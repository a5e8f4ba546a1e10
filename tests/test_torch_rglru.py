"""The port's RG-LRU mixer (``nn.rglru``) against the jitted reference on
the CPU, on reduced recurrentgemma-2b's widths (d_model and width 64,
conv_width 4), the reference's weights carried over (projections
fake-quantized as ``model.params_from_jax`` does; the convolution, gates
and ``lam`` as they are), with nonzero biases drawn from a numpy seed.

Bars, each measured here:

  * the forward (``apply_train``, prefill's compute) and
    ``prefill_state`` equal the jitted reference bit for bit, at 1-16
    tokens (odd and even lengths through the associative scan's
    recursion; 1 and 2 tokens are shorter than ``conv_width - 1``, whose
    state is zero-padded in front), at batch 4 and at batch 2;
  * one decode step from a prefill state equals the jitted reference's
    standalone step bit for bit, output and state, at batch 4 with
    ``scanned=False``: XLA contracts the state term's product there.
    Inside the model's scan it contracts the input term's
    (``scanned=True``, held bit-equal by ``tests/test_torch_recurrent.py``);
    here that form, and the standalone step at batch 1 (its gate
    products sum in another order), stay within DECODE_STATE_ULPS f32
    ulps of the state (3 measured), the output bit-equal;
  * XLA:CPU's exp, sigmoid and softplus (``core.host_math``) equal
    ``jax.jit`` of each on 2^16 samples, and its f32 dot order at the
    shapes the two mixers use.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro import configs as jconfigs  # noqa: E402
from repro.nn import blocks as jblocks  # noqa: E402
from repro.nn import rglru as jrglru  # noqa: E402
from repro_torch.core import host_math  # noqa: E402
from repro_torch.nn import linear, rglru  # noqa: E402

ARCH = "recurrentgemma-2b"
DECODE_STATE_ULPS = 4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _same(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    if want.dtype.name == "bfloat16":
        np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                      want.view(np.int16))
    else:
        np.testing.assert_array_equal(got.contiguous().numpy().view(np.int32),
                                      want.view(np.int32))


@pytest.fixture(scope="module")
def pair():
    jcfg = jconfigs.get_reduced(ARCH)
    jcfg = jcfg.replace(quant=jcfg.quant.replace(quantize_acts=False))
    rc = jblocks._rglru_cfg(jcfg)
    jp, _ = jrglru.init(jax.random.PRNGKey(1), rc)
    jp = jax.tree_util.tree_map(np.asarray, jp)
    rng = np.random.default_rng(0)
    for k in ("conv_b", "gate_a_b", "gate_x_b"):
        jp[k] = (0.3 * rng.standard_normal(rc.width)).astype(np.float32)
    tp = {k: ({"w": linear.prepare_weight(_t(np.asarray(v["w"], np.float32)),
                                          jcfg.quant)}
              if isinstance(v, dict) else _t(np.asarray(v, np.float32)))
          for k, v in jp.items()}
    q = jcfg.quant
    return dict(
        jp=jp, tp=tp, cfg=rglru.RGLRUConfig(d_model=64, width=64),
        forward=jax.jit(lambda p, x: jrglru.apply_train(p, x, rc, q)),
        state=jax.jit(lambda p, x: jrglru.prefill_state(p, x, rc, q)),
        decode=jax.jit(lambda p, x, s: jrglru.apply_decode(p, x, s, rc, q)))


def _x(seed, b, s):
    xj = jnp.asarray(np.random.default_rng(seed).standard_normal(
        (b, s, 64)), jnp.bfloat16)
    return xj, _t(xj)


def test_init_matches_the_reference_layout(pair):
    """Leaf names, shapes and dtypes as the reference's init; ``lam``
    within an f32 ulp of the reference's linspace (torch's and jax's
    linspace round differently; the parity tests carry the reference's
    leaves over)."""
    got = rglru.init(torch.Generator().manual_seed(0), pair["cfg"],
                     jconfigs.get_reduced(ARCH).quant.replace(
                         quantize_acts=False), "cpu")
    assert sorted(got) == sorted(pair["jp"])
    for k, v in pair["jp"].items():
        want = np.asarray(v["w"] if isinstance(v, dict) else v)
        leaf = got[k]["w"] if isinstance(v, dict) else got[k]
        assert tuple(leaf.shape) == want.shape
    lam = np.asarray(pair["jp"]["lam"])
    assert (np.abs(got["lam"].numpy() - lam) <= np.spacing(lam)).all()
    assert got["gate_a"].dtype == torch.float32


@pytest.mark.parametrize("b,s", [(4, 1), (4, 2), (4, 3), (4, 11), (4, 16),
                                 (2, 9)])
def test_forward_and_state_equal_the_jitted_reference(pair, b, s):
    xj, xt = _x(s, b, s)
    _same(rglru.apply_train(pair["tp"], xt, pair["cfg"]),
          pair["forward"](pair["jp"], xj))
    want = pair["state"](pair["jp"], xj)
    got = rglru.prefill_state(pair["tp"], xt, pair["cfg"])
    _same(got["h"], want["h"])
    _same(got["conv"], want["conv"])
    out, state = rglru.prefill(pair["tp"], xt, pair["cfg"])
    _same(out, pair["forward"](pair["jp"], xj))
    _same(state["h"], want["h"])


def _near(got: torch.Tensor, want) -> None:
    """Within DECODE_STATE_ULPS f32 ulps (steps between the bit patterns;
    no value here changes sign)."""
    a = got.numpy().view(np.int32).astype(np.int64)
    b = np.asarray(want).view(np.int32).astype(np.int64)
    assert np.abs(a - b).max() <= DECODE_STATE_ULPS


@pytest.mark.parametrize("b", [4, 1])
def test_decode_from_a_prefill_state_equals_the_jitted_reference(pair, b):
    xj, xt = _x(5, b, 11)
    jstate = pair["state"](pair["jp"], xj)
    x1j, x1t = _x(6, b, 1)
    want, wstate = pair["decode"](pair["jp"], x1j, jstate)
    state = {k: _t(v) for k, v in jstate.items()}
    _same(rglru.apply_decode(pair["tp"], x1t, state, pair["cfg"],
                             scanned=False), want)
    _same(state["conv"], wstate["conv"])
    if b == 4:
        _same(state["h"], wstate["h"])
    else:
        _near(state["h"], wstate["h"])
    scanned = {k: _t(v) for k, v in jstate.items()}
    rglru.apply_decode(pair["tp"], x1t, scanned, pair["cfg"])
    _near(scanned["h"], wstate["h"])


@pytest.mark.parametrize("name", ["exp", "logistic", "softplus"])
def test_host_transcendentals_equal_xla(name):
    x = (np.random.default_rng(1).standard_normal(1 << 16) * 6).astype(
        np.float32)
    x[:8] = [0.0, -0.0, np.inf, -np.inf, 100.0, -100.0, 88.8, -87.9]
    fn = {"exp": jnp.exp, "logistic": jax.nn.sigmoid,
          "softplus": jax.nn.softplus}[name]
    _same(getattr(host_math, name)(torch.from_numpy(x)), jax.jit(fn)(x))


@pytest.mark.parametrize("m,k,n", [(44, 64, 64), (4, 64, 64), (8, 32, 8),
                                   (8, 8, 16), (16, 8, 32), (512, 2, 2),
                                   (512, 4, 4), (16, 32, 1)])
def test_host_dot_equals_xla_at_the_mixers_shapes(m, k, n):
    """RG-LRU's gates (rows x 64 x 64), SSD's chunk products (8 x 32 x 8,
    8 x 8 x 16, 16 x 8 x 32), its chunk recurrence (512 x c x c; at c = 3
    the order depends on the batch, and ``tests/test_torch_ssd.py``
    holds it inside the scan) and its decode read-out (16 x 32 x 1),
    batched."""
    rng = np.random.default_rng(m * k + n)
    a = rng.standard_normal((3, m, k)).astype(np.float32)
    b = rng.standard_normal((3, k, n)).astype(np.float32)
    want = jax.jit(lambda a, b: jnp.einsum("zmk,zkn->zmn", a, b))(a, b)
    _same(host_math.dot(torch.from_numpy(a), torch.from_numpy(b),
                        host_math.dot_lanes(m, k, n)), want)
