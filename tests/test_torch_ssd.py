"""The port's SSD mixer (``nn.ssd``, mamba2) against the jitted reference
on the CPU, on reduced mamba2-780m's widths (d_model 64, d_inner 128,
headdim 16 -> 8 heads, d_state 32, one group, chunk 8), the reference's
weights carried over, with nonzero ``conv_b`` / ``dt_bias`` / ``norm``
and a ``D`` off 1 drawn from a numpy seed.

Bars, each measured here: the forward, ``prefill_state`` (output, SSD
state, convolution state) and a decode step from a prefill state equal
the jitted reference bit for bit, over one chunk (1, 2, 5 and 8 tokens;
1 and 2 are shorter than ``conv_width - 1``), several chunks (16 and 24
tokens) and from an ``init_state``, at batch 4. The scan's pairwise
products sum in XLA:CPU's orders for their shapes (``host_math.dot``),
its cumulative sums left to right. A length that is neither at most one
chunk nor a multiple of it raises the reference's ``AssertionError``
with its message.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro import configs as jconfigs  # noqa: E402
from repro.nn import blocks as jblocks  # noqa: E402
from repro.nn import ssd as jssd  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.nn import blocks as tblocks  # noqa: E402
from repro_torch.nn import linear, ssd  # noqa: E402

ARCH = "mamba2-780m"
B = 4


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
    sc = jblocks._ssd_cfg(jcfg)
    jp, _ = jssd.init(jax.random.PRNGKey(1), sc)
    jp = jax.tree_util.tree_map(np.asarray, jp)
    rng = np.random.default_rng(0)
    jp["conv_b"] = (0.3 * rng.standard_normal(sc.conv_dim)).astype(np.float32)
    jp["dt_bias"] = (0.5 * rng.standard_normal(sc.nheads)).astype(np.float32)
    jp["D"] = (1 + 0.3 * rng.standard_normal(sc.nheads)).astype(np.float32)
    jp["norm"] = {"scale": (0.3 * rng.standard_normal(sc.d_inner)).astype(
        np.float32)}

    def conv(k, v):
        if k in ("in_proj", "out_proj"):
            return {"w": linear.prepare_weight(_t(np.asarray(
                v["w"], np.float32)), jcfg.quant)}
        if k == "norm":
            return {"scale": _t(v["scale"])}
        return _t(np.asarray(v, np.float32))

    q = jcfg.quant
    tcfg = tconfigs.get_reduced(ARCH)
    return dict(
        jp=jp, tp={k: conv(k, v) for k, v in jp.items()}, sc=sc,
        cfg=tblocks._ssd_cfg(tcfg),
        forward=jax.jit(lambda p, x, i: jssd.apply_train(
            p, x, sc, q, init_state=i, return_state=True)),
        state=jax.jit(lambda p, x: jssd.prefill_state(p, x, sc, q)),
        decode=jax.jit(lambda p, x, s: jssd.apply_decode(p, x, s, sc, q)))


def _x(seed, s):
    xj = jnp.asarray(np.random.default_rng(seed).standard_normal(
        (B, s, 64)), jnp.bfloat16)
    return xj, _t(xj)


def test_config_and_init_match_the_reference(pair):
    cfg, sc = pair["cfg"], pair["sc"]
    assert (cfg.nheads, cfg.conv_dim, cfg.chunk) == (sc.nheads, sc.conv_dim,
                                                     sc.chunk) == (8, 192, 8)
    got = ssd.init(torch.Generator().manual_seed(0), cfg,
                   tconfigs.get_reduced(ARCH).quant.replace(
                       quantize_acts=False), "cpu")
    assert sorted(got) == sorted(pair["jp"])
    for k in ("conv_w", "A_log", "dt_bias", "D"):
        assert tuple(got[k].shape) == np.asarray(pair["jp"][k]).shape
    assert tuple(got["in_proj"]["w"].shape) == (64, 2 * 128 + 2 * 32 + 8)


@pytest.mark.parametrize("s", [1, 2, 5, 8, 16, 24])
def test_prefill_and_decode_equal_the_jitted_reference(pair, s):
    xj, xt = _x(s, s)
    wout, wstate = pair["state"](pair["jp"], xj)
    out, state = ssd.prefill_state(pair["tp"], xt, pair["cfg"])
    _same(out, wout)
    _same(state["h"], wstate["h"])
    _same(state["conv"], wstate["conv"])
    _same(ssd.apply_train(pair["tp"], xt, pair["cfg"]), wout)
    x1j, x1t = _x(100 + s, 1)
    want, wnext = pair["decode"](pair["jp"], x1j, wstate)
    got = ssd.apply_decode(pair["tp"], x1t, state, pair["cfg"])
    _same(got, want)
    _same(state["h"], wnext["h"])
    _same(state["conv"], wnext["conv"])


@pytest.mark.parametrize("s", [8, 16])
def test_scan_from_an_init_state_equals_the_jitted_reference(pair, s):
    xj, xt = _x(7 + s, s)
    init = (0.1 * np.random.default_rng(s).standard_normal(
        (B, 8, 16, 32))).astype(np.float32)
    wout, wstate = pair["forward"](pair["jp"], xj, init)
    out, state = ssd.apply_train(pair["tp"], xt, pair["cfg"],
                                 init_state=_t(init), return_state=True)
    _same(out, wout)
    _same(state, wstate)


def test_indivisible_length_raises_like_the_reference(pair):
    xj, xt = _x(3, 11)
    with pytest.raises(AssertionError) as want:
        pair["state"](pair["jp"], xj)
    with pytest.raises(AssertionError) as got:
        ssd.prefill_state(pair["tp"], xt, pair["cfg"])
    assert str(got.value) == str(want.value) == \
        "seq 11 not divisible by chunk 8"


def test_segsum_equals_the_reference():
    x = np.random.default_rng(4).standard_normal((3, 5, 9)).astype(
        np.float32)
    _same(ssd._segsum(torch.from_numpy(x)), jax.jit(jssd._segsum)(x))
