"""The port's multi-head latent attention (``nn.mla``) against the jitted
reference on the CPU, on reduced deepseek-v2-lite's widths (d_model 64, 4
heads, kv_lora 32, nope 16, rope 8, v 16) and the reference's weights
carried over by ``model.params_from_jax``.

Bars, each measured here:

  * the forward (prefill compute) and ``prefill_cache`` equal the jitted
    reference bit for bit: the output, ``c_kv``, ``k_rope`` and ``kpos``,
    with and without the ``query_chunk`` split (a chunk of 8 takes it at
    24 rows);
  * the absorbed decode is held to the one-row bar of the contiguous
    cache (``tests/test_torch_monolithic.py``): the output within
    DECODE_TOL_ULPS bf16 ulps of its largest value, the cache bit-equal.
    Its one-row products (``q_eff``, the latent logits, P.V and the
    un-absorption) are torch f32 einsums that may sum in another order
    than XLA:CPU's dots;
  * the decode reads ``wk_b`` / ``wv_b`` as the reference's f32 masters
    cast to bf16 (``"raw"``), prefill reads them fake-quantized (``"w"``):
    poisoning the form a path must not read leaves it bit-equal, and
    swapping in the other form moves it past its bar;
  * ``rope_freqs`` at MLA's rope widths (8 reduced, 64 at full width) and
    the shared-head rotation are bit-equal; so is the latent's RMSNorm at
    widths 32 and 512.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro import configs as jconfigs  # noqa: E402
from repro.nn import blocks as jblocks  # noqa: E402
from repro.nn import mla as jmla  # noqa: E402
from repro.nn import model as jmodel  # noqa: E402
from repro.nn import rotary as jrotary  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.nn import blocks as tblocks  # noqa: E402
from repro_torch.nn import mla, rotary  # noqa: E402
from repro_torch.nn import model as tmodel  # noqa: E402

ARCH = "deepseek-v2-lite-16b"
DECODE_TOL_ULPS = 2
S, MAX_SEQ = 24, 32


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return a.view(np.int16)
    return a


def _t(a) -> torch.Tensor:
    """A reference array as a port tensor with the same bytes."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _tb(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 \
        else t.numpy()


@pytest.fixture(scope="module")
def pair():
    """Reduced deepseek in both packages: the prologue block's mixer
    (layer 0) on the reference's weights, kv_norm's scale drawn from
    N(0, 0.25); and the jitted reference functions, each jitted once."""
    quant = dict(quantize_acts=False, quantize_kv_cache=True)
    jcfg = jconfigs.get_reduced(ARCH)
    jcfg = jcfg.replace(quant=jcfg.quant.replace(**quant))
    tcfg = tconfigs.get_reduced(ARCH)
    tcfg = tcfg.replace(quant=tcfg.quant.replace(**quant))
    jparams, _ = jmodel.init(jax.random.PRNGKey(3), jcfg)
    jparams = jax.tree_util.tree_map(np.asarray, jparams)
    scale = jparams["prologue0"]["mixer"]["kv_norm"]["scale"]
    jparams["prologue0"]["mixer"]["kv_norm"]["scale"] = scale + 0.5 * \
        np.random.default_rng(3).standard_normal(scale.shape).astype(
            np.float32)
    tparams = tmodel.params_from_jax(jparams, tcfg, "cpu")
    jp = jparams["prologue0"]["mixer"]
    tp = tparams["layers"][0]["mixer"]
    q = jcfg.quant

    def jit_cfg(chunk):
        mcfg = jblocks._mla_cfg(jcfg.replace(query_chunk=chunk))
        return dict(
            forward=jax.jit(lambda p, x, pos: jmla.apply_train(
                p, x, pos, mcfg, q)),
            cache=jax.jit(lambda p, x, pos: jmla.prefill_cache(
                p, x, pos, mcfg, q, MAX_SEQ)),
            mcfg=tblocks._mla_cfg(tcfg.replace(query_chunk=chunk)))

    jdecode = jax.jit(lambda p, x, c, pos: jmla.apply_decode(
        p, x, c, pos, jblocks._mla_cfg(jcfg), q))
    return dict(jp=jp, tp=tp, jit=jit_cfg, jdecode=jdecode,
                mcfg=tblocks._mla_cfg(tcfg), jcfg=jcfg)


def _inputs(seed, b=2, s=S, d=64):
    x = np.random.default_rng(seed).standard_normal((b, s, d)).astype(
        np.float32)
    xj = jnp.asarray(x, jnp.bfloat16)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()
    return xj, _t(xj), pos, torch.from_numpy(pos)


def _assert_cache(jc, tc):
    for key in ("c_kv", "k_rope", "kpos"):
        assert tc[key].dtype == {"kpos": torch.int32}.get(key,
                                                          torch.bfloat16)
        np.testing.assert_array_equal(_tb(tc[key]), _bits(jc[key]),
                                      err_msg=key)


# ---------------------------------------------------------------------------
# prefill: bit for bit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("chunk", [1024, 8])
def test_forward_and_prefill_cache_equal_the_jitted_reference(pair, chunk):
    """At chunk 8 the 24 query rows take the reference's query-chunk map
    (three chunks); at 1024 one product."""
    fns = pair["jit"](chunk)
    xj, xt, pj, pt = _inputs(11)
    want = fns["forward"](pair["jp"], xj, pj)
    jc = fns["cache"](pair["jp"], xj, pj)
    got = mla.apply_train(pair["tp"], xt, pt, fns["mcfg"])
    assert got.dtype == torch.bfloat16 and got.shape == (2, S, 64)
    np.testing.assert_array_equal(_tb(got), _bits(want))
    tc = mla.prefill_cache(pair["tp"], xt, pt, fns["mcfg"], MAX_SEQ)
    _assert_cache(jc, tc)
    assert tc["kpos"].tolist() == list(range(S)) + [-1] * (MAX_SEQ - S)


# ---------------------------------------------------------------------------
# the absorbed decode: the one-row bar
# ---------------------------------------------------------------------------


def _decode_steps(pair, tp, steps=4):
    """``steps`` decodes from the reference's prefill cache, each step
    from the reference's cache of the step before. Yields (reference
    output, port output, reference cache, port cache)."""
    fns = pair["jit"](1024)
    xj, _, pj, _ = _inputs(12)
    jc = fns["cache"](pair["jp"], xj, pj)
    rng = np.random.default_rng(13)
    for i in range(steps):
        pos = S + i
        tc = {k: _t(v) for k, v in jc.items()}
        x1 = jnp.asarray(rng.standard_normal((2, 1, 64)), jnp.bfloat16)
        want, jc = pair["jdecode"](pair["jp"], x1, jc, np.int32(pos))
        got = mla.apply_decode(tp, _t(x1), tc, pos, pair["mcfg"])
        yield np.asarray(want, np.float32), got.float().numpy(), jc, tc


def _ulps_off(want, got) -> float:
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    return float(np.abs(got - want).max() / ulp)


def test_absorbed_decode_within_the_one_row_bar(pair):
    """Four steps at positions 24-27: the output within DECODE_TOL_ULPS
    bf16 ulps of its largest value, the cache (the step's written latent,
    rotated key and position) bit-equal."""
    worst = 0.0
    for want, got, jc, tc in _decode_steps(pair, pair["tp"]):
        worst = max(worst, _ulps_off(want, got))
        _assert_cache(jc, tc)
    assert worst <= DECODE_TOL_ULPS, worst


def _with(tp, name, form, value):
    out = {k: (dict(v) if isinstance(v, dict) else v) for k, v in tp.items()}
    out[name] = dict(tp[name])
    out[name][form] = value
    return out


@pytest.mark.parametrize("name", ["wk_b", "wv_b"])
def test_decode_reads_raw_weights_and_prefill_fake_quantized(pair, name):
    """``raw`` is the reference's f32 master cast to bf16 and ``w`` its
    fake-quantized weight, and they differ. Zeroing the form a path must
    not read leaves it bit-equal; giving the decode ``w`` in place of
    ``raw`` moves it past its bar, and prefill ``raw`` in place of ``w``
    moves its output."""
    tp = pair["tp"]
    master = pair["jp"][name]["w"]
    np.testing.assert_array_equal(
        _tb(tp[name]["raw"]), _bits(jnp.asarray(master, jnp.bfloat16)))
    assert not torch.equal(tp[name]["raw"], tp[name]["w"])
    fns = pair["jit"](1024)
    xj, xt, pj, pt = _inputs(11)
    want = _bits(fns["forward"](pair["jp"], xj, pj))
    zero_raw = _with(tp, name, "raw", torch.zeros_like(tp[name]["raw"]))
    np.testing.assert_array_equal(
        _tb(mla.apply_train(zero_raw, xt, pt, fns["mcfg"])), want)
    raw_as_w = _with(tp, name, "w", tp[name]["raw"])
    assert (_tb(mla.apply_train(raw_as_w, xt, pt, fns["mcfg"]))
            != want).any()

    zero_w = _with(tp, name, "w", torch.zeros_like(tp[name]["w"]))
    for (_, good, _, _), (_, got, _, _) in zip(_decode_steps(pair, tp, 2),
                                               _decode_steps(pair, zero_w,
                                                             2)):
        np.testing.assert_array_equal(got, good)
    w_as_raw = _with(tp, name, "raw", tp[name]["w"])
    worst = max(_ulps_off(want, got) for want, got, _, _ in
                _decode_steps(pair, w_as_raw, 2))
    assert worst > DECODE_TOL_ULPS, worst


# ---------------------------------------------------------------------------
# RoPE at the rope widths, the latent's RMSNorm
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("head_dim", [8, 64])
def test_rope_at_mla_widths_equals_the_jitted_reference(head_dim):
    """The frequencies, and the shared key's rotation (one head,
    ``[..., None, :]``) at every position below 2,048, bit for bit."""
    want = jax.jit(jrotary.rope_freqs, static_argnums=(0, 1))(head_dim,
                                                              1e4)
    np.testing.assert_array_equal(
        rotary.rope_freqs(head_dim, 1e4).numpy().view(np.uint32),
        np.asarray(want).view(np.uint32))
    n = 2048
    rng = np.random.default_rng(head_dim)
    kj = jnp.asarray(rng.standard_normal((2, n, head_dim)), jnp.bfloat16)
    pos = np.broadcast_to(np.arange(n, dtype=np.int32), (2, n)).copy()
    rot = jax.jit(lambda k, p: jrotary.apply_rope(k[..., None, :], p)[
        ..., 0, :])(kj, pos)
    got = rotary.apply_rope(_t(kj)[..., None, :], torch.from_numpy(pos),
                            1e4, n)[..., 0, :]
    np.testing.assert_array_equal(_tb(got), _bits(rot))


@pytest.mark.parametrize("width", [32, 512])
def test_latent_norm_equals_the_jitted_reference(width):
    """The latent's RMSNorm (``rmsnorm_apply``'s default eps, width
    ``kv_lora``: 32 reduced, 512 full) as the reference's ``_latent``
    runs it, on projections of rows at many scales, at the row counts
    that prefill and decode give it. Measured beside it: XLA:CPU runs a
    *standalone* jitted RMSNorm of thousands of rows at widths up to 32
    through AVX-512's ``rsqrt14`` estimate, which parts from the port's
    ``rsqrtps`` path in about 9% of rows; inside the latent it does not."""
    mcfg = dict(d_model=64, num_heads=4, kv_lora=width, qk_nope_dim=16,
                qk_rope_dim=8, v_head_dim=16)
    jcfg, tcfg = jmla.MLAConfig(**mcfg), mla.MLAConfig(**mcfg)
    quant = jconfigs.get_reduced(ARCH).quant.replace(quantize_acts=False)
    tquant = tconfigs.get_reduced(ARCH).quant.replace(quantize_acts=False)
    rng = np.random.default_rng(width)
    w = (rng.standard_normal((64, width + 8)) / 8).astype(np.float32)
    scale = (0.5 * rng.standard_normal(width)).astype(np.float32)
    jp = {"wkv_a": {"w": w}, "kv_norm": {"scale": scale}}
    tp = {"wkv_a": {"w": tmodel.linear.prepare_weight(torch.from_numpy(w),
                                                      tquant)},
          "kv_norm": {"scale": torch.from_numpy(scale)}}
    latent = jax.jit(lambda p, x: jmla._latent(p, x, jcfg, quant,
                                               jnp.bfloat16)[0])
    for b, s in [(3, 19), (2, 24), (8, 1), (3, 1), (4, 100)]:
        x = (rng.standard_normal((b, s, 64))
             * np.exp(rng.uniform(-3, 3, (b, s, 1)))).astype(np.float32)
        xj = jnp.asarray(x, jnp.bfloat16)
        got = mla._latent(tp, _t(xj), tcfg, torch.bfloat16)[0]
        assert got.dtype == torch.bfloat16 and got.shape == (b, s, width)
        np.testing.assert_array_equal(_tb(got), _bits(latent(jp, xj)),
                                      err_msg=f"{b} x {s}")


def test_full_width_shapes_and_the_scale():
    """The full config's MLA: the cache's 1,152 bytes a token a layer,
    and the logit scale as the f32 rounding of 192 ** -0.5."""
    cfg = tblocks._mla_cfg(tconfigs.get_config(ARCH))
    cache = mla.init_cache(1, 4, cfg, "cpu")
    per_token = sum(cache[k][0, 0].numel() * cache[k].element_size()
                    for k in ("c_kv", "k_rope"))
    assert per_token == 1152
    assert mla._scale(cfg) == float(np.float32(192 ** -0.5))
    assert cache["c_kv"].shape == (1, 4, 512)
