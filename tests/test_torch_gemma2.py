"""gemma2's model features in the port against the jitted reference, on
the CPU: XLA:CPU's tanh, GeGLU, the embedding scale, the logit and
attention softcaps, the sandwich post-norms and the rounding of the
residual stream inside a scanned two-block pattern.

XLA:CPU's f32 tanh is a rational approximation of its own (fault C5 in
ROADMAP.md): on 10^6 inputs ``standard_normal * 3`` torch's tanh misses
it 592,442 times. The port's ``core.host_math.tanh`` reproduces it, and
the tests hold it, ``gelu_tanh`` and the softcaps to the reference bit
for bit, over a sweep of f32 bit patterns too. The rest is held bit for
bit as well, but for the page walk's f32 output and products on a bf16
rounding tie (the docstrings say where).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs import get_reduced as jreduced  # noqa: E402
from repro.nn import blocks as jblocks  # noqa: E402
from repro.nn import embedding as jemb  # noqa: E402
from repro.nn import ffn as jffn  # noqa: E402
from repro.nn import model as jmodel  # noqa: E402
from repro_torch.configs import get_reduced as treduced  # noqa: E402
from repro_torch.core import host_math  # noqa: E402
from repro_torch.kernels import mx_attention  # noqa: E402
from repro_torch.nn import blocks as tblocks  # noqa: E402
from repro_torch.nn import embedding as temb  # noqa: E402
from repro_torch.nn import ffn as tffn  # noqa: E402
from repro_torch.nn import model as tmodel  # noqa: E402

#: f32 bit patterns of the sweep: every STRIDE-th of the 2^32
STRIDE = 4099
#: the walk's f32 output against the interpret-mode kernel's
OUT_RTOL = 1e-5


def _bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.uint32)


def _misses(got, want) -> int:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    nan = np.isnan(got) & np.isnan(want)
    return int(((_bits(got) != _bits(want)) & ~nan).sum())


def _normal(n, scale, seed=0) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal(n) * scale).astype(
        np.float32)


def _sweep() -> np.ndarray:
    return np.arange(0, 2 ** 32, STRIDE, dtype=np.uint64).astype(
        np.uint32).view(np.float32)


def test_tanh_equals_xla_and_torch_does_not():
    """10^6 values of ``standard_normal * 3`` (seed 0) and the bit-pattern
    sweep (subnormals, infinities, NaNs) are bit-equal; torch's tanh
    misses the 10^6 values 592,442 times (measured with jax 0.9.0)."""
    xla = jax.jit(jnp.tanh)
    x = _normal(10 ** 6, 3.0)
    want = np.asarray(xla(x))
    assert _misses(host_math.tanh(torch.from_numpy(x)), want) == 0
    assert _misses(torch.tanh(torch.from_numpy(x)), want) > 500_000
    pats = _sweep()
    assert _misses(host_math.tanh(torch.from_numpy(pats.copy())),
                   np.asarray(xla(pats))) == 0


def test_gelu_tanh_and_softcap_equal_xla():
    gelu = jax.jit(lambda v: jax.nn.gelu(v, approximate=True))
    for x in (_normal(10 ** 5, 3.0, 1), _sweep()):
        assert _misses(host_math.gelu_tanh(torch.from_numpy(x.copy())),
                       np.asarray(gelu(x))) == 0
    x = _normal(10 ** 5, 60.0, 2)
    for cap in (50.0, 30.0):
        want = np.asarray(jax.jit(lambda v: jnp.tanh(v / cap) * cap)(x))
        assert _misses(host_math.softcap(torch.from_numpy(x), cap),
                       want) == 0


def _pair(seed=0, **over):
    """Reduced gemma2-2b in both packages (weight-only MX, MX KV cache) on
    the reference's weights, RMSNorm scales drawn from N(0, 0.25) so that
    the post-norms weigh in."""
    quant = dict(quantize_acts=False, quantize_kv_cache=True)
    jcfg = jreduced("gemma2-2b")
    tcfg = treduced("gemma2-2b")
    jcfg = jcfg.replace(quant=jcfg.quant.replace(**quant), **over)
    tcfg = tcfg.replace(quant=tcfg.quant.replace(**quant), **over)
    jparams, _ = jmodel.init(jax.random.PRNGKey(seed), jcfg)
    rng = np.random.default_rng(seed)

    def scales(path, leaf):
        leaf = np.asarray(leaf)
        if jax.tree_util.keystr(path).endswith("['scale']"):
            leaf = leaf + 0.5 * rng.standard_normal(leaf.shape).astype(
                np.float32)
        return leaf
    jparams = jax.tree_util.tree_map_with_path(scales, jparams)
    return jcfg, jparams, tcfg, tmodel.params_from_jax(jparams, tcfg, "cpu")


def _bf16(shape, seed, scale=1.0):
    x = np.random.default_rng(seed).standard_normal(shape) * scale
    j = jnp.asarray(x.astype(np.float32), jnp.bfloat16)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).bfloat16()


def _same_bf16(got: torch.Tensor, want) -> None:
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  np.asarray(want).view(np.int16))


def test_geglu_equals_the_reference():
    jcfg, jparams, tcfg, tparams = _pair()
    jx, tx = _bf16((3, 7, 64), 3, 2.0)
    lp = jax.tree_util.tree_map(lambda a: a[0],
                                jparams["groups"]["block0"]["ffn"])
    want = jax.jit(lambda p, x: jffn.apply(p, x, jcfg.quant, "geglu"))(lp, jx)
    _same_bf16(tffn.apply(tparams["layers"][0]["ffn"], tx, "geglu"), want)
    # the no-gate kind is ported (musicgen), and both kinds train (their
    # gradients: tests/test_torch_train_gemma2.py, _musicgen.py)
    tblocks._require_ported(tcfg.pattern[0], tcfg.replace(ffn_kind="gelu"))
    for kind in ("geglu", "gelu"):
        for bd in tcfg.pattern:
            tblocks.require_trainable(bd, tcfg.replace(ffn_kind=kind))


@pytest.mark.parametrize("d", [64, 2304, 3584, 3072])
def test_embedding_scale_equals_the_reference(d):
    """``bf16(d) ** 0.5`` in bf16 (59.75 at gemma2-9b's 3584), and the
    scaled rows bit-equal."""
    table = np.random.default_rng(d).standard_normal((32, d)).astype(
        np.float32) * 0.01
    toks = np.arange(0, 32, 3, dtype=np.int32)[None]
    want = jax.jit(lambda e, t: jemb.embed({"embed": e}, t, True))(table, toks)
    got = temb.embed({"embed": torch.from_numpy(table).bfloat16()},
                     torch.from_numpy(toks), scale_by_sqrt_dim=True)
    _same_bf16(got, want)


def test_logit_softcap_equals_the_reference():
    """The softcap of the reference's own f32 logits equals its capped
    logits bit for bit; the port's head reaches the same capped logits
    wherever its bf16 product equals the reference's (a product on a
    bf16 rounding tie may round the other way: torch's f32 dot sums in
    another order than XLA's)."""
    jcfg, jparams, tcfg, tparams = _pair()
    jx, tx = _bf16((2, 5, 64), 4, 3.0)
    head = jax.jit(lambda p, x, cap: jemb.logits(p, x, cap),
                   static_argnums=2)
    want, plain = (np.array(head(jparams["embedding"], jx, cap))
                   for cap in (30.0, None))
    capped = host_math.softcap(torch.from_numpy(plain), 30.0).numpy()
    np.testing.assert_array_equal(capped, want)
    assert np.abs(want).max() < 30.0 and not np.array_equal(want, plain)
    got = temb.logits(tparams["embedding"], tx, softcap=30.0).numpy()
    same = temb.logits(tparams["embedding"], tx).numpy() == plain
    assert same.mean() > 0.999
    np.testing.assert_array_equal(got[same], want[same])


def test_post_norm_blocks_equal_the_reference():
    """Each block of the pattern, prefill and one-token decode, on the
    same inputs: outputs and caches bit-equal. The local block's 13
    tokens pass its window of 8."""
    jcfg, jparams, tcfg, tparams = _pair()
    jx, tx = _bf16((2, 13, 64), 5)
    pos = np.broadcast_to(np.arange(13, dtype=np.int32), (2, 13))
    for li, (key, g, bd) in enumerate(jmodel.iter_layer_blocks(jcfg)):
        lp = jmodel.layer_params(jparams, key, g)
        want, jc = jax.jit(lambda p, x: jblocks.prefill_block(
            p, x, pos, bd, jcfg, 16))(lp, jx)
        got, tc = tblocks.prefill_block(tparams["layers"][li], tx,
                                        torch.from_numpy(pos.copy()),
                                        tcfg.all_blocks()[li], tcfg, 16)
        _same_bf16(got.bfloat16(), want)
        jd, _ = jax.jit(lambda p, x, c: jblocks.apply_decode(
            p, x, c, 13, bd, jcfg))(lp, jx[:, :1], jc)
        tc = {k: v.clone() for k, v in tc.items()}
        _same_bf16(tblocks.apply_decode(tparams["layers"][li], tx[:, :1], tc,
                                        13, tcfg.all_blocks()[li], tcfg)
                   .bfloat16(), jd)


def _prefill_and_head_input(tparams, tcfg, toks, max_seq):
    """``model.prefill``'s logits and the hidden rows its head read."""
    seen = []
    head = tmodel._head

    def spy(params, cfg, x):
        seen.append(x)
        return head(params, cfg, x)
    tmodel._head = spy
    try:
        logits, _ = tmodel.prefill(tparams, tcfg, torch.from_numpy(toks),
                                   max_seq)
    finally:
        tmodel._head = head
    return logits.numpy(), seen[0]


def _assert_equal_but_head_ties(got, want, x, tparams, tcfg):
    """Logits bit-equal, except where the head's exact product lies on a
    bf16 rounding tie within the f32 sum's error bound: torch's f32 dot
    sums in another order than XLA's and may round to the tie's other
    side. Each such logit must be the reference's value from that other
    bf16 neighbour, and at most two may differ."""
    bad = np.argwhere(got != want)
    assert len(bad) <= 2, bad
    h = tmodel.rmsnorm_apply(tparams["final_norm"], x, tcfg.norm_eps)
    table = tparams["embedding"]["embed"].T
    w = table.float().numpy().astype(np.float64)
    hh = h.float().numpy().astype(np.float64)
    exact, bound = hh @ w, w.shape[0] * 2.0 ** -24 * (np.abs(hh) @ np.abs(w))
    pre = torch.matmul(h, table).float().numpy()
    for idx in map(tuple, bad):
        b = float(pre[idx])
        ulp = 2.0 ** (np.floor(np.log2(abs(b))) - 7)
        other = [n for n in (b - ulp, b + ulp)
                 if abs(exact[idx] - (b + n) / 2) <= bound[idx]]
        fixed = host_math.softcap(torch.tensor(other, dtype=torch.float32),
                                  tcfg.logit_softcap)
        assert want[idx] in fixed.tolist(), (idx, exact[idx], b)


@pytest.mark.parametrize("groups", [1, 2])
def test_pattern_rounding_through_the_scan(groups):
    """Inside one iteration of the reference's scan XLA hands the local
    block's output sum to the global block's norm unrounded; the scan
    carries bf16 between iterations. ``model.layer_carries`` says which
    layers carry. Prefill logits equal the reference's at one and two
    groups (``_assert_equal_but_head_ties``: one head tie at two groups),
    and rounding every block output instead moves hundreds of them."""
    jcfg, jparams, tcfg, tparams = _pair(num_groups=groups)
    assert tmodel.layer_carries(tcfg) == [True, False] * groups
    toks = np.random.default_rng(6).integers(0, 512, (2, 11)).astype(np.int32)
    want = np.asarray(jax.jit(lambda p, t: jmodel.prefill(
        p, jcfg, tokens=t, max_seq=16))(jparams, toks)[0])
    got, x = _prefill_and_head_input(tparams, tcfg, toks, 16)
    _assert_equal_but_head_ties(got, want, x, tparams, tcfg)
    carries = tmodel.layer_carries
    try:
        tmodel.layer_carries = lambda cfg: [False] * cfg.num_layers
        rounded, _ = tmodel.prefill(tparams, tcfg, torch.from_numpy(toks), 16)
    finally:
        tmodel.layer_carries = carries
    assert (rounded.numpy() != want).sum() > 100


def test_walk_softcap_and_window_equal_the_reference_kernel():
    """The plain page walk of #1 (``mx_attention_ragged_fused`` on CPU
    tensors) against the reference's Pallas kernel in interpret mode,
    at softcap 50 and window 8, with a row whose walk starts past page
    0: written pages bit-equal, outputs within OUT_RTOL (the two sum f32
    products in other orders, as ``test_torch_ragged_kernel.py`` says)."""
    from repro.kernels import mx_attention_ragged_fused as jragged

    rng = np.random.default_rng(7)
    r, w, kvh, g, d, ps, npg = 3, 8, 2, 2, 16, 4, 12
    table = np.full((r, 6), -1, np.int32)
    table[0, :6] = [0, 1, 2, 3, 4, 5]
    table[1, :2] = [6, 7]
    table[2, :3] = [8, 9, 10]
    starts = np.array([16, 0, 6], np.int32)
    lens = np.array([21, 8, 12], np.int32)
    q = (rng.standard_normal((r, kvh, w, g, d)) * 4).astype(np.float32)
    k = rng.standard_normal((r, w, kvh, d)).astype(np.float32)
    v = rng.standard_normal((r, w, kvh, d)).astype(np.float32)
    jq = jnp.asarray(q, jnp.bfloat16)
    jk = jnp.asarray(k, jnp.bfloat16)
    jv = jnp.asarray(v, jnp.bfloat16)
    pools = [np.zeros((npg, ps, kvh, d), np.uint8),
             np.full((npg, ps, kvh, d // 16), 127, np.uint8)] * 2
    fill = rng.integers(0, 120, (npg, ps, kvh, d)).astype(np.uint8)
    pools[0] = fill
    pools[2] = fill[::-1].copy()
    jpools = [jnp.asarray(p).view(jnp.float8_e4m3fn) if i % 2 == 0
              else jnp.asarray(p) for i, p in enumerate(pools)]
    want = jax.jit(lambda *a: jragged(
        *a, fmt_name="fp8_e4m3", block_size=16, softcap=50.0, window=8,
        interpret=True))(jq, jk, jv, *jpools, table, starts, lens)

    def t(a):
        return torch.from_numpy(np.array(a.astype(jnp.float32))).bfloat16()
    tpools = [torch.from_numpy(p.copy()).view(torch.float8_e4m3fn)
              if i % 2 == 0 else torch.from_numpy(p.copy())
              for i, p in enumerate(pools)]
    got = mx_attention.mx_attention_ragged_fused(
        t(jq), t(jk), t(jv), *tpools, torch.from_numpy(table),
        torch.from_numpy(starts), torch.from_numpy(lens),
        fmt_name="fp8_e4m3", block_size=16, softcap=50.0, window=8)
    np.testing.assert_allclose(got[0].float().numpy(),
                               np.asarray(want[0], np.float32),
                               rtol=OUT_RTOL, atol=OUT_RTOL)
    for g, w in zip(got[1], want[1]):
        np.testing.assert_array_equal(g.view(torch.uint8).numpy(),
                                      np.asarray(w).view(np.uint8))
