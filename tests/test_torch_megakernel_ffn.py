"""The megakernel's (#8) fused layer tail for the reference's three FFN
kinds: the gated SwiGLU and GeGLU, and musicgen's no-gate GELU.

Small models (d_model 64, 4 query heads of 16 over 2 or 4 KV heads, d_ff
128, two layers, page 8) and the reference test's row mix (starts 13, 9,
0, 12; n_new 1, 3, W, W) over decoy-filled pools. Bars:

  * the port's megakernel step (its plain version on the CPU) against its
    own per-layer ragged step, GeGLU and GELU: logits and every pool byte
    bit-equal;
  * against the reference's ``model.megakernel_step_paged`` (jitted,
    #8 in Pallas interpret mode) on weights carried over with
    ``params_from_jax``: logits and every pool byte bit-equal (measured;
    the SwiGLU kind's bar in ``tests/test_torch_megakernel.py`` is one
    ulp, as its pools' fp8 codes may round apart);
  * the wrapper refuses an unknown kind, a gated kind without a gate and
    the GELU kind with one, with ``ValueError``;
  * the product plan without a gate: the up product alone in plain
    128-column tiles, every tile once, at musicgen's widths one wave a
    phase on 132 SMs;
  * on the card (``cuda``), the kernel against its plain version for both
    kinds at G 1 and 2, head_dim 16 and 64: logits within one bf16 ulp of
    the largest with equal argmax, at most CODE_FRACTION of the pool
    codes apart, visits equal.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import MXFP8  # noqa: E402
from repro_torch.kernels import mx_megakernel as tmk  # noqa: E402
from repro_torch.nn import BlockDef, ModelConfig  # noqa: E402
from repro_torch.nn import embedding as tembedding  # noqa: E402
from repro_torch.nn import model as tmodel  # noqa: E402

PS = 8
NUM_PAGES = 12
CODE_FRACTION = 1e-3
KINDS = ("geglu", "gelu")
POOL_KEYS = tmodel.POOL_KEYS


def _dims(kind, kv_heads=2, head_dim=16, d_model=64, d_ff=128):
    return dict(name="t", family="dense", d_model=d_model, vocab_size=128,
                num_groups=2, num_heads=4, num_kv_heads=kv_heads,
                head_dim=head_dim, d_ff=d_ff, ffn_kind=kind)


QUANT = dict(fmt="fp8_e4m3", block_size=16, quantize_acts=False,
             quantize_kv_cache=True)


def _tcfg(kind, **kw):
    return ModelConfig(pattern=(BlockDef("attn"),),
                       quant=MXFP8.replace(**QUANT), **_dims(kind, **kw))


def _decoys(cfg, rng):
    """Per-layer decoy pool bytes: normal values in the fp8 pools, scales
    118-133."""
    layer = tmodel.init_paged_cache(cfg, NUM_PAGES, PS, "cpu")[0]
    out = []
    for _ in range(cfg.num_layers):
        pool = {}
        for key, t in layer.items():
            if key.endswith("_scales"):
                pool[key] = rng.integers(118, 134, t.shape).astype(np.uint8)
            else:
                pool[key] = torch.from_numpy(rng.normal(size=t.shape).astype(
                    np.float32)).to(t.dtype).view(torch.uint8).numpy()
        out.append(pool)
    return out


def _load(cache, decoys):
    for pool, src in zip(cache, decoys):
        for key, t in pool.items():
            t.view(torch.uint8).copy_(torch.from_numpy(src[key]).to(
                t.device))


def _rows(cfg, rng, w=8):
    """Decode from a mid-page start, a 3-token window across a page
    boundary, a fresh chunk and an unaligned continuation chunk."""
    starts = np.asarray([13, 9, 0, 12], np.int32)
    lens = starts + np.asarray([1, 3, w, w], np.int32)
    pages_per = [-(-int(t) // PS) for t in lens]
    perm = rng.permutation(NUM_PAGES - 1)
    table = np.full((4, max(pages_per) + 1), -1, np.int32)
    off = 0
    for i, npg in enumerate(pages_per):
        table[i, :npg] = perm[off:off + npg]
        off += npg
    tokens = rng.integers(0, cfg.vocab_size, (4, w)).astype(np.int32)
    return tokens, table, starts, lens, np.zeros(4, np.int32)


def _pool_bytes(cache):
    return [cache.stack[k].view(torch.uint8).cpu().numpy() for k in POOL_KEYS]


def _step(fn, params, cfg, decoys, args, device="cpu"):
    cache = tmodel.init_paged_cache(cfg, NUM_PAGES, PS, device)
    _load(cache, decoys)
    targs = [torch.from_numpy(a).to(device) for a in args]
    targs[0] = targs[0].long()
    logits = fn(params, cfg, cache, *targs)
    return logits.cpu().numpy(), _pool_bytes(cache)


@pytest.mark.parametrize("kind", KINDS)
def test_megakernel_step_bit_matches_ragged_step(kind):
    tcfg = _tcfg(kind)
    rng = np.random.default_rng(11)
    params = tmodel.init(tcfg, torch.Generator().manual_seed(0), "cpu")
    assert ("gate" in params["layer_stack"]["ffn"]) == (kind == "geglu")
    decoys = _decoys(tcfg, rng)
    args = _rows(tcfg, rng)
    la, pa = _step(tmodel.ragged_step_paged, params, tcfg, decoys, args)
    lb, pb = _step(tmodel.megakernel_step_paged, params, tcfg, decoys, args)
    assert np.isfinite(la).all()
    np.testing.assert_array_equal(la.view(np.int32), lb.view(np.int32))
    for x, y in zip(pa, pb):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("kind", KINDS)
def test_megakernel_step_equals_the_reference(kind):
    jax = pytest.importorskip("jax")
    jnp = jax.numpy
    from repro.core import MXFP8 as JMXFP8
    from repro.nn import BlockDef as JBlockDef
    from repro.nn import ModelConfig as JModelConfig
    from repro.nn import model as jmodel

    jcfg = JModelConfig(pattern=(JBlockDef("attn"),),
                        quant=JMXFP8.replace(**QUANT),
                        decode_kernel="fused", **_dims(kind))
    tcfg = _tcfg(kind)
    rng = np.random.default_rng(5)
    jparams, _ = jmodel.init(jax.random.PRNGKey(1), jcfg)
    tparams = tmodel.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), tcfg, "cpu")
    decoys = _decoys(tcfg, rng)
    args = _rows(tcfg, rng)
    jcache = jmodel.init_megakernel_cache(jcfg, 4, NUM_PAGES, PS)
    jleaves = {key: jnp.asarray(np.stack([d[key] for d in decoys]).view(
        leaf.dtype)) for key, leaf in jcache["groups"][0].items()}
    want, jcache = jax.jit(lambda p, c, *a: jmodel.megakernel_step_paged(
        p, jcfg, c, *a))(jmodel.pack_megakernel_params(jparams, jcfg),
                         {"groups": (jleaves,)}, *map(jnp.asarray, args))
    got, pools = _step(tmodel.megakernel_step_paged, tparams, tcfg, decoys,
                       args)
    np.testing.assert_array_equal(got, np.asarray(want)[:, 0])
    for key, g in zip(POOL_KEYS, pools):
        np.testing.assert_array_equal(
            g, np.asarray(jcache["groups"][0][key]).view(np.uint8),
            err_msg=key)


def test_wrapper_refuses_mismatched_kinds():
    tcfg = _tcfg("gelu")
    params = tmodel.init(tcfg, torch.Generator().manual_seed(0), "cpu")
    lay, pools = tmodel.megakernel_stacks(params, tmodel.init_paged_cache(
        tcfg, NUM_PAGES, PS, "cpu"))
    up = lay["ffn"]["up"]["w"]
    x = torch.zeros((1, 8, 64), dtype=torch.bfloat16)
    i32 = dict(dtype=torch.int32)
    rows = (torch.full((1, 2), -1, **i32), torch.zeros(1, **i32),
            torch.ones(1, **i32))
    head = (x, lay["norm_mixer"]["scale"],
            *(lay["mixer"][k]["w"] for k in ("wq", "wk", "wv", "wo")),
            lay["norm_ffn"]["scale"])
    kw = dict(head_dim=16, rope_theta=1e4, norm_eps=1e-6, block_size=16)
    for kind, gate, match in (("relu", None, "unknown ffn_kind"),
                              ("swiglu", None, "takes a gate"),
                              ("geglu", None, "takes a gate"),
                              ("gelu", up, "takes no gate")):
        with pytest.raises(ValueError, match=match):
            tmk.mx_megakernel_step(*head, gate, up, lay["ffn"]["down"]["w"],
                                   *pools, *rows, ffn_kind=kind, **kw)


def _cdiv(a, b):
    return -(-a // b)


@pytest.mark.parametrize("m", [8, 512, 2048])
def test_plan_without_a_gate_covers_every_tile_once(m):
    """musicgen's widths: the up product alone, 128 columns a tile, every
    tile once; at 512 rows one wave a phase on 132 SMs."""
    plan = tmk.megakernel_plan(m, 1536, 1536, 1536, 6144, 132, gated=False)
    gu = plan["gate_up"]
    assert not any(ph["pair"] for ph in plan.values())
    assert gu["tiles"] == gu["tm"] * _cdiv(6144, tmk.TILE_N)
    units = tmk.plan_units(plan, "gate_up")
    assert len(set(units)) == len(units) == gu["tiles"]
    assert set(units) == {(0, a, b) for a in range(gu["tm"])
                          for b in range(_cdiv(6144, tmk.TILE_N))}
    if m == 512:
        got = {k: (v["rows"], v["tiles"]) for k, v in plan.items()}
        assert got == {"qkv": (256, 72), "wo": (128, 48),
                       "gate_up": (256, 96), "down": (128, 48)}


# ---------------------------------------------------------------------------
# on the card: the kernel against its plain version
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return "cuda"


def _stack_step(params, cfg, cache, tokens, table, starts, lens, lidx,
                plain=False):
    lay, pools = tmodel.megakernel_stacks(params, cache)
    x = tembedding.embed(params["embedding"], tokens, cfg.compute_dtype)
    ffn = lay["ffn"]
    weights = [lay["mixer"][k]["w"] for k in ("wq", "wk", "wv", "wo")] + [
        ffn[k]["w"] if k in ffn else None for k in ("gate", "up", "down")]
    norms = (lay["norm_mixer"]["scale"], lay["norm_ffn"]["scale"])
    kw = dict(head_dim=cfg.head_dim, rope_theta=cfg.rope_theta,
              norm_eps=cfg.norm_eps, fmt_name=cfg.quant.fmt,
              block_size=min(cfg.quant.block_size, cfg.head_dim),
              softcap=None, window=None, page_fmts=None, mixed_fmts=None,
              ffn_kind=cfg.ffn_kind)
    if plain:
        t, s, n = tmk.normalize_rows(table, starts, lens, pools[0].shape[1],
                                     x.shape[1])
        x, visits = tmk.mx_megakernel_step_plain(x, weights, norms, pools,
                                                 t, s, n, **kw)
    else:
        x, _, visits = tmk.mx_megakernel_step(
            x, norms[0], *weights[:4], norms[1], *weights[4:], *pools, table,
            starts, lens, quant=cfg.quant, debug_visits=True, **kw)
    return tmodel._ragged_head(params, cfg, x, starts, lens, lidx), visits


@pytest.mark.cuda
@pytest.mark.parametrize("kind", KINDS)
def test_cuda_kernel_matches_plain_version(kind, cuda_device):
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cuda.matmul.allow_tf32 = False
    launches = tmk.mx_megakernel_step.launches
    cases = [dict(), dict(kv_heads=4), dict(kv_heads=4, head_dim=64,
                                            d_model=256, d_ff=1024)]
    for case in cases:
        tcfg = _tcfg(kind, **case)
        rng = np.random.default_rng(13)
        params = tmodel.init(tcfg, torch.Generator(cuda_device).manual_seed(2),
                             cuda_device)
        decoys = _decoys(tcfg, rng)
        args = _rows(tcfg, rng)
        runs = []
        for plain in (True, False):
            cache = tmodel.init_paged_cache(tcfg, NUM_PAGES, PS, cuda_device)
            _load(cache, decoys)
            targs = [torch.from_numpy(a).to(cuda_device) for a in args]
            targs[0] = targs[0].long()
            logits, visits = _stack_step(params, tcfg, cache, *targs,
                                         plain=plain)
            torch.cuda.synchronize()
            runs.append((logits.cpu().numpy(), _pool_bytes(cache),
                         visits.cpu()))
        (want, wpools, wvis), (got, gpools, gvis) = runs
        tol = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
        np.testing.assert_allclose(got, want, rtol=0, atol=tol,
                                   err_msg=str(case))
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
        assert torch.equal(gvis, wvis) and int(wvis.sum()) > 0, case
        trash = NUM_PAGES - 1
        diff = sum(int((g[:, :trash] != w[:, :trash]).sum())
                   for g, w in zip(gpools, wpools))
        total = sum(w[:, :trash].size for w in wpools)
        assert diff / total <= CODE_FRACTION, (case, diff, total)
    assert tmk.mx_megakernel_step.launches - launches == len(cases)
