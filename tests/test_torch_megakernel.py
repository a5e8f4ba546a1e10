"""The port's layer-fused megakernel step (``step_mode="megakernel"``).

``repro_torch.kernels.mx_megakernel_step`` on CPU tensors runs its plain
version, the port's per-layer ragged step composed over the stacked
weights and pools; on CUDA tensors it launches one persistent kernel per
step (``csrc/mx_megakernel.cu``). Small models (head_dim 16-32, 1-3
layers, page 8) and the reference test's row mix (starts 13, 9, 0, 12;
n_new 1, 3, W, W; decoy-filled pools; ``tests/test_megakernel.py``).

Bars:
  * the port's megakernel step against its own per-layer ragged step:
    bit-identical logits, every pool byte, and visits summed over layers;
  * against the reference's ``model.megakernel_step_paged`` (jitted,
    Pallas in interpret mode), on weights carried over with
    ``params_from_jax``: ``test_torch_model_step.py``'s bar, logits
    within one bf16 ulp of the largest, equal argmax, at most
    CODE_FRACTION of the pool codes differing;
  * the fallback ladder's reasons equal the reference's, string for
    string; engine streams equal the port's ragged engine's and the
    reference's megakernel engine's (seed chosen so that every greedy
    pick leads by more than one bf16 ulp, asserted);
  * one megakernel call per engine step against L ragged-kernel calls.
The ``cuda``-marked case holds the kernel against its plain version on
the card, with the bar above.
"""
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import MXFP8, quantize  # noqa: E402
from repro_torch.kernels import mx_megakernel as tmk  # noqa: E402
from repro_torch.nn import BlockDef, ModelConfig  # noqa: E402
from repro_torch.nn import attention as tattention  # noqa: E402
from repro_torch.nn import blocks as tblocks  # noqa: E402
from repro_torch.nn import embedding as tembedding  # noqa: E402
from repro_torch.nn import model as tmodel  # noqa: E402
from repro_torch.serve import (ContinuousBatchingEngine,  # noqa: E402
                               ServeConfig, TierPolicy)

PS = 8
NUM_PAGES = 12
CODE_FRACTION = 1e-3
GAP_TOL_ULPS = 1
#: model seed of the engine streams: every greedy pick of the port's runs
#: leads its runner-up by more than GAP_TOL_ULPS (asserted)
STREAM_SEED = 10
POOL_KEYS = tmodel.POOL_KEYS


def _ref():
    """The JAX reference's modules (the tests that compare with it import
    JAX here, so that the ``cuda`` case runs where JAX is absent)."""
    jax = pytest.importorskip("jax")
    from repro.core import MXFP8 as JMXFP8
    from repro.nn import BlockDef as JBlockDef
    from repro.nn import ModelConfig as JModelConfig
    from repro.nn import blocks, model
    from repro.serve import ContinuousBatchingEngine, ServeConfig
    from repro.serve import TierPolicy as JTierPolicy
    return SimpleNamespace(jax=jax, jnp=jax.numpy, MXFP8=JMXFP8,
                           BlockDef=JBlockDef, ModelConfig=JModelConfig,
                           blocks=blocks, model=model,
                           Engine=ContinuousBatchingEngine,
                           ServeConfig=ServeConfig, TierPolicy=JTierPolicy)


def _dims(fmt="fp8_e4m3", block_size=16, head_dim=16, num_groups=2,
          window=None, d_model=64, d_ff=128):
    dims = dict(name="t", family="dense", d_model=d_model, vocab_size=128,
                num_groups=num_groups, num_heads=4, num_kv_heads=2,
                head_dim=head_dim, d_ff=d_ff)
    qkw = dict(fmt=fmt, block_size=block_size, quantize_acts=False,
               quantize_kv_cache=True)
    return dims, qkw, window


def _tcfg(**kw):
    """The port's config of the reference test's ``_cfg``."""
    dims, qkw, window = _dims(**kw)
    return ModelConfig(pattern=(BlockDef("attn", window=window),),
                       quant=MXFP8.replace(**qkw), **dims)


def _cfgs(**kw):
    """(reference cfg, port cfg) of the reference test's ``_cfg``."""
    ref = _ref()
    dims, qkw, window = _dims(**kw)
    jcfg = ref.ModelConfig(pattern=(ref.BlockDef("attn", window=window),),
                           quant=ref.MXFP8.replace(**qkw),
                           decode_kernel="fused", **dims)
    return jcfg, _tcfg(**kw)


def _port_params(ref, jparams, tcfg):
    return tmodel.params_from_jax(
        ref.jax.tree_util.tree_map(np.asarray, jparams), tcfg, "cpu")


def _decoys(cfg, rng, tiered):
    """Per-layer decoy pool bytes (the reference test's fill): random bytes
    in uint8 pools, normal values in fp8 pools, scales 118-133."""
    layer = tblocks.init_paged_cache(NUM_PAGES, PS, cfg.pattern[0], cfg,
                                     "cpu", tiered=tiered)
    out = []
    for _ in range(cfg.num_layers):
        pool = {}
        for key, t in layer.items():
            if key.endswith("_scales"):
                pool[key] = rng.integers(118, 134, t.shape).astype(np.uint8)
            elif t.dtype == torch.uint8:
                pool[key] = rng.integers(0, 256, t.shape).astype(np.uint8)
            else:
                pool[key] = torch.from_numpy(rng.normal(size=t.shape).astype(
                    np.float32)).to(t.dtype).view(torch.uint8).numpy()
        out.append(pool)
    return out


def _load(cache, decoys):
    for pool, src in zip(cache, decoys):
        for key, t in pool.items():
            t.view(torch.uint8).copy_(torch.from_numpy(src[key]))


def _rows(cfg, rng, w=8, tiered=False):
    """The reference test's rows: a decode from a mid-page start, a 3-token
    window across a page boundary, a fresh chunk and an unaligned
    continuation chunk; tables from a permutation that never hands out
    the trash page; tiered: page formats with written pages in fp8."""
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
    fmts = None
    if tiered:
        fmts = rng.integers(0, 3, (NUM_PAGES,)).astype(np.int32)
        fmts[table[table >= 0]] = 0  # the hot-write invariant
    return (tokens, table, starts, lens, np.zeros(4, np.int32)), fmts


def _pool_bytes(cache):
    return [pool[k].view(torch.uint8).numpy().copy() for pool in cache
            for k in POOL_KEYS]


class _Recorder:
    """Wraps a kernel wrapper: counts its calls and keeps the visits of
    each (run with ``debug_visits=True``)."""

    def __init__(self, fn):
        self.fn, self.calls, self.visits = fn, 0, []

    def __call__(self, *args, **kw):
        self.calls += 1
        *out, visits = self.fn(*args, **kw, debug_visits=True)
        self.visits.append(visits)
        return tuple(out)


def _port_steps(tcfg, params, decoys, args, fmts, monkeypatch):
    """The port's ragged step and megakernel step over the same decoys:
    (logits, pool bytes, visits summed over layers) of each."""
    targs = [torch.from_numpy(a) for a in args]
    targs[0] = targs[0].long()
    kw = {}
    if fmts is not None:
        kw = dict(page_fmts=torch.from_numpy(fmts),
                  mixed_fmts=("fp8_e4m3", "fp6_e3m2", "fp4_e2m1"))
    out = {}
    for mode in ("ragged", "megakernel"):
        cache = tmodel.init_paged_cache(tcfg, NUM_PAGES, PS, "cpu",
                                        tiered=fmts is not None)
        _load(cache, decoys)
        if mode == "ragged":
            rec = _Recorder(tattention.mx_attention_ragged_fused)
            monkeypatch.setattr(tattention, "mx_attention_ragged_fused", rec)
            logits = tmodel.ragged_step_paged(params, tcfg, cache, *targs,
                                              **kw)
        else:
            rec = _Recorder(tmk.mx_megakernel_step)
            monkeypatch.setattr(tmk, "mx_megakernel_step", rec)
            logits = tmodel.megakernel_step_paged(params, tcfg, cache,
                                                  *targs, **kw)
        monkeypatch.undo()
        # per call: (R, KVH, 1) of one layer, or (L, R, KVH, 1)
        visits = torch.cat([v.reshape(-1, *v.shape[-3:])
                            for v in rec.visits])
        out[mode] = (logits, _pool_bytes(cache), visits.sum(0))
    return out


# ---------------------------------------------------------------------------
# (a) the megakernel step against the port's per-layer ragged step
# ---------------------------------------------------------------------------

STEP_CASES = {
    **{f"{fmt}-b{bs}": dict(fmt=fmt, block_size=bs, head_dim=bs,
                            d_model=4 * bs)
       for fmt in ("fp8_e4m3", "fp8_e5m2", "fp4_e2m1") for bs in (16, 32)},
    "window": dict(window=12),
    "tiered-L1": dict(num_groups=1, tiered=True),
    "tiered-L3": dict(num_groups=3, tiered=True)}


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_megakernel_step_bit_matches_ragged_step(case, monkeypatch):
    kw = dict(STEP_CASES[case])
    tiered = kw.pop("tiered", False)
    tcfg = _tcfg(**kw)
    rng = np.random.default_rng(11)
    params = tmodel.init(tcfg, torch.Generator().manual_seed(0), "cpu")
    decoys = _decoys(tcfg, rng, tiered)
    args, fmts = _rows(tcfg, rng, tiered=tiered)
    out = _port_steps(tcfg, params, decoys, args, fmts, monkeypatch)
    (la, pa, va), (lb, pb, vb) = out["ragged"], out["megakernel"]
    assert torch.isfinite(la).all()
    assert torch.equal(la.view(torch.int32), lb.view(torch.int32))
    for x, y in zip(pa, pb):
        np.testing.assert_array_equal(x, y)
    assert torch.equal(va, vb) and int(va.sum()) > 0


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


def _assert_one_copy(params, cache, layers):
    """Every per-layer weight and pool tensor is the slice of its (L, ...)
    stack: same pointer, shape and strides."""
    lay, pools = tmodel.megakernel_stacks(params, cache)
    stacks = dict(_leaves(lay))
    assert all(t.shape[0] == layers for t in stacks.values())
    for li, bp in enumerate(params["layers"]):
        leaves = dict(_leaves(bp))
        assert leaves.keys() == stacks.keys()
        for path, leaf in leaves.items():
            view = stacks[path][li]
            assert leaf.data_ptr() == view.data_ptr() \
                and leaf.shape == view.shape \
                and leaf.stride() == view.stride(), path
    assert all(p.shape[:2] == (layers, NUM_PAGES) for p in pools)
    for li, pool in enumerate(cache):
        for key, stack in zip(tmodel.POOL_KEYS, pools):
            assert pool[key].data_ptr() == stack[li].data_ptr()


def test_init_lays_out_one_copy_of_the_weights():
    """``model.init`` and ``init_paged_cache`` lay a uniform stack out as
    one (L, ...) tensor per leaf with the per-layer entries its slices,
    so the megakernel and the per-layer step read the same bytes; the
    values are those of one block made at a time; params or a cache
    without stacks are refused by name."""
    tcfg = _tcfg(num_groups=3)
    params = tmodel.init(tcfg, torch.Generator().manual_seed(0), "cpu")
    cache = tmodel.init_paged_cache(tcfg, NUM_PAGES, PS, "cpu")
    _assert_one_copy(params, cache, 3)
    gen = torch.Generator().manual_seed(0)
    tembedding.init(gen, tcfg.vocab_size, tcfg.d_model,
                    tcfg.tied_embeddings, "cpu", tcfg.compute_dtype)
    for bp in params["layers"]:
        want = dict(_leaves(tblocks.init(gen, tcfg.pattern[0], tcfg, "cpu")))
        for path, leaf in _leaves(bp):
            assert torch.equal(leaf, want[path]), path
    with pytest.raises(ValueError, match="uniform layer stack"):
        tmodel.megakernel_stacks(params, list(cache))
    with pytest.raises(ValueError, match="uniform layer stack"):
        tmodel.megakernel_stacks({"layers": params["layers"]}, cache)


def test_params_from_jax_lays_out_one_copy_of_the_weights():
    """The reference's weights carried over keep the same layout."""
    ref = _ref()
    jcfg, tcfg = _cfgs(num_groups=3)
    jparams, _ = ref.model.init(ref.jax.random.PRNGKey(1), jcfg)
    params = _port_params(ref, jparams, tcfg)
    cache = tmodel.init_paged_cache(tcfg, NUM_PAGES, PS, "cpu", tiered=True)
    _assert_one_copy(params, cache, 3)
    wq = np.asarray(jparams["groups"]["block0"]["mixer"]["wq"]["w"],
                    np.float32)
    assert params["layer_stack"]["mixer"]["wq"]["w"].shape == wq.shape


def test_wrapper_prechecks_match_reference():
    """The reference's refusals: a tiered step needs an fp8 hot format,
    activation quantization is refused; uniform fp6 pools have no
    layout, as in the ragged kernel."""
    tcfg = _tcfg(num_groups=1)
    params = tmodel.init(tcfg, torch.Generator().manual_seed(0), "cpu")
    lay, pools = tmodel.megakernel_stacks(params, tmodel.init_paged_cache(
        tcfg, NUM_PAGES, PS, "cpu", tiered=True))
    x = torch.zeros((1, 8, 64), dtype=torch.bfloat16)
    i32 = dict(dtype=torch.int32)
    rows = (torch.full((1, 2), -1, **i32), torch.zeros(1, **i32),
            torch.ones(1, **i32))
    weights = [lay["norm_mixer"]["scale"],
               *(lay["mixer"][k]["w"] for k in ("wq", "wk", "wv", "wo")),
               lay["norm_ffn"]["scale"],
               *(lay["ffn"][k]["w"] for k in ("gate", "up", "down"))]
    kw = dict(head_dim=16, rope_theta=1e4, norm_eps=1e-6, block_size=16)
    with pytest.raises(ValueError, match="must be an fp8"):
        tmk.mx_megakernel_step(x, *weights, *pools, *rows, fmt_name="fp4_e2m1",
                               page_fmts=torch.zeros(NUM_PAGES,
                                                     dtype=torch.int32), **kw)
    with pytest.raises(ValueError, match="activation quantization"):
        tmk.mx_megakernel_step(x, *weights, *pools, *rows,
                               quant=MXFP8.replace(quantize_acts=True),
                               page_fmts=torch.zeros(NUM_PAGES,
                                                     dtype=torch.int32), **kw)
    fp6 = tuple(p.clone() for p in pools)
    with pytest.raises(ValueError, match="uniform fp6"):
        tmk.mx_megakernel_step(x, *weights, *fp6, *rows, fmt_name="fp6_e3m2",
                               **kw)


# ---------------------------------------------------------------------------
# (b) the megakernel step against the reference's
# ---------------------------------------------------------------------------


def _assert_near_reference(got, want, tcache, jcache):
    tol = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    jleaves = jcache["groups"][0]
    differing = total = 0
    trash = NUM_PAGES - 1
    for li, pool in enumerate(tcache):
        for key in POOL_KEYS:
            g = pool[key].view(torch.uint8).numpy()[:trash]
            w = np.asarray(jleaves[key][li]).view(np.uint8)[:trash]
            differing += int((g != w).sum())
            total += g.size
    assert differing / total <= CODE_FRACTION, (differing, total)
    return differing


@pytest.mark.parametrize("case", ["fp8_e4m3", "tiered"])
def test_megakernel_step_matches_reference(case):
    ref = _ref()
    jnp, jmodel = ref.jnp, ref.model
    tiered = case == "tiered"
    jcfg, tcfg = _cfgs(num_groups=2)
    rng = np.random.default_rng(5)
    jparams, _ = jmodel.init(ref.jax.random.PRNGKey(1), jcfg)
    tparams = _port_params(ref, jparams, tcfg)
    decoys = _decoys(tcfg, rng, tiered)
    args, fmts = _rows(tcfg, rng, tiered=tiered)
    jcache = jmodel.init_paged_cache(jcfg, 4, NUM_PAGES, PS, tiered=tiered)
    jleaves = {}
    for key, leaf in jcache["groups"][0].items():
        raw = np.stack([d[key] for d in decoys])
        jleaves[key] = jnp.asarray(raw.view(leaf.dtype))
    kw = {} if fmts is None else {"page_fmts": jnp.asarray(fmts)}
    want, jcache = ref.jax.jit(lambda p, c, *a: jmodel.megakernel_step_paged(
        p, jcfg, c, *a, **kw))(jmodel.pack_megakernel_params(jparams, jcfg),
                               {"groups": (jleaves,)},
                               *map(jnp.asarray, args))
    tcache = tmodel.init_paged_cache(tcfg, NUM_PAGES, PS, "cpu",
                                     tiered=tiered)
    _load(tcache, decoys)
    targs = [torch.from_numpy(a) for a in args]
    tkw = {} if fmts is None else {"page_fmts": torch.from_numpy(fmts)}
    got = tmodel.megakernel_step_paged(tparams, tcfg, tcache,
                                       targs[0].long(), *targs[1:], **tkw)
    _assert_near_reference(got.numpy(), np.asarray(want)[:, 0], tcache,
                           jcache)


# ---------------------------------------------------------------------------
# (c) the reject-reason ladder, string for string
# ---------------------------------------------------------------------------

LADDER = {
    "accepted": {},
    "non-attention": dict(pattern=("ssd",)),
    "non-uniform": dict(pattern=("attn", ("attn", 8))),
    "two-block pattern": dict(pattern=("attn", "attn")),
    "prologue": dict(prologue=("attn",)),
    "ffn": dict(pattern=(("attn", None, "none"),)),
    "activation quantization": dict(quantize_acts=True),
    "wide KV pool": dict(quantize_kv_cache=False),
    "empty": dict(pattern=(), num_groups=0)}


def _ladder_cfgs(ref, case):
    jcfg, tcfg = _cfgs()
    spec = LADDER[case]

    def blocks_of(bdef, names):
        out = []
        for b in names:
            b = (b,) if isinstance(b, str) else b
            out.append(bdef(b[0], *b[1:2], **({"ffn": b[2]}
                                              if len(b) > 2 else {})))
        return tuple(out)

    jkw, tkw = {}, {}
    for key in ("pattern", "prologue"):
        if key in spec:
            jkw[key] = blocks_of(ref.BlockDef, spec[key])
            tkw[key] = blocks_of(BlockDef, spec[key])
    if "num_groups" in spec:
        jkw["num_groups"] = tkw["num_groups"] = spec["num_groups"]
    for key in ("quantize_acts", "quantize_kv_cache"):
        if key in spec:
            jkw["quant"] = jcfg.quant.replace(**{key: spec[key]})
            tkw["quant"] = tcfg.quant.replace(**{key: spec[key]})
    return jcfg.replace(**jkw), tcfg.replace(**tkw)


@pytest.mark.parametrize("case", list(LADDER))
def test_reject_reason_equals_reference(case):
    ref = _ref()
    jcfg, tcfg = _ladder_cfgs(ref, case)
    want = ref.blocks.megakernel_reject_reason(jcfg)
    assert tblocks.megakernel_reject_reason(tcfg) == want
    assert (want is None) == (case == "accepted")


# ---------------------------------------------------------------------------
# (d) engine streams; (f) calls per step
# ---------------------------------------------------------------------------


def _churn_reqs(rng):
    return [(rng.integers(0, 128, (s,)).astype(np.int32), m)
            for s, m in [(4, 12), (4, 12), (7, 5), (3, 8)]]


SCENARIOS = {
    "churn-prefix": dict(max_seq=24, max_slots=2, page_size=4, num_pages=7,
                         prefix_cache=True),
    "chunked": dict(max_seq=48, max_slots=2, page_size=8, prefill_chunk=8),
    "tiered": dict(max_seq=48, max_slots=2, page_size=8, prefill_chunk=8,
                   num_pages=14, tiered=True)}
#: the tiered scenario's policy (both packages): pages demote after one
#: idle step, so the repack runs on the stacked pools' per-layer views
TIERS = dict(hot_steps=1, cold_steps=3)


def _serve_port(tparams, tcfg, reqs, mode, monkeypatch, **serve):
    calls = {"ragged": _Recorder(tattention.mx_attention_ragged_fused),
             "megakernel": _Recorder(tmk.mx_megakernel_step)}
    monkeypatch.setattr(tattention, "mx_attention_ragged_fused",
                        calls["ragged"])
    monkeypatch.setattr(tmk, "mx_megakernel_step", calls["megakernel"])
    eng = ContinuousBatchingEngine(tparams, tcfg, ServeConfig(
        step_mode=mode, **serve), device="cpu")
    ids = [eng.submit(p, m) for p, m in reqs]
    out = eng.run()
    monkeypatch.undo()
    return [out[i] for i in ids], eng, {k: c.calls for k, c in calls.items()}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_megakernel_engine_streams(scenario, monkeypatch):
    """Port megakernel = port ragged = reference megakernel, request by
    request; the megakernel engine makes one megakernel call per ragged
    dispatch and no per-layer call, the ragged engine L per dispatch."""
    ref = _ref()
    jcfg, tcfg = _cfgs()
    reqs = _churn_reqs(np.random.default_rng(3))
    serve = dict(SCENARIOS[scenario])
    jserve = dict(serve)
    if serve.get("tiered"):
        serve["tier_policy"] = TierPolicy(**TIERS)
        jserve["tier_policy"] = ref.TierPolicy(**TIERS)
    jparams, _ = ref.model.init(ref.jax.random.PRNGKey(STREAM_SEED), jcfg)
    tparams = _port_params(ref, jparams, tcfg)
    ragged, reng, rcalls = _serve_port(tparams, tcfg, reqs, "ragged",
                                       monkeypatch, **serve)
    mega, meng, mcalls = _serve_port(tparams, tcfg, reqs, "megakernel",
                                     monkeypatch, **serve)
    jeng = ref.Engine(jparams, jcfg, ref.ServeConfig(step_mode="megakernel",
                                                     **jserve))
    ids = [jeng.submit(p, m) for p, m in reqs]
    jout = jeng.run()
    assert jeng.megakernel
    stats, rstats = meng.cache_stats(), reng.cache_stats()
    assert stats["megakernel"] and stats["step_mode"] == "megakernel"
    assert not rstats["megakernel"] and rstats["step_mode"] == "ragged"
    assert stats["min_top2_gap_ulps"] > GAP_TOL_ULPS
    assert rstats["min_top2_gap_ulps"] > GAP_TOL_ULPS
    for r, m, i in zip(ragged, mega, ids):
        np.testing.assert_array_equal(m, r)
        np.testing.assert_array_equal(m, jout[i])
    # (f): 1 wrapper call per step against L
    steps = stats["ragged_steps"]
    assert steps == rstats["ragged_steps"] > 0
    assert mcalls == {"megakernel": steps, "ragged": 0}
    assert rcalls == {"megakernel": 0, "ragged": steps * tcfg.num_layers}
    assert stats["launches_per_step"] is None  # CPU: nothing launched
    if scenario == "tiered":
        assert stats["repacked_pages"] > 0
        np.testing.assert_array_equal(meng.page_fmts, reng.page_fmts)


# ---------------------------------------------------------------------------
# (e) the fallback rungs
# ---------------------------------------------------------------------------


def test_fallback_to_ragged_serves_with_the_reason(monkeypatch):
    """A non-uniform window pattern fails the static ladder: the engine
    runs the per-layer ragged step, records the reference's reason, and
    serves the ragged engine's streams."""
    ref = _ref()
    jcfg, tcfg = _cfgs()
    pattern = dict(pattern=(BlockDef("attn"), BlockDef("attn", window=8)),
                   num_groups=1)
    tcfg = tcfg.replace(**pattern)
    jcfg = jcfg.replace(pattern=(ref.BlockDef("attn"),
                                 ref.BlockDef("attn", window=8)),
                        num_groups=1)
    params = tmodel.init(tcfg, torch.Generator().manual_seed(1), "cpu")
    reqs = _churn_reqs(np.random.default_rng(7))[:2]
    serve = dict(max_seq=32, max_slots=2, page_size=4, prefill_chunk=4)
    want, _, _ = _serve_port(params, tcfg, reqs, "ragged", monkeypatch,
                             **serve)
    got, eng, calls = _serve_port(params, tcfg, reqs, "megakernel",
                                  monkeypatch, **serve)
    assert not eng.megakernel and eng.ragged
    assert eng._megakernel_fallback_reason == \
        ref.blocks.megakernel_reject_reason(jcfg)
    assert eng.cache_stats()["step_mode"] == "ragged"
    assert calls["megakernel"] == 0 and calls["ragged"] > 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_fallback_to_split_and_runtime_rungs_match_reference():
    """Ragged prerequisites unmet (the einsum decode kernel): split
    dispatches, with the reference engine's reason; activation
    quantization and pre-quantized MXTensor weights: the per-layer
    ragged step, with the reference's reasons."""
    ref = _ref()
    jcfg, tcfg = _cfgs()
    serve = dict(step_mode="megakernel", max_seq=32, max_slots=2,
                 page_size=4)
    jparams, _ = ref.model.init(ref.jax.random.PRNGKey(0), jcfg)
    tparams = _port_params(ref, jparams, tcfg)
    jeng = ref.Engine(jparams, jcfg, ref.ServeConfig(decode_kernel="einsum",
                                                     **serve))
    eng = ContinuousBatchingEngine(tparams, tcfg, ServeConfig(
        decode_kernel="einsum", **serve), device="cpu")
    assert not eng.megakernel and not eng.ragged
    assert eng._megakernel_fallback_reason == \
        jeng._megakernel_fallback_reason
    assert "ragged prerequisites" in eng._megakernel_fallback_reason
    rid = eng.submit(np.arange(5, dtype=np.int32), 3)
    assert len(eng.run()[rid]) == 8
    assert eng.cache_stats()["step_mode"] == "split"
    acts = tcfg.replace(quant=tcfg.quant.replace(quantize_acts=True))
    eng = ContinuousBatchingEngine({}, acts, ServeConfig(**serve),
                                   device="cpu")
    assert not eng.megakernel and eng.ragged
    assert eng._megakernel_fallback_reason == \
        ref.blocks.megakernel_reject_reason(jcfg.replace(
            quant=jcfg.quant.replace(quantize_acts=True)))
    mx = {"layers": [{"mixer": {"wq": {"w": quantize(
        torch.ones((64, 64)), "fp8_e4m3", 16, axis=0)}}}]}
    eng = ContinuousBatchingEngine(mx, tcfg, ServeConfig(**serve),
                                   device="cpu")
    assert not eng.megakernel and eng.ragged
    assert eng._megakernel_fallback_reason == (
        "MXTensor (pre-quantized) weights — the megakernel pre-quantizes "
        "wide masters itself")


def test_launcher_serves_the_megakernel_step_on_cpu():
    from repro_torch.launch import serve

    report = serve.main(["--arch", "granite-8b", "--reduced", "--batch", "3",
                         "--prompt-len", "40", "--shared-prefix", "32",
                         "--ragged", "--new-tokens", "4", "--device", "cpu",
                         "--step-mode", "megakernel"])
    assert report["step_mode"] == "megakernel"
    assert report["generated_tokens"] == 12
    assert report["dispatches"]["ragged"] > 0
    assert report["kernel_launches"] == 0  # CPU tensors: the plain version
    assert report["launches_per_step"] is None


# ---------------------------------------------------------------------------
# on the card: the kernel against its plain version
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return "cuda"


def stack_step(params, cfg, cache, tokens, table, starts, lens, lidx,
               page_fmts=None, mixed_fmts=None, plain=False):
    """``model.megakernel_step_paged`` through the wrapper, or with
    ``plain`` its plain version, on any device: (logits, visits)."""
    lay, pools = tmodel.megakernel_stacks(params, cache)
    x = tembedding.embed(params["embedding"], tokens, cfg.compute_dtype)
    weights = [lay["mixer"][k]["w"] for k in ("wq", "wk", "wv", "wo")] \
        + [lay["ffn"][k]["w"] for k in ("gate", "up", "down")]
    norms = (lay["norm_mixer"]["scale"], lay["norm_ffn"]["scale"])
    kw = dict(head_dim=cfg.head_dim, rope_theta=cfg.rope_theta,
              norm_eps=cfg.norm_eps, fmt_name=cfg.quant.fmt,
              block_size=min(cfg.quant.block_size, cfg.head_dim),
              softcap=cfg.attn_softcap, window=cfg.all_blocks()[0].window,
              page_fmts=page_fmts, mixed_fmts=mixed_fmts)
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
def test_cuda_kernel_matches_plain_version(cuda_device):
    """On the card: logits within one bf16 ulp of the largest and the same
    argmax, at most CODE_FRACTION of the pool codes differing (the
    kernel's products sum in another order than cuBLAS), visits exact.
    head_dim 16 and 32, fp8 and fp4 pools, a window, a tiered pool; M, N
    and K off every product tile and TMA box (d_model 144, d_ff 336);
    granite-8b's d_ff (14336: down sums 224 stages in one CTA)."""
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cuda.matmul.allow_tf32 = False
    launches = tmk.mx_megakernel_step.launches
    mixed = ("fp8_e4m3", "fp6_e3m2", "fp4_e2m1")
    cases = [dict(), dict(fmt="fp4_e2m1", block_size=32, head_dim=32,
                          d_model=128), dict(window=12, num_groups=3),
             dict(tiered=True, num_groups=3),
             dict(d_model=144, d_ff=336), dict(d_ff=14336)]
    for case in cases:
        kw = dict(case)
        tiered = kw.pop("tiered", False)
        tcfg = _tcfg(**kw)
        rng = np.random.default_rng(13)
        params = tmodel.init(tcfg, torch.Generator(cuda_device).manual_seed(2),
                             cuda_device)
        decoys = _decoys(tcfg, rng, tiered)
        args, fmts = _rows(tcfg, rng, tiered=tiered)
        targs = [torch.from_numpy(a).to(cuda_device) for a in args]
        targs[0] = targs[0].long()
        fkw = {} if fmts is None else dict(
            page_fmts=torch.from_numpy(fmts).to(cuda_device),
            mixed_fmts=mixed)
        runs = []
        for step in ("plain", "kernel", "model"):
            cache = tmodel.init_paged_cache(tcfg, NUM_PAGES, PS, cuda_device,
                                            tiered=tiered)
            _load_device(cache, decoys)
            if step == "model":
                logits = tmodel.megakernel_step_paged(params, tcfg, cache,
                                                      *targs, **fkw)
                visits = runs[1][2]
            else:
                logits, visits = stack_step(params, tcfg, cache, *targs,
                                            plain=step == "plain", **fkw)
            torch.cuda.synchronize()
            runs.append((logits.cpu().numpy(), _pool_bytes_cpu(cache),
                         visits.cpu()))
        # the model step launches the same kernel on the same inputs
        np.testing.assert_array_equal(runs[2][0], runs[1][0])
        for g, w in zip(runs[2][1], runs[1][1]):
            np.testing.assert_array_equal(g[:, :NUM_PAGES - 1],
                                          w[:, :NUM_PAGES - 1])
        (want, wpools, wvis), (got, gpools, gvis) = runs[:2]
        tol = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
        np.testing.assert_allclose(got, want, rtol=0, atol=tol,
                                   err_msg=str(case))
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
        assert torch.equal(gvis, wvis) and int(wvis.sum()) > 0, case
        trash = NUM_PAGES - 1  # written by inactive rows: racy by contract
        diff = sum(int((g[:, :trash] != w[:, :trash]).sum())
                   for g, w in zip(gpools, wpools))
        total = sum(w[:, :trash].size for w in wpools)
        assert diff / total <= CODE_FRACTION, (case, diff, total)
    assert tmk.mx_megakernel_step.launches - launches == 2 * len(cases)


def _load_device(cache, decoys):
    for pool, src in zip(cache, decoys):
        for key, t in pool.items():
            t.view(torch.uint8).copy_(torch.from_numpy(src[key]).to(
                t.device))


def _pool_bytes_cpu(cache):
    return [cache.stack[k].view(torch.uint8).cpu().numpy()
            for k in POOL_KEYS]


# ---------------------------------------------------------------------------
# the product plan of the CUDA launch (host side, runs here)
# ---------------------------------------------------------------------------

#: (M, DM, HD, KVD, DFF): granite-8b at the main path's 512 rows and at a
#: decode step's 8, and the cuda case's shapes (the tiny model, M N and K
#: off the tiles, granite's d_ff)
PLAN_SHAPES = [(512, 4096, 4096, 1024, 14336), (8, 4096, 4096, 1024, 14336),
               (32, 64, 64, 32, 128), (32, 144, 64, 32, 336),
               (32, 64, 64, 32, 14336)]


def _cdiv(a, b):
    return -(-a // b)


@pytest.mark.parametrize("ctas", [132, 114, 64, 1])
@pytest.mark.parametrize("shape", PLAN_SHAPES,
                         ids=lambda s: "m{}_dm{}_dff{}".format(s[0], s[1],
                                                               s[4]))
def test_megakernel_plan_covers_every_tile_once(shape, ctas):
    """Every output tile of every job exactly once, each with its whole
    contraction (summed in order in one CTA); tile rows the kernel takes
    and covering M; the activation tile fastest, so the CTAs that share a
    weight column block run together; no plan slower than another tile
    size by the plan's own count (waves x bytes a stage)."""
    m, dm, hd, kvd, dff = shape
    plan = tmk.megakernel_plan(m, dm, hd, kvd, dff, ctas)
    assert tuple(plan) == tmk.PHASES
    for name, ph in plan.items():
        assert ph["rows"] in tmk.TILE_ROWS
        assert ph["tm"] == _cdiv(m, ph["rows"])
        assert (ph["tm"] - 1) * ph["rows"] < m <= ph["tm"] * ph["rows"]
        cols = tmk.TILE_N // 2 if ph["pair"] else tmk.TILE_N
        units = tmk.plan_units(plan, name)
        assert len(units) == ph["tiles"]
        want = {(j, a, b) for j, (n, _) in enumerate(ph["jobs"])
                for a in range(ph["tm"]) for b in range(_cdiv(n, cols))}
        assert len(set(units)) == len(units) and set(units) == want
        assert len({k for _, k in ph["jobs"]}) == 1  # the jobs share K
        for a, b in zip(units, units[1:]):
            if b[1]:  # same weight column block as the unit before
                assert (a[0], a[2]) == (b[0], b[2]) and b[1] == a[1] + 1
        waves = _cdiv(ph["tiles"], ctas)
        cost = waves * (2 * tmk.TILE_K * 128 + ph["rows"] * 128)
        for rows in tmk.TILE_ROWS:
            tiles = sum(_cdiv(m, rows) * _cdiv(n, cols)
                        for n, _ in ph["jobs"])
            assert cost <= _cdiv(tiles, ctas) * (2 * tmk.TILE_K * 128
                                                 + rows * 128)
    assert plan["gate_up"]["pair"] and not plan["qkv"]["pair"]


def test_megakernel_plan_at_granite_fills_the_card():
    """At granite-8b's shapes on 132 SMs: 256-row tiles for q/k/v (96)
    and gate/up (448 of 64 columns each), 128-row tiles for wo and down
    (128, where 256 rows would leave 64); no phase leaves a third of the
    CTAs idle."""
    plan = tmk.megakernel_plan(512, 4096, 4096, 1024, 14336, 132)
    got = {k: (v["rows"], v["tiles"]) for k, v in plan.items()}
    assert got == {"qkv": (256, 96), "wo": (128, 128),
                   "gate_up": (256, 448), "down": (128, 128)}
    for ph in plan.values():
        waves = _cdiv(ph["tiles"], 132)
        assert ph["tiles"] / (waves * 132) > 2 / 3
    with pytest.raises(ValueError):
        tmk.megakernel_plan(0, 64, 64, 32, 128, 132)
