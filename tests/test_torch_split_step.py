"""The port's split engine step against the reference's.

Model level: reduced granite-8b (2 layers, d_model 64, head_dim 16, MX
block 16, weight-only MXFP8), the reference's weights carried over with
``params_from_jax``. Two ``prefill_chunk_paged`` dispatches (two rows,
then one row whose padded final chunk reaches past its table) and one
``decode_step_paged`` (with an inactive slot) run on the fused MX path,
the einsum oracle and a wide bf16 pool. Bars: logits within one bf16 ulp
of the largest logit with the same argmax (the reference returns
bf16-rounded logits and sums f32 products in another order), and every
pool byte identical.

Engine level: the scenarios of the reference's own ragged-vs-split
identity test (``tests/test_ragged_step.py``) without speculation, on
its small model, through the reference's split engine and the port's:
streams equal, pool bytes after the drain equal, every step's page
formats equal when tiered, and the dispatch counts by kind equal. The
port's split and ragged engines give equal streams too. Every model here
is a seed whose greedy picks all lead their runner-up by more than one
bf16 ulp (asserted).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs import get_reduced as jax_reduced  # noqa: E402
from repro.core import MXFP8 as JAX_MXFP8  # noqa: E402
from repro.nn import BlockDef as JaxBlockDef  # noqa: E402
from repro.nn import ModelConfig as JaxModelConfig  # noqa: E402
from repro.nn import model as jmodel  # noqa: E402
from repro.serve import ContinuousBatchingEngine as JaxEngine  # noqa: E402
from repro.serve import ServeConfig as JaxServeConfig  # noqa: E402
from repro.serve import TierPolicy as JaxTierPolicy  # noqa: E402
from repro_torch.configs import get_reduced as torch_reduced  # noqa: E402
from repro_torch.core import MXFP8  # noqa: E402
from repro_torch.nn import BlockDef, ModelConfig  # noqa: E402
from repro_torch.nn import model as tmodel  # noqa: E402
from repro_torch.serve import (ContinuousBatchingEngine,  # noqa: E402
                               ServeConfig, TierPolicy)

GAP_TOL_ULPS = 1
#: engine-level weights: the first PRNGKey seed from 0 up whose greedy
#: picks lead their runner-up by more than GAP_TOL_ULPS in every scenario
#: and step mode below (the 128-token vocabulary ties often)
ENGINE_SEED = 47
POOL_KEYS = {"mx": ("k_elems", "k_scales", "v_elems", "v_scales"),
             "wide": ("k", "v")}


# ---------------------------------------------------------------------------
# model level
# ---------------------------------------------------------------------------


def _granite(path: str):
    """(reference cfg, port cfg) of reduced granite on ``path``: "fused"
    and "einsum" serve an MX fp8 cache, "wide" a bf16 one (fused
    requested: a wide pool takes the einsum gather all the same)."""
    kernel = "einsum" if path == "einsum" else "fused"
    kv = path != "wide"
    j = jax_reduced("granite-8b")
    j = j.replace(quant=j.quant.replace(quantize_acts=False,
                                        quantize_kv_cache=kv),
                  decode_kernel=kernel)
    t = torch_reduced("granite-8b")
    t = t.replace(quant=t.quant.replace(quantize_acts=False,
                                        quantize_kv_cache=kv),
                  decode_kernel=kernel)
    return j, t


def _pool_bytes(pool: dict) -> list:
    keys = POOL_KEYS["wide" if "k" in pool else "mx"]
    out = []
    for key in keys:
        leaf = pool[key]
        if isinstance(leaf, torch.Tensor):
            out.append(leaf.contiguous().view(torch.uint8).numpy())
        else:
            out.append(np.asarray(leaf).view(np.uint8))
    return out


def _assert_logits(got: torch.Tensor, want) -> None:
    want = np.asarray(want, np.float32)
    got = got.numpy()
    tol = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def _assert_pools(tcache: list, jcache) -> None:
    for layer, tpool in enumerate(tcache):
        jpool = {k: v[layer] for k, v in jcache["groups"][0].items()}
        for g, w in zip(_pool_bytes(tpool), _pool_bytes(jpool)):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("path", ["fused", "einsum", "wide"])
def test_split_model_steps_match_reference(path):
    jcfg, tcfg = _granite(path)
    jparams, _ = jmodel.init(jax.random.PRNGKey(0), jcfg)
    tparams = tmodel.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), tcfg, "cpu")
    num_pages, ps, c = 12, 4, 8
    jcache = jmodel.init_paged_cache(jcfg, 3, num_pages, ps)
    tcache = tmodel.init_paged_cache(tcfg, num_pages, ps, "cpu")
    rng = np.random.default_rng(0)
    prefill = jax.jit(lambda p, cache, *a: jmodel.prefill_chunk_paged(
        p, jcfg, cache, *a))
    decode = jax.jit(lambda p, cache, *a: jmodel.decode_step_paged(
        p, jcfg, cache, *a))
    # (table, chunk starts, real tokens, logit rows): two rows from 0 (one
    # a padded final chunk), then row 0's padded final chunk at 8, whose
    # padding reaches past its three-page table
    chunks = [(np.array([[0, 1, 2], [3, 4, -1]], np.int32), [0, 0], [8, 5],
               [7, 4]),
              (np.array([[0, 1, 2]], np.int32), [8], [3], [2])]
    for table, starts, reals, lidx in chunks:
        tokens = rng.integers(0, tcfg.vocab_size,
                              (len(starts), c)).astype(np.int32)
        args = [tokens, table] + [np.asarray(a, np.int32)
                                  for a in (starts, reals, lidx)]
        want, jcache = prefill(jparams, jcache, *map(jnp.asarray, args))
        got = tmodel.prefill_chunk_paged(
            tparams, tcfg, tcache, *(torch.from_numpy(a) for a in args))
        assert got.shape == (len(starts), 1, tcfg.vocab_size)
        _assert_logits(got, want)
        _assert_pools(tcache, jcache)
    # decode: row 0 at 11 (its last page), row 1 at 5, slot 2 inactive
    table = np.array([[0, 1, 2], [3, 4, -1], [-1, -1, -1]], np.int32)
    args = [rng.integers(0, tcfg.vocab_size, (3, 1)).astype(np.int32), table,
            np.array([11, 5, 0], np.int32)]
    want, jcache = decode(jparams, jcache, *map(jnp.asarray, args))
    got = tmodel.decode_step_paged(tparams, tcfg, tcache,
                                   *(torch.from_numpy(a) for a in args))
    _assert_logits(got[:2], np.asarray(want)[:2])  # slot 2: garbage
    _assert_pools(tcache, jcache)


# ---------------------------------------------------------------------------
# engine level
# ---------------------------------------------------------------------------


def _small(kv: bool = True):
    """(reference cfg, port cfg): the small model of the reference's
    ragged-vs-split test (weight-only MXFP8, block 16), with an MX fp8
    cache or (``kv=False``) a wide bf16 one."""
    dims = dict(name="t", family="dense", d_model=64, vocab_size=128,
                num_groups=1, num_heads=4, num_kv_heads=2, head_dim=16,
                d_ff=128)
    jcfg = JaxModelConfig(
        pattern=(JaxBlockDef("attn"),), quant=JAX_MXFP8.replace(
            block_size=16, quantize_acts=False, quantize_kv_cache=kv),
        **dims)
    tcfg = ModelConfig(pattern=(BlockDef("attn"),), quant=MXFP8.replace(
        block_size=16, quantize_acts=False, quantize_kv_cache=kv), **dims)
    return jcfg, tcfg


def _churn_reqs():
    """The reference test's requests (its rng(3) draw)."""
    rng = np.random.default_rng(3)
    return [(rng.integers(0, 128, (s,)).astype(np.int32), m)
            for s, m in [(4, 12), (4, 12), (7, 5), (3, 8)]]


def _budget_reqs():
    """Prompts of several chunks, so that a two-chunk budget batches
    two sequences' chunks into one dispatch."""
    rng = np.random.default_rng(5)
    return [(rng.integers(0, 128, (s,)).astype(np.int32), 6)
            for s in (21, 13, 30)]


SCENARIOS = {
    "churn-prefix": dict(max_seq=24, max_slots=2, page_size=4, num_pages=7,
                         prefix_cache=True),
    "chunked": dict(max_seq=48, max_slots=2, page_size=8, prefill_chunk=8),
    # tiered: pages demote after one idle step and go cold after three, so
    # that this short run repacks
    "tiered": dict(max_seq=48, max_slots=2, page_size=8, prefill_chunk=8,
                   num_pages=14, tiered=True),
    "einsum": dict(max_seq=48, max_slots=2, page_size=8, prefill_chunk=8,
                   decode_kernel="einsum"),
    "wide": dict(max_seq=48, max_slots=2, page_size=8, prefill_chunk=8),
    "budget": dict(max_seq=48, max_slots=3, page_size=4, prefill_chunk=8,
                   prefill_token_budget=16),
}


AGGRESSIVE_TIERS = dict(hot_steps=1, cold_steps=3, repack_pages_per_step=3)


def _serve_cfgs(scenario: str, **extra):
    """(reference ServeConfig, port ServeConfig) of ``scenario``."""
    kw = dict(SCENARIOS[scenario], **extra)
    if scenario != "tiered":
        return JaxServeConfig(**kw), ServeConfig(**kw)
    return (JaxServeConfig(tier_policy=JaxTierPolicy(**AGGRESSIVE_TIERS),
                           **kw),
            ServeConfig(tier_policy=TierPolicy(**AGGRESSIVE_TIERS), **kw))


def _drive(eng, reqs):
    """Serve ``reqs`` step by step; (streams, page formats after every
    step or None)."""
    ids = [eng.submit(p, m) for p, m in reqs]
    history = []
    more = True
    while more:
        more = eng.step()
        if getattr(eng, "tiered", False):
            history.append(np.array(eng.page_fmts))
    out = eng.run()
    return [out[i] for i in ids], history


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_split_engine_matches_reference(scenario):
    jcfg, tcfg = _small(kv=scenario != "wide")
    jparams, _ = jmodel.init(jax.random.PRNGKey(ENGINE_SEED), jcfg)
    tparams = tmodel.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), tcfg, "cpu")
    reqs = _budget_reqs() if scenario == "budget" else _churn_reqs()
    jscfg, tscfg = _serve_cfgs(scenario, step_mode="split")
    jeng = JaxEngine(jparams, jcfg, jscfg)
    want, jhist = _drive(jeng, reqs)
    teng = ContinuousBatchingEngine(tparams, tcfg, tscfg, device="cpu")
    got, thist = _drive(teng, reqs)
    stats, jstats = teng.cache_stats(), jeng.cache_stats()
    assert stats["step_mode"] == "split" and not jeng.ragged
    assert stats["min_top2_gap_ulps"] > GAP_TOL_ULPS
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert len(thist) == len(jhist)
    for t, j in zip(thist, jhist):
        np.testing.assert_array_equal(t, j)
    for key in ("preemptions", "cow_copies", "prefill_chunks",
                "prefill_dispatches", "peak_pages", "resident_tokens_at_peak",
                "allocated_bytes", "dispatches_decode", "dispatches_prefill",
                "dispatches_write", "dispatches_repack"):
        assert stats[key] == jstats[key], key
    _assert_pools(teng.cache, jeng.cache)
    if scenario == "churn-prefix":
        assert stats["preemptions"] >= 1, "pool must force a swap"
    if scenario == "tiered":
        assert stats["repacked_pages"] > 0
    if scenario == "budget":
        assert stats["prefill_chunks"] > stats["prefill_dispatches"]
    if scenario in ("churn-prefix", "chunked", "tiered"):
        # the port's own oracle: its ragged engine gives the same streams
        reng = ContinuousBatchingEngine(tparams, tcfg,
                                        _serve_cfgs(scenario)[1], device="cpu")
        ragged, _ = _drive(reng, reqs)
        assert reng.cache_stats()["step_mode"] == "ragged"
        assert reng.cache_stats()["min_top2_gap_ulps"] > GAP_TOL_ULPS
        for g, r in zip(got, ragged):
            np.testing.assert_array_equal(g, r)
    else:
        # einsum and wide caches fall back to split by themselves
        fallback = ContinuousBatchingEngine(
            tparams, tcfg, _serve_cfgs(scenario)[1], device="cpu")
        assert fallback.cache_stats()["step_mode"] == (
            "ragged" if scenario == "budget" else "split")
        assert fallback._trash_pages == (scenario == "budget")


@pytest.mark.parametrize("argv,mode", [
    (["--step-mode", "split", "--prefill-token-budget", "128"], "split"),
    (["--quant", "mxfp8"], "split"),  # a wide bf16 cache falls back
    (["--decode-kernel", "einsum"], "split")])
def test_launcher_serves_the_split_step_on_cpu(argv, mode):
    from repro_torch.launch import serve

    report = serve.main(["--arch", "granite-8b", "--reduced", "--batch", "3",
                         "--prompt-len", "40", "--shared-prefix", "32",
                         "--ragged", "--new-tokens", "4", "--device", "cpu",
                         *argv])
    assert report["step_mode"] == mode
    assert report["generated_tokens"] == 12
    assert report["dispatches"]["decode"] > 0
    assert report["dispatches"]["ragged"] == 0
    assert report["kernel_launches"] == 0  # CPU tensors: the plain versions
    args = serve.parse_args(["--arch", "granite-8b", "--step-mode",
                             "megakernel", "--prefill-max-chunks", "2"])
    assert (args.step_mode, args.prefill_max_chunks) == ("megakernel", 2)
