"""The port's tiered mixed-format KV cache against the reference's
``ContinuousBatchingEngine`` (ragged step, ``tiered=True``).

Same weights (carried over with ``params_from_jax``), same prompts, same
``ServeConfig``: both engines are stepped in lockstep, and after every
step their per-page format ids and the pool's units in use must be
equal; at the end, every request's stream and every layer's pool bytes.
The order of host events inside a step (tick, admit, repack, step) and
the repack's candidate order decide which page is requantized when, so
a port that marked a page one step late would part from the reference
here long before its tokens did.

Scenarios: the reference's own ``"tiered"`` ragged scenario
(``tests/test_ragged_step.py``), an aggressive-policy churn
(``tests/test_tiered_kv.py``), the same churn under pool pressure that
preempts, swap-out and restore of demoted pages,
copy-on-write of a narrow shared page (promoted back to fp8 before the
write), an engine over a packed fp4 pool, the ``PagePool`` unit
metering, and the tiering configuration's rejections.

Greedy streams can only be compared where no pick is a near-tie: each
scenario's seed is one whose every sampled token leads its runner-up by
more than LOGIT_TOL_ULPS bf16 ulps in the port (asserted).
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.core import MXFP8 as JAX_MXFP8  # noqa: E402
from repro.nn import BlockDef as JaxBlockDef  # noqa: E402
from repro.nn import ModelConfig as JaxModelConfig  # noqa: E402
from repro.nn import model as jmodel  # noqa: E402
from repro.serve import ContinuousBatchingEngine as JaxEngine  # noqa: E402
from repro.serve import ServeConfig as JaxServeConfig  # noqa: E402
from repro.serve import TierPolicy as JaxTierPolicy  # noqa: E402
from repro.serve.kv_cache import PagePool as JaxPagePool  # noqa: E402
from repro_torch.core import MXFP8  # noqa: E402
from repro_torch.nn import BlockDef, ModelConfig  # noqa: E402
from repro_torch.nn import model as tmodel  # noqa: E402
from repro_torch.serve import (ContinuousBatchingEngine,  # noqa: E402
                               PagePool, ServeConfig, TierPolicy)

LOGIT_TOL_ULPS = 1
#: init seed of the three-layer model of the one-call-a-dispatch test:
#: every greedy pick of its churn leads by more than LOGIT_TOL_ULPS
STACK_SEED = 5
POOL_KEYS = ("k_elems", "k_scales", "v_elems", "v_scales")
AGGRESSIVE = dict(hot_steps=1, cold_steps=3, repack_pages_per_step=3)


def _configs(fmt="fp8_e4m3", layers=1):
    """The reference tiering tests' model (d_model 64, 4/2 heads of 16,
    weight-only MX, MX KV pages, block 16; one layer unless named), in
    both packages."""
    dims = dict(name="t", family="dense", d_model=64, vocab_size=128,
                num_groups=layers, num_heads=4, num_kv_heads=2, head_dim=16,
                d_ff=128)
    jcfg = JaxModelConfig(
        pattern=(JaxBlockDef("attn"),), quant=JAX_MXFP8.replace(
            fmt=fmt, block_size=16, quantize_acts=False,
            quantize_kv_cache=True), **dims)
    tcfg = ModelConfig(pattern=(BlockDef("attn"),), quant=MXFP8.replace(
        fmt=fmt, block_size=16, quantize_acts=False, quantize_kv_cache=True),
        **dims)
    return jcfg, tcfg


@functools.lru_cache(maxsize=None)
def _models(seed, fmt="fp8_e4m3", layers=1):
    jcfg, tcfg = _configs(fmt, layers)
    jparams, _ = jmodel.init(jax.random.PRNGKey(seed), jcfg)
    tparams = tmodel.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), tcfg, "cpu")
    return jcfg, jparams, tcfg, tparams


def _ragged_reqs(rng):
    """``tests/test_ragged_step.py::_churn_reqs``."""
    return [(rng.integers(0, 128, (s,)).astype(np.int32), m)
            for s, m in [(4, 12), (4, 12), (7, 5), (3, 8)]]


def _churn_reqs(rng, n=6):
    """``tests/test_tiered_kv.py::_churn_reqs``: a shared head on every
    other prompt, ragged tails."""
    head = rng.integers(0, 128, (16,)).astype(np.int32)
    reqs = []
    for i in range(n):
        tail = rng.integers(0, 128, (3 + 5 * (i % 3),)).astype(np.int32)
        reqs.append((np.concatenate([head, tail]) if i % 2 else tail, 6))
    return reqs


def _engines(seed, serve, fmt="fp8_e4m3", policy=None, layers=1):
    jcfg, jparams, tcfg, tparams = _models(seed, fmt, layers)
    jtier = ttier = None
    if policy is not None:
        jtier, ttier = JaxTierPolicy(**policy), TierPolicy(**policy)
    jeng = JaxEngine(jparams, jcfg, JaxServeConfig(
        decode_kernel="fused", tier_policy=jtier, **serve))
    teng = ContinuousBatchingEngine(tparams, tcfg, ServeConfig(
        tier_policy=ttier, **serve), device="cpu")
    return jeng, teng


def _assert_same_state(jeng, teng, step):
    if getattr(jeng, "tiered", False):
        np.testing.assert_array_equal(teng.page_fmts, jeng.page_fmts,
                                      err_msg=f"page formats, step {step}")
    jpool, tpool = jeng.scheduler.pool, teng.scheduler.pool
    assert tpool.units_in_use == jpool.units_in_use, step
    assert tpool.pages_in_use == jpool.pages_in_use, step


def _lockstep(jeng, teng, reqs, hook=None):
    """Submit ``reqs`` to both engines and step them together, comparing
    their page formats and units after every step; ``hook(step)`` may
    intervene between steps. Returns both engines' streams."""
    ids = [(jeng.submit(p, m), teng.submit(p, m)) for p, m in reqs]
    step = 0
    while True:
        more = jeng.step()
        assert teng.step() == more
        step += 1
        _assert_same_state(jeng, teng, step)
        if hook is not None:
            hook(step)
        if not more:
            break
    jout = {r.id: np.asarray(r.generated) for r in jeng.scheduler.finished}
    tout = {r.id: np.asarray(r.generated) for r in teng.scheduler.finished}
    return [jout[j] for j, _ in ids], [tout[t] for _, t in ids]


def _assert_pools_equal(jeng, teng):
    groups = jeng.cache["groups"][0]
    for layer, tpool in enumerate(teng.cache):
        for key in POOL_KEYS:
            want = np.asarray(groups[key][layer]).view(np.uint8)
            got = tpool[key].view(torch.uint8).numpy()
            np.testing.assert_array_equal(got, want, err_msg=key)


def _assert_streams(jstreams, tstreams, teng):
    assert teng.cache_stats()["min_top2_gap_ulps"] > LOGIT_TOL_ULPS
    for j, t in zip(jstreams, tstreams):
        np.testing.assert_array_equal(t, j)


SCENARIOS = {
    # tests/test_ragged_step.py SCENARIOS["tiered"]: the default policy
    "tiered": (2, lambda: _ragged_reqs(np.random.default_rng(3)),
               dict(max_seq=48, max_slots=2, page_size=8, prefill_chunk=8,
                    num_pages=14, tiered=True), None),
    # tests/test_tiered_kv.py::test_tiered_aggressive_churn_invariants
    "aggressive": (0, lambda: _churn_reqs(np.random.default_rng(9), n=8),
                   dict(max_seq=48, max_slots=2, page_size=8,
                        prefill_chunk=8, num_pages=14, tiered=True),
                   AGGRESSIVE),
    # the same churn with 16 new tokens a request through three slots and
    # an 8-page budget: pool pressure swaps sequences out mid-tiering
    "preemption": (13, lambda: [(p, 16) for p, _ in _churn_reqs(
        np.random.default_rng(9))],
                   dict(max_seq=64, max_slots=3, page_size=8,
                        prefill_chunk=8, num_pages=8, tiered=True),
                   AGGRESSIVE),
}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_tiered_engine_matches_reference_step_by_step(scenario):
    seed, reqs, serve, policy = SCENARIOS[scenario]
    jeng, teng = _engines(seed, serve, policy=policy)
    jstreams, tstreams = _lockstep(jeng, teng, reqs())
    _assert_streams(jstreams, tstreams, teng)
    _assert_pools_equal(jeng, teng)
    jstats, stats = jeng.cache_stats(), teng.cache_stats()
    for key in ("repacked_pages", "repack_dispatches", "max_repacked_in_step",
                "unit_budget", "units_in_use", "peak_units", "pages_fp8_e4m3",
                "pages_fp6_e3m2", "pages_fp4_e2m1", "preemptions",
                "cow_copies"):
        assert stats[key] == jstats[key], key
    if policy is not None:
        assert stats["repacked_pages"] > 0 and stats["pages_fp4_e2m1"] > 0
    if scenario == "preemption":
        assert stats["preemptions"] >= 1
    assert len(teng.page_fmts) == teng.num_pages + 1
    assert int(teng.page_fmts[-1]) == teng._base_fmt_id  # the trash page


@pytest.mark.parametrize("stacked", [True, False])
def test_uniform_stack_repacks_in_one_call_per_dispatch(monkeypatch,
                                                        stacked):
    """A three-layer uniform model under the aggressive churn: the engine
    hands the repack its (L, ...) pools in one call a dispatch; with the
    stack hidden (as a non-uniform model has none) it calls once a layer.
    Either way the run matches the reference step by step."""
    from repro_torch.serve import engine as engine_mod

    layers = 3
    _, reqs, serve, policy = SCENARIOS["aggressive"]
    jeng, teng = _engines(STACK_SEED, serve, policy=policy, layers=layers)
    assert teng.cache.stack is not None
    if not stacked:
        teng.cache.stack = None
    calls = []
    repack = engine_mod.mx_repack_pages

    def counted(*args, **kwargs):
        calls.append(args[0].ndim)
        return repack(*args, **kwargs)

    monkeypatch.setattr(engine_mod, "mx_repack_pages", counted)
    jstreams, tstreams = _lockstep(jeng, teng, reqs())
    _assert_streams(jstreams, tstreams, teng)
    _assert_pools_equal(jeng, teng)
    stats, jstats = teng.cache_stats(), jeng.cache_stats()
    for key in ("repacked_pages", "repack_dispatches", "units_in_use"):
        assert stats[key] == jstats[key], key
    dispatches = stats["repack_dispatches"]
    assert dispatches > 0 and stats["pages_fp4_e2m1"] > 0
    if stacked:
        assert calls == [5] * dispatches
    else:
        assert calls == [4] * (dispatches * layers)


def test_swap_restore_preserves_narrow_page_formats():
    """The reference's scenario: a sequence whose pages already demoted is
    swapped out and restored. Its stream equals the reference's with the
    same forced swap, and the port's own run without the swap; the saved
    format ids equal the reference's and include a narrow one."""
    prompt = np.random.default_rng(21).integers(0, 128, (24,)).astype(
        np.int32)
    serve = dict(max_seq=64, max_slots=2, page_size=8, prefill_chunk=8,
                 prefix_cache=False, tiered=True)
    policy = dict(hot_steps=1, cold_steps=2, repack_pages_per_step=8)

    def drive(eng, force_swap):
        rid = eng.submit(prompt, 24)
        frozen = saved = None
        while True:
            more = eng.step()
            seq = next((s for s in eng.scheduler.slots
                        if s is not None and s.req.id == rid), None)
            if (frozen is None and seq is not None
                    and seq.prefill_pos is None
                    and any(int(eng.page_fmts[p]) != eng._base_fmt_id
                            for p in seq.pages)):
                frozen = eng.tier = dataclasses.replace(
                    eng.tier, repack_pages_per_step=0)
                if force_swap:
                    eng._swap_out(seq)
                    saved = list(eng._swap_fmts[rid])
            if not more:
                break
        assert frozen is not None, "no page demoted before completion"
        out = next(r for r in eng.scheduler.finished if r.id == rid)
        return np.asarray(out.generated), saved

    jeng, teng = _engines(1, serve, policy=policy)
    want, jsaved = drive(jeng, True)
    got, saved = drive(teng, True)
    _, teng2 = _engines(1, serve, policy=policy)
    unswapped, _ = drive(teng2, False)
    assert saved == jsaved and any(f != 0 for f in saved)
    assert teng.cache_stats()["min_top2_gap_ulps"] > LOGIT_TOL_ULPS
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, unswapped)
    _assert_pools_equal(jeng, teng)


def test_cow_promotes_a_narrow_shared_page_before_the_write():
    """A decoding sequence's partly written page is repacked to fp4 and
    gains a second holder (in both engines alike). The next step copies
    it (copy-on-write), promotes the copy back to fp8 by a widening
    repack, and only then writes into it; streams, per-step formats and
    pool bytes stay equal to the reference's."""
    serve = dict(max_seq=64, max_slots=2, page_size=8, prefill_chunk=8,
                 prefix_cache=False, tiered=True)
    policy = dict(hot_steps=2, cold_steps=4, repack_pages_per_step=2)
    jeng, teng = _engines(0, serve, policy=policy)
    rng = np.random.default_rng(5)
    reqs = [(rng.integers(0, 128, (n,)).astype(np.int32), 10)
            for n in (20, 13)]
    state = {}

    def hook(step):
        if state:
            return
        seqs = [s for s in teng.scheduler.decode_ready() if s.pos % 8]
        if not seqs:
            return
        slot, ps = seqs[0].slot, 8
        for eng in (jeng, teng):
            seq = eng.scheduler.slots[slot]
            pid = seq.pages[seq.pos // ps]
            eng._repack_pages_to([pid], "fp4_e2m1")
            eng.scheduler.pool.retain([pid])
            state[id(eng)] = pid
        _assert_same_state(jeng, teng, step)

    jstreams, tstreams = _lockstep(jeng, teng, reqs, hook)
    assert state, "no decoding sequence sat mid-page"
    _assert_streams(jstreams, tstreams, teng)
    _assert_pools_equal(jeng, teng)
    stats, jstats = teng.cache_stats(), jeng.cache_stats()
    assert stats["cow_copies"] == jstats["cow_copies"] == 1
    assert stats["repacked_pages"] == jstats["repacked_pages"]
    pid = state[id(teng)]  # the narrow original: held by the extra ref
    assert teng.scheduler.pool.ref(pid) == 1
    assert int(teng.page_fmts[pid]) == 4


def test_fp4_pool_engine_matches_reference():
    """``tests/test_ragged_step.py::test_ragged_engine_formats``' fp4 case:
    a packed-nibble fp4 pool through the in-kernel write path."""
    serve = dict(max_seq=32, max_slots=2, page_size=4, prefill_chunk=4)
    jeng, teng = _engines(5, serve, fmt="fp4_e2m1")
    reqs = _ragged_reqs(np.random.default_rng(9))[:2]
    jstreams, tstreams = _lockstep(jeng, teng, reqs)
    _assert_streams(jstreams, tstreams, teng)
    _assert_pools_equal(jeng, teng)
    assert teng.cache[0]["k_elems"].shape[-1] == 8  # head_dim 16, packed


def test_page_pool_unit_metering_matches_reference():
    """A seeded sequence of allocations, retains, frees and re-meterings,
    legal and not, against the reference's PagePool: same results, same
    errors, same units, peaks and allocation log after every operation."""
    rng = np.random.default_rng(0)
    pools = [JaxPagePool(12, unit_budget=30, track_allocs=True),
             PagePool(12, unit_budget=30, track_allocs=True)]

    def apply(pool, op, arg):
        try:
            return getattr(pool, op)(*arg)
        except ValueError as exc:
            return ("ValueError", str(exc))

    for _ in range(400):
        op = rng.choice(["alloc", "retain", "free", "set_cost", "can_alloc",
                         "ref", "cost"])
        pid = int(rng.integers(-1, 13))
        arg = {"alloc": (int(rng.integers(-1, 4)),),
               "can_alloc": (int(rng.integers(0, 4)),),
               "retain": ([pid],), "free": ([pid],), "ref": (pid,),
               "cost": (pid,),
               "set_cost": (pid, int(rng.integers(0, 6)))}[op]
        results = [apply(p, op, arg) for p in pools]
        assert results[0] == results[1], (op, arg)
        j, t = pools
        assert (t.units_in_use, t.peak_units, t.units_free, t.free_pages,
                t.pages_in_use, t.peak_in_use, t.alloc_log) == \
            (j.units_in_use, j.peak_units, j.units_free, j.free_pages,
             j.pages_in_use, j.peak_in_use, j.alloc_log)
        if rng.random() < 0.1:
            j.alloc_log.clear()
            t.alloc_log.clear()


@pytest.mark.parametrize("model,serve,policy", [
    ({}, dict(decode_kernel="einsum"), {}),
    ({}, dict(prefill_mode="monolithic"), {}),
    (dict(quantize_kv_cache=False), {}, {}),
    (dict(fmt="fp4_e2m1"), {}, {}),
    ({}, {}, dict(mid_fmt="fp5")),
    ({}, {}, dict(cold_fmt="int4")),
    ({}, {}, dict(mid_fmt="fp4_e2m1", cold_fmt="fp6_e3m2")),
    ({}, {}, dict(hot_steps=0)),
    ({}, {}, dict(hot_steps=8, cold_steps=4)),
    ({}, {}, dict(repack_pages_per_step=-1)),
    ({}, {}, dict(repack_list_len=0))])
def test_tiering_rejections_match_reference(model, serve, policy):
    jcfg, jparams, tcfg, tparams = _models(0)
    jcfg = jcfg.replace(quant=jcfg.quant.replace(**model))
    tcfg = tcfg.replace(quant=tcfg.quant.replace(**model))
    kw = dict(max_seq=32, max_slots=2, page_size=8, prefill_chunk=8,
              tiered=True, **serve)
    with pytest.raises(ValueError) as want:
        JaxEngine(jparams, jcfg, JaxServeConfig(
            tier_policy=JaxTierPolicy(**policy), **kw))
    with pytest.raises(ValueError) as got:
        ContinuousBatchingEngine(tparams, tcfg, ServeConfig(
            tier_policy=TierPolicy(**policy), **kw), device="cpu")
    assert str(got.value) == str(want.value)
