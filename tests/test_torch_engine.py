"""Greedy streams of the port's engine against the reference's
``ContinuousBatchingEngine`` (default ragged, chunked step).

Same weights (carried over with ``params_from_jax``), same prompts, same
``ServeConfig``: six prompts sharing a 32-token head through three slots
and a ten-page pool, so admission churns, the prefix tree shares, evicts
and dedupes pages, and swap preemption fires. Every request's stream must
be token-identical.

A random-init model has near-tied top-2 logits, and logits are bf16
values. The port reproduces the reference's rounding points (the step
test holds logits to one bf16 ulp, LOGIT_TOL_ULPS), so the seed here is
one whose every sampled token leads its runner-up by more than that, and
the test asserts it.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.core import MXFP8 as JAX_MXFP8  # noqa: E402
from repro.nn import BlockDef as JaxBlockDef  # noqa: E402
from repro.nn import ModelConfig as JaxModelConfig  # noqa: E402
from repro.nn import model as jmodel  # noqa: E402
from repro.serve import ContinuousBatchingEngine as JaxEngine  # noqa: E402
from repro.serve import FixedSlotEngine as JaxFixedSlot  # noqa: E402
from repro.serve import ServeConfig as JaxServeConfig  # noqa: E402
from repro_torch.core import MXFP8  # noqa: E402
from repro_torch.nn import BlockDef, ModelConfig  # noqa: E402
from repro_torch.nn import model as tmodel  # noqa: E402
from repro_torch.serve import (ContinuousBatchingEngine,  # noqa: E402
                               ServeConfig)
from repro_torch.serve import sampling as tsampling  # noqa: E402

LOGIT_TOL_ULPS = 1
TIGHT = dict(max_seq=52, max_slots=3, page_size=8, num_pages=10,
             prefix_cache=True)
ROOMY = dict(max_seq=52, max_slots=6, page_size=8, num_pages=60,
             prefix_cache=True)


def _configs():
    """The small attention-only model of tests/test_prefix_cache.py, in
    both packages (weight-only MXFP8, MX fp8 KV pages, block 16)."""
    dims = dict(name="t", family="dense", d_model=64, vocab_size=128,
                num_groups=1, num_heads=4, num_kv_heads=2, head_dim=16,
                d_ff=128)
    jcfg = JaxModelConfig(
        pattern=(JaxBlockDef("attn"),), quant=JAX_MXFP8.replace(
            block_size=16, quantize_acts=False, quantize_kv_cache=True),
        **dims)
    tcfg = ModelConfig(pattern=(BlockDef("attn"),), quant=MXFP8.replace(
        block_size=16, quantize_acts=False, quantize_kv_cache=True), **dims)
    return jcfg, tcfg


def _shared_head_prompts():
    rng = np.random.default_rng(3)
    head = rng.integers(0, 128, (32,)).astype(np.int32)
    return [np.concatenate([head, rng.integers(0, 128, (8,)).astype(np.int32)])
            for _ in range(6)]


def _models(seed):
    jcfg, tcfg = _configs()
    jparams, _ = jmodel.init(jax.random.PRNGKey(seed), jcfg)
    tparams = tmodel.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), tcfg, "cpu")
    return jcfg, jparams, tcfg, tparams


def _serve_reference(jcfg, jparams, prompts, new_tokens, **serve):
    eng = JaxEngine(jparams, jcfg, JaxServeConfig(**serve))
    ids = [eng.submit(p, new_tokens) for p in prompts]
    out = eng.run()
    return [out[i] for i in ids], eng.cache_stats()


def _serve_port(tcfg, tparams, prompts, new_tokens, **serve):
    eng = ContinuousBatchingEngine(tparams, tcfg, ServeConfig(**serve),
                                   device="cpu")
    ids = [eng.submit(p, new_tokens) for p in prompts]
    out = eng.run()
    return [out[i] for i in ids], eng.cache_stats()


def test_streams_match_reference_under_churn_preemption_and_sharing():
    jcfg, jparams, tcfg, tparams = _models(seed=18)
    prompts = _shared_head_prompts()
    want, jstats = _serve_reference(jcfg, jparams, prompts, 10, **TIGHT)
    got, stats = _serve_port(tcfg, tparams, prompts, 10, **TIGHT)
    assert stats["preemptions"] >= 1, "pool sizing must force a swap"
    assert stats["prefix_evictions"] >= 1, "pool sizing must force eviction"
    assert stats["prefix_hit_tokens"] > 0
    assert stats["min_top2_gap_ulps"] > LOGIT_TOL_ULPS
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    for key in ("preemptions", "prefix_evictions", "prefix_hit_tokens",
                "cow_copies", "prefix_dedupes"):
        assert stats[key] == jstats[key], key


def test_prefix_preemption_scenario_is_a_near_tie_not_a_paging_fault(
        monkeypatch):
    """The scenario of the reference's failing
    test_prefix_sharing_with_preemption_and_eviction (same weights,
    prompts and pool). The port's stream equals the reference continuous
    engine's with and without preemption/eviction, so paging is exact in
    both; request 3 parts from the fixed-slot engine at position 41,
    where the two candidate tokens' logits are one bf16 ulp apart."""
    jcfg, jparams, tcfg, tparams = _models(seed=0)
    prompts = _shared_head_prompts()
    want, _ = _serve_reference(jcfg, jparams, prompts, 10, **TIGHT)
    got, stats = _serve_port(tcfg, tparams, prompts, 10, **TIGHT)
    roomy, roomy_stats = _serve_port(tcfg, tparams, prompts, 10, **ROOMY)
    assert stats["preemptions"] >= 1 and stats["prefix_evictions"] >= 1
    assert roomy_stats["preemptions"] == 0
    assert roomy_stats["prefix_evictions"] == 0
    for g, w, r in zip(got, want, roomy):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, r)
    fixed = JaxFixedSlot(jparams, jcfg, JaxServeConfig(max_seq=52)).generate(
        prompts[3][None], 10)[0]
    pos = int(np.flatnonzero(fixed != got[3])[0])
    assert pos == 41
    # the port's logits for position 41, teacher-forced on the shared stream
    eng = ContinuousBatchingEngine(tparams, tcfg, ServeConfig(
        max_seq=52, max_slots=1, page_size=8, prefix_cache=False),
        device="cpu")
    logits = []
    greedy = tsampling.greedy
    monkeypatch.setattr(tsampling, "greedy", lambda lg: (
        logits.append(lg[0].float()), greedy(lg))[1])
    eng.submit(got[3][:pos], 1)
    eng.run()
    top, runner = logits[-1].topk(2).indices.tolist()
    assert (top, runner) == (got[3][pos], fixed[pos]) == (96, 56)
    lo, hi = float(logits[-1][runner]), float(logits[-1][top])
    assert hi - lo == 2.0 ** (math.floor(math.log2(hi)) - 7)  # one ulp


@pytest.mark.parametrize("override", [dict(mesh_shape=(1, 2))])
def test_unported_serve_options_raise(override):
    _, tcfg = _configs()
    with pytest.raises(NotImplementedError):
        ContinuousBatchingEngine({}, tcfg, ServeConfig(**override),
                                 device="cpu")


def test_monolithic_prefill_with_tiering_raises_as_the_reference():
    """Monolithic prefill is ported, but the tiered cache still refuses
    it, with the reference's ValueError and message."""
    jcfg, tcfg = _configs()
    kw = dict(max_seq=32, max_slots=2, page_size=8, tiered=True,
              prefill_mode="monolithic")
    jparams, _ = jmodel.init(jax.random.PRNGKey(0), jcfg)
    with pytest.raises(ValueError) as want:
        JaxEngine(jparams, jcfg, JaxServeConfig(**kw))
    with pytest.raises(ValueError) as got:
        ContinuousBatchingEngine({}, tcfg, ServeConfig(**kw), device="cpu")
    assert str(got.value) == str(want.value)


def test_launcher_batch_workload_on_cpu():
    from repro_torch.launch import serve

    report = serve.main(["--arch", "granite-8b", "--reduced", "--batch", "3",
                         "--prompt-len", "40", "--shared-prefix", "32",
                         "--ragged", "--new-tokens", "4", "--device", "cpu"])
    assert report["requests"] == 3 and report["generated_tokens"] == 12
    assert report["kernel_launches"] == 0  # CPU tensors: the plain version
    assert report["prefix_hit_rate"] > 0
    with pytest.raises(SystemExit):  # still unported: names ROADMAP A7
        serve.main(["--arch", "granite-8b", "--mesh", "2"])


def test_launcher_fixed_engine_and_monolithic_prefill_on_cpu():
    """``--engine fixed`` runs the fixed-slot engine's ``generate`` on the
    reference launcher's fixed batch; ``--prefill-mode monolithic`` serves
    the batch workload through monolithic admission (split dispatches, a
    prefix hit from the shared head); the reference's ``--engine fixed``
    rules refuse speculation, the server and the tiered cache."""
    from repro_torch.launch import serve

    common = ["--arch", "granite-8b", "--reduced", "--batch", "3",
              "--prompt-len", "24", "--shared-prefix", "16",
              "--new-tokens", "4", "--device", "cpu"]
    fixed = serve.main(common + ["--engine", "fixed"])
    assert fixed["out"].shape == (3, 16 + 24 + 4)
    np.testing.assert_array_equal(fixed["out"][:, :40], fixed["prompts"])
    assert (fixed["prompts"][:, :16] == fixed["prompts"][0, :16]).all()
    mono = serve.main(common + ["--prefill-mode", "monolithic", "--ragged"])
    assert mono["step_mode"] == "split" and mono["ragged_steps"] == 0
    assert mono["generated_tokens"] == 12 and mono["prefix_hit_rate"] > 0
    assert mono["dispatches"]["prefill"] == 2 * 3
    for flags in (["--spec-decode"], ["--serve"], ["--tiered"]):
        with pytest.raises(SystemExit):
            serve.parse_args(["--arch", "granite-8b", "--engine", "fixed",
                              *flags])


def test_launcher_tiered_on_cpu():
    """``--tiered`` through the launcher: pages demote after one idle step
    and the report carries the tiered stats; the reference's flag checks
    refuse a tiered fp4 base and a tiered wide KV cache."""
    from repro_torch.launch import serve

    report = serve.main(["--arch", "granite-8b", "--reduced", "--batch", "3",
                         "--prompt-len", "40", "--shared-prefix", "32",
                         "--ragged", "--new-tokens", "8", "--tiered",
                         "--tier-hot-steps", "1", "--device", "cpu"])
    tiers = report["tiered"]
    assert report["generated_tokens"] == 24
    assert tiers["repacked_pages"] > 0 and tiers["pages_fp6_e3m2"] > 0
    assert tiers["max_repacked_in_step"] <= 4
    assert 0 < tiers["units_in_use"] <= tiers["unit_budget"]
    for argv in (["--tiered", "--quant", "mxfp4", "--quantize-kv"],
                 ["--tiered", "--quant", "mxfp8"],
                 ["--tiered", "--quant", "wide", "--quantize-kv"]):
        with pytest.raises(SystemExit):
            serve.parse_args(["--arch", "granite-8b", *argv])


def _warmup_touches_only_the_trash_page(tiered: bool):
    _, tcfg = _configs()
    params = tmodel.init(tcfg, torch.Generator().manual_seed(0), "cpu")
    eng = ContinuousBatchingEngine(params, tcfg, ServeConfig(
        **TIGHT, tiered=tiered), device="cpu")
    before = [{k: t.clone() for k, t in pool.items()} for pool in eng.cache]
    stats = eng.cache_stats()
    eng.warmup()
    trash = eng.num_pages
    for pool, old in zip(eng.cache, before):
        for k, t in pool.items():
            assert torch.equal(t[:trash], old[k][:trash]), k
            assert not torch.equal(t[trash:], old[k][trash:]), k
    assert eng.cache_stats() == stats
    return eng


def test_warmup_writes_only_the_trash_page():
    _warmup_touches_only_the_trash_page(tiered=False)


def test_tiered_warmup_leaves_formats_ages_and_counters():
    """On a tiered engine warmup passes the page formats to every layer
    and still writes only the trash page, which stays in the base
    format; no format, age, tick or tiering counter moves."""
    eng = _warmup_touches_only_the_trash_page(tiered=True)
    assert (eng.page_fmts == eng._base_fmt_id).all()
    assert not eng._last_write.any() and eng._tick == 0


def test_launcher_prompts_share_the_head_with_the_first_requests():
    from repro_torch.launch import serve

    args = serve.parse_args(["--arch", "granite-8b", "--batch", "4",
                             "--prompt-len", "20", "--shared-prefix", "8",
                             "--ragged"])
    _, tcfg = _configs()
    every = serve.make_prompts(tcfg, args)
    two = serve.make_prompts(tcfg, args, sharing=2)
    head = every[0][:8]
    assert all(np.array_equal(p[:8], head) for p in every)
    assert [len(p) for p in two] == [len(p) - 8 * (i >= 2)
                                     for i, p in enumerate(every)]
    for i, (p, q) in enumerate(zip(every, two)):
        np.testing.assert_array_equal(q, p if i < 2 else p[8:])


def test_two_request_shared_head_burst_falls_back_like_the_reference():
    """Eight requests into eight free slots, two of them sharing a
    page-aligned head (the full-width workload of chip_smoke.py, cut
    down). The follower is deferred while the leader prefills, but every
    admission pass spends one of its ``max_deferrals`` attempts, so they
    run out before the leader's pages register and it prefills a private
    copy: no prefix hit, in both engines alike."""
    jcfg, jparams, tcfg, tparams = _models(seed=18)
    rng = np.random.default_rng(4)
    head = rng.integers(0, 128, (16,)).astype(np.int32)
    prompts = [np.concatenate([head[:16 * (i < 2)], rng.integers(
        0, 128, (int(n),)).astype(np.int32)])
        for i, n in enumerate(rng.integers(30, 60, 8))]
    serve = dict(max_seq=80, max_slots=8, page_size=8, prefill_chunk=16)
    _, jstats = _serve_reference(jcfg, jparams, prompts, 2, **serve)
    _, stats = _serve_port(tcfg, tparams, prompts, 2, **serve)
    assert stats["deferral_fallbacks"] == stats["deferred_admissions"] == 1
    assert stats["prefix_hit_rate"] == 0.0
    for key in ("deferred_admissions", "deferral_fallbacks",
                "prefix_hit_rate", "prefill_tokens_computed"):
        assert stats[key] == jstats[key], key
