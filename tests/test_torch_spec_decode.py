"""Speculative decoding and stochastic serving in the port's engine
(``repro_torch.serve``), against the reference's on the CPU.

  * drafters and ``greedy_accept`` equal the reference's, on its own cases
    (``tests/test_spec_decode.py``) and on random histories;
  * engine streams equal the reference ``ContinuousBatchingEngine``'s with
    the same weights (``model.params_from_jax``), reduced granite, under
    churn, preemption and prefix sharing: ragged and split steps, spec on
    and off, temperature 0 and > 0 with explicit seeds, tiered included.
    The streams must be equal outright: at vocab 512 some greedy picks of
    these runs are exact bf16 ties, which both packages break alike, so
    no near-tie allowance is made;
  * with spec on at temperature 0 the port's streams equal its non-spec
    streams for the n-gram drafter and an adversarial scripted one, in all
    three step modes;
  * rollback: a pinned write-window page is copied before the verify
    write and keeps its bytes, prefix pages keep theirs, and a sequence's
    cache rows equal plain decode's after every verify step (the
    reference's seed-failing property tests, at fixed seeds here, with the
    outputs compared with the reference's);
  * the megakernel step's plain version with ``num_logits = 1 + K`` equals
    the per-layer ragged step's bit for bit, and the reference's within
    one bf16 ulp.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import get_reduced as jax_reduced  # noqa: E402
from repro.core import MXFP8 as JAX_MXFP8  # noqa: E402
from repro.nn import BlockDef as JaxBlockDef  # noqa: E402
from repro.nn import ModelConfig as JaxModelConfig  # noqa: E402
from repro.nn import model as jmodel  # noqa: E402
from repro.serve import ContinuousBatchingEngine as JaxEngine  # noqa: E402
from repro.serve import SamplingParams as JaxSamplingParams  # noqa: E402
from repro.serve import ServeConfig as JaxServeConfig  # noqa: E402
from repro.serve import TierPolicy as JaxTierPolicy  # noqa: E402
from repro.serve import spec_decode as jspec  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.core import MXFP8  # noqa: E402
from repro_torch.nn import BlockDef, ModelConfig  # noqa: E402
from repro_torch.nn import model as tmodel  # noqa: E402
from repro_torch.serve import (ContinuousBatchingEngine,  # noqa: E402
                               NgramDrafter, SamplingParams, Scheduler,
                               ScriptedDrafter, ServeConfig, TierPolicy,
                               greedy_accept)
from repro_torch.serve.spec_decode import resolve_drafter  # noqa: E402

MODEL_SEED = 3  # reduced-granite init seed of the engine comparisons
POOL_KEYS = tmodel.POOL_KEYS


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The models here are small: one intra-op thread a process is as
    fast alone and keeps parallel test workers from oversubscribing the
    host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# drafters and the acceptance rule
# ---------------------------------------------------------------------------


def test_ngram_drafter_cases():
    """The reference test's cases, on the port's drafter."""
    d = NgramDrafter(max_ngram=2)
    np.testing.assert_array_equal(
        d.propose(np.asarray([7, 1, 2, 9, 1, 2], np.int32), 3), [9, 1, 2])
    np.testing.assert_array_equal(NgramDrafter(max_ngram=1).propose(
        np.asarray([4, 9, 4], np.int32), 3), [9, 4, 4])
    np.testing.assert_array_equal(NgramDrafter(max_ngram=3).propose(
        np.asarray([5, 1, 2, 3, 8, 1, 2, 3], np.int32), 2), [8, 1])
    np.testing.assert_array_equal(NgramDrafter(max_ngram=1).propose(
        np.asarray([4, 10, 4, 20, 4], np.int32), 1), [20])
    np.testing.assert_array_equal(NgramDrafter().propose(
        np.asarray([1, 2, 3], np.int32), 2), [3, 3])
    np.testing.assert_array_equal(NgramDrafter().propose(
        np.asarray([9], np.int32), 2), [9, 9])
    with pytest.raises(ValueError):
        NgramDrafter(max_ngram=1, min_ngram=2)


@pytest.mark.parametrize("k", [1, 3, 4, 8])
def test_drafters_equal_reference_on_random_histories(k):
    rng = np.random.default_rng(k)
    pairs = [(NgramDrafter(), jspec.NgramDrafter()),
             (NgramDrafter(max_ngram=2, min_ngram=2),
              jspec.NgramDrafter(max_ngram=2, min_ngram=2)),
             (ScriptedDrafter(vocab=50, seed=k),
              jspec.ScriptedDrafter(vocab=50, seed=k))]
    for _ in range(60):
        hist = rng.integers(0, 6, int(rng.integers(1, 40))).astype(np.int32)
        for port, ref in pairs:
            got = port.propose(hist, k)
            assert got.dtype == np.int32 and got.shape == (k,)
            np.testing.assert_array_equal(got, ref.propose(hist, k))


def test_greedy_accept_equals_reference():
    a, em = greedy_accept([5, 6, 7], [5, 6, 7, 8])
    assert a == 3 and list(em) == [5, 6, 7, 8]
    a, em = greedy_accept([5, 9, 7], [5, 6, 7, 8])
    assert a == 1 and list(em) == [5, 6]
    a, em = greedy_accept([9, 9], [5, 6, 7])
    assert a == 0 and list(em) == [5]
    rng = np.random.default_rng(0)
    for _ in range(200):
        k = int(rng.integers(1, 6))
        drafts, targets = rng.integers(0, 3, k), rng.integers(0, 3, k + 1)
        a, em = greedy_accept(drafts, targets)
        ra, rem = jspec.greedy_accept(drafts, targets)
        assert a == ra
        np.testing.assert_array_equal(em, rem)


def test_resolve_drafter():
    assert isinstance(resolve_drafter("ngram", 128), NgramDrafter)
    d = ScriptedDrafter(8)
    assert resolve_drafter(d, 128) is d
    with pytest.raises(ValueError):
        resolve_drafter("medusa", 128)


def test_submit_rejects_draft_window_overflow():
    s = Scheduler(max_slots=1, num_pages=4, page_size=4, max_seq=16,
                  prefill_chunk=4, num_draft_tokens=4)
    with pytest.raises(ValueError, match="draft window"):
        s.submit(np.arange(8, dtype=np.int32), 5)
    assert not s.queue
    Scheduler(max_slots=1, num_pages=4, page_size=4, max_seq=16,
              prefill_chunk=4).submit(np.arange(8, dtype=np.int32), 5)
    s.submit(np.arange(4, dtype=np.int32), 5)
    with pytest.raises(ValueError):
        Scheduler(max_slots=1, num_pages=4, page_size=4, max_seq=16,
                  prefill_chunk=4, num_draft_tokens=-1)


@pytest.mark.parametrize("bad,match", [
    (dict(spec_decode=True, num_draft_tokens=0), "num_draft_tokens"),
    (dict(spec_decode=True, drafter="medusa"), "drafter"),
    (dict(temperature=-1.0), "temperature"),
    (dict(top_p=0.0), "top_p")])
def test_config_errors_are_the_reference_value_errors(bad, match):
    tcfg = _reduced()[1]
    with pytest.raises(ValueError, match=match):
        ContinuousBatchingEngine({}, tcfg, ServeConfig(max_seq=24, **bad),
                                 device="cpu")


# ---------------------------------------------------------------------------
# engine streams against the reference (reduced granite)
# ---------------------------------------------------------------------------


def _reduced():
    """(reference cfg, port cfg): reduced granite as the launcher serves
    it (weight-only MXFP8, MX fp8 KV pages)."""
    j = jax_reduced("granite-8b")
    j = j.replace(quant=j.quant.replace(quantize_acts=False,
                                        quantize_kv_cache=True),
                  decode_kernel="fused")
    t = get_reduced("granite-8b")
    t = t.replace(quant=t.quant.replace(quantize_acts=False,
                                        quantize_kv_cache=True))
    return j, t


@pytest.fixture(scope="module")
def granite():
    jcfg, tcfg = _reduced()
    jparams, _ = jmodel.init(jax.random.PRNGKey(MODEL_SEED), jcfg)
    tparams = tmodel.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), tcfg, "cpu")
    return jcfg, jparams, tcfg, tparams


def _prompts(vocab):
    """Five prompts, four sharing a 16-token head (two pages)."""
    rng = np.random.default_rng(7)
    head = rng.integers(0, vocab, 16).astype(np.int32)
    return [np.concatenate([head[:16 * (i < 4)], rng.integers(
        0, vocab, n).astype(np.int32)]) for i, n in enumerate(
        (5, 11, 3, 9, 14))]


#: a pool tight enough that admission churns and swap preemption fires
TIGHT = dict(max_seq=48, max_slots=3, page_size=8, num_pages=8,
             prefix_cache=True, prefill_chunk=16)
SAMPLED = [dict(temperature=0.8, top_p=0.95, top_k=50, seed=11),
           None,  # the engine default
           dict(temperature=1.3, seed=2 ** 32 - 1),
           dict(temperature=0.7, top_k=5, seed=0),
           dict(temperature=0.8, top_p=0.95, top_k=50, seed=11)]
SCRIPTED = object()  # the adversarial scripted drafter, in either package

ENGINE_CASES = {
    "ragged-greedy-ngram": (dict(spec_decode=True), [None] * 5),
    "ragged-sampled": ({}, SAMPLED),
    "ragged-sampled-spec-scripted": (
        dict(spec_decode=True, num_draft_tokens=3, drafter=SCRIPTED),
        SAMPLED),
    "ragged-default-temperature-spec": (
        dict(spec_decode=True, temperature=0.9, top_p=0.9, seed=5),
        [None] * 5),
    "split-greedy-spec-scripted": (
        dict(step_mode="split", spec_decode=True, drafter=SCRIPTED),
        [None] * 5),
    "split-sampled": (dict(step_mode="split"), SAMPLED),
    "split-sampled-spec": (
        dict(step_mode="split", spec_decode=True, num_draft_tokens=2),
        SAMPLED),
    "tiered-ragged-sampled-spec": (
        dict(tiered=True, spec_decode=True, num_draft_tokens=3),
        SAMPLED),
    "tiered-split-greedy-spec": (
        dict(tiered=True, step_mode="split", spec_decode=True),
        [None] * 5),
}


def _serve(engine_cls, serve_cls, sp_cls, params, cfg, prompts, sps, kw,
           **extra):
    kw = dict(kw)
    if kw.get("drafter") is SCRIPTED:
        kw["drafter"] = (ScriptedDrafter if serve_cls is ServeConfig
                         else jspec.ScriptedDrafter)(vocab=cfg.vocab_size,
                                                     seed=4)
    if kw.pop("tiered", False):
        tp = TierPolicy if serve_cls is ServeConfig else JaxTierPolicy
        kw.update(tiered=True, tier_policy=tp(
            hot_steps=1, cold_steps=3, repack_pages_per_step=3))
    eng = engine_cls(params, cfg, serve_cls(**TIGHT, **kw), **extra)
    ids = [eng.submit(p, 10, sampling_params=None if sp is None
                      else sp_cls(**sp)) for p, sp in zip(prompts, sps)]
    out = eng.run()
    return [out[i] for i in ids], eng.cache_stats()


@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
def test_engine_streams_equal_reference(granite, case):
    jcfg, jparams, tcfg, tparams = granite
    kw, sps = ENGINE_CASES[case]
    prompts = _prompts(tcfg.vocab_size)
    want, jstats = _serve(JaxEngine, JaxServeConfig, JaxSamplingParams,
                          jparams, jcfg, prompts, sps, kw)
    got, stats = _serve(ContinuousBatchingEngine, ServeConfig,
                        SamplingParams, tparams, tcfg, prompts, sps, kw,
                        device="cpu")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert stats["preemptions"] >= 1 or kw.get("tiered"), \
        "pool sizing must force a swap"
    assert stats["prefix_hit_tokens"] > 0
    keys = ["preemptions", "cow_copies", "prefix_hit_tokens",
            "dispatches_verify", "dispatches_decode", "dispatches_ragged"]
    if kw.get("spec_decode"):
        keys += ["spec_steps", "accepted_tokens", "emitted_tokens"]
        assert stats["spec_steps"] > 0
    if kw.get("tiered"):
        keys += ["repacked_pages", "units_in_use"]
        assert stats["repacked_pages"] > 0
    for key in keys:
        assert stats[key] == jstats[key], key
    if any(sp is not None for sp in sps) or kw.get("temperature"):
        assert 0 < stats["min_sample_lead"] < float("inf")


# ---------------------------------------------------------------------------
# the port alone: speculation leaves greedy streams alone
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("drafter", ["ngram", "scripted"])
@pytest.mark.parametrize("mode", ["ragged", "split", "megakernel"])
def test_spec_streams_equal_plain_streams(granite, mode, drafter):
    _, _, tcfg, tparams = granite
    prompts = _prompts(tcfg.vocab_size)
    plain, pstats = _serve(ContinuousBatchingEngine, ServeConfig,
                           SamplingParams, tparams, tcfg, prompts, [None] * 5,
                           dict(step_mode=mode), device="cpu")
    for k in (1, 4):
        spec, stats = _serve(
            ContinuousBatchingEngine, ServeConfig, SamplingParams, tparams,
            tcfg, prompts, [None] * 5, dict(
                step_mode=mode, spec_decode=True, num_draft_tokens=k,
                drafter="ngram" if drafter == "ngram" else SCRIPTED),
            device="cpu")
        for g, w in zip(spec, plain):
            np.testing.assert_array_equal(g, w)
        assert stats["step_mode"] == mode and stats["preemptions"] >= 1
        assert stats["accepted_per_step"] >= 1.0


def test_same_seed_same_stream_under_churn_and_preemption(granite):
    """A request's sampled stream is a function of its seed alone: alone,
    beside other requests, and swapped out and back in, with speculation
    off and on (the two draw from other keys, so their streams differ)."""
    _, _, tcfg, tparams = granite
    rng = np.random.default_rng(3)
    vocab = tcfg.vocab_size
    prompt = rng.integers(0, vocab, 6).astype(np.int32)
    sp = SamplingParams(temperature=0.8, top_p=0.9, seed=123)
    others = [(rng.integers(0, vocab, s).astype(np.int32), m,
               SamplingParams(temperature=1.2, seed=i))
              for i, (s, m) in enumerate([(6, 14), (9, 5), (4, 8)])]

    def run(reqs, **kw):
        eng = ContinuousBatchingEngine(tparams, tcfg, ServeConfig(
            max_seq=24, page_size=4, prefill_chunk=8, **kw), device="cpu")
        ids = [eng.submit(p, m, sampling_params=s) for p, m, s in reqs]
        out = eng.run()
        return eng, out[ids[0]]

    streams = []
    for spec in (False, True):  # (speculation draws other keys)
        _, want = run([(prompt, 14, sp)], max_slots=2, spec_decode=spec,
                      num_draft_tokens=2)
        _, mixed = run([(prompt, 14, sp)] + others[:2], max_slots=3,
                       spec_decode=spec, num_draft_tokens=2)
        np.testing.assert_array_equal(mixed, want)
        eng, churn = run([(prompt, 14, sp)] + others, max_slots=2,
                         num_pages=8, spec_decode=spec, num_draft_tokens=2)
        assert eng.scheduler.preemptions >= 1
        np.testing.assert_array_equal(churn, want)
        streams.append(want)
    _, other = run([(prompt, 14, SamplingParams(temperature=0.8, top_p=0.9,
                                                seed=124))], max_slots=2)
    assert not np.array_equal(other, streams[0])


def test_spec_eos_mid_window_stops_exactly(granite):
    """An EOS accepted inside a verify window ends the request at it."""
    _, _, tcfg, tparams = granite
    prompts = np.random.default_rng(1).integers(
        0, tcfg.vocab_size, (2, 6)).astype(np.int32)

    def run(**kw):
        eng = ContinuousBatchingEngine(tparams, tcfg, ServeConfig(
            max_seq=24, max_slots=1, page_size=8, prefill_chunk=8, **kw),
            device="cpu")
        ids = [eng.submit(p, 8) for p in prompts]
        out = eng.run()
        return [out[i] for i in ids]

    ref = run()[0]
    eos = int(ref[6 + 2])  # the third greedy token becomes the eos id
    stop = 6 + 1 + int(np.argmax(ref[6:] == eos))
    first, second = run(eos_id=eos, spec_decode=True, num_draft_tokens=4)
    assert first[-1] == eos and len(first) == stop
    np.testing.assert_array_equal(first, ref[:stop])
    assert len(second) == 6 + 8 or second[-1] == eos


# ---------------------------------------------------------------------------
# rollback: pages and cache rows
# ---------------------------------------------------------------------------


def _small_cfgs():
    """The reference property tests' model, in both packages."""
    dims = dict(name="t", family="dense", d_model=64, vocab_size=128,
                num_groups=1, num_heads=4, num_kv_heads=2, head_dim=16,
                d_ff=128)
    jcfg = JaxModelConfig(pattern=(JaxBlockDef("attn"),),
                          quant=JAX_MXFP8.replace(block_size=16,
                                                  quantize_acts=False,
                                                  quantize_kv_cache=True),
                          **dims)
    tcfg = ModelConfig(pattern=(BlockDef("attn"),), quant=MXFP8.replace(
        block_size=16, quantize_acts=False, quantize_kv_cache=True), **dims)
    return jcfg, tcfg


@pytest.fixture(scope="module")
def small():
    jcfg, tcfg = _small_cfgs()
    jparams, _ = jmodel.init(jax.random.PRNGKey(0), jcfg)
    tparams = tmodel.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), tcfg, "cpu")
    return jcfg, jparams, tcfg, tparams


def _page_bytes(eng, pid):
    return [pool[k][pid].view(torch.uint8).clone() for pool in eng.cache
            for k in POOL_KEYS]


@pytest.mark.parametrize("mode", ["ragged", "split"])
def test_cow_protects_a_pinned_write_window_page(small, mode):
    """Pin the page a verify window is about to write: the engine copies
    it first, the pinned bytes survive although most drafts roll back,
    and the stream is the plain engine's."""
    _, _, tcfg, tparams = small
    prompt = np.random.default_rng(0).integers(0, 128, 6).astype(np.int32)
    kw = dict(max_seq=24, max_slots=1, page_size=8, prefill_chunk=8,
              step_mode=mode)
    plain = ContinuousBatchingEngine(tparams, tcfg, ServeConfig(**kw),
                                     device="cpu")
    plain.submit(prompt, 8)
    want = list(plain.run().values())[0]
    eng = ContinuousBatchingEngine(tparams, tcfg, ServeConfig(
        **kw, spec_decode=True, num_draft_tokens=3,
        drafter=ScriptedDrafter(vocab=128, seed=5)), device="cpu")
    eng.submit(prompt, 8)
    eng.step()  # admit, prefill, first token
    eng.step()  # the first verify window
    seq = eng.scheduler.active()[0]
    pinned = seq.pages[seq.pos // 8]
    eng.scheduler.pool.retain([pinned])  # another holder
    before = _page_bytes(eng, pinned)
    copies = eng.scheduler.cow_copies
    eng.step()  # this window writes into the pinned page
    assert eng.scheduler.cow_copies > copies
    assert pinned not in seq.pages, "repointed to a private copy"
    for a, b in zip(before, _page_bytes(eng, pinned)):
        assert torch.equal(a, b)
    while eng.step():
        pass
    eng.scheduler.pool.free([pinned])
    out = np.concatenate([prompt, eng.scheduler.finished[0].generated])
    np.testing.assert_array_equal(out, want)


def test_rejected_drafts_leave_shared_prefix_pages_untouched(small):
    """Shared-head prompts under adversarial drafts: after every step the
    pages the prefix tree holds keep their bytes, hits fire, and the
    streams are the plain engine's."""
    _, _, tcfg, tparams = small
    rng = np.random.default_rng(7)
    head = rng.integers(0, 128, 8).astype(np.int32)
    prompts = [np.concatenate([head, rng.integers(0, 128, 3).astype(
        np.int32)]) for _ in range(3)]
    kw = dict(max_seq=28, max_slots=3, page_size=4, prefill_chunk=4,
              prefix_cache=True)
    plain = ContinuousBatchingEngine(tparams, tcfg, ServeConfig(**kw),
                                     device="cpu")
    ids_p = [plain.submit(p, 8) for p in prompts]
    out_p = plain.run()
    eng = ContinuousBatchingEngine(tparams, tcfg, ServeConfig(
        **kw, spec_decode=True, num_draft_tokens=3,
        drafter=ScriptedDrafter(vocab=128, seed=9)), device="cpu")
    ids_s = [eng.submit(p, 8) for p in prompts]
    held_bytes = {}
    more = True
    while more:
        more = eng.step()
        held = set(eng.scheduler.prefix.pages_held)
        for pid, old in list(held_bytes.items()):
            if pid in held:
                for a, b in zip(old, _page_bytes(eng, pid)):
                    assert torch.equal(a, b), pid
        held_bytes = {pid: _page_bytes(eng, pid) for pid in held}
    out_s = eng.run()
    for i_s, i_p in zip(ids_s, ids_p):
        np.testing.assert_array_equal(out_s[i_s], out_p[i_p])
    stats = eng.cache_stats()
    assert stats["prefix_hit_tokens"] > 0 and stats["spec_steps"] > 0


def _seq_rows(eng, seq, n_rows):
    """The first ``n_rows`` cache rows of ``seq`` through its page table,
    per pool leaf: its logical cache."""
    pages = torch.as_tensor(seq.pages)
    return [pool[k][pages].reshape(-1, *pool[k].shape[2:])[:n_rows]
            .view(torch.uint8).clone() for pool in eng.cache
            for k in POOL_KEYS]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_verify_rollback_cache_equivalence(small, seed):
    """The scenario of the reference's seed-failing property test
    ``test_spec_verify_rollback_cache_equivalence_property`` at fixed
    seeds: after every verify step the sequence's cache rows, position
    and stream equal plain decode's, and the final stream equals the
    reference's speculative engine's."""
    jcfg, jparams, tcfg, tparams = small
    rng = np.random.default_rng(seed)
    prompt = rng.integers(0, 128, (int(rng.integers(2, 7)),)).astype(
        np.int32)
    max_new = int(rng.integers(4, 11))
    k = int(rng.integers(1, 5))
    base = dict(max_seq=24, max_slots=1, page_size=4, prefix_cache=False)
    spec = ContinuousBatchingEngine(tparams, tcfg, ServeConfig(
        **base, spec_decode=True, num_draft_tokens=k,
        drafter=ScriptedDrafter(vocab=128, seed=seed)), device="cpu")
    plain = ContinuousBatchingEngine(tparams, tcfg, ServeConfig(**base),
                                     device="cpu")
    sid = spec.submit(prompt, max_new)
    pid = plain.submit(prompt, max_new)
    guard = 0
    while spec.step():
        guard += 1
        assert guard < 100
        if not spec.scheduler.active():
            break
        sseq = spec.scheduler.active()[0]
        assert sseq.pos == len(prompt) + len(sseq.req.generated) - 1
        while not plain.scheduler.active() or \
                plain.scheduler.active()[0].pos < sseq.pos:
            assert plain.step() or plain.scheduler.active()
        pseq = plain.scheduler.active()[0]
        assert pseq.pos == sseq.pos
        assert pseq.req.generated == sseq.req.generated[
            :len(pseq.req.generated)]
        for a, b in zip(_seq_rows(spec, sseq, sseq.pos),
                        _seq_rows(plain, pseq, pseq.pos)):
            assert torch.equal(a, b)
    out_s = spec.run()
    while plain.step():
        pass
    out_p = plain.run()
    np.testing.assert_array_equal(out_s[sid], out_p[pid])
    assert spec.scheduler.pool.pages_in_use == 0
    ref = JaxEngine(jparams, jcfg, JaxServeConfig(
        max_seq=24, max_slots=1, page_size=4, prefix_cache=False,
        spec_decode=True, num_draft_tokens=k,
        drafter=jspec.ScriptedDrafter(vocab=128, seed=seed)))
    rid = ref.submit(prompt, max_new)
    np.testing.assert_array_equal(ref.run()[rid], out_s[sid])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_spec_churn_refcounts_and_identity(small, seed):
    """The scenario of the reference's seed-failing property test
    ``test_spec_engine_churn_property_refcounts_and_identity`` at fixed
    seeds: per-request outputs equal the plain engine's and the
    reference's speculative engine's, and after draining every page's
    refcount equals the prefix tree's holds."""
    jcfg, jparams, tcfg, tparams = small
    rng = np.random.default_rng(seed)
    head = rng.integers(0, 128, (int(rng.integers(0, 9)),)).astype(np.int32)
    reqs = []
    for _ in range(int(rng.integers(2, 5))):
        tail = rng.integers(0, 128, (int(rng.integers(1, 5)),)).astype(
            np.int32)
        reqs.append((np.concatenate([head, tail]), int(rng.integers(2, 8))))
    k = int(rng.integers(1, 4))
    base = dict(max_seq=28, max_slots=2, page_size=4, prefix_cache=True)
    plain = ContinuousBatchingEngine(tparams, tcfg, ServeConfig(**base),
                                     device="cpu")
    ids_p = [plain.submit(p, m) for p, m in reqs]
    out_p = plain.run()
    spec = ContinuousBatchingEngine(tparams, tcfg, ServeConfig(
        **base, spec_decode=True, num_draft_tokens=k,
        drafter=ScriptedDrafter(vocab=128, seed=seed + 1)), device="cpu")
    ids_s = [spec.submit(p, m) for p, m in reqs]
    out_s = spec.run()
    ref = JaxEngine(jparams, jcfg, JaxServeConfig(
        **base, spec_decode=True, num_draft_tokens=k,
        drafter=jspec.ScriptedDrafter(vocab=128, seed=seed + 1)))
    ids_r = [ref.submit(p, m) for p, m in reqs]
    out_r = ref.run()
    for i_s, i_p, i_r in zip(ids_s, ids_p, ids_r):
        np.testing.assert_array_equal(out_s[i_s], out_p[i_p])
        np.testing.assert_array_equal(out_s[i_s], out_r[i_r])
    pool = spec.scheduler.pool
    held = spec.scheduler.prefix.pages_held
    for pg in range(pool.num_pages):
        assert pool.ref(pg) == held.count(pg), (pg, held)
    assert pool.pages_in_use == len(held)


# ---------------------------------------------------------------------------
# the model step with verify windows
# ---------------------------------------------------------------------------


def _window_rows(cfg, rng, k=4, w=8, ps=8, num_pages=12):
    """Four rows: a decode, two verify windows of 1 + k (one across a page
    boundary) and a prefill chunk; tables from a permutation that never
    hands out the last (trash) page."""
    starts = np.asarray([13, 5, 0, 20], np.int32)
    lens = starts + np.asarray([1, 1 + k, w, 1 + k], np.int32)
    pages_per = [-(-int(t) // ps) for t in lens]
    perm = rng.permutation(num_pages - 1)
    table = np.full((4, max(pages_per) + 1), -1, np.int32)
    off = 0
    for i, npg in enumerate(pages_per):
        table[i, :npg] = perm[off:off + npg]
        off += npg
    tokens = rng.integers(0, cfg.vocab_size, (4, w)).astype(np.int32)
    lidx = np.asarray([0, 0, w - 1, 0], np.int32)
    return tokens, table, starts, lens, lidx


def test_megakernel_verify_windows_equal_ragged_step(granite):
    """``num_logits = 1 + K`` through the megakernel step's plain version
    and the per-layer ragged step (two layers): logits bit for bit, every
    pool byte equal; the same rows of the reference's ragged step within
    one bf16 ulp, argmax equal; ``num_logits=None`` is row 0."""
    jcfg, jparams, tcfg, tparams = granite
    rng = np.random.default_rng(5)
    k, ps, num_pages = 4, 8, 12
    tokens, table, starts, lens, lidx = _window_rows(tcfg, rng, k, ps=ps,
                                                     num_pages=num_pages)
    targs = [torch.from_numpy(a) for a in (tokens, table, starts, lens,
                                           lidx)]
    targs[0] = targs[0].long()
    out = {}
    for name, fn in (("ragged", tmodel.ragged_step_paged),
                     ("megakernel", tmodel.megakernel_step_paged)):
        cache = tmodel.init_paged_cache(tcfg, num_pages, ps, "cpu")
        logits = fn(tparams, tcfg, cache, *targs, num_logits=1 + k)
        out[name] = (logits, [pool[key].view(torch.uint8).clone()
                              for pool in cache for key in POOL_KEYS])
        cache = tmodel.init_paged_cache(tcfg, num_pages, ps, "cpu")
        one = fn(tparams, tcfg, cache, *targs)
        assert torch.equal(one, logits[:, 0])
    (la, pa), (lb, pb) = out["ragged"], out["megakernel"]
    assert la.shape == (4, 1 + k, tcfg.vocab_size)
    assert torch.equal(la.view(torch.int32), lb.view(torch.int32))
    for a, b in zip(pa, pb):
        assert torch.equal(a, b)
    # rows past a row's last real token repeat its last logits
    assert torch.equal(la[0, 1], la[0, 0]) and torch.equal(la[2, 1],
                                                           la[2, 0])
    jcache = jmodel.init_paged_cache(jcfg, 4, num_pages, ps)
    want, _ = jax.jit(lambda p, c, *a: jmodel.ragged_step_paged(
        p, jcfg, c, *a, num_logits=1 + k))(jparams, jcache, tokens, table,
                                            starts, lens, lidx)
    want = torch.from_numpy(np.array(want, np.float32))
    ulp = torch.ldexp(torch.ones(()), torch.frexp(
        want.abs().max()).exponent - 8)
    assert float((la - want).abs().max()) <= float(ulp)
    assert torch.equal(la.argmax(-1), want.argmax(-1))


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------


def test_launcher_serves_sampled_speculative_requests_on_cpu():
    from repro_torch.launch import serve

    argv = ["--arch", "granite-8b", "--reduced", "--batch", "3",
            "--prompt-len", "24", "--shared-prefix", "16", "--ragged",
            "--new-tokens", "6", "--temperature", "0.8", "--seed", "3",
            "--spec-decode", "--device", "cpu"]
    report = serve.main(argv)
    assert report["requests"] == 3 and report["generated_tokens"] == 18
    assert report["spec"]["spec_steps"] > 0
    assert report["spec"]["accepted_per_step"] >= 1.0
    assert 0 < report["min_sample_lead"] < float("inf")
    again = serve.main(argv)
    for i in report["ids"]:
        np.testing.assert_array_equal(again["results"][i],
                                      report["results"][i])
    split = serve.main(argv + ["--step-mode", "split", "--max-slots", "2",
                               "--page-size", "8", "--prefill-chunk", "16",
                               "--no-prefix-cache", "--top-k", "20",
                               "--top-p", "0.9"])
    assert split["generated_tokens"] == 18 and split["prefix_hit_rate"] == 0
    assert split["dispatches"]["verify"] > 0
    args = serve.parse_args(["--arch", "granite-8b", "--spec-decode",
                             "--num-draft-tokens", "2"])
    assert (args.spec_decode, args.num_draft_tokens) == (True, 2)
    for flag in ("--prefill-mode", "--mesh", "--engine"):
        with pytest.raises(SystemExit):
            serve.parse_args(["--arch", "granite-8b", flag, "1"])
    assert serve.parse_args(["--arch", "granite-8b", "--prefill-max-chunks",
                             "1"]).prefill_max_chunks == 1
