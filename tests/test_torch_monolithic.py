"""Monolithic prefill, the contiguous cache, the fixed-slot engine and the
batch API of the port against the reference, on the CPU.

The same numpy-seeded weights (``model.params_from_jax``) and prompts go
through both packages. Dense prefill is held bit for bit: hidden states
after every block, logits, the contiguous cache leaf by leaf (a windowed
layer's ring roll included), tail prefill over page-aligned and
partial-page hits, installed page bytes; so are ``jax.random.split``
keys. One-token decode over the contiguous cache runs q.k as a torch
f32 einsum, which sums its 16 exact products in another order than
XLA:CPU's dot does at one query row (at prefill's many rows the two
orders agree here): a logit may move by one f32 ulp, its softmax row and
a bf16 attention output by one ulp, and the next layer with them. So
each decode step starts from the reference's own cache and is held to
stated bars: logits within DECODE_TOL_ULPS bf16 ulps of the largest
logit with the same argmax, layer 0's cache bit-equal, and at most
DECODE_BYTE_FRACTION of the cache's bytes apart (measured at seeds 1-3
of every kind: the worst step 1.75 ulps and 9 of 6,528 bytes, most
steps bit-equal). Engines are held token for token: greedy streams
under churn, swap preemption, sharing, partial-page hits with
copy-on-write and a pool too small to copy (the prefix tree's partial
entry lets go).

The reference is imported at module level (the file needs JAX, as every
parity test does).
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.core import MXFP4 as J_MXFP4  # noqa: E402
from repro.core import MXFP8 as J_MXFP8  # noqa: E402
from repro.nn import BlockDef as JBlockDef  # noqa: E402
from repro.nn import ModelConfig as JModelConfig  # noqa: E402
from repro.nn import blocks as jblocks  # noqa: E402
from repro.nn import model as jmodel  # noqa: E402
from repro.serve import ContinuousBatchingEngine as JEngine  # noqa: E402
from repro.serve import FixedSlotEngine as JFixed  # noqa: E402
from repro.serve import PagePool as JPagePool  # noqa: E402
from repro.serve import PrefixCache as JPrefixCache  # noqa: E402
from repro.serve import ServeConfig as JServeConfig  # noqa: E402
from repro.serve import kv_cache as jkv  # noqa: E402
from repro_torch.core import MXFP4, MXFP8  # noqa: E402
from repro_torch.nn import BlockDef, ModelConfig  # noqa: E402
from repro_torch.nn import blocks as tblocks  # noqa: E402
from repro_torch.nn import model as tmodel  # noqa: E402
from repro_torch.serve import (ContinuousBatchingEngine,  # noqa: E402
                               FixedSlotEngine, PagePool, PrefixCache,
                               ServeConfig, kv_cache, make_serve_step,
                               sampling)

#: decode over the contiguous cache: logits' distance from the
#: reference's in bf16 ulps of the largest logit, and the share of the
#: cache's bytes that may differ (a one-ulp hidden state moves a few codes)
DECODE_TOL_ULPS = 2
DECODE_BYTE_FRACTION = 0.01

#: the reduced granite shape (2 layers, d_model 64, 4 heads of 16 over 2
#: KV heads) in both packages, by KV cache kind
KINDS = {"fp8": (J_MXFP8, MXFP8, True, None),
         "fp4": (J_MXFP4, MXFP4, True, None),
         "wide": (J_MXFP8, MXFP8, False, None),
         "window": (J_MXFP8, MXFP8, True, 16)}


def _pair(kind="fp8", seed=1, **over):
    """Both packages' configs and weights: the reduced granite (2 layers,
    vocab 512, theta 1e7, an untied head) unless ``over`` says more."""
    jq, tq, kv, window = KINDS[kind]
    dims = dict(name="t", family="dense", d_model=64, vocab_size=512,
                num_groups=2, num_heads=4, num_kv_heads=2, head_dim=16,
                d_ff=128, rope_theta=1e7, tied_embeddings=False)
    dims.update(over)
    quant = dict(block_size=16, quantize_acts=False, quantize_kv_cache=kv)
    jcfg = JModelConfig(pattern=(JBlockDef("attn", window=window),),
                        quant=jq.replace(**quant), **dims)
    tcfg = ModelConfig(pattern=(BlockDef("attn", window=window),),
                       quant=tq.replace(**quant), **dims)
    jparams, _ = jmodel.init(jax.random.PRNGKey(seed), jcfg)
    tparams = tmodel.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), tcfg, "cpu")
    return jcfg, jparams, tcfg, tparams


def _np(t):
    """A port leaf as numpy, fp8 as its bytes."""
    if t.dtype in (torch.float8_e4m3fn, torch.float8_e5m2):
        return t.view(torch.uint8).numpy()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy()


def _jnp(a):
    a = np.asarray(a)
    if a.dtype.itemsize == 1 and a.dtype.kind not in "iub":
        return a.view(np.uint8)
    if a.dtype.name == "bfloat16":
        return a.view(np.int16)
    return a


def _assert_same_tree(jtree, ttree):
    """Leaf by leaf, bit for bit, over the reference's pytree paths."""
    leaves = jax.tree_util.tree_leaves_with_path(jtree)
    assert leaves
    for path, leaf in leaves:
        node = ttree
        for k in path:
            node = node[k.key if hasattr(k, "key") else k.idx]
        np.testing.assert_array_equal(_np(node), _jnp(leaf),
                                      err_msg=jax.tree_util.keystr(path))


def _assert_same_pools(jcache, tcfg, tcache):
    """Paged caches leaf by leaf in the reference's order."""
    jleaves = jax.tree_util.tree_leaves(jcache)
    layout = tmodel.reference_cache_leaves(tcfg, tcache)
    assert len(jleaves) == len(layout)
    for jleaf, (key, layers, stacked) in zip(jleaves, layout):
        got = [_np(tcache[li][key]) for li in layers]
        np.testing.assert_array_equal(np.stack(got) if stacked else got[0],
                                      _jnp(jleaf), err_msg=key)


def _logits(a):
    return np.asarray(a, np.float32)


def _to_port(tree):
    """A reference cache pytree as the port's (dicts and tuples of
    tensors with the same bytes)."""
    if isinstance(tree, dict):
        return {k: _to_port(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_to_port(v) for v in tree)
    a = np.asarray(tree)
    if a.dtype.name in ("float8_e4m3fn", "float8_e5m2", "bfloat16"):
        raw = torch.from_numpy(a.view(np.int16 if a.dtype.itemsize == 2
                                      else np.uint8).copy())
        return raw.view(getattr(torch, a.dtype.name))
    return torch.from_numpy(a.copy())


def _assert_decode_close(jl, tl, jcache, tcache):
    """The decode bars: logits within DECODE_TOL_ULPS bf16 ulps of the
    largest, same argmax; ``kpos`` and layer 0 bit-equal; at most
    DECODE_BYTE_FRACTION of all bytes apart."""
    want, got = _logits(jl), tl.numpy()
    tol = DECODE_TOL_ULPS * 2.0 ** (np.floor(np.log2(np.abs(want).max()))
                                    - 7)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    differing = total = 0
    for key, jleaf in jcache["groups"][0].items():
        g, w = _np(tcache["groups"][0][key]), _jnp(jleaf)
        np.testing.assert_array_equal(g[0], w[0], err_msg=f"layer 0 {key}")
        if key == "kpos":
            np.testing.assert_array_equal(g, w)
        differing += int((g != w).sum())
        total += g.size
    assert differing <= DECODE_BYTE_FRACTION * total, (differing, total)


# ---------------------------------------------------------------------------
# the contiguous model path
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_prefill_and_decode_equal_the_jitted_reference(kind):
    """Hidden states after each block (each package's own chain), prefill
    logits and cache all bit-equal; then five decode steps through
    ``make_serve_step``, each from the reference's cache of the step
    before, held to the decode bars. The windowed
    kind's 37-token prompt fills its 16-slot ring, which the prefill
    rolls by 21 % 16 and decode keeps wrapping."""
    jcfg, jparams, tcfg, tparams = _pair(kind)
    rng = np.random.default_rng(7)
    toks = rng.integers(0, 512, (2, 37)).astype(np.int32)
    max_seq = 48
    positions = np.broadcast_to(np.arange(37, dtype=np.int32), (2, 37))
    jx = jmodel._embed_inputs(jparams, jcfg, jax.numpy.asarray(toks))
    tx = tmodel.embedding.embed(tparams["embedding"],
                                torch.from_numpy(toks).long())
    for li, (key, g, bd) in enumerate(jmodel.iter_layer_blocks(jcfg)):
        jfn = jax.jit(functools.partial(jblocks.prefill_block, bd=bd,
                                        cfg=jcfg, max_seq=max_seq))
        jx, jc = jfn(jmodel.layer_params(jparams, key, g), jx, positions)
        tx, tc = tblocks.prefill_block(
            tparams["layers"][li], tx, torch.from_numpy(positions.copy()),
            tcfg.all_blocks()[li], tcfg, max_seq)
        tx = tx.to(tcfg.compute_dtype)  # as the model stores it
        np.testing.assert_array_equal(_np(tx), _jnp(jx), err_msg=f"block {li}")
        _assert_same_tree(jc, tc)
    jl, jcache = jax.jit(lambda p, t: jmodel.prefill(
        p, jcfg, tokens=t, max_seq=max_seq))(jparams, toks)
    tl, tcache = tmodel.prefill(tparams, tcfg, torch.from_numpy(toks).long(),
                                max_seq=max_seq)
    np.testing.assert_array_equal(tl.numpy(), _logits(jl))
    _assert_same_tree(jcache, tcache)
    if kind == "window":
        kpos = tcache["groups"][0]["kpos"][0].tolist()
        assert kpos[:5] == list(range(32, 37)) and kpos[5] == 21
    jstep = jax.jit(lambda p, c, t, pos: jmodel.decode_step(
        p, jcfg, c, tokens=t, pos=pos))
    tstep = make_serve_step(tcfg)
    tok = np.argmax(_logits(jl)[:, -1], axis=-1).astype(np.int32)[:, None]
    for i in range(5):
        pos = 37 + i
        tcache = _to_port(jcache)
        jl, jcache = jstep(jparams, jcache, tok, np.int32(pos))
        tl, tcache = tstep(tparams, tcache, torch.from_numpy(tok).long(), pos)
        _assert_decode_close(jl, tl, jcache, tcache)
        tok = np.argmax(_logits(jl)[:, -1], axis=-1).astype(np.int32)[:, None]


def _paged_pair(jcfg, tcfg, num_pages):
    jfull = jcfg.replace(serve_full_cache=True)
    tfull = tcfg.replace(serve_full_cache=True)
    return (jfull, tfull, jmodel.init_paged_cache(jcfg, 1, num_pages, 8),
            tmodel.init_paged_cache(tcfg, num_pages, 8, "cpu"))


@pytest.mark.parametrize("pos0", [16, 21])
def test_tail_prefill_and_installs_equal_the_reference(pos0):
    """A 21-token prompt (two pages and 5 rows) prefilled and installed
    into pages [3, 5, 1]; then a prompt that shares its first ``pos0``
    tokens prefills its tail over the gathered prefix pages: 16 is
    page-aligned (``install_prefill`` into fresh pages), 21 ends in page
    1, which is copied to page 7 and the tail's rows installed from its
    row 5 on (``install_prefill_offset``). Logits and tail caches are
    bit-equal, pool bytes byte-equal, and the tail's logits equal a cold
    prefill of the whole prompt."""
    jcfg, jparams, tcfg, tparams = _pair("fp8")
    jfull, tfull, jcache, tcache = _paged_pair(jcfg, tcfg, 10)
    rng = np.random.default_rng(3)
    a = rng.integers(0, 512, (21,)).astype(np.int32)
    b = np.concatenate([a[:pos0], rng.integers(0, 512, (11,))]).astype(
        np.int32)
    pages_a = [3, 5, 1]
    _, jpf = jax.jit(lambda p, t: jmodel.prefill(
        p, jfull, tokens=t, max_seq=24))(jparams, a[None])
    _, tpf = tmodel.prefill(tparams, tfull, torch.from_numpy(a[None]).long(),
                            max_seq=24)
    jcache = jkv.install_prefill(jcache, jpf, 0, np.asarray(pages_a), 8)
    kv_cache.install_prefill(tcache, tmodel.cache_layers(tfull, tpf),
                             torch.tensor(pages_a), 8)
    _assert_same_pools(jcache, tcfg, tcache)

    n_full, valid = divmod(pos0, 8)
    gather = pages_a[:n_full + (1 if valid else 0)]
    tail = b[pos0:]
    tail_seq = -(-len(tail) // 8) * 8
    jl, jtc = jax.jit(lambda p, c, t, pp: jmodel.prefill_with_prefix(
        p, jfull, c, t, pp, pos0, tail_seq))(
            jparams, jcache, tail[None], np.asarray(gather))
    tl, ttc = tmodel.prefill_with_prefix(
        tparams, tfull, tcache, torch.from_numpy(tail[None]).long(),
        torch.tensor(gather), pos0, tail_seq)
    np.testing.assert_array_equal(tl.numpy(), _logits(jl))
    _assert_same_tree(jtc, ttc)
    cold, _ = tmodel.prefill(tparams, tfull, torch.from_numpy(b[None]).long(),
                             max_seq=32)
    np.testing.assert_array_equal(tl.numpy(), cold.numpy())
    layers = tmodel.cache_layers(tfull, ttc)
    if valid:
        jcache = jkv.copy_page(jcache, np.int32(1), np.int32(7))
        kv_cache.copy_page(tcache, 1, 7)
        ids = [7, 2, 4]
        jcache = jkv.install_prefill_offset(jcache, jtc, 0, np.asarray(ids),
                                            8, valid, len(tail))
        kv_cache.install_prefill_offset(tcache, layers, torch.tensor(ids), 8,
                                        valid, len(tail))
    else:
        ids = [6, 0]
        jcache = jkv.install_prefill(jcache, jtc, 0, np.asarray(ids), 8)
        kv_cache.install_prefill(tcache, layers, torch.tensor(ids), 8)
    _assert_same_pools(jcache, tcfg, tcache)


def test_installs_write_through_the_layer_stack():
    """On a uniform stack the per-layer pools are slices of
    ``PagedCache.stack``: an install writes a layer at a time and the
    (L, NP, ...) tensors that the stacked kernels read hold its bytes."""
    _, _, tcfg, tparams = _pair("fp8")
    tfull = tcfg.replace(serve_full_cache=True)
    prompt = torch.arange(1, 14)[None]
    _, pf = tmodel.prefill(tparams, tfull, prompt, max_seq=16)
    layers = tmodel.cache_layers(tfull, pf)
    cache = tmodel.init_paged_cache(tcfg, 6, 8, "cpu")
    assert cache.stack is not None
    kv_cache.install_prefill(cache, layers, torch.tensor([4, 2]), 8)
    kv_cache.install_prefill_offset(cache, layers, torch.tensor([5, 1]),
                                    8, 3, 9)
    for li, pool in enumerate(cache):
        for key, leaf in pool.items():
            assert torch.equal(cache.stack[key][li].view(torch.uint8),
                               leaf.view(torch.uint8))
        assert cache.stack["k_elems"].view(torch.uint8)[li, 4].any()
        assert cache.stack["k_elems"].view(torch.uint8)[li, 1].any()


# ---------------------------------------------------------------------------
# engines
# ---------------------------------------------------------------------------


def _tiny(seed):
    """tests/test_prefix_cache.py's model: one block, vocab 128, theta
    1e4, tied embeddings."""
    return _pair("fp8", seed=seed, num_groups=1, vocab_size=128,
                 rope_theta=10000.0, tied_embeddings=True)


def _shared_head_prompts():
    rng = np.random.default_rng(3)
    head = rng.integers(0, 128, (32,)).astype(np.int32)
    return [np.concatenate([head, rng.integers(0, 128, (8,)).astype(np.int32)])
            for _ in range(6)]


def _streams(eng, reqs):
    ids = [eng.submit(p, m) for p, m in reqs]
    res = eng.run()
    return [res[i] for i in ids], eng.cache_stats()


def _serve_port(models, reqs, **serve):
    """(streams, stats) of ``reqs``, each (prompt, max_new), through the
    port's monolithic engine."""
    _, _, tcfg, tparams = models
    return _streams(ContinuousBatchingEngine(tparams, tcfg, ServeConfig(
        prefill_mode="monolithic", **serve), device="cpu"), reqs)


def _serve_both(models, reqs, **serve):
    """``reqs`` through the reference's and the port's monolithic engines:
    (reference streams, port streams, reference stats, port stats)."""
    jcfg, jparams, _, _ = models
    want, jstats = _streams(JEngine(jparams, jcfg, JServeConfig(
        prefill_mode="monolithic", **serve)), reqs)
    got, stats = _serve_port(models, reqs, **serve)
    return want, got, jstats, stats


STAT_KEYS = ("preemptions", "prefix_evictions", "prefix_hit_tokens",
             "cow_copies", "prefix_dedupes", "prefix_partial_inserts",
             "prefix_partial_entries", "dispatches_prefill",
             "dispatches_write", "dispatches_decode", "prompt_tokens",
             "prefill_tokens_computed")


def _assert_same_serving(want, got, jstats, stats):
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g, w, err_msg=f"request {i}")
    for key in STAT_KEYS:
        assert stats[key] == jstats[key], key


@pytest.mark.parametrize("seed", [18, 0])
def test_monolithic_streams_equal_the_reference_under_churn(seed):
    """Six prompts sharing a 32-token head through three slots and a
    ten-page pool (admission churn, sharing, LRU eviction and swap
    preemption). Seed 0 is the scenario of the reference's
    test_prefix_sharing_with_preemption_and_eviction: a pick there is an
    exact tie, and the port's monolithic engine takes the reference's."""
    models = _tiny(seed)
    want, got, jstats, stats = _serve_both(
        models, [(p, 10) for p in _shared_head_prompts()], max_seq=52,
        max_slots=3, page_size=8, num_pages=10, prefix_cache=True)
    assert stats["preemptions"] >= 1 and stats["prefix_evictions"] >= 1
    assert stats["prefix_hit_tokens"] > 0
    assert stats["step_mode"] == "split" and stats["ragged_steps"] == 0
    _assert_same_serving(want, got, jstats, stats)
    if seed == 0:
        assert stats["min_top2_gap_ulps"] == 0.0


def _chat_requests():
    """A head ending mid-page (one page and two rows at page size 8) as
    the first prompt, then prompts that extend it: partial-page hits."""
    rng = np.random.default_rng(41)
    head = rng.integers(0, 128, (10,)).astype(np.int32)
    return head, [(head, 4)] + [
        (np.concatenate([head, rng.integers(0, 128, (t,))]).astype(np.int32),
         4) for t in (6, 2, 9)]


def test_partial_page_hits_equal_the_reference_and_the_cold_run():
    """Partial-page hits under monolithic admission, on two slots: every
    follower hits the head's two mid-page tokens, the shared partial page
    is copied before its tail is installed, and the streams equal the
    reference's and the port's own run without a prefix cache."""
    models = _tiny(0)
    _, reqs = _chat_requests()
    serve = dict(max_seq=32, max_slots=2, page_size=8)
    want, got, jstats, stats = _serve_both(models, reqs, prefix_cache=True,
                                           **serve)
    _assert_same_serving(want, got, jstats, stats)
    assert stats["prefix_partial_inserts"] >= 1
    assert stats["prefix_hit_tokens"] >= 3 * 10
    assert stats["cow_copies"] >= 1
    cold, _ = _serve_port(models, reqs, prefix_cache=False, **serve)
    for g, c in zip(got, cold):
        np.testing.assert_array_equal(g, c)


@pytest.mark.parametrize("options", [
    dict(spec_decode=True, num_draft_tokens=3), dict(decode_kernel="einsum"),
    dict(temperature=0.8, seed=5)])
def test_monolithic_with_speculation_einsum_and_sampling(options):
    """Monolithic admission beside the split step's other paths: verify
    windows of 1 + K rows (the copy-on-write of a partial page covers the
    window), the einsum decode oracle, and sampled requests (each from
    its own seed): streams and stats equal to the reference's."""
    _, reqs = _chat_requests()
    want, got, jstats, stats = _serve_both(
        _tiny(18), reqs, max_seq=40, max_slots=2, page_size=8, **options)
    _assert_same_serving(want, got, jstats, stats)
    assert stats["prefix_partial_inserts"] >= 1


def test_pool_sized_to_one_sequence_lets_the_partial_entry_go(monkeypatch):
    """Two pages for one 16-token sequence: the second prompt's hit ends
    in the first's partial page, no page is left for the copy, so the
    tree's partial entry lets go and the tail installs in place; its own
    decode meets the same at its partial page. No deadlock, and streams
    equal the reference's and the cold run's."""
    models = _tiny(0)
    head, _ = _chat_requests()
    reqs = [(head, 1), (np.concatenate([head, [5, 6, 7]]).astype(np.int32),
                        3)]
    serve = dict(max_seq=16, max_slots=1, page_size=8, num_pages=2)
    unpinned = []
    orig = ContinuousBatchingEngine._unpin_partial

    def counted(self, pid):
        ok = orig(self, pid)
        unpinned.append(ok)
        return ok

    monkeypatch.setattr(ContinuousBatchingEngine, "_unpin_partial", counted)
    want, got, jstats, stats = _serve_both(models, reqs, prefix_cache=True,
                                           **serve)
    _assert_same_serving(want, got, jstats, stats)
    assert unpinned.count(True) >= 2 and stats["cow_copies"] == 0
    assert stats["prefix_hit_tokens"] == 10
    cold, _ = _serve_port(models, reqs, prefix_cache=False, **serve)
    for g, c in zip(got, cold):
        np.testing.assert_array_equal(g, c)


def test_monolithic_falls_back_from_the_ragged_step(caplog):
    _, _, tcfg, tparams = _tiny(0)
    with caplog.at_level("INFO"):
        eng = ContinuousBatchingEngine(tparams, tcfg, ServeConfig(
            max_seq=32, prefill_mode="monolithic", step_mode="megakernel",
            prefill_chunk=0), device="cpu")
    assert not eng.ragged and not eng.megakernel
    assert eng.cache_stats()["step_mode"] == "split"
    assert "using split dispatches" in caplog.text
    assert eng._trash_pages == 0


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_fixed_slot_engine_equals_the_reference(temperature):
    """Greedy, and sampled under the reference's key chain (the first
    token under PRNGKey(0), each later one under a split)."""
    jcfg, jparams, tcfg, tparams = _pair("fp8", seed=2)
    prompts = np.random.default_rng(5).integers(0, 512, (3, 19)).astype(
        np.int32)
    want = JFixed(jparams, jcfg, JServeConfig(
        max_seq=40, temperature=temperature)).generate(prompts, 8)
    got = FixedSlotEngine(tparams, tcfg, ServeConfig(
        max_seq=40, temperature=temperature), device="cpu").generate(
            prompts, 8)
    assert got.shape == (3, 27) and got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_generate_pads_with_eos_as_the_reference():
    """The batch API: (B, S0 + new) int32, rows that stop at EOS right
    padded with eos_id; equal to the reference's ``generate``."""
    jcfg, jparams, tcfg, tparams = _tiny(18)
    prompts = np.stack([p[:20] for p in _shared_head_prompts()[:3]])
    base = dict(max_seq=40, max_slots=2, page_size=8,
                prefill_mode="monolithic")
    plain = ContinuousBatchingEngine(tparams, tcfg, ServeConfig(**base),
                                     device="cpu").generate(prompts, 8)
    eos = int(plain[1, 23])  # the fourth token of row 1's stream
    kw = dict(base, eos_id=eos)
    want = JEngine(jparams, jcfg, JServeConfig(**kw)).generate(prompts, 8)
    got = ContinuousBatchingEngine(tparams, tcfg, ServeConfig(**kw),
                                   device="cpu").generate(
                                       prompts, 8, key=np.zeros(2))
    assert got.shape == (3, 28) and got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert (got[1, 24:] == eos).all()


@pytest.mark.parametrize("seed,num", [(0, 2), (7, 3), (12345, 2)])
def test_split_keys_equal_jax(seed, num):
    key = jax.random.PRNGKey(seed)
    for _ in range(3):
        want = np.asarray(jax.random.split(key, num))
        got = sampling.split(np.asarray(key).astype(np.int64), num)
        np.testing.assert_array_equal(got, want.astype(np.int64))
        got_t = sampling.split(torch.from_numpy(
            np.asarray(key).astype(np.int64)), num)
        np.testing.assert_array_equal(got_t.numpy(), want.astype(np.int64))
        key = jax.random.split(key)[1]


# ---------------------------------------------------------------------------
# partial-page entries in the prefix tree and in snapshots
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_partial_entries_follow_the_reference_tree(seed):
    """One random script of acquire (with partial hits, copied or let go
    as the engine does), insert(partial=True), finish, evict and
    release_partial on both packages' trees: equal results, refcounts,
    exports and stats after every operation."""
    rng = np.random.default_rng(seed)
    ps, num_pages = 4, 24
    trees = [JPrefixCache(JPagePool(num_pages), ps),
             PrefixCache(PagePool(num_pages), ps)]
    live = [[], []]
    for _ in range(80):
        op = int(rng.integers(4))
        arg = [int(x) for x in rng.integers(0, 3, size=13)]
        n_tok = int(rng.integers(1, 13))
        full_only = bool(rng.integers(4) == 0)
        results = []
        for tree, tables in zip(trees, live):
            pool = tree.pool
            if op == 0:
                prompt = np.asarray(arg[:n_tok], np.int32)
                hit, cached = tree.acquire(prompt, full_only=full_only)
                if cached % ps:
                    if pool.can_alloc(1):
                        (new,) = pool.alloc(1)
                        pool.free([hit[-1]])
                        hit[-1] = new
                    else:
                        tree.release_partial(hit[-1])
                need = -(-n_tok // ps) - len(hit)
                ids = pool.alloc(need) if pool.can_alloc(need) else None
                if ids is None:
                    tree.evict(need - pool.free_pages)
                    ids = pool.alloc(need)
                if ids is None:
                    pool.free(hit)
                    results.append((cached, None))
                    continue
                table = hit + ids
                created = tree.insert(prompt, table, partial=True)
                tables.append(table)
                results.append((cached, created, list(table)))
            elif op == 1:
                if tables:
                    pool.free(tables.pop(n_tok % len(tables)))
                results.append(len(tables))
            elif op == 2:
                results.append(tree.evict(n_tok % 4))
            else:
                results.append(tree.release_partial(n_tok + 3 * arg[0]))
        assert results[0] == results[1], op
        j, t = trees
        assert t.export_state() == j.export_state()
        assert t.stats() == j.stats()
        assert t.evictable_count() == j.evictable_count()
        assert [t.pool.ref(p) for p in range(num_pages)] == \
            [j.pool.ref(p) for p in range(num_pages)]


def _fill(eng, reqs, new=4):
    ids = [eng.submit(p, new) for p, _ in reqs]
    out = eng.run()
    return [out[i] for i in ids]


def test_snapshot_with_partials_reference_to_port_to_reference(tmp_path):
    """A reference monolithic engine's snapshot holds partial entries; the
    port loads it (the same tree as a reference engine loading it, warm
    hits through the partial pages equal) and saves a file equal byte for
    byte to the one that reference engine saves, so the reference loads
    the port's file as its own."""
    jcfg, jparams, tcfg, tparams = _tiny(0)
    head, reqs = _chat_requests()
    kw = dict(max_seq=32, max_slots=2, page_size=8,
              prefill_mode="monolithic")
    jsave = JEngine(jparams, jcfg, JServeConfig(**kw))
    _fill(jsave, reqs)
    jsave.save_prefix_cache(tmp_path / "ref.npz")
    state = jsave.scheduler.prefix.export_state()
    assert len(state["partials"]) >= 2

    def port():
        return ContinuousBatchingEngine(tparams, tcfg, ServeConfig(**kw),
                                        device="cpu")

    warm = [(np.concatenate([head, [9, 9, 9]]).astype(np.int32), 4)]
    tload = port()
    n = tload.load_prefix_cache(tmp_path / "ref.npz")
    assert n == len(state["nodes"]) + len(state["partials"])
    jload = JEngine(jparams, jcfg, JServeConfig(**kw))
    jload.load_prefix_cache(tmp_path / "ref.npz")
    assert tload.scheduler.prefix.export_state() == \
        jload.scheduler.prefix.export_state()
    tload.save_prefix_cache(tmp_path / "port.npz")
    jload.save_prefix_cache(tmp_path / "ref2.npz")
    with np.load(tmp_path / "ref2.npz") as a, \
            np.load(tmp_path / "port.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for name in a.files:
            np.testing.assert_array_equal(a[name], b[name], err_msg=name)
    np.testing.assert_array_equal(_fill(tload, warm)[0],
                                  _fill(jload, warm)[0])
    assert tload.cache_stats()["prefix_hit_tokens"] == 10


def test_ragged_snapshot_loads_into_the_monolithic_engine(tmp_path):
    """A ragged engine's snapshot (full pages only) warm-starts a
    monolithic engine, whose warm hit equals the reference monolithic
    engine's on the same file."""
    jcfg, jparams, tcfg, tparams = _tiny(0)
    _, reqs = _chat_requests()
    kw = dict(max_seq=32, max_slots=2, page_size=8)
    ragged = ContinuousBatchingEngine(tparams, tcfg, ServeConfig(**kw),
                                      device="cpu")
    _fill(ragged, reqs)
    ragged.save_prefix_cache(tmp_path / "ragged.npz")
    mono = dict(kw, prefill_mode="monolithic")
    teng = ContinuousBatchingEngine(tparams, tcfg, ServeConfig(**mono),
                                    device="cpu")
    jeng = JEngine(jparams, jcfg, JServeConfig(**mono))
    assert teng.load_prefix_cache(tmp_path / "ragged.npz") == \
        jeng.load_prefix_cache(tmp_path / "ragged.npz") > 0
    warm = [(reqs[2][0], 4)]
    np.testing.assert_array_equal(_fill(teng, warm)[0], _fill(jeng, warm)[0])
    assert teng.cache_stats()["prefix_hit_tokens"] == 8
