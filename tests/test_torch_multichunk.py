"""Several prompt chunks per ragged row: the reference's prefill budgeting.

``ServeConfig.prefill_max_chunks`` lets a prefilling sequence take up to
that many chunks in one ragged (or megakernel) step while the batch is
undersubscribed (fewer active sequences than slots); a full batch falls
back to one chunk, so decode rows are never starved. The ragged width is
``prefill_chunk * prefill_max_chunks``.

Held against the JAX package, with the same seeded numpy inputs and the
reference's weights carried over with ``params_from_jax``:
  * the scheduler's budget, ``prefill_allowed_chunks`` and
    ``planned_prefill_real``, at each point of the reference's
    ``test_scheduler_prefill_chunk_budget`` scenario, and its ValueError;
  * the reference's ``test_megakernel_multichunk_prefill_budgeting``
    scenario in the ragged, megakernel, tiered and speculative modes at
    ``prefill_max_chunks`` 1, 2 and 4: streams, ``prefill_dispatches``
    and ``prefill_rows_per_step`` equal to the reference engine's;
  * the ragged kernel's plain version at W = 4 chunks against the
    reference kernel (interpret mode), on rows mixing a decode row, a
    verify window and multi-chunk prefills: pool bytes and visits equal,
    outputs within OUT_TOL (the two sum f32 products in other orders);
  * the launcher's ``--prefill-max-chunks`` on reduced granite.
The query tile the CUDA cell walks a wide row in (``query_tile``) is
planned here; the ``cuda``-marked tests hold the tiled kernel against its
plain version, and a forced small tile against one tile bit for bit, on
the card.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import MXFP8, quantize  # noqa: E402
from repro_torch.kernels import mx_attention as tk  # noqa: E402
from repro_torch.kernels import mx_megakernel as tmk  # noqa: E402
from repro_torch.nn import BlockDef, ModelConfig  # noqa: E402
from repro_torch.nn import model as tmodel  # noqa: E402
from repro_torch.serve import (ContinuousBatchingEngine,  # noqa: E402
                               ServeConfig, TierPolicy)
from repro_torch.serve.scheduler import Scheduler  # noqa: E402

OUT_TOL = 1e-5
#: the tiered mode's policy (both packages): pages demote after one idle
#: step, so repacks run while the long prompt still streams
TIERS = dict(hot_steps=1, cold_steps=3)
#: the reference test's engine settings (tests/test_megakernel.py)
SERVE = dict(max_seq=48, max_slots=3, page_size=4, prefill_chunk=4)
MODES = {"ragged": dict(step_mode="ragged"),
         "megakernel": dict(step_mode="megakernel"),
         "tiered": dict(step_mode="ragged", tiered=True),
         "spec": dict(step_mode="ragged", spec_decode=True,
                      num_draft_tokens=2)}


def _jax():
    jax = pytest.importorskip("jax")
    return jax


# ---------------------------------------------------------------------------
# the scheduler's budget
# ---------------------------------------------------------------------------


def _budget_trace(cls):
    """The reference test's scenario on scheduler class ``cls``: the
    allowed chunks at each point and the planned bites at several
    widths."""
    sched = cls(max_slots=2, num_pages=16, page_size=4, max_seq=16,
                prefill_chunk=4, prefill_max_chunks=3)
    trace = [sched.prefill_allowed_chunks()]  # empty batch
    for _ in range(2):
        sched.submit(np.arange(12, dtype=np.int32), 2)
    assert sched.admit_next() is not None
    seq = sched.prefilling()[0]
    trace += [sched.prefill_allowed_chunks()]  # one slot still free
    trace += [sched.planned_prefill_real(seq, w) for w in (4, 8, 12, 16)]
    assert sched.admit_next() is not None
    trace += [sched.prefill_allowed_chunks()]  # fully subscribed
    trace += [sched.planned_prefill_real(seq, w) for w in (4, 8, 12, 16)]
    seq.prefill_pos = 10  # two prompt tokens left
    trace += [sched.planned_prefill_real(seq, w) for w in (4, 12)]
    return trace


def test_scheduler_prefill_chunk_budget_equals_reference():
    from repro.serve.scheduler import Scheduler as JaxScheduler

    got, want = _budget_trace(Scheduler), _budget_trace(JaxScheduler)
    assert got == want
    # undersubscribed: three chunks up to the width; full: one
    assert got == [3, 3, 4, 8, 12, 12, 1, 4, 4, 4, 4, 2, 2]
    kw = dict(max_slots=2, num_pages=16, page_size=4, max_seq=16,
              prefill_chunk=4, prefill_max_chunks=0)
    with pytest.raises(ValueError) as g:
        Scheduler(**kw)
    with pytest.raises(ValueError) as w:
        JaxScheduler(**kw)
    assert str(g.value) == str(w.value)


@pytest.mark.parametrize("mode", ["ragged", "split", "monolithic"])
def test_engine_rejects_zero_chunks_as_the_reference(mode):
    from repro.serve import ContinuousBatchingEngine as JaxEngine
    from repro.serve import ServeConfig as JaxServeConfig

    jcfg, tcfg = _configs()
    kw = dict(SERVE, prefill_max_chunks=0)
    if mode == "split":
        kw["step_mode"] = "split"
    elif mode == "monolithic":
        kw.update(prefill_mode="monolithic", prefill_chunk=64)
    jparams, _ = _jax_model(jcfg, 0)
    with pytest.raises(ValueError) as want:
        JaxEngine(jparams, jcfg, JaxServeConfig(**kw))
    with pytest.raises(ValueError) as got:
        ContinuousBatchingEngine({}, tcfg, ServeConfig(**kw), device="cpu")
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# the engine: the reference's budgeting scenario in every ragged mode
# ---------------------------------------------------------------------------


def _configs():
    """(reference cfg, port cfg) of tests/test_megakernel.py's ``_cfg``:
    two attention layers, head_dim 16, weight-only MXFP8, fp8 pages."""
    from repro.core import MXFP8 as JMXFP8
    from repro.nn import BlockDef as JBlockDef
    from repro.nn import ModelConfig as JModelConfig

    dims = dict(name="t", family="dense", d_model=64, vocab_size=128,
                num_groups=2, num_heads=4, num_kv_heads=2, head_dim=16,
                d_ff=128)
    qkw = dict(fmt="fp8_e4m3", block_size=16, quantize_acts=False,
               quantize_kv_cache=True)
    jcfg = JModelConfig(pattern=(JBlockDef("attn"),),
                        quant=JMXFP8.replace(**qkw), decode_kernel="fused",
                        **dims)
    tcfg = ModelConfig(pattern=(BlockDef("attn"),),
                       quant=MXFP8.replace(**qkw), **dims)
    return jcfg, tcfg


def _jax_model(jcfg, seed):
    from repro.nn import model as jmodel

    return jmodel.init(_jax().random.PRNGKey(seed), jcfg)


def _requests():
    """The reference test's two requests: a 30-token prompt beside a
    4-token one, so the long prompt streams while a slot stays free."""
    rng = np.random.default_rng(21)
    return [(rng.integers(0, 128, (30,)).astype(np.int32), 4),
            (rng.integers(0, 128, (4,)).astype(np.int32), 6)]


def _serve_both(mode: str, chunks: int):
    """(port streams, port stats, reference streams, reference stats) of
    the requests through ``mode`` at ``prefill_max_chunks`` ``chunks``."""
    from repro.serve import ContinuousBatchingEngine as JaxEngine
    from repro.serve import ServeConfig as JaxServeConfig
    from repro.serve import TierPolicy as JaxTierPolicy

    jax = _jax()
    jcfg, tcfg = _configs()
    jparams, _ = _jax_model(jcfg, 0)
    tparams = tmodel.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), tcfg, "cpu")
    kw = dict(SERVE, prefill_max_chunks=chunks, **MODES[mode])
    jkw = dict(kw)
    if kw.get("tiered"):
        kw["tier_policy"] = TierPolicy(**TIERS)
        jkw["tier_policy"] = JaxTierPolicy(**TIERS)
    runs = []
    for eng in (ContinuousBatchingEngine(tparams, tcfg, ServeConfig(**kw),
                                         device="cpu"),
                JaxEngine(jparams, jcfg, JaxServeConfig(**jkw))):
        ids = [eng.submit(p, m) for p, m in _requests()]
        out = eng.run()
        runs += [[out[i] for i in ids], eng.cache_stats()]
    return runs


@pytest.mark.parametrize("chunks", [1, 2, 4])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_multichunk_engine_equals_reference(mode, chunks):
    """Streams, prefill dispatches and prompt rows a prefill-carrying
    dispatch equal the reference engine's, in every ragged mode."""
    got, stats, want, jstats = _serve_both(mode, chunks)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    for key in ("prefill_dispatches", "prefill_rows_per_step",
                "prefill_tokens_computed", "prefill_chunks"):
        assert stats[key] == jstats[key], key
    assert stats["step_mode"] == MODES[mode]["step_mode"]
    if mode == "tiered":
        assert stats["repacked_pages"] == jstats["repacked_pages"] > 0
    if mode == "spec":
        assert stats["accepted_tokens"] == jstats["accepted_tokens"]


@pytest.mark.parametrize("mode", sorted(MODES))
def test_four_chunks_take_fewer_prefill_dispatches(mode):
    """The reference test's invariant in the port: four chunks a step
    retire the long prompt in fewer prefill dispatches with the same
    streams (chunk splits leave the ragged path's numbers unchanged).
    Not so on the tiered cache: its pages demote by steps since their
    last write, so a prompt retired in fewer steps is read under other
    formats and its stream may part (in the reference too, which
    test_multichunk_engine_equals_reference holds it to)."""
    one, s1, _, _ = _serve_both(mode, 1)
    four, s4, _, _ = _serve_both(mode, 4)
    if mode != "tiered":
        for a, b in zip(one, four):
            np.testing.assert_array_equal(a, b)
    assert s4["prefill_dispatches"] < s1["prefill_dispatches"]
    assert s4["prefill_rows_per_step"] > s1["prefill_rows_per_step"]


@pytest.mark.parametrize("mode", ["split", "monolithic"])
def test_split_and_monolithic_ignore_the_option(mode):
    """The split step and monolithic admission read no chunk budget: at
    four chunks they serve the one-chunk streams with the same dispatch
    counts, as the reference's do."""
    from repro.serve import ContinuousBatchingEngine as JaxEngine
    from repro.serve import ServeConfig as JaxServeConfig

    jax = _jax()
    jcfg, tcfg = _configs()
    jparams, _ = _jax_model(jcfg, 0)
    tparams = tmodel.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), tcfg, "cpu")
    kw = dict(SERVE, step_mode="split")
    if mode == "monolithic":
        kw.update(prefill_mode="monolithic", prefill_chunk=64)
    runs = {}
    for chunks in (1, 4):
        for name, eng in (
                ("port", ContinuousBatchingEngine(
                    tparams, tcfg, ServeConfig(prefill_max_chunks=chunks,
                                               **kw), device="cpu")),
                ("ref", JaxEngine(jparams, jcfg, JaxServeConfig(
                    prefill_max_chunks=chunks, **kw)))):
            ids = [eng.submit(p, m) for p, m in _requests()]
            out = eng.run()
            stats = eng.cache_stats()
            runs[name, chunks] = ([out[i] for i in ids], {
                k: stats[k] for k in ("prefill_dispatches",
                                      "prefill_rows_per_step")})
            if name == "port":
                assert stats["step_mode"] == "split"
    for chunks in (1, 4):
        for g, w in zip(runs["port", chunks][0], runs["ref", chunks][0]):
            np.testing.assert_array_equal(g, w)
        assert runs["port", chunks][1] == runs["ref", chunks][1]
        assert runs["port", chunks][1] == runs["port", 1][1]
    for a, b in zip(runs["port", 4][0], runs["port", 1][0]):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# the ragged kernel at four chunks a row
# ---------------------------------------------------------------------------

#: (row_start, n_new) of the kernel case at W = 4 chunks of 8: a decode row
#: from a mid-page start, a verify window across a page boundary, four
#: chunks from 0, four chunks from position 32, and an inactive row
KERNEL_ROWS = [(13, 1), (6, 3), (0, 32), (32, 32), (0, 0)]
KERNEL_W = 32


def _kernel_case(fmt, block_size, *, d=16, g=2, kvh=2, ps=8, window=None,
                 softcap=None, seed=7):
    """Numpy inputs of one ragged step over KERNEL_ROWS (bf16-exact q/k/v,
    pools of quantized normal values, the trash page last)."""
    rng = np.random.default_rng(seed)
    w = KERNEL_W
    r = len(KERNEL_ROWS)
    pages = [-(-(s + n) // ps) if n else 0 for s, n in KERNEL_ROWS]
    npages = sum(pages) + 2
    pmax = max(pages) + 1
    perm = rng.permutation(npages - 1)
    table = np.full((r, pmax), -1, np.int32)
    off = 0
    for i, n in enumerate(pages):
        table[i, :n] = perm[off:off + n]
        off += n

    def pool():
        qx = quantize(torch.from_numpy(rng.normal(
            size=(npages * ps * kvh, d)).astype(np.float32)), fmt, block_size)
        return (qx.elements.view(torch.uint8).numpy().reshape(
                    npages, ps, kvh, -1).copy(),
                qx.scales.numpy().reshape(npages, ps, kvh, -1).copy())

    def bf16(shape):
        x = rng.normal(size=shape).astype(np.float32)
        return np.asarray(torch.from_numpy(x).bfloat16().float())

    ke, ks = pool()
    ve, vs = pool()
    return dict(q=bf16((r, kvh, w, g, d)), k_new=bf16((r, w, kvh, d)),
                v_new=bf16((r, w, kvh, d)), ke=ke, ks=ks, ve=ve, vs=vs,
                table=table,
                starts=np.asarray([s for s, _ in KERNEL_ROWS], np.int32),
                lens=np.asarray([s + max(n, 1) for s, n in KERNEL_ROWS],
                                np.int32),
                fmt=fmt, block_size=block_size, window=window,
                softcap=softcap)


FP8_VIEWS = {"fp8_e4m3": torch.float8_e4m3fn, "fp8_e5m2": torch.float8_e5m2}


def _run_port(c, device="cpu", **kw):
    def t(x, dtype=None):
        x = torch.from_numpy(np.array(x)).to(device)
        return x if dtype is None else x.to(dtype)

    pools = [t(c["ke"]), t(c["ks"]), t(c["ve"]), t(c["vs"])]
    if c["fmt"] in FP8_VIEWS:
        pools[0], pools[2] = (p.view(FP8_VIEWS[c["fmt"]])
                              for p in (pools[0], pools[2]))
    out, pools, visits = tk.mx_attention_ragged_fused(
        t(c["q"], torch.bfloat16), t(c["k_new"], torch.bfloat16),
        t(c["v_new"], torch.bfloat16), *pools, t(c["table"]),
        t(c["starts"]), t(c["lens"]), fmt_name=c["fmt"],
        block_size=c["block_size"], window=c["window"],
        softcap=c["softcap"], debug_visits=True, **kw)
    return (out.cpu().numpy(), [p.view(torch.uint8).cpu().numpy()
                                for p in pools], visits.cpu().numpy())


def _run_reference(c):
    jnp = _jax().numpy
    from repro.kernels import mx_attention_ragged_fused

    ke, ve = jnp.asarray(c["ke"]), jnp.asarray(c["ve"])
    if c["fmt"] in FP8_VIEWS:
        view = {"fp8_e4m3": jnp.float8_e4m3fn,
                "fp8_e5m2": jnp.float8_e5m2}[c["fmt"]]
        ke, ve = (a.view(view) for a in (ke, ve))
    out, pools, visits = mx_attention_ragged_fused(
        jnp.asarray(c["q"]), jnp.asarray(c["k_new"]), jnp.asarray(c["v_new"]),
        ke, jnp.asarray(c["ks"]), ve, jnp.asarray(c["vs"]),
        jnp.asarray(c["table"]), jnp.asarray(c["starts"]),
        jnp.asarray(c["lens"]), fmt_name=c["fmt"],
        block_size=c["block_size"], window=c["window"],
        softcap=c["softcap"], debug_visits=True)
    return (np.asarray(out), [np.asarray(p).view(np.uint8) for p in pools],
            np.asarray(visits))


@pytest.mark.parametrize("fmt,block_size,window,softcap", [
    ("fp8_e4m3", 16, None, None), ("fp8_e5m2", 16, 12, 5.0),
    ("fp4_e2m1", 8, None, 5.0)])
def test_plain_ragged_at_four_chunks_matches_reference_kernel(
        fmt, block_size, window, softcap):
    case = _kernel_case(fmt, block_size, window=window, softcap=softcap)
    want_out, want_pools, want_visits = _run_reference(case)
    out, pools, visits = _run_port(case)
    for name, got, want in zip(("ke", "ks", "ve", "vs"), pools, want_pools):
        np.testing.assert_array_equal(got, want, err_msg=name)
    np.testing.assert_array_equal(visits, want_visits)
    assert not np.array_equal(pools[0], case["ke"])  # the window was written
    np.testing.assert_allclose(out, want_out, rtol=0, atol=OUT_TOL)


def test_tile_tokens_is_checked_and_leaves_the_plain_version_alone():
    """On the CPU the plain version runs whatever the tile; a tile that is
    not a positive int raises."""
    case = _kernel_case("fp8_e4m3", 16)
    out, pools, visits = _run_port(case)
    out16, pools16, visits16 = _run_port(case, tile_tokens=16)
    np.testing.assert_array_equal(out16, out)
    np.testing.assert_array_equal(visits16, visits)
    for a, b in zip(pools16, pools):
        np.testing.assert_array_equal(a, b)
    for bad in (0, -16, 16.0, True):
        with pytest.raises(ValueError):
            _run_port(case, tile_tokens=bad)


# ---------------------------------------------------------------------------
# the query tile of the CUDA cell (host side, runs here)
# ---------------------------------------------------------------------------


def _walk_smem(t, g, d, ps):
    """csrc/mx_attention_walk.cuh's smem_bytes(t * g, d, ps): the library
    function the wrapper asks on the card, written out."""
    rows = t * g
    blocks = (rows + 15) // 16
    ds = 1
    while 2 * ds * blocks <= 16 and (d // 16) % (2 * ds) == 0:
        ds *= 2
    kp, rp = -(-ps // 16) * 16, -(-rows // 16) * 16
    return (kp + rp) * (d + 8) * 2 + (kp + rp) * d * 4 + blocks * ds * 128


def _megakernel_smem(t, g, d, ps):
    """csrc/mx_megakernel.cu's smem_for: the walk's part or the product
    ring's (4 stages of 48 KB and the gate exchange), whichever is larger,
    past the alignment slack and the stages' barriers."""
    return 2048 + max(_walk_smem(t, g, d, ps), 4 * 49152 + 32768)


#: (W, G, D) -> tokens a tile: the one-chunk step fits whole; four chunks
#: (W 256) take the largest multiple of 16 that fits 232,448 bytes
TILES = {(64, 4, 128): 64, (256, 4, 128): 64,  # granite-8b
         (64, 2, 256): 64, (256, 2, 256): 64,  # gemma2-9b
         (64, 3, 128): 64, (256, 3, 128): 80,  # phi4-mini
         (128, 4, 128): 64, (5, 4, 128): 5, (72, 2, 256): 64}


@pytest.mark.parametrize("shape", sorted(TILES))
def test_query_tile_fits_a_block(shape):
    w, g, d = shape
    t = tk.query_tile(w, g, d, 16, _walk_smem)
    assert t == TILES[shape]
    assert _walk_smem(t, g, d, 16) <= 232448
    assert t == w or (t % 16 == 0
                      and _walk_smem(t + 16, g, d, 16) > 232448)
    # the megakernel's walk shares a block with the product ring: the
    # same tiles fit there at these shapes
    assert tk.query_tile(w, g, d, 16, _megakernel_smem) == t


def test_query_tile_raises_when_no_tile_fits():
    with pytest.raises(NotImplementedError):
        tk.query_tile(256, 64, 256, 16, _walk_smem)


def test_megakernel_plan_at_four_chunks():
    """At 2,048 activation rows (granite-8b, 8 rows of four 64-token
    chunks) every phase takes 256-row tiles, and the phase B scratch of
    the RoPE'd queries is sized by R * W rows."""
    plan = tmk.megakernel_plan(2048, 4096, 4096, 1024, 14336, 132)
    got = {k: (v["rows"], v["tiles"]) for k, v in plan.items()}
    assert got == {"qkv": (256, 384), "wo": (256, 256),
                   "gate_up": (256, 1792), "down": (256, 256)}
    scratch = tmk._scratch_for("cpu", 2048, 64, 64, 32, 128)
    assert [tuple(t.shape) for t in scratch] == [
        (2048, 64), (2048, 64), (2048, 32), (2048, 32), (2048, 64),
        (2048, 64), (2048, 64), (2048, 128)]
    tmk._scratch.clear()


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------


def test_launcher_prefill_max_chunks_on_cpu():
    """``--prefill-max-chunks 4`` on reduced granite: the flag reaches the
    ServeConfig, the ragged width is four chunks, and a 200-token prompt
    beside a short one (two requests, four slots) streams the same
    tokens in fewer prefill dispatches than at one chunk."""
    from repro_torch.launch import serve

    assert "--prefill-max-chunks" not in serve.UNPORTED_FLAGS
    assert "--mesh" in serve.UNPORTED_FLAGS
    argv = ["--arch", "granite-8b", "--reduced", "--batch", "2",
            "--max-slots", "4", "--prompt-len", "200", "--ragged",
            "--new-tokens", "4", "--prefill-chunk", "32", "--device", "cpu"]
    args = serve.parse_args(argv + ["--prefill-max-chunks", "4"])
    assert args.prefill_max_chunks == 4
    _, eng = serve.build_engine(args)
    assert eng.serve_cfg.prefill_max_chunks == 4
    assert eng.scheduler.prefill_max_chunks == 4
    assert eng._width == 128
    reports = {n: serve.main(argv + ["--prefill-max-chunks", str(n)])
               for n in (1, 4)}
    for i in reports[1]["ids"]:
        np.testing.assert_array_equal(reports[4]["results"][i],
                                      reports[1]["results"][i])
    assert reports[4]["prefill_dispatches"] < reports[1]["prefill_dispatches"]
    assert reports[4]["prefill_rows_per_step"] \
        > reports[1]["prefill_rows_per_step"]
    assert reports[4]["generated_tokens"] == 8
