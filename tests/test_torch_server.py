"""The port's serving front end against the reference's, on the CPU:
cancel in every state, prefix-cache snapshots, the HTTP/SSE server and
the launcher's server flags.

Both engines serve the reference's test model (``tests/test_server.py``:
d_model 64, one attention block, 4 heads of 16 over 2 KV heads, vocab
128, MXFP8 weights, an MX fp8 KV cache, block 16) with the same weights
(``model.params_from_jax``). Each cancel case runs one script of submits,
steps and cancels on both and requires equal cancellation counts, pages
in use, prefix trees (``export_state``, page ids included) and surviving
streams; after the drain the pool holds just the tree's pages and every
slot is free. Snapshots round-trip bit for bit within the port in every
step mode, tiered too, and pass between the two packages both ways in
the reference's file layout. The HTTP cases run a ``ServeHTTPServer`` on
an ephemeral port inside ``asyncio.run``. The reference is imported by a
fixture, so the file collects where JAX is not installed.
"""
import asyncio
import json
import logging
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import MXFP4, MXFP8  # noqa: E402
from repro_torch.launch import serve as tlaunch  # noqa: E402
from repro_torch.nn import BlockDef, ModelConfig  # noqa: E402
from repro_torch.nn import model as tmodel  # noqa: E402
from repro_torch.serve import (AsyncServeEngine,  # noqa: E402
                               ContinuousBatchingEngine, DrainingError,
                               ServeConfig, ServeHTTPServer, ShedError,
                               TierPolicy, kv_cache)
from repro_torch.serve.server import sse_generate  # noqa: E402

SEED = 0
TIERS = dict(hot_steps=1, cold_steps=2, repack_pages_per_step=8)
QUANTS = {"fp8": (MXFP8, True), "fp4": (MXFP4, True), "wide": (MXFP8, False)}


def _cfg(quant, quantize_kv=True):
    return ModelConfig(
        name="t", family="dense", d_model=64, vocab_size=128,
        pattern=(BlockDef("attn"),), num_groups=1, num_heads=4,
        num_kv_heads=2, head_dim=16, d_ff=128,
        quant=quant.replace(block_size=16, quantize_acts=False,
                            quantize_kv_cache=quantize_kv))


@pytest.fixture(scope="module")
def R():
    """The reference's modules, and both packages' models for each pool
    kind (fp8, packed fp4, wide bf16) on the same weights."""
    jax = pytest.importorskip("jax")
    from repro import core as jcore
    from repro.nn import BlockDef as JBlockDef
    from repro.nn import ModelConfig as JModelConfig
    from repro.nn import model as jmodel
    from repro.serve import (ContinuousBatchingEngine as JEngine,
                             ServeConfig as JServeConfig,
                             TierPolicy as JTierPolicy)

    models = {}
    for kind, (tquant, kv) in QUANTS.items():
        jquant = {"fp8": jcore.MXFP8, "fp4": jcore.MXFP4,
                  "wide": jcore.MXFP8}[kind]
        jcfg = JModelConfig(
            name="t", family="dense", d_model=64, vocab_size=128,
            pattern=(JBlockDef("attn"),), num_groups=1, num_heads=4,
            num_kv_heads=2, head_dim=16, d_ff=128,
            quant=jquant.replace(block_size=16, quantize_acts=False,
                                 quantize_kv_cache=kv))
        tcfg = _cfg(tquant, kv)
        jparams, _ = jmodel.init(jax.random.PRNGKey(SEED), jcfg)
        tparams = tmodel.params_from_jax(
            jax.tree_util.tree_map(np.asarray, jparams), tcfg, "cpu")
        models[kind] = (jcfg, jparams, tcfg, tparams)

    def engines(kind="fp8", **kw):
        jcfg, jparams, tcfg, tparams = models[kind]
        jkw, tkw = dict(kw), dict(kw)
        if kw.get("tiered"):
            jkw["tier_policy"] = JTierPolicy(**TIERS)
            tkw["tier_policy"] = TierPolicy(**TIERS)
        return (JEngine(jparams, jcfg, JServeConfig(**jkw)),
                ContinuousBatchingEngine(tparams, tcfg, ServeConfig(**tkw),
                                         device="cpu"))

    return SimpleNamespace(jax=jax, engines=engines, models=models)


def _port(R, kind="fp8", **kw):
    _, _, tcfg, tparams = R.models[kind]
    if kw.get("tiered"):
        kw["tier_policy"] = TierPolicy(**TIERS)
    return ContinuousBatchingEngine(tparams, tcfg, ServeConfig(**kw),
                                    device="cpu")


def _tree_pages(eng):
    return len(eng.scheduler.prefix.export_state()["nodes"])


# ---------------------------------------------------------------------------
# cancel in every state, against the reference
# ---------------------------------------------------------------------------


def _step_until(eng, done, limit=400):
    for n in range(limit):
        if done(eng):
            return n
        eng.step()
    raise AssertionError("the scenario never reached its state")


def _script_queued(eng):
    p = np.arange(1, 5, dtype=np.int32)
    log = [eng.cancel(99)]
    ids = [eng.submit(p + i, 3) for i in range(3)]
    log.append(eng.cancel(ids[1]))
    eng.step()
    return log


def _script_mid_prefill(eng):
    long_prompt = np.arange(1, 33, dtype=np.int32)  # 8 chunks of 4
    rid = eng.submit(long_prompt, 4)
    eng.submit(np.arange(40, 46, dtype=np.int32), 5)
    eng.step()
    eng.step()
    seq = next(s for s in eng.scheduler.slots
               if s is not None and s.req.id == rid)
    assert seq.prefill_pos is not None, "still prefilling"
    log = [eng.cancel(rid)]
    eng.submit(long_prompt[:12].copy(), 4)
    return log


def _script_decoding(eng):
    head = np.arange(1, 9, dtype=np.int32)
    r1 = eng.submit(np.concatenate([head, [50, 51]]).astype(np.int32), 20)
    r2 = eng.submit(np.concatenate([head, [60]]).astype(np.int32), 20)
    n = _step_until(eng, lambda e: sum(
        len(s.req.generated) >= 3 for s in e.scheduler.slots
        if s is not None) == 2)
    log = [n, eng.cancel(r1)]
    eng.step()
    log.append(eng.cancel(r2))
    eng.submit(np.concatenate([head, [70, 71, 72]]).astype(np.int32), 6)
    return log


def _swap_reqs():
    rng = np.random.default_rng(3)
    return [(rng.integers(0, 128, (s,)).astype(np.int32), m)
            for s, m in [(4, 14), (4, 14), (7, 5), (3, 8)]]


def _script_swapped(eng):
    for p, m in _swap_reqs():
        eng.submit(p, m)
    n = _step_until(eng, lambda e: any(r.swap is not None
                                       for r in e.scheduler.queue))
    swapped = next(r for r in eng.scheduler.queue if r.swap is not None)
    return [n, swapped.id, eng.cancel(swapped.id)]


def _script_verify(eng):
    p = np.arange(1, 7, dtype=np.int32)
    r1 = eng.submit(p, 12)
    eng.submit(p[::-1].copy(), 12)
    n = _step_until(eng, lambda e: e.spec_steps >= 1)
    return [n, eng.cancel(r1)]


SWAP_POOL = dict(max_seq=20, max_slots=2, page_size=4, num_pages=7)
CANCEL_CASES = {
    "queued": (dict(max_seq=24, max_slots=2, page_size=4), _script_queued),
    "mid_prefill": (dict(max_seq=64, max_slots=2, page_size=4,
                         prefill_chunk=4, prefill_token_budget=4),
                    _script_mid_prefill),
    "mid_prefill_split": (dict(max_seq=64, max_slots=2, page_size=4,
                               prefill_chunk=4, prefill_token_budget=4,
                               step_mode="split"), _script_mid_prefill),
    "decoding": (dict(max_seq=40, max_slots=2, page_size=4),
                 _script_decoding),
    "swapped": (SWAP_POOL, _script_swapped),
    "verify": (dict(max_seq=32, max_slots=2, page_size=8, spec_decode=True,
                    num_draft_tokens=3), _script_verify),
    "tiered_swapped": (dict(SWAP_POOL, num_pages=4, tiered=True),
                       _script_swapped),
    "megakernel_decoding": (dict(max_seq=40, max_slots=2, page_size=4,
                                 step_mode="megakernel"), _script_decoding),
}


def _accounting(eng):
    sched = eng.scheduler
    return (sched.cancellations, sched.pool.pages_in_use,
            sched.prefix.export_state())


@pytest.mark.parametrize("case", sorted(CANCEL_CASES))
def test_cancel_matches_reference(R, case):
    serve, script = CANCEL_CASES[case]
    jeng, teng = R.engines(**serve)
    assert script(teng) == script(jeng)
    assert teng.scheduler.cancellations >= 1
    assert _accounting(teng) == _accounting(jeng)
    got, want = teng.run(), jeng.run()
    assert sorted(got) == sorted(want)
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid])
    assert _accounting(teng) == _accounting(jeng)
    assert teng.scheduler.pool.pages_in_use == _tree_pages(teng)
    assert all(s is None for s in teng.scheduler.slots)
    assert not teng.scheduler.has_work
    stats = teng.cache_stats()
    assert stats["cancellations"] == teng.scheduler.cancellations
    assert stats["shed_count"] == 0
    if serve.get("tiered"):
        assert not teng._swap_fmts
        tree = [n["page"] for n in teng.scheduler.prefix.export_state()
                ["nodes"]]
        assert [int(teng.page_fmts[p]) for p in tree] == \
            [int(jeng.page_fmts[p]) for p in tree]
    if serve.get("step_mode") == "megakernel":
        assert teng.megakernel


def test_admission_latency_stats_and_shed(R):
    """``cache_stats`` carries the reference's admission-latency keys and
    the shed count; a shed request costs nothing and the admitted one
    still completes."""
    _, teng = R.engines(max_seq=24, max_slots=2, page_size=4, max_queue=1)
    p = np.arange(1, 5, dtype=np.int32)
    teng.submit(p, 2)
    with pytest.raises(ShedError):
        teng.submit(p, 2)
    out = teng.run()
    stats = teng.cache_stats()
    assert stats["shed_count"] == 1 and len(out) == 1
    assert len(teng.admission_latencies) == 1
    lat = teng.admission_latencies[0]
    assert stats["admission_latency_p50"] == stats["admission_latency_p95"] \
        == stats["admission_latency_mean"] == lat > 0
    assert teng.overload.stats()["ewma_admission_latency_s"] == lat


# ---------------------------------------------------------------------------
# prefix-cache snapshots
# ---------------------------------------------------------------------------

HEAD = np.arange(1, 13, dtype=np.int32)  # 3 full pages at page size 4
SNAP = dict(max_seq=32, max_slots=2, page_size=4)


def _fill(eng, new=6):
    """Serve two prompts sharing HEAD's first two pages; returns the first
    one's stream."""
    r1 = eng.submit(HEAD, new)
    eng.submit(np.concatenate([HEAD[:8], np.arange(50, 58)]).astype(np.int32),
               new)
    return eng.run()[r1]


def _warm(eng, new=6):
    rid = eng.submit(HEAD, new)
    return eng.run()[rid]


def _tree_bytes(eng):
    """(structure without page ids, the tree pages' bytes by leaf)."""
    state = eng.scheduler.prefix.export_state()
    pids = [n["page"] for n in state["nodes"]]
    layout = tmodel.reference_cache_leaves(eng.cfg, eng.cache)
    leaves = kv_cache.extract_leaves(eng.cache, layout, torch.as_tensor(pids))
    strip = [{k: v for k, v in n.items() if k != "page"}
             for n in state["nodes"]]
    return strip, [leaf.numpy().tobytes() for leaf in leaves], pids


@pytest.mark.parametrize("mode", ["ragged", "split", "megakernel"])
def test_snapshot_roundtrip_bit_identical(R, tmp_path, mode):
    e1 = _port(R, step_mode=mode, **SNAP)
    cold = _fill(e1)
    path = tmp_path / "prefix.npz"
    n_pages = e1.save_prefix_cache(path)
    assert n_pages == _tree_pages(e1) > 0
    e2 = _port(R, step_mode=mode, **SNAP)
    assert e2.load_prefix_cache(path) == e1.scheduler.prefix.num_nodes
    s1, b1, _ = _tree_bytes(e1)
    s2, b2, pids2 = _tree_bytes(e2)
    assert s1 == s2 and b1 == b2
    assert e2.scheduler.pool.pages_in_use == len(pids2)
    np.testing.assert_array_equal(_warm(e2), cold)
    assert e2.cache_stats()["prefix_hit_rate"] > 0


def test_snapshot_roundtrip_tiered_formats(R, tmp_path):
    """Page formats survive; the warm hit over the demoted pages equals
    the saving engine's own warm hit (the cold run decoded over those
    pages while they were still fp8; ROADMAP C)."""
    kw = dict(SNAP, tiered=True)
    e1 = _port(R, **kw)
    _fill(e1, new=8)
    path = tmp_path / "tiered.npz"
    assert e1.save_prefix_cache(path) > 0
    e2 = _port(R, **kw)
    e2.load_prefix_cache(path)
    s1, b1, p1 = _tree_bytes(e1)
    s2, b2, p2 = _tree_bytes(e2)
    assert s1 == s2 and b1 == b2
    fmts1 = [int(e1.page_fmts[p]) for p in p1]
    assert fmts1 == [int(e2.page_fmts[p]) for p in p2]
    assert any(f != e1._base_fmt_id for f in fmts1), \
        "the policy must demote some page below the base format"
    assert e2.scheduler.pool.units_in_use == e1.scheduler.pool.units_in_use
    np.testing.assert_array_equal(_warm(e2, 8), _warm(e1, 8))


@pytest.mark.parametrize("save_mode,load_mode",
                         [("ragged", "split"), ("split", "ragged")])
def test_snapshot_across_step_modes(R, tmp_path, save_mode, load_mode):
    """The ragged pool's trash page never enters a snapshot, which is
    addressed by listed page, so it loads into the other step mode."""
    e1 = _port(R, step_mode=save_mode, **SNAP)
    assert e1._trash_pages == (save_mode == "ragged")
    cold = _fill(e1)
    path = tmp_path / "xmode.npz"
    e1.save_prefix_cache(path)
    e2 = _port(R, step_mode=load_mode, **SNAP)
    assert e2.load_prefix_cache(path) > 0
    s1, b1, _ = _tree_bytes(e1)
    s2, b2, pids2 = _tree_bytes(e2)
    assert s1 == s2 and b1 == b2
    assert all(p < e2.num_pages for p in pids2)
    np.testing.assert_array_equal(_warm(e2), cold)


def test_snapshot_rejects_mismatched_geometry(R, tmp_path):
    e1 = _port(R, **SNAP)
    _fill(e1, new=4)
    path = tmp_path / "prefix.npz"
    e1.save_prefix_cache(path)
    for other in (dict(SNAP, page_size=8), dict(SNAP, tiered=True)):
        e2 = _port(R, **other)
        with pytest.raises(ValueError, match="snapshot leaf 0"):
            e2.load_prefix_cache(path)
        assert e2.scheduler.pool.pages_in_use == 0  # nothing was taken
    e3 = _port(R, **SNAP)
    _fill(e3, new=4)
    with pytest.raises(RuntimeError, match="empty prefix cache"):
        e3.load_prefix_cache(path)


def test_snapshot_refuses_partial_entries(R, tmp_path):
    """Partial-page entries load with the pages the snapshot carries
    (tests/test_torch_monolithic.py round-trips them); an entry on a page
    the snapshot does not carry is refused before any page is taken."""
    e1 = _port(R, **SNAP)
    _fill(e1, new=4)
    path = tmp_path / "prefix.npz"
    e1.save_prefix_cache(path)
    with np.load(path) as data:
        payload = dict(data)
    state = json.loads(bytes(payload["structure"]).decode())
    state["partials"] = [{"node": 0, "tail": [1, 2],
                          "page": int(payload["page_ids"].max()) + 1,
                          "last_use": 1}]
    payload["structure"] = np.frombuffer(json.dumps(state).encode(),
                                         np.uint8)
    np.savez(tmp_path / "partial.npz", **payload)
    e2 = _port(R, **SNAP)
    with pytest.raises(ValueError, match="does not carry"):
        e2.load_prefix_cache(tmp_path / "partial.npz")
    assert e2.scheduler.pool.pages_in_use == 0


@pytest.mark.parametrize("kind,tiered", [("fp8", False), ("fp4", False),
                                         ("fp8", True), ("wide", False)])
def test_snapshot_file_equals_the_reference(R, tmp_path, kind, tiered):
    """Both packages save the same file for the same workload: leaf
    order, dtype names, shapes, bytes, structure and page formats."""
    kw = dict(SNAP, tiered=tiered)
    jeng, teng = R.engines(kind, **kw)
    np.testing.assert_array_equal(_fill(teng), _fill(jeng))
    jeng.save_prefix_cache(tmp_path / "ref.npz")
    teng.save_prefix_cache(tmp_path / "port.npz")
    with np.load(tmp_path / "ref.npz") as want, \
            np.load(tmp_path / "port.npz") as got:
        assert sorted(got.files) == sorted(want.files)
        n_leaves = sum(f.endswith("_bytes") for f in want.files)
        assert n_leaves == (2 if kind == "wide" else 4)
        for name in got.files:
            np.testing.assert_array_equal(got[name], want[name], err_msg=name)
        assert str(got["leaf_0_dtype"]) == {
            "fp8": "uint8" if tiered else "float8_e4m3fn", "fp4": "uint8",
            "wide": "bfloat16"}[kind]


def test_reference_snapshot_loads_into_the_port(R, tmp_path):
    jsave, _ = R.engines(**SNAP)
    _fill(jsave)
    jsave.save_prefix_cache(tmp_path / "ref.npz")
    jload, tload = R.engines(**SNAP)
    jload.load_prefix_cache(tmp_path / "ref.npz")
    tload.load_prefix_cache(tmp_path / "ref.npz")
    assert tload.scheduler.prefix.export_state() == \
        jload.scheduler.prefix.export_state()
    np.testing.assert_array_equal(_warm(tload), _warm(jload))


def test_port_snapshot_loads_into_the_reference(R, tmp_path):
    jnp = R.jax.numpy
    _, tsave = R.engines(**SNAP)
    _fill(tsave)
    tsave.save_prefix_cache(tmp_path / "port.npz")
    jload, tload = R.engines(**SNAP)
    jload.load_prefix_cache(tmp_path / "port.npz")
    tload.load_prefix_cache(tmp_path / "port.npz")
    _, port_bytes, pids = _tree_bytes(tload)
    snap = jload._extract(jload.cache, jnp.asarray(0, jnp.int32),
                          jnp.asarray(pids, jnp.int32))
    ref_bytes = [np.asarray(leaf).tobytes()
                 for leaf in R.jax.tree_util.tree_leaves(snap)]
    assert ref_bytes == port_bytes
    np.testing.assert_array_equal(_warm(jload), _warm(tload))


# ---------------------------------------------------------------------------
# HTTP/SSE
# ---------------------------------------------------------------------------


async def _http(port, method, path, body=None):
    """One plain request: (status line, headers, JSON body)."""
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    data = body if isinstance(body, bytes) else json.dumps(body or {}).encode()
    writer.write((f"{method} {path} HTTP/1.1\r\nHost: x\r\n"
                  f"Content-Length: {len(data)}\r\n\r\n").encode() + data)
    await writer.drain()
    status = (await reader.readline()).decode()
    headers = {}
    while True:
        line = await reader.readline()
        if line in (b"\r\n", b"\n", b""):
            break
        name, _, value = line.decode().partition(":")
        headers[name.strip().lower()] = value.strip()
    length = int(headers.get("content-length", 0))
    payload = json.loads(await reader.readexactly(length)) if length else {}
    writer.close()
    await writer.wait_closed()
    return status, headers, payload


async def _collect(port, payload):
    tokens, events = [], []
    async for event in sse_generate("127.0.0.1", port, payload):
        events.append(event)
        if "token" in event:
            tokens.append(event["token"])
    return tokens, events


def _serve(eng, client):
    """Run ``client(server, async_engine)`` against a server over ``eng``
    on an ephemeral port; returns its result."""
    async def go():
        aeng = AsyncServeEngine(eng)
        srv = ServeHTTPServer(aeng, port=0)
        await srv.start()
        try:
            return await client(srv, aeng)
        finally:
            await srv.stop()

    return asyncio.run(go())


def test_sse_streams_equal_the_reference_direct_run(R):
    prompt = list(range(1, 9))
    kw = dict(max_slots=4, max_seq=32, page_size=8)
    jeng, teng = R.engines(**kw)

    async def client(srv, aeng):
        results = await asyncio.gather(
            _collect(srv.port, {"prompt": prompt, "max_new_tokens": 6}),
            _collect(srv.port, {"prompt": prompt, "max_new_tokens": 6,
                                "temperature": 0.8, "seed": 5}),
            _collect(srv.port, {"prompt": prompt, "max_new_tokens": 6,
                                "temperature": 0.8, "seed": 5}))
        health = await _http(srv.port, "GET", "/v1/health")
        return results, health

    ((greedy, events), (s1, _), (s2, _)), health = _serve(teng, client)
    rid = jeng.submit(np.asarray(prompt, np.int32), 6)
    direct = jeng.run()[rid]
    assert greedy == list(direct[len(prompt):])
    assert events[0] == {"request_id": events[-1]["request_id"]}
    assert [e["index"] for e in events[1:-1]] == list(range(6))
    assert events[-1]["done"] and events[-1]["tokens"] == greedy
    assert s1 == s2 and len(s1) == 6
    status, _, stats = health
    assert "200" in status
    assert stats["queue_depth"] == 0 and stats["draining"] is False
    assert stats["admitted_count"] == 3
    assert teng.scheduler.finished == []  # cleared after every step


def test_sse_tokens_trail_their_step_by_a_bounded_lag(R):
    """Each token reaches its client a fixed few loop turns after the
    step that sampled it, however long the stream: a stream takes every
    token queued for it at a wake-up (one token a wake-up fell a step
    further behind every few steps, so the last tokens came long after
    their steps)."""
    teng = _port(R, max_slots=2, max_seq=64, page_size=8)
    steps, recorded, lags = [0], {}, []
    step = teng.step

    def counted_step():
        steps[0] += 1
        return step()

    teng.step = counted_step

    async def client(srv, aeng):
        deliver = teng.scheduler.on_token

        def stamped(req, token, finished):
            recorded.setdefault(req.id, []).append(steps[0])
            deliver(req, token, finished)

        teng.scheduler.on_token = stamped
        async for event in sse_generate("127.0.0.1", srv.port, {
                "prompt": list(range(1, 9)), "max_new_tokens": 40}):
            if "token" in event:
                lags.append(steps[0]
                            - recorded[event_id[0]][event["index"]])
            elif "request_id" in event:
                event_id = [event["request_id"]]

    _serve(teng, client)
    assert len(lags) == 40
    assert max(lags) <= 4, lags


def test_async_engine_token_batches_without_http(R):
    """``AsyncServeEngine.token_batches`` yields (token, finished) batches
    up to the finishing token, equal to a direct run; a cancel ends a
    stream."""
    teng = _port(R, max_slots=2, max_seq=32, page_size=8)
    prompt = np.arange(1, 9, dtype=np.int32)

    async def go():
        aeng = AsyncServeEngine(teng)
        whole, cut = aeng.submit(prompt, 6), aeng.submit(prompt[::-1], 20)

        async def consume(rid, cancel_at=None):
            items = []
            async for batch in aeng.token_batches(rid):
                assert batch
                items.extend(batch)
                if cancel_at is not None and len(items) >= cancel_at:
                    assert aeng.cancel(rid)
                    cancel_at = None
            return items

        got, rest = await asyncio.gather(consume(whole), consume(cut, 2))
        await aeng.drain()
        return got, rest

    got, rest = asyncio.run(go())
    direct = _port(R, max_slots=2, max_seq=32, page_size=8)
    rid = direct.submit(prompt, 6)
    want = direct.run()[rid][len(prompt):].tolist()
    assert got == [(t, i == 5) for i, t in enumerate(want)]
    assert 2 <= len(rest) < 20 and not any(f for _, f in rest)
    assert teng.scheduler.cancellations == 1


def test_sse_hangup_cancels_and_frees(R):
    teng = _port(R, max_slots=2, max_seq=64, page_size=8)

    async def client(srv, aeng):
        body = json.dumps({"prompt": list(range(1, 9)),
                           "max_new_tokens": 50}).encode()
        reader, writer = await asyncio.open_connection("127.0.0.1", srv.port)
        writer.write((f"POST /v1/generate HTTP/1.1\r\nHost: x\r\n"
                      f"Content-Length: {len(body)}\r\n\r\n").encode() + body)
        await writer.drain()
        for _ in range(8):  # status, headers, the id and a few tokens
            await reader.readline()
        writer.close()
        await writer.wait_closed()
        await aeng.drain()  # reaches idle without decoding 50 tokens

    _serve(teng, client)
    sched = teng.scheduler
    assert sched.cancellations == 1
    assert all(s is None for s in sched.slots)
    assert sched.pool.pages_in_use == _tree_pages(teng)
    assert teng.steps < 50


def test_sse_half_close_cancels_by_eof(R):
    """A client that shuts its sending side and keeps reading: writes
    still succeed, so only the EOF on the request socket can find it."""
    teng = _port(R, max_slots=2, max_seq=64, page_size=8)

    async def client(srv, aeng):
        body = json.dumps({"prompt": list(range(1, 9)),
                           "max_new_tokens": 50}).encode()
        reader, writer = await asyncio.open_connection("127.0.0.1", srv.port)
        writer.write((f"POST /v1/generate HTTP/1.1\r\nHost: x\r\n"
                      f"Content-Length: {len(body)}\r\n\r\n").encode() + body)
        await writer.drain()
        while b"token" not in await reader.readline():
            pass
        writer.write_eof()
        rest = await reader.read()  # the server ends the response
        writer.close()
        await writer.wait_closed()
        await aeng.drain()
        return rest

    rest = _serve(teng, client)
    assert b'"done"' not in rest
    assert teng.scheduler.cancellations == 1
    assert teng.scheduler.pool.pages_in_use == _tree_pages(teng)


class _FailingWriter:
    """A stream writer whose writes fail from the ``ok``-th on, as a
    socket's do once the peer has gone."""

    def __init__(self, ok: int):
        self.ok, self.writes = ok, []

    def write(self, data):
        if len(self.writes) >= self.ok:
            raise BrokenPipeError("peer gone")
        self.writes.append(data)

    async def drain(self):
        pass


class _SilentReader:
    """A request socket that neither sends nor closes."""

    async def read(self, n):
        await asyncio.get_running_loop().create_future()


def test_sse_failed_write_cancels(R):
    teng = _port(R, max_slots=2, max_seq=64, page_size=8)

    async def go():
        aeng = AsyncServeEngine(teng)
        srv = ServeHTTPServer(aeng, port=0)
        writer = _FailingWriter(ok=3)  # headers + id, then two tokens
        await srv._generate(_SilentReader(), writer, {
            "prompt": list(range(1, 9)), "max_new_tokens": 50})
        await aeng.drain()
        return writer.writes

    writes = asyncio.run(go())
    assert len(writes) == 3 and b'"token"' in writes[-1]
    assert teng.scheduler.cancellations == 1
    assert all(s is None for s in teng.scheduler.slots)
    assert teng.scheduler.pool.pages_in_use == _tree_pages(teng)


def test_failed_step_ends_the_streams_and_drain_raises(R):
    """A step that raises ends every open stream without its "done" event
    (no client waits on a dead engine) and comes out of ``drain``."""
    teng = _port(R, max_slots=2, max_seq=64, page_size=8)
    step, calls = teng.step, [0]

    def failing_step():
        calls[0] += 1
        if calls[0] == 4:
            raise RuntimeError("device fault")
        return step()

    teng.step = failing_step

    async def client(srv, aeng):
        got = await asyncio.gather(*(_collect(srv.port, {
            "prompt": list(range(1 + i, 9)), "max_new_tokens": 20})
            for i in range(2)))
        with pytest.raises(RuntimeError, match="device fault"):
            await aeng.drain()
        return got

    for tokens, events in _serve(teng, client):
        assert len(tokens) < 20 and not any(e.get("done") for e in events)


def test_cancel_route_ends_the_stream(R):
    teng = _port(R, max_slots=2, max_seq=64, page_size=8)

    async def client(srv, aeng):
        events, answers = [], []
        async for event in sse_generate("127.0.0.1", srv.port, {
                "prompt": list(range(1, 9)), "max_new_tokens": 50}):
            events.append(event)
            if len(events) == 3:  # the id and two tokens
                answers.append(await _http(srv.port, "POST", "/v1/cancel", {
                    "request_id": events[0]["request_id"]}))
        return events, answers

    events, [(status, _, body)] = _serve(teng, client)
    assert "200" in status and body == {"cancelled": True}
    assert events[-1] == {"done": True, "request_id": events[0]["request_id"],
                          "cancelled": True}
    assert teng.scheduler.cancellations == 1
    assert teng.scheduler.pool.pages_in_use == _tree_pages(teng)


def test_shed_429_drain_503_and_bad_requests(R):
    teng = _port(R, max_seq=24, max_slots=2, page_size=4, max_queue=0)

    async def client(srv, aeng):
        shed = await _http(srv.port, "POST", "/v1/generate",
                           {"prompt": [1, 2, 3], "max_new_tokens": 2})
        bad = [await _http(srv.port, "POST", "/v1/generate", b"{not json"),
               await _http(srv.port, "POST", "/v1/generate",
                           {"max_new_tokens": 2}),
               await _http(srv.port, "GET", "/v1/nowhere")]
        drained = await _http(srv.port, "POST", "/v1/drain")
        refused = await _http(srv.port, "POST", "/v1/generate",
                              {"prompt": [1, 2, 3], "max_new_tokens": 2})
        with pytest.raises(DrainingError):
            aeng.submit([1, 2, 3], 2)
        with pytest.raises(RuntimeError, match="503"):
            await _collect(srv.port, {"prompt": [1, 2, 3]})
        health = await _http(srv.port, "GET", "/v1/health")
        return shed, bad, drained, refused, health

    shed, bad, drained, refused, health = _serve(teng, client)
    status, headers, body = shed
    assert "429" in status and "queue full" in body["error"]
    assert float(headers["retry-after"]) >= \
        teng.overload.cfg.min_retry_after_s == 0.05
    assert ["400" in b[0] for b in bad] == [True, True, False]
    assert "404" in bad[2][0]
    assert drained[2] == {"drained": True}
    assert "503" in refused[0]
    assert health[2]["draining"] is True and health[2]["shed_count"] == 1


def test_max_queue_burst_sheds_the_rest_and_serves_the_admitted(R):
    """With both slots busy, eight concurrent submissions against
    max_queue 2: two queue, six shed with Retry-After >= 0.05, and every
    admitted stream completes."""
    teng = _port(R, max_seq=24, max_slots=2, page_size=4, max_queue=2)

    async def client(srv, aeng):
        busy = []
        for i in range(2):  # each in its slot before the next arrives
            busy.append(asyncio.ensure_future(_collect(srv.port, {
                "prompt": [90 + i, 2, 3], "max_new_tokens": 18})))
            while not teng.scheduler.slots[i]:
                await asyncio.sleep(0)

        async def one(i):
            try:
                return await _collect(srv.port, {
                    "prompt": [1 + i, 2, 3], "max_new_tokens": 3})
            except RuntimeError as e:
                return str(e)

        burst = await asyncio.gather(*(one(i) for i in range(8)))
        return burst, [await b for b in busy]

    burst, busy = _serve(teng, client)
    sheds = [r for r in burst if isinstance(r, str)]
    served = [r for r in burst if not isinstance(r, str)]
    assert len(sheds) == 6 == teng.cache_stats()["shed_count"]
    for shed in sheds:
        assert "429" in shed
        retry = float(shed.split("Retry-After: ")[1].split("\\r")[0])
        assert retry >= teng.overload.cfg.min_retry_after_s
    assert [len(tokens) for tokens, _ in served] == [3, 3]
    assert [len(tokens) for tokens, _ in busy] == [18, 18]


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

LAUNCH = ["--arch", "granite-8b", "--reduced", "--device", "cpu",
          "--batch", "2", "--prompt-len", "12", "--new-tokens", "4",
          "--page-size", "4", "--prefill-chunk", "8"]


def test_launcher_flags_reach_serve_config():
    for flag in ("--slo-ms", "--max-queue", "--serve", "--host", "--port",
                 "--prefix-snapshot"):
        assert flag not in tlaunch.UNPORTED_FLAGS
    assert "--mesh" in tlaunch.UNPORTED_FLAGS
    args = tlaunch.parse_args(LAUNCH + ["--slo-ms", "250", "--max-queue",
                                        "3", "--serve", "--port", "0"])
    _, eng = tlaunch.build_engine(args)
    assert (eng.serve_cfg.slo_ms, eng.serve_cfg.max_queue) == (250.0, 3)
    assert eng.overload.cfg.slo_ms == 250.0
    assert args.serve and args.port == 0 and args.host == "127.0.0.1"
    _, eng = tlaunch.build_engine(tlaunch.parse_args(LAUNCH))
    assert (eng.serve_cfg.slo_ms, eng.serve_cfg.max_queue) == (None, None)
    with pytest.raises(SystemExit):  # the front end needs --engine continuous
        tlaunch.parse_args(LAUNCH + ["--engine", "fixed", "--serve"])


def test_run_server_loads_and_writes_back_the_snapshot(tmp_path, caplog):
    path = tmp_path / "prefix.npz"
    args = tlaunch.parse_args(LAUNCH + ["--serve", "--port", "0",
                                        "--prefix-snapshot", str(path)])
    prompt = list(range(3, 15))

    def run():
        cfg, eng = tlaunch.build_engine(args)
        seen = {}

        async def until(server):
            seen["nodes_at_start"] = eng.scheduler.prefix.num_nodes
            seen["tokens"], _ = await _collect(server.port, {
                "prompt": prompt, "max_new_tokens": 4})
        tlaunch._run_server(eng, args, until=until)
        return eng, seen

    with caplog.at_level(logging.INFO, logger="repro_torch.serve"):
        eng1, first = run()
        assert path.exists() and first["nodes_at_start"] == 0
        saved = eng1.scheduler.prefix.num_nodes
        assert saved == len(prompt) // 4
        eng2, second = run()
    assert second["nodes_at_start"] == saved
    assert second["tokens"] == first["tokens"]
    assert eng2.cache_stats()["prefix_hit_tokens"] > 0
    assert any("warm-started prefix cache" in r.message
               for r in caplog.records)
