"""Reduced recurrentgemma-2b and mamba2-780m in the port against the
jitted reference on the CPU, the reference's weights carried over by
``model.params_from_jax``; and the engines' recurrent-mixer fallbacks.

Bars, each measured here:

  * dense prefill's logits and every cache leaf (K/V caches, RG-LRU and
    SSD states), then four one-token decode steps' logits and caches,
    equal the jitted reference bit for bit, for both reduced models and
    for reduced recurrentgemma cut to two groups plus its two trailing
    unscanned RG-LRU layers (full width's epilogue): XLA carries the
    residual sum unrounded from one unscanned layer into the next, and
    in decode from the last into the final norm
    (``model.layer_carries``), and contracts the RG-LRU update's other
    product in an unscanned layer (``rglru.apply_decode``'s
    ``scanned``);
  * ``ContinuousBatchingEngine`` and ``FixedSlotEngine`` streams equal
    the reference engines' token for token, and ``state_bytes`` equals
    the reference's (8,192 and 149,504 bytes over four slots);
  * a pool small enough to preempt recurrent sequences (swap-out, then
    readmission into another slot) gives the unpressured run's streams,
    which are the reference's; restoring pages without the state rows
    parts them (a control);
  * the engine's fallbacks are the reference's: the prefix cache off,
    chunked prefill to monolithic admission, the ragged step to the
    split dispatches, with its log lines; speculation raises
    ``NotImplementedError`` and tiering ``ValueError``, each with the
    reference's message, and so do the paged paths that need attention
    (the port's counterparts of ``tests/test_chunked_prefill.py:353``,
    ``tests/test_prefix_cache.py:389`` and ``tests/test_spec_decode.py
    :203``).
"""
import logging

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro import configs as jconfigs  # noqa: E402
from repro.nn import BlockDef as JBlockDef  # noqa: E402
from repro.nn import blocks as jblocks  # noqa: E402
from repro.nn import model as jmodel  # noqa: E402
from repro.serve import ContinuousBatchingEngine as JEngine  # noqa: E402
from repro.serve import FixedSlotEngine as JFixed  # noqa: E402
from repro.serve import ServeConfig as JServeConfig  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.launch import serve as tlaunch  # noqa: E402
from repro_torch.launch import train as tlaunch_train  # noqa: E402
from repro_torch.nn import BlockDef  # noqa: E402
from repro_torch.nn import blocks as tblocks  # noqa: E402
from repro_torch.nn import model as tmodel  # noqa: E402
from repro_torch.serve import (ContinuousBatchingEngine,  # noqa: E402
                               FixedSlotEngine, ServeConfig, kv_cache)

ARCHS = ("recurrentgemma-2b", "mamba2-780m")
NEW = 10
SERVE = dict(max_seq=32, max_slots=4, page_size=4)
#: the prompts: mamba2's prefill takes at most one chunk (8) or a multiple
LENS = {"recurrentgemma-2b": (5, 11, 3, 9, 14), "mamba2-780m": (8, 16, 5, 8, 3)}
PREEMPT_PAGES = 12  # four swap-outs at SERVE with these prompts


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _bytes(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        t = a.contiguous()
        return t.view(torch.uint8).numpy() if t.element_size() == 1 else \
            t.view({2: torch.int16, 4: torch.int32}[t.element_size()]
                   ).numpy().view(np.uint8)
    return np.ascontiguousarray(np.asarray(a)).view(np.uint8)


def _pair(arch: str, epilogue: bool = False):
    quant = dict(quantize_acts=False, quantize_kv_cache=True)
    jcfg = jconfigs.get_reduced(arch)
    tcfg = tconfigs.get_reduced(arch)
    jcfg = jcfg.replace(quant=jcfg.quant.replace(**quant))
    tcfg = tcfg.replace(quant=tcfg.quant.replace(**quant))
    if epilogue:
        jcfg = jcfg.replace(num_groups=2, epilogue=(JBlockDef("rglru"),) * 2)
        tcfg = tcfg.replace(num_groups=2, epilogue=(BlockDef("rglru"),) * 2)
    jparams, _ = jmodel.init(jax.random.PRNGKey(0), jcfg)
    jparams = jax.tree_util.tree_map(np.asarray, jparams)
    return jcfg, jparams, tcfg, tmodel.params_from_jax(jparams, tcfg, "cpu")


@pytest.fixture(scope="module", params=ARCHS)
def arch_pair(request):
    return (request.param, *_pair(request.param))


def _prompts(arch: str) -> list:
    rng = np.random.default_rng(2)
    return [rng.integers(0, 512, (n,)).astype(np.int32) for n in LENS[arch]]


@pytest.mark.parametrize("arch,epilogue", [("recurrentgemma-2b", False),
                                           ("mamba2-780m", False),
                                           ("recurrentgemma-2b", True)])
def test_prefill_and_decode_equal_the_jitted_reference(arch, epilogue):
    jcfg, jparams, tcfg, tparams = _pair(arch, epilogue)
    b, s = 4, 16
    toks = np.random.default_rng(1).integers(0, 512, (b, s)).astype(np.int32)
    want, jcache = jax.jit(lambda p, t: jmodel.prefill(
        p, jcfg, tokens=t, max_seq=32))(jparams, toks)
    got, tcache = tmodel.prefill(tparams, tcfg, torch.from_numpy(toks).long(),
                                 max_seq=32)
    np.testing.assert_array_equal(_bytes(got), _bytes(want))
    jl, tl = jax.tree_util.tree_leaves(jcache), tmodel.leaves(tcache)
    assert len(jl) == len(tl)
    for a, t in zip(jl, tl):
        np.testing.assert_array_equal(_bytes(t), _bytes(a))
    step = jax.jit(lambda p, c, t, pos: jmodel.decode_step(
        p, jcfg, c, tokens=t, pos=pos))
    tok = np.argmax(np.asarray(want)[:, -1], -1).astype(np.int32)[:, None]
    for i in range(4):
        want, jcache = step(jparams, jcache, tok, jnp.int32(s + i))
        got, tcache = tmodel.decode_step(tparams, tcfg, tcache,
                                         torch.from_numpy(tok).long(), s + i)
        np.testing.assert_array_equal(_bytes(got), _bytes(want))
        for a, t in zip(jax.tree_util.tree_leaves(jcache),
                        tmodel.leaves(tcache)):
            np.testing.assert_array_equal(_bytes(t), _bytes(a))
        tok = np.argmax(np.asarray(want)[:, -1], -1).astype(np.int32)[:, None]


def test_layer_carries_through_unscanned_blocks():
    cfg = tconfigs.get_config("recurrentgemma-2b")
    carries = tmodel.layer_carries(cfg)
    assert len(carries) == 26
    assert carries[:3] == [True, True, False]
    assert carries[-2:] == [True, False]
    assert tmodel.layer_carries(cfg, into_head=True)[-1]
    mamba = tconfigs.get_config("mamba2-780m")
    assert not any(tmodel.layer_carries(mamba, into_head=True))


def _reference_run(jcfg, jparams, prompts, **over):
    eng = JEngine(jparams, jcfg, JServeConfig(**{**SERVE, **over}))
    ids = [eng.submit(p, NEW) for p in prompts]
    out = eng.run()
    return [np.asarray(out[i]) for i in ids], eng


def _port_run(tcfg, tparams, prompts, **over):
    eng = ContinuousBatchingEngine(tparams, tcfg,
                                   ServeConfig(**{**SERVE, **over}),
                                   device="cpu")
    ids = [eng.submit(p, NEW) for p in prompts]
    out = eng.run()
    return [out[i] for i in ids], eng


@pytest.fixture(scope="module")
def reference_runs(arch_pair):
    arch, jcfg, jparams, _, _ = arch_pair
    prompts = _prompts(arch)
    free, eng = _reference_run(jcfg, jparams, prompts)
    return dict(prompts=prompts, free=free, stats=eng.cache_stats())


def test_continuous_engine_equals_the_reference(arch_pair, reference_runs,
                                                caplog):
    arch, _, _, tcfg, tparams = arch_pair
    with caplog.at_level(logging.INFO):
        got, eng = _port_run(tcfg, tparams, reference_runs["prompts"])
    for g, w in zip(got, reference_runs["free"]):
        np.testing.assert_array_equal(g, w)
    stats = eng.cache_stats()
    want = reference_runs["stats"]
    assert stats["state_bytes"] == want["state_bytes"] == \
        {"recurrentgemma-2b": 8192, "mamba2-780m": 149504}[arch]
    assert stats["page_bytes"] == want["page_bytes"]
    assert stats["allocated_bytes"] == want["allocated_bytes"]
    assert not eng.prefix_enabled and eng.scheduler.prefix is None
    assert not eng.chunked and stats["step_mode"] == "split"
    mixer = "rglru" if arch.startswith("recurrent") else "ssd"
    for line in (f"prefix cache disabled: mixers ['{mixer}'] are not "
                 "attention-only",
                 f"chunked prefill disabled: mixers ['{mixer}'] are not "
                 "attention-only; using monolithic prefill",
                 "ragged step disabled: needs attention-only mixers"):
        assert line in caplog.text


def test_preempted_recurrent_sequences_resume_with_their_state(
        arch_pair, reference_runs):
    _, _, _, tcfg, tparams = arch_pair
    prompts = reference_runs["prompts"]
    got, eng = _port_run(tcfg, tparams, prompts, num_pages=PREEMPT_PAGES)
    assert eng.cache_stats()["preemptions"] >= 1
    for g, w in zip(got, reference_runs["free"]):
        np.testing.assert_array_equal(g, w)
    # control: pages restored without the state rows part the streams
    real = kv_cache.restore_seq
    try:
        kv_cache.restore_seq = lambda c, s, ids, slot=None: real(c, s, ids)
        lost, _ = _port_run(tcfg, tparams, prompts, num_pages=PREEMPT_PAGES)
    finally:
        kv_cache.restore_seq = real
    assert any(not np.array_equal(a, b) for a, b in zip(lost, got))


def test_fixed_slot_engine_equals_the_reference(arch_pair):
    arch, jcfg, jparams, tcfg, tparams = arch_pair
    s0 = 8
    prompts = np.random.default_rng(4).integers(0, 512, (4, s0)).astype(
        np.int32)
    want = JFixed(jparams, jcfg, JServeConfig(max_seq=32)).generate(
        prompts, NEW)
    got = FixedSlotEngine(tparams, tcfg, ServeConfig(max_seq=32),
                          device="cpu").generate(prompts, NEW)
    np.testing.assert_array_equal(got, np.asarray(want))


def _one_layer(mixer: str):
    """The reference's fallback tests' one-block hybrid config, in both
    packages, and the reference's weights carried over."""
    from repro.core import MXFP8 as JMXFP8
    from repro.nn import ModelConfig as JModelConfig
    from repro_torch.core import MXFP8
    from repro_torch.nn import ModelConfig

    kw = dict(name="t", family="hybrid", d_model=64, vocab_size=128,
              num_groups=1, num_heads=4, num_kv_heads=2, head_dim=16,
              d_ff=128, rnn_width=64)
    jcfg = JModelConfig(pattern=(JBlockDef(mixer),), **kw, quant=JMXFP8.replace(
        block_size=16, quantize_acts=False))
    tcfg = ModelConfig(pattern=(BlockDef(mixer),), **kw, quant=MXFP8.replace(
        block_size=16, quantize_acts=False))
    jparams, _ = jmodel.init(jax.random.PRNGKey(0), jcfg)
    jparams = jax.tree_util.tree_map(np.asarray, jparams)
    return jcfg, jparams, tcfg, tmodel.params_from_jax(jparams, tcfg, "cpu")


def test_chunked_falls_back_to_monolithic_for_recurrent_mixers():
    jcfg, jparams, tcfg, tparams = _one_layer("rglru")
    eng = ContinuousBatchingEngine(tparams, tcfg, ServeConfig(
        max_seq=16, max_slots=1, page_size=4), device="cpu")
    assert not eng.chunked
    prompt = np.arange(5, dtype=np.int32)
    out = eng.generate(prompt[None], 4)
    fixed = FixedSlotEngine(tparams, tcfg, ServeConfig(max_seq=16),
                            device="cpu").generate(prompt[None], 4)
    np.testing.assert_array_equal(out, fixed)
    want = JFixed(jparams, jcfg, JServeConfig(max_seq=16)).generate(
        prompt[None], 4)
    np.testing.assert_array_equal(out, np.asarray(want))


def test_prefix_cache_auto_disabled_for_recurrent_mixers():
    _, _, tcfg, tparams = _one_layer("rglru")
    eng = ContinuousBatchingEngine(tparams, tcfg, ServeConfig(
        max_seq=16, max_slots=1, page_size=4, prefix_cache=True),
        device="cpu")
    assert not eng.prefix_enabled
    assert eng.scheduler.prefix is None


@pytest.mark.parametrize("over,error", [
    (dict(spec_decode=True), NotImplementedError),
    (dict(tiered=True), ValueError),
    (dict(spec_decode=True, tiered=True), NotImplementedError)])
def test_speculation_and_tiering_raise_as_the_reference(over, error):
    jcfg, jparams, tcfg, tparams = _one_layer("rglru")
    with pytest.raises(error) as want:
        JEngine(jparams, jcfg, JServeConfig(max_seq=24, **over))
    with pytest.raises(error) as got:
        ContinuousBatchingEngine(tparams, tcfg, ServeConfig(
            max_seq=24, **over), device="cpu")
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("mixer", ["rglru", "ssd"])
def test_attention_only_paths_raise_the_reference_messages(mixer):
    """The block-level paged paths that need attention, and the tiered
    pool, refuse a recurrent mixer with the reference's messages."""
    arch = "recurrentgemma-2b" if mixer == "rglru" else "mamba2-780m"
    jcfg, tcfg = jconfigs.get_reduced(arch), tconfigs.get_reduced(arch)
    bd = next(b for b in tcfg.pattern if b.mixer == mixer)
    jbd = next(b for b in jcfg.pattern if b.mixer == mixer)
    x = torch.zeros((1, 1, 64), dtype=torch.bfloat16)
    z = torch.zeros((1,), dtype=torch.int32)
    calls = {
        "verify": (lambda: jblocks.apply_verify_paged(
            {}, None, None, None, None, jbd, jcfg),
            lambda: tblocks.apply_verify_paged({}, x, {}, z, z, bd, tcfg)),
        "chunked": (lambda: jblocks.apply_prefill_chunked(
            {}, None, None, None, None, None, jbd, jcfg),
            lambda: tblocks.apply_prefill_chunked({}, x, {}, z, z, z, bd,
                                                  tcfg)),
        "ragged": (lambda: jblocks.apply_ragged_step(
            {}, None, None, None, None, None, jbd, jcfg),
            lambda: tblocks.apply_ragged_step({}, x, {}, z, z, z, bd, tcfg)),
        "prefix": (lambda: jblocks.prefill_block_tail(
            {}, None, None, None, None, jbd, jcfg, 8),
            lambda: tblocks.prefill_block_tail({}, x, z[None], {}, z, bd,
                                               tcfg, 8)),
        "tiered": (lambda: jblocks.init_paged_cache(2, 4, 4, jbd, jcfg,
                                                    tiered=True),
                   lambda: tblocks.init_paged_cache(4, 4, bd, tcfg, "cpu",
                                                    tiered=True,
                                                    num_slots=2)),
    }
    for name, (ref, port) in calls.items():
        with pytest.raises(NotImplementedError) as want:
            ref()
        with pytest.raises(NotImplementedError) as got:
            port()
        assert str(got.value) == str(want.value), name
    state = tblocks.init_paged_cache(4, 4, bd, tcfg, "cpu", num_slots=3)
    jstate = jblocks.init_paged_cache(3, 4, 4, jbd, jcfg)
    assert {k: tuple(v.shape) for k, v in state.items()} == \
        {k: tuple(v.shape) for k, v in jstate.items()}
    with pytest.raises(NotImplementedError, match="A9b"):
        tblocks.require_trainable(bd, tcfg)


def test_state_rows_travel_with_the_slot():
    """install, extract, restore and merge move a state row between slots
    and leave pools and other rows alone."""
    _, _, tcfg, _ = _pair("recurrentgemma-2b")
    cache = tmodel.init_paged_cache(tcfg, 6, 4, "cpu", num_slots=3)
    kinds = [kv_cache.is_pool(e) for e in cache]
    assert kinds == [False, False, True]
    pre = [{k: torch.randn((1, *v.shape[1:])) if not kv_cache.is_pool(e)
            else torch.zeros((1, 8, *v.shape[2:]), dtype=v.dtype)
            for k, v in e.items()} for e in cache]
    kv_cache.install_prefill(cache, pre, torch.tensor([1, 2]), 4, slot=2)
    assert torch.equal(cache[0]["h"][2], pre[0]["h"][0])
    assert not cache[0]["h"][:2].any()
    snap = kv_cache.extract_seq(cache, torch.tensor([1, 2]), slot=2)
    merged = kv_cache.merge_snapshots(snap, kv_cache.extract_seq(
        cache, torch.tensor([3])))
    assert merged[2]["k_elems"].shape[0] == 3
    assert torch.equal(merged[1]["conv"], pre[1]["conv"][0])
    kv_cache.restore_seq(cache, merged, torch.tensor([4, 5, 0]), slot=0)
    assert torch.equal(cache[1]["conv"][0], pre[1]["conv"][0])
    assert kv_cache.state_nbytes(cache) + sum(
        t.numel() * t.element_size() for t in cache[2].values()) == \
        kv_cache.cache_nbytes(cache)


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_cache_leaves_follow_the_reference(arch):
    """The paged cache's leaves in the reference's pytree order and shapes
    (``model.reference_cache_leaves``): state rows of four slots beside
    the attention pools; mamba2's uniform stack keeps each state leaf as
    one (L, slots, ...) tensor."""
    jcfg, tcfg = jconfigs.get_reduced(arch), tconfigs.get_reduced(arch)
    quant = dict(quantize_acts=False, quantize_kv_cache=True)
    jcfg = jcfg.replace(quant=jcfg.quant.replace(**quant))
    tcfg = tcfg.replace(quant=tcfg.quant.replace(**quant))
    jcache = jmodel.init_paged_cache(jcfg, 4, 6, 4)
    cache = tmodel.init_paged_cache(tcfg, 6, 4, "cpu", num_slots=4)
    want = [tuple(leaf.shape) for leaf in jax.tree_util.tree_leaves(jcache)]
    got = [((len(layers),) if stacked else ()) + tuple(
        cache[layers[0]][key].shape)
        for key, layers, stacked in tmodel.reference_cache_leaves(tcfg,
                                                                  cache)]
    assert got == want
    if arch == "mamba2-780m":
        assert tuple(cache.stack["h"].shape) == (2, 4, 8, 16, 32)
        assert cache[1]["h"].data_ptr() == cache.stack["h"][1].data_ptr()


def test_launchers_resolve_both_archs():
    for arch, prompt_len in (("recurrentgemma-2b", 12), ("mamba2-780m", 8)):
        report = tlaunch.main(["--arch", arch, "--reduced", "--batch", "2",
                               "--prompt-len", str(prompt_len),
                               "--new-tokens", "3", "--device", "cpu"])
        assert report["step_mode"] == "split"
        assert all(len(report["results"][i]) == len(p) + 3
                   for i, p in zip(report["ids"], report["prompts"]))
        with pytest.raises(NotImplementedError, match="A9b"):
            tlaunch_train.main(["--arch", arch, "--reduced", "--device",
                                "cpu", "--steps", "1"])
