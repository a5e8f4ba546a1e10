"""The port's architecture registry and its three newer configs against the
reference: gemma2-2b, gemma2-9b and phi4-mini-3.8b, reduced, on the CPU.
The registry, config and model-step tests also run reduced mixtral-8x22b
(its MoE layer and engines: ``tests/test_torch_moe.py``).

The configs and the registry are compared field for field. The models
run on the reference's own weights (``model.params_from_jax``), with
nonzero RMSNorm scales so that every norm, the sandwich post-norms among
them, weighs in:

  * dense prefill's logits and contiguous cache are bit-equal. Five
    ``decode_step`` steps, each from the reference's cache of the step
    before (gemma2's local layers wrap their 8-slot ring), are held to
    ``test_torch_monolithic.py``'s decode bars (DECODE_TOL_ULPS,
    DECODE_BYTE_FRACTION): at one query row XLA:CPU's dots sum in
    another order than torch's, and a product on a bf16 rounding tie
    may round the other way (measured here: the LM head's logit 217 at
    gemma2's position 16, a q projection element at 17; phi4-mini's
    five steps bit-equal). The tanh and both softcaps are bit-equal
    (``test_torch_gemma2.py``);
  * two ragged steps over shared pools, prompts crossing the window of
    8, are held as ``test_torch_model_step.py`` holds granite's: logits
    within one bf16 ulp of the largest (RAGGED_TOL_ULPS), the same
    argmax, and at most CODE_FRACTION of the pools' fp8 codes apart;
  * greedy streams through ``ContinuousBatchingEngine`` (ragged, split,
    monolithic, and gemma2 tiered: one repack call a layer),
    ``FixedSlotEngine`` and phi4-mini's megakernel step (its plain
    version on the CPU) equal the reference engine's, at
    seeds whose every pick leads its runner-up by more than
    GAP_TOL_ULPS, which the tests assert.

The reduced gemma2-9b equals the reduced gemma2-2b in every field but
its name (asserted), so the engines run on the 2b alone.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro import configs as jconfigs  # noqa: E402
from repro.nn import blocks as jblocks  # noqa: E402
from repro.nn import model as jmodel  # noqa: E402
from repro.serve import ContinuousBatchingEngine as JEngine  # noqa: E402
from repro.serve import FixedSlotEngine as JFixed  # noqa: E402
from repro.serve import ServeConfig as JServeConfig  # noqa: E402
from repro.serve import TierPolicy as JTierPolicy  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.nn import blocks as tblocks  # noqa: E402
from repro_torch.nn import model as tmodel  # noqa: E402
from repro_torch.serve import (ContinuousBatchingEngine,  # noqa: E402
                               FixedSlotEngine, ServeConfig, TierPolicy)
from repro_torch.serve import engine as engine_mod  # noqa: E402

NEW_ARCHS = ("gemma2-2b", "gemma2-9b", "phi4-mini-3.8b")
#: the model-step tests also run mixtral-8x22b (its MoE behind every
#: prefill, decode and ragged step; tests/test_torch_moe.py has the rest)
STEP_ARCHS = NEW_ARCHS + ("mixtral-8x22b",)
RAGGED_TOL_ULPS = 1
CODE_FRACTION = 1e-3
GAP_TOL_ULPS = 1
DECODE_TOL_ULPS = 2
DECODE_BYTE_FRACTION = 0.01
#: engine runs: weight seed of each arch (every pick leads by > 1 ulp)
ENGINE_SEED = {"gemma2-2b": 22, "phi4-mini-3.8b": 2}
#: the tiered gemma2 run's seed, chosen the same way
TIERED_SEED = 12


# ---------------------------------------------------------------------------
# configs and the registry
# ---------------------------------------------------------------------------


def _fields(cfg) -> dict:
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def _dtype_name(dt) -> str:
    return str(dt).split(".")[-1].rstrip("'>")


def _same_config(tcfg, jcfg, where="cfg"):
    """Every field of the port's dataclass equals the reference's field
    of that name (the reference has more fields: training, MoE, ...);
    dtypes compare by name, nested dataclasses field by field."""
    jf = _fields(jcfg)
    for name, value in _fields(tcfg).items():
        want, at = jf[name], f"{where}.{name}"
        if dataclasses.is_dataclass(value):
            _same_config(value, want, at)
        elif name.endswith("dtype"):
            assert _dtype_name(value) == _dtype_name(want), at
        elif isinstance(value, tuple) and value and \
                dataclasses.is_dataclass(value[0]):
            assert len(value) == len(want), at
            for i, (a, b) in enumerate(zip(value, want)):
                _same_config(a, b, f"{at}[{i}]")
        else:
            assert value == want, at


@pytest.mark.parametrize("arch", sorted(tconfigs.ARCHS))
def test_configs_equal_the_reference_field_for_field(arch):
    _same_config(tconfigs.get_config(arch), jconfigs.get_config(arch))
    _same_config(tconfigs.get_reduced(arch), jconfigs.get_reduced(arch))


def test_registry_shapes_and_applicability():
    assert tconfigs.list_archs() == jconfigs.list_archs() == sorted(
        ["deepseek-v2-lite-16b", "gemma2-2b", "gemma2-9b", "granite-8b",
         "llava-next-mistral-7b", "mamba2-780m", "mixtral-8x22b",
         "musicgen-medium", "phi4-mini-3.8b", "recurrentgemma-2b"])
    assert {k: dataclasses.astuple(v) for k, v in tconfigs.SHAPES.items()} \
        == {k: dataclasses.astuple(v) for k, v in jconfigs.SHAPES.items()}
    for arch in tconfigs.list_archs():
        for name, shape in tconfigs.SHAPES.items():
            assert tconfigs.shape_applicable(
                tconfigs.get_config(arch), shape) == \
                jconfigs.shape_applicable(jconfigs.get_config(arch),
                                          jconfigs.SHAPES[name])
    with pytest.raises(KeyError, match="unknown arch"):
        tconfigs.get_config("musicgen-large")
    nine = _fields(tconfigs.get_reduced("gemma2-9b"))
    two = _fields(tconfigs.get_reduced("gemma2-2b"))
    assert {k: v for k, v in nine.items() if k != "name"} == \
        {k: v for k, v in two.items() if k != "name"}


@pytest.mark.parametrize("arch", sorted(tconfigs.ARCHS))
def test_megakernel_reject_reasons_equal_the_reference(arch):
    for kv in (True, False):
        for get in ("get_config", "get_reduced"):
            jcfg = getattr(jconfigs, get)(arch)
            tcfg = getattr(tconfigs, get)(arch)
            jcfg = jcfg.replace(quant=jcfg.quant.replace(
                quantize_acts=False, quantize_kv_cache=kv))
            tcfg = tcfg.replace(quant=tcfg.quant.replace(
                quantize_acts=False, quantize_kv_cache=kv))
            want = jblocks.megakernel_reject_reason(jcfg)
            assert tblocks.megakernel_reject_reason(tcfg) == want
            if arch.startswith("gemma2"):
                assert want.startswith("non-uniform block pattern")
            elif arch == "mixtral-8x22b":
                assert want.startswith("ffn kind 'moe'")
            elif arch == "deepseek-v2-lite-16b":
                assert want.startswith("non-attention mixers ['mla']")
            elif arch == "recurrentgemma-2b":
                assert want.startswith("non-attention mixers ['rglru']")
            elif arch == "mamba2-780m":
                assert want.startswith("non-attention mixers ['ssd']")
            elif kv:
                assert want is None


# ---------------------------------------------------------------------------
# the model steps
# ---------------------------------------------------------------------------


def _pair(arch, seed=0, **over):
    """Both packages' reduced ``arch`` as the launcher serves it
    (weight-only MX, an MX KV cache), on the reference's weights with
    RMSNorm scales drawn from N(0, 0.25)."""
    quant = dict(quantize_acts=False, quantize_kv_cache=True)
    jcfg = jconfigs.get_reduced(arch)
    tcfg = tconfigs.get_reduced(arch)
    jcfg = jcfg.replace(quant=jcfg.quant.replace(**quant), **over)
    tcfg = tcfg.replace(quant=tcfg.quant.replace(**quant), **over)
    jparams, _ = jmodel.init(jax.random.PRNGKey(seed), jcfg)
    rng = np.random.default_rng(seed)

    def scales(path, leaf):
        leaf = np.asarray(leaf)
        if jax.tree_util.keystr(path).endswith("['scale']"):
            leaf = leaf + 0.5 * rng.standard_normal(leaf.shape).astype(
                np.float32)
        return leaf
    jparams = jax.tree_util.tree_map_with_path(scales, jparams)
    tparams = tmodel.params_from_jax(jparams, tcfg, "cpu")
    return jcfg, jparams, tcfg, tparams


def _np(t):
    if t.dtype in (torch.float8_e4m3fn, torch.float8_e5m2):
        return t.view(torch.uint8).numpy()
    return t.numpy()


def _jnp(a):
    a = np.asarray(a)
    if a.dtype.itemsize == 1 and a.dtype.kind not in "iub":
        return a.view(np.uint8)
    return a


def _to_port(tree):
    if isinstance(tree, dict):
        return {k: _to_port(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_to_port(v) for v in tree)
    a = np.asarray(tree)
    if a.dtype.name in ("float8_e4m3fn", "float8_e5m2"):
        return torch.from_numpy(a.view(np.uint8).copy()).view(
            getattr(torch, a.dtype.name))
    return torch.from_numpy(a.copy())


def _assert_same_tree(jtree, ttree):
    for path, leaf in jax.tree_util.tree_leaves_with_path(jtree):
        node = ttree
        for k in path:
            node = node[k.key if hasattr(k, "key") else k.idx]
        np.testing.assert_array_equal(_np(node), _jnp(leaf),
                                      err_msg=jax.tree_util.keystr(path))


def _assert_decode_close(jl, tl, jcache, tcache):
    """``test_torch_monolithic.py``'s decode bars: logits within
    DECODE_TOL_ULPS bf16 ulps of the largest with the same argmax, and at
    most DECODE_BYTE_FRACTION of the cache's bytes apart."""
    want, got = np.asarray(jl), tl.numpy()
    tol = DECODE_TOL_ULPS * 2.0 ** (np.floor(np.log2(np.abs(want).max()))
                                    - 7)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    differing = total = 0
    for path, leaf in jax.tree_util.tree_leaves_with_path(jcache):
        node = tcache
        for k in path:
            node = node[k.key if hasattr(k, "key") else k.idx]
        g, w = _np(node), _jnp(leaf)
        differing += int((g != w).sum())
        total += g.size
    assert differing <= DECODE_BYTE_FRACTION * total, (differing, total)


@pytest.mark.parametrize("arch", STEP_ARCHS)
def test_prefill_and_decode_steps_equal_the_reference(arch):
    """Dense prefill bit for bit (logits and cache); then five decode
    steps, each from the reference's cache of the step before, held to
    the decode bars."""
    jcfg, jparams, tcfg, tparams = _pair(arch)
    toks = np.random.default_rng(1).integers(0, 512, (2, 13)).astype(
        np.int32)
    jl, jcache = jax.jit(lambda p, t: jmodel.prefill(
        p, jcfg, tokens=t, max_seq=24))(jparams, toks)
    tl, tcache = tmodel.prefill(tparams, tcfg, torch.from_numpy(toks),
                                max_seq=24)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    _assert_same_tree(jcache, tcache)
    jstep = jax.jit(lambda p, c, t, pos: jmodel.decode_step(
        p, jcfg, c, tokens=t, pos=pos))
    tok = np.argmax(np.asarray(jl)[:, -1], -1).astype(np.int32)[:, None]
    for pos in range(13, 18):
        tcache = _to_port(jcache)
        jl, jcache = jstep(jparams, jcache, tok, np.int32(pos))
        tl, tcache = tmodel.decode_step(tparams, tcfg, tcache,
                                        torch.from_numpy(tok), pos)
        _assert_decode_close(jl, tl, jcache, tcache)
        tok = np.argmax(np.asarray(jl)[:, -1], -1).astype(np.int32)[:, None]


def _ragged_steps():
    """Two steps of R=4 rows, W=16, page size 4: prompts of 16 and 11
    tokens, a one-token row and an idle row; then decode rows and a
    continuation chunk, every prompt past the window of 8."""
    table = np.full((4, 8), -1, np.int32)
    table[0, :5] = [0, 1, 2, 3, 8]
    table[1, :4] = [4, 5, 6, 9]
    table[2, :2] = [7, 10]
    first = dict(starts=[0, 0, 0, 0], lens=[16, 11, 1, 1],
                 lidx=[15, 10, 0, 0])
    second = dict(starts=[16, 11, 1, 0], lens=[17, 16, 2, 1],
                  lidx=[0, 4, 0, 0])
    return table, [first, second]


@pytest.mark.parametrize("arch", STEP_ARCHS)
def test_ragged_steps_match_the_reference_kernel(arch):
    """The reference's ragged step runs its Pallas kernel in interpret
    mode; the port's runs the kernel's plain version."""
    jcfg, jparams, tcfg, tparams = _pair(arch, decode_kernel="fused")
    num_pages, ps = 13, 4
    jcache = jmodel.init_paged_cache(jcfg, 4, num_pages, ps)
    tcache = tmodel.init_paged_cache(tcfg, num_pages, ps, "cpu")
    step = jax.jit(lambda p, c, *a: jmodel.ragged_step_paged(p, jcfg, c, *a))
    rng = np.random.default_rng(2)
    table, steps = _ragged_steps()
    for meta in steps:
        tokens = rng.integers(0, 512, (4, 16)).astype(np.int32)
        args = [tokens, table] + [np.asarray(meta[k], np.int32)
                                  for k in ("starts", "lens", "lidx")]
        want, jcache = step(jparams, jcache, *args)
        got = tmodel.ragged_step_paged(
            tparams, tcfg, tcache, *(torch.from_numpy(a) for a in args))
        want, got = np.asarray(want)[:3, 0], got.numpy()[:3]
        tol = RAGGED_TOL_ULPS * 2.0 ** (
            np.floor(np.log2(np.abs(want).max())) - 7)
        np.testing.assert_allclose(got, want, rtol=0, atol=tol)
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
        differing = total = 0
        layout = tmodel.reference_cache_leaves(tcfg, tcache)
        for jleaf, (key, layers, stacked) in zip(
                jax.tree_util.tree_leaves(jcache), layout):
            g = [tcache[li][key].view(torch.uint8).numpy() for li in layers]
            g = np.stack(g) if stacked else g[0]
            w = np.asarray(jleaf).view(np.uint8)
            differing += int((g != w).sum())
            total += g.size
        assert differing <= CODE_FRACTION * total, (differing, total)


# ---------------------------------------------------------------------------
# engines
# ---------------------------------------------------------------------------


def _prompts():
    """Four prompts through three slots: two share a 12-token head, and
    every prompt crosses the window of 8 (lengths 16, 16, 16, 9)."""
    rng = np.random.default_rng(5)
    head = rng.integers(0, 512, (12,)).astype(np.int32)
    out = [np.concatenate([head, rng.integers(0, 512, (4,))]).astype(
        np.int32) for _ in range(2)]
    out += [rng.integers(0, 512, (n,)).astype(np.int32) for n in (16, 9)]
    return out


SERVE = dict(max_seq=40, max_slots=3, page_size=4, num_pages=40,
             prefix_cache=True, prefill_chunk=8)
MODES = {"ragged": {}, "split": dict(step_mode="split"),
         "monolithic": dict(prefill_mode="monolithic")}


def _run(engine, prompts, new_tokens):
    ids = [engine.submit(p, new_tokens) for p in prompts]
    out = engine.run()
    return [out[i] for i in ids], engine.cache_stats()


_REFERENCE = {}


def _reference_streams(arch, mode):
    """The reference engine's streams, once per (arch, mode)."""
    key = (arch, mode)
    if key not in _REFERENCE:
        jcfg, jparams, _, _ = _pair(arch, ENGINE_SEED[arch])
        eng = JEngine(jparams, jcfg, JServeConfig(**SERVE, **MODES[mode]))
        _REFERENCE[key] = _run(eng, _prompts(), 6)[0]
    return _REFERENCE[key]


@pytest.mark.parametrize("arch,mode", [
    ("gemma2-2b", "ragged"), ("gemma2-2b", "split"),
    ("gemma2-2b", "monolithic"), ("phi4-mini-3.8b", "ragged"), ("phi4-mini-3.8b", "split"),
    ("phi4-mini-3.8b", "monolithic")])
def test_continuous_engine_streams_equal_the_reference(arch, mode):
    _, _, tcfg, tparams = _pair(arch, ENGINE_SEED[arch])
    eng = ContinuousBatchingEngine(
        tparams, tcfg, ServeConfig(**SERVE, **MODES[mode]), device="cpu")
    got, stats = _run(eng, _prompts(), 6)
    assert stats["step_mode"] == ("split" if mode != "ragged" else "ragged")
    assert stats["prefix_hit_tokens"] > 0
    assert stats["min_top2_gap_ulps"] > GAP_TOL_ULPS
    for g, w in zip(got, _reference_streams(arch, mode)):
        np.testing.assert_array_equal(g, w)


def test_phi4_megakernel_plain_streams_equal_the_reference():
    """phi4-mini's uniform stack takes the megakernel step (its plain
    version on the CPU); its streams equal the reference's ragged run."""
    _, _, tcfg, tparams = _pair("phi4-mini-3.8b",
                                ENGINE_SEED["phi4-mini-3.8b"])
    eng = ContinuousBatchingEngine(
        tparams, tcfg, ServeConfig(**SERVE, step_mode="megakernel"),
        device="cpu")
    got, stats = _run(eng, _prompts(), 6)
    assert stats["megakernel"] and stats["step_mode"] == "megakernel"
    assert stats["min_top2_gap_ulps"] > GAP_TOL_ULPS
    for g, w in zip(got, _reference_streams("phi4-mini-3.8b", "ragged")):
        np.testing.assert_array_equal(g, w)


def test_gemma2_megakernel_falls_back_with_the_reference_reason(caplog):
    _, _, tcfg, tparams = _pair("gemma2-2b", ENGINE_SEED["gemma2-2b"])
    with caplog.at_level("INFO"):
        eng = ContinuousBatchingEngine(
            tparams, tcfg, ServeConfig(**SERVE, step_mode="megakernel"),
            device="cpu")
    stats = eng.cache_stats()
    assert not stats["megakernel"] and stats["step_mode"] == "ragged"
    assert stats["megakernel_fallback_reason"].startswith(
        "non-uniform block pattern")
    assert "megakernel step disabled: non-uniform block pattern" in \
        caplog.text
    got, _ = _run(eng, _prompts(), 6)
    for g, w in zip(got, _reference_streams("gemma2-2b", "ragged")):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("arch", ["gemma2-2b", "phi4-mini-3.8b"])
def test_fixed_slot_engine_equals_the_reference(arch):
    jcfg, jparams, tcfg, tparams = _pair(arch, ENGINE_SEED[arch])
    prompts = np.stack([p[-5:] for p in _prompts()[:4]])
    serve = dict(max_seq=24, max_slots=4, page_size=4, num_pages=24)
    want = JFixed(jparams, jcfg, JServeConfig(**serve)).generate(prompts, 8)
    got = FixedSlotEngine(tparams, tcfg, ServeConfig(**serve),
                          device="cpu").generate(prompts, 8)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_gemma2_tiered_repacks_one_call_a_layer(monkeypatch):
    """Reduced gemma2-2b through the tiered cache (demoted after one idle
    step, cold after three, three pages a step): its pools are per layer
    (no stack), so each repack dispatch calls #7 once a layer on 4-D
    pools; streams and the repack counts equal the reference's."""
    jcfg, jparams, tcfg, tparams = _pair("gemma2-2b", TIERED_SEED)
    policy = dict(hot_steps=1, cold_steps=3, repack_pages_per_step=3)
    jeng = JEngine(jparams, jcfg, JServeConfig(
        **SERVE, tiered=True, tier_policy=JTierPolicy(**policy)))
    teng = ContinuousBatchingEngine(tparams, tcfg, ServeConfig(
        **SERVE, tiered=True, tier_policy=TierPolicy(**policy)),
        device="cpu")
    assert teng.cache.stack is None
    calls = []
    repack = engine_mod.mx_repack_pages

    def counted(*args, **kwargs):
        calls.append(args[0].ndim)
        return repack(*args, **kwargs)

    monkeypatch.setattr(engine_mod, "mx_repack_pages", counted)
    want, jstats = _run(jeng, _prompts(), 6)
    got, stats = _run(teng, _prompts(), 6)
    assert stats["min_top2_gap_ulps"] > GAP_TOL_ULPS
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    for key in ("repacked_pages", "repack_dispatches", "units_in_use"):
        assert stats[key] == jstats[key], key
    assert stats["repack_dispatches"] > 0 and stats["pages_fp4_e2m1"] > 0
    assert calls == [4] * (stats["repack_dispatches"] * tcfg.num_layers)
