"""The port's MoE FFN and mixtral-8x22b against the reference on the CPU.

Bars, each measured here:

  * the MoE layer (``nn.moe.apply``, dense and sorted dispatch, swiglu and
    gelu experts, with and without a shared expert, top-2 and top-3)
    equals the *jitted* reference's bit for bit, on the reference's
    weights carried over by ``model.params_from_jax``. Jitted, because XLA
    merges the dense dispatch's cast of the bf16 gate product to f32 into
    the product (the activation reads the f32 sums), which the eager
    reference does not; the engine runs the jitted step;
  * ``params_from_jax`` gives the expert stacks the reference's
    fake-quantized values (``_mx_expert_weight`` without a mesh) bit for
    bit, and the router f32 as it is;
  * the router: torch's f32 dot over d_model sums in another order than
    XLA's, and its ``exp`` differs by ulps, so logits and probabilities
    differ in their last f32 bits (measured: most logits, about a quarter
    of the probabilities). The expert choices and the bf16 weights that
    the experts' outputs are combined with are equal, and the test asserts
    why: every k-th probability leads the (k+1)-th, and every f32 weight
    lies off a bf16 rounding midpoint, by more than MARGIN_FACTOR times the
    largest difference measured between the two routers;
  * reduced mixtral's greedy streams through ``ContinuousBatchingEngine``
    (ragged and split; dense and sorted) equal the reference engine's, at
    a weight seed whose every pick leads its runner-up by more than
    GAP_TOL_ULPS (asserted); its megakernel mode falls back to the ragged
    step with the reference's reason; the recurrent mixers behind an MoE
    FFN take the reference's fallbacks, a dense no-gate ``gelu`` FFN
    builds without a gate, and MLA gets the reference's refusal.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro import configs as jconfigs  # noqa: E402
from repro.nn import BlockDef as JBlockDef  # noqa: E402
from repro.nn import blocks as jblocks  # noqa: E402
from repro.nn import model as jmodel  # noqa: E402
from repro.nn import moe as jmoe  # noqa: E402
from repro.serve import ContinuousBatchingEngine as JEngine  # noqa: E402
from repro.serve import ServeConfig as JServeConfig  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.nn import BlockDef  # noqa: E402
from repro_torch.nn import blocks as tblocks  # noqa: E402
from repro_torch.nn import model as tmodel  # noqa: E402
from repro_torch.nn import moe as tmoe  # noqa: E402
from repro_torch.serve import ContinuousBatchingEngine, ServeConfig  # noqa: E402

ARCH = "mixtral-8x22b"
MARGIN_FACTOR = 4
GAP_TOL_ULPS = 1
#: the engine runs' weight seed: every greedy pick of the four port runs
#: leads its runner-up by more than GAP_TOL_ULPS (the smallest from 0)
ENGINE_SEED = 17


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small models: one intra-op thread a process is as fast alone and
    keeps parallel test workers from oversubscribing the host."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pair(seed=0, **over):
    """Both packages' reduced mixtral as the launcher serves it
    (weight-only MX, an MX KV cache), on the reference's weights with
    RMSNorm scales drawn from N(0, 0.25)."""
    quant = dict(quantize_acts=False, quantize_kv_cache=True)
    jcfg = jconfigs.get_reduced(ARCH)
    tcfg = tconfigs.get_reduced(ARCH)
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
    return jcfg, jparams, tcfg, tmodel.params_from_jax(jparams, tcfg, "cpu")


def _bf16(shape, seed):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    j = jnp.asarray(x, jnp.bfloat16)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).bfloat16()


def _layer0(jparams):
    return jax.tree_util.tree_map(lambda a: a[0],
                                  jparams["groups"]["block0"]["ffn"])


# ---------------------------------------------------------------------------
# the layer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dispatch", ["dense", "sorted"])
@pytest.mark.parametrize("kind,shared,top_k", [
    ("swiglu", 0, 2), ("swiglu", 1, 2), ("gelu", 0, 2), ("geglu", 1, 2),
    ("gelu", 1, 2), ("swiglu", 0, 3)])
def test_moe_layer_equals_the_jitted_reference(dispatch, kind, shared,
                                               top_k):
    """Bit for bit on (3, 11, 64) rows; top-3 makes the sorted dispatch's
    bf16 scatter order count (three adds a token); the gelu kind's shared
    experts run the no-gate FFN (``ffn.apply``)."""
    jcfg, jparams, tcfg, tparams = _pair(
        1, moe_dispatch=dispatch, ffn_kind=kind, num_shared=shared,
        top_k=top_k)
    mcfg = jblocks._moe_cfg(jcfg)
    jx, tx = _bf16((3, 11, 64), 2)
    want, jaux = jax.jit(lambda p, x: jmoe.apply(p, x, mcfg, jcfg.quant))(
        _layer0(jparams), jx)
    tmcfg = tblocks._moe_cfg(tcfg)
    got = tmoe.apply(tparams["layers"][0]["ffn"], tx, tmcfg)
    _, tidx, tprobs = tmoe.router(tparams["layers"][0]["ffn"], tx, tmcfg)
    taux = tmoe.aux_loss(tidx, tprobs, tmcfg)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  np.asarray(want).view(np.int16))
    # the loss sums f32 probabilities, which differ in their last bits
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)


def test_expert_stacks_equal_the_reference_weights():
    """Each expert's slice fake-quantized along d_in, as the reference's
    ``_mx_expert_weight`` does at every use (the last layer's, taken off
    the stacked reference leaves); the router stays f32; the uniform
    stack's (L, ...) leaves hold every layer's."""
    jcfg, jparams, tcfg, tparams = _pair(2, num_shared=1)
    last = tcfg.num_layers - 1
    jffn = jax.tree_util.tree_map(lambda a: a[last],
                                  jparams["groups"]["block0"]["ffn"])
    tffn = tparams["layers"][last]["ffn"]
    for name in ("gate", "up", "down"):
        want = jmoe._mx_expert_weight(jffn["experts"][name], jcfg.quant, 1,
                                      jcfg.compute_dtype)
        got = tffn["experts"][name]
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                      np.asarray(want).view(np.int16))
        for layer in range(tcfg.num_layers):
            assert torch.equal(
                tparams["layer_stack"]["ffn"]["experts"][name][layer],
                tparams["layers"][layer]["ffn"]["experts"][name])
    np.testing.assert_array_equal(tffn["router"]["w"].numpy(),
                                  np.asarray(jffn["router"]["w"]))
    assert set(tffn["shared"]) == {"gate", "up", "down"}


@pytest.mark.parametrize("experts", [4, 8])
def test_router_choices_and_weights_equal_with_margins(experts):
    """Reduced mixtral's router (d_model 64, top-2 of 4 experts, and of
    mixtral's 8): the port's top-k indices equal ``lax.top_k``'s and its
    weights round to the same bf16, with margins asserted (module
    docstring). At d_model 6144 on the same draw (``python
    tests/test_torch_moe.py`` prints it; ROADMAP C) 914 of 1,024 f32
    weights differ, by up to 24 f32 ulps, none after rounding to bf16,
    and one lies within 4x its difference of a midpoint."""
    d = 64
    cfg = dict(d_model=d, d_ff_expert=64, num_experts=experts, top_k=2)
    jcfg, tcfg = jmoe.MoEConfig(**cfg), tmoe.MoEConfig(**cfg)
    rng = np.random.default_rng(d)
    w = (rng.standard_normal((d, experts)) / np.sqrt(d)).astype(
        np.float32)
    jx, tx = _bf16((4, 128, d), d + 1)
    jw, one_hot, _ = jax.jit(lambda p, x: jmoe._router(p, x, jcfg))(
        {"router": {"w": w}}, jx)
    jprobs = jax.jit(lambda x: jax.nn.softmax(jnp.einsum(
        "btd,de->bte", x.astype(jnp.float32), w), axis=-1))(jx)
    tw, tidx, tprobs = tmoe.router({"router": {"w": torch.from_numpy(w)}},
                                   tx, tcfg)
    jw, jprobs = np.asarray(jw), np.asarray(jprobs)
    np.testing.assert_array_equal(tidx.numpy(),
                                  np.asarray(one_hot).argmax(-1))
    np.testing.assert_array_equal(
        tw.bfloat16().view(torch.int16).numpy(),
        np.asarray(jnp.asarray(jw, jnp.bfloat16)).view(np.int16))
    # margins: the choice, and each weight's distance from a bf16
    # rounding midpoint against its own difference
    prob_err = np.abs(tprobs.numpy() - jprobs).max()
    weight_err = np.abs(tw.numpy() - jw)
    ranked = np.sort(jprobs, axis=-1)[..., ::-1]
    assert (ranked[..., 1] - ranked[..., 2]).min() \
        > MARGIN_FACTOR * prob_err
    ulp = 2.0 ** (np.floor(np.log2(np.abs(jw))) - 7)
    off_mid = np.abs(np.abs(jw / ulp - np.floor(jw / ulp)) - 0.5) * ulp
    assert (off_mid > MARGIN_FACTOR * weight_err).all()
    assert 0 < weight_err.max() < 1e-6 and 0 < prob_err < 1e-6


def test_unported_moe_paths_raise():
    cfg = tmoe.MoEConfig(d_model=64, d_ff_expert=64, num_experts=4, top_k=2)
    quant = tconfigs.get_reduced(ARCH).quant.replace(quantize_acts=False)
    params = tmoe.init(torch.Generator().manual_seed(0), cfg, quant, "cpu")
    x = torch.zeros((1, 2, 64), dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="A7"):
        tmoe.apply(params, x, cfg, mesh=(1, 4))
    with pytest.raises(ValueError, match="dispatch"):
        tmoe.apply(params, x, tmoe.MoEConfig(64, 64, 4, 2,
                                             dispatch="ragged"))


# ---------------------------------------------------------------------------
# the engine
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


def _run(engine):
    ids = [engine.submit(p, 6) for p in _prompts()]
    out = engine.run()
    return [out[i] for i in ids], engine.cache_stats()


_REFERENCE = {}


def _reference_streams(dispatch, step_mode):
    key = (dispatch, step_mode)
    if key not in _REFERENCE:
        jcfg, jparams, _, _ = _pair(ENGINE_SEED, moe_dispatch=dispatch)
        eng = JEngine(jparams, jcfg, JServeConfig(**SERVE,
                                                  step_mode=step_mode))
        _REFERENCE[key] = _run(eng)[0]
    return _REFERENCE[key]


@pytest.mark.parametrize("step_mode", ["ragged", "split"])
@pytest.mark.parametrize("dispatch", ["dense", "sorted"])
def test_continuous_engine_streams_equal_the_reference(dispatch, step_mode):
    _, _, tcfg, tparams = _pair(ENGINE_SEED, moe_dispatch=dispatch)
    eng = ContinuousBatchingEngine(
        tparams, tcfg, ServeConfig(**SERVE, step_mode=step_mode),
        device="cpu")
    got, stats = _run(eng)
    assert stats["step_mode"] == step_mode
    assert stats["prefix_hit_tokens"] > 0
    assert stats["min_top2_gap_ulps"] > GAP_TOL_ULPS
    for g, w in zip(got, _reference_streams(dispatch, step_mode)):
        np.testing.assert_array_equal(g, w)


def test_megakernel_falls_back_with_the_reference_reason(caplog):
    jcfg, _, tcfg, tparams = _pair(ENGINE_SEED)
    want = jblocks.megakernel_reject_reason(jcfg)
    assert want == ("ffn kind 'moe' (the fused layer tail implements the "
                    "dense gated MLP only)")
    with caplog.at_level("INFO"):
        eng = ContinuousBatchingEngine(
            tparams, tcfg, ServeConfig(**SERVE, step_mode="megakernel"),
            device="cpu")
    stats = eng.cache_stats()
    assert not stats["megakernel"] and stats["step_mode"] == "ragged"
    assert stats["megakernel_fallback_reason"] == want
    assert f"megakernel step disabled: {want}" in caplog.text
    got, _ = _run(eng)
    for g, w in zip(got, _reference_streams("dense", "ragged")):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("mixer", ["rglru", "ssd"])
def test_engine_still_raises_a8_for_other_mixers(mixer):
    """The recurrent mixers are ported now (behind an MoE FFN too): the
    engine takes them with the reference's fallbacks (the split step,
    monolithic admission, no prefix cache); the no-gate ``gelu`` FFN
    (ported with A8d) builds a dense block without a gate."""
    _, _, tcfg, _ = _pair(ENGINE_SEED)
    cfg = tcfg.replace(pattern=(BlockDef(mixer, ffn="moe"),), d_inner=128,
                       headdim=16, d_state=32, ssd_chunk=8)
    params = tmodel.init(cfg, torch.Generator().manual_seed(0), "cpu")
    eng = ContinuousBatchingEngine(params, cfg, ServeConfig(**SERVE),
                                   device="cpu")
    assert (eng.ragged, eng.chunked, eng.prefix_enabled) == (False,) * 3
    block = tblocks.init(torch.Generator().manual_seed(0),
                         BlockDef(mixer, ffn="dense"),
                         cfg.replace(ffn_kind="gelu"), "cpu")
    assert set(block["ffn"]) == {"up", "down"}


@pytest.mark.parametrize("tiered", [False, True])
def test_continuous_engine_refuses_mla_with_the_reference_message(tiered):
    """MLA blocks (here behind mixtral's MoE) get the reference engine's
    refusal, string for string, before any tiering check, as there."""
    jcfg, jparams, tcfg, tparams = _pair(ENGINE_SEED)
    bd = dict(ffn="moe")
    jcfg = jcfg.replace(pattern=(JBlockDef("mla", **bd),))
    cfg = tcfg.replace(pattern=(BlockDef("mla", **bd),))
    with pytest.raises(NotImplementedError) as want:
        JEngine(jparams, jcfg, JServeConfig(**SERVE, tiered=tiered))
    with pytest.raises(NotImplementedError) as got:
        ContinuousBatchingEngine(tparams, cfg,
                                 ServeConfig(**SERVE, tiered=tiered),
                                 device="cpu")
    assert str(got.value) == str(want.value)
    assert "use FixedSlotEngine" in str(got.value)


@pytest.mark.parametrize("what", ["paged cache", "training"])
def test_paged_cache_and_training_refuse_mla(what):
    """The paged pool raises with the reference's message (MLA has no page
    layout); training MLA blocks raises naming ROADMAP A9b."""
    _, _, tcfg, _ = _pair(ENGINE_SEED)
    bd = BlockDef("mla", ffn="moe")
    if what == "paged cache":
        with pytest.raises(NotImplementedError,
                           match="paged serving does not support mixer "
                                 "'mla' yet"):
            tblocks.init_paged_cache(8, 4, bd, tcfg, "cpu")
    else:
        with pytest.raises(NotImplementedError, match=r"MLA.*A9b"):
            tblocks.require_trainable(bd, tcfg)


def router_differences(d: int, experts: int = 8, top_k: int = 2) -> dict:
    """The two routers on the router test's draw at d_model ``d``: f32
    weights that differ and by how many f32 ulps at most, bf16 weights and
    choices that differ, and weights within MARGIN_FACTOR times their own
    difference of a bf16 rounding midpoint."""
    cfg = dict(d_model=d, d_ff_expert=64, num_experts=experts, top_k=top_k)
    jcfg, tcfg = jmoe.MoEConfig(**cfg), tmoe.MoEConfig(**cfg)
    rng = np.random.default_rng(d)
    w = (rng.standard_normal((d, experts)) / np.sqrt(d)).astype(np.float32)
    jx, tx = _bf16((4, 128, d), d + 1)
    jw, one_hot, _ = jax.jit(lambda p, x: jmoe._router(p, x, jcfg))(
        {"router": {"w": w}}, jx)
    tw, tidx, _ = tmoe.router({"router": {"w": torch.from_numpy(w)}}, tx,
                              tcfg)
    jw = np.asarray(jw)
    err = np.abs(tw.numpy() - jw)
    ulp = 2.0 ** (np.floor(np.log2(np.abs(jw))) - 7)
    off_mid = np.abs(np.abs(jw / ulp - np.floor(jw / ulp)) - 0.5) * ulp
    return dict(
        weights=jw.size, f32_differ=int((err > 0).sum()),
        max_f32_ulps=float((err / (ulp / 2 ** 16)).max()),
        bf16_differ=int((tw.bfloat16().float().numpy() != np.asarray(
            jnp.asarray(jw, jnp.bfloat16)).astype(np.float32)).sum()),
        choices_differ=int((tidx.numpy() != np.asarray(one_hot).argmax(-1))
                           .sum()),
        near_midpoint=int((off_mid <= MARGIN_FACTOR * err).sum()))


if __name__ == "__main__":
    for d in (64, 6144):
        print(f"d_model {d}, top-2 of 8:", router_differences(d))
