"""llava-next-mistral-7b against the JAX reference on the CPU, reduced (2
layers, d_model 64, 4 query heads of 16 over 2 KV heads, SwiGLU d_ff 128,
vocab 512, an untied head, RoPE theta 1e6): the reference's weights
carried over by ``model.params_from_jax``, RMSNorm scales drawn from
N(0, 0.25). The vision frontend is the reference's stub: precomputed
(B, S, d_model) ``embeds`` reach ``forward``, ``prefill``,
``decode_step`` and ``loss_fn``; the engines serve the mistral backbone
from token ids.

Bars, each measured on this host:

  * RoPE at theta 1e6, head_dim 128: the f32 cos/sin tables over
    positions [0, 4096) and bf16 rotations there bit-equal;
  * ``prefill(embeds=...)`` of seeded-normal embeddings: caches
    bit-equal, logits within PREFILL_TOL_ULPS bf16 ulp of the largest
    with equal argmax (measured: one of 1,024 logits one ulp apart, a
    near-tie product in the LM head at one row; ROADMAP C); then five
    ``decode_step(embeds=...)`` steps on the port's own cache: logits and
    caches bit-equal;
  * the training forward over ``embeds`` and ``loss_fn`` on an
    ``embeds`` batch: bit-equal logits, loss within two f32 ulps;
  * step-0 MXFP8 QAT loss and gradients on the reference's token
    batches: loss within two f32 ulps, every gradient leaf within
    GRAD_RTOL of its largest (``tests/test_torch_train.py``'s bar for an
    untied head). Measured: the loss two ulps apart, the gradients within
    2.3e-3 of their leaf's largest, as granite-8b's;
  * greedy streams of four prompts through three slots of the continuous
    engine, ragged and megakernel (its plain version), token for token
    the reference engine's, at a weight seed whose every pick leads by
    more than GAP_TOL_ULPS (asserted);
  * the train launcher takes llava: two QAT steps, finite losses.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro import configs as jconfigs  # noqa: E402
from repro.data import DataConfig as JDataConfig  # noqa: E402
from repro.data import SyntheticLMDataset as JDataset  # noqa: E402
from repro.nn import model as jmodel  # noqa: E402
from repro.nn import rotary as jrotary  # noqa: E402
from repro.serve import ContinuousBatchingEngine as JEngine  # noqa: E402
from repro.serve import ServeConfig as JServeConfig  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.nn import model as tmodel  # noqa: E402
from repro_torch.nn import rotary  # noqa: E402
from repro_torch.serve import ContinuousBatchingEngine  # noqa: E402
from repro_torch.serve import ServeConfig  # noqa: E402
from repro_torch.train import loop  # noqa: E402

ARCH = "llava-next-mistral-7b"
PREFILL_TOL_ULPS = 1
GRAD_RTOL = 5e-3
GAP_TOL_ULPS = 1
#: weight seed of the engine streams: the smallest whose every pick leads
#: its runner-up by more than GAP_TOL_ULPS (seeds 0-5 tie within one ulp)
ENGINE_SEED = 6
SEQ, BATCH = 16, 4


def _pair(seed=0, **over):
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


def _np(t):
    if t.dtype in (torch.float8_e4m3fn, torch.float8_e5m2):
        return t.view(torch.uint8).numpy()
    return t.numpy()


def _jnp(a):
    a = np.asarray(a)
    if a.dtype.itemsize == 1 and a.dtype.kind not in "iub":
        return a.view(np.uint8)
    return a


def _assert_same_tree(jtree, ttree):
    for path, leaf in jax.tree_util.tree_leaves_with_path(jtree):
        node = ttree
        for k in path:
            node = node[k.key if hasattr(k, "key") else k.idx]
        np.testing.assert_array_equal(_np(node), _jnp(leaf),
                                      err_msg=jax.tree_util.keystr(path))


def _embeds(shape, seed):
    return (0.5 * np.random.default_rng(seed).standard_normal(shape)).astype(
        np.float32)


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.uint16 if a.dtype.itemsize == 2 else np.uint32)


def test_rope_at_theta_1e6_equals_the_jitted_reference():
    theta, d, n = 1e6, 128, 4096
    pos = np.arange(n, dtype=np.int32)

    def tables(p):
        angles = p[:, None].astype(jnp.float32) * jrotary.rope_freqs(d, theta)
        return jnp.cos(angles), jnp.sin(angles)

    want = jax.jit(tables)(jnp.asarray(pos))
    got = rotary.rope_table(d, theta, n, "cpu")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_bits(g.numpy()), _bits(w))
    xj = jnp.asarray(np.random.default_rng(6).normal(size=(n, 2, d)),
                     jnp.bfloat16)
    want = jax.jit(jrotary.apply_rope, static_argnums=2)(
        xj, jnp.asarray(pos), theta)
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).bfloat16()
    got = rotary.apply_rope(xt, torch.from_numpy(pos), theta, n)
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  _bits(want).view(np.int16))


def test_embeds_prefill_and_decode_equal_the_reference():
    jcfg, jparams, tcfg, tparams = _pair()
    emb = _embeds((2, 13, 64), 3)
    jl, jcache = jax.jit(lambda p, e: jmodel.prefill(
        p, jcfg, embeds=e, max_seq=24))(jparams, emb)
    tl, tcache = tmodel.prefill(tparams, tcfg, embeds=torch.from_numpy(emb),
                                max_seq=24)
    want, got = np.asarray(jl), tl.numpy()
    tol = PREFILL_TOL_ULPS * 2.0 ** (np.floor(np.log2(np.abs(want).max()))
                                     - 7)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    _assert_same_tree(jcache, tcache)
    step = jax.jit(lambda p, c, e, pos: jmodel.decode_step(
        p, jcfg, c, embeds=e, pos=pos))
    for pos in range(13, 18):
        e = _embeds((2, 1, 64), pos)
        jl, jcache = step(jparams, jcache, e, np.int32(pos))
        tl, tcache = tmodel.decode_step(tparams, tcfg, tcache, pos=pos,
                                        embeds=torch.from_numpy(e))
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl),
                                      err_msg=pos)
        _assert_same_tree(jcache, tcache)


def _train_pair():
    jcfg = jconfigs.get_reduced(ARCH)
    tcfg = tconfigs.get_reduced(ARCH)
    jparams, _ = jmodel.init(jax.random.PRNGKey(0), jcfg)
    tparams = tmodel.train_params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), tcfg, "cpu")
    return jcfg, jparams, tcfg, tparams


def test_embeds_forward_and_loss_equal_the_reference():
    jcfg, jparams, tcfg, tparams = _train_pair()
    emb = _embeds((2, SEQ, 64), 4)
    labels = np.random.default_rng(4).integers(
        -1, tcfg.vocab_size, (2, SEQ)).astype(np.int32)
    want, _ = jax.jit(lambda p, e: jmodel.forward(p, jcfg, embeds=e))(
        jparams, emb)
    loss, _ = jax.jit(lambda p, b: jmodel.loss_fn(p, jcfg, b))(
        jparams, {"embeds": emb, "labels": labels})
    with torch.no_grad():
        got, _ = tmodel.forward(tparams, tcfg, embeds=torch.from_numpy(emb))
        tloss, _ = tmodel.loss_fn(tparams, tcfg, {
            "embeds": torch.from_numpy(emb),
            "labels": torch.from_numpy(labels)})
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert abs(float(tloss) - float(loss)) <= 2 * np.spacing(
        np.float32(loss))


def test_step0_qat_gradients_equal_the_reference():
    jcfg, jparams, tcfg, tparams = _train_pair()
    batch = JDataset(JDataConfig(vocab_size=jcfg.vocab_size, seq_len=SEQ,
                                 global_batch=BATCH)).batch_at(0)
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda p, b: jmodel.loss_fn(p, jcfg, b), has_aux=True))(
            jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    tloss, _, tgrads = loop.loss_and_grads(
        tparams, tcfg, {k: torch.from_numpy(np.array(v))
                        for k, v in batch.items()})
    assert abs(float(tloss) - float(loss)) <= 2 * np.spacing(
        np.float32(loss))
    want = jax.tree_util.tree_leaves(grads)
    got = tmodel.reference_leaves(tcfg, tgrads)
    paths = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(grads)[0]]
    assert len(want) == len(got) == len(paths)
    for path, a, b in zip(paths, want, got):
        b = (torch.stack(list(b)) if isinstance(b, list) else b).numpy()
        a = np.asarray(a)
        assert a.shape == b.shape, path
        assert np.abs(a - b).max() <= GRAD_RTOL * np.abs(a).max(), path


# ---------------------------------------------------------------------------
# the continuous engine
# ---------------------------------------------------------------------------

SERVE = dict(max_seq=40, max_slots=3, page_size=4, num_pages=40,
             prefix_cache=True, prefill_chunk=8)


def _prompts():
    """Four prompts through three slots, two sharing a 12-token head."""
    rng = np.random.default_rng(5)
    head = rng.integers(0, 512, (12,)).astype(np.int32)
    out = [np.concatenate([head, rng.integers(0, 512, (4,))]).astype(
        np.int32) for _ in range(2)]
    out += [rng.integers(0, 512, (n,)).astype(np.int32) for n in (16, 9)]
    return out


def _run(engine):
    ids = [engine.submit(p, 6) for p in _prompts()]
    out = engine.run()
    return [out[i] for i in ids], engine.cache_stats()


@pytest.fixture(scope="module")
def reference_streams():
    jcfg, jparams, _, _ = _pair(ENGINE_SEED)
    return _run(JEngine(jparams, jcfg, JServeConfig(**SERVE)))[0]


@pytest.mark.parametrize("mode", ["ragged", "megakernel"])
def test_continuous_engine_streams_equal_the_reference(mode,
                                                        reference_streams):
    _, _, tcfg, tparams = _pair(ENGINE_SEED)
    eng = ContinuousBatchingEngine(
        tparams, tcfg, ServeConfig(**SERVE, step_mode=mode), device="cpu")
    got, stats = _run(eng)
    assert stats["step_mode"] == mode
    assert stats["prefix_hit_tokens"] > 0
    assert stats["min_top2_gap_ulps"] > GAP_TOL_ULPS
    for g, w in zip(got, reference_streams):
        np.testing.assert_array_equal(g, w)


def test_train_launcher_trains_llava():
    """The launcher's token batches (the reference's pipeline), two MXFP8
    QAT steps of reduced llava on the CPU: finite losses, the reference
    data's step count."""
    from repro_torch.launch import train as launch_train

    report = launch_train.main(["--arch", ARCH, "--reduced", "--device",
                                "cpu", "--steps", "2", "--seq-len", "16",
                                "--global-batch", "4"])
    assert report["final_step"] == 2 and report["steps"] == [0, 1]
    assert all(np.isfinite(report["loss"]))
