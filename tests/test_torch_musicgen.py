"""musicgen-medium against the JAX reference on the CPU, reduced (2
layers, d_model 64, 4 MHA heads of 16, a GELU FFN of 128, 4 codebooks of
128): the reference's weights carried over by ``model.params_from_jax``,
RMSNorm scales drawn from N(0, 0.25) so that every norm weighs in.

Bars, each measured on this host:

  * the no-gate GELU FFN (``ffn.apply(kind="gelu")``): bit-equal to the
    jitted reference's on rows of scale 1 and 8, and on rows small
    enough that the up product's GELU meets subnormals (flushed, C2);
  * the codebook embedding, (B, S, 4) tokens offset by ``c * V``,
    gathered and summed in f32 in codebook order, rounded once:
    bit-equal; tokens of another shape raise ``ValueError``;
  * dense prefill's (B, 1, 4, V) logits and contiguous cache, then four
    greedy decode frames (argmax per codebook) on the port's own cache:
    logits and caches bit-equal;
  * the training forward (``model.forward`` over the f32 masters, MXFP8
    QAT): logits within FORWARD_TOL_ULPS bf16 ulps of the largest, argmax
    equal. Measured: bit-equal, since the LM head's product sums in
    XLA:CPU's order (``embedding._HeadCPU``; torch's CPU product left
    one of 16,384 logits one ulp apart);
  * ``loss_fn`` on (B, S, 4) labels, on a codebook stack with a SwiGLU
    FFN (musicgen's own GELU stack: ``test_torch_train_musicgen.py``):
    loss within two f32 ulps, every gradient leaf (the tied 512-row
    codebook table's scatter-add among them) within GRAD_RTOL of its
    largest (``tests/test_torch_train.py``'s bar). Measured: the loss one
    ulp apart, the gradients within 3.0e-6 of their leaf's largest, 7 of
    11 leaves bit-equal;
  * two ragged steps over shared pools, and the same through the
    megakernel step (the reference's #8 in Pallas interpret mode, the
    port's plain version): logits (R, 4, V) and every pool byte
    bit-equal;
  * the engines and the launcher refuse codebook heads with the
    reference's exception types; the train launcher trains musicgen.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro import configs as jconfigs  # noqa: E402
from repro.data import DataConfig as JDataConfig  # noqa: E402
from repro.data import SyntheticLMDataset as JDataset  # noqa: E402
from repro.launch import serve as jlaunch  # noqa: E402
from repro.nn import ffn as jffn  # noqa: E402
from repro.nn import model as jmodel  # noqa: E402
from repro.serve import ContinuousBatchingEngine as JEngine  # noqa: E402
from repro.serve import FixedSlotEngine as JFixed  # noqa: E402
from repro.serve import ServeConfig as JServeConfig  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.launch import serve as tlaunch  # noqa: E402
from repro_torch.launch import train as tlaunch_train  # noqa: E402
from repro_torch.nn import ffn as tffn  # noqa: E402
from repro_torch.nn import model as tmodel  # noqa: E402
from repro_torch.serve import (ContinuousBatchingEngine,  # noqa: E402
                               FixedSlotEngine, ServeConfig)
from repro_torch.train import loop  # noqa: E402

ARCH = "musicgen-medium"
CB, V = 4, 128
FORWARD_TOL_ULPS = 1
GRAD_RTOL = 5e-3
SEQ, BATCH = 16, 4


def _pair(**over):
    """Both packages' reduced musicgen as served (weight-only MX, an MX
    KV cache) on the reference's weights, norm scales from N(0, 0.25)."""
    quant = dict(quantize_acts=False, quantize_kv_cache=True)
    jcfg = jconfigs.get_reduced(ARCH)
    tcfg = tconfigs.get_reduced(ARCH)
    jcfg = jcfg.replace(quant=jcfg.quant.replace(**quant), **over)
    tcfg = tcfg.replace(quant=tcfg.quant.replace(**quant), **over)
    jparams, _ = jmodel.init(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(0)

    def scales(path, leaf):
        leaf = np.asarray(leaf)
        if jax.tree_util.keystr(path).endswith("['scale']"):
            leaf = leaf + 0.5 * rng.standard_normal(leaf.shape).astype(
                np.float32)
        return leaf
    jparams = jax.tree_util.tree_map_with_path(scales, jparams)
    return jcfg, jparams, tcfg, tmodel.params_from_jax(jparams, tcfg, "cpu")


@pytest.fixture(scope="module")
def pair():
    return _pair(decode_kernel="fused")


def _np(t):
    if t.dtype in (torch.float8_e4m3fn, torch.float8_e5m2):
        return t.view(torch.uint8).numpy()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy()


def _jnp(a):
    a = np.asarray(a)
    if a.dtype.itemsize == 1 and a.dtype.kind not in "iub":
        return a.view(np.uint8)
    if a.dtype.itemsize == 2 and a.dtype.kind not in "iub":
        return a.view(np.int16)
    return a


def _assert_same_tree(jtree, ttree):
    for path, leaf in jax.tree_util.tree_leaves_with_path(jtree):
        node = ttree
        for k in path:
            node = node[k.key if hasattr(k, "key") else k.idx]
        np.testing.assert_array_equal(_np(node), _jnp(leaf),
                                      err_msg=jax.tree_util.keystr(path))


def _frames(shape, seed):
    return np.random.default_rng(seed).integers(0, V, shape).astype(np.int32)


# ---------------------------------------------------------------------------
# the layers
# ---------------------------------------------------------------------------


def test_gelu_ffn_has_no_gate_and_equals_the_reference(pair):
    jcfg, jparams, tcfg, tparams = pair
    layer = tparams["layers"][0]["ffn"]
    assert set(layer) == {"up", "down"}
    gen = torch.Generator().manual_seed(0)
    assert set(tffn.init(gen, 64, 128, tcfg.quant, "cpu", "gelu")) == \
        {"up", "down"}
    assert set(tffn.init_train(gen, 64, 128, "cpu", "gelu")) == \
        {"up", "down"}
    lp = jax.tree_util.tree_map(lambda a: a[0],
                                jparams["groups"]["block0"]["ffn"])
    fn = jax.jit(lambda p, x: jffn.apply(p, x, jcfg.quant, "gelu"))
    rng = np.random.default_rng(4)
    for scale in (1.0, 8.0, 1e-36):
        x = jnp.asarray(scale * rng.standard_normal((3, 7, 64)),
                        jnp.bfloat16)
        want = fn(lp, x)
        got = tffn.apply(layer, torch.from_numpy(np.array(
            x.astype(jnp.float32))).bfloat16(), "gelu")
        np.testing.assert_array_equal(_np(got), _jnp(want), err_msg=scale)
    with pytest.raises(ValueError, match="ffn kind"):
        tffn.apply(layer, torch.zeros((1, 1, 64), dtype=torch.bfloat16),
                   "relu")


def test_codebook_embedding_equals_the_reference(pair):
    jcfg, jparams, tcfg, tparams = pair
    assert tparams["embedding"]["embed"].shape == (CB * V, 64)
    toks = _frames((2, 9, CB), 1)
    want = jax.jit(lambda p, t: jmodel._embed_inputs(p, jcfg, t))(jparams,
                                                                  toks)
    got = tmodel._embed(tparams, tcfg, torch.from_numpy(toks).long())
    np.testing.assert_array_equal(_np(got), _jnp(want))
    with pytest.raises(ValueError, match="codebook tokens"):
        tmodel._embed(tparams, tcfg, torch.from_numpy(toks[..., 0]).long())


# ---------------------------------------------------------------------------
# the model functions
# ---------------------------------------------------------------------------


def test_prefill_and_decode_frames_equal_the_reference(pair):
    """Dense prefill of 13 frames, then four greedy decode frames, each
    side on its own cache: logits and caches bit-equal throughout."""
    jcfg, jparams, tcfg, tparams = pair
    toks = _frames((2, 13, CB), 2)
    jl, jcache = jax.jit(lambda p, t: jmodel.prefill(
        p, jcfg, tokens=t, max_seq=24))(jparams, toks)
    tl, tcache = tmodel.prefill(tparams, tcfg, torch.from_numpy(toks).long(),
                                max_seq=24)
    assert tl.shape == (2, 1, CB, V)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    _assert_same_tree(jcache, tcache)
    step = jax.jit(lambda p, c, t, pos: jmodel.decode_step(
        p, jcfg, c, tokens=t, pos=pos))
    for pos in range(13, 17):
        frame = np.asarray(jl)[:, -1].argmax(-1).astype(np.int32)[:, None]
        jl, jcache = step(jparams, jcache, frame, np.int32(pos))
        tl, tcache = tmodel.decode_step(tparams, tcfg, tcache,
                                        torch.from_numpy(frame).long(), pos)
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl),
                                      err_msg=pos)
        _assert_same_tree(jcache, tcache)


def test_training_forward_within_an_ulp_of_the_reference():
    jcfg = jconfigs.get_reduced(ARCH)
    tcfg = tconfigs.get_reduced(ARCH)
    jparams, _ = jmodel.init(jax.random.PRNGKey(0), jcfg)
    tparams = tmodel.train_params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), tcfg, "cpu")
    toks = _frames((2, SEQ, CB), 3)
    want, _ = jax.jit(lambda p, t: jmodel.forward(p, jcfg, tokens=t))(
        jparams, toks)
    with torch.no_grad():
        got, _ = tmodel.forward(tparams, tcfg, torch.from_numpy(toks).long())
    want, got = np.asarray(want), got.numpy()
    assert got.shape == (2, SEQ, CB, V)
    tol = FORWARD_TOL_ULPS * 2.0 ** (np.floor(np.log2(np.abs(want).max()))
                                     - 7)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    # the GELU's gradient flows: a backward through the same forward
    # reaches the up projection (its bits: test_torch_train_musicgen.py)
    w_up = tparams["layers"][0]["ffn"]["up"]["w"].requires_grad_(True)
    logits, _ = tmodel.forward(tparams, tcfg, torch.from_numpy(toks).long())
    (g,) = torch.autograd.grad(logits.square().sum(), w_up)
    assert torch.isfinite(g).all() and g.abs().max() > 0


def test_codebook_loss_and_gradients_equal_the_reference():
    """``loss_fn`` on (B, S, 4) labels from the reference's data pipeline
    with codebooks, on reduced musicgen with a SwiGLU FFN (a codebook
    stack that trains here): loss within two f32 ulps, every gradient
    leaf (the 512-row table's scatter-add included) within GRAD_RTOL of
    its largest."""
    jcfg = jconfigs.get_reduced(ARCH).replace(ffn_kind="swiglu")
    tcfg = tconfigs.get_reduced(ARCH).replace(ffn_kind="swiglu")
    jparams, _ = jmodel.init(jax.random.PRNGKey(0), jcfg)
    batch = JDataset(JDataConfig(vocab_size=V, seq_len=SEQ,
                                 global_batch=BATCH,
                                 num_codebooks=CB)).batch_at(0)
    assert batch["labels"].shape == (BATCH, SEQ, CB)
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda p, b: jmodel.loss_fn(p, jcfg, b), has_aux=True))(
            jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    tparams = tmodel.train_params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), tcfg, "cpu")
    tloss, _, tgrads = loop.loss_and_grads(
        tparams, tcfg, {k: torch.from_numpy(np.array(v))
                        for k, v in batch.items()})
    assert abs(float(tloss) - float(loss)) <= 2 * np.spacing(
        np.float32(loss))
    want = jax.tree_util.tree_leaves(grads)
    got = tmodel.reference_leaves(tcfg, tgrads)
    assert len(want) == len(got)
    for a, b in zip(want, got):
        b = (torch.stack(list(b)) if isinstance(b, list) else b).numpy()
        a = np.asarray(a)
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= GRAD_RTOL * np.abs(a).max()


# ---------------------------------------------------------------------------
# the paged steps: ragged and megakernel
# ---------------------------------------------------------------------------


def _ragged_steps():
    """Two steps of R=4 rows, W=16, page size 4: prompts of 16 and 11
    frames, a one-frame row and an idle row; then decode rows and a
    continuation chunk."""
    table = np.full((4, 8), -1, np.int32)
    table[0, :5] = [0, 1, 2, 3, 8]
    table[1, :4] = [4, 5, 6, 9]
    table[2, :2] = [7, 10]
    return table, [dict(starts=[0, 0, 0, 0], lens=[16, 11, 1, 1],
                        lidx=[15, 10, 0, 0]),
                   dict(starts=[16, 11, 1, 0], lens=[17, 16, 2, 1],
                        lidx=[0, 4, 0, 0])]


@pytest.mark.parametrize("mode", ["ragged", "megakernel"])
def test_paged_steps_equal_the_reference(pair, mode):
    """The reference's ragged step (its Pallas kernel in interpret mode)
    or megakernel step (#8 in interpret mode, the GELU tail) against the
    port's (plain versions on the CPU): logits and pools bit-equal."""
    jcfg, jparams, tcfg, tparams = pair
    num_pages, ps = 13, 4
    if mode == "ragged":
        jcache = jmodel.init_paged_cache(jcfg, 4, num_pages, ps)
        jfn, tfn = jmodel.ragged_step_paged, tmodel.ragged_step_paged
    else:
        jcache = jmodel.init_megakernel_cache(jcfg, 4, num_pages, ps)
        jparams = jmodel.pack_megakernel_params(jparams, jcfg)
        jfn, tfn = jmodel.megakernel_step_paged, tmodel.megakernel_step_paged
    tcache = tmodel.init_paged_cache(tcfg, num_pages, ps, "cpu")
    step = jax.jit(lambda p, c, *a: jfn(p, jcfg, c, *a))
    table, steps = _ragged_steps()
    for i, meta in enumerate(steps):
        args = [_frames((4, 16, CB), 5 + i), table] + [
            np.asarray(meta[k], np.int32) for k in ("starts", "lens", "lidx")]
        want, jcache = step(jparams, jcache, *args)
        got = tfn(tparams, tcfg, tcache, *(torch.from_numpy(a) for a in args))
        assert got.shape == (4, CB, V)
        np.testing.assert_array_equal(got.numpy()[:3],
                                      np.asarray(want)[:3, 0])
        layout = tmodel.reference_cache_leaves(tcfg, tcache)
        for jleaf, (key, layers, stacked) in zip(
                jax.tree_util.tree_leaves(jcache), layout):
            g = [tcache[li][key].view(torch.uint8).numpy() for li in layers]
            np.testing.assert_array_equal(np.stack(g) if stacked else g[0],
                                          np.asarray(jleaf).view(np.uint8),
                                          err_msg=key)


# ---------------------------------------------------------------------------
# no engine serves codebook heads, as in the reference
# ---------------------------------------------------------------------------


def _raised(fn):
    with pytest.raises(Exception) as info:
        fn()
    return info.value


def test_engines_refuse_codebook_heads_as_the_reference(pair):
    jcfg, jparams, tcfg, tparams = pair
    serve = dict(max_seq=24, max_slots=2, page_size=4, num_pages=16)
    want = _raised(lambda: JEngine(jparams, jcfg, JServeConfig(**serve)))
    got = _raised(lambda: ContinuousBatchingEngine(
        tparams, tcfg, ServeConfig(**serve), device="cpu"))
    assert type(got) is type(want) is NotImplementedError
    assert str(got) == str(want)
    frames = _frames((2, 6, CB), 7)
    want = _raised(lambda: JFixed(jparams, jcfg, JServeConfig(
        **serve)).generate(frames, 2))
    got = _raised(lambda: FixedSlotEngine(tparams, tcfg, ServeConfig(
        **serve), device="cpu").generate(frames, 2))
    assert type(got) is type(want) is ValueError


@pytest.mark.parametrize("engine", ["continuous", "fixed"])
def test_serve_launcher_refuses_musicgen_as_the_reference(engine):
    argv = ["--arch", ARCH, "--reduced", "--batch", "2", "--prompt-len",
            "6", "--new-tokens", "2", "--engine", engine]
    want = _raised(lambda: jlaunch.main(argv + ["--quant", "mxfp8",
                                                "--quantize-kv"]))
    got = _raised(lambda: tlaunch.main(argv + ["--device", "cpu"]))
    assert type(got) is type(want)
    assert type(got) is (NotImplementedError if engine == "continuous"
                         else ValueError)


def test_train_launcher_refuses_musicgen_naming_a9b():
    """The train launcher refused musicgen naming A9b until its GELU's
    gradient was ported; it now trains reduced musicgen one step on (B,
    S, 4) codebook batches."""
    report = tlaunch_train.main(["--arch", ARCH, "--reduced", "--device",
                                 "cpu", "--steps", "1", "--seq-len", "16",
                                 "--global-batch", "4"])
    assert report["final_step"] == 1 and np.isfinite(report["loss"][0])
