"""gemma2's training path in the port against the jitted reference, on
the CPU: the gradients of XLA:CPU's tanh (``core.host_math``'s ``tanh``,
``gelu_tanh`` and ``softcap``), GeGLU's backward, both softcaps',
gemma2's blocks (sandwich post-norms, the local layer's window) and
reduced gemma2-2b's step-0 loss and gradients, and three train steps.

Same numpy-seeded inputs and the reference's own params (its ``init``,
carried over by ``model.train_params_from_jax``). Bars, and what was
measured on this host (jax 0.9.0, torch 2.13; ``python
tests/test_torch_train.py`` prints the model-level values):

  * the three host gradients, GeGLU's, both softcaps' and each block's
    gradients: bit-equal;
  * reduced gemma2-2b's step-0 loss within two f32 ulps (two apart);
    every weight gradient and the embedding's bit-equal, the RMSNorm
    scales' within NORM_SCALE_RTOL of the leaf's largest (3.4e-7: XLA
    sums them over the rows in an order of its own, as for phi4-mini in
    ``tests/test_torch_train.py``). Reduced gemma2-9b is the same config;
  * three train steps at the bars of ``tests/test_torch_train.py``:
    losses within LOSS_RTOL, grad norms within GNORM_RTOL, each param
    leaf within PARAM_TOL of the reference's own movement (measured:
    1.7e-5, 9.2e-4 and 0.0026).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro.configs import get_reduced as jget_reduced  # noqa: E402
from repro.data import DataConfig as JDataConfig  # noqa: E402
from repro.data import SyntheticLMDataset as JDataset  # noqa: E402
from repro.nn import attention as jattention  # noqa: E402
from repro.nn import blocks as jblocks  # noqa: E402
from repro.nn import embedding as jemb  # noqa: E402
from repro.nn import ffn as jffn  # noqa: E402
from repro.nn import model as jmodel  # noqa: E402
from repro.train import OptimConfig as JOptimConfig  # noqa: E402
from repro.train import init_state as jinit_state  # noqa: E402
from repro.train import make_train_step as jmake_train_step  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.kernels import mx_matmul  # noqa: E402
from repro_torch.kernels.ops import _tile  # noqa: E402
from repro_torch.core import host_math  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.nn import blocks, embedding, ffn, model  # noqa: E402
from repro_torch.train import OptimConfig, loop, optim  # noqa: E402

ARCH = "gemma2-2b"
NORM_SCALE_RTOL = 1e-6
LOSS_RTOL = 5e-3
GNORM_RTOL = 2e-2
PARAM_TOL = 0.15
SEQ, BATCH = 16, 4
#: XLA:CPU's tanh: x itself below this magnitude, its clamp above
SMALL, CLAMP = 0.0004, 7.99881172180175781


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _t(x):
    return torch.from_numpy(np.array(x))


def _same(got, want, what=""):
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    np.testing.assert_array_equal(got, _np(want), err_msg=what)


def _edges(seed: int) -> np.ndarray:
    """Normal values at several scales, the tanh's branch points and
    their neighbours (small-x pass-through, the clamp, +-20),
    subnormals and zeros."""
    rng = np.random.default_rng(seed)
    x = np.concatenate([rng.standard_normal(1 << 14) * s
                        for s in (3e-4, 0.3, 3.0, 30.0, 300.0)])
    pts = np.float32([SMALL, CLAMP, 20.0, 1e-39, 0.0])
    near = np.concatenate([np.nextafter(pts, np.float32(np.inf)),
                           np.nextafter(pts, np.float32(-np.inf)), pts])
    return np.concatenate([x, near, -near]).astype(np.float32)


FUNCS = {
    "tanh": (jnp.tanh, host_math.tanh, 1.0),
    "gelu_tanh": (lambda v: jax.nn.gelu(v, approximate=True),
                  host_math.gelu_tanh, 1.0),
    # the softcaps see logits of tens, so their inputs are scaled up
    "softcap50": (lambda v: jnp.tanh(v / 50.0) * 50.0,
                  lambda v: host_math.softcap(v, 50.0), 50.0),
    "softcap30": (lambda v: jnp.tanh(v / 30.0) * 30.0,
                  lambda v: host_math.softcap(v, 30.0), 30.0),
}


@pytest.mark.parametrize("name", sorted(FUNCS))
def test_host_tanh_gradients_equal_the_jitted_reference(name):
    """Value and input gradient bit-equal to ``jax.jit`` of the function
    and of its vjp, over normal values, the tanh's small-x branch and its
    clamp at +-7.99881172 (``x / cap`` there for the softcaps), +-20,
    subnormals and signed zeros."""
    jfn, tfn, scale = FUNCS[name]
    x = _edges(len(name)) * np.float32(scale)
    g = np.random.default_rng(1).standard_normal(x.size).astype(np.float32)
    g[-3:] = np.float32([1e-39, -0.0, 3.0])
    want_y, want_g = jax.jit(
        lambda a, b: (jfn(a), jax.vjp(jfn, a)[1](b)[0]))(x, g)
    xt = _t(x).requires_grad_(True)
    y = tfn(xt)
    (got_g,) = torch.autograd.grad(y, xt, _t(g))
    _same(y, want_y, "value")
    _same(got_g, want_g, "gradient")


def test_exp_logistic_softplus_still_refuse_a_gradient():
    x = torch.ones(4, requires_grad=True)
    for fn in (host_math.exp, host_math.logistic, host_math.softplus):
        with pytest.raises(ValueError, match="A9b"):
            fn(x)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def pair():
    jcfg, cfg = jget_reduced(ARCH), get_reduced(ARCH)
    params, _ = jmodel.init(jax.random.PRNGKey(0), jcfg)
    tp = model.train_params_from_jax(
        jax.tree_util.tree_map(np.asarray, params), cfg, "cpu")
    return jcfg, cfg, params, tp


def _bf16(shape, seed, scale=1.0):
    x = np.random.default_rng(seed).standard_normal(shape) * scale
    return jnp.asarray(x.astype(np.float32)).astype(jnp.bfloat16)


def _leaf_grads(tree):
    leaves = model.leaves(tree)
    for leaf in leaves:
        leaf.requires_grad_(True)
    return leaves


def test_geglu_ffn_gradients_equal_the_reference(pair):
    """QAT GeGLU: output, input gradient and the three weight gradients
    bit-equal (the backward through ``bf16(bf16(gelu(gate)) * up)``)."""
    jcfg, cfg, params, tp = pair
    lp = jax.tree_util.tree_map(lambda a: a[0],
                                params["groups"]["block0"]["ffn"])
    x, dy = _bf16((BATCH, SEQ, 64), 3, 2.0), _bf16((BATCH, SEQ, 64), 4)

    def f(p, x):
        return jffn.apply(p, x, jcfg.quant, "geglu")

    y, (gp, gx) = jax.jit(lambda p, x, c: (f(p, x), jax.vjp(f, p, x)[1](c)))(
        lp, x, dy)
    tparams = {k: {"w": v["w"].detach().clone()}
               for k, v in tp["layers"][0]["ffn"].items()}
    leaves = _leaf_grads(tparams)
    xt = _t(_np(x)).bfloat16().requires_grad_(True)
    yt = ffn.apply(tparams, xt, "geglu", torch.bfloat16, cfg.quant)
    got = torch.autograd.grad(yt, [xt] + leaves, _t(_np(dy)).bfloat16())
    _same(yt, y, "y")
    _same(got[0], gx, "dx")
    for g, w in zip(got[1:], jax.tree_util.tree_leaves(gp)):
        _same(g, w, "dw")


@pytest.mark.parametrize("block", [0, 1])
def test_block_gradients_equal_the_reference(pair, block):
    """Reduced gemma2's local (window 8) and global block over 16 tokens,
    norm scales drawn from N(0, 0.25), training forward and vjp: QAT
    projections, the attention softcap, the sandwich post-norms, GeGLU.
    Output, input gradient and every weight gradient bit-equal, the norm
    scales' within NORM_SCALE_RTOL. The local layer's window masks keys
    at this length."""
    jcfg, cfg, params, tp = pair
    bd = jcfg.pattern[block]
    pos = np.broadcast_to(np.arange(SEQ, dtype=np.int32), (BATCH, SEQ))
    if bd.window:
        mask = np.asarray(jattention._mask(pos, pos, None)
                          & ~jattention._mask(pos, pos, bd.window))
        assert mask.any()  # causal keys the window drops
    rng = np.random.default_rng(block)

    def scaled(path, leaf):  # norm scales from N(0, 0.25): (1 + w) weighs in
        leaf = np.array(leaf[0])
        if jax.tree_util.keystr(path).endswith("['scale']"):
            leaf += 0.5 * rng.standard_normal(leaf.shape).astype(np.float32)
        return leaf

    lp = jax.tree_util.tree_map_with_path(scaled,
                                          params["groups"][f"block{block}"])
    x, dy = _bf16((BATCH, SEQ, 64), 5 + block), _bf16((BATCH, SEQ, 64), 7)

    def f(p, x):
        return jblocks.apply_train(p, x, pos, bd, jcfg)[0]

    y, (gp, gx) = jax.jit(lambda p, x, c: (f(p, x), jax.vjp(f, p, x)[1](c)))(
        lp, x, dy)
    tparams = optim.tree_like(lambda t: t, jax.tree_util.tree_map(
        lambda a: torch.from_numpy(np.array(a)), lp))
    leaves = _leaf_grads(tparams)
    xt = _t(_np(x)).bfloat16().requires_grad_(True)
    yt = blocks.apply_train(tparams, xt, _t(pos), cfg.pattern[block],
                            cfg)[0].bfloat16()
    got = torch.autograd.grad(yt, [xt] + leaves, _t(_np(dy)).bfloat16())
    _same(yt, y, "y")
    _same(got[0], gx, "dx")
    paths = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(gp)[0]]
    for path, g, w in zip(paths, got[1:], jax.tree_util.tree_leaves(gp)):
        w = np.asarray(w)
        if path.endswith("['scale']"):
            err = np.abs(g.numpy() - w).max() / np.abs(w).max()
            assert err <= NORM_SCALE_RTOL, (path, err)
        else:
            _same(g, w, path)


def test_logit_softcap_gradient_equals_the_reference(pair):
    """The tied head with the final softcap 30: f32 logits and the
    gradients of the hidden states and the table bit-equal."""
    jcfg, cfg, params, tp = pair
    x = _bf16((BATCH, SEQ, 64), 9, 4.0)
    g = np.random.default_rng(10).standard_normal(
        (BATCH, SEQ, cfg.vocab_size)).astype(np.float32) * 0.01

    def f(p, x):
        return jemb.logits(p, x, jcfg.logit_softcap)

    y, (gp, gx) = jax.jit(lambda p, x, c: (f(p, x), jax.vjp(f, p, x)[1](c)))(
        params["embedding"], x, g)
    table = tp["embedding"]["embed"].detach().clone().requires_grad_(True)
    xt = _t(_np(x)).bfloat16().requires_grad_(True)
    yt = embedding.logits({"embed": table}, xt,
                          softcap=cfg.logit_softcap)
    gxt, gtt = torch.autograd.grad(yt, (xt, table), _t(g))
    _same(yt, y, "logits")
    _same(gxt, gx, "dx")
    _same(gtt, gp["embed"], "d table")


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def _batch(jcfg, step=0):
    ds = JDataset(JDataConfig(vocab_size=jcfg.vocab_size, seq_len=SEQ,
                              global_batch=BATCH))
    return ds.batch_at(step)


@pytest.fixture(scope="module")
def grads(pair):
    jcfg, cfg, params, tp = pair
    batch = _batch(jcfg)
    fn = jax.jit(jax.value_and_grad(
        lambda p, b: jmodel.loss_fn(p, jcfg, b), has_aux=True))
    (loss, _), jgrads = fn(params, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
    tloss, _, tgrads = loop.loss_and_grads(
        tp, cfg, {k: _t(v) for k, v in batch.items()})
    return float(loss), jgrads, float(tloss), tgrads


def test_reduced_loss_equals_the_reference(grads):
    loss, _, tloss, _ = grads
    assert abs(tloss - loss) <= 2 * np.spacing(np.float32(loss)), (tloss,
                                                                   loss)


def test_every_reduced_gradient_leaf_equals_the_reference(pair, grads):
    """Embedding (the tied head's transpose meets the scatter-add), both
    blocks' projections and norms, the final norm: weights bit-equal,
    norm scales within NORM_SCALE_RTOL of the leaf's largest."""
    _, cfg, _, _ = pair
    _, jgrads, _, tgrads = grads
    want = jax.tree_util.tree_leaves(jgrads)
    got = model.reference_leaves(cfg, tgrads)
    paths = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(jgrads)[0]]
    assert len(want) == len(got) == len(paths) == 24
    for path, a, b in zip(paths, want, got):
        b = (torch.stack(list(b)) if isinstance(b, list) else b).numpy()
        a = np.asarray(a)
        assert a.shape == b.shape, path
        if path.endswith("['scale']"):
            err = np.abs(a - b).max() / np.abs(a).max()
            assert err <= NORM_SCALE_RTOL, (path, err)
        else:
            np.testing.assert_array_equal(b, a, err_msg=path)


def test_three_train_steps_track_the_reference():
    """``make_train_step`` (remat full, one microbatch) against the
    reference's jitted step from the same state over the same three
    batches, at ``tests/test_torch_train.py``'s bars."""
    jcfg, cfg = jget_reduced(ARCH), get_reduced(ARCH)
    kw = dict(lr=3e-3, warmup_steps=1, total_steps=3)
    jstate, _ = jinit_state(jax.random.PRNGKey(0), jcfg)
    start = [np.asarray(x) for x in jax.tree_util.tree_leaves(
        jstate["params"])]
    params = model.train_params_from_jax(
        jax.tree_util.tree_map(np.asarray, jstate["params"]), cfg, "cpu")
    loop.trainable(params)
    tstate = {"params": params, "opt": optim.init(params)}
    jstep = jax.jit(jmake_train_step(jcfg, JOptimConfig(**kw), 1))
    tstep = loop.make_train_step(cfg, OptimConfig(**kw), 1)
    for s in range(3):
        batch = _batch(jcfg, s)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in
                                    batch.items()})
        tstate, tm = tstep(tstate, {k: _t(v) for k, v in batch.items()})
        assert np.isfinite(float(tm["loss"]))
        assert abs(float(tm["loss"]) - float(jm["loss"])) \
            <= LOSS_RTOL * abs(float(jm["loss"]))
        assert abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) \
            <= GNORM_RTOL * float(jm["grad_norm"])
    want = jax.tree_util.tree_leaves(jstate["params"])
    got = model.reference_leaves(cfg, tstate["params"])
    for a, b, a0 in zip(want, got, start):
        b = (torch.stack(list(b)) if isinstance(b, list) else b)
        a, b = np.asarray(a), b.detach().numpy()
        moved = np.linalg.norm(a - a0)
        assert moved > 0
        assert np.linalg.norm(a - b) <= PARAM_TOL * moved


@pytest.mark.parametrize("arch", ["gemma2-2b", "gemma2-9b"])
def test_train_launcher_configures_and_trains_gemma2(arch):
    """Both gemma2 archs pass ``configure`` at full width; the reduced
    launcher runs two CPU steps with finite losses."""
    args = launch_train.parse_args(["--arch", arch, "--device", "cpu"])
    cfg, _ = launch_train.configure(args)
    assert cfg.post_norms and cfg.logit_softcap and cfg.num_layers == (
        26 if arch == "gemma2-2b" else 42)
    report = launch_train.main(["--arch", arch, "--reduced", "--device",
                                "cpu", "--steps", "2", "--seq-len", "16",
                                "--global-batch", "4"])
    assert report["final_step"] == 2
    assert all(np.isfinite(report["loss"]))


@pytest.mark.parametrize("m,k,n", [(1024, 2304, 9216), (1024, 9216, 2304)])
def test_qat_pallas_tiles_at_the_training_shapes(m, k, n):
    """#10's plan (``mx_matmul.matmul_plan``) at gemma2-2b's gate/up and
    down products of a launcher step (1,024 tokens): one CTA a tile, no
    split of the contraction; the gate/up product takes the cp.async
    ring at 64 rows (72 blocks of 32 are not a multiple of 16)."""
    plan = mx_matmul.matmul_plan(m, n, k, max(_tile(k, 512), 32),
                                 "fp8_e4m3", 32, "mx", torch.float32)
    assert plan.splits == 1 and plan.ws_slots == 0
    assert plan.m_tiles * plan.bm >= m and plan.k_tiles * max(
        _tile(k, 512), 32) == k
    if k == 2304:
        assert (plan.lean, plan.bm) == (False, 64)
