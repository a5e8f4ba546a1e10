"""musicgen's training path in the port against the jitted reference, on
the CPU: the no-gate GELU FFN's backward, reduced musicgen-medium's
step-0 codebook loss and gradients, three train steps, and the train
launcher on (B, S, 4) codebook batches.

Same numpy-seeded inputs and the reference's own params (its ``init``,
carried over by ``model.train_params_from_jax``). Bars, and what was
measured on this host (jax 0.9.0, torch 2.13; ``python
tests/test_torch_train.py`` prints the model-level values):

  * the GELU FFN (QAT): output, input and weight gradients bit-equal;
  * reduced musicgen's step-0 loss within two f32 ulps (one apart);
    every weight gradient and the 512-row codebook table's bit-equal,
    the RMSNorm scales' within NORM_SCALE_RTOL of the leaf's largest
    (2.0e-7: XLA sums them over the rows in an order of its own, as for
    phi4-mini in ``tests/test_torch_train.py``);
  * three train steps at the bars of ``tests/test_torch_train.py``
    (measured: losses 2.0e-7 and grad norms 4.0e-7 apart, each param
    leaf within 1e-7 of the reference's own movement).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro.configs import get_reduced as jget_reduced  # noqa: E402
from repro.data import DataConfig as JDataConfig  # noqa: E402
from repro.data import SyntheticLMDataset as JDataset  # noqa: E402
from repro.nn import ffn as jffn  # noqa: E402
from repro.nn import model as jmodel  # noqa: E402
from repro.train import OptimConfig as JOptimConfig  # noqa: E402
from repro.train import init_state as jinit_state  # noqa: E402
from repro.train import make_train_step as jmake_train_step  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.kernels import mx_matmul  # noqa: E402
from repro_torch.kernels.ops import _tile  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.nn import ffn, model  # noqa: E402
from repro_torch.train import OptimConfig, loop, optim  # noqa: E402

ARCH = "musicgen-medium"
CB, V = 4, 128
NORM_SCALE_RTOL = 1e-6
LOSS_RTOL = 5e-3
GNORM_RTOL = 2e-2
PARAM_TOL = 0.15
SEQ, BATCH = 16, 4


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _t(x):
    return torch.from_numpy(np.array(x))


def _batch(step=0):
    ds = JDataset(JDataConfig(vocab_size=V, seq_len=SEQ, global_batch=BATCH,
                              num_codebooks=CB))
    return ds.batch_at(step)


@pytest.fixture(scope="module")
def pair():
    jcfg, cfg = jget_reduced(ARCH), get_reduced(ARCH)
    params, _ = jmodel.init(jax.random.PRNGKey(0), jcfg)
    tp = model.train_params_from_jax(
        jax.tree_util.tree_map(np.asarray, params), cfg, "cpu")
    return jcfg, cfg, params, tp


@pytest.mark.parametrize("scale", [1.0, 8.0])
def test_gelu_ffn_gradients_equal_the_reference(pair, scale):
    """QAT no-gate GELU, ``down(bf16(gelu(up(x))))``: output, input
    gradient and both weight gradients bit-equal."""
    jcfg, cfg, params, tp = pair
    lp = jax.tree_util.tree_map(lambda a: a[0],
                                params["groups"]["block0"]["ffn"])
    rng = np.random.default_rng(int(scale))
    x = jnp.asarray((rng.standard_normal((BATCH, SEQ, 64)) * scale).astype(
        np.float32)).astype(jnp.bfloat16)
    dy = jnp.asarray(rng.standard_normal((BATCH, SEQ, 64)).astype(
        np.float32)).astype(jnp.bfloat16)

    def f(p, x):
        return jffn.apply(p, x, jcfg.quant, "gelu")

    y, (gp, gx) = jax.jit(lambda p, x, c: (f(p, x), jax.vjp(f, p, x)[1](c)))(
        lp, x, dy)
    tparams = {k: {"w": v["w"].detach().clone().requires_grad_(True)}
               for k, v in tp["layers"][0]["ffn"].items()}
    assert sorted(tparams) == ["down", "up"]
    xt = _t(_np(x)).bfloat16().requires_grad_(True)
    yt = ffn.apply(tparams, xt, "gelu", torch.bfloat16, cfg.quant)
    got = torch.autograd.grad(yt, [xt, tparams["down"]["w"],
                                   tparams["up"]["w"]],
                              _t(_np(dy)).bfloat16())
    np.testing.assert_array_equal(yt.detach().float().numpy(), _np(y))
    np.testing.assert_array_equal(got[0].float().numpy(), _np(gx))
    for g, name in zip(got[1:], ("down", "up")):
        np.testing.assert_array_equal(g.numpy(), np.asarray(gp[name]["w"]),
                                      err_msg=name)


@pytest.fixture(scope="module")
def grads(pair):
    jcfg, cfg, params, tp = pair
    batch = _batch()
    assert batch["labels"].shape == (BATCH, SEQ, CB)
    fn = jax.jit(jax.value_and_grad(
        lambda p, b: jmodel.loss_fn(p, jcfg, b), has_aux=True))
    (loss, _), jgrads = fn(params, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
    tloss, _, tgrads = loop.loss_and_grads(
        tp, cfg, {k: _t(v) for k, v in batch.items()})
    return float(loss), jgrads, float(tloss), tgrads


def test_codebook_loss_equals_the_reference(grads):
    loss, _, tloss, _ = grads
    assert abs(tloss - loss) <= 2 * np.spacing(np.float32(loss)), (tloss,
                                                                   loss)


def test_every_codebook_gradient_leaf_equals_the_reference(pair, grads):
    _, cfg, _, _ = pair
    _, jgrads, _, tgrads = grads
    want = jax.tree_util.tree_leaves(jgrads)
    got = model.reference_leaves(cfg, tgrads)
    paths = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(jgrads)[0]]
    assert len(want) == len(got) == len(paths) == 10
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
    reference's jitted step over three codebook batches."""
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
        batch = _batch(s)
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


def test_train_launcher_takes_codebook_batches():
    """musicgen-medium passes ``configure`` at full width (48 layers);
    the reduced launcher runs two CPU steps on (B, S, 4) batches."""
    args = launch_train.parse_args(["--arch", ARCH, "--device", "cpu"])
    cfg, _ = launch_train.configure(args)
    assert cfg.num_layers == 48 and cfg.num_codebooks == CB
    report = launch_train.main(["--arch", ARCH, "--reduced", "--device",
                                "cpu", "--steps", "2", "--seq-len", "16",
                                "--global-batch", "4"])
    assert report["final_step"] == 2
    assert all(np.isfinite(report["loss"]))


@pytest.mark.parametrize("m,k,n", [(1024, 1536, 6144), (1024, 6144, 1536)])
def test_qat_pallas_tiles_at_the_training_shapes(m, k, n):
    """#10's plan (``mx_matmul.matmul_plan``) at musicgen-medium's gate/up and
    down products of a launcher step (1,024 tokens): one CTA a tile, no
    split of the contraction; the gate/up product takes the TMA ring at
    128 rows (48 blocks of 32)."""
    plan = mx_matmul.matmul_plan(m, n, k, max(_tile(k, 512), 32),
                                 "fp8_e4m3", 32, "mx", torch.float32)
    assert plan.splits == 1 and plan.ws_slots == 0
    assert plan.m_tiles * plan.bm >= m and plan.k_tiles * max(
        _tile(k, 512), 32) == k
    if k == 1536:
        assert (plan.lean, plan.bm) == (True, 128)
