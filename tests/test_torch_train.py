"""The port's training path against the JAX reference on the CPU.

Same numpy-seeded inputs and the reference's own params (its ``init``,
carried over by ``model.train_params_from_jax``) through the jitted
reference and the port, at reduced widths:

  * ``qat_matmul``'s forward and vjp (e4m3, e5m2 and fp4 operands,
    blocks 16 and 32, bf16 and f32 inputs) and ``fake_quant``'s
    straight-through gradient: bit-equal;
  * ``loss_fn`` and every gradient leaf of reduced phi4-mini (tied head)
    and granite-8b (untied head): phi4-mini's weight gradients bit-equal,
    its norm scales' within NORM_SCALE_RTOL of the leaf's largest (XLA
    sums them over the rows in an order of its own); granite-8b's within
    GRAD_RTOL of each leaf's largest (measured: its weight gradients
    bit-equal too, the norm scales as phi4-mini's);
  * ``optim.apply`` on the reference's gradients (f32 arithmetic with
    XLA's FMA contractions and its folded bias corrections; ``lr_at``
    with its reciprocal multiplies): bit-equal at step 1; at later steps
    params within one f32 ulp (``b ** step``'s power);
  * three steps of ``make_train_step`` at microbatches 1 and 2,
    ``quantize_grads`` on and off, remat full and none: each loss within
    LOSS_RTOL, grad norm within GNORM_RTOL, and each param leaf's
    distance from the reference's within PARAM_TOL of the reference's
    own movement over the three steps (Frobenius norms). Adam divides by
    each gradient's running magnitude, so an ulp apart in a gradient
    near zero moves an element by up to the learning rate: the bar is
    on the leaf, not the element, and the step's part marks
    (``loop.PART_MARKS``) in order;
  * MLA, MoE, the recurrent mixers, ``--multihost`` and
    ``--model-parallel`` raise (gemma2 and musicgen train:
    ``tests/test_torch_train_gemma2.py``, ``test_torch_train_musicgen.py``).

Measured on this host (jax 0.9.0, torch 2.13; ``python
tests/test_torch_train.py`` prints them): loss of the first step
within one f32 ulp for both archs; granite-8b's weight gradients
bit-equal; three steps at most 7.7e-8 apart in loss,
1.2e-4 in grad norm and 0.0002 of a leaf's movement.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro.configs import get_reduced as jget_reduced  # noqa: E402
from repro.core import fake_quant as jfake_quant  # noqa: E402
from repro.core import qat_matmul as jqat  # noqa: E402
from repro.data import DataConfig as JDataConfig  # noqa: E402
from repro.data import SyntheticLMDataset as JDataset  # noqa: E402
from repro.nn import model as jmodel  # noqa: E402
from repro.train import OptimConfig as JOptimConfig  # noqa: E402
from repro.train import init_state as jinit_state  # noqa: E402
from repro.train import make_train_step as jmake_train_step  # noqa: E402
from repro.train import optim as joptim  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.core import fake_quant, qat_matmul  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.nn import model  # noqa: E402
from repro_torch.train import OptimConfig, loop, optim  # noqa: E402

ARCHS = ["phi4-mini-3.8b", "granite-8b"]
NORM_SCALE_RTOL = 1e-6
GRAD_RTOL = 5e-3
LOSS_RTOL = 5e-3
GNORM_RTOL = 2e-2
PARAM_TOL = 0.15
CLIP_RTOL = 1e-5
F32_RTOL, F32_ATOL = 1e-5, 1e-6
SEQ, BATCH = 16, 4


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _t(x):
    return torch.from_numpy(np.array(x))


# ---------------------------------------------------------------------------
# qat_matmul and fake_quant
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("block", [16, 32])
@pytest.mark.parametrize("fmt", ["fp8_e4m3", "fp8_e5m2", "fp4_e2m1"])
def test_qat_matmul_forward_and_vjp_equal_the_reference(fmt, block, dtype):
    rng = np.random.default_rng([len(fmt), block, len(dtype)])
    x = rng.normal(size=(2, 8, 64)).astype(np.float32)
    w = (rng.normal(size=(64, 96)) / 8).astype(np.float32)
    dy = rng.normal(size=(2, 8, 96)).astype(np.float32)
    jdt = getattr(jnp, dtype)
    xj, dyj = jnp.asarray(x).astype(jdt), jnp.asarray(dy).astype(jdt)

    def f(x, w):
        return jqat(x, w, fmt, block, True, "fused", jnp.float32, "off")

    y_ref, (dx_ref, dw_ref) = jax.jit(
        lambda x, w, c: (f(x, w), jax.vjp(f, x, w)[1](c)))(
            xj, jnp.asarray(w), dyj)
    tdt = getattr(torch, dtype)
    xt = _t(_np(xj)).to(tdt).requires_grad_(True)
    wt = _t(w).requires_grad_(True)
    y = qat_matmul(xt, wt, fmt, block, True, "fused")
    dx, dw = torch.autograd.grad(y, (xt, wt), _t(_np(dyj)).to(tdt))
    assert y.dtype == tdt and dx.dtype == tdt and dw.dtype == torch.float32
    got = (y.detach(), dx, dw)
    for g, want in zip(got, (y_ref, dx_ref, dw_ref)):
        g = g.float().numpy()
        if dtype == "bfloat16" or g is got[2]:
            np.testing.assert_array_equal(g, _np(want))
        else:  # f32 sums in another order, not rounded to bf16
            np.testing.assert_allclose(g, _np(want), rtol=F32_RTOL,
                                       atol=F32_ATOL)


@pytest.mark.parametrize("quantize_acts", [True, False])
def test_qat_matmul_takes_the_reference_modes_only(quantize_acts):
    """``mode="pallas"`` (the kernel tier's product: #10's plain version
    with quantized activations, #9's without) gives the reference's
    output and vjp bit for bit on bf16 inputs; an unknown mode raises."""
    rng = np.random.default_rng(11)
    x = rng.normal(size=(16, 64)).astype(np.float32)
    w = (rng.normal(size=(64, 32)) / 8).astype(np.float32)
    dy = rng.normal(size=(16, 32)).astype(np.float32)
    xj, dyj = (jnp.asarray(a).astype(jnp.bfloat16) for a in (x, dy))

    def f(x, w):
        return jqat(x, w, "fp8_e4m3", 32, quantize_acts, "pallas",
                    jnp.float32, "off")

    y_ref, (dx_ref, dw_ref) = jax.jit(
        lambda x, w, c: (f(x, w), jax.vjp(f, x, w)[1](c)))(
            xj, jnp.asarray(w), dyj)
    xt = _t(_np(xj)).bfloat16().requires_grad_(True)
    wt = _t(w).requires_grad_(True)
    y = qat_matmul(xt, wt, "fp8_e4m3", 32, quantize_acts, "pallas")
    dx, dw = torch.autograd.grad(y, (xt, wt), _t(_np(dyj)).bfloat16())
    for got, want in ((y.detach(), y_ref), (dx, dx_ref), (dw, dw_ref)):
        np.testing.assert_array_equal(got.float().numpy(), _np(want))
    with pytest.raises(ValueError, match="mode"):
        qat_matmul(xt, wt, mode="tiled")


def test_fake_quant_value_and_straight_through_gradient():
    rng = np.random.default_rng(3)
    w = rng.normal(size=(64, 48)).astype(np.float32)
    g = rng.normal(size=(64, 48)).astype(np.float32)
    want, vjp = jax.vjp(lambda v: jfake_quant(v, "fp8_e4m3", 32, 0),
                        jnp.asarray(w))
    (want_g,) = vjp(jnp.asarray(g))
    wt = _t(w).requires_grad_(True)
    got = fake_quant(wt, "fp8_e4m3", 32, 0)
    (got_g,) = torch.autograd.grad(got, wt, _t(g))
    np.testing.assert_array_equal(got.detach().numpy(), _np(want))
    np.testing.assert_array_equal(got_g.numpy(), _np(want_g))
    np.testing.assert_array_equal(got_g.numpy(), g)  # straight through


# ---------------------------------------------------------------------------
# loss and gradients
# ---------------------------------------------------------------------------


def _reference_params(arch):
    jcfg = jget_reduced(arch)
    params, _ = jmodel.init(jax.random.PRNGKey(0), jcfg)
    return jcfg, params


def _batch(jcfg, step=0):
    ds = JDataset(JDataConfig(vocab_size=jcfg.vocab_size, seq_len=SEQ,
                              global_batch=BATCH,
                              num_codebooks=jcfg.num_codebooks))
    return ds.batch_at(step)


@pytest.fixture(scope="module", params=ARCHS)
def grads_pair(request):
    arch = request.param
    jcfg, params = _reference_params(arch)
    batch = _batch(jcfg)
    fn = jax.jit(jax.value_and_grad(
        lambda p, b: jmodel.loss_fn(p, jcfg, b), has_aux=True))
    (loss, metrics), grads = fn(params, {k: jnp.asarray(v)
                                         for k, v in batch.items()})
    cfg = get_reduced(arch)
    tp = model.train_params_from_jax(
        jax.tree_util.tree_map(np.asarray, params), cfg, "cpu")
    tloss, tmetrics, tgrads = loop.loss_and_grads(
        tp, cfg, {k: _t(v) for k, v in batch.items()})
    return (arch, cfg, (float(loss), {k: float(v) for k, v in
                                      metrics.items()}, grads),
            (float(tloss), {k: float(v) for k, v in tmetrics.items()},
             tgrads))


def test_loss_fn_equals_the_reference(grads_pair):
    _, _, (loss, metrics, _), (tloss, tmetrics, _) = grads_pair
    ulp = np.spacing(np.float32(loss))
    assert abs(tloss - loss) <= 2 * ulp, (tloss, loss)
    assert set(tmetrics) == set(metrics) == {"ce", "zloss", "aux"}
    for k in metrics:  # the z-loss sums its rows in another order
        assert abs(tmetrics[k] - metrics[k]) <= 1e-6 * abs(metrics[k]), (
            k, tmetrics, metrics)


def test_every_gradient_leaf_equals_the_reference(grads_pair):
    arch, cfg, (_, _, grads), (_, _, tgrads) = grads_pair
    want = jax.tree_util.tree_leaves(grads)
    got = model.reference_leaves(cfg, tgrads)
    paths = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(grads)[0]]
    assert len(want) == len(got) == len(paths)
    for path, a, b in zip(paths, want, got):
        b = (torch.stack(list(b)) if isinstance(b, list) else b).numpy()
        a = np.asarray(a)
        assert a.shape == b.shape, path
        err = np.abs(a - b).max() / np.abs(a).max()
        if arch == "granite-8b":
            assert err <= GRAD_RTOL, (path, err)
        elif "scale" in path:
            assert err <= NORM_SCALE_RTOL, (path, err)
        else:
            np.testing.assert_array_equal(b, a, err_msg=path)


# ---------------------------------------------------------------------------
# the optimizer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
def test_lr_at_equals_the_reference(schedule):
    for warm, total in ((0, 4), (3, 10), (20, 100)):
        jcfg = JOptimConfig(lr=3e-4, warmup_steps=warm, total_steps=total,
                            schedule=schedule)
        tcfg = OptimConfig(lr=3e-4, warmup_steps=warm, total_steps=total,
                           schedule=schedule)
        fn = jax.jit(lambda s: joptim.lr_at(jcfg, s))
        for step in range(0, total + 2):
            want = float(fn(jnp.asarray(step, jnp.int32)))
            assert optim.lr_at(tcfg, step) == want, (warm, total, step)


def test_global_norm_within_ulps_of_the_reference():
    """Each leaf's sum of squares in another order than XLA's windows of
    32 (x 32): within two f32 ulps."""
    rng = np.random.default_rng(7)
    leaves = [rng.normal(size=s).astype(np.float32)
              for s in ((64, 96), (32,), (2, 64, 128), (512, 64))]
    want = float(jax.jit(joptim.global_norm)(
        [jnp.asarray(x) for x in leaves]))
    got = float(optim.global_norm([_t(x) for x in leaves]))
    assert abs(got - want) <= 2 * np.spacing(np.float32(want))


@pytest.mark.parametrize("clip", [None, 1.0])
def test_optim_apply_on_the_reference_grads(clip):
    """Without clipping bit-equal (params within one f32 ulp past step 1:
    ``b ** step``); with clipping the scale follows the global norm's
    last bits, so moments and params within CLIP_RTOL of each leaf's
    largest."""
    rng = np.random.default_rng(5)
    shapes = {"a": (64, 96), "b": (32,), "c": (96, 64)}
    p = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    jcfg = JOptimConfig(lr=3e-3, warmup_steps=2, total_steps=10,
                        clip_norm=clip)
    tcfg = OptimConfig(lr=3e-3, warmup_steps=2, total_steps=10,
                       clip_norm=clip)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    jstate = joptim.init(jp)
    tp = {k: _t(v) for k, v in p.items()}
    tstate = optim.init(tp)
    fn = jax.jit(lambda a, b, c: joptim.apply(jcfg, a, b, c))
    for step in range(4):
        g = {k: (rng.normal(size=s) * 0.3).astype(np.float32)
             for k, s in shapes.items()}
        jp, jstate, jm = fn(jp, {k: jnp.asarray(v) for k, v in g.items()},
                            jstate)
        tp, tstate, tm = optim.apply(tcfg, tp, {k: _t(v) for k, v in
                                                g.items()}, tstate)
        assert float(tm["lr"]) == float(jm["lr"])
        assert int(tstate["step"]) == int(jstate["step"]) == step + 1
        for k in shapes:
            pairs = [(tstate["m"][k], jstate["m"][k]),
                     (tstate["v"][k], jstate["v"][k]), (tp[k], jp[k])]
            for i, (got, want) in enumerate(pairs):
                got, want = got.numpy(), np.asarray(want)
                if clip is not None:
                    np.testing.assert_allclose(
                        got, want, rtol=0,
                        atol=CLIP_RTOL * np.abs(want).max())
                elif i < 2 or step == 0:
                    np.testing.assert_array_equal(got, want)
                else:
                    np.testing.assert_allclose(
                        got, want, rtol=0,
                        atol=np.spacing(np.abs(want)).max())
            # each step from the reference's state
            for t, w in zip((tstate["m"][k], tstate["v"][k], tp[k]),
                            (jstate["m"][k], jstate["v"][k], jp[k])):
                t.copy_(_t(w))


# ---------------------------------------------------------------------------
# three train steps
# ---------------------------------------------------------------------------


THREE_STEP_CASES = [
    ("phi4-mini-3.8b", 1, False, "full"),
    ("phi4-mini-3.8b", 2, True, "none"),
    ("granite-8b", 2, False, "full"),
    ("granite-8b", 1, True, "none"),
]


@pytest.mark.parametrize("arch,microbatches,quantize_grads,remat",
                         THREE_STEP_CASES)
def test_three_train_steps_track_the_reference(arch, microbatches,
                                               quantize_grads, remat):
    jcfg, cfg = jget_reduced(arch), get_reduced(arch)
    jcfg = jcfg.replace(remat=remat, quant=jcfg.quant.replace(
        quantize_grads=quantize_grads))
    cfg = cfg.replace(remat=remat, quant=cfg.quant.replace(
        quantize_grads=quantize_grads))
    kw = dict(lr=3e-3, warmup_steps=1, total_steps=3)
    jstate, _ = jinit_state(jax.random.PRNGKey(0), jcfg)
    start = [np.asarray(x) for x in jax.tree_util.tree_leaves(
        jstate["params"])]
    params = model.train_params_from_jax(
        jax.tree_util.tree_map(np.asarray, jstate["params"]), cfg, "cpu")
    loop.trainable(params)
    tstate = {"params": params, "opt": optim.init(params)}
    jstep = jax.jit(jmake_train_step(jcfg, JOptimConfig(**kw),
                                     microbatches))
    tstep = loop.make_train_step(cfg, OptimConfig(**kw), microbatches)
    marks = []
    mark = marks.append
    loop.PART_MARKS.append(mark)
    try:
        for s in range(3):
            batch = _batch(jcfg, s)
            jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in
                                        batch.items()})
            tstate, tm = tstep(tstate, {k: _t(v) for k, v in batch.items()})
            assert float(tm["lr"]) == float(jm["lr"])
            assert abs(float(tm["loss"]) - float(jm["loss"])) \
                <= LOSS_RTOL * abs(float(jm["loss"]))
            assert abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) \
                <= GNORM_RTOL * float(jm["grad_norm"])
    finally:
        loop.PART_MARKS.remove(mark)
    # the step's parts, as a caller timing them sees them
    assert marks == 3 * (["forward", "backward"] * microbatches
                         + ["compress"] * quantize_grads
                         + ["optimizer", "end"])
    assert int(tstate["opt"]["step"]) == 3
    want = jax.tree_util.tree_leaves(jstate["params"])
    got = model.reference_leaves(cfg, tstate["params"])
    for a, b, a0 in zip(want, got, start):
        b = (torch.stack(list(b)) if isinstance(b, list) else b)
        b = b.detach().numpy()
        a = np.asarray(a)
        moved = np.linalg.norm(a - a0)
        assert moved > 0
        assert np.linalg.norm(a - b) <= PARAM_TOL * moved


# ---------------------------------------------------------------------------
# what waits for ROADMAP A9b / A7
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "recurrentgemma-2b",
                                  "mixtral-8x22b"])
def test_unported_archs_raise_naming_a9b(arch):
    cfg = get_reduced(arch)
    with pytest.raises(NotImplementedError, match="A9b"):
        model.check_trainable(cfg)
    with pytest.raises(NotImplementedError, match="A9b"):
        model.init_train(cfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(NotImplementedError, match="A9b"):
        launch_train.main(["--arch", arch, "--reduced", "--device", "cpu",
                           "--steps", "1"])


@pytest.mark.parametrize("flags,label", [(["--multihost"], "A9b"),
                                         (["--model-parallel", "2"], "A7")])
def test_unported_launcher_flags_raise(flags, label):
    with pytest.raises(NotImplementedError, match=label):
        launch_train.main(["--arch", "granite-8b", "--reduced", "--device",
                           "cpu", "--steps", "1"] + flags)


def gradient_report(arch: str) -> list:
    """Reduced ``arch``'s step-0 loss (f32 ulps apart) and, per gradient
    leaf, its largest difference over the leaf's largest value and the
    elements that differ, port against the jitted reference."""
    jcfg, params = _reference_params(arch)
    batch = _batch(jcfg)
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda p, b: jmodel.loss_fn(p, jcfg, b), has_aux=True))(
            params, {k: jnp.asarray(v) for k, v in batch.items()})
    cfg = get_reduced(arch)
    tp = model.train_params_from_jax(
        jax.tree_util.tree_map(np.asarray, params), cfg, "cpu")
    tloss, _, tgrads = loop.loss_and_grads(
        tp, cfg, {k: _t(v) for k, v in batch.items()})
    rows = [("loss ulps", (float(tloss) - float(loss))
             / float(np.spacing(np.float32(loss))), 0)]
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(grads)[0],
                            model.reference_leaves(cfg, tgrads)):
        b = (torch.stack(list(b)) if isinstance(b, list) else b).numpy()
        a = np.asarray(a)
        rows.append((jax.tree_util.keystr(path),
                     float(np.abs(a - b).max() / np.abs(a).max()),
                     int((a != b).sum())))
    return rows


def three_step_report(arch: str, microbatches: int = 1,
                      quantize_grads: bool = False,
                      remat: str = "full") -> tuple:
    """Three train steps of reduced ``arch`` against the reference's from
    one state: the largest relative loss and grad-norm differences, and
    the largest param leaf's distance over the reference's movement."""
    jcfg, cfg = jget_reduced(arch), get_reduced(arch)
    jcfg = jcfg.replace(remat=remat, quant=jcfg.quant.replace(
        quantize_grads=quantize_grads))
    cfg = cfg.replace(remat=remat, quant=cfg.quant.replace(
        quantize_grads=quantize_grads))
    kw = dict(lr=3e-3, warmup_steps=1, total_steps=3)
    jstate, _ = jinit_state(jax.random.PRNGKey(0), jcfg)
    start = [np.asarray(x) for x in jax.tree_util.tree_leaves(
        jstate["params"])]
    params = model.train_params_from_jax(
        jax.tree_util.tree_map(np.asarray, jstate["params"]), cfg, "cpu")
    loop.trainable(params)
    tstate = {"params": params, "opt": optim.init(params)}
    jstep = jax.jit(jmake_train_step(jcfg, JOptimConfig(**kw),
                                     microbatches))
    tstep = loop.make_train_step(cfg, OptimConfig(**kw), microbatches)
    loss = gnorm = 0.0
    for s in range(3):
        batch = _batch(jcfg, s)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in
                                    batch.items()})
        tstate, tm = tstep(tstate, {k: _t(v) for k, v in batch.items()})
        loss = max(loss, abs(float(tm["loss"]) / float(jm["loss"]) - 1))
        gnorm = max(gnorm, abs(float(tm["grad_norm"])
                               / float(jm["grad_norm"]) - 1))
    leaf = max(
        float(np.linalg.norm(np.asarray(a) - (torch.stack(list(b)) if
              isinstance(b, list) else b).detach().numpy())
              / np.linalg.norm(np.asarray(a) - a0))
        for a, b, a0 in zip(jax.tree_util.tree_leaves(jstate["params"]),
                            model.reference_leaves(cfg, tstate["params"]),
                            start))
    return loss, gnorm, leaf


if __name__ == "__main__":
    # the measured values that this file's and the gemma2 / musicgen
    # training tests' docstrings quote
    for arch in ARCHS + ["gemma2-2b", "musicgen-medium"]:
        for name, err, n in gradient_report(arch):
            print(f"{arch} {name}: {err:.3g} ({n} elements differ)")
    for case in THREE_STEP_CASES + [("gemma2-2b", 1, False, "full"),
                                    ("musicgen-medium", 1, False, "full")]:
        print(f"three steps {case} (loss, grad norm, worst leaf):",
              three_step_report(*case))
