"""The port's training substrate against the JAX package's on the CPU:
data batches, checkpoints, fault handling, metrics lines, gradient
compression's skip rule and the launcher with a resume.

Exact throughout: ``SyntheticLMDataset`` and ``CorpusDataset`` batches
equal the reference's bit for bit; a checkpoint the port writes restores
in ``repro.train.checkpoint.restore`` with equal bytes and the same
manifest structure, and the reverse; the watchdog (on a fake clock),
``run_with_restarts`` and ``PreemptionGuard`` act as the reference's on
the same inputs; ``MetricsLogger`` writes the reference's lines (on a
fake clock); a resumed launcher run replays the uninterrupted one bit for
bit. The reference is imported inside fixtures, so the ``cuda``-marked
test here also runs on a machine without JAX.
"""
import json
import shutil
import signal
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.data import (CorpusDataset, DataConfig,  # noqa: E402
                              SyntheticLMDataset)
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.nn import model  # noqa: E402
from repro_torch.train import checkpoint, fault, loop, metrics, optim  # noqa

ARCH = "phi4-mini-3.8b"
LAUNCH = ["--arch", ARCH, "--reduced", "--device", "cpu", "--seq-len", "16",
          "--global-batch", "4"]


@pytest.fixture(scope="module")
def ref():
    """The reference's modules (JAX is imported here only)."""
    pytest.importorskip("jax")
    import jax

    from repro import data as jdata
    from repro.configs import get_reduced as jget_reduced
    from repro.train import checkpoint as jcheckpoint
    from repro.train import fault as jfault
    from repro.train import init_state as jinit_state
    from repro.train import loop as jloop
    from repro.train import make_train_step as jmake_train_step
    from repro.train import metrics as jmetrics
    from repro.train import OptimConfig as JOptimConfig

    class R:
        pass

    r = R()
    r.jax, r.data, r.checkpoint, r.fault = jax, jdata, jcheckpoint, jfault
    r.loop, r.metrics, r.get_reduced = jloop, jmetrics, jget_reduced
    r.init_state, r.make_train_step = jinit_state, jmake_train_step
    r.OptimConfig = JOptimConfig
    return r


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(vocab_size=512, seq_len=16, global_batch=4),
    dict(vocab_size=512, seq_len=16, global_batch=4, mode="uniform"),
    dict(vocab_size=200064, seq_len=128, global_batch=8, seed=3),
    dict(vocab_size=300, seq_len=8, global_batch=4, num_codebooks=2),
    dict(vocab_size=512, seq_len=16, global_batch=4, process_index=1,
         process_count=2),
])
def test_synthetic_batches_equal_the_reference(ref, kw):
    got, want = SyntheticLMDataset(DataConfig(**kw)), \
        ref.data.SyntheticLMDataset(ref.data.DataConfig(**kw))
    for step in (0, 1, 7):
        a, b = got.batch_at(step), want.batch_at(step)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    first = next(iter(got))
    np.testing.assert_array_equal(first["tokens"],
                                  want.batch_at(0)["tokens"])


def test_corpus_batches_equal_the_reference(ref):
    text = "the quick brown fox jumps over the lazy dog. " * 40
    kw = dict(vocab_size=256, seq_len=32, global_batch=4, seed=5)
    got = CorpusDataset(text, DataConfig(**kw))
    want = ref.data.CorpusDataset(text, ref.data.DataConfig(**kw))
    for step in range(3):
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(got.batch_at(step)[k],
                                          want.batch_at(step)[k])


def test_uneven_process_split_raises():
    with pytest.raises(ValueError, match="divide"):
        SyntheticLMDataset(DataConfig(vocab_size=64, seq_len=4,
                                      global_batch=3, process_count=2))


# ---------------------------------------------------------------------------
# checkpoints across the packages
# ---------------------------------------------------------------------------


def _trained_port_state(steps=1):
    cfg = get_reduced(ARCH)
    state = loop.init_state(cfg, torch.Generator().manual_seed(4), "cpu")
    step = loop.make_train_step(cfg, optim.OptimConfig(warmup_steps=1))
    ds = SyntheticLMDataset(DataConfig(vocab_size=cfg.vocab_size,
                                       seq_len=16, global_batch=4))
    for s in range(steps):
        state, _ = step(state, {k: torch.from_numpy(v) for k, v in
                                ds.batch_at(s).items()})
    return cfg, state


def _port_leaves(cfg, state):
    out = []
    for leaf in model.leaves(checkpoint.reference_state(cfg, state),
                             stacked=True):
        t = torch.stack(list(leaf)) if isinstance(leaf, list) else leaf
        out.append(t.detach().numpy())
    return out


def test_port_checkpoint_restores_in_the_reference(ref, tmp_path):
    cfg, state = _trained_port_state()
    checkpoint.save(str(tmp_path), 1, state, cfg, extra={"data_step": 1})
    like, _ = ref.init_state(ref.jax.random.PRNGKey(0),
                             ref.get_reduced(ARCH))
    restored, step, extra = ref.checkpoint.restore(str(tmp_path), like)
    assert step == 1 and extra == {"data_step": 1}
    want = ref.jax.tree_util.tree_leaves(restored)
    got = _port_leaves(cfg, state)
    assert len(want) == len(got)
    for a, b in zip(want, got):
        a = np.asarray(a)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    with open(tmp_path / "step_00000001" / "manifest.json") as f:
        manifest = json.load(f)
    assert manifest["treedef"] == str(
        ref.jax.tree_util.tree_structure(like))
    assert manifest["num_leaves"] == len(want)


def test_reference_checkpoint_restores_in_the_port(ref, tmp_path):
    jax = ref.jax
    jcfg = ref.get_reduced(ARCH)
    jstate, _ = ref.init_state(jax.random.PRNGKey(1), jcfg)
    step = jax.jit(ref.make_train_step(jcfg, ref.OptimConfig(
        warmup_steps=1)))
    ds = ref.data.SyntheticLMDataset(ref.data.DataConfig(
        vocab_size=jcfg.vocab_size, seq_len=16, global_batch=4))
    jstate, _ = step(jstate, {k: jax.numpy.asarray(v) for k, v in
                              ds.batch_at(0).items()})
    ref.checkpoint.save(str(tmp_path), 1, jstate, extra={"data_step": 1})
    cfg, state = _trained_port_state(steps=0)
    state, got_step, extra = checkpoint.restore(str(tmp_path), state, cfg)
    assert got_step == 1 and extra == {"data_step": 1}
    for a, b in zip(jax.tree_util.tree_leaves(jstate),
                    _port_leaves(cfg, state)):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_checkpoint_atomicity_pruning_and_leaf_count(tmp_path):
    cfg, state = _trained_port_state(steps=0)
    for s in range(1, 6):
        checkpoint.save(str(tmp_path), s, state, cfg, keep=2)
    (tmp_path / "step_00000009.tmp").mkdir()  # an interrupted save
    assert checkpoint.list_steps(str(tmp_path)) == [4, 5]
    assert checkpoint.latest_step(str(tmp_path)) == 5
    other = get_reduced("granite-8b")
    wrong = loop.init_state(other, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match="leaves"):
        checkpoint.restore(str(tmp_path), wrong, other)
    with pytest.raises(FileNotFoundError):
        checkpoint.restore(str(tmp_path / "none"), state, cfg)


# ---------------------------------------------------------------------------
# gradient compression's skip rule
# ---------------------------------------------------------------------------


def test_compress_grads_skip_rule_equals_the_reference(ref):
    jnp = ref.jax.numpy
    cfg = ref.get_reduced(ARCH)
    qcfg = cfg.replace(quant=cfg.quant.replace(quantize_grads=True))
    rng = np.random.default_rng(2)
    leaves = {"a": rng.normal(size=(4, 64)), "b": rng.normal(size=(10,)),
              "c": rng.normal(size=(3, 5))}
    leaves = {k: v.astype(np.float32) for k, v in leaves.items()}
    want = ref.loop._compress_grads({k: jnp.asarray(v) for k, v in
                                     leaves.items()}, qcfg)
    got = [torch.from_numpy(leaves[k].copy()) for k in sorted(leaves)]
    loop.compress_leaves(got)
    for k, g in zip(sorted(leaves), got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(want[k]))
    assert not np.array_equal(got[0].numpy(), leaves["a"])  # quantized
    np.testing.assert_array_equal(got[1].numpy(), leaves["b"])  # 10: wide
    # a size that is a multiple of 32 over a last axis that is not: both
    # packages raise; a stacked leaf counts the whole stack's size
    bad = rng.normal(size=(32, 3)).astype(np.float32)
    with pytest.raises(ValueError):
        ref.loop._compress_grads({"w": jnp.asarray(bad)}, qcfg)
    with pytest.raises(ValueError):
        loop.compress_leaves([torch.from_numpy(bad)])
    stack = rng.normal(size=(2, 16)).astype(np.float32)
    with pytest.raises(ValueError):
        ref.loop._compress_grads({"w": jnp.asarray(stack)}, qcfg)
    with pytest.raises(ValueError):
        loop.compress_leaves([[torch.from_numpy(stack[0]),
                               torch.from_numpy(stack[1])]])


# ---------------------------------------------------------------------------
# fault handling and metrics
# ---------------------------------------------------------------------------


class FakeClock:
    def __init__(self, durations):
        self.t, self.durations, self.start = 0.0, iter(durations), True

    def __call__(self):
        if not self.start:
            self.t += next(self.durations)
        self.start = not self.start
        return self.t


DURATIONS = [0.01] * 10 + [0.05, 0.011, 0.03, 0.01] + [0.012] * 4


def test_straggler_watchdog_flags_as_the_reference(ref, monkeypatch):
    got = fault.StragglerWatchdog(window=8, clock=FakeClock(DURATIONS))
    slow = []
    for _ in DURATIONS:
        got.step_start()
        slow.append(got.step_end())
    monkeypatch.setattr(ref.fault, "time", types.SimpleNamespace(
        monotonic=FakeClock(DURATIONS)))
    want = ref.fault.StragglerWatchdog(window=8)
    want_slow = []
    for _ in DURATIONS:
        want.step_start()
        want_slow.append(want.step_end())
    assert slow == want_slow and got.flagged == want.flagged == 2


@pytest.mark.parametrize("fails", [0, 2, 5])
def test_run_with_restarts_as_the_reference(ref, fails):
    def run(mod):
        calls, seen = [], []

        def loop_fn(resume):
            calls.append(resume)
            if len(calls) <= fails:
                raise RuntimeError(f"node failure {len(calls)}")
            return 42

        try:
            out = mod.run_with_restarts(
                loop_fn, max_restarts=3,
                on_restart=lambda n, e: seen.append((n, str(e))))
        except RuntimeError as e:
            out = f"raised {e}"
        return out, calls, seen

    assert run(fault) == run(ref.fault)
    assert run(fault)[0] == (42 if fails <= 3 else "raised node failure 4")


def test_preemption_guard_stops_at_the_next_boundary():
    guard = fault.PreemptionGuard()
    try:
        assert not guard.should_stop
        signal.raise_signal(signal.SIGTERM)
        assert guard.should_stop
    finally:
        guard.restore()
    assert signal.getsignal(signal.SIGTERM) is not guard._handler


def test_metrics_lines_equal_the_reference(ref, tmp_path, monkeypatch):
    times = iter([100.0, 100.5, 101.5, 100.0, 100.5, 101.5])
    clock = types.SimpleNamespace(time=lambda: next(times))
    monkeypatch.setattr(metrics, "time", clock)
    monkeypatch.setattr(ref.metrics, "time", clock)
    recs = [{"loss": torch.tensor(2.5), "lr": 3e-4, "note": "text"},
            {"loss": np.float32(2.25), "grad_norm": torch.tensor(1.5)},
            {"loss": 2.0}]
    paths = tmp_path / "port.jsonl", tmp_path / "ref.jsonl"
    for mod, path in zip((metrics, ref.metrics), paths):
        logger = mod.MetricsLogger(str(path))
        for i, m in enumerate(recs):
            logger.log(i, m, tokens_per_step=64, model_flops_per_step=1e12)
        logger.close()
    assert paths[0].read_text() == paths[1].read_text()
    got = metrics.read_metrics(str(paths[0]))
    assert [r["step"] for r in got] == [0, 1, 2]
    assert got[1]["tokens_per_s"] == 128.0 and "note" not in got[0]


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------


def test_launcher_resume_replays_the_run(ref, tmp_path):
    whole = tmp_path / "whole"
    straight = launch_train.main(LAUNCH + ["--steps", "4", "--ckpt-dir",
                                           str(whole), "--ckpt-every", "2"])
    assert straight["final_step"] == 4 and straight["steps"] == [0, 1, 2, 3]
    assert all(np.isfinite(straight["loss"]))
    assert checkpoint.list_steps(str(whole)) == [2, 4]
    # drop the last checkpoint: the launcher resumes from step 2
    shutil.copytree(whole, tmp_path / "cut")
    shutil.rmtree(tmp_path / "cut" / "step_00000004")
    resumed = launch_train.main(LAUNCH + ["--steps", "4", "--ckpt-dir",
                                          str(tmp_path / "cut"),
                                          "--ckpt-every", "2"])
    assert resumed["steps"] == [2, 3]
    assert resumed["loss"] == straight["loss"][2:]
    assert resumed["grad_norm"] == straight["grad_norm"][2:]
    for i in range(len(list((whole / "step_00000004").glob("leaf_*")))):
        name = f"step_00000004/leaf_{i:05d}.npy"
        np.testing.assert_array_equal(np.load(whole / name),
                                      np.load(tmp_path / "cut" / name))
    like, _ = ref.init_state(ref.jax.random.PRNGKey(0),
                             ref.get_reduced(ARCH))
    _, step, extra = ref.checkpoint.restore(str(tmp_path / "cut"), like)
    assert step == 4 and extra == {"data_step": 4}


def test_launcher_device_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_train.main(["--arch", ARCH, "--reduced", "--steps", "1"])


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_cuda_qat_matmul_launches_quantize_for_both_operands():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.core import qat_matmul
    from repro_torch.core.dot import quantize_weight
    from repro_torch.kernels import mx_quantize as mq

    gen = torch.Generator().manual_seed(0)
    x = torch.randn(4, 64, 256, generator=gen).bfloat16()
    w = torch.randn(256, 128, generator=gen) / 16
    mq.mx_quantize.launches = 0
    xc = x.cuda().requires_grad_(True)
    wc = w.cuda().requires_grad_(True)
    y = qat_matmul(xc, wc, "fp8_e4m3", 32)
    assert mq.mx_quantize.launches == 2
    y.float().sum().backward()
    assert mq.mx_quantize.launches == 2  # the backward reuses the residuals
    want = qat_matmul(x, w, "fp8_e4m3", 32)
    np.testing.assert_allclose(y.detach().float().cpu().numpy(),
                               want.float().numpy(), rtol=1e-2, atol=1e-2)
    got_w, want_w = quantize_weight(wc, "fp8_e4m3", 32), quantize_weight(
        w, "fp8_e4m3", 32)
    assert torch.equal(got_w.elements.view(torch.uint8).cpu(),
                       want_w.elements.view(torch.uint8))
    assert torch.equal(got_w.scales.cpu(), want_w.scales)


@pytest.mark.cuda
def test_cuda_matmul_rounds_once_whatever_the_cublas_settings():
    """``dot.matmul``'s bf16 product on the card gives the same bits with
    cuBLAS's reduced-precision bf16 reduction on and off: f32 sums
    rounded once, by the function itself."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.core.dot import matmul

    gen = torch.Generator().manual_seed(0)
    a = torch.randn(1024, 8192, generator=gen).bfloat16().cuda()
    b = (torch.randn(8192, 3072, generator=gen) / 64).bfloat16().cuda()
    flags = torch.backends.cuda.matmul
    saved = flags.allow_bf16_reduced_precision_reduction
    try:
        outs = []
        for allow in (True, False):
            flags.allow_bf16_reduced_precision_reduction = allow
            outs.append(matmul(a, b, torch.bfloat16))
    finally:
        flags.allow_bf16_reduced_precision_reduction = saved
    want = torch.mm(a, b, out_dtype=torch.float32).to(torch.bfloat16)
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], want)
