"""The port's overload controller (``repro_torch.serve.overload``) against
the reference's, decision for decision.

Seeded random event sequences (admit at a depth, a first token observed
with a latency, the injected clock stepped) go to both controllers with
one clock; after every event the two must agree exactly: the admit or
shed decision, the shed's message and ``retry_after_s``, the prediction
and ``stats()``. The configurations cover the SLO model, the hard queue
cap, hysteresis, the cold cap and the retry floor. The reference's four
controller cases follow, run against the port. The reference is imported
by a fixture, so the file collects where JAX is not installed.
"""
import numpy as np
import pytest

from repro_torch.serve import OverloadConfig, OverloadController, ShedError

CONFIGS = [
    dict(slo_ms=100),
    dict(max_queue=3),
    dict(slo_ms=40, max_queue=6),
    dict(slo_ms=60, hysteresis=0.5, ewma_alpha=0.6),
    dict(slo_ms=25, max_queue=2, ewma_alpha=1.0, min_retry_after_s=0.0),
    dict(slo_ms=80, hysteresis=1.0, min_retry_after_s=0.2),
    dict(),
]


@pytest.fixture(scope="module")
def ref():
    """The reference's overload module (pure Python, no JAX)."""
    pytest.importorskip("jax")
    from repro.serve import overload

    return overload


def _admit(ctl, shed_type, depth):
    try:
        ctl.admit(depth)
    except shed_type as e:
        return ("shed", str(e), e.retry_after_s)
    return ("admit",)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("knobs", CONFIGS, ids=lambda k: ",".join(
    f"{a}={b}" for a, b in k.items()) or "defaults")
def test_decisions_match_the_reference(ref, knobs, seed):
    rng = np.random.default_rng(seed)
    now = [0.0]
    ours = OverloadController(OverloadConfig(**knobs), clock=lambda: now[0])
    theirs = ref.OverloadController(ref.OverloadConfig(**knobs),
                                    clock=lambda: now[0])
    kinds = []
    for _ in range(300):
        kind = rng.choice(["admit", "observe", "tick"], p=[0.5, 0.3, 0.2])
        kinds.append(kind)
        if kind == "admit":
            depth = int(rng.integers(0, 12))
            got = _admit(ours, ShedError, depth)
            want = _admit(theirs, ref.ShedError, depth)
            assert got == want
        elif kind == "observe":
            lat = float(rng.exponential(0.03))
            ours.observe_first_token(lat)
            theirs.observe_first_token(lat)
        else:
            now[0] += float(rng.exponential(0.01))
        assert ours.stats() == theirs.stats()
        for depth in (0, 3, 9):
            assert ours.predicted_latency(depth) == \
                theirs.predicted_latency(depth)
    stats = ours.stats()
    assert stats["admitted_count"] > 0
    if knobs:
        assert stats["shed_count"] > 0, "the sequence must shed"


def test_config_validation_matches_the_reference(ref):
    for bad in (dict(slo_ms=0), dict(slo_ms=-5), dict(max_queue=-1),
                dict(ewma_alpha=0), dict(ewma_alpha=1.5),
                dict(hysteresis=0), dict(hysteresis=1.5),
                dict(min_retry_after_s=-1.0)):
        with pytest.raises(ValueError) as ours:
            OverloadConfig(**bad).validate()
        with pytest.raises(ValueError) as theirs:
            ref.OverloadConfig(**bad).validate()
        assert str(ours.value) == str(theirs.value)
    assert ShedError("x", retry_after_s=-1.0).retry_after_s == 0.0


# the reference's controller cases (tests/test_server.py), on the port


def test_overload_predicts_sheds_and_recovers():
    now = [0.0]
    ctl = OverloadController(OverloadConfig(slo_ms=100),
                             clock=lambda: now[0])
    ctl.admit(50)  # no measurements yet: admitted
    ctl.observe_first_token(0.02)
    now[0] += 0.01
    ctl.observe_first_token(0.02)
    assert abs(ctl.predicted_latency(5) - (5 * 0.01 + 0.02)) < 1e-9
    ctl.admit(8)  # 100 ms == SLO, not over
    with pytest.raises(ShedError) as ei:
        ctl.admit(9)  # 110 ms
    assert ei.value.retry_after_s > 0
    assert ctl.shedding
    with pytest.raises(ShedError):
        ctl.admit(8)  # under the SLO, not under 85 ms: hysteresis
    ctl.admit(0)  # an empty queue always admits
    assert ctl.shedding
    ctl.admit(6)  # 80 ms < 85 ms: shedding ends
    assert not ctl.shedding
    stats = ctl.stats()
    assert stats["shed_count"] == 2 and stats["admitted_count"] == 4


def test_overload_max_queue_is_a_hard_cap():
    ctl = OverloadController(OverloadConfig(max_queue=2))
    ctl.admit(0)
    ctl.admit(1)
    with pytest.raises(ShedError):
        ctl.admit(2)


def test_overload_config_validation():
    for bad in (dict(slo_ms=0), dict(max_queue=-1), dict(ewma_alpha=0),
                dict(hysteresis=1.5), dict(min_retry_after_s=-1.0)):
        with pytest.raises(ValueError):
            OverloadConfig(**bad).validate()
    assert ShedError("x", retry_after_s=-1.0).retry_after_s == 0.0


def test_overload_retry_after_never_zero():
    now = [0.0]
    # cold cap: no first-token interval yet, the floor answers
    ctl = OverloadController(OverloadConfig(max_queue=1),
                             clock=lambda: now[0])
    ctl.admit(0)
    with pytest.raises(ShedError) as ei:
        ctl.admit(1)
    assert ei.value.retry_after_s == pytest.approx(0.05)
    # warm cap: the measured interval beats the floor
    ctl = OverloadController(OverloadConfig(max_queue=1),
                             clock=lambda: now[0])
    ctl.observe_first_token(0.01)
    now[0] += 0.25
    ctl.observe_first_token(0.01)
    with pytest.raises(ShedError) as ei:
        ctl.admit(5)
    assert ei.value.retry_after_s == pytest.approx(0.25)
    # 10 ms over the SLO: under the floor, which answers
    ctl = OverloadController(OverloadConfig(slo_ms=100),
                             clock=lambda: now[0])
    ctl.observe_first_token(0.02)
    now[0] += 0.01
    ctl.observe_first_token(0.02)
    with pytest.raises(ShedError) as ei:
        ctl.admit(9)
    assert ei.value.retry_after_s == pytest.approx(0.05)
    ctl = OverloadController(OverloadConfig(max_queue=1,
                                            min_retry_after_s=2.0),
                             clock=lambda: now[0])
    ctl.admit(0)
    with pytest.raises(ShedError) as ei:
        ctl.admit(1)
    assert ei.value.retry_after_s == pytest.approx(2.0)
