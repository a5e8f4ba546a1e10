"""The port's RoPE and SiLU against the jitted reference, bit for bit.

The reference runs its model steps under ``jax.jit``, so its numbers are
what XLA makes of them: it folds ``rope_freqs``'s iota-built expression
at compile time (eager ``jnp.power`` gives another table), and XLA:CPU
flushes subnormals to zero. Each test compares against the jitted
function and carries a control that shows the port's earlier code (f32
``torch.pow`` frequencies; torch's f32 cos/sin, which the jitted
reference's -- the C library's ``cosf``/``sinf`` -- part from at long
positions; an unflushed ``silu``) fails it.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.nn import common as jcommon  # noqa: E402
from repro.nn import rotary as jrotary  # noqa: E402
from repro_torch.core import host_math  # noqa: E402
from repro_torch.nn import ffn, rotary  # noqa: E402

THETAS = (1e4, 3.3e4, 1e5, 5e5, 1e6, 1e7)
HEAD_DIMS = (16, 32, 48, 64, 80, 96, 128, 160, 192, 256)


def _old_freqs(head_dim, theta):
    """The port's frequencies before the repair: f32 ``1 / pow``."""
    exponent = 2.0 * torch.arange(head_dim // 2,
                                  dtype=torch.float32) / head_dim
    return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32),
                           exponent)


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.uint16 if a.dtype.itemsize == 2 else np.uint32)


def test_rope_freqs_equal_the_jitted_reference():
    jitted = jax.jit(jrotary.rope_freqs, static_argnums=(0, 1))
    misses = old_misses = total = 0
    for theta in THETAS:
        for d in HEAD_DIMS:
            want = _bits(jitted(d, theta))
            misses += int((_bits(rotary.rope_freqs(d, theta).numpy())
                           != want).sum())
            old_misses += int((_bits(_old_freqs(d, theta).numpy())
                               != want).sum())
            total += d // 2
    assert total == 3216
    assert misses == 0
    assert old_misses > 100  # the control: f32 pow misses entries


@pytest.mark.parametrize("head_dim", [128, 256])
@pytest.mark.parametrize("theta", [1e4, 1e7])
def test_apply_rope_equals_the_jitted_reference(head_dim, theta,
                                                monkeypatch):
    """bf16 inputs at every position below 1,024, two heads."""
    rng = np.random.default_rng(head_dim + int(theta))
    n = 1024
    x = rng.normal(size=(n, 2, head_dim)).astype(np.float32)
    xj = jnp.asarray(x, jnp.bfloat16)
    pos = np.arange(n, dtype=np.int32)
    want = _bits(jax.jit(jrotary.apply_rope, static_argnums=2)(
        xj, jnp.asarray(pos), theta))
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).bfloat16()

    def port():
        return _bits(rotary.apply_rope(xt, torch.from_numpy(pos), theta, n)
                     .view(torch.int16).numpy())

    np.testing.assert_array_equal(port(), want)
    # the control: the same rotation on the old frequencies
    rotary.rope_table.cache_clear()
    monkeypatch.setattr(rotary, "rope_freqs", _old_freqs)
    try:
        assert (port() != want).sum() > 0
    finally:
        rotary.rope_table.cache_clear()


#: positions of the long-table tests: past 32,768, and past the first
#: bf16 misses of torch's cos/sin (5,819 at theta 1e4; 13,852 at 1e7)
LONG_POSITIONS = 40960


def _torch_cos_sin(angles):
    """The port's cos/sin before the repair: torch's f32 cos and sin."""
    return torch.cos(angles), torch.sin(angles)


@pytest.mark.parametrize("theta,head_dim", [(1e4, 64), (1e4, 128),
                                            (1e4, 256), (1e7, 128)])
def test_rope_tables_equal_the_jitted_reference_at_long_positions(
        theta, head_dim, monkeypatch):
    """The f32 cos/sin tables over positions [0, 40960) equal the jitted
    reference's on every entry, and so do bf16 rotations of one head
    there; torch's cos/sin (the control) miss f32 entries and rotated
    bf16 values."""
    n = LONG_POSITIONS
    pos = np.arange(n, dtype=np.int32)

    def ref_tables(p):
        angles = p[:, None].astype(jnp.float32) * jrotary.rope_freqs(
            head_dim, theta)
        return jnp.cos(angles), jnp.sin(angles)

    want_cos, want_sin = (_bits(t) for t in jax.jit(ref_tables)(
        jnp.asarray(pos)))
    rotary.rope_table.cache_clear()
    cos, sin = rotary.rope_table(head_dim, theta, n, "cpu")
    np.testing.assert_array_equal(_bits(cos.numpy()), want_cos)
    np.testing.assert_array_equal(_bits(sin.numpy()), want_sin)

    rng = np.random.default_rng(int(theta) + head_dim)
    xj = jnp.asarray(rng.normal(size=(n, 1, head_dim)), jnp.bfloat16)
    want = _bits(jax.jit(jrotary.apply_rope, static_argnums=2)(
        xj, jnp.asarray(pos), theta))
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).bfloat16()

    def port():
        return _bits(rotary.apply_rope(xt, torch.from_numpy(pos), theta, n)
                     .view(torch.int16).numpy())

    np.testing.assert_array_equal(port(), want)
    # the control: torch's f32 cos/sin of the same angles
    rotary.rope_table.cache_clear()
    monkeypatch.setattr(host_math, "cos_sin", _torch_cos_sin)
    try:
        old_cos, old_sin = rotary.rope_table(head_dim, theta, n, "cpu")
        assert (_bits(old_cos.numpy()) != want_cos).sum() > 1000
        assert (_bits(old_sin.numpy()) != want_sin).sum() > 1000
        assert (port() != want).sum() > 0
    finally:
        rotary.rope_table.cache_clear()


def test_silu_rounds_like_the_jitted_reference_on_every_bf16_gate():
    codes = np.arange(1 << 16, dtype=np.uint32).astype(np.uint16)
    gates = codes.view(jnp.bfloat16).astype(np.float32)
    gates = gates[np.isfinite(gates)]
    assert gates.size == 65280
    want = _bits(jax.jit(lambda g: jcommon.round_to(
        jax.nn.silu(g), jnp.bfloat16))(jnp.asarray(gates)))
    g = torch.from_numpy(gates)

    def misses(act):
        return int((_bits(act.bfloat16().view(torch.int16).numpy())
                    != want).sum())

    assert misses(ffn.silu(g)) == 0
    # the controls: torch's silu keeps subnormals (511 gates), and so does
    # flushing only its output (-87.5, -88 and -88.5 are left)
    assert misses(torch.nn.functional.silu(g)) == 511
    from repro_torch.core.formats import flush_subnormals
    assert misses(flush_subnormals(torch.nn.functional.silu(g))) == 3
