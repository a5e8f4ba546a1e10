"""The port's RMSNorm against the jitted reference, bit for bit (CPU).

The reference's ``rmsnorm_apply`` runs under ``jax.jit``, so its bits are
XLA:CPU's: the row sum ``jnp.mean(x * x)`` is a tree of reduce-windows of
32 consecutive elements, each summed in order (4096 -> 128 -> 4 -> 1; a
level that is not a multiple of 32 is padded around), the divide by the
width becomes a multiply by its f32 reciprocal, contracted with ``+ eps``
into an FMA, and ``rsqrt`` is the x86 ``rsqrtps`` estimate refined by two
Newton steps with FMAs, not a correctly rounded one. The port's CPU path
repeats all three (``nn.norms.window_sum``, ``core.host_math.rsqrt``).
Each test carries a control: ``torch.mean`` with ``torch.rsqrt``, the
port's earlier code, misses rows. The helper's rsqrt needs an x86 host.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.nn import norms as jnorms  # noqa: E402
from repro_torch.core import host_math  # noqa: E402
from repro_torch.nn import norms  # noqa: E402


def _old_rmsnorm(params, x, eps=1e-6):
    """The port's RMSNorm before the repair: torch.mean, torch.rsqrt."""
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)
            * (1.0 + params["scale"].float())).to(x.dtype)


def _rows(rng, rows, width):
    """Gaussian rows at many scales (e^-3 to e^3), as a model's residual
    stream has them."""
    return (rng.normal(size=(rows, width))
            * np.exp(rng.uniform(-3, 3, (rows, 1)))).astype(np.float32)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("width,rows", [(64, 10000), (4096, 2000),
                                        (2304, 1000), (14336, 500)])
def test_rmsnorm_equals_the_jitted_reference_in_every_row(width, rows,
                                                          dtype):
    """64 and 4096 are the port's widths (reduced and granite-8b); 2304
    pads its second level, 14336 sums 14 windows at its last."""
    rng = np.random.default_rng(width + rows)
    x = _rows(rng, rows, width)
    scale = (0.1 * rng.normal(size=(width,))).astype(np.float32)
    xj = jnp.asarray(x)
    if dtype == "bf16":
        xj = xj.astype(jnp.bfloat16)
    want = np.asarray(jax.jit(jnorms.rmsnorm_apply)(
        {"scale": jnp.asarray(scale)}, xj).astype(jnp.float32))
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32)))
    if dtype == "bf16":
        xt = xt.bfloat16()
    params = {"scale": torch.from_numpy(scale)}
    got = norms.rmsnorm_apply(params, xt)
    assert got.dtype == xt.dtype
    np.testing.assert_array_equal(got.float().numpy(), want)
    # the control: torch.mean and torch.rsqrt miss rows
    old = _old_rmsnorm(params, xt).float().numpy()
    assert (old != want).any(axis=-1).sum() > 0


def test_window_sum_is_the_reference_tree():
    """Level by level: 4096 -> 128 -> 4 -> 1, each window in order."""
    v = torch.from_numpy(np.random.default_rng(0).normal(
        size=(7, 4096)).astype(np.float32)) ** 2

    def in_order(w):
        acc = w[..., 0]
        for i in range(1, w.shape[-1]):
            acc = acc + w[..., i]
        return acc

    level = in_order(in_order(v.reshape(7, 128, 32)).reshape(7, 4, 32))
    assert torch.equal(norms.window_sum(v), in_order(level))


def test_host_rsqrt_equals_xla_rsqrt():
    """Every positive normal f32 drawn over the whole exponent range,
    the special inputs, and the FMA with a scale and an add, against
    jitted ``jax.lax.rsqrt``; torch.rsqrt (the control) misses."""
    rng = np.random.default_rng(1)
    x = rng.integers(0x00800000, 0x7F800000, 200000,
                     dtype=np.uint32).view(np.float32)
    special = np.array([0.0, -0.0, 1e-40, -1e-40, 1.17549435e-38, 3e38,
                        np.inf, -np.inf, -1.0, np.nan, 1.0, 4.0],
                       np.float32)
    x = np.concatenate([x, special])
    want = np.asarray(jax.jit(jax.lax.rsqrt)(jnp.asarray(x)))
    got = host_math.rsqrt(torch.from_numpy(x)).numpy()
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    np.testing.assert_array_equal(got[~nan].view(np.uint32),
                                  want[~nan].view(np.uint32))
    assert (torch.rsqrt(torch.from_numpy(x)).numpy()[~nan]
            != want[~nan]).sum() > 1000
    # rsqrt(sum * (1 / width) + eps) as XLA contracts it
    s = np.exp(rng.uniform(-10, 10, 100000)).astype(np.float32)
    recip = float(np.float32(1) / np.float32(3072))
    want = np.asarray(jax.jit(lambda v: jax.lax.rsqrt(v * recip + 1e-6))(
        jnp.asarray(s)))
    got = host_math.rsqrt(torch.from_numpy(s), recip, 1e-6).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("width", [64, 4096])
def test_rmsnorm_gradient_equals_the_reference_gradient(width):
    """The CPU path stays differentiable through the host rsqrt: the
    gradients of <rmsnorm(x), c> in x and in the scale equal
    ``jax.grad`` of the jitted reference within 1e-5 relative (f32 sums
    in other orders), and the rsqrt's own gradient is -0.5 r^3 there."""
    rng = np.random.default_rng(width)
    x = _rows(rng, 16, width)
    scale = (0.1 * rng.normal(size=(width,))).astype(np.float32)
    cot = rng.normal(size=(16, width)).astype(np.float32)

    def loss(p, v):
        return jnp.sum(jnorms.rmsnorm_apply(p, v) * cot)

    want_s, want_x = jax.jit(jax.grad(loss, argnums=(0, 1)))(
        {"scale": jnp.asarray(scale)}, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    st = torch.from_numpy(scale).requires_grad_()
    (norms.rmsnorm_apply({"scale": st}, xt) * torch.from_numpy(cot)).sum() \
        .backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_x),
                               rtol=1e-5, atol=1e-5 * np.abs(want_x).max())
    np.testing.assert_allclose(st.grad.numpy(), np.asarray(want_s["scale"]),
                               rtol=1e-5,
                               atol=1e-5 * np.abs(want_s["scale"]).max())
    u = torch.from_numpy(np.exp(rng.uniform(-5, 5, 100)).astype(np.float32))
    u.requires_grad_()
    r = host_math.rsqrt(u, 0.5, 1e-6)
    r.sum().backward()
    np.testing.assert_allclose(u.grad.numpy(),
                               (-0.25 * r.detach() ** 3).numpy(), rtol=1e-6)
    with pytest.raises(ValueError, match="no gradient"):
        host_math.cos_sin(torch.ones(3, requires_grad=True))
