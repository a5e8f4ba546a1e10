"""The port's MX dot product entry points against the reference's.

``repro_torch.core.mx_dot`` in its three modes (the paper's tiers:
"emulated" two-step f32 dequant, "fused" bf16 dequant, "pallas" the
kernels) and ``repro_torch.nn.linear.apply`` with ``MXTensor`` weights
from ``linear.quantize_weights`` and with wide weights, against
``repro.core.mx_dot`` and ``repro.nn.linear`` on the same inputs. The
reference's weights come from its own ``quantize_weights`` and cross to
the port through ``core.mx_tensor.from_jax``.

On the CPU the reference's ``linear.apply`` swaps "pallas" for "fused"
(no TPU); the port never swaps. So the port's "pallas" layer is held to
the reference's kernel path, ``mx_dot(..., mode="pallas")`` (interpret
mode), rounded to bf16 as ``apply`` rounds it.

Tolerances: f32 results rtol 1e-5, atol 1e-4 (the same exact products
summed in another order); bf16 results one bf16 ulp of the reference
plus 1e-4 (each side rounds an f32 value that agrees to that bar).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro.core import MXFP8 as JMXFP8  # noqa: E402
from repro.core import WIDE as JWIDE  # noqa: E402
from repro.core import mx_dot as jmx_dot  # noqa: E402
from repro.core import qat_matmul as jqat  # noqa: E402
from repro.core import quantize as jquantize  # noqa: E402
from repro.nn import linear as jlinear  # noqa: E402
from repro_torch.core import MXFP8, WIDE, mx_dot, qat_matmul  # noqa: E402
from repro_torch.core import quantize as tquantize  # noqa: E402
from repro_torch.core.mx_tensor import from_jax  # noqa: E402
from repro_torch.nn import linear  # noqa: E402

FMTS = ["fp8_e4m3", "fp8_e5m2", "fp4_e2m1"]
MODES = ["emulated", "fused", "pallas"]
RTOL, ATOL = 1e-5, 1e-4
D_IN, D_OUT = 256, 96


def _port(t):
    return from_jax(np.asarray(t.elements), np.asarray(t.scales), t.fmt_name,
                    t.block_size, t.axis, t.shape)


def _jax_weights(w: np.ndarray, quant):
    """The reference's quantize_weights, jitted (one compile per format)."""
    fn = jax.jit(lambda v: jlinear.quantize_weights({"w": v}, quant)["w"])
    return fn(jnp.asarray(w))


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(17)
    x = rng.normal(size=(2, 8, D_IN)).astype(np.float32)
    w = (rng.normal(size=(D_IN, D_OUT)) / 16).astype(np.float32)
    weights = {fmt: _jax_weights(w, JMXFP8.replace(fmt=fmt)) for fmt in FMTS}
    return x, w, weights


def _assert_bf16_close(got: torch.Tensor, want) -> None:
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    err = np.abs(got.float().numpy() - want)
    assert (err <= ulp + ATOL).all(), err.max()


@pytest.mark.parametrize("fmt", FMTS)
def test_quantize_weights_bit_exact(data, fmt):
    _, w, weights = data
    got = linear.quantize_weights({"w": torch.from_numpy(w)},
                                  MXFP8.replace(fmt=fmt))["w"]
    want = _port(weights[fmt])
    assert (got.shape, got.axis, got.fmt_name) == (want.shape, 0, fmt)
    assert got.nbytes == weights[fmt].nbytes
    for g, v in ((got.elements, want.elements), (got.scales, want.scales)):
        np.testing.assert_array_equal(g.view(torch.uint8).numpy(),
                                      v.view(torch.uint8).numpy())
    assert linear.quantize_weights({"w": w}, WIDE)["w"] is w


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("fmt", FMTS)
def test_mx_dot_weight_only(data, fmt, mode):
    x, _, weights = data
    want = np.asarray(jmx_dot(jnp.asarray(x), weights[fmt], mode=mode))
    got = mx_dot(torch.from_numpy(x), _port(weights[fmt]), mode=mode)
    assert got.shape == (2, 8, D_OUT) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("fmt", FMTS)
def test_mx_dot_mx_by_mx(data, fmt, mode):
    x, _, weights = data
    xq = tquantize(torch.from_numpy(x), fmt, 32)
    jxq = jquantize(jnp.asarray(x), fmt, 32)
    want = np.asarray(jmx_dot(jxq, weights[fmt], mode=mode))
    got = mx_dot(xq, _port(weights[fmt]), mode=mode)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_mx_dot_rejects_unknown_mode(data):
    x, _, weights = data
    with pytest.raises(ValueError):
        mx_dot(torch.from_numpy(x), _port(weights["fp8_e4m3"]), mode="fast")


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("quantize_acts", [False, True])
def test_linear_apply_mx_weights(data, mode, quantize_acts):
    x, _, weights = data
    fmt = "fp8_e4m3"
    # activations in the weights' format, so that "pallas" may take them
    jq = JMXFP8.replace(mode=mode, quantize_acts=quantize_acts, act_fmt=fmt)
    tq = MXFP8.replace(mode=mode, quantize_acts=quantize_acts, act_fmt=fmt)
    if mode == "pallas":
        a = (jquantize(jnp.asarray(x), fmt, 32) if quantize_acts
             else jnp.asarray(x).astype(jnp.bfloat16))
        want = jmx_dot(a, weights[fmt], mode="pallas").astype(jnp.bfloat16)
    else:
        want = jlinear.apply({"w": weights[fmt]}, jnp.asarray(x), jq)
    got = linear.apply({"w": _port(weights[fmt])}, torch.from_numpy(x),
                       quant=tq)
    assert got.dtype == torch.bfloat16 and got.shape == (2, 8, D_OUT)
    _assert_bf16_close(got, want)


def test_linear_apply_mxfp8_acts_raise_under_pallas(data):
    # MXFP8 quantizes activations as e5m2 and weights as e4m3: the MX x MX
    # kernels take one format, so the reference's kernel path raises, and
    # so does the port's
    x, _, weights = data
    jxq = jquantize(jnp.asarray(x), JMXFP8.activation_format, 32)
    with pytest.raises(ValueError):
        jmx_dot(jxq, weights["fp8_e4m3"], mode="pallas")
    with pytest.raises(ValueError, match="configs differ"):
        linear.apply({"w": _port(weights["fp8_e4m3"])}, torch.from_numpy(x),
                     quant=MXFP8.replace(mode="pallas"))


def test_linear_apply_wide_weights(data):
    x, w, _ = data
    want = jlinear.apply({"w": jnp.asarray(w)}, jnp.asarray(x), JWIDE)
    got = linear.apply({"w": torch.from_numpy(w)}, torch.from_numpy(x),
                       quant=WIDE)
    _assert_bf16_close(got, want)


@pytest.mark.parametrize("fmt", FMTS)
def test_linear_apply_wide_master_fake_quantized(data, fmt):
    # weight-only MX on a wide f32 master: both fake-quantize it at use
    x, w, _ = data
    want = jlinear.apply({"w": jnp.asarray(w)}, jnp.asarray(x),
                         JMXFP8.replace(fmt=fmt, quantize_acts=False))
    got = linear.apply({"w": torch.from_numpy(w)}, torch.from_numpy(x),
                       quant=MXFP8.replace(fmt=fmt, quantize_acts=False))
    assert got.dtype == torch.bfloat16 and got.shape == (2, 8, D_OUT)
    _assert_bf16_close(got, want)


def test_linear_apply_wide_master_with_mx_acts_raises(data):
    # a wide f32 master under quantize_acts takes the reference's QAT
    # product (both operands block-quantized), bit-equal, never a silent
    # wide product; linear.apply maps the "pallas" mode to "fused" as the
    # reference does, and a direct qat_matmul(mode="pallas") (the kernel
    # tier's product) gives the reference's bits too; an unknown mode
    # raises
    x, w, _ = data
    for mode in ("fused", "pallas"):
        want = jlinear.apply({"w": jnp.asarray(w)}, jnp.asarray(x),
                             JMXFP8.replace(mode=mode))
        got = linear.apply({"w": torch.from_numpy(w)}, torch.from_numpy(x),
                           quant=MXFP8.replace(mode=mode))
        assert got.dtype == torch.bfloat16 and got.shape == (2, 8, D_OUT)
        np.testing.assert_array_equal(
            got.float().numpy(), np.asarray(want.astype(jnp.float32)))
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    want = jqat(xb, jnp.asarray(w), "fp8_e4m3", 32, True, "pallas",
                jnp.float32, "off")
    got = qat_matmul(torch.from_numpy(np.array(xb.astype(jnp.float32)))
                     .bfloat16(), torch.from_numpy(w), mode="pallas")
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))
    with pytest.raises(ValueError, match="mode"):
        qat_matmul(torch.from_numpy(x), torch.from_numpy(w), mode="tiled")
