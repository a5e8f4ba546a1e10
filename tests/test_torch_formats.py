"""The port's MX numerics against ``repro.core``, bit for bit.

Same numpy inputs through ``repro.core`` (JAX on the CPU) and
``repro_torch.core``: E8M0 bytes and decoded scales, fp8 grid snaps and
stored codes, whole-array ``quantize``/``fake_quant`` codes and values.
The grids are exhaustive where the format is small: every fp8 code, every
RNE midpoint between neighbouring codes, every biased E8M0 byte, amax at
every power of two from the subnormal range to the top, plus saturation
and signed zeros. The reference computes with subnormals flushed, and the
port must agree there too.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.core import fake_quant as jfake_quant  # noqa: E402
from repro.core import formats as JF  # noqa: E402
from repro.core import quantize as jquantize  # noqa: E402
from repro_torch.core import fake_quant as tfake_quant  # noqa: E402
from repro_torch.core import formats as TF  # noqa: E402
from repro_torch.core import quantize as tquantize  # noqa: E402

FP8 = ["fp8_e4m3", "fp8_e5m2"]
_NP_FP8 = {"fp8_e4m3": jnp.float8_e4m3fn, "fp8_e5m2": jnp.float8_e5m2}


def _bits(x) -> np.ndarray:
    """Raw bytes of an array from either package, for exact comparison."""
    if isinstance(x, torch.Tensor):
        x = x.contiguous()
        return x.view(torch.uint8).numpy() if x.element_size() == 1 else \
            x.view(torch.int32).numpy()
    x = np.asarray(x)
    return x.view(np.uint8) if x.itemsize == 1 else x.view(np.int32)


def _grid_values(fmt) -> np.ndarray:
    """Every finite code's value, both signs, plus every midpoint between
    neighbouring magnitudes (the RNE ties) and out-of-range magnitudes."""
    codes = np.arange(256, dtype=np.uint8)
    vals = codes.view(_NP_FP8[fmt]).astype(np.float32)
    mags = np.unique(np.abs(vals[np.isfinite(vals)]))
    mids = (mags[:-1] + mags[1:]) / 2
    top = TF.get_format(fmt).max
    extra = np.array([top * 1.01, top * 4, 1e30, 0.0, -0.0], np.float32)
    return np.concatenate([mags, -mags, mids, -mids, extra, -extra]
                          ).astype(np.float32)


def test_e8m0_from_amax_every_power_of_two():
    # 2^-149 .. 2^127: subnormal amax (which the reference flushes), the
    # clip to 0 at the bottom and to 254 at the top
    exps = np.arange(-149, 128)
    amax = np.exp2(exps.astype(np.float64)).astype(np.float32)
    amax = np.concatenate([amax, amax * 1.75, [0.0]]).astype(np.float32)
    for fmt in FP8:
        want = JF.e8m0_from_amax(jnp.asarray(amax), JF.get_format(fmt))
        got = TF.e8m0_from_amax(torch.from_numpy(amax), TF.get_format(fmt))
        np.testing.assert_array_equal(_bits(got), _bits(want))


def test_e8m0_to_scale_every_byte():
    e = np.arange(256, dtype=np.uint8)[:255]  # 0xFF is NaN, never stored
    want = JF.e8m0_to_scale(jnp.asarray(e))
    got = TF.e8m0_to_scale(torch.from_numpy(e))
    np.testing.assert_array_equal(_bits(got), _bits(want))
    assert _bits(got)[0] == 0x00400000  # byte 0 -> the subnormal 2^-127


@pytest.mark.parametrize("fmt", FP8)
def test_snap_and_encode_every_code_and_midpoint(fmt):
    x = _grid_values(fmt)
    top = TF.get_format(fmt).max
    clipped = np.clip(x, -top, top)
    np.testing.assert_array_equal(
        _bits(TF.snap_to_fp8_grid(torch.from_numpy(clipped), fmt)),
        _bits(JF.snap_to_fp8_grid(jnp.asarray(clipped), fmt)))
    np.testing.assert_array_equal(
        _bits(TF.encode_elements(torch.from_numpy(x), fmt)),
        _bits(JF.encode_elements(jnp.asarray(x), fmt)))


def _quantize_inputs(block: int, seed: int) -> np.ndarray:
    """Blocks whose amax sweeps every binade, subnormal ones included,
    with signed zeros, subnormal elements and saturating outliers."""
    rng = np.random.default_rng(seed)
    rows = 320
    x = rng.normal(size=(rows, 4 * block)).astype(np.float64)
    x *= np.exp2(np.arange(rows) % 270 - 150)[:, None]  # 2^-150 .. 2^119
    x = x.astype(np.float32)
    x[0] = 0.0
    x[1] = -0.0
    x[2, ::3] = -0.0
    x[3, :block] = 1e-45  # smallest subnormal
    x[4, 1] = 3.0e38
    return x


@pytest.mark.parametrize("block", [16, 32])
@pytest.mark.parametrize("fmt", FP8)
def test_quantize_codes_and_scales_bit_exact(fmt, block):
    for axis in (-1, 0):
        x = _quantize_inputs(block, seed=block)
        if axis == 0:
            x = np.ascontiguousarray(x.T)
        want = jquantize(jnp.asarray(x), fmt, block, axis=axis)
        got = tquantize(torch.from_numpy(x), fmt, block, axis=axis)
        np.testing.assert_array_equal(_bits(got.elements),
                                      _bits(want.elements))
        np.testing.assert_array_equal(_bits(got.scales), _bits(want.scales))
        np.testing.assert_array_equal(_bits(got.dequantize()),
                                      _bits(want.dequantize()))


@pytest.mark.parametrize("fmt", FP8)
def test_fake_quant_weight_axis0_bit_exact(fmt):
    # the weight-only serving path: (d_in, d_out) f32 masters blocked
    # along d_in, as nn.linear calls it
    rng = np.random.default_rng(7)
    w = (rng.normal(size=(256, 96)) / 16).astype(np.float32)
    want = jfake_quant(jnp.asarray(w), fmt, 32, 0)
    got = tfake_quant(torch.from_numpy(w), fmt, 32, 0)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    np.testing.assert_array_equal(
        _bits(got.to(torch.bfloat16).float()),
        _bits(np.asarray(want.astype(jnp.bfloat16).astype(jnp.float32))))


def test_unported_formats_raise():
    for fmt in ("fp4_e2m1", "fp6_e3m2", "fp6_e2m3"):
        with pytest.raises(NotImplementedError):
            TF.get_format(fmt)
