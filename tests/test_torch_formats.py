"""The port's MX numerics against ``repro.core``, bit for bit.

Same numpy inputs through ``repro.core`` (JAX on the CPU) and
``repro_torch.core``: E8M0 bytes and decoded scales, grid snaps and
stored codes of all five element formats (fp8 e4m3/e5m2, fp6 e3m2/e2m3,
fp4 e2m1), fp4/fp6 packing, whole-array ``quantize``/``fake_quant`` codes
and values, for f32 and bf16 inputs. The grids are exhaustive where the
format is small: every code, every RNE midpoint between neighbouring
codes, every biased E8M0 byte, every finite bf16 value, amax at every
power of two from the subnormal range to the top, plus saturation and
signed zeros. The reference computes with subnormals flushed, and the
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
from repro.kernels import mx_quantize as jmq  # noqa: E402
from repro_torch.core import quantize as tquantize  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402

FP8 = ["fp8_e4m3", "fp8_e5m2"]
SUB_BYTE = ["fp6_e3m2", "fp6_e2m3", "fp4_e2m1"]
ALL_FMTS = FP8 + SUB_BYTE
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
@pytest.mark.parametrize("fmt", ALL_FMTS)
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


@pytest.mark.parametrize("fmt", ALL_FMTS)
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
    # every element format of the reference is ported; what stays
    # unported is an fp6 operand of the matmul kernels, which the
    # reference does not take either (repro/core/policy.py)
    for fmt in ALL_FMTS:
        assert TF.get_format(fmt).name == fmt
    with pytest.raises(KeyError):
        TF.get_format("fp8_e3m4")
    for fmt in ("fp6_e3m2", "fp6_e2m3"):
        w = tquantize(torch.ones(64, 8), fmt, 32, axis=0)
        with pytest.raises(ValueError):
            tops.mx_matmul(torch.ones(2, 64), w)


# ---------------------------------------------------------------------------
# fp4 / fp6: codes, packing, casts
# ---------------------------------------------------------------------------


def _sub_byte_grid(fmt) -> np.ndarray:
    """Every magnitude of the format (the reference's scalar spec grid),
    both signs, every midpoint (the RNE ties), out-of-range magnitudes,
    f32 subnormals and signed zeros."""
    mags = JF.scalar_code_grid(fmt).astype(np.float32)
    mids = (mags[:-1] + mags[1:]) / 2
    top = TF.get_format(fmt).max
    extra = np.array([top * 1.01, top * 4, 1e30, 1e-45, 1e-40, 0.0],
                     np.float32)
    return np.concatenate([mags, -mags, mids, -mids, extra, -extra]
                          ).astype(np.float32)


@pytest.mark.parametrize("fmt", ALL_FMTS)
def test_cast_to_format_value_every_code_and_midpoint(fmt):
    x = _sub_byte_grid(fmt)
    np.testing.assert_array_equal(
        _bits(TF.cast_to_format_value(torch.from_numpy(x), fmt)),
        _bits(JF.cast_to_format_value(jnp.asarray(x), fmt)))


@pytest.mark.parametrize("fmt", SUB_BYTE)
def test_sub_byte_codes_every_code_and_midpoint(fmt):
    x = _sub_byte_grid(fmt)
    if fmt == "fp4_e2m1":
        got, want = TF.fp4_encode(torch.from_numpy(x)), JF.fp4_encode(
            jnp.asarray(x))
        # the kernels' arithmetic encoder (mx_quantize._encode_fp4_codes),
        # whose CUDA counterpart is csrc/mx_codec.cuh::encode_fp4
        kern = jmq._encode_fp4_codes(jnp.asarray(x))
    else:
        got = TF.fp6_encode(torch.from_numpy(x), fmt)
        want = JF.fp6_encode(jnp.asarray(x), fmt)
        kern = jmq._encode_fp6_codes(jnp.asarray(x), JF.get_format(fmt))
    np.testing.assert_array_equal(_bits(got), _bits(want))
    np.testing.assert_array_equal(_bits(got), _bits(kern))


@pytest.mark.parametrize("fmt", SUB_BYTE)
def test_sub_byte_decode_every_code(fmt):
    n = 16 if fmt == "fp4_e2m1" else 64
    codes = np.arange(n, dtype=np.uint8)
    if fmt == "fp4_e2m1":
        got = TF.fp4_decode(torch.from_numpy(codes))
        want = JF.fp4_decode(jnp.asarray(codes))
    else:
        got = TF.fp6_decode(torch.from_numpy(codes), fmt)
        want = JF.fp6_decode(jnp.asarray(codes), fmt)
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("fmt", SUB_BYTE)
def test_sub_byte_pack_unpack_and_storage(fmt):
    rng = np.random.default_rng(3)
    bits = 4 if fmt == "fp4_e2m1" else 6
    codes = rng.integers(0, 2 ** bits, (5, 96)).astype(np.uint8)
    pack, unpack = ((TF.fp4_pack, TF.fp4_unpack) if bits == 4
                    else (TF.fp6_pack, TF.fp6_unpack))
    jpack = JF.fp4_pack if bits == 4 else JF.fp6_pack
    packed = pack(torch.from_numpy(codes))
    assert packed.shape == (5, 96 * bits // 8)
    np.testing.assert_array_equal(_bits(packed),
                                  _bits(jpack(jnp.asarray(codes))))
    np.testing.assert_array_equal(unpack(packed).numpy(), codes)
    # whole storage path: values -> packed bytes -> values
    x = np.tile(_sub_byte_grid(fmt), 4)[:4 * (len(_sub_byte_grid(fmt))
                                              // 4)]
    stored = TF.encode_elements(torch.from_numpy(x), fmt)
    np.testing.assert_array_equal(
        _bits(stored), _bits(JF.encode_elements(jnp.asarray(x), fmt)))
    np.testing.assert_array_equal(
        _bits(TF.decode_elements(stored, fmt)),
        _bits(JF.decode_elements(jnp.asarray(stored.numpy()), fmt)))
    with pytest.raises(ValueError):
        pack(torch.zeros(3, 2 if bits == 6 else 3, dtype=torch.uint8))


def _bf16_grid_blocks(block: int) -> np.ndarray:
    """Every finite bf16 value, 31 to a block, each block led by an amax
    drawn from every binade: bf16-exact f32 values."""
    pats = np.arange(2 ** 16, dtype=np.uint32)
    vals = (pats << 16).view(np.float32)
    vals = vals[np.isfinite(vals)]
    rng = np.random.default_rng(5)
    vals = rng.permutation(vals)
    per = block - 1
    n = -(-len(vals) // (4 * per)) * 4
    body = np.zeros(n * per, np.float32)
    body[:len(vals)] = vals
    lead = np.exp2(np.arange(n) % 254 - 126.0).astype(np.float32)
    x = np.concatenate([lead[:, None], body.reshape(n, per)], axis=1)
    return x.reshape(-1, 4 * block)


@pytest.mark.parametrize("fmt", ALL_FMTS)
def test_quantize_bf16_inputs_bit_exact(fmt):
    # the reference quantizes bf16 inputs in bf16, the port in f32: the
    # codes agree because the amax and the power-of-two division are
    # exact in bf16 and every clip bound is a bf16 value
    for x in (_bf16_grid_blocks(32),
              _quantize_inputs(32, seed=9).astype(np.float32)):
        xb = torch.from_numpy(x).bfloat16()
        want = jquantize(jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16),
                         fmt, 32)
        got = tquantize(xb, fmt, 32)
        np.testing.assert_array_equal(_bits(got.elements),
                                      _bits(want.elements))
        np.testing.assert_array_equal(_bits(got.scales), _bits(want.scales))
        np.testing.assert_array_equal(
            _bits(got.dequantize(torch.bfloat16).float()),
            _bits(np.asarray(want.dequantize(jnp.bfloat16)
                             .astype(jnp.float32))))
