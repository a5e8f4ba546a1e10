"""The port's fused quantize kernel against the reference's.

``repro_torch.kernels.ops.quantize_pallas`` on CPU tensors runs the
kernel's plain PyTorch version; ``repro.kernels.quantize_pallas`` runs
the Pallas kernel in interpret mode, as the reference's own tests do.
Both get the same numpy inputs, whose blocks include all-zero blocks,
all-subnormal blocks, blocks whose amax is normal while some elements are
subnormal, signed zeros and values that saturate. Element bytes and E8M0
scales must be identical for all five formats, f32 and bf16 inputs.

The CUDA kernel is held to the plain version on the card by the
``cuda``-marked test below and by ``chip_smoke.py``. The reference is
imported by a fixture, so that the ``cuda`` test also runs where JAX is
not installed.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import mx_quantize as tmq  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

FMTS = ["fp8_e4m3", "fp8_e5m2", "fp6_e3m2", "fp6_e2m3", "fp4_e2m1"]


@pytest.fixture(scope="module")
def J():
    """The reference (JAX on the CPU)."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import quantize_pallas

    return jnp, quantize_pallas


def _bytes(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.contiguous().view(torch.uint8).numpy()
    return np.asarray(x).view(np.uint8)


def make_input(shape, block: int, seed: int) -> np.ndarray:
    """Random rows at many scales with the corner blocks written in."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float64)
    rows = x.reshape(-1, shape[-1])
    rows *= np.exp2(rng.integers(-20, 20, size=(rows.shape[0], 1)))
    flat = rows.reshape(-1).astype(np.float32)
    flat = flat.reshape(-1, block)
    flat[0] = 0.0  # zero block: E8M0 byte 0
    flat[1] = rng.normal(size=block) * 1e-39  # all subnormal
    flat[2, ::2] = 1e-40  # normal amax, subnormal elements
    flat[2, 1::2] = rng.normal(size=block // 2) * 4.0
    flat[3, :] = -0.0
    flat[3, 1] = 5.0
    flat[4] = rng.normal(size=block) * 2.0 ** 126  # near the top
    flat[5, 0] = 3.0e38
    return flat.reshape(shape).astype(np.float32)


@pytest.mark.parametrize("fmt", FMTS)
@pytest.mark.parametrize("shape,block", [((8, 32), 32), ((64, 256), 32),
                                         ((4, 8, 128), 16), ((16, 512), 64),
                                         ((8, 256), 8), ((8, 256), 128)])
def test_quantize_pallas_bit_exact(J, fmt, shape, block):
    jnp, jquantize_pallas = J
    x = make_input(shape, block, seed=sum(shape) + block)
    want = jquantize_pallas(jnp.asarray(x), fmt, block)
    got = tops.quantize_pallas(torch.from_numpy(x), fmt, block)
    assert got.elements.shape == tuple(want.elements.shape)
    assert got.shape == tuple(want.shape) and got.axis == want.axis
    np.testing.assert_array_equal(_bytes(got.elements),
                                  _bytes(want.elements))
    np.testing.assert_array_equal(_bytes(got.scales), _bytes(want.scales))
    # and against the port's own oracle
    oe, os_ = tref.mx_quantize_ref(torch.from_numpy(x), fmt=fmt,
                                   block_size=block)
    np.testing.assert_array_equal(_bytes(got.elements), _bytes(oe))
    np.testing.assert_array_equal(_bytes(got.scales), _bytes(os_))


@pytest.mark.parametrize("fmt", FMTS)
def test_quantize_pallas_bf16_input(J, fmt):
    jnp, jquantize_pallas = J
    x = torch.from_numpy(make_input((32, 256), 32, seed=4)).bfloat16()
    want = jquantize_pallas(
        jnp.asarray(x.float().numpy()).astype(jnp.bfloat16), fmt, 32)
    got = tops.quantize_pallas(x, fmt, 32)
    np.testing.assert_array_equal(_bytes(got.elements),
                                  _bytes(want.elements))
    np.testing.assert_array_equal(_bytes(got.scales), _bytes(want.scales))


def test_quantize_rejects_bad_inputs():
    with pytest.raises(ValueError):  # block does not divide K
        tmq.mx_quantize(torch.zeros(4, 48), block_size=32)
    with pytest.raises(ValueError):  # fp6 codes do not pack
        tmq.mx_quantize(torch.zeros(4, 6), fmt_name="fp6_e3m2", block_size=2)
    with pytest.raises(TypeError):
        tmq.mx_quantize(torch.zeros(4, 32, dtype=torch.float16))


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    # (33, 48): rows and a K that are not multiples of a warp's step
    cases = [((64, 512), b) for b in (8, 32, 64)] + [((33, 48), 16)]
    for fmt in FMTS:
        for shape, block in cases:
            for dtype in (torch.float32, torch.bfloat16):
                x = torch.from_numpy(make_input(shape, block, seed=block))
                x = x.to(dtype)
                want = tmq.mx_quantize_plain(x, fmt_name=fmt,
                                             block_size=block)
                before = tmq.mx_quantize.launches
                got = tmq.mx_quantize(x.cuda(), fmt_name=fmt,
                                      block_size=block)
                torch.cuda.synchronize()
                assert tmq.mx_quantize.launches == before + 1
                for g, w in zip(got, want):
                    np.testing.assert_array_equal(_bytes(g.cpu()), _bytes(w))
