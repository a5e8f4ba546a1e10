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
not installed. The kernel takes the ratio as x times the exact
reciprocal 2^(127-e) where the reference divides by 2^(e-127); the
identity it relies on is checked here on every E8M0 byte.
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


def sweep_input(stride: int = 2048) -> np.ndarray:
    """Every ``stride``-th f32 bit pattern from +0 to 448, both signs, in
    blocks of 32 led by 448: e4m3's ratio is the value itself (E8M0 127)
    and e5m2's the value times 2^7, so the codes cover each fp8 grid's
    ties and subnormals. (M, 4096) f32 rows, zero-padded."""
    mags = np.arange(0, 0x43E00001, stride, dtype=np.uint32).view(np.float32)
    vals = np.concatenate([mags, -mags])
    rows = np.full(((len(vals) + 30) // 31, 32), 0.0, np.float32)
    rows[:, 0] = 448.0
    rows[:, 1:].reshape(-1)[:len(vals)] = vals
    flat = rows.reshape(-1)
    flat = np.concatenate([flat, np.zeros(-len(flat) % 4096, np.float32)])
    return flat.reshape(-1, 4096)


def _recip_bits(e: np.ndarray) -> np.ndarray:
    """Bits of 2^(127-e) for E8M0 bytes e in [1, 254] (2^-127 subnormal)."""
    return np.where(e < 254, (254 - e) << 23, 0x00400000).astype(np.int32)


@pytest.mark.parametrize("kind", ["normal", "subnormal", "signed_zero"])
def test_ratio_by_exact_reciprocal_equals_divide(kind):
    """x / 2^(e-127) == x * 2^(127-e) bit for bit for every e in 1..254:
    both round the same real value once (no flush to zero), the CUDA
    quantizer's and repack's e8m0_recip."""
    rng = np.random.default_rng(254)
    if kind == "normal":  # every exponent, 64 mantissas each, both signs
        bits = (np.arange(1, 255, dtype=np.int64)[:, None] << 23) \
            | rng.integers(0, 1 << 23, (254, 64))
        bits = np.concatenate([bits.reshape(-1), bits.reshape(-1)
                               | (1 << 31)])
    elif kind == "subnormal":
        bits = rng.integers(1, 1 << 23, 4096)
        bits = np.concatenate([bits, bits | (1 << 31), [1, 0x7FFFFF]])
    else:
        bits = np.array([0, 1 << 31])
    x = torch.from_numpy(bits.astype(np.uint32).view(np.float32))
    e = np.arange(1, 255, dtype=np.int64)
    scale = torch.from_numpy((e << 23).astype(np.int32)).view(torch.float32)
    recip = torch.from_numpy(_recip_bits(e)).view(torch.float32)
    assert torch.equal(scale * recip, torch.ones(254))  # exact reciprocals
    want = (x[None, :] / scale[:, None]).view(torch.int32)
    got = (x[None, :] * recip[:, None]).view(torch.int32)
    assert torch.equal(got, want)
    # the sign survives, a zero quotient's too
    assert torch.equal(got < 0, (x.view(torch.int32) < 0).expand_as(got))
    if kind == "signed_zero":
        assert torch.equal(got, x.view(torch.int32).expand_as(got))
    elif kind == "subnormal":  # by 2^(e-127) >= 1 (e >= 127): still tiny
        assert ((got[126:] & 0x7F800000) == 0).all()


def test_quantize_rejects_bad_inputs():
    with pytest.raises(ValueError):  # block does not divide K
        tmq.mx_quantize(torch.zeros(4, 48), block_size=32)
    with pytest.raises(ValueError):  # fp6 codes do not pack
        tmq.mx_quantize(torch.zeros(4, 6), fmt_name="fp6_e3m2", block_size=2)
    with pytest.raises(TypeError):
        tmq.mx_quantize(torch.zeros(4, 32, dtype=torch.float16))


def cuda_cases(fmt: str) -> list:
    """(shape, block, offset, seed) cases of the card test for one format:
    (64, 512) at blocks 8, 32, 64 and (33, 48), rows and a K off a warp's
    step, at their first seeds; blocks 8-128 at K 4096 (the warp-group
    path); blocks 96 and 256 (one block a warp group); rows one element
    off 16-byte alignment (the scalar tail); fp8 at K % 4 == 1 and fp4 at
    K % 4 == 2 (the scalar tail's partial quads)."""
    cases = [((64, 512), b, 0, b) for b in (8, 32, 64)] + [((33, 48), 16, 0,
                                                             16)]
    new = [((64, 4096), b, 0) for b in (8, 16, 32, 64, 128)]
    new += [((16, 384), 96, 0), ((8, 1024), 256, 0), ((16, 512), 32, 1)]
    if fmt.startswith("fp8"):
        new += [((16, 4097), 1, 0), ((16, 4098), 2, 0)]
    if fmt == "fp4_e2m1":
        new += [((16, 4098), 2, 0), ((16, 4098), 1, 0)]
    return cases + [(shape, block, offset, block + shape[1])
                    for shape, block, offset in new]


def _on_card(x: torch.Tensor, offset: int) -> torch.Tensor:
    """x on the card, its rows ``offset`` elements past an aligned start."""
    if not offset:
        return x.cuda()
    flat = torch.empty(x.numel() + offset, dtype=x.dtype, device="cuda")
    out = flat[offset:].view(x.shape)
    out.copy_(x)
    return out


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    sweep = torch.from_numpy(sweep_input())
    for fmt in FMTS:
        # corner blocks of at least 8 elements (blocks 1 and 2 too)
        inputs = [(make_input(shape, max(block, 8), seed=seed), block,
                   offset) for shape, block, offset, seed in cuda_cases(fmt)]
        inputs.append((sweep.numpy(), 32, 0))
        for x_np, block, offset in inputs:
            for dtype in (torch.float32, torch.bfloat16):
                x = torch.from_numpy(x_np).to(dtype)
                want = tmq.mx_quantize_plain(x, fmt_name=fmt,
                                             block_size=block)
                before = tmq.mx_quantize.launches
                got = tmq.mx_quantize(_on_card(x, offset), fmt_name=fmt,
                                      block_size=block)
                torch.cuda.synchronize()
                assert tmq.mx_quantize.launches == before + 1
                for g, w in zip(got, want):
                    np.testing.assert_array_equal(
                        _bytes(g.cpu()), _bytes(w),
                        err_msg=f"{fmt} {tuple(x.shape)} block {block} "
                                f"{dtype} offset {offset}")
