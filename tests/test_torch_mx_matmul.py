"""The port's MX matmul family against the reference's kernels.

``repro_torch.kernels.ops.mx_matmul`` (and the dgrad wrapper behind
``mx_matmul_trainable``) on CPU tensors runs the kernels' plain PyTorch
versions; ``repro.kernels`` runs the Pallas kernels in interpret mode, as
the reference's own tests do. Both get the same MX operands: the port
quantizes seeded numpy data (its codes equal the reference's bit for
bit, ``tests/test_torch_formats.py``) and the bytes are carried across,
since the reference's eager quantizer takes seconds per new shape on the
CPU. Shapes, formats and block sizes are those of
``tests/test_kernels.py`` and ``tests/test_kernels_extended.py``.

Tolerances. f32 accumulation: rtol 1e-5, atol 1e-4, the reference's own
bar; the two sum the same exact f32 products in another order. bf16
accumulation: each K tile's f32 partial is rounded to bf16 and added to
the bf16 output at the reference's points, so the two sides differ only
where a partial that differs in its last f32 bits rounds one bf16 ulp
apart. Two limits: more than 99% of the outputs are bit-identical, and
every output lies within two bf16 ulps of the largest |partial| or
|running sum| it meets in the tile loop. A skipped tile or a rounding
point in the wrong place breaks the first; the second bounds the rest.

The CUDA kernels are held to the plain versions on the card by the
``cuda``-marked test below and by ``chip_smoke.py``. The reference is
imported by a fixture, so that the ``cuda`` test also runs where JAX is
not installed.
"""
import math
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import quantize as tquantize  # noqa: E402
from repro_torch.kernels import mx_matmul as tmm  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

FMTS = ["fp8_e4m3", "fp8_e5m2", "fp4_e2m1"]
RTOL, ATOL = 1e-5, 1e-4


@pytest.fixture(scope="module")
def J():
    """The reference (JAX on the CPU) and what the tests call of it."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.core.mx_tensor import MXTensor
    from repro.kernels import mx_matmul, mx_matmul_trainable
    from repro.kernels.mx_matmul import mx_matmul_dgrad

    fp8 = {"fp8_e4m3": jnp.float8_e4m3fn, "fp8_e5m2": jnp.float8_e5m2}

    def to_jax(t):
        """The port's MXTensor as the reference's (same bytes)."""
        raw = t.elements.contiguous().view(torch.uint8).numpy()
        elems = raw.view(fp8[t.fmt_name]) if t.fmt_name in fp8 else raw
        return MXTensor(jnp.asarray(elems), jnp.asarray(t.scales.numpy()),
                        t.fmt_name, t.block_size, t.axis, t.shape)

    return types.SimpleNamespace(jax=jax, jnp=jnp, mx=to_jax,
                                 matmul=mx_matmul,
                                 trainable=mx_matmul_trainable,
                                 dgrad=mx_matmul_dgrad)


def _rand(rng, shape, scale=1.0) -> np.ndarray:
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _operands(fmt, m, k, n, block=32, seed=0, a_scale=2.0, b_scale=0.5):
    """x (m, k) f32 numpy, its MX quantization and w (k, n)'s, blocked
    along k, as port tensors."""
    rng = np.random.default_rng(seed)
    x, w = _rand(rng, (m, k), a_scale), _rand(rng, (k, n), b_scale)
    return (x, tquantize(torch.from_numpy(x), fmt, block),
            tquantize(torch.from_numpy(w), fmt, block, axis=0))


def bf16_acc_bound(a: torch.Tensor, b: torch.Tensor, bk: int) -> np.ndarray:
    """Two bf16 ulps of the largest |partial| or |running sum| that each
    output meets in the bf16 tile loop (see the module docstring); ``a``
    (M, K) and ``b`` (K, N) are the wide f32 operands, scales folded in."""
    a, b = a.float().cpu(), b.float().cpu()
    out = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.bfloat16)
    big = torch.zeros(out.shape)
    for k0 in range(0, a.shape[1], bk):
        p = a[:, k0:k0 + bk] @ b[k0:k0 + bk]
        out = (out.float() + p.bfloat16().float()).bfloat16()
        big = torch.maximum(big, torch.maximum(p.abs(), out.float().abs()))
    big = big.numpy()
    ulp = np.exp2(np.floor(np.log2(np.maximum(big, 1e-30))) - 7)
    return 2 * np.where(big > 0, ulp, 0.0)


# ---------------------------------------------------------------------------
# MX x MX
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fmt", FMTS)
@pytest.mark.parametrize("m,k,n", [(8, 32, 8), (16, 64, 128), (128, 256, 64),
                                   (256, 1024, 128), (64, 512, 96)])
def test_mx_matmul_vv_shapes(J, fmt, m, k, n):
    _, xq, wq = _operands(fmt, m, k, n, seed=m + k + n)
    want = np.asarray(J.matmul(J.mx(xq), J.mx(wq)))
    got = tops.mx_matmul(xq, wq)
    assert got.dtype == torch.float32 and got.shape == (m, n)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    # and the port's own Eq. (2) oracle
    oracle = tref.mx_matmul_ref(xq.elements, xq.scales, wq.elements,
                                wq.scales, fmt=fmt)
    np.testing.assert_allclose(got.numpy(), oracle.numpy(), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("block_size", [8, 16, 32, 64, 128])
def test_mx_matmul_software_defined_block_sizes(J, block_size):
    _, xq, wq = _operands("fp8_e4m3", 32, 256, 32, block=block_size,
                          a_scale=1.0, b_scale=1.0)
    want = np.asarray(J.matmul(J.mx(xq), J.mx(wq)))
    got = tops.mx_matmul(xq, wq)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    # weight-only at the same block size
    x = xq.dequantize()
    want = np.asarray(J.matmul(J.jnp.asarray(x.numpy()), J.mx(wq)))
    got = tops.mx_matmul(x, wq)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("fmt", FMTS)
@pytest.mark.parametrize("variant", ["vv", "wo"])
def test_mx_matmul_bf16_accumulation(J, fmt, variant):
    # K = 1024 runs two 512-wide K tiles: two bf16 rounding points
    m, k, n = 32, 1024, 48
    x, xq, wq = _operands(fmt, m, k, n, seed=11, a_scale=1.0, b_scale=1.0)
    a = J.mx(xq) if variant == "vv" else J.jnp.asarray(x)
    ta = xq if variant == "vv" else torch.from_numpy(x)
    want = np.asarray(J.matmul(a, J.mx(wq), acc_dtype=J.jnp.bfloat16)
                      .astype(J.jnp.float32))
    got = tops.mx_matmul(ta, wq, acc_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    a_wide = xq.dequantize() if variant == "vv" else torch.from_numpy(x)
    err = np.abs(got.float().numpy() - want)
    assert (err <= bf16_acc_bound(a_wide, wq.dequantize(), 512)).all(), \
        err.max()
    # the rounding points are the reference's: almost every output agrees
    assert (err == 0).mean() > 0.99


def test_mx_matmul_batched_lead_dims(J):
    rng = np.random.default_rng(2)
    x = _rand(rng, (2, 4, 8, 64))
    wq = tquantize(torch.from_numpy(_rand(rng, (64, 32))), "fp8_e4m3", 32,
                   axis=0)
    xq = tquantize(torch.from_numpy(x), "fp8_e4m3", 32)
    want = np.asarray(J.matmul(J.mx(xq), J.mx(wq)))
    got = tops.mx_matmul(xq, wq)
    assert got.shape == (2, 4, 8, 32)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    got_wo = tops.mx_matmul(torch.from_numpy(x), wq)
    np.testing.assert_allclose(
        got_wo.numpy(), np.asarray(J.matmul(J.jnp.asarray(x), J.mx(wq))),
        rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# weight-only
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fmt", FMTS)
@pytest.mark.parametrize("m,k,n", [(8, 64, 8), (64, 512, 96), (128, 256, 128)])
def test_mx_matmul_wo_shapes(J, fmt, m, k, n):
    x, _, wq = _operands(fmt, m, k, n, seed=3 * m + n, a_scale=1.0,
                         b_scale=1.0)
    want = np.asarray(J.matmul(J.jnp.asarray(x), J.mx(wq)))
    got = tops.mx_matmul(torch.from_numpy(x), wq)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    oracle = tref.mx_matmul_wo_ref(torch.from_numpy(x), wq.elements,
                                   wq.scales, fmt=fmt)
    np.testing.assert_allclose(got.numpy(), oracle.numpy(), rtol=RTOL,
                               atol=ATOL)
    # bf16 activations, as the weight-only linear layer feeds them
    xb = torch.from_numpy(x).bfloat16()
    want = np.asarray(J.matmul(J.jnp.asarray(xb.float().numpy())
                               .astype(J.jnp.bfloat16), J.mx(wq)))
    got = tops.mx_matmul(xb, wq)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# dgrad and the trainable entry point
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fmt", FMTS)
@pytest.mark.parametrize("m,k,n,block", [(8, 64, 32, 32), (64, 512, 96, 32),
                                         (32, 256, 64, 8),
                                         (32, 256, 64, 64)])
def test_mx_dgrad_vs_reference_kernel(J, fmt, m, k, n, block):
    rng = np.random.default_rng(m + k + n + block)
    w, dy = _rand(rng, (k, n)), _rand(rng, (m, n))
    tw = tquantize(torch.from_numpy(w), fmt, block, axis=0)
    wq = J.mx(tw)
    want = np.asarray(J.dgrad(J.jnp.asarray(dy), wq.elements, wq.scales,
                             fmt_name=fmt, block_size=block,
                             bm=tops._tile(m, 128), bn=tops._tile(n, 128),
                             bk=max(tops._tile(k, 512), block),
                             interpret=True))
    got = tmm.mx_matmul_dgrad(torch.from_numpy(dy), tw.elements, tw.scales,
                              fmt_name=fmt, block_size=block,
                              bn=tops._tile(n, 128))
    assert got.shape == (m, k) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("fmt", FMTS)
def test_mx_matmul_trainable_dx_matches_jax_grad(J, fmt):
    rng = np.random.default_rng(21)
    x = _rand(rng, (2, 8, 64))
    tw = tquantize(torch.from_numpy(_rand(rng, (64, 48))), fmt, 32, axis=0)
    wq = J.mx(tw)
    dy = _rand(rng, (2, 8, 48))

    def loss(v):
        return J.jnp.sum(J.trainable(v, wq, fmt, 32, J.jnp.float32)
                       * J.jnp.asarray(dy))

    want = np.asarray(J.jax.grad(loss)(J.jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_()
    y = tops.mx_matmul_trainable(xt, tw, fmt, 32)
    want_y = J.trainable(J.jnp.asarray(x), wq, fmt, 32, J.jnp.float32)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want_y),
                               rtol=RTOL, atol=ATOL)
    y.backward(torch.from_numpy(dy))
    assert xt.grad.dtype == torch.float32
    np.testing.assert_allclose(xt.grad.numpy(), want, rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# what the kernels refuse
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fmt", ["fp6_e3m2", "fp6_e2m3"])
def test_fp6_operands_raise(fmt):
    w = tquantize(torch.ones(64, 8), fmt, 32, axis=0)
    with pytest.raises(ValueError):
        tops.mx_matmul(torch.ones(4, 64), w)
    with pytest.raises(ValueError):
        tops.mx_matmul(tquantize(torch.ones(4, 64), fmt, 32), w)
    with pytest.raises(ValueError):
        tmm.mx_matmul_dgrad(torch.ones(4, 8), w.elements, w.scales,
                            fmt_name=fmt, bn=8)


def test_mismatched_or_misplaced_operands_raise():
    w = tquantize(torch.ones(64, 8), "fp8_e4m3", 32, axis=0)
    with pytest.raises(ValueError, match="configs differ"):  # e5m2 x e4m3
        tops.mx_matmul(tquantize(torch.ones(4, 64), "fp8_e5m2", 32), w)
    with pytest.raises(ValueError, match="configs differ"):  # block sizes
        tops.mx_matmul(tquantize(torch.ones(4, 64), "fp8_e4m3", 16), w)
    with pytest.raises(ValueError, match="axis 0"):
        tops.mx_matmul(torch.ones(4, 8),
                       tquantize(torch.ones(8, 64), "fp8_e4m3", 32))
    for a in (torch.ones(4, 32), tquantize(torch.ones(4, 32), "fp8_e4m3",
                                           32)):
        with pytest.raises(ValueError):  # K of a and b differ
            tops.mx_matmul(a, w)


# ---------------------------------------------------------------------------
# the tensor-core kernels' premises and plan (CPU)
# ---------------------------------------------------------------------------

# granite-8b's seven projections as (K, N), and the M of a decode step, a
# small batch, a ragged chunk and a ragged step
PROJ = {"wq": (4096, 4096), "wk": (4096, 1024), "wv": (4096, 1024),
        "wo": (4096, 4096), "gate": (4096, 14336), "up": (4096, 14336),
        "down": (14336, 4096)}
PLAN_MS = [1, 8, 64, 77, 512]
# finite MX values, one per (code, E8M0 byte): the kernels decode each to
# bf16 and multiply on the tensor cores, which is exact only if every one
# of them is a bf16 value
FINITE_VALUES = {"fp8_e4m3": 64210, "fp8_e5m2": 62280, "fp4_e2m1": 4068}


@pytest.mark.parametrize("fmt", FMTS)
def test_every_mx_value_is_exact_in_bf16(fmt):
    f = tmm.F.get_format(fmt)
    if f.packed:  # the 16 nibbles, low first
        codes = torch.arange(16, dtype=torch.uint8)
        row, k = (codes[0::2] | (codes[1::2] << 4)).to(torch.uint8), 16
    else:
        row = torch.arange(256, dtype=torch.uint8).view(f.storage_dtype)
        k = 256
    scales = torch.arange(256, dtype=torch.uint8)[:, None]  # every E8M0 byte
    v = tmm.F.dequantize_blocks(row.repeat(256, 1), scales, f, k)
    finite = torch.isfinite(v)
    assert int(finite.sum()) == FINITE_VALUES[fmt]
    assert torch.equal(v[finite].bfloat16().float(), v[finite])


def _stress_rows(rng, m, k) -> np.ndarray:
    """The quantizer's stress rows of ``chip_smoke.quantize_input`` (rows at
    many scales; zero, subnormal, mixed, signed-zero, near-overflow and
    saturating rows), built with numpy."""
    x = rng.normal(size=(m, k)) * np.exp2(
        rng.integers(-20, 20, size=(m, 1)).astype(np.float64))
    x = x.astype(np.float32)
    x[0] = 0.0
    x[1] = (rng.normal(size=k) * 1e-39).astype(np.float32)
    x[2, ::2] = 1e-40
    x[3] = -0.0
    x[3, 1::32] = 5.0
    x[4] = (rng.normal(size=k) * 2.0 ** 120).astype(np.float32)
    x[5, ::32] = 3.0e38
    return x


def _log_uniform(rng, n, lo, hi) -> np.ndarray:
    mag = np.exp2(rng.uniform(np.log2(lo), np.log2(hi), size=n))
    return (mag * rng.choice([-1.0, 1.0], size=n)).astype(np.float32)


BF16_MAX = float(torch.finfo(torch.bfloat16).max)
F32_MAX = float(np.finfo(np.float32).max)
SPLIT_INPUTS = {
    "stress_rows": lambda rng: _stress_rows(rng, 16, 256).ravel(),
    "log_uniform": lambda rng: _log_uniform(rng, 100_000, 2.0 ** -110,
                                            BF16_MAX),
    # above bf16's largest finite value rounding hi to bf16 would overflow;
    # truncation does not
    "near_f32_max": lambda rng: _log_uniform(rng, 10_000, BF16_MAX, F32_MAX),
    "edges": lambda rng: np.array(
        [2.0 ** -110, -(2.0 ** -110), 2.0 ** -126, 1.0, -1.0 - 2.0 ** -23,
         1.0 + 2.0 ** -16 + 2.0 ** -23, BF16_MAX, F32_MAX, -F32_MAX,
         np.nextafter(np.float32(2.0 ** -110), np.float32(1.0))],
        dtype=np.float32)}


@pytest.mark.parametrize("name", sorted(SPLIT_INPUTS))
def test_bf16x3_split_reproduces_f32_exactly(name):
    """The f32 A's three bf16 terms sum back to the flushed value exactly
    for 2^-110 <= |a| (and up to f32's largest), so the three exact
    products add up to the f32 product's terms."""
    a = torch.from_numpy(SPLIT_INPUTS[name](np.random.default_rng(7)))
    af = tmm.F.flush_subnormals(a)
    hi, mid, lo = tmm.bf16x3_split(af)
    assert hi.dtype == mid.dtype == lo.dtype == torch.bfloat16
    total = hi.double() + mid.double() + lo.double()
    covered = (af.abs() >= 2.0 ** -110) | (af == 0)
    assert covered.any()
    assert torch.equal(total[covered], af.double()[covered])
    # below the range only lo's bf16 rounding is lost
    assert ((total - af.double()).abs() <= 2.0 ** -134).all()


@pytest.mark.parametrize("proj", sorted(PROJ))
@pytest.mark.parametrize("m", PLAN_MS)
def test_split_plan_covers_every_tile_once(m, proj):
    k, n = PROJ[proj]
    bk = max(tops._tile(k, 512), 32)
    for fmt in FMTS:
        for a_kind in tmm.A_KINDS:
            for acc in (torch.float32, torch.bfloat16):
                plan = tmm.matmul_plan(m, n, k, bk, fmt, 32, a_kind, acc)
                ranges = plan.ranges()
                assert len(ranges) == plan.splits >= 1
                tiles = [t for t0, t1 in ranges for t in range(t0, t1)]
                assert tiles == list(range(k // bk)) == \
                    list(range(plan.k_tiles))  # each once, ascending
                assert all(t1 > t0 for t0, t1 in ranges)
                slots = 0 if plan.splits == 1 else (
                    plan.k_tiles if acc == torch.bfloat16 else plan.splits)
                assert plan.workspace_shape(m, n) == (slots, m, n)
                assert plan.lean and plan.w == tmm.STAGE_K
                assert plan.m_tiles * plan.bm >= m > (plan.m_tiles - 1) \
                    * plan.bm
                assert plan.n_tiles * tmm.TILE_N >= n
                if a_kind == "f32" or acc == torch.bfloat16:
                    assert plan.bm <= 64
                # a split only where the (m, n) tiles leave SMs idle
                ctas = plan.m_tiles * plan.n_tiles
                assert plan.splits == 1 or ctas * 2 <= tmm.SMS * (
                    2 if plan.bm == 16 else 1)


@pytest.mark.parametrize("m,k,n,block,fmt,lean", [
    (77, 4160, 1000, 32, "fp8_e4m3", False),   # bk 64, 130 E8M0 bytes a row
    (5, 40, 24, 8, "fp8_e4m3", False),        # bk 8: stages of 8
    (3, 6, 5, 2, "fp4_e2m1", False),          # block 2, 3-byte rows
    (4, 9, 7, 3, "fp8_e5m2", False),          # odd block and stage
    (64, 512, 96, 16, "fp4_e2m1", True)])
def test_plan_stages_of_odd_shapes(m, k, n, block, fmt, lean):
    bk = max(tops._tile(k, 512), block)
    plan = tmm.matmul_plan(m, n, k, bk, fmt, block)
    assert bk % plan.w == 0 and plan.w <= min(tmm.STAGE_K, 16 * block)
    assert plan.w % 2 == 0 or not tmm.F.get_format(fmt).packed
    assert plan.lean == lean and (plan.bm <= 64 or lean)
    assert [t for r in plan.ranges() for t in range(*r)] == \
        list(range(k // bk))


@pytest.mark.parametrize("m,n,k,bn,fmt,block,lean", [
    (512, 14336, 4096, 128, "fp8_e4m3", 32, True),   # gate/up, M 512
    (8, 14336, 4096, 128, "fp4_e2m1", 32, True),     # M 8: split over N
    (77, 1000, 4160, 8, "fp8_e5m2", 32, True),       # ragged, stages of 8
    (70, 130, 1024, 130, "fp4_e2m1", 8, True),       # stages of 26
    (33, 64, 256, 64, "fp8_e4m3", 128, True),        # block 128: one tile
    (5, 24, 40, 24, "fp8_e4m3", 8, False),           # 40-byte rows
    (3, 5, 6, 5, "fp4_e2m1", 2, False)])             # block 2, 3-byte rows
def test_dgrad_plan_covers_the_contraction(m, n, k, bn, fmt, block, lean):
    plan = tmm.dgrad_plan(m, n, k, bn, fmt, block)
    assert bn % plan.w == 0 and plan.w <= tmm.STAGE_K
    assert plan.w == max(s for s in range(1, 65) if bn % s == 0)
    assert plan.lean == lean
    assert plan.bm == (16 if m <= 16 else 64)
    assert plan.m_tiles * plan.bm >= m > (plan.m_tiles - 1) * plan.bm
    assert plan.n_tiles * tmm.TILE_N >= k > (plan.n_tiles - 1) * tmm.TILE_N
    assert plan.k_tiles == n // bn
    assert [t for r in plan.ranges() for t in range(*r)] == \
        list(range(n // bn))
    assert plan.ws_slots == (plan.splits if plan.splits > 1 else 0)
    # a split only where the output tiles leave SMs idle
    ctas = plan.m_tiles * plan.n_tiles
    assert plan.splits == 1 or ctas * 2 <= tmm.SMS * (
        2 if plan.bm == 16 else 1)
    assert plan == tmm.dgrad_plan(m, n, k, bn, fmt, block)


def test_dgrad_plan_splits_a_decode_step():
    """At M 8, gate/up's 32 column tiles leave the card idle: the
    contraction splits 8 ways (256 CTAs, two an SM), 14 bn tiles each."""
    plan = tmm.dgrad_plan(8, 14336, 4096, 128, "fp8_e4m3", 32)
    assert (plan.splits, plan.tiles_per_split) == (8, 14)
    assert tmm.dgrad_plan(512, 14336, 4096, 128, "fp8_e4m3", 32).splits == 1


def test_tile_choice_is_the_reference_one():
    assert [tops._tile(k, 512) for k in (4096, 14336, 1024, 96, 40, 6)] == \
        [512, 512, 512, 32, 8, 6]


FIRST_CARD_SHAPES = [(8, 64, 8, 32), (70, 1024, 130, 32), (64, 512, 96, 16),
                     (33, 256, 64, 64)]
#: blocks larger than a 64-element stage and smaller than a k16 step, on
#: the TMA path (K / block a multiple of 16) and the cp.async path, with 8
#: or 9 bk tiles, the contraction split over CTAs (M 77) or not (M 512);
#: then a one-tile contraction at block 128
BLOCK_CARD_SHAPES = [(77, 4096, 1000, 128), (512, 4608, 1040, 128),
                     (512, 4096, 1040, 8), (77, 576, 1000, 8)]
ONE_TILE = (300, 512, 260, 128)


def _card_cases():
    """(format, m, k, n, block, A kinds of wo) of the card test, in the
    order it draws its operands: the first port's shapes (every format;
    wo with a bf16 and, since the tensor-core kernels, an f32 A), then
    granite-8b's seven projections at a decode step's M = 8 (fp8 e4m3, f32
    A at gate), a ragged shape whose bk is 64, blocks 8 and 128 on both
    copy paths and a one-tile contraction (every format)."""
    cases = [(fmt, m, k, n, block, ("bf16", "f32")) for fmt in FMTS
             for (m, k, n, block) in FIRST_CARD_SHAPES]
    cases += [("fp8_e4m3", 8, k, n, 32,
               ("bf16", "f32") if name == "gate" else ("bf16",))
              for name, (k, n) in PROJ.items()]
    cases += [(fmt, 77, 4160, 1000, 32, ("bf16", "f32")) for fmt in FMTS]
    cases += [(fmt, *shape, ("bf16", "f32")) for fmt in FMTS
              for shape in BLOCK_CARD_SHAPES + [ONE_TILE]]
    return cases


def bf16_tile_range(a: torch.Tensor, b: torch.Tensor, bk: int) -> tuple:
    """(exact, lo, hi) of the bf16 tile loop: ``exact`` on exact partials
    (each bk tile's product in f64, rounded once to f32, then the two bf16
    roundings), ``lo`` and ``hi`` on every partial moved down and up by the
    f32 bar, 1e-5 x |A|.|B| of its tile. Each rounding and add is
    monotone, so any loop whose partials lie within the f32 bar of the
    exact ones ends between lo and hi."""
    a, b = a.double().cpu(), b.double().cpu()
    outs = [torch.zeros((a.shape[0], b.shape[1]), dtype=torch.bfloat16)
            for _ in range(3)]
    for k0 in range(0, a.shape[1], bk):
        at, bt = a[:, k0:k0 + bk], b[k0:k0 + bk]
        p, slack = at @ bt, 1e-5 * (at.abs() @ bt.abs())
        for i, q in enumerate((p, p - slack, p + slack)):
            outs[i] = (outs[i].float()
                       + q.float().bfloat16().float()).bfloat16()
    return tuple(o.float().numpy() for o in outs)


@pytest.mark.cuda
def test_cuda_kernels_match_plain_versions():
    """The kernels against their plain versions on the card; every call
    twice, bit-equal. Two kinds of bf16-accumulation case are held to the
    exact tile loop instead (bf16_tile_range: every output within the
    range its partials reach inside the f32 bar, and identical outputs
    counted against it): an f32 A, whose products the plain version
    rounds to f32 (24 + 8 significant bits) where the kernel's three bf16
    terms multiply exactly; and the one-tile contraction, where an output
    that nearly cancels (|partial| ~1e-7 of |A|.|B|) makes any f32 sum's
    order error several bf16 ulps of |partial|."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(0)
    bf16_same = bf16_outputs = dgrad_cases = 0
    for (fmt, m, k, n, block, wide_kinds) in _card_cases():
        x = torch.from_numpy(_rand(rng, (m, k)))
        w = tquantize(torch.from_numpy(_rand(rng, (k, n))), fmt, block,
                      axis=0)
        xq = tquantize(x, fmt, block)
        dy = torch.from_numpy(_rand(rng, (m, n)))
        bk = max(tops._tile(k, 512), block)
        cuda = [t.cuda() for t in (x, xq.elements, xq.scales, w.elements,
                                   w.scales, dy)]
        mag = (x.abs() @ w.dequantize().abs()).numpy()
        wide = {"bf16": x.bfloat16(), "f32": x, "vv": xq.dequantize()}
        for acc in (torch.float32, torch.bfloat16):
            kw = dict(fmt_name=fmt, block_size=block, acc_dtype=acc, bk=bk)
            runs = [("vv",
                     lambda: tmm.mx_matmul_vv(*cuda[1:5], **kw),
                     lambda: tmm.mx_matmul_vv_plain(xq.elements, xq.scales,
                                                    w.elements, w.scales,
                                                    **kw))]
            for kind in wide_kinds:
                a = x.bfloat16() if kind == "bf16" else x
                runs.append((
                    kind,
                    lambda a=a: tmm.mx_matmul_wo(a.cuda(), *cuda[3:5], **kw),
                    lambda a=a: tmm.mx_matmul_wo_plain(a, w.elements,
                                                       w.scales, **kw)))
            for variant, run, plain in runs:
                label = (variant, fmt, m, k, n, acc)
                got, again = run(), run()
                # no float atomics, split or not: the same bits twice
                assert torch.equal(got.view(torch.uint8),
                                   again.view(torch.uint8)), label
                got = got.cpu().float().numpy()
                want = plain().float().numpy()
                if acc == torch.float32:
                    assert (np.abs(got - want) <= 1e-5 * mag + 1e-30).all(), \
                        label
                    continue
                if variant == "f32" or (m, k, n, block) == ONE_TILE:
                    want, lo, hi = bf16_tile_range(wide[variant],
                                                   w.dequantize(), bk)
                    assert ((got >= lo) & (got <= hi)).all(), label
                else:
                    bound = bf16_acc_bound(wide[variant], w.dequantize(), bk)
                    assert (np.abs(got - want) <= bound + 1e-30).all(), label
                bf16_same += int((got == want).sum())
                bf16_outputs += got.size
        # dgrad at every case: fp4, blocks 8 to 128, the ragged shape (a
        # bn of 8), the one tile, and M 8 at the projections (the
        # contraction split over CTAs); two calls, the same bits
        dgrad_kw = dict(fmt_name=fmt, block_size=block,
                        bn=tops._tile(n, 128))
        got = tmm.mx_matmul_dgrad(cuda[5], *cuda[3:5], **dgrad_kw)
        again = tmm.mx_matmul_dgrad(cuda[5], *cuda[3:5], **dgrad_kw)
        assert torch.equal(got.view(torch.int32), again.view(torch.int32)), \
            (fmt, m, k, n, block)
        want = tmm.mx_matmul_dgrad_plain(dy, w.elements, w.scales,
                                         **dgrad_kw)
        mag = (dy.abs() @ w.dequantize().abs().T).numpy()
        assert ((got.cpu() - want).abs().numpy()
                <= 1e-5 * mag + 1e-30).all(), (fmt, m, k, n, block)
        dgrad_cases += 1
    torch.cuda.synchronize()
    assert math.isfinite(float(got.sum()))
    # bf16 accumulation rounds where the plain version rounds
    assert bf16_same > 0.99 * bf16_outputs
    assert dgrad_cases == len(_card_cases())
