"""The port's two-pass paged decode against the reference kernels.

``repro_torch.kernels.gather_kv_pages`` and ``mx_attention_decode`` on
CPU tensors run their plain PyTorch versions; the reference's run their
Pallas kernels in interpret mode, as the reference's own tests do
(``tests/test_paged_attention.py``, ``tests/test_kernels_extended.py``),
at those tests' sizes. Both get the same numpy inputs, quantized once.

  * the gather: every output byte equal to the reference's, on fp8
    e4m3/e5m2, packed fp4 and packed fp6 pools, with -1 table entries
    (clamped onto page 0, as in the reference) and spare garbage pages;
  * ``mx_attention_decode_paged`` bit-equal to ``mx_attention_decode``
    on the equivalent contiguous cache (the reference's own claim), and
    within 1e-5 of the reference's paged output;
  * the decode within 1e-5 of the reference kernel and of the ported
    oracle ``mx_attention_decode_ref`` (itself within 1e-5 of the
    reference's), with shared and per-sequence ``kpos``/``pos``, a
    softcap, fp4 and fp6 caches, bf16 queries, and a row whose every key
    is masked (the mean of V, as in the reference).

The two sum f32 products in other orders, hence 1e-5. The ``cuda``-marked
test holds the CUDA kernels to the plain versions on the card and, at
granite-8b's head_dim with logits near 100, the decode kernel and its
plain version both to an f64 decode. The reference is imported by a
fixture, so that the ``cuda`` test also runs where JAX is not installed.
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import quantize as tquantize  # noqa: E402
from repro_torch.kernels import mx_attention as tk  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

OUT_TOL = 1e-5
TORCH_FP8 = {"fp8_e4m3": torch.float8_e4m3fn, "fp8_e5m2": torch.float8_e5m2}


@pytest.fixture(scope="module")
def J():
    """The reference (JAX on the CPU) and what the tests call of it."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.kernels import gather_kv_pages, mx_attention_decode
    from repro.kernels import mx_attention_decode_paged, ref

    fp8 = {"fp8_e4m3": jnp.float8_e4m3fn, "fp8_e5m2": jnp.float8_e5m2}

    def j(elems, fmt=None):
        a = jnp.asarray(elems)
        return a.view(fp8[fmt]) if fmt in fp8 else a

    return types.SimpleNamespace(jnp=jnp, gather=gather_kv_pages,
                                 decode=mx_attention_decode,
                                 paged=mx_attention_decode_paged, ref=ref,
                                 j=j)


def _cache(rng, shape, fmt, block, scale=1.0):
    """(element bytes, E8M0 bytes) of normal values, blocked along the
    last axis."""
    x = (rng.normal(size=shape) * scale).astype(np.float32)
    qx = tquantize(torch.from_numpy(x), fmt, block)
    return qx.elements.view(torch.uint8).numpy(), qx.scales.numpy()


def _t(elems, fmt=None, device="cpu"):
    t = torch.from_numpy(np.array(elems)).to(device)
    return t.view(TORCH_FP8[fmt]) if fmt in TORCH_FP8 else t


def _u8(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.cpu().view(torch.uint8).numpy()
    return np.asarray(x).view(np.uint8)


def paged_case(fmt, block, b, kvh, t, d, ps, rng, g=2):
    """A contiguous (B, KVH, T, .) cache scattered into a shuffled pool
    with three spare pages of garbage bytes (255)."""
    npg = t // ps
    npages = b * npg + 3
    table = rng.permutation(npages)[:b * npg].reshape(b, npg).astype(np.int32)
    cache, pools = {}, {}
    for name in ("k", "v"):
        elems, scales = _cache(rng, (b, kvh, t, d), fmt, block)
        cache[name] = (elems, scales)
        for key, src in ((name + "e", elems), (name + "s", scales)):
            pool = np.full((npages, ps, kvh, src.shape[-1]), 255, np.uint8)
            for i in range(b):
                for p in range(npg):
                    pool[table[i, p]] = src[i, :, p * ps:(p + 1) * ps] \
                        .transpose(1, 0, 2)
            pools[key] = pool
    q = rng.normal(size=(b, kvh, g, d)).astype(np.float32)
    return dict(fmt=fmt, block=block, q=q, cache=cache, pools=pools,
                table=table)


def _pool_args(c, conv):
    return [conv(c["pools"][k], c["fmt"] if k.endswith("e") else None)
            for k in ("ke", "ks", "ve", "vs")]


# ---------------------------------------------------------------------------
# the gather
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fmt,block", [("fp8_e4m3", 32), ("fp8_e5m2", 32),
                                       ("fp4_e2m1", 32), ("fp6_e3m2", 32)])
def test_gather_matches_reference_byte_for_byte(fmt, block, J):
    rng = np.random.default_rng(5)
    c = paged_case(fmt, block, 2, 3, 32, 32, 8, rng)
    table = c["table"].copy()
    table[1, 2:] = -1  # unallocated: the reference clips them to page 0
    want = J.gather(*_pool_args(c, J.j), J.jnp.asarray(table))
    pools = _pool_args(c, _t)
    got = tk.gather_kv_pages(*pools, torch.from_numpy(table))
    for name, gt, wt, pool in zip(("ke", "ks", "ve", "vs"), got, want,
                                  pools):
        assert gt.dtype == pool.dtype
        np.testing.assert_array_equal(_u8(gt), _u8(wt))
        # the clamped rows hold page 0's bytes, not zeros
        page0 = c["pools"][name][0].transpose(1, 0, 2)
        np.testing.assert_array_equal(_u8(gt)[1, :, 16:24], page0)
    # and the live rows are the contiguous cache's
    np.testing.assert_array_equal(_u8(got[0])[0], c["cache"]["k"][0][0])


# ---------------------------------------------------------------------------
# paged against contiguous
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fmt", ["fp8_e4m3", "fp8_e5m2", "fp4_e2m1"])
@pytest.mark.parametrize("block", [16, 32, 64])
def test_paged_equals_contiguous_bit_for_bit(fmt, block, J):
    rng = np.random.default_rng(123)
    b, kvh, d, t, ps = 2, 2, 64, 64, 16
    c = paged_case(fmt, block, b, kvh, t, d, ps, rng)
    lens = np.array([t - 3, t - 17], np.int32)
    q = torch.from_numpy(c["q"])
    (ke, ks), (ve, vs) = c["cache"]["k"], c["cache"]["v"]
    want = []
    for i in range(b):
        kpos = torch.where(torch.arange(t) < int(lens[i]), torch.arange(t),
                           torch.tensor(-1)).to(torch.int32)
        want.append(tk.mx_attention_decode(
            q[i:i + 1], _t(ke[i:i + 1], fmt), _t(ks[i:i + 1]),
            _t(ve[i:i + 1], fmt), _t(vs[i:i + 1]), kpos, int(lens[i]) - 1,
            fmt_name=fmt, block_size=block))
    want = torch.cat(want).numpy()
    got = tk.mx_attention_decode_paged(
        q, *_pool_args(c, _t), torch.from_numpy(c["table"]),
        torch.from_numpy(lens), fmt_name=fmt, block_size=block).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    ref = np.asarray(J.paged(
        J.jnp.asarray(c["q"]), *_pool_args(c, J.j),
        J.jnp.asarray(c["table"]), J.jnp.asarray(lens), fmt_name=fmt,
        block_size=block))
    np.testing.assert_allclose(got, ref, rtol=0, atol=OUT_TOL)


# ---------------------------------------------------------------------------
# the decode against the reference kernel and the oracles
# ---------------------------------------------------------------------------

#: (fmt, block, (b, kvh, g, d, t), kind, q dtype); kind: "tail" = the last
#: 7 slots empty (kpos -1), "softcap", "per_seq" = (B, T) kpos / (B,) pos
#: with a row whose every key is masked
DECODE_CASES = [
    ("fp8_e4m3", 32, (1, 2, 1, 32, 64), "tail", "f32"),
    ("fp8_e5m2", 32, (2, 4, 3, 64, 128), "tail", "f32"),
    ("fp8_e4m3", 32, (1, 8, 2, 128, 256), "tail", "bf16"),
    ("fp8_e4m3", 32, (1, 1, 1, 32, 32), "softcap", "f32"),
    ("fp4_e2m1", 16, (2, 2, 2, 64, 64), "tail", "f32"),
    ("fp4_e2m1", 32, (3, 2, 2, 32, 48), "per_seq", "bf16"),
    ("fp6_e3m2", 32, (2, 2, 2, 64, 64), "tail", "f32"),
    ("fp6_e2m3", 16, (3, 2, 2, 32, 48), "per_seq", "f32"),
    ("fp8_e4m3", 64, (3, 2, 2, 64, 48), "per_seq", "f32"),
]


def decode_case(fmt, block, shape, kind, q_dtype, scale=None, seed=77):
    """Inputs of one decode; q and K are scaled by ``scale`` (5 for the
    softcap, where logits must reach the cap, else 1 by default)."""
    rng = np.random.default_rng(seed)
    b, kvh, g, d, t = shape
    if scale is None:
        scale = 5.0 if kind == "softcap" else 1.0
    q = (rng.normal(size=(b, kvh, g, d)) * scale).astype(np.float32)
    if q_dtype == "bf16":
        q = np.asarray(torch.from_numpy(q).bfloat16().float())
    k = _cache(rng, (b, kvh, t, d), fmt, block, scale)
    v = _cache(rng, (b, kvh, t, d), fmt, block)
    if kind == "per_seq":
        # row 1: no key at or below pos (every key masked)
        kpos = np.stack([np.where(np.arange(t) < n, np.arange(t), -1)
                         for n in (10, t, 33)][:b]).astype(np.int32)
        pos = np.array([9, -1, 32][:b], np.int32)
    else:
        valid = t - 7 if kind == "tail" else t
        kpos = np.where(np.arange(t) < valid, np.arange(t), -1).astype(
            np.int32)
        pos = np.int32(valid - 1)
    return dict(fmt=fmt, block=block, q=q, q_dtype=q_dtype, k=k, v=v,
                kpos=kpos, pos=pos,
                softcap=50.0 if kind == "softcap" else None)


def run_decode_port(c, device="cpu"):
    q = torch.from_numpy(c["q"]).to(device)
    if c["q_dtype"] == "bf16":
        q = q.bfloat16()
    (ke, ks), (ve, vs) = c["k"], c["v"]
    return tk.mx_attention_decode(
        q, _t(ke, c["fmt"], device), _t(ks, device=device),
        _t(ve, c["fmt"], device), _t(vs, device=device),
        torch.from_numpy(np.array(c["kpos"])).to(device),
        torch.from_numpy(np.array(c["pos"])).to(device),
        fmt_name=c["fmt"], block_size=c["block"], softcap=c["softcap"])


def decode_f64(c) -> torch.Tensor:
    """The decode in f64 over the exactly decoded cache (MX values and
    bf16 queries are exact in f64): the result both f32 versions round."""
    (ke, ks), (ve, vs) = c["k"], c["v"]
    fmt = tk.F.get_format(c["fmt"])
    k, v = (tk._dequant_rows(_t(e, c["fmt"]), _t(sc), fmt, c["block"])
            .double() for e, sc in ((ke, ks), (ve, vs)))
    b, _, t, d = k.shape
    logits = torch.einsum("bhgd,bhtd->bhgt", torch.from_numpy(c["q"])
                          .double(), k) * d ** -0.5
    if c["softcap"]:
        logits = torch.tanh(logits / c["softcap"]) * c["softcap"]
    kpos = torch.from_numpy(np.broadcast_to(c["kpos"], (b, t)).copy())
    pos = torch.from_numpy(np.broadcast_to(c["pos"], (b,)).copy())
    keep = (kpos <= pos[:, None]) & (kpos >= 0)
    logits = torch.where(keep[:, None, None], logits,
                         torch.full_like(logits, -2.0e38))
    return torch.einsum("bhgt,bhtd->bhgd", torch.softmax(logits, -1), v)


@pytest.mark.parametrize("fmt,block,shape,kind,q_dtype", DECODE_CASES)
def test_decode_matches_reference_kernel_and_oracle(fmt, block, shape, kind,
                                                    q_dtype, J):
    c = decode_case(fmt, block, shape, kind, q_dtype)
    got = run_decode_port(c).numpy()
    (ke, ks), (ve, vs) = c["k"], c["v"]
    jnp = J.jnp
    jq = jnp.asarray(c["q"], jnp.bfloat16 if q_dtype == "bf16" else None)
    jargs = (J.j(ke, fmt), J.j(ks), J.j(ve, fmt), J.j(vs))
    want = np.asarray(J.decode(jq, *jargs, jnp.asarray(c["kpos"]),
                               jnp.asarray(c["pos"]), fmt_name=fmt,
                               block_size=block, softcap=c["softcap"]))
    np.testing.assert_allclose(got, want, rtol=0, atol=OUT_TOL)
    # the oracles take a shared kpos and a scalar pos: one row at a time
    b = shape[0]
    kpos = np.broadcast_to(c["kpos"], (b, shape[-1]))
    pos = np.broadcast_to(c["pos"], (b,))
    q = torch.from_numpy(c["q"])
    for i in range(b):
        rows = slice(i, i + 1)
        oracle = tref.mx_attention_decode_ref(
            q[rows], _t(ke[rows], fmt), _t(ks[rows]), _t(ve[rows], fmt),
            _t(vs[rows]), torch.from_numpy(kpos[i].copy()), int(pos[i]),
            fmt=fmt, block_size=block, softcap=c["softcap"]).numpy()
        np.testing.assert_allclose(got[rows], oracle, rtol=0, atol=OUT_TOL)
        jax_oracle = np.asarray(J.ref.mx_attention_decode_ref(
            jq[rows], *(a[rows] for a in jargs), jnp.asarray(kpos[i]),
            int(pos[i]), fmt=fmt, block_size=block, softcap=c["softcap"]))
        np.testing.assert_allclose(oracle, jax_oracle, rtol=0, atol=OUT_TOL)
    if kind == "per_seq":  # the fully masked row: the mean of V over T
        vd = tk._dequant_rows(_t(ve, fmt), _t(vs), tk.F.get_format(fmt),
                              block)
        np.testing.assert_allclose(got[1], vd[1].mean(dim=1, keepdim=True)
                                   .expand(-1, shape[2], -1).numpy(),
                                   rtol=0, atol=OUT_TOL)


def test_decode_refuses_a_format_its_storage_contradicts(J):
    """fp8 storage named as fp4 raises, as the reference's check does."""
    c = decode_case("fp8_e4m3", 32, (1, 1, 1, 32, 32), "tail", "f32")
    (ke, ks), (ve, vs) = c["k"], c["v"]
    with pytest.raises(ValueError, match="does not match"):
        J.decode(J.jnp.asarray(c["q"]), J.j(ke, "fp8_e4m3"), J.j(ks),
                 J.j(ve, "fp8_e4m3"), J.j(vs), J.jnp.asarray(c["kpos"]),
                 int(c["pos"]), fmt_name="fp4_e2m1")
    with pytest.raises(ValueError, match="does not match"):
        tk.mx_attention_decode(
            torch.from_numpy(c["q"]), _t(ke, "fp8_e4m3"), _t(ks),
            _t(ve, "fp8_e4m3"), _t(vs), torch.from_numpy(c["kpos"]),
            int(c["pos"]), fmt_name="fp4_e2m1")


# ---------------------------------------------------------------------------
# the CUDA kernels against the plain versions (on the card only)
# ---------------------------------------------------------------------------

#: granite-8b's KVH 8, G 4 and head_dim 128 over 336 keys with q and K
#: scaled x5: logits reach +-100 (50 under the softcap), and the f32
#: rounding of their dot products moves each version's outputs by a few
#: 1e-6 from the exact result, in opposite directions at times, so the
#: kernel is held to the f64 decode, as is the plain version
HARD_CASES = [("fp8_e4m3", 32, (2, 8, 4, 128, 336), "softcap", "bf16", 5.0),
              ("fp8_e4m3", 32, (3, 8, 4, 128, 336), "per_seq", "bf16", 5.0),
              ("fp4_e2m1", 32, (3, 8, 4, 128, 336), "per_seq", "bf16", 5.0)]


@pytest.mark.parametrize("t", [336, 1024, 5, 64, 65, 17, 100000])
def test_decode_plan_splits_the_keys(t):
    """The CUDA decode's key split: splits of DECODE_CHUNK keys, every
    key in exactly one split (the last may be short)."""
    splits, chunk = tk.decode_plan(t)
    assert chunk == tk.DECODE_CHUNK == 64
    assert (splits - 1) * chunk < t <= splits * chunk


def test_decode_plan_at_granite_shapes():
    """21 pages: 6 splits of 64 keys (384 CTAs at B 8); 64 pages: 16."""
    assert tk.decode_plan(21 * 16) == (6, 64)
    assert tk.decode_plan(64 * 16) == (16, 64)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return "cuda"


@pytest.mark.cuda
def test_cuda_kernels_match_plain_versions(cuda_device):
    before = (tk.gather_kv_pages.launches, tk.mx_attention_decode.launches)
    for fmt, block in (("fp8_e4m3", 32), ("fp8_e5m2", 16), ("fp4_e2m1", 32),
                       ("fp6_e3m2", 32)):
        rng = np.random.default_rng(9)
        c = paged_case(fmt, block, 3, 2, 64, 64, 16, rng, g=4)
        table = c["table"].copy()
        table[2, 1:] = -1
        got = tk.gather_kv_pages(*(p.to(cuda_device) for p in _pool_args(
            c, _t)), torch.from_numpy(table).to(cuda_device))
        want = tk.gather_kv_pages(*_pool_args(c, _t), torch.from_numpy(table))
        for gt, wt in zip(got, want):
            np.testing.assert_array_equal(_u8(gt), _u8(wt))
        lens = torch.tensor([64, 17, 5], dtype=torch.int32)
        q = torch.from_numpy(c["q"]).bfloat16()
        paged = tk.mx_attention_decode_paged(
            q.to(cuda_device), *(p.to(cuda_device) for p in _pool_args(
                c, _t)), torch.from_numpy(table).to(cuda_device),
            lens.to(cuda_device), fmt_name=fmt, block_size=block)
        kpos = torch.arange(64, dtype=torch.int32)
        contiguous = tk.mx_attention_decode(
            q.to(cuda_device), *(x.to(cuda_device) for x in got), kpos.to(
                cuda_device), (lens - 1).to(cuda_device), fmt_name=fmt,
            block_size=block)
        plain = tk.mx_attention_decode(q, *want, kpos, lens - 1,
                                       fmt_name=fmt, block_size=block)
        torch.cuda.synchronize()
        # by bits: slot 2's -1 entries read page 0, here one of the spare
        # garbage pages, whose NaN values reach the masked keys' 0 * v
        assert torch.equal(paged.view(torch.int32),
                           contiguous.view(torch.int32))
        np.testing.assert_allclose(contiguous.cpu().numpy(), plain.numpy(),
                                   rtol=0, atol=OUT_TOL, err_msg=fmt)
    for case in DECODE_CASES:
        c = decode_case(*case)
        np.testing.assert_allclose(run_decode_port(c, cuda_device).cpu()
                                   .numpy(), run_decode_port(c).numpy(),
                                   rtol=0, atol=OUT_TOL, err_msg=str(case))
    for case in HARD_CASES:
        c = decode_case(*case)
        exact = decode_f64(c)
        kernel, plain = (float((run_decode_port(c, dev).cpu().double()
                                - exact).abs().max())
                         for dev in (cuda_device, "cpu"))
        # each within OUT_TOL of the exact result, and the kernel no
        # farther from it than twice the plain version
        assert max(kernel, plain) <= OUT_TOL, (case, kernel, plain)
        assert kernel <= 2 * plain, (case, kernel, plain)
    assert tk.gather_kv_pages.launches - before[0] == 8
    assert tk.mx_attention_decode.launches - before[1] == \
        8 + len(DECODE_CASES) + len(HARD_CASES)
