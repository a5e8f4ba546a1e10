"""The port's page repack against the reference's ``mx_repack_pages``.

``repro_torch.kernels.mx_repack_pages`` on CPU tensors runs its plain
PyTorch version; ``repro.kernels.mx_repack_pages`` runs the Pallas kernel
in interpret mode, as the reference's own tests do. Both get the same
numpy tiered pools: full-width uint8 rows whose pages hold fp8 e4m3, fp6
e3m2 or fp4 e2m1 codes in their prefix (random bytes in the dead tail),
and one page under fp6 e2m3, an id outside the candidate formats, which
decodes as the first of them. Blocks with an all-zero decode, with E8M0
byte 0 under nonzero codes, and with decoded values below the f32
normal range are written in. The page list carries padding (count <
length), and an id past the pool, which is clipped onto the last page.
Layer-stacked pools (L, NP, PS, KVH, D), as a uniform model's engine
hands them over in one call, must equal the reference applied layer by
layer.

Bar: every byte of every pool identical, repacked pages (prefix and
zeroed tail) and untouched pages alike. The CUDA kernel is held to the
plain version on the card by ``chip_smoke.py`` and by the ``cuda``-marked
test below.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import formats as F  # noqa: E402
from repro_torch.kernels import mx_repack as tr  # noqa: E402
from repro_torch.kernels.mx_quantize import quantize_rows  # noqa: E402

MIXED = ("fp8_e4m3", "fp6_e3m2", "fp4_e2m1")
NPAGES, PS, KVH, D = 7, 4, 2, 64
#: per-page source format ids (page 3: fp6 e2m3, outside MIXED)
SRC = [0, 2, 4, 3, 0, 4, 2]


def make_pools(block_size: int, seed: int = 0, corners: bool = True,
               d: int = D):
    """Numpy (ke, ks, ve, vs) tiered pools, page p in format SRC[p];
    ``corners`` writes in the zero, byte-0 and tiny-scale blocks."""
    rng = np.random.default_rng(seed)
    pools = []
    for _ in range(2):
        elems = rng.integers(0, 256, (NPAGES, PS, KVH, d), dtype=np.uint8)
        scales = np.zeros((NPAGES, PS, KVH, d // block_size), np.uint8)
        for p, fid in enumerate(SRC):
            fmt = F.get_format(F.FORMAT_BY_ID[fid])
            x = torch.from_numpy(
                rng.normal(size=(PS, KVH, d)).astype(np.float32) * 4.0)
            if corners:
                x[0, 0, :block_size] = 0.0  # an all-zero block
            codes, e = quantize_rows(x, fmt, block_size)
            w = fmt.storage_len(d)
            elems[p, ..., :w] = codes.numpy()
            scales[p] = e.numpy()
            if corners:
                # E8M0 byte 0 under nonzero codes (read as a zero scale),
                # and a scale so small that the decoded values sit at the
                # bottom of the f32 range (subnormal ones flush to zero)
                scales[p, 1, 0, 0] = 0
                scales[p, 2, 1, -1] = 3
        pools += [elems, scales]
    return pools


def make_stacked_pools(block_size: int, layers: int, seed: int = 0,
                       d: int = D):
    """(L, ...) pools: layer l holds ``make_pools`` of seed + l."""
    per_layer = [make_pools(block_size, seed + l, d=d) for l in range(layers)]
    return [np.stack(leaf) for leaf in zip(*per_layer)]


def run_reference(pools, ids, fmts, count, dst, block_size):
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import mx_repack_pages as jax_repack

    out = jax_repack(*(jnp.asarray(a) for a in pools),
                     jnp.asarray(ids, jnp.int32), jnp.asarray(fmts, jnp.int32),
                     jnp.asarray(count, jnp.int32), dst_fmt_name=dst,
                     mixed_fmts=MIXED, block_size=block_size)
    return [np.asarray(a) for a in out]


def run_port(pools, ids, fmts, count, dst, block_size, device="cpu"):
    t = [torch.from_numpy(np.array(a)).to(device) for a in pools]
    out = tr.mx_repack_pages(
        *t, torch.tensor(ids, dtype=torch.int32, device=device),
        torch.tensor(fmts, dtype=torch.int32, device=device), count,
        dst_fmt_name=dst, mixed_fmts=MIXED, block_size=block_size)
    assert all(o is p for o, p in zip(out, t))  # in place
    return [a.cpu().numpy() for a in out]


def page_list(dst):
    """(ids, src fmt ids, count): three live pages of mixed source formats
    (one of them named past the pool, so clipped onto the last page) and
    padding that repeats the last live entry, as the reference requires.
    The widening destination takes the narrow pages."""
    live = [1, 2, 5] if dst.startswith("fp8") else [0, 3, NPAGES + 4]
    ids = live + [live[-1]] * 2
    fmts = [SRC[min(p, NPAGES - 1)] for p in ids]
    return ids, fmts, len(live)


@pytest.mark.parametrize("dst,block_size", [
    ("fp6_e3m2", 16), ("fp6_e2m3", 16), ("fp4_e2m1", 16), ("fp4_e2m1", 32),
    ("fp8_e4m3", 16)])
def test_plain_repack_matches_reference_kernel(dst, block_size):
    pools = make_pools(block_size)
    ids, fmts, count = page_list(dst)
    want = run_reference(pools, ids, fmts, count, dst, block_size)
    got = run_port(pools, ids, fmts, count, dst, block_size)
    touched = {min(p, NPAGES - 1) for p in ids[:count]}
    w = F.get_format(dst).storage_len(D)
    for name, g, x, before in zip(("ke", "ks", "ve", "vs"), got, want,
                                  pools):
        np.testing.assert_array_equal(g, x, err_msg=name)
        for p in range(NPAGES):  # the check is not vacuous
            if p not in touched:
                np.testing.assert_array_equal(g[p], before[p])
    for p in touched:
        assert not got[0][p, ..., w:].any()  # dead tail zeroed


@pytest.mark.parametrize("dst,block_size", [
    ("fp6_e3m2", 16), ("fp6_e2m3", 32), ("fp4_e2m1", 16),
    ("fp8_e4m3", 16)])
def test_plain_stacked_repack_matches_reference_per_layer(dst, block_size):
    """One call on (3, NP, PS, KVH, D) pools: the reference kernel run on
    each layer's pools in turn, byte for byte, every layer changed."""
    layers = 3
    pools = make_stacked_pools(block_size, layers)
    ids, fmts, count = page_list(dst)
    got = run_port(pools, ids, fmts, count, dst, block_size)
    for layer in range(layers):
        want = run_reference([a[layer] for a in pools], ids, fmts, count,
                             dst, block_size)
        for name, g, x, before in zip(("ke", "ks", "ve", "vs"), got, want,
                                      pools):
            np.testing.assert_array_equal(g[layer], x,
                                          err_msg=f"{name}, layer {layer}")
        assert not np.array_equal(got[0][layer], pools[0][layer])


def test_widening_repack_is_lossless():
    """The copy-on-write promotion: fp4 and fp6 pages re-encoded to fp8
    decode to exactly their old values (away from the bottom of the
    exponent range, where the fp8 scale would clip at E8M0 byte 0)."""
    from repro_torch.kernels.mx_attention import _dequant_rows_mixed

    pools = make_pools(16, seed=3, corners=False)
    ids, fmts, count = [2, 1], [4, 2], 2
    got = run_port(pools, ids, fmts, count, "fp8_e4m3", 16)
    for p, fid in zip(ids, fmts):
        for e_i, s_i in ((0, 1), (2, 3)):
            old = _dequant_rows_mixed(torch.from_numpy(pools[e_i][p]),
                                      torch.from_numpy(pools[s_i][p]), fid,
                                      MIXED, 16)
            new = _dequant_rows_mixed(torch.from_numpy(got[e_i][p]),
                                      torch.from_numpy(got[s_i][p]), 0,
                                      MIXED, 16)
            assert torch.equal(old, new)


@pytest.mark.parametrize("bad,match", [
    (dict(dtype=torch.float8_e4m3fn), "raw uint8"),
    (dict(dst="fp3"), "unknown target format"),
    (dict(count=0), "count"),
    (dict(layers=(3, 3, 2, 3)), "share their leading L"),
    (dict(layers=(3, 3, 3, None)), "share their leading L")])
def test_wrapper_rejects_what_the_reference_rejects(bad, match):
    pools = [torch.from_numpy(a) for a in make_pools(16)]
    if "dtype" in bad:
        pools[0] = pools[0].view(bad["dtype"])
    if "layers" in bad:  # stacked pools whose L differ (None: unstacked)
        pools = [p if n is None else p.expand(n, *p.shape).contiguous()
                 for p, n in zip(pools, bad["layers"])]
    with pytest.raises(ValueError, match=match):
        tr.mx_repack_pages(*pools, torch.zeros(2, dtype=torch.int32),
                           torch.zeros(2, dtype=torch.int32),
                           bad.get("count", 1),
                           dst_fmt_name=bad.get("dst", "fp4_e2m1"),
                           block_size=16)


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version():
    """Per-layer and layer-stacked (L 3) pools, one launch a call; blocks
    of 16 and 32 (shuffle-reduced) and of 12 at D 48 (the kernel's
    shared-memory amax pass), every destination format."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    for dst, block_size, d in (("fp6_e3m2", 16, D), ("fp6_e2m3", 32, D),
                               ("fp4_e2m1", 16, D), ("fp8_e4m3", 32, D),
                               ("fp6_e3m2", 12, 48), ("fp4_e2m1", 12, 48)):
        for layers in (None, 3):
            pools = make_pools(block_size, seed=7, d=d) if layers is None \
                else make_stacked_pools(block_size, layers, seed=7, d=d)
            ids, fmts, count = page_list(dst)
            want = run_port(pools, ids, fmts, count, dst, block_size)
            launches = tr.mx_repack_pages.launches
            got = run_port(pools, ids, fmts, count, dst, block_size, "cuda")
            assert tr.mx_repack_pages.launches == launches + 1
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)
