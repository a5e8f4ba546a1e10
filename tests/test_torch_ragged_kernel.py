"""The port's ragged MX page-walk kernel against the reference kernel.

``repro_torch.kernels.mx_attention_ragged_fused`` on CPU tensors runs its
plain PyTorch version; ``repro.kernels.mx_attention_ragged_fused`` runs
the Pallas kernel in interpret mode, as the reference's own tests do.
Both get the same numpy inputs: a batch mixing a decode row with a
mid-page start, a 3-token window across a page boundary, a fresh prefill
chunk, a continuation chunk with an unaligned start, and an inactive row
whose table is all -1 (the trash page). The pools are uniform fp8, packed
fp4, or mixed-format uint8 rows whose resident pages carry fp8, fp6 and
fp4 codes (and garbage in their dead tail bytes) under per-page format
ids. Written pool bytes and visit counts must be identical; ``out`` must
agree within 1e-5 (the two sum f32 products in different orders).

The pools are encoded by the port's ``quantize`` (bit-exact with the
reference's, ``tests/test_torch_formats.py``), so the CUDA kernel can be
held to the plain version on the card without JAX: by ``chip_smoke.py``
and by the ``cuda``-marked test below. The reference is imported by the
tests that call it.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import formats as F  # noqa: E402
from repro_torch.core import quantize as tquantize  # noqa: E402
from repro_torch.kernels import mx_attention as tk  # noqa: E402

OUT_TOL = 1e-5
MIXED = ("fp8_e4m3", "fp6_e3m2", "fp4_e2m1")
FP8_VIEWS = {"fp8_e4m3": torch.float8_e4m3fn, "fp8_e5m2": torch.float8_e5m2}


def _reference():
    """(jax.numpy, the reference's ragged kernel), or skip."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import mx_attention_ragged_fused
    return jnp, mx_attention_ragged_fused


def _encode(x, fmt, block_size):
    """(codes as uint8 bytes, E8M0 scales) of f32 rows, as numpy."""
    qx = tquantize(torch.from_numpy(x), fmt, block_size)
    return (qx.elements.view(torch.uint8).numpy(), qx.scales.numpy())


def _mixed_pool(rng, page_ids, npages, ps, kvh, d, block_size):
    """uint8 rows: page p holds codes of format page_ids[p] in its row
    prefix and random bytes in the dead tail."""
    elems = rng.integers(0, 256, (npages, ps, kvh, d), dtype=np.uint8)
    scales = np.zeros((npages, ps, kvh, d // block_size), np.uint8)
    for p, fid in enumerate(page_ids):
        codes, e = _encode(rng.normal(size=(ps * kvh, d)).astype(
            np.float32), F.FORMAT_BY_ID[int(fid)], block_size)
        codes = codes.reshape(ps, kvh, -1)
        elems[p, :, :, :codes.shape[-1]] = codes
        scales[p] = e.reshape(ps, kvh, -1)
    return elems, scales


def make_case(fmt, block_size, *, d=64, g=2, kvh=2, ps=8, w=8, seed=101,
              window=None, softcap=None, mixed=False):
    """Numpy inputs for one ragged step (bf16-representable q/k/v). With
    ``mixed``, the pools are mixed-format uint8 rows: write-window pages
    hold fp8 (the engine's hot-write invariant), the other pages cycle
    through fp8 e4m3, fp6 e3m2, fp4 e2m1 and fp6 e2m3 (an id outside
    ``MIXED``, which decodes as its first format)."""
    rng = np.random.default_rng(seed)
    starts = [13, 9, 0, 12, 0]
    n_news = [1, 3, w, w, 1]
    r = len(starts)
    totals = [s + n for s, n in zip(starts, n_news)]
    pages_per = [-(-t // ps) for t in totals[:-1]]
    npages = sum(pages_per) + 3  # spare pages + the trash page (last)
    pmax = max(pages_per) + 1
    perm = rng.permutation(npages - 1)  # never hand out the trash page
    table = np.full((r, pmax), -1, np.int32)  # last row: inactive
    off = 0
    for i, npg in enumerate(pages_per):
        table[i, :npg] = perm[off:off + npg]
        off += npg

    def pool(x):
        codes, e = _encode(x, fmt, block_size)
        return (codes.reshape(npages, ps, kvh, -1).copy(),
                e.reshape(npages, ps, kvh, -1).copy())

    page_fmts = None
    if mixed:
        cycle = [F.FORMAT_IDS[f] for f in MIXED + ("fp6_e2m3",)]
        page_fmts = np.asarray([cycle[p % 4] for p in range(npages)],
                               np.int32)
        for i, (st, tot) in enumerate(zip(starts, totals)):
            for p in range(st // ps, -(-tot // ps)):
                if table[i, p] >= 0:
                    page_fmts[table[i, p]] = F.FORMAT_IDS[fmt]
        ke, ks = _mixed_pool(rng, page_fmts, npages, ps, kvh, d, block_size)
        ve, vs = _mixed_pool(rng, page_fmts, npages, ps, kvh, d, block_size)
    else:
        # decoy codes everywhere: rows outside each window must keep them
        ke, ks = pool(rng.normal(size=(npages * ps * kvh, d)).astype(
            np.float32))
        ve, vs = pool(rng.normal(size=(npages * ps * kvh, d)).astype(
            np.float32))

    def bf16(shape, scale=1.0):
        x = (rng.normal(size=shape) * scale).astype(np.float32)
        return np.asarray(torch.from_numpy(x).bfloat16().float())

    q = bf16((r, kvh, w, g, d))
    k_new = bf16((r, w, kvh, d))
    v_new = bf16((r, w, kvh, d))
    # corner values of the write path: signed zeros, a tiny block (E8M0
    # byte 0) and an outlier that shrinks the rest of its block
    k_new[0, 0, 0, :4] = -0.0
    k_new[1, 1, 1, :block_size] = 2.0 ** -120
    k_new[2, 3, 0, 5] = 3.0e4
    return dict(q=q, k_new=k_new, v_new=v_new, ke=ke, ks=ks, ve=ve, vs=vs,
                table=table, starts=np.asarray(starts, np.int32),
                lens=np.asarray(totals, np.int32), fmt=fmt,
                block_size=block_size, window=window, softcap=softcap,
                page_fmts=page_fmts)


def _mixed_kw(c, page_fmts):
    if c["page_fmts"] is None:
        return {}
    return dict(page_fmts=page_fmts, mixed_fmts=MIXED)


def run_reference(c):
    jnp, jax_ragged = _reference()
    fmt = c["fmt"]
    ke, ve = jnp.asarray(c["ke"]), jnp.asarray(c["ve"])
    if c["page_fmts"] is None and fmt in FP8_VIEWS:
        view = {"fp8_e4m3": jnp.float8_e4m3fn,
                "fp8_e5m2": jnp.float8_e5m2}[fmt]
        ke, ve = (a.view(view) for a in (ke, ve))
    out, pools, visits = jax_ragged(
        jnp.asarray(c["q"]), jnp.asarray(c["k_new"]), jnp.asarray(c["v_new"]),
        ke, jnp.asarray(c["ks"]), ve, jnp.asarray(c["vs"]),
        jnp.asarray(c["table"]), jnp.asarray(c["starts"]),
        jnp.asarray(c["lens"]), fmt_name=fmt, block_size=c["block_size"],
        window=c["window"], softcap=c["softcap"], debug_visits=True,
        **_mixed_kw(c, None if c["page_fmts"] is None
                    else jnp.asarray(c["page_fmts"])))
    pools = [np.asarray(p).view(np.uint8) for p in pools]
    return np.asarray(out), pools, np.asarray(visits)


def run_port(c, device="cpu", **kw):
    fmt = c["fmt"]

    def t(x, dtype=None):
        x = torch.from_numpy(np.array(x)).to(device)  # own copy: pools
        # are updated in place
        return x if dtype is None else x.to(dtype)

    pools = [t(c["ke"]), t(c["ks"]), t(c["ve"]), t(c["vs"])]
    if c["page_fmts"] is None and fmt in FP8_VIEWS:
        pools[0], pools[2] = (p.view(FP8_VIEWS[fmt])
                              for p in (pools[0], pools[2]))
    out, pools, visits = tk.mx_attention_ragged_fused(
        t(c["q"], torch.bfloat16), t(c["k_new"], torch.bfloat16),
        t(c["v_new"], torch.bfloat16), *pools, t(c["table"]),
        t(c["starts"]), t(c["lens"]), fmt_name=fmt,
        block_size=c["block_size"], window=c["window"], softcap=c["softcap"],
        debug_visits=True, **kw, **_mixed_kw(
            c, None if c["page_fmts"] is None else t(c["page_fmts"])))
    pools = [p.view(torch.uint8).cpu().numpy() for p in pools]
    return out.cpu().numpy(), pools, visits.cpu().numpy()


def _check_against_reference(case):
    want_out, want_pools, want_visits = run_reference(case)
    out, pools, visits = run_port(case)
    for name, got, want in zip(("ke", "ks", "ve", "vs"), pools, want_pools):
        np.testing.assert_array_equal(got, want, err_msg=name)
    np.testing.assert_array_equal(visits, want_visits)
    # the write window really was written (the check is not vacuous)
    assert not np.array_equal(pools[0], case["ke"])
    np.testing.assert_allclose(out, want_out, rtol=0, atol=OUT_TOL)


@pytest.mark.parametrize("fmt,block_size,window,softcap", [
    ("fp8_e4m3", 16, None, None), ("fp8_e4m3", 32, 6, None),
    ("fp8_e5m2", 16, 6, 5.0), ("fp8_e5m2", 32, None, None)])
def test_plain_ragged_matches_reference_kernel(fmt, block_size, window,
                                               softcap):
    _check_against_reference(make_case(fmt, block_size, window=window,
                                       softcap=softcap))


@pytest.mark.parametrize("fmt,block_size,window,softcap,mixed", [
    ("fp4_e2m1", 16, None, None, False), ("fp4_e2m1", 32, 6, 5.0, False),
    ("fp8_e4m3", 16, 6, None, True), ("fp8_e4m3", 32, None, 5.0, True),
    ("fp8_e5m2", 16, None, None, True)])
def test_plain_ragged_fp4_and_mixed_pools_match_reference_kernel(
        fmt, block_size, window, softcap, mixed):
    _check_against_reference(make_case(fmt, block_size, window=window,
                                       softcap=softcap, mixed=mixed))


def test_uniform_fp6_pools_raise_value_error():
    """The reference has no uniform fp6 pool layout (see the wrapper's
    docstring); the port refuses one instead of inventing a layout."""
    case = make_case("fp8_e4m3", 16)
    t = {k: torch.from_numpy(np.ascontiguousarray(v))
         for k, v in case.items() if isinstance(v, np.ndarray)}
    for fmt in ("fp6_e3m2", "fp6_e2m3"):
        with pytest.raises(ValueError, match="uniform fp6"):
            tk.mx_attention_ragged_fused(
                t["q"], t["k_new"], t["v_new"], t["ke"], t["ks"], t["ve"],
                t["vs"], t["table"], t["starts"], t["lens"], block_size=16,
                fmt_name=fmt)


def test_reference_uniform_fp6_pool_fails_on_its_own_layout():
    """What the reference does with a uniform fp6 pool laid out as its
    ``_cache_arrays`` allocates it (D-byte uint8 rows): tracing the kernel
    unpacks the D-byte rows as fp6 byte triples, and D = 64 bytes do not
    reshape into triples (TypeError); the write would merge 3D/4 packed
    bytes into them besides."""
    jnp, jax_ragged = _reference()
    case = make_case("fp8_e4m3", 16)
    with pytest.raises(TypeError, match="reshape"):
        jax_ragged(
            *(jnp.asarray(case[k]) for k in ("q", "k_new", "v_new", "ke",
                                             "ks", "ve", "vs", "table",
                                             "starts", "lens")),
            fmt_name="fp6_e3m2", block_size=16)


def test_mixed_pool_write_format_must_be_fp8():
    case = make_case("fp8_e4m3", 16, mixed=True)
    t = {k: torch.from_numpy(np.ascontiguousarray(v))
         for k, v in case.items() if isinstance(v, np.ndarray)}
    with pytest.raises(ValueError, match="must be an fp8"):
        tk.mx_attention_ragged_fused(
            t["q"], t["k_new"], t["v_new"], t["ke"], t["ks"], t["ve"],
            t["vs"], t["table"], t["starts"], t["lens"], block_size=16,
            fmt_name="fp4_e2m1", page_fmts=t["page_fmts"])


@pytest.mark.parametrize("ps,d,block", [(33, 64, 16), (8, 24, 8),
                                         (8, 272, 16), (8, 64, 2),
                                         (8, 128, 64)])
def test_cuda_launch_checks_raise_value_error(ps, d, block):
    """What the walk's tile cannot take raises before any launch: pages
    over 32 rows, head_dim not a multiple of 16 or over 256, blocks not a
    multiple of 4 or over 32."""
    with pytest.raises(ValueError):
        tk._launch_common([], [], ps, d, block, 0, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("d,ps,w,g", [(64, 8, 8, 2), (16, 16, 8, 2),
                                      (32, 32, 5, 3), (128, 16, 8, 3),
                                      (256, 8, 4, 3), (256, 16, 64, 2),
                                      (128, 16, 64, 3)])
def test_cuda_kernel_matches_plain_version(d, ps, w, g):
    """The walk's tile at head_dim 16-256 and pages of 8-32 rows,
    W * G a multiple of 16 or not, up to gemma2's 128 query rows of 256
    and phi4-mini's 192 of 128 a cell."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    for fmt, block_size, softcap, mixed in (
            ("fp8_e4m3", 16, None, False), ("fp8_e5m2", 16, 5.0, False),
            ("fp4_e2m1", 16, None, False), ("fp4_e2m1", 32, 5.0, False),
            ("fp8_e4m3", 16, None, True), ("fp8_e5m2", 32, 5.0, True)):
        case = make_case(fmt, min(block_size, d), d=d, g=g, ps=ps, w=w,
                         window=6, softcap=softcap, mixed=mixed)
        want_out, want_pools, want_visits = run_port(case, "cpu")
        out, pools, visits = run_port(case, "cuda")
        trash = case["ke"].shape[0] - 1  # scratch page: racy by contract
        for got, want in zip(pools, want_pools):
            np.testing.assert_array_equal(got[:trash], want[:trash])
        np.testing.assert_array_equal(visits, want_visits)
        live = slice(0, len(case["starts"]) - 1)
        np.testing.assert_allclose(out[live], want_out[live], rtol=0,
                                   atol=OUT_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("d,g,tile", [(128, 4, 64), (256, 2, 64),
                                      (128, 3, 80)],
                         ids=["granite", "gemma2_9b", "phi4_mini"])
def test_cuda_kernel_walks_four_chunks_in_tiles(d, g, tile):
    """W 256 (four 64-token chunks a row): granite-8b's 1,024 query rows
    a cell, gemma2-9b's 512 of head_dim 256 (window, softcap) and
    phi4-mini's 768 (tiles of 80, 80, 80 and 16 tokens) do not fit one
    block's shared memory, so the cell walks them in query tiles; held to
    the plain version as above."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    lib = tk._library("mx_attention_ragged")
    assert tk.query_tile(256, g, d, 16,
                         lib.mx_attention_ragged_smem_bytes) == tile
    window, softcap = (48, 50.0) if d == 256 else (None, None)
    for fmt, mixed in (("fp8_e4m3", False), ("fp8_e4m3", True)):
        case = make_case(fmt, 32, d=d, g=g, ps=16, w=256, window=window,
                         softcap=softcap, mixed=mixed)
        want_out, want_pools, want_visits = run_port(case, "cpu")
        out, pools, visits = run_port(case, "cuda")
        trash = case["ke"].shape[0] - 1
        for got, want in zip(pools, want_pools):
            np.testing.assert_array_equal(got[:trash], want[:trash])
        np.testing.assert_array_equal(visits, want_visits)
        live = slice(0, len(case["starts"]) - 1)
        np.testing.assert_allclose(out[live], want_out[live], rtol=0,
                                   atol=OUT_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("fmt,mixed", [("fp8_e4m3", False),
                                       ("fp4_e2m1", False),
                                       ("fp8_e4m3", True)])
def test_cuda_forced_small_tiles_equal_one_tile_bit_for_bit(fmt, mixed):
    """At W 64, G 4, head_dim 128 one tile holds the cell; forced tiles of
    16 (and of 48: an uneven last tile) give its outputs, pool bytes and
    visits bit for bit: a query row's sums do not depend on the rows
    walked beside it, nor on how the head dim is sliced over warps."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    case = make_case(fmt, 32, d=128, g=4, ps=16, w=64, softcap=5.0,
                     mixed=mixed)
    out, pools, visits = run_port(case, "cuda")
    trash = case["ke"].shape[0] - 1
    for tile in (16, 48):
        got = run_port(case, "cuda", tile_tokens=tile)
        np.testing.assert_array_equal(got[0], out)
        for a, b in zip(got[1], pools):
            np.testing.assert_array_equal(a[:trash], b[:trash])
        np.testing.assert_array_equal(got[2], visits)
