"""The port's split-step page-walk kernels against the reference kernels.

``repro_torch.kernels.mx_attention_verify_fused`` (decode / verify) and
``mx_attention_prefill_fused`` (chunked prefill) on CPU tensors run their
plain PyTorch versions; the reference's run their Pallas kernels in
interpret mode, as the reference's own tests do. Both get the same numpy
inputs on uniform fp8 e4m3/e5m2 pools, packed fp4 pools (blocks 16 and
32) and mixed-format uint8 pools whose pages carry fp8, fp6 and fp4
codes (and garbage dead tails) under per-page format ids, one an id
outside the candidate formats.

  * verify: Tq 1 and 3, rows at page boundaries, a row whose queries
    start at position 0, an inactive slot (table all -1, length 0: the
    reference clips it onto page 0), -1 table tails, a sliding window
    and a softcap;
  * prefill: B = 2 rows, one a fresh chunk at position 0, the other a
    padded final chunk over resident pages, with -0.0, a negative
    subnormal, a tiny block (E8M0 byte 0) and an outlier in the chunk's
    K/V; on a mixed pool a chunk page whose stale format id is fp4.

Every pool byte (written and untouched) and the visit counts must be
identical, and ``out`` within 1e-5 (the two sum f32 products in other
orders). The ``cuda``-marked tests hold the CUDA kernels to the plain
versions on the card, and the ragged kernel's decode rows bit-equal to
the verify kernel's over the host-written pool.
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
POOLS = ("ke", "ks", "ve", "vs")
D, G, KVH, PS = 32, 2, 2, 4


def _encode(x, fmt, block_size):
    qx = tquantize(torch.from_numpy(x), fmt, block_size)
    return qx.elements.view(torch.uint8).numpy(), qx.scales.numpy()


def _pools(rng, npages, fmt, block_size, page_fmts):
    """Random codes on every page: uniform ``fmt`` storage, or (with
    ``page_fmts``) full-width uint8 rows with random dead tail bytes,
    page p holding codes of the format its id decodes as (an id outside
    the candidates decodes as the first of them, as in the reference)."""
    out = {}
    for name in ("k", "v"):
        if page_fmts is None:
            codes, e = _encode(rng.normal(size=(npages * PS * KVH, D))
                               .astype(np.float32), fmt, block_size)
            out[f"{name}e"] = codes.reshape(npages, PS, KVH, -1).copy()
            out[f"{name}s"] = e.reshape(npages, PS, KVH, -1).copy()
            continue
        elems = rng.integers(0, 256, (npages, PS, KVH, D), dtype=np.uint8)
        scales = np.zeros((npages, PS, KVH, D // block_size), np.uint8)
        for p, fid in enumerate(page_fmts):
            codes, e = _encode(rng.normal(size=(PS * KVH, D)).astype(
                np.float32), tk._mixed_fmt_name(int(fid), MIXED), block_size)
            codes = codes.reshape(PS, KVH, -1)
            elems[p, :, :, :codes.shape[-1]] = codes
            scales[p] = e.reshape(PS, KVH, -1)
        out[f"{name}e"], out[f"{name}s"] = elems, scales
    return out


def _bf16(rng, shape):
    x = rng.normal(size=shape).astype(np.float32)
    return np.asarray(torch.from_numpy(x).bfloat16().float())


def _cycle_fmts(npages):
    cycle = [F.FORMAT_IDS[f] for f in MIXED + ("fp6_e2m3",)]
    return np.asarray([cycle[p % 4] for p in range(npages)], np.int32)


def verify_case(fmt, block_size, tq, *, mixed=False, window=None,
                softcap=None, seed=7):
    """Four slots: lengths 9 and 14 (page-boundary starts for Tq 3), a
    slot whose first query sits at 0, and an inactive slot."""
    rng = np.random.default_rng(seed)
    lens = [9, 14, tq, 0]
    npages, pmax = 12, 5
    perm = rng.permutation(npages)
    table = np.full((4, pmax), -1, np.int32)
    off = 0
    for i, n in enumerate(lens[:3]):
        pages = -(-n // PS)
        table[i, :pages] = perm[off:off + pages]
        off += pages
    page_fmts = _cycle_fmts(npages) if mixed else None
    return dict(q=_bf16(rng, (4, KVH, tq, G, D)),
                **_pools(rng, npages, fmt, block_size, page_fmts),
                table=table, lens=np.asarray(lens, np.int32), fmt=fmt,
                block_size=block_size, window=window, softcap=softcap,
                page_fmts=page_fmts)


def prefill_case(fmt, block_size, *, mixed=False, window=None,
                 softcap=None, seed=11):
    """Two rows of one C = max(8, PS) chunk: row 0 fresh at position 0 (C
    real tokens), row 1 a padded final chunk at C (5 real tokens) over
    the resident pages below it; -1 table tails."""
    rng = np.random.default_rng(seed)
    c = max(8, PS)
    npages, pmax = 10, 5
    table = np.full((2, pmax), -1, np.int32)
    table[0, :2] = [6, 2]
    table[1, :4] = [4, 0, 8, 3]
    page_fmts = None
    if mixed:
        page_fmts = _cycle_fmts(npages)
        page_fmts[[6, 2, 8]] = F.FORMAT_IDS[fmt]
        page_fmts[3] = F.FORMAT_IDS["fp4_e2m1"]  # stale id of a chunk page
    k_chunk = _bf16(rng, (2, c, KVH, D))
    k_chunk[0, 0, 0, :4] = -0.0  # signed zeros keep their sign here
    k_chunk[0, 2, 1, 3] = -1e-40  # a negative subnormal: flushed to -0.0
    k_chunk[1, 1, 1, :block_size] = 2.0 ** -120  # E8M0 byte 0
    k_chunk[1, 6, 0, 5] = 3.0e4  # padding row: written all the same
    return dict(q=_bf16(rng, (2, KVH, c, G, D)), k_chunk=k_chunk,
                v_chunk=_bf16(rng, (2, c, KVH, D)),
                **_pools(rng, npages, fmt, block_size, page_fmts),
                table=table, starts=np.asarray([0, c], np.int32),
                lens=np.asarray([c, c + 5], np.int32), fmt=fmt,
                block_size=block_size, window=window, softcap=softcap,
                page_fmts=page_fmts)


def wide_prefill_case(fmt, block_size, *, mixed=False, c=64, resident=10,
                      window=None, softcap=None, seed=13):
    """Two rows of one C-token chunk at the module's geometry: row 0 fresh
    at position 0, row 1 a padded final chunk (C - 5 real tokens) over
    ``resident`` resident pages; -1 table tails."""
    rng = np.random.default_rng(seed)
    own = c // PS
    npages = 2 * own + resident
    perm = rng.permutation(npages)
    table = np.full((2, resident + own + 1), -1, np.int32)
    table[0, :own] = perm[:own]
    table[1, :resident + own] = perm[own:]
    page_fmts = None
    if mixed:
        page_fmts = _cycle_fmts(npages)
        page_fmts[np.concatenate([perm[:own], perm[own + resident:]])] = \
            F.FORMAT_IDS[fmt]
    start = resident * PS
    return dict(q=_bf16(rng, (2, KVH, c, G, D)),
                k_chunk=_bf16(rng, (2, c, KVH, D)),
                v_chunk=_bf16(rng, (2, c, KVH, D)),
                **_pools(rng, npages, fmt, block_size, page_fmts),
                table=table, starts=np.asarray([0, start], np.int32),
                lens=np.asarray([c, start + c - 5], np.int32), fmt=fmt,
                block_size=block_size, window=window, softcap=softcap,
                page_fmts=page_fmts)


# ---------------------------------------------------------------------------
# running both packages
# ---------------------------------------------------------------------------


def _kw(c, page_fmts):
    kw = dict(fmt_name=c["fmt"], block_size=c["block_size"],
              window=c["window"], softcap=c["softcap"], debug_visits=True)
    if c["page_fmts"] is not None:
        kw.update(page_fmts=page_fmts, mixed_fmts=MIXED)
    return kw


def _jax_pools(jnp, c):
    pools = [jnp.asarray(c[k]) for k in POOLS]
    if c["page_fmts"] is None and c["fmt"] in FP8_VIEWS:
        view = {"fp8_e4m3": jnp.float8_e4m3fn,
                "fp8_e5m2": jnp.float8_e5m2}[c["fmt"]]
        pools[0], pools[2] = (p.view(view) for p in (pools[0], pools[2]))
    return pools


def _torch_pools(c, device):
    pools = [torch.from_numpy(np.array(c[k])).to(device) for k in POOLS]
    if c["page_fmts"] is None and c["fmt"] in FP8_VIEWS:
        pools[0], pools[2] = (p.view(FP8_VIEWS[c["fmt"]])
                              for p in (pools[0], pools[2]))
    return pools


def _t(x, device, dtype=None):
    x = torch.from_numpy(np.array(x)).to(device)
    return x if dtype is None else x.to(dtype)


def _bytes(pools):
    return [np.asarray(p.view(torch.uint8).cpu()) if isinstance(
        p, torch.Tensor) else np.asarray(p).view(np.uint8) for p in pools]


def run_verify_reference(c):
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import mx_attention_verify_fused
    out, visits = mx_attention_verify_fused(
        jnp.asarray(c["q"]), *_jax_pools(jnp, c), jnp.asarray(c["table"]),
        jnp.asarray(c["lens"]), **_kw(c, None if c["page_fmts"] is None
                                      else jnp.asarray(c["page_fmts"])))
    return np.asarray(out), np.asarray(visits)


def run_verify_port(c, device="cpu"):
    pools = _torch_pools(c, device)
    out, visits = tk.mx_attention_verify_fused(
        _t(c["q"], device, torch.bfloat16), *pools, _t(c["table"], device),
        _t(c["lens"], device), **_kw(c, None if c["page_fmts"] is None
                                     else _t(c["page_fmts"], device)))
    return out.cpu().numpy(), visits.cpu().numpy(), _bytes(pools)


def run_prefill_reference(c):
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import mx_attention_prefill_fused
    out, pools, visits = mx_attention_prefill_fused(
        jnp.asarray(c["q"]), jnp.asarray(c["k_chunk"]),
        jnp.asarray(c["v_chunk"]), *_jax_pools(jnp, c),
        jnp.asarray(c["table"]), jnp.asarray(c["starts"]),
        jnp.asarray(c["lens"]), **_kw(c, None if c["page_fmts"] is None
                                      else jnp.asarray(c["page_fmts"])))
    return np.asarray(out), np.asarray(visits), _bytes(pools)


def run_prefill_port(c, device="cpu", **kw):
    pools = _torch_pools(c, device)
    out, pools, visits = tk.mx_attention_prefill_fused(
        _t(c["q"], device, torch.bfloat16),
        _t(c["k_chunk"], device, torch.bfloat16),
        _t(c["v_chunk"], device, torch.bfloat16), *pools,
        _t(c["table"], device), _t(c["starts"], device),
        _t(c["lens"], device), **_kw(c, None if c["page_fmts"] is None
                                     else _t(c["page_fmts"], device)),
        **kw)
    return out.cpu().numpy(), visits.cpu().numpy(), _bytes(pools)


# ---------------------------------------------------------------------------
# plain versions against the reference (CPU)
# ---------------------------------------------------------------------------

POOL_KINDS = [("fp8_e4m3", 16, False), ("fp8_e5m2", 32, False),
              ("fp4_e2m1", 16, False), ("fp4_e2m1", 32, False),
              ("fp8_e4m3", 16, True)]


@pytest.mark.parametrize("tq", [1, 3])
@pytest.mark.parametrize("fmt,block_size,mixed", POOL_KINDS)
def test_plain_verify_matches_reference_kernel(fmt, block_size, mixed, tq):
    window, softcap = ((5, 5.0) if tq == 3 else (None, None))
    c = verify_case(fmt, block_size, tq, mixed=mixed, window=window,
                    softcap=softcap)
    want_out, want_visits = run_verify_reference(c)
    out, visits, pools = run_verify_port(c)
    np.testing.assert_array_equal(visits, want_visits)
    for got, name in zip(pools, POOLS):  # read-only
        np.testing.assert_array_equal(got, c[name].view(np.uint8))
    np.testing.assert_allclose(out, want_out, rtol=0, atol=OUT_TOL)


@pytest.mark.parametrize("window,softcap", [(None, None), (6, 5.0)])
@pytest.mark.parametrize("fmt,block_size,mixed", POOL_KINDS)
def test_plain_prefill_matches_reference_kernel(fmt, block_size, mixed,
                                                window, softcap):
    c = prefill_case(fmt, block_size, mixed=mixed, window=window,
                     softcap=softcap)
    want_out, want_visits, want_pools = run_prefill_reference(c)
    out, visits, pools = run_prefill_port(c)
    for name, got, want in zip(POOLS, pools, want_pools):
        np.testing.assert_array_equal(got, want, err_msg=name)
    np.testing.assert_array_equal(visits, want_visits)
    # the chunk pages were written, the others not touched
    written = [6, 2, 8, 3]
    assert not np.array_equal(pools[0][written], c["ke"][written])
    rest = np.setdiff1d(np.arange(c["ke"].shape[0]), written)
    np.testing.assert_array_equal(pools[0][rest], c["ke"].view(
        np.uint8)[rest])
    np.testing.assert_allclose(out, want_out, rtol=0, atol=OUT_TOL)


def test_prefill_keeps_the_sign_of_zero():
    """Unlike the ragged write (its one-hot gather turns -0.0 into +0.0),
    the chunked prefill quantizes its rows directly: -0.0 and a flushed
    negative subnormal store the fp8 code of -0.0 (0x80)."""
    c = prefill_case("fp8_e4m3", 16)
    _, _, pools = run_prefill_port(c)
    row0 = pools[0][6, 0, 0]  # page 6 row 0 = chunk row 0 of row 0
    assert (row0[:4] == 0x80).all()
    assert pools[0][6, 2, 1, 3] == 0x80


@pytest.mark.parametrize("fmt", ["fp6_e3m2", "fp6_e2m3"])
def test_uniform_fp6_pools_raise_value_error(fmt):
    v = {k: torch.from_numpy(np.ascontiguousarray(x))
         for k, x in verify_case("fp8_e4m3", 16, 1).items()
         if isinstance(x, np.ndarray)}
    p = {k: torch.from_numpy(np.ascontiguousarray(x))
         for k, x in prefill_case("fp8_e4m3", 16).items()
         if isinstance(x, np.ndarray)}
    with pytest.raises(ValueError, match="uniform fp6"):
        tk.mx_attention_verify_fused(
            v["q"], *(v[k] for k in POOLS), v["table"], v["lens"],
            fmt_name=fmt, block_size=16)
    with pytest.raises(ValueError, match="uniform fp6"):
        tk.mx_attention_prefill_fused(
            p["q"], p["k_chunk"], p["v_chunk"], *(p[k] for k in POOLS),
            p["table"], p["starts"], p["lens"], fmt_name=fmt, block_size=16)


def test_decode_wrapper_is_the_tq1_verify():
    c = verify_case("fp8_e4m3", 16, 1)
    pools = _torch_pools(c, "cpu")
    q = _t(c["q"], "cpu", torch.bfloat16)
    out, visits = tk.mx_attention_decode_fused(
        q[:, :, 0], *pools, _t(c["table"], "cpu"), _t(c["lens"], "cpu"),
        block_size=16, debug_visits=True)
    want, want_visits, _ = run_verify_port(c)
    assert torch.equal(out, torch.from_numpy(want[:, :, 0]))
    np.testing.assert_array_equal(visits.numpy(), want_visits)


# ---------------------------------------------------------------------------
# the CUDA kernels against the plain versions (card only)
# ---------------------------------------------------------------------------


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")


#: the cuda-marked tests' geometries (the module's D, G and PS): the
#: module's own, then the walk's tile at head_dim 16, 128 and 256
#: with pages of 8-32 rows and Tq * G, C * G not multiples of 16
GEOMETRIES = [dict(D=32, G=2, PS=4), dict(D=16, G=3, PS=8),
              dict(D=128, G=3, PS=16), dict(D=256, G=2, PS=32)]


@pytest.fixture(params=GEOMETRIES,
                ids=lambda g: "d{D}_g{G}_ps{PS}".format(**g))
def geometry(request, monkeypatch):
    """Sets the module's geometry for one cuda-marked case."""
    for name, value in request.param.items():
        monkeypatch.setitem(globals(), name, value)
    return request.param


@pytest.mark.cuda
def test_cuda_kernels_match_plain_versions(geometry):
    _need_card()
    for fmt, block_size, mixed in POOL_KINDS:
        block_size = min(block_size, D)
        # Tq 9: Tq * G (18 or 27) fills one 16-row block of the walk and
        # part of a second, as a verify window of 1 + K does at G 4
        for tq in (1, 3, 9):
            c = verify_case(fmt, block_size, tq, mixed=mixed, window=5,
                            softcap=5.0 if tq == 3 else None)
            want_out, want_visits, _ = run_verify_port(c, "cpu")
            out, visits, pools = run_verify_port(c, "cuda")
            np.testing.assert_array_equal(visits, want_visits)
            for got, name in zip(pools, POOLS):
                np.testing.assert_array_equal(got, c[name].view(np.uint8))
            np.testing.assert_allclose(out, want_out, rtol=0, atol=OUT_TOL)
        c = prefill_case(fmt, block_size, mixed=mixed, window=6,
                         softcap=5.0)
        want_out, want_visits, want_pools = run_prefill_port(c, "cpu")
        out, visits, pools = run_prefill_port(c, "cuda")
        for got, want in zip(pools, want_pools):
            np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(visits, want_visits)
        np.testing.assert_allclose(out, want_out, rtol=0, atol=OUT_TOL)


@pytest.mark.cuda
def test_cuda_ragged_decode_rows_bit_equal_verify_kernel(geometry):
    """One ragged step with decode rows and a 3-token window against the
    verify kernel over the pool the host write produces: the pools are
    identical and each row's real queries give the same bits."""
    _need_card()
    from repro_torch.nn.attention import AttnConfig, _write_pages
    from repro_torch.core import MXFP8

    rng = np.random.default_rng(3)
    starts, n_news, w = [9, 12, 2], [1, 3, 1], 8  # inside the tables
    c = verify_case("fp8_e4m3", 16, 1)
    table = torch.from_numpy(c["table"][:3]).cuda()
    pools = _torch_pools(c, "cuda")
    q = torch.from_numpy(_bf16(rng, (3, KVH, w, G, D))).bfloat16().cuda()
    k_new = torch.from_numpy(_bf16(rng, (3, w, KVH, D))).bfloat16().cuda()
    v_new = torch.from_numpy(_bf16(rng, (3, w, KVH, D))).bfloat16().cuda()
    st = torch.tensor(starts, dtype=torch.int32, device="cuda")
    lens = st + torch.tensor(n_news, dtype=torch.int32, device="cuda")
    ragged_pools = [p.clone() for p in pools]
    out, _ = tk.mx_attention_ragged_fused(
        q, k_new, v_new, *ragged_pools, table, st, lens, block_size=16)
    quant = MXFP8.replace(block_size=16, quantize_kv_cache=True)
    cfg = AttnConfig(d_model=KVH * G * D, num_heads=KVH * G,
                     num_kv_heads=KVH, head_dim=D)
    for i, n in enumerate(n_news):
        host = dict(zip(("k_elems", "k_scales", "v_elems", "v_scales"),
                        pools))
        posv = st[i:i + 1, None] + torch.arange(n, device="cuda")[None]
        _write_pages(host, k_new[i:i + 1, :n], v_new[i:i + 1, :n],
                     table[i:i + 1], posv, cfg, quant)
    for got, want in zip(_bytes(ragged_pools), _bytes(pools)):
        np.testing.assert_array_equal(got, want)
    for i, n in enumerate(n_news):
        ver = tk.mx_attention_verify_fused(
            q[i:i + 1, :, :n].contiguous(), *pools, table[i:i + 1],
            lens[i:i + 1], block_size=16)
        assert torch.equal(ver[0], out[i, :, :n])


@pytest.mark.cuda
def test_cuda_prefill_walks_g6_chunks_in_tiles(monkeypatch):
    """mixtral-8x22b's chunk (C 64, G 6, head_dim 128, pages of 16): 384
    query rows a cell need 316,672 bytes of shared memory, more than a
    block has, so the cell walks them in tiles of 32 tokens; held to the
    plain version (pool bytes, visits, out within OUT_TOL) on fp8 and
    mixed pools, the second chunk crossing a window of 100."""
    _need_card()
    for name, value in dict(D=128, G=6, PS=16).items():
        monkeypatch.setitem(globals(), name, value)
    lib = tk._library("mx_attention_paged")
    assert lib.mx_attention_paged_smem_bytes(64 * 6, 128, 16) > tk._MAX_SMEM
    assert tk.query_tile(64, 6, 128, 16, tk._paged_tile_bytes(lib)) == 32
    for mixed in (False, True):
        c = wide_prefill_case("fp8_e4m3", 32, mixed=mixed, window=100,
                              softcap=5.0)
        want_out, want_visits, want_pools = run_prefill_port(c, "cpu")
        out, visits, pools = run_prefill_port(c, "cuda")
        for got, want in zip(pools, want_pools):
            np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(visits, want_visits)
        np.testing.assert_allclose(out, want_out, rtol=0, atol=OUT_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("fmt,mixed", [("fp8_e4m3", False),
                                       ("fp4_e2m1", False),
                                       ("fp8_e4m3", True)])
def test_cuda_prefill_forced_tiles_equal_one_tile_bit_for_bit(monkeypatch,
                                                              fmt, mixed):
    """At C 64, G 4, head_dim 128 one tile holds the cell; forced tiles of
    16 (and of 48: an uneven last tile) give its outputs, pool bytes and
    visits bit for bit."""
    _need_card()
    for name, value in dict(D=128, G=4, PS=16).items():
        monkeypatch.setitem(globals(), name, value)
    c = wide_prefill_case(fmt, 32, mixed=mixed, softcap=5.0)
    out, visits, pools = run_prefill_port(c, "cuda")
    for tile in (16, 48):
        got = run_prefill_port(c, "cuda", tile_tokens=tile)
        np.testing.assert_array_equal(got[0], out)
        np.testing.assert_array_equal(got[1], visits)
        for a, b in zip(got[2], pools):
            np.testing.assert_array_equal(a, b)
