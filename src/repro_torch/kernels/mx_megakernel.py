"""The layer-fused megakernel: a whole L-layer ragged engine step in one
launch (port of ``repro.kernels.mx_megakernel``).

``mx_megakernel_step`` runs every layer's RMSNorm, q/k/v products, RoPE,
the ragged MX page walk with its in-kernel quantized K/V write, the
output product, the residual add, the FFN RMSNorm, the FFN of the
reference's three kinds (``FFN_KINDS``: the gated SwiGLU and GeGLU, and
the no-gate GELU of the up projection alone) and the second residual
add. On CUDA tensors it launches one persistent
cooperative kernel (``csrc/mx_megakernel.cu``) per call, with the
products in its own body; on CPU tensors it runs
:func:`mx_megakernel_step_plain`, the port's per-layer ragged step
composed over the stacked weights and pools, so on the CPU the two steps
are bit-identical by construction. There is no fallback: a CUDA tensor
launches the kernel or raises.

Layouts (``L`` the layer axis, weights prepared as ``nn.linear`` stores
them: fake-quantized once, bf16, ``(d_in, d_out)``)::

  x0          (R, W, DM)               the embedded tokens
  norm_mixer  (L, DM) f32              RMSNorm scales (before ``1 +``)
  wq          (L, DM, H * D)
  wk, wv      (L, DM, KVH * D)
  wo          (L, H * D, DM)
  norm_ffn    (L, DM) f32
  gate, up    (L, DM, DFF)               gate None for ffn_kind "gelu"
  down        (L, DFF, DM)
  pools       (L, NP, PS, KVH, ED / NB)  the ragged kernel's pools, stacked
  page_table  (R, P) int               shared by every layer; entries < 0
                                       map to each layer's trash page NP - 1
  row_start   (R,) int, seq_lens (R,) int, page_fmts (NP,) int32: as for
                                       ``mx_attention_ragged_fused``

Returns ``(x (R, W, DM) final residual, pools)``, plus the (L, R, KVH, 1)
pages each layer's cells walked with ``debug_visits=True``. The pools
are updated in place. The final norm and the LM head stay outside.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import formats as F

from . import build
from .mx_attention import (MIXED_FMTS_DEFAULT, _check_fmt, _check_meta,
                           _check_pool_shapes, _launch_common, _mixed_ids,
                           _on_one_device, _ptr,
                           mx_attention_ragged_fused_plain, normalize_rows,
                           query_tile)

_lib = None
#: global scratch of the kernel's phases, one set per shape and device
_scratch = {}


def _library():
    global _lib
    if _lib is None:
        lib = build.load("mx_megakernel")
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.mx_megakernel_launch.argtypes = ([ptr] * 30 + [i32] * 25
                                             + [f32] * 3 + [ptr])
        lib.mx_megakernel_launch.restype = i32
        lib.mx_megakernel_smem_bytes.argtypes = [i32] * 4
        lib.mx_megakernel_smem_bytes.restype = ctypes.c_size_t
        lib.mx_megakernel_grid.argtypes = [i32] * 4
        lib.mx_megakernel_grid.restype = i32
        _lib = lib
    return _lib


def walk_tile(w: int, g: int, d: int, ps: int) -> int:
    """Tokens of the query tile phase B walks a cell's ``w * g`` rows in
    (:func:`mx_attention.query_tile` under this kernel's shared memory:
    ``w`` where the whole cell fits beside the product ring)."""
    return query_tile(w, g, d, ps, _library().mx_megakernel_smem_bytes)


def grid_size(w: int, g: int, d: int, ps: int) -> int:
    """CTAs of the persistent grid on the current card at these shapes
    (one per SM when the shared memory allows one), with phase B's walk in
    :func:`walk_tile`'s tiles."""
    n = _library().mx_megakernel_grid(walk_tile(w, g, d, ps), g, d, ps)
    if n <= 0:
        raise RuntimeError(f"mx_megakernel_grid failed: cudaError {-n}")
    return n


#: the FFN kinds of the fused layer tail, by the kernel's id (its index):
#: the activation is silu (swiglu) or the tanh GELU (geglu) of the gate
#: times up, or the tanh GELU of up alone (gelu, no gate)
FFN_KINDS = ("swiglu", "geglu", "gelu")
GATED_KINDS = ("swiglu", "geglu")

#: the kernel's product tile (csrc/mx_megakernel.cu): TILE_N weight
#: columns (a gate/up pair: TILE_N / 2 of each) by one of TILE_ROWS
#: activation rows, walked in TILE_K-deep TMA stages
TILE_N, TILE_K = 128, 64
TILE_ROWS = (256, 128)
#: the step's product phases, in the kernel's order: name -> (N, K) of
#: each job; gate_up is a pair (its tile holds both products' columns)
#: unless the FFN has no gate (then it is up's product alone)
PHASES = ("qkv", "wo", "gate_up", "down")


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def megakernel_plan(m: int, dm: int, hd: int, kvd: int, dff: int,
                    ctas: int, gated: bool = True) -> dict:
    """The product plan of one launch: for each phase its jobs' (N, K),
    the activation rows of its tiles and its tile count.

    ``ctas`` CTAs take a phase's tiles grid-stride, each tile's whole
    contraction in one CTA (summed in order, as the per-layer step's
    products are). A CTA pulls a stage's weight boxes (16 KB) and its
    activation rows (256 B a row) from L2 for each of its tiles in turn,
    so a phase's time goes as its waves times that; the plan takes the
    tile rows with the least, the larger on a tie. At granite's 512 rows
    (8 rows of one 64-token chunk) on 132 SMs that is 256 rows for q/k/v
    (96 tiles) and gate/up (448), and 128 for wo and down (128 tiles where
    256 rows leave 64). At 2,048 rows (four chunks a row, W 256) every
    phase takes 256: q/k/v 384 tiles, wo and down 256, gate/up 1,792.
    Without a gate (``gated`` False: the ``gelu`` kind) the up product
    alone takes the gate_up phase, TILE_N columns a tile; at musicgen's
    widths (d_model 1,536, 24 heads of 64, d_ff 6,144) and 512 rows that
    is 256 rows for q/k/v (72 tiles) and up (96), 128 for wo and down (48
    each): one wave each on 132 SMs.
    Returns ``{name: {"jobs", "pair", "rows", "tm", "tiles"}}``.
    """
    if min(m, dm, hd, kvd, dff, ctas) < 1:
        raise ValueError("megakernel_plan takes positive sizes")
    jobs = {"qkv": ((hd, dm), (kvd, dm), (kvd, dm)), "wo": ((dm, hd),),
            "gate_up": ((dff, dm),), "down": ((dm, dff),)}
    plan = {}
    for name in PHASES:
        pair = gated and name == "gate_up"
        cols = TILE_N // 2 if pair else TILE_N
        best = None
        for rows in TILE_ROWS:
            tm = _cdiv(m, rows)
            tiles = sum(tm * _cdiv(n, cols) for n, _ in jobs[name])
            cost = _cdiv(tiles, ctas) * (2 * TILE_K * 128 + rows * 128)
            if best is None or cost < best[0]:
                best = (cost, dict(jobs=jobs[name], pair=pair, rows=rows,
                                   tm=tm, tiles=tiles))
        plan[name] = best[1]
    return plan


def plan_units(plan: dict, name: str) -> list:
    """The kernel's walk of phase ``name`` (its ``unit_of``): for each
    unit in order, ``(job, tile_m, tile_n)`` -- the jobs one after the
    other, within a job the activation tile fastest."""
    ph = plan[name]
    cols = TILE_N // 2 if ph["pair"] else TILE_N
    return [(job, u % ph["tm"], u // ph["tm"])
            for job, (n, _) in enumerate(ph["jobs"])
            for u in range(ph["tm"] * _cdiv(n, cols))]


def _scratch_for(dev, m: int, dm: int, hd: int, kvd: int, dff: int):
    key = (str(dev), m, dm, hd, kvd, dff)
    if key not in _scratch:
        bf = dict(dtype=torch.bfloat16, device=dev)
        _scratch[key] = (
            torch.empty((m, dm), **bf),    # normed residual
            torch.empty((m, hd), **bf),    # q
            torch.empty((m, kvd), **bf),   # k
            torch.empty((m, kvd), **bf),   # v
            torch.empty((m, hd), **bf),    # RoPE'd q, cell-major
            torch.empty((m, hd), **bf),    # attention output
            torch.empty((m, dm), dtype=torch.float32, device=dev),  # sum
            torch.empty((m, dff), **bf))   # FFN hidden
    return _scratch[key]


def _launch(x0, weights, norms, pools, table, start, lens, *, head_dim,
            rope_theta, norm_eps, ffn_kind, fmt_name, block_size, softcap,
            window, page_fmts, mixed_fmts, num_positions):
    from repro_torch.nn.rotary import rope_table

    wq, wk, wv, wo, gate, up, down = weights
    gated = gate is not None
    named = [(n, t) for n, t in zip(("wq", "wk", "wv", "wo", "gate", "up",
                                     "down"), weights) if t is not None]
    r, w, dm = x0.shape
    layers, npages, ps, kvh, ed = pools[0].shape
    d = head_dim
    h = wq.shape[-1] // d
    dff = up.shape[-1]
    lib = _library()
    tile = walk_tile(w, h // kvh, d, ps)
    smem = lib.mx_megakernel_smem_bytes(tile, h // kvh, d, ps)
    _launch_common(
        [("x0", x0)] + named,
        list(zip(("ke", "ks", "ve", "vs"), pools))
        + [("norm_mixer", norms[0]), ("norm_ffn", norms[1]),
           ("page_fmts", page_fmts)], ps, d, block_size, smem,
        tile * h // kvh)
    if any(t.dtype != torch.float32 for t in norms):
        raise TypeError("the CUDA megakernel takes f32 norm scales")
    for name, t in named:
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary "
                             "(TMA)")
    cos, sin = rope_table(d, float(rope_theta), num_positions, x0.device)
    grid = grid_size(w, h // kvh, d, ps)
    plan = megakernel_plan(r * w, dm, h * d, kvh * d, dff, grid, gated)
    scratch = _scratch_for(x0.device, r * w, dm, h * d, kvh * d, dff)
    out = torch.empty_like(x0)
    visits = torch.empty((layers, r, kvh, 1), dtype=torch.int32,
                         device=x0.device)
    mask, default = _mixed_ids(page_fmts, mixed_fmts)
    err = lib.mx_megakernel_launch(
        x0.data_ptr(), out.data_ptr(), *(t.data_ptr() for t in norms),
        *(t.data_ptr() for t in (wq, wk, wv, wo, gate if gated else up, up,
                                 down)),
        *(t.data_ptr() for t in pools),
        table.data_ptr(), start.data_ptr(), lens.data_ptr(), _ptr(page_fmts),
        cos.data_ptr(), sin.data_ptr(), *(t.data_ptr() for t in scratch),
        visits.data_ptr(), layers, r, w, h, kvh, d, dm, dff, npages, ps, ed,
        table.shape[1], num_positions, tile, block_size,
        F.FORMAT_IDS[fmt_name],
        -1 if window is None else int(window), mask, default, grid,
        FFN_KINDS.index(ffn_kind),
        *(plan[k]["rows"] for k in PHASES), float(norm_eps),
        float(softcap or 0.0), float(d ** -0.5),
        torch.cuda.current_stream(x0.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"mx_megakernel_launch failed: cudaError {err}")
    mx_megakernel_step.launches += 1
    return out, visits


def mx_megakernel_step_plain(x0, weights, norms, pools, table, start, lens,
                             *, head_dim, rope_theta, norm_eps, fmt_name,
                             block_size, softcap, window, page_fmts,
                             mixed_fmts, ffn_kind="swiglu",
                             compute_dtype=torch.bfloat16):
    """The port's per-layer ragged step over the stacked weights and
    pools, layer by layer: ``nn.attention.apply_ragged`` (norm, the
    rounded products, RoPE from the host-made table) with
    :func:`mx_attention_ragged_fused_plain` as its attention, then the
    residual add and the FFN of ``ffn_kind`` (``nn.ffn.apply``) of
    ``nn.blocks._decode_tail``. Expects the rows normalised by
    ``normalize_rows``. Returns ``(x, visits)``."""
    from repro_torch.core import QuantConfig
    from repro_torch.nn import attention, blocks
    from repro_torch.nn.norms import rmsnorm_apply

    wq, wk, wv, wo, gate, up, down = weights
    d = head_dim
    kvh = pools[0].shape[3]
    acfg = attention.AttnConfig(
        d_model=x0.shape[-1], num_heads=wq.shape[-1] // d, num_kv_heads=kvh,
        head_dim=d, rope_theta=rope_theta, window=window, softcap=softcap)
    quant = QuantConfig(fmt=fmt_name, block_size=block_size,
                        quantize_acts=False, quantize_kv_cache=True)
    visits = []

    def attend(*args, **kw):
        out, vis = mx_attention_ragged_fused_plain(*args, **kw)
        visits.append(vis)
        return out, args[3:7]

    x = x0
    for li in range(wq.shape[0]):
        pool = dict(zip(("k_elems", "k_scales", "v_elems", "v_scales"),
                        (p[li] for p in pools)))
        mixer = {name: {"w": t[li]} for name, t in
                 (("wq", wq), ("wk", wk), ("wv", wv), ("wo", wo))}
        h = rmsnorm_apply({"scale": norms[0][li]}, x, norm_eps)
        h = attention.apply_ragged(mixer, h, pool, table, start, lens, acfg,
                                   quant, compute_dtype, page_fmts=page_fmts,
                                   mixed_fmts=mixed_fmts, attend=attend)
        tail = {"norm_ffn": {"scale": norms[1][li]},
                "ffn": {name: {"w": t[li]} for name, t in
                        (("gate", gate), ("up", up), ("down", down))
                        if t is not None}}
        x = blocks._decode_tail(tail, x, h, norm_eps, compute_dtype,
                                ffn_kind).to(compute_dtype)
    return x, torch.stack(visits)


def mx_megakernel_step(x0, norm_mixer, wq, wk, wv, wo, norm_ffn, gate, up,
                       down, ke_pool, ks_pool, ve_pool, vs_pool, page_table,
                       row_start, seq_lens, *, head_dim: int,
                       rope_theta: float, norm_eps: float,
                       ffn_kind: str = "swiglu", quant=None,
                       fmt_name: str = "fp8_e4m3", block_size: int = 32,
                       softcap=None, window=None,
                       compute_dtype=torch.bfloat16, page_fmts=None,
                       mixed_fmts=None, debug_visits: bool = False):
    """The whole decoder stack over a ragged row batch in one launch (the
    module docstring has the layouts).

    ``ffn_kind`` is one of ``FFN_KINDS``; ``gate`` is None for the no-gate
    ``gelu`` kind and a tensor for the gated ones (else ``ValueError``).
    ``quant`` is the model's ``QuantConfig``: the weights arrive prepared,
    and activation quantization is refused, as in the reference. Tiered
    pools (``page_fmts``) write the window in ``fmt_name``, which must be
    an fp8. CUDA tensors launch the kernel (counted in
    ``mx_megakernel_step.launches``); CPU tensors run
    :func:`mx_megakernel_step_plain`. The table and row vectors are
    normalised as the ragged wrapper does.
    """
    mixed = page_fmts is not None
    _check_fmt(ke_pool, fmt_name, mixed=mixed)
    if mixed:
        mixed_fmts = tuple(mixed_fmts or MIXED_FMTS_DEFAULT)
        if F.get_format(fmt_name).bits != 8:
            raise ValueError(
                "tiered megakernel steps write the window in the hot "
                f"format, which must be an fp8; got {fmt_name!r}")
    else:
        mixed_fmts = None
    if quant is not None and quant.enabled and quant.quantize_acts:
        raise ValueError(
            "the megakernel runs weight-only or unquantized linears; "
            "activation quantization is rejected by the engine's fallback "
            "ladder")
    if ffn_kind not in FFN_KINDS:
        raise ValueError(f"unknown ffn_kind {ffn_kind!r} (expected one of "
                         f"{FFN_KINDS})")
    if (gate is not None) != (ffn_kind in GATED_KINDS):
        raise ValueError(
            f"ffn_kind {ffn_kind!r} takes "
            f"{'a gate' if ffn_kind in GATED_KINDS else 'no gate'}")
    r, w, dm = x0.shape
    layers, d = wq.shape[0], head_dim
    pools = (ke_pool, ks_pool, ve_pool, vs_pool)
    if any(p.ndim != 5 or p.shape[0] != layers for p in pools):
        raise ValueError(f"pools must be stacked (L={layers}, NP, PS, KVH, "
                         "ED / NB)")
    kvh = ke_pool.shape[3]
    _check_pool_shapes(kvh, d, *(p[0] for p in pools), fmt_name, block_size,
                       page_fmts, mixed_fmts, "megakernel steps")
    hd, kvd, dff = wq.shape[-1], kvh * d, up.shape[-1]
    want = {"wq": (dm, hd), "wk": (dm, kvd), "wv": (dm, kvd), "wo": (hd, dm),
            "gate": (dm, dff), "up": (dm, dff), "down": (dff, dm)}
    weights = (wq, wk, wv, wo, gate, up, down)
    for (name, shape), t in zip(want.items(), weights):
        if t is not None and t.shape != (layers, *shape):
            raise ValueError(f"{name} must be {(layers, *shape)}, got "
                             f"{tuple(t.shape)}")
    if hd % d or (hd // d) % kvh:
        raise ValueError("wq's heads must group evenly over the kv heads")
    norms = (norm_mixer, norm_ffn)
    if any(t.shape != (layers, dm) for t in norms):
        raise ValueError(f"norm scales must be {(layers, dm)}")
    _check_meta(r, page_table, row_start, seq_lens, window=window)
    dev = x0.device
    _on_one_device(dev, *weights, *norms, *pools, page_table, row_start,
                   seq_lens, page_fmts)
    table, start, lens = normalize_rows(page_table, row_start, seq_lens,
                                        ke_pool.shape[1], w)
    kw = dict(head_dim=d, rope_theta=rope_theta, norm_eps=norm_eps,
              ffn_kind=ffn_kind, fmt_name=F.get_format(fmt_name).name,
              block_size=block_size, softcap=softcap, window=window,
              page_fmts=page_fmts, mixed_fmts=mixed_fmts)
    if dev.type == "cuda":
        if compute_dtype != torch.bfloat16:
            raise TypeError("the CUDA megakernel computes in bf16")
        # the RoPE table covers every position a row's pages can hold
        x, visits = _launch(x0, weights, norms, pools, table, start, lens,
                            num_positions=table.shape[1] * ke_pool.shape[2]
                            + w, **kw)
    else:
        x, visits = mx_megakernel_step_plain(
            x0, weights, norms, pools, table, start, lens,
            compute_dtype=compute_dtype, **kw)
    return (x, pools, visits) if debug_visits else (x, pools)


#: CUDA launches (the plain CPU version is not counted)
mx_megakernel_step.launches = 0
