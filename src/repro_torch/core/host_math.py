"""Host f32 math that the jitted reference takes from XLA:CPU, bit for bit.

``csrc/host_math.c`` compiles, at first use, with the host C compiler
(``$CC``, else ``cc``) into a shared library under ``core/_build/``
(listed in ``.gitignore``), loaded with ctypes; the file name carries a
hash of the source and flags. The flags ``-O2 -fno-fast-math
-ffp-contract=off`` keep every rounding where the source puts it. A
helper that cannot be built raises: nothing falls back to torch's math.

* :func:`cos_sin` -- the C library's ``cosf`` / ``sinf`` of f32 angles,
  which the jitted reference's RoPE tables equal (C3).
* :func:`rsqrt` -- XLA:CPU's f32 ``rsqrt``: the x86 ``rsqrtps`` estimate
  and two FMA Newton steps (C4), of ``fma(x, scale, add)`` (RMSNorm's
  ``sum * (1 / width) + eps``, which XLA contracts). The estimate is the
  host CPU's, so the bits match the reference run on the same host; a
  host that is not x86 raises ``RuntimeError``. Differentiable: its
  gradient is ``-0.5 * scale * r**3`` times the incoming one.
* :func:`tanh` -- XLA:CPU's f32 ``tanh``, a rational approximation of its
  own that neither libm nor torch reproduces (C5), and :func:`gelu_tanh`,
  ``jax.nn.gelu(approximate=True)`` as XLA fuses it around that tanh.
  :func:`softcap` applies the tanh to CPU tensors as the jitted reference
  does. All three are differentiable: on CPU tensors their gradients are
  ``jax.jit(jax.grad(...))``'s bits (jax's tanh JVP in XLA:CPU's order,
  its contractions and flushed subnormals); on the card each is torch's
  ops and torch's autograd.
* :func:`exp`, :func:`logistic`, :func:`softplus` -- XLA:CPU's f32 exp (a
  Cephes polynomial of its own), ``jax.nn.sigmoid`` and
  ``jax.nn.softplus`` around it (softplus through XLA's log1p), which the
  recurrent mixers' gates and step sizes take; torch's exp parts from
  XLA's in about one value of ten. These have no gradient (the
  recurrent mixers' training waits for ROADMAP A9b).
* :func:`fma` and :func:`dot` -- the multiply-adds that XLA:CPU contracts
  (the RG-LRU scan's combine, the causal convolutions' taps) and its f32
  dot over a short contraction: one chain of fused multiply-adds in
  contraction order (the RG-LRU gates, the SSD scan's products).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np
import torch

from .formats import flush_subnormals

SOURCE = Path(__file__).resolve().parent / "csrc" / "host_math.c"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
CFLAGS = ("-O2", "-fno-fast-math", "-ffp-contract=off", "-shared", "-fPIC")

_lib = None


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join(CFLAGS).encode())
    return BUILD_DIR / f"libhost_math-{digest.hexdigest()[:16]}.so"


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    path = library_path()
    if not path.exists():
        cc = os.environ.get("CC") or shutil.which("cc") or shutil.which("gcc")
        if cc is None:
            raise RuntimeError("no C compiler (set CC): the host math "
                               "helpers are built from csrc/host_math.c")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run([cc, *CFLAGS, "-o", str(tmp), str(SOURCE),
                               "-lm"], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"building {SOURCE.name} failed:\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, path)
    lib = ctypes.CDLL(str(path))
    ptr, n = ctypes.c_void_p, ctypes.c_long
    lib.rope_cos_sin.argtypes = [ptr, ptr, ptr, n]
    lib.rope_cos_sin.restype = None
    lib.xla_rsqrt.argtypes = [ptr, ptr, n, ctypes.c_float, ctypes.c_float]
    lib.xla_rsqrt.restype = ctypes.c_int
    for fn in (lib.xla_tanh, lib.xla_gelu_tanh, lib.xla_exp, lib.xla_log,
               lib.xla_logistic, lib.xla_softplus):
        fn.argtypes = [ptr, ptr, n]
        fn.restype = None
    for fn in (lib.xla_tanh_grad, lib.xla_gelu_tanh_grad):
        fn.argtypes = [ptr, ptr, ptr, n]
        fn.restype = None
    lib.xla_softcap_grad.argtypes = [ptr, ptr, ptr, n, ctypes.c_float,
                                     ctypes.c_float]
    lib.xla_softcap_grad.restype = None
    lib.xla_fma.argtypes = [ptr, ptr, ptr, ptr, n]
    lib.xla_fma.restype = None
    lib.xla_dot.argtypes = [ptr, ptr, ptr, n, n, n, n, n]
    lib.xla_dot.restype = None
    _lib = lib
    return lib


def _host_f32(x: torch.Tensor) -> torch.Tensor:
    if x.device.type != "cpu" or x.dtype != torch.float32:
        raise ValueError(f"host math takes f32 CPU tensors, got {x.dtype} "
                         f"on {x.device}")
    return x.contiguous()


def cos_sin(angles: torch.Tensor) -> tuple:
    """``(cosf(angles), sinf(angles))``, one C call for the whole tensor.
    The tables are constants: angles that need a gradient raise."""
    if angles.requires_grad and torch.is_grad_enabled():
        raise ValueError("cos_sin has no gradient: pass detached angles")
    x = _host_f32(angles)
    c, s = torch.empty_like(x), torch.empty_like(x)
    _library().rope_cos_sin(x.data_ptr(), c.data_ptr(), s.data_ptr(),
                            x.numel())
    return c, s


def _rsqrt(x: torch.Tensor, scale: float, add: float) -> torch.Tensor:
    x = _host_f32(x)
    out = torch.empty_like(x)
    if _library().xla_rsqrt(x.data_ptr(), out.data_ptr(), x.numel(),
                            scale, add) != 0:
        raise RuntimeError("XLA:CPU's rsqrt is reproduced only on x86 hosts "
                           "(its rsqrtps estimate)")
    return out


class _Rsqrt(torch.autograd.Function):
    """The C call as an autograd node: d rsqrt(u) / du = -0.5 u^-1.5 =
    -0.5 r^3, and du / dx = scale."""

    @staticmethod
    def forward(ctx, x, scale, add):
        r = _rsqrt(x, scale, add)
        ctx.save_for_backward(r)
        ctx.scale = scale
        return r

    @staticmethod
    def backward(ctx, grad):
        (r,) = ctx.saved_tensors
        return grad * (-0.5 * ctx.scale) * (r * r * r), None, None


def rsqrt(x: torch.Tensor, scale: float = 1.0,
          add: float = -0.0) -> torch.Tensor:
    """XLA:CPU's f32 ``rsqrt`` of ``fma(x, scale, add)`` for every element,
    ``scale`` and ``add`` rounded to f32 (by default ``x`` itself, signed
    zeros kept); raises off x86. Special inputs as XLA's: +-0 and
    subnormals give +-inf, +inf gives 0, negatives and NaN give NaN.
    Gradients flow through it (``_Rsqrt``)."""
    return _Rsqrt.apply(x, scale, add)


def _elementwise(fn, x: torch.Tensor) -> torch.Tensor:
    if x.requires_grad and torch.is_grad_enabled():
        raise ValueError("exp, logistic and softplus have no gradient "
                         "(ROADMAP A9b)")
    return _host_call(fn, x)


def _host_call(fn, x: torch.Tensor, *args) -> torch.Tensor:
    x = _host_f32(x)
    out = torch.empty_like(x)
    fn(x.data_ptr(), out.data_ptr(), x.numel(), *args)
    return out


def _grad_call(fn, x: torch.Tensor, g: torch.Tensor, *args) -> torch.Tensor:
    x, g = _host_f32(x), _host_f32(g.expand_as(x))
    out = torch.empty_like(x)
    fn(x.data_ptr(), g.data_ptr(), out.data_ptr(), x.numel(), *args)
    return out


def _recip(cap: float) -> float:
    """``f32(1 / cap)``, the multiply XLA puts for a divide by ``cap``."""
    return float(np.float32(1.0) / np.float32(cap))


class _HostTanh(torch.autograd.Function):
    """:func:`tanh`, :func:`gelu_tanh` or :func:`softcap` of an f32 CPU
    tensor (``cap`` 0 for the first two), with XLA:CPU's gradient: the C
    helper's ``xla_*_grad`` of the saved input and the incoming
    gradient."""

    @staticmethod
    def forward(ctx, x, kind, cap):
        ctx.save_for_backward(x)
        ctx.kind, ctx.cap = kind, cap
        lib = _library()
        if kind == "softcap":
            u = flush_subnormals(x * _recip(cap))
            return _host_call(lib.xla_tanh, u) * cap
        return _host_call(getattr(lib, f"xla_{kind}"), x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        lib = _library()
        if ctx.kind == "softcap":
            dx = _grad_call(lib.xla_softcap_grad, x, g, ctx.cap,
                            _recip(ctx.cap))
        else:
            dx = _grad_call(getattr(lib, f"xla_{ctx.kind}_grad"), x, g)
        return dx, None, None


def tanh(x: torch.Tensor) -> torch.Tensor:
    """XLA:CPU's f32 ``tanh`` of every element of an f32 CPU tensor: ``x``
    itself below 0.0004 in magnitude, +-1 from 20, else its rational
    approximation on ``x`` clamped to +-7.99881172 (fused multiply-adds,
    one IEEE divide). Bit-equal to ``jax.jit(jnp.tanh)`` on the CPU, its
    gradient to the jitted ``jax.grad``'s: ``h = g * (1 - t)``, then
    ``fma(h, t, h)``. On the card ``torch.tanh``."""
    if x.device.type != "cpu":
        return torch.tanh(x)
    return _HostTanh.apply(x, "tanh", 0.0)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu(x, approximate=True)`` of an f32 CPU tensor as the
    jitted reference computes it: ``x * ((tanh(u) + 1) * 0.5)`` with ``u =
    fma(x**3, 0.044715, x) * f32(sqrt(2 / pi))`` (XLA contracts the
    multiply-add), :func:`tanh`, and subnormal operands and results
    flushed to signed zeros. Its gradient is the jitted ``jax.grad``'s
    (``xla_gelu_tanh_grad`` in ``csrc/host_math.c``); ``nn.ffn.gelu_tanh``
    takes the card."""
    return _HostTanh.apply(x, "gelu_tanh", 0.0)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    """``tanh(x / cap) * cap`` of f32 ``x``. On CPU tensors as the jitted
    reference computes it: XLA folds the divide into a multiply by
    ``f32(1 / cap)`` (a subnormal product flushed), and its tanh is
    :func:`tanh`; the gradient is
    ``fma(h, t, h) * f32(1 / cap)`` with ``h = (g * cap) * (1 - t)``, as
    XLA:CPU computes ``jax.grad``'s. On the card torch's divide and
    ``tanh``, as the CUDA kernels' ``tanhf(s / cap) * cap``, with torch's
    autograd."""
    if x.device.type != "cpu":
        return torch.tanh(x / cap) * cap
    return _HostTanh.apply(x, "softcap", float(cap))


def exp(x: torch.Tensor) -> torch.Tensor:
    """XLA:CPU's f32 ``exp`` of every element of an f32 CPU tensor."""
    return _elementwise(_library().xla_exp, x)


def log(x: torch.Tensor) -> torch.Tensor:
    """XLA:CPU's f32 ``log`` of every element of an f32 CPU tensor (no
    gradient)."""
    return _elementwise(_library().xla_log, x)


def logistic(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.sigmoid`` as XLA:CPU computes it: ``1 / (exp(-x) + 1)``
    with :func:`exp`."""
    return _elementwise(_library().xla_logistic, x)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus`` as XLA:CPU computes it: ``max(x, 0) +
    log1p(exp(-|x|))`` with :func:`exp` and XLA's log1p; NaN passes."""
    return _elementwise(_library().xla_softplus, x)


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` rounded once (``fmaf``), elementwise over f32 CPU
    tensors broadcast to one shape."""
    a, b, c = torch.broadcast_tensors(a, b, c)
    a, b, c = (_host_f32(t) for t in (a, b, c))
    out = torch.empty_like(a)
    _library().xla_fma(a.data_ptr(), b.data_ptr(), c.data_ptr(),
                       out.data_ptr(), out.numel())
    return out


def dot(a: torch.Tensor, b: torch.Tensor, lanes: int = 1) -> torch.Tensor:
    """The batched product ``a @ b`` of f32 CPU tensors (..., M, K) and
    (..., K, N) (batch axes broadcast) in an order of XLA:CPU's f32 dot
    over a short contraction: term k goes to lane ``k % lanes``, each lane
    one chain of fused multiply-adds in k order, the lanes summed in
    pairs. XLA picks the order by shape (:func:`dot_lanes`)."""
    if lanes < 1 or lanes & (lanes - 1):
        raise ValueError(f"lanes must be a power of two, got {lanes}")
    batch = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
    m, k = a.shape[-2:]
    n = b.shape[-1]
    if b.shape[-2] != k:
        raise ValueError(f"dot of {tuple(a.shape)} and {tuple(b.shape)}")
    a = _host_f32(a.expand(*batch, m, k))
    b = _host_f32(b.expand(*batch, k, n))
    out = torch.empty((*batch, m, n), dtype=torch.float32)
    nb = out.numel() // max(m * n, 1)
    if out.numel():
        _library().xla_dot(a.data_ptr(), b.data_ptr(), out.data_ptr(), nb, m,
                           k, n, lanes)
    return out


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """f32 batched ``a @ b``, (..., M, K) by (..., K, N): on CPU tensors
    in XLA:CPU's order for the shape (:func:`dot` over :func:`dot_lanes`),
    on the card ``torch.matmul``."""
    if a.device.type != "cpu":
        return torch.matmul(a, b)
    m, k = a.shape[-2:]
    return dot(a, b, dot_lanes(m, k, b.shape[-1]))


def dot_lanes(m: int, k: int, n: int) -> int:
    """The lanes of XLA:CPU's f32 dot of an (M, K) by a (K, N) matrix
    (batched or not), as measured against ``jax.jit(jnp.einsum)``: a
    matrix-vector product (N 1, M >= 8) sums in 8 lanes; a product with
    2 <= N <= 16 columns in 4 over K >= 8 (one chain where M is 1, or M
    and N are both 2) and over K = 4 from M 8; every other shape with K
    <= 3 or N >= 17 in one chain. Other shapes (K 5-7, or N 1 below M 8)
    sum in orders not reproduced here: the result then lies within an
    f32 ulp or so of XLA's."""
    if k >= 8 and n == 1 and m >= 8:
        return 8
    if k >= 8 and 2 <= n <= 16 and m >= 2 and not (m == 2 and n == 2):
        return 4
    if k == 4 and 2 <= n <= 16 and m >= 8:
        return 4
    return 1
