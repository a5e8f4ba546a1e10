"""How far the MX matmul kernels and their plain versions each lie from the
exact result with bf16 accumulation, on the card.

    PYTHONPATH=src python3 tools/mx_matmul_bf16_witness.py

``chip_smoke.py`` holds ``mx_matmul_wo`` / ``mx_matmul_vv`` with bf16
accumulation within two bf16 ulps of the largest |partial| or |running
sum| of the plain version's tile loop (the "bound"). This script measures
both sides against the exact tile loop (each bk tile's product in f64,
rounded once to f32, then the two bf16 roundings), in units of that bound,
where the bar between them has been seen to fail:

  1. a contraction of one bk tile, (M, K, N) = (300, 512, 260), blocks 8
     to 128, three formats, vv and wo with a bf16 and an f32 A, two seeds:
     per case the kernel-to-plain ratio and each side's distance from the
     exact loop, and at the farthest output |partial| / |A|.|B|;
  2. 33 bk tiles, (512, 4224, 4096) at block 128, bk 128, f32 A, fp8
     e4m3, three seeds: how many outputs lie 0, 1, 2, 3... ulps of the
     largest |partial| or |running sum| from the exact loop on each side,
     and for the kernel's farthest output the tile loop's prefix, the
     kernel's (A with the columns past tile T zeroed) beside the exact.

Needs a CUDA card. Prints the card's name and power limit first.
"""
from __future__ import annotations

import subprocess
import sys

import torch

from repro_torch.core import quantize
from repro_torch.kernels import mx_matmul as mm
from repro_torch.kernels.ops import quantize_pallas


def exact_loop(a, w, bk):
    out = torch.zeros((a.shape[0], w.shape[1]), dtype=torch.bfloat16,
                      device=a.device)
    for k0 in range(0, a.shape[1], bk):
        p = (a[:, k0:k0 + bk].double() @ w[k0:k0 + bk].double()).float()
        out = (out.float() + p.bfloat16().float()).bfloat16()
    return out


def ulp_of_big(a, w, bk):
    """One bf16 ulp of the largest |partial| or |running sum| of the f32
    tile loop (half of chip_smoke's two-ulp bound)."""
    out = torch.zeros((a.shape[0], w.shape[1]), dtype=torch.bfloat16,
                      device=a.device)
    big = torch.zeros(out.shape, device=a.device)
    for k0 in range(0, a.shape[1], bk):
        p = a[:, k0:k0 + bk] @ w[k0:k0 + bk]
        out = (out.float() + p.bfloat16().float()).bfloat16()
        big = torch.maximum(big, torch.maximum(p.abs(), out.float().abs()))
    ulp = torch.exp2(torch.floor(torch.log2(big.clamp(min=1e-30))) - 7)
    return torch.where(big > 0, ulp, torch.zeros_like(ulp))


def operands(m, k, n, fmt, block, seed):
    gen = torch.Generator("cuda").manual_seed(seed)
    w = quantize(torch.randn((k, n), generator=gen, device="cuda") / 64, fmt,
                 block, axis=0)
    x = torch.randn((m, k), generator=gen, device="cuda")
    return x, w


def calls(x, w, fmt, block, bk):
    kw = dict(fmt_name=fmt, block_size=block, acc_dtype=torch.bfloat16, bk=bk)
    xq = quantize_pallas(x, fmt, block)
    yield ("vv", xq.dequantize(),
           mm.mx_matmul_vv(xq.elements, xq.scales, w.elements, w.scales, **kw),
           mm.mx_matmul_vv_plain(xq.elements, xq.scales, w.elements,
                                 w.scales, **kw))
    for a in (x.bfloat16(), x):
        yield (f"wo {str(a.dtype)[6:]} A", a.float(),
               mm.mx_matmul_wo(a, w.elements, w.scales, **kw),
               mm.mx_matmul_wo_plain(a, w.elements, w.scales, **kw))


def one_tile() -> None:
    m, k, n = 300, 512, 260
    for seed in (0, 1):
        for block in (8, 16, 32, 64, 128):
            for fmt in ("fp8_e4m3", "fp8_e5m2", "fp4_e2m1"):
                x, w = operands(m, k, n, fmt, block, seed)
                ww = w.dequantize()
                for name, a, got, want in calls(x, w, fmt, block, k):
                    u2 = 2 * ulp_of_big(a, ww, k)
                    exact = exact_loop(a, ww, k).float()
                    dist = {side: (o.float() - exact).abs() / u2.clamp(
                        min=1e-30) for side, o in (("kernel", got),
                                                   ("plain", want))}
                    gate = float(((got.float() - want.float()).abs()
                                  / u2.clamp(min=1e-30)).max())
                    i = int(torch.maximum(dist["kernel"],
                                          dist["plain"]).argmax())
                    p = float((a.double() @ ww.double()).flatten()[i])
                    mag = float((a.abs().double() @ ww.abs().double())
                                .flatten()[i])
                    print(f"one tile seed {seed} block {block} {fmt} {name}: "
                          f"kernel to plain {gate:.3g} of the bound; from "
                          f"the exact loop kernel "
                          f"{float(dist['kernel'].max()):.3g}, plain "
                          f"{float(dist['plain'].max()):.3g}; at the "
                          f"farthest output |partial| / |A|.|B| "
                          f"{abs(p) / mag:.3g}")


def many_tiles() -> None:
    m, k, n, block, bk, fmt = 512, 4224, 4096, 128, 128, "fp8_e4m3"
    worst = (-1.0, None)
    for seed in (0, 1, 2):
        x, w = operands(m, k, n, fmt, block, seed)
        ww = w.dequantize()
        kw = dict(fmt_name=fmt, block_size=block, acc_dtype=torch.bfloat16,
                  bk=bk)
        got = mm.mx_matmul_wo(x, w.elements, w.scales, **kw)
        want = mm.mx_matmul_wo_plain(x, w.elements, w.scales, **kw)
        u = ulp_of_big(x, ww, bk)
        exact = exact_loop(x, ww, bk).float()
        for side, o in (("kernel", got), ("plain", want)):
            d = ((o.float() - exact).abs() / u.clamp(min=1e-30)).round()
            hist = torch.bincount(d.long().flatten()).tolist()
            print(f"33 tiles seed {seed} {side}: outputs at 0, 1, 2... ulps "
                  f"from the exact loop {hist}")
            if side == "kernel" and float(d.max()) > worst[0]:
                worst = (float(d.max()), (seed, divmod(int(d.argmax()), n)))
    seed, (i, j) = worst[1]
    x, w = operands(m, k, n, fmt, block, seed)
    ww = w.dequantize()
    kw = dict(fmt_name=fmt, block_size=block, acc_dtype=torch.bfloat16, bk=bk)
    o = torch.zeros((), dtype=torch.bfloat16, device="cuda")
    print(f"33 tiles seed {seed}, the kernel's farthest output ({i}, {j}):")
    for t in range(k // bk):
        cols = slice(t * bk, (t + 1) * bk)
        p64 = float(x[i, cols].double() @ ww[cols, j].double())
        p = torch.tensor(p64, device="cuda").float()
        o = (o.float() + p.bfloat16().float()).bfloat16()
        xa = x.clone()
        xa[:, (t + 1) * bk:] = 0
        kt = mm.mx_matmul_wo(xa, w.elements, w.scales, **kw)[i, j]
        print(f"  tile {t}: exact partial {p64:.10g} (f32 {float(p):.10g}, "
              f"bf16 {float(p.bfloat16()):.8g}); running sum exact "
              f"{float(o):.8g}, kernel {float(kt):.8g}")


def main() -> int:
    if not torch.cuda.is_available():
        print("mx_matmul_bf16_witness: no CUDA device visible",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    one_tile()
    many_tiles()
    return 0


if __name__ == "__main__":
    sys.exit(main())
