"""The port's ragged MX page-walk kernel against the reference kernel.

``repro_torch.kernels.mx_attention_ragged_fused`` on CPU tensors runs its
plain PyTorch version; ``repro.kernels.mx_attention_ragged_fused`` runs
the Pallas kernel in interpret mode, as the reference's own tests do.
Both get the same numpy inputs: a batch mixing a decode row with a
mid-page start, a 3-token window across a page boundary, a fresh prefill
chunk, a continuation chunk with an unaligned start, and an inactive row
whose table is all -1 (the trash page). Written pool bytes and visit
counts must be identical; ``out`` must agree within 1e-5 (the two sum
f32 products in different orders).

The CUDA kernel itself is held to the plain version on the card by
``chip_smoke.py`` and by the ``cuda``-marked test below.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.core import quantize as jquantize  # noqa: E402
from repro.kernels import mx_attention_ragged_fused as jax_ragged  # noqa: E402
from repro_torch.kernels import mx_attention as tk  # noqa: E402

OUT_TOL = 1e-5


def make_case(fmt, block_size, *, d=64, g=2, kvh=2, ps=8, w=8, seed=101,
              window=None, softcap=None):
    """Numpy inputs for one ragged step (bf16-representable q/k/v)."""
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
        qx = jquantize(jnp.asarray(x), fmt, block_size)
        return (np.asarray(qx.elements).view(np.uint8).reshape(
            npages, ps, kvh, d).copy(),
            np.asarray(qx.scales).reshape(npages, ps, kvh, -1).copy())

    # decoy codes everywhere: rows outside each window must keep them
    ke, ks = pool(rng.normal(size=(npages * ps * kvh, d)).astype(np.float32))
    ve, vs = pool(rng.normal(size=(npages * ps * kvh, d)).astype(np.float32))

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
                block_size=block_size, window=window, softcap=softcap)


def run_reference(c):
    fmt = c["fmt"]
    view = {"fp8_e4m3": jnp.float8_e4m3fn, "fp8_e5m2": jnp.float8_e5m2}[fmt]
    out, pools, visits = jax_ragged(
        jnp.asarray(c["q"]), jnp.asarray(c["k_new"]), jnp.asarray(c["v_new"]),
        jnp.asarray(c["ke"]).view(view), jnp.asarray(c["ks"]),
        jnp.asarray(c["ve"]).view(view), jnp.asarray(c["vs"]),
        jnp.asarray(c["table"]), jnp.asarray(c["starts"]),
        jnp.asarray(c["lens"]), fmt_name=fmt, block_size=c["block_size"],
        window=c["window"], softcap=c["softcap"], debug_visits=True)
    pools = [np.asarray(p).view(np.uint8) for p in pools]
    return np.asarray(out), pools, np.asarray(visits)


def run_port(c, device="cpu"):
    fmt = c["fmt"]
    dt = {"fp8_e4m3": torch.float8_e4m3fn, "fp8_e5m2": torch.float8_e5m2}[fmt]

    def t(x, dtype=None):
        x = torch.from_numpy(np.array(x)).to(device)  # own copy: pools
        # are updated in place
        return x if dtype is None else x.to(dtype)

    pools = [t(c["ke"]).view(dt), t(c["ks"]), t(c["ve"]).view(dt),
             t(c["vs"])]
    out, pools, visits = tk.mx_attention_ragged_fused(
        t(c["q"], torch.bfloat16), t(c["k_new"], torch.bfloat16),
        t(c["v_new"], torch.bfloat16), *pools, t(c["table"]),
        t(c["starts"]), t(c["lens"]), fmt_name=fmt,
        block_size=c["block_size"], window=c["window"], softcap=c["softcap"],
        debug_visits=True)
    pools = [p.view(torch.uint8).cpu().numpy() for p in pools]
    return out.cpu().numpy(), pools, visits.cpu().numpy()


@pytest.mark.parametrize("fmt,block_size,window,softcap", [
    ("fp8_e4m3", 16, None, None), ("fp8_e4m3", 32, 6, None),
    ("fp8_e5m2", 16, 6, 5.0), ("fp8_e5m2", 32, None, None)])
def test_plain_ragged_matches_reference_kernel(fmt, block_size, window,
                                               softcap):
    case = make_case(fmt, block_size, window=window, softcap=softcap)
    want_out, want_pools, want_visits = run_reference(case)
    out, pools, visits = run_port(case)
    for name, got, want in zip(("ke", "ks", "ve", "vs"), pools, want_pools):
        np.testing.assert_array_equal(got, want, err_msg=name)
    np.testing.assert_array_equal(visits, want_visits)
    # the write window really was written (the check is not vacuous)
    assert not np.array_equal(pools[0], case["ke"])
    np.testing.assert_allclose(out, want_out, rtol=0, atol=OUT_TOL)


@pytest.mark.parametrize("unported", [
    dict(fmt_name="fp4_e2m1"), dict(fmt_name="fp6_e3m2"),
    dict(page_fmts=np.zeros(4, np.int32))])
def test_unported_pool_formats_raise(unported):
    case = make_case("fp8_e4m3", 16)
    t = {k: torch.from_numpy(np.ascontiguousarray(v))
         for k, v in case.items() if isinstance(v, np.ndarray)}
    with pytest.raises(NotImplementedError):
        tk.mx_attention_ragged_fused(
            t["q"], t["k_new"], t["v_new"], t["ke"], t["ks"], t["ve"],
            t["vs"], t["table"], t["starts"], t["lens"], block_size=16,
            **unported)


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    for fmt, softcap in (("fp8_e4m3", None), ("fp8_e5m2", 5.0)):
        case = make_case(fmt, 16, window=6, softcap=softcap)
        want_out, want_pools, want_visits = run_port(case, "cpu")
        out, pools, visits = run_port(case, "cuda")
        trash = case["ke"].shape[0] - 1  # scratch page: racy by contract
        for got, want in zip(pools, want_pools):
            np.testing.assert_array_equal(got[:trash], want[:trash])
        np.testing.assert_array_equal(visits, want_visits)
        live = slice(0, len(case["starts"]) - 1)
        np.testing.assert_allclose(out[live], want_out[live], rtol=0,
                                   atol=OUT_TOL)
