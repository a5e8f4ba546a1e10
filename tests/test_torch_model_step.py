"""One ragged model step of the port against ``repro.nn.model``.

Reduced granite-8b (2 layers, d_model 64, head_dim 16, MX block 16),
weight-only MXFP8 with an MX fp8 KV cache, as the serving launcher runs
it. The reference's param tree is carried over with ``params_from_jax``,
so both packages compute with the same weights. Two steps run back to
back on the same pools: a prefill chunk, a partial chunk, a one-token
row and an inactive row; then decode rows with mid-page starts and a
continuation chunk with an unaligned start.

Bars:
  * the reference step's own wide K/V (its projections + RoPE), fed to
    the port's ragged attention, writes the same pool bytes as the
    reference kernel does;
  * end to end, logits agree within one bf16 ulp of the largest logit
    (the reference returns bf16-rounded logits, and attention sums f32
    products in another order), and at most CODE_FRACTION of the stored
    fp8 codes may differ (measured: none, because the port reproduces
    the reference's rounding points, see ``nn.blocks._decode_tail``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs import get_reduced as jax_reduced  # noqa: E402
from repro.kernels import mx_attention_ragged_fused as jax_ragged  # noqa: E402
from repro.nn import attention as jattn  # noqa: E402
from repro.nn import blocks as jblocks  # noqa: E402
from repro.nn import embedding as jemb  # noqa: E402
from repro.nn import model as jmodel  # noqa: E402
from repro.nn.norms import rmsnorm_apply as jrms  # noqa: E402
from repro_torch.configs import get_reduced as torch_reduced  # noqa: E402
from repro_torch.kernels import mx_attention_ragged_fused  # noqa: E402
from repro_torch.nn import model as tmodel  # noqa: E402
from repro_torch.nn import rotary  # noqa: E402

CODE_FRACTION = 1e-3
POOL_KEYS = ("k_elems", "k_scales", "v_elems", "v_scales")


def serving_configs():
    """(reference cfg, port cfg): reduced granite as the launcher serves
    it (weight-only MX, MX KV pages)."""
    j = jax_reduced("granite-8b")
    j = j.replace(quant=j.quant.replace(quantize_acts=False,
                                        quantize_kv_cache=True),
                  decode_kernel="fused")
    t = torch_reduced("granite-8b")
    t = t.replace(quant=t.quant.replace(quantize_acts=False,
                                        quantize_kv_cache=True))
    return j, t


def port_params(jparams, tcfg):
    return tmodel.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                                  tcfg, "cpu")


def _steps():
    """Row metadata of the two steps (R=4 rows, W=16, page size 4)."""
    table = np.full((4, 8), -1, np.int32)
    table[0, :5] = [0, 1, 2, 3, 8]
    table[1, :4] = [4, 5, 6, 9]
    table[2, :2] = [7, 10]
    first = dict(starts=[0, 0, 0, 0], lens=[16, 9, 1, 1], lidx=[15, 8, 0, 0])
    second = dict(starts=[16, 9, 1, 0], lens=[17, 16, 2, 1], lidx=[0, 6, 0, 0])
    return table, [first, second]


def _pool_bytes(pool) -> list:
    return [np.asarray(pool[k]).view(np.uint8) for k in POOL_KEYS]


def test_ragged_step_logits_and_pools_match_reference():
    jcfg, tcfg = serving_configs()
    jparams, _ = jmodel.init(jax.random.PRNGKey(0), jcfg)
    tparams = port_params(jparams, tcfg)
    num_pages, ps = 13, 4
    jcache = jmodel.init_paged_cache(jcfg, 4, num_pages, ps)
    tcache = tmodel.init_paged_cache(tcfg, num_pages, ps, "cpu")
    step = jax.jit(lambda p, c, *a: jmodel.ragged_step_paged(p, jcfg, c, *a))
    rng = np.random.default_rng(0)
    table, steps = _steps()
    for meta in steps:
        tokens = rng.integers(0, tcfg.vocab_size, (4, 16)).astype(np.int32)
        args = [tokens, table] + [np.asarray(meta[k], np.int32)
                                  for k in ("starts", "lens", "lidx")]
        want, jcache = step(jparams, jcache, *map(jnp.asarray, args))
        got = tmodel.ragged_step_paged(
            tparams, tcfg, tcache, *(torch.from_numpy(a) for a in args))
        want = np.asarray(want)[:3, 0]  # row 3 is inactive: garbage logits
        got = got.numpy()[:3]
        tol = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
        np.testing.assert_allclose(got, want, rtol=0, atol=tol)
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
        differing = total = 0
        for layer, tpool in enumerate(tcache):
            jpool = {k: v[layer] for k, v in jcache["groups"][0].items()}
            for g, w in zip(_pool_bytes({k: t.view(torch.uint8).numpy()
                                         for k, t in tpool.items()}),
                            _pool_bytes(jpool)):
                differing += int((g != w).sum())
                total += g.size
        assert differing / total <= CODE_FRACTION, (differing, total)


def test_reference_kv_through_port_attention_writes_identical_pages():
    """Per layer: the reference's projections + RoPE of the layer input,
    fed to both ragged kernels on the same pool, write identical bytes;
    layer 0's pages also equal what the reference's full step wrote."""
    jcfg, tcfg = serving_configs()
    jparams, _ = jmodel.init(jax.random.PRNGKey(1), jcfg)
    table, steps = _steps()
    meta = steps[0]
    tokens = np.random.default_rng(1).integers(0, 512, (4, 16)).astype(
        np.int32)
    starts, lens = (np.asarray(meta[k], np.int32) for k in ("starts", "lens"))
    num_pages, ps = 13, 4
    jcache = jmodel.init_paged_cache(jcfg, 4, num_pages, ps)
    _, stepped = jax.jit(lambda p, c, *a: jmodel.ragged_step_paged(
        p, jcfg, c, *a))(jparams, jcache, jnp.asarray(tokens),
                         jnp.asarray(table), jnp.asarray(starts),
                         jnp.asarray(lens), jnp.asarray(meta["lidx"]))
    bd = jcfg.pattern[0]
    acfg = jblocks._attn_cfg(jcfg, bd)

    @jax.jit
    def layer_qkv(p, x):
        h = jrms(p["norm_mixer"], x, jcfg.norm_eps)
        posv = jnp.asarray(starts)[:, None] + jnp.arange(16)[None]
        return jattn._project_decode_qkv(p["mixer"], h, posv, acfg,
                                         jcfg.quant, jcfg.compute_dtype)

    block = jax.jit(lambda p, x, c: jblocks.apply_ragged_step(
        p, x, c, jnp.asarray(table), jnp.asarray(starts), jnp.asarray(lens),
        bd, jcfg)[0])
    x = jemb.embed(jparams["embedding"], jnp.asarray(tokens), False)
    empty = jmodel.init_paged_cache(jcfg, 4, num_pages, ps)["groups"][0]
    for layer in range(jcfg.num_layers):
        p = jax.tree_util.tree_map(lambda a: a[layer],
                                   jparams["groups"]["block0"])
        pool0 = {k: v[layer] for k, v in empty.items()}
        q, k, v = layer_qkv(p, x)
        qk = q.reshape(4, 16, 2, 2, 16).transpose(0, 2, 1, 3, 4)
        _, want = jax_ragged(qk, k, v, *(pool0[key] for key in POOL_KEYS),
                             jnp.asarray(table), jnp.asarray(starts),
                             jnp.asarray(lens), block_size=16)
        tpool = [torch.from_numpy(np.array(pool0[key]).view(np.uint8))
                 for key in POOL_KEYS]
        tpool[0] = tpool[0].view(torch.float8_e4m3fn)
        tpool[2] = tpool[2].view(torch.float8_e4m3fn)
        as_t = lambda a: torch.from_numpy(  # noqa: E731
            np.array(a.astype(jnp.float32))).to(torch.bfloat16)
        mx_attention_ragged_fused(
            as_t(qk), as_t(k), as_t(v), *tpool, torch.from_numpy(table),
            torch.from_numpy(starts), torch.from_numpy(lens), block_size=16)
        for got, exp in zip(tpool, want):
            np.testing.assert_array_equal(got.view(torch.uint8).numpy(),
                                          np.asarray(exp).view(np.uint8))
        if layer == 0:
            full = {key: leaf[0] for key, leaf in stepped["groups"][0].items()}
            for got, exp in zip(tpool, _pool_bytes(full)):
                np.testing.assert_array_equal(got.view(torch.uint8).numpy(),
                                              exp)
        x = block(p, x, pool0)


def test_tiered_ragged_step_matches_reference():
    """A tiered cache (full-width uint8 rows, per-page format ids shared by
    both layers): the first step prefills fp8 pages; then the pages the
    second step only reads are repacked to fp6 e3m2 and fp4 e2m1, each
    package by its own repack, and the second step runs over the mixed
    pool. Layer 0's pool bytes must be identical (its K/V come from the
    same embeddings); beyond it, the bars above: logits within one bf16
    ulp with the same argmax, at most CODE_FRACTION of the pool bytes
    differing. Measured on the first test's inputs (used here): none.
    With PRNGKey(2) instead, 7 of 7,072 layer-1 bytes and the logits
    move by one ulp: the two attention paths sum f32 products in
    another order, and a flipped bf16 rounding of one layer's output
    carries into the next layer's K/V codes."""
    from repro.kernels import mx_repack_pages as jax_repack
    from repro_torch.kernels import mx_repack_pages

    jcfg, tcfg = serving_configs()
    jparams, _ = jmodel.init(jax.random.PRNGKey(0), jcfg)
    tparams = port_params(jparams, tcfg)
    num_pages, ps = 13, 4
    mixed = ("fp8_e4m3", "fp6_e3m2", "fp4_e2m1")
    jcache = jmodel.init_paged_cache(jcfg, 4, num_pages, ps, tiered=True)
    tcache = tmodel.init_paged_cache(tcfg, num_pages, ps, "cpu", tiered=True)
    step = jax.jit(lambda p, c, f, *a: jmodel.ragged_step_paged(
        p, jcfg, c, *a, page_fmts=f, mixed_fmts=mixed))
    rng = np.random.default_rng(0)
    table, steps = _steps()
    fmts = np.zeros((num_pages,), np.int32)
    # resident in the second step: rows 0 and 1's pages before their
    # write windows (row 2 writes its only page)
    narrow = {"fp6_e3m2": [0, 2, 5], "fp4_e2m1": [1, 3, 4]}
    for n, meta in enumerate(steps):
        if n == 1:
            groups = dict(jcache["groups"][0])
            for dst, ids in narrow.items():
                ids_j = jnp.asarray(ids, jnp.int32)
                src = jnp.asarray(fmts[ids])
                for layer in range(jcfg.num_layers):
                    out = jax_repack(*(groups[k][layer] for k in POOL_KEYS),
                                     ids_j, src, len(ids), dst_fmt_name=dst,
                                     mixed_fmts=mixed, block_size=16)
                    groups = {k: groups[k].at[layer].set(o)
                              for k, o in zip(POOL_KEYS, out)}
                for pool in tcache:
                    mx_repack_pages(*(pool[k] for k in POOL_KEYS),
                                    torch.tensor(ids), torch.tensor(fmts[ids]),
                                    len(ids), dst_fmt_name=dst,
                                    mixed_fmts=mixed, block_size=16)
                fmts[ids] = {"fp6_e3m2": 2, "fp4_e2m1": 4}[dst]
            jcache = dict(jcache, groups=(groups,))
        tokens = rng.integers(0, tcfg.vocab_size, (4, 16)).astype(np.int32)
        args = [tokens, table] + [np.asarray(meta[k], np.int32)
                                  for k in ("starts", "lens", "lidx")]
        want, jcache = step(jparams, jcache, jnp.asarray(fmts),
                            *map(jnp.asarray, args))
        got = tmodel.ragged_step_paged(
            tparams, tcfg, tcache, *(torch.from_numpy(a) for a in args),
            page_fmts=torch.from_numpy(fmts), mixed_fmts=mixed)
        want = np.asarray(want)[:3, 0]  # row 3 is inactive
        got = got.numpy()[:3]
        tol = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
        np.testing.assert_allclose(got, want, rtol=0, atol=tol)
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
        differing = total = 0
        for layer, tpool in enumerate(tcache):
            jpool = {k: v[layer] for k, v in jcache["groups"][0].items()}
            for g, w in zip(_pool_bytes({k: t.numpy()
                                         for k, t in tpool.items()}),
                            _pool_bytes(jpool)):
                if layer == 0:  # same inputs: the write is exact
                    np.testing.assert_array_equal(g, w)
                differing += int((g != w).sum())
                total += g.size
        assert differing / total <= CODE_FRACTION, (differing, total)
    assert tcache[0]["k_elems"].dtype == torch.uint8


def test_ragged_step_at_granite_head_dim_matches_reference(monkeypatch):
    """RoPE at a real width: one layer at granite-8b's head_dim 128 and
    theta 1e7, eight rows of 16 new tokens, four across position 64 and
    four across 180 (where f32 ``pow`` frequencies round a cos and a sin
    to another bf16 value). The bar above holds and every pool byte
    equals the reference's; the control: on the port's earlier
    frequencies the K page bytes differ, which head_dim 16 cannot show."""
    shape = dict(d_model=256, num_groups=1, num_heads=16, num_kv_heads=8,
                 head_dim=128, d_ff=256)
    jcfg, tcfg = serving_configs()
    jcfg = jcfg.replace(**shape, quant=jcfg.quant.replace(block_size=32))
    tcfg = tcfg.replace(**shape, quant=tcfg.quant.replace(block_size=32))
    assert jcfg.rope_theta == tcfg.rope_theta == 1e7
    jparams, _ = jmodel.init(jax.random.PRNGKey(3), jcfg)
    tparams = port_params(jparams, tcfg)
    w = ps = 16
    starts = np.array([64] * 4 + [165, 170, 176, 180], np.int32)
    pmax = -(-(int(starts.max()) + w) // ps)
    table = np.arange(8 * pmax, dtype=np.int32).reshape(8, pmax)
    num_pages = 8 * pmax + 1  # and the trash page
    tokens = np.random.default_rng(3).integers(
        0, tcfg.vocab_size, (8, w)).astype(np.int32)
    args = [tokens, table, starts, starts + w, np.full(8, w - 1, np.int32)]
    jcache = jmodel.init_paged_cache(jcfg, 8, num_pages, ps)
    want, jcache = jax.jit(lambda p, c, *a: jmodel.ragged_step_paged(
        p, jcfg, c, *a))(jparams, jcache, *map(jnp.asarray, args))
    want = np.asarray(want)[:, 0]
    want_pools = _pool_bytes({k: v[0] for k, v in
                              jcache["groups"][0].items()})

    def port_step():
        tcache = tmodel.init_paged_cache(tcfg, num_pages, ps, "cpu")
        got = tmodel.ragged_step_paged(tparams, tcfg, tcache,
                                       *(torch.from_numpy(a) for a in args))
        return got.numpy(), _pool_bytes({k: t.view(torch.uint8).numpy()
                                         for k, t in tcache[0].items()})

    got, pools = port_step()
    tol = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    for g, w_ in zip(pools, want_pools):
        np.testing.assert_array_equal(g, w_)

    def old_freqs(head_dim, theta):
        exponent = 2.0 * torch.arange(head_dim // 2,
                                      dtype=torch.float32) / head_dim
        return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32),
                               exponent)

    rotary.rope_table.cache_clear()
    monkeypatch.setattr(rotary, "rope_freqs", old_freqs)
    try:
        _, old_pools = port_step()
    finally:
        rotary.rope_table.cache_clear()
    assert (old_pools[0] != want_pools[0]).sum() > 0
