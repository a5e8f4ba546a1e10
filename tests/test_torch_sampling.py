"""The port's sampler (``repro_torch.serve.sampling``) against the
reference's ``repro.serve.sampling`` on the CPU.

Bars:
  * the threefry part equals jax 0.9.0 bit for bit: ``PRNGKey``,
    ``fold_in``, 32-bit ``bits`` and ``uniform`` (plain and on [tiny, 1)),
    seeds 0, 1, 2^31 - 1 and 2^32 - 1, counters 0-1,000, shapes (1,),
    (8, 5) and (49152,);
  * ``filter_logits`` keeps the reference's sets on rows full of ties;
    a row may differ only where an exclusive prefix mass lies within
    BOUNDARY_ULPS f32 ulps of ``top_p`` (torch's softmax and cumsum sum in
    another order than XLA's), and such rows are counted and must be few;
  * ``sample`` and ``verify_rejection`` give the reference's tokens,
    counts and emitted rows at (8, 49152) and (8, 5, 49152), temperatures
    0, 0.7 and 1.3. The float part (log, softmax) may differ by ulps, so
    each test measures that difference and asserts that every decision's
    margin (the winning perturbed score's lead, |u - p(draft)| / p(draft))
    exceeds MARGIN_FACTOR times it;
  * the reference's frozen chi-square checks (``tests/test_sampling.py``)
    hold for the port.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.serve import sampling as R  # noqa: E402
from repro_torch.serve import sampling as S  # noqa: E402

SEEDS = [0, 1, 2 ** 31 - 1, 2 ** 32 - 1]
COUNTERS = np.arange(1001, dtype=np.int32)
VOCAB = 49152
#: a decision's margin must exceed this many times the measured error of
#: the float part that feeds it
MARGIN_FACTOR = 4
#: top-p decisions within this many f32 ulps of p may differ
BOUNDARY_ULPS = 4
TINY = float(np.finfo(np.float32).tiny)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The models here are small: one intra-op thread a process is as
    fast alone and keeps parallel test workers from oversubscribing the
    host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _raw(key) -> np.ndarray:
    return np.asarray(key).astype(np.int64)


def _vec(n, temps=1.0, top_ps=1.0, top_ks=0, seeds=0, counters=0):
    """Per-row parameter vectors as numpy arrays (reference dtypes)."""
    def arr(x, dt):
        return np.full((n,), x, dt) if np.isscalar(x) else np.asarray(x, dt)
    return (arr(temps, np.float32), arr(top_ps, np.float32),
            arr(top_ks, np.int32), arr(seeds, np.uint32),
            arr(counters, np.int32))


def _t(vecs):
    """The same vectors as the port's tensors (seeds as int64 words)."""
    return tuple(torch.from_numpy(v.astype(np.int64) if v.dtype == np.uint32
                                  else v) for v in vecs)


# ---------------------------------------------------------------------------
# the threefry streams, bit for bit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("host", [False, True], ids=["tensor", "numpy"])
@pytest.mark.parametrize("seed", SEEDS)
def test_keys_and_fold_in_equal_jax(seed, host):
    """On tensors and on numpy arrays (the engine's keys, made on the
    host)."""
    jkey = jax.random.PRNGKey(np.uint32(seed))
    seeds = np.full(len(COUNTERS), seed, np.uint32)
    tkeys = S.prng_key(seeds if host else torch.from_numpy(
        seeds.astype(np.int64)))
    assert isinstance(tkeys, np.ndarray) == host

    def arr(x):
        return x if host else x.numpy()
    np.testing.assert_array_equal(arr(tkeys)[0], _raw(jkey))
    want = _raw(jax.vmap(lambda c: jax.random.fold_in(jkey, c))(COUNTERS))
    got = S.fold_in(tkeys, COUNTERS if host else torch.from_numpy(COUNTERS))
    np.testing.assert_array_equal(arr(got), want)
    # the engine's key chain: fold_in(fold_in(PRNGKey(seed), counter), salt)
    want = _raw(jax.vmap(lambda c: jax.random.fold_in(jax.random.fold_in(
        jkey, c), 3))(COUNTERS))
    np.testing.assert_array_equal(arr(S.fold_in(got, 3)), want)
    np.testing.assert_array_equal(S._base_keys(seeds, COUNTERS),
                                  arr(got))


@pytest.mark.parametrize("shape", [(1,), (8, 5), (VOCAB,)])
@pytest.mark.parametrize("seed", SEEDS)
def test_bits_and_uniform_equal_jax(seed, shape):
    """Bits and uniforms under every counter's key (four counters at the
    vocab-wide shape); the uniforms compared as f32 bit patterns."""
    ctrs = COUNTERS if shape != (VOCAB,) else \
        np.asarray([0, 1, 500, 1000], np.int32)
    jkeys = jax.vmap(lambda c: jax.random.fold_in(
        jax.random.PRNGKey(np.uint32(seed)), c))(ctrs)
    tkeys = torch.from_numpy(_raw(jkeys))
    want_bits = np.asarray(jax.vmap(lambda k: jax.random.bits(k, shape))(
        jkeys)).astype(np.int64)
    np.testing.assert_array_equal(S.random_bits(tkeys, shape).numpy(),
                                  want_bits)
    for lo in (0.0, TINY):
        want = np.asarray(jax.vmap(lambda k, lo=lo: jax.random.uniform(
            k, shape, minval=lo, maxval=1.0))(jkeys))
        got = S.uniform(tkeys, shape, lo, 1.0).numpy()
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32))
    # a scalar draw, as verify_rejection's acceptance test makes one
    want = np.asarray(jax.vmap(jax.random.uniform)(jkeys))
    np.testing.assert_array_equal(S.uniform(tkeys).numpy().view(np.int32),
                                  want.view(np.int32))


# ---------------------------------------------------------------------------
# SamplingParams and seeds
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bad", [
    dict(temperature=-0.1), dict(temperature=float("nan")),
    dict(top_p=0.0), dict(top_p=1.5), dict(top_k=-1), dict(seed="abc")])
def test_sampling_params_validate_rejects(bad):
    with pytest.raises(ValueError):
        S.SamplingParams(**bad).validate()
    with pytest.raises(ValueError):
        R.SamplingParams(**bad).validate()


def test_resolve_seed_equals_reference():
    S.SamplingParams(temperature=0.7).validate()  # T > 0 is served now
    for base in (0, 1, 2 ** 32 - 1, 12345):
        for rid in (0, 1, 7, 10 ** 6):
            assert S.resolve_seed(S.SamplingParams(), base, rid) == \
                R.resolve_seed(R.SamplingParams(), base, rid)
    assert S.resolve_seed(S.SamplingParams(seed=-1), 0, 3) == 2 ** 32 - 1
    assert R.resolve_seed(R.SamplingParams(seed=42), 0, 7) == \
        S.resolve_seed(S.SamplingParams(seed=42), 0, 7) == 42


# ---------------------------------------------------------------------------
# filtering
# ---------------------------------------------------------------------------


def _tied_rows(rng, n=48, v=2000):
    """Logits on a grid of 0.25: each row is full of exact ties."""
    return (np.round(rng.normal(size=(n, v)) * 6) / 4).astype(np.float32)


def _edge_tokens(logits, temps, top_ps, top_ks) -> tuple:
    """(N, V) mask of the top-k survivors whose exclusive prefix mass lies
    within BOUNDARY_ULPS f32 ulps of top_p (torch's masses), and (N, V)
    probabilities, both in vocab order."""
    x = torch.from_numpy(logits) / torch.from_numpy(temps)[:, None]
    order = torch.argsort(-x, dim=-1, stable=True)
    k = torch.from_numpy(top_ks.astype(np.int64))[:, None]
    ranks = torch.arange(x.shape[1])[None]
    survive = (k <= 0) | (ranks < k)
    keep = torch.empty_like(survive).scatter_(-1, order, survive)
    p = torch.take_along_dim(torch.softmax(torch.where(keep, x, -torch.inf),
                                           dim=-1), order, dim=-1)
    excl = (torch.cumsum(p, dim=-1) - p).numpy()
    ulp = np.spacing(top_ps.astype(np.float32))[:, None]
    band = survive.numpy() & (np.abs(excl - top_ps[:, None])
                              <= BOUNDARY_ULPS * ulp)
    out_band, out_p = np.zeros_like(band), np.zeros(band.shape, np.float32)
    np.put_along_axis(out_band, order.numpy(), band, axis=-1)
    np.put_along_axis(out_p, order.numpy(), p.numpy(), axis=-1)
    return out_band, out_p


@pytest.mark.parametrize("top_k", [0, 1, 50])
@pytest.mark.parametrize("top_p", [0.05, 0.9, 1.0])
def test_filter_logits_keeps_the_reference_sets(top_p, top_k):
    """Kept sets equal the reference's except at the top-p edge, where the
    two sums may part: every differing token must lie there, edge tokens
    must be few (below p = 1 at most one a row, in at most two rows; at
    p = 1 the edge is the tail whose prefix mass rounds to within a few
    ulps of 1), and the mass of the differing ones a few ulps of p."""
    rng = np.random.default_rng(int(top_p * 100) + top_k)
    logits = _tied_rows(rng)
    n, v = logits.shape
    temps, tps, tks, _, _ = _vec(n, temps=rng.choice([0.0, 0.7, 1.3], n),
                                 top_ps=top_p, top_ks=top_k)
    want = np.isfinite(np.asarray(R.filter_logits(
        jnp.asarray(logits), temps, tps, tks)))
    got = S.filter_logits(torch.from_numpy(logits), *_t((temps, tps, tks)))
    got_keep = np.isfinite(got.numpy())
    differ = want != got_keep
    safe_t = np.where(temps > 0, temps, 1).astype(np.float32)
    edge, probs = _edge_tokens(logits, safe_t, tps, tks)
    assert not (differ & ~edge).any(), np.argwhere(differ & ~edge)
    if top_p < 1:  # one edge token a row at most, in few rows
        assert edge.any(axis=1).sum() <= 2 and edge.sum(axis=1).max() <= 1
    assert edge.sum() <= 0.01 * n * v, f"{edge.sum()} edge tokens"
    assert (np.where(differ, probs, 0).sum(axis=1)
            <= 2 * BOUNDARY_ULPS * np.spacing(np.float32(top_p))).all()
    # the kept logits themselves are the scaled ones, bit for bit
    kept = want & got_keep
    np.testing.assert_array_equal(
        got.numpy()[kept], (logits / safe_t[:, None])[kept])
    if top_k:
        assert (got_keep.sum(axis=1) <= top_k).all()


def test_filter_semantics():
    """The reference test's cases: top-k keeps the k largest, top-p the
    smallest covering prefix, temperature scales."""
    logits = torch.tensor([[3.0, 1.0, 4.0, 1.5, 9.0, 2.6, 5.0, 3.5]])
    t, p, k, _, _ = _t(_vec(1, top_ks=3))
    keep = torch.isfinite(S.filter_logits(logits, t, p, k))[0]
    assert set(torch.nonzero(keep).flatten().tolist()) == {4, 6, 2}
    logits = torch.log(torch.tensor([[0.4, 0.3, 0.2, 0.1]]))
    t, p, k, _, _ = _t(_vec(1, top_ps=0.6))
    keep = torch.isfinite(S.filter_logits(logits, t, p, k))[0]
    assert set(torch.nonzero(keep).flatten().tolist()) == {0, 1}
    t, p, k, _, _ = _t(_vec(1, temps=2.0))
    out = S.filter_logits(torch.tensor([[2.0, 0.0, -1.0]]), t, p, k)
    np.testing.assert_allclose(out.numpy(), [[1.0, 0.0, -0.5]], rtol=1e-6)


# ---------------------------------------------------------------------------
# sample and verify_rejection against the reference
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jitted():
    return jax.jit(R.sample), jax.jit(R.verify_rejection)


FILTERS = {"plain": (1.0, 0), "nucleus-topk": (0.9, 50)}


def _params(rng, n, temp, name):
    top_p, top_k = FILTERS[name]
    return _vec(n, temps=temp, top_ps=top_p, top_ks=top_k,
                seeds=rng.integers(0, 2 ** 32, n, dtype=np.uint64),
                counters=rng.integers(0, 1000, n))


def _gumbel_jax(keys, v):
    return np.asarray(jax.vmap(lambda k: jax.random.gumbel(k, (v,)))(
        jnp.asarray(keys.numpy().astype(np.uint32))))


@pytest.mark.parametrize("name", sorted(FILTERS))
@pytest.mark.parametrize("temp", [0.0, 0.7, 1.3])
def test_sample_equals_reference(jitted, temp, name):
    rng = np.random.default_rng(int(temp * 10) + len(name))
    n = 8
    logits = (rng.normal(size=(n, VOCAB)) * 3).astype(np.float32)
    vecs = _params(rng, n, temp, name)
    want = np.asarray(jitted[0](jnp.asarray(logits), *vecs))
    tvecs = _t(vecs)
    got, lead = S.sample(torch.from_numpy(logits), *tvecs, with_lead=True)
    np.testing.assert_array_equal(got.numpy(), want)
    if temp == 0:
        np.testing.assert_array_equal(want, logits.argmax(-1))
        assert torch.isinf(lead).all()
        return
    # the perturbed scores' error: torch's log against XLA's on the same
    # uniforms (the filtered logits are the same f32 quotients)
    keys = torch.from_numpy(S.fold_in(S._base_keys(tvecs[3], tvecs[4]),
                                      S._SALT_SAMPLE))
    err = np.abs(S.gumbel(keys, (VOCAB,)).numpy()
                 - _gumbel_jax(keys, VOCAB)).max()
    assert 0 < err < 1e-5
    finite = torch.isfinite(lead)
    assert float(lead[finite].min()) > MARGIN_FACTOR * 2 * err


def _drafts(rng, logits):
    """Drafts equal to each row's argmax targets, with every other row's
    second draft replaced at random: accept counts vary at T 0."""
    d = logits[:, :-1].argmax(-1).astype(np.int32)
    d[::2, 1] = rng.integers(0, logits.shape[-1], d[::2, 1].shape)
    return d


@pytest.mark.parametrize("name", sorted(FILTERS))
@pytest.mark.parametrize("temp", [0.0, 0.7, 1.3])
def test_verify_rejection_equals_reference(jitted, temp, name):
    rng = np.random.default_rng(100 + int(temp * 10) + len(name))
    n, t = 8, 5
    logits = (rng.normal(size=(n, t, VOCAB)) * 3).astype(np.float32)
    # sharpen row 0 of half the rows so that some drafts are accepted at
    # T > 0 and the bonus draw runs
    logits[1::2, :, :] *= 4
    drafts = _drafts(rng, logits)
    vecs = _params(rng, n, temp, name)
    wn, we = jitted[1](jnp.asarray(logits), jnp.asarray(drafts), *vecs)
    wn, we = np.asarray(wn), np.asarray(we)
    tvecs = _t(vecs)
    gn, ge, (gap, lead) = S.verify_rejection(
        torch.from_numpy(logits), torch.from_numpy(drafts), *tvecs,
        margins=True)
    np.testing.assert_array_equal(gn.numpy(), wn)
    for i in range(n):
        np.testing.assert_array_equal(ge[i, :wn[i]].numpy(), we[i, :wn[i]])
    if temp == 0:
        assert set(wn[::2]) == {2} and set(wn[1::2]) == {5}
        return
    # the acceptance tests' error: torch's softmax against XLA's on the
    # same filtered rows, relative to each draft's probability (the
    # margins are |u - p| / p)
    lf = logits.reshape(n * t, VOCAB)
    rep = [np.repeat(v, t) for v in vecs[:3]]
    jf = R.filter_logits(jnp.asarray(lf), *rep)
    p_want = np.asarray(jax.nn.softmax(jf, axis=-1)).reshape(n, t, VOCAB)
    p_got = torch.softmax(S.filter_logits(torch.from_numpy(lf), *_t(rep)),
                          dim=-1).numpy().reshape(n, t, VOCAB)
    d = drafts[..., None]
    pg = np.take_along_axis(p_got[:, :-1], d, -1)[..., 0]
    pw = np.take_along_axis(p_want[:, :-1], d, -1)[..., 0]
    live = pw > 0
    err_p = (np.abs(pg - pw)[live] / pw[live]).max()
    counted = np.arange(t - 1)[None] < np.minimum(wn, t - 1)[:, None]
    assert float(gap.numpy()[counted].min()) > MARGIN_FACTOR * max(
        err_p, np.spacing(np.float32(1)))
    # the final draw's error: the reference's residual and gumbel against
    # the port's, on the rows and keys the port drew with
    acc = wn - 1
    rows = np.arange(n)
    base = torch.from_numpy(S._base_keys(tvecs[3], tvecs[4]))
    keys = S.fold_in(S.fold_in(base, torch.from_numpy(acc)),
                     S._SALT_RESIDUAL)
    dpad = np.concatenate([drafts, np.zeros((n, 1), np.int32)], 1)
    jres = np.asarray(R._remove_and_renorm(
        jnp.asarray(p_want[rows, acc]), jnp.asarray(dpad[rows, acc]),
        jnp.asarray(acc < t - 1)))
    tres = S._remove_and_renorm(torch.from_numpy(p_got[rows, acc]),
                                torch.from_numpy(dpad[rows, acc]),
                                torch.from_numpy(acc < t - 1)).numpy()
    live = (jres > 0) & (tres > 0)
    err = np.abs(np.log(tres[live]) - np.log(jres[live])).max() + np.abs(
        S.gumbel(keys, (VOCAB,)).numpy() - _gumbel_jax(keys, VOCAB)).max()
    assert float(lead.min()) > MARGIN_FACTOR * 2 * err


def test_greedy_rows_are_exact_argmax_and_prefix_match():
    rng = np.random.default_rng(0)
    logits = torch.from_numpy(rng.normal(size=(16, 33)).astype(np.float32))
    vecs = _t(_vec(16, temps=0.0, seeds=np.arange(16)))
    np.testing.assert_array_equal(S.sample(logits, *vecs).numpy(),
                                  logits.argmax(-1).numpy())
    logits = rng.normal(size=(8, 4, 11)).astype(np.float32)
    targets = logits.argmax(-1)
    drafts = targets[:, :3].copy()
    drafts[::2, 1] ^= 1
    n_emit, emitted = S.verify_rejection(
        torch.from_numpy(logits), torch.from_numpy(drafts),
        *_t(_vec(8, temps=0.0, seeds=np.arange(8))))
    np.testing.assert_array_equal(n_emit[::2].numpy(), 2)
    np.testing.assert_array_equal(n_emit[1::2].numpy(), 4)
    for i in range(8):
        np.testing.assert_array_equal(emitted[i, :n_emit[i]].numpy(),
                                      targets[i, :n_emit[i]])


def test_sample_is_pure_function_of_seed_and_counter():
    rng = np.random.default_rng(1)
    row = rng.normal(size=(1, 17)).astype(np.float32)
    noise = rng.normal(size=(7, 17)).astype(np.float32)

    def tok_at(batch_pos, n, seed, ctr):
        logits = np.concatenate([noise[:batch_pos], row,
                                 noise[batch_pos:n - 1]], axis=0)
        seeds = np.arange(100, 100 + n)
        seeds[batch_pos] = seed
        ctrs = np.full(n, 9)
        ctrs[batch_pos] = ctr
        vecs = _t(_vec(n, temps=0.8, top_ps=0.9, seeds=seeds,
                       counters=ctrs))
        return int(S.sample(torch.from_numpy(logits), *vecs)[batch_pos])

    want = tok_at(0, 1, seed=7, ctr=3)
    assert tok_at(0, 4, seed=7, ctr=3) == want
    assert tok_at(2, 5, seed=7, ctr=3) == want
    assert tok_at(7, 8, seed=7, ctr=3) == want
    assert len({tok_at(0, 1, seed=7, ctr=i) for i in range(32)}) > 1


# ---------------------------------------------------------------------------
# distributions: the reference's frozen chi-square checks, on the port
# ---------------------------------------------------------------------------

_PROBS = np.asarray([0.30, 0.22, 0.16, 0.12, 0.08, 0.06, 0.04, 0.02])


def _chi2_crit(df, z=3.0902):
    """Wilson-Hilferty chi-square critical value (alpha ~= 1e-3)."""
    return df * (1 - 2 / (9 * df) + z * np.sqrt(2 / (9 * df))) ** 3


def _target_dist(temps, top_ps, top_ks):
    logits = torch.log(torch.tensor(_PROBS, dtype=torch.float32))[None]
    t, p, k, _, _ = _t(_vec(1, temps=temps, top_ps=top_ps, top_ks=top_ks))
    return torch.softmax(S.filter_logits(logits, t, p, k)[0], -1).numpy()


def _chisq_gof(counts, expected_probs, n):
    support = expected_probs > 0
    assert counts[~support].sum() == 0, "mass outside the filtered support"
    exp = expected_probs[support] * n
    stat = float((((counts[support] - exp) ** 2) / exp).sum())
    return stat, _chi2_crit(int(support.sum()) - 1)


def test_sample_matches_filtered_distribution():
    n = 4000
    temps, top_ps, top_ks = 0.9, 0.92, 6
    logits = torch.log(torch.tensor(_PROBS, dtype=torch.float32)).repeat(n, 1)
    vecs = _t(_vec(n, temps=temps, top_ps=top_ps, top_ks=top_ks,
                   seeds=np.arange(n)))
    toks = S.sample(logits, *vecs).numpy()
    counts = np.bincount(toks, minlength=len(_PROBS)).astype(np.float64)
    stat, crit = _chisq_gof(counts, _target_dist(temps, top_ps, top_ks), n)
    assert stat < crit, (stat, crit)


def test_rejection_verification_is_lossless():
    """The first emitted token's marginal equals plain filtered sampling
    for any draft, inside or outside the filtered support."""
    n = 4000
    temps, top_ps, top_ks = 0.9, 0.92, 6
    v = len(_PROBS)
    row = np.log(_PROBS, dtype=np.float32)
    logits = torch.from_numpy(np.tile(row, (n, 2, 1)))
    drafts = torch.from_numpy((np.arange(n) % v).reshape(n, 1))
    vecs = _t(_vec(n, temps=temps, top_ps=top_ps, top_ks=top_ks,
                   seeds=np.arange(n)))
    n_emit, emitted = S.verify_rejection(logits, drafts, *vecs)
    n_emit, emitted = n_emit.numpy(), emitted.numpy()
    assert set(np.unique(n_emit)) == {1, 2}
    first = emitted[:, 0]
    counts = np.bincount(first, minlength=v).astype(np.float64)
    stat, crit = _chisq_gof(counts, _target_dist(temps, top_ps, top_ks), n)
    assert stat < crit, (stat, crit)
    acc = n_emit == 2
    np.testing.assert_array_equal(first[acc], drafts.numpy()[acc, 0])
    assert not np.any(first[~acc] == drafts.numpy()[~acc, 0])


def _report():
    """Print the float part's measured differences and the decision
    margins of the cases above: ``python tests/test_torch_sampling.py``."""
    rng = np.random.default_rng(0)
    keys = torch.from_numpy(S.fold_in(S.prng_key(np.arange(40)), 7))
    u = S.uniform(keys, (VOCAB,), TINY, 1.0)
    lt, lj = torch.log(u).numpy(), np.asarray(jnp.log(jnp.asarray(
        u.numpy())))
    gt, gj = S.gumbel(keys, (VOCAB,)).numpy(), _gumbel_jax(keys, VOCAB)
    print(f"log of {u.numel()} f32 uniforms: {int((lt != lj).sum())} differ "
          f"(max {np.abs(lt - lj).max():.3g}); gumbel: "
          f"{int((gt != gj).sum())} differ (max {np.abs(gt - gj).max():.3g})")
    x = (rng.normal(size=(8, VOCAB)) * 3).astype(np.float32)
    pt = torch.softmax(torch.from_numpy(x), -1).numpy()
    pj = np.asarray(jax.nn.softmax(jnp.asarray(x), axis=-1))
    ct = torch.cumsum(torch.from_numpy(pt), -1).numpy()
    cj = np.asarray(jnp.cumsum(jnp.asarray(pt), axis=-1))
    print(f"softmax of 8 x {VOCAB}: {int((pt != pj).sum())} differ (max "
          f"relative {np.max(np.abs(pt - pj) / pj):.3g}); cumsum: "
          f"{int((ct != cj).sum())} differ (max {np.abs(ct - cj).max():.3g})")
    jitted = (jax.jit(R.sample), jax.jit(R.verify_rejection))
    for temp in (0.7, 1.3):
        for name in sorted(FILTERS):
            r = np.random.default_rng(int(temp * 10) + len(name))
            logits = (r.normal(size=(8, VOCAB)) * 3).astype(np.float32)
            vecs = _params(r, 8, temp, name)
            same = np.array_equal(np.asarray(jitted[0](jnp.asarray(logits),
                                                        *vecs)),
                                  S.sample(torch.from_numpy(logits),
                                           *_t(vecs)).numpy())
            _, lead = S.sample(torch.from_numpy(logits), *_t(vecs),
                               with_lead=True)
            r = np.random.default_rng(100 + int(temp * 10) + len(name))
            w = (r.normal(size=(8, 5, VOCAB)) * 3).astype(np.float32)
            w[1::2] *= 4
            d = _drafts(r, w)
            vv = _params(r, 8, temp, name)
            n, _, (gap, vlead) = S.verify_rejection(
                torch.from_numpy(w), torch.from_numpy(d), *_t(vv),
                margins=True)
            counted = np.arange(4)[None] < np.minimum(n.numpy(), 4)[:, None]
            print(f"T {temp} {name}: sample tokens equal {same}, smallest "
                  f"lead {float(lead[torch.isfinite(lead)].min()):.4g}; "
                  f"verify: smallest |u - p| / p "
                  f"{float(gap.numpy()[counted].min()):.4g}, smallest final "
                  f"lead {float(vlead.min()):.4g}")


if __name__ == "__main__":
    _report()
