"""deepseek-v2-lite-16b (MLA, a dense-FFN prologue block, then MoE
blocks of routed and shared experts) in the port against the jitted
reference on the CPU, reduced (d_model 64, 3 layers: the prologue and
two groups of the one-block pattern; 4 experts top-2 and 1 shared), on
the reference's weights carried over by ``model.params_from_jax`` with
RMSNorm scales drawn from N(0, 0.25).

Bars, each measured here:

  * ``params_from_jax`` consumes every leaf of the reference's tree, and
    nothing else: the port's leaves map one to one onto the reference's
    (``wk_b`` / ``wv_b`` carry two forms of one leaf, ``tests/
    test_torch_mla.py``);
  * dense prefill is bit-equal: the hidden state after every block
    (each package's own chain), the logits and the contiguous cache leaf
    by leaf (``{"prologue0", "groups"}``, each a latent cache). This also
    confirms ``model.layer_carries`` on this stack: every block's output
    reaches the next one rounded to bf16 (the unscanned prologue's, and
    the one-block pattern's across scan iterations);
  * decode is held to the one-row bar of ``tests/test_torch_monolithic.
    py`` (DECODE_TOL_ULPS bf16 ulps of the largest logit, the same
    argmax, layer 0's cache bit-equal, at most DECODE_BYTE_FRACTION of
    the cache's bytes apart), each step from the reference's cache;
  * ``FixedSlotEngine``'s greedy streams, dense and sorted dispatch,
    equal the reference's ``FixedSlotEngine``'s, at a weight seed whose
    every pick leads its runner-up by more than GAP_TOL_ULPS (asserted);
  * the launcher serves the reduced model with ``--engine fixed`` on the
    CPU, and its default continuous engine refuses MLA with the
    reference's message.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro import configs as jconfigs  # noqa: E402
from repro.nn import blocks as jblocks  # noqa: E402
from repro.nn import model as jmodel  # noqa: E402
from repro.serve import ContinuousBatchingEngine as JEngine  # noqa: E402
from repro.serve import FixedSlotEngine as JFixed  # noqa: E402
from repro.serve import ServeConfig as JServeConfig  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.launch import serve as tlaunch  # noqa: E402
from repro_torch.nn import blocks as tblocks  # noqa: E402
from repro_torch.nn import model as tmodel  # noqa: E402
from repro_torch.serve import FixedSlotEngine, ServeConfig  # noqa: E402

ARCH = "deepseek-v2-lite-16b"
DECODE_TOL_ULPS = 2
DECODE_BYTE_FRACTION = 0.01
GAP_TOL_ULPS = 1
#: the engine runs' weight seed: every greedy pick of the port's runs
#: leads its runner-up by more than GAP_TOL_ULPS (asserted)
ENGINE_SEED = 2
B, S0, NEW, MAX_SEQ = 3, 19, 8, 40


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pair(seed=0, **over):
    """Both packages' reduced deepseek as the launcher serves it
    (weight-only MX), on the reference's weights."""
    quant = dict(quantize_acts=False, quantize_kv_cache=True)
    jcfg = jconfigs.get_reduced(ARCH)
    tcfg = tconfigs.get_reduced(ARCH)
    jcfg = jcfg.replace(quant=jcfg.quant.replace(**quant), **over)
    tcfg = tcfg.replace(quant=tcfg.quant.replace(**quant), **over)
    jparams, _ = jmodel.init(jax.random.PRNGKey(seed), jcfg)
    rng = np.random.default_rng(seed)

    def scales(path, leaf):
        leaf = np.asarray(leaf)
        if jax.tree_util.keystr(path).endswith("['scale']"):
            leaf = leaf + 0.5 * rng.standard_normal(leaf.shape).astype(
                np.float32)
        return leaf
    jparams = jax.tree_util.tree_map_with_path(scales, jparams)
    return jcfg, jparams, tcfg, tmodel.params_from_jax(jparams, tcfg, "cpu")


def _np(t):
    return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 \
        else t.numpy()


def _jnp(a):
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _to_port(tree):
    if isinstance(tree, dict):
        return {k: _to_port(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_to_port(v) for v in tree)
    a = np.asarray(tree)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _assert_same_tree(jtree, ttree):
    leaves = jax.tree_util.tree_leaves_with_path(jtree)
    assert leaves
    for path, leaf in leaves:
        node = ttree
        for k in path:
            node = node[k.key if hasattr(k, "key") else k.idx]
        np.testing.assert_array_equal(_np(node), _jnp(leaf),
                                      err_msg=jax.tree_util.keystr(path))


@pytest.fixture(scope="module")
def model_pair():
    jcfg, jparams, tcfg, tparams = _pair(0)
    prefill = jax.jit(lambda p, t: jmodel.prefill(p, jcfg, tokens=t,
                                                  max_seq=MAX_SEQ))
    step = jax.jit(lambda p, c, t, pos: jmodel.decode_step(
        p, jcfg, c, tokens=t, pos=pos))
    toks = np.random.default_rng(7).integers(0, 512, (B, S0)).astype(
        np.int32)
    return dict(jcfg=jcfg, jparams=jparams, tcfg=tcfg, tparams=tparams,
                prefill=prefill, step=step, toks=toks)


# ---------------------------------------------------------------------------
# the weights carried across
# ---------------------------------------------------------------------------


def _port_paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _port_paths(v, prefix + (k,))
    else:
        yield prefix


def test_params_from_jax_consumes_every_reference_leaf(model_pair):
    """Layer by layer (the groups' leaves sliced), each reference leaf
    path is a port leaf path and back, ``raw`` counted as its ``w``; the
    stack is not uniform (a dense prologue ahead of MoE blocks), so the
    layers are a list and there is no ``layer_stack``."""
    jcfg, jparams, tcfg, tparams = (model_pair[k] for k in
                                    ("jcfg", "jparams", "tcfg", "tparams"))
    assert "layer_stack" not in tparams and len(tparams["layers"]) == 3
    for (key, g, bd), layer in zip(jmodel.iter_layer_blocks(jcfg),
                                   tparams["layers"]):
        want = {tuple(k.key for k in path) for path, _ in
                jax.tree_util.tree_leaves_with_path(
                    jmodel.layer_params(jparams, key, g))}
        got = [p[:-1] + ("w",) if p[-1] == "raw" else p
               for p in _port_paths(layer)]
        assert set(got) == want, key
        assert set(layer["mixer"]["wk_b"]) == {"w", "raw"}
        assert set(layer["mixer"]["wv_b"]) == {"w", "raw"}
        assert (("ffn", "experts", "gate") in want) == (bd.ffn == "moe")
    assert set(tparams["embedding"]) == set(jparams["embedding"])
    assert set(tparams["final_norm"]) == set(jparams["final_norm"])
    assert set(jparams) == {"embedding", "prologue0", "groups",
                            "final_norm"}


# ---------------------------------------------------------------------------
# prefill and decode over the contiguous latent cache
# ---------------------------------------------------------------------------


def test_prefill_equals_the_jitted_reference_block_by_block(model_pair):
    """Hidden states after each block, logits and the cache, bit for
    bit; the port's carries are all False on this stack."""
    jcfg, jparams, tcfg, tparams, toks = (
        model_pair[k] for k in ("jcfg", "jparams", "tcfg", "tparams",
                                "toks"))
    assert tmodel.layer_carries(tcfg) == [False] * 3
    positions = np.broadcast_to(np.arange(S0, dtype=np.int32), (B, S0))
    jx = jmodel._embed_inputs(jparams, jcfg, jnp.asarray(toks))
    tx = tmodel._embed(tparams, tcfg, torch.from_numpy(toks).long())
    for li, (key, g, bd) in enumerate(jmodel.iter_layer_blocks(jcfg)):
        jfn = jax.jit(functools.partial(jblocks.prefill_block, bd=bd,
                                        cfg=jcfg, max_seq=MAX_SEQ))
        jx, jc = jfn(jmodel.layer_params(jparams, key, g), jx, positions)
        tx, tc = tblocks.prefill_block(
            tparams["layers"][li], tx, torch.from_numpy(positions.copy()),
            tcfg.all_blocks()[li], tcfg, MAX_SEQ)
        tx = tx.to(tcfg.compute_dtype)
        np.testing.assert_array_equal(_np(tx), _jnp(jx),
                                      err_msg=f"block {li}")
        _assert_same_tree(jc, tc)
    jl, jcache = model_pair["prefill"](jparams, toks)
    tl, tcache = tmodel.prefill(tparams, tcfg, torch.from_numpy(toks).long(),
                                max_seq=MAX_SEQ)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl, np.float32))
    _assert_same_tree(jcache, tcache)
    assert set(tcache) == {"prologue0", "groups"}
    assert tcache["groups"][0]["c_kv"].shape == (2, B, MAX_SEQ, 32)


def test_decode_steps_within_the_one_row_bar(model_pair):
    """Five steps, each from the reference's cache of the step before."""
    jparams, tcfg, tparams, toks = (model_pair[k] for k in
                                    ("jparams", "tcfg", "tparams", "toks"))
    jl, jcache = model_pair["prefill"](jparams, toks)
    tok = np.argmax(np.asarray(jl)[:, -1], -1).astype(np.int32)[:, None]
    for i in range(5):
        pos = S0 + i
        tcache = _to_port(jcache)
        jl, jcache = model_pair["step"](jparams, jcache, tok, np.int32(pos))
        tl, tcache = tmodel.decode_step(tparams, tcfg, tcache,
                                        torch.from_numpy(tok).long(), pos)
        want, got = np.asarray(jl, np.float32), tl.numpy()
        tol = DECODE_TOL_ULPS * 2.0 ** (
            np.floor(np.log2(np.abs(want).max())) - 7)
        np.testing.assert_allclose(got, want, rtol=0, atol=tol)
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
        differing = total = 0
        for path, leaf in jax.tree_util.tree_leaves_with_path(jcache):
            node = tcache
            for k in path:
                node = node[k.key if hasattr(k, "key") else k.idx]
            g, w = _np(node), _jnp(leaf)
            if path[0].key == "prologue0":
                np.testing.assert_array_equal(g, w, err_msg="layer 0")
            differing += int((g != w).sum())
            total += g.size
        assert differing <= DECODE_BYTE_FRACTION * total, (differing, total)
        tok = np.argmax(want[:, -1], -1).astype(np.int32)[:, None]


# ---------------------------------------------------------------------------
# FixedSlotEngine and the launcher
# ---------------------------------------------------------------------------


def _leads_ulps(tparams, tcfg, prompts, out) -> float:
    """The smallest lead, in bf16 ulps of the pick's logit, of each greedy
    pick of ``out`` over its runner-up, replaying the stream through the
    port's prefill and decode."""
    toks = torch.from_numpy(out).long()
    logits, cache = tmodel.prefill(tparams, tcfg, toks[:, :S0],
                                   max_seq=MAX_SEQ)
    lead = np.inf
    for i in range(NEW):
        row = logits[:, -1].numpy()
        top2 = np.sort(row, -1)[:, -2:]
        ulp = 2.0 ** (np.floor(np.log2(np.abs(top2[:, 1]))) - 7)
        lead = min(lead, float(((top2[:, 1] - top2[:, 0]) / ulp).min()))
        assert (row.argmax(-1) == out[:, S0 + i]).all()
        if i < NEW - 1:
            logits, cache = tmodel.decode_step(
                tparams, tcfg, cache, toks[:, S0 + i:S0 + i + 1], S0 + i)
    return lead


@pytest.mark.parametrize("dispatch", ["dense", "sorted"])
def test_fixed_slot_engine_streams_equal_the_reference(dispatch):
    jcfg, jparams, tcfg, tparams = _pair(ENGINE_SEED, moe_dispatch=dispatch)
    prompts = np.random.default_rng(5).integers(0, 512, (B, S0)).astype(
        np.int32)
    want = JFixed(jparams, jcfg, JServeConfig(max_seq=MAX_SEQ)).generate(
        prompts, NEW)
    got = FixedSlotEngine(tparams, tcfg, ServeConfig(max_seq=MAX_SEQ),
                          device="cpu").generate(prompts, NEW)
    assert got.shape == (B, S0 + NEW) and got.dtype == np.int32
    np.testing.assert_array_equal(got, np.asarray(want))
    assert _leads_ulps(tparams, tcfg, prompts, got) > GAP_TOL_ULPS


def _reference_refusal() -> str:
    jcfg, jparams, _, _ = _pair(0)
    with pytest.raises(NotImplementedError) as err:
        JEngine(jparams, jcfg, JServeConfig(max_seq=MAX_SEQ))
    return str(err.value)


def test_launcher_serves_fixed_and_refuses_continuous():
    """``--engine fixed`` serves the reduced model on the CPU; the default
    continuous engine raises the reference engine's message, string for
    string."""
    argv = ["--arch", ARCH, "--reduced", "--batch", "2", "--prompt-len",
            "8", "--new-tokens", "4", "--device", "cpu"]
    report = tlaunch.main(argv + ["--engine", "fixed"])
    assert report["out"].shape == (2, 12)
    np.testing.assert_array_equal(report["out"][:, :8], report["prompts"])
    want = _reference_refusal()
    assert want == ("continuous batching does not support mixers {'mla'} "
                    "— use FixedSlotEngine (launch/serve.py --engine fixed)")
    with pytest.raises(NotImplementedError) as err:
        tlaunch.main(argv)
    assert str(err.value) == want
