"""The port's cached transformer (``prefill_chunk`` then ``decode_step``)
against the reference package, on the same converted parameters.

Tolerances: fp32 1e-4 absolute and relative, because the two frameworks
take the same sums in another order (matmul blocking, the layer loop vs
``lax.scan``) and the differences grow through the layers.  bf16 5e-2 of the
largest reference logit of the step: XLA on the CPU keeps excess precision
inside its fusions where torch rounds each op to bf16, and a rounding
difference in the hidden state moves every logit by an amount that scales
with the logits, not with each logit's own size.  On these smoke models
either framework's bf16 logits lie up to 0.3 from its own fp32 logits."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax
import jax.numpy as jnp

from repro.configs import get_config as jax_config
from repro.models import transformer as jax_tf
from repro.models.layers import init_params as jax_init
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.models import transformer

TOLS = {"float32": 1e-4, "bfloat16": 5e-2}
# every LM architecture both packages register: dense GQA (tinyllama, gemma3's
# local:global layers), dense MHA (deepseek-7b), MoE (qwen2-moe) and MLA + MoE
# (deepseek-v2)
LM_ARCHS = ["tinyllama-1.1b", "gemma3-4b", "deepseek-7b", "qwen2-moe-a2.7b", "deepseek-v2-236b"]
TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.mark.parametrize("arch", LM_ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_then_decode_matches_reference(arch, dtype):
    jcfg = dataclasses.replace(jax_config(arch, smoke=True), dtype=getattr(jnp, dtype))
    tcfg = dataclasses.replace(get_config(arch, smoke=True), dtype=TORCH_DTYPE[dtype])
    jp = jax_init(jax.random.PRNGKey(0), jax_tf.lm_specs(jcfg), jcfg.dtype)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")

    B, T, c = 2, 40, 8
    rng = np.random.default_rng(0)
    start = np.array([0, 3], np.int32)  # per-sequence positions
    jcache = jax_tf.init_cache(jcfg, B, T)
    tcache = transformer.init_cache(tcfg, B, T, "cpu")
    jlen, tlen = jnp.asarray(start), torch.from_numpy(start)
    tol = TOLS[dtype]
    # three chunks (past gemma3-smoke's window of 8), then three decode steps
    steps = [("prefill", rng.integers(0, jcfg.vocab, size=(B, c))) for _ in range(3)]
    steps += [("decode", rng.integers(0, jcfg.vocab, size=(B, 1))) for _ in range(3)]
    for kind, toks in steps:
        jfn = jax_tf.prefill_chunk if kind == "prefill" else jax_tf.decode_step
        tfn = transformer.prefill_chunk if kind == "prefill" else transformer.decode_step
        jlog, jcache, jlen = jfn(jp, jcfg, jnp.asarray(toks, jnp.int32), jcache, jlen)
        tlog, tcache, tlen = tfn(tp, tcfg, torch.from_numpy(toks), tcache, tlen)
        assert tlog.dtype == torch.float32 and tlog.shape == (B, jcfg.vocab)
        want = np.asarray(jlog)
        if dtype == "float32":
            np.testing.assert_allclose(tlog.numpy(), want, atol=tol, rtol=tol)
        else:
            assert np.abs(tlog.numpy() - want).max() <= tol * np.abs(want).max()
        np.testing.assert_array_equal(tlen.numpy(), np.asarray(jlen))
    assert sorted(tcache) == sorted(jcache)
    for name in jcache:
        got, want = tcache[name].float().numpy(), np.asarray(jcache[name], np.float32)
        if dtype == "float32":
            np.testing.assert_allclose(got, want, atol=tol, rtol=tol)
        else:
            assert np.abs(got - want).max() <= tol * np.abs(want).max()


def test_layer_flags_match_reference():
    for arch in ("tinyllama-1.1b", "gemma3-4b"):
        for smoke in (True, False):
            np.testing.assert_array_equal(
                transformer.layer_flags(get_config(arch, smoke=smoke)),
                jax_tf.layer_flags(jax_config(arch, smoke=smoke)),
            )


def _spec_tree(tree):
    """A spec tree as plain values: {path: (shape, axes, init, scale)}."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update({f"{k}/{p}": s for p, s in _spec_tree(v).items()})
        return out
    return {"": (tuple(tree.shape), tuple(tree.axes), tree.init, tree.scale)}


@pytest.mark.parametrize("arch", LM_ARCHS)
@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
def test_lm_specs_match_reference(arch, smoke):
    """The port's spec tree is the reference's, leaf for leaf: names,
    shapes, logical axes (the fan-in of a normal init is the second-last
    axis in both packages), init and scale; built from the configs alone,
    with nothing allocated."""
    tcfg, jcfg = get_config(arch, smoke=smoke), jax_config(arch, smoke=smoke)
    assert tcfg.name == jcfg.name and (tcfg.moe is None) == (jcfg.moe is None)
    assert (tcfg.mla is None) == (jcfg.mla is None)
    assert _spec_tree(transformer.lm_specs(tcfg)) == _spec_tree(jax_tf.lm_specs(jcfg))


def test_gemma3_head_dim_256_forward_matches_reference():
    """gemma3-smoke's depth and widths with gemma3-4b's head dim of 256 (the
    full-width model's attention shape per head, two query heads a KV head,
    local and global layers): ``forward`` and ``prefill`` against the
    reference's in fp32, from the same converted parameters.

    Tolerance: 1e-4 of the largest reference value of each output (the rule
    ``tests/test_torch_train.py`` holds gradients to).  The reference's init
    draws a projection at 1/sqrt of its head axis, so at this head dim the
    cached K/V values reach about 25 and the scores have a spread of tens:
    the softmax is nearly an argmax, and one fp32 rounding of a score, taken
    in another order, moves the outputs by an amount that scales with the
    layer's values (here up to 2.4e-4 of logits that reach 4.3)."""
    over = dict(d_head=256)
    jcfg = dataclasses.replace(jax_config("gemma3-4b", smoke=True), dtype=jnp.float32, **over)
    tcfg = dataclasses.replace(get_config("gemma3-4b", smoke=True), dtype=torch.float32, **over)
    assert tcfg.head_dim == 256 and tcfg.n_heads // tcfg.n_kv_heads == 2
    jp = jax_init(jax.random.PRNGKey(4), jax_tf.lm_specs(jcfg), jcfg.dtype)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    toks = np.random.default_rng(4).integers(0, jcfg.vocab, size=(2, 20)).astype(np.int32)

    def close(got, want):
        want = np.asarray(want, np.float32)
        assert got.shape == want.shape
        assert np.abs(got.numpy() - want).max() <= TOLS["float32"] * np.abs(want).max()

    want, _ = jax_tf.forward(jp, jcfg, jnp.asarray(toks))  # 20 > the window of 8
    got, _ = transformer.forward(tp, tcfg, torch.from_numpy(toks))
    close(got, want)
    jl, jc, _ = jax_tf.prefill(jp, jcfg, jnp.asarray(toks))
    tl, tc, _ = transformer.prefill(tp, tcfg, torch.from_numpy(toks))
    close(tl, jl)
    for name in ("k", "v"):
        assert tc[name].shape == (tcfg.n_layers, 2, 20, tcfg.n_kv_heads, 256)
        close(tc[name], jc[name])
