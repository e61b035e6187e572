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
from repro_torch.configs import MoESpec, get_config
from repro_torch.convert import params_from_numpy
from repro_torch.models import transformer

TOLS = {"float32": 1e-4, "bfloat16": 5e-2}
TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "gemma3-4b"])
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
    for name in ("k", "v"):
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


def test_moe_and_mla_configs_are_not_ported_yet():
    base = get_config("tinyllama-1.1b", smoke=True)
    moe = dataclasses.replace(base, moe=MoESpec(n_experts=4, top_k=2, d_ff_expert=32))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        transformer.lm_specs(moe)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        transformer.init_cache(moe, 1, 8, "cpu")
