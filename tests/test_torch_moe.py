"""The port's MoE FFN (``repro_torch.models.moe``) against the reference's
``repro.models.moe``, on the CPU, from the same seeded numpy inputs.

``moe_ffn`` with and without shared experts, over one group and several,
with capacity drops that each case asserts happen (or not), and at the
decode shapes (B*S = 1 and 2); the routing (expert ids and capacity slots)
where router probabilities tie exactly, where the k order of equal
probabilities decides which tokens an expert drops; and
``aux_load_balance_loss``.

Tolerances: fp32 2e-5 absolute and relative (``tests/test_kernels.py``'s, a
single layer); bf16 5e-2 of the largest reference value, as
``tests/test_torch_transformer.py`` holds bf16 (XLA keeps excess precision
inside its fusions where torch rounds each op to bf16)."""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax
import jax.numpy as jnp

from repro.configs.base import MoESpec as JaxMoESpec
from repro.models import moe as jax_moe
from repro.models.layers import init_params as jax_init
from repro_torch.configs import MoESpec
from repro_torch.convert import params_from_numpy
from repro_torch.models import moe

TOLS = {"float32": 2e-5, "bfloat16": 5e-2}
TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _dims(E, K, shared, d, f, group, cf, package=moe):
    return package.MoEDims(n_experts=E, top_k=K, n_shared=shared, d_model=d, d_ff=f,
                           group_size=group, capacity_factor=cf)


def _layer_params(E, K, shared, d, f, dtype, seed):
    """One layer's parameters (the reference's init, layer axis dropped), as
    JAX arrays and as torch tensors of the same values."""
    spec = JaxMoESpec(n_experts=E, top_k=K, n_shared=shared, d_ff_expert=f)
    jp = jax_init(jax.random.PRNGKey(seed), jax_moe.moe_specs(spec, d, 1), getattr(jnp, dtype))
    jp = jax.tree_util.tree_map(lambda a: a[0], jp)
    return jp, params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")


def _pair(a: np.ndarray, dtype: str):
    j = jnp.asarray(a, dtype)
    return j, torch.from_numpy(np.array(j, np.float32)).to(TORCH_DTYPE[dtype])


def _reference_route(x, router, dims):
    """The reference's routing, as ``repro.models.moe.moe_ffn`` computes it
    (its lines up to the dispatch tensor, with its own JAX calls): (idx
    [G,g,K], slot [G,g,K], -1 where dropped)."""
    B, S, d = x.shape
    E, K = dims.n_experts, dims.top_k
    g = min(dims.group_size, B * S)
    G = B * S // g
    C = dims.capacity(g)
    xt = x.reshape(G, g, d)
    logits = jnp.einsum("Ggd,dE->GgE", xt, router).astype(jnp.float32)
    _, idx = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), K)
    prior_count = jnp.zeros((G, 1, E), dtype=jnp.int32)
    slots = []
    for k in range(K):
        mask_k = jax.nn.one_hot(idx[..., k], E, dtype=jnp.int32)
        pos_k = jnp.cumsum(mask_k, axis=1) - 1 + prior_count
        prior_count = prior_count + mask_k.sum(axis=1, keepdims=True)
        keep = (pos_k < C) & (mask_k > 0)
        slots.append(jnp.where(keep.any(-1), (pos_k * mask_k).sum(-1), -1))
    return np.array(idx), np.array(jnp.stack(slots, -1))


# (label, B, S, E, K, shared, d, f, group_size, capacity_factor, drops)
CASES = [
    ("one group, shared, drops", 2, 16, 8, 2, 1, 32, 24, 1024, 0.5, True),
    ("one group, no shared, no drops", 2, 16, 8, 2, 0, 32, 24, 1024, 100.0, False),
    ("four groups, shared, drops", 2, 32, 6, 3, 2, 32, 16, 16, 0.75, True),
    ("four groups, no shared, drops", 4, 8, 16, 4, 0, 24, 16, 8, 1.0, True),
    ("decode B1", 1, 1, 8, 2, 1, 32, 24, 1024, 1.25, False),
    ("decode B2", 2, 1, 8, 2, 1, 32, 24, 1024, 1.25, False),
    ("qwen2-moe-like top-4 of 60", 1, 64, 60, 4, 4, 32, 16, 1024, 1.25, True),
]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_ffn_matches_reference(case, dtype):
    _, B, S, E, K, shared, d, f, group, cf, drops = case
    jp, tp = _layer_params(E, K, shared, d, f, dtype, seed=len(case[0]))
    x = np.random.default_rng(B * S + E).standard_normal((B, S, d)).astype(np.float32)
    jx, tx = _pair(x, dtype)
    jdims, tdims = _dims(E, K, shared, d, f, group, cf, jax_moe), _dims(E, K, shared, d, f,
                                                                         group, cf)
    want = np.asarray(jax_moe.moe_ffn(jx, jp, jdims), np.float32)
    got = moe.moe_ffn(tx, tp, tdims)
    assert got.dtype == TORCH_DTYPE[dtype] and got.shape == (B, S, d)
    G, g, C = moe.groups(B * S, tdims)
    assert (G, C) == (B * S // min(group, B * S), jdims.capacity(min(group, B * S)))
    gates, idx, slot = moe.route(tx, tp["router"], tdims)
    assert gates.shape == idx.shape == slot.shape == (G, g, K)
    assert bool((slot < 0).any()) == drops  # capacity drops some (token, k) pairs, or none
    if dtype == "float32":
        ridx, rslot = _reference_route(jx, jp["router"], jdims)
        np.testing.assert_array_equal(idx.numpy(), ridx)
        np.testing.assert_array_equal(slot.numpy(), rslot)
        np.testing.assert_allclose(gates.sum(-1).numpy(), 1.0, rtol=1e-6)
        np.testing.assert_allclose(got.numpy(), want, atol=TOLS[dtype], rtol=TOLS[dtype])
    else:
        assert np.abs(got.float().numpy() - want).max() <= TOLS[dtype] * np.abs(want).max()


def test_moe_ffn_refuses_a_partial_group():
    """The reference asserts that the tokens fill whole groups; the port raises."""
    dims = _dims(4, 2, 0, 8, 8, group=6, cf=1.25)
    with pytest.raises(ValueError, match="whole number of groups"):
        moe.groups(16, dims)


def test_route_breaks_ties_as_the_reference():
    """Router probabilities that tie exactly: the inputs are small integers
    and three experts share one router column, so their logits (and
    probabilities) are equal bit for bit in both packages.  The reference's
    ``jax.lax.top_k`` puts the lowest expert id first among equal
    probabilities, so the k order of tied experts, and with it which tokens
    an expert's capacity drops, must be the same in the port."""
    E, K, d, g = 6, 4, 8, 24
    rng = np.random.default_rng(5)
    router = rng.integers(-2, 3, size=(d, E)).astype(np.float32)
    router[:, 2] = router[:, 1]
    router[:, 4] = router[:, 1]
    x = rng.integers(-1, 2, size=(1, g, d)).astype(np.float32)
    jdims = _dims(E, K, 0, d, 4, 1024, 0.5, jax_moe)
    tdims = _dims(E, K, 0, d, 4, 1024, 0.5)
    ridx, rslot = _reference_route(jnp.asarray(x), jnp.asarray(router), jdims)
    gates, idx, slot = moe.route(torch.from_numpy(x), torch.from_numpy(router), tdims)
    probs = torch.softmax(torch.from_numpy(x[0] @ router), -1)
    # ties decide the order: some token has tied experts inside its top K
    tied = [t for t in range(g) if len(set(probs[t, ridx[0, t]].tolist())) < K]
    assert tied, "no token's top K holds a tie"
    assert bool((slot < 0).any())  # capacity drops, so the order matters
    np.testing.assert_array_equal(idx.numpy(), ridx)
    np.testing.assert_array_equal(slot.numpy(), rslot)
    # the opposite tie rule (the highest id first) gives other ids here
    _, flipped = moe.top_k_lowest_first(probs.flip(-1), K)
    assert not np.array_equal((E - 1 - flipped).numpy(), ridx[0])


def test_top_k_lowest_first_on_the_documented_tie():
    probs = torch.tensor([[0.1, 0.3, 0.3, 0.2, 0.3, 0.1]])
    vals, idx = moe.top_k_lowest_first(probs, 4)
    _, want = jax.lax.top_k(jnp.asarray(probs.numpy()), 4)
    assert idx.tolist() == [[1, 2, 4, 3]] == np.asarray(want).tolist()
    assert torch.equal(vals, probs[0, [1, 2, 4, 3]][None])


def test_aux_load_balance_loss_matches_reference():
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((2, 16, 8)).astype(np.float32)
    idx = rng.integers(0, 8, size=(2, 16, 2)).astype(np.int32)
    want = float(jax_moe.aux_load_balance_loss(jnp.asarray(logits), jnp.asarray(idx), 8))
    got = moe.aux_load_balance_loss(torch.from_numpy(logits), torch.from_numpy(idx), 8)
    assert math.isclose(float(got), want, rel_tol=1e-6)


def test_moe_specs_match_reference():
    for spec in (MoESpec(n_experts=60, top_k=4, n_shared=4, d_ff_expert=1408),
                 MoESpec(n_experts=8, top_k=2, n_shared=0, d_ff_expert=32)):
        jspec = JaxMoESpec(**{k: getattr(spec, k) for k in
                              ("n_experts", "top_k", "n_shared", "d_ff_expert")})
        got = moe.moe_specs(spec, 2048, 24)
        want = jax_moe.moe_specs(jspec, 2048, 24)
        flat = lambda t: {k: (flat(v) if isinstance(v, dict) else (v.shape, v.axes))
                          for k, v in t.items()}
        assert flat(got) == flat(want)
