"""The port's GatedGCN training path against the reference package, on the
CPU: the gated aggregation (the wrapper runs its plain version for CPU
tensors) against the Pallas kernel in interpret mode and against the COO
``segment_sum`` form; the vectorised ``edge_to_padded`` against the
reference loop; the ELL index (no edge dropped on a power-law graph, the
source-sorted list the backward kernel sums over); and GatedGCN's logits,
loss and gradients on ``full_graph`` (with and without remat), a
``NeighborSampler`` ``minibatch`` block and ``batched_graphs``, plus one
AdamW step, from the same converted parameters and numpy inputs.

Tolerances: the aggregation as ``tests/test_kernels.py`` (fp32 2e-5, bf16
2e-2), the ELL form against ``segment_sum`` 1e-4 as there; the model 1e-4
absolute and relative (the same fp32 sums in other orders through three
layers; gradients leaf by leaf within 1e-4 of the leaf's largest value)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax
import jax.numpy as jnp

from repro.configs import get_config as jax_config
from repro.configs.base import ShapeCell as JaxCell
from repro.data.graph import CSRGraph as JaxCSRGraph
from repro.data.graph import NeighborSampler as JaxNeighborSampler
from repro.kernels.gnn_aggregate import edge_to_padded as jax_edge_to_padded
from repro.kernels.gnn_aggregate import gnn_aggregate as jax_gnn_aggregate
from repro.kernels.gnn_aggregate import gnn_aggregate_ref as jax_gnn_aggregate_ref
from repro.models import gnn as jax_gnn
from repro.models.layers import init_params as jax_init
from repro.optim import AdamWConfig as JaxAdamWConfig
from repro.optim import apply_updates as jax_apply_updates
from repro.optim import init_state as jax_init_state
from repro.train import build_loss_fn as jax_build_loss_fn
from repro.train import build_param_specs as jax_param_specs
from repro_torch.configs import ShapeCell, get_config
from repro_torch.convert import params_from_numpy
from repro_torch.data import CSRGraph, NeighborSampler, random_graph
from repro_torch.kernels.gnn_aggregate import (
    edge_to_padded,
    edge_to_padded_vec,
    ell_index,
    gnn_aggregate,
    gnn_aggregate_ref,
)
from repro_torch.models import gnn
from repro_torch.optim import AdamWConfig
from repro_torch.train import build_loss_fn, build_train_step, make_train_state

TOLS = {"float32": 2e-5, "bfloat16": 2e-2}
AGG_CASES = [(50, 16, 8), (128, 70, 12), (16, 128, 4)]  # as tests/test_kernels.py


def _f32(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _ell_of_table(nbr):
    """The ELL index whose neighbour table is ``nbr [N, deg]``: row n's
    slots as edges nbr[n, j] -> n, in slot order."""
    N, deg = nbr.shape
    ell = ell_index(np.stack([nbr.reshape(-1), np.repeat(np.arange(N), deg)]), N)
    np.testing.assert_array_equal(ell.nbr.numpy(), nbr)
    return ell


# --------------------------------------------------------------------------
# the aggregation and its layout
# --------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", AGG_CASES)
def test_gnn_aggregate_matches_reference(case, dtype):
    N, dim, deg = case
    rng = np.random.default_rng(AGG_CASES.index(case))
    jh = jnp.asarray(rng.normal(size=(N, dim)), dtype)
    nbr = rng.integers(0, N, size=(N, deg)).astype(np.int32)
    jg = jnp.asarray(rng.random((N, deg, dim)), dtype)
    h, g = params_from_numpy({"h": np.asarray(jh), "g": np.asarray(jg)}, "cpu").values()
    ell = _ell_of_table(nbr)
    before = gnn_aggregate.launches_fwd
    got = gnn_aggregate(h, ell.nbr, g, ell.rev)
    assert gnn_aggregate.launches_fwd == before  # the CPU runs the plain version
    assert got.dtype == h.dtype
    tol = TOLS[dtype]
    for want in (jax_gnn_aggregate(jh, jnp.asarray(nbr), jg, interpret=True),
                 jax_gnn_aggregate_ref(jh, jnp.asarray(nbr), jg)):
        np.testing.assert_allclose(_f32(got), _f32(want), atol=tol, rtol=tol)


def test_gnn_aggregate_gradients_match_reference():
    """The plain version under autograd (the backward kernels' oracle)
    against jax.vjp of the reference oracle, fp32."""
    N, dim, deg = 30, 16, 5
    rng = np.random.default_rng(0)
    h = rng.normal(size=(N, dim)).astype(np.float32)
    nbr = rng.integers(0, N, size=(N, deg)).astype(np.int32)
    g = rng.random((N, deg, dim)).astype(np.float32)
    dout = rng.normal(size=(N, dim)).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b: jax_gnn_aggregate_ref(a, jnp.asarray(nbr), b),
                     jnp.asarray(h), jnp.asarray(g))
    jdh, jdg = vjp(jnp.asarray(dout))
    th, tg = torch.from_numpy(h).requires_grad_(), torch.from_numpy(g).requires_grad_()
    ell = _ell_of_table(nbr)
    out = gnn_aggregate(th, ell.nbr, tg, ell.rev)
    dh, dg = torch.autograd.grad(out, (th, tg), torch.from_numpy(dout))
    np.testing.assert_allclose(dh.numpy(), np.asarray(jdh), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(dg.numpy(), np.asarray(jdg), atol=2e-5, rtol=2e-5)


def test_gnn_aggregate_matches_segment_sum():
    """Padded-ELL aggregation equals the model's COO segment_sum form."""
    N, E, dim = 40, 150, 16
    rng = np.random.default_rng(3)
    edge_index = np.stack([rng.integers(0, N, E), rng.integers(0, N, E)])
    h = rng.normal(size=(N, dim)).astype(np.float32)
    eta = rng.random((E, dim)).astype(np.float32)
    ell = ell_index(edge_index, N)
    nbr, gates = edge_to_padded(edge_index, eta, N, ell.max_deg)
    np.testing.assert_array_equal(nbr, ell.nbr.numpy())
    out = gnn_aggregate(torch.from_numpy(h), ell.nbr, torch.from_numpy(gates), ell.rev)
    want = jax.ops.segment_sum(jnp.asarray(eta) * jnp.asarray(h)[edge_index[0]],
                               jnp.asarray(edge_index[1]), num_segments=N)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)


def test_gnn_aggregate_out_of_range_ids_index_as_the_reference():
    rng = np.random.default_rng(4)
    h = rng.normal(size=(10, 8)).astype(np.float32)
    nbr = rng.integers(0, 10, size=(6, 3)).astype(np.int32)
    nbr[1, 2], nbr[4, 0], nbr[5, 1] = 10, -11, -1
    g = rng.random((6, 3, 8)).astype(np.float32)
    # ids no ELL index holds: the plain version (the wrapper on the CPU) alone
    got = gnn_aggregate_ref(torch.from_numpy(h), torch.from_numpy(nbr),
                            torch.from_numpy(g)).numpy()
    want = np.asarray(jax_gnn_aggregate_ref(jnp.asarray(h), jnp.asarray(nbr), jnp.asarray(g)))
    bad = np.isin(np.arange(6), [1, 4])
    assert np.isnan(got[bad]).all() and np.isnan(want[bad]).all()
    np.testing.assert_allclose(got[~bad], want[~bad], atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("max_deg", [1, 3, 8, 40])
def test_edge_to_padded_vec_equals_the_reference_loop(max_deg):
    N, E = 30, 200
    rng = np.random.default_rng(max_deg)
    edge_index = np.stack([rng.integers(0, N, E), rng.integers(0, N, E)]).astype(np.int32)
    eta = rng.random((E, 4)).astype(np.float32)
    want = jax_edge_to_padded(edge_index, eta, N, max_deg)
    for got in (edge_to_padded(edge_index, eta, N, max_deg),
                edge_to_padded_vec(edge_index, eta, N, max_deg)):
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_ell_index_drops_no_edge_on_a_power_law_graph():
    N, E = 500, 6000
    edge_index = random_graph(N, E, seed=1)
    in_deg = np.bincount(edge_index[1], minlength=N)
    assert in_deg.max() > 8 * in_deg.mean()  # skewed: a fixed max_deg would drop edges
    ell = ell_index(edge_index, N)
    assert ell.max_deg == in_deg.max()
    slot = ell.slot.numpy()
    assert np.unique(slot).size == E  # one slot per edge
    np.testing.assert_array_equal(ell.nbr.numpy().reshape(-1)[slot], edge_index[0])
    np.testing.assert_array_equal(slot // ell.max_deg, edge_index[1])
    # the slots of each node follow the input order of its edges
    order = np.lexsort((np.arange(E), edge_index[1]))
    np.testing.assert_array_equal(np.diff(slot[order])[np.diff(edge_index[1][order]) == 0], 1)
    # the ELL gates hold every edge's gate: the aggregation equals segment_sum
    rng = np.random.default_rng(2)
    h = rng.normal(size=(N, 6)).astype(np.float32)
    eta = rng.random((E, 6)).astype(np.float32)
    gates = np.zeros((N * ell.max_deg, 6), np.float32)
    gates[slot] = eta
    out = gnn_aggregate(torch.from_numpy(h), ell.nbr,
                        torch.from_numpy(gates).view(N, ell.max_deg, 6), ell.rev)
    want = jax.ops.segment_sum(jnp.asarray(eta) * jnp.asarray(h)[edge_index[0]],
                               jnp.asarray(edge_index[1]), num_segments=N)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)


def test_ell_reverse_lists_group_real_slots_by_source():
    N, E = 60, 400
    edge_index = random_graph(N, E, seed=3)
    ell = ell_index(edge_index, N)
    ptr, rev = ell.rev_ptr.numpy(), ell.rev_slot.numpy()
    assert ptr.dtype == np.int32 and rev.dtype == np.int32 and ptr[-1] == E
    src_of_slot = dict(zip(ell.slot.numpy().tolist(), edge_index[0].tolist()))
    for m in range(N):
        mine = rev[ptr[m]:ptr[m + 1]]
        assert all(src_of_slot[s] == m for s in mine)
        assert np.all(np.diff(mine) > 0)  # increasing slot order: a fixed sum order
    with pytest.raises(ValueError, match="outside"):
        ell_index(np.array([[0, 5], [1, 2]]), 5)


# --------------------------------------------------------------------------
# GatedGCN through the train step's loss
# --------------------------------------------------------------------------
def _sampler_block(n=200, e=1500, fanouts=(3, 2), n_seeds=8, d_feat=12, seed=0):
    """A NeighborSampler block from the reference's sampler and the port's
    copy (the same arrays), with features and labels from numpy."""
    ei = random_graph(n, e, seed=seed)
    block = NeighborSampler(CSRGraph.from_edge_index(ei, n), fanouts, seed=seed).sample(
        np.arange(n_seeds, dtype=np.int32))
    jblock = JaxNeighborSampler(JaxCSRGraph.from_edge_index(ei, n), fanouts, seed=seed).sample(
        np.arange(n_seeds, dtype=np.int32))
    for k in block:
        np.testing.assert_array_equal(block[k], jblock[k])
    rng = np.random.default_rng(seed + 1)
    feats = rng.normal(size=(n, d_feat)).astype(np.float32)
    return {
        "node_feat": feats[block["nodes"]],
        "edge_index": block["edge_index"],
        "labels": rng.integers(0, 7, n_seeds).astype(np.int32),
        "seed_ids": np.arange(n_seeds, dtype=np.int32),
    }


def _full_graph_batch(n=40, e=160, d_feat=12, seed=0):
    rng = np.random.default_rng(seed)
    return {
        "node_feat": (rng.normal(size=(n, d_feat)) * 0.1).astype(np.float32),
        "edge_index": rng.integers(0, n, size=(2, e)).astype(np.int32),
        "labels": rng.integers(0, 7, n).astype(np.int32),
        "train_mask": rng.random(n) < 0.5,
    }


def _batched_batch(b=3, n=10, e=24, seed=0):
    rng = np.random.default_rng(seed)
    return {
        "node_feat": (rng.normal(size=(b, n, 16)) * 0.1).astype(np.float32),
        "edge_index": rng.integers(0, n, size=(b, 2, e)).astype(np.int32),
        "labels": rng.integers(0, 7, b).astype(np.int32),
    }


CASES = {
    "full_graph": (dict(d_feat=12), _full_graph_batch),
    "minibatch": (dict(d_feat=12), _sampler_block),
    "batched_graphs": ({}, _batched_batch),
    # ogb_products' node features (d_feat 100) on a small graph: the cell the
    # card runs at a cut scale, with remat "full"
    "ogb_products": (dict(d_feat=100), lambda seed=0: _full_graph_batch(d_feat=100, seed=seed)),
}
KINDS = {"ogb_products": "full_graph"}  # a case's cell kind, where it is not its name


def _setup(kind, remat="none", seed=0):
    params, make = CASES[kind]
    kind = KINDS.get(kind, kind)
    jcell, tcell = JaxCell("c", kind, params), ShapeCell("c", kind, params)
    jcfg, tcfg = jax_config("gatedgcn", smoke=True), get_config("gatedgcn", smoke=True)
    jp = jax_init(jax.random.PRNGKey(seed), jax_param_specs(jcfg, jcell), jnp.float32)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    batch = make(seed=seed)
    jloss = jax_build_loss_fn(jcfg, jcell, remat=remat)
    tloss = build_loss_fn(tcfg, tcell, remat=remat)
    return jp, tp, batch, jloss, tloss, (tcfg, tcell)


def _grad_close(got, want):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _grad_close(got[k], want[k])
        return
    want = np.asarray(want, np.float32)
    tol = 1e-4 * max(np.abs(want).max(), 1e-3)
    np.testing.assert_allclose(got.numpy(), want, atol=tol, rtol=1e-4)


@pytest.mark.parametrize("kind,remat", [("full_graph", "none"), ("full_graph", "full"),
                                        ("minibatch", "none"), ("batched_graphs", "none"),
                                        ("ogb_products", "full")])
def test_gnn_loss_and_gradients_match_reference(kind, remat):
    jp, tp, batch, jloss, tloss, _ = _setup(kind, remat)
    (jl, _), jg = jax.value_and_grad(
        lambda p: jloss(p, {k: jnp.asarray(v) for k, v in batch.items()}), has_aux=True)(jp)
    leaves = jax.tree_util.tree_leaves(tp)
    req = [t.detach().requires_grad_(True) for t in leaves]
    tree = jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(tp), req)
    tl, metrics = tloss(tree, {k: torch.from_numpy(np.array(v)) for k, v in batch.items()})
    grads = torch.autograd.grad(tl, req)
    np.testing.assert_allclose(float(tl.detach()), float(jl), atol=1e-4, rtol=1e-4)
    assert float(metrics["loss"]) == float(tl)
    _grad_close(jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(tp), grads), jg)


@pytest.mark.parametrize("kind", ["full_graph", "minibatch", "batched_graphs"])
def test_gnn_logits_match_reference(kind):
    jp, tp, batch, *_ = _setup(kind)
    jcfg, tcfg = jax_config("gatedgcn", smoke=True), get_config("gatedgcn", smoke=True)
    tb = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    if kind == "batched_graphs":
        want = jax_gnn.forward_batched(jp, jcfg, jnp.asarray(batch["node_feat"]),
                                       jnp.asarray(batch["edge_index"]))
        got = gnn.forward_batched(tp, tcfg, tb["node_feat"], tb["edge_index"])
    else:
        want = jax_gnn.forward(jp, jcfg, jnp.asarray(batch["node_feat"]),
                               jnp.asarray(batch["edge_index"]))
        got = gnn.forward(tp, tcfg, tb["node_feat"], tb["edge_index"])
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)


def test_gnn_train_step_matches_reference_adamw():
    """One AdamW step of ``build_train_step`` on a sampled block against the
    reference's gradients and update."""
    jp, tp, batch, jloss, _, (tcfg, tcell) = _setup("minibatch", seed=1)
    (jl, _), jg = jax.value_and_grad(
        lambda p: jloss(p, {k: jnp.asarray(v) for k, v in batch.items()}), has_aux=True)(jp)
    jnew, _, jm = jax_apply_updates(jp, jg, jax_init_state(jp),
                                    JaxAdamWConfig(lr=1e-2, warmup_steps=1, total_steps=10))
    step = build_train_step(tcfg, tcell, AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=10))
    state, m = step(make_train_state(tp),
                    {k: torch.from_numpy(np.array(v)) for k, v in batch.items()})
    np.testing.assert_allclose(float(m["loss"]), float(jl), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
    got = jax.tree_util.tree_leaves(state["params"])
    for a, b in zip(got, jax.tree_util.tree_leaves(jnew)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4, rtol=1e-4)


def test_forward_rejects_edges_outside_the_graph():
    """The reference's synthetic ``minibatch`` batch draws edge ids up to the
    full graph's node count, past the block's rows (``jnp.take`` fills and
    ``segment_sum`` drops them); the port's host-side ELL build refuses them."""
    _, tp, batch, *_ = _setup("full_graph")
    ei = batch["edge_index"].copy()
    ei[0, 3] = batch["node_feat"].shape[0]
    with pytest.raises(ValueError, match="outside"):
        gnn.forward(tp, get_config("gatedgcn", smoke=True),
                    torch.from_numpy(batch["node_feat"]), torch.from_numpy(ei))
