"""The row-pointer (CSR) layout of the gated aggregation against the
reference package, on the CPU: ``csr_index`` against ``ell_index`` (the same
sources per row, the cumulative in-degree, the source-sorted reverse lists
and each list entry's row), built on the meta device too, where no value can
be read back to the host; the plain CSR aggregation (``num`` and ``den``,
through the wrapper, which runs the plain version for CPU tensors) against
the reference model's two ``jax.ops.segment_sum``s; a padded-ELL table run as
its CSR form against ``gnn_aggregate_ref`` and the Pallas kernel in interpret
mode; gradients against ``jax.grad``; and the GatedGCN forward, which must
build no ELL index.

Tolerances: as ``tests/test_kernels.py`` (fp32 2e-5, bf16 2e-2).  The JAX
side sums in fp32 on the same rounded inputs and rounds once, which is the
kernel's contract (fp32 accumulation) and the Pallas kernel's."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax
import jax.numpy as jnp

from repro.kernels.gnn_aggregate import gnn_aggregate as jax_gnn_aggregate
from repro.kernels.gnn_aggregate import gnn_aggregate_ref as jax_gnn_aggregate_ref
from repro_torch.configs import get_config
from repro_torch.data import random_graph
from repro_torch.kernels import gnn_aggregate as agg_pkg
from repro_torch.kernels.gnn_aggregate import (
    csr_index,
    ell_as_csr,
    ell_index,
    gnn_aggregate,
    gnn_aggregate_csr,
    gnn_aggregate_csr_ref,
    gnn_aggregate_ref,
)
from repro_torch.kernels.gnn_aggregate import ref as agg_ref
from repro_torch.models import gnn
from repro_torch.models.gnn import gnn_specs
from repro_torch.models.layers import init_params

TOLS = {"float32": 2e-5, "bfloat16": 2e-2}
AGG_CASES = [(50, 16, 8), (128, 70, 12), (16, 128, 4)]  # as tests/test_kernels.py


def _graph(kind: str):
    """(edge_index [2, E] int32, n_nodes): a power-law graph, one whose upper
    half of the nodes has no in-edge, and one where most nodes have none."""
    if kind == "power_law":
        return random_graph(500, 6000, seed=1), 500
    rng = np.random.default_rng(5)
    if kind == "half_isolated":
        return np.stack([rng.integers(0, 80, 400), rng.integers(0, 40, 400)]).astype(np.int32), 80
    return np.stack([rng.integers(0, 300, 20), rng.integers(0, 300, 20)]).astype(np.int32), 300


def _f32(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _jax_segment_sums(h, edge_index, eta, n, dtype):
    """The reference model's num and den (``src/repro/models/gnn.py``,
    ``_gated_layer``) on the same rounded inputs, summed in fp32 and rounded
    once to ``dtype``."""
    src, dst = (jnp.asarray(a) for a in edge_index)
    h32 = jnp.asarray(_f32(h))
    eta32 = jnp.asarray(_f32(eta))
    num = jax.ops.segment_sum(eta32 * jnp.take(h32, src, axis=0), dst, num_segments=n)
    den = jax.ops.segment_sum(eta32, dst, num_segments=n)
    return num.astype(dtype), den.astype(dtype)


# --------------------------------------------------------------------------
# the index
# --------------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["power_law", "half_isolated", "sparse"])
def test_csr_index_matches_ell_index(kind):
    edge_index, n = _graph(kind)
    src, dst = edge_index.astype(np.int64)
    E = src.shape[0]
    idx = csr_index(torch.from_numpy(edge_index), n)
    ell = ell_index(edge_index, n)
    for t in (idx.row_ptr, idx.col, idx.rev_ptr, idx.rev_slot, idx.rev_row):
        assert t.dtype == torch.int32
    row_ptr, col = idx.row_ptr.numpy(), idx.col.numpy()
    in_deg = np.bincount(dst, minlength=n)
    assert (in_deg == 0).any()  # rows with no slot
    np.testing.assert_array_equal(row_ptr, np.concatenate([[0], np.cumsum(in_deg)]))
    # each row holds the sources of the ELL row, in its slot order
    nbr = ell.nbr.numpy()
    for v in range(n):
        mine = col[row_ptr[v]:row_ptr[v + 1]]
        np.testing.assert_array_equal(mine, nbr[v, :in_deg[v]])
        np.testing.assert_array_equal(np.sort(mine), np.sort(src[dst == v]))
    # slot k holds input edge perm[k]: the ELL slot's rank within its row
    perm = idx.perm.numpy()
    np.testing.assert_array_equal(col, src[perm])
    inv = np.empty(E, np.int64)
    inv[perm] = np.arange(E)
    slot = ell.slot.numpy()
    np.testing.assert_array_equal(inv, row_ptr[dst] + slot % ell.max_deg)
    # the reverse list: the slots of each source, in increasing order, and their rows
    rev_ptr, rev_slot, rev_row = (t.numpy() for t in idx.rev)
    np.testing.assert_array_equal(rev_ptr, np.concatenate([[0], np.cumsum(
        np.bincount(src, minlength=n))]))
    for m in range(n):
        mine = rev_slot[rev_ptr[m]:rev_ptr[m + 1]]
        np.testing.assert_array_equal(mine, np.flatnonzero(col == m))
    np.testing.assert_array_equal(rev_row, np.searchsorted(row_ptr, rev_slot, side="right") - 1)
    np.testing.assert_array_equal(rev_row, dst[perm][rev_slot])


def test_csr_index_reads_nothing_back_on_the_meta_device():
    """Built from tensors that hold no values: no op of the build reads a
    value or a size back to the host (a sync on the card)."""
    ei = torch.empty(2, 6000, dtype=torch.int32, device="meta")
    idx = csr_index(ei, 500)
    assert idx.row_ptr.device.type == "meta"
    assert tuple(idx.row_ptr.shape) == (501,) and tuple(idx.rev_row.shape) == (6000,)


# --------------------------------------------------------------------------
# the plain aggregation over the index
# --------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind,dim", [("power_law", 70), ("half_isolated", 16), ("sparse", 13)])
def test_csr_aggregate_matches_segment_sums(kind, dim, dtype):
    edge_index, n = _graph(kind)
    rng = np.random.default_rng(dim)
    tdt = getattr(torch, dtype)
    h = torch.from_numpy(rng.normal(size=(n, dim)).astype(np.float32)).to(tdt)
    eta = torch.from_numpy(rng.random((edge_index.shape[1], dim)).astype(np.float32)).to(tdt)
    idx = csr_index(torch.from_numpy(edge_index), n)
    gates = eta[idx.perm]  # in slot order
    before = gnn_aggregate.launches_fwd
    num, den = gnn_aggregate_csr(h, idx.row_ptr, idx.col, gates, idx.rev, with_den=True)
    assert gnn_aggregate.launches_fwd == before  # the CPU runs the plain version
    assert num.dtype == den.dtype == tdt and tuple(num.shape) == (n, dim)
    want_num, want_den = _jax_segment_sums(h, edge_index, eta, n, dtype)
    tol = TOLS[dtype]
    np.testing.assert_allclose(_f32(num), _f32(want_num), atol=tol, rtol=tol)
    np.testing.assert_allclose(_f32(den), _f32(want_den), atol=tol, rtol=tol)
    no_den, none = gnn_aggregate_csr(h, idx.row_ptr, idx.col, gates, idx.rev)
    assert none is None and torch.equal(no_den, num)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", AGG_CASES)
def test_ell_as_csr_matches_the_ell_reference(case, dtype):
    """A padded-ELL table run as its CSR form (what the wrapper hands the
    kernels on CUDA) against the ELL plain version and the Pallas kernel."""
    N, dim, deg = case
    rng = np.random.default_rng(AGG_CASES.index(case))
    jh = jnp.asarray(rng.normal(size=(N, dim)), dtype)
    nbr = rng.integers(0, N, size=(N, deg)).astype(np.int32)
    jg = jnp.asarray(rng.random((N, deg, dim)), dtype)
    tdt = getattr(torch, dtype)
    h = torch.from_numpy(np.array(jh.astype(jnp.float32))).to(tdt)
    g = torch.from_numpy(np.array(jg.astype(jnp.float32))).to(tdt)
    ell = ell_index(np.stack([nbr.reshape(-1), np.repeat(np.arange(N), deg)]), N)
    np.testing.assert_array_equal(ell.nbr.numpy(), nbr)
    row_ptr, col, rev = ell_as_csr(ell.nbr, ell.rev)
    np.testing.assert_array_equal(row_ptr.numpy(), np.arange(N + 1) * deg)
    np.testing.assert_array_equal(rev[2].numpy(), ell.rev_slot.numpy() // deg)
    got, _ = gnn_aggregate_csr(h, row_ptr, col, g.view(N * deg, dim), rev)
    assert got.dtype == tdt
    tol = TOLS[dtype]
    np.testing.assert_allclose(_f32(got), _f32(gnn_aggregate_ref(h, ell.nbr, g)),
                               atol=tol, rtol=tol)
    for want in (jax_gnn_aggregate(jh, jnp.asarray(nbr), jg, interpret=True),
                 jax_gnn_aggregate_ref(jh, jnp.asarray(nbr), jg)):
        np.testing.assert_allclose(_f32(got), _f32(want), atol=tol, rtol=tol)


def test_csr_aggregate_gradients_match_jax():
    """The plain version under autograd (the backward kernel's oracle):
    gradients of a loss on num and den against jax.grad of the reference's
    segment_sum form, fp32."""
    edge_index, n = _graph("power_law")
    dim = 12
    rng = np.random.default_rng(7)
    h = rng.normal(size=(n, dim)).astype(np.float32)
    eta = rng.random((edge_index.shape[1], dim)).astype(np.float32)
    a = rng.normal(size=(n, dim)).astype(np.float32)
    b = rng.normal(size=(n, dim)).astype(np.float32)
    src, dst = (jnp.asarray(x) for x in edge_index)

    def jloss(h_, eta_):
        num = jax.ops.segment_sum(eta_ * jnp.take(h_, src, axis=0), dst, num_segments=n)
        den = jax.ops.segment_sum(eta_, dst, num_segments=n)
        return jnp.sum(num * a) + jnp.sum(den * b)

    jdh, jdeta = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(h), jnp.asarray(eta))
    idx = csr_index(torch.from_numpy(edge_index), n)
    th = torch.from_numpy(h).requires_grad_(True)
    teta = torch.from_numpy(eta).requires_grad_(True)
    num, den = gnn_aggregate_csr(th, idx.row_ptr, idx.col, teta[idx.perm], idx.rev,
                                 with_den=True)
    loss = (num * torch.from_numpy(a)).sum() + (den * torch.from_numpy(b)).sum()
    dh, deta = torch.autograd.grad(loss, (th, teta))
    np.testing.assert_allclose(dh.numpy(), np.asarray(jdh), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(deta.numpy(), np.asarray(jdeta), atol=2e-5, rtol=2e-5)


def test_csr_aggregate_ids_index_as_the_reference():
    """Out-of-range ids make their row NaN and negative ids count from the
    end, as jnp.take does; den reads no h and stays finite; rows with no
    slot are 0."""
    rng = np.random.default_rng(4)
    h = rng.normal(size=(10, 8)).astype(np.float32)
    nbr = rng.integers(0, 10, size=(6, 3)).astype(np.int32)
    nbr[1, 2], nbr[4, 0], nbr[5, 1] = 10, -11, -1
    g = rng.random((6, 3, 8)).astype(np.float32)
    row_ptr = torch.tensor([0, 3, 6, 9, 12, 15, 18, 18], dtype=torch.int32)  # row 6: empty
    num, den = gnn_aggregate_csr_ref(torch.from_numpy(h), row_ptr,
                                     torch.from_numpy(nbr.reshape(-1)),
                                     torch.from_numpy(g.reshape(18, 8)), with_den=True)
    want = np.asarray(jax_gnn_aggregate_ref(jnp.asarray(h), jnp.asarray(nbr), jnp.asarray(g)))
    bad = np.isin(np.arange(6), [1, 4])
    got = num.numpy()
    assert np.isnan(got[:6][bad]).all() and np.isnan(want[bad]).all()
    np.testing.assert_allclose(got[:6][~bad], want[~bad], atol=2e-5, rtol=2e-5)
    np.testing.assert_array_equal(got[6], 0)
    np.testing.assert_allclose(den.numpy()[:6], g.sum(axis=1), atol=2e-5, rtol=2e-5)
    np.testing.assert_array_equal(den.numpy()[6], 0)


# --------------------------------------------------------------------------
# the model
# --------------------------------------------------------------------------
def test_forward_builds_no_ell_index(monkeypatch):
    """GatedGCN's forward runs on the CSR index alone: the host-side ELL
    build is never called."""
    def refuse(*args, **kwargs):
        raise AssertionError("forward built an ELL index")

    for module in (agg_ref, agg_pkg, gnn):
        monkeypatch.setattr(module, "ell_index", refuse, raising=False)
    cfg = get_config("gatedgcn", smoke=True)
    rng = np.random.default_rng(0)
    n = 40
    params = init_params(torch.Generator().manual_seed(0), gnn_specs(cfg, 12), cfg.dtype, "cpu")
    feats = torch.from_numpy((rng.normal(size=(n, 12)) * 0.1).astype(np.float32))
    ei = torch.from_numpy(rng.integers(0, n, size=(2, 160)).astype(np.int32))
    logits = gnn.forward(params, cfg, feats, ei)
    assert tuple(logits.shape) == (n, cfg.n_classes) and torch.isfinite(logits).all()
