"""The port's recsys training path against the reference package, on the CPU:
``build_loss_fn`` and ``build_train_step`` of FM, DCN-v2, BST and SASRec on
their smoke configs in fp32, from the reference's ``init_params`` and the
same numpy batches; and the embedding-bag backward's plain versions
(``embedding_bag_bwd_ref`` against ``jax.grad`` of the reference's
``embedding_bag_ref``, ``embedding_bag_bwd_seq_ref``, the kernel's
arithmetic, against ``embedding_bag_bwd_ref``).

Tolerances: the loss and every gradient leaf within 1e-4 of the leaf's
largest reference value (the same fp32 sums in other orders through a few
dense layers); five AdamW steps' losses and parameters within 1e-4, as the
LM's five-step test; the plain backward within 1e-5 of its largest value in
fp32 (other summation orders) and within 2e-2 in bf16 (the reference sums a
bf16 table's gradient in bf16, the port in fp32 rounded once)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax
import jax.numpy as jnp

from repro.configs import get_config as jax_config
from repro.configs import get_shapes as jax_shapes
from repro.data import make_batch as jax_make_batch
from repro.kernels.embedding_bag import embedding_bag_ref as jax_embedding_bag_ref
from repro.models.layers import init_params as jax_init
from repro.optim import AdamWConfig as JaxAdamWConfig
from repro.train import build_loss_fn as jax_build_loss_fn
from repro.train import build_param_specs as jax_param_specs
from repro.train import build_train_step as jax_build_train_step
from repro.train import make_train_state as jax_make_train_state
from repro_torch.configs import get_config, get_shapes
from repro_torch.convert import params_from_numpy
from repro_torch.data import make_batch
from repro_torch.kernels.embedding_bag import (
    bwd_index,
    embedding_bag,
    embedding_bag_bwd,
    embedding_bag_bwd_ref,
    embedding_bag_bwd_seq_ref,
)
from repro_torch.kernels.embedding_bag import ops as bag_ops
from repro_torch.optim import AdamWConfig
from repro_torch.train import build_loss_fn, build_train_step, make_train_state
from repro_torch.tree import leaves, unflatten

RECSYS = ["fm", "dcn-v2", "bst", "sasrec"]
BATCH = 16


def _cells(arch):
    """(reference cell, port cell): ``train_batch`` at BATCH samples."""
    def small(cell):
        return dataclasses.replace(cell, params=dict(cell.params, batch=BATCH))

    return (small(next(c for c in jax_shapes(arch) if c.name == "train_batch")),
            small(next(c for c in get_shapes(arch) if c.name == "train_batch")))


def _setup(arch, seed=0):
    jcfg, tcfg = jax_config(arch, smoke=True), get_config(arch, smoke=True)
    jcell, tcell = _cells(arch)
    jp = jax_init(jax.random.PRNGKey(seed), jax_param_specs(jcfg, jcell), jnp.float32)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    return jcfg, tcfg, jcell, tcell, jp, tp


def _leaf_close(got, want, what):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy()
    assert got.shape == want.shape, what
    tol = 1e-4 * max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, atol=tol, rtol=0, err_msg=what)


@pytest.mark.parametrize("arch", RECSYS)
def test_loss_and_every_gradient_match_reference(arch):
    jcfg, tcfg, jcell, tcell, jp, tp = _setup(arch)
    jbatch = jax_make_batch(jcfg, jcell, seed=1)
    tbatch = make_batch(tcfg, tcell, seed=1, device="cpu")
    jloss_fn = jax_build_loss_fn(jcfg, jcell)
    jloss, jgrads = jax.value_and_grad(lambda p: jloss_fn(p, jbatch)[0])(jp)
    req = [t.detach().requires_grad_(True) for t in leaves(tp)]
    tloss, metrics = build_loss_fn(tcfg, tcell)(unflatten(tp, req), tbatch)
    tgrads = [torch.zeros_like(t) if g is None else g  # as the train step does
              for t, g in zip(req, torch.autograd.grad(tloss, req, allow_unused=True))]
    loss = float(tloss.detach())
    np.testing.assert_allclose(loss, float(jloss), atol=1e-4 * abs(float(jloss)), rtol=0)
    assert float(metrics["loss"].detach()) == loss
    jleaves = jax.tree_util.tree_leaves(jgrads)
    assert len(jleaves) == len(tgrads)
    for i, (g, w) in enumerate(zip(tgrads, jleaves)):
        _leaf_close(g, w, f"{arch} gradient leaf {i}")
    assert embedding_bag.launches_bwd == 0  # the CPU runs the plain version


@pytest.mark.parametrize("arch", RECSYS)
def test_five_adamw_steps_track_reference(arch):
    jcfg, tcfg, jcell, tcell, jp, tp = _setup(arch, seed=2)
    opt = dict(warmup_steps=2, total_steps=5)
    jstep = jax.jit(jax_build_train_step(jcfg, jcell, JaxAdamWConfig(**opt)))
    tstep = build_train_step(tcfg, tcell, AdamWConfig(**opt))
    jstate, tstate = jax_make_train_state(jp), make_train_state(tp)
    for s in range(5):
        jstate, jm = jstep(jstate, jax_make_batch(jcfg, jcell, seed=s))
        tstate, tm = tstep(tstate, make_batch(tcfg, tcell, seed=s, device="cpu"))
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), atol=1e-4, rtol=1e-4,
                                       err_msg=f"{arch} step {s} {k}")
    for i, (g, w) in enumerate(zip(leaves(tstate["params"]),
                                   jax.tree_util.tree_leaves(jstate["params"]))):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4, rtol=1e-4,
                                   err_msg=f"{arch} parameter leaf {i}")


# --------------------------------------------------------------------------
# the backward's plain versions
# --------------------------------------------------------------------------
# (V, dim, n_bags, bag, combiner, weighted): FM-like field sums, bags of one,
# a SASRec-like weighted mean, width 1 (FM's linear term)
BWD_CASES = [
    (300, 10, 64, 39, "sum", False),
    (500, 16, 300, 1, "sum", False),
    (256, 50, 40, 50, "mean", True),
    (120, 1, 50, 9, "sum", True),
    (90, 8, 33, 7, "mean", False),
]


def _bwd_inputs(case, seed, bad_ids=True):
    V, dim, n_bags, bag, combiner, weighted = case
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, V, size=(n_bags, bag)).astype(np.int32)
    if bad_ids:
        ids.flat[::7] -= V  # negative ids, counting from the end
        ids.flat[3::11] = V + 5  # past the end: they add nothing
        ids.flat[5::13] = -V - 2
    w = rng.random((n_bags, bag)).astype(np.float32) if weighted else None
    dout = rng.normal(size=(n_bags, dim)).astype(np.float32)
    return V, ids, w, dout, combiner


@pytest.mark.parametrize("case", BWD_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bwd_ref_matches_jax_grad_of_the_reference(case, dtype):
    V, ids, w, dout, combiner = _bwd_inputs(case, BWD_CASES.index(case))
    dim = dout.shape[1]
    jtable = jnp.zeros((V, dim), dtype)
    jdout = jnp.asarray(dout).astype(dtype)
    jw = jnp.asarray(w) if w is not None else None
    _, vjp = jax.vjp(lambda t: jax_embedding_bag_ref(t, jnp.asarray(ids), jw, combiner), jtable)
    want = np.asarray(vjp(jdout)[0], np.float32)
    tdout = params_from_numpy(np.asarray(jdout), "cpu")
    tw = torch.from_numpy(w) if w is not None else None
    got = embedding_bag_bwd_ref(V, torch.from_numpy(ids), tw, tdout, combiner)
    assert got.dtype == tdout.dtype and got.shape == (V, dim)
    tol = (1e-5 if dtype == "float32" else 2e-2) * float(np.abs(want).max())
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=0)
    # an id outside [-V, V) adds nothing: a row no valid id names stays 0
    valid = ids[(ids >= -V) & (ids < V)]
    untouched = np.ones(V, bool)
    untouched[np.where(valid < 0, valid + V, valid)] = False
    assert (got.float().numpy()[untouched] == 0).all()
    assert (want[untouched] == 0).all()
    # the wrapper on CPU tensors is the plain version, and autograd of the
    # forward on the CPU gives the same table gradient
    assert torch.equal(embedding_bag_bwd(V, torch.from_numpy(ids), tw, tdout, combiner), got)
    if dtype == "float32":
        table = torch.zeros(V, dim, requires_grad=True)
        out = embedding_bag(table, torch.from_numpy(ids), tw, combiner=combiner)
        (g,) = torch.autograd.grad(out, table, tdout)
        np.testing.assert_allclose(g.numpy(), got.numpy(), atol=tol, rtol=0)


@pytest.mark.parametrize("case", BWD_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("chunk", [32, 64, None])
def test_bwd_seq_ref_matches_bwd_ref(case, dtype, chunk):
    V, ids, w, dout, combiner = _bwd_inputs(case, 10 + BWD_CASES.index(case))
    tdout = torch.from_numpy(dout).to(dtype)
    tw = torch.from_numpy(w) if w is not None else None
    tids = torch.from_numpy(ids)
    want = embedding_bag_bwd_ref(V, tids, tw, tdout, combiner)
    got = embedding_bag_bwd_seq_ref(V, tids, tw, tdout, combiner, chunk=chunk)
    assert got.dtype == dtype and got.shape == want.shape
    tol = (1e-5 if dtype == torch.float32 else 1e-2) * float(want.float().abs().max())
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=0)
    untouched = torch.ones(V, dtype=torch.bool)
    key, _ = bwd_index(tids, V)
    untouched[key[key < V].long()] = False
    assert (got[untouched] == 0).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bwd_seq_ref_sums_a_hub_over_many_chunks_in_chunk_order(dtype):
    """A hub row read by 1,000 of 1,200 positions spans 32 chunks of 32: its
    gradient is its pieces, each a position-ordered sum from 0, added in
    chunk order (computed here by hand), within fp32 rounding of the plain
    sum."""
    V, dim, n_bags, bag = 40, 3, 300, 4
    rng = np.random.default_rng(7)
    ids = rng.integers(0, V, size=(n_bags, bag)).astype(np.int32)
    hub = rng.choice(n_bags * bag, 1000, replace=False)
    ids.flat[hub] = 17
    dout = torch.from_numpy(rng.normal(size=(n_bags, dim)).astype(np.float32)).to(dtype)
    w = torch.from_numpy(rng.random((n_bags, bag)).astype(np.float32))
    tids = torch.from_numpy(ids)
    got = embedding_bag_bwd_seq_ref(V, tids, w, dout, "sum", chunk=32)
    key, pos = bwd_index(tids, V)
    at = (key == 17).nonzero()[:, 0]
    assert at.numel() >= 1000 and len({int(i) // 32 for i in at}) >= 32
    terms = dout.float()[pos[at].long() // bag] * w.reshape(-1)[pos[at].long()][:, None]
    total = None
    for c in sorted({int(i) // 32 for i in at}):  # the pieces, in chunk order
        piece = torch.zeros(dim)
        for t, i in zip(terms, at):
            if int(i) // 32 == c:
                piece = piece + t
        total = piece if total is None else total + piece
    assert torch.equal(got[17], total.to(dtype))
    want = embedding_bag_bwd_ref(V, tids, w, dout, "sum")
    tol = (1e-5 if dtype == torch.float32 else 1e-2) * float(want.float().abs().max())
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=0)


def test_bwd_index_sorts_positions_stably_by_row():
    V = 10
    ids = torch.tensor([[3, -1, 12], [3, 0, -11], [9, 3, -10]], dtype=torch.int32)
    key, pos = bwd_index(ids, V)
    assert key.dtype == pos.dtype == torch.int32
    assert key.tolist() == [0, 0, 3, 3, 3, 9, 9, 10, 10]
    assert pos.tolist() == [4, 8, 0, 3, 7, 1, 6, 2, 5]


@pytest.mark.parametrize("dim", [1, 10, 16, 32, 50, 128, 1024])
def test_bwd_chunk_fits_the_shared_memory(dim):
    chunk = bag_ops.bwd_chunk(dim)
    assert chunk % 32 == 0 and 32 <= chunk <= bag_ops.BWD_THREADS
    assert (bag_ops.bwd_smem_bytes(chunk, dim) + bag_ops.BWD_STATIC_SMEM
            <= bag_ops.SMEM_PER_BLOCK)
    if dim <= 50:  # the recsys widths: a full block of positions
        assert chunk == bag_ops.BWD_THREADS


def test_cpu_path_stays_the_plain_version_under_autograd():
    """On the CPU the wrapper is ``embedding_bag_ref``, which autograd
    differentiates in the table and the weights alike (the card's kernel
    path gives the table its gradient and refuses weights that require
    grad: tests/test_torch_kernels_cuda.py)."""
    table = torch.randn(20, 4, requires_grad=True)
    ids = torch.randint(0, 20, (5, 3), dtype=torch.int32)
    w = torch.rand(5, 3, requires_grad=True)
    out = embedding_bag(table, ids, w)
    gt, gw = torch.autograd.grad(out.sum(), (table, w))
    assert gt.shape == table.shape and gw.shape == w.shape
