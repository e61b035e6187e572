"""The port's embedding bag against the reference package, on the CPU: the
wrapper (which runs its plain version for CPU tensors) against the Pallas
kernel in interpret mode and against ``embedding_bag_ref``, on the shapes of
``tests/test_kernels.py``; the segment-form ``layers.embedding_bag``; and ids
outside the table, where both packages index as ``jnp.take`` does (negative
ids count from the end, ids past either end fill the row with NaN).

Tolerances as ``tests/test_kernels.py``: fp32 2e-5, bf16 2e-2 (the two sum
the same fp32 products in other orders; bf16 rounds once at the end)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.kernels.embedding_bag import embedding_bag as jax_embedding_bag
from repro.kernels.embedding_bag import embedding_bag_ref as jax_embedding_bag_ref
from repro.models import layers as jax_layers
from repro_torch.convert import params_from_numpy
from repro_torch.kernels.embedding_bag import embedding_bag, embedding_bag_ref
from repro_torch.models import layers

TOLS = {"float32": 2e-5, "bfloat16": 2e-2}

BAG_CASES = [  # as tests/test_kernels.py: (V, dim, n_bags, bag_size, combiner)
    (1000, 16, 8, 4, "sum"),
    (5000, 128, 16, 26, "sum"),  # dcn-v2-like field lookup
    (300, 10, 32, 39, "sum"),  # fm-like
    (256, 50, 4, 50, "mean"),  # sasrec-like history pooling
]


def _inputs(case, dtype, seed):
    V, dim, n_bags, bag, _ = case
    rng = np.random.default_rng(seed)
    jtable = jnp.asarray(rng.normal(size=(V, dim)), dtype)
    ids = rng.integers(0, V, size=(n_bags, bag)).astype(np.int32)
    w = rng.random((n_bags, bag)).astype(np.float32)
    table = params_from_numpy(np.asarray(jtable), "cpu")  # bit for bit, bf16 included
    return jtable, table, ids, w


def _f32(x):
    return np.asarray(x, np.float32) if not isinstance(x, torch.Tensor) else x.float().numpy()


@pytest.mark.parametrize("case", BAG_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("weighted", [True, False])
def test_embedding_bag_matches_reference(case, dtype, weighted):
    jtable, table, ids, w = _inputs(case, dtype, BAG_CASES.index(case))
    combiner = case[-1]
    jw = jnp.asarray(w) if weighted else None
    tw = torch.from_numpy(w) if weighted else None
    before = embedding_bag.launches
    got = embedding_bag(table, torch.from_numpy(ids), tw, combiner=combiner)
    assert embedding_bag.launches == before  # the CPU runs the plain version
    assert got.dtype == table.dtype and got.shape == (case[2], case[1])
    tol = TOLS[dtype]
    for want in (
        jax_embedding_bag(jtable, jnp.asarray(ids), jw, combiner=combiner, interpret=True),
        jax_embedding_bag_ref(jtable, jnp.asarray(ids), jw, combiner=combiner),
    ):
        np.testing.assert_allclose(_f32(got), _f32(want), atol=tol, rtol=tol)


def test_embedding_bag_ref_is_the_wrapper_on_the_cpu():
    _, table, ids, w = _inputs(BAG_CASES[2], "float32", 0)
    ids, w = torch.from_numpy(ids), torch.from_numpy(w)
    for combiner in ("sum", "mean"):
        assert torch.equal(embedding_bag(table, ids, w, combiner=combiner),
                           embedding_bag_ref(table, ids, w, combiner))


def test_embedding_bag_out_of_range_ids_index_as_the_reference():
    jtable, table, ids, w = _inputs(BAG_CASES[0], "float32", 1)
    ids[2, 1] = 1000  # == V
    ids[5, 3] = -1001  # < -V
    ids[6, 0] = -1  # the last row
    got = embedding_bag(table, torch.from_numpy(ids), torch.from_numpy(w)).numpy()
    want = np.asarray(jax_embedding_bag_ref(jtable, jnp.asarray(ids), jnp.asarray(w)))
    bad = np.zeros(len(ids), bool)
    bad[[2, 5]] = True
    assert np.isnan(got[bad]).all() and np.isnan(want[bad]).all()
    assert np.isfinite(got[~bad]).all()
    np.testing.assert_allclose(got[~bad], want[~bad], atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("combiner", ["sum", "mean"])
@pytest.mark.parametrize("weighted", [True, False])
def test_segment_embedding_bag_matches_reference(combiner, weighted):
    rng = np.random.default_rng(7)
    V, dim, nnz, n_seg = 60, 8, 100, 12
    table = rng.normal(size=(V, dim)).astype(np.float32)
    ids = rng.integers(0, V, nnz).astype(np.int32)
    seg = rng.integers(0, n_seg - 1, nnz).astype(np.int32)  # the last bag stays empty
    w = rng.random(nnz).astype(np.float32) if weighted else None
    want = jax_layers.embedding_bag(
        jnp.asarray(table), jnp.asarray(ids), jnp.asarray(seg), n_seg, combiner,
        jnp.asarray(w) if weighted else None)
    got = layers.embedding_bag(
        torch.from_numpy(table), torch.from_numpy(ids), torch.from_numpy(seg), n_seg,
        combiner, torch.from_numpy(w) if weighted else None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)
    np.testing.assert_array_equal(
        layers.embedding_lookup(torch.from_numpy(table), torch.from_numpy(ids)).numpy(),
        np.asarray(jax_layers.embedding_lookup(jnp.asarray(table), jnp.asarray(ids))))
