"""The embedding-bag kernel's plan and walk, on the CPU (no card needed).

``ops.plan`` cuts a call into tiles of bags, chunks of each bag's ids, a ring
of shared-memory stages and a persistent grid; ``ops.walk`` lists each
block's units; ``ref.embedding_bag_tiled`` follows that walk in torch and
``ref.embedding_bag_seq_ref`` is the kernel's arithmetic (j in order, each
product and sum rounded on its own).  Here: the walk covers every (bag, id)
once and in j order, a plan fits the card's shared memory and SMs, the
tiled walk equals the sequential oracle bit for bit, and both match the JAX
package's ``embedding_bag`` (the Pallas kernel in interpret mode) and
``embedding_bag_ref`` within fp32 2e-5 and bf16 2e-2, as
``tests/test_torch_embedding_bag.py`` states (the orders of the fp32 sums
differ; bf16 rounds once at the end).  Inputs come from numpy seeds."""
import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.kernels.embedding_bag import embedding_bag as jax_embedding_bag
from repro.kernels.embedding_bag import embedding_bag_ref as jax_embedding_bag_ref
from repro_torch.convert import params_from_numpy
from repro_torch.kernels.embedding_bag import (
    embedding_bag_ref,
    embedding_bag_seq_ref,
    embedding_bag_tiled,
)
from repro_torch.kernels.embedding_bag import ops

TOLS = {"float32": 2e-5, "bfloat16": 2e-2}
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# (label, V, dim, n_bags, bag, combiner, weighted): the recsys models' bags at
# small sizes, FM's linear term (width 1), an odd width, empty bags, a bag
# longer than a stage, weighted bags of one (not the bags-of-one path), and
# rows of more pieces than the block has threads (wide tiles: fp32 at an odd
# width 257 copied a float a piece, and width 1,100 in pieces of four)
CASES = [
    ("fm fields", 400, 10, 40, 39, "sum", False),
    ("fm rows", 400, 10, 300, 1, "sum", False),
    ("fm linear", 400, 1, 40, 39, "sum", False),
    ("dcn-v2 rows", 500, 16, 260, 1, "sum", False),
    ("bst rows", 500, 32, 126, 1, "sum", False),
    ("sasrec history mean", 500, 50, 12, 50, "mean", True),
    ("sasrec rows", 500, 50, 120, 1, "sum", False),
    ("odd width", 77, 13, 20, 5, "sum", True),
    ("empty bags sum", 10, 6, 3, 0, "sum", False),
    ("empty bags mean", 10, 6, 3, 0, "mean", False),
    ("long bags", 300, 16, 3, 700, "sum", True),
    ("weighted bags of one", 100, 8, 50, 1, "mean", True),
    ("wide odd rows", 60, 257, 5, 39, "sum", True),
    ("wide rows mean", 60, 1100, 4, 9, "mean", False),
]
# how the plan is sized: as on the card (132 SMs, the default stages), and a few
# SMs with stages of 512 bytes, so that blocks walk many tiles and bags span
# stages: (SMs, stage bytes or None for the default)
SIZINGS = {"card": (ops.SMS, None), "small": (3, 512)}


@contextlib.contextmanager
def _stages(nbytes: int | None):
    """The plan's stage sizes (``ops.STAGE_BYTES``, ``ops.STAGE_BYTES_ONE``)
    set to ``nbytes`` for a while (None: left as they are)."""
    saved = ops.STAGE_BYTES, ops.STAGE_BYTES_ONE
    if nbytes is not None:
        ops.STAGE_BYTES = ops.STAGE_BYTES_ONE = nbytes
    try:
        yield
    finally:
        ops.STAGE_BYTES, ops.STAGE_BYTES_ONE = saved


def _vec(dim: int, itemsize: int) -> int:
    vec = 16 // itemsize
    while vec > 1 and dim % vec:
        vec //= 2
    return vec


def _plan(case, dtype: str, sizing: str) -> ops.Plan:
    _, V, dim, n_bags, bag, _, weighted = case
    itemsize = 4 if dtype == "float32" else 2
    sms, stage_bytes = SIZINGS[sizing]
    with _stages(stage_bytes):
        return ops.plan(n_bags, bag, dim, DTYPES[dtype], _vec(dim, itemsize),
                        weighted=weighted, sms=sms)


def _inputs(case, dtype: str, seed: int, bad_ids: bool):
    _, V, dim, n_bags, bag, _, weighted = case
    rng = np.random.default_rng(seed)
    jtable = jnp.asarray(rng.normal(size=(V, dim)), dtype)
    low = -V if bad_ids else 0
    ids = rng.integers(low, V, size=(n_bags, bag)).astype(np.int32)
    if bad_ids and ids.size >= 2:
        ids.flat[ids.size // 3] = V  # past the end
        ids.flat[2 * ids.size // 3] = -V - 1  # before the start
    w = rng.random((n_bags, bag)).astype(np.float32) if weighted else None
    table = params_from_numpy(np.asarray(jtable), "cpu")  # bit for bit, bf16 included
    return jtable, table, ids, w


def _f32(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


@pytest.mark.parametrize("sizing", sorted(SIZINGS))
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_plan_walk_covers_every_id_once_in_order(case, dtype, sizing):
    p = _plan(case, dtype, sizing)
    _, V, dim, n_bags, bag, _, weighted = case
    seen = {b: [] for b in range(n_bags)}
    owner = {}
    for block, units in ops.walk(p):
        for u in units:
            assert len(u.bags) <= p.tile_bags and len(u.ids) <= p.chunk_ids
            for b in u.bags:
                assert owner.setdefault(b, block) == block  # one block sums a bag
                seen[b].extend(u.ids)
    assert all(js == list(range(bag)) for js in seen.values())  # once each, j in order
    assert len(owner) == n_bags
    # the stages fit a block's shared memory, and the plan's blocks an SM's
    assert p.smem_bytes <= ops.SMEM_PER_BLOCK
    assert p.blocks_per_sm * (p.smem_bytes + ops.SMEM_RESERVED) <= ops.SMEM_PER_SM
    sms, stage_bytes = SIZINGS[sizing]
    assert 1 <= p.grid <= min(p.tiles, sms * p.blocks_per_sm)
    # a bag longer than a stage is cut into chunks carried across stages
    if stage_bytes is None:
        stage_bytes = ops.STAGE_BYTES_ONE if p.one else ops.STAGE_BYTES
    if bag * p.tile_bags * p.row_bytes > max(stage_bytes, p.tile_bags * p.row_bytes):
        assert p.chunks > 1
    assert p.one == (bag == 1 and not weighted)
    # a pair a thread, or a wide tile of one bag whose pairs the threads loop over
    pairs = dim // p.vec
    assert p.wide == (not p.one and p.tile_bags * pairs > ops.THREADS)
    assert p.tile_bags * pairs <= ops.THREADS or p.one or p.tile_bags == 1


@pytest.mark.parametrize("sizing", sorted(SIZINGS))
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_tiled_walk_equals_the_sequential_oracle_bit_for_bit(case, dtype, sizing):
    _, table, ids, w = _inputs(case, dtype, CASES.index(case), bad_ids=True)
    ids, w = torch.from_numpy(ids), (torch.from_numpy(w) if w is not None else None)
    combiner = case[5]
    tiled = embedding_bag_tiled(table, ids, w, combiner, _plan(case, dtype, sizing))
    exact = embedding_bag_seq_ref(table, ids, w, combiner)
    assert tiled.dtype == table.dtype and tiled.shape == (case[3], case[2])
    torch.testing.assert_close(tiled, exact, atol=0, rtol=0, equal_nan=True)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_tiled_walk_and_oracle_match_the_reference(case, dtype):
    """In-range ids against the Pallas kernel (interpret mode; it has no
    grid step for an empty bag) and ``embedding_bag_ref``; ids past either
    end, and negative ids, against ``embedding_bag_ref``, which fills NaN as
    ``jnp.take`` does."""
    combiner, tol = case[5], TOLS[dtype]
    for bad_ids in (False, True):
        jtable, table, ids, w = _inputs(case, dtype, 100 + CASES.index(case), bad_ids)
        tw = torch.from_numpy(w) if w is not None else None
        jw = jnp.asarray(w) if w is not None else None
        got = [embedding_bag_tiled(table, torch.from_numpy(ids), tw, combiner,
                                   _plan(case, dtype, "small")),
               embedding_bag_seq_ref(table, torch.from_numpy(ids), tw, combiner)]
        wants = [jax_embedding_bag_ref(jtable, jnp.asarray(ids), jw, combiner=combiner)]
        if not bad_ids and case[4] > 0:
            wants.append(jax_embedding_bag(jtable, jnp.asarray(ids), jw, combiner=combiner,
                                           interpret=True))
        for g in got:
            for want in wants:
                np.testing.assert_allclose(_f32(g), _f32(want), atol=tol, rtol=tol)
            np.testing.assert_allclose(
                _f32(g), _f32(embedding_bag_ref(table, torch.from_numpy(ids), tw, combiner)),
                atol=tol, rtol=tol)


# the serving path's launches at serve_bulk (B 262,144; PERF.md §6): FM's field
# sums, its linear term and its rows(); DCN-v2's, BST's and SASRec's bags of one
MAIN_PATH = [
    ("fm fields", 262_144, 39, 10),
    ("fm linear", 262_144, 39, 1),
    ("fm rows", 262_144 * 39, 1, 10),
    ("dcn-v2 rows", 262_144 * 26, 1, 16),
    ("bst rows", 262_144 * 21, 1, 32),
    ("sasrec rows", 262_144 * 50, 1, 50),
]


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", MAIN_PATH, ids=[m[0] for m in MAIN_PATH])
def test_plan_fills_the_card_at_the_main_path_shapes(shape, dtype):
    _, n_bags, bag, dim = shape
    itemsize = 4 if dtype == "float32" else 2
    p = ops.plan(n_bags, bag, dim, DTYPES[dtype], _vec(dim, itemsize))
    assert p.grid == ops.SMS * p.blocks_per_sm  # persistent: every SM takes blocks
    assert p.smem_bytes <= ops.SMEM_PER_BLOCK
    if p.one:  # the staged rows are the output tile: whole 16-byte pieces
        assert (p.tile_bags * p.row_bytes) % 16 == 0
    else:  # a (bag, chunk) pair a thread: as many as fit, up to MAX_TILE_BAGS bags
        pairs = p.tile_bags * (dim // p.vec)
        assert pairs <= ops.THREADS
        assert p.tile_bags == ops.MAX_TILE_BAGS or pairs >= 0.9 * ops.THREADS
    assert p.stage_bytes <= (ops.STAGE_BYTES_ONE if p.one else ops.STAGE_BYTES)
    assert p.blocks_per_sm * (p.smem_bytes + ops.SMEM_RESERVED) <= ops.SMEM_BUDGET


def test_plan_refuses_what_the_kernel_cannot_take():
    wide = ops.plan(8, 4, 257, torch.float32, 1)  # 257 pieces a row: a wide tile of one bag
    assert wide.wide and wide.tile_bags == 1
    misaligned = ops.plan(1000, 39, 512, torch.float32, 1)  # a view that allows 4-byte pieces
    assert misaligned.wide and misaligned.chunks > 1
    assert misaligned.smem_bytes <= ops.SMEM_PER_BLOCK
    assert ops.plan(8, 40, 14_520, torch.float32, 4, weighted=True).wide
    with pytest.raises(ValueError, match="does not fit"):  # two stages, the row and its sums
        ops.plan(8, 40, 14_524, torch.float32, 4, weighted=True)
    with pytest.raises(ValueError, match="no plan"):
        ops.plan(8, 4, 10, torch.float32, 4)  # 4 elements a piece do not divide 10
    with pytest.raises(TypeError, match="fp32 or bf16"):
        ops.plan(8, 4, 16, torch.float16, 4)
    assert ops.plan(8, 4, 1024, torch.float32, 4).tile_bags == 1  # 256 pieces: a bag a tile
