"""Wrapper of the hand-written embedding-bag kernel
(``csrc/embedding_bag.cu``), with the reference wrapper's signature, and the
static plan of the kernel's walk.

A table on the CPU goes to the plain version (:func:`embedding_bag_ref`).  A
table on a CUDA device goes to the kernel, or the wrapper raises: there is no
fallback.  The reference pads the width to 128 TPU lanes; here the kernel
takes any width whose row fits its shared memory (two stages of one row,
the output row and, for a bag cut into chunks, the row's fp32 sums: up to
14,520 fp32 or 23,232 bf16 columns), so nothing is padded.

:func:`plan` computes, from static shapes only, how the kernel cuts the work:
tiles of consecutive bags, each bag's ids cut into chunks so that a unit (one
chunk of one tile) fits a shared-memory stage, a ring of stages, and a
persistent grid.  :func:`walk` lists the units each block takes, in order;
``ref.embedding_bag_tiled`` follows it on the CPU.
"""
from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Iterator, NamedTuple

import torch

from .. import build
from .ref import embedding_bag_ref

__all__ = ["Plan", "Unit", "embedding_bag", "embedding_bag_ref", "launch", "plan", "walk"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_COMBINERS = ("sum", "mean")
_fn = None

# the kernel's constants (csrc/embedding_bag.cu)
THREADS = 256  # kThreads
STAGES = 2  # kStages: one stage summed while the next one's rows arrive
BLOCKS_PER_SM = 3  # kMinBlocks: __launch_bounds__ keeps the registers for three
# H100: 228 KB of shared memory an SM, 227 KB a block, 1 KB the runtime's own
# per block; 132 SMs
SMEM_PER_SM = 233_472
SMEM_PER_BLOCK = 232_448
SMEM_RESERVED = 1_024
SMS = 132
# what the plan aims at: stages of about 32 KB for sums and 16 KB for bags of
# one, three blocks an SM, so that an SM keeps 48 to 96 KB of rows coming
# (3.35 TB/s times a microsecond is 25 KB an SM).  On the H100 a sum's time
# grew with the units a tile takes (PERF.md, PR 22), so the stages are as
# large as three blocks allow.
STAGE_BYTES = 32 * 1024
STAGE_BYTES_ONE = 16 * 1024
MAX_STAGE_ROWS = 2048  # bounds the ids kept beside a stage
MAX_TILE_BAGS = 128  # sums: fewer, longer chunks ran FM's width-1 linear term faster
# the shared memory the plan's blocks may take of an SM: the rest stays L1,
# which the 4- and 8-byte copies go through (plans that left it near 13 KB
# slowed FM's rows())
SMEM_BUDGET = 210 * 1024


@dataclasses.dataclass(frozen=True)
class Plan:
    """How the kernel walks one call (every field follows from the shapes,
    the copy width and the SM count)."""

    n_bags: int
    bag: int  # ids per bag
    dim: int
    itemsize: int  # bytes of a table element
    vec: int  # elements per copied piece: the copy width
    weighted: bool
    tile_bags: int  # bags per tile
    chunk_ids: int  # ids of each bag per unit (0 for bags of 0)
    chunks: int  # units per tile: each bag's ids in chunks of chunk_ids
    one: bool  # bags of one without weights: the staged rows are the output
    tiles: int
    grid: int  # persistent blocks
    blocks_per_sm: int
    smem_bytes: int

    @property
    def row_bytes(self) -> int:
        return self.dim * self.itemsize

    @property
    def copy_bytes(self) -> int:
        return self.vec * self.itemsize

    @property
    def wide(self) -> bool:
        """More (bag, vector chunk) pairs in a tile than the block has
        threads: each thread loops over pairs, and a sum carried across
        chunks waits in shared memory."""
        return not self.one and self.tile_bags * (self.dim // self.vec) > THREADS

    @property
    def stage_ids(self) -> int:
        """Row slots of a stage: ids gathered per unit."""
        return self.tile_bags * self.chunk_ids

    @property
    def stage_bytes(self) -> int:
        return _align(self.stage_ids * self.row_bytes, 16)


def _align(x: int, a: int) -> int:
    return -(-x // a) * a


def _smem_bytes(tb: int, ic: int, bag: int, dim: int, itemsize: int, pairs: int,
                weighted: bool, one: bool) -> int:
    """The shared memory the kernel carves (``carve`` in the source): the
    stages, 2 * STAGES - 1 slots of ids (and of weights), the output tile,
    and a wide tile's fp32 sums carried across chunks."""
    row = dim * itemsize
    k = 1 if bag == 0 else -(-bag // ic)
    idp = _align(tb * bag + 3, 4) if k == 1 else tb * _align(ic + 3, 4)
    n = STAGES * _align(tb * ic * row, 16) + (2 * STAGES - 1) * idp * 4 * (2 if weighted else 1)
    if not one:
        n += _align(tb * row, 16)
        if tb * pairs > THREADS and k > 1:
            n += _align(tb * dim * 4, 16)
    return n


def _balanced(bag: int, cap: int) -> int:
    """Ids per chunk: at most ``cap``, the chunks of a bag as even as can be."""
    return -(-bag // -(-bag // cap))


def plan(n_bags: int, bag: int, dim: int, dtype: torch.dtype, align: int, *,
         weighted: bool = False, sms: int = SMS) -> Plan:
    """The kernel's plan for ``n_bags`` bags of ``bag`` ids over a table of
    width ``dim``, copied ``align`` elements a piece (``build.vector_width``).

    A tile holds enough bags that its (bag, vector chunk) pairs fill the
    block's threads, up to MAX_TILE_BAGS (bags of one: enough rows for a
    stage), rounded so that its output is a whole number of 16-byte pieces
    where that costs under a tenth of the lanes, and fewer where the tiles
    would not give every block the SMs can hold one; a row of more pairs
    than threads takes a tile alone.  Each bag's ids are cut into even
    chunks so that a unit fits a stage of about STAGE_BYTES (STAGE_BYTES_ONE
    for bags of one); the ring has
    STAGES stages; the grid is at most the SMs times the blocks whose shared
    memory fits on one within SMEM_BUDGET."""
    if dtype not in _DTYPES:
        raise TypeError(f"embedding_bag: table must be fp32 or bf16, got {dtype}")
    itemsize = 4 if dtype == torch.float32 else 2
    row = dim * itemsize
    if n_bags <= 0 or dim <= 0 or bag < 0 or align <= 0 or dim % align:
        raise ValueError(f"embedding_bag: no plan for {n_bags} bags of {bag} at width {dim}, "
                         f"{align} elements a piece")
    pairs = dim // align  # vector chunks of a row: (bag, chunk) pairs per bag
    one = bag == 1 and not weighted
    stage_bytes = STAGE_BYTES_ONE if one else STAGE_BYTES
    m16 = 16 // math.gcd(16, row)  # bags whose output is a whole number of 16-byte pieces
    if one:
        tb = max(1, min(stage_bytes // row, MAX_STAGE_ROWS))
        if tb >= m16:
            tb -= tb % m16
    else:
        tb = max(1, min(THREADS // pairs, MAX_TILE_BAGS))
        if tb >= m16 and (tb - tb % m16) * 10 >= tb * 9:
            tb -= tb % m16
    if -(-n_bags // tb) < sms * BLOCKS_PER_SM:
        tb = max(1, -(-n_bags // (sms * BLOCKS_PER_SM)))
    if bag == 0:
        ic = 0
    elif one:
        ic = 1
    else:
        ic = _balanced(bag, max(1, min(stage_bytes // (tb * row), MAX_STAGE_ROWS // tb)))
    while (smem := _smem_bytes(tb, ic, bag, dim, itemsize, pairs, weighted, one)) > SMEM_PER_BLOCK:
        if ic > 1:
            ic = _balanced(bag, ic // 2)
        elif tb > 1:
            tb = max(1, tb // 2)
        else:
            raise ValueError(f"embedding_bag: a row of {row} bytes does not fit {STAGES} stages")
    chunks = 1 if bag == 0 else -(-bag // ic)
    blocks = max(1, min(BLOCKS_PER_SM, SMEM_BUDGET // (smem + SMEM_RESERVED)))
    tiles = -(-n_bags // tb)
    return Plan(n_bags=n_bags, bag=bag, dim=dim, itemsize=itemsize, vec=align,
                weighted=weighted, tile_bags=tb, chunk_ids=ic, chunks=chunks, one=one,
                tiles=tiles, grid=min(tiles, sms * blocks), blocks_per_sm=blocks,
                smem_bytes=smem)


class Unit(NamedTuple):
    """One unit of a block's walk: chunk ``chunk`` of tile ``tile``."""

    tile: int
    chunk: int
    bags: range  # the tile's bags
    ids: range  # the positions j, in each of those bags, that the unit gathers


def walk(p: Plan) -> Iterator[tuple[int, list[Unit]]]:
    """(block, its units in the order it takes them) for every block of the
    grid: tiles blockIdx, blockIdx + grid, ..., and in each tile its chunks
    in j order."""
    for b in range(p.grid):
        units = []
        for t in range(b, p.tiles, p.grid):
            bags = range(t * p.tile_bags, min(p.n_bags, (t + 1) * p.tile_bags))
            for k in range(p.chunks):
                units.append(Unit(t, k, bags, range(k * p.chunk_ids,
                                                    min(p.bag, (k + 1) * p.chunk_ids))))
        yield b, units


def _kernel():
    global _fn
    if _fn is None:
        fn = build.load("embedding_bag").embedding_bag_launch
        fn.argtypes = (
            [ctypes.c_void_p] * 4
            + [ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong]
            + [ctypes.c_int] * 10 + [ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


_sm_counts: dict[int, int] = {}


def _sms(device: torch.device) -> int:
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _sm_counts:
        _sm_counts[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return _sm_counts[index]


def _check(table: torch.Tensor, ids: torch.Tensor, weights: torch.Tensor | None,
           combiner: str) -> None:
    if table.device.type != "cuda":
        raise ValueError(f"embedding_bag: unsupported device {table.device}")
    if combiner not in _COMBINERS:
        raise ValueError(f"embedding_bag: combiner must be 'sum' or 'mean', got {combiner!r}")
    if table.dtype not in _DTYPES:
        raise TypeError(f"embedding_bag: table must be fp32 or bf16, got {table.dtype}")
    if ids.dtype != torch.int32:
        raise TypeError(f"embedding_bag: ids must be int32, got {ids.dtype}")
    if table.dim() != 2 or ids.dim() != 2 or table.shape[0] == 0:
        raise ValueError(
            f"embedding_bag: shapes table {tuple(table.shape)}, ids {tuple(ids.shape)} are "
            "not [V>0, dim] and [n_bags, bag_size]"
        )
    if table.shape[0] >= 2**31:
        raise ValueError(f"embedding_bag: {table.shape[0]} table rows; the kernel takes < 2^31")
    tensors = [("ids", ids)] + ([("weights", weights)] if weights is not None else [])
    for name, t in tensors:
        if t.device != table.device:
            raise ValueError(f"embedding_bag: {name} on {t.device}, table on {table.device}")
    if weights is not None:
        if weights.dtype != torch.float32:
            raise TypeError(f"embedding_bag: weights must be fp32, got {weights.dtype}")
        if weights.shape != ids.shape:
            raise ValueError(
                f"embedding_bag: weights {tuple(weights.shape)} differ from ids {tuple(ids.shape)}"
            )
    if not all(t.is_contiguous() for _, t in [("table", table)] + tensors):
        raise ValueError("embedding_bag: table, ids and weights must be contiguous")


def launch(table: torch.Tensor, ids: torch.Tensor, weights: torch.Tensor | None, combiner: str,
           p: Plan, out: torch.Tensor) -> torch.Tensor:
    """One launch of the kernel on ``p`` (checked inputs on the card) into
    ``out``; counts it in ``embedding_bag.launches``."""
    stream = torch.cuda.current_stream(table.device).cuda_stream
    with torch.cuda.device(table.device):
        err = _kernel()(
            table.data_ptr(), ids.data_ptr(),
            weights.data_ptr() if weights is not None else None, out.data_ptr(),
            table.shape[0], p.dim, p.n_bags, p.bag, int(combiner == "mean"), p.vec,
            _DTYPES[table.dtype], p.tile_bags, p.chunk_ids, int(p.one),
            p.grid, p.blocks_per_sm, p.smem_bytes, stream,
        )
    if err != 0:
        raise RuntimeError(f"embedding_bag kernel launch failed: CUDA error {err}")
    embedding_bag.launches += 1
    return out


def embedding_bag(
    table: torch.Tensor,  # [V, dim]
    ids: torch.Tensor,  # [n_bags, bag_size] int32
    weights: torch.Tensor | None = None,  # [n_bags, bag_size] fp32; None: ones
    *,
    combiner: str = "sum",
) -> torch.Tensor:
    """Per bag, the weighted sum of its rows (``"mean"``: divided by
    bag_size), accumulated in fp32.  Returns [n_bags, dim] in the table's
    dtype.  A negative id in [-V, 0) counts from the end; an id outside
    [-V, V) makes its bag's row NaN."""
    if table.device.type == "cpu":
        return embedding_bag_ref(table, ids, weights, combiner)
    _check(table, ids, weights, combiner)
    n_bags, bag = ids.shape
    dim = table.shape[1]
    out = torch.empty(n_bags, dim, dtype=table.dtype, device=table.device)
    if n_bags == 0 or dim == 0:
        return out
    vec = build.vector_width(dim, table.element_size(), table, out)
    p = plan(n_bags, bag, dim, table.dtype, vec, weighted=weights is not None,
             sms=_sms(table.device))
    return launch(table, ids, weights, combiner, p, out)


# kernel launches: one per call that reached the card, and nowhere else.
# Callers that prove a path went through the kernel set it to 0 and read it.
embedding_bag.launches = 0
