"""Wrapper of the hand-written embedding-bag kernels
(``csrc/embedding_bag.cu``), with the reference wrapper's signature, and the
static plan of the forward kernel's walk.

A table on the CPU goes to the plain version (:func:`embedding_bag_ref`),
which autograd differentiates.  A table on a CUDA device goes to the
kernels, or the wrapper raises: there is no fallback.  With grad mode on and
a table that requires grad, the call goes through a
``torch.autograd.Function``: the forward kernel, then one launch of the
backward kernel (:func:`embedding_bag_bwd`), which writes the dense table
gradient over a reverse index sorted on the card (:func:`bwd_index`),
deterministically and with no float atomics.  The gradient goes to the
table only: weights are constants, and a CUDA ``weights`` that requires
grad is refused.  A table on the ``meta`` device (the dry-run) takes an
explicit shape-only path through the same functions: the outputs, the
backward's sort buffers, dense fill, tickets and partials as meta tensors,
each launch's FLOPs and bytes reported to :mod:`repro_torch.kernels.meta`
in its place, and no launch.

The reference pads the width to 128 TPU lanes; here the forward kernel
takes any width whose row fits its shared memory (two stages of one row,
the output row and, for a bag cut into chunks, the row's fp32 sums: up to
14,520 fp32 or 23,232 bf16 columns), and the backward any width whose
chunk of 32 positions does (:func:`bwd_chunk`), so nothing is padded.

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

from .. import build, meta
from .ref import bwd_index, embedding_bag_bwd_ref, embedding_bag_ref

__all__ = ["Plan", "Unit", "bwd_chunk", "bwd_index", "embedding_bag", "embedding_bag_bwd",
           "embedding_bag_ref", "launch", "launch_bwd", "plan", "reset_launches", "walk"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_COMBINERS = ("sum", "mean")
_fn = None
_fn_bwd = None

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
    if device.type == "meta":
        return meta.SMS
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _sm_counts:
        _sm_counts[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return _sm_counts[index]


def _check(table: torch.Tensor, ids: torch.Tensor, weights: torch.Tensor | None,
           combiner: str, name: str = "table") -> None:
    """The kernels' checks; ``table`` is the table (forward) or the output's
    gradient ``dout`` [n_bags, dim] (backward, ``name`` "dout")."""
    if table.device.type not in ("cuda", "meta"):
        raise ValueError(f"embedding_bag: unsupported device {table.device}")
    if combiner not in _COMBINERS:
        raise ValueError(f"embedding_bag: combiner must be 'sum' or 'mean', got {combiner!r}")
    if table.dtype not in _DTYPES:
        raise TypeError(f"embedding_bag: {name} must be fp32 or bf16, got {table.dtype}")
    if ids.dtype != torch.int32:
        raise TypeError(f"embedding_bag: ids must be int32, got {ids.dtype}")
    if table.dim() != 2 or ids.dim() != 2 or table.shape[0] == 0:
        raise ValueError(
            f"embedding_bag: shapes {name} {tuple(table.shape)}, ids {tuple(ids.shape)} are "
            "not [V>0, dim] and [n_bags, bag_size]"
        )
    if table.shape[0] >= 2**31:
        raise ValueError(f"embedding_bag: {table.shape[0]} table rows; the kernel takes < 2^31")
    tensors = [("ids", ids)] + ([("weights", weights)] if weights is not None else [])
    for tname, t in tensors:
        if t.device != table.device:
            raise ValueError(f"embedding_bag: {tname} on {t.device}, {name} on {table.device}")
    if weights is not None:
        if weights.dtype != torch.float32:
            raise TypeError(f"embedding_bag: weights must be fp32, got {weights.dtype}")
        if weights.shape != ids.shape:
            raise ValueError(
                f"embedding_bag: weights {tuple(weights.shape)} differ from ids {tuple(ids.shape)}"
            )
    if not all(t.is_contiguous() for _, t in [(name, table)] + tensors):
        raise ValueError(f"embedding_bag: {name}, ids and weights must be contiguous")


def launch(table: torch.Tensor, ids: torch.Tensor, weights: torch.Tensor | None, combiner: str,
           p: Plan, out: torch.Tensor) -> torch.Tensor:
    """One launch of the kernel on ``p`` (checked inputs on the card) into
    ``out``; counts it in ``embedding_bag.launches``.  On meta tensors it
    records the call's count instead: each id's row read once, the ids (and
    weights) read, the output written; one add (and a multiply, weighted)
    an element of a row, in fp32 on the CUDA cores."""
    if table.device.type == "meta":  # the dry-run: no launch
        n_ids, weighted = p.n_bags * p.bag, weights is not None
        nbytes = (n_ids * p.row_bytes + n_ids * 4 * (2 if weighted else 1)
                  + p.n_bags * p.row_bytes)
        meta.record("embedding_bag", (2 if weighted else 1) * n_ids * p.dim, nbytes, "fp32")
        return out
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


def _forward(table: torch.Tensor, ids: torch.Tensor, weights: torch.Tensor | None,
             combiner: str) -> torch.Tensor:
    """One launch of the forward kernel on checked inputs."""
    n_bags, bag = ids.shape
    dim = table.shape[1]
    out = torch.empty(n_bags, dim, dtype=table.dtype, device=table.device)
    if n_bags == 0 or dim == 0:
        return out
    vec = build.vector_width(dim, table.element_size(), table, out)
    p = plan(n_bags, bag, dim, table.dtype, vec, weighted=weights is not None,
             sms=_sms(table.device))
    return launch(table, ids, weights, combiner, p, out)


# --------------------------------------------------------------------------
# backward
# --------------------------------------------------------------------------
# the backward kernel's constants (csrc/embedding_bag.cu)
BWD_THREADS = 256  # kBwdThreads: a block takes a chunk of at most this many positions
BWD_TERM_BYTES = 64 * 1024  # the fp32 terms of a chunk, staged in shared memory
BWD_STATIC_SMEM = 72  # the kernel's static shared memory: per-warp counts, two keys


def bwd_chunk(dim: int) -> int:
    """Positions of the sorted list a block of the backward kernel takes at
    width ``dim``: BWD_THREADS, or fewer (a multiple of 32, at least 32) so
    that the chunk's fp32 terms fit about BWD_TERM_BYTES."""
    return max(32, min(BWD_THREADS, BWD_TERM_BYTES // (4 * max(dim, 1)) // 32 * 32))


def bwd_smem_bytes(chunk: int, dim: int) -> int:
    """The shared memory the backward kernel carves (``bwd_carve`` in the
    source): the chunk's fp32 terms, its keys, bags and weights, and the
    first position of each of its runs."""
    return _align(chunk * dim * 4 + 3 * chunk * 4 + (chunk + 1) * 4, 16)


def _kernel_bwd():
    global _fn_bwd
    if _fn_bwd is None:
        fn = build.load("embedding_bag").embedding_bag_bwd_launch
        fn.argtypes = (
            [ctypes.c_void_p] * 7
            + [ctypes.c_longlong, ctypes.c_longlong]
            + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
        _fn_bwd = fn
    return _fn_bwd


def launch_bwd(key: torch.Tensor, pos: torch.Tensor, dout: torch.Tensor,
               weights: torch.Tensor | None, combiner: str, bag: int, dtable: torch.Tensor,
               tickets: torch.Tensor) -> torch.Tensor:
    """One launch of the backward kernel (checked inputs on the card) over
    the reverse index (key, pos) of :func:`bwd_index`: writes every row of
    ``dtable`` that an id reads (the others are left as they are) and counts
    the launch in ``embedding_bag.launches_bwd``.  ``tickets`` (one int32 a
    chunk) must be 0; the kernel leaves them 0, so they serve the next
    launch too."""
    n = key.numel()
    V, dim = dtable.shape
    chunk = bwd_chunk(dim)
    n_chunks = -(-n // chunk)
    smem = bwd_smem_bytes(chunk, dim)
    if smem + BWD_STATIC_SMEM > SMEM_PER_BLOCK:
        raise ValueError(f"embedding_bag: no backward at width {dim}: a chunk of {chunk} "
                         f"positions takes {smem} bytes of shared memory")
    if tickets.numel() < n_chunks or tickets.dtype != torch.int32:
        raise ValueError(f"embedding_bag: {n_chunks} int32 tickets wanted")
    partial = torch.empty(n_chunks * 2 * dim, dtype=torch.float32, device=dtable.device)
    if dtable.device.type == "meta":  # the dry-run: no launch
        # the sorted index, dout and the weights read, dtable's rows written
        # (the dense fill before the launch is its own op); an add (and a
        # multiply, weighted) an element of each position's row, in fp32
        weighted = weights is not None
        nbytes = n * 8 + dout.numel() * dout.element_size() + (n * 4 if weighted else 0)
        nbytes += min(n, V) * dim * dtable.element_size()
        meta.record("embedding_bag_bwd", (2 if weighted else 1) * n * dim, nbytes, "fp32")
        return dtable
    vec = build.vector_width(dim, dtable.element_size(), dout, dtable)
    stream = torch.cuda.current_stream(dtable.device).cuda_stream
    with torch.cuda.device(dtable.device):
        err = _kernel_bwd()(
            key.data_ptr(), pos.data_ptr(), dout.data_ptr(),
            weights.data_ptr() if weights is not None else None, dtable.data_ptr(),
            partial.data_ptr(), tickets.data_ptr(),
            V, n, bag, dim, int(combiner == "mean"), vec, _DTYPES[dtable.dtype], chunk, smem,
            stream,
        )
    if err != 0:
        raise RuntimeError(f"embedding_bag backward kernel launch failed: CUDA error {err}")
    embedding_bag.launches_bwd += 1
    return dtable


def embedding_bag_bwd(
    V: int,  # table rows
    ids: torch.Tensor,  # [n_bags, bag_size] int32
    weights: torch.Tensor | None,  # [n_bags, bag_size] fp32; None: ones
    dout: torch.Tensor,  # [n_bags, dim], the output's gradient, in the table's dtype
    combiner: str = "sum",
) -> torch.Tensor:
    """The table's gradient [V, dim] in ``dout``'s dtype (the weights get
    none): ``dtable[v]`` is the sum over the positions (b, j) with
    ``ids[b, j] = v`` of ``w[b, j] * dout[b]`` (``dout[b] / bag`` for
    "mean"), accumulated in fp32; an id in [-V, 0) counts from the end, and
    an id outside [-V, V) adds nothing.  On the card: the reverse index
    (:func:`bwd_index`, a stable sort), a zeroed ``dtable``, and one launch
    of the backward kernel, whose sums are :func:`embedding_bag_bwd_seq_ref`
    bit for bit.  On the CPU: :func:`embedding_bag_bwd_ref`."""
    if dout.device.type == "cpu":
        return embedding_bag_bwd_ref(V, ids, weights, dout, combiner)
    _check(dout, ids, weights, combiner, name="dout")
    if weights is not None and weights.requires_grad:
        raise ValueError(_WEIGHTS_GRAD)
    n_bags, bag = ids.shape
    if dout.shape[0] != n_bags:
        raise ValueError(f"embedding_bag: dout {tuple(dout.shape)} has not one row a bag of "
                         f"ids {tuple(ids.shape)}")
    if not 0 < V < 2**31 or ids.numel() >= 2**31:
        raise ValueError(f"embedding_bag: backward of {ids.numel()} ids over {V} rows; the "
                         "kernel takes fewer than 2^31 of each")
    dim = dout.shape[1]
    dtable = torch.zeros(V, dim, dtype=dout.dtype, device=dout.device)
    if ids.numel() == 0 or dim == 0:
        return dtable
    key, pos = bwd_index(ids, V)
    tickets = torch.zeros(-(-ids.numel() // bwd_chunk(dim)), dtype=torch.int32,
                          device=dout.device)
    return launch_bwd(key, pos, dout, weights, combiner, bag, dtable, tickets)


_WEIGHTS_GRAD = ("embedding_bag: the gradient goes to the table only; weights that require "
                 "grad are refused on the card (pass weights.detach())")


class _EmbeddingBag(torch.autograd.Function):
    """The forward kernel, and the backward kernel for the table."""

    @staticmethod
    def forward(ctx, table, ids, weights, combiner):
        ctx.save_for_backward(ids, weights)
        ctx.rows, ctx.combiner = table.shape[0], combiner
        return _forward(table, ids, weights, combiner)

    @staticmethod
    def backward(ctx, dout):
        ids, weights = ctx.saved_tensors
        dtable = embedding_bag_bwd(ctx.rows, ids, weights, dout.contiguous(), ctx.combiner)
        return dtable, None, None, None


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
    [-V, V) makes its bag's row NaN.  Differentiable in the table only: on
    the card, with grad mode on and a table that requires grad, the backward
    kernel gives the table's gradient (:func:`embedding_bag_bwd`); weights
    are constants there, and weights that require grad are refused.  Under
    ``torch.no_grad`` the call launches the forward kernel alone."""
    if table.device.type == "cpu":
        return embedding_bag_ref(table, ids, weights, combiner)
    _check(table, ids, weights, combiner)
    if torch.is_grad_enabled():
        if weights is not None and weights.requires_grad:
            raise ValueError(_WEIGHTS_GRAD)
        if table.requires_grad:
            return _EmbeddingBag.apply(table, ids, weights, combiner)
    return _forward(table, ids, weights, combiner)


# Kernel launches that reached the card, and nowhere else: forward launches
# (``launches``) and backward launches (``launches_bwd``).  Callers that prove
# a path went through the kernels reset them (reset_launches) and read them.
def reset_launches() -> None:
    embedding_bag.launches = 0
    embedding_bag.launches_bwd = 0


reset_launches()
