"""Wrappers of the hand-written decode-attention kernels
(``csrc/decode_attention.cu``), with the model functions' signatures.

Three variants; :func:`variant` names the one that takes the model's cached
attention call of a shape, from static shapes before any launch:

* ``"fused"``: one query row (S = 1) and at most 16 rows per KV head.  One
  launch writes the step's K/V row into the cache and attends (bf16 on the
  tensor cores); :func:`plan_fused` sizes its grid to the card, each block
  takes its share of the live keys (:func:`fused_partition`, on the card
  from ``q_start``), and the splits combine inside a thread-block cluster
  and, past one cluster, through a workspace the last block of a KV head
  reads.  ``decode_step`` takes it through :func:`decode_attention_chunk`
  (alias :func:`decode_attention_insert`).
* ``"chunk"``: S > 1 query rows in bf16, the head dim padded to 16 at most
  256 (dh 16 and up) and a GQA group dividing 64.  One launch writes the
  chunk's K/V rows into the cache and attends with ``wgmma``; a cluster of
  :func:`plan_chunk` blocks shares each 64-row tile's keys.
  ``prefill_chunk`` takes it through :func:`decode_attention_chunk`.
* ``"split"`` (:func:`decode_attention`, at any S >= 1 and any GQA group):
  a split kernel over KV splits, then a combine kernel: two launches a call.
  :func:`decode_attention_chunk` takes it, after two index writes of the new
  rows, for what the other two do not take: fp32 chunks (the exact parity
  path), dh 8, groups that do not divide 64, and more than 16 rows per KV
  head at S = 1.

A tensor on the CPU goes to the plain version
(:mod:`repro_torch.models.attention`).  A CUDA tensor goes to a kernel, or
the wrapper raises: there is no fallback.  A tensor on the ``meta`` device
(the dry-run) takes an explicit shape-only path: the variant's outputs and
scratch (the split variant's partials, planned for the H100's SMs) as meta
tensors (the fused variant's workspace and tickets too), the call's FLOPs
and bytes reported to
:mod:`repro_torch.kernels.meta`, and no launch.  The valid lengths are
values a meta tensor does not hold, so the count takes every key of the
cache, as ``model_flops`` does for a decode step.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ...models.attention import decode_attention as decode_attention_plain
from ...models.attention import decode_attention_chunk as decode_attention_chunk_plain
from ...models.attention import insert_chunk
from .. import build, meta

__all__ = [
    "count_replays", "decode_attention", "decode_attention_chunk", "decode_attention_chunk_plain",
    "decode_attention_insert", "decode_attention_plain", "fused_blocks_per_sm", "fused_partition",
    "fused_tile", "fused_workspace_floats", "plan", "plan_chunk", "plan_fused", "reset_launches",
    "variant",
]

_WARPS, _ROWS_PER_WARP = 4, 4  # must match kWarps / kRowsPerWarp in the source
_ROWS = _WARPS * _ROWS_PER_WARP
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
VARIANTS = ("split", "fused", "chunk")
KERNELS_PER_CALL = {"split": 2, "fused": 1, "chunk": 1}  # split: the split and the combine kernel
FUSED_MAX_G = 16  # query rows per KV head that one fused block holds
MAX_CLUSTER = 8  # the portable cluster size: blocks of a fused or a chunk cluster
FUSED_THREADS = 128  # threads of a fused block (kFusedThreads)
FUSED_STAGES = 3  # K/V tiles in a fused block's ring (kFusedStages)
FUSED_SPLIT_KEYS = 64  # the fewest keys of the static T a fused split is planned for
CLUSTER_SPLIT_KEYS = 1024  # ... when the splits span more than one cluster
FUSED_TICKETS = 65_535  # one ticket a (b, KV head): the launch's most B * Hkv
# an H100 SM: shared memory its blocks share, the part each block reserves,
# and threads; a fused block's static shared memory (the combine's flag) as
# allocated
SM_SMEM_BYTES, BLOCK_SMEM_RESERVED, SM_THREADS = 233_472, 1_024, 2_048
FUSED_STATIC_SMEM = 128
CHUNK_ROWS = 64  # query rows of a chunk block (one wgmma tile): G must divide it
CHUNK_KEYS = 64  # keys of a chunk block's tile
_fns: dict[str, object] = {}


def _kernel(name: str):
    fn = _fns.get(name)
    if fn is None:
        lib = build.load("decode_attention")
        if name in ("fused", "chunk"):
            init = getattr(lib, f"decode_attention_{name}_init")
            init.restype = ctypes.c_int
            err = init()  # the shared-memory limit of the variant's kernels, once
            if err == -1:  # the chunk kernels' check of their largest cluster
                raise RuntimeError(
                    f"decode_attention chunk init: a cluster of {MAX_CLUSTER} chunk blocks "
                    "cannot be placed on this device at the kernels' shared memory")
            if err != 0:
                raise RuntimeError(f"decode_attention {name} init failed: CUDA error {err}")
            fn = getattr(lib, f"decode_attention_{name}_launch")
            n_ptr, n_int = (9, 10) if name == "fused" else (7, 8)
            fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [ctypes.c_void_p]
        else:
            fn = lib.decode_attention_launch
            fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 11 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def variant(S: int, G: int, dh: int, dtype: torch.dtype) -> str:
    """The kernel that takes a call that writes its new K/V rows and
    attends: ``"fused"`` for one query row (S = 1) with G <= 16 rows per KV
    head; ``"chunk"`` for S > 1 in bf16 with dh from 16 to 256 and G
    dividing 64; ``"split"`` for the rest (fp32 chunks, dh 8, other
    groups).  All need fp32 or bf16 and a head dim that is a multiple of 8
    up to 256.  Raises for what no kernel takes."""
    if dtype not in _DTYPES:
        raise TypeError(f"decode_attention: no kernel for {dtype}; fp32 or bf16")
    if dh <= 0 or dh > 256 or dh % 8:
        raise ValueError(f"decode_attention: head dim {dh} must be a multiple of 8 up to 256")
    if S <= 0 or G <= 0:
        raise ValueError(f"decode_attention: S={S} query rows and G={G} must be positive")
    if S == 1:
        return "fused" if G <= FUSED_MAX_G else "split"
    # dh 8 stays split: a 64-column wgmma tile would be seven eighths padding
    if dtype == torch.bfloat16 and dh >= 16 and CHUNK_ROWS % G == 0:
        return "chunk"
    return "split"


def plan(B: int, S: int, Hq: int, Hkv: int, T: int, dh: int, n_sm: int) -> tuple[int, int, int]:
    """Split variant: (key tile, split length, number of splits), from static
    shapes only: enough blocks to give every SM two, splits a whole number of
    tiles.  The key tile (keys staged in shared memory per step) shrinks as
    dh grows."""
    tk = 64 if dh <= 64 else 32 if dh <= 128 else 16
    row_tiles = -(-(S * (Hq // Hkv)) // _ROWS)
    n_tiles = -(-T // tk)
    want = min(n_tiles, max(1, -(-2 * n_sm // (B * Hkv * row_tiles))))
    split_len = -(-n_tiles // want) * tk
    return tk, split_len, -(-T // split_len)


def fused_tile(dh: int, dtype: torch.dtype) -> int:
    """Keys of a fused block's K/V tile.  bf16 (``mma.sync``): 64 up to dh
    128 (four warps of 16 keys), 32 above (two warps along the keys, two
    along O's columns).  fp32 (CUDA-core products): a power of two from 16
    to 128 keys and at most 16 KB of K."""
    if dtype == torch.bfloat16:
        return 64 if dh <= 128 else 32
    tk = 128
    while tk * dh * torch.finfo(dtype).bits // 8 > 16384:
        tk //= 2
    return tk


def fused_blocks_per_sm(dh: int, dtype: torch.dtype) -> int:
    """Fused blocks an H100 SM holds.  bf16: as many as the ring's shared
    memory allows (FusedMma::kBlocksPerSm; ``__launch_bounds__`` holds the
    registers to it, and ``chip_smoke.py`` checks it against the device's
    own reckoning).  fp32, the parity path, is planned at one."""
    if dtype != torch.bfloat16:
        return 1
    row = 128 * -(-dh // 64) + 16  # bytes of a K or V row, padded against bank conflicts
    ring = FUSED_STAGES * 2 * fused_tile(dh, dtype) * row
    return min(SM_THREADS // FUSED_THREADS,
               SM_SMEM_BYTES // (ring + FUSED_STATIC_SMEM + BLOCK_SMEM_RESERVED))


def plan_fused(B: int, Hkv: int, T: int, dh: int, dtype: torch.dtype, n_sm: int,
               window: int | None = None) -> tuple[int, int, int]:
    """Fused variant: (key tile, splits a (b, KV head), blocks a cluster),
    from static shapes only, so a launch never waits on the device's
    lengths: as many splits as fill every SM's blocks once over the B * Hkv
    heads, no more than the keys a row can see (T, or the window) hold
    tiles of FUSED_SPLIT_KEYS, and one cluster of at most MAX_CLUSTER; past
    one cluster only while each split keeps CLUSTER_SPLIT_KEYS of them, in
    whole clusters: of MAX_CLUSTER where an SM holds four blocks or more,
    else of 2 (at two blocks an SM an H100 does not place all of the larger
    clusters at once: ``tools/decode_ab.py sweep``).  Each block cuts its
    share from the live length on the card (:func:`fused_partition`)."""
    tk = fused_tile(dh, dtype)
    keys = min(T, window) if window else T
    per_sm = fused_blocks_per_sm(dh, dtype)
    want = max(1, min(n_sm * per_sm // (B * Hkv), -(-keys // FUSED_SPLIT_KEYS)))
    if want <= MAX_CLUSTER:
        return tk, want, want
    want = min(want, keys // CLUSTER_SPLIT_KEYS)
    if want <= MAX_CLUSTER:
        return tk, MAX_CLUSTER, MAX_CLUSTER
    cluster = MAX_CLUSTER if per_sm >= 4 else 2
    return tk, max(MAX_CLUSTER, want // cluster * cluster), cluster


def fused_partition(q_start: int, T: int, window: int | None, n_splits: int,
                    tk: int) -> list[tuple[int, int]]:
    """The keys ``(lo, hi)`` (inclusive; ``lo > hi`` when empty) of each of
    a fused call's ``n_splits`` splits for a query at ``q_start``, as each
    block computes them on the card (``fused_split_range``): the visible
    keys (window included, none at or past T) cut into tiles of ``tk`` from
    the first one, the tiles shared out evenly and in order, so no split is
    empty while there are at least as many tiles as splits."""
    lo = max(0, q_start - window + 1) if window else 0
    hi = min(T - 1, q_start)
    n_tiles = (hi - lo) // tk + 1 if hi >= lo else 0
    first = [s * n_tiles // n_splits * tk for s in range(n_splits + 1)]  # each split's first key
    return [(lo + a, min(hi, lo + b - 1)) for a, b in zip(first, first[1:])]


def fused_workspace_floats(B: int, Hkv: int, G: int, dh: int, n_splits: int, cluster: int) -> int:
    """fp32 values of a fused call's workspace: none within one cluster; past
    it, m and l of 16 rows and the G * dh sums of each (b, KV head) and
    cluster."""
    n_clusters = n_splits // cluster
    return 0 if n_clusters == 1 else B * Hkv * n_clusters * (2 * FUSED_MAX_G + G * dh)


# The fused variant's tickets, one int32 a (b, KV head) a device, zeros
# between launches: made once, outside any graph capture, and kept (the
# kernel sets each back to 0).  Calls on one device run in stream order.
_TICKETS: dict[torch.device, torch.Tensor] = {}


def _tickets(device: torch.device) -> torch.Tensor:
    t = _TICKETS.get(device)
    if t is None:
        if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError("decode_attention fused: the first call past one cluster of splits "
                               "must run outside a CUDA graph capture")
        t = _TICKETS[device] = torch.zeros(FUSED_TICKETS, dtype=torch.int32, device=device)
    return t


def plan_chunk(B: int, S: int, G: int, Hkv: int, T: int, n_sm: int) -> int:
    """Chunk variant: the blocks of a cluster that share each 64-row tile's
    key tiles (1, 2, 4 or 8), from static shapes only: as many as give
    every SM two blocks, as the split variant's plan does, and no more than
    T has key tiles."""
    blocks = B * Hkv * -(-(S * G) // CHUNK_ROWS)
    want = min(MAX_CLUSTER, 2 * n_sm // blocks, -(-T // CHUNK_KEYS))
    n = 1
    while 2 * n <= want:
        n *= 2
    return n


@functools.lru_cache(maxsize=None)
def _n_sm(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _sms(device: torch.device) -> int:
    return meta.SMS if device.type == "meta" else _n_sm(device.index or 0)


def _record(var: str, q: torch.Tensor, T: int, Hkv: int, writes: bool) -> None:
    """A meta call's count: bytes q read and out written, every cached K/V
    row read (and with ``writes`` the new rows read and written), q_start
    read; FLOPs 4 per (query row, key) pair and head dim in QK^T and PV.
    The chunk variant's and the bf16 fused variant's products run on the
    tensor cores, the split variant's and fp32's on the CUDA cores."""
    B, S, Hq, dh = q.shape
    isz = q.element_size()
    nbytes = (2 * B * S * Hq * dh + 2 * B * T * Hkv * dh) * isz + 4 * B
    if writes:
        nbytes += 4 * B * S * Hkv * dh * isz
    unit = "bf16" if q.dtype == torch.bfloat16 and var != "split" else "fp32"
    meta.record(f"decode_attention_{var}", 4 * B * S * T * Hq * dh, nbytes, unit)


def _count(var: str) -> None:
    """One call of ``var`` reached the card, or, while the stream is being
    captured into a CUDA graph, was recorded into it (counted on replay)."""
    n = KERNELS_PER_CALL[var]
    if torch.cuda.is_current_stream_capturing():
        decode_attention.captured_by_variant[var] += n
        return
    decode_attention.launches_by_variant[var] += n


def count_replays(per_replay: dict[str, int], replays: int = 1) -> None:
    """Count the kernels of ``replays`` replays of a CUDA graph that holds
    ``per_replay`` kernels of each variant."""
    for var, n in per_replay.items():
        decode_attention.launches_by_variant[var] += n * replays


def _check_common(name: str, q, tensors, q_start, window) -> None:
    for tname, t in tensors + (("q_start", q_start),):
        if t.device != q.device:
            raise ValueError(f"{name}: {tname} on {t.device}, q on {q.device}")
    if q.dtype not in _DTYPES or any(t.dtype != q.dtype for _, t in tensors):
        raise TypeError(
            f"{name}: q/k/v must share fp32 or bf16, got "
            f"{q.dtype}/" + "/".join(str(t.dtype) for _, t in tensors)
        )
    if q_start.dtype != torch.int32:
        raise TypeError(f"{name}: q_start must be int32, got {q_start.dtype}")
    if not (q.is_contiguous() and q_start.is_contiguous()
            and all(t.is_contiguous() for _, t in tensors)):
        raise ValueError(f"{name}: q, k, v and q_start must be contiguous")
    if window is not None and window <= 0:
        raise ValueError(f"{name}: window must be positive, got {window}")


def decode_attention(
    q: torch.Tensor,  # [B,S,Hq,dh]
    k_cache: torch.Tensor,  # [B,T,Hkv,dh]
    v_cache: torch.Tensor,
    q_start: torch.Tensor,  # [B] int32
    *,
    window: int | None = None,
) -> torch.Tensor:
    """Query row s of sequence b attends keys ``kpos <= q_start[b]+s`` (and,
    with ``window``, ``kpos > q_start[b]+s-window``).  Returns [B,S,Hq,dh]
    in q's dtype.  The split variant, whatever S is."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, q_start, window=window)
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    _check_common("decode_attention", q, (("k_cache", k_cache), ("v_cache", v_cache)),
                  q_start, window)
    B, S, Hq, dh = q.shape
    Bk, T, Hkv, dhk = k_cache.shape
    if v_cache.shape != k_cache.shape or Bk != B or dhk != dh or q_start.shape != (B,):
        raise ValueError(
            f"decode_attention: shapes q {tuple(q.shape)}, k {tuple(k_cache.shape)}, "
            f"v {tuple(v_cache.shape)}, q_start {tuple(q_start.shape)} do not agree"
        )
    if Hkv <= 0 or Hq % Hkv:
        raise ValueError(f"decode_attention: Hq={Hq} is not a multiple of Hkv={Hkv}")
    variant(S, Hq // Hkv, dh, q.dtype)  # raises for what no kernel takes

    tk, split_len, n_splits = plan(B, S, Hq, Hkv, T, dh, _sms(q.device))
    n_part = B * Hkv * S * (Hq // Hkv) * n_splits
    out = torch.empty_like(q)
    m_part = torch.empty(n_part, dtype=torch.float32, device=q.device)
    l_part = torch.empty(n_part, dtype=torch.float32, device=q.device)
    acc_part = torch.empty(n_part * dh, dtype=torch.float32, device=q.device)
    if q.device.type == "meta":  # the dry-run: shapes and counts, no launch
        _record("split", q, T, Hkv, writes=False)
        return out
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = _kernel("split")(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), q_start.data_ptr(),
            out.data_ptr(), m_part.data_ptr(), l_part.data_ptr(), acc_part.data_ptr(),
            B, S, Hq, Hkv, T, dh, window or 0, n_splits, split_len, tk, _DTYPES[q.dtype],
            stream,
        )
    if err != 0:
        raise RuntimeError(f"decode_attention split launch failed: CUDA error {err}")
    _count("split")
    return out


def decode_attention_chunk(
    q: torch.Tensor,  # [B,S,Hq,dh]
    k_new: torch.Tensor,  # [B,S,Hkv,dh]
    v_new: torch.Tensor,
    k_cache: torch.Tensor,  # [B,T,Hkv,dh]; rows q_start[b]..q_start[b]+S-1 written in place
    v_cache: torch.Tensor,
    q_start: torch.Tensor,  # [B] int32
    *,
    window: int | None = None,
) -> torch.Tensor:
    """Write the new K/V rows at ``q_start[b] + s`` into the caches, then
    attend as :func:`decode_attention`.  Returns [B,S,Hq,dh] in q's dtype.
    On the card :func:`variant` picks the route from static shapes: the
    ``"chunk"`` or ``"fused"`` variant does both in one launch (positions at
    or past T write nothing); otherwise two index writes, then the split
    variant.  The engine refuses positions past T before any work (the plain
    version raises for them)."""
    if q.device.type == "cpu":
        return decode_attention_chunk_plain(
            q, k_new, v_new, k_cache, v_cache, q_start, window=window)
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"decode_attention_chunk: unsupported device {q.device}")
    tensors = (("k_new", k_new), ("v_new", v_new), ("k_cache", k_cache), ("v_cache", v_cache))
    _check_common("decode_attention_chunk", q, tensors, q_start, window)
    B, S, Hq, dh = q.shape
    Bk, T, Hkv, dhk = k_cache.shape
    if (v_cache.shape != k_cache.shape or Bk != B or dhk != dh or q_start.shape != (B,)
            or k_new.shape != (B, S, Hkv, dh) or v_new.shape != k_new.shape):
        raise ValueError(
            f"decode_attention_chunk: shapes q {tuple(q.shape)}, k_new {tuple(k_new.shape)}, "
            f"v_new {tuple(v_new.shape)}, k {tuple(k_cache.shape)}, v {tuple(v_cache.shape)}, "
            f"q_start {tuple(q_start.shape)} do not agree"
        )
    if Hkv <= 0 or Hq % Hkv:
        raise ValueError(f"decode_attention_chunk: Hq={Hq} is not a multiple of Hkv={Hkv}")
    var = variant(S, Hq // Hkv, dh, q.dtype)
    if var == "split":
        insert_chunk(k_cache, k_new, q_start)
        insert_chunk(v_cache, v_new, q_start)
        return decode_attention(q, k_cache, v_cache, q_start, window=window)
    # every operand is read and written 16 bytes at a time
    if any(t.data_ptr() % 16 for t in (q, k_new, v_new, k_cache, v_cache)):
        raise ValueError("decode_attention_chunk: q, k and v must start on a 16-byte boundary")

    out = torch.empty_like(q)
    ws = tickets = None
    if var == "fused":
        tk, n_splits, cluster = plan_fused(B, Hkv, T, dh, q.dtype, _sms(q.device), window)
        n_ws = fused_workspace_floats(B, Hkv, Hq // Hkv, dh, n_splits, cluster)
        if n_ws:  # splits past one cluster: the clusters' sums and the tickets
            ws = torch.empty(n_ws, dtype=torch.float32, device=q.device)
            tickets = _tickets(q.device)
    if q.device.type == "meta":  # the dry-run: shapes and counts, no launch
        _record(var, q, T, Hkv, writes=True)
        return out
    stream = torch.cuda.current_stream(q.device).cuda_stream
    ptrs = (q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), k_cache.data_ptr(),
            v_cache.data_ptr(), q_start.data_ptr(), out.data_ptr())
    with torch.cuda.device(q.device):
        if var == "fused":
            err = _kernel("fused")(*ptrs, None if ws is None else ws.data_ptr(),
                                   None if tickets is None else tickets.data_ptr(), B, Hq, Hkv,
                                   T, dh, window or 0, n_splits, cluster, tk,
                                   _DTYPES[q.dtype], stream)
        else:
            n_split = plan_chunk(B, S, Hq // Hkv, Hkv, T, _sms(q.device))
            err = _kernel("chunk")(*ptrs, B, S, Hq, Hkv, T, dh, window or 0, n_split, stream)
    if err != 0:
        raise RuntimeError(f"decode_attention {var} launch failed: CUDA error {err}")
    _count(var)
    return out


# one decode step's call (S = 1): the fused variant at G <= 16 on the card
decode_attention_insert = decode_attention_chunk


# Kernel launches that reached the card, and nowhere else, by variant
# (``launches_by_variant``; a split call launches two kernels, a fused or a
# chunk call one).  A call made while its stream is being captured into a
# CUDA graph launches nothing; it adds to ``captured_by_variant``, and the
# graph's owner counts each replay with :func:`count_replays`.  Callers that
# prove a path went through the kernels reset them (reset_launches) and read
# them.
def reset_launches() -> None:
    decode_attention.launches_by_variant = {v: 0 for v in VARIANTS}
    decode_attention.captured_by_variant = {v: 0 for v in VARIANTS}


reset_launches()
