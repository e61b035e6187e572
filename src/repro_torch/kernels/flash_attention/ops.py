"""Wrapper of the hand-written flash-attention kernels
(``csrc/flash_attention.cu``), with the reference wrapper's signature.

q is ``[B,Sq,Hq,dh]``, k ``[B,Sk,Hkv,dh]`` and v ``[B,Sk,Hkv,dv]`` with
``dv <= dh`` (MLA's values are narrower than its keys); the output, its
gradient and v's gradient are ``dv`` wide.  The kernels take narrower values
natively: the bf16 kernels at their (keys, values) pairs of 64-column chunks
(:func:`instance`), the fp32 kernels by zero-filling V past ``dv`` in their
split.  ``flash_attention`` is a ``torch.autograd.Function`` on CUDA tensors: its
forward launches the forward kernel, which also writes the per-row
logsumexp, and its backward launches the backward kernels (:func:`fused_bwd`
says which design a shape takes).  Which
kernels take a shape is :func:`variant`'s choice, made from the dtype, the
head dim and the GQA group before any launch: ``"wgmma"`` (bf16, group
dividing 64, every head dim), ``"wgmma_rows"`` (bf16, any other group: the
same kernels on a gathered copy of q and dout) or ``"tf32x3"`` (fp32, every
head dim and group: each fp32 product as three TF32 products on the tensor
cores); the bf16 variants raise for a pair of column-chunk counts no
instantiation takes.  A tensor on the CPU goes to the plain version
(:func:`attention_ref`), which autograd differentiates.  A CUDA tensor goes
to the kernels of its variant, or the wrapper raises: there is no fallback.
The wrapper allocates the scratch a call needs (the size is the library's
``flash_attention_work_floats``): the tf32x3 split's operands, the
wgmma_rows gathered copies, the bf16 backward's delta (with, where the fused
kernels run, lse by rows, the fp32 dQ accumulator and its counters).  A tensor on the
``meta`` device (the dry-run) takes an explicit shape-only path: the same
outputs and scratch (sized by :func:`work_floats`, the library's function in
Python) as meta tensors, the call's FLOPs and bytes reported to
:mod:`repro_torch.kernels.meta`, and no launch.
"""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from .. import build, meta
from .ref import attention_ref, fused_heads_per_group

__all__ = [
    "flash_attention", "flash_attention_bwd", "flash_attention_fwd", "fused_bwd", "instance",
    "reset_launches", "variant", "work_floats",
]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
VARIANTS = ("tf32x3", "wgmma", "wgmma_rows")  # index = the kernels' variant number
_INTS = 9  # B, Sq, Sk, Hq, Hkv, dh, dv, causal, window
# the (keys, values) pairs of 64-column chunks the bf16 kernels are
# instantiated at (wgmma_pair): equal counts, and MLA's keys of 192 and
# values of 128
PAIRS = ((1, 1), (2, 2), (3, 3), (4, 4), (3, 2))
_fns: dict[str, object] = {}


def chunks(d: int) -> int:
    """64-column chunks of a width padded to 16 (the kernels' ``wgmma_chunks``)."""
    return ((d + 15) // 16 * 16 + 63) // 64


def variant(dtype: torch.dtype, dh: int, G: int, dv: int | None = None) -> str:
    """The kernels that take a shape (values ``dv`` wide, ``dh`` where None):
    ``"wgmma"`` for bf16 with a GQA group G that divides 64 (a 64-row box of
    q then holds whole positions), at every head dim; ``"wgmma_rows"`` for
    bf16 with any other G, at every head dim (a gather pass first lays out
    the rows of each kv head contiguously); ``"tf32x3"`` for fp32 at every
    head dim and every G.  The bf16 variants take the pairs of column-chunk
    counts of ``PAIRS``.  Raises for what no kernel takes."""
    dv = dh if dv is None else dv
    if dtype not in _DTYPES:
        raise TypeError(f"flash_attention: no kernel for {dtype}; fp32 or bf16")
    if dh <= 0 or dh > 256 or dh % 8:
        raise ValueError(f"flash_attention: head dim {dh} must be a multiple of 8 up to 256")
    if dv <= 0 or dv > dh or dv % 8:
        raise ValueError(f"flash_attention: value width {dv} must be a multiple of 8 up to the "
                         f"head dim {dh}")
    if G <= 0:
        raise ValueError(f"flash_attention: GQA group {G} must be positive")
    if dtype == torch.float32:
        return "tf32x3"
    if (chunks(dh), chunks(dv)) not in PAIRS:
        raise ValueError(
            f"flash_attention: no bf16 kernel takes keys of {dh} and values of {dv} columns: "
            f"their 64-column chunks ({chunks(dh)}, {chunks(dv)}) are not a pair of {PAIRS}")
    return "wgmma" if 64 % G == 0 else "wgmma_rows"


def fused_bwd(dh: int, dv: int | None = None) -> bool:
    """Whether the bf16 backward at keys ``dh`` and values ``dv`` wide runs
    the fused kernels (the kernels' ``fused_bwd``: equal chunk counts, one or
    two, and MLA's keys of three chunks beside values of two): D's walk, one
    key-tile kernel for dK, dV and dQ's partials summed in key order, and
    dq's conversion; else (three or four equal chunks) the dQ kernel, then
    the dK/dV kernel."""
    dc, dvc = chunks(dh), chunks(dh if dv is None else dv)
    return (dc == dvc and dc <= 2) or (dc, dvc) == (3, 2)


def instance(dtype: torch.dtype, dh: int, G: int, dv: int | None = None) -> str:
    """The instantiation that takes a shape: the variant and, for bf16, the
    counts of 64-column chunks of the keys and of the values, as "wgmma 3x2"
    (MLA's keys of 192 and values of 128); "tf32x3" for fp32."""
    dv = dh if dv is None else dv
    var = variant(dtype, dh, G, dv)
    return var if var == "tf32x3" else f"{var} {chunks(dh)}x{chunks(dv)}"


def _kernel(name: str, n_ptr: int, n_tail: int = 0):
    """The library's entry ``name``: n_ptr pointers, the shape, the scale,
    dtype and variant, n_tail more ints, the stream."""
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(build.load("flash_attention"), name)
        fn.argtypes = (
            [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * _INTS
            + [ctypes.c_float, ctypes.c_int, ctypes.c_int] + [ctypes.c_int] * n_tail
            + [ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


# the kernels' tiling constants that size the scratch (csrc/flash_attention.cu)
_BLOCK_ROWS = 128  # kBlockRows: rows (or keys) of a block
_X3_CHUNK = 16  # kX3Chunk: tiles of a tf32x3 backward walk a block takes
_TILE = 64  # a tile of keys or of rows


def _x3_chunks(n: int) -> int:
    return -(-n // _X3_CHUNK) if n > _X3_CHUNK else 1


def _x3_q_chunks(Sq: int, Sk: int, G: int, causal: int, window: int) -> int:
    """x3_q_chunks: the most chunks a block of rows' key walk takes."""
    R, most = Sq * G, 1
    for r0 in range(0, R, _BLOCK_ROWS):
        p_lo, p_hi = r0 // G, (min(R, r0 + _BLOCK_ROWS) - 1) // G
        key_lo = max(0, p_lo - window + 1) if window > 0 else 0
        key_hi = min(Sk - 1, p_hi) if causal else Sk - 1
        first = key_lo // _TILE
        most = max(most, _x3_chunks(key_hi // _TILE - first + 1 if key_hi >= key_lo else 0))
    return most


def _x3_kv_chunks(Sq: int, Sk: int, G: int, causal: int, window: int) -> int:
    """x3_kv_chunks: the most chunks a block of keys' row walk takes."""
    R, most = Sq * G, 1
    for k0 in range(0, Sk, _BLOCK_ROWS):
        k_last = min(Sk, k0 + _BLOCK_ROWS) - 1
        p_min = k0 if causal else 0
        p_max = min(Sq - 1, k_last + window - 1) if window > 0 else Sq - 1
        first = min(p_min, Sq) * G // _TILE
        end = min(R, (p_max + 1) * G)
        n = (end - first * _TILE + _TILE - 1) // _TILE if end > first * _TILE else 0
        most = max(most, _x3_chunks(n))
    return most


def work_floats(B: int, Sq: int, Sk: int, Hq: int, Hkv: int, dh: int, causal: int,
                window: int, var: int, backward: bool, dv: int | None = None) -> int:
    """Floats of fp32 scratch a call needs (values ``dv`` wide, ``dh`` where
    None): the library's ``flash_attention_work_floats`` (``X3Work``,
    ``WgWork``) in Python, for the meta path, which loads no library.
    ``var`` indexes VARIANTS."""
    dv = dh if dv is None else dv
    if B <= 0 or Sq <= 0 or Sk <= 0 or Hkv <= 0 or Hq % Hkv or dh <= 0 or not 0 < dv <= dh:
        return 0
    up = lambda x, m: -(-x // m) * m
    if VARIANTS[var] == "tf32x3":
        BH, R = B * Hkv, Sq * (Hq // Hkv)
        rows_q, rows_k = 2 * BH * R * dh, 2 * BH * Sk * dh
        cols_q, cols_k = 2 * BH * dh * up(R, 8), 2 * BH * dh * up(Sk, 8)
        if not backward:
            return rows_q + rows_k + cols_k
        G = Hq // Hkv
        return (2 * rows_q + 2 * rows_k + 2 * cols_q + cols_k + 2 * BH * up(R, 64)
                + _x3_q_chunks(Sq, Sk, G, causal, window) * BH * R * dh
                + 2 * _x3_kv_chunks(Sq, Sk, G, causal, window) * BH * Sk * dh)
    rows = VARIANTS[var] == "wgmma_rows"  # the gathered q (dh) and dout (dv)
    q_rows, do_rows = (B * Hq * Sq * d // 2 if rows else 0 for d in (dh, dv))
    if not backward:
        return q_rows
    if not fused_bwd(dh, dv):  # delta [B,Hq,Sq]; every part rounded up to 4 floats
        return q_rows + do_rows + up(B * Hq * Sq, 4)
    # lse * log2(e) and delta by rows, the fp32 dQ accumulator of the 64-row
    # tiles, and their counters with the ticket
    tiles = B * Hkv * -(-Sq * (Hq // Hkv) // _TILE)
    return (q_rows + do_rows + 2 * tiles * _TILE + tiles * chunks(dh) * _TILE * _TILE
            + up(tiles + 1, 4))


def _work(args: tuple, backward: bool, device) -> torch.Tensor | None:
    """The fp32 scratch of one call (None where it needs none)."""
    if device.type == "meta":
        B, Sq, Sk, Hq, Hkv, dh, dv, causal, window = args[:_INTS]
        n = work_floats(B, Sq, Sk, Hq, Hkv, dh, causal, window, args[-1], backward, dv=dv)
    else:
        fn = _fns.get("work")
        if fn is None:
            fn = build.load("flash_attention").flash_attention_work_floats
            fn.argtypes = [ctypes.c_int] * (_INTS + 2)
            fn.restype = ctypes.c_longlong
            _fns["work"] = fn
        n = fn(*args[:_INTS], args[-1], int(backward))
    return torch.empty(n, dtype=torch.float32, device=device) if n else None


def unmasked_pairs(Sq: int, Sk: int, causal: bool, window: int | None) -> int:
    """(query, key) pairs the mask keeps, per (b, query head): query s sees
    key t < Sk with (causal) t <= s and (window) t > s - window."""
    s = np.arange(Sq, dtype=np.int64)
    hi = np.minimum(s, Sk - 1) if causal else np.full(Sq, Sk - 1, np.int64)
    lo = np.maximum(0, s - window + 1) if window else np.zeros(Sq, np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())


def _cost(q, k, v, causal: bool, window: int | None,
          backward: bool) -> tuple[int, int, str]:
    """(FLOPs, bytes, unit) of one call, as PERF.md counts the bound.
    Bytes: forward reads q, k (dh wide), v (dv) and writes out (dv) and the
    fp32 logsumexp; backward reads q, k, v, out, dout and the logsumexp and
    writes dq, dk (dh) and dv (dv).  FLOPs, 2 a multiply-add over the pairs
    the mask keeps: forward Q.K (dh) and P.V (dv), backward dO.V and P^T.dO
    (dv), dS.K and dS^T.Q (dh)."""
    B, Sq, Hq, dh = q.shape
    Sk, Hkv, dv = k.shape[1], k.shape[2], v.shape[-1]
    isz = q.element_size()
    q_rows, kv_rows, lse = B * Sq * Hq * isz, B * Sk * Hkv * isz, B * Hq * Sq * 4
    if backward:  # q, dq, k, dk at dh; out, dout, v, dv at dv
        nbytes = 2 * (q_rows + kv_rows) * (dh + dv) + lse
    else:  # q, k at dh; out, v at dv
        nbytes = (q_rows + kv_rows) * (dh + dv) + lse
    pairs = unmasked_pairs(Sq, Sk, causal, window)
    flops = (4 if backward else 2) * B * Hq * (dh + dv) * pairs
    return flops, nbytes, "bf16" if q.dtype == torch.bfloat16 else "tf32x3"


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window: int | None) -> None:
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"flash_attention: {name} on {t.device}, q on {q.device}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"flash_attention: q/k/v must share fp32 or bf16, got {q.dtype}/{k.dtype}/{v.dtype}"
        )
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: q, k and v must be contiguous")
    if any(t.data_ptr() % 16 for t in (q, k, v)):  # the bf16 kernels load 16 bytes at a time
        raise ValueError("flash_attention: q, k and v must start on a 16-byte boundary")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4 or v.shape[:3] != k.shape[:3]:
        raise ValueError(
            f"flash_attention: shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"v {tuple(v.shape)} are not [B,Sq,Hq,dh], [B,Sk,Hkv,dh] and [B,Sk,Hkv,dv]"
        )
    B, Sq, Hq, dh = q.shape
    Bk, Sk, Hkv, dhk = k.shape
    if Bk != B or dhk != dh or min(B, Sq, Sk) <= 0:
        raise ValueError(
            f"flash_attention: shapes q {tuple(q.shape)} and k {tuple(k.shape)} do not agree"
        )
    if Hkv <= 0 or Hq % Hkv:
        raise ValueError(f"flash_attention: Hq={Hq} is not a multiple of Hkv={Hkv}")
    if dh > 256 or dh % 8:
        raise ValueError(f"flash_attention: head dim {dh} must be a multiple of 8 up to 256")
    dv = v.shape[-1]
    if dv <= 0 or dv > dh or dv % 8:
        raise ValueError(f"flash_attention: value width {dv} must be a multiple of 8 up to the "
                         f"head dim {dh}")
    if window is not None and window <= 0:
        raise ValueError(f"flash_attention: window must be positive, got {window}")


def _shape_args(q, k, v, causal, window) -> tuple[tuple, str, str]:
    """The kernels' shape arguments, the variant and the instantiation that
    take them."""
    B, Sq, Hq, dh = q.shape
    Sk, Hkv, dv = k.shape[1], k.shape[2], v.shape[-1]
    var = variant(q.dtype, dh, Hq // Hkv, dv)
    return ((B, Sq, Sk, Hq, Hkv, dh, dv, int(causal), window or 0,
             1.0 / math.sqrt(dh), _DTYPES[q.dtype], VARIANTS.index(var)), var,
            instance(q.dtype, dh, Hq // Hkv, dv))


def _count(var: str, inst: str, kind: str) -> None:
    flash_attention.launches_by_variant[var][kind] += 1
    by_inst = flash_attention.launches_by_instance.setdefault(inst, {"fwd": 0, "bwd": 0})
    by_inst[kind] += 1


def flash_attention_fwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
    window: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One launch of the forward kernel: (out [B,Sq,Hq,dv] in q's dtype,
    lse fp32 [B,Hq,Sq])."""
    _check(q, k, v, window)
    B, Sq, Hq, _ = q.shape
    out = q.new_empty(B, Sq, Hq, v.shape[-1])
    lse = torch.empty(B, Hq, Sq, dtype=torch.float32, device=q.device)
    args, var, inst = _shape_args(q, k, v, causal, window)
    work = _work(args, False, q.device)
    if q.device.type == "meta":  # the dry-run: shapes and counts, no launch
        meta.record("flash_attention_fwd", *_cost(q, k, v, causal, window, False))
        return out, lse
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = _kernel("flash_attention_fwd", 6)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
            None if work is None else work.data_ptr(), *args, stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_attention {var} forward launch failed: CUDA error {err}")
    flash_attention.launches_fwd += 1
    _count(var, inst, "fwd")
    return out, lse


def flash_attention_bwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
    lse: torch.Tensor, dout: torch.Tensor, *, causal: bool = True, window: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernels: (dq, dk, dv) in the inputs' dtype, out and dout
    [B,Sq,Hq,dv].  Counts one backward launch.  bf16 where :func:`fused_bwd`
    holds: a delta kernel sums D = rowsum(P * dP) over the keys per row into
    the scratch, the counters of dQ's row tiles are zeroed, one persistent
    key-tile kernel (its tickets taking the kv heads in groups of
    :func:`~.ref.fused_heads_per_group`) accumulates dK and dV and adds each
    key tile's partial of dQ into an fp32 accumulator in increasing key
    order, and a last kernel writes dq; other bf16 pairs run the dQ kernel
    (which writes D first, in a first walk) and then the dK/dV kernel.
    wgmma_rows first gathers q and dout into its scratch; the tf32x3 variant
    first splits q, k, v and dout into its scratch and writes D and the
    logsumexp per row there."""
    _check(q, k, v, window)
    want = (*q.shape[:3], v.shape[-1])
    if (out.shape != want or dout.shape != want or out.dtype != q.dtype
            or dout.dtype != q.dtype or not (out.is_contiguous() and dout.is_contiguous())
            or dout.data_ptr() % 16):
        raise ValueError("flash_attention: out and dout must be contiguous, typed as q and "
                         "shaped [B,Sq,Hq,dv], and dout must start on a 16-byte boundary")
    if lse.dtype != torch.float32 or lse.shape != (q.shape[0], q.shape[2], q.shape[1]):
        raise ValueError(f"flash_attention: lse must be fp32 [B,Hq,Sq], got {tuple(lse.shape)}")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    args, var, inst = _shape_args(q, k, v, causal, window)
    work = _work(args, True, q.device)
    if q.device.type == "meta":  # the dry-run: shapes and counts, no launch
        meta.record("flash_attention_bwd", *_cost(q, k, v, causal, window, True))
        return dq, dk, dv
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        B, Sq, _, Hq, Hkv, dh, dv_w = args[:7]
        err = _kernel("flash_attention_bwd", 10, 1)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), None if work is None else work.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), *args,
            fused_heads_per_group(B, Sq, Hq, Hkv, dh, dv_w), stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_attention {var} backward launch failed: CUDA error {err}")
    flash_attention.launches_bwd += 1
    _count(var, inst, "bwd")
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        out, lse = flash_attention_fwd(q, k, v, causal=causal, window=window)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dout = dout.contiguous()
        if dout.data_ptr() % 16:  # a view at an odd offset: a fresh copy is aligned
            dout = dout.clone()
        dq, dk, dv = flash_attention_bwd(
            q, k, v, out, lse, dout, causal=ctx.causal, window=ctx.window
        )
        return dq, dk, dv, None, None


def flash_attention(
    q: torch.Tensor,  # [B,Sq,Hq,dh]
    k: torch.Tensor,  # [B,Sk,Hkv,dh]
    v: torch.Tensor,  # [B,Sk,Hkv,dv], dv <= dh
    *,
    causal: bool = True,
    window: int | None = None,
) -> torch.Tensor:
    """Query position s attends key t < Sk with (causal) t <= s and (window)
    t > s - window.  Returns [B,Sq,Hq,dv] in q's dtype; differentiable."""
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window)
    _check(q, k, v, window)
    return _FlashAttention.apply(q, k, v, causal, window)


# kernel launches: forward calls and backward calls (each backward call
# launches its kernels, fused_bwd's three or the dQ and the dK/dV kernel,
# after the gather pass of wgmma_rows or the split of tf32x3) that reached
# the card, and nowhere else;
# launches_by_variant splits them by variant(), launches_by_instance by
# instance() (an instantiation's key appears at its first launch).  Callers
# that prove a path went through the kernels reset them (reset_launches) and
# read them.
def reset_launches() -> None:
    flash_attention.launches_fwd = 0
    flash_attention.launches_bwd = 0
    flash_attention.launches_by_variant = {v: {"fwd": 0, "bwd": 0} for v in VARIANTS}
    flash_attention.launches_by_instance = {}


reset_launches()
