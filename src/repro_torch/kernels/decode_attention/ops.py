"""Wrapper of the hand-written decode-attention kernel
(``csrc/decode_attention.cu``), with the model function's signature.

A tensor on the CPU goes to the plain version
(:func:`repro_torch.models.attention.decode_attention`).  A CUDA tensor goes
to the kernel, or the wrapper raises: there is no fallback.
"""
from __future__ import annotations

import ctypes

import torch

from ...models.attention import decode_attention as decode_attention_plain
from .. import build

__all__ = ["decode_attention", "decode_attention_plain", "plan"]

_WARPS, _ROWS_PER_WARP = 4, 4  # must match kWarps / kRowsPerWarp in the source
_ROWS = _WARPS * _ROWS_PER_WARP
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = build.load("decode_attention").decode_attention_launch
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 11 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def plan(B: int, S: int, Hq: int, Hkv: int, T: int, dh: int, n_sm: int) -> tuple[int, int, int]:
    """(key tile, split length, number of splits), from static shapes only:
    enough blocks to give every SM two, splits a whole number of tiles.  The
    key tile (keys staged in shared memory per step) shrinks as dh grows."""
    tk = 64 if dh <= 64 else 32 if dh <= 128 else 16
    row_tiles = -(-(S * (Hq // Hkv)) // _ROWS)
    n_tiles = -(-T // tk)
    want = min(n_tiles, max(1, -(-2 * n_sm // (B * Hkv * row_tiles))))
    split_len = -(-n_tiles // want) * tk
    return tk, split_len, -(-T // split_len)


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
    in q's dtype."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, q_start, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache), ("q_start", q_start)):
        if t.device != q.device:
            raise ValueError(f"decode_attention: {name} on {t.device}, q on {q.device}")
    if q.dtype not in _DTYPES or k_cache.dtype != q.dtype or v_cache.dtype != q.dtype:
        raise TypeError(
            f"decode_attention: q/k/v must share fp32 or bf16, got "
            f"{q.dtype}/{k_cache.dtype}/{v_cache.dtype}"
        )
    if q_start.dtype != torch.int32:
        raise TypeError(f"decode_attention: q_start must be int32, got {q_start.dtype}")
    if not (q.is_contiguous() and k_cache.is_contiguous() and v_cache.is_contiguous()
            and q_start.is_contiguous()):
        raise ValueError("decode_attention: q, k_cache, v_cache and q_start must be contiguous")
    B, S, Hq, dh = q.shape
    Bk, T, Hkv, dhk = k_cache.shape
    if v_cache.shape != k_cache.shape or Bk != B or dhk != dh or q_start.shape != (B,):
        raise ValueError(
            f"decode_attention: shapes q {tuple(q.shape)}, k {tuple(k_cache.shape)}, "
            f"v {tuple(v_cache.shape)}, q_start {tuple(q_start.shape)} do not agree"
        )
    if Hkv <= 0 or Hq % Hkv:
        raise ValueError(f"decode_attention: Hq={Hq} is not a multiple of Hkv={Hkv}")
    if dh > 256 or dh % 8:
        raise ValueError(f"decode_attention: head dim {dh} must be a multiple of 8 up to 256")
    if window is not None and window <= 0:
        raise ValueError(f"decode_attention: window must be positive, got {window}")

    n_sm = torch.cuda.get_device_properties(q.device).multi_processor_count
    tk, split_len, n_splits = plan(B, S, Hq, Hkv, T, dh, n_sm)
    n_part = B * Hkv * S * (Hq // Hkv) * n_splits
    out = torch.empty_like(q)
    m_part = torch.empty(n_part, dtype=torch.float32, device=q.device)
    l_part = torch.empty(n_part, dtype=torch.float32, device=q.device)
    acc_part = torch.empty(n_part * dh, dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    fn = _kernel()
    with torch.cuda.device(q.device):
        err = fn(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), q_start.data_ptr(),
            out.data_ptr(), m_part.data_ptr(), l_part.data_ptr(), acc_part.data_ptr(),
            B, S, Hq, Hkv, T, dh, window or 0, n_splits, split_len, tk, _DTYPES[q.dtype],
            stream,
        )
    if err != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: CUDA error {err}")
    decode_attention.launches += 1
    return out


# kernel launches: one per call that reached the card, and nowhere else.
# Callers that prove a path went through the kernel set it to 0 and read it.
decode_attention.launches = 0

