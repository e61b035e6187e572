"""GQA attention as plain torch ops: full-sequence (``gqa_attention``,
``chunked_gqa_attention``) and cached (``decode_attention``).

``decode_attention`` is the plain version of the hand-written kernel in
:mod:`repro_torch.kernels.decode_attention`: the wrapper there runs it for
tensors on the CPU, the tests hold it against the reference package, and
the chip smoke holds the kernel against it on the card.  The full-sequence
functions are the model's CPU lowering (on the card the model calls
:mod:`repro_torch.kernels.flash_attention`).  All cast where the reference
casts: scores leave the product in the working dtype and are then cast to
fp32; probabilities are cast back to the working dtype before the product
with V.
"""
from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

NEG_INF = -1e30


def _global(global_flag) -> bool:
    """A per-layer flag (0.0/1.0) that, when 1, lifts the window."""
    return global_flag is not None and float(global_flag) > 0.5


def gqa_attention(
    q: torch.Tensor,  # [B,S,Hq,dh]
    k: torch.Tensor,  # [B,T,Hkv,dh]
    v: torch.Tensor,  # [B,T,Hkv,dh]
    *,
    causal: bool = True,
    window: int | None = None,
    q_offset: int = 0,
    global_flag: float | None = None,
) -> torch.Tensor:
    """``window`` restricts attention to a sliding window; ``global_flag``
    (0.0/1.0 per layer, e.g. gemma3's 5:1 pattern) lifts the window when 1."""
    B, S, Hq, dh = q.shape
    _, T, Hkv, _ = k.shape
    G = Hq // Hkv
    qg = q.reshape(B, S, Hkv, G, dh)
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k).float() / math.sqrt(dh)
    qpos = torch.arange(S, device=q.device) + q_offset
    kpos = torch.arange(T, device=q.device)
    mask = torch.ones(S, T, dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window is not None and not _global(global_flag):
        mask &= kpos[None, :] > qpos[:, None] - window
    scores = scores.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v)
    return out.reshape(B, S, Hq, v.shape[-1])


def chunked_gqa_attention(
    q: torch.Tensor,  # [B,S,Hq,dh]
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
    global_flag: float | None = None,
    block_q: int = 256,
) -> torch.Tensor:
    """Q-chunked attention with per-chunk rematerialization: the S x T score
    matrix never materializes beyond one (block_q x T) tile, and backward
    recomputes per chunk (``torch.utils.checkpoint`` per q-block, where the
    reference checkpoints its scan body)."""
    B, S, Hq, dh = q.shape
    if S <= block_q:
        return gqa_attention(q, k, v, causal=causal, window=window, global_flag=global_flag)
    pad = (-S) % block_q
    qp = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, pad)) if pad else q
    outs = []
    for off in range(0, qp.shape[1], block_q):
        outs.append(checkpoint(
            gqa_attention, qp[:, off:off + block_q], k, v, use_reentrant=False,
            causal=causal, window=window, q_offset=off, global_flag=global_flag,
        ))
    return torch.cat(outs, dim=1)[:, :S]


def decode_attention(
    q: torch.Tensor,  # [B,S,Hq,dh]  (S=1 decode; S=chunk for chunked prefill)
    k_cache: torch.Tensor,  # [B,T,Hkv,dh]  (new kv already inserted)
    v_cache: torch.Tensor,
    q_start: torch.Tensor,  # [B] position of the FIRST query token
    *,
    window: int | None = None,
    global_flag: float | None = None,
) -> torch.Tensor:
    """Cached attention: query token s attends kpos <= q_start+s (and, with
    a window on a local layer, kpos > q_start+s-window)."""
    B, S, Hq, dh = q.shape
    _, T, Hkv, _ = k_cache.shape
    G = Hq // Hkv
    qg = q.reshape(B, S, Hkv, G, dh)
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k_cache).float()
    scores = scores / math.sqrt(dh)
    kpos = torch.arange(T, device=q.device)
    qpos = q_start.long()[:, None] + torch.arange(S, device=q.device)[None, :]  # [B,S]
    mask = kpos[None, None, :] <= qpos[:, :, None]  # [B,S,T]
    if window is not None and not _global(global_flag):
        mask &= kpos[None, None, :] > qpos[:, :, None] - window
    scores = scores.masked_fill(~mask[:, None, None, :, :], NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v_cache)
    return out.reshape(B, S, Hq, v_cache.shape[-1])


def insert_chunk(cache: torch.Tensor, new: torch.Tensor, cache_len: torch.Tensor) -> torch.Tensor:
    """Write new [B,c,...] into cache [B,T,...] at positions cache_len+j, in
    place, and return ``cache``.  The reference adds a one-hot product into
    the cache instead (its arrays are immutable); on the zeroed tail the
    serving engine guarantees, both give the same values."""
    B, c = new.shape[:2]
    rows = torch.arange(B, device=cache.device)[:, None]
    cols = cache_len.long()[:, None] + torch.arange(c, device=cache.device)[None, :]
    cache[rows, cols] = new.to(cache.dtype)
    return cache


def insert_kv(cache: torch.Tensor, new: torch.Tensor, cache_len: torch.Tensor) -> torch.Tensor:
    """Write new [B,1,...] into cache [B,T,...] at position cache_len[B], in
    place (see :func:`insert_chunk`)."""
    return insert_chunk(cache, new, cache_len)
