"""Cached GQA attention as plain torch ops.

``decode_attention`` is the plain version of the hand-written kernel in
:mod:`repro_torch.kernels.decode_attention`: the wrapper there runs it for
tensors on the CPU, the tests hold it against the reference package, and
the chip smoke holds the kernel against it on the card.  It casts where the
reference casts: scores leave the product in the working dtype and are then
cast to fp32; probabilities are cast back to the working dtype before the
product with V.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


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
    if window is not None and not (global_flag is not None and float(global_flag) > 0.5):
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
