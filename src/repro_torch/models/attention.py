"""GQA attention as plain torch ops: full-sequence (``gqa_attention``,
``chunked_gqa_attention``) and cached (``decode_attention``, and
``decode_attention_chunk`` / ``decode_attention_insert``, which first write
the chunk's or the step's K/V rows); and DeepSeek-V2's multi-head latent
attention (``mla_prefill``, ``mla_decode``).

``decode_attention``, ``decode_attention_chunk`` and
``decode_attention_insert`` are the plain versions
of the hand-written kernels in :mod:`repro_torch.kernels.decode_attention`:
the wrappers there run them for tensors on the CPU, the tests hold them
against the reference package, and the chip smoke holds the kernels against
them on the card.  The full-sequence
functions are the model's CPU lowering (on the card the model calls
:mod:`repro_torch.kernels.flash_attention`).  All cast where the reference
casts: scores leave the product in the working dtype and are then cast to
fp32; probabilities are cast back to the working dtype before the product
with V.
"""
from __future__ import annotations

import math

from typing import Callable

import torch
from torch.utils.checkpoint import checkpoint

from .layers import apply_rope

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


def decode_attention_chunk(
    q: torch.Tensor,  # [B,S,Hq,dh]
    k_new: torch.Tensor,  # [B,S,Hkv,dh]
    v_new: torch.Tensor,
    k_cache: torch.Tensor,  # [B,T,Hkv,dh]; rows q_start[b]..q_start[b]+S-1 written in place
    v_cache: torch.Tensor,
    q_start: torch.Tensor,  # [B] position of the first new token
    *,
    window: int | None = None,
) -> torch.Tensor:
    """A chunk's (or, at S = 1, a decode step's) attention, as the
    reference's layer body computes it: insert the new K/V rows at
    ``q_start``, then attend.  Updates the caches in place and returns
    [B,S,Hq,dh]."""
    insert_chunk(k_cache, k_new, q_start)
    insert_chunk(v_cache, v_new, q_start)
    return decode_attention(q, k_cache, v_cache, q_start, window=window)


# one decode step's attention (S = 1)
decode_attention_insert = decode_attention_chunk


# --------------------------------------------------------------------------
# MLA (DeepSeek-V2, arXiv:2405.04434) — with the absorbed-matmul decode path
# --------------------------------------------------------------------------
def _mla_query(x, p, nope: int, positions, theta: float):
    """(q_nope [B,S,H,nope], q_rope [B,S,H,rope] rotated)."""
    cq = x @ p["w_dq"]
    q = torch.einsum("bsr,rhe->bshe", cq, p["w_uq"])  # e = nope+rope
    return q[..., :nope], apply_rope(q[..., nope:], positions, theta)


def mla_latent(x, w_dkv, rope: int, positions, theta: float):
    """The rows MLA caches for x [B,S,d]: (c_kv [B,S,r], k_rope [B,S,rope]
    rotated, shared by every head)."""
    ckv_full = x @ w_dkv  # r = kv_lora + rope
    c_kv, k_rope = ckv_full[..., :-rope], ckv_full[..., -rope:]
    return c_kv, apply_rope(k_rope[:, :, None, :], positions, theta)[:, :, 0, :]


def mla_prefill(
    x: torch.Tensor,  # [B,S,d]
    p: dict,
    *,
    n_heads: int,
    nope: int,
    rope: int,
    v_dim: int,
    positions: torch.Tensor,
    theta: float,
    attend: Callable,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (attn_out [B,S,H*v_dim], c_kv [B,S,r], k_rope [B,S,rope]).

    The heads' keys are decompressed from the latent, and attention is MHA
    at head dim nope + rope with values of width v_dim, computed by
    ``attend(q, k, v)``: the model passes the reference's lowering on the
    CPU and the flash kernels on the card."""
    B, S, _ = x.shape
    q_nope, q_rope = _mla_query(x, p, nope, positions, theta)
    c_kv, k_rope = mla_latent(x, p["w_dkv"], rope, positions, theta)
    k_nope = torch.einsum("bsr,rhe->bshe", c_kv, p["w_uk"])  # [B,S,H,nope]
    v = torch.einsum("bsr,rhe->bshe", c_kv, p["w_uv"])  # [B,S,H,v_dim]
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(B, S, n_heads, rope)], dim=-1)
    out = attend(torch.cat([q_nope, q_rope], dim=-1), k, v)
    return out.reshape(B, S, n_heads * v_dim), c_kv, k_rope


def mla_decode(
    x: torch.Tensor,  # [B,S,d]  (S=1 decode; S=chunk for chunked prefill)
    p: dict,
    c_kv_cache: torch.Tensor,  # [B,T,r]   (new latents already inserted)
    k_rope_cache: torch.Tensor,  # [B,T,rope]
    q_start: torch.Tensor,  # [B] position of the FIRST query token
    *,
    n_heads: int,
    nope: int,
    rope: int,
    v_dim: int,
    positions: torch.Tensor,  # [B,S]
    theta: float,
) -> torch.Tensor:
    """Absorbed-matmul cached attention: scores live in the latent space, the
    cache is only the rank-r latent + shared rope key — the MLA memory win.
    Query token s (global position q_start+s) attends kpos <= q_start+s.
    Every product rounds to the working dtype where the reference's does
    (the two score terms are added in it, then cast to fp32)."""
    B, S, _ = x.shape
    T = c_kv_cache.shape[1]
    q_nope, q_rope = _mla_query(x, p, nope, positions, theta)
    # absorb w_uk into the query: q_lat [B,S,H,r]
    q_lat = torch.einsum("bshe,rhe->bshr", q_nope, p["w_uk"])
    scores = torch.einsum("bshr,btr->bhst", q_lat, c_kv_cache)
    scores = scores + torch.einsum("bshe,bte->bhst", q_rope, k_rope_cache)
    scores = scores.float() / math.sqrt(nope + rope)
    kpos = torch.arange(T, device=x.device)
    qpos = q_start.long()[:, None] + torch.arange(S, device=x.device)[None, :]  # [B,S]
    mask = kpos[None, None, :] <= qpos[:, :, None]  # [B,S,T]
    scores = scores.masked_fill(~mask[:, None, :, :], NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    ctx_lat = torch.einsum("bhst,btr->bshr", probs, c_kv_cache)  # [B,S,H,r]
    v = torch.einsum("bshr,rhe->bshe", ctx_lat, p["w_uv"])  # [B,S,H,v_dim]
    return v.reshape(B, S, n_heads * v_dim)
