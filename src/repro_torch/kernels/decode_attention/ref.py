"""Plain torch oracle for cached decode attention, the counterpart of the
reference package's ``decode_attention/ref.py``: one query row per
(b, q-head), keys ``< lens[b]``."""
from __future__ import annotations

import math

import torch


def decode_attention_ref(
    q: torch.Tensor,  # [B, Hkv, G, d]
    k_cache: torch.Tensor,  # [B, T, Hkv, d]
    v_cache: torch.Tensor,
    lens: torch.Tensor,  # [B]
) -> torch.Tensor:
    B, Hkv, G, d = q.shape
    T = k_cache.shape[1]
    s = torch.einsum("bkgd,btkd->bkgt", q, k_cache).float() / math.sqrt(d)
    mask = torch.arange(T, device=q.device)[None, :] < lens.long()[:, None]
    s = s.masked_fill(~mask[:, None, None, :], -1e30)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bkgt,btkd->bkgd", p, v_cache)


def _combine(parts: list) -> tuple | None:
    """Partials (m, l, acc) combined in order, each weighted by exp(m - M);
    empty ones (None) skipped.  None when every one is empty."""
    parts = [p for p in parts if p is not None]
    if not parts:
        return None
    M = torch.stack([m for m, _, _ in parts]).amax(0)
    L, A = torch.zeros_like(M), torch.zeros_like(parts[0][2])
    for m, l, acc in parts:
        w = torch.exp(m - M)
        L = L + w * l
        A = A + w[..., None] * acc
    return M, L, A


def fused_two_level_ref(
    q: torch.Tensor,  # [B, 1, Hq, d]
    k_cache: torch.Tensor,  # [B, T, Hkv, d], the new row already written
    v_cache: torch.Tensor,
    ranges: list[list[tuple[int, int]]],  # per sequence, each split's keys (lo, hi)
    cluster: int,
) -> torch.Tensor:
    """The fused decode kernel's arithmetic in plain torch, fp32: a partial
    (m, l, unnormalised acc) per split over its keys ``ranges[b][s]`` (as
    ``ops.fused_partition`` gives them), the splits of each cluster of
    ``cluster`` combined in rank order, then the clusters in cluster order.
    Returns [B, 1, Hq, d] fp32."""
    B, _, Hq, d = q.shape
    Hkv = k_cache.shape[2]
    G = Hq // Hkv
    out = torch.empty(B, 1, Hq, d, dtype=torch.float32, device=q.device)
    for b in range(B):
        qb = q[b, 0].float().reshape(Hkv, G, d)
        parts = []
        for lo, hi in ranges[b]:
            if lo > hi:
                parts.append(None)
                continue
            s = torch.einsum("kgd,nkd->kgn", qb, k_cache[b, lo:hi + 1].float()) / math.sqrt(d)
            m = s.amax(-1)
            p = torch.exp(s - m[..., None])
            parts.append((m, p.sum(-1), torch.einsum("kgn,nkd->kgd", p,
                                                     v_cache[b, lo:hi + 1].float())))
        clusters = [_combine(parts[c:c + cluster]) for c in range(0, len(parts), cluster)]
        _, L, A = _combine(clusters)
        out[b, 0] = (A / L[..., None]).reshape(Hq, d)
    return out
