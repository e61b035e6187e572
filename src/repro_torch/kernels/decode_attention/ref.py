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
