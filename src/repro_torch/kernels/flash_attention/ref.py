"""Plain torch oracle for the flash attention kernel, the counterpart of the
reference package's ``flash_attention/ref.py``.  It casts where the
reference casts: scores leave the product in the working dtype and are then
cast to fp32; probabilities are cast back before the product with V."""
from __future__ import annotations

import math

import torch


def _scores(q, k, *, causal, window):
    """Masked fp32 scores [B,Hkv,G,Sq,Sk] (masked entries -1e30)."""
    B, Sq, Hq, d = q.shape
    _, Sk, Hkv, _ = k.shape
    qg = q.reshape(B, Sq, Hkv, Hq // Hkv, d)
    s = torch.einsum("bskgd,btkd->bkgst", qg, k).float() / math.sqrt(d)
    qpos = torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones(Sq, Sk, dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    return s.masked_fill(~mask, -1e30)


def attention_ref(
    q: torch.Tensor,  # [B,Sq,Hq,d]
    k: torch.Tensor,  # [B,Sk,Hkv,d]
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
) -> torch.Tensor:
    B, Sq, Hq, d = q.shape
    p = torch.softmax(_scores(q, k, causal=causal, window=window), dim=-1).to(q.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", p, v)
    return out.reshape(B, Sq, Hq, d)


def attention_lse_ref(
    q: torch.Tensor, k: torch.Tensor, *, causal: bool = True, window: int | None = None
) -> torch.Tensor:
    """The per-row logsumexp of the scaled, masked scores, fp32 [B,Hq,Sq]:
    what the kernel saves for its backward."""
    B, Sq, Hq, _ = q.shape
    lse = torch.logsumexp(_scores(q, k, causal=causal, window=window), dim=-1)
    return lse.reshape(B, Hq, Sq)  # [B,Hkv,G,Sq] -> heads kvh*G+g in order
