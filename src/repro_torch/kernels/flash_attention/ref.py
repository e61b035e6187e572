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


# --------------------------------------------------------------------------
# The fp32 kernels' arithmetic (variant "tf32x3"), for the tests on the CPU
# --------------------------------------------------------------------------
def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """fp32 ``x`` rounded to TF32 (10 explicit mantissa bits, the low 13 bits
    zero), to nearest with ties away from zero: ``cvt.rna.tf32.f32``."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split_tf32(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo): hi = tf32(x), lo = tf32(x - hi), as the kernels' split pass
    and their staging of P and dS write them."""
    hi = tf32_round(x)
    return hi, tf32_round(x.float() - hi)


def einsum_tf32(eq: str, a: torch.Tensor, b: torch.Tensor, passes: int = 3) -> torch.Tensor:
    """``einsum(eq, a, b)`` with each fp32 product a.b taken as the kernels
    take it on the tensor cores: a_hi.b_lo + a_lo.b_hi + a_hi.b_hi (three
    passes; each product of tf32 values is exact in fp32, the sums fp32), or
    a_hi.b_hi alone (one TF32 pass)."""
    ah, al = split_tf32(a)
    bh, bl = split_tf32(b)
    if passes == 1:
        return torch.einsum(eq, ah, bh)
    if passes != 3:
        raise ValueError(f"passes must be 1 or 3, got {passes}")
    return torch.einsum(eq, ah, bl) + torch.einsum(eq, al, bh) + torch.einsum(eq, ah, bh)


def attention_tf32x3(
    q: torch.Tensor,  # [B,Sq,Hq,d] fp32
    k: torch.Tensor,  # [B,Sk,Hkv,d]
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
    passes: int = 3,
) -> torch.Tensor:
    """Attention as the fp32 forward kernel computes it: S = Q.K^T in tf32
    products, the softmax in fp32 on the unnormalised exponentials, O =
    P.V in tf32 products, then divided by the row sums.  Used by tests
    only; the wrapper's CPU path is :func:`attention_ref`."""
    B, Sq, Hq, d = q.shape
    _, Sk, Hkv, _ = k.shape
    qg = q.float().reshape(B, Sq, Hkv, Hq // Hkv, d)
    s = einsum_tf32("bskgd,btkd->bkgst", qg, k.float(), passes) / math.sqrt(d)
    qpos = torch.arange(Sq)[:, None]
    kpos = torch.arange(Sk)[None, :]
    mask = torch.ones(Sq, Sk, dtype=torch.bool)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    s = s.masked_fill(~mask, -torch.inf)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    out = einsum_tf32("bkgst,btkd->bskgd", p, v.float(), passes)
    out = out / p.sum(dim=-1).permute(0, 3, 1, 2)[..., None]
    return out.reshape(B, Sq, Hq, d)
