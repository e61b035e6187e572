"""Wrapper of the hand-written flash-attention kernels
(``csrc/flash_attention.cu``), with the reference wrapper's signature.

``flash_attention`` is a ``torch.autograd.Function`` on CUDA tensors: its
forward launches the forward kernel, which also writes the per-row
logsumexp, and its backward launches the two backward kernels.  Which
kernels take a shape is :func:`variant`'s choice, made from the dtype, the
head dim and the GQA group before any launch: ``"wgmma"`` (bf16, group
dividing 64, every head dim), ``"wmma"`` (other bf16) or ``"fma"`` (fp32).
A tensor on the CPU goes to the plain version (:func:`attention_ref`), which
autograd differentiates.  A CUDA tensor goes to the kernels of its variant,
or the wrapper raises: there is no fallback.
"""
from __future__ import annotations

import ctypes
import math

import torch

from .. import build
from .ref import attention_ref

__all__ = [
    "flash_attention", "flash_attention_bwd", "flash_attention_fwd", "reset_launches", "variant",
]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
VARIANTS = ("fma", "wmma", "wgmma")  # index = the kernels' variant number
_INTS = 8  # B, Sq, Sk, Hq, Hkv, dh, causal, window
_fns: dict[str, object] = {}


def variant(dtype: torch.dtype, dh: int, G: int) -> str:
    """The kernels that take a shape: ``"wgmma"`` for bf16 with a GQA group
    G that divides 64 (the wgmma kernels' 64-row boxes hold whole
    positions), at every head dim; ``"wmma"`` for other bf16; ``"fma"`` for
    fp32.  Raises for what no kernel takes."""
    if dtype not in _DTYPES:
        raise TypeError(f"flash_attention: no kernel for {dtype}; fp32 or bf16")
    if dh <= 0 or dh > 256 or dh % 8:
        raise ValueError(f"flash_attention: head dim {dh} must be a multiple of 8 up to 256")
    if G <= 0:
        raise ValueError(f"flash_attention: GQA group {G} must be positive")
    if dtype == torch.float32:
        return "fma"
    return "wgmma" if 64 % G == 0 else "wmma"


def _kernel(name: str, n_ptr: int):
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(build.load("flash_attention"), name)
        fn.argtypes = (
            [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * _INTS
            + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window: int | None) -> None:
    if q.device.type != "cuda":
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
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(
            f"flash_attention: shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"v {tuple(v.shape)} are not [B,Sq,Hq,d] and [B,Sk,Hkv,d]"
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
    if window is not None and window <= 0:
        raise ValueError(f"flash_attention: window must be positive, got {window}")


def _shape_args(q, k, causal, window) -> tuple[tuple, str]:
    """The kernels' shape arguments, and the variant that takes them."""
    B, Sq, Hq, dh = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    var = variant(q.dtype, dh, Hq // Hkv)
    return (B, Sq, Sk, Hq, Hkv, dh, int(causal), window or 0,
            1.0 / math.sqrt(dh), _DTYPES[q.dtype], VARIANTS.index(var)), var


def flash_attention_fwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
    window: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One launch of the forward kernel: (out [B,Sq,Hq,d] in q's dtype,
    lse fp32 [B,Hq,Sq])."""
    _check(q, k, v, window)
    B, Sq, Hq, _ = q.shape
    out = torch.empty_like(q)
    lse = torch.empty(B, Hq, Sq, dtype=torch.float32, device=q.device)
    args, var = _shape_args(q, k, causal, window)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = _kernel("flash_attention_fwd", 5)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(), *args,
            stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_attention {var} forward launch failed: CUDA error {err}")
    flash_attention.launches_fwd += 1
    flash_attention.launches_by_variant[var]["fwd"] += 1
    return out, lse


def flash_attention_bwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
    lse: torch.Tensor, dout: torch.Tensor, *, causal: bool = True, window: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The two backward kernels (dK/dV per key tile, dQ per row tile):
    (dq, dk, dv) in the inputs' dtype.  Counts one backward launch.  The
    wgmma variant runs dQ first, which writes D = rowsum(dO * O) once into an
    fp32 [B,Hq,Sq] scratch that the dK/dV kernel reads."""
    _check(q, k, v, window)
    if (out.shape != q.shape or dout.shape != q.shape or out.dtype != q.dtype
            or dout.dtype != q.dtype or not (out.is_contiguous() and dout.is_contiguous())
            or dout.data_ptr() % 16):
        raise ValueError("flash_attention: out and dout must be contiguous, shaped and typed "
                         "as q, and dout must start on a 16-byte boundary")
    if lse.dtype != torch.float32 or lse.shape != (q.shape[0], q.shape[2], q.shape[1]):
        raise ValueError(f"flash_attention: lse must be fp32 [B,Hq,Sq], got {tuple(lse.shape)}")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    args, var = _shape_args(q, k, causal, window)
    delta = torch.empty_like(lse) if var == "wgmma" else None
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = _kernel("flash_attention_bwd", 10)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), None if delta is None else delta.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), *args, stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_attention {var} backward launch failed: CUDA error {err}")
    flash_attention.launches_bwd += 1
    flash_attention.launches_by_variant[var]["bwd"] += 1
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
    q: torch.Tensor,  # [B,Sq,Hq,d]
    k: torch.Tensor,  # [B,Sk,Hkv,d]
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
) -> torch.Tensor:
    """Query position s attends key t < Sk with (causal) t <= s and (window)
    t > s - window.  Returns [B,Sq,Hq,d] in q's dtype; differentiable."""
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window)
    _check(q, k, v, window)
    return _FlashAttention.apply(q, k, v, causal, window)


# kernel launches: forward-kernel calls and backward calls (each backward
# call launches the dK/dV and the dQ kernel) that reached the card, and
# nowhere else; launches_by_variant splits them by variant().  Callers that
# prove a path went through the kernels reset them (reset_launches) and read
# them.
def reset_launches() -> None:
    flash_attention.launches_fwd = 0
    flash_attention.launches_bwd = 0
    flash_attention.launches_by_variant = {v: {"fwd": 0, "bwd": 0} for v in VARIANTS}


reset_launches()
