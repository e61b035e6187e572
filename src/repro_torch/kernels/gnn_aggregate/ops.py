"""Wrapper of the hand-written gated-aggregation kernels
(``csrc/gnn_aggregate.cu``), with the reference wrapper's signature.

``gnn_aggregate`` is a ``torch.autograd.Function`` on CUDA tensors: its
forward launches the forward kernel and its backward launches the dgates and
dh kernels (deterministic: dh sums over a source-sorted list of the real
slots, no atomics).  Tensors on the CPU go to the plain version
(:func:`gnn_aggregate_ref`), which autograd differentiates.  A CUDA tensor
goes to the kernels, or the wrapper raises: there is no fallback.  The
reference pads the width to 128 TPU lanes; here nothing is padded.
"""
from __future__ import annotations

import ctypes

import torch

from .. import build
from .ref import gnn_aggregate_ref

__all__ = ["gnn_aggregate", "gnn_aggregate_bwd", "gnn_aggregate_fwd"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_fns: dict[str, object] = {}


def _kernel(name: str, n_ptr: int):
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(build.load("gnn_aggregate"), name)
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_longlong] * 2
                       + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _check(h: torch.Tensor, nbr: torch.Tensor, gates: torch.Tensor) -> None:
    if h.device.type != "cuda":
        raise ValueError(f"gnn_aggregate: unsupported device {h.device}")
    for name, t in (("nbr", nbr), ("gates", gates)):
        if t.device != h.device:
            raise ValueError(f"gnn_aggregate: {name} on {t.device}, h on {h.device}")
    if h.dtype not in _DTYPES or gates.dtype != h.dtype:
        raise TypeError(
            f"gnn_aggregate: h and gates must share fp32 or bf16, got {h.dtype}/{gates.dtype}"
        )
    if nbr.dtype != torch.int32:
        raise TypeError(f"gnn_aggregate: nbr must be int32, got {nbr.dtype}")
    if (h.dim() != 2 or nbr.dim() != 2 or h.shape[0] == 0
            or gates.shape != (nbr.shape[0], nbr.shape[1], h.shape[1])):
        raise ValueError(
            f"gnn_aggregate: shapes h {tuple(h.shape)}, nbr {tuple(nbr.shape)}, gates "
            f"{tuple(gates.shape)} are not [N_h>0, dim], [N, max_deg], [N, max_deg, dim]"
        )
    if not (h.is_contiguous() and nbr.is_contiguous() and gates.is_contiguous()):
        raise ValueError("gnn_aggregate: h, nbr and gates must be contiguous")


def _check_rev(h: torch.Tensor, rev_ptr: torch.Tensor, rev_slot: torch.Tensor) -> None:
    for name, t in (("rev_ptr", rev_ptr), ("rev_slot", rev_slot)):
        if t.device != h.device or t.dtype != torch.int32 or t.dim() != 1 \
                or not t.is_contiguous():
            raise ValueError(f"gnn_aggregate: {name} must be a contiguous int32 vector on "
                             f"{h.device}")
    if rev_ptr.shape[0] != h.shape[0] + 1:
        raise ValueError(f"gnn_aggregate: rev_ptr has {rev_ptr.shape[0]} entries, wanted "
                         f"{h.shape[0] + 1}")


def _args(h: torch.Tensor, nbr: torch.Tensor, *tensors: torch.Tensor) -> tuple:
    N, deg = nbr.shape
    dim = h.shape[1]
    vec = build.vector_width(dim, h.element_size(), h, *tensors)
    return N, h.shape[0], dim, deg, vec, _DTYPES[h.dtype]


def gnn_aggregate_fwd(h: torch.Tensor, nbr: torch.Tensor, gates: torch.Tensor) -> torch.Tensor:
    """One launch of the forward kernel: out [N, dim] in h's dtype."""
    _check(h, nbr, gates)
    out = torch.empty(nbr.shape[0], h.shape[1], dtype=h.dtype, device=h.device)
    if out.numel() == 0:
        return out.zero_()
    stream = torch.cuda.current_stream(h.device).cuda_stream
    with torch.cuda.device(h.device):
        err = _kernel("gnn_aggregate_fwd", 4)(
            h.data_ptr(), nbr.data_ptr(), gates.data_ptr(), out.data_ptr(),
            *_args(h, nbr, gates, out), stream,
        )
    if err != 0:
        raise RuntimeError(f"gnn_aggregate forward kernel launch failed: CUDA error {err}")
    gnn_aggregate.launches_fwd += 1
    return out


def gnn_aggregate_bwd(
    h: torch.Tensor, nbr: torch.Tensor, gates: torch.Tensor, dout: torch.Tensor,
    rev_ptr: torch.Tensor, rev_slot: torch.Tensor, *, need_h: bool = True,
    need_gates: bool = True,
) -> tuple[torch.Tensor | None, torch.Tensor | None]:
    """The backward kernels: (dh [N_h, dim], dgates [N, max_deg, dim]) in
    h's dtype, None where not wanted.  Counts one backward launch."""
    _check(h, nbr, gates)
    _check_rev(h, rev_ptr, rev_slot)
    if dout.shape != (nbr.shape[0], h.shape[1]) or dout.dtype != h.dtype \
            or dout.device != h.device or not dout.is_contiguous():
        raise ValueError("gnn_aggregate: dout must be contiguous, [N, dim] and typed as h")
    dh = torch.empty_like(h) if need_h else None
    dgates = torch.empty_like(gates) if need_gates else None
    if dout.numel() == 0 or not (need_h or need_gates):
        return (dh.zero_() if dh is not None else None,
                dgates.zero_() if dgates is not None else None)
    outs = [t for t in (dh, dgates) if t is not None]
    stream = torch.cuda.current_stream(h.device).cuda_stream
    ptr = lambda t: t.data_ptr() if t is not None else None
    with torch.cuda.device(h.device):
        err = _kernel("gnn_aggregate_bwd", 8)(
            h.data_ptr(), nbr.data_ptr(), gates.data_ptr(), dout.data_ptr(),
            rev_ptr.data_ptr(), rev_slot.data_ptr(), ptr(dgates), ptr(dh),
            *_args(h, nbr, gates, dout, *outs), stream,
        )
    if err != 0:
        raise RuntimeError(f"gnn_aggregate backward kernel launch failed: CUDA error {err}")
    gnn_aggregate.launches_bwd += 1
    return dh, dgates


class _GnnAggregate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, nbr, gates, rev_ptr, rev_slot):
        out = gnn_aggregate_fwd(h, nbr, gates)
        ctx.save_for_backward(h, nbr, gates, rev_ptr, rev_slot)
        return out

    @staticmethod
    def backward(ctx, dout):
        h, nbr, gates, rev_ptr, rev_slot = ctx.saved_tensors
        dh, dgates = gnn_aggregate_bwd(
            h, nbr, gates, dout.contiguous(), rev_ptr, rev_slot,
            need_h=ctx.needs_input_grad[0], need_gates=ctx.needs_input_grad[2],
        )
        return dh, None, dgates, None, None


def gnn_aggregate(
    h: torch.Tensor,  # [N_h, dim]
    nbr: torch.Tensor,  # [N, max_deg] int32, padding -> 0
    gates: torch.Tensor,  # [N, max_deg, dim], padding -> 0
    rev: tuple[torch.Tensor, torch.Tensor],  # EllIndex.rev of the graph nbr was built from
) -> torch.Tensor:
    """out[n] = sum_j gates[n,j] * h[nbr[n,j]], accumulated in fp32; [N, dim]
    in h's dtype; differentiable in h and gates.  ``rev`` is the
    (rev_ptr, rev_slot) source index of the real slots (:attr:`EllIndex.rev`,
    built with ``nbr`` by :func:`ell_index`) that the backward kernel sums
    dh over; the plain version on the CPU does not read it."""
    if h.device.type == "cpu":
        return gnn_aggregate_ref(h, nbr, gates)
    _check(h, nbr, gates)
    _check_rev(h, *rev)
    return _GnnAggregate.apply(h, nbr, gates, *rev)


# kernel launches: forward-kernel calls and backward calls (each backward
# call launches the dgates and the dh kernel) that reached the card, and
# nowhere else.  Callers that prove a path went through the kernels set them
# to 0 and read them.
gnn_aggregate.launches_fwd = 0
gnn_aggregate.launches_bwd = 0
