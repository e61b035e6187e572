"""Wrapper of the hand-written gated-aggregation kernels
(``csrc/gnn_aggregate.cu``): one forward and one backward over a row-pointer
(CSR) index of the slots, and the reference wrapper's padded-ELL contract on
the same kernels.

``gnn_aggregate_csr`` is the model's call: ``num`` (and, when asked, ``den``)
over the slots of each row, differentiable in h and the gates.
``gnn_aggregate`` keeps the reference wrapper's signature over a padded-ELL
table, the case ``row_ptr[n] = n * max_deg`` (:func:`ell_as_csr`).  On CUDA
tensors both go through ``torch.autograd.Function`` to the kernels: one
forward launch, and one backward launch that writes dgates per slot and dh
per source over the source-sorted reverse list (deterministic, no atomics).
Tensors on the CPU go to the plain versions (:func:`gnn_aggregate_csr_ref`,
:func:`gnn_aggregate_ref`), which autograd differentiates.  A CUDA tensor
goes to the kernels, or the wrapper raises: there is no fallback.  A
tensor on the ``meta`` device (the dry-run) takes an explicit shape-only
path through the same functions: the outputs and gradients as meta tensors,
each launch's FLOPs and bytes reported to :mod:`repro_torch.kernels.meta` in
its place, and no launch.  The reference pads the width to 128 TPU lanes;
here nothing is padded.
"""
from __future__ import annotations

import ctypes

import torch

from .. import build, meta
from .ref import ell_as_csr, gnn_aggregate_csr_ref, gnn_aggregate_ref

__all__ = ["gnn_aggregate", "gnn_aggregate_bwd", "gnn_aggregate_csr", "gnn_aggregate_fwd",
           "reset_launches"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
LAYOUTS = ("csr", "ell")
_fns: dict[str, object] = {}


def _kernel(name: str, n_ptr: int):
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(build.load("gnn_aggregate"), name)
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_longlong] * 2
                       + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _index_vector(name: str, t: torch.Tensor, device: torch.device) -> None:
    if t.device != device or t.dtype != torch.int32 or t.dim() != 1 or not t.is_contiguous():
        raise ValueError(f"gnn_aggregate: {name} must be a contiguous int32 vector on {device}, "
                         f"got {t.dtype} {tuple(t.shape)} on {t.device}")


def _check(h: torch.Tensor, row_ptr: torch.Tensor, col: torch.Tensor, gates: torch.Tensor,
           rev: tuple[torch.Tensor, torch.Tensor, torch.Tensor] | None = None) -> None:
    if h.device.type not in ("cuda", "meta"):
        raise ValueError(f"gnn_aggregate: unsupported device {h.device}")
    if gates.device != h.device:
        raise ValueError(f"gnn_aggregate: gates on {gates.device}, h on {h.device}")
    if h.dtype not in _DTYPES or gates.dtype != h.dtype:
        raise TypeError(
            f"gnn_aggregate: h and gates must share fp32 or bf16, got {h.dtype}/{gates.dtype}"
        )
    for name, t in (("row_ptr", row_ptr), ("col", col)):
        _index_vector(name, t, h.device)
    if (h.dim() != 2 or h.shape[0] == 0 or row_ptr.shape[0] < 2
            or gates.shape != (col.shape[0], h.shape[1])):
        raise ValueError(
            f"gnn_aggregate: shapes h {tuple(h.shape)}, row_ptr {tuple(row_ptr.shape)}, col "
            f"{tuple(col.shape)}, gates {tuple(gates.shape)} are not [N_h>0, dim], [N+1>1], "
            f"[slots], [slots, dim]"
        )
    if col.shape[0] >= 2**31:
        raise ValueError(f"gnn_aggregate: {col.shape[0]} slots overflow int32")
    if not (h.is_contiguous() and gates.is_contiguous()):
        raise ValueError("gnn_aggregate: h and gates must be contiguous")
    if rev is not None:
        for name, t in zip(("rev_ptr", "rev_slot", "rev_row"), rev):
            _index_vector(name, t, h.device)
        if rev[0].shape[0] != h.shape[0] + 1 or rev[1].shape != rev[2].shape:
            raise ValueError(
                f"gnn_aggregate: rev_ptr has {rev[0].shape[0]} entries (wanted "
                f"{h.shape[0] + 1}), rev_slot {rev[1].shape[0]}, rev_row {rev[2].shape[0]}"
            )


def _launch(name: str, n_ptr: int, h: torch.Tensor, ptrs: list, rows: int, rows_t: list,
            layout: str) -> None:
    """One launch; ``rows_t`` are the tensors read or written as rows of dim
    (their alignment bounds the vector width)."""
    dim = h.shape[1]
    vec = build.vector_width(dim, h.element_size(), *rows_t)
    stream = torch.cuda.current_stream(h.device).cuda_stream
    with torch.cuda.device(h.device):
        err = _kernel(name, n_ptr)(*ptrs, rows, h.shape[0], dim, vec, _DTYPES[h.dtype], stream)
    if err != 0:
        raise RuntimeError(f"gnn_aggregate: {name} launch failed: CUDA error {err}")
    gnn_aggregate.launches_by_layout[layout] += 1


def _record(name: str, h: torch.Tensor, n_rows: int, n_slots: int, outs: int,
            backward: bool) -> None:
    """A meta call's count over the real slots: the index, the gates (one
    row a slot) and a row of h for each slot (at most every row of h) read;
    forward: num (and den) written, a multiply-add an element of a slot (and
    an add for den); backward: dnum (and dden) read at every row, the
    reverse list read, dgates and dh written, a multiply an element of a
    slot for dgates (and an add for dden) and a multiply-add for dh.  fp32
    work on the CUDA cores."""
    dim, isz, Nh = h.shape[1], h.element_size(), h.shape[0]
    gates = n_slots * dim * isz
    rows = min(n_slots, Nh) * dim * isz
    if backward:
        nbytes = (outs * n_rows * dim * isz + rows + gates + (n_rows + 1 + n_slots) * 4
                  + (Nh + 1 + 2 * n_slots) * 4 + gates + Nh * dim * isz)
        flops = n_slots * dim * (outs + 2)
    else:
        nbytes = (n_rows + 1 + n_slots) * 4 + gates + rows + outs * n_rows * dim * isz
        flops = n_slots * dim * (1 + outs)
    meta.record(name, flops, nbytes, "fp32")


def _ptr(t: torch.Tensor | None):
    return t.data_ptr() if t is not None else None


def gnn_aggregate_fwd(
    h: torch.Tensor, row_ptr: torch.Tensor, col: torch.Tensor, gates: torch.Tensor, *,
    with_den: bool = False, layout: str = "csr",
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """One launch of the forward kernel: (num [N, dim], den [N, dim] or
    None) in h's dtype.  ``layout`` names the index for the launch counts."""
    _check(h, row_ptr, col, gates)
    N = row_ptr.shape[0] - 1
    num = torch.empty(N, h.shape[1], dtype=h.dtype, device=h.device)
    den = torch.empty_like(num) if with_den else None
    outs = [t for t in (num, den) if t is not None]
    if h.device.type == "meta":  # the dry-run: no launch
        _record("gnn_aggregate_fwd", h, N, col.shape[0], len(outs), False)
        return num, den
    _launch("gnn_aggregate_fwd", 6, h,
            [h.data_ptr(), row_ptr.data_ptr(), col.data_ptr(), gates.data_ptr(), num.data_ptr(),
             _ptr(den)], N, [h, gates, *outs], layout)
    gnn_aggregate.launches_fwd += 1
    return num, den


def gnn_aggregate_bwd(
    h: torch.Tensor, row_ptr: torch.Tensor, col: torch.Tensor, gates: torch.Tensor,
    dnum: torch.Tensor, dden: torch.Tensor | None,
    rev: tuple[torch.Tensor, torch.Tensor, torch.Tensor], *, need_h: bool = True,
    need_gates: bool = True, layout: str = "csr",
) -> tuple[torch.Tensor | None, torch.Tensor | None]:
    """One launch of the backward kernel: (dh [N_h, dim], dgates [slots,
    dim]) in h's dtype, None where not wanted.  ``rev`` is the (rev_ptr,
    rev_slot, rev_row) source-sorted list of the slots that dh sums over."""
    _check(h, row_ptr, col, gates, rev)
    N = row_ptr.shape[0] - 1
    for name, t in (("dnum", dnum), ("dden", dden)):
        if t is not None and (t.shape != (N, h.shape[1]) or t.dtype != h.dtype
                              or t.device != h.device or not t.is_contiguous()):
            raise ValueError(f"gnn_aggregate: {name} must be contiguous, [N, dim] and typed as h")
    dh = torch.empty_like(h) if need_h else None
    dgates = torch.empty_like(gates) if need_gates else None
    if not (need_h or need_gates):
        return dh, dgates
    if h.device.type == "meta":  # the dry-run: no launch
        _record("gnn_aggregate_bwd", h, N, col.shape[0], 1 if dden is None else 2, True)
        return dh, dgates
    rows_t = [t for t in (h, gates, dnum, dden, dh, dgates) if t is not None]
    _launch("gnn_aggregate_bwd", 11, h,
            [h.data_ptr(), row_ptr.data_ptr(), col.data_ptr(), gates.data_ptr(),
             dnum.data_ptr(), _ptr(dden), *(t.data_ptr() for t in rev), _ptr(dgates),
             _ptr(dh)], N, rows_t, layout)
    gnn_aggregate.launches_bwd += 1
    return dh, dgates


class _Aggregate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, gates, row_ptr, col, rev_ptr, rev_slot, rev_row, with_den, layout):
        num, den = gnn_aggregate_fwd(h, row_ptr, col, gates, with_den=with_den, layout=layout)
        ctx.save_for_backward(h, gates, row_ptr, col, rev_ptr, rev_slot, rev_row)
        ctx.layout = layout
        return num, den

    @staticmethod
    def backward(ctx, dnum, dden):
        h, gates, row_ptr, col, *rev = ctx.saved_tensors
        dh, dgates = gnn_aggregate_bwd(
            h, row_ptr, col, gates, dnum.contiguous(),
            dden.contiguous() if dden is not None else None, tuple(rev),
            need_h=ctx.needs_input_grad[0], need_gates=ctx.needs_input_grad[1],
            layout=ctx.layout,
        )
        return dh, dgates, None, None, None, None, None, None, None


def gnn_aggregate_csr(
    h: torch.Tensor,  # [N_h, dim]
    row_ptr: torch.Tensor,  # [N+1] int32: the slots of row n are row_ptr[n]..row_ptr[n+1]
    col: torch.Tensor,  # [slots] int32: the source of each slot
    gates: torch.Tensor,  # [slots, dim]
    rev: tuple[torch.Tensor, torch.Tensor, torch.Tensor],  # CsrIndex.rev of the same index
    *, with_den: bool = False,
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """(num, den): num[n] = sum over the slots k of row n of gates[k] *
    h[col[k]], den[n] the sum of those gates (None unless ``with_den``),
    accumulated in fp32; [N, dim] in h's dtype; differentiable in h and
    gates.  ``rev`` is the (rev_ptr, rev_slot, rev_row) source-sorted list of
    the slots (:attr:`CsrIndex.rev`) that the backward kernel sums dh over;
    the plain version on the CPU does not read it."""
    if h.device.type == "cpu":
        return gnn_aggregate_csr_ref(h, row_ptr, col, gates, with_den)
    _check(h, row_ptr, col, gates, rev)
    return _Aggregate.apply(h, gates, row_ptr, col, *rev, with_den, "csr")


def gnn_aggregate(
    h: torch.Tensor,  # [N_h, dim]
    nbr: torch.Tensor,  # [N, max_deg] int32, padding -> 0
    gates: torch.Tensor,  # [N, max_deg, dim], padding -> 0
    rev: tuple[torch.Tensor, torch.Tensor],  # EllIndex.rev of the graph nbr was built from
) -> torch.Tensor:
    """The reference wrapper's contract: out[n] = sum_j gates[n,j] *
    h[nbr[n,j]], accumulated in fp32; [N, dim] in h's dtype; differentiable
    in h and gates.  ``rev`` is the (rev_ptr, rev_slot) source index of the
    real slots (:attr:`EllIndex.rev`, built with ``nbr`` by
    :func:`ell_index`); on CUDA the table runs as its CSR index
    (:func:`ell_as_csr`) through the same kernels.  The plain version on the
    CPU does not read ``rev``."""
    if h.device.type == "cpu":
        return gnn_aggregate_ref(h, nbr, gates)
    if nbr.dim() != 2 or gates.shape != (*nbr.shape, h.shape[-1]):
        raise ValueError(
            f"gnn_aggregate: shapes h {tuple(h.shape)}, nbr {tuple(nbr.shape)}, gates "
            f"{tuple(gates.shape)} are not [N_h>0, dim], [N, max_deg], [N, max_deg, dim]"
        )
    if nbr.dtype != torch.int32:
        raise TypeError(f"gnn_aggregate: nbr must be int32, got {nbr.dtype}")
    if nbr.numel() >= 2**31:
        raise ValueError(f"gnn_aggregate: {tuple(nbr.shape)} slots overflow int32")
    if not (nbr.is_contiguous() and gates.is_contiguous()):
        raise ValueError("gnn_aggregate: nbr and gates must be contiguous")
    for name, t in zip(("rev_ptr", "rev_slot"), rev):
        _index_vector(name, t, h.device)
    row_ptr, col, rev3 = ell_as_csr(nbr, rev)
    flat = gates.view(nbr.numel(), gates.shape[-1])
    _check(h, row_ptr, col, flat, rev3)
    return _Aggregate.apply(h, flat, row_ptr, col, *rev3, False, "ell")[0]


# Kernel launches that reached the card, and nowhere else: forward launches
# (``launches_fwd``), backward launches (``launches_bwd``; one kernel writes
# both dgates and dh), and both by the index they ran on
# (``launches_by_layout``: "csr", or "ell" for the padded-ELL contract).
# Callers that prove a path went through the kernels reset them
# (reset_launches) and read them.
def reset_launches() -> None:
    gnn_aggregate.launches_fwd = 0
    gnn_aggregate.launches_bwd = 0
    gnn_aggregate.launches_by_layout = {layout: 0 for layout in LAYOUTS}


reset_launches()
