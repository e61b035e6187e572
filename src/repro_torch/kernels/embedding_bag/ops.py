"""Wrapper of the hand-written embedding-bag kernel
(``csrc/embedding_bag.cu``), with the reference wrapper's signature.

A table on the CPU goes to the plain version (:func:`embedding_bag_ref`).  A
table on a CUDA device goes to the kernel, or the wrapper raises: there is no
fallback.  The reference pads the width to 128 TPU lanes; here the kernel
takes any width, so nothing is padded.
"""
from __future__ import annotations

import ctypes

import torch

from .. import build
from .ref import embedding_bag_ref

__all__ = ["embedding_bag", "embedding_bag_ref"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_COMBINERS = ("sum", "mean")
_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = build.load("embedding_bag").embedding_bag_launch
        fn.argtypes = (
            [ctypes.c_void_p] * 4
            + [ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong]
            + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check(table: torch.Tensor, ids: torch.Tensor, weights: torch.Tensor | None,
           combiner: str) -> None:
    if table.device.type != "cuda":
        raise ValueError(f"embedding_bag: unsupported device {table.device}")
    if combiner not in _COMBINERS:
        raise ValueError(f"embedding_bag: combiner must be 'sum' or 'mean', got {combiner!r}")
    if table.dtype not in _DTYPES:
        raise TypeError(f"embedding_bag: table must be fp32 or bf16, got {table.dtype}")
    if ids.dtype != torch.int32:
        raise TypeError(f"embedding_bag: ids must be int32, got {ids.dtype}")
    if table.dim() != 2 or ids.dim() != 2 or table.shape[0] == 0:
        raise ValueError(
            f"embedding_bag: shapes table {tuple(table.shape)}, ids {tuple(ids.shape)} are "
            "not [V>0, dim] and [n_bags, bag_size]"
        )
    tensors = [("ids", ids)] + ([("weights", weights)] if weights is not None else [])
    for name, t in tensors:
        if t.device != table.device:
            raise ValueError(f"embedding_bag: {name} on {t.device}, table on {table.device}")
    if weights is not None:
        if weights.dtype != torch.float32:
            raise TypeError(f"embedding_bag: weights must be fp32, got {weights.dtype}")
        if weights.shape != ids.shape:
            raise ValueError(
                f"embedding_bag: weights {tuple(weights.shape)} differ from ids {tuple(ids.shape)}"
            )
    if not all(t.is_contiguous() for _, t in [("table", table)] + tensors):
        raise ValueError("embedding_bag: table, ids and weights must be contiguous")


def embedding_bag(
    table: torch.Tensor,  # [V, dim]
    ids: torch.Tensor,  # [n_bags, bag_size] int32
    weights: torch.Tensor | None = None,  # [n_bags, bag_size] fp32; None: ones
    *,
    combiner: str = "sum",
) -> torch.Tensor:
    """Per bag, the weighted sum of its rows (``"mean"``: divided by
    bag_size), accumulated in fp32.  Returns [n_bags, dim] in the table's
    dtype.  A negative id in [-V, 0) counts from the end; an id outside
    [-V, V) makes its bag's row NaN."""
    if table.device.type == "cpu":
        return embedding_bag_ref(table, ids, weights, combiner)
    _check(table, ids, weights, combiner)
    n_bags, bag = ids.shape
    dim = table.shape[1]
    out = torch.empty(n_bags, dim, dtype=table.dtype, device=table.device)
    if n_bags == 0 or dim == 0:
        return out
    vec = build.vector_width(dim, table.element_size(), table, out)
    stream = torch.cuda.current_stream(table.device).cuda_stream
    with torch.cuda.device(table.device):
        err = _kernel()(
            table.data_ptr(), ids.data_ptr(),
            weights.data_ptr() if weights is not None else None, out.data_ptr(),
            table.shape[0], dim, n_bags, bag, int(combiner == "mean"), vec,
            _DTYPES[table.dtype], stream,
        )
    if err != 0:
        raise RuntimeError(f"embedding_bag kernel launch failed: CUDA error {err}")
    embedding_bag.launches += 1
    return out


# kernel launches: one per call that reached the card, and nowhere else.
# Callers that prove a path went through the kernel set it to 0 and read it.
embedding_bag.launches = 0
