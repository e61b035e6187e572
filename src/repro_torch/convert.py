"""Carry parameters across from the reference package.

The reference's parameter pytree, given as numpy arrays (``np.asarray`` of
each leaf), becomes the port's dict of tensors under the same names and the
same stacked ``[L, ...]`` layout, and back.  bf16 leaves arrive as
``ml_dtypes.bfloat16`` arrays, which ``torch.from_numpy`` rejects: they
cross bit for bit through a ``uint16`` view.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch


def _leaf_to_torch(a: Any, device: torch.device) -> torch.Tensor:
    # an owned copy: the result never shares memory with the caller's array
    a = np.array(a, copy=True, order="C")
    if a.dtype.name == "bfloat16":  # by name: no ml_dtypes import needed
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def params_from_numpy(tree: Any, device: str | torch.device = "cuda") -> Any:
    """Nested dicts and lists of numpy arrays -> the same structure of
    tensors on ``device``."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("params_from_numpy: device='cuda' requested but CUDA is not available")
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [params_from_numpy(v, device) for v in tree]
    return _leaf_to_torch(tree, device)


def params_to_numpy(tree: Any) -> Any:
    """Inverse of :func:`params_from_numpy`: bf16 tensors come back as
    ``ml_dtypes.bfloat16`` arrays."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [params_to_numpy(v) for v in tree]
    t = tree.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        import ml_dtypes  # only this direction needs numpy's bf16 type

        return t.view(torch.uint16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()
