"""Synthetic batch generators matching input_specs, LM family, on torch.

Values come from numpy's generator, as in the reference, so the same seed
gives the same batch in both packages.  GNN and recsys cells are not ported
yet (``input_specs`` raises for them).
"""
from __future__ import annotations

import numpy as np
import torch

from ..configs.base import LMConfig, ShapeCell, input_specs


def make_batch(
    cfg: LMConfig, cell: ShapeCell, seed: int = 0, device: str | torch.device = "cuda"
) -> dict:
    """Materialize a concrete batch with the exact spec shapes/dtypes on
    ``device``."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_batch: device='cuda' requested but CUDA is not available")
    rng = np.random.default_rng(seed)
    return {name: _fill(rng, name, spec, cfg, cell, device)
            for name, spec in input_specs(cfg, cell).items()}


def _fill(rng, name, spec, cfg: LMConfig, cell: ShapeCell, device):
    if isinstance(spec, dict):  # nested (decode cache)
        return {k: _fill(rng, k, v, cfg, cell, device) for k, v in spec.items()}
    shape, dtype = spec.shape, spec.dtype
    if name in ("tokens", "targets"):
        a = torch.from_numpy(rng.integers(0, cfg.vocab, size=shape).astype(np.int32))
        return a.to(device)
    if name == "cache_len":
        return torch.full(shape, cell.params["seq_len"] // 2, dtype=torch.int32, device=device)
    if dtype.is_floating_point:
        # float64 -> float32 -> dtype, the rounding path of jnp.asarray(...).astype
        x = torch.from_numpy(rng.normal(size=shape) * 0.1).float()
        return x.to(dtype).to(device)
    return torch.zeros(shape, dtype=dtype, device=device)
