"""Synthetic batch generators matching input_specs for every family/cell,
on torch.

Values come from numpy's generator, as in the reference, so the same seed
gives the same batch in both packages; tensors go to an explicit device.

With a ``torch.Generator`` (``generator=``) the normal floating inputs, the
decode cache included, are drawn instead on the generator's device, in place
in the spec's dtype (the cache a layer at a time): no float64 or fp32 copy
of them exists, so a cache of tens of GB is made on the card.  The integer
inputs still come from numpy, and equal the numpy path's for the same seed
where no normal draw precedes them (every LM cell: tokens, then the cache,
then ``cache_len``, which takes no draw).
"""
from __future__ import annotations

import numpy as np
import torch

from ..configs.base import Config, ShapeCell, input_specs


def make_batch(
    cfg: Config, cell: ShapeCell, seed: int = 0, device: str | torch.device | None = None,
    *, generator: torch.Generator | None = None,
) -> dict:
    """Materialize a concrete batch with the exact spec shapes/dtypes on
    ``device`` (default "cuda", or the generator's device).  With
    ``generator`` the normal floating inputs are drawn from it, N(0, 0.1^2),
    on its device (see the module's docstring)."""
    if generator is not None:
        if device is not None and torch.device(device) != generator.device:
            raise ValueError(f"make_batch: generator on {generator.device}, device {device}")
        device = generator.device
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_batch: device='cuda' requested but CUDA is not available")
    rng = np.random.default_rng(seed)
    return {name: _fill(rng, name, spec, cfg, cell, device, generator)
            for name, spec in input_specs(cfg, cell).items()}


def _ints(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a).astype(np.int32)).to(device)


def _normal(shape, dtype, gen: torch.Generator, by_layer: bool) -> torch.Tensor:
    """N(0, 0.1^2) drawn in place in ``dtype`` on the generator's device;
    ``by_layer``: one draw a slice of the leading (layer) axis."""
    out = torch.empty(shape, dtype=dtype, device=gen.device)
    for part in (out.unbind(0) if by_layer and out.dim() else (out,)):
        part.normal_(0.0, 0.1, generator=gen)
    return out


def _fill(rng, name, spec, cfg: Config, cell: ShapeCell, device, gen=None, in_cache=False):
    if isinstance(spec, dict):  # nested (decode cache)
        return {k: _fill(rng, k, v, cfg, cell, device, gen, True) for k, v in spec.items()}
    shape, dtype = spec.shape, spec.dtype
    if name in ("tokens", "targets"):
        return _ints(rng.integers(0, cfg.vocab, size=shape), device)
    if name == "cache_len":
        return torch.full(shape, cell.params["seq_len"] // 2, dtype=torch.int32, device=device)
    if name == "edge_index":
        n = cell.params.get("n_nodes", 16)
        return _ints(rng.integers(0, n, size=shape), device)
    if name == "labels":
        if not dtype.is_floating_point:
            n_cls = getattr(cfg, "n_classes", 2)
            return _ints(rng.integers(0, n_cls, size=shape), device)
        x = torch.from_numpy(rng.integers(0, 2, size=shape).astype(np.float32))
        return x.to(dtype).to(device)
    if name == "train_mask":
        return torch.from_numpy(rng.random(shape) < 0.5).to(device)
    if name == "sparse_ids":
        vocabs = np.asarray(cfg.vocab_sizes, np.int64)
        return _ints(rng.integers(0, vocabs[None, :], size=shape), device)
    if name in ("hist_ids", "target_id", "pos_ids", "neg_ids", "candidate_ids", "seed_ids"):
        hi = getattr(cfg, "item_vocab", 0) or cell.params.get("n_nodes", 1000)
        return _ints(rng.integers(0, hi, size=shape), device)
    if dtype.is_floating_point and gen is not None:
        return _normal(shape, dtype, gen, in_cache)
    if dtype.is_floating_point:
        # float64 -> float32 -> dtype, the rounding path of jnp.asarray(...).astype
        x = torch.from_numpy(rng.normal(size=shape) * 0.1).float()
        return x.to(dtype).to(device)
    return torch.zeros(shape, dtype=dtype, device=device)
