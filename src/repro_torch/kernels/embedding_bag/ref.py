"""Plain torch version of the embedding-bag kernel: gather, then a weighted
sum per bag in fp32 (``src/repro/kernels/embedding_bag/ref.py``)."""
from __future__ import annotations

import torch


def embedding_bag_ref(
    table: torch.Tensor,  # [V, dim]
    ids: torch.Tensor,  # [n_bags, bag_size]
    weights: torch.Tensor | None = None,  # [n_bags, bag_size]
    combiner: str = "sum",
) -> torch.Tensor:
    """Ids index as ``jnp.take`` does in the reference (and as the kernel
    does): a negative id in [-V, 0) counts from the end, and an id outside
    [-V, V) gathers a row of NaN."""
    V = table.shape[0]
    ids = ids.long()
    valid = (ids >= -V) & (ids < V)
    ids = torch.where(ids < 0, ids + V, ids)
    rows = table[ids.clamp(0, max(V - 1, 0))].float()  # fp32 accumulate
    rows = torch.where(valid[..., None], rows, torch.nan)
    if weights is not None:
        rows = rows * weights[..., None].float()
    out = rows.sum(dim=1)
    if combiner == "mean":
        out = out / ids.shape[1]
    return out.to(table.dtype)
