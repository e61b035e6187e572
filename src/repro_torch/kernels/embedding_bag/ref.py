"""Plain torch versions of the embedding-bag kernel: gather, then a weighted
sum per bag in fp32 (``src/repro/kernels/embedding_bag/ref.py``).

* :func:`embedding_bag_ref`, the wrapper's CPU path: the reference's
  gather-and-sum.
* :func:`embedding_bag_seq_ref`, the kernel's arithmetic bit for bit: the
  sum over j in order, each product and each sum rounded on its own.
* :func:`embedding_bag_tiled`, the kernel's walk (``ops.plan``,
  ``ops.walk``): tiles, stages, chunks of a long bag carried across stages.
  It equals :func:`embedding_bag_seq_ref` bit for bit.
"""
from __future__ import annotations

import torch


def _rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]`` in fp32 as ``jnp.take`` gathers: a negative id in
    [-V, 0) counts from the end, an id outside [-V, V) gives a row of NaN."""
    V = table.shape[0]
    ids = ids.long()
    valid = (ids >= -V) & (ids < V)
    ids = torch.where(ids < 0, ids + V, ids)
    rows = table[ids.clamp(0, max(V - 1, 0))].float()
    return torch.where(valid[..., None], rows, torch.nan)


def embedding_bag_ref(
    table: torch.Tensor,  # [V, dim]
    ids: torch.Tensor,  # [n_bags, bag_size]
    weights: torch.Tensor | None = None,  # [n_bags, bag_size]
    combiner: str = "sum",
) -> torch.Tensor:
    """Ids index as ``jnp.take`` does in the reference (and as the kernel
    does): a negative id in [-V, 0) counts from the end, and an id outside
    [-V, V) gathers a row of NaN."""
    rows = _rows(table, ids)  # fp32 accumulate
    if weights is not None:
        rows = rows * weights[..., None].float()
    out = rows.sum(dim=1)
    if combiner == "mean":
        out = out / ids.shape[1]
    return out.to(table.dtype)


def _finish(acc: torch.Tensor, bag: int, combiner: str, dtype: torch.dtype) -> torch.Tensor:
    if combiner == "mean":  # a true division by a tensor: torch multiplies by 1/bag otherwise
        acc = acc / torch.full_like(acc, bag)
    return acc.to(dtype)


def _accumulate(acc: torch.Tensor, rows: torch.Tensor, w: torch.Tensor | None) -> torch.Tensor:
    """``acc + rows * w`` with the product and the sum rounded on their own."""
    if w is not None:
        rows = rows * w[:, None].float()
    return acc + rows


def embedding_bag_seq_ref(
    table: torch.Tensor,  # [V, dim]
    ids: torch.Tensor,  # [n_bags, bag_size]
    weights: torch.Tensor | None = None,  # [n_bags, bag_size]
    combiner: str = "sum",
) -> torch.Tensor:
    """The kernel's oracle, bit for bit: ``acc = acc + rows[:, j] * w[:, j]``
    for j in order in fp32 (a separate multiply and add), then ``/ bag`` for
    "mean", rounded once to the table's type."""
    n_bags, bag = ids.shape
    acc = torch.zeros(n_bags, table.shape[1], dtype=torch.float32, device=table.device)
    for j in range(bag):
        acc = _accumulate(acc, _rows(table, ids[:, j]), None if weights is None else weights[:, j])
    return _finish(acc, bag, combiner, table.dtype)


def embedding_bag_tiled(
    table: torch.Tensor,  # [V, dim]
    ids: torch.Tensor,  # [n_bags, bag_size]
    weights: torch.Tensor | None,  # [n_bags, bag_size]
    combiner: str,
    plan,  # ops.Plan of this call
) -> torch.Tensor:
    """The kernel's walk on the CPU: every block of ``plan`` takes its units
    in order; a unit gathers its rows into a stage laid out j-major (slot
    j * tile_bags + bag), and each (bag, vector chunk) pair adds its bag's
    staged rows in j order to a sum carried from the tile's earlier chunks;
    the tile's last chunk finishes the sums and writes the output tile."""
    from .ops import walk

    n_bags, bag = ids.shape
    dim = table.shape[1]
    if (plan.n_bags, plan.bag, plan.dim) != (n_bags, bag, dim):
        raise ValueError(f"embedding_bag_tiled: plan for {(plan.n_bags, plan.bag, plan.dim)}, "
                         f"inputs {(n_bags, bag, dim)}")
    out = torch.empty(n_bags, dim, dtype=table.dtype, device=table.device)
    tb = plan.tile_bags
    for _, units in walk(plan):
        for u in units:
            nb, n = len(u.bags), len(u.ids)
            bags = torch.arange(u.bags.start, u.bags.stop)
            stage = torch.full((plan.chunk_ids * tb, dim), torch.nan)  # a copy fills each slot
            for j in range(n):
                stage[j * tb:j * tb + nb] = _rows(table, ids[bags, u.ids.start + j])
            if u.chunk == 0:
                acc = torch.zeros(nb, dim, dtype=torch.float32, device=table.device)
            for j in range(n):
                w = None if weights is None else weights[bags, u.ids.start + j]
                acc = _accumulate(acc, stage[j * tb:j * tb + nb], w)
            if u.chunk == plan.chunks - 1:
                out[bags] = _finish(acc, bag, combiner, table.dtype)
    return out
