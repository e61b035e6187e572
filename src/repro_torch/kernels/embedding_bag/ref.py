"""Plain torch versions of the embedding-bag kernel: gather, then a weighted
sum per bag in fp32 (``src/repro/kernels/embedding_bag/ref.py``).

* :func:`embedding_bag_ref`, the wrapper's CPU path: the reference's
  gather-and-sum.
* :func:`embedding_bag_seq_ref`, the kernel's arithmetic bit for bit: the
  sum over j in order, each product and each sum rounded on its own.
* :func:`embedding_bag_tiled`, the kernel's walk (``ops.plan``,
  ``ops.walk``): tiles, stages, chunks of a long bag carried across stages.
  It equals :func:`embedding_bag_seq_ref` bit for bit.

The gradient goes to the table only (the weights are constants):

* :func:`embedding_bag_bwd_ref`, the dense ``dtable`` that autograd of
  :func:`embedding_bag_ref` gives, summed in fp32 (fp64 for an fp64
  ``dout``) and rounded once.
* :func:`embedding_bag_bwd_seq_ref`, the backward kernel's arithmetic bit
  for bit: the reverse index of :func:`bwd_index`, sums in chunks of its
  positions, the chunks' partial sums added in chunk order.
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


# --------------------------------------------------------------------------
# backward: the table's gradient
# --------------------------------------------------------------------------
def _valid_rows(ids: torch.Tensor, V: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(row, valid) of every id as ``jnp.take`` reads it: [-V, 0) counts from
    the end; an id outside [-V, V) is not valid (its transpose drops it)."""
    ids = ids.long()
    valid = (ids >= -V) & (ids < V)
    return torch.where(ids < 0, ids + V, ids), valid


def embedding_bag_bwd_ref(
    V: int,  # table rows
    ids: torch.Tensor,  # [n_bags, bag_size]
    weights: torch.Tensor | None,  # [n_bags, bag_size]
    dout: torch.Tensor,  # [n_bags, dim], the output's gradient
    combiner: str = "sum",
) -> torch.Tensor:
    """The table's gradient [V, dim] in ``dout``'s dtype:
    ``dtable[v] = sum over (b, j) with ids[b, j] = v of w[b, j] * dout[b]``
    (``dout[b] / bag`` for "mean"), an id in [-V, 0) counting from the end
    and an id outside [-V, V) adding nothing, as ``jax.grad`` of the
    reference's ``jnp.take`` gives.  Summed in fp32 (fp64 for fp64 ``dout``)
    and rounded once; autograd of :func:`embedding_bag_ref` rounds each row's
    share to a bf16 table's dtype before it sums, so in bf16 the two differ
    by that rounding."""
    n_bags, bag = ids.shape
    acc = torch.float64 if dout.dtype == torch.float64 else torch.float32
    g = dout.to(acc)
    if combiner == "mean":
        g = g / bag
    g = g[:, None, :].expand(n_bags, bag, dout.shape[1])
    if weights is not None:
        g = g * weights[..., None].to(acc)
    rows, valid = _valid_rows(ids, V)
    out = torch.zeros(V, dout.shape[1], dtype=acc, device=dout.device)
    return out.index_add_(0, rows[valid], g[valid]).to(dout.dtype)


def bwd_index(ids: torch.Tensor, V: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The backward kernel's reverse index of ``ids [n_bags, bag]``, built
    on their device with no read back to the host: (key, pos), both [n]
    int32, the flat positions ``b * bag + j`` sorted stably by the row they
    read (so increasing within a row), ``key`` that row.  An id outside
    [-V, V) gets key V and sorts after every row."""
    rows, valid = _valid_rows(ids.reshape(-1), V)
    key = torch.where(valid, rows, V).int()
    key, pos = torch.sort(key, stable=True)
    return key, pos.int()


def embedding_bag_bwd_seq_ref(
    V: int,
    ids: torch.Tensor,  # [n_bags, bag_size]
    weights: torch.Tensor | None,  # [n_bags, bag_size]
    dout: torch.Tensor,  # [n_bags, dim]
    combiner: str = "sum",
    chunk: int | None = None,  # positions a block takes; None: ops.bwd_chunk(dim)
) -> torch.Tensor:
    """The backward kernel's oracle, bit for bit.  The term of position
    ``p = b * bag + j`` is ``dout[b]`` in fp32, divided by the bag for
    "mean", times ``w[b, j]`` when weighted, each step rounded on its own.
    The positions, sorted by :func:`bwd_index`, are cut into chunks of
    ``chunk``; in each chunk the run of one row is summed in position order
    from 0 (``acc = acc + term``); a row whose run lies in one chunk is that
    sum, and a row whose positions span chunks c0 .. c1 is
    ``((piece_c0 + piece_c0+1) + ...) + piece_c1``, its pieces added in
    chunk order.  Rows no id reads are 0; the result is rounded once to
    ``dout``'s dtype."""
    n_bags, bag = ids.shape
    dim = dout.shape[1]
    out = torch.zeros(V, dim, dtype=dout.dtype, device=dout.device)
    n = n_bags * bag
    if n == 0 or dim == 0:
        return out
    if chunk is None:
        from .ops import bwd_chunk

        chunk = bwd_chunk(dim)
    key, pos = bwd_index(ids, V)
    pos = pos.long()
    g = dout.float()[pos // bag]
    if combiner == "mean":  # a true division by a tensor, as _finish
        g = g / torch.full_like(g, bag)
    if weights is not None:
        g = g * weights.reshape(-1)[pos].float()[:, None]
    n_chunks = -(-n // chunk)
    pad = n_chunks * chunk - n
    key = torch.cat([key, key.new_full((pad,), V)]).view(n_chunks, chunk)
    g = torch.cat([g, g.new_zeros(pad, dim)]).view(n_chunks, chunk, dim)
    live = key < V
    same_prev = torch.zeros_like(live)
    same_prev[:, 1:] = key[:, 1:] == key[:, :-1]
    same_next = torch.zeros_like(live)
    same_next[:, :-1] = key[:, :-1] == key[:, 1:]
    start, end = live & ~same_prev, live & ~same_next
    acc = torch.zeros(n_chunks, dim, device=dout.device)
    sums = torch.empty(n_chunks, chunk, dim, device=dout.device)
    zero = torch.zeros_like(acc)
    for j in range(chunk):  # each chunk's runs, in position order
        acc = torch.where(start[:, j, None], zero, acc) + g[:, j]
        sums[:, j] = acc
    piece_key, piece = key[end], sums[end]  # in (row, chunk) order
    first = torch.ones_like(piece_key, dtype=torch.bool)
    first[1:] = piece_key[1:] != piece_key[:-1]
    at = torch.arange(len(piece_key), device=dout.device)
    rank = at - torch.cummax(torch.where(first, at, 0), 0).values
    seg = torch.cumsum(first, 0) - 1
    total = torch.empty(int(first.sum()), dim, device=dout.device)
    for r in range(int(rank.max()) + 1):  # the pieces of each row, in chunk order
        sel = rank == r
        total[seg[sel]] = piece[sel] if r == 0 else total[seg[sel]] + piece[sel]
    out[piece_key[first].long()] = total.to(dout.dtype)
    return out
