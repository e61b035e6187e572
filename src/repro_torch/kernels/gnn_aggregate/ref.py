"""Plain torch versions of the gated neighbour aggregation, and the layouts
they run on (``src/repro/kernels/gnn_aggregate/ref.py``).

The row-pointer (CSR) layout, the model's: the slots of row n are
``row_ptr[n]..row_ptr[n+1]``, slot k gathers ``h[col[k]]`` with gate row
``gates[k]``.  ``csr_index`` builds it from COO edges on their own device,
with torch ops and no read back to the host: slot k is the k-th edge in
destination order, and a source-sorted list of the slots (with each slot's
row) is what the deterministic backward kernel sums dh over.

The padded-ELL layout, the Pallas contract's: node n's in-edges fill slots
0.. of row n of ``nbr [N, max_deg]`` (their sources) and of ``gates [N,
max_deg, dim]``, in input order; padding slots point at row 0 with zero
gates.  ``ell_index`` builds it on the host with ``max_deg`` the graph's
largest in-degree, so no edge is dropped, together with the per-edge slots
and the source-sorted list of real slots; ``ell_as_csr`` gives its CSR form
(``row_ptr[n] = n * max_deg``), on which the kernels run it.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


def gnn_aggregate_ref(h: torch.Tensor, nbr: torch.Tensor, gates: torch.Tensor) -> torch.Tensor:
    """out[n] = sum_j gates[n,j] * h[nbr[n,j]] in fp32, in h's dtype.  Ids
    index as ``jnp.take`` does in the reference (and as the kernel does): a
    negative id in [-N_h, 0) counts from the end, and an id outside
    [-N_h, N_h) gathers a row of NaN."""
    n_rows = h.shape[0]
    nbr = nbr.long()
    valid = (nbr >= -n_rows) & (nbr < n_rows)
    nbr = torch.where(nbr < 0, nbr + n_rows, nbr)
    rows = h[nbr.clamp(0, max(n_rows - 1, 0))].float()  # [N, deg, dim]
    rows = torch.where(valid[..., None], rows, torch.nan)
    return (rows * gates.float()).sum(dim=1).to(h.dtype)


def gnn_aggregate_csr_ref(
    h: torch.Tensor, row_ptr: torch.Tensor, col: torch.Tensor, gates: torch.Tensor,
    with_den: bool = False,
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """(num, den) in h's dtype, [N, dim] for ``row_ptr [N+1]``: num[n] the
    sum over the slots k in [row_ptr[n], row_ptr[n+1]) of gates[k] *
    h[col[k]], den[n] the sum of those gates (None unless ``with_den``), both
    in fp32; a row with no slot is 0.  Ids index as in
    :func:`gnn_aggregate_ref`."""
    n_rows, N = h.shape[0], row_ptr.shape[0] - 1
    ids = col.long()
    valid = (ids >= -n_rows) & (ids < n_rows)
    ids = torch.where(ids < 0, ids + n_rows, ids).clamp(0, max(n_rows - 1, 0))
    rows = torch.where(valid[:, None], h[ids].float(), torch.nan)  # [slots, dim]
    g = gates.float()
    # 1 + the row of each slot; 0 and N + 1 collect slots outside every row
    seg = torch.searchsorted(row_ptr, torch.arange(col.shape[0], dtype=row_ptr.dtype,
                                                   device=row_ptr.device), right=True)

    def seg_sum(x: torch.Tensor) -> torch.Tensor:
        out = torch.zeros(N + 2, x.shape[1], dtype=torch.float32, device=x.device)
        return out.index_add_(0, seg, x)[1:-1].to(h.dtype)

    return seg_sum(rows * g), (seg_sum(g) if with_den else None)


@dataclass(frozen=True)
class CsrIndex:
    """One graph's row-pointer index over its real edges, as tensors on the
    edges' device.  Slot k is the k-th edge in destination order (a stable
    sort: the edges into one node keep their input order)."""

    perm: torch.Tensor  # [E] int64: slot k holds input edge perm[k]
    row_ptr: torch.Tensor  # [N+1] int32: the slots of node n are row_ptr[n]..row_ptr[n+1]
    col: torch.Tensor  # [E] int32: the source of each slot
    rev_ptr: torch.Tensor  # [N+1] int32: slots with source m at rev_slot[rev_ptr[m]:rev_ptr[m+1]]
    rev_slot: torch.Tensor  # [E] int32, grouped by source, increasing within a source
    rev_row: torch.Tensor  # [E] int32: the destination of each rev_slot

    @property
    def rev(self) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        return self.rev_ptr, self.rev_slot, self.rev_row


def csr_index(edge_index, n_nodes: int) -> CsrIndex:
    """The CSR index of COO edges ``edge_index [2, E]`` (a tensor, or numpy
    for the CPU) over ``n_nodes`` nodes, built on ``edge_index``'s device by
    two stable sorts and ``searchsorted``: no op reads a value or a size back
    to the host, so on the card it queues without a sync.  Ids must lie in
    [0, n_nodes); they are not checked here, since that would read them on
    the host (the model's ``forward`` does, once a call)."""
    edge_index = torch.as_tensor(edge_index)
    src, dst = edge_index[0].long(), edge_index[1].long()
    dst_sorted, perm = torch.sort(dst, stable=True)
    col = src[perm]
    nodes = torch.arange(n_nodes + 1, device=dst.device)
    col_sorted, rev_slot = torch.sort(col, stable=True)  # stable: slots increase per source
    return CsrIndex(
        perm=perm,
        row_ptr=torch.searchsorted(dst_sorted, nodes).int(),
        col=col.int(),
        rev_ptr=torch.searchsorted(col_sorted, nodes).int(),
        rev_slot=rev_slot.int(),
        rev_row=dst_sorted[rev_slot].int(),
    )


def ell_as_csr(
    nbr: torch.Tensor, rev: tuple[torch.Tensor, torch.Tensor]
) -> tuple[torch.Tensor, torch.Tensor, tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """(row_ptr, col, (rev_ptr, rev_slot, rev_row)): the CSR form of a
    padded-ELL table ``nbr [N, max_deg]`` and its real slots' source list
    ``rev`` (:attr:`EllIndex.rev`).  Row n's slots are n * max_deg .. +
    max_deg, padding included; slot s lies in row s // max_deg."""
    N, deg = nbr.shape
    row_ptr = torch.arange(N + 1, dtype=torch.int32, device=nbr.device) * deg
    rev_ptr, rev_slot = rev
    return row_ptr, nbr.reshape(-1), (rev_ptr, rev_slot, rev_slot // max(deg, 1))


def edge_to_padded(
    edge_index, eta, n_nodes: int, max_deg: int
):
    """Convert COO (src,dst) edges + per-edge gates to the padded-ELL layout
    the kernel consumes.  numpy host-side prep (data-pipeline stage)."""
    import numpy as np

    src, dst = np.asarray(edge_index)
    eta = np.asarray(eta)
    nbr = np.zeros((n_nodes, max_deg), np.int32)
    gates = np.zeros((n_nodes, max_deg, eta.shape[-1]), eta.dtype)
    fill = np.zeros(n_nodes, np.int32)
    for e in range(src.shape[0]):
        d = dst[e]
        if fill[d] < max_deg:
            nbr[d, fill[d]] = src[e]
            gates[d, fill[d]] = eta[e]
            fill[d] += 1
    return nbr, gates


def _ranks(dst: np.ndarray) -> np.ndarray:
    """Each edge's rank among the edges into its node, in input order: a
    stable sort by dst, then the position within each run."""
    order = np.argsort(dst, kind="stable")
    d = dst[order]
    ranks = np.empty(dst.shape[0], np.int64)
    ranks[order] = np.arange(d.shape[0]) - np.searchsorted(d, d, side="left")
    return ranks


def _reverse(src: np.ndarray, slot: np.ndarray, n_src: int) -> tuple[np.ndarray, np.ndarray]:
    """(rev_ptr [n_src+1], rev_slot): the slots grouped by source, each
    source's slots in increasing order."""
    order = np.lexsort((slot, src))
    rev_slot = slot[order].astype(np.int32)
    rev_ptr = np.zeros(n_src + 1, np.int64)
    np.cumsum(np.bincount(src, minlength=n_src), out=rev_ptr[1:])
    return rev_ptr.astype(np.int32), rev_slot


@dataclass(frozen=True)
class EllIndex:
    """One graph's padded-ELL index, as tensors on one device."""

    nbr: torch.Tensor  # [N, max_deg] int32, padding -> 0
    slot: torch.Tensor  # [E] int64: n * max_deg + j of each edge, in input order
    rev_ptr: torch.Tensor  # [N+1] int32: real slots of source m at rev_slot[ptr[m]:ptr[m+1]]
    rev_slot: torch.Tensor  # [E] int32, grouped by source, increasing within a source
    max_deg: int

    @property
    def rev(self) -> tuple[torch.Tensor, torch.Tensor]:
        return self.rev_ptr, self.rev_slot


def ell_index(edge_index, n_nodes: int, device: str | torch.device = "cpu") -> EllIndex:
    """The ELL index of COO edges ``edge_index [2, E]`` (numpy or a tensor)
    over ``n_nodes`` nodes, built on the host.  ``max_deg`` is the largest
    in-degree (at least 1), so every edge gets a slot."""
    if isinstance(edge_index, torch.Tensor):
        edge_index = edge_index.cpu().numpy()
    src, dst = (np.asarray(a).astype(np.int64) for a in np.asarray(edge_index))
    for name, a in (("source", src), ("destination", dst)):
        if a.size and (a.min() < 0 or a.max() >= n_nodes):
            raise ValueError(
                f"ell_index: {name} ids span [{a.min()}, {a.max()}], outside [0, {n_nodes})"
            )
    rank = _ranks(dst)
    max_deg = int(rank.max()) + 1 if rank.size else 1
    if n_nodes * max_deg >= 2**31:
        raise ValueError(f"ell_index: {n_nodes} x {max_deg} slots overflow int32")
    nbr = np.zeros((n_nodes, max_deg), np.int32)
    nbr[dst, rank] = src
    slot = dst * max_deg + rank
    rev_ptr, rev_slot = _reverse(src, slot, n_nodes)
    to = lambda a: torch.from_numpy(a).to(device)
    return EllIndex(to(nbr), to(slot), to(rev_ptr), to(rev_slot), max_deg)


def edge_to_padded_vec(edge_index, eta, n_nodes: int, max_deg: int):
    """:func:`edge_to_padded` without the Python loop over edges, through
    :func:`ell_index`'s slots: the same arrays (edges past ``max_deg`` of a
    node are dropped, as there)."""
    ell = ell_index(edge_index, n_nodes)
    dst, rank = np.divmod(ell.slot.numpy(), ell.max_deg)
    keep = rank < max_deg
    eta = np.asarray(eta)
    nbr = np.zeros((n_nodes, max_deg), np.int32)
    nbr[:, :min(max_deg, ell.max_deg)] = ell.nbr.numpy()[:, :max_deg]
    gates = np.zeros((n_nodes, max_deg, eta.shape[-1]), eta.dtype)
    gates[dst[keep], rank[keep]] = eta[keep]
    return nbr, gates
