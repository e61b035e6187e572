"""Graph substrate: CSR adjacency + real fanout neighbor sampling.

``minibatch_lg`` (Reddit-scale: 233k nodes / 115M edges, fanout 15-10)
requires an actual neighbor sampler, not a stub: ``NeighborSampler`` builds a
CSR index once and draws per-seed fixed-fanout samples (with replacement for
high-degree nodes, padded with self-loops for low-degree nodes) producing the
static-shape padded subgraph the jitted train step consumes.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


def random_graph(
    n_nodes: int, n_edges: int, seed: int = 0, power_law: bool = True
) -> np.ndarray:
    """Edge index [2, E] with a skewed (power-law-ish) degree distribution."""
    rng = np.random.default_rng(seed)
    if power_law:
        w = rng.pareto(1.5, size=n_nodes) + 1.0
        p = w / w.sum()
        src = rng.choice(n_nodes, size=n_edges, p=p)
        dst = rng.choice(n_nodes, size=n_edges, p=p)
    else:
        src = rng.integers(0, n_nodes, size=n_edges)
        dst = rng.integers(0, n_nodes, size=n_edges)
    return np.stack([src, dst]).astype(np.int32)


@dataclass
class CSRGraph:
    indptr: np.ndarray  # [N+1]
    indices: np.ndarray  # [E] neighbour ids
    n_nodes: int

    @classmethod
    def from_edge_index(cls, edge_index: np.ndarray, n_nodes: int) -> "CSRGraph":
        src, dst = edge_index
        order = np.argsort(dst, kind="stable")
        src_sorted = src[order]
        counts = np.bincount(dst, minlength=n_nodes)
        indptr = np.zeros(n_nodes + 1, np.int64)
        np.cumsum(counts, out=indptr[1:])
        return cls(indptr=indptr, indices=src_sorted.astype(np.int32), n_nodes=n_nodes)

    def degree(self, nodes: np.ndarray) -> np.ndarray:
        return (self.indptr[nodes + 1] - self.indptr[nodes]).astype(np.int64)


class NeighborSampler:
    """GraphSAGE-style fixed-fanout sampler producing padded subgraphs."""

    def __init__(self, graph: CSRGraph, fanouts: tuple[int, ...], seed: int = 0):
        self.g = graph
        self.fanouts = fanouts
        self.rng = np.random.default_rng(seed)

    def _sample_neighbors(self, nodes: np.ndarray, fanout: int) -> np.ndarray:
        """[B] -> [B, fanout] sampled neighbour ids (self-loop padded)."""
        deg = self.g.degree(nodes)
        # random offsets into each node's neighbour list
        offs = (self.rng.random((nodes.shape[0], fanout)) * np.maximum(deg, 1)[:, None]).astype(
            np.int64
        )
        idx = self.g.indptr[nodes][:, None] + offs
        nbrs = self.g.indices[np.minimum(idx, self.g.indices.shape[0] - 1)]
        # isolated nodes: self-loops
        nbrs = np.where(deg[:, None] > 0, nbrs, nodes[:, None])
        return nbrs.astype(np.int32)

    def sample(self, seeds: np.ndarray) -> dict[str, np.ndarray]:
        """Returns a padded 2-hop block: local node list + local edge index.

        Layout: [seeds | hop1 | hop2]; edges point child -> parent (message
        flow toward the seeds).  Static shapes: B*(1+f1+f1*f2) nodes,
        B*(f1+f1*f2) edges.
        """
        assert len(self.fanouts) == 2, "configured for 2-hop (fanout 15-10)"
        f1, f2 = self.fanouts
        B = seeds.shape[0]
        hop1 = self._sample_neighbors(seeds, f1)  # [B, f1]
        hop2 = self._sample_neighbors(hop1.reshape(-1), f2)  # [B*f1, f2]

        nodes = np.concatenate([seeds, hop1.reshape(-1), hop2.reshape(-1)])
        n1_off = B
        n2_off = B + B * f1
        # hop1 -> seeds
        src1 = n1_off + np.arange(B * f1)
        dst1 = np.repeat(np.arange(B), f1)
        # hop2 -> hop1
        src2 = n2_off + np.arange(B * f1 * f2)
        dst2 = n1_off + np.repeat(np.arange(B * f1), f2)
        edge_index = np.stack(
            [np.concatenate([src1, src2]), np.concatenate([dst1, dst2])]
        ).astype(np.int32)
        return {"nodes": nodes.astype(np.int32), "edge_index": edge_index}
