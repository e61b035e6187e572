"""GatedGCN (arXiv:1711.07553 / benchmarking-GNNs arXiv:2003.00982).

Layer update (with edge features, residuals, and norm):

    e'_ij = e_ij + ReLU(Norm(A h_i + B h_j + C e_ij))
    eta_ij = sigma(e'_ij) / (sum_j sigma(e'_ij) + eps)
    h'_i  = h_i + ReLU(Norm(U h_i + sum_j eta_ij * (V h_j)))

The reference sums messages and gates with two ``jax.ops.segment_sum``s
over the edges.  Here one call of the gated-aggregation kernel
(:func:`repro_torch.kernels.gnn_aggregate.gnn_aggregate_csr`) gives both,
over a row-pointer (CSR) index of the real edges that ``forward`` builds once
per graph on the graph's own device (:func:`csr_index`, no read back to the
host).  The edges are taken in destination order, so the edge states and
their gates sigma(e') are already in the index's slot order: no padded
tensor is built.  Edge order cannot show in the logits, since every edge's
state starts from the same encoded constant.  The reference's
``act_*_axes`` are GSPMD annotations: on one card there is nothing to do.
"""
from __future__ import annotations

from functools import partial
from typing import Any, Callable

import torch
from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

from ..configs.base import GNNConfig
from ..kernels.gnn_aggregate import CsrIndex, csr_index, gnn_aggregate_csr
from .layers import PSpec, layer_norm

RematPolicy = Callable[..., Any]  # a selective-checkpoint policy (ctx, op, ...)


def gnn_specs(cfg: GNNConfig, d_feat: int) -> dict:
    L, h, de = cfg.n_layers, cfg.d_hidden, cfg.d_edge
    return {
        "node_encoder": PSpec((d_feat, h), ("node_feat", "hidden")),
        "edge_encoder": PSpec((de, h), ("edge_feat", "hidden")),
        "layers": {
            "A": PSpec((L, h, h), ("layers", "hidden", "hidden")),
            "B": PSpec((L, h, h), ("layers", "hidden", "hidden")),
            "C": PSpec((L, h, h), ("layers", "hidden", "hidden")),
            "U": PSpec((L, h, h), ("layers", "hidden", "hidden")),
            "V": PSpec((L, h, h), ("layers", "hidden", "hidden")),
            "ln_h_scale": PSpec((L, h), ("layers", "hidden"), init="ones"),
            "ln_h_bias": PSpec((L, h), ("layers", "hidden"), init="zeros"),
            "ln_e_scale": PSpec((L, h), ("layers", "hidden"), init="ones"),
            "ln_e_bias": PSpec((L, h), ("layers", "hidden"), init="zeros"),
        },
        "readout": PSpec((h, cfg.n_classes), ("hidden", "classes")),
    }


def _gated_layer(p: dict, h: torch.Tensor, e: torch.Tensor, src: torch.Tensor,
                 dst: torch.Tensor, index: CsrIndex):
    h_src = h[src]
    h_dst = h[dst]
    e_new = h_dst @ p["A"] + h_src @ p["B"] + e @ p["C"]
    e_new = torch.relu(layer_norm(e_new, p["ln_e_scale"], p["ln_e_bias"]))
    e = e + e_new

    eta = torch.sigmoid(e)  # the gates, one row a slot
    # sum_j eta_ij * (V h_j) and sum_j eta_ij: the reference's segment_sums
    # of eta * (h_src @ V) and of eta
    num, den = gnn_aggregate_csr(h @ p["V"], index.row_ptr, index.col, eta, index.rev,
                                 with_den=True)
    agg = num / (den + 1e-6)
    h_new = h @ p["U"] + agg
    h_new = torch.relu(layer_norm(h_new, p["ln_h_scale"], p["ln_h_bias"]))
    return h + h_new, e


def forward(
    params: dict,
    cfg: GNNConfig,
    node_feat: torch.Tensor,  # [N, d_feat]
    edge_index: torch.Tensor,  # [2, E] (src, dst)
    *,
    unroll: int = 1,
    remat: RematPolicy | None = None,
) -> torch.Tensor:
    """Returns per-node class logits [N, n_classes] in fp32.  The graph's CSR
    index is built here, on ``edge_index``'s device, once a call.  The ids
    are checked to lie in [0, N) by one read of their min and max on the host,
    the call's only sync (:func:`csr_index` itself reads nothing back); on
    the ``meta`` device (the dry-run) there are no ids to read, and the
    check is skipped.  ``remat`` is None or a selective-checkpoint policy
    applied per layer; ``unroll`` has no effect."""
    n = node_feat.shape[0]
    if edge_index.numel() and edge_index.device.type != "meta":
        lo, hi = torch.stack(torch.aminmax(edge_index)).tolist()
        if lo < 0 or hi >= n:
            raise ValueError(f"gnn forward: edge ids span [{lo}, {hi}], outside [0, {n})")
    index = csr_index(edge_index, n)
    # the edges in slot order, so that the edge states line up with the index
    src, dst = (edge_index[i].long()[index.perm] for i in (0, 1))
    h = node_feat.to(cfg.dtype) @ params["node_encoder"]
    # edge features: encoded from a constant when the dataset has none
    e = torch.ones(src.shape[0], cfg.d_edge, dtype=cfg.dtype,
                   device=node_feat.device) @ params["edge_encoder"]

    def body(layer_p, h, e):
        return _gated_layer(layer_p, h, e, src, dst, index)

    if remat is not None:
        ctx = partial(create_selective_checkpoint_contexts, remat)
        run = partial(checkpoint, body, use_reentrant=False, context_fn=ctx)
    else:
        run = body
    layers = params["layers"]
    for l in range(layers["A"].shape[0]):
        h, e = run({k: v[l] for k, v in layers.items()}, h, e)
    return (h @ params["readout"]).float()


def forward_batched(
    params: dict,
    cfg: GNNConfig,
    node_feat: torch.Tensor,  # [B, n, d]
    edge_index: torch.Tensor,  # [B, 2, e]
) -> torch.Tensor:
    """Batched small graphs (molecule cell): one forward over the disjoint
    union of the B graphs (the reference's vmap), then a mean over each
    graph's nodes for a graph-level prediction."""
    B, n, d = node_feat.shape
    offsets = torch.arange(B, device=edge_index.device, dtype=edge_index.dtype) * n
    union = (edge_index + offsets[:, None, None]).permute(1, 0, 2).reshape(2, -1)
    logits = forward(params, cfg, node_feat.reshape(B * n, d), union)
    return logits.view(B, n, -1).mean(dim=1)


def loss_fn(
    params: dict,
    cfg: GNNConfig,
    node_feat: torch.Tensor,
    edge_index: torch.Tensor,
    labels: torch.Tensor,
    mask: torch.Tensor | None = None,
    remat: RematPolicy | None = None,
) -> torch.Tensor:
    logits = forward(params, cfg, node_feat, edge_index, remat=remat)
    ce = -torch.log_softmax(logits, dim=-1).gather(-1, labels.long()[:, None])[:, 0]
    if mask is not None:
        return (ce * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return ce.mean()
