"""train_step / serve_step builders for the LM, GNN and recsys families, on
torch.

``build_param_specs(cfg, cell)`` -> PSpec tree
``build_train_step(cfg, ...)``  -> fn(state, batch) -> (state, metrics)
``build_serve_step(cfg, cell)`` -> fn(params, **inputs) -> outputs

The step runs eagerly where the reference is jitted.  Gradients come from
``torch.autograd.grad`` on detached views of the parameters, and the
optimizer updates the state in place (see :mod:`repro_torch.optim.adamw`).
Recsys models train on the reference's losses (BCE for FM, DCN-v2 and BST,
BPR for SASRec); on the card every table gradient comes from the
embedding-bag backward kernel, a dense [V, dim] gradient as the reference's
transpose of ``jnp.take`` gives.
"""
from __future__ import annotations

from typing import Any, Callable

import torch
from torch.utils.checkpoint import CheckpointPolicy

from ..configs.base import Config, GNNConfig, LMConfig, RecsysConfig, ShapeCell
from ..models import gnn, recsys, transformer
from ..optim import AdamWConfig, apply_updates, init_state
from ..tree import leaves, tree_map, unflatten

_MATMULS = {
    torch.ops.aten.mm.default,
    torch.ops.aten.bmm.default,
    torch.ops.aten.addmm.default,
    torch.ops.aten.baddbmm.default,
}


def _save_nothing(ctx, op, *args, **kwargs):
    return CheckpointPolicy.PREFER_RECOMPUTE


def _save_dots(ctx, op, *args, **kwargs):
    """Keep matmul outputs, recompute the rest (jax's ``checkpoint_dots``).
    Without a mesh, dots with and without batch dims are treated alike."""
    return CheckpointPolicy.MUST_SAVE if op in _MATMULS else CheckpointPolicy.PREFER_RECOMPUTE


# name -> selective-checkpoint policy per layer (None: no checkpoint)
REMAT_POLICIES: dict[str, Any] = {
    "none": None,
    "dots": _save_dots,
    "dots_no_batch": _save_dots,
    "full": _save_nothing,
}


# --------------------------------------------------------------------------
# param specs
# --------------------------------------------------------------------------
def build_param_specs(cfg: Config, cell: ShapeCell | None = None) -> Any:
    if isinstance(cfg, LMConfig):
        return transformer.lm_specs(cfg)
    if isinstance(cfg, GNNConfig):
        d_feat = 16
        if cell is not None:
            d_feat = cell.params.get("d_feat", 602 if cell.kind == "minibatch" else 16)
        return gnn.gnn_specs(cfg, d_feat)
    if isinstance(cfg, RecsysConfig):
        return {
            "fm-2way": recsys.fm_specs,
            "cross": recsys.dcn_specs,
            "transformer-seq": recsys.bst_specs,
            "self-attn-seq": recsys.sasrec_specs,
        }[cfg.interaction](cfg)
    raise TypeError(type(cfg))


# --------------------------------------------------------------------------
# losses
# --------------------------------------------------------------------------
def _lm_loss(params, cfg: LMConfig, batch, *, remat=None, unroll=1):
    if cfg.loss_vocab_chunks:
        x, _ = transformer.forward(
            params, cfg, batch["tokens"], remat=remat, unroll=unroll, no_head=True
        )
        loss = transformer.streaming_ce_loss(
            x, transformer.lm_head(params), batch["targets"], cfg.loss_vocab_chunks
        )
        return loss, {"loss": loss, "ppl_proxy": loss}
    logits, _ = transformer.forward(params, cfg, batch["tokens"], remat=remat, unroll=unroll)
    logp = torch.log_softmax(logits, dim=-1)
    ce = -logp.gather(-1, batch["targets"].long()[..., None])[..., 0]
    loss = ce.mean()
    return loss, {"loss": loss, "ppl_proxy": loss}


def _ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(-1, labels.long()[:, None]).mean()


def _bce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Binary cross-entropy on logits, in the reference's stable form."""
    return (torch.relu(logits) - logits * labels + torch.log1p(torch.exp(-logits.abs()))).mean()


def _gnn_loss(params, cfg: GNNConfig, batch, cell: ShapeCell, remat=None):
    if cell.kind == "batched_graphs":
        logits = gnn.forward_batched(params, cfg, batch["node_feat"], batch["edge_index"])
        loss = _ce(logits, batch["labels"])
        return loss, {"loss": loss}
    if cell.kind == "minibatch":
        logits = gnn.forward(params, cfg, batch["node_feat"], batch["edge_index"])
        loss = _ce(logits[: batch["labels"].shape[0]], batch["labels"])
        return loss, {"loss": loss}
    mask = batch.get("train_mask")
    loss = gnn.loss_fn(
        params, cfg, batch["node_feat"], batch["edge_index"], batch["labels"],
        mask.float() if mask is not None else None,
        remat=remat,
    )
    return loss, {"loss": loss}


def _recsys_loss(params, cfg: RecsysConfig, batch):
    if cfg.interaction == "fm-2way":
        logits = recsys.fm_forward(params, cfg, batch["sparse_ids"])
        loss = _bce(logits, batch["labels"])
    elif cfg.interaction == "cross":
        logits = recsys.dcn_forward(params, cfg, batch["dense"], batch["sparse_ids"])
        loss = _bce(logits, batch["labels"])
    elif cfg.interaction == "transformer-seq":
        logits = recsys.bst_forward(params, cfg, batch["hist_ids"], batch["target_id"])
        loss = _bce(logits, batch["labels"])
    elif cfg.interaction == "self-attn-seq":
        pos, neg = recsys.sasrec_forward(
            params, cfg, batch["hist_ids"], batch["pos_ids"], batch["neg_ids"]
        )
        loss = -torch.nn.functional.logsigmoid(pos - neg).mean()  # BPR
    else:
        raise ValueError(cfg.interaction)
    return loss, {"loss": loss}


def build_loss_fn(
    cfg: Config, cell: ShapeCell | None = None, *, remat: str = "none", unroll: int = 1
) -> Callable:
    if isinstance(cfg, LMConfig):
        policy = REMAT_POLICIES[remat]
        return lambda params, batch: _lm_loss(params, cfg, batch, remat=policy, unroll=unroll)
    if isinstance(cfg, GNNConfig):
        if cell is None:
            raise ValueError("build_loss_fn: a GNN loss needs its shape cell")
        policy = REMAT_POLICIES[remat]
        return lambda params, batch: _gnn_loss(params, cfg, batch, cell, remat=policy)
    if isinstance(cfg, RecsysConfig):
        return lambda params, batch: _recsys_loss(params, cfg, batch)
    raise TypeError(type(cfg))


# --------------------------------------------------------------------------
# train step
# --------------------------------------------------------------------------
def make_train_state(params: Any, opt_cfg: AdamWConfig | None = None) -> dict:
    return {"params": params, "opt": init_state(params)}


def build_train_step(
    cfg: Any,
    cell: ShapeCell | None = None,
    opt_cfg: AdamWConfig | None = None,
    *,
    remat: str = "none",
    unroll: int = 1,
    grad_accum: int = 1,
) -> Callable:
    """Returns fn(state, batch) -> (state, metrics).  Metrics are 0-d fp32
    tensors on the parameters' device; the state is updated in place."""
    opt_cfg = opt_cfg or AdamWConfig()
    loss_fn = build_loss_fn(cfg, cell, remat=remat, unroll=unroll)

    def single_grads(params, batch):
        req = [t.detach().requires_grad_(True) for t in leaves(params)]
        loss, metrics = loss_fn(unflatten(params, req), batch)
        # a leaf the loss does not read (DCN-v2's retrieval tower) gets zeros,
        # as jax.grad gives it
        grads = [torch.zeros_like(t) if g is None else g
                 for t, g in zip(req, torch.autograd.grad(loss, req, allow_unused=True))]
        metrics = {k: v.detach() for k, v in metrics.items()}
        return loss.detach(), metrics, unflatten(params, grads)

    def train_step(state: dict, batch: dict) -> tuple[dict, dict]:
        params = state["params"]
        if grad_accum == 1:
            _, metrics, grads = single_grads(params, batch)
        else:
            n = next(iter(batch.values())).shape[0]
            if n % grad_accum:
                raise ValueError(f"batch {n} is not a multiple of grad_accum={grad_accum}")
            m = n // grad_accum
            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                   device=p.device), params)
            metrics = None
            for i in range(grad_accum):
                mb = {k: v[i * m:(i + 1) * m] for k, v in batch.items()}
                _, mm, g = single_grads(params, mb)
                for acc, gi in zip(leaves(grads), leaves(g)):
                    acc.add_(gi.float())
                metrics = mm if metrics is None else {k: metrics[k] + mm[k] for k in mm}
            grads = tree_map(lambda g: g / grad_accum, grads)
            metrics = {k: v / grad_accum for k, v in metrics.items()}
        new_params, new_opt, opt_metrics = apply_updates(params, grads, state["opt"], opt_cfg)
        metrics = dict(metrics)
        metrics.update(opt_metrics)
        return {"params": new_params, "opt": new_opt}, metrics

    return train_step


# --------------------------------------------------------------------------
# serve step
# --------------------------------------------------------------------------
def build_serve_step(cfg: Config, cell: ShapeCell, *, unroll: int = 1) -> Callable:
    if isinstance(cfg, LMConfig):
        if cell.kind == "prefill":

            def prefill_step(params, tokens):
                return transformer.prefill(params, cfg, tokens, unroll=unroll)

            return prefill_step
        if cell.kind == "decode":

            def decode_step(params, tokens, cache, cache_len):
                return transformer.decode_step(params, cfg, tokens, cache, cache_len)

            return decode_step
        raise ValueError(cell.kind)

    if isinstance(cfg, RecsysConfig):
        if cell.kind == "retrieval":
            fn = {
                "fm-2way": lambda p, **b: recsys.fm_retrieval(
                    p, cfg, b["sparse_ids"], b["candidate_ids"]
                ),
                "cross": lambda p, **b: recsys.dcn_retrieval(
                    p, cfg, b["dense"], b["sparse_ids"], b["candidate_ids"]
                ),
                "transformer-seq": lambda p, **b: recsys.bst_retrieval(
                    p, cfg, b["hist_ids"], b["candidate_ids"]
                ),
                "self-attn-seq": lambda p, **b: recsys.sasrec_retrieval(
                    p, cfg, b["hist_ids"], b["candidate_ids"]
                ),
            }[cfg.interaction]
            return fn

        def score(params, **batch):
            if cfg.interaction == "fm-2way":
                return recsys.fm_forward(params, cfg, batch["sparse_ids"])
            if cfg.interaction == "cross":
                return recsys.dcn_forward(params, cfg, batch["dense"], batch["sparse_ids"])
            if cfg.interaction == "transformer-seq":
                return recsys.bst_forward(params, cfg, batch["hist_ids"], batch["target_id"])
            if cfg.interaction == "self-attn-seq":
                pos, neg = recsys.sasrec_forward(
                    params, cfg, batch["hist_ids"], batch["pos_ids"], batch["neg_ids"]
                )
                return pos
            raise ValueError(cfg.interaction)

        return score

    raise TypeError(f"no serve step for {type(cfg)}")
