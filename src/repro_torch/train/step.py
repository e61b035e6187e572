"""train_step / serve_step builders, LM family, on torch.

``build_param_specs(cfg, cell)`` -> PSpec tree
``build_train_step(cfg, ...)``  -> fn(state, batch) -> (state, metrics)
``build_serve_step(cfg, cell)`` -> fn(params, **inputs) -> outputs

The step runs eagerly where the reference is jitted.  Gradients come from
``torch.autograd.grad`` on detached views of the parameters, and the
optimizer updates the state in place (see :mod:`repro_torch.optim.adamw`).
GNN and recsys families are not ported yet.
"""
from __future__ import annotations

from typing import Any, Callable

import torch
from torch.utils.checkpoint import CheckpointPolicy

from ..configs.base import UNPORTED_FAMILIES, LMConfig, ShapeCell
from ..models import transformer
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


def _lm_only(cfg: Any) -> LMConfig:
    if not isinstance(cfg, LMConfig):
        raise NotImplementedError(f"{type(cfg).__name__} {UNPORTED_FAMILIES}")
    return cfg


# --------------------------------------------------------------------------
# param specs
# --------------------------------------------------------------------------
def build_param_specs(cfg: Any, cell: ShapeCell | None = None) -> Any:
    return transformer.lm_specs(_lm_only(cfg))


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


def build_loss_fn(
    cfg: Any, cell: ShapeCell | None = None, *, remat: str = "none", unroll: int = 1
) -> Callable:
    cfg = _lm_only(cfg)
    policy = REMAT_POLICIES[remat]
    return lambda params, batch: _lm_loss(params, cfg, batch, remat=policy, unroll=unroll)


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
        grads = torch.autograd.grad(loss, req)
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
def build_serve_step(cfg: Any, cell: ShapeCell, *, unroll: int = 1) -> Callable:
    cfg = _lm_only(cfg)
    if cell.kind == "prefill":

        def prefill_step(params, tokens):
            return transformer.prefill(params, cfg, tokens, unroll=unroll)

        return prefill_step
    if cell.kind == "decode":

        def decode_step(params, tokens, cache, cache_len):
            return transformer.decode_step(params, cfg, tokens, cache, cache_len)

        return decode_step
    raise ValueError(cell.kind)
