"""AdamW with global-norm clipping and cosine/warmup schedule, on torch.

The reference's pure update, done in place: the moments are fp32 tensors
updated with in-place ops, and each parameter is overwritten with its fp32
update cast back to its dtype.  Callers that keep the old state must copy
it first.  ``step`` is an int32 tensor, replaced (not mutated) each update.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import torch

from ..tree import leaves, tree_map


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    step = step.float()
    warm = step / max(cfg.warmup_steps, 1)
    prog = (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1)
    prog = prog.clamp(0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def init_state(params: Any) -> dict:
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return {
        "mu": tree_map(zeros, params),
        "nu": tree_map(zeros, params),
        "step": torch.zeros((), dtype=torch.int32, device=leaves(params)[0].device),
    }


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in fp32."""
    sq = [torch.linalg.vector_norm(t, dtype=torch.float32).square() for t in leaves(tree)]
    return torch.stack(sq).sum().sqrt()


@torch.no_grad()
def apply_updates(
    params: Any, grads: Any, state: dict, cfg: AdamWConfig
) -> tuple[Any, dict, dict[str, torch.Tensor]]:
    """One AdamW step.  Updates ``params``, ``state["mu"]`` and
    ``state["nu"]`` in place and returns them with the new step and the
    metrics ``grad_norm`` and ``lr`` (0-d fp32 tensors)."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    lr = schedule(cfg, step)
    stepf = step.float()
    bc1 = 1 - cfg.b1 ** stepf
    bc2 = 1 - cfg.b2 ** stepf
    for p, g, mu, nu in zip(leaves(params), leaves(grads), leaves(state["mu"]),
                            leaves(state["nu"])):
        g = g.float() * scale
        mu.mul_(cfg.b1).add_(g, alpha=1 - cfg.b1)
        nu.mul_(cfg.b2).addcmul_(g, g, value=1 - cfg.b2)
        p32 = p.float()
        delta = (mu / bc1) / ((nu / bc2).sqrt() + cfg.eps) + cfg.weight_decay * p32
        p.copy_(p32 - lr * delta)
    new_state = {"mu": state["mu"], "nu": state["nu"], "step": step}
    return params, new_state, {"grad_norm": gnorm, "lr": lr}
