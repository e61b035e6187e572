"""Mixture-of-Experts FFN (shared + routed top-k, GShard capacity dispatch)
as torch ops.

The reference's grouped formulation: the ``B*S`` tokens are cut B-major
into ``G`` groups of ``g = min(group_size, B*S)``, each token goes to its
top-k experts in order of k and then of its place in the group, and an
expert takes at most ``C = capacity(g)`` tokens of a group; the rest are
dropped.  Where the reference builds one-hot ``[G,g,E,C]`` dispatch and
combine tensors and contracts them, the port moves each kept token into its
slot of an ``[E, G*C, d]`` buffer with a gather, runs the experts as one
batched product over E, and gathers each token's K outputs back.  Empty
slots hold zeros, as in the reference, so the experts see the same inputs.

:func:`route` is the routing alone (expert ids, gates and slots), which
:func:`moe_ffn` calls.  Nothing on the path reads a value back to the host,
so a decode step that holds it can be captured into a CUDA graph.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from ..configs.base import MoESpec
from .layers import PSpec, swiglu


@dataclasses.dataclass(frozen=True)
class MoEDims:
    n_experts: int
    top_k: int
    n_shared: int
    d_model: int
    d_ff: int
    group_size: int = 1024
    capacity_factor: float = 1.25

    def capacity(self, group_size: int) -> int:
        c = int(math.ceil(self.top_k * group_size / self.n_experts * self.capacity_factor))
        return max(c, 4)


def moe_specs(spec: MoESpec, d_model: int, n_layers: int) -> dict:
    E, f = spec.n_experts, spec.d_ff_expert
    d = d_model
    L = n_layers
    out = {
        "router": PSpec((L, d, E), ("layers", "embed", "experts_r")),
        "w_gate": PSpec((L, E, d, f), ("layers", "experts", "embed", "expert_ff")),
        "w_up": PSpec((L, E, d, f), ("layers", "experts", "embed", "expert_ff")),
        "w_down": PSpec((L, E, f, d), ("layers", "experts", "expert_ff", "embed")),
    }
    if spec.n_shared:
        fs = spec.d_ff_expert * spec.n_shared
        out["shared"] = {
            "w_gate": PSpec((L, d, fs), ("layers", "embed", "ff")),
            "w_up": PSpec((L, d, fs), ("layers", "embed", "ff")),
            "w_down": PSpec((L, fs, d), ("layers", "ff", "embed")),
        }
    return out


def groups(n_tokens: int, dims: MoEDims) -> tuple[int, int, int]:
    """(G groups, g tokens a group, C slots an expert has in a group) for a
    call over ``n_tokens``; raises where the reference asserts."""
    g = min(dims.group_size, n_tokens)
    if n_tokens % g:
        raise ValueError(
            f"moe_ffn: {n_tokens} tokens are not a whole number of groups of {g} "
            f"(moe_group_size {dims.group_size})")
    return n_tokens // g, g, dims.capacity(g)


def top_k_lowest_first(probs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The k largest of ``probs`` (>= 0) along the last axis, largest first,
    with ties broken as ``jax.lax.top_k`` breaks them: the lowest index
    first.  Each probability's fp32 bits (ordered as integers, since it is
    not negative) and its reversed index make one int64 key, so no two keys
    tie and any top-k gives the same ids on every device."""
    n = probs.shape[-1]
    bits = probs.float().contiguous().view(torch.int32).long()
    rev = torch.arange(n - 1, -1, -1, device=probs.device)
    _, idx = torch.topk(bits * n + rev, k, dim=-1)
    return probs.gather(-1, idx), idx


def route(x: torch.Tensor, router: torch.Tensor, dims: MoEDims):
    """Routing of x [B,S,d] as the reference routes it.  Returns (gates
    [G,g,K] fp32, renormalised; idx [G,g,K] int64 expert ids; slot [G,g,K]
    int64, the token's place among its expert's C slots of the group, or -1
    where capacity dropped it)."""
    B, S, d = x.shape
    E, K = dims.n_experts, dims.top_k
    G, g, C = groups(B * S, dims)
    # the product in the working dtype, then fp32, as the reference rounds it
    logits = (x.reshape(G, g, d) @ router).float()
    probs = torch.softmax(logits, dim=-1)
    gates, idx = top_k_lowest_first(probs, K)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)  # renorm

    # capacity positions, priority by k, then by the token's place in its group
    slots = []
    prior = torch.zeros(G, 1, E, dtype=torch.int64, device=x.device)
    for k in range(K):
        mask_k = F.one_hot(idx[..., k], E)  # [G,g,E]
        pos_k = mask_k.cumsum(1) - 1 + prior
        prior = prior + mask_k.sum(1, keepdim=True)
        pos = pos_k.gather(-1, idx[..., k:k + 1])[..., 0]
        slots.append(torch.where(pos < C, pos, -1))
    return gates, idx, torch.stack(slots, -1)


def moe_ffn(x: torch.Tensor, p: dict, dims: MoEDims) -> torch.Tensor:
    """x: [B,S,d] -> [B,S,d].  p holds one layer's slices (no leading L).

    The reference's ``_ep_constraint`` is a GSPMD sharding annotation of the
    expert buffers; on one card there is nothing to place, so it has no
    counterpart here."""
    B, S, d = x.shape
    E, K = dims.n_experts, dims.top_k
    G, g, C = groups(B * S, dims)
    T = B * S
    gates, idx, slot = route(x, p["router"], dims)

    # row of each (token, k) in the [E*G*C] slot buffer; a dropped one goes
    # to the extra row E*G*C, which is zero and never read as a slot
    grp = torch.arange(G, device=x.device)[:, None, None]
    row = torch.where(slot >= 0, (idx * G + grp) * C + slot, E * G * C).reshape(T * K)
    # token of each slot (T, a zero row of x, where the slot is empty)
    fill = torch.full((E * G * C + 1,), T, dtype=torch.int64, device=x.device)
    fill.scatter_(0, row, torch.arange(T * K, device=x.device) // K)
    xs = torch.cat([x.reshape(T, d), x.new_zeros(1, d)])
    expert_in = xs[fill[:-1]].view(E, G * C, d)

    h = F.silu(torch.bmm(expert_in, p["w_gate"])) * torch.bmm(expert_in, p["w_up"])
    expert_out = torch.bmm(h, p["w_down"]).view(E * G * C, d)
    expert_out = torch.cat([expert_out, expert_out.new_zeros(1, d)])
    # combine: each token's K outputs weighted by its gates, cast to the
    # working dtype first as the reference's combine tensor is, summed in fp32
    picked = expert_out[row].view(T, K, d).float()
    w = gates.to(x.dtype).float().reshape(T, K, 1)
    out = (picked * w).sum(1).to(x.dtype).view(B, S, d)
    if "shared" in p:
        sp = p["shared"]
        out = out + swiglu(x, sp["w_gate"], sp["w_up"], sp["w_down"])
    return out


def aux_load_balance_loss(logits: torch.Tensor, idx: torch.Tensor, n_experts: int) -> torch.Tensor:
    """Switch-style load-balancing auxiliary loss."""
    probs = torch.softmax(logits.float(), dim=-1)
    density = F.one_hot(idx[..., 0].long(), n_experts).float().mean(dim=(0, 1))
    density_proxy = probs.mean(dim=tuple(range(probs.ndim - 1)))
    return n_experts * (density * density_proxy).sum()
