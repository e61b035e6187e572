"""Common layers and the param-spec system, as torch ops.

Params are nested dicts of tensors.  Every model declares a *spec tree* of
``PSpec`` (shape, logical axes, init); ``init_params`` materializes it with
the reference package's scheme.  Torch's generator gives other numbers than
``jax.random`` from the same seed: parity tests convert the reference's
parameters with :mod:`repro_torch.convert` instead.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import torch


# --------------------------------------------------------------------------
# param specs
# --------------------------------------------------------------------------
@dataclass(frozen=True)
class PSpec:
    shape: tuple[int, ...]
    axes: tuple[str | None, ...]
    init: str = "normal"  # normal | zeros | ones | embed
    scale: float | None = None  # default: 1/sqrt(fan_in) for normal

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def init_params(
    generator: torch.Generator,
    specs: Any,
    dtype: torch.dtype,
    device: str | torch.device = "cuda",
) -> Any:
    """Materialize a spec tree: normal x 1/sqrt(fan_in) (or the spec's
    scale), zeros for norms.  Leaves are drawn in sorted-key order, the
    order ``jax.tree_util`` flattens a dict in."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("init_params: device='cuda' requested but CUDA is not available")

    def build(s: Any) -> Any:
        if isinstance(s, PSpec):
            if s.init == "zeros":
                return torch.zeros(s.shape, dtype=dtype, device=device)
            if s.init == "ones":
                return torch.ones(s.shape, dtype=dtype, device=device)
            fan_in = s.shape[-2] if len(s.shape) >= 2 else max(s.shape[-1], 1)
            scale = s.scale if s.scale is not None else 1.0 / math.sqrt(fan_in)
            w = torch.randn(s.shape, generator=generator, dtype=torch.float32, device=device)
            return w.mul_(scale).to(dtype)
        if isinstance(s, list):
            return [build(x) for x in s]
        return {k: build(s[k]) for k in sorted(s)}

    return build(specs)


def abstract_params(specs: Any, dtype: torch.dtype, device: str | torch.device = "meta") -> Any:
    """Uninitialised tensors of a spec tree's shapes (on ``meta``: shapes
    alone, the dry-run's stand-ins for the reference's ShapeDtypeStructs)."""
    if isinstance(specs, PSpec):
        return torch.empty(specs.shape, dtype=dtype, device=device)
    if isinstance(specs, list):
        return [abstract_params(s, dtype, device) for s in specs]
    return {k: abstract_params(specs[k], dtype, device) for k in sorted(specs)}


def logical_axes(specs: Any) -> Any:
    if isinstance(specs, PSpec):
        return specs.axes
    if isinstance(specs, list):
        return [logical_axes(s) for s in specs]
    return {k: logical_axes(v) for k, v in specs.items()}


def param_count(specs: Any) -> int:
    if isinstance(specs, PSpec):
        return math.prod(specs.shape)
    if isinstance(specs, list):
        return sum(param_count(s) for s in specs)
    return sum(param_count(s) for s in specs.values())


# --------------------------------------------------------------------------
# functional layers
# --------------------------------------------------------------------------
def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float = 1e-5):
    """LayerNorm with fp32 statistics (population variance)."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale + bias).to(x.dtype)


def batch_stat_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float = 1e-5):
    """BatchNorm with the batch's own statistics (training mode, no running
    averages), in fp32: the mean and population variance reduce over every
    leading dim, one pair a feature."""
    xf = x.float()
    red = tuple(range(x.ndim - 1))
    if not red:  # a 1-D x has no leading dim: each value is its own batch
        mu, var = xf, torch.zeros_like(xf)
    else:
        mu = xf.mean(dim=red, keepdim=True)
        var = (xf - mu).square().mean(dim=red, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale + bias).to(x.dtype)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor, w_down: torch.Tensor):
    g = x @ w_gate
    u = x @ w_up
    return (torch.nn.functional.silu(g) * u) @ w_down


# -- rotary ------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float, device: torch.device | None = None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10_000.0) -> torch.Tensor:
    """x: [..., S, H, dh]; positions: [..., S].  Rotates the two halves of
    the head (not interleaved pairs); angles in fp32."""
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, x.device)  # [dh/2]
    angles = positions[..., :, None].float() * freqs  # [..., S, dh/2]
    cos = torch.cos(angles)[..., :, None, :]  # broadcast over heads
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# -- embedding / segment ops ---------------------------------------------------
def embedding_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    return table[ids.long()]


def embedding_bag(
    table: torch.Tensor,
    ids: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    combiner: str = "sum",
    weights: torch.Tensor | None = None,
) -> torch.Tensor:
    """EmbeddingBag in segment form, as plain torch ops (gather, then a
    sum per segment with ``index_add``).

    ids: [nnz] row indices; segment_ids: [nnz] output bag per id (sorted not
    required); returns [num_segments, dim].  The models use the fixed-size
    bag kernel of :mod:`repro_torch.kernels.embedding_bag` instead.
    """
    rows = table[ids.long()]
    if weights is not None:
        rows = rows * weights[:, None]
    seg = segment_ids.long()
    out = rows.new_zeros((num_segments, rows.shape[-1])).index_add_(0, seg, rows)
    if combiner == "mean":
        cnt = rows.new_zeros(num_segments).index_add_(0, seg, torch.ones_like(seg, dtype=rows.dtype))
        out = out / torch.clamp(cnt, min=1.0)[:, None]
    return out


def mlp(x: torch.Tensor, layers: list[dict[str, torch.Tensor]], act=torch.relu):
    for i, lyr in enumerate(layers):
        x = x @ lyr["w"] + lyr["b"]
        if i < len(layers) - 1:
            x = act(x)
    return x


def mlp_specs(d_in: int, widths: tuple[int, ...], axes_in="embed", prefix="mlp"):
    layers = []
    d = d_in
    for i, w in enumerate(widths):
        layers.append(
            {
                "w": PSpec((d, w), (axes_in if i == 0 else "mlp_hidden", "mlp_hidden")),
                "b": PSpec((w,), ("mlp_hidden",), init="zeros"),
            }
        )
        d = w
    return layers
