"""Model configurations of the port: the reference package's ``LMConfig``
with ``dtype`` as a torch dtype, its shape cells, and the LM branch of
``input_specs`` as shape/dtype records (``TensorSpec``, no allocation).
GNN and recsys configs are not ported yet (ROADMAP.md queue 1, items 7
and 8)."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any

import torch


# --------------------------------------------------------------------------
# shape cells
# --------------------------------------------------------------------------
@dataclass(frozen=True)
class ShapeCell:
    name: str
    kind: str  # train | prefill | decode | full_graph | minibatch | batch | retrieval
    params: dict[str, int] = field(default_factory=dict)
    note: str = ""


LM_SHAPES = (
    ShapeCell("train_4k", "train", {"seq_len": 4096, "global_batch": 256}),
    ShapeCell("prefill_32k", "prefill", {"seq_len": 32768, "global_batch": 32}),
    ShapeCell("decode_32k", "decode", {"seq_len": 32768, "global_batch": 128}),
    ShapeCell("long_500k", "decode", {"seq_len": 524288, "global_batch": 1}),
)


@dataclass(frozen=True)
class MoESpec:
    n_experts: int
    top_k: int
    n_shared: int = 0
    d_ff_expert: int = 0  # per-expert hidden size


@dataclass(frozen=True)
class MLASpec:
    kv_lora_rank: int = 512
    q_lora_rank: int = 1536
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128


@dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 0  # 0 -> d_model // n_heads
    moe: MoESpec | None = None
    moe_capacity_factor: float = 1.25
    moe_group_size: int = 1024
    moe_ep_axis: str | None = None  # mesh axis for explicit EP annotations
    moe_token_axes: tuple = ()
    mla: MLASpec | None = None
    # local:global attention pattern (gemma3): (n_local, n_global) per cycle
    local_global: tuple[int, int] | None = None
    local_window: int = 1024
    rope_theta: float = 10_000.0
    dtype: torch.dtype = torch.bfloat16
    tie_embeddings: bool = False
    # attention lowering: "einsum" (baseline) | "chunked" (flash-style q-chunk
    # remat; the XLA analogue of kernels/flash_attention for the dry-run)
    attention_impl: str = "einsum"
    attn_block_q: int = 512
    # serve prefill: compute logits only for the last position (vLLM-style)
    prefill_last_only: bool = False
    # Megatron-SP-style residual-stream sharding: constrain the scan carry to
    # (batch over act_batch_axes, seq over act_seq_axes) so saved activations
    # shard over the model axis too (GSPMD inserts the AG/RS pairs)
    act_batch_axes: tuple = ()
    act_seq_axes: tuple = ()
    # streaming CE: scan over vocab chunks (running logsumexp) so the fp32
    # [B,S,V] logits never materialize; 0 = off
    loss_vocab_chunks: int = 0
    # True iff attention is full (quadratic) in every layer -> long_500k skipped
    sub_quadratic: bool = False
    # per-arch sharding-rule overrides: (logical_axis, (mesh axes...)) pairs
    shard_overrides: tuple = ()
    family: str = "lm"

    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads


# --------------------------------------------------------------------------
# registry
# --------------------------------------------------------------------------
_REGISTRY: dict[str, Any] = {}


def register(arch_id: str, module_name: str) -> None:
    _REGISTRY[arch_id] = module_name


def list_archs() -> list[str]:
    return sorted(_REGISTRY)


def get_arch(arch_id: str):
    """Returns the config module for an arch id (lazy import)."""
    import importlib

    if arch_id not in _REGISTRY:
        raise KeyError(f"unknown arch {arch_id!r}; known: {list_archs()}")
    return importlib.import_module(f"repro_torch.configs.{_REGISTRY[arch_id]}")


def get_config(arch_id: str, smoke: bool = False) -> LMConfig:
    mod = get_arch(arch_id)
    return mod.SMOKE if smoke else mod.CONFIG


def reduced(config: LMConfig, **overrides) -> LMConfig:
    return dataclasses.replace(config, **overrides)


# --------------------------------------------------------------------------
# input specs (shape/dtype records, no allocation)
# --------------------------------------------------------------------------
@dataclass(frozen=True)
class TensorSpec:
    """The port's stand-in for ``jax.ShapeDtypeStruct``."""

    shape: tuple[int, ...]
    dtype: torch.dtype


UNPORTED_FAMILIES = (
    "is not ported yet: GNN and recsys models wait for ROADMAP.md queue 1, "
    "items 7 (GNN) and 8 (recsys)"
)


def input_specs(config: Any, cell: ShapeCell) -> dict[str, Any]:
    """Model-input stand-ins for one (arch x shape) cell."""
    if isinstance(config, LMConfig):
        return _lm_input_specs(config, cell)
    raise NotImplementedError(f"{type(config).__name__} {UNPORTED_FAMILIES}")


def _lm_input_specs(cfg: LMConfig, cell: ShapeCell) -> dict[str, Any]:
    p = cell.params
    B, S = p["global_batch"], p["seq_len"]
    if cell.kind == "train":
        return {
            "tokens": TensorSpec((B, S), torch.int32),
            "targets": TensorSpec((B, S), torch.int32),
        }
    if cell.kind == "prefill":
        return {"tokens": TensorSpec((B, S), torch.int32)}
    if cell.kind == "decode":
        # one new token against a KV cache of length S
        if cfg.mla is not None:
            m = cfg.mla
            cache = {
                "c_kv": TensorSpec((cfg.n_layers, B, S, m.kv_lora_rank), cfg.dtype),
                "k_rope": TensorSpec((cfg.n_layers, B, S, m.rope_head_dim), cfg.dtype),
            }
        else:
            hkv, dh = cfg.n_kv_heads, cfg.head_dim
            cache = {
                "k": TensorSpec((cfg.n_layers, B, S, hkv, dh), cfg.dtype),
                "v": TensorSpec((cfg.n_layers, B, S, hkv, dh), cfg.dtype),
            }
        return {
            "tokens": TensorSpec((B, 1), torch.int32),
            "cache": cache,
            "cache_len": TensorSpec((B,), torch.int32),
        }
    raise ValueError(cell.kind)
