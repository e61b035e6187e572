"""Model configurations of the port: the reference package's ``LMConfig``,
``GNNConfig`` and ``RecsysConfig`` with ``dtype`` as a torch dtype, their
shape cells, and ``input_specs`` as shape/dtype records (``TensorSpec``, no
allocation)."""
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

GNN_SHAPES = (
    ShapeCell(
        "full_graph_sm",
        "full_graph",
        {"n_nodes": 2708, "n_edges": 10556, "d_feat": 1433},
    ),
    ShapeCell(
        "minibatch_lg",
        "minibatch",
        {
            "n_nodes": 232_965,
            "n_edges": 114_615_892,
            "batch_nodes": 1024,
            "fanout1": 15,
            "fanout2": 10,
        },
    ),
    ShapeCell(
        "ogb_products",
        "full_graph",
        {"n_nodes": 2_449_029, "n_edges": 61_859_140, "d_feat": 100},
    ),
    ShapeCell(
        "molecule",
        "batched_graphs",
        {"n_nodes": 30, "n_edges": 64, "batch": 128},
    ),
)

RECSYS_SHAPES = (
    ShapeCell("train_batch", "train", {"batch": 65536}),
    ShapeCell("serve_p99", "serve", {"batch": 512}),
    ShapeCell("serve_bulk", "serve", {"batch": 262144}),
    ShapeCell("retrieval_cand", "retrieval", {"batch": 1, "n_candidates": 1_000_000}),
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

    def n_params(self) -> int:
        """Total parameter count (for MODEL_FLOPS = 6*N*D bookkeeping)."""
        d, f, L, V = self.d_model, self.d_ff, self.n_layers, self.vocab
        hq, hkv, dh = self.n_heads, self.n_kv_heads, self.head_dim
        if self.mla is not None:
            m = self.mla
            attn = (
                d * m.q_lora_rank
                + m.q_lora_rank * hq * (m.nope_head_dim + m.rope_head_dim)
                + d * (m.kv_lora_rank + m.rope_head_dim)
                + m.kv_lora_rank * hq * (m.nope_head_dim + m.v_head_dim)
                + hq * m.v_head_dim * d
            )
        else:
            attn = d * hq * dh + 2 * d * hkv * dh + hq * dh * d
        if self.moe is not None:
            ffn_per_layer = (
                self.moe.n_experts * 3 * d * self.moe.d_ff_expert
                + self.moe.n_shared * 3 * d * self.moe.d_ff_expert
                + d * self.moe.n_experts  # router
            )
        else:
            ffn_per_layer = 3 * d * f
        per_layer = attn + ffn_per_layer + 2 * d  # 2 rmsnorm scales
        n = L * per_layer + V * d + d  # embed + final norm
        if not self.tie_embeddings:
            n += V * d
        return int(n)

    def n_active_params(self) -> int:
        if self.moe is None:
            return self.n_params()
        d, L = self.d_model, self.n_layers
        dense_like = self.n_params()
        all_experts = L * self.moe.n_experts * 3 * d * self.moe.d_ff_expert
        active = L * (self.moe.top_k + self.moe.n_shared) * 3 * d * self.moe.d_ff_expert
        # shared experts always active; replace routed total by top_k
        shared = L * self.moe.n_shared * 3 * d * self.moe.d_ff_expert
        return int(dense_like - all_experts - shared + active)


@dataclass(frozen=True)
class GNNConfig:
    name: str
    n_layers: int
    d_hidden: int
    aggregator: str = "gated"
    d_edge: int = 8
    n_classes: int = 47
    dtype: torch.dtype = torch.float32
    # scan-carry sharding constraints (mesh axis names) for node/edge states
    act_node_axes: tuple = ()
    act_edge_axes: tuple = ()
    shard_overrides: tuple = ()
    family: str = "gnn"


@dataclass(frozen=True)
class RecsysConfig:
    name: str
    interaction: str  # transformer-seq | cross | fm-2way | self-attn-seq
    embed_dim: int
    n_dense: int = 0
    n_sparse: int = 0
    seq_len: int = 0
    n_blocks: int = 0
    n_heads: int = 0
    n_cross_layers: int = 0
    mlp: tuple[int, ...] = ()
    vocab_sizes: tuple[int, ...] = ()  # per sparse field
    item_vocab: int = 0  # for sequence models
    dtype: torch.dtype = torch.float32
    family: str = "recsys"


Config = LMConfig | GNNConfig | RecsysConfig


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


def get_config(arch_id: str, smoke: bool = False) -> Config:
    mod = get_arch(arch_id)
    return mod.SMOKE if smoke else mod.CONFIG


def get_shapes(arch_id: str) -> tuple[ShapeCell, ...]:
    return get_arch(arch_id).SHAPES


def reduced(config: Config, **overrides) -> Config:
    return dataclasses.replace(config, **overrides)


# --------------------------------------------------------------------------
# input specs (shape/dtype records, no allocation)
# --------------------------------------------------------------------------
@dataclass(frozen=True)
class TensorSpec:
    """The port's stand-in for ``jax.ShapeDtypeStruct``."""

    shape: tuple[int, ...]
    dtype: torch.dtype


def input_specs(config: Config, cell: ShapeCell) -> dict[str, Any]:
    """Model-input stand-ins for one (arch x shape) cell."""
    if isinstance(config, LMConfig):
        return _lm_input_specs(config, cell)
    if isinstance(config, GNNConfig):
        return _gnn_input_specs(config, cell)
    if isinstance(config, RecsysConfig):
        return _recsys_input_specs(config, cell)
    raise TypeError(type(config))


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


def _pad512(n: int) -> int:
    """Graph/candidate dims padded to a 512 multiple so every mesh divides
    them (GSPMD rejects uneven shardings).  Padding rows are isolated
    self-loop nodes masked out of the loss — <0.03% overhead at these sizes."""
    return ((n + 511) // 512) * 512


def _gnn_input_specs(cfg: GNNConfig, cell: ShapeCell) -> dict[str, Any]:
    p = cell.params
    if cell.kind == "full_graph":
        n, e, df = _pad512(p["n_nodes"]), _pad512(p["n_edges"]), p["d_feat"]
        return {
            "node_feat": TensorSpec((n, df), cfg.dtype),
            "edge_index": TensorSpec((2, e), torch.int32),
            "labels": TensorSpec((n,), torch.int32),
            "train_mask": TensorSpec((n,), torch.bool),
        }
    if cell.kind == "minibatch":
        b, f1, f2 = p["batch_nodes"], p["fanout1"], p["fanout2"]
        n_sub = b * (1 + f1 + f1 * f2)  # padded sampled subgraph
        e_sub = b * (f1 + f1 * f2)
        return {
            "node_feat": TensorSpec((n_sub, 602), cfg.dtype),  # reddit d_feat
            "edge_index": TensorSpec((2, e_sub), torch.int32),
            "labels": TensorSpec((b,), torch.int32),
            "seed_ids": TensorSpec((b,), torch.int32),
        }
    if cell.kind == "batched_graphs":
        b, n, e = p["batch"], p["n_nodes"], p["n_edges"]
        return {
            "node_feat": TensorSpec((b, n, 16), cfg.dtype),
            "edge_index": TensorSpec((b, 2, e), torch.int32),
            "labels": TensorSpec((b,), torch.int32),
        }
    raise ValueError(cell.kind)


def _recsys_input_specs(cfg: RecsysConfig, cell: ShapeCell) -> dict[str, Any]:
    p = cell.params
    if cell.kind == "retrieval":
        specs = _recsys_batch_specs(cfg, p["batch"])
        specs.pop("labels", None)
        specs["candidate_ids"] = TensorSpec((p["n_candidates"],), torch.int32)
        return specs
    specs = _recsys_batch_specs(cfg, p["batch"])
    if cell.kind != "train":
        specs.pop("labels", None)
    return specs


def _recsys_batch_specs(cfg: RecsysConfig, B: int) -> dict[str, Any]:
    if cfg.interaction == "cross":  # dcn-v2
        return {
            "dense": TensorSpec((B, cfg.n_dense), cfg.dtype),
            "sparse_ids": TensorSpec((B, cfg.n_sparse), torch.int32),
            "labels": TensorSpec((B,), cfg.dtype),
        }
    if cfg.interaction == "fm-2way":  # fm
        return {
            "sparse_ids": TensorSpec((B, cfg.n_sparse), torch.int32),
            "labels": TensorSpec((B,), cfg.dtype),
        }
    if cfg.interaction == "transformer-seq":  # bst
        return {
            "hist_ids": TensorSpec((B, cfg.seq_len), torch.int32),
            "target_id": TensorSpec((B,), torch.int32),
            "labels": TensorSpec((B,), cfg.dtype),
        }
    if cfg.interaction == "self-attn-seq":  # sasrec
        return {
            "hist_ids": TensorSpec((B, cfg.seq_len), torch.int32),
            "pos_ids": TensorSpec((B,), torch.int32),
            "neg_ids": TensorSpec((B,), torch.int32),
            "labels": TensorSpec((B,), cfg.dtype),
        }
    raise ValueError(cfg.interaction)
