"""Architecture registry: --arch <id> resolves here.  The port carries every
configuration the reference registers: the five LM architectures (dense
GQA, MoE and MLA), GatedGCN and the four recsys models."""
from .base import (
    GNN_SHAPES,
    LM_SHAPES,
    RECSYS_SHAPES,
    Config,
    GNNConfig,
    LMConfig,
    MLASpec,
    MoESpec,
    RecsysConfig,
    ShapeCell,
    TensorSpec,
    get_arch,
    get_config,
    get_shapes,
    input_specs,
    list_archs,
    reduced,
    register,
)

register("deepseek-7b", "deepseek_7b")
register("gemma3-4b", "gemma3_4b")
register("tinyllama-1.1b", "tinyllama_1_1b")
register("qwen2-moe-a2.7b", "qwen2_moe_a2_7b")
register("deepseek-v2-236b", "deepseek_v2_236b")
register("gatedgcn", "gatedgcn")
register("bst", "bst")
register("dcn-v2", "dcn_v2")
register("fm", "fm")
register("sasrec", "sasrec")

__all__ = [
    "GNN_SHAPES",
    "LM_SHAPES",
    "RECSYS_SHAPES",
    "Config",
    "GNNConfig",
    "LMConfig",
    "MLASpec",
    "MoESpec",
    "RecsysConfig",
    "ShapeCell",
    "TensorSpec",
    "get_arch",
    "get_config",
    "get_shapes",
    "input_specs",
    "list_archs",
    "reduced",
    "register",
]
