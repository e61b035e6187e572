"""Architecture registry: --arch <id> resolves here.  The port carries the
dense-GQA configs of its serving and training slices, GatedGCN and the four
recsys models."""
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

register("gemma3-4b", "gemma3_4b")
register("tinyllama-1.1b", "tinyllama_1_1b")
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
