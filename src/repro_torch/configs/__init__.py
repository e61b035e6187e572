"""Architecture registry: --arch <id> resolves here.  The port carries the
dense-GQA configs its serving and training slices run."""
from .base import (
    LM_SHAPES,
    LMConfig,
    MLASpec,
    MoESpec,
    ShapeCell,
    TensorSpec,
    get_arch,
    get_config,
    input_specs,
    list_archs,
    reduced,
    register,
)

register("gemma3-4b", "gemma3_4b")
register("tinyllama-1.1b", "tinyllama_1_1b")

__all__ = [
    "LM_SHAPES",
    "LMConfig",
    "MLASpec",
    "MoESpec",
    "ShapeCell",
    "TensorSpec",
    "get_arch",
    "get_config",
    "input_specs",
    "list_archs",
    "reduced",
    "register",
]
