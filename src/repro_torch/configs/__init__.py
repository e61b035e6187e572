"""Architecture registry: --arch <id> resolves here.  The port carries the
dense-GQA configs its serving slice runs."""
from .base import LMConfig, MLASpec, MoESpec, get_arch, get_config, list_archs, reduced, register

register("gemma3-4b", "gemma3_4b")
register("tinyllama-1.1b", "tinyllama_1_1b")

__all__ = [
    "LMConfig",
    "MLASpec",
    "MoESpec",
    "get_arch",
    "get_config",
    "list_archs",
    "reduced",
    "register",
]
