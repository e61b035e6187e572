from .ops import flash_attention, reset_launches, variant
from .ref import attention_lse_ref, attention_ref

__all__ = ["attention_lse_ref", "attention_ref", "flash_attention", "reset_launches", "variant"]
