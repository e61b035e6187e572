from .ops import decode_attention
from .ref import decode_attention_ref

__all__ = ["decode_attention", "decode_attention_ref"]
