from .ops import decode_attention, decode_attention_chunk, decode_attention_insert
from .ref import decode_attention_ref, fused_two_level_ref

__all__ = [
    "decode_attention", "decode_attention_chunk", "decode_attention_insert", "decode_attention_ref",
    "fused_two_level_ref",
]
