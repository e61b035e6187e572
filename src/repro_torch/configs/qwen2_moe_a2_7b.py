"""Qwen1.5-MoE-A2.7B (hf:Qwen/Qwen1.5-MoE-A2.7B): 4 shared + 60 routed top-4.

Expert count 60 is not divisible by the 16-way model axis; the sharding rules
fall back to tensor-parallel per-expert d_ff (1408/16 = 88) — see DESIGN §5.
"""
from .base import LMConfig, LM_SHAPES, MoESpec, reduced

CONFIG = LMConfig(
    name="qwen2-moe-a2.7b",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_head=128,
    d_ff=1408,
    vocab=151936,
    moe=MoESpec(n_experts=60, top_k=4, n_shared=4, d_ff_expert=1408),
    sub_quadratic=False,  # pure full attention -> long_500k skipped
)

SMOKE = reduced(
    CONFIG, name="qwen2-moe-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=4, d_head=16, d_ff=64, vocab=256,
    moe=MoESpec(n_experts=8, top_k=2, n_shared=1, d_ff_expert=32),
)

SHAPES = LM_SHAPES
