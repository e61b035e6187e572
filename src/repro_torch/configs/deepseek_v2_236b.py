"""DeepSeek-V2 236B (arXiv:2405.04434): MLA kv_lora=512, 2 shared + 160
routed top-6 experts.

Experts shard over the data axis (160/16=10) with per-expert d_ff over the
model axis (1536/16=96): pure model-axis EP would leave 28 GB of expert
weights per chip (> v5e HBM). MLA's latent cache makes long_500k deployable.
"""
from .base import LMConfig, LM_SHAPES, MLASpec, MoESpec, reduced

CONFIG = LMConfig(
    name="deepseek-v2-236b",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,
    d_head=192,  # nope 128 + rope 64
    d_ff=12288,
    vocab=102400,
    moe=MoESpec(n_experts=160, top_k=6, n_shared=2, d_ff_expert=1536),
    mla=MLASpec(
        kv_lora_rank=512, q_lora_rank=1536, rope_head_dim=64,
        nope_head_dim=128, v_head_dim=128,
    ),
    rope_theta=10_000.0,
    sub_quadratic=True,  # MLA latent cache -> long_500k runs
    shard_overrides=(("experts", ("data",)),),
)

SMOKE = reduced(
    CONFIG, name="deepseek-v2-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=4, d_head=24, d_ff=128, vocab=256,
    moe=MoESpec(n_experts=8, top_k=2, n_shared=1, d_ff_expert=32),
    mla=MLASpec(kv_lora_rank=16, q_lora_rank=24, rope_head_dim=8,
                nope_head_dim=16, v_head_dim=16),
)

SHAPES = LM_SHAPES
