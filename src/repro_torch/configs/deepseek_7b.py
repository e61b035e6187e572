"""DeepSeek-LLM 7B (arXiv:2401.02954): llama-arch dense, MHA (GQA kv=32)."""
from .base import LMConfig, LM_SHAPES, reduced

CONFIG = LMConfig(
    name="deepseek-7b",
    n_layers=30,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    d_head=128,
    d_ff=11008,
    vocab=102400,
    sub_quadratic=False,  # pure full attention -> long_500k skipped (DESIGN §4)
)

SMOKE = reduced(
    CONFIG, name="deepseek-7b-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=4, d_head=16, d_ff=128, vocab=256,
)

SHAPES = LM_SHAPES
