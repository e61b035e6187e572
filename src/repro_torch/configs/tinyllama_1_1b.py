"""TinyLlama 1.1B (arXiv:2401.02385): llama2-arch small, GQA kv=4."""
from .base import LMConfig, reduced

CONFIG = LMConfig(
    name="tinyllama-1.1b",
    n_layers=22,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    d_head=64,
    d_ff=5632,
    vocab=32000,
    sub_quadratic=False,  # pure full attention -> long_500k skipped
)

SMOKE = reduced(
    CONFIG, name="tinyllama-smoke", n_layers=2, d_model=64, n_heads=8,
    n_kv_heads=2, d_head=8, d_ff=128, vocab=256,
)
