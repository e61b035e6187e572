"""Gemma-3 4B (hf:google/gemma-3-*): 5:1 local:global attention, 128k ctx."""
from .base import LMConfig, reduced

CONFIG = LMConfig(
    name="gemma3-4b",
    n_layers=34,
    d_model=2560,
    n_heads=8,
    n_kv_heads=4,
    d_head=256,
    d_ff=10240,
    vocab=262144,
    local_global=(5, 1),
    local_window=1024,
    rope_theta=1_000_000.0,
    sub_quadratic=True,  # hybrid local:global -> long_500k runs
)

SMOKE = reduced(
    CONFIG, name="gemma3-4b-smoke", n_layers=3, d_model=64, n_heads=4,
    n_kv_heads=2, d_head=16, d_ff=128, vocab=256, local_global=(2, 1),
    local_window=8,
)
