"""BST (arXiv:1905.06874): Behaviour Sequence Transformer (Alibaba)."""
from .base import RecsysConfig, RECSYS_SHAPES, reduced

CONFIG = RecsysConfig(
    name="bst",
    interaction="transformer-seq",
    embed_dim=32,
    seq_len=20,
    n_blocks=1,
    n_heads=8,
    mlp=(1024, 512, 256),
    item_vocab=4_000_000,  # Taobao-scale item catalogue
)

SMOKE = reduced(
    CONFIG, name="bst-smoke", embed_dim=8, seq_len=6, n_heads=2,
    mlp=(32, 16), item_vocab=1000,
)

SHAPES = RECSYS_SHAPES
