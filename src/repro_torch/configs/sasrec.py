"""SASRec (arXiv:1808.09781): 2 blocks, 1 head, seq 50, embed 50."""
from .base import RecsysConfig, RECSYS_SHAPES, reduced

CONFIG = RecsysConfig(
    name="sasrec",
    interaction="self-attn-seq",
    embed_dim=50,
    seq_len=50,
    n_blocks=2,
    n_heads=1,
    item_vocab=2_000_000,  # industrial catalogue; >= retrieval_cand pool
)

SMOKE = reduced(
    CONFIG, name="sasrec-smoke", embed_dim=8, seq_len=10, n_blocks=1,
    item_vocab=500,
)

SHAPES = RECSYS_SHAPES
