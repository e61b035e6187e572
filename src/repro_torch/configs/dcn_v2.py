"""DCN-v2 (arXiv:2008.13535): 13 dense + 26 sparse (Criteo), 3 cross layers."""
from .base import RecsysConfig, RECSYS_SHAPES, reduced

# Criteo-Kaggle-like per-field cardinalities (sum ~33.8M)
_CRITEO_VOCABS = (
    1461, 584, 10_131_227, 2_202_608, 306, 24, 12_518, 634, 4, 93_146,
    5684, 8_351_593, 3195, 28, 14_993, 5_461_306, 11, 5653, 2173, 4,
    7_046_547, 18, 16, 286_181, 105, 142_572,
)

CONFIG = RecsysConfig(
    name="dcn-v2",
    interaction="cross",
    embed_dim=16,
    n_dense=13,
    n_sparse=26,
    n_cross_layers=3,
    mlp=(1024, 1024, 512),
    vocab_sizes=_CRITEO_VOCABS,
)

SMOKE = reduced(
    CONFIG, name="dcn-v2-smoke", embed_dim=4, n_dense=4, n_sparse=5,
    n_cross_layers=2, mlp=(16, 8), vocab_sizes=(50, 100, 20, 80, 10),
)

SHAPES = RECSYS_SHAPES
