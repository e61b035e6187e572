"""FM (Rendle ICDM'10): pairwise interactions via the O(nk) sum-square trick."""
from .base import RecsysConfig, RECSYS_SHAPES, reduced

# 39 sparse fields (Criteo-TB style: 13 bucketized dense + 26 categorical)
_FM_VOCABS = tuple([100] * 13 + list((
    1461, 584, 8_000_000, 2_202_608, 306, 24, 12_518, 634, 4, 93_146,
    5684, 6_500_000, 3195, 28, 14_993, 5_461_306, 11, 5653, 2173, 4,
    7_046_547, 18, 16, 286_181, 105, 142_572,
)))

CONFIG = RecsysConfig(
    name="fm",
    interaction="fm-2way",
    embed_dim=10,
    n_sparse=39,
    vocab_sizes=_FM_VOCABS,
)

SMOKE = reduced(
    CONFIG, name="fm-smoke", embed_dim=4, n_sparse=6,
    vocab_sizes=(50, 100, 20, 80, 10, 30),
)

SHAPES = RECSYS_SHAPES
