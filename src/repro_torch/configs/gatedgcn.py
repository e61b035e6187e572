"""GatedGCN (arXiv:2003.00982 benchmarking-GNNs): 16L, d_hidden=70, gated agg."""
from .base import GNNConfig, GNN_SHAPES, reduced

CONFIG = GNNConfig(
    name="gatedgcn",
    n_layers=16,
    d_hidden=70,
    aggregator="gated",
    d_edge=8,
    n_classes=47,
)

SMOKE = reduced(CONFIG, name="gatedgcn-smoke", n_layers=3, d_hidden=16, n_classes=7)

SHAPES = GNN_SHAPES
