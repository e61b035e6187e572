from .graph import CSRGraph, NeighborSampler, random_graph
from .synthetic import make_batch

__all__ = ["CSRGraph", "NeighborSampler", "make_batch", "random_graph"]
