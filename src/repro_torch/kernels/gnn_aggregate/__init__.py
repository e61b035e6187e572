from .ops import gnn_aggregate
from .ref import EllIndex, edge_to_padded, edge_to_padded_vec, ell_index, gnn_aggregate_ref

__all__ = [
    "EllIndex",
    "edge_to_padded",
    "edge_to_padded_vec",
    "ell_index",
    "gnn_aggregate",
    "gnn_aggregate_ref",
]
