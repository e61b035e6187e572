from .ops import gnn_aggregate, gnn_aggregate_csr, reset_launches
from .ref import (
    CsrIndex,
    EllIndex,
    csr_index,
    edge_to_padded,
    edge_to_padded_vec,
    ell_as_csr,
    ell_index,
    gnn_aggregate_csr_ref,
    gnn_aggregate_ref,
)

__all__ = [
    "CsrIndex",
    "EllIndex",
    "csr_index",
    "edge_to_padded",
    "edge_to_padded_vec",
    "ell_as_csr",
    "ell_index",
    "gnn_aggregate",
    "gnn_aggregate_csr",
    "gnn_aggregate_csr_ref",
    "gnn_aggregate_ref",
    "reset_launches",
]
