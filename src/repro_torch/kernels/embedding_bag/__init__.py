from .ops import embedding_bag, embedding_bag_bwd, plan, reset_launches
from .ref import (
    bwd_index,
    embedding_bag_bwd_ref,
    embedding_bag_bwd_seq_ref,
    embedding_bag_ref,
    embedding_bag_seq_ref,
    embedding_bag_tiled,
)

__all__ = ["bwd_index", "embedding_bag", "embedding_bag_bwd", "embedding_bag_bwd_ref",
           "embedding_bag_bwd_seq_ref", "embedding_bag_ref", "embedding_bag_seq_ref",
           "embedding_bag_tiled", "plan", "reset_launches"]
