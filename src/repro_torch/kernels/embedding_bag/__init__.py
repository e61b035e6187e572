from .ops import embedding_bag, plan
from .ref import embedding_bag_ref, embedding_bag_seq_ref, embedding_bag_tiled

__all__ = ["embedding_bag", "embedding_bag_ref", "embedding_bag_seq_ref", "embedding_bag_tiled",
           "plan"]
