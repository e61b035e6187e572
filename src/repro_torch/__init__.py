"""PyTorch/CUDA port of the ``repro`` package, slice by slice.

It imports torch, numpy and the standard library, never ``jax`` and nothing
of ``repro``: where it needs a module of ``repro`` it keeps its own copy under
the same relative path.  The serving path (``serve.ServeEngine``) runs the
dense-GQA transformer with a hand-written Hopper decode-attention kernel
(``kernels/decode_attention``); full-sequence attention and training use the
flash kernels (``kernels/flash_attention``); the recsys models look rows up
through the embedding-bag kernel (``kernels/embedding_bag``) and GatedGCN
aggregates through the gated-aggregation kernels (``kernels/gnn_aggregate``).
Entry points run on CUDA unless the caller passes ``device="cpu"``.
"""
