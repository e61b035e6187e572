"""PyTorch/CUDA port of the ``repro`` package, slice by slice.

It imports torch, numpy and the standard library, never ``jax`` and nothing
of ``repro``: where it needs a module of ``repro`` it keeps its own copy under
the same relative path.  The serving path (``serve.ServeEngine``) runs the
dense-GQA transformer with a hand-written Hopper decode-attention kernel
(``kernels/decode_attention``).  Entry points run on CUDA unless the caller
passes ``device="cpu"``.
"""
