"""LM data-preparation pipeline as SWfMS modules (RISP-cacheable stages).

The thesis' technique applies to *data* workflows first and foremost: the
tokenize -> pack -> split stages below register with the WorkflowExecutor, so
repeated training runs over the same corpus reuse the packed token shards
instead of re-preprocessing (DESIGN §4 table, LM row).

The port of the reference's ``data/pipeline.py``: torch functions on the
device of the tensor they are given.  The reference tokenizes in ``uint32``;
torch's ``uint32`` arithmetic is thin, so the port computes in ``int64`` (no
value comes near either limit: 255 * 311 + 255 * 7 < 2^17) and returns
``int32``, so every stored leaf equals the reference's byte for byte.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..core.executor import WorkflowExecutor
from ..core.workflow import ModuleSpec


def byte_tokenize(text_blob: torch.Tensor, vocab: int = 32000) -> torch.Tensor:
    """Toy byte-pair-ish tokenizer: fold bytes into the model vocab."""
    b = torch.as_tensor(text_blob).to(torch.int64)
    pairs = b[: (b.shape[0] // 2) * 2].reshape(-1, 2)
    ids = (pairs[:, 0] * 311 + pairs[:, 1] * 7) % vocab
    return ids.to(torch.int32)


def pack_sequences(ids: torch.Tensor, seq_len: int = 128) -> torch.Tensor:
    """Pack the token stream into [n, seq_len+1] rows (input+target)."""
    n = ids.shape[0] // (seq_len + 1)
    return ids[: n * (seq_len + 1)].reshape(n, seq_len + 1)


def train_split(packed: torch.Tensor, holdout: int = 8) -> dict:
    return {"train": packed[:-holdout], "eval": packed[-holdout:]}


def register_data_modules(ex: WorkflowExecutor, vocab: int = 32000) -> None:
    ex.register(
        ModuleSpec(
            "tokenize",
            lambda blob, vocab=vocab: byte_tokenize(blob, vocab),
            {"vocab": vocab},
        )
    )
    ex.register(
        ModuleSpec(
            "pack", lambda ids, seq_len=128: pack_sequences(ids, seq_len),
            {"seq_len": 128},
        )
    )
    ex.register(
        ModuleSpec(
            "split", lambda p, holdout=8: train_split(p, holdout), {"holdout": 8}
        )
    )


def make_corpus_blob(
    n_bytes: int = 1 << 20, seed: int = 0, device: Any = "cuda"
) -> torch.Tensor:
    """``n_bytes`` random bytes from numpy's generator seeded with ``seed``
    (the reference's draw, value for value), as ``int32`` on ``device``."""
    rng = np.random.default_rng(seed)
    blob = rng.integers(0, 256, size=n_bytes, dtype=np.uint32).astype(np.int32)
    return torch.from_numpy(blob).to(device)
