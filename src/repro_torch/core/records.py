"""Bookkeeping record of one stored artifact: a copy of ``ArtifactRecord``
from the reference package's ``core/store.py``, the one piece of the store
that snapshot retention needs."""
from __future__ import annotations

import time
from dataclasses import dataclass, field


@dataclass
class ArtifactRecord:
    key: str
    nbytes_raw: int
    nbytes_disk: int
    save_s: float
    load_s: float | None = None
    n_loads: int = 0
    created_at: float = field(default_factory=time.time)
    compute_s: float | None = None  # producer-reported recompute seconds
    last_used_at: float = 0.0

    def __post_init__(self) -> None:
        if not self.last_used_at:
            self.last_used_at = self.created_at
