"""JSONL provenance log of workflow executions (thesis: CouchDB run records)."""
from __future__ import annotations

import json
import threading
import time
from dataclasses import asdict, dataclass, field
from pathlib import Path
from typing import Any, Iterator


@dataclass
class RunRecord:
    workflow_id: str
    dataset_id: str
    modules: list[str]
    module_seconds: list[float]
    reused_prefix_depth: int
    load_seconds: float
    stored_keys: list[str]
    store_seconds: float
    total_seconds: float
    n_requests: int  # module execs + store/loads — the Table 6.1 "requests" proxy
    failed_at: int | None = None
    recovered_from_depth: int = 0
    timestamp: float = field(default_factory=time.time)
    extra: dict[str, Any] = field(default_factory=dict)


class ProvenanceLog:
    def __init__(self, path: str | Path | None = None) -> None:
        self.path = Path(path) if path else None
        self.records: list[RunRecord] = []
        self._lock = threading.Lock()  # concurrent runs append from workers
        if self.path and self.path.exists():
            for line in self.path.read_text().splitlines():
                if line.strip():
                    self.records.append(RunRecord(**json.loads(line)))

    def append(self, rec: RunRecord) -> None:
        with self._lock:
            self.records.append(rec)
            if self.path:
                with self.path.open("a") as f:
                    f.write(json.dumps(asdict(rec)) + "\n")

    def __iter__(self) -> Iterator[RunRecord]:
        return iter(self.records)

    def __len__(self) -> int:
        return len(self.records)

    def totals(self) -> dict[str, float]:
        return {
            "runs": len(self.records),
            "total_seconds": sum(r.total_seconds for r in self.records),
            "exec_seconds": sum(sum(r.module_seconds) for r in self.records),
            "load_seconds": sum(r.load_seconds for r in self.records),
            "store_seconds": sum(r.store_seconds for r in self.records),
            "requests": sum(r.n_requests for r in self.records),
            "reused_runs": sum(1 for r in self.records if r.reused_prefix_depth > 0),
        }
