"""Checkpointing on one card: manifest save/restore and async save, on torch.

Built on the same IntermediateStore as RISP artifacts — a checkpoint IS an
intermediate state of the training workflow (the thesis' error-recovery
story, Ch. 3.5.2, applied to training):

  * async mode snapshots to host memory synchronously (a copy of every
    tensor, so later in-place updates cannot reach it) and writes on a
    worker thread, overlapping serialization with the next step's compute
  * restore returns tensors on the manager's device (or the one named)
"""
from __future__ import annotations

import json
import threading
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Any

import torch

from ..core.store import IntermediateStore
from ..tree import tree_map


@dataclass
class CheckpointInfo:
    step: int
    key: str
    nbytes: int
    seconds: float
    async_pending: bool = False


class CheckpointManager:
    def __init__(
        self,
        directory: str | Path,
        *,
        keep: int = 3,
        async_save: bool = False,
        device: str | torch.device = "cuda",
    ) -> None:
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.store = IntermediateStore(self.dir / "objects")
        self.keep = keep
        self.async_save = async_save
        self.device = torch.device(device)
        self._meta_path = self.dir / "checkpoints.json"
        self.checkpoints: list[dict] = []
        if self._meta_path.exists():
            self.checkpoints = json.loads(self._meta_path.read_text())
        self._pending: threading.Thread | None = None

    # -- save ------------------------------------------------------------
    def _key(self, step: int) -> str:
        return f"ckpt::step{step:012d}"

    def save(self, step: int, state: Any) -> CheckpointInfo:
        if self.async_save:
            return self._save_async(step, state)
        t0 = time.perf_counter()
        res = self.store.put(self._key(step), state)
        self._commit(step, res.nbytes_raw)
        return CheckpointInfo(step, res.key, res.nbytes_raw, time.perf_counter() - t0)

    def _save_async(self, step: int, state: Any) -> CheckpointInfo:
        self.wait()  # one in flight at a time
        # snapshot to host memory synchronously (cheap), write on a thread
        host_state = tree_map(_host_copy, state)

        def work():
            res = self.store.put(self._key(step), host_state)
            self._commit(step, res.nbytes_raw)

        self._pending = threading.Thread(target=work, daemon=True)
        self._pending.start()
        return CheckpointInfo(step, self._key(step), 0, 0.0, async_pending=True)

    def wait(self) -> None:
        if self._pending is not None:
            self._pending.join()
            self._pending = None

    def _commit(self, step: int, nbytes: int) -> None:
        self.checkpoints = [c for c in self.checkpoints if c["step"] != step]
        self.checkpoints.append({"step": step, "nbytes": nbytes, "ts": time.time()})
        self.checkpoints.sort(key=lambda c: c["step"])
        while len(self.checkpoints) > self.keep:
            old = self.checkpoints.pop(0)
            self.store.delete(self._key(old["step"]))
        self._meta_path.write_text(json.dumps(self.checkpoints))

    # -- restore -------------------------------------------------------------
    def latest_step(self) -> int | None:
        self.wait()
        return self.checkpoints[-1]["step"] if self.checkpoints else None

    def restore(
        self,
        step: int | None = None,
        *,
        device: str | torch.device | None = None,
    ) -> tuple[int, Any]:
        """Restore a checkpoint onto ``device`` (default: the manager's)."""
        self.wait()
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        state = self.store.get(self._key(step), device=device or self.device)
        return step, state


def _host_copy(leaf: Any) -> Any:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    return leaf
