"""Fault-tolerant training driver: checkpoint-restart with failure injection.

The loop is single-process and exercises the full restart path:
deterministic batch re-assignment (step -> data seed), crash injection,
resume from the latest durable checkpoint.  The step runs eagerly (the
reference jits it); its metrics are read back to the host, which waits for
the device, before the step's seconds are taken.

Straggler mitigation at scale (documented design, see DESIGN §8): synchronous
steps bound straggler damage to one step; slow hosts are detected by
per-step heartbeat timing and evicted by restarting onto the healthy subset
(elastic restore); the input pipeline is prefetched host-side so data never
gates the step.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable

from ..ckpt import CheckpointManager


class InjectedFailure(RuntimeError):
    pass


@dataclass
class TrainDriver:
    train_step: Callable[[dict, dict], tuple[dict, dict]]
    make_batch: Callable[[int], dict]  # step -> batch (deterministic reassignment)
    ckpt: CheckpointManager
    ckpt_every: int = 10
    fail_at_steps: tuple[int, ...] = ()  # injected crashes (once each)
    log: list[dict] = field(default_factory=list)
    _failed: set = field(default_factory=set)

    def run(self, state: dict, n_steps: int) -> tuple[dict, list[dict]]:
        """Run to ``n_steps``, restarting on failure. Returns (state, log)."""
        step = 0
        restored = self.ckpt.latest_step()
        if restored is not None:
            step, state = self.ckpt.restore()
        while step < n_steps:
            try:
                if step in self.fail_at_steps and step not in self._failed:
                    self._failed.add(step)
                    raise InjectedFailure(f"injected node failure at step {step}")
                t0 = time.perf_counter()
                state, metrics = self.train_step(state, self.make_batch(step))
                metrics = {k: float(v) for k, v in metrics.items()}
                step += 1
                self.log.append(
                    {"step": step, "seconds": time.perf_counter() - t0, **metrics}
                )
                if step % self.ckpt_every == 0 or step == n_steps:
                    self.ckpt.save(step, state)
            except InjectedFailure:
                # restart path: restore last durable checkpoint, re-derive the
                # batch stream from the restored step (no data loss/dup)
                restored = self.ckpt.latest_step()
                if restored is None:
                    step = 0
                    self.log.append({"event": "restart", "from_step": 0})
                    continue
                step, state = self.ckpt.restore()
                self.log.append({"event": "restart", "from_step": step})
        self.ckpt.wait()
        return state, self.log
