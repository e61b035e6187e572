"""Aggregate throughput/reuse stats of a serving engine: a copy of
``AggregateStats`` from the reference package's ``sched/stats.py``.  The
per-tenant ledger stays behind until a slice needs it."""
from __future__ import annotations

from dataclasses import dataclass


@dataclass
class AggregateStats:
    """Fleet-level view over many completed runs/requests.

    ``units`` are the per-run work items — DAG nodes for ``WorkflowService``,
    prompt chunks for ``ServeEngine`` — so ``reuse_rate`` is comparable
    across both: the fraction of work the shared intermediate-data layer
    avoided recomputing.
    """

    runs: int = 0
    failures: int = 0
    wall_seconds: float = 0.0  # first submission -> last completion
    busy_seconds: float = 0.0  # sum of per-run wall times
    units_total: int = 0
    units_skipped: int = 0
    stored: int = 0
    singleflight_waits: int = 0

    def add_run(self, result: "object") -> None:
        """Fold one completed run into the tally.  ``result`` is any
        RunResult-shaped object (``total_seconds``, ``module_seconds``,
        ``n_skipped``, ``stored_keys``) — sequential or DAG.  Callers
        serialize access (this mutates under their lock)."""
        self.runs += 1
        self.busy_seconds += result.total_seconds  # type: ignore[attr-defined]
        self.units_total += len(result.module_seconds)  # type: ignore[attr-defined]
        self.units_skipped += result.n_skipped  # type: ignore[attr-defined]
        self.stored += len(result.stored_keys)  # type: ignore[attr-defined]

    def snapshot(
        self, wall_seconds: float, singleflight_waits: int = 0
    ) -> "AggregateStats":
        """Immutable copy of a live tally with the window-level fields filled
        in — the reporting shape ``WorkflowService.stats`` and
        ``Client.stats`` both return."""
        return AggregateStats(
            runs=self.runs,
            failures=self.failures,
            wall_seconds=max(wall_seconds, 0.0),
            busy_seconds=self.busy_seconds,
            units_total=self.units_total,
            units_skipped=self.units_skipped,
            stored=self.stored,
            singleflight_waits=singleflight_waits,
        )

    @property
    def throughput_rps(self) -> float:
        """Completed runs per wall-clock second across the whole window."""
        return self.runs / self.wall_seconds if self.wall_seconds > 0 else 0.0

    @property
    def reuse_rate(self) -> float:
        """Fraction of work units skipped via store hits / single-flight."""
        return self.units_skipped / self.units_total if self.units_total else 0.0

    @property
    def concurrency(self) -> float:
        """Mean number of runs in flight (busy over wall time)."""
        return self.busy_seconds / self.wall_seconds if self.wall_seconds > 0 else 0.0

    def row(self) -> str:
        return (
            f"runs={self.runs} failures={self.failures} "
            f"throughput={self.throughput_rps:.2f}/s reuse={self.reuse_rate:.2%} "
            f"singleflight_waits={self.singleflight_waits} stored={self.stored}"
        )

