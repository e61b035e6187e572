"""Aggregate throughput/reuse stats shared by the scheduler service and the
serving engine (both are front doors that replay many units of work against
one RISP-governed cache), plus the per-tenant ledger the gateway bills
quota against.

These dict-shaped snapshots are now *deprecated aliases* over the unified
:mod:`repro.obs.metrics` registry: ``runs``/``failures`` ↔
``repro_runs_total{status}``, ``units_total``/``units_skipped`` ↔
``repro_run_units[_skipped]_total``, ``stored`` ↔ ``repro_run_stored_total``,
``singleflight_waits`` ↔ ``repro_singleflight_waits_total``, and the
per-tenant counters ↔ ``repro_tenant_*{tenant}``.  See
``repro/obs/naming.py`` for the pinned mapping."""
from __future__ import annotations

import threading
from dataclasses import dataclass, field


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


@dataclass
class TenantCounters:
    """One tenant's resource tally: what multi-user admission control and
    quota billing are computed from."""

    runs_in_flight: int = 0
    runs_total: int = 0
    failures: int = 0
    rejected: int = 0  # 429s: pending budget or tenant quota
    bytes_stored: int = 0  # live bytes this tenant's runs put in the store
    keys_stored: int = 0
    units_total: int = 0
    units_skipped: int = 0

    @property
    def reuse_rate(self) -> float:
        return self.units_skipped / self.units_total if self.units_total else 0.0

    def as_dict(self) -> dict:
        return {
            "runs_in_flight": self.runs_in_flight,
            "runs_total": self.runs_total,
            "failures": self.failures,
            "rejected": self.rejected,
            "bytes_stored": self.bytes_stored,
            "keys_stored": self.keys_stored,
            "units_total": self.units_total,
            "units_skipped": self.units_skipped,
            "reuse_rate": self.reuse_rate,
        }


@dataclass
class TenantLedger:
    """Thread-safe per-tenant accounting over one shared store.

    The gateway charges each stored key to the tenant whose run persisted it
    (shared-namespace artifacts bill their *storer* — the tenants who reuse
    them ride free, which is exactly the economics the thesis wants to
    encourage), and credits the bytes back when the eviction manager (or a
    fleet-wide eviction event) reclaims the key — so ``bytes_stored`` tracks
    *live* usage against the store budget, not a monotone total.
    """

    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False)
    _tenants: dict[str, TenantCounters] = field(default_factory=dict)
    _key_owner: dict[str, tuple[str, int]] = field(default_factory=dict)
    _metrics: "object | None" = field(default=None, repr=False)

    def bind_metrics(self, registry) -> None:
        """Mirror the ledger onto a :class:`repro.obs.metrics.MetricsRegistry`
        as tenant-labeled series (the gateway calls this with its registry).
        The dict snapshot stays the deprecated alias surface; the registry
        series are the canonical names (see ``repro/obs/naming.py``).  Note
        ``repro_tenant_runs_total`` counts *started* reservations — a
        cancelled reservation is subtracted from the alias dict but, being a
        monotone counter, not from the canonical series."""
        self._metrics = registry
        self._m_runs = registry.counter(
            "repro_tenant_runs_total", "run reservations started", ("tenant",)
        )
        self._m_failures = registry.counter(
            "repro_tenant_failures_total", "runs that failed", ("tenant",)
        )
        self._m_rejected = registry.counter(
            "repro_tenant_rejected_total", "submissions rejected (429)", ("tenant",)
        )
        self._g_inflight = registry.gauge(
            "repro_tenant_inflight", "runs currently in flight", ("tenant",)
        )
        self._g_bytes = registry.gauge(
            "repro_tenant_stored_bytes", "live stored bytes billed", ("tenant",)
        )

    def _sync_gauges(self, tenant: str, c: TenantCounters) -> None:
        if self._metrics is None:
            return
        self._g_inflight.labels(tenant=tenant).set(c.runs_in_flight)
        self._g_bytes.labels(tenant=tenant).set(c.bytes_stored)

    def _get(self, tenant: str) -> TenantCounters:
        c = self._tenants.get(tenant)
        if c is None:
            c = self._tenants[tenant] = TenantCounters()
        return c

    def run_started(self, tenant: str) -> None:
        with self._lock:
            c = self._get(tenant)
            c.runs_in_flight += 1
            c.runs_total += 1
            if self._metrics is not None:
                self._m_runs.labels(tenant=tenant).inc()
            self._sync_gauges(tenant, c)

    def run_finished(
        self,
        tenant: str,
        *,
        failed: bool = False,
        units_total: int = 0,
        units_skipped: int = 0,
    ) -> None:
        with self._lock:
            c = self._get(tenant)
            c.runs_in_flight = max(0, c.runs_in_flight - 1)
            c.units_total += units_total
            c.units_skipped += units_skipped
            if failed:
                c.failures += 1
                if self._metrics is not None:
                    self._m_failures.labels(tenant=tenant).inc()
            self._sync_gauges(tenant, c)

    def run_cancelled(self, tenant: str) -> None:
        """Release a reservation that never ran (a later admission layer
        rejected it): undo both the in-flight slot and the run count."""
        with self._lock:
            c = self._get(tenant)
            c.runs_in_flight = max(0, c.runs_in_flight - 1)
            c.runs_total = max(0, c.runs_total - 1)
            self._sync_gauges(tenant, c)

    def rejected(self, tenant: str) -> None:
        with self._lock:
            self._get(tenant).rejected += 1
            if self._metrics is not None:
                self._m_rejected.labels(tenant=tenant).inc()

    def charge_stored(self, tenant: str, key: str, nbytes: int) -> None:
        """Bill ``nbytes`` of ``key`` to ``tenant``.  Re-storing a key that
        is already billed (another run recomputed it after an eviction the
        ledger missed) re-bills at the new size without double counting."""
        with self._lock:
            prev = self._key_owner.pop(key, None)
            if prev is not None:
                pc = self._get(prev[0])
                pc.bytes_stored = max(0, pc.bytes_stored - prev[1])
                pc.keys_stored = max(0, pc.keys_stored - 1)
            c = self._get(tenant)
            c.bytes_stored += nbytes
            c.keys_stored += 1
            self._key_owner[key] = (tenant, nbytes)
            if prev is not None:
                self._sync_gauges(prev[0], self._get(prev[0]))
            self._sync_gauges(tenant, c)

    def credit_evicted(self, key: str) -> None:
        """The store reclaimed ``key``: release its bytes from whichever
        tenant was billed.  Unknown keys are ignored (evictions of artifacts
        stored before the ledger existed, or by out-of-band writers)."""
        with self._lock:
            owner = self._key_owner.pop(key, None)
            if owner is None:
                return
            c = self._get(owner[0])
            c.bytes_stored = max(0, c.bytes_stored - owner[1])
            c.keys_stored = max(0, c.keys_stored - 1)
            self._sync_gauges(owner[0], c)

    def in_flight(self, tenant: str) -> int:
        with self._lock:
            c = self._tenants.get(tenant)
            return c.runs_in_flight if c is not None else 0

    def bytes_stored(self, tenant: str) -> int:
        with self._lock:
            c = self._tenants.get(tenant)
            return c.bytes_stored if c is not None else 0

    def snapshot(self, tenant: str | None = None) -> dict:
        """Plain-dict view: one tenant's counters, or ``{tenant: counters}``
        for all of them."""
        with self._lock:
            if tenant is not None:
                c = self._tenants.get(tenant)
                return (c.as_dict() if c is not None else TenantCounters().as_dict())
            return {t: c.as_dict() for t, c in self._tenants.items()}
