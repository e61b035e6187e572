"""Admission control: bounded load, per-tenant quotas, explicit 429s.

Two layers refuse work *before* it costs anything:

  * the **service-wide pending budget** lives in ``WorkflowService``
    (``max_pending``) — its :class:`~repro_torch.sched.service.AdmissionRejected`
    is the global backpressure signal;
  * the **per-tenant quotas** live here: runs in flight per tenant (one
    noisy tenant cannot occupy the whole pending budget) and live stored
    bytes per tenant (billed/credited through the shared
    :class:`~repro_torch.sched.stats.TenantLedger`, which the gateway wires to the
    store's eviction events — quota is *live* usage against the eviction
    budget, not a monotone counter).

Both rejections surface to HTTP as structured ``429`` with ``Retry-After``;
accepted work is never silently dropped, rejected work is never silently
queued.
"""
from __future__ import annotations

from ..sched.stats import TenantLedger


class QuotaExceeded(Exception):
    """A per-tenant quota refused the submission (gateway → 429)."""

    def __init__(self, message: str, *, retry_after_s: float) -> None:
        super().__init__(message)
        self.retry_after_s = retry_after_s


class AdmissionController:
    """Per-tenant admission gates over a shared :class:`TenantLedger`.

    ``reserve`` is called before the service submit (and charges the
    in-flight slot so concurrent requests cannot over-admit); ``release`` is
    called when the run finishes — or immediately, when the service-wide
    budget rejected the submission after the reservation.
    """

    def __init__(
        self,
        ledger: TenantLedger,
        *,
        max_inflight_per_tenant: int | None = None,
        max_bytes_per_tenant: int | None = None,
        retry_after_s: float = 1.0,
    ) -> None:
        if max_inflight_per_tenant is not None and max_inflight_per_tenant < 1:
            raise ValueError("max_inflight_per_tenant must be >= 1 (or None)")
        if max_bytes_per_tenant is not None and max_bytes_per_tenant < 1:
            raise ValueError("max_bytes_per_tenant must be >= 1 (or None)")
        self.ledger = ledger
        self.max_inflight_per_tenant = max_inflight_per_tenant
        self.max_bytes_per_tenant = max_bytes_per_tenant
        self.retry_after_s = retry_after_s

    def reserve(self, tenant: str) -> None:
        """Admit one run for ``tenant`` or raise :class:`QuotaExceeded`.
        On success the tenant's in-flight count is already incremented."""
        if self.max_inflight_per_tenant is not None:
            if self.ledger.in_flight(tenant) >= self.max_inflight_per_tenant:
                self.ledger.rejected(tenant)
                raise QuotaExceeded(
                    f"tenant {tenant!r} already has "
                    f"{self.max_inflight_per_tenant} runs in flight",
                    retry_after_s=self.retry_after_s,
                )
        if self.max_bytes_per_tenant is not None:
            used = self.ledger.bytes_stored(tenant)
            if used >= self.max_bytes_per_tenant:
                self.ledger.rejected(tenant)
                raise QuotaExceeded(
                    f"tenant {tenant!r} stores {used} bytes, at or over its "
                    f"{self.max_bytes_per_tenant}-byte quota; reuse existing "
                    "artifacts or wait for eviction to reclaim space",
                    retry_after_s=self.retry_after_s,
                )
        self.ledger.run_started(tenant)

    def release(
        self,
        tenant: str,
        *,
        failed: bool = False,
        units_total: int = 0,
        units_skipped: int = 0,
    ) -> None:
        self.ledger.run_finished(
            tenant,
            failed=failed,
            units_total=units_total,
            units_skipped=units_skipped,
        )

    def cancel(self, tenant: str) -> None:
        """The service-wide pending budget rejected a submission *after* a
        successful reservation: undo the reservation and record the 429."""
        self.ledger.run_cancelled(tenant)
        self.ledger.rejected(tenant)
