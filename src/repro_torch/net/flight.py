"""Distributed single-flight: one computer per uncomputed prefix, fleet-wide.

The process-local :class:`~repro.sched.singleflight.SingleFlight` coalesces concurrent
computes of one store key *within* a process; this extends the election
across processes using the store service's lease table.  Two levels compose:

  1. locally, threads coalesce exactly as before (followers receive the
     leader's in-memory value — no store round-trip at all);
  2. the local leader then contends for the service-side lease.  Granted →
     it is the fleet-wide leader: it computes, stores through the normal
     admission path, and releases the lease with a ``stored`` bit.  Denied →
     it blocks until the remote leader releases, then simply re-runs its
     produce function: the function's own "is it in the store?" probe now
     finds the leader's artifact and loads it.

The lease provider is anything with the ``lease_acquire``/``lease_release``
surface — a single :class:`~repro.net.client.RemoteBackend`, or a
:class:`~repro.net.sharded.ShardedBackend` that routes the election to the
key's ring primary and falls over along the ring when that shard dies:
waiters whose blocked acquire dies with the shard re-contend and re-elect
on the next live node, so exactly-once stem election survives a shard death
mid-run (the per-round store probe below is what squeezes out the rare
double-compute window a mid-election death opens).

When the remote leader did *not* store (admission gate rejected it, or the
leader crashed — crashed leaders are auto-released by the server), waiters
re-contend for the lease so computes happen one-at-a-time rather than as a
thundering herd; after ``max_rounds`` unproductive waits a caller gives up
coordinating and computes locally — progress is never hostage to the
coordination layer.  The same applies when the lease service itself is
unreachable (every shard down): the flight degrades to an uncoordinated
local compute instead of failing the run.  Unlike the in-process flight, a
remote leader's exception is *not* propagated to followers (exceptions
don't cross the wire); followers recompute and surface their own.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Protocol, runtime_checkable

from ..core.backends import BackendUnavailable
from ..obs import tracing as _tracing
from ..obs.metrics import MetricsRegistry
from ..sched.singleflight import SingleFlight
from .client import LeaseGrant


@runtime_checkable
class LeaseProvider(Protocol):
    """What the flight needs from the coordination layer: per-key leases.

    Satisfied by ``RemoteBackend`` (one server's lease table) and
    ``ShardedBackend`` (ring-primary election with failover).
    """

    def lease_acquire(
        self, key: str, *, wait: bool = True, timeout_s: float = 300.0
    ) -> LeaseGrant: ...

    def lease_release(self, key: str, token: str, *, stored: bool) -> None: ...


class DistributedSingleFlight(SingleFlight):
    """Per-key compute deduplication across threads *and* processes."""

    def __init__(
        self,
        remote: LeaseProvider,
        stored_fn: Callable[[str], bool] | None = None,
        lease_timeout_s: float = 300.0,
        max_rounds: int = 3,
        registry: MetricsRegistry | None = None,
    ) -> None:
        super().__init__(registry=registry)
        self.remote = remote
        # tells the leader whether its compute actually landed in the store
        # (the admission gate may have rejected it); wired to ``store.has``
        self.stored_fn = stored_fn
        self.lease_timeout_s = lease_timeout_s
        self.max_rounds = max_rounds
        self._m_remote_leads = self.metrics.counter(
            "repro_singleflight_remote_leads_total", "flights this process led fleet-wide"
        )
        self._m_remote_waits = self.metrics.counter(
            "repro_singleflight_remote_waits_total",
            "flights coalesced onto another process's compute",
        )
        self._m_uncoordinated = self.metrics.counter(
            "repro_singleflight_uncoordinated_total",
            "flights run without a reachable lease service",
        )
        self._m_lease_wait_s = self.metrics.histogram(
            "repro_singleflight_lease_wait_seconds",
            "time spent blocked on another process's lease",
        )

    @property
    def remote_leads(self) -> int:
        """Deprecated alias of ``repro_singleflight_remote_leads_total``."""
        return int(self._m_remote_leads.value)

    @property
    def remote_waits(self) -> int:
        """Deprecated alias of ``repro_singleflight_remote_waits_total``."""
        return int(self._m_remote_waits.value)

    @property
    def uncoordinated(self) -> int:
        """Deprecated alias of ``repro_singleflight_uncoordinated_total``."""
        return int(self._m_uncoordinated.value)

    def _stored(self, key: str) -> bool:
        if self.stored_fn is None:
            return False
        try:
            return bool(self.stored_fn(key))
        except BackendUnavailable:
            # presence undecidable (replicas down): treat as not stored —
            # worst case is a redundant compute, never a lost artifact
            return False

    def run(
        self,
        key: str,
        fn: Callable[[], Any],
        timeout: float | None = None,
    ) -> tuple[Any, bool]:
        (value, remote_leader), local_leader = super().run(
            key, lambda: self._coordinate(key, fn), timeout
        )
        return value, local_leader and remote_leader

    def _coordinate(self, key: str, fn: Callable[[], Any]) -> tuple[Any, bool]:
        # already stored: no election needed — contending would serialize
        # the fleet's *loads* behind one lease for no benefit
        if self._stored(key):
            return fn(), True
        for round_no in range(self.max_rounds):
            if round_no and self._stored(key):
                # the previous leader stored it but its release got lost with
                # a dying shard (stored bit never reached us): load, don't
                # recompute — this probe is what keeps election exactly-once
                # across a mid-run shard death
                return fn(), False
            sp = _tracing.span("lease.acquire", kind="lease", key=key)
            t0 = time.monotonic()
            try:
                with sp:
                    grant = self.remote.lease_acquire(
                        key, wait=True, timeout_s=self.lease_timeout_s
                    )
                    sp.set(granted=grant.granted)
                    if not grant.granted:
                        # the blocking acquire above *was* the wait on the
                        # fleet leader — surface it under its real name
                        sp.rename("lease.wait")
            except BackendUnavailable:
                # the whole coordination layer is unreachable: compute
                # locally rather than wedging the run on it
                self._m_uncoordinated.inc()
                return fn(), True
            if grant.granted:
                self._m_remote_leads.inc()
                try:
                    value = fn()
                except BaseException:
                    self._release(key, grant.token, stored=False)
                    raise
                self._release(key, grant.token, stored=self._stored(key))
                return value, True
            self._m_remote_waits.inc()
            self._m_waits.inc()
            self._m_lease_wait_s.observe(time.monotonic() - t0)
            if grant.stored:
                # the fleet leader stored it: fn's store probe loads it now
                return fn(), False
            # leader stored nothing (rejected/failed/timed out): contend again
        return fn(), True  # coordination exhausted — compute unilaterally

    def _release(self, key: str, token: str, *, stored: bool) -> None:
        try:
            self.remote.lease_release(key, token, stored=stored)
        except BackendUnavailable:
            # the granting shard died holding the lease: its death already
            # auto-released every lease it held, so waiters are not wedged
            pass
