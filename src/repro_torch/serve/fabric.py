"""Mount a :class:`ServeEngine` on a bare storage backend, with no ``Client``
around it.  :meth:`repro_torch.api.Client.serve_engine` is the documented way
to serve on a client's fabric (its snapshots also go to the client's
provenance catalog); this helper keeps the engine phases that predate the
front door.

The engine's prefix KV snapshots become artifacts on ``backend`` (a local
directory, a memory backend, or a store server through ``RemoteBackend``),
encoded by the KV codec, so engines of either package restore each other's
prefills.  With ``remote`` (the ``RemoteBackend`` of a store server), prefill
is a coordinated compute: the server's lease table elects one prefiller of
each shared prefix across processes, followers load its snapshot, and the
server's eviction events prune every engine's records and ``policy.stored``.
With ``cache_bytes`` the snapshots are read through a :class:`CachingBackend`
in front of ``backend``, as the reference's ``Client`` mounts a remote pool,
so repeat restores of a shared prefix stay off the wire.
"""
from __future__ import annotations

from typing import Any

from ..core.backends import StorageBackend
from ..net.cache import CachingBackend
from ..net.flight import DistributedSingleFlight
from ..obs.metrics import MetricsRegistry
from ..sched.singleflight import SingleFlight
from .engine import ServeEngine
from .snapshots import FabricSnapshotStore


def mount_serve_engine(
    backend: StorageBackend,
    cfg: Any,
    params: Any,
    *,
    remote: Any = None,
    cache_bytes: int | None = None,
    snapshot_budget_bytes: int | None = None,
    ledger: Any = None,
    tenant: str = "",
    **engine_kw: Any,
) -> ServeEngine:
    """A ``ServeEngine`` whose snapshots live on ``backend``.

    ``remote`` (a ``RemoteBackend``, usually ``backend`` itself) adds the
    fleet-wide election and the eviction-event stream; without it a
    process-local ``SingleFlight`` still coalesces concurrent identical
    prefixes.  ``cache_bytes`` puts a ``CachingBackend`` of that capacity
    between the snapshot store and ``backend``; elections and eviction
    events still go to ``remote``, and an eviction event purges the cache's
    copy.  ``snapshot_budget_bytes`` is the gain-loss budget the store
    enforces on the backend.  ``ledger`` (a
    :class:`~repro_torch.sched.stats.TenantLedger`) bills the stored snapshot
    bytes to ``tenant``.  The remaining ``engine_kw`` (``max_len``,
    ``chunk``, ``policy``, ``registry``, ``dataset_id``, ``device``, ...)
    pass through to ``ServeEngine``.
    """
    metrics = MetricsRegistry()  # one home for the store's, flight's and engine's series
    if cache_bytes is not None:
        backend = CachingBackend(backend, capacity_bytes=cache_bytes, registry=metrics)
    snapshots = FabricSnapshotStore(
        backend,
        capacity_bytes=snapshot_budget_bytes,
        registry=metrics,
        ledger=ledger,
        tenant=tenant,
        events_from=remote,
    )
    if remote is not None:
        flight: SingleFlight = DistributedSingleFlight(
            remote, stored_fn=snapshots.contains, registry=metrics
        )
    else:
        flight = SingleFlight(registry=metrics)
    return ServeEngine(
        cfg=cfg,
        params=params,
        snapshots=snapshots,
        flight=flight,
        metrics=metrics,
        **engine_kw,
    )
