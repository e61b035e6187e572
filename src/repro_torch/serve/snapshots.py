"""The ``SnapshotStore`` seam: where a serving engine's KV snapshots live.

The port's copy of the reference's ``serve/snapshots.py``.  Two
implementations stand behind one interface:

* :class:`MemorySnapshotStore` — the engine-private host-RAM tier with a
  gain-loss budget;
* :class:`FabricSnapshotStore` — snapshots as artifacts on any
  :class:`~repro_torch.core.backends.StorageBackend` (a local directory, or a
  store server through ``RemoteBackend``), encoded by the KV codec
  (:mod:`repro_torch.core.kvcodec`), whose blobs and manifests are the
  reference's byte for byte: an engine of either package restores the
  other's snapshots.  Every way a snapshot can disappear (local eviction,
  another process's eviction on the event stream, an absence found by a
  probe or a load) funnels through one ``_forget`` path that drops the
  record, fires the evict listeners (the engine's ``policy.stored``) and
  credits the tenant ledger.

A snapshot is a dict of tensors.  The store keeps host copies that share no
memory with the device cache the engine goes on writing in place, and a
restore hands back those host tensors for the engine to copy to its device.
"""
from __future__ import annotations

import threading
import time
from abc import ABC, abstractmethod
from dataclasses import dataclass
from typing import Any, Callable, Iterable

import torch

from ..core.backends import BackendUnavailable, StorageBackend
from ..core.eviction import EvictionContext, EvictionManager
from ..core.kvcodec import load_kv, save_kv
from ..core.records import ArtifactRecord
from ..core.workflow import PrefixKey
from ..obs.metrics import MetricsRegistry

__all__ = [
    "FabricSnapshotStore",
    "LoadedSnapshot",
    "MemorySnapshotStore",
    "SnapshotStore",
]


@dataclass
class LoadedSnapshot:
    """One restored snapshot: host-side cache pytree + its provenance."""

    cache: Any  # host tensor dict — caller copies it to its device
    length: int  # valid cache positions (prefix length in tokens)
    prefill_s: float  # measured seconds a fresh prefill of this prefix costs
    load_s: float  # measured seconds this load took


def _host_tree(cache: dict[str, torch.Tensor]) -> tuple[dict[str, torch.Tensor], int]:
    # copy=True: on the CPU ``.to("cpu")`` would alias the live cache, which
    # the engine keeps writing in place
    host = {k: a.detach().to("cpu", copy=True) for k, a in cache.items()}
    nbytes = sum(a.numel() * a.element_size() for a in host.values())
    return host, nbytes


class SnapshotStore(ABC):
    """Where prefix KV snapshots live, and who learns when they die.

    ``save``/``load`` move whole snapshots; ``presence_many`` answers the
    deep-prefix probe in one batched round trip (tri-state: ``None`` =
    unreachable, never treated as absent).  Evict listeners fire for *every*
    removal path — the engine keeps ``policy.stored`` consistent through
    them, exactly like the workflow store's listener contract.
    """

    def __init__(self, registry: MetricsRegistry | None = None) -> None:
        self.metrics = registry if registry is not None else MetricsRegistry()
        m = self.metrics
        self._m_saves = m.counter(
            "repro_serve_snapshot_saves_total", "KV snapshots persisted"
        )
        self._m_loads = m.counter(
            "repro_serve_snapshot_loads_total", "KV snapshots restored"
        )
        self._m_drops = m.counter(
            "repro_serve_snapshot_evictions_total",
            "KV snapshots dropped, by cause",
            labels=("source",),
        )
        self._m_save_s = m.histogram(
            "repro_serve_snapshot_save_seconds", "seconds to persist one snapshot"
        )
        self._m_load_s = m.histogram(
            "repro_serve_snapshot_load_seconds", "seconds to restore one snapshot"
        )
        m.gauge(
            "repro_serve_snapshots", "live KV snapshots known here"
        ).unlabeled.set_function(lambda: float(self.n_snapshots))
        m.gauge(
            "repro_serve_snapshot_stored_bytes", "bytes of live KV snapshots"
        ).unlabeled.set_function(lambda: float(self.snapshot_bytes()))
        self._listeners: list[Callable[[str], None]] = []

    # -- listener plumbing (shared) -----------------------------------------
    def add_evict_listener(self, fn: Callable[[str], None]) -> None:
        """``fn(key)`` fires whenever ``key`` stops being loadable here —
        local eviction, fleet eviction event, or discovered phantom."""
        self._listeners.append(fn)

    def _fire(self, key: str) -> None:
        for fn in list(self._listeners):
            try:
                fn(key)
            except Exception:  # noqa: BLE001 - listeners must not kill serving
                pass

    # -- contract ------------------------------------------------------------
    @abstractmethod
    def save(
        self,
        key: str,
        cache: Any,
        length: int,
        *,
        prefill_s: float,
        prefix: PrefixKey | None = None,
    ) -> bool:
        """Persist one snapshot; False when the budget (or fabric) rejects it."""

    @abstractmethod
    def load(self, key: str) -> LoadedSnapshot | None:
        """Restore ``key``, or None when it is gone/unreachable (a discovered
        authoritative absence also fires the evict listeners)."""

    @abstractmethod
    def presence_many(self, keys: Iterable[str]) -> dict[str, bool | None]:
        """Batched presence (one round trip on remote fabrics); authoritative
        absences of locally-known snapshots fire the evict listeners."""

    @abstractmethod
    def drop(self, key: str) -> None:
        """Explicitly evict ``key`` (no-op when unknown)."""

    @abstractmethod
    def record(self, key: str) -> ArtifactRecord | None:
        """Bookkeeping record for ``key`` (None when unknown here)."""

    @property
    @abstractmethod
    def n_snapshots(self) -> int: ...

    @property
    @abstractmethod
    def n_evictions(self) -> int: ...

    @abstractmethod
    def snapshot_bytes(self) -> int: ...

    def contains(self, key: str) -> bool:
        """Presence of one key; unreachable counts as False (a redundant
        prefill is safe, a skipped one is not) — the single-flight
        ``stored_fn`` probe uses this."""
        return bool(self.presence_many([key]).get(key))

    def close(self) -> None:  # pragma: no cover - default teardown is empty
        pass


class MemorySnapshotStore(SnapshotStore):
    """The legacy engine-private tier, extracted verbatim behind the seam:
    host-RAM snapshot dict + gain-loss budget.  ``load`` hands back the same
    host arrays it stored (no codec round trip — this tier trades
    shareability for zero serialization cost)."""

    def __init__(
        self,
        capacity_bytes: int | None = None,
        eviction: str = "gain_loss",
        *,
        registry: MetricsRegistry | None = None,
        load_bps: float = 4e9,
    ) -> None:
        super().__init__(registry)
        self._snaps: dict[str, tuple[Any, int]] = {}  # key -> (host cache, len)
        self._records: dict[str, ArtifactRecord] = {}
        self._evictor = EvictionManager(capacity_bytes, eviction)
        self._ctx = EvictionContext(load_bps=load_bps)
        self._lock = threading.Lock()

    def save(
        self,
        key: str,
        cache: Any,
        length: int,
        *,
        prefill_s: float,
        prefix: PrefixKey | None = None,
    ) -> bool:
        host, nbytes = _host_tree(cache)
        if not self._evictor.admits(nbytes):
            return False
        with self._lock:
            self._snaps[key] = (host, length)
            self._records[key] = ArtifactRecord(
                key, nbytes, nbytes, save_s=0.0, compute_s=prefill_s
            )
            victims = self._evictor.select_victims(
                self._records,
                sum(r.nbytes_disk for r in self._records.values()),
                ctx=self._ctx,
                incoming=key,
            )
            for victim in victims:
                self._snaps.pop(victim, None)
                self._records.pop(victim, None)
        for victim in victims:
            self._m_drops.labels(source="evict").inc()
            self._fire(victim)
        if key in victims:
            return False
        self._m_saves.inc()
        self._m_save_s.observe(0.0)
        return True

    def load(self, key: str) -> LoadedSnapshot | None:
        t0 = time.perf_counter()
        with self._lock:
            entry = self._snaps.get(key)
            rec = self._records.get(key)
            if entry is None:
                return None
            if rec is not None:
                rec.n_loads += 1
                rec.last_used_at = time.time()
        self._m_loads.inc()
        load_s = time.perf_counter() - t0
        self._m_load_s.observe(load_s)
        return LoadedSnapshot(
            cache=entry[0],
            length=entry[1],
            prefill_s=float(rec.compute_s or 0.0) if rec is not None else 0.0,
            load_s=load_s,
        )

    def presence_many(self, keys: Iterable[str]) -> dict[str, bool | None]:
        with self._lock:
            return {k: k in self._snaps for k in keys}

    def drop(self, key: str) -> None:
        with self._lock:
            known = self._snaps.pop(key, None) is not None
            self._records.pop(key, None)
        if known:
            self._m_drops.labels(source="drop").inc()
            self._fire(key)

    def record(self, key: str) -> ArtifactRecord | None:
        return self._records.get(key)

    @property
    def n_snapshots(self) -> int:
        return len(self._snaps)

    @property
    def n_evictions(self) -> int:
        return self._evictor.n_evictions

    def snapshot_bytes(self) -> int:
        with self._lock:
            return sum(r.nbytes_disk for r in self._records.values())


class FabricSnapshotStore(SnapshotStore):
    """KV snapshots as shared artifacts on a :class:`StorageBackend`.

    Parameters
    ----------
    backend: where bytes live — ``LocalFSBackend``, ``MemoryBackend``, or a
        ``RemoteBackend`` (``mount_serve_engine`` builds one for an engine).
    capacity_bytes: gain-loss budget *this store enforces* on the fabric; an
        eviction here deletes the artifact fleet-wide (same semantics as the
        workflow store's capacity over a shared backend).  ``None`` = no
        local enforcement.
    codec: per-leaf payload codec name from the codec registry (default
        ``"none"`` — the zero-copy raw path).
    catalog: snapshots publish ``CatalogRecord``s at the admission seam and
        discard them on any removal, so ``find``/``--dedup`` see serving
        artifacts exactly like workflow artifacts.
    ledger / tenant: optional ``TenantLedger`` billing — ``charge_stored``
        on admission, ``credit_evicted`` on every removal path.
    events_from: a backend with ``add_event_listener`` (RemoteBackend /
        ShardedBackend): fleet-wide eviction events prune local records so
        no engine keeps planning around a snapshot another process evicted.
    """

    def __init__(
        self,
        backend: StorageBackend,
        *,
        capacity_bytes: int | None = None,
        eviction: str = "gain_loss",
        codec: str | None = "none",
        registry: MetricsRegistry | None = None,
        catalog: Any = None,
        ledger: Any = None,
        tenant: str = "",
        events_from: Any = None,
        load_bps: float = 4e9,
    ) -> None:
        super().__init__(registry)
        self.backend = backend
        self.codec = codec
        self.catalog = catalog
        self.ledger = ledger
        self.tenant = tenant
        self._records: dict[str, ArtifactRecord] = {}
        self._prefixes: dict[str, PrefixKey] = {}  # for catalog re-publish
        self._evictor = EvictionManager(capacity_bytes, eviction)
        self._ctx = EvictionContext(load_bps=load_bps)
        self._lock = threading.Lock()
        if events_from is not None:
            events_from.add_event_listener(self._on_fabric_event)

    # -- removal funnel ------------------------------------------------------
    def _forget(self, key: str, source: str) -> None:
        """The one path out: record + catalog + ledger + listeners converge."""
        with self._lock:
            known = self._records.pop(key, None) is not None
            self._prefixes.pop(key, None)
        if not known:
            return
        if self.catalog is not None:
            self.catalog.discard(key)
        if self.ledger is not None:
            self.ledger.credit_evicted(key)
        self._m_drops.labels(source=source).inc()
        self._fire(key)

    def _on_fabric_event(self, event: str, key: str) -> None:
        if event == "evicted":
            self._forget(key, source="event")

    def _evict(self, key: str) -> None:
        try:
            self.backend.delete(key)
        except BackendUnavailable:
            # can't reach the fabric: keep the record — the artifact still
            # exists, and pretending otherwise would leak the ledger bytes
            return
        invalidate = getattr(self.backend, "invalidate", None)
        if callable(invalidate):
            invalidate(key)
        self._forget(key, source="evict")

    # -- contract ------------------------------------------------------------
    def save(
        self,
        key: str,
        cache: Any,
        length: int,
        *,
        prefill_s: float,
        prefix: PrefixKey | None = None,
    ) -> bool:
        host, nbytes = _host_tree(cache)
        if not self._evictor.admits(nbytes):
            return False
        t0 = time.perf_counter()
        try:
            info = save_kv(
                self.backend,
                key,
                host,
                length,
                codec=self.codec,
                prefill_s=prefill_s,
            )
        except BackendUnavailable:
            return False
        save_s = time.perf_counter() - t0
        rec = ArtifactRecord(
            key, info.nbytes_raw, info.nbytes_disk, save_s=save_s, compute_s=prefill_s
        )
        with self._lock:
            self._records[key] = rec
            if prefix is not None:
                self._prefixes[key] = prefix
            total = sum(r.nbytes_disk for r in self._records.values())
            victims = self._evictor.select_victims(
                self._records, total, ctx=self._ctx, incoming=key
            )
        if self.catalog is not None and prefix is not None:
            self.catalog.publish(prefix, key, rec)
        if self.ledger is not None:
            self.ledger.charge_stored(self.tenant, key, info.nbytes_disk)
        for victim in victims:
            self._evict(victim)
        if key in victims:
            return False
        self._m_saves.inc()
        self._m_save_s.observe(save_s)
        return True

    def load(self, key: str) -> LoadedSnapshot | None:
        t0 = time.perf_counter()
        try:
            tree, length, info = load_kv(self.backend, key)
        except (KeyError, FileNotFoundError):
            # authoritative absence: evicted elsewhere before the event (or
            # any event at all) reached us — prune so nothing phantom-plans
            self._forget(key, source="phantom")
            return None
        except BackendUnavailable:
            return None  # unreachable is not absent: keep records intact
        load_s = time.perf_counter() - t0
        now = time.time()
        with self._lock:
            rec = self._records.get(key)
            if rec is None:
                # cross-process adoption: another engine stored it; the
                # manifest carries the measured prefill cost so gain-loss
                # prices it here exactly as it did there
                rec = ArtifactRecord(
                    key,
                    info.nbytes_raw,
                    info.nbytes_disk,
                    save_s=0.0,
                    compute_s=info.prefill_s,
                    created_at=info.created_at or now,
                )
                self._records[key] = rec
            rec.n_loads += 1
            rec.last_used_at = now
            rec.load_s = load_s
        if self.catalog is not None:
            self.catalog.touch(key, rec)
        self._m_loads.inc()
        self._m_load_s.observe(load_s)
        return LoadedSnapshot(
            cache=tree,
            length=length,
            prefill_s=float(info.prefill_s or rec.compute_s or 0.0),
            load_s=load_s,
        )

    def presence_many(self, keys: Iterable[str]) -> dict[str, bool | None]:
        keys = list(keys)
        try:
            result = self.backend.exists_many(keys)
        except BackendUnavailable:
            return {k: None for k in keys}
        for k, present in result.items():
            if present is False:
                self._forget(k, source="phantom")
        return result

    def drop(self, key: str) -> None:
        self._evict(key)

    def record(self, key: str) -> ArtifactRecord | None:
        return self._records.get(key)

    @property
    def n_snapshots(self) -> int:
        return len(self._records)

    @property
    def n_evictions(self) -> int:
        return self._evictor.n_evictions

    def snapshot_bytes(self) -> int:
        with self._lock:
            return sum(r.nbytes_disk for r in self._records.values())
