"""The ``SnapshotStore`` seam: where a serving engine's KV snapshots live.

The port's copy of the reference's ``serve/snapshots.py``.  It carries the
interface and :class:`MemorySnapshotStore`, the engine-private host-RAM tier
with a gain-loss budget; ``FabricSnapshotStore`` (snapshots shared through a
storage backend and the KV codec) waits for a later slice.

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

from ..core.eviction import EvictionContext, EvictionManager
from ..core.records import ArtifactRecord
from ..core.workflow import PrefixKey
from ..obs.metrics import MetricsRegistry

__all__ = [
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
