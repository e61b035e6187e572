"""Read-through blob cache: hot prefixes at local speed, shared pool behind.

``CachingBackend`` wraps any :class:`~repro.core.backends.StorageBackend`
(in practice a :class:`~repro.net.client.RemoteBackend` or a
:class:`~repro.net.sharded.ShardedBackend`) with a bounded, digest-validated
LRU over individual blobs.  The workflow access pattern it exploits is
extremely cache-friendly: a reused prefix is *immutable* — its
content-addressed key never changes meaning — so a blob fetched once can be
served locally forever, and the only invalidation that exists is
whole-artifact eviction, delivered by the server's event stream.

Two pieces of bookkeeping keep that invalidation correct and cheap:

  * an **invalidation generation** per key — the inner fetch on a miss (and
    the inner write on a put) runs *outside* the lock, so an eviction event
    can land in between; inserting the stale bytes afterwards would
    resurrect a dead blob.  Each ``invalidate``/``delete`` bumps the key's
    generation; an insert only lands if the generation it captured before
    going to the network is still current.
  * a **key -> blob-names index** — eviction events arrive one *key* at a
    time, but the LRU is keyed by ``(key, name)``.  The index makes
    ``invalidate`` O(blobs-of-key) instead of a full O(cache) scan per
    event, which matters under a busy fleet-wide eviction stream.

Every cached entry keeps the SHA-256 of its bytes and is re-verified on
hit; a corrupted entry silently falls back to a fresh fetch.  ``exists``/
meta ops are deliberately *not* cached: presence is the one question whose
answer other processes change (stores, evictions), and a stale positive
would make the planner skip a compute it still needs.
"""
from __future__ import annotations

import threading
from collections import OrderedDict

from ..core.backends import StorageBackend
from ..obs.metrics import MetricsRegistry
from .protocol import digest


class CachingBackend(StorageBackend):
    """Bounded LRU blob cache in front of a slower (remote) backend."""

    name = "caching"

    def __init__(
        self,
        inner: StorageBackend,
        capacity_bytes: int = 256 * 1024 * 1024,
        max_entry_fraction: float = 0.5,
        registry: MetricsRegistry | None = None,
    ) -> None:
        if not 0.0 < max_entry_fraction <= 1.0:
            raise ValueError("max_entry_fraction must be in (0, 1]")
        self.inner = inner
        self.capacity_bytes = capacity_bytes
        # one blob may occupy at most this fraction of the cache: a single
        # multi-GB artifact passing through must not evict the entire hot
        # set of small, frequently-reused prefixes to buy one doomed entry
        self.max_entry_bytes = int(capacity_bytes * max_entry_fraction)
        self._lock = threading.Lock()
        self._blobs: OrderedDict[tuple[str, str], tuple[bytes, str]] = OrderedDict()
        self._names: dict[str, set[str]] = {}  # key -> cached blob names
        # invalidation fencing: _gen[key] exists only while an invalidation
        # raced an in-flight fetch of that key; _inflight counts the fetches.
        # Both dicts are bounded by current fetch concurrency, not by the
        # eviction-event volume.
        self._gen: dict[str, int] = {}  # key -> invalidation generation
        self._inflight: dict[str, int] = {}  # key -> fetches on the wire
        self._nbytes = 0
        # counters live on the unified registry; the bare attribute names
        # survive as read-only aliases below
        self.metrics = registry if registry is not None else MetricsRegistry()
        m = self.metrics
        self._m_hits = m.counter("repro_cache_hits_total", "blob reads served locally")
        self._m_misses = m.counter(
            "repro_cache_misses_total", "blob reads that went to the inner backend"
        )
        self._m_validation_failures = m.counter(
            "repro_cache_validation_failures_total",
            "cached entries that failed digest re-verification",
        )
        self._m_stale_dropped = m.counter(
            "repro_cache_stale_inserts_dropped_total",
            "fetches outrun by an invalidation",
        )
        self._m_purge_examined = m.counter(
            "repro_cache_purge_examined_total",
            "entries looked at by invalidations (O() proof)",
        )
        self._m_oversize = m.counter(
            "repro_cache_oversize_rejected_total",
            "blobs too large to be worth caching",
        )
        m.gauge(
            "repro_cache_bytes", "bytes currently held by the LRU"
        ).unlabeled.set_function(lambda: self._nbytes)
        m.gauge(
            "repro_cache_entries", "blobs currently held by the LRU"
        ).unlabeled.set_function(lambda: len(self._blobs))

    # -- deprecated counter aliases ---------------------------------------------
    @property
    def hits(self) -> int:
        """Deprecated alias of ``repro_cache_hits_total``."""
        return int(self._m_hits.value)

    @property
    def misses(self) -> int:
        """Deprecated alias of ``repro_cache_misses_total``."""
        return int(self._m_misses.value)

    @property
    def validation_failures(self) -> int:
        """Deprecated alias of ``repro_cache_validation_failures_total``."""
        return int(self._m_validation_failures.value)

    @property
    def stale_inserts_dropped(self) -> int:
        """Deprecated alias of ``repro_cache_stale_inserts_dropped_total``."""
        return int(self._m_stale_dropped.value)

    @property
    def purge_examined(self) -> int:
        """Deprecated alias of ``repro_cache_purge_examined_total``."""
        return int(self._m_purge_examined.value)

    @property
    def oversize_rejected(self) -> int:
        """Deprecated alias of ``repro_cache_oversize_rejected_total``."""
        return int(self._m_oversize.value)

    # -- cache bookkeeping (callers hold the lock) ---------------------------
    def _insert(self, key: str, name: str, data: bytes, gen: int) -> None:
        if self._gen.get(key, 0) != gen:
            # an eviction event landed while the bytes were in flight:
            # inserting now would resurrect a dead blob
            self._m_stale_dropped.inc()
            return
        if len(data) > self.max_entry_bytes:
            self._m_oversize.inc()
            return
        ck = (key, name)
        prev = self._blobs.pop(ck, None)
        if prev is not None:
            self._nbytes -= len(prev[0])
        if not isinstance(data, bytes):
            # writes may pass a memoryview over a live buffer (KV codec's
            # zero-copy path); cache an immutable snapshot, never an alias
            data = bytes(data)
        self._blobs[ck] = (data, digest(data))
        self._names.setdefault(key, set()).add(name)
        self._nbytes += len(data)
        while self._nbytes > self.capacity_bytes and self._blobs:
            okey, oname = next(iter(self._blobs))
            self._drop_entry(okey, oname)

    def _drop_entry(self, key: str, name: str) -> None:
        """Remove one blob from the LRU + byte accounting + name index —
        the single place the three structures' invariant is maintained.
        Callers hold the lock."""
        entry = self._blobs.pop((key, name), None)
        if entry is not None:
            self._nbytes -= len(entry[0])
        names = self._names.get(key)
        if names is not None:
            names.discard(name)
            if not names:
                del self._names[key]

    def _fetch_begin(self, key: str) -> int:
        """Register an about-to-go-on-the-wire fetch; returns the generation
        an eventual insert must still match.  Callers hold the lock."""
        self._inflight[key] = self._inflight.get(key, 0) + 1
        return self._gen.get(key, 0)

    def _fetch_end(self, key: str, name: str, data: bytes | None, gen: int) -> None:
        """Complete a fetch: insert (if it produced bytes and no invalidation
        outran it) and retire the fence once the last fetch lands."""
        with self._lock:
            if data is not None:
                self._insert(key, name, data, gen)
            n = self._inflight.get(key, 0) - 1
            if n <= 0:
                self._inflight.pop(key, None)
                self._gen.pop(key, None)  # no fetch left that could race it
            else:
                self._inflight[key] = n

    def _purge(self, key: str) -> None:
        """Drop every cached blob of ``key`` via the name index —
        O(blobs-of-key), never a scan of the whole LRU."""
        if key in self._inflight:
            # fence the racing fetch(es): their eventual insert must lose
            self._gen[key] = self._gen.get(key, 0) + 1
        names = self._names.pop(key, None)
        if not names:
            return
        for name in names:
            self._m_purge_examined.inc()
            self._drop_entry(key, name)

    def invalidate(self, key: str) -> None:
        """Drop every cached blob of ``key`` (wired to eviction events) and
        fence out any in-flight fetch of its stale bytes."""
        with self._lock:
            self._purge(key)

    @property
    def cached_bytes(self) -> int:
        with self._lock:
            return self._nbytes

    # -- StorageBackend --------------------------------------------------------
    def write_blob(self, key: str, name: str, data: bytes) -> int:
        with self._lock:
            gen = self._fetch_begin(key)
        ok = False
        try:
            n = self.inner.write_blob(key, name, data)
            ok = True
        finally:
            self._fetch_end(key, name, data if ok else None, gen)
        return n

    def read_blob(self, key: str, name: str) -> bytes:
        with self._lock:
            entry = self._blobs.get((key, name))
            if entry is not None:
                self._blobs.move_to_end((key, name))
        if entry is not None:
            data, want = entry
            # hash OUTSIDE the lock: concurrent hits on large blobs must not
            # serialize behind each other's digest computation
            if digest(data) == want:
                self._m_hits.inc()
                return data
            self._m_validation_failures.inc()
            with self._lock:
                # bit-rot in the cache: drop (if still ours) and re-fetch
                cur = self._blobs.get((key, name))
                if cur is not None and cur[0] is data:
                    self._drop_entry(key, name)
        self._m_misses.inc()
        with self._lock:
            gen = self._fetch_begin(key)
        data = None
        try:
            data = self.inner.read_blob(key, name)
        finally:
            self._fetch_end(key, name, data, gen)
        return data

    def delete(self, key: str) -> None:
        with self._lock:
            self._purge(key)  # fence in-flight fetches BEFORE the delete…
        self.inner.delete(key)
        with self._lock:
            self._purge(key)  # …and drop anything that slipped in since

    def exists(self, key: str) -> bool:
        return self.inner.exists(key)

    def exists_many(self, keys):
        # presence is never cached (see module docstring) — pass the batch
        # through so a deep probe walk stays one round trip
        return self.inner.exists_many(keys)

    def write_meta(self, name: str, text: str) -> None:
        self.inner.write_meta(name, text)

    def read_meta(self, name: str) -> str | None:
        return self.inner.read_meta(name)

    def nbytes(self, key: str) -> int:
        return self.inner.nbytes(key)
