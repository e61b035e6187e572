"""Shard-aware, content-addressed intermediate-data store.

The thesis stored intermediate states in HDFS via Python pickle (Ch. 3.4).
Here each artifact is a pytree of arrays; every *addressable shard* of every
leaf is written as an independent compressed blob, so on a multi-host pod each
host persists exactly its local shards (the HDFS-write analogue) and restores
them without gathering.  A JSON manifest records the global shapes/dtypes/
shard indices plus measured save/load timings — the inputs to the thesis'
``T1 > T2`` admission test (Eq. 4.9).

The store splits three concerns across three pluggable layers:

  * serialization — pytree flattening, manifests, codec compression (here);
  * persistence   — a :class:`~repro.core.backends.StorageBackend`
    (filesystem, memory, or tiered hot/cold);
  * retention     — an optional :class:`~repro.core.eviction.EvictionManager`
    that keeps ``total_disk_bytes`` under ``capacity_bytes`` by gain-loss-
    ratio (or LRU) eviction, notifying listeners (the executor's policy
    bookkeeping) of every evicted key.

The port's copy (``repro_torch.core.store``) differs only at its tensor
seam: values are nested dicts, lists and tuples of tensors and scalars,
flattened by the port's own code (dicts in sorted-key order, as
``jax.tree_util`` flattens them) into the same ``manifest.json`` and blob
layout; each leaf goes to the host with ``.detach().cpu()``; bf16 leaves are
written as the bytes of a 16-bit view under the dtype name ``"bfloat16"`` and
read back without numpy's bf16 type (no ``ml_dtypes``); ``get`` returns
tensors on the device the caller names.  One card has no sharded leaves, and
``skeleton.pkl`` holds the port's own skeleton, not a JAX treedef.
"""
from __future__ import annotations

import json
import pickle
import threading
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable, Sequence

import numpy as np
import torch

from ..obs import tracing as _tracing
from ..obs.metrics import MetricsRegistry
from ..tree import leaves as tree_leaves
from ..tree import tree_map, unflatten
from .backends import BackendUnavailable, LocalFSBackend, StorageBackend
from .codecs import Codec, resolve_codec
from .eviction import EvictionContext, EvictionManager
from .records import ArtifactRecord

_LEAF = "__repro_leaf__"

# dtype names as the manifest records them (numpy's names) <-> torch dtypes
_TORCH_DTYPES = {
    "float64": torch.float64, "float32": torch.float32, "float16": torch.float16,
    "bfloat16": torch.bfloat16, "int64": torch.int64, "int32": torch.int32,
    "int16": torch.int16, "int8": torch.int8, "uint8": torch.uint8, "bool": torch.bool,
}
_DTYPE_NAMES = {v: k for k, v in _TORCH_DTYPES.items()}


def _host_leaf(leaf: Any) -> torch.Tensor:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().contiguous()
    return torch.from_numpy(np.array(leaf))  # Python or numpy scalars/arrays


def _leaf_bytes(t: torch.Tensor) -> bytes:
    if t.dtype == torch.bfloat16:  # numpy has no bf16 type without ml_dtypes
        t = t.view(torch.int16)
    return t.numpy().tobytes()


@dataclass
class PutResult:
    key: str
    nbytes_raw: int
    nbytes_disk: int
    seconds: float
    deduped: bool = False
    admitted: bool = True  # False: artifact exceeded the whole budget
    evicted: tuple[str, ...] = ()  # keys evicted to make room


class IntermediateStore:
    """Content-addressed artifact store with per-shard blobs.

    Parameters
    ----------
    root: directory for the default :class:`LocalFSBackend`; ignored when an
        explicit ``backend`` is given.
    compression_level: level for the selected codec (zstd/zlib).
    backend: storage backend; defaults to ``LocalFSBackend(root)``.
    codec: codec name (``"zstd"``/``"zlib"``/``"none"``) or ``Codec``;
        ``None`` picks the best available (zstd if installed, else zlib).
    capacity_bytes: optional storage budget; when set, every ``put`` evicts
        lowest-value artifacts (per ``eviction``) until the store fits.
    eviction: ``"gain_loss"`` (default) or ``"lru"``, or an
        :class:`EvictionPolicy` instance.
    index_flush_every: persist ``index.json`` after at most this many index
        mutations (puts/evicts/hit-stat updates) ...
    index_flush_interval_s: ... or when the last flush is older than this,
        whichever comes first.  ``index.json`` is a crash-safe *cache* of
        stats, not the source of truth — artifact existence is always
        re-verified against the backend, so a crash between flushes loses
        at most some hit statistics, never correctness.
    """

    def __init__(
        self,
        root: str | Path | None = None,
        compression_level: int = 3,
        *,
        backend: StorageBackend | None = None,
        codec: str | Codec | None = None,
        capacity_bytes: int | None = None,
        eviction: str | Any = "gain_loss",
        index_flush_every: int = 64,
        index_flush_interval_s: float = 1.0,
        registry: MetricsRegistry | None = None,
    ) -> None:
        if backend is None:
            if root is None:
                raise ValueError("pass either root or backend")
            backend = LocalFSBackend(root)
        self.backend = backend
        self.codec = resolve_codec(codec, level=compression_level)
        self.evictor = EvictionManager(capacity_bytes, eviction)
        self.records: dict[str, ArtifactRecord] = {}
        self._evict_listeners: list[Callable[[str], None]] = []
        self.index_flush_every = max(1, index_flush_every)
        self.index_flush_interval_s = index_flush_interval_s
        self._dirty = False
        self._mutations_since_flush = 0
        self._last_flush = time.monotonic()
        self._shared_index_cache: tuple[float, bytes | str | None, dict[str, Any]] | None = None
        # one reentrant lock serializes index/manifest mutation so concurrent
        # scheduler workers can't corrupt ``records`` or interleave partial
        # writes of ``index.json`` (evict listeners run while it is held —
        # they must not call back into the store or take the policy lock)
        self._lock = threading.RLock()
        self.metrics = registry if registry is not None else MetricsRegistry()
        m = self.metrics
        self._m_puts = m.counter("repro_store_puts_total", "artifacts persisted by the store")
        self._m_gets = m.counter("repro_store_gets_total", "artifact loads served by the store")
        self._m_put_seconds = m.histogram("repro_store_put_seconds", "store put latency")
        self._m_get_seconds = m.histogram("repro_store_get_seconds", "store get latency")
        self._m_evictions = m.counter(
            "repro_store_evictions_total", "artifacts deleted by budget eviction"
        )
        self._m_evicted_bytes = m.counter(
            "repro_store_evicted_bytes_total", "disk bytes reclaimed by eviction"
        )
        self._m_reuse_hits = m.counter(
            "repro_reuse_hits_total", "artifact loads that replaced a recompute"
        )
        self._m_saved = m.counter(
            "repro_reuse_seconds_saved_total",
            "estimated compute seconds avoided by reuse (paper Ch. 4 time gain)",
        )
        m.gauge(
            "repro_store_disk_bytes", "current disk footprint of stored artifacts"
        ).unlabeled.set_function(lambda: self.total_disk_bytes)
        m.gauge(
            "repro_store_artifacts", "artifacts currently recorded"
        ).unlabeled.set_function(lambda: len(self.records))
        self._load_index()

    @property
    def capacity_bytes(self) -> int | None:
        return self.evictor.capacity_bytes

    # -- index persistence -------------------------------------------------
    def _load_index(self) -> None:
        raw = self.backend.read_meta("index.json")
        if raw:
            for k, v in json.loads(raw).items():
                self.records[k] = ArtifactRecord(**v)

    def _flush_index(self) -> None:
        self.backend.write_meta(
            "index.json", json.dumps({k: vars(v) for k, v in self.records.items()})
        )
        self._dirty = False
        self._mutations_since_flush = 0
        self._last_flush = time.monotonic()

    def _mark_dirty(self) -> None:
        """Record an index mutation; flush on a count/age threshold rather
        than per mutation (a store with n artifacts would otherwise rewrite
        the O(n) index n times — O(n^2) churn).  Callers hold ``_lock``."""
        self._dirty = True
        self._mutations_since_flush += 1
        if (
            self._mutations_since_flush >= self.index_flush_every
            or time.monotonic() - self._last_flush >= self.index_flush_interval_s
        ):
            self._flush_index()

    def flush(self) -> None:
        """Persist the index now if it has unflushed mutations."""
        with self._lock:
            if self._dirty:
                self._flush_index()

    def close(self) -> None:
        self.flush()

    def __enter__(self) -> "IntermediateStore":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()

    def __del__(self) -> None:  # best-effort: never raise during teardown
        try:
            self.flush()
        except Exception:  # noqa: BLE001
            pass

    # -- helpers -------------------------------------------------------------
    def has(self, key: str) -> bool:
        """True iff ``key`` is loadable right now (collapses ``unreachable``
        to False — use :meth:`has_state` where the difference matters)."""
        return self.has_state(key) == "present"

    def has_state(self, key: str) -> str:
        """``"present"`` | ``"absent"`` | ``"unreachable"``.

        ``absent`` is authoritative (every replica was reachable and the
        artifact is gone — callers may prune bookkeeping); ``unreachable``
        means the pool, or every replica of this key in a sharded pool,
        cannot be reached: *not reusable right now*, but NOT gone — neither
        the record nor any policy bookkeeping should be dropped, and
        accounting converges when the pool returns.
        """
        with self._lock:
            try:
                alive = self.backend.exists(key)
            except BackendUnavailable:
                return "unreachable"
            return self._classify_presence(key, alive)

    def has_state_many(self, keys: "Sequence[str]") -> dict[str, str]:
        """Batched :meth:`has_state`: one backend round trip for any number
        of keys (``exists_many`` coalesces into a single ``batch`` request on
        a remote pool; a sharded pool fans it out once per involved shard).
        Same per-key answers AND same side effects — phantom records are
        pruned, sibling artifacts adopted — so a deep reuse-probe walk costs
        O(1) round trips instead of O(depth)."""
        keys = list(dict.fromkeys(keys))
        if not keys:
            return {}
        with self._lock:
            try:
                presence = self.backend.exists_many(keys)
            except BackendUnavailable:
                return {k: "unreachable" for k in keys}
            out: dict[str, str] = {}
            for k in keys:
                alive = presence.get(k)
                if alive is None:
                    out[k] = "unreachable"
                else:
                    out[k] = self._classify_presence(k, bool(alive))
            return out

    def _classify_presence(self, key: str, alive: bool) -> str:
        """Map one key's backend-reported presence to a ``has_state`` answer,
        applying the bookkeeping side effects.  Callers hold ``_lock``."""
        if key in self.records:
            if alive:
                return "present"
            # phantom record: the artifact vanished without us hearing
            # (evicted fleet-wide before we connected, crashed writer,
            # stale shared index).  Prune it so budget accounting never
            # counts bytes that are not there, and tell listeners so
            # policy bookkeeping converges like any other eviction.
            del self.records[key]
            self._dirty = True
            self._mutations_since_flush += 1
            for fn in self._evict_listeners:
                fn(key)
            return "absent"
        # a sibling process sharing this backend (remote store) may have
        # persisted the artifact after our index snapshot: adopt it
        if alive:
            self._adopt_record(key)
            return "present"
        return "absent"

    def _shared_index(self) -> dict[str, Any]:
        """The pool's ``index.json``, parsed, cached for one flush interval —
        adopting k sibling artifacts must not cost k full-index transfers.
        When the TTL lapses but the raw bytes come back unchanged, the cached
        parse is reused: deep-chain probes against a quiet pool pay a transfer
        but never an O(artifacts) JSON decode.  Callers hold ``_lock``."""
        now = time.monotonic()
        cached = self._shared_index_cache
        if cached is not None and now - cached[0] < max(self.index_flush_interval_s, 1.0):
            return cached[2]
        try:
            raw = self.backend.read_meta("index.json")
        except BackendUnavailable:
            raw = None  # stats cache unreachable: synthesize records instead
        if cached is not None and raw == cached[1]:
            self._shared_index_cache = (now, cached[1], cached[2])
            return cached[2]
        parsed: dict[str, Any] = {}
        if raw:
            try:
                parsed = json.loads(raw)
            except json.JSONDecodeError:
                parsed = {}
        self._shared_index_cache = (now, raw, parsed)
        return parsed

    def _adopt_record(self, key: str) -> None:
        """Create a local record for an artifact another process stored.

        Prefer the shared ``index.json`` entry (it carries real stats); when
        the writer has not flushed yet (or our cached view predates it),
        synthesize a minimal record from the backend's byte count.  Callers
        hold ``_lock``."""
        entry = self._shared_index().get(key)
        if entry:
            self.records[key] = ArtifactRecord(**entry)
            return
        try:
            nb = int(self.backend.nbytes(key))
        except (NotImplementedError, BackendUnavailable):
            nb = 0
        self.records[key] = ArtifactRecord(key, nbytes_raw=nb, nbytes_disk=nb, save_s=0.0)

    def _blob_name(self, stem: str) -> str:
        return f"{stem}.npy{self.codec.suffix}"

    def _write_blob(self, key: str, name: str, t: torch.Tensor) -> int:
        # raw bytes + manifest-recorded dtype/shape: survives bfloat16, which
        # the npy format would degrade to void types
        blob = self.codec.compress(_leaf_bytes(t))
        return self.backend.write_blob(key, name, blob)

    def _read_blob(
        self, key: str, name: str, codec: Codec, dtype: str, shape: list[int]
    ) -> torch.Tensor:
        raw = codec.decompress(self.backend.read_blob(key, name))
        if dtype not in _TORCH_DTYPES:
            raise TypeError(f"artifact leaf {name}: dtype {dtype!r} is not supported")
        tdt = _TORCH_DTYPES[dtype]
        if not raw:
            return torch.empty(shape, dtype=tdt)
        if tdt == torch.bfloat16:
            return torch.frombuffer(bytearray(raw), dtype=torch.int16).view(tdt).reshape(shape)
        return torch.frombuffer(bytearray(raw), dtype=tdt).reshape(shape)

    # -- eviction ------------------------------------------------------------
    def add_evict_listener(self, fn: Callable[[str], None]) -> None:
        """``fn(key)`` is called for every artifact the budget evicts."""
        if fn not in self._evict_listeners:
            self._evict_listeners.append(fn)

    def remove_evict_listener(self, fn: Callable[[str], None]) -> None:
        """Unregister a listener (e.g. when an executor is discarded but the
        store lives on)."""
        if fn in self._evict_listeners:
            self._evict_listeners.remove(fn)

    def evict(self, key: str) -> None:
        """Drop an artifact and notify listeners (policy bookkeeping)."""
        with self._lock:
            self._evict_batch([key])
            self._mark_dirty()

    def on_external_evict(self, key: str) -> None:
        """A sibling process evicted ``key`` at the shared backend: drop the
        local record and notify listeners — the backend delete already
        happened remotely.  Wired to the remote store's eviction-event
        stream so every client's ``policy.stored`` view converges.

        Runs on the backend's event thread, so it only *marks* the index
        dirty (no ``_mark_dirty`` threshold check): an inline flush would be
        a synchronous network write back into the backend from its own
        event loop — the next regular mutation or ``flush()`` persists it.
        """
        with self._lock:
            if key in self.records:
                del self.records[key]
                self._dirty = True
                self._mutations_since_flush += 1
            for fn in self._evict_listeners:
                fn(key)

    def _evict_batch(self, keys: list[str]) -> None:
        """Drop artifacts + notify listeners without flushing per victim;
        callers flush the index once afterwards."""
        sp = _tracing.span("store.evict", kind="store", n=len(keys)) if keys else None
        for key in keys:
            rec = self.records.get(key)
            if rec is not None:
                self.backend.delete(key)
                del self.records[key]
                self._m_evictions.inc()
                self._m_evicted_bytes.inc(rec.nbytes_disk)
            for fn in self._evict_listeners:
                fn(key)
        if sp is not None:
            sp.end()

    def _enforce_budget(self, incoming: str) -> tuple[str, ...]:
        victims = self.evictor.select_victims(
            self.records,
            self.total_disk_bytes,
            ctx=EvictionContext(load_bps=self.load_throughput()),
            incoming=incoming,
        )
        self._evict_batch(victims)
        return tuple(victims)

    # -- public API ----------------------------------------------------------
    def put(
        self, key: str, value: Any, *, compute_seconds: float | None = None
    ) -> PutResult:
        """Persist a pytree under ``key``.

        ``compute_seconds`` is the producer's measured cost of recomputing the
        value (the executor passes the prefix's module seconds) — the *gain*
        numerator of the eviction criterion.
        """
        with _tracing.span("store.put", kind="store", key=key) as sp:
            with self._lock:
                res = self._put_locked(key, value, compute_seconds)
            sp.set(nbytes=res.nbytes_disk, deduped=res.deduped, admitted=res.admitted)
        self._m_puts.inc()
        self._m_put_seconds.observe(res.seconds)
        return res

    def _put_locked(
        self, key: str, value: Any, compute_seconds: float | None
    ) -> PutResult:
        if self.has(key):
            rec = self.records[key]
            if compute_seconds is not None:
                rec.compute_s = compute_seconds
            return PutResult(key, rec.nbytes_raw, rec.nbytes_disk, 0.0, deduped=True)
        t0 = time.perf_counter()

        # the skeleton: the value's nesting with _LEAF in place of each leaf
        leaves = tree_leaves(value)
        skeleton = tree_map(lambda _: _LEAF, value)
        # pre-write admission: an artifact whose RAW size already exceeds the
        # whole budget is rejected before any bytes are compressed or written
        # (compression below 1x would not change the verdict in practice)
        est_raw = sum(
            leaf.numel() * leaf.element_size() if isinstance(leaf, torch.Tensor)
            else int(getattr(leaf, "nbytes", 0) or 0)
            for leaf in leaves
        )
        if not self.evictor.admits(est_raw) and self.codec.name == "none":
            return PutResult(key, est_raw, est_raw, 0.0, admitted=False)
        if (
            self.evictor.capacity_bytes is not None
            and est_raw > 4 * self.evictor.capacity_bytes
        ):
            # even generous 4x compression could not fit it; don't write 100GB
            # into a 1GB-budget store just to find out
            return PutResult(key, est_raw, est_raw, 0.0, admitted=False)
        manifest: dict[str, Any] = {"key": key, "codec": self.codec.name, "leaves": []}
        nbytes_raw = 0
        nbytes_disk = 0
        for i, leaf in enumerate(leaves):
            entry: dict[str, Any] = {"index": i}
            t = _host_leaf(leaf)
            if t.dtype not in _DTYPE_NAMES:
                raise TypeError(f"artifact {key!r} leaf {i}: dtype {t.dtype} is not supported")
            entry["kind"] = "dense"
            entry["shape"] = list(t.shape)
            entry["dtype"] = _DTYPE_NAMES[t.dtype]
            name = self._blob_name(f"leaf{i}")
            nbytes_disk += self._write_blob(key, name, t)
            nbytes_raw += t.numel() * t.element_size()
            entry["file"] = name
            manifest["leaves"].append(entry)

        if not self.evictor.admits(nbytes_disk):
            # bigger than the whole budget: storing it could never fit
            self.backend.delete(key)
            return PutResult(key, nbytes_raw, nbytes_disk, 0.0, admitted=False)

        self.backend.write_blob(key, "skeleton.pkl", pickle.dumps(skeleton))
        self.backend.write_blob(key, "manifest.json", json.dumps(manifest).encode())
        dt = time.perf_counter() - t0
        self.records[key] = ArtifactRecord(
            key, nbytes_raw, nbytes_disk, dt, compute_s=compute_seconds
        )
        evicted = self._enforce_budget(incoming=key)
        self._mark_dirty()
        # a value-aware policy may decide the newcomer itself is the victim:
        # it displaces only artifacts worth less per byte than itself
        return PutResult(
            key, nbytes_raw, nbytes_disk, dt, admitted=key not in evicted,
            evicted=evicted,
        )

    def get(self, key: str, device: str | torch.device = "cuda") -> Any:
        """The value stored under ``key``, its tensors on ``device``."""
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("IntermediateStore.get: device='cuda' requested but CUDA "
                               "is not available")
        with _tracing.span("store.get", kind="store", key=key) as sp:
            t0 = time.perf_counter()
            with self._lock:
                value = self._get_locked(key, device)
                rec = self.records.get(key)
                compute_s = rec.compute_s if rec is not None else None
            dt = time.perf_counter() - t0
            self._m_gets.inc()
            self._m_get_seconds.observe(dt)
            # every successful load is a reuse hit: the caller was about to
            # recompute this prefix.  The realized time gain is the producer's
            # measured compute cost minus what the load actually took.
            self._m_reuse_hits.inc()
            saved = max(0.0, (compute_s or 0.0) - dt)
            if saved > 0.0:
                self._m_saved.inc(saved)
            sp.set(source="store", saved_s=round(saved, 6))
        return value

    def _get_locked(self, key: str, device: torch.device) -> Any:
        t0 = time.perf_counter()
        # optimistic read: the manifest itself is the existence proof, so a
        # fully-cached get costs ZERO backend round trips (has() would pay an
        # uncacheable exists() probe per call — presence stays authoritative
        # for *planning*, but a load can trust the blob it actually got)
        try:
            manifest = json.loads(self.backend.read_blob(key, "manifest.json"))
        except (KeyError, FileNotFoundError):
            raise KeyError(key) from None
        if key not in self.records:
            self._adopt_record(key)  # stored by a sibling process
        skeleton = pickle.loads(self.backend.read_blob(key, "skeleton.pkl"))
        # pre-codec manifests (seed layout) were always zstd-compressed
        codec = resolve_codec(manifest.get("codec", "zstd"))
        leaves = []
        for entry in manifest["leaves"]:
            if entry["kind"] != "dense":
                raise ValueError(f"artifact {key!r}: {entry['kind']!r} leaves are not supported")
            t = self._read_blob(key, entry["file"], codec, entry["dtype"], entry["shape"])
            leaves.append(t.to(device))
        value = unflatten(skeleton, leaves)
        dt = time.perf_counter() - t0
        rec = self.records[key]
        rec.load_s = dt
        rec.n_loads += 1
        # deliberately wall-clock (unlike deadline math elsewhere): record
        # timestamps are persisted in index.json and compared across
        # processes/restarts, where monotonic readings are meaningless
        rec.last_used_at = time.time()
        # hit statistics drive eviction ranking, so they should survive
        # restarts of read-only sessions; the batched-flush thresholds bound
        # both the rewrite frequency and the window of lost stats
        self._mark_dirty()
        return value

    def delete(self, key: str) -> None:
        with self._lock:
            if key in self.records:
                self.backend.delete(key)
                del self.records[key]
                self._mark_dirty()

    # -- accounting ----------------------------------------------------------
    @property
    def total_disk_bytes(self) -> int:
        with self._lock:
            return sum(r.nbytes_disk for r in self.records.values())

    @property
    def total_raw_bytes(self) -> int:
        with self._lock:
            return sum(r.nbytes_raw for r in self.records.values())

    def save_throughput(self) -> float:
        """Mean observed store bandwidth (raw bytes/s) for T1 estimation."""
        with self._lock:
            pairs = [
                (r.nbytes_raw, r.save_s) for r in self.records.values() if r.save_s > 0
            ]
        if not pairs:
            return 1e9
        tot_b = sum(b for b, _ in pairs)
        tot_s = sum(s for _, s in pairs)
        return tot_b / max(tot_s, 1e-9)

    def load_throughput(self) -> float:
        with self._lock:
            pairs = [
                (r.nbytes_raw, r.load_s)
                for r in self.records.values()
                if r.load_s and r.load_s > 0
            ]
        if not pairs:
            return self.save_throughput() * 2.0
        tot_b = sum(b for b, _ in pairs)
        tot_s = sum(s for _, s in pairs)
        return tot_b / max(tot_s, 1e-9)
