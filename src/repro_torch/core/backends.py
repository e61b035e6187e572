"""Pluggable storage backends for the intermediate-data store.

``IntermediateStore`` owns *what* an artifact is (pytree flattening, per-shard
blobs, the JSON manifest, compression via a ``Codec``); a ``StorageBackend``
owns only *where bytes live*.  An artifact is a namespace ``key`` holding
named blobs (``manifest.json``, ``skeleton.pkl``, ``leaf0.bin.zst``, ...);
store-level metadata (``index.json``) lives beside the namespaces.

Backends:

  * ``LocalFSBackend`` — the seed behavior: content-addressed directories
    ``objects/<h[:2]>/<h>/`` under a root path (the thesis' HDFS-write
    analogue, Ch. 3.4).
  * ``MemoryBackend``  — dict-of-dicts; for tests and as the hot tier.
  * ``TieredBackend``  — a bounded hot tier over a durable cold tier with
    LRU promote/demote; reads served hot when possible, writes go cold
    (authoritative) and are cached hot.
"""
from __future__ import annotations

import hashlib
import io
import os
import shutil
import tempfile
import threading
from abc import ABC, abstractmethod
from collections import OrderedDict
from pathlib import Path
from typing import BinaryIO, Iterable


def _key_hash(key: str) -> str:
    return hashlib.sha256(key.encode()).hexdigest()[:24]


class BackendUnavailable(RuntimeError):
    """The backend (or every replica of a distributed one) cannot be reached.

    Distinct from ``KeyError``/``FileNotFoundError``: the artifact may well
    still exist — the bytes are just unreachable right now.  Callers above
    the backend seam (store ``has``, scheduler load paths) treat this as
    "not reusable at the moment" and fall back to recomputing rather than
    failing the run or pruning records for artifacts that are still alive.
    """


class BlobWriter(ABC):
    """Incremental sink for one blob's bytes (the streaming write seam).

    The contract that matters for torn streams: nothing a reader can observe
    changes until :meth:`commit` — a writer abandoned mid-stream (or
    explicitly :meth:`abort`-ed) leaves no partial blob behind and reclaims
    any spill space it used.  ``commit``/``abort`` are idempotent.
    """

    @abstractmethod
    def write(self, data: bytes | bytearray | memoryview) -> None:
        """Append a chunk."""

    @abstractmethod
    def commit(self) -> int:
        """Atomically publish the accumulated bytes; return bytes stored."""

    @abstractmethod
    def abort(self) -> None:
        """Discard everything written so far (reclaim spill space)."""


class _SpillBlobWriter(BlobWriter):
    """Default streaming writer for backends without a native one: chunks
    append to an anonymous spill file on disk (constant memory while the
    stream is in flight), and ``commit`` replays them through the backend's
    one-shot ``write_blob`` — partial streams never reach the backend."""

    def __init__(self, backend: "StorageBackend", key: str, name: str) -> None:
        self._backend = backend
        self._key = key
        self._name = name
        self._spill: BinaryIO | None = tempfile.TemporaryFile(prefix="repro-spill-")
        self._nbytes = 0

    def write(self, data: bytes | bytearray | memoryview) -> None:
        if self._spill is None:
            raise RuntimeError("writer already committed/aborted")
        self._spill.write(data)
        self._nbytes += len(data)

    def commit(self) -> int:
        if self._spill is None:
            return self._nbytes
        spill, self._spill = self._spill, None
        try:
            spill.seek(0)
            return self._backend.write_blob(self._key, self._name, spill.read())
        finally:
            spill.close()  # anonymous tempfile: close() reclaims the space

    def abort(self) -> None:
        if self._spill is not None:
            spill, self._spill = self._spill, None
            spill.close()


class BlobReader:
    """Sized, file-like source for one blob (the streaming read seam).

    ``raw`` is any object with ``readinto``; when it is a real file the
    consumer may use ``fileno()`` for zero-copy sends (``os.sendfile``).
    """

    def __init__(self, raw: BinaryIO, size: int) -> None:
        self.raw = raw
        self.size = size

    def readinto(self, view: memoryview) -> int:
        return self.raw.readinto(view)

    def fileno(self) -> int:
        return self.raw.fileno()  # raises for memory-backed readers

    def close(self) -> None:
        try:
            self.raw.close()
        except OSError:
            pass

    def __enter__(self) -> "BlobReader":
        return self

    def __exit__(self, *exc: object) -> None:
        self.close()


class StorageBackend(ABC):
    """Byte-level persistence for artifact namespaces."""

    name = "abstract"

    @abstractmethod
    def write_blob(self, key: str, name: str, data: bytes) -> int:
        """Persist ``data`` as blob ``name`` of artifact ``key``; return bytes stored."""

    @abstractmethod
    def read_blob(self, key: str, name: str) -> bytes:
        """Read blob ``name`` of artifact ``key`` (KeyError/FileNotFoundError if absent)."""

    @abstractmethod
    def delete(self, key: str) -> None:
        """Drop every blob of artifact ``key`` (no-op if absent)."""

    @abstractmethod
    def exists(self, key: str) -> bool:
        """True iff artifact ``key`` has a committed manifest."""

    @abstractmethod
    def write_meta(self, name: str, text: str) -> None:
        """Persist store-level metadata (e.g. ``index.json``)."""

    @abstractmethod
    def read_meta(self, name: str) -> str | None:
        """Read store-level metadata, or None if absent."""

    def nbytes(self, key: str) -> int:
        """Total stored bytes of artifact ``key`` (0 if absent)."""
        raise NotImplementedError(f"{self.name} backend does not track sizes")

    # -- streaming / batched extensions (defaults compose from the core ops) --
    def open_blob_writer(self, key: str, name: str) -> BlobWriter:
        """Incremental writer for blob ``name`` of ``key``.  The default
        spills chunks to an anonymous temp file and publishes through
        ``write_blob`` at commit; backends with a native atomic path
        (``LocalFSBackend``) override for true constant-memory commits.
        Until ``commit``, no reader observes any of the written bytes."""
        return _SpillBlobWriter(self, key, name)

    def open_blob_reader(self, key: str, name: str) -> BlobReader:
        """Sized incremental reader for blob ``name`` of ``key`` (raises
        ``KeyError``/``FileNotFoundError`` like ``read_blob`` when absent).
        The default materializes ``read_blob`` once; file-backed backends
        override to stream straight off disk."""
        data = self.read_blob(key, name)
        return BlobReader(io.BytesIO(data), len(data))

    def exists_many(self, keys: Iterable[str]) -> dict[str, "bool | None"]:
        """Presence of many artifacts at once.  ``None`` marks a key whose
        presence is *undecidable right now* (``BackendUnavailable`` — e.g.
        every replica of it unreachable in a distributed backend); plain
        backends never return it.  Remote backends override this with a
        single batched round trip — the deep-chain probe walk depends on
        that being O(1) round trips, not O(depth)."""
        out: dict[str, bool | None] = {}
        for key in keys:
            try:
                out[key] = self.exists(key)
            except BackendUnavailable:
                out[key] = None
        return out


class _FSBlobWriter(BlobWriter):
    """LocalFS streaming writer: append to a dot-tmp spill file in the object
    directory, commit via atomic rename — the same write-then-rename
    discipline as ``write_blob``, with constant memory for any blob size."""

    def __init__(self, directory: Path, name: str) -> None:
        directory.mkdir(parents=True, exist_ok=True)
        self._final = directory / name
        self._tmp = directory / f".{name}.tmp.{os.getpid()}.{threading.get_ident()}"
        self._fh: BinaryIO | None = open(self._tmp, "wb")
        self._nbytes = 0

    def write(self, data: bytes | bytearray | memoryview) -> None:
        if self._fh is None:
            raise RuntimeError("writer already committed/aborted")
        self._fh.write(data)
        self._nbytes += len(data)

    def commit(self) -> int:
        if self._fh is None:
            return self._nbytes
        fh, self._fh = self._fh, None
        fh.close()
        try:
            os.replace(self._tmp, self._final)
        except OSError:
            try:
                os.unlink(self._tmp)
            except OSError:
                pass
            raise
        return self._nbytes

    def abort(self) -> None:
        if self._fh is not None:
            fh, self._fh = self._fh, None
            fh.close()
            try:
                os.unlink(self._tmp)
            except OSError:
                pass


class LocalFSBackend(StorageBackend):
    """Filesystem backend with the seed's content-addressed layout."""

    name = "localfs"

    def __init__(self, root: str | Path) -> None:
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)

    def _obj_dir(self, key: str) -> Path:
        h = _key_hash(key)
        return self.root / "objects" / h[:2] / h

    def write_blob(self, key: str, name: str, data: bytes) -> int:
        d = self._obj_dir(key)
        d.mkdir(parents=True, exist_ok=True)
        # write-then-rename (same discipline as write_meta): a reader racing
        # an overwrite sees the old or the new blob, never a torn one
        tmp = d / f".{name}.tmp.{os.getpid()}.{threading.get_ident()}"
        tmp.write_bytes(data)
        os.replace(tmp, d / name)
        return len(data)

    def read_blob(self, key: str, name: str) -> bytes:
        return (self._obj_dir(key) / name).read_bytes()

    def delete(self, key: str) -> None:
        d = self._obj_dir(key)
        if d.exists():
            shutil.rmtree(d)

    def exists(self, key: str) -> bool:
        return (self._obj_dir(key) / "manifest.json").exists()

    def write_meta(self, name: str, text: str) -> None:
        # write-then-rename: concurrent readers (and crashed writers) never
        # observe a torn index.json
        tmp = self.root / f"{name}.tmp.{os.getpid()}.{threading.get_ident()}"
        tmp.write_text(text)
        os.replace(tmp, self.root / name)

    def read_meta(self, name: str) -> str | None:
        p = self.root / name
        return p.read_text() if p.exists() else None

    def nbytes(self, key: str) -> int:
        d = self._obj_dir(key)
        if not d.exists():
            return 0
        return sum(
            f.stat().st_size
            for f in d.iterdir()
            if f.is_file() and not f.name.startswith(".")  # skip tmp leftovers
        )

    def open_blob_writer(self, key: str, name: str) -> BlobWriter:
        return _FSBlobWriter(self._obj_dir(key), name)

    def open_blob_reader(self, key: str, name: str) -> BlobReader:
        path = self._obj_dir(key) / name
        try:
            fh = open(path, "rb")
        except FileNotFoundError:
            raise KeyError(f"{key}/{name}") from None
        return BlobReader(fh, os.fstat(fh.fileno()).st_size)


class MemoryBackend(StorageBackend):
    """In-process backend: tests, ephemeral stores, and hot-tier caching."""

    name = "memory"

    def __init__(self) -> None:
        self._objects: dict[str, dict[str, bytes]] = {}
        self._meta: dict[str, str] = {}

    def write_blob(self, key: str, name: str, data: bytes) -> int:
        # callers may hand a memoryview over a live buffer (the KV codec's
        # zero-copy path); snapshot it so the stored blob can't alias it
        self._objects.setdefault(key, {})[name] = (
            data if isinstance(data, bytes) else bytes(data)
        )
        return len(data)

    def read_blob(self, key: str, name: str) -> bytes:
        return self._objects[key][name]

    def delete(self, key: str) -> None:
        self._objects.pop(key, None)

    def exists(self, key: str) -> bool:
        return "manifest.json" in self._objects.get(key, ())

    def write_meta(self, name: str, text: str) -> None:
        self._meta[name] = text

    def read_meta(self, name: str) -> str | None:
        return self._meta.get(name)

    def nbytes(self, key: str) -> int:
        return sum(len(b) for b in self._objects.get(key, {}).values())

    def open_blob_writer(self, key: str, name: str) -> BlobWriter:
        # the destination is memory anyway: accumulate directly, publish on
        # commit (the dict assignment is the atomic step)
        backend = self

        class _MemWriter(BlobWriter):
            def __init__(self) -> None:
                self._parts: list[bytes] | None = []

            def write(self, data: bytes | bytearray | memoryview) -> None:
                if self._parts is None:
                    raise RuntimeError("writer already committed/aborted")
                self._parts.append(bytes(data))

            def commit(self) -> int:
                if self._parts is None:
                    return 0
                parts, self._parts = self._parts, None
                return backend.write_blob(key, name, b"".join(parts))

            def abort(self) -> None:
                self._parts = None

        return _MemWriter()


class TieredBackend(StorageBackend):
    """Hot/cold tiering: bounded memory tier over a durable backend.

    Writes land on ``cold`` (authoritative) and are mirrored hot; reads hit
    the hot tier first and promote on miss.  When the hot tier exceeds
    ``hot_capacity_bytes``, least-recently-used *artifacts* (whole
    namespaces, so a manifest never outlives its blobs) are demoted —
    dropped from memory only; cold copies are untouched.

    Thread-safety: one lock guards the hot-tier bookkeeping (LRU order,
    byte accounting, the memory tier itself) so a concurrent ``_shrink_hot``
    can never race a promote into inconsistent accounting or crash an LRU
    iteration mid-scan; a read that loses its hot entry mid-flight falls
    back to the (authoritative) cold tier.  Cold-tier I/O — potentially a
    slow disk or a network hop — always happens *outside* the lock.
    """

    name = "tiered"

    def __init__(
        self,
        cold: StorageBackend,
        hot: MemoryBackend | None = None,
        hot_capacity_bytes: int = 256 * 1024 * 1024,
    ) -> None:
        self.cold = cold
        self.hot = hot or MemoryBackend()
        self.hot_capacity_bytes = hot_capacity_bytes
        self._lock = threading.RLock()
        self._lru: OrderedDict[str, None] = OrderedDict()  # key -> (LRU order)
        self._hot_nbytes = 0  # running total; avoids O(keys) rescans
        self.promotions = 0
        self.demotions = 0

    # -- hot-tier bookkeeping (callers hold self._lock) -----------------------
    def _touch(self, key: str) -> None:
        self._lru.pop(key, None)
        self._lru[key] = None

    def _hot_bytes(self) -> int:
        with self._lock:
            return self._hot_nbytes

    def _hot_write(self, key: str, name: str, data: bytes) -> None:
        prev = self.hot._objects.get(key, {}).get(name)
        self._hot_nbytes += len(data) - (len(prev) if prev is not None else 0)
        self.hot.write_blob(key, name, data)
        self._touch(key)

    def _hot_drop(self, key: str) -> None:
        self._hot_nbytes -= self.hot.nbytes(key)
        self.hot.delete(key)
        self._lru.pop(key, None)

    def _shrink_hot(self) -> None:
        while self._lru and self._hot_nbytes > self.hot_capacity_bytes:
            victim = next(iter(self._lru))
            self._hot_drop(victim)
            self.demotions += 1

    # -- StorageBackend ------------------------------------------------------
    def write_blob(self, key: str, name: str, data: bytes) -> int:
        n = self.cold.write_blob(key, name, data)
        if len(data) <= self.hot_capacity_bytes:
            with self._lock:
                self._hot_write(key, name, data)
                self._shrink_hot()
        return n

    def read_blob(self, key: str, name: str) -> bytes:
        with self._lock:
            try:
                data = self.hot.read_blob(key, name)
            except KeyError:
                # demoted by a concurrent _shrink_hot/delete mid-read: the
                # cold tier is authoritative, fall through to it
                pass
            else:
                self._touch(key)
                return data
        data = self.cold.read_blob(key, name)
        if len(data) <= self.hot_capacity_bytes:
            with self._lock:
                self._hot_write(key, name, data)
                self.promotions += 1
                self._shrink_hot()
        return data

    def delete(self, key: str) -> None:
        with self._lock:
            self._hot_drop(key)
        self.cold.delete(key)
        # a read that fetched cold bytes before the delete may promote them
        # concurrently; drop again so the hot tier doesn't keep orphan bytes
        with self._lock:
            self._hot_drop(key)

    def exists(self, key: str) -> bool:
        # cold is authoritative: every write lands there, and hot may briefly
        # hold resurrected blobs from a promote racing a delete — those must
        # not make an evicted artifact look alive
        return self.cold.exists(key)

    def exists_many(self, keys: Iterable[str]) -> dict[str, bool | None]:
        return self.cold.exists_many(keys)

    def open_blob_writer(self, key: str, name: str) -> BlobWriter:
        # streamed blobs skip the hot mirror on purpose: anything big enough
        # to stream would evict the whole hot set for one entry (the next
        # read promotes it if it actually fits)
        return self.cold.open_blob_writer(key, name)

    def open_blob_reader(self, key: str, name: str) -> BlobReader:
        # serve streams straight from cold: correct (authoritative tier) and
        # constant-memory; small blobs keep using read_blob and the hot path
        return self.cold.open_blob_reader(key, name)

    def write_meta(self, name: str, text: str) -> None:
        self.cold.write_meta(name, text)

    def read_meta(self, name: str) -> str | None:
        return self.cold.read_meta(name)

    def nbytes(self, key: str) -> int:
        return self.cold.nbytes(key)
