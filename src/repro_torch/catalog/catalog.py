"""The :class:`Catalog` facade — one publish/discard/find surface for all
three deployments.

* **in-process** — records live in the local :class:`CatalogIndex` and
  persist as ``catalog.json`` through the store's backend (batched, like
  ``index.json``).
* **cross-process** — the backend is a ``RemoteBackend``: every publish is
  mirrored to the server's index (``catalog_put``), queries prefer the
  server's view (it survives client churn and sees every writer), and
  persistence is the *server's* job.
* **cluster** — the backend is a ``ShardedBackend``: publishes land on the
  same replica set as the blobs they describe, queries fan out per shard
  and merge here.

Consistency is event-driven, never scan-driven: admission publishes
(``admit_and_store``), the store's evict listeners call :meth:`discard`
(in-memory only — listeners run under the store lock), and server-side
deletes prune the server's index directly, so budget evictions converge on
every deployment without anyone re-reading ``index.json``.
"""
from __future__ import annotations

import json
import threading
from typing import Any, Mapping, Sequence

from ..core.backends import BackendUnavailable
from ..core.store import ArtifactRecord
from ..core.workflow import PrefixKey
from .index import CatalogIndex
from .records import CatalogQuery, CatalogRecord, rank_key, record_for_prefix

CATALOG_META = "catalog.json"


def _supports_remote_catalog(backend: Any) -> bool:
    return callable(getattr(backend, "catalog_put", None)) and callable(
        getattr(backend, "catalog_query", None)
    )


class Catalog:
    """Provenance index over the artifact space.

    Parameters
    ----------
    backend: the store's storage backend.  When it speaks the catalog op
        family (``RemoteBackend``/``ShardedBackend``), publishes are
        mirrored there and queries prefer its merged view; otherwise the
        catalog is purely local.
    persist: persist the local index as ``catalog.json`` through the
        backend's meta channel.  Defaults to on for local backends and off
        for remote ones (each server persists its own slice).
    flush_every: batch local persistence — write ``catalog.json`` after at
        most this many mutations (and on :meth:`flush`/:meth:`close`).
    """

    def __init__(
        self,
        backend: Any = None,
        *,
        persist: bool | None = None,
        flush_every: int = 64,
    ) -> None:
        self.index = CatalogIndex()
        self.backend = backend
        self._remote = backend if _supports_remote_catalog(backend) else None
        can_persist = backend is not None and callable(
            getattr(backend, "write_meta", None)
        )
        self.persist = (
            persist if persist is not None else (can_persist and self._remote is None)
        )
        self.flush_every = max(1, flush_every)
        self._flush_lock = threading.Lock()
        self._flushed_at_mutation = 0
        self._dirty = False
        # observability (tests + benchmarks assert on these)
        self.publish_failures = 0  # best-effort remote mirrors that failed
        self.remote_queries = 0
        self.local_queries = 0
        if self.persist:
            self._load()

    # -- persistence (local mode) -------------------------------------------
    def _load(self) -> None:
        try:
            raw = self.backend.read_meta(CATALOG_META)
        except BackendUnavailable:
            return
        if not raw:
            return
        try:
            docs = json.loads(raw)
        except json.JSONDecodeError:
            return  # damaged snapshot: rebuilt by future publishes
        if isinstance(docs, list):
            self.index.load(docs)
        self._flushed_at_mutation = self.index.mutations
        self._dirty = False

    def _flush_now(self) -> None:
        with self._flush_lock:
            snapshot = self.index.snapshot()
            mutations = self.index.mutations
            try:
                self.backend.write_meta(CATALOG_META, json.dumps(snapshot))
            except BackendUnavailable:
                return  # stays dirty; retried on the next mutation/flush
            self._flushed_at_mutation = mutations
            self._dirty = self.index.mutations != mutations

    def _mark_dirty(self) -> None:
        if not self.persist:
            return
        self._dirty = True
        if self.index.mutations - self._flushed_at_mutation >= self.flush_every:
            self._flush_now()

    def flush(self) -> None:
        """Persist the local index now if it has unflushed mutations."""
        if self.persist and self._dirty:
            self._flush_now()

    def close(self) -> None:
        self.flush()

    # -- write path ----------------------------------------------------------
    def publish(
        self,
        prefix: PrefixKey,
        key: str,
        record: "ArtifactRecord | None" = None,
        *,
        compute_s: float | None = None,
    ) -> CatalogRecord:
        """Index one admitted artifact.  Called from the admission seam
        (AFTER the store's ``put`` returns — never under the store lock).
        The remote mirror is best-effort: an unreachable server only costs a
        counter bump, the local view stays correct, and the server's index
        self-heals on the next publish of the same key."""
        rec = record_for_prefix(
            prefix,
            key,
            nbytes=int(getattr(record, "nbytes_disk", 0) or 0),
            compute_s=(
                compute_s
                if compute_s is not None
                else getattr(record, "compute_s", None)
            ),
            created_at=getattr(record, "created_at", None),
            last_used_at=float(getattr(record, "last_used_at", 0.0) or 0.0),
            n_loads=int(getattr(record, "n_loads", 0) or 0),
        )
        self.index.upsert(rec)
        self._mark_dirty()
        if self._remote is not None:
            # the net layer swallows transport errors (returns False) so a
            # flapping shard can't fail an admission that already landed
            if not self._remote.catalog_put(rec.to_doc()):
                self.publish_failures += 1
        return rec

    def discard(self, key: str) -> None:
        """Drop one key from the local view.  Purely in-memory + dirty mark:
        wired as a store evict listener, which runs under the store lock —
        no network, no meta IO, no re-entry into the store."""
        if self.index.discard(key):
            self._dirty = self.persist

    def touch(self, key: str, record: "ArtifactRecord | None" = None) -> None:
        """Refresh reuse stats after a hit (load) of ``key``."""
        if record is None:
            return
        if self.index.touch(
            key,
            last_used_at=float(getattr(record, "last_used_at", 0.0) or 0.0),
            n_loads=int(getattr(record, "n_loads", 0) or 0),
        ):
            self._mark_dirty()

    # -- read path -----------------------------------------------------------
    def find(
        self,
        module: str | None = None,
        params: Mapping[str, Any] | None = None,
        dataset: str | None = None,
        namespace: str | None = None,
        *,
        any_position: bool = False,
        limit: int = 50,
    ) -> list[CatalogRecord]:
        return self.query(
            CatalogQuery.build(
                module=module,
                params=params,
                dataset=dataset,
                namespace=namespace,
                any_position=any_position,
                limit=limit,
            )
        )

    def query(self, q: CatalogQuery) -> list[CatalogRecord]:
        """Ranked matches.  Remote-backed catalogs merge the server-side
        answer (authoritative across clients) with the local index (covers
        records whose best-effort mirror failed); dedup is by key, keeping
        the freshest stats."""
        local = self.index.query(q)
        remote_docs = self._query_remote(q)
        if remote_docs is None:
            self.local_queries += 1
            return local
        self.remote_queries += 1
        merged: dict[str, CatalogRecord] = {}
        for doc in remote_docs:
            try:
                rec = CatalogRecord.from_doc(doc)
            except (KeyError, ValueError, TypeError):
                continue
            if q.matches(rec):  # never trust a remote to have filtered right
                merged[rec.key] = rec
        for rec in local:
            old = merged.get(rec.key)
            if old is None or rec.last_used_at > old.last_used_at:
                merged[rec.key] = rec
        hits = sorted(merged.values(), key=rank_key)
        return hits[: q.limit]

    def _query_remote(self, q: CatalogQuery) -> "list[dict] | None":
        if self._remote is None:
            return None
        # None = unsupported server or pool unreachable: serve the local view
        return self._remote.catalog_query(q.to_doc())

    # -- consistency helpers ---------------------------------------------------
    def verify_present(
        self, records: Sequence[CatalogRecord], presence: Mapping[str, str]
    ) -> list[CatalogRecord]:
        """Filter records by a ``has_state_many`` answer, pruning the local
        index for authoritative absences (zero-phantom guarantee: a caller
        that verified gets only records whose artifact is readable *now*)."""
        out: list[CatalogRecord] = []
        for rec in records:
            state = presence.get(rec.key, "absent")
            if state == "present":
                out.append(rec)
            elif state == "absent":
                self.discard(rec.key)
        return out
