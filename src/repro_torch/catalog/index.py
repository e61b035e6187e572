"""In-memory inverted index over :class:`CatalogRecord`s.

The index is the query engine shared by every deployment: in-process it is
the client's write-through view, cross-process it lives inside
``StoreServer`` (op family ``catalog_*``), and in a cluster each shard
holds the slice for the blobs it replicates.

Postings are *loose* pre-filters — e.g. ``by_param`` keys on
``(module, name, encoded_value)`` regardless of chain position, so a chain
that repeats a module id can over-match — and :meth:`CatalogQuery.matches`
is always applied as the final exact predicate.  That keeps the postings
simple and the results correct.

Thread safety: all public methods take the internal lock.  ``upsert`` /
``discard`` are cheap dict/set updates, safe to call from eviction
listeners that run under the store lock (no IO, no re-entry into the
store).
"""
from __future__ import annotations

import threading
from typing import Any, Callable, Iterable, Mapping

from .records import CatalogQuery, CatalogRecord, rank_key


class CatalogIndex:
    """Postings + exact-match query over catalog records."""

    def __init__(self) -> None:
        self._lock = threading.RLock()
        self._records: dict[str, CatalogRecord] = {}
        # posting lists: loose pre-filters, each a set of record keys
        self._by_terminal: dict[str, set[str]] = {}
        self._by_member: dict[str, set[str]] = {}
        self._by_param: dict[tuple[str, str, str], set[str]] = {}
        self._by_dataset: dict[str, set[str]] = {}
        self._by_namespace: dict[str, set[str]] = {}
        self._mutations = 0  # monotonic; lets owners batch persistence

    # -- write path --------------------------------------------------------
    def _index_one(self, rec: CatalogRecord) -> None:
        key = rec.key
        self._by_terminal.setdefault(rec.module, set()).add(key)
        self._by_dataset.setdefault(rec.dataset, set()).add(key)
        self._by_namespace.setdefault(rec.namespace, set()).add(key)
        for module_id, state in zip(rec.modules, rec.states):
            self._by_member.setdefault(module_id, set()).add(key)
            for name, enc in state.items():
                self._by_param.setdefault((module_id, name, enc), set()).add(key)

    def _unindex_one(self, rec: CatalogRecord) -> None:
        key = rec.key

        def drop(table: dict, k: Any) -> None:
            bucket = table.get(k)
            if bucket is not None:
                bucket.discard(key)
                if not bucket:
                    del table[k]

        drop(self._by_terminal, rec.module)
        drop(self._by_dataset, rec.dataset)
        drop(self._by_namespace, rec.namespace)
        for module_id, state in zip(rec.modules, rec.states):
            drop(self._by_member, module_id)
            for name, enc in state.items():
                drop(self._by_param, (module_id, name, enc))

    def upsert(self, rec: CatalogRecord) -> None:
        with self._lock:
            old = self._records.get(rec.key)
            if old is not None:
                # keep the best-known stats: an upsert from a re-admission
                # must not erase reuse counters accumulated earlier
                if old.n_loads > rec.n_loads:
                    rec.n_loads = old.n_loads
                if old.last_used_at > rec.last_used_at:
                    rec.last_used_at = old.last_used_at
                if old.created_at and (
                    not rec.created_at or old.created_at < rec.created_at
                ):
                    rec.created_at = old.created_at
                self._unindex_one(old)
            self._records[rec.key] = rec
            self._index_one(rec)
            self._mutations += 1

    def touch(
        self, key: str, *, last_used_at: float | None = None, n_loads: int | None = None
    ) -> bool:
        """Update reuse stats for one record (no reindex needed — stats are
        not posting terms).  Returns False when the key is unknown."""
        with self._lock:
            rec = self._records.get(key)
            if rec is None:
                return False
            if last_used_at is not None and last_used_at > rec.last_used_at:
                rec.last_used_at = last_used_at
            if n_loads is not None and n_loads > rec.n_loads:
                rec.n_loads = n_loads
            self._mutations += 1
            return True

    def discard(self, key: str) -> bool:
        """Remove one record.  Idempotent; safe inside eviction listeners."""
        with self._lock:
            rec = self._records.pop(key, None)
            if rec is None:
                return False
            self._unindex_one(rec)
            self._mutations += 1
            return True

    def clear(self) -> None:
        with self._lock:
            self._records.clear()
            self._by_terminal.clear()
            self._by_member.clear()
            self._by_param.clear()
            self._by_dataset.clear()
            self._by_namespace.clear()
            self._mutations += 1

    # -- read path ---------------------------------------------------------
    def __len__(self) -> int:
        with self._lock:
            return len(self._records)

    def __contains__(self, key: str) -> bool:
        with self._lock:
            return key in self._records

    def get(self, key: str) -> CatalogRecord | None:
        with self._lock:
            return self._records.get(key)

    @property
    def mutations(self) -> int:
        with self._lock:
            return self._mutations

    def _candidates(self, q: CatalogQuery) -> set[str] | None:
        """Intersect the applicable posting lists; ``None`` means "all"."""
        pools: list[set[str]] = []
        if q.module is not None:
            table = self._by_member if q.any_position else self._by_terminal
            pools.append(table.get(q.module, set()))
            for name, enc in q.params.items():
                pools.append(self._by_param.get((q.module, name, enc), set()))
        if q.dataset is not None:
            pools.append(self._by_dataset.get(q.dataset, set()))
        if q.namespace is not None:
            pools.append(self._by_namespace.get(q.namespace, set()))
        if not pools:
            return None
        pools.sort(key=len)  # start from the rarest term
        out = set(pools[0])
        for p in pools[1:]:
            out &= p
            if not out:
                break
        return out

    def query(self, q: CatalogQuery) -> list[CatalogRecord]:
        """Ranked exact matches, at most ``q.limit`` of them."""
        with self._lock:
            keys = self._candidates(q)
            pool: Iterable[CatalogRecord]
            if keys is None:
                pool = list(self._records.values())
            else:
                pool = [self._records[k] for k in keys]
            hits = [r for r in pool if q.matches(r)]
        hits.sort(key=rank_key)
        return hits[: q.limit]

    def snapshot(self) -> list[dict]:
        """All records as JSON documents (persistence / wire transfer)."""
        with self._lock:
            return [r.to_doc() for r in self._records.values()]

    def load(self, docs: Iterable[Mapping[str, Any]]) -> int:
        """Bulk-load documents (replaces nothing — upserts).  Malformed
        documents are skipped: a damaged catalog file must not take the
        store down with it."""
        n = 0
        for doc in docs:
            try:
                rec = CatalogRecord.from_doc(doc)
            except (KeyError, ValueError, TypeError, AttributeError):
                continue
            self.upsert(rec)
            n += 1
        return n

    def prune(self, is_present: Callable[[str], bool]) -> int:
        """Drop records whose artifact no longer exists (used after
        loading a persisted snapshot that may have raced evictions)."""
        with self._lock:
            stale = [k for k in self._records if not is_present(k)]
        for k in stale:
            self.discard(k)
        return len(stale)
