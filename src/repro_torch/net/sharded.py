"""``ShardedBackend`` — N store servers as one replicated artifact pool.

A single ``StoreServer`` is the right *contract* but the wrong
*cardinality*: one daemon's disk, accept loop, and lease table saturate
exactly when workflow parallelism starts paying (the single-node data
bottleneck of parallel SWfMS surveys, arXiv 1303.7195).  This backend keeps
the ``StorageBackend`` seam byte-for-byte and spreads it over a static
cluster:

  * **routing** — every artifact key (and meta name) maps onto a
    :class:`~repro_torch.net.ring.HashRing` preference list; the first ``R``
    nodes are its replica set (``replication=R``).
  * **replicated writes** — each blob write lands on every reachable
    replica; one success is enough to return (unreachable replicas are
    healed later by read-repair).  With ``R=2`` a shard can die mid-run
    without losing a single artifact.
  * **failover reads** — reads walk the replica set in ring order, skipping
    shards marked down; a read served by a non-primary counts as a
    ``failover_read``.
  * **read-repair** — when a later replica serves a blob that an *alive*
    earlier replica was missing (it restarted empty, or missed the write
    while down), the blob is written back best-effort, converging the
    replica set without any background process.
  * **ring-aware leases** — ``lease_acquire`` contends on the key's primary
    and falls over along the ring when it is unreachable, so the fleet-wide
    single-flight election (``DistributedSingleFlight``) survives a shard
    death mid-run: waiters re-elect on the next live node.
  * **merged event streams** — eviction events from every shard fan into
    the same listeners.  A replicated delete broadcasts from up to ``R``
    shards; listeners (cache invalidation, ``store.on_external_evict``)
    are idempotent by design.

Absence is only trusted when *every* replica of a key is reachable and
answers "no"; if any replica is down, presence questions raise
:class:`~repro_torch.net.protocol.StoreUnreachable` (a ``BackendUnavailable``),
which the store and scheduler treat as "not reusable right now" — plan a
recompute, never prune a record for bytes that may still exist.  Only
transport-level unreachability gets that treatment: a reachable shard
*reporting* an error (bad request, disk fault) propagates as-is and never
marks the shard down.

Membership is static configuration (the same comma-separated list every
client passes); see ``docs/remote.md`` for the operational caveats, chiefly
that a shard restored from an old disk can resurrect artifacts deleted
while it was away.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Callable, Sequence

from ..core.backends import BackendUnavailable, StorageBackend
from ..obs.metrics import MetricsRegistry, merge_docs
from .client import LeaseGrant, RemoteBackend
from .protocol import MAX_BATCH_OPS, IntegrityError, StoreUnreachable, parse_urls
from .ring import HashRing


class ShardedBackend(StorageBackend):
    """Consistent-hash routed, replicated client over N ``StoreServer``s.

    Parameters
    ----------
    urls: comma-separated endpoint list (``"h:7077,h:7078"``) or a sequence
        of single-endpoint urls.  Order is irrelevant: the ring sorts
        members canonically, so every client sharing the list routes alike.
    replication: replica-set size ``R`` per key (clamped to the shard
        count).  ``R=1`` is pure sharding (a dead shard loses its keys until
        it returns); ``R>=2`` survives single-shard death with no loss.
    client_id: shared across the per-shard connections, so a replicated
        delete's eviction broadcast still skips its originator on every
        shard.
    down_cooldown_s: after a transport failure a shard is skipped for this
        long before being probed again — failover stays fast without
        hammering a dead endpoint, and recovery is noticed within one
        cooldown.
    backend_kw: forwarded to each per-shard :class:`RemoteBackend` (its own
        socket pool — pool-per-shard).  Retries default lower than a
        single-server backend's: the ring itself is the retry of record.
    """

    name = "sharded"

    def __init__(
        self,
        urls: str | Sequence[str],
        *,
        replication: int = 2,
        client_id: str | None = None,
        down_cooldown_s: float = 1.0,
        vnodes: int = 64,
        registry: MetricsRegistry | None = None,
        **backend_kw: Any,
    ) -> None:
        if isinstance(urls, str):
            endpoints = parse_urls(urls)
        else:
            endpoints = [ep for u in urls for ep in parse_urls(u)]
        if len(set(endpoints)) != len(endpoints):
            raise ValueError(f"duplicate endpoints in {urls!r}")
        if replication < 1:
            raise ValueError("replication must be >= 1")
        backend_kw.setdefault("retries", 2)
        backend_kw.setdefault("retry_backoff_s", 0.05)
        self.nodes: tuple[str, ...] = tuple(f"{h}:{p}" for h, p in endpoints)
        self.ring = HashRing(self.nodes, vnodes=vnodes)
        self.replication = min(replication, len(self.nodes))
        self.down_cooldown_s = down_cooldown_s
        # one registry across the per-shard clients: their series carry a
        # ``shard`` label, so sharing never collides
        self.metrics = registry if registry is not None else MetricsRegistry()
        self._shards: dict[str, RemoteBackend] = {
            node: RemoteBackend(
                f"tcp://{node}", client_id=client_id, registry=self.metrics,
                **backend_kw,
            )
            for node in self.nodes
        }
        self.client_id = next(iter(self._shards.values())).client_id
        for rb in self._shards.values():
            rb.client_id = self.client_id  # one identity across the cluster
        self._lock = threading.Lock()
        self._down_until: dict[str, float] = {}  # node -> monotonic retry time
        self._lease_routes: dict[tuple[str, str], str] = {}  # (key, token) -> node
        # cluster-health counters on the registry; the attribute names the
        # tests and benchmarks assert on survive below as read-only aliases
        self._m_failover_reads = self.metrics.counter(
            "repro_cluster_failover_reads_total",
            "reads served by a non-first live replica",
        )
        self._m_read_repairs = self.metrics.counter(
            "repro_cluster_read_repairs_total",
            "blobs healed back onto a lagging replica",
        )
        self._m_lease_failovers = self.metrics.counter(
            "repro_cluster_lease_failovers_total",
            "lease ops that left the key's primary",
        )

    # -- shard health ----------------------------------------------------------
    def _is_down(self, node: str) -> bool:
        with self._lock:
            until = self._down_until.get(node)
            return until is not None and time.monotonic() < until

    def _mark_down(self, node: str) -> None:
        with self._lock:
            self._down_until[node] = time.monotonic() + self.down_cooldown_s

    def _mark_up(self, node: str) -> None:
        with self._lock:
            self._down_until.pop(node, None)

    def _replicas(self, key: str) -> list[str]:
        return self.ring.replicas(key, self.replication)

    def _candidates(self, targets: Sequence[str]) -> tuple[list[str], int]:
        """The nodes an op should actually dial, in preference order, plus
        the count of within-cooldown shards it must treat as unreachable
        WITHOUT dialing (redialing a dead endpoint on every presence probe
        would pay full connect retries per op, serialized under the store
        lock).  A shard whose cooldown expired counts as live again — that
        is how recovery is noticed.  When every target is inside its
        cooldown, probe them all anyway: the fleet must never lock itself
        out by having marked everything down."""
        live = [n for n in targets if not self._is_down(n)]
        if not live:
            return list(targets), 0
        return live, len(targets) - len(live)

    # -- blob ops --------------------------------------------------------------
    def write_blob(self, key: str, name: str, data: bytes) -> int:
        """Write to every replica of ``key``; >= 1 must land.  Like
        ``delete`` — and unlike the read paths — this dials replicas inside
        their down-cooldown too: a transient blip must not silently
        under-replicate a fresh artifact (read-repair only heals a lagging
        replica when a *preferred* one fails, so a skipped write could stay
        single-copy until the exact moment redundancy is needed)."""
        targets = self._replicas(key)
        nbytes: int | None = None
        last: Exception | None = None
        for node in targets:
            try:
                n = self._shards[node].write_blob(key, name, data)
            except BackendUnavailable as e:
                self._mark_down(node)
                last = e
                continue
            self._mark_up(node)
            if nbytes is None:
                nbytes = n
        if nbytes is None:
            raise StoreUnreachable(
                f"no replica of {key!r} reachable for write "
                f"(tried {targets}): {last}"
            ) from last
        return nbytes

    def read_blob(self, key: str, name: str) -> bytes:
        targets = self._replicas(key)
        to_try, unreachable = self._candidates(targets)
        missing: list[str] = []  # alive replicas that answered "not found"
        corrupt: list[str] = []  # alive replicas whose copy failed its digest
        last: Exception | None = None
        for node in to_try:
            try:
                data = self._shards[node].read_blob(key, name)
            except (KeyError, FileNotFoundError) as e:
                missing.append(node)
                last = e
                continue
            except IntegrityError as e:
                # bit rot on this replica: another may hold a verified-good
                # copy — replication's whole point.  Repair it if one does.
                corrupt.append(node)
                last = e
                continue
            except BackendUnavailable as e:
                self._mark_down(node)
                unreachable += 1
                last = e
                continue
            self._mark_up(node)
            if node != targets[0]:
                # served by a non-primary replica — whether we fell through
                # this very op or the primary was already marked down
                self._m_failover_reads.inc()
            self._repair(key, name, data, missing + corrupt)
            return data
        if corrupt and unreachable == 0:
            raise IntegrityError(
                f"blob {key}/{name}: every reachable replica holding it is "
                f"corrupt ({corrupt})"
            ) from last
        if unreachable == 0:
            raise KeyError(f"{key}/{name}") from last
        raise StoreUnreachable(
            f"blob {key}/{name}: {unreachable} replica(s) unreachable and no "
            f"reachable replica holds it"
        ) from last

    def _repair(self, key: str, name: str, data: bytes, lagging: list[str]) -> None:
        """Best-effort write-back to alive replicas that missed the blob
        (restarted empty, down during the original write, or bit-rotten)."""
        for node in lagging:
            try:
                self._shards[node].write_blob(key, name, data)
            except BackendUnavailable:
                self._mark_down(node)
            else:
                self._m_read_repairs.inc()

    def delete(self, key: str) -> None:
        """Delete on every replica — deliberately including shards inside
        their down-cooldown (a skipped delete is a future resurrection, the
        static-membership caveat in the docs; a skipped write is only a
        pending repair)."""
        targets = self._replicas(key)
        reached = False
        last: Exception | None = None
        for node in targets:
            try:
                self._shards[node].delete(key)
            except BackendUnavailable as e:
                self._mark_down(node)
                last = e
                continue
            self._mark_up(node)
            reached = True
        if not reached:
            raise StoreUnreachable(
                f"no replica of {key!r} reachable for delete (tried {targets})"
            ) from last

    def exists(self, key: str) -> bool:
        """True on the first replica that has the key.  ``False`` is only
        trusted when every replica was reachable and answered no: an
        unreachable replica might be the sole holder, and a false negative
        would make the planner recompute-and-overwrite — raise instead so
        ``store.has`` degrades to "not reusable right now"."""
        to_try, unreachable = self._candidates(self._replicas(key))
        last: Exception | None = None
        for node in to_try:
            try:
                present = self._shards[node].exists(key)
            except BackendUnavailable as e:
                self._mark_down(node)
                unreachable += 1
                last = e
                continue
            self._mark_up(node)
            if present:
                return True
        if unreachable == 0:
            return False
        raise StoreUnreachable(
            f"presence of {key!r} undecidable: {unreachable} replica(s) "
            f"unreachable, none of the reachable ones hold it"
        ) from last

    def exists_many(self, keys: "Sequence[str]") -> dict[str, "bool | None"]:
        """Batched presence probe across the cluster: group every key's
        replica set by node, send **at most one ``batch`` request per
        involved shard**, and merge with ``exists``'s exact semantics —
        ``True`` on any replica's yes; ``False`` only when every replica of
        the key was reachable and said no; ``None`` (undecidable) otherwise.
        Unlike :meth:`exists` this never raises for an undecidable key — a
        deep probe walk must report what it *can* decide in one round."""
        keys = list(dict.fromkeys(keys))
        if not keys:
            return {}
        node_keys: dict[str, list[str]] = {}
        unreachable: dict[str, int] = {k: 0 for k in keys}
        votes: dict[str, list[bool]] = {k: [] for k in keys}
        for k in keys:
            to_try, skipped = self._candidates(self._replicas(k))
            unreachable[k] = skipped
            for node in to_try:
                node_keys.setdefault(node, []).append(k)
        for node, ks in node_keys.items():
            shard = self._shards[node]
            results: list[dict[str, Any]] = []
            try:
                for start in range(0, len(ks), MAX_BATCH_OPS):
                    group = ks[start : start + MAX_BATCH_OPS]
                    results.extend(shard.batch([{"op": "exists", "key": k} for k in group]))
            except BackendUnavailable:
                self._mark_down(node)
                for k in ks:
                    unreachable[k] += 1
                continue
            self._mark_up(node)
            for k, r in zip(ks, results):
                if r.get("ok"):
                    votes[k].append(bool(r.get("exists")))
                else:
                    unreachable[k] += 1
        out: dict[str, bool | None] = {}
        for k in keys:
            if any(votes[k]):
                out[k] = True
            elif unreachable[k] == 0:
                out[k] = False
            else:
                out[k] = None
        return out

    def nbytes(self, key: str) -> int:
        to_try, _ = self._candidates(self._replicas(key))
        best: int | None = None
        last: Exception | None = None
        for node in to_try:
            try:
                n = self._shards[node].nbytes(key)
            except BackendUnavailable as e:
                self._mark_down(node)
                last = e
                continue
            self._mark_up(node)
            # replicas can lag (repair pending): report the fullest copy
            best = n if best is None else max(best, n)
        if best is None:
            raise StoreUnreachable(
                f"no replica of {key!r} reachable for nbytes"
            ) from last
        return best

    # -- meta ops --------------------------------------------------------------
    # Store-level metadata (index.json — a crash-safe stats cache, never a
    # source of truth) is broadcast to every shard so any single survivor
    # can seed a fresh client's adoption stats.
    def write_meta(self, name: str, text: str) -> None:
        to_try, _ = self._candidates(self.nodes)
        reached = False
        last: Exception | None = None
        for node in to_try:
            try:
                self._shards[node].write_meta(name, text)
            except BackendUnavailable as e:
                self._mark_down(node)
                last = e
                continue
            self._mark_up(node)
            reached = True
        if not reached:
            raise StoreUnreachable(f"no shard reachable for write_meta {name!r}") from last

    def read_meta(self, name: str) -> str | None:
        to_try, _ = self._candidates(self.ring.order(name))
        last: Exception | None = None
        reached = False
        for node in to_try:
            try:
                text = self._shards[node].read_meta(name)
            except BackendUnavailable as e:
                self._mark_down(node)
                last = e
                continue
            self._mark_up(node)
            reached = True
            if text is not None:
                return text
        if reached:
            return None  # every reachable shard agrees it is absent
        raise StoreUnreachable(f"no shard reachable for read_meta {name!r}") from last

    # -- catalog ops -------------------------------------------------------------
    def catalog_put(self, doc: dict[str, Any]) -> bool:
        """Mirror a catalog record onto the SAME replica set as the blob it
        describes — when a shard dies, the survivors that still serve the
        artifact also still answer queries about it.  Like ``write_blob``
        this dials replicas inside their down-cooldown (a skipped mirror
        would leave a replica serving a blob its catalog has never heard
        of).  True when >= 1 replica accepted."""
        key = str(doc.get("key", ""))
        if not key:
            return False
        landed = False
        for node in self._replicas(key):
            try:
                ok = self._shards[node].catalog_put(doc)
            except BackendUnavailable:
                self._mark_down(node)
                continue
            self._mark_up(node)
            landed = landed or ok
        return landed

    def catalog_remove(self, key: str) -> bool:
        """Drop a record on every replica (mirrors ``delete``'s discipline:
        cooldown shards are dialed too — a skipped removal is a future
        phantom)."""
        reached = False
        for node in self._replicas(key):
            try:
                ok = self._shards[node].catalog_remove(key)
            except BackendUnavailable:
                self._mark_down(node)
                continue
            self._mark_up(node)
            reached = reached or ok
        return reached

    def catalog_query(self, query_doc: dict[str, Any]) -> "list[dict[str, Any]] | None":
        """Fan the query out to every live shard and merge, deduplicating by
        key (replication means up to R shards answer for one artifact —
        keep the copy with the freshest stats).  ``None`` only when no shard
        answered at all; a partial cluster still returns what the reachable
        shards know, which is exactly the replica-surviving answer the
        kill-one-shard guarantee needs."""
        to_try, _ = self._candidates(self.nodes)
        merged: dict[str, dict[str, Any]] = {}
        answered = False
        for node in to_try:
            try:
                results = self._shards[node].catalog_query(query_doc)
            except BackendUnavailable:
                self._mark_down(node)
                continue
            self._mark_up(node)
            if results is None:  # pre-catalog shard: no vote either way
                continue
            answered = True
            for doc in results:
                key = str(doc.get("key", ""))
                old = merged.get(key)
                if old is None or float(doc.get("last_used_at", 0) or 0) > float(
                    old.get("last_used_at", 0) or 0
                ):
                    merged[key] = doc
        if not answered:
            return None
        return list(merged.values())

    # -- coordination ----------------------------------------------------------
    def lease_acquire(
        self, key: str, *, wait: bool = True, timeout_s: float = 300.0
    ) -> LeaseGrant:
        """Contend on the key's ring primary, falling over clockwise.

        All contenders walk the same order and skip the same down shards, so
        after a primary death the fleet re-converges on one stand-in
        electorate: a waiter whose blocked acquire dies with the shard
        retries here and lands on the next live node, where election
        proceeds (exactly-once is then restored by the stored-artifact probe
        every producer runs before computing).
        """
        to_try, _ = self._candidates(self.ring.order(key))
        last: Exception | None = None
        for node in to_try:
            try:
                grant = self._shards[node].lease_acquire(
                    key, wait=wait, timeout_s=timeout_s
                )
            except BackendUnavailable as e:
                self._mark_down(node)
                last = e
                continue
            self._mark_up(node)
            if node != self.ring.primary(key):
                self._m_lease_failovers.inc()
            if grant.granted:
                with self._lock:
                    self._lease_routes[(key, grant.token)] = node
            return grant
        raise StoreUnreachable(f"no shard reachable to lease {key!r}") from last

    def lease_release(self, key: str, token: str, *, stored: bool) -> None:
        with self._lock:
            node = self._lease_routes.pop((key, token), None)
        if node is None:
            node = self.ring.primary(key)
        try:
            self._shards[node].lease_release(key, token, stored=stored)
        except BackendUnavailable:
            # the granting shard is gone — and with it the lease table entry
            # (its death already auto-released every lease it held)
            self._mark_down(node)

    # -- events / introspection ------------------------------------------------
    def add_event_listener(self, fn: Callable[[str, str], None]) -> None:
        """Subscribe ``fn(event, key)`` to EVERY shard's event stream.  A
        replicated delete broadcasts from up to R shards; listeners must be
        idempotent per key (cache invalidation and record-drop both are)."""
        for rb in self._shards.values():
            rb.add_event_listener(fn)

    def server_stats(self) -> dict[str, Any]:
        """Aggregate + per-shard server counters (``None`` for dead shards)."""
        shards: dict[str, Any] = {}
        ops: dict[str, int] = {}
        total = 0
        for node, rb in self._shards.items():
            try:
                st = rb.server_stats()
            except BackendUnavailable:
                self._mark_down(node)
                shards[node] = None
                continue
            self._mark_up(node)
            shards[node] = st
            total += st.get("requests", 0)
            for op, n in st.get("ops", {}).items():
                ops[op] = ops.get(op, 0) + n
        return {"requests": total, "ops": ops, "shards": shards}

    def metrics_doc(self) -> dict[str, Any]:
        """Cluster-wide metrics merge: fan the ``metrics`` op out to every
        shard and fold the docs element-wise (fixed histogram buckets make
        that exact), stamping each shard's series with ``shard=host:port`` so
        non-additive gauges (uptime, connections) never sum across shards.
        Dead or pre-metrics shards simply contribute nothing."""
        docs: list[dict[str, Any] | None] = []
        extras: list[dict[str, str] | None] = []
        for node, rb in self._shards.items():
            try:
                doc = rb.metrics_doc()
            except BackendUnavailable:
                self._mark_down(node)
                continue
            self._mark_up(node)
            if doc is None:
                continue
            docs.append(doc)
            extras.append({"shard": node})
        return merge_docs(docs, extras)

    def ping_all(self) -> dict[str, bool]:
        out: dict[str, bool] = {}
        for node, rb in self._shards.items():
            try:
                out[node] = rb.ping()
            except BackendUnavailable:
                self._mark_down(node)
                out[node] = False
        return out

    def ping(self) -> bool:
        return all(self.ping_all().values())

    @property
    def reconnects(self) -> int:
        return sum(rb.reconnects for rb in self._shards.values())

    @property
    def failover_reads(self) -> int:
        """Deprecated alias of ``repro_cluster_failover_reads_total``."""
        return int(self._m_failover_reads.value)

    @property
    def read_repairs(self) -> int:
        """Deprecated alias of ``repro_cluster_read_repairs_total``."""
        return int(self._m_read_repairs.value)

    @property
    def lease_failovers(self) -> int:
        """Deprecated alias of ``repro_cluster_lease_failovers_total``."""
        return int(self._m_lease_failovers.value)

    def shard_for(self, key: str) -> str:
        """The key's current ring primary (benchmarks pick kill victims)."""
        return self.ring.primary(key)

    def close(self) -> None:
        for rb in self._shards.values():
            rb.close()
