"""Cluster mode in the port (``repro_torch.net.{ring,sharded}``): the hash
ring, ``ShardedBackend``, replication, failover, read-repair, leases on the
ring, and ``Client(store_url="h:p1,h:p2,h:p3")`` end to end, on the CPU.

Modelled on ``tests/test_sharded.py``, all 23 of its cases, over the port's
servers, on torch tensors (every client takes ``device="cpu"``).  Beyond
them, held against the reference package: ``HashRing`` places the same labels
on the same shards in the same order (exactly), and the port's
``ShardedBackend`` and ``Client`` over three reference ``StoreServer``s pass
the backend contract and reuse across the cluster.
"""
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from repro_torch.api import Client
from repro_torch.core import IntermediateStore, MemoryBackend
from repro_torch.net import (
    CachingBackend,
    DistributedSingleFlight,
    HashRing,
    RemoteStoreError,
    ShardedBackend,
    StoreServer,
    StoreUnreachable,
)
from repro_torch.net.protocol import parse_urls


# -- helpers -------------------------------------------------------------------
def _cluster(n=3, backend_factory=MemoryBackend):
    servers = [StoreServer(backend_factory()).start() for _ in range(n)]
    urls = ",".join(f"127.0.0.1:{s.port}" for s in servers)
    return servers, urls


def _sharded(urls, **kw):
    kw.setdefault("replication", 2)
    kw.setdefault("down_cooldown_s", 0.05)
    kw.setdefault("retries", 1)
    kw.setdefault("retry_backoff_s", 0.01)
    return ShardedBackend(urls, **kw)


def _node_of(server):
    return f"127.0.0.1:{server.port}"


def _key_with_primary(ring, node, tag="k"):
    """A key whose ring primary is ``node`` (exists within a few tries)."""
    for i in range(10_000):
        key = f"{tag}-{i}"
        if ring.primary(key) == node:
            return key
    raise AssertionError(f"no key found with primary {node}")


@pytest.fixture()
def cluster3():
    servers, urls = _cluster(3)
    yield servers, urls
    for s in servers:
        s.stop()


# -- ring ----------------------------------------------------------------------
def test_parse_urls():
    assert parse_urls("tcp://h:1,h:2, other:3") == [("h", 1), ("h", 2), ("other", 3)]
    assert parse_urls("h:7077") == [("h", 7077)]
    with pytest.raises(ValueError):
        parse_urls("h:1,h:1")  # duplicate member = silently halved replication
    with pytest.raises(ValueError):
        parse_urls(",")


def test_ring_balance_and_determinism():
    nodes = ["a:1", "b:1", "c:1"]
    ring = HashRing(nodes)
    keys = [f"key{i}" for i in range(3000)]
    spread = ring.spread(keys)
    # near-uniform: no shard owns less than half or more than double its share
    assert all(500 <= v <= 2000 for v in spread.values()), spread
    # member order is irrelevant: every client routes identically
    ring2 = HashRing(list(reversed(nodes)))
    assert all(ring.order(k) == ring2.order(k) for k in keys[:300])


def test_ring_order_and_replicas():
    ring = HashRing(["a:1", "b:1", "c:1"])
    order = ring.order("some-key")
    assert sorted(order) == ["a:1", "b:1", "c:1"]  # every node, once
    assert ring.primary("some-key") == order[0]
    assert ring.replicas("some-key", 2) == order[:2]
    assert ring.replicas("some-key", 99) == order  # clamped
    assert ring.replicas("some-key", 0) == order[:1]  # at least one
    single = HashRing(["solo:1"])
    assert single.order("x") == ["solo:1"]


def test_ring_remap_is_minimal():
    """Dropping one member remaps only that member's keys (consistent
    hashing's point, vs hash % N remapping almost everything)."""
    keys = [f"key{i}" for i in range(2000)]
    big = HashRing(["a:1", "b:1", "c:1"])
    small = HashRing(["a:1", "b:1"])
    moved = sum(
        1
        for k in keys
        if big.primary(k) != "c:1" and small.primary(k) != big.primary(k)
    )
    assert moved == 0


# -- sharded backend: contract + replication ----------------------------------
def test_sharded_backend_contract(cluster3):
    servers, urls = cluster3
    sb = _sharded(urls)
    try:
        assert sb.ping()
        assert not sb.exists("k")
        sb.write_blob("k", "manifest.json", b"{}")
        sb.write_blob("k", "leaf0.bin", b"\x01" * 100)
        assert sb.exists("k")
        assert sb.read_blob("k", "leaf0.bin") == b"\x01" * 100
        assert sb.nbytes("k") == 102
        with pytest.raises(KeyError):
            sb.read_blob("k", "missing.bin")
        sb.write_meta("index.json", '{"a": 1}')
        assert sb.read_meta("index.json") == '{"a": 1}'
        assert sb.read_meta("nope.json") is None
        sb.delete("k")
        assert not sb.exists("k")
        sb.delete("k")  # idempotent
    finally:
        sb.close()


def test_write_replicates_to_r_shards(cluster3):
    servers, urls = cluster3
    sb = _sharded(urls, replication=2)
    try:
        for i in range(8):
            sb.write_blob(f"k{i}", "manifest.json", b"{}")
        for i in range(8):
            holders = [s for s in servers if s.backend.exists(f"k{i}")]
            assert len(holders) == 2, f"k{i} on {len(holders)} shards, want 2"
            # and they are exactly the ring's replica set
            want = set(sb.ring.replicas(f"k{i}", 2))
            assert {_node_of(s) for s in holders} == want
    finally:
        sb.close()


def test_write_dials_cooldown_replicas(cluster3):
    """A down-marker from a transient blip must not make writes skip a
    replica that is actually alive — a skipped write is silent
    under-replication, invisible until the surviving copy dies too."""
    servers, urls = cluster3
    sb = _sharded(urls, replication=2)
    try:
        targets = sb.ring.replicas("k", 2)
        sb._mark_down(targets[1])  # blip marker; the shard itself is healthy
        sb.write_blob("k", "manifest.json", b"{}")
        holders = {_node_of(s) for s in servers if s.backend.exists("k")}
        assert holders == set(targets), "write must reach cooldown replicas too"
    finally:
        sb.close()


def test_failover_read_when_primary_down(cluster3):
    servers, urls = cluster3
    sb = _sharded(urls, replication=2)
    try:
        sb.write_blob("k", "manifest.json", b"{}")
        sb.write_blob("k", "b", b"payload")
        prim = sb.shard_for("k")
        next(s for s in servers if _node_of(s) == prim).stop()
        assert sb.read_blob("k", "b") == b"payload"
        assert sb.exists("k")
        assert sb.failover_reads >= 1
    finally:
        sb.close()


def test_zero_loss_after_killing_one_shard(cluster3):
    """The acceptance shape in miniature: R=2, kill any one shard, every
    artifact stays readable through the store layer."""
    servers, urls = cluster3
    sb = _sharded(urls, replication=2)
    try:
        store = IntermediateStore(backend=sb)
        keys = [f"art{i}" for i in range(12)]
        for i, key in enumerate(keys):
            store.put(key, np.arange(16.0) + i)
        servers[1].stop()
        for i, key in enumerate(keys):
            assert store.has(key), f"{key} lost after shard kill"
            np.testing.assert_array_equal(
                np.asarray(store.get(key, device="cpu")), np.arange(16.0) + i
            )
    finally:
        sb.close()


def test_corrupt_replica_fails_over_and_heals(cluster3):
    """A replica whose copy repeatedly fails digest verification is treated
    like a miss: the read fails over to a verified-good replica and repairs
    the rotten copy instead of failing the run."""
    from repro_torch.net import IntegrityError

    servers, urls = cluster3
    sb = _sharded(urls, replication=2)
    try:
        sb.write_blob("k", "manifest.json", b"{}")
        sb.write_blob("k", "b", b"good-bytes")
        prim = sb.shard_for("k")

        def corrupt_read(key, name):
            raise IntegrityError(f"blob {key}/{name} failed digest verification")

        sb._shards[prim].read_blob = corrupt_read  # this replica serves rot
        assert sb.read_blob("k", "b") == b"good-bytes"
        assert sb.failover_reads >= 1
        assert sb.read_repairs >= 1  # good bytes written back over the rot
        # every copy bad and every replica reachable -> IntegrityError, not
        # a phantom KeyError (the artifact exists, its bytes are damaged)
        succ = sb.ring.replicas("k", 2)[1]
        sb._shards[succ].read_blob = corrupt_read
        with pytest.raises(IntegrityError):
            sb.read_blob("k", "b")
    finally:
        sb.close()


def test_server_reported_errors_do_not_mark_shard_down(cluster3):
    """A reachable shard rejecting a bad request is not a dead shard: the
    error propagates as plain RemoteStoreError (not StoreUnreachable) and
    routing for other keys is unaffected."""
    servers, urls = cluster3
    sb = _sharded(urls, replication=2)
    try:
        with pytest.raises(RemoteStoreError) as exc:
            sb.write_blob("k", "../evil", b"x")  # server rejects the name
        assert not isinstance(exc.value, StoreUnreachable)
        assert not sb._down_until  # nobody got marked down
        sb.write_blob("k", "manifest.json", b"{}")  # cluster fully usable
        assert sb.exists("k")
    finally:
        sb.close()


def test_read_repair_after_shard_restart(cluster3):
    """A shard that restarts empty is healed by the first read
    that falls through it to a surviving replica."""
    servers, urls = cluster3
    sb = _sharded(urls, replication=2)
    try:
        sb.write_blob("k", "manifest.json", b"{}")
        sb.write_blob("k", "b", b"precious")
        prim = sb.shard_for("k")
        idx = next(i for i, s in enumerate(servers) if _node_of(s) == prim)
        port = servers[idx].port
        servers[idx].stop()
        # restart EMPTY on the same port (disk wiped / fresh volume)
        servers[idx] = StoreServer(MemoryBackend(), port=port).start()
        deadline = time.monotonic() + 2  # outlive the down-marker cooldown
        while time.monotonic() < deadline:
            if sb.read_blob("k", "b") == b"precious" and sb.read_repairs:
                break
            time.sleep(0.05)
        assert sb.read_repairs >= 1
        # the restarted primary now holds the healed copy locally
        assert servers[idx].backend.read_blob("k", "b") == b"precious"
    finally:
        sb.close()


def test_exists_undecidable_raises_and_store_has_degrades(cluster3):
    """With the only replica down, absence is unprovable: the backend raises
    BackendUnavailable and ``store.has`` answers False WITHOUT pruning the
    record — the bytes come back when the shard does."""
    servers, urls = cluster3
    sb = _sharded(urls, replication=1)
    try:
        store = IntermediateStore(backend=sb)
        store.put("solo", np.arange(8.0))
        assert store.has("solo")
        prim = sb.shard_for("solo")
        idx = next(i for i, s in enumerate(servers) if _node_of(s) == prim)
        port = servers[idx].port
        servers[idx].stop()
        with pytest.raises(StoreUnreachable):
            sb.exists("solo")
        assert store.has_state("solo") == "unreachable"
        assert not store.has("solo")  # degraded, not crashed
        assert "solo" in store.records  # …and NOT pruned
        # shard returns with its disk intact: artifact is reusable again
        servers[idx] = StoreServer(
            servers[idx].backend, port=port
        ).start()
        deadline = time.monotonic() + 2
        while time.monotonic() < deadline and not store.has("solo"):
            time.sleep(0.05)
        assert store.has("solo")
    finally:
        sb.close()


def test_has_adoption_when_primary_and_replica_disagree(cluster3):
    """Primary restarted empty, replica still holds the artifact.
    A fresh client's ``has()`` must adopt from the replica (OR-semantics),
    and ``get`` must assemble the value from it."""
    servers, urls = cluster3
    sb1 = _sharded(urls, replication=2)
    try:
        writer = IntermediateStore(backend=sb1)
        writer.put("shared", {"a": torch.arange(6.0).reshape(2, 3)})
        prim = sb1.shard_for("shared")
        idx = next(i for i, s in enumerate(servers) if _node_of(s) == prim)
        port = servers[idx].port
        servers[idx].stop()
        servers[idx] = StoreServer(MemoryBackend(), port=port).start()
        assert not servers[idx].backend.exists("shared")  # primary: "no"
        sb2 = _sharded(urls, replication=2)
        try:
            reader = IntermediateStore(backend=sb2)
            assert reader.has("shared")  # replica: "yes" wins
            out = reader.get("shared", device="cpu")
            np.testing.assert_array_equal(
                np.asarray(out["a"]), np.arange(6.0).reshape(2, 3)
            )
        finally:
            sb2.close()
    finally:
        sb1.close()


# -- leases on the ring --------------------------------------------------------
def test_lease_routes_to_primary_and_release_works(cluster3):
    servers, urls = cluster3
    sb1, sb2 = _sharded(urls), _sharded(urls)
    try:
        g = sb1.lease_acquire("k", wait=False)
        assert g.granted
        # held server-side on the key's primary
        prim = sb1.shard_for("k")
        srv = next(s for s in servers if _node_of(s) == prim)
        assert srv.stats()["active_leases"] == 1
        assert not sb2.lease_acquire("k", wait=False).granted
        sb1.lease_release("k", g.token, stored=True)
        g2 = sb2.lease_acquire("k", wait=False)
        assert g2.granted
        sb2.lease_release("k", g2.token, stored=False)
    finally:
        sb1.close()
        sb2.close()


def test_shard_death_during_inflight_lease_reelects_on_ring(cluster3):
    """The lease primary dies while a leader holds the lease and
    a waiter blocks on it.  The waiter's broken wait must fail over along
    the ring and win a fresh election on the next live shard."""
    servers, urls = cluster3
    sb_leader = _sharded(urls)
    sb_waiter = _sharded(urls)
    try:
        prim_node = _node_of(servers[0])
        key = _key_with_primary(sb_leader.ring, prim_node, tag="lease")
        g = sb_leader.lease_acquire(key, wait=False)
        assert g.granted

        out = {}

        def wait_for_lease():
            # the DistributedSingleFlight contention loop in miniature: a
            # wait that ends without the artifact (auto-release of the dying
            # leader, or a transport failure failed over by the ring)
            # re-contends until it is elected
            for _ in range(4):
                grant = sb_waiter.lease_acquire(key, wait=True, timeout_s=30)
                out["grant"] = grant
                if grant.granted or grant.stored:
                    return

        t = threading.Thread(target=wait_for_lease)
        t.start()
        deadline = time.monotonic() + 2  # waiter must be blocked server-side
        while time.monotonic() < deadline and servers[0].stats()["ops"].get(
            "lease_acquire", 0
        ) < 2:
            time.sleep(0.02)
        servers[0].stop()  # primary dies mid-wait
        t.join(timeout=10)
        assert not t.is_alive(), "waiter wedged on a dead shard"
        assert out["grant"].granted, "waiter must re-elect itself on the ring"
        # and the election moved off the dead primary along the ring
        assert sb_waiter.lease_failovers >= 1
        # the stand-in electorate is the ring successor, for every client
        assert sb_waiter.ring.order(key)[1] == sb_leader.ring.order(key)[1]
    finally:
        sb_leader.close()
        sb_waiter.close()


def test_distributed_singleflight_exactly_once_over_cluster(cluster3):
    servers, urls = cluster3
    computes = []
    lock = threading.Lock()

    def make_client():
        sb = _sharded(urls)
        store = IntermediateStore(backend=CachingBackend(sb))
        sf = DistributedSingleFlight(sb, stored_fn=store.has, lease_timeout_s=10)
        return sb, store, sf

    clients = [make_client() for _ in range(4)]
    barrier = threading.Barrier(4)
    results = []

    def run(i):
        sb, store, sf = clients[i]

        def produce():
            if store.has("cold-key"):
                return np.asarray(store.get("cold-key", device="cpu"))
            with lock:
                computes.append(i)
            time.sleep(0.1)
            value = np.arange(16.0)
            store.put("cold-key", value)
            return value

        barrier.wait()
        value, leader = sf.run("cold-key", produce)
        results.append((i, leader, value))

    threads = [threading.Thread(target=run, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    try:
        assert len(computes) == 1, f"expected exactly one compute, got {computes}"
        for _, _, value in results:
            np.testing.assert_array_equal(value, np.arange(16.0))
        assert sum(1 for r in results if r[1]) == 1
    finally:
        for sb, _, _ in clients:
            sb.close()


# -- events + api.Client end to end -------------------------------------------
def test_replicated_delete_events_converge_listeners(cluster3):
    servers, urls = cluster3
    sb1, sb2 = _sharded(urls), _sharded(urls)
    try:
        s2_cache = CachingBackend(sb2)
        s2 = IntermediateStore(backend=s2_cache)
        seen = []

        def on_event(event, key):
            if event == "evicted":
                s2_cache.invalidate(key)
                s2.on_external_evict(key)
                seen.append(key)

        sb2.add_event_listener(on_event)
        deadline = time.monotonic() + 2
        while (
            sum(
                s.stats()["subscribers"] for s in servers
            ) < len(servers)
            and time.monotonic() < deadline
        ):
            time.sleep(0.01)

        s1 = IntermediateStore(backend=sb1)
        s1.put("shared", torch.ones((8,)))
        assert s2.has("shared")
        s1.evict("shared")
        deadline = time.monotonic() + 2
        while not seen and time.monotonic() < deadline:
            time.sleep(0.01)
        # a replicated delete may broadcast from up to R shards; listeners
        # are idempotent, so convergence — not event count — is the contract
        assert set(seen) == {"shared"}
        assert "shared" not in s2.records
        assert not s2.has("shared")
    finally:
        sb1.close()
        sb2.close()


def test_client_cluster_mode_end_to_end(cluster3):
    servers, urls = cluster3

    def mk(cid):
        c = Client(store_url=urls, replication=2, policy="TSAR", client_id=cid,
               device="cpu")
        c.register_fn("double", lambda x: x * 2)
        c.register_fn("inc", lambda x, by=1: x + by, by=1)
        return c

    a, b = mk("a"), mk("b")
    try:
        data = torch.arange(32.0)
        ra = a.run_steps("ds", data, ["double", "inc"], "wa")
        assert ra.n_skipped == 0
        rb = b.run_steps("ds", data, ["double", "inc"], "wb")
        assert rb.n_skipped >= 1, "second client must reuse across the cluster"
        # kill the deepest stored key's primary: a THIRD client still reuses
        key = ra.stored_keys[-1]
        prim = a._remote.shard_for(key)
        next(s for s in servers if _node_of(s) == prim).stop()
        c = mk("c")
        try:
            rc = c.run_steps("ds", data, ["double", "inc"], "wc")
            assert rc.n_skipped >= 1, "kill of one shard must not lose the prefix"
            np.testing.assert_array_equal(
                np.asarray(rc.output), np.asarray(ra.output)
            )
        finally:
            c.close()
    finally:
        a.close()
        b.close()


def test_client_replication_validation():
    with pytest.raises(ValueError, match="replication"):
        Client(policy="TSAR", replication=2, device="cpu")
    with pytest.raises(ValueError, match="replication"):
        Client(store_url="127.0.0.1:1", replication=2, device="cpu")


# -- catalog over the cluster ---------------------------------------------------
def _catalog_client(urls, cid):
    c = Client(store_url=urls, replication=2, policy="TSAR", client_id=cid,
               device="cpu")
    c.register_fn("load", lambda d, scale=1: [x * scale for x in d], scale=1)
    return c


def _await_subscribers(servers, n, timeout=2.0):
    deadline = time.monotonic() + timeout
    while (
        sum(s.stats()["subscribers"] for s in servers) < n
        and time.monotonic() < deadline
    ):
        time.sleep(0.01)


def test_catalog_writes_follow_blob_replica_sets(cluster3):
    servers, urls = cluster3
    c = _catalog_client(urls, "cat-route")
    try:
        for scale in range(4):
            spec = c.spec("ds")
            spec.chain([("load", {"scale": scale})])
            c.run(spec, [1, 2, 3])
        hits = c.find(module="load")
        assert len(hits) == 4
        # each record lives on exactly the shards that hold its blob
        for h in hits:
            replicas = set(c._remote._replicas(h.key))
            for s in servers:
                has_rec = s.catalog.get(h.key) is not None
                assert has_rec == (_node_of(s) in replicas), h.key
    finally:
        c.close()


def test_concurrent_evictions_event_delivery_and_catalog_convergence(cluster3):
    """Concurrent evictions across the cluster — every eviction
    event is delivered to the subscribed client (at-least-once; replicated
    deletes may broadcast up to R times), and once the stream drains the
    catalog never reports an evicted artifact as present."""
    servers, urls = cluster3
    c = _catalog_client(urls, "cat-evt")
    try:
        for scale in range(6):
            spec = c.spec("ds")
            spec.chain([("load", {"scale": scale})])
            c.run(spec, [1, 2, 3])
        keys = sorted(h.key for h in c.find(module="load"))
        assert len(keys) == 6

        seen: list[str] = []
        c._remote.add_event_listener(
            lambda ev, k: seen.append(k) if ev == "evicted" else None
        )
        _await_subscribers(servers, len(servers))

        victims = keys[:3]
        sb = _sharded(urls)
        try:
            threads = [
                threading.Thread(target=sb.delete, args=(k,)) for k in victims
            ]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            # drain: the victims leave the client's local records AND its
            # catalog index via the event listeners
            deadline = time.monotonic() + 5
            while time.monotonic() < deadline and any(
                k in c.catalog.index or k in c.store.records for k in victims
            ):
                time.sleep(0.02)

            assert set(victims) <= set(seen), "every eviction must be delivered"
            for k in victims:
                assert k not in c.catalog.index
                assert k not in c.store.records
                # the shard-side indexes pruned on delete too
                assert all(s.catalog.get(k) is None for s in servers)
            # zero phantoms: find answers exactly the survivors
            assert sorted(h.key for h in c.find(module="load")) == keys[3:]
        finally:
            sb.close()
    finally:
        c.close()


def test_cluster_find_zero_phantoms_after_shard_kill(cluster3):
    """Acceptance: kill one shard; ``Client.find`` answers from the replicas
    and every returned record's artifact is verifiably present."""
    servers, urls = cluster3
    c = _catalog_client(urls, "cat-kill")
    try:
        for scale in range(5):
            spec = c.spec("ds")
            spec.chain([("load", {"scale": scale})])
            c.run(spec, [1, 2, 3])
        before = {h.key for h in c.find(module="load")}
        assert len(before) == 5

        servers[0].stop()
        # a fresh client has no local index: answers come from the surviving
        # shards' catalogs, then get presence-verified in one batched probe
        c2 = _catalog_client(urls, "cat-kill-2")
        try:
            hits = c2.find(module="load")
            assert {h.key for h in hits} == before, "replicas cover the dead shard"
            presence = c2.store.has_state_many([h.key for h in hits])
            assert all(v == "present" for v in presence.values()), presence
        finally:
            c2.close()
    finally:
        c.close()


# -- against the reference package -------------------------------------------------
@pytest.mark.parametrize("nodes", [
    ["solo:1"],
    ["a:1", "b:1"],
    ["127.0.0.1:7077", "127.0.0.1:7078", "127.0.0.1:7079"],
    [f"10.0.0.{i}:{7000 + i}" for i in range(5)],
])
def test_ring_places_labels_as_the_reference(nodes):
    from repro.net import HashRing as JaxRing

    ours, ref = HashRing(nodes), JaxRing(nodes)
    keys = [f"key{i}" for i in range(2000)] + [
        "a" * 64, "ds/" + "0" * 40, "tenant:a/prompts/3f2c", ""]
    for k in keys:
        assert ours.order(k) == ref.order(k)
        assert ours.primary(k) == ref.primary(k)
        assert ours.replicas(k, 2) == ref.replicas(k, 2)
    assert ours.spread(keys) == ref.spread(keys)
    assert HashRing(list(reversed(nodes))).order("x") == ref.order("x")


@pytest.fixture()
def reference_cluster3():
    from repro.core import MemoryBackend as JaxMemory
    from repro.net import StoreServer as JaxServer

    servers = [JaxServer(JaxMemory()).start() for _ in range(3)]
    yield servers, ",".join(f"127.0.0.1:{s.port}" for s in servers)
    for s in servers:
        s.stop()


def test_sharded_backend_contract_over_reference_servers(reference_cluster3):
    servers, urls = reference_cluster3
    sb = _sharded(urls, replication=2)
    try:
        assert sb.ping()
        assert not sb.exists("k")
        sb.write_blob("k", "manifest.json", b"{}")
        sb.write_blob("k", "leaf0.bin", b"\x01" * 100)
        assert sb.exists("k")
        assert sb.read_blob("k", "leaf0.bin") == b"\x01" * 100
        assert sb.nbytes("k") == 102
        with pytest.raises(KeyError):
            sb.read_blob("k", "missing.bin")
        sb.write_meta("index.json", '{"a": 1}')
        assert sb.read_meta("index.json") == '{"a": 1}'
        assert sb.read_meta("nope.json") is None
        sb.delete("k")
        assert not sb.exists("k")
        sb.delete("k")  # idempotent
        sb.write_blob("r", "manifest.json", b"{}")
        sb.write_blob("r", "b", b"payload")
        holders = {_node_of(s) for s in servers if s.backend.exists("r")}
        assert holders == set(sb.ring.replicas("r", 2))
        prim = sb.shard_for("r")
        next(s for s in servers if _node_of(s) == prim).stop()
        assert sb.read_blob("r", "b") == b"payload"
        assert sb.failover_reads >= 1
    finally:
        sb.close()


def test_client_cluster_mode_over_reference_servers(reference_cluster3):
    """A reference ``Client`` and the port's on one reference cluster: the
    port's reuses the prefix the reference's stored, under the same keys."""
    from repro.api import Client as JaxClient

    servers, urls = reference_cluster3
    ref = JaxClient(store_url=urls, replication=2, policy="TSAR", client_id="ref")
    ours = Client(store_url=urls, replication=2, policy="TSAR", client_id="port",
                  device="cpu")
    for c in (ref, ours):
        c.register_fn("double", lambda x: x * 2)
        c.register_fn("inc", lambda x, by=1: x + by, by=1)
    try:
        ra = ref.run_steps("ds", np.arange(32.0), ["double", "inc"], "wa")
        assert ra.n_skipped == 0
        rb = ours.run_steps("ds", torch.arange(32.0, dtype=torch.float64),
                            ["double", "inc"], "wb")
        assert rb.n_skipped == 2, "the port must reuse the reference's prefix"
        np.testing.assert_array_equal(rb.output.numpy(), np.asarray(ra.output))
        assert set(ours.store.records) == set(ra.stored_keys)
    finally:
        ref.close()
        ours.close()
