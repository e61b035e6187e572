"""The port's store service (``repro_torch.net``): its copies of the
reference's ``StoreServer``, ``CachingBackend`` and ``serve`` CLI, on the CPU.

Modelled on ``tests/test_net.py``, all 22 of its cases: the protocol's url
parsing and framing, the backend contract over the wire, the
cache tier (bounded LRU, fences against eviction events, indexed purges),
the eviction-event stream, the failure modes (server restart, truncated
frames, digest mismatch, an artifact evicted while planned), leases and the
distributed single-flight; the two that drive the reference's ``Client``
drive the port's, mounted with ``store_url``.
Beyond them: each package's ``RemoteBackend`` against the other package's
server, and the CLI started with ``--port 0`` and stopped by SIGTERM.
"""
import json
import os
import signal
import socket
import struct
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from repro import core as jcore
from repro import net as jnet
from repro_torch.api import Client
from repro_torch.core import IntermediateStore, LocalFSBackend, MemoryBackend
from repro_torch.net import (
    CachingBackend,
    DistributedSingleFlight,
    RemoteBackend,
    StoreServer,
)
from repro_torch.net.protocol import (
    IntegrityError,
    RemoteStoreError,
    parse_url,
    recv_frame,
    send_frame,
)

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture()
def server(tmp_path):
    srv = StoreServer(LocalFSBackend(tmp_path / "pool")).start()
    yield srv
    srv.stop()


def _fast_backend(url, cls=RemoteBackend, **kw):
    kw.setdefault("retries", 2)
    kw.setdefault("retry_backoff_s", 0.01)
    return cls(url, **kw)


def _get(store, key):
    return store.get(key, device="cpu")


# -- protocol --------------------------------------------------------------------
def test_parse_url():
    assert parse_url("tcp://h:123") == ("h", 123)
    assert parse_url("h:123") == ("h", 123)
    assert parse_url("tcp://10.0.0.1:7077") == ("10.0.0.1", 7077)
    assert parse_url("myhost")[0] == "myhost"
    with pytest.raises(ValueError):
        parse_url("tcp://h:notaport")
    with pytest.raises(ValueError):
        parse_url("tcp://h:1/path")


def test_frame_roundtrip():
    a, b = socket.socketpair()
    try:
        send_frame(a, {"op": "x", "n": 3}, b"payload")
        header, payload = recv_frame(b)
        assert header == {"op": "x", "n": 3}
        assert payload == b"payload"
    finally:
        a.close()
        b.close()


# -- backend contract over the wire ------------------------------------------
def _contract(rb, meta="index.json"):
    assert rb.ping()
    assert not rb.exists("k")
    rb.write_blob("k", "manifest.json", b"{}")
    rb.write_blob("k", "leaf0.bin", b"\x01" * 100)
    assert rb.exists("k")
    assert rb.read_blob("k", "leaf0.bin") == b"\x01" * 100
    assert rb.nbytes("k") == 102
    with pytest.raises(KeyError):
        rb.read_blob("k", "missing.bin")
    rb.write_meta(meta, '{"a": 1}')
    assert rb.read_meta(meta) == '{"a": 1}'
    assert rb.read_meta("nope.json") is None
    rb.delete("k")
    assert not rb.exists("k")
    rb.delete("k")  # idempotent


def test_remote_backend_contract(server):
    rb = _fast_backend(server.url)
    try:
        _contract(rb)
    finally:
        rb.close()


@pytest.mark.parametrize("client,srv", [("reference", "port"), ("port", "reference")])
def test_each_package_client_against_the_other_server(tmp_path, client, srv):
    """The wire is one protocol: a reference ``RemoteBackend`` speaks to the
    port's server and the port's to the reference's, for the backend contract
    and for a stored artifact that the other package's store adopts."""
    server_cls = StoreServer if srv == "port" else jnet.StoreServer
    backend_cls = LocalFSBackend if srv == "port" else jcore.LocalFSBackend
    server = server_cls(backend_cls(tmp_path / "pool")).start()
    remote_cls = RemoteBackend if client == "port" else jnet.RemoteBackend
    rb = _fast_backend(server.url, remote_cls)
    other = _fast_backend(server.url, RemoteBackend)
    try:
        _contract(rb, meta="contract.json")  # a store reads index.json below
        value = np.arange(12.0, dtype=np.float32).reshape(3, 4)
        if client == "reference":
            jcore.IntermediateStore(backend=jnet.CachingBackend(rb)).put("key1", value)
        else:
            IntermediateStore(backend=CachingBackend(rb)).put("key1", torch.from_numpy(value))
        assert server.stats()["ops"]["write_blob"] >= 2
        # a second port client adopts it from the shared pool
        store = IntermediateStore(backend=CachingBackend(other))
        assert store.has("key1")
        np.testing.assert_array_equal(np.asarray(_get(store, "key1")), value)
        # and the lease table is shared: a lease held by one is denied to the other
        g = rb.lease_acquire("held", wait=False)
        assert g.granted and not other.lease_acquire("held", wait=False).granted
        rb.lease_release("held", g.token, stored=False)
        assert other.lease_acquire("held", wait=False).granted
    finally:
        rb.close()
        other.close()
        server.stop()


def test_store_roundtrip_and_cross_client_adoption(server):
    rb1, rb2 = _fast_backend(server.url), _fast_backend(server.url)
    try:
        s1 = IntermediateStore(backend=CachingBackend(rb1))
        s2 = IntermediateStore(backend=CachingBackend(rb2))
        value = {"a": torch.arange(12.0).reshape(3, 4), "b": torch.ones(5, dtype=torch.float64)}
        s1.put("key1", value, compute_seconds=0.2)
        # s2 never saw the put; it adopts the record from the shared pool
        assert s2.has("key1")
        out = _get(s2, "key1")
        assert torch.equal(out["a"], value["a"]) and torch.equal(out["b"], value["b"])
    finally:
        rb1.close()
        rb2.close()


def test_caching_backend_serves_repeats_locally(server):
    rb = _fast_backend(server.url)
    try:
        cache = CachingBackend(rb)
        store = IntermediateStore(backend=cache)
        store.put("k", torch.arange(64.0))
        _get(store, "k")  # populates any blobs not cached by the put
        before = rb.server_stats()["ops"].get("read_blob", 0)
        for _ in range(3):
            assert torch.equal(_get(store, "k"), torch.arange(64.0))
        after = rb.server_stats()["ops"].get("read_blob", 0)
        assert after == before, "cached re-reads must not hit the server"
        assert cache.hits > 0
    finally:
        rb.close()


def test_cache_bounded_lru():
    inner = MemoryBackend()
    cache = CachingBackend(inner, capacity_bytes=1000)
    for i in range(10):
        cache.write_blob(f"k{i}", "b", bytes([i]) * 300)
    assert cache.cached_bytes <= 1000
    # oldest entries were dropped, but reads still succeed via the backend
    assert cache.read_blob("k0", "b") == b"\x00" * 300


class _GatedBackend(MemoryBackend):
    """Inner backend whose fetch blocks until the test releases it."""

    def __init__(self):
        super().__init__()
        self.entered = threading.Event()
        self.gate = threading.Event()

    def read_blob(self, key, name):
        self.entered.set()
        assert self.gate.wait(5), "test never released the gated fetch"
        return super().read_blob(key, name)


def test_cache_miss_insert_fenced_by_invalidation():
    """An eviction event landing between the inner fetch and the re-insert
    must not resurrect the dead blob."""
    inner = _GatedBackend()
    inner._objects["k"] = {"b": b"stale-bytes"}
    cache = CachingBackend(inner)
    out = {}

    def miss():
        out["data"] = cache.read_blob("k", "b")

    t = threading.Thread(target=miss)
    t.start()
    assert inner.entered.wait(5)
    cache.invalidate("k")
    inner.gate.set()
    t.join(timeout=5)
    assert out["data"] == b"stale-bytes"
    assert cache.stale_inserts_dropped == 1
    assert cache.cached_bytes == 0
    assert not cache._gen and not cache._inflight
    inner.entered.clear()
    inner.gate.set()
    cache.read_blob("k", "b")
    assert cache.cached_bytes == len(b"stale-bytes")


def test_cache_invalidation_of_uncached_keys_leaves_no_state():
    cache = CachingBackend(MemoryBackend())
    for i in range(500):
        cache.invalidate(f"never-seen-{i}")
    assert not cache._gen and not cache._inflight and not cache._names
    assert cache.cached_bytes == 0


class _GatedWriteBackend(MemoryBackend):
    def __init__(self):
        super().__init__()
        self.entered = threading.Event()
        self.gate = threading.Event()

    def write_blob(self, key, name, data):
        self.entered.set()
        assert self.gate.wait(5), "test never released the gated write"
        return super().write_blob(key, name, data)


def test_cache_write_insert_fenced_by_invalidation():
    inner = _GatedWriteBackend()
    cache = CachingBackend(inner)
    t = threading.Thread(target=cache.write_blob, args=("k", "b", b"v1"))
    t.start()
    assert inner.entered.wait(5)
    cache.invalidate("k")
    inner.gate.set()
    t.join(timeout=5)
    assert cache.stale_inserts_dropped == 1
    assert cache.cached_bytes == 0
    assert inner.read_blob("k", "b") == b"v1"
    cache.write_blob("k", "b", b"v2")
    assert cache.cached_bytes == 2


def test_cache_purge_uses_index_not_full_scan():
    cache = CachingBackend(MemoryBackend())
    n_keys, blobs_per_key = 200, 2
    for i in range(n_keys):
        for j in range(blobs_per_key):
            cache.write_blob(f"k{i}", f"b{j}", b"x" * 8)
    assert cache.purge_examined == 0
    cache.invalidate("k7")
    assert cache.purge_examined == blobs_per_key
    assert cache.read_blob("k7", "b0") == b"x" * 8
    before = cache.purge_examined
    cache.invalidate("never-cached")
    assert cache.purge_examined == before


def _wait_subscribed(rb):
    deadline = time.time() + 2
    while rb.server_stats()["subscribers"] == 0 and time.time() < deadline:
        time.sleep(0.01)


def test_eviction_event_stream(server):
    rb1, rb2 = _fast_backend(server.url), _fast_backend(server.url)
    try:
        s2_cache = CachingBackend(rb2)
        s2 = IntermediateStore(backend=s2_cache)
        seen = []

        def on_event(event, key):
            if event == "evicted":
                s2_cache.invalidate(key)
                s2.on_external_evict(key)
                seen.append(key)

        rb2.add_event_listener(on_event)
        _wait_subscribed(rb2)
        s1 = IntermediateStore(backend=CachingBackend(rb1))
        s1.put("shared", torch.ones(8))
        assert s2.has("shared")
        s1.evict("shared")  # broadcasts to rb2 (not back to rb1)
        deadline = time.time() + 2
        while not seen and time.time() < deadline:
            time.sleep(0.01)
        assert seen == ["shared"]
        assert "shared" not in s2.records
        assert not s2.has("shared")
    finally:
        rb1.close()
        rb2.close()


# -- failure modes -------------------------------------------------------------
def test_server_restart_mid_run_reconnects(tmp_path):
    srv = StoreServer(LocalFSBackend(tmp_path / "pool")).start()
    port = srv.port
    rb = RemoteBackend(srv.url, retries=6, retry_backoff_s=0.05)
    try:
        store = IntermediateStore(backend=CachingBackend(rb, capacity_bytes=0))
        store.put("k", torch.arange(32.0))
        srv.stop()
        srv = StoreServer(LocalFSBackend(tmp_path / "pool"), port=port).start()
        assert torch.equal(_get(store, "k"), torch.arange(32.0))
        assert rb.reconnects > 0
    finally:
        rb.close()
        srv.stop()


def test_truncated_request_does_not_wedge_server(server):
    raw = socket.create_connection((server.host, server.port))
    raw.sendall(struct.pack(">IQ", 500, 0) + b'{"op": "ping"')  # header cut short
    raw.close()
    rb = _fast_backend(server.url)
    try:
        assert rb.ping()
    finally:
        rb.close()


def _one_shot_bad_server(responses):
    ls = socket.socket()
    ls.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    ls.bind(("127.0.0.1", 0))
    ls.listen(8)

    def serve():
        for resp in responses:
            try:
                conn, _ = ls.accept()
                recv_frame(conn)
                if resp:
                    conn.sendall(resp)
                conn.close()
            except OSError:
                return

    threading.Thread(target=serve, daemon=True).start()
    return ls, ls.getsockname()[1]


def test_truncated_response_retries_then_errors():
    head = b'{"ok":true}'
    bad = struct.pack(">IQ", len(head), 100) + head + b"x" * 10
    ls, port = _one_shot_bad_server([bad, bad, bad])
    rb = RemoteBackend(f"tcp://127.0.0.1:{port}", retries=2, retry_backoff_s=0.01)
    try:
        with pytest.raises(RemoteStoreError, match="unreachable after"):
            rb.ping()
    finally:
        rb.close()
        ls.close()


def test_digest_mismatch_raises_integrity_error():
    head = json.dumps({"ok": True, "digest": "0" * 64}).encode()
    resp = struct.pack(">IQ", len(head), 4) + head + b"evil"
    ls, port = _one_shot_bad_server([resp] * 4)
    rb = RemoteBackend(f"tcp://127.0.0.1:{port}", retries=1, retry_backoff_s=0.01)
    try:
        with pytest.raises(IntegrityError):
            rb.read_blob("k", "b")
    finally:
        rb.close()
        ls.close()


def test_evicted_while_planned_recomputes_through_remote(server):
    calls = {"n": 0}
    with Client(store_url=server.url, policy="TSAR", device="cpu") as client:
        @client.module("count")
        def count(x):
            calls["n"] += 1
            return x + 1

        r1 = client.run_steps("ds", torch.arange(4.0), ["count"], "w1")
        assert calls["n"] == 1
        # wipe the artifact on the server's backend: no eviction event reaches
        # the client, whose policy still plans a load that will vanish
        key = r1.stored_keys[0]
        server.backend.delete(key)
        assert key in client.policy.stored
        r2 = client.run_steps("ds", torch.arange(4.0), ["count"], "w2")
        assert calls["n"] == 2  # recompute fallback, not a crash
        assert torch.equal(r2.output, torch.arange(4.0) + 1)


def test_two_executors_reuse_each_other_through_the_server(server):
    """Two ``Client``s on one server: artifacts stored by one are reused by
    the other (``test_client_store_url_end_to_end`` of the reference)."""
    def mk(cid):
        c = Client(store_url=server.url, policy="TSAR", client_id=cid, device="cpu")
        c.register_fn("double", lambda x: x * 2)
        c.register_fn("inc", lambda x, by=1: x + by, by=1)
        return c

    a, b = mk("a"), mk("b")
    try:
        data = torch.arange(32.0)
        ra = a.run_steps("ds", data, ["double", "inc"], "wa")
        assert ra.n_skipped == 0
        rb_ = b.run_steps("ds", data, ["double", "inc"], "wb")
        assert rb_.n_skipped >= 1, "second client must reuse the first's prefix"
        assert torch.equal(ra.output, rb_.output)
    finally:
        a.close()
        b.close()


# -- leases and the distributed single-flight -------------------------------------
def test_lease_auto_release_on_disconnect(server):
    rb1, rb2 = _fast_backend(server.url), _fast_backend(server.url)
    g1 = rb1.lease_acquire("k", wait=False)
    assert g1.granted
    rb1.close()  # leader dies: server auto-releases with stored=False
    g2 = rb2.lease_acquire("k", wait=True, timeout_s=5)
    try:
        assert g2.granted or not g2.stored
    finally:
        rb2.close()


def test_distributed_singleflight_exactly_once_across_clients(server):
    computes = []
    lock = threading.Lock()

    def make_client():
        rb = _fast_backend(server.url)
        store = IntermediateStore(backend=CachingBackend(rb))
        return rb, store, DistributedSingleFlight(rb, stored_fn=store.has, lease_timeout_s=10)

    clients = [make_client() for _ in range(4)]
    barrier = threading.Barrier(4)
    results = []

    def run(i):
        rb, store, sf = clients[i]

        def produce():
            if store.has("cold-key"):
                return "loaded", _get(store, "cold-key")
            with lock:
                computes.append(i)
            time.sleep(0.1)
            value = torch.arange(16.0)
            store.put("cold-key", value)
            return "computed", value

        barrier.wait()
        (source, value), leader = sf.run("cold-key", produce)
        results.append((i, source, leader, value))

    threads = [threading.Thread(target=run, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    try:
        assert len(computes) == 1, f"expected exactly one compute, got {computes}"
        assert len(results) == 4
        for _, _, _, value in results:
            assert torch.equal(value, torch.arange(16.0))
        assert sum(1 for r in results if r[2]) == 1
    finally:
        for rb, _, _ in clients:
            rb.close()


def test_distributed_singleflight_not_stored_falls_back_to_compute(server):
    n_calls = []
    lock = threading.Lock()

    def make(i):
        rb = _fast_backend(server.url)
        sf = DistributedSingleFlight(rb, stored_fn=None, lease_timeout_s=5)

        def fn():
            with lock:
                n_calls.append(i)
            time.sleep(0.05)
            return i

        return rb, sf, fn

    pairs = [make(i) for i in range(3)]
    barrier = threading.Barrier(3)
    out = []

    def run(i):
        rb, sf, fn = pairs[i]
        barrier.wait()
        value, leader = sf.run("never-stored", fn)
        out.append((i, value, leader))

    threads = [threading.Thread(target=run, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    try:
        assert len(n_calls) == 3
        for i, value, _ in out:
            assert value == i
    finally:
        for rb, _, _ in pairs:
            rb.close()


def test_path_traversal_names_rejected(server):
    rb = _fast_backend(server.url)
    try:
        for name in ("../../evil", "..", "a/b", "c\\d", ""):
            with pytest.raises(RemoteStoreError, match="illegal blob name"):
                rb.write_blob("k", name, b"x")
            with pytest.raises(RemoteStoreError, match="illegal blob name"):
                rb.read_blob("k", name)
            with pytest.raises(RemoteStoreError, match="illegal blob name"):
                rb.write_meta(name, "x")
        root = Path(server.backend.root)
        assert not (root.parent / "evil").exists()
    finally:
        rb.close()


def test_held_lease_survives_pool_churn(server):
    rb = _fast_backend(server.url, max_pool=1)
    rb2 = _fast_backend(server.url)
    try:
        g = rb.lease_acquire("pinned", wait=False)
        assert g.granted

        def churn():
            for _ in range(10):
                rb.exists("nope")

        ts = [threading.Thread(target=churn) for _ in range(4)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        assert not rb2.lease_acquire("pinned", wait=False).granted
        rb.lease_release("pinned", g.token, stored=False)
        assert rb2.lease_acquire("pinned", wait=False).granted
    finally:
        rb.close()
        rb2.close()


# -- the CLI ---------------------------------------------------------------------
def test_serve_cli_starts_serves_and_stops_on_sigterm(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.net.serve", "--root", str(tmp_path / "pool"),
         "--port", "0", "--host", "127.0.0.1"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env, cwd=ROOT)
    try:
        url = None
        deadline = time.monotonic() + 60
        while url is None and time.monotonic() < deadline:
            line = proc.stdout.readline()
            if not line:
                break
            if "store server listening on" in line:
                url = line.split("listening on ")[1].split()[0]
        assert url and url.startswith("tcp://127.0.0.1:"), url
        rb = _fast_backend(url)
        try:
            rb.write_blob("k", "leaf0.bin", b"\x07" * 33)
            assert rb.read_blob("k", "leaf0.bin") == b"\x07" * 33
        finally:
            rb.close()
        assert (tmp_path / "pool").is_dir()
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        proc.stdout.close()
