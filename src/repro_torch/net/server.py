"""``StoreServer`` — the intermediate-data store as a shared daemon.

One server process owns a :class:`~repro.core.backends.StorageBackend` (a
``LocalFSBackend`` in the CLI) and exposes its full contract over the framed
TCP protocol of :mod:`repro.net.protocol`, so any number of workflow
processes share one artifact pool — the fleet-wide denominator the gain-loss
storing model needs (arXiv 2202.06473) and the reuse-across-workers setup
parallel SWfMSs assume (arXiv 1303.7195).

Beyond the byte ops the server provides the two pieces of *coordination*
that cannot live client-side:

  * a **lease table** — the cross-process generalization of the in-process
    :class:`~repro.sched.singleflight.SingleFlight`: the first client to
    ``lease_acquire`` an uncomputed store key becomes the fleet-wide leader;
    later acquirers block until the leader releases (carrying a ``stored``
    bit telling them whether loading or recomputing is next).  Leases held
    by a connection are auto-released when it dies, so a crashed leader
    never wedges the fleet.
  * an **eviction-event stream** — every ``delete`` is broadcast to
    subscribed clients (minus the originator), so each client's
    ``policy.stored`` bookkeeping and read-through cache converge on the
    same view of what still exists.

Every connection is handled by its own thread (handlers mostly block on
socket or disk I/O, where the GIL is released); per-op request counters are
exposed via the ``stats`` op — benchmarks use them to prove cache hits never
touch the network.
"""
from __future__ import annotations

import hashlib
import itertools
import json
import os
import socket
import threading
import time
from typing import Any

from ..catalog.index import CatalogIndex
from ..catalog.records import CatalogQuery, CatalogRecord
from ..core.backends import StorageBackend
from ..obs import tracing as _tracing
from ..obs.metrics import MetricsRegistry
from .protocol import (
    DEFAULT_CHUNK_BYTES,
    MAX_BATCH_OPS,
    MAX_CHUNK_BYTES,
    MAX_HEADER_BYTES,
    MAX_PAYLOAD_BYTES,
    PROTO_VERSION,
    ConnectionClosed,
    ProtocolError,
    digest,
    recv_frame,
    recv_frame_into,
    send_chunk_prefix,
    send_frame,
    send_stream_end,
)

_MAX_LEASE_WAIT_S = 3600.0


class _Lease:
    __slots__ = ("token", "client_id", "event", "stored")

    def __init__(self, token: str, client_id: str) -> None:
        self.token = token
        self.client_id = client_id
        self.event = threading.Event()
        self.stored = False


class _Conn:
    """Per-connection server state (socket + locks + held leases)."""

    def __init__(self, sock: socket.socket, peer: Any) -> None:
        self.sock = sock
        self.peer = peer
        self.send_lock = threading.Lock()  # event pushes race with responses
        self.client_id = ""
        self.leases: set[tuple[str, str]] = set()  # (key, token)
        self.subscriber = False

    def send(
        self, header: dict[str, Any], payload: bytes = b"", *,
        timeout_s: float | None = None,
    ) -> None:
        with self.send_lock:
            if timeout_s is not None:
                self.sock.settimeout(timeout_s)
            try:
                send_frame(self.sock, header, payload)
            finally:
                if timeout_s is not None:
                    self.sock.settimeout(None)


class StoreServer:
    """Threaded TCP daemon exposing a ``StorageBackend`` plus coordination."""

    def __init__(
        self,
        backend: StorageBackend,
        host: str = "127.0.0.1",
        port: int = 0,
        registry: MetricsRegistry | None = None,
        trace_service: str | None = None,
    ) -> None:
        self.backend = backend
        self.host = host
        self.port = port
        # service name stamped on this server's spans — in-process test
        # clusters give each shard its own so stitched traces can tell the
        # shards apart even under one pid
        self.trace_service = trace_service
        self._listener: socket.socket | None = None
        self._accept_thread: threading.Thread | None = None
        self._stopping = threading.Event()
        self._conns_lock = threading.Lock()
        self._conns: set[_Conn] = set()
        self._lease_lock = threading.Lock()
        self._leases: dict[str, _Lease] = {}
        self._token_counter = itertools.count(1)
        # per-op and streaming counters live on the unified metrics registry;
        # ``stats()`` reconstructs its legacy dict shape from the same series
        self.metrics = registry if registry is not None else MetricsRegistry()
        self._m_requests = self.metrics.counter(
            "repro_store_server_requests_total", "requests dispatched, per op", ("op",)
        )
        self._m_stream_chunks = self.metrics.counter(
            "repro_store_server_stream_chunks_total",
            "chunk frames moved by streaming transfers",
            ("dir",),
        )
        self._m_stream_bytes = self.metrics.counter(
            "repro_store_server_stream_bytes_total",
            "payload bytes moved by streaming transfers",
            ("dir",),
        )
        self._m_stream_events = self.metrics.counter(
            "repro_store_server_stream_events_total",
            "streaming milestones (streamed_writes, sendfile_reads, spill_aborts, ...)",
            ("event",),
        )
        # pre-bound children: the per-chunk path must not pay a label lookup
        self._m_chunks_in = self._m_stream_chunks.labels(dir="in")
        self._m_chunks_out = self._m_stream_chunks.labels(dir="out")
        self._m_bytes_in = self._m_stream_bytes.labels(dir="in")
        self._m_bytes_out = self._m_stream_bytes.labels(dir="out")
        self.metrics.gauge(
            "repro_store_server_connections", "live client connections"
        ).unlabeled.set_function(lambda: len(self._conns))
        self.metrics.gauge(
            "repro_store_server_active_leases", "keys currently leased"
        ).unlabeled.set_function(lambda: len(self._leases))
        self.metrics.gauge(
            "repro_store_server_subscribers", "connections subscribed to events"
        ).unlabeled.set_function(
            lambda: sum(1 for c in list(self._conns) if c.subscriber)
        )
        self.metrics.gauge(
            "repro_store_server_catalog_records", "records in the catalog slice"
        ).unlabeled.set_function(lambda: len(self.catalog))
        self.metrics.gauge(
            "repro_store_server_uptime_seconds", "seconds since start()"
        ).unlabeled.set_function(lambda: time.monotonic() - self._started_at)
        # digest sidecar: content digests recorded at verified writes, so a
        # chunked read can skip the server-side SHA-256 pass (the client's
        # incremental fold is the end-to-end check) and go through
        # ``os.sendfile`` without the bytes ever entering userspace.  Purely
        # an optimization cache: lazily repopulated by folding reads after a
        # restart, dropped on delete.
        self._digest_lock = threading.Lock()
        self._digests: dict[tuple[str, str], str] = {}
        # server-side catalog slice: the provenance index for the artifacts
        # this shard holds.  Lives here (not client-side) so it survives
        # client churn; persisted as catalog.json through the backend with
        # the same batched-flush discipline as the store's index.json.
        self.catalog = CatalogIndex()
        self.catalog_flush_every = 64
        self._catalog_flushed = 0
        # monotonic, not wall: uptime and every lease-wait deadline in this
        # process must be immune to NTP steps — a wall-clock jump must never
        # expire (or extend) a lease or report negative uptime
        self._started_at = time.monotonic()

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "StoreServer":
        if self._listener is not None:
            raise RuntimeError("server already started")
        self._stopping.clear()
        self._load_catalog()
        ls = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        ls.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        ls.bind((self.host, self.port))
        ls.listen(128)
        # a thread blocked in accept() holds the socket open past close()
        # (Linux), pinning the port; a timeout lets it observe _stopping
        ls.settimeout(0.2)
        self.port = ls.getsockname()[1]
        self._listener = ls
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="store-accept", daemon=True
        )
        self._accept_thread.start()
        return self

    def stop(self) -> None:
        """Close the listener and every live connection; wake lease waiters."""
        self._stopping.set()
        if self._listener is not None:
            if self._accept_thread is not None:
                self._accept_thread.join(timeout=2)  # drain a blocked accept()
            try:
                self._listener.close()
            except OSError:
                pass
            self._listener = None
        with self._conns_lock:
            conns = list(self._conns)
        for conn in conns:
            self._drop_conn(conn)
        if self._accept_thread is not None:
            self._accept_thread.join(timeout=5)
            self._accept_thread = None
        self._flush_catalog()

    def wait(self) -> None:
        """Block until :meth:`stop` is called (signal handler, other thread)."""
        while not self._stopping.wait(0.5):
            pass

    def serve_forever(self) -> None:
        self.start()
        try:
            self.wait()
        finally:
            self.stop()

    def __enter__(self) -> "StoreServer":
        return self.start()

    def __exit__(self, *exc: Any) -> None:
        self.stop()

    @property
    def url(self) -> str:
        return f"tcp://{self.host}:{self.port}"

    # -- accept / per-connection loop ---------------------------------------
    def _accept_loop(self) -> None:
        assert self._listener is not None
        listener = self._listener
        while not self._stopping.is_set():
            try:
                sock, peer = listener.accept()
            except socket.timeout:
                continue
            except OSError:  # listener closed by stop()
                return
            sock.settimeout(None)  # accept()ed sockets inherit the timeout
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            conn = _Conn(sock, peer)
            with self._conns_lock:
                self._conns.add(conn)
            threading.Thread(
                target=self._serve_conn, args=(conn,), name="store-conn", daemon=True
            ).start()

    def _drop_conn(self, conn: _Conn) -> None:
        with self._conns_lock:
            self._conns.discard(conn)
        # a dead leader must not wedge its followers: auto-release with
        # stored=False so waiters recompute (or re-elect) instead of hanging.
        # Snapshot under the lease lock (the serve thread mutates the set
        # under it too), release outside (the lock is not reentrant).
        with self._lease_lock:
            held = list(conn.leases)
            conn.leases.clear()
        for key, token in held:
            self._release_lease(key, token, stored=False)
        try:
            conn.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            conn.sock.close()
        except OSError:
            pass

    def _serve_conn(self, conn: _Conn) -> None:
        try:
            while not self._stopping.is_set():
                try:
                    header, payload = recv_frame(conn.sock)
                except ConnectionClosed:
                    return
                except (ProtocolError, OSError):
                    # truncated/garbled frame: this connection's framing is
                    # unrecoverable — drop it; other connections are unharmed
                    return
                try:
                    self._dispatch(conn, header, payload)
                except (ProtocolError, OSError):
                    # a tear mid-op (chunk stream truncated, peer vanished):
                    # framing is unrecoverable — drop the connection quietly;
                    # the op's own cleanup (spill abort) already ran
                    return
        finally:
            self._drop_conn(conn)

    # -- request dispatch -----------------------------------------------------
    def _count_stream(self, what: str, n: int = 1) -> None:
        self._m_stream_events.labels(event=what).inc(n)

    def _dispatch(self, conn: _Conn, req: dict[str, Any], payload: bytes) -> None:
        op = req.get("op", "")
        self._m_requests.labels(op=op).inc()
        # adopt the caller's trace context when the request carries one (the
        # optional ``tp`` field — absent from old clients, ignored by old
        # servers) so the server-side span stitches under the caller's trace
        ctx = _tracing.TraceContext.from_traceparent(req.get("tp"))
        sp = (
            _tracing.span(f"store.{op}", kind="server", parent=ctx,
                          svc=self.trace_service)
            if ctx is not None
            else _tracing.NOOP_SPAN
        )
        try:
            with sp:
                handler = getattr(self, f"_op_{op}", None)
                if handler is None:
                    conn.send(
                        {"ok": False, "error": f"unknown op {op!r}", "kind": "bad_op"}
                    )
                    return
                handler(conn, req, payload)
        except (KeyError, FileNotFoundError) as e:
            conn.send({"ok": False, "error": str(e), "kind": "not_found"})
        except (BrokenPipeError, ConnectionResetError):
            raise
        except ProtocolError:
            # a tear *inside* a chunk stream: the connection's framing state
            # is gone — it must be dropped, never answered (the per-op spill
            # cleanup already ran via the handler's try/finally)
            raise
        except Exception as e:  # noqa: BLE001 - fault isolation per request
            conn.send({"ok": False, "error": f"{type(e).__name__}: {e}", "kind": "server"})

    @staticmethod
    def _bad_name(name: Any) -> bool:
        """Blob/meta names are joined into filesystem paths by the backend;
        a network client must never be able to traverse outside the root."""
        return (
            not isinstance(name, str)
            or not name
            or "/" in name
            or "\\" in name
            or "\x00" in name
            or name in (".", "..")
        )

    def _check_name(self, conn: _Conn, req: dict[str, Any]) -> str | None:
        name = req.get("name")
        if self._bad_name(name):
            conn.send(
                {"ok": False, "error": f"illegal blob name {name!r}", "kind": "bad_name"}
            )
            return None
        return name

    # -- digest sidecar --------------------------------------------------------
    def _record_digest(self, key: str, name: str, hexd: str) -> None:
        with self._digest_lock:
            self._digests[(key, name)] = hexd

    def _known_digest(self, key: str, name: str) -> str | None:
        with self._digest_lock:
            return self._digests.get((key, name))

    def _forget_digests(self, key: str) -> None:
        with self._digest_lock:
            for k in [k for k in self._digests if k[0] == key]:
                del self._digests[k]

    # -- storage ops ----------------------------------------------------------
    def _op_write_blob(self, conn: _Conn, req: dict[str, Any], payload: bytes) -> None:
        name = self._check_name(conn, req)
        if name is None:
            return
        want = req.get("digest")
        if want is not None and digest(payload) != want:
            conn.send(
                {"ok": False, "error": "payload digest mismatch", "kind": "integrity"}
            )
            return
        n = self.backend.write_blob(req["key"], name, payload)
        if want is not None:
            self._record_digest(req["key"], name, want)
        conn.send({"ok": True, "nbytes": n})

    def _op_read_blob(self, conn: _Conn, req: dict[str, Any], payload: bytes) -> None:
        name = self._check_name(conn, req)
        if name is None:
            return
        key = req["key"]
        if req.get("accept_chunked"):
            # v2 client: stream large blobs; small ones still go one-shot
            # (same fields as a v1 response, so the client's fallback parse
            # is trivial).  A v1 server never sees accept_chunked — unknown
            # request fields are ignored — which is the whole read-side
            # negotiation: none needed.
            stream_min = int(req.get("stream_min_bytes", 0))
            reader = self.backend.open_blob_reader(key, name)
            with reader:
                if reader.size >= stream_min:
                    self._stream_blob(conn, req, key, name, reader)
                    return
                data = reader.raw.read()
            hexd = digest(data)
            self._record_digest(key, name, hexd)
            conn.send({"ok": True, "digest": hexd}, data)
            return
        data = self.backend.read_blob(key, name)
        hexd = digest(data)
        self._record_digest(key, name, hexd)
        conn.send({"ok": True, "digest": hexd}, data)

    def _stream_blob(self, conn, req, key: str, name: str, reader) -> None:
        """Chunked read response: ``{"ok","chunked","size"}`` then chunk
        frames and an end frame.  When the sidecar already knows the content
        digest the payload goes through ``os.sendfile`` (zero-copy, no SHA
        pass — the client's fold is the end-to-end check); otherwise we read
        through one bounded buffer, folding as we go, and the fold both
        terminates this stream and repopulates the sidecar."""
        size = reader.size
        chunk_bytes = max(
            1, min(int(req.get("chunk_bytes", DEFAULT_CHUNK_BYTES)), MAX_CHUNK_BYTES)
        )
        known = self._known_digest(key, name)
        fd = None
        if known is not None and hasattr(os, "sendfile"):
            try:
                fd = reader.fileno()
            except (OSError, ValueError, AttributeError):
                fd = None  # memory-backed reader: fall through to the copy loop
        with conn.send_lock:  # one frame sequence, never interleaved
            send_frame(conn.sock, {"ok": True, "chunked": True, "size": size})
            try:
                if fd is not None:
                    offset = 0
                    while offset < size:
                        n = min(chunk_bytes, size - offset)
                        send_chunk_prefix(conn.sock, n)
                        sent = 0
                        while sent < n:
                            sent += os.sendfile(
                                conn.sock.fileno(), fd, offset + sent, n - sent
                            )
                        offset += n
                        self._m_chunks_out.inc()
                        self._m_bytes_out.inc(n)
                    send_stream_end(conn.sock, digest_hex=known)
                    self._count_stream("sendfile_reads")
                else:
                    buf = bytearray(chunk_bytes)
                    view = memoryview(buf)
                    sha = hashlib.sha256()
                    sent = 0
                    while sent < size:
                        n = reader.readinto(view)
                        if n <= 0:
                            raise OSError(
                                f"blob {key}/{name} shrank mid-read "
                                f"({sent} of {size} bytes)"
                            )
                        n = min(n, size - sent)
                        sha.update(view[:n])
                        send_frame(conn.sock, b'{"c":1}', view[:n])
                        sent += n
                        self._m_chunks_out.inc()
                        self._m_bytes_out.inc(n)
                    hexd = sha.hexdigest()
                    self._record_digest(key, name, hexd)
                    send_stream_end(conn.sock, digest_hex=hexd)
                self._count_stream("streamed_reads")
            except (BrokenPipeError, ConnectionResetError, ProtocolError):
                raise
            except OSError as e:
                # backend failure after the ok header went out: the stream
                # grammar's abort frame is the only way to tell the client
                send_stream_end(conn.sock, abort=True, error=str(e), kind="server")

    def _op_write_blob_chunked(
        self, conn: _Conn, req: dict[str, Any], payload: bytes
    ) -> None:
        """v2 chunked PUT.  Handshake: this request -> ready ack -> chunk
        frames -> end frame (digest) -> commit response.  The ready ack is
        the negotiation: a v1 server answers ``bad_op`` *before* the client
        has streamed anything, so falling back costs one round trip, not one
        blob.  Bytes append to a :class:`BlobWriter` (spill file on the FS
        backend) — nothing is visible to ``exists``/``read_blob`` until the
        folded digest checks out and the writer commits."""
        name = self._check_name(conn, req)
        if name is None:
            return
        key = req["key"]
        try:
            size = int(req["size"])
        except (KeyError, TypeError, ValueError):
            conn.send({"ok": False, "error": "bad or missing size", "kind": "bad_op"})
            return
        if size < 0 or size > MAX_PAYLOAD_BYTES:
            conn.send({"ok": False, "error": f"size out of range: {size}", "kind": "bad_op"})
            return
        chunk_bytes = max(
            1, min(int(req.get("chunk_bytes", DEFAULT_CHUNK_BYTES)), MAX_CHUNK_BYTES)
        )
        conn.send({"ok": True, "ready": True})
        writer = self.backend.open_blob_writer(key, name)
        committed = False
        try:
            buf = bytearray(chunk_bytes)
            view = memoryview(buf)
            sha = hashlib.sha256()
            got = 0
            while True:
                header, n = recv_frame_into(conn.sock, view)
                if header.get("end"):
                    break
                if got + n > size:
                    # the peer lied about size; framing trust is gone
                    raise ProtocolError(
                        f"stream overran its announced {size} bytes"
                    )
                if n:
                    sha.update(view[:n])
                    writer.write(view[:n])
                    got += n
                    self._m_chunks_in.inc()
                    self._m_bytes_in.inc(n)
            if header.get("abort"):
                conn.send(
                    {
                        "ok": False,
                        "error": header.get("error") or "client aborted stream",
                        "kind": "aborted",
                    }
                )
                return
            if got != size:
                conn.send(
                    {
                        "ok": False,
                        "error": f"stream ended at {got} of {size} bytes",
                        "kind": "protocol",
                    }
                )
                return
            folded = sha.hexdigest()
            want = header.get("digest")
            if want is not None and want != folded:
                conn.send(
                    {"ok": False, "error": "stream digest mismatch", "kind": "integrity"}
                )
                return
            nbytes = writer.commit()
            committed = True
            self._record_digest(key, name, folded)
            self._count_stream("streamed_writes")
            conn.send({"ok": True, "nbytes": nbytes})
        finally:
            if not committed:
                # torn stream, overrun, digest mismatch, backend error: the
                # spill file is reclaimed and no partial blob ever landed
                writer.abort()
                self._count_stream("spill_aborts")

    def _op_delete(self, conn: _Conn, req: dict[str, Any], payload: bytes) -> None:
        key = req["key"]
        self.backend.delete(key)
        self._forget_digests(key)
        # keep the provenance index consistent with the blobs it describes:
        # an evicted artifact must never be reported as present by a query
        if self.catalog.discard(key):
            self._catalog_dirty()
        conn.send({"ok": True})
        self._broadcast(
            {"event": "evicted", "key": key}, skip_client=req.get("client_id", "")
        )

    def _op_exists(self, conn: _Conn, req: dict[str, Any], payload: bytes) -> None:
        conn.send({"ok": True, "exists": bool(self.backend.exists(req["key"]))})

    def _op_write_meta(self, conn: _Conn, req: dict[str, Any], payload: bytes) -> None:
        name = self._check_name(conn, req)
        if name is None:
            return
        self.backend.write_meta(name, payload.decode())
        conn.send({"ok": True})

    def _op_read_meta(self, conn: _Conn, req: dict[str, Any], payload: bytes) -> None:
        name = self._check_name(conn, req)
        if name is None:
            return
        text = self.backend.read_meta(name)
        if text is None:
            conn.send({"ok": True, "none": True})
        else:
            conn.send({"ok": True}, text.encode())

    def _op_nbytes(self, conn: _Conn, req: dict[str, Any], payload: bytes) -> None:
        conn.send({"ok": True, "nbytes": int(self.backend.nbytes(req["key"]))})

    # -- v2: negotiation + batched small ops ----------------------------------
    def _op_hello(self, conn: _Conn, req: dict[str, Any], payload: bytes) -> None:
        conn.send(
            {
                "ok": True,
                "proto": PROTO_VERSION,
                "features": ["chunked", "batch", "catalog", "metrics"],
            }
        )

    # only cheap presence/metadata probes may ride in a batch: a blob op in
    # the middle of a coalesced round trip would re-serialize the data plane
    # behind metadata traffic
    _BATCH_SUBOPS = frozenset({"exists", "read_meta", "nbytes", "ping"})
    # one read_meta result above this is returned as kind="too_large" instead
    # of blowing the 1 MiB response-header cap when many ride together
    _BATCH_META_BYTES = 256 << 10

    def _op_batch(self, conn: _Conn, req: dict[str, Any], payload: bytes) -> None:
        ops = req.get("ops")
        if not isinstance(ops, list):
            conn.send({"ok": False, "error": "batch needs an ops list", "kind": "bad_op"})
            return
        if len(ops) > MAX_BATCH_OPS:
            conn.send(
                {
                    "ok": False,
                    "error": f"batch of {len(ops)} exceeds {MAX_BATCH_OPS} sub-ops",
                    "kind": "bad_op",
                }
            )
            return
        self._count_stream("batch_subops", len(ops))
        results = []
        budget = MAX_HEADER_BYTES - (64 << 10)  # response-header headroom
        for sub in ops:
            results.append(self._batch_one(sub, budget))
            if results[-1].get("ok") and "text" in results[-1]:
                budget -= len(results[-1]["text"])
        conn.send({"ok": True, "results": results})

    def _batch_one(self, sub: Any, budget: int) -> dict[str, Any]:
        if not isinstance(sub, dict):
            return {"ok": False, "error": "sub-op must be an object", "kind": "bad_op"}
        op = sub.get("op", "")
        if op not in self._BATCH_SUBOPS:
            return {
                "ok": False,
                "error": f"op {op!r} not allowed in a batch",
                "kind": "bad_op",
            }
        try:
            if op == "ping":
                return {"ok": True, "pong": True}
            if op == "exists":
                return {"ok": True, "exists": bool(self.backend.exists(sub["key"]))}
            if op == "nbytes":
                return {"ok": True, "nbytes": int(self.backend.nbytes(sub["key"]))}
            # read_meta: the result rides inline in the response header, so
            # oversized values must bounce (client retries them singularly)
            name = sub.get("name")
            if self._bad_name(name):
                return {
                    "ok": False,
                    "error": f"illegal blob name {name!r}",
                    "kind": "bad_name",
                }
            text = self.backend.read_meta(name)
            if text is None:
                return {"ok": True, "none": True}
            if len(text) > min(self._BATCH_META_BYTES, max(budget, 0)):
                return {
                    "ok": False,
                    "error": f"meta {name!r} too large for a batch response",
                    "kind": "too_large",
                }
            return {"ok": True, "text": text}
        except (KeyError, FileNotFoundError) as e:
            return {"ok": False, "error": str(e), "kind": "not_found"}
        except Exception as e:  # noqa: BLE001 - per-sub-op fault isolation
            return {"ok": False, "error": f"{type(e).__name__}: {e}", "kind": "server"}

    # -- catalog ops -----------------------------------------------------------
    # one query's results ride in the response header (1 MiB cap): bound them
    _CATALOG_MAX_LIMIT = 1000

    def _load_catalog(self) -> None:
        """Restore the persisted catalog slice, pruning records whose
        artifacts vanished while the server was down (crashed writer, disk
        wipe) — the index must never promise a blob the backend lost."""
        try:
            raw = self.backend.read_meta("catalog.json")
        except Exception:  # noqa: BLE001 - a damaged snapshot must not stop startup
            return
        if not raw:
            return
        try:
            docs = json.loads(raw)
        except json.JSONDecodeError:
            return
        if isinstance(docs, list):
            self.catalog.load(docs)
            try:
                self.catalog.prune(self.backend.exists)
            except Exception:  # noqa: BLE001
                pass
        self._catalog_flushed = self.catalog.mutations

    def _flush_catalog(self) -> None:
        if self.catalog.mutations == self._catalog_flushed:
            return
        try:
            self.backend.write_meta("catalog.json", json.dumps(self.catalog.snapshot()))
        except Exception:  # noqa: BLE001 - persistence is a cache, not truth
            return
        self._catalog_flushed = self.catalog.mutations

    def _catalog_dirty(self) -> None:
        if self.catalog.mutations - self._catalog_flushed >= self.catalog_flush_every:
            self._flush_catalog()

    def _op_catalog_put(self, conn: _Conn, req: dict[str, Any], payload: bytes) -> None:
        doc = req.get("doc")
        if not isinstance(doc, dict):
            conn.send({"ok": False, "error": "catalog_put needs a doc", "kind": "bad_op"})
            return
        try:
            rec = CatalogRecord.from_doc(doc)
        except (KeyError, ValueError, TypeError) as e:
            conn.send({"ok": False, "error": f"bad catalog doc: {e}", "kind": "bad_op"})
            return
        self.catalog.upsert(rec)
        self._catalog_dirty()
        conn.send({"ok": True})

    def _op_catalog_remove(self, conn: _Conn, req: dict[str, Any], payload: bytes) -> None:
        removed = self.catalog.discard(req["key"])
        if removed:
            self._catalog_dirty()
        conn.send({"ok": True, "removed": removed})

    def _op_catalog_query(self, conn: _Conn, req: dict[str, Any], payload: bytes) -> None:
        try:
            q = CatalogQuery.from_doc(req.get("query") or {})
        except (ValueError, TypeError) as e:
            conn.send({"ok": False, "error": f"bad catalog query: {e}", "kind": "bad_op"})
            return
        q.limit = min(q.limit, self._CATALOG_MAX_LIMIT)
        results = [r.to_doc() for r in self.catalog.query(q)]
        conn.send({"ok": True, "results": results, "total": len(self.catalog)})

    # -- coordination ops ------------------------------------------------------
    def _op_lease_acquire(self, conn: _Conn, req: dict[str, Any], payload: bytes) -> None:
        key = req["key"]
        client_id = req.get("client_id", "")
        wait = bool(req.get("wait", True))
        timeout = min(float(req.get("timeout", 300.0)), _MAX_LEASE_WAIT_S)
        with self._lease_lock:
            lease = self._leases.get(key)
            if lease is None:
                token = f"t{next(self._token_counter)}"
                self._leases[key] = _Lease(token, client_id)
                conn.leases.add((key, token))
        if lease is None:
            # send OUTSIDE the lease lock: a client with a full receive
            # window must never wedge fleet-wide lease traffic
            conn.send({"ok": True, "granted": True, "token": token})
            return
        if not wait:
            conn.send({"ok": True, "granted": False, "waited": False})
            return
        # block this handler thread (connection-per-thread makes that safe)
        # until the leader releases; the stored bit tells the waiter whether
        # the artifact landed (load it) or not (become the next leader).
        # Event.wait computes its deadline from the monotonic clock, so an
        # NTP step can neither cut a lease wait short nor stretch it.
        if lease.event.wait(timeout):
            conn.send({"ok": True, "granted": False, "stored": lease.stored})
        else:
            conn.send({"ok": True, "granted": False, "stored": False, "timeout": True})

    def _op_lease_release(self, conn: _Conn, req: dict[str, Any], payload: bytes) -> None:
        key, token = req["key"], req.get("token", "")
        self._release_lease(key, token, stored=bool(req.get("stored", False)))
        with self._lease_lock:
            conn.leases.discard((key, token))
        # releasing an unknown/expired lease is a no-op: the client may be
        # replaying after a reconnect that already auto-released it
        conn.send({"ok": True})

    def _release_lease(self, key: str, token: str, stored: bool) -> None:
        with self._lease_lock:
            lease = self._leases.get(key)
            if lease is None or lease.token != token:
                return
            del self._leases[key]
        lease.stored = stored
        lease.event.set()

    def _op_subscribe(self, conn: _Conn, req: dict[str, Any], payload: bytes) -> None:
        conn.client_id = req.get("client_id", "")
        conn.subscriber = True
        conn.send({"ok": True})

    def _broadcast(self, event: dict[str, Any], skip_client: str = "") -> None:
        with self._conns_lock:
            subs = [c for c in self._conns if c.subscriber]
        for sub in subs:
            if skip_client and sub.client_id == skip_client:
                continue  # originator already handled it locally
            try:
                # bounded send: a subscriber that stopped draining its socket
                # must not wedge the deleting connection (and, through its
                # send_lock, every later broadcast) — drop it instead
                sub.send(event, timeout_s=5.0)
            except OSError:  # includes socket.timeout
                self._drop_conn(sub)

    # -- introspection ---------------------------------------------------------
    def stats(self) -> dict[str, Any]:
        """Legacy dict-shaped snapshot, now a **deprecated alias** view
        reconstructed from the unified metrics registry (the canonical
        surface is the ``metrics`` op / ``repro_store_server_*`` series —
        see ``repro/obs/naming.py`` for the pinned key mapping)."""
        counts = {
            s["labels"]["op"]: int(s["value"] or 0)
            for s in self._m_requests.series()
        }
        streaming: dict[str, int] = {}
        for s in self._m_stream_chunks.series():
            streaming[f"chunks_{s['labels']['dir']}"] = int(s["value"] or 0)
        for s in self._m_stream_bytes.series():
            streaming[f"bytes_{s['labels']['dir']}"] = int(s["value"] or 0)
        for s in self._m_stream_events.series():
            streaming[s["labels"]["event"]] = int(s["value"] or 0)
        with self._lease_lock:
            n_leases = len(self._leases)
        with self._conns_lock:
            n_conns = len(self._conns)
            n_subs = sum(1 for c in self._conns if c.subscriber)
        return {
            "proto": PROTO_VERSION,
            "requests": sum(counts.values()),
            "ops": counts,
            "streaming": streaming,
            "active_leases": n_leases,
            "connections": n_conns,
            "subscribers": n_subs,
            "catalog_records": len(self.catalog),
            "uptime_s": time.monotonic() - self._started_at,
        }

    def _op_stats(self, conn: _Conn, req: dict[str, Any], payload: bytes) -> None:
        conn.send({"ok": True, "stats": self.stats()})

    def _op_metrics(self, conn: _Conn, req: dict[str, Any], payload: bytes) -> None:
        """Canonical introspection surface: the full registry doc, mergeable
        across shards (``ShardedBackend.metrics_doc`` fans this out)."""
        conn.send({"ok": True, "metrics": self.metrics.to_doc()})

    def _op_ping(self, conn: _Conn, req: dict[str, Any], payload: bytes) -> None:
        conn.send({"ok": True, "pong": True})
