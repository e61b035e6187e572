"""``RemoteBackend`` — the store-server client, a drop-in ``StorageBackend``.

``IntermediateStore(backend=RemoteBackend("tcp://host:7077"))`` gives any
process a view onto the shared artifact pool with *zero* changes above the
backend seam: serialization, manifests, codecs, eviction accounting, and
policy bookkeeping all keep running client-side; only bytes cross the wire.

Transport properties:

  * **connection pool** — concurrent scheduler threads each check out a
    socket (dialing on demand), so a long lease wait never blocks unrelated
    reads;
  * **reconnect-and-retry** — every request is idempotent at the server, so
    transport failures (server restart, dropped conn, truncated frame)
    are retried on a fresh connection with exponential backoff before an
    error ever reaches the store;
  * **digest verification** — blob reads carry the server's SHA-256 and are
    re-fetched once on mismatch, then fail loudly with ``IntegrityError``;
  * **event subscription** — an optional dedicated connection streams
    server-side eviction events to registered listeners (the store's
    ``on_external_evict``, the read-through cache's ``invalidate``), with
    automatic resubscription after a server restart.
"""
from __future__ import annotations

import socket
import threading
import time
import uuid
from typing import Any, Callable, Iterable, NoReturn

from ..core.backends import StorageBackend
from ..obs import tracing as _tracing
from ..obs.metrics import MetricsRegistry
from .protocol import (
    DEFAULT_CHUNK_BYTES,
    MAX_BATCH_OPS,
    ConnectionClosed,
    IntegrityError,
    ProtocolError,
    RemoteStoreError,
    StoreUnreachable,
    digest,
    parse_url,
    recv_blob_stream,
    recv_frame,
    send_blob_stream,
    send_frame,
)


class LeaseGrant:
    """Outcome of one ``lease_acquire`` round."""

    __slots__ = ("granted", "token", "stored", "timed_out")

    def __init__(self, granted: bool, token: str = "", stored: bool = False,
                 timed_out: bool = False) -> None:
        self.granted = granted
        self.token = token
        self.stored = stored
        self.timed_out = timed_out


class RemoteBackend(StorageBackend):
    """TCP client for a :class:`~repro.net.server.StoreServer`."""

    name = "remote"

    def __init__(
        self,
        url: str,
        *,
        client_id: str | None = None,
        connect_timeout_s: float = 5.0,
        op_timeout_s: float = 120.0,
        retries: int = 5,
        retry_backoff_s: float = 0.05,
        max_pool: int = 8,
        stream_threshold: int = 1 << 20,
        chunk_bytes: int = DEFAULT_CHUNK_BYTES,
        registry: MetricsRegistry | None = None,
    ) -> None:
        self.host, self.port = parse_url(url)
        self.client_id = client_id or f"c-{uuid.uuid4().hex[:12]}"
        self.connect_timeout_s = connect_timeout_s
        self.op_timeout_s = op_timeout_s
        self.retries = retries
        self.retry_backoff_s = retry_backoff_s
        self.max_pool = max_pool
        # blobs at/above stream_threshold travel chunked (wire v2) when the
        # server supports it; negotiation is lazy — the first bad_op reply
        # marks the server v1 and every later op goes one-shot/pipelined
        self.stream_threshold = stream_threshold
        self.chunk_bytes = chunk_bytes
        self._server_proto: int | None = None  # None = not yet probed
        self._server_catalog: bool | None = None  # None = not yet probed
        self._pool: list[socket.socket] = []
        self._pool_lock = threading.Lock()
        self._lease_lock = threading.Lock()
        self._lease_socks: dict[tuple[str, str], socket.socket] = {}
        self._closed = False
        self._listeners: list[Callable[[str, str], None]] = []
        self._listener_lock = threading.Lock()
        self._event_thread: threading.Thread | None = None
        self._event_sock: socket.socket | None = None
        # transport counters live on the unified registry, shard-labeled so a
        # multi-shard client's series stay distinguishable after a merge; the
        # legacy attribute names below are read-only aliases
        self.metrics = registry if registry is not None else MetricsRegistry()
        self._shard = f"{self.host}:{self.port}"
        lbl = {"shard": self._shard}
        self._m_reconnects = self.metrics.counter(
            "repro_remote_reconnects_total", "transport-level redials", ("shard",)
        ).labels(**lbl)
        self._m_streamed_writes = self.metrics.counter(
            "repro_remote_streamed_writes_total",
            "blobs written via chunked streaming",
            ("shard",),
        ).labels(**lbl)
        self._m_streamed_reads = self.metrics.counter(
            "repro_remote_streamed_reads_total",
            "blobs read via chunked streaming",
            ("shard",),
        ).labels(**lbl)
        self._m_batched = self.metrics.counter(
            "repro_remote_batched_requests_total",
            "batch round trips issued",
            ("shard",),
        ).labels(**lbl)
        self._m_rpc_seconds = self.metrics.histogram(
            "repro_remote_rpc_seconds", "remote RPC round-trip time", ("op", "shard")
        )

    # -- deprecated counter aliases ---------------------------------------------
    @property
    def reconnects(self) -> int:
        """Deprecated alias of ``repro_remote_reconnects_total{shard}``."""
        return int(self._m_reconnects.value)

    @property
    def streamed_writes(self) -> int:
        """Deprecated alias of ``repro_remote_streamed_writes_total{shard}``."""
        return int(self._m_streamed_writes.value)

    @property
    def streamed_reads(self) -> int:
        """Deprecated alias of ``repro_remote_streamed_reads_total{shard}``."""
        return int(self._m_streamed_reads.value)

    @property
    def batched_requests(self) -> int:
        """Deprecated alias of ``repro_remote_batched_requests_total{shard}``."""
        return int(self._m_batched.value)

    # -- connection management -------------------------------------------------
    def _dial(self) -> socket.socket:
        sock = socket.create_connection(
            (self.host, self.port), timeout=self.connect_timeout_s
        )
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        sock.settimeout(self.op_timeout_s)
        return sock

    def _checkout(self) -> socket.socket:
        with self._pool_lock:
            if self._pool:
                return self._pool.pop()
        return self._dial()

    def _checkin(self, sock: socket.socket) -> None:
        with self._pool_lock:
            if not self._closed and len(self._pool) < self.max_pool:
                sock.settimeout(self.op_timeout_s)  # undo per-request overrides
                self._pool.append(sock)
                return
        try:
            sock.close()
        except OSError:
            pass

    def close(self) -> None:
        self._closed = True
        with self._pool_lock:
            pool, self._pool = self._pool, []
        with self._lease_lock:
            pool += list(self._lease_socks.values())  # server auto-releases
            self._lease_socks.clear()
        for sock in pool:
            try:
                sock.close()
            except OSError:
                pass
        if self._event_sock is not None:
            try:
                self._event_sock.close()
            except OSError:
                pass
        if self._event_thread is not None:
            self._event_thread.join(timeout=2)
            self._event_thread = None

    # -- request core ----------------------------------------------------------
    def _scrap(self, sock: socket.socket) -> None:
        """Discard a socket whose framing state is unknown — and its pooled
        siblings, which are almost certainly from the same dead server epoch,
        rather than letting stale sockets burn through the retry budget one
        by one."""
        with self._pool_lock:
            stale, self._pool = self._pool, []
        for s in [sock, *stale]:
            try:
                s.close()
            except OSError:
                pass

    def _with_retries(self, fn: Callable[[socket.socket], Any]) -> Any:
        """Run ``fn(sock)`` on a pooled socket, redialing on transport
        failure with exponential backoff.  ``fn`` owns the socket for its
        whole call — it may exchange *multiple* frames (a chunked stream, a
        pipelined batch) and every frame of a failed attempt is replayed on
        the fresh socket, which is safe because all ops are idempotent at
        the server."""
        if self._closed:
            raise RemoteStoreError("backend is closed")
        last: Exception | None = None
        for attempt in range(self.retries + 1):
            try:
                sock = self._checkout()
            except OSError as e:  # server down/restarting: back off and redial
                last = e
                self._m_reconnects.inc()
                if attempt < self.retries:  # no pointless sleep before raising
                    time.sleep(self.retry_backoff_s * (2**attempt))
                continue
            try:
                result = fn(sock)
            except (ProtocolError, OSError) as e:
                self._scrap(sock)
                last = e
                self._m_reconnects.inc()
                if attempt < self.retries:  # no pointless sleep before raising
                    time.sleep(self.retry_backoff_s * (2**attempt))
                continue
            self._checkin(sock)
            return result
        raise StoreUnreachable(
            f"store server {self.host}:{self.port} unreachable after "
            f"{self.retries + 1} attempts: {last}"
        ) from last

    def _exchange(
        self,
        header: dict[str, Any],
        payload: bytes = b"",
        *,
        timeout_s: float | None = None,
    ) -> tuple[dict[str, Any], bytes, socket.socket]:
        """One request/response, retrying transport failures on fresh
        sockets.  Returns the (healthy) socket WITHOUT checking it back in —
        the caller decides whether to pool it or pin it."""
        if self._closed:
            raise RemoteStoreError("backend is closed")
        last: Exception | None = None
        for attempt in range(self.retries + 1):
            try:
                sock = self._checkout()
            except OSError as e:  # server down/restarting: back off and redial
                last = e
                self._m_reconnects.inc()
                if attempt < self.retries:  # no pointless sleep before raising
                    time.sleep(self.retry_backoff_s * (2**attempt))
                continue
            try:
                if timeout_s is not None:
                    sock.settimeout(timeout_s)
                send_frame(sock, header, payload)
                resp, data = recv_frame(sock)
            except (ProtocolError, OSError) as e:
                self._scrap(sock)
                last = e
                self._m_reconnects.inc()
                if attempt < self.retries:  # no pointless sleep before raising
                    time.sleep(self.retry_backoff_s * (2**attempt))
                continue
            return resp, data, sock
        raise StoreUnreachable(
            f"store server {self.host}:{self.port} unreachable after "
            f"{self.retries + 1} attempts: {last}"
        ) from last

    @staticmethod
    def _raise_reply(resp: dict[str, Any]) -> NoReturn:
        """Map a server error reply to the typed exception the store layer
        expects.  The reply ``kind`` rides on ``RemoteStoreError`` so callers
        can distinguish a v1 server's ``bad_op`` (fall back) from a real
        failure (raise)."""
        kind = resp.get("kind", "server")
        msg = resp.get("error", "remote store error")
        if kind == "not_found":
            raise KeyError(msg)
        if kind == "integrity":
            raise IntegrityError(msg)
        err = RemoteStoreError(msg)
        err.kind = kind
        raise err

    @staticmethod
    def _stamp(header: dict[str, Any]) -> dict[str, Any]:
        """Attach the current traceparent (``tp``) to an outbound request
        header.  Servers that predate tracing ignore the unknown field; with
        tracing off this is a no-op, so the wire stays byte-identical."""
        tp = _tracing.current_traceparent()
        if tp is not None:
            header["tp"] = tp
        return header

    def _request(
        self,
        header: dict[str, Any],
        payload: bytes = b"",
        *,
        timeout_s: float | None = None,
    ) -> tuple[dict[str, Any], bytes]:
        op = header.get("op", "?")
        t0 = time.perf_counter()
        with _tracing.span("rpc", kind="rpc", op=op, shard=self._shard):
            resp, data, sock = self._exchange(
                self._stamp(header), payload, timeout_s=timeout_s
            )
        self._m_rpc_seconds.labels(op=op, shard=self._shard).observe(
            time.perf_counter() - t0
        )
        self._checkin(sock)
        if resp.get("ok"):
            return resp, data
        self._raise_reply(resp)

    # -- StorageBackend contract -----------------------------------------------
    def write_blob(self, key: str, name: str, data: bytes) -> int:
        if len(data) >= self.stream_threshold and self._server_proto != 1:
            try:
                return self._write_blob_chunked(key, name, data)
            except RemoteStoreError as e:
                if getattr(e, "kind", "") != "bad_op":
                    raise
                # v1 server: remember, fall through to the one-shot path
                self._server_proto = 1
        resp, _ = self._request(
            {"op": "write_blob", "key": key, "name": name, "digest": digest(data)},
            data,
        )
        return int(resp["nbytes"])

    def _write_blob_chunked(self, key: str, name: str, data: bytes) -> int:
        """Chunked PUT: request -> ready ack -> chunk stream -> commit reply.
        The ready ack lands *before* any chunk leaves, so a v1 server's
        ``bad_op`` costs one round trip, not one blob; a torn stream replays
        whole on a fresh socket (server-side commit is atomic + idempotent)."""
        header = self._stamp(
            {
                "op": "write_blob_chunked",
                "key": key,
                "name": name,
                "size": len(data),
                "chunk_bytes": self.chunk_bytes,
            }
        )

        def put(sock: socket.socket) -> dict[str, Any]:
            send_frame(sock, header)
            ack, _ = recv_frame(sock)
            if not ack.get("ok"):
                return ack  # server-reported: not a transport failure
            send_blob_stream(sock, data, self.chunk_bytes)
            final, _ = recv_frame(sock)
            return final

        t0 = time.perf_counter()
        with _tracing.span(
            "rpc", kind="rpc", op="write_blob_chunked", shard=self._shard
        ):
            resp = self._with_retries(put)
        self._m_rpc_seconds.labels(op="write_blob_chunked", shard=self._shard).observe(
            time.perf_counter() - t0
        )
        if not resp.get("ok"):
            self._raise_reply(resp)
        self._m_streamed_writes.inc()
        return int(resp["nbytes"])

    def read_blob(self, key: str, name: str) -> bytes:
        declared, folded, data = self._fetch_blob(key, name)
        if declared != folded:
            # one corrupt transfer is retryable; a corrupt blob at rest is not
            declared, folded, data = self._fetch_blob(key, name)
            if declared != folded:
                raise IntegrityError(f"blob {key}/{name} failed digest verification")
        return data

    def _fetch_blob(self, key: str, name: str) -> tuple[str, str, bytes]:
        """One GET; returns (declared digest, locally computed digest, data).
        The request advertises ``accept_chunked`` — a v2 server streams blobs
        ≥ ``stream_min_bytes`` and we fold SHA-256 as chunks arrive; a v1
        server ignores the unknown fields and answers one-shot.  No
        negotiation round trip either way."""
        req: dict[str, Any] = {"op": "read_blob", "key": key, "name": name}
        if self._server_proto != 1:
            req.update(
                accept_chunked=True,
                stream_min_bytes=self.stream_threshold,
                chunk_bytes=self.chunk_bytes,
            )
        self._stamp(req)

        def get(sock: socket.socket) -> tuple[dict[str, Any], str, bytes]:
            send_frame(sock, req)
            resp, data = recv_frame(sock)
            if not resp.get("ok") or not resp.get("chunked"):
                return resp, digest(data), data
            buf, folded, end = recv_blob_stream(sock, int(resp["size"]))
            if end.get("abort"):
                return end, "", b""  # server-reported mid-stream failure
            resp = dict(resp)
            resp["digest"] = end.get("digest")
            self._m_streamed_reads.inc()
            return resp, folded, bytes(buf)

        t0 = time.perf_counter()
        with _tracing.span("rpc", kind="rpc", op="read_blob", shard=self._shard):
            resp, folded, data = self._with_retries(get)
        self._m_rpc_seconds.labels(op="read_blob", shard=self._shard).observe(
            time.perf_counter() - t0
        )
        if not resp.get("ok"):
            self._raise_reply(resp)
        return resp.get("digest"), folded, data

    def delete(self, key: str) -> None:
        self._request({"op": "delete", "key": key, "client_id": self.client_id})

    def exists(self, key: str) -> bool:
        resp, _ = self._request({"op": "exists", "key": key})
        return bool(resp["exists"])

    def write_meta(self, name: str, text: str) -> None:
        self._request({"op": "write_meta", "name": name}, text.encode())

    def read_meta(self, name: str) -> str | None:
        resp, data = self._request({"op": "read_meta", "name": name})
        if resp.get("none"):
            return None
        return data.decode()

    def nbytes(self, key: str) -> int:
        resp, _ = self._request({"op": "nbytes", "key": key})
        return int(resp["nbytes"])

    # -- v2: batched / pipelined small ops --------------------------------------
    def hello(self) -> dict[str, Any]:
        """Probe the server's protocol version and feature list.  Never
        required — every v2 path negotiates lazily — but callers that want to
        know up front (diagnostics, tests) can ask."""
        try:
            resp, _ = self._request({"op": "hello"})
        except RemoteStoreError as e:
            if getattr(e, "kind", "") != "bad_op":
                raise
            self._server_proto = 1
            return {"proto": 1, "features": []}
        self._server_proto = int(resp.get("proto", 1))
        return {"proto": self._server_proto, "features": resp.get("features", [])}

    def batch(self, ops: list[dict[str, Any]]) -> list[dict[str, Any]]:
        """Coalesce small read-only sub-ops (``exists``/``read_meta``/
        ``nbytes``/``ping``) into one round trip.  Against a v1 server the
        sub-ops are *pipelined* instead — all requests go out back-to-back on
        one socket before the responses are read — so deep probe walks still
        avoid per-op latency stacking.  Returns one result dict per sub-op
        (server errors are captured per-result, not raised)."""
        if not ops:
            return []
        if len(ops) > MAX_BATCH_OPS:
            raise ValueError(f"batch of {len(ops)} exceeds {MAX_BATCH_OPS} sub-ops")
        if self._server_proto != 1:
            try:
                resp, _ = self._request({"op": "batch", "ops": ops})
                self._m_batched.inc()
                results = resp["results"]
                # an oversized read_meta bounces out of the batch: retry it
                # singularly (rare; keeps the response header bounded)
                for i, r in enumerate(results):
                    if not r.get("ok") and r.get("kind") == "too_large":
                        results[i] = self._singular(ops[i])
                return results
            except RemoteStoreError as e:
                if getattr(e, "kind", "") != "bad_op":
                    raise
                self._server_proto = 1
        return self._pipelined(ops)

    def _singular(self, sub: dict[str, Any]) -> dict[str, Any]:
        try:
            resp, data = self._request(dict(sub))
        except KeyError as e:
            return {"ok": False, "error": str(e), "kind": "not_found"}
        except RemoteStoreError as e:
            return {"ok": False, "error": str(e), "kind": getattr(e, "kind", "server")}
        if sub.get("op") == "read_meta" and not resp.get("none"):
            resp = dict(resp)
            resp["text"] = data.decode()
        return resp

    def _pipelined(self, ops: list[dict[str, Any]]) -> list[dict[str, Any]]:
        tp = _tracing.current_traceparent()

        def run(sock: socket.socket) -> list[dict[str, Any]]:
            for sub in ops:
                send_frame(sock, {**sub, "tp": tp} if tp is not None else sub)
            out: list[dict[str, Any]] = []
            for sub in ops:
                resp, data = recv_frame(sock)
                if resp.get("ok") and sub.get("op") == "read_meta" and not resp.get("none"):
                    resp = dict(resp)
                    resp["text"] = data.decode()
                out.append(resp)
            return out

        return self._with_retries(run)

    def exists_many(self, keys: "Iterable[str]") -> dict[str, "bool | None"]:
        """Batched presence probe: one round trip for any number of keys.
        ``None`` marks a key whose presence could not be decided (server
        unreachable or per-key server error) — the store treats those as
        unreachable, never as absent."""
        keys = list(keys)
        if not keys:
            return {}
        out: dict[str, bool | None] = {}
        for start in range(0, len(keys), MAX_BATCH_OPS):
            group = keys[start : start + MAX_BATCH_OPS]
            try:
                results = self.batch([{"op": "exists", "key": k} for k in group])
            except (RemoteStoreError, ProtocolError, OSError):
                for k in group:
                    out[k] = None
                continue
            for k, r in zip(group, results):
                out[k] = bool(r.get("exists")) if r.get("ok") else None
        return out

    # -- catalog ops -------------------------------------------------------------
    # Transport failures and pre-catalog servers degrade, never raise: the
    # catalog is a discovery surface riding on operations (admission, delete)
    # that already succeeded — mirroring it must not fail them.  A server
    # answering ``bad_op`` is remembered so later ops skip the round trip.
    def catalog_put(self, doc: dict[str, Any]) -> bool:
        """Upsert one record into the server-side catalog.  False when the
        server predates the op family or is unreachable."""
        if self._server_catalog is False:
            return False
        try:
            self._request({"op": "catalog_put", "doc": doc})
        except StoreUnreachable:
            return False
        except RemoteStoreError as e:
            if getattr(e, "kind", "") != "bad_op":
                raise
            self._server_catalog = False
            return False
        self._server_catalog = True
        return True

    def catalog_remove(self, key: str) -> bool:
        """Drop one record from the server-side catalog (idempotent)."""
        if self._server_catalog is False:
            return False
        try:
            self._request({"op": "catalog_remove", "key": key})
        except StoreUnreachable:
            return False
        except RemoteStoreError as e:
            if getattr(e, "kind", "") != "bad_op":
                raise
            self._server_catalog = False
            return False
        self._server_catalog = True
        return True

    def catalog_query(self, query_doc: dict[str, Any]) -> "list[dict[str, Any]] | None":
        """Run a catalog query server-side.  ``None`` (vs ``[]``) means the
        answer is unavailable — pre-catalog server or pool unreachable — so
        the caller can fall back to its local view."""
        if self._server_catalog is False:
            return None
        try:
            resp, _ = self._request({"op": "catalog_query", "query": query_doc})
        except StoreUnreachable:
            return None
        except RemoteStoreError as e:
            if getattr(e, "kind", "") != "bad_op":
                raise
            self._server_catalog = False
            return None
        self._server_catalog = True
        return list(resp.get("results", ()))

    # -- coordination ----------------------------------------------------------
    def lease_acquire(
        self, key: str, *, wait: bool = True, timeout_s: float = 300.0
    ) -> LeaseGrant:
        resp, _, sock = self._exchange(
            self._stamp(
                {
                    "op": "lease_acquire",
                    "key": key,
                    "client_id": self.client_id,
                    "wait": wait,
                    "timeout": timeout_s,
                }
            ),
            # the socket must outlive the server-side blocking wait
            timeout_s=timeout_s + 30.0,
        )
        if not resp.get("ok"):
            self._checkin(sock)
            raise RemoteStoreError(resp.get("error", "lease_acquire failed"))
        grant = LeaseGrant(
            granted=bool(resp.get("granted")),
            token=resp.get("token", ""),
            stored=bool(resp.get("stored", False)),
            timed_out=bool(resp.get("timeout", False)),
        )
        if grant.granted:
            # the server auto-releases a lease when the connection that
            # acquired it dies — so the carrying socket must stay pinned
            # (out of the shared pool, immune to pool-overflow closes)
            # until lease_release travels back over it
            with self._lease_lock:
                self._lease_socks[(key, grant.token)] = sock
        else:
            self._checkin(sock)
        return grant

    def lease_release(self, key: str, token: str, *, stored: bool) -> None:
        with self._lease_lock:
            sock = self._lease_socks.pop((key, token), None)
        header = {"op": "lease_release", "key": key, "token": token, "stored": stored}
        if sock is None:
            # unknown pin (reconnected meanwhile): plain request; the server
            # treats releasing an unknown lease as a no-op
            self._request(header)
            return
        try:
            sock.settimeout(self.op_timeout_s)
            send_frame(sock, header)
            recv_frame(sock)
        except (ProtocolError, OSError):
            # losing this socket releases the lease server-side anyway
            try:
                sock.close()
            except OSError:
                pass
        else:
            self._checkin(sock)

    def server_stats(self) -> dict[str, Any]:
        resp, _ = self._request({"op": "stats"})
        return dict(resp["stats"])

    def metrics_doc(self) -> "dict[str, Any] | None":
        """Fetch the server's metrics-registry document (see
        ``repro.obs.metrics.MetricsRegistry.to_doc``).  ``None`` against a
        server that predates the ``metrics`` op."""
        try:
            resp, _ = self._request({"op": "metrics"})
        except RemoteStoreError as e:
            if getattr(e, "kind", "") != "bad_op":
                raise
            return None
        return dict(resp.get("metrics", {}))

    def ping(self) -> bool:
        resp, _ = self._request({"op": "ping"})
        return bool(resp.get("pong"))

    # -- eviction-event stream --------------------------------------------------
    def add_event_listener(self, fn: Callable[[str, str], None]) -> None:
        """``fn(event, key)`` runs on the event thread for every server-side
        event (currently ``"evicted"``).  Listeners must be fast and must
        not call back into this backend."""
        with self._listener_lock:
            self._listeners.append(fn)
            if self._event_thread is None:
                self._event_thread = threading.Thread(
                    target=self._event_loop, name="store-events", daemon=True
                )
                self._event_thread.start()

    def _event_loop(self) -> None:
        backoff = self.retry_backoff_s
        while not self._closed:
            sock: socket.socket | None = None
            try:
                sock = self._dial()
                send_frame(sock, {"op": "subscribe", "client_id": self.client_id})
                resp, _ = recv_frame(sock)
                if not resp.get("ok"):
                    raise RemoteStoreError("subscribe rejected")
                self._event_sock = sock
                sock.settimeout(None)  # events arrive whenever they arrive
                backoff = self.retry_backoff_s
                while not self._closed:
                    event, _ = recv_frame(sock)
                    self._dispatch_event(event)
            except (ProtocolError, OSError, RemoteStoreError):
                if self._closed:
                    return
                # server restarting: resubscribe when it comes back
                time.sleep(backoff)
                backoff = min(backoff * 2, 2.0)
            finally:
                self._event_sock = None
                if sock is not None:
                    try:
                        sock.close()
                    except OSError:
                        pass

    def _dispatch_event(self, event: dict[str, Any]) -> None:
        name = event.get("event", "")
        key = event.get("key", "")
        with self._listener_lock:
            listeners = list(self._listeners)
        for fn in listeners:
            try:
                fn(name, key)
            except Exception:  # noqa: BLE001 - one listener must not kill the stream
                pass
