"""Wire protocol for the cross-process intermediate-data store.

One *frame* carries one message in either direction::

    +----------------+----------------+----------------+---------------+
    | header_len: 4B | payload_len: 8B| header (JSON)  | payload bytes |
    +----------------+----------------+----------------+---------------+

Lengths are big-endian.  The header is a small JSON object (``op`` and its
arguments on requests; ``ok`` plus result fields on responses); the payload
is the raw blob bytes (requests: ``write_blob``/``write_meta``; responses:
``read_blob``/``read_meta``).  Blob frames carry a ``digest`` field — the
SHA-256 hex of the payload — verified on both ends, so a flipped bit on the
wire (or a blob corrupted at rest) surfaces as :class:`IntegrityError`
instead of silently poisoning a downstream module.

A clean EOF *between* frames is a normal connection close
(:class:`ConnectionClosed`); an EOF *inside* a frame is a truncated frame
(:class:`ProtocolError`) — the distinction is what lets the client safely
retry idempotent requests after a server restart.

Wire format v2 (negotiated per feature, v1 peers keep working — see
``docs/remote.md``) adds a *chunked transfer mode* on top of the same frame
grammar: a large blob travels as a sequence of fixed-size chunk frames
(header ``{"c": 1}``) bounded by :data:`MAX_CHUNK_BYTES`, terminated by an
end frame (``{"end": true, "digest": <sha256-hex>}``) carrying the digest
folded incrementally as the chunks were produced.  Both endpoints process
the stream through a bounded buffer, so memory stays constant regardless of
blob size; the receiver verifies the folded digest at stream end.  A torn
stream (EOF inside a chunk frame) is a :class:`ProtocolError` exactly like
any other truncation.  v2 also adds a ``batch`` op coalescing small
presence/metadata requests into one round trip.
"""
from __future__ import annotations

import hashlib
import json
import os
import queue
import socket
import struct
import threading
from typing import Any

from ..core.backends import BackendUnavailable

_FRAME = struct.Struct(">IQ")  # header_len, payload_len

MAX_HEADER_BYTES = 1 << 20  # 1 MiB of JSON is already absurd
MAX_PAYLOAD_BYTES = 1 << 40  # sanity bound, not a quota

PROTO_VERSION = 2  # chunked transfer + batch; one-shot ops unchanged from v1
DEFAULT_CHUNK_BYTES = 4 << 20  # stream chunk size (bounded-buffer unit)
MAX_CHUNK_BYTES = 64 << 20  # a "chunk" frame above this is a protocol error
MAX_BATCH_OPS = 4096  # sub-ops per batch request

DEFAULT_PORT = 7077

_CHUNK_HDR = b'{"c":1}'  # pre-encoded per-chunk frame header


class ProtocolError(RuntimeError):
    """Malformed or truncated frame."""


class ConnectionClosed(ProtocolError):
    """Peer closed the connection at a frame boundary (normal teardown)."""


class IntegrityError(ProtocolError):
    """Payload bytes do not match their declared content digest."""


class RemoteStoreError(RuntimeError):
    """The store service failed a request (server-reported or transport)."""


class StoreUnreachable(RemoteStoreError, BackendUnavailable):
    """No server — or, in cluster mode, no replica of the key — could be
    reached at all.  Distinct from a server-*reported* failure (a reachable
    shard rejecting a bad request or hitting a disk error must not be
    treated as dead).  Subclasses
    :class:`~repro.core.backends.BackendUnavailable` so layers above the
    backend seam (store, scheduler) can degrade to recompute without
    importing ``repro.net``."""


def digest(data: bytes | bytearray | memoryview) -> str:
    return hashlib.sha256(data).hexdigest()


# payloads above this are sent as a second sendall on the raw buffer instead
# of being copied into one concatenated frame — a one-shot multi-GB blob must
# not cost an extra full-size allocation+memcpy just to prepend 12+N bytes
_INLINE_SEND_BYTES = 1 << 16


def send_frame(
    sock: socket.socket,
    header: dict[str, Any] | bytes,
    payload: bytes | bytearray | memoryview = b"",
) -> None:
    head = (
        header
        if isinstance(header, bytes)
        else json.dumps(header, separators=(",", ":")).encode()
    )
    if len(head) > MAX_HEADER_BYTES:
        raise ProtocolError(f"header too large: {len(head)} bytes")
    prefix = _FRAME.pack(len(head), len(payload)) + head
    if len(payload) <= _INLINE_SEND_BYTES:
        # one sendall: small frames leave in a single segment
        sock.sendall(prefix + payload)
    else:
        sock.sendall(prefix)
        sock.sendall(payload)  # memoryview-aware: no concatenation copy


def recv_exact_into(
    sock: socket.socket, view: memoryview, *, at_boundary: bool = False
) -> None:
    """Fill ``view`` exactly, reading into it without intermediate copies.
    ``at_boundary`` marks the read that starts a frame: EOF there is a clean
    close, EOF elsewhere a truncation."""
    n = len(view)
    got = 0
    while got < n:
        r = sock.recv_into(view[got:], min(n - got, 1 << 20))
        if not r:
            if at_boundary and got == 0:
                raise ConnectionClosed("peer closed the connection")
            raise ProtocolError(f"truncated frame: expected {n} bytes, got {got}")
        got += r


def recv_exact(sock: socket.socket, n: int, *, at_boundary: bool = False) -> bytes:
    """Read exactly ``n`` bytes.  ``at_boundary`` marks the read that starts
    a frame: EOF there is a clean close, EOF elsewhere a truncation."""
    if n == 0:
        return b""
    buf = bytearray(n)
    recv_exact_into(sock, memoryview(buf), at_boundary=at_boundary)
    return bytes(buf)


def _recv_prefix(sock: socket.socket) -> tuple[int, int]:
    raw = recv_exact(sock, _FRAME.size, at_boundary=True)
    header_len, payload_len = _FRAME.unpack(raw)
    if header_len > MAX_HEADER_BYTES or payload_len > MAX_PAYLOAD_BYTES:
        raise ProtocolError(
            f"frame lengths out of range: header={header_len} payload={payload_len}"
        )
    return header_len, payload_len


def _parse_header(raw: bytes) -> dict[str, Any]:
    try:
        header = json.loads(raw)
    except json.JSONDecodeError as e:
        raise ProtocolError(f"unparseable frame header: {e}") from e
    if not isinstance(header, dict):
        raise ProtocolError(f"frame header must be an object, got {type(header).__name__}")
    return header


def recv_frame(sock: socket.socket) -> tuple[dict[str, Any], bytes]:
    header_len, payload_len = _recv_prefix(sock)
    header = _parse_header(recv_exact(sock, header_len))
    payload = recv_exact(sock, payload_len) if payload_len else b""
    return header, payload


def recv_frame_into(
    sock: socket.socket, view: memoryview
) -> tuple[dict[str, Any], int]:
    """Like :func:`recv_frame` but receives the payload *into* ``view`` (no
    allocation — the stream loops reuse one bounded buffer, which is what
    keeps memory constant for arbitrarily large blobs).  Returns ``(header,
    payload_len)``; a payload larger than ``view`` is a protocol error."""
    header_len, payload_len = _recv_prefix(sock)
    header = _parse_header(recv_exact(sock, header_len))
    if payload_len > len(view):
        raise ProtocolError(
            f"stream chunk of {payload_len} bytes exceeds the "
            f"{len(view)}-byte receive window"
        )
    if payload_len:
        recv_exact_into(sock, view[:payload_len])
    return header, payload_len


# -- chunked transfer mode (wire format v2) -----------------------------------
def send_chunk(sock: socket.socket, payload: bytes | bytearray | memoryview) -> None:
    """One fixed-size chunk frame of a v2 stream."""
    if len(payload) > MAX_CHUNK_BYTES:
        raise ProtocolError(f"chunk of {len(payload)} bytes exceeds MAX_CHUNK_BYTES")
    send_frame(sock, _CHUNK_HDR, payload)


def send_chunk_prefix(sock: socket.socket, payload_len: int) -> None:
    """Frame prefix + header of a chunk whose payload the caller will push
    itself (``os.sendfile`` from a backend file straight into the socket —
    the payload bytes never enter userspace)."""
    if payload_len > MAX_CHUNK_BYTES:
        raise ProtocolError(f"chunk of {payload_len} bytes exceeds MAX_CHUNK_BYTES")
    sock.sendall(_FRAME.pack(len(_CHUNK_HDR), payload_len) + _CHUNK_HDR)


def send_stream_end(
    sock: socket.socket,
    *,
    digest_hex: str | None = None,
    abort: bool = False,
    error: str = "",
    kind: str = "server",
) -> None:
    """Terminal frame of a v2 stream: the folded digest on success, or an
    abort marker (with an error for the peer to surface) on failure."""
    end: dict[str, Any] = {"end": True}
    if abort:
        end.update(abort=True, error=error, kind=kind)
    else:
        end["digest"] = digest_hex
    send_frame(sock, end)


def send_blob_stream(
    sock: socket.socket,
    data: bytes | bytearray | memoryview,
    chunk_bytes: int = DEFAULT_CHUNK_BYTES,
) -> str:
    """Stream an in-memory buffer as chunk frames + end frame, folding the
    SHA-256 incrementally; chunks are memoryview slices (zero copies).
    Returns the hex digest that was declared in the end frame."""
    chunk_bytes = max(1, min(chunk_bytes, MAX_CHUNK_BYTES))
    mv = memoryview(data)
    sha = hashlib.sha256()
    for off in range(0, len(mv), chunk_bytes):
        piece = mv[off : off + chunk_bytes]
        sha.update(piece)
        send_chunk(sock, piece)
    hexd = sha.hexdigest()
    send_stream_end(sock, digest_hex=hexd)
    return hexd


def recv_blob_stream(
    sock: socket.socket, size: int, *, overlap_fold: bool | None = None
) -> tuple[bytearray, str, dict]:
    """Receive a v2 stream of exactly ``size`` payload bytes into one
    preallocated buffer, folding SHA-256 as chunks arrive.

    Returns ``(buffer, folded_digest_hex, end_header)``; the caller compares
    the folded digest to the end frame's declared one.  On an abort end frame
    the buffer is partial and ``end_header["abort"]`` is set.  Overrun (more
    payload than announced) and truncation are :class:`ProtocolError`\\ s.

    ``overlap_fold`` moves the digest fold to a worker thread so hashing
    chunk N overlaps receiving chunk N+1 (sha256 releases the GIL).  The
    default (``None``) enables it for multi-chunk streams on multi-core
    hosts only — on a single CPU the fold cannot run concurrently and the
    thread is pure overhead.
    """
    if size < 0 or size > MAX_PAYLOAD_BYTES:
        raise ProtocolError(f"stream size out of range: {size}")
    buf = bytearray(size)
    view = memoryview(buf)
    sha = hashlib.sha256()
    got = 0
    if overlap_fold is None:
        overlap_fold = size > DEFAULT_CHUNK_BYTES and (os.cpu_count() or 1) > 1
    # Each chunk lands in its own disjoint slice of ``buf`` and is never
    # rewritten, so the fold can safely run one chunk behind the socket.
    folder = _StreamFolder(sha) if overlap_fold else None
    try:
        while True:
            header, n = recv_frame_into(sock, view[got:])
            if header.get("end"):
                if not header.get("abort") and got != size:
                    raise ProtocolError(
                        f"stream ended early: expected {size} bytes, got {got}"
                    )
                if folder is not None:
                    folder.finish()
                    folder = None
                return buf, sha.hexdigest(), header
            if n > 0:
                if folder is not None:
                    folder.feed(view[got : got + n])
                else:
                    sha.update(view[got : got + n])
                got += n
            if got > size:  # unreachable (recv_frame_into bounds it) — belt
                raise ProtocolError("stream overran its announced size")
    finally:
        if folder is not None:
            folder.finish()


class _StreamFolder:
    """Folds SHA-256 over buffer slices on a worker thread, in feed order."""

    def __init__(self, sha) -> None:
        self._sha = sha
        self._q: queue.SimpleQueue = queue.SimpleQueue()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            self._sha.update(item)

    def feed(self, view: memoryview) -> None:
        self._q.put(view)

    def finish(self) -> None:
        """Drain the queue and join; after this the sha holds every fed byte."""
        self._q.put(None)
        self._thread.join()


def parse_url(url: str) -> tuple[str, int]:
    """``tcp://host:port`` / ``host:port`` / ``host`` -> ``(host, port)``."""
    rest = url[len("tcp://"):] if url.startswith("tcp://") else url
    if "/" in rest:
        raise ValueError(f"store url must not carry a path: {url!r}")
    host, sep, port = rest.rpartition(":")
    if not sep:
        return rest or "127.0.0.1", DEFAULT_PORT
    try:
        return host or "127.0.0.1", int(port)
    except ValueError:
        raise ValueError(f"bad port in store url {url!r}") from None


def parse_urls(url: str) -> list[tuple[str, int]]:
    """Comma-separated cluster membership -> ordered ``(host, port)`` list.

    ``"tcp://h:7077,h:7078,other:7077"`` — the scheme prefix may appear on
    any (or no) member.  Order is irrelevant to routing (the hash ring sorts
    members canonically) but duplicates are rejected: a member listed twice
    would silently halve its effective replication.
    """
    endpoints = [parse_url(part.strip()) for part in url.split(",") if part.strip()]
    if not endpoints:
        raise ValueError(f"no endpoints in store url {url!r}")
    if len(set(endpoints)) != len(endpoints):
        raise ValueError(f"duplicate endpoints in store url {url!r}")
    return endpoints
