"""Cross-process run tracing: TraceContext, spans, NDJSON sinks.

A *trace* follows one workflow run across every process it touches:
gateway → ``WorkflowService`` → ``DagScheduler`` workers → ``RemoteBackend``
RPCs → ``StoreServer`` shards.  Each process appends finished spans to an
NDJSON file in a shared trace directory; ``python -m repro.obs.trace``
stitches them back into one tree by ``(trace_id, span_id, parent_id)``.

Propagation formats
-------------------
- HTTP (gateway): a W3C-style ``traceparent`` header,
  ``00-<32 hex trace_id>-<16 hex span_id>-01``.
- ``repro.net`` frames: an optional ``"tp"`` field carrying the same string
  in the request header.  Servers that predate tracing simply ignore the
  unknown field (the same forward-compat contract the v2 streaming
  negotiation relies on), so no handshake is needed.

Fast path
---------
Tracing is **off by default**.  When off, :func:`span` returns a shared
no-op object after one module-global check — the hot paths
(``store.get``, RPC dispatch) pay a function call and a branch, nothing
else.  ``benchmarks/bench_obs.py`` pins this.

Cross-thread propagation is explicit: the current span lives in a
``contextvars.ContextVar``, and code that hops threads (scheduler workers)
re-activates the parent with :func:`activate` or passes ``parent=``.
"""
from __future__ import annotations

import contextvars
import json
import os
import threading
import time
from typing import Any, Iterator, Mapping

__all__ = [
    "NOOP_SPAN",
    "Span",
    "TraceContext",
    "activate",
    "bind",
    "configure_tracing",
    "current_baggage",
    "current_span",
    "current_traceparent",
    "span",
    "tracing_enabled",
]

_HEX = "0123456789abcdef"


def _rand_hex(nbytes: int) -> str:
    return os.urandom(nbytes).hex()


class TraceContext:
    """An addressable point in a trace: ``trace_id`` + ``span_id``.

    Also the cross-process wire form (``traceparent``) and a valid
    ``parent=`` for :func:`span`, so a server can adopt an inbound context
    directly.
    """

    __slots__ = ("trace_id", "span_id")

    def __init__(self, trace_id: str, span_id: str) -> None:
        self.trace_id = trace_id
        self.span_id = span_id

    @classmethod
    def new(cls) -> "TraceContext":
        return cls(_rand_hex(16), _rand_hex(8))

    def to_traceparent(self) -> str:
        return f"00-{self.trace_id}-{self.span_id}-01"

    @classmethod
    def from_traceparent(cls, header: str | None) -> "TraceContext | None":
        if not header or not isinstance(header, str):
            return None
        parts = header.strip().split("-")
        if len(parts) < 3:
            return None
        _, trace_id, span_id = parts[0], parts[1], parts[2]
        if len(trace_id) != 32 or len(span_id) != 16:
            return None
        if any(c not in _HEX for c in trace_id + span_id):
            return None
        if trace_id == "0" * 32 or span_id == "0" * 16:
            return None
        return cls(trace_id, span_id)

    def __repr__(self) -> str:  # pragma: no cover — debugging aid
        return f"TraceContext({self.trace_id!r}, {self.span_id!r})"


class _SpanWriter:
    """Appends finished spans as NDJSON lines to ``<dir>/<service>-<pid>.ndjson``."""

    def __init__(self, directory: str, service: str) -> None:
        self.directory = directory
        self.service = service
        self._lock = threading.Lock()
        self._fh: Any = None

    def write(self, rec: dict[str, Any]) -> None:
        line = json.dumps(rec, separators=(",", ":")) + "\n"
        with self._lock:
            if self._fh is None:
                os.makedirs(self.directory, exist_ok=True)
                path = os.path.join(
                    self.directory, f"{self.service}-{os.getpid()}.ndjson"
                )
                self._fh = open(path, "a", encoding="utf-8")
            try:
                self._fh.write(line)
                self._fh.flush()
            except Exception:  # noqa: BLE001 — tracing must never break the fabric
                pass

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                try:
                    self._fh.close()
                except Exception:  # noqa: BLE001
                    pass
                self._fh = None


# module state: one writer per process; svc can still be overridden per span
# (in-process test clusters give each StoreServer its own service name)
_writer: _SpanWriter | None = None
_enabled = False
_env_checked = False
_current: contextvars.ContextVar[Any] = contextvars.ContextVar("repro_span", default=None)
_baggage: contextvars.ContextVar[Mapping[str, Any]] = contextvars.ContextVar(
    "repro_baggage", default={}
)


def configure_tracing(
    directory: str | None,
    service: str = "repro",
    *,
    enabled: bool = True,
) -> None:
    """Enable (or disable with ``enabled=False``/``directory=None``) span
    recording for this process.  Also reachable via the ``REPRO_TRACE_DIR``
    and ``REPRO_SERVICE`` environment variables."""
    global _writer, _enabled, _env_checked
    _env_checked = True
    old = _writer
    if directory is None or not enabled:
        _writer, _enabled = None, False
    else:
        _writer, _enabled = _SpanWriter(directory, service), True
    if old is not None:
        old.close()


def _ensure_env() -> None:
    global _env_checked
    if not _env_checked:
        _env_checked = True
        d = os.environ.get("REPRO_TRACE_DIR")
        if d:
            configure_tracing(d, os.environ.get("REPRO_SERVICE", "repro"))


def tracing_enabled() -> bool:
    _ensure_env()
    return _enabled


class Span:
    __slots__ = (
        "trace_id",
        "span_id",
        "parent_id",
        "name",
        "kind",
        "svc",
        "attrs",
        "_t0",
        "_start",
        "_token",
        "_ended",
    )

    def __init__(
        self,
        name: str,
        kind: str,
        trace_id: str,
        parent_id: str | None,
        svc: str | None,
        attrs: dict[str, Any],
    ) -> None:
        self.name = name
        self.kind = kind
        self.trace_id = trace_id
        self.span_id = _rand_hex(8)
        self.parent_id = parent_id
        self.svc = svc
        self.attrs = attrs
        self._t0 = time.monotonic()
        self._start = time.time()
        self._token: contextvars.Token | None = None
        self._ended = False

    def set(self, **attrs: Any) -> None:
        self.attrs.update(attrs)

    def rename(self, name: str) -> None:
        self.name = name

    def end(self) -> None:
        if self._ended:
            return
        self._ended = True
        w = _writer
        if w is None:
            return
        w.write(
            {
                "trace": self.trace_id,
                "span": self.span_id,
                "parent": self.parent_id,
                "name": self.name,
                "kind": self.kind,
                "svc": self.svc or w.service,
                "pid": os.getpid(),
                "start": round(self._start, 6),
                "dur": round(time.monotonic() - self._t0, 6),
                "attrs": self.attrs,
            }
        )

    def __enter__(self) -> "Span":
        self._token = _current.set(self)
        return self

    def __exit__(self, exc_type: Any, exc: Any, tb: Any) -> None:
        if self._token is not None:
            _current.reset(self._token)
            self._token = None
        if exc_type is not None:
            self.attrs.setdefault("error", exc_type.__name__)
        self.end()


class _NoopSpan:
    """Shared do-nothing span — the disabled-tracing fast path."""

    __slots__ = ()
    trace_id = None
    span_id = None
    parent_id = None

    def set(self, **attrs: Any) -> None:
        pass

    def rename(self, name: str) -> None:
        pass

    def end(self) -> None:
        pass

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc: Any) -> None:
        pass


NOOP_SPAN = _NoopSpan()


def span(
    name: str,
    *,
    kind: str = "internal",
    parent: Any = None,
    svc: str | None = None,
    **attrs: Any,
) -> Any:
    """Open a span (use as a context manager).

    ``parent`` may be a :class:`Span`, a :class:`TraceContext`, or ``None``
    (inherit the context-local current span; fresh trace if there is none).
    Returns :data:`NOOP_SPAN` when tracing is disabled.
    """
    _ensure_env()
    if not _enabled:
        return NOOP_SPAN
    if parent is None:
        parent = _current.get()
    if parent is not None and getattr(parent, "trace_id", None):
        return Span(name, kind, parent.trace_id, parent.span_id, svc, attrs)
    return Span(name, kind, _rand_hex(16), None, svc, attrs)


def current_span() -> Span | None:
    s = _current.get()
    return s if isinstance(s, Span) else None


def current_context() -> TraceContext | None:
    s = _current.get()
    if s is None or not getattr(s, "trace_id", None):
        return None
    return TraceContext(s.trace_id, s.span_id)


def current_traceparent() -> str | None:
    """Wire form of the current span, or ``None`` outside any span (or with
    tracing off) — callers attach it to outbound frames/requests only when
    non-None, so disabled tracing adds zero bytes to the wire."""
    ctx = current_context()
    return ctx.to_traceparent() if ctx is not None else None


class activate:
    """Re-activate a span/context on another thread::

        with tracing.activate(parent_ctx):
            ...  # span() calls here parent under parent_ctx
    """

    def __init__(self, target: Any) -> None:
        self._target = target
        self._token: contextvars.Token | None = None

    def __enter__(self) -> Any:
        self._token = _current.set(self._target)
        return self._target

    def __exit__(self, *exc: Any) -> None:
        if self._token is not None:
            _current.reset(self._token)


class bind:
    """Attach log baggage (``run_id``, ``tenant``, …) to the current context;
    the :mod:`repro.obs.logging` filter stamps it onto every record."""

    def __init__(self, **kw: Any) -> None:
        self._kw = kw
        self._token: contextvars.Token | None = None

    def __enter__(self) -> "bind":
        merged = {**_baggage.get(), **self._kw}
        self._token = _baggage.set(merged)
        return self

    def __exit__(self, *exc: Any) -> None:
        if self._token is not None:
            _baggage.reset(self._token)


def current_baggage() -> Mapping[str, Any]:
    return _baggage.get()


def iter_spans(directory: str) -> Iterator[dict[str, Any]]:
    """Yield every span record found under ``directory`` (all processes)."""
    try:
        names = sorted(os.listdir(directory))
    except OSError:
        return
    for fname in names:
        if not fname.endswith(".ndjson"):
            continue
        try:
            with open(os.path.join(directory, fname), encoding="utf-8") as fh:
                for line in fh:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        yield json.loads(line)
                    except ValueError:
                        continue  # torn tail line from a live writer
        except OSError:
            continue
