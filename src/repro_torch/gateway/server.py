"""``GatewayServer`` — the workflow fabric's HTTP front door.

A dependency-light threaded HTTP/JSON service (stdlib ``http.server``, the
same no-framework discipline as ``repro_torch.net``) that turns the in-process
``repro_torch.api.Client`` into a multi-tenant network surface:

  * ``POST /v1/workflows``        — submit a serialized ``WorkflowSpec``
    (they JSON-round-trip with canonical digests) plus its input data;
    202 + run id, or synchronous completion with ``"wait": true``.
  * ``GET  /v1/runs/{id}``        — run status + result summary.
  * ``GET  /v1/runs/{id}/events`` — chunked NDJSON progress stream
    (accepted → started → finished/failed).
  * ``GET  /v1/recommend``        — the Ch. 4 recommendation surface over
    the caller's visible namespaces.
  * ``GET  /v1/artifacts``        — provenance-catalog browse
    (``?module=&param.k=&dataset=&namespace=``), scoped to one visible
    namespace per query (private by default, ``shared`` on request).
  * ``GET  /v1/stats``            — fabric aggregate + the caller's ledger.
  * ``GET  /healthz``             — unauthenticated liveness/drain probe.

Every submission is authenticated (bearer token → tenant), resolved into
exactly one artifact namespace (private by default, opt-in ``shared`` —
see :mod:`repro_torch.gateway.tenancy`), and admitted against two budgets
(per-tenant quotas here, the service-wide pending bound in
``WorkflowService``).  Saturation is an explicit structured ``429`` with
``Retry-After`` — accepted runs are never dropped, rejected runs are never
queued.  SIGTERM-style shutdown is two-phase: :meth:`begin_shutdown` makes
every new submission a ``503`` while in-flight runs drain, then
:meth:`close` waits them out and stops the listener.
"""
from __future__ import annotations

import json
import secrets
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Mapping
from urllib.parse import parse_qs, urlparse

from ..api.client import Client
from ..api.recommend import RecommendReport
from ..api.spec import SpecError, WorkflowSpec
from ..core.registry import ToolStateError, UnknownModuleError
from ..obs import tracing as _tracing
from ..obs.logging import get_logger
from ..obs.metrics import render_prometheus
from ..sched.scheduler import DagRunResult
from ..sched.service import AdmissionRejected, ServiceClosed
from ..sched.stats import TenantLedger
from .admission import AdmissionController, QuotaExceeded
from .auth import AuthError, TokenAuthenticator
from .tenancy import NamespaceDenied, TenancyPolicy

DEFAULT_PORT = 8707
DEFAULT_MAX_BODY_BYTES = 1 << 20  # 1 MiB of JSON is a very large workflow
_EVENT_STREAM_MAX_S = 300.0
_WAIT_MAX_S = 300.0
_MAX_RUNS_TRACKED = 10_000

_log = get_logger("gateway")


class _ApiError(Exception):
    """Internal: carries an HTTP status + structured body to the handler."""

    def __init__(
        self,
        status: int,
        error: str,
        message: str,
        headers: Mapping[str, str] | None = None,
    ) -> None:
        super().__init__(message)
        self.status = status
        self.error = error
        self.message = message
        self.headers = dict(headers or {})


class RunHandle:
    """Gateway-side state of one submitted run: status, events, result."""

    __slots__ = (
        "run_id", "tenant", "namespace", "digest", "created_at",
        "status", "events", "cond", "summary", "error", "trace_id",
    )

    def __init__(self, run_id: str, tenant: str, namespace: str, digest: str) -> None:
        self.run_id = run_id
        self.tenant = tenant
        self.namespace = namespace
        self.digest = digest
        self.created_at = time.time()
        self.status = "pending"  # pending | running | done | failed
        self.events: list[dict[str, Any]] = []
        self.cond = threading.Condition()
        self.summary: dict[str, Any] | None = None
        self.error: str | None = None
        self.trace_id: str | None = None

    def add_event(self, event: str, **fields: Any) -> None:
        doc = {"event": event, "run_id": self.run_id, "ts": time.time(), **fields}
        with self.cond:
            self.events.append(doc)
            self.cond.notify_all()

    @property
    def terminal(self) -> bool:
        return self.status in ("done", "failed")

    def describe(self) -> dict[str, Any]:
        doc: dict[str, Any] = {
            "run_id": self.run_id,
            "status": self.status,
            "namespace": self.namespace,
            "digest": self.digest,
        }
        if self.trace_id is not None:
            doc["trace_id"] = self.trace_id
        if self.summary is not None:
            doc["result"] = self.summary
        if self.error is not None:
            doc["error"] = self.error
        return doc


def _json_safe(value: Any) -> Any:
    """``value`` if it serializes as JSON, else a type placeholder — run
    outputs may be arrays/pytrees that have no JSON form."""
    try:
        json.dumps(value)
        return value
    except (TypeError, ValueError):
        return f"<unserializable: {type(value).__name__}>"


def _summarize(result: DagRunResult) -> dict[str, Any]:
    return {
        "n_nodes": len(result.module_seconds),
        "n_computed": result.n_computed,
        "n_skipped": result.n_skipped,
        "stored_keys": list(result.stored_keys),
        "total_seconds": result.total_seconds,
        "singleflight_waits": result.singleflight_waits,
        "reused_prefix_depth": (
            result.reused_prefix.depth if result.reused_prefix is not None else 0
        ),
        "output": _json_safe(result.output),
    }


def _report_doc(report: RecommendReport) -> dict[str, Any]:
    def sug(s: Any) -> dict[str, Any]:
        doc = {
            "kind": s.kind,
            "modules": [m.module_id for m in s.prefix.modules],
            "depth": s.depth,
            "support": s.support,
            "confidence": s.confidence,
            "stored": s.stored,
            "module_id": s.module_id,
        }
        if s.note:
            doc["note"] = s.note
        return doc

    return {
        "dataset_id": report.dataset_id,
        "depth": report.depth,
        "reusable_prefixes": [sug(s) for s in report.reusable_prefixes],
        "next_modules": [sug(s) for s in report.next_modules],
        "near_misses": [sug(s) for s in report.near_misses],
    }


def _artifact_doc(rec: Any) -> dict[str, Any]:
    """One catalog record as the wire shape of ``GET /v1/artifacts``."""
    return {
        "key": rec.key,
        "namespace": rec.namespace,
        "dataset": rec.dataset,
        "modules": list(rec.modules),
        "params": [rec.params(i) for i in range(rec.depth)],
        "depth": rec.depth,
        "nbytes": rec.nbytes,
        "compute_s": rec.compute_s,
        "created_at": rec.created_at,
        "last_used_at": rec.last_used_at,
        "n_loads": rec.n_loads,
    }


class GatewayServer:
    """Multi-tenant HTTP front door over one :class:`repro_torch.api.Client`.

    The client (and therefore the store, policy, registry, and scheduler)
    is shared across every tenant — that is the design: one intermediate-data
    fabric, namespaced keys for isolation, shared-namespace keys for
    cross-tenant reuse.  The caller owns the client's lifecycle unless
    ``own_client=True`` (the CLI sets it).
    """

    def __init__(
        self,
        client: Client,
        auth: TokenAuthenticator,
        *,
        host: str = "127.0.0.1",
        port: int = 0,
        tenancy: TenancyPolicy | None = None,
        max_body_bytes: int = DEFAULT_MAX_BODY_BYTES,
        max_inflight_per_tenant: int | None = None,
        max_bytes_per_tenant: int | None = None,
        retry_after_s: float = 1.0,
        own_client: bool = False,
    ) -> None:
        if len(auth) == 0:
            raise ValueError(
                "refusing to start an unauthenticated gateway: register at "
                "least one token"
            )
        self.client = client
        self.auth = auth
        self.tenancy = tenancy if tenancy is not None else TenancyPolicy()
        self.host = host
        self.port = port
        self.max_body_bytes = max_body_bytes
        self.retry_after_s = retry_after_s
        self.ledger = TenantLedger()
        self.admission = AdmissionController(
            self.ledger,
            max_inflight_per_tenant=max_inflight_per_tenant,
            max_bytes_per_tenant=max_bytes_per_tenant,
            retry_after_s=retry_after_s,
        )
        self._own_client = own_client
        self._runs_lock = threading.Lock()
        self._runs: dict[str, RunHandle] = {}
        self._draining = False
        self._closed = False
        self._httpd: ThreadingHTTPServer | None = None
        self._thread: threading.Thread | None = None
        # the gateway shares the client's registry — one metrics home for
        # the whole process; GET /metrics renders it merged with the
        # server-side registries of the mounted pool
        self.metrics = client.metrics
        self.ledger.bind_metrics(self.metrics)
        self._m_requests = self.metrics.counter(
            "repro_gateway_requests_total",
            "gateway admission/submission outcomes",
            ("op",),
        )
        self._m_http = self.metrics.counter(
            "repro_gateway_http_responses_total",
            "HTTP responses sent, by status code",
            ("status",),
        )
        # live quota: evictions (local budget or fleet-wide events) credit
        # the billed tenant's bytes back
        client.store.add_evict_listener(self.ledger.credit_evicted)

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> None:
        handler = type("_Handler", (_GatewayHandler,), {"gateway": self})
        self._httpd = ThreadingHTTPServer((self.host, self.port), handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="gateway-http", daemon=True
        )
        self._thread.start()

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    @property
    def draining(self) -> bool:
        return self._draining

    def begin_shutdown(self) -> None:
        """Phase one of graceful shutdown: new submissions get 503 (here and
        at the service), in-flight runs keep executing, status/event reads
        keep working so clients can observe their runs finishing."""
        self._draining = True
        self.client.service.begin_shutdown()

    def close(self, drain_timeout: float | None = None) -> None:
        """Phase two: drain in-flight runs, stop the listener.  Idempotent."""
        self.begin_shutdown()
        if self._closed:
            return
        self._closed = True
        self.client.service.drain(drain_timeout)
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
        if self._own_client:
            self.client.close()

    def __enter__(self) -> "GatewayServer":
        if self._httpd is None:
            self.start()
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()

    # -- bookkeeping -----------------------------------------------------------
    def _count(self, what: str) -> None:
        if what.startswith("http_"):
            self._m_http.labels(status=what[len("http_"):]).inc()
        else:
            self._m_requests.labels(op=what).inc()

    def counts(self) -> dict[str, int]:
        """Deprecated alias surface: the legacy flat dict, reconstructed from
        ``repro_gateway_requests_total{op}`` and
        ``repro_gateway_http_responses_total{status}``
        (see ``repro_torch/obs/naming.py``)."""
        out: dict[str, int] = {}
        for s in self._m_requests.series():
            out[s["labels"]["op"]] = int(s["value"] or 0)
        for s in self._m_http.series():
            out[f"http_{s['labels']['status']}"] = int(s["value"] or 0)
        return out

    def metrics_text(self) -> str:
        """The fabric-wide Prometheus exposition behind ``GET /metrics``:
        this process's registry (gateway + client + scheduler + store +
        cache) merged with every reachable store server's registry."""
        return render_prometheus(self.client.metrics_doc())

    def _track(self, handle: RunHandle) -> None:
        with self._runs_lock:
            self._runs[handle.run_id] = handle
            if len(self._runs) > _MAX_RUNS_TRACKED:
                # retire oldest *terminal* runs only: an accepted run's
                # status must stay queryable until it completes
                for rid in [
                    r.run_id
                    for r in sorted(self._runs.values(), key=lambda r: r.created_at)
                    if r.terminal
                ][: len(self._runs) - _MAX_RUNS_TRACKED]:
                    self._runs.pop(rid, None)

    def get_run(self, run_id: str, tenant: str) -> RunHandle:
        with self._runs_lock:
            handle = self._runs.get(run_id)
        # a foreign tenant's run id is indistinguishable from an unknown one
        if handle is None or handle.tenant != tenant:
            raise _ApiError(404, "not_found", f"unknown run {run_id!r}")
        return handle

    # -- submission ------------------------------------------------------------
    def submit(
        self,
        tenant: str,
        spec: WorkflowSpec,
        data: Any,
        requested_namespace: str | None,
        trace: "_tracing.TraceContext | None" = None,
    ) -> RunHandle:
        """Admit + submit one run.  ``trace`` is the inbound trace context
        (parsed from the HTTP ``traceparent`` header); when tracing is
        enabled the gateway opens a ``gateway.submit`` span under it and
        parents the run's span there, so one trace covers
        gateway → scheduler → store → shards across processes."""
        gsp = _tracing.span("gateway.submit", kind="server", parent=trace, tenant=tenant)
        with gsp:
            return self._submit(tenant, spec, data, requested_namespace, trace, gsp)

    def _submit(
        self,
        tenant: str,
        spec: WorkflowSpec,
        data: Any,
        requested_namespace: str | None,
        trace: "_tracing.TraceContext | None",
        gsp: Any,
    ) -> RunHandle:
        if self._draining:
            raise _ApiError(
                503,
                "draining",
                "gateway is shutting down; resubmit elsewhere or later",
                {"Retry-After": "1"},
            )
        try:
            namespace = self.tenancy.resolve(tenant, requested_namespace)
        except NamespaceDenied as e:
            self._count("denied_namespace")
            raise _ApiError(403, "namespace_denied", str(e)) from None
        spec = spec.with_namespace(namespace)
        try:
            spec.validate(self.client.registry)
        except (SpecError, ToolStateError, UnknownModuleError) as e:
            self._count("invalid_spec")
            raise _ApiError(422, "invalid_spec", str(e)) from None

        try:
            self.admission.reserve(tenant)
        except QuotaExceeded as e:
            self._count("rejected_quota")
            raise _ApiError(
                429, "quota_exceeded", str(e),
                {"Retry-After": f"{max(1, round(e.retry_after_s))}"},
            ) from None

        run_id = f"r-{secrets.token_hex(8)}"
        handle = RunHandle(run_id, tenant, namespace, spec.digest)
        # parent the run's span under the gateway span when one is live,
        # else pass the raw inbound context straight through
        if getattr(gsp, "trace_id", None):
            gsp.set(run_id=run_id, namespace=namespace)
            child = _tracing.TraceContext(gsp.trace_id, gsp.span_id)
        else:
            child = trace
        handle.trace_id = child.trace_id if child is not None else None
        self._track(handle)
        handle.add_event(
            "accepted", namespace=namespace, digest=spec.digest, tenant=tenant
        )

        def _on_state(state: str) -> None:
            if state == "started":
                handle.status = "running"
                handle.add_event("started")

        try:
            fut = self.client.submit(spec, data, on_state=_on_state, trace=child)
        except AdmissionRejected as e:
            self.admission.cancel(tenant)
            handle.status = "failed"
            handle.error = str(e)
            handle.add_event("rejected", message=str(e))
            self._count("rejected_pending")
            raise _ApiError(
                429, "saturated", str(e),
                {"Retry-After": f"{max(1, round(self.retry_after_s))}"},
            ) from None
        except ServiceClosed as e:
            self.admission.cancel(tenant)
            handle.status = "failed"
            handle.error = str(e)
            handle.add_event("rejected", message=str(e))
            raise _ApiError(503, "draining", str(e), {"Retry-After": "1"}) from None

        self._count("accepted")
        _log.info(
            "run %s accepted (tenant=%s namespace=%s trace=%s)",
            run_id, tenant, namespace, handle.trace_id or "-",
        )

        def _done(f: Any) -> None:
            try:
                result: DagRunResult = f.result()
            except Exception as e:  # noqa: BLE001 - surfaced via run status
                handle.error = f"{type(e).__name__}: {e}"
                handle.status = "failed"
                self.admission.release(handle.tenant, failed=True)
                handle.add_event("failed", message=handle.error)
                _log.warning(
                    "run %s failed (tenant=%s): %s",
                    handle.run_id, handle.tenant, handle.error,
                )
            else:
                handle.summary = _summarize(result)
                for key in result.stored_keys:
                    rec = self.client.store.records.get(key)
                    if rec is not None:
                        self.ledger.charge_stored(
                            handle.tenant, key, int(rec.nbytes_disk)
                        )
                handle.status = "done"
                self.admission.release(
                    handle.tenant,
                    units_total=len(result.module_seconds),
                    units_skipped=result.n_skipped,
                )
                handle.add_event(
                    "finished",
                    n_skipped=result.n_skipped,
                    n_computed=result.n_computed,
                    stored=len(result.stored_keys),
                    total_seconds=result.total_seconds,
                )

        fut.add_done_callback(_done)
        return handle

    # -- read surfaces -----------------------------------------------------------
    def recommend_doc(
        self,
        tenant: str,
        dataset: str,
        modules: list[str],
        requested_namespace: str | None,
        top_k: int,
    ) -> dict[str, Any]:
        try:
            namespace = self.tenancy.resolve(tenant, requested_namespace)
        except NamespaceDenied as e:
            raise _ApiError(403, "namespace_denied", str(e)) from None
        partial = WorkflowSpec(dataset, namespace=namespace)
        if modules:
            partial.chain([m for m in modules])
        report = self.client.recommend(partial, top_k=top_k)
        return _report_doc(report)

    def artifacts_doc(
        self,
        tenant: str,
        module: str | None,
        params: dict[str, Any],
        dataset: str | None,
        requested_namespace: str | None,
        any_position: bool,
        limit: int,
    ) -> dict[str, Any]:
        """Tenant-scoped catalog browse: every query resolves to exactly ONE
        visible namespace through the same :class:`TenancyPolicy` gate as
        submissions — the private namespace by default, ``shared`` on
        request, a foreign tenant's namespace never (403)."""
        try:
            namespace = self.tenancy.resolve(tenant, requested_namespace)
        except NamespaceDenied as e:
            self._count("denied_namespace")
            raise _ApiError(403, "namespace_denied", str(e)) from None
        try:
            hits = self.client.find(
                module=module,
                params=params or None,
                dataset=dataset,
                namespace=namespace,
                any_position=any_position,
                limit=max(1, min(limit, 500)),
            )
        except ValueError as e:  # e.g. param filters without ?module=
            raise _ApiError(400, "bad_request", str(e)) from None
        return {
            "namespace": namespace,
            "count": len(hits),
            "artifacts": [_artifact_doc(r) for r in hits],
        }

    def stats_doc(self, tenant: str) -> dict[str, Any]:
        agg = self.client.stats()
        service = self.client.service
        return {
            "fabric": {
                "runs": agg.runs,
                "failures": agg.failures,
                "throughput_rps": agg.throughput_rps,
                "reuse_rate": agg.reuse_rate,
                "stored": agg.stored,
                "singleflight_waits": agg.singleflight_waits,
                "pending_runs": service.pending_runs,
                "rejected_runs": service.rejected_runs,
                "max_pending": service.max_pending,
            },
            "gateway": self.counts(),
            "tenant": {tenant: self.ledger.snapshot(tenant)},
            "draining": self._draining,
        }


class _GatewayHandler(BaseHTTPRequestHandler):
    """One HTTP connection; routes into the class-level ``gateway``."""

    gateway: GatewayServer  # bound by GatewayServer.start()
    protocol_version = "HTTP/1.1"
    server_version = "repro-gateway"

    def log_message(self, fmt: str, *args: Any) -> None:  # noqa: D102
        # http.server's per-request stderr chatter becomes debug-level
        # structured logging (visible with --log-level debug)
        _log.debug("%s %s", self.address_string(), fmt % args)

    # -- plumbing ------------------------------------------------------------
    def _send_json(
        self,
        status: int,
        doc: Mapping[str, Any],
        headers: Mapping[str, str] | None = None,
    ) -> None:
        body = json.dumps(doc).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)
        self.gateway._count(f"http_{status}")

    def _authenticate(self) -> str:
        try:
            return self.gateway.auth.authenticate(self.headers.get("Authorization"))
        except AuthError as e:
            raise _ApiError(
                401, "unauthorized", str(e),
                {"WWW-Authenticate": 'Bearer realm="repro-gateway"'},
            ) from None

    def _read_body(self) -> bytes:
        length = self.headers.get("Content-Length")
        if length is None:
            raise _ApiError(411, "length_required", "Content-Length is required")
        try:
            n = int(length)
        except ValueError:
            raise _ApiError(400, "bad_request", "malformed Content-Length") from None
        if n < 0:
            raise _ApiError(400, "bad_request", "malformed Content-Length")
        if n > self.gateway.max_body_bytes:
            # refuse before reading: a huge body never gets buffered
            self.close_connection = True
            raise _ApiError(
                413,
                "too_large",
                f"request body {n} bytes exceeds the "
                f"{self.gateway.max_body_bytes}-byte limit",
            )
        return self.rfile.read(n)

    def _parse_json(self, raw: bytes) -> Any:
        try:
            return json.loads(raw.decode("utf-8"))
        except (ValueError, UnicodeDecodeError) as e:
            raise _ApiError(400, "bad_json", f"invalid JSON body: {e}") from None

    # -- routes --------------------------------------------------------------
    def do_GET(self) -> None:  # noqa: N802 - http.server API
        try:
            url = urlparse(self.path)
            parts = [p for p in url.path.split("/") if p]
            if url.path == "/healthz":
                self._send_json(
                    200, {"ok": True, "draining": self.gateway.draining}
                )
                return
            if url.path == "/metrics":
                # unauthenticated like /healthz: an operational scrape
                # surface, not a tenant data surface
                body = self.gateway.metrics_text().encode()
                self.send_response(200)
                self.send_header(
                    "Content-Type", "text/plain; version=0.0.4; charset=utf-8"
                )
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
                self.gateway._count("http_200")
                return
            tenant = self._authenticate()
            if parts[:1] == ["v1"] and parts[1:2] == ["runs"] and len(parts) == 3:
                handle = self.gateway.get_run(parts[2], tenant)
                self._send_json(200, handle.describe())
            elif (
                parts[:1] == ["v1"]
                and parts[1:2] == ["runs"]
                and len(parts) == 4
                and parts[3] == "events"
            ):
                handle = self.gateway.get_run(parts[2], tenant)
                self._stream_events(handle)
            elif parts == ["v1", "recommend"]:
                q = parse_qs(url.query)
                dataset = (q.get("dataset") or [""])[0]
                if not dataset:
                    raise _ApiError(400, "bad_request", "missing ?dataset=")
                modules = [
                    m for m in (q.get("modules") or [""])[0].split(",") if m
                ]
                namespace = (q.get("namespace") or [None])[0]
                try:
                    top_k = int((q.get("top_k") or ["5"])[0])
                except ValueError:
                    raise _ApiError(400, "bad_request", "top_k must be an int")
                doc = self.gateway.recommend_doc(
                    tenant, dataset, modules, namespace, top_k
                )
                self._send_json(200, doc)
            elif parts == ["v1", "artifacts"]:
                q = parse_qs(url.query)
                module = (q.get("module") or [None])[0]
                dataset = (q.get("dataset") or [None])[0]
                namespace = (q.get("namespace") or [None])[0]
                any_position = (q.get("any") or ["0"])[0] in ("1", "true", "yes")
                try:
                    limit = int((q.get("limit") or ["20"])[0])
                except ValueError:
                    raise _ApiError(400, "bad_request", "limit must be an int")
                # ?param.k=v filters on decoded tool-state params; values are
                # parsed as JSON when they look like it ("3", "true",
                # '"text"'), else taken as plain strings
                params: dict[str, Any] = {}
                for raw_key, values in q.items():
                    if not raw_key.startswith("param.") or not values:
                        continue
                    name = raw_key[len("param."):]
                    if not name:
                        raise _ApiError(400, "bad_request", "empty param name")
                    try:
                        params[name] = json.loads(values[0])
                    except ValueError:
                        params[name] = values[0]
                doc = self.gateway.artifacts_doc(
                    tenant, module, params, dataset, namespace,
                    any_position, limit,
                )
                self._send_json(200, doc)
            elif parts == ["v1", "stats"]:
                self._send_json(200, self.gateway.stats_doc(tenant))
            else:
                raise _ApiError(404, "not_found", f"no route for {url.path}")
        except _ApiError as e:
            self._send_json(
                e.status, {"error": e.error, "message": e.message}, e.headers
            )
        except Exception as e:  # noqa: BLE001 - the server thread must survive
            self._send_json(500, {"error": "internal", "message": str(e)})

    def do_POST(self) -> None:  # noqa: N802 - http.server API
        try:
            url = urlparse(self.path)
            if url.path != "/v1/workflows":
                raise _ApiError(404, "not_found", f"no route for {url.path}")
            tenant = self._authenticate()
            body = self._parse_json(self._read_body())
            if not isinstance(body, Mapping):
                raise _ApiError(400, "bad_request", "body must be a JSON object")
            # either {"spec": {...}, "data": ..., "namespace": ..., "wait": ...}
            # or a bare workflow-spec document
            if "spec" in body:
                raw_spec = body["spec"]
                data = body.get("data")
                namespace = body.get("namespace")
                wait = bool(body.get("wait", False))
            else:
                raw_spec, data, namespace, wait = body, None, None, False
            if not isinstance(raw_spec, Mapping):
                raise _ApiError(400, "bad_request", "'spec' must be a JSON object")
            try:
                spec = WorkflowSpec.from_dict(raw_spec)
            except SpecError as e:
                raise _ApiError(422, "invalid_spec", str(e)) from None
            if namespace is None and spec.namespace:
                namespace = spec.namespace
            trace = _tracing.TraceContext.from_traceparent(
                self.headers.get("traceparent")
            )
            handle = self.gateway.submit(tenant, spec, data, namespace, trace=trace)
            if wait:
                self._wait_terminal(handle)
                self._send_json(200, handle.describe())
            else:
                self._send_json(202, handle.describe())
        except _ApiError as e:
            self._send_json(
                e.status, {"error": e.error, "message": e.message}, e.headers
            )
        except Exception as e:  # noqa: BLE001 - the server thread must survive
            self._send_json(500, {"error": "internal", "message": str(e)})

    # -- streaming -------------------------------------------------------------
    def _wait_terminal(self, handle: RunHandle, timeout: float = _WAIT_MAX_S) -> None:
        deadline = time.monotonic() + timeout
        with handle.cond:
            while not handle.terminal:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise _ApiError(
                        504,
                        "timeout",
                        f"run {handle.run_id} still {handle.status!r} after "
                        f"{timeout:.0f}s; poll GET /v1/runs/{handle.run_id}",
                    )
                handle.cond.wait(min(remaining, 1.0))

    def _stream_events(self, handle: RunHandle) -> None:
        """Chunked NDJSON: every event so far, then live events until the
        run reaches a terminal state."""
        self.send_response(200)
        self.send_header("Content-Type", "application/x-ndjson")
        self.send_header("Transfer-Encoding", "chunked")
        self.send_header("Cache-Control", "no-store")
        self.end_headers()
        self.gateway._count("http_200")

        def _chunk(doc: dict[str, Any]) -> None:
            data = (json.dumps(doc) + "\n").encode()
            self.wfile.write(b"%x\r\n" % len(data) + data + b"\r\n")
            self.wfile.flush()

        sent = 0
        deadline = time.monotonic() + _EVENT_STREAM_MAX_S
        try:
            while True:
                with handle.cond:
                    while (
                        sent >= len(handle.events)
                        and not handle.terminal
                        and time.monotonic() < deadline
                    ):
                        handle.cond.wait(1.0)
                    fresh = handle.events[sent:]
                for doc in fresh:
                    _chunk(doc)
                sent += len(fresh)
                if (handle.terminal and sent >= len(handle.events)) or (
                    time.monotonic() >= deadline
                ):
                    break
            self.wfile.write(b"0\r\n\r\n")
        except (BrokenPipeError, ConnectionResetError):
            pass  # client went away mid-stream; nothing to clean up
        self.close_connection = True
