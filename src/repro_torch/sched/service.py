"""Concurrent workflow submission front door.

``WorkflowService`` accepts many overlapping DAG (or sequential) workflow
submissions and executes them against ONE shared ``IntermediateStore`` +
``StoragePolicy`` + module registry — the configuration where the thesis'
storing strategy pays off at scale: concurrent runs share stored prefixes,
and in-flight runs coalesce duplicate computes through single-flight.

Each submission gets a lightweight coordinator running the scheduler's
dispatch loop (coordinators mostly block on node futures) on a bounded
coordinator pool — at most ``max_concurrent_runs`` dispatch loops exist at
once, excess submissions simply queue; node work itself executes on the
scheduler's bounded worker pool, so total module concurrency is capped at
``max_workers`` regardless of how many runs are in flight.

The port's copy differs in one argument: ``device`` passes through to the
scheduler, which loads stored prefixes onto it ("cuda" unless the caller
asks for the CPU).
"""
from __future__ import annotations

import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from concurrent.futures import wait as futures_wait
from typing import Any, Callable, Mapping, Sequence

from ..core.cost import CostModel
from ..core.provenance import ProvenanceLog
from ..core.registry import ModuleRegistry
from ..core.risp import StoragePolicy
from ..core.store import IntermediateStore
from ..core.workflow import ModuleSpec, Workflow
from ..obs import tracing as _tracing
from ..obs.metrics import MetricsRegistry
from .dag import DagWorkflow
from .dispatch import NodeDispatcher
from .scheduler import DagRunResult, DagScheduler
from .singleflight import SingleFlight
from .stats import AggregateStats


class AdmissionRejected(RuntimeError):
    """The service's pending-run budget is full: the submission was refused,
    not queued.  Callers (the gateway maps this to ``429 Retry-After``)
    should back off and resubmit; nothing was scheduled."""

    def __init__(self, pending: int, max_pending: int) -> None:
        super().__init__(
            f"submission rejected: {pending} runs already pending "
            f"(max_pending={max_pending})"
        )
        self.pending = pending
        self.max_pending = max_pending


class ServiceClosed(RuntimeError):
    """The service is shutting down (or closed): new submissions are
    refused while in-flight runs drain.  The gateway maps this to 503."""


class WorkflowService:
    """Shared-store, shared-policy execution service for concurrent workflows.

    ``max_pending`` bounds runs in flight (queued + executing): submissions
    beyond it raise :class:`AdmissionRejected` instead of piling onto the
    coordinator pool's unbounded queue — saturation becomes an explicit,
    retryable signal rather than silent memory growth.  ``None`` preserves
    the legacy unbounded behavior.
    """

    def __init__(
        self,
        store: IntermediateStore,
        policy: StoragePolicy,
        registry: ModuleRegistry | dict[str, ModuleSpec] | None = None,
        max_workers: int = 4,
        admission: str = "always",
        provenance: ProvenanceLog | None = None,
        cost_model: CostModel | None = None,
        max_concurrent_runs: int = 32,
        singleflight: "SingleFlight | None" = None,
        dispatcher: "NodeDispatcher | None" = None,
        max_pending: int | None = None,
        catalog: Any = None,
        metrics: MetricsRegistry | None = None,
        device: Any = "cuda",
    ) -> None:
        if max_pending is not None and max_pending < 1:
            raise ValueError("max_pending must be >= 1 (or None for unbounded)")
        # one metrics home for the whole fabric: default to the store's
        # registry so service-, flight-, and store-level series co-reside
        self.metrics = metrics if metrics is not None else store.metrics
        self.scheduler = DagScheduler(
            store=store,
            policy=policy,
            registry=registry if registry is not None else ModuleRegistry(),
            max_workers=max_workers,
            admission=admission,
            provenance=provenance,
            cost_model=cost_model,
            singleflight=(
                singleflight
                if singleflight is not None
                else SingleFlight(registry=self.metrics)
            ),
            dispatcher=dispatcher,
            catalog=catalog,
            device=device,
        )
        m = self.metrics
        self._m_runs = m.counter(
            "repro_runs_total", "workflow runs finished", ("status",)
        )
        self._m_run_seconds = m.histogram(
            "repro_run_seconds", "end-to-end workflow run wall time"
        )
        self._m_units = m.counter(
            "repro_run_units_total", "workflow nodes in finished runs"
        )
        self._m_units_skipped = m.counter(
            "repro_run_units_skipped_total", "nodes skipped via stored-prefix reuse"
        )
        self._m_stored = m.counter(
            "repro_run_stored_total", "artifacts stored by finished runs"
        )
        self._m_rejected = m.counter(
            "repro_service_rejected_total",
            "submissions refused by the max_pending admission bound",
        )
        m.gauge(
            "repro_service_pending_runs", "runs submitted but not yet finished"
        ).unlabeled.set_function(lambda: self._pending)
        self._lock = threading.Lock()
        self._t_first: float | None = None
        self._t_last: float = 0.0
        self._agg = AggregateStats()
        # a submission burst must not spawn a thread per run: coordinators
        # run on a bounded pool, excess dispatch loops queue
        self._coord_pool = ThreadPoolExecutor(
            max_workers=max_concurrent_runs, thread_name_prefix="dag-run"
        )
        self._inflight: list[Future] = []  # coordinator-pool futures
        self.max_pending = max_pending
        self._pending = 0  # submitted, not yet finished (under self._lock)
        self._draining = False
        self._closed = False

    # -- delegated surface ---------------------------------------------------
    @property
    def store(self) -> IntermediateStore:
        return self.scheduler.store

    @property
    def policy(self) -> StoragePolicy:
        return self.scheduler.policy

    @property
    def registry(self) -> ModuleRegistry:
        return self.scheduler.registry

    @property
    def catalog(self) -> Any:
        return self.scheduler.catalog

    def register(self, spec: ModuleSpec) -> None:
        self.scheduler.register(spec)

    def register_fn(self, module_id: str, fn, **default_params) -> None:
        self.scheduler.register_fn(module_id, fn, **default_params)

    def dag(self, dataset_id: str, workflow_id: str = "") -> DagWorkflow:
        return self.scheduler.dag(dataset_id, workflow_id)

    # -- submission ----------------------------------------------------------
    @property
    def pending_runs(self) -> int:
        """Runs submitted but not yet finished (queued + executing)."""
        with self._lock:
            return self._pending

    @property
    def rejected_runs(self) -> int:
        """Submissions refused by the ``max_pending`` admission bound
        (deprecated alias of ``repro_service_rejected_total``)."""
        return int(self._m_rejected.value)

    def submit(
        self,
        dag: DagWorkflow | Workflow,
        data: Any,
        on_state: "Callable[[str], None] | None" = None,
        trace: "_tracing.TraceContext | None" = None,
    ) -> "Future[DagRunResult]":
        """Non-blocking: schedule one workflow run, return its future.

        Raises :class:`AdmissionRejected` when ``max_pending`` runs are
        already in flight and :class:`ServiceClosed` once shutdown has begun.
        ``on_state`` fires with ``"started"`` when a coordinator picks the
        run up, then ``"finished"`` or ``"failed"`` (before the future
        resolves); exceptions it raises are swallowed — observability must
        not kill the run.

        ``trace`` is the run's :class:`~repro.obs.tracing.TraceContext`
        (gateway-propagated or caller-minted); when tracing is enabled and
        none is given, a fresh one is minted so every run is traceable.  The
        returned future carries it as ``fut.trace_id``.
        """
        if trace is None and _tracing.tracing_enabled():
            trace = _tracing.TraceContext.new()
        fut: Future[DagRunResult] = Future()
        fut.trace_id = trace.trace_id if trace is not None else None  # type: ignore[attr-defined]
        with self._lock:
            if self._draining or self._closed:
                raise ServiceClosed("service is shutting down; not accepting runs")
            if self.max_pending is not None and self._pending >= self.max_pending:
                self._m_rejected.inc()
                raise AdmissionRejected(self._pending, self.max_pending)
            self._pending += 1
            if self._t_first is None:
                self._t_first = time.perf_counter()

        def _notify(state: str) -> None:
            if on_state is None:
                return
            try:
                on_state(state)
            except Exception:  # noqa: BLE001 - observer errors never kill runs
                pass

        wf_name = getattr(dag, "workflow_id", "") or getattr(dag, "dataset_id", "")

        def _coordinate() -> None:
            _notify("started")
            rsp = _tracing.span("run", kind="run", parent=trace, workflow=wf_name)
            t0 = time.perf_counter()
            try:
                with rsp:
                    result = self.scheduler.run(dag, data)
                    rsp.set(
                        n_skipped=result.n_skipped, stored=len(result.stored_keys)
                    )
            except BaseException as e:  # noqa: BLE001 - delivered via future
                self._m_runs.labels(status="failed").inc()
                self._m_run_seconds.observe(time.perf_counter() - t0)
                with self._lock:
                    self._agg.failures += 1
                    self._t_last = time.perf_counter()
                    self._pending -= 1
                _notify("failed")
                fut.set_exception(e)
            else:
                self._m_runs.labels(status="ok").inc()
                self._m_run_seconds.observe(time.perf_counter() - t0)
                self._m_units.inc(len(result.module_seconds))
                self._m_units_skipped.inc(result.n_skipped)
                self._m_stored.inc(len(result.stored_keys))
                with self._lock:
                    self._agg.add_run(result)
                    self._t_last = time.perf_counter()
                    self._pending -= 1
                _notify("finished")
                fut.set_result(result)

        try:
            coord = self._coord_pool.submit(_coordinate)
        except RuntimeError:  # pool already shut down: racing close()
            with self._lock:
                self._pending -= 1
            raise ServiceClosed("service is shutting down; not accepting runs")
        with self._lock:
            self._inflight = [f for f in self._inflight if not f.done()]
            self._inflight.append(coord)
        return fut

    def run(self, dag: DagWorkflow | Workflow, data: Any) -> DagRunResult:
        """Blocking convenience wrapper around :meth:`submit`."""
        return self.submit(dag, data).result()

    def run_steps(
        self,
        dataset_id: str,
        data: Any,
        steps: Sequence[str | tuple[str, Mapping[str, Any] | None]],
        workflow_id: str = "",
    ) -> DagRunResult:
        """Sequential-pipeline compatibility entry (same shape as
        ``WorkflowExecutor.run``), executed as a chain DAG."""
        dag = self.dag(dataset_id, workflow_id)
        dag.chain(steps)
        return self.run(dag, data)

    # -- reporting / lifecycle ----------------------------------------------
    def stats(self) -> AggregateStats:
        sf = self.scheduler.singleflight
        with self._lock:
            wall = (
                (self._t_last - self._t_first)
                if self._t_first is not None and self._t_last
                else 0.0
            )
            return self._agg.snapshot(wall, singleflight_waits=sf.waits)

    def drain(self, timeout: float | None = None) -> None:
        """Wait for every in-flight submission to finish."""
        with self._lock:
            pending = list(self._inflight)
        futures_wait(pending, timeout=timeout)

    def begin_shutdown(self) -> None:
        """Stop accepting submissions (``submit`` raises
        :class:`ServiceClosed`) while in-flight runs keep executing — the
        first half of a graceful SIGTERM: reject new, drain old."""
        with self._lock:
            self._draining = True

    def close(self) -> None:
        """Graceful, idempotent shutdown: reject new submissions, drain
        in-flight runs, release the pools."""
        self.begin_shutdown()
        with self._lock:
            if self._closed:
                return
            self._closed = True
        self.drain()
        self._coord_pool.shutdown(wait=True)
        self.scheduler.close()

    def __enter__(self) -> "WorkflowService":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()
