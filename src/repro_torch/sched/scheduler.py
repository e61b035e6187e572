"""Topological DAG scheduler with store-backed skipping and single-flight.

Execution of one :class:`DagWorkflow` run:

 1. *Plan* — step the storage policy over the DAG's root-to-sink path
    decomposition (one mined pipeline per path, Ch. 3.3), then mark every
    chain node whose artifact is live in the store as *loadable* and prune
    ancestors no needed node depends on — the DAG generalization of the
    sequential executor's prefix skip.
 2. *Dispatch* — submit ready nodes (all planned parents done) onto a shared
    worker pool; loads have no dependencies and overlap with computes.
 3. *Produce* — each chain node's load-or-compute runs under
    :class:`SingleFlight`, so concurrent runs needing the same prefix compute
    it exactly once; computed outputs the policy admitted flow through the
    same ``admit_and_store`` path (Eq. 4.9 gate + budget eviction) as the
    sequential executor.
 4. On a mid-run eviction race (planned load vanishes), the worker falls back
    to recomputing the chain inline, recursing through pruned ancestors.

Thread-safety invariants are documented in ``docs/scheduler.md``.

The port's copy differs at its tensor seam: a node's seconds end when the
card has finished its work (``wait_for_device`` on the worker thread's
current stream, where the reference calls ``jax.block_until_ready``), and
loads go to ``device`` ("cuda" unless the caller asks for the CPU).  Branches
run in pool threads; on one default stream their kernels queue behind each
other, so a branch's seconds also hold the kernels of any branch queued
before its own on that stream.
"""
from __future__ import annotations

import threading
import time
from concurrent.futures import FIRST_COMPLETED, Future, ThreadPoolExecutor, wait
from dataclasses import dataclass, field
from typing import Any

from ..core.backends import BackendUnavailable
from ..core.cost import CostModel
from ..obs import tracing as _tracing
from ..core.executor import _nbytes, admit_and_store, wait_for_device
from ..core.provenance import ProvenanceLog, RunRecord
from ..core.registry import ModuleRegistry
from ..core.risp import StoragePolicy, StoredRecord
from ..core.store import IntermediateStore
from ..core.workflow import ModuleRef, ModuleSpec, PrefixKey, Workflow
from .dag import DagWorkflow
from .dispatch import NodeDispatcher
from .singleflight import SingleFlight


class DagWorkflowError(RuntimeError):
    def __init__(self, message: str, dag: DagWorkflow, node_id: str, cause: Exception):
        super().__init__(message)
        self.dag = dag
        self.node_id = node_id
        self.cause = cause


@dataclass
class NodeResult:
    node_id: str
    module_id: str
    seconds: float  # wall time in this run (compute, load, or flight wait)
    source: str  # "computed" | "loaded" | "singleflight" | "pruned"
    key: str | None = None
    stored: bool = False


@dataclass
class DagRunResult:
    """Per-run stats, field-compatible with the sequential ``RunResult``."""

    output: Any  # sole sink's value, or dict {node_id: value} for multi-sink
    dag: DagWorkflow
    node_results: dict[str, NodeResult]
    module_seconds: list[float]  # topo order; 0.0 for skipped nodes
    reused_prefix: PrefixKey | None  # deepest chain prefix not recomputed
    load_seconds: float
    stored_keys: list[str]
    store_seconds: float
    total_seconds: float
    n_skipped: int  # nodes whose module fn did not run (loaded/waited/pruned)
    singleflight_waits: int = 0
    outputs: dict[str, Any] = field(default_factory=dict)  # all sink values

    @property
    def exec_seconds(self) -> float:
        return sum(self.module_seconds)

    @property
    def n_computed(self) -> int:
        return sum(1 for r in self.node_results.values() if r.source == "computed")


class _RunCtx:
    """Mutable per-run state shared by the dispatch loop and node workers."""

    def __init__(self, dag: DagWorkflow, data: Any):
        self.dag = dag
        self.data = data
        self.lock = threading.RLock()
        self.values: dict[str, Any] = {}
        self.node_results: dict[str, NodeResult] = {}
        self.module_seconds: dict[str, float] = {}
        self.load_s = 0.0
        self.store_s = 0.0
        self.stored_keys: list[str] = []
        self.sf_waits = 0
        # the run span, re-activated on every pool worker thread so node
        # spans (and the store/RPC spans beneath them) stitch to this run
        self.trace_parent: Any = None


@dataclass
class DagScheduler:
    """Dispatches ready DAG nodes onto a bounded worker pool.

    Shares ``store``/``policy``/``registry``/``cost_model`` with any number
    of concurrent ``run`` calls (and with sequential ``WorkflowExecutor``s
    built on the same objects).
    """

    store: IntermediateStore
    policy: StoragePolicy
    registry: ModuleRegistry = field(default_factory=ModuleRegistry)
    max_workers: int = 4
    admission: str = "always"  # "always" | "t1_gt_t2"
    provenance: ProvenanceLog | None = None
    cost_model: CostModel | None = None
    # pass a DistributedSingleFlight (repro.net) to extend the election
    # across processes sharing one remote store
    singleflight: SingleFlight = field(default_factory=SingleFlight)
    # optional ProcessPoolDispatcher: module fns execute in worker processes
    # (GIL escape); scheduling/store/admission stay in this process.  The
    # dispatcher's lifecycle belongs to its creator, not to close().
    dispatcher: NodeDispatcher | None = None
    # optional repro.catalog.Catalog (duck-typed; see admit_and_store)
    catalog: Any = None
    # where stored prefixes are loaded
    device: Any = "cuda"

    def __post_init__(self) -> None:
        if not isinstance(self.registry, ModuleRegistry):
            self.registry = ModuleRegistry(self.registry)
        if self.cost_model is None:
            self.cost_model = CostModel(store=self.store)
        if self.admission not in ("always", "t1_gt_t2"):
            raise ValueError(f"unknown admission mode {self.admission!r}")
        if self.max_workers < 1:
            raise ValueError("max_workers must be >= 1")
        self.store.add_evict_listener(self._on_store_evict)
        self._pool = ThreadPoolExecutor(
            max_workers=self.max_workers, thread_name_prefix="dag-node"
        )
        # store keys some run's policy step admitted but no one persisted yet.
        # Shared across runs: under single-flight, the leader that actually
        # computes a prefix may belong to a different run than the one whose
        # policy step admitted it — whoever computes it must store it.
        self._pending_lock = threading.Lock()
        self._pending_stores: set[str] = set()

    def _on_store_evict(self, key: str) -> None:
        # plain GIL-atomic pop: never take the policy lock from inside the
        # store lock (see docs/scheduler.md lock ordering); Catalog.discard
        # is in-memory only, so it is equally safe here
        self.policy.stored.pop(key, None)
        if self.catalog is not None:
            self.catalog.discard(key)

    def close(self) -> None:
        self._pool.shutdown(wait=True)
        self.store.remove_evict_listener(self._on_store_evict)

    # -- registration (delegates to the shared registry) ----------------------
    def register(self, spec: ModuleSpec) -> None:
        self.registry.register(spec)

    def register_fn(self, module_id: str, fn, **default_params) -> None:
        self.registry.register_fn(module_id, fn, **default_params)

    def dag(self, dataset_id: str, workflow_id: str = "") -> DagWorkflow:
        """A DAG builder whose tool states resolve through this registry."""
        return DagWorkflow(dataset_id, workflow_id, registry=self.registry)

    def _params_for(self, ref: ModuleRef) -> dict[str, Any]:
        return self.registry.resolve_params(ref)

    # -- execution -----------------------------------------------------------
    def run(self, dag: DagWorkflow | Workflow, data: Any) -> DagRunResult:
        if isinstance(dag, Workflow):
            dag = DagWorkflow.from_workflow(dag, registry=self.registry)
        dag.validate()
        with _tracing.span(
            "sched.run", kind="run", workflow=dag.workflow_id or dag.dataset_id
        ) as run_sp:
            result = self._run_traced(dag, data, run_sp)
            run_sp.set(
                n_skipped=result.n_skipped,
                stored=len(result.stored_keys),
                sf_waits=result.singleflight_waits,
            )
        return result

    def _run_traced(self, dag: DagWorkflow, data: Any, run_sp: Any) -> DagRunResult:
        t_start = time.perf_counter()
        order = dag.topo_order()
        with_state = self.policy.with_state

        # 1) policy bookkeeping over the path decomposition, then plan
        rec = self.policy.step_paths(dag.paths())
        chain_prefix = {n: dag.chain_prefix(n) for n in order}
        chain_keys = {
            p.key(with_state): n for n, p in chain_prefix.items() if p is not None
        }
        # only prefixes that name an actual chain node are storable; fan-in
        # path prefixes must not linger in policy bookkeeping as "stored"
        non_chain: list[str] = []
        for prefix in rec.store:
            key = prefix.key(with_state)
            if key in chain_keys:
                with self._pending_lock:
                    self._pending_stores.add(key)
            else:
                non_chain.append(key)

        # every presence question this plan needs — each node's chain-prefix
        # loadability plus the non-chain bookkeeping probes — in ONE batched
        # round trip to the pool instead of one per node
        probe_keys = [
            p.key(with_state) for p in chain_prefix.values() if p is not None
        ] + non_chain
        with _tracing.span("probe.plan", kind="probe", depth=len(probe_keys)) as psp:
            states = self.store.has_state_many(probe_keys)
            psp.set(present=sum(1 for s in states.values() if s == "present"))
        for key in non_chain:
            if states.get(key) == "absent":
                # authoritative absence only: an unreachable artifact keeps
                # its bookkeeping (shard death is not eviction)
                self.policy.stored.pop(key, None)
        loadable = {
            n: p is not None and states.get(p.key(with_state)) == "present"
            for n, p in chain_prefix.items()
        }
        sinks = set(dag.sinks())
        children = {n: dag.children_of(n) for n in order}
        needed: set[str] = set()
        for n in reversed(order):
            if n in sinks or any(
                c in needed and not loadable[c] for c in children[n]
            ):
                needed.add(n)

        # 2) dispatch ready planned nodes onto the pool
        ctx = _RunCtx(dag, data)
        ctx.trace_parent = run_sp if isinstance(run_sp, _tracing.Span) else None
        planned = [n for n in order if n in needed]
        remaining = {
            n: (0 if loadable[n] else len(dag.parents_of(n))) for n in planned
        }
        ready = [n for n in planned if remaining[n] == 0]
        inflight: dict[Future, str] = {}
        failure: tuple[str, Exception] | None = None
        while ready or inflight:
            if failure is None:
                for n in ready:
                    inflight[self._pool.submit(self._materialize, ctx, n)] = n
            ready = []
            if not inflight:
                break
            done, _ = wait(inflight, return_when=FIRST_COMPLETED)
            for fut in done:
                n = inflight.pop(fut)
                try:
                    fut.result()
                except DagWorkflowError as e:
                    # a single-flight follower re-raises the leader's error,
                    # possibly naming a node of another run's DAG — map it to
                    # the local node that waited on the flight
                    local = e.node_id if e.node_id in dag else n
                    failure = failure or (local, e.cause)
                    continue
                except Exception as e:  # noqa: BLE001 - surfaced below
                    failure = failure or (n, e)
                    continue
                for c in children[n]:
                    if c in remaining and not loadable[c]:
                        remaining[c] -= 1
                        if remaining[c] == 0 and failure is None:
                            ready.append(c)
        if failure is not None:
            node_id, cause = failure
            self._persist_recovery_points(ctx, node_id)
            raise DagWorkflowError(
                f"node {node_id!r} ({dag.ref(node_id).module_id}) failed: {cause}",
                dag,
                node_id,
                cause,
            ) from cause

        # pending-store requests satisfied meanwhile (by this run's loads or
        # another run's store) are dropped so the set tracks only keys still
        # owed a store attempt — it must not grow across a service's lifetime
        with self._pending_lock:
            satisfied = {k for k in self._pending_stores if self.store.has(k)}
            self._pending_stores -= satisfied

        # 3) assemble RunResult-compatible stats
        for n in order:
            if n not in ctx.node_results:
                prefix = chain_prefix[n]
                ctx.node_results[n] = NodeResult(
                    n,
                    dag.ref(n).module_id,
                    0.0,
                    "pruned",
                    prefix.key(with_state) if prefix else None,
                )
        reused: PrefixKey | None = None
        for n in order:
            r = ctx.node_results[n]
            p = chain_prefix[n]
            if p is not None and r.source in ("loaded", "singleflight"):
                if reused is None or p.depth > reused.depth:
                    reused = p
        outputs = {s: ctx.values[s] for s in dag.sinks() if s in ctx.values}
        module_seconds = [ctx.module_seconds.get(n, 0.0) for n in order]
        n_computed = sum(
            1 for r in ctx.node_results.values() if r.source == "computed"
        )
        total = time.perf_counter() - t_start
        result = DagRunResult(
            output=next(iter(outputs.values())) if len(outputs) == 1 else outputs,
            dag=dag,
            node_results=ctx.node_results,
            module_seconds=module_seconds,
            reused_prefix=reused,
            load_seconds=ctx.load_s,
            stored_keys=ctx.stored_keys,
            store_seconds=ctx.store_s,
            total_seconds=total,
            n_skipped=len(order) - n_computed,
            singleflight_waits=ctx.sf_waits,
            outputs=outputs,
        )
        if self.provenance is not None:
            n_loaded = sum(
                1 for r in ctx.node_results.values() if r.source == "loaded"
            )
            self.provenance.append(
                RunRecord(
                    workflow_id=dag.workflow_id,
                    dataset_id=dag.dataset_id,
                    modules=dag.module_keys(),
                    module_seconds=module_seconds,
                    reused_prefix_depth=reused.depth if reused else 0,
                    load_seconds=ctx.load_s,
                    stored_keys=list(ctx.stored_keys),
                    store_seconds=ctx.store_s,
                    total_seconds=total,
                    n_requests=n_computed + len(ctx.stored_keys) + n_loaded,
                    extra={"scheduler": "dag", "workers": self.max_workers},
                )
            )
        return result

    # -- node production ------------------------------------------------------
    def _materialize(self, ctx: _RunCtx, node_id: str) -> Any:
        """Value of ``node_id`` within this run: memo -> single-flight
        load-or-compute -> recursive parent materialization."""
        with ctx.lock:
            if node_id in ctx.values:
                return ctx.values[node_id]
        prefix = ctx.dag.chain_prefix(node_id)
        key = prefix.key(self.policy.with_state) if prefix is not None else None
        t0 = time.perf_counter()
        # pool threads carry no context — stitch node spans to the run span
        # explicitly; recursive materialization inherits the caller's span
        par = _tracing.current_span() or ctx.trace_parent
        with _tracing.span(
            "node",
            kind="node",
            parent=par,
            node=node_id,
            module=ctx.dag.ref(node_id).module_id,
        ) as nsp:
            if key is not None:
                (source, value), leader = self.singleflight.run(
                    key, lambda: self._produce(ctx, node_id, prefix, key)
                )
                if not leader:
                    source = "singleflight"
                    with ctx.lock:
                        ctx.sf_waits += 1
            else:
                source, value = self._produce(ctx, node_id, None, None)
            nsp.set(source=source)
        dt = time.perf_counter() - t0
        with ctx.lock:
            ctx.values[node_id] = value
            res = ctx.node_results.setdefault(
                node_id,
                NodeResult(node_id, ctx.dag.ref(node_id).module_id, dt, source, key),
            )
            res.seconds = dt
            res.source = source
            res.stored = key in ctx.stored_keys if key else False
        return value

    def _produce(
        self, ctx: _RunCtx, node_id: str, prefix: PrefixKey | None, key: str | None
    ) -> tuple[str, Any]:
        # a) live artifact: load instead of computing
        if key is not None and self.store.has(key):
            t0 = time.perf_counter()
            try:
                value = self.store.get(key, self.device)
            except KeyError:  # evicted between has() and get()
                self.policy.stored.pop(key, None)
            except BackendUnavailable:
                # the artifact's shard(s) died between has() and get(): the
                # bytes may still exist, so keep all bookkeeping and simply
                # recompute this chain inline — same fallback as eviction
                pass
            else:
                with self._pending_lock:  # store request satisfied by the load
                    self._pending_stores.discard(key)
                if self.catalog is not None:  # refresh reuse counters for ranking
                    self.catalog.touch(key, self.store.records.get(key))
                with ctx.lock:
                    ctx.load_s += time.perf_counter() - t0
                return "loaded", value
        # b) compute from parents (recursing through pruned ancestors if a
        #    planned load vanished under us)
        parents = ctx.dag.parents_of(node_id)
        if not parents:
            inp: Any = ctx.data
        elif len(parents) == 1:
            inp = self._materialize(ctx, parents[0])
        else:
            inp = tuple(self._materialize(ctx, p) for p in parents)
        ref = ctx.dag.ref(node_id)
        spec = self.registry[ref.module_id]
        params = self._params_for(ref)
        t0 = time.perf_counter()
        try:
            if self.dispatcher is not None and self.dispatcher.accepts(
                ref.module_id
            ):
                value = self.dispatcher.invoke(ref.module_id, params, inp)
            else:
                value = spec.fn(inp, **params)
            value = wait_for_device(value)
        except DagWorkflowError:
            raise
        except Exception as e:  # noqa: BLE001 - module code is user code
            raise DagWorkflowError(
                f"node {node_id!r} ({ref.module_id}) failed: {e}", ctx.dag, node_id, e
            ) from e
        dt = time.perf_counter() - t0
        assert self.cost_model is not None
        self.cost_model.observe(ref, dt, _nbytes(value))
        with ctx.lock:
            ctx.module_seconds[node_id] = dt
        # c) policy-admitted chain outputs flow through the standard
        #    store/eviction admission path (one attempt per admitted key,
        #    performed by whichever run's leader computed the value)
        if key is not None:
            with self._pending_lock:
                should_store = key in self._pending_stores
                self._pending_stores.discard(key)
            if should_store:
                chain = ctx.dag.chain_nodes(node_id) or ()
                with ctx.lock:
                    measured = sum(ctx.module_seconds.get(n, 0.0) for n in chain)
                skey, ssec = admit_and_store(
                    self.store,
                    self.policy,
                    self.cost_model,
                    self.admission,
                    prefix,
                    value,
                    measured or None,
                    catalog=self.catalog,
                )
                with ctx.lock:
                    ctx.store_s += ssec
                    if skey is not None:
                        ctx.stored_keys.append(skey)
        return "computed", value

    # -- error recovery -------------------------------------------------------
    def _persist_recovery_points(self, ctx: _RunCtx, failed_node: str) -> None:
        """Persist the failed node's already-computed chain parents so a
        retried run restarts at the failure point (thesis Ch. 3.5.2)."""
        for p in ctx.dag.parents_of(failed_node):
            prefix = ctx.dag.chain_prefix(p)
            with ctx.lock:
                value = ctx.values.get(p)
            if prefix is None or value is None:
                continue
            key = prefix.key(self.policy.with_state)
            state = self.store.has_state(key)
            if state == "unreachable":
                # pool gone: a put would fail (masking the node error being
                # recovered), and claiming the prefix as stored without
                # bytes anywhere would be a phantom — skip both
                continue
            if state == "absent":
                self.store.put(key, value)
                if self.catalog is not None:
                    self.catalog.publish(prefix, key, self.store.records.get(key))
            self.policy.stored.setdefault(
                key, StoredRecord(prefix, self.policy.n_pipelines)
            )
