"""One front door for the whole system.

Before ``repro_torch.api``, running a workflow meant choosing between three
disjoint entry points — ``WorkflowExecutor`` (sequential), ``WorkflowService``
(concurrent DAGs), ``ServeEngine`` (serving) — each with its own module
bookkeeping.  :class:`Client` wires store + policy + eviction + cost model +
registry + both execution engines in one constructor, and accepts the same
declarative :class:`~repro_torch.api.spec.WorkflowSpec` everywhere.  Because both
engines share one :class:`~repro_torch.core.registry.ModuleRegistry` and one
``StoragePolicy``, a prefix stored by a sequential ``run`` is reused by a
concurrent ``submit`` of an equivalent spec (and vice versa) — the store
keys are identical by construction.

``recommend`` exposes the thesis' Ch. 4 recommendation pipeline over the
same mined history: feed it a partial spec while composing and it returns
ranked reusable-prefix and next-module suggestions.
"""
from __future__ import annotations

import tempfile
import threading
import time
from concurrent.futures import Future
from typing import Any, Callable, Iterable, Mapping, Sequence

from ..core.backends import BackendUnavailable
from ..core.cost import CostModel
from ..core.executor import RunResult, WorkflowExecutor
from ..core.provenance import ProvenanceLog
from ..core.registry import ModuleRegistry
from ..core.risp import StoragePolicy, make_policy
from ..core.store import IntermediateStore
from ..core.workflow import ModuleRef, ModuleSpec, Workflow
from ..obs import tracing as _tracing
from ..obs.metrics import MetricsRegistry, merge_docs
from ..sched.dag import DagWorkflow
from ..sched.dispatch import NodeDispatcher
from ..sched.scheduler import DagRunResult
from ..catalog import Catalog, CatalogRecord, rank_key
from ..sched.service import WorkflowService
from ..sched.singleflight import SingleFlight
from ..sched.stats import AggregateStats
from .recommend import RecommendReport, Recommender
from .spec import WorkflowSpec, check_namespace, namespaced_dataset


class Client:
    """Unified facade over the sequential executor and the DAG scheduler.

    Parameters
    ----------
    root: directory for the default ``IntermediateStore`` (a temp dir when
        neither ``root`` nor ``store`` nor ``store_url`` is given — handy
        for demos/tests).
    store_url: ``tcp://host:port`` of a ``repro_torch.net`` store server.  The
        client then mounts the *shared* artifact pool through a read-through
        ``CachingBackend`` over a ``RemoteBackend``, subscribes to the
        server's eviction-event stream (keeping ``policy.stored`` and the
        cache consistent with fleet-wide evictions), and upgrades the
        scheduler's single-flight to the server's lease table so N client
        processes compute an uncomputed prefix exactly once.  A
        comma-separated list (``"h:7077,h:7078,h:7079"``) mounts the pool in
        **cluster mode** instead: a ``ShardedBackend`` routes every key over
        a consistent-hash ring of the listed servers with ``replication``
        copies, failover reads, read-repair, and ring-aware lease election
        (see ``docs/remote.md``, "Cluster mode").  Mutually exclusive with
        ``root``/``store``.
    replication: replica count per artifact in cluster mode (default 2,
        clamped to the shard count) — ``R>=2`` survives a shard death
        mid-run with no artifact loss.  Only valid with a multi-endpoint
        ``store_url``.
    store: pre-built store; mutually exclusive with ``root``/``capacity_bytes``
        /``eviction``/``codec``.
    policy: a ``StoragePolicy`` instance or a policy name
        (``"PT"``/``"TSAR"``/``"TSPAR"``/``"TSFR"``); names are instantiated
        with ``with_state``.
    registry: shared ``ModuleRegistry`` (or a plain dict, adopted by
        reference).  Pass the same registry to several clients/engines to
        share one module universe.
    max_workers: DAG scheduler worker-pool size.
    admission: ``"always"`` or the Eq. 4.9 cost gate ``"t1_gt_t2"``.
    cache_bytes: local read-through cache budget (``store_url`` mode only).
    dispatcher: optional ``repro_torch.sched.ProcessPoolDispatcher`` — module
        computes escape onto worker processes (the caller owns its
        lifecycle).
    namespace: default artifact namespace.  Specs that don't carry their own
        namespace are rebound to this one before resolving ``PrefixKey``s, so
        everything this client stores lives under
        ``<namespace>/<dataset_id>`` — the isolation unit the gateway maps
        tenants onto.  Empty (the default) keeps the legacy un-namespaced
        keys.
    max_pending: bound on scheduler submissions in flight (queued + running);
        when saturated, ``submit`` raises
        :class:`~repro_torch.sched.service.AdmissionRejected` instead of queueing
        unboundedly.  ``None`` (default) keeps the unbounded legacy behavior.
    device: where both engines load reused prefixes (``"cuda"`` unless the
        caller asks for the CPU); ``serve_engine`` takes its own ``device``
        through ``engine_kw``.
    """

    def __init__(
        self,
        root: str | None = None,
        *,
        store: IntermediateStore | None = None,
        store_url: str | None = None,
        policy: StoragePolicy | str = "PT",
        with_state: bool = True,
        registry: ModuleRegistry | Mapping[str, ModuleSpec] | None = None,
        admission: str = "always",
        capacity_bytes: int | None = None,
        eviction: str | None = None,
        codec: str | None = None,
        max_workers: int = 4,
        max_concurrent_runs: int = 32,
        provenance: ProvenanceLog | None = None,
        cache_bytes: int = 64 * 1024 * 1024,
        client_id: str | None = None,
        replication: int | None = None,
        dispatcher: "NodeDispatcher | None" = None,
        namespace: str = "",
        max_pending: int | None = None,
        device: Any = "cuda",
    ) -> None:
        self.namespace = check_namespace(namespace)
        self._remote: "RemoteBackend | ShardedBackend | None" = None
        singleflight: "SingleFlight | None" = None
        # one metrics registry for every layer this client wires together
        # (store, cache, shards, single-flight, service) — a pre-built store
        # brings its own, which we adopt so all series still co-reside
        metrics = store.metrics if store is not None else MetricsRegistry()
        self.metrics = metrics
        if store_url is None and replication is not None:
            raise ValueError("replication only applies to a store_url cluster mount")
        if store_url is not None:
            if store is not None or root is not None:
                raise ValueError(
                    "store_url mounts a remote pool; don't also pass store/root"
                )
            # local import: repro_torch.api stays importable without repro_torch.net only
            # in spirit — net has no extra deps, but the seam keeps layering
            # one-directional (api -> net, never net -> api)
            from ..net import (
                CachingBackend,
                DistributedSingleFlight,
                RemoteBackend,
                ShardedBackend,
            )

            if "," in store_url:
                self._remote = ShardedBackend(
                    store_url,
                    replication=replication if replication is not None else 2,
                    client_id=client_id,
                    registry=metrics,
                )
            else:
                if replication is not None:
                    raise ValueError(
                        "replication is a cluster-mode option; it needs a "
                        "multi-endpoint store_url (\"h:p1,h:p2,…\")"
                    )
                self._remote = RemoteBackend(
                    store_url, client_id=client_id, registry=metrics
                )
            cache = CachingBackend(
                self._remote, capacity_bytes=cache_bytes, registry=metrics
            )
            store = IntermediateStore(
                backend=cache,
                capacity_bytes=capacity_bytes,
                eviction=eviction if eviction is not None else "gain_loss",
                codec=codec,
                registry=metrics,
            )
            # fleet-wide evictions: purge the cache first, then drop local
            # records + policy bookkeeping via the store's listeners
            def _on_event(event: str, key: str, _cache=cache, _store=store) -> None:
                if event == "evicted":
                    _cache.invalidate(key)
                    _store.on_external_evict(key)

            self._remote.add_event_listener(_on_event)
            singleflight = DistributedSingleFlight(
                self._remote, stored_fn=store.has, registry=metrics
            )
        elif store is None:
            if root is None:
                root = tempfile.mkdtemp(prefix="repro-store-")
            store = IntermediateStore(
                root,
                capacity_bytes=capacity_bytes,
                eviction=eviction if eviction is not None else "gain_loss",
                codec=codec,
                registry=metrics,
            )
        elif any(v is not None for v in (root, capacity_bytes, eviction, codec)):
            raise ValueError(
                "a pre-built store already fixes root/capacity_bytes/eviction/"
                "codec; pass either the store or those options, not both"
            )
        if isinstance(policy, str):
            policy = make_policy(policy, with_state=with_state)
        self.store = store
        self.policy = policy
        self.registry = (
            registry
            if isinstance(registry, ModuleRegistry)
            else ModuleRegistry(registry)
        )
        cost_model = CostModel(store=store)
        # provenance catalog: local query index mirrored to the remote pool
        # (server- or cluster-side) when one is mounted, so the index
        # survives client churn.  Mirrors through the RAW remote backend, not
        # the read-through cache wrapper — catalog ops are not blob ops.
        self.catalog = Catalog(
            self._remote if self._remote is not None else store.backend
        )
        self.executor = WorkflowExecutor(
            store=store,
            policy=policy,
            registry=self.registry,
            admission=admission,
            provenance=provenance,
            cost_model=cost_model,
            catalog=self.catalog,
            device=device,
        )
        self.service = WorkflowService(
            store=store,
            policy=policy,
            registry=self.registry,
            max_workers=max_workers,
            admission=admission,
            provenance=provenance,
            cost_model=cost_model,
            max_concurrent_runs=max_concurrent_runs,
            singleflight=singleflight,
            dispatcher=dispatcher,
            max_pending=max_pending,
            catalog=self.catalog,
            device=device,
        )
        self.recommender = Recommender(policy, store, catalog=self.catalog)
        # client-level aggregate stats spanning BOTH engines (the service's
        # own tally covers only submit()-path runs)
        self._lock = threading.Lock()
        self._agg = AggregateStats()
        self._t_first: float | None = None
        self._t_last = 0.0
        self._closed = False

    def _bind_namespace(self, spec: WorkflowSpec) -> WorkflowSpec:
        """Apply the client's default namespace to specs that carry none
        (a spec's own namespace always wins)."""
        if self.namespace and not spec.namespace:
            return spec.with_namespace(self.namespace)
        return spec

    # -- registration ----------------------------------------------------------
    def module(
        self,
        module_id: str | None = None,
        *,
        cost_hint: float | None = None,
        **default_params: Any,
    ) -> Callable[[Callable[..., Any]], Callable[..., Any]]:
        """``@client.module("normalize")`` decorator (see
        :meth:`ModuleRegistry.module`)."""
        return self.registry.module(
            module_id, cost_hint=cost_hint, **default_params
        )

    def register(self, spec: ModuleSpec) -> None:
        self.registry.register(spec)

    def register_fn(self, module_id: str, fn, **default_params) -> None:
        self.registry.register_fn(module_id, fn, **default_params)

    # -- spec construction ------------------------------------------------------
    def spec(self, dataset_id: str, workflow_id: str = "") -> WorkflowSpec:
        """An empty :class:`WorkflowSpec` builder (validated against this
        client's registry at run time)."""
        return WorkflowSpec(dataset_id, workflow_id)

    # -- bookkeeping ------------------------------------------------------------
    def _mark_start(self) -> None:
        with self._lock:
            if self._t_first is None:
                self._t_first = time.perf_counter()

    def _record(self, result: RunResult | DagRunResult | None, failed: bool) -> None:
        with self._lock:
            self._t_last = time.perf_counter()
            if failed or result is None:
                self._agg.failures += 1
            else:
                self._agg.add_run(result)

    # -- execution ---------------------------------------------------------------
    def run(
        self,
        spec: WorkflowSpec | Workflow | DagWorkflow,
        data: Any,
    ) -> RunResult | DagRunResult:
        """Blocking run.  Linear specs (and ``Workflow``s) execute on the
        sequential executor; DAG-shaped specs go through the scheduler.
        Either way the artifacts land under the same ``PrefixKey``s."""
        self._mark_start()
        if isinstance(spec, WorkflowSpec):
            spec = self._bind_namespace(spec)
            if spec.is_linear:
                runnable: Workflow | DagWorkflow = spec.to_workflow(self.registry)
            else:
                runnable = spec.to_dag(self.registry)
        else:
            runnable = spec
        try:
            if isinstance(runnable, Workflow):
                result: RunResult | DagRunResult = self.executor.run_workflow(
                    runnable, data
                )
            else:
                result = self.service.scheduler.run(runnable, data)
        except Exception:
            self._record(None, failed=True)
            raise
        self._record(result, failed=False)
        return result

    def submit(
        self,
        spec: WorkflowSpec | Workflow | DagWorkflow,
        data: Any,
        on_state: Callable[[str], None] | None = None,
        trace: "_tracing.TraceContext | None" = None,
    ) -> "Future[DagRunResult]":
        """Non-blocking submission onto the shared scheduler (chains run as
        chain DAGs).  Returns the run's future.  ``on_state`` (if given) is
        forwarded to :meth:`WorkflowService.submit` — it fires with
        ``"started"`` when a coordinator picks the run up and
        ``"finished"``/``"failed"`` when it completes.  ``trace`` parents the
        run's span under an inbound trace context (e.g. a gateway request);
        without it the service mints a fresh trace when tracing is enabled.
        The returned future carries the run's ``trace_id`` attribute."""
        self._mark_start()
        if isinstance(spec, WorkflowSpec):
            dag = self._bind_namespace(spec).to_dag(self.registry)
        elif isinstance(spec, Workflow):
            dag = DagWorkflow.from_workflow(spec, registry=self.registry)
        else:
            dag = spec
        fut = self.service.submit(dag, data, on_state=on_state, trace=trace)

        def _done(f: "Future[DagRunResult]") -> None:
            try:
                self._record(f.result(), failed=False)
            except Exception:  # noqa: BLE001 - delivered via the future
                self._record(None, failed=True)

        fut.add_done_callback(_done)
        return fut

    def run_steps(
        self,
        dataset_id: str,
        data: Any,
        steps: Sequence[str | tuple[str, Mapping[str, Any] | None]],
        workflow_id: str = "",
    ) -> RunResult | DagRunResult:
        """Linear-pipeline shorthand."""
        return self.run(WorkflowSpec.from_steps(dataset_id, steps, workflow_id), data)

    # -- history / recommendation ------------------------------------------------
    def observe(self, wf: WorkflowSpec | Workflow) -> None:
        """Feed one workflow into the mined history *without executing it* —
        the thesis' replay protocol (Ch. 4.5.1), used to warm the
        recommendation surface from an existing corpus.

        The policy's miner and replay counters advance exactly as if the
        workflow had run, but store admissions it claims are pruned again
        when no artifact exists: replayed history must not make real runs
        believe (and skip storing) artifacts that were never persisted.
        """
        if isinstance(wf, WorkflowSpec):
            rec = self.policy.step_paths(
                self._bind_namespace(wf).to_dag(self.registry, strict=False).paths()
            )
        else:
            rec = self.policy.step(wf)
        for prefix in rec.store:
            key = prefix.key(self.policy.with_state)
            if self.store.has_state(key) == "absent":
                # GIL-atomic pop without the policy lock (same pattern as the
                # store's evict listeners; see the documented lock order).
                # Authoritative absence only: unreachable shards are not
                # evidence the replayed artifact never existed.
                self.policy.stored.pop(key, None)

    def replay(self, corpus: Iterable[WorkflowSpec | Workflow]) -> int:
        """Observe a whole corpus; returns the number of workflows replayed."""
        n = 0
        for wf in corpus:
            self.observe(wf)
            n += 1
        return n

    def recommend(
        self,
        partial: WorkflowSpec | Workflow | str,
        modules: Sequence[ModuleRef] = (),
        top_k: int = 5,
    ) -> RecommendReport:
        """Ranked suggestions while composing a workflow.

        ``partial`` is a linear (possibly empty) :class:`WorkflowSpec`, a
        :class:`Workflow`, or a bare dataset id (then ``modules`` supplies
        the chain built so far).  Returns reusable-prefix suggestions
        (deepest skip points, flagged when the artifact is live) and
        next-module suggestions mined from the observed corpus.
        """
        if isinstance(partial, str):
            # bare dataset ids are composed with the client's default
            # namespace (pass an already-composed id to escape)
            dataset_id = namespaced_dataset(self.namespace, partial)
            chain = tuple(modules)
        elif isinstance(partial, Workflow):
            dataset_id, chain = partial.dataset_id, partial.modules
        else:
            partial = self._bind_namespace(partial)
            dataset_id = partial.effective_dataset_id
            if len(partial) == 0:
                chain = ()
            else:
                chain = partial.to_workflow(self.registry, strict=False).modules
        return self.recommender.recommend(dataset_id, chain, top_k=top_k)

    def find(
        self,
        module: str | None = None,
        params: Mapping[str, Any] | None = None,
        dataset: str | None = None,
        namespace: str | None = None,
        *,
        any_position: bool = False,
        limit: int = 20,
        verify: bool = True,
    ) -> list[CatalogRecord]:
        """Query the provenance catalog: which stored artifacts were produced
        by ``module`` with these (decoded) ``params``, for this ``dataset``,
        in this ``namespace``?

        Matching is against the *terminal* module of each artifact's chain
        unless ``any_position=True``.  ``namespace=None`` scopes to this
        client's bound namespace (or any, when the client is un-namespaced);
        pass ``"*"`` to search across namespaces explicitly, or ``""`` for
        the un-namespaced pool only.  Results merge the local index with the
        remote pool's (server/cluster) index when one is mounted, ranked by
        reuse count, then chain depth, then recency.

        With ``verify=True`` (default) every candidate is checked against
        the store in one batched presence probe; only artifacts readable
        *right now* survive — the zero-phantom guarantee: ``find`` never
        reports an evicted artifact.  Authoritative absences additionally
        prune the catalog; candidates whose every replica is unreachable are
        dropped from the answer but kept indexed (the artifact may well
        exist; only its shards are down).
        """
        if namespace is None:
            ns = self.namespace if self.namespace else "*"
        else:
            ns = namespace
        hits = self.catalog.find(
            module=module,
            params=dict(params) if params else None,
            dataset=dataset,
            namespace=None if ns == "*" else ns,
            any_position=any_position,
            limit=limit,
        )
        if not verify or not hits:
            return hits
        presence = self.store.has_state_many([r.key for r in hits])
        kept = self.catalog.verify_present(hits, presence)
        # fold in the local store's live stats (loads observed by THIS
        # process since the record was published) so ranking reflects the
        # freshest counters we can see
        merged: list[CatalogRecord] = []
        for rec in kept:
            art = self.store.records.get(rec.key)
            if art is not None and (
                art.n_loads > rec.n_loads or art.last_used_at > rec.last_used_at
            ):
                rec = CatalogRecord(
                    key=rec.key,
                    namespace=rec.namespace,
                    dataset=rec.dataset,
                    modules=rec.modules,
                    states=rec.states,
                    nbytes=rec.nbytes,
                    compute_s=rec.compute_s,
                    created_at=rec.created_at,
                    last_used_at=max(rec.last_used_at, art.last_used_at),
                    n_loads=max(rec.n_loads, art.n_loads),
                )
            merged.append(rec)
        merged.sort(key=rank_key)
        return merged

    # -- serving -----------------------------------------------------------------
    def serve_engine(
        self,
        cfg: Any,
        params: Any,
        *,
        dataset_id: str = "prompts",
        policy: "StoragePolicy | None" = None,
        snapshot_budget_bytes: int | None = None,
        snapshot_codec: str | None = "none",
        ledger: Any = None,
        tenant: str | None = None,
        **engine_kw: Any,
    ) -> "Any":
        """Mount a :class:`~repro_torch.serve.ServeEngine` on this client's fabric.

        The engine's KV-prefix snapshots become first-class artifacts on the
        client's backend (local store dir, remote pool, or shard cluster —
        read through the same hot cache workflow artifacts use), encoded by
        the deterministic KV codec and published to the provenance catalog.
        With a remote mount, prefill is a *coordinated compute*: the
        store-server lease table elects exactly one prefiller per shared
        prompt prefix fleet-wide (followers block, then load the leader's
        snapshot), and fleet eviction events keep every engine's
        ``policy.stored`` free of phantoms.

        ``dataset_id`` is composed with the client's namespace, so snapshot
        keys are tenant-scoped exactly like workflow artifacts.  ``ledger``
        (a :class:`~repro_torch.sched.stats.TenantLedger`) bills stored snapshot
        bytes to ``tenant`` (default: the client's namespace) and is credited
        on every eviction path.  Remaining ``engine_kw`` (``max_len``,
        ``chunk``, ``greedy``, ...) pass through to ``ServeEngine``.
        """
        from ..core.risp import RISP
        from ..serve import FabricSnapshotStore, ServeEngine

        snapshots = FabricSnapshotStore(
            self.store.backend,
            capacity_bytes=snapshot_budget_bytes,
            codec=snapshot_codec,
            registry=self.metrics,
            catalog=self.catalog,
            ledger=ledger,
            tenant=tenant if tenant is not None else (self.namespace or ""),
            events_from=self._remote,
        )
        if self._remote is not None:
            from ..net import DistributedSingleFlight

            flight: SingleFlight = DistributedSingleFlight(
                self._remote, stored_fn=snapshots.contains, registry=self.metrics
            )
        else:
            # still coalesces concurrent identical prefixes in-process
            flight = SingleFlight(registry=self.metrics)
        return ServeEngine(
            cfg=cfg,
            params=params,
            policy=policy if policy is not None else RISP(),
            registry=self.registry,
            snapshots=snapshots,
            flight=flight,
            metrics=self.metrics,
            dataset_id=namespaced_dataset(self.namespace, dataset_id),
            **engine_kw,
        )

    # -- reporting / lifecycle -----------------------------------------------------
    def stats(self) -> AggregateStats:
        """Aggregate throughput/reuse across BOTH engines (sequential runs +
        scheduler submissions), in the same shape ``WorkflowService.stats``
        and ``ServeEngine.aggregate_stats`` report."""
        sf = self.service.scheduler.singleflight
        with self._lock:
            wall = (
                (self._t_last - self._t_first)
                if self._t_first is not None and self._t_last
                else 0.0
            )
            return self._agg.snapshot(wall, singleflight_waits=sf.waits)

    def metrics_doc(self) -> dict[str, Any]:
        """Fabric-wide metrics document: this process's registry (store,
        cache, shards-as-seen-from-here, scheduler, single-flight) merged
        with the server-side registries of every reachable store server when
        a remote pool is mounted.  Server series arrive stamped with a
        ``shard`` label so gauges from different processes never collapse
        into one meaningless sum.  Render with
        :func:`repro_torch.obs.metrics.render_prometheus`."""
        docs: list[dict[str, Any]] = [self.metrics.to_doc()]
        extras: list[dict[str, str] | None] = [None]
        remote = self._remote
        if remote is not None:
            try:
                server_doc = remote.metrics_doc()
            except BackendUnavailable:
                server_doc = None
            if server_doc:
                docs.append(server_doc)
                # ShardedBackend stamps per-shard labels itself; a single
                # RemoteBackend's doc still needs its endpoint stamped here
                extras.append(
                    None
                    if hasattr(remote, "_shards")
                    else {"shard": f"{remote.host}:{remote.port}"}
                )
        return merge_docs(docs, extras)

    def drain(self, timeout: float | None = None) -> None:
        self.service.drain(timeout)

    def close(self) -> None:
        """Idempotent teardown: drain the service, flush the store, release
        any remote mount.  Safe to call repeatedly (and from ``__exit__``
        after an explicit close)."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
        self.service.close()
        self.store.flush()
        self.catalog.close()
        if self._remote is not None:
            self._remote.close()

    def __enter__(self) -> "Client":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()
