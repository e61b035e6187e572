"""Prefix-skipping workflow executor with RISP-guided storing + error recovery.

Execution of a pipeline ``D -> M1 -> ... -> Mn``:

 1. Ask the storage policy for the longest previously-stored prefix whose
    artifact is still present in the store; load it and skip those modules
    (thesis Ch. 3: "skipping procedure ... increases the flexibility and
    reusability to analyze fractions of pipelines in low cost").
 2. Execute the remaining modules, timing each (block_until_ready).
 3. Store whatever the policy admits — optionally gated by the Eq. 4.9 cost
    test (admission="t1_gt_t2").
 4. On module failure, persist the last good intermediate state so a resumed
    run restarts at the failure point (thesis Ch. 3.5.2 error recovery).

The port's copy differs at its tensor seam: a module's seconds end when the
card has finished its work (``wait_for_device``, where the reference calls
``jax.block_until_ready``), so ``compute_seconds`` (the gain in gain-loss
eviction and the t1 of Eq. 4.9) is device time, not the host's launch time;
values are nested dicts, lists and tuples of tensors; reused prefixes load
onto ``device`` ("cuda" unless the caller asks for the CPU).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Mapping, Sequence

import torch

from ..obs import tracing as _tracing
from ..tree import leaves as tree_leaves
from .backends import BackendUnavailable
from .cost import CostModel
from .provenance import ProvenanceLog, RunRecord
from .registry import ModuleRegistry
from .risp import Recommendation, StoragePolicy, StoredRecord
from .store import IntermediateStore
from .workflow import ModuleRef, ModuleSpec, PrefixKey, Workflow


class WorkflowError(RuntimeError):
    def __init__(self, message: str, workflow: Workflow, failed_at: int, cause: Exception):
        super().__init__(message)
        self.workflow = workflow
        self.failed_at = failed_at  # 0-based module index that failed
        self.cause = cause


@dataclass
class RunResult:
    output: Any
    workflow: Workflow
    module_seconds: list[float]
    reused_prefix: PrefixKey | None
    load_seconds: float
    stored_keys: list[str]
    store_seconds: float
    total_seconds: float
    n_skipped: int
    recovered_from_depth: int = 0

    @property
    def exec_seconds(self) -> float:
        return sum(self.module_seconds)


def _nbytes(value: Any) -> int:
    total = 0
    for leaf in tree_leaves(value):
        total += getattr(leaf, "nbytes", 0) or 0
    return int(total)


def wait_for_device(value: Any) -> Any:
    """``value`` once the card has finished computing it: the current stream
    of each CUDA device that holds a leaf is synchronized (the stream this
    thread queued the module's kernels on, not the whole device)."""
    devices = {
        leaf.device
        for leaf in tree_leaves(value)
        if isinstance(leaf, torch.Tensor) and leaf.is_cuda
    }
    for dev in devices:
        torch.cuda.current_stream(dev).synchronize()
    return value


# -- shared helpers (sequential executor + repro.sched.DagScheduler) ----------
def probe_reusable_prefix(
    store: IntermediateStore,
    policy: StoragePolicy,
    candidate: PrefixKey | None,
    keep: frozenset[str] | set[str] = frozenset(),
    device: Any = "cuda",
) -> tuple[PrefixKey | None, Any, float]:
    """Load the longest stored prefix at-or-below ``candidate``.

    Walks parents of ``candidate`` until one has a live artifact; stale
    policy bookkeeping for evicted prefixes is dropped along the way —
    except keys in ``keep``: the caller's *planned* stores for the current
    run, which legitimately have no artifact yet.
    Returns ``(prefix, value, load_seconds)`` — ``(None, None, 0.0)`` when
    nothing is reusable.  The value's tensors are loaded onto ``device``.

    The whole parent chain is probed in ONE batched presence round trip
    (``store.has_state_many``) instead of one per link: a depth-d chain
    against a remote pool used to cost d round trips before the first byte
    of a reusable artifact moved.
    """
    chain: list[tuple[PrefixKey, str]] = []
    node = candidate
    while node is not None:
        chain.append((node, node.key(policy.with_state)))
        node = node.parent()
    sp = _tracing.span("probe.prefix", kind="probe", depth=len(chain))
    with sp:
        states = store.has_state_many([key for _, key in chain]) if chain else {}
        sp.set(present=sum(1 for s in states.values() if s == "present"))
    for candidate, key in chain:
        state = states.get(key, "unreachable")
        if state == "present":
            t0 = time.perf_counter()
            try:
                value = store.get(key, device)
            except KeyError:  # evicted between the batched probe and get()
                policy.stored.pop(key, None)
                continue
            except BackendUnavailable:
                # shard(s) holding it died between the probe and get(): the
                # bytes may survive, so keep bookkeeping, try a shorter prefix
                continue
            return candidate, value, time.perf_counter() - t0
        # artifact evicted: drop stale bookkeeping, try shorter prefix —
        # but only on authoritative absence; an unreachable artifact keeps
        # its bookkeeping (the bytes are still out there)
        if state == "absent" and key not in keep:
            policy.stored.pop(key, None)
    return None, None, 0.0


def admit_and_store(
    store: IntermediateStore,
    policy: StoragePolicy,
    cost_model: CostModel,
    admission: str,
    prefix: PrefixKey,
    value: Any,
    measured_exec_s: float | None,
    catalog: Any = None,
) -> tuple[str | None, float]:
    """Run one policy-recommended store through cost gating + budget admission.

    Returns ``(key, seconds)`` with ``key=None`` when the Eq. 4.9 gate or the
    store budget rejected the artifact (policy bookkeeping is cleaned up so it
    is never recommended for reuse).

    ``catalog`` (a :class:`repro.catalog.Catalog`, duck-typed to keep the
    core layer free of upward imports) is the provenance index's admission
    hook: this is the only seam that still holds the structured ``prefix``
    the flat store key was rendered from, so the publish happens here —
    after ``put`` returns, never under the store lock.
    """
    key = prefix.key(policy.with_state)
    if admission == "t1_gt_t2" and not cost_model.should_store(prefix, measured_exec_s):
        policy.stored.pop(key, None)
        return None, 0.0
    res = store.put(
        key,
        value,
        compute_seconds=cost_model.recompute_seconds(prefix, measured_exec_s),
    )
    if not res.admitted:  # artifact exceeds the whole store budget: never stored
        policy.stored.pop(key, None)
        return None, res.seconds
    if catalog is not None:
        catalog.publish(prefix, key, store.records.get(key))
    return key, res.seconds


@dataclass
class WorkflowExecutor:
    """Sequential front door.  ``registry`` is the shared
    :class:`~repro.core.registry.ModuleRegistry`; a plain dict is adopted by
    reference for backward compatibility.  New code should construct engines
    through :class:`repro.api.Client`, which wires one registry + store +
    policy across the sequential executor and the DAG scheduler."""

    store: IntermediateStore
    policy: StoragePolicy
    registry: ModuleRegistry = field(default_factory=ModuleRegistry)
    admission: str = "always"  # "always" | "t1_gt_t2"
    provenance: ProvenanceLog | None = None
    cost_model: CostModel | None = None
    catalog: Any = None  # optional repro.catalog.Catalog (duck-typed)
    device: Any = "cuda"  # where reused prefixes are loaded

    def __post_init__(self) -> None:
        if not isinstance(self.registry, ModuleRegistry):
            self.registry = ModuleRegistry(self.registry)
        if self.cost_model is None:
            self.cost_model = CostModel(store=self.store)
        if self.admission not in ("always", "t1_gt_t2"):
            raise ValueError(f"unknown admission mode {self.admission!r}")
        # budget evictions must also clear the policy's stored-key map, or the
        # policy would keep recommending reuse of artifacts that are gone
        self.store.add_evict_listener(self._on_store_evict)

    def _on_store_evict(self, key: str) -> None:
        self.policy.stored.pop(key, None)
        # runs under the store lock: Catalog.discard is in-memory only
        if self.catalog is not None:
            self.catalog.discard(key)

    # -- registration (delegates to the shared registry) ----------------------
    def register(self, spec: ModuleSpec) -> None:
        self.registry.register(spec)

    def register_fn(self, module_id: str, fn, **default_params) -> None:
        self.registry.register_fn(module_id, fn, **default_params)

    # -- workflow construction -------------------------------------------------
    def make_workflow(
        self,
        dataset_id: str,
        steps: Sequence[str | tuple[str, Mapping[str, Any] | None]],
        workflow_id: str = "",
    ) -> Workflow:
        refs = []
        for step in steps:
            if isinstance(step, str):
                mod, params = step, None
            else:
                mod, params = step
            spec = self.registry[mod]
            refs.append(spec.ref(params))
        return Workflow(dataset_id, tuple(refs), workflow_id)

    # -- execution --------------------------------------------------------------
    def run(
        self,
        dataset_id: str,
        data: Any,
        steps: Sequence[str | tuple[str, Mapping[str, Any] | None]],
        workflow_id: str = "",
    ) -> RunResult:
        wf = self.make_workflow(dataset_id, steps, workflow_id)
        return self.run_workflow(wf, data)

    def _params_for(self, ref: ModuleRef) -> dict[str, Any]:
        return self.registry.resolve_params(ref)

    def run_workflow(self, wf: Workflow, data: Any) -> RunResult:
        with _tracing.span(
            "run", kind="run", workflow=wf.workflow_id or wf.dataset_id
        ) as run_sp:
            result = self._run_workflow_traced(wf, data)
            run_sp.set(n_skipped=result.n_skipped, stored=len(result.stored_keys))
        return result

    def _run_workflow_traced(self, wf: Workflow, data: Any) -> RunResult:
        t_start = time.perf_counter()
        rec: Recommendation = self.policy.step(wf)

        # 1) reuse the longest stored prefix whose artifact still exists.
        # Probe from the FULL chain, not just the policy's recommendation:
        # the store may hold prefixes this policy instance never admitted —
        # another process/engine sharing the (possibly remote) store put
        # them there, and content-addressed keys make them interchangeable.
        # Cost: up to len(wf) presence probes per run (file stats locally,
        # ~ms round trips remotely) — presence must stay authoritative, and
        # any cheaper hint (records / shared index) would miss exactly the
        # cross-process artifacts this probe exists to find.
        candidate = wf.prefix(len(wf)) if len(wf) else None
        planned = {p.key(self.policy.with_state) for p in rec.store}
        reused, loaded, load_s = probe_reusable_prefix(
            self.store, self.policy, candidate, keep=planned, device=self.device
        )
        if reused is not None:
            # adopt the fact into local bookkeeping so later planning
            # (and eviction listeners) see what we just relied on
            reused_key = reused.key(self.policy.with_state)
            self.policy.stored.setdefault(
                reused_key, StoredRecord(reused, self.policy.n_pipelines)
            )
            if self.catalog is not None:  # refresh reuse counters for ranking
                self.catalog.touch(reused_key, self.store.records.get(reused_key))
        start_idx = reused.depth if reused is not None else 0
        value = loaded if reused is not None else data

        # 2) execute the suffix, retaining stage outputs for storing
        module_seconds = [0.0] * len(wf)
        stage_values: dict[int, Any] = {}  # depth -> value (1-based)
        failed_at: int | None = None
        for i in range(start_idx, len(wf)):
            ref = wf.modules[i]
            spec = self.registry[ref.module_id]
            params = self._params_for(ref)
            t0 = time.perf_counter()
            try:
                value = spec.fn(value, **params)
                value = wait_for_device(value)
            except Exception as e:  # noqa: BLE001 - module code is user code
                failed_at = i
                self._persist_recovery_point(wf, i, stage_values, reused)
                raise WorkflowError(
                    f"module {ref.module_id} failed at step {i}: {e}", wf, i, e
                ) from e
            dt = time.perf_counter() - t0
            module_seconds[i] = dt
            assert self.cost_model is not None
            self.cost_model.observe(ref, dt, _nbytes(value))
            stage_values[i + 1] = value

        # 3) store what the policy admitted (cost-gated if requested)
        stored_keys: list[str] = []
        store_s = 0.0
        assert self.cost_model is not None
        for prefix in rec.store:
            depth = prefix.depth
            if depth not in stage_values:
                # inside the skipped prefix: normally stored by an earlier run,
                # but a budget eviction may have dropped it while a deeper
                # prefix survived — don't let the policy believe it exists.
                # Authoritative absence only: unreachable shards are not
                # evidence of eviction (see has_state)
                key = prefix.key(self.policy.with_state)
                if self.store.has_state(key) == "absent":
                    self.policy.stored.pop(key, None)
                continue
            key, dt = admit_and_store(
                self.store,
                self.policy,
                self.cost_model,
                self.admission,
                prefix,
                stage_values[depth],
                sum(module_seconds[:depth]) or None,
                catalog=self.catalog,
            )
            store_s += dt
            if key is not None:
                stored_keys.append(key)

        total = time.perf_counter() - t_start
        result = RunResult(
            output=value,
            workflow=wf,
            module_seconds=module_seconds,
            reused_prefix=reused,
            load_seconds=load_s,
            stored_keys=stored_keys,
            store_seconds=store_s,
            total_seconds=total,
            n_skipped=start_idx,
        )
        if self.provenance is not None:
            n_requests = (len(wf) - start_idx) + len(stored_keys) + (1 if reused else 0)
            self.provenance.append(
                RunRecord(
                    workflow_id=wf.workflow_id,
                    dataset_id=wf.dataset_id,
                    modules=[m.key(True) for m in wf.modules],
                    module_seconds=module_seconds,
                    reused_prefix_depth=start_idx,
                    load_seconds=load_s,
                    stored_keys=stored_keys,
                    store_seconds=store_s,
                    total_seconds=total,
                    n_requests=n_requests,
                    failed_at=failed_at,
                    recovered_from_depth=start_idx if reused else 0,
                )
            )
        return result

    # -- error recovery -----------------------------------------------------------
    def _persist_recovery_point(
        self,
        wf: Workflow,
        failed_idx: int,
        stage_values: dict[int, Any],
        reused: PrefixKey | None,
    ) -> None:
        """Store the last good intermediate state so a retry skips to it."""
        depth = failed_idx  # output of module failed_idx-1 has depth failed_idx
        if depth in stage_values:
            prefix = wf.prefix(depth)
            key = prefix.key(self.policy.with_state)
            state = self.store.has_state(key)
            if state == "unreachable":
                # the pool is gone: a put would fail (masking the module
                # error being recovered), and claiming the prefix as stored
                # without bytes anywhere would be a phantom — skip both
                return
            if state == "absent":
                self.store.put(key, stage_values[depth])
                if self.catalog is not None:
                    self.catalog.publish(prefix, key, self.store.records.get(key))
            self.policy.stored.setdefault(
                key, StoredRecord(prefix, self.policy.n_pipelines)
            )
        # if nothing was computed yet, the reused prefix (if any) already covers it


def eval_repr(v: str) -> Any:
    """Deprecated inverse of the ``repr()`` encoding old ``ToolState``s used.

    ``ToolState.from_config`` now renders params through the canonical,
    invertible :func:`repro.core.workflow.encode_param`; decode with
    :func:`repro.core.workflow.decode_param`, which still falls back to this
    literal-eval behaviour for legacy repr-encoded params.  Kept only so
    persisted pre-canonical states (and external callers) keep resolving.
    """
    import ast

    try:
        return ast.literal_eval(v)
    except (ValueError, SyntaxError):
        return v
