"""Concurrent DAG scheduling with single-flight intermediate-data reuse.

The thesis formalizes a workflow as a full DAG ``W = (D, M, E, ID, O)``
(Ch. 6.3.1) but mines rules over sequential module chains (Ch. 3.3); this
subsystem closes the gap:

  * :class:`DagWorkflow`   — fan-in/fan-out graph of module occurrences with
    deterministic root-to-node path decomposition, so RISP rule mining keeps
    operating on sequential pipelines;
  * :class:`DagScheduler`  — topological dispatch of ready nodes onto a
    worker pool, with store-backed prefix skipping at node granularity;
  * :class:`SingleFlight`  — when N in-flight runs need the same prefix,
    exactly one computes it and the rest await its future;
  * :class:`WorkflowService` — the front door for many concurrent
    submissions sharing one store + policy, with aggregate throughput stats.

See ``docs/scheduler.md`` for the execution model and thread-safety
invariants.
"""
from .dag import DagNode, DagWorkflow
from .dispatch import NodeDispatcher, ProcessPoolDispatcher
from .scheduler import DagRunResult, DagScheduler, DagWorkflowError, NodeResult
from .singleflight import SingleFlight
from .stats import AggregateStats, TenantCounters, TenantLedger
from .service import AdmissionRejected, ServiceClosed, WorkflowService

__all__ = [
    "AdmissionRejected",
    "AggregateStats",
    "DagNode",
    "DagRunResult",
    "DagScheduler",
    "DagWorkflow",
    "DagWorkflowError",
    "NodeDispatcher",
    "NodeResult",
    "ProcessPoolDispatcher",
    "ServiceClosed",
    "SingleFlight",
    "TenantCounters",
    "TenantLedger",
    "WorkflowService",
]
