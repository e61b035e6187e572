"""repro_torch.obs — unified observability for the workflow fabric.

One metrics home (:mod:`repro_torch.obs.metrics`), cross-process run tracing
(:mod:`repro_torch.obs.tracing`), structured logging
(:mod:`repro_torch.obs.logging`), and a trace-tree CLI
(``python -m repro_torch.obs.trace``).  Everything is stdlib-only so every
layer of the fabric can depend on it without cycles.
"""
from __future__ import annotations

from .metrics import MetricsRegistry, lint_registry, merge_docs, render_prometheus
from .tracing import TraceContext, bind, configure_tracing, current_traceparent, span

__all__ = [
    "MetricsRegistry",
    "TraceContext",
    "bind",
    "configure_tracing",
    "current_traceparent",
    "lint_registry",
    "merge_docs",
    "render_prometheus",
    "span",
]
