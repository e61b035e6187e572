"""Structured logging wired to the tracing context.

``configure_logging`` sets up the ``repro`` logger hierarchy with either a
human-readable line format or JSON lines; every record passes through
:class:`TraceInjectFilter`, which stamps ``trace_id`` / ``run_id`` /
``tenant`` from the active span and :func:`repro.obs.tracing.bind` baggage
— so one ``grep trace_id`` correlates logs with the span tree.
"""
from __future__ import annotations

import json
import logging
import sys
import time
from typing import Any

from . import tracing

__all__ = ["TraceInjectFilter", "JsonFormatter", "configure_logging", "get_logger"]

_LEVELS = {"debug", "info", "warning", "error", "critical"}


class TraceInjectFilter(logging.Filter):
    def filter(self, record: logging.LogRecord) -> bool:
        span = tracing.current_span()
        bag = tracing.current_baggage()
        record.trace_id = (span.trace_id if span else None) or bag.get("trace_id") or "-"
        record.run_id = bag.get("run_id") or "-"
        record.tenant = bag.get("tenant") or "-"
        return True


class JsonFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        doc: dict[str, Any] = {
            "ts": round(time.time(), 3),
            "level": record.levelname.lower(),
            "logger": record.name,
            "msg": record.getMessage(),
            "trace_id": getattr(record, "trace_id", "-"),
            "run_id": getattr(record, "run_id", "-"),
            "tenant": getattr(record, "tenant", "-"),
        }
        if record.exc_info:
            doc["exc"] = self.formatException(record.exc_info)
        return json.dumps(doc, separators=(",", ":"))


def configure_logging(
    level: str = "info",
    *,
    json_lines: bool = False,
    stream: Any = None,
) -> logging.Logger:
    """Configure the ``repro`` logger tree (idempotent — replaces handlers
    installed by a previous call, so tests can reconfigure freely)."""
    if level.lower() not in _LEVELS:
        raise ValueError(f"unknown log level {level!r} (expected one of {sorted(_LEVELS)})")
    logger = logging.getLogger("repro")
    logger.setLevel(getattr(logging, level.upper()))
    for h in [h for h in logger.handlers if getattr(h, "_repro_obs", False)]:
        logger.removeHandler(h)
    handler = logging.StreamHandler(stream or sys.stderr)
    handler._repro_obs = True  # type: ignore[attr-defined]
    handler.addFilter(TraceInjectFilter())
    if json_lines:
        handler.setFormatter(JsonFormatter())
    else:
        handler.setFormatter(
            logging.Formatter(
                "%(asctime)s %(levelname)-7s %(name)s [%(trace_id)s %(run_id)s %(tenant)s] %(message)s"
            )
        )
    logger.addHandler(handler)
    logger.propagate = False
    return logger


def get_logger(name: str) -> logging.Logger:
    return logging.getLogger(name if name.startswith("repro") else f"repro.{name}")
