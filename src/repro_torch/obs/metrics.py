"""Thread-safe metrics registry — the one home for every counter in the fabric.

Three instrument kinds, all label-aware:

- :class:`Counter` — monotonic float, ``inc(n)``.
- :class:`Gauge` — settable value, or a callback sampled at collection time
  (``set_function``) so "current bytes"/"pending runs" never go stale.
- :class:`Histogram` — **fixed log buckets** (half-decade steps, 10 µs → 31.6 s
  by default).  Fixed bounds make histograms *mergeable*: two processes'
  bucket-count vectors add element-wise, which is what lets
  ``ShardedBackend`` fold N shards' ``metrics`` docs into one cluster view.

A registry serializes to a JSON-able *doc* (:meth:`MetricsRegistry.to_doc`)
that travels over the wire as the ``metrics`` op reply; :func:`merge_docs`
combines docs (optionally stamping each with an extra label such as
``shard=host:port``), and :func:`render_prometheus` renders a doc in the
Prometheus text exposition format for the gateway's ``GET /metrics``.

Naming scheme (enforced by :func:`lint_registry` and a tier-1 lint test):
``repro_<subsystem>_<what>[_unit]``; counters end in ``_total``; label names
come from the small fixed vocabulary below so dashboards can join across
subsystems.
"""
from __future__ import annotations

import json
import math
import re
import threading
from bisect import bisect_left
from typing import Any, Callable, Iterable, Mapping

__all__ = [
    "ALLOWED_LABELS",
    "DEFAULT_BUCKETS",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "lint_doc",
    "lint_registry",
    "merge_docs",
    "render_prometheus",
]

_NAME_RE = re.compile(r"^repro(_[a-z0-9]+)+$")
_LABEL_RE = re.compile(r"^[a-z][a-z0-9_]*$")

#: label vocabulary shared by every subsystem — new labels are a deliberate
#: API decision, not a drive-by (the lint test fails on anything else)
ALLOWED_LABELS = frozenset(
    {"op", "shard", "tenant", "namespace", "dir", "status", "source", "event", "policy"}
)

#: half-decade log buckets, 1e-5 s .. 31.6 s (rounded so bounds are stable
#: dict keys across processes — a merge requires *identical* bounds)
DEFAULT_BUCKETS: tuple[float, ...] = tuple(
    float(f"{10.0 ** (k / 2.0):.6g}") for k in range(-10, 4)
)


def _labels_key(labelnames: tuple[str, ...], kw: Mapping[str, str]) -> tuple[str, ...]:
    if set(kw) != set(labelnames):
        raise ValueError(f"expected labels {labelnames}, got {tuple(kw)}")
    return tuple(str(kw[k]) for k in labelnames)


class Counter:
    """Monotonic counter child (one label combination)."""

    __slots__ = ("_lock", "_v")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._v = 0.0

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._v += n

    @property
    def value(self) -> float:
        v = self._v
        return int(v) if float(v).is_integer() else v


class Gauge:
    """Settable gauge child; ``set_function`` makes it a live callback."""

    __slots__ = ("_lock", "_v", "_fn")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._v = 0.0
        self._fn: Callable[[], float] | None = None

    def set(self, v: float) -> None:
        with self._lock:
            self._v = float(v)

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._v += n

    def dec(self, n: float = 1.0) -> None:
        self.inc(-n)

    def set_function(self, fn: Callable[[], float]) -> None:
        self._fn = fn

    @property
    def value(self) -> float:
        if self._fn is not None:
            try:
                v = float(self._fn())
            except Exception:  # noqa: BLE001 — a dead callback must not kill a scrape
                v = float("nan")
        else:
            v = self._v
        return int(v) if v == v and float(v).is_integer() else v


class Histogram:
    """Fixed-bucket latency histogram child (cumulative on render, raw
    per-bucket counts internally so merging is element-wise addition)."""

    __slots__ = ("_lock", "bounds", "counts", "sum", "count")

    def __init__(self, bounds: tuple[float, ...]) -> None:
        self._lock = threading.Lock()
        self.bounds = bounds
        self.counts = [0] * (len(bounds) + 1)  # last slot = +Inf
        self.sum = 0.0
        self.count = 0

    def observe(self, v: float) -> None:
        idx = bisect_left(self.bounds, v)
        with self._lock:
            self.counts[idx] += 1
            self.sum += v
            self.count += 1

    def snapshot(self) -> dict[str, Any]:
        with self._lock:
            return {"counts": list(self.counts), "sum": self.sum, "count": self.count}


class _Family:
    """A named metric plus its labeled children."""

    def __init__(
        self,
        name: str,
        kind: str,
        help: str,
        labelnames: tuple[str, ...],
        factory: Callable[[], Any],
    ) -> None:
        self.name = name
        self.kind = kind
        self.help = help
        self.labelnames = labelnames
        self._factory = factory
        self._lock = threading.Lock()
        self._children: dict[tuple[str, ...], Any] = {}
        if not labelnames:  # pre-create the unlabeled child for hot paths
            self._children[()] = factory()

    def labels(self, **kw: str) -> Any:
        key = _labels_key(self.labelnames, kw)
        child = self._children.get(key)
        if child is None:
            with self._lock:
                child = self._children.setdefault(key, self._factory())
        return child

    @property
    def unlabeled(self) -> Any:
        return self._children[()]

    # convenience pass-throughs for label-free hot paths
    def inc(self, n: float = 1.0) -> None:
        self._children[()].inc(n)

    def observe(self, v: float) -> None:
        self._children[()].observe(v)

    @property
    def value(self) -> float:
        return self._children[()].value

    def series(self) -> list[dict[str, Any]]:
        with self._lock:
            items = list(self._children.items())
        out = []
        for key, child in items:
            labels = dict(zip(self.labelnames, key))
            if self.kind == "histogram":
                out.append({"labels": labels, "hist": child.snapshot()})
            else:
                v = child.value
                out.append({"labels": labels, "value": None if v != v else v})
        return out


class MetricsRegistry:
    """Thread-safe family registry.  Re-registering an existing name returns
    the existing family (so components sharing one registry compose) but a
    kind/label mismatch raises — one name, one meaning."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._families: dict[str, _Family] = {}

    def _register(
        self,
        name: str,
        kind: str,
        help: str,
        labels: Iterable[str],
        factory: Callable[[], Any],
    ) -> _Family:
        labelnames = tuple(labels)
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if fam.kind != kind or fam.labelnames != labelnames:
                    raise ValueError(
                        f"metric {name!r} already registered as {fam.kind}"
                        f"{fam.labelnames}, not {kind}{labelnames}"
                    )
                return fam
            fam = _Family(name, kind, help, labelnames, factory)
            self._families[name] = fam
            return fam

    def counter(self, name: str, help: str = "", labels: Iterable[str] = ()) -> _Family:
        return self._register(name, "counter", help, labels, Counter)

    def gauge(self, name: str, help: str = "", labels: Iterable[str] = ()) -> _Family:
        return self._register(name, "gauge", help, labels, Gauge)

    def histogram(
        self,
        name: str,
        help: str = "",
        labels: Iterable[str] = (),
        buckets: tuple[float, ...] = DEFAULT_BUCKETS,
    ) -> _Family:
        bounds = tuple(buckets)
        fam = self._register(name, "histogram", help, labels, lambda: Histogram(bounds))
        fam.buckets = bounds
        return fam

    def families(self) -> list[_Family]:
        with self._lock:
            return list(self._families.values())

    def to_doc(self) -> dict[str, Any]:
        """JSON-able snapshot — the wire shape of the ``metrics`` op."""
        doc: dict[str, Any] = {}
        for fam in self.families():
            entry: dict[str, Any] = {
                "type": fam.kind,
                "help": fam.help,
                "labels": list(fam.labelnames),
                "series": fam.series(),
            }
            if fam.kind == "histogram":
                entry["bounds"] = list(getattr(fam, "buckets", DEFAULT_BUCKETS))
            doc[fam.name] = entry
        return doc


def _merge_series(kind: str, into: list[dict[str, Any]], more: list[dict[str, Any]]) -> None:
    index = {json.dumps(s["labels"], sort_keys=True): s for s in into}
    for s in more:
        k = json.dumps(s["labels"], sort_keys=True)
        cur = index.get(k)
        if cur is None:
            index[k] = s
            into.append(s)
        elif kind == "histogram":
            a, b = cur["hist"], s["hist"]
            if len(a["counts"]) == len(b["counts"]):
                a["counts"] = [x + y for x, y in zip(a["counts"], b["counts"])]
                a["sum"] += b["sum"]
                a["count"] += b["count"]
        else:  # counters and gauges both add — gauges here are extensive
            # quantities (bytes, pending runs); per-shard gauges that are not
            # additive carry a distinguishing ``shard`` label and never collide
            if s.get("value") is not None:
                cur["value"] = (cur.get("value") or 0) + s["value"]


def merge_docs(
    docs: Iterable[dict[str, Any] | None],
    extra_labels: Iterable[Mapping[str, str] | None] | None = None,
) -> dict[str, Any]:
    """Merge metric docs from N processes into one cluster doc.

    ``extra_labels[i]`` (e.g. ``{"shard": "host:port"}``) is stamped onto
    every series of ``docs[i]`` first, so per-process series stay
    distinguishable and non-additive gauges never sum across shards.
    """
    merged: dict[str, Any] = {}
    extras = list(extra_labels) if extra_labels is not None else None
    for i, doc in enumerate(docs):
        if not doc:
            continue
        extra = extras[i] if extras else None
        for name, entry in doc.items():
            series = [
                {**s, "labels": {**s["labels"], **(extra or {})}} for s in entry["series"]
            ]
            cur = merged.get(name)
            if cur is None:
                cur = {k: v for k, v in entry.items() if k != "series"}
                if extra:
                    cur["labels"] = sorted(set(cur.get("labels", [])) | set(extra))
                cur["series"] = []
                merged[name] = cur
            _merge_series(entry["type"], cur["series"], series)
    return merged


def _fmt_labels(labels: Mapping[str, str], extra: Mapping[str, str] | None = None) -> str:
    items = {**labels, **(extra or {})}
    if not items:
        return ""
    body = ",".join(
        f'{k}="{str(v).replace(chr(92), chr(92) * 2).replace(chr(34), chr(92) + chr(34))}"'
        for k, v in sorted(items.items())
    )
    return "{" + body + "}"


def _fmt_value(v: Any) -> str:
    if v is None or v != v:
        return "NaN"
    if v in (math.inf, -math.inf):
        return "+Inf" if v > 0 else "-Inf"
    return repr(float(v)) if not float(v).is_integer() else str(int(v))


def render_prometheus(doc: Mapping[str, Any]) -> str:
    """Render a metrics doc in the Prometheus text exposition format."""
    lines: list[str] = []
    for name in sorted(doc):
        entry = doc[name]
        if entry["help"]:
            lines.append(f"# HELP {name} {entry['help']}")
        lines.append(f"# TYPE {name} {entry['type']}")
        for s in entry["series"]:
            if entry["type"] == "histogram":
                hist = s["hist"]
                bounds = entry.get("bounds", list(DEFAULT_BUCKETS))
                cum = 0
                for i, le in enumerate(list(bounds) + [math.inf]):
                    cum += hist["counts"][i] if i < len(hist["counts"]) else 0
                    le_s = "+Inf" if le == math.inf else _fmt_value(le)
                    lines.append(
                        f"{name}_bucket{_fmt_labels(s['labels'], {'le': le_s})} {cum}"
                    )
                lines.append(f"{name}_sum{_fmt_labels(s['labels'])} {_fmt_value(hist['sum'])}")
                lines.append(f"{name}_count{_fmt_labels(s['labels'])} {hist['count']}")
            else:
                lines.append(f"{name}{_fmt_labels(s['labels'])} {_fmt_value(s.get('value'))}")
    return "\n".join(lines) + "\n"


def lint_doc(doc: Mapping[str, Any]) -> list[str]:
    """Return naming-scheme violations for a metrics doc (empty = clean)."""
    problems: list[str] = []
    for name, entry in doc.items():
        if not _NAME_RE.match(name):
            problems.append(f"{name}: name does not match {_NAME_RE.pattern}")
        if entry["type"] == "counter" and not name.endswith("_total"):
            problems.append(f"{name}: counter names must end in _total")
        if entry["type"] == "histogram" and not name.endswith(("_seconds", "_bytes")):
            problems.append(f"{name}: histogram names must end in _seconds/_bytes")
        if not entry.get("help"):
            problems.append(f"{name}: missing help text")
        for label in entry.get("labels", []):
            if label == "le" or not _LABEL_RE.match(label):
                problems.append(f"{name}: malformed label {label!r}")
            elif label not in ALLOWED_LABELS:
                problems.append(
                    f"{name}: label {label!r} not in ALLOWED_LABELS "
                    f"(extend the vocabulary deliberately if needed)"
                )
    return problems


def lint_registry(registry: MetricsRegistry) -> list[str]:
    return lint_doc(registry.to_doc())
