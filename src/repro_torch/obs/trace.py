"""Trace-tree CLI: stitch NDJSON spans from every process into one tree.

Usage::

    python -m repro_torch.obs.trace --dir traces/ --list
    python -m repro_torch.obs.trace --dir traces/ <trace_id>

Renders the span tree (service, duration, key attrs), marks the critical
path (the chain of spans that bounds the run's wall time) with ``*``, and
rolls up "seconds saved by reuse" — the per-run realization of the paper's
Ch. 4 time-gain claim: for every artifact served from the store instead of
recomputed, the saving is its recorded compute cost minus the load time.
"""
from __future__ import annotations

import argparse
import os
import sys
from collections import defaultdict
from typing import Any, Iterable

from .tracing import iter_spans

__all__ = ["build_trace", "critical_path", "render_trace", "main"]


def build_trace(spans: Iterable[dict[str, Any]], trace_id: str) -> dict[str, Any]:
    """Index one trace's spans: children map, roots, service set."""
    by_id: dict[str, dict[str, Any]] = {}
    for s in spans:
        if s.get("trace") == trace_id and s.get("span"):
            by_id[s["span"]] = s
    children: dict[str | None, list[dict[str, Any]]] = defaultdict(list)
    roots: list[dict[str, Any]] = []
    for s in by_id.values():
        parent = s.get("parent")
        if parent and parent in by_id:
            children[parent].append(s)
        else:
            roots.append(s)  # true root, or an orphan from a lost parent file
    for lst in children.values():
        lst.sort(key=lambda s: s.get("start", 0.0))
    roots.sort(key=lambda s: s.get("start", 0.0))
    processes = {(s.get("svc"), s.get("pid")) for s in by_id.values()}
    return {
        "trace_id": trace_id,
        "spans": by_id,
        "children": children,
        "roots": roots,
        "services": sorted({s.get("svc") or "?" for s in by_id.values()}),
        "processes": sorted(processes, key=str),
    }


def critical_path(tree: dict[str, Any]) -> list[str]:
    """Span ids on the critical path: from the root, repeatedly descend into
    the child that *finishes last* (the one the parent's end waits on)."""
    if not tree["roots"]:
        return []
    root = max(tree["roots"], key=lambda s: s.get("start", 0) + s.get("dur", 0))
    path = [root["span"]]
    node = root
    while True:
        kids = tree["children"].get(node["span"], [])
        if not kids:
            break
        node = max(kids, key=lambda s: s.get("start", 0) + s.get("dur", 0))
        path.append(node["span"])
    return path


def reuse_rollup(tree: dict[str, Any]) -> dict[str, float]:
    hits, saved = 0, 0.0
    for s in tree["spans"].values():
        attrs = s.get("attrs") or {}
        if "saved_s" in attrs:
            hits += 1
            saved += float(attrs["saved_s"] or 0.0)
    return {"reuse_hits": hits, "seconds_saved": round(saved, 6)}


_SHOWN_ATTRS = ("op", "node", "module", "source", "key", "tenant", "run_id", "saved_s", "error")


def _fmt_span(s: dict[str, Any], on_path: bool) -> str:
    attrs = s.get("attrs") or {}
    shown = " ".join(f"{k}={attrs[k]}" for k in _SHOWN_ATTRS if k in attrs)
    mark = "*" if on_path else " "
    dur_ms = (s.get("dur") or 0.0) * 1e3
    return f"{mark} {s.get('name')} [{s.get('svc')}/{s.get('pid')}] {dur_ms:.1f}ms {shown}".rstrip()


def render_trace(tree: dict[str, Any]) -> str:
    path = set(critical_path(tree))
    lines = [f"trace {tree['trace_id']}  ({len(tree['spans'])} spans, "
             f"{len(tree['processes'])} processes: {', '.join(tree['services'])})"]

    def walk(span: dict[str, Any], depth: int) -> None:
        lines.append("  " * depth + _fmt_span(span, span["span"] in path))
        for child in tree["children"].get(span["span"], []):
            walk(child, depth + 1)

    for root in tree["roots"]:
        walk(root, 1)
    roll = reuse_rollup(tree)
    if tree["roots"]:
        t0 = min(s.get("start", 0.0) for s in tree["spans"].values())
        t1 = max(s.get("start", 0.0) + s.get("dur", 0.0) for s in tree["spans"].values())
        lines.append(f"  wall: {(t1 - t0) * 1e3:.1f}ms  critical path: {len(path)} spans")
    lines.append(
        f"  reuse: {int(roll['reuse_hits'])} hits, {roll['seconds_saved']:.3f}s saved"
    )
    return "\n".join(lines)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.trace", description=__doc__.splitlines()[0]
    )
    ap.add_argument("trace_id", nargs="?", help="trace to render (omit with --list)")
    ap.add_argument("--dir", default="traces", help="span NDJSON directory (default: traces/)")
    ap.add_argument("--list", action="store_true", help="list trace ids seen in --dir")
    args = ap.parse_args(argv)

    spans = list(iter_spans(args.dir))
    if args.list or not args.trace_id:
        seen: dict[str, dict[str, Any]] = {}
        for s in spans:
            t = s.get("trace")
            if not t:
                continue
            agg = seen.setdefault(t, {"n": 0, "start": s.get("start", 0.0), "name": ""})
            agg["n"] += 1
            if s.get("parent") is None or s.get("kind") == "run":
                agg["name"] = s.get("name", "")
        for t, agg in sorted(seen.items(), key=lambda kv: kv[1]["start"]):
            print(f"{t}  {agg['n']:4d} spans  {agg['name']}")
        if not seen:
            print(f"no spans under {args.dir!r}", file=sys.stderr)
            return 1
        return 0

    tree = build_trace(spans, args.trace_id)
    if not tree["spans"]:
        print(f"trace {args.trace_id} not found under {args.dir!r}", file=sys.stderr)
        return 1
    print(render_trace(tree))
    return 0


if __name__ == "__main__":
    try:
        raise SystemExit(main())
    except BrokenPipeError:  # e.g. `... | head` closed the pipe
        os.close(sys.stdout.fileno())
        raise SystemExit(0)
