"""``python -m repro_torch.catalog.query`` — find-by-statepoint from the shell.

Works against every deployment:

* ``--root DIR`` — a local store directory: loads ``catalog.json`` through
  a :class:`~repro_torch.core.backends.LocalFSBackend`.
* ``--store-url tcp://h:p[,h:p...]`` — a store server or cluster: runs the
  query server-side (``catalog_query``), fanning out and merging when the
  url names more than one shard.

``--dedup`` switches the tool from find-by-statepoint to a cross-namespace
duplication report: identical module chains (same dataset, same modules,
same encoded tool states) stored under several ``tenant:*`` namespaces are
promotion candidates — keep one copy under ``shared`` and the rest of the
bytes come back.

Examples::

    python -m repro_torch.catalog.query --root /tmp/store --module align --param k=31
    python -m repro_torch.catalog.query --store-url tcp://localhost:7077 \
        --module train --param lr=0.1 --dataset d1 --json
    python -m repro_torch.catalog.query --root /tmp/store --dedup
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Sequence

from .catalog import Catalog
from .records import CatalogQuery, CatalogRecord


def _parse_param(spec: str) -> tuple[str, Any]:
    """``name=value`` with the value parsed as JSON first (so ``k=31``
    matches the *int* 31), falling back to the raw string."""
    if "=" not in spec:
        raise argparse.ArgumentTypeError(
            f"--param needs name=value, got {spec!r}"
        )
    name, raw = spec.split("=", 1)
    try:
        return name, json.loads(raw)
    except json.JSONDecodeError:
        return name, raw


def _open_catalog(args: argparse.Namespace) -> Catalog:
    if args.store_url:
        from ..net.client import RemoteBackend
        from ..net.sharded import ShardedBackend

        url = args.store_url
        if "," in url:
            backend = ShardedBackend(url, replication=args.replication)
        else:
            backend = RemoteBackend(url)
        return Catalog(backend, persist=False)
    from ..core.backends import LocalFSBackend

    return Catalog(LocalFSBackend(args.root), persist=True)


def _chain_identity(rec: CatalogRecord) -> tuple:
    """Hashable content identity of an artifact *ignoring namespace*: same
    bare dataset, same module chain, same encoded tool states at every
    position.  Two records with equal identities hold the same bytes — the
    store key differs only in the namespace segment."""
    return (
        rec.dataset,
        rec.modules,
        tuple(tuple(sorted(s.items())) for s in rec.states),
    )


def dedup_report(
    records: "Sequence[CatalogRecord]", *, tenant_only: bool = True
) -> list[dict[str, Any]]:
    """Group records by content identity and report every group stored under
    more than one namespace.  Each entry names the namespaces holding a copy,
    the canonical copy to keep (most-reused, ties to oldest), and the bytes
    reclaimed by promoting it to ``shared`` and dropping the rest.

    ``tenant_only`` restricts the scan to ``tenant:*`` namespaces — the
    multi-tenant case the gateway creates; pass ``False`` to consider every
    namespace (including ``""`` and ``shared`` itself).
    """
    groups: dict[tuple, list[CatalogRecord]] = {}
    for rec in records:
        if tenant_only and not rec.namespace.startswith("tenant:"):
            continue
        groups.setdefault(_chain_identity(rec), []).append(rec)

    report: list[dict[str, Any]] = []
    for members in groups.values():
        namespaces = {r.namespace for r in members}
        if len(namespaces) < 2:
            continue
        # keep the copy with the best reuse record; oldest breaks ties so
        # the choice is stable across runs
        keep = min(members, key=lambda r: (-r.n_loads, r.created_at, r.key))
        reclaimable = sum(r.nbytes for r in members) - keep.nbytes
        report.append(
            {
                "dataset": keep.dataset,
                "modules": list(keep.modules),
                "depth": keep.depth,
                "params": keep.params(),
                "namespaces": sorted(namespaces),
                "n_copies": len(members),
                "keep": keep.key,
                "promote_to": "shared",
                "reclaimable_bytes": reclaimable,
                "total_loads": sum(r.n_loads for r in members),
            }
        )
    report.sort(key=lambda e: (-e["reclaimable_bytes"], e["keep"]))
    return report


def _fmt_dedup_entry(entry: dict[str, Any]) -> str:
    chain = ">".join(entry["modules"])
    nss = ",".join(entry["namespaces"])
    return (
        f"{entry['dataset']:16s} {chain:40s} x{entry['n_copies']} "
        f"[{nss}] reclaim={entry['reclaimable_bytes']}B "
        f"loads={entry['total_loads']} keep={entry['keep']}"
    )


def _fmt_row(rec: CatalogRecord) -> str:
    params = ", ".join(f"{k}={v!r}" for k, v in sorted(rec.params().items()))
    ns = rec.namespace or "-"
    return (
        f"{ns:12s} {rec.dataset:16s} {'>'.join(rec.modules):40s} "
        f"[{params}] loads={rec.n_loads} bytes={rec.nbytes}"
    )


def main(argv: "Sequence[str] | None" = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.catalog.query",
        description="Query the artifact catalog (find-by-statepoint).",
    )
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--root", help="local store directory (reads catalog.json)")
    src.add_argument(
        "--store-url",
        help="store server url; comma-separated list queries a cluster",
    )
    ap.add_argument("--module", help="terminal module id to match")
    ap.add_argument(
        "--param",
        action="append",
        default=[],
        type=_parse_param,
        metavar="NAME=VALUE",
        help="parameter filter (repeatable); VALUE parsed as JSON, then raw",
    )
    ap.add_argument("--dataset", help="bare dataset id to match")
    ap.add_argument("--namespace", help="namespace to match (e.g. shared)")
    ap.add_argument(
        "--any-position",
        action="store_true",
        help="match artifacts whose chain *contains* the module anywhere",
    )
    ap.add_argument("--limit", type=int, default=20)
    ap.add_argument(
        "--replication", type=int, default=2, help="cluster replica-set size"
    )
    ap.add_argument("--json", action="store_true", help="emit records as JSON")
    ap.add_argument(
        "--dedup",
        action="store_true",
        help="report identical chains duplicated across tenant namespaces "
        "(promotion-to-shared candidates with reclaimable bytes)",
    )
    ap.add_argument(
        "--all-namespaces",
        action="store_true",
        help="with --dedup: consider every namespace, not just tenant:*",
    )
    args = ap.parse_args(argv)
    if args.param and not args.module:
        ap.error("--param needs --module to anchor it")
    if args.dedup and (args.module or args.param or args.namespace):
        ap.error("--dedup scans whole catalogs; it only composes with "
                 "--dataset and --json")

    catalog = _open_catalog(args)
    try:
        if args.dedup:
            # full scan: an unfiltered query returns every record the
            # catalog (or cluster, merged) knows about
            scan = CatalogQuery.build(dataset=args.dataset, limit=1_000_000)
            report = dedup_report(
                catalog.query(scan), tenant_only=not args.all_namespaces
            )
            if args.json:
                print(json.dumps(report, indent=2))
            else:
                for entry in report:
                    print(_fmt_dedup_entry(entry))
                total = sum(e["reclaimable_bytes"] for e in report)
                print(
                    f"{len(report)} duplicated chain(s), "
                    f"{total} byte(s) reclaimable by promotion to shared",
                    file=sys.stderr,
                )
            return 0
        q = CatalogQuery.build(
            module=args.module,
            params=dict(args.param),
            dataset=args.dataset,
            namespace=args.namespace,
            any_position=args.any_position,
            limit=args.limit,
        )
        hits = catalog.query(q)
    finally:
        close = getattr(catalog.backend, "close", None)
        if callable(close):
            close()
    if args.json:
        print(json.dumps([r.to_doc() for r in hits], indent=2))
    else:
        for rec in hits:
            print(_fmt_row(rec))
        print(f"{len(hits)} artifact(s)", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
