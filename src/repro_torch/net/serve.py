"""``python -m repro_torch.net.serve`` — run a store server over a directory.

Example::

    python -m repro_torch.net.serve --root /var/lib/repro-store --port 7077

Clients then mount the pool with
``IntermediateStore(backend=RemoteBackend("tcp://host:7077"))`` or
``serve.mount_serve_engine(RemoteBackend("tcp://host:7077"), ...)``.

A *cluster* is simply N of these processes, each over its **own** root
directory (never a shared one — a shard owns its bytes), mounted together:
``Client(store_url="h:7077,h:7078,h:7079", replication=2)``.  Routing,
replication, and failover are entirely client-side (see ``docs/remote.md``,
"Cluster mode"); the servers need not know about each other.
"""
from __future__ import annotations

import argparse
import os
import signal
import sys

from ..core.backends import LocalFSBackend, MemoryBackend, TieredBackend
from ..obs.logging import configure_logging, get_logger
from ..obs.tracing import configure_tracing
from .protocol import DEFAULT_PORT
from .server import StoreServer


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.net.serve",
        description="Serve a directory as a shared intermediate-data store.",
    )
    parser.add_argument("--root", required=True, help="artifact directory")
    parser.add_argument(
        "--host",
        default="127.0.0.1",
        help="bind address; the protocol is unauthenticated, so expose it "
        "beyond loopback (--host 0.0.0.0) only on a trusted network",
    )
    parser.add_argument("--port", type=int, default=DEFAULT_PORT)
    parser.add_argument(
        "--hot-mb",
        type=int,
        default=0,
        help="optional in-memory hot tier (MiB); 0 disables tiering",
    )
    parser.add_argument(
        "--log-level",
        default="info",
        choices=["debug", "info", "warning", "error", "critical"],
        help="logging verbosity for the repro logger tree",
    )
    parser.add_argument(
        "--log-json",
        action="store_true",
        help="emit JSON-lines logs instead of the human-readable format",
    )
    parser.add_argument(
        "--trace-dir",
        default=None,
        help="record spans as NDJSON under this directory (enables tracing; "
        "also reachable via REPRO_TRACE_DIR)",
    )
    parser.add_argument(
        "--service",
        default=os.environ.get("REPRO_SERVICE", "store"),
        help="service name stamped on this process's spans "
        "(default: $REPRO_SERVICE or 'store')",
    )
    args = parser.parse_args(argv)

    configure_logging(args.log_level, json_lines=args.log_json)
    log = get_logger("net.serve")
    if args.trace_dir:
        configure_tracing(args.trace_dir, args.service)

    backend = LocalFSBackend(args.root)
    if args.hot_mb > 0:
        backend = TieredBackend(
            backend, MemoryBackend(), hot_capacity_bytes=args.hot_mb << 20
        )
    server = StoreServer(
        backend, host=args.host, port=args.port, trace_service=args.service
    )
    server.start()
    log.info("store server listening on %s (root=%s)", server.url, args.root)

    signal.signal(signal.SIGTERM, lambda *_: server.stop())
    signal.signal(signal.SIGINT, lambda *_: server.stop())
    try:
        server.wait()
    except KeyboardInterrupt:
        pass
    finally:
        server.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
