"""``python -m repro_torch.gateway.serve`` — run the workflow gateway.

Example::

    python -m repro_torch.gateway.serve --root /var/lib/repro-artifacts \\
        --port 8707 --token s3cret-a=alice --token s3cret-b=bob \\
        --modules mypkg.pipelines:register

    curl -s -X POST http://127.0.0.1:8707/v1/workflows \\
        -H 'Authorization: Bearer s3cret-a' \\
        -d '{"spec": {...workflow spec json...}, "data": [1,2,3],
             "namespace": "shared", "wait": true}'

``--device`` (default ``cuda``) is where the client loads reused prefixes;
pass ``--device cpu`` on a machine without a card.

``--modules`` imports ``pkg.mod`` and calls its ``register(registry)`` (or a
named function after ``:``) so the gateway knows the module universe tenants
may reference.  ``--demo-modules`` registers a tiny arithmetic pipeline set —
enough to smoke-test the gateway end to end without writing code.

Binds loopback by default: tokens ride in plaintext HTTP headers, so expose
the gateway beyond ``127.0.0.1`` only behind TLS termination or on a trusted
network.  SIGTERM/SIGINT trigger the two-phase graceful shutdown (new
submissions 503, in-flight runs drain, then the listener stops).
"""
from __future__ import annotations

import argparse
import importlib
import os
import signal
import sys
import threading

from ..api.client import Client
from ..core.registry import ModuleRegistry
from ..obs.logging import configure_logging, get_logger
from ..obs.tracing import configure_tracing
from .auth import TokenAuthenticator
from .server import DEFAULT_PORT, GatewayServer
from .tenancy import SHARED_NAMESPACE, TenancyPolicy


def register_demo_modules(registry: ModuleRegistry) -> None:
    """A tiny numeric pipeline universe for smoke tests and demos."""

    @registry.module("normalize")
    def normalize(xs):
        total = sum(xs) or 1.0
        return [x / total for x in xs]

    @registry.module("scale", factor=2.0)
    def scale(xs, factor=2.0):
        return [x * factor for x in xs]

    @registry.module("stats")
    def stats(xs):
        return {"n": len(xs), "mean": sum(xs) / len(xs) if xs else 0.0}


def _load_modules(spec: str, registry: ModuleRegistry) -> None:
    mod_name, _, fn_name = spec.partition(":")
    mod = importlib.import_module(mod_name)
    fn = getattr(mod, fn_name or "register")
    fn(registry)


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.gateway.serve",
        description="HTTP front door: multi-tenant workflow submission over "
        "one shared intermediate-data fabric.",
    )
    parser.add_argument("--root", help="artifact directory (default: temp dir)")
    parser.add_argument(
        "--store-url",
        help="mount a repro_torch.net store/cluster instead of a local root "
        '(e.g. "h:7077" or "h:7077,h:7078,h:7079")',
    )
    parser.add_argument(
        "--host",
        default="127.0.0.1",
        help="bind address; tokens travel as plaintext HTTP headers, so go "
        "beyond loopback only behind TLS or on a trusted network",
    )
    parser.add_argument("--port", type=int, default=DEFAULT_PORT)
    parser.add_argument(
        "--token",
        action="append",
        default=[],
        metavar="TOKEN=TENANT",
        help="register one bearer token (repeatable); required",
    )
    parser.add_argument(
        "--modules",
        action="append",
        default=[],
        metavar="PKG.MOD[:FN]",
        help="import and call FN(registry) (default FN: register) to "
        "populate the module universe (repeatable)",
    )
    parser.add_argument(
        "--demo-modules",
        action="store_true",
        help="register the built-in demo pipeline modules",
    )
    parser.add_argument("--policy", default="PT")
    parser.add_argument(
        "--device",
        default="cuda",
        help="where the client loads reused prefixes (default: cuda; "
        "cpu runs without a card)",
    )
    parser.add_argument("--max-workers", type=int, default=4)
    parser.add_argument(
        "--max-pending",
        type=int,
        default=64,
        help="service-wide pending-run budget; saturation answers 429",
    )
    parser.add_argument(
        "--max-inflight-per-tenant",
        type=int,
        default=16,
        help="per-tenant in-flight run quota (0 disables)",
    )
    parser.add_argument(
        "--max-mb-per-tenant",
        type=int,
        default=0,
        help="per-tenant live stored-bytes quota in MiB (0 disables)",
    )
    parser.add_argument(
        "--capacity-mb",
        type=int,
        default=0,
        help="store eviction budget in MiB (0: unbounded)",
    )
    parser.add_argument(
        "--shared-namespace",
        action="append",
        default=[],
        help=f"extra opt-in shared namespaces (default: {SHARED_NAMESPACE!r})",
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
        default=os.environ.get("REPRO_SERVICE", "gateway"),
        help="service name stamped on this process's spans "
        "(default: $REPRO_SERVICE or 'gateway')",
    )
    args = parser.parse_args(argv)

    configure_logging(args.log_level, json_lines=args.log_json)
    log = get_logger("gateway.serve")
    if args.trace_dir:
        configure_tracing(args.trace_dir, args.service)

    if not args.token:
        parser.error("at least one --token TOKEN=TENANT is required")
    auth = TokenAuthenticator.from_pairs(args.token)

    client = Client(
        root=args.root if not args.store_url else None,
        store_url=args.store_url,
        policy=args.policy,
        max_workers=args.max_workers,
        capacity_bytes=(args.capacity_mb << 20) or None,
        max_pending=args.max_pending,
        device=args.device,
    )
    if args.demo_modules:
        register_demo_modules(client.registry)
    for spec in args.modules:
        _load_modules(spec, client.registry)

    shared = tuple([SHARED_NAMESPACE, *args.shared_namespace])
    gateway = GatewayServer(
        client,
        auth,
        host=args.host,
        port=args.port,
        tenancy=TenancyPolicy(shared),
        max_inflight_per_tenant=args.max_inflight_per_tenant or None,
        max_bytes_per_tenant=(args.max_mb_per_tenant << 20) or None,
        own_client=True,
    )
    gateway.start()
    log.info(
        "gateway listening on %s (tenants=%d, modules=%d)",
        gateway.url, len(auth), len(client.registry),
    )

    done = threading.Event()

    def _graceful(*_: object) -> None:
        # phase one inline (reject new work immediately); the drain happens
        # on the main thread below
        gateway.begin_shutdown()
        done.set()

    signal.signal(signal.SIGTERM, _graceful)
    signal.signal(signal.SIGINT, _graceful)
    try:
        done.wait()
    except KeyboardInterrupt:
        gateway.begin_shutdown()
    log.info("gateway draining in-flight runs...")
    gateway.close()
    log.info("gateway stopped")
    return 0


if __name__ == "__main__":
    sys.exit(main())
