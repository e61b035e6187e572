"""``repro_torch.gateway`` — the HTTP front door of the workflow fabric.

Everything below this package is an in-process library; everything above it
is "millions of users".  The gateway closes that gap with four layers, each
its own module:

  * :mod:`~repro_torch.gateway.auth`      — bearer tokens → tenants
    (constant-time lookup, no identity provider pretensions);
  * :mod:`~repro_torch.gateway.tenancy`   — tenant → artifact namespace: private
    ``tenant:<name>`` isolation by construction, opt-in ``shared`` namespace
    where identical public prefixes collide on purpose so tenants reuse each
    other's intermediates — the thesis' reuse economics across users;
  * :mod:`~repro_torch.gateway.admission` — per-tenant quotas (runs in flight,
    live stored bytes billed against the eviction budget) over the
    service-wide ``max_pending`` bound: saturation is a structured 429 with
    Retry-After, never an unbounded queue;
  * :mod:`~repro_torch.gateway.server`    — the threaded stdlib HTTP/JSON service:
    ``POST /v1/workflows``, ``GET /v1/runs/{id}`` (+ chunked ``/events``
    stream), ``GET /v1/recommend``, ``GET /v1/stats``, ``GET /healthz``,
    and two-phase SIGTERM drain.

Run one with ``python -m repro_torch.gateway.serve``; see ``docs/gateway.md``.
"""
from .admission import AdmissionController, QuotaExceeded
from .auth import AuthError, TokenAuthenticator
from .server import DEFAULT_PORT, GatewayServer, RunHandle
from .tenancy import (
    SHARED_NAMESPACE,
    NamespaceDenied,
    TenancyPolicy,
    private_namespace,
)

__all__ = [
    "AdmissionController",
    "AuthError",
    "DEFAULT_PORT",
    "GatewayServer",
    "NamespaceDenied",
    "QuotaExceeded",
    "RunHandle",
    "SHARED_NAMESPACE",
    "TenancyPolicy",
    "TokenAuthenticator",
    "private_namespace",
]
