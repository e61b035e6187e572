"""Tenant → namespace mapping: the isolation *and* sharing rules.

Every authenticated submission runs inside exactly one artifact namespace,
and the namespace is what every ``PrefixKey`` is derived from (see
``repro_torch.api.spec.namespaced_dataset``), so these rules are the whole
cross-tenant story:

  * ``tenant:<name>`` — the tenant's **private** namespace.  Artifacts
    stored there are keyed under ``tenant:<name>/<dataset>::…`` and can
    never be produced or probed by another tenant's submission, because no
    other tenant's submissions are ever resolved into that namespace.
  * ``shared`` (and any extra names the operator allows) — the **opt-in
    public** namespace.  Any tenant may submit into it; identical public
    prefixes then collide *by construction*, which is the point: tenant B's
    run of a pipeline tenant A already ran skips A's stored intermediates.
    The thesis' reuse economics, across users.

A submission may name a namespace explicitly (request field or spec field).
Naming nothing means private.  Naming another tenant's private namespace is
refused (gateway → 403) — isolation is enforced here, at admission, not by
hoping clients behave.
"""
from __future__ import annotations

from ..api.spec import SpecError, check_namespace

SHARED_NAMESPACE = "shared"
TENANT_PREFIX = "tenant:"


class NamespaceDenied(Exception):
    """The tenant asked for a namespace it may not use (gateway → 403)."""


def check_tenant_name(tenant: str) -> str:
    """Tenant names must be non-empty, namespace-safe, and must not embed
    the reserved ``tenant:`` prefix or namespace separators."""
    if not tenant:
        raise ValueError("empty tenant name")
    try:
        check_namespace(tenant)
    except SpecError as e:
        raise ValueError(f"invalid tenant name {tenant!r}: {e}") from None
    if ":" in tenant:
        raise ValueError(f"invalid tenant name {tenant!r}: ':' is reserved")
    return tenant


def private_namespace(tenant: str) -> str:
    return f"{TENANT_PREFIX}{tenant}"


class TenancyPolicy:
    """Resolves a (tenant, requested namespace) pair to the namespace a
    submission actually runs in."""

    def __init__(self, shared_namespaces: tuple[str, ...] = (SHARED_NAMESPACE,)) -> None:
        for ns in shared_namespaces:
            check_namespace(ns)
            if ns.startswith(TENANT_PREFIX):
                raise ValueError(
                    f"shared namespace {ns!r} collides with the tenant: prefix"
                )
        self.shared_namespaces = tuple(shared_namespaces)

    def resolve(self, tenant: str, requested: str | None) -> str:
        """The namespace this tenant's submission runs in.

        ``None``/``""``/the tenant's own private namespace → private;
        an allowed shared namespace → that namespace; anything else →
        :class:`NamespaceDenied`.
        """
        mine = private_namespace(tenant)
        if not requested or requested == mine:
            return mine
        try:
            check_namespace(requested)
        except SpecError as e:
            raise NamespaceDenied(str(e)) from None
        if requested in self.shared_namespaces:
            return requested
        if requested.startswith(TENANT_PREFIX):
            raise NamespaceDenied(
                f"namespace {requested!r} is another tenant's private space"
            )
        raise NamespaceDenied(
            f"namespace {requested!r} is not an allowed shared namespace "
            f"(allowed: {', '.join(self.shared_namespaces)})"
        )
