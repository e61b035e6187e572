"""Bearer-token authentication for the workflow gateway.

The gateway's trust model is deliberately boring: a static map from opaque
bearer tokens to tenant names, supplied at startup (CLI flags, a tokens
file, or programmatically).  There is no user database, no token issuance,
no expiry — the gateway is the *front door of a workflow fabric*, not an
identity provider; production deployments put it behind whatever issues
their tokens and feed the map in.

What the module does guarantee:

  * token comparison is constant-time (``hmac.compare_digest``) — a
    timing side channel must not let one tenant brute-force another's token;
  * tenant names are validated against the namespace charset at
    registration, so a tenant name can never smuggle a ``/`` into the
    ``tenant:<name>`` private namespace and collide with another tenant.
"""
from __future__ import annotations

import hmac
from typing import Iterable, Mapping

from .tenancy import check_tenant_name


class AuthError(Exception):
    """Missing, malformed, or unknown credentials (gateway → 401)."""


class TokenAuthenticator:
    """Static ``token -> tenant`` map with constant-time lookup."""

    def __init__(self, tokens: Mapping[str, str] | None = None) -> None:
        self._tokens: dict[str, str] = {}
        for token, tenant in (tokens or {}).items():
            self.add_token(token, tenant)

    def add_token(self, token: str, tenant: str) -> None:
        if not token:
            raise ValueError("empty token")
        self._tokens[token] = check_tenant_name(tenant)

    @classmethod
    def from_pairs(cls, pairs: Iterable[str]) -> "TokenAuthenticator":
        """Build from CLI-style ``"<token>=<tenant>"`` strings."""
        auth = cls()
        for pair in pairs:
            token, sep, tenant = pair.partition("=")
            if not sep or not token or not tenant:
                raise ValueError(
                    f"malformed token spec {pair!r}; expected '<token>=<tenant>'"
                )
            auth.add_token(token, tenant)
        return auth

    def __len__(self) -> int:
        return len(self._tokens)

    def authenticate(self, authorization: str | None) -> str:
        """Map an ``Authorization`` header to a tenant name.

        Raises :class:`AuthError` on a missing header, a non-Bearer scheme,
        or an unknown token.  Every registered token is compared (constant
        work per request) so response timing does not reveal whether a
        guessed token shares a prefix with a real one.
        """
        if not authorization:
            raise AuthError("missing Authorization header")
        scheme, _, token = authorization.partition(" ")
        if scheme.lower() != "bearer" or not token.strip():
            raise AuthError("expected 'Authorization: Bearer <token>'")
        token = token.strip()
        tenant: str | None = None
        for known, name in self._tokens.items():
            if hmac.compare_digest(known.encode(), token.encode()):
                tenant = name
        if tenant is None:
            raise AuthError("unknown token")
        return tenant
