"""Adaptive RISP (thesis Ch. 5): tool-state-aware recommendation.

The adaptive variant is the same association-rule machinery with prefix keys
that include each module's parameter-configuration digest — built by passing
``with_state=True`` to any policy.  This module provides the convenience
constructors and the parameter-matching helper used by the serving layer.
"""
from __future__ import annotations

from .risp import RISP, TSAR, TSFR, TSPAR, StoragePolicy
from .workflow import ModuleRef, PrefixKey


def adaptive_risp() -> RISP:
    return RISP(with_state=True)


def adaptive_policy(name: str) -> StoragePolicy:
    from .risp import make_policy

    return make_policy(name, with_state=True)


def states_match(a: ModuleRef, b: ModuleRef) -> bool:
    """Ch. 5: a stored prefix is reusable only if module ids AND parameter
    configurations match."""
    return a.module_id == b.module_id and a.state.digest == b.state.digest


def prefix_state_match(stored: PrefixKey, wanted: PrefixKey) -> bool:
    if stored.dataset_id != wanted.dataset_id or len(stored) != len(wanted):
        return False
    return all(states_match(x, y) for x, y in zip(stored.modules, wanted.modules))


__all__ = [
    "RISP",
    "TSAR",
    "TSPAR",
    "TSFR",
    "adaptive_risp",
    "adaptive_policy",
    "states_match",
    "prefix_state_match",
]
