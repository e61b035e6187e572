"""Capacity-bounded eviction with the gain-loss-ratio criterion.

The thesis' Eq. 4.9 admission test (store iff T1 > T2) decides what *enters*
the store; Chakroborti's follow-up ("Gain-loss ratio of storing intermediate
data from workflows", arXiv 2202.06473) supplies the criterion for what
*leaves* it once a storage budget binds:

    gain(a)  = expected execution time saved by keeping artifact ``a``
             = (recompute seconds − load seconds) × expected future hits
    loss(a)  = bytes of budget the artifact occupies
    ratio(a) = gain(a) / loss(a)      — seconds saved per byte stored

Artifacts with the lowest ratio are evicted first: a huge artifact that is
cheap to recompute frees many bytes at little cost, while a small artifact
downstream of an expensive fit stays pinned almost indefinitely.  Expected
future hits are estimated from observed hits (``n_loads``), the same
frequency signal the thesis' association rules exploit.

``LRUEviction`` is kept as the classical baseline; ``bench_eviction.py``
sweeps both against the same budget.

Records are duck-typed: anything exposing ``nbytes_disk``, ``nbytes_raw``,
``save_s``, ``load_s``, ``n_loads``, ``compute_s`` and ``last_used_at`` works
— ``ArtifactRecord`` in the store and KV-snapshot records in ``ServeEngine``
share this shape, so serving memory is bounded by the same policy.
"""
from __future__ import annotations

import threading
from abc import ABC, abstractmethod
from dataclasses import dataclass
from typing import Any, Iterable, Mapping


@dataclass
class EvictionContext:
    """Store-level signals a policy may need (measured load bandwidth)."""

    load_bps: float = 1e9  # bytes/second; store passes its measured value


class EvictionPolicy(ABC):
    """Ranks records; lower score = evicted earlier.

    ``value_aware`` policies also gate *admission*: a newcomer whose score is
    below the artifacts it would displace is evicted itself instead (LRU, by
    definition, always favors the newcomer).
    """

    name = "abstract"
    value_aware = False

    @abstractmethod
    def score(self, rec: Any, ctx: EvictionContext) -> float: ...


class LRUEviction(EvictionPolicy):
    """Classical recency baseline: evict the least-recently-used artifact."""

    name = "lru"

    def score(self, rec: Any, ctx: EvictionContext) -> float:
        return rec.last_used_at


class GainLossEviction(EvictionPolicy):
    """Evict the artifact with the least execution-time gain per byte."""

    name = "gain_loss"
    value_aware = True

    def score(self, rec: Any, ctx: EvictionContext) -> float:
        return gain_loss_ratio(rec, ctx)


def gain_loss_ratio(rec: Any, ctx: EvictionContext | None = None) -> float:
    """Seconds of future execution time saved per byte of budget occupied."""
    ctx = ctx or EvictionContext()
    load_s = rec.load_s if rec.load_s else rec.nbytes_raw / max(ctx.load_bps, 1.0)
    # recompute time: measured module-chain seconds if the producer reported
    # them, else the save wall time (a write-bandwidth-shaped lower bound)
    recompute_s = rec.compute_s if rec.compute_s is not None else rec.save_s
    gain_per_hit = max(recompute_s - load_s, 0.0)
    # sub-linear frequency weighting: observed hits raise the expected-hit
    # estimate without making incumbents unseat-able by never-yet-hit
    # newcomers (the policy layer's rule mining owns the popularity signal)
    expected_hits = (1.0 + rec.n_loads) ** 0.5
    return gain_per_hit * expected_hits / max(rec.nbytes_disk, 1)


POLICIES: dict[str, type[EvictionPolicy]] = {
    "gain_loss": GainLossEviction,
    "lru": LRUEviction,
}


class EvictionManager:
    """Keeps a record set within ``capacity_bytes`` by ranked eviction."""

    def __init__(
        self,
        capacity_bytes: int | None = None,
        policy: str | EvictionPolicy = "gain_loss",
    ) -> None:
        self.capacity_bytes = capacity_bytes
        self.policy = POLICIES[policy]() if isinstance(policy, str) else policy
        self.n_evictions = 0
        self.bytes_evicted = 0
        # counters are read/written from concurrent scheduler workers; the
        # store additionally holds its own lock around select_victims calls
        self._lock = threading.Lock()

    def admits(self, nbytes: int) -> bool:
        """A single artifact larger than the whole budget is never admitted."""
        return self.capacity_bytes is None or nbytes <= self.capacity_bytes

    def select_victims(
        self,
        records: Mapping[str, Any],
        total_bytes: int,
        protect: Iterable[str] = (),
        ctx: EvictionContext | None = None,
        incoming: str | None = None,
    ) -> list[str]:
        """Keys to evict (worst score first) to bring ``total_bytes`` under budget.

        ``protect`` shields keys unconditionally.  ``incoming`` names the
        just-inserted record: under a ``value_aware`` policy it only displaces
        strictly lower-scored artifacts — if those don't free enough bytes,
        the newcomer itself is the (sole) victim.  Pure selection — the
        caller performs the deletions.
        """
        if self.capacity_bytes is None or total_bytes <= self.capacity_bytes:
            return []
        ctx = ctx or EvictionContext()
        protected = set(protect)
        incoming_score = None
        if incoming is not None and incoming in records and self.policy.value_aware:
            incoming_score = self.policy.score(records[incoming], ctx)
        ranked = sorted(
            (k for k in records if k not in protected and k != incoming),
            key=lambda k: (self.policy.score(records[k], ctx), records[k].last_used_at),
        )
        victims: list[str] = []
        excess = total_bytes - self.capacity_bytes
        for k in ranked:
            if excess <= 0:
                break
            if (
                incoming_score is not None
                and self.policy.score(records[k], ctx) > incoming_score
            ):
                break  # everything left is worth more per byte than the newcomer
            victims.append(k)
            excess -= records[k].nbytes_disk
        if excess > 0 and incoming is not None and incoming_score is not None:
            victims = [incoming]  # newcomer can't pay for the bytes it needs
        with self._lock:
            self.n_evictions += len(victims)
            self.bytes_evicted += sum(records[k].nbytes_disk for k in victims)
        return victims
