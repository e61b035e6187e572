"""Consistent-hash ring: static cluster membership -> per-key shard routing.

The sharded store routes every artifact key (and every meta name) onto an
ordered *preference list* of shards: the key's position on the ring picks
its **primary**, and walking the ring clockwise yields the failover /
replication order.  Consistent hashing — rather than ``hash(key) % N`` —
keeps two properties the cluster leans on:

  * **stability** — membership is part of the configuration every client
    shares (``Client(store_url="h:p1,h:p2,h:p3")``); any process that hashes
    the same member list routes every key identically, with no coordination.
    Removing one member remaps only the keys that lived on it.
  * **spread** — each member is hashed onto the ring at many *virtual
    points*, so the keyspace splits near-uniformly even with 3 shards
    (a single point per shard can skew arc lengths by several x).

Keys here are the store's ``PrefixKey`` digests — high-entropy strings — so
SHA-256 of ``key`` is an unbiased ring position.  The ring is immutable
after construction: membership changes are a *deployment* action (restart
clients with the new list), which is the static-membership contract
``docs/remote.md`` documents.
"""
from __future__ import annotations

import bisect
import hashlib
from typing import Iterable, Sequence


def _point(label: str) -> int:
    """Ring position of ``label``: first 8 bytes of SHA-256, big-endian."""
    return int.from_bytes(hashlib.sha256(label.encode()).digest()[:8], "big")


class HashRing:
    """Immutable consistent-hash ring over a static member list."""

    def __init__(self, nodes: Iterable[str], vnodes: int = 64) -> None:
        self.nodes: tuple[str, ...] = tuple(dict.fromkeys(nodes))
        if not self.nodes:
            raise ValueError("a hash ring needs at least one node")
        if vnodes < 1:
            raise ValueError("vnodes must be >= 1")
        self.vnodes = vnodes
        points: list[tuple[int, str]] = []
        for node in self.nodes:
            for v in range(vnodes):
                points.append((_point(f"{node}#{v}"), node))
        points.sort()
        self._points = points
        self._hashes = [h for h, _ in points]

    def order(self, key: str) -> list[str]:
        """Every node, in ring-walk (preference) order for ``key``.

        Index 0 is the key's primary; successive entries are the failover /
        replica targets.  Walking clockwise from the key's hash and keeping
        the first appearance of each node makes the order consistent across
        processes and stable under key-space shifts.
        """
        if len(self.nodes) == 1:
            return [self.nodes[0]]
        start = bisect.bisect_right(self._hashes, _point(key)) % len(self._points)
        seen: set[str] = set()
        out: list[str] = []
        n = len(self._points)
        for i in range(n):
            node = self._points[(start + i) % n][1]
            if node not in seen:
                seen.add(node)
                out.append(node)
                if len(out) == len(self.nodes):
                    break
        return out

    def primary(self, key: str) -> str:
        return self.order(key)[0]

    def replicas(self, key: str, r: int) -> list[str]:
        """The key's first ``min(r, len(nodes))`` preferred nodes (>= 1)."""
        return self.order(key)[: max(1, min(r, len(self.nodes)))]

    def spread(self, keys: Sequence[str]) -> dict[str, int]:
        """Primary-assignment histogram (diagnostics / balance tests)."""
        counts = {n: 0 for n in self.nodes}
        for k in keys:
            counts[self.primary(k)] += 1
        return counts

    def __len__(self) -> int:
        return len(self.nodes)

    def __repr__(self) -> str:
        return f"HashRing({list(self.nodes)!r}, vnodes={self.vnodes})"
