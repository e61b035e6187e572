"""Single-flight deduplication of concurrent intermediate-data computes.

When N in-flight workflow runs all need the same :class:`PrefixKey` and the
store has no artifact yet, running the module chain N times wastes N-1
computes — and the thesis' replay protocol (examine pipelines serially) never
faces this because it is sequential.  ``SingleFlight`` is the concurrent
generalization: the first arrival becomes the *leader* and computes; followers
block on the flight's event and receive the leader's in-memory value.  The
leader still routes the result through the normal store/eviction admission
path, so once the flight lands, later runs hit the store as usual.

Flights are keyed by store key and removed as soon as they resolve; a leader
failure propagates the exception to every follower (a deterministic module
fails identically everywhere).
"""
from __future__ import annotations

import threading
from typing import Any, Callable

from ..obs.metrics import MetricsRegistry


class _Flight:
    __slots__ = ("_event", "_value", "_exc")

    def __init__(self) -> None:
        self._event = threading.Event()
        self._value: Any = None
        self._exc: BaseException | None = None

    def resolve(self, value: Any) -> None:
        self._value = value
        self._event.set()

    def fail(self, exc: BaseException) -> None:
        self._exc = exc
        self._event.set()

    def wait(self, timeout: float | None = None) -> Any:
        if not self._event.wait(timeout):
            raise TimeoutError("single-flight leader did not finish in time")
        if self._exc is not None:
            raise self._exc
        return self._value


class SingleFlight:
    """Per-key compute deduplication across concurrent runs."""

    def __init__(self, registry: MetricsRegistry | None = None) -> None:
        self._lock = threading.Lock()
        self._flights: dict[str, _Flight] = {}
        # counters live in the shared metrics registry; ``leads``/``waits``
        # remain as read-only properties for existing callers
        self.metrics = registry if registry is not None else MetricsRegistry()
        self._m_leads = self.metrics.counter(
            "repro_singleflight_leads_total", "flights this process computed"
        )
        self._m_waits = self.metrics.counter(
            "repro_singleflight_waits_total",
            "flights coalesced onto another caller's compute",
        )

    @property
    def leads(self) -> int:
        """Times a caller computed (deprecated alias of
        ``repro_singleflight_leads_total``)."""
        return int(self._m_leads.value)

    @property
    def waits(self) -> int:
        """Times a caller coalesced onto another's compute (deprecated alias
        of ``repro_singleflight_waits_total``)."""
        return int(self._m_waits.value)

    def run(
        self,
        key: str,
        fn: Callable[[], Any],
        timeout: float | None = None,
    ) -> tuple[Any, bool]:
        """Return ``(fn(), True)`` as the leader, or ``(leader's value,
        False)`` after waiting on an in-progress flight for the same key."""
        with self._lock:
            flight = self._flights.get(key)
            if flight is None:
                flight = _Flight()
                self._flights[key] = flight
                self._m_leads.inc()
                leader = True
            else:
                self._m_waits.inc()
                leader = False
        if not leader:
            return flight.wait(timeout), False
        try:
            value = fn()
        except BaseException as e:
            flight.fail(e)
            raise
        else:
            flight.resolve(value)
            return value, True
        finally:
            with self._lock:
                self._flights.pop(key, None)

    @property
    def in_flight(self) -> int:
        with self._lock:
            return len(self._flights)
