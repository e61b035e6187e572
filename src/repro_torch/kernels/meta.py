"""The kernels' shape-only path on the ``meta`` device, for the dry-run.

The dry-run (:mod:`repro_torch.launch.dryrun`) traces a step on ``meta``
tensors: no values, no memory.  Each kernel wrapper takes an explicit
branch for them (never a fallback: a ``cuda`` tensor still launches its
kernel or raises, a ``cpu`` one still takes the plain version).  On
``meta`` a wrapper allocates what its kernel path allocates on the card
(outputs, scratch, index and sort buffers) as meta tensors, so the dry-run's
memory count sees them, reports the call's FLOPs and bytes here, and
launches nothing.  The plain versions never run there: the plain flash
attention, for one, builds [B,H,S,S] scores that the kernel never holds.

The counts follow PERF.md's bounds: FLOPs 2 a multiply-add over the work
the mask or the index keeps, bytes each input read once and each output
written once.  ``unit`` names the peak that the work runs at
(:data:`repro_torch.launch.analysis.PEAKS`).
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import Iterator

SMS = 132  # the H100 SXM's SMs: the plans' SM count for a card the dry-run reckons


@dataclass
class KernelCounts:
    """What the kernels' meta paths reported while this counter was open."""

    calls: dict[str, int] = field(default_factory=dict)
    flops: dict[str, float] = field(default_factory=dict)  # by kernel
    bytes: dict[str, float] = field(default_factory=dict)  # by kernel
    flops_by_unit: dict[str, float] = field(default_factory=dict)

    def add(self, kernel: str, flops: float, nbytes: float, unit: str) -> None:
        self.calls[kernel] = self.calls.get(kernel, 0) + 1
        self.flops[kernel] = self.flops.get(kernel, 0.0) + flops
        self.bytes[kernel] = self.bytes.get(kernel, 0.0) + nbytes
        self.flops_by_unit[unit] = self.flops_by_unit.get(unit, 0.0) + flops


_open: list[KernelCounts] = []


@contextlib.contextmanager
def counting() -> Iterator[KernelCounts]:
    """A counter of the meta calls made inside the block."""
    counts = KernelCounts()
    _open.append(counts)
    try:
        yield counts
    finally:
        _open.remove(counts)


def record(kernel: str, flops: float, nbytes: float, unit: str) -> None:
    """One kernel call on meta tensors: its FLOPs at ``unit``'s peak and its
    bytes, added to every open counter."""
    for counts in _open:
        counts.add(kernel, float(flops), float(nbytes), unit)
