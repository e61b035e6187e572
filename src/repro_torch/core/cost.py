"""Execution-time cost model (thesis Ch. 4.5.4, Eq. 4.9).

  T1 = time to execute modules M1..Mk (+ store the result)
  T2 = time to retrieve the stored result
  Execution-time gain = T1 - T2; storing pays off iff T1 > T2.

The model tracks per-(module, state) execution-time EMAs and the store's
measured save/load bandwidth so the executor can do cost-aware admission
("t1_gt_t2" mode) the way the thesis applies Eq. 4.9 to the P2IRC cluster.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from .store import IntermediateStore
from .workflow import ModuleRef, PrefixKey


@dataclass
class CostModel:
    store: IntermediateStore | None = None
    ema_alpha: float = 0.4
    _exec_s: dict[str, float] = field(default_factory=dict)
    _out_bytes: dict[str, float] = field(default_factory=dict)

    def observe(self, ref: ModuleRef, seconds: float, out_bytes: int) -> None:
        k = ref.key(with_state=True)
        prev = self._exec_s.get(k)
        self._exec_s[k] = seconds if prev is None else (
            self.ema_alpha * seconds + (1 - self.ema_alpha) * prev
        )
        prevb = self._out_bytes.get(k)
        self._out_bytes[k] = out_bytes if prevb is None else (
            self.ema_alpha * out_bytes + (1 - self.ema_alpha) * prevb
        )

    def exec_seconds(self, ref: ModuleRef, default: float = 0.0) -> float:
        return self._exec_s.get(ref.key(with_state=True), default)

    def prefix_exec_seconds(self, prefix: PrefixKey) -> float:
        return sum(self.exec_seconds(m) for m in prefix.modules)

    def out_bytes(self, ref: ModuleRef, default: float = 0.0) -> float:
        return self._out_bytes.get(ref.key(with_state=True), default)

    # -- Eq. 4.9 --------------------------------------------------------------
    def t1(self, prefix: PrefixKey, measured_exec_s: float | None = None) -> float:
        exec_s = (
            measured_exec_s
            if measured_exec_s is not None
            else self.prefix_exec_seconds(prefix)
        )
        store_s = 0.0
        if self.store is not None:
            b = self.out_bytes(prefix.modules[-1])
            store_s = b / self.store.save_throughput()
        return exec_s + store_s

    def t2(self, prefix: PrefixKey) -> float:
        if self.store is None:
            return 0.0
        b = self.out_bytes(prefix.modules[-1])
        return b / self.store.load_throughput()

    def gain(self, prefix: PrefixKey, measured_exec_s: float | None = None) -> float:
        return self.t1(prefix, measured_exec_s) - self.t2(prefix)

    def should_store(self, prefix: PrefixKey, measured_exec_s: float | None = None) -> bool:
        return self.gain(prefix, measured_exec_s) > 0.0

    # -- gain-loss ratio (arXiv 2202.06473) -----------------------------------
    def recompute_seconds(
        self, prefix: PrefixKey, measured_exec_s: float | None = None
    ) -> float:
        """Best estimate of re-executing the prefix from scratch — the *gain*
        numerator of the eviction criterion.  Prefers the EMA (covers modules
        skipped in the measuring run) but never under-reports a measurement."""
        return max(self.prefix_exec_seconds(prefix), measured_exec_s or 0.0)

    def gain_per_byte(
        self, prefix: PrefixKey, measured_exec_s: float | None = None
    ) -> float:
        """Seconds saved per stored byte if this prefix's artifact is kept —
        the same ratio :func:`repro.core.eviction.gain_loss_ratio` computes
        from store records, here predicted *before* the artifact exists."""
        b = self.out_bytes(prefix.modules[-1])
        return self.gain(prefix, measured_exec_s) / max(b, 1.0)
