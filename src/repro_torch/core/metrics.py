"""Replay evaluator computing the thesis' four measures (Ch. 4.5.2 / 5.4.2).

  LR    = pipelines that could reuse previously stored results / pipelines x100
  PSRR  = stored results reused at least once / stored results x100
  FRSR  = total reuse events / stored results
  PISRS = stored results / total intermediate states x100
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Sequence

from .risp import StoragePolicy, make_policy
from .workflow import Workflow


@dataclass
class PolicyReport:
    name: str
    n_pipelines: int
    n_reusable_pipelines: int
    n_stored: int
    n_stored_reused: int
    total_reuse_events: int
    total_intermediate_states: int

    @property
    def lr(self) -> float:
        return 100.0 * self.n_reusable_pipelines / max(self.n_pipelines, 1)

    @property
    def psrr(self) -> float:
        return 100.0 * self.n_stored_reused / max(self.n_stored, 1)

    @property
    def frsr(self) -> float:
        return self.total_reuse_events / max(self.n_stored, 1)

    @property
    def pisrs(self) -> float:
        return 100.0 * self.n_stored / max(self.total_intermediate_states, 1)

    def row(self) -> dict[str, float | int | str]:
        return {
            "policy": self.name,
            "pipelines": self.n_pipelines,
            "reusable_pipelines": self.n_reusable_pipelines,
            "stored": self.n_stored,
            "LR_pct": round(self.lr, 2),
            "PSRR_pct": round(self.psrr, 2),
            "FRSR": round(self.frsr, 2),
            "PISRS_pct": round(self.pisrs, 2),
        }


def evaluate_policy(policy: StoragePolicy, corpus: Iterable[Workflow]) -> PolicyReport:
    for wf in corpus:
        policy.step(wf)
    return PolicyReport(
        name=policy.name,
        n_pipelines=policy.n_pipelines,
        n_reusable_pipelines=policy.n_reusable_pipelines,
        n_stored=policy.n_stored,
        n_stored_reused=policy.n_stored_reused,
        total_reuse_events=policy.total_reuse_events,
        total_intermediate_states=policy.total_intermediate_states,
    )


def evaluate_all(
    corpus: Sequence[Workflow],
    names: Sequence[str] = ("PT", "TSAR", "TSPAR", "TSFR"),
    with_state: bool = False,
) -> dict[str, PolicyReport]:
    return {
        name: evaluate_policy(make_policy(name, with_state=with_state), corpus)
        for name in names
    }
