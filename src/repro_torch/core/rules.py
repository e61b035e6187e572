"""Association-rule mining over workflow histories (thesis Ch. 4.3 / 5.2).

A rule is ``D => [M1..Mk]`` — "workflows on dataset D tend to start with the
module sequence M1..Mk".

    support(D => prefix) = number of pipelines in history generating the rule
    support(D)           = number of pipelines using dataset D
    confidence           = support(D => prefix) / support(D)

The miner is incremental: feeding pipelines one at a time matches the thesis'
replay protocol ("while examining the n-th pipeline ... analyzes association
rules from the previous n-1 pipelines").
"""
from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass

from .workflow import PrefixKey, Workflow


@dataclass(frozen=True)
class Rule:
    prefix: PrefixKey
    support: int
    dataset_support: int

    @property
    def confidence(self) -> float:
        return self.support / self.dataset_support if self.dataset_support else 0.0

    @property
    def depth(self) -> int:
        return self.prefix.depth


class RuleMiner:
    """Incremental support/confidence bookkeeping.

    ``with_state=True`` gives the adaptive (tool-state-aware) variant: rules
    only match when every module in the prefix has an identical parameter
    configuration (Ch. 5 example: M3 run with C3' does not extend the
    M1,M2,M3 rule mined from runs with C3).
    """

    def __init__(self, with_state: bool = False) -> None:
        self.with_state = with_state
        self._prefix_support: dict[str, int] = defaultdict(int)
        self._dataset_support: dict[str, int] = defaultdict(int)
        self._prefix_by_key: dict[str, PrefixKey] = {}
        self.n_pipelines = 0

    # -- updates ---------------------------------------------------------
    def add(self, wf: Workflow) -> None:
        self.n_pipelines += 1
        self._dataset_support[wf.dataset_id] += 1
        for prefix in wf.prefixes():
            key = prefix.key(self.with_state)
            self._prefix_support[key] += 1
            self._prefix_by_key.setdefault(key, prefix)

    # -- queries ---------------------------------------------------------
    def support(self, prefix: PrefixKey) -> int:
        return self._prefix_support.get(prefix.key(self.with_state), 0)

    def support_of_key(self, key: str) -> int:
        """Support by pre-rendered prefix key (the recommender's hot path)."""
        return self._prefix_support.get(key, 0)

    def iter_prefixes(self):
        """All distinct mined prefixes (one per rule)."""
        return iter(self._prefix_by_key.values())

    def dataset_support(self, dataset_id: str) -> int:
        return self._dataset_support.get(dataset_id, 0)

    def rule(self, prefix: PrefixKey) -> Rule:
        return Rule(
            prefix=prefix,
            support=self.support(prefix),
            dataset_support=self.dataset_support(prefix.dataset_id),
        )

    def rules_for(self, wf: Workflow) -> list[Rule]:
        """All rules derivable from ``wf`` with current history counts."""
        return [self.rule(p) for p in wf.prefixes()]

    def distinct_rules(self) -> list[Rule]:
        out = []
        for key, prefix in self._prefix_by_key.items():
            out.append(
                Rule(
                    prefix=prefix,
                    support=self._prefix_support[key],
                    dataset_support=self._dataset_support[prefix.dataset_id],
                )
            )
        return out

    @property
    def n_distinct_rules(self) -> int:
        return len(self._prefix_by_key)
