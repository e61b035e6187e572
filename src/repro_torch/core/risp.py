"""Storage-recommendation policies: RISP (PT) and the thesis' three baselines.

Replay protocol (thesis Ch. 4.5.1): pipelines are examined serially; for the
n-th pipeline each policy first answers "which already-stored intermediate
state can this pipeline reuse?" (vs. stores decided on pipelines 1..n-1), then
decides what to store from the n-th pipeline.

Policies:
  PT / RISP   — store the output indicated by the *longest highest-confidence*
                association rule of the pipeline under progress (Ch. 4.3.3).
  TSAR        — store every intermediate state result.
  TSPAR       — store the state indicated by the longest rule with support >= 1
                in the previous history.
  TSFR        — store only the final result.

``with_state=True`` selects the adaptive variant (Ch. 5): keys include each
module's tool-state digest so differently-parameterized runs never match.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field

from .rules import RuleMiner
from .workflow import PrefixKey, Workflow


@dataclass
class StoredRecord:
    prefix: PrefixKey
    stored_at: int  # pipeline index that triggered the store
    reuse_count: int = 0


@dataclass
class Recommendation:
    """Result of observing one pipeline."""

    reuse: PrefixKey | None  # longest previously-stored prefix of this pipeline
    store: list[PrefixKey] = field(default_factory=list)  # newly admitted keys


class StoragePolicy:
    """Base class; subclasses override ``_select_stores``."""

    name = "base"

    def __init__(self, with_state: bool = False) -> None:
        self.with_state = with_state
        self.miner = RuleMiner(with_state=with_state)
        self.stored: dict[str, StoredRecord] = {}
        self.n_pipelines = 0
        self.n_reusable_pipelines = 0
        self.total_reuse_events = 0
        self.total_intermediate_states = 0
        # serializes the replay protocol (miner + counters + stored map) when
        # many scheduler runs step the same policy concurrently.  Lock order:
        # never call store methods while holding this lock (the store's evict
        # listeners mutate ``stored`` with plain GIL-atomic dict ops instead).
        self.lock = threading.RLock()

    # -- main entry point --------------------------------------------------
    def step(self, wf: Workflow) -> Recommendation:
        with self.lock:
            return self._step_locked(wf)

    def _step_locked(self, wf: Workflow) -> Recommendation:
        self.n_pipelines += 1
        self.total_intermediate_states += wf.n_intermediate_states

        reuse = self.lookup_reuse(wf)
        if reuse is not None:
            rec = self.stored[reuse.key(self.with_state)]
            rec.reuse_count += 1
            self.n_reusable_pipelines += 1
            self.total_reuse_events += 1

        stores = self._select_stores(wf)
        admitted = []
        for prefix in stores:
            key = prefix.key(self.with_state)
            if key not in self.stored:
                self.stored[key] = StoredRecord(prefix, self.n_pipelines)
                admitted.append(prefix)
        return Recommendation(reuse=reuse, store=admitted)

    def step_paths(self, workflows: "list[Workflow]") -> Recommendation:
        """Step every root-to-sink path of one DAG atomically (Ch. 3.3
        decomposition: a DAG contributes one mined pipeline per path) and
        merge the recommendations: deepest reuse wins, stores are unioned."""
        with self.lock:
            reuse: PrefixKey | None = None
            store: list[PrefixKey] = []
            seen: set[str] = set()
            for wf in workflows:
                rec = self._step_locked(wf)
                if rec.reuse is not None and (
                    reuse is None or rec.reuse.depth > reuse.depth
                ):
                    reuse = rec.reuse
                for prefix in rec.store:
                    key = prefix.key(self.with_state)
                    if key not in seen:
                        seen.add(key)
                        store.append(prefix)
            return Recommendation(reuse=reuse, store=store)

    def lookup_reuse(self, wf: Workflow) -> PrefixKey | None:
        """Longest stored prefix of ``wf`` (the deepest skip point)."""
        for k in range(len(wf), 0, -1):
            prefix = wf.prefix(k)
            if prefix.key(self.with_state) in self.stored:
                return prefix
        return None

    # -- policy-specific admission ------------------------------------------
    def _select_stores(self, wf: Workflow) -> list[PrefixKey]:
        raise NotImplementedError

    # -- reporting -----------------------------------------------------------
    @property
    def n_stored(self) -> int:
        return len(self.stored)

    @property
    def n_stored_reused(self) -> int:
        return sum(1 for r in self.stored.values() if r.reuse_count > 0)


class RISP(StoragePolicy):
    """PT: store the output of the longest among the highest-confidence
    association rules of the pipeline under progress (thesis Ch. 4.3.3).

    Only rules that were *obtained from the pipelines in the history* are
    candidates (support >= 2 counting the current pipeline, i.e. the prefix
    appeared in at least one earlier pipeline).  Without this gate a pipeline
    whose prefixes are all novel would tie at minimal confidence and store its
    final result, which contradicts the thesis' stored counts (PT stores 49
    results vs. TSPAR's 159 on the 508-workflow corpus — PT must be the more
    selective policy).  The Fig. 4.1 worked example is unaffected: the
    highest-confidence rules D1=>M1 and D1=>[M1,M2] have support 3, and the
    longest, [M1,M2], is recommended.
    """

    name = "PT"

    def _select_stores(self, wf: Workflow) -> list[PrefixKey]:
        self.miner.add(wf)
        rules = [r for r in self.miner.rules_for(wf) if r.support >= 2]
        if not rules:
            return []
        best = max(r.confidence for r in rules)
        candidates = [r for r in rules if r.confidence == best]
        chosen = max(candidates, key=lambda r: r.depth)
        return [chosen.prefix]


class TSAR(StoragePolicy):
    """Store All Results."""

    name = "TSAR"

    def _select_stores(self, wf: Workflow) -> list[PrefixKey]:
        self.miner.add(wf)
        return list(wf.prefixes())


class TSPAR(StoragePolicy):
    """Store Previously-Appeared Results: longest prefix with support >= 1 in
    the first n-1 pipelines."""

    name = "TSPAR"

    def _select_stores(self, wf: Workflow) -> list[PrefixKey]:
        seen = [p for p in wf.prefixes() if self.miner.support(p) >= 1]
        self.miner.add(wf)
        if not seen:
            return []
        return [max(seen, key=len)]


class TSFR(StoragePolicy):
    """Store the Final Result only."""

    name = "TSFR"

    def _select_stores(self, wf: Workflow) -> list[PrefixKey]:
        self.miner.add(wf)
        return [wf.prefix(len(wf))]


POLICIES: dict[str, type[StoragePolicy]] = {
    "PT": RISP,
    "TSAR": TSAR,
    "TSPAR": TSPAR,
    "TSFR": TSFR,
}


def make_policy(name: str, with_state: bool = False) -> StoragePolicy:
    return POLICIES[name](with_state=with_state)
