"""Recommendation surface: ranked reuse and next-module suggestions.

The thesis' headline contribution (Ch. 4) is an *automatic recommendation
technique*: while a user composes a workflow, the system surfaces (a) stored
intermediate states the partial workflow can start from and (b) the module
sequences users historically applied next — the interaction pattern the
companion design study (arXiv:2010.04880) found users want *during*
composition, not after.  This module makes that pipeline public: it reads the
same :class:`~repro_torch.core.rules.RuleMiner` state the storage policies maintain
(no extra bookkeeping) and ranks:

  * **reusable prefixes** — prefixes of the partial chain worth starting
    from, deepest first (the deepest is the thesis' skip point): either the
    policy claims them stored, or the mined history supports them (the
    prefix appeared in >=2 pipelines — PT's obtained-from-history gate, the
    replayed-corpus case where no artifact was ever persisted locally).
    ``stored`` flags artifacts live in the store *right now*;
  * **next modules** — association rules that extend the partial chain by
    one module, ranked by confidence then support (Ch. 4.3.3's "longest
    highest-confidence rule" ordering, applied incrementally).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Sequence

from ..core.risp import StoragePolicy
from ..core.store import IntermediateStore
from ..core.workflow import ModuleRef, PrefixKey, decode_param

if TYPE_CHECKING:  # pragma: no cover - typing only
    from ..catalog import Catalog


@dataclass(frozen=True)
class Suggestion:
    """One ranked recommendation.

    ``kind`` is ``"reusable_prefix"`` (start from this stored state; its
    depth tells how many modules the user skips), ``"next_module"``
    (``module_id`` extends the partial chain; ``prefix`` is the extended
    chain the rule describes), or ``"near_miss"`` (a *stored* artifact with
    the same module-id chain but exactly one differing parameter — served
    from the catalog; ``note`` names the difference).
    """

    kind: str
    prefix: PrefixKey
    support: int
    dataset_support: int
    stored: bool
    module_id: str | None = None
    note: str = ""

    @property
    def confidence(self) -> float:
        return self.support / self.dataset_support if self.dataset_support else 0.0

    @property
    def depth(self) -> int:
        return self.prefix.depth

    def describe(self) -> str:
        mods = ">".join(m.module_id for m in self.prefix.modules)
        if self.kind == "next_module":
            return (
                f"next: {self.module_id} (confidence {self.confidence:.2f}, "
                f"support {self.support}) -> {mods}"
            )
        if self.kind == "near_miss":
            return f"near miss [{self.note}]: {mods} (loads {self.support})"
        live = "stored" if self.stored else "recommended"
        return (
            f"reuse depth {self.depth} [{live}]: {mods} "
            f"(confidence {self.confidence:.2f}, support {self.support})"
        )


@dataclass
class RecommendReport:
    """Suggestion lists for one partial workflow."""

    dataset_id: str
    depth: int  # partial-chain length the suggestions are relative to
    reusable_prefixes: list[Suggestion]
    next_modules: list[Suggestion]
    near_misses: list[Suggestion] = field(default_factory=list)

    @property
    def best_reuse(self) -> Suggestion | None:
        return self.reusable_prefixes[0] if self.reusable_prefixes else None

    @property
    def best_next(self) -> Suggestion | None:
        return self.next_modules[0] if self.next_modules else None

    @property
    def best_near_miss(self) -> Suggestion | None:
        return self.near_misses[0] if self.near_misses else None


class Recommender:
    """Ranks suggestions from a policy's mined history + the live store.

    Shares the policy's ``RuleMiner`` and ``stored`` bookkeeping — feeding
    the recommender is just running (or replaying) workflows through the
    policy.  An index over ``(dataset, depth)`` is rebuilt lazily whenever
    the miner has advanced, so repeated ``recommend`` calls between runs are
    O(candidate rules), not O(all rules).
    """

    def __init__(
        self,
        policy: StoragePolicy,
        store: IntermediateStore | None = None,
        catalog: "Catalog | None" = None,
    ) -> None:
        self.policy = policy
        self.store = store
        self.catalog = catalog
        self._index: dict[tuple[str, int], list[PrefixKey]] = {}
        self._indexed_at = -1

    # -- index ---------------------------------------------------------------
    def _refresh(self) -> None:
        miner = self.policy.miner
        with self.policy.lock:
            if miner.n_pipelines == self._indexed_at:
                return
            index: dict[tuple[str, int], list[PrefixKey]] = {}
            for prefix in miner.iter_prefixes():
                index.setdefault((prefix.dataset_id, prefix.depth), []).append(prefix)
            self._index = index
            self._indexed_at = miner.n_pipelines

    def _is_live(self, key: str) -> bool:
        return self.store is not None and self.store.has(key)

    # -- queries ---------------------------------------------------------------
    def recommend(
        self,
        dataset_id: str,
        modules: Sequence[ModuleRef] = (),
        top_k: int = 5,
    ) -> RecommendReport:
        """Suggestions for the partial chain ``dataset_id => modules``.

        ``modules`` may be empty: then only next-module (first-module)
        suggestions are produced.
        """
        self._refresh()
        miner = self.policy.miner
        with_state = self.policy.with_state
        modules = tuple(modules)

        # snapshot miner/policy state under the lock; store liveness probes
        # happen after release (documented lock order: never call store
        # methods while holding the policy lock)
        reuse_cands: list[tuple[PrefixKey, str, int]] = []
        next_cands: list[tuple[PrefixKey, str, int]] = []
        with self.policy.lock:
            ds_support = miner.dataset_support(dataset_id)
            for k in range(len(modules), 0, -1):
                prefix = PrefixKey(dataset_id, modules[:k])
                key = prefix.key(with_state)
                support = miner.support_of_key(key)
                if key in self.policy.stored or support >= 2:
                    reuse_cands.append((prefix, key, support))
            chain_key = (
                PrefixKey(dataset_id, modules).key(with_state) if modules else None
            )
            for cand in self._index.get((dataset_id, len(modules) + 1), ()):
                parent = cand.parent()
                parent_key = parent.key(with_state) if parent is not None else None
                if parent_key != chain_key:
                    continue
                key = cand.key(with_state)
                next_cands.append((cand, key, miner.support_of_key(key)))

        reusable = [
            Suggestion(
                kind="reusable_prefix",
                prefix=prefix,
                support=support,
                dataset_support=ds_support,
                stored=self._is_live(key),
            )
            for prefix, key, support in reuse_cands[:top_k]
        ]
        nxt = [
            Suggestion(
                kind="next_module",
                prefix=cand,
                support=support,
                dataset_support=ds_support,
                stored=self._is_live(key),
                module_id=cand.modules[-1].module_id,
            )
            for cand, key, support in next_cands
        ]
        nxt.sort(key=lambda s: (-s.confidence, -s.support, s.module_id or ""))
        # one suggestion per module id (rules are per tool-state under
        # with_state=True; a frequently re-parameterized module must not
        # crowd every other next-module out of the report) — the kept entry
        # is that module's highest-confidence state
        seen_modules: set[str] = set()
        deduped = []
        for s in nxt:
            if s.module_id in seen_modules:
                continue
            seen_modules.add(s.module_id or "")
            deduped.append(s)
        return RecommendReport(
            dataset_id=dataset_id,
            depth=len(modules),
            reusable_prefixes=reusable,
            next_modules=deduped[:top_k],
            near_misses=self.near_misses(dataset_id, modules, top_k=top_k),
        )

    def near_misses(
        self,
        dataset_id: str,
        modules: Sequence[ModuleRef] = (),
        top_k: int = 5,
    ) -> list[Suggestion]:
        """Stored artifacts one parameter away from the partial chain.

        A *near miss* has the exact module-id chain of ``dataset_id =>
        modules`` but exactly one differing (or extra/missing) parameter
        somewhere along it — the catalog's answer to "someone already ran
        almost this; is their setting the one you meant?".  Served entirely
        from the :class:`~repro_torch.catalog.Catalog` (empty without one), ranked
        by reuse count then recency.  ``dataset_id`` may be namespaced
        (``ns/dataset``); matching is namespace-exact.
        """
        if self.catalog is None or not modules:
            return []
        from ..catalog.records import split_namespaced_dataset

        modules = tuple(modules)
        chain = tuple(m.module_id for m in modules)
        ns, ds = split_namespaced_dataset(dataset_id)
        try:
            records = self.catalog.find(
                module=chain[-1],
                dataset=ds,
                namespace=ns or "",
                limit=max(64, top_k * 8),
            )
        except Exception:  # noqa: BLE001 - advisory surface: degrade to none
            return []

        own_params = [dict(m.state.params) for m in modules]
        hits: list[tuple[tuple, Suggestion]] = []
        for rec in records:
            if rec.modules != chain or rec.depth != len(chain):
                continue
            note = self._one_param_diff(own_params, rec.states, chain)
            if note is None:
                continue
            hits.append(
                (
                    (-rec.n_loads, -rec.last_used_at, rec.key),
                    Suggestion(
                        kind="near_miss",
                        prefix=rec.prefix_key(),
                        support=rec.n_loads,
                        dataset_support=rec.n_loads,
                        stored=True,
                        module_id=chain[-1],
                        note=note,
                    ),
                )
            )
        hits.sort(key=lambda it: it[0])
        return [s for _, s in hits[:top_k]]

    @staticmethod
    def _one_param_diff(
        own: "list[dict[str, str]]",
        theirs: "Sequence[dict[str, str] | Mapping[str, str]]",
        chain: "tuple[str, ...]",
    ) -> str | None:
        """Describe the single differing encoded param, or None if the
        chains differ by zero params (identical — a reuse hit, not a near
        miss) or by more than one."""
        diffs: list[str] = []
        for pos, module_id in enumerate(chain):
            mine = own[pos]
            other = dict(theirs[pos]) if pos < len(theirs) else {}
            for name in sorted(set(mine) | set(other)):
                a, b = mine.get(name), other.get(name)
                if a == b:
                    continue
                if len(diffs) >= 2:
                    return None
                mine_s = repr(decode_param(a)) if a is not None else "unset"
                their_s = repr(decode_param(b)) if b is not None else "unset"
                diffs.append(f"{module_id}.{name}={their_s} (yours {mine_s})")
        return diffs[0] if len(diffs) == 1 else None
