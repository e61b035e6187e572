"""Catalog record + query documents.

A :class:`CatalogRecord` is the *queryable* description of one stored
artifact: where the store itself only answers exact ``PrefixKey`` lookups,
the catalog knows the artifact's module chain, each module's decoded
tool-state parameters, its dataset and namespace, and the cost/size/reuse
statistics that rank it.  Records are plain JSON documents so they travel
over the ``repro.net`` wire (the ``catalog_*`` op family) and persist as
``catalog.json`` beside ``index.json``.

Parameter values are kept in their **canonical encoded** form (the same
invertible :func:`repro.core.workflow.encode_param` rendering the
``ToolState`` identity uses).  Matching a user query therefore reduces to
string equality after encoding the query value — exactly the equality that
defines tool-state identity, so ``find(params={"k": 31})`` matches precisely
the artifacts whose store keys embed ``k=31``, typed (``31 != "31"``).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Mapping, Sequence

from ..core.workflow import ModuleRef, PrefixKey, ToolState, encode_param


def split_namespaced_dataset(dataset_id: str) -> tuple[str, str]:
    """Split a composed ``<namespace>/<dataset>`` identity (the inverse of
    :func:`repro.api.spec.namespaced_dataset`).  Legacy un-namespaced ids
    come back as ``("", dataset_id)``.  ``"/"`` is reserved as the separator,
    so only the first one splits."""
    if "/" in dataset_id:
        ns, ds = dataset_id.split("/", 1)
        return ns, ds
    return "", dataset_id


@dataclass
class CatalogRecord:
    """One stored artifact, as the catalog sees it.

    ``modules`` is the module-id chain root→terminal; ``states`` carries the
    *encoded* parameter mapping of each module at the same position.  The
    terminal module (``modules[-1]``) is the one that produced the artifact.
    """

    key: str  # the store key (PrefixKey rendering) — the catalog's identity
    namespace: str
    dataset: str  # bare dataset id (namespace stripped)
    modules: tuple[str, ...]
    states: tuple[Mapping[str, str], ...]  # encoded params per chain position
    nbytes: int = 0
    compute_s: float | None = None
    created_at: float = field(default_factory=time.time)
    last_used_at: float = 0.0
    n_loads: int = 0

    def __post_init__(self) -> None:
        self.modules = tuple(self.modules)
        self.states = tuple(dict(s) for s in self.states)
        if len(self.modules) != len(self.states):
            raise ValueError(
                f"chain of {len(self.modules)} modules with "
                f"{len(self.states)} states"
            )
        if not self.last_used_at:
            self.last_used_at = self.created_at

    # -- derived --------------------------------------------------------------
    @property
    def depth(self) -> int:
        return len(self.modules)

    @property
    def module(self) -> str:
        """The terminal module — the one whose output this artifact is."""
        return self.modules[-1]

    @property
    def dataset_id(self) -> str:
        """The composed dataset identity every ``PrefixKey`` uses."""
        return f"{self.namespace}/{self.dataset}" if self.namespace else self.dataset

    def params(self, position: int = -1) -> dict[str, Any]:
        """Decoded parameter mapping of one chain position (default:
        terminal module)."""
        state = ToolState(tuple(sorted(self.states[position].items())))
        return state.to_config()

    def prefix_key(self) -> PrefixKey:
        """Reconstruct the artifact's :class:`PrefixKey` (tool states
        included) — what a reuse probe or recommender suggestion needs."""
        refs = tuple(
            ModuleRef(m, ToolState(tuple(sorted(s.items()))))
            for m, s in zip(self.modules, self.states)
        )
        return PrefixKey(self.dataset_id, refs)

    # -- documents -------------------------------------------------------------
    def to_doc(self) -> dict[str, Any]:
        return {
            "key": self.key,
            "namespace": self.namespace,
            "dataset": self.dataset,
            "modules": list(self.modules),
            "states": [dict(s) for s in self.states],
            "nbytes": int(self.nbytes),
            "compute_s": self.compute_s,
            "created_at": self.created_at,
            "last_used_at": self.last_used_at,
            "n_loads": int(self.n_loads),
        }

    @classmethod
    def from_doc(cls, doc: Mapping[str, Any]) -> "CatalogRecord":
        return cls(
            key=str(doc["key"]),
            namespace=str(doc.get("namespace", "")),
            dataset=str(doc.get("dataset", "")),
            modules=tuple(str(m) for m in doc.get("modules", ())),
            states=tuple(
                {str(k): str(v) for k, v in s.items()} for s in doc.get("states", ())
            ),
            nbytes=int(doc.get("nbytes", 0) or 0),
            compute_s=doc.get("compute_s"),
            created_at=float(doc.get("created_at", 0.0) or 0.0),
            last_used_at=float(doc.get("last_used_at", 0.0) or 0.0),
            n_loads=int(doc.get("n_loads", 0) or 0),
        )


def record_for_prefix(
    prefix: PrefixKey,
    key: str,
    *,
    nbytes: int = 0,
    compute_s: float | None = None,
    created_at: float | None = None,
    last_used_at: float = 0.0,
    n_loads: int = 0,
) -> CatalogRecord:
    """Build the catalog record for one admitted artifact.  Called at the
    admission seam (``admit_and_store``), the only place that still holds the
    structured :class:`PrefixKey` the flat store key was rendered from."""
    namespace, dataset = split_namespaced_dataset(prefix.dataset_id)
    return CatalogRecord(
        key=key,
        namespace=namespace,
        dataset=dataset,
        modules=tuple(m.module_id for m in prefix.modules),
        states=tuple(dict(m.state.params) for m in prefix.modules),
        nbytes=nbytes,
        compute_s=compute_s,
        created_at=created_at if created_at is not None else time.time(),
        last_used_at=last_used_at,
        n_loads=n_loads,
    )


@dataclass
class CatalogQuery:
    """One find-by-statepoint query (signac's ``find(filter)``, specialized
    to the workflow data model).

    ``params`` values are **encoded** (see module docstring); build queries
    from user values with :meth:`build`.  ``module=None`` matches any module;
    ``any_position=True`` matches artifacts whose chain *contains* the module
    (with its params at that position) instead of only artifacts the module
    itself produced.  ``namespace=None`` means "any namespace" — the gateway
    never passes None (tenant scoping resolves a concrete namespace first).
    """

    module: str | None = None
    params: dict[str, str] = field(default_factory=dict)
    dataset: str | None = None
    namespace: str | None = None
    any_position: bool = False
    limit: int = 50

    @classmethod
    def build(
        cls,
        module: str | None = None,
        params: Mapping[str, Any] | None = None,
        dataset: str | None = None,
        namespace: str | None = None,
        any_position: bool = False,
        limit: int = 50,
    ) -> "CatalogQuery":
        if params and module is None:
            raise ValueError("a params filter needs a module to anchor it")
        return cls(
            module=module,
            params={str(k): encode_param(v) for k, v in (params or {}).items()},
            dataset=dataset,
            namespace=namespace,
            any_position=any_position,
            limit=max(1, int(limit)),
        )

    def to_doc(self) -> dict[str, Any]:
        return {
            "module": self.module,
            "params": dict(self.params),
            "dataset": self.dataset,
            "namespace": self.namespace,
            "any_position": self.any_position,
            "limit": self.limit,
        }

    @classmethod
    def from_doc(cls, doc: Mapping[str, Any]) -> "CatalogQuery":
        return cls(
            module=doc.get("module"),
            params={str(k): str(v) for k, v in (doc.get("params") or {}).items()},
            dataset=doc.get("dataset"),
            namespace=doc.get("namespace"),
            any_position=bool(doc.get("any_position", False)),
            limit=max(1, int(doc.get("limit", 50) or 50)),
        )

    # -- matching ---------------------------------------------------------------
    def _position_matches(self, rec: CatalogRecord, i: int) -> bool:
        if rec.modules[i] != self.module:
            return False
        state = rec.states[i]
        return all(state.get(k) == v for k, v in self.params.items())

    def matches(self, rec: CatalogRecord) -> bool:
        """Exact predicate — postings in :class:`CatalogIndex` are only a
        pre-filter (loose for repeated module ids); this decides."""
        if self.namespace is not None and rec.namespace != self.namespace:
            return False
        if self.dataset is not None and rec.dataset != self.dataset:
            return False
        if self.module is None:
            return True
        if self.any_position:
            return any(self._position_matches(rec, i) for i in range(rec.depth))
        return self._position_matches(rec, rec.depth - 1)


def rank_key(rec: CatalogRecord) -> tuple:
    """Ranking: most-reused first, then deepest (a deeper reusable prefix
    skips more work), then most recently touched; key breaks ties so the
    order is deterministic across processes."""
    return (-rec.n_loads, -rec.depth, -rec.last_used_at, rec.key)
