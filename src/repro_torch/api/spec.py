"""Declarative, JSON-round-trippable workflow documents.

A :class:`WorkflowSpec` is the portable description of a workflow — linear
chain or fan-in/fan-out DAG — that the ``repro_torch.api.Client`` accepts on every
entry point.  It addresses the reusability blocker the Galaxy case study
(arXiv:2309.07291) identifies: workflows that exist only as in-memory object
graphs cannot be shared, versioned, or re-run elsewhere.  The design rules:

  * **Serializable** — ``to_json``/``from_json`` round-trip the document
    exactly, including per-node tool states (params go through the canonical
    invertible encoder from ``repro_torch.core.workflow``, so tuples stay tuples
    and floats keep full precision).
  * **Store-key compatible** — resolving a spec against a
    :class:`~repro_torch.core.registry.ModuleRegistry` yields the same
    ``PrefixKey`` identities in every process, so intermediate data stored
    by one process is reused by another that parsed the same document.
  * **Canonically digested** — :attr:`digest` hashes a normalized rendering
    (nodes sorted by id, presentational fields excluded) via ``_stable_hash``;
    serialization never changes it.

``from_galaxy`` imports Galaxy's native ``.ga`` workflow JSON (the corpus
format the source thesis mined).
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, Iterator, Mapping, Sequence

from ..core.registry import ModuleRegistry
from ..core.workflow import (
    ModuleRef,
    ToolState,
    Workflow,
    _stable_hash,
    decode_param,
)
from ..sched.dag import DagWorkflow, kahn_order

SCHEMA_KIND = "repro.workflow_spec"
SCHEMA_VERSION = 1

# characters a namespace may use; "/" is reserved as the namespace/dataset
# separator inside composed dataset ids, ":" only for the "tenant:<name>"
# convention the gateway uses
_NAMESPACE_OK = frozenset(
    "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_.:-"
)


class SpecError(ValueError):
    """The workflow document is structurally invalid (cycle, duplicate node,
    unknown parent/module, empty graph)."""


def check_namespace(namespace: str) -> str:
    """Validate a namespace label (``""`` — the legacy un-namespaced world —
    is allowed and returned as-is)."""
    if namespace and not set(namespace) <= _NAMESPACE_OK:
        raise SpecError(
            f"invalid namespace {namespace!r}: allowed characters are "
            "letters, digits, '_', '.', ':', '-'"
        )
    return namespace


def namespaced_dataset(namespace: str, dataset_id: str) -> str:
    """The dataset identity every ``PrefixKey`` of a namespaced workflow is
    derived from: ``<namespace>/<dataset_id>`` (or plain ``dataset_id`` when
    un-namespaced).  Two tenants submitting the same document into the same
    namespace therefore share store keys — and into different namespaces,
    never do."""
    check_namespace(namespace)
    return f"{namespace}/{dataset_id}" if namespace else dataset_id


@dataclass(frozen=True)
class NodeSpec:
    """One module occurrence: id + module + tool-state params + parents.

    ``after`` order matters for fan-in nodes — the module function receives a
    tuple of parent values in this order.
    """

    node_id: str
    module_id: str
    params: ToolState = field(default_factory=ToolState)
    after: tuple[str, ...] = ()

    def config(self) -> dict[str, Any]:
        """The decoded parameter mapping (may be empty)."""
        return self.params.to_config()


def _as_state(params: Mapping[str, Any] | ToolState | None) -> ToolState:
    if isinstance(params, ToolState):
        # normalize: a ToolState carried over from a legacy (repr-encoded)
        # workflow re-canonicalizes here, so the document always serializes
        # canonical encodings and its digest survives JSON round trips
        if not params.params:
            return params
        return ToolState.from_config(params.to_config())
    return ToolState.from_config(params)


class WorkflowSpec:
    """Mutable builder + serializable document for one workflow.

    Build programmatically::

        spec = WorkflowSpec("survey2026", workflow_id="report")
        spec.add("norm", "normalize")
        spec.add("q10", "analyze", {"q": 10}, after="norm")
        spec.add("q90", "analyze", {"q": 90}, after="norm")
        spec.add("sum", "merge", after=("q10", "q90"))

    or declaratively: ``WorkflowSpec.from_json(text)``,
    ``WorkflowSpec.from_steps("ds", ["normalize", ("analyze", {"q": 10})])``,
    ``WorkflowSpec.from_galaxy(ga_doc)``.

    Unlike ``DagWorkflow.add``, ``add`` tolerates forward references to
    parents (documents may list nodes in any order); :meth:`validate` checks
    the full structure.
    """

    def __init__(
        self,
        dataset_id: str,
        workflow_id: str = "",
        nodes: Sequence[NodeSpec] = (),
        namespace: str = "",
    ) -> None:
        if not dataset_id:
            raise SpecError("a workflow spec needs a dataset_id")
        self.dataset_id = dataset_id
        self.workflow_id = workflow_id
        self.namespace = check_namespace(namespace)
        self._nodes: dict[str, NodeSpec] = {}
        for n in nodes:
            self._add_node(n)

    @property
    def effective_dataset_id(self) -> str:
        """Dataset identity after namespace composition — what every engine
        view (and therefore every ``PrefixKey``) is built from."""
        return namespaced_dataset(self.namespace, self.dataset_id)

    def with_namespace(self, namespace: str) -> "WorkflowSpec":
        """A copy of this spec rebound to ``namespace`` (nodes shared — they
        are immutable).  The gateway uses this to pin every submission to its
        tenant's private namespace or the opt-in shared one."""
        return WorkflowSpec(
            self.dataset_id, self.workflow_id, self.nodes, namespace=namespace
        )

    # -- construction --------------------------------------------------------
    def _add_node(self, node: NodeSpec) -> None:
        if node.node_id in self._nodes:
            raise SpecError(f"duplicate node id {node.node_id!r}")
        self._nodes[node.node_id] = node

    def add(
        self,
        node_id: str,
        module_id: str,
        params: Mapping[str, Any] | ToolState | None = None,
        after: str | Sequence[str] | None = None,
    ) -> str:
        if after is None:
            parents: tuple[str, ...] = ()
        elif isinstance(after, str):
            parents = (after,)
        else:
            parents = tuple(after)
        self._add_node(NodeSpec(node_id, module_id, _as_state(params), parents))
        return node_id

    def chain(
        self,
        steps: Sequence[str | tuple[str, Mapping[str, Any] | None]],
        after: str | None = None,
    ) -> str | None:
        """Append a linear chain of ``steps``; returns the last node id."""
        last = after
        for step in steps:
            mod, params = (step, None) if isinstance(step, str) else step
            nid = f"{mod}.{len(self._nodes)}"
            self.add(nid, mod, params, after=last)
            last = nid
        return last

    @classmethod
    def from_steps(
        cls,
        dataset_id: str,
        steps: Sequence[str | tuple[str, Mapping[str, Any] | None]],
        workflow_id: str = "",
    ) -> "WorkflowSpec":
        """Linear-pipeline shorthand (mirrors ``WorkflowExecutor.run`` steps)."""
        spec = cls(dataset_id, workflow_id)
        spec.chain(steps)
        return spec

    @classmethod
    def from_workflow(cls, wf: Workflow) -> "WorkflowSpec":
        """Lift an in-memory sequential :class:`Workflow` into a document."""
        spec = cls(wf.dataset_id, wf.workflow_id)
        last: str | None = None
        for i, ref in enumerate(wf.modules):
            nid = f"{ref.module_id}.{i}"
            spec.add(nid, ref.module_id, ref.state, after=last)
            last = nid
        return spec

    @classmethod
    def from_dag(cls, dag: DagWorkflow) -> "WorkflowSpec":
        """Lift an in-memory :class:`DagWorkflow` into a document."""
        spec = cls(dag.dataset_id, dag.workflow_id)
        for nid in dag.nodes:
            node = dag.node(nid)
            spec.add(nid, node.ref.module_id, node.ref.state, after=node.parents)
        return spec

    # -- structure -----------------------------------------------------------
    def __len__(self) -> int:
        return len(self._nodes)

    def __contains__(self, node_id: str) -> bool:
        return node_id in self._nodes

    def __iter__(self) -> Iterator[NodeSpec]:
        return iter(self._nodes.values())

    @property
    def nodes(self) -> tuple[NodeSpec, ...]:
        return tuple(self._nodes.values())

    def node(self, node_id: str) -> NodeSpec:
        return self._nodes[node_id]

    def roots(self) -> tuple[str, ...]:
        return tuple(n.node_id for n in self._nodes.values() if not n.after)

    def sinks(self) -> tuple[str, ...]:
        with_children = {p for n in self._nodes.values() for p in n.after}
        return tuple(nid for nid in self._nodes if nid not in with_children)

    def topo_order(self) -> tuple[str, ...]:
        """Deterministic topological order (Kahn; ties broken by declaration
        order).  Raises :class:`SpecError` on cycles or unknown parents."""
        for n in self._nodes.values():
            for p in n.after:
                if p not in self._nodes:
                    raise SpecError(
                        f"node {n.node_id!r}: unknown parent {p!r}"
                    )
        try:
            return kahn_order({nid: n.after for nid, n in self._nodes.items()})
        except ValueError as e:
            raise SpecError(str(e).replace("graph", "spec")) from None

    @property
    def is_linear(self) -> bool:
        """True when the spec is a single chain (one root, every node with at
        most one parent and one child) — the executor-compatible shape."""
        if not self._nodes:
            return False
        if len(self.roots()) != 1:
            return False
        child_count: dict[str, int] = {nid: 0 for nid in self._nodes}
        for n in self._nodes.values():
            if len(n.after) > 1:
                return False
            for p in n.after:
                child_count[p] += 1
        return all(c <= 1 for c in child_count.values())

    def validate(self, registry: ModuleRegistry | None = None) -> None:
        """Structural checks (non-empty, parents resolve, acyclic), plus —
        when a registry is given — unknown-module and tool-state validation."""
        if not self._nodes:
            raise SpecError("a workflow spec needs at least one node")
        self.topo_order()
        if registry is not None:
            for n in self._nodes.values():
                if n.module_id not in registry:
                    known = ", ".join(sorted(registry)[:8]) or "<none>"
                    raise SpecError(
                        f"node {n.node_id!r} references unknown module "
                        f"{n.module_id!r}; registered modules: {known}"
                    )
                registry.validate_state(n.module_id, n.config())

    # -- identity ------------------------------------------------------------
    def canonical(self) -> dict[str, Any]:
        """Normalized rendering for digesting: nodes sorted by id, parent
        *order* preserved (fan-in order is semantic), presentational fields
        (``workflow_id``, document key order) excluded.  The namespace is
        part of the identity when set (the same document in two namespaces
        names two disjoint artifact families); un-namespaced specs keep their
        pre-namespace digests."""
        doc: dict[str, Any] = {
            "version": SCHEMA_VERSION,
            "dataset_id": self.dataset_id,
            "nodes": [
                [n.node_id, n.module_id, list(map(list, n.params.params)), list(n.after)]
                for n in sorted(self._nodes.values(), key=lambda n: n.node_id)
            ],
        }
        if self.namespace:
            doc["namespace"] = self.namespace
        return doc

    @property
    def digest(self) -> str:
        """Canonical content digest, stable across processes and across
        serialize/deserialize round-trips (built on ``_stable_hash``)."""
        return _stable_hash(self.canonical())

    # -- engine views ---------------------------------------------------------
    def _resolve_ref(
        self, node: NodeSpec, registry: ModuleRegistry | None
    ) -> ModuleRef:
        # registry resolution merges registered defaults into the tool state,
        # matching what make_workflow/DagWorkflow.add produce — REQUIRED for
        # PrefixKey compatibility with runs built through the engines.  An
        # unregistered module resolves raw (lenient callers only; strict
        # validation has already rejected it otherwise), so known modules
        # still mine engine-identical keys.
        if registry is None or node.module_id not in registry:
            return ModuleRef(node.module_id, node.params)
        return registry[node.module_id].ref(node.config() or None)

    def to_workflow(
        self, registry: ModuleRegistry | None = None, *, strict: bool = True
    ) -> Workflow:
        """Sequential-engine view; requires :attr:`is_linear`.

        ``strict=False`` skips registry validation (structure is always
        checked) and resolves unregistered modules raw — for observe/
        recommend flows over historical corpora whose tools are not all
        registered locally."""
        self.validate(registry if strict else None)
        if not self.is_linear:
            raise SpecError(
                "spec is not a linear chain; use to_dag() / Client.submit()"
            )
        refs = tuple(
            self._resolve_ref(self._nodes[nid], registry)
            for nid in self.topo_order()
        )
        return Workflow(self.effective_dataset_id, refs, self.workflow_id)

    def to_dag(
        self, registry: ModuleRegistry | None = None, *, strict: bool = True
    ) -> DagWorkflow:
        """Scheduler view (works for chains and DAGs alike).  ``strict`` as
        in :meth:`to_workflow`."""
        self.validate(registry if strict else None)
        dag = DagWorkflow(self.effective_dataset_id, self.workflow_id, registry=None)
        for nid in self.topo_order():
            node = self._nodes[nid]
            dag.add(
                nid,
                self._resolve_ref(node, registry),
                after=node.after or None,
            )
        return dag

    def prefix_keys(
        self, registry: ModuleRegistry | None = None, with_state: bool = True
    ) -> list[str]:
        """Store keys of every linear-ancestry node — the intermediate-data
        identities a run of this spec can share with other processes."""
        dag = self.to_dag(registry)
        out = []
        for nid in dag.topo_order():
            prefix = dag.chain_prefix(nid)
            if prefix is not None:
                out.append(prefix.key(with_state))
        return out

    # -- serialization ---------------------------------------------------------
    def to_dict(self) -> dict[str, Any]:
        doc: dict[str, Any] = {
            "kind": SCHEMA_KIND,
            "version": SCHEMA_VERSION,
            "dataset_id": self.dataset_id,
            "workflow_id": self.workflow_id,
            "nodes": [
                {
                    "id": n.node_id,
                    "module": n.module_id,
                    # params are already canonically encoded strings — emit
                    # them verbatim so the document round-trips bit-exactly
                    "params": {k: v for k, v in n.params.params} or None,
                    "after": list(n.after),
                }
                for n in self._nodes.values()
            ],
        }
        if self.namespace:
            doc["namespace"] = self.namespace
        return doc

    @classmethod
    def from_dict(cls, doc: Mapping[str, Any]) -> "WorkflowSpec":
        kind = doc.get("kind", SCHEMA_KIND)
        if kind != SCHEMA_KIND:
            raise SpecError(f"not a workflow spec document (kind={kind!r})")
        version = int(doc.get("version", SCHEMA_VERSION))
        if version > SCHEMA_VERSION:
            raise SpecError(
                f"workflow spec version {version} is newer than supported "
                f"({SCHEMA_VERSION})"
            )
        if "dataset_id" not in doc:
            raise SpecError("workflow spec document missing 'dataset_id'")
        spec = cls(
            doc["dataset_id"],
            doc.get("workflow_id", ""),
            namespace=str(doc.get("namespace") or ""),
        )
        for nd in doc.get("nodes", ()):
            missing = [f for f in ("id", "module") if f not in nd]
            if missing:
                raise SpecError(f"workflow spec node missing field(s) {missing}")
            raw = nd.get("params") or {}
            # normalize to the canonical encoding so equal specs digest
            # equally however they were authored: string values are treated
            # as canonical/legacy *encodings* (to_json emits those; a literal
            # string is its JSON-quoted form, e.g. "\"fast\""), while plain
            # JSON values (numbers, bools, lists, objects) are taken as-is
            state = ToolState.from_config(
                {
                    str(k): decode_param(v) if isinstance(v, str) else v
                    for k, v in raw.items()
                }
            )
            spec._add_node(
                NodeSpec(
                    nd["id"],
                    nd["module"],
                    state,
                    tuple(nd.get("after") or ()),
                )
            )
        return spec

    def to_json(self, indent: int | None = None) -> str:
        return json.dumps(self.to_dict(), indent=indent)

    @classmethod
    def from_json(cls, text: str) -> "WorkflowSpec":
        try:
            doc = json.loads(text)
        except ValueError as e:
            raise SpecError(f"invalid workflow spec JSON: {e}") from e
        if not isinstance(doc, Mapping):
            raise SpecError("workflow spec JSON must be an object")
        return cls.from_dict(doc)

    # -- Galaxy import ---------------------------------------------------------
    @classmethod
    def from_galaxy(
        cls,
        doc: Mapping[str, Any] | str,
        dataset_id: str | None = None,
        simplify_tool_ids: bool = True,
    ) -> "WorkflowSpec":
        """Import a Galaxy ``.ga`` workflow document (the format the source
        thesis mined 508 of).

        ``data_input``/``data_collection_input`` steps become the workflow's
        input dataset (``dataset_id`` defaults to the first input's label,
        else the workflow name); each tool step becomes one node whose
        parents follow ``input_connections``.  ``tool_state`` params are
        kept, minus Galaxy's ``__``-prefixed internals; full toolshed ids
        are shortened to the tool's short name when ``simplify_tool_ids``.
        """
        if isinstance(doc, str):
            try:
                doc = json.loads(doc)
            except ValueError as e:
                raise SpecError(f"invalid Galaxy workflow JSON: {e}") from e
        steps = doc.get("steps")
        if not isinstance(steps, Mapping) or not steps:
            raise SpecError("Galaxy document has no steps")

        def _step_key(item: tuple[str, Any]) -> int:
            try:
                return int(item[1].get("id", item[0]))
            except (TypeError, ValueError):
                return 0

        ordered = [s for _, s in sorted(steps.items(), key=_step_key)]
        input_types = ("data_input", "data_collection_input", "parameter_input")
        inputs = {
            str(s.get("id")): s
            for s in ordered
            if s.get("type") in input_types or s.get("tool_id") in (None, "")
        }
        if dataset_id is None:
            for s in inputs.values():
                label = s.get("label") or s.get("name")
                if label:
                    dataset_id = str(label)
                    break
        dataset_id = dataset_id or str(doc.get("name") or "galaxy-input")
        spec = cls(dataset_id, workflow_id=str(doc.get("name") or ""))

        def _module_id(tool_id: str) -> str:
            if simplify_tool_ids and "/" in tool_id:
                parts = [p for p in tool_id.split("/") if p]
                # toolshed ids end in .../<short_name>/<version>
                return parts[-2] if len(parts) >= 2 else parts[-1]
            return tool_id

        for s in ordered:
            sid = str(s.get("id"))
            if sid in inputs:
                continue
            tool_id = s.get("tool_id") or s.get("name") or f"step{sid}"
            params: dict[str, Any] = {}
            raw_state = s.get("tool_state")
            if isinstance(raw_state, str):
                try:
                    raw_state = json.loads(raw_state)
                except ValueError:
                    raw_state = {}
            if isinstance(raw_state, Mapping):
                params = {
                    k: v
                    for k, v in raw_state.items()
                    if not str(k).startswith("__")
                }
            parents: list[str] = []
            conns = s.get("input_connections") or {}
            for conn in conns.values():
                entries = conn if isinstance(conn, list) else [conn]
                for entry in entries:
                    if not isinstance(entry, Mapping):
                        continue
                    pid = str(entry.get("id"))
                    if pid in inputs or pid in parents:
                        continue  # dataset inputs make the node a root
                    parents.append(pid)
            label = s.get("label")
            node_id = str(label) if label else sid
            spec.add(node_id, _module_id(str(tool_id)), params or None, parents or None)

        # Galaxy connections reference numeric step ids; relabel parents that
        # point at steps we renamed via labels
        id_to_node = {
            str(s.get("id")): (str(s.get("label")) if s.get("label") else str(s.get("id")))
            for s in ordered
            if str(s.get("id")) not in inputs
        }
        renamed: dict[str, NodeSpec] = {}
        for n in spec._nodes.values():
            renamed[n.node_id] = NodeSpec(
                n.node_id,
                n.module_id,
                n.params,
                tuple(id_to_node.get(p, p) for p in n.after),
            )
        spec._nodes = renamed
        spec.validate()
        return spec

    def __repr__(self) -> str:
        return (
            f"WorkflowSpec(dataset_id={self.dataset_id!r}, "
            f"workflow_id={self.workflow_id!r}, nodes={len(self)}, "
            f"digest={self.digest})"
        )
