"""DAG workflow model with root-to-node path decomposition.

``W = (D, M, E, ID, O)`` (thesis Ch. 6.3.1): one input dataset ``D``, module
occurrences ``M`` (nodes), dataflow edges ``E``, intermediate data ``ID``
(node outputs), outputs ``O`` (sink-node values).  Rule mining stays
sequential per Ch. 3.3 ("considering only sequential module processing"):
:meth:`DagWorkflow.paths` decomposes the DAG into root-to-sink module chains,
each a plain :class:`~repro.core.workflow.Workflow` the existing policies can
step.

Intermediate-data identity: a node whose ancestry is a *linear chain* (every
ancestor, and the node itself, has at most one parent) has a canonical
:class:`~repro.core.workflow.PrefixKey` — the same identity the sequential
executor uses, so DAG runs and sequential runs share stored artifacts.
Fan-in nodes (and their descendants) depend on more than one root-to-node
path, which the thesis' prefix identity cannot express; their outputs are
computed but not store-addressable.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Mapping, Sequence

from ..core.workflow import ModuleRef, ModuleSpec, PrefixKey, ToolState, Workflow


def kahn_order(parents: Mapping[str, Sequence[str]]) -> tuple[str, ...]:
    """Deterministic topological order over ``node -> parents`` (Kahn's
    algorithm; ties broken by mapping insertion order).  Raises
    ``ValueError`` naming the offending nodes on a cycle.  Shared by
    :class:`DagWorkflow` and ``repro.api.WorkflowSpec``."""
    remaining = {nid: len(ps) for nid, ps in parents.items()}
    children: dict[str, list[str]] = {nid: [] for nid in parents}
    for nid, ps in parents.items():
        for p in ps:
            children[p].append(nid)
    order: list[str] = []
    ready = [nid for nid in parents if remaining[nid] == 0]
    while ready:
        nid = ready.pop(0)
        order.append(nid)
        for c in children[nid]:
            remaining[c] -= 1
            if remaining[c] == 0:
                ready.append(c)
    if len(order) != len(parents):
        cyclic = sorted(nid for nid in parents if nid not in order)
        raise ValueError(f"workflow graph has a cycle through {cyclic}")
    return tuple(order)


@dataclass(frozen=True)
class DagNode:
    """A module occurrence inside a DAG: node id + module ref + fan-in."""

    node_id: str
    ref: ModuleRef
    parents: tuple[str, ...] = ()


class DagWorkflow:
    """Mutable DAG builder; validated/frozen views are computed on demand.

    ``registry`` (optional) resolves ``(module_id, params)`` through
    :meth:`ModuleSpec.ref` so tool-state digests match workflows built by
    ``WorkflowExecutor.make_workflow`` — pass it (or build via
    ``WorkflowService.dag``) whenever DAG runs should share artifacts with
    sequential runs.
    """

    def __init__(
        self,
        dataset_id: str,
        workflow_id: str = "",
        registry: Mapping[str, ModuleSpec] | None = None,
    ) -> None:
        self.dataset_id = dataset_id
        self.workflow_id = workflow_id
        self.registry = registry
        self._nodes: dict[str, DagNode] = {}  # insertion-ordered

    # -- construction --------------------------------------------------------
    def add(
        self,
        node_id: str,
        module: str | ModuleRef,
        params: Mapping[str, Any] | None = None,
        after: str | Sequence[str] | None = None,
    ) -> str:
        """Add one node; ``after`` names its parent(s) (fan-in order matters:
        a multi-parent node's fn receives a tuple of values in this order)."""
        if node_id in self._nodes:
            raise ValueError(f"duplicate node id {node_id!r}")
        if isinstance(module, ModuleRef):
            if params is not None:
                raise ValueError("pass params via the ModuleRef's tool state")
            ref = module
        elif self.registry is not None:
            ref = self.registry[module].ref(params)
        else:
            ref = ModuleRef(module, ToolState.from_config(params))
        if after is None:
            parents: tuple[str, ...] = ()
        elif isinstance(after, str):
            parents = (after,)
        else:
            parents = tuple(after)
        for p in parents:
            if p not in self._nodes:
                raise ValueError(f"node {node_id!r}: unknown parent {p!r}")
        self._nodes[node_id] = DagNode(node_id, ref, parents)
        return node_id

    def chain(
        self,
        steps: Sequence[str | tuple[str, Mapping[str, Any] | None]],
        after: str | None = None,
        prefix: str = "",
    ) -> str:
        """Append a linear chain of steps; returns the last node id."""
        last = after
        for i, step in enumerate(steps):
            mod, params = (step, None) if isinstance(step, str) else step
            nid = f"{prefix}{mod}.{len(self._nodes)}"
            self.add(nid, mod, params, after=last)
            last = nid
        assert last is not None
        return last

    @classmethod
    def from_workflow(
        cls, wf: Workflow, registry: Mapping[str, ModuleSpec] | None = None
    ) -> "DagWorkflow":
        """Lift a sequential Workflow into an equivalent chain DAG."""
        dag = cls(wf.dataset_id, wf.workflow_id, registry)
        last: str | None = None
        for i, ref in enumerate(wf.modules):
            nid = f"{ref.module_id}.{i}"
            dag.add(nid, ref, after=last)
            last = nid
        return dag

    # -- structure -----------------------------------------------------------
    def __len__(self) -> int:
        return len(self._nodes)

    def __contains__(self, node_id: str) -> bool:
        return node_id in self._nodes

    @property
    def nodes(self) -> tuple[str, ...]:
        return tuple(self._nodes)

    def node(self, node_id: str) -> DagNode:
        return self._nodes[node_id]

    def ref(self, node_id: str) -> ModuleRef:
        return self._nodes[node_id].ref

    def parents_of(self, node_id: str) -> tuple[str, ...]:
        return self._nodes[node_id].parents

    def children_of(self, node_id: str) -> tuple[str, ...]:
        return tuple(
            n.node_id for n in self._nodes.values() if node_id in n.parents
        )

    def roots(self) -> tuple[str, ...]:
        return tuple(n.node_id for n in self._nodes.values() if not n.parents)

    def sinks(self) -> tuple[str, ...]:
        with_children = {p for n in self._nodes.values() for p in n.parents}
        return tuple(nid for nid in self._nodes if nid not in with_children)

    def validate(self) -> None:
        if not self._nodes:
            raise ValueError("a DAG workflow needs at least one node")
        self.topo_order()  # raises on cycles (unreachable via add(), but
        # guards DAGs deserialized or mutated through the internals)

    def topo_order(self) -> tuple[str, ...]:
        """Deterministic topological order (Kahn; ties broken by insertion)."""
        return kahn_order({nid: n.parents for nid, n in self._nodes.items()})

    # -- identity / decomposition -------------------------------------------
    def chain_nodes(self, node_id: str) -> tuple[str, ...] | None:
        """Root-to-node chain of node ids when the ancestry is linear, else
        None (the node or an ancestor has fan-in)."""
        chain: list[str] = []
        cur: str | None = node_id
        while cur is not None:
            parents = self._nodes[cur].parents
            if len(parents) > 1:
                return None
            chain.append(cur)
            cur = parents[0] if parents else None
        return tuple(reversed(chain))

    def chain_prefix(self, node_id: str) -> PrefixKey | None:
        """The node's canonical intermediate-data identity (linear ancestry
        only) — the same PrefixKey a sequential run of the chain produces."""
        chain = self.chain_nodes(node_id)
        if chain is None:
            return None
        return PrefixKey(self.dataset_id, tuple(self._nodes[n].ref for n in chain))

    def paths(self, max_paths: int = 64) -> list[Workflow]:
        """Root-to-sink decomposition: one sequential Workflow per path.

        Fan-in multiplies paths; enumeration is capped at ``max_paths``
        (deterministically, following declared parent order) so adversarial
        diamond stacks cannot blow up rule mining.
        """
        out: list[Workflow] = []

        def walk(node_id: str, suffix: tuple[str, ...]) -> None:
            if len(out) >= max_paths:
                return
            path = (node_id,) + suffix
            parents = self._nodes[node_id].parents
            if not parents:
                refs = tuple(self._nodes[n].ref for n in path)
                wid = self.workflow_id or "dag"
                out.append(Workflow(self.dataset_id, refs, f"{wid}:p{len(out)}"))
                return
            for p in parents:
                walk(p, path)

        for sink in self.sinks():
            walk(sink, ())
        return out

    def module_keys(self, with_state: bool = True) -> list[str]:
        """Topo-ordered module keys (provenance record field)."""
        return [self._nodes[n].ref.key(with_state) for n in self.topo_order()]
