"""``repro_torch.api`` — the unified, declarative front door.

Three pillars (the thesis's Ch. 4 recommendation technique made
public):

  * :class:`ModuleRegistry` — one module universe shared by every engine
    (sequential executor, DAG scheduler/service, serving engine), with a
    ``@registry.module(...)`` decorator, default params, and tool-state
    validation;
  * :class:`WorkflowSpec` — a declarative, JSON-round-trippable workflow
    document (chains and fan-in/fan-out DAGs, per-node tool states, Galaxy
    ``.ga`` import) whose resolved ``PrefixKey``s are identical across
    processes — the portable unit of workflow sharing;
  * :class:`Client` — store + policy + eviction + both engines in one
    constructor: ``run``/``submit``/``stats``/``recommend``/``replay``.

Quickstart::

    from repro_torch.api import Client, WorkflowSpec

    client = Client("/tmp/artifacts", policy="PT", with_state=True)

    @client.module("normalize")
    def normalize(x): ...

    spec = WorkflowSpec.from_steps("sensor-A", ["normalize", ...])
    result = client.run(spec, data)
    print(client.recommend(spec).best_next)

Migration from the legacy front doors is documented in ``docs/api.md``;
``WorkflowExecutor`` and ``WorkflowService`` remain supported shims over the
same machinery.
"""
from ..core.registry import ModuleRegistry, ToolStateError, UnknownModuleError
from .client import Client
from .recommend import RecommendReport, Recommender, Suggestion
from .spec import NodeSpec, SpecError, WorkflowSpec

__all__ = [
    "Client",
    "ModuleRegistry",
    "NodeSpec",
    "RecommendReport",
    "Recommender",
    "SpecError",
    "Suggestion",
    "ToolStateError",
    "UnknownModuleError",
    "WorkflowSpec",
]
