"""Shared module registry: one source of truth for executable modules.

Before this existed, every front door (``WorkflowExecutor``, ``DagScheduler``
via ``WorkflowService``, and ad-hoc dicts in examples) kept its own
``dict[str, ModuleSpec]`` with duplicated ``register``/``register_fn``
bookkeeping — a module registered on the service was invisible to a
standalone executor sharing the same store, so their runs silently diverged.
:class:`ModuleRegistry` is the single registry all engines consume (it is a
``MutableMapping``, so any code written against the plain dict keeps
working), plus the declarative conveniences the ``repro.api`` facade builds
on: a ``@registry.module(...)`` decorator, default-parameter merging, and
tool-state validation against the module's call signature.
"""
from __future__ import annotations

import inspect
from typing import Any, Callable, Iterable, Iterator, Mapping, MutableMapping

from .workflow import ModuleRef, ModuleSpec, ToolState


class UnknownModuleError(KeyError):
    """A workflow references a module id nobody registered."""

    def __str__(self) -> str:  # KeyError quotes its arg; keep the message flat
        return self.args[0] if self.args else ""


class ToolStateError(ValueError):
    """A tool state names parameters the module's function cannot accept."""


class ModuleRegistry(MutableMapping[str, ModuleSpec]):
    """Mapping of ``module_id -> ModuleSpec`` shared by every engine.

    Construction accepts nothing, an iterable of specs, or an existing
    ``dict`` — a plain dict is adopted *by reference*, so legacy code that
    still mutates the raw dict stays in sync with engines holding the
    registry.
    """

    def __init__(
        self,
        specs: Mapping[str, ModuleSpec] | Iterable[ModuleSpec] | None = None,
    ) -> None:
        if specs is None:
            self._specs: dict[str, ModuleSpec] = {}
        elif isinstance(specs, ModuleRegistry):
            self._specs = specs._specs  # share, don't copy: one source of truth
        elif isinstance(specs, dict):
            self._specs = specs  # adopt by reference (legacy shared-dict setups)
        elif isinstance(specs, Mapping):
            self._specs = dict(specs)
        else:
            self._specs = {s.module_id: s for s in specs}

    # -- mapping protocol ----------------------------------------------------
    def __getitem__(self, module_id: str) -> ModuleSpec:
        try:
            return self._specs[module_id]
        except KeyError:
            known = ", ".join(sorted(self._specs)[:8]) or "<none>"
            raise UnknownModuleError(
                f"unknown module {module_id!r}; registered modules: {known}"
                + ("..." if len(self._specs) > 8 else "")
            ) from None

    def __setitem__(self, module_id: str, spec: ModuleSpec) -> None:
        if not isinstance(spec, ModuleSpec):
            raise TypeError(f"expected ModuleSpec, got {type(spec).__name__}")
        if spec.module_id != module_id:
            raise ValueError(
                f"key {module_id!r} does not match spec.module_id {spec.module_id!r}"
            )
        self._specs[module_id] = spec

    def __delitem__(self, module_id: str) -> None:
        del self._specs[module_id]

    def __iter__(self) -> Iterator[str]:
        return iter(self._specs)

    def __len__(self) -> int:
        return len(self._specs)

    def __repr__(self) -> str:
        return f"ModuleRegistry({sorted(self._specs)})"

    # -- registration ----------------------------------------------------------
    def register(self, spec: ModuleSpec) -> ModuleSpec:
        self[spec.module_id] = spec
        return spec

    def register_fn(
        self,
        module_id: str,
        fn: Callable[..., Any],
        cost_hint: float | None = None,
        **default_params: Any,
    ) -> ModuleSpec:
        return self.register(
            ModuleSpec(module_id, fn, dict(default_params), cost_hint)
        )

    def module(
        self,
        module_id: str | None = None,
        *,
        cost_hint: float | None = None,
        **default_params: Any,
    ) -> Callable[[Callable[..., Any]], Callable[..., Any]]:
        """Decorator registration::

            @registry.module("normalize")
            def normalize(x, eps=1e-6): ...

            @registry.module()          # id defaults to the function name
            def featurize(x): ...

        The decorated function is returned unchanged (it stays directly
        callable); defaults passed to the decorator become the module's
        default tool state.
        """

        def deco(fn: Callable[..., Any]) -> Callable[..., Any]:
            mid = module_id or fn.__name__
            self.register_fn(mid, fn, cost_hint=cost_hint, **default_params)
            return fn

        return deco

    def ensure(
        self,
        module_id: str,
        fn: Callable[..., Any] | None = None,
        cost_hint: float | None = None,
        **default_params: Any,
    ) -> ModuleSpec:
        """Register ``module_id`` if absent; return its spec either way.

        Used by engines that synthesize module occurrences from observed
        work units (the serving engine's prompt chunks): ``fn=None`` records
        a non-executable placeholder so the module universe is introspectable
        without pretending the unit can be re-run by a workflow engine.
        """
        if module_id in self._specs:
            spec = self._specs[module_id]
            if cost_hint is not None and spec.cost_hint is None:
                spec.cost_hint = cost_hint
            return spec
        if fn is None:

            def _placeholder(*a: Any, **k: Any) -> Any:
                raise NotImplementedError(
                    f"module {module_id!r} was observed (not registered with an "
                    "executable function); it cannot be run by a workflow engine"
                )

            fn = _placeholder
        return self.register_fn(module_id, fn, cost_hint=cost_hint, **default_params)

    # -- resolution / validation ----------------------------------------------
    def ref(
        self,
        module_id: str,
        params: Mapping[str, Any] | None = None,
        validate: bool = True,
    ) -> ModuleRef:
        """Resolve ``(module_id, params)`` to a :class:`ModuleRef` whose tool
        state merges the module's registered defaults — the identity every
        engine must agree on for cross-engine artifact reuse."""
        spec = self[module_id]
        if validate:
            self.validate_state(module_id, params)
        return spec.ref(params)

    def validate_state(
        self, module_id: str, params: Mapping[str, Any] | None
    ) -> None:
        """Reject tool states the module's function could never accept.

        Checks parameter *names* against the function signature (anything
        goes when the function takes ``**kwargs``); value encodability is
        enforced separately by ``ToolState.from_config``.
        """
        spec = self[module_id]
        if not params:
            return
        try:
            sig = inspect.signature(spec.fn)
        except (TypeError, ValueError):  # builtins / C callables: no signature
            return
        accepts_kwargs = any(
            p.kind is inspect.Parameter.VAR_KEYWORD
            for p in sig.parameters.values()
        )
        if accepts_kwargs:
            return
        # the first positionally-fillable parameter receives the flowing
        # value, not a tool-state param; everything keyword-passable after it
        # is fair game
        allowed: set[str] = set()
        data_arg_seen = False
        for n, p in sig.parameters.items():
            if p.kind in (
                inspect.Parameter.POSITIONAL_ONLY,
                inspect.Parameter.POSITIONAL_OR_KEYWORD,
            ):
                if not data_arg_seen:
                    data_arg_seen = True
                    continue
                if p.kind is inspect.Parameter.POSITIONAL_OR_KEYWORD:
                    allowed.add(n)
            elif p.kind is inspect.Parameter.KEYWORD_ONLY:
                allowed.add(n)
        unknown = sorted(set(map(str, params)) - allowed)
        if unknown:
            raise ToolStateError(
                f"module {module_id!r} does not accept parameter(s) "
                f"{unknown}; accepted: {sorted(allowed) or '<none>'}"
            )

    def resolve_params(self, ref: ModuleRef) -> dict[str, Any]:
        """Concrete call kwargs for one module occurrence: registered defaults
        overlaid with the ref's decoded tool state."""
        spec = self[ref.module_id]
        params = dict(spec.default_params)
        params.update(ref.state.to_config())
        return params

    def make_state(
        self, module_id: str, params: Mapping[str, Any] | None = None
    ) -> ToolState:
        return self.ref(module_id, params).state
