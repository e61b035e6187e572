"""Workflow data model: Modules, ToolStates, Workflows, and prefix keys.

Mirrors the thesis' formalization (Ch. 6.3.1):

    W = (D, M, E, ID, O)  — input dataset D, modules M, edges E, intermediate
    data ID, output O.  A module is m => <id, I, O, C, S, T, Id> where C is the
    parameter-configuration set and T the tool state.

For rule mining the thesis treats pipelines as *sequential* module chains
(Ch. 3.3: "For simplicity we are considering only sequential module processing
in workflows"); general DAGs are decomposed into root-to-node paths.
"""
from __future__ import annotations

import hashlib
import json
import re
from dataclasses import dataclass, field
from typing import Any, Callable, Iterator, Mapping, Sequence

_ADDR_RE = re.compile(r" at 0x[0-9a-fA-F]+")


def _canonical(obj: Any, invertible: bool = False) -> Any:
    """Reduce ``obj`` to a JSON-safe form whose rendering is identical across
    processes.  ``repr`` fallbacks that embed memory addresses would make the
    digest unique per run — silently defeating cross-process reuse — so
    address-bearing reprs are rejected rather than hashed.

    ``invertible=True`` selects the tool-state-parameter variant: every
    encoding must be reversible by :func:`_decanonical`, so tuples are tagged
    (vs. lists), bytes/arrays carry their raw content instead of a digest, and
    ``repr`` fallbacks are only accepted when ``ast.literal_eval`` can undo
    them.  Values that cannot round-trip raise ``TypeError`` loudly instead of
    silently degrading to strings at execution time.
    """
    if obj is None or isinstance(obj, (bool, int, str)):
        return obj
    if isinstance(obj, float):
        return obj
    if isinstance(obj, bytes):
        if invertible:
            return {"__hexbytes__": obj.hex()}
        return {"__bytes__": hashlib.sha256(obj).hexdigest()}
    if isinstance(obj, Mapping):
        # encoded as a tagged sorted pair-list, not a plain JSON object, so a
        # user dict like {"__set__": [...]} can never forge the sentinel
        # encodings below (which would collide with the real set/array/bytes)
        if not invertible or all(isinstance(k, str) for k in obj):
            return {
                "__map__": [
                    [str(k), _canonical(v, invertible)]
                    for k, v in sorted(obj.items(), key=lambda kv: str(kv[0]))
                ]
            }
        # non-str keys: encode both sides and sort by rendering, so the
        # encoding is insertion-order independent like every other container
        return {
            "__dictitems__": sorted(
                (
                    [_canonical(k, True), _canonical(v, True)]
                    for k, v in obj.items()
                ),
                key=lambda kv: json.dumps(kv, sort_keys=True),
            )
        }
    elif isinstance(obj, tuple):
        if invertible:
            return {"__tuple__": [_canonical(x, invertible) for x in obj]}
        return [_canonical(x) for x in obj]
    elif isinstance(obj, list):
        return [_canonical(x, invertible) for x in obj]
    elif isinstance(obj, (set, frozenset)):
        tag = "__frozenset__" if invertible and isinstance(obj, frozenset) else "__set__"
        return {
            tag: sorted(
                json.dumps(_canonical(x, invertible), sort_keys=True) for x in obj
            )
        }
    # array-likes (numpy / jax / ml_dtypes): digest dtype + shape + raw bytes
    elif hasattr(obj, "dtype") and hasattr(obj, "shape") and hasattr(obj, "tobytes"):
        import numpy as np

        arr = np.ascontiguousarray(obj)
        if invertible:
            return {
                "__ndarray__": str(arr.dtype),
                "shape": list(arr.shape),
                "hex": arr.tobytes().hex(),
            }
        return {
            "__array__": str(arr.dtype),
            "shape": list(arr.shape),
            "sha256": hashlib.sha256(arr.tobytes()).hexdigest(),
        }
    r = repr(obj)
    if _ADDR_RE.search(r):
        raise TypeError(
            f"cannot stably hash {type(obj).__name__!r}: repr embeds a memory "
            "address; give it a value-based __repr__ or pass primitives/arrays"
        )
    if invertible:
        import ast

        try:
            ast.literal_eval(r)
        except (ValueError, SyntaxError) as e:
            raise TypeError(
                f"tool-state parameter of type {type(obj).__name__!r} is not "
                f"value-recoverable (repr {r!r} is not a Python literal); pass "
                "primitives, tuples/lists/dicts/sets of them, or arrays"
            ) from e
    return {"__repr__": r}


def _decanonical(obj: Any) -> Any:
    """Invert :func:`_canonical` (invertible mode) back to Python values."""
    if isinstance(obj, dict):
        if "__tuple__" in obj:
            return tuple(_decanonical(x) for x in obj["__tuple__"])
        if "__map__" in obj:
            return {k: _decanonical(v) for k, v in obj["__map__"]}
        if "__set__" in obj:
            return {_decanonical(json.loads(s)) for s in obj["__set__"]}
        if "__frozenset__" in obj:
            return frozenset(
                _decanonical(json.loads(s)) for s in obj["__frozenset__"]
            )
        if "__dictitems__" in obj:
            return {
                _decanonical(k): _decanonical(v) for k, v in obj["__dictitems__"]
            }
        if "__hexbytes__" in obj:
            return bytes.fromhex(obj["__hexbytes__"])
        if "__ndarray__" in obj:
            import numpy as np

            raw = bytes.fromhex(obj["hex"])
            arr = np.frombuffer(raw, dtype=np.dtype(obj["__ndarray__"]))
            return arr.reshape(obj["shape"]).copy()
        if "__repr__" in obj:
            import ast

            try:
                return ast.literal_eval(obj["__repr__"])
            except (ValueError, SyntaxError):
                return obj["__repr__"]
        raise TypeError(f"cannot decode digest-only encoding {sorted(obj)!r}")
    if isinstance(obj, list):
        return [_decanonical(x) for x in obj]
    return obj


def encode_param(value: Any) -> str:
    """Canonical, *invertible* rendering of one tool-state parameter value.

    The encoding is deterministic across processes (same guarantees as
    ``_stable_hash``'s canonical form) and :func:`decode_param` recovers the
    original value exactly — including tuples, floats, nested containers,
    bytes, and small arrays.  Non-recoverable values raise ``TypeError`` at
    construction time instead of degrading to strings at execution time.
    """
    return json.dumps(_canonical(value, invertible=True), sort_keys=True)


def decode_param(encoded: str) -> Any:
    """Inverse of :func:`encode_param`.

    Legacy ``repr()``-encoded params (pre-canonical ``ToolState``s, e.g. from
    persisted specs) fall back to ``ast.literal_eval`` — the deprecated
    :func:`repro.core.executor.eval_repr` behaviour — so old documents keep
    resolving.
    """
    try:
        payload = json.loads(encoded)
    except (ValueError, TypeError):
        # legacy repr() encoding ("'s'", "(1, 2)", "{'a': 1}", ...)
        import ast

        try:
            return ast.literal_eval(encoded)
        except (ValueError, SyntaxError):
            return encoded
    return _decanonical(payload)


def _stable_hash(obj: Any) -> str:
    """SHA-256 of a canonical-JSON rendering; used for tool states & datasets.

    Deterministic across processes: unhashable leaves are canonicalized (arrays
    by content digest) or rejected, never ``repr``-ed into ``<... at 0x...>``.
    """
    payload = json.dumps(_canonical(obj), sort_keys=True).encode()
    return hashlib.sha256(payload).hexdigest()[:16]


@dataclass(frozen=True)
class ToolState:
    """Parameter configuration of a module (thesis Ch. 5: 'tool state').

    Two invocations of the same module with different parameter sets are
    different tool states and must not share intermediate data.
    """

    params: tuple[tuple[str, str], ...] = ()

    @classmethod
    def from_config(cls, config: Mapping[str, Any] | None) -> "ToolState":
        """Canonicalize a parameter mapping.

        Values are rendered through :func:`encode_param` — deterministic
        across processes and exactly invertible by :meth:`to_config` (tuples
        stay tuples, floats keep full precision, nested containers survive).
        Values that cannot round-trip raise ``TypeError`` here rather than
        silently degrading to strings when a module is executed.
        """
        if not config:
            return cls()
        items = tuple(sorted((str(k), encode_param(v)) for k, v in config.items()))
        return cls(items)

    def to_config(self) -> dict[str, Any]:
        """Recover the parameter mapping (inverse of :meth:`from_config`).

        The decoded mapping is computed once and cached on the instance
        (immutable after construction, so the decode can never go stale):
        the registry resolves params on every node execution and both the
        recommender index and the catalog decode whole chains — without the
        cache each pays a full ``decode_param`` pass per visit.  Callers get
        a fresh shallow copy so mutating the returned dict cannot corrupt
        the cache.
        """
        cached = getattr(self, "_decoded", None)
        if cached is None:
            cached = {k: decode_param(v) for k, v in self.params}
            # frozen dataclass: bypass the immutability guard for the memo.
            # eq/hash are unaffected (they only consider declared fields).
            object.__setattr__(self, "_decoded", cached)
        return dict(cached)

    @property
    def digest(self) -> str:
        return _stable_hash(self.params) if self.params else "default"

    def __str__(self) -> str:  # pragma: no cover - debug aid
        return self.digest


@dataclass(frozen=True)
class ModuleRef:
    """A module occurrence inside a workflow: id + tool state."""

    module_id: str
    state: ToolState = field(default_factory=ToolState)

    def key(self, with_state: bool) -> str:
        return f"{self.module_id}@{self.state.digest}" if with_state else self.module_id


@dataclass(frozen=True)
class Workflow:
    """A sequential pipeline applied to one input dataset."""

    dataset_id: str
    modules: tuple[ModuleRef, ...]
    workflow_id: str = ""

    def __post_init__(self) -> None:
        if not self.modules:
            raise ValueError("a workflow needs at least one module")

    @classmethod
    def build(
        cls,
        dataset_id: str,
        steps: Sequence[str | tuple[str, Mapping[str, Any] | None]],
        workflow_id: str = "",
    ) -> "Workflow":
        refs = []
        for step in steps:
            if isinstance(step, str):
                refs.append(ModuleRef(step))
            else:
                mod, cfg = step
                refs.append(ModuleRef(mod, ToolState.from_config(cfg)))
        return cls(dataset_id, tuple(refs), workflow_id)

    def __len__(self) -> int:
        return len(self.modules)

    def prefixes(self) -> Iterator["PrefixKey"]:
        """All prefixes D=>[M1..Mk], k=1..n — one per storable intermediate state.

        The thesis derives one association rule per storable result including
        the final one (Ch. 4.3.1: 4 rules from a 4-module pipeline).
        """
        for k in range(1, len(self.modules) + 1):
            yield self.prefix(k)

    def prefix(self, k: int) -> "PrefixKey":
        if not 1 <= k <= len(self.modules):
            raise IndexError(f"prefix length {k} out of range 1..{len(self.modules)}")
        return PrefixKey(self.dataset_id, self.modules[:k])

    @property
    def n_intermediate_states(self) -> int:
        """Storable states incl. the final result (thesis counts both)."""
        return len(self.modules)


@dataclass(frozen=True)
class PrefixKey:
    """Canonical identity of an intermediate state: dataset + module prefix.

    ``key(with_state=True)`` is the *adaptive RISP* identity (Ch. 5) — it
    includes each module's tool-state digest; ``with_state=False`` is the plain
    Ch. 4 identity.
    """

    dataset_id: str
    modules: tuple[ModuleRef, ...]

    def key(self, with_state: bool = False) -> str:
        mods = ">".join(m.key(with_state) for m in self.modules)
        return f"{self.dataset_id}::{mods}"

    def __len__(self) -> int:
        return len(self.modules)

    @property
    def depth(self) -> int:
        return len(self.modules)

    def parent(self) -> "PrefixKey | None":
        if len(self.modules) == 1:
            return None
        return PrefixKey(self.dataset_id, self.modules[:-1])


@dataclass
class ModuleSpec:
    """An executable module registered with the SWfMS executor.

    ``fn`` maps (input pytree, **params) -> output pytree. ``cost_hint``
    optionally estimates seconds for scheduling/reporting.
    """

    module_id: str
    fn: Callable[..., Any]
    default_params: dict[str, Any] = field(default_factory=dict)
    cost_hint: float | None = None

    def ref(self, params: Mapping[str, Any] | None = None) -> ModuleRef:
        merged = dict(self.default_params)
        if params:
            merged.update(params)
        return ModuleRef(self.module_id, ToolState.from_config(merged))
