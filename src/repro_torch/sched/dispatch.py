"""Node dispatchers: where a DAG node's module function actually executes.

By default the :class:`~repro.sched.scheduler.DagScheduler` runs module
functions on its thread pool — correct for modules that release the GIL
(external tools, BLAS, I/O) but useless for pure-Python compute, which the
GIL serializes no matter how many threads exist.  A *dispatcher* redirects
just the ``fn(data, **params)`` call; scheduling, store probing, admission,
and eviction bookkeeping all stay in the coordinating process, so every
invariant of the scheduler is untouched.

:class:`ProcessPoolDispatcher` sends the call to a pool of worker
processes.  Workers are primed once by a picklable ``registry_factory``
(a module-level function returning the module universe), then invoked by
module id — only the data pytree and resolved params cross the process
boundary.  Pair it with a remote store (``repro.net``) and N schedulers in
N processes share one artifact pool while their computes use real cores.
"""
from __future__ import annotations

import multiprocessing
from concurrent.futures import ProcessPoolExecutor
from typing import Any, Callable, Mapping, Protocol, runtime_checkable


@runtime_checkable
class NodeDispatcher(Protocol):
    """Minimal contract the scheduler needs from a dispatcher."""

    def accepts(self, module_id: str) -> bool: ...

    def invoke(self, module_id: str, params: Mapping[str, Any], data: Any) -> Any: ...


# -- worker-process side ------------------------------------------------------
_WORKER_FNS: dict[str, Callable[..., Any]] = {}


def _normalize_registry(reg: Any) -> dict[str, Callable[..., Any]]:
    fns: dict[str, Callable[..., Any]] = {}
    for module_id in reg:
        spec = reg[module_id]
        fns[module_id] = getattr(spec, "fn", spec)  # ModuleSpec or bare callable
    return fns


def _worker_init(registry_factory: Callable[[], Any]) -> None:
    global _WORKER_FNS
    _WORKER_FNS = _normalize_registry(registry_factory())


def _worker_modules() -> frozenset[str]:
    return frozenset(_WORKER_FNS)


def _worker_invoke(module_id: str, params: dict[str, Any], data: Any) -> Any:
    return _WORKER_FNS[module_id](data, **params)


def _worker_hold(seconds: float) -> None:
    import time

    time.sleep(seconds)


# -- coordinator side ---------------------------------------------------------
class ProcessPoolDispatcher:
    """Executes module functions in worker processes (escaping the GIL).

    Parameters
    ----------
    registry_factory: picklable zero-arg callable (a module-level function)
        returning the worker's module universe — a ``ModuleRegistry``, a
        ``dict[str, ModuleSpec]``, or a ``dict[str, callable]``.  It runs
        once per worker at startup.
    max_procs: pool size.
    mp_context: multiprocessing start method; ``"spawn"`` (default) gives
        workers a clean interpreter — mandatory when the coordinator has
        live threads or an initialized accelerator runtime, both of which
        ``fork`` would corrupt.
    """

    def __init__(
        self,
        registry_factory: Callable[[], Any],
        max_procs: int = 4,
        mp_context: str = "spawn",
    ) -> None:
        self.max_procs = max_procs
        self._pool = ProcessPoolExecutor(
            max_workers=max_procs,
            mp_context=multiprocessing.get_context(mp_context),
            initializer=_worker_init,
            initargs=(registry_factory,),
        )
        self._modules: frozenset[str] | None = None

    def modules(self) -> frozenset[str]:
        """Module ids the workers can execute (probed once, then cached)."""
        if self._modules is None:
            self._modules = self._pool.submit(_worker_modules).result()
        return self._modules

    def accepts(self, module_id: str) -> bool:
        # modules registered on the coordinator after worker startup fall
        # back to inline execution instead of failing in the worker
        return module_id in self.modules()

    def invoke(self, module_id: str, params: Mapping[str, Any], data: Any) -> Any:
        return self._pool.submit(
            _worker_invoke, module_id, dict(params), data
        ).result()

    def warmup(self) -> None:
        """Force startup of the *whole* pool (interpreters + imports) before
        timing runs: overlapping hold tasks make the executor spawn every
        worker, not just the first."""
        futs = [self._pool.submit(_worker_hold, 0.2) for _ in range(self.max_procs)]
        for f in futs:
            f.result()
        self.modules()

    def close(self) -> None:
        self._pool.shutdown(wait=True)

    def __enter__(self) -> "ProcessPoolDispatcher":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()
