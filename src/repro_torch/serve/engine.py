"""Serving engine with a RISP-guided KV-prefix cache, on torch.

The port of the reference's ``serve/engine.py``: a request's prompt is a
*workflow* — the token stream chunked into fixed-size modules — and RISP's
association mining over the request history decides which prefix KV states
to retain.  Later requests restore the deepest stored snapshot and skip
prefilling it.  Left-padding with token 0, ``_chunk_id`` over int32 token
bytes and ``workflow_id=f"req{n}"`` are the reference's, so RISP sees the
same keys and takes the same decisions.

Differences that follow from torch:

* the model updates the KV cache in place, so the cache at a chunk boundary
  whose prefix RISP admitted is cloned when it is reached (the reference
  keeps every boundary for free: its arrays are immutable), and a result
  shared by a single-flight is cloned by each party before it is extended;
* a device's work is awaited with ``torch.cuda.synchronize`` before the
  clock is read, so measured prefill seconds, the price in gain-loss
  eviction, are device time and not enqueue time;
* on the card, decoding replays one CUDA graph of ``transformer.decode_step``
  per new token, the counterpart of the reference's ``jax.jit`` of the step.
  The graph works on static buffers of the engine (a ``[L,1,max_len,...]``
  cache, KV or MLA's latent, its length, the token and the logits); the step it holds advances
  its own length.  The first decode captures it (after one eager warm-up
  step on the capture stream); every request copies its cache and length
  into the static buffers, which no snapshot or boundary clone ever aliases,
  and a lock keeps two threads from interleaving there.  A failed capture
  raises: nothing falls back to eager steps on the card.  On the CPU decoding
  stays eager.

The engine runs on ``device`` ("cuda" by default; asking for CUDA without a
card raises).  Snapshots live in a :class:`MemorySnapshotStore` unless
``snapshots`` is given: a :class:`FabricSnapshotStore` puts them on a shared
storage backend, where an engine of either package restores them, and a
``flight`` (:class:`~repro_torch.net.flight.DistributedSingleFlight`) elects
one prefiller of a shared prefix across processes
(:func:`repro_torch.serve.fabric.mount_serve_engine` wires both).
"""
from __future__ import annotations

import hashlib
import threading
import time
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from ..configs.base import LMConfig
from ..core.registry import ModuleRegistry
from ..core.risp import RISP, StoragePolicy, StoredRecord
from ..core.workflow import ModuleRef, Workflow
from ..kernels.decode_attention import ops as decode_ops
from ..models import transformer
from ..obs import tracing as _tracing
from ..obs.metrics import MetricsRegistry
from ..sched.singleflight import SingleFlight
from ..sched.stats import AggregateStats
from .snapshots import MemorySnapshotStore, SnapshotStore


def _chunk_id(tokens: np.ndarray) -> str:
    return hashlib.sha1(np.ascontiguousarray(tokens).tobytes()).hexdigest()[:12]


def _clone(cache: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    return {k: a.clone() for k, a in cache.items()}


@dataclass
class GenStats:
    prompt_len: int
    n_chunks: int
    chunks_skipped: int
    prefill_s: float
    decode_s: float
    stored_prefixes: int
    n_new_tokens: int


class ServeMetrics:
    """The canonical ``repro_serve_*`` instruments.

    One home for every serving counter; :meth:`ServeEngine.aggregate_stats`
    is reconstructed from these.
    """

    def __init__(self, registry: MetricsRegistry) -> None:
        m = registry
        self.requests = m.counter(
            "repro_serve_requests_total", "generation requests served"
        )
        self.chunks = m.counter(
            "repro_serve_chunks_total", "prompt chunks across all requests"
        )
        self.chunks_skipped = m.counter(
            "repro_serve_chunks_skipped_total",
            "prompt chunks skipped by restoring a KV snapshot",
        )
        self.tokens = m.counter("repro_serve_tokens_total", "new tokens decoded")
        self.stored = m.counter(
            "repro_serve_snapshots_stored_total",
            "KV snapshot admissions by this engine",
        )
        self.busy = m.counter(
            "repro_serve_busy_seconds_total", "seconds spent prefilling + decoding"
        )
        self.saved = m.counter(
            "repro_serve_prefill_saved_seconds_total",
            "prefill seconds avoided by snapshot reuse (measured cost minus load)",
        )
        self.prefill_s = m.histogram(
            "repro_serve_prefill_seconds", "per-request prefill wall seconds"
        )
        self.decode_s = m.histogram(
            "repro_serve_decode_seconds", "per-request decode wall seconds"
        )


@dataclass
class _PrefixResult:
    """State after materializing a prompt prefix (the coordinated unit)."""

    cache: Any  # device cache dict at ``depth`` chunks
    cache_len: Any  # torch [1] int32 on the engine's device
    depth: int  # chunks materialized in ``cache``
    logits: Any | None  # logits of the last prefilled chunk (None: none ran)
    skipped: int  # chunks restored from a snapshot instead of prefilled
    stored: int  # snapshot admissions performed
    prefill_s: float  # wall seconds of prefill done here




class _DecodeGraph:
    """``transformer.decode_step`` captured once as a CUDA graph over static
    buffers: the cache (``{"k","v": [L,1,max_len,Hkv,dh]}``, or MLA's
    ``{"c_kv": [L,1,max_len,r], "k_rope": [L,1,max_len,rope]}``), its length
    ``[1]`` int32, the token ``[1,1]`` int64 and the logits ``[1,V]``.  The
    captured step writes its cache rows into the static cache and advances
    the static length.  Decode-attention kernels recorded into the graph are
    counted once per replay (``kernels``: one fused kernel a layer for GQA;
    none for MLA, whose absorbed attention is plain torch)."""

    def __init__(self, engine: "ServeEngine") -> None:
        cfg, dev = engine.cfg, engine._dev
        self.cache = transformer.init_cache(cfg, 1, engine.max_len, dev)
        self.cache_len = torch.zeros(1, dtype=torch.int32, device=dev)
        self.token = torch.zeros(1, 1, dtype=torch.int64, device=dev)

        def step() -> torch.Tensor:
            logits, _, new_len = transformer.decode_step(
                engine.params, cfg, self.token, self.cache, self.cache_len)
            self.cache_len.copy_(new_len)
            return logits

        stream = torch.cuda.Stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):  # warm-up: libraries set up outside the capture
            step()
        torch.cuda.current_stream(dev).wait_stream(stream)
        captured = dict(decode_ops.decode_attention.captured_by_variant)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, stream=stream, capture_error_mode="thread_local"):
            self.logits = step()
        self.kernels = {
            v: n - captured[v]
            for v, n in decode_ops.decode_attention.captured_by_variant.items()
            if n - captured[v]
        }

    def load(self, cache: dict[str, torch.Tensor], cache_len: torch.Tensor) -> None:
        """Copy a request's cache and length into the static buffers."""
        for name, a in self.cache.items():
            a.copy_(cache[name])
        self.cache_len.copy_(cache_len)

    def step(self, token: int) -> torch.Tensor:
        self.token.fill_(token)
        self.graph.replay()
        decode_ops.count_replays(self.kernels)
        return self.logits


@dataclass
class ServeEngine:
    cfg: LMConfig
    params: Any
    max_len: int = 512
    chunk: int = 32
    policy: StoragePolicy = field(default_factory=RISP)
    greedy: bool = True
    # KV-snapshot budget for the default in-memory tier: same gain-loss
    # retention as the disk store (ignored when ``snapshots`` is passed)
    snapshot_budget_bytes: int | None = None
    eviction: str = "gain_loss"
    # optional shared ModuleRegistry: observed prompt chunks are recorded as
    # (non-executable) modules with prefill-cost hints, so the serving
    # workload's module universe is introspectable through the same registry
    # the workflow engines consume
    registry: ModuleRegistry | None = None
    # where snapshots live (None -> engine-private MemorySnapshotStore);
    # pass a FabricSnapshotStore to share prefills across processes
    snapshots: SnapshotStore | None = None
    # single-flight election over shared-prefix prefills; a
    # DistributedSingleFlight makes the election fleet-wide
    flight: SingleFlight | None = None
    metrics: MetricsRegistry | None = None
    # dataset identity of the prompt workflows (snapshot keys are scoped by it)
    dataset_id: str = "prompts"
    # where the model runs; params must already live there
    device: str | torch.device = "cuda"

    def __post_init__(self) -> None:
        self._dev = torch.device(self.device)
        if self._dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("ServeEngine: device='cuda' requested but CUDA is not available")
        if self.params["embed"].device.type != self._dev.type:
            raise ValueError(
                f"ServeEngine: params on {self.params['embed'].device}, engine on {self._dev}"
            )
        if self.metrics is None:
            self.metrics = (
                self.snapshots.metrics
                if self.snapshots is not None
                else MetricsRegistry()
            )
        if self.snapshots is None:
            self.snapshots = MemorySnapshotStore(
                self.snapshot_budget_bytes, self.eviction, registry=self.metrics
            )
        # every removal path funnels through the store's listeners: the
        # policy's claim of the snapshot dies with the snapshot.
        # GIL-atomic pop without the policy lock (documented lock order).
        self.snapshots.add_evict_listener(
            lambda key: self.policy.stored.pop(key, None)
        )
        self._sm = ServeMetrics(self.metrics)
        self._chunk_prefill_s = 0.0  # EMA seconds to prefill one chunk
        self._t_first: float | None = None
        self._t_last = 0.0
        self._graph: _DecodeGraph | None = None
        self._graph_lock = threading.Lock()

    # -- device plumbing -----------------------------------------------------
    def _sync(self) -> None:
        """Wait for the device, so the clock reads finished work."""
        if self._dev.type == "cuda":
            torch.cuda.synchronize(self._dev)

    def _tokens(self, toks: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.asarray(toks, np.int64)).to(self._dev)

    def _prefill(self, tok, cache, cache_len):
        return transformer.prefill_chunk(self.params, self.cfg, tok, cache, cache_len)

    def _decode(self, tok, cache, cache_len):
        return transformer.decode_step(self.params, self.cfg, tok, cache, cache_len)

    def _decode_tokens(self, logits, cache, cache_len, n: int) -> list[int]:
        """Greedy tokens from ``logits`` on: ``n`` decode steps, eager on the
        CPU, replays of the captured graph on the card."""
        out: list[int] = []
        if self._dev.type != "cuda":
            for _ in range(n):
                nxt = int(torch.argmax(logits[0]))
                out.append(nxt)
                tok = torch.tensor([[nxt]], dtype=torch.int64, device=self._dev)
                logits, cache, cache_len = self._decode(tok, cache, cache_len)
            return out
        with self._graph_lock:
            if self._graph is None:
                self._graph = _DecodeGraph(self)
            graph = self._graph
            graph.load(cache, cache_len)
            for _ in range(n):
                nxt = int(torch.argmax(logits[0]))
                out.append(nxt)
                logits = self._replay(graph, nxt)
        return out

    def _replay(self, graph: "_DecodeGraph", token: int) -> torch.Tensor:
        """One decode step on the card: the graph's logits after ``token``."""
        return graph.step(token)

    # -- RISP bookkeeping over request chunks ------------------------------
    def _workflow(self, chunks: list[np.ndarray]) -> Workflow:
        mods = tuple(ModuleRef(_chunk_id(c)) for c in chunks)
        if self.registry is not None:
            for m in mods:
                self.registry.ensure(
                    m.module_id, cost_hint=self._chunk_prefill_s or None
                )
        return Workflow(
            self.dataset_id, mods, workflow_id=f"req{self.policy.n_pipelines}"
        )

    def _load_snapshot(self, key: str, depth: int) -> "Any | None":
        """Restore one snapshot, crediting the measured time it saved."""
        with _tracing.span("serve.snapshot.load", kind="serve", key=key) as sp:
            snap = self.snapshots.load(key)
            if snap is None:
                sp.set(status="miss")
                return None
            recompute = snap.prefill_s or depth * self._chunk_prefill_s
            saved = max(recompute - snap.load_s, 0.0)
            sp.set(source="snapshot", saved_s=round(saved, 6), depth=depth)
            self._sm.saved.inc(saved)
        return snap

    # -- prefill -------------------------------------------------------------
    def _prefill_prefix(
        self,
        chunks: list[np.ndarray],
        wf: Workflow,
        rec: Any,
        depth_keys: dict[int, str],
        upto: int,
        presence: "dict[str, bool | None] | None" = None,
    ) -> _PrefixResult:
        """Materialize the first ``upto`` chunks: restore the deepest live
        snapshot, prefill the rest, store what the policy admitted.

        This is the unit a single-flight leader runs.  A follower re-running
        it after the leader finishes re-probes and finds the leader's
        snapshot — so it prefills nothing (the exactly-once property)."""
        ws = self.policy.with_state
        if presence is None:
            presence = self.snapshots.presence_many(list(depth_keys.values()))
        # authoritative absences invalidate any claim the policy still holds,
        # except the claims ``policy.step`` just admitted for THIS request:
        # those are pending the save below, not stale
        pending = {p.key(ws) for p in rec.store}
        for key in depth_keys.values():
            if presence.get(key) is False and key not in pending:
                self.policy.stored.pop(key, None)

        start, cache, cache_len_i = 0, None, 0
        for d in range(upto, 0, -1):
            key = depth_keys[d]
            if not presence.get(key):
                continue
            snap = self._load_snapshot(key, d)
            if snap is None:
                continue  # phantom: the store already pruned + notified
            # a copy: the model writes the restored cache in place
            cache = {k: a.to(self._dev, copy=True) for k, a in snap.cache.items()}
            cache_len_i = snap.length
            start = d
            # cross-process adoption: mining in this process may never have
            # admitted this prefix — record that it is stored so the policy
            # recommends reusing it next time
            self.policy.stored.setdefault(
                key, StoredRecord(wf.prefix(d), self.policy.n_pipelines)
            )
            break
        if cache is None:
            cache = transformer.init_cache(self.cfg, 1, self.max_len, self._dev)

        t0 = time.perf_counter()
        cache_len = torch.tensor([cache_len_i], dtype=torch.int32, device=self._dev)
        logits = None
        # the cache is written in place: keep a clone at each boundary whose
        # prefix the policy admitted (known before the loop), and only there
        admitted = {p.depth for p in rec.store}
        boundary: dict[int, tuple[Any, int]] = {}
        # measured recompute cost of each boundary's prefix: seconds actually
        # spent this request, plus the EMA-priced skipped part — this is what
        # gain-loss eviction will charge to re-create the snapshot
        boundary_cost: dict[int, float] = {}
        base_cost = start * self._chunk_prefill_s
        cum = 0.0
        for i in range(start, upto):
            tok = self._tokens(chunks[i][None])
            tc = time.perf_counter()
            logits, cache, cache_len = self._prefill(tok, cache, cache_len)
            self._sync()
            dt = time.perf_counter() - tc
            self._chunk_prefill_s = (
                dt if not self._chunk_prefill_s
                else 0.3 * dt + 0.7 * self._chunk_prefill_s
            )
            cum += dt
            if i + 1 in admitted:
                boundary[i + 1] = (_clone(cache), cache_len_i + (i + 1 - start) * self.chunk)
            boundary_cost[i + 1] = base_cost + cum
        prefill_s = time.perf_counter() - t0

        # store admitted prefixes (only those whose boundary we computed)
        stored = 0
        for prefix in rec.store:
            if prefix.depth > upto:
                continue  # a later (uncoordinated) stage never stores
            key = prefix.key(ws)
            if prefix.depth in boundary:
                c, ln = boundary[prefix.depth]
                if self.snapshots.save(
                    key, c, ln,
                    prefill_s=boundary_cost[prefix.depth],
                    prefix=prefix,
                ):
                    stored += 1
                else:  # budget rejected the snapshot
                    self.policy.stored.pop(key, None)
            elif presence.get(key):
                pass  # inside the restored region: already on the store
            else:
                self.policy.stored.pop(key, None)
        return _PrefixResult(
            cache=cache,
            cache_len=cache_len,
            depth=upto,
            logits=logits,
            skipped=start,
            stored=stored,
            prefill_s=prefill_s,
        )

    # -- generation ---------------------------------------------------------
    @torch.inference_mode()
    def generate(
        self, prompt: list[int] | np.ndarray, max_new_tokens: int = 16
    ) -> tuple[list[int], GenStats]:
        prompt = np.asarray(prompt, np.int32)
        pad = (-len(prompt)) % self.chunk
        padded = np.concatenate([np.zeros(pad, np.int32), prompt])  # left-pad
        if len(padded) + max_new_tokens > self.max_len:
            # the reference drops writes past the cache silently; an index
            # past it here would be a device-side fault, so refuse up front
            raise ValueError(
                f"{len(padded)} padded prompt tokens + {max_new_tokens} new tokens "
                f"exceed max_len {self.max_len}"
            )
        chunks = [padded[i : i + self.chunk] for i in range(0, len(padded), self.chunk)]
        n = len(chunks)
        wf = self._workflow(chunks)
        rec = self.policy.step(wf)
        ws = self.policy.with_state
        depth_keys = {d: wf.prefix(d).key(ws) for d in range(1, n + 1)}

        # the coordination unit: the deepest prefix this request was asked to
        # store — exactly one engine should prefill it
        coord_depth = max((p.depth for p in rec.store), default=0)

        with _tracing.span("serve.prefill", kind="serve") as sp:
            t_pf = time.perf_counter()
            if self.flight is not None and coord_depth > 0:
                value, leader = self.flight.run(
                    depth_keys[coord_depth],
                    lambda: self._prefill_prefix(
                        chunks, wf, rec, depth_keys, upto=coord_depth
                    ),
                )
                # leader and followers share ``value``: each extends a copy
                value = _PrefixResult(
                    cache=_clone(value.cache),
                    cache_len=value.cache_len,
                    depth=value.depth,
                    logits=value.logits,
                    skipped=value.skipped if leader else value.depth,
                    stored=value.stored if leader else 0,
                    prefill_s=value.prefill_s if leader else 0.0,
                )
            else:
                value = self._prefill_prefix(chunks, wf, rec, depth_keys, upto=n)

            # uncoordinated remainder: this request's private suffix
            cache, cache_len = value.cache, value.cache_len
            logits = value.logits
            t_ext = time.perf_counter()
            for i in range(value.depth, n):
                tok = self._tokens(chunks[i][None])
                tc = time.perf_counter()
                logits, cache, cache_len = self._prefill(tok, cache, cache_len)
                self._sync()
                dt = time.perf_counter() - tc
                self._chunk_prefill_s = (
                    dt if not self._chunk_prefill_s
                    else 0.3 * dt + 0.7 * self._chunk_prefill_s
                )
            prefill_s = value.prefill_s + (time.perf_counter() - t_ext)
            sp.set(n=n, skipped=value.skipped, stored=value.stored)
        stored = value.stored

        # decode
        t1 = time.perf_counter()
        if logits is None:  # full-prompt cache hit: re-run last chunk's logits
            tok = self._tokens(chunks[-1][None])
            trimmed_cache, trimmed_len = self._trim_last_chunk(cache, cache_len)
            logits, cache, cache_len = self._prefill(tok, trimmed_cache, trimmed_len)
        out = self._decode_tokens(logits, cache, cache_len, max_new_tokens)
        self._sync()  # the last decode step is still in flight otherwise
        decode_s = time.perf_counter() - t1

        stats = GenStats(
            prompt_len=len(prompt),
            n_chunks=n,
            chunks_skipped=value.skipped,
            prefill_s=prefill_s,
            decode_s=decode_s,
            stored_prefixes=stored,
            n_new_tokens=len(out),
        )
        if self._t_first is None:
            self._t_first = t_pf
        self._t_last = time.perf_counter()
        m = self._sm
        m.requests.inc()
        m.chunks.inc(stats.n_chunks)
        m.chunks_skipped.inc(stats.chunks_skipped)
        m.tokens.inc(stats.n_new_tokens)
        m.stored.inc(stats.stored_prefixes)
        m.busy.inc(stats.prefill_s + stats.decode_s)
        m.prefill_s.observe(stats.prefill_s)
        m.decode_s.observe(stats.decode_s)
        return out, stats

    def _trim_last_chunk(self, cache, cache_len):
        """Full-prefix hit: zero out the last chunk's slots and re-prefill it
        to recover last-position logits (snapshots store caches, not logits).
        Zeroes in place: ``cache`` is this request's own copy."""
        ln = int(cache_len[0]) - self.chunk
        for a in cache.values():
            a[:, :, ln:] = 0
        return cache, torch.tensor([ln], dtype=torch.int32, device=self._dev)

    # -- accounting -----------------------------------------------------------
    @property
    def n_snapshots(self) -> int:
        return self.snapshots.n_snapshots

    @property
    def n_snapshot_evictions(self) -> int:
        return self.snapshots.n_evictions

    def snapshot_bytes(self) -> int:
        return self.snapshots.snapshot_bytes()

    def aggregate_stats(self) -> AggregateStats:
        """Fleet-level view in the scheduler service's shape: one request =
        one run, one prompt chunk = one work unit (skipped = prefill reuse).
        Reconstructed from the canonical ``repro_serve_*`` registry series."""
        wall = (
            (self._t_last - self._t_first)
            if self._t_first is not None and self._t_last
            else 0.0
        )
        m = self._sm
        return AggregateStats(
            runs=int(m.requests.value),
            wall_seconds=max(wall, 0.0),
            busy_seconds=m.busy.value,
            units_total=int(m.chunks.value),
            units_skipped=int(m.chunks_skipped.value),
            stored=int(m.stored.value),
        )
