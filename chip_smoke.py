#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving and training paths on one NVIDIA H100.

    python3 chip_smoke.py

In order it: prints the card's name and power limit; builds every CUDA
kernel of the port from the sources in this checkout (one nvcc per source,
all at once); holds the decode-attention kernels against their plain torch
versions on the card at TinyLlama-1.1B's attention shapes (and gemma3-like
and smoke shapes), with the kernels', the plain versions' and a library
call's times: the split variant at every shape, at one query row per
sequence also the fused variant (new K/V row written, splits combined in a
cluster) and at the bf16 chunk shapes also the chunk variant (the chunk's
K/V rows written, ``wgmma``), both with written caches and reruns equal bit
for bit; serves six full-width TinyLlama-1.1B requests (bf16, random weights
from a seeded CUDA generator) through ``repro_torch.serve.ServeEngine``,
which prefills chunks eagerly (chunk variant, no index write) and decodes by
replaying a CUDA graph of ``decode_step`` (fused variant), counting each
variant's kernels, and times eager ``decode_step`` against graph replays
from one cache state; checks an fp32 smoke engine on the card (graph
replays; its chunks on the split variant) against the same engine on the
CPU, token for token; prints ptxas's registers and spills for each
``wgmma`` flash kernel; holds the flash-attention kernels (forward: out and
logsumexp; backward: dq, dk, dv) against the plain version plus autograd at
the training shape, gemma3-4b's local and global layers (dh 256), head dims
192 and 136 at G 2 and 8, a dh-256 shape at G 3 (the ``wmma`` kernels),
and smoke and ragged shapes, with their times and the variant (``wgmma``,
``wmma`` or ``fma``) that each shape takes; trains
full-width TinyLlama-1.1B (bf16, B 4 x S 2048) for one warm-up and three
timed steps through ``build_train_step``, counting the flash launches by
variant (all must be ``wgmma``), and profiles one more step; trains an fp32
smoke model five steps on the card and on the CPU and compares them; runs
``TrainDriver`` with checkpoints and an injected failure on the card; and
prefills 2,048 tokens at full width (every flash call ``wgmma``) and
profiles one more prefill, then checks ``prefill`` (flash kernel) against a chain of
``prefill_chunk`` calls (chunk kernel) of the same 576 tokens at full width,
and against a chain on a smoke model (split kernel).  Then gemma3-4b at full
width (dh 256, bf16, 4.55B parameters): a 2,048-token prefill through all 34
layers (every flash call ``wgmma``), profiled once more; one forward and
backward at the reference's init through the flash kernels and through the
plain version, whose gradient norms are held against each other; a train
step at full depth (B 1 x S 2048, remat full, two warm-up and three timed);
and a 6-layer model whose card logits (bf16) are held against the CPU
port's in fp32.

Then the recsys and GNN paths: it holds the embedding-bag kernel against its
plain version at the FM, DCN-v2 and retrieval lookup shapes over the
full-size tables (and a SASRec-like mean and a smoke case); serves FM,
DCN-v2, BST and SASRec at full width through ``build_serve_step`` at
``serve_p99``, ``serve_bulk`` and ``retrieval_cand``, counting the kernel's
launches and profiling one ``serve_p99`` call per model, and checks the fp32
smoke models on the card against the CPU; builds the gated aggregation's
row-pointer (CSR) index on the card under the sync debug mode (any read back
to the host fails) and holds the aggregation kernels (forward with num and
den; one backward launch for dgates and dh) against their plain versions
plus autograd on both layouts, the CSR index and the padded-ELL contract,
at the ``minibatch_lg`` block, a Cora-scale graph and a smoke graph, and on
the CSR index alone over the whole synthetic power-law graph (232,965 nodes,
11,461,589 edges, hubs of tens of thousands of edges) and a uniform graph of
the same size (its control, with no hub), and checks that two
backward runs give equal bits (each kernel's device time is read back to
back under the profiler and by CUDA events behind a device sleep that hides
the host, also with the L2 evicted before each call, beside each layout's
bound and the ``index_add_`` form of the reference model's segment sums; the
ELL forward once more with every gate nonzero, a control for the block's
zero padding gates); and trains
full-width GatedGCN through ``build_train_step`` on ``minibatch_lg`` blocks
sampled from that graph (one warm-up, three timed steps, one profiled;
every aggregation launch must run on the CSR index), times the index build
alone, takes one ``full_graph_sm`` step, and trains an fp32 smoke
GatedGCN five steps on the card and on the CPU and compares them.

It needs a CUDA card and the ``repro_torch`` package beside it (under
``src/``); without either it fails before printing any result.  Any failed
check exits non-zero.  The last line is a JSON object naming the device.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
PEAK_OPS_PER_S = {torch.float32: 67e12, torch.bfloat16: 989e12}  # dense, per input type


class CheckFailed(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise CheckFailed(what)


def assert_close_ratio(got: torch.Tensor, ref: torch.Tensor, tol: float) -> tuple[float, float]:
    """(max abs err, worst err / (tol + tol * |ref|)): torch.testing's rule
    with atol = rtol = tol."""
    diff = (got.float() - ref).abs()
    return diff.max().item(), (diff / (tol + tol * ref.abs())).max().item()


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean milliseconds per call, by CUDA events around ``iters`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


# --------------------------------------------------------------------------
# phase: kernel against its plain version
# --------------------------------------------------------------------------
# (label, B, S, T, Hq, Hkv, dh, q_start per sequence, window)
KERNEL_CASES = [
    ("decode B1", 1, 1, 1024, 32, 4, 64, [575], None),
    ("decode B4", 4, 1, 1024, 32, 4, 64, [575, 100, 1000, 7], None),
    ("prefill B1", 1, 64, 1024, 32, 4, 64, [512], None),
    ("prefill B4", 4, 64, 1024, 32, 4, 64, [0, 64, 448, 960], None),
    ("gemma3-like local", 2, 64, 1024, 8, 4, 256, [700, 300], 256),
    ("smoke decode", 1, 1, 256, 8, 2, 8, [150], None),
    ("smoke prefill", 2, 16, 256, 8, 2, 8, [0, 200], None),
]
MAIN_CASE = "decode B1"  # the shape of every decode step on the main path
# the engine's prefill_chunk call (chunk 64 at q_start 512 over max_len 1024):
# the chunk variant's shape on the main path
CHUNK_CASE = "prefill B1"
# the split variant's path now: fp32 chunks of the smoke models (dh 8)
SPLIT_CASE = "smoke prefill"


def visible_keys(q_start: list[int], S: int, T: int, window: int | None) -> int:
    """Keys some query row of each sequence can see, summed over sequences."""
    n = 0
    for qs in q_start:
        hi = min(T - 1, qs + S - 1)
        lo = max(0, qs - window + 1) if window else 0
        n += max(0, hi - lo + 1)
    return n


def attended_pairs(q_start: list[int], S: int, T: int, window: int | None) -> int:
    """(query row, key) pairs that are unmasked, per (b, query head)."""
    n = 0
    for qs in q_start:
        for s in range(S):
            qp = qs + s
            lo = max(0, qp - window + 1) if window else 0
            n += max(0, min(T - 1, qp) - lo + 1)
    return n


def bound_ms(case, dtype, writes: bool = False) -> tuple[float, str]:
    """Least time: bytes moved (q, visible K/V and q_start read once, out
    written once; writes: the S new K/V rows a sequence also written into the
    cache) over HBM rate, or operations (2 per multiply-add in QK^T and PV
    over the unmasked pairs) over the peak rate for the input type."""
    _, B, S, T, Hq, Hkv, dh, q_start, window = case
    isz = torch.finfo(dtype).bits // 8
    nbytes = (2 * B * S * Hq * dh + 2 * visible_keys(q_start, S, T, window) * Hkv * dh) * isz
    nbytes += 4 * B
    if writes:  # the new rows are read from k_new/v_new instead of the cache, and written
        nbytes += 2 * B * S * Hkv * dh * isz
    ops = 4 * attended_pairs(q_start, S, T, window) * Hq * dh
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def library_call(q, k, v, q_start, window):
    """One PyTorch call computing the same function (timed as a yardstick
    only; the port never calls it)."""
    B, S, Hq, dh = q.shape
    T = k.shape[1]
    kpos = torch.arange(T, device=q.device)
    qpos = q_start.long()[:, None] + torch.arange(S, device=q.device)[None, :]
    mask = kpos[None, None, :] <= qpos[:, :, None]
    if window:
        mask &= kpos[None, None, :] > qpos[:, :, None] - window
    mask = mask[:, None]  # [B,1,S,T]
    out = torch.nn.functional.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        attn_mask=mask, enable_gqa=True,
    )
    return out.transpose(1, 2)


def phase_kernels(dev) -> dict:
    from repro_torch.kernels.decode_attention import ops

    results, written = {}, {}
    gen = torch.Generator(device=dev).manual_seed(1234)
    for case in KERNEL_CASES:
        label, B, S, T, Hq, Hkv, dh, qs_list, window = case
        for dtype in (torch.float32, torch.bfloat16):
            q = torch.randn(B, S, Hq, dh, generator=gen, device=dev).to(dtype)
            k = torch.randn(B, T, Hkv, dh, generator=gen, device=dev).to(dtype)
            v = torch.randn(B, T, Hkv, dh, generator=gen, device=dev).to(dtype)
            q_start = torch.tensor(qs_list, dtype=torch.int32, device=dev)
            got = ops.decode_attention(q, k, v, q_start, window=window)
            want = ops.decode_attention_plain(q, k, v, q_start, window=window)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            tol = TOL[dtype]
            tname = str(dtype).replace("torch.", "")
            print(f"kernel check {label:18s} {tname:8s} max_abs_err {err:.3e} tol {tol:.0e}")
            check(math.isfinite(err) and err <= tol,
                  f"decode_attention {label} {tname}: max_abs_err {err} > {tol}")
            ms = cuda_ms(lambda: ops.decode_attention(q, k, v, q_start, window=window))
            plain_ms = cuda_ms(lambda: ops.decode_attention_plain(q, k, v, q_start, window=window))
            lib_ms = cuda_ms(lambda: library_call(q, k, v, q_start, window))
            dev_ms, span_ms = kernel_device_ms(
                lambda: ops.decode_attention(q, k, v, q_start, window=window))
            q_ms = queued_ms(lambda: ops.decode_attention(q, k, v, q_start, window=window))
            bms, by = bound_ms(case, dtype)
            results[(label, tname)] = dict(ms=ms, device_ms=dev_ms, span_ms=span_ms,
                                           queued_ms=q_ms, plain_ms=plain_ms,
                                           library_ms=lib_ms, bound_ms=bms, bound_by=by,
                                           max_abs_err=err)
            print(f"kernel time  {label:18s} {tname:8s} ms {ms:.6f} device_ms {dev_ms:.6f} "
                  f"device_span_ms {span_ms:.6f} queued_ms {q_ms:.6f} "
                  f"plain_ms {plain_ms:.6f} library_ms {lib_ms:.6f} bound_ms {bms:.6f} ({by})")
            var = ops.variant(S, Hq // Hkv, dh, dtype)
            if var != "split":  # the fused (S = 1) or the chunk variant takes the call
                written[(label, tname)] = written_case(ops, var, case, q, k, v, q_start, gen,
                                                       dtype, lib_ms)
    return {"cases": results, "written": written}


def written_case(ops, var, case, q, k, v, q_start, gen, dtype, lib_ms) -> dict:
    """The variant ``var`` that writes the new K/V rows and attends in one
    launch (fused: S = 1, splits combined in a cluster; chunk: S > 1,
    ``wgmma``) against its plain version on the same inputs: output within
    the tolerance, written caches and reruns equal bit for bit; then its
    times beside the split variant's."""
    label, B, S, T, Hq, Hkv, dh, qs_list, window = case
    tname = str(dtype).replace("torch.", "")
    check(ops.variant(S, Hq // Hkv, dh, dtype) == var, f"{label}: not the {var} variant")
    k_new = torch.randn(B, S, Hkv, dh, generator=gen, device=q.device).to(dtype)
    v_new = torch.randn(B, S, Hkv, dh, generator=gen, device=q.device).to(dtype)
    k_want, v_want = k.clone(), v.clone()
    want = ops.decode_attention_chunk_plain(q, k_new, v_new, k_want, v_want, q_start,
                                            window=window)
    runs = []
    for _ in range(2):
        k_got, v_got = k.clone(), v.clone()
        before = dict(ops.decode_attention.launches_by_variant)
        runs.append(ops.decode_attention_chunk(q, k_new, v_new, k_got, v_got, q_start,
                                               window=window))
        torch.cuda.synchronize()
        after = ops.decode_attention.launches_by_variant
        check(all(after[v_] - before[v_] == (1 if v_ == var else 0) for v_ in after),
              f"{var} {label} {tname}: launches {before} -> {after}")
        check(torch.equal(k_got, k_want) and torch.equal(v_got, v_want),
              f"{var} {label} {tname}: the written caches differ from the plain version's")
    err = (runs[0].float() - want.float()).abs().max().item()
    tol = TOL[dtype]
    print(f"kernel check {label:18s} {tname:8s} {var} max_abs_err {err:.3e} tol {tol:.0e} "
          f"caches bit-equal reruns bit-equal {torch.equal(runs[0], runs[1])}")
    check(math.isfinite(err) and err <= tol,
          f"{var} decode_attention {label} {tname}: max_abs_err {err} > {tol}")
    check(torch.equal(runs[0], runs[1]), f"{var} {label} {tname}: reruns differ")

    def call():  # rewrites the same rows each time: every call does the same work
        return ops.decode_attention_chunk(q, k_new, v_new, k_got, v_got, q_start, window=window)

    def plain():
        return ops.decode_attention_chunk_plain(q, k_new, v_new, k_want, v_want, q_start,
                                                window=window)

    ms = cuda_ms(call)
    plain_ms = cuda_ms(plain)
    dev_ms, span_ms = kernel_device_ms(call)
    q_ms = queued_ms(call)
    bms, by = bound_ms(case, dtype, writes=True)
    print(f"kernel time  {label:18s} {tname:8s} {var} ms {ms:.6f} device_ms {dev_ms:.6f} "
          f"device_span_ms {span_ms:.6f} queued_ms {q_ms:.6f} plain_ms {plain_ms:.6f} "
          f"library_ms {lib_ms:.6f} bound_ms {bms:.6f} ({by})")
    if var == "chunk":  # the cluster sizes beside the plan's choice (outputs checked too)
        planned = ops.plan_chunk(B, S, Hq // Hkv, Hkv, T, torch.cuda.get_device_properties(
            q.device).multi_processor_count)
        plan, sweep = ops.plan_chunk, {}
        try:
            for n in (1, 2, 4, 8):
                ops.plan_chunk = lambda *_, n=n: n
                out = call()
                e = (out.float() - want.float()).abs().max().item()
                check(math.isfinite(e) and e <= tol, f"chunk {label} at {n} splits: err {e}")
                sweep[n] = queued_ms(call)
        finally:
            ops.plan_chunk = plan
        print(f"kernel time  {label:18s} {tname:8s} chunk queued_ms by blocks a cluster "
              + " ".join(f"{n}: {t:.6f}" for n, t in sweep.items()) + f" (planned {planned})")
    return dict(ms=ms, device_ms=dev_ms, span_ms=span_ms, queued_ms=q_ms, plain_ms=plain_ms,
                library_ms=lib_ms, bound_ms=bms, bound_by=by, max_abs_err=err)


# --------------------------------------------------------------------------
# phase: full-width serving
# --------------------------------------------------------------------------
def phase_engine(dev) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import ops
    from repro_torch.models import transformer
    from repro_torch.models.layers import init_params
    from repro_torch.serve import ServeEngine

    cfg = get_config("tinyllama-1.1b")  # full width, bf16
    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_params(gen, transformer.lm_specs(cfg), cfg.dtype, dev)
    engine = ServeEngine(cfg, params, max_len=1024, chunk=64, device=dev)
    n_par = n_bytes = 0
    for t in leaves(params):
        n_par += t.numel()
        n_bytes += t.numel() * t.element_size()
    print(f"engine: {cfg.name} params {n_par} bytes {n_bytes} decode bound "
          f"(weights read once per token) {n_bytes / HBM_BYTES_PER_S * 1e3:.6f} ms")

    # every logits tensor the engine computes (prefill chunks and graph
    # replays) is checked for finiteness on the device; the flags are read
    # once at the end
    finite: list[torch.Tensor] = []
    inner_prefill, inner_replay = engine._prefill, engine._replay

    def watched_prefill(tok, cache, cache_len):
        out = inner_prefill(tok, cache, cache_len)
        finite.append(torch.isfinite(out[0]).all())
        return out

    def watched_replay(graph, token):
        logits = inner_replay(graph, token)
        finite.append(torch.isfinite(logits).all())
        return logits

    engine._prefill, engine._replay = watched_prefill, watched_replay
    # the index writes a chunk would take before the split kernel: none on
    # this path, since the chunk kernel writes its rows itself
    index_writes = [0]
    inner_insert = ops.insert_chunk

    def counted_insert(*args, **kwargs):
        index_writes[0] += 1
        return inner_insert(*args, **kwargs)

    ops.insert_chunk = counted_insert

    rng = np.random.default_rng(0)
    system = rng.integers(0, cfg.vocab, size=512).tolist()
    prompts = [system + rng.integers(0, cfg.vocab, size=64).tolist() for _ in range(6)]
    max_new = 32
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launches()
    by_var = ops.decode_attention.launches_by_variant
    rows = []
    for i, prompt in enumerate(prompts):
        before = dict(by_var)
        out, st = engine.generate(prompt, max_new_tokens=max_new)
        split, fused, chunk = (by_var[v] - before[v] for v in ("split", "fused", "chunk"))
        trimmed = 1 if st.chunks_skipped == st.n_chunks else 0
        chunk_calls = (st.n_chunks - st.chunks_skipped) + trimmed
        # the first decode warms up one eager step, then captures the graph
        steps = st.n_new_tokens + (1 if i == 0 else 0)
        mem = torch.cuda.max_memory_allocated(dev)
        chunk_ms = st.prefill_s * 1e3 / chunk_calls
        tps = st.n_new_tokens / st.decode_s
        print(f"req {i + 1}: chunks_skipped {st.chunks_skipped}/{st.n_chunks} "
              f"prefill_ms {st.prefill_s * 1e3:.3f} prefill_ms_per_chunk_call {chunk_ms:.3f} "
              f"decode_ms {st.decode_s * 1e3:.3f} "
              f"decode_ms_per_token {st.decode_s * 1e3 / st.n_new_tokens:.6f} "
              f"decode_tok_s {tps:.2f} max_memory_allocated {mem} "
              f"kernels chunk {chunk} split {split} fused {fused}")
        check(len(out) == max_new, f"request {i + 1}: {len(out)} tokens, wanted {max_new}")
        check(chunk == cfg.n_layers * chunk_calls,
              f"request {i + 1}: {chunk} chunk kernels, wanted {cfg.n_layers} x {chunk_calls}")
        check(split == 0, f"request {i + 1}: {split} split kernels, wanted none")
        check(fused == cfg.n_layers * steps,
              f"request {i + 1}: {fused} fused kernels, wanted {cfg.n_layers} x {steps}")
        rows.append(dict(skipped=st.chunks_skipped, n=st.n_chunks, prefill_s=st.prefill_s,
                         decode_s=st.decode_s, tokens=st.n_new_tokens))
    launches = dict(by_var)
    ops.insert_chunk = inner_insert
    graph = engine._graph
    print(f"engine: kernels {launches} index writes {index_writes[0]} graph holds "
          f"{graph.kernels} snapshots {engine.n_snapshots}")
    check(index_writes[0] == 0, f"{index_writes[0]} index writes of chunk rows on the main path")
    check(graph.kernels == {"fused": cfg.n_layers},
          f"the decode graph holds {graph.kernels}, wanted {cfg.n_layers} fused kernels")
    for i in range(2, 6):
        check(rows[i]["skipped"] > 0, f"request {i + 1} skipped no chunk")
    check(bool(torch.stack(finite).all()), "non-finite logits on the main path")
    steady = rows[1:]
    graph_ms = sum(r["decode_s"] for r in steady) * 1e3 / sum(r["tokens"] for r in steady)
    eager_ms, replay_ms = decode_yardstick(engine, max_new)
    print(f"engine: decode ms per token (requests 2-6, graph) {graph_ms:.6f}; at one state, "
          f"replay {replay_ms:.6f} eager decode_step {eager_ms:.6f} "
          f"(eager / replay {eager_ms / replay_ms:.3f})")
    prof = phase_profile(engine, prompts[-1], max_new)
    # the watchers close over the engine: without them it is freed on return,
    # with its graph, the graph's memory pool and the static cache, before the
    # later phases measure their peak memory
    del engine._prefill, engine._replay
    return {"launches": launches, "rows": rows, "graph_ms": graph_ms, "eager_ms": eager_ms,
            "replay_ms": replay_ms, "profile": prof}


def decode_yardstick(engine, n: int) -> tuple[float, float]:
    """ms per token of ``n`` greedy steps from one cache state (the graph's
    state after the last request), eager ``transformer.decode_step`` and
    graph replays, each step's argmax read on the host as the engine reads
    it: (eager, replay).  Runs after the main path's counts were read."""
    from repro_torch.models import transformer

    graph = engine._graph
    state = {k: a.clone() for k, a in graph.cache.items()}
    state_len = graph.cache_len.clone()
    first = int(torch.argmax(graph.logits[0]))

    def eager():
        cache = {k: a.clone() for k, a in state.items()}
        cache_len, nxt = state_len.clone(), first
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            tok = torch.tensor([[nxt]], dtype=torch.int64, device=cache_len.device)
            logits, cache, cache_len = transformer.decode_step(
                engine.params, engine.cfg, tok, cache, cache_len)
            nxt = int(torch.argmax(logits[0]))
        return (time.perf_counter() - t0) * 1e3 / n

    def replay():
        graph.load(state, state_len)
        nxt = first
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            nxt = int(torch.argmax(graph.step(nxt)[0]))
        return (time.perf_counter() - t0) * 1e3 / n

    with torch.inference_mode():  # the graph's static buffers are inference tensors
        eager()  # warm-up
        times = [eager(), replay(), replay(), eager()]  # in turns
    return (times[0] + times[3]) / 2, (times[1] + times[2]) / 2


# --------------------------------------------------------------------------
# phase: where one request's time goes
# --------------------------------------------------------------------------
def device_events(prof) -> list:
    return [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]


def phase_profile(engine, prompt, max_new: int) -> dict:
    """One more request of the stream under torch.profiler (after the main
    path's launch count was read)."""
    stats = {}

    def request():
        _, stats["st"] = engine.generate(prompt, max_new_tokens=max_new)

    prof = profile_call("request", request, n_kernels=8,
                        watch=("decode_attention_chunk_kernel", "decode_attention_fused_kernel"))
    st = stats["st"]
    print(f"profile request: chunks_skipped {st.chunks_skipped}/{st.n_chunks} "
          f"new_tokens {st.n_new_tokens}")
    return prof


DEVICE_SLEEP_CYCLES = 100_000_000  # about 50 ms at the H100's 1.98 GHz


def kernel_device_ms(fn, iters: int = 20, by_kernel: dict | None = None) -> tuple[float, float]:
    """Device time per call of the kernels ``fn`` launches, from the
    profiler's kernel records of back-to-back calls queued behind a device
    sleep: (their summed durations, the span from the first start to the
    last end), each over ``iters``.  ``by_kernel``, where given, receives
    the summed durations per kernel function (its name without template
    arguments), over ``iters``."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(DEVICE_SLEEP_CYCLES)
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    evs = sorted(device_events(prof), key=lambda e: e.time_range.start)[1:]  # [0]: the sleep
    if not evs:
        return float("nan"), float("nan")
    total = sum(e.time_range.elapsed_us() for e in evs)
    span = max(e.time_range.end for e in evs) - evs[0].time_range.start
    if by_kernel is not None:
        for e in evs:
            m = re.search(r"(\w+)[<(]", e.name.replace("(anonymous namespace)::", ""))
            name = m.group(1) if m else e.name
            by_kernel[name] = by_kernel.get(name, 0.0) + e.time_range.elapsed_us() / iters / 1e3
    return total / iters / 1e3, span / iters / 1e3


def queued_ms(fn, iters: int = 10) -> float:
    """Milliseconds per call by CUDA events around back-to-back calls that
    are queued behind a device sleep, so the host's launch work is hidden
    and the events time the device alone."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(DEVICE_SLEEP_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


L2_FLUSH_BYTES = 256 * 2**20  # five times the H100's 50 MB L2


def flushed_ms(fn, iters: int = 10) -> float:
    """Milliseconds per call by CUDA events around each call alone, each
    after a read of a 256 MB buffer that evicts the L2, all queued behind a
    device sleep so that the events time the device alone."""
    buf = torch.ones(L2_FLUSH_BYTES // 4, device="cuda")
    fn()
    torch.cuda.synchronize()
    pairs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
             for _ in range(iters)]
    torch.cuda._sleep(DEVICE_SLEEP_CYCLES)
    for start, end in pairs:
        buf.sum()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(start.elapsed_time(end) for start, end in pairs) / iters


# --------------------------------------------------------------------------
# phase: device path against the CPU path
# --------------------------------------------------------------------------
def leaves(tree):
    """Leaves in sorted-key order (the order the store rebuilds dicts in)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k])
    elif isinstance(tree, list):
        for v in tree:
            yield from leaves(v)
    else:
        yield tree


def cpu_f32(tree):
    """A tree of tensors copied to the CPU in fp32."""
    if isinstance(tree, dict):
        return {k: cpu_f32(v) for k, v in tree.items()}
    return tree.detach().cpu().float()


def to_device(tree, dev):
    if isinstance(tree, dict):
        return {k: to_device(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_device(v, dev) for v in tree]
    return tree.to(dev)


def smoke_stream(vocab: int) -> list[list[int]]:
    rng = np.random.default_rng(0)
    system = rng.integers(0, vocab, size=48).tolist()
    prompts = [system + rng.integers(0, vocab, size=16).tolist() for _ in range(6)]
    # the system prompt alone, twice: with chunk 16 it is the stored 3-chunk
    # prefix, so every chunk is restored and the engine re-runs the last one
    # to get logits (the full-hit path)
    return prompts + [system, system]


def phase_parity(dev) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.decode_attention.ops import reset_launches
    from repro_torch.models.layers import init_params
    from repro_torch.models.transformer import lm_specs
    from repro_torch.serve import ServeEngine

    cfg = dataclasses.replace(get_config("tinyllama-1.1b", smoke=True), dtype=torch.float32)
    gen = torch.Generator(device="cpu").manual_seed(0)
    cpu_params = init_params(gen, lm_specs(cfg), cfg.dtype, "cpu")
    dev_params = to_device(cpu_params, dev)
    on_dev = ServeEngine(cfg, dev_params, max_len=128, chunk=16, device=dev)
    on_cpu = ServeEngine(cfg, cpu_params, max_len=128, chunk=16, device="cpu")
    reset_launches()
    for i, prompt in enumerate(smoke_stream(cfg.vocab)):
        a, sa = on_dev.generate(prompt, max_new_tokens=8)
        b, sb = on_cpu.generate(prompt, max_new_tokens=8)
        print(f"parity req {i + 1}: chunks_skipped card {sa.chunks_skipped}/{sa.n_chunks} "
              f"cpu {sb.chunks_skipped}/{sb.n_chunks} tokens_equal {a == b}")
        check(a == b, f"parity request {i + 1}: device tokens {a} != cpu tokens {b}")
        check(sa.chunks_skipped == sb.chunks_skipped,
              f"parity request {i + 1}: chunks_skipped {sa.chunks_skipped} != {sb.chunks_skipped}")
        if i >= 6:
            check(sa.chunks_skipped == sa.n_chunks, f"parity request {i + 1} was not a full hit")
    after = dict(decode_attention.launches_by_variant)
    print(f"parity: decode kernels on the card {after}")
    check(after["split"] > 0 and after["fused"] > 0 and after["chunk"] == 0,
          f"the fp32 device engine did not run its chunks on the split kernel and its decode "
          f"steps on the fused kernel: {after}")
    check(on_dev._graph is not None and on_dev._graph.kernels == {"fused": cfg.n_layers},
          "the device engine did not decode through its CUDA graph")
    return after


# --------------------------------------------------------------------------
# phase: flash-attention kernels against the plain version plus autograd
# --------------------------------------------------------------------------
# (label, B, S, Hq, Hkv, dh, causal, window): TinyLlama's train shape,
# gemma3-4b's local (window 1024) and global layers at full width, head dims
# of three 64-column chunks (192, and 136: mostly padding) at G 2 and 8,
# gemma3's local layer at G 3 (a group that does not divide 64: the WMMA
# kernels), and the smoke and ragged shapes
FLASH_CASES = [
    ("train", 4, 2048, 32, 4, 64, True, None),
    ("gemma3-like", 1, 2048, 8, 4, 256, True, 1024),
    ("gemma3 global", 1, 2048, 8, 4, 256, True, None),
    ("dh192 G2", 1, 2048, 8, 4, 192, True, None),
    ("dh192 G8", 1, 2048, 32, 4, 192, True, None),
    ("dh136 G2", 1, 2048, 8, 4, 136, True, None),
    ("dh136 G8", 1, 2048, 32, 4, 136, True, None),
    ("dh256 G3", 1, 2048, 6, 2, 256, True, 1024),
    ("smoke", 2, 64, 8, 2, 8, True, None),
    ("non-causal S200", 2, 200, 8, 2, 64, False, None),
]
FLASH_MAIN = "train"  # the shape of every attention call of the train step
GEMMA_LOCAL, GEMMA_GLOBAL = "gemma3-like", "gemma3 global"  # gemma3-4b's attention calls
FLASH_WMMA = "dh256 G3"  # the one bf16 case on the WMMA kernels


def flash_pairs(S: int, causal: bool, window: int | None) -> int:
    """(query, key) pairs that are unmasked, per (b, query head)."""
    n = 0
    for s in range(S):
        hi = s if causal else S - 1
        lo = max(0, s - window + 1) if window else 0
        n += hi - lo + 1
    return n


def flash_bound_ms(case, dtype, backward: bool) -> tuple[float, str]:
    """Least time.  Bytes: forward reads q, k, v once and writes out and the
    fp32 logsumexp; backward reads q, k, v, out, dout and the logsumexp and
    writes dq, dk, dv.  Operations (2 per multiply-add over the unmasked
    pairs): forward Q.K and P.V (4 per pair and head dim); backward
    dO.V, P.dO, dS.K and dS.Q (8; the recomputation of Q.K is not counted).
    The peak is the rate for the input type."""
    _, B, S, Hq, Hkv, dh, causal, window = case
    isz = torch.finfo(dtype).bits // 8
    qo = B * S * Hq * dh * isz
    kv = B * S * Hkv * dh * isz
    lse = B * Hq * S * 4
    nbytes = (2 * qo + 2 * kv + lse) if not backward else (4 * qo + 4 * kv + lse)
    ops = (8 if backward else 4) * B * Hq * dh * flash_pairs(S, causal, window)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sdpa(q, k, v, causal, window):
    """One PyTorch call computing the same function (timed as a yardstick
    only; the port never calls it)."""
    F = torch.nn.functional
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    if window is None:
        out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal, enable_gqa=True)
    else:
        S = q.shape[1]
        pos = torch.arange(S, device=q.device)
        mask = pos[None, :] > pos[:, None] - window
        if causal:
            mask &= pos[None, :] <= pos[:, None]
        out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, enable_gqa=True)
    return out.transpose(1, 2)


def flash_oracle(q, k, v, dout, causal, window):
    """The plain version plus autograd, in fp32 on the same values: for bf16
    inputs the tolerance then measures the kernel's rounding alone."""
    from repro_torch.kernels.flash_attention import attention_lse_ref, attention_ref

    q32, k32, v32 = (t.detach().float().requires_grad_(True) for t in (q, k, v))
    out = attention_ref(q32, k32, v32, causal=causal, window=window)
    dq, dk, dv = torch.autograd.grad(out, (q32, k32, v32), dout.float())
    lse = attention_lse_ref(q32.detach(), k32.detach(), causal=causal, window=window)
    return out.detach(), lse, dq, dk, dv


def backward_ms(out, inputs, dout, iters) -> float:
    """Milliseconds per autograd backward through an already built graph."""
    return cuda_ms(lambda: torch.autograd.grad(out, inputs, dout, retain_graph=True),
                   iters=iters, warmup=2)


def print_ptxas() -> None:
    """ptxas's registers and spills for each wgmma flash kernel as built."""
    from repro_torch.kernels import build

    for row in build.ptxas_report("flash_attention"):
        if "wgmma" in row["kernel"]:
            print(f"ptxas {row['kernel']}: registers {row['registers']} spill stores "
                  f"{row['spill_stores']} B loads {row['spill_loads']} B")


def phase_flash(dev) -> dict:
    from repro_torch.kernels.flash_attention import attention_ref
    from repro_torch.kernels.flash_attention import ops

    print_ptxas()
    results = {}
    gen = torch.Generator(device=dev).manual_seed(4321)
    for case in FLASH_CASES:
        label, B, S, Hq, Hkv, dh, causal, window = case
        iters = 10 if S >= 1024 else 50
        for dtype in (torch.float32, torch.bfloat16):
            tname = str(dtype).replace("torch.", "")
            q = torch.randn(B, S, Hq, dh, generator=gen, device=dev).to(dtype)
            k = torch.randn(B, S, Hkv, dh, generator=gen, device=dev).to(dtype)
            v = torch.randn(B, S, Hkv, dh, generator=gen, device=dev).to(dtype)
            dout = torch.randn(B, S, Hq, dh, generator=gen, device=dev).to(dtype)
            want = flash_oracle(q, k, v, dout, causal, window)
            out, lse = ops.flash_attention_fwd(q, k, v, causal=causal, window=window)
            grads = ops.flash_attention_bwd(q, k, v, out, lse, dout, causal=causal,
                                            window=window)
            torch.cuda.synchronize()
            tol = TOL[dtype]
            errs = {"fwd": 0.0, "bwd": 0.0}
            for name, got, ref in zip(("out", "lse", "dq", "dk", "dv"), (out, lse, *grads),
                                      want):
                err, ratio = assert_close_ratio(got, ref, tol)
                print(f"flash check {label:16s} {tname:8s} {name:3s} max_abs_err {err:.3e} "
                      f"tol atol=rtol={tol:.0e} worst err/(atol+rtol*|ref|) {ratio:.3f}")
                check(math.isfinite(err) and ratio <= 1.0,
                      f"flash_attention {label} {tname} {name}: max_abs_err {err}, "
                      f"worst ratio {ratio} > 1")
                kind = "fwd" if name in ("out", "lse") else "bwd"
                errs[kind] = max(errs[kind], err)
            del want
            fwd = lambda: ops.flash_attention_fwd(q, k, v, causal=causal, window=window)
            bwd = lambda: ops.flash_attention_bwd(q, k, v, out, lse, dout, causal=causal,
                                                  window=window)
            row = {"variant": ops.variant(dtype, dh, Hq // Hkv)}
            want_var = ("fma" if dtype == torch.float32 else
                        "wmma" if label == FLASH_WMMA else "wgmma")
            check(row["variant"] == want_var,
                  f"flash {label} {tname}: variant {row['variant']}, wanted {want_var}")
            for kind, fn in (("fwd", fwd), ("bwd", bwd)):
                bms, by = flash_bound_ms(case, dtype, kind == "bwd")
                split: dict[str, float] = {}
                dms, sms = kernel_device_ms(fn, iters=min(iters, 10), by_kernel=split)
                row[kind] = dict(ms=cuda_ms(fn, iters=iters, warmup=2), device_ms=dms, span_ms=sms,
                                 queued_ms=queued_ms(fn), bound_ms=bms, bound_by=by,
                                 max_abs_err=errs[kind], device_ms_by_kernel=split)
            qg, kg, vg = (t.clone().requires_grad_(True) for t in (q, k, v))
            row["fwd"]["plain_ms"] = cuda_ms(
                lambda: attention_ref(q, k, v, causal=causal, window=window), iters=iters,
                warmup=2)
            row["fwd"]["library_ms"] = cuda_ms(lambda: sdpa(q, k, v, causal, window),
                                               iters=iters, warmup=2)
            plain_out = attention_ref(qg, kg, vg, causal=causal, window=window)
            row["bwd"]["plain_ms"] = backward_ms(plain_out, (qg, kg, vg), dout, iters)
            del plain_out
            lib_out = sdpa(qg, kg, vg, causal, window)
            row["bwd"]["library_ms"] = backward_ms(lib_out, (qg, kg, vg), dout, iters)
            del lib_out
            for kind in ("fwd", "bwd"):
                r = row[kind]
                print(f"flash time  {label:16s} {tname:8s} {row['variant']:5s} {kind} "
                      f"ms {r['ms']:.6f} "
                      f"device_ms {r['device_ms']:.6f} device_span_ms {r['span_ms']:.6f} "
                      f"queued_ms {r['queued_ms']:.6f} "
                      f"plain_ms {r['plain_ms']:.6f} "
                      f"library_ms {r['library_ms']:.6f} bound_ms {r['bound_ms']:.6f} "
                      f"({r['bound_by']}); device_ms by kernel "
                      + " ".join(f"{k} {v:.6f}" for k, v in r["device_ms_by_kernel"].items()))
            results[(label, tname)] = row
            del q, k, v, dout, out, lse, grads, qg, kg, vg
            torch.cuda.empty_cache()
    return {"cases": results}


# --------------------------------------------------------------------------
# phase: full-width training
# --------------------------------------------------------------------------
def lm_batch(vocab: int, B: int, S: int, step: int, dev) -> dict:
    """Batch ``step`` as the training driver makes it (numpy seed = step)."""
    r = np.random.default_rng(step)
    toks = r.integers(0, vocab, size=(B, S + 1)).astype(np.int32)
    return {"tokens": torch.from_numpy(toks[:, :-1].copy()).to(dev),
            "targets": torch.from_numpy(toks[:, 1:].copy()).to(dev)}


def profile_call(label: str, fn, n_kernels: int = 10, watch: tuple[str, ...] = ()) -> dict:
    """``fn`` once under torch.profiler: wall time, the device's busy and
    idle share, the kernels that take the device time, and the time and
    count of the kernels whose names hold a string of ``watch``."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    evs = device_events(prof)
    if not evs:
        print(f"profile {label}: the profiler saw no device events; idle share not measured")
        return {}
    busy_us = sum(e.time_range.elapsed_us() for e in evs)
    by_name: dict[str, float] = {}
    for e in evs:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    print(f"profile {label}: wall_ms {wall_us / 1e3:.3f} device_busy_ms {busy_us / 1e3:.3f} "
          f"device_idle_share {1 - busy_us / wall_us:.4f} device_kernels {len(evs)}")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:n_kernels]:
        print(f"profile {label}: {us / 1e3:10.3f} ms {us / busy_us:7.2%} {name[:100]}")
    for w in watch:
        hits = [e.time_range.elapsed_us() for e in evs if w in e.name]
        print(f"profile {label}: {w}: {sum(hits) / 1e3:.3f} ms {sum(hits) / busy_us:.2%} "
              f"of busy in {len(hits)} kernels")
    return {"wall_ms": wall_us / 1e3, "busy_ms": busy_us / 1e3,
            "idle_share": 1 - busy_us / wall_us}


def phase_train(dev) -> dict:
    from repro_torch.configs import ShapeCell, get_config
    from repro_torch.kernels.flash_attention import flash_attention, reset_launches, variant
    from repro_torch.models.layers import init_params
    from repro_torch.models.transformer import lm_specs
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import build_train_step, make_train_state

    cfg = get_config("tinyllama-1.1b")  # full width, bf16
    B, S = 4, 2048
    cell = ShapeCell("train", "train", {"seq_len": S, "global_batch": B})
    gen = torch.Generator(device=dev).manual_seed(0)
    state = make_train_state(init_params(gen, lm_specs(cfg), cfg.dtype, dev))
    step = build_train_step(cfg, cell, AdamWConfig(warmup_steps=10, total_steps=100),
                            remat="none")
    batches = [lm_batch(cfg.vocab, B, S, i, dev) for i in range(5)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    rows = []
    for i in range(4):  # one warm-up step, three timed
        f0, b0 = flash_attention.launches_fwd, flash_attention.launches_bwd
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batches[i])
        m = {k: float(v) for k, v in m.items()}  # waits for the device
        dt = time.perf_counter() - t0
        nf, nb = flash_attention.launches_fwd - f0, flash_attention.launches_bwd - b0
        tag = "warm-up" if i == 0 else f"step {i}"
        print(f"train {tag}: loss {m['loss']:.6f} grad_norm {m['grad_norm']:.6f} "
              f"lr {m['lr']:.6e} step_ms {dt * 1e3:.3f} tokens_per_s {B * S / dt:.1f} "
              f"flash_fwd {nf} flash_bwd {nb}")
        check(all(math.isfinite(v) for v in m.values()), f"train {tag}: non-finite {m}")
        check(nf == cfg.n_layers and nb == cfg.n_layers,
              f"train {tag}: {nf} forward / {nb} backward flash calls, wanted {cfg.n_layers}")
        rows.append(dict(step_s=dt, **m))
    launches = (flash_attention.launches_fwd, flash_attention.launches_bwd)
    var = variant(cfg.dtype, cfg.head_dim, cfg.n_heads // cfg.n_kv_heads)
    by_var = flash_attention.launches_by_variant
    print(f"train: flash launches by variant {by_var}; the train shape's variant is {var}")
    check(var == "wgmma" and by_var["wgmma"] == {"fwd": launches[0], "bwd": launches[1]},
          f"train: not every flash call ran the wgmma kernels: {by_var}")
    mem = torch.cuda.max_memory_allocated(dev)
    timed = rows[1:]
    mean_s = sum(r["step_s"] for r in timed) / len(timed)
    print(f"train: {cfg.name} B {B} S {S} bf16 remat none: mean step_ms {mean_s * 1e3:.3f} "
          f"tokens_per_s {B * S / mean_s:.1f} max_memory_allocated {mem} "
          f"flash launches fwd {launches[0]} bwd {launches[1]}")

    def one_more():
        nonlocal state
        state, m = step(state, batches[4])
        check(math.isfinite(float(m["loss"])), "profiled step: non-finite loss")

    prof = profile_call("train step", one_more)
    del state
    torch.cuda.empty_cache()
    return {"launches": launches, "rows": rows, "mean_step_s": mean_s, "max_memory": mem,
            "profile": prof, "variant": var}


def phase_train_parity(dev) -> None:
    """Five fp32 smoke steps on the card (kernels) and on the CPU (plain
    path) from the same parameters and numpy batches."""
    from repro_torch.configs import ShapeCell, get_config
    from repro_torch.data import make_batch
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models.layers import init_params
    from repro_torch.models.transformer import lm_specs
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import build_train_step, make_train_state

    cfg = dataclasses.replace(get_config("tinyllama-1.1b", smoke=True), dtype=torch.float32)
    cell = ShapeCell("t", "train", {"seq_len": 64, "global_batch": 4})
    cpu_params = init_params(torch.Generator().manual_seed(0), lm_specs(cfg), cfg.dtype, "cpu")
    dev_state = make_train_state(to_device(cpu_params, dev))
    cpu_state = make_train_state(cpu_params)
    opt = AdamWConfig(warmup_steps=2, total_steps=5)
    dev_step, cpu_step = build_train_step(cfg, cell, opt), build_train_step(cfg, cell, opt)
    before = flash_attention.launches_fwd, flash_attention.launches_bwd
    for s in range(5):
        dev_state, a = dev_step(dev_state, make_batch(cfg, cell, seed=s, device=dev))
        cpu_state, b = cpu_step(cpu_state, make_batch(cfg, cell, seed=s, device="cpu"))
        la, lb = float(a["loss"]), float(b["loss"])
        print(f"train parity step {s + 1}: loss card {la:.7f} cpu {lb:.7f} "
              f"grad_norm card {float(a['grad_norm']):.7f} cpu {float(b['grad_norm']):.7f}")
        check(abs(la - lb) <= 1e-4 + 1e-4 * abs(lb), f"train parity step {s + 1}: loss {la} "
              f"on the card, {lb} on the CPU")
    worst = 0.0
    for pa, pb in zip(leaves(dev_state["params"]), leaves(cpu_state["params"])):
        diff = (pa.cpu() - pb).abs()
        worst = max(worst, (diff / (1e-4 + 1e-4 * pb.abs())).max().item())
    launched = (flash_attention.launches_fwd - before[0], flash_attention.launches_bwd - before[1])
    print(f"train parity: final params worst err/(1e-4+1e-4*|cpu|) {worst:.4f}; "
          f"flash launches on the card fwd {launched[0]} bwd {launched[1]}")
    check(worst <= 1.0, f"train parity: final parameters differ (worst ratio {worst})")
    check(min(launched) > 0, "train parity: the card never launched the flash kernels")


def phase_driver(dev) -> None:
    """TrainDriver + CheckpointManager on the card at smoke width: 10 steps,
    a checkpoint every 4, a failure injected at step 6."""
    from repro_torch.ckpt import CheckpointManager
    from repro_torch.configs import ShapeCell, get_config
    from repro_torch.data import make_batch
    from repro_torch.models.layers import init_params
    from repro_torch.models.transformer import lm_specs
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime import TrainDriver
    from repro_torch.train import build_train_step, make_train_state

    cfg = get_config("tinyllama-1.1b", smoke=True)  # bf16
    cell = ShapeCell("t", "train", {"seq_len": 16, "global_batch": 4})
    gen = torch.Generator(device=dev).manual_seed(0)
    state = make_train_state(init_params(gen, lm_specs(cfg), cfg.dtype, dev))
    step_fn = build_train_step(cfg, cell, AdamWConfig(warmup_steps=1, total_steps=20))
    batches = {s: make_batch(cfg, cell, seed=s, device=dev) for s in range(12)}
    with tempfile.TemporaryDirectory() as d:
        ckpt = CheckpointManager(d, keep=2, async_save=True, device=dev)
        driver = TrainDriver(train_step=step_fn, make_batch=lambda s: batches[s], ckpt=ckpt,
                             ckpt_every=4, fail_at_steps=(6,))
        final, log = driver.run(state, 10)
        restarts = [e for e in log if e.get("event") == "restart"]
        steps_run = [e["step"] for e in log if "step" in e]
        losses = [e["loss"] for e in log if "loss" in e]
        print(f"driver: restarts {restarts} steps {steps_run} "
              f"losses {[round(x, 6) for x in losses]}")
        check(len(restarts) == 1 and restarts[0]["from_step"] == 4,
              f"driver: restarts {restarts}, wanted one from step 4")
        check(steps_run[-1] == 10 and steps_run.count(5) == 2 and steps_run.count(6) == 2,
              f"driver: steps run {steps_run}")
        check(all(math.isfinite(x) for x in losses), "driver: non-finite loss")
        step, restored = ckpt.restore()
        same = all(torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16 else a,
                               b.view(torch.int16) if b.dtype == torch.bfloat16 else b)
                   for a, b in zip(leaves(restored), leaves(final)))
        print(f"driver: restored step {step} equal to the final state bit for bit: {same}")
        check(step == 10 and same, "driver: the restored state differs from the saved one")


CHAIN_CHUNKS = 9  # 64-token prefill_chunk calls held against one prefill of their tokens
CHAIN_TOL = 5e-2  # of the largest |value|: see chunk_chain


def chunk_chain(params, cfg, toks, dev) -> tuple[dict, dict]:
    """``transformer.prefill`` (flash kernel) of the first 64 * CHAIN_CHUNKS
    tokens against a chain of 64-token ``prefill_chunk`` calls (chunk kernel)
    over the engine's 1024-row cache.  Returns the errors, {"logits": (max
    abs err, largest |ref|), "k"/"v": [(max abs err, largest |ref|) per
    layer]}, and the chain's decode-attention launches by variant; fails
    unless the chain ran one chunk kernel a layer and call and no flash
    kernel.  Tolerance, held by the caller: 5e-2 of the largest |logit| and
    of each layer's largest cached |value|, as tests/test_torch_transformer.py
    holds bf16 logits and caches: a rounding difference in the hidden state
    moves every value by an amount that scales with the layer's values, not
    with each value's own size, and it grows through the layers (layer 0 is
    equal bit for bit; each later layer adds about one bf16 step)."""
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.decode_attention.ops import reset_launches
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import transformer

    n = 64 * CHAIN_CHUNKS
    plg, pc, _ = transformer.prefill(params, cfg, toks[:, :n])
    chain = transformer.init_cache(cfg, 1, 1024, dev)
    chain_len = torch.zeros(1, dtype=torch.int32, device=dev)
    torch.cuda.synchronize()
    reset_launches()
    f0 = flash_attention.launches_fwd
    for i in range(0, n, 64):
        clg, chain, chain_len = transformer.prefill_chunk(params, cfg, toks[:, i:i + 64], chain,
                                                         chain_len)
    torch.cuda.synchronize()
    launches = dict(decode_attention.launches_by_variant)
    errs = {"logits": ((plg - clg).abs().max().item(), plg.abs().max().item())}
    for name in ("k", "v"):
        ref = pc[name].float()
        diff = (chain[name][:, :, :n].float() - ref).abs()
        errs[name] = [(diff[i].max().item(), ref[i].abs().max().item())
                      for i in range(cfg.n_layers)]
    worst = {k: max(errs[k], key=lambda er: er[0] / er[1]) for k in ("k", "v")}
    print(f"prefill vs prefill_chunk chain ({cfg.name} bf16, {CHAIN_CHUNKS} chunks of 64, "
          f"wo std {params['layers']['attn']['wo'].float().std().item():.4e}): logits "
          f"max_abs_err {errs['logits'][0]:.4e} largest {errs['logits'][1]:.4e}; "
          + " ".join(f"{k} layer 0 {errs[k][0][0]:.4e} of {errs[k][0][1]:.4e}, worst layer "
                     f"{worst[k][0]:.4e} of {worst[k][1]:.4e}" for k in ("k", "v"))
          + f"; decode kernels {launches} flash launches {flash_attention.launches_fwd - f0}")
    check(launches == {"split": 0, "fused": 0, "chunk": CHAIN_CHUNKS * cfg.n_layers}
          and flash_attention.launches_fwd == f0,
          f"the prefill_chunk chain did not run one chunk kernel a layer: {launches}")
    check(chain_len.tolist() == [n], f"prefill_chunk chain length {chain_len.tolist()}")
    return errs, launches


def at_true_fan_in(params: dict, cfg) -> dict:
    """``params`` with the attention projections redrawn at 1/sqrt of their
    true fan-in: wq, wk, wv at 1/sqrt(d_model) and wo at 1/sqrt(Hq * dh)
    (the reference's init draws a 4-D projection at 1/sqrt of its head
    axis, where scores have a spread of hundreds and the softmax is an
    argmax); the other leaves are shared."""
    attn = params["layers"]["attn"]
    fan = {"wq": cfg.n_heads, "wk": cfg.n_kv_heads, "wv": cfg.n_kv_heads, "wo": cfg.head_dim}
    true_fan = {"wq": cfg.d_model, "wk": cfg.d_model, "wv": cfg.d_model,
                "wo": cfg.n_heads * cfg.head_dim}
    return {**params, "layers": {**params["layers"], "attn": {
        **attn, **{w: attn[w] * math.sqrt(fan[w] / true_fan[w]) for w in fan}}}}


def phase_prefill(dev) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.decode_attention.ops import reset_launches as reset_decode
    from repro_torch.kernels.flash_attention import flash_attention, reset_launches
    from repro_torch.models import transformer
    from repro_torch.models.layers import init_params

    cfg = get_config("tinyllama-1.1b")  # full width, bf16
    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_params(gen, transformer.lm_specs(cfg), cfg.dtype, dev)
    toks = torch.from_numpy(
        np.random.default_rng(0).integers(0, cfg.vocab, size=(1, 2048)).astype(np.int32)
    ).to(dev)
    transformer.prefill(params, cfg, toks)  # warm-up
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    logits, cache, clen = transformer.prefill(params, cfg, toks)
    ok = bool(torch.isfinite(logits).all())  # waits for the device
    ms = (time.perf_counter() - t0) * 1e3
    launches = flash_attention.launches_fwd
    print(f"prefill: {cfg.name} B 1 S 2048 bf16 ms {ms:.3f} flash launches fwd {launches} "
          f"bwd {flash_attention.launches_bwd} cache {tuple(cache['k'].shape)} "
          f"logits finite {ok}")
    check(ok, "prefill: non-finite logits")
    check(launches == cfg.n_layers and flash_attention.launches_bwd == 0,
          f"prefill: {launches} flash launches, wanted {cfg.n_layers}")
    by_var = flash_attention.launches_by_variant
    print(f"prefill: flash launches by variant {by_var}")
    check(by_var["wgmma"]["fwd"] == launches,
          f"prefill: not every flash call ran the wgmma kernels: {by_var}")
    check(clen.tolist() == [2048] and cache["k"].shape == (cfg.n_layers, 1, 2048, 4, 64),
          "prefill: cache shape or length")
    del cache, logits
    prof = profile_call("prefill", lambda: transformer.prefill(params, cfg, toks), n_kernels=8)

    # prefill (flash kernel) against a chain of 64-token prefill_chunk calls
    # (chunk kernel) of the same tokens, at full width in bf16.  With these
    # weights a 4-D projection is drawn at 1/sqrt of its head axis (the
    # reference's fan-in rule), so layer 0's scores have a std near 180 and
    # the softmax is an argmax that one bf16 step of a K row flips: past
    # layer 0 the two paths part whatever the kernels.  Held here: layer 0's
    # caches (no attention before them).  The whole chain is held with the
    # projections drawn at 1/sqrt(d_model) (wq, wk, wv) and 1/sqrt(Hq * dh)
    # (wo), where scores have a std near 1.
    cerrs, chain_launches = chunk_chain(params, cfg, toks, dev)
    check(all(cerrs[k][0][0] <= CHAIN_TOL * cerrs[k][0][1] for k in ("k", "v")),
          f"prefill_chunk chain layer-0 caches differ from prefill's: {cerrs}")
    scaled = at_true_fan_in(params, cfg)
    serrs, scaled_launches = chunk_chain(scaled, cfg, toks, dev)
    check(serrs["logits"][0] <= CHAIN_TOL * serrs["logits"][1],
          f"prefill_chunk chain logits differ from prefill's: {serrs['logits']}")
    check(all(e <= CHAIN_TOL * r for k in ("k", "v") for e, r in serrs[k]),
          f"prefill_chunk chain caches differ from prefill's: {serrs}")
    chain_launches = {v: chain_launches[v] + scaled_launches[v] for v in chain_launches}
    del params, scaled
    torch.cuda.empty_cache()

    # prefill (flash kernel) against a chain of prefill_chunk calls (split
    # kernel: fp32)
    scfg = dataclasses.replace(get_config("gemma3-4b", smoke=True), dtype=torch.float32)
    sp = init_params(torch.Generator(device=dev).manual_seed(1), transformer.lm_specs(scfg),
                     scfg.dtype, dev)
    stoks = torch.from_numpy(
        np.random.default_rng(1).integers(0, scfg.vocab, size=(2, 48)).astype(np.int32)
    ).to(dev)
    f0 = flash_attention.launches_fwd
    lg, c, cl = transformer.prefill(sp, scfg, stoks)
    chain = transformer.init_cache(scfg, 2, 64, dev)
    chain_len = torch.zeros(2, dtype=torch.int32, device=dev)
    reset_decode()
    for i in range(0, 48, 16):
        clg, chain, chain_len = transformer.prefill_chunk(sp, scfg, stoks[:, i:i + 16], chain,
                                                         chain_len)
    smoke_launches = dict(decode_attention.launches_by_variant)
    errs = [(lg - clg).abs().max().item(),
            (c["k"] - chain["k"][:, :, :48]).abs().max().item(),
            (c["v"] - chain["v"][:, :, :48]).abs().max().item()]
    print(f"prefill vs prefill_chunk chain (gemma3 smoke fp32, window 8): max_abs_err logits "
          f"{errs[0]:.3e} k {errs[1]:.3e} v {errs[2]:.3e} (tol 1e-4); flash launches "
          f"{flash_attention.launches_fwd - f0} decode kernels {smoke_launches}")
    check(max(errs) <= 1e-4 and torch.equal(cl, chain_len),
          f"prefill differs from the prefill_chunk chain: {errs}")
    check(flash_attention.launches_fwd > f0 and smoke_launches["split"] > 0,
          "prefill check: a kernel was not launched")
    return {"launches": launches, "ms": ms, "profile": prof, "chain_errs": serrs,
            "chain_launches": chain_launches, "smoke_chain_launches": smoke_launches}


# --------------------------------------------------------------------------
# phase: gemma3-4b at full width (head dim 256)
# --------------------------------------------------------------------------
GEMMA_SEQ = 2048
GEMMA_CYCLE = 6  # layers of one 5:1 local:global cycle: the model check's depth
GEMMA_CHECK_SEQ = 1152  # the model check's tokens: past the local window of 1024
GEMMA_CHECK_TOL = 5e-2  # of the largest |logit|, as tests/test_torch_transformer.py holds bf16
GEMMA_GRAD_TOL = 5e-2  # the worst leaf's |g - g_fp32| / |g_fp32|, bf16 against the fp32 oracle


def gemma3_grad_witness(dev, cfg, params, label: str) -> dict:
    """One forward and backward of ``cfg`` at ``params`` (B 1 x S 2048,
    remat full, the train phase's first batch) through three attentions:
    the flash kernels, the plain version in the model's dtype (its scores
    rounded to bf16 before the softmax) and the plain version in fp32 on
    the same values (the oracle ``phase_flash`` holds the kernels against;
    the kernels too keep scores in fp32).  For each: the gradient's norm in
    fp64 and in fp32 as the optimizer takes it (``global_norm``); and the
    worst leaf's relative difference from the fp32 oracle's gradient.  At
    the reference's init the fp32 norm overflows under every attention (the
    init's doing, not the kernels'); at the true fan-in ``phase_gemma3``
    holds the kernels' gradient against the oracle's."""
    from repro_torch.configs import ShapeCell
    from repro_torch.kernels.flash_attention import attention_ref, flash_attention
    from repro_torch.models import transformer
    from repro_torch.optim.adamw import global_norm
    from repro_torch.train import build_loss_fn
    from repro_torch.tree import leaves as tree_leaves, unflatten

    cell = ShapeCell("train", "train", {"seq_len": GEMMA_SEQ, "global_batch": 1})
    loss_fn = build_loss_fn(cfg, cell, remat="full")
    batch = lm_batch(cfg.vocab, 1, GEMMA_SEQ, 0, dev)

    def plain(q, k, v, *, causal=True, window=None):
        return attention_ref(q, k, v, causal=causal, window=window)

    def plain_fp32(q, k, v, *, causal=True, window=None):
        return attention_ref(q.float(), k.float(), v.float(), causal=causal,
                             window=window).to(q.dtype)

    def run(attn):
        req = [t.detach().requires_grad_(True) for t in tree_leaves(params)]
        transformer.flash_attention = attn
        try:
            loss, _ = loss_fn(unflatten(params, req), batch)
            grads = torch.autograd.grad(loss, req)
        finally:
            transformer.flash_attention = flash_attention
        norm64 = math.sqrt(sum(torch.linalg.vector_norm(g, dtype=torch.float64).item() ** 2
                               for g in grads))
        return grads, {"loss": float(loss.detach()), "norm_fp64": norm64,
                       "norm_fp32": float(global_norm(list(grads)))}

    ref, out = run(plain_fp32)
    out = {"fp32": out}
    for name, attn in (("kernel", flash_attention), ("plain", plain)):
        grads, out[name] = run(attn)
        out[name]["worst_leaf"] = max(
            torch.linalg.vector_norm(a.float() - b.float(), dtype=torch.float64).item()
            / max(torch.linalg.vector_norm(b, dtype=torch.float64).item(), 1e-300)
            for a, b in zip(grads, ref))
        del grads
    del ref
    print(f"gemma3 grad witness, {label}: {cfg.n_layers} layers, B 1 S {GEMMA_SEQ}: " + "; ".join(
        f"{name} loss {r['loss']:.6f} grad norm fp64 {r['norm_fp64']:.6e} fp32 "
        f"{r['norm_fp32']}" + (f" worst leaf |g - g_fp32| / |g_fp32| {r['worst_leaf']:.4e}"
                               if "worst_leaf" in r else "")
        for name, r in out.items()))
    check(all(math.isfinite(r["loss"]) for r in out.values()),
          f"gemma3 grad witness: non-finite loss {out}")
    return out


def gemma3_train(dev, cfg) -> dict:
    """Two warm-up and three timed train steps of ``cfg`` (B 1 x S 2048,
    bf16 parameters and gradients, fp32 AdamW moments, every layer under
    the port's full remat), counting the flash launches of each step.  The
    attention projections are drawn at their true fan-in: under the
    reference's init the gradient's norm at 34 layers overflows fp32
    (``gemma3_grad_witness`` shows it, with the kernels and without)."""
    from repro_torch.configs import ShapeCell
    from repro_torch.kernels.flash_attention import flash_attention, reset_launches
    from repro_torch.models.layers import init_params
    from repro_torch.models.transformer import lm_specs
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import build_train_step, make_train_state

    B, S = 1, GEMMA_SEQ
    cell = ShapeCell("train", "train", {"seq_len": S, "global_batch": B})
    gen = torch.Generator(device=dev).manual_seed(0)
    state = make_train_state(at_true_fan_in(init_params(gen, lm_specs(cfg), cfg.dtype, dev),
                                            cfg))
    step = build_train_step(cfg, cell, AdamWConfig(warmup_steps=10, total_steps=100),
                            remat="full")
    batches = [lm_batch(cfg.vocab, B, S, i, dev) for i in range(5)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    rows = []
    for i in range(5):  # two warm-up steps (the allocator settles), three timed
        f0, b0 = flash_attention.launches_fwd, flash_attention.launches_bwd
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batches[i])
        m = {k: float(v) for k, v in m.items()}  # waits for the device
        dt = time.perf_counter() - t0
        nf, nb = flash_attention.launches_fwd - f0, flash_attention.launches_bwd - b0
        tag = f"warm-up {i + 1}" if i < 2 else f"step {i - 1}"
        print(f"gemma3 train {tag}: loss {m['loss']:.6f} grad_norm {m['grad_norm']:.6f} "
              f"step_ms {dt * 1e3:.3f} tokens_per_s {B * S / dt:.1f} flash_fwd {nf} "
              f"flash_bwd {nb}")
        check(all(math.isfinite(v) for v in m.values()), f"gemma3 train {tag}: non-finite {m}")
        # a forward a layer, and one more a layer where the backward recomputes it
        check(nf == 2 * cfg.n_layers and nb == cfg.n_layers,
              f"gemma3 train {tag}: {nf} forward / {nb} backward flash calls for "
              f"{cfg.n_layers} layers")
        rows.append(dict(step_s=dt, **m))
    launches = (flash_attention.launches_fwd, flash_attention.launches_bwd)
    by_var = flash_attention.launches_by_variant
    check(by_var["wgmma"] == {"fwd": launches[0], "bwd": launches[1]},
          f"gemma3 train: not every flash call ran the wgmma kernels: {by_var}")
    mem = torch.cuda.max_memory_allocated(dev)
    mean_s = sum(r["step_s"] for r in rows[2:]) / 3
    return {"launches": launches, "rows": rows, "mean_step_s": mean_s, "max_memory": mem,
            "tokens_per_s": B * S / mean_s, "depth": cfg.n_layers}


def phase_gemma3(dev) -> dict:
    """gemma3-4b (34 layers, d_model 2560, Hq 8, Hkv 4, dh 256, d_ff 10,240,
    vocab 262,144; 29 local layers with a window of 1024 and 5 global ones)
    at full width in bf16, random weights from a seeded CUDA generator: one
    2,048-token prefill (every flash call the wgmma kernels at dh 256), a
    gradient witness at the reference's init (the kernels against the
    plain version), a train step at full depth, and a 6-layer model whose
    card logits (bf16, flash kernels) are held against the CPU port's in
    fp32 on the same parameters."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention, reset_launches
    from repro_torch.models import transformer
    from repro_torch.models.layers import init_params

    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config("gemma3-4b")  # full width and depth, bf16
    windows = transformer._layer_windows(cfg)
    n_local = sum(w is not None for w in windows)
    check(cfg.head_dim == 256 and (n_local, len(windows) - n_local) == (29, 5),
          f"gemma3-4b: head dim {cfg.head_dim}, local/global layers {n_local}/"
          f"{len(windows) - n_local}")
    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_params(gen, transformer.lm_specs(cfg), cfg.dtype, dev)
    n_params = sum(t.numel() for t in leaves(params))
    toks = torch.from_numpy(
        np.random.default_rng(0).integers(0, cfg.vocab, size=(1, GEMMA_SEQ)).astype(np.int32)
    ).to(dev)
    transformer.prefill(params, cfg, toks)  # warm-up
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    logits, cache, clen = transformer.prefill(params, cfg, toks)
    ok = bool(torch.isfinite(logits).all())  # waits for the device
    ms = (time.perf_counter() - t0) * 1e3
    pre_launches = flash_attention.launches_fwd
    by_var = flash_attention.launches_by_variant
    print(f"gemma3 prefill: {cfg.name} {n_params} parameters bf16 B 1 S {GEMMA_SEQ} ms {ms:.3f} "
          f"flash launches fwd {pre_launches} bwd {flash_attention.launches_bwd} by variant "
          f"{by_var} cache {tuple(cache['k'].shape)} logits finite {ok}")
    check(ok, "gemma3 prefill: non-finite logits")
    check(pre_launches == cfg.n_layers and flash_attention.launches_bwd == 0
          and by_var["wgmma"]["fwd"] == pre_launches,
          f"gemma3 prefill: {pre_launches} flash launches {by_var}, wanted {cfg.n_layers} wgmma")
    check(clen.tolist() == [GEMMA_SEQ]
          and cache["k"].shape == (cfg.n_layers, 1, GEMMA_SEQ, cfg.n_kv_heads, 256),
          "gemma3 prefill: cache shape or length")
    del logits, cache
    prof = profile_call("gemma3 prefill", lambda: transformer.prefill(params, cfg, toks),
                        n_kernels=8, watch=("flash_fwd_wgmma",))
    # the gradient at the reference's init (its norm overflows fp32 under
    # every attention) and at the true fan-in (the train step's first)
    witness = {label: gemma3_grad_witness(dev, cfg, p, label) for label, p in (
        ("reference init", params), ("true fan-in", at_true_fan_in(params, cfg)))}
    ref, fan = witness["reference init"], witness["true fan-in"]
    check(all(math.isinf(r["norm_fp32"]) for r in ref.values()),
          f"gemma3 grad witness: at the reference's init the fp32 norm overflows under some "
          f"attentions only: {ref}")
    check(all(math.isfinite(r["norm_fp32"]) for r in fan.values())
          and fan["kernel"]["worst_leaf"] <= GEMMA_GRAD_TOL,
          f"gemma3 grad witness: at the true fan-in the kernels' gradient is "
          f"{fan['kernel']['worst_leaf']} from the fp32 oracle's (tol {GEMMA_GRAD_TOL}): {fan}")
    del params
    gc.collect()
    torch.cuda.empty_cache()

    tr = gemma3_train(dev, cfg)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"gemma3 train: {cfg.name} depth {tr['depth']} of {cfg.n_layers} "
          f"B 1 S {GEMMA_SEQ} bf16 remat full: mean step_ms {tr['mean_step_s'] * 1e3:.3f} "
          f"tokens_per_s {tr['tokens_per_s']:.1f} max_memory_allocated {tr['max_memory']} "
          f"flash launches fwd {tr['launches'][0]} bwd {tr['launches'][1]}")

    # one 6-layer cycle at full width: card logits (bf16, flash kernels)
    # against the CPU port in fp32 on the same parameters, projections at
    # 1/sqrt of their true fan-in
    c6 = dataclasses.replace(cfg, n_layers=GEMMA_CYCLE)
    p6 = at_true_fan_in(
        init_params(torch.Generator(device=dev).manual_seed(1), transformer.lm_specs(c6),
                    c6.dtype, dev), c6)
    t6 = torch.from_numpy(
        np.random.default_rng(1).integers(0, c6.vocab, size=(1, GEMMA_CHECK_SEQ)).astype(np.int32)
    )
    reset_launches()
    with torch.no_grad():
        card, _ = transformer.forward(p6, c6, t6.to(dev))
        card = card.cpu()
    check_launches = flash_attention.launches_fwd
    check(check_launches == GEMMA_CYCLE
          and flash_attention.launches_by_variant["wgmma"]["fwd"] == GEMMA_CYCLE,
          f"gemma3 check: flash launches {flash_attention.launches_by_variant}")
    cpu_params = cpu_f32(p6)
    del p6
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with torch.no_grad():
        ref, _ = transformer.forward(cpu_params, dataclasses.replace(c6, dtype=torch.float32), t6)
    cpu_s = time.perf_counter() - t0
    err, largest = (card - ref).abs().max().item(), ref.abs().max().item()
    print(f"gemma3 check: 6 layers full width, S {GEMMA_CHECK_SEQ}: card bf16 logits against "
          f"the CPU port in fp32 (same parameters; {cpu_s:.1f} s on the CPU): max_abs_err "
          f"{err:.4e} largest {largest:.4e} tol {GEMMA_CHECK_TOL:.0e} of the largest; "
          f"flash launches {check_launches}")
    check(math.isfinite(err) and err <= GEMMA_CHECK_TOL * largest,
          f"gemma3 check: card logits differ from the CPU port's by {err} (largest {largest})")
    return {"prefill_launches": pre_launches, "prefill_ms": ms, "profile": prof,
            "n_params": n_params, "train": tr, "witness": witness,
            "check_launches": check_launches,
            "check_err": (err, largest)}


# --------------------------------------------------------------------------
# phase: embedding-bag kernel against its plain version
# --------------------------------------------------------------------------
BAG_SRC = "src/repro_torch/kernels/embedding_bag/csrc/embedding_bag.cu"
BAG_TPU = "src/repro/kernels/embedding_bag/kernel.py:70"
# (label, arch whose full table is gathered, cell whose batch gives the ids,
#  combiner, weighted)
BAG_CASES = [
    ("fm serve_bulk bags", "fm", "serve_bulk", "sum", False),
    ("dcn-v2 bags of one", "dcn-v2", "serve_bulk", "sum", False),
    ("retrieval bags of one", "bst", "retrieval_cand", "sum", False),
    ("sasrec-like mean", "sasrec", "serve_bulk", "mean", True),
    ("smoke fm bags", "fm-smoke", "serve_p99", "sum", True),
]
BAG_MAIN = "fm serve_bulk bags"  # FM's field sums at serve_bulk: the largest bag of the path


def bag_inputs(arch: str, cell_name: str, dev):
    """(table spec (V, dim), ids [n_bags, bag] int32) as the model path
    makes them from ``make_batch``: FM's stacked field ids as one bag per
    row, DCN-v2's as bags of one, candidates as bags of one, SASRec's
    histories as bags."""
    from repro_torch.configs import get_config, get_shapes
    from repro_torch.data import make_batch
    from repro_torch.models.recsys import _stacked_ids

    smoke = arch.endswith("-smoke")
    name = arch[:-len("-smoke")] if smoke else arch
    cfg = get_config(name, smoke=smoke)
    cell = next(c for c in get_shapes(name) if c.name == cell_name)
    batch = make_batch(cfg, cell, seed=0, device=dev)
    V = sum(cfg.vocab_sizes) or cfg.item_vocab
    if name == "fm":
        ids = _stacked_ids(cfg, batch["sparse_ids"])
    elif name == "dcn-v2":
        ids = _stacked_ids(cfg, batch["sparse_ids"]).reshape(-1, 1)
    elif "candidate_ids" in batch:
        ids = batch["candidate_ids"].reshape(-1, 1)
    else:
        ids = batch["hist_ids"]
    return (V, cfg.embed_dim), ids.contiguous()


def bag_bound_ms(ids, dim: int, itemsize: int, weighted: bool) -> tuple[float, str]:
    """Least time.  Bytes: the distinct rows the bags gather, read once, the
    ids (and weights) read once, the output written once.  Operations: one
    add (and one multiply, weighted) per gathered element, at the fp32 rate
    (the sums run in fp32)."""
    n_bags, bag = ids.shape
    rows = torch.unique(ids).numel()
    nbytes = rows * dim * itemsize + ids.numel() * 4 * (2 if weighted else 1)
    nbytes += n_bags * dim * itemsize
    ops = (2 if weighted else 1) * ids.numel() * dim
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[torch.float32] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_bag(dev) -> dict:
    from repro_torch.kernels.embedding_bag import embedding_bag, embedding_bag_ref

    F = torch.nn.functional
    results = {}
    gen = torch.Generator(device=dev).manual_seed(77)
    for label, arch, cell_name, combiner, weighted in BAG_CASES:
        (V, dim), ids = bag_inputs(arch, cell_name, dev)
        n_bags, bag = ids.shape
        table32 = torch.randn(V, dim, generator=gen, device=dev)
        w = torch.rand(n_bags, bag, generator=gen, device=dev) if weighted else None
        iters = 10 if ids.numel() > 10**6 else 50
        for dtype in (torch.float32, torch.bfloat16):
            tname = str(dtype).replace("torch.", "")
            table = table32 if dtype == torch.float32 else table32.to(dtype)
            got = embedding_bag(table, ids, w, combiner=combiner)
            want = embedding_bag_ref(table.float(), ids, w, combiner)  # fp32, same values
            torch.cuda.synchronize()
            tol = TOL[dtype]
            err, ratio = assert_close_ratio(got, want, tol)
            print(f"bag check {label:22s} {tname:8s} bags {n_bags} x {bag} dim {dim} V {V} "
                  f"max_abs_err {err:.3e} tol atol=rtol={tol:.0e} worst ratio {ratio:.3f}")
            check(math.isfinite(err) and ratio <= 1.0,
                  f"embedding_bag {label} {tname}: max_abs_err {err}, worst ratio {ratio}")
            del got, want
            run = lambda: embedding_bag(table, ids, w, combiner=combiner)
            dms, sms = kernel_device_ms(run, iters=min(iters, 10))
            row = dict(ms=cuda_ms(run, iters=iters, warmup=2), device_ms=dms, span_ms=sms,
                       queued_ms=queued_ms(run), flushed_ms=flushed_ms(run),
                       plain_ms=cuda_ms(lambda: embedding_bag_ref(table, ids, w, combiner),
                                        iters=iters, warmup=2),
                       library_ms=None, max_abs_err=err)
            if not weighted:  # F.embedding_bag computes the same function only unweighted
                row["library_ms"] = cuda_ms(
                    lambda: F.embedding_bag(ids, table, mode=combiner), iters=iters, warmup=2)
            row["bound_ms"], row["bound_by"] = bag_bound_ms(ids, dim, table.element_size(),
                                                            weighted)
            lib = f"{row['library_ms']:.6f}" if row["library_ms"] is not None else "n/a"
            print(f"bag time  {label:22s} {tname:8s} ms {row['ms']:.6f} device_ms "
                  f"{row['device_ms']:.6f} device_span_ms {row['span_ms']:.6f} queued_ms "
                  f"{row['queued_ms']:.6f} l2_flushed_ms {row['flushed_ms']:.6f} "
                  f"plain_ms {row['plain_ms']:.6f} library_ms {lib} "
                  f"bound_ms {row['bound_ms']:.6f} ({row['bound_by']})")
            results[(label, tname)] = row
            del table
        del table32, ids, w
        torch.cuda.empty_cache()
    return {"cases": results}


# --------------------------------------------------------------------------
# phase: full-width recsys serving
# --------------------------------------------------------------------------
RECSYS = ("fm", "dcn-v2", "bst", "sasrec")
RECSYS_CELLS = ("serve_p99", "serve_bulk", "retrieval_cand")


@torch.no_grad()
def phase_recsys(dev) -> dict:
    from repro_torch.configs import get_config, get_shapes
    from repro_torch.data import make_batch
    from repro_torch.kernels.embedding_bag import embedding_bag
    from repro_torch.models.layers import init_params
    from repro_torch.train import build_param_specs, build_serve_step

    rows = {}
    embedding_bag.launches = 0
    for arch in RECSYS:
        cfg = get_config(arch)  # full width, fp32 (the reference's dtype)
        cells = {c.name: c for c in get_shapes(arch)}
        gen = torch.Generator(device=dev).manual_seed(0)
        params = init_params(gen, build_param_specs(cfg, cells["serve_p99"]), cfg.dtype, dev)
        n_bytes = sum(t.numel() * t.element_size() for t in leaves(params))
        print(f"recsys {arch}: params bytes {n_bytes}")
        for name in RECSYS_CELLS:
            cell = cells[name]
            batch = make_batch(cfg, cell, seed=0, device=dev)
            fn = build_serve_step(cfg, cell)
            before = embedding_bag.launches
            out = fn(params, **batch)
            per_call = embedding_bag.launches - before
            B = cell.params["batch"]
            shape = (B, cell.params["n_candidates"]) if cell.kind == "retrieval" else (B,)
            ok = bool(torch.isfinite(out).all())
            check(tuple(out.shape) == shape and ok,
                  f"recsys {arch} {name}: output {tuple(out.shape)} finite {ok}")
            check(per_call > 0, f"recsys {arch} {name}: no embedding-bag launch")
            del out
            ms = cuda_ms(lambda: fn(params, **batch), iters=20 if B <= 512 else 5, warmup=2)
            print(f"recsys {arch:7s} {name:15s} ms_per_call {ms:.6f} "
                  f"embedding_bag_launches_per_call {per_call} output {shape}")
            rows[(arch, name)] = dict(ms=ms, launches_per_call=per_call)
            if name == "serve_p99":
                prof = profile_call(f"recsys {arch} serve_p99", lambda: fn(params, **batch),
                                    n_kernels=5)
                rows[(arch, name)]["profile"] = prof
            del batch
        del params
        torch.cuda.empty_cache()
    launches = embedding_bag.launches
    print(f"recsys: embedding_bag launches {launches}")
    check(launches > 0, "recsys serving never launched the embedding-bag kernel")
    recsys_parity(dev)
    return {"launches": launches, "rows": rows}


def recsys_parity(dev) -> None:
    """The fp32 smoke models' scores and retrievals on the card against the
    same models on the CPU.  FM's and DCN-v2's candidates are drawn inside
    their smoke tables (``make_batch`` draws them below 1,000, past the 290
    and 260 rows there, which both packages score NaN)."""
    import dataclasses as dc

    from repro_torch.configs import get_config, get_shapes
    from repro_torch.data import make_batch
    from repro_torch.kernels.embedding_bag import embedding_bag
    from repro_torch.models.layers import init_params
    from repro_torch.train import build_param_specs, build_serve_step

    before = embedding_bag.launches
    for arch in RECSYS:
        cfg = get_config(arch, smoke=True)
        for cell in get_shapes(arch)[1:]:
            if cell.kind == "retrieval":
                n_c = min(cfg.item_vocab or sum(cfg.vocab_sizes), 1000)
                cell = dc.replace(cell, params=dict(cell.params, n_candidates=n_c))
            elif cell.name == "serve_bulk":
                cell = dc.replace(cell, params=dict(cell.params, batch=4096))
            cpu_params = init_params(torch.Generator().manual_seed(0),
                                     build_param_specs(cfg, cell), cfg.dtype, "cpu")
            batch = make_batch(cfg, cell, seed=1, device="cpu")
            if "candidate_ids" in batch and not cfg.item_vocab:
                batch["candidate_ids"] = torch.arange(n_c, dtype=torch.int32)
            fn = build_serve_step(cfg, cell)
            want = fn(cpu_params, **batch)
            got = fn(to_device(cpu_params, dev), **to_device(batch, dev)).cpu()
            tol = 1e-4 * want.abs().max().item()
            diff = (got - want).abs()
            ratio = (diff / (tol + 1e-4 * want.abs())).max().item()
            print(f"recsys parity {arch:7s} {cell.name:15s} card vs cpu max_abs_err "
                  f"{diff.max().item():.3e} (tol 1e-4 x max|score| = {tol:.3e}, rtol 1e-4) "
                  f"worst ratio {ratio:.3f}")
            check(ratio <= 1.0, f"recsys parity {arch} {cell.name}: worst ratio {ratio}")
    check(embedding_bag.launches > before, "recsys parity: the card never launched the kernel")


# --------------------------------------------------------------------------
# phase: gated-aggregation kernels against the plain version plus autograd
# --------------------------------------------------------------------------
AGG_SRC = "src/repro_torch/kernels/gnn_aggregate/csrc/gnn_aggregate.cu"
AGG_TPU = "src/repro/kernels/gnn_aggregate/kernel.py:59"
AGG_MAIN = "minibatch_lg block"
AGG_SKEW = "power-law graph"
AGG_UNIFORM = "uniform graph"  # control: the power-law graph's sizes without its skew
REDDIT_NODES = 232_965
REDDIT_EDGES_CUT = 11_461_589  # a tenth of the published 114,615,892: keeps the host build short


def power_law_graph(seed: int = 0):
    """A synthetic power-law graph with Reddit's node count and a tenth of
    its edges (edge_index [2, E] numpy), and a NeighborSampler (fanout 15-10)
    over it; the block shapes do not depend on the edge count."""
    from repro_torch.data import CSRGraph, NeighborSampler, random_graph

    t0 = time.perf_counter()
    ei = random_graph(REDDIT_NODES, REDDIT_EDGES_CUT, seed=seed)
    sampler = NeighborSampler(CSRGraph.from_edge_index(ei, REDDIT_NODES), (15, 10), seed=seed)
    print(f"graph: {REDDIT_NODES} nodes {REDDIT_EDGES_CUT} edges (power law) built in "
          f"{time.perf_counter() - t0:.3f} s; largest in-degree "
          f"{int(np.bincount(ei[1], minlength=REDDIT_NODES).max())}")
    return ei, sampler


def agg_graphs(graph, sampler) -> list:
    """(label, edge_index [2,E] numpy, n_nodes, dim, dtypes, layouts) for the
    kernel checks.  The power-law graph runs on the CSR index alone: its
    padded ELL would not fit the card.  A uniform random graph with the same
    node and edge counts (largest in-degree below 100) is its control: what
    the kernels read at that size with no hub to split."""
    from repro_torch.data import random_graph

    block = sampler.sample(np.random.default_rng(0).choice(REDDIT_NODES, 1024, replace=False)
                           .astype(np.int32))
    r = np.random.default_rng(1)
    cora = r.integers(0, 2708, size=(2, 10752))  # full_graph_sm: make_batch's edges, padded
    smoke = r.integers(0, 40, size=(2, 160))
    both, all_types = ("ell", "csr"), (torch.float32, torch.bfloat16)
    return [(AGG_MAIN, block["edge_index"], block["nodes"].shape[0], 70, all_types, both),
            ("full_graph_sm", cora, 3072, 70, all_types, both),
            ("smoke", smoke, 40, 16, all_types, both),
            (AGG_SKEW, graph, REDDIT_NODES, 70, (torch.float32,), ("csr",)),
            (AGG_UNIFORM, random_graph(REDDIT_NODES, REDDIT_EDGES_CUT, seed=0, power_law=False),
             REDDIT_NODES, 70, (torch.float32,), ("csr",))]


def agg_bound_ms(ell, n_rows: int, dim: int, itemsize: int, backward: bool) -> tuple[float, str]:
    """Least time of the padded-ELL call.  Both ways read the neighbour table
    and the distinct rows of h it references once.  Forward bytes: those,
    every ELL gate (a padding slot cannot be told from an edge of row 0)
    read once, and the output written once.  Backward bytes: those, dout,
    the source index and the gates at the real slots only (dh needs no
    other) read once, dgates (every slot) and dh written once.  Operations:
    a multiply-add per gate element forward (2), a multiply per gate element
    and a multiply-add per real slot and element backward, at the fp32
    rate."""
    N, D = ell.nbr.shape
    E = ell.rev_slot.numel()
    rows = torch.unique(ell.nbr).numel()
    all_gates = N * D * dim * itemsize
    nbytes = N * D * 4 + rows * dim * itemsize + N * dim * itemsize  # + out or dout
    ops = 2 * N * D * dim
    if backward:
        nbytes += E * dim * itemsize + all_gates + (n_rows + 1 + E) * 4 + n_rows * dim * itemsize
        ops = N * D * dim + 2 * E * dim
    else:
        nbytes += all_gates
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[torch.float32] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def csr_bound_ms(idx, n_rows: int, dim: int, itemsize: int, backward: bool,
                 with_den: bool) -> tuple[float, str]:
    """Least time of the CSR call, counting what these inputs need.  Forward
    bytes: row_ptr and col, the gates (one row a real edge) and the distinct
    rows of h that col names read once; num (and den) written once, every
    row.  Backward bytes: dnum (and dden) at the rows that have an edge, the
    distinct rows of h, the gates, row_ptr, col and the reverse list
    (rev_ptr, rev_slot, rev_row) read once; dgates (one row a real edge) and
    dh written once.  Operations at the fp32 rate: a multiply-add per gate
    element forward (2, and 1 more for den); backward a multiply per gate
    element for dgates (and an add for dden) and a multiply-add for dh."""
    N, E = idx.row_ptr.numel() - 1, idx.col.numel()
    outs = 2 if with_den else 1
    h_rows = torch.unique(idx.col).numel()
    gates = E * dim * itemsize
    if backward:
        rows_with_edges = int((idx.row_ptr[1:] > idx.row_ptr[:-1]).sum())
        nbytes = (outs * rows_with_edges * dim * itemsize + h_rows * dim * itemsize + gates
                  + (N + 1 + E + n_rows + 1 + 2 * E) * 4 + gates + n_rows * dim * itemsize)
        ops = E * dim * (outs + 2)
    else:
        nbytes = (N + 1 + E) * 4 + gates + h_rows * dim * itemsize + outs * N * dim * itemsize
        ops = E * dim * (1 + outs)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[torch.float32] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def agg_times(fn, iters: int) -> dict:
    dms, sms = kernel_device_ms(fn, iters=min(iters, 10))
    return dict(ms=cuda_ms(fn, iters=iters, warmup=2), device_ms=dms, span_ms=sms,
                queued_ms=queued_ms(fn), flushed_ms=flushed_ms(fn))


def agg_check(label: str, tname: str, layout: str, names, got, want, tol: float) -> dict:
    """Each kernel output against the plain version within atol = rtol =
    tol; returns the largest error of the forward and of the backward."""
    errs = {"fwd": 0.0, "bwd": 0.0}
    for name, g, w in zip(names, got, want):
        err, ratio = assert_close_ratio(g, w, tol)
        print(f"agg check {label:20s} {tname:8s} {layout} {name:6s} max_abs_err {err:.3e} "
              f"tol atol=rtol={tol:.0e} worst ratio {ratio:.3f}")
        check(math.isfinite(err) and ratio <= 1.0,
              f"gnn_aggregate {label} {tname} {layout} {name}: max_abs_err {err}, ratio {ratio}")
        kind = "fwd" if name in ("out", "num", "den") else "bwd"
        errs[kind] = max(errs[kind], err)
    return errs


def csr_check64(label: str, idx, h, gates, dnum, dden, got, tol: float,
                chunk: int = 1 << 21) -> dict:
    """The CSR call's outputs (num, den, dh, dgates) against the same
    function in fp64, slots taken in chunks.  Each element is held to
    |got - ref| <= tol * (1 + S), S the sum of the magnitudes of the terms it
    adds up: the normwise bound of a float32 sum.  The elementwise rule
    (S = |ref|) cannot hold for a hub's sum of tens of thousands of terms
    in any other order: the plain fp32 version (index_add_, whose atomics
    fix no order) is printed against it too."""
    from repro_torch.kernels.gnn_aggregate import gnn_aggregate_csr_ref

    dev, (N, dim), E = h.device, dnum.shape, idx.col.numel()
    row_of = torch.searchsorted(idx.row_ptr, torch.arange(E, dtype=torch.int32, device=dev),
                                right=True) - 1
    src = idx.col.long()
    h64, dnum64, dden64 = h.double(), dnum.double(), dden.double()
    zeros = lambda n: torch.zeros(n, dim, dtype=torch.float64, device=dev)
    num, num_s, den, dh, dh_s = zeros(N), zeros(N), zeros(N), zeros(h.shape[0]), zeros(h.shape[0])
    dg_err = dg_ratio = 0.0
    for a in range(0, E, chunk):
        r, c, g = row_of[a:a + chunk], src[a:a + chunk], gates[a:a + chunk].double()
        t = g * h64[c]
        num.index_add_(0, r, t)
        num_s.index_add_(0, r, t.abs())
        den.index_add_(0, r, g)
        u = g * dnum64[r]
        dh.index_add_(0, c, u)
        dh_s.index_add_(0, c, u.abs())
        p, q = dnum64[r] * h64[c], dden64[r]
        diff = (got[3][a:a + chunk].double() - (p + q)).abs()
        dg_err = max(dg_err, diff.max().item())
        dg_ratio = max(dg_ratio, (diff / (tol * (1 + p.abs() + q.abs()))).max().item())
        del t, u, p, q, diff
    errs = {"fwd": 0.0, "bwd": 0.0}
    tname = str(h.dtype).replace("torch.", "")
    rows = [("num", got[0], num, num_s), ("den", got[1], den, den.abs()),
            ("dh", got[2], dh, dh_s)]
    for name, g, ref, scale in rows:
        diff = (g.double() - ref).abs()
        err, ratio = diff.max().item(), (diff / (tol * (1 + scale))).max().item()
        elementwise = (diff / (tol * (1 + ref.abs()))).max().item()
        print(f"agg check {label:20s} {tname:8s} csr {name:6s} against fp64: max_abs_err "
              f"{err:.3e} worst err/(tol*(1+sum|terms|)) {ratio:.3f} (tol {tol:.0e}); "
              f"elementwise rule {elementwise:.3f}")
        check(math.isfinite(err) and ratio <= 1.0,
              f"gnn_aggregate {label} csr {name}: max_abs_err {err}, ratio {ratio}")
        errs["fwd" if name in ("num", "den") else "bwd"] = max(
            errs["fwd" if name in ("num", "den") else "bwd"], err)
    print(f"agg check {label:20s} {tname:8s} csr dgates against fp64: max_abs_err {dg_err:.3e} "
          f"worst err/(tol*(1+sum|terms|)) {dg_ratio:.3f}")
    check(math.isfinite(dg_err) and dg_ratio <= 1.0,
          f"gnn_aggregate {label} csr dgates: max_abs_err {dg_err}, ratio {dg_ratio}")
    errs["bwd"] = max(errs["bwd"], dg_err)
    plain, _ = gnn_aggregate_csr_ref(h, idx.row_ptr, idx.col, gates, False)
    diff = (plain.double() - num).abs()
    print(f"agg check {label:20s} {tname:8s} plain fp32 num against fp64: max_abs_err "
          f"{diff.max().item():.3e} worst err/(tol*(1+sum|terms|)) "
          f"{(diff / (tol * (1 + num_s))).max().item():.3f}; elementwise rule "
          f"{(diff / (tol * (1 + num.abs()))).max().item():.3f}")
    return errs


def agg_print(label: str, tname: str, layout: str, row: dict) -> None:
    for kind in ("fwd", "bwd"):
        r = row[kind]
        print(f"agg time  {label:20s} {tname:8s} {layout} {kind} ms {r['ms']:.6f} device_ms "
              f"{r['device_ms']:.6f} device_span_ms {r['span_ms']:.6f} queued_ms "
              f"{r['queued_ms']:.6f} l2_flushed_ms {r['flushed_ms']:.6f} "
              f"plain_ms {r['plain_ms']:.6f} yardstick_index_add_ms {r['yardstick_ms']:.6f} "
              f"bound_ms {r['bound_ms']:.6f} ({r['bound_by']})")


def agg_ell_case(ops, label, ei, n, h, eta, dout, iters, gen) -> dict:
    """The padded-ELL contract (run as its CSR form on the same kernels):
    forward and backward against the ELL plain version plus autograd, two
    backward runs equal bit for bit, times beside the ELL bound."""
    from repro_torch.kernels.gnn_aggregate import ell_as_csr, ell_index, gnn_aggregate_ref

    dev, dtype, dim = h.device, h.dtype, h.shape[1]
    tname = str(dtype).replace("torch.", "")
    ell = ell_index(ei, n, dev)
    gates = torch.zeros(n * ell.max_deg, dim, device=dev, dtype=dtype)
    gates.index_copy_(0, ell.slot, eta)
    row_ptr, col, rev = ell_as_csr(ell.nbr, ell.rev)
    h32 = h.detach().float().requires_grad_(True)
    g32 = gates.detach().float().view(n, ell.max_deg, dim).requires_grad_(True)
    ref_out = gnn_aggregate_ref(h32, ell.nbr, g32)
    ref_dh, ref_dg = torch.autograd.grad(ref_out, (h32, g32), dout.float())
    want = (ref_out.detach(), ref_dh, ref_dg.view(-1, dim))
    del ref_out, h32, g32
    fwd = lambda: ops.gnn_aggregate_fwd(h, row_ptr, col, gates, layout="ell")
    bwd = lambda: ops.gnn_aggregate_bwd(h, row_ptr, col, gates, dout, None, rev, layout="ell")
    out, _ = fwd()
    dh, dg = bwd()
    dh2, dg2 = bwd()
    torch.cuda.synchronize()
    same = torch.equal(dh, dh2) and torch.equal(dg, dg2)
    del dh2, dg2
    print(f"agg check {label:20s} {tname:8s} ell N {n} max_deg {ell.max_deg} dim {dim}")
    errs = agg_check(label, tname, "ell", ("out", "dh", "dgates"), (out, dh, dg), want,
                     TOL[dtype])
    print(f"agg check {label:20s} {tname:8s} ell backward equal bit for bit over two runs: "
          f"{same}")
    check(same, f"gnn_aggregate {label} {tname} ell: the backward is not deterministic")
    del want, out, dh, dg
    row = {}
    for kind, fn in (("fwd", fwd), ("bwd", bwd)):
        bms, by = agg_bound_ms(ell, n, dim, h.element_size(), kind == "bwd")
        row[kind] = dict(agg_times(fn, iters), bound_ms=bms, bound_by=by, max_abs_err=errs[kind])
    if label == AGG_MAIN:
        # control for the data: the same forward with every slot's gate
        # nonzero (93% of the block's slots are padding, whose gates are 0)
        dense = torch.rand(gates.shape, generator=gen, device=dev).to(dtype)
        row["fwd"]["dense_flushed_ms"] = flushed_ms(
            lambda: ops.gnn_aggregate_fwd(h, row_ptr, col, dense, layout="ell"))
        print(f"agg time  {label:20s} {tname:8s} ell fwd with every gate nonzero: "
              f"l2_flushed_ms {row['fwd']['dense_flushed_ms']:.6f}")
        del dense
    gates3 = gates.view(n, ell.max_deg, dim)
    hg, gg = (t.clone().requires_grad_(True) for t in (h, gates3))
    row["fwd"]["plain_ms"] = cuda_ms(lambda: gnn_aggregate_ref(h, ell.nbr, gates3),
                                     iters=iters, warmup=2)
    plain_out = gnn_aggregate_ref(hg, ell.nbr, gg)
    row["bwd"]["plain_ms"] = backward_ms(plain_out, (hg, gg), dout, iters)
    return row


def agg_csr_case(ops, label, idx, n, h, gates, dnum, dden, iters, exact: bool) -> dict:
    """The CSR call the model makes (num and den in one launch; the backward
    with dnum and dden): against the CSR plain version plus autograd (or,
    with ``exact``, the fp64 function: :func:`csr_check64`), two backward
    runs equal bit for bit, times beside the CSR bound."""
    from repro_torch.kernels.gnn_aggregate import gnn_aggregate_csr_ref

    dtype, dim = h.dtype, h.shape[1]
    tname = str(dtype).replace("torch.", "")
    fwd = lambda: ops.gnn_aggregate_fwd(h, idx.row_ptr, idx.col, gates, with_den=True)
    bwd = lambda: ops.gnn_aggregate_bwd(h, idx.row_ptr, idx.col, gates, dnum, dden, idx.rev)
    num, den = fwd()
    dh, dg = bwd()
    dh2, dg2 = bwd()
    torch.cuda.synchronize()
    same = torch.equal(dh, dh2) and torch.equal(dg, dg2)
    del dh2, dg2
    deg = idx.row_ptr[1:] - idx.row_ptr[:-1]
    max_deg = int(deg.max())
    print(f"agg check {label:20s} {tname:8s} csr N {n} E {idx.col.numel()} largest in-degree "
          f"{max_deg} dim {dim}; its padded ELL gates would take "
          f"{n * max_deg * dim * h.element_size()} B")
    if exact:
        errs = csr_check64(label, idx, h, gates, dnum, dden, (num, den, dh, dg), TOL[dtype])
    else:
        h32, g32 = (t.detach().float().requires_grad_(True) for t in (h, gates))
        ref_num, ref_den = gnn_aggregate_csr_ref(h32, idx.row_ptr, idx.col, g32, True)
        want = (ref_num.detach(), ref_den.detach(),
                *torch.autograd.grad((ref_num, ref_den), (h32, g32),
                                     (dnum.float(), dden.float())))
        del ref_num, ref_den, h32, g32
        errs = agg_check(label, tname, "csr", ("num", "den", "dh", "dgates"),
                         (num, den, dh, dg), want, TOL[dtype])
        del want
    print(f"agg check {label:20s} {tname:8s} csr backward equal bit for bit over two runs: "
          f"{same}")
    check(same, f"gnn_aggregate {label} {tname} csr: the backward is not deterministic")
    del num, den, dh, dg
    row = {}
    for kind, fn in (("fwd", fwd), ("bwd", bwd)):
        bms, by = csr_bound_ms(idx, n, dim, h.element_size(), kind == "bwd", True)
        row[kind] = dict(agg_times(fn, iters), bound_ms=bms, bound_by=by, max_abs_err=errs[kind])
    num_only = lambda: ops.gnn_aggregate_fwd(h, idx.row_ptr, idx.col, gates)
    row["fwd"]["no_den_queued_ms"] = queued_ms(num_only)
    row["fwd"]["no_den_bound_ms"] = csr_bound_ms(idx, n, dim, h.element_size(), False, False)[0]
    print(f"agg time  {label:20s} {tname:8s} csr fwd without den: queued_ms "
          f"{row['fwd']['no_den_queued_ms']:.6f} bound_ms {row['fwd']['no_den_bound_ms']:.6f}")
    plain = lambda h_, g_: gnn_aggregate_csr_ref(h_, idx.row_ptr, idx.col, g_, True)
    row["fwd"]["plain_ms"] = cuda_ms(lambda: plain(h, gates), iters=iters, warmup=1)
    hg, gg = (t.clone().requires_grad_(True) for t in (h, gates))
    row["bwd"]["plain_ms"] = backward_ms(plain(hg, gg), (hg, gg), (dnum, dden), iters)
    return row


def phase_agg(dev, graphs) -> dict:
    from repro_torch.kernels.gnn_aggregate import csr_index
    from repro_torch.kernels.gnn_aggregate import ops

    results, index_ms = {}, {}
    gen = torch.Generator(device=dev).manual_seed(99)
    for label, ei, n, dim, dtypes, layouts in graphs:
        ei_dev = torch.from_numpy(np.asarray(ei, np.int32)).to(dev)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")  # any read back to the host raises
        try:
            idx = csr_index(ei_dev, n)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        index_ms[label] = queued_ms(lambda: csr_index(ei_dev, n))
        print(f"agg index {label:20s} csr_index on the card without a sync: queued_ms "
              f"{index_ms[label]:.6f}")
        src, dst = (ei_dev[i].long() for i in (0, 1))
        E = src.numel()
        big = E > 10**6  # held against fp64 (csr_check64), timed with few calls
        iters = 3 if big else (10 if n > 10**5 else 50)
        for dtype in dtypes:
            tname = str(dtype).replace("torch.", "")
            h = torch.randn(n, dim, generator=gen, device=dev).to(dtype)
            eta = torch.rand(E, dim, generator=gen, device=dev).to(dtype)  # input edge order
            dnum, dden = (torch.randn(n, dim, generator=gen, device=dev).to(dtype)
                          for _ in range(2))
            row = {}
            if "ell" in layouts:
                row["ell"] = agg_ell_case(ops, label, ei, n, h, eta, dnum, iters, gen)
            row["csr"] = agg_csr_case(ops, label, idx, n, h, eta[idx.perm], dnum, dden, iters,
                                      exact=big)
            # yardstick, labelled as such: the reference model's segment-sum
            # form, index_add_ of eta * h[src] and of eta, exactly the CSR call
            seg = lambda e_, h_: (
                torch.zeros(n, dim, device=dev, dtype=dtype).index_add_(0, dst, e_ * h_[src]),
                torch.zeros(n, dim, device=dev, dtype=dtype).index_add_(0, dst, e_))
            fwd_ms = cuda_ms(lambda: seg(eta, h), iters=iters, warmup=1)
            hg, eg = h.clone().requires_grad_(True), eta.clone().requires_grad_(True)
            bwd_ms = backward_ms(seg(eg, hg), (hg, eg), (dnum, dden), iters)
            del hg, eg
            for layout in row:
                row[layout]["fwd"]["yardstick_ms"] = fwd_ms
                row[layout]["bwd"]["yardstick_ms"] = bwd_ms
                agg_print(label, tname, layout, row[layout])
            results[(label, tname)] = row
            del h, eta, dnum, dden
            gc.collect()
            torch.cuda.empty_cache()
        del idx, ei_dev, src, dst
    return {"cases": results, "index_ms": index_ms}


# --------------------------------------------------------------------------
# phase: full-width GatedGCN training
# --------------------------------------------------------------------------
def minibatch(sampler, feats, labels, step: int, dev) -> dict:
    """A minibatch_lg batch: 1,024 seeds (numpy seed = step) and their
    sampled 2-hop block, features and labels gathered on the card."""
    seeds = np.random.default_rng(step).choice(REDDIT_NODES, 1024, replace=False)
    block = sampler.sample(seeds.astype(np.int32))
    nodes = torch.from_numpy(block["nodes"]).to(dev).long()
    return {"node_feat": feats[nodes], "edge_index": torch.from_numpy(block["edge_index"]).to(dev),
            "labels": labels[nodes[:1024]], "seed_ids": torch.arange(1024, device=dev,
                                                                   dtype=torch.int32)}


def phase_gnn_train(dev, sampler) -> dict:
    from repro_torch.configs import get_config, get_shapes
    from repro_torch.data import make_batch
    from repro_torch.kernels.gnn_aggregate import csr_index, gnn_aggregate, reset_launches
    from repro_torch.models.layers import init_params
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import build_param_specs, build_train_step, make_train_state

    cfg = get_config("gatedgcn")  # full width: 16 layers, d_hidden 70, 47 classes, fp32
    cells = {c.name: c for c in get_shapes("gatedgcn")}
    cell = cells["minibatch_lg"]
    gen = torch.Generator(device=dev).manual_seed(0)
    state = make_train_state(init_params(gen, build_param_specs(cfg, cell), cfg.dtype, dev))
    step = build_train_step(cfg, cell, AdamWConfig(warmup_steps=10, total_steps=100))
    feats = torch.randn(REDDIT_NODES, 602, generator=gen, device=dev).mul_(0.1)
    labels = torch.randint(0, cfg.n_classes, (REDDIT_NODES,), generator=gen, device=dev,
                           dtype=torch.int32)
    batches = [minibatch(sampler, feats, labels, i, dev) for i in range(5)]
    # the step's index build alone: device time of csr_index on a block
    ei0, n0 = batches[0]["edge_index"], batches[0]["node_feat"].shape[0]
    index_ms = queued_ms(lambda: csr_index(ei0, n0))
    index_host_ms = cuda_ms(lambda: csr_index(ei0, n0), iters=20, warmup=2)
    print(f"gnn train: csr_index of a minibatch_lg block ({n0} nodes, {ei0.shape[1]} edges) "
          f"queued_ms {index_ms:.6f} ms (back to back, host included) {index_host_ms:.6f}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    rows = []
    n_steps = 4
    for i in range(n_steps):  # one warm-up step, three timed
        f0, b0 = gnn_aggregate.launches_fwd, gnn_aggregate.launches_bwd
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batches[i])
        m = {k: float(v) for k, v in m.items()}  # waits for the device
        dt = time.perf_counter() - t0
        nf, nb = gnn_aggregate.launches_fwd - f0, gnn_aggregate.launches_bwd - b0
        tag = "warm-up" if i == 0 else f"step {i}"
        print(f"gnn train {tag}: loss {m['loss']:.6f} grad_norm {m['grad_norm']:.6f} "
              f"step_ms {dt * 1e3:.3f} seeds_per_s {1024 / dt:.1f} agg_fwd {nf} agg_bwd {nb}")
        check(all(math.isfinite(v) for v in m.values()), f"gnn train {tag}: non-finite {m}")
        check(nf == cfg.n_layers and nb == cfg.n_layers,
              f"gnn train {tag}: {nf} forward / {nb} backward aggregations, wanted {cfg.n_layers}")
        rows.append(dict(step_s=dt, **m))
    launches = [gnn_aggregate.launches_fwd, gnn_aggregate.launches_bwd]
    layouts = dict(gnn_aggregate.launches_by_layout)
    # no [N, max_deg, d] tensor in the step: every launch ran on the CSR index
    check(layouts == {"csr": 2 * n_steps * cfg.n_layers, "ell": 0},
          f"gnn train: launches by layout {layouts}, wanted every one on the CSR index")
    mem = torch.cuda.max_memory_allocated(dev)
    timed = rows[1:]
    mean_s = sum(r["step_s"] for r in timed) / len(timed)
    print(f"gnn train: {cfg.name} minibatch_lg (1024 seeds, fanout 15-10, 169984 nodes, "
          f"168960 edges, d_feat 602) fp32: mean step_ms {mean_s * 1e3:.3f} seeds_per_s "
          f"{1024 / mean_s:.1f} max_memory_allocated {mem}; aggregation launches in the "
          f"{n_steps} steps fwd {launches[0]} bwd {launches[1]} by layout {layouts}")

    def one_more():
        nonlocal state
        state, m = step(state, batches[4])
        check(math.isfinite(float(m["loss"])), "profiled gnn step: non-finite loss")

    prof = profile_call("gnn train step", one_more)
    del state, batches, feats, labels
    torch.cuda.empty_cache()

    # one full_graph_sm step (Cora-scale, d_feat 1433, the train mask)
    fcell = cells["full_graph_sm"]
    fstate = make_train_state(init_params(gen, build_param_specs(cfg, fcell), cfg.dtype, dev))
    fbatch = make_batch(cfg, fcell, seed=0, device=dev)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    fstate, m = build_train_step(cfg, fcell)(fstate, fbatch)
    loss = float(m["loss"])
    dt = time.perf_counter() - t0
    full = [gnn_aggregate.launches_fwd, gnn_aggregate.launches_bwd]
    check(gnn_aggregate.launches_by_layout["ell"] == 0, "full_graph_sm step: an ELL launch")
    print(f"gnn train full_graph_sm: loss {loss:.6f} step_ms {dt * 1e3:.3f} (first call) "
          f"agg_fwd {full[0]} agg_bwd {full[1]}")
    check(math.isfinite(loss) and full == [cfg.n_layers, cfg.n_layers],
          f"full_graph_sm step: loss {loss}, {full[0]}/{full[1]} aggregations")
    del fstate, fbatch
    torch.cuda.empty_cache()
    return {"launches": launches, "steps": n_steps, "launches_full_graph": full, "rows": rows,
            "mean_step_s": mean_s, "max_memory": mem, "profile": prof, "index_ms": index_ms}


def phase_gnn_parity(dev) -> None:
    """Five fp32 smoke GatedGCN steps on minibatch blocks, on the card
    (kernels) and on the CPU (plain path), from the same parameters."""
    from repro_torch.configs import ShapeCell, get_config
    from repro_torch.data import CSRGraph, NeighborSampler, random_graph
    from repro_torch.kernels.gnn_aggregate import gnn_aggregate
    from repro_torch.models.gnn import gnn_specs
    from repro_torch.models.layers import init_params
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import build_train_step, make_train_state

    cfg = get_config("gatedgcn", smoke=True)  # fp32
    cell = ShapeCell("mb", "minibatch", {"d_feat": 32})
    n = 2000
    sampler = NeighborSampler(CSRGraph.from_edge_index(random_graph(n, 20000, seed=3), n),
                              (15, 10), seed=3)
    feats = (np.random.default_rng(4).normal(size=(n, 32)) * 0.1).astype(np.float32)
    cpu_params = init_params(torch.Generator().manual_seed(0), gnn_specs(cfg, 32), cfg.dtype,
                             "cpu")
    dev_state = make_train_state(to_device(cpu_params, dev))
    cpu_state = make_train_state(cpu_params)
    opt = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=5)
    dev_step, cpu_step = build_train_step(cfg, cell, opt), build_train_step(cfg, cell, opt)
    before = gnn_aggregate.launches_fwd, gnn_aggregate.launches_bwd
    for s in range(5):
        seeds = np.random.default_rng(10 + s).choice(n, 64, replace=False).astype(np.int32)
        block = sampler.sample(seeds)
        batch = {"node_feat": torch.from_numpy(feats[block["nodes"]]),
                 "edge_index": torch.from_numpy(block["edge_index"]),
                 "labels": torch.from_numpy(seeds % cfg.n_classes).int()}
        dev_state, a = dev_step(dev_state, to_device(batch, dev))
        cpu_state, b = cpu_step(cpu_state, batch)
        la, lb = float(a["loss"]), float(b["loss"])
        print(f"gnn parity step {s + 1}: loss card {la:.7f} cpu {lb:.7f} "
              f"grad_norm card {float(a['grad_norm']):.7f} cpu {float(b['grad_norm']):.7f}")
        check(abs(la - lb) <= 1e-4 + 1e-4 * abs(lb),
              f"gnn parity step {s + 1}: loss {la} on the card, {lb} on the CPU")
    worst = 0.0
    for pa, pb in zip(leaves(dev_state["params"]), leaves(cpu_state["params"])):
        diff = (pa.cpu() - pb).abs()
        worst = max(worst, (diff / (1e-4 + 1e-4 * pb.abs())).max().item())
    launched = (gnn_aggregate.launches_fwd - before[0], gnn_aggregate.launches_bwd - before[1])
    print(f"gnn parity: final params worst err/(1e-4+1e-4*|cpu|) {worst:.4f}; aggregation "
          f"launches on the card fwd {launched[0]} bwd {launched[1]}")
    check(worst <= 1.0, f"gnn parity: final parameters differ (worst ratio {worst})")
    check(min(launched) > 0, "gnn parity: the card never launched the aggregation kernels")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(here, "src"))
    from repro_torch.kernels import build  # fails where the package is absent

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    build_s = build.build_all()
    print(f"build: {build_s:.3f} s for {len(build.sources())} source(s)")

    def timed(fn, *args):
        t = time.perf_counter()
        out = fn(dev, *args)
        print(f"phase {fn.__name__}: {time.perf_counter() - t:.3f} s")
        gc.collect()  # what the phase left in reference cycles goes before the next
        return out

    kern = timed(phase_kernels)
    eng = timed(phase_engine)
    par = timed(phase_parity)
    flash = timed(phase_flash)
    train = timed(phase_train)
    timed(phase_train_parity)
    timed(phase_driver)
    pre = timed(phase_prefill)
    gem = timed(phase_gemma3)
    bag = timed(phase_bag)
    rec = timed(phase_recsys)
    graph, sampler = power_law_graph()
    agg = timed(phase_agg, agg_graphs(graph, sampler))
    del graph
    gtrain = timed(phase_gnn_train, sampler)
    timed(phase_gnn_parity)

    def decode_shape(label, tname):
        c = next(c for c in KERNEL_CASES if c[0] == label)
        return {"case": label, "B": c[1], "S": c[2], "T": c[3], "Hq": c[4], "Hkv": c[5],
                "dh": c[6], "q_start": c[7], "dtype": tname}

    flash_case = next(c for c in FLASH_CASES if c[0] == FLASH_MAIN)
    flash_shape = {"B": flash_case[1], "S": flash_case[2], "Hq": flash_case[3],
                   "Hkv": flash_case[4], "dh": flash_case[5], "causal": flash_case[6],
                   "dtype": "bfloat16"}
    fm = flash["cases"][(FLASH_MAIN, "bfloat16")]
    flash_src = "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu"
    flash_tpu = "src/repro/kernels/flash_attention/kernel.py:114"
    decode_src = "src/repro_torch/kernels/decode_attention/csrc/decode_attention.cu"
    decode_tpu = "src/repro/kernels/decode_attention/kernel.py:106"
    split_paths = {"fp32 smoke serving (card vs CPU)": par["split"],
                   "fp32 gemma3 smoke prefill_chunk chain": pre["smoke_chain_launches"]["split"]}
    split_at_chunk = kern["cases"][(CHUNK_CASE, "bfloat16")]
    line = {"kernels": []}
    for name, var, case, tname, r, by_path in (
        ("decode_attention_fused", "fused", MAIN_CASE, "bfloat16",
         kern["written"][(MAIN_CASE, "bfloat16")],
         {"serving decode steps (CUDA graph replays and the capture's warm-up step)":
          eng["launches"]["fused"]}),
        ("decode_attention_chunk", "chunk", CHUNK_CASE, "bfloat16",
         kern["written"][(CHUNK_CASE, "bfloat16")],
         {"serving prefill chunks": eng["launches"]["chunk"]}),
        ("decode_attention", "split", SPLIT_CASE, "float32", kern["cases"][(SPLIT_CASE, "float32")],
         split_paths),
    ):
        entry = {
            "name": name,
            "route": "cuda",
            "source": decode_src,
            "replaces": decode_tpu,
            "launches": sum(by_path.values()),
            "variant": var,
            "launches_by_path": by_path,
            "max_abs_err": r["max_abs_err"],
            "ms": r["ms"],
            "device_ms": r["device_ms"],
            "queued_ms": r["queued_ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
            "held": True,
            "shape": decode_shape(case, tname),
        }
        if var == "chunk":
            entry["full_width_chain_launches"] = pre["chain_launches"]["chunk"]
        if var == "split":  # the variant the chunk kernel replaced at the engine's chunk call
            entry["at_chunk_case"] = {k: split_at_chunk[k] for k in (
                "queued_ms", "plain_ms", "library_ms", "bound_ms", "max_abs_err")}
        line["kernels"].append(entry)
    for name, kind, launches, by_path in (
        ("flash_attention", "fwd", train["launches"][0] + pre["launches"],
         {"train": train["launches"][0], "prefill": pre["launches"]}),
        ("flash_attention_bwd", "bwd", train["launches"][1], {"train": train["launches"][1]}),
    ):
        r = fm[kind]
        line["kernels"].append({
            "name": name,
            "route": "cuda",
            "source": flash_src,
            "replaces": flash_tpu,
            "launches": launches,
            "variant": fm["variant"],
            "launches_by_path": by_path,
            "max_abs_err": r["max_abs_err"],
            "ms": r["ms"],
            "device_ms": r["device_ms"],
            "queued_ms": r["queued_ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
            "held": True,
            "shape": flash_shape,
        })
    gtr = gem["train"]
    for name, kind, by_path in (
        ("flash_attention_dh256", "fwd",
         {"gemma3 prefill": gem["prefill_launches"],
          f"gemma3 train ({gtr['depth']} layers, 5 steps, remat full)": gtr["launches"][0],
          "gemma3 6-layer check": gem["check_launches"]}),
        ("flash_attention_dh256_bwd", "bwd",
         {f"gemma3 train ({gtr['depth']} layers, 5 steps)": gtr["launches"][1]}),
    ):
        r = flash["cases"][(GEMMA_LOCAL, "bfloat16")]
        g = flash["cases"][(GEMMA_GLOBAL, "bfloat16")]
        w = flash["cases"][(FLASH_WMMA, "bfloat16")]
        check(r["variant"] == g["variant"] == "wgmma" and min(by_path.values()) > 0,
              f"{name}: launches {by_path}, variants {r['variant']}/{g['variant']}")
        c = next(c for c in FLASH_CASES if c[0] == GEMMA_LOCAL)
        line["kernels"].append({
            "name": name,
            "route": "cuda",
            "source": flash_src,
            "replaces": flash_tpu,
            "launches": sum(by_path.values()),
            "variant": r["variant"],
            "launches_by_path": by_path,
            "max_abs_err": r[kind]["max_abs_err"],
            "ms": r[kind]["ms"],
            "device_ms": r[kind]["device_ms"],
            "queued_ms": r[kind]["queued_ms"],
            "plain_ms": r[kind]["plain_ms"],
            "bound_ms": r[kind]["bound_ms"],
            "bound_by": r[kind]["bound_by"],
            "library_ms": r[kind]["library_ms"],
            "held": True,
            "shape": {"case": GEMMA_LOCAL, "B": c[1], "S": c[2], "Hq": c[3], "Hkv": c[4],
                      "dh": c[5], "causal": c[6], "window": c[7], "dtype": "bfloat16"},
            "global": {k: g[kind][k] for k in (
                "queued_ms", "plain_ms", "library_ms", "bound_ms", "max_abs_err")},
            "wmma_dh256_G3": {k: w[kind][k] for k in (
                "queued_ms", "plain_ms", "library_ms", "bound_ms", "max_abs_err")},
        })
    bm = bag["cases"][(BAG_MAIN, "float32")]
    bag_case = next(c for c in BAG_CASES if c[0] == BAG_MAIN)
    line["kernels"].append({
        "name": "embedding_bag",
        "route": "cuda",
        "source": BAG_SRC,
        "replaces": BAG_TPU,
        "launches": rec["launches"],
        "launches_by_path": {"recsys serving": rec["launches"]},
        "max_abs_err": bm["max_abs_err"],
        "ms": bm["ms"],
        "device_ms": bm["device_ms"],
        "queued_ms": bm["queued_ms"],
        "l2_flushed_ms": bm["flushed_ms"],
        "plain_ms": bm["plain_ms"],
        "bound_ms": bm["bound_ms"],
        "bound_by": bm["bound_by"],
        "library_ms": bm["library_ms"],
        "held": True,
        "shape": {"case": BAG_MAIN, "arch": bag_case[1], "cell": bag_case[2],
                  "combiner": bag_case[3], "dtype": "float32"},
    })
    am = agg["cases"][(AGG_MAIN, "float32")]
    skew = agg["cases"][(AGG_SKEW, "float32")]["csr"]
    mb_path = f"gnn train minibatch_lg ({gtrain['steps']} steps)"
    for i, (name, kind) in enumerate((("gnn_aggregate", "fwd"), ("gnn_aggregate_bwd", "bwd"))):
        r, e = am["csr"][kind], am["ell"][kind]
        by_path = {mb_path: gtrain["launches"][i],
                   "gnn train full_graph_sm (1 step)": gtrain["launches_full_graph"][i]}
        line["kernels"].append({
            "name": name,
            "route": "cuda",
            "source": AGG_SRC,
            "replaces": AGG_TPU,
            "layout": "csr",  # the model's call (with den); ell_*: the padded-ELL contract
            "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "launches_per_step": gtrain["launches"][i] // gtrain["steps"],
            "max_abs_err": r["max_abs_err"],
            "ms": r["ms"],
            "device_ms": r["device_ms"],
            "queued_ms": r["queued_ms"],
            "l2_flushed_ms": r["flushed_ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"],
            "library_ms": None,  # no single PyTorch call computes the gated aggregation
            "yardstick_ms": r["yardstick_ms"],
            "yardstick": "index_add_ of eta * h[src] and of eta (the reference model's "
                         "segment sums)",
            "ell_max_abs_err": e["max_abs_err"],
            "ell_ms": e["ms"],
            "ell_queued_ms": e["queued_ms"],
            "ell_l2_flushed_ms": e["flushed_ms"],
            "ell_plain_ms": e["plain_ms"],
            "ell_bound_ms": e["bound_ms"],
            "ell_bound_by": e["bound_by"],
            **({"ell_dense_gates_l2_flushed_ms": e["dense_flushed_ms"]}
               if "dense_flushed_ms" in e else {}),
            "power_law_queued_ms": skew[kind]["queued_ms"],
            "power_law_bound_ms": skew[kind]["bound_ms"],
            "held": True,
            "shape": {"case": AGG_MAIN, "N": 169_984, "E": 168_960, "dim": 70,
                      "dtype": "float32", "ell_max_deg": 15,
                      "power_law": {"N": REDDIT_NODES, "E": REDDIT_EDGES_CUT}},
        })
    print(f"total: {time.perf_counter() - t0:.3f} s on {card}")
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
