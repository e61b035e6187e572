#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving and training paths on one NVIDIA H100.

    python3 chip_smoke.py

In order it: prints the card's name and power limit; builds every CUDA
kernel of the port from the sources in this checkout (one nvcc per source,
all at once); holds the decode-attention kernel against its plain torch
version on the card at TinyLlama-1.1B's attention shapes (and gemma3-like
and smoke shapes), with the kernel's, the plain version's and a library
call's times; serves six full-width TinyLlama-1.1B requests (bf16, random
weights from a seeded CUDA generator) through ``repro_torch.serve.ServeEngine``,
counting the kernel's launches; checks an fp32 smoke engine on the card
against the same engine on the CPU, token for token; holds the flash-attention
kernels (forward: out and logsumexp; backward: dq, dk, dv) against the plain
version plus autograd at the training, gemma3-like, smoke and ragged shapes,
with their times and the variant (``wgmma``, ``wmma`` or ``fma``) that each
shape takes; trains full-width TinyLlama-1.1B (bf16, B 4 x S 2048) for
one warm-up and three timed steps through ``build_train_step``, counting the
flash launches by variant (all must be ``wgmma``), and profiles one more step; trains an fp32 smoke model five
steps on the card and on the CPU and compares them; runs ``TrainDriver``
with checkpoints and an injected failure on the card; and prefills 2,048
tokens at full width (every flash call ``wgmma``) and profiles one more
prefill, then checks ``prefill`` against a chain of
``prefill_chunk`` calls on a smoke model.

Then the recsys and GNN paths: it holds the embedding-bag kernel against its
plain version at the FM, DCN-v2 and retrieval lookup shapes over the
full-size tables (and a SASRec-like mean and a smoke case); serves FM,
DCN-v2, BST and SASRec at full width through ``build_serve_step`` at
``serve_p99``, ``serve_bulk`` and ``retrieval_cand``, counting the kernel's
launches and profiling one ``serve_p99`` call per model, and checks the fp32
smoke models on the card against the CPU; holds the gated-aggregation
kernels (forward, and the backward's dh and dgates) against the plain version
plus autograd at the ``minibatch_lg`` block, a Cora-scale graph and a smoke
graph, and checks that two backward runs give equal bits (each kernel's
device time is read back to back under the profiler and by CUDA events
behind a device sleep that hides the host; the embedding bag's and the
aggregation's also under the profiler with the L2 evicted before each call,
and the forward once more with every gate nonzero, a control for the
block's zero padding gates); and trains
full-width GatedGCN through ``build_train_step`` on ``minibatch_lg`` blocks
sampled from a synthetic power-law graph (one warm-up, three timed steps,
one profiled), takes one ``full_graph_sm`` step, and trains an fp32 smoke
GatedGCN five steps on the card and on the CPU and compares them.

It needs a CUDA card and the ``repro_torch`` package beside it (under
``src/``); without either it fails before printing any result.  Any failed
check exits non-zero.  The last line is a JSON object naming the device.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
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


def bound_ms(case, dtype) -> tuple[float, str]:
    """Least time: bytes moved (q, visible K/V and q_start read once, out
    written once) over HBM rate, or operations (2 per multiply-add in QK^T and
    PV over the unmasked pairs) over the peak rate for the input type."""
    _, B, S, T, Hq, Hkv, dh, q_start, window = case
    isz = torch.finfo(dtype).bits // 8
    nbytes = (2 * B * S * Hq * dh + 2 * visible_keys(q_start, S, T, window) * Hkv * dh) * isz
    nbytes += 4 * B
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

    results = {}
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
    return {"cases": results}


# --------------------------------------------------------------------------
# phase: full-width serving
# --------------------------------------------------------------------------
def phase_engine(dev) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.models.layers import init_params
    from repro_torch.models.transformer import lm_specs
    from repro_torch.serve import ServeEngine

    cfg = get_config("tinyllama-1.1b")  # full width, bf16
    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_params(gen, lm_specs(cfg), cfg.dtype, dev)
    engine = ServeEngine(cfg, params, max_len=1024, chunk=64, device=dev)
    n_par = n_bytes = 0
    for t in leaves(params):
        n_par += t.numel()
        n_bytes += t.numel() * t.element_size()
    print(f"engine: {cfg.name} params {n_par} bytes {n_bytes} decode bound "
          f"(weights read once per token) {n_bytes / HBM_BYTES_PER_S * 1e3:.6f} ms")

    # every logits tensor the engine computes is checked for finiteness on
    # the device; the flags are read once at the end
    finite: list[torch.Tensor] = []
    for name in ("_prefill", "_decode"):
        inner = getattr(engine, name)

        def watched(tok, cache, cache_len, _inner=inner):
            out = _inner(tok, cache, cache_len)
            finite.append(torch.isfinite(out[0]).all())
            return out

        setattr(engine, name, watched)

    rng = np.random.default_rng(0)
    system = rng.integers(0, cfg.vocab, size=512).tolist()
    prompts = [system + rng.integers(0, cfg.vocab, size=64).tolist() for _ in range(6)]
    max_new = 32
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    decode_attention.launches = 0
    expected = 0
    rows = []
    for i, prompt in enumerate(prompts):
        before = decode_attention.launches
        out, st = engine.generate(prompt, max_new_tokens=max_new)
        n_launch = decode_attention.launches - before
        trimmed = 1 if st.chunks_skipped == st.n_chunks else 0
        calls = (st.n_chunks - st.chunks_skipped) + trimmed + st.n_new_tokens
        expected += cfg.n_layers * calls
        mem = torch.cuda.max_memory_allocated(dev)
        tps = st.n_new_tokens / st.decode_s
        print(f"req {i + 1}: chunks_skipped {st.chunks_skipped}/{st.n_chunks} "
              f"prefill_ms {st.prefill_s * 1e3:.3f} decode_ms {st.decode_s * 1e3:.3f} "
              f"decode_tok_s {tps:.2f} max_memory_allocated {mem} launches {n_launch}")
        check(len(out) == max_new, f"request {i + 1}: {len(out)} tokens, wanted {max_new}")
        check(n_launch == cfg.n_layers * calls,
              f"request {i + 1}: {n_launch} launches, wanted {cfg.n_layers} x {calls}")
        rows.append(dict(skipped=st.chunks_skipped, n=st.n_chunks, prefill_s=st.prefill_s,
                         decode_s=st.decode_s, tokens=st.n_new_tokens))
    launches = decode_attention.launches
    print(f"engine: launches {launches} expected {expected} snapshots {engine.n_snapshots}")
    check(launches == expected, f"launches {launches} != expected {expected}")
    for i in range(2, 6):
        check(rows[i]["skipped"] > 0, f"request {i + 1} skipped no chunk")
    check(bool(torch.stack(finite).all()), "non-finite logits on the main path")
    phase_profile(engine, prompts[-1], max_new)
    return {"launches": launches, "rows": rows}


# --------------------------------------------------------------------------
# phase: where one request's time goes
# --------------------------------------------------------------------------
def device_events(prof) -> list:
    return [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]


def phase_profile(engine, prompt, max_new: int) -> None:
    """One more request of the stream under torch.profiler (after the main
    path's launch count was read)."""
    stats = {}

    def request():
        _, stats["st"] = engine.generate(prompt, max_new_tokens=max_new)

    profile_call("request", request, n_kernels=8)
    st = stats["st"]
    print(f"profile request: chunks_skipped {st.chunks_skipped}/{st.n_chunks} "
          f"new_tokens {st.n_new_tokens}")


DEVICE_SLEEP_CYCLES = 100_000_000  # about 50 ms at the H100's 1.98 GHz


def kernel_device_ms(fn, iters: int = 20) -> tuple[float, float]:
    """Device time per call of the kernels ``fn`` launches, from the
    profiler's kernel records of back-to-back calls queued behind a device
    sleep: (their summed durations, the span from the first start to the
    last end), each over ``iters``."""
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


def phase_parity(dev) -> None:
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.models.layers import init_params
    from repro_torch.models.transformer import lm_specs
    from repro_torch.serve import ServeEngine

    cfg = dataclasses.replace(get_config("tinyllama-1.1b", smoke=True), dtype=torch.float32)
    gen = torch.Generator(device="cpu").manual_seed(0)
    cpu_params = init_params(gen, lm_specs(cfg), cfg.dtype, "cpu")
    dev_params = to_device(cpu_params, dev)
    on_dev = ServeEngine(cfg, dev_params, max_len=128, chunk=16, device=dev)
    on_cpu = ServeEngine(cfg, cpu_params, max_len=128, chunk=16, device="cpu")
    before = decode_attention.launches
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
    check(decode_attention.launches > before, "the device engine never launched the kernel")


# --------------------------------------------------------------------------
# phase: flash-attention kernels against the plain version plus autograd
# --------------------------------------------------------------------------
# (label, B, S, Hq, Hkv, dh, causal, window)
FLASH_CASES = [
    ("train", 4, 2048, 32, 4, 64, True, None),
    ("gemma3-like", 1, 2048, 8, 4, 256, True, 1024),
    ("smoke", 2, 64, 8, 2, 8, True, None),
    ("non-causal S200", 2, 200, 8, 2, 64, False, None),
]
FLASH_MAIN = "train"  # the shape of every attention call of the train step


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


def phase_flash(dev) -> dict:
    from repro_torch.kernels.flash_attention import attention_ref
    from repro_torch.kernels.flash_attention import ops

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
            for kind, fn in (("fwd", fwd), ("bwd", bwd)):
                bms, by = flash_bound_ms(case, dtype, kind == "bwd")
                dms, sms = kernel_device_ms(fn, iters=min(iters, 10))
                row[kind] = dict(ms=cuda_ms(fn, iters=iters, warmup=2), device_ms=dms, span_ms=sms,
                                 queued_ms=queued_ms(fn), bound_ms=bms, bound_by=by,
                                 max_abs_err=errs[kind])
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
                      f"({r['bound_by']})")
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


def profile_call(label: str, fn, n_kernels: int = 10) -> dict:
    """``fn`` once under torch.profiler: wall time, the device's busy and
    idle share, and the kernels that take the device time."""
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
    return {"wall_ms": wall_us / 1e3, "busy_ms": busy_us / 1e3}


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


def phase_prefill(dev) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import decode_attention
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
    del params
    torch.cuda.empty_cache()

    # prefill (flash kernel) against a chain of prefill_chunk calls (decode kernel)
    scfg = dataclasses.replace(get_config("gemma3-4b", smoke=True), dtype=torch.float32)
    sp = init_params(torch.Generator(device=dev).manual_seed(1), transformer.lm_specs(scfg),
                     scfg.dtype, dev)
    stoks = torch.from_numpy(
        np.random.default_rng(1).integers(0, scfg.vocab, size=(2, 48)).astype(np.int32)
    ).to(dev)
    d0, f0 = decode_attention.launches, flash_attention.launches_fwd
    lg, c, cl = transformer.prefill(sp, scfg, stoks)
    chain = transformer.init_cache(scfg, 2, 64, dev)
    chain_len = torch.zeros(2, dtype=torch.int32, device=dev)
    for i in range(0, 48, 16):
        clg, chain, chain_len = transformer.prefill_chunk(sp, scfg, stoks[:, i:i + 16], chain,
                                                         chain_len)
    errs = [(lg - clg).abs().max().item(),
            (c["k"] - chain["k"][:, :, :48]).abs().max().item(),
            (c["v"] - chain["v"][:, :, :48]).abs().max().item()]
    print(f"prefill vs prefill_chunk chain (gemma3 smoke fp32, window 8): max_abs_err logits "
          f"{errs[0]:.3e} k {errs[1]:.3e} v {errs[2]:.3e} (tol 1e-4); flash launches "
          f"{flash_attention.launches_fwd - f0} decode launches {decode_attention.launches - d0}")
    check(max(errs) <= 1e-4 and torch.equal(cl, chain_len),
          f"prefill differs from the prefill_chunk chain: {errs}")
    check(flash_attention.launches_fwd > f0 and decode_attention.launches > d0,
          "prefill check: a kernel was not launched")
    return {"launches": launches, "ms": ms, "profile": prof}


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
REDDIT_NODES = 232_965
REDDIT_EDGES_CUT = 11_461_589  # a tenth of the published 114,615,892: keeps the host build short


def power_law_sampler(seed: int = 0):
    """A NeighborSampler (fanout 15-10) over a synthetic power-law graph with
    Reddit's node count and a tenth of its edges; the block shapes do not
    depend on the edge count."""
    from repro_torch.data import CSRGraph, NeighborSampler, random_graph

    t0 = time.perf_counter()
    ei = random_graph(REDDIT_NODES, REDDIT_EDGES_CUT, seed=seed)
    sampler = NeighborSampler(CSRGraph.from_edge_index(ei, REDDIT_NODES), (15, 10), seed=seed)
    print(f"graph: {REDDIT_NODES} nodes {REDDIT_EDGES_CUT} edges (power law) built in "
          f"{time.perf_counter() - t0:.3f} s; largest in-degree "
          f"{int(np.bincount(ei[1], minlength=REDDIT_NODES).max())}")
    return sampler


def agg_graphs(sampler) -> list:
    """(label, edge_index [2,E] numpy, n_nodes, dim) for the kernel checks."""
    block = sampler.sample(np.random.default_rng(0).choice(REDDIT_NODES, 1024, replace=False)
                           .astype(np.int32))
    r = np.random.default_rng(1)
    cora = r.integers(0, 2708, size=(2, 10752))  # full_graph_sm: make_batch's edges, padded
    smoke = r.integers(0, 40, size=(2, 160))
    return [(AGG_MAIN, block["edge_index"], block["nodes"].shape[0], 70),
            ("full_graph_sm", cora, 3072, 70), ("smoke", smoke, 40, 16)]


def agg_bound_ms(ell, n_rows: int, dim: int, itemsize: int, backward: bool) -> tuple[float, str]:
    """Least time.  Both ways read the neighbour table and the distinct rows
    of h it references once.  Forward bytes: those, every ELL gate (a
    padding slot cannot be told from an edge of row 0) read once, and the
    output written once.  Backward bytes: those, dout, the source index and
    the gates at the real slots only (dh needs no other) read once, dgates
    (every slot) and dh written once.  Operations: a multiply-add per gate
    element forward (2), a multiply per gate element and a multiply-add per
    real slot and element backward, at the fp32 rate."""
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


def phase_agg(dev, sampler) -> dict:
    from repro_torch.kernels.gnn_aggregate import ell_index, gnn_aggregate_ref
    from repro_torch.kernels.gnn_aggregate import ops

    results = {}
    gen = torch.Generator(device=dev).manual_seed(99)
    for label, ei, n, dim in agg_graphs(sampler):
        ell = ell_index(ei, n, dev)
        src, dst = (torch.from_numpy(np.asarray(a)).to(dev).long() for a in ei)
        E = src.numel()
        for dtype in (torch.float32, torch.bfloat16):
            tname = str(dtype).replace("torch.", "")
            h = torch.randn(n, dim, generator=gen, device=dev).to(dtype)
            eta = torch.rand(E, dim, generator=gen, device=dev).to(dtype)
            gates = torch.zeros(n * ell.max_deg, dim, device=dev, dtype=dtype)
            gates.index_copy_(0, ell.slot, eta)
            gates = gates.view(n, ell.max_deg, dim)
            dout = torch.randn(n, dim, generator=gen, device=dev).to(dtype)
            h32, g32 = (t.float().requires_grad_(True) for t in (h, gates))
            ref_out = gnn_aggregate_ref(h32, ell.nbr, g32)
            ref = (ref_out.detach(), *torch.autograd.grad(ref_out, (h32, g32), dout.float()))
            del ref_out, h32, g32
            out = ops.gnn_aggregate_fwd(h, ell.nbr, gates)
            dh, dg = ops.gnn_aggregate_bwd(h, ell.nbr, gates, dout, *ell.rev)
            dh2, dg2 = ops.gnn_aggregate_bwd(h, ell.nbr, gates, dout, *ell.rev)
            torch.cuda.synchronize()
            same = torch.equal(dh, dh2) and torch.equal(dg, dg2)
            del dh2, dg2
            tol = TOL[dtype]
            errs = {"fwd": 0.0, "bwd": 0.0}
            for name, got, want in zip(("out", "dh", "dgates"), (out, dh, dg), ref):
                err, ratio = assert_close_ratio(got, want, tol)
                print(f"agg check {label:18s} {tname:8s} {name:6s} N {n} max_deg {ell.max_deg} "
                      f"dim {dim} max_abs_err {err:.3e} tol atol=rtol={tol:.0e} "
                      f"worst ratio {ratio:.3f}")
                check(math.isfinite(err) and ratio <= 1.0,
                      f"gnn_aggregate {label} {tname} {name}: max_abs_err {err}, ratio {ratio}")
                kind = "fwd" if name == "out" else "bwd"
                errs[kind] = max(errs[kind], err)
            print(f"agg check {label:18s} {tname:8s} backward equal bit for bit over two runs: "
                  f"{same}")
            check(same, f"gnn_aggregate {label} {tname}: the backward is not deterministic")
            del ref, out, dh, dg
            iters = 10 if n > 10**5 else 50
            fwd = lambda: ops.gnn_aggregate_fwd(h, ell.nbr, gates)
            bwd = lambda: ops.gnn_aggregate_bwd(h, ell.nbr, gates, dout, *ell.rev)
            row = {}
            for kind, fn in (("fwd", fwd), ("bwd", bwd)):
                bms, by = agg_bound_ms(ell, n, dim, h.element_size(), kind == "bwd")
                dms, sms = kernel_device_ms(fn, iters=min(iters, 10))
                row[kind] = dict(ms=cuda_ms(fn, iters=iters, warmup=2), device_ms=dms, span_ms=sms,
                                 queued_ms=queued_ms(fn), flushed_ms=flushed_ms(fn),
                                 bound_ms=bms, bound_by=by, library_ms=None,
                                 max_abs_err=errs[kind])
            if label == AGG_MAIN:
                # control for the data: the same forward with every slot's gate
                # nonzero (93% of the block's slots are padding, whose gates are 0)
                dense = torch.rand(gates.shape, generator=gen, device=dev).to(dtype)
                row["fwd"]["dense_flushed_ms"] = flushed_ms(
                    lambda: ops.gnn_aggregate_fwd(h, ell.nbr, dense))
                print(f"agg time  {label:18s} {tname:8s} fwd with every gate nonzero: "
                      f"l2_flushed_ms {row['fwd']['dense_flushed_ms']:.6f}")
                del dense
            hg, gg = (t.clone().requires_grad_(True) for t in (h, gates))
            row["fwd"]["plain_ms"] = cuda_ms(lambda: gnn_aggregate_ref(h, ell.nbr, gates),
                                             iters=iters, warmup=2)
            plain_out = gnn_aggregate_ref(hg, ell.nbr, gg)
            row["bwd"]["plain_ms"] = backward_ms(plain_out, (hg, gg), dout, iters)
            del plain_out
            # yardstick, labelled as such: the reference model's segment-sum form,
            # index_add_ of eta * h[src] (its own inputs: eta per edge, not ELL gates)
            seg = lambda e_, h_: torch.zeros(n, dim, device=dev, dtype=dtype).index_add_(
                0, dst, e_ * h_[src])
            row["fwd"]["yardstick_ms"] = cuda_ms(lambda: seg(eta, h), iters=iters, warmup=2)
            eg = eta.clone().requires_grad_(True)
            seg_out = seg(eg, hg)
            row["bwd"]["yardstick_ms"] = backward_ms(seg_out, (hg, eg), dout, iters)
            del seg_out, hg, gg, eg
            for kind in ("fwd", "bwd"):
                r = row[kind]
                print(f"agg time  {label:18s} {tname:8s} {kind} ms {r['ms']:.6f} device_ms "
                      f"{r['device_ms']:.6f} device_span_ms {r['span_ms']:.6f} queued_ms "
                      f"{r['queued_ms']:.6f} l2_flushed_ms {r['flushed_ms']:.6f} "
                      f"plain_ms {r['plain_ms']:.6f} "
                      f"yardstick_index_add_ms {r['yardstick_ms']:.6f} bound_ms "
                      f"{r['bound_ms']:.6f} ({r['bound_by']})")
            results[(label, tname)] = row
            del h, eta, gates, dout
            torch.cuda.empty_cache()
    return {"cases": results}


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
    from repro_torch.kernels.gnn_aggregate import gnn_aggregate
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
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    gnn_aggregate.launches_fwd = gnn_aggregate.launches_bwd = 0
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
    mem = torch.cuda.max_memory_allocated(dev)
    timed = rows[1:]
    mean_s = sum(r["step_s"] for r in timed) / len(timed)
    print(f"gnn train: {cfg.name} minibatch_lg (1024 seeds, fanout 15-10, 169984 nodes, "
          f"168960 edges, d_feat 602) fp32: mean step_ms {mean_s * 1e3:.3f} seeds_per_s "
          f"{1024 / mean_s:.1f} max_memory_allocated {mem}; aggregation launches in the "
          f"{n_steps} steps fwd {launches[0]} bwd {launches[1]}")

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
    gnn_aggregate.launches_fwd = gnn_aggregate.launches_bwd = 0
    t0 = time.perf_counter()
    fstate, m = build_train_step(cfg, fcell)(fstate, fbatch)
    loss = float(m["loss"])
    dt = time.perf_counter() - t0
    full = [gnn_aggregate.launches_fwd, gnn_aggregate.launches_bwd]
    print(f"gnn train full_graph_sm: loss {loss:.6f} step_ms {dt * 1e3:.3f} (first call) "
          f"agg_fwd {full[0]} agg_bwd {full[1]}")
    check(math.isfinite(loss) and full == [cfg.n_layers, cfg.n_layers],
          f"full_graph_sm step: loss {loss}, {full[0]}/{full[1]} aggregations")
    del fstate, fbatch
    torch.cuda.empty_cache()
    return {"launches": launches, "steps": n_steps, "launches_full_graph": full, "rows": rows,
            "mean_step_s": mean_s, "max_memory": mem, "profile": prof}


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
        return out

    kern = timed(phase_kernels)
    eng = timed(phase_engine)
    timed(phase_parity)
    flash = timed(phase_flash)
    train = timed(phase_train)
    timed(phase_train_parity)
    timed(phase_driver)
    pre = timed(phase_prefill)
    bag = timed(phase_bag)
    rec = timed(phase_recsys)
    sampler = power_law_sampler()
    agg = timed(phase_agg, sampler)
    gtrain = timed(phase_gnn_train, sampler)
    timed(phase_gnn_parity)

    main_case = next(c for c in KERNEL_CASES if c[0] == MAIN_CASE)
    m = kern["cases"][(MAIN_CASE, "bfloat16")]
    flash_case = next(c for c in FLASH_CASES if c[0] == FLASH_MAIN)
    flash_shape = {"B": flash_case[1], "S": flash_case[2], "Hq": flash_case[3],
                   "Hkv": flash_case[4], "dh": flash_case[5], "causal": flash_case[6],
                   "dtype": "bfloat16"}
    fm = flash["cases"][(FLASH_MAIN, "bfloat16")]
    flash_src = "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu"
    flash_tpu = "src/repro/kernels/flash_attention/kernel.py:114"
    line = {"kernels": [{
        "name": "decode_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/decode_attention/csrc/decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention/kernel.py:106",
        "launches": eng["launches"],
        "max_abs_err": m["max_abs_err"],
        "ms": m["ms"],
        "device_ms": m["device_ms"],
        "queued_ms": m["queued_ms"],
        "plain_ms": m["plain_ms"],
        "bound_ms": m["bound_ms"],
        "bound_by": m["bound_by"],
        "library_ms": m["library_ms"],
        "held": True,
        "shape": {"B": main_case[1], "S": main_case[2], "T": main_case[3], "Hq": main_case[4],
                  "Hkv": main_case[5], "dh": main_case[6], "q_start": main_case[7],
                  "dtype": "bfloat16"},
    }]}
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
    mb_path = f"gnn train minibatch_lg ({gtrain['steps']} steps)"
    for i, (name, kind) in enumerate((("gnn_aggregate", "fwd"), ("gnn_aggregate_bwd", "bwd"))):
        r = am[kind]
        by_path = {mb_path: gtrain["launches"][i],
                   "gnn train full_graph_sm (1 step)": gtrain["launches_full_graph"][i]}
        line["kernels"].append({
            "name": name,
            "route": "cuda",
            "source": AGG_SRC,
            "replaces": AGG_TPU,
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
            "library_ms": None,  # no single PyTorch call computes the gated ELL aggregation
            "yardstick_ms": r["yardstick_ms"],
            "yardstick": "index_add_ of eta * h[src] (the reference model's segment-sum form)",
            **({"dense_gates_l2_flushed_ms": r["dense_flushed_ms"]}
               if "dense_flushed_ms" in r else {}),
            "held": True,
            "shape": {"case": AGG_MAIN, "N": 169_984, "max_deg": 15, "dim": 70,
                      "dtype": "float32"},
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
