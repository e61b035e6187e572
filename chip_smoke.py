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
with their times; trains full-width TinyLlama-1.1B (bf16, B 4 x S 2048) for
one warm-up and three timed steps through ``build_train_step``, counting the
flash launches, and profiles one more step; trains an fp32 smoke model five
steps on the card and on the CPU and compares them; runs ``TrainDriver``
with checkpoints and an injected failure on the card; and prefills 2,048
tokens at full width, then checks ``prefill`` against a chain of
``prefill_chunk`` calls on a smoke model.

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
    worst = 0.0
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
            worst = max(worst, err)
            ms = cuda_ms(lambda: ops.decode_attention(q, k, v, q_start, window=window))
            plain_ms = cuda_ms(lambda: ops.decode_attention_plain(q, k, v, q_start, window=window))
            lib_ms = cuda_ms(lambda: library_call(q, k, v, q_start, window))
            dev_ms = kernel_device_ms(lambda: ops.decode_attention(q, k, v, q_start, window=window))
            bms, by = bound_ms(case, dtype)
            results[(label, tname)] = dict(ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                                           library_ms=lib_ms, bound_ms=bms, bound_by=by,
                                           max_abs_err=err)
            print(f"kernel time  {label:18s} {tname:8s} ms {ms:.6f} device_ms {dev_ms:.6f} "
                  f"plain_ms {plain_ms:.6f} library_ms {lib_ms:.6f} bound_ms {bms:.6f} ({by})")
    return {"cases": results, "max_abs_err": worst}


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


def kernel_device_ms(fn, iters: int = 20) -> float:
    """Device time per call of the kernels ``fn`` launches, from the profiler."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    evs = device_events(prof)
    return sum(e.time_range.elapsed_us() for e in evs) / iters / 1e3 if evs else float("nan")


# --------------------------------------------------------------------------
# phase: device path against the CPU path
# --------------------------------------------------------------------------
def leaves(tree):
    """Leaves in sorted-key order (the order the store rebuilds dicts in)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k])
    else:
        yield tree


def to_device(tree, dev):
    if isinstance(tree, dict):
        return {k: to_device(v, dev) for k, v in tree.items()}
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
    worst = {"fwd": 0.0, "bwd": 0.0}
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
            for name, got, ref in zip(("out", "lse", "dq", "dk", "dv"), (out, lse, *grads),
                                      want):
                diff = (got.float() - ref).abs()
                err = diff.max().item()
                # torch.testing.assert_close's rule with atol = rtol = tol
                ratio = (diff / (tol + tol * ref.abs())).max().item()
                print(f"flash check {label:16s} {tname:8s} {name:3s} max_abs_err {err:.3e} "
                      f"tol atol=rtol={tol:.0e} worst err/(atol+rtol*|ref|) {ratio:.3f}")
                check(math.isfinite(err) and ratio <= 1.0,
                      f"flash_attention {label} {tname} {name}: max_abs_err {err}, "
                      f"worst ratio {ratio} > 1")
                kind = "fwd" if name in ("out", "lse") else "bwd"
                worst[kind] = max(worst[kind], err)
            del want
            fwd = lambda: ops.flash_attention_fwd(q, k, v, causal=causal, window=window)
            bwd = lambda: ops.flash_attention_bwd(q, k, v, out, lse, dout, causal=causal,
                                                  window=window)
            row = {}
            for kind, fn in (("fwd", fwd), ("bwd", bwd)):
                bms, by = flash_bound_ms(case, dtype, kind == "bwd")
                row[kind] = dict(ms=cuda_ms(fn, iters=iters, warmup=2),
                                 device_ms=kernel_device_ms(fn, iters=min(iters, 10)),
                                 bound_ms=bms, bound_by=by)
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
                print(f"flash time  {label:16s} {tname:8s} {kind} ms {r['ms']:.6f} "
                      f"device_ms {r['device_ms']:.6f} plain_ms {r['plain_ms']:.6f} "
                      f"library_ms {r['library_ms']:.6f} bound_ms {r['bound_ms']:.6f} "
                      f"({r['bound_by']})")
            results[(label, tname)] = row
            del q, k, v, dout, out, lse, grads, qg, kg, vg
            torch.cuda.empty_cache()
    return {"cases": results, "max_abs_err": worst}


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
    from repro_torch.kernels.flash_attention import flash_attention
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
    flash_attention.launches_fwd = flash_attention.launches_bwd = 0
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
            "profile": prof}


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
    from repro_torch.kernels.flash_attention import flash_attention
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
    flash_attention.launches_fwd = flash_attention.launches_bwd = 0
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
    check(clen.tolist() == [2048] and cache["k"].shape == (cfg.n_layers, 1, 2048, 4, 64),
          "prefill: cache shape or length")
    del params, cache, logits
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
    return {"launches": launches, "ms": ms}


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

    def timed(fn):
        t = time.perf_counter()
        out = fn(dev)
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
        "max_abs_err": kern["max_abs_err"],
        "ms": m["ms"],
        "device_ms": m["device_ms"],
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
            "launches_by_path": by_path,
            "max_abs_err": flash["max_abs_err"][kind],
            "ms": r["ms"],
            "device_ms": r["device_ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
            "held": True,
            "shape": flash_shape,
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
