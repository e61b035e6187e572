#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving and training paths on one NVIDIA H100.

    python3 chip_smoke.py

In order it: prints the card's name and power limit; builds every CUDA
kernel of the port from the sources in this checkout (one nvcc per source,
all at once); prints ptxas's report of every decode kernel (a chunk or bf16 fused
kernel that spills fails the run); holds the decode-attention kernels against
their plain torch versions on the card at TinyLlama-1.1B's attention
shapes (and gemma3 and smoke shapes), with the kernels', the plain
versions' and a library call's times: the split variant at every shape,
then at every shape the variant that writes the new K/V rows and attends
(fused at one query row per sequence: the grid from ``plan_fused``, each
block's keys cut from the live length on the card, splits combined in a
cluster and past it through a workspace, bf16 on ``mma.sync``, and at T
65,536 and 131,072 too, then one captured call replayed while the length
crosses split boundaries, bit for bit against eager calls; chunk
at the bf16 chunk shapes up to dh 256, ``wgmma``, each beside the split
variant's route at the same shape and a sweep of cluster sizes; split,
after two index writes, for fp32 and dh 8), with written caches and
reruns equal bit for bit; serves six full-width TinyLlama-1.1B requests
(bf16, random weights from a seeded CUDA generator) through
``repro_torch.serve.ServeEngine``, which prefills chunks eagerly (chunk
variant, no index write) and decodes by replaying a CUDA graph of
``decode_step`` (fused variant), counting each variant's kernels, and
times eager ``decode_step`` against graph replays
from one cache state; checks an fp32 smoke engine on the card (graph
replays; its chunks on the split variant) against the same engine on the
CPU, token for token; prints ptxas's registers and spills for every flash
kernel (the ``wgmma``, ``wgmma_rows`` and ``tf32x3`` kernels, the fused bf16
backward's delta, key-tile and dq conversion kernels; one that spills fails
the run); holds the flash-attention kernels (forward: out
and logsumexp; backward: dq, dk, dv) against the plain version plus autograd
at the training shape, gemma3-4b's local and global layers (dh 256), head
dims 192 and 136 at G 2 and 8, groups that do not divide 64 (the
``wgmma_rows`` kernels: a dh-256 shape at G 3, and small shapes at G 72 and
at G 5 with dh 256), and smoke and ragged shapes, with their times and the
variant (``wgmma``, ``wgmma_rows`` or ``tf32x3``) that each shape takes, one
full-width fp32 backward run twice and held equal bit for bit; trains
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

Then the MoE and MLA families at full width, bf16: deepseek-7b (dense MHA,
dh 128) and qwen2-moe-a2.7b (60 routed experts top-4 and 4 shared, MHA at
dh 128) each serve the six requests (chunk and fused kernels at dh 128, G 1;
one fused kernel a layer in the decode graph; later requests skip chunks;
graph replays token-equal to eager ``decode_step`` from one state; decode ms
per token against the weights read once and, for qwen2-moe, the active
weights alone; the share of routed pairs capacity dropped) and prefill
2,048 tokens (flash at dh 128; qwen2-moe's two groups of 1,024, C 86);
deepseek-v2-236b at full width cut to 4 of its 60 layers (MLA: the latent
cache, whose snapshot bytes a token are printed against an MHA cache's; no
decode kernel) serves three requests and holds a 1,024-token ``forward``
(flash at dh 192 with values of 128, every launch the (3, 2) chunk
instantiation) against one ``prefill_chunk`` over the same tokens (the
absorbed attention); each family's flash shape, forward and backward (for
deepseek-v2 on the values as they are, and beside it on values padded to
192, the earlier design), is held against fp32 autograd of the plain version
and timed beside its bound, the plain version and SDPA.  Then card against CPU in fp32: the
three smoke configs and gemma3's at dh 256 (window 8: the split and fused
variants at dh 256 with the window biting) through two engines (tokens
equal), and qwen2-moe-a2.7b
at full width cut to 2 layers (a 64-token chunk and 4 decode steps within
1e-4 of the largest logit; the router's expert ids and slots equal on both
devices).  Then the three families train at full width and cut depth (bf16,
B 1 x S 2048, deepseek-7b, qwen2-moe-a2.7b and deepseek-v2-236b at the
depths of FAMILY_TRAIN): first, on the parameters alone, a gradient under
remat full against remat none with each layer's recomputed routing equal
bit for bit to its forward's, qwen2-moe's gradient taken twice (equal bits,
or the leaves that differ named), and deepseek-v2's gradient through the
flash kernels against the plain attention in fp32 (routing free and
replayed; norms and attention leaves within 5e-2); then one warm-up and
three timed AdamW steps (step ms, tokens/s, peak memory, the flash launches
of each step, the routed pairs capacity dropped); then each family's smoke
config trains five fp32 steps on the card and on the CPU (losses and
parameters within 1e-4, routing equal at every step).

Then the recsys and GNN paths: it prints ptxas's registers and spills for
every embedding-bag instantiation (a spill fails the run) and holds the
embedding-bag kernel, fp32 and bf16, against its plain versions at every bag
shape the recsys ``serve_bulk`` path launches over the full-size tables
(FM's field sums, its linear term at width 1 and its ``rows()`` bags of
one; DCN-v2's, BST's and SASRec's bags of one), at the retrieval
candidates, a SASRec-like weighted mean, a smoke case and 1,024 bags of
4,096 ids: bit for bit against ``embedding_bag_seq_ref`` (the kernel's
arithmetic) and within TOL of ``embedding_bag_ref``, with its times beside
the bound, a sector-rounded diagnostic, the plain version and the library
call; holds the embedding-bag backward kernel (the table's gradient over a
reverse index sorted on the card), fp32 and bf16, at the same cases, at the
recsys train path's three shapes (FM's field sums, DCN-v2's bags of one,
SASRec's history at ``train_batch``) and at a hub row whose positions span
4,096 chunks: bit for bit against ``embedding_bag_bwd_seq_ref``, equal bits
on a second call, and within TOL plus the bound of a sequential fp32 sum of
the fp64 gradient, with the kernel's and the whole call's times (index, zero
fill, kernel) beside the bound, the zero fill's bound, autograd of the plain
version and the library's backward at the train shapes; serves FM,
DCN-v2, BST and SASRec at full width through ``build_serve_step`` at
``serve_p99``, ``serve_bulk`` and ``retrieval_cand``, counting the kernel's
launches by model and cell and profiling one ``serve_p99`` call per model
and FM's ``serve_bulk`` call by kernel, and checks the fp32 smoke models on
the card against the CPU; trains the four at full width in fp32 through
``build_train_step`` at ``train_batch`` (B 65,536): one step's gradients
taken twice from the same state must be equal bit for bit, then three steps
(finite metrics; one forward and one backward bag launch a lookup: FM 3,
DCN-v2 1, BST 1, SASRec 3), each timed by CUDA events, peak memory, and one
profiled step that must hold no kernel of a plain table gradient (the
wrapper's plain path is watched and must never run on the card); and trains
the fp32 smoke models five AdamW steps on the card and on the CPU and
compares them; builds the gated aggregation's
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
GatedGCN five steps on the card and on the CPU and compares them.  Then the
two GatedGCN cells no phase above runs, at full width (16 layers, d_hidden
70, 47 classes, fp32) through ``build_train_step`` and AdamW on
``make_batch``'s graphs: ``molecule`` at its full size (B 128 graphs of 30
nodes and 64 edges through ``forward_batched``; the first step's loss and
every gradient leaf held against the CPU's within 1e-4 of the leaf's largest
value; 16 + 16 aggregation launches a step, all on the CSR index), and
``ogb_products`` cut in scale, not in shape (nodes and edges by one factor,
the largest whose dry-run peak lies under 75 GB, remat full; the cut goes
into ``reduced``), with its index build's device time; then the aggregation
kernels at ogb_products' full published size (2,449,029 rows and 61,859,140
slots x 70 fp32, past 2^31 elements) on ``make_batch``'s uniform graph and
on a power-law graph of the same counts drawn on the card: two backward runs
equal bit for bit, every output against the same function in fp64 and (on
the uniform graph) against the plain version in row blocks, the times
beside the bound, the plain version and the ``index_add_`` yardstick.  Then
the dry-run (``repro_torch.launch.dryrun``, on the meta device) reckons
each step whose peak a phase measured (TinyLlama's, the three families',
``minibatch_lg``'s and the two new cells'): its peak within 10% of the
step's measured one, its roofline time at most the measured step time,
TinyLlama's counted FLOPs within 10% of ``model_flops``; it prints the depth
it gives each family under 75 GB beside FAMILY_TRAIN's, and holds its flash
scratch sizes to the library's.

Last, the thesis's workflow path at full TinyLlama-1.1B width: a 64 MB
corpus on the card goes through tokenize -> pack -> split (the port's
``data/pipeline.py``) -> train (4 AdamW steps of B 4 x S 2048 from seeded
weights; 2.2 GB of bf16 weights out) -> eval (per-row cross-entropy of two
held-out rows chosen by a parameter) in ``WorkflowExecutor`` over an
``IntermediateStore`` in a temporary directory, with RISP: cold runs until
RISP admits the train prefix, reuse runs that skip tokenize to train (eval
equal bit for bit to the cold runs'), a run whose eval raises once and its
resumed run (restarting at the failure point), and ``t1_gt_t2`` runs whose
Eq. 4.9 decision must be the one its t1 and t2 give; each run printed with
its module, save and load seconds and bytes, and the train module's
seconds held at or above its steps' device time (CUDA events in the
module), beside one call's host time with no device wait.  Then the same
DAG (the prefix, two eval branches) twice at once through ``DagScheduler``
over a fresh store: train computed once, by single-flight, and every branch
equal bit for bit to the sequential runs.  Then two engines mounted by
``mount_serve_engine`` on one fabric directory serve the six requests of
the serving phase: the second's first request restores the first's
snapshots, tokens equal the memory-store engine's, and the chunk and fused
kernel counts hold as in the serving phase.  Then the port's own store
server: ``python -m repro_torch.net.serve`` in a child process, two engines
mounted on it through ``RemoteBackend`` with a cache tier serve the six
requests in turn (one election stores the shared prefix; engine 2 restores
it over the wire with its tier cold, then from the tier with no server read;
tokens equal the memory-store engine's), and the server stops on SIGTERM.
Then the front door, ``repro_torch.api.Client``: the thesis's Ch. 4 and
Ch. 5 evaluation on the host (each policy's row, exact); a local client
with PT runs the workflow pipeline above as a ``WorkflowSpec`` three times
(the third skips the stored train prefix), replays the Ch. 4 corpus, and
``recommend`` and ``find`` name the prefix stored on the card; then three
``python -m repro_torch.net.serve`` children form a cluster, two clients
mounted with ``store_url`` (replication 2, a cache tier each) serve the six
requests through ``Client.serve_engine`` under one election, tokens equal
the memory-store engine's; the primary of the shared prefix's snapshot is
killed and one more request restores from its replica (a failover read,
tokens unchanged), ``find`` lists the snapshot's catalog record, and the
survivors stop on SIGTERM with exit code 0.
Then the multi-tenant HTTP gateway, ``repro_torch.gateway``, over the same
pipeline (a first module, ``blob``, draws the corpus on the card from the
POST's JSON): one ``python -m repro_torch.net.serve --trace-dir D`` child,
the gateway in this process over a ``Client`` mounted on it (PT, codec
none, tracing into D), and two tenants over HTTP on loopback: alice's
three runs in ``shared`` (the third skips blob to train), a 429 over her
quota while one trains, bob's private run (every module computed) and his
shared run (blob to train skipped: another tenant's prefix), the event
stream, recommend, stats, artifacts and metrics, then a drain (503 to a
new POST, the run in flight ends done); a start/SIGTERM smoke of the
gateway's CLI with ``--device cuda`` (its demo modules compute host lists);
and ``python -m repro_torch.obs.trace`` over the spans
of both processes.  Last, gemma3-4b served at full width and depth (seven
requests through ``ServeEngine(max_len=2048, chunk=64)``, the last of
1,600 prompt tokens, past the local window; its chunks on the chunk
variant, 34 kernels a call and no index write, its decode steps on the
fused one at dh 256), then a chain of 25 64-token ``prefill_chunk`` calls
over its 2,048-row cache held against ``prefill`` of the same tokens.
After it, the reference's LM serve cells (``phase_lm_cells``): TinyLlama's
``prefill_32k`` and ``decode_32k``, gemma3-4b's ``prefill_32k``,
``decode_32k`` and ``long_500k``, deepseek-7b's and qwen2-moe-a2.7b's
``prefill_32k`` and ``decode_32k``, deepseek-v2-236b's ``prefill_32k``,
``decode_32k`` and ``long_500k``, through ``build_serve_step`` at the
published widths, S or T, window and ``cache_len``, each at the cut (batch,
or at B 1 depth) the dry-run's ``fit`` takes under 75 GB, the decode cache
drawn on the card: step ms, tokens a second, the device's idle share, the
step's peak against its reckoning, every launch ``fused`` or ``wgmma`` (no
decode kernel at MLA's absorbed decode; MLA's flash at keys of 192 and
values of 128), MoE's groups and capacity drops, the kernels at each
cell's shape against their plain versions, and each decode step at B 2
and 2 layers (MLA 1) against the CPU port, an MoE oracle routing as the
card.  Then the ``train_4k`` cell (S 4,096) of all five through
``build_train_step`` at the cut and remat the dry-run's ``fit`` takes (remat
full where it keeps more layers than none): the step's gradient at B 1
through the flash kernels against the plain attention in fp32 (MoE's runs
routing as the kernels' run), step ms, tokens a second, losses and
gradient norms, the idle share, the peak against its reckoning, every
flash launch ``wgmma``, and the flash forward and backward at the cell's
shape against fp32 autograd of the plain version.  Those checks draw their
queries or keys so that the scores spread by several units (a near-flat
softmax would hide a dropped key), and each refuses planted wrong outputs
(the train cells': gradients with the keys past 2,048 dropped).
The steps run back to back on expandable allocator segments.

It needs a CUDA card and the ``repro_torch`` package beside it (under
``src/``); without either it fails before printing any result.  Any failed
check exits non-zero.  The last line is a JSON object naming the device.
"""
from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import gc
import json
import math
import os
import re
import signal
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
PEAK_OPS_PER_S = {torch.float32: 67e12, torch.bfloat16: 989e12}  # dense, per input type
# fp32 attention products as three TF32 products on the tensor cores (the
# flash kernels' tf32x3 variant): 495 TFLOP/s of TF32 over three passes
TF32X3_OPS_PER_S = 495e12 / 3


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
GEMMA_SERVE_LEN = 2048  # gemma3-4b's engine max_len: the long request's 1,632 positions fit
# (label, B, S, T, Hq, Hkv, dh, q_start per sequence, window)
KERNEL_CASES = [
    ("decode B1", 1, 1, 1024, 32, 4, 64, [575], None),
    ("decode B4", 4, 1, 1024, 32, 4, 64, [575, 100, 1000, 7], None),
    ("prefill B1", 1, 64, 1024, 32, 4, 64, [512], None),
    ("prefill B4", 4, 64, 1024, 32, 4, 64, [0, 64, 448, 960], None),
    ("gemma3-like local", 2, 64, 1024, 8, 4, 256, [700, 300], 256),
    ("smoke decode", 1, 1, 256, 8, 2, 8, [150], None),
    ("smoke prefill", 2, 16, 256, 8, 2, 8, [0, 200], None),
    # MHA at dh 128 (G 1): the decode step and engine chunk of deepseek-7b
    # (Hq 32) and qwen2-moe-a2.7b (Hq 16)
    ("deepseek-7b decode", 1, 1, 1024, 32, 32, 128, [575], None),
    ("deepseek-7b chunk", 1, 64, 1024, 32, 32, 128, [512], None),
    ("qwen2-moe decode", 1, 1, 1024, 16, 16, 128, [575], None),
    ("qwen2-moe chunk", 1, 64, 1024, 16, 16, 128, [512], None),
    # gemma3-4b's engine at full width (Hq 8, Hkv 4, dh 256) over its cache
    # of GEMMA_SERVE_LEN rows: decode steps (fused) and 64-row chunk calls
    # (the chunk variant at DC 4; the split variant's route, two index
    # writes and its two kernels, is timed beside it); in a local layer
    # (window 1024) the first requests' positions, then the long request's
    # last chunk and first step, where the window cuts keys; in a global
    # layer the long request's, every key visible
    ("gemma3 decode", 1, 1, GEMMA_SERVE_LEN, 8, 4, 256, [575], 1024),
    ("gemma3 chunk", 1, 64, GEMMA_SERVE_LEN, 8, 4, 256, [512], 1024),
    ("gemma3 long decode", 1, 1, GEMMA_SERVE_LEN, 8, 4, 256, [1600], 1024),
    ("gemma3 long chunk", 1, 64, GEMMA_SERVE_LEN, 8, 4, 256, [1536], 1024),
    ("gemma3 global decode", 1, 1, GEMMA_SERVE_LEN, 8, 4, 256, [1600], None),
    ("gemma3 global chunk", 1, 64, GEMMA_SERVE_LEN, 8, 4, 256, [1536], None),
    # the fused plans past one cluster of splits (T 65,536 and 131,072, B 1,
    # at TinyLlama's and gemma3-4b's heads): one visible key (q_start 0, and
    # 1: most splits empty), and B 4 with lengths 10 / T/2 / T-1 / 3
    ("long T65536 q0", 1, 1, 65536, 32, 4, 64, [0], None),
    ("long T65536 q1", 1, 1, 65536, 32, 4, 64, [1], None),
    ("long T65536 B4", 4, 1, 65536, 32, 4, 64, [10, 32768, 65535, 3], None),
    ("long T131072 q0", 1, 1, 131072, 8, 4, 256, [0], None),
    ("long T131072 q1", 1, 1, 131072, 8, 4, 256, [1], None),
    ("long T131072 B4", 4, 1, 131072, 8, 4, 256, [10, 65536, 131071, 3], None),
]
LONG_FUSED = tuple(c[0] for c in KERNEL_CASES if c[0].startswith("long T"))
# the fused variant's short-T queued_ms under its earlier design (one
# cluster of splits from the static T, CUDA-core products, two tiles in the
# ring), measured by this script on an H100 80GB HBM3 at 700 W
SHORT_FUSED_BEFORE = {"decode B1": 0.0152, "decode B4": 0.0215, "gemma3 decode": 0.0388}
MAIN_CASE = "decode B1"  # the shape of every decode step on the main path
# the engine's prefill_chunk call (chunk 64 at q_start 512 over max_len 1024):
# the chunk variant's shape on the main path
CHUNK_CASE = "prefill B1"
# the split variant's path now: fp32 chunks of the smoke models (dh 8)
SPLIT_CASE = "smoke prefill"
FAMILY_DECODE = ("deepseek-7b decode", "qwen2-moe decode")  # the fused variant at dh 128, G 1
FAMILY_CHUNK = ("deepseek-7b chunk", "qwen2-moe chunk")  # the chunk variant at dh 128, G 1
GEMMA_DECODE, GEMMA_CHUNK = "gemma3 decode", "gemma3 chunk"  # fused and chunk at dh 256, G 2
# the long request's decode step and last chunk call, in a local layer
# (the window bites) and in a global one
GEMMA_SERVED = {"fused": ("gemma3 long decode", "gemma3 global decode"),
                "chunk": ("gemma3 long chunk", "gemma3 global chunk")}


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


def print_decode_ptxas() -> None:
    """ptxas's registers and spills for every decode-attention kernel as
    built; a chunk or bf16 fused kernel (``decode_attention_chunk_kernelILi<DC>E``,
    ``decode_attention_fused_mma_kernelILi<DC>E``, DC 1 to 4) that spills
    fails the run, and so does a missing instantiation."""
    from repro_torch.kernels import build

    dcs = {"chunk": set(), "fused_mma": set()}
    for row in build.ptxas_report("decode_attention"):
        name = row["kernel"]
        print(f"ptxas {name}: registers {row['registers']} spill stores "
              f"{row['spill_stores']} B loads {row['spill_loads']} B")
        m = re.search(r"decode_attention_(chunk|fused_mma)_kernelILi(\d)E", name)
        if m:
            dcs[m.group(1)].add(int(m.group(2)))
            check(row["spill_stores"] == row["spill_loads"] == 0,
                  f"ptxas: {name} spills {row['spill_stores']} B")
    check(all(d == {1, 2, 3, 4} for d in dcs.values()), f"ptxas: kernels at DC {dcs}")


def phase_kernels(dev) -> dict:
    from repro_torch.kernels.decode_attention import ops

    print_decode_ptxas()
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
            # the long cases: queries at LM_KEY_SPREAD (a power of two, so
            # exact in bf16), scores spread so the softmax picks a few of the
            # live keys, held against fp32 with planted controls
            long_case = label in LONG_FUSED
            written[(label, tname)] = written_case(
                ops, ops.variant(S, Hq // Hkv, dh, dtype), case,
                q * LM_KEY_SPREAD if long_case else q, k, v, q_start, gen, dtype, lib_ms,
                controls=long_case)
            del q, k, v
    torch.cuda.empty_cache()
    short = {label: written[(label, "bfloat16")]["queued_ms"] for label in SHORT_FUSED_BEFORE}
    print("kernel fused short T against the earlier design: " + "; ".join(
        f"{label} {ms:.6f} ms ({ms / SHORT_FUSED_BEFORE[label]:.3f} times "
        f"{SHORT_FUSED_BEFORE[label]})" for label, ms in short.items()))
    return {"cases": results, "written": written, "short": short,
            "occupancy": fused_occupancy(ops), "graph": fused_graph_check(ops, dev)}


def fused_occupancy(ops) -> dict:
    """The bf16 fused kernel's blocks an SM holds, as the device reckons them
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``), against what
    ``plan_fused`` plans with (``fused_blocks_per_sm``): equal, or the grid
    is not the one wave the plan means."""
    from repro_torch.kernels import build

    ops._kernel("fused")  # the init sets the kernels' shared-memory limits
    fn = build.load("decode_attention").decode_attention_fused_blocks_per_sm
    fn.restype, fn.argtypes = ctypes.c_int, [ctypes.c_int]
    got = {dh: (fn(dh), ops.fused_blocks_per_sm(dh, torch.bfloat16)) for dh in (64, 128, 192, 256)}
    print("kernel fused blocks an SM holds (device, plan) by dh: "
          + ", ".join(f"{dh}: {d}, {p}" for dh, (d, p) in got.items()))
    check(all(d == p for d, p in got.values()), f"fused occupancy differs from the plan: {got}")
    return {dh: d for dh, (d, _) in got.items()}


def fused_graph_check(ops, dev) -> dict:
    """One fused call (B 1, T 131,072, gemma3-4b's heads, bf16: 64 splits
    in 8 clusters) captured once in a CUDA graph and replayed while q_start
    moves so the live keys cross tile and split boundaries (one key, as
    many tiles as splits and one either side, sixteen tiles a split, half
    and all of T): each replay's output and caches equal bit for bit to an
    eager call's on the same inputs, and the fused kernel counted once a
    replay.  The graph's kernels are read at capture (``captured_by_variant``,
    as ``ServeEngine`` reads them), the eager calls' from their launches."""
    B, T, Hq, Hkv, dh = 1, 131072, 8, 4, 256
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    tk, n_splits, cluster = ops.plan_fused(B, Hkv, T, dh, torch.bfloat16, n_sm)
    gen = torch.Generator(device=dev).manual_seed(21)
    q, k_new, v_new = (torch.randn(B, 1, h, dh, generator=gen, device=dev).to(torch.bfloat16)
                       for h in (Hq, Hkv, Hkv))
    k, v = (torch.randn(B, T, Hkv, dh, generator=gen, device=dev).to(torch.bfloat16)
            for _ in range(2))
    q_start = torch.zeros(B, dtype=torch.int32, device=dev)
    ops.decode_attention_chunk(q, k_new, v_new, k, v, q_start)  # warm-up, outside the capture
    torch.cuda.synchronize()
    captured = dict(ops.decode_attention.captured_by_variant)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = ops.decode_attention_chunk(q, k_new, v_new, k, v, q_start)
    in_graph = {v_: n - captured[v_] for v_, n in ops.decode_attention.captured_by_variant.items()}
    lengths = [0, 1, tk - 1, tk, (n_splits - 1) * tk, n_splits * tk - 1, n_splits * tk,
               (n_splits + 1) * tk + 5, 16 * n_splits * tk + 3, T // 2, T - 1]
    equal, eager_n = [], {v_: 0 for v_ in ops.decode_attention.launches_by_variant}
    for qs in lengths:
        q_start.fill_(qs)
        graph.replay()
        replayed = out.clone()
        k_rep, v_rep = k.clone(), v.clone()
        before = dict(ops.decode_attention.launches_by_variant)
        eager = ops.decode_attention_chunk(q, k_new, v_new, k, v, q_start)
        torch.cuda.synchronize()
        for v_, n in ops.decode_attention.launches_by_variant.items():
            eager_n[v_] += n - before[v_]
        equal.append(torch.equal(replayed, eager) and torch.equal(k_rep, k)
                     and torch.equal(v_rep, v) and bool(torch.isfinite(eager).all()))
    print(f"kernel fused graph: B {B} T {T} Hq {Hq} Hkv {Hkv} dh {dh} bf16, plan "
          f"{(tk, n_splits, cluster)}; one capture replayed at q_start {lengths}: equal to "
          f"the eager call {equal}; kernels in the graph {in_graph}, in the eager calls "
          f"{eager_n}")
    check(all(equal), f"fused graph replays differ from eager calls: {dict(zip(lengths, equal))}")
    check(in_graph == {"split": 0, "fused": ops.KERNELS_PER_CALL["fused"], "chunk": 0},
          f"fused graph: kernels captured {in_graph}")
    check(eager_n == {"split": 0, "fused": len(lengths) * ops.KERNELS_PER_CALL["fused"],
                      "chunk": 0}, f"fused graph: eager kernels {eager_n}")
    del graph, q, k_new, v_new, k, v, out
    torch.cuda.empty_cache()
    return {"lengths": lengths, "equal": equal, "plan": [tk, n_splits, cluster]}


def written_case(ops, var, case, q, k, v, q_start, gen, dtype, lib_ms, new=None,
                 controls: bool = False) -> dict:
    """The variant ``var`` that writes the new K/V rows and attends in one
    launch (fused: S = 1, splits combined in a cluster; chunk: S > 1,
    ``wgmma``; split: two index writes, then its two kernels) against its
    plain version on the same inputs: output within the tolerance, written
    caches and reruns equal bit for bit; then its times beside the split
    variant's.  ``new``: the (K, V) rows written, unit normal where not
    given.  ``controls``: the output is held against the plain version on
    fp32 copies of the written caches, within TOL times that output's
    largest magnitude, and two planted wrong outputs must fail the same
    check (``planted_controls``)."""
    label, B, S, T, Hq, Hkv, dh, qs_list, window = case
    tname = str(dtype).replace("torch.", "")
    check(ops.variant(S, Hq // Hkv, dh, dtype) == var, f"{label}: not the {var} variant")
    k_new, v_new = new or tuple(torch.randn(B, S, Hkv, dh, generator=gen,
                                            device=q.device).to(dtype) for _ in range(2))
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
        check(all(after[v_] - before[v_] == (ops.KERNELS_PER_CALL[var] if v_ == var else 0)
                  for v_ in after),
              f"{var} {label} {tname}: launches {before} -> {after}")
        check(torch.equal(k_got, k_want) and torch.equal(v_got, v_want),
              f"{var} {label} {tname}: the written caches differ from the plain version's")
    tol = TOL[dtype]
    if controls:
        ref = ops.decode_attention_plain(q.float(), k_want.float(), v_want.float(), q_start,
                                         window=window)
        largest = ref.abs().max().item()
        bound = tol * largest
    else:
        ref, bound = want, tol
    err = (runs[0].float() - ref.float()).abs().max().item()
    print(f"kernel check {label:18s} {tname:8s} {var} max_abs_err {err:.3e} tol {tol:.0e}"
          + (f" of the largest |out| {largest:.4e}: bound {bound:.4e} (err {err / bound:.4f} "
             f"of it)" if controls else "")
          + f" caches bit-equal reruns bit-equal {torch.equal(runs[0], runs[1])}")
    check(math.isfinite(err) and err <= bound,
          f"{var} decode_attention {label} {tname}: max_abs_err {err} > {bound}")
    check(torch.equal(runs[0], runs[1]), f"{var} {label} {tname}: reruns differ")
    planted = (planted_controls(ops, case, q, k_want, v_want, q_start, ref, bound)
               if controls else None)
    del ref

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
    res = dict(ms=ms, device_ms=dev_ms, span_ms=span_ms, queued_ms=q_ms, plain_ms=plain_ms,
               library_ms=lib_ms, bound_ms=bms, bound_by=by, max_abs_err=err)
    if var == "fused":  # cold: each call after a read that evicts the L2
        res["flushed_ms"] = flushed_ms(call)
        print(f"kernel cold  {label:18s} {tname:8s} {var} l2_flushed_ms {res['flushed_ms']:.6f}")
    if controls:
        res.update(largest=largest, held_to=bound, controls=planted)
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
        # the split variant's route at the same shape, as the wrapper took it
        # before the chunk kernel did: two index writes, then its two kernels
        k_s, v_s = k.clone(), v.clone()

        def split_route():
            ops.insert_chunk(k_s, k_new, q_start)
            ops.insert_chunk(v_s, v_new, q_start)
            return ops.decode_attention(q, k_s, v_s, q_start, window=window)

        e = (split_route().float() - want.float()).abs().max().item()
        check(math.isfinite(e) and e <= tol, f"split route at {label}: err {e}")
        split_ms = queued_ms(split_route)
        cold_ms = flushed_ms(call)
        print(f"kernel chunk vs split {label:18s} {tname:8s} chunk queued_ms {q_ms:.6f} "
              f"l2_flushed_ms {cold_ms:.6f} split queued_ms {split_ms:.6f} (two index writes, "
              f"split and combine: {split_ms / q_ms:.2f} times) library_ms {lib_ms:.6f} "
              f"bound_ms {bms:.6f} ({by}) chunk queued_ms by blocks a cluster "
              + " ".join(f"{n}: {t:.6f}" for n, t in sweep.items()) + f" (planned {planned})")
        res.update(flushed_ms=cold_ms, split_queued_ms=split_ms, sweep=sweep, planned=planned)
    return res


def first_split_keys(ops, B, Hkv, T, dh, dtype, qs_list, window, dev) -> tuple[list, int]:
    """The keys (lo, hi) of the fused plan's first split of each sequence's
    live range (``fused_partition``, as the kernel cuts them on the card),
    and the plan's splits; with one split a head (nothing past it to drop),
    its first tile.  A planted control zeroes the keys past them."""
    tk, n, _ = ops.plan_fused(B, Hkv, T, dh, dtype,
                              torch.cuda.get_device_properties(dev).multi_processor_count, window)
    firsts = [ops.fused_partition(qs, T, window, n, tk)[0] for qs in qs_list]
    if n == 1:
        firsts = [(lo, min(hi, lo + tk - 1)) for lo, hi in firsts]
    return firsts, n


def planted_controls(ops, case, q, k, v, q_start, ref, bound) -> dict:
    """Two wrong outputs that ``written_case``'s check must refuse, so that
    it is shown to see a fault at this shape: zeros, and the plain version
    (fp32) over copies of the written caches ``k``, ``v`` whose keys past
    the fused plan's first split of each sequence's live range are zeroed
    (``first_split_keys``), as a kernel that dropped every split but the
    first would read them, in the sequences that have keys both in that
    split and past it.  Where no sequence has keys both in that split
    and past it (fewer live tiles than splits leave the first split empty,
    and dropping the rest is the zeros control again), the second is the
    plain version with one key past each sequence's live range seen, as a
    kernel whose mask let one more key through would read it.  Each one's
    max abs error against ``ref`` must lie above ``bound``."""
    label, B, S, T, Hq, Hkv, dh, qs_list, window = case
    kept, n = first_split_keys(ops, B, Hkv, T, dh, k.dtype, qs_list, window, k.device)
    # the sequences with keys both in the first split and past it: only
    # theirs are zeroed, so the control's error lies in them alone
    cut = [lo <= hi < min(T - 1, qs + S - 1) for (lo, hi), qs in zip(kept, qs_list)]
    if any(cut):
        k0, v0 = k.float(), v.float()
        for b, (_, hi) in enumerate(kept):
            if cut[b]:
                k0[b, hi + 1:], v0[b, hi + 1:] = 0, 0
        second = "later splits dropped"
        wrong = ops.decode_attention_plain(q.float(), k0, v0, q_start, window=window)
        what = (f"rows past the first of {n} splits zeroed in sequences "
                f"{[b for b in range(B) if cut[b]]} (keys {kept} kept)")
        del k0, v0
    else:
        check(all(qs + S < T for qs in qs_list), f"{label}: no key past the live range to plant")
        second = "one key more"
        wrong = ops.decode_attention_plain(q.float(), k.float(), v.float(), q_start + 1,
                                           window=window)
        what = (f"no keys both in and past the first of {n} splits ({kept}); one key past "
                f"each live range seen")
    planted = {"zeros": torch.zeros_like(ref), second: wrong}
    errs = {name: (p - ref).abs().max().item() for name, p in planted.items()}
    print(f"kernel check {label:18s} planted controls (each must exceed the bound {bound:.4e}): "
          f"zeros max_abs_err {errs['zeros']:.4e} ({errs['zeros'] / bound:.2f} times the "
          f"bound); {what}: {errs[second]:.4e} ({errs[second] / bound:.2f} times)")
    check(all(e > bound for e in errs.values()),
          f"{label}: a planted control passes the check: {errs}, bound {bound}")
    return errs


# --------------------------------------------------------------------------
# phase: full-width serving
# --------------------------------------------------------------------------
STORE_CACHE_BYTES = 1 << 30  # each engine's cache tier in front of the store server
STORE_RESTORES = 5  # cold and warm restores of the shared prefix, in turns


def tier_restore_ms(engine, rb) -> dict:
    """The shared prefix's snapshot loaded through ``engine``'s cache tier
    STORE_RESTORES times cold (its entry invalidated first: the blobs cross
    the wire) and warm (read again from the tier), in turns: ms of each
    load, and the server reads each kind made."""
    snaps = engine.snapshots
    cache = snaps.backend
    key = next(iter(snaps._records))
    reads = lambda: rb.server_stats()["ops"].get("read_blob", 0)
    ms: dict[str, list] = {"cold": [], "warm": []}
    n_reads = {"cold": 0, "warm": 0}
    for _ in range(STORE_RESTORES):
        for kind in ("cold", "warm"):
            if kind == "cold":
                cache.invalidate(key)
            r0 = reads()
            t0 = time.perf_counter()
            snap = snaps.load(key)
            ms[kind].append((time.perf_counter() - t0) * 1e3)
            n_reads[kind] += reads() - r0
            check(snap is not None, f"store server: the snapshot {key} did not load")
    nbytes = snaps.record(key).nbytes_disk
    print(f"store server: restore of the shared prefix's snapshot ({nbytes} B) through the "
          f"cache tier, {STORE_RESTORES} in turns: cold ms "
          f"{[round(x, 3) for x in ms['cold']]} ({n_reads['cold']} server reads), warm ms "
          f"{[round(x, 3) for x in ms['warm']]} ({n_reads['warm']} server reads)")
    check(n_reads["warm"] == 0 and n_reads["cold"] >= STORE_RESTORES,
          f"store server: restores read {n_reads} from the server")
    return {"bytes": nbytes, "cold_ms": ms["cold"], "warm_ms": ms["warm"]}


def start_store_server(root: str, trace_dir: str | None = None):
    """``python -m repro_torch.net.serve --root root --port 0`` in a child
    process (with ``--trace-dir trace_dir`` where given): (the process, the
    url it printed).  A thread reads the rest of its output until it exits."""
    env = dict(os.environ, PYTHONPATH=os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                                   "src"))
    trace = ["--trace-dir", trace_dir] if trace_dir else []
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.net.serve", "--root", root, "--port", "0",
         "--host", "127.0.0.1", *trace],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
    deadline = time.monotonic() + 120
    while time.monotonic() < deadline:
        line = proc.stdout.readline()
        if not line:
            break
        if "store server listening on" in line:
            # drain what the server logs later, so that it never blocks on a full pipe
            threading.Thread(target=proc.stdout.read, daemon=True).start()
            return proc, line.split("listening on ")[1].split()[0]
    proc.kill()
    proc.wait()
    raise CheckFailed("store server: the CLI printed no url")


def phase_store_server(dev, engine_rows) -> dict:
    """The port's own store server on the card's host: ``repro_torch.net.serve``
    started in a child process over a temporary root, and two full-width
    TinyLlama-1.1B engines mounted on it (``mount_serve_engine`` over a
    ``RemoteBackend``, the lease table and eviction events from the server,
    snapshots read through a cache tier of STORE_CACHE_BYTES) serving the six
    requests of ``phase_engine`` in turn, engine 1 then engine 2.  RISP
    admits the shared prefix at its second sight, so engine 1's second
    request is the one election of the run: it leads it, prefills the
    prefix and stores its snapshot, the only one either engine stores.
    Every later request restores it: engine 1's from its own tier (written
    through), engine 2's first over the wire (its tier cold) and its second
    from the tier with no read reaching the server (warm).  Tokens equal the
    memory-store engine's; the server stops on SIGTERM with exit code 0."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import ops
    from repro_torch.models import transformer
    from repro_torch.models.layers import init_params
    from repro_torch.net import RemoteBackend
    from repro_torch.serve import mount_serve_engine

    cfg = get_config("tinyllama-1.1b")  # full width, bf16
    params = init_params(torch.Generator(device=dev).manual_seed(0), transformer.lm_specs(cfg),
                         cfg.dtype, dev)  # phase_engine's weights
    prompts = engine_prompts(cfg.vocab)
    shared = ENGINE_SYSTEM // 64
    out: dict = {}
    by_var = ops.decode_attention.launches_by_variant
    with tempfile.TemporaryDirectory() as root:
        proc, url = start_store_server(root)
        rbs = []
        try:
            engines = []
            for e in (1, 2):
                rbs.append(RemoteBackend(url))
                engines.append(mount_serve_engine(rbs[-1], cfg, params, remote=rbs[-1],
                                                  cache_bytes=STORE_CACHE_BYTES, max_len=1024,
                                                  chunk=64, device=dev))
            print(f"store server: {url} (python -m repro_torch.net.serve, pid {proc.pid}); two "
                  f"engines, cache tier {STORE_CACHE_BYTES} B each")
            reads = lambda: rbs[0].server_stats()["ops"].get("read_blob", 0)
            rows: dict[int, list] = {}
            tier: dict[str, dict] = {}
            before_all = dict(by_var)
            for e, engine in zip((1, 2), engines):
                cache = engine.snapshots.backend
                # seconds spent loading snapshots (GenStats.prefill_s starts after the restore)
                load_s = lambda: engine.snapshots._m_load_s.unlabeled.sum
                rows[e] = []
                for i, prompt in enumerate(prompts):
                    before = (cache.hits, cache.misses, reads(), load_s())
                    rows[e] += serve_requests(engine, cfg, [prompt], ENGINE_NEW,
                                              f"store engine {e} request {i + 1}, call")
                    after = (cache.hits, cache.misses, reads(), load_s())
                    r = rows[e][-1]
                    r.update(hits=after[0] - before[0], misses=after[1] - before[1],
                             server_reads=after[2] - before[2],
                             restore_ms=(after[3] - before[3]) * 1e3)
                    if e == 2 and i < 2:
                        tier["cold" if i == 0 else "warm"] = {k: r[k] for k in (
                            "skipped", "hits", "misses", "server_reads", "restore_ms")}
                        tier["cold" if i == 0 else "warm"]["prefill_ms"] = r["prefill_s"] * 1e3
                for i, (got, want) in enumerate(zip(rows[e], engine_rows)):
                    check(got["out"] == want["out"],
                          f"store engine {e} request {i + 1}: tokens differ from the "
                          f"memory-store engine's")
                fl = engine.flight
                print(f"store engine {e}: skipped {[r['skipped'] for r in rows[e]]} stored "
                      f"{[r['stored'] for r in rows[e]]}; elections led {fl.remote_leads} "
                      f"waited {fl.remote_waits}; cache tier hits {cache.hits} misses "
                      f"{cache.misses} bytes {cache.cached_bytes}; server reads a request "
                      f"{[r['server_reads'] for r in rows[e]]}")
                out[f"engine {e}"] = {"leads": fl.remote_leads, "waits": fl.remote_waits,
                                      "skipped": [r["skipped"] for r in rows[e]]}
            out.update({v: by_var[v] - before_all[v] for v in ("fused", "chunk", "split")})
            cold, warm = tier["cold"], tier["warm"]
            print(f"store server: the shared prefix ({shared} chunks) stored once, by engine "
                  f"1's second request under the one election; engine 2's hits, restore_ms + "
                  f"prefill_ms (the tail chunk): cache tier cold {cold['restore_ms']:.3f} + "
                  f"{cold['prefill_ms']:.3f} (tier misses {cold['misses']}, server reads "
                  f"{cold['server_reads']}), warm {warm['restore_ms']:.3f} + "
                  f"{warm['prefill_ms']:.3f} (tier hits {warm['hits']}, misses "
                  f"{warm['misses']}, server reads {warm['server_reads']}); decode kernels "
                  f"{ {k: out[k] for k in ('chunk', 'fused', 'split')} }; server ops "
                  f"{rbs[0].server_stats()['ops']}")
            stored = [r["stored"] for e in (1, 2) for r in rows[e]]
            check(out["engine 1"]["leads"] == 1 and out["engine 2"]["leads"] == 0
                  and sum(stored) == 1 and rows[1][1]["stored"] == 1,
                  f"store server: elections led {out['engine 1']['leads']} and "
                  f"{out['engine 2']['leads']}, snapshots stored {stored}: wanted one, by "
                  f"engine 1's second request")
            check([r["skipped"] for r in rows[1][2:] + rows[2]] == [shared] * 10,
                  "store server: a request after the election prefilled the shared prefix")
            check(cold["misses"] > 0 and cold["server_reads"] > 0,
                  f"store server: engine 2's first restore did not cross the wire: {cold}")
            check(warm["misses"] == 0 and warm["hits"] > 0 and warm["server_reads"] == 0,
                  f"store server: a warm hit went to the server: {warm}")
            check(out["split"] == 0, f"store server: {out['split']} split kernels")
            out["restore"] = tier_restore_ms(engines[1], rbs[1])
            out["tier"] = tier
            del engines
        finally:
            for rb in rbs:
                rb.close()
            proc.send_signal(signal.SIGTERM)
            try:
                rc = proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
                rc = None
        print(f"store server: stopped on SIGTERM, exit code {rc}")
        check(rc == 0, f"store server: exit code {rc} after SIGTERM")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_engine(dev) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.models import transformer
    from repro_torch.models.layers import init_params

    cfg = get_config("tinyllama-1.1b")  # full width, bf16
    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_params(gen, transformer.lm_specs(cfg), cfg.dtype, dev)
    return serve_engine(dev, cfg, params, engine_prompts(cfg.vocab), ENGINE_NEW, "engine", "req",
                        profile=True)


def param_bytes(params: dict) -> tuple[int, int]:
    """(parameters, bytes) of a tree."""
    n_par = n_bytes = 0
    for t in leaves(params):
        n_par += t.numel()
        n_bytes += t.numel() * t.element_size()
    return n_par, n_bytes


@contextlib.contextmanager
def counted_inserts(ops):
    """Counts, in the one-element list it yields, the index writes of chunk
    rows (``ops.insert_chunk``, which the split variant's route takes before
    its kernels) made while it is open."""
    n = [0]
    inner = ops.insert_chunk

    def counted(*args, **kwargs):
        n[0] += 1
        return inner(*args, **kwargs)

    ops.insert_chunk = counted
    try:
        yield n
    finally:
        ops.insert_chunk = inner


def serve_engine(dev, cfg, params, prompts, max_new: int, tag: str, label: str,
                 profile: bool = False, max_len: int = 1024,
                 profile_chunk_at: int | None = None) -> dict:
    """``prompts`` through one ``ServeEngine`` (chunk 64) on ``params``:
    the kernels by variant (``serve_requests``), the index writes of chunk
    rows through the decode wrapper (none where the chunk kernel takes the
    chunk shape and writes its rows, two a layer a chunk call, K and V,
    where the split variant takes it; an MLA model's latent rows are
    written by the model), a decode graph that
    holds one fused kernel a layer (none for MLA), chunks skipped by every
    request from the third on, and finite logits in every prefill chunk and
    graph replay.  Then decode ms per token by graph, and eager
    ``decode_step`` against replays from one state (times and tokens); with
    ``profile``, one more request under the profiler; with
    ``profile_chunk_at``, one chunk call at that position (``profile_chunk``).
    ``chunk_starts`` holds each chunk call's cache position, in order.  For
    an MoE model it counts the routed (token, k) pairs of the prefill chunks
    that capacity dropped (a decode step drops none: one token a group,
    C >= 4 >= K, and a token's K experts differ)."""
    from repro_torch.kernels.decode_attention import ops
    from repro_torch.models import moe
    from repro_torch.serve import ServeEngine

    engine = ServeEngine(cfg, params, max_len=max_len, chunk=64, device=dev)
    n_par, n_bytes = param_bytes(params)
    print(f"{tag}: {cfg.name} params {n_par} bytes {n_bytes} decode bound "
          f"(weights read once per token) {n_bytes / HBM_BYTES_PER_S * 1e3:.6f} ms")

    # every logits tensor the engine computes (prefill chunks and graph
    # replays) is checked for finiteness on the device; the flags are read
    # once at the end
    finite: list[torch.Tensor] = []
    starts: list[torch.Tensor] = []  # each chunk call's cache_len, read once at the end
    drops: list[torch.Tensor] = []  # [dropped, routed] of each MoE call in a prefill chunk
    in_prefill = [False]
    inner_prefill, inner_replay, inner_route = engine._prefill, engine._replay, moe.route

    def watched_prefill(tok, cache, cache_len):
        starts.append(cache_len.clone())
        in_prefill[0] = True
        try:
            out = inner_prefill(tok, cache, cache_len)
        finally:
            in_prefill[0] = False
        finite.append(torch.isfinite(out[0]).all())
        return out

    def watched_replay(graph, token):
        logits = inner_replay(graph, token)
        finite.append(torch.isfinite(logits).all())
        return logits

    def counted_route(x, router, dims):
        out = inner_route(x, router, dims)
        if in_prefill[0]:
            slot = out[2]
            drops.append(torch.stack([(slot < 0).sum(), torch.full_like(slot[0, 0, 0],
                                                                         slot.numel())]))
        return out

    engine._prefill, engine._replay = watched_prefill, watched_replay
    moe.route = counted_route
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launches()
    by_var = ops.decode_attention.launches_by_variant
    # the index writes a chunk takes before the split kernel: none where the
    # chunk kernel takes the chunk shape, since it writes its rows itself
    try:
        with counted_inserts(ops) as index_writes:
            rows = serve_requests(engine, cfg, prompts, max_new, label)
    finally:
        moe.route = inner_route
    launches = dict(by_var)
    graph = engine._graph
    want_graph = {} if cfg.mla is not None else {"fused": cfg.n_layers}
    attn_layers = 0 if cfg.mla is not None else cfg.n_layers
    chunk_var = engine_variants(engine, cfg)[0] if attn_layers else "chunk"
    want_writes = (2 * attn_layers * sum(r["chunk_calls"] for r in rows)
                   if chunk_var == "split" else 0)
    print(f"{tag}: kernels {launches} index writes {index_writes[0]} (chunk shape on "
          f"{chunk_var}) graph holds {graph.kernels} snapshots {engine.n_snapshots}")
    check(index_writes[0] == want_writes,
          f"{tag}: {index_writes[0]} index writes of chunk rows, wanted {want_writes} "
          f"(chunks on the {chunk_var} variant)")
    check(graph.kernels == want_graph,
          f"{tag}: the decode graph holds {graph.kernels}, wanted {want_graph}")
    for i in range(2, len(prompts)):
        check(rows[i]["skipped"] > 0, f"{tag}: request {i + 1} skipped no chunk")
    check(bool(torch.stack(finite).all()), f"{tag}: non-finite logits on the main path")
    out = {"launches": launches, "rows": rows, "chunk_starts": torch.cat(starts).tolist()}
    if drops:
        dropped, routed = (int(v) for v in torch.stack(drops).sum(0).tolist())
        print(f"{tag}: routed (token, k) pairs in prefill chunks {routed} dropped by capacity "
              f"{dropped} share {dropped / routed:.6f}")
        out["drop"] = (dropped, routed)
    snap = engine.snapshot_bytes()
    cached = engine.n_snapshots * cfg.n_layers * max_len
    print(f"{tag}: snapshots {engine.n_snapshots} bytes {snap} per cached position and layer "
          f"{snap / cached:.1f}")
    out["snapshot"] = (engine.n_snapshots, snap, snap / cached)
    steady = rows[1:]
    graph_ms = sum(r["decode_s"] for r in steady) * 1e3 / sum(r["tokens"] for r in steady)
    eager_ms, replay_ms, eager_toks, replay_toks = decode_yardstick(engine, max_new)
    print(f"{tag}: decode ms per token (requests 2-{len(rows)}, graph) {graph_ms:.6f}; at one "
          f"state, replay {replay_ms:.6f} eager decode_step {eager_ms:.6f} "
          f"(eager / replay {eager_ms / replay_ms:.3f}); tokens equal {eager_toks == replay_toks}")
    out.update(graph_ms=graph_ms, eager_ms=eager_ms, replay_ms=replay_ms,
               tokens_equal=eager_toks == replay_toks)
    if profile:
        out["profile"] = phase_profile(engine, prompts[-1], max_new)
    if profile_chunk_at is not None:
        out["chunk_profile"] = profile_chunk(engine, inner_prefill, profile_chunk_at)
    # the watchers close over the engine: without them it is freed on return,
    # with its graph, the graph's memory pool and the static cache, before the
    # later phases measure their peak memory
    del engine._prefill, engine._replay
    return out


ENGINE_SYSTEM, ENGINE_TAIL, ENGINE_NEW = 512, 64, 32  # the six requests' shared prompt


def engine_prompts(vocab: int) -> list[list[int]]:
    """Six requests sharing a 512-token system prompt, each with its own
    64-token tail."""
    rng = np.random.default_rng(0)
    system = rng.integers(0, vocab, size=ENGINE_SYSTEM).tolist()
    return [system + rng.integers(0, vocab, size=ENGINE_TAIL).tolist() for _ in range(6)]


def engine_variants(engine, cfg) -> tuple[str, str]:
    """The decode-attention variants that take ``engine``'s chunk calls and
    its decode steps: ``ops.variant`` of the chunk shape and of one row."""
    from repro_torch.kernels.decode_attention import ops

    G = cfg.n_heads // cfg.n_kv_heads
    return (ops.variant(engine.chunk, G, cfg.head_dim, cfg.dtype),
            ops.variant(1, G, cfg.head_dim, cfg.dtype))


def serve_requests(engine, cfg, prompts, max_new: int, label: str) -> list[dict]:
    """``engine.generate`` on each prompt in turn, with its times and the
    decode kernels it launched by variant: chunk calls on the variant that
    ``ops.variant`` names for the chunk shape (the chunk kernel, one a
    layer, up to dh 128 in bf16; the split variant's two a layer past it),
    decode steps on the fused kernel (one a layer; the engine's first decode
    adds an eager warm-up step before its capture), and no kernel of any
    other variant.  An MLA model launches none: its cached attention is
    plain torch."""
    from repro_torch.kernels.decode_attention import ops

    attn_layers = 0 if cfg.mla is not None else cfg.n_layers
    chunk_var, step_var = engine_variants(engine, cfg) if attn_layers else ("chunk", "fused")
    by_var = ops.decode_attention.launches_by_variant
    dev = engine._dev
    first = engine._graph is None
    rows = []
    for i, prompt in enumerate(prompts):
        before = dict(by_var)
        out, st = engine.generate(prompt, max_new_tokens=max_new)
        got = {v: by_var[v] - before[v] for v in ops.VARIANTS}
        split, fused, chunk = (got[v] for v in ("split", "fused", "chunk"))
        trimmed = 1 if st.chunks_skipped == st.n_chunks else 0
        chunk_calls = (st.n_chunks - st.chunks_skipped) + trimmed
        # the first decode warms up one eager step, then captures the graph
        steps = st.n_new_tokens + (1 if first and i == 0 else 0)
        mem = torch.cuda.max_memory_allocated(dev)
        chunk_ms = st.prefill_s * 1e3 / chunk_calls
        tps = st.n_new_tokens / st.decode_s
        print(f"{label} {i + 1}: chunks_skipped {st.chunks_skipped}/{st.n_chunks} "
              f"prefill_ms {st.prefill_s * 1e3:.3f} prefill_ms_per_chunk_call {chunk_ms:.3f} "
              f"decode_ms {st.decode_s * 1e3:.3f} "
              f"decode_ms_per_token {st.decode_s * 1e3 / st.n_new_tokens:.6f} "
              f"decode_tok_s {tps:.2f} max_memory_allocated {mem} "
              f"kernels chunk {chunk} split {split} fused {fused}")
        check(len(out) == max_new, f"{label} {i + 1}: {len(out)} tokens, wanted {max_new}")
        want = {v: 0 for v in ops.VARIANTS}
        want[chunk_var] += ops.KERNELS_PER_CALL[chunk_var] * attn_layers * chunk_calls
        want[step_var] += ops.KERNELS_PER_CALL[step_var] * attn_layers * steps
        check(got == want,
              f"{label} {i + 1}: kernels {got}, wanted {want} ({attn_layers} layers, "
              f"{chunk_calls} chunk calls on {chunk_var}, {steps} decode steps on {step_var})")
        rows.append(dict(skipped=st.chunks_skipped, n=st.n_chunks, prefill_s=st.prefill_s,
                         decode_s=st.decode_s, tokens=st.n_new_tokens, out=out,
                         stored=st.stored_prefixes, chunk_calls=chunk_calls))
    return rows


def decode_yardstick(engine, n: int) -> tuple[float, float, list, list]:
    """``n`` greedy steps from one cache state (the graph's state after the
    last request), eager ``transformer.decode_step`` and graph replays, each
    step's argmax read on the host as the engine reads it: (eager ms per
    token, replay ms per token, eager tokens, replay tokens).  Runs after
    the main path's counts were read."""
    from repro_torch.models import transformer

    graph = engine._graph
    state = {k: a.clone() for k, a in graph.cache.items()}
    state_len = graph.cache_len.clone()
    first = int(torch.argmax(graph.logits[0]))

    def eager():
        cache = {k: a.clone() for k, a in state.items()}
        cache_len, nxt, toks = state_len.clone(), first, []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            tok = torch.tensor([[nxt]], dtype=torch.int64, device=cache_len.device)
            logits, cache, cache_len = transformer.decode_step(
                engine.params, engine.cfg, tok, cache, cache_len)
            nxt = int(torch.argmax(logits[0]))
            toks.append(nxt)
        return (time.perf_counter() - t0) * 1e3 / n, toks

    def replay():
        graph.load(state, state_len)
        nxt, toks = first, []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            nxt = int(torch.argmax(graph.step(nxt)[0]))
            toks.append(nxt)
        return (time.perf_counter() - t0) * 1e3 / n, toks

    with torch.inference_mode():  # the graph's static buffers are inference tensors
        eager()  # warm-up
        runs = [eager(), replay(), replay(), eager()]  # in turns
    return ((runs[0][0] + runs[3][0]) / 2, (runs[1][0] + runs[2][0]) / 2, runs[0][1],
            runs[1][1])


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

    # the prefix matches the fused kernel's bf16 and fp32 instances
    prof = profile_call("request", request, n_kernels=8,
                        watch=("decode_attention_chunk_kernel", "decode_attention_fused"))
    st = stats["st"]
    print(f"profile request: chunks_skipped {st.chunks_skipped}/{st.n_chunks} "
          f"new_tokens {st.n_new_tokens}")
    if prof:  # the request's decode steps went through the fused kernel
        fused = prof["watch"]["decode_attention_fused"]["kernels"]
        check(fused > 0, f"profile request: no fused decode kernel among the device's "
                         f"kernels ({st.n_new_tokens} new tokens)")
    return prof


def profile_chunk(engine, prefill, at: int) -> dict:
    """One eager chunk call under torch.profiler, after an uncounted one:
    ``engine.chunk`` tokens written at cache position ``at`` into a copy of
    the decode graph's cache, through ``prefill`` (the engine's own): its
    wall time beside the device's busy time and idle share, and the kernels
    that take the device.  Runs after the main path's counts were read."""
    cache = {k: a.clone() for k, a in engine._graph.cache.items()}
    tok = engine._tokens(np.zeros((1, engine.chunk), np.int32))
    at_len = torch.tensor([at], dtype=torch.int32, device=engine._dev)
    return profile_call(f"chunk call at {at}", lambda: prefill(tok, cache, at_len.clone()),
                        n_kernels=8, watch=("decode_attention",), warm=True)


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


def kernels_of_one_call(fn, iters: int = 5) -> dict[str, float]:
    """Each kernel's device ms a call of ``fn`` (named as ``kernel_device_ms``
    names them), from the profiler's records of ``iters`` calls.  The tracer
    can miss the first kernels after it starts, so ``iters`` uncounted calls
    go first, then a device sleep, and only the kernels after it count."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda._sleep(DEVICE_SLEEP_CYCLES)
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    evs = device_events(prof)
    spins = [e.time_range.end for e in evs if "spin_kernel" in e.name]
    split: dict[str, float] = {}
    for e in evs:
        if spins and e.time_range.start >= max(spins):
            m = re.search(r"(\w+)[<(]", e.name.replace("(anonymous namespace)::", ""))
            name = m.group(1) if m else e.name
            split[name] = split.get(name, 0.0) + e.time_range.elapsed_us() / iters / 1e3
    return split


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
# groups that do not divide 64 (the wgmma_rows kernels): gemma3's local layer
# at G 3, G 72 (a 64-row tile is part of one position's heads) and G 5 at dh
# 256 with a window, and the smoke and ragged shapes
FLASH_CASES = [
    ("train", 4, 2048, 32, 4, 64, True, None),
    ("gemma3-like", 1, 2048, 8, 4, 256, True, 1024),
    ("gemma3 global", 1, 2048, 8, 4, 256, True, None),
    ("dh192 G2", 1, 2048, 8, 4, 192, True, None),
    ("dh192 G8", 1, 2048, 32, 4, 192, True, None),
    ("dh136 G2", 1, 2048, 8, 4, 136, True, None),
    ("dh136 G8", 1, 2048, 32, 4, 136, True, None),
    ("dh256 G3", 1, 2048, 6, 2, 256, True, 1024),
    ("G72 S70", 1, 70, 72, 1, 64, True, None),
    ("G5 dh256", 2, 150, 10, 2, 256, True, 64),
    ("smoke", 2, 64, 8, 2, 8, True, None),
    ("non-causal S200", 2, 200, 8, 2, 64, False, None),
]
FLASH_MAIN = "train"  # the shape of every attention call of the train step
GEMMA_LOCAL, GEMMA_GLOBAL = "gemma3-like", "gemma3 global"  # gemma3-4b's attention calls
FLASH_ROWS = "dh256 G3"  # the timed bf16 case on the wgmma_rows kernels
FLASH_ROWS_CASES = (FLASH_ROWS, "G72 S70", "G5 dh256")  # every bf16 case on them
FLASH_BITS = "gemma3 global"  # its fp32 backward runs twice and must give equal bits


def flash_pairs(S: int, causal: bool, window: int | None) -> int:
    """(query, key) pairs that are unmasked, per (b, query head)."""
    n = 0
    for s in range(S):
        hi = s if causal else S - 1
        lo = max(0, s - window + 1) if window else 0
        n += hi - lo + 1
    return n


def flash_bound_ms(case, dtype, backward: bool, dv: int | None = None) -> tuple[float, str]:
    """Least time, with values ``dv`` wide (``dh`` where None; MLA's are
    narrower than its keys).  Bytes: forward reads q, k, v once and writes
    out and the fp32 logsumexp; backward reads q, k, v, out, dout and the
    logsumexp and writes dq, dk, dv (q, k and their gradients dh wide; v,
    out and their gradients dv).  Operations (2 per multiply-add over the
    unmasked pairs): forward Q.K (dh) and P.V (dv); backward dO.V and P.dO
    (dv), dS.K and dS.Q (dh; the recomputation of Q.K is not counted).
    The peak is the rate for the input type, except that fp32 products are
    counted at TF32X3_OPS_PER_S: on this card the least time for an fp32
    product is three TF32 passes on the tensor cores, which the fp32 kernels
    take, not the CUDA cores' 67 TFLOP/s (PEAK_OPS_PER_S, kept for the
    kernels whose fp32 work is not products)."""
    _, B, S, Hq, Hkv, dh, causal, window = case
    dv = dh if dv is None else dv
    isz = torch.finfo(dtype).bits // 8
    once = B * S * (Hq + Hkv) * (dh + dv) * isz  # q, k at dh; out (or v), v at dv
    lse = B * Hq * S * 4
    nbytes = (2 if backward else 1) * once + lse
    ops = (4 if backward else 2) * B * Hq * (dh + dv) * flash_pairs(S, causal, window)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    peak = TF32X3_OPS_PER_S if dtype == torch.float32 else PEAK_OPS_PER_S[dtype]
    t_ops = ops / peak * 1e3
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


def flash_oracle(q, k, v, dout, causal, window, heads: int | None = None):
    """The plain version plus autograd, in fp32 on the same values: for bf16
    inputs the tolerance then measures the kernel's rounding alone.  Where
    ``heads`` is given, over groups of that many query heads with their kv
    heads (each head's attention is its own): the fp32 scores of all of
    MLA's 128 heads at S 4,096 take 8.6 GB a copy."""
    from repro_torch.kernels.flash_attention import attention_lse_ref, attention_ref

    Hq, G = q.shape[2], q.shape[2] // k.shape[2]
    step = heads or Hq
    parts = []
    for h in range(0, Hq, step):
        hq, hk = slice(h, h + step), slice(h // G, (h + step) // G)
        q32, k32, v32 = (t[:, :, sl].detach().float().requires_grad_(True)
                         for t, sl in ((q, hq), (k, hk), (v, hk)))
        out = attention_ref(q32, k32, v32, causal=causal, window=window)
        grads = torch.autograd.grad(out, (q32, k32, v32), dout[:, :, hq].float())
        lse = attention_lse_ref(q32.detach(), k32.detach(), causal=causal, window=window)
        parts.append((out.detach(), lse, *grads))
        del out, grads, q32, k32, v32
    if len(parts) == 1:
        return parts[0]
    return tuple(torch.cat([p[i] for p in parts], dim=1 if i == 1 else 2) for i in range(5))


def backward_ms(out, inputs, dout, iters) -> float:
    """Milliseconds per autograd backward through an already built graph."""
    return cuda_ms(lambda: torch.autograd.grad(out, inputs, dout, retain_graph=True),
                   iters=iters, warmup=2)


MLA_INSTANCE = "ILi3ELi2E"  # the (keys 3, values 2) chunk instantiation, mangled
# MLA's (3, 2) kernels: the ping-pong forward and the fused backward's two
# (the delta and key-tile kernels; dq's conversion takes every pair)
MLA_KERNELS = {"fwd": ("flash_fwd_pp_wgmma_kernel",),
               "bwd": ("flash_bwd_delta_wgmma_kernel", "flash_bwd_fused_wgmma_kernel")}


def print_ptxas() -> dict:
    """ptxas's registers, spills and wgmma serialization (its C75xx notes)
    for every flash kernel as built (mangled names: a wgmma kernel's template
    arguments end in ``Lb0E``, a wgmma_rows kernel's in ``Lb1E``, and begin
    with the key and value chunk counts, ``ILi3ELi2E`` for MLA's; the gather
    pass is ``flash_rows_gather_kernel``, the fused backward's are
    ``flash_bwd_delta_wgmma_kernel``, ``flash_bwd_fused_wgmma_kernel`` and
    ``flash_bwd_dq_convert_kernel``); a kernel that spills fails the run, and
    so does one of MLA's six (3, 2) kernels (MLA_KERNELS, wgmma and
    wgmma_rows) whose wgmmas ptxas serialized.  Returns those six rows by
    direction (``fwd``, ``bwd``)."""
    from repro_torch.kernels import build

    mla: dict[str, list] = {"fwd": [], "bwd": []}
    for row in build.ptxas_report("flash_attention"):
        name = row["kernel"]
        print(f"ptxas {name}: registers {row['registers']} spill stores "
              f"{row['spill_stores']} B loads {row['spill_loads']} B"
              + (f" wgmma serialized ({row['serialized']})" if row["serialized"] else ""))
        check(row["spill_stores"] == row["spill_loads"] == 0,
              f"ptxas: {name} spills {row['spill_stores']} B")
        if MLA_INSTANCE in name:
            kind = next((k for k, names in MLA_KERNELS.items() if any(n in name for n in names)),
                        None)
            check(kind is not None, f"ptxas: {name} is no kernel of MLA_KERNELS")
            check(not row["serialized"], f"ptxas serialized {name}'s wgmmas: {row['serialized']}")
            mla[kind].append(row)
    check(len(mla["fwd"]) == 2 and len(mla["bwd"]) == 4,
          f"ptxas: (3, 2) kernels {[r['kernel'] for v in mla.values() for r in v]}, wanted the "
          f"ping-pong forward and the delta and key-tile kernels, wgmma and wgmma_rows")
    return mla


def phase_flash(dev) -> dict:
    from repro_torch.kernels.flash_attention import attention_ref
    from repro_torch.kernels.flash_attention import ops

    mla_ptxas = print_ptxas()
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
            if (label, dtype) == (FLASH_BITS, torch.float32):  # a full-width fp32 backward, twice
                again = ops.flash_attention_bwd(q, k, v, out, lse, dout, causal=causal,
                                                window=window)
                same = all(torch.equal(a, b) for a, b in zip(grads, again))
                print(f"flash bits  {label:16s} {tname:8s} backward run twice: equal bits {same}")
                check(same, f"flash_attention {label} {tname}: two backward runs differ")
                del again
            fwd = lambda: ops.flash_attention_fwd(q, k, v, causal=causal, window=window)
            bwd = lambda: ops.flash_attention_bwd(q, k, v, out, lse, dout, causal=causal,
                                                  window=window)
            row = {"variant": ops.variant(dtype, dh, Hq // Hkv)}
            want_var = ("tf32x3" if dtype == torch.float32 else
                        "wgmma_rows" if label in FLASH_ROWS_CASES else "wgmma")
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
    return {"cases": results, "mla_ptxas": mla_ptxas}


# --------------------------------------------------------------------------
# phase: full-width training
# --------------------------------------------------------------------------
def lm_batch(vocab: int, B: int, S: int, step: int, dev) -> dict:
    """Batch ``step`` as the training driver makes it (numpy seed = step)."""
    r = np.random.default_rng(step)
    toks = r.integers(0, vocab, size=(B, S + 1)).astype(np.int32)
    return {"tokens": torch.from_numpy(toks[:, :-1].copy()).to(dev),
            "targets": torch.from_numpy(toks[:, 1:].copy()).to(dev)}


PROFILE_LEAD_CYCLES = 100_000  # about 50 us at the H100's 1.98 GHz


def profile_call(label: str, fn, n_kernels: int = 10, watch: tuple[str, ...] = (),
                 warm: bool = False) -> dict:
    """``fn`` once under torch.profiler: wall time, the device's busy and
    idle share, the kernels that take the device time, and the time and
    count of the kernels whose names hold a string of ``watch``.  ``warm``
    (for an ``fn`` that may run twice): a first, uncounted call goes before
    the counted one."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        # the tracer can miss the first kernels after it starts (it dropped
        # FM serve_bulk's first three, and in a later run its first): a short
        # sleep kernel goes first and is not counted; with warm, a whole
        # call goes first, and only what follows the last sleep is counted
        torch.cuda._sleep(PROFILE_LEAD_CYCLES)
        torch.cuda.synchronize()
        if warm:
            fn()
            torch.cuda._sleep(PROFILE_LEAD_CYCLES)
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    evs = device_events(prof)
    spins = [e.time_range.end for e in evs if "spin_kernel" in e.name]
    if warm and spins:
        evs = [e for e in evs if e.time_range.start >= max(spins)]
    evs = [e for e in evs if "spin_kernel" not in e.name]
    if not evs:
        print(f"profile {label}: the profiler saw no device events; idle share not measured")
        return {}
    busy_us = sum(e.time_range.elapsed_us() for e in evs)
    by_name: dict[str, float] = {}
    for e in evs:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    print(f"profile {label}: wall_ms {wall_us / 1e3:.3f} device_busy_ms {busy_us / 1e3:.3f} "
          f"device_idle_share {1 - busy_us / wall_us:.4f} device_kernels {len(evs)}")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:n_kernels]
    for name, us in top:
        print(f"profile {label}: {us / 1e3:10.3f} ms {us / busy_us:7.2%} {name[:100]}")
    watched = {}
    for w in watch:
        hits = [e.time_range.elapsed_us() for e in evs if w in e.name]
        print(f"profile {label}: {w}: {sum(hits) / 1e3:.3f} ms {sum(hits) / busy_us:.2%} "
              f"of busy in {len(hits)} kernels")
        watched[w] = {"ms": sum(hits) / 1e3, "busy_share": sum(hits) / busy_us,
                      "kernels": len(hits)}
    return {"wall_ms": wall_us / 1e3, "busy_ms": busy_us / 1e3,
            "idle_share": 1 - busy_us / wall_us, "watch": watched,
            "top": [[name[:100], us / 1e3] for name, us in top]}


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
    pre = torch.cuda.memory_allocated(dev)  # what the process holds before the step's state
    gen = torch.Generator(device=dev).manual_seed(0)
    state = make_train_state(init_params(gen, lm_specs(cfg), cfg.dtype, dev))
    step = build_train_step(cfg, cell, AdamWConfig(warmup_steps=10, total_steps=100),
                            remat="none")
    batches = [lm_batch(cfg.vocab, B, S, i, dev) for i in range(5)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)  # live at the reset: the state, the batches, pre
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
            "base_memory": base, "pre_memory": pre, "batches": len(batches), "profile": prof,
            "variant": var}


def phase_train_parity(dev) -> dict:
    """Five fp32 smoke steps on the card (kernels) and on the CPU (plain
    path) from the same parameters and numpy batches; returns the tf32x3
    flash launches of the card's steps."""
    from repro_torch.configs import ShapeCell, get_config
    from repro_torch.data import make_batch
    from repro_torch.kernels.flash_attention import flash_attention, reset_launches
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
    reset_launches()
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
    by_var = {v: dict(n) for v, n in flash_attention.launches_by_variant.items()}
    print(f"train parity: final params worst err/(1e-4+1e-4*|cpu|) {worst:.4f}; "
          f"flash launches on the card by variant {by_var}")
    check(worst <= 1.0, f"train parity: final parameters differ (worst ratio {worst})")
    check(min(by_var["tf32x3"].values()) > 0
          and sum(n for v, c in by_var.items() if v != "tf32x3" for n in c.values()) == 0,
          f"train parity: the fp32 steps did not run every flash call on tf32x3: {by_var}")
    return by_var["tf32x3"]


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


def chunk_chain(params, cfg, toks, dev, cache_rows: int = 1024,
                n_chunks: int = CHAIN_CHUNKS) -> tuple[dict, dict]:
    """``transformer.prefill`` (flash kernel) of the first 64 * ``n_chunks``
    tokens against a chain of 64-token ``prefill_chunk`` calls (chunk kernel)
    over an engine's cache of ``cache_rows`` rows.  Returns the errors,
    {"logits": (max abs err, largest |ref|), "k"/"v": [(max abs err,
    largest |ref|) per layer]}, and the chain's decode-attention launches by variant; fails
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

    n = 64 * n_chunks
    plg, pc, _ = transformer.prefill(params, cfg, toks[:, :n])
    chain = transformer.init_cache(cfg, 1, cache_rows, dev)
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
    print(f"prefill vs prefill_chunk chain ({cfg.name} bf16, {n_chunks} chunks of 64 over "
          f"{cache_rows} cache rows, "
          f"wo std {params['layers']['attn']['wo'].float().std().item():.4e}): logits "
          f"max_abs_err {errs['logits'][0]:.4e} largest {errs['logits'][1]:.4e}; "
          + " ".join(f"{k} layer 0 {errs[k][0][0]:.4e} of {errs[k][0][1]:.4e}, worst layer "
                     f"{worst[k][0]:.4e} of {worst[k][1]:.4e}" for k in ("k", "v"))
          + f"; decode kernels {launches} flash launches {flash_attention.launches_fwd - f0}")
    check(launches == {"split": 0, "fused": 0, "chunk": n_chunks * cfg.n_layers}
          and flash_attention.launches_fwd == f0,
          f"the prefill_chunk chain did not run one chunk kernel a layer: {launches}")
    check(chain_len.tolist() == [n], f"prefill_chunk chain length {chain_len.tolist()}")
    return errs, launches


def at_true_fan_in(params: dict, cfg) -> dict:
    """``params`` with the attention projections that the reference's init
    draws at 1/sqrt of a head axis (a 4-D projection's fan-in is its
    second-last axis) redrawn at 1/sqrt of their true fan-in: for GQA wq,
    wk, wv at 1/sqrt(d_model) and wo at 1/sqrt(Hq * dh); for MLA w_uq at
    1/sqrt(q_lora_rank) and w_uk, w_uv at 1/sqrt(kv_lora_rank).  At the
    reference's scale, GQA scores have a spread of hundreds and the softmax
    is an argmax.  The other leaves are shared: MLA's w_dq, w_dkv and w_o,
    the router and every expert matrix are 2-D or 3-D products already drawn
    at their true fan-in."""
    attn = params["layers"]["attn"]
    if cfg.mla is not None:
        m = cfg.mla
        fan = {"w_uq": cfg.n_heads, "w_uk": cfg.n_heads, "w_uv": cfg.n_heads}
        true_fan = {"w_uq": m.q_lora_rank, "w_uk": m.kv_lora_rank, "w_uv": m.kv_lora_rank}
    else:
        fan = {"wq": cfg.n_heads, "wk": cfg.n_kv_heads, "wv": cfg.n_kv_heads,
               "wo": cfg.head_dim}
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
    reset_launches()
    lg, c, cl = transformer.prefill(sp, scfg, stoks)
    smoke_flash = dict(flash_attention.launches_by_variant["tf32x3"])
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
          f"{flash_attention.launches_by_variant} decode kernels {smoke_launches}")
    check(max(errs) <= 1e-4 and torch.equal(cl, chain_len),
          f"prefill differs from the prefill_chunk chain: {errs}")
    check(0 < smoke_flash["fwd"] == flash_attention.launches_fwd and smoke_launches["split"] > 0,
          "prefill check: a kernel was not launched, or a flash call was not tf32x3")
    return {"launches": launches, "ms": ms, "profile": prof, "chain_errs": serrs,
            "chain_launches": chain_launches, "smoke_chain_launches": smoke_launches,
            "smoke_flash": smoke_flash}


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


GEMMA_LONG = 1600  # the long request's prompt: the shared 512 tokens and 1,088 more
GEMMA_CHAIN_CHUNKS = 25  # the long prompt's 1,600 tokens, past the local window of 1024
GEMMA_PARAMS = 4_550_996_480


def gemma3_prompts(vocab: int) -> list[list[int]]:
    """The six requests of ``engine_prompts``, then a long one: their shared
    512 tokens followed by 1,088 more, which takes the local layers past
    their window of 1024 in its chunk calls and decode steps."""
    prompts = engine_prompts(vocab)
    rng = np.random.default_rng(1)
    tail = rng.integers(0, vocab, size=GEMMA_LONG - ENGINE_SYSTEM).tolist()
    return prompts + [prompts[0][:ENGINE_SYSTEM] + tail]


def phase_gemma3_serve(dev) -> dict:
    """gemma3-4b served at full width and depth in bf16 (34 layers, Hq 8,
    Hkv 4, dh 256; 29 local layers with a window of 1024), random weights
    from a seeded CUDA generator with the attention projections at their
    true fan-in (``at_true_fan_in``: at the reference's scale the scores'
    spread makes the softmax an argmax), through ``ServeEngine(max_len=2048,
    chunk=64)``: the six requests of ``engine_prompts`` and one long request
    of 1,600 prompt tokens.  Its chunk calls take the chunk variant (one
    kernel a layer, which writes the rows: no index write), its decode steps
    the fused one (the graph holds one a layer); ``serve_engine`` holds the
    kernel counts, the index writes, finite logits, and replay tokens equal
    to eager ``decode_step``'s, and its decode ms a token is set beside the
    bytes of weights a step reads.  The long request's chunk calls must
    start where its prompt puts them, the last past the window; one more
    chunk call at the last one's position runs under the profiler.  Then a
    chain of GEMMA_CHAIN_CHUNKS 64-token ``prefill_chunk`` calls over the
    engine's 2,048-row cache (chunk kernel; the last chunks past the window)
    is held against ``transformer.prefill`` of the same tokens (flash
    kernel), as ``chunk_chain`` holds TinyLlama's."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import ops
    from repro_torch.models import transformer
    from repro_torch.models.layers import init_params

    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config("gemma3-4b")  # full width and depth, bf16: nothing cut
    windows = transformer._layer_windows(cfg)
    n_local = sum(w is not None for w in windows)
    G = cfg.n_heads // cfg.n_kv_heads
    check((cfg.n_layers, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, n_local, cfg.dtype)
          == (34, 8, 4, 256, 29, torch.bfloat16)
          and {w for w in windows if w is not None} == {1024},
          f"gemma3-4b: {cfg.n_layers} layers, heads {cfg.n_heads}/{cfg.n_kv_heads}, dh "
          f"{cfg.head_dim}, {n_local} local layers, windows {set(windows)}, {cfg.dtype}")
    chunk_var = ops.variant(64, G, cfg.head_dim, cfg.dtype)
    step_var = ops.variant(1, G, cfg.head_dim, cfg.dtype)
    check((chunk_var, step_var) == ("chunk", "fused"),
          f"gemma3-4b: chunk calls on {chunk_var}, decode steps on {step_var}")
    params = at_true_fan_in(
        init_params(torch.Generator(device=dev).manual_seed(0), transformer.lm_specs(cfg),
                    cfg.dtype, dev), cfg)
    n_par = param_bytes(params)[0]
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    check(n_par == GEMMA_PARAMS, f"gemma3-4b: {n_par} parameters, wanted {GEMMA_PARAMS}")
    cluster = ops.plan_chunk(1, 64, G, cfg.n_kv_heads, GEMMA_SERVE_LEN, n_sm)
    print(f"gemma3 serve: {cfg.name} full width and depth, bf16, max_len {GEMMA_SERVE_LEN} "
          f"chunk 64; chunk calls on {chunk_var} (plan_chunk: clusters of {cluster} blocks, "
          f"{-(-64 * G // ops.CHUNK_ROWS) * cfg.n_kv_heads} row tiles, at {n_sm} SMs), decode "
          f"steps on {step_var} (plan_fused at a local and a global layer "
          + ", ".join(str(ops.plan_fused(1, cfg.n_kv_heads, GEMMA_SERVE_LEN, cfg.head_dim,
                                         cfg.dtype, n_sm, w)) for w in (1024, None)) + ")")
    prompts = gemma3_prompts(cfg.vocab)
    run = serve_engine(dev, cfg, params, prompts, ENGINE_NEW, "gemma3-4b", "gemma3-4b req",
                       max_len=GEMMA_SERVE_LEN, profile_chunk_at=GEMMA_LONG - 64)
    check(run["tokens_equal"], "gemma3-4b: graph replays and eager steps gave other tokens")
    print_decode_bounds("gemma3-4b", cfg, params, run)
    rows = run["rows"]
    long = rows[-1]
    check(long["n"] == GEMMA_LONG // 64 and long["skipped"] == ENGINE_SYSTEM // 64,
          f"gemma3-4b long request: skipped {long['skipped']}/{long['n']} chunks, wanted "
          f"{ENGINE_SYSTEM // 64}/{GEMMA_LONG // 64}")
    # the long request's chunk calls, as the engine made them: its last rows
    # reach past the local window, which then cuts the keys of its first
    long_starts = run["chunk_starts"][-long["chunk_calls"]:]
    check(long_starts == list(range(ENGINE_SYSTEM, GEMMA_LONG, 64))
          and long_starts[-1] + 64 > cfg.local_window,
          f"gemma3-4b long request: chunk calls at {long_starts}, wanted "
          f"{ENGINE_SYSTEM} to {GEMMA_LONG - 64} by 64, past the window {cfg.local_window}")
    calls = sum(r["chunk_calls"] for r in rows)
    chunk_ms = sum(r["prefill_s"] for r in rows) * 1e3 / calls
    long_ms = long["prefill_s"] * 1e3 / long["chunk_calls"]
    n_snap, snap_bytes, per_pos = run["snapshot"]
    print(f"gemma3 serve: {len(rows)} requests, prefill ms per chunk call {chunk_ms:.3f} over "
          f"{calls} calls (long request {long_ms:.3f} over {long['chunk_calls']}); chunks "
          f"skipped {[r['skipped'] for r in rows]} of {[r['n'] for r in rows]}; snapshot "
          f"bytes a token a layer {per_pos:.1f}; decode ms a token graph "
          f"{run['graph_ms']:.6f} replay {run['replay_ms']:.6f} eager {run['eager_ms']:.6f}; "
          f"decode kernels {run['launches']}")
    per_call = run["launches"]["chunk"] / calls
    check(per_call == cfg.n_layers and run["launches"]["split"] == 0,
          f"gemma3-4b: {run['launches']} decode kernels over {calls} chunk calls, wanted "
          f"{cfg.n_layers} chunk kernels a call and no split kernel")
    run.update(chunk_ms=chunk_ms, long_chunk_ms=long_ms, calls=calls, n_params=n_par,
               cluster=cluster)

    # the chunk kernel at DC 4 on the real model: a chain of 64-token chunks
    # over the engine's cache, past the local window, against prefill
    toks = torch.tensor([prompts[-1][:64 * GEMMA_CHAIN_CHUNKS]], dtype=torch.int32, device=dev)
    cerrs, chain_launches = chunk_chain(params, cfg, toks, dev, cache_rows=GEMMA_SERVE_LEN,
                                        n_chunks=GEMMA_CHAIN_CHUNKS)
    check(cerrs["logits"][0] <= CHAIN_TOL * cerrs["logits"][1],
          f"gemma3-4b prefill_chunk chain logits differ from prefill's: {cerrs['logits']}")
    check(all(e <= CHAIN_TOL * r for k in ("k", "v") for e, r in cerrs[k]),
          f"gemma3-4b prefill_chunk chain caches differ from prefill's: {cerrs}")
    run.update(chain_errs=cerrs, chain_launches=chain_launches)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return run


# --------------------------------------------------------------------------
# phase: the MoE and MLA families at full width
# --------------------------------------------------------------------------
FAMILY_SEQ = 2048  # deepseek-7b's and qwen2-moe-a2.7b's prefill: qwen2's two groups of 1,024
MLA_LAYERS = 4  # deepseek-v2-236b's cut: its 60 layers take about 478 GB in bf16
MLA_SEQ = 1024  # the flash prefill against the absorbed chunk: one MoE group in both
MLA_REQUESTS, MLA_NEW = 3, 16
FAMILY_TOL = 5e-2  # of the largest |logit|, as tests/test_torch_transformer.py holds bf16
FAMILY_PARAMS = {"deepseek-7b": 6_910_365_696, "qwen2-moe-a2.7b": 14_315_587_584,
                 f"deepseek-v2-236b@{MLA_LAYERS}": 16_937_038_848}


def decode_bounds(cfg, params) -> dict[str, tuple[float, float]]:
    """The least bytes a decode step reads, and their ms at HBM rate: every
    parameter but the embedding table (one row of it is read); for an MoE
    model also the active weights alone (attention, norms, router, shared
    experts, the K routed experts a token takes, the head)."""
    read = param_bytes(params)[1] - param_bytes({"e": params["embed"]})[1]
    out = {"weights": read}
    if cfg.moe is not None:
        m = cfg.moe
        per_expert = 3 * cfg.d_model * m.d_ff_expert * params["embed"].element_size()
        out["active"] = read - cfg.n_layers * (m.n_experts - m.top_k) * per_expert
    return {k: (b, b / HBM_BYTES_PER_S * 1e3) for k, b in out.items()}


def flash_family_case(label: str, B: int, S: int, H: int, dh: int, dv: int, dev) -> dict:
    """The flash forward and backward at a family's prefill and train shape
    (bf16, MHA, causal) on the values as they are, dv wide (MLA: dv < dh,
    which the kernels take natively): out, and dq, dk and dv of the
    backward, against fp32 autograd of the plain version on the same values,
    within TOL; the launches under the instantiation ``ops.instance`` names;
    each kernel's ``queued_ms`` and cold time (``l2_flushed_ms``) beside the
    bound, the plain version and SDPA.  Where dv < dh, the values padded with
    zero columns to dh (the model's route before the kernels took narrower
    values, the earlier design) run in the same process as the before: their
    first dv output columns and gradient columns held the same way, the
    padded output columns zero, their times beside the native ones."""
    from repro_torch.kernels.flash_attention import attention_ref, flash_attention
    from repro_torch.kernels.flash_attention import ops

    dtype = torch.bfloat16
    pad = torch.nn.functional.pad
    gen = torch.Generator(device=dev).manual_seed(4322)
    q = torch.randn(B, S, H, dh, generator=gen, device=dev).to(dtype)
    k = torch.randn(B, S, H, dh, generator=gen, device=dev).to(dtype)
    v = torch.randn(B, S, H, dv, generator=gen, device=dev).to(dtype)
    dout = torch.randn(B, S, H, dv, generator=gen, device=dev).to(dtype)
    var, inst = ops.variant(dtype, dh, 1, dv), ops.instance(dtype, dh, 1, dv)
    check(var == "wgmma", f"flash {label}: variant {var}, wanted wgmma")
    q32, k32, v32 = (t.float().requires_grad_(True) for t in (q, k, v))
    want = attention_ref(q32, k32, v32, causal=True)
    wgrads = torch.autograd.grad(want, (q32, k32, v32), dout.float())
    want = want.detach()
    del q32, k32, v32

    def held(what: str, vv, dd) -> dict:
        """One forward and backward on values vv (dv wide, or padded), the
        output's and dv's first dv columns held; their launches' instance."""
        by = flash_attention.launches_by_instance
        before = {key: dict(n) for key, n in by.items()}
        out, lse = ops.flash_attention_fwd(q, k, vv, causal=True)
        grads = ops.flash_attention_bwd(q, k, vv, out, lse, dd, causal=True)
        torch.cuda.synchronize()
        moved = {key: {c: n[c] - before.get(key, {}).get(c, 0) for c in n}
                 for key, n in by.items() if n != before.get(key)}
        err, ratio = assert_close_ratio(out[..., :dv], want, TOL[dtype])
        zero = bool((out[..., dv:] == 0).all())
        check(math.isfinite(err) and ratio <= 1.0 and zero,
              f"flash {label} {what}: max_abs_err {err} worst ratio {ratio} padded columns zero "
              f"{zero}")
        berr = bratio = 0.0
        for name, got, ref in zip(("dq", "dk", "dv"), (grads[0], grads[1], grads[2][..., :dv]),
                                  wgrads):
            e, r = assert_close_ratio(got, ref, TOL[dtype])
            check(math.isfinite(e) and r <= 1.0,
                  f"flash {label} {what} {name}: max_abs_err {e} worst err/(atol+rtol*|ref|) {r}")
            berr, bratio = max(berr, e), max(bratio, r)
        check(len(moved) == 1 and list(moved.values())[0] == {"fwd": 1, "bwd": 1},
              f"flash {label} {what}: launches by instance {moved}")
        fwd = lambda: ops.flash_attention_fwd(q, k, vv, causal=True)
        bwd = lambda: ops.flash_attention_bwd(q, k, vv, out, lse, dd, causal=True)
        # one profile for both (the tracer kept none of a forward's kernels
        # in profiles of the forward alone), taken again where it kept none
        for _ in range(3):
            split = kernels_of_one_call(lambda: (fwd(), bwd()), iters=10)
            split_fwd = {n: t for n, t in split.items() if n.startswith("flash_fwd")}
            split_bwd = {n: t for n, t in split.items() if n not in split_fwd}
            if split_fwd and split_bwd:
                break
        row = dict(instance=list(moved)[0], max_abs_err=err, ratio=ratio, queued_ms=queued_ms(fwd),
                   l2_flushed_ms=flushed_ms(fwd), ms=cuda_ms(fwd, iters=10, warmup=2),
                   kernels=split_fwd)
        row["bwd"] = dict(max_abs_err=berr, ratio=bratio, queued_ms=queued_ms(bwd),
                          l2_flushed_ms=flushed_ms(bwd), ms=cuda_ms(bwd, iters=10, warmup=2),
                          kernels=split_bwd)
        del out, lse, grads
        return row

    row = held("native", v, dout)
    row["variant"] = var
    check(row["instance"] == inst, f"flash {label}: ran {row['instance']}, wanted {inst}")
    b = row["bwd"]
    if inst == "wgmma 3x2":  # the ping-pong forward; the fused backward's four steps, no more
        want_f = set(MLA_KERNELS["fwd"])
        want_b = {*MLA_KERNELS["bwd"], "flash_bwd_dq_convert_kernel", "Memset (Device)"}
        check(set(row["kernels"]) == want_f and set(b["kernels"]) == want_b,
              f"flash {label}: kernels of a call: forward {sorted(row['kernels'])}, backward "
              f"{sorted(b['kernels'])}; wanted {sorted(want_f)} and {sorted(want_b)}")
    print(f"flash family {label}: kernels of one call (device ms, the profiler): forward "
          + " ".join(f"{n} {t:.4f}" for n, t in row["kernels"].items()) + "; backward "
          + " ".join(f"{n} {t:.4f}" for n, t in b["kernels"].items()))
    row["plain_ms"] = cuda_ms(lambda: attention_ref(q, k, v, causal=True), iters=5, warmup=1)
    row["library_ms"] = cuda_ms(lambda: sdpa(q, k, v, True, None), iters=10, warmup=2)
    case = (label, B, S, H, H, dh, True, None)
    row["bound_ms"], row["bound_by"] = flash_bound_ms(case, dtype, False, dv)
    qg, kg, vg = (t.clone().requires_grad_(True) for t in (q, k, v))
    plain_out = attention_ref(qg, kg, vg, causal=True)
    b["plain_ms"] = backward_ms(plain_out, (qg, kg, vg), dout, 5)
    del plain_out
    lib_out = sdpa(qg, kg, vg, True, None)
    b["library_ms"] = backward_ms(lib_out, (qg, kg, vg), dout, 10)
    del lib_out, qg, kg, vg
    b["bound_ms"], b["bound_by"] = flash_bound_ms(case, dtype, True, dv)
    print(f"flash family {label}: B {B} S {S} Hq=Hkv {H} dh {dh} dv {dv} bf16 {var} "
          f"({row['instance']}) max_abs_err {row['max_abs_err']:.3e} worst err/(atol+rtol*|ref|) "
          f"{row['ratio']:.3f}; queued_ms {row['queued_ms']:.6f} l2_flushed_ms "
          f"{row['l2_flushed_ms']:.6f} ms {row['ms']:.6f} plain_ms {row['plain_ms']:.6f} "
          f"library_ms (SDPA) {row['library_ms']:.6f} bound_ms {row['bound_ms']:.6f} "
          f"({row['bound_by']})")
    print(f"flash family {label} backward: dq, dk, dv max_abs_err {b['max_abs_err']:.3e} worst "
          f"err/(atol+rtol*|ref|) {b['ratio']:.3f}; queued_ms {b['queued_ms']:.6f} l2_flushed_ms "
          f"{b['l2_flushed_ms']:.6f} ms {b['ms']:.6f} plain_ms {b['plain_ms']:.6f} library_ms "
          f"(SDPA) {b['library_ms']:.6f} bound_ms {b['bound_ms']:.6f} ({b['bound_by']})")
    if dv < dh:
        p = held("padded values", pad(v, (0, dh - dv)), pad(dout, (0, dh - dv)))
        pb = p["bwd"]
        print(f"flash family {label} padded values (the earlier design, {p['instance']}): "
              f"forward queued_ms {p['queued_ms']:.6f} l2_flushed_ms {p['l2_flushed_ms']:.6f} "
              f"ms {p['ms']:.6f}; backward queued_ms {pb['queued_ms']:.6f} l2_flushed_ms "
              f"{pb['l2_flushed_ms']:.6f} ms {pb['ms']:.6f}; native over padded queued_ms: "
              f"forward {row['queued_ms'] / p['queued_ms']:.4f} backward "
              f"{b['queued_ms'] / pb['queued_ms']:.4f}")
        row["padded"] = p
    del q, k, v, dout, want, wgrads
    torch.cuda.empty_cache()
    return row


def family_prefill(dev, cfg, params, S: int, tag: str) -> dict:
    """``transformer.prefill`` of B 1 x S tokens (a warm-up, then one timed
    call): every flash call the ``wgmma`` kernels, one a layer, finite
    logits, the cache's shape."""
    from repro_torch.kernels.flash_attention import flash_attention, reset_launches
    from repro_torch.models import transformer

    toks = torch.from_numpy(
        np.random.default_rng(0).integers(0, cfg.vocab, size=(1, S)).astype(np.int32)).to(dev)
    transformer.prefill(params, cfg, toks)  # warm-up
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    logits, cache, clen = transformer.prefill(params, cfg, toks)
    ok = bool(torch.isfinite(logits).all())  # waits for the device
    ms = (time.perf_counter() - t0) * 1e3
    launches = flash_attention.launches_fwd
    by_var = flash_attention.launches_by_variant
    shapes = {k: tuple(a.shape) for k, a in cache.items()}
    print(f"{tag} prefill: B 1 S {S} bf16 ms {ms:.3f} flash launches fwd {launches} by variant "
          f"{by_var} cache {shapes} logits finite {ok}")
    check(ok, f"{tag} prefill: non-finite logits")
    check(launches == cfg.n_layers == by_var["wgmma"]["fwd"] and flash_attention.launches_bwd == 0,
          f"{tag} prefill: flash launches {by_var}, wanted {cfg.n_layers} wgmma")
    want = transformer.init_cache(cfg, 1, S, "meta")
    check(clen.tolist() == [S] and shapes == {k: tuple(a.shape) for k, a in want.items()},
          f"{tag} prefill: cache {shapes} length {clen.tolist()}")
    return {"ms": ms, "launches": launches}


def family_params(dev, cfg, key: str) -> dict:
    from repro_torch.models import transformer
    from repro_torch.models.layers import init_params

    gc.collect()
    torch.cuda.empty_cache()
    params = init_params(torch.Generator(device=dev).manual_seed(0), transformer.lm_specs(cfg),
                         cfg.dtype, dev)
    n_par, n_bytes = param_bytes(params)
    print(f"{key}: {cfg.name} {cfg.n_layers} layers d_model {cfg.d_model} bf16 parameters "
          f"{n_par} bytes {n_bytes}")
    check(n_par == FAMILY_PARAMS[key], f"{key}: {n_par} parameters, wanted {FAMILY_PARAMS[key]}")
    return params


def print_decode_bounds(tag: str, cfg, params, run: dict) -> None:
    b = decode_bounds(cfg, params)
    print(f"{tag}: decode ms per token (graph) {run['graph_ms']:.6f} against its bounds: "
          + "; ".join(f"{k} {n} B {ms:.6f} ms ({run['graph_ms'] / ms:.2f}x)"
                      for k, (n, ms) in b.items()))
    run["bounds"] = b


def phase_deepseek7b(dev) -> dict:
    """deepseek-7b at full width (30 layers, d_model 4096, MHA: 32 heads of
    128), bf16: the serving phase's six requests and a 2,048-token prefill
    (flash at dh 128, G 1; chunk and fused kernels at dh 128, G 1)."""
    from repro_torch.configs import get_config

    cfg = get_config("deepseek-7b")
    params = family_params(dev, cfg, "deepseek-7b")
    run = serve_engine(dev, cfg, params, engine_prompts(cfg.vocab), ENGINE_NEW, "deepseek-7b",
                       "deepseek-7b req")
    check(run["tokens_equal"], "deepseek-7b: graph replays and eager steps gave other tokens")
    print_decode_bounds("deepseek-7b", cfg, params, run)
    run["prefill"] = family_prefill(dev, cfg, params, FAMILY_SEQ, "deepseek-7b")
    del params
    run["flash"] = flash_family_case("deepseek-7b prefill", 1, FAMILY_SEQ, 32, 128, 128, dev)
    return run


def phase_qwen2_moe(dev) -> dict:
    """qwen2-moe-a2.7b at full width (24 layers, d_model 2048, MHA: 16 heads
    of 128; 60 routed experts top-4 and 4 shared, each of 1,408), bf16: the
    six requests (graph replay's tokens held equal to eager ``decode_step``'s
    from one state, the share of routed pairs capacity dropped), a 2,048-token
    prefill (two groups of 1,024, C 86), and decode ms per token against
    every expert's weights read once and against the active weights alone."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer
    from repro_torch.models.moe import groups

    cfg = get_config("qwen2-moe-a2.7b")
    dims = transformer._moe_dims(cfg)
    check(groups(FAMILY_SEQ, dims) == (2, 1024, 86),
          f"qwen2-moe prefill groups {groups(FAMILY_SEQ, dims)}, wanted (2, 1024, 86)")
    params = family_params(dev, cfg, "qwen2-moe-a2.7b")
    run = serve_engine(dev, cfg, params, engine_prompts(cfg.vocab), ENGINE_NEW, "qwen2-moe",
                       "qwen2-moe req")
    check(run["tokens_equal"], "qwen2-moe: graph replays and eager steps gave other tokens")
    print_decode_bounds("qwen2-moe", cfg, params, run)
    run["prefill"] = family_prefill(dev, cfg, params, FAMILY_SEQ, "qwen2-moe")
    del params
    run["flash"] = flash_family_case("qwen2-moe prefill", 1, FAMILY_SEQ, 16, 128, 128, dev)
    return run


def mla_tokens(dev, cfg) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, size=(1, MLA_SEQ)).astype(np.int32)).to(dev)


def routing_flips(a: tuple, b: tuple) -> float:
    """Share of (token, k) expert choices of route result ``a`` that ``b``
    does not make for the same token (in any k)."""
    ia, ib = a[1], b[1]
    return 1.0 - (ia[..., :, None] == ib[..., None, :]).any(-1).float().mean().item()


def mla_instance(cfg) -> str:
    """The flash instantiation every MLA attention call must take: keys of
    nope + rope columns, values of v_head_dim, unpadded ("wgmma 3x2" in bf16
    at deepseek-v2's widths; "tf32x3" in fp32)."""
    from repro_torch.kernels.flash_attention import ops

    m = cfg.mla
    inst = ops.instance(cfg.dtype, m.nope_head_dim + m.rope_head_dim,
                        cfg.n_heads // cfg.n_kv_heads, m.v_head_dim)
    check(cfg.dtype != torch.bfloat16 or inst == "wgmma 3x2",
          f"{cfg.name}: flash instance {inst}, wanted wgmma 3x2")
    return inst


def mla_witness(dev, cfg, params, label: str) -> dict:
    """``forward`` over B 1 x MLA_SEQ tokens (one MoE group; flash at dh 192
    with values of 128, every launch the instantiation ``mla_instance``
    names) against one ``prefill_chunk`` call over the
    same tokens (the absorbed attention over the latent cache; the same
    group): the last position's logits, (max abs err, largest |ref|).  The
    chunk runs twice: routing freely, and replaying the forward's routing
    (``moe.route``'s gates, ids and slots, layer by layer), which leaves the
    attention's rounding as the only source of the gap; the share of expert
    choices the free chunk makes otherwise is read per layer."""
    from repro_torch.kernels.flash_attention import flash_attention, reset_launches, variant
    from repro_torch.models import moe, transformer

    toks = mla_tokens(dev, cfg)
    inst = mla_instance(cfg)
    inner = moe.route
    routes: dict[str, list] = {"forward": [], "chunk": []}

    def recorded(where):
        def route(x, router, dims):
            routes[where].append(inner(x, router, dims))
            return routes[where][-1]
        return route

    def replayed():
        it = iter(routes["forward"])
        return lambda x, router, dims: next(it)

    def chunk():
        cache = transformer.init_cache(cfg, 1, MLA_SEQ, dev)
        return transformer.prefill_chunk(
            params, cfg, toks, cache, torch.zeros(1, dtype=torch.int32, device=dev))

    try:
        with torch.no_grad():
            transformer.forward(params, cfg, toks, last_only=True)  # warm-up
            torch.cuda.synchronize()
            reset_launches()
            moe.route = recorded("forward")
            t0 = time.perf_counter()
            full, _ = transformer.forward(params, cfg, toks, last_only=True)
            torch.cuda.synchronize()
            fwd_ms = (time.perf_counter() - t0) * 1e3
            by_var = {v: dict(n) for v, n in flash_attention.launches_by_variant.items()}
            by_inst = {v: dict(n) for v, n in flash_attention.launches_by_instance.items()}
            moe.route = recorded("chunk")
            t0 = time.perf_counter()
            free, _, clen = chunk()
            torch.cuda.synchronize()
            chunk_ms = (time.perf_counter() - t0) * 1e3
            moe.route = replayed()
            same, _, _ = chunk()
    finally:
        moe.route = inner
    full = full[:, -1]
    err, largest = (full - free).abs().max().item(), full.abs().max().item()
    err_same = (full - same).abs().max().item()
    flips = [routing_flips(a, b) for a, b in zip(routes["forward"], routes["chunk"])]
    var = variant(cfg.dtype, cfg.mla.nope_head_dim + cfg.mla.rope_head_dim, 1)
    print(f"deepseek-v2 witness ({label}): {cfg.n_layers} layers {str(cfg.dtype)[6:]} forward "
          f"(flash {inst}, dh 192, values 128) ms {fwd_ms:.3f} against one prefill_chunk "
          f"(absorbed) ms {chunk_ms:.3f} over {MLA_SEQ} tokens: last logits max_abs_err "
          f"{err:.4e} largest {largest:.4e} ({err / largest:.4e} of it); with the forward's "
          f"routing replayed {err_same:.4e} ({err_same / largest:.4e} of it); expert choices "
          f"the free chunk makes otherwise, by layer {[f'{f:.6f}' for f in flips]}; "
          f"flash launches {by_var} by instance {by_inst}")
    check(by_var[var]["fwd"] == cfg.n_layers and sum(
        n["fwd"] for n in by_var.values()) == cfg.n_layers,
        f"deepseek-v2 witness: flash launches {by_var}, wanted {cfg.n_layers} {var}")
    check(by_inst == {inst: {"fwd": cfg.n_layers, "bwd": 0}},
          f"deepseek-v2 witness: flash launches by instance {by_inst}, wanted {cfg.n_layers} "
          f"{inst} (values unpadded)")
    check(clen.tolist() == [MLA_SEQ], f"deepseek-v2 witness: length {clen.tolist()}")
    check(len(flips) == cfg.n_layers and len(routes["chunk"]) == cfg.n_layers,
          f"deepseek-v2 witness: routed {len(routes['forward'])} and {len(routes['chunk'])} "
          f"times, wanted {cfg.n_layers}")
    return {"err": err, "err_same_routing": err_same, "largest": largest, "flips": flips,
            "fwd_ms": fwd_ms, "chunk_ms": chunk_ms, "launches": cfg.n_layers}


def absorbed_scores_rounded(x, p, c_kv, k_rope, cfg, dtype) -> torch.Tensor:
    """``mla_decode`` of MLA_SEQ tokens over their own latent rows in fp32,
    with only the score terms rounded to ``dtype`` where the working-dtype
    path rounds them: the absorbed query, each of the two score products and
    their sum.  Against fp32, it shows what the score rounding alone moves."""
    from repro_torch.models import attention

    m = cfg.mla
    B, S, _ = x.shape

    def rnd(t):
        return t.to(dtype).float()

    q_nope, q_rope = attention._mla_query(x, p, m.nope_head_dim,
                                          torch.arange(S, device=x.device)[None], cfg.rope_theta)
    q_lat = rnd(torch.einsum("bshe,rhe->bshr", q_nope, p["w_uk"]))
    scores = rnd(rnd(torch.einsum("bshr,btr->bhst", q_lat, c_kv))
                 + rnd(torch.einsum("bshe,bte->bhst", q_rope, k_rope)))
    scores = scores / math.sqrt(m.nope_head_dim + m.rope_head_dim)
    future = torch.ones(S, S, dtype=torch.bool, device=x.device).triu(1)
    probs = torch.softmax(scores.masked_fill(future, float("-inf")), dim=-1)
    ctx = torch.einsum("bhst,btr->bshr", probs, c_kv)
    return torch.einsum("bshr,rhe->bshe", ctx, p["w_uv"]).reshape(B, S, -1)


def mla_attention_witness(dev, cfg, params, label: str) -> dict:
    """Layer 0's attention alone, with no MoE after it, on the witness's
    tokens: ``mla_prefill`` on the flash kernel and the absorbed
    ``mla_decode`` over the prefill's own latent rows, both in the working
    dtype, each against ``mla_prefill`` in fp32 (plain attention) from the
    same rounded inputs, as is ``absorbed_scores_rounded``.  Held: the fp32
    absorbed path within 1e-4 of the fp32 prefill, the flash prefill within
    the bf16 bound of it, and the working-dtype absorbed path no further
    from it than that bound past what rounding its scores alone moves.
    (max abs err, largest |fp32|) of each."""
    from repro_torch.kernels.flash_attention import flash_attention, reset_launches
    from repro_torch.models import attention, transformer
    from repro_torch.models.layers import rms_norm

    m = cfg.mla
    toks = mla_tokens(dev, cfg)
    p0 = {k: v[0] for k, v in params["layers"]["attn"].items()}
    x = rms_norm(torch.nn.functional.embedding(toks, params["embed"]), params["layers"]["ln1"][0])
    kw = dict(n_heads=cfg.n_heads, nope=m.nope_head_dim, rope=m.rope_head_dim,
              v_dim=m.v_head_dim, positions=torch.arange(MLA_SEQ, device=dev)[None],
              theta=cfg.rope_theta)
    start = torch.zeros(1, dtype=torch.int32, device=dev)
    p32 = {k: v.float() for k, v in p0.items()}
    reset_launches()
    with torch.no_grad():
        flash, c_kv, k_rope = attention.mla_prefill(
            x, p0, attend=lambda q, k, v: transformer._full_attention(cfg, q, k, v, 1.0, True),
            **kw)
        absorbed = attention.mla_decode(x, p0, c_kv, k_rope, start, **kw)
        ref, c32, r32 = attention.mla_prefill(
            x.float(), p32, attend=lambda q, k, v: attention.gqa_attention(q, k, v, causal=True),
            **kw)
        abs32 = attention.mla_decode(x.float(), p32, c32, r32, start, **kw)
        scores_rounded = absorbed_scores_rounded(x.float(), p32, c32, r32, cfg, cfg.dtype)
    n = sum(c["fwd"] for c in flash_attention.launches_by_variant.values())
    check(n == 1, f"deepseek-v2 attention witness ({label}): {n} flash launches, wanted 1")
    by_inst = flash_attention.launches_by_instance
    check(by_inst == {mla_instance(cfg): {"fwd": 1, "bwd": 0}},
          f"deepseek-v2 attention witness ({label}): flash launches by instance {by_inst}")
    largest = ref.abs().max().item()
    out = {"largest": largest, "launches": n, **{name: (a.float() - b.float()).abs().max().item()
                                                 for name, a, b in (
        ("flash", flash, ref), ("absorbed", absorbed, ref), ("flash_absorbed", flash, absorbed),
        ("fp32_absorbed", abs32, ref), ("scores_rounded", scores_rounded, ref),
        ("absorbed_scores_rounded", absorbed, scores_rounded))}}
    print(f"deepseek-v2 attention witness ({label}, layer 0, no MoE, {str(cfg.dtype)[6:]}): "
          f"largest fp32 output {largest:.4e}; max_abs_err against it: flash prefill "
          f"{out['flash']:.4e} ({out['flash'] / largest:.4e} of it), absorbed "
          f"{out['absorbed']:.4e} ({out['absorbed'] / largest:.4e}), fp32 absorbed with only "
          f"its scores rounded {out['scores_rounded']:.4e} "
          f"({out['scores_rounded'] / largest:.4e}), fp32 absorbed {out['fp32_absorbed']:.4e} "
          f"({out['fp32_absorbed'] / largest:.4e}); flash against absorbed "
          f"{out['flash_absorbed']:.4e} ({out['flash_absorbed'] / largest:.4e}); absorbed "
          f"against the scores-only rounding {out['absorbed_scores_rounded']:.4e} "
          f"({out['absorbed_scores_rounded'] / largest:.4e})")
    for key, tol, what in (("fp32_absorbed", 1e-4, "fp32 absorbed path and fp32 prefill"),
                           ("flash", FAMILY_TOL, "flash prefill and fp32 prefill")):
        check(math.isfinite(out[key]) and out[key] <= tol * largest,
              f"deepseek-v2 attention witness ({label}): {what} differ by {out[key]} "
              f"(largest {largest}, tol {tol} of it)")
    # the two roundings of the scores fall apart (their errors are of one
    # size, not one sign), so what is held is the size
    check(math.isfinite(out["absorbed"])
          and out["absorbed"] <= out["scores_rounded"] + FAMILY_TOL * largest,
          f"deepseek-v2 attention witness ({label}): the absorbed path is {out['absorbed']} from "
          f"fp32, more than the bf16 bound past its scores' rounding alone "
          f"({out['scores_rounded']}; largest {largest})")
    return out


def phase_deepseek_v2(dev) -> dict:
    """deepseek-v2-236b at full width (d_model 5120; MLA: 128 heads, latent
    512, rope 64, nope 128, values 128; 160 routed experts top-6 and 2
    shared, each of 1,536) cut to MLA_LAYERS of its 60 layers, bf16: three
    requests sharing the 512-token prompt (the latent cache; the absorbed
    attention is plain torch, so no decode kernel), the snapshot bytes a
    token against an MHA cache's, and the flash prefill against the
    absorbed path on the same 1,024 tokens."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer
    from repro_torch.models.layers import init_params

    full = get_config("deepseek-v2-236b")
    cfg = dataclasses.replace(full, n_layers=MLA_LAYERS)
    m = cfg.mla
    print(f"deepseek-v2: reduced n_layers {full.n_layers} -> {MLA_LAYERS} (60 layers take about "
          f"478 GB in bf16); widths as published")
    params = family_params(dev, cfg, f"deepseek-v2-236b@{MLA_LAYERS}")
    run = serve_engine(dev, cfg, params, engine_prompts(cfg.vocab)[:MLA_REQUESTS], MLA_NEW,
                       "deepseek-v2", "deepseek-v2 req")
    check(run["tokens_equal"], "deepseek-v2: graph replays and eager steps gave other tokens")
    check(sum(run["launches"].values()) == 0,
          f"deepseek-v2: decode kernels {run['launches']}, wanted none (MLA)")
    print_decode_bounds("deepseek-v2", cfg, params, run)
    isz = params["embed"].element_size()
    latent = (m.kv_lora_rank + m.rope_head_dim) * isz
    mha = cfg.n_heads * ((m.nope_head_dim + m.rope_head_dim) + m.v_head_dim) * isz
    print(f"deepseek-v2: snapshot bytes a token a layer {run['snapshot'][2]:.1f} (latent "
          f"{latent}) against an MHA cache's {mha} ({mha / latent:.2f}x)")
    check(run["snapshot"][2] == latent, f"deepseek-v2: snapshot {run['snapshot']} B")
    run["snapshot_mha"] = mha
    # the flash prefill against the absorbed chunk.  In bf16 the absorbed
    # path rounds its score terms to bf16 before the softmax (as the
    # reference does), where the flash kernel keeps fp32 scores.  At the
    # reference's init (w_uq, w_uk, w_uv drawn at 1/sqrt of the head axis,
    # 128, not of the ranks 1,536 and 512) the scores spread several times
    # wider: that rounding alone then moves layer 0's attention about as far
    # from fp32 as the whole bf16 absorbed path does (mla_attention_witness),
    # the 160-way routing of the two paths parts more with each layer, and
    # their logits part past the bound.  So at that init the bf16 logits are
    # printed with their split, and held are the attention alone against
    # fp32 and, in fp32 at one layer, the logits (below); at the true fan-in
    # the bf16 logits are held, as tests/test_torch_transformer.py holds them
    run["witness"] = {label: mla_witness(dev, cfg, p, label) for label, p in (
        ("reference init", params), ("true fan-in", at_true_fan_in(params, cfg)))}
    run["attention_witness"] = {label: mla_attention_witness(dev, cfg, p, label) for label, p in (
        ("reference init", params), ("true fan-in", at_true_fan_in(params, cfg)))}
    w = run["witness"]["true fan-in"]
    check(math.isfinite(w["err"]) and w["err"] <= FAMILY_TOL * w["largest"],
          f"deepseek-v2 witness: flash prefill and absorbed chunk differ by {w['err']} "
          f"(largest {w['largest']}) at the true fan-in")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    c32 = dataclasses.replace(cfg, n_layers=1, dtype=torch.float32)
    p32 = init_params(torch.Generator(device=dev).manual_seed(0), transformer.lm_specs(c32),
                      c32.dtype, dev)
    w = mla_witness(dev, c32, p32, "fp32, reference init")
    check(math.isfinite(w["err"]) and w["err"] <= 1e-4 * w["largest"],
          f"deepseek-v2 fp32 witness: flash prefill and absorbed chunk differ by {w['err']} "
          f"(largest {w['largest']}; tol 1e-4 of it)")
    run["witness"]["fp32, 1 layer, reference init"] = w
    del p32
    torch.cuda.empty_cache()
    run["flash"] = flash_family_case("deepseek-v2 prefill (MLA)", 1, MLA_SEQ, cfg.n_heads,
                                     m.nope_head_dim + m.rope_head_dim, m.v_head_dim, dev)
    return run


FAMILY_CHECK_LAYERS = 2  # qwen2-moe-a2.7b's card-vs-CPU check in fp32: 7.05 GB


def phase_family_parity(dev) -> dict:
    """Card against CPU in fp32.  The smoke configs of qwen2-moe,
    deepseek-v2 and deepseek-7b, and gemma3's at dh 256 (window 8, as
    tests/test_torch_transformer.py widens it; attention projections at
    their true fan-in, where a rounding in another order moves no argmax)
    through two engines (tokens and chunks skipped equal, as
    ``phase_parity``; gemma3's chunks on the split variant and its decode
    steps on the fused one at dh 256, G 2); then qwen2-moe-a2.7b at full width
    cut to FAMILY_CHECK_LAYERS layers, attention projections at their true
    fan-in (``at_true_fan_in``; the experts are drawn at it already): one
    64-token chunk and 4 decode steps of the same tokens on both devices,
    logits within 1e-4 of the largest, and ``moe.route`` on the card's MoE
    inputs giving the same expert ids and slots on both devices."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.decode_attention.ops import reset_launches
    from repro_torch.models import moe, transformer
    from repro_torch.models.layers import init_params
    from repro_torch.serve import ServeEngine

    out = {"split": 0, "fused": 0}
    for arch in ("qwen2-moe-a2.7b", "deepseek-v2-236b", "deepseek-7b", "gemma3-4b"):
        gemma = arch == "gemma3-4b"  # at dh 256, projections at their true fan-in
        cfg = dataclasses.replace(get_config(arch, smoke=True), dtype=torch.float32,
                                  **({"d_head": 256} if gemma else {}))
        cpu_params = init_params(torch.Generator(device="cpu").manual_seed(0),
                                 transformer.lm_specs(cfg), cfg.dtype, "cpu")
        if gemma:
            cpu_params = at_true_fan_in(cpu_params, cfg)
        on_dev = ServeEngine(cfg, to_device(cpu_params, dev), max_len=128, chunk=16, device=dev)
        on_cpu = ServeEngine(cfg, cpu_params, max_len=128, chunk=16, device="cpu")
        reset_launches()
        for i, prompt in enumerate(smoke_stream(cfg.vocab)):
            a, sa = on_dev.generate(prompt, max_new_tokens=8)
            b, sb = on_cpu.generate(prompt, max_new_tokens=8)
            check(a == b and sa.chunks_skipped == sb.chunks_skipped,
                  f"{cfg.name} parity request {i + 1}: card {a} skipped {sa.chunks_skipped}, "
                  f"cpu {b} skipped {sb.chunks_skipped}")
        n = dict(decode_attention.launches_by_variant)
        skipped = on_dev.aggregate_stats().units_skipped
        print(f"family parity {cfg.name} fp32: {len(smoke_stream(cfg.vocab))} requests tokens "
              f"equal, chunks skipped {skipped} on both; decode kernels {n}; graph holds "
              f"{on_dev._graph.kernels}")
        check(skipped > 0, f"{cfg.name} parity: no chunk skipped")
        if gemma:
            check(cfg.head_dim == 256 and n["split"] > 0 and n["fused"] > 0 and n["chunk"] == 0,
                  f"{cfg.name} dh {cfg.head_dim} parity: decode kernels {n}, wanted split and "
                  f"fused only")
            out["gemma3_split"], out["gemma3_fused"] = n["split"], n["fused"]
        out["split"] += n["split"]
        out["fused"] += n["fused"]

    cfg = dataclasses.replace(get_config("qwen2-moe-a2.7b"), n_layers=FAMILY_CHECK_LAYERS,
                              dtype=torch.float32)
    params = at_true_fan_in(init_params(torch.Generator(device=dev).manual_seed(3),
                                        transformer.lm_specs(cfg), cfg.dtype, dev), cfg)
    cpu_params = cpu_f32(params)
    print(f"family parity {cfg.name} fp32 {cfg.n_layers} layers: parameters "
          f"{param_bytes(params)[0]} bytes {param_bytes(params)[1]}")
    rng = np.random.default_rng(3)
    steps = [rng.integers(0, cfg.vocab, size=(1, 64))] + [
        rng.integers(0, cfg.vocab, size=(1, 1)) for _ in range(4)]
    routes: dict[str, list] = {"card": [], "cpu": []}
    inner_route = moe.route

    def recorded(where):
        def route(x, router, dims):
            r = inner_route(x, router, dims)
            routes[where].append((x, router, dims, r))
            return r
        return route

    reset_launches()
    logits = {}
    t0 = time.perf_counter()
    try:
        for where, p, d in (("card", params, dev), ("cpu", cpu_params, torch.device("cpu"))):
            moe.route = recorded(where)
            cache = transformer.init_cache(cfg, 1, 128, d)
            clen = torch.zeros(1, dtype=torch.int32, device=d)
            logits[where] = []
            with torch.no_grad():
                for i, toks in enumerate(steps):
                    fn = transformer.prefill_chunk if i == 0 else transformer.decode_step
                    lg, cache, clen = fn(p, cfg, torch.from_numpy(toks).to(d), cache, clen)
                    logits[where].append(lg.cpu())
    finally:
        moe.route = inner_route
    cpu_s = time.perf_counter() - t0
    n = dict(decode_attention.launches_by_variant)
    worst = 0.0
    for i, (a, b) in enumerate(zip(logits["card"], logits["cpu"])):
        err, largest = (a - b).abs().max().item(), b.abs().max().item()
        worst = max(worst, err / largest)
        print(f"family parity {cfg.name} {cfg.n_layers} layers fp32 step {i} "
              f"({'chunk of 64' if i == 0 else 'decode'}): max_abs_err {err:.4e} largest "
              f"{largest:.4e} (tol 1e-4 of the largest)")
        check(math.isfinite(err) and err <= 1e-4 * largest,
              f"{cfg.name} parity step {i}: card logits differ by {err} (largest {largest})")
    same = diff_ids = 0
    for (x, router, dims, r), (_, _, _, rc) in zip(routes["card"], routes["cpu"]):
        # the routing of the card's own inputs, on the CPU
        again = inner_route(x.cpu(), router.cpu(), dims)
        for a, b in zip(r[1:], again[1:]):
            check(torch.equal(a.cpu(), b), f"{cfg.name} parity: route differs between devices")
        diff_ids += int((r[1].cpu() != rc[1]).sum())
        same += 1
    check(len(routes["card"]) == len(routes["cpu"]) == FAMILY_CHECK_LAYERS * len(steps),
          f"{cfg.name} parity: MoE calls {len(routes['card'])} / {len(routes['cpu'])}")
    check(diff_ids == 0, f"{cfg.name} parity: the two runs routed {diff_ids} pairs differently")
    print(f"family parity {cfg.name}: route on the card's inputs gives equal expert ids and "
          f"slots on both devices in {same} MoE calls; the two runs' own routes equal; worst "
          f"err / largest {worst:.3e}; decode kernels {n}; {cpu_s:.1f} s")
    out["split"] += n["split"]
    out["fused"] += n["fused"]
    out["check_split"], out["check_fused"] = n["split"], n["fused"]
    del params, cpu_params, routes
    return out


# (arch, layers the card trains at full width): the deepest cut whose train
# step keeps its peak under about 75 GB (bf16 parameters and gradients, fp32
# moments: 12 B a parameter, plus the step's activations and temporaries)
FAMILY_TRAIN = (("deepseek-7b", 24), ("qwen2-moe-a2.7b", 9), ("deepseek-v2-236b", 1))
FAMILY_TRAIN_SEQ = 2048  # B 1 x S 2048: two MoE groups of 1,024
FAMILY_TRAIN_STEPS = 4  # one warm-up, three timed
FAMILY_GRAD_TOL = 5e-2  # of the plain attention's gradient norm, as gemma3's witness holds it
FAMILY_SMOKE_STEPS = 5


def leaf_paths(tree, prefix: str = "") -> list[str]:
    """The leaves' paths ("layers/attn/w_uq"), in ``leaves`` order."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in leaf_paths(tree[k], f"{prefix}{k}/")]
    return [prefix[:-1]]


def rel_diff(a: torch.Tensor, b: torch.Tensor) -> float:
    """|a - b| / |b| in fp64 norms."""
    return (torch.linalg.vector_norm(a.float() - b.float(), dtype=torch.float64).item()
            / max(torch.linalg.vector_norm(b, dtype=torch.float64).item(), 1e-300))


def family_grads(params, cfg, batch, remat: str = "none", attn=None, route=None):
    """(loss, gradient leaves, the ``moe.route`` results in call order) of one
    forward and backward of ``_lm_loss``; ``attn`` stands in for the flash
    kernels and ``route`` for ``moe.route`` (given the inner route)."""
    from repro_torch.configs import ShapeCell
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import moe, transformer
    from repro_torch.train import build_loss_fn
    from repro_torch.tree import leaves as tree_leaves, unflatten

    S = batch["tokens"].shape[1]
    loss_fn = build_loss_fn(cfg, ShapeCell("train", "train", {"seq_len": S, "global_batch": 1}),
                            remat=remat)
    inner = moe.route
    routes: list = []

    def recorded(x, router, dims):
        out = (route or inner)(x, router, dims)
        routes.append(tuple(t.detach() for t in out))
        return out

    req = [t.detach().requires_grad_(True) for t in tree_leaves(params)]
    moe.route = recorded
    transformer.flash_attention = attn or flash_attention
    try:
        loss, _ = loss_fn(unflatten(params, req), batch)
        grads = torch.autograd.grad(loss, req)
    finally:
        moe.route, transformer.flash_attention = inner, flash_attention
    return float(loss.detach()), list(grads), routes


def replayed_route(recorded: list, flips: list | None = None):
    """``moe.route`` that takes each call's expert ids and slots from
    ``recorded`` and computes the gates from this call's own inputs (so the
    router still gets its gradient), as ``route`` computes them.  Where
    ``flips`` is given, each call appends the share of the recorded choices
    that its own routing (``moe.route`` on its inputs) would have flipped
    (``routing_flips``)."""
    from repro_torch.models import moe
    from repro_torch.models.moe import groups

    own, calls = moe.route, iter(recorded)

    def route(x, router, dims):
        rec = next(calls)
        _, idx, slot = rec
        B, S, d = x.shape
        G, g, _ = groups(B * S, dims)
        probs = torch.softmax((x.reshape(G, g, d) @ router).float(), dim=-1)
        gates = probs.gather(-1, idx)
        if flips is not None:
            flips.append(routing_flips(rec, own(x, router, dims)))
        return gates / gates.sum(-1, keepdim=True).clamp_min(1e-9), idx, slot
    return route


def equal_routes(a: list, b: list) -> bool:
    return len(a) == len(b) and all(
        torch.equal(x, y) for ra, rb in zip(a, b) for x, y in zip(ra, rb))


def family_checks(dev, cfg, params, batch, tag: str) -> dict:
    """Gradient checks at full width and cut depth, on the parameters alone
    (before the train state exists): a gradient under remat full against
    remat none, with each layer's recomputed route (gates, ids, slots) equal
    bit for bit to its forward's; for qwen2-moe the gradient taken twice
    from one state and batch (equal bits, or the leaves that differ are
    named); for deepseek-v2 the MLA gradient witness: the gradient through
    the flash kernels (values unpadded) against the plain ``attention_ref`` in
    fp32 on the same values, routing free and with the flash run's routing
    replayed, gradient norms and the attention leaves within 5e-2."""
    from repro_torch.kernels.flash_attention import attention_ref, flash_attention

    names = leaf_paths(params)
    out: dict = {}
    f0, b0 = flash_attention.launches_fwd, flash_attention.launches_bwd
    by_inst0 = {k: dict(n) for k, n in flash_attention.launches_by_instance.items()}
    loss, g_none, r_none = family_grads(params, cfg, batch)
    norm = lambda gs: math.sqrt(sum(torch.linalg.vector_norm(g, dtype=torch.float64).item() ** 2
                                    for g in gs))
    n_none = norm(g_none)
    _, g_full, r_full = family_grads(params, cfg, batch, remat="full")
    L = cfg.n_layers
    moe_layers = L if cfg.moe is not None else 0
    recomputed = [r_full[2 * L - 1 - i] for i in range(L)] if moe_layers else []
    same_routes = equal_routes(r_full[:L], recomputed) and equal_routes(r_full[:L], r_none)
    worst = max(rel_diff(a, b) for a, b in zip(g_full, g_none))
    bits = all(torch.equal(a, b) for a, b in zip(g_full, g_none))
    print(f"{tag} remat full against none: loss {loss:.6f} grad norm {n_none:.6e}; worst leaf "
          f"|g_full - g_none| / |g_none| {worst:.4e} equal bits {bits}; MoE calls "
          f"{len(r_full)} (forward {moe_layers}, recomputed {len(r_full) - moe_layers}); "
          f"recomputed routes equal the forward's bit for bit {same_routes}")
    check(math.isfinite(loss) and math.isfinite(n_none), f"{tag}: non-finite loss or gradient")
    check(len(r_full) == 2 * moe_layers and same_routes,
          f"{tag}: under remat the recomputed routing differs from the forward's")
    out.update(loss=loss, grad_norm=n_none, remat_worst=worst, remat_bits=bits)
    del g_full, r_full, recomputed
    if cfg.moe is not None and cfg.mla is None:  # qwen2-moe: two runs, one state and batch
        _, g_again, r_again = family_grads(params, cfg, batch)
        differ = [n for n, a, b in zip(names, g_none, g_again) if not torch.equal(a, b)]
        print(f"{tag} determinism: gradients taken twice from one state and batch: "
              f"{'equal bits in every leaf' if not differ else 'leaves that differ: ' + str(differ)}"
              f"; routes equal {equal_routes(r_none, r_again)}")
        check(equal_routes(r_none, r_again), f"{tag}: two runs routed differently")
        out["determinism_differ"] = differ
        del g_again, r_again
    if cfg.mla is not None:  # the MLA gradient witness

        def plain_fp32(q, k, v, *, causal=True, window=None):
            return attention_ref(q.float(), k.float(), v.float(), causal=causal,
                                 window=window).to(q.dtype)

        attn_idx = [i for i, n in enumerate(names) if n.startswith("layers/attn/")]
        wit = {}
        for label, route in (("free", None), ("replayed", replayed_route(r_none))):
            lp, gp, rp = family_grads(params, cfg, batch, attn=plain_fp32, route=route)
            flips = sum(routing_flips(a, b) for a, b in zip(r_none, rp)) / max(len(rp), 1)
            leaf = {names[i]: rel_diff(g_none[i], gp[i]) for i in attn_idx}
            n_plain = norm(gp)
            wit[label] = dict(loss=lp, norm=n_plain, norm_rel=abs(n_none - n_plain) / n_plain,
                              attn_worst=max(leaf.values()), flips=flips)
            print(f"{tag} MLA gradient witness, plain attention_ref fp32, routing {label}: loss "
                  f"{lp:.6f} grad norm {n_plain:.6e} against the kernels' {n_none:.6e} (rel "
                  f"{wit[label]['norm_rel']:.4e}); expert choices parting {flips:.6f}; "
                  f"attention leaves |g_kernel - g_plain| / |g_plain| "
                  + " ".join(f"{n.split('/')[-1]} {d:.4e}" for n, d in leaf.items()))
            del gp, rp
        w = wit["replayed"]
        check(w["norm_rel"] <= FAMILY_GRAD_TOL and w["attn_worst"] <= FAMILY_GRAD_TOL,
              f"{tag}: the kernels' gradient differs from the plain attention's: {w}")
        out["witness"] = wit
    out["launches"] = (flash_attention.launches_fwd - f0, flash_attention.launches_bwd - b0)
    if cfg.mla is not None:  # every flash call of the checks at the unpadded values
        moved = {k: {c: n[c] - by_inst0.get(k, {}).get(c, 0) for c in n}
                 for k, n in flash_attention.launches_by_instance.items()
                 if n != by_inst0.get(k)}
        want = {mla_instance(cfg): {"fwd": out["launches"][0], "bwd": out["launches"][1]}}
        print(f"{tag} gradient checks: flash launches by instance {moved}")
        check(moved == want, f"{tag}: gradient checks' flash launches {moved}, wanted {want}")
    del g_none, r_none
    return out


def family_train(dev, arch: str, layers: int) -> dict:
    """One family at full width cut to ``layers`` layers, bf16, B 1 x S
    2048: the gradient checks (``family_checks``), then one warm-up and
    three timed train steps through ``build_train_step`` (remat none, AdamW
    with its large leaves updated in slices): loss, grad norm, lr, step ms,
    tokens/s, peak memory, the flash launches of each step (one forward and
    one backward a layer, every one ``wgmma``) and, for MoE, the routed
    (token, k) pairs capacity dropped.  The attention projections are drawn
    at their true fan-in (``at_true_fan_in``; the expert, router and shared
    leaves are drawn at it already)."""
    from repro_torch.configs import ShapeCell, get_config
    from repro_torch.kernels.flash_attention import flash_attention, reset_launches
    from repro_torch.models import moe, transformer
    from repro_torch.models.layers import init_params
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import build_train_step, make_train_state

    full = get_config(arch)
    cfg = dataclasses.replace(full, n_layers=layers)
    B, S = 1, FAMILY_TRAIN_SEQ
    tag = f"{arch} train"
    print(f"{tag}: reduced n_layers {full.n_layers} -> {layers} (the train state of more does "
          f"not fit one card); widths as published; attention projections at the true fan-in")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    pre = torch.cuda.memory_allocated(dev)  # what the process holds before the step's state
    params = at_true_fan_in(init_params(torch.Generator(device=dev).manual_seed(0),
                                        transformer.lm_specs(cfg), cfg.dtype, dev), cfg)
    n_par = param_bytes(params)[0]
    batches = [lm_batch(cfg.vocab, B, S, i, dev) for i in range(FAMILY_TRAIN_STEPS)]
    run = {"layers": layers, "params": n_par, "checks": family_checks(dev, cfg, params,
                                                                      batches[0], tag)}
    gc.collect()
    torch.cuda.empty_cache()
    state = make_train_state(params)
    del params
    step = build_train_step(cfg, ShapeCell("train", "train", {"seq_len": S, "global_batch": B}),
                            AdamWConfig(warmup_steps=10, total_steps=100), remat="none")
    drops: list[torch.Tensor] = []
    inner = moe.route
    retries = lambda: torch.cuda.memory_stats(dev).get("num_alloc_retries", 0)

    def counted(x, router, dims):
        out = inner(x, router, dims)
        drops.append((out[2] < 0).sum())
        return out

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)  # live at the reset: the state, the batches, pre
    reset_launches()
    rows = []
    moe.route = counted
    try:
        for i in range(FAMILY_TRAIN_STEPS):
            f0, b0 = flash_attention.launches_fwd, flash_attention.launches_bwd
            drops.clear()
            r0 = retries()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, batches[i])
            m = {k: float(v) for k, v in m.items()}  # waits for the device
            dt = time.perf_counter() - t0
            nf, nb = flash_attention.launches_fwd - f0, flash_attention.launches_bwd - b0
            tag_i = "warm-up" if i == 0 else f"step {i}"
            drop = ""
            if cfg.moe is not None:
                routed = layers * B * S * cfg.moe.top_k
                n_drop = int(torch.stack(drops).sum())
                drop = f" dropped {n_drop} of {routed} routed pairs ({n_drop / routed:.6f})"
                m["drop_share"] = n_drop / routed
            print(f"{tag} {tag_i}: loss {m['loss']:.6f} grad_norm {m['grad_norm']:.6f} lr "
                  f"{m['lr']:.6e} step_ms {dt * 1e3:.3f} tokens_per_s {B * S / dt:.1f} "
                  f"max_memory_allocated {torch.cuda.max_memory_allocated(dev)} allocator "
                  f"retries {retries() - r0} flash_fwd {nf} flash_bwd {nb}{drop}")
            check(all(math.isfinite(v) for v in m.values()), f"{tag} {tag_i}: non-finite {m}")
            check(nf == layers and nb == layers,
                  f"{tag} {tag_i}: {nf} forward / {nb} backward flash calls for {layers} layers")
            rows.append(dict(step_s=dt, **m))
    finally:
        moe.route = inner
    launches = (flash_attention.launches_fwd, flash_attention.launches_bwd)
    by_var = flash_attention.launches_by_variant
    check(by_var["wgmma"] == {"fwd": launches[0], "bwd": launches[1]},
          f"{tag}: not every flash call ran the wgmma kernels: {by_var}")
    if cfg.mla is not None:  # every step's flash call at the unpadded values
        by_inst = flash_attention.launches_by_instance
        print(f"{tag}: flash launches by instance {by_inst}")
        check(by_inst == {mla_instance(cfg): {"fwd": launches[0], "bwd": launches[1]}},
              f"{tag}: flash launches by instance {by_inst}, wanted every one "
              f"{mla_instance(cfg)}")
    mem = torch.cuda.max_memory_allocated(dev)
    mean_s = sum(r["step_s"] for r in rows[1:]) / (len(rows) - 1)
    print(f"{tag}: {layers} of {full.n_layers} layers, {n_par} parameters, B {B} S {S} bf16 "
          f"remat none: mean step_ms {mean_s * 1e3:.3f} tokens_per_s {B * S / mean_s:.1f} "
          f"max_memory_allocated {mem} flash launches fwd {launches[0]} bwd {launches[1]}")
    del state
    gc.collect()
    torch.cuda.empty_cache()
    run.update(rows=rows, mean_step_s=mean_s, tokens_per_s=B * S / mean_s, max_memory=mem,
               base_memory=base, pre_memory=pre, launches=launches, full_layers=full.n_layers)
    return run


def family_smoke_parity(dev, arch: str) -> dict:
    """FAMILY_SMOKE_STEPS fp32 train steps of ``arch``'s smoke config on the
    card (tf32x3 flash kernels) and on the CPU from the same parameters and
    numpy batches: losses within 1e-4, the final parameters within 1e-4, and
    ``moe.route``'s expert ids and slots equal on both devices at every step."""
    from repro_torch.configs import ShapeCell, get_config
    from repro_torch.data import make_batch
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import moe
    from repro_torch.models.layers import init_params
    from repro_torch.models.transformer import lm_specs
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import build_train_step, make_train_state

    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype=torch.float32)
    cell = ShapeCell("t", "train", {"seq_len": 64, "global_batch": 4})
    cpu_params = init_params(torch.Generator().manual_seed(0), lm_specs(cfg), cfg.dtype, "cpu")
    states = {"card": make_train_state(to_device(cpu_params, dev)),
              "cpu": make_train_state(cpu_params)}
    opt = AdamWConfig(warmup_steps=2, total_steps=5)
    steps = {k: build_train_step(cfg, cell, opt) for k in states}
    inner = moe.route
    routes: dict[str, list] = {"card": [], "cpu": []}

    def recorded(where):
        def route(x, router, dims):
            out = inner(x, router, dims)
            routes[where].append([t.detach().cpu() for t in out[1:]])
            return out
        return route

    f0, b0 = flash_attention.launches_fwd, flash_attention.launches_bwd
    worst_loss = 0.0
    try:
        for s in range(FAMILY_SMOKE_STEPS):
            m = {}
            for where, d in (("card", dev), ("cpu", "cpu")):
                moe.route = recorded(where)
                states[where], m[where] = steps[where](states[where],
                                                       make_batch(cfg, cell, seed=s, device=d))
            la, lb = float(m["card"]["loss"]), float(m["cpu"]["loss"])
            worst_loss = max(worst_loss, abs(la - lb) / (1e-4 + 1e-4 * abs(lb)))
            check(abs(la - lb) <= 1e-4 + 1e-4 * abs(lb),
                  f"{cfg.name} train parity step {s + 1}: loss {la} on the card, {lb} on the CPU")
    finally:
        moe.route = inner
    worst = 0.0
    for pa, pb in zip(leaves(states["card"]["params"]), leaves(states["cpu"]["params"])):
        worst = max(worst, ((pa.cpu() - pb).abs() / (1e-4 + 1e-4 * pb.abs())).max().item())
    n_moe = len(routes["card"])
    same = n_moe == len(routes["cpu"]) and all(
        torch.equal(x, y) for a, b in zip(routes["card"], routes["cpu"]) for x, y in zip(a, b))
    launches = (flash_attention.launches_fwd - f0, flash_attention.launches_bwd - b0)
    print(f"family train parity {cfg.name} fp32, {FAMILY_SMOKE_STEPS} steps card vs CPU: worst "
          f"loss err/(1e-4+1e-4*|cpu|) {worst_loss:.4f}; final params worst {worst:.4f}; MoE "
          f"calls {n_moe}, expert ids and slots equal on both devices {same}; flash launches "
          f"fwd {launches[0]} bwd {launches[1]}")
    check(worst <= 1.0, f"{cfg.name} train parity: final parameters differ (worst ratio {worst})")
    want_moe = cfg.n_layers * FAMILY_SMOKE_STEPS if cfg.moe is not None else 0
    check(n_moe == want_moe and same, f"{cfg.name} train parity: routing differs between devices")
    return {"launches": launches, "worst": worst, "worst_loss": worst_loss}


def phase_family_train(dev) -> dict:
    """deepseek-7b, qwen2-moe-a2.7b and deepseek-v2-236b trained at full
    width and cut depth (``family_train``), then their smoke configs card
    against CPU in fp32 (``family_smoke_parity``)."""
    from repro_torch.kernels.flash_attention import flash_attention

    out = {"train": {arch: family_train(dev, arch, layers) for arch, layers in FAMILY_TRAIN}}
    before = dict(flash_attention.launches_by_variant["tf32x3"])
    out["parity"] = {arch: family_smoke_parity(dev, arch) for arch, _ in FAMILY_TRAIN}
    after = flash_attention.launches_by_variant["tf32x3"]
    check(sum(p["launches"][0] for p in out["parity"].values()) == after["fwd"] - before["fwd"],
          "family train parity: not every fp32 flash call ran the tf32x3 kernels")
    return out


# --------------------------------------------------------------------------
# phase: embedding-bag kernel against its plain version
# --------------------------------------------------------------------------
BAG_SRC = "src/repro_torch/kernels/embedding_bag/csrc/embedding_bag.cu"
BAG_TPU = "src/repro/kernels/embedding_bag/kernel.py:70"
BAG_VARIANT = "tile_ring"  # tiles of bags, ids and rows staged by cp.async into a ring
# (label, arch whose full table is gathered, cell whose batch gives the ids,
#  lookup, combiner, weighted).  lookup: "fields" FM's stacked field ids, one
#  bag a sample; "linear" the same bags over FM's w_linear (width 1); "rows"
#  the model's rows() lookups at the cell, as bags of one; "candidates" the
#  candidate ids as bags of one; "history" SASRec's histories as bags; "long"
#  LONG_BAGS bags of LONG_IDS ids over a LONG_V x LONG_DIM table, each bag
#  longer than a stage
BAG_CASES = [
    ("fm serve_bulk bags", "fm", "serve_bulk", "fields", "sum", False),
    ("dcn-v2 bags of one", "dcn-v2", "serve_bulk", "rows", "sum", False),
    ("retrieval bags of one", "bst", "retrieval_cand", "candidates", "sum", False),
    ("sasrec-like mean", "sasrec", "serve_bulk", "history", "mean", True),
    ("smoke fm bags", "fm-smoke", "serve_p99", "fields", "sum", True),
    ("fm rows", "fm", "serve_bulk", "rows", "sum", False),
    ("fm linear bags", "fm", "serve_bulk", "linear", "sum", False),
    ("bst bags of one", "bst", "serve_bulk", "rows", "sum", False),
    ("sasrec bags of one", "sasrec", "serve_bulk", "rows", "sum", False),
    ("long bags", None, None, "long", "sum", False),
]
BAG_MAIN = "fm serve_bulk bags"  # FM's field sums at serve_bulk: the largest bag of the path
LONG_V, LONG_DIM, LONG_BAGS, LONG_IDS = 100_000, 128, 1024, 4096
SECTOR_BYTES = 32


def bag_inputs(arch: str | None, cell_name: str | None, lookup: str, dev):
    """(table spec (V, dim), ids [n_bags, bag] int32) as the model path
    makes them from ``make_batch`` (see BAG_CASES)."""
    if lookup == "long":
        gen = torch.Generator(device=dev).manual_seed(11)
        ids = torch.randint(0, LONG_V, (LONG_BAGS, LONG_IDS), generator=gen, device=dev,
                            dtype=torch.int32)
        return (LONG_V, LONG_DIM), ids
    from repro_torch.configs import get_config, get_shapes
    from repro_torch.data import make_batch
    from repro_torch.models.recsys import _stacked_ids

    smoke = arch.endswith("-smoke")
    name = arch[:-len("-smoke")] if smoke else arch
    cfg = get_config(name, smoke=smoke)
    cell = next(c for c in get_shapes(name) if c.name == cell_name)
    batch = make_batch(cfg, cell, seed=0, device=dev)
    V = sum(cfg.vocab_sizes) or cfg.item_vocab
    dim = 1 if lookup == "linear" else cfg.embed_dim
    if lookup in ("fields", "linear"):
        ids = _stacked_ids(cfg, batch["sparse_ids"])
    elif lookup == "candidates":
        ids = batch["candidate_ids"].reshape(-1, 1)
    elif lookup == "history":
        ids = batch["hist_ids"]
    elif name in ("fm", "dcn-v2"):  # rows(): the field rows
        ids = _stacked_ids(cfg, batch["sparse_ids"]).reshape(-1, 1)
    elif name == "bst":  # rows(): the history with the target appended
        ids = torch.cat([batch["hist_ids"], batch["target_id"][:, None]], dim=1).reshape(-1, 1)
    else:  # sasrec rows(): the history
        ids = batch["hist_ids"].reshape(-1, 1)
    return (V, dim), ids.to(torch.int32).contiguous()


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


def bag_sector_ms(ids, dim: int, itemsize: int, weighted: bool) -> float:
    """A diagnostic beside the bound: the bound's bytes with each distinct
    row rounded up to the whole 32-byte sectors it touches (a 40-byte row
    touches two or three)."""
    n_bags, _ = ids.shape
    row = dim * itemsize
    start = torch.unique(ids).long() * row
    sectors = ((start + row - 1) // SECTOR_BYTES - start // SECTOR_BYTES + 1).sum().item()
    nbytes = sectors * SECTOR_BYTES + ids.numel() * 4 * (2 if weighted else 1) + n_bags * row
    return nbytes / HBM_BYTES_PER_S * 1e3


def long_bag_ratio(got, table, ids, w, combiner: str, tol: float) -> tuple[float, float]:
    """(max abs err, worst err / allowed) of a sum over thousands of ids per
    bag, against the exact sum (fp64).  A j-ordered fp32 sum of 4,096 terms
    (the kernel's, bit for bit ``embedding_bag_seq_ref``) and torch's pairwise
    one differ by more than TOL, so the allowance is TOL (1 + |exact|) plus
    the bound on n sequential fp32 additions, gamma_n sum_j |w_j x_j| with
    gamma_n = n u / (1 - n u), u = 2^-24 (Higham, Accuracy and Stability of
    Numerical Algorithms, 4.2)."""
    from repro_torch.kernels.embedding_bag import embedding_bag_ref

    t64 = table.double()
    w64 = None if w is None else w.double()
    want = embedding_bag_ref(t64, ids, w64, combiner)
    mass = embedding_bag_ref(t64.abs(), ids, None if w is None else w64.abs(), combiner)
    nu = ids.shape[1] * 2.0**-24
    diff = (got.double() - want).abs()
    ratio = (diff / (tol * (1 + want.abs()) + nu / (1 - nu) * mass)).max().item()
    return diff.max().item(), ratio


def print_bag_ptxas() -> None:
    """ptxas's registers and spills for every embedding-bag instantiation as
    built; one that spills fails the run."""
    from repro_torch.kernels import build

    rows = build.ptxas_report("embedding_bag")
    for row in rows:
        print(f"ptxas {row['kernel']}: registers {row['registers']} spill stores "
              f"{row['spill_stores']} B loads {row['spill_loads']} B")
        check(row["spill_stores"] == row["spill_loads"] == 0,
              f"ptxas: {row['kernel']} spills {row['spill_stores']} B")
    check(len(rows) > 0, "ptxas: no report for the embedding-bag library")


def phase_bag(dev) -> dict:
    """Every BAG_CASES case in fp32 and bf16: the kernel against its plain
    versions (bit for bit against ``embedding_bag_seq_ref``, the kernel's
    arithmetic; within TOL of ``embedding_bag_ref``), then its times and
    plan beside the bound, the plain version and the library call
    (``F.embedding`` for bags of one, ``F.embedding_bag`` for other bags but
    weighted means and bf16 weighted sums, which no single call computes on
    fp32 weights)."""
    from repro_torch.kernels.embedding_bag import (
        embedding_bag,
        embedding_bag_ref,
        embedding_bag_seq_ref,
    )
    from repro_torch.kernels.embedding_bag import ops as bag_ops

    print_bag_ptxas()
    F = torch.nn.functional
    results = {}
    gen = torch.Generator(device=dev).manual_seed(77)
    for label, arch, cell_name, lookup, combiner, weighted in BAG_CASES:
        (V, dim), ids = bag_inputs(arch, cell_name, lookup, dev)
        n_bags, bag = ids.shape
        table32 = torch.randn(V, dim, generator=gen, device=dev)
        w = torch.rand(n_bags, bag, generator=gen, device=dev) if weighted else None
        iters = 10 if ids.numel() > 10**6 else 50
        for dtype in (torch.float32, torch.bfloat16):
            tname = str(dtype).replace("torch.", "")
            table = table32 if dtype == torch.float32 else table32.to(dtype)
            got = embedding_bag(table, ids, w, combiner=combiner)
            want = embedding_bag_ref(table.float(), ids, w, combiner)  # fp32, same values
            exact = embedding_bag_seq_ref(table, ids, w, combiner)
            same = bool(((got == exact) | (got.isnan() & exact.isnan())).all())
            bits = "equal" if same else "DIFFER"
            check(same, f"embedding_bag {label} {tname}: differs from embedding_bag_seq_ref")
            del exact
            torch.cuda.synchronize()
            tol = TOL[dtype]
            if lookup == "long":
                err, ratio = long_bag_ratio(got, table, ids, w, combiner, tol)
            else:
                err, ratio = assert_close_ratio(got, want, tol)
            print(f"bag check {label:22s} {tname:8s} bags {n_bags} x {bag} dim {dim} V {V} "
                  f"bits vs seq_ref {bits} max_abs_err {err:.3e} tol atol=rtol={tol:.0e} "
                  f"worst ratio {ratio:.3f}")
            check(math.isfinite(err) and ratio <= 1.0,
                  f"embedding_bag {label} {tname}: max_abs_err {err}, worst ratio {ratio}")
            del got, want
            run = lambda: embedding_bag(table, ids, w, combiner=combiner)
            dms, sms = kernel_device_ms(run, iters=min(iters, 10))
            row = dict(ms=cuda_ms(run, iters=iters, warmup=2), device_ms=dms, span_ms=sms,
                       queued_ms=queued_ms(run), flushed_ms=flushed_ms(run),
                       plain_ms=cuda_ms(lambda: embedding_bag_ref(table, ids, w, combiner),
                                        iters=min(iters, 10), warmup=1),
                       library_ms=None, max_abs_err=err, bits=bits)
            if bag == 1 and not weighted:  # a bag of one is a row: F.embedding
                flat = ids[:, 0]
                row["library_ms"] = cuda_ms(lambda: F.embedding(flat, table), iters=iters,
                                            warmup=2)
            elif not weighted or (combiner == "sum" and dtype == torch.float32):
                # it weighs only sums, by weights of the table's type (fp32 here)
                row["library_ms"] = cuda_ms(
                    lambda: F.embedding_bag(ids, table, mode=combiner, per_sample_weights=w),
                    iters=iters, warmup=2)
            row["bound_ms"], row["bound_by"] = bag_bound_ms(ids, dim, table.element_size(),
                                                            weighted)
            row["sector_ms"] = bag_sector_ms(ids, dim, table.element_size(), weighted)
            out = torch.empty(n_bags, dim, dtype=dtype, device=dev)
            vec = bag_ops.build.vector_width(dim, table.element_size(), table, out)
            p = bag_ops.plan(n_bags, bag, dim, dtype, vec, weighted=weighted,
                             sms=bag_ops._sms(dev))
            row["plan"] = {"tile_bags": p.tile_bags, "chunk_ids": p.chunk_ids,
                           "chunks": p.chunks, "copy_bytes": p.copy_bytes, "one": p.one,
                           "wide": p.wide, "grid": p.grid, "smem_bytes": p.smem_bytes}
            del out
            lib = f"{row['library_ms']:.6f}" if row["library_ms"] is not None else "n/a"
            print(f"bag time  {label:22s} {tname:8s} ms {row['ms']:.6f} device_ms "
                  f"{row['device_ms']:.6f} device_span_ms {row['span_ms']:.6f} queued_ms "
                  f"{row['queued_ms']:.6f} l2_flushed_ms {row['flushed_ms']:.6f} "
                  f"plain_ms {row['plain_ms']:.6f} library_ms {lib} "
                  f"bound_ms {row['bound_ms']:.6f} ({row['bound_by']}) sector_ms "
                  f"{row['sector_ms']:.6f} plan tb {p.tile_bags} ic {p.chunk_ids} k "
                  f"{p.chunks} copy {p.copy_bytes} B grid {p.grid} smem {p.smem_bytes}")
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
BAG_PROFILED = ("fm", "serve_bulk")  # the call profiled by kernel for the bag's share


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
            if name == "serve_p99" or (arch, name) == BAG_PROFILED:
                # serve_p99 for each model; FM's serve_bulk by kernel, the bag's share.
                # The record says whether the profile saw every bag kernel the
                # call launches.
                prof = profile_call(f"recsys {arch} {name}", lambda: fn(params, **batch),
                                    n_kernels=5 if name == "serve_p99" else 12,
                                    watch=("embedding_bag_kernel",), warm=True)
                seen = prof.get("watch", {}).get("embedding_bag_kernel", {}).get("kernels", 0)
                prof["complete"] = seen == per_call
                print(f"profile recsys {arch} {name}: saw {seen} of the call's {per_call} "
                      "bag kernels")
                rows[(arch, name)]["profile"] = prof
            rows[(arch, name)]["launches"] = embedding_bag.launches - before
            del batch
        del params
        torch.cuda.empty_cache()
    launches = embedding_bag.launches
    print(f"recsys: embedding_bag launches {launches}")
    check(launches > 0, "recsys serving never launched the embedding-bag kernel")
    before = embedding_bag.launches
    recsys_parity(dev)
    return {"launches": launches, "rows": rows,
            "parity_launches": embedding_bag.launches - before}


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
# phase: the embedding-bag backward kernel against its plain versions
# --------------------------------------------------------------------------
BAG_BWD_NOTE = ("no Pallas backward: the reference differentiates its lookups by XLA's "
                "transpose of jnp.take (src/repro/models/recsys.py:57)")
# the train path's three shapes at train_batch (B 65,536), as BAG_CASES: FM's
# field sums, DCN-v2's bags of one and SASRec's history as bags of one
BAG_BWD_TRAIN = [
    ("fm train bags", "fm", "train_batch", "fields", "sum", False),
    ("dcn-v2 train bags of one", "dcn-v2", "train_batch", "rows", "sum", False),
    ("sasrec train history", "sasrec", "train_batch", "rows", "sum", False),
]
BAG_BWD_MAIN = "fm train bags"
# a hub: HUB_IDS of HUB_BAGS x 4 positions read one row of a HUB_V x 10
# table, so its run spans HUB_IDS / 256 chunks of the kernel's walk
HUB_V, HUB_BAGS, HUB_IDS = 1_000_000, 262_144, 400_000
BAG_BWD_HUB = ("hub over many chunks", None, None, "hub", "sum", True)
BAG_BWD_FORBIDDEN = ("indexing_backward", "index_put", "indexFunc", "embedding_backward",
                     "compute_grad_weight", "sum_and_scatter")  # a plain table gradient


def bwd_inputs(case, dev, gen):
    """(V, dim, ids, weights or None, dout fp32) for a BAG_CASES-shaped case."""
    label, arch, cell_name, lookup, combiner, weighted = case
    if lookup == "hub":
        V, dim = HUB_V, 10
        ids = torch.randint(0, V, (HUB_BAGS, 4), generator=gen, device=dev, dtype=torch.int32)
        at = torch.randperm(ids.numel(), generator=gen, device=dev)[:HUB_IDS]
        ids.view(-1)[at] = 4321
    else:
        (V, dim), ids = bag_inputs(arch, cell_name, lookup, dev)
    n_bags, bag = ids.shape
    w = torch.rand(n_bags, bag, generator=gen, device=dev) if weighted else None
    return V, dim, ids, w, torch.randn(n_bags, dim, generator=gen, device=dev)


def bwd_check(V, ids, w, dout, combiner, got, tol) -> tuple[float, float]:
    """(max abs err, worst err / allowed) against the fp64 gradient:
    allowed = tol (1 + |exact|) + gamma_n sum |w x| for a row of n
    positions, gamma_n = n u / (1 - n u), u = 2^-24 (the bound on n
    sequential fp32 additions, Higham 4.2; the kernel's chunked sum is
    within it)."""
    from repro_torch.kernels.embedding_bag import embedding_bag_bwd_ref

    w64 = None if w is None else w.double()
    exact = embedding_bag_bwd_ref(V, ids, w64, dout.double(), combiner)
    mass = embedding_bag_bwd_ref(V, ids, None if w is None else w64.abs(), dout.double().abs(),
                                 combiner)
    rows = torch.where(ids < 0, ids + V, ids).long().view(-1)
    nu = torch.bincount(rows[(rows >= 0) & (rows < V)], minlength=V).double()[:, None] * 2.0**-24
    diff = (got.double() - exact).abs()
    ratio = (diff / (tol * (1 + exact.abs()) + nu / (1 - nu) * mass)).max().item()
    return diff.max().item(), ratio


def bwd_bound_ms(V, ids, dim: int, itemsize: int, weighted: bool) -> tuple[float, str, float]:
    """(least time, what bounds it, the zero fill's least time).  Bytes: the
    ids (and weights) read once, each bag's dout row read once, each row an
    id reads written once; operations: one add (and a multiply, weighted)
    per position and element at the fp32 rate.  The dense zero fill of
    dtable (V x dim written) is its own line."""
    n_bags, _ = ids.shape
    rows = torch.where(ids < 0, ids + V, ids)
    touched = torch.unique(rows[(rows >= 0) & (rows < V)]).numel()
    nbytes = ids.numel() * 4 * (2 if weighted else 1) + n_bags * dim * itemsize
    nbytes += touched * dim * itemsize
    ops = (2 if weighted else 1) * ids.numel() * dim
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[torch.float32] * 1e3
    fill = V * dim * itemsize / HBM_BYTES_PER_S * 1e3
    return (t_bytes, "bytes", fill) if t_bytes >= t_ops else (t_ops, "operations", fill)


def bwd_times(V, dim, ids, w, dout, combiner, bag_ops) -> dict:
    """The backward's times: the kernel alone on a built index, back to back
    and queued behind a device sleep; the whole call (reverse index, zero
    fill, kernel) the same ways and with the L2 evicted; the index and the
    fill alone; autograd of ``embedding_bag_ref`` (plain); the backward
    alone of ``F.embedding`` (bags of one) or ``F.embedding_bag`` (sum),
    the yardstick."""
    from repro_torch.kernels.embedding_bag import bwd_index, embedding_bag_ref

    F = torch.nn.functional
    n_bags, bag = ids.shape
    call = lambda: bag_ops.embedding_bag_bwd(V, ids, w, dout, combiner)
    key, pos = bwd_index(ids, V)
    dtable = torch.zeros(V, dim, dtype=dout.dtype, device=dout.device)
    tickets = torch.zeros(-(-ids.numel() // bag_ops.bwd_chunk(dim)), dtype=torch.int32,
                          device=dout.device)
    kernel = lambda: bag_ops.launch_bwd(key, pos, dout, w, combiner, bag, dtable, tickets)
    row = dict(ms=cuda_ms(kernel, iters=10, warmup=2), queued_ms=queued_ms(kernel),
               call_ms=cuda_ms(call, iters=10, warmup=2), call_queued_ms=queued_ms(call),
               call_flushed_ms=flushed_ms(call),
               index_ms=queued_ms(lambda: bwd_index(ids, V)),
               fill_ms=queued_ms(lambda: torch.zeros(V, dim, dtype=dout.dtype,
                                                     device=dout.device)))
    del dtable, key, pos
    table = torch.zeros(V, dim, dtype=dout.dtype, device=dout.device, requires_grad=True)
    out = embedding_bag_ref(table, ids, w, combiner)
    row["plain_ms"] = cuda_ms(lambda: torch.autograd.grad(out, table, dout, retain_graph=True),
                              iters=5, warmup=1)
    del out
    row["library_ms"] = None
    if bag == 1 and w is None:
        out = F.embedding(ids[:, 0], table)
    elif w is None or (combiner == "sum" and dout.dtype == torch.float32):
        out = F.embedding_bag(ids, table, mode=combiner, per_sample_weights=w)
    else:
        out = None
    if out is not None:
        row["library_ms"] = cuda_ms(
            lambda: torch.autograd.grad(out, table, dout, retain_graph=True), iters=5, warmup=1)
    del out, table
    return row


def phase_bag_bwd(dev) -> dict:
    """The backward kernel at every BAG_CASES case, the train path's three
    shapes and a hub over many chunks, fp32 and bf16: bit for bit against
    ``embedding_bag_bwd_seq_ref`` (the kernel's arithmetic), the same bits
    on a second call, and within TOL plus the bound of a sequential fp32
    sum of the fp64 gradient; then, at the train shapes, its times beside
    the bound, the plain version and the library call."""
    from repro_torch.kernels.embedding_bag import embedding_bag_bwd_seq_ref
    from repro_torch.kernels.embedding_bag import ops as bag_ops

    gen = torch.Generator(device=dev).manual_seed(78)
    results = {}
    for case in BAG_CASES + BAG_BWD_TRAIN + [BAG_BWD_HUB]:
        label, combiner, weighted = case[0], case[4], case[5]
        V, dim, ids, w, dout32 = bwd_inputs(case, dev, gen)
        n_bags, bag = ids.shape
        timed = case in BAG_BWD_TRAIN
        for dtype in (torch.float32, torch.bfloat16):
            tname = str(dtype).replace("torch.", "")
            dout = dout32.to(dtype)
            before = bag_ops.embedding_bag.launches_bwd
            got = bag_ops.embedding_bag_bwd(V, ids, w, dout, combiner)
            again = bag_ops.embedding_bag_bwd(V, ids, w, dout, combiner)
            check(bag_ops.embedding_bag.launches_bwd == before + 2,
                  f"embedding_bag_bwd {label} {tname}: not one launch a call")
            same = bool(torch.equal(got, again))
            del again
            exact = embedding_bag_bwd_seq_ref(V, ids, w, dout, combiner)
            bits = bool(torch.equal(got, exact))
            del exact
            err, ratio = bwd_check(V, ids, w, dout, combiner, got, TOL[dtype])
            chunks = -(-ids.numel() // bag_ops.bwd_chunk(dim))
            print(f"bag bwd check {label:24s} {tname:8s} bags {n_bags} x {bag} dim {dim} V {V} "
                  f"chunks {chunks} bits vs seq_ref {'equal' if bits else 'DIFFER'} rerun "
                  f"{'equal' if same else 'DIFFER'} max_abs_err {err:.3e} vs fp64 (tol "
                  f"{TOL[dtype]:.0e} + sequential-sum bound) worst ratio {ratio:.3f}")
            check(bits, f"embedding_bag_bwd {label} {tname}: differs from the seq_ref")
            check(same, f"embedding_bag_bwd {label} {tname}: two calls differ")
            check(math.isfinite(err) and ratio <= 1.0,
                  f"embedding_bag_bwd {label} {tname}: max_abs_err {err}, worst ratio {ratio}")
            del got
            row = {"max_abs_err": err, "bits": bits}
            if timed:
                row.update(bwd_times(V, dim, ids, w, dout, combiner, bag_ops))
                row["bound_ms"], row["bound_by"], row["fill_bound_ms"] = bwd_bound_ms(
                    V, ids, dim, dout.element_size(), w is not None)
                lib = f"{row['library_ms']:.6f}" if row["library_ms"] is not None else "n/a"
                print(f"bag bwd time  {label:24s} {tname:8s} kernel ms {row['ms']:.6f} "
                      f"queued_ms {row['queued_ms']:.6f} bound_ms {row['bound_ms']:.6f} "
                      f"({row['bound_by']}); call (index + zero fill + kernel) ms "
                      f"{row['call_ms']:.6f} queued_ms {row['call_queued_ms']:.6f} "
                      f"l2_flushed_ms {row['call_flushed_ms']:.6f}; index_ms "
                      f"{row['index_ms']:.6f} fill_ms {row['fill_ms']:.6f} fill_bound_ms "
                      f"{row['fill_bound_ms']:.6f}; plain_ms {row['plain_ms']:.6f} "
                      f"library_ms {lib}")
            results[(label, tname)] = row
            torch.cuda.empty_cache()
        del ids, w, dout32
        torch.cuda.empty_cache()
    return {"cases": results}


# --------------------------------------------------------------------------
# phase: full-width recsys training
# --------------------------------------------------------------------------
# embedding-bag launches a train step makes (forward = backward): FM its
# rows() bags of one, its linear term and its field sums; DCN-v2 and BST one
# rows() lookup; SASRec the history, the positives and the negatives
TRAIN_BAGS = {"fm": 3, "dcn-v2": 1, "bst": 1, "sasrec": 3}
TRAIN_STEPS = 3  # one warm-up, two timed


def step_grads(loss_fn, params, batch) -> list:
    """Every leaf's gradient of one step's loss at ``params``, as the train
    step takes it (zeros for a leaf the loss does not read)."""
    from repro_torch.tree import unflatten

    req = [t.detach().requires_grad_(True) for t in leaves(params)]
    loss, _ = loss_fn(unflatten(params, req), batch)
    grads = torch.autograd.grad(loss, req, allow_unused=True)
    return [torch.zeros_like(t) if g is None else g for t, g in zip(req, grads)]


def phase_recsys_train(dev) -> dict:
    """FM, DCN-v2, BST and SASRec at full width in fp32 through
    ``build_train_step`` at ``train_batch`` (B 65,536): one step's gradients
    twice from the same state (equal bits), then TRAIN_STEPS steps (finite
    metrics, TRAIN_BAGS forward and backward bag launches each, step time
    by CUDA events, peak memory) and one profiled step (no kernel of a plain
    table gradient); the wrapper's plain path is watched and must never run
    on the card.  Then the smoke models' train parity, card vs CPU."""
    from repro_torch.configs import get_config, get_shapes
    from repro_torch.data import make_batch
    from repro_torch.kernels.embedding_bag import embedding_bag, reset_launches
    from repro_torch.kernels.embedding_bag import ops as bag_ops
    from repro_torch.models.layers import init_params
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import (build_loss_fn, build_param_specs, build_train_step,
                                   make_train_state)

    plain = bag_ops.embedding_bag_ref
    plain_on_card = [0]

    def watched_plain(table, *args, **kwargs):  # the wrapper's plain path, watched
        if table.device.type != "cpu":
            plain_on_card[0] += 1
        return plain(table, *args, **kwargs)

    bag_ops.embedding_bag_ref = watched_plain
    rows = {}
    try:
        for arch in RECSYS:
            cfg = get_config(arch)  # full width, fp32 (the reference's dtype)
            cell = next(c for c in get_shapes(arch) if c.name == "train_batch")
            B = cell.params["batch"]
            gen = torch.Generator(device=dev).manual_seed(0)
            params = init_params(gen, build_param_specs(cfg, cell), cfg.dtype, dev)
            batches = [make_batch(cfg, cell, seed=i, device=dev) for i in range(TRAIN_STEPS)]
            loss_fn = build_loss_fn(cfg, cell)
            g1 = step_grads(loss_fn, params, batches[0])
            g2 = step_grads(loss_fn, params, batches[0])
            differ = [i for i, (a, b) in enumerate(zip(g1, g2)) if not torch.equal(a, b)]
            del g1, g2
            print(f"recsys train {arch}: one step's gradients twice from the same state: "
                  f"{'equal bit for bit' if not differ else f'leaves {differ} DIFFER'}")
            check(not differ, f"recsys train {arch}: gradients of leaves {differ} differ")
            state = make_train_state(params)
            step = build_train_step(cfg, cell, AdamWConfig(warmup_steps=10, total_steps=100))
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
            reset_launches()
            steps = []
            for i in range(TRAIN_STEPS):
                f0, b0 = embedding_bag.launches, embedding_bag.launches_bwd
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                start.record()
                state, m = step(state, batches[i])
                end.record()
                m = {k: float(v) for k, v in m.items()}  # waits for the device
                wall = time.perf_counter() - t0
                ms = start.elapsed_time(end)
                nf, nb = embedding_bag.launches - f0, embedding_bag.launches_bwd - b0
                tag = "warm-up" if i == 0 else f"step {i}"
                print(f"recsys train {arch} {tag}: loss {m['loss']:.6f} grad_norm "
                      f"{m['grad_norm']:.6f} step_ms {ms:.3f} (host wall {wall * 1e3:.3f}) "
                      f"samples_per_s {B / ms * 1e3:.1f} bag_fwd {nf} bag_bwd {nb}")
                check(all(math.isfinite(v) for v in m.values()),
                      f"recsys train {arch} {tag}: non-finite {m}")
                check(nf == nb == TRAIN_BAGS[arch],
                      f"recsys train {arch} {tag}: {nf} forward / {nb} backward bag launches, "
                      f"wanted {TRAIN_BAGS[arch]}")
                steps.append(dict(step_ms=ms, wall_ms=wall * 1e3, **m))
            launches = (embedding_bag.launches, embedding_bag.launches_bwd)
            mem = torch.cuda.max_memory_allocated(dev)
            n_bytes = sum(t.numel() * t.element_size() for t in leaves(state["params"]))
            mean_ms = sum(r["step_ms"] for r in steps[1:]) / (TRAIN_STEPS - 1)
            print(f"recsys train {arch}: train_batch B {B} fp32: mean step_ms {mean_ms:.3f} "
                  f"samples_per_s {B / mean_ms * 1e3:.1f} params bytes {n_bytes} "
                  f"max_memory_allocated {mem}; bag launches fwd {launches[0]} bwd {launches[1]}")

            def one_more():
                nonlocal state
                state, m = step(state, batches[0])
                check(math.isfinite(float(m["loss"])), f"profiled {arch} step: non-finite loss")

            prof = profile_call(f"recsys train {arch} step", one_more, n_kernels=8,
                                watch=("embedding_bag_bwd_kernel",) + BAG_BWD_FORBIDDEN)
            seen = prof.get("watch", {})
            plain_kernels = sum(seen.get(w, {}).get("kernels", 0) for w in BAG_BWD_FORBIDDEN)
            check(plain_kernels == 0, f"recsys train {arch}: {plain_kernels} kernels of a plain "
                                      "table gradient in the profiled step")
            rows[arch] = dict(steps=steps, mean_step_ms=mean_ms, max_memory=mem,
                              params_bytes=n_bytes, launches=launches, profile=prof)
            del state, params, batches, step
            gc.collect()
            torch.cuda.empty_cache()
        check(plain_on_card[0] == 0,
              f"recsys train: the plain embedding bag ran {plain_on_card[0]} times on the card")
        parity = recsys_train_parity(dev)
    finally:
        bag_ops.embedding_bag_ref = plain
    return {"rows": rows, "parity_launches": parity}


def recsys_train_parity(dev) -> tuple[int, int]:
    """Five fp32 AdamW steps of each smoke model at B 1,024 on the card
    (kernels) and on the CPU (plain path), from the same parameters: loss
    and parameters within 1e-4 + 1e-4 |cpu|, as the GatedGCN parity holds
    them.  Returns the card's (forward, backward) bag launches."""
    import dataclasses as dc

    from repro_torch.configs import get_config, get_shapes
    from repro_torch.data import make_batch
    from repro_torch.kernels.embedding_bag import embedding_bag
    from repro_torch.models.layers import init_params
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import build_param_specs, build_train_step, make_train_state

    before = embedding_bag.launches, embedding_bag.launches_bwd
    opt = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=5)
    for arch in RECSYS:
        cfg = get_config(arch, smoke=True)  # fp32
        cell = next(c for c in get_shapes(arch) if c.name == "train_batch")
        cell = dc.replace(cell, params=dict(cell.params, batch=1024))
        cpu_params = init_params(torch.Generator().manual_seed(0), build_param_specs(cfg, cell),
                                 cfg.dtype, "cpu")
        dev_state = make_train_state(to_device(cpu_params, dev))
        cpu_state = make_train_state(cpu_params)
        step = build_train_step(cfg, cell, opt)
        for s in range(5):
            batch = make_batch(cfg, cell, seed=20 + s, device="cpu")
            dev_state, a = step(dev_state, to_device(batch, dev))
            cpu_state, b = step(cpu_state, batch)
            la, lb = float(a["loss"]), float(b["loss"])
            check(abs(la - lb) <= 1e-4 + 1e-4 * abs(lb),
                  f"recsys train parity {arch} step {s + 1}: loss {la} on the card, {lb} on the "
                  "CPU")
        worst = 0.0
        for pa, pb in zip(leaves(dev_state["params"]), leaves(cpu_state["params"])):
            diff = (pa.cpu() - pb).abs()
            worst = max(worst, (diff / (1e-4 + 1e-4 * pb.abs())).max().item())
        print(f"recsys train parity {arch}: 5 steps, last loss card {la:.7f} cpu {lb:.7f}; "
              f"final params worst err/(1e-4+1e-4*|cpu|) {worst:.4f}")
        check(worst <= 1.0, f"recsys train parity {arch}: parameters differ (worst {worst})")
    launched = (embedding_bag.launches - before[0], embedding_bag.launches_bwd - before[1])
    check(min(launched) > 0, "recsys train parity: the card never launched the bag kernels")
    return launched


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


def row_blocks(idx, blocks: int) -> list[tuple[int, int, int, int]]:
    """(first row, end row, first slot, end slot) of ``blocks`` blocks of
    whole rows of a CSR index, each about as many slots, none empty."""
    N, E = idx.row_ptr.numel() - 1, idx.col.numel()
    ends = torch.searchsorted(idx.row_ptr, torch.linspace(0, E, blocks + 1, device=idx.col.device)
                              .long().int()).tolist()
    ends[0], ends[-1] = 0, N
    slots = idx.row_ptr[ends].tolist()
    return [(r0, r1, a, b) for r0, r1, a, b in zip(ends, ends[1:], slots, slots[1:]) if r1 > r0]


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
    # the plain fp32 num in blocks of rows of about 2^23 slots: its [slots,
    # dim] temporaries of a graph of 6e7 slots would not fit beside the rest
    err = norm_ratio = elem_ratio = 0.0
    for r0, r1, a, b in row_blocks(idx, -(-E // (1 << 23))):
        plain, _ = gnn_aggregate_csr_ref(h, idx.row_ptr[r0:r1 + 1] - a, idx.col[a:b],
                                         gates[a:b], False)
        diff = (plain.double() - num[r0:r1]).abs()
        err = max(err, diff.max().item())
        norm_ratio = max(norm_ratio, (diff / (tol * (1 + num_s[r0:r1]))).max().item())
        elem_ratio = max(elem_ratio, (diff / (tol * (1 + num[r0:r1].abs()))).max().item())
        del plain, diff
    print(f"agg check {label:20s} {tname:8s} plain fp32 num against fp64: max_abs_err "
          f"{err:.3e} worst err/(tol*(1+sum|terms|)) {norm_ratio:.3f}; elementwise rule "
          f"{elem_ratio:.3f}")
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
    pre = torch.cuda.memory_allocated(dev)  # what the process holds before the step's state
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
    base = torch.cuda.memory_allocated(dev)  # the state, feats, labels, the batches, pre
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
            "mean_step_s": mean_s, "max_memory": mem, "base_memory": base, "pre_memory": pre,
            "profile": prof, "index_ms": index_ms}


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


# --------------------------------------------------------------------------
# phase: the GatedGCN cells molecule and ogb_products, and the aggregation
# kernel at ogb_products' full size
# --------------------------------------------------------------------------
FIT_BYTES = 75 * 10**9  # a cut's reckoned peak stays under this (tools/family_depth.py's)
OGB_NODES, OGB_EDGES = 2_449_029, 61_859_140  # ogb_products as published
OGB_STEPS = 3  # one warm-up, two timed
MOLECULE_STEPS = 4  # one warm-up, three timed
OGB_AGG_ITERS = 3
OGB_AGG_BLOCKS = 8  # row blocks of the plain version's check at the full size


def first_step_parity(dev, cfg, cell, cpu_params, batch) -> dict:
    """The loss and every gradient leaf of one step at ``cpu_params`` on the
    card (kernels) and on the CPU (plain path), each leaf held within 1e-4
    of its largest value (the loss within 1e-4 of itself)."""
    from repro_torch.kernels.gnn_aggregate import gnn_aggregate
    from repro_torch.train import build_loss_fn
    from repro_torch.tree import unflatten

    loss_fn = build_loss_fn(cfg, cell)

    def grads(params, b):
        req = [t.detach().requires_grad_(True) for t in leaves(params)]
        loss, _ = loss_fn(unflatten(params, req), b)
        return float(loss.detach()), torch.autograd.grad(loss, req)

    f0, b0 = gnn_aggregate.launches_fwd, gnn_aggregate.launches_bwd
    la, ga = grads(to_device(cpu_params, dev), to_device(batch, dev))
    launched = (gnn_aggregate.launches_fwd - f0, gnn_aggregate.launches_bwd - b0)
    lb, gb = grads(cpu_params, batch)
    worst = abs(la - lb) / (1e-4 * max(abs(lb), 1e-3))
    for a, b in zip(ga, gb):
        worst = max(worst, ((a.cpu() - b).abs().max() / (1e-4 * max(b.abs().max(), 1e-3))).item())
    print(f"gnn {cell.name} first step card vs CPU (fp32): loss {la:.7f} / {lb:.7f}; worst "
          f"|card - cpu| / (1e-4 * the leaf's largest |value|) {worst:.4f} over {len(gb)} "
          f"gradient leaves and the loss; aggregation launches fwd {launched[0]} bwd "
          f"{launched[1]}")
    check(worst <= 1.0, f"gnn {cell.name}: the card's first step differs from the CPU's "
                        f"(worst ratio {worst})")
    check(launched == (cfg.n_layers, cfg.n_layers),
          f"gnn {cell.name} first step: aggregation launches {launched}")
    return {"worst": worst, "loss": (la, lb)}


def gnn_train_steps(dev, cfg, cell, step, state, batches, n_steps: int, unit: str,
                    per_step: float, remat: bool, pre: int) -> dict:
    """``n_steps`` train steps (the first a warm-up) from a peak reset: loss,
    step ms, ``unit`` a second (``per_step`` of them a step), the aggregation
    launches of each step (a forward and a backward a layer, and under remat
    the recomputed forward too, every one on the CSR index) and the peak.
    ``pre`` is what the process held before the step's state was built."""
    from repro_torch.kernels.gnn_aggregate import gnn_aggregate, reset_launches
    from repro_torch.launch.dryrun import CARD_BYTES

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    reset_launches()
    rows = []
    want = ((2 if remat else 1) * cfg.n_layers, cfg.n_layers)
    for i in range(n_steps):
        f0, b0 = gnn_aggregate.launches_fwd, gnn_aggregate.launches_bwd
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batches[i % len(batches)])
        m = {k: float(v) for k, v in m.items()}  # waits for the device
        dt = time.perf_counter() - t0
        nf, nb = gnn_aggregate.launches_fwd - f0, gnn_aggregate.launches_bwd - b0
        tag = "warm-up" if i == 0 else f"step {i}"
        print(f"gnn {cell.name} {tag}: loss {m['loss']:.6f} grad_norm {m['grad_norm']:.6f} "
              f"step_ms {dt * 1e3:.3f} {unit}_per_s {per_step / dt:.1f} agg_fwd {nf} "
              f"agg_bwd {nb}")
        check(all(math.isfinite(v) for v in m.values()), f"gnn {cell.name} {tag}: {m}")
        check((nf, nb) == want, f"gnn {cell.name} {tag}: {nf} forward / {nb} backward "
                                f"aggregations, wanted {want}")
        rows.append(dict(step_s=dt, **m))
    layouts = dict(gnn_aggregate.launches_by_layout)
    launches = [gnn_aggregate.launches_fwd, gnn_aggregate.launches_bwd]
    check(layouts == {"csr": sum(launches), "ell": 0},
          f"gnn {cell.name}: launches by layout {layouts}, wanted every one on the CSR index")
    mem = torch.cuda.max_memory_allocated(dev)
    mean_s = sum(r["step_s"] for r in rows[1:]) / (n_steps - 1)
    print(f"gnn {cell.name}: {cfg.name} fp32, {cell.params}: mean step_ms {mean_s * 1e3:.3f} "
          f"{unit}_per_s {per_step / mean_s:.1f} max_memory_allocated {mem} (live at the reset "
          f"{base}); aggregation launches in the {n_steps} steps fwd {launches[0]} bwd "
          f"{launches[1]} by layout {layouts}")
    check(mem < CARD_BYTES, f"gnn {cell.name}: peak {mem} B")
    return {"rows": rows, "mean_step_s": mean_s, "max_memory": mem, "base_memory": base,
            "pre_memory": pre, "launches": launches, "steps": n_steps,
            f"{unit}_per_s": per_step / mean_s}


def gnn_molecule(dev, cfg, cell) -> dict:
    """``molecule`` not cut: B 128 graphs of 30 nodes and 64 edges through
    ``forward_batched``; the first step card against CPU, then the steps."""
    from repro_torch.data import make_batch
    from repro_torch.models.layers import init_params
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import build_param_specs, build_train_step, make_train_state

    cpu_params = init_params(torch.Generator().manual_seed(0), build_param_specs(cfg, cell),
                             cfg.dtype, "cpu")
    cpu_batches = [make_batch(cfg, cell, seed=i, device="cpu") for i in range(MOLECULE_STEPS)]
    parity = first_step_parity(dev, cfg, cell, cpu_params, cpu_batches[0])
    gc.collect()
    pre = torch.cuda.memory_allocated(dev)
    state = make_train_state(to_device(cpu_params, dev))
    batches = [to_device(b, dev) for b in cpu_batches]
    step = build_train_step(cfg, cell, AdamWConfig(warmup_steps=10, total_steps=100))
    p = cell.params
    run = gnn_train_steps(dev, cfg, cell, step, state, batches, MOLECULE_STEPS, "graphs",
                          p["batch"], remat=False, pre=pre)
    del state, batches
    run.update(parity=parity, resident_batches=MOLECULE_STEPS - 1)
    return run


def gnn_ogb_cut(dev, cfg, full) -> dict:
    """``ogb_products`` cut in scale, not in shape: the dry-run's largest
    node count (its edges cut by the same factor) whose step, remat full,
    peaks under FIT_BYTES; d_feat 100, 16 layers at width 70; the index
    build's device time (no sync), then the steps on one graph."""
    from repro_torch.data import make_batch
    from repro_torch.kernels.gnn_aggregate import csr_index
    from repro_torch.launch import dryrun
    from repro_torch.models.layers import init_params
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import build_param_specs, build_train_step, make_train_state

    t0 = time.perf_counter()
    cell, rec = dryrun.largest_cut("gatedgcn", full, FIT_BYTES, remat="full")
    n, e = cell.params["n_nodes"], cell.params["n_edges"]
    print(f"gnn ogb_products: the dry-run's cut for a peak under {FIT_BYTES} B (remat full): "
          f"{n} of {OGB_NODES} nodes, {e} of {OGB_EDGES} edges (factor {n / OGB_NODES:.6f}; "
          f"{e / n:.3f} edges a node, published {OGB_EDGES / OGB_NODES:.3f}); reckoned peak "
          f"{rec['memory']['peak_hbm_bytes']} B, roofline "
          f"{rec['roofline']['step_time_s'] * 1e3:.3f} ms; search "
          f"{time.perf_counter() - t0:.3f} s")
    gc.collect()
    torch.cuda.empty_cache()
    pre = torch.cuda.memory_allocated(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    state = make_train_state(init_params(gen, build_param_specs(cfg, cell), cfg.dtype, dev))
    step = build_train_step(cfg, cell, AdamWConfig(warmup_steps=10, total_steps=100),
                            remat="full")
    batch = make_batch(cfg, cell, seed=0, device=dev)
    ei, n_pad = batch["edge_index"], batch["node_feat"].shape[0]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")  # any read back to the host raises
    try:
        csr_index(ei, n_pad)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    index_ms = queued_ms(lambda: csr_index(ei, n_pad))
    print(f"gnn ogb_products: csr_index of the cut graph ({n_pad} nodes, {ei.shape[1]} edges) on "
          f"the card without a sync: queued_ms {index_ms:.6f}")
    run = gnn_train_steps(dev, cfg, cell, step, state, [batch], OGB_STEPS, "nodes", n,
                          remat=True, pre=pre)
    del state, batch, ei
    gc.collect()
    torch.cuda.empty_cache()
    run.update(cell=cell, reckoned=rec, index_ms=index_ms)
    return run


def power_law_on_card(n: int, e: int, dev, seed: int = 0) -> torch.Tensor:
    """Edges [2, e] int32 with ``random_graph``'s power law (node weights
    pareto(1.5) + 1, both ends drawn in proportion to them), drawn on the
    card: the host's ``rng.choice`` takes tens of seconds at this size."""
    w = np.random.default_rng(seed).pareto(1.5, size=n) + 1.0
    cdf = torch.from_numpy(np.cumsum(w / w.sum())).to(dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    ends = [torch.searchsorted(cdf, torch.rand(e, generator=gen, device=dev, dtype=torch.float64))
            .clamp_(max=n - 1).int() for _ in range(2)]
    return torch.stack(ends)


def csr_rows_against_plain(idx, h, gates, dnum, dden, got, blocks: int) -> tuple[dict, dict]:
    """The CSR call's outputs (num, den, dh, dgates) against the plain
    version plus autograd in fp32, on every row, in ``blocks`` blocks of
    rows (the plain version's [slots, dim] temporaries of the whole graph
    would not fit beside the kernel's).  Returns the largest errors (fwd,
    bwd) and the plain version's summed times of the blocks (fwd, bwd)."""
    from repro_torch.kernels.gnn_aggregate import gnn_aggregate_csr_ref

    h32 = h.detach().clone().requires_grad_(True)
    dh_acc = torch.zeros_like(h)
    errs, ms = {"fwd": 0.0, "bwd": 0.0}, {"fwd": 0.0, "bwd": 0.0}
    ev = lambda: torch.cuda.Event(enable_timing=True)
    for r0, r1, a, b in row_blocks(idx, blocks):
        rp = idx.row_ptr[r0:r1 + 1] - a
        g = gates[a:b].detach().requires_grad_(True)
        t = [ev() for _ in range(3)]
        t[0].record()
        num, den = gnn_aggregate_csr_ref(h32, rp, idx.col[a:b], g, True)
        t[1].record()
        dh, dg = torch.autograd.grad((num, den), (h32, g), (dnum[r0:r1], dden[r0:r1]))
        t[2].record()
        torch.cuda.synchronize()
        ms["fwd"] += t[0].elapsed_time(t[1])
        ms["bwd"] += t[1].elapsed_time(t[2])
        dh_acc += dh
        for kind, x, y in (("fwd", got[0][r0:r1], num), ("fwd", got[1][r0:r1], den),
                           ("bwd", got[3][a:b], dg)):
            err, ratio = assert_close_ratio(x, y.detach(), TOL[torch.float32])
            check(math.isfinite(err) and ratio <= 1.0,
                  f"gnn_aggregate ogb_products rows {r0}..{r1} {kind}: max_abs_err {err}, "
                  f"ratio {ratio}")
            errs[kind] = max(errs[kind], err)
        del num, den, dh, dg, g
    err, ratio = assert_close_ratio(got[2], dh_acc, TOL[torch.float32])
    check(math.isfinite(err) and ratio <= 1.0,
          f"gnn_aggregate ogb_products dh: max_abs_err {err}, ratio {ratio}")
    errs["bwd"] = max(errs["bwd"], err)
    print(f"agg check ogb_products full uniform csr against the plain version in {blocks} row "
          f"blocks (atol=rtol={TOL[torch.float32]:.0e}): fwd max_abs_err {errs['fwd']:.3e}, bwd "
          f"{errs['bwd']:.3e}; plain ms fwd {ms['fwd']:.3f} bwd {ms['bwd']:.3f} (block sums)")
    return errs, ms


def agg_ogb_full(dev) -> dict:
    """The aggregation kernels at ogb_products' published size, 2,449,029
    rows and 61,859,140 slots x 70 fp32 (4.33e9 gate elements, past 2^31),
    forward with den and backward, on make_batch's uniform graph and on a
    power-law graph of the same counts: the index built without a sync; two
    backward runs equal bit for bit; against the same function in fp64
    (``csr_check64``, the large graphs' rule of ``phase_agg``) and, on the
    uniform graph, against the plain version in row blocks; then the times
    beside the bound and the ``index_add_`` yardstick, written out in place
    (autograd of the whole ``index_add_`` form would not fit beside it)."""
    from repro_torch.configs import get_config, get_shapes
    from repro_torch.data import make_batch
    from repro_torch.kernels.gnn_aggregate import csr_index
    from repro_torch.kernels.gnn_aggregate import ops

    cfg = get_config("gatedgcn")
    full = {c.name: c for c in get_shapes("gatedgcn")}["ogb_products"]
    n, E, dim = OGB_NODES, OGB_EDGES, cfg.d_hidden
    t0 = time.perf_counter()
    uniform = make_batch(cfg, full, seed=0, device="cpu")["edge_index"][:, :E].contiguous()
    print(f"agg ogb_products: make_batch's graph drawn in {time.perf_counter() - t0:.3f} s")
    gen = torch.Generator(device=dev).manual_seed(29)
    out = {}
    for label in ("uniform", "power law"):
        t0 = time.perf_counter()
        ei = uniform.to(dev) if label == "uniform" else power_law_on_card(n, E, dev)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")  # any read back to the host raises
        try:
            idx = csr_index(ei, n)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        index_ms = queued_ms(lambda: csr_index(ei, n))
        del ei
        max_deg = int((idx.row_ptr[1:] - idx.row_ptr[:-1]).max())
        print(f"agg ogb_products {label}: {n} rows, {E} slots x {dim} fp32 ({E * dim} gate "
              f"elements, 2^31 = {2**31}); largest in-degree {max_deg}; graph on the card in "
              f"{time.perf_counter() - t0:.3f} s; csr_index queued_ms {index_ms:.6f}")
        h = torch.randn(n, dim, generator=gen, device=dev)
        gates = torch.rand(E, dim, generator=gen, device=dev)  # slot order: i.i.d., as drawn
        dnum, dden = (torch.randn(n, dim, generator=gen, device=dev) for _ in range(2))
        fwd = lambda: ops.gnn_aggregate_fwd(h, idx.row_ptr, idx.col, gates, with_den=True)
        bwd = lambda: ops.gnn_aggregate_bwd(h, idx.row_ptr, idx.col, gates, dnum, dden, idx.rev)
        num, den = fwd()
        dh, dg = bwd()
        dh2, dg2 = bwd()
        torch.cuda.synchronize()
        same = torch.equal(dh, dh2) and torch.equal(dg, dg2)
        del dh2, dg2
        print(f"agg check ogb_products {label}: backward equal bit for bit over two runs: {same}")
        check(same, f"gnn_aggregate ogb_products {label}: the backward is not deterministic")
        errs = csr_check64(f"ogb_products {label}", idx, h, gates, dnum, dden,
                           (num, den, dh, dg), TOL[torch.float32])
        row = {"index_ms": index_ms, "max_in_degree": max_deg}
        plain_ms = {}
        if label == "uniform":
            plain_errs, plain_ms = csr_rows_against_plain(idx, h, gates, dnum, dden,
                                                          (num, den, dh, dg), OGB_AGG_BLOCKS)
            errs = {k: max(errs[k], plain_errs[k]) for k in errs}
        del num, den, dh, dg
        gc.collect()
        torch.cuda.empty_cache()
        for kind, fn in (("fwd", fwd), ("bwd", bwd)):
            bms, by = csr_bound_ms(idx, n, dim, 4, kind == "bwd", True)
            row[kind] = dict(agg_times(fn, OGB_AGG_ITERS), bound_ms=bms, bound_by=by,
                             max_abs_err=errs[kind], plain_ms=plain_ms.get(kind))
        # yardstick: the reference model's segment sums as index_add_, and
        # their backward written out (what autograd of that form runs), in place
        src, dst = idx.col.long(), torch.searchsorted(
            idx.row_ptr, torch.arange(E, dtype=torch.int32, device=dev), right=True) - 1

        def seg_fwd():
            t = gates * h[src]
            a = torch.zeros(n, dim, device=dev).index_add_(0, dst, t)
            del t
            return a, torch.zeros(n, dim, device=dev).index_add_(0, dst, gates)

        def seg_bwd():
            dg_ = dnum[dst]
            dg_.mul_(h[src]).add_(dden[dst])
            u = dnum[dst]
            u.mul_(gates)
            return torch.zeros(n, dim, device=dev).index_add_(0, src, u), dg_

        row["fwd"]["yardstick_ms"] = cuda_ms(seg_fwd, iters=OGB_AGG_ITERS, warmup=1)
        row["bwd"]["yardstick_ms"] = cuda_ms(seg_bwd, iters=OGB_AGG_ITERS, warmup=1)
        for kind in ("fwd", "bwd"):
            r = row[kind]
            print(f"agg time  ogb_products {label:9s} float32 csr {kind} ms {r['ms']:.6f} "
                  f"device_ms {r['device_ms']:.6f} queued_ms {r['queued_ms']:.6f} "
                  f"l2_flushed_ms {r['flushed_ms']:.6f} plain_ms {r['plain_ms']} "
                  f"yardstick_index_add_ms {r['yardstick_ms']:.6f} bound_ms "
                  f"{r['bound_ms']:.6f} ({r['bound_by']}) on {card_line()}")
        out[label] = row
        del h, gates, dnum, dden, idx, src, dst
        gc.collect()
        torch.cuda.empty_cache()
    return out


def phase_gnn_cells(dev) -> dict:
    """Full-width GatedGCN (16 layers, d_hidden 70, 47 classes, fp32) on the
    two cells the other phases do not run, through ``build_train_step`` and
    AdamW on ``make_batch``'s graphs: ``molecule`` at its full size and
    ``ogb_products`` at the dry-run's cut; then the aggregation kernels at
    ogb_products' full size."""
    from repro_torch.configs import get_config, get_shapes

    cfg = get_config("gatedgcn")
    cells = {c.name: c for c in get_shapes("gatedgcn")}
    out = {"molecule": gnn_molecule(dev, cfg, cells["molecule"])}
    gc.collect()
    torch.cuda.empty_cache()
    out["ogb_products"] = gnn_ogb_cut(dev, cfg, cells["ogb_products"])
    out["agg_full"] = agg_ogb_full(dev)
    return out


# --------------------------------------------------------------------------
# phase: the dry-run's reckoning against the card's measurements
# --------------------------------------------------------------------------
DRYRUN_TOL = 0.10  # the reckoned peak against max_memory_allocated, and TinyLlama's FLOPs


def lm_resident(B: int, S: int, n: int) -> dict:
    """``n`` batches of tokens and targets [B, S] int32 held beside a step."""
    from repro_torch.configs.base import TensorSpec

    spec = TensorSpec((B, S), torch.int32)
    return {"batches": [{"tokens": spec, "targets": spec} for _ in range(n)]}


def dryrun_steps(train, ftrain, gtrain, cells) -> list[dict]:
    """The seven steps whose peak a phase measured, each as the dry-run
    takes it: (label, arch, cell, remat, cfg overrides, what the phase holds
    beside the step and its one batch, the measured run)."""
    from repro_torch.configs import ShapeCell, get_shapes
    from repro_torch.configs.base import TensorSpec

    gnn = {c.name: c for c in get_shapes("gatedgcn")}
    f32, i32 = torch.float32, torch.int32
    block = {"node_feat": TensorSpec((169_984, 602), f32),
             "edge_index": TensorSpec((2, 168_960), i32),
             "labels": TensorSpec((1024,), i32), "seed_ids": TensorSpec((1024,), i32)}
    mol = gnn["molecule"].params
    mol_batch = {"node_feat": TensorSpec((mol["batch"], mol["n_nodes"], 16), f32),
                 "edge_index": TensorSpec((mol["batch"], 2, mol["n_edges"]), i32),
                 "labels": TensorSpec((mol["batch"],), i32)}
    steps = [dict(label="tinyllama-1.1b train B 4 x S 2048", arch="tinyllama-1.1b",
                  cell=ShapeCell("train", "train", {"seq_len": 2048, "global_batch": 4}),
                  remat="none", overrides=[], resident=lm_resident(4, 2048, train["batches"] - 1),
                  run=train)]
    for arch, r in ftrain["train"].items():
        steps.append(dict(
            label=f"{arch} train at {r['layers']} of {r['full_layers']} layers, B 1 x S 2048",
            arch=arch, cell=ShapeCell("train", "train", {"seq_len": FAMILY_TRAIN_SEQ,
                                                         "global_batch": 1}),
            remat="none", overrides=[f"n_layers={r['layers']}"],
            resident=lm_resident(1, FAMILY_TRAIN_SEQ, FAMILY_TRAIN_STEPS - 1), run=r))
    steps.append(dict(label="gatedgcn minibatch_lg", arch="gatedgcn", cell=gnn["minibatch_lg"],
                      remat="none", overrides=[],
                      resident={"feats": TensorSpec((REDDIT_NODES, 602), f32),
                                "labels": TensorSpec((REDDIT_NODES,), i32),
                                "batches": [block] * 4}, run=gtrain))
    m = cells["molecule"]
    steps.append(dict(label="gatedgcn molecule", arch="gatedgcn", cell=gnn["molecule"],
                      remat="none", overrides=[],
                      resident={"batches": [mol_batch] * m["resident_batches"]}, run=m))
    o = cells["ogb_products"]
    steps.append(dict(label="gatedgcn ogb_products at the cut", arch="gatedgcn", cell=o["cell"],
                      remat="full", overrides=[], resident=None, run=o))
    return steps


def dryrun_compare(label: str, rec: dict, run: dict, trace_s: float,
                   data_bound_ms: float | None = None) -> dict:
    """One measured step against the dry-run's record of it: the reckoned
    peak within DRYRUN_TOL of the step's own peak (``max_memory_allocated``
    from a reset after its state was built, less ``run["pre_memory"]``, what
    the process held before), and the roofline time at most the measured
    step ms.  ``data_bound_ms``, where the reckoning counts work the run
    does not do (a decode step's meta path reads every cache key; the run
    attends ``cache_len`` + 1 of them), is the step's least time from this
    run's data, which the measured step is held to instead of the roofline."""
    check(rec["status"] == "ok", f"dry-run {label}: {rec}")
    # the step's own peak: what the process held before the phase built
    # the step's state (earlier phases' tensors, cuBLAS workspaces) is not
    # the step's
    peak, measured = rec["memory"]["peak_hbm_bytes"], run["max_memory"] - run["pre_memory"]
    roof_ms = rec["roofline"]["step_time_s"] * 1e3
    step_ms = run["mean_step_s"] * 1e3
    counted = rec["roofline"]["flops_per_chip"]
    r = dict(reckoned_peak=peak, measured_peak=measured, ratio=peak / measured,
             max_memory_allocated=run["max_memory"], before_the_step=run["pre_memory"],
             reckoned_argument_bytes=rec["memory"]["argument_bytes"],
             measured_argument_bytes=run["base_memory"] - run["pre_memory"],
             roofline_ms=roof_ms, step_ms=step_ms,
             dominant=rec["roofline"]["dominant"], counted_flops=counted,
             model_flops=rec["model_flops_global"],
             counted_over_model=counted / rec["model_flops_global"],
             trace_s=trace_s)
    held = "the roofline"
    if data_bound_ms is not None:
        r["data_bound_ms"] = data_bound_ms
        held = f"this run's data bound {data_bound_ms:.3f} ms"
    print(f"dryrun {label}: reckoned peak {peak} B against the step's measured "
          f"{measured} (ratio {r['ratio']:.4f}: max_memory_allocated {run['max_memory']} "
          f"less {run['pre_memory']} held before the step's state); live at the start "
          f"reckoned {r['reckoned_argument_bytes']}, measured "
          f"{r['measured_argument_bytes']}; "
          f"roofline {roof_ms:.3f} ms ({r['dominant']}) against the measured step "
          f"{step_ms:.3f} ms (held to {held}); FLOPs counted {counted:.6e} against "
          f"model_flops {r['model_flops']:.6e} ({r['counted_over_model']:.4f}); traced in "
          f"{trace_s:.3f} s")
    check(abs(peak - measured) <= DRYRUN_TOL * measured,
          f"dry-run {label}: reckoned peak {peak} B, measured {measured} B")
    floor = roof_ms if data_bound_ms is None else data_bound_ms
    check(floor <= step_ms, f"dry-run {label}: {held} {floor} ms above the measured "
                            f"{step_ms} ms")
    return r


def phase_dryrun(dev, train, ftrain, gtrain, cells) -> dict:
    """The dry-run (``repro_torch.launch.dryrun``, on the meta device) of
    each step whose peak an earlier phase measured, at the same shape,
    dtype, remat and depth, holding what the phase held beside it: the
    reckoned peak within DRYRUN_TOL of the step's measured peak
    (``max_memory_allocated`` after the phase's ``reset_peak_memory_stats``,
    less what the process held before the phase built the step's state), the
    roofline time at most the
    measured step ms, TinyLlama's counted FLOPs within DRYRUN_TOL of
    ``model_flops`` (the embedding lookup, a product there, is a gather
    here).  Then the depth the dry-run gives each family under FIT_BYTES
    beside FAMILY_TRAIN's, and its flash scratch sizes against the library's
    (``check_flash_work_floats``)."""
    from repro_torch.launch import dryrun

    rows, steps = {}, dryrun_steps(train, ftrain, gtrain, cells)
    for s in steps:
        t0 = time.perf_counter()
        rec = dryrun.run_cell(s["arch"], s["cell"], remat=s["remat"], cfg_overrides=s["overrides"],
                              resident=s["resident"])
        rows[s["label"]] = dryrun_compare(s["label"], rec, s["run"], time.perf_counter() - t0)
    tl = rows[steps[0]["label"]]  # TinyLlama's
    check(abs(tl["counted_over_model"] - 1) <= DRYRUN_TOL,
          f"dry-run TinyLlama: counted FLOPs {tl['counted_flops']} against model_flops "
          f"{tl['model_flops']}")
    # tools/family_depth.py's question, answered by the dry-run
    depths = {}
    for arch, used in FAMILY_TRAIN:
        cell = next(s["cell"] for s in steps if s["arch"] == arch)
        L, rec = dryrun.deepest(arch, cell, FIT_BYTES,
                                resident=lm_resident(1, FAMILY_TRAIN_SEQ, FAMILY_TRAIN_STEPS - 1))
        depths[arch] = {"dryrun": L, "used": used,
                        "reckoned_peak": rec["memory"]["peak_hbm_bytes"] if rec else None}
        print(f"dryrun family depth {arch}: the dry-run's deepest under {FIT_BYTES} B is {L} "
              f"layers (reckoned peak {depths[arch]['reckoned_peak']} B); FAMILY_TRAIN uses "
              f"{used}")
    check_flash_work_floats()
    return {"steps": rows, "family_depth": depths}


def check_flash_work_floats() -> None:
    """The meta path's flash scratch (``ops.work_floats``) against the
    library's ``flash_attention_work_floats`` at every flash case, and at
    MLA's values of 128 beside keys of 192 (G 1 and G 3)."""
    import ctypes

    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import ops as flash_ops

    library = build.load("flash_attention").flash_attention_work_floats
    library.argtypes = [ctypes.c_int] * 11  # B, Sq, Sk, Hq, Hkv, dh, dv, causal, window, var, bwd
    library.restype = ctypes.c_longlong
    n_cases = 0
    mla_cases = [("mla", 1, MLA_SEQ, 128, 128, 192, True, None, 128),
                 ("mla G 3", 1, 300, 6, 2, 192, True, None, 128)]
    for c in [(*c, c[5]) for c in FLASH_CASES] + mla_cases:
        _, B, S, Hq, Hkv, dh, causal, window, dv = c
        for var in range(len(flash_ops.VARIANTS)):
            for backward in (False, True):
                args = (B, S, S, Hq, Hkv, dh, int(causal), window or 0, var)
                got = flash_ops.work_floats(*args, backward, dv=dv)
                want = library(*args[:6], dv, *args[6:], int(backward))
                check(got == want, f"flash work_floats {c[0]} variant {var} backward "
                                   f"{backward}: {got} against the library's {want}")
                n_cases += 1
    print(f"dryrun flash scratch: work_floats equals the library's at {n_cases} cases")


WF_CORPUS_BYTES = 1 << 26  # 64 MB: 16,376 packed rows of 2,049 tokens
WF_SEQ = 2048
WF_HOLDOUT = 8  # eval rows held out by split; the t1_gt_t2 runs hold out 16
WF_STEPS, WF_BATCH = 4, 4  # AdamW steps of B 4 x S 2048 in the train module
WF_EVAL_ROWS = 2  # eval rows a call, from the parameter ``start`` on


def wf_steps(start: int, holdout: int = WF_HOLDOUT) -> list:
    """corpus -> tokenize -> pack -> split -> train -> eval(start)."""
    return ["tokenize", ("pack", {"seq_len": WF_SEQ}), ("split", {"holdout": holdout}),
            "train", ("eval", {"start": start})]


def wf_registry(cfg, dev, witness: list, failures: list, computes: dict):
    """The workflow's modules: the port's data stages, and ``train`` and
    ``eval`` at full width.  ``train`` records CUDA events around its steps
    in ``witness``; ``eval`` raises once for each entry of ``failures``;
    ``computes`` counts each module's calls."""
    import torch.nn.functional as F

    from repro_torch.configs import ShapeCell
    from repro_torch.core import ModuleRegistry
    from repro_torch.data.pipeline import register_data_modules
    from repro_torch.models import transformer
    from repro_torch.models.layers import init_params
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import build_train_step, make_train_state

    cell = ShapeCell("train", "train", {"seq_len": WF_SEQ, "global_batch": WF_BATCH})
    opt = AdamWConfig(warmup_steps=10, total_steps=100)

    def train(split, steps=WF_STEPS, seed=0):
        """``steps`` AdamW steps from weights drawn with ``seed``; returns
        the bf16 weights (no optimizer moments) and the eval rows."""
        gen = torch.Generator(device=dev).manual_seed(seed)
        state = make_train_state(init_params(gen, transformer.lm_specs(cfg), cfg.dtype, dev))
        step = build_train_step(cfg, cell, opt, remat="none")
        rows = split["train"]
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        losses = []
        start.record()
        for i in range(steps):
            r = rows[i * WF_BATCH:(i + 1) * WF_BATCH]
            state, m = step(state, {"tokens": r[:, :-1].contiguous(),
                                    "targets": r[:, 1:].contiguous()})
            losses.append(m["loss"])
        end.record()
        witness.append((start, end, losses))
        return {"params": state["params"], "eval": split["eval"]}

    def evaluate(trained, start=0, n=WF_EVAL_ROWS):
        """Per-row mean cross-entropy (fp32) of eval rows start..start+n."""
        if failures:
            failures.pop()
            raise RuntimeError("injected eval failure")
        rows = trained["eval"][start:start + n]
        with torch.no_grad():
            logits, _ = transformer.forward(trained["params"], cfg, rows[:, :-1].contiguous())
            ce = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                                 rows[:, 1:].reshape(-1).long(), reduction="none")
        return ce.view(rows.shape[0], -1).mean(1)

    reg = ModuleRegistry()
    register_data_modules(reg, vocab=cfg.vocab)
    reg.register_fn("train", train, steps=WF_STEPS, seed=0)
    reg.register_fn("eval", evaluate, start=0, n=WF_EVAL_ROWS)
    for mid in list(reg):
        spec = reg[mid]

        def counted(x, _fn=spec.fn, _mid=mid, **kw):
            computes[_mid] = computes.get(_mid, 0) + 1
            return _fn(x, **kw)

        spec.fn = counted
    return reg


def wf_report(label: str, r, store, dev) -> dict:
    """One run's line: skips, each module's seconds, load and save seconds,
    the bytes loaded and stored, and the eval output."""
    loaded = 0
    if r.reused_prefix is not None:
        rec = store.records.get(r.reused_prefix.key(True))
        loaded = rec.nbytes_raw if rec is not None else 0
    stored = sum(store.records[k].nbytes_raw for k in r.stored_keys if k in store.records)
    out = [float(v) for v in r.output.float().cpu()]
    secs = " ".join(f"{s:.6f}" for s in r.module_seconds)
    print(f"workflow {label}: n_skipped {r.n_skipped}/{len(r.workflow)} module_s [{secs}] "
          f"load_s {r.load_seconds:.6f} bytes_loaded {loaded} save_s {r.store_seconds:.6f} "
          f"bytes_stored {stored} total_s {r.total_seconds:.6f} eval_ce {out}")
    check(r.output.dtype == torch.float32 and r.output.device == torch.device(dev)
          and tuple(r.output.shape) == (WF_EVAL_ROWS,) and all(map(math.isfinite, out)),
          f"workflow {label}: eval output {r.output}")
    return {"n_skipped": r.n_skipped, "module_s": list(r.module_seconds),
            "load_s": r.load_seconds, "save_s": r.store_seconds, "bytes_loaded": loaded,
            "bytes_stored": stored, "total_s": r.total_seconds, "eval_ce": out}


def wf_witness(label: str, r, witness: list) -> dict:
    """The train module's seconds in run ``r`` against the device time of
    its steps (CUDA events recorded inside the module)."""
    at = 3  # train's index in wf_steps
    start, end, losses = witness[-1]
    device_s = start.elapsed_time(end) / 1e3
    loss = [float(x) for x in losses]
    print(f"workflow {label}: train compute_s {r.module_seconds[at]:.6f} "
          f"device_s_of_its_steps {device_s:.6f} losses {loss}")
    check(all(map(math.isfinite, loss)), f"workflow {label}: losses {loss}")
    check(r.module_seconds[at] >= device_s,
          f"workflow {label}: train compute_s {r.module_seconds[at]} < its device time "
          f"{device_s}")
    return {"compute_s": r.module_seconds[at], "device_s": device_s, "losses": loss}


def phase_workflow(dev, engine_rows) -> dict:
    """The thesis's workflow path at full TinyLlama-1.1B width, through
    ``WorkflowExecutor`` and ``DagScheduler`` over ``IntermediateStore``s in
    temporary directories, then two serving engines sharing snapshots
    through one fabric directory (``mount_serve_engine``)."""
    import dataclasses as dc
    import shutil
    import threading

    from repro_torch.configs import get_config
    from repro_torch.core import RISP, CostModel, IntermediateStore, WorkflowError
    from repro_torch.core import WorkflowExecutor
    from repro_torch.data.pipeline import (
        byte_tokenize, make_corpus_blob, pack_sequences, train_split)
    from repro_torch.kernels.decode_attention import ops as decode_ops
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention import reset_launches as reset_flash
    from repro_torch.sched import DagScheduler

    @dc.dataclass
    class WitnessCost(CostModel):
        """Records each Eq. 4.9 decision with the t1 and t2 it compared."""
        decisions: list = dc.field(default_factory=list)

        def should_store(self, prefix, measured_exec_s=None):
            t1, t2 = self.t1(prefix, measured_exec_s), self.t2(prefix)
            ok = super().should_store(prefix, measured_exec_s)
            self.decisions.append((prefix, measured_exec_s, t1, t2, ok))
            return ok

    cfg = get_config("tinyllama-1.1b")  # full width, bf16
    witness: list = []
    failures: list = []
    computes: dict = {}
    reg = wf_registry(cfg, dev, witness, failures, computes)
    root = tempfile.mkdtemp(prefix="wf-")
    torch.cuda.synchronize()
    reset_flash()
    decode_ops.reset_launches()
    out: dict = {"runs": {}}
    try:
        t0 = time.perf_counter()
        blob = make_corpus_blob(WF_CORPUS_BYTES, seed=0, device=dev)
        torch.cuda.synchronize()
        print(f"workflow: corpus {WF_CORPUS_BYTES} bytes on the card in "
              f"{time.perf_counter() - t0:.3f} s; {cfg.name} {cfg.n_layers} layers d_model "
              f"{cfg.d_model}; pack {WF_SEQ} split holdout {WF_HOLDOUT}; train {WF_STEPS} "
              f"steps of B {WF_BATCH} x S {WF_SEQ}; eval {WF_EVAL_ROWS} rows")
        store = IntermediateStore(os.path.join(root, "seq"), codec="none")
        ex = WorkflowExecutor(store=store, policy=RISP(with_state=True), registry=reg,
                              device=dev)
        train_key = ex.make_workflow("corpus", wf_steps(0)).prefix(4).key(True)

        # cold runs with differing eval parameters until RISP admits train
        cold = {}
        for i, start in enumerate((0, 2, 4)):
            r = ex.run("corpus", blob, wf_steps(start), f"cold{i}")
            check(r.n_skipped == 0, f"workflow cold {i}: skipped {r.n_skipped}")
            cold[start] = r
            out["runs"][f"cold {i}"] = wf_report(f"cold {i} eval start {start}", r, store, dev)
            out["runs"][f"cold {i}"]["witness"] = wf_witness(f"cold {i}", r, witness)
            if train_key in r.stored_keys:
                break
        check(train_key in store.records, f"workflow: RISP never admitted train in {len(cold)} runs")
        rec = store.records[train_key]
        print(f"workflow: RISP admitted train after {len(cold)} cold runs: {rec.nbytes_raw} "
              f"bytes, save_s {rec.save_s:.6f}, compute_s {rec.compute_s:.6f}")
        check(rec.compute_s >= out["runs"][f"cold {len(cold) - 1}"]["witness"]["device_s"],
              "workflow: the stored train prefix's compute_s is under its steps' device time")
        stored_by = start

        # reuse: the same eval on the stored bits, then the first cold run's eval
        for label, start in (("reuse", stored_by), ("reuse first", 0)):
            n_train = computes.get("train", 0)
            r = ex.run("corpus", blob, wf_steps(start), label)
            out["runs"][label] = wf_report(f"{label} eval start {start}", r, store, dev)
            check(r.n_skipped == 4 and computes.get("train", 0) == n_train,
                  f"workflow {label}: skipped {r.n_skipped}, wanted tokenize to train")
            check(torch.equal(r.output, cold[start].output),
                  f"workflow {label}: eval {r.output} differs from the cold run's "
                  f"{cold[start].output}")
        out["reuse_load_s"] = out["runs"]["reuse"]["load_s"]

        # recovery: eval raises once; the resumed run restarts at the failure point
        failures.append(1)
        try:
            ex.run("corpus", blob, wf_steps(6), "recover")
            check(False, "workflow recovery: the injected failure did not raise")
        except WorkflowError as e:
            failed_at = e.failed_at
        r = ex.run("corpus", blob, wf_steps(6), "resumed")
        out["runs"]["resumed"] = wf_report(f"resumed after a failure at module {failed_at}",
                                           r, store, dev)
        check(failed_at == 4 and r.n_skipped == failed_at,
              f"workflow recovery: failed at {failed_at}, resumed after {r.n_skipped}")
        out["recovery"] = {"failed_at": failed_at, "resumed_skipped": r.n_skipped}

        # Eq. 4.9 admission over the same store (its measured save and load
        # rates); holdout 16 makes a prefix this store does not hold yet
        cost = WitnessCost(store=store)
        ex2 = WorkflowExecutor(store=store, policy=RISP(with_state=True), registry=reg,
                               admission="t1_gt_t2", cost_model=cost, device=dev)
        key16 = ex2.make_workflow("corpus", wf_steps(0, 16)).prefix(4).key(True)
        for i, start in enumerate((0, 2, 4)):
            r = ex2.run("corpus", blob, wf_steps(start, 16), f"t1t2 {i}")
            out["runs"][f"t1_gt_t2 {i}"] = wf_report(f"t1_gt_t2 {i} eval start {start}",
                                                    r, store, dev)
            if any(p.key(True) == key16 for p, *_ in cost.decisions):
                break
        check(bool(cost.decisions), "workflow t1_gt_t2: no admission decision was taken")
        for prefix, measured, t1, t2, ok in cost.decisions:
            kept = prefix.key(True) in store.records
            print(f"workflow t1_gt_t2: prefix depth {prefix.depth} compute_s {measured:.6f} "
                  f"t1 {t1:.6f} t2 {t2:.6f} decision {'store' if ok else 'skip'} "
                  f"stored {kept}")
            check(ok == (t1 > t2) and kept == ok,
                  f"workflow t1_gt_t2: decision {ok} stored {kept} for t1 {t1} t2 {t2}")
        check(any(p.key(True) == key16 for p, *_ in cost.decisions),
              "workflow t1_gt_t2: no decision on the train prefix")
        out["t1_gt_t2"] = [{"depth": p.depth, "compute_s": m, "t1": t1, "t2": t2,
                            "store": ok} for p, m, t1, t2, ok in cost.decisions]

        # the host's time of one train call with no device wait, beside the
        # executor's compute_s of the same module (cold run 0)
        split = train_split(pack_sequences(byte_tokenize(blob, cfg.vocab), WF_SEQ), WF_HOLDOUT)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trained = reg["train"].fn(split)
        host_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        start, end, _ = witness[-1]
        dev_s = start.elapsed_time(end) / 1e3
        cs = out["runs"]["cold 0"]["witness"]["compute_s"]
        print(f"workflow witness: train host_s (no device wait) {host_s:.6f} wall_s with the "
              f"wait {wall_s:.6f} device_s_of_its_steps {dev_s:.6f}; executor compute_s "
              f"(cold 0) {cs:.6f}")
        out["witness"] = {"host_s": host_s, "wall_s": wall_s, "device_s": dev_s,
                          "executor_compute_s": cs}
        del trained, split
        shutil.rmtree(os.path.join(root, "seq"), ignore_errors=True)
        del ex, ex2, store
        gc.collect()
        torch.cuda.empty_cache()

        # the DAG: the shared prefix, then two eval branches, run twice at once
        # over a fresh store; single-flight computes the prefix once
        sched = DagScheduler(store=IntermediateStore(os.path.join(root, "dag"), codec="none"),
                             policy=RISP(with_state=True), registry=reg, max_workers=4,
                             device=dev)
        starts = sorted(cold)[:2]
        before = dict(computes)
        results: dict = {}

        def run_dag(name):
            dag = sched.dag("corpus", name)
            prev = None
            for i, (mid, params) in enumerate(
                    [(s, None) if isinstance(s, str) else s for s in wf_steps(0)[:4]]):
                dag.add(mid, mid, params, after=prev)
                prev = mid
            for s in starts:
                dag.add(f"eval{s}", "eval", {"start": s}, after="train")
            results[name] = sched.run(dag, blob)

        threads = [threading.Thread(target=run_dag, args=(n,)) for n in ("dag a", "dag b")]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        dag_s = time.perf_counter() - t0
        sched.close()
        check(set(results) == {"dag a", "dag b"}, f"workflow dag: runs finished {set(results)}")
        n_train = computes.get("train", 0) - before.get("train", 0)
        srcs = {n: {k: v.source for k, v in r.node_results.items()} for n, r in results.items()}
        print(f"workflow dag: two runs at once in {dag_s:.6f} s; train computed {n_train} time(s); "
              f"single-flight leads {sched.singleflight.leads} waits {sched.singleflight.waits}; "
              f"sources {srcs}")
        for name, r in results.items():
            secs = " ".join(f"{s:.6f}" for s in r.module_seconds)
            print(f"workflow {name}: module_s [{secs}] load_s {r.load_seconds:.6f} save_s "
                  f"{r.store_seconds:.6f} stored {len(r.stored_keys)} total_s "
                  f"{r.total_seconds:.6f}")
            for s in starts:
                check(torch.equal(r.outputs[f"eval{s}"], cold[s].output),
                      f"workflow {name}: branch eval{s} {r.outputs[f'eval{s}']} differs from "
                      f"the sequential run's {cold[s].output}")
        check(n_train == 1, f"workflow dag: train computed {n_train} times, wanted once")
        check(sorted(srcs[n]["train"] for n in srcs)[0] == "computed"
              and {srcs[n]["train"] for n in srcs} <= {"computed", "singleflight", "loaded"},
              f"workflow dag: train sources {srcs}")
        out["dag"] = {"seconds": dag_s, "train_computes": n_train, "sources": srcs,
                      "leads": sched.singleflight.leads, "waits": sched.singleflight.waits}
        del sched, results
        gc.collect()
        torch.cuda.empty_cache()
        out["flash"] = (flash_attention.launches_fwd, flash_attention.launches_bwd)
        out["flash_by_variant"] = {v: dict(c) for v, c in
                                   flash_attention.launches_by_variant.items()}
        out["train_calls"] = computes.get("train", 0)
        out["eval_calls"] = computes.get("eval", 0)
        print(f"workflow: module calls {computes}; flash launches fwd {out['flash'][0]} "
              f"bwd {out['flash'][1]} by variant {out['flash_by_variant']}")
        check(out["flash"][1] == cfg.n_layers * WF_STEPS * out["train_calls"]
              and out["flash"][0] == cfg.n_layers * (WF_STEPS * out["train_calls"]
                                                     + out["eval_calls"] - 1)
              and out["flash_by_variant"]["wgmma"] == {"fwd": out["flash"][0],
                                                       "bwd": out["flash"][1]},
              f"workflow: flash launches {out['flash']} by variant "
              f"{out['flash_by_variant']} for {out['train_calls']} train and "
              f"{out['eval_calls']} eval calls (one raised before its forward)")

        out["fabric"] = wf_fabric(dev, cfg, os.path.join(root, "fabric"), engine_rows)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["decode"] = dict(decode_ops.decode_attention.launches_by_variant)
    return out


def wf_fabric(dev, cfg, root: str, engine_rows: list) -> dict:
    """Two engines mounted on one fabric directory, each with its own
    registry, serve the six requests of ``phase_engine``; the second's first
    request restores the first's snapshots from the backend.  Tokens must
    equal those of the engine on ``MemorySnapshotStore``."""
    from repro_torch.core import LocalFSBackend, ModuleRegistry
    from repro_torch.models import transformer
    from repro_torch.models.layers import init_params
    from repro_torch.serve import mount_serve_engine

    gen = torch.Generator(device=dev).manual_seed(0)  # phase_engine's weights
    params = init_params(gen, transformer.lm_specs(cfg), cfg.dtype, dev)
    torch.cuda.reset_peak_memory_stats(dev)
    prompts = engine_prompts(cfg.vocab)
    out = {}
    regs = []
    for e in (1, 2):
        reg = ModuleRegistry()
        regs.append(reg)
        engine = mount_serve_engine(LocalFSBackend(root), cfg, params, registry=reg,
                                    max_len=1024, chunk=64, device=dev)
        loads0 = engine.snapshots._m_loads.value
        rows = serve_requests(engine, cfg, prompts, ENGINE_NEW, f"fabric engine {e} req")
        for i, (got, want) in enumerate(zip(rows, engine_rows)):
            check(got["out"] == want["out"],
                  f"fabric engine {e} request {i + 1}: tokens differ from the memory-store "
                  f"engine's")
        print(f"fabric engine {e}: snapshots {engine.snapshots.n_snapshots} loads "
              f"{int(engine.snapshots._m_loads.value - loads0)} saves "
              f"{int(engine.snapshots._m_saves.value)} bytes "
              f"{engine.snapshots.snapshot_bytes()} registry modules {len(reg)}")
        out[e] = {"rows": [{k: v for k, v in r.items() if k != "out"} for r in rows],
                  "snapshots": engine.snapshots.n_snapshots,
                  "loads": int(engine.snapshots._m_loads.value - loads0)}
        del engine
        gc.collect()
    shared = ENGINE_SYSTEM // 64
    first = out[2]["rows"][0]
    check(first["skipped"] == shared and out[2]["loads"] >= 1,
          f"fabric engine 2 request 1: skipped {first['skipped']}, wanted the {shared} shared "
          f"chunks from engine 1's snapshots")
    check(out[1]["rows"][0]["skipped"] == 0, "fabric engine 1 request 1 skipped a chunk")
    check(sorted(regs[0]) == sorted(regs[1]) and len(regs[0]) == shared + len(prompts),
          f"fabric: the registries hold {len(regs[0])} and {len(regs[1])} chunk modules")
    print(f"fabric: engine 2's first request restored {first['skipped']}/{first['n']} chunks "
          f"from engine 1's snapshots: hit prefill_ms {first['prefill_s'] * 1e3:.3f}; engine "
          f"1's first request (cold) prefill_ms {out[1]['rows'][0]['prefill_s'] * 1e3:.3f}")
    return out


# --------------------------------------------------------------------------
CLIENT_CH4 = {"PT": (51.97, 67), "TSAR": (65.16, 4302), "TSPAR": (51.97, 131),
              "TSFR": (12.2, 447)}  # LR_pct and stored of each policy on the Ch. 4 corpus
CLIENT_CH5_PT = (49.81, 91)  # PT on the Ch. 5 corpus with tool states


def metric_total(doc: dict, name: str) -> float:
    """The sum of a counter's series in a metrics document, the process's
    own series only (the servers' carry a ``shard`` label)."""
    entry = doc.get(name, {"series": []})
    return sum(s["value"] or 0 for s in entry["series"] if "shard" not in s["labels"])


def client_evaluation() -> dict:
    """The thesis's replay evaluation (host only): every policy on the
    Ch. 4 corpus, and on the Ch. 5 corpus with tool states."""
    from repro_torch.core import evaluate_all, galaxy_ch4_corpus, galaxy_ch5_corpus

    out: dict = {}
    for label, corpus, with_state in (("ch4", galaxy_ch4_corpus, False),
                                      ("ch5", galaxy_ch5_corpus, True)):
        t0 = time.perf_counter()
        reports = evaluate_all(corpus(), with_state=with_state)
        secs = time.perf_counter() - t0
        rows = {name: r.row() for name, r in reports.items()}
        for row in rows.values():
            print(f"client evaluation {label} (host): {json.dumps(row)}")
        print(f"client evaluation {label} (host): corpus and evaluate_all in {secs:.3f} s")
        out[label] = {"rows": rows, "seconds": secs}
    ch4, ch5 = out["ch4"]["rows"], out["ch5"]["rows"]
    check(45 <= ch4["PT"]["LR_pct"] <= 60 and 35 <= ch5["PT"]["LR_pct"] <= 60,
          f"client evaluation: PT LR {ch4['PT']['LR_pct']} (ch4), {ch5['PT']['LR_pct']} (ch5)")
    got = {n: (r["LR_pct"], r["stored"]) for n, r in ch4.items()}
    check(got == CLIENT_CH4 and (ch5["PT"]["LR_pct"], ch5["PT"]["stored"]) == CLIENT_CH5_PT,
          f"client evaluation: ch4 {got}, ch5 PT {ch5['PT']}; the thesis's rows are "
          f"{CLIENT_CH4} and {CLIENT_CH5_PT}")
    return out


def client_local(dev, cfg, root: str) -> dict:
    """A local ``Client`` with PT runs the workflow phase's pipeline as a
    ``WorkflowSpec``: cold (eval start 0), again with eval start 2 (the
    prefix up to train repeats, so PT stores it), then eval start 4, which
    skips the stored prefix.  Then the Ch. 4 corpus is replayed into the
    same policy, and ``recommend`` and ``find`` must name the stored prefix."""
    from repro_torch.api import Client, WorkflowSpec
    from repro_torch.core import galaxy_ch4_corpus
    from repro_torch.data.pipeline import make_corpus_blob

    witness: list = []
    computes: dict = {}
    reg = wf_registry(cfg, dev, witness, [], computes)
    blob = make_corpus_blob(WF_CORPUS_BYTES, seed=0, device=dev)
    out: dict = {"runs": {}}
    with Client(root, policy="PT", registry=reg, codec="none", device=dev) as client:
        train_key = WorkflowSpec.from_steps("corpus", wf_steps(0)).prefix_keys(reg)[3]
        results = {}
        for label, start in (("cold", 0), ("again", 2), ("reuse", 4)):
            spec = WorkflowSpec.from_steps("corpus", wf_steps(start), f"client {label}")
            n_train = computes.get("train", 0)
            r = client.run(WorkflowSpec.from_json(spec.to_json()), blob)
            results[label] = r
            row = wf_report(f"client {label} eval start {start}", r, client.store, dev)
            row["trained"] = computes.get("train", 0) - n_train
            out["runs"][label] = row
        check(results["cold"].n_skipped == 0 and results["again"].n_skipped == 0
              and train_key in results["again"].stored_keys,
              f"client: skipped {results['cold'].n_skipped}, {results['again'].n_skipped}; "
              f"stored {results['again'].stored_keys}, wanted the train prefix by the second run")
        check(results["reuse"].n_skipped == 4 and out["runs"]["reuse"]["trained"] == 0,
              f"client reuse: skipped {results['reuse'].n_skipped}, train ran "
              f"{out['runs']['reuse']['trained']} time(s); wanted tokenize to train skipped")
        rec = client.store.records[train_key]
        print(f"client: PT stored the train prefix ({rec.nbytes_raw} B) in the second run: "
              f"save_s {results['again'].store_seconds:.6f}; the third run loaded it in "
              f"load_s {results['reuse'].load_seconds:.6f}; run seconds "
              f"{[round(r.total_seconds, 6) for r in results.values()]}")
        t0 = time.perf_counter()
        n = client.replay(galaxy_ch4_corpus())
        replay_s = time.perf_counter() - t0
        partial = WorkflowSpec.from_steps("corpus", wf_steps(0)[:4])
        recommend_ms = []
        for _ in range(5):
            t0 = time.perf_counter()
            report = client.recommend(partial)
            recommend_ms.append((time.perf_counter() - t0) * 1e3)
        best = report.best_reuse
        print(f"client: replayed {n} pipelines in {replay_s:.3f} s; recommend of the partial "
              f"spec (tokenize..train) ms {[round(x, 3) for x in recommend_ms]}: "
              f"{[s.describe() for s in report.reusable_prefixes]}; next "
              f"{[s.describe() for s in report.next_modules]}")
        check(best is not None and best.prefix.key(True) == train_key and best.stored,
              f"client recommend: best reuse {best and best.describe()}, wanted the stored "
              f"train prefix")
        check(bool(report.next_modules) and report.best_next.module_id == "eval",
              f"client recommend: next modules {[s.module_id for s in report.next_modules]}")
        hits = client.find(module="train")
        print(f"client find(module='train'): {[(h.key, h.nbytes, h.n_loads) for h in hits]}")
        check([h.key for h in hits] == [train_key] and client.store.has(train_key),
              f"client find: {[h.key for h in hits]}, wanted only the stored train prefix")
        out.update(replayed=n, replay_s=replay_s, recommend_ms=recommend_ms,
                   train_bytes=rec.nbytes_raw, save_s=results["again"].store_seconds,
                   load_s=results["reuse"].load_seconds,
                   run_s={k: r.total_seconds for k, r in results.items()},
                   train_calls=computes.get("train", 0), eval_calls=computes.get("eval", 0))
        del results
    del blob
    gc.collect()
    torch.cuda.empty_cache()
    return out


def client_cluster(dev, cfg, root: str, engine_rows: list) -> dict:
    """Three store servers in child processes, two clients mounted on all
    three (replication 2, a cache tier each) serving the six requests
    through ``Client.serve_engine``; then the primary of the shared prefix's
    snapshot is killed and one more request restores from its replica."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.api import Client
    from repro_torch.models import transformer
    from repro_torch.models.layers import init_params

    params = init_params(torch.Generator(device=dev).manual_seed(0), transformer.lm_specs(cfg),
                         cfg.dtype, dev)  # phase_engine's weights
    prompts = engine_prompts(cfg.vocab)
    shared = ENGINE_SYSTEM // 64
    roots = [os.path.join(root, f"shard{i}") for i in range(3)]
    with ThreadPoolExecutor(3) as pool:
        started = list(pool.map(start_store_server, roots))
    procs = [p for p, _ in started]
    url = ",".join(u for _, u in started)
    clients: list = []
    out: dict = {}
    try:
        engines = []
        for e in (1, 2):
            clients.append(Client(store_url=url, replication=2, cache_bytes=STORE_CACHE_BYTES,
                                  client_id=f"client-{e}", device=dev))
            engines.append(clients[-1].serve_engine(cfg, params, max_len=1024, chunk=64,
                                                    device=dev))
            check(engines[-1].snapshots.catalog is clients[-1].catalog,
                  "client cluster: the engine's snapshot store has no catalog")
        print(f"client cluster: {url} (three python -m repro_torch.net.serve, pids "
              f"{[p.pid for p in procs]}); two clients, replication 2, cache tier "
              f"{STORE_CACHE_BYTES} B each")
        rows: dict[int, list] = {}
        restore: dict[str, float] = {}
        for e, engine in zip((1, 2), engines):
            load_s = lambda: engine.snapshots._m_load_s.unlabeled.sum
            cache = engine.snapshots.backend
            rows[e] = []
            for i, prompt in enumerate(prompts):
                before = (load_s(), cache.misses)
                rows[e] += serve_requests(engine, cfg, [prompt], ENGINE_NEW,
                                          f"client engine {e} request {i + 1}, call")
                rows[e][-1]["restore_ms"] = (load_s() - before[0]) * 1e3
                rows[e][-1]["misses"] = cache.misses - before[1]
            for i, (got, want) in enumerate(zip(rows[e], engine_rows)):
                check(got["out"] == want["out"],
                      f"client engine {e} request {i + 1}: tokens differ from the "
                      f"memory-store engine's")
            print(f"client engine {e}: skipped {[r['skipped'] for r in rows[e]]} stored "
                  f"{[r['stored'] for r in rows[e]]} restore_ms "
                  f"{[round(r['restore_ms'], 3) for r in rows[e]]} tier misses "
                  f"{[r['misses'] for r in rows[e]]}")
        restore["cold_ms"] = rows[2][0]["restore_ms"]
        restore["warm_ms"] = rows[2][1]["restore_ms"]
        check(rows[2][0]["misses"] > 0 and rows[2][1]["misses"] == 0,
              f"client cluster: engine 2's tier misses {[r['misses'] for r in rows[2][:2]]}, "
              f"wanted a cold restore over the wire and then a warm one from the tier")
        elections = sum(metric_total(c.metrics_doc(), "repro_singleflight_remote_leads_total")
                        for c in clients)
        leads = [engine.flight.remote_leads for engine in engines]
        stored = [r["stored"] for e in (1, 2) for r in rows[e]]
        print(f"client cluster: elections {elections} (metrics_doc), led by engine "
              f"{leads}; snapshots stored {stored}")
        check(elections == 1 and leads == [1, 0] and sum(stored) == 1,
              f"client cluster: {elections} elections, leads {leads}, stored {stored}; wanted "
              f"one, by engine 1")
        check([r["skipped"] for r in rows[1][2:] + rows[2]] == [shared] * 10,
              "client cluster: a request after the election prefilled the shared prefix")

        key = next(iter(engines[1].snapshots._records))
        remote = clients[1]._remote
        primary = remote.shard_for(key)
        replicas = remote._replicas(key)
        victim = next(i for i, (_, u) in enumerate(started) if u.endswith(primary))
        procs[victim].kill()
        procs[victim].wait()
        engines[1].snapshots.backend.invalidate(key)  # the restore must cross the wire
        before = (remote.failover_reads, engines[1].snapshots._m_load_s.unlabeled.sum)
        row = serve_requests(engines[1], cfg, [prompts[2]], ENGINE_NEW,
                             "client engine 2 after the kill, request 3 again, call")[0]
        failover = remote.failover_reads - before[0]
        restore["failover_ms"] = (engines[1].snapshots._m_load_s.unlabeled.sum - before[1]) * 1e3
        print(f"client cluster: killed the snapshot's primary {primary} (replicas {replicas}); "
              f"request 3 again skipped {row['skipped']}/{row['n']}, failover reads "
              f"{failover}, restore_ms {restore['failover_ms']:.3f}")
        check(row["out"] == engine_rows[2]["out"] and row["skipped"] == shared,
              "client cluster: the request after the kill differs from the memory-store "
              "engine's or prefilled the shared prefix")
        check(failover > 0, "client cluster: no failover read after the primary died")
        hits = clients[1].find(dataset="prompts", any_position=True, limit=100)
        print(f"client cluster find(dataset='prompts'): {[(h.key, h.depth) for h in hits]}")
        check(key in {h.key for h in hits},
              f"client cluster: find did not list the snapshot {key}")
        out = {"restore": restore, "elections": elections, "failover_reads": failover,
               "rows": {e: [{k: v for k, v in r.items() if k != "out"} for r in rows[e]]
                        for e in rows}}
        del engines
    finally:
        for c in clients:
            c.close()
        codes = []
        for proc in procs:
            if proc.poll() is not None:
                continue  # the server killed above
            proc.send_signal(signal.SIGTERM)
            try:
                codes.append(proc.wait(timeout=30))
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
                codes.append(None)
    print(f"client cluster: survivors stopped on SIGTERM, exit codes {codes}")
    check(codes == [0, 0], f"client cluster: survivors' exit codes {codes} after SIGTERM")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_client(dev, engine_rows) -> dict:
    """The front door (``repro_torch.api.Client``) at full TinyLlama-1.1B
    width: the thesis's evaluation, a local client running the workflow
    pipeline, and two clients serving on a three-server cluster."""
    import shutil

    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import ops as decode_ops
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention import reset_launches as reset_flash

    cfg = get_config("tinyllama-1.1b")  # full width, bf16
    out = {"evaluation": client_evaluation()}
    root = tempfile.mkdtemp(prefix="client-")
    torch.cuda.synchronize()
    reset_flash()
    decode_ops.reset_launches()
    try:
        out["local"] = client_local(dev, cfg, os.path.join(root, "local"))
        out["cluster"] = client_cluster(dev, cfg, os.path.join(root, "cluster"), engine_rows)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["flash"] = (flash_attention.launches_fwd, flash_attention.launches_bwd)
    out["decode"] = dict(decode_ops.decode_attention.launches_by_variant)
    loc = out["local"]
    print(f"client: module calls train {loc['train_calls']} eval {loc['eval_calls']}; flash "
          f"launches fwd {out['flash'][0]} bwd {out['flash'][1]}; decode kernels "
          f"{out['decode']}")
    check(out["flash"][1] == cfg.n_layers * WF_STEPS * loc["train_calls"]
          and out["flash"][0] == cfg.n_layers * (WF_STEPS * loc["train_calls"]
                                                 + loc["eval_calls"]),
          f"client: flash launches {out['flash']} for {loc['train_calls']} train and "
          f"{loc['eval_calls']} eval calls")
    check(out["decode"]["fused"] > 0 and out["decode"]["chunk"] > 0
          and out["decode"]["split"] == 0, f"client: decode kernels {out['decode']}")
    return out


# --------------------------------------------------------------------------
# phase: the multi-tenant HTTP gateway over the workflow, and the trace CLI
# --------------------------------------------------------------------------
GW_TOKENS = {"tok-alice": "alice", "tok-bob": "bob"}
GW_BLOB = {"n_bytes": WF_CORPUS_BYTES, "seed": 0}  # the POST's data: ``blob`` draws the corpus
GW_TRAIN_AT = 4  # train's index in gw_steps
GW_PRINT_LINES = 24  # lines of the trace CLI's output printed from each end


def gw_request(base: str, method: str, path: str, token: str | None = None, body=None,
               timeout: float = 600):
    """(status, parsed JSON body, headers) of one HTTP request to the
    gateway; 4xx and 5xx answers are returned, not raised."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(base + path, method=method)
    if token is not None:
        req.add_header("Authorization", f"Bearer {token}")
    data = None
    if body is not None:
        data = json.dumps(body).encode()
        req.add_header("Content-Type", "application/json")
    try:
        with urllib.request.urlopen(req, data=data, timeout=timeout) as resp:
            raw = resp.read()
            is_json = resp.headers.get_content_type() == "application/json"
            return resp.status, (json.loads(raw) if is_json else raw.decode()), dict(resp.headers)
    except urllib.error.HTTPError as e:
        raw = e.read()
        return e.code, (json.loads(raw) if raw else {}), dict(e.headers)


def gw_steps(start: int) -> list:
    """blob -> tokenize -> pack -> split -> train -> eval(start)."""
    return ["blob", *wf_steps(start)]


def gw_registry(cfg, dev, computes: dict):
    """The workflow phase's modules (``wf_registry``) behind a first module,
    ``blob``, that draws the 64 MB corpus on the card from the POST's JSON
    data (a POST cannot carry the tensor; it carries its size and seed).
    ``eval`` returns a list of floats, so that the run document carries it;
    ``pack`` defaults to the workflow's sequence length, so that the chain
    of module names that ``/v1/recommend`` takes resolves to the stored
    prefix's key."""
    from repro_torch.data.pipeline import make_corpus_blob

    reg = wf_registry(cfg, dev, [], [], computes)

    def blob(data):
        computes["blob"] = computes.get("blob", 0) + 1
        return make_corpus_blob(int(data["n_bytes"]), seed=int(data["seed"]), device=dev)

    reg.register_fn("blob", blob)
    evaluate = reg["eval"].fn
    reg["eval"].fn = lambda x, _fn=evaluate, **kw: _fn(x, **kw).tolist()
    reg["pack"].default_params["seq_len"] = WF_SEQ
    return reg


def gw_metric(text: str, name: str) -> float:
    """The sum of a metric's series without a ``shard`` label (this
    process's own) in a Prometheus exposition."""
    total = 0.0
    for line in text.splitlines():
        head, _, value = line.rpartition(" ")
        if (head == name or head.startswith(name + "{")) and "shard=" not in head:
            total += float(value)
    return total


def gateway_runs(dev, cfg, url: str, computes: dict) -> dict:
    """The gateway in this process over a ``Client`` mounted on the store
    server at ``url`` (PT, codec none, the workflow's modules at full
    TinyLlama-1.1B width on the card; one run at a time), driven over HTTP
    on loopback by two tenants, alice and bob."""
    from repro_torch.api import Client, WorkflowSpec
    from repro_torch.gateway import GatewayServer, TenancyPolicy, TokenAuthenticator

    reg = gw_registry(cfg, dev, computes)
    alice, bob = "tok-alice", "tok-bob"
    train_key = WorkflowSpec.from_steps("corpus", gw_steps(0)).with_namespace(
        "shared").prefix_keys(reg)[GW_TRAIN_AT]
    out: dict = {"runs": {}}
    client = Client(store_url=url, policy="PT", codec="none", device=dev, registry=reg,
                    max_concurrent_runs=1)
    gw = GatewayServer(client, TokenAuthenticator(GW_TOKENS), tenancy=TenancyPolicy(("shared",)),
                       max_inflight_per_tenant=1)
    gw.start()

    def body(start: int, namespace: str | None, wait: bool) -> dict:
        spec = WorkflowSpec.from_steps("corpus", gw_steps(start), f"gateway eval {start}")
        doc = {"spec": json.loads(spec.to_json()), "data": GW_BLOB, "wait": wait}
        if namespace:
            doc["namespace"] = namespace
        return doc

    def idle(token: str) -> None:
        # a run's slot is released just after its status turns done
        deadline = time.monotonic() + 60
        while gw.ledger.in_flight(GW_TOKENS[token]) and time.monotonic() < deadline:
            time.sleep(0.01)

    def report(label: str, doc: dict, n_train: int | None) -> dict:
        """One run's line; ``n_train``: train's call count before the run,
        where no other run ran beside it (None where one may have)."""
        res = doc["result"]
        trained = None if n_train is None else computes.get("train", 0) - n_train
        row = {"run_s": res["total_seconds"], "n_skipped": res["n_skipped"],
               "n_computed": res["n_computed"], "trained": trained,
               "stored": res["stored_keys"], "eval_ce": res["output"],
               "namespace": doc["namespace"], "trace_id": doc.get("trace_id")}
        print(f"gateway {label}: {doc['status']} namespace {doc['namespace']} n_skipped "
              f"{res['n_skipped']}/{res['n_nodes']} n_computed {res['n_computed']} train ran "
              f"{row['trained']} run_s {res['total_seconds']:.6f} stored {res['stored_keys']} "
              f"eval_ce {res['output']} trace {row['trace_id']}")
        check(doc["status"] == "done" and res["n_nodes"] == len(gw_steps(0))
              and isinstance(res["output"], list) and len(res["output"]) == WF_EVAL_ROWS
              and all(map(math.isfinite, res["output"])), f"gateway {label}: {doc}")
        out["runs"][label] = row
        return row

    def run_wait(label: str, token: str, start: int, namespace: str | None) -> dict:
        idle(token)
        n_train = computes.get("train", 0)
        st, doc, _ = gw_request(gw.url, "POST", "/v1/workflows", token,
                                body(start, namespace, True))
        check(st == 200, f"gateway {label}: HTTP {st} {doc}")
        return report(label, doc, n_train)

    def wait_done(token: str, run_id: str) -> dict:
        deadline = time.monotonic() + 600
        while time.monotonic() < deadline:
            st, doc, _ = gw_request(gw.url, "GET", f"/v1/runs/{run_id}", token)
            check(st == 200, f"gateway GET run {run_id}: HTTP {st} {doc}")
            if doc["status"] in ("done", "failed"):
                return doc
            time.sleep(0.05)
        raise CheckFailed(f"gateway: run {run_id} never finished")

    try:
        print(f"gateway: {gw.url} over the store server {url}; tenants {sorted(GW_TOKENS.values())}"
              f", shared namespace 'shared', one run in flight per tenant, PT, codec none")
        cold = run_wait("alice shared cold (eval start 0)", alice, 0, "shared")
        check(cold["n_skipped"] == 0 and cold["trained"] == 1, f"gateway cold: {cold}")

        # alice's second run trains and stores the prefix; meanwhile her
        # next POST is over her quota and bob's is accepted (it waits for
        # the one run slot, then runs in his private namespace)
        n_train = computes.get("train", 0)
        st, a2, _ = gw_request(gw.url, "POST", "/v1/workflows", alice, body(2, "shared", False))
        check(st == 202, f"gateway alice again: HTTP {st} {a2}")
        t0 = time.perf_counter()
        st429, rej, hdrs = gw_request(gw.url, "POST", "/v1/workflows", alice,
                                      body(4, "shared", False))
        quota_ms = (time.perf_counter() - t0) * 1e3
        st, bp, _ = gw_request(gw.url, "POST", "/v1/workflows", bob, body(0, None, False))
        print(f"gateway: alice's POST while her run {a2['run_id']} is {a2['status']}: HTTP "
              f"{st429} {rej.get('error')} Retry-After {hdrs.get('Retry-After')} in "
              f"{quota_ms:.3f} ms; bob's POST: HTTP {st} namespace {bp.get('namespace')}")
        check(st429 == 429 and rej.get("error") == "quota_exceeded"
              and int(hdrs.get("Retry-After", 0)) >= 1,
              f"gateway: alice's POST over quota got HTTP {st429} {rej} {hdrs}")
        check(st == 202 and bp["namespace"] == "tenant:bob", f"gateway bob private: {st} {bp}")
        out["quota"] = {"status": st429, "error": rej["error"],
                        "retry_after": int(hdrs["Retry-After"]), "ms": quota_ms}

        # alice's run to its terminal event, over the chunked event stream
        t0 = time.perf_counter()
        st, text, hdrs = gw_request(gw.url, "GET", f"/v1/runs/{a2['run_id']}/events", alice)
        events = [json.loads(line) for line in text.splitlines()]
        names = [e["event"] for e in events]
        print(f"gateway: GET /v1/runs/{a2['run_id']}/events ({hdrs.get('Content-Type')}) "
              f"{names} in {(time.perf_counter() - t0) * 1e3:.3f} ms")
        check(st == 200 and names[0] == "accepted" and names[-1] == "finished"
              and all(e["run_id"] == a2["run_id"] for e in events), f"gateway events: {events}")
        out["events"] = names
        again = report("alice shared again (eval start 2)", wait_done(alice, a2["run_id"]),
                       None)
        check(again["n_skipped"] == 0 and train_key in again["stored"],
              f"gateway again: {again}; wanted the train prefix {train_key} stored")
        priv = report("bob private (eval start 0)", wait_done(bob, bp["run_id"]), None)
        check(priv["n_computed"] == len(gw_steps(0)) and priv["n_skipped"] == 0
              and computes.get("train", 0) - n_train == 2,
              f"gateway bob private: {priv}, train calls {computes.get('train', 0) - n_train} "
              f"in the two runs; wanted every module computed, after the shared prefix was "
              f"stored")

        reuse = run_wait("alice shared reuse (eval start 4)", alice, 4, "shared")
        shared = run_wait("bob shared (eval start 6)", bob, 6, "shared")
        for label, r in (("alice reuse", reuse), ("bob shared", shared)):
            check(r["n_skipped"] == GW_TRAIN_AT + 1 and r["trained"] == 0,
                  f"gateway {label}: skipped {r['n_skipped']}, train ran {r['trained']}; "
                  f"wanted blob..train skipped")
        out["trace_id"] = shared["trace_id"]

        t0 = time.perf_counter()
        st, rec, _ = gw_request(
            gw.url, "GET", "/v1/recommend?dataset=corpus&modules=blob,tokenize,pack,split,"
            "train&namespace=shared", bob)
        rec_ms = (time.perf_counter() - t0) * 1e3
        print(f"gateway: GET /v1/recommend (blob..train, shared) in {rec_ms:.3f} ms: reusable "
              f"{rec.get('reusable_prefixes')} next {rec.get('next_modules')}")
        best = (rec.get("reusable_prefixes") or [{}])[0]
        check(st == 200 and best.get("modules") == ["blob", "tokenize", "pack", "split", "train"]
              and best.get("stored") is True,
              f"gateway recommend: {rec}; wanted the stored train prefix")
        st, arts, _ = gw_request(gw.url, "GET", "/v1/artifacts?module=train&namespace=shared",
                                 bob)
        listed = [(a["key"], a["nbytes"], a["n_loads"], a["compute_s"])
                  for a in arts.get("artifacts", [])]
        print(f"gateway: GET /v1/artifacts (train, shared) (key, bytes, loads, compute_s: the "
              f"recompute seconds a hit's saving is set against): {listed}")
        check(st == 200 and [a["key"] for a in arts["artifacts"]] == [train_key],
              f"gateway artifacts: {arts}")
        out["prefix_compute_s"] = arts["artifacts"][0]["compute_s"]
        stats = {}
        for name, token in (("alice", alice), ("bob", bob)):
            st, doc, _ = gw_request(gw.url, "GET", "/v1/stats", token)
            check(st == 200, f"gateway stats: HTTP {st}")
            stats[name] = doc["tenant"][name]
        print(f"gateway: GET /v1/stats tenants {stats}; gateway counts {doc['gateway']}; "
              f"fabric runs {doc['fabric']['runs']} reuse_rate {doc['fabric']['reuse_rate']}")
        check(stats["alice"]["runs_total"] == 3 and stats["bob"]["runs_total"] == 2
              and stats["alice"]["rejected"] == 1 and stats["alice"]["bytes_stored"] > 0,
              f"gateway stats: {stats}")
        st, text, _ = gw_request(gw.url, "GET", "/metrics")
        saved = gw_metric(text, "repro_reuse_seconds_saved_total")
        hits = gw_metric(text, "repro_reuse_hits_total")
        print(f"gateway: GET /metrics ({len(text)} bytes): repro_reuse_seconds_saved_total "
              f"{saved} repro_reuse_hits_total {hits}")
        check(st == 200 and hits >= 2, f"gateway metrics: reuse hits {hits}")
        out.update(recommend_ms=rec_ms, stats=stats, metrics={"reuse_seconds_saved": saved,
                                                              "reuse_hits": hits})

        # drain: a training run in flight, then the two-phase shutdown
        idle(alice)
        n_train = computes.get("train", 0)
        st, dr, _ = gw_request(gw.url, "POST", "/v1/workflows", alice, body(0, None, False))
        check(st == 202, f"gateway drain run: HTTP {st} {dr}")
        deadline = time.monotonic() + 120
        while computes.get("train", 0) == n_train and time.monotonic() < deadline:
            time.sleep(0.01)
        check(computes.get("train", 0) > n_train, "gateway drain: train never started")
        t0 = time.perf_counter()
        gw.begin_shutdown()
        st503, doc503, hdrs = gw_request(gw.url, "POST", "/v1/workflows", bob,
                                         body(8, "shared", False))
        st, health, _ = gw_request(gw.url, "GET", "/healthz")
        print(f"gateway drain: POST while draining: HTTP {st503} {doc503.get('error')} "
              f"Retry-After {hdrs.get('Retry-After')}; /healthz {health}")
        check(st503 == 503 and doc503.get("error") == "draining" and "Retry-After" in hdrs
              and health.get("draining") is True, f"gateway drain: {st503} {doc503} {health}")
        drained = report("alice private, drained (eval start 0)",
                         wait_done(alice, dr["run_id"]), n_train)
        gw.close()
        drain_s = time.perf_counter() - t0
        print(f"gateway drain: the run in flight ended {drained['n_computed']} computed; close() "
              f"returned {drain_s:.3f} s after begin_shutdown()")
        check(drained["trained"] == 1, f"gateway drain: {drained}")
        out["drain"] = {"status": st503, "error": doc503["error"], "close_s": drain_s}
    finally:
        gw.close()
        client.close()
    return out


def gateway_cli(root: str) -> dict:
    """A start/SIGTERM smoke of the CLI: ``python -m repro_torch.gateway.serve
    --device cuda --demo-modules`` in a child process, one demo workflow
    through it (its modules compute host lists and load nothing stored, so
    no tensor reaches the card), then SIGTERM, which must end it with exit
    code 0."""
    env = dict(os.environ, PYTHONPATH=os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                                   "src"))
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.gateway.serve", "--device", "cuda",
         "--demo-modules", "--port", "0", "--token", "t=alice", "--root",
         os.path.join(root, "cli")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
    try:
        line = proc.stdout.readline()
        check("gateway listening on http://" in line, f"gateway CLI: first line {line!r}")
        base = line.split("listening on ")[1].split()[0]
        start_s = time.perf_counter() - t0
        spec = {"dataset_id": "nums", "nodes": [
            {"id": "normalize", "module": "normalize"},
            {"id": "scale", "module": "scale", "after": ["normalize"]},
            {"id": "stats", "module": "stats", "after": ["scale"]}]}
        st, doc, _ = gw_request(base, "POST", "/v1/workflows", "t",
                                {"spec": spec, "data": [1, 2, 3], "wait": True}, timeout=60)
        check(st == 200 and doc["status"] == "done", f"gateway CLI run: HTTP {st} {doc}")
        proc.send_signal(signal.SIGTERM)
        text, _ = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    print(f"gateway CLI: {base} (python -m repro_torch.gateway.serve --device cuda, pid "
          f"{proc.pid}) up in {start_s:.3f} s; demo run {doc['result']['output']}; exit code "
          f"{proc.returncode} after SIGTERM")
    check(proc.returncode == 0 and "gateway stopped" in text,
          f"gateway CLI: exit code {proc.returncode}: {text[-2000:]}")
    return {"start_s": start_s, "rc": proc.returncode}


def gateway_trace(trace_dir: str, trace_id: str) -> dict:
    """``python -m repro_torch.obs.trace --dir D --list``, then the same for
    bob's shared run: a tree that spans the gateway's process and the store
    server's, with its critical path and reuse rollup."""
    from repro_torch.obs.trace import build_trace, critical_path, reuse_rollup
    from repro_torch.obs.tracing import iter_spans

    env = dict(os.environ, PYTHONPATH=os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                                   "src"))
    outs = {}
    for args in (["--list"], [trace_id]):
        got = subprocess.run([sys.executable, "-m", "repro_torch.obs.trace", "--dir", trace_dir,
                              *args], capture_output=True, text=True, env=env, timeout=120)
        check(got.returncode == 0, f"trace CLI {args}: exit code {got.returncode} {got.stderr}")
        lines = got.stdout.splitlines()
        shown = lines if len(lines) <= 2 * GW_PRINT_LINES else (
            lines[:GW_PRINT_LINES] + [f"... {len(lines) - 2 * GW_PRINT_LINES} lines ..."]
            + lines[-GW_PRINT_LINES:])
        print(f"trace CLI {' '.join(args)}: {len(lines)} lines")
        for line in shown:
            print(f"  | {line}")
        outs[args[0]] = got.stdout
    check(trace_id in outs["--list"], f"trace CLI: {trace_id} not listed")
    tree = build_trace(list(iter_spans(trace_dir)), trace_id)
    path = critical_path(tree)
    roll = reuse_rollup(tree)
    spans = tree["spans"]
    print(f"trace {trace_id}: {len(spans)} spans, processes {tree['processes']}; critical path "
          f"{[(spans[s]['name'], spans[s]['svc'], round(spans[s]['dur'] * 1e3, 3)) for s in path]}"
          f"; reuse rollup {roll}")
    check({"gateway", "store"} <= set(tree["services"]) and len(tree["processes"]) >= 2,
          f"trace {trace_id}: services {tree['services']} processes {tree['processes']}")
    check("critical path" in outs[trace_id] and "reuse:" in outs[trace_id],
          "trace CLI: no critical path or reuse line")
    # where a hit's load goes: the store.get span against the read_blob
    # round trips under it (the gateway's side) and the store server's reads
    gets = [s for s in spans.values() if s["name"] == "store.get"
            and (s.get("attrs") or {}).get("source") == "store"]
    check(len(gets) == 1, f"trace {trace_id}: {len(gets)} store.get spans that loaded, wanted 1")
    under = tree["children"].get(gets[0]["span"], [])
    load = {"store_get_s": gets[0]["dur"],
            "read_blob_rpc_s": sum(s["dur"] for s in under if s["name"] == "rpc"
                                   and (s.get("attrs") or {}).get("op") == "read_blob"),
            "store_read_blob_s": sum(s["dur"] for s in under if s["name"] == "store.read_blob"),
            "saved_s": (gets[0].get("attrs") or {}).get("saved_s")}
    print(f"trace {trace_id}: the prefix's load: store.get {load['store_get_s']:.6f} s, of it "
          f"read_blob round trips {load['read_blob_rpc_s']:.6f} s (the store server's reads "
          f"{load['store_read_blob_s']:.6f} s); saved_s {load['saved_s']}")
    return {"spans": len(spans), "processes": [list(p) for p in tree["processes"]],
            "critical_path": [spans[s]["name"] for s in path], "rollup": roll, "load": load}


def phase_gateway(dev) -> dict:
    """The multi-tenant HTTP gateway (``repro_torch.gateway``) over the
    workflow at full TinyLlama-1.1B width: one port store server as a child
    process (``python -m repro_torch.net.serve --trace-dir D``), the gateway
    in this process over a ``Client`` mounted on it (tracing into the same
    directory), two tenants driving it over HTTP on loopback (shared
    prefixes reused across tenants, a private namespace computed in full,
    a 429 over quota, the event stream, recommend, stats, artifacts,
    metrics, the drain's 503); then a start/SIGTERM smoke of the gateway's
    CLI with ``--device cuda``; then ``python -m repro_torch.obs.trace``
    over the spans of both processes, with the stored prefix's load split
    under its ``store.get`` span.  Tracing is off again when the phase
    ends."""
    import shutil

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention import reset_launches as reset_flash
    from repro_torch.obs.tracing import configure_tracing

    cfg = get_config("tinyllama-1.1b")  # full width, bf16
    root = tempfile.mkdtemp(prefix="gateway-")
    trace_dir = os.path.join(root, "traces")
    computes: dict = {}
    t0 = time.perf_counter()
    try:
        configure_tracing(trace_dir, "gateway")
        proc, url = start_store_server(os.path.join(root, "store"), trace_dir)
        try:
            torch.cuda.synchronize()
            reset_flash()
            out = gateway_runs(dev, cfg, url, computes)
            out["flash"] = (flash_attention.launches_fwd, flash_attention.launches_bwd)
        finally:
            proc.send_signal(signal.SIGTERM)
            try:
                rc = proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
                rc = None
        check(rc == 0, f"gateway: the store server's exit code {rc} after SIGTERM")
        out["cli"] = gateway_cli(root)
    finally:
        configure_tracing(None)
    out["wall_s"] = time.perf_counter() - t0
    try:
        out["trace"] = gateway_trace(trace_dir, out["trace_id"])
    finally:
        shutil.rmtree(root, ignore_errors=True)
    n_train, n_eval = computes.get("train", 0), computes.get("eval", 0)
    print(f"gateway: module calls {computes}; flash launches fwd {out['flash'][0]} bwd "
          f"{out['flash'][1]}")
    check(out["flash"][1] == cfg.n_layers * WF_STEPS * n_train
          and out["flash"][0] == cfg.n_layers * (WF_STEPS * n_train + n_eval),
          f"gateway: flash launches {out['flash']} for {n_train} train and {n_eval} eval calls")
    out.update(train_calls=n_train, eval_calls=n_eval)
    gc.collect()
    torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------------------
# phase: the reference's LM serve cells at the cuts one card holds
# --------------------------------------------------------------------------
LM_CELLS = (("tinyllama-1.1b", "prefill_32k"), ("tinyllama-1.1b", "decode_32k"),
            ("gemma3-4b", "prefill_32k"), ("gemma3-4b", "decode_32k"),
            ("gemma3-4b", "long_500k"), ("deepseek-7b", "prefill_32k"),
            ("deepseek-7b", "decode_32k"), ("qwen2-moe-a2.7b", "prefill_32k"),
            ("qwen2-moe-a2.7b", "decode_32k"), ("deepseek-v2-236b", "prefill_32k"),
            ("deepseek-v2-236b", "decode_32k"), ("deepseek-v2-236b", "long_500k"))
# train_4k through each
LM_TRAIN_CELLS = ("tinyllama-1.1b", "gemma3-4b", "deepseek-7b", "qwen2-moe-a2.7b",
                  "deepseek-v2-236b")
# the keys from which the planted controls of the train cells drop the
# backward's gradient: every train step on the card before these cells
# stopped at S 2,048
LM_TRAIN_CUT = 2048
LM_GRAD_TOL = 5e-2  # the step's gradient against the fp32 oracle's, as family_checks holds it
LM_CELL_STEPS = 3  # timed, after one warm-up; one more runs under the profiler
LM_BLOCK = 256  # query rows of each block on which the plain version checks the flash forward
LM_CHECK_LAYERS = 2  # the decode cells' whole step card against CPU: one local, one global
LM_CHECK_LAYERS_MLA = 1  # deepseek-v2's: two of its layers take about 36 GB of host memory in fp32
LM_CHECK_BATCH = 2
LM_PEAK_TOL = 0.01  # a cell step's own peak against the dry-run's reckoning
LM_ORACLE_HEADS = 32  # query heads a group of the fp32 oracle: MLA's 128 at S 4,096 take 8.6 GB
LM_MOE_C = {"qwen2-moe-a2.7b": 86, "deepseek-v2-236b": 48}  # slots an expert in 1,024 tokens
LM_MOE_DECODE_C = 4  # capacity's floor: a decode step's group is its batch
LM_CHECK_TOL = 5e-2  # of the largest |logit|, as tests/test_torch_train.py holds bf16
LM_CACHE_STD = 0.1  # make_batch's N(0, 0.1^2) draw
# the spread of the scores in the attention checks: a few of the 32,768 or
# 524,288 keys take the softmax, so an output is at the values' scale and a
# dropped or misplaced key shows (at a spread of 0.1 the softmax is nearly
# flat and every output is about the values' mean)
LM_KEY_SPREAD = 4.0
LM_PATH = "LM serve cells"


def lm_fit(arch: str, name: str) -> tuple:
    """(the dry-run's cut of one LM cell under FIT_BYTES, the seconds its
    tracing took): ``dryrun.fit``'s result, or for ``train_4k``
    ``dryrun.fit_train``'s remat and fits.  On the CPU alone (meta
    tensors), so a worker process can run it (``LMFits``)."""
    on_src_path()
    from repro_torch.configs import get_shapes
    from repro_torch.launch import dryrun

    published = next(c for c in get_shapes(arch) if c.name == name)
    t0 = time.perf_counter()
    fit = (dryrun.fit_train if name == "train_4k" else dryrun.fit)(arch, published, FIT_BYTES)
    return fit, time.perf_counter() - t0


def on_src_path() -> None:
    """``src/`` beside this file on ``sys.path``: the package's home, in this
    process or a spawned one (which unpickles ``repro_torch`` objects)."""
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src")
    if src not in sys.path:
        sys.path.insert(0, src)


class LMFits:
    """Every LM cell's ``lm_fit``, traced in one spawned worker process while
    the earlier phases hold the card: the MoE and MLA cells' traces take tens
    of seconds each (deepseek-v2's ``train_4k`` searches the depth under both
    remats).  ``all`` waits for every cell's, then stops the worker (as
    ``close`` does at exit), so no other process or thread of this one runs
    while the cells are timed."""

    def __init__(self):
        import atexit
        import multiprocessing

        on_src_path()  # this process unpickles the worker's results
        self.pool = multiprocessing.get_context("spawn").Pool(1)
        keys = (*LM_CELLS, *((arch, "train_4k") for arch in LM_TRAIN_CELLS))
        self.results = {key: self.pool.apply_async(lm_fit, key) for key in keys}
        atexit.register(self.close)

    def all(self) -> dict:
        try:
            return {key: r.get() for key, r in self.results.items()}
        finally:
            self.close()

    def close(self) -> None:
        self.pool.terminate()
        self.pool.join()


def lm_params(dev, cfg, seed: int) -> dict:
    """Random bf16 weights from a seeded CUDA generator, the attention
    projections at their true fan-in (``at_true_fan_in``).  ``init_params``
    draws a leaf in fp32, then casts it: where the bf16 weights and the
    largest leaf's fp32 draw would pass FIT_BYTES (deepseek-v2's routed
    experts at 9 layers draw 45 GB in fp32), each stacked layer leaf is
    drawn a layer at a time into its bf16 stack."""
    from repro_torch.models import transformer
    from repro_torch.models.layers import abstract_params, init_params

    specs = transformer.lm_specs(cfg)
    gen = torch.Generator(device=dev).manual_seed(seed)
    sizes = [math.prod(s.shape) for s in leaves(specs)]
    isz = torch.finfo(cfg.dtype).bits // 8
    if sum(sizes) * isz + 4 * max(sizes) <= FIT_BYTES:
        return at_true_fan_in(init_params(gen, specs, cfg.dtype, dev), cfg)
    params = init_params(gen, {k: v for k, v in specs.items() if k != "layers"}, cfg.dtype, dev)
    params["layers"] = abstract_params(specs["layers"], cfg.dtype, dev)
    one = transformer.lm_specs(dataclasses.replace(cfg, n_layers=1))["layers"]
    for i in range(cfg.n_layers):  # a leaf of a layer at a time: 7 GB at most beside the stacks
        for dst, spec in zip(leaves(params["layers"]), leaves(one)):
            dst[i].copy_(init_params(gen, spec, cfg.dtype, dev)[0])
    return at_true_fan_in(params, cfg)


def lm_check_layers(cfg) -> list[tuple[int, int | None]]:
    """(layer, window) of the first local layer and the first global one
    (one layer where every layer is global)."""
    from repro_torch.models import transformer

    picked = {}
    for i, w in enumerate(transformer._layer_windows(cfg)):
        picked.setdefault(w is None, (i, w))
    return [picked[g] for g in (False, True) if g in picked]


def lm_widths(cfg) -> tuple[int, int, int, int]:
    """(Hq, Hkv, dh, dv) of a cell's flash calls: MLA's keys are nope + rope
    wide (``head_dim``) and its values ``v_head_dim``."""
    dv = cfg.head_dim if cfg.mla is None else cfg.mla.v_head_dim
    return cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, dv


def lm_moe_groups(cfg, n_tokens: int, decode: bool, label: str) -> tuple | None:
    """``groups()`` (G, g, C) of an MoE step over ``n_tokens``, checked:
    groups of 1,024 tokens with LM_MOE_C slots an expert (prefill, train),
    or one group of the batch at capacity's floor (decode)."""
    if cfg.moe is None:
        return None
    from repro_torch.models import transformer
    from repro_torch.models.moe import groups

    got = groups(n_tokens, transformer._moe_dims(cfg))
    want = ((1, n_tokens, LM_MOE_DECODE_C) if decode
            else (n_tokens // 1024, 1024, LM_MOE_C[cfg.name]))
    check(got == want, f"{label}: MoE groups {got}, wanted {want}")
    return got


@contextlib.contextmanager
def patched_route(route):
    """``moe.route`` replaced by ``route`` inside (nothing where None)."""
    from repro_torch.models import moe

    inner = moe.route
    moe.route = route or inner
    try:
        yield
    finally:
        moe.route = inner


@contextlib.contextmanager
def counted_drops():
    """``moe.route`` counting the routed (token, k) pairs inside and those
    capacity dropped, as ``serve_engine`` counts them: yields [dropped,
    routed], filled at the exit (one read of the device)."""
    from repro_torch.models import moe

    inner, calls, out = moe.route, [], [0, 0]

    def counted(x, router, dims):
        r = inner(x, router, dims)
        calls.append(((r[2] < 0).sum(), r[2].numel()))
        return r

    with patched_route(counted):
        yield out
    if calls:
        out[:] = [int(torch.stack([d for d, _ in calls]).sum()), sum(n for _, n in calls)]


def mla_latent_scale(params, cfg, tokens, cache, cache_len) -> tuple[float, float]:
    """(the spread of layer 0's absorbed scores over each sequence's live
    cache rows, as drawn; the factor on the latent and rope rows that takes
    it to LM_KEY_SPREAD): the scores are linear in those rows.  The spread is
    the scores' standard deviation over heads and keys, in fp32, averaged
    over the sequences."""
    from repro_torch.models.attention import _mla_query
    from repro_torch.models.layers import rms_norm

    m = cfg.mla
    lp = params["layers"]
    ap = {k: w[0] for k, w in lp["attn"].items()}
    h = rms_norm(params["embed"][tokens].to(cfg.dtype), lp["ln1"][0])
    q_nope, q_rope = _mla_query(h, ap, m.nope_head_dim, cache_len[:, None].long(),
                                cfg.rope_theta)
    q_lat = torch.einsum("bshe,rhe->bshr", q_nope, ap["w_uk"]).float()
    stds = []
    for b, n in enumerate(cache_len.tolist()):
        s = (q_lat[b, 0] @ cache["c_kv"][0, b, :n].float().T
             + q_rope[b, 0].float() @ cache["k_rope"][0, b, :n].float().T)
        stds.append((s / math.sqrt(m.nope_head_dim + m.rope_head_dim)).std().item())
    spread = sum(stds) / len(stds)
    return spread, LM_KEY_SPREAD / spread


def lm_flash_check(dev, cfg, B: int, S: int, window: int | None, label: str) -> dict:
    """The flash forward at the cell's shape (random q, k, v from a seeded
    CUDA generator, causal, ``window``) against the plain version on three
    blocks of LM_BLOCK query rows of every sequence (the first, one in the
    middle, the last), each computed in fp32 as ``decode_attention`` with
    ``q_start`` at the block's first row over the keys up to its last: the
    plain attention of the whole S does not fit ([B, H, S, S] scores).
    q is drawn at LM_KEY_SPREAD, k and v unit normal, so the scores spread
    by LM_KEY_SPREAD and each output row is at the values' scale.  Two
    planted wrong outputs must fail the same check: zeros, and each middle
    and last block attending only to its own 256 keys (every earlier key
    dropped).  v is ``dv`` wide (MLA's 128 beside keys of 192).  Times: the
    kernel, the plain version on one last block, SDPA."""
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.models.attention import decode_attention

    (Hq, Hkv, dh, dv), bf16 = lm_widths(cfg), torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(7)
    q = torch.empty(B, S, Hq, dh, dtype=bf16, device=dev).normal_(std=LM_KEY_SPREAD,
                                                                  generator=gen)
    k = torch.empty(B, S, Hkv, dh, dtype=bf16, device=dev).normal_(generator=gen)
    v = torch.empty(B, S, Hkv, dv, dtype=bf16, device=dev).normal_(generator=gen)
    out, _ = fops.flash_attention_fwd(q, k, v, causal=True, window=window)
    mid = S // 2 // LM_BLOCK * LM_BLOCK
    err = ratio = largest = 0.0
    planted = {"zeros": 0.0, "earlier keys dropped": 0.0}  # worst ratio of each control
    zero = torch.tensor([0], dtype=torch.int32, device=dev)
    for s0 in (0, mid, S - LM_BLOCK):
        end = s0 + LM_BLOCK
        for b in range(B):
            qb = q[b:b + 1, s0:end].float()
            ref = decode_attention(qb, k[b:b + 1, :end].float(), v[b:b + 1, :end].float(),
                                   torch.tensor([s0], dtype=torch.int32, device=dev),
                                   window=window)
            e, r = assert_close_ratio(out[b:b + 1, s0:end], ref, TOL[bf16])
            err, ratio, largest = max(err, e), max(ratio, r), max(largest, ref.abs().max().item())
            wrong = {"zeros": torch.zeros_like(ref)}
            if s0:
                wrong["earlier keys dropped"] = decode_attention(
                    qb, k[b:b + 1, s0:end].float(), v[b:b + 1, s0:end].float(), zero,
                    window=window)
            for name, w in wrong.items():
                planted[name] = max(planted[name], assert_close_ratio(w, ref, TOL[bf16])[1])
            del ref, wrong
    del out
    ms = queued_ms(lambda: fops.flash_attention_fwd(q, k, v, causal=True, window=window),
                   iters=3)
    last = (q[:1, S - LM_BLOCK:].float(), k[:1].float(), v[:1].float(),
            torch.tensor([S - LM_BLOCK], dtype=torch.int32, device=dev))
    plain_block_ms = cuda_ms(lambda: decode_attention(*last, window=window), iters=3, warmup=1)
    del last
    lib = queued_ms(lambda: sdpa(q, k, v, True, window), iters=3)
    bound, by = flash_bound_ms((label, B, S, Hq, Hkv, dh, True, window), bf16, False, dv)
    print(f"{label}: flash forward at B {B} S {S} Hq {Hq} Hkv {Hkv} dh {dh} dv {dv} window "
          f"{window}, {fops.instance(bf16, dh, Hq // Hkv, dv)}: against the plain version on "
          f"blocks of {LM_BLOCK} rows at 0, {mid} and {S - LM_BLOCK} of each of the {B} sequences "
          f"(fp32, largest |out| {largest:.4e}): max_abs_err {err:.4e} worst "
          f"err/(tol + tol*|ref|) {ratio:.4f} (tol {TOL[bf16]}: must be at most 1); planted "
          f"controls' worst ratios (each must exceed 1): zeros {planted['zeros']:.4f}, the "
          f"middle and last blocks over their own keys only "
          f"{planted['earlier keys dropped']:.4f}; queued_ms {ms:.4f} bound_ms {bound:.4f} "
          f"({by}) plain_ms on one last block {plain_block_ms:.4f} (the whole plain attention "
          f"does not fit) SDPA {lib:.4f}")
    check(ratio <= 1.0, f"{label}: flash forward against the plain version: err {err}, "
                        f"ratio {ratio}")
    check(min(planted.values()) > 1.0, f"{label}: a planted control passes the check: {planted}")
    del q, k, v
    return {"max_abs_err": err, "ratio": ratio, "largest": largest, "controls": planted,
            "queued_ms": ms, "bound_ms": bound,
            "bound_by": by, "plain_ms": None, "plain_last_block_ms": plain_block_ms,
            "library_ms": lib, "shape": {"B": B, "S": S, "Hq": Hq, "Hkv": Hkv, "dh": dh,
                                         "dv": dv, "causal": True, "window": window}}


def lm_decode_check(dev, cfg, k_layer, v_layer, cache_len, window, label: str) -> dict:
    """One KV layer's ``[B, T, Hkv, dh]`` slice of the cell's cache, cloned,
    through ``written_case`` (the fused variant writes the new row at
    ``cache_len`` and attends: against the plain version on fp32 copies,
    within TOL of its largest output, caches and reruns bit-equal, two
    planted controls refused; its times), SDPA with a mask beside it.  The
    queries are drawn at LM_KEY_SPREAD / LM_CACHE_STD and the new rows at
    the cache's LM_CACHE_STD, so the scores spread by LM_KEY_SPREAD: the
    softmax picks a few of the 16,385 or 262,145 live keys and the output
    is at the values' scale, not at their mean's."""
    from repro_torch.kernels.decode_attention import ops as dops

    B, T, Hkv, dh = k_layer.shape
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    Hq, bf16 = cfg.n_heads, torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(8)
    q = (torch.randn(B, 1, Hq, dh, generator=gen, device=dev)
         * (LM_KEY_SPREAD / LM_CACHE_STD)).to(bf16)
    new = tuple((torch.randn(B, 1, Hkv, dh, generator=gen, device=dev) * LM_CACHE_STD).to(bf16)
                for _ in range(2))
    case = (label, B, 1, T, Hq, Hkv, dh, cache_len.tolist(), window)
    lib = queued_ms(lambda: library_call(q, k_layer, v_layer, cache_len, window))
    print(f"{label}: decode at B {B} T {T} Hq {Hq} Hkv {Hkv} dh {dh} window {window} q_start "
          f"{case[7][0]}, plan_fused "
          f"{dops.plan_fused(B, Hkv, T, dh, bf16, n_sm, window)}")
    r = written_case(dops, "fused", case, q, k_layer, v_layer, cache_len, gen, bf16, lib,
                     new=new, controls=True)
    return {**r, "shape": {"B": B, "T": T, "Hq": Hq, "Hkv": Hkv, "dh": dh,
                           "q_start": case[7][0], "window": window}}


def lm_decode_cpu_check(dev, cfg_full, cell, label: str) -> dict:
    """The decode cell's step at B LM_CHECK_BATCH, cut to LM_CHECK_LAYERS
    layers (gemma3-4b's pattern set to one local layer and one global; an
    MLA model to LM_CHECK_LAYERS_MLA), at the full T and ``cache_len``, on
    the card (bf16: the fused kernel, or MLA's absorbed einsums) and on the
    CPU through the port's plain path in fp32, from the same weights and
    batch: the logits within LM_CHECK_TOL of the largest.  The cache is
    ``make_batch``'s, scaled so the scores spread by LM_KEY_SPREAD and the
    attention, not the residual, sets the logits: GQA's keys to
    LM_KEY_SPREAD and its values to unit scale (the queries have unit
    scale); MLA's latent and rope rows by the factor ``mla_latent_scale``
    measures on layer 0.  An MoE oracle replays the card's expert ids and
    slots (``replayed_route``) and reads the share of them its own routing
    would have flipped.  A planted control must fail the same check: the
    card's step over a copy of the cache whose keys past the fused plan's
    first split of each sequence's live range (a global layer's plan) are
    zeroed, or, for MLA, whose latent rows past half of each sequence's live
    range are."""
    from repro_torch.data import make_batch
    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.launch.dryrun import batch_cut
    from repro_torch.models import moe, transformer
    from repro_torch.train import build_serve_step

    mla = cfg_full.mla is not None
    extra = {"local_global": (1, 1)} if cfg_full.local_global else {}
    n_layers = LM_CHECK_LAYERS_MLA if mla else LM_CHECK_LAYERS
    cfg = dataclasses.replace(cfg_full, n_layers=n_layers, **extra)
    windows = transformer._layer_windows(cfg)
    cell = batch_cut(cell, LM_CHECK_BATCH)
    params = lm_params(dev, cfg, seed=2)
    batch = make_batch(cfg, cell, seed=2, generator=torch.Generator(device=dev).manual_seed(3))
    cache, lens = batch["cache"], batch["cache_len"].tolist()
    if mla:
        spread, scale = mla_latent_scale(params, cfg, batch["tokens"], cache,
                                         batch["cache_len"])
        for c in cache.values():
            c.mul_(scale)
        scaled = (f"latent and rope rows x {scale:.4f} (layer 0's absorbed scores spread "
                  f"{spread:.4f} as drawn, {LM_KEY_SPREAD} after)")
        kept = [(0, (n + 1) // 2 - 1) for n in lens]
        control = f"the latent rows from {[hi + 1 for _, hi in kept]} zeroed"
    else:
        cache["k"].mul_(LM_KEY_SPREAD / LM_CACHE_STD)
        cache["v"].mul_(1 / LM_CACHE_STD)
        scaled = f"keys at {LM_KEY_SPREAD}, values at 1"
        kept, n_splits = first_split_keys(dops, LM_CHECK_BATCH, cfg.n_kv_heads, cell.params[
            "seq_len"], cfg.head_dim, cfg.dtype, lens, None, dev)
        control = f"the rows past the first of {n_splits} splits zeroed, keys {kept} kept"
    cpu_params, cpu_cache = cpu_f32(params), cpu_f32(cache)
    tokens, cache_len = batch["tokens"].cpu(), batch["cache_len"].cpu()
    step = build_serve_step(cfg, cell)
    T = cell.params["seq_len"]
    planted = {name: c.clone() for name, c in cache.items()}
    for c in planted.values():
        for b, (_, hi) in enumerate(kept):
            c[:, b, hi + 1:] = 0
    routes: list = []
    inner = moe.route

    def recorded(x, router, dims):
        out = inner(x, router, dims)
        routes.append(tuple(t.cpu() for t in out))
        return out

    dops.reset_launches()
    with patched_route(recorded if cfg.moe is not None else None):
        card = step(params, batch["tokens"], cache, batch["cache_len"])[0].float().cpu()
    launches = dict(dops.decode_attention.launches_by_variant)
    wrong = step(params, batch["tokens"], planted, batch["cache_len"])[0].float().cpu()
    del params, batch, cache, planted
    gc.collect()
    torch.cuda.empty_cache()
    flips: list = []
    t0 = time.perf_counter()
    with patched_route(replayed_route(routes, flips) if cfg.moe is not None else None):
        ref = build_serve_step(dataclasses.replace(cfg, dtype=torch.float32), cell)(
            cpu_params, tokens, cpu_cache, cache_len)[0]
    cpu_s = time.perf_counter() - t0
    largest = ref.abs().max().item()
    err, ctrl = ((x - ref).abs().max().item() for x in (card, wrong))
    flip = max(flips) if flips else None
    print(f"{label} step card vs CPU: B {LM_CHECK_BATCH}, {n_layers} layers (windows "
          f"{windows}), T {T}, cache_len {cache_len.tolist()}, {scaled}: card bf16 logits "
          f"against the CPU port in fp32 ({cpu_s:.1f} s on the CPU)"
          + ("" if flip is None else f", the oracle routing as the card (expert ids and slots "
             f"replayed; its own routing would flip {flip:.6f} of the card's choices at worst "
             f"in a layer: {[round(f, 6) for f in flips]})")
          + f": max_abs_err {err:.4e} largest {largest:.4e} tol {LM_CHECK_TOL:.0e} of the "
          f"largest ({LM_CHECK_TOL * largest:.4e}); planted control (the card's step with "
          f"{control}; must exceed it) {ctrl:.4e}; decode kernels {launches}")
    want = {"split": 0, "fused": 0 if mla else n_layers, "chunk": 0}
    check(launches == want, f"{label} step card vs CPU: decode kernels {launches}, wanted {want}")
    check(math.isfinite(err) and err <= LM_CHECK_TOL * largest,
          f"{label} step card vs CPU: logits {err} apart (largest {largest})")
    check(ctrl > LM_CHECK_TOL * largest,
          f"{label} step card vs CPU: the planted control passes: {ctrl} (largest {largest})")
    return {"max_abs_err": err, "largest": largest, "control": ctrl, "cpu_s": cpu_s,
            "launches": launches, "layers": n_layers, "flips": flips}


def lm_decode_step_bound_ms(cfg, params, cache_len: list[int], T: int) -> dict[str, float]:
    """A decode step's least time from this run's data, over HBM rate: the
    weights it reads (``decode_bounds``: every parameter but the embedding
    table; for MoE also the active weights alone, though the step's batched
    product reads every expert's) and, in each layer, the cache rows its
    sequences see (``cache_len`` + 1 keys, or the window): K and V of every
    KV head, or MLA's one latent and rope row (``kv_lora_rank`` +
    ``rope_head_dim`` columns)."""
    from repro_torch.models import transformer

    rows = sum(visible_keys(cache_len, 1, T, w) for w in transformer._layer_windows(cfg))
    m = cfg.mla
    cols = 2 * cfg.n_kv_heads * cfg.head_dim if m is None else m.kv_lora_rank + m.rope_head_dim
    cache = rows * cols * torch.finfo(cfg.dtype).bits // 8
    return {k: (b + cache) / HBM_BYTES_PER_S * 1e3 for k, (b, _) in
            decode_bounds(cfg, params).items()}


def lm_cell(dev, arch: str, name: str, fit: tuple | None = None) -> dict:
    """One cell through ``build_serve_step`` at the cut the dry-run's
    ``fit`` takes under FIT_BYTES (``lm_fit``, or ``fit`` where a worker
    traced it already; the batch, or at B 1 the depth; never a width, S, T,
    the window or ``cache_len``): one warm-up step, LM_CELL_STEPS
    steps timed by CUDA events, one more profiled; the launches of those
    steps by variant (decode all ``fused``, none where MLA's absorbed
    einsums decode; flash all ``wgmma``, MLA's at the instantiation
    ``mla_instance`` names; no index write); for MoE the ``groups()`` of the
    step and the share of routed pairs capacity dropped in the warm-up; the
    step's own peak against the reckoning, within LM_PEAK_TOL; the kernels
    against their plain versions at the cell's shape; for decode cells the
    step card against CPU at B 2 and 2 layers (1 for MLA; prefill cells have
    no such check: the plain attention's [B, H, S, S] scores at S 32,768 do
    not fit)."""
    from repro_torch.configs import get_config, get_shapes
    from repro_torch.data import make_batch
    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention import reset_launches as reset_flash
    from repro_torch.launch import dryrun
    from repro_torch.train import build_serve_step

    label = f"lm cell {arch} {name}"
    published = next(c for c in get_shapes(arch) if c.name == name)
    (cell, overrides, cuts, rec), trace_s = fit or lm_fit(arch, name)
    full_cfg = get_config(arch)
    cfg = dryrun.apply_cfg_overrides(full_cfg, overrides)
    B, T = cell.params["global_batch"], cell.params["seq_len"]
    decode = cell.kind == "decode"
    mla = cfg.mla is not None
    print(f"{label}: the dry-run's cut under {FIT_BYTES} B: {cuts or 'none'} (reckoned peak "
          f"{rec['memory']['peak_hbm_bytes']} B, roofline "
          f"{rec['roofline']['step_time_s'] * 1e3:.3f} ms; {trace_s:.1f} s of tracing)")
    check(rec["status"] == "ok" and T == published.params["seq_len"]
          and dataclasses.replace(cfg, n_layers=full_cfg.n_layers) == full_cfg,
          f"{label}: the cut touches more than the batch and the depth: {cell}, {overrides}")
    groups = lm_moe_groups(cfg, B if decode else B * T, decode, label)
    gc.collect()
    torch.cuda.empty_cache()
    pre = torch.cuda.memory_allocated(dev)
    params = lm_params(dev, cfg, seed=0)
    batch = make_batch(cfg, cell, seed=0, generator=torch.Generator(device=dev).manual_seed(1))
    step = build_serve_step(cfg, cell)
    inputs = ((batch["tokens"], batch["cache"], batch["cache_len"]) if decode
              else (batch["tokens"],))

    def one():
        return step(params, *inputs)[0]  # the logits; a prefill's cache is dropped here

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    reset_flash()
    dops.reset_launches()
    torch.cuda.empty_cache()  # once, before the warm-up: the steps run back to back
    with counted_inserts(dops) as index_writes:
        with counted_drops() as drops:
            finite = [torch.isfinite(one()).all()]  # warm-up
        times = []
        for _ in range(LM_CELL_STEPS):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            logits = one()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
            finite.append(torch.isfinite(logits).all())
            del logits
        prof = profile_call(label, one, n_kernels=3,
                            watch=("decode_attention_fused",) if decode and not mla else ())
    max_mem = torch.cuda.max_memory_allocated(dev)
    n_steps = LM_CELL_STEPS + 2
    decode_launches = dict(dops.decode_attention.launches_by_variant)
    flash_launches = {v: dict(n) for v, n in flash_attention.launches_by_variant.items()}
    by_inst = {k: dict(n) for k, n in flash_attention.launches_by_instance.items()}
    med = sorted(times)[len(times) // 2]
    per_step = B if decode else B * T
    run = {"mean_step_s": sum(times) / len(times) / 1e3, "max_memory": max_mem,
           "base_memory": base, "pre_memory": pre}
    moe_part = ("" if groups is None else
                f"; MoE groups (G, g, C) {groups}, capacity dropped {drops[0]} of {drops[1]} "
                f"routed pairs in the warm-up step ({drops[0] / drops[1]:.6f})")
    print(f"{label}: {cfg.name} {cfg.n_layers} layers bf16 B {B} {'T' if decode else 'S'} "
          f"{T}{f' cache_len {T // 2}' if decode else ''}: step ms median {med:.3f} range "
          f"{min(times):.3f}-{max(times):.3f} over {LM_CELL_STEPS} (CUDA events), tokens_per_s "
          f"{per_step / med * 1e3:.1f}; device idle share "
          f"{prof.get('idle_share', 'not measured')}; the step's own peak {max_mem - pre} B "
          f"(max_memory_allocated {max_mem} less {pre} held before) against the reckoned "
          f"{rec['memory']['peak_hbm_bytes']}; launches in the {n_steps} steps: decode "
          f"{decode_launches}, flash {flash_launches} by instance {by_inst}, index writes "
          f"{index_writes[0]}{moe_part}")
    check(bool(torch.stack(finite).all()), f"{label}: non-finite logits")
    L = cfg.n_layers
    want_decode = {"split": 0, "fused": n_steps * L if decode and not mla else 0, "chunk": 0}
    want_flash = {v: {"fwd": n_steps * L if (v == "wgmma" and not decode) else 0, "bwd": 0}
                  for v in flash_launches}
    check(decode_launches == want_decode and flash_launches == want_flash
          and index_writes[0] == 0,
          f"{label}: decode {decode_launches} (wanted {want_decode}), flash {flash_launches} "
          f"(wanted {want_flash}), index writes {index_writes[0]}")
    if mla and not decode:
        want = {mla_instance(cfg): {"fwd": n_steps * L, "bwd": 0}}
        check(by_inst == want, f"{label}: flash launches by instance {by_inst}, wanted {want}")
    bounds = (lm_decode_step_bound_ms(cfg, params, batch["cache_len"].tolist(), T) if decode
              else None)
    if bounds:
        print(f"{label}: the step's data bounds (weights and visible cache rows at HBM rate): "
              + "; ".join(f"{k} {ms:.3f} ms ({med / ms:.2f}x)" for k, ms in bounds.items()))
    dr = dryrun_compare(f"{arch} {name} at the cut", rec, run, trace_s,
                        data_bound_ms=bounds["weights"] if bounds else None)
    check(abs(dr["ratio"] - 1) <= LM_PEAK_TOL,
          f"{label}: the reckoned peak is {dr['ratio']:.4f} of the step's own")
    out = {"arch": arch, "cell": name, "cuts": cuts, "B": B, "T": T, "layers": L,
           "step_ms": times, "median_ms": med, "tokens_per_s": per_step / med * 1e3,
           "profile": prof, "decode_launches": decode_launches,
           "flash_launches": flash_launches, "flash_by_instance": by_inst, "dryrun": dr,
           "kernels": {}, "bounds": bounds}
    if groups is not None:
        out.update(moe_groups=groups, drops=drops)

    # the kernels at the cell's shape, on one layer (local and global for
    # gemma3-4b); none at MLA's decode, whose absorbed attention is einsums
    if decode and not mla:
        slices = {i: (batch["cache"]["k"][i].clone(), batch["cache"]["v"][i].clone(), w)
                  for i, w in lm_check_layers(cfg)}
        cache_len = batch["cache_len"]
    del params, batch, inputs
    gc.collect()
    torch.cuda.empty_cache()
    if decode:
        if mla:
            print(f"{label}: no decode kernel runs (MLA's absorbed attention over the latent "
                  f"cache is einsums, as in the reference); the step card vs CPU holds it")
        else:
            for i in list(slices):
                k_l, v_l, w = slices.pop(i)
                out["kernels"][f"layer {i}"] = lm_decode_check(dev, cfg, k_l, v_l, cache_len, w,
                                                               f"{label} layer {i}")
                del k_l, v_l
                torch.cuda.empty_cache()
        out["cpu_check"] = lm_decode_cpu_check(dev, full_cfg, cell, label)
    else:
        for i, w in lm_check_layers(cfg):
            out["kernels"][f"layer {i}"] = lm_flash_check(dev, cfg, B, T, w,
                                                          f"{label} layer {i}")
    gc.collect()
    torch.cuda.empty_cache()
    return out


def lm_train_flash_check(dev, cfg, B: int, S: int, window: int | None, label: str) -> dict:
    """The flash forward and backward at a train cell's shape (bf16, causal,
    ``window``; q drawn at LM_KEY_SPREAD, k, v and dout unit normal) against
    fp32 autograd of the plain version, taken one sequence at a time (the
    plain scores of the whole batch take 13 GB a copy at TinyLlama's B 6)
    and LM_ORACLE_HEADS query heads at a time: out, lse, dq, dk and dv
    within TOL.  v and dout are ``dv`` wide (MLA's 128 beside keys of 192).
    Two planted controls must fail the same check: zeros, and the kernels'
    dK and dV with the rows of keys LM_TRAIN_CUT and after zeroed (what a
    backward that stopped at the S of the earlier train steps gives).  Times: the kernels, the bound, the
    plain version on one sequence, SDPA at the cell's shape."""
    from repro_torch.kernels.flash_attention import attention_ref
    from repro_torch.kernels.flash_attention import ops as fops

    (Hq, Hkv, dh, dv), bf16 = lm_widths(cfg), torch.bfloat16
    tol = TOL[bf16]
    gen = torch.Generator(device=dev).manual_seed(9)
    q = torch.empty(B, S, Hq, dh, dtype=bf16, device=dev).normal_(std=LM_KEY_SPREAD,
                                                                  generator=gen)
    k = torch.empty(B, S, Hkv, dh, dtype=bf16, device=dev).normal_(generator=gen)
    v = torch.empty(B, S, Hkv, dv, dtype=bf16, device=dev).normal_(generator=gen)
    dout = torch.empty(B, S, Hq, dv, dtype=bf16, device=dev).normal_(generator=gen)
    kw = dict(causal=True, window=window)
    out, lse = fops.flash_attention_fwd(q, k, v, **kw)
    got = dict(zip(("out", "lse", "dq", "dk", "dv"),
                   (out, lse, *fops.flash_attention_bwd(q, k, v, out, lse, dout, **kw))))
    worst = {name: [0.0, 0.0, 0.0] for name in got}  # max abs err, ratio, largest |ref|
    cut = f"keys from {LM_TRAIN_CUT} on dropped"
    planted = {"zeros": 0.0, cut: 0.0}  # worst ratio of each control
    for b in range(B):
        want = flash_oracle(q[b:b + 1], k[b:b + 1], v[b:b + 1], dout[b:b + 1], True, window,
                            heads=LM_ORACLE_HEADS)
        for (name, g), ref in zip(got.items(), want):
            e, r = assert_close_ratio(g[b:b + 1], ref, tol)
            w = worst[name]
            w[:] = max(w[0], e), max(w[1], r), max(w[2], ref.abs().max().item())
            planted["zeros"] = max(planted["zeros"],
                                   assert_close_ratio(torch.zeros_like(ref), ref, tol)[1])
            if name in ("dk", "dv"):
                dropped = g[b:b + 1].float()
                dropped[:, LM_TRAIN_CUT:] = 0
                planted[cut] = max(planted[cut], assert_close_ratio(dropped, ref, tol)[1])
        del want
    ratio = max(w[1] for w in worst.values())
    print(f"{label}: flash at B {B} S {S} Hq {Hq} Hkv {Hkv} dh {dh} dv {dv} window {window}, "
          f"{fops.instance(bf16, dh, Hq // Hkv, dv)}: against fp32 autograd of the plain "
          f"version, one sequence and {LM_ORACLE_HEADS} heads at a time (q at "
          f"{LM_KEY_SPREAD}): " + ", ".join(
              f"{n} max_abs_err {w[0]:.4e} ratio {w[1]:.4f} (largest {w[2]:.4e})"
              for n, w in worst.items())
          + f"; worst err/(tol + tol*|ref|) {ratio:.4f} (tol {tol}: must be at most 1); planted "
          f"controls' worst ratios (each must exceed 1): zeros {planted['zeros']:.4f}, {cut} "
          f"{planted[cut]:.4f}")
    check(ratio <= 1.0, f"{label}: flash against fp32 autograd: {worst}")
    check(min(planted.values()) > 1.0, f"{label}: a planted control passes the check: {planted}")
    o, l = got["out"], got["lse"]
    del got, out, lse
    times = {"fwd": {"queued_ms": queued_ms(lambda: fops.flash_attention_fwd(q, k, v, **kw))},
             "bwd": {"queued_ms": queued_ms(
                 lambda: fops.flash_attention_bwd(q, k, v, o, l, dout, **kw))}}
    times["fwd"]["plain_one_sequence_ms"] = cuda_ms(
        lambda: attention_ref(q[:1], k[:1], v[:1], **kw), iters=3, warmup=1)
    one = [t[:1].clone().requires_grad_(True) for t in (q, k, v)]
    plain_out = attention_ref(*one, **kw)
    times["bwd"]["plain_one_sequence_ms"] = backward_ms(plain_out, one, dout[:1], iters=3)
    del plain_out, one
    times["fwd"]["library_ms"] = queued_ms(lambda: sdpa(q, k, v, True, window), iters=3)
    qg, kg, vg = (t.clone().requires_grad_(True) for t in (q, k, v))
    lib_out = sdpa(qg, kg, vg, True, window)
    times["bwd"]["library_ms"] = backward_ms(lib_out, (qg, kg, vg), dout, iters=3)
    del lib_out, qg, kg, vg, q, k, v, dout, o, l
    for kind, names in (("fwd", ("out", "lse")), ("bwd", ("dq", "dk", "dv"))):
        t = times[kind]
        t["bound_ms"], t["bound_by"] = flash_bound_ms((label, B, S, Hq, Hkv, dh, True, window),
                                                      bf16, kind == "bwd", dv)
        t.update(plain_ms=None, max_abs_err=max(worst[n][0] for n in names),
                 ratio=max(worst[n][1] for n in names))
        print(f"{label}: flash {kind} queued_ms {t['queued_ms']:.4f} bound_ms "
              f"{t['bound_ms']:.4f} ({t['bound_by']}) plain_ms on one sequence "
              f"{t['plain_one_sequence_ms']:.4f} SDPA {t['library_ms']:.4f}")
    torch.cuda.empty_cache()
    return {**times, "controls": planted, "errs": worst,
            "shape": {"B": B, "S": S, "Hq": Hq, "Hkv": Hkv, "dh": dh, "dv": dv, "causal": True,
                      "window": window}}


class _KeysDropped(torch.autograd.Function):
    """The flash kernels, forward and backward, with dK and dV zeroed from key
    LM_TRAIN_CUT on: the planted control of ``lm_train_grad_check``."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        from repro_torch.kernels.flash_attention import ops as fops

        out, lse = fops.flash_attention_fwd(q, k, v, causal=causal, window=window)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.kw = dict(causal=causal, window=window)
        return out

    @staticmethod
    def backward(ctx, dout):
        from repro_torch.kernels.flash_attention import ops as fops

        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = fops.flash_attention_bwd(q, k, v, out, lse, dout.contiguous(), **ctx.kw)
        dk[:, LM_TRAIN_CUT:] = 0
        dv[:, LM_TRAIN_CUT:] = 0
        return dq, dk, dv, None, None


def lm_train_grad_check(dev, cfg, cell, remat: str, params, label: str) -> dict:
    """One forward and backward of the train cell's loss at its depth and
    remat, B 1 x S, through four attentions (``family_grads``): the flash
    kernels, the plain version in fp32 (the oracle), the plain version in
    bf16, and the planted control (``_KeysDropped``).  An MoE model's other
    three runs replay the kernels' run's expert ids and slots
    (``replayed_route``), so the attention's rounding is all that parts them;
    the share of those choices the oracle's own routing would have flipped
    is read.  The kernels' grad norm and each attention projection leaf must
    lie within LM_GRAD_TOL of the oracle's, or within the bf16 plain
    version's own distance where that is larger; the control must not.
    Every flash launch of an MLA model is at ``mla_instance``'s.  Under remat
    none each plain call recomputes its scores in the backward (a checkpoint
    around the call, values unchanged): the saved fp32 scores of every layer
    at S 4,096 do not fit."""
    from repro_torch.data import make_batch
    from repro_torch.kernels.flash_attention import attention_ref, flash_attention
    from repro_torch.launch.dryrun import batch_cut
    from torch.utils.checkpoint import checkpoint

    one = batch_cut(cell, 1)
    batch = make_batch(cfg, one, seed=5, generator=torch.Generator(device=dev).manual_seed(5))
    names = leaf_paths(params)
    attn_idx = [i for i, n in enumerate(names) if n.startswith("layers/attn/")]

    def plain(dtype):
        def attn(q, k, v, *, causal=True, window=None):
            def f(q, k, v):
                return attention_ref(q.to(dtype), k.to(dtype), v.to(dtype), causal=causal,
                                     window=window).to(q.dtype)
            return checkpoint(f, q, k, v, use_reentrant=False) if remat == "none" else f(q, k, v)
        return attn

    def dropped(q, k, v, *, causal=True, window=None):
        return _KeysDropped.apply(q, k, v, causal, window)

    def norm(gs):
        return math.sqrt(sum(torch.linalg.vector_norm(g, dtype=torch.float64).item() ** 2
                             for g in gs))

    def run(attn, route=None):
        """(loss, grad norm, the attention leaves' gradients, the routes)."""
        loss, grads, routes = family_grads(params, cfg, batch, remat=remat, attn=attn,
                                           route=route)
        return loss, norm(grads), [grads[i] for i in attn_idx], routes

    f0, b0 = flash_attention.launches_fwd, flash_attention.launches_bwd
    inst0 = {k: dict(n) for k, n in flash_attention.launches_by_instance.items()}
    runs = {"kernels": run(flash_attention)}
    routes = runs["kernels"][3] if cfg.moe is not None else None
    flips: list = []
    replay = lambda f=None: replayed_route(routes, f) if routes else None  # noqa: E731
    runs["fp32 oracle"] = run(plain(torch.float32), replay(flips))
    runs["plain bf16"] = run(plain(cfg.dtype), replay())
    runs["planted"] = run(dropped, replay())
    _, n_ref, ref, _ = runs["fp32 oracle"]
    out = {}
    for name in ("fp32 oracle", "plain bf16", "kernels", "planted"):
        loss, n, gs, _ = runs[name]
        out[name] = {"loss": loss, "norm": n}
        if name != "fp32 oracle":
            out[name]["dist"] = {"grad norm": abs(n - n_ref) / n_ref, **{
                names[i].split("/")[-1]: rel_diff(g, r) for i, g, r in zip(attn_idx, gs, ref)}}
    launches = (flash_attention.launches_fwd - f0, flash_attention.launches_bwd - b0)
    moved = {k: {c: n[c] - inst0.get(k, {}).get(c, 0) for c in n}
             for k, n in flash_attention.launches_by_instance.items() if n != inst0.get(k)}
    del runs, ref
    bound = {q: max(LM_GRAD_TOL, d) for q, d in out["plain bf16"]["dist"].items()}
    kern, ctrl = out["kernels"]["dist"], out["planted"]["dist"]
    passes = lambda d: all(d[q] <= bound[q] for q in d)  # noqa: E731
    flip = (f"; the other runs route as the kernels' (expert ids and slots replayed; the "
            f"oracle's own routing would flip {max(flips):.6f} of them at worst in a layer)"
            if flips else "")
    print(f"{label} gradient check: {cfg.n_layers} layers, remat {remat}, B 1 S "
          f"{one.params['seq_len']}: " + "; ".join(
              f"{name} loss {r['loss']:.6f} grad norm {r['norm']:.6e}"
              + ("" if "dist" not in r else " |x - x_fp32| / |x_fp32|: " + " ".join(
                  f"{q} {d:.4e}" for q, d in r["dist"].items()))
              for name, r in out.items())
          + f"; held to {LM_GRAD_TOL} or the bf16 plain version's distance where larger; the "
          f"planted control (dK, dV past key {LM_TRAIN_CUT} dropped) must fail; flash launches "
          f"{launches} by instance {moved}{flip}")
    check(all(math.isfinite(r["loss"]) and math.isfinite(r["norm"]) for r in out.values()),
          f"{label} gradient check: non-finite loss or norm: {out}")
    check(passes(kern), f"{label} gradient check: the kernels' gradient {kern}, bound {bound}")
    check(not passes(ctrl), f"{label} gradient check: the planted control passes: {ctrl}")
    if cfg.mla is not None:
        want = {mla_instance(cfg): {"fwd": launches[0], "bwd": launches[1]}}
        check(moved == want, f"{label} gradient check: flash launches {moved}, wanted {want}")
    return {**out, "bound": bound, "launches": launches, "flips": flips}


# the flash kernels a train step's profile times apart: the forward (MLA's
# (3, 2) on flash_fwd_pp_wgmma_kernel, the others on flash_fwd_wgmma_kernel);
# the fused backward's delta, key-tile and dq conversion kernels; the dQ and
# dK/dV kernels of the pairs the fused kernels do not take
FLASH_WATCH = ("flash_fwd", "flash_bwd_delta_wgmma", "flash_bwd_fused_wgmma",
               "flash_bwd_dq_convert", "flash_bwd_dq_wgmma", "flash_bwd_dkdv_wgmma")


def lm_train_cell(dev, arch: str, fit: tuple | None = None) -> dict:
    """The reference's ``train_4k`` cell through ``build_train_step`` at the
    cut and remat the dry-run's ``fit_train`` takes (``lm_fit``, or ``fit``
    where a worker traced it already; widths, S and the window as
    published), random bf16 weights at the true fan-in (``lm_params``), a
    fresh AdamW state, batches from ``make_batch`` drawn on the card: the
    gradient check (``lm_train_grad_check``, on the parameters alone), one
    warm-up step, LM_CELL_STEPS steps timed by CUDA events and one more
    profiled (its flash kernels by name, FLASH_WATCH: the backward's split
    between the delta, fused and dq conversion kernels, or the dQ and dK/dV
    kernels); each step's loss and grad norm finite; the flash launches of
    those steps (L forwards a step, 2L under remat full, L backwards, all
    ``wgmma``, MLA's at ``mla_instance``'s; no decode kernel); for MoE the
    ``groups()`` of the step and the share of routed pairs capacity dropped
    in the warm-up; the step's own peak against the reckoning, within
    LM_PEAK_TOL; the flash kernels at the cell's shape on one layer (a local
    and a global one for gemma3-4b, ``lm_train_flash_check``)."""
    from repro_torch.configs import get_config, get_shapes
    from repro_torch.data import make_batch
    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention import reset_launches as reset_flash
    from repro_torch.launch import dryrun
    from repro_torch.train import build_train_step, make_train_state

    name = "train_4k"
    label = f"lm cell {arch} {name}"
    published = next(c for c in get_shapes(arch) if c.name == name)
    (remat, fits), trace_s = fit or lm_fit(arch, name)
    cell, overrides, cuts, rec = fits[remat]
    full_cfg = get_config(arch)
    cfg = dryrun.apply_cfg_overrides(full_cfg, overrides)
    B, S, L = cell.params["global_batch"], cell.params["seq_len"], cfg.n_layers
    for r, (c, _, cu, rc) in fits.items():
        print(f"{label}: the dry-run's cut under {FIT_BYTES} B at remat {r}: {cu or 'none'} "
              f"(reckoned peak {rc['memory']['peak_hbm_bytes']} B, {rc['n_layers']} layers)")
    print(f"{label}: takes remat {remat}: B {B} of {published.params['global_batch']}, {L} of "
          f"{full_cfg.n_layers} layers, roofline {rec['roofline']['step_time_s'] * 1e3:.3f} ms; "
          f"{trace_s:.1f} s of tracing")
    check(rec["status"] == "ok" and S == published.params["seq_len"]
          and dataclasses.replace(cfg, n_layers=full_cfg.n_layers) == full_cfg,
          f"{label}: the cut touches more than the batch and the depth: {cell}, {overrides}")
    groups = lm_moe_groups(cfg, B * S, False, label)
    gc.collect()
    torch.cuda.empty_cache()
    pre = torch.cuda.memory_allocated(dev)
    params = lm_params(dev, cfg, seed=0)
    grad = lm_train_grad_check(dev, cfg, cell, remat, params, label)
    gc.collect()
    torch.cuda.empty_cache()
    state = make_train_state(params)
    del params
    step = build_train_step(cfg, cell, remat=remat)  # the optimizer dryrun.build_step takes
    n_steps = LM_CELL_STEPS + 2
    batches = [make_batch(cfg, cell, seed=i, generator=torch.Generator(device=dev).manual_seed(i))
               for i in range(n_steps)]
    check(all(sorted(b) == ["targets", "tokens"] and all(
        t.shape == (B, S) and t.dtype == torch.int32 for t in b.values()) for b in batches),
        f"{label}: make_batch gives {[(k, t.shape, t.dtype) for k, t in batches[0].items()]}")
    metrics = []

    def one():
        nonlocal state
        state, m = step(state, batches[len(metrics)])
        metrics.append(m)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    reset_flash()
    dops.reset_launches()
    torch.cuda.empty_cache()
    with counted_drops() as drops:
        one()  # warm-up
    times = []
    for _ in range(LM_CELL_STEPS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        one()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    prof = profile_call(label, one, n_kernels=5, watch=FLASH_WATCH)
    if prof:
        w = prof["watch"]
        print(f"{label}: the flash backward's kernels in the profiled step: D (delta kernel) "
              f"{w['flash_bwd_delta_wgmma']['ms']:.3f} ms, fused dK/dV/dQ "
              f"{w['flash_bwd_fused_wgmma']['ms']:.3f} ms, dq conversion "
              f"{w['flash_bwd_dq_convert']['ms']:.3f} ms; the dQ and dK/dV kernels (the pairs "
              f"the fused kernels do not take) {w['flash_bwd_dq_wgmma']['ms']:.3f} and "
              f"{w['flash_bwd_dkdv_wgmma']['ms']:.3f} ms")
    max_mem = torch.cuda.max_memory_allocated(dev)
    decode_launches = dict(dops.decode_attention.launches_by_variant)
    flash_launches = {v: dict(n) for v, n in flash_attention.launches_by_variant.items()}
    by_inst = {k: dict(n) for k, n in flash_attention.launches_by_instance.items()}
    rows = [{k: float(v) for k, v in m.items()} for m in metrics]
    med = sorted(times)[len(times) // 2]
    run = {"mean_step_s": sum(times) / len(times) / 1e3, "max_memory": max_mem,
           "base_memory": base, "pre_memory": pre}
    print(f"{label}: {cfg.name} {L} layers bf16 remat {remat} B {B} S {S}: step ms median "
          f"{med:.3f} range {min(times):.3f}-{max(times):.3f} over {LM_CELL_STEPS} (CUDA events), "
          f"tokens_per_s {B * S / med * 1e3:.1f}; device idle share "
          f"{prof.get('idle_share', 'not measured')}; losses "
          f"{[round(r['loss'], 6) for r in rows]} grad norms "
          f"{[round(r['grad_norm'], 6) for r in rows]}; the step's own peak {max_mem - pre} B "
          f"(max_memory_allocated {max_mem} less {pre} held before) against the reckoned "
          f"{rec['memory']['peak_hbm_bytes']}; launches in the {n_steps} steps: decode "
          f"{decode_launches}, flash {flash_launches} by instance {by_inst}"
          + ("" if groups is None else
             f"; MoE groups (G, g, C) {groups}, capacity dropped {drops[0]} of {drops[1]} "
             f"routed pairs in the warm-up step ({drops[0] / drops[1]:.6f})"))
    check(all(math.isfinite(v) for r in rows for v in r.values()),
          f"{label}: non-finite metrics {rows}")
    per_step = (2 if remat == "full" else 1) * L  # a forward a layer, again where remat recomputes
    want_flash = {v: {"fwd": n_steps * per_step if v == "wgmma" else 0,
                      "bwd": n_steps * L if v == "wgmma" else 0} for v in flash_launches}
    check(all(n == 0 for n in decode_launches.values()) and flash_launches == want_flash,
          f"{label}: decode {decode_launches}, flash {flash_launches} (wanted {want_flash})")
    if cfg.mla is not None:
        want = {mla_instance(cfg): want_flash["wgmma"]}
        check(by_inst == want, f"{label}: flash launches by instance {by_inst}, wanted {want}")
    dr = dryrun_compare(f"{arch} {name} at the cut", rec, run, trace_s)
    check(abs(dr["ratio"] - 1) <= LM_PEAK_TOL,
          f"{label}: the reckoned peak is {dr['ratio']:.4f} of the step's own")
    out = {"arch": arch, "cell": name, "cuts": cuts, "remat": remat, "B": B, "T": S,
           "layers": L, "step_ms": times, "median_ms": med, "tokens_per_s": B * S / med * 1e3,
           "metrics": rows, "profile": prof, "decode_launches": decode_launches,
           "flash_launches": flash_launches, "flash_by_instance": by_inst, "dryrun": dr,
           "grad_check": grad, "kernels": {}}
    if groups is not None:
        out.update(moe_groups=groups, drops=drops)
    del state, batches, metrics
    gc.collect()
    torch.cuda.empty_cache()
    for i, w in lm_check_layers(cfg):
        out["kernels"][f"layer {i}"] = lm_train_flash_check(dev, cfg, B, S, w,
                                                            f"{label} layer {i}")
    return out


def phase_lm_cells(dev, fits: LMFits | None = None) -> dict:
    """The reference's LM serve cells (``configs/base.py``'s LM_SHAPES:
    ``prefill_32k``, ``decode_32k``, ``long_500k``; of the five LM configs,
    LM_CELLS: every pair the reference does not skip, ``long_500k`` of
    TinyLlama-1.1B, deepseek-7b and qwen2-moe-a2.7b being its ``skipped``)
    through ``build_serve_step`` at full width, S or T, window and
    ``cache_len``, random weights from a seeded CUDA generator at the true
    fan-in, the batch from ``make_batch`` drawn on the card, each at the
    cut the dry-run takes under FIT_BYTES, one after another (``lm_cell``);
    then the ``train_4k`` cell of each of LM_TRAIN_CELLS (``lm_train_cell``).
    ``fits``, where given, holds the cuts a worker traced meanwhile; it is
    read, and its worker stopped, before the first cell."""
    # expandable segments: memory a step frees is unmapped, and the next
    # step's largest allocation (TinyLlama prefill's fp32 [B, S, V] logits,
    # 39 GiB at B 10) maps it again; with fixed segments, those the first
    # step left hold 35 GiB free but in pieces, and the second step fails
    settings = torch._C._accelerator_setAllocatorSettings
    torch.cuda.empty_cache()
    settings("expandable_segments:True")
    try:
        got = fits.all() if fits else {}
        rows = {f"{arch} {name}": lm_cell(dev, arch, name, got.get((arch, name)))
                for arch, name in LM_CELLS}
        rows.update({f"{arch} train_4k": lm_train_cell(dev, arch, got.get((arch, "train_4k")))
                     for arch in LM_TRAIN_CELLS})
    finally:
        torch.cuda.empty_cache()
        settings("expandable_segments:False")
    fused = sum(r["decode_launches"]["fused"] for r in rows.values())
    flash = {label: r["flash_launches"]["wgmma"] for label, r in rows.items()
             if any(r["flash_launches"]["wgmma"].values())}
    print(f"lm cells: decode fused kernels {fused}, flash wgmma launches {flash} over the "
          f"{len(rows)} cells' steps")
    return {"rows": rows, "fused": fused, "flash": flash}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 2
    on_src_path()
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
    fits = LMFits()  # the LM cells' dry-run cuts, traced on the CPU while the card works

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
    tpar = timed(phase_train_parity)
    timed(phase_driver)
    pre = timed(phase_prefill)
    gem = timed(phase_gemma3)
    ds7 = timed(phase_deepseek7b)
    qwen = timed(phase_qwen2_moe)
    dsv2 = timed(phase_deepseek_v2)
    fpar = timed(phase_family_parity)
    ftrain = timed(phase_family_train)
    bag = timed(phase_bag)
    bwd = timed(phase_bag_bwd)
    rec = timed(phase_recsys)
    rtrain = timed(phase_recsys_train)
    graph, sampler = power_law_graph()
    agg = timed(phase_agg, agg_graphs(graph, sampler))
    del graph
    gtrain = timed(phase_gnn_train, sampler)
    timed(phase_gnn_parity)
    cells = timed(phase_gnn_cells)
    dr = timed(phase_dryrun, train, ftrain, gtrain, cells)
    wf = timed(phase_workflow, eng["rows"])
    store = timed(phase_store_server, eng["rows"])
    cli = timed(phase_client, eng["rows"])
    gwy = timed(phase_gateway)
    g3s = timed(phase_gemma3_serve)
    lm = timed(phase_lm_cells, fits)

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
    family_parity = ("fp32 MoE/MLA and gemma3 dh-256 smoke engines and 2-layer qwen2-moe "
                     "(card vs CPU)")
    split_paths = {"fp32 smoke serving (card vs CPU)": par["split"],
                   "fp32 gemma3 smoke prefill_chunk chain": pre["smoke_chain_launches"]["split"],
                   family_parity: fpar["split"]}
    split_at_chunk = kern["cases"][(CHUNK_CASE, "bfloat16")]
    # the cuts of scale this run makes to a published configuration
    line = {"kernels": [], "reduced": {
        "deepseek-v2-236b": {"n_layers": [60, MLA_LAYERS],
                             "why": "60 layers take about 478 GB in bf16"},
        **{f"{arch} train": {"n_layers": [r["full_layers"], r["layers"]],
                             "why": "the train state (12 B a parameter) of more layers and the "
                                    "step's activations do not fit 80 GB"}
           for arch, r in ftrain["train"].items()},
        "ogb_products": {"n_nodes": [OGB_NODES, cells["ogb_products"]["cell"].params["n_nodes"]],
                         "n_edges": [OGB_EDGES, cells["ogb_products"]["cell"].params["n_edges"]],
                         "why": "the full graph's train step needs about 450 GB with remat "
                                "full (7.3 KB an edge); nodes and edges cut by one factor, the "
                                f"largest whose dry-run peak lies under {FIT_BYTES} B"},
        **{f"{r['arch']} {r['cell']}": {
            **r["cuts"], **({"remat": r["remat"]} if "remat" in r else {}),
            "why": "the cell's weights, batch and step do not fit 80 GB; the "
                   "dry-run's largest cut (batch, or at B 1 depth) whose reckoned "
                   f"peak lies under {FIT_BYTES} B (a train cell: at remat none, or full "
                   "where that keeps more layers); widths, S or T, window and "
                   "cache_len as published"}
           for r in lm["rows"].values() if r["cuts"]}}}
    lm_keys = ("queued_ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "max_abs_err")

    def at_lm_cells(cell: tuple[str, ...], kind: str | None = None) -> dict:
        """The kernels' checks at the LM cells named (by cell or "arch cell");
        a train cell's forward or backward by ``kind``."""
        out = {}
        for label, row in lm["rows"].items():
            if not (row["cell"] in cell or label in cell):
                continue
            for layer, c in row["kernels"].items():
                r = c[kind] if kind in c else c
                out[f"{label} {layer}"] = {
                    "shape": c["shape"], **{k: r[k] for k in lm_keys},
                    **{k: r[k] for k in ("plain_last_block_ms", "plain_one_sequence_ms",
                                         "largest", "flushed_ms") if k in r},
                    **({"controls": c["controls"]} if "controls" in c else {})}
        return out

    def lm_flash(archs: tuple[str, ...], kind: str, train: bool) -> int:
        """Flash launches of kind in the LM cells of ``archs``, the train cells or the serve."""
        return sum(n[kind] for label, n in lm["flash"].items()
                   if label.split()[0] in archs and label.endswith("train_4k") == train)

    lm_train_path = "LM train cells (train_4k)"

    for name, var, case, tname, r, by_path in (
        ("decode_attention_fused", "fused", MAIN_CASE, "bfloat16",
         kern["written"][(MAIN_CASE, "bfloat16")],
         {"serving decode steps (CUDA graph replays and the capture's warm-up step)":
          eng["launches"]["fused"],
          "fabric serving decode steps (two engines)": wf["decode"]["fused"],
          "store-server serving decode steps (two engines, cache tier)": store["fused"],
          "client": cli["decode"]["fused"],
          "deepseek-7b serving decode steps": ds7["launches"]["fused"],
          "qwen2-moe-a2.7b serving decode steps": qwen["launches"]["fused"],
          family_parity: fpar["fused"],
          "gemma3-4b serving decode steps (dh 256)": g3s["launches"]["fused"],
          LM_PATH: lm["fused"]}),
        ("decode_attention_chunk", "chunk", CHUNK_CASE, "bfloat16",
         kern["written"][(CHUNK_CASE, "bfloat16")],
         {"serving prefill chunks": eng["launches"]["chunk"],
          "fabric serving prefill chunks (two engines)": wf["decode"]["chunk"],
          "store-server serving prefill chunks (two engines, cache tier)": store["chunk"],
          "client": cli["decode"]["chunk"],
          "deepseek-7b serving prefill chunks": ds7["launches"]["chunk"],
          "qwen2-moe-a2.7b serving prefill chunks": qwen["launches"]["chunk"],
          "gemma3-4b serving prefill chunks (dh 256)": g3s["launches"]["chunk"]}),
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
        timed_keys = ("queued_ms", "plain_ms", "library_ms", "bound_ms", "max_abs_err")
        if var in ("fused", "chunk"):  # MHA at dh 128, G 1: deepseek-7b's and qwen2-moe's
            entry["family_cases"] = {
                label: {k: kern["written"][(label, "bfloat16")][k] for k in timed_keys}
                for label in ((FAMILY_DECODE if var == "fused" else FAMILY_CHUNK))}
        # gemma3-4b's engine at dh 256, G 2 (fused: its decode steps; chunk:
        # its chunk calls), at the first requests' positions in a local layer,
        # then at the long request's, where the window bites, and in a global
        # layer
        gemma_served = {label: {k: kern["written"][(label, "bfloat16")][k] for k in timed_keys}
                        for label in GEMMA_SERVED.get(var, ())}
        if var == "fused":
            entry["l2_flushed_ms"] = r["flushed_ms"]
            entry["at_lm_cells"] = at_lm_cells(("decode_32k", "long_500k"))
            entry["at_long_t"] = {f"{label} {tname}": {k: kern["written"][(label, tname)][k]
                                                       for k in (*timed_keys, "flushed_ms")}
                                  for label in LONG_FUSED for tname in ("float32", "bfloat16")}
            entry["short_t_against_earlier"] = {
                label: [ms, SHORT_FUSED_BEFORE[label]] for label, ms in kern["short"].items()}
            entry["blocks_per_sm"] = kern["occupancy"]
            entry["graph_replays_equal_eager"] = kern["graph"]
            entry["at_gemma3_decode"] = {
                k: kern["written"][(GEMMA_DECODE, "bfloat16")][k] for k in timed_keys}
            entry["at_gemma3_served"] = gemma_served
        if var == "chunk":
            entry["l2_flushed_ms"] = r["flushed_ms"]
            entry["full_width_chain_launches"] = pre["chain_launches"]["chunk"]
            entry["gemma3_chain_launches"] = g3s["chain_launches"]["chunk"]
            # beside each gemma3 chunk shape: the split variant's route there
            # (two index writes and two kernels), its two kernels alone on a
            # cache that holds the rows, and the cluster sweep
            entry["at_gemma3_chunk"] = {
                k: kern["written"][(GEMMA_CHUNK, "bfloat16")][k] for k in timed_keys}
            entry["at_gemma3_served"] = gemma_served
            for label, r in ((GEMMA_CHUNK, entry["at_gemma3_chunk"]), *gemma_served.items()):
                w = kern["written"][(label, "bfloat16")]
                r.update(l2_flushed_ms=w["flushed_ms"], split_queued_ms=w["split_queued_ms"],
                         sweep=w["sweep"],
                         planned=w["planned"],
                         split_kernels_alone_queued_ms=kern["cases"][(label, "bfloat16")][
                             "queued_ms"])
        if var == "split":  # the variant the chunk kernel replaced at the engine's chunk call
            entry["at_chunk_case"] = {k: split_at_chunk[k] for k in timed_keys}
        line["kernels"].append(entry)
    wf_path = f"workflow ({wf['train_calls']} train, {wf['eval_calls']} eval calls)"
    # the LM cells' flash calls at dh 64 and 128 (deepseek-7b's and qwen2-moe's, G 1)
    dc12 = ("tinyllama-1.1b", "deepseek-7b", "qwen2-moe-a2.7b")
    family_flash = {"deepseek-7b prefill": ds7["prefill"]["launches"],
                    "qwen2-moe-a2.7b prefill": qwen["prefill"]["launches"]}
    # deepseek-v2's flash calls, every one at the (3, 2) instantiation
    mla = ("deepseek-v2-236b",)
    mla_flash = [{f"deepseek-v2-236b forward ({MLA_LAYERS} layers, two witnesses)":
                  sum(dsv2["witness"][k]["launches"] for k in ("reference init", "true fan-in")),
                  "deepseek-v2-236b layer 0 attention (two witnesses)":
                  sum(w["launches"] for w in dsv2["attention_witness"].values()),
                  LM_PATH: lm_flash(mla, "fwd", False),
                  lm_train_path: lm_flash(mla, "fwd", True)},
                 {lm_train_path: lm_flash(mla, "bwd", True)}]
    family_train_flash = [{}, {}]
    for arch, r in ftrain["train"].items():
        into = mla_flash if arch == "deepseek-v2-236b" else family_train_flash
        for i in (0, 1):
            into[i][f"{arch} train ({r['layers']} of {r['full_layers']} layers, "
                    f"{FAMILY_TRAIN_STEPS} steps)"] = r["launches"][i]
            into[i][f"{arch} gradient checks ({r['layers']} of {r['full_layers']} layers)"] = \
                r["checks"]["launches"][i]
    for name, kind, by_path in (
        ("flash_attention", "fwd",
         {"train": train["launches"][0], "prefill": pre["launches"], wf_path: wf["flash"][0],
          "client": cli["flash"][0], "gateway": gwy["flash"][0], **family_flash,
          **family_train_flash[0], LM_PATH: lm_flash(dc12, "fwd", False),
          lm_train_path: lm_flash(dc12, "fwd", True)}),
        ("flash_attention_bwd", "bwd", {"train": train["launches"][1], wf_path: wf["flash"][1],
                                        "client": cli["flash"][1], "gateway": gwy["flash"][1],
                                        **family_train_flash[1],
                                        lm_train_path: lm_flash(dc12, "bwd", True)}),
    ):
        r = fm[kind]
        # TinyLlama's (DC 1, G 8), deepseek-7b's and qwen2-moe's (DC 2, G 1) at
        # the LM cells
        lm_shapes = {"at_lm_cells": at_lm_cells(
            tuple(f"{a} {c}" for a in dc12 for c in (("prefill_32k", "train_4k")
                                                     if kind == "fwd" else ("train_4k",))),
            kind)}
        line["kernels"].append({
            "name": name,
            "route": "cuda",
            "source": flash_src,
            "replaces": flash_tpu,
            "launches": sum(by_path.values()),
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
            "family_cases": {
                "deepseek-7b (B 1, S 2048, Hq=Hkv 32, dh 128)": ds7["flash"],
                "qwen2-moe-a2.7b (B 1, S 2048, Hq=Hkv 16, dh 128)": qwen["flash"]}
            if kind == "fwd" else {
                label: r["bwd"] for label, r in (
                    ("deepseek-7b (B 1, S 2048, Hq=Hkv 32, dh 128)", ds7["flash"]),
                    ("qwen2-moe-a2.7b (B 1, S 2048, Hq=Hkv 16, dh 128)", qwen["flash"]))},
            **lm_shapes,
        })
    # MLA's keys of 192 and values of 128 at the (3, 2) chunk instantiation,
    # timed on deepseek-v2's prefill shape beside the padded values of the
    # earlier design (instantiation 3x3)
    mf = dsv2["flash"]
    for name, kind, by_path in (("flash_attention_mla", "fwd", mla_flash[0]),
                                ("flash_attention_mla_bwd", "bwd", mla_flash[1])):
        r = mf if kind == "fwd" else mf["bwd"]
        pad_r = mf["padded"] if kind == "fwd" else mf["padded"]["bwd"]
        check(mf["instance"] == "wgmma 3x2" and min(by_path.values()) > 0,
              f"{name}: launches {by_path}, instance {mf['instance']}")
        line["kernels"].append({
            "name": name,
            "route": "cuda",
            "source": flash_src,
            "replaces": flash_tpu,
            "launches": sum(by_path.values()),
            "variant": mf["variant"],
            "instance": mf["instance"],
            "launches_by_path": by_path,
            "max_abs_err": r["max_abs_err"],
            "ms": r["ms"],
            "queued_ms": r["queued_ms"],
            "l2_flushed_ms": r["l2_flushed_ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
            "held": True,
            "shape": {"B": 1, "S": MLA_SEQ, "Hq": 128, "Hkv": 128, "dh": 192, "dv": 128,
                      "causal": True, "dtype": "bfloat16"},
            "padded_values": {"instance": mf["padded"]["instance"],
                              **{k: pad_r[k] for k in ("queued_ms", "l2_flushed_ms", "ms",
                                                        "max_abs_err")}},
            # the design's kernels (the ping-pong forward; the fused
            # backward's delta, counters, key tiles and conversion) and each
            # one's device ms in one call, by the profiler, which reads short
            "kernels_of_one_call": r["kernels"],
            "ptxas": {row["kernel"]: {k: row[k] for k in ("registers", "spill_stores",
                                                          "spill_loads", "serialized")}
                      for row in flash["mla_ptxas"][kind]},
            "at_lm_cells": at_lm_cells((*(("deepseek-v2-236b prefill_32k",) if kind == "fwd"
                                          else ()), "deepseek-v2-236b train_4k"), kind),
        })
    gtr = gem["train"]
    for name, kind, by_path in (
        ("flash_attention_dh256", "fwd",
         {"gemma3 prefill": gem["prefill_launches"],
          f"gemma3 train ({gtr['depth']} layers, 5 steps, remat full)": gtr["launches"][0],
          "gemma3 6-layer check": gem["check_launches"],
          LM_PATH: lm_flash(("gemma3-4b",), "fwd", False),
          lm_train_path: lm_flash(("gemma3-4b",), "fwd", True)}),
        ("flash_attention_dh256_bwd", "bwd",
         {f"gemma3 train ({gtr['depth']} layers, 5 steps)": gtr["launches"][1],
          lm_train_path: lm_flash(("gemma3-4b",), "bwd", True)}),
    ):
        r = flash["cases"][(GEMMA_LOCAL, "bfloat16")]
        g = flash["cases"][(GEMMA_GLOBAL, "bfloat16")]
        w = flash["cases"][(FLASH_ROWS, "bfloat16")]
        check(r["variant"] == g["variant"] == "wgmma" and w["variant"] == "wgmma_rows"
              and min(by_path.values()) > 0,
              f"{name}: launches {by_path}, variants {r['variant']}/{g['variant']}/"
              f"{w['variant']}")
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
            "wgmma_rows_dh256_G3": {k: w[kind][k] for k in (
                "queued_ms", "plain_ms", "library_ms", "bound_ms", "max_abs_err")},
            "at_lm_cells": at_lm_cells((*(("gemma3-4b prefill_32k",) if kind == "fwd" else ()),
                                        "gemma3-4b train_4k"), kind),
        })
    f32_main = flash["cases"][(FLASH_MAIN, "float32")]
    for name, kind, by_path in (
        ("flash_attention_tf32x3", "fwd",
         {"fp32 smoke train (card vs CPU, 5 steps)": tpar["fwd"],
          "fp32 MoE/MLA smoke train (card vs CPU, 5 steps, three configs)":
          sum(r["launches"][0] for r in ftrain["parity"].values()),
          "fp32 gemma3 smoke prefill": pre["smoke_flash"]["fwd"],
          "fp32 deepseek-v2 witness (1 layer, dh 192, values 128)":
          dsv2["witness"]["fp32, 1 layer, reference init"]["launches"]}),
        ("flash_attention_tf32x3_bwd", "bwd",
         {"fp32 smoke train (card vs CPU, 5 steps)": tpar["bwd"],
          "fp32 MoE/MLA smoke train (card vs CPU, 5 steps, three configs)":
          sum(r["launches"][1] for r in ftrain["parity"].values())}),
    ):
        r = f32_main[kind]
        check(f32_main["variant"] == "tf32x3" and min(by_path.values()) > 0,
              f"{name}: launches {by_path}, variant {f32_main['variant']}")
        line["kernels"].append({
            "name": name,
            "route": "cuda",
            "source": flash_src,
            "replaces": flash_tpu,
            "launches": sum(by_path.values()),
            "variant": "tf32x3",
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
            "shape": dict(flash_shape, dtype="float32"),
            "cases": {c[0]: {k: flash["cases"][(c[0], "float32")][kind][k] for k in (
                "queued_ms", "plain_ms", "library_ms", "bound_ms", "max_abs_err")}
                for c in FLASH_CASES},
        })
    bm = bag["cases"][(BAG_MAIN, "float32")]
    bag_case = next(c for c in BAG_CASES if c[0] == BAG_MAIN)
    bag_paths = {f"recsys {a} {c}": r["launches"] for (a, c), r in rec["rows"].items()}
    bag_paths["recsys fp32 smoke parity (card vs CPU)"] = rec["parity_launches"]
    for arch, r in rtrain["rows"].items():
        bag_paths[f"recsys train {arch} ({TRAIN_STEPS} steps)"] = r["launches"][0]
    bag_paths["recsys fp32 smoke train parity (card vs CPU, 5 steps)"] = \
        rtrain["parity_launches"][0]
    line["kernels"].append({
        "name": "embedding_bag",
        "route": "cuda",
        "source": BAG_SRC,
        "replaces": BAG_TPU,
        "launches": sum(bag_paths.values()),
        "variant": BAG_VARIANT,
        "launches_by_path": bag_paths,
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
                  "combiner": bag_case[4], "dtype": "float32"},
        "cases": {f"{label} {tname}": {k: r[k] for k in (
            "queued_ms", "bound_ms", "plain_ms", "library_ms", "max_abs_err")}
            for (label, tname), r in bag["cases"].items()},
        "fm_serve_bulk_profile": rec["rows"][BAG_PROFILED].get("profile", {}),
    })
    bb = bwd["cases"][(BAG_BWD_MAIN, "float32")]
    bwd_case = next(c for c in BAG_BWD_TRAIN if c[0] == BAG_BWD_MAIN)
    bwd_paths = {f"recsys train {arch} ({TRAIN_STEPS} steps)": r["launches"][1]
                 for arch, r in rtrain["rows"].items()}
    bwd_paths["recsys fp32 smoke train parity (card vs CPU, 5 steps)"] = \
        rtrain["parity_launches"][1]
    line["kernels"].append({
        "name": "embedding_bag_bwd",
        "route": "cuda",
        "source": BAG_SRC,
        "replaces": BAG_TPU,
        "replaces_note": BAG_BWD_NOTE,
        "launches": sum(bwd_paths.values()),
        "variant": "sorted_chunks",
        "launches_by_path": bwd_paths,
        "launches_per_step": {arch: r["launches"][1] // TRAIN_STEPS
                              for arch, r in rtrain["rows"].items()},
        "max_abs_err": bb["max_abs_err"],
        "ms": bb["ms"],
        "queued_ms": bb["queued_ms"],
        "call_ms": bb["call_ms"],
        "call_queued_ms": bb["call_queued_ms"],
        "call_l2_flushed_ms": bb["call_flushed_ms"],
        "index_ms": bb["index_ms"],
        "fill_ms": bb["fill_ms"],
        "plain_ms": bb["plain_ms"],
        "bound_ms": bb["bound_ms"],
        "bound_by": bb["bound_by"],
        "fill_bound_ms": bb["fill_bound_ms"],
        "library_ms": bb["library_ms"],
        "held": True,
        "shape": {"case": BAG_BWD_MAIN, "arch": bwd_case[1], "cell": bwd_case[2],
                  "combiner": bwd_case[4], "dtype": "float32"},
        "cases": {f"{label} {tname}": {k: r[k] for k in (
            "queued_ms", "call_queued_ms", "bound_ms", "fill_bound_ms", "plain_ms",
            "library_ms", "max_abs_err")} for (label, tname), r in bwd["cases"].items()
            if "queued_ms" in r},
        "train_steps": {arch: {k: r[k] for k in ("mean_step_ms", "max_memory")}
                        for arch, r in rtrain["rows"].items()},
    })
    am = agg["cases"][(AGG_MAIN, "float32")]
    skew = agg["cases"][(AGG_SKEW, "float32")]["csr"]
    mb_path = f"gnn train minibatch_lg ({gtrain['steps']} steps)"
    mol, ogb, full = cells["molecule"], cells["ogb_products"], cells["agg_full"]
    for i, (name, kind) in enumerate((("gnn_aggregate", "fwd"), ("gnn_aggregate_bwd", "bwd"))):
        r, e = am["csr"][kind], am["ell"][kind]
        by_path = {mb_path: gtrain["launches"][i],
                   "gnn train full_graph_sm (1 step)": gtrain["launches_full_graph"][i],
                   f"gnn train molecule ({mol['steps']} steps)": mol["launches"][i],
                   f"gnn train ogb_products at the cut ({ogb['steps']} steps, remat full)":
                   ogb["launches"][i]}
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
            "ogb_products_full": {
                label: {"max_in_degree": full[label]["max_in_degree"],
                        **{k: full[label][kind][k] for k in (
                            "queued_ms", "flushed_ms", "ms", "bound_ms", "bound_by", "plain_ms",
                            "yardstick_ms", "max_abs_err")}}
                for label in full},
            "held": True,
            "shape": {"case": AGG_MAIN, "N": 169_984, "E": 168_960, "dim": 70,
                      "dtype": "float32", "ell_max_deg": 15,
                      "power_law": {"N": REDDIT_NODES, "E": REDDIT_EDGES_CUT}},
        })
    line["family_train"] = {arch: {
        "layers": [r["layers"], r["full_layers"]], "parameters": r["params"],
        "mean_step_ms": r["mean_step_s"] * 1e3, "tokens_per_s": r["tokens_per_s"],
        "max_memory": r["max_memory"], **({"drop_share": [x["drop_share"] for x in r["rows"]]}
                                          if "drop_share" in r["rows"][0] else {})}
        for arch, r in ftrain["train"].items()}
    line["gnn_cells"] = {
        name: {"mean_step_ms": r["mean_step_s"] * 1e3, "max_memory": r["max_memory"],
               **{k: v for k, v in r.items() if k.endswith("_per_s")}}
        for name, r in (("molecule", mol), ("ogb_products", ogb))}
    dr["steps"].update({f"{r['arch']} {r['cell']} at the cut": r["dryrun"]
                        for r in lm["rows"].values()})
    line["dryrun"] = dr
    line["lm_cells"] = {label: {
        "B": r["B"], "T": r["T"], "layers": r["layers"], "cuts": r["cuts"],
        "step_ms": r["step_ms"], "median_ms": r["median_ms"], "tokens_per_s": r["tokens_per_s"],
        "idle_share": r["profile"].get("idle_share"), "top_ops": r["profile"].get("top"),
        "fused_busy_share": r["profile"].get("watch", {}).get(
            "decode_attention_fused", {}).get("busy_share"),
        "peak": r["dryrun"]["measured_peak"], "reckoned_peak": r["dryrun"]["reckoned_peak"],
        **({"card_vs_cpu": {k: r["cpu_check"][k] for k in (
            "max_abs_err", "largest", "control", "layers", "flips")}}
           if "cpu_check" in r else {}),
        **({"data_bound_ms": r["bounds"]} if r.get("bounds") else {}),
        **({"moe_groups": r["moe_groups"], "dropped_routed": r["drops"]}
           if "moe_groups" in r else {}),
        **({"remat": r["remat"], "losses": [m["loss"] for m in r["metrics"]],
            "grad_norms": [m["grad_norm"] for m in r["metrics"]],
            "flash_busy_share": {w: x["busy_share"] for w, x in r["profile"].get(
                "watch", {}).items()},
            "gradient_check": {k: r["grad_check"][k]["dist"] for k in (
                "kernels", "plain bf16", "planted")},
            "gradient_check_flips": r["grad_check"]["flips"]} if "grad_check" in r else {})}
        for label, r in lm["rows"].items()}
    line["store_server"] = {**store["tier"], "restore": store["restore"]}
    line["client"] = {
        "policies": {k: v["rows"] for k, v in cli["evaluation"].items()},
        "evaluation_s": {k: v["seconds"] for k, v in cli["evaluation"].items()},
        "run_s": cli["local"]["run_s"], "save_s": cli["local"]["save_s"],
        "load_s": cli["local"]["load_s"], "recommend_ms": cli["local"]["recommend_ms"],
        "restore_ms": cli["cluster"]["restore"], "elections": cli["cluster"]["elections"],
        "failover_reads": cli["cluster"]["failover_reads"]}
    line["gateway"] = {
        "run_s": {k: r["run_s"] for k, r in gwy["runs"].items()},
        "n_skipped": {k: r["n_skipped"] for k, r in gwy["runs"].items()},
        "quota_429": gwy["quota"], "drain": gwy["drain"], "events": gwy["events"],
        "recommend_ms": gwy["recommend_ms"], "metrics": gwy["metrics"],
        "rollup": gwy["trace"]["rollup"], "trace_processes": gwy["trace"]["processes"],
        "critical_path": gwy["trace"]["critical_path"], "cli": gwy["cli"],
        "prefix_compute_s": gwy["prefix_compute_s"], "prefix_load": gwy["trace"]["load"],
        "wall_s": gwy["wall_s"]}
    line["gemma3_serve"] = {
        "decode_ms_graph": g3s["graph_ms"], "decode_ms_replay": g3s["replay_ms"],
        "decode_ms_eager": g3s["eager_ms"],
        "decode_bound_ms": {k: ms for k, (_, ms) in g3s["bounds"].items()},
        "prefill_ms_per_chunk_call": g3s["chunk_ms"],
        "long_prefill_ms_per_chunk_call": g3s["long_chunk_ms"],
        "chunks_skipped": [[r["skipped"], r["n"]] for r in g3s["rows"]],
        "snapshot_bytes_per_token_layer": g3s["snapshot"][2], "launches": g3s["launches"],
        "chunk_call_profile": {k: g3s["chunk_profile"].get(k)
                               for k in ("wall_ms", "busy_ms", "idle_share", "watch")},
        "chunk_cluster": g3s["cluster"],
        "chain_errs": {"logits": g3s["chain_errs"]["logits"],
                       **{k: max(e / r for e, r in g3s["chain_errs"][k]) for k in ("k", "v")}}}
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
