"""The hand-written CUDA kernels against their plain torch versions, on the
card.  They have no CPU mode, so these tests skip where no CUDA device is
present; on the card they run with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py

This file imports torch and the port only (no JAX), so it runs on a machine
that has no JAX installed."""
import re

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.decode_attention import ops
from repro_torch.models import attention

TOLS = {torch.float32: 2e-5, torch.bfloat16: 2e-2}  # as tests/test_kernels.py

# (B, S, Hq, Hkv, T, dh, q_start, window)
CASES = [
    (1, 1, 32, 4, 1024, 64, [575], None),
    (4, 64, 32, 4, 1024, 64, [0, 64, 448, 960], None),
    (2, 64, 8, 4, 1024, 256, [700, 300], 256),
    (2, 16, 8, 2, 256, 8, [0, 200], None),
    (3, 5, 4, 1, 200, 128, [0, 33, 190], 16),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_kernel_matches_plain(case, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    B, S, Hq, Hkv, T, dh, qs, window = case
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn(B, S, Hq, dh, generator=g, device=dev).to(dtype)
    k = torch.randn(B, T, Hkv, dh, generator=g, device=dev).to(dtype)
    v = torch.randn(B, T, Hkv, dh, generator=g, device=dev).to(dtype)
    q_start = torch.tensor(qs, dtype=torch.int32, device=dev)
    before = dict(ops.decode_attention.launches_by_variant)
    got = ops.decode_attention(q, k, v, q_start, window=window)
    want = attention.decode_attention(q, k, v, q_start, window=window)
    torch.cuda.synchronize()
    # the split variant at any S: its split kernel and its combine kernel
    assert ops.decode_attention.launches_by_variant == {
        "split": before["split"] + 2, "fused": before["fused"], "chunk": before["chunk"]}
    torch.testing.assert_close(got.float(), want.float(), atol=TOLS[dtype], rtol=TOLS[dtype])


@pytest.mark.cuda
def test_decode_attention_kernel_rejects_bad_inputs():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    q = torch.zeros(1, 1, 4, 12, device=dev)  # head dim not a multiple of 8
    kv = torch.zeros(1, 16, 2, 12, device=dev)
    qs = torch.zeros(1, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="head dim"):
        ops.decode_attention(q, kv, kv, qs)
    with pytest.raises(TypeError, match="int32"):
        ops.decode_attention(q[..., :8].contiguous(), kv[..., :8].contiguous(),
                             kv[..., :8].contiguous(), qs.long())


# --------------------------------------------------------------------------
# decode attention, fused variant: write the new K/V row, attend, combine the
# KV splits in a cluster, in one launch
# --------------------------------------------------------------------------
# (B, Hq, Hkv, T, dh, q_start, window)
FUSED_CASES = [
    (1, 32, 4, 1024, 64, [575], None),  # the S = 1 row of CASES: TinyLlama's decode step
    (4, 32, 4, 1024, 64, [0, 1023, 575, 7], None),  # q_start 0 and T - 1
    (1, 8, 2, 256, 8, [150], None),  # the smoke config's head dim
    (2, 8, 8, 300, 128, [0, 299], None),  # G 1
    (2, 16, 1, 512, 256, [300, 10], None),  # G 16, dh 256
    (3, 8, 2, 1000, 64, [999, 5, 500], 100),  # a window
    (1, 64, 4, 4096, 64, [4000], 256),  # G 16, eight splits of 512, a window
    (2, 4, 2, 20, 16, [3, 19], None),  # one split, a ragged tile
    # rows that are not a power of two bytes: key tiles of 64 (bf16) and 32
    # (fp32) at dh 96, 128 and 64 at dh 40, 32 and 16 at dh 136
    (2, 16, 2, 1000, 96, [999, 400], None),
    (1, 8, 1, 700, 40, [650], 300),
    (3, 6, 2, 333, 136, [0, 200, 332], None),
    # deepseek-7b's and qwen2-moe-a2.7b's decode step: G 1 at dh 128
    (1, 32, 32, 1024, 128, [575], None),
    (1, 16, 16, 1024, 128, [600], None),
    # plans past one cluster of splits (clusters combined through the
    # workspace and the tickets): one visible key, and mixed lengths
    (1, 32, 4, 65536, 64, [0], None),
    (1, 32, 4, 65536, 64, [1], None),
    (4, 32, 4, 65536, 64, [10, 32768, 65535, 3], None),
    (1, 8, 4, 131072, 256, [0], None),
    (1, 8, 4, 131072, 256, [1], None),
    (4, 8, 4, 131072, 256, [10, 65536, 131071, 3], None),
    (2, 8, 4, 131072, 256, [70000, 131071], 1024),  # a window over a long cache
]


def _fused_inputs(case, dtype, seed=0):
    B, Hq, Hkv, T, dh, qs, _ = case
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(B, 1, Hq, dh, generator=g, device=dev).to(dtype)
    k_new = torch.randn(B, 1, Hkv, dh, generator=g, device=dev).to(dtype)
    v_new = torch.randn(B, 1, Hkv, dh, generator=g, device=dev).to(dtype)
    k = torch.randn(B, T, Hkv, dh, generator=g, device=dev).to(dtype)
    v = torch.randn(B, T, Hkv, dh, generator=g, device=dev).to(dtype)
    q_start = torch.tensor(qs, dtype=torch.int32, device=dev)
    return q, k_new, v_new, k, v, q_start


@pytest.mark.cuda
@pytest.mark.parametrize("case", FUSED_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_decode_attention_matches_plain(case, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    B, Hq, Hkv, T, dh, qs, window = case
    assert ops.variant(1, Hq // Hkv, dh, dtype) == "fused"
    q, k_new, v_new, k, v, q_start = _fused_inputs(case, dtype)
    k_want, v_want = k.clone(), v.clone()
    want = attention.decode_attention_insert(
        q, k_new, v_new, k_want, v_want, q_start, window=window)
    runs = []
    for _ in range(2):
        k_got, v_got = k.clone(), v.clone()
        before = dict(ops.decode_attention.launches_by_variant)
        got = ops.decode_attention_insert(q, k_new, v_new, k_got, v_got, q_start, window=window)
        torch.cuda.synchronize()
        # one launch of the fused kernel, nothing of the split variant
        assert ops.decode_attention.launches_by_variant["fused"] == before["fused"] + 1
        assert ops.decode_attention.launches_by_variant["split"] == before["split"]
        torch.testing.assert_close(got.float(), want.float(), atol=TOLS[dtype], rtol=TOLS[dtype])
        # the new rows were written, and nothing else of the caches changed
        assert torch.equal(k_got, k_want) and torch.equal(v_got, v_want)
        runs.append(got)
    assert torch.equal(runs[0], runs[1])  # reruns are equal bit for bit


@pytest.mark.cuda
@pytest.mark.parametrize("G", [17, 32])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_insert_wide_groups_take_the_split_kernel(G, dtype):
    """More query rows per KV head than a fused block holds: the wrapper
    writes the new rows, then runs the split variant (two kernels)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    case = (2, 2 * G, 2, 512, 64, [100, 511], None)
    assert ops.variant(1, G, 64, dtype) == "split"
    q, k_new, v_new, k, v, q_start = _fused_inputs(case, dtype)
    k_want, v_want = k.clone(), v.clone()
    want = attention.decode_attention_insert(q, k_new, v_new, k_want, v_want, q_start)
    before = dict(ops.decode_attention.launches_by_variant)
    got = ops.decode_attention_insert(q, k_new, v_new, k, v, q_start)
    torch.cuda.synchronize()
    assert ops.decode_attention.launches_by_variant == {
        "split": before["split"] + 2, "fused": before["fused"], "chunk": before["chunk"]}
    torch.testing.assert_close(got.float(), want.float(), atol=TOLS[dtype], rtol=TOLS[dtype])
    assert torch.equal(k, k_want) and torch.equal(v, v_want)


@pytest.mark.cuda
def test_fused_decode_attention_writes_nothing_past_the_cache():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    case = (2, 8, 2, 64, 16, [63, 64], None)  # the second sequence is full
    q, k_new, v_new, k, v, q_start = _fused_inputs(case, torch.float32)
    k_got, v_got = k.clone(), v.clone()
    got = ops.decode_attention_insert(q, k_new, v_new, k_got, v_got, q_start)
    torch.cuda.synchronize()
    assert torch.equal(k_got[1], k[1]) and torch.equal(v_got[1], v[1])
    # sequence 1 attends its whole cache, as the plain attention does
    want = attention.decode_attention(q[1:], k[1:], v[1:], q_start[1:])
    torch.testing.assert_close(got[1:], want, atol=TOLS[torch.float32], rtol=TOLS[torch.float32])


@pytest.mark.cuda
def test_fused_decode_attention_counts_graph_replays():
    """A call recorded into a CUDA graph launches nothing; each replay of the
    graph launches the fused kernel once."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    case = (1, 32, 4, 1024, 64, [575], None)
    q, k_new, v_new, k, v, q_start = _fused_inputs(case, torch.bfloat16)
    ops.decode_attention_insert(q, k_new, v_new, k, v, q_start)  # warm-up, outside the capture
    torch.cuda.synchronize()
    ops.reset_launches()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = ops.decode_attention_insert(q, k_new, v_new, k, v, q_start)
    assert ops.decode_attention.launches_by_variant == {"split": 0, "fused": 0, "chunk": 0}
    assert ops.decode_attention.captured_by_variant == {"split": 0, "fused": 1, "chunk": 0}
    k_want, v_want = k.clone(), v.clone()
    want = attention.decode_attention_insert(q, k_new, v_new, k_want, v_want, q_start)
    for _ in range(3):
        graph.replay()
        ops.count_replays({"fused": 1})
    torch.cuda.synchronize()
    assert ops.decode_attention.launches_by_variant == {"split": 0, "fused": 3, "chunk": 0}
    torch.testing.assert_close(out.float(), want.float(), atol=2e-2, rtol=2e-2)
    assert torch.equal(k, k_want)


@pytest.mark.cuda
def test_fused_decode_attention_graph_replays_across_split_boundaries():
    """One call past one cluster of splits (T 131,072, bf16) captured once:
    replays while q_start moves across tile, split and cluster boundaries
    equal eager calls bit for bit (each block cuts its keys from the live
    length on the card; the tickets are back at 0 after every launch)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    case = (1, 8, 4, 131072, 256, [0], None)
    q, k_new, v_new, k, v, q_start = _fused_inputs(case, torch.bfloat16)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    tk, n_splits, cluster = ops.plan_fused(1, 4, 131072, 256, torch.bfloat16, n_sm)
    assert n_splits > cluster
    ops.decode_attention_insert(q, k_new, v_new, k, v, q_start)  # warm-up, outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = ops.decode_attention_insert(q, k_new, v_new, k, v, q_start)
    for qs in (0, tk - 1, tk, n_splits * tk - 1, n_splits * tk, 8 * n_splits * tk + 3, 131071):
        q_start.fill_(qs)
        graph.replay()
        replayed = out.clone()
        eager = ops.decode_attention_insert(q, k_new, v_new, k, v, q_start)
        torch.cuda.synchronize()
        assert torch.equal(replayed, eager), qs


@pytest.mark.cuda
def test_fused_decode_attention_rejects_bad_inputs():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    q, k_new, v_new, k, v, q_start = _fused_inputs((1, 8, 2, 64, 16, [5], None), torch.float32)
    with pytest.raises(TypeError, match="int32"):
        ops.decode_attention_insert(q, k_new, v_new, k, v, q_start.long())
    with pytest.raises(ValueError, match="do not agree"):
        ops.decode_attention_insert(q, k_new[:, :, :1].contiguous(), v_new, k, v, q_start)
    with pytest.raises(ValueError, match="16-byte"):
        flat = torch.zeros(k.numel() + 1, device=k.device)
        ops.decode_attention_insert(q, k_new, v_new, flat[1:].view(k.shape), v, q_start)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "qwen2-moe-a2.7b", "deepseek-v2-236b"])
def test_engine_graph_on_the_card_matches_the_cpu(arch):
    """The fp32 smoke engine on the card, which replays one captured graph a
    token, gives the CPU engine's tokens over the smoke stream, and the
    snapshots it stored are untouched by later requests.  qwen2-moe-smoke's
    graph holds the MoE routing (no read back to the host); deepseek-v2-smoke's
    holds MLA's absorbed attention, which is plain torch: no decode kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models.layers import init_params
    from repro_torch.models.transformer import lm_specs
    from repro_torch.serve import ServeEngine

    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype=torch.float32)
    cpu_params = init_params(torch.Generator().manual_seed(0), lm_specs(cfg), cfg.dtype, "cpu")

    def to_card(tree):
        if isinstance(tree, dict):
            return {k: to_card(v) for k, v in tree.items()}
        return tree.cuda()

    dev_params = to_card(cpu_params)
    on_dev = ServeEngine(cfg, dev_params, max_len=128, chunk=16, device="cuda")
    on_cpu = ServeEngine(cfg, cpu_params, max_len=128, chunk=16, device="cpu")
    rng = np.random.default_rng(0)
    system = rng.integers(0, cfg.vocab, size=48).tolist()
    prompts = [system + rng.integers(0, cfg.vocab, size=16).tolist() for _ in range(6)]
    ops.reset_launches()
    tokens = 0
    snaps = None
    for i, prompt in enumerate(prompts + [system, system]):
        a, sa = on_dev.generate(prompt, max_new_tokens=8)
        b, sb = on_cpu.generate(prompt, max_new_tokens=8)
        assert a == b, f"request {i + 1}"
        assert sa.chunks_skipped == sb.chunks_skipped
        tokens += sa.n_new_tokens
        if i == 2:  # after the system prompt was stored: copies of every snapshot
            snaps = {key: {n: t.clone() for n, t in on_dev.snapshots.load(key).cache.items()}
                     for key in list(on_dev.policy.stored)}
    assert snaps, "no snapshot was stored"
    for key, cache in snaps.items():
        now = on_dev.snapshots.load(key).cache
        assert all(torch.equal(now[n], t) for n, t in cache.items()), key
    # every decode step's attention ran the fused kernel: one per layer per
    # replayed token, plus the capture's eager warm-up step (none for MLA)
    assert on_dev._graph is not None
    fused = 0 if cfg.mla is not None else cfg.n_layers
    assert on_dev._graph.kernels == ({"fused": fused} if fused else {})
    assert ops.decode_attention.launches_by_variant["fused"] == fused * (tokens + 1)


# --------------------------------------------------------------------------
# decode attention, chunk variant: write a prefill chunk's K/V rows and
# attend with wgmma, in one launch
# --------------------------------------------------------------------------
# (B, S, Hq, Hkv, T, dh, q_start, window)
CHUNK_CASES = [
    (1, 64, 32, 4, 1024, 64, [512], None),  # the engine's chunk call (TinyLlama)
    (4, 64, 32, 4, 1024, 64, [0, 64, 448, 960], None),  # mixed starts, one ending at T
    (3, 13, 32, 4, 1024, 64, [5, 333, 1000], None),  # unaligned starts, S not a multiple of 64/G
    (2, 64, 32, 4, 1024, 64, [700, 77], 100),  # a window
    (2, 64, 16, 2, 512, 128, [128, 300], None),  # dh 128
    (2, 37, 32, 4, 1024, 64, [987, 0], None),  # the last rows of T, unaligned
    (1, 100, 4, 4, 300, 64, [150], 40),  # G 1, two row tiles of 64 positions
    (1, 3, 64, 1, 200, 64, [10], None),  # G 64: one position a row tile
    (2, 20, 8, 2, 128, 16, [5, 100], None),  # dh 16, two blocks a cluster
    (1, 33, 8, 2, 256, 72, [40], 50),  # dh 72: padded columns
    (1, 64, 8, 1, 1024, 64, [700], None),  # eight blocks a cluster
    (8, 64, 32, 4, 256, 64, [0, 17, 64, 100, 128, 150, 190, 192], None),  # one block a row tile
    (1, 64, 32, 32, 1024, 128, [512], None),  # deepseek-7b's engine chunk: G 1, dh 128
    (1, 64, 16, 16, 1024, 128, [448], None),  # qwen2-moe-a2.7b's
    # gemma3-4b's served chunk (G 2, dh 256, T 2048): a local layer at the
    # first requests' positions, the long request's last chunk (the window
    # bites), a global layer
    (1, 64, 8, 4, 2048, 256, [512], 1024),
    (1, 64, 8, 4, 2048, 256, [1536], 1024),
    (1, 64, 8, 4, 2048, 256, [1536], None),
    (2, 64, 8, 4, 2048, 256, [77, 1001], 1024),  # B 2, unaligned starts
    (2, 37, 16, 8, 1024, 192, [333, 5], None),  # dh 192, unaligned, S not a multiple of 32
    (1, 64, 4, 4, 512, 256, [200], None),  # G 1 at dh 256
    (1, 20, 16, 2, 256, 136, [100], None),  # G 8 at dh 136: padded columns
    (1, 64, 8, 1, 1024, 192, [700], 100),  # a window that cuts keys, G 8 at dh 192
    (2, 50, 4, 2, 512, 136, [13, 400], 64),  # G 2 at dh 136, windowed, unaligned
]


def _chunk_inputs(case, dtype, seed=0):
    B, S, Hq, Hkv, T, dh, qs, _ = case
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(B, S, Hq, dh, generator=g, device=dev).to(dtype)
    k_new = torch.randn(B, S, Hkv, dh, generator=g, device=dev).to(dtype)
    v_new = torch.randn(B, S, Hkv, dh, generator=g, device=dev).to(dtype)
    k = torch.randn(B, T, Hkv, dh, generator=g, device=dev).to(dtype)
    v = torch.randn(B, T, Hkv, dh, generator=g, device=dev).to(dtype)
    q_start = torch.tensor(qs, dtype=torch.int32, device=dev)
    return q, k_new, v_new, k, v, q_start


@pytest.mark.cuda
@pytest.mark.parametrize("case", CHUNK_CASES)
def test_chunk_decode_attention_matches_plain(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    B, S, Hq, Hkv, T, dh, qs, window = case
    dtype = torch.bfloat16
    assert ops.variant(S, Hq // Hkv, dh, dtype) == "chunk"
    # the cases cover clusters of 1, 2, 4 and 8 blocks
    assert ops.plan_chunk(B, S, Hq // Hkv, Hkv, T, 132) in (1, 2, 4, 8)
    q, k_new, v_new, k, v, q_start = _chunk_inputs(case, dtype)
    k_want, v_want = k.clone(), v.clone()
    want = attention.decode_attention_chunk(
        q, k_new, v_new, k_want, v_want, q_start, window=window)
    runs = []
    for _ in range(2):
        k_got, v_got = k.clone(), v.clone()
        before = dict(ops.decode_attention.launches_by_variant)
        got = ops.decode_attention_chunk(q, k_new, v_new, k_got, v_got, q_start, window=window)
        torch.cuda.synchronize()
        # one launch of the chunk kernel, no other kernel of the family
        assert ops.decode_attention.launches_by_variant == {
            "split": before["split"], "fused": before["fused"], "chunk": before["chunk"] + 1}
        torch.testing.assert_close(got.float(), want.float(), atol=TOLS[dtype], rtol=TOLS[dtype])
        # the chunk's rows were written, and nothing else of the caches changed
        assert torch.equal(k_got, k_want) and torch.equal(v_got, v_want)
        runs.append(got)
    assert torch.equal(runs[0], runs[1])  # reruns are equal bit for bit


@pytest.mark.cuda
def test_chunk_decode_attention_writes_nothing_past_the_cache():
    """Sequence 0's chunk runs 10 rows into T and 54 past it: the rows past T
    are not written (they would land on sequence 1's first rows), and its
    first 10 query rows are what a 10-row chunk gives."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    case = (2, 64, 32, 4, 256, 64, [246, 100], None)
    q, k_new, v_new, k, v, q_start = _chunk_inputs(case, torch.bfloat16)
    k_got, v_got = k.clone(), v.clone()
    got = ops.decode_attention_chunk(q, k_new, v_new, k_got, v_got, q_start)
    torch.cuda.synchronize()
    assert torch.equal(k_got[0, :246], k[0, :246]) and torch.equal(k_got[0, 246:], k_new[0, :10])
    assert torch.equal(v_got[0, :246], v[0, :246]) and torch.equal(v_got[0, 246:], v_new[0, :10])
    assert torch.equal(k_got[1, :100], k[1, :100]) and torch.equal(k_got[1, 164:], k[1, 164:])
    assert torch.equal(v_got[1, :100], v[1, :100]) and torch.equal(v_got[1, 164:], v[1, 164:])
    k_want, v_want = k[:1].clone(), v[:1].clone()
    want = attention.decode_attention_chunk(
        q[:1, :10], k_new[:1, :10], v_new[:1, :10], k_want, v_want, q_start[:1])
    torch.testing.assert_close(got[:1, :10].float(), want.float(), atol=2e-2, rtol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, dh, Hq", [(torch.float32, 64, 8), (torch.bfloat16, 256, 6),
                                           (torch.bfloat16, 8, 8)])
def test_other_chunks_never_launch_the_chunk_kernel(dtype, dh, Hq):
    """fp32 chunks (the exact parity path), a group that does not divide
    64 (G 3 at dh 256) and dh 8 take the index writes and the split kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    case = (2, 16, Hq, 2, 256, dh, [0, 200], None)
    assert ops.variant(16, Hq // 2, dh, dtype) == "split"
    q, k_new, v_new, k, v, q_start = _chunk_inputs(case, dtype)
    k_want, v_want = k.clone(), v.clone()
    want = attention.decode_attention_chunk(q, k_new, v_new, k_want, v_want, q_start)
    before = dict(ops.decode_attention.launches_by_variant)
    got = ops.decode_attention_chunk(q, k_new, v_new, k, v, q_start)
    torch.cuda.synchronize()
    assert ops.decode_attention.launches_by_variant == {
        "split": before["split"] + 2, "fused": before["fused"], "chunk": before["chunk"]}
    torch.testing.assert_close(got.float(), want.float(), atol=TOLS[dtype], rtol=TOLS[dtype])
    assert torch.equal(k, k_want) and torch.equal(v, v_want)


@pytest.mark.cuda
def test_chunk_decode_attention_counts_graph_replays():
    """The chunk kernel's plan comes from static shapes and q_start stays on
    the card, so a CUDA graph captures the call: the capture launches
    nothing, and each replay runs the kernel once."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    case = CHUNK_CASES[0]
    q, k_new, v_new, k, v, q_start = _chunk_inputs(case, torch.bfloat16)
    ops.decode_attention_chunk(q, k_new, v_new, k, v, q_start)  # warm-up, outside the capture
    torch.cuda.synchronize()
    ops.reset_launches()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = ops.decode_attention_chunk(q, k_new, v_new, k, v, q_start)
    assert ops.decode_attention.launches_by_variant == {"split": 0, "fused": 0, "chunk": 0}
    assert ops.decode_attention.captured_by_variant == {"split": 0, "fused": 0, "chunk": 1}
    k_want, v_want = k.clone(), v.clone()
    want = attention.decode_attention_chunk(q, k_new, v_new, k_want, v_want, q_start)
    for _ in range(3):
        graph.replay()
        ops.count_replays({"chunk": 1})
    torch.cuda.synchronize()
    assert ops.decode_attention.launches_by_variant == {"split": 0, "fused": 0, "chunk": 3}
    torch.testing.assert_close(out.float(), want.float(), atol=2e-2, rtol=2e-2)
    assert torch.equal(k, k_want) and torch.equal(v, v_want)


@pytest.mark.cuda
def test_chunk_decode_attention_rejects_bad_inputs():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    case = (1, 16, 8, 2, 64, 16, [5], None)
    q, k_new, v_new, k, v, q_start = _chunk_inputs(case, torch.bfloat16)
    before = dict(ops.decode_attention.launches_by_variant)
    with pytest.raises(TypeError, match="int32"):
        ops.decode_attention_chunk(q, k_new, v_new, k, v, q_start.long())
    with pytest.raises(ValueError, match="do not agree"):
        ops.decode_attention_chunk(q, k_new[:, :8].contiguous(), v_new, k, v, q_start)
    with pytest.raises(TypeError, match="fp32 or bf16"):
        ops.decode_attention_chunk(q, k_new.float(), v_new, k, v, q_start)
    with pytest.raises(ValueError, match="16-byte"):
        flat = torch.zeros(k.numel() + 1, dtype=k.dtype, device=k.device)
        ops.decode_attention_chunk(q, k_new, v_new, flat[1:].view(k.shape), v, q_start)
    assert ops.decode_attention.launches_by_variant == before  # nothing was launched


# --------------------------------------------------------------------------
# flash attention: forward (out, lse) and backward (dq, dk, dv)
# --------------------------------------------------------------------------
from repro_torch.kernels.flash_attention import attention_lse_ref, attention_ref
from repro_torch.kernels.flash_attention import ops as flash_ops

# (B, S, Hq, Hkv, dh, causal, window): the train shape, gemma3-like local,
# smoke, ragged non-causal, MQA/MHA with a ragged edge, a head dim the bf16
# kernels pad to 16 (24) at G 3, which does not divide 64 and takes the
# wgmma_rows kernels (the rows of a kv head gathered first), and dh 136 with
# a window on a non-causal layer; then edges of the wgmma
# kernels: S not a multiple of their row (128) or key (64, 128) tiles, G 1,
# 2, 8 and 64, a window on a causal and on a non-causal layer, dh 16 and 128
# (two 64-column chunks); then head dims above 128 (WIDE_FLASH_CASES)
FLASH_CASES = [
    (4, 2048, 32, 4, 64, True, None),
    (1, 2048, 8, 4, 256, True, 1024),
    (2, 64, 8, 2, 8, True, None),
    (2, 200, 8, 2, 64, False, None),
    (1, 77, 4, 1, 32, True, 16),
    (2, 130, 4, 4, 128, True, None),
    (1, 90, 6, 3, 24, True, None),
    (1, 100, 2, 1, 136, False, 40),
    (1, 1000, 8, 8, 64, True, None),
    (2, 2047, 4, 2, 16, True, 300),
    (1, 1000, 16, 2, 128, False, None),
    (1, 2047, 16, 2, 64, False, 128),
    (1, 333, 64, 1, 32, True, None),
    (2, 517, 8, 1, 64, True, 100),
]
# dh 136 (three 64-column chunks, the last mostly padding), 192 (three) and
# 256 (four; gemma3's local and global layers at G 2) at G 1, 2 and 8,
# causal, windowed and non-causal, with S ragged against the 64-key and
# 128-row tiles; and dh 256 at G 3, which takes the wgmma_rows kernels
WIDE_FLASH_CASES = [
    (1, 333, 2, 1, 136, True, None),
    (2, 200, 8, 8, 136, False, None),
    (1, 517, 16, 2, 136, True, 100),
    (1, 300, 2, 1, 192, True, 64),
    (1, 1000, 8, 8, 192, True, None),
    (2, 130, 16, 2, 192, False, None),
    (1, 2048, 8, 4, 256, True, None),
    (2, 259, 4, 4, 256, True, 50),
    (1, 777, 16, 2, 256, False, None),
    (1, 100, 8, 1, 256, False, 40),
    (1, 190, 6, 2, 256, True, None),
]
# groups past one 64-row tile (G 72 and 128: a row tile is then 64 heads of
# one position, in the wgmma_rows and the tf32x3 kernels), G 5 at dh 256
# with a window, and the wgmma_rows kernels at two and three 64-column
# chunks (G 3 at dh 96, G 5 at dh 136)
FLASH_CASES += WIDE_FLASH_CASES + [
    (1, 70, 72, 1, 64, True, None),
    (1, 33, 128, 1, 16, False, None),
    (2, 150, 10, 2, 256, True, 64),
    (1, 45, 9, 3, 96, True, 16),
    (1, 77, 15, 3, 136, False, 20),
    # the prefill attention of deepseek-7b (Hq 32) and qwen2-moe-a2.7b (Hq
    # 16): MHA, G 1 at dh 128
    (1, 2048, 32, 32, 128, True, None),
    (1, 2048, 16, 16, 128, True, None),
]


def flash_oracle(q, k, v, dout, causal, window):
    """The plain version plus autograd, in fp32 on the same values: for bf16
    inputs the tolerance then measures the kernel's rounding alone."""
    q32, k32, v32 = (t.detach().float().requires_grad_(True) for t in (q, k, v))
    out = attention_ref(q32, k32, v32, causal=causal, window=window)
    dq, dk, dv = torch.autograd.grad(out, (q32, k32, v32), dout.float())
    lse = attention_lse_ref(q32.detach(), k32.detach(), causal=causal, window=window)
    return out.detach(), lse, dq, dk, dv


@pytest.mark.cuda
@pytest.mark.parametrize(
    "case, dtype",
    [(c, d) for d in (torch.float32, torch.bfloat16) for c in FLASH_CASES],
)
def test_flash_attention_kernels_match_plain(case, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    B, S, Hq, Hkv, dh, causal, window = case
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    q = torch.randn(B, S, Hq, dh, generator=g, device=dev).to(dtype)
    k = torch.randn(B, S, Hkv, dh, generator=g, device=dev).to(dtype)
    v = torch.randn(B, S, Hkv, dh, generator=g, device=dev).to(dtype)
    dout = torch.randn(B, S, Hq, dh, generator=g, device=dev).to(dtype)
    want = flash_oracle(q, k, v, dout, causal, window)
    fa = flash_ops.flash_attention
    var = flash_ops.variant(dtype, dh, Hq // Hkv)
    f0, b0 = fa.launches_fwd, fa.launches_bwd
    v0 = dict(fa.launches_by_variant[var])
    qg, kg, vg = (t.clone().requires_grad_(True) for t in (q, k, v))
    out = flash_ops.flash_attention(qg, kg, vg, causal=causal, window=window)
    dq, dk, dv = torch.autograd.grad(out, (qg, kg, vg), dout)
    _, lse = flash_ops.flash_attention_fwd(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa.launches_fwd == f0 + 2
    assert fa.launches_bwd == b0 + 1
    assert fa.launches_by_variant[var] == {"fwd": v0["fwd"] + 2, "bwd": v0["bwd"] + 1}
    tol = TOLS[dtype]
    for name, got, ref in zip(("out", "lse", "dq", "dk", "dv"), (out, lse, dq, dk, dv), want):
        assert got.dtype == (torch.float32 if name == "lse" else dtype), name
        torch.testing.assert_close(got.float(), ref, atol=tol, rtol=tol, msg=name)


@pytest.mark.cuda
def test_flash_attention_train_shape_runs_wgmma():
    """The train step's attention shape (bf16, dh 64, G 8) takes the wgmma
    kernels, forward and backward, as the per-variant counters show."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(3)
    q = torch.randn(4, 2048, 32, 64, generator=g, device=dev).to(torch.bfloat16)
    kv = torch.randn(4, 2048, 4, 64, generator=g, device=dev).to(torch.bfloat16)
    q.requires_grad_(True)
    flash_ops.reset_launches()
    out = flash_ops.flash_attention(q, kv, kv, causal=True)
    out.backward(torch.ones_like(out))
    torch.cuda.synchronize()
    by = flash_ops.flash_attention.launches_by_variant
    assert flash_ops.variant(torch.bfloat16, 64, 8) == "wgmma"
    assert by["wgmma"] == {"fwd": 1, "bwd": 1}
    assert by["wgmma_rows"] == by["tf32x3"] == {"fwd": 0, "bwd": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_mla_prefill_shape_with_padded_values(dtype):
    """deepseek-v2's prefill attention (MHA over 128 heads, keys of nope 128
    + rope 64 = 192 columns, values of 128): the model pads the values with
    zero columns to 192, runs the flash forward (bf16: ``wgmma`` at three
    64-column chunks) and keeps the first 128 output columns, which must be
    the attention over the unpadded values; the padded columns come out zero.
    The backward runs as the model's autograd takes it: the cut gives the
    kernel a dout whose 64 padded columns are zero, and the pad's backward
    keeps dv's first 128 columns; dq, dk and dv are held against fp32
    autograd of ``attention_ref`` on the unpadded values (padded inside the
    graph, the output cut)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    B, S, H, dh, dv = 1, 1024, 128, 192, 128
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(7)
    q = torch.randn(B, S, H, dh, generator=g, device=dev).to(dtype)
    k = torch.randn(B, S, H, dh, generator=g, device=dev).to(dtype)
    v = torch.randn(B, S, H, dv, generator=g, device=dev).to(dtype)
    dout = torch.randn(B, S, H, dv, generator=g, device=dev).to(dtype)
    qg, kg, vg = (t.clone().requires_grad_(True) for t in (q, k, v))
    flash_ops.reset_launches()
    out = flash_ops.flash_attention(qg, kg, torch.nn.functional.pad(vg, (0, dh - dv)),
                                    causal=True)
    dq, dk, dvg = torch.autograd.grad(out[..., :dv], (qg, kg, vg), dout)
    torch.cuda.synchronize()
    want_var = "tf32x3" if dtype == torch.float32 else "wgmma"
    assert flash_ops.variant(dtype, dh, 1) == want_var
    assert flash_ops.flash_attention.launches_by_variant[want_var] == {"fwd": 1, "bwd": 1}
    assert torch.equal(out[..., dv:], torch.zeros_like(out[..., dv:]))
    assert dvg.shape == v.shape
    q32, k32, v32 = (t.float().requires_grad_(True) for t in (q, k, v))
    want = attention_ref(q32, k32, torch.nn.functional.pad(v32, (0, dh - dv)),
                         causal=True)[..., :dv]
    wq, wk, wv = torch.autograd.grad(want, (q32, k32, v32), dout.float())
    tol = dict(atol=TOLS[dtype], rtol=TOLS[dtype])
    torch.testing.assert_close(out[..., :dv].detach().float(), want.detach(), **tol)
    for got, ref in ((dq, wq), (dk, wk), (dvg, wv)):
        torch.testing.assert_close(got.float(), ref, **tol)


# (B, S, Hq, Hkv, dh, dv, causal, window): values narrower than keys, as
# the kernels take them natively.  deepseek-v2's prefill (MHA over 128 heads,
# keys 192, values 128: the (3, 2) instantiation), an S not a multiple of a
# tile, a window that cuts the keys, G 3 (wgmma_rows at (3, 2)), and the smoke
# config's keys of 24 and values of 16 (one chunk each); then narrower
# values within equal chunk counts: the smoke widths at G 3 with a window,
# dh 192 / dv 136 (three chunks each: dK/dV split by columns) and dh 128 / dv
# 72 at G 3 (two chunks each, wgmma_rows: split by columns too)
NARROW_CASES = [
    (1, 1024, 128, 128, 192, 128, True, None),
    (2, 37, 4, 4, 192, 128, True, None),
    (1, 300, 8, 8, 192, 128, True, 64),
    (1, 200, 6, 2, 192, 128, True, None),
    (2, 90, 4, 4, 24, 16, True, None),
    (1, 45, 6, 2, 24, 16, True, 16),
    (1, 130, 4, 2, 192, 136, False, 40),
    (1, 77, 6, 2, 128, 72, True, None),
]


def _narrow_inputs(case, dtype, seed):
    B, S, Hq, Hkv, dh, dv, _, _ = case
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(B, S, Hq, dh, generator=g, device=dev).to(dtype)
    k = torch.randn(B, S, Hkv, dh, generator=g, device=dev).to(dtype)
    v = torch.randn(B, S, Hkv, dv, generator=g, device=dev).to(dtype)
    dout = torch.randn(B, S, Hq, dv, generator=g, device=dev).to(dtype)
    return q, k, v, dout


@pytest.mark.cuda
@pytest.mark.parametrize("case, dtype", [(c, d) for d in (torch.bfloat16, torch.float32)
                                         for c in NARROW_CASES])
def test_flash_attention_narrow_values_match_plain(case, dtype):
    """Forward and backward at values narrower than keys, on the unpadded
    values: out, lse, dq, dk and dv against fp32 autograd of the plain
    version; the launches counted under the instantiation ``instance``
    names (bf16 at dh 192, dv 128: "wgmma 3x2" or "wgmma_rows 3x2"; fp32:
    tf32x3, its split zero-filling V past dv)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    B, S, Hq, Hkv, dh, dv, causal, window = case
    q, k, v, dout = _narrow_inputs(case, dtype, 11)
    want = flash_oracle(q, k, v, dout, causal, window)
    inst = flash_ops.instance(dtype, dh, Hq // Hkv, dv)
    if dtype == torch.bfloat16 and (dh, dv) == (192, 128):
        assert inst == ("wgmma 3x2" if Hq // Hkv == 1 else "wgmma_rows 3x2")
    flash_ops.reset_launches()
    qg, kg, vg = (t.clone().requires_grad_(True) for t in (q, k, v))
    out = flash_ops.flash_attention(qg, kg, vg, causal=causal, window=window)
    dq, dk, dvg = torch.autograd.grad(out, (qg, kg, vg), dout)
    _, lse = flash_ops.flash_attention_fwd(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_ops.flash_attention.launches_by_instance == {inst: {"fwd": 2, "bwd": 1}}
    assert tuple(out.shape) == (B, S, Hq, dv) and dvg.shape == v.shape
    tol = TOLS[dtype]
    for name, got, ref in zip(("out", "lse", "dq", "dk", "dv"), (out, lse, dq, dk, dvg), want):
        torch.testing.assert_close(got.float(), ref, atol=tol, rtol=tol, msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [NARROW_CASES[0], NARROW_CASES[3]], ids=["wgmma", "wgmma_rows"])
def test_flash_attention_narrow_values_backward_is_deterministic(case):
    """The (3, 2) backward run twice gives equal bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    causal, window = case[6], case[7]
    q, k, v, dout = _narrow_inputs(case, torch.bfloat16, 12)
    out, lse = flash_ops.flash_attention_fwd(q, k, v, causal=causal, window=window)
    first = flash_ops.flash_attention_bwd(q, k, v, out, lse, dout, causal=causal, window=window)
    second = flash_ops.flash_attention_bwd(q, k, v, out, lse, dout, causal=causal, window=window)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_flash_attention_refuses_pairs_without_a_kernel():
    """bf16 keys of 256 and values of 128 (chunks 4 and 2): no instantiation
    takes them, so the wrapper raises before any launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    q = torch.zeros(1, 16, 2, 256, dtype=torch.bfloat16, device=dev)
    v = torch.zeros(1, 16, 2, 128, dtype=torch.bfloat16, device=dev)
    flash_ops.reset_launches()
    with pytest.raises(ValueError, match="no bf16 kernel"):
        flash_ops.flash_attention(q, q, v)
    assert flash_ops.flash_attention.launches_fwd == 0


@pytest.mark.cuda
@pytest.mark.parametrize("window", [1024, None], ids=["local", "global"])
def test_flash_attention_gemma3_shape_runs_wgmma(window):
    """gemma3-4b's attention (bf16, dh 256, G 2, S 2048, local window 1024 or
    global) takes the wgmma kernels, forward and backward, and no other."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(4)
    q = torch.randn(1, 2048, 8, 256, generator=g, device=dev).to(torch.bfloat16)
    k = torch.randn(1, 2048, 4, 256, generator=g, device=dev).to(torch.bfloat16)
    v = torch.randn(1, 2048, 4, 256, generator=g, device=dev).to(torch.bfloat16)
    q.requires_grad_(True)
    flash_ops.reset_launches()
    for _ in range(3):
        out = flash_ops.flash_attention(q, k, v, causal=True, window=window)
        out.backward(torch.ones_like(out))
    torch.cuda.synchronize()
    by = flash_ops.flash_attention.launches_by_variant
    assert flash_ops.variant(torch.bfloat16, 256, 2) == "wgmma"
    assert by["wgmma"] == {"fwd": 3, "bwd": 3}
    assert by["wgmma_rows"] == by["tf32x3"] == {"fwd": 0, "bwd": 0}


# (B, S, Hq, Hkv, dh, dtype): a ragged shape, the train shape, gemma3's head
# dim (bf16: dK/dV columns split between the two warpgroups) and the ragged
# shape at G 3 (wgmma_rows), in bf16; the ragged shape at G 3, gemma3's
# global layer and the train shape in fp32; the MoE/MLA families' shapes
DETERMINISM_CASES = [
    (2, 300, 8, 2, 64, torch.bfloat16), (4, 2048, 32, 4, 64, torch.bfloat16),
    (1, 2048, 8, 4, 256, torch.bfloat16), (2, 300, 6, 2, 64, torch.bfloat16),
    (2, 300, 6, 2, 64, torch.float32),
    (1, 2048, 8, 4, 256, torch.float32), (4, 2048, 32, 4, 64, torch.float32),
    # the families' train shapes: deepseek-7b's MHA at dh 128 (Hq 32) and
    # deepseek-v2's MLA at dh 192 (Hq 128)
    (1, 2048, 32, 32, 128, torch.bfloat16), (1, 2048, 128, 128, 192, torch.bfloat16),
    # the fused kernels, whose dQ sums run in key order behind counters:
    # TinyLlama's and qwen2-moe's train_4k sequence, and G 72 (wgmma_rows)
    (1, 4096, 32, 4, 64, torch.bfloat16), (1, 4096, 16, 16, 128, torch.bfloat16),
    (1, 70, 72, 1, 64, torch.bfloat16),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", DETERMINISM_CASES)
def test_flash_attention_backward_is_deterministic(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    B, S, Hq, Hkv, dh, dtype = case
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(2)
    q = torch.randn(B, S, Hq, dh, generator=g, device=dev).to(dtype)
    k = torch.randn(B, S, Hkv, dh, generator=g, device=dev).to(dtype)
    v = torch.randn(B, S, Hkv, dh, generator=g, device=dev).to(dtype)
    dout = torch.randn_like(q)
    out, lse = flash_ops.flash_attention_fwd(q, k, v)
    first = flash_ops.flash_attention_bwd(q, k, v, out, lse, dout)
    second = flash_ops.flash_attention_bwd(q, k, v, out, lse, dout)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


# (B, S, Hq, Hkv, dh, dv, window): the reference's train_4k cell at S 4,096,
# one sequence of each model's attention (causal): TinyLlama-1.1B (DC 1,
# G 8), gemma3-4b's local and global layers (DC 4, G 2), deepseek-7b (DC 2,
# G 1), qwen2-moe-a2.7b (DC 2, G 1, 16 heads) and deepseek-v2-236b's MLA
# (keys 192, values 128: the (3, 2) instantiation, 128 heads); and
# TinyLlama's at S 4,160, not a multiple of a tile.  The key walks are twice
# as long as at the S 2,048 every other case reaches.  Then the wgmma_rows
# kernels under the fused design: G 3 at S 4,096 and G 72 at S 1,024.
LONG_BWD_CASES = [
    (1, 4096, 32, 4, 64, 64, None),
    (1, 4096, 8, 4, 256, 256, 1024),
    (1, 4096, 8, 4, 256, 256, None),
    (1, 4096, 32, 32, 128, 128, None),
    (1, 4160, 32, 4, 64, 64, None),
    (1, 4096, 16, 16, 128, 128, None),
    (1, 4096, 128, 128, 192, 128, None),
    (1, 4096, 6, 2, 64, 64, None),
    (1, 1024, 72, 1, 64, 64, None),
]
KEY_SPREAD = 4.0  # the queries' scale, as chip_smoke.py's LM_KEY_SPREAD
ORACLE_HEADS = 32  # query heads a group of the fp32 oracle: MLA's 128 take 8.6 GB a copy


@pytest.mark.cuda
@pytest.mark.parametrize("case", LONG_BWD_CASES, ids=["tinyllama", "gemma3-local",
                                                      "gemma3-global", "deepseek-7b", "S4160",
                                                      "qwen2-moe", "deepseek-v2-mla",
                                                      "rows-G3", "rows-G72"])
def test_flash_backward_at_train_4096_matches_fp32_autograd(case):
    """bf16 forward and backward on the ``wgmma`` kernels (``wgmma_rows``
    where G does not divide 64) at the train_4k cell's S against fp32
    autograd of ``attention_ref`` at TOL, taken ORACLE_HEADS query heads at
    a time, or the heads of one kv head where G is larger (each head's
    attention is its own).  The queries are drawn at KEY_SPREAD, so the
    scores spread by 4 and the softmax picks a few keys: a key the kernels
    drop, past 2,048 (half of S, where S is shorter) or anywhere, moves an
    output row by the values' scale."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    B, S, Hq, Hkv, dh, dv, window = case
    bf16, dev = torch.bfloat16, torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(21)
    q = (torch.randn(B, S, Hq, dh, generator=g, device=dev) * KEY_SPREAD).to(bf16)
    k = torch.randn(B, S, Hkv, dh, generator=g, device=dev).to(bf16)
    v = torch.randn(B, S, Hkv, dv, generator=g, device=dev).to(bf16)
    dout = torch.randn(B, S, Hq, dv, generator=g, device=dev).to(bf16)
    G = Hq // Hkv
    step = min(Hq, max(G, ORACLE_HEADS // G * G))  # whole kv heads
    parts = [flash_oracle(q[:, :, h:h + step], k[:, :, h // G:(h + step) // G],
                          v[:, :, h // G:(h + step) // G], dout[:, :, h:h + step], True, window)
             for h in range(0, Hq, step)]
    want = [torch.cat([p[i] for p in parts], dim=1 if i == 1 else 2) for i in range(5)]
    del parts
    assert flash_ops.variant(bf16, dh, G, dv) == ("wgmma" if 64 % G == 0 else "wgmma_rows")
    flash_ops.reset_launches()
    out, lse = flash_ops.flash_attention_fwd(q, k, v, causal=True, window=window)
    grads = flash_ops.flash_attention_bwd(q, k, v, out, lse, dout, causal=True, window=window)
    torch.cuda.synchronize()
    inst = flash_ops.instance(bf16, dh, G, dv)
    assert flash_ops.flash_attention.launches_by_instance == {inst: {"fwd": 1, "bwd": 1}}
    tol = TOLS[bf16]
    for name, got, ref in zip(("out", "lse", "dq", "dk", "dv"), (out, lse, *grads), want):
        torch.testing.assert_close(got.float(), ref, atol=tol, rtol=tol, msg=name)
    # a planted control fails the same check: dK and dV with the rows of keys
    # 2,048 and after zeroed, what a backward that stopped at S 2,048 gives
    for got, ref in zip(grads[1:], want[3:]):
        cut = got.float()
        cut[:, min(2048, S // 2):] = 0
        assert ((cut - ref).abs() / (tol + tol * ref.abs())).max() > 1


# (B, Sq, Sk, Hq, Hkv, dh, window): the fused kernels (dh 64 and 128, G 4
# and 2, G 3 on wgmma_rows) where the query and key lengths differ under a
# causal window, every row seeing some key: key blocks whose walks start and
# end inside the rows, the first adder of a row tile past key block 0
UNEQUAL_CASES = [
    (1, 360, 300, 8, 2, 64, 64), (1, 300, 500, 8, 2, 64, 64),
    (1, 360, 300, 8, 4, 128, 64), (1, 300, 500, 8, 4, 128, 64),
    (2, 330, 300, 6, 2, 64, 48),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", UNEQUAL_CASES)
def test_flash_backward_window_with_unequal_lengths(case):
    """bf16 backward at Sq beside Sk under a window against fp32 autograd of
    the plain version at TOL."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    B, Sq, Sk, Hq, Hkv, dh, window = case
    bf16, dev = torch.bfloat16, torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(31)
    q = (torch.randn(B, Sq, Hq, dh, generator=g, device=dev) * KEY_SPREAD).to(bf16)
    k = torch.randn(B, Sk, Hkv, dh, generator=g, device=dev).to(bf16)
    v = torch.randn(B, Sk, Hkv, dh, generator=g, device=dev).to(bf16)
    dout = torch.randn(B, Sq, Hq, dh, generator=g, device=dev).to(bf16)
    assert Sq - 1 - (window - 1) <= Sk - 1  # every row sees a key
    assert flash_ops.fused_bwd(dh)
    want = flash_oracle(q, k, v, dout, True, window)
    out, lse = flash_ops.flash_attention_fwd(q, k, v, causal=True, window=window)
    grads = flash_ops.flash_attention_bwd(q, k, v, out, lse, dout, causal=True, window=window)
    torch.cuda.synchronize()
    tol = TOLS[bf16]
    for name, got, ref in zip(("out", "lse", "dq", "dk", "dv"), (out, lse, *grads), want):
        torch.testing.assert_close(got.float(), ref, atol=tol, rtol=tol, msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("dh,G", [(64, 8), (128, 1), (64, 3)])
def test_flash_backward_after_another_shape_gives_the_same_bits(dh, G):
    """The fused kernels' row-tile counters and ticket are zeroed before
    every call: a backward after one at another shape (more row tiles, then
    fewer) gives the bits of the first call at its own shape."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")

    def inputs(B, S, Hkv, seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        q = torch.randn(B, S, Hkv * G, dh, generator=g, device=dev).to(torch.bfloat16)
        k, v = (torch.randn(B, S, Hkv, dh, generator=g, device=dev).to(torch.bfloat16)
                for _ in range(2))
        out, lse = flash_ops.flash_attention_fwd(q, k, v)
        return q, k, v, out, lse, torch.randn_like(out)

    small, large = inputs(1, 700, 2, 5), inputs(2, 1500, 4, 6)
    first = flash_ops.flash_attention_bwd(*small)
    flash_ops.flash_attention_bwd(*large)
    again = flash_ops.flash_attention_bwd(*small)
    flash_ops.flash_attention_bwd(*inputs(1, 300, 1, 7))
    after_fewer = flash_ops.flash_attention_bwd(*small)
    torch.cuda.synchronize()
    for a, b, c in zip(first, again, after_fewer):
        assert torch.equal(a, b) and torch.equal(a, c)


def _mla_inputs(B, S, Hq, Hkv, seed, spread=1.0):
    """bf16 q (at ``spread``), k, v and dout at MLA's keys of 192 and values of 128."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    q = (torch.randn(B, S, Hq, 192, generator=g, device=dev) * spread).to(torch.bfloat16)
    k = torch.randn(B, S, Hkv, 192, generator=g, device=dev).to(torch.bfloat16)
    v = torch.randn(B, S, Hkv, 128, generator=g, device=dev).to(torch.bfloat16)
    dout = torch.randn(B, S, Hq, 128, generator=g, device=dev).to(torch.bfloat16)
    return q, k, v, dout


def _kernels_of(fn) -> set[str]:
    """The names of the device kernels (and memsets) one call of fn runs."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = set()
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:  # "void ...::f<...>(...)": f
            m = re.search(r"(\w+)[<(]", e.name.replace("(anonymous namespace)::", ""))
            names.add(m.group(1) if m else e.name)
    return names


@pytest.mark.cuda
@pytest.mark.parametrize("Hq,Hkv", [(16, 16), (6, 2)], ids=["wgmma", "wgmma_rows"])
def test_flash_mla_backward_runs_the_fused_kernels(Hq, Hkv):
    """The (3, 2) backward is the fused design's four steps (the delta
    kernel, the counters' memset, the key-tile kernel, dq's conversion; after
    the gather at wgmma_rows), and no dQ or dK/dV kernel; the forward is the
    ping-pong kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    q, k, v, dout = _mla_inputs(1, 1024, Hq, Hkv, 41)
    assert flash_ops.fused_bwd(192, 128)
    out, lse = flash_ops.flash_attention_fwd(q, k, v)
    bwd = _kernels_of(lambda: flash_ops.flash_attention_bwd(q, k, v, out, lse, dout))
    fwd = _kernels_of(lambda: flash_ops.flash_attention_fwd(q, k, v))
    gather = {"flash_rows_gather_kernel"} if Hq != Hkv else set()
    kernels = {n for n in bwd if n.startswith("flash_")}
    assert kernels == {"flash_bwd_delta_wgmma_kernel", "flash_bwd_fused_wgmma_kernel",
                       "flash_bwd_dq_convert_kernel", *gather}, bwd
    assert any("emset" in n for n in bwd), bwd  # the counters zeroed in-stream
    assert {n for n in fwd if n.startswith("flash_")} == {"flash_fwd_pp_wgmma_kernel", *gather}


@pytest.mark.cuda
@pytest.mark.parametrize("Hkv,G", [(4, 1), (2, 3)], ids=["wgmma", "wgmma_rows"])
def test_flash_mla_backward_after_another_shape_gives_the_same_bits(Hkv, G):
    """The (3, 2) backward's counters, ticket and head groups: reruns, after
    a call at more heads and a longer S, then at fewer, give equal bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")

    def call(B, S, hkv, seed):
        q, k, v, dout = _mla_inputs(B, S, hkv * G, hkv, seed, spread=4.0)
        out, lse = flash_ops.flash_attention_fwd(q, k, v)
        return lambda: flash_ops.flash_attention_bwd(q, k, v, out, lse, dout)

    small = call(1, 700, Hkv, 5)
    first = small()
    again = small()
    call(2, 1500, 2 * Hkv, 6)()
    after_more = small()
    call(1, 300, 1, 7)()
    after_fewer = small()
    torch.cuda.synchronize()
    for a, b, c, d in zip(first, again, after_more, after_fewer):
        assert torch.equal(a, b) and torch.equal(a, c) and torch.equal(a, d)


@pytest.mark.cuda
def test_flash_mla_backward_at_4096_holds_with_planted_controls():
    """deepseek-v2's train_4k attention (B 1, 128 heads, keys 192, values
    128, causal) with queries at KEY_SPREAD: out, lse, dq, dk and dv within
    TOL of fp32 autograd (the worst err / (tol + tol |ref|) at most 1), and
    two planted controls, dK and dV with the keys from 2,048 on zeroed, far
    past it (above 40)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, dout = _mla_inputs(1, 4096, 128, 128, 23, spread=KEY_SPREAD)
    parts = [flash_oracle(q[:, :, h:h + ORACLE_HEADS], k[:, :, h:h + ORACLE_HEADS],
                          v[:, :, h:h + ORACLE_HEADS], dout[:, :, h:h + ORACLE_HEADS], True, None)
             for h in range(0, 128, ORACLE_HEADS)]
    want = [torch.cat([p[i] for p in parts], dim=1 if i == 1 else 2) for i in range(5)]
    del parts
    out, lse = flash_ops.flash_attention_fwd(q, k, v, causal=True)
    grads = flash_ops.flash_attention_bwd(q, k, v, out, lse, dout, causal=True)
    torch.cuda.synchronize()
    tol = TOLS[torch.bfloat16]
    ratio = lambda got, ref: ((got.float() - ref).abs() / (tol + tol * ref.abs())).max().item()
    for name, got, ref in zip(("out", "lse", "dq", "dk", "dv"), (out, lse, *grads), want):
        assert ratio(got, ref) <= 1.0, name
    for name, got, ref in zip(("dk", "dv"), grads[1:], want[3:]):
        cut = got.float()
        cut[:, 2048:] = 0
        assert ratio(cut, ref) > 40, name


# (B, S, Hq, Hkv, window): the (3, 2) forward where its tiles are ragged (S
# not a multiple of 128, the second warpgroup's rows past S), under a window
# that leaves a warpgroup's tile invisible, at G 3 (wgmma_rows 3x2)
MLA_FWD_CASES = [(2, 37, 4, 4, None), (1, 1000, 8, 8, None), (1, 700, 8, 8, 100),
                 (1, 333, 6, 2, 64), (2, 600, 9, 3, None)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", MLA_FWD_CASES)
def test_flash_mla_forward_matches_plain(case):
    """The ping-pong forward's out and lse against the plain version in fp32
    at TOL."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    B, S, Hq, Hkv, window = case
    q, k, v, _ = _mla_inputs(B, S, Hq, Hkv, 43, spread=KEY_SPREAD)
    flash_ops.reset_launches()
    out, lse = flash_ops.flash_attention_fwd(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    inst = "wgmma 3x2" if Hq == Hkv else "wgmma_rows 3x2"
    assert flash_ops.flash_attention.launches_by_instance == {inst: {"fwd": 1, "bwd": 0}}
    q32, k32, v32 = q.float(), k.float(), v.float()
    tol = TOLS[torch.bfloat16]
    torch.testing.assert_close(out.float(), attention_ref(q32, k32, v32, window=window),
                               atol=tol, rtol=tol)
    torch.testing.assert_close(lse, attention_lse_ref(q32, k32, window=window), atol=tol,
                               rtol=tol)


@pytest.mark.cuda
def test_flash_mla_forward_at_32768_matches_plain_on_three_blocks():
    """The forward at prefill_32k's S (B 1, causal; 16 of deepseek-v2's
    heads): three 256-row blocks (the first, one in the middle, the last)
    of out and lse against the plain version in fp32 over the keys they see."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    S, H = 32768, 16
    q, k, v, _ = _mla_inputs(1, S, H, H, 47, spread=KEY_SPREAD)
    out, lse = flash_ops.flash_attention_fwd(q, k, v, causal=True)
    torch.cuda.synchronize()
    tol = TOLS[torch.bfloat16]
    for r0 in (0, S // 2 - 128, S - 256):
        qs = q[:, r0:r0 + 256].float()
        ks, vs = k[:, :r0 + 256].float(), v[:, :r0 + 256].float()
        # the block's rows are positions r0.. of the whole: offset the mask
        s = torch.einsum("bshd,bthd->bhst", qs, ks) / 192 ** 0.5
        pos = torch.arange(r0, r0 + 256, device=q.device)[:, None]
        s = s.masked_fill(torch.arange(r0 + 256, device=q.device)[None, :] > pos, -torch.inf)
        want_lse = torch.logsumexp(s, dim=-1)
        want = torch.einsum("bhst,bthd->bshd", torch.softmax(s, dim=-1).to(torch.bfloat16).float(),
                            vs)
        torch.testing.assert_close(out[:, r0:r0 + 256].float(), want, atol=tol, rtol=tol)
        torch.testing.assert_close(lse[:, :, r0:r0 + 256], want_lse, atol=tol, rtol=tol)
        del s


@pytest.mark.cuda
def test_flash_attention_rejects_bad_inputs():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    q = torch.zeros(1, 16, 4, 12, device=dev)  # head dim not a multiple of 8
    kv = torch.zeros(1, 16, 2, 12, device=dev)
    with pytest.raises(ValueError, match="head dim"):
        flash_ops.flash_attention(q, kv, kv)
    q = torch.zeros(1, 16, 3, 8, device=dev)
    kv = torch.zeros(1, 16, 2, 8, device=dev)
    with pytest.raises(ValueError, match="multiple"):
        flash_ops.flash_attention(q, kv, kv)
    with pytest.raises(TypeError, match="fp32 or bf16"):
        flash_ops.flash_attention(q.half(), kv.half(), kv.half())
    with pytest.raises(ValueError, match="contiguous"):
        x = torch.zeros(1, 8, 16, 2, device=dev).transpose(1, 2)
        flash_ops.flash_attention(x, x, x)
    # contiguous, but starting 2 bytes past an aligned address
    x = torch.zeros(1 + 16 * 2 * 8, dtype=torch.bfloat16, device=dev)[1:].view(1, 16, 2, 8)
    with pytest.raises(ValueError, match="16-byte"):
        flash_ops.flash_attention(x, x, x)


@pytest.mark.cuda
@pytest.mark.parametrize("remat", ["full", "dots"])
def test_train_step_remat_on_the_card(remat):
    """Per-layer checkpointing re-runs the flash forward kernel in the
    backward pass; the step's loss and parameters equal those of no remat."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import dataclasses

    from repro_torch.configs import ShapeCell, get_config
    from repro_torch.data import make_batch
    from repro_torch.models.layers import init_params
    from repro_torch.models.transformer import lm_specs
    from repro_torch.train import build_train_step, make_train_state

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = dataclasses.replace(get_config("tinyllama-1.1b", smoke=True), dtype=torch.float32)
    cell = ShapeCell("t", "train", {"seq_len": 64, "global_batch": 4})
    params = init_params(torch.Generator(device=dev).manual_seed(0), lm_specs(cfg), cfg.dtype, dev)
    batch = make_batch(cfg, cell, seed=0, device=dev)
    clone = lambda t: {k: clone(v) for k, v in t.items()} if isinstance(t, dict) else t.clone()
    ref, ref_m = build_train_step(cfg, cell)(make_train_state(clone(params)), batch)
    f0 = flash_ops.flash_attention.launches_fwd
    got, m = build_train_step(cfg, cell, remat=remat)(make_train_state(clone(params)), batch)
    torch.cuda.synchronize()
    # one forward per layer, and one more per layer when the backward recomputes it
    assert flash_ops.flash_attention.launches_fwd - f0 == 2 * cfg.n_layers
    torch.testing.assert_close(m["loss"], ref_m["loss"], atol=1e-6, rtol=1e-6)
    for k in ("embed", "head"):
        torch.testing.assert_close(got["params"][k], ref["params"][k], atol=1e-6, rtol=1e-6)


@pytest.mark.cuda
def test_moe_train_step_on_the_card_matches_the_cpu():
    """One fp32 train step of qwen2-moe-smoke, on the card (flash kernels,
    the dispatch gathers' backward as accumulating scatters) and on the CPU
    from the same parameters and batch: the loss, the grad norm and every
    updated parameter within 1e-4, and the router's expert ids and slots
    equal on both devices."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import dataclasses

    from repro_torch.configs import ShapeCell, get_config
    from repro_torch.data import make_batch
    from repro_torch.models import moe
    from repro_torch.models.layers import init_params
    from repro_torch.models.transformer import lm_specs
    from repro_torch.train import build_train_step, make_train_state
    from repro_torch.tree import leaves

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = dataclasses.replace(get_config("qwen2-moe-a2.7b", smoke=True), dtype=torch.float32)
    cell = ShapeCell("t", "train", {"seq_len": 64, "global_batch": 4})
    params = init_params(torch.Generator().manual_seed(0), lm_specs(cfg), cfg.dtype, "cpu")
    routes = {"cuda": [], "cpu": []}
    inner = moe.route

    def recorded(x, router, dims):
        out = inner(x, router, dims)
        routes[x.device.type].append([t.detach().cpu() for t in out[1:]])
        return out

    moe.route = recorded
    try:
        f0 = flash_ops.flash_attention.launches_by_variant["tf32x3"]["bwd"]
        on_dev, m_dev = build_train_step(cfg, cell)(
            make_train_state(_to(params, dev)),
            make_batch(cfg, cell, seed=0, device=dev))
        on_cpu, m_cpu = build_train_step(cfg, cell)(
            make_train_state(_to(params, "cpu")), make_batch(cfg, cell, seed=0, device="cpu"))
        torch.cuda.synchronize()
    finally:
        moe.route = inner
    assert flash_ops.flash_attention.launches_by_variant["tf32x3"]["bwd"] - f0 == cfg.n_layers
    for k in ("loss", "grad_norm"):
        torch.testing.assert_close(m_dev[k].cpu(), m_cpu[k], atol=1e-4, rtol=1e-4)
    for a, b in zip(leaves(on_dev["params"]), leaves(on_cpu["params"])):
        torch.testing.assert_close(a.cpu(), b, atol=1e-4, rtol=1e-4)
    assert len(routes["cuda"]) == len(routes["cpu"]) == cfg.n_layers
    for a, b in zip(routes["cuda"], routes["cpu"]):
        assert all(torch.equal(x, y) for x, y in zip(a, b))


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev, copy=True)


# --------------------------------------------------------------------------
# embedding bag
# --------------------------------------------------------------------------
import numpy as np

from repro_torch.kernels import build
from repro_torch.kernels.embedding_bag import embedding_bag_ref, embedding_bag_seq_ref
from repro_torch.kernels.embedding_bag import ops as bag_ops

# (V, dim, n_bags, bag_size, combiner, weighted): the FM, DCN-v2 (bags of
# one), retrieval and SASRec-like widths, the smoke widths, 128 and an odd
# width (scalar loads), and an empty bag; then bags longer than the shared
# memory (96 rows of 4 KB, their sums carried across stages), bags of one by
# the hundred thousand at FM's and SASRec's widths, and FM's linear term
# (width 1, 39 ids)
BAG_CASES = [
    (300, 10, 64, 39, "sum", False),
    (5000, 16, 1000, 1, "sum", False),
    (4000, 32, 3000, 1, "sum", False),
    (256, 50, 40, 50, "mean", True),
    (290, 4, 8, 6, "sum", True),
    (100, 8, 33, 7, "mean", False),
    (5000, 128, 16, 26, "sum", True),
    (77, 13, 20, 5, "sum", True),
    (50, 1, 20, 9, "sum", False),
    (10, 6, 3, 0, "sum", False),
    (20_000, 1024, 24, 96, "sum", True),
    (100_000, 10, 100_000, 1, "sum", False),
    (100_000, 50, 100_000, 1, "sum", False),
    (1000, 1, 512, 39, "sum", False),
]


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _bag_inputs(case, dtype, dev, seed=3):
    V, dim, n_bags, bag, combiner, weighted = case
    g = torch.Generator(device=dev).manual_seed(seed)
    table = torch.randn(V, dim, generator=g, device=dev).to(dtype)
    ids = torch.randint(0, V, (n_bags, bag), generator=g, device=dev, dtype=torch.int32)
    w = torch.rand(n_bags, bag, generator=g, device=dev) if weighted else None
    return table, ids, w, combiner


@pytest.mark.cuda
@pytest.mark.parametrize("case", BAG_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_embedding_bag_kernel_matches_plain(case, dtype):
    dev = _cuda()
    V, dim, n_bags, bag, combiner, weighted = case
    table, ids, w, combiner = _bag_inputs(case, dtype, dev)
    before = bag_ops.embedding_bag.launches
    got = bag_ops.embedding_bag(table, ids, w, combiner=combiner)
    want = embedding_bag_ref(table.float(), ids, w, combiner)  # fp32 on the same values
    exact = embedding_bag_seq_ref(table, ids, w, combiner)  # the kernel's arithmetic
    torch.cuda.synchronize()
    assert bag_ops.embedding_bag.launches == before + 1
    assert got.dtype == dtype and got.shape == (n_bags, dim)
    torch.testing.assert_close(got, exact, atol=0, rtol=0, equal_nan=True)
    torch.testing.assert_close(got.float(), want, atol=TOLS[dtype], rtol=TOLS[dtype],
                               equal_nan=True)


@pytest.mark.cuda
def test_embedding_bag_kernel_sums_4096_ids_a_bag_in_order():
    """Bags of 4,096 ids at width 128 (2 MB of rows a bag): the kernel's sum
    is the j-ordered one, bit for bit.  Such a sum differs from the plain
    version's (torch's pairwise order) by more than 2e-5, so it is held
    against the exact sum (fp64) within 2e-5 plus the bound on the rounding
    of n sequential fp32 additions, gamma_n * sum_j |w_j x_j| with
    gamma_n = n u / (1 - n u), u = 2^-24 (Higham, Accuracy and Stability of
    Numerical Algorithms, 4.2)."""
    dev = _cuda()
    table, ids, w, _ = _bag_inputs((5000, 128, 40, 4096, "sum", True), torch.float32, dev)
    got = bag_ops.embedding_bag(table, ids, w)
    exact = embedding_bag_seq_ref(table, ids, w)
    want = embedding_bag_ref(table.double(), ids, w.double())
    mass = embedding_bag_ref(table.double().abs(), ids, w.double())
    torch.cuda.synchronize()
    torch.testing.assert_close(got, exact, atol=0, rtol=0)
    nu = 4096 * 2.0**-24
    bound = 2e-5 * (1 + want.abs()) + nu / (1 - nu) * mass
    assert ((got.double() - want).abs() <= bound).all()


@pytest.mark.cuda
def test_embedding_bag_kernel_copies_bf16_rows_below_4_byte_alignment():
    """bf16 at an odd width: 26-byte rows, copied into the stage by 2-byte
    loads, in one launch."""
    dev = _cuda()
    table, ids, w, _ = _bag_inputs((301, 13, 700, 11, "sum", True), torch.bfloat16, dev)
    assert build.vector_width(13, 2, table) == 1
    before = bag_ops.embedding_bag.launches
    got = bag_ops.embedding_bag(table, ids, w)
    torch.cuda.synchronize()
    assert bag_ops.embedding_bag.launches == before + 1
    torch.testing.assert_close(got, embedding_bag_seq_ref(table, ids, w), atol=0, rtol=0)
    ones = bag_ops.embedding_bag(table, ids[:, :1].contiguous())
    torch.testing.assert_close(ones, table[ids[:, 0].long()], atol=0, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("stage_bytes", [600, 2048, 6000])
def test_embedding_bag_kernel_gives_the_same_bits_on_every_plan(stage_bytes, monkeypatch):
    """FM's field sums (width 10, 39 ids, cut into chunks over the stages) and
    bags of one, in stages of 600 B to 6 KB (the plan's stage sizes set for
    the test), over eight SMs' worth of blocks: every plan gives the oracle's
    bits."""
    dev = _cuda()
    monkeypatch.setattr(bag_ops, "STAGE_BYTES", stage_bytes)
    monkeypatch.setattr(bag_ops, "STAGE_BYTES_ONE", stage_bytes)
    for case in ((3000, 10, 999, 39, "sum", False), (3000, 10, 4099, 1, "sum", False)):
        table, ids, w, combiner = _bag_inputs(case, torch.float32, dev)
        p = bag_ops.plan(ids.shape[0], ids.shape[1], 10, torch.float32, 2, sms=8)
        assert p.chunks > 1 or p.one
        out = torch.empty(ids.shape[0], 10, device=dev)
        got = bag_ops.launch(table, ids, w, combiner, p, out)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, embedding_bag_seq_ref(table, ids, w, combiner),
                                   atol=0, rtol=0)


def _misaligned(V: int, dim: int, dev) -> torch.Tensor:
    """A contiguous [V, dim] fp32 table whose pointer is 4 bytes past a
    16-byte boundary, so the kernel copies it a float a piece."""
    g = torch.Generator(device=dev).manual_seed(5)
    return torch.randn(V * dim + 1, generator=g, device=dev)[1:].view(V, dim)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["fp32 width 257", "misaligned width 512"])
@pytest.mark.parametrize("bag", [1, 39])
def test_embedding_bag_kernel_sums_rows_wider_than_the_block(case, bag):
    """Rows of more copied pieces than the block has threads (fp32 at width
    257; a misaligned view at width 512): wide tiles, whose threads loop over
    the (bag, chunk) pairs and carry the sums of a bag cut into chunks in
    shared memory; bags of one and weighted bags of 39 ids, one launch each,
    bit for bit the oracle's."""
    dev = _cuda()
    if case == "fp32 width 257":
        table, ids, w, _ = _bag_inputs((700, 257, 600, bag, "sum", True), torch.float32, dev)
    else:
        table = _misaligned(700, 512, dev)
        _, ids, w, _ = _bag_inputs((700, 8, 600, bag, "sum", True), torch.float32, dev)
    assert build.vector_width(table.shape[1], 4, table) == 1
    for weights in (None, w):
        before = bag_ops.embedding_bag.launches
        got = bag_ops.embedding_bag(table, ids, weights)
        torch.cuda.synchronize()
        assert bag_ops.embedding_bag.launches == before + 1
        torch.testing.assert_close(got, embedding_bag_seq_ref(table, ids, weights), atol=0,
                                   rtol=0)


@pytest.mark.cuda
def test_embedding_bag_kernel_reads_the_end_of_a_table_past_2_31_bytes():
    """Ids near the end of a DCN-v2-sized table (33,762,591 x 16 fp32, 2.16
    GB): 64-bit addresses."""
    dev = _cuda()
    V, dim = 33_762_591, 16
    table = torch.empty(V, dim, device=dev)
    rows = torch.arange(V, device=dev, dtype=torch.float32)
    table.copy_(rows[:, None] * 1e-3 + torch.arange(dim, device=dev)[None, :])
    del rows
    ids = torch.tensor([[V - 1], [V - 2], [2**31 // (4 * dim)], [2**31 // (4 * dim) + 1], [0],
                        [-1]], dtype=torch.int32, device=dev)
    got = bag_ops.embedding_bag(table, ids)
    want = table[torch.where(ids[:, 0] < 0, ids[:, 0] + V, ids[:, 0]).long()]
    torch.cuda.synchronize()
    assert table[V - 1].data_ptr() - table.data_ptr() >= 2**31
    assert torch.equal(got, want)
    bags = torch.tensor([[V - 1, V - 3, 5]], dtype=torch.int32, device=dev)
    torch.testing.assert_close(bag_ops.embedding_bag(table, bags, combiner="mean"),
                               embedding_bag_ref(table, bags, None, "mean"), atol=0, rtol=0)


@pytest.mark.cuda
def test_embedding_bag_kernel_fills_out_of_range_bags_with_nan():
    dev = _cuda()
    table = torch.randn(100, 10, device=dev)
    ids = torch.randint(0, 100, (6, 4), device=dev, dtype=torch.int32)
    ids[1, 2], ids[3, 0], ids[4, 1] = 100, -101, -1
    got = bag_ops.embedding_bag(table, ids)
    want = embedding_bag_ref(table, ids)
    torch.cuda.synchronize()
    assert torch.isnan(got[[1, 3]]).all() and torch.isfinite(got[[0, 2, 4, 5]]).all()
    torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5, equal_nan=True)


@pytest.mark.cuda
def test_embedding_bag_rejects_bad_inputs():
    dev = _cuda()
    table = torch.randn(50, 8, device=dev)
    ids = torch.zeros(4, 3, dtype=torch.int32, device=dev)
    with pytest.raises(TypeError, match="int32"):
        bag_ops.embedding_bag(table, ids.long())
    with pytest.raises(TypeError, match="fp32 or bf16"):
        bag_ops.embedding_bag(table.half(), ids)
    with pytest.raises(TypeError, match="weights must be fp32"):
        bag_ops.embedding_bag(table, ids, torch.ones(4, 3, device=dev, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="weights"):
        bag_ops.embedding_bag(table, ids, torch.ones(4, 2, device=dev))
    with pytest.raises(ValueError, match="contiguous"):
        bag_ops.embedding_bag(torch.randn(8, 50, device=dev).T, ids)
    with pytest.raises(ValueError, match="ids on cpu"):
        bag_ops.embedding_bag(table, ids.cpu())
    with pytest.raises(ValueError, match="combiner"):
        bag_ops.embedding_bag(table, ids, combiner="max")
    with pytest.raises(ValueError, match="shapes"):
        bag_ops.embedding_bag(table, ids[0])


# --------------------------------------------------------------------------
# embedding bag: the backward kernel (the table's gradient)
# --------------------------------------------------------------------------
from repro_torch.kernels.embedding_bag import embedding_bag_bwd_ref, embedding_bag_bwd_seq_ref


def _bwd_bound(V, ids, w, dout, combiner, tol):
    """(exact fp64 gradient, allowed |err| per element): tol (1 + |exact|)
    plus the bound on n sequential fp32 additions, gamma_n sum |w x| with
    gamma_n = n u / (1 - n u), u = 2^-24, n the ids the row takes (Higham,
    4.2); a chunked sum is no worse than the sequential one."""
    w64 = None if w is None else w.double()
    exact = embedding_bag_bwd_ref(V, ids, w64, dout.double(), combiner)
    mass = embedding_bag_bwd_ref(V, ids, None if w is None else w64.abs(), dout.double().abs(),
                                 combiner)
    rows = torch.where(ids < 0, ids + V, ids).long()
    nu = torch.bincount(rows[(rows >= 0) & (rows < V)], minlength=V).double()[:, None] * 2.0**-24
    return exact, tol * (1 + exact.abs()) + nu / (1 - nu) * mass


def _bwd_inputs(case, dtype, dev, seed=4):
    table, ids, w, combiner = _bag_inputs(case, dtype, dev, seed)
    V = table.shape[0]
    if ids.numel() > 20:  # negative ids count from the end; ids past either end add nothing
        flat = ids.view(-1)
        flat[::7] -= V
        flat[3::11] = V + 5
        flat[5::13] = -V - 2
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    dout = torch.randn(ids.shape[0], table.shape[1], generator=g, device=dev).to(dtype)
    return V, ids, w, dout, combiner


@pytest.mark.cuda
@pytest.mark.parametrize("case", BAG_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_embedding_bag_bwd_kernel_matches_plain(case, dtype):
    """One launch a call, the kernel's arithmetic bit for bit, the same bits
    on a second call, and the fp64 gradient within TOL plus the bound of a
    sequential fp32 sum."""
    dev = _cuda()
    V, ids, w, dout, combiner = _bwd_inputs(case, dtype, dev)
    before = bag_ops.embedding_bag.launches_bwd
    got = bag_ops.embedding_bag_bwd(V, ids, w, dout, combiner)
    again = bag_ops.embedding_bag_bwd(V, ids, w, dout, combiner)
    exact = embedding_bag_bwd_seq_ref(V, ids, w, dout, combiner)
    torch.cuda.synchronize()
    assert bag_ops.embedding_bag.launches_bwd == before + (2 if ids.numel() else 0)
    assert got.dtype == dtype and got.shape == (V, dout.shape[1])
    assert torch.equal(got, again)
    torch.testing.assert_close(got, exact, atol=0, rtol=0)
    want, allowed = _bwd_bound(V, ids, w, dout, combiner, TOLS[dtype])
    assert ((got.double() - want).abs() <= allowed).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_embedding_bag_bwd_kernel_sums_a_hub_over_many_chunks(dtype):
    """A hub row read by 200,000 of 262,144 positions (782 chunks of 256),
    beside bags of one over a wide table: bit for bit the oracle's, the
    pieces added in chunk order by whichever block arrives last."""
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(9)
    V, dim = 100_000, 10
    ids = torch.randint(0, V, (65_536, 4), generator=g, device=dev, dtype=torch.int32)
    ids.view(-1)[torch.randperm(ids.numel(), generator=g, device=dev)[:200_000]] = 12_345
    w = torch.rand(ids.shape, generator=g, device=dev)
    dout = torch.randn(65_536, dim, generator=g, device=dev).to(dtype)
    got = bag_ops.embedding_bag_bwd(V, ids, w, dout)
    exact = embedding_bag_bwd_seq_ref(V, ids, w, dout)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, exact, atol=0, rtol=0)
    want, allowed = _bwd_bound(V, ids, w, dout, "sum", TOLS[dtype])
    assert ((got.double() - want).abs() <= allowed).all()
    for _ in range(2):
        assert torch.equal(bag_ops.embedding_bag_bwd(V, ids, w, dout), got)


@pytest.mark.cuda
def test_embedding_bag_autograd_launches_the_backward_only_for_a_table_with_grad():
    dev = _cuda()
    table = torch.randn(300, 10, device=dev, requires_grad=True)
    ids = torch.randint(0, 300, (64, 39), device=dev, dtype=torch.int32)
    f0, b0 = bag_ops.embedding_bag.launches, bag_ops.embedding_bag.launches_bwd
    with torch.no_grad():  # serving: the forward kernel alone
        out = bag_ops.embedding_bag(table, ids)
    assert out.grad_fn is None
    out = bag_ops.embedding_bag(table.detach(), ids)  # no table gradient wanted
    assert out.grad_fn is None
    assert (bag_ops.embedding_bag.launches, bag_ops.embedding_bag.launches_bwd) == (f0 + 2, b0)
    dout = torch.randn(64, 10, device=dev)
    out = bag_ops.embedding_bag(table, ids)
    (g,) = torch.autograd.grad(out, table, dout)
    torch.cuda.synchronize()
    assert (bag_ops.embedding_bag.launches, bag_ops.embedding_bag.launches_bwd) == (f0 + 3, b0 + 1)
    torch.testing.assert_close(g, embedding_bag_bwd_seq_ref(300, ids, None, dout), atol=0, rtol=0)


@pytest.mark.cuda
def test_embedding_bag_bwd_rejects_bad_inputs():
    dev = _cuda()
    table = torch.randn(50, 8, device=dev, requires_grad=True)
    ids = torch.zeros(4, 3, dtype=torch.int32, device=dev)
    w = torch.ones(4, 3, device=dev, requires_grad=True)
    dout = torch.randn(4, 8, device=dev)
    with pytest.raises(ValueError, match="table only"):
        bag_ops.embedding_bag(table, ids, w)
    with pytest.raises(ValueError, match="table only"):
        bag_ops.embedding_bag_bwd(50, ids, w, dout)
    with pytest.raises(TypeError, match="dout must be fp32 or bf16"):
        bag_ops.embedding_bag_bwd(50, ids, None, dout.half())
    with pytest.raises(ValueError, match="one row a bag"):
        bag_ops.embedding_bag_bwd(50, ids, None, dout[:3])
    with pytest.raises(ValueError, match="shapes"):
        bag_ops.embedding_bag_bwd(50, ids[0], None, dout)
    with pytest.raises(TypeError, match="int32"):
        bag_ops.embedding_bag_bwd(50, ids.long(), None, dout)
    with pytest.raises(ValueError, match="contiguous"):
        bag_ops.embedding_bag_bwd(50, ids, None, torch.randn(8, 4, device=dev).T)
    with pytest.raises(ValueError, match="2\\^31"):
        bag_ops.embedding_bag_bwd(2**31, ids, None, dout)


# --------------------------------------------------------------------------
# gated aggregation: forward and backward, on both layouts
# --------------------------------------------------------------------------
from repro_torch.kernels.gnn_aggregate import (
    csr_index,
    ell_as_csr,
    ell_index,
    gnn_aggregate_csr_ref,
    gnn_aggregate_ref,
)
from repro_torch.kernels.gnn_aggregate import ops as agg_ops

# (n_nodes, n_edges, dim): the smoke width, the full width with padding
# slots, a Cora-like graph, odd widths (scalar loads), and an isolated tail
AGG_GRAPHS = [(40, 160, 16), (300, 2000, 70), (3072, 10752, 70), (64, 500, 13),
              (50, 30, 8), (200, 1500, 128)]
# CSR graphs (n_nodes, n_edges, dim, hub edges): the rows above, a hub row
# and a hub source of 5,000 edges each (split over a block's warps), and
# widths past one panel of lanes (fp32 300: two panels; bf16 264 likewise)
CSR_GRAPHS = AGG_GRAPHS + [(3000, 20000, 70, 5000), (500, 3000, 16, 4500),
                           (200, 1500, 300, 0), (200, 1500, 264, 300)]


def _ell_case(n, e, dim, dtype, dev, seed=0):
    rng = np.random.default_rng(seed)
    ei = np.stack([rng.integers(0, n, e), rng.integers(0, n // 2 + 1, e)])  # nodes > n/2: none in
    ell = ell_index(ei, n, dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    h = torch.randn(n, dim, generator=g, device=dev).to(dtype)
    eta = torch.rand(e, dim, generator=g, device=dev).to(dtype)
    gates = torch.zeros(n * ell.max_deg, dim, device=dev, dtype=dtype)
    gates[ell.slot] = eta
    dout = torch.randn(n, dim, generator=g, device=dev).to(dtype)
    return ell, h, gates.view(n, ell.max_deg, dim), dout


def _csr_case(n, e, dim, hub, dtype, dev, seed=0):
    """A graph with no in-edge into the upper half of the nodes, plus `hub`
    edges into node 7 and `hub` edges out of node 11; its CSR index, h,
    gates in slot order and the gradients of num and den."""
    rng = np.random.default_rng(seed)
    src = np.concatenate([rng.integers(0, n, e), rng.integers(0, n, hub), np.full(hub, 11)])
    dst = np.concatenate([rng.integers(0, n // 2 + 1, e), np.full(hub, 7),
                          rng.integers(0, n // 2 + 1, hub)])
    idx = csr_index(torch.from_numpy(np.stack([src, dst]).astype(np.int32)).to(dev), n)
    g = torch.Generator(device=dev).manual_seed(seed)
    h = torch.randn(n, dim, generator=g, device=dev).to(dtype)
    gates = torch.rand(src.shape[0], dim, generator=g, device=dev).to(dtype)
    dnum, dden = (torch.randn(n, dim, generator=g, device=dev).to(dtype) for _ in range(2))
    return idx, h, gates, dnum, dden


def _agg_oracle(h, nbr, gates, dout):
    """The plain version plus autograd, in fp32 on the same values."""
    h32, g32 = (t.detach().float().requires_grad_(True) for t in (h, gates))
    out = gnn_aggregate_ref(h32, nbr, g32)
    dh, dg = torch.autograd.grad(out, (h32, g32), dout.float())
    return out.detach(), dh, dg


def _csr_oracle(h, idx, gates, dnum, dden, with_den):
    """The plain CSR version plus autograd, in fp32 on the same values:
    (num, den or None, dh, dgates)."""
    h32, g32 = (t.detach().float().requires_grad_(True) for t in (h, gates))
    num, den = gnn_aggregate_csr_ref(h32, idx.row_ptr, idx.col, g32, with_den)
    outs, grads = [num], [dnum.float()]
    if with_den:
        outs.append(den)
        grads.append(dden.float())
    dh, dg = torch.autograd.grad(outs, (h32, g32), grads)
    return num.detach(), den.detach() if with_den else None, dh, dg


@pytest.mark.cuda
@pytest.mark.parametrize("graph", AGG_GRAPHS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gnn_aggregate_kernels_match_plain(graph, dtype):
    """The padded-ELL contract, run as its CSR form on the same kernels."""
    dev = _cuda()
    ell, h, gates, dout = _ell_case(*graph, dtype, dev)
    want = _agg_oracle(h, ell.nbr, gates, dout)
    f0, b0 = agg_ops.gnn_aggregate.launches_fwd, agg_ops.gnn_aggregate.launches_bwd
    e0 = agg_ops.gnn_aggregate.launches_by_layout["ell"]
    hg, gg = h.clone().requires_grad_(True), gates.clone().requires_grad_(True)
    out = agg_ops.gnn_aggregate(hg, ell.nbr, gg, ell.rev)
    dh, dg = torch.autograd.grad(out, (hg, gg), dout)
    torch.cuda.synchronize()
    assert agg_ops.gnn_aggregate.launches_fwd == f0 + 1
    assert agg_ops.gnn_aggregate.launches_bwd == b0 + 1
    assert agg_ops.gnn_aggregate.launches_by_layout["ell"] == e0 + 2
    tol = TOLS[dtype]
    for name, got, ref in zip(("out", "dh", "dgates"), (out, dh, dg), want):
        assert got.dtype == dtype, name
        torch.testing.assert_close(got.float(), ref, atol=tol, rtol=tol, msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("graph", CSR_GRAPHS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_den", [False, True])
def test_gnn_aggregate_csr_kernels_match_plain(graph, dtype, with_den):
    dev = _cuda()
    n, e, dim, *hub = graph
    idx, h, gates, dnum, dden = _csr_case(n, e, dim, hub[0] if hub else 0, dtype, dev)
    want = _csr_oracle(h, idx, gates, dnum, dden, with_den)
    f0, c0 = agg_ops.gnn_aggregate.launches_fwd, agg_ops.gnn_aggregate.launches_by_layout["csr"]
    hg, gg = h.clone().requires_grad_(True), gates.clone().requires_grad_(True)
    num, den = agg_ops.gnn_aggregate_csr(hg, idx.row_ptr, idx.col, gg, idx.rev,
                                         with_den=with_den)
    outs, grads = ([num, den], [dnum, dden]) if with_den else ([num], [dnum])
    dh, dg = torch.autograd.grad(outs, (hg, gg), grads)
    torch.cuda.synchronize()
    assert agg_ops.gnn_aggregate.launches_fwd == f0 + 1
    assert agg_ops.gnn_aggregate.launches_by_layout["csr"] == c0 + 2
    assert (den is None) == (not with_den)
    tol = TOLS[dtype]
    for name, got, ref in zip(("num", "den", "dh", "dgates"), (num, den, dh, dg), want):
        if ref is None:
            continue
        assert got.dtype == dtype, name
        torch.testing.assert_close(got.float(), ref, atol=tol, rtol=tol, msg=name)
    assert not num[n // 2 + 1:].any()  # rows with no in-edge are zero


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gnn_aggregate_backward_is_deterministic(dtype):
    """Two backward launches give equal bits, on the padded ELL and on a CSR
    index whose hub row and hub source are split over a block's warps."""
    dev = _cuda()
    ell, h, gates, dout = _ell_case(3000, 40000, 70, dtype, dev, seed=1)
    row_ptr, col, rev = ell_as_csr(ell.nbr, ell.rev)
    flat = gates.view(-1, 70)
    first = agg_ops.gnn_aggregate_bwd(h, row_ptr, col, flat, dout, None, rev)
    second = agg_ops.gnn_aggregate_bwd(h, row_ptr, col, flat, dout, None, rev)
    for a, b in zip(first, second):
        assert torch.equal(a, b)
    idx, h, gates, dnum, dden = _csr_case(3000, 40000, 70, 6000, dtype, dev, seed=2)
    first = agg_ops.gnn_aggregate_bwd(h, idx.row_ptr, idx.col, gates, dnum, dden, idx.rev)
    second = agg_ops.gnn_aggregate_bwd(h, idx.row_ptr, idx.col, gates, dnum, dden, idx.rev)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_gnn_aggregate_ell_out_of_range_ids_give_nan():
    """Source ids index as jnp.take does: an id outside [-N_h, N_h) makes its
    row NaN, a negative one counts from the end."""
    dev = _cuda()
    rng = np.random.default_rng(4)
    h = torch.from_numpy(rng.normal(size=(10, 8)).astype(np.float32)).to(dev)
    nbr = rng.integers(0, 10, size=(6, 3)).astype(np.int32)
    nbr[1, 2], nbr[4, 0], nbr[5, 1] = 10, -11, -1
    g = torch.from_numpy(rng.random((6, 3, 8)).astype(np.float32)).to(dev)
    nbr = torch.from_numpy(nbr).to(dev)
    rev = (torch.zeros(11, dtype=torch.int32, device=dev),  # no gradient asked for
           torch.zeros(0, dtype=torch.int32, device=dev))
    for dtype in (torch.float32, torch.bfloat16):
        got = agg_ops.gnn_aggregate(h.to(dtype), nbr, g.to(dtype), rev)
        want = gnn_aggregate_ref(h.to(dtype).float(), nbr, g.to(dtype).float())
        bad = torch.tensor([False, True, False, False, True, False], device=dev)
        assert torch.isnan(got[bad]).all() and not torch.isnan(got[~bad]).any()
        torch.testing.assert_close(got[~bad].float(), want[~bad], atol=TOLS[dtype],
                                   rtol=TOLS[dtype])


@pytest.mark.cuda
def test_csr_index_builds_without_a_sync():
    """The index is built on the card with no read back to the host: any
    sync raises under the sync debug mode.  It matches the CPU build."""
    dev = _cuda()
    rng = np.random.default_rng(3)
    ei = torch.from_numpy(rng.integers(0, 5000, size=(2, 60000)).astype(np.int32))
    ei_dev = ei.to(dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        idx = csr_index(ei_dev, 5000)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    want = csr_index(ei, 5000)
    for name in ("perm", "row_ptr", "col", "rev_ptr", "rev_slot", "rev_row"):
        assert torch.equal(getattr(idx, name).cpu(), getattr(want, name)), name


@pytest.mark.cuda
def test_gnn_aggregate_rejects_bad_inputs():
    dev = _cuda()
    h = torch.randn(10, 8, device=dev)
    nbr = torch.zeros(10, 3, dtype=torch.int32, device=dev)
    gates = torch.rand(10, 3, 8, device=dev)
    rev = (torch.zeros(11, dtype=torch.int32, device=dev),  # no real slot
           torch.zeros(0, dtype=torch.int32, device=dev))
    with pytest.raises(TypeError, match="int32"):
        agg_ops.gnn_aggregate(h, nbr.long(), gates, rev)
    with pytest.raises(TypeError, match="share fp32 or bf16"):
        agg_ops.gnn_aggregate(h, nbr, gates.bfloat16(), rev)
    with pytest.raises(ValueError, match="shapes"):
        agg_ops.gnn_aggregate(h, nbr, gates[:, :2].contiguous(), rev)
    with pytest.raises(ValueError, match="contiguous"):
        agg_ops.gnn_aggregate(torch.randn(8, 10, device=dev).T, nbr, gates, rev)
    with pytest.raises(ValueError, match="gates on cpu"):
        agg_ops.gnn_aggregate(h, nbr, gates.cpu(), rev)
    with pytest.raises(ValueError, match="rev_ptr"):
        agg_ops.gnn_aggregate(h, nbr, gates, (torch.zeros(5, dtype=torch.int32, device=dev),
                                              torch.zeros(30, dtype=torch.int32, device=dev)))
    idx = csr_index(torch.zeros(2, 4, dtype=torch.int32, device=dev), 10)
    flat = torch.rand(4, 8, device=dev)
    with pytest.raises(ValueError, match="row_ptr"):
        agg_ops.gnn_aggregate_csr(h, idx.row_ptr.long(), idx.col, flat, idx.rev)
    with pytest.raises(ValueError, match="shapes"):
        agg_ops.gnn_aggregate_csr(h, idx.row_ptr, idx.col, flat[:3], idx.rev)
    with pytest.raises(ValueError, match="rev_row"):
        agg_ops.gnn_aggregate_csr(h, idx.row_ptr, idx.col, flat, idx.rev[:2] + (idx.col.cpu(),))


# --------------------------------------------------------------------------
# the model paths on the card against the CPU
# --------------------------------------------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["fm", "dcn-v2", "bst", "sasrec"])
def test_recsys_serve_steps_on_the_card_match_the_cpu(arch):
    dev = _cuda()
    import dataclasses

    from repro_torch.configs import get_config, get_shapes
    from repro_torch.data import make_batch
    from repro_torch.models.layers import init_params
    from repro_torch.train import build_param_specs, build_serve_step

    cfg = get_config(arch, smoke=True)
    for cell in get_shapes(arch)[1:]:
        p = dict(cell.params, batch=min(cell.params["batch"], 64))
        if "n_candidates" in p:
            p["n_candidates"] = min(cfg.item_vocab or sum(cfg.vocab_sizes), 1000)
        cell = dataclasses.replace(cell, params=p)
        params = init_params(torch.Generator().manual_seed(0), build_param_specs(cfg, cell),
                             cfg.dtype, "cpu")
        batch = make_batch(cfg, cell, seed=1, device="cpu")
        if "candidate_ids" in batch:
            batch["candidate_ids"] = torch.arange(p["n_candidates"], dtype=torch.int32)
        clone = lambda t: [clone(v) for v in t] if isinstance(t, list) else (
            {k: clone(v) for k, v in t.items()} if isinstance(t, dict) else t.to(dev))
        before = bag_ops.embedding_bag.launches
        got = build_serve_step(cfg, cell)(clone(params), **clone(batch))
        want = build_serve_step(cfg, cell)(params, **batch)
        torch.cuda.synchronize()
        assert bag_ops.embedding_bag.launches > before
        tol = 1e-4 * float(want.abs().max())
        torch.testing.assert_close(got.cpu(), want, atol=tol, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["fm", "dcn-v2", "bst", "sasrec"])
def test_recsys_train_steps_on_the_card_match_the_cpu(arch):
    """Two fp32 smoke train steps on the card (every table gradient from the
    backward kernel) against the same steps on the CPU: loss and parameters
    within 1e-4."""
    dev = _cuda()
    import dataclasses

    from repro_torch.configs import get_config, get_shapes
    from repro_torch.data import make_batch
    from repro_torch.models.layers import init_params
    from repro_torch.train import build_param_specs, build_train_step, make_train_state
    from repro_torch.tree import leaves

    cfg = get_config(arch, smoke=True)
    cell = next(c for c in get_shapes(arch) if c.kind == "train")
    cell = dataclasses.replace(cell, params=dict(cell.params, batch=256))
    params = init_params(torch.Generator().manual_seed(0), build_param_specs(cfg, cell),
                         cfg.dtype, "cpu")
    clone = lambda t: [clone(v) for v in t] if isinstance(t, list) else (
        {k: clone(v) for k, v in t.items()} if isinstance(t, dict) else t.to(dev))
    dev_state, cpu_state = make_train_state(clone(params)), make_train_state(params)
    step = build_train_step(cfg, cell)
    before = bag_ops.embedding_bag.launches_bwd
    for s in range(2):
        batch = make_batch(cfg, cell, seed=s, device="cpu")
        dev_state, a = step(dev_state, clone(batch))
        cpu_state, b = step(cpu_state, batch)
        torch.testing.assert_close(a["loss"].cpu(), b["loss"], atol=1e-4, rtol=1e-4)
    torch.cuda.synchronize()
    assert bag_ops.embedding_bag.launches_bwd > before
    for pa, pb in zip(leaves(dev_state["params"]), leaves(cpu_state["params"])):
        torch.testing.assert_close(pa.cpu(), pb, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_gnn_train_steps_on_the_card_match_the_cpu():
    dev = _cuda()
    from repro_torch.configs import ShapeCell, get_config
    from repro_torch.data import CSRGraph, NeighborSampler, random_graph
    from repro_torch.models.gnn import gnn_specs
    from repro_torch.models.layers import init_params
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import build_train_step, make_train_state

    cfg = get_config("gatedgcn", smoke=True)
    cell = ShapeCell("mb", "minibatch", {"d_feat": 12})
    ei = random_graph(300, 3000, seed=0)
    sampler = NeighborSampler(CSRGraph.from_edge_index(ei, 300), (4, 3), seed=0)
    feats = np.random.default_rng(1).normal(size=(300, 12)).astype(np.float32)
    params = init_params(torch.Generator().manual_seed(0), gnn_specs(cfg, 12), cfg.dtype, "cpu")
    clone = lambda t: {k: clone(v) for k, v in t.items()} if isinstance(t, dict) else t.to(dev)
    dev_state, cpu_state = make_train_state(clone(params)), make_train_state(params)
    opt = AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=5)
    dev_step, cpu_step = build_train_step(cfg, cell, opt), build_train_step(cfg, cell, opt)
    f0 = agg_ops.gnn_aggregate.launches_fwd
    e0 = agg_ops.gnn_aggregate.launches_by_layout["ell"]
    for s in range(3):
        block = sampler.sample(np.arange(8 * s, 8 * s + 8, dtype=np.int32))
        batch = {"node_feat": torch.from_numpy(feats[block["nodes"]]),
                 "edge_index": torch.from_numpy(block["edge_index"]),
                 "labels": torch.arange(8, dtype=torch.int32) % cfg.n_classes}
        dev_state, a = dev_step(dev_state, clone(batch))
        cpu_state, b = cpu_step(cpu_state, batch)
        torch.testing.assert_close(a["loss"].cpu(), b["loss"], atol=1e-4, rtol=1e-4)
    assert agg_ops.gnn_aggregate.launches_fwd - f0 == 3 * cfg.n_layers
    assert agg_ops.gnn_aggregate.launches_by_layout["ell"] == e0  # the model runs on CSR
    for k in ("node_encoder", "readout"):
        torch.testing.assert_close(dev_state["params"][k].cpu(), cpu_state["params"][k],
                                   atol=1e-4, rtol=1e-4)


def _cuda_executor(tmp_path, **kw):
    from repro_torch.core import TSAR, IntermediateStore, WorkflowExecutor

    return WorkflowExecutor(store=IntermediateStore(tmp_path / "store"),
                            policy=TSAR(with_state=True), **kw)


@pytest.mark.cuda
def test_executor_on_cuda_values_stores_reloads_and_reuses(tmp_path):
    dev = _cuda()
    ex = _cuda_executor(tmp_path)
    assert ex.device == "cuda"
    calls = {"scale": 0, "mix": 0}

    def scale(x, by=2.0):
        calls["scale"] += 1
        return x * by

    def mix(x, k=1):
        calls["mix"] += 1
        return {"sum": x.sum(0), "rows": x[:k].to(torch.bfloat16)}

    ex.register_fn("scale", scale, by=2.0)
    ex.register_fn("mix", mix, k=1)
    g = torch.Generator(device=dev).manual_seed(0)
    data = torch.randn(64, 32, generator=g, device=dev)
    steps = ["scale", ("mix", {"k": 3})]
    cold = ex.run("ds", data, steps, "w1")
    assert cold.n_skipped == 0 and len(cold.stored_keys) == 2
    warm = ex.run("ds", data, steps, "w2")
    assert warm.n_skipped == 2 and calls == {"scale": 1, "mix": 1}
    for k in ("sum", "rows"):
        assert warm.output[k].is_cuda
        assert torch.equal(warm.output[k], cold.output[k])
    assert warm.output["rows"].dtype == torch.bfloat16
    tail = ex.run("ds", data, ["scale", ("mix", {"k": 5})], "w3")  # the scaled prefix reloads
    assert tail.n_skipped == 1 and calls == {"scale": 1, "mix": 2}
    assert tail.output["rows"].is_cuda


@pytest.mark.cuda
def test_module_seconds_cover_the_device_work(tmp_path):
    """A module that queues a known device sleep and returns at once: its
    seconds in the executor and in the DAG scheduler hold the sleep, which
    CUDA events recorded inside the module time."""
    dev = _cuda()
    from repro_torch.sched import DagScheduler

    slept = []

    def sleepy(x, cycles=200_000_000):  # about 0.1 s at the H100's 1.98 GHz
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        torch.cuda._sleep(cycles)
        end.record()
        slept.append((start, end))
        return x + 1  # queued behind the sleep: the host returns before it ends

    ex = _cuda_executor(tmp_path)
    ex.register_fn("sleepy", sleepy, cycles=200_000_000)
    r = ex.run("ds", torch.zeros(4, device=dev), ["sleepy"], "w1")
    start, end = slept[-1]
    device_s = start.elapsed_time(end) / 1e3
    assert device_s > 0.02
    assert r.module_seconds[0] >= device_s
    rec = ex.store.records[r.stored_keys[0]]
    assert rec.compute_s >= device_s  # the gain eviction prices it by

    sched = DagScheduler(store=ex.store, policy=ex.policy, registry=ex.registry)
    try:
        dag = sched.dag("ds2", "d1")
        dag.add("a", "sleepy", {"cycles": 100_000_000})
        res = sched.run(dag, torch.zeros(4, device=dev))
        start, end = slept[-1]
        assert res.module_seconds[0] >= start.elapsed_time(end) / 1e3
        assert res.output.is_cuda
    finally:
        sched.close()


@pytest.mark.cuda
def test_dag_branches_on_the_card_equal_the_sequential_runs(tmp_path):
    dev = _cuda()
    from repro_torch.core import TSAR, IntermediateStore, WorkflowExecutor
    from repro_torch.sched import DagScheduler

    def stem(x):
        return torch.tanh(x @ x.T)

    def head(x, col=0):
        return (x[:, col:col + 8] @ x[:8]).float()

    g = torch.Generator(device=dev).manual_seed(1)
    data = torch.randn(256, 256, generator=g, device=dev)
    ex = WorkflowExecutor(store=IntermediateStore(tmp_path / "a"), policy=TSAR(with_state=True))
    sched = DagScheduler(store=IntermediateStore(tmp_path / "b"), policy=TSAR(with_state=True),
                         max_workers=2)
    for reg in (ex, sched):
        reg.register_fn("stem", stem)
        reg.register_fn("head", head, col=0)
    want = [ex.run("ds", data, ["stem", ("head", {"col": c})], f"w{c}").output for c in (0, 8)]
    try:
        dag = sched.dag("ds", "d")
        dag.add("s", "stem")
        dag.add("h0", "head", {"col": 0}, after="s")
        dag.add("h8", "head", {"col": 8}, after="s")
        res = sched.run(dag, data)
    finally:
        sched.close()
    assert res.node_results["s"].source == "computed" and res.n_computed == 3
    assert torch.equal(res.outputs["h0"], want[0]) and torch.equal(res.outputs["h8"], want[1])
