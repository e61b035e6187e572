"""The hand-written CUDA kernels against their plain torch versions, on the
card.  They have no CPU mode, so these tests skip where no CUDA device is
present; on the card they run with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py

This file imports torch and the port only (no JAX), so it runs on a machine
that has no JAX installed."""
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
def test_engine_graph_on_the_card_matches_the_cpu():
    """The fp32 smoke engine on the card, which replays one captured graph a
    token, gives the CPU engine's tokens over the smoke stream, and the
    snapshots it stored are untouched by later requests."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models.layers import init_params
    from repro_torch.models.transformer import lm_specs
    from repro_torch.serve import ServeEngine

    cfg = dataclasses.replace(get_config("tinyllama-1.1b", smoke=True), dtype=torch.float32)
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
    # replayed token, plus the capture's eager warm-up step
    assert on_dev._graph is not None
    assert on_dev._graph.kernels == {"fused": cfg.n_layers}
    assert ops.decode_attention.launches_by_variant["fused"] == cfg.n_layers * (tokens + 1)


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
@pytest.mark.parametrize("dtype, dh", [(torch.float32, 64), (torch.bfloat16, 256),
                                       (torch.bfloat16, 8)])
def test_other_chunks_never_launch_the_chunk_kernel(dtype, dh):
    """fp32 chunks (the exact parity path), dh 256 and dh 8 take the index
    writes and the split kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    case = (2, 16, 8, 2, 256, dh, [0, 200], None)
    assert ops.variant(16, 4, dh, dtype) == "split"
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
# kernels pad to 16 (24) at G 3, which does not divide the wgmma kernels'
# 64-row boxes and takes the WMMA kernels, and dh 136 with a window on a
# non-causal layer; then edges of the wgmma
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
# 128-row tiles; and dh 256 at G 3, which takes the WMMA kernels
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
FLASH_CASES += WIDE_FLASH_CASES


def flash_oracle(q, k, v, dout, causal, window):
    """The plain version plus autograd, in fp32 on the same values: for bf16
    inputs the tolerance then measures the kernel's rounding alone."""
    q32, k32, v32 = (t.detach().float().requires_grad_(True) for t in (q, k, v))
    out = attention_ref(q32, k32, v32, causal=causal, window=window)
    dq, dk, dv = torch.autograd.grad(out, (q32, k32, v32), dout.float())
    lse = attention_lse_ref(q32.detach(), k32.detach(), causal=causal, window=window)
    return out.detach(), lse, dq, dk, dv


@pytest.mark.cuda
@pytest.mark.parametrize("case", FLASH_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
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
    assert by["wmma"] == by["fma"] == {"fwd": 0, "bwd": 0}


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
    assert by["wmma"] == by["fma"] == {"fwd": 0, "bwd": 0}


# (B, S, Hq, Hkv, dh): a ragged shape, the train shape, and gemma3's head
# dim (dK/dV columns split between the two warpgroups)
DETERMINISM_CASES = [(2, 300, 8, 2, 64), (4, 2048, 32, 4, 64), (1, 2048, 8, 4, 256)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", DETERMINISM_CASES)
def test_flash_attention_backward_is_deterministic(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    B, S, Hq, Hkv, dh = case
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(2)
    q = torch.randn(B, S, Hq, dh, generator=g, device=dev).to(torch.bfloat16)
    k = torch.randn(B, S, Hkv, dh, generator=g, device=dev).to(torch.bfloat16)
    v = torch.randn(B, S, Hkv, dh, generator=g, device=dev).to(torch.bfloat16)
    dout = torch.randn_like(q)
    out, lse = flash_ops.flash_attention_fwd(q, k, v)
    first = flash_ops.flash_attention_bwd(q, k, v, out, lse, dout)
    second = flash_ops.flash_attention_bwd(q, k, v, out, lse, dout)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


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


# --------------------------------------------------------------------------
# embedding bag
# --------------------------------------------------------------------------
import numpy as np

from repro_torch.kernels.embedding_bag import embedding_bag_ref
from repro_torch.kernels.embedding_bag import ops as bag_ops

# (V, dim, n_bags, bag_size, combiner, weighted): the FM, DCN-v2 (bags of
# one), retrieval and SASRec-like widths, the smoke widths, 128 and an odd
# width (scalar loads), and an empty bag
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
]


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", BAG_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_embedding_bag_kernel_matches_plain(case, dtype):
    dev = _cuda()
    V, dim, n_bags, bag, combiner, weighted = case
    g = torch.Generator(device=dev).manual_seed(3)
    table = torch.randn(V, dim, generator=g, device=dev).to(dtype)
    ids = torch.randint(0, V, (n_bags, bag), generator=g, device=dev, dtype=torch.int32)
    w = torch.rand(n_bags, bag, generator=g, device=dev) if weighted else None
    before = bag_ops.embedding_bag.launches
    got = bag_ops.embedding_bag(table, ids, w, combiner=combiner)
    want = embedding_bag_ref(table.float(), ids, w, combiner)  # fp32 on the same values
    torch.cuda.synchronize()
    assert bag_ops.embedding_bag.launches == before + 1
    assert got.dtype == dtype and got.shape == (n_bags, dim)
    torch.testing.assert_close(got.float(), want, atol=TOLS[dtype], rtol=TOLS[dtype],
                               equal_nan=True)


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
