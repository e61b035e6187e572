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
    before = ops.decode_attention.launches
    got = ops.decode_attention(q, k, v, q_start, window=window)
    want = attention.decode_attention(q, k, v, q_start, window=window)
    torch.cuda.synchronize()
    assert ops.decode_attention.launches == before + 1
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
# flash attention: forward (out, lse) and backward (dq, dk, dv)
# --------------------------------------------------------------------------
from repro_torch.kernels.flash_attention import attention_lse_ref, attention_ref
from repro_torch.kernels.flash_attention import ops as flash_ops

# (B, S, Hq, Hkv, dh, causal, window): the train shape, gemma3-like local,
# smoke, ragged non-causal, MQA/MHA with a ragged edge, and head dims the
# bf16 kernels pad to 16 (24) or that take the WMMA kernels (136; and G 3,
# which does not divide the wgmma kernels' 64-row boxes); then edges of the
# wgmma kernels: S not a multiple of their row (128) or key (64, 128) tiles,
# G 1, 2, 8 and 64, a window on a causal and on a non-causal layer, dh 16
# and 128 (two 64-column chunks)
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


# (B, S, Hq, Hkv, dh): a ragged shape, and the train shape
DETERMINISM_CASES = [(2, 300, 8, 2, 64), (4, 2048, 32, 4, 64)]


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
# gated aggregation: forward and backward
# --------------------------------------------------------------------------
from repro_torch.kernels.gnn_aggregate import ell_index, gnn_aggregate_ref
from repro_torch.kernels.gnn_aggregate import ops as agg_ops

# (n_nodes, n_edges, dim): the smoke width, the full width with padding
# slots, a Cora-like graph, odd widths (scalar loads), and an isolated tail
AGG_GRAPHS = [(40, 160, 16), (300, 2000, 70), (3072, 10752, 70), (64, 500, 13),
              (50, 30, 8), (200, 1500, 128)]


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


def _agg_oracle(h, nbr, gates, dout):
    """The plain version plus autograd, in fp32 on the same values."""
    h32, g32 = (t.detach().float().requires_grad_(True) for t in (h, gates))
    out = gnn_aggregate_ref(h32, nbr, g32)
    dh, dg = torch.autograd.grad(out, (h32, g32), dout.float())
    return out.detach(), dh, dg


@pytest.mark.cuda
@pytest.mark.parametrize("graph", AGG_GRAPHS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gnn_aggregate_kernels_match_plain(graph, dtype):
    dev = _cuda()
    ell, h, gates, dout = _ell_case(*graph, dtype, dev)
    want = _agg_oracle(h, ell.nbr, gates, dout)
    f0, b0 = agg_ops.gnn_aggregate.launches_fwd, agg_ops.gnn_aggregate.launches_bwd
    hg, gg = h.clone().requires_grad_(True), gates.clone().requires_grad_(True)
    out = agg_ops.gnn_aggregate(hg, ell.nbr, gg, ell.rev)
    dh, dg = torch.autograd.grad(out, (hg, gg), dout)
    torch.cuda.synchronize()
    assert agg_ops.gnn_aggregate.launches_fwd == f0 + 1
    assert agg_ops.gnn_aggregate.launches_bwd == b0 + 1
    tol = TOLS[dtype]
    for name, got, ref in zip(("out", "dh", "dgates"), (out, dh, dg), want):
        assert got.dtype == dtype, name
        torch.testing.assert_close(got.float(), ref, atol=tol, rtol=tol, msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gnn_aggregate_backward_is_deterministic(dtype):
    dev = _cuda()
    ell, h, gates, dout = _ell_case(3000, 40000, 70, dtype, dev, seed=1)
    first = agg_ops.gnn_aggregate_bwd(h, ell.nbr, gates, dout, *ell.rev)
    second = agg_ops.gnn_aggregate_bwd(h, ell.nbr, gates, dout, *ell.rev)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


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
    for s in range(3):
        block = sampler.sample(np.arange(8 * s, 8 * s + 8, dtype=np.int32))
        batch = {"node_feat": torch.from_numpy(feats[block["nodes"]]),
                 "edge_index": torch.from_numpy(block["edge_index"]),
                 "labels": torch.arange(8, dtype=torch.int32) % cfg.n_classes}
        dev_state, a = dev_step(dev_state, clone(batch))
        cpu_state, b = cpu_step(cpu_state, batch)
        torch.testing.assert_close(a["loss"].cpu(), b["loss"], atol=1e-4, rtol=1e-4)
    assert agg_ops.gnn_aggregate.launches_fwd - f0 == 3 * cfg.n_layers
    for k in ("node_encoder", "readout"):
        torch.testing.assert_close(dev_state["params"][k].cpu(), cpu_state["params"][k],
                                   atol=1e-4, rtol=1e-4)
