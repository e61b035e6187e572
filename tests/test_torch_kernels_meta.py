"""The kernels' shape-only path on the ``meta`` device (the dry-run's), on
the CPU: each wrapper, forward and backward, gives on meta tensors the
shapes and dtypes that its plain version gives on the CPU, counts its work
and launches nothing; no plain version runs in a dry-run (a spy on each);
``run_cell`` on the smoke configs gives ``status: ok`` with the outputs of a
real CPU run of the same step; and ``gnn.forward`` on meta reads nothing
back to the host."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import ShapeCell, get_config, get_shapes
from repro_torch.data import make_batch
from repro_torch.kernels import meta
from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.kernels.embedding_bag import ops as bag_ops
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.gnn_aggregate import csr_index, ell_index
from repro_torch.kernels.gnn_aggregate import ops as agg_ops
from repro_torch.launch import dryrun
from repro_torch.models import gnn, transformer
from repro_torch.models.layers import init_params
from repro_torch.train import build_param_specs

M = torch.device("meta")


def _pair(shape, dtype, seed, grad=True):
    """The same shape on the CPU (values) and on meta."""
    g = torch.Generator().manual_seed(seed)
    cpu = torch.randn(shape, generator=g).to(dtype).requires_grad_(grad)
    return cpu, torch.empty(shape, dtype=dtype, device=M).requires_grad_(grad)


def _sig(ts):
    return [(tuple(t.shape), t.dtype) for t in ts]


def _launch_counts():
    return (flash_ops.flash_attention.launches_fwd, flash_ops.flash_attention.launches_bwd,
            dict(decode_ops.decode_attention.launches_by_variant),
            bag_ops.embedding_bag.launches, bag_ops.embedding_bag.launches_bwd,
            agg_ops.gnn_aggregate.launches_fwd, agg_ops.gnn_aggregate.launches_bwd)


FLASH = [  # B, Sq, Sk, Hq, Hkv, dh, causal, window, dtype (variant)
    (2, 64, 64, 8, 2, 64, True, None, torch.bfloat16),  # wgmma
    (1, 40, 40, 6, 2, 128, True, 16, torch.bfloat16),  # wgmma_rows (G 3)
    (2, 48, 48, 4, 4, 32, False, None, torch.float32),  # tf32x3
]


@pytest.mark.parametrize("case", FLASH, ids=["wgmma", "wgmma_rows", "tf32x3"])
def test_flash_meta_shapes_equal_the_plain_version(case):
    B, Sq, Sk, Hq, Hkv, dh, causal, window, dtype = case
    (qc, qm), (kc, km), (vc, vm) = (_pair(s, dtype, i) for i, s in enumerate(
        ((B, Sq, Hq, dh), (B, Sk, Hkv, dh), (B, Sk, Hkv, dh))))
    before = _launch_counts()
    with meta.counting() as counts:
        om = flash_ops.flash_attention(qm, km, vm, causal=causal, window=window)
        gm = torch.autograd.grad(om, (qm, km, vm), torch.empty_like(om))
    oc = flash_ops.flash_attention(qc, kc, vc, causal=causal, window=window)
    gc_ = torch.autograd.grad(oc, (qc, kc, vc), torch.ones_like(oc))
    assert _sig([om, *gm]) == _sig([oc, *gc_])
    assert om.device.type == "meta" and _launch_counts() == before
    assert counts.calls == {"flash_attention_fwd": 1, "flash_attention_bwd": 1}
    pairs = flash_ops.unmasked_pairs(Sq, Sk, causal, window)
    assert counts.flops["flash_attention_fwd"] == 4 * B * Hq * dh * pairs
    assert counts.flops["flash_attention_bwd"] == 8 * B * Hq * dh * pairs
    unit = "tf32x3" if dtype == torch.float32 else "bf16"
    assert set(counts.flops_by_unit) == {unit}


def test_unmasked_pairs_count_the_mask():
    assert flash_ops.unmasked_pairs(4, 4, True, None) == 10
    assert flash_ops.unmasked_pairs(4, 4, False, None) == 16
    assert flash_ops.unmasked_pairs(5, 5, True, 2) == 9  # 1 + 2 * 4
    S, w = 300, 37
    want = sum(s - max(0, s - w + 1) + 1 for s in range(S))
    assert flash_ops.unmasked_pairs(S, S, True, w) == want


def test_flash_meta_allocates_the_kernels_scratch():
    """The tf32x3 backward's scratch (the split operands and the chunk
    partials) is allocated on meta, sized by work_floats."""
    B, S, Hq, Hkv, dh = 1, 256, 4, 2, 64
    args = (B, S, S, Hq, Hkv, dh, 1, 0, flash_ops.VARIANTS.index("tf32x3"))
    n_bwd = flash_ops.work_floats(*args, True)
    assert n_bwd > flash_ops.work_floats(*args, False) > 0
    wg = flash_ops.VARIANTS.index("wgmma")
    assert flash_ops.work_floats(*args[:8], wg, False) == 0
    assert flash_ops.work_floats(*args[:8], wg, True) == B * Hq * S
    rk = dryrun.Reckoner()
    with rk:
        q = torch.empty(B, S, Hq, dh, device=M)
        k = torch.empty(B, S, Hkv, dh, device=M)
        out, lse = flash_ops.flash_attention_fwd(q, k, k, causal=True)
        base = rk.live
        flash_ops.flash_attention_bwd(q, k, k, out, lse, torch.empty_like(out), causal=True)
    assert rk.peak - base >= 4 * n_bwd


@pytest.mark.parametrize("S,dtype,var,dh", [
    pytest.param(1, torch.bfloat16, "fused", 32, id="1-dtype0-fused"),
    pytest.param(8, torch.bfloat16, "chunk", 32, id="8-dtype1-chunk"),
    pytest.param(8, torch.float32, "split", 32, id="8-dtype2-split"),
    pytest.param(8, torch.bfloat16, "chunk", 256, id="8-dtype3-chunk-dh256"),  # gemma3-4b's
])
def test_decode_meta_shapes_equal_the_plain_version(S, dtype, var, dh):
    B, T, Hq, Hkv = 2, 64, 8, 2
    assert decode_ops.variant(S, Hq // Hkv, dh, dtype) == var
    q_start = torch.tensor([3, 17], dtype=torch.int32)
    cpu = [_pair(s, dtype, i, grad=False)[0] for i, s in enumerate(
        ((B, S, Hq, dh), (B, S, Hkv, dh), (B, S, Hkv, dh), (B, T, Hkv, dh), (B, T, Hkv, dh)))]
    mt = [torch.empty(t.shape, dtype=dtype, device=M) for t in cpu]
    before = _launch_counts()
    with meta.counting() as counts:
        om = decode_ops.decode_attention_chunk(*mt, q_start.to(M))
        sm = decode_ops.decode_attention(mt[0], mt[3], mt[4], q_start.to(M))
    oc = decode_ops.decode_attention_chunk(*cpu, q_start)
    sc = decode_ops.decode_attention(cpu[0], cpu[3], cpu[4], q_start)
    assert _sig([om, sm]) == _sig([oc, sc]) and _launch_counts() == before
    assert counts.calls == ({"decode_attention_split": 2} if var == "split" else
                            {f"decode_attention_{var}": 1, "decode_attention_split": 1})
    assert counts.flops[f"decode_attention_{var}"] > 0


@pytest.mark.parametrize("weighted,combiner", [(False, "sum"), (True, "mean")])
def test_embedding_bag_meta_shapes_equal_the_plain_version(weighted, combiner):
    V, dim, n_bags, bag = 50, 16, 12, 5
    tc, tm = _pair((V, dim), torch.float32, 0)
    ids = torch.from_numpy(np.random.default_rng(0).integers(0, V, (n_bags, bag))
                           .astype(np.int32))
    w = torch.rand(n_bags, bag) if weighted else None
    before = _launch_counts()
    with meta.counting() as counts:
        om = bag_ops.embedding_bag(tm, ids.to(M), None if w is None else w.to(M),
                                   combiner=combiner)
        (gm,) = torch.autograd.grad(om, tm, torch.empty_like(om))
    oc = bag_ops.embedding_bag(tc, ids, w, combiner=combiner)
    (gc_,) = torch.autograd.grad(oc, tc, torch.ones_like(oc))
    assert _sig([om, gm]) == _sig([oc, gc_]) and _launch_counts() == before
    assert counts.calls == {"embedding_bag": 1, "embedding_bag_bwd": 1}
    assert counts.flops["embedding_bag"] == (2 if weighted else 1) * n_bags * bag * dim


def test_gnn_aggregate_meta_shapes_equal_the_plain_version():
    n, E, dim = 30, 90, 16
    ei = np.random.default_rng(0).integers(0, n, (2, E)).astype(np.int32)
    idx_c = csr_index(torch.from_numpy(ei), n)
    idx_m = csr_index(torch.from_numpy(ei).to(M), n)
    hc, hm = _pair((n, dim), torch.float32, 1)
    gc_, gm = _pair((E, dim), torch.float32, 2)
    before = _launch_counts()
    with meta.counting() as counts:
        num_m, den_m = agg_ops.gnn_aggregate_csr(hm, idx_m.row_ptr, idx_m.col, gm, idx_m.rev,
                                                 with_den=True)
        grads_m = torch.autograd.grad((num_m, den_m), (hm, gm),
                                      (torch.empty_like(num_m), torch.empty_like(den_m)))
    num_c, den_c = agg_ops.gnn_aggregate_csr(hc, idx_c.row_ptr, idx_c.col, gc_, idx_c.rev,
                                             with_den=True)
    grads_c = torch.autograd.grad((num_c, den_c), (hc, gc_),
                                  (torch.ones_like(num_c), torch.ones_like(den_c)))
    assert _sig([num_m, den_m, *grads_m]) == _sig([num_c, den_c, *grads_c])
    assert _launch_counts() == before
    assert counts.calls == {"gnn_aggregate_fwd": 1, "gnn_aggregate_bwd": 1}
    assert counts.flops["gnn_aggregate_fwd"] == E * dim * 3
    # the padded-ELL contract
    ell = ell_index(ei, n)
    gates_c = torch.rand(n, ell.max_deg, dim).requires_grad_(True)
    gates_m = torch.empty(gates_c.shape, device=M).requires_grad_(True)
    with meta.counting() as counts:
        om = agg_ops.gnn_aggregate(hm, ell.nbr.to(M), gates_m,
                                   tuple(t.to(M) for t in ell.rev))
        gm2 = torch.autograd.grad(om, (hm, gates_m), torch.empty_like(om))
    oc = agg_ops.gnn_aggregate(hc, ell.nbr, gates_c, ell.rev)
    gc2 = torch.autograd.grad(oc, (hc, gates_c), torch.ones_like(oc))
    assert _sig([om, *gm2]) == _sig([oc, *gc2]) and _launch_counts() == before
    assert counts.calls == {"gnn_aggregate_fwd": 1, "gnn_aggregate_bwd": 1}


class _NoHostRead(TorchDispatchMode):
    """Fails on an op that reads a value back to the host."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten._local_scalar_dense.default, torch.ops.aten.item.default):
            raise AssertionError(f"{func} reads a value back to the host")
        return func(*args, **(kwargs or {}))


def test_gnn_forward_on_meta_reads_nothing_back_to_the_host():
    cfg = get_config("gatedgcn", smoke=True)
    params = {k: v for k, v in init_params(torch.Generator().manual_seed(0),
                                           gnn.gnn_specs(cfg, 12), cfg.dtype, "cpu").items()}
    params = _to(params, M)
    with _NoHostRead():
        logits = gnn.forward(params, cfg, torch.empty(40, 12, device=M),
                             torch.empty(2, 160, dtype=torch.int32, device=M))
    assert logits.shape == (40, cfg.n_classes) and logits.device.type == "meta"


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


@pytest.fixture
def spied(monkeypatch):
    """Every plain version a kernel wrapper (or the model's CPU attention)
    could take raises: a dry-run must never reach one."""
    def boom(*a, **k):
        raise AssertionError("a plain version ran in the dry-run")

    for mod, name in ((flash_ops, "attention_ref"), (decode_ops, "decode_attention_plain"),
                      (decode_ops, "decode_attention_chunk_plain"),
                      (bag_ops, "embedding_bag_ref"), (bag_ops, "embedding_bag_bwd_ref"),
                      (agg_ops, "gnn_aggregate_csr_ref"), (agg_ops, "gnn_aggregate_ref"),
                      (transformer, "gqa_attention"), (transformer, "chunked_gqa_attention")):
        monkeypatch.setattr(mod, name, boom)


LM_TRAIN = ShapeCell("t", "train", {"seq_len": 32, "global_batch": 2})
LM_PREFILL = ShapeCell("p", "prefill", {"seq_len": 32, "global_batch": 2})
LM_DECODE = ShapeCell("d", "decode", {"seq_len": 64, "global_batch": 2})
RECSYS_TRAIN = ShapeCell("r", "train", {"batch": 8})
RECSYS_SERVE = ShapeCell("s", "serve", {"batch": 8})
GRAPH = ShapeCell("g", "full_graph", {"n_nodes": 40, "n_edges": 160, "d_feat": 100})
MOLECULE = next(c for c in get_shapes("gatedgcn") if c.name == "molecule")
RUNS = [
    ("tinyllama-1.1b", LM_TRAIN, "none", {"flash_attention_fwd", "flash_attention_bwd"}),
    ("tinyllama-1.1b", LM_PREFILL, "none", {"flash_attention_fwd"}),
    ("tinyllama-1.1b", LM_DECODE, "none", {"decode_attention_fused"}),
    ("qwen2-moe-a2.7b", LM_TRAIN, "none", {"flash_attention_fwd", "flash_attention_bwd"}),
    ("deepseek-v2-236b", LM_TRAIN, "full", {"flash_attention_fwd", "flash_attention_bwd"}),
    ("deepseek-v2-236b", LM_DECODE, "none", set()),  # MLA decode: plain on the card too
    ("fm", RECSYS_TRAIN, "none", {"embedding_bag", "embedding_bag_bwd"}),
    ("fm", RECSYS_SERVE, "none", {"embedding_bag"}),
    ("gatedgcn", MOLECULE, "none", {"gnn_aggregate_fwd", "gnn_aggregate_bwd"}),
    ("gatedgcn", GRAPH, "full", {"gnn_aggregate_fwd", "gnn_aggregate_bwd"}),
]


@pytest.mark.parametrize("arch,cell,remat,kernels", RUNS,
                         ids=[f"{a}-{c.kind}-{r}" for a, c, r, _ in RUNS])
def test_run_cell_gives_the_outputs_of_a_real_cpu_run(arch, cell, remat, kernels, spied):
    rec = dryrun.run_cell(arch, cell, smoke=True, remat=remat)
    assert rec["status"] == "ok", rec.get("traceback")
    assert set(rec["kernels"]) == kernels
    assert rec["memory"]["peak_hbm_bytes"] >= rec["memory"]["argument_bytes"] > 0
    assert rec["roofline"]["flops_per_chip"] > 0 and rec["roofline"]["hbm_bytes_per_chip"] > 0


@pytest.mark.parametrize("arch,cell,remat,kernels", RUNS,
                         ids=[f"{a}-{c.kind}-{r}" for a, c, r, _ in RUNS])
def test_run_cell_outputs_equal_a_cpu_run(arch, cell, remat, kernels):
    rec = dryrun.run_cell(arch, cell, smoke=True, remat=remat)
    cfg = get_config(arch, smoke=True)
    params = init_params(torch.Generator().manual_seed(0), build_param_specs(cfg, cell),
                         cfg.dtype, "cpu")
    make_state, step = dryrun.build_step(cfg, cell, remat=remat)
    out = step(make_state(params), make_batch(cfg, cell, seed=0, device="cpu"))
    assert rec["outputs"] == dryrun.output_shapes(out)


def _alloc(nbytes: int) -> int:
    return -(-nbytes // dryrun.ALLOC_BYTES) * dryrun.ALLOC_BYTES


@pytest.mark.parametrize("B,T,Hq,Hkv,dh,window,plan", [
    (98, 32_768, 32, 4, 64, None, (64, 1, 1)),  # TinyLlama decode_32k at its cut
    (1, 524_288, 8, 4, 256, 1024, (32, 8, 8)),  # gemma3-4b long_500k, a local layer
    (1, 524_288, 8, 4, 256, None, (32, 66, 2)),  # and a global one
    (7, 32_768, 16, 16, 128, None, (64, 2, 2)),  # qwen2-moe-a2.7b decode_32k at its cut
], ids=["decode_32k-dh64", "long_500k-local", "long_500k-global", "qwen2-moe-decode_32k"])
def test_fused_decode_at_the_lm_cells_on_meta(B, T, Hq, Hkv, dh, window, plan):
    """The fused decode at the serve cells' T on meta: the card path's
    allocations (its output; past one cluster of splits also the fp32
    workspace of the clusters' sums and, made once a device, the tickets),
    the plan from static shapes, every cache key counted, no launch."""
    bf16 = torch.bfloat16
    G = Hq // Hkv
    assert decode_ops.variant(1, G, dh, bf16) == "fused"
    assert decode_ops.plan_fused(B, Hkv, T, dh, bf16, meta.SMS, window) == plan
    n_ws = decode_ops.fused_workspace_floats(B, Hkv, G, dh, plan[1], plan[2])
    assert n_ws == (0 if plan[1] == plan[2] else B * Hkv * plan[1] // plan[2] * (32 + G * dh))
    decode_ops._TICKETS.pop(torch.device(M), None)  # as on a card's first such call
    before = _launch_counts()
    rk = dryrun.Reckoner()
    with rk, meta.counting() as counts:
        q = torch.empty(B, 1, Hq, dh, dtype=bf16, device=M)
        k_new, v_new = (torch.empty(B, 1, Hkv, dh, dtype=bf16, device=M) for _ in range(2))
        k, v = (torch.empty(B, T, Hkv, dh, dtype=bf16, device=M) for _ in range(2))
        q_start = torch.empty(B, dtype=torch.int32, device=M)
        base = rk.live
        out = decode_ops.decode_attention_chunk(q, k_new, v_new, k, v, q_start, window=window)
    assert out.shape == q.shape and out.dtype == bf16 and out.device.type == "meta"
    extra = _alloc(n_ws * 4) + _alloc(decode_ops.FUSED_TICKETS * 4) if n_ws else 0
    assert rk.peak - base == _alloc(out.numel() * 2) + extra
    assert counts.calls == {"decode_attention_fused": 1} and _launch_counts() == before
    assert counts.flops["decode_attention_fused"] == 4 * B * T * Hq * dh
    assert counts.bytes["decode_attention_fused"] >= 2 * B * T * Hkv * dh * 2


@pytest.mark.parametrize("B,Hq,Hkv,dh,dv,window", [
    (10, 32, 4, 64, 64, None),  # TinyLlama prefill_32k at its cut
    (1, 8, 4, 256, 256, 1024),  # gemma3-4b, a local layer
    (1, 8, 4, 256, 256, None),  # and a global one
    (1, 16, 16, 128, 128, None),  # qwen2-moe-a2.7b at its cut
    (1, 128, 128, 192, 128, None),  # deepseek-v2-236b's MLA (wgmma 3x2)
], ids=["tinyllama", "gemma3-local", "gemma3-global", "qwen2-moe", "deepseek-v2-mla"])
def test_flash_forward_at_prefill_32k_on_meta(B, Hq, Hkv, dh, dv, window):
    """The flash forward at S 32,768 on meta: the card path's allocations
    (the output, ``dv`` wide, and the fp32 logsumexp; the wgmma forward
    takes no scratch), the row grid inside the kernel's 65,535, the FLOPs of
    the pairs the mask keeps (Q.K at dh, P.V at dv), no launch."""
    S, bf16 = 32_768, torch.bfloat16
    G = Hq // Hkv
    assert flash_ops.variant(bf16, dh, G, dv) == "wgmma"
    wg = flash_ops.VARIANTS.index("wgmma")
    assert flash_ops.work_floats(B, S, S, Hq, Hkv, dh, 1, window or 0, wg, False, dv=dv) == 0
    assert -(-(S * G) // 64) <= 65_535
    before = _launch_counts()
    rk = dryrun.Reckoner()
    with rk, meta.counting() as counts:
        q = torch.empty(B, S, Hq, dh, dtype=bf16, device=M)
        k = torch.empty(B, S, Hkv, dh, dtype=bf16, device=M)
        v = torch.empty(B, S, Hkv, dv, dtype=bf16, device=M)
        base = rk.live
        out, lse = flash_ops.flash_attention_fwd(q, k, v, causal=True, window=window)
    assert out.shape == (B, S, Hq, dv) and out.dtype == bf16
    assert lse.shape == (B, Hq, S) and lse.dtype == torch.float32
    assert rk.peak - base == _alloc(out.numel() * 2) + _alloc(lse.numel() * 4)
    assert counts.calls == {"flash_attention_fwd": 1} and _launch_counts() == before
    pairs = flash_ops.unmasked_pairs(S, S, True, window)
    assert counts.flops["flash_attention_fwd"] == 2 * B * Hq * (dh + dv) * pairs


@pytest.mark.parametrize("B,Hq,Hkv,dh,dv,window", [
    (6, 32, 4, 64, 64, None),  # TinyLlama train_4k at its cut
    (2, 8, 4, 256, 256, 1024),  # gemma3-4b at its cut (remat full), a local layer
    (2, 8, 4, 256, 256, None),  # and a global one
    (1, 32, 32, 128, 128, None),  # deepseek-7b at its cut
    (1, 16, 16, 128, 128, None),  # qwen2-moe-a2.7b at its cut
    (1, 128, 128, 192, 128, None),  # deepseek-v2-236b's MLA (wgmma 3x2)
], ids=["tinyllama", "gemma3-local", "gemma3-global", "deepseek-7b", "qwen2-moe",
        "deepseek-v2-mla"])
def test_flash_backward_at_train_4k_on_meta(B, Hq, Hkv, dh, dv, window):
    """The flash backward at S 4,096 on meta: dq, dk and dv in the inputs'
    shapes and dtype (dv ``dv`` wide), and the card path's allocations
    (those three and the wgmma backward's fp32 D scratch, [B, Hq, S]); the
    grids inside the kernels' 65,535 (the dQ kernel's row blocks, the dK/dV
    kernel's key blocks); the FLOPs of the pairs the mask keeps; no
    launch."""
    S, bf16 = 4096, torch.bfloat16
    G = Hq // Hkv
    assert flash_ops.variant(bf16, dh, G, dv) == "wgmma"
    wg = flash_ops.VARIANTS.index("wgmma")
    scratch = flash_ops.work_floats(B, S, S, Hq, Hkv, dh, 1, window or 0, wg, True, dv=dv)
    assert scratch == B * Hq * S
    assert -(-(S * G) // 64) <= 65_535 and -(-S // 64) <= 65_535
    before = _launch_counts()
    rk = dryrun.Reckoner()
    with rk, meta.counting() as counts:
        q = torch.empty(B, S, Hq, dh, dtype=bf16, device=M)
        k = torch.empty(B, S, Hkv, dh, dtype=bf16, device=M)
        v = torch.empty(B, S, Hkv, dv, dtype=bf16, device=M)
        out = torch.empty(B, S, Hq, dv, dtype=bf16, device=M)
        dout = torch.empty_like(out)
        lse = torch.empty(B, Hq, S, dtype=torch.float32, device=M)
        base = rk.live
        dq, dk, dv_ = flash_ops.flash_attention_bwd(q, k, v, out, lse, dout, causal=True,
                                                    window=window)
    assert _sig([dq, dk, dv_]) == _sig([q, k, v])
    assert rk.peak - base == (_alloc(q.numel() * 2) + _alloc(k.numel() * 2)
                              + _alloc(v.numel() * 2) + _alloc(scratch * 4))
    assert counts.calls == {"flash_attention_bwd": 1} and _launch_counts() == before
    pairs = flash_ops.unmasked_pairs(S, S, True, window)
    assert counts.flops["flash_attention_bwd"] == 4 * B * Hq * (dh + dv) * pairs
