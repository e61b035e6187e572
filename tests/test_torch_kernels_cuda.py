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
# bf16 kernels pad to 16 (24) or that take their smaller tiles (136)
FLASH_CASES = [
    (4, 2048, 32, 4, 64, True, None),
    (1, 2048, 8, 4, 256, True, 1024),
    (2, 64, 8, 2, 8, True, None),
    (2, 200, 8, 2, 64, False, None),
    (1, 77, 4, 1, 32, True, 16),
    (2, 130, 4, 4, 128, True, None),
    (1, 90, 6, 3, 24, True, None),
    (1, 100, 2, 1, 136, False, 40),
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
    f0, b0 = flash_ops.flash_attention.launches_fwd, flash_ops.flash_attention.launches_bwd
    qg, kg, vg = (t.clone().requires_grad_(True) for t in (q, k, v))
    out = flash_ops.flash_attention(qg, kg, vg, causal=causal, window=window)
    dq, dk, dv = torch.autograd.grad(out, (qg, kg, vg), dout)
    _, lse = flash_ops.flash_attention_fwd(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_ops.flash_attention.launches_fwd == f0 + 2
    assert flash_ops.flash_attention.launches_bwd == b0 + 1
    tol = TOLS[dtype]
    for name, got, ref in zip(("out", "lse", "dq", "dk", "dv"), (out, lse, dq, dk, dv), want):
        assert got.dtype == (torch.float32 if name == "lse" else dtype), name
        torch.testing.assert_close(got.float(), ref, atol=tol, rtol=tol, msg=name)


@pytest.mark.cuda
def test_flash_attention_backward_is_deterministic():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(2)
    q = torch.randn(2, 300, 8, 64, generator=g, device=dev).to(torch.bfloat16)
    k = torch.randn(2, 300, 2, 64, generator=g, device=dev).to(torch.bfloat16)
    v = torch.randn(2, 300, 2, 64, generator=g, device=dev).to(torch.bfloat16)
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
