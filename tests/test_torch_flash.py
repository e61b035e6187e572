"""The port's full-sequence attention against the reference package, on the
CPU: ``kernels.flash_attention`` (its plain path, the one tensors on the CPU
take) against the Pallas kernel run in interpret mode and against
``attention_ref``; the model functions ``gqa_attention`` and
``chunked_gqa_attention`` against theirs, with a window and ``global_flag``
0/1; and the gradients of all three against ``jax.grad`` of the reference
function on the same cotangent.  The hand kernels run only on the card:
``tests/test_torch_kernels_cuda.py``.

Tolerances: fp32 2e-5 absolute and relative for outputs and gradients (the
same sums, taken in another order); bf16 2e-2 (as ``tests/test_kernels.py``):
the Pallas kernel makes its scores in fp32 where the einsum oracle and the
port's plain path make them in bf16 and then cast, and the bf16 tolerance
covers that difference."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax
import jax.numpy as jnp

from repro.kernels.flash_attention import attention_ref as jax_attention_ref
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro.models import attention as jax_attn
from repro_torch.kernels.flash_attention import attention_lse_ref, attention_ref, flash_attention
from repro_torch.models import attention

TOLS = {"float32": 2e-5, "bfloat16": 2e-2}
TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# tests/test_kernels.py:24-30, the smoke head dim of 8, and gemma3's head
# dim of 256 (four 64-column chunks in the kernels on the card) and 192
# (three), at its group of 2, with a window and without; then groups that do
# not divide 64 (on the card, bf16 takes the wgmma_rows kernels there): G 3,
# G 5 with a window, and G 72, past one 64-row tile
FLASH_CASES = [
    # (B, Sq, Sk, Hq, Hkv, d, causal, window, blk)
    (1, 64, 64, 1, 1, 32, True, None, 32),
    (2, 128, 128, 4, 2, 64, True, None, 64),
    (2, 96, 96, 8, 8, 32, False, None, 32),  # non-multiple of block -> padding
    (1, 256, 256, 4, 1, 64, True, 64, 64),  # MQA + sliding window
    (2, 128, 128, 4, 4, 128, True, None, 128),
    (2, 40, 40, 8, 2, 8, True, None, 16),  # smoke head dim
    (1, 64, 64, 2, 1, 192, True, 16, 32),
    (1, 64, 64, 2, 1, 192, True, None, 32),
    (1, 64, 64, 2, 1, 256, True, 16, 32),
    (1, 64, 64, 2, 1, 256, True, None, 32),
    (1, 40, 40, 6, 2, 24, True, None, 16),
    (2, 30, 30, 10, 2, 32, True, 8, 16),
    (1, 20, 20, 72, 1, 16, True, None, 16),
]


def _pair(a: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    j = jnp.asarray(a, dtype)
    t = torch.from_numpy(np.array(j, np.float32)).to(TORCH_DTYPE[dtype])
    return j, t


def _close(got, want, tol):
    np.testing.assert_allclose(
        got.detach().float().numpy(), np.asarray(want, np.float32), atol=tol, rtol=tol
    )


def _inputs(case, dtype, seed):
    B, Sq, Sk, Hq, Hkv, d = case[:6]
    rng = np.random.default_rng(seed)
    q = _pair(rng.normal(size=(B, Sq, Hq, d)), dtype)
    k = _pair(rng.normal(size=(B, Sk, Hkv, d)), dtype)
    v = _pair(rng.normal(size=(B, Sk, Hkv, d)), dtype)
    return q, k, v


@pytest.mark.parametrize("case", FLASH_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_matches_pallas_and_ref(case, dtype):
    B, Sq, Sk, Hq, Hkv, d, causal, window, blk = case
    (qj, qt), (kj, kt), (vj, vt) = _inputs(case, dtype, sum(case[:6]))
    got = flash_attention(qt, kt, vt, causal=causal, window=window)
    assert got.dtype == TORCH_DTYPE[dtype] and got.shape == (B, Sq, Hq, d)
    pallas = pallas_flash(qj, kj, vj, causal=causal, window=window, block_q=blk,
                          block_k=blk, interpret=True)
    ref = jax_attention_ref(qj, kj, vj, causal=causal, window=window)
    _close(got, pallas, TOLS[dtype])
    _close(got, ref, TOLS[dtype])
    _close(attention_ref(qt, kt, vt, causal=causal, window=window), ref, TOLS[dtype])


def test_lse_ref_is_the_softmax_normaliser():
    """``attention_lse_ref`` (what the kernel saves for its backward)
    recovers the reference's output: softmax = exp(scores - lse)."""
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.normal(size=(2, 33, 4, 16)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(2, 33, 2, 16)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(2, 33, 2, 16)).astype(np.float32))
    lse = attention_lse_ref(q, k, causal=True, window=8)
    assert lse.shape == (2, 4, 33) and lse.dtype == torch.float32
    s = torch.einsum("bshd,bthd->bhst", q, k.repeat_interleave(2, dim=2)) / 4.0
    pos = torch.arange(33)
    mask = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - 8)
    p = torch.exp(s.masked_fill(~mask, float("-inf")) - lse[..., None])
    out = torch.einsum("bhst,bthd->bshd", p, v.repeat_interleave(2, dim=2))
    want = jax_attention_ref(jnp.asarray(q.numpy()), jnp.asarray(k.numpy()),
                             jnp.asarray(v.numpy()), causal=True, window=8)
    _close(out, want, TOLS["float32"])


# (S, window, global_flag, block_q)
MODEL_CASES = [
    (24, None, None, 8),
    (24, 6, 0.0, 8),
    (24, 6, 1.0, 8),
    (30, 5, 0.0, 16),  # S not a multiple of block_q
]


@pytest.mark.parametrize("case", MODEL_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gqa_and_chunked_attention_match_reference(case, dtype):
    S, window, flag, blk = case
    shape = (2, S, S, 8, 2, 16)
    (qj, qt), (kj, kt), (vj, vt) = _inputs(shape, dtype, S + (window or 0))
    jflag = None if flag is None else jnp.float32(flag)
    want = jax_attn.gqa_attention(qj, kj, vj, window=window, global_flag=jflag)
    got = attention.gqa_attention(qt, kt, vt, window=window, global_flag=flag)
    _close(got, want, TOLS[dtype])
    want = jax_attn.chunked_gqa_attention(qj, kj, vj, window=window, global_flag=jflag,
                                          block_q=blk)
    got = attention.chunked_gqa_attention(qt, kt, vt, window=window, global_flag=flag,
                                          block_q=blk)
    _close(got, want, TOLS[dtype])


def test_gqa_attention_q_offset_matches_reference():
    (qj, qt), (kj, kt), (vj, vt) = _inputs((1, 8, 24, 4, 2, 16), "float32", 5)
    want = jax_attn.gqa_attention(qj, kj, vj, window=6, q_offset=16)
    got = attention.gqa_attention(qt, kt, vt, window=6, q_offset=16)
    _close(got, want, TOLS["float32"])


# (name, torch function, jax function)
GRAD_FUNCS = [
    ("flash_attention", lambda q, k, v: flash_attention(q, k, v, causal=True, window=6),
     lambda q, k, v: jax_attention_ref(q, k, v, causal=True, window=6)),
    ("gqa_attention", lambda q, k, v: attention.gqa_attention(q, k, v, window=6,
                                                              global_flag=0.0),
     lambda q, k, v: jax_attn.gqa_attention(q, k, v, window=6, global_flag=jnp.float32(0))),
    ("chunked_gqa_attention",
     lambda q, k, v: attention.chunked_gqa_attention(q, k, v, window=6, global_flag=0.0,
                                                     block_q=8),
     lambda q, k, v: jax_attn.chunked_gqa_attention(q, k, v, window=6,
                                                    global_flag=jnp.float32(0), block_q=8)),
]


@pytest.mark.parametrize("name,tfn,jfn", GRAD_FUNCS, ids=[g[0] for g in GRAD_FUNCS])
def test_attention_gradients_match_jax_grad(name, tfn, jfn):
    (qj, qt), (kj, kt), (vj, vt) = _inputs((2, 21, 21, 8, 2, 16), "float32", 11)
    ct = np.random.default_rng(12).normal(size=(2, 21, 8, 16)).astype(np.float32)
    _, vjp = jax.vjp(jfn, qj, kj, vj)
    want = vjp(jnp.asarray(ct))
    q, k, v = (t.clone().requires_grad_(True) for t in (qt, kt, vt))
    out = tfn(q, k, v)
    got = torch.autograd.grad(out, (q, k, v), torch.from_numpy(ct))
    for g, w in zip(got, want):
        _close(g, w, TOLS["float32"])


@pytest.mark.parametrize("window", [None, 6])
def test_flash_attention_gradients_match_jax_vjp_at_head_dim_256(window):
    """gemma3's head dim, at its group of 2, global and local: the port's
    gradients against ``jax.vjp`` of the reference function."""
    (qj, qt), (kj, kt), (vj, vt) = _inputs((1, 24, 24, 4, 2, 256), "float32", 13)
    ct = np.random.default_rng(14).normal(size=(1, 24, 4, 256)).astype(np.float32)
    _, vjp = jax.vjp(lambda q, k, v: jax_attention_ref(q, k, v, causal=True, window=window),
                     qj, kj, vj)
    want = vjp(jnp.asarray(ct))
    q, k, v = (t.clone().requires_grad_(True) for t in (qt, kt, vt))
    out = flash_attention(q, k, v, causal=True, window=window)
    got = torch.autograd.grad(out, (q, k, v), torch.from_numpy(ct))
    for g, w in zip(got, want):
        _close(g, w, TOLS["float32"])
