"""The bf16 flash backward's arithmetic where the scores spread, on the CPU.

Queries drawn at 4 times the keys' scale (as the card's train-cell checks
draw them, ``chip_smoke.py``'s LM_KEY_SPREAD) make the softmax pick a few
keys, and every key's dK sums many large terms that cancel.  The emulation
of the bf16 kernels in ``kernels/flash_attention/ref.py`` (D = rowsum(P *
dP) summed over the keys in fp32, P^T and dS^T as hi + lo bf16 in dV and dK;
what both ``wgmma`` and ``wgmma_rows`` compute, tile by tile) is held
against the reference package's ``attention_ref`` and its ``jax.vjp`` in
fp32 on the same bf16 values at the card tests' tolerance (2e-2 absolute
and relative), at TinyLlama-1.1B's heads (G 8, dh 64), deepseek-7b's (G 1,
dh 128) and gemma3-4b's local layers (G 2, dh 256, a window); and the
single-rounding arithmetic (P^T and dS^T rounded once to bf16, D from the
bf16 output) must miss that tolerance there: on the card it missed by 4.5
to 4.7 times on dK at S 2,048 and 4,096 alike, as the library's bf16
backward does.  The emulation takes, as the kernels do, the fused kernels'
order of dQ's sums where they run (keys and values of one or two equal
64-column chunks: each key block's bf16(dS) . K summed in fp32 into its row
tile in increasing key order), and the dQ kernel's walk elsewhere; it is
held at three more shapes, deepseek-v2's keys of 192 beside values of 128
(the (3, 2) instantiation), a group of 3 (``wgmma_rows``) and gemma3-4b's
dh 256 at a group of 3 and no window (the dQ and dK/dV kernels).  The kernels
themselves run only on the card (``tests/test_torch_kernels_cuda.py``,
``-k 4096``)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from test_torch_flash_rows import _reference, _worst  # noqa: E402

from repro_torch.kernels.flash_attention import ref  # noqa: E402

SPREAD = 4.0
# (B, S, Hq, Hkv, dh, causal, window[, dv])
CASES = [
    (1, 512, 32, 4, 64, True, None),
    (1, 512, 4, 4, 128, True, None),
    (1, 384, 4, 2, 256, True, 64),
]
IDS = ["tinyllama-heads", "deepseek-7b-heads", "gemma3-local-heads"]
# keys of 192 beside values of 128 (MLA, the (3, 2) instantiation), G 3
# (wgmma_rows, the fused kernels at dh 64) and G 3 at dh 256 (four chunks)
MORE_CASES = [
    (1, 320, 4, 4, 192, True, None, 128),
    (1, 300, 6, 2, 64, True, None),
    (1, 320, 6, 2, 256, True, None),
]
MORE_IDS = ["deepseek-v2-mla-heads", "g3-heads", "dh256-g3-global-heads"]


def _inputs(case):
    """q at SPREAD, k, v and dout unit normal (v and dout dv wide), as bf16
    from numpy."""
    B, S, Hq, Hkv, dh = case[:5]
    dv = case[7] if len(case) > 7 else dh
    rng = np.random.default_rng(sum(case[:5]))
    shapes = [(B, S, Hq, dh), (B, S, Hkv, dh), (B, S, Hkv, dv), (B, S, Hq, dv)]
    q, k, v, dout = (rng.normal(size=s).astype(np.float32) for s in shapes)
    return [torch.from_numpy(x).bfloat16() for x in (q * SPREAD, k, v, dout)]


def _padded_reference(case, q, k, v, dout):
    """The reference at values as wide as the keys (v and dout zero past dv,
    which leaves the first dv columns of out and dv and all of dq and dk as
    they are), cut back to dv."""
    dh, dv = q.shape[-1], v.shape[-1]
    pad = lambda x: torch.nn.functional.pad(x, (0, dh - dv))
    want_out, want = _reference(case[:7], q, k, pad(v), pad(dout))
    return want_out[..., :dv], [want[0], want[1], want[2][..., :dv]]


def _grads(case, single_rounding: bool):
    causal, window = case[5:7]
    q, k, v, dout = _inputs(case)
    want_out, want = _padded_reference(case, q, k, v, dout)
    out, lse = ref.attention_rows_fwd(q, k, v, causal=causal, window=window)
    got = ref.attention_rows_bwd(q, k, v, out, lse, dout, causal=causal, window=window,
                                 single_rounding=single_rounding)
    return _worst(out, want_out), [_worst(g, w) for g, w in zip(got, want)]


@pytest.mark.parametrize("case", CASES + MORE_CASES, ids=IDS + MORE_IDS)
def test_kernel_arithmetic_holds_the_tolerance_at_spread_scores(case):
    out, grads = _grads(case, single_rounding=False)
    assert out <= 1.0 and max(grads) <= 1.0, (out, grads)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_one_bf16_rounding_misses_the_tolerance_at_spread_scores(case):
    _, grads = _grads(case, single_rounding=True)
    assert max(grads) > 1.0, grads
