"""The arithmetic of the fp32 flash kernels (variant ``tf32x3``) on the CPU:
each fp32 product a.b is taken as a_hi.b_lo + a_lo.b_hi + a_hi.b_hi, with
hi = tf32(x) and lo = tf32(x - hi) rounded to nearest (ties away), and fp32
sums.  ``kernels/flash_attention/ref.py`` emulates that in plain torch; here
attention built on it is held against the reference package's fp32
``attention_ref`` at the fp32 tolerance (2e-5 absolute and relative, as
``tests/test_kernels.py``), and the same attention with one TF32 pass
(a_hi.b_hi alone) must miss that tolerance.  The kernels themselves run
only on the card (``tests/test_torch_kernels_cuda.py``)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp

from repro.kernels.flash_attention import attention_ref as jax_attention_ref
from repro_torch.kernels.flash_attention.ref import (
    attention_tf32x3, einsum_tf32, split_tf32, tf32_round,
)

TOL = 2e-5

# (B, S, Hq, Hkv, dh, causal, window): the smoke shape (dh 8), G 3 at dh 136
# and 256, G 72 (a row tile of 64 heads of one position) at dh 256 with a
# window, and dh 136 at G 72 without the causal mask
CASES = [
    (2, 40, 8, 2, 8, True, None),
    (1, 48, 6, 2, 136, True, None),
    (1, 33, 3, 1, 256, False, None),
    (1, 24, 72, 1, 256, True, 16),
    (1, 20, 72, 1, 136, False, None),
]


def _inputs(case):
    B, S, Hq, Hkv, dh = case[:5]
    rng = np.random.default_rng(sum(case[:5]))
    return [rng.normal(size=(B, S, h, dh)).astype(np.float32) for h in (Hq, Hkv, Hkv)]


def _reference(case, q, k, v):
    causal, window = case[5:]
    out = jax_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                            window=window)
    return np.asarray(out, np.float32)


@pytest.mark.parametrize("case", CASES)
def test_three_tf32_passes_hold_the_fp32_tolerance(case):
    q, k, v = _inputs(case)
    got = attention_tf32x3(*(torch.from_numpy(x) for x in (q, k, v)), causal=case[5],
                           window=case[6])
    np.testing.assert_allclose(got.numpy(), _reference(case, q, k, v), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("case", CASES)
def test_one_tf32_pass_misses_the_fp32_tolerance(case):
    """What the tolerance sees: TF32 alone rounds the inputs to 11 bits."""
    q, k, v = _inputs(case)
    got = attention_tf32x3(*(torch.from_numpy(x) for x in (q, k, v)), causal=case[5],
                           window=case[6], passes=1)
    assert not np.allclose(got.numpy(), _reference(case, q, k, v), atol=TOL, rtol=TOL)


def test_tf32_round_is_to_nearest_with_ties_away():
    one = 1.0
    x = torch.tensor([one + 2**-11, one + 2**-12, -(one + 2**-11), one + 3 * 2**-12,
                      one - 2**-12, 0.0, 3.0 * 2**-100])
    want = torch.tensor([one + 2**-10, one, -(one + 2**-10), one + 2**-10, one, 0.0,
                         3.0 * 2**-100])
    assert torch.equal(tf32_round(x), want)


def test_split_keeps_22_bits_and_tf32_values():
    x = torch.from_numpy(np.random.default_rng(0).normal(size=4096).astype(np.float32))
    hi, lo = split_tf32(x)
    for part in (hi, lo):
        assert torch.all(part.view(torch.int32) & 0x1FFF == 0)
    assert torch.all((x.double() - hi.double() - lo.double()).abs() <= 2.0**-22 * x.double().abs())


def test_three_passes_hold_a_long_product_to_fp32_precision():
    """A dot product over 256 (gemma3's head dim): three passes keep the
    error near fp32's, one pass near 2^-11 of the terms."""
    rng = np.random.default_rng(1)
    a = torch.from_numpy(rng.normal(size=(64, 256)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(64, 256)).astype(np.float32))
    exact = a.double() @ b.double().T
    scale = (a.double().abs() @ b.double().abs().T)
    err3 = ((einsum_tf32("md,nd->mn", a, b).double() - exact).abs() / scale).max().item()
    err1 = ((einsum_tf32("md,nd->mn", a, b, passes=1).double() - exact).abs() / scale).max().item()
    assert err3 < 2e-7 < 1e-5 < err1
