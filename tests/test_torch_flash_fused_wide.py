"""The bf16 flash backward at three and four equal 64-column chunks (dh 136
to 256: gemma3-4b's dh 256) on the CPU.

There the backward is not the fused design (``fused_bwd`` is false): the dQ
kernel (``csrc/flash_attention.cu``) walks its 64-key tiles twice, first
summing D = rowsum(P * dP) in fp32 in key order, then adding bf16(dS) . K
into each row's dQ; the dK/dV kernel walks the 64-row tiles of its 64 keys
and adds P^T . dO and dS^T . Q with P^T and dS^T as hi + lo bf16.
``ref.attention_rows_bwd`` emulates that arithmetic tile by tile; here it
is held against the
reference package's ``attention_ref`` and its ``jax.vjp`` in fp32 on the
same bf16 values at the bf16 tolerance of ``tests/test_kernels.py`` (2e-2
absolute and relative), at G 1, 2, 3 and 5 (``wgmma_rows`` where G does not
divide 64), causal or not, windows of 64 and 1,024, and lengths that are
not a multiple of a tile.  The kernels run only on the card
(``tests/test_torch_kernels_cuda.py``)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from test_torch_flash_rows import TOL, _inputs, _reference, _worst  # noqa: E402

from repro_torch.kernels.flash_attention import ops, ref  # noqa: E402

assert TOL == 2e-2

# (B, S, Hq, Hkv, dh, causal, window)
CASES = [
    (1, 150, 2, 2, 256, True, None),     # DC 4, G 1
    (2, 130, 8, 4, 256, False, 64),      # DC 4, G 2, non-causal, window 64
    (1, 1100, 4, 2, 256, True, 1024),    # DC 4, G 2, gemma3-4b's local window
    (1, 77, 6, 2, 256, True, None),      # DC 4, G 3 (wgmma_rows)
    (2, 90, 2, 2, 192, False, None),     # DC 3, G 1
    (1, 200, 15, 3, 192, True, 64),      # DC 3, G 5 (wgmma_rows)
    (1, 99, 5, 1, 136, False, None),     # DC 3 at dh 136, G 5
    (1, 1040, 6, 2, 136, False, 1024),   # DC 3 at dh 136, G 3, non-causal, window 1,024
]
IDS = [f"dh{c[4]}-G{c[2] // c[3]}-S{c[1]}" + ("-causal" if c[5] else "")
       + (f"-w{c[6]}" if c[6] else "") for c in CASES]


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_wide_fused_emulation_matches_reference(case):
    B, S, Hq, Hkv, dh, causal, window = case
    dc = ref.column_chunks(dh)
    assert dc >= 3 and not ref.fused_bwd(dc, dc) and not ops.fused_bwd(dh)
    q, k, v, dout = _inputs(case, sum(case[:5]))
    want_out, want_grads = _reference(case, q, k, v, dout)
    out, lse = ref.attention_rows_fwd(q, k, v, causal=causal, window=window)
    assert _worst(out, want_out) <= 1.0
    grads = ref.attention_rows_bwd(q, k, v, out, lse, dout, causal=causal, window=window)
    for name, got, want in zip(("dq", "dk", "dv"), grads, want_grads):
        assert got.dtype == torch.bfloat16 and got.shape == want.shape, name
        assert _worst(got, want) <= 1.0, name


def test_rows_with_no_visible_key_get_zero_gradients():
    """Queries past the keys under a causal window (Sq 200, Sk 100, window
    64, dh 256, G 2): rows from position 163 on see no key, and their out
    and dq are zeros (their row walks hold no key tile); the rows that see
    keys, and dk and dv, hold against the reference on those rows alone."""
    import numpy as np

    Sq, Sk, Hq, Hkv, dh, window = 200, 100, 2, 1, 256, 64
    seen = Sk - 1 + window  # positions below it see a key
    rng = np.random.default_rng(11)
    shapes = [(1, Sq, Hq, dh), (1, Sk, Hkv, dh), (1, Sk, Hkv, dh), (1, Sq, Hq, dh)]
    q, k, v, dout = (torch.from_numpy(rng.normal(size=s).astype(np.float32)).bfloat16()
                     for s in shapes)
    out, lse = ref.attention_rows_fwd(q, k, v, causal=True, window=window)
    dq, dk, dv = ref.attention_rows_bwd(q, k, v, out, lse, dout, causal=True, window=window)
    assert torch.count_nonzero(out[:, seen:]) == 0 and torch.count_nonzero(dq[:, seen:]) == 0
    case = (1, seen, Hq, Hkv, dh, True, window)
    want_out, want = _reference(case, q[:, :seen], k, v, dout[:, :seen])
    assert _worst(out[:, :seen], want_out) <= 1.0
    for name, got, w in zip(("dq", "dk", "dv"), (dq[:, :seen], dk, dv), want):
        assert _worst(got, w) <= 1.0, name
