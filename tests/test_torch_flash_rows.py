"""The bf16 flash kernels over gathered rows (variant ``wgmma_rows``, the
GQA groups that do not divide 64) on the CPU.

``kernels/flash_attention/ref.py`` mirrors in plain torch what those kernels
do: the gather pass's layout of the rows of a kv head (``gather_rows``), the
key tiles and row tiles each block walks, skips and masks (``key_walk``,
``row_walk``, ``tile_invisible``, ``tile_needs_mask``, ``kv_tile_skip``,
``kv_tile_needs_mask``: the formulas of ``csrc/flash_attention.cu``), and
their arithmetic: P rounded to bf16 for P.V; in the backward D = rowsum(P *
dP) summed over the keys in fp32, and P^T and dS^T as hi + lo bf16 in dV and
dK.  Here the walks are checked to reach every visible (row, key) pair and
to mask every tile that holds an invisible one; the emulation, tile by tile
in 64-row tiles, is held against the reference package's ``attention_ref``
and its ``jax.vjp`` at G 3, 5, 72 and 128 at the bf16 tolerance of the card
tests (2e-2 absolute and relative, against fp32 on the same bf16 values);
and the single-rounding arithmetic (P^T and dS^T rounded once, D from the
bf16 output) must miss that tolerance at G 72, where a key's gradient sums
over 5,040 rows.  The kernels themselves run only on the card
(``tests/test_torch_kernels_cuda.py``)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax
import jax.numpy as jnp

from repro.kernels.flash_attention import attention_ref as jax_attention_ref
from repro_torch.kernels.flash_attention import ref

TOL = 2e-2

# (B, S, Hq, Hkv, dh, causal, window): the card tests' G 72 (causal), G 128
# (non-causal) and G 5 (dh 256, windowed) cases; G 3 at dh 24 and at dh 96
# (the dK/dV kernel's columns split at two chunks) with a window; G 5 at dh
# 136, non-causal with a window; G 72 at dh 256 with a window
CASES = [
    (1, 70, 72, 1, 64, True, None),
    (1, 33, 128, 1, 16, False, None),
    (2, 150, 10, 2, 256, True, 64),
    (1, 90, 6, 2, 24, True, None),
    (1, 45, 9, 3, 96, True, 16),
    (1, 77, 15, 3, 136, False, 20),
    (1, 24, 72, 1, 256, True, 8),
]


def _inputs(case, seed):
    """q, k, v and dout as bf16 torch tensors, from numpy."""
    B, S, Hq, Hkv, dh = case[:5]
    rng = np.random.default_rng(seed)
    shapes = [(B, S, Hq, dh), (B, S, Hkv, dh), (B, S, Hkv, dh), (B, S, Hq, dh)]
    return [torch.from_numpy(rng.normal(size=s).astype(np.float32)).bfloat16() for s in shapes]


def _reference(case, q, k, v, dout):
    """out and (dq, dk, dv) of the reference function in fp32 on the same
    bf16 values, through jax.vjp."""
    causal, window = case[5:]
    args = [jnp.asarray(t.float().numpy()) for t in (q, k, v)]
    out, vjp = jax.vjp(
        lambda a, b, c: jax_attention_ref(a, b, c, causal=causal, window=window), *args)
    grads = vjp(jnp.asarray(dout.float().numpy()))
    return np.asarray(out), [np.asarray(g) for g in grads]


def _worst(got, want):
    """max |got - want| / (TOL + TOL |want|): at most 1 within tolerance."""
    got = got.float().numpy()
    return float(np.max(np.abs(got - want) / (TOL + TOL * np.abs(want))))


def test_gather_rows_lays_out_each_kv_head_contiguously():
    x = torch.arange(2 * 5 * 6 * 8, dtype=torch.float32).reshape(2, 5, 6, 8)
    rows = ref.gather_rows(x, 2)  # G 3
    assert rows.shape == (4, 15, 8)
    for b in range(2):
        for kvh in range(2):
            for s in range(5):
                for g in range(3):
                    assert torch.equal(rows[b * 2 + kvh, s * 3 + g], x[b, s, kvh * 3 + g])


def _visible(R, G, Sk, causal, window):
    pos = np.arange(R)[:, None] // G
    key = np.arange(Sk)[None, :]
    ok = np.ones((R, Sk), bool)
    if causal:
        ok &= key <= pos
    if window:
        ok &= key > pos - window
    return ok


def _walk_faults(Sq, G, dh, causal, window):
    """What the three kernels' walks miss: visible (row, key) pairs that no
    tile reaches, and tiles left unmasked that hold an invisible pair; per
    kernel, as counts."""
    Sk, R, w = Sq, Sq * G, window or 0
    dc = ref.column_chunks(dh)
    vis = _visible(R, G, Sk, causal, w)
    faults = {}
    # forward and dQ: blocks of rows, each warpgroup over the block's key walk
    for name, rows, keys in (("fwd", 2 * ref.ROWS, ref.fwd_keys(dc)),
                             ("dq", ref.dq_consumers(dc) * ref.ROWS, ref.ROWS)):
        seen = np.zeros_like(vis)
        unmasked_bad = 0
        for r0 in range(0, R, rows):
            for t0 in ref.key_walk(r0, rows, Sq, Sk, G, causal, w, keys):
                for rw0 in range(r0, min(r0 + rows, R), ref.ROWS):
                    n = min(R, rw0 + ref.ROWS) - rw0
                    lo, hi = rw0 // G, (rw0 + n - 1) // G
                    if ref.tile_invisible(t0, keys, lo, hi, Sk, causal, w):
                        continue
                    seen[rw0:rw0 + n, t0:t0 + keys] = True
                    if not ref.tile_needs_mask(t0, keys, lo, hi, Sk, causal, w):
                        unmasked_bad += int(t0 + keys > Sk or
                                            not vis[rw0:rw0 + n, t0:t0 + keys].all())
        faults[name] = (int((vis & ~seen).sum()), unmasked_bad)
    # dK/dV: blocks of keys, each warpgroup's 64 keys over the block's row walk
    keys = ref.kv_keys(dc)
    seen = np.zeros_like(vis)
    unmasked_bad = 0
    for k0 in range(0, Sk, keys):
        for rt0 in ref.row_walk(k0, keys, Sq, Sk, G, causal, w):
            lo, hi = rt0 // G, (min(R, rt0 + ref.ROWS) - 1) // G
            for kw0 in range(k0, k0 + keys, ref.ROWS):
                if ref.kv_tile_skip(kw0, lo, hi, Sk, causal, w):
                    continue
                seen[rt0:rt0 + ref.ROWS, kw0:kw0 + ref.ROWS] = True
                if not ref.kv_tile_needs_mask(rt0, R, kw0, lo, hi, Sk, causal, w):
                    unmasked_bad += int(not vis[rt0:rt0 + ref.ROWS, kw0:kw0 + ref.ROWS].all())
    faults["dkdv"] = (int((vis & ~seen).sum()), unmasked_bad)
    return faults


@pytest.mark.parametrize("G", [3, 5, 6, 12, 72, 96, 128])
def test_walks_reach_every_visible_pair_and_mask_the_rest(G):
    """Over S 1 to 300 (ragged against the 64-row, 64- and 128-key tiles),
    causal or not, windows of 1 to 200, and dh 64, 128, 136 and 256 (which
    change the tiles): no walk misses a visible pair, and every tile left
    unmasked holds visible pairs only."""
    for S in (1, 2, 63, 65, 130, 300):
        for causal in (True, False):
            for window in (None, 1, 17, 64, 200):
                for dh in (64, 128, 136, 256):
                    faults = _walk_faults(S, G, dh, causal, window)
                    assert all(f == (0, 0) for f in faults.values()), (
                        S, causal, window, dh, faults)


@pytest.mark.parametrize("case", CASES)
def test_rows_emulation_matches_reference(case):
    causal, window = case[5:]
    q, k, v, dout = _inputs(case, sum(case[:5]))
    want_out, want_grads = _reference(case, q, k, v, dout)
    out, lse = ref.attention_rows_fwd(q, k, v, causal=causal, window=window)
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    assert _worst(out, want_out) <= 1.0
    lse_want = ref.attention_lse_ref(q.float(), k.float(), causal=causal, window=window)
    torch.testing.assert_close(lse, lse_want, atol=1e-5, rtol=1e-5)
    grads = ref.attention_rows_bwd(q, k, v, out, lse, dout, causal=causal, window=window)
    for name, got, want in zip(("dq", "dk", "dv"), grads, want_grads):
        assert got.dtype == torch.bfloat16 and got.shape == want.shape, name
        assert _worst(got, want) <= 1.0, name


def test_one_bf16_rounding_misses_the_tolerance_at_G72():
    """What the hi/lo fragments and the summed D buy: at G 72 the
    single-rounding arithmetic (P^T and dS^T rounded once to bf16, D from the
    bf16 output) puts dK and dV past the bf16 tolerance."""
    case = CASES[0]
    causal, window = case[5:]
    q, k, v, dout = _inputs(case, sum(case[:5]))
    _, (_, want_dk, want_dv) = _reference(case, q, k, v, dout)
    out, lse = ref.attention_rows_fwd(q, k, v, causal=causal, window=window)
    _, dk, dv = ref.attention_rows_bwd(q, k, v, out, lse, dout, causal=causal, window=window,
                                       single_rounding=True)
    assert max(_worst(dk, want_dk), _worst(dv, want_dv)) > 1.0
