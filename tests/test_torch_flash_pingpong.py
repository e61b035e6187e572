"""The bf16 flash forward at one and two 64-column chunks (dh up to 128) as
the ping-pong kernel computes it, on the CPU.

``flash_fwd_pp_wgmma_kernel`` (``csrc/flash_attention.cu``) takes every bf16
forward whose values fit two chunks: (1, 1), (2, 2) and MLA's (3, 2).  Its
consumer warpgroups issue a tile's S beside the last tile's P.V, so O takes
the last tile's P.V and is then rescaled to this tile's maximum, where the
earlier kernel rescaled first (the same roundings, step for step: see
the last test).  ``ref.attention_rows_fwd`` follows that order wherever
``ref.fwd_pingpong`` says the kernel runs.  Here its output
and lse, at dh 64 and 128, GQA groups 1, 4, 8 and 72, ragged S, causal or
not, with and without a window, are held against the reference package's
``attention_ref`` (fp32 on the same bf16 values) and its Pallas kernel in
interpret mode (bf16), as ``tests/test_torch_flash.py`` runs them.

Tolerance: the bf16 one of ``tests/test_kernels.py`` (2e-2 absolute and
relative): P is rounded to bf16 for P.V, as the Pallas kernel does; lse,
which the kernel keeps in fp32, is held at 1e-5 against the port's
``attention_lse_ref``.  The kernel itself runs only on the card
(``tests/test_torch_kernels_cuda.py``, ``chip_smoke.py``)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp

from repro.kernels.flash_attention import attention_ref as jax_attention_ref
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro_torch.kernels.flash_attention import ops, ref

TOL = 2e-2

# (B, S, Hq, Hkv, dh, causal, window): S ragged against the 64-row and
# 128-key tiles; G 1, 4, 8 (wgmma) and 72 (wgmma_rows) at dh 64 (DC 1) and
# dh 128 (DC 2); dh 96 and 40 pad to their chunk
CASES = [
    (1, 200, 8, 1, 64, True, None),
    (2, 130, 4, 1, 64, False, None),
    (1, 150, 2, 2, 64, True, 32),
    (1, 70, 72, 1, 64, True, None),
    (1, 45, 72, 1, 64, False, 20),
    (1, 257, 8, 2, 128, True, 100),
    (1, 190, 1, 1, 128, False, 50),
    (2, 99, 16, 2, 128, True, None),
    (1, 40, 72, 1, 128, False, 16),
    (1, 140, 4, 1, 128, False, None),
    (1, 133, 12, 3, 96, True, 64),
    (1, 66, 8, 1, 40, True, None),
]
IDS = ["S{1}-G{0}-dh{2}-{3}{4}".format(c[2] // c[3], c[1], c[4], "causal" if c[5] else "full",
                                       f"-w{c[6]}" if c[6] else "") for c in CASES]


def _inputs(case, seed):
    """q, k and v as bf16 torch tensors and the same values as JAX bf16 arrays."""
    B, S, Hq, Hkv, dh = case[:5]
    rng = np.random.default_rng(seed)
    shapes = [(B, S, Hq, dh), (B, S, Hkv, dh), (B, S, Hkv, dh)]
    arrays = [jnp.asarray(rng.normal(size=s), "bfloat16") for s in shapes]
    return [torch.from_numpy(np.array(a, np.float32)).bfloat16() for a in arrays], arrays


def _worst(got, want):
    """max |got - want| / (TOL + TOL |want|): at most 1 within tolerance."""
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    return float(np.max(np.abs(got - want) / (TOL + TOL * np.abs(want))))


@pytest.mark.parametrize("dh,dv,pp", [(64, 64, True), (128, 128, True), (192, 128, True),
                                      (24, 16, True), (192, 192, False), (256, 256, False)])
def test_pingpong_takes_every_forward_whose_values_fit_two_chunks(dh, dv, pp):
    """The kernel's fwd_pingpong: values of one or two chunks, at every pair
    an instantiation takes."""
    dc, dvc = ref.column_chunks(dh), ref.column_chunks(dv)
    assert (dc, dvc) in ops.PAIRS
    assert ref.fwd_pingpong(dvc) is pp
    assert ref.fwd_keys(dvc) == (128 if pp else 64)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_pingpong_emulation_matches_reference_and_pallas(case):
    B, S, Hq, Hkv, dh, causal, window = case
    (q, k, v), (qj, kj, vj) = _inputs(case, sum(case[:5]))
    assert ref.fwd_pingpong(ref.column_chunks(dh))
    out, lse = ref.attention_rows_fwd(q, k, v, causal=causal, window=window)
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    want = jax_attention_ref(*(a.astype(jnp.float32) for a in (qj, kj, vj)), causal=causal,
                             window=window)
    assert _worst(out, want) <= 1.0
    blk = 64 if S >= 64 else 16
    pallas = pallas_flash(qj, kj, vj, causal=causal, window=window, block_q=blk, block_k=blk,
                          interpret=True)
    assert _worst(out, pallas) <= 1.0
    lse_want = ref.attention_lse_ref(q.float(), k.float(), causal=causal, window=window)
    torch.testing.assert_close(lse, lse_want, atol=1e-5, rtol=1e-5)


def test_pingpong_defers_pv_without_changing_the_sums():
    """Deferring a tile's P.V to the next turn changes no rounding: the
    ping-pong's O before the rescale, B_t = fl(fl(B_(t-1) alpha_t) + PV_t),
    follows the earlier kernel's recurrence step for step.  The emulation
    in both orders gives equal bits, the fp32 residual below the bf16
    output included, within TOL of the reference."""
    case = (1, 300, 8, 1, 64, True, None)
    (q, k, v), (qj, kj, vj) = _inputs(case, 5)
    pp = ref.attention_rows_fwd(q, k, v, causal=True, residual=True)
    old = ref.fwd_pingpong
    try:
        ref.fwd_pingpong = lambda dvc: False
        first = ref.attention_rows_fwd(q, k, v, causal=True, residual=True)
    finally:
        ref.fwd_pingpong = old
    want = jax_attention_ref(*(a.astype(jnp.float32) for a in (qj, kj, vj)), causal=True)
    assert all(torch.equal(a, b) for a, b in zip(pp, first))
    assert _worst(pp[0], want) <= 1.0


def _visible(R, G, Sk, causal, window):
    pos = np.arange(R)[:, None] // G
    key = np.arange(Sk)[None, :]
    ok = np.ones((R, Sk), bool)
    if causal:
        ok &= key <= pos
    if window:
        ok &= key > pos - window
    return ok


@pytest.mark.parametrize("most", [True, False], ids=["most", "two"])
@pytest.mark.parametrize("dh", [64, 40, 128])
@pytest.mark.parametrize("G", [1, 3, 8, 72])
def test_pingpong_walks_reach_every_visible_pair_and_mask_the_rest(dh, G, most):
    """The ping-pong blocks (``pp_consumers`` warpgroups of 64 rows, or two,
    over 128-key tiles): over S 1 to 400, causal or not, windows of 1 to
    300, no visible (row, key) pair is missed, and a tile left unmasked holds
    visible pairs only."""
    dc = ref.column_chunks(dh)
    rows, keys = (ref.pp_consumers(dc) if most else 2) * ref.ROWS, ref.fwd_keys(dc)
    for S in (1, 63, 130, 257, 400):
        for causal in (True, False):
            for window in (None, 1, 100, 300):
                R, w = S * G, window or 0
                vis = _visible(R, G, S, causal, w)
                seen = np.zeros_like(vis)
                for r0 in range(0, R, rows):
                    for t0 in ref.key_walk(r0, rows, S, S, G, causal, w, keys):
                        for rw0 in range(r0, min(r0 + rows, R), ref.ROWS):
                            n = min(R, rw0 + ref.ROWS) - rw0
                            lo, hi = rw0 // G, (rw0 + n - 1) // G
                            if ref.tile_invisible(t0, keys, lo, hi, S, causal, w):
                                continue
                            seen[rw0:rw0 + n, t0:t0 + keys] = True
                            if not ref.tile_needs_mask(t0, keys, lo, hi, S, causal, w):
                                assert t0 + keys <= S and vis[rw0:rw0 + n, t0:t0 + keys].all()
                assert not (vis & ~seen).any(), (S, causal, window)


@pytest.mark.parametrize("n_rt,bh,hg", [(16, 16, 16), (2048, 40, 1), (7, 5, 2), (3, 4, 3)])
@pytest.mark.parametrize("causal", [True, False])
def test_pingpong_grid_takes_every_block_once_heads_in_groups(n_rt, bh, hg, causal):
    """``pp_block`` in the order the blocks start: every (row tile, kv head)
    once, the last group's blocks past the heads empty; the heads in groups
    of hg, one group after another; within a group the tiles in order, under
    causal the heaviest (last) first."""
    n = hg * n_rt * -(-bh // hg)
    blocks = [ref.pp_block(i, n_rt, bh, hg, causal) for i in range(n)]
    seen = [b for b in blocks if b is not None]
    assert sorted(seen) == [(t, h) for t in range(n_rt) for h in range(bh)]
    assert len(blocks) - len(seen) == n_rt * (-bh % hg)
    for i in range(1, len(seen)):
        (t0, h0), (t1, h1) = seen[i - 1], seen[i]
        assert h1 // hg >= h0 // hg  # groups in order
        if h1 // hg == h0 // hg:  # within a group: tile major, heaviest first
            assert (t1 <= t0) if causal else (t1 >= t0)


def test_pingpong_takes_three_consumers_at_one_chunk_where_their_grid_fills_the_card():
    """192-row blocks at one column chunk where they give every SM of the
    H100 a block (TinyLlama's prefill_32k, train_4k and train shape), two
    warpgroups for short calls and at two chunks."""
    nc = ref.pp_launch_consumers
    assert nc(1, 10, 32768, 8, 4) == nc(1, 6, 4096, 8, 4) == nc(1, 4, 2048, 8, 4) == 3
    assert nc(1, 1, 70, 72, 1) == nc(1, 2, 64, 4, 2) == nc(1, 2, 200, 4, 2) == 2
    assert nc(2, 1, 32768, 1, 32) == nc(3, 1, 32768, 1, 128) == 2
    assert nc(1, 1, 3145, 8, 1) == 3 and nc(1, 1, 3144, 8, 1) == 2  # 132 and 131 blocks


def test_pingpong_groups_keep_their_k_and_v_within_the_bytes():
    """At the cells' shapes: one kv head a group at the prefill_32k cells
    (TinyLlama's 8 MiB of K and V a head, deepseek-7b's 16, MLA's 20), 8 to
    16 heads of the short calls (0.5 to 1 MiB a head), three of MLA's at S
    4,096 (2.5 MiB a head)."""
    hpg = ref.pp_heads_per_group
    assert ref.PP_GROUP_BYTES == 8 << 20
    assert hpg(10, 32768, 4, 1, 1) == 1
    assert hpg(1, 32768, 32, 2, 2) == 1
    assert hpg(1, 32768, 128, 3, 2) == 1
    assert hpg(1, 2048, 16, 2, 2) == 8
    assert hpg(4, 2048, 4, 1, 1) == 16
    assert hpg(6, 4096, 4, 1, 1) == 8
    assert hpg(1, 4096, 128, 3, 2) == 3
    assert hpg(1, 10, 1, 1, 1, group_bytes=0) == 1
