"""The fused decode kernel's plan and combine on the CPU: ``plan_fused``
sizes the grid from static shapes, ``fused_partition`` gives each split its
keys from the live length as every block computes them on the card, and
``fused_two_level_ref`` (the kernel's arithmetic in plain torch: a partial
per split over that partition, combined in each cluster in rank order, then
across clusters in cluster order) against the reference's
``decode_attention``.  The kernel itself runs only on the card
(``tests/test_torch_kernels_cuda.py``, ``chip_smoke.py``)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp

from repro.models import attention as jax_attn
from repro_torch.kernels.decode_attention import fused_two_level_ref, ops

N_SM = 132  # an H100's SMs, as the wrapper reads them on the card


def _covers_exactly(ranges, q_start, T, window, tk):
    """The ranges, in split order, tile the visible keys with no overlap and
    nothing left over; each starts a whole number of tiles after the first
    visible key.  Returns the visible count and the non-empty splits."""
    lo = max(0, q_start - window + 1) if window else 0
    hi = min(T - 1, q_start)
    nxt, full = lo, 0
    for a, b in ranges:
        if a > b:
            continue
        assert a == nxt and (a - lo) % tk == 0
        nxt, full = b + 1, full + 1
    assert nxt == max(lo, hi + 1)
    return max(0, hi - lo + 1), full


TS = [1, 2, 63, 64, 65, 1000, 1024, 2048, 4096, 32_768, 65_536, 131_072, 524_288]
WINDOWS = [None, 1, 7, 100, 1024, 4096]


@pytest.mark.parametrize("T", TS)
@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("dh,dtype", [(64, torch.bfloat16), (256, torch.bfloat16),
                                      (8, torch.float32), (128, torch.float32)],
                         ids=["bf16-64", "bf16-256", "f32-8", "f32-128"])
def test_partition_tiles_the_visible_keys_exactly(T, window, dh, dtype):
    """At q_start 0, T - 1 and in between, under the plan's splits at B 1
    and B 98 and at 1, 3 and 64 splits: every visible key in exactly one
    split, in order, and no split empty while there are at least as many
    tiles as splits."""
    for B in (1, 98):
        tk, n_plan, _ = ops.plan_fused(B, 4, T, dh, dtype, N_SM, window)
        for n_splits in {n_plan, 1, 3, 64}:
            for q_start in {0, T // 2, T - 1, max(0, T - 2)}:
                ranges = ops.fused_partition(q_start, T, window, n_splits, tk)
                assert len(ranges) == n_splits
                n_vis, full = _covers_exactly(ranges, q_start, T, window, tk)
                n_tiles = -(-n_vis // tk)
                if n_tiles >= n_splits:
                    assert full == n_splits
                else:
                    assert full == n_tiles
                sizes = [-(-(b - a + 1) // tk) for a, b in ranges if a <= b]
                assert max(sizes, default=0) - min(sizes, default=0) <= 1


def test_partition_with_mixed_lengths_in_one_batch():
    """One static plan for the batch; each sequence cuts its own live length
    (the window cuts the long ones), down to a single key."""
    T, window, dh = 131_072, 1024, 64
    tk, n_splits, cluster = ops.plan_fused(4, 4, T, dh, torch.bfloat16, N_SM)
    assert (tk, cluster) == (64, 8) and n_splits > cluster
    for q_start in (10, T // 2, T - 1, 3, 0):
        for w in (None, window):
            ranges = ops.fused_partition(q_start, T, w, n_splits, tk)
            n_vis, full = _covers_exactly(ranges, q_start, T, w, tk)
            assert full == min(n_splits, -(-n_vis // tk))
    # past T nothing more is visible, and a window past T sees nothing
    assert _covers_exactly(ops.fused_partition(T + 5, T, None, 8, tk), T + 5, T, None, tk) == (T, 8)
    assert all(a > b for a, b in ops.fused_partition(T + window, T, window, 8, tk))


@pytest.mark.parametrize("B,Hkv,T,dh,window,want", [
    (1, 4, 1024, 64, None, (64, 8, 8)),  # TinyLlama's decode step: today's eight splits
    (4, 4, 1024, 64, None, (64, 8, 8)),
    (1, 4, 2048, 256, 1024, (32, 8, 8)),  # gemma3-4b's served step
    (1, 32, 1024, 128, None, (64, 8, 8)),  # deepseek-7b's
    (98, 4, 32_768, 64, None, (64, 1, 1)),  # decode_32k: 392 heads fill the card once
    (14, 4, 32_768, 256, None, (32, 4, 4)),  # gemma3-4b decode_32k, a global layer
    (14, 4, 32_768, 256, 1024, (32, 4, 4)),  # and a local one
    (1, 4, 524_288, 256, None, (32, 66, 2)),  # long_500k, a global layer: 33 clusters
    (1, 4, 524_288, 256, 1024, (32, 8, 8)),  # a local layer: the window's keys, one cluster
    (1, 4, 65_536, 64, None, (64, 64, 8)),
    (1, 4, 131_072, 64, None, (64, 128, 8)),
    (1, 2, 128, 8, None, (128, 2, 2)),  # the fp32 smoke engine's cache
], ids=["decode-B1", "decode-B4", "gemma3-served", "deepseek-7b", "decode_32k", "gemma3-B14",
        "gemma3-B14-local", "long_500k", "long_500k-local", "T65536", "T131072", "smoke-f32"])
def test_plan_at_serving_sizes(B, Hkv, T, dh, window, want):
    dtype = torch.float32 if dh == 8 else torch.bfloat16
    assert ops.plan_fused(B, Hkv, T, dh, dtype, N_SM, window) == want


@pytest.mark.parametrize("dh,bps", [(8, 4), (64, 4), (72, 2), (128, 2), (136, 2), (192, 2),
                                    (200, 2), (256, 2)])
def test_blocks_per_sm_from_the_ring(dh, bps):
    """bf16 blocks an SM holds at each ring size (the card checks the same
    numbers against its own occupancy reckoning); fp32 is planned at one."""
    assert ops.fused_blocks_per_sm(dh, torch.bfloat16) == bps
    assert ops.fused_blocks_per_sm(dh, torch.float32) == 1


@pytest.mark.parametrize("B,T,dh,window", [(1, 524_288, 256, None), (14, 32_768, 256, None),
                                           (98, 32_768, 64, None), (1, 65_536, 64, None)])
def test_workspace_only_past_one_cluster(B, T, dh, window):
    tk, n_splits, cluster = ops.plan_fused(B, 4, T, dh, torch.bfloat16, N_SM, window)
    G = 2 if dh == 256 else 8
    n = ops.fused_workspace_floats(B, 4, G, dh, n_splits, cluster)
    if n_splits == cluster:
        assert n == 0
    else:
        assert n == B * 4 * (n_splits // cluster) * (2 * 16 + G * dh)


def _arrays(B, T, Hkv, G, dh, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, 1, Hkv * G, dh)).astype(np.float32) * 3.0  # scores spread
    k = rng.normal(size=(B, T, Hkv, dh)).astype(np.float32)
    v = rng.normal(size=(B, T, Hkv, dh)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("window", [None, 300], ids=["global", "window"])
@pytest.mark.parametrize("G,dh", [(8, 64), (2, 256)])
@pytest.mark.parametrize("n_splits,cluster", [(8, 8), (64, 8), (16, 4), (5, 5)])
def test_two_level_combine_matches_reference(window, G, dh, n_splits, cluster):
    """fp32 at 2e-5 against the reference's decode_attention: partials per
    split over ``fused_partition``'s keys, combined in split order within
    each cluster, then across clusters; B 2 with one short and one long
    sequence."""
    B, T, Hkv = 2, 4096, 2
    tk = ops.fused_tile(dh, torch.bfloat16)
    q, k, v = _arrays(B, T, Hkv, G, dh, seed=G * dh + n_splits)
    q_start = np.array([37, 4000], np.int32)
    want = np.asarray(jax_attn.decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(q_start), window=window))
    ranges = [ops.fused_partition(int(s), T, window, n_splits, tk) for s in q_start]
    got = fused_two_level_ref(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                              ranges, cluster)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)
