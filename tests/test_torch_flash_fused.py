"""The fused bf16 flash backward's bookkeeping, on the CPU.

The fused kernels (``csrc/flash_attention.cu``, keys and values of one or
two equal 64-column chunks) add each key block's partial of dQ into its row
tile's fp32 sum in increasing key order: the key block that reaches a tile
first stores, and every later one waits until the tile's counter equals its
ordinal, its key block less ``kv_block_first`` of the tile.  That holds only
if the key blocks whose row walks hold a tile are a run of consecutive
blocks starting at ``kv_block_first``; here the walks (``row_walk``, the
kernels' formulas) are enumerated at causal, windowed and non-causal shapes,
Sq beside Sk, and groups up to 72.  Also the scratch the wrapper sizes for
the fused kernels (``work_floats``: lse and D in the rows' order, the
accumulator, the counters and the ticket) and which pairs of chunk counts take them.  The kernels run only on
the card (``tests/test_torch_kernels_cuda.py``)."""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention import ops, ref  # noqa: E402

# (Sq, Sk, G, causal, window)
WALK_CASES = [
    (300, 300, 8, True, 0), (300, 300, 1, False, 0), (700, 700, 2, True, 128),
    (300, 500, 4, True, 64), (360, 300, 4, True, 64), (70, 70, 72, True, 0),
    (200, 200, 3, False, 17), (150, 150, 5, True, 64), (1000, 1000, 1, True, 300),
]


@pytest.mark.parametrize("keys", [128, 64])
@pytest.mark.parametrize("case", WALK_CASES)
def test_the_key_blocks_of_a_row_tile_start_at_kv_block_first(case, keys):
    Sq, Sk, G, causal, window = case
    walks = [set(ref.row_walk(k0, keys, Sq, Sk, G, causal, window))
             for k0 in range(0, Sk, keys)]
    seen = 0
    for rt0 in range(0, Sq * G, ref.ROWS):
        blocks = [kb for kb, walk in enumerate(walks) if rt0 in walk]
        if not blocks:
            continue
        seen += 1
        assert blocks == list(range(blocks[0], blocks[-1] + 1)), (rt0, blocks)
        assert blocks[0] == ref.kv_block_first(rt0, G, window, keys), (rt0, blocks)
    assert seen > 0


def test_fused_bwd_takes_equal_chunk_counts_of_one_or_two():
    widths = (8, 64, 72, 128, 136, 192, 256)
    for dh in widths:
        for dv in widths:
            if dv > dh:
                continue
            want = ops.chunks(dh) == ops.chunks(dv) <= 2
            assert ops.fused_bwd(dh, dv) == want == ref.fused_bwd(ops.chunks(dh), ops.chunks(dv))
    assert ops.fused_bwd(64) and ops.fused_bwd(128) and not ops.fused_bwd(256)
    assert not ops.fused_bwd(192, 128)


# (B, S, Hq, Hkv, dh, dv): DC 1 and 2 at G 8 and 1 (fused), G 3 (fused, the
# gathered copies too), dh 256 and MLA's (3, 2) (the dQ and dK/dV kernels)
SCRATCH_CASES = [
    (2, 300, 8, 1, 64, 64), (1, 257, 16, 16, 128, 128), (2, 100, 6, 2, 64, 64),
    (1, 300, 8, 4, 256, 256), (1, 200, 4, 4, 192, 128),
]


@pytest.mark.parametrize("case", SCRATCH_CASES)
def test_work_floats_counts_the_fused_scratch(case):
    B, S, Hq, Hkv, dh, dv = case
    G = Hq // Hkv
    var = "wgmma" if 64 % G == 0 else "wgmma_rows"
    n = ops.work_floats(B, S, S, Hq, Hkv, dh, 1, 0, ops.VARIANTS.index(var), True, dv=dv)
    rows = B * Hq * S * (dh + dv) // 2 if var == "wgmma_rows" else 0
    if ops.fused_bwd(dh, dv):  # lse and D by rows, the accumulator, the counters
        tiles = B * Hkv * -(-S * G // 64)
        want = rows + 2 * tiles * 64 + tiles * ops.chunks(dh) * 64 * 64 + -(-(tiles + 1) // 4) * 4
    else:  # delta [B, Hq, S]
        want = rows + -(-B * Hq * S // 4) * 4
    assert n == want
    # the forward keeps no backward scratch
    fwd = ops.work_floats(B, S, S, Hq, Hkv, dh, 1, 0, ops.VARIANTS.index(var), False, dv=dv)
    assert fwd == (B * Hq * S * dh // 2 if var == "wgmma_rows" else 0)
