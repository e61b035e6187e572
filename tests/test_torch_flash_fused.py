"""The fused bf16 flash backward's bookkeeping, on the CPU.

The fused kernels (``csrc/flash_attention.cu``, keys and values of one or
two equal 64-column chunks, and MLA's keys of three beside values of two)
add each key block's partial of dQ into its row
tile's fp32 sum in increasing key order: the key block that reaches a tile
first stores, and every later one waits until the tile's counter equals its
ordinal, its key block less ``kv_block_first`` of the tile.  That holds only
if the key blocks whose row walks hold a tile are a run of consecutive
blocks starting at ``kv_block_first``; here the walks (``row_walk``, the
kernels' formulas) are enumerated at causal, windowed and non-causal shapes,
Sq beside Sk, and groups up to 72, and at MLA's 64-key blocks.  The tickets
(``fused_item``) hand out every item once, each key block after the one
before it of its kv head, so that no block waits on an item no running
block holds.  Also the scratch the wrapper sizes for the fused kernels
(``work_floats``: lse and D in the rows' order, the accumulator, the
counters and the ticket) and which pairs of chunk counts take them.  The
kernels run only on the card (``tests/test_torch_kernels_cuda.py``)."""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention import ops, ref  # noqa: E402

# (Sq, Sk, G, causal, window)
WALK_CASES = [
    (300, 300, 8, True, 0), (300, 300, 1, False, 0), (700, 700, 2, True, 128),
    (300, 500, 4, True, 64), (360, 300, 4, True, 64), (70, 70, 72, True, 0),
    (200, 200, 3, False, 17), (150, 150, 5, True, 64), (1000, 1000, 1, True, 300),
]


# MLA's (3, 2) at its 64-key blocks (kv_keys): deepseek-v2's cells' causal
# walks, Sq beside Sk either way, a window, and G 3 (wgmma_rows)
MLA_WALK_CASES = [
    (1024, 1024, 1, True, 0), (4096, 4096, 1, True, 0), (200, 330, 1, True, 0),
    (330, 200, 1, True, 0), (330, 200, 1, False, 0), (257, 257, 1, True, 100),
    (600, 600, 3, True, 64),
]


def _check_walks(case, keys):
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


@pytest.mark.parametrize("keys", [128, 64])
@pytest.mark.parametrize("case", WALK_CASES)
def test_the_key_blocks_of_a_row_tile_start_at_kv_block_first(case, keys):
    _check_walks(case, keys)


@pytest.mark.parametrize("case", MLA_WALK_CASES)
def test_mla_key_blocks_of_a_row_tile_start_at_kv_block_first(case):
    assert ref.kv_keys(ref.column_chunks(192)) == 64
    _check_walks(case, 64)


def test_fused_bwd_takes_one_or_two_equal_chunks_and_mla_3x2():
    widths = (8, 64, 72, 128, 136, 192, 256)
    for dh in widths:
        for dv in widths:
            if dv > dh:
                continue
            dc, dvc = ops.chunks(dh), ops.chunks(dv)
            want = dc == dvc <= 2 or (dc, dvc) == (3, 2)
            assert ops.fused_bwd(dh, dv) == want == ref.fused_bwd(dc, dvc)
    assert ops.fused_bwd(64) and ops.fused_bwd(128) and not ops.fused_bwd(256)
    assert ops.fused_bwd(192, 128) and not ops.fused_bwd(192) and not ops.fused_bwd(256, 128)


# (B*Hkv, key blocks, heads a group): every head key block first (DC 1 and
# 2), deepseek-v2's 128 heads in groups at S 1,024, 4,096 and 32,768, and a
# last group smaller than the rest
TICKET_CASES = [(2, 4, 2), (24, 64, 24), (128, 16, 16), (128, 64, 8), (128, 512, 1), (10, 7, 4)]


@pytest.mark.parametrize("case", TICKET_CASES)
def test_fused_tickets_take_each_item_once_after_its_predecessor(case):
    BH, n_kb, hg = case
    taken = {}
    for t in range(BH * n_kb):
        bh, kb = ref.fused_item(t, BH, n_kb, hg)
        assert 0 <= bh < BH and 0 <= kb < n_kb and (bh, kb) not in taken
        taken[bh, kb] = t
        if kb > 0:  # the key block before, whose adds this one waits for
            assert taken[bh, kb - 1] < t
    assert len(taken) == BH * n_kb
    if hg == BH:  # key block major over every head, as at DC 1 and 2
        assert all(taken[t % BH, t // BH] == t for t in range(BH * n_kb))


def test_fused_heads_per_group_follows_the_l2_budget():
    # deepseek-v2's MLA: 16 heads at S 1,024 (the cap), 8 at 4,096, 1 at 32,768
    for S, want in ((1024, 16), (4096, 8), (32768, 1)):
        assert ref.fused_heads_per_group(1, S, 128, 128, 192, 128) == want
    # every head elsewhere: DC 1 and 2 keep key block major over all of them
    assert ref.fused_heads_per_group(6, 4096, 32, 4, 64, 64) == 24
    assert ref.fused_heads_per_group(1, 4096, 32, 32, 128, 128) == 32


# (B, S, Hq, Hkv, dh, dv): DC 1 and 2 at G 8 and 1 (fused), G 3 (fused, the
# gathered copies too), dh 256 (the dQ and dK/dV kernels) and MLA's (3, 2)
# (fused, three chunks of dQ a row tile)
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
