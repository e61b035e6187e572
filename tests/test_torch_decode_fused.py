"""The decode step's fused attention call (write the new K/V row, then
attend) on the CPU: ``decode_attention_insert`` against the reference's two
``insert_kv`` calls and ``decode_attention``, which variant of the kernel
takes a call, and the fused variant's static plan.  The kernel itself runs
only on the card (``tests/test_torch_kernels_cuda.py``)."""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp

from repro.models import attention as jax_attn
from repro_torch.kernels.decode_attention import ops
from repro_torch.models import attention

TOLS = {"float32": 2e-5, "bfloat16": 2e-2}  # as tests/test_kernels.py
TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _pair(a: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    j = jnp.asarray(a, dtype)
    t = torch.from_numpy(np.array(j, np.float32)).to(TORCH_DTYPE[dtype])
    return j, t


def _as_torch(a, dtype: str) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32)).to(TORCH_DTYPE[dtype])


@pytest.mark.parametrize("G", [1, 4, 8])
@pytest.mark.parametrize("dh", [8, 64])
@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("window", [None, 6])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_insert_then_attend_matches_reference(G, dh, B, window, dtype):
    Hkv, T = 2, 40
    Hq = G * Hkv
    rng = np.random.default_rng(G * 100 + dh + B)
    q_start = np.array([0, 17, 39][:B] if B == 3 else [23], np.int32)  # distinct per sequence
    # a written prefix and a zeroed tail, as the engine guarantees
    base = rng.normal(size=(2, B, T, Hkv, dh))
    base[:, np.arange(T)[None, :] >= q_start[:, None]] = 0.0
    kc_j, kc_t = _pair(base[0], dtype)
    vc_j, vc_t = _pair(base[1], dtype)
    q_j, q_t = _pair(rng.normal(size=(B, 1, Hq, dh)), dtype)
    kn_j, kn_t = _pair(rng.normal(size=(B, 1, Hkv, dh)), dtype)
    vn_j, vn_t = _pair(rng.normal(size=(B, 1, Hkv, dh)), dtype)
    qs_j = jnp.asarray(q_start)

    k_want = jax_attn.insert_kv(kc_j, kn_j, qs_j)
    v_want = jax_attn.insert_kv(vc_j, vn_j, qs_j)
    want = jax_attn.decode_attention(q_j, k_want, v_want, qs_j, window=window)

    k_got, v_got = kc_t.clone(), vc_t.clone()
    got = ops.decode_attention_insert(
        q_t, kn_t, vn_t, k_got, v_got, torch.from_numpy(q_start), window=window)
    assert got.dtype == TORCH_DTYPE[dtype] and got.shape == (B, 1, Hq, dh)
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want, np.float32), atol=TOLS[dtype], rtol=TOLS[dtype])
    # the caches were written in place, bit for bit as the reference's
    assert torch.equal(k_got, _as_torch(k_want, dtype))
    assert torch.equal(v_got, _as_torch(v_want, dtype))


def test_plain_version_is_the_two_inserts_then_attention():
    rng = np.random.default_rng(5)
    B, T, Hq, Hkv, dh = 2, 16, 8, 2, 8
    q = torch.from_numpy(rng.normal(size=(B, 1, Hq, dh)).astype(np.float32))
    kn = torch.from_numpy(rng.normal(size=(B, 1, Hkv, dh)).astype(np.float32))
    vn = torch.from_numpy(rng.normal(size=(B, 1, Hkv, dh)).astype(np.float32))
    kc = torch.from_numpy(rng.normal(size=(B, T, Hkv, dh)).astype(np.float32))
    vc = torch.from_numpy(rng.normal(size=(B, T, Hkv, dh)).astype(np.float32))
    qs = torch.tensor([3, 15], dtype=torch.int32)
    k1, v1, k2, v2 = kc.clone(), vc.clone(), kc.clone(), vc.clone()
    got = attention.decode_attention_insert(q, kn, vn, k1, v1, qs, window=4)
    attention.insert_kv(k2, kn, qs)
    attention.insert_kv(v2, vn, qs)
    want = attention.decode_attention(q, k2, v2, qs, window=4)
    assert torch.equal(got, want)
    assert torch.equal(k1, k2) and torch.equal(v1, v2)


def test_wrapper_takes_the_plain_version_on_the_cpu():
    ops.reset_launches()
    rng = np.random.default_rng(7)
    q = torch.from_numpy(rng.normal(size=(1, 1, 4, 8)).astype(np.float32))
    kn = torch.from_numpy(rng.normal(size=(1, 1, 2, 8)).astype(np.float32))
    kc = torch.zeros(1, 12, 2, 8)
    qs = torch.tensor([5], dtype=torch.int32)
    k1, v1, k2, v2 = kc.clone(), kc.clone(), kc.clone(), kc.clone()
    got = ops.decode_attention_insert(q, kn, kn, k1, v1, qs)
    want = attention.decode_attention_insert(q, kn, kn, k2, v2, qs)
    assert torch.equal(got, want) and torch.equal(k1, k2) and torch.equal(v1, v2)
    assert ops.decode_attention.launches_by_variant == {"split": 0, "fused": 0, "chunk": 0}


def test_wrapper_rejects_other_devices():
    q = torch.empty(1, 1, 4, 8, device="meta")
    kv = torch.empty(1, 1, 2, 8, device="meta")
    cache = torch.empty(1, 16, 2, 8, device="meta")
    qs = torch.zeros(1, dtype=torch.int32, device="meta")
    # meta is the dry-run's shape-only path: an output of q's shape, no launch
    assert ops.decode_attention_insert(q, kv, kv, cache, cache, qs).shape == q.shape
    # any device but cpu, cuda and meta is refused before any work
    other = types.SimpleNamespace(device=torch.device("xpu", 0))
    with pytest.raises(ValueError, match="device"):
        ops.decode_attention_insert(other, kv, kv, cache, cache, qs)


@pytest.mark.parametrize("G", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("dh", [8, 64, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_one_row_per_sequence_takes_the_fused_kernel(G, dh, dtype):
    assert ops.variant(1, G, dh, dtype) == "fused"


# the variant each (S, G) takes in bf16 at dh 64: a chunk whose group divides
# 64 takes the chunk kernel, wide groups at S = 1 the split kernel
BF16_VARIANT = {(2, 1): "chunk", (16, 4): "chunk", (64, 8): "chunk", (1, 17): "split",
                (1, 32): "split", (5, 64): "chunk"}


@pytest.mark.parametrize("S, G", [(2, 1), (16, 4), (64, 8), (1, 17), (1, 32), (5, 64)])
def test_chunks_and_wide_groups_take_the_split_kernel(S, G):
    """In fp32 every chunk and every wide group takes the split kernel; in
    bf16 a chunk takes the chunk kernel and a wide group at S = 1 still the
    split kernel."""
    assert ops.variant(S, G, 64, torch.bfloat16) == BF16_VARIANT[(S, G)]
    assert ops.variant(S, G, 64, torch.float32) == "split"


@pytest.mark.parametrize("dh", [0, 12, 100, 264])
def test_head_dims_no_kernel_takes_raise(dh):
    with pytest.raises(ValueError, match="head dim"):
        ops.variant(1, 8, dh, torch.bfloat16)


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64, torch.int32])
def test_other_dtypes_raise(dtype):
    with pytest.raises(TypeError, match="fp32 or bf16"):
        ops.variant(1, 8, 64, dtype)


@pytest.mark.parametrize("S, G", [(0, 8), (1, 0), (-1, 4)])
def test_empty_shapes_raise(S, G):
    with pytest.raises(ValueError, match="positive"):
        ops.variant(S, G, 64, torch.bfloat16)


@pytest.mark.parametrize("dh", range(8, 257, 8))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
def test_fused_plan_covers_every_cache_length(dh, dtype):
    """For every head dim the fused variant takes, from T = 1 to 4096 and at
    the serve cells' T, at B 1 and B 98: a key tile the kernel takes (bf16:
    64 up to dh 128, else 32; fp32: 16, 32, 64 or 128 keys, at most 16 KB of
    K, the largest that fits); whole clusters of at most 8 blocks; no more
    splits than fill every SM once (but one) nor than the keys hold tiles of
    64; past one cluster, clusters of 8 or 2 and at least 1,024 keys a
    split; and the splits of the
    live-length partition cover every visible key once."""
    assert ops.variant(1, 8, dh, dtype) == "fused"
    itemsize = torch.finfo(dtype).bits // 8
    for B in (1, 98):
        for T in [*range(1, 4097), 32_768, 524_288]:
            tk, n_splits, cluster = ops.plan_fused(B, 4, T, dh, dtype, 132)
            if dtype == torch.bfloat16:
                assert tk == (64 if dh <= 128 else 32)
            else:
                assert tk in (16, 32, 64, 128) and tk * dh * itemsize <= 16384
                assert tk == 128 or 2 * tk * dh * itemsize > 16384
            assert 1 <= cluster <= 8 and n_splits % cluster == 0
            assert n_splits == 1 or n_splits * B * 4 <= 132 * ops.fused_blocks_per_sm(dh, dtype)
            assert n_splits <= -(-T // 64)
            if n_splits > cluster:  # clusters of 8, or of 2 at fewer than 4 blocks an SM
                assert cluster == (8 if ops.fused_blocks_per_sm(dh, dtype) >= 4 else 2)
                assert n_splits * 1024 <= T
            if T % 997 == 0 or T > 4096:  # the partition at a sample of lengths
                for q_start in (0, T // 3, T - 1):
                    ranges = ops.fused_partition(q_start, T, None, n_splits, tk)
                    keys = [t for a, b in ranges for t in range(a, b + 1)]
                    assert keys == list(range(q_start + 1))


def test_fused_plan_at_serving_sizes():
    # the full-width engine's cache (max_len 1024) and the smoke engine's (128)
    assert ops.plan_fused(1, 4, 1024, 64, torch.bfloat16, 132) == (64, 8, 8)
    assert ops.plan_fused(1, 2, 128, 8, torch.float32, 132) == (128, 2, 2)
    # rows that are not a power of two bytes: the tile rounds down to one
    assert ops.plan_fused(1, 4, 1024, 96, torch.bfloat16, 132)[0] == 64  # 192-byte rows
    assert ops.plan_fused(1, 4, 1024, 40, torch.float32, 132)[0] == 64  # 160-byte rows
    assert ops.plan_fused(1, 4, 1024, 136, torch.bfloat16, 132)[0] == 32
