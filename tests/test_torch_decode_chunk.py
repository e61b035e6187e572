"""A prefill chunk's attention call (write the chunk's K/V rows, then
attend) on the CPU: ``decode_attention_chunk`` against the reference's two
``insert_chunk`` calls and ``decode_attention``, which variant of the kernel
takes a call, and ``prefill_chunk`` through the new call against the
reference's logits.  The chunk kernel itself runs only on the card
(``tests/test_torch_kernels_cuda.py``)."""
import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax
import jax.numpy as jnp

from repro.configs import get_config as jax_config
from repro.models import attention as jax_attn
from repro.models import transformer as jax_tf
from repro.models.layers import init_params as jax_init
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.kernels.decode_attention import ops
from repro_torch.models import attention, transformer

TOLS = {"float32": 2e-5, "bfloat16": 2e-2}  # as tests/test_kernels.py
TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# first positions of the chunk per sequence (T 48, S 6): on multiples of 16,
# and off them (the last chunk ends one short of T)
Q_START = {("aligned", 1): [16], ("aligned", 3): [0, 16, 32],
           ("unaligned", 1): [23], ("unaligned", 3): [3, 17, 41]}


def _pair(a: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    j = jnp.asarray(a, dtype)
    t = torch.from_numpy(np.array(j, np.float32)).to(TORCH_DTYPE[dtype])
    return j, t


def _as_torch(a, dtype: str) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32)).to(TORCH_DTYPE[dtype])


@pytest.mark.parametrize("G", [1, 4, 8])
@pytest.mark.parametrize("dh", [8, 64, 128])
@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("start", ["aligned", "unaligned"])
@pytest.mark.parametrize("window", [None, 6])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunk_insert_then_attend_matches_reference(G, dh, B, start, window, dtype):
    Hkv, T, S = 2, 48, 6
    Hq = G * Hkv
    rng = np.random.default_rng(G * 1000 + dh * 10 + B)
    q_start = np.array(Q_START[(start, B)], np.int32)
    # a written prefix and a zeroed tail, as the engine guarantees
    base = rng.normal(size=(2, B, T, Hkv, dh))
    base[:, np.arange(T)[None, :] >= q_start[:, None]] = 0.0
    kc_j, kc_t = _pair(base[0], dtype)
    vc_j, vc_t = _pair(base[1], dtype)
    q_j, q_t = _pair(rng.normal(size=(B, S, Hq, dh)), dtype)
    kn_j, kn_t = _pair(rng.normal(size=(B, S, Hkv, dh)), dtype)
    vn_j, vn_t = _pair(rng.normal(size=(B, S, Hkv, dh)), dtype)
    qs_j = jnp.asarray(q_start)

    k_want = jax_attn.insert_chunk(kc_j, kn_j, qs_j)
    v_want = jax_attn.insert_chunk(vc_j, vn_j, qs_j)
    want = jax_attn.decode_attention(q_j, k_want, v_want, qs_j, window=window)

    k_got, v_got = kc_t.clone(), vc_t.clone()
    got = ops.decode_attention_chunk(
        q_t, kn_t, vn_t, k_got, v_got, torch.from_numpy(q_start), window=window)
    assert got.dtype == TORCH_DTYPE[dtype] and got.shape == (B, S, Hq, dh)
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want, np.float32), atol=TOLS[dtype], rtol=TOLS[dtype])
    # the chunk's rows were written in place, bit for bit as the reference's
    assert torch.equal(k_got, _as_torch(k_want, dtype))
    assert torch.equal(v_got, _as_torch(v_want, dtype))


def test_plain_version_is_the_two_inserts_then_attention():
    rng = np.random.default_rng(11)
    B, S, T, Hq, Hkv, dh = 2, 5, 24, 8, 2, 16
    q = torch.from_numpy(rng.normal(size=(B, S, Hq, dh)).astype(np.float32))
    kn = torch.from_numpy(rng.normal(size=(B, S, Hkv, dh)).astype(np.float32))
    vn = torch.from_numpy(rng.normal(size=(B, S, Hkv, dh)).astype(np.float32))
    kc = torch.from_numpy(rng.normal(size=(B, T, Hkv, dh)).astype(np.float32))
    vc = torch.from_numpy(rng.normal(size=(B, T, Hkv, dh)).astype(np.float32))
    qs = torch.tensor([3, 19], dtype=torch.int32)
    k1, v1, k2, v2 = kc.clone(), vc.clone(), kc.clone(), vc.clone()
    got = attention.decode_attention_chunk(q, kn, vn, k1, v1, qs, window=4)
    attention.insert_chunk(k2, kn, qs)
    attention.insert_chunk(v2, vn, qs)
    want = attention.decode_attention(q, k2, v2, qs, window=4)
    assert torch.equal(got, want)
    assert torch.equal(k1, k2) and torch.equal(v1, v2)


# (S, G, dh): shapes the chunk kernel takes in bf16 (gemma3-4b's served
# chunk: S 64, G 2, dh 256)
CHUNK_SHAPES = [(64, 8, 64), (2, 1, 16), (7, 4, 128), (3, 64, 64), (64, 2, 120), (1000, 16, 24),
                (64, 2, 256), (64, 8, 136), (7, 4, 192)]


@pytest.mark.parametrize("S, G, dh", CHUNK_SHAPES)
def test_bf16_chunks_take_the_chunk_kernel(S, G, dh):
    assert ops.variant(S, G, dh, torch.bfloat16) == "chunk"
    assert ops.variant(S, G, dh, torch.float32) == "split"  # the exact parity path
    assert ops.variant(1, G, dh, torch.bfloat16) == ("fused" if G <= 16 else "split")


@pytest.mark.parametrize("S, G, dh", [
    (64, 8, 8),  # the smoke configs' head dim
    (64, 3, 64), (16, 128, 64), (8, 6, 128),  # groups that do not divide 64
    (64, 3, 256), (64, 6, 192),  # the same above dh 128
])
def test_other_chunks_take_the_split_kernel(S, G, dh):
    assert ops.variant(S, G, dh, torch.bfloat16) == "split"
    assert ops.variant(S, G, dh, torch.float32) == "split"


@pytest.mark.parametrize("S, G, dh, dtype, error", [
    (64, 8, 12, torch.bfloat16, ValueError),  # not a multiple of 8
    (64, 8, 264, torch.bfloat16, ValueError),
    (0, 8, 64, torch.bfloat16, ValueError),
    (64, 0, 64, torch.bfloat16, ValueError),
    (64, 8, 64, torch.float16, TypeError),
])
def test_chunk_shapes_no_kernel_takes_raise(S, G, dh, dtype, error):
    with pytest.raises(error):
        ops.variant(S, G, dh, dtype)


def test_chunk_plan_fills_the_card_from_static_shapes():
    """Blocks a cluster that share a row tile's key tiles: a power of two
    up to 8, no more than T has key tiles, and as many as give each of the
    H100's 132 SMs two blocks."""
    assert ops.plan_chunk(1, 64, 8, 4, 1024, 132) == 8  # the engine's chunk: 32 row tiles
    assert ops.plan_chunk(4, 64, 8, 4, 1024, 132) == 2  # 128 row tiles
    assert ops.plan_chunk(16, 64, 8, 4, 1024, 132) == 1  # 512 row tiles fill the card
    assert ops.plan_chunk(1, 64, 8, 1, 1024, 132) == 8
    assert ops.plan_chunk(2, 20, 4, 2, 128, 132) == 2  # two key tiles
    assert ops.plan_chunk(8, 512, 8, 8, 4096, 132) == 1
    # gemma3-4b's served chunk (G 2, Hkv 4, T 2048): 8 row tiles, 64 blocks,
    # one an SM at dh 256's 160 KB of shared memory
    assert ops.plan_chunk(1, 64, 2, 4, 2048, 132) == 8
    for B in (1, 2, 3, 4):
        for S in (2, 13, 64, 200):
            for G in (1, 4, 8, 64):
                for T in (64, 300, 1024):
                    n = ops.plan_chunk(B, S, G, 4, T, 132)
                    blocks = B * 4 * -(-(S * G) // 64)
                    assert n in (1, 2, 4, 8) and n <= -(-T // 64)
                    assert n == 1 or n * blocks <= 2 * 132


def test_wrapper_takes_the_plain_version_on_the_cpu():
    ops.reset_launches()
    rng = np.random.default_rng(13)
    q = torch.from_numpy(rng.normal(size=(1, 4, 8, 16)).astype(np.float32)).bfloat16()
    kn = torch.from_numpy(rng.normal(size=(1, 4, 2, 16)).astype(np.float32)).bfloat16()
    kc = torch.zeros(1, 12, 2, 16, dtype=torch.bfloat16)
    qs = torch.tensor([5], dtype=torch.int32)
    assert ops.variant(4, 4, 16, torch.bfloat16) == "chunk"  # the card would launch it
    k1, v1, k2, v2 = kc.clone(), kc.clone(), kc.clone(), kc.clone()
    got = ops.decode_attention_chunk(q, kn, kn, k1, v1, qs)
    want = attention.decode_attention_chunk(q, kn, kn, k2, v2, qs)
    assert torch.equal(got, want) and torch.equal(k1, k2) and torch.equal(v1, v2)
    assert ops.decode_attention.launches_by_variant == {"split": 0, "fused": 0, "chunk": 0}


def test_wrapper_rejects_other_devices():
    q = torch.empty(1, 4, 8, 16, dtype=torch.bfloat16, device="meta")
    kv = torch.empty(1, 4, 2, 16, dtype=torch.bfloat16, device="meta")
    cache = torch.empty(1, 16, 2, 16, dtype=torch.bfloat16, device="meta")
    qs = torch.zeros(1, dtype=torch.int32, device="meta")
    # meta is the dry-run's shape-only path: an output of q's shape, no launch
    assert ops.decode_attention_chunk(q, kv, kv, cache, cache, qs).shape == q.shape
    # any device but cpu, cuda and meta is refused before any work
    other = types.SimpleNamespace(device=torch.device("xpu", 0))
    with pytest.raises(ValueError, match="device"):
        ops.decode_attention_chunk(other, kv, kv, cache, cache, qs)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_chunk_through_the_chunk_call_matches_reference(dtype, monkeypatch):
    """Three chunks of tinyllama-smoke at unaligned first positions: every
    layer's attention goes through ``decode_attention_chunk``, and the
    logits and caches follow the reference (tolerances and their reasons:
    ``tests/test_torch_transformer.py``)."""
    tols = {"float32": 1e-4, "bfloat16": 5e-2}
    jcfg = dataclasses.replace(jax_config("tinyllama-1.1b", smoke=True),
                               dtype=getattr(jnp, dtype))
    tcfg = dataclasses.replace(get_config("tinyllama-1.1b", smoke=True),
                               dtype=TORCH_DTYPE[dtype])
    jp = jax_init(jax.random.PRNGKey(3), jax_tf.lm_specs(jcfg), jcfg.dtype)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    calls = []

    def counted(*args, **kwargs):
        calls.append(args[0].shape)
        return ops.decode_attention_chunk(*args, **kwargs)

    monkeypatch.setattr(transformer, "decode_attention_chunk", counted)
    B, T, c = 2, 40, 9
    rng = np.random.default_rng(3)
    start = np.array([1, 5], np.int32)
    jcache = jax_tf.init_cache(jcfg, B, T)
    tcache = transformer.init_cache(tcfg, B, T, "cpu")
    jlen, tlen = jnp.asarray(start), torch.from_numpy(start)
    tol = tols[dtype]
    for _ in range(3):
        toks = rng.integers(0, jcfg.vocab, size=(B, c))
        jlog, jcache, jlen = jax_tf.prefill_chunk(jp, jcfg, jnp.asarray(toks, jnp.int32),
                                                  jcache, jlen)
        tlog, tcache, tlen = transformer.prefill_chunk(tp, tcfg, torch.from_numpy(toks),
                                                       tcache, tlen)
        want = np.asarray(jlog)
        assert np.abs(tlog.numpy() - want).max() <= tol * max(1.0, np.abs(want).max())
    assert tlen.tolist() == np.asarray(jlen).tolist() == [28, 32]
    assert len(calls) == 3 * tcfg.n_layers and all(s[1] == c for s in calls)
    for name in ("k", "v"):
        got = tcache[name].float().numpy()
        ref = np.asarray(jcache[name], np.float32)
        assert np.abs(got - ref).max() <= tol * max(1.0, np.abs(ref).max())
