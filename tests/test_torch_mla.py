"""The port's multi-head latent attention against the reference's, on the
CPU, from the same seeded parameters and inputs: ``mla_prefill`` (both
lowerings), ``mla_decode`` (the absorbed path, at S = 1 and over a chunk,
with per-sequence starts), the latent cache of ``init_cache``, and the
flash kernels' plain version on values padded with zero columns, which
gives the unpadded attention's columns.

Tolerances: fp32 2e-5 absolute and relative (``tests/test_kernels.py``'s);
bf16 5e-2 of the largest reference value, as
``tests/test_torch_transformer.py`` holds bf16."""
import dataclasses
from functools import partial

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
from repro_torch.kernels.flash_attention import attention_ref
from repro_torch.models import attention, transformer

TOLS = {"float32": 2e-5, "bfloat16": 5e-2}
TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}
ARCH = "deepseek-v2-236b"


def _setup(dtype, seed=0):
    """deepseek-v2-smoke's layer 0 attention parameters, in both packages."""
    jcfg = dataclasses.replace(jax_config(ARCH, smoke=True), dtype=getattr(jnp, dtype))
    jp = jax_init(jax.random.PRNGKey(seed), jax_tf.lm_specs(jcfg), jcfg.dtype)
    jp = jax.tree_util.tree_map(lambda a: a[0], jp["layers"]["attn"])
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    m = jcfg.mla
    kw = dict(n_heads=jcfg.n_heads, nope=m.nope_head_dim, rope=m.rope_head_dim,
              v_dim=m.v_head_dim, theta=jcfg.rope_theta)
    return jcfg, jp, tp, kw


def _pair(a: np.ndarray, dtype: str):
    j = jnp.asarray(a, dtype)
    return j, torch.from_numpy(np.array(j, np.float32)).to(TORCH_DTYPE[dtype])


def _close(got, want, dtype):
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    assert got.shape == want.shape
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=TOLS[dtype], rtol=TOLS[dtype])
    else:
        assert np.abs(got - want).max() <= TOLS[dtype] * np.abs(want).max()


@pytest.mark.parametrize("impl", ["einsum", "chunked"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_prefill_matches_reference(impl, dtype):
    jcfg, jp, tp, kw = _setup(dtype)
    B, S = 2, 20
    x = np.random.default_rng(1).standard_normal((B, S, jcfg.d_model)).astype(np.float32)
    jx, tx = _pair(x, dtype)
    pos = np.broadcast_to(np.arange(S)[None], (B, S)).astype(np.int32)
    want = jax_attn.mla_prefill(jx, jp, positions=jnp.asarray(pos), attn_impl=impl,
                                block_q=8, **kw)
    attend = (partial(attention.chunked_gqa_attention, causal=True, block_q=8)
              if impl == "chunked" else partial(attention.gqa_attention, causal=True))
    got = attention.mla_prefill(tx, tp, positions=torch.from_numpy(pos), attend=attend, **kw)
    m = jcfg.mla
    shapes = [(B, S, jcfg.n_heads * m.v_head_dim), (B, S, m.kv_lora_rank),
              (B, S, m.rope_head_dim)]
    for g, w, shape in zip(got, want, shapes):
        assert g.shape == shape
        _close(g, w, dtype)


@pytest.mark.parametrize("S", [1, 8])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_decode_matches_reference(S, dtype):
    """The absorbed path over a latent cache of 24 rows, S new query rows
    per sequence at starts 5 and 13."""
    jcfg, jp, tp, kw = _setup(dtype, seed=1)
    m = jcfg.mla
    B, T = 2, 24
    rng = np.random.default_rng(2 + S)
    x = rng.standard_normal((B, S, jcfg.d_model)).astype(np.float32)
    ckv = rng.standard_normal((B, T, m.kv_lora_rank)).astype(np.float32)
    krope = rng.standard_normal((B, T, m.rope_head_dim)).astype(np.float32)
    start = np.array([5, 13], np.int32)
    pos = (start[:, None] + np.arange(S)[None]).astype(np.int32)
    (jx, tx), (jc, tc), (jk, tk) = (_pair(a, dtype) for a in (x, ckv, krope))
    want = jax_attn.mla_decode(jx, jp, jc, jk, jnp.asarray(start), positions=jnp.asarray(pos),
                               **kw)
    got = attention.mla_decode(tx, tp, tc, tk, torch.from_numpy(start),
                               positions=torch.from_numpy(pos), **kw)
    assert got.shape == (B, S, jcfg.n_heads * m.v_head_dim) and got.dtype == TORCH_DTYPE[dtype]
    _close(got, want, dtype)


def test_absorbed_decode_equals_full_attention():
    """``mla_prefill`` over S tokens and ``mla_decode`` of the same tokens
    against their own latent rows compute the same attention (the identity
    the card's flash-prefill check relies on), here both in the port, fp32."""
    jcfg, _, tp, kw = _setup("float32", seed=2)
    B, S = 1, 12
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (B, S, jcfg.d_model)).astype(np.float32))
    pos = torch.arange(S)[None]
    full, ckv, krope = attention.mla_prefill(
        x, tp, positions=pos, attend=partial(attention.gqa_attention, causal=True), **kw)
    absorbed = attention.mla_decode(x, tp, ckv, krope, torch.zeros(B, dtype=torch.int32),
                                    positions=pos, **kw)
    torch.testing.assert_close(absorbed, full, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_zero_padded_values_leave_the_attention_unchanged(dtype):
    """MLA's prefill attention has keys of nope + rope columns and values of
    v_dim.  The flash kernels take the narrower values as they are; values
    padded with zero columns up to the key width (the model's route on the
    card before the kernels took them) give, through the kernels' plain
    version, the unpadded attention's columns bit for bit and zeros past
    them."""
    cfg = get_config(ARCH, smoke=True)
    m = cfg.mla
    dh, dv, H = m.nope_head_dim + m.rope_head_dim, m.v_head_dim, cfg.n_heads
    g = torch.Generator().manual_seed(0)
    q, k = (torch.randn(2, 18, H, dh, generator=g).to(TORCH_DTYPE[dtype]) for _ in range(2))
    v = torch.randn(2, 18, H, dv, generator=g).to(TORCH_DTYPE[dtype])
    padded = attention_ref(q, k, torch.nn.functional.pad(v, (0, dh - dv)), causal=True)
    assert torch.equal(padded[..., dv:], torch.zeros_like(padded[..., dv:]))
    want = attention.gqa_attention(q, k, v, causal=True)
    assert torch.equal(padded[..., :dv], want)


@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
def test_mla_init_cache_is_the_latent_cache(smoke):
    """``init_cache`` of an MLA config is the reference's latent cache:
    ``c_kv`` [L,B,T,kv_lora_rank] and ``k_rope`` [L,B,T,rope_head_dim] in the
    working dtype, zeroed (at full width on the meta device: shapes only)."""
    tcfg, jcfg = get_config(ARCH, smoke=smoke), jax_config(ARCH, smoke=smoke)
    device = "cpu" if smoke else "meta"
    got = transformer.init_cache(tcfg, 3, 40, device)
    want = jax.eval_shape(lambda: jax_tf.init_cache(jcfg, 3, 40))
    assert sorted(got) == sorted(want) == ["c_kv", "k_rope"]
    for name, a in got.items():
        assert tuple(a.shape) == want[name].shape and a.dtype == tcfg.dtype
    m = tcfg.mla
    assert got["c_kv"].shape == (tcfg.n_layers, 3, 40, m.kv_lora_rank)
    assert got["k_rope"].shape == (tcfg.n_layers, 3, 40, m.rope_head_dim)
    if smoke:
        assert not any(bool(a.any()) for a in got.values())
