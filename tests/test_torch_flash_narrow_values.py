"""Values narrower than keys in the flash-attention wrapper (MLA: keys of
nope + rope columns, values of v_dim), on the CPU: the plain version
``attention_ref`` at dv < dh against the reference's
``repro.models.attention.gqa_attention`` and, bit for bit, the port's;
``variant`` and the wrapper's checks at (dh, dv) pairs; the meta path's
shapes and its count of the work at deepseek-v2's prefill shape; and
deepseek-v2's smoke ``forward`` handing the flash wrapper its values as they
are, with no pad.

Tolerances: fp32 1e-5 absolute and relative (the two frameworks' einsums sum
in other orders); bf16 2e-2, as the kernels' bf16 checks hold."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp

from repro.models import attention as jax_attn
from repro_torch.configs import get_config
from repro_torch.kernels import meta
from repro_torch.kernels.flash_attention import attention_ref
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models import attention, transformer
from repro_torch.models.layers import init_params

TOLS = {"float32": 1e-5, "bfloat16": 2e-2}
TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# (dh, dv): deepseek-v2's keys of 192 and values of 128, and its smoke
# config's 24 and 16
WIDTHS = [(192, 128), (24, 16)]
MASKS = {"causal": None, "window": 8}  # every case causal; "window" adds one of 8


def _inputs(B, S, Hkv, G, dh, dv, dtype, seed=0):
    """q, k, v from numpy, rounded to ``dtype`` once, in both packages."""
    r = np.random.default_rng(seed)
    shapes = ((B, S, Hkv * G, dh), (B, S, Hkv, dh), (B, S, Hkv, dv))
    arrays = [r.standard_normal(s).astype(np.float32) for s in shapes]
    jx = [jnp.asarray(a, dtype) for a in arrays]
    tx = [torch.from_numpy(np.array(j, np.float32)).to(TORCH_DTYPE[dtype]) for j in jx]
    return jx, tx


@pytest.mark.parametrize("dh,dv", WIDTHS, ids=[f"dh{a}-dv{b}" for a, b in WIDTHS])
@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("mask", list(MASKS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_ref_matches_the_reference(dtype, mask, G, dh, dv):
    (jq, jk, jv), (q, k, v) = _inputs(2, 37, 2, G, dh, dv, dtype)
    window = MASKS[mask]
    want = jax_attn.gqa_attention(jq, jk, jv, causal=True, window=window)
    got = attention_ref(q, k, v, causal=True, window=window)
    assert tuple(got.shape) == (2, 37, 2 * G, dv) == want.shape
    assert got.dtype == q.dtype
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=TOLS[dtype], rtol=TOLS[dtype])


@pytest.mark.parametrize("dh,dv", WIDTHS, ids=[f"dh{a}-dv{b}" for a, b in WIDTHS])
@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("mask", list(MASKS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_ref_equals_the_ports_gqa_attention(dtype, mask, G, dh, dv):
    """The kernels' plain version computes the function the model's CPU path
    computes, bit for bit, with no pad."""
    _, (q, k, v) = _inputs(1, 29, 2, G, dh, dv, dtype, seed=1)
    window = MASKS[mask]
    got = attention_ref(q, k, v, causal=True, window=window)
    assert torch.equal(got, attention.gqa_attention(q, k, v, causal=True, window=window))


@pytest.mark.parametrize("dh,dv", WIDTHS, ids=[f"dh{a}-dv{b}" for a, b in WIDTHS])
def test_mla_widths_take_wgmma_and_tf32x3(dh, dv):
    assert flash_ops.variant(torch.bfloat16, dh, 1, dv) == "wgmma"
    assert flash_ops.variant(torch.bfloat16, dh, 3, dv) == "wgmma_rows"
    assert flash_ops.variant(torch.float32, dh, 1, dv) == "tf32x3"
    assert flash_ops.variant(torch.float32, dh, 3, dv) == "tf32x3"


def test_instances_name_the_chunk_pairs():
    assert flash_ops.instance(torch.bfloat16, 192, 1, 128) == "wgmma 3x2"
    assert flash_ops.instance(torch.bfloat16, 192, 3, 128) == "wgmma_rows 3x2"
    assert flash_ops.instance(torch.bfloat16, 192, 1) == "wgmma 3x3"
    assert flash_ops.instance(torch.bfloat16, 24, 1, 16) == "wgmma 1x1"
    assert flash_ops.instance(torch.float32, 192, 1, 128) == "tf32x3"
    assert {flash_ops.instance(torch.bfloat16, dh, 1) for dh in (64, 128, 192, 256)} == {
        "wgmma 1x1", "wgmma 2x2", "wgmma 3x3", "wgmma 4x4"}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("dh,dv", [(64, 72), (192, 200), (192, 124), (24, 20)],
                         ids=["dv-over-dh", "dv-over-dh-192", "dv-not-x8", "dv-not-x8-smoke"])
def test_bad_value_widths_raise(dtype, dh, dv):
    with pytest.raises(ValueError, match="value width"):
        flash_ops.variant(dtype, dh, 1, dv)


@pytest.mark.parametrize("dh,dv", [(256, 128), (256, 192), (128, 64), (192, 64)])
def test_pairs_without_an_instantiation_raise(dh, dv):
    """bf16 keys and values whose 64-column chunk counts no kernel is
    instantiated at; fp32 takes them, zero-filling V."""
    with pytest.raises(ValueError, match="no bf16 kernel"):
        flash_ops.variant(torch.bfloat16, dh, 1, dv)
    assert flash_ops.variant(torch.float32, dh, 1, dv) == "tf32x3"


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_check_takes_narrow_values_and_refuses_others(dtype):
    q, k = _meta(1, 16, 4, 192, dtype=dtype), _meta(1, 16, 4, 192, dtype=dtype)
    flash_ops._check(q, k, _meta(1, 16, 4, 128, dtype=dtype), None)
    for v, what in ((_meta(1, 16, 4, 200, dtype=dtype), "value width"),
                    (_meta(1, 16, 4, 124, dtype=dtype), "value width"),
                    (_meta(1, 15, 4, 128, dtype=dtype), "shapes"),
                    (_meta(1, 16, 2, 128, dtype=dtype), "shapes")):
        with pytest.raises(ValueError, match=what):
            flash_ops._check(q, k, v, None)


def test_meta_path_gives_value_wide_outputs_and_counts_the_work():
    """deepseek-v2's prefill attention on meta: out and dv at dv, dq and dk
    at dh; the FLOPs and bytes recorded equal a count by hand."""
    B, S, H, dh, dv = 1, 1024, 128, 192, 128
    q, k = (_meta(B, S, H, dh).requires_grad_(True) for _ in range(2))
    v = _meta(B, S, H, dv).requires_grad_(True)
    with meta.counting() as counts:
        out = flash_ops.flash_attention(q, k, v, causal=True)
        dq, dk, dvg = torch.autograd.grad(out, (q, k, v), torch.empty_like(out))
    assert tuple(out.shape) == (B, S, H, dv) and tuple(dvg.shape) == (B, S, H, dv)
    assert tuple(dq.shape) == tuple(dk.shape) == (B, S, H, dh)
    pairs = S * (S + 1) // 2  # causal
    rows, lse = B * S * H * 2, B * H * S * 4  # a bf16 row of one column; the fp32 lse
    # forward: Q.K over dh, P.V over dv; q, k read at dh, v read and out written at dv
    assert counts.flops["flash_attention_fwd"] == 2 * B * H * pairs * (dh + dv)
    assert counts.bytes["flash_attention_fwd"] == rows * (dh + dh + dv + dv) + lse
    # backward: dO.V and P^T.dO over dv, dS.K and dS^T.Q over dh; q, k, dq,
    # dk at dh; v, out, dout, dv at dv
    assert counts.flops["flash_attention_bwd"] == 2 * B * H * pairs * (2 * dh + 2 * dv)
    assert counts.bytes["flash_attention_bwd"] == rows * (4 * dh + 4 * dv) + lse


def test_work_floats_size_the_gathered_dout_at_dv():
    B, S, Hq, Hkv, dh, dv = 1, 64, 6, 2, 192, 128
    rows, wg = flash_ops.VARIANTS.index("wgmma_rows"), flash_ops.VARIANTS.index("wgmma")
    args = (B, S, S, Hq, Hkv, dh, 1, 0)
    assert flash_ops.work_floats(*args, rows, False, dv=dv) == B * Hq * S * dh // 2
    assert flash_ops.work_floats(*args, rows, True, dv=dv) == (
        B * Hq * S * (dh + dv) // 2 + B * Hq * S)
    assert flash_ops.work_floats(*args, wg, True, dv=dv) == B * Hq * S
    assert flash_ops.work_floats(*args, rows, True) == B * Hq * S * dh + B * Hq * S
    x3 = flash_ops.VARIANTS.index("tf32x3")  # the split keeps V dh wide, zero-filled
    assert flash_ops.work_floats(*args, x3, True, dv=dv) == flash_ops.work_floats(*args, x3, True)


def test_deepseek_v2_forward_passes_its_values_unpadded(monkeypatch):
    """A spy on the flash wrapper over deepseek-v2's smoke ``forward`` on the
    meta device (the card's path, shapes only): every call gets values
    v_head_dim wide, and ``F.pad`` is never called."""
    cfg = get_config("deepseek-v2-236b", smoke=True)
    m = cfg.mla
    assert m.v_head_dim < m.nope_head_dim + m.rope_head_dim
    params = init_params(torch.Generator().manual_seed(0), transformer.lm_specs(cfg), cfg.dtype,
                         "cpu")
    params = torch.utils._pytree.tree_map(lambda t: t.to("meta"), params)
    seen, pads = [], []
    inner_flash, inner_pad = transformer.flash_attention, torch.nn.functional.pad

    def flash_spy(q, k, v, **kw):
        seen.append((q.shape[-1], k.shape[-1], v.shape[-1]))
        return inner_flash(q, k, v, **kw)

    def pad_spy(*a, **kw):
        pads.append(a[1] if len(a) > 1 else kw.get("pad"))
        return inner_pad(*a, **kw)

    monkeypatch.setattr(transformer, "flash_attention", flash_spy)
    monkeypatch.setattr(torch.nn.functional, "pad", pad_spy)
    tokens = torch.zeros(2, 16, dtype=torch.int32, device="meta")
    with meta.counting() as counts:
        logits, _ = transformer.forward(params, cfg, tokens)
    assert logits.device.type == "meta"
    dh = m.nope_head_dim + m.rope_head_dim
    assert seen == [(dh, dh, m.v_head_dim)] * cfg.n_layers
    assert pads == []
    assert counts.calls["flash_attention_fwd"] == cfg.n_layers
