"""Config-driven transformer LM, dense-GQA serving path, as torch ops.

Parameters keep the reference's stacked per-layer layout (``[L, ...]`` under
the names of :func:`lm_specs`) and the cache keeps its pytree
``{"k","v": [L,B,T,Hkv,dh]}``, so snapshots and converted parameters move
between the packages unchanged.  A Python loop over layers indexes the
stacked tensors in place of ``lax.scan``.  Every attention call goes through
the decode-attention kernel's wrapper; the cache is updated in place.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from ..configs.base import LMConfig
from ..kernels.decode_attention import decode_attention
from .attention import insert_chunk, insert_kv
from .layers import PSpec, apply_rope, rms_norm

_UNPORTED = (
    "is not ported yet: MoE and MLA configs wait for ROADMAP.md queue 1, item 9 "
    "(MoE and MLA)"
)


def _check_dense(cfg: LMConfig) -> None:
    if cfg.mla is not None:
        raise NotImplementedError(f"MLA attention ({cfg.name}) {_UNPORTED}")
    if cfg.moe is not None:
        raise NotImplementedError(f"MoE FFN ({cfg.name}) {_UNPORTED}")


# --------------------------------------------------------------------------
# param specs
# --------------------------------------------------------------------------
def lm_specs(cfg: LMConfig) -> dict:
    _check_dense(cfg)
    L, d, V = cfg.n_layers, cfg.d_model, cfg.vocab
    hq, hkv, dh, f = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_ff
    layers: dict[str, Any] = {
        "ln1": PSpec((L, d), ("layers", "embed"), init="zeros"),
        "ln2": PSpec((L, d), ("layers", "embed"), init="zeros"),
        "attn": {
            "wq": PSpec((L, d, hq, dh), ("layers", "attn_in", "heads", "head_dim")),
            "wk": PSpec((L, d, hkv, dh), ("layers", "attn_in", "kv_heads", "head_dim")),
            "wv": PSpec((L, d, hkv, dh), ("layers", "attn_in", "kv_heads", "head_dim")),
            "wo": PSpec((L, hq, dh, d), ("layers", "heads", "head_dim", "attn_out")),
        },
        "ffn": {
            "w_gate": PSpec((L, d, f), ("layers", "embed", "ff")),
            "w_up": PSpec((L, d, f), ("layers", "embed", "ff")),
            "w_down": PSpec((L, f, d), ("layers", "ff", "embed")),
        },
    }
    specs = {
        "embed": PSpec((V, d), ("vocab", "embed"), scale=0.02),
        "layers": layers,
        "final_norm": PSpec((d,), ("embed",), init="zeros"),
    }
    if not cfg.tie_embeddings:
        specs["head"] = PSpec((d, V), ("embed", "vocab"))
    return specs


def layer_flags(cfg: LMConfig) -> np.ndarray:
    """is_global per layer: gemma3 pattern 'n_local local then 1 global'."""
    if cfg.local_global is None:
        return np.ones(cfg.n_layers, dtype=np.float32)
    n_local, n_global = cfg.local_global
    cycle = n_local + n_global
    flags = [(i % cycle) >= n_local for i in range(cfg.n_layers)]
    return np.asarray(flags, dtype=np.float32)


def _layer_windows(cfg: LMConfig) -> list[int | None]:
    """The window each layer attends with: None on global layers."""
    if cfg.local_global is None:
        return [None] * cfg.n_layers
    return [None if g > 0.5 else cfg.local_window for g in layer_flags(cfg)]


def init_cache(
    cfg: LMConfig, batch: int, max_len: int, device: str | torch.device = "cuda"
) -> dict:
    """Zeroed KV cache stacked over layers."""
    _check_dense(cfg)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=cfg.dtype, device=device),
        "v": torch.zeros(shape, dtype=cfg.dtype, device=device),
    }


# --------------------------------------------------------------------------
# cached forward (serving)
# --------------------------------------------------------------------------
def _proj_heads(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhe->bshe") as one matmul."""
    d, H, e = w.shape
    return (h @ w.reshape(d, H * e)).view(*h.shape[:-1], H, e)


def _cached_forward(params: dict, cfg: LMConfig, tokens, cache, cache_len, insert):
    _check_dense(cfg)
    B, c = tokens.shape
    x = params["embed"][tokens].to(cfg.dtype)
    positions = cache_len[:, None].long() + torch.arange(c, device=tokens.device)[None, :]
    lp = params["layers"]
    ap, fp = lp["attn"], lp["ffn"]
    for i, window in enumerate(_layer_windows(cfg)):
        k_c, v_c = cache["k"][i], cache["v"][i]
        h = rms_norm(x, lp["ln1"][i])
        q = apply_rope(_proj_heads(h, ap["wq"][i]), positions, cfg.rope_theta)
        k = apply_rope(_proj_heads(h, ap["wk"][i]), positions, cfg.rope_theta)
        v = _proj_heads(h, ap["wv"][i])
        insert(k_c, k, cache_len)
        insert(v_c, v, cache_len)
        out = decode_attention(q, k_c, v_c, cache_len, window=window)
        hq, dh, d = ap["wo"][i].shape
        x = x + out.reshape(B, c, hq * dh) @ ap["wo"][i].reshape(hq * dh, d)
        h2 = rms_norm(x, lp["ln2"][i])
        g = F.silu(h2 @ fp["w_gate"][i])
        u = h2 @ fp["w_up"][i]
        x = x + (g * u) @ fp["w_down"][i]
    # only the last position's logits are returned, so only it is projected
    x = rms_norm(x[:, -1:], params["final_norm"])
    head = params.get("head")
    logits = x @ params["embed"].T if head is None else x @ head
    return logits[:, -1].float(), cache, cache_len + c


def decode_step(
    params: dict,
    cfg: LMConfig,
    tokens: torch.Tensor,  # [B,1]
    cache: dict,  # stacked over layers: [L,B,T,...]; updated in place
    cache_len: torch.Tensor,  # [B] int32 current valid length (new token goes here)
):
    """One decode step. Returns (logits [B,V] fp32, cache, cache_len + 1)."""
    return _cached_forward(params, cfg, tokens, cache, cache_len, insert_kv)


def prefill_chunk(
    params: dict,
    cfg: LMConfig,
    tokens: torch.Tensor,  # [B,c]
    cache: dict,  # [L,B,T,...]; updated in place
    cache_len: torch.Tensor,  # [B] int32 valid length before this chunk
):
    """Chunked prefill against an existing cache (serving engine / RISP
    prefix reuse): appends c tokens at positions cache_len..cache_len+c-1.
    Returns (last-position logits [B,V] fp32, cache, cache_len + c)."""
    return _cached_forward(params, cfg, tokens, cache, cache_len, insert_chunk)
