"""Config-driven transformer LM as torch ops: GQA or MLA attention, dense
or MoE FFN.  The full-sequence ``forward`` (training, ``prefill``) and the
cached serving path (``prefill_chunk``, ``decode_step``).

Parameters keep the reference's stacked per-layer layout (``[L, ...]`` under
the names of :func:`lm_specs`) and the cache keeps its pytree
(``{"k","v": [L,B,T,Hkv,dh]}``, or for MLA the latent cache
``{"c_kv": [L,B,T,r], "k_rope": [L,B,T,rope]}``), so snapshots and
converted parameters move between the packages unchanged.  A Python loop
over layers takes the place of ``lax.scan``: ``forward`` unbinds the stacked
tensors once (their gradient is one stack), the cached path indexes them.
On the card every full-sequence attention goes through the flash-attention
kernels (MLA's too: they take its values of 128 columns beside keys of 192
natively) and every cached GQA one through a decode-attention kernel
(``decode_step``: the fused variant, which also writes the step's K/V row;
``prefill_chunk``: the chunk variant, or the split variant after the
chunk's rows are written); MLA's cached attention is the reference's
absorbed product in plain torch on both devices.  On the CPU ``forward``
lowers attention as the reference does (``cfg.attention_impl``).  The
cache is updated in place.  The MoE FFN (:mod:`.moe`) groups the tokens of
each call as the reference does, so a chunk routes as the reference's
chunk routes.
"""
from __future__ import annotations

from functools import partial
from typing import Any, Callable

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

from ..configs.base import LMConfig
from ..kernels.decode_attention import decode_attention_chunk
from ..kernels.flash_attention import flash_attention
from .attention import (
    chunked_gqa_attention,
    gqa_attention,
    insert_chunk,
    mla_decode,
    mla_latent,
    mla_prefill,
)
from .layers import PSpec, apply_rope, rms_norm, swiglu
from .moe import MoEDims, moe_ffn, moe_specs


# --------------------------------------------------------------------------
# param specs
# --------------------------------------------------------------------------
def lm_specs(cfg: LMConfig) -> dict:
    L, d, V = cfg.n_layers, cfg.d_model, cfg.vocab
    hq, hkv, dh, f = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_ff
    layers: dict[str, Any] = {
        "ln1": PSpec((L, d), ("layers", "embed"), init="zeros"),
        "ln2": PSpec((L, d), ("layers", "embed"), init="zeros"),
    }
    if cfg.mla is not None:
        m = cfg.mla
        e_q = m.nope_head_dim + m.rope_head_dim
        layers["attn"] = {
            "w_dq": PSpec((L, d, m.q_lora_rank), ("layers", "embed", "q_lora")),
            "w_uq": PSpec(
                (L, m.q_lora_rank, hq, e_q), ("layers", "q_lora", "heads", "head_dim")
            ),
            "w_dkv": PSpec(
                (L, d, m.kv_lora_rank + m.rope_head_dim), ("layers", "embed", "kv_lora")
            ),
            "w_uk": PSpec(
                (L, m.kv_lora_rank, hq, m.nope_head_dim),
                ("layers", "kv_lora", "heads", "head_dim"),
            ),
            "w_uv": PSpec(
                (L, m.kv_lora_rank, hq, m.v_head_dim),
                ("layers", "kv_lora", "heads", "head_dim"),
            ),
            "w_o": PSpec((L, hq * m.v_head_dim, d), ("layers", "qkv", "embed")),
        }
    else:
        layers["attn"] = {
            "wq": PSpec((L, d, hq, dh), ("layers", "attn_in", "heads", "head_dim")),
            "wk": PSpec((L, d, hkv, dh), ("layers", "attn_in", "kv_heads", "head_dim")),
            "wv": PSpec((L, d, hkv, dh), ("layers", "attn_in", "kv_heads", "head_dim")),
            "wo": PSpec((L, hq, dh, d), ("layers", "heads", "head_dim", "attn_out")),
        }
    if cfg.moe is not None:
        layers["moe"] = moe_specs(cfg.moe, d, L)
    else:
        layers["ffn"] = {
            "w_gate": PSpec((L, d, f), ("layers", "embed", "ff")),
            "w_up": PSpec((L, d, f), ("layers", "embed", "ff")),
            "w_down": PSpec((L, f, d), ("layers", "ff", "embed")),
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


def _moe_dims(cfg: LMConfig) -> MoEDims:
    assert cfg.moe is not None
    return MoEDims(
        n_experts=cfg.moe.n_experts,
        top_k=cfg.moe.top_k,
        n_shared=cfg.moe.n_shared,
        d_model=cfg.d_model,
        d_ff=cfg.moe.d_ff_expert,
        group_size=cfg.moe_group_size,
        capacity_factor=cfg.moe_capacity_factor,
    )


def init_cache(
    cfg: LMConfig, batch: int, max_len: int, device: str | torch.device = "cuda"
) -> dict:
    """Zeroed KV (or MLA latent) cache stacked over layers."""
    L = cfg.n_layers
    if cfg.mla is not None:
        m = cfg.mla
        shapes = {"c_kv": (L, batch, max_len, m.kv_lora_rank),
                  "k_rope": (L, batch, max_len, m.rope_head_dim)}
    else:
        shape = (L, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
        shapes = {"k": shape, "v": shape}
    return {k: torch.zeros(s, dtype=cfg.dtype, device=device) for k, s in shapes.items()}


def _proj_heads(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhe->bshe") as one matmul."""
    d, H, e = w.shape
    return (h @ w.reshape(d, H * e)).view(*h.shape[:-1], H, e)


def _out_proj(out: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """einsum("bshe,hed->bsd") as one matmul."""
    hq, dh, d = wo.shape
    return out.reshape(*out.shape[:2], hq * dh) @ wo.reshape(hq * dh, d)


# --------------------------------------------------------------------------
# blocks (full sequence)
# --------------------------------------------------------------------------
def _full_attention(cfg: LMConfig, q, k, v, is_global: float, causal: bool):
    """Full-sequence attention of q [B,S,Hq,dh] over k [B,S,Hkv,dh] and v
    [B,S,Hkv,dv], dv <= dh (MLA's values are narrower than its keys)."""
    window = None if cfg.local_global is None else cfg.local_window
    if q.device.type == "cpu":  # the reference's lowering, differentiated by autograd
        if cfg.attention_impl == "chunked":
            return chunked_gqa_attention(
                q, k, v, causal=causal, window=window, global_flag=is_global,
                block_q=cfg.attn_block_q,
            )
        return gqa_attention(q, k, v, causal=causal, window=window, global_flag=is_global)
    # on the card: the flash kernels, whatever attention_impl says, at v's
    # own width; a global layer attends without the window
    return flash_attention(q, k, v, causal=causal, window=None if is_global > 0.5 else window)


def _attn_block(cfg: LMConfig, p: dict, x, positions, is_global, *, causal=True):
    """Full-sequence attention (train / prefill). Returns (out, kv-for-cache):
    (k, v), or for MLA the latent rows (c_kv, k_rope)."""
    if cfg.mla is not None:
        m = cfg.mla
        out, c_kv, k_rope = mla_prefill(
            x, p, n_heads=cfg.n_heads, nope=m.nope_head_dim, rope=m.rope_head_dim,
            v_dim=m.v_head_dim, positions=positions, theta=cfg.rope_theta,
            attend=lambda q, k, v: _full_attention(cfg, q, k, v, float(is_global), causal),
        )
        return out @ p["w_o"], (c_kv, k_rope)
    q = apply_rope(_proj_heads(x, p["wq"]), positions, cfg.rope_theta)
    k = apply_rope(_proj_heads(x, p["wk"]), positions, cfg.rope_theta)
    v = _proj_heads(x, p["wv"])
    out = _full_attention(cfg, q, k, v, float(is_global), causal)
    return _out_proj(out, p["wo"]), (k, v)


def _ffn_block(cfg: LMConfig, layer_p: dict, x):
    if cfg.moe is not None:
        return moe_ffn(x, layer_p["moe"], _moe_dims(cfg))
    f = layer_p["ffn"]
    return swiglu(x, f["w_gate"], f["w_up"], f["w_down"])


def _layer(cfg: LMConfig, layer_p: dict, x, positions, is_global, *, collect_kv=False):
    h, kv = _attn_block(cfg, layer_p["attn"], rms_norm(x, layer_p["ln1"]), positions, is_global)
    x = x + h
    x = x + _ffn_block(cfg, layer_p, rms_norm(x, layer_p["ln2"]))
    return x, (kv if collect_kv else None)


def lm_head(params: dict) -> torch.Tensor:
    """The [d, V] output projection: ``head``, or the tied embedding's transpose."""
    head = params.get("head")
    return params["embed"].T if head is None else head


def _unbind_layers(tree: Any, n: int) -> list:
    """Stacked ``[L, ...]`` leaves -> one dict of views per layer."""
    if isinstance(tree, dict):
        per_key = {k: _unbind_layers(v, n) for k, v in tree.items()}
        return [{k: per_key[k][i] for k in tree} for i in range(n)]
    return list(tree.unbind(0))


# --------------------------------------------------------------------------
# model entry points (full sequence)
# --------------------------------------------------------------------------
RematPolicy = Callable[..., Any]  # a selective-checkpoint policy (ctx, op, ...)


def forward(
    params: dict,
    cfg: LMConfig,
    tokens: torch.Tensor,
    *,
    remat: RematPolicy | None = None,
    unroll: int = 1,
    collect_kv: bool = False,
    last_only: bool = False,
    no_head: bool = False,
):
    """tokens [B,S] -> (logits [B,S,V] fp32, cache pair | None).
    With no_head=True returns the final hidden states instead of logits.

    ``remat`` is None (save everything) or a selective-checkpoint policy:
    each layer then runs under ``torch.utils.checkpoint`` and the policy
    decides which op outputs are saved.  ``unroll`` is accepted for the
    reference's signature and has no effect.  The reference's act-sharding
    constraint is a GSPMD annotation: on one card there is nothing to do."""
    B, S = tokens.shape
    x = F.embedding(tokens, params["embed"]).to(cfg.dtype)
    positions = torch.arange(S, device=tokens.device)[None].expand(B, S)
    flags = layer_flags(cfg)

    def body(layer_p, y, is_global):
        return _layer(cfg, layer_p, y, positions, is_global, collect_kv=collect_kv)

    if remat is not None:
        ctx = partial(create_selective_checkpoint_contexts, remat)
        run = partial(checkpoint, body, use_reentrant=False, context_fn=ctx)
    else:
        run = body
    caches = []
    for layer_p, is_global in zip(_unbind_layers(params["layers"], cfg.n_layers), flags):
        x, kv = run(layer_p, x, float(is_global))
        caches.append(kv)
    caches = (
        (torch.stack([kv[0] for kv in caches]), torch.stack([kv[1] for kv in caches]))
        if collect_kv else None
    )
    x = rms_norm(x, params["final_norm"])
    if last_only:
        x = x[:, -1:]  # vLLM-style: prefill only needs the last position
    if no_head:
        return x, caches
    logits = x @ lm_head(params)
    return logits.float(), caches


def _ce_chunk(x, head, targets, m_prev, s_prev, tgt_prev, lo: int, c: int):
    lg = (x @ head[:, lo:lo + c]).float()
    m_cur = torch.maximum(m_prev, lg.amax(-1))
    s_cur = s_prev * torch.exp(m_prev - m_cur) + torch.exp(lg - m_cur[..., None]).sum(-1)
    mine = (targets >= lo) & (targets < lo + c)
    idx = (targets.long() - lo).clamp(0, c - 1)
    tgt_lg = lg.gather(-1, idx[..., None])[..., 0]
    return m_cur, s_cur, torch.where(mine, tgt_lg, tgt_prev)


def streaming_ce_loss(
    x: torch.Tensor,  # [B,S,d] final hidden (normed)
    head: torch.Tensor,  # [d,V] (or transposed embed for tied)
    targets: torch.Tensor,  # [B,S]
    n_chunks: int,
) -> torch.Tensor:
    """CE via running logsumexp over vocab chunks: the fp32 [B,S,V] logits
    tensor never materializes (peak extra memory = one [B,S,V/n] chunk);
    each chunk is recomputed in backward, as the reference checkpoints its
    scan body."""
    V = head.shape[-1]
    if V % n_chunks:
        raise ValueError(f"vocab {V} is not a multiple of loss_vocab_chunks={n_chunks}")
    c = V // n_chunks
    B, S, _ = x.shape
    m = torch.full((B, S), float("-inf"), dtype=torch.float32, device=x.device)
    s = torch.zeros((B, S), dtype=torch.float32, device=x.device)
    tgt = torch.zeros((B, S), dtype=torch.float32, device=x.device)
    for i in range(n_chunks):
        m, s, tgt = checkpoint(_ce_chunk, x, head, targets, m, s, tgt, i * c, c,
                               use_reentrant=False)
    return (torch.log(s) + m - tgt).mean()


@torch.no_grad()
def prefill(params: dict, cfg: LMConfig, tokens: torch.Tensor, *, unroll: int = 1):
    """Returns (last-position logits [B,V] fp32, cache dict, cache_len [B])."""
    B, S = tokens.shape
    logits, caches = forward(
        params, cfg, tokens, unroll=unroll, collect_kv=True,
        last_only=cfg.prefill_last_only,
    )
    names = ("c_kv", "k_rope") if cfg.mla is not None else ("k", "v")
    cache = dict(zip(names, caches))
    cache_len = torch.full((B,), S, dtype=torch.int32, device=tokens.device)
    return logits[:, -1], cache, cache_len


# --------------------------------------------------------------------------
# cached forward (serving)
# --------------------------------------------------------------------------

def _layer_slice(tree: Any, i: int) -> Any:
    """Layer ``i``'s views of stacked ``[L, ...]`` leaves."""
    if isinstance(tree, dict):
        return {k: _layer_slice(v, i) for k, v in tree.items()}
    return tree[i]


def _cached_forward(params: dict, cfg: LMConfig, tokens, cache, cache_len):
    """c new tokens per sequence (c = 1: a decode step).  GQA: the attention
    call writes the new K/V rows itself: on the card one kernel a layer, the
    fused variant at decode (G <= 16 query heads per KV head) and the chunk
    variant for a bf16 chunk (dh 16 to 256, G dividing 64); other shapes
    write the rows with index writes, then run the split kernel.  MLA: the
    chunk's latent and rope rows are written with index writes, then the
    absorbed attention reads the cache."""
    B, c = tokens.shape
    x = params["embed"][tokens].to(cfg.dtype)
    positions = cache_len[:, None].long() + torch.arange(c, device=tokens.device)[None, :]
    lp = params["layers"]
    m = cfg.mla
    for i, window in enumerate(_layer_windows(cfg)):
        p = _layer_slice(lp, i)
        ap = p["attn"]
        h = rms_norm(x, p["ln1"])
        if m is not None:
            c_kv, k_rope = mla_latent(h, ap["w_dkv"], m.rope_head_dim, positions, cfg.rope_theta)
            ckv_c = insert_chunk(cache["c_kv"][i], c_kv, cache_len)
            krope_c = insert_chunk(cache["k_rope"][i], k_rope, cache_len)
            out = mla_decode(
                h, ap, ckv_c, krope_c, cache_len, n_heads=cfg.n_heads,
                nope=m.nope_head_dim, rope=m.rope_head_dim, v_dim=m.v_head_dim,
                positions=positions, theta=cfg.rope_theta,
            )
            x = x + out @ ap["w_o"]
        else:
            q = apply_rope(_proj_heads(h, ap["wq"]), positions, cfg.rope_theta)
            k = apply_rope(_proj_heads(h, ap["wk"]), positions, cfg.rope_theta)
            v = _proj_heads(h, ap["wv"])
            out = decode_attention_chunk(q, k, v, cache["k"][i], cache["v"][i], cache_len,
                                         window=window)
            x = x + _out_proj(out, ap["wo"])
        x = x + _ffn_block(cfg, p, rms_norm(x, p["ln2"]))
    # only the last position's logits are returned, so only it is projected
    x = rms_norm(x[:, -1:], params["final_norm"])
    logits = x @ lm_head(params)
    return logits[:, -1].float(), cache, cache_len + c


def decode_step(
    params: dict,
    cfg: LMConfig,
    tokens: torch.Tensor,  # [B,1]
    cache: dict,  # stacked over layers: [L,B,T,...]; updated in place
    cache_len: torch.Tensor,  # [B] int32 current valid length (new token goes here)
):
    """One decode step. Returns (logits [B,V] fp32, cache, cache_len + 1)."""
    return _cached_forward(params, cfg, tokens, cache, cache_len)


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
    return _cached_forward(params, cfg, tokens, cache, cache_len)
