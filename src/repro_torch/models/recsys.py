"""RecSys models: FM, DCN-v2, BST, SASRec on a shared embedding substrate.

The hot path is the sparse embedding lookup.  Every table row the models
read goes through :func:`repro_torch.kernels.embedding_bag.embedding_bag`
(the hand-written kernel on the card, its plain version on the CPU), where
the reference calls ``jnp.take``:

* reductions over the fields are bags of ``n_sparse`` ids (FM's sum of
  field embeddings and its linear term, ``fm_retrieval``'s user vector);
* every other lookup is a bag of one (``ids [n, 1]``): DCN-v2's field
  embeddings, the sequence models' history, target, positive, negative and
  candidate rows, FM's and DCN-v2's candidate rows, and the rows of FM's
  square term.

The dense products and the sequence models' attention stay plain torch, as
the reference computes them outside any Pallas kernel.  Tables use one
logical "table_vocab" axis (a sharding annotation in the reference).

Training differentiates every lookup in its table only (ids and weights
are constants).  On the card each lookup's table gradient is one launch of
the embedding-bag backward kernel, a dense [V, dim] tensor as the
reference's transpose of ``jnp.take`` gives; FM's table is read twice (its
square term's ``rows()`` and its field sums), so autograd adds two dense
gradients.  On the CPU autograd differentiates the plain version.

Retrieval scoring (``retrieval_cand``): one query against 10^6 candidates as
a batched dot against the candidate-embedding matrix — FM factorizes exactly
(score = <sum_user v, v_cand> + w_cand + const); sequence models use their
standard final-hidden-state-dot-item-embedding scoring; DCN-v2 uses a
two-tower projection of its cross output.
"""
from __future__ import annotations

import torch

from ..configs.base import RecsysConfig
from ..kernels.embedding_bag import embedding_bag
from .attention import gqa_attention
from .layers import PSpec, layer_norm, mlp


# --------------------------------------------------------------------------
# shared helpers
# --------------------------------------------------------------------------
def _mlp_specs(d_in: int, widths: tuple[int, ...], out_dim: int = 1) -> list:
    layers = []
    d = d_in
    for w in list(widths) + [out_dim]:
        layers.append(
            {
                "w": PSpec((d, w), ("mlp_in", "mlp_hidden")),
                "b": PSpec((w,), ("mlp_hidden",), init="zeros"),
            }
        )
        d = w
    return layers


def _field_table_specs(cfg: RecsysConfig) -> PSpec:
    """One stacked table for all sparse fields (offset-indexed rows)."""
    total_rows = sum(cfg.vocab_sizes)
    return PSpec((total_rows, cfg.embed_dim), ("table_vocab", "embed_dim"), scale=0.02)


def field_offsets(cfg: RecsysConfig, device: str | torch.device = "cpu") -> torch.Tensor:
    off = [0]
    for v in cfg.vocab_sizes[:-1]:
        off.append(off[-1] + v)
    return torch.tensor(off, dtype=torch.int32, device=device)


def _stacked_ids(cfg: RecsysConfig, sparse_ids: torch.Tensor) -> torch.Tensor:
    """Per-field local ids [B, F] -> rows of the stacked table [B, F], int32."""
    return (sparse_ids + field_offsets(cfg, sparse_ids.device)[None, :]).to(torch.int32)


def rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]`` for ids of any shape, as bags of one: [..., dim]."""
    flat = ids.reshape(-1, 1).to(torch.int32).contiguous()
    return embedding_bag(table, flat).reshape(*ids.shape, table.shape[1])


def lookup_fields(table: torch.Tensor, cfg: RecsysConfig, sparse_ids: torch.Tensor):
    """sparse_ids [B, n_fields] (per-field local ids) -> [B, n_fields, dim]."""
    return rows(table, _stacked_ids(cfg, sparse_ids))


# --------------------------------------------------------------------------
# FM (Rendle ICDM'10): O(nk) sum-square trick
# --------------------------------------------------------------------------
def fm_specs(cfg: RecsysConfig) -> dict:
    total_rows = sum(cfg.vocab_sizes)
    return {
        "table": _field_table_specs(cfg),
        "w_linear": PSpec((total_rows,), ("table_vocab",), scale=0.01),
        "bias": PSpec((1,), (None,), init="zeros"),
    }


def fm_forward(params: dict, cfg: RecsysConfig, sparse_ids: torch.Tensor) -> torch.Tensor:
    ids = _stacked_ids(cfg, sparse_ids)  # [B,F]
    v = rows(params["table"], ids)  # [B,F,k], for the square term
    lin = embedding_bag(params["w_linear"].view(-1, 1), ids)[:, 0]  # [B]
    s = embedding_bag(params["table"], ids)  # [B,k]
    pair = 0.5 * (s.square().sum(-1) - v.square().sum(dim=(1, 2)))
    return params["bias"][0] + lin + pair


def fm_retrieval(params: dict, cfg: RecsysConfig, sparse_ids, candidate_ids):
    """Exact FM split: user-part constant + <sum_user v, v_c> + w_c."""
    v_u = embedding_bag(params["table"], _stacked_ids(cfg, sparse_ids))  # [B,k]
    v_c = rows(params["table"], candidate_ids)  # [C,k]
    w_c = rows(params["w_linear"].view(-1, 1), candidate_ids)[:, 0]  # [C]
    return v_u @ v_c.T + w_c[None, :]


# --------------------------------------------------------------------------
# DCN-v2 (arXiv:2008.13535)
# --------------------------------------------------------------------------
def dcn_specs(cfg: RecsysConfig) -> dict:
    d0 = cfg.n_dense + cfg.n_sparse * cfg.embed_dim
    Lc = cfg.n_cross_layers
    return {
        "table": _field_table_specs(cfg),
        "cross_w": PSpec((Lc, d0, d0), ("layers", "x0", "x0")),
        "cross_b": PSpec((Lc, d0), ("layers", "x0"), init="zeros"),
        "mlp": _mlp_specs(d0, cfg.mlp),
        "tower": PSpec((d0, cfg.embed_dim), ("x0", "embed_dim")),  # retrieval tower
    }


def dcn_embed(params: dict, cfg: RecsysConfig, dense, sparse_ids):
    emb = lookup_fields(params["table"], cfg, sparse_ids)  # [B,F,k]
    B = dense.shape[0]
    return torch.cat([dense, emb.reshape(B, -1)], dim=-1)


def dcn_cross(params: dict, x0: torch.Tensor) -> torch.Tensor:
    x = x0
    for l in range(params["cross_w"].shape[0]):
        x = x0 * (x @ params["cross_w"][l] + params["cross_b"][l]) + x
    return x


def dcn_forward(params: dict, cfg: RecsysConfig, dense, sparse_ids) -> torch.Tensor:
    x0 = dcn_embed(params, cfg, dense, sparse_ids)
    x = dcn_cross(params, x0)
    return mlp(x, params["mlp"])[:, 0]


def dcn_retrieval(params: dict, cfg: RecsysConfig, dense, sparse_ids, candidate_ids):
    x0 = dcn_embed(params, cfg, dense, sparse_ids)
    u = dcn_cross(params, x0) @ params["tower"]
    v_c = rows(params["table"], candidate_ids)
    return u @ v_c.T


# --------------------------------------------------------------------------
# BST (arXiv:1905.06874): transformer over user behaviour sequence
# --------------------------------------------------------------------------
def _tf_block_specs(cfg: RecsysConfig, L: int, d: int) -> dict:
    h = cfg.n_heads
    dh = max(d // max(h, 1), 1)
    return {
        "wq": PSpec((L, d, h, dh), ("layers", "embed_dim", "heads", "head_dim")),
        "wk": PSpec((L, d, h, dh), ("layers", "embed_dim", "heads", "head_dim")),
        "wv": PSpec((L, d, h, dh), ("layers", "embed_dim", "heads", "head_dim")),
        "wo": PSpec((L, h, dh, d), ("layers", "heads", "head_dim", "embed_dim")),
        "ffn_w1": PSpec((L, d, 4 * d), ("layers", "embed_dim", "ff")),
        "ffn_b1": PSpec((L, 4 * d), ("layers", "ff"), init="zeros"),
        "ffn_w2": PSpec((L, 4 * d, d), ("layers", "ff", "embed_dim")),
        "ffn_b2": PSpec((L, d), ("layers", "embed_dim"), init="zeros"),
        "ln1_s": PSpec((L, d), ("layers", "embed_dim"), init="ones"),
        "ln1_b": PSpec((L, d), ("layers", "embed_dim"), init="zeros"),
        "ln2_s": PSpec((L, d), ("layers", "embed_dim"), init="ones"),
        "ln2_b": PSpec((L, d), ("layers", "embed_dim"), init="zeros"),
    }


def _tf_encode(p: dict, x: torch.Tensor, causal: bool) -> torch.Tensor:
    """x [B,S,d]; stacked blocks, one loop step per block (the reference's
    scan).  Attention is the plain einsum ``gqa_attention``: the head dims
    (4 for BST, 50 for SASRec) are not the flash kernel's multiples of 8."""
    for l in range(p["wq"].shape[0]):
        lp = {k: v[l] for k, v in p.items()}
        h = layer_norm(x, lp["ln1_s"], lp["ln1_b"])
        q = torch.einsum("bsd,dhe->bshe", h, lp["wq"])
        k = torch.einsum("bsd,dhe->bshe", h, lp["wk"])
        v = torch.einsum("bsd,dhe->bshe", h, lp["wv"])
        a = gqa_attention(q, k, v, causal=causal)
        x = x + torch.einsum("bshe,hed->bsd", a, lp["wo"])
        h = layer_norm(x, lp["ln2_s"], lp["ln2_b"])
        f = torch.relu(h @ lp["ffn_w1"] + lp["ffn_b1"])
        x = x + f @ lp["ffn_w2"] + lp["ffn_b2"]
    return x


def bst_specs(cfg: RecsysConfig) -> dict:
    d = cfg.embed_dim
    # +1 position: the target item is appended to the behaviour sequence
    return {
        "item_table": PSpec((cfg.item_vocab, d), ("table_vocab", "embed_dim"), scale=0.02),
        "pos_table": PSpec((cfg.seq_len + 1, d), ("seq", "embed_dim"), scale=0.02),
        "blocks": _tf_block_specs(cfg, cfg.n_blocks, d),
        "mlp": _mlp_specs((cfg.seq_len + 1) * d, cfg.mlp),
    }


def bst_forward(params: dict, cfg: RecsysConfig, hist_ids, target_id) -> torch.Tensor:
    B = hist_ids.shape[0]
    seq = torch.cat([hist_ids, target_id[:, None]], dim=1)  # [B,S+1]
    x = rows(params["item_table"], seq) + params["pos_table"][None]
    x = _tf_encode(params["blocks"], x, causal=False)
    return mlp(x.reshape(B, -1), params["mlp"])[:, 0]


def bst_retrieval(params: dict, cfg: RecsysConfig, hist_ids, candidate_ids):
    x = rows(params["item_table"], hist_ids)
    x = x + params["pos_table"][None, : cfg.seq_len]
    x = _tf_encode(params["blocks"], x, causal=False)
    u = x.mean(dim=1)  # [B,d]
    v_c = rows(params["item_table"], candidate_ids)
    return u @ v_c.T


# --------------------------------------------------------------------------
# SASRec (arXiv:1808.09781)
# --------------------------------------------------------------------------
def sasrec_specs(cfg: RecsysConfig) -> dict:
    d = cfg.embed_dim
    return {
        "item_table": PSpec((cfg.item_vocab, d), ("table_vocab", "embed_dim"), scale=0.02),
        "pos_table": PSpec((cfg.seq_len, d), ("seq", "embed_dim"), scale=0.02),
        "blocks": _tf_block_specs(cfg, cfg.n_blocks, d),
        "ln_f_s": PSpec((d,), ("embed_dim",), init="ones"),
        "ln_f_b": PSpec((d,), ("embed_dim",), init="zeros"),
    }


def sasrec_encode(params: dict, cfg: RecsysConfig, hist_ids) -> torch.Tensor:
    x = rows(params["item_table"], hist_ids) + params["pos_table"][None]
    x = _tf_encode(params["blocks"], x, causal=True)
    return layer_norm(x, params["ln_f_s"], params["ln_f_b"])  # [B,S,d]


def sasrec_forward(params: dict, cfg: RecsysConfig, hist_ids, pos_ids, neg_ids):
    """BPR-style: score positive & negative next items from the last state."""
    h = sasrec_encode(params, cfg, hist_ids)[:, -1]  # [B,d]
    v_pos = rows(params["item_table"], pos_ids)
    v_neg = rows(params["item_table"], neg_ids)
    return (h * v_pos).sum(-1), (h * v_neg).sum(-1)


def sasrec_retrieval(params: dict, cfg: RecsysConfig, hist_ids, candidate_ids):
    h = sasrec_encode(params, cfg, hist_ids)[:, -1]
    v_c = rows(params["item_table"], candidate_ids)
    return h @ v_c.T
