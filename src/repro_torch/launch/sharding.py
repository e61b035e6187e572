"""Logical-axis -> mesh-axis resolution with divisibility-aware fallback.

Every param/input dim carries a logical axis name (models/layers.PSpec); the
rules below map names to candidate mesh axes in priority order.  A candidate
is taken only if (a) its mesh axes are unused by this array and (b) its total
way-count divides the dim.  This realizes the DESIGN §5 policies mechanically:

  * gemma3-4b: 8 heads fail 16-way "model" -> the head_dim entry picks it up
  * qwen2-moe: 60 experts fail -> per-expert d_ff ("expert_ff") takes "model"
  * deepseek-v2: config overrides route "experts" to the data axis (EP) while
    "expert_ff" keeps "model"

The port runs on one card and shards nothing: a spec is a tuple of mesh-axis
names (or tuples of them, for a dim over several axes), the stand-in for the
reference's ``PartitionSpec``, and ``tree_shardings`` and
``shard_input_specs`` give trees of specs, not ``NamedSharding``s.  The
dry-run records them against the reference's mesh shapes (:mod:`.mesh`).
"""
from __future__ import annotations

import math
from typing import Any, Mapping

from ..configs.base import (
    Config,
    GNNConfig,
    LMConfig,
    RecsysConfig,
    ShapeCell,
    TensorSpec,
)

Cand = tuple  # tuple of mesh axes used jointly
Spec = tuple  # per dim: None, a mesh axis, or a tuple of them; trailing Nones dropped

# name -> candidates in priority order; each candidate is a tuple of mesh axes
DEFAULT_RULES: dict[str, tuple[Cand, ...]] = {
    # data-ish dims
    "batch": (("pod", "data"), ("data",)),
    "nodes": (("pod", "data"), ("data",)),
    "edges": (("pod", "data"), ("data",)),
    "candidates": (("pod", "data"), ("data",)),
    "kv_seq": (("data",), ("pod", "data")),
    # tensor-parallel dims
    "vocab": (("model",),),
    "ff": (("model",),),
    "heads": (("model",),),
    "kv_heads": (("model",),),
    # NOTE: no head_dim fallback — sharding within a head mismatches the
    # q-side (heads) sharding and triggers involuntary SPMD remat copies;
    # replicating non-divisible (small) KV projections is strictly better.
    "head_dim": (),
    "qkv": (("model",),),
    "experts": (("model",),),
    "expert_ff": (("model",),),
    "table_vocab": (("model",),),
    "mlp_hidden": (("model",),),
    # attention weight storage dims: replicated by default ("heads" carries
    # the TP); overridden per-arch when heads don't divide the model axis
    "attn_in": (),
    "attn_out": (),
    # replicated dims
    "experts_r": (),
    "embed": (),
    "embed_dim": (),
    "seq": (),
    "layers": (),
    "q_lora": (),
    "kv_lora": (),
    "hidden": (),
    "classes": (),
    "node_feat": (),
    "edge_feat": (),
    "mlp_in": (),
    "x0": (),
}


def rules_for(cfg: Config) -> dict[str, tuple[Cand, ...]]:
    rules = dict(DEFAULT_RULES)
    for name, axes in getattr(cfg, "shard_overrides", ()) or ():
        # overrides REPLACE the rule: empty axes means force-replicate
        rules[name] = (tuple(axes),) if axes else ()
    return rules


def resolve_spec(
    axes: tuple[str | None, ...],
    shape: tuple[int, ...],
    mesh: Mapping[str, int],
    rules: Mapping[str, tuple[Cand, ...]],
) -> Spec:
    """``mesh`` maps each mesh axis to its size (:mod:`.mesh`)."""
    used: set[str] = set()
    out: list[Any] = []
    for name, dim in zip(axes, shape):
        assigned = None
        if name is not None:
            for cand in rules.get(name, ()):
                cand = tuple(cand)
                if not cand:
                    continue
                if any(c in used or c not in mesh for c in cand):
                    continue
                ways = math.prod(mesh[c] for c in cand)
                if ways <= 1 or dim % ways != 0:
                    continue
                assigned = cand if len(cand) > 1 else cand[0]
                used.update(cand)
                break
        out.append(assigned)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def _is_axes(x: Any) -> bool:
    return isinstance(x, tuple) and all(a is None or isinstance(a, str) for a in x)


def tree_shardings(axes_tree: Any, shape_tree: Any, mesh: Mapping[str, int], rules) -> Any:
    """axes_tree: tree of axis-tuples; shape_tree: matching tree of shaped
    objects (PSpec / TensorSpec / tensors).  Returns the tree of specs."""
    if _is_axes(axes_tree):
        return resolve_spec(axes_tree, tuple(shape_tree.shape), mesh, rules)
    if isinstance(axes_tree, dict):
        return {k: tree_shardings(axes_tree[k], shape_tree[k], mesh, rules) for k in axes_tree}
    if isinstance(axes_tree, list):
        return [tree_shardings(a, s, mesh, rules) for a, s in zip(axes_tree, shape_tree)]
    raise TypeError(f"tree_shardings: {type(axes_tree)} is not an axes tree")


# --------------------------------------------------------------------------
# input logical axes per family/cell (mirrors configs.base.input_specs)
# --------------------------------------------------------------------------
def input_axes(cfg: Config, cell: ShapeCell) -> dict[str, Any]:
    if isinstance(cfg, LMConfig):
        if cell.kind == "train":
            return {"tokens": ("batch", "seq"), "targets": ("batch", "seq")}
        if cell.kind == "prefill":
            return {"tokens": ("batch", "seq")}
        if cell.kind == "decode":
            if cfg.mla is not None:
                cache = {
                    "c_kv": ("layers", "batch", "kv_seq", "kv_lora"),
                    "k_rope": ("layers", "batch", "kv_seq", None),
                }
            else:
                cache = {
                    "k": ("layers", "batch", "kv_seq", "kv_heads", "head_dim"),
                    "v": ("layers", "batch", "kv_seq", "kv_heads", "head_dim"),
                }
            return {"tokens": ("batch", None), "cache": cache, "cache_len": ("batch",)}
    if isinstance(cfg, GNNConfig):
        if cell.kind == "full_graph":
            return {
                "node_feat": ("nodes", None),
                "edge_index": (None, "edges"),
                "labels": ("nodes",),
                "train_mask": ("nodes",),
            }
        if cell.kind == "minibatch":
            return {
                "node_feat": ("nodes", None),
                "edge_index": (None, "edges"),
                "labels": ("batch",),
                "seed_ids": ("batch",),
            }
        if cell.kind == "batched_graphs":
            return {
                "node_feat": ("batch", None, None),
                "edge_index": ("batch", None, None),
                "labels": ("batch",),
            }
    if isinstance(cfg, RecsysConfig):
        base = {
            "dense": ("batch", None),
            "sparse_ids": ("batch", None),
            "hist_ids": ("batch", None),
            "target_id": ("batch",),
            "pos_ids": ("batch",),
            "neg_ids": ("batch",),
            "labels": ("batch",),
            "candidate_ids": ("candidates",),
        }
        from ..configs.base import input_specs

        return {k: base[k] for k in input_specs(cfg, cell)}
    raise TypeError((type(cfg), cell.kind))


def shard_input_specs(cfg: Config, cell: ShapeCell, mesh: Mapping[str, int]) -> dict[str, Any]:
    """The spec of every input of ``input_specs(cfg, cell)``, in its tree."""
    from ..configs.base import input_specs

    rules = rules_for(cfg)
    specs = input_specs(cfg, cell)
    axes = input_axes(cfg, cell)

    def attach(spec, ax):
        if isinstance(spec, dict):
            return {k: attach(spec[k], ax[k]) for k in spec}
        assert isinstance(spec, TensorSpec)
        return resolve_spec(ax, spec.shape, mesh, rules)

    return {k: attach(specs[k], axes[k]) for k in specs}
