"""Step analysis for one NVIDIA H100: HLO collective parsing, roofline terms
and the analytic model FLOPs.

Hardware model: one H100 SXM 80GB HBM3 at its 700 W power limit, from
NVIDIA's data sheet (dense rates, no sparsity):
  bf16 on the tensor cores 989 TFLOP/s; TF32 on the tensor cores 495;
  fp32 on the CUDA cores 67; HBM3 3.35 TB/s.
Each FLOP is divided by the peak of the op that does it (``PEAKS``): a bf16
GEMM at the bf16 rate, an fp32 GEMM at the CUDA cores' rate (the port's
card runs set ``torch.backends.cuda.matmul.allow_tf32 = False``), the fp32
flash kernels (``tf32x3``: each fp32 product as three TF32 products) at a
third of the TF32 rate, and the kernels whose fp32 work is not products
(aggregation, the embedding bag, the split and fused decode variants) at
the CUDA cores' rate.

One card moves nothing between chips: the collective term stays in the
record and is 0, and no link rate is stated.  ``parse_collectives`` and
``scan_correct`` are kept, verbatim, for HLO text that the reference's
dry-run writes; the port's own dry-run (:mod:`.dryrun`) counts every layer
of its Python loop and needs no scan correction.
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field

PEAKS = {  # FLOP/s of one H100 SXM by the unit that does the work
    "bf16": 989e12,  # bf16 (and fp16) on the tensor cores
    "tf32": 495e12,  # fp32 GEMMs with allow_tf32
    "tf32x3": 495e12 / 3,  # the fp32 flash kernels: three TF32 passes a product
    "fp32": 67e12,  # the CUDA cores
}
PEAK_FLOPS = PEAKS["bf16"]
HBM_BW = 3.35e12  # B/s

_DTYPE_BYTES = {
    "pred": 1, "s4": 1, "u4": 1, "s8": 1, "u8": 1,
    "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4,
    "s64": 8, "u64": 8, "f64": 8, "c64": 8, "c128": 16,
    "f8e4m3fn": 1, "f8e5m2": 1, "f8e4m3": 1, "f8e3m4": 1, "f8e4m3b11fnuz": 1,
    "token": 0, "opaque": 0,
}

_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")
_INSTR_RE = re.compile(
    r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=\s*(.+?)\s+"
    r"([a-z][\w\-]*)\((.*)\)", re.ASCII
)
COLLECTIVES = (
    "all-gather",
    "all-reduce",
    "reduce-scatter",
    "all-to-all",
    "collective-permute",
)


def _type_bytes(type_str: str) -> int:
    total = 0
    for dt, dims in _SHAPE_RE.findall(type_str):
        if dt not in _DTYPE_BYTES:
            continue
        n = 1
        if dims:
            for d in dims.split(","):
                n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


@dataclass
class CollectiveStats:
    """Per-chip bytes moved over ICI, by collective kind."""

    bytes_by_kind: dict[str, float] = field(default_factory=dict)
    count_by_kind: dict[str, int] = field(default_factory=dict)

    @property
    def total_bytes(self) -> float:
        return sum(self.bytes_by_kind.values())

    def add(self, kind: str, nbytes: float) -> None:
        self.bytes_by_kind[kind] = self.bytes_by_kind.get(kind, 0.0) + nbytes
        self.count_by_kind[kind] = self.count_by_kind.get(kind, 0) + 1


def parse_collectives(hlo_text: str) -> CollectiveStats:
    """Sum per-chip ICI traffic from post-SPMD HLO.

    Cost model per op (ring algorithms, (N-1)/N ~ 1):
      all-reduce:          2 x result bytes
      all-gather:          result - operands (received shards)
      reduce-scatter:      operands - result
      all-to-all:          operand bytes
      collective-permute:  operand bytes
    """
    # first pass: result bytes of every named instruction
    sizes: dict[str, int] = {}
    instrs: list[tuple[str, str, str, str]] = []
    for line in hlo_text.splitlines():
        m = _INSTR_RE.match(line)
        if not m:
            continue
        name, type_str, opcode, args = m.groups()
        sizes[name] = _type_bytes(type_str)
        if any(opcode.startswith(c) for c in COLLECTIVES):
            instrs.append((name, type_str, opcode, args))

    stats = CollectiveStats()
    for name, type_str, opcode, args in instrs:
        result_b = sizes[name]
        opnames = re.findall(r"%?([\w.\-]+)", args)
        operand_b = sum(sizes.get(o, 0) for o in opnames if o in sizes)
        kind = next(c for c in COLLECTIVES if opcode.startswith(c))
        if kind == "all-reduce":
            moved = 2.0 * result_b
        elif kind == "all-gather":
            moved = max(result_b - operand_b, result_b // 2)
        elif kind == "reduce-scatter":
            moved = max(operand_b - result_b, result_b)
        else:  # all-to-all, collective-permute
            moved = operand_b or result_b
        stats.add(kind, float(moved))
    return stats


def scan_correct(q1: float, q2: float, n_layers: int) -> float:
    """fixed+body, fixed+2*body -> fixed + L*body."""
    body = max(q2 - q1, 0.0)
    return q1 + (n_layers - 1) * body


@dataclass
class RooflineTerms:
    flops: float  # FLOPs of one step on the card
    hbm_bytes: float  # bytes accessed
    coll_bytes: float  # bytes between chips: 0 on one card
    chips: int
    # FLOPs by the PEAKS key of the unit that does them; empty: all at PEAK_FLOPS
    flops_by_peak: dict[str, float] = field(default_factory=dict)

    @property
    def compute_s(self) -> float:
        if not self.flops_by_peak:
            return self.flops / PEAK_FLOPS
        return sum(n / PEAKS[k] for k, n in self.flops_by_peak.items())

    @property
    def memory_s(self) -> float:
        return self.hbm_bytes / HBM_BW

    @property
    def collective_s(self) -> float:
        """0: one card has no link to another."""
        return 0.0

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """Roofline step time: max of the three terms (perfect overlap)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    def roofline_fraction(self, model_flops_per_chip: float, peak: float = PEAK_FLOPS) -> float:
        """Useful-FLOPs throughput / peak — the MFU-at-roofline score; ``peak``
        is the rate of the model's working dtype (bf16 unless given)."""
        if self.step_time_s == 0:
            return 0.0
        return (model_flops_per_chip / self.step_time_s) / peak

    def as_dict(self) -> dict:
        return {
            "flops_per_chip": self.flops,
            "hbm_bytes_per_chip": self.hbm_bytes,
            "coll_bytes_per_chip": self.coll_bytes,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "step_time_s": self.step_time_s,
            "flops_by_peak": dict(self.flops_by_peak),
        }


# --------------------------------------------------------------------------
# analytic MODEL_FLOPS per family (the "useful compute" numerator)
# --------------------------------------------------------------------------
def model_flops(cfg, cell) -> float:
    """Global useful FLOPs for one step of (cfg, cell)."""
    from ..configs.base import GNNConfig, LMConfig, RecsysConfig

    if isinstance(cfg, LMConfig):
        n_active = cfg.n_active_params()
        p = cell.params
        B, S = p["global_batch"], p["seq_len"]
        if cell.kind == "train":
            # 6*N*D + causal attention 6*L*B*S^2*(Hq*dh) (12*.. * 0.5 causal)
            attn = 6 * cfg.n_layers * B * S * S * cfg.n_heads * cfg.head_dim
            if cfg.local_global is not None:
                n_loc, n_glob = cfg.local_global
                w = min(cfg.local_window, S)
                frac = (n_loc * (w / S) + n_glob) / (n_loc + n_glob)
                attn *= frac
            return 6.0 * n_active * B * S + attn
        if cell.kind == "prefill":
            attn = 3 * cfg.n_layers * B * S * S * cfg.n_heads * cfg.head_dim
            if cfg.local_global is not None:
                n_loc, n_glob = cfg.local_global
                w = min(cfg.local_window, S)
                frac = (n_loc * (w / S) + n_glob) / (n_loc + n_glob)
                attn *= frac
            return 2.0 * n_active * B * S + attn
        # decode: one token per sequence
        if cfg.mla is not None:
            r = cfg.mla.kv_lora_rank + cfg.mla.rope_head_dim
            attn = 4.0 * cfg.n_layers * B * S * r * cfg.n_heads / cfg.n_heads
            attn = 4.0 * cfg.n_layers * B * S * (r + cfg.mla.kv_lora_rank)
        else:
            attn = 4.0 * cfg.n_layers * B * S * cfg.n_kv_heads * cfg.head_dim
        if cfg.local_global is not None:
            n_loc, n_glob = cfg.local_global
            w = min(cfg.local_window, S)
            frac = (n_loc * (w / S) + n_glob) / (n_loc + n_glob)
            attn *= frac
        return 2.0 * n_active * B + attn
    if isinstance(cfg, GNNConfig):
        p = cell.params
        d = cfg.d_hidden
        if cell.kind == "batched_graphs":
            n = p["batch"] * p["n_nodes"]
            e = p["batch"] * p["n_edges"]
        elif cell.kind == "minibatch":
            n = p["batch_nodes"] * (1 + p["fanout1"] + p["fanout1"] * p["fanout2"])
            e = p["batch_nodes"] * (p["fanout1"] + p["fanout1"] * p["fanout2"])
        else:
            n, e = p["n_nodes"], p["n_edges"]
        per_layer = 2 * n * d * d * 2 + 2 * e * d * d * 3 + 8 * e * d
        fwd = cfg.n_layers * per_layer + 2 * n * p.get("d_feat", 16) * d
        return 3.0 * fwd  # train: fwd + bwd
    if isinstance(cfg, RecsysConfig):
        p = cell.params
        B = p["batch"]
        d = cfg.embed_dim
        fwd = 0.0
        if cfg.interaction == "fm-2way":
            fwd = 2.0 * B * cfg.n_sparse * d
        elif cfg.interaction == "cross":
            d0 = cfg.n_dense + cfg.n_sparse * d
            fwd = cfg.n_cross_layers * 2 * B * d0 * d0
            dims = [d0] + list(cfg.mlp) + [1]
            fwd += sum(2 * B * a * b for a, b in zip(dims, dims[1:]))
        elif cfg.interaction in ("transformer-seq", "self-attn-seq"):
            S = cfg.seq_len + (1 if cfg.interaction == "transformer-seq" else 0)
            per_block = 8 * S * d * d + 4 * S * S * d + 16 * S * d * d
            fwd = B * max(cfg.n_blocks, 1) * per_block
            if cfg.mlp:
                d_in = S * d
                dims = [d_in] + list(cfg.mlp) + [1]
                fwd += sum(2 * B * a * b for a, b in zip(dims, dims[1:]))
        if cell.kind == "retrieval":
            fwd += 2.0 * p["n_candidates"] * d * B
        mult = 3.0 if cell.kind == "train" else 1.0
        return mult * fwd
    raise TypeError(type(cfg))
