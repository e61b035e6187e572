"""Dry-run for one NVIDIA H100: the shapes, memory and FLOPs of a step,
traced on the ``meta`` device with no card and no memory.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gatedgcn --shape ogb_products
    PYTHONPATH=src python -m repro_torch.launch.dryrun            # every arch x cell
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch tinyllama-1.1b --smoke \\
        --shape train_4k --remat full

The parameters, the AdamW state (fp32 ``mu`` and ``nu``, the ``step``) and
the inputs are built from ``build_param_specs`` and ``input_specs`` as meta
tensors, and the cell's step is run on them: ``build_train_step`` (forward,
backward and the AdamW update) for the train kinds, ``build_serve_step`` for
the serve, prefill and decode kinds.  Every op passes a counter
(:class:`Reckoner`):

* **memory**: each new storage adds its bytes, rounded up to the caching
  allocator's 512 B, and subtracts them when it dies; the peak is the
  prediction of ``torch.cuda.max_memory_allocated`` for the same step.
  ``argument_bytes`` are what is live when the step starts (state, inputs
  and any ``resident`` tensors), ``temp_bytes`` the peak above them;
* **FLOPs**: the matmul-like ops of ``torch.utils.flop_counter``, each at
  the peak of the unit that does it (:data:`.analysis.PEAKS`: bf16 products
  on the tensor cores, fp32 ones on the CUDA cores unless TF32 is allowed);
* **bytes accessed**: each op's inputs read and outputs written (a view
  moves nothing; a gather reads no more of its source than it writes), what
  eager execution moves, L2 aside.

The hand-written kernels take their explicit ``meta`` path
(:mod:`repro_torch.kernels.meta`): they allocate what the kernel path
allocates on the card, scratch included, and report their own FLOPs and
bytes; no plain version runs.

One card, so ``chips`` is 1, ``mesh`` is ``"h100"`` and the collective term
is 0.  The port's layers are a Python loop, so every layer is counted and
no scan correction is needed: the reference's ``--unroll``,
``--no-scan-correct``, ``--mesh`` and ``--smoke-mesh`` have no counterpart.
What it keeps of the reference's meshes: the specs that
:mod:`.sharding` resolves for every parameter and input on the production
pod and multi-pod shapes (:mod:`.mesh`), recorded beside the count; nothing
in the port shards.  The full cells are shaped for 256 or 512 chips
(``train_4k`` is B 256 x S 4096): on one card most read ``fits: false``.
Records go to ``results/dryrun/``.
"""
from __future__ import annotations

import argparse
import ast
import dataclasses
import json
import sys
import time
import traceback
import weakref
from pathlib import Path
from typing import Any, Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from ..configs import get_config, get_shapes, list_archs
from ..configs.base import GNNConfig, LMConfig, ShapeCell, input_specs
from ..kernels import meta
from ..models.layers import abstract_params, logical_axes, param_count
from ..optim import init_state
from ..train import build_param_specs, build_serve_step, build_train_step
from . import analysis
from .mesh import make_production_mesh
from .sharding import rules_for, shard_input_specs, tree_shardings

RESULTS_DIR = Path(__file__).resolve().parents[3] / "results" / "dryrun"
CARD_BYTES = 80 * 10**9  # the H100's 80 GB of HBM3
ALLOC_BYTES = 512  # the CUDA caching allocator rounds every block up to this
TRAIN_KINDS = ("train", "full_graph", "minibatch", "batched_graphs")

aten = torch.ops.aten
_EMPTY = {aten.empty.memory_format, aten.empty_strided.default, aten.empty_like.default,
          aten.new_empty.default, aten.new_empty_strided.default}
# gathers: their source (argument 0) is read no more than they write
_GATHER_SOURCE = {aten.embedding.default: 0, aten.index.Tensor: 0,
                  aten.index_select.default: 0, aten.gather.default: 0}
# scatters into self (argument 0): the rows they touch are those of the values
_SCATTER_VALUES = {aten.index_put_.default: 2, aten.index_put.default: 2,
                   aten._index_put_impl_.default: 2, aten.index_add_.default: 3,
                   aten.index_add.default: 3, aten.scatter_add_.default: 3,
                   aten.scatter_add.default: 3, aten.index_copy_.default: 3}


def _nbytes(t: torch.Tensor) -> int:
    """Bytes of a tensor's elements, at most its storage's (a broadcast view
    reads each stored element once)."""
    logical = t.numel() * t.element_size()
    return min(logical, t.untyped_storage().nbytes()) if t.numel() else 0


def _unit(dtype: torch.dtype, allow_tf32: bool) -> str:
    if dtype in (torch.bfloat16, torch.float16):
        return "bf16"
    return "tf32" if dtype == torch.float32 and allow_tf32 else "fp32"


class Reckoner(TorchDispatchMode):
    """Counts what the ops run under it allocate (live and peak bytes, by
    storage, rounded to ALLOC_BYTES), the FLOPs of the matmul-like ops by
    unit, and the bytes every op reads and writes (while ``counting``)."""

    def __init__(self, allow_tf32: bool = False):
        super().__init__()
        self.allow_tf32 = allow_tf32
        self.live = 0
        self.peak = 0
        self._sizes: dict[int, int] = {}  # id of a live storage -> its bytes
        self.counting = False
        self.flops_by_unit: dict[str, float] = {}
        self.bytes = 0.0
        self.ops = 0

    def _free(self, key: int) -> None:
        self.live -= self._sizes.pop(key)

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key, n = id(st), -(-st.nbytes() // ALLOC_BYTES) * ALLOC_BYTES
        old = self._sizes.get(key)
        if old is None:
            weakref.finalize(st, self._free, key)
        elif old >= n:
            return
        self._sizes[key] = n
        self.live += n - (old or 0)
        self.peak = max(self.peak, self.live)

    def _count(self, func, args, kwargs, out) -> None:
        self.ops += 1
        packet = func.overloadpacket
        if packet in flop_registry:
            first = next(t for t in tree_leaves(args) if isinstance(t, torch.Tensor))
            unit = _unit(first.dtype, self.allow_tf32)
            flops = flop_registry[packet](*args, **kwargs, out_val=out)
            self.flops_by_unit[unit] = self.flops_by_unit.get(unit, 0) + flops
        returns = func._schema.returns
        if func in _EMPTY or any(r.alias_info is not None and not r.alias_info.is_write
                                 for r in returns):
            return  # a view or an allocation moves no bytes
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        written = sum(_nbytes(t) for t in outs)
        flat = list(args) + list(kwargs.values())
        cap = {}
        if func in _GATHER_SOURCE:
            cap[_GATHER_SOURCE[func]] = written
        elif func in _SCATTER_VALUES and len(flat) > _SCATTER_VALUES[func]:
            values = flat[_SCATTER_VALUES[func]]
            rows = _nbytes(values) if isinstance(values, torch.Tensor) else 0
            cap[0] = rows
            written = min(written, rows)
        read = 0
        for i, a in enumerate(flat):
            for t in tree_leaves(a):
                if isinstance(t, torch.Tensor):
                    read += min(_nbytes(t), cap.get(i, _nbytes(t)))
        self.bytes += read + written

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self._track(t)
        if self.counting:
            self._count(func, args, kwargs, out)
        return out


# --------------------------------------------------------------------------
# one cell
# --------------------------------------------------------------------------
def apply_cfg_overrides(cfg, overrides: list[str]):
    """--cfg key=value (python literals) -> dataclasses.replace on the config."""
    kw = {}
    for ov in overrides or ():
        key, _, val = ov.partition("=")
        try:
            kw[key] = ast.literal_eval(val)
        except (ValueError, SyntaxError):
            kw[key] = val
    return dataclasses.replace(cfg, **kw) if kw else cfg


def _n_layers(cfg) -> int:
    if isinstance(cfg, (LMConfig, GNNConfig)):
        return cfg.n_layers
    return getattr(cfg, "n_blocks", 1) or 1


def _materialize(spec: Any, device: str) -> Any:
    if isinstance(spec, dict):
        return {k: _materialize(v, device) for k, v in spec.items()}
    if isinstance(spec, (list, tuple)):
        return [_materialize(v, device) for v in spec]
    return torch.empty(spec.shape, dtype=spec.dtype, device=device)


def output_shapes(tree: Any, prefix: str = "") -> dict[str, list]:
    """path -> [shape, dtype] of every tensor of a step's output tree."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(output_shapes(tree[k], f"{prefix}{k}/"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(output_shapes(v, f"{prefix}{i}/"))
        return out
    if isinstance(tree, torch.Tensor):
        return {prefix.rstrip("/"): [list(tree.shape), str(tree.dtype).replace("torch.", "")]}
    return {}


def build_step(cfg, cell: ShapeCell, *, remat: str = "none", grad_accum: int = 1
               ) -> tuple[Callable[[Any], Any], Callable[[Any, dict], Any]]:
    """(make_state, step) of the cell, as a training loop holds them: for the train
    kinds the train state (parameters and a fresh AdamW state) and
    ``build_train_step``'s step, which returns (state, metrics); for the
    others the parameters and ``build_serve_step``'s step."""
    if cell.kind in TRAIN_KINDS:
        train = build_train_step(cfg, cell, remat=remat, grad_accum=grad_accum)
        return (lambda params: {"params": params, "opt": init_state(params)}), train
    serve = build_serve_step(cfg, cell)
    if cell.kind == "decode":
        return (lambda params: params), (lambda params, inputs: serve(
            params, inputs["tokens"], inputs["cache"], inputs["cache_len"]))
    return (lambda params: params), (lambda params, inputs: serve(params, **inputs))


@dataclasses.dataclass
class Trace:
    argument_bytes: int  # live when the step starts
    peak_bytes: int
    flops_by_unit: dict[str, float]
    bytes: float
    ops: int  # aten ops the step ran
    kernels: dict[str, dict]  # kernel -> calls, flops, bytes (their meta paths)
    outputs: dict[str, list]


def trace_step(cfg, cell: ShapeCell, *, remat: str = "none", grad_accum: int = 1,
               resident: dict[str, Any] | None = None) -> Trace:
    """Run the cell's step on meta tensors under a :class:`Reckoner`.  The
    state, the inputs and ``resident`` (a tree of TensorSpecs held on the
    card beside them, such as the batches a training loop keeps) are live before
    the step starts."""
    make_state, step = build_step(cfg, cell, remat=remat, grad_accum=grad_accum)
    specs = build_param_specs(cfg, cell)
    rk = Reckoner(allow_tf32=torch.backends.cuda.matmul.allow_tf32)
    with rk, meta.counting() as kc:
        state = make_state(abstract_params(specs, cfg.dtype, "meta"))
        inputs = _materialize(input_specs(cfg, cell), "meta")
        kept = _materialize(resident or {}, "meta")
        argument_bytes = rk.live
        rk.counting = True
        out = step(state, inputs)
        rk.counting = False
        outputs = output_shapes(out)
        del out, state, inputs, kept
    kernels = {k: {"calls": kc.calls[k], "flops": kc.flops[k], "bytes": kc.bytes[k]}
               for k in sorted(kc.calls)}
    flops = dict(rk.flops_by_unit)
    for unit, n in kc.flops_by_unit.items():
        flops[unit] = flops.get(unit, 0) + n
    return Trace(argument_bytes, rk.peak, flops, rk.bytes + sum(kc.bytes.values()), rk.ops,
                 kernels, outputs)


def _json_specs(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _json_specs(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_json_specs(v) for v in tree]
    return [list(a) if isinstance(a, tuple) else a for a in tree]


def shardings(cfg, cell: ShapeCell) -> dict:
    """The specs :mod:`.sharding` resolves for every parameter and input on
    the reference's production pod and multi-pod meshes (nothing shards on
    one card; the record keeps them)."""
    specs, rules = build_param_specs(cfg, cell), rules_for(cfg)
    out = {}
    for name, multi_pod in (("pod", False), ("multipod", True)):
        mesh = make_production_mesh(multi_pod=multi_pod)
        out[name] = {"params": _json_specs(tree_shardings(logical_axes(specs), specs, mesh,
                                                         rules)),
                     "inputs": _json_specs(shard_input_specs(cfg, cell, mesh))}
    return out


def run_cell(
    arch: str,
    cell: ShapeCell,
    *,
    remat: str = "none",
    grad_accum: int = 1,
    cfg_overrides: list[str] | None = None,
    tag: str = "",
    smoke: bool = False,
    resident: dict[str, Any] | None = None,
) -> dict:
    """The record of one (arch x cell) step on one H100: the reference's
    keys where they mean something on one card.  ``smoke`` takes the arch's
    smoke config; ``resident`` (a tree of TensorSpecs) is held beside the
    step, as a training loop holds its other batches."""
    cfg = apply_cfg_overrides(get_config(arch, smoke=smoke), cfg_overrides or [])
    rec: dict = {
        "arch": arch,
        "shape": cell.name,
        "kind": cell.kind,
        "cell": dict(cell.params),
        "mesh": "h100",
        "chips": 1,
        "remat": remat,
        "grad_accum": grad_accum,
        "tag": tag,
        "cfg_overrides": list(cfg_overrides or []),
        "smoke": smoke,
    }
    if isinstance(cfg, LMConfig) and cell.name == "long_500k" and not cfg.sub_quadratic:
        rec["status"] = "skipped"
        rec["reason"] = "pure full-attention arch; 500k dense KV excluded (DESIGN §4)"
        return rec

    t0 = time.time()
    try:
        tr = trace_step(cfg, cell, remat=remat, grad_accum=grad_accum, resident=resident)
    except Exception as e:  # noqa: BLE001 - a failed cell is a record, not a crash
        rec["status"] = "failed"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
        return rec
    flops = float(sum(tr.flops_by_unit.values()))
    terms = analysis.RooflineTerms(flops=flops, hbm_bytes=tr.bytes, coll_bytes=0.0, chips=1,
                                   flops_by_peak=tr.flops_by_unit)
    mflops = analysis.model_flops(cfg, cell)
    peak = analysis.PEAKS[_unit(cfg.dtype, torch.backends.cuda.matmul.allow_tf32)]
    rec.update(
        status="ok",
        trace_s=round(time.time() - t0, 3),
        scan_corrected=False,
        n_layers=_n_layers(cfg),
        n_params=param_count(build_param_specs(cfg, cell)),
        memory={
            "argument_bytes": tr.argument_bytes,
            "temp_bytes": tr.peak_bytes - tr.argument_bytes,
            "peak_hbm_bytes": tr.peak_bytes,
            "card_bytes": CARD_BYTES,
        },
        fits=tr.peak_bytes < CARD_BYTES,
        roofline=terms.as_dict(),
        collectives={"bytes_by_kind": {}, "count_by_kind": {}},
        model_flops_global=mflops,
        model_flops_per_chip=mflops,
        useful_flops_ratio=(mflops / flops) if flops else None,
        roofline_fraction=terms.roofline_fraction(mflops, peak),
        aten_ops=tr.ops,
        kernels=tr.kernels,
        outputs=tr.outputs,
        shardings=shardings(cfg, cell),
    )
    return rec


def scaled_cell(cell: ShapeCell, n_nodes: int) -> ShapeCell:
    """A graph cell cut in scale, not in shape: ``n_nodes`` nodes and the
    edges that keep the published edges a node."""
    p = dict(cell.params)
    p["n_edges"] = round(n_nodes * p["n_edges"] / p["n_nodes"])
    p["n_nodes"] = n_nodes
    return ShapeCell(cell.name, cell.kind, p, cell.note)


def largest_under(reckon: Callable[[int], dict], lo: int, hi: int, step: int,
                  budget: int) -> tuple[int, dict | None]:
    """The largest x in lo, lo + step, ... <= hi whose record ``reckon(x)``
    peaks under ``budget`` bytes (lo - step and None if not one does).  The
    peak grows with x, nearly as a line: two probes place the first guess,
    then the walk goes a step at a time to the boundary."""
    def peak(x: int) -> tuple[int, dict]:
        rec = reckon(x)
        if rec["status"] != "ok":
            raise RuntimeError(f"dry-run at {x}: {rec.get('error', rec.get('reason'))}")
        return rec["memory"]["peak_hbm_bytes"], rec

    snap = lambda x: min(hi, max(lo, lo + (x - lo) // step * step))
    x1, x2 = lo, snap(lo + max(step, (hi - lo) // 4))
    (p1, r1), (p2, r2) = peak(x1), peak(x2) if x2 != x1 else peak(x1)
    guess = x1 if p2 == p1 else snap(x1 + int((budget - p1) * (x2 - x1) / (p2 - p1)))
    known = {x1: (p1, r1), x2: (p2, r2)}
    x = guess
    p, rec = known.get(x) or peak(x)
    while p >= budget and x > lo:
        x -= step
        p, rec = known.get(x) or peak(x)
    if p >= budget:
        return lo - step, None
    while x + step <= hi:
        q, r = known.get(x + step) or peak(x + step)
        if q >= budget:
            break
        x, p, rec = x + step, q, r
    return x, rec


def largest_cut(arch: str, cell: ShapeCell, budget: int, step: int = 512,
                **kw) -> tuple[ShapeCell, dict]:
    """The largest node count, a multiple of ``step`` (input_specs pads a
    graph's nodes to 512 anyway), with the edges cut by the same factor,
    whose dry-run peak lies under ``budget`` bytes; and its record."""
    n_full = cell.params["n_nodes"]
    n, rec = largest_under(
        lambda n: run_cell(arch, scaled_cell(cell, n), **kw),
        step, n_full // step * step, step, budget)
    if rec is None:
        raise RuntimeError(f"no cut of {arch} {cell.name} fits {budget} B")
    return scaled_cell(cell, n), rec


def batch_cut(cell: ShapeCell, global_batch: int) -> ShapeCell:
    """An LM cell at another ``global_batch``: its sequence length, and with
    it ``cache_len``, stay the published ones."""
    return ShapeCell(cell.name, cell.kind, {**cell.params, "global_batch": global_batch},
                     cell.note)


def largest_batch(arch: str, cell: ShapeCell, budget: int, step: int = 1,
                  **kw) -> tuple[ShapeCell, dict]:
    """The largest ``global_batch``, a multiple of ``step`` up to the
    published one, whose dry-run peak lies under ``budget`` bytes: the cut
    cell and its record."""
    full = cell.params["global_batch"]
    B, rec = largest_under(lambda b: run_cell(arch, batch_cut(cell, b), **kw),
                           step, full // step * step, step, budget)
    if rec is None:
        raise RuntimeError(f"no batch of {arch} {cell.name} fits {budget} B")
    return batch_cut(cell, B), rec


def fit(arch: str, cell: ShapeCell, budget: int, **kw) -> tuple[ShapeCell, list[str], dict, dict]:
    """The cut of an LM cell that one card holds under ``budget`` bytes: the
    batch first, down to one row, then the depth.  Returns the cell, the
    config overrides (``n_layers=L`` where the depth is cut), the cuts as
    ``{"global_batch": [published, cut], "n_layers": [...]}`` (empty where the
    whole cell fits) and the cut's record."""
    rec = run_cell(arch, cell, **kw)
    B = cell.params["global_batch"]
    if rec["status"] != "ok" or rec["memory"]["peak_hbm_bytes"] < budget:
        return cell, [], {}, rec
    cuts = {}
    if B > 1:
        one = run_cell(arch, batch_cut(cell, 1), **kw)
        if one["memory"]["peak_hbm_bytes"] < budget:
            cut, rec = largest_batch(arch, cell, budget, **kw)
            return cut, [], {"global_batch": [B, cut.params["global_batch"]]}, rec
        cell, cuts = batch_cut(cell, 1), {"global_batch": [B, 1]}
    full = rec["n_layers"]
    L, rec = deepest(arch, cell, budget, **kw)
    if rec is None:
        raise RuntimeError(f"not one layer of {arch} {cell.name} fits {budget} B")
    return cell, [f"n_layers={L}"], {**cuts, "n_layers": [full, L]}, rec


def fit_train(arch: str, cell: ShapeCell, budget: int, **kw) -> tuple[str, dict]:
    """The cut of a train cell and the remat it runs under: :func:`fit` at
    remat none (the reference's default); where that cuts the depth, at
    remat full too; the remat whose cut keeps more layers (none where they
    tie).  Returns (remat, {remat: fit's result})."""
    fits = {"none": fit(arch, cell, budget, **kw)}
    if "n_layers" in fits["none"][2]:
        fits["full"] = fit(arch, cell, budget, **kw, remat="full")
    return max(fits, key=lambda r: fits[r][3]["n_layers"]), fits


def deepest(arch: str, cell: ShapeCell, budget: int, *, cfg_overrides: list[str] | None = None,
            **kw) -> tuple[int, dict | None]:
    """The most layers of ``arch`` whose dry-run peak lies under ``budget``
    bytes (0 if not one does), and that depth's record."""
    full = apply_cfg_overrides(get_config(arch), cfg_overrides or []).n_layers
    return largest_under(
        lambda L: run_cell(arch, cell, cfg_overrides=[*(cfg_overrides or []), f"n_layers={L}"],
                           **kw),
        1, full, 1, budget)


def main() -> None:
    ap = argparse.ArgumentParser(
        description="dry-run for one H100: trace each cell's step on the meta device")
    ap.add_argument("--arch", default=None, help="arch id (default: all)")
    ap.add_argument("--shape", default=None, help="shape cell name (default: all)")
    ap.add_argument("--smoke", action="store_true", help="the arch's smoke config")
    ap.add_argument("--remat", default="none")
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument(
        "--cfg", action="append", default=[],
        help="config override key=value (python literal), repeatable",
    )
    ap.add_argument("--tag", default="", help="experiment tag")
    ap.add_argument("--fit", type=float, default=None, metavar="BYTES",
                    help="LM cells: print the largest batch (or depth, at B 1) whose "
                         "reckoned peak lies under BYTES, e.g. 75e9")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    archs = [args.arch] if args.arch else list_archs()
    out_dir = Path(args.out) if args.out else RESULTS_DIR
    out_dir.mkdir(parents=True, exist_ok=True)

    n_ok = n_fail = n_skip = 0
    for arch in archs:
        for cell in get_shapes(arch):
            if args.shape and cell.name != args.shape:
                continue
            if args.fit is not None and cell.kind in ("prefill", "decode", "train"):
                _, _, cuts, rec = fit(arch, cell, int(args.fit), remat=args.remat,
                                      cfg_overrides=args.cfg, smoke=args.smoke)
                n_ok += rec["status"] == "ok"
                n_fail += rec["status"] == "failed"
                n_skip += rec["status"] == "skipped"
                if rec["status"] != "ok":
                    print(f"[{rec['status']}] {arch:18s} {cell.name:13s} "
                          f"{rec.get('reason', rec.get('error'))}", flush=True)
                    continue
                said = ", ".join(f"{k} {c} of {f}" for k, (f, c) in cuts.items()) or "not cut"
                print(f"[fit] {arch:18s} {cell.name:13s} {said}: reckoned peak "
                      f"{rec['memory']['peak_hbm_bytes']} B under {int(args.fit)}, roofline "
                      f"{rec['roofline']['step_time_s'] * 1e3:.3f} ms", flush=True)
                continue
            rec = run_cell(arch, cell, remat=args.remat, grad_accum=args.grad_accum,
                           cfg_overrides=args.cfg, tag=args.tag, smoke=args.smoke)
            suffix = f"__{args.tag}" if args.tag else ""
            fname = f"{arch}__{cell.name}__{rec['mesh']}{suffix}.json"
            (out_dir / fname).write_text(json.dumps(rec, indent=1))
            status = rec["status"]
            n_ok += status == "ok"
            n_fail += status == "failed"
            n_skip += status == "skipped"
            if status == "ok":
                r = rec["roofline"]
                print(
                    f"[ok] {arch:18s} {cell.name:13s} {rec['mesh']:6s} "
                    f"trace={rec['trace_s']:7.2f}s peak_hbm="
                    f"{rec['memory']['peak_hbm_bytes'] / 2**30:9.2f}GiB fits={rec['fits']!s:5s} "
                    f"dom={r['dominant']:10s} step={r['step_time_s'] * 1e3:11.3f}ms "
                    f"RF={rec['roofline_fraction']:.3f}",
                    flush=True,
                )
            elif status == "skipped":
                print(f"[skip] {arch:18s} {cell.name:13s} {rec['reason']}", flush=True)
            else:
                print(f"[FAIL] {arch:18s} {cell.name:13s} {rec['mesh']:6s} {rec['error']}",
                      flush=True)
    print(f"dry-run complete: ok={n_ok} failed={n_fail} skipped={n_skip}")
    if n_fail:
        sys.exit(1)


if __name__ == "__main__":
    main()
