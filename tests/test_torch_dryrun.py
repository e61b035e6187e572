"""The port's dry-run modules against the reference package, on the CPU:
``model_flops``, the parameter counts and the input specs of every arch x
cell, ``resolve_spec`` of every parameter leaf on the pod and multi-pod mesh
shapes, and ``parse_collectives`` / ``scan_correct`` on HLO text; then the
port's dry-run itself (``repro_torch.launch.dryrun``, the meta device): its
memory counter, the cut and depth searches and its CLI.

The reference's ``repro.launch.dryrun`` is never imported: its first line
sets XLA_FLAGS to 512 host devices for the whole process.  Everything here
is exact (integers, FLOP formulas, specs)."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import numpy as np
from jax.sharding import PartitionSpec as P

from repro.configs import get_config as jax_config
from repro.configs import get_shapes as jax_shapes
from repro.configs import input_specs as jax_input_specs
from repro.launch import analysis as jax_analysis
from repro.launch import sharding as jax_sharding
from repro.models.layers import param_count as jax_param_count
from repro.train import build_param_specs as jax_param_specs
from repro_torch.configs import ShapeCell, get_config, get_shapes, input_specs, list_archs
from repro_torch.launch import analysis, dryrun, mesh, sharding
from repro_torch.models.layers import PSpec, logical_axes, param_count
from repro_torch.train import build_param_specs

ROOT = Path(__file__).resolve().parents[1]
PAIRS = [(arch, cell.name) for arch in list_archs() for cell in get_shapes(arch)]


def _cells(arch, name):
    jcell = next(c for c in jax_shapes(arch) if c.name == name)
    tcell = next(c for c in get_shapes(arch) if c.name == name)
    return jcell, tcell


def test_archs_and_cells_match_reference():
    from repro.configs import list_archs as jax_archs

    assert list_archs() == jax_archs()
    for arch in list_archs():
        assert [c.name for c in get_shapes(arch)] == [c.name for c in jax_shapes(arch)]


@pytest.mark.parametrize("arch,name", PAIRS)
def test_model_flops_equal_reference(arch, name):
    jcell, tcell = _cells(arch, name)
    assert analysis.model_flops(get_config(arch), tcell) == jax_analysis.model_flops(
        jax_config(arch), jcell)


@pytest.mark.parametrize("arch,name", PAIRS)
def test_param_count_equals_reference(arch, name):
    jcell, tcell = _cells(arch, name)
    want = jax_param_count(jax_param_specs(jax_config(arch), jcell))
    assert param_count(build_param_specs(get_config(arch), tcell)) == want


def _flat_specs(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat_specs(tree[k], f"{prefix}{k}/"))
        return out
    return {prefix.rstrip("/"): (tuple(tree.shape), str(np.dtype(tree.dtype)) if not
                                 isinstance(tree.dtype, torch.dtype)
                                 else str(tree.dtype).replace("torch.", ""))}


@pytest.mark.parametrize("arch,name", PAIRS)
def test_input_specs_equal_reference(arch, name):
    jcell, tcell = _cells(arch, name)
    want = _flat_specs(jax_input_specs(jax_config(arch), jcell))
    assert _flat_specs(input_specs(get_config(arch), tcell)) == want


class _FakeMesh:
    def __init__(self, shape):
        self.shape = shape


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


@pytest.mark.parametrize("multi_pod", [False, True], ids=["pod", "multipod"])
@pytest.mark.parametrize("arch", list_archs())
def test_resolve_spec_equals_reference_on_every_parameter_leaf(arch, multi_pod):
    shape = mesh.make_production_mesh(multi_pod=multi_pod)
    fake = _FakeMesh(shape)
    cell_name = get_shapes(arch)[0].name
    jcell, tcell = _cells(arch, cell_name)
    jcfg, tcfg = jax_config(arch), get_config(arch)
    jrules, trules = jax_sharding.rules_for(jcfg), sharding.rules_for(tcfg)
    jl = list(_leaves(jax_param_specs(jcfg, jcell)))
    tl = list(_leaves(build_param_specs(tcfg, tcell)))
    assert len(jl) == len(tl) and all(isinstance(t, PSpec) for t in tl)
    for j, t in zip(jl, tl):
        assert (j.shape, j.axes) == (t.shape, t.axes)
        want = tuple(jax_sharding.resolve_spec(j.axes, j.shape, fake, jrules))
        assert sharding.resolve_spec(t.axes, t.shape, shape, trules) == want
    specs = build_param_specs(tcfg, tcell)
    tree = sharding.tree_shardings(logical_axes(specs), specs, shape, trules)
    assert list(_leaves(tree)) == [
        tuple(jax_sharding.resolve_spec(j.axes, j.shape, fake, jrules)) for j in jl]


def test_resolve_spec_divisibility_fallbacks():
    """The case list of the reference's tests/test_dryrun.py."""
    shape = {"pod": 2, "data": 16, "model": 16}
    rules = dict(sharding.DEFAULT_RULES)
    assert sharding.resolve_spec(("embed", "heads", "head_dim"), (4096, 32, 128), shape,
                                 rules) == tuple(P(None, "model"))
    assert sharding.resolve_spec(("embed", "heads", "head_dim"), (2560, 8, 256), shape,
                                 rules) == tuple(P())
    assert sharding.resolve_spec(("experts", "embed", "expert_ff"), (60, 2048, 1408), shape,
                                 rules) == tuple(P(None, None, "model"))
    r2 = sharding.rules_for(get_config("deepseek-v2-236b"))
    assert sharding.resolve_spec(("experts", "embed", "expert_ff"), (160, 5120, 1536), shape,
                                 r2) == tuple(P("data", None, "model"))
    assert sharding.resolve_spec(("batch", "seq"), (256, 4096), shape, rules) == tuple(
        P(("pod", "data")))
    assert sharding.resolve_spec(("batch", "kv_seq"), (1, 524288), shape, rules) == tuple(
        P(None, "data"))


@pytest.mark.parametrize("multi_pod", [False, True], ids=["pod", "multipod"])
@pytest.mark.parametrize("arch,name", PAIRS)
def test_input_shardings_equal_reference(arch, name, multi_pod):
    jcell, tcell = _cells(arch, name)
    shape = mesh.make_production_mesh(multi_pod=multi_pod)
    fake = _FakeMesh(shape)
    jcfg = jax_config(arch)
    jspecs, jaxes = jax_input_specs(jcfg, jcell), jax_sharding.input_axes(jcfg, jcell)
    rules = jax_sharding.rules_for(jcfg)

    def want(spec, ax):
        if isinstance(spec, dict):
            return {k: want(spec[k], ax[k]) for k in spec}
        return tuple(jax_sharding.resolve_spec(ax, spec.shape, fake, rules))

    assert sharding.shard_input_specs(get_config(arch), tcell, shape) == {
        k: want(jspecs[k], jaxes[k]) for k in jspecs}


def test_mesh_shapes_are_the_reference_meshes():
    assert mesh.make_production_mesh() == {"data": 16, "model": 16}
    assert mesh.make_production_mesh(multi_pod=True) == {"pod": 2, "data": 16, "model": 16}
    assert mesh.make_smoke_mesh() == {"data": 2, "model": 4}
    assert mesh.make_smoke_mesh(multi_pod=True) == {"pod": 2, "data": 2, "model": 2}


HLO = """
  %p0 = bf16[64,128]{1,0} parameter(0)
  %ag = bf16[64,2048]{1,0} all-gather(%p0), dimensions={1}
  %ar = f32[32,32]{1,0} all-reduce(%x), to_apply=%sum
  %rs = f32[4,32]{1,0} reduce-scatter(%ar), dimensions={0}
  %cp = bf16[8,8]{1,0} collective-permute(%p1)
"""


def test_parse_collectives_equals_reference():
    got, want = analysis.parse_collectives(HLO), jax_analysis.parse_collectives(HLO)
    assert got.bytes_by_kind == want.bytes_by_kind
    assert got.count_by_kind == want.count_by_kind
    assert got.total_bytes == want.total_bytes > 0


@pytest.mark.parametrize("q1,q2,L", [(15, 20, 30), (0.0, 0.0, 4), (7.5, 3.0, 16)])
def test_scan_correct_equals_reference(q1, q2, L):
    assert analysis.scan_correct(q1, q2, L) == jax_analysis.scan_correct(q1, q2, L)


def test_roofline_terms_take_each_flop_at_its_unit_peak():
    t = analysis.RooflineTerms(flops=3e12, hbm_bytes=3.35e9, coll_bytes=0.0, chips=1,
                               flops_by_peak={"bf16": 989e9, "fp32": 67e9, "tf32x3": 165e9})
    assert t.compute_s == pytest.approx(1e-3 + 1e-3 + 1e-3)
    assert t.memory_s == pytest.approx(1e-3)
    assert t.collective_s == 0.0 and t.dominant == "compute"
    d = t.as_dict()
    for key in ("flops_per_chip", "hbm_bytes_per_chip", "coll_bytes_per_chip", "compute_s",
                "memory_s", "collective_s", "dominant", "step_time_s"):
        assert key in d
    plain = analysis.RooflineTerms(flops=989e12, hbm_bytes=0, coll_bytes=0, chips=1)
    assert plain.compute_s == pytest.approx(1.0)


# --------------------------------------------------------------------------
# the port's dry-run
# --------------------------------------------------------------------------
def test_reckoner_counts_live_and_peak_storages():
    rk = dryrun.Reckoner()
    with rk:
        a = torch.empty(1000, device="meta")  # 4,000 B -> 4,096
        b = a * 2
        v = b[10:]  # a view: no new storage
        del a
        live_after = rk.live
        c = torch.empty(100, dtype=torch.bfloat16, device="meta")  # 200 B -> 512
    assert rk.peak == 8192 and live_after == 4096
    assert rk.live == 4096 + 512
    del b, v, c


def test_reckoner_counts_matmul_flops_by_unit_and_bytes():
    rk = dryrun.Reckoner()
    with rk:
        x = torch.empty(64, 32, device="meta")
        w = torch.empty(32, 16, device="meta", dtype=torch.bfloat16)
        rk.counting = True
        _ = x @ w.float()
        _ = x.bfloat16() @ w
    assert rk.flops_by_unit == {"fp32": 2 * 64 * 32 * 16, "bf16": 2 * 64 * 32 * 16}
    assert rk.bytes > 0


def test_largest_under_finds_the_boundary():
    calls = []

    def reckon(x):
        calls.append(x)
        return {"status": "ok", "memory": {"peak_hbm_bytes": 1000 + 37 * x}}

    x, rec = dryrun.largest_under(reckon, 1, 1000, 1, 10_000)
    assert x == 243 and rec["memory"]["peak_hbm_bytes"] < 10_000 <= 1000 + 37 * (x + 1)
    assert len(calls) <= 6
    assert dryrun.largest_under(reckon, 1, 1000, 1, 500) == (0, None)


def test_largest_cut_of_a_graph_cell():
    cell = ShapeCell("g", "full_graph", {"n_nodes": 4096, "n_edges": 40960, "d_feat": 8})
    half = dryrun.run_cell("gatedgcn", dryrun.scaled_cell(cell, 2048), smoke=True)
    budget = half["memory"]["peak_hbm_bytes"] + 1
    cut, rec = dryrun.largest_cut("gatedgcn", cell, budget, smoke=True, remat="full")
    n = cut.params["n_nodes"]
    assert n % 512 == 0 and cut.params["n_edges"] == round(n * 10)
    assert rec["memory"]["peak_hbm_bytes"] < budget
    if n + 512 <= 4096:
        nxt = dryrun.run_cell("gatedgcn", dryrun.scaled_cell(cell, n + 512), smoke=True,
                              remat="full")
        assert nxt["memory"]["peak_hbm_bytes"] >= budget


def test_deepest_under_a_budget():
    cell = ShapeCell("t", "train", {"seq_len": 32, "global_batch": 2})
    peaks = [dryrun.run_cell("qwen2-moe-a2.7b", cell, smoke=True,
                             cfg_overrides=[f"n_layers={L}"])["memory"]["peak_hbm_bytes"]
             for L in (1, 2)]
    assert peaks[1] > peaks[0]
    L, rec = dryrun.deepest("qwen2-moe-a2.7b", cell, peaks[1], smoke=True)
    assert L == 1 and rec["memory"]["peak_hbm_bytes"] == peaks[0]


def test_dryrun_cli_writes_ok_records(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "gatedgcn", "--smoke",
         "--shape", "molecule", "--out", str(tmp_path)],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300,
    )
    assert out.returncode == 0, out.stdout + out.stderr
    assert "ok=1 failed=0 skipped=0" in out.stdout
    (path,) = tmp_path.glob("*.json")
    rec = json.loads(path.read_text())
    assert rec["status"] == "ok" and rec["mesh"] == "h100" and rec["chips"] == 1
    assert rec["memory"]["peak_hbm_bytes"] > rec["memory"]["argument_bytes"] > 0
    assert rec["fits"] is True and rec["roofline"]["collective_s"] == 0.0
    assert rec["kernels"]["gnn_aggregate_fwd"]["calls"] == 3  # the smoke config's 3 layers
    assert rec["shardings"]["pod"]["inputs"]["node_feat"] == ["data"]


def test_long_500k_is_skipped_for_full_attention_archs():
    cell = next(c for c in get_shapes("tinyllama-1.1b") if c.name == "long_500k")
    rec = dryrun.run_cell("tinyllama-1.1b", cell)
    assert rec["status"] == "skipped"


@pytest.mark.parametrize("kind,step", [("decode", 1), ("decode", 4), ("prefill", 1)])
def test_largest_batch_of_an_lm_cell(kind, step):
    """The largest batch (a multiple of ``step``) whose reckoned peak lies
    under the budget; the next step up is over it; S stays."""
    cell = ShapeCell("c", kind, {"seq_len": 256, "global_batch": 64})
    at = lambda B: dryrun.run_cell("tinyllama-1.1b", dryrun.batch_cut(cell, B),  # noqa: E731
                                   smoke=True)["memory"]["peak_hbm_bytes"]
    budget = at(20) + 1
    cut, rec = dryrun.largest_batch("tinyllama-1.1b", cell, budget, step=step, smoke=True)
    B = cut.params["global_batch"]
    assert B % step == 0 and cut.params["seq_len"] == 256 and cut.name == cell.name
    assert rec["memory"]["peak_hbm_bytes"] < budget <= at(B + step)
    assert B == 20 // step * step


def test_fit_cuts_the_batch_then_the_depth():
    cell = ShapeCell("c", "decode", {"seq_len": 512, "global_batch": 8})
    peak = lambda c, L=None: dryrun.run_cell(  # noqa: E731
        "gemma3-4b", c, smoke=True, cfg_overrides=[f"n_layers={L}"] if L else []
    )["memory"]["peak_hbm_bytes"]
    full = peak(cell)
    assert dryrun.fit("gemma3-4b", cell, full + 1, smoke=True)[:3] == (cell, [], {})
    budget = peak(dryrun.batch_cut(cell, 5)) + 1
    cut, over, cuts, rec = dryrun.fit("gemma3-4b", cell, budget, smoke=True)
    assert (cut.params["global_batch"], over, cuts) == (5, [], {"global_batch": [8, 5]})
    one = dryrun.batch_cut(cell, 1)
    budget = peak(one, 2) + 1  # one row does not fit at the smoke depth of 3, two layers do
    cut, over, cuts, rec = dryrun.fit("gemma3-4b", cell, budget, smoke=True)
    assert (cut, over) == (one, ["n_layers=2"])
    assert cuts == {"global_batch": [8, 1], "n_layers": [3, 2]}
    assert rec["memory"]["peak_hbm_bytes"] < budget


def test_dryrun_cli_prints_the_fit(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "tinyllama-1.1b",
         "--smoke", "--shape", "decode_32k", "--fit", "1e12", "--out", str(tmp_path)],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300,
    )
    assert out.returncode == 0, out.stdout + out.stderr
    assert "[fit] tinyllama-1.1b" in out.stdout and "not cut" in out.stdout


def test_fit_train_takes_the_remat_that_keeps_more_layers():
    """The train_4k cell under a budget where remat none holds one row at
    one layer fewer than the config's and remat full holds every layer (the
    choice gemma3-4b's whole config meets under 75 GB: none B 1 at 31 of 34
    layers, full B 2 at 34), on gemma3-smoke: ``fit_train`` takes remat
    full, with the batch that ``fit`` finds and every layer."""
    cell = next(c for c in get_shapes("gemma3-4b") if c.name == "train_4k")
    one = dryrun.batch_cut(cell, 1)
    n = get_config("gemma3-4b", smoke=True).n_layers
    peak = lambda remat, L: dryrun.run_cell(  # noqa: E731
        "gemma3-4b", one, smoke=True, remat=remat, cfg_overrides=[f"n_layers={L}"]
    )["memory"]["peak_hbm_bytes"]
    budget = peak("none", n - 1) + 1
    assert peak("none", n) >= budget > peak("full", n)
    remat, fits = dryrun.fit_train("gemma3-4b", cell, budget, smoke=True)
    assert remat == "full" and sorted(fits) == ["full", "none"]
    cut, over, cuts, rec = fits["none"]
    assert (cut, over) == (one, [f"n_layers={n - 1}"])
    assert cuts == {"global_batch": [256, 1], "n_layers": [n, n - 1]}
    cut, over, cuts, rec = fits["full"]
    B = cut.params["global_batch"]
    assert over == [] and cuts == {"global_batch": [256, B]} and rec["n_layers"] == n
    assert rec["remat"] == "full" and rec["memory"]["peak_hbm_bytes"] < budget
    assert B >= 1 and cut.params["seq_len"] == 4096


def test_fit_train_keeps_remat_none_where_it_cuts_no_layer():
    """TinyLlama's choice (B 6 at all 22 layers under remat none): where
    remat none cuts only the batch, ``fit_train`` traces no other remat."""
    cell = next(c for c in get_shapes("tinyllama-1.1b") if c.name == "train_4k")
    one = dryrun.run_cell("tinyllama-1.1b", dryrun.batch_cut(cell, 1), smoke=True)
    budget = one["memory"]["peak_hbm_bytes"] + 1
    remat, fits = dryrun.fit_train("tinyllama-1.1b", cell, budget, smoke=True)
    assert remat == "none" and list(fits) == ["none"]
    assert fits["none"][2] == {"global_batch": [256, 1]} and fits["none"][1] == []
