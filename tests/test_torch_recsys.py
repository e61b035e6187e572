"""The port's recsys serving path against the reference package, on the CPU,
from the same converted parameters (the reference's ``init_params``) and the
same numpy batches: ``build_serve_step`` of FM, DCN-v2, BST and SASRec on
their smoke configs, score and retrieval, in fp32; the configs, input specs
and synthetic batches of the GNN and recsys cells; and the layers the models
use.

Tolerance: 1e-4 of the largest reference score, absolute, plus 1e-4
relative (the same fp32 sums in other orders through a few dense layers).

``make_batch`` draws FM's and DCN-v2's candidate ids below 1,000 whatever the
table's size (neither has an ``item_vocab``); the smoke tables hold 290 and
260 rows, so both packages would score some candidates NaN (``jnp.take``'s
fill).  The retrieval checks draw candidates inside the table instead."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax
import jax.numpy as jnp

from repro.configs import get_config as jax_config
from repro.configs import get_shapes as jax_shapes
from repro.configs import input_specs as jax_input_specs
from repro.data import make_batch as jax_make_batch
from repro.models import layers as jax_layers
from repro.models.layers import init_params as jax_init
from repro.train import build_param_specs as jax_param_specs
from repro.train import build_serve_step as jax_serve_step
from repro_torch.configs import get_config, get_shapes, input_specs, list_archs
from repro_torch.convert import params_from_numpy
from repro_torch.data import make_batch
from repro_torch.kernels.embedding_bag import embedding_bag
from repro_torch.models import layers
from repro_torch.train import build_serve_step, build_train_step, make_train_state

RECSYS = ["fm", "dcn-v2", "bst", "sasrec"]


def _small(cell):
    p = dict(cell.params)
    p["batch"] = 8
    if "n_candidates" in p:
        p["n_candidates"] = 64
    return dataclasses.replace(cell, params=p)


def _jax_cell(arch, name):
    return next(c for c in jax_shapes(arch) if c.name == name)


def _to_torch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


@pytest.mark.parametrize("arch", RECSYS)
@pytest.mark.parametrize("cell_name", ["serve_p99", "retrieval_cand"])
def test_serve_step_matches_reference(arch, cell_name):
    jcfg, tcfg = jax_config(arch, smoke=True), get_config(arch, smoke=True)
    jcell = _small(_jax_cell(arch, cell_name))
    tcell = _small(next(c for c in get_shapes(arch) if c.name == cell_name))
    jp = jax_init(jax.random.PRNGKey(0), jax_param_specs(jcfg, jcell), jnp.float32)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    batch = {k: np.asarray(v) for k, v in jax_make_batch(jcfg, jcell, seed=3).items()}
    if "candidate_ids" in batch and not tcfg.item_vocab:
        rng = np.random.default_rng(4)
        batch["candidate_ids"] = rng.integers(0, sum(tcfg.vocab_sizes), 64).astype(np.int32)
    want = np.asarray(jax_serve_step(jcfg, jcell)(jp, **{k: jnp.asarray(v)
                                                         for k, v in batch.items()}))
    before = embedding_bag.launches
    got = build_serve_step(tcfg, tcell)(tp, **_to_torch(batch))
    assert embedding_bag.launches == before  # the CPU runs the plain version
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert np.isfinite(want).all()
    tol = 1e-4 * np.abs(want).max()
    np.testing.assert_allclose(got.numpy(), want, atol=tol, rtol=1e-4)


@pytest.mark.parametrize("arch", RECSYS + ["gatedgcn"])
def test_input_specs_and_batches_match_reference(arch):
    jcfg, tcfg = jax_config(arch, smoke=True), get_config(arch, smoke=True)
    assert [c.name for c in get_shapes(arch)] == [c.name for c in jax_shapes(arch)]
    for jc, tc in zip(jax_shapes(arch), get_shapes(arch)):
        assert jc.params == tc.params and jc.kind == tc.kind
        if arch == "gatedgcn":
            p = dict(tc.params, batch_nodes=4, n_nodes=40, n_edges=64, d_feat=12, batch=3)
            jc, tc = dataclasses.replace(jc, params=p), dataclasses.replace(tc, params=p)
        else:
            jc, tc = _small(jc), _small(tc)
        js, ts = jax_input_specs(jcfg, jc), input_specs(tcfg, tc)
        assert list(js) == list(ts)
        for k in js:
            assert js[k].shape == ts[k].shape, k
            assert str(js[k].dtype) == str(ts[k].dtype).replace("torch.", ""), k
        want = jax_make_batch(jcfg, jc, seed=5)
        got = make_batch(tcfg, tc, seed=5, device="cpu")
        assert list(want) == list(got)
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)


def test_port_registers_the_reference_configs():
    assert {"fm", "dcn-v2", "bst", "sasrec", "gatedgcn"} <= set(list_archs())
    for arch in RECSYS + ["gatedgcn"]:
        for smoke in (False, True):
            j, t = jax_config(arch, smoke=smoke), get_config(arch, smoke=smoke)
            jd, td = dataclasses.asdict(j), dataclasses.asdict(t)
            assert np.dtype(jd.pop("dtype")).name == str(td.pop("dtype")).replace("torch.", "")
            assert jd == td


@pytest.mark.parametrize("arch", RECSYS)
def test_recsys_train_step_runs_on_the_cpu(arch):
    """``build_train_step`` trains every recsys model (parity with the
    reference: tests/test_torch_recsys_train.py): finite metrics, every
    table changed by the step, the CPU on the plain version."""
    cfg = get_config(arch, smoke=True)
    cell = _small(next(c for c in get_shapes(arch) if c.kind == "train"))
    from repro_torch.train import build_param_specs

    params = layers.init_params(torch.Generator().manual_seed(0), build_param_specs(cfg, cell),
                                cfg.dtype, "cpu")
    tables = {k: params[k].clone() for k in ("table", "item_table", "w_linear") if k in params}
    before = embedding_bag.launches_bwd
    state, m = build_train_step(cfg, cell)(make_train_state(params), make_batch(
        cfg, cell, seed=0, device="cpu"))
    assert embedding_bag.launches_bwd == before
    assert {"loss", "grad_norm", "lr"} <= set(m)
    assert all(bool(torch.isfinite(v)) for v in m.values())
    for k, t in tables.items():
        assert not torch.equal(state["params"][k], t), k


def test_layer_norm_and_mlp_match_reference():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(5, 7, 12)).astype(np.float32)
    s, b = rng.normal(size=12).astype(np.float32), rng.normal(size=12).astype(np.float32)
    want = jax_layers.layer_norm(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b))
    got = layers.layer_norm(torch.from_numpy(x), torch.from_numpy(s), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    specs = jax_layers.mlp_specs(12, (16, 8))
    assert [{k: (v.shape, v.axes) for k, v in lyr.items()} for lyr in specs] == [
        {k: (v.shape, v.axes) for k, v in lyr.items()} for lyr in layers.mlp_specs(12, (16, 8))]
    jp = jax_init(jax.random.PRNGKey(1), specs, jnp.float32)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    want = jax_layers.mlp(jnp.asarray(x), jp)
    np.testing.assert_allclose(layers.mlp(torch.from_numpy(x), tp).numpy(), np.asarray(want),
                               atol=1e-5, rtol=1e-5)
    assert layers.param_count(layers.mlp_specs(12, (16, 8))) == jax_layers.param_count(specs)


@pytest.mark.parametrize("arch", RECSYS)
def test_init_params_builds_lists_of_layers(arch):
    """The port's init keeps the reference's tree (mlp layers as a list) and
    its scheme (scales per spec)."""
    cfg = get_config(arch, smoke=True)
    cell = next(c for c in get_shapes(arch) if c.kind == "serve")
    from repro_torch.train import build_param_specs

    specs = build_param_specs(cfg, cell)
    p = layers.init_params(torch.Generator().manual_seed(0), specs, cfg.dtype, "cpu")
    jp = jax_init(jax.random.PRNGKey(0), jax_param_specs(jax_config(arch, smoke=True), cell),
                  jnp.float32)
    shapes = lambda t: jax.tree_util.tree_map(lambda a: tuple(a.shape), t)
    assert shapes(jax.tree_util.tree_map(np.asarray, jp)) == jax.tree_util.tree_map(
        lambda a: tuple(a.shape), p)
    table = p["table"] if "table" in p else p["item_table"]
    assert abs(float(table.std()) - 0.02) < 0.005
    state = make_train_state(p)  # lists of layers go through the optimizer state too
    assert jax.tree_util.tree_map(lambda a: tuple(a.shape), state["opt"]["mu"]) == \
        jax.tree_util.tree_map(lambda a: tuple(a.shape), p)
