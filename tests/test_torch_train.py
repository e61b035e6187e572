"""The port's training and full-sequence paths against the reference package,
on the CPU, from the same converted parameters and numpy batches:
``forward`` and ``prefill``, ``streaming_ce_loss``, ``_lm_loss`` gradients
leaf by leaf, one AdamW step, a five-step loss curve of
``build_train_step``, the remat policies and gradient accumulation, the
``TrainDriver`` recovery path and the ``launch.train`` CLI.

Tolerances: fp32 1e-4 absolute and relative through the layers (the same
sums in another order, growing through the layers; a single attention holds
2e-5 in ``tests/test_torch_flash.py``).  Gradients, leaf by leaf, within
1e-4 of the leaf's largest reference value on tinyllama-smoke and 5e-4 on
gemma3-smoke, where the embedding's gradient passes through an RMS norm of
inputs drawn at scale 0.02, which multiplies it some fifty times, and each
framework's fp32 rounding with it.  bf16 logits within 5e-2 of the largest
reference logit, as ``tests/test_torch_transformer.py`` explains (XLA keeps
excess precision inside its fusions where torch rounds each op), or, where
more, within the distance of the reference's own bf16 logits from its fp32
logits: on gemma3-smoke over 20 positions both frameworks' bf16 logits lie
far from fp32, and nearer to each other than to it."""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax
import jax.numpy as jnp

from repro.configs import get_config as jax_config
from repro.configs.base import ShapeCell as JaxCell
from repro.data import make_batch as jax_make_batch
from repro.models import transformer as jax_tf
from repro.models.layers import init_params as jax_init
from repro.optim import AdamWConfig as JaxAdamWConfig
from repro.optim import apply_updates as jax_apply_updates
from repro.optim import init_state as jax_init_state
from repro.train import build_loss_fn as jax_build_loss_fn
from repro.train import build_train_step as jax_build_train_step
from repro.train import make_train_state as jax_make_train_state
from repro_torch.ckpt import CheckpointManager
from repro_torch.configs import ShapeCell, get_config
from repro_torch.convert import params_from_numpy
from repro_torch.data import make_batch
from repro_torch.models import moe, transformer
from repro_torch.optim import AdamWConfig, apply_updates, init_state
from repro_torch.runtime import TrainDriver
from repro_torch.train import build_loss_fn, build_train_step, make_train_state

ROOT = Path(__file__).resolve().parents[1]
TOLS = {"float32": 1e-4, "bfloat16": 5e-2}
TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}
CELL = ShapeCell("t", "train", {"seq_len": 16, "global_batch": 4})
JCELL = JaxCell("t", "train", {"seq_len": 16, "global_batch": 4})


def _configs(arch, dtype, **over):
    jcfg = dataclasses.replace(jax_config(arch, smoke=True), dtype=getattr(jnp, dtype), **over)
    tcfg = dataclasses.replace(get_config(arch, smoke=True), dtype=TORCH_DTYPE[dtype], **over)
    return jcfg, tcfg


def _params(jcfg, seed=0):
    jp = jax_init(jax.random.PRNGKey(seed), jax_tf.lm_specs(jcfg), jcfg.dtype)
    return jp, params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")


def _tokens(vocab, shape, seed):
    return np.random.default_rng(seed).integers(0, vocab, size=shape).astype(np.int32)


def _close(got, want, dtype, tol=None):
    tol = tol or TOLS[dtype]
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=tol, rtol=tol)
    else:
        assert np.abs(got - want).max() <= tol * np.abs(want).max()


def _tree_close(got, want, tol):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _tree_close(got[k], want[k], tol)
    else:
        np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                                   atol=tol, rtol=tol)


# --------------------------------------------------------------------------
# forward / prefill
# --------------------------------------------------------------------------
@pytest.mark.parametrize(
    "arch", ["tinyllama-1.1b", "gemma3-4b", "deepseek-7b", "qwen2-moe-a2.7b", "deepseek-v2-236b"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["einsum", "chunked"])
def test_forward_logits_match_reference(arch, dtype, impl):
    jcfg, tcfg = _configs(arch, dtype, attention_impl=impl, attn_block_q=8)
    jp, tp = _params(jcfg)
    toks = _tokens(jcfg.vocab, (2, 20), 1)  # 20 > gemma3-smoke's window of 8
    want, _ = jax_tf.forward(jp, jcfg, jnp.asarray(toks))
    got, caches = transformer.forward(tp, tcfg, torch.from_numpy(toks))
    assert got.dtype == torch.float32 and caches is None
    if dtype == "float32":
        _close(got, want, dtype)
        return
    want = np.asarray(want)
    want32 = np.asarray(jax_tf.forward(
        jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), jp),
        dataclasses.replace(jcfg, dtype=jnp.float32), jnp.asarray(toks))[0])
    bound = max(TOLS[dtype] * np.abs(want).max(), np.abs(want - want32).max())
    assert np.abs(got.numpy() - want).max() <= bound


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "gemma3-4b"])
def test_prefill_matches_reference(arch):
    jcfg, tcfg = _configs(arch, "float32")
    jp, tp = _params(jcfg, seed=2)
    toks = _tokens(jcfg.vocab, (2, 18), 3)
    jl, jc, jlen = jax_tf.prefill(jp, jcfg, jnp.asarray(toks))
    tl, tc, tlen = transformer.prefill(tp, tcfg, torch.from_numpy(toks))
    _close(tl, jl, "float32")
    for name in ("k", "v"):
        _close(tc[name], jc[name], "float32")
    np.testing.assert_array_equal(tlen.numpy(), np.asarray(jlen))
    assert tlen.dtype == torch.int32


def test_forward_options_match_reference():
    jcfg, tcfg = _configs("tinyllama-1.1b", "float32")
    jp, tp = _params(jcfg)
    toks = _tokens(jcfg.vocab, (2, 12), 4)
    for kw in ({"last_only": True}, {"no_head": True}, {"collect_kv": True}):
        want, wc = jax_tf.forward(jp, jcfg, jnp.asarray(toks), **kw)
        got, gc = transformer.forward(tp, tcfg, torch.from_numpy(toks), **kw)
        _close(got, want, "float32")
        if kw.get("collect_kv"):
            for g, w in zip(gc, wc):
                _close(g, w, "float32")


def test_prefill_chain_of_chunks_gives_the_same_cache():
    """``prefill`` (full-sequence attention) against a chain of
    ``prefill_chunk`` calls (cached attention) over the same tokens."""
    _, tcfg = _configs("gemma3-4b", "float32")
    _, tp = _params(_configs("gemma3-4b", "float32")[0], seed=5)
    toks = torch.from_numpy(_tokens(tcfg.vocab, (2, 24), 6))
    logits, cache, clen = transformer.prefill(tp, tcfg, toks)
    chain = transformer.init_cache(tcfg, 2, 32, "cpu")
    cl = torch.zeros(2, dtype=torch.int32)
    for i in range(0, 24, 8):
        lg, chain, cl = transformer.prefill_chunk(tp, tcfg, toks[:, i:i + 8], chain, cl)
    torch.testing.assert_close(lg, logits, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(chain["k"][:, :, :24], cache["k"], atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(chain["v"][:, :, :24], cache["v"], atol=1e-4, rtol=1e-4)
    assert torch.equal(cl, clen)


# --------------------------------------------------------------------------
# losses and gradients
# --------------------------------------------------------------------------
def test_streaming_ce_loss_value_and_gradient():
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 5, 16)).astype(np.float32)
    head = (rng.normal(size=(16, 32)) * 0.5).astype(np.float32)
    tgt = rng.integers(0, 32, size=(2, 5)).astype(np.int32)
    (jl, (jgx, jgh)) = jax.value_and_grad(
        lambda a, b: jax_tf.streaming_ce_loss(a, b, jnp.asarray(tgt), 4), argnums=(0, 1)
    )(jnp.asarray(x), jnp.asarray(head))
    tx = torch.from_numpy(x).requires_grad_(True)
    th = torch.from_numpy(head).requires_grad_(True)
    tl = transformer.streaming_ce_loss(tx, th, torch.from_numpy(tgt), 4)
    gx, gh = torch.autograd.grad(tl, (tx, th))
    _close(tl, jl, "float32", 2e-5)
    _close(gx, jgx, "float32", 2e-5)
    _close(gh, jgh, "float32", 2e-5)
    # and it is the plain cross entropy
    full = torch.nn.functional.cross_entropy((tx @ th).reshape(10, 32), torch.from_numpy(tgt)
                                             .long().reshape(10))
    _close(tl, full.detach().numpy(), "float32", 2e-5)


FAMILIES = ["deepseek-7b", "qwen2-moe-a2.7b", "deepseek-v2-236b"]


@pytest.mark.parametrize("arch,tol", [("tinyllama-1.1b", 1e-4), ("gemma3-4b", 5e-4)]
                         + [(a, 1e-4) for a in FAMILIES])
@pytest.mark.parametrize("chunks", [0, 4])
def test_lm_loss_gradients_match_reference(arch, tol, chunks):
    jcfg, tcfg = _configs(arch, "float32", loss_vocab_chunks=chunks)
    _grads_match(jcfg, tcfg, tol)


def _grads_match(jcfg, tcfg, tol, seed=8):
    """The loss and every gradient leaf of ``_lm_loss`` against
    ``jax.value_and_grad`` of the reference's, from the same parameters and
    batch."""
    jp, tp = _params(jcfg, seed=seed)
    batch = jax_make_batch(jcfg, JCELL, seed=seed + 1)
    tbatch = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    (jl, _), jg = jax.value_and_grad(jax_build_loss_fn(jcfg, JCELL), has_aux=True)(jp, batch)
    leaves = {}

    def req(tree, path=()):
        if isinstance(tree, dict):
            return {k: req(v, path + (k,)) for k, v in tree.items()}
        leaves[path] = tree.clone().requires_grad_(True)
        return leaves[path]

    tparams = req(tp)
    tl, metrics = build_loss_fn(tcfg, CELL)(tparams, tbatch)
    grads = torch.autograd.grad(tl, list(leaves.values()))
    _close(tl, jl, "float32")
    assert float(metrics["ppl_proxy"].detach()) == float(tl.detach())
    for (path, _), g in zip(leaves.items(), grads):
        want = jg
        for k in path:
            want = want[k]
        want = np.asarray(want)
        err = np.abs(g.numpy() - want).max()
        assert err <= tol * np.abs(want).max(), ("/".join(path), err, np.abs(want).max())


def _recording_route(calls: list):
    """``moe.route`` that keeps each call's (gates, ids, slots)."""
    inner = moe.route

    def route(x, router, dims):
        out = inner(x, router, dims)
        calls.append(tuple(t.detach().clone() for t in out))
        return out
    return route


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "deepseek-v2-236b"])
def test_moe_gradients_with_capacity_drops_match_reference(arch, monkeypatch):
    """Several MoE groups a call (group 16 of the 64 tokens) at capacity
    factor 1.0 (C 4 for a mean load of 4): the routing drops pairs, which
    the test asserts, and the loss and every gradient leaf still match
    ``jax.grad`` of the reference's one-hot dispatch and combine."""
    jcfg, tcfg = _configs(arch, "float32", moe_group_size=16, moe_capacity_factor=1.0)
    calls = []
    monkeypatch.setattr(moe, "route", _recording_route(calls))
    _grads_match(jcfg, tcfg, 1e-4, seed=14)
    assert len(calls) == tcfg.n_layers
    for gates, idx, slot in calls:
        assert slot.shape[:2] == (4, 16)  # G 4 groups of g 16
        assert int(slot.max()) == 3  # C 4
    assert sum(int((slot < 0).sum()) for _, _, slot in calls) > 0, "no pair was dropped"


@pytest.mark.parametrize("arch", ["synthetic"] + FAMILIES)
def test_one_adamw_step_matches_reference(arch):
    """Three AdamW updates (warm-up, then the cosine branch) of a small tree,
    or of a smoke family's parameters with gradients drawn at their shapes."""
    rng = np.random.default_rng(10)
    if arch == "synthetic":
        params = {"a": rng.normal(size=(4, 3)).astype(np.float32),
                  "b": {"c": rng.normal(size=(5,)).astype(np.float32)}}
    else:
        params = jax.tree_util.tree_map(np.asarray, _params(_configs(arch, "float32")[0])[0])
    grads = jax.tree_util.tree_map(
        lambda a: rng.normal(size=a.shape).astype(np.float32) * 3, params)
    jcfg = JaxAdamWConfig(warmup_steps=2, total_steps=10)
    tcfg = AdamWConfig(warmup_steps=2, total_steps=10)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    jstate = jax_init_state(jparams)
    tparams = params_from_numpy(params, "cpu")
    tstate = init_state(tparams)
    for _ in range(3):  # warmup, then the cosine branch
        jparams, jstate, jm = jax_apply_updates(
            jparams, jax.tree_util.tree_map(jnp.asarray, grads), jstate, jcfg)
        tparams, tstate, tm = apply_updates(tparams, params_from_numpy(grads, "cpu"),
                                            tstate, tcfg)
    _tree_close(tparams, jparams, 2e-6)
    _tree_close(tstate["mu"], jstate["mu"], 2e-6)
    _tree_close(tstate["nu"], jstate["nu"], 2e-6)
    assert tstate["step"].dtype == torch.int32 and int(tstate["step"]) == int(jstate["step"])
    for k in ("grad_norm", "lr"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=2e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sliced_adamw_update_is_bit_equal(dtype, monkeypatch):
    """A leaf above the slicing size is updated in slices of whole rows
    (here of 8 rows of 64, the last slice short); parameters and moments
    equal the update of the whole leaf bit for bit, over three steps."""
    from repro_torch.optim import adamw

    rng = np.random.default_rng(15)
    shape = (3, 50, 64)
    p0 = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dtype)
    gs = [torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dtype)
          for _ in range(3)]
    small = {"b": torch.from_numpy(rng.normal(size=(7,)).astype(np.float32))}
    cfg = AdamWConfig(warmup_steps=2, total_steps=10)
    out = {}
    for name, limit in (("whole", adamw.SLICE_BYTES), ("sliced", 4 * 64 * 8)):
        monkeypatch.setattr(adamw, "SLICE_BYTES", limit)
        assert (adamw._slice_rows(p0, p0, p0, p0) is None) == (name == "whole")
        params = {"w": p0.clone(), **{k: v.clone() for k, v in small.items()}}
        state = init_state(params)
        for g in gs:
            params, state, m = apply_updates(params, {"w": g, "b": small["b"] * 2}, state, cfg)
        out[name] = (params, state, m)
    (pw, sw, mw), (ps, ss, ms) = out["whole"], out["sliced"]
    for a, b in ((pw["w"], ps["w"]), (sw["mu"]["w"], ss["mu"]["w"]),
                 (sw["nu"]["w"], ss["nu"]["w"]), (pw["b"], ps["b"])):
        assert torch.equal(a, b)
    assert torch.equal(mw["grad_norm"], ms["grad_norm"])


@pytest.mark.parametrize("arch", ["tinyllama-1.1b"] + FAMILIES)
def test_five_step_loss_curve_matches_reference(arch):
    jcfg, tcfg = _configs(arch, "float32")
    jp, tp = _params(jcfg, seed=11)
    opt = dict(warmup_steps=2, total_steps=5)
    jstep = jax.jit(jax_build_train_step(jcfg, JCELL, JaxAdamWConfig(**opt)))
    tstep = build_train_step(tcfg, CELL, AdamWConfig(**opt))
    jstate, tstate = jax_make_train_state(jp), make_train_state(tp)
    for s in range(5):
        batch = jax_make_batch(jcfg, JCELL, seed=s)
        jstate, jm = jstep(jstate, batch)
        tstate, tm = tstep(tstate, make_batch(tcfg, CELL, seed=s, device="cpu"))
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), atol=1e-4, rtol=1e-4,
                                       err_msg=f"step {s} {k}")
    _tree_close(tstate["params"], jstate["params"], 1e-4)


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone()


@pytest.mark.parametrize("remat,accum", [("full", 1), ("dots", 1), ("dots_no_batch", 1),
                                         ("none", 2)])
def test_remat_and_grad_accum_give_the_same_step(remat, accum):
    _, tcfg = _configs("gemma3-4b", "float32")
    _, tp = _params(_configs("gemma3-4b", "float32")[0], seed=12)
    batch = make_batch(tcfg, CELL, seed=13, device="cpu")
    ref_state, ref_m = build_train_step(tcfg, CELL)(make_train_state(_clone(tp)), batch)
    state, m = build_train_step(tcfg, CELL, remat=remat, grad_accum=accum)(
        make_train_state(_clone(tp)), batch)
    tol = 1e-6 if accum == 1 else 1e-4  # accumulation halves the batch: other sums
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(m[k]), float(ref_m[k]), rtol=tol, atol=tol)
    _tree_close(state["params"], {k: v.numpy() if isinstance(v, torch.Tensor) else v
                                  for k, v in _numpy(ref_state["params"]).items()}, tol)


def test_moe_grad_accum_step_matches_the_reference_accumulated_step(monkeypatch):
    """``grad_accum=2`` on qwen2-moe-smoke: each micro-batch of 32 tokens is
    routed as its own group (g = min(group_size, tokens) of the call), so the
    accumulated step is not the plain step; it is held against the
    reference's own ``grad_accum=2`` step."""
    jcfg, tcfg = _configs("qwen2-moe-a2.7b", "float32")
    jp, tp = _params(jcfg, seed=16)
    opt = dict(warmup_steps=2, total_steps=5)
    jstep = jax.jit(jax_build_train_step(jcfg, JCELL, JaxAdamWConfig(**opt), grad_accum=2))
    tstep = build_train_step(tcfg, CELL, AdamWConfig(**opt), grad_accum=2)
    calls = []
    monkeypatch.setattr(moe, "route", _recording_route(calls))
    jstate, jm = jstep(jax_make_train_state(jp), jax_make_batch(jcfg, JCELL, seed=17))
    tstate, tm = tstep(make_train_state(tp), make_batch(tcfg, CELL, seed=17, device="cpu"))
    assert [tuple(c[1].shape) for c in calls] == [(1, 32, 2)] * (2 * tcfg.n_layers)
    for k in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), atol=1e-4, rtol=1e-4, err_msg=k)
    _tree_close(tstate["params"], jstate["params"], 1e-4)


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "deepseek-v2-236b"])
@pytest.mark.parametrize("remat", ["full", "dots"])
def test_moe_remat_recomputes_the_forward_routes(arch, remat, monkeypatch):
    """Under remat each layer's forward runs again in the backward, routing
    included: the recomputed routes (gates, expert ids and slots) equal the
    forward's bit for bit, layer by layer, and the step equals the step
    without remat."""
    _, tcfg = _configs(arch, "float32")
    _, tp = _params(_configs(arch, "float32")[0], seed=18)
    batch = make_batch(tcfg, CELL, seed=19, device="cpu")
    ref_state, ref_m = build_train_step(tcfg, CELL)(make_train_state(_clone(tp)), batch)
    calls = []
    monkeypatch.setattr(moe, "route", _recording_route(calls))
    state, m = build_train_step(tcfg, CELL, remat=remat)(make_train_state(_clone(tp)), batch)
    L = tcfg.n_layers
    assert len(calls) == 2 * L  # the forward's L, then the backward's L, last layer first
    for i in range(L):
        for a, b in zip(calls[i], calls[2 * L - 1 - i]):
            assert torch.equal(a, b)
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(m[k]), float(ref_m[k]), rtol=1e-6, atol=1e-6)
    _tree_close(state["params"], _numpy(ref_state["params"]), 1e-6)


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    return tree.numpy()


def test_serve_and_batch_builders_refuse_unported_families():
    """A config of no known family is refused as the reference refuses it
    (every family's loss is ported: recsys training's parity is
    tests/test_torch_recsys_train.py)."""
    from repro_torch.configs import input_specs
    from repro_torch.train import build_loss_fn, build_param_specs

    class OtherConfig:  # stands in for a family neither package has
        family = "other"

    for fn in (lambda: build_param_specs(OtherConfig()), lambda: input_specs(OtherConfig(), CELL),
               lambda: build_loss_fn(OtherConfig(), CELL)):
        with pytest.raises(TypeError):
            fn()


def test_make_batch_matches_reference():
    jcfg, tcfg = _configs("tinyllama-1.1b", "bfloat16")
    for cell, jc in ((CELL, JCELL),
                     (ShapeCell("d", "decode", {"seq_len": 8, "global_batch": 2}),
                      JaxCell("d", "decode", {"seq_len": 8, "global_batch": 2}))):
        want = jax_make_batch(jcfg, jc, seed=3)
        got = make_batch(tcfg, cell, seed=3, device="cpu")
        assert sorted(got) == sorted(want)
        for k in want:
            if isinstance(want[k], dict):
                for n in want[k]:
                    assert got[k][n].dtype == torch.bfloat16
                    _close(got[k][n], want[k][n], "float32", 1e-7)
            else:
                np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


# --------------------------------------------------------------------------
# driver and CLI
# --------------------------------------------------------------------------
def test_train_driver_failure_recovery(tmp_path):
    """tests/test_runtime.py::test_train_driver_failure_recovery, on the port."""
    cfg = get_config("tinyllama-1.1b", smoke=True)
    gen = torch.Generator().manual_seed(0)
    from repro_torch.models.layers import init_params

    state = make_train_state(init_params(gen, transformer.lm_specs(cfg), cfg.dtype, "cpu"))
    step_fn = build_train_step(cfg, CELL, AdamWConfig(warmup_steps=1, total_steps=20))
    batches = {s: make_batch(cfg, CELL, seed=s, device="cpu") for s in range(12)}
    ckpt = CheckpointManager(tmp_path / "ck", keep=2, device="cpu")
    driver = TrainDriver(
        train_step=step_fn,
        make_batch=lambda s: batches[s],
        ckpt=ckpt,
        ckpt_every=4,
        fail_at_steps=(6,),
    )
    final_state, log = driver.run(state, 10)
    restarts = [e for e in log if e.get("event") == "restart"]
    assert len(restarts) == 1 and restarts[0]["from_step"] == 4
    steps_run = [e["step"] for e in log if "step" in e]
    assert steps_run[-1] == 10
    # steps 5,6 ran twice (recovery re-execution from the checkpoint)
    assert steps_run.count(5) == 2 and steps_run.count(6) == 2
    losses = [e["loss"] for e in log if "loss" in e]
    assert all(np.isfinite(l) for l in losses)
    # the re-run steps give the losses of the first run: the restore is exact
    first = {e["step"]: e["loss"] for e in log[:6] if "loss" in e}
    again = [e for e in log if "loss" in e and e["step"] in (5, 6)][2:]
    assert [e["loss"] for e in again] == [first[5], first[6]]
    step, restored = ckpt.restore()
    assert step == 10
    assert torch.equal(restored["params"]["embed"].view(torch.int16),
                       final_state["params"]["embed"].view(torch.int16))


def test_train_cli_smoke_with_failure(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="2")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "tinyllama-1.1b",
         "--smoke", "--steps", "6", "--batch", "2", "--seq", "32", "--device", "cpu",
         "--fail-at", "3", "--ckpt-every", "2", "--ckpt-dir", str(tmp_path / "ck")],
        capture_output=True, text=True, env=env, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert "restart from step 2" in out.stdout
    assert "done: 6 steps" in out.stdout


def test_train_cli_cuts_the_depth():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="2")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "qwen2-moe-a2.7b",
         "--smoke", "--layers", "1", "--device", "cpu", "--steps", "2", "--batch", "2",
         "--seq", "32"],
        capture_output=True, text=True, env=env, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert "qwen2-moe-smoke: reduced n_layers 2 -> 1" in out.stdout
    assert "done: 2 steps" in out.stdout
