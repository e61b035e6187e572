"""The reference's ``train_4k`` cell (``configs/base.py``'s LM_SHAPES) on the
port against the reference package, on the CPU: the dry-run's train step
(``dryrun.build_step``: ``build_train_step`` and a fresh AdamW state, as the
card's train cells run it) against the reference's ``build_train_step``, at
a cut of ``seq_len`` 256 and ``global_batch`` 2, fp32, remat none and full,
on the smoke configs of TinyLlama-1.1B, gemma3-4b (whose local window of 8
bites at 256), deepseek-7b, qwen2-moe-a2.7b and deepseek-v2-236b (MoE: the
512 tokens make one group of 512).  Both packages take one step from the same
converted parameters and the same batch; then ``make_batch`` on a
``torch.Generator`` gives the train cell's specs.

Tolerances: the loss and the grad norm 1e-4 relative; each gradient leaf
of the cell's loss within 1e-4 of the leaf's largest reference value,
gemma3-smoke 5e-4, as ``tests/test_torch_train.py`` holds the gradients
(the embedding's gradient passes an RMS norm of inputs at scale 0.02, which
multiplies it some fifty times); every updated parameter within that
tolerance absolute and relative, as ``tests/test_torch_train.py`` holds the
parameters after its steps.  The leaf's largest value bounds the gradients,
not the updated parameters: the norms are drawn at zero, so after one step
they hold values of the learning rate's size, and AdamW divides each
element's gradient by its own size; an element whose gradient is 1.6e-4 of
its leaf's largest (deepseek-7b-smoke's ``ln2``) moves by 8e-4 of the
update when its gradient moves by 4e-7 of the leaf's largest."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax
import jax.numpy as jnp

from repro.configs import get_config as jax_config
from repro.configs import get_shapes as jax_shapes
from repro.data import make_batch as jax_make_batch
from repro.models import transformer as jax_tf
from repro.models.layers import init_params as jax_init
from repro.train import build_loss_fn as jax_build_loss_fn
from repro.train import build_train_step as jax_build_train_step
from repro.train import make_train_state as jax_make_train_state
from repro_torch.configs import get_config, get_shapes
from repro_torch.configs.base import input_specs
from repro_torch.convert import params_from_numpy
from repro_torch.data import make_batch
from repro_torch.launch import dryrun
from repro_torch.train import build_loss_fn

SEQ, BATCH = 256, 2
TOLS = {"tinyllama-1.1b": 1e-4, "gemma3-4b": 5e-4, "deepseek-7b": 1e-4, "qwen2-moe-a2.7b": 1e-4,
        "deepseek-v2-236b": 1e-4}


def _cells(arch: str):
    """The published train_4k cell of each package, cut to SEQ x BATCH."""
    jcell = next(c for c in jax_shapes(arch) if c.name == "train_4k")
    tcell = next(c for c in get_shapes(arch) if c.name == "train_4k")
    assert dict(jcell.params) == dict(tcell.params) == {"seq_len": 4096, "global_batch": 256}
    return (dataclasses.replace(jcell, params={"seq_len": SEQ, "global_batch": BATCH}),
            dryrun.batch_cut(dataclasses.replace(tcell, params={**tcell.params, "seq_len": SEQ}),
                             BATCH))


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield "/".join(path), tree


@pytest.mark.parametrize("arch", list(TOLS))
@pytest.mark.parametrize("remat", ["none", "full"])
def test_train_4k_step_matches_reference(arch, remat):
    jcfg = dataclasses.replace(jax_config(arch, smoke=True), dtype=jnp.float32)
    tcfg = dataclasses.replace(get_config(arch, smoke=True), dtype=torch.float32)
    if tcfg.local_global is not None:
        assert tcfg.local_window < SEQ  # the window bites
    jcell, tcell = _cells(arch)
    jp = jax_init(jax.random.PRNGKey(3), jax_tf.lm_specs(jcfg), jcfg.dtype)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    jbatch = jax_make_batch(jcfg, jcell, seed=4)
    tbatch = make_batch(tcfg, tcell, seed=4, device="cpu")
    for name in ("tokens", "targets"):
        np.testing.assert_array_equal(tbatch[name].numpy(), np.asarray(jbatch[name]))
    tol = TOLS[arch]
    # the gradient of the cell's loss at the remat, leaf by leaf
    (_, _), jg = jax.value_and_grad(jax_build_loss_fn(jcfg, jcell, remat=remat),
                                    has_aux=True)(jp, jbatch)
    req = {}

    def need(tree, path=()):
        if isinstance(tree, dict):
            return {k: need(v, path + (k,)) for k, v in tree.items()}
        req["/".join(path)] = tree.clone().requires_grad_(True)
        return req["/".join(path)]

    loss, _ = build_loss_fn(tcfg, tcell, remat=remat)(need(tp), tbatch)
    grads = dict(zip(req, torch.autograd.grad(loss, list(req.values()))))
    want = dict(_leaves(jg))
    assert sorted(grads) == sorted(want)
    for name, w in want.items():
        w = np.asarray(w, np.float32)
        err = np.abs(grads[name].numpy() - w).max()
        assert err <= tol * np.abs(w).max(), (name, err, np.abs(w).max())
    # one step of each package's train step
    jstate, jm = jax.jit(jax_build_train_step(jcfg, jcell, remat=remat))(
        jax_make_train_state(jp), jbatch)
    make_state, step = dryrun.build_step(tcfg, tcell, remat=remat)
    tstate, tm = step(make_state(tp), tbatch)
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4, err_msg=k)
    want = dict(_leaves(jstate["params"]))
    got = dict(_leaves(tstate["params"]))
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), np.asarray(w, np.float32), atol=tol,
                                   rtol=tol, err_msg=name)


@pytest.mark.parametrize("arch", list(TOLS))
def test_generator_batch_has_the_train_cell_specs(arch):
    """``make_batch(..., generator=)`` at the train cell: tokens and targets
    [B, S] int32, numpy's draw of the seed (the generator draws only
    floats, which a train cell has none of)."""
    cfg = get_config(arch, smoke=True)
    _, cell = _cells(arch)
    specs = input_specs(cfg, cell)
    drawn = make_batch(cfg, cell, seed=6, generator=torch.Generator().manual_seed(1))
    plain = make_batch(cfg, cell, seed=6, device="cpu")
    assert sorted(drawn) == sorted(specs) == ["targets", "tokens"]
    for name, spec in specs.items():
        t = drawn[name]
        assert tuple(t.shape) == tuple(spec.shape) == (BATCH, SEQ)
        assert t.dtype == spec.dtype == torch.int32 and t.device.type == "cpu"
        assert torch.equal(t, plain[name])
        assert int(t.min()) >= 0 and int(t.max()) < cfg.vocab
