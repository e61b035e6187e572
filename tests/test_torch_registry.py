"""The port's ModuleRegistry against the reference's, on the CPU.

The serving engines of both packages, each with its own registry, record the
same chunk modules on the same fp32 smoke stream; the copied registry
resolves, validates and keys tool states as the reference does."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax
import jax.numpy as jnp

from repro.configs import get_config as jax_config
from repro.core import ModuleRegistry as JaxRegistry
from repro.core import ToolStateError as JaxToolStateError
from repro.models import transformer as jax_tf
from repro.models.layers import init_params as jax_init
from repro.serve import ServeEngine as JaxEngine
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core import MemoryBackend, ModuleRegistry, ToolStateError, UnknownModuleError
from repro_torch.serve import ServeEngine, mount_serve_engine

CHUNK, MAX_LEN, NEW = 16, 128, 3


@pytest.fixture(scope="module")
def model():
    jcfg = dataclasses.replace(jax_config("tinyllama-1.1b", smoke=True), dtype=jnp.float32)
    tcfg = dataclasses.replace(get_config("tinyllama-1.1b", smoke=True), dtype=torch.float32)
    jp = jax_init(jax.random.PRNGKey(0), jax_tf.lm_specs(jcfg), jcfg.dtype)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    return jcfg, jp, tcfg, tp


def _stream(vocab: int) -> list[list[int]]:
    rng = np.random.default_rng(0)
    system = rng.integers(0, vocab, size=3 * CHUNK).tolist()
    return [system + rng.integers(0, vocab, size=CHUNK).tolist() for _ in range(4)] + [system]


@pytest.mark.parametrize("mounted", [False, True])
def test_engine_registry_records_the_reference_chunk_modules(model, mounted):
    jcfg, jp, tcfg, tp = model
    jreg, treg = JaxRegistry(), ModuleRegistry()
    ref = JaxEngine(jcfg, jp, max_len=MAX_LEN, chunk=CHUNK, registry=jreg)
    if mounted:
        port = mount_serve_engine(MemoryBackend(), tcfg, tp, registry=treg, max_len=MAX_LEN,
                                  chunk=CHUNK, device="cpu")
    else:
        port = ServeEngine(tcfg, tp, max_len=MAX_LEN, chunk=CHUNK, registry=treg, device="cpu")
    for prompt in _stream(jcfg.vocab):
        want, _ = ref.generate(prompt, NEW)
        got, _ = port.generate(prompt, NEW)
        assert got == want
        assert sorted(treg) == sorted(jreg)
    assert len(treg) == 3 + 4  # the shared system prompt's chunks, then each tail
    for mid in treg:
        # a chunk observed after the first prefill carries a cost hint in both
        assert (treg[mid].cost_hint is None) == (jreg[mid].cost_hint is None)
        with pytest.raises(NotImplementedError):
            treg[mid].fn(None)  # observed, not executable


def test_registry_resolution_matches_reference():
    out = {}
    for side, reg in (("jax", JaxRegistry()), ("port", ModuleRegistry())):

        @reg.module("norm", eps=1e-6)
        def norm(x, eps=1e-6, *, axis=0):
            return x

        reg.register_fn("inc", lambda x, by=1: x + by, by=1)
        reg.ensure("seen", cost_hint=0.5)
        reg.ensure("seen", cost_hint=9.0)  # kept: the first hint stands
        ref = reg.ref("norm", {"axis": 1})
        out[side] = (sorted(reg), ref.key(True), reg.resolve_params(ref),
                     reg.make_state("inc", {"by": 4}).digest, reg["seen"].cost_hint)
    assert out["port"] == out["jax"]


def test_registry_errors_match_reference():
    for reg, err in ((JaxRegistry(), JaxToolStateError), (ModuleRegistry(), ToolStateError)):
        reg.register_fn("inc", lambda x, by=1: x + by, by=1)
        with pytest.raises(err):
            reg.ref("inc", {"bogus": 1})
        with pytest.raises(KeyError):
            reg["missing"]
    with pytest.raises(UnknownModuleError):
        ModuleRegistry()["missing"]
