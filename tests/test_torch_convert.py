"""Parameters cross from the reference package to the port and back, bit for
bit, under the names and shapes of ``lm_specs``."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax
import jax.numpy as jnp

from repro.configs import get_config as jax_config
from repro.models import transformer as jax_tf
from repro.models.layers import init_params as jax_init
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.models.layers import PSpec, init_params
from repro_torch.models.transformer import lm_specs

ARCHS = ["tinyllama-1.1b", "gemma3-4b", "deepseek-7b", "qwen2-moe-a2.7b", "deepseek-v2-236b"]


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix.rstrip("/"): tree}


def _jax_numpy_params(arch, dtype):
    cfg = dataclasses.replace(jax_config(arch, smoke=True), dtype=dtype)
    params = jax_init(jax.random.PRNGKey(0), jax_tf.lm_specs(cfg), cfg.dtype)
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_round_trip_is_bit_exact(arch, dtype):
    tree = _jax_numpy_params(arch, getattr(jnp, dtype))
    tp = params_from_numpy(tree, "cpu")
    back = params_to_numpy(tp)
    want, got = _flat(tree), _flat(back)
    assert want.keys() == got.keys()
    for name, a in want.items():
        b = got[name]
        assert b.dtype == a.dtype, name
        assert b.shape == a.shape, name
        assert np.array_equal(a.view(np.uint8), b.view(np.uint8)), name
    want_torch = torch.float32 if dtype == "float32" else torch.bfloat16
    assert all(t.dtype == want_torch for t in _flat(tp).values())


@pytest.mark.parametrize("arch", ARCHS)
def test_names_and_shapes_match_lm_specs(arch):
    tree = _jax_numpy_params(arch, jnp.float32)
    tp = _flat(params_from_numpy(tree, "cpu"))
    specs = _flat(lm_specs(get_config(arch, smoke=True)))
    jax_specs = jax.tree_util.tree_map(
        lambda s: s.shape,
        jax_tf.lm_specs(jax_config(arch, smoke=True)),
        is_leaf=lambda x: hasattr(x, "axes"),
    )
    assert tp.keys() == specs.keys() == _flat(jax_specs).keys()
    for name, spec in specs.items():
        assert tuple(tp[name].shape) == spec.shape == _flat(jax_specs)[name], name


def test_converted_params_do_not_share_memory():
    src = {"w": np.ones((4, 4), np.float32)}
    t = params_from_numpy(src, "cpu")
    src["w"][:] = 7.0
    assert float(t["w"].sum()) == 16.0


def test_init_params_follows_the_reference_scheme():
    specs = {
        "norm": PSpec((512,), ("embed",), init="zeros"),
        "w": PSpec((256, 512), ("embed", "ff")),
        "embed": PSpec((512, 64), ("vocab", "embed"), scale=0.02),
    }
    p = init_params(torch.Generator().manual_seed(0), specs, torch.bfloat16, "cpu")
    assert list(p) == sorted(specs)  # drawn in the order jax flattens a dict
    assert p["norm"].dtype == torch.bfloat16 and not p["norm"].any()
    # normal x 1/sqrt(fan_in), fan_in = shape[-2]; explicit scale wins
    assert abs(p["w"].float().std().item() - 1 / np.sqrt(256)) < 0.003
    assert abs(p["embed"].float().std().item() - 0.02) < 0.001


def test_cuda_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    specs = {"w": PSpec((2, 2), ("a", "b"))}
    with pytest.raises(RuntimeError, match="CUDA"):
        init_params(torch.Generator().manual_seed(0), specs, torch.float32, "cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        params_from_numpy({"w": np.zeros(2, np.float32)}, "cuda")
