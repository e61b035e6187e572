"""The reference's LM serve cells (``prefill`` and ``decode`` through
``build_serve_step``, with the batch from ``make_batch``) on the port
against the reference package, at a cut of ``seq_len`` 1,536 and
``global_batch`` 3: ``cache_len`` is 768, the keys span two 512-wide
blocks of the reference's chunked attention, and gemma3-smoke's window of 8
bites.  The MoE archs (qwen2-moe, and deepseek-v2 with MLA's latent cache
``c_kv``, ``k_rope``) at ``seq_len`` 2,048 and ``global_batch`` 2: a
prefill's B * S must be a whole number of 1,024-token MoE groups, or both
packages raise; ``cache_len`` 1,024 spans two 512-key blocks.  Each
package draws its own batch from the same seed; the parameters are the
reference's, converted.  Then ``apply_rope`` at the long positions
of ``prefill_32k`` and ``long_500k``, and ``make_batch``'s draw on a
``torch.Generator`` (the one the card's cells use).

Tolerances: fp32 1e-4 of the largest reference value (the frameworks take
the same sums in another order).  bf16: the larger of 5e-2 of it and the
reference's own distance from its fp32 run of the same batch, as
``tests/test_torch_train.py`` holds bf16 logits: XLA keeps excess
precision inside its fusions where torch rounds each op."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax
import jax.numpy as jnp
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import get_config as jax_config
from repro.data.synthetic import make_batch as jax_make_batch
from repro.models import transformer as jax_tf
from repro.models.layers import apply_rope as jax_apply_rope
from repro.models.layers import init_params as jax_init
from repro.train.step import build_serve_step as jax_serve_step
from repro_torch.configs import ShapeCell, get_config
from repro_torch.configs.base import input_specs
from repro_torch.convert import params_from_numpy
from repro_torch.data import make_batch
from repro_torch.data import synthetic
from repro_torch.models import moe
from repro_torch.models.layers import apply_rope
from repro_torch.train import build_serve_step

TOLS = {"float32": 1e-4, "bfloat16": 5e-2}
TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}
SEQ, BATCH = 1536, 3
MOE_CUT = {"qwen2-moe-a2.7b": (2048, 2), "deepseek-v2-236b": (2048, 2)}  # (seq_len, batch)


def _cell(kind: str, arch: str) -> ShapeCell:
    name = {"prefill": "prefill_32k", "decode": "decode_32k"}[kind]
    seq, batch = MOE_CUT.get(arch, (SEQ, BATCH))
    return ShapeCell(name, kind, {"seq_len": seq, "global_batch": batch})


def _configs(arch: str, dtype: str):
    return (dataclasses.replace(jax_config(arch, smoke=True), dtype=getattr(jnp, dtype)),
            dataclasses.replace(get_config(arch, smoke=True), dtype=TORCH_DTYPE[dtype]))


def _jax_step(jcfg, cell, jp, batch):
    step = jax_serve_step(jcfg, cell)
    if cell.kind == "decode":
        return step(jp, batch["tokens"], batch["cache"], batch["cache_len"])
    return step(jp, batch["tokens"])


def _f32(tree):
    return jax.tree_util.tree_map(
        lambda a: a.astype(jnp.float32) if jnp.issubdtype(a.dtype, jnp.floating) else a, tree)


def _bound(want, want32, dtype: str) -> float:
    want = np.asarray(want, np.float32)
    if dtype == "float32":
        return TOLS[dtype] * np.abs(want).max()
    return max(TOLS[dtype] * np.abs(want).max(),
               np.abs(want - np.asarray(want32, np.float32)).max())


def _tf32(tree):
    if isinstance(tree, dict):
        return {k: _tf32(v) for k, v in tree.items()}
    return tree.float() if tree.is_floating_point() else tree


def _routed_as(routes: list, record: bool):
    """``moe.route`` that appends each call's (ids, slots) to ``routes``, or
    (``record`` False) takes them from it in call order and computes the
    gates from this call's own inputs, as ``route`` does."""
    inner = moe.route
    calls = iter(routes)

    def route(x, router, dims):
        if record:
            out = inner(x, router, dims)
            routes.append(out[1:])
            return out
        idx, slot = next(calls)
        G, g, _ = moe.groups(x.shape[0] * x.shape[1], dims)
        probs = torch.softmax((x.reshape(G, g, -1) @ router).float(), dim=-1).gather(-1, idx)
        return probs / probs.sum(-1, keepdim=True).clamp_min(1e-9), idx, slot
    return route


def _run(jcfg, tcfg, cell, jp, tp, jb, tb, dtype):
    """Both packages' steps: (the reference's outputs, its fp32 run's, the
    port's).  An MoE model's bf16 step routes as the port's fp32 step of the
    same batch (expert ids and slots replayed): a near tie of two experts'
    probabilities rounds either way in bf16, and each framework rounds its
    own, so a token's expert can part between the packages (deepseek-v2-smoke's
    prefill: 0.6% of the first layer's choices part between the port's bf16
    and fp32 runs, one of them a sequence's last token's, which moves its
    logits by 5.6% of the largest).  The reference's own flips stay in its distance from
    its fp32 run, which the bound takes."""
    want = _jax_step(jcfg, cell, jp, jb)
    want32 = (_jax_step(dataclasses.replace(jcfg, dtype=jnp.float32), cell, _f32(jp), _f32(jb))
              if dtype == "bfloat16" else want)
    decode = cell.kind == "decode"
    args = (tp, tb["tokens"], tb["cache"], tb["cache_len"]) if decode else (tp, tb["tokens"])
    step = build_serve_step(tcfg, cell)
    if tcfg.moe is None or dtype == "float32":
        return want, want32, step(*args)
    routes, inner = [], moe.route
    try:
        moe.route = _routed_as(routes, record=True)
        build_serve_step(dataclasses.replace(tcfg, dtype=torch.float32), cell)(
            *(_tf32(a) for a in args))
        moe.route = _routed_as(routes, record=False)
        return want, want32, step(*args)
    finally:
        moe.route = inner


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "gemma3-4b", "deepseek-7b",
                                  "qwen2-moe-a2.7b", "deepseek-v2-236b"])
@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_serve_step_matches_reference(arch, kind, dtype):
    """Decode: ``make_batch`` draws every cache row, the one at
    ``cache_len`` too, and the reference's insert adds the step's K/V row to
    what is there (a one-hot product) where the port's writes it.  So the
    drawn batch is held as each package defines it (the port's row in the
    first layer is the reference's less the drawn one; past it the hidden
    states part, since each attended a different row), and the logits and
    every layer's row on the batch with that row zero, as the serving
    engine keeps a cache's tail.  MLA's cache is the latent rows."""
    jcfg, tcfg = _configs(arch, dtype)
    cell = _cell(kind, arch)
    seq, batch = cell.params["seq_len"], cell.params["global_batch"]
    names = ("c_kv", "k_rope") if tcfg.mla is not None else ("k", "v")
    jp = jax_init(jax.random.PRNGKey(0), jax_tf.lm_specs(jcfg), jcfg.dtype)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    jb = jax_make_batch(jcfg, cell, seed=4)
    tb = make_batch(tcfg, cell, seed=4, device="cpu")
    np.testing.assert_array_equal(tb["tokens"].numpy(), np.asarray(jb["tokens"]))
    # the cache rows the step writes: decode's row at cache_len in every
    # layer, prefill's whole cache
    at = (slice(None), slice(None), seq // 2) if kind == "decode" else (slice(None),)
    if kind == "decode":
        assert int(tb["cache_len"][0]) == seq // 2 == int(jb["cache_len"][0])
        first = (0, slice(None), seq // 2)
        drawn = {}
        for name in names:
            drawn[name] = np.asarray(jb["cache"][name], np.float32)[first]
            np.testing.assert_array_equal(tb["cache"][name].float().numpy(),
                                          np.asarray(jb["cache"][name], np.float32))
        want, want32, (_, cache, _) = _run(jcfg, tcfg, cell, jp, tp, jb, tb, dtype)
        for name in names:
            w = np.asarray(want[1][name], np.float32)[first] - drawn[name]
            w32 = np.asarray(want32[1][name], np.float32)[first] - drawn[name]
            got = cache[name].float().numpy()[first]
            assert np.abs(got - w).max() <= _bound(w, w32, dtype)
        jb["cache"] = {n: c.at[:, :, seq // 2].set(0) for n, c in jb["cache"].items()}
        tb = make_batch(tcfg, cell, seed=4, device="cpu")
        for c in tb["cache"].values():
            c[:, :, seq // 2] = 0
    want, want32, (logits, cache, clen) = _run(jcfg, tcfg, cell, jp, tp, jb, tb, dtype)
    assert logits.dtype == torch.float32 and logits.shape == (batch, jcfg.vocab)
    err = np.abs(logits.numpy() - np.asarray(want[0])).max()
    assert err <= _bound(want[0], want32[0], dtype)
    np.testing.assert_array_equal(clen.numpy(), np.asarray(want[2]))
    for name in names:
        g = cache[name].float().numpy()[at]
        w, w32 = np.asarray(want[1][name], np.float32)[at], np.asarray(want32[1][name])[at]
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= _bound(w, w32, dtype)


@pytest.mark.parametrize("dh,theta", [(64, 1e4), (256, 1e6)], ids=["dh64", "dh256"])
@pytest.mark.parametrize("start", [0, 32_704, 524_224])
def test_rope_at_long_positions_matches_reference(dh, theta, start):
    """64 positions from ``start`` (the last of ``prefill_32k``'s and of
    ``long_500k``'s 524,288) in fp32.  The two packages part by fp32
    rounding of large angles: up to 5.2e-5 from 524,224 at dh 256 and theta
    1e6, at most 4.8e-7 from position 0; 1e-4 holds them."""
    x = np.random.default_rng(start + dh).standard_normal((1, 64, 2, dh)).astype(np.float32)
    pos = np.arange(start, start + 64, dtype=np.int32)[None]
    want = np.asarray(jax_apply_rope(jnp.asarray(x), jnp.asarray(pos), theta))
    got = apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


# --------------------------------------------------------------------------
# make_batch on a torch.Generator
# --------------------------------------------------------------------------
CELLS = [("tinyllama-1.1b", "decode", torch.bfloat16), ("gemma3-4b", "decode", torch.float32),
         ("gemma3-4b", "prefill", torch.bfloat16)]


@pytest.mark.parametrize("arch,kind,dtype", CELLS, ids=["tinyllama-decode-bf16",
                                                        "gemma3-decode-fp32",
                                                        "gemma3-prefill-bf16"])
def test_generator_batch_has_the_specs_and_the_numpy_integers(arch, kind, dtype):
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype=dtype)
    cell = ShapeCell("c", kind, {"seq_len": 256, "global_batch": 3})
    drawn = make_batch(cfg, cell, seed=5, generator=torch.Generator().manual_seed(9))
    plain = make_batch(cfg, cell, seed=5, device="cpu")
    specs = input_specs(cfg, cell)

    def walk(d, s, p):
        for name, spec in s.items():
            if isinstance(spec, dict):
                walk(d[name], spec, p[name])
                continue
            t = d[name]
            assert tuple(t.shape) == tuple(spec.shape) and t.dtype == spec.dtype
            if t.dtype.is_floating_point:
                assert abs(t.float().std().item() - 0.1) < 0.01
                assert not torch.equal(t, p[name])  # drawn anew, not numpy's
            else:
                assert torch.equal(t, p[name])  # tokens and cache_len are numpy's

    walk(drawn, specs, plain)
    again = make_batch(cfg, cell, seed=5, generator=torch.Generator().manual_seed(9))
    assert all(torch.equal(a, b) for a, b in zip(_leaves(drawn), _leaves(again)))
    if kind == "decode":  # each layer drawn anew
        k = drawn["cache"]["k"]
        assert not torch.equal(k[0], k[1])


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    else:
        yield tree


class _Made(TorchDispatchMode):
    """(dtype, numel) of every tensor an op makes."""

    def __init__(self):
        super().__init__()
        self.made = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor):
                self.made.append((t.dtype, t.numel()))
        return out


class _SpyRng:
    """A numpy Generator that records the dtype and size of what it draws."""

    def __init__(self, rng, drawn):
        self._rng, self._drawn = rng, drawn

    def __getattr__(self, name):
        fn = getattr(self._rng, name)

        def spied(*args, **kwargs):
            out = fn(*args, **kwargs)
            a = np.asarray(out)
            self._drawn.append((name, a.dtype, a.size))
            return out

        return spied


def test_generator_batch_makes_no_float64_and_no_copy_of_the_cache(monkeypatch):
    cfg = get_config("tinyllama-1.1b", smoke=True)  # bf16
    cell = ShapeCell("c", "decode", {"seq_len": 512, "global_batch": 4})
    L, B, T, Hkv, dh = cfg.n_layers, 4, 512, cfg.n_kv_heads, cfg.head_dim
    layer = B * T * Hkv * dh
    drawn = []
    real = np.random.default_rng
    monkeypatch.setattr(synthetic.np.random, "default_rng",
                        lambda seed: _SpyRng(real(seed), drawn))
    with _Made() as spy:
        batch = make_batch(cfg, cell, seed=0, generator=torch.Generator().manual_seed(0))
    assert batch["cache"]["k"].shape == (L, B, T, Hkv, dh)
    # numpy drew the tokens only: no normal draw, no float array
    assert [(n, s) for n, _, s in drawn] == [("integers", B)]
    assert all(not np.issubdtype(d, np.floating) for _, d, _ in drawn)
    # torch made no float64 tensor, no float in another dtype than the
    # spec's, and nothing the size of the cache but the cache itself
    floats = [(d, n) for d, n in spy.made if d.is_floating_point]
    assert floats and all(d == torch.bfloat16 for d, _ in floats)
    assert all(n <= layer for d, n in floats if n != L * layer)
    assert sum(n == L * layer for _, n in floats) == 2  # k and v, allocated once each
