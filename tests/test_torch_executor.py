"""The port's WorkflowExecutor against the reference's, on the CPU.

Each case of ``tests/test_store_executor.py`` runs on both packages, over
fresh stores, with the same modules and the same data: the runs must make the
same skip decisions, store the same keys with equal leaf blobs, and give equal
outputs.  The device wait is checked on the CPU as a no-op."""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro import core as jcore
from repro_torch import core as tcore
from repro_torch.core.executor import _nbytes, probe_reusable_prefix, wait_for_device


def leaf_blobs(store) -> dict:
    """key -> [(dtype, shape, leaf blob bytes)] over every stored artifact."""
    out = {}
    for key in sorted(store.records):
        man = json.loads(bytes(store.backend.read_blob(key, "manifest.json")))
        out[key] = [(e["dtype"], e["shape"], bytes(store.backend.read_blob(key, e["file"])))
                    for e in man["leaves"]]
    return out


class Pair:
    """One executor of each package, with the same modules and policy kind."""

    def __init__(self, tmp_path, policy="RISP", with_state=False, **kw):
        self.calls = {"jax": {}, "port": {}}
        self.ex = {}
        for side, core, xp in (("jax", jcore, jnp), ("port", tcore, torch)):
            store = core.IntermediateStore(tmp_path / side, **kw.pop("store_kw", {}))
            extra = {"device": "cpu"} if side == "port" else {}
            ex = core.WorkflowExecutor(
                store=store, policy=core.make_policy(
                    {"RISP": "PT"}.get(policy, policy), with_state=with_state),
                **kw, **extra)
            calls = self.calls[side]

            def count(name, fn, calls=calls):
                def wrapped(x, **params):
                    calls[name] = calls.get(name, 0) + 1
                    return fn(x, **params)

                return wrapped

            def failing(x, n_ok=0):
                raise RuntimeError("boom")

            ex.register(core.ModuleSpec("double", count("double", lambda x: x * 2)))
            ex.register(core.ModuleSpec("inc", count("inc", lambda x, by=1: x + by), {"by": 1}))
            ex.register(core.ModuleSpec("square", count("square", lambda x: x * x)))
            ex.register(core.ModuleSpec("fail", count("fail", failing)))
            self.ex[side] = ex

    def run(self, data: np.ndarray, steps, wid: str):
        """Both packages run ``steps``; their decisions must agree."""
        jr = self.ex["jax"].run("ds", jnp.asarray(data), steps, wid)
        tr = self.ex["port"].run("ds", torch.from_numpy(data.copy()), steps, wid)
        assert tr.n_skipped == jr.n_skipped
        assert tr.stored_keys == jr.stored_keys
        assert (tr.reused_prefix is None) == (jr.reused_prefix is None)
        if tr.reused_prefix is not None:
            assert tr.reused_prefix.key(True) == jr.reused_prefix.key(True)
        np.testing.assert_array_equal(tr.output.numpy(), np.asarray(jr.output))
        return jr, tr

    def same_stores(self) -> None:
        assert leaf_blobs(self.ex["port"].store) == leaf_blobs(self.ex["jax"].store)


def test_executor_prefix_skip(tmp_path):
    p = Pair(tmp_path, policy="TSAR")
    data = np.arange(6.0, dtype=np.float32)
    _, r1 = p.run(data, ["double", "inc", "square"], "w1")
    assert r1.n_skipped == 0
    _, r2 = p.run(data, ["double", "inc", "inc"], "w2")
    assert r2.n_skipped == 2
    assert p.calls["port"] == p.calls["jax"] == {"double": 1, "inc": 2, "square": 1}
    p.same_stores()


def test_executor_cache_equivalence(tmp_path):
    p = Pair(tmp_path, policy="TSAR")
    data = np.linspace(-2, 2, 16, dtype=np.float32)
    steps = ["double", ("inc", {"by": 3}), "square"]
    _, cold = p.run(data, steps, "w1")
    _, warm = p.run(data, steps, "w2")  # full-prefix hit
    assert warm.n_skipped == 3
    assert torch.equal(cold.output, warm.output)
    p.same_stores()


def test_executor_tool_state_distinguishes(tmp_path):
    p = Pair(tmp_path, policy="TSAR", with_state=True)
    data = np.ones(4, dtype=np.float32)
    p.run(data, [("inc", {"by": 1})], "w1")
    _, r = p.run(data, [("inc", {"by": 2})], "w2")
    assert r.n_skipped == 0
    _, r3 = p.run(data, [("inc", {"by": 2})], "w3")
    assert r3.n_skipped == 1
    p.same_stores()


def test_executor_error_recovery(tmp_path):
    p = Pair(tmp_path, policy="RISP")
    data = np.arange(4.0, dtype=np.float32)
    errors = {}
    for side, ex, x in (("jax", p.ex["jax"], jnp.asarray(data)),
                        ("port", p.ex["port"], torch.from_numpy(data.copy()))):
        err = jcore.WorkflowError if side == "jax" else tcore.WorkflowError
        with pytest.raises(err) as ei:
            ex.run("ds", x, ["double", "inc", "fail"], "w1")
        errors[side] = ei.value.failed_at
    assert errors == {"jax": 2, "port": 2}
    p.same_stores()  # the recovery point [double, inc], in both
    _, r = p.run(data, ["double", "inc", "square"], "w2")
    assert r.n_skipped == 2
    assert p.calls["port"]["double"] == p.calls["jax"]["double"] == 1


def test_executor_eviction_falls_back(tmp_path):
    p = Pair(tmp_path, policy="TSAR")
    data = np.arange(4.0, dtype=np.float32)
    p.run(data, ["double", "inc"], "w1")
    for ex in p.ex.values():
        ex.store.delete(ex.make_workflow("ds", ["double", "inc"]).prefix(2).key(False))
    _, r = p.run(data, ["double", "inc"], "w2")
    assert r.n_skipped == 1
    p.same_stores()


def test_cost_admission_runs_in_both_packages(tmp_path):
    p = Pair(tmp_path, policy="TSAR", admission="t1_gt_t2")
    big = np.ones((512, 512), dtype=np.float32)
    for side, x in (("jax", jnp.asarray(big)), ("port", torch.from_numpy(big))):
        r = p.ex[side].run("ds", x, ["double"], "w1")
        assert isinstance(r.stored_keys, list)  # stored or not by measured throughput


@pytest.mark.parametrize("policy", ["RISP", "TSAR", "TSPAR", "TSFR"])
def test_policies_make_the_same_decisions_over_a_stream(tmp_path, policy):
    """A stream of workflows sharing prefixes: every run's skips and stores
    agree between the packages, and the stores end up equal."""
    p = Pair(tmp_path, policy=policy, with_state=True)
    data = np.linspace(0, 1, 8, dtype=np.float32)
    stream = [["double", "inc", "square"], ["double", "inc", ("inc", {"by": 2})],
              ["double", "inc", "square"], ["double", ("inc", {"by": 5})],
              ["double", "inc", ("inc", {"by": 2}), "square"], ["double", "inc", "square"]]
    for i, steps in enumerate(stream):
        p.run(data, steps, f"w{i}")
    assert p.calls["port"] == p.calls["jax"]
    p.same_stores()


def test_provenance_records_match(tmp_path):
    logs = {}
    for side, core in (("jax", jcore), ("port", tcore)):
        logs[side] = core.ProvenanceLog(tmp_path / f"{side}.jsonl")
    p = Pair(tmp_path, policy="TSAR")
    for side in p.ex:
        p.ex[side].provenance = logs[side]
    data = np.arange(4.0, dtype=np.float32)
    p.run(data, ["double", "inc"], "w1")
    p.run(data, ["double", "square"], "w2")
    j, t = logs["jax"].records, logs["port"].records
    assert len(t) == len(j) == 2
    for a, b in zip(j, t):
        assert (a.modules, a.reused_prefix_depth, a.stored_keys, a.n_requests) == (
            b.modules, b.reused_prefix_depth, b.stored_keys, b.n_requests)


def test_nbytes_and_device_wait_on_the_cpu(tmp_path):
    value = {"a": torch.zeros(3, 4), "b": [torch.ones(2, dtype=torch.bfloat16), 7]}
    assert _nbytes(value) == 3 * 4 * 4 + 2 * 2
    assert wait_for_device(value) is value  # no CUDA leaf: nothing to wait for
    store = tcore.IntermediateStore(tmp_path / "s")
    policy = tcore.TSAR()
    wf = tcore.Workflow("ds", (tcore.ModuleRef("m"),))
    store.put(wf.prefix(1).key(False), value)
    got, loaded, _ = probe_reusable_prefix(store, policy, wf.prefix(1), device="cpu")
    assert got == wf.prefix(1)
    assert torch.equal(loaded["a"], value["a"]) and loaded["b"][1] == 7


def test_executor_defaults_to_the_card(tmp_path):
    """Reused prefixes load onto CUDA unless the caller asks for the CPU:
    without a card, a run that would reuse one raises, and never falls back."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    ex = tcore.WorkflowExecutor(store=tcore.IntermediateStore(tmp_path / "s"),
                                policy=tcore.TSAR())
    ex.register(tcore.ModuleSpec("double", lambda x: x * 2))
    assert ex.device == "cuda"
    ex.run("ds", torch.arange(3.0), ["double"], "w1")  # nothing stored yet: no load
    with pytest.raises(RuntimeError, match="CUDA"):
        ex.run("ds", torch.arange(3.0), ["double"], "w2")
