"""The port's DAG scheduler and WorkflowService against the reference's, on
the CPU.

Each case of ``tests/test_sched.py`` that runs a DAG runs on both packages,
over fresh stores, with the same modules and data: node sources, skips,
stored keys, leaf blobs and outputs must agree.  The DAG model, the
dispatcher and the tenant ledger are copies; their own behaviour is checked
against the reference's on the same inputs."""
import json
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro import core as jcore
from repro import sched as jsched
from repro_torch import core as tcore
from repro_torch import sched as tsched

SIDES = (("jax", jcore, jsched, jnp.asarray), ("port", tcore, tsched,
                                                lambda a: torch.from_numpy(np.array(a))))


def leaf_blobs(store) -> dict:
    """key -> [(dtype, shape, leaf blob bytes)] over every stored artifact."""
    out = {}
    for key in sorted(store.records):
        man = json.loads(bytes(store.backend.read_blob(key, "manifest.json")))
        out[key] = [(e["dtype"], e["shape"], bytes(store.backend.read_blob(key, e["file"])))
                    for e in man["leaves"]]
    return out


def _as_np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class Services:
    """One WorkflowService of each package over its own fresh store."""

    def __init__(self, tmp_path, max_workers=4, policy="TSAR", store_kw=None, **kw):
        self.calls = {}
        self.svc = {}
        self.to = {}
        for side, core, sched, to in SIDES:
            store = core.IntermediateStore(tmp_path / side, **(store_kw or {}))
            extra = {"device": "cpu"} if side == "port" else {}
            svc = sched.WorkflowService(
                store=store, policy=core.make_policy(policy, with_state=True),
                max_workers=max_workers, **kw, **extra)
            calls = {"double": 0, "inc": 0, "merge": 0, "fail": 0}
            lock = threading.Lock()

            def count(name, fn, calls=calls, lock=lock):
                def wrapped(x, **params):
                    with lock:
                        calls[name] += 1
                    return fn(x, **params)

                return wrapped

            def failing(x, calls=calls, lock=lock):
                with lock:
                    calls["fail"] += 1
                raise RuntimeError("boom")

            svc.register_fn("double", count("double", lambda x: x * 2))
            svc.register_fn("inc", count("inc", lambda x, by=1: x + by), by=1)
            svc.register_fn("merge", count("merge", lambda xs: sum(xs[1:], xs[0])))
            svc.register_fn("fail", failing)
            self.calls[side], self.svc[side], self.to[side] = calls, svc, to

    def run_steps(self, data, steps, wid):
        res = {s: self.svc[s].run_steps("ds", self.to[s](data), steps, wid) for s in self.svc}
        self.agree(res)
        return res["port"]

    def run_dag(self, build, data, wid="w"):
        res = {}
        for s, svc in self.svc.items():
            dag = svc.dag("ds", wid)
            build(dag)
            res[s] = svc.run(dag, self.to[s](data))
        self.agree(res)
        return res["port"]

    def agree(self, res) -> None:
        j, t = res["jax"], res["port"]
        assert t.n_skipped == j.n_skipped
        assert sorted(t.stored_keys) == sorted(j.stored_keys)
        assert {n: (r.source, r.key, r.stored) for n, r in t.node_results.items()} == {
            n: (r.source, r.key, r.stored) for n, r in j.node_results.items()}
        assert t.outputs.keys() == j.outputs.keys()
        for k in t.outputs:
            np.testing.assert_array_equal(_as_np(t.outputs[k]), _as_np(j.outputs[k]))

    def same_stores(self) -> None:
        assert leaf_blobs(self.svc["port"].store) == leaf_blobs(self.svc["jax"].store)

    def close(self) -> None:
        for svc in self.svc.values():
            svc.close()


@pytest.fixture()
def svcs(tmp_path):
    s = Services(tmp_path)
    yield s
    s.close()


def _fan(dag):
    dag.add("a", "double")
    dag.add("b", "inc", {"by": 3}, after="a")
    dag.add("c", "inc", {"by": 5}, after="a")
    dag.add("m", "merge", after=("b", "c"))


def test_dag_model_matches_reference():
    """The copied DAG model: the same order, paths, chain prefixes and keys."""
    out = {}
    for side, core, sched, _ in SIDES:
        reg = core.ModuleRegistry()
        for mid in ("double", "inc", "merge"):
            reg.register_fn(mid, lambda x, by=1: x, by=1)
        dag = sched.DagWorkflow("ds", "w", registry=reg)
        _fan(dag)
        dag.add("d", "inc", {"by": 7}, after="c")
        out[side] = (dag.topo_order(), [w.key(True) for w in
                                        (p.prefix(len(p)) for p in dag.paths())],
                     {n: (p.key(True) if p else None) for n, p in
                      ((n, dag.chain_prefix(n)) for n in dag.topo_order())},
                     dag.sinks(), dag.module_keys())
    assert out["port"] == out["jax"]


def test_dag_validation_errors_match_reference():
    for side, core, sched, _ in SIDES:
        dag = sched.DagWorkflow("ds")
        dag.add("a", "double")
        with pytest.raises(ValueError):
            dag.add("a", "inc")
        with pytest.raises(ValueError):
            dag.add("b", "inc", after="zzz")


def test_dag_matches_sequential_executor(tmp_path):
    """A chain DAG gives the sequential executor's exact output and shares
    its stored artifacts, in both packages."""
    data = np.linspace(-2, 2, 16, dtype=np.float32)
    steps = ["double", ("inc", {"by": 3})]
    for side, core, sched, to in SIDES:
        extra = {"device": "cpu"} if side == "port" else {}
        ex = core.WorkflowExecutor(store=core.IntermediateStore(tmp_path / side),
                                   policy=core.TSAR(with_state=True), **extra)
        ex.register_fn("double", lambda x: x * 2)
        ex.register_fn("inc", lambda x, by=1: x + by, by=1)
        seq = ex.run("ds", to(data), steps, "w1")
        calls = {"n": 0}

        def double(x, calls=calls):
            calls["n"] += 1
            return x * 2

        svc = sched.WorkflowService(store=ex.store, policy=ex.policy, **extra)
        svc.register_fn("double", double)
        svc.register_fn("inc", lambda x, by=1: x + by, by=1)
        r = svc.run_steps("ds", to(data), steps, "w2")
        assert calls["n"] == 0 and r.n_skipped == 2
        np.testing.assert_array_equal(_as_np(r.output), _as_np(seq.output))
        svc.close()


def test_dag_fan_out_fan_in_correctness(svcs):
    r = svcs.run_dag(_fan, np.arange(4.0, dtype=np.float32), "w1")
    np.testing.assert_allclose(r.output.numpy(), (np.arange(4.0) * 2 + 3) + (np.arange(4.0) * 2 + 5))
    assert svcs.calls["port"]["double"] == svcs.calls["jax"]["double"] == 1
    assert r.node_results["m"].key is None
    svcs.same_stores()


def test_dag_prefix_reuse_and_pruning(svcs):
    data = np.arange(6.0, dtype=np.float32)
    svcs.run_steps(data, ["double", ("inc", {"by": 1}), "double"], "w1")
    r2 = svcs.run_steps(data, ["double", ("inc", {"by": 1}), ("inc", {"by": 9})], "w2")
    assert r2.n_skipped == 2 and r2.reused_prefix.depth == 2
    assert sorted(r.source for r in r2.node_results.values()) == ["computed", "loaded", "pruned"]
    assert svcs.calls["port"] == svcs.calls["jax"]
    svcs.same_stores()


def test_dag_module_failure_raises_and_recovers(svcs):
    data = np.arange(4.0, dtype=np.float32)

    def chain(dag):
        dag.add("a", "double")
        dag.add("b", "inc", after="a")
        dag.add("f", "fail", after="b")

    for side, core, sched, to in SIDES:
        svc = svcs.svc[side]
        dag = svc.dag("ds", "w1")
        chain(dag)
        with pytest.raises(sched.DagWorkflowError) as ei:
            svc.run(dag, to(data))
        assert ei.value.node_id == "f"
    svcs.same_stores()  # both persisted the recovery points
    r = svcs.run_steps(data, ["double", "inc", "double"], "w2")
    assert svcs.calls["port"]["double"] == svcs.calls["jax"]["double"] == 2
    assert svcs.calls["port"]["inc"] == svcs.calls["jax"]["inc"] == 1
    np.testing.assert_allclose(r.output.numpy(), (np.arange(4.0) * 2 + 1) * 2)


def test_dag_provenance_records(tmp_path):
    logs = {side: core.ProvenanceLog(tmp_path / f"{side}.jsonl") for side, core, _, _ in SIDES}
    svcs = Services(tmp_path, provenance=None)
    for side, svc in svcs.svc.items():
        svc.scheduler.provenance = logs[side]
    svcs.run_steps(np.arange(4.0, dtype=np.float32), ["double", "inc"], "w1")
    svcs.close()
    j, t = logs["jax"].records[0], logs["port"].records[0]
    assert t.extra.get("scheduler") == "dag"
    assert (t.modules, t.reused_prefix_depth, t.stored_keys, t.n_requests) == (
        j.modules, j.reused_prefix_depth, j.stored_keys, j.n_requests)


@pytest.mark.parametrize("workers", [1, 4])
def test_scheduler_worker_counts_equivalent(tmp_path, workers):
    svcs = Services(tmp_path, max_workers=workers)

    def fan(dag):
        dag.add("a", "double")
        for i in range(6):
            dag.add(f"b{i}", "inc", {"by": i}, after="a")

    r = svcs.run_dag(fan, np.arange(8.0, dtype=np.float32))
    assert len(r.outputs) == 6
    svcs.same_stores()
    svcs.close()


def test_dag_recomputes_when_planned_load_vanishes(svcs):
    data = np.arange(4.0, dtype=np.float32)
    svcs.run_steps(data, ["double", "inc"], "w1")
    restore = []
    for side in svcs.svc:
        store = svcs.svc[side].store
        deep_key = [k for k in store.records if ">" in k][0]
        real_get = store.get
        vanished = {"done": False}

        def vanishing_get(key, *args, real_get=real_get, deep_key=deep_key, vanished=vanished):
            if key == deep_key and not vanished["done"]:
                vanished["done"] = True
                raise KeyError(key)
            return real_get(key, *args)

        store.get = vanishing_get
        restore.append((store, real_get, vanished))
    try:
        r = svcs.run_steps(data, ["double", "inc", ("inc", {"by": 9})], "w2")
    finally:
        for store, real_get, _ in restore:
            store.get = real_get
    assert all(v["done"] for _, _, v in restore)
    np.testing.assert_allclose(r.output.numpy(), np.arange(4.0) * 2 + 1 + 9)
    assert svcs.calls["port"] == svcs.calls["jax"] == {"double": 1, "inc": 3, "merge": 0, "fail": 0}


def test_service_singleflight_stress(tmp_path):
    """16 overlapping DAGs sharing one prefix: computed once, every run
    succeeds, the budget holds; the same in both packages."""
    capacity = 1 << 20
    for side, core, sched, to in SIDES:
        store = core.IntermediateStore(tmp_path / side, capacity_bytes=capacity)
        extra = {"device": "cpu"} if side == "port" else {}
        svc = sched.WorkflowService(store=store, policy=core.TSAR(with_state=True),
                                    max_workers=4, **extra)
        n_shared = [0]
        lock = threading.Lock()
        release = threading.Event()

        def shared_stem(x, n_shared=n_shared, lock=lock, release=release):
            with lock:
                n_shared[0] += 1
            release.wait(timeout=5.0)
            return x * 2

        svc.register_fn("stem", shared_stem)
        svc.register_fn("tail", lambda x, by=0: x + by, by=0)
        futs = []
        for i in range(16):
            dag = svc.dag("ds", f"w{i}")
            dag.add("a", "stem")
            dag.add("b", "tail", {"by": i}, after="a")
            futs.append(svc.submit(dag, to(np.arange(32.0, dtype=np.float32))))
        release.set()
        results = [f.result(timeout=60) for f in futs]
        assert n_shared[0] == 1, side
        for i, r in enumerate(results):
            np.testing.assert_allclose(_as_np(r.output), np.arange(32.0) * 2 + i)
        stats = svc.stats()
        assert stats.runs == 16 and stats.failures == 0 and stats.singleflight_waits >= 1
        assert store.total_disk_bytes <= capacity
        svc.close()


def test_service_stats_shape(svcs):
    data = np.arange(4.0, dtype=np.float32)
    svcs.run_steps(data, ["double"], "w1")
    svcs.run_steps(data, ["double"], "w2")
    j, t = svcs.svc["jax"].stats(), svcs.svc["port"].stats()
    assert (t.runs, t.units_total, t.units_skipped) == (j.runs, j.units_total, j.units_skipped)
    assert t.runs == 2 and 0.0 <= t.reuse_rate <= 1.0


def test_tenant_ledger_matches_reference():
    out = {}
    for side, _, sched, _ in SIDES:
        led = sched.TenantLedger()
        led.charge_stored("t:a", "k1", 100)
        led.charge_stored("t:a", "k2", 50)
        led.charge_stored("t:b", "k3", 7)
        led.credit_evicted("k1")
        led.credit_evicted("k1")  # a second credit of one key changes nothing
        out[side] = (led.bytes_stored("t:a"), led.bytes_stored("t:b"))
    assert out["port"] == out["jax"] == (50, 7)
