"""The port's front door (``repro_torch.api``): ``ModuleRegistry``,
``WorkflowSpec``, ``Client`` and the recommender, on the CPU.

Modelled on ``tests/test_api.py``, all 45 of its cases, on torch tensors (array
parameters stay numpy, as in the reference); the port's engines load reused
prefixes where the caller says, so every executor, service and client here
takes ``device="cpu"``.  Beyond them, held against the reference package and
exactly: a spec parsed from the same JSON, or imported from the same Galaxy
``.ga`` document, has the same digest, ``to_json()`` text and ``PrefixKey``
store keys in both packages; after both replay ``galaxy_ch4_corpus()``,
``recommend`` of held-out partial chains gives equal reports; and
``Client.serve_engine(..., device="cpu")`` publishes its KV snapshots to the
catalog.
"""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from repro_torch.api import (
    Client,
    ModuleRegistry,
    SpecError,
    ToolStateError,
    UnknownModuleError,
    WorkflowSpec,
)
from repro_torch.core import (
    IntermediateStore,
    ModuleSpec,
    RISP,
    TSAR,
    WorkflowExecutor,
    decode_param,
    encode_param,
    galaxy_ch4_corpus,
)
from repro_torch.core.workflow import ToolState
from repro_torch.sched import WorkflowService


# -- canonical tool-state params (from_config round-trip) ---------------------
class TestToolStateRoundTrip:
    @pytest.mark.parametrize(
        "value",
        [
            None,
            True,
            3,
            0.1,
            1e-300,
            "fast",
            "1.5",  # string that looks numeric must stay a string
            (1, 2),
            (1.5, "a", None),
            [1, [2, 3]],
            {"a": (1.0, 2), "b": {"c": [4, 5]}},
            {1, 2, 3},
            frozenset({"x", "y"}),
            b"\x00\xffraw",
            (("nested",), {"deep": (0.25,)}),
        ],
    )
    def test_encode_decode_identity(self, value):
        out = decode_param(encode_param(value))
        assert out == value
        assert type(out) is type(value)

    def test_tool_state_config_roundtrip(self):
        cfg = {"scale": 2.5, "dims": (0, 1), "opts": {"mode": "fast", "k": [1, 2]}}
        state = ToolState.from_config(cfg)
        assert state.to_config() == cfg
        # tuples must stay tuples (the old repr path happened to get this
        # right; the canonical path must not regress it)
        assert isinstance(state.to_config()["dims"], tuple)

    def test_ndarray_param_roundtrips(self):
        cfg = {"w": np.arange(6, dtype=np.float32).reshape(2, 3)}
        out = ToolState.from_config(cfg).to_config()
        np.testing.assert_array_equal(out["w"], cfg["w"])
        assert out["w"].dtype == np.float32

    def test_non_recoverable_param_raises_loudly(self):
        # the old repr path silently degraded this to the string "slice(...)"
        with pytest.raises(TypeError, match="not value-recoverable"):
            ToolState.from_config({"s": slice(1, 2)})

    def test_nested_frozenset_roundtrips(self):
        v = frozenset({frozenset({1, 2}), 3})
        out = decode_param(encode_param(v))
        assert out == v and isinstance(out, frozenset)
        assert {type(e) for e in out} == {frozenset, int}

    def test_non_str_key_dict_order_independent(self):
        # non-str-key dicts must encode insertion-order independently, or
        # value-equal tool states digest differently across processes
        a = encode_param({"m": {1: "a", 2: "b"}})
        b = encode_param({"m": {2: "b", 1: "a"}})
        assert a == b
        assert decode_param(a) == {"m": {1: "a", 2: "b"}}
        # frozenset keys survive too
        k = frozenset({1, 2})
        assert decode_param(encode_param({k: "x"})) == {k: "x"}

    def test_legacy_repr_params_still_decode(self):
        # states persisted before the canonical encoder used repr()
        legacy = ToolState(params=(("a", "(1, 2)"), ("b", "'fast'"), ("c", "3")))
        assert legacy.to_config() == {"a": (1, 2), "b": "fast", "c": 3}

    def test_executor_receives_decoded_values(self, tmp_path):
        """End to end: a tuple/float param reaches the module fn with its
        original type (the old repr path degraded it silently)."""
        seen = {}

        def probe(x, dims=(), scale=1.0):
            seen["dims"], seen["scale"] = dims, scale
            return x

        ex = WorkflowExecutor(store=IntermediateStore(tmp_path / "s"), policy=TSAR(),
                              device="cpu")
        ex.register(ModuleSpec("probe", probe))
        ex.run("ds", torch.arange(4.0), [("probe", {"dims": (0, 1), "scale": 0.5})])
        assert seen["dims"] == (0, 1) and isinstance(seen["dims"], tuple)
        assert seen["scale"] == 0.5 and isinstance(seen["scale"], float)

    def test_digest_distinguishes_types(self):
        assert (
            ToolState.from_config({"x": (1, 2)}).digest
            != ToolState.from_config({"x": [1, 2]}).digest
        )
        assert (
            ToolState.from_config({"x": "1"}).digest
            != ToolState.from_config({"x": 1}).digest
        )


# -- ModuleRegistry -----------------------------------------------------------
class TestModuleRegistry:
    def test_decorator_and_defaults(self):
        reg = ModuleRegistry()

        @reg.module("inc", by=2)
        def inc(x, by=1):
            return x + by

        @reg.module()
        def double(x):
            return x * 2

        assert set(reg) == {"inc", "double"}
        assert reg["inc"].default_params == {"by": 2}
        assert inc(1) == 2  # decorated fn stays directly callable
        # defaults merge into the tool state (engine-identical refs)
        assert reg.ref("inc").state.to_config() == {"by": 2}

    def test_unknown_module_error(self):
        reg = ModuleRegistry()
        with pytest.raises(UnknownModuleError, match="unknown module 'nope'"):
            reg["nope"]

    def test_tool_state_validation(self):
        reg = ModuleRegistry()
        reg.register_fn("inc", lambda x, by=1: x + by)
        reg.validate_state("inc", {"by": 3})
        with pytest.raises(ToolStateError, match="does not accept"):
            reg.validate_state("inc", {"step": 3})
        # **kwargs modules accept anything
        reg.register_fn("anykw", lambda x, **kw: x)
        reg.validate_state("anykw", {"whatever": 1})

    def test_tool_state_validation_positional_only_data_arg(self):
        reg = ModuleRegistry()

        def analyze(x, /, q=50, *, mode="fast"):
            return x

        reg.register_fn("analyze", analyze)
        reg.validate_state("analyze", {"q": 10, "mode": "slow"})  # must not raise
        with pytest.raises(ToolStateError, match="does not accept"):
            reg.validate_state("analyze", {"x": 1})  # the data arg is not a param

    def test_mapping_protocol_guards(self):
        reg = ModuleRegistry()
        spec = ModuleSpec("m", lambda x: x)
        with pytest.raises(ValueError, match="does not match"):
            reg["other"] = spec
        reg["m"] = spec
        del reg["m"]
        assert len(reg) == 0

    def test_shared_registry_executor_and_service(self, tmp_path):
        """The divergence fix: a module registered through the service is
        visible to a standalone executor sharing the registry (and vice
        versa)."""
        store = IntermediateStore(tmp_path / "s")
        reg = ModuleRegistry()
        policy = TSAR(with_state=True)
        ex = WorkflowExecutor(store=store, policy=policy, registry=reg, device="cpu")
        svc = WorkflowService(store=store, policy=policy, registry=reg, device="cpu")
        try:
            svc.register_fn("double", lambda x: x * 2)  # via the service...
            ex.register_fn("inc", lambda x, by=1: x + by, by=1)  # via the executor
            # ...both visible on either engine
            r = ex.run("ds", torch.arange(4.0), ["double", "inc"], "w1")
            np.testing.assert_allclose(np.asarray(r.output), np.arange(4.0) * 2 + 1)
            r2 = svc.run_steps("ds", torch.arange(4.0), ["double", "inc"], "w2")
            assert r2.n_skipped == 2  # and they share the stored artifacts
        finally:
            svc.close()

    def test_plain_dict_adopted_by_reference(self, tmp_path):
        legacy: dict = {}
        ex = WorkflowExecutor(
            store=IntermediateStore(tmp_path / "s"), policy=TSAR(), registry=legacy,
            device="cpu",
        )
        legacy["double"] = ModuleSpec("double", lambda x: x * 2)  # old-style mutation
        r = ex.run("ds", torch.arange(3.0), ["double"])
        np.testing.assert_allclose(np.asarray(r.output), np.arange(3.0) * 2)


# -- WorkflowSpec -------------------------------------------------------------
def fanout_spec() -> WorkflowSpec:
    spec = WorkflowSpec("survey", workflow_id="report")
    spec.add("a", "double")
    spec.add("b", "inc", {"by": (1, 2)}, after="a")
    spec.add("c", "inc", {"by": (3, 4)}, after="a")
    spec.add("m", "merge", after=("b", "c"))
    return spec


class TestWorkflowSpec:
    def test_chain_json_roundtrip_preserves_digest(self):
        spec = WorkflowSpec.from_steps(
            "ds", ["double", ("inc", {"by": 3, "mode": "fast"})], "w"
        )
        clone = WorkflowSpec.from_json(spec.to_json(indent=2))
        assert clone.digest == spec.digest
        assert [n.node_id for n in clone.nodes] == [n.node_id for n in spec.nodes]
        assert clone.node(clone.nodes[1].node_id).config() == {
            "by": 3,
            "mode": "fast",
        }

    def test_dag_json_roundtrip_preserves_digest_and_fanin_order(self):
        spec = fanout_spec()
        clone = WorkflowSpec.from_json(spec.to_json())
        assert clone.digest == spec.digest
        assert clone.node("m").after == ("b", "c")  # fan-in order is semantic
        # and a doubly-round-tripped copy still agrees
        assert WorkflowSpec.from_json(clone.to_json()).digest == spec.digest

    def test_digest_independent_of_declaration_order(self):
        a = WorkflowSpec("ds")
        a.add("root", "double")
        a.add("x", "inc", {"by": 1}, after="root")
        a.add("y", "inc", {"by": 2}, after="root")
        b = WorkflowSpec("ds")
        b.add("root", "double")
        b.add("y", "inc", {"by": 2}, after="root")  # branches swapped
        b.add("x", "inc", {"by": 1}, after="root")
        assert a.digest == b.digest
        # but renaming a node or changing params changes it
        c = WorkflowSpec("ds")
        c.add("root", "double")
        c.add("x", "inc", {"by": 7}, after="root")
        c.add("y", "inc", {"by": 2}, after="root")
        assert a.digest != c.digest

    def test_cyclic_spec_rejected(self):
        doc = {
            "kind": "repro.workflow_spec",
            "version": 1,
            "dataset_id": "ds",
            "nodes": [
                {"id": "a", "module": "m1", "after": ["b"]},
                {"id": "b", "module": "m2", "after": ["a"]},
            ],
        }
        spec = WorkflowSpec.from_dict(doc)
        with pytest.raises(SpecError, match="cycle"):
            spec.validate()

    def test_structural_errors(self):
        with pytest.raises(SpecError, match="dataset_id"):
            WorkflowSpec("")
        spec = WorkflowSpec("ds")
        with pytest.raises(SpecError, match="at least one node"):
            spec.validate()
        spec.add("a", "m1")
        with pytest.raises(SpecError, match="duplicate node id"):
            spec.add("a", "m1")
        spec.add("b", "m2", after="ghost")
        with pytest.raises(SpecError, match="unknown parent 'ghost'"):
            spec.validate()

    def test_unknown_module_rejected_with_registry(self):
        reg = ModuleRegistry()
        reg.register_fn("double", lambda x: x * 2)
        spec = WorkflowSpec.from_steps("ds", ["double", "mystery"])
        with pytest.raises(SpecError, match="unknown module 'mystery'"):
            spec.validate(reg)

    def test_bad_tool_state_rejected_with_registry(self):
        reg = ModuleRegistry()
        reg.register_fn("inc", lambda x, by=1: x + by)
        spec = WorkflowSpec.from_steps("ds", [("inc", {"step": 2})])
        with pytest.raises(ToolStateError, match="does not accept"):
            spec.validate(reg)

    def test_is_linear(self):
        assert WorkflowSpec.from_steps("ds", ["a", "b", "c"]).is_linear
        assert not fanout_spec().is_linear

    def test_hand_written_doc_params_normalize(self):
        # plain JSON values pass through; string values are *encodings*
        # (a literal string is its JSON-quoted form — docs/api.md)
        doc = {
            "kind": "repro.workflow_spec",
            "version": 1,
            "dataset_id": "d",
            "nodes": [
                {
                    "id": "a",
                    "module": "m",
                    "params": {"bins": 10, "mode": '"fast"', "on": True},
                    "after": [],
                }
            ],
        }
        spec = WorkflowSpec.from_dict(doc)
        assert spec.node("a").config() == {"bins": 10, "mode": "fast", "on": True}
        # and it digests identically to the programmatic equivalent
        prog = WorkflowSpec("d")
        prog.add("a", "m", {"bins": 10, "mode": "fast", "on": True})
        assert spec.digest == prog.digest

    def test_from_json_rejects_garbage(self):
        with pytest.raises(SpecError, match="invalid workflow spec JSON"):
            WorkflowSpec.from_json("{nope")
        with pytest.raises(SpecError, match="must be an object"):
            WorkflowSpec.from_json("[1, 2]")
        with pytest.raises(SpecError, match="kind"):
            WorkflowSpec.from_json(json.dumps({"kind": "other", "dataset_id": "d"}))
        with pytest.raises(SpecError, match="missing 'dataset_id'"):
            WorkflowSpec.from_json(json.dumps({"kind": "repro.workflow_spec"}))
        with pytest.raises(SpecError, match="missing field"):
            WorkflowSpec.from_json(
                json.dumps(
                    {
                        "kind": "repro.workflow_spec",
                        "dataset_id": "d",
                        "nodes": [{"id": "a"}],
                    }
                )
            )

    def test_spec_prefix_keys_match_engine_keys(self, tmp_path):
        """The document's resolved PrefixKeys are exactly the store keys a
        sequential run produces — the cross-process contract."""
        reg = ModuleRegistry()
        reg.register_fn("double", lambda x: x * 2)
        reg.register_fn("inc", lambda x, by=1: x + by, by=1)
        spec = WorkflowSpec.from_steps("ds", ["double", ("inc", {"by": 3})])
        ex = WorkflowExecutor(
            store=IntermediateStore(tmp_path / "s"),
            policy=TSAR(with_state=True),
            registry=reg,
            device="cpu",
        )
        ex.run_workflow(spec.to_workflow(reg), torch.arange(4.0))
        assert set(spec.prefix_keys(reg)) == set(ex.store.records)

    def test_legacy_toolstate_workflow_roundtrip_preserves_digest(self):
        """A spec lifted from a legacy repr-encoded ToolState normalizes at
        construction, so serialization cannot change its digest."""
        from repro_torch.core.workflow import ModuleRef, Workflow

        legacy = ToolState(params=(("q", "(1, 2)"),))  # pre-canonical encoding
        wf = Workflow("ds", (ModuleRef("m", legacy),), "w")
        spec = WorkflowSpec.from_workflow(wf)
        clone = WorkflowSpec.from_json(spec.to_json())
        assert clone.digest == spec.digest
        assert clone.node(clone.nodes[0].node_id).config() == {"q": (1, 2)}

    def test_roundtrip_through_workflow_and_dag(self):
        reg = ModuleRegistry()
        reg.register_fn("double", lambda x: x * 2)
        reg.register_fn("inc", lambda x, by=1: x + by, by=1)
        spec = WorkflowSpec.from_steps("ds", ["double", ("inc", {"by": 3})], "w")
        wf = spec.to_workflow(reg)
        again = WorkflowSpec.from_workflow(wf)
        assert again.to_workflow().prefix(2).key(True) == wf.prefix(2).key(True)
        dag = spec.to_dag(reg)
        assert WorkflowSpec.from_dag(dag).digest == spec.digest


GALAXY_DOC = {
    "a_galaxy_workflow": "true",
    "name": "rnaseq-qc",
    "steps": {
        "0": {
            "id": 0,
            "type": "data_input",
            "tool_id": None,
            "label": "reads",
            "input_connections": {},
        },
        "1": {
            "id": 1,
            "type": "tool",
            "tool_id": "toolshed.g2.bx.psu.edu/repos/devteam/fastqc/fastqc/0.73",
            "tool_state": '{"limits": null, "__page__": 0, "kmers": 7}',
            "input_connections": {"input_file": {"id": 0, "output_name": "output"}},
        },
        "2": {
            "id": 2,
            "type": "tool",
            "tool_id": "toolshed.g2.bx.psu.edu/repos/pjbriggs/trimmomatic/trimmomatic/0.38",
            "label": "trim",
            "tool_state": '{"window": 4}',
            "input_connections": {"readtype|fastq_in": {"id": 1, "output_name": "html"}},
        },
        "3": {
            "id": 3,
            "type": "tool",
            "tool_id": "multiqc",
            "tool_state": "{}",
            "input_connections": {
                "results": [
                    {"id": 1, "output_name": "text"},
                    {"id": 2, "output_name": "log"},
                ]
            },
        },
    },
}


class TestGalaxyImport:
    def test_import_structure(self):
        spec = WorkflowSpec.from_galaxy(GALAXY_DOC)
        assert spec.dataset_id == "reads"
        assert spec.workflow_id == "rnaseq-qc"
        assert len(spec) == 3  # data_input step is the dataset, not a node
        fastqc = spec.node("1")
        assert fastqc.module_id == "fastqc"  # toolshed id shortened
        assert fastqc.after == ()  # parent was the data input
        assert fastqc.config() == {"limits": None, "kmers": 7}  # __page__ dropped
        assert spec.node("trim").after == ("1",)
        assert spec.node("3").after == ("1", "trim")  # label-renamed parent

    def test_import_roundtrips_as_spec_json(self):
        spec = WorkflowSpec.from_galaxy(json.dumps(GALAXY_DOC))
        clone = WorkflowSpec.from_json(spec.to_json())
        assert clone.digest == spec.digest

    def test_import_rejects_stepless_doc(self):
        with pytest.raises(SpecError, match="no steps"):
            WorkflowSpec.from_galaxy({"name": "empty", "steps": {}})


# -- Client facade ------------------------------------------------------------
def make_client(tmp_path, policy=None, **kw):
    client = Client(
        store=IntermediateStore(tmp_path / "store"),
        policy=policy or TSAR(with_state=True),
        device="cpu",
        **kw,
    )
    calls = {"double": 0, "inc": 0, "merge": 0}

    @client.module("double")
    def double(x):
        calls["double"] += 1
        return x * 2

    @client.module("inc", by=1)
    def inc(x, by=1):
        calls["inc"] += 1
        return x + by

    @client.module("merge")
    def merge(xs):
        calls["merge"] += 1
        return sum(xs[1:], xs[0])

    return client, calls


class TestClient:
    def test_one_spec_every_engine_run_then_submit(self, tmp_path):
        """Acceptance: a prefix stored via Client.run() (sequential path) is
        reused by Client.submit() of an equivalent DAG spec, with identical
        PrefixKey store keys."""
        client, calls = make_client(tmp_path)
        try:
            spec = WorkflowSpec.from_steps("ds", ["double", ("inc", {"by": 3})], "w1")
            data = torch.arange(6.0)
            r1 = client.run(spec, data)  # linear -> sequential executor
            assert r1.n_skipped == 0 and calls["double"] == 1
            keys_after_run = set(client.store.records)
            assert keys_after_run == set(spec.prefix_keys(client.registry))

            # an equivalent spec, freshly parsed from JSON, submitted as a DAG
            clone = WorkflowSpec.from_json(spec.to_json())
            r2 = client.submit(clone, data).result(timeout=60)
            assert calls["double"] == 1, "stored prefix must be reused, not recomputed"
            assert r2.n_skipped == 2
            assert set(client.store.records) == keys_after_run  # same identities
            np.testing.assert_array_equal(np.asarray(r1.output), np.asarray(r2.output))
        finally:
            client.close()

    def test_one_spec_every_engine_submit_then_run(self, tmp_path):
        """...and vice versa: artifacts stored by the scheduler are reused by
        the sequential path."""
        client, calls = make_client(tmp_path)
        try:
            spec = WorkflowSpec.from_steps("ds", ["double", ("inc", {"by": 3})], "w1")
            data = torch.arange(6.0)
            client.submit(spec, data).result(timeout=60)
            n_double = calls["double"]
            r2 = client.run(WorkflowSpec.from_json(spec.to_json()), data)
            assert calls["double"] == n_double  # sequential path loaded, not re-ran
            assert r2.n_skipped == 2
        finally:
            client.close()

    def test_fan_in_spec_runs_through_scheduler(self, tmp_path):
        client, calls = make_client(tmp_path)
        try:
            spec = client.spec("ds", "report")
            spec.add("a", "double")
            spec.add("b", "inc", {"by": 3}, after="a")
            spec.add("c", "inc", {"by": 5}, after="a")
            spec.add("m", "merge", after=("b", "c"))
            r = client.run(spec, torch.arange(4.0))
            expect = (np.arange(4.0) * 2 + 3) + (np.arange(4.0) * 2 + 5)
            np.testing.assert_allclose(np.asarray(r.output), expect)
            assert calls["double"] == 1  # shared stem computed once
        finally:
            client.close()

    def test_deserialized_spec_reuses_stored_prefix(self, tmp_path):
        """Acceptance: a stored prefix from a deserialized spec is reused by a
        freshly parsed copy (cross-process portability, same-store proxy)."""
        client, calls = make_client(tmp_path)
        try:
            text = WorkflowSpec.from_steps(
                "ds", ["double", ("inc", {"by": 2.5})], "w"
            ).to_json()
            first = WorkflowSpec.from_json(text)
            client.run(first, torch.arange(4.0))
            again = WorkflowSpec.from_json(text)  # independent parse
            r = client.run(again, torch.arange(4.0))
            assert r.n_skipped == 2
            assert calls["double"] == 1 and calls["inc"] == 1
        finally:
            client.close()

    def test_prebuilt_store_excludes_store_options(self, tmp_path):
        store = IntermediateStore(tmp_path / "s")
        with pytest.raises(ValueError, match="pre-built store"):
            Client(store=store, eviction="lru")
        with pytest.raises(ValueError, match="pre-built store"):
            Client(store=store, codec="zlib")

    def test_validation_errors_surface(self, tmp_path):
        client, _ = make_client(tmp_path)
        try:
            with pytest.raises(SpecError, match="unknown module"):
                client.run(WorkflowSpec.from_steps("ds", ["mystery"]), torch.arange(2.0))
            with pytest.raises(ToolStateError):
                client.run(
                    WorkflowSpec.from_steps("ds", [("inc", {"nope": 1})]),
                    torch.arange(2.0),
                )
        finally:
            client.close()

    def test_stats_span_both_engines(self, tmp_path):
        client, _ = make_client(tmp_path)
        try:
            spec = WorkflowSpec.from_steps("ds", ["double", "inc"], "w")
            client.run(spec, torch.arange(4.0))  # sequential
            client.submit(spec, torch.arange(4.0)).result(timeout=60)  # scheduler
            client.drain()
            st = client.stats()
            assert st.runs == 2 and st.failures == 0
            assert st.units_total == 4 and st.units_skipped >= 2
            assert "runs=2" in st.row()
        finally:
            client.close()

    def test_recommend_after_corpus_replay(self, tmp_path):
        """Acceptance: recommend() returns >=1 reusable-prefix suggestion
        after replaying galaxy_ch4_corpus (Ch. 4's recommendation pipeline)."""
        client, _ = make_client(tmp_path, policy=RISP())
        try:
            corpus = galaxy_ch4_corpus()
            assert client.replay(corpus) == len(corpus)
            # compose a partial workflow extending a history-supported prefix
            partial = max(
                (p for p in client.policy.miner.iter_prefixes()
                 if client.policy.miner.support(p) >= 2),
                key=lambda p: p.depth,
            )
            report = client.recommend(partial.dataset_id, partial.modules)
            assert len(report.reusable_prefixes) >= 1
            best = report.best_reuse
            assert best.kind == "reusable_prefix"
            assert best.depth <= partial.depth
            assert best.confidence > 0
            assert "reuse depth" in best.describe()

            # next-module suggestions extend a *shorter* partial chain
            if partial.depth > 1:
                report2 = client.recommend(
                    partial.dataset_id, partial.modules[:-1]
                )
                suggested = [s.module_id for s in report2.next_modules]
                assert partial.modules[-1].module_id in suggested
                confs = [s.confidence for s in report2.next_modules]
                assert confs == sorted(confs, reverse=True)
        finally:
            client.close()

    def test_recommend_empty_partial_suggests_first_module(self, tmp_path):
        client, _ = make_client(tmp_path, policy=RISP())
        try:
            from collections import Counter

            corpus = galaxy_ch4_corpus()
            client.replay(corpus)
            ds = Counter(wf.dataset_id for wf in corpus).most_common(1)[0][0]
            report = client.recommend(ds)
            assert report.depth == 0
            assert report.next_modules, "popular dataset must have first-module rules"
        finally:
            client.close()

    def test_replay_does_not_block_first_real_store(self, tmp_path):
        """Replayed (never-executed) history must not leave phantom 'stored'
        claims that make the first real run skip persisting its artifacts."""
        client, calls = make_client(tmp_path, policy=RISP())
        try:
            spec = WorkflowSpec.from_steps("ds", ["double", "inc"], "w")
            # two replays make D=>double>inc the top rule; PT would "store" it
            client.observe(spec)
            client.observe(spec)
            live = {
                k for k in client.policy.stored if client.store.has(k)
            }
            assert live == set()  # no phantom claims backed by nothing
            r1 = client.run(spec, torch.arange(4.0))
            assert r1.stored_keys, "first real run must persist the mined prefix"
            r2 = client.run(spec, torch.arange(4.0))
            assert r2.n_skipped == 2 and calls["double"] == 1
        finally:
            client.close()

    def test_recommend_flags_live_artifacts(self, tmp_path):
        client, _ = make_client(tmp_path)  # TSAR stores everything
        try:
            spec = WorkflowSpec.from_steps("ds", ["double", "inc"], "w")
            client.run(spec, torch.arange(4.0))
            report = client.recommend(spec)
            assert report.best_reuse is not None
            assert report.best_reuse.stored  # artifact is live in the store
            assert report.best_reuse.depth == 2
        finally:
            client.close()

    def test_recommend_dedupes_next_module_states(self, tmp_path):
        """A frequently re-parameterized module yields ONE next-module
        suggestion (its best state), not top_k copies of itself."""
        client, _ = make_client(tmp_path, policy=RISP(with_state=True))
        try:
            partial = WorkflowSpec.from_steps("ds", ["double"])
            for by in (1, 2, 3, 1):
                client.observe(
                    WorkflowSpec.from_steps("ds", ["double", ("inc", {"by": by})])
                )
            report = client.recommend(partial)
            ids = [s.module_id for s in report.next_modules]
            assert ids == ["inc"]
            assert report.best_next.support == 2  # the repeated by=1 state wins
        finally:
            client.close()

    def test_legacy_front_doors_still_work_alongside(self, tmp_path):
        """Migration contract: the old imperative entry points keep working
        against the same store/policy/registry the Client wired."""
        client, calls = make_client(tmp_path)
        try:
            ex = WorkflowExecutor(
                store=client.store, policy=client.policy, registry=client.registry,
                device="cpu",
            )
            r = ex.run("ds", torch.arange(4.0), ["double", ("inc", {"by": 3})], "w1")
            assert calls["double"] == 1
            # the Client sees the legacy run's artifacts
            r2 = client.run(
                WorkflowSpec.from_steps("ds", ["double", ("inc", {"by": 3})]),
                torch.arange(4.0),
            )
            assert r2.n_skipped == 2 and calls["double"] == 1
        finally:
            client.close()


# -- against the reference package --------------------------------------------
def _registries():
    """The same module universe in both packages (defaults resolve into keys)."""
    from repro.api import ModuleRegistry as JaxRegistry

    regs = []
    for reg in (ModuleRegistry(), JaxRegistry()):
        reg.register_fn("double", lambda x: x * 2)
        reg.register_fn("inc", lambda x, by=1, mode="slow": x + 1, by=1)
        reg.register_fn("merge", lambda xs: xs[0])
        regs.append(reg)
    return regs


def _spec_texts():
    """JSON documents written by the reference package."""
    from repro.api import WorkflowSpec as JaxSpec

    chain = JaxSpec.from_steps(
        "ds", ["double", ("inc", {"by": (1, 2.5), "mode": "fast"})], "w")
    dag = JaxSpec("survey", workflow_id="report")
    dag.add("a", "double")
    dag.add("b", "inc", {"by": (1, 2)}, after="a")
    dag.add("c", "inc", {"by": {"k": [3, 4]}}, after="a")
    dag.add("m", "merge", after=("b", "c"))
    bare = JaxSpec.from_steps("sensor-A", ["double", "inc", ("inc", {"by": 1e-300})])
    return {
        "chain": chain.to_json(),
        "chain_indented": chain.to_json(indent=2),
        "dag": dag.to_json(),
        "namespaced": bare.with_namespace("tenant:a").to_json(),
        "bare": bare.to_json(),
    }


@pytest.mark.parametrize("name", ["chain", "chain_indented", "dag", "namespaced", "bare"])
def test_spec_json_digest_and_keys_equal_reference(name):
    from repro.api import WorkflowSpec as JaxSpec

    text = _spec_texts()[name]
    ours, ref = WorkflowSpec.from_json(text), JaxSpec.from_json(text)
    assert ours.digest == ref.digest
    assert ours.to_json() == ref.to_json()
    assert ours.to_json(indent=2) == ref.to_json(indent=2)
    assert ours.canonical() == ref.canonical()
    reg, jreg = _registries()
    assert ours.prefix_keys(reg) == ref.prefix_keys(jreg)
    assert ours.prefix_keys(reg, with_state=False) == ref.prefix_keys(jreg, with_state=False)
    assert ours.topo_order() == ref.topo_order() and ours.is_linear == ref.is_linear
    # and the port's own document reads back in the reference unchanged
    assert JaxSpec.from_json(ours.to_json()).digest == ref.digest


def test_galaxy_import_equal_reference():
    from repro.api import WorkflowSpec as JaxSpec

    text = json.dumps(GALAXY_DOC)
    ours, ref = WorkflowSpec.from_galaxy(text), JaxSpec.from_galaxy(text)
    assert ours.digest == ref.digest
    assert ours.to_json() == ref.to_json()
    assert ours.prefix_keys() == ref.prefix_keys()
    assert WorkflowSpec.from_galaxy(GALAXY_DOC).to_json() == ref.to_json()


def test_run_stores_the_reference_keys(tmp_path):
    """A spec the reference wrote, run by the port's Client, stores exactly
    the keys the reference resolves for it."""
    from repro.api import WorkflowSpec as JaxSpec

    text = _spec_texts()["chain"]
    reg, jreg = _registries()
    client = Client(store=IntermediateStore(tmp_path / "s"), policy=TSAR(with_state=True),
                    registry=reg, device="cpu")
    try:
        spec = WorkflowSpec.from_json(text)
        client.run(spec, torch.arange(4.0))
        assert set(client.store.records) == set(JaxSpec.from_json(text).prefix_keys(jreg))
    finally:
        client.close()


def _suggestions(report, with_state):
    return [
        (s.kind, s.prefix.key(with_state), s.support, s.dataset_support, s.stored,
         s.module_id, s.note, s.confidence, s.describe())
        for s in report
    ]


def _report(r, with_state=False):
    return (r.dataset_id, r.depth, _suggestions(r.reusable_prefixes, with_state),
            _suggestions(r.next_modules, with_state),
            _suggestions(r.near_misses, with_state))


def test_recommend_equals_reference_after_ch4_replay(tmp_path):
    """Both packages replay the first 450 pipelines of the Ch. 4 corpus; the
    other 58, cut at three depths each, are held out: every report is equal,
    every suggestion in its order, confidence and all."""
    from repro.api import Client as JaxClient
    from repro.core import galaxy_ch4_corpus as jax_ch4

    corpus, jcorpus = galaxy_ch4_corpus(), jax_ch4()
    ours = Client(str(tmp_path / "port"), policy="PT", with_state=False, device="cpu")
    ref = JaxClient(str(tmp_path / "ref"), policy="PT", with_state=False)
    try:
        assert ours.replay(corpus[:450]) == ref.replay(jcorpus[:450]) == 450
        n, n_reuse, n_next = 0, 0, 0
        for wf, jwf in zip(corpus[450:], jcorpus[450:]):
            for depth in sorted({1, max(1, len(wf) // 2), len(wf) - 1}):
                a = ours.recommend(wf.dataset_id, wf.modules[:depth])
                b = ref.recommend(jwf.dataset_id, jwf.modules[:depth])
                assert _report(a) == _report(b), (wf.workflow_id, depth)
                n += 1
                n_reuse += bool(a.reusable_prefixes)
                n_next += bool(a.next_modules)
        assert n >= 150 and n_reuse >= 50 and n_next >= 50, (n, n_reuse, n_next)
    finally:
        ours.close()
        ref.close()


def test_near_misses_equal_reference(tmp_path):
    """The catalog side of ``recommend``: the same stored chains give the
    same near misses, notes and order in both packages."""
    from repro.api import Client as JaxClient

    def build(cls, root, **kw):
        c = cls(str(root), namespace="alice", **kw)
        c.register_fn("load", lambda d, scale=1: [x * scale for x in d], scale=1)
        c.register_fn("norm", lambda d, mode="z": d, mode="z")
        for scale, mode in ((2, "z"), (3, "z"), (3, "minmax"), (5, "z")):
            for _ in range(2):
                spec = c.spec("ds1")
                spec.chain([("load", {"scale": scale}), ("norm", {"mode": mode})])
                c.run(spec, [1, 2, 3])
        return c

    ours, ref = build(Client, tmp_path / "port", device="cpu"), build(JaxClient, tmp_path / "ref")
    try:
        for scale, mode in ((7, "z"), (2, "z"), (3, "q"), (5, "minmax")):
            a, b = ours.spec("ds1"), ref.spec("ds1")
            for s in (a, b):
                s.chain([("load", {"scale": scale}), ("norm", {"mode": mode})])
            ra, rb = ours.recommend(a), ref.recommend(b)
            assert _report(ra, True) == _report(rb, True)
        probe = ours.spec("ds1")
        probe.chain([("load", {"scale": 7}), ("norm", {"mode": "z"})])
        assert len(ours.recommend(probe).near_misses) == 3
    finally:
        ours.close()
        ref.close()


# -- serving on the client's fabric -------------------------------------------
def test_serve_engine_publishes_snapshots_to_the_catalog(tmp_path):
    """``Client.serve_engine(..., device="cpu")``: the engine's KV snapshots
    are artifacts on the client's store and records in its catalog (the
    reference's own path; ``FabricSnapshotStore(catalog=)`` is the client's
    ``Catalog``), and a second engine on the same client restores them."""
    from repro_torch.configs import get_config
    from repro_torch.models.layers import init_params
    from repro_torch.models.transformer import lm_specs

    cfg = dataclasses.replace(get_config("tinyllama-1.1b", smoke=True), dtype=torch.float32)
    params = init_params(torch.Generator().manual_seed(0), lm_specs(cfg), cfg.dtype, "cpu")
    rng = np.random.default_rng(7)
    prompt = rng.integers(0, cfg.vocab, size=24).tolist()
    with Client(str(tmp_path / "store"), policy="PT", namespace="tenant:a",
                device="cpu") as client:
        first = client.serve_engine(cfg, params, policy=TSAR(), max_len=64, chunk=8,
                                    device="cpu")
        assert first.snapshots.catalog is client.catalog
        toks, st = first.generate(prompt, 4)
        assert st.stored_prefixes >= 1
        keys = set(first.snapshots._records)
        hits = client.find(dataset="prompts", any_position=True, limit=100)
        assert {h.key for h in hits} == keys
        assert all(h.namespace == "tenant:a" and h.dataset == "prompts" for h in hits)
        second = client.serve_engine(cfg, params, policy=TSAR(), max_len=64, chunk=8,
                                     device="cpu")
        toks2, st2 = second.generate(prompt, 4)
        assert toks2 == toks and st2.chunks_skipped == st2.n_chunks == 3
