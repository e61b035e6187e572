"""The port's HTTP front door (``repro_torch.gateway``) on the CPU.

Modelled on ``tests/test_gateway.py``, all 34 of its cases (namespaces, the
HTTP surface, error mapping, cross-tenant reuse, admission, the service's
admission, shutdown with the CLI's SIGTERM, and the artifacts endpoint),
each over a real ``GatewayServer`` on a loopback port.  The port's engines
load reused prefixes where the caller says, so every client, service and
CLI here runs with ``device="cpu"`` (``--device cpu``).

Beyond them, held against the reference package: the same ``WorkflowSpec``
JSON POSTed to both packages' gateways gives equal run documents (run ids,
trace ids, seconds and the tensor output's placeholder excepted), equal
stored keys and equal ``/v1/recommend`` documents; and each package's
gateway runs over the other package's ``StoreServer``, tenants reusing each
other's shared prefixes through it.
"""
from __future__ import annotations

import json
import signal
import subprocess
import sys
import tempfile
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from repro_torch.api import Client, SpecError, WorkflowSpec
from repro_torch.api.spec import check_namespace, namespaced_dataset
from repro_torch.core import MemoryBackend
from repro_torch.core.risp import make_policy
from repro_torch.core.store import IntermediateStore
from repro_torch.gateway import (
    GatewayServer,
    NamespaceDenied,
    TenancyPolicy,
    TokenAuthenticator,
    private_namespace,
)
from repro_torch.gateway.serve import register_demo_modules
from repro_torch.net import StoreServer
from repro_torch.sched import (
    AdmissionRejected,
    ServiceClosed,
    TenantLedger,
    WorkflowService,
)

TOKENS = {"tok-a": "alice", "tok-b": "bob"}
ROOT = Path(__file__).resolve().parent.parent


# -- plain-HTTP helpers -------------------------------------------------------

def _request(base, method, path, token=None, body=None, timeout=30):
    """Returns (status, parsed-JSON body, headers) without raising on 4xx."""
    req = urllib.request.Request(base + path, method=method)
    if token is not None:
        req.add_header("Authorization", f"Bearer {token}")
    data = None
    if body is not None:
        data = body if isinstance(body, bytes) else json.dumps(body).encode()
        req.add_header("Content-Type", "application/json")
    try:
        with urllib.request.urlopen(req, data=data, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read()), dict(resp.headers)
    except urllib.error.HTTPError as e:
        raw = e.read()
        return e.code, (json.loads(raw) if raw else {}), dict(e.headers)


def _register_slow(registry):
    @registry.module("slow", seconds=0.4)
    def slow(xs, seconds=0.4):
        time.sleep(seconds)
        return xs

    return slow


def _chain_doc(dataset="nums", steps=("normalize", "scale", "stats")):
    return WorkflowSpec.from_steps(dataset, list(steps)).to_dict()


def _wait_done(base, token, run_id, deadline_s=30.0):
    deadline = time.monotonic() + deadline_s
    while time.monotonic() < deadline:
        st, doc, _ = _request(base, "GET", f"/v1/runs/{run_id}", token)
        assert st == 200, doc
        if doc["status"] in ("done", "failed"):
            return doc
        time.sleep(0.02)
    raise AssertionError(f"run {run_id} never finished")


@pytest.fixture()
def gateway():
    client = Client(max_pending=16, device="cpu")
    register_demo_modules(client.registry)
    _register_slow(client.registry)
    gw = GatewayServer(client, TokenAuthenticator(TOKENS))
    gw.start()
    yield gw
    gw.close()
    client.close()


# -- namespace plumbing (api.spec) -------------------------------------------

class TestNamespaces:
    def test_namespace_roundtrips_and_changes_digest(self):
        spec = WorkflowSpec.from_steps("ds", ["a", "b"])
        ns = spec.with_namespace("tenant:alice")
        assert ns.effective_dataset_id == "tenant:alice/ds"
        assert ns.digest != spec.digest
        again = WorkflowSpec.from_json(ns.to_json())
        assert again.namespace == "tenant:alice"
        assert again.digest == ns.digest
        # un-namespaced documents keep their digest and wire format
        assert "namespace" not in spec.to_dict()
        assert WorkflowSpec.from_json(spec.to_json()).digest == spec.digest

    def test_namespace_charset_enforced(self):
        with pytest.raises(SpecError):
            check_namespace("bad/ns")
        with pytest.raises(SpecError):
            WorkflowSpec("ds", namespace="a b")
        assert namespaced_dataset("", "ds") == "ds"
        assert namespaced_dataset("shared", "ds") == "shared/ds"

    def test_prefix_keys_are_namespaced(self):
        spec = WorkflowSpec.from_steps("ds", ["a", "b"]).with_namespace("shared")
        for key in spec.prefix_keys():
            assert key.startswith("shared/ds::")

    def test_tenancy_policy_resolution(self):
        pol = TenancyPolicy(("shared", "commons"))
        assert pol.resolve("alice", None) == private_namespace("alice")
        assert pol.resolve("alice", "shared") == "shared"
        assert pol.resolve("alice", "commons") == "commons"
        assert pol.resolve("alice", "tenant:alice") == "tenant:alice"
        with pytest.raises(NamespaceDenied):
            pol.resolve("bob", "tenant:alice")
        with pytest.raises(NamespaceDenied):
            pol.resolve("bob", "elsewhere")

    def test_client_default_namespace(self):
        with Client(namespace="tenant:carol", device="cpu") as client:
            register_demo_modules(client.registry)
            spec = WorkflowSpec.from_steps("nums", ["normalize", "scale"])
            for _ in range(3):  # enough history for the policy to store
                client.run(spec, [1.0, 2.0])
            keys = list(client.store.records)
            assert keys and all(k.startswith("tenant:carol/nums::") for k in keys)
            # a spec that carries its own namespace wins over the default
            shared = spec.with_namespace("shared")
            for _ in range(3):
                client.run(shared, [1.0, 2.0])
            assert any(k.startswith("shared/nums::") for k in client.store.records)


# -- HTTP surface -------------------------------------------------------------

class TestHttpSurface:
    def test_healthz_unauthenticated(self, gateway):
        st, doc, _ = _request(gateway.url, "GET", "/healthz")
        assert st == 200 and doc["ok"] is True and doc["draining"] is False

    def test_auth_required(self, gateway):
        st, doc, hdrs = _request(gateway.url, "GET", "/v1/stats")
        assert st == 401 and doc["error"] == "unauthorized"
        assert "WWW-Authenticate" in hdrs
        st, doc, _ = _request(gateway.url, "GET", "/v1/stats", token="nope")
        assert st == 401
        st, _, _ = _request(gateway.url, "GET", "/v1/stats", token="tok-a")
        assert st == 200

    def test_submit_async_then_poll(self, gateway):
        st, doc, _ = _request(
            gateway.url, "POST", "/v1/workflows", "tok-a",
            {"spec": _chain_doc(), "data": [1, 2, 3]},
        )
        assert st == 202 and doc["status"] in ("pending", "running", "done")
        assert doc["namespace"] == "tenant:alice"
        final = _wait_done(gateway.url, "tok-a", doc["run_id"])
        assert final["status"] == "done"
        res = final["result"]
        assert res["n_nodes"] == 3
        assert res["output"]["n"] == 3

    def test_submit_wait_inline(self, gateway):
        st, doc, _ = _request(
            gateway.url, "POST", "/v1/workflows", "tok-a",
            {"spec": _chain_doc(), "data": [1, 2, 3], "wait": True},
        )
        assert st == 200 and doc["status"] == "done"

    def test_events_stream_reaches_terminal(self, gateway):
        st, doc, _ = _request(
            gateway.url, "POST", "/v1/workflows", "tok-a",
            {"spec": _chain_doc(), "data": [1, 2, 3]},
        )
        rid = doc["run_id"]
        req = urllib.request.Request(gateway.url + f"/v1/runs/{rid}/events")
        req.add_header("Authorization", "Bearer tok-a")
        with urllib.request.urlopen(req, timeout=30) as resp:
            assert resp.headers.get("Content-Type") == "application/x-ndjson"
            events = [json.loads(line) for line in resp.read().splitlines()]
        names = [e["event"] for e in events]
        assert names[0] == "accepted"
        assert names[-1] in ("finished", "failed")
        assert all(e["run_id"] == rid for e in events)

    def test_runs_are_tenant_scoped(self, gateway):
        _, doc, _ = _request(
            gateway.url, "POST", "/v1/workflows", "tok-a",
            {"spec": _chain_doc(), "data": [1, 2, 3], "wait": True},
        )
        rid = doc["run_id"]
        st, _, _ = _request(gateway.url, "GET", f"/v1/runs/{rid}", "tok-b")
        assert st == 404  # foreign run ids look unknown, not forbidden
        st, _, _ = _request(gateway.url, "GET", f"/v1/runs/{rid}/events", "tok-b")
        assert st == 404
        st, _, _ = _request(gateway.url, "GET", f"/v1/runs/{rid}", "tok-a")
        assert st == 200

    def test_recommend_endpoint(self, gateway):
        for _ in range(3):
            _request(
                gateway.url, "POST", "/v1/workflows", "tok-a",
                {"spec": _chain_doc(), "data": [1, 2, 3],
                 "namespace": "shared", "wait": True},
            )
        st, doc, _ = _request(
            gateway.url, "GET",
            "/v1/recommend?dataset=nums&modules=normalize&namespace=shared",
            "tok-a",
        )
        assert st == 200
        assert doc["dataset_id"] == "shared/nums"
        assert doc["next_modules"], doc
        assert doc["next_modules"][0]["module_id"] == "scale"

    def test_stats_endpoint(self, gateway):
        _request(
            gateway.url, "POST", "/v1/workflows", "tok-a",
            {"spec": _chain_doc(), "data": [1, 2, 3], "wait": True},
        )
        st, doc, _ = _request(gateway.url, "GET", "/v1/stats", "tok-a")
        assert st == 200
        assert doc["fabric"]["runs"] >= 1
        assert doc["tenant"]["alice"]["runs_total"] >= 1
        assert doc["gateway"]["accepted"] >= 1


# -- error mapping: the server must survive every malformed input -------------

class TestErrorMapping:
    def test_malformed_and_invalid_requests(self, gateway):
        base = gateway.url
        cases = []
        # malformed JSON
        cases.append(_request(base, "POST", "/v1/workflows", "tok-a", b"{nope"))
        # body not an object
        cases.append(_request(base, "POST", "/v1/workflows", "tok-a", b"[1,2]"))
        # spec not an object
        cases.append(
            _request(base, "POST", "/v1/workflows", "tok-a", {"spec": 7})
        )
        # unknown module
        bad = {"dataset_id": "d", "nodes": [{"id": "x", "module": "nope"}]}
        cases.append(
            _request(base, "POST", "/v1/workflows", "tok-a", {"spec": bad})
        )
        # cycle
        cyc = {
            "dataset_id": "d",
            "nodes": [
                {"id": "a", "module": "normalize", "after": ["b"]},
                {"id": "b", "module": "normalize", "after": ["a"]},
            ],
        }
        cases.append(
            _request(base, "POST", "/v1/workflows", "tok-a", {"spec": cyc})
        )
        # missing dataset_id
        cases.append(
            _request(base, "POST", "/v1/workflows", "tok-a", {"spec": {"nodes": []}})
        )
        # empty spec
        cases.append(
            _request(base, "POST", "/v1/workflows", "tok-a",
                     {"spec": {"dataset_id": "d", "nodes": []}})
        )
        # unknown run + unknown route
        cases.append(_request(base, "GET", "/v1/runs/r-missing", "tok-a"))
        cases.append(_request(base, "GET", "/v1/nothing", "tok-a"))
        # recommend without dataset
        cases.append(_request(base, "GET", "/v1/recommend", "tok-a"))

        for st, doc, _ in cases:
            assert 400 <= st < 500, (st, doc)
            assert "error" in doc and doc["message"], doc
        statuses = [st for st, _, _ in cases]
        assert statuses.count(422) >= 3  # validation failures are structured
        assert 400 in statuses and 404 in statuses

        # unknown-module message names the module and the known universe
        st, doc, _ = _request(
            base, "POST", "/v1/workflows", "tok-a",
            {"spec": {"dataset_id": "d", "nodes": [{"id": "x", "module": "nope"}]}},
        )
        assert st == 422 and "nope" in doc["message"]

        # ... and after all that abuse the server still works
        st, doc, _ = _request(base, "GET", "/healthz")
        assert st == 200
        st, doc, _ = _request(
            base, "POST", "/v1/workflows", "tok-a",
            {"spec": _chain_doc(), "data": [1, 2, 3], "wait": True},
        )
        assert st == 200 and doc["status"] == "done"

    def test_oversized_body_rejected(self):
        client = Client(device="cpu")
        register_demo_modules(client.registry)
        gw = GatewayServer(
            client, TokenAuthenticator(TOKENS), max_body_bytes=2048
        )
        gw.start()
        try:
            huge = json.dumps({"spec": _chain_doc(), "pad": "x" * 4096}).encode()
            st, doc, _ = _request(gw.url, "POST", "/v1/workflows", "tok-a", huge)
            assert st == 413 and doc["error"] == "too_large"
            st, _, _ = _request(gw.url, "GET", "/healthz")
            assert st == 200
        finally:
            gw.close()
            client.close()


# -- tenancy + reuse end to end ----------------------------------------------

class TestCrossTenantReuse:
    def test_shared_namespace_reuses_private_never_leaks(self, gateway):
        """Tenant B's shared-namespace run reuses tenant A's intermediates
        (compute counters prove it); private artifacts are invisible across
        tenants."""
        base = gateway.url
        body = {"spec": _chain_doc(), "data": [1, 2, 3],
                "namespace": "shared", "wait": True}
        # warm: the miner needs history before the policy stores, and one
        # more run to persist the prefix
        stored_total = 0
        for _ in range(3):
            st, doc, _ = _request(base, "POST", "/v1/workflows", "tok-a", body)
            assert st == 200 and doc["status"] == "done"
            stored_total += len(doc["result"]["stored_keys"])
        assert stored_total >= 1
        # tenant B, same public prefix: zero computes, all skipped
        st, doc, _ = _request(base, "POST", "/v1/workflows", "tok-b", body)
        assert st == 200
        res = doc["result"]
        assert res["n_computed"] == 0 and res["n_skipped"] == res["n_nodes"]

        # the artifacts live under the shared namespace, not any tenant's
        store = gateway.client.store
        shared_keys = [k for k in store.records if k.startswith("shared/")]
        assert shared_keys
        assert not any(k.startswith("tenant:") for k in store.records)

        # private runs do NOT see shared (or each other's) artifacts
        priv = {"spec": _chain_doc(), "data": [1, 2, 3], "wait": True}
        st, doc, _ = _request(base, "POST", "/v1/workflows", "tok-b", priv)
        assert st == 200
        assert doc["namespace"] == "tenant:bob"
        assert doc["result"]["n_computed"] == doc["result"]["n_nodes"]

    def test_private_namespace_keys_disjoint(self, gateway):
        base = gateway.url
        body = {"spec": _chain_doc(), "data": [1, 2, 3], "wait": True}
        for _ in range(3):  # far enough to store under alice's namespace
            _request(base, "POST", "/v1/workflows", "tok-a", body)
        store = gateway.client.store
        alice_keys = [k for k in store.records if k.startswith("tenant:alice/")]
        assert alice_keys
        # bob's identical private pipeline starts cold
        st, doc, _ = _request(base, "POST", "/v1/workflows", "tok-b", body)
        assert doc["result"]["n_computed"] == doc["result"]["n_nodes"]
        assert not any(k.startswith("tenant:bob/") and k in alice_keys
                       for k in store.records)

    def test_foreign_private_namespace_403(self, gateway):
        st, doc, _ = _request(
            gateway.url, "POST", "/v1/workflows", "tok-b",
            {"spec": _chain_doc(), "data": [1], "namespace": "tenant:alice"},
        )
        assert st == 403 and doc["error"] == "namespace_denied"


# -- admission control --------------------------------------------------------

class TestAdmission:
    def _slow_gateway(self, **kw):
        client = Client(max_workers=1, max_concurrent_runs=1,
                        max_pending=kw.pop("max_pending", 2), device="cpu")
        _register_slow(client.registry)
        gw = GatewayServer(client, TokenAuthenticator(TOKENS), **kw)
        gw.start()
        return gw, client

    def test_saturation_answers_429_and_loses_nothing(self):
        gw, client = self._slow_gateway(max_pending=2)
        try:
            body = {
                "spec": WorkflowSpec.from_steps(
                    "d", [("slow", {"seconds": 0.3})]
                ).to_dict(),
                "data": [1],
            }
            accepted, rejected = [], 0
            for _ in range(6):
                st, doc, hdrs = _request(gw.url, "POST", "/v1/workflows",
                                         "tok-a", body)
                if st == 202:
                    accepted.append(doc["run_id"])
                else:
                    assert st == 429, (st, doc)
                    assert doc["error"] in ("saturated", "quota_exceeded")
                    assert int(hdrs["Retry-After"]) >= 1
                    rejected += 1
            assert rejected >= 1 and accepted
            # zero lost accepted runs: every 202 reaches "done"
            for rid in accepted:
                assert _wait_done(gw.url, "tok-a", rid)["status"] == "done"
            st, doc, _ = _request(gw.url, "GET", "/v1/stats", "tok-a")
            assert doc["fabric"]["rejected_runs"] + doc["tenant"]["alice"][
                "rejected"] >= rejected
        finally:
            gw.close()
            client.close()

    def test_per_tenant_inflight_quota(self):
        gw, client = self._slow_gateway(max_pending=8,
                                        max_inflight_per_tenant=1)
        try:
            body = {
                "spec": WorkflowSpec.from_steps(
                    "d", [("slow", {"seconds": 0.5})]
                ).to_dict(),
                "data": [1],
            }
            st1, doc1, _ = _request(gw.url, "POST", "/v1/workflows", "tok-a", body)
            assert st1 == 202
            st2, doc2, _ = _request(gw.url, "POST", "/v1/workflows", "tok-a", body)
            assert st2 == 429 and doc2["error"] == "quota_exceeded"
            # another tenant is unaffected by alice's quota
            st3, doc3, _ = _request(gw.url, "POST", "/v1/workflows", "tok-b", body)
            assert st3 == 202
            _wait_done(gw.url, "tok-a", doc1["run_id"])
            _wait_done(gw.url, "tok-b", doc3["run_id"])
            # slot released: alice may submit again
            st4, doc4, _ = _request(gw.url, "POST", "/v1/workflows", "tok-a", body)
            assert st4 == 202
            _wait_done(gw.url, "tok-a", doc4["run_id"])
        finally:
            gw.close()
            client.close()

    def test_bytes_quota_billed_and_credited(self):
        ledger = TenantLedger()
        ledger.charge_stored("alice", "k1", 1000)
        ledger.charge_stored("alice", "k2", 500)
        assert ledger.bytes_stored("alice") == 1500
        # re-billing a key to another tenant moves the bytes
        ledger.charge_stored("bob", "k1", 800)
        assert ledger.bytes_stored("alice") == 500
        assert ledger.bytes_stored("bob") == 800
        # eviction credits the billed owner; unknown keys are ignored
        ledger.credit_evicted("k1")
        ledger.credit_evicted("never-seen")
        assert ledger.bytes_stored("bob") == 0
        assert ledger.snapshot("alice")["keys_stored"] == 1

    def test_bytes_quota_rejects_submissions(self, gateway):
        gateway.admission.max_bytes_per_tenant = 1
        gateway.ledger.charge_stored("alice", "some/key", 10)
        try:
            st, doc, _ = _request(
                gateway.url, "POST", "/v1/workflows", "tok-a",
                {"spec": _chain_doc(), "data": [1, 2, 3]},
            )
            assert st == 429 and doc["error"] == "quota_exceeded"
            assert "quota" in doc["message"]
            # eviction frees the quota again
            gateway.ledger.credit_evicted("some/key")
            st, _, _ = _request(
                gateway.url, "POST", "/v1/workflows", "tok-a",
                {"spec": _chain_doc(), "data": [1, 2, 3], "wait": True},
            )
            assert st == 200
        finally:
            gateway.admission.max_bytes_per_tenant = None


# -- service level: bounded pending, no silent queueing ------------------------

class TestServiceAdmission:
    def _service(self, max_pending):
        store = IntermediateStore(tempfile.mkdtemp(prefix="repro-torch-gwtest-"))
        policy = make_policy("PT", with_state=True)
        svc = WorkflowService(
            store, policy, max_workers=1, max_concurrent_runs=1,
            max_pending=max_pending, device="cpu",
        )
        svc.register_fn("slow", lambda xs: (time.sleep(0.3), xs)[1])
        return svc

    def test_saturation_rejects_rather_than_accumulates(self):
        svc = self._service(max_pending=2)
        try:
            dag = svc.dag("d")
            dag.chain(["slow"])
            futs = [svc.submit(dag, [1]), svc.submit(dag, [1])]
            with pytest.raises(AdmissionRejected) as exc:
                svc.submit(dag, [1])
            assert exc.value.pending == 2 and exc.value.max_pending == 2
            assert svc.pending_runs == 2  # nothing accumulated
            assert svc.rejected_runs == 1
            for f in futs:
                f.result(timeout=30)
            # capacity freed: accepted again
            svc.submit(dag, [1]).result(timeout=30)
        finally:
            svc.close()

    def test_unbounded_default_unchanged(self):
        svc = self._service(max_pending=None)
        try:
            dag = svc.dag("d")
            dag.chain(["slow"])
            futs = [svc.submit(dag, [1]) for _ in range(5)]
            for f in futs:
                f.result(timeout=30)
        finally:
            svc.close()

    def test_on_state_callbacks_fire_in_order(self):
        svc = self._service(max_pending=None)
        try:
            dag = svc.dag("d")
            dag.chain(["slow"])
            states: list[str] = []
            svc.submit(dag, [1], on_state=states.append).result(timeout=30)
            assert states == ["started", "finished"]
        finally:
            svc.close()

    def test_submit_after_shutdown_raises_service_closed(self):
        svc = self._service(max_pending=None)
        dag = svc.dag("d")
        dag.chain(["slow"])
        fut = svc.submit(dag, [1])
        svc.begin_shutdown()
        with pytest.raises(ServiceClosed):
            svc.submit(dag, [1])
        # the in-flight run still completes: drain, don't drop
        assert fut.result(timeout=30) is not None
        svc.close()
        svc.close()  # idempotent


# -- graceful shutdown ---------------------------------------------------------

class TestShutdown:
    def test_client_close_idempotent(self):
        client = Client(device="cpu")
        client.close()
        client.close()
        with Client(device="cpu") as c2:
            c2.close()  # __exit__ will close again: must not raise

    def test_gateway_drains_inflight_and_503s_new(self):
        client = Client(max_workers=1, max_pending=8, device="cpu")
        _register_slow(client.registry)
        gw = GatewayServer(client, TokenAuthenticator(TOKENS))
        gw.start()
        body = {
            "spec": WorkflowSpec.from_steps(
                "d", [("slow", {"seconds": 0.5})]
            ).to_dict(),
            "data": [1],
        }
        st, doc, _ = _request(gw.url, "POST", "/v1/workflows", "tok-a", body)
        assert st == 202
        gw.begin_shutdown()
        # new submissions: structured 503 + Retry-After
        st2, doc2, hdrs = _request(gw.url, "POST", "/v1/workflows", "tok-a", body)
        assert st2 == 503 and doc2["error"] == "draining"
        assert "Retry-After" in hdrs
        # health reflects draining; status stays readable during the drain
        st3, health, _ = _request(gw.url, "GET", "/healthz")
        assert st3 == 200 and health["draining"] is True
        final = _wait_done(gw.url, "tok-a", doc["run_id"])
        assert final["status"] == "done"  # accepted run was not dropped
        gw.close()
        gw.close()  # idempotent
        client.close()

    def test_cli_sigterm_graceful(self, tmp_path: Path):
        proc = subprocess.Popen(
            [
                sys.executable, "-m", "repro_torch.gateway.serve",
                "--root", str(tmp_path / "store"),
                "--port", "0",
                "--token", "t=alice",
                "--demo-modules",
                "--device", "cpu",
            ],
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
            env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
                 "OMP_NUM_THREADS": "1"},
        )
        try:
            line = proc.stdout.readline()
            assert "gateway listening on http://" in line, line
            base = line.split("listening on ")[1].split()[0]
            st, doc, _ = _request(base, "GET", "/healthz", timeout=10)
            assert st == 200 and doc["ok"]
            st, doc, _ = _request(
                base, "POST", "/v1/workflows", "t",
                {"spec": _chain_doc(), "data": [1, 2, 3], "wait": True},
                timeout=30,
            )
            assert st == 200 and doc["status"] == "done"
            proc.send_signal(signal.SIGTERM)
            out, _ = proc.communicate(timeout=30)
            assert proc.returncode == 0, out
            assert "gateway stopped" in out
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.communicate(timeout=10)


# -- provenance-catalog browse -------------------------------------------------

class TestArtifactsEndpoint:
    def _seed(self, gw, token, factor, namespace=None, runs=2):
        """Run the nums chain until the policy admits it (PT: support >= 2)."""
        spec = WorkflowSpec.from_steps(
            "nums", ["normalize", ("scale", {"factor": factor})]
        ).to_dict()
        body = {"spec": spec, "data": [1.0, 2.0, 3.0], "wait": True}
        if namespace is not None:
            body["namespace"] = namespace
        for _ in range(runs):
            st, doc, _ = _request(gw.url, "POST", "/v1/workflows", token, body)
            assert st == 200 and doc["status"] == "done", doc

    def test_artifacts_are_tenant_scoped(self, gateway):
        self._seed(gateway, "tok-a", factor=2.0)
        st, doc, _ = _request(gateway.url, "GET", "/v1/artifacts?module=scale", "tok-a")
        assert st == 200
        assert doc["namespace"] == "tenant:alice"
        assert doc["count"] >= 1
        art = doc["artifacts"][0]
        assert art["modules"][-1] == "scale"
        assert art["params"][-1] == {"factor": 2.0}
        assert art["key"].startswith("tenant:alice/nums::")
        # bob's private view is empty; alice's artifacts are invisible to him
        st, doc, _ = _request(gateway.url, "GET", "/v1/artifacts?module=scale", "tok-b")
        assert st == 200 and doc["count"] == 0
        # a foreign private namespace is a 403, not an empty answer
        st, doc, _ = _request(
            gateway.url, "GET", "/v1/artifacts?namespace=tenant:alice", "tok-b"
        )
        assert st == 403 and doc["error"] == "namespace_denied"

    def test_artifacts_param_filter_is_typed(self, gateway):
        self._seed(gateway, "tok-a", factor=2.0)
        self._seed(gateway, "tok-a", factor=3.0)
        st, doc, _ = _request(
            gateway.url, "GET", "/v1/artifacts?module=scale&param.factor=2.0", "tok-a"
        )
        assert st == 200 and doc["count"] == 1
        assert doc["artifacts"][0]["params"][-1] == {"factor": 2.0}
        st, doc, _ = _request(
            gateway.url, "GET", "/v1/artifacts?module=scale&param.factor=9.9", "tok-a"
        )
        assert st == 200 and doc["count"] == 0
        # filters without a module anchor are a structured 400
        st, doc, _ = _request(
            gateway.url, "GET", "/v1/artifacts?param.factor=2.0", "tok-a"
        )
        assert st == 400 and doc["error"] == "bad_request"
        st, doc, _ = _request(
            gateway.url, "GET", "/v1/artifacts?module=scale&limit=nope", "tok-a"
        )
        assert st == 400

    def test_shared_namespace_is_browsable_cross_tenant(self, gateway):
        self._seed(gateway, "tok-a", factor=2.0, namespace="shared")
        st, doc, _ = _request(
            gateway.url, "GET", "/v1/artifacts?module=scale&namespace=shared", "tok-b"
        )
        assert st == 200 and doc["namespace"] == "shared" and doc["count"] >= 1
        assert all(
            a["key"].startswith("shared/") for a in doc["artifacts"]
        )

    def test_artifacts_never_report_evicted(self, gateway):
        self._seed(gateway, "tok-a", factor=2.0)
        st, doc, _ = _request(gateway.url, "GET", "/v1/artifacts?module=scale", "tok-a")
        assert doc["count"] >= 1
        for art in doc["artifacts"]:
            gateway.client.store.evict(art["key"])
        st, doc, _ = _request(gateway.url, "GET", "/v1/artifacts?module=scale", "tok-a")
        assert st == 200 and doc["count"] == 0, doc

    def test_recommend_surfaces_near_misses(self, gateway):
        self._seed(gateway, "tok-a", factor=3.0)
        # the recommend chain resolves the registry default factor=2.0 —
        # one param away from the stored factor=3.0 artifact
        st, doc, _ = _request(
            gateway.url, "GET", "/v1/recommend?dataset=nums&modules=normalize,scale",
            "tok-a",
        )
        assert st == 200, doc
        assert doc["near_misses"], doc
        nm = doc["near_misses"][0]
        assert nm["kind"] == "near_miss"
        assert "scale.factor=3.0 (yours 2.0)" == nm["note"]


# -- against the reference package ---------------------------------------------

def _reference():
    """The reference package's client, gateway and store server."""
    pytest.importorskip("jax")
    from repro import api as japi
    from repro import core as jcore
    from repro import gateway as jgw
    from repro import net as jnet
    from repro.gateway.serve import register_demo_modules as jdemo

    return japi, jcore, jgw, jnet, jdemo


def _build_gateway(package: str, **client_kw):
    if package == "port":
        client = Client(device="cpu", **client_kw)
        register_demo_modules(client.registry)

        @client.registry.module("as_array")
        def as_array(xs):
            return torch.tensor(xs, dtype=torch.float32)

        gw = GatewayServer(client, TokenAuthenticator(TOKENS))
    else:
        japi, _, jgw, _, jdemo = _reference()
        client = japi.Client(**client_kw)
        jdemo(client.registry)

        @client.registry.module("as_array")
        def as_array(xs):
            return np.asarray(xs, dtype=np.float32)

        gw = jgw.GatewayServer(client, jgw.TokenAuthenticator(TOKENS))
    gw.start()
    return gw, client


_VOLATILE = ("run_id", "trace_id")


def _stable(doc: dict) -> dict:
    """A run document without what differs between any two runs: its ids
    and seconds; the output only where it is a placeholder."""
    out = {k: v for k, v in doc.items() if k not in _VOLATILE}
    if "result" in doc:
        res = dict(doc["result"])
        res.pop("total_seconds")
        if isinstance(res["output"], str) and res["output"].startswith("<unserializable"):
            res.pop("output")
        out["result"] = res
    return out


def test_same_spec_gives_equal_documents_in_both_packages():
    """The same spec JSON POSTed to both packages' gateways, as two tenants
    in ``shared`` and in private namespaces: equal run documents (ids,
    seconds and the placeholder of a tensor output excepted), equal stored
    keys, equal ``/v1/recommend`` and ``/v1/stats`` tenant rows."""
    docs: dict[str, list] = {}
    keys: dict[str, list] = {}
    recs: dict[str, dict] = {}
    outputs: dict[str, list] = {}
    chains = [
        _chain_doc(),
        WorkflowSpec.from_steps("nums", ["normalize", ("scale", {"factor": 3.0}),
                                         "as_array"]).to_dict(),
    ]
    for package in ("port", "reference"):
        gw, client = _build_gateway(package)
        try:
            docs[package], outputs[package] = [], []
            for token, namespace in (("tok-a", "shared"), ("tok-a", "shared"),
                                     ("tok-a", "shared"), ("tok-b", "shared"),
                                     ("tok-b", None), ("tok-a", None)):
                for spec in chains:
                    body = {"spec": spec, "data": [1.0, 2.0, 3.0], "wait": True}
                    if namespace:
                        body["namespace"] = namespace
                    st, doc, _ = _request(gw.url, "POST", "/v1/workflows", token, body)
                    assert st == 200 and doc["status"] == "done", doc
                    docs[package].append(_stable(doc))
                    outputs[package].append(doc["result"]["output"])
            keys[package] = sorted(client.store.records)
            st, recs[package], _ = _request(
                gw.url, "GET",
                "/v1/recommend?dataset=nums&modules=normalize,scale&namespace=shared",
                "tok-b",
            )
            assert st == 200
            st, stats, _ = _request(gw.url, "GET", "/v1/stats", "tok-b")
            assert st == 200
            recs[package]["tenant"] = {
                k: v for k, v in stats["tenant"]["bob"].items() if "bytes" not in k}
        finally:
            gw.close()
            client.close()
    assert docs["port"] == docs["reference"]
    assert keys["port"] == keys["reference"] and keys["port"]
    assert recs["port"] == recs["reference"]
    # the tensor output is a placeholder in both; the list outputs are equal
    assert outputs["port"][1] == "<unserializable: Tensor>"
    assert outputs["reference"][1].startswith("<unserializable")
    assert outputs["port"][0::2] == outputs["reference"][0::2]
    # bob's first shared run reused a prefix that alice's runs stored
    assert docs["port"][6]["result"]["n_skipped"] >= 1


@pytest.mark.parametrize("gateway_pkg,server_pkg", [("port", "reference"), ("reference", "port")])
def test_each_package_gateway_over_the_other_store_server(gateway_pkg, server_pkg):
    """One wire protocol under the gateway: a gateway of one package mounts
    a ``StoreServer`` of the other with ``store_url``; alice's shared runs
    store the chain there and bob's run skips every module."""
    _, jcore, _, jnet, _ = _reference()
    if server_pkg == "port":
        server = StoreServer(MemoryBackend()).start()
    else:
        server = jnet.StoreServer(jcore.MemoryBackend()).start()
    gw, client = _build_gateway(gateway_pkg, store_url=f"127.0.0.1:{server.port}")
    try:
        body = {"spec": _chain_doc(), "data": [1, 2, 3], "namespace": "shared",
                "wait": True}
        stored = []
        for _ in range(3):
            st, doc, _ = _request(gw.url, "POST", "/v1/workflows", "tok-a", body)
            assert st == 200 and doc["status"] == "done", doc
            stored += doc["result"]["stored_keys"]
        assert stored and all(k.startswith("shared/nums::") for k in stored)
        assert server.stats()["ops"].get("write_blob", 0) >= 1
        st, doc, _ = _request(gw.url, "POST", "/v1/workflows", "tok-b", body)
        res = doc["result"]
        assert st == 200 and res["n_computed"] == 0 and res["n_skipped"] == res["n_nodes"]
    finally:
        gw.close()
        client.close()
        server.stop()
