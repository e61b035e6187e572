"""The port's provenance catalog facade (``repro_torch.catalog.Catalog``), its
``python -m repro_torch.catalog.query`` CLI and ``Client.find``, on the CPU.

Modelled on the cases of ``tests/test_catalog.py`` that cover ``catalog.py``,
``query.py``, ``Client.find`` and the recommender's near misses, with its two
store and tool-state cases (the shared ``index.json`` re-parse skip and the
``ToolState.to_config`` decode cache); the record, index and server cases are
in ``tests/test_torch_catalog_index.py``.  Beyond them, held against the
reference package and exactly: each package's ``Client`` over the other
package's ``StoreServer`` finds the records the other published, the port's
``Catalog`` reads a catalog the reference's wrote, and the dedup CLI prints
the same report in both packages.
"""
import json
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from repro.api import Client as JaxClient
from repro.catalog import Catalog as JaxCatalog
from repro.core import LocalFSBackend as JaxFS
from repro.core import workflow as jworkflow
from repro.net import StoreServer as JaxServer
from repro_torch.api import Client
from repro_torch.catalog import Catalog, CatalogQuery, record_for_prefix
from repro_torch.core import IntermediateStore, LocalFSBackend, MemoryBackend
from repro_torch.core.workflow import ModuleRef, PrefixKey, ToolState, encode_param
from repro_torch.net import StoreServer

ROOT = Path(__file__).resolve().parents[1]
CHAIN = (("load", {"scale": 2}), ("norm", {"mode": "z"}))


def _prefix(dataset="ds", chain=CHAIN, wf=(ModuleRef, ToolState, PrefixKey)):
    ref, state, key = wf
    return key(dataset, tuple(ref(m, state.from_config(cfg)) for m, cfg in chain))


def _rec(dataset="ds", chain=CHAIN, **stats):
    p = _prefix(dataset, chain)
    return record_for_prefix(p, p.key(True), **stats)


# -- the facade ----------------------------------------------------------------------
def test_catalog_persists_and_reloads(tmp_path):
    cat = Catalog(LocalFSBackend(tmp_path))
    assert cat.persist
    rec = cat.publish(_prefix("alice/ds1"), _prefix("alice/ds1").key(True))
    cat.flush()
    reborn = Catalog(LocalFSBackend(tmp_path))
    assert [r.key for r in reborn.find(module="norm")] == [rec.key]
    reborn.discard(rec.key)
    reborn.flush()
    assert Catalog(LocalFSBackend(tmp_path)).find(module="norm") == []


def test_verify_present_drops_and_prunes(tmp_path):
    cat = Catalog(LocalFSBackend(tmp_path))
    a = cat.publish(_prefix("ds1"), "k-a")
    b = cat.publish(_prefix("ds2"), "k-b")
    c = cat.publish(_prefix("ds3"), "k-c")
    kept = cat.verify_present(
        [a, b, c], {"k-a": "present", "k-b": "absent", "k-c": "unreachable"})
    assert [r.key for r in kept] == ["k-a"]
    assert "k-b" not in cat.index
    assert "k-c" in cat.index


def test_shared_index_skips_reparse_when_bytes_unchanged():
    store = IntermediateStore(backend=MemoryBackend())
    store.backend.write_meta(
        "index.json", json.dumps({"k": {"key": "k", "nbytes_raw": 4,
                                        "nbytes_disk": 4, "save_s": 0.1}}))
    with store._lock:
        first = store._shared_index()
        ts, raw, parsed = store._shared_index_cache
        store._shared_index_cache = (ts - 1e6, raw, parsed)
        assert store._shared_index() is first, "unchanged bytes must reuse the cached parse"
        store.backend.write_meta("index.json", json.dumps({}))
        ts, raw, parsed = store._shared_index_cache
        store._shared_index_cache = (ts - 1e6, raw, parsed)
        changed = store._shared_index()
        assert changed == {} and changed is not first


def test_toolstate_to_config_caches_decode():
    ts = ToolState.from_config({"a": (1, 2), "b": 3.5, "c": "x"})
    one = ts.to_config()
    assert one == {"a": (1, 2), "b": 3.5, "c": "x"}
    cached = ts._decoded
    two = ts.to_config()
    assert ts._decoded is cached, "decode runs once per instance"
    assert two == one and two is not one, "callers get independent copies"
    two["a"] = None
    assert ts.to_config() == one


# -- Client.find and the near misses -------------------------------------------------
def _register(c):
    c.register_fn("load", lambda d, scale=1: [x * scale for x in d], scale=1)
    c.register_fn("norm", lambda d, mode="z": d, mode="z")
    return c


def _client(tmp_path, **kw):
    return _register(Client(str(tmp_path / "store"), device="cpu", **kw))


def _run_chain(c, scale, mode="z", dataset="ds1", times=2):
    for _ in range(times):  # PT admits at support >= 2
        spec = c.spec(dataset)
        spec.chain([("load", {"scale": scale}), ("norm", {"mode": mode})])
        r = c.run(spec, [1, 2, 3])
    return r


def test_client_find_in_process(tmp_path):
    c = _client(tmp_path, namespace="alice")
    try:
        _run_chain(c, scale=2)
        _run_chain(c, scale=3)
        hits = c.find(module="norm", params={"mode": "z"})
        assert len(hits) == 2
        assert all(h.namespace == "alice" for h in hits)
        assert {h.params(0)["scale"] for h in hits} == {2, 3}
        assert c.find(module="load", params={"scale": 2}) == []
        assert len(c.find(module="load", any_position=True)) == 2
        assert c.find(module="norm", namespace="bob") == []
        assert len(c.find(module="norm", namespace="*")) == 2
    finally:
        c.close()


def test_client_find_never_reports_evicted(tmp_path):
    c = _client(tmp_path)
    try:
        _run_chain(c, scale=2)
        hits = c.find(module="norm")
        assert len(hits) == 1
        key = hits[0].key
        c.store.evict(key)
        assert c.find(module="norm") == [], "zero-phantom: evicted => invisible"
        assert key not in c.catalog.index
    finally:
        c.close()


def test_catalog_survives_client_restart_local(tmp_path):
    c = _client(tmp_path)
    try:
        _run_chain(c, scale=2)
    finally:
        c.close()
    c2 = Client(str(tmp_path / "store"), device="cpu")
    try:
        assert len(c2.find(module="norm")) == 1, "catalog.json persists across restarts"
    finally:
        c2.close()


def test_recommender_near_misses(tmp_path):
    c = _client(tmp_path, namespace="alice")
    try:
        _run_chain(c, scale=2)
        _run_chain(c, scale=3)
        _run_chain(c, scale=3, mode="minmax")
        spec = c.spec("ds1")
        spec.chain([("load", {"scale": 7}), ("norm", {"mode": "z"})])
        report = c.recommend(spec)
        notes = [s.note for s in report.near_misses]
        assert len(notes) == 2
        assert all("load.scale=" in n and "(yours 7)" in n for n in notes)
        assert all(s.kind == "near_miss" for s in report.near_misses)
        spec2 = c.spec("ds1")
        spec2.chain([("load", {"scale": 2}), ("norm", {"mode": "z"})])
        exact = c.recommend(spec2)
        assert [s.note for s in exact.near_misses] == ["load.scale=3 (yours 2)"]
    finally:
        c.close()


def test_near_miss_requires_single_diff():
    from repro_torch.api.recommend import Recommender

    own = [{"a": encode_param(1), "b": encode_param(2)}]
    same = [{"a": encode_param(1), "b": encode_param(2)}]
    one = [{"a": encode_param(9), "b": encode_param(2)}]
    two = [{"a": encode_param(9), "b": encode_param(8)}]
    missing = [{"a": encode_param(1)}]
    assert Recommender._one_param_diff(own, same, ("m",)) is None
    assert "m.a=9 (yours 1)" == Recommender._one_param_diff(own, one, ("m",))
    assert Recommender._one_param_diff(own, two, ("m",)) is None
    assert "m.b=unset (yours 2)" == Recommender._one_param_diff(own, missing, ("m",))


@pytest.fixture()
def server(tmp_path):
    srv = StoreServer(LocalFSBackend(tmp_path / "pool")).start()
    yield srv
    srv.stop()


def test_client_remote_catalog_survives_client_churn(server):
    url = f"127.0.0.1:{server.port}"
    c = _register(Client(store_url=url, namespace="alice", device="cpu"))
    try:
        _run_chain(c, scale=2)
    finally:
        c.close()
    c2 = Client(store_url=url, namespace="alice", device="cpu")
    try:
        hits = c2.find(module="norm")
        assert len(hits) == 1
        assert c2.catalog.remote_queries == 1
        assert len(c2.catalog.index) == 0
    finally:
        c2.close()


# -- across the packages ---------------------------------------------------------------
def _port_client(url):
    return Client(store_url=url, namespace="alice", device="cpu")


def _reference_client(url):
    return JaxClient(store_url=url, namespace="alice")


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_clients_find_each_others_records_through_either_server(tmp_path, writer):
    """One package's ``Client`` runs over the other package's server; a fresh
    client of the other package finds the records, equal as documents."""
    if writer == "port":
        server = JaxServer(JaxFS(tmp_path / "pool")).start()
        mk_writer, mk_reader = _port_client, _reference_client
    else:
        server = StoreServer(LocalFSBackend(tmp_path / "pool")).start()
        mk_writer, mk_reader = _reference_client, _port_client
    url = f"127.0.0.1:{server.port}"
    w = _register(mk_writer(url))
    try:
        _run_chain(w, scale=2)
        _run_chain(w, scale=3)
        written = sorted((h.to_doc() for h in w.find(module="norm")), key=lambda d: d["key"])
    finally:
        w.close()
    r = mk_reader(url)
    try:
        hits = r.find(module="norm", params={"mode": "z"})
        assert len(hits) == 2 and r.catalog.remote_queries == 1
        docs = sorted((h.to_doc() for h in hits), key=lambda d: d["key"])
        assert [d["key"] for d in docs] == [d["key"] for d in written]
        # the reuse statistics move with every load; the rest is the record
        strip = ("n_loads", "last_used_at", "load_s")
        assert [{k: v for k, v in d.items() if k not in strip} for d in docs] == \
            [{k: v for k, v in d.items() if k not in strip} for d in written]
        assert {h.params(0)["scale"] for h in hits} == {2, 3}
    finally:
        r.close()
        server.stop()


def test_port_catalog_reads_the_reference_catalog(tmp_path):
    """``catalog.json`` written by the reference's ``Catalog`` loads in the
    port's and answers the same query (and back)."""
    jcat = JaxCatalog(JaxFS(tmp_path / "a"))
    wf = (jworkflow.ModuleRef, jworkflow.ToolState, jworkflow.PrefixKey)
    for ds, chain in (("alice/ds1", CHAIN), ("bob/ds2", CHAIN),
                      ("alice/ds3", (("load", {"scale": 5}),))):
        p = _prefix(ds, chain, wf)
        jcat.publish(p, p.key(True))
    jcat.flush()
    ours = Catalog(LocalFSBackend(tmp_path / "a"))
    for q in (dict(module="norm"), dict(module="load", any_position=True),
              dict(module="load", params={"scale": 5}), dict(namespace="alice")):
        assert [r.to_doc() for r in ours.find(**q)] == [r.to_doc() for r in jcat.find(**q)]
    cat = Catalog(LocalFSBackend(tmp_path / "b"))
    p = _prefix("carol/ds9")
    cat.publish(p, p.key(True))
    cat.flush()
    back = JaxCatalog(JaxFS(tmp_path / "b")).find(module="norm")
    assert [r.to_doc() for r in back] == [r.to_doc() for r in cat.find(module="norm")]


# -- the cross-namespace dedup report --------------------------------------------------
def _tenant_rec(ns, dataset="ds", chain=(("load", {"scale": 2}),), **stats):
    return _rec(f"{ns}/{dataset}", chain, **stats)


def test_dedup_report_groups_identical_chains_across_tenants():
    from repro_torch.catalog.query import dedup_report

    a = _tenant_rec("tenant:a", nbytes=100, n_loads=5)
    b = _tenant_rec("tenant:b", nbytes=100, n_loads=1)
    c = _tenant_rec("tenant:c", nbytes=100)
    other = _tenant_rec("tenant:b", chain=(("load", {"scale": 3}),), nbytes=50)
    solo = _tenant_rec("tenant:a", dataset="ds2", nbytes=10)
    report = dedup_report([a, b, c, other, solo])
    assert len(report) == 1
    entry = report[0]
    assert entry["namespaces"] == ["tenant:a", "tenant:b", "tenant:c"]
    assert entry["n_copies"] == 3
    assert entry["keep"] == a.key, "most-reused copy is kept"
    assert entry["promote_to"] == "shared"
    assert entry["reclaimable_bytes"] == 200
    assert entry["total_loads"] == 6
    assert entry["params"] == {"scale": 2}


def test_dedup_report_tenant_only_toggle():
    from repro_torch.catalog.query import dedup_report

    shared = _rec("shared/ds", (("load", {"scale": 2}),), nbytes=10)
    tenant = _tenant_rec("tenant:a", nbytes=10)
    assert dedup_report([shared, tenant]) == []
    full = dedup_report([shared, tenant], tenant_only=False)
    assert len(full) == 1
    assert full[0]["namespaces"] == ["shared", "tenant:a"]


def _dedup_catalog(root):
    cat = Catalog(LocalFSBackend(root))
    for ns, loads in (("tenant:a", 3), ("tenant:b", 0)):
        p = _prefix(f"{ns}/ds")
        cat.publish(p, p.key(True))
        rec = cat.index.get(p.key(True))
        rec.nbytes, rec.n_loads = 40, loads
    cat.flush()


def test_dedup_cli_end_to_end(tmp_path, capsys):
    from repro_torch.catalog.query import main as query_main

    _dedup_catalog(tmp_path)
    assert query_main(["--root", str(tmp_path), "--dedup", "--json"]) == 0
    report = json.loads(capsys.readouterr().out)
    assert len(report) == 1
    assert report[0]["reclaimable_bytes"] == 40
    assert report[0]["namespaces"] == ["tenant:a", "tenant:b"]
    assert query_main(["--root", str(tmp_path), "--dedup"]) == 0
    out, err = capsys.readouterr()
    assert "tenant:a,tenant:b" in out
    assert "40 byte(s) reclaimable" in err


@pytest.mark.parametrize("args", [["--dedup", "--json"], ["--dedup"],
                                  ["--module", "load", "--json"],
                                  ["--module", "norm", "--namespace", "tenant:a"]])
def test_query_cli_prints_the_reference_report(tmp_path, args):
    """Both packages' CLIs, each in a process of its own, print the same
    bytes for the same catalog."""
    _dedup_catalog(tmp_path)
    env = {"PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu", "PATH": "/usr/bin:/bin"}
    outs = [
        subprocess.run([sys.executable, "-m", f"{pkg}.catalog.query", "--root",
                        str(tmp_path), *args],
                       capture_output=True, text=True, env=env, cwd=ROOT, timeout=120)
        for pkg in ("repro_torch", "repro")
    ]
    assert [o.returncode for o in outs] == [0, 0], [o.stderr for o in outs]
    assert outs[0].stdout == outs[1].stdout and outs[0].stdout.strip()
    assert outs[0].stderr == outs[1].stderr
