"""The port's catalog records and index (``repro_torch.catalog``) and the
store server's ``catalog_*`` ops over them, on the CPU.

Modelled on the records, index and server cases of ``tests/test_catalog.py``
(the ``Catalog`` facade, the recommender and the ``Client`` cases wait for
``catalog/{catalog,query}.py`` and ``api/``).  Beyond them: a record built by
either package is the same document, and the reference's ``RemoteBackend``
publishes into and queries the port server's index.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import catalog as jcatalog
from repro.core import workflow as jworkflow
from repro.net import RemoteBackend as JaxRemote
from repro_torch.catalog import (
    CatalogIndex,
    CatalogQuery,
    CatalogRecord,
    rank_key,
    record_for_prefix,
    split_namespaced_dataset,
)
from repro_torch.core import IntermediateStore, LocalFSBackend
from repro_torch.core.workflow import ModuleRef, PrefixKey, ToolState, encode_param
from repro_torch.net import RemoteBackend, StoreServer

CHAIN = (("load", {"scale": 2}), ("norm", {"mode": "z"}))


def _prefix(dataset="ds", chain=CHAIN, wf=None):
    wf = wf or (ModuleRef, ToolState, PrefixKey)
    ref, state, key = wf
    return key(dataset, tuple(ref(m, state.from_config(cfg)) for m, cfg in chain))


def _rec(dataset="ds", chain=CHAIN, **stats):
    p = _prefix(dataset, chain)
    return record_for_prefix(p, p.key(True), **stats)


# -- records / documents -------------------------------------------------------
def test_split_namespaced_dataset():
    assert split_namespaced_dataset("alice/ds1") == ("alice", "ds1")
    assert split_namespaced_dataset("ds1") == ("", "ds1")
    assert split_namespaced_dataset("a/b/c") == ("a", "b/c")


def test_record_for_prefix_and_roundtrip():
    rec = _rec("alice/ds1", nbytes=10, n_loads=3)
    assert (rec.namespace, rec.dataset, rec.dataset_id) == ("alice", "ds1", "alice/ds1")
    assert rec.modules == ("load", "norm") and rec.module == "norm" and rec.depth == 2
    assert rec.params(0) == {"scale": 2}
    assert rec.params() == {"mode": "z"}
    back = CatalogRecord.from_doc(json.loads(json.dumps(rec.to_doc())))
    assert back == rec
    assert back.prefix_key().key(True) == rec.key


def test_records_are_the_same_document_in_both_packages():
    """The server stores and answers documents, so a record of either package
    must be the other's: same key, same encoded params, same round trip."""
    stats = dict(nbytes=10, n_loads=3, compute_s=0.5, created_at=1.0, last_used_at=2.0)
    jp = _prefix("alice/ds1", wf=(jworkflow.ModuleRef, jworkflow.ToolState, jworkflow.PrefixKey))
    tp = _prefix("alice/ds1")
    assert jp.key(True) == tp.key(True)
    jdoc = jcatalog.record_for_prefix(jp, jp.key(True), **stats).to_doc()
    tdoc = record_for_prefix(tp, tp.key(True), **stats).to_doc()
    assert tdoc == jdoc
    assert CatalogRecord.from_doc(jdoc).to_doc() == jdoc
    assert jcatalog.CatalogRecord.from_doc(tdoc).to_doc() == tdoc
    q = dict(module="load", params={"scale": 2}, any_position=True, namespace="alice")
    assert CatalogQuery.build(**q).to_doc() == jcatalog.CatalogQuery.build(**q).to_doc()


def test_query_build_encodes_typed_params():
    q = CatalogQuery.build(module="load", params={"scale": 2})
    assert q.params == {"scale": encode_param(2)}
    assert q.matches(_rec(chain=(("load", {"scale": 2}),)))
    assert not q.matches(_rec(chain=(("load", {"scale": "2"}),)))
    with pytest.raises(ValueError, match="module"):
        CatalogQuery.build(params={"scale": 2})


def test_query_matching_positions_and_scopes():
    rec = _rec("alice/ds1")
    assert CatalogQuery.build(module="norm").matches(rec)
    assert not CatalogQuery.build(module="load").matches(rec)
    assert CatalogQuery.build(module="load", any_position=True).matches(rec)
    assert CatalogQuery.build(namespace="alice").matches(rec)
    assert not CatalogQuery.build(namespace="").matches(rec)
    assert CatalogQuery.build(dataset="ds1").matches(rec)
    assert not CatalogQuery.build(dataset="other").matches(rec)
    twice = _rec(chain=(("f", {"k": 1}), ("f", {"k": 2})))
    assert CatalogQuery.build(module="f", params={"k": 1}, any_position=True).matches(twice)
    assert not CatalogQuery.build(module="f", params={"k": 1}).matches(twice)
    assert CatalogQuery.build(module="f", params={"k": 2}).matches(twice)


def test_rank_key_orders_loads_depth_recency():
    a = _rec("d1", (("m", {"k": 1}),), n_loads=5)
    b = _rec("d2", (("m", {"k": 1}), ("m2", {})), n_loads=1, last_used_at=100.0)
    c = _rec("d3", (("m", {"k": 1}),), n_loads=1, last_used_at=50.0)
    assert sorted([c, b, a], key=rank_key) == [a, b, c]


# -- index ---------------------------------------------------------------------
def test_index_upsert_touch_discard():
    idx = CatalogIndex()
    rec = _rec(n_loads=1, last_used_at=10.0)
    idx.upsert(rec)
    assert len(idx) == 1 and rec.key in idx
    idx.upsert(_rec(n_loads=0, last_used_at=5.0))  # staler stats keep the best
    assert idx.get(rec.key).n_loads == 1
    assert idx.touch(rec.key, last_used_at=20.0, n_loads=4)
    assert idx.get(rec.key).n_loads == 4 and idx.get(rec.key).last_used_at == 20.0
    assert not idx.touch("missing", last_used_at=1.0, n_loads=1)
    assert idx.discard(rec.key)
    assert not idx.discard(rec.key)
    assert len(idx) == 0
    assert idx.query(CatalogQuery.build(module="norm")) == []


def test_index_query_uses_postings_but_stays_exact():
    idx = CatalogIndex()
    for i in range(20):
        idx.upsert(_rec(f"ds{i}", (("load", {"scale": i}), ("norm", {"mode": "z"}))))
    hits = idx.query(CatalogQuery.build(module="load", params={"scale": 7}, any_position=True))
    assert [h.params(0) for h in hits] == [{"scale": 7}]
    assert idx.query(CatalogQuery.build(module="norm", limit=5)) == sorted(
        idx.query(CatalogQuery.build(module="norm", limit=100)), key=rank_key)[:5]
    assert idx.query(CatalogQuery.build(dataset="ds3"))[0].dataset == "ds3"


def test_index_snapshot_load_and_prune():
    idx = CatalogIndex()
    idx.upsert(_rec("a/ds"))
    idx.upsert(_rec("b/ds"))
    fresh = CatalogIndex()
    fresh.load(idx.snapshot() + [{"broken": True}, 42])  # malformed entries skipped
    assert len(fresh) == 2
    keep = {r.key for r in fresh.query(CatalogQuery.build(namespace="a"))}
    fresh.prune(lambda k: k in keep)
    assert len(fresh) == 1
    assert fresh.query(CatalogQuery.build(namespace="b")) == []


# -- the port's server: the catalog op family ------------------------------------
@pytest.fixture()
def server(tmp_path):
    srv = StoreServer(LocalFSBackend(tmp_path / "pool")).start()
    yield srv
    srv.stop()


@pytest.mark.parametrize("client", ["port", "reference"])
def test_server_catalog_ops(server, client):
    rb = (RemoteBackend if client == "port" else JaxRemote)(f"127.0.0.1:{server.port}")
    try:
        rec = _rec("alice/ds1", n_loads=2)
        assert rb.catalog_put(rec.to_doc())
        assert server.stats()["catalog_records"] == 1
        out = rb.catalog_query(CatalogQuery.build(module="norm").to_doc())
        assert [d["key"] for d in out] == [rec.key]
        assert rb.catalog_query(CatalogQuery.build(module="other").to_doc()) == []
        assert rb.catalog_remove(rec.key)
        assert server.stats()["catalog_records"] == 0
    finally:
        rb.close()


def test_server_delete_prunes_catalog(server):
    rb = RemoteBackend(f"127.0.0.1:{server.port}")
    store = IntermediateStore(backend=rb)
    try:
        p = _prefix("ds1")
        key = p.key(True)
        store.put(key, torch.ones(4))
        assert rb.catalog_put(record_for_prefix(p, key).to_doc())
        store.evict(key)  # -> backend.delete -> server-side catalog prune
        assert server.catalog.get(key) is None
    finally:
        rb.close()


def test_server_catalog_persists_across_restart(tmp_path):
    srv = StoreServer(LocalFSBackend(tmp_path / "pool")).start()
    rb = RemoteBackend(f"127.0.0.1:{srv.port}")
    try:
        assert rb.catalog_put(_rec("ds-persist").to_doc())
    finally:
        rb.close()
        srv.stop()  # flushes catalog.json
    srv2 = StoreServer(LocalFSBackend(tmp_path / "pool")).start()
    try:
        assert len(srv2.catalog) == 0, "blobless records are pruned at load"
    finally:
        srv2.stop()


def test_server_catalog_restart_keeps_live_records(tmp_path):
    srv = StoreServer(LocalFSBackend(tmp_path / "pool")).start()
    rb = RemoteBackend(f"127.0.0.1:{srv.port}")
    p = _prefix("ds1")
    key = p.key(True)
    try:
        IntermediateStore(backend=rb).put(key, torch.from_numpy(np.ones(4, np.float32)))
        assert rb.catalog_put(record_for_prefix(p, key).to_doc())
    finally:
        rb.close()
        srv.stop()
    srv2 = StoreServer(LocalFSBackend(tmp_path / "pool")).start()
    rb2 = RemoteBackend(f"127.0.0.1:{srv2.port}")
    try:
        out = rb2.catalog_query(CatalogQuery.build(module="norm").to_doc())
        assert [d["key"] for d in out] == [key]
    finally:
        rb2.close()
        srv2.stop()


def test_remote_backend_degrades_without_catalog_support(server):
    rb = RemoteBackend(f"127.0.0.1:{server.port}")
    try:
        rb._server_catalog = False  # an old server: force the negotiation flag
        assert not rb.catalog_put(_rec().to_doc())
        assert rb.catalog_query(CatalogQuery.build(module="m").to_doc()) is None
        assert not rb.catalog_remove("k")
    finally:
        rb.close()
