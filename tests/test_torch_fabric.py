"""KV snapshots shared between the two packages through the fabric store, on
the CPU (modelled on ``tests/test_serve_fabric.py``).

* a snapshot saved by an engine of either package restores in the other, and
  generation is token-equal on an fp32 smoke stream, for a KV cache
  (tinyllama-smoke) and for MLA's latent cache (deepseek-v2-smoke);
* a JAX engine and a torch engine share one election over a reference
  ``StoreServer``, and over the port's own, and prefill the shared prefix
  exactly once, also when the first leader dies mid-prefill;
* engines mounted with a cache tier (``cache_bytes``) restore token-equal,
  and a repeat restore is served from the tier with no round trip;
* a remote eviction event prunes the torch engine's records and
  ``policy.stored``, and every local removal path credits the tenant ledger.
"""
import dataclasses
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax
import jax.numpy as jnp

from repro.configs import get_config as jax_config
from repro.core import LocalFSBackend as JaxFS
from repro.core import MemoryBackend as JaxMemory
from repro.core.risp import TSAR as JaxTSAR
from repro.models import transformer as jax_tf
from repro.models.layers import init_params as jax_init
from repro.net import DistributedSingleFlight as JaxFlight
from repro.net import RemoteBackend as JaxRemote
from repro.net import StoreServer
from repro.serve import FabricSnapshotStore as JaxFabric
from repro.serve import ServeEngine as JaxEngine
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core import LocalFSBackend, MemoryBackend
from repro_torch.core.risp import TSAR
from repro_torch.net import RemoteBackend
from repro_torch.net import StoreServer as PortStoreServer
from repro_torch.sched.stats import TenantLedger
from repro_torch.serve import FabricSnapshotStore, ServeEngine, mount_serve_engine

CHUNK, MAX_LEN, NEW = 8, 64, 4


def _model(arch):
    jcfg = dataclasses.replace(jax_config(arch, smoke=True), dtype=jnp.float32)
    tcfg = dataclasses.replace(get_config(arch, smoke=True), dtype=torch.float32)
    jp = jax_init(jax.random.PRNGKey(1), jax_tf.lm_specs(jcfg), jcfg.dtype)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    return jcfg, jp, tcfg, tp


@pytest.fixture(scope="module")
def model():
    return _model("tinyllama-1.1b")


@pytest.fixture(scope="module")
def mla_model():
    """deepseek-v2-smoke: MLA attention (the cache is the latent
    ``{"c_kv","k_rope"}``) and MoE FFNs."""
    return _model("deepseek-v2-236b")


@pytest.fixture(scope="module")
def prompt(model):
    rng = np.random.default_rng(7)
    return rng.integers(0, model[0].vocab, size=3 * CHUNK).tolist()


@pytest.fixture(scope="module")
def reference(model, prompt):
    """Cold generation by the reference engine: no snapshot restored."""
    jcfg, jp, _, _ = model
    toks, st = JaxEngine(jcfg, jp, max_len=MAX_LEN, chunk=CHUNK).generate(prompt, NEW)
    assert st.chunks_skipped == 0
    return toks


def _jax_engine(model, backend, **kw):
    jcfg, jp, _, _ = model
    snaps = JaxFabric(backend, events_from=kw.pop("events_from", None))
    return JaxEngine(jcfg, jp, max_len=MAX_LEN, chunk=CHUNK, policy=JaxTSAR(),
                     snapshots=snaps, **kw)


def _port_engine(model, backend, **kw):
    _, _, tcfg, tp = model
    return mount_serve_engine(backend, tcfg, tp, policy=TSAR(), max_len=MAX_LEN,
                              chunk=CHUNK, device="cpu", **kw)


def test_port_cold_generation_matches_reference(model, prompt, reference):
    _, _, tcfg, tp = model
    toks, st = ServeEngine(tcfg, tp, max_len=MAX_LEN, chunk=CHUNK, device="cpu").generate(
        prompt, NEW)
    assert toks == reference and st.chunks_skipped == 0


def test_reference_snapshots_restore_in_the_port(model, prompt, reference, tmp_path):
    writer = _jax_engine(model, JaxFS(tmp_path))
    toks, st = writer.generate(prompt, NEW)
    assert toks == reference and st.stored_prefixes >= 1
    reader = _port_engine(model, LocalFSBackend(tmp_path))
    toks, st = reader.generate(prompt, NEW)
    assert st.chunks_skipped == st.n_chunks == 3  # every chunk restored, none prefilled
    assert toks == reference
    assert reader.snapshots.n_snapshots >= 1  # adopted from the reference's manifests


def test_port_snapshots_restore_in_the_reference(model, prompt, reference, tmp_path):
    writer = _port_engine(model, LocalFSBackend(tmp_path))
    toks, st = writer.generate(prompt, NEW)
    assert toks == reference and st.stored_prefixes >= 1
    reader = _jax_engine(model, JaxFS(tmp_path))
    toks, st = reader.generate(prompt, NEW)
    assert st.chunks_skipped == st.n_chunks == 3
    assert toks == reference


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_mla_latent_snapshots_cross_packages(mla_model, prompt, writer, tmp_path):
    """An MLA latent-cache snapshot saved by one package's engine restores in
    the other's: every chunk restored, the restored leaves are the latent
    cache, and generation equals the reference's cold generation."""
    jcfg, jp, _, _ = mla_model
    cold, st = JaxEngine(jcfg, jp, max_len=MAX_LEN, chunk=CHUNK).generate(prompt, NEW)
    assert st.chunks_skipped == 0
    engines = [lambda: _jax_engine(mla_model, JaxFS(tmp_path)),
               lambda: _port_engine(mla_model, LocalFSBackend(tmp_path))]
    first, second = engines if writer == "reference" else engines[::-1]
    toks, st = first().generate(prompt, NEW)
    assert toks == cold and st.stored_prefixes >= 1
    reader = second()
    toks, st = reader.generate(prompt, NEW)
    assert st.chunks_skipped == st.n_chunks == 3  # every chunk restored, none prefilled
    assert toks == cold
    key = next(iter(reader.policy.stored))
    assert sorted(reader.snapshots.load(key).cache) == ["c_kv", "k_rope"]


def test_both_packages_store_the_same_snapshot_keys(model, prompt, tmp_path):
    jax_eng = _jax_engine(model, JaxFS(tmp_path / "jax"))
    port_eng = _port_engine(model, LocalFSBackend(tmp_path / "port"))
    rng = np.random.default_rng(3)
    stream = [prompt + rng.integers(0, model[0].vocab, size=CHUNK).tolist() for _ in range(3)]
    for p in stream:
        _, js = jax_eng.generate(p, NEW)
        _, ts = port_eng.generate(p, NEW)
        assert (ts.chunks_skipped, ts.stored_prefixes) == (js.chunks_skipped, js.stored_prefixes)
    assert sorted(port_eng.snapshots._records) == sorted(jax_eng.snapshots._records)


def _served_pair(model, port):
    """A JAX engine and a torch engine, each with its own connection, flight
    and snapshot store, over one reference store server."""
    jrb = JaxRemote(f"127.0.0.1:{port}")
    jsnaps = JaxFabric(jrb, events_from=jrb)
    jflight = JaxFlight(jrb, stored_fn=jsnaps.contains, lease_timeout_s=30)
    jcfg, jp, _, _ = model
    jeng = JaxEngine(jcfg, jp, max_len=MAX_LEN, chunk=CHUNK, policy=JaxTSAR(),
                     snapshots=jsnaps, flight=jflight)
    trb = RemoteBackend(f"127.0.0.1:{port}")
    teng = _port_engine(model, trb, remote=trb)
    return jeng, teng, jrb, trb


def _shared_prefix_once(model, prompt, reference, server):
    jeng, teng, jrb, trb = _served_pair(model, server.port)
    barrier = threading.Barrier(2)
    results: dict = {}

    def run(name, eng):
        barrier.wait()
        results[name] = eng.generate(prompt, NEW)

    try:
        threads = [threading.Thread(target=run, args=("jax", jeng)),
                   threading.Thread(target=run, args=("port", teng))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        assert set(results) == {"jax", "port"}
        assert results["jax"][0] == reference and results["port"][0] == reference
        leads = {"jax": jeng.flight.remote_leads, "port": teng.flight.remote_leads}
        assert sum(leads.values()) == 1, leads
        leader = "jax" if leads["jax"] else "port"
        follower = "port" if leader == "jax" else "jax"
        st = {k: v[1] for k, v in results.items()}
        assert st[leader].chunks_skipped == 0 and st[leader].stored_prefixes >= 1
        assert st[follower].chunks_skipped == st[follower].n_chunks
        assert st[follower].stored_prefixes == 0
        saves = int(jeng.snapshots._m_saves.value + teng.snapshots._m_saves.value)
        assert saves == st[leader].stored_prefixes
    finally:
        jrb.close()
        trb.close()
        server.stop()


def test_mixed_engines_prefill_a_shared_prefix_exactly_once(model, prompt, reference):
    _shared_prefix_once(model, prompt, reference, StoreServer(JaxMemory()).start())


def test_mixed_engines_share_one_election_over_the_port_server(model, prompt, reference):
    """The same election over the port's own ``StoreServer``."""
    _shared_prefix_once(model, prompt, reference, PortStoreServer(MemoryBackend()).start())


def test_cache_tier_restores_token_equal_with_no_round_trip(model, prompt, reference):
    """Two engines over one port server, each behind a cache tier: the second
    restores the first's prefill token-equal, and its repeat restore reads
    every blob from its tier, no ``read_blob`` reaching the server."""
    server = PortStoreServer(MemoryBackend()).start()
    rbs = [RemoteBackend(server.url), RemoteBackend(server.url)]
    try:
        writer, reader = (_port_engine(model, rb, remote=rb, cache_bytes=64 << 20) for rb in rbs)
        toks, st = writer.generate(prompt, NEW)
        assert toks == reference and st.stored_prefixes >= 1
        cache = reader.snapshots.backend
        assert cache.inner is rbs[1] and cache.capacity_bytes == 64 << 20
        toks, st = reader.generate(prompt, NEW)
        assert toks == reference and st.chunks_skipped == st.n_chunks
        misses, reads = cache.misses, server.stats()["ops"].get("read_blob", 0)
        assert misses > 0 and cache.hits == 0  # the first restore crossed the wire
        toks, st = reader.generate(prompt, NEW)
        assert toks == reference and st.chunks_skipped == st.n_chunks
        assert cache.misses == misses and cache.hits > 0
        assert server.stats()["ops"].get("read_blob", 0) == reads
    finally:
        for rb in rbs:
            rb.close()
        server.stop()


def test_port_follower_reelects_when_the_reference_leader_dies(model, prompt, reference):
    server = StoreServer(JaxMemory()).start()
    jeng, teng, jrb, trb = _served_pair(model, server.port)
    started = threading.Event()

    def dying_prefill(*a, **kw):
        started.set()  # the lease is held: let the follower contend, then die
        time.sleep(0.1)
        raise RuntimeError("accelerator lost")

    jeng._prefill_prefix = dying_prefill
    outcome: dict = {}

    def run_jax():
        try:
            jeng.generate(prompt, NEW)
        except RuntimeError as e:
            outcome["error"] = e

    try:
        t = threading.Thread(target=run_jax)
        t.start()
        assert started.wait(30), "the doomed leader never took the lease"
        toks, st = teng.generate(prompt, NEW)
        t.join(60)
        assert isinstance(outcome.get("error"), RuntimeError)
        assert toks == reference
        assert st.chunks_skipped == 0 and st.stored_prefixes >= 1
        assert teng.flight.remote_leads == 1 and teng.flight.remote_waits >= 1
    finally:
        jrb.close()
        trb.close()
        server.stop()


def test_remote_eviction_event_prunes_the_port_engine(model, prompt):
    server = StoreServer(JaxMemory()).start()
    jeng, teng, jrb, trb = _served_pair(model, server.port)
    try:
        jeng.generate(prompt, 2)
        _, st = teng.generate(prompt, 2)  # adopts the reference's snapshots
        assert st.chunks_skipped == st.n_chunks
        keys = list(teng.snapshots._records)
        assert keys and all(k in teng.policy.stored for k in keys)
        for key in list(jeng.snapshots._records):
            jeng.snapshots.drop(key)
        deadline = time.monotonic() + 5
        while time.monotonic() < deadline:
            if all(teng.snapshots.record(k) is None for k in keys):
                break
            time.sleep(0.05)
        for key in keys:
            assert teng.snapshots.record(key) is None, "record phantom in the port"
            assert key not in teng.policy.stored, "policy phantom in the port"
    finally:
        jrb.close()
        trb.close()
        server.stop()


def test_eviction_converges_policy_and_ledger(model, prompt):
    backend = MemoryBackend()
    ledger = TenantLedger()
    eng = _port_engine(model, backend, ledger=ledger, tenant="tenant:a")
    eng.generate(prompt, 2)
    snaps = eng.snapshots
    assert isinstance(snaps, FabricSnapshotStore) and snaps.n_snapshots >= 1
    keys = list(snaps._records)
    assert ledger.bytes_stored("tenant:a") == snaps.snapshot_bytes()
    assert all(k in eng.policy.stored for k in keys)
    for key in keys:
        snaps.drop(key)
        assert snaps.record(key) is None
        assert key not in eng.policy.stored, "policy phantom"
        assert not backend.exists(key)
    assert ledger.bytes_stored("tenant:a") == 0, "ledger phantom"
    assert snaps.snapshot_bytes() == 0


def test_snapshot_budget_evicts_on_the_fabric(model, prompt):
    """A budget below one snapshot admits none; the engine still serves."""
    backend = MemoryBackend()
    eng = _port_engine(model, backend, snapshot_budget_bytes=1)
    toks, st = eng.generate(prompt, 2)
    assert st.stored_prefixes == 0 and eng.snapshots.n_snapshots == 0
    assert len(toks) == 2
