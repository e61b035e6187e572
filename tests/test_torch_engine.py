"""The port's ServeEngine against the reference's, on the CPU.

Same converted parameters, same fp32 smoke stream: tokens must agree token
for token, and RISP must skip and store the same chunks."""
import dataclasses
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax
import jax.numpy as jnp

from repro.configs import get_config as jax_config
from repro.models import transformer as jax_tf
from repro.models.layers import init_params as jax_init
from repro.serve import ServeEngine as JaxEngine
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.launch import serve as serve_cli
from repro_torch.sched.singleflight import SingleFlight
from repro_torch.serve import ServeEngine

CHUNK, MAX_LEN, MAX_NEW = 16, 128, 6


def _models(arch):
    jcfg = dataclasses.replace(jax_config(arch, smoke=True), dtype=jnp.float32)
    tcfg = dataclasses.replace(get_config(arch, smoke=True), dtype=torch.float32)
    jp = jax_init(jax.random.PRNGKey(0), jax_tf.lm_specs(jcfg), jcfg.dtype)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    return jcfg, jp, tcfg, tp


def _stream(vocab):
    """Six requests sharing a 3-chunk system prompt, then the system prompt
    alone twice: it is the stored prefix, so every chunk is restored and the
    engine takes the full-hit path (re-running the last chunk)."""
    rng = np.random.default_rng(0)
    system = rng.integers(0, vocab, size=3 * CHUNK).tolist()
    prompts = [system + rng.integers(0, vocab, size=CHUNK).tolist() for _ in range(6)]
    return prompts + [system, system]


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "gemma3-4b"])
def test_generate_matches_reference_engine(arch):
    jcfg, jp, tcfg, tp = _models(arch)
    ref = JaxEngine(jcfg, jp, max_len=MAX_LEN, chunk=CHUNK)
    port = ServeEngine(tcfg, tp, max_len=MAX_LEN, chunk=CHUNK, device="cpu")
    full_hits = 0
    for prompt in _stream(jcfg.vocab):
        want, ws = ref.generate(prompt, max_new_tokens=MAX_NEW)
        got, gs = port.generate(prompt, max_new_tokens=MAX_NEW)
        assert got == want
        assert gs.chunks_skipped == ws.chunks_skipped
        assert gs.stored_prefixes == ws.stored_prefixes
        assert gs.n_chunks == ws.n_chunks
        full_hits += gs.chunks_skipped == gs.n_chunks
    assert full_hits == 2  # the last two requests took the _trim_last_chunk path
    assert port.n_snapshots == ref.n_snapshots
    assert port.aggregate_stats().units_skipped == ref.aggregate_stats().units_skipped


def _tail_is_zero(snap):
    return all(not bool(a[:, :, snap.length:].any()) for a in snap.cache.values())


def test_stored_snapshot_holds_no_kv_past_its_length():
    """The model writes the cache in place: a snapshot saved from a boundary
    that the prefill went past must not carry the later chunks."""
    _, _, tcfg, tp = _models("tinyllama-1.1b")
    eng = ServeEngine(tcfg, tp, max_len=MAX_LEN, chunk=CHUNK, device="cpu")
    stored = 0
    for prompt in _stream(tcfg.vocab):
        _, st = eng.generate(prompt, max_new_tokens=MAX_NEW)
        stored += st.stored_prefixes
        for key in list(eng.snapshots._snaps):
            snap = eng.snapshots.load(key)
            assert snap.length == 3 * CHUNK
            # saved at depth 3 of 4 chunks, before the 4th chunk and decode
            assert _tail_is_zero(snap), key
            assert all(a[:, :, : snap.length].any() for a in snap.cache.values())
    assert stored >= 1


def test_restored_cache_is_a_copy():
    """Requests that restore a snapshot extend a copy of it: the stored
    host tensors stay as saved across the whole stream."""
    _, _, tcfg, tp = _models("tinyllama-1.1b")
    eng = ServeEngine(tcfg, tp, max_len=MAX_LEN, chunk=CHUNK, device="cpu")
    stream = _stream(tcfg.vocab)
    eng.generate(stream[0], MAX_NEW)
    eng.generate(stream[1], MAX_NEW)
    (key,) = eng.snapshots._snaps
    saved = {k: a.clone() for k, a in eng.snapshots.load(key).cache.items()}
    for prompt in stream[2:]:
        eng.generate(prompt, MAX_NEW)
    after = eng.snapshots.load(key).cache
    assert all(torch.equal(saved[k], after[k]) for k in saved)


def test_single_flight_path_matches_plain_path():
    _, _, tcfg, tp = _models("tinyllama-1.1b")
    plain = ServeEngine(tcfg, tp, max_len=MAX_LEN, chunk=CHUNK, device="cpu")
    flown = ServeEngine(
        tcfg, tp, max_len=MAX_LEN, chunk=CHUNK, device="cpu", flight=SingleFlight()
    )
    for prompt in _stream(tcfg.vocab):
        a, sa = plain.generate(prompt, MAX_NEW)
        b, sb = flown.generate(prompt, MAX_NEW)
        assert a == b and sa.chunks_skipped == sb.chunks_skipped


def test_request_past_max_len_is_refused_before_any_work():
    _, _, tcfg, tp = _models("tinyllama-1.1b")
    eng = ServeEngine(tcfg, tp, max_len=64, chunk=CHUNK, device="cpu")
    with pytest.raises(ValueError, match="max_len"):
        eng.generate(list(range(60)), max_new_tokens=1)  # 64 padded + 1
    assert eng.policy.n_pipelines == 0
    out, _ = eng.generate(list(range(48)), max_new_tokens=16)  # fills it exactly
    assert len(out) == 16


def test_cuda_engine_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, _, tcfg, tp = _models("tinyllama-1.1b")
    with pytest.raises(RuntimeError, match="CUDA"):
        ServeEngine(tcfg, tp)  # device defaults to cuda


def test_cli_serves_on_the_cpu(monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", [
        "serve", "--device", "cpu", "--smoke", "--requests", "3", "--max-new", "2",
        "--max-len", "96", "--chunk", "16", "--system-len", "36",
    ])
    serve_cli.main()
    out = capsys.readouterr().out
    assert "req 2: skipped" in out and "snapshots" in out
