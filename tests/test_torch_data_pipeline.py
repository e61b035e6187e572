"""The port's LM data pipeline against the reference's, on the CPU.

The same corpus goes through tokenize -> pack -> split on both packages'
executors over fresh stores: every stored artifact has the same key and the
same leaf blobs, byte for byte, and the skip decisions agree."""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import IntermediateStore as JaxStore
from repro.core import TSAR as JaxTSAR
from repro.core import WorkflowExecutor as JaxExecutor
from repro.data.pipeline import make_corpus_blob as jax_blob
from repro.data.pipeline import register_data_modules as jax_register
from repro_torch.core import TSAR, IntermediateStore, WorkflowExecutor
from repro_torch.data.pipeline import (
    byte_tokenize,
    make_corpus_blob,
    pack_sequences,
    register_data_modules,
    train_split,
)

VOCAB = 1000


def leaf_blobs(store) -> dict:
    """key -> [(dtype, shape, leaf blob bytes)] over every stored artifact."""
    out = {}
    for key in sorted(store.records):
        man = json.loads(bytes(store.backend.read_blob(key, "manifest.json")))
        out[key] = [(e["dtype"], e["shape"], bytes(store.backend.read_blob(key, e["file"])))
                    for e in man["leaves"]]
    return out


def _executors(tmp_path):
    jex = JaxExecutor(store=JaxStore(tmp_path / "jax"), policy=JaxTSAR(with_state=True))
    tex = WorkflowExecutor(store=IntermediateStore(tmp_path / "port"),
                           policy=TSAR(with_state=True), device="cpu")
    jax_register(jex, vocab=VOCAB)
    register_data_modules(tex, vocab=VOCAB)
    return jex, tex


@pytest.mark.parametrize("n_bytes,seed", [(1 << 16, 0), (12_345, 3)])
def test_corpus_blob_matches_reference(n_bytes, seed):
    want = np.asarray(jax_blob(n_bytes, seed))
    got = make_corpus_blob(n_bytes, seed, device="cpu")
    assert got.dtype == torch.int32 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("vocab", [1000, 32000])
def test_stage_functions_match_reference(vocab):
    from repro.data import pipeline as jp

    blob = jax_blob(4097, 1)
    ids = byte_tokenize(make_corpus_blob(4097, 1, device="cpu"), vocab)
    want = np.asarray(jp.byte_tokenize(blob, vocab))
    assert ids.dtype == torch.int32
    np.testing.assert_array_equal(ids.numpy(), want)
    packed = pack_sequences(ids, 31)
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jp.pack_sequences(want, 31)))
    got, ref = train_split(packed, 5), jp.train_split(np.asarray(jp.pack_sequences(want, 31)), 5)
    for part in ("train", "eval"):
        np.testing.assert_array_equal(got[part].numpy(), np.asarray(ref[part]))


@pytest.mark.parametrize("seq_len,holdout", [(64, 8), (32, 3)])
def test_pipeline_artifacts_equal_reference_byte_for_byte(tmp_path, seq_len, holdout):
    jex, tex = _executors(tmp_path)
    steps = ["tokenize", ("pack", {"seq_len": seq_len}), ("split", {"holdout": holdout})]
    jr = jex.run("corpus-v1", jax_blob(1 << 16), steps, "prep1")
    tr = tex.run("corpus-v1", make_corpus_blob(1 << 16, device="cpu"), steps, "prep1")
    assert tr.n_skipped == jr.n_skipped == 0
    assert tr.stored_keys == jr.stored_keys and len(tr.stored_keys) == 3
    assert leaf_blobs(tex.store) == leaf_blobs(jex.store)
    for part in ("train", "eval"):
        np.testing.assert_array_equal(tr.output[part].numpy(), np.asarray(jr.output[part]))
    # a second job over the same corpus reuses everything, in both packages
    jr2 = jex.run("corpus-v1", jax_blob(1 << 16), steps, "prep2")
    tr2 = tex.run("corpus-v1", make_corpus_blob(1 << 16, device="cpu"), steps, "prep2")
    assert tr2.n_skipped == jr2.n_skipped == 3
    np.testing.assert_array_equal(tr2.output["train"].numpy(), np.asarray(jr2.output["train"]))


def test_pipeline_state_sensitivity_matches_reference(tmp_path):
    jex, tex = _executors(tmp_path)
    runs = [(["tokenize", ("pack", {"seq_len": 64})], "a"),
            (["tokenize", ("pack", {"seq_len": 32})], "b")]
    for steps, wid in runs:
        jr = jex.run("corpus-v1", jax_blob(1 << 16), steps, wid)
        tr = tex.run("corpus-v1", make_corpus_blob(1 << 16, device="cpu"), steps, wid)
        assert tr.n_skipped == jr.n_skipped
        assert tr.stored_keys == jr.stored_keys
    assert tr.n_skipped == 1 and tuple(tr.output.shape) == (992, 33)  # 32,768 ids // 33
    np.testing.assert_array_equal(tr.output.numpy(), np.asarray(jr.output))
    assert leaf_blobs(tex.store) == leaf_blobs(jex.store)
