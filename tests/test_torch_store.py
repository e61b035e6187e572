"""The port's ``IntermediateStore`` and ``CheckpointManager`` on the CPU: a
put/get round trip of fp32, bf16 and int32 tensors, bit for bit, with
``manifest.json`` laid out as the reference package writes it; the bf16
round trip where ``ml_dtypes`` cannot be imported (the machine with the card
has none); and checkpoint save/restore/``keep``, sync and async."""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.core.store import IntermediateStore as JaxStore
from repro_torch.ckpt import CheckpointManager
from repro_torch.core.store import IntermediateStore

ROOT = Path(__file__).resolve().parents[1]


def _value():
    g = torch.Generator().manual_seed(0)
    return {
        "params": {
            "w": torch.randn(3, 5, generator=g),
            "b16": torch.randn(4, 2, generator=g).to(torch.bfloat16),
        },
        "opt": {"step": torch.tensor(7, dtype=torch.int32),
                "ids": torch.arange(6, dtype=torch.int32).reshape(2, 3)},
        "pair": (torch.ones(2), [torch.zeros(1, dtype=torch.int32)]),
    }


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_clone(v) for v in tree)
    return tree.clone()


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _assert_bitwise_equal(a, b):
    assert type(a) is type(b)
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _assert_bitwise_equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_bitwise_equal(x, y)
    else:
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a.view(torch.uint8) if a.dtype == torch.bfloat16 else a,
                           b.view(torch.uint8) if b.dtype == torch.bfloat16 else b)


def test_put_get_round_trip_is_bit_exact(tmp_path):
    store = IntermediateStore(tmp_path / "s")
    value = _value()
    res = store.put("k1", value)
    assert res.nbytes_raw == sum(t.numel() * t.element_size() for t in _leaves(value))
    _assert_bitwise_equal(store.get("k1", device="cpu"), value)
    # a second store over the same directory reads it back too
    _assert_bitwise_equal(IntermediateStore(tmp_path / "s").get("k1", device="cpu"), value)


def test_manifest_fields_match_the_reference(tmp_path):
    """The same values through both stores: manifests agree field for field
    (key, codec, and per leaf index/kind/shape/dtype/file), leaves in the
    reference's order (sorted dict keys)."""
    value = {"b": np.arange(6, dtype=np.int32).reshape(2, 3),
             "a": {"w": np.linspace(0, 1, 10, dtype=np.float32),
                   "h": np.ones((2, 2), np.float32)}}
    tvalue = {"b": torch.from_numpy(value["b"]),
              "a": {k: torch.from_numpy(v) for k, v in value["a"].items()},
              "c": torch.arange(4, dtype=torch.float32).to(torch.bfloat16)}
    jvalue = {"b": jnp.asarray(value["b"]),
              "a": {k: jnp.asarray(v) for k, v in value["a"].items()},
              "c": jnp.arange(4, dtype=jnp.float32).astype(jnp.bfloat16)}
    JaxStore(tmp_path / "j", codec="zlib").put("key", jvalue)
    IntermediateStore(tmp_path / "t", codec="zlib").put("key", tvalue)

    def manifest(root):
        found = list(Path(root).rglob("manifest.json"))
        assert len(found) == 1
        return json.loads(found[0].read_text()), found[0].parent

    mj, dj = manifest(tmp_path / "j")
    mt, dt = manifest(tmp_path / "t")
    assert mt == mj
    assert [e["dtype"] for e in mt["leaves"]] == ["float32", "float32", "int32", "bfloat16"]
    for e in mt["leaves"]:  # and the blobs hold the same bytes
        assert (dt / e["file"]).read_bytes() == (dj / e["file"]).read_bytes()


BLOCKED = r"""
import sys
sys.modules["ml_dtypes"] = None  # importing it now raises ImportError
import numpy as np, torch
try:
    np.dtype("bfloat16")
    raise SystemExit("numpy knows bfloat16: ml_dtypes was not blocked")
except TypeError:
    pass
from repro_torch.core.store import IntermediateStore
x = torch.randn(5, 3, generator=torch.Generator().manual_seed(1)).to(torch.bfloat16)
s = IntermediateStore(ROOT_DIR)
s.put("k", {"x": x, "n": torch.tensor(3, dtype=torch.int32)})
y = IntermediateStore(ROOT_DIR).get("k", device="cpu")
assert y["x"].dtype == torch.bfloat16
assert torch.equal(y["x"].view(torch.int16), x.view(torch.int16))
assert "ml_dtypes" not in {m for m in sys.modules if sys.modules[m] is not None}
print("BF16_OK")
"""


def test_bf16_round_trip_without_ml_dtypes(tmp_path):
    code = f"ROOT_DIR = {str(tmp_path / 's')!r}\n" + BLOCKED
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "BF16_OK" in out.stdout


def test_get_refuses_cuda_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    store = IntermediateStore(tmp_path / "s")
    store.put("k", {"x": torch.ones(2)})
    with pytest.raises(RuntimeError, match="CUDA"):
        store.get("k")


@pytest.mark.parametrize("async_save", [False, True])
def test_checkpoint_save_restore_keep(tmp_path, async_save):
    mgr = CheckpointManager(tmp_path / "ck", keep=2, async_save=async_save, device="cpu")
    states = {}
    for step in (1, 2, 3):
        state = _value()
        state["params"]["w"] += step
        states[step] = _clone(state)
        mgr.save(step, state)
        # an in-place update right after an async save must not reach the checkpoint
        state["params"]["w"].add_(100.0)
    assert mgr.latest_step() == 3
    assert [c["step"] for c in mgr.checkpoints] == [2, 3]  # keep=2 deleted step 1
    step, restored = mgr.restore()
    assert step == 3
    _assert_bitwise_equal(restored, states[3])
    step, restored = mgr.restore(2)
    _assert_bitwise_equal(restored, states[2])
    with pytest.raises(KeyError):
        mgr.restore(1)
    # a new manager over the same directory sees the same checkpoints
    again = CheckpointManager(tmp_path / "ck", keep=2, device="cpu")
    assert again.latest_step() == 3


def test_async_save_snapshots_before_returning(tmp_path):
    mgr = CheckpointManager(tmp_path / "ck", async_save=True, device="cpu")
    state = {"w": torch.zeros(1000)}
    mgr.save(1, state)
    state["w"].add_(1.0)  # the optimizer's in-place update of the next step
    _, restored = mgr.restore(1)
    assert torch.equal(restored["w"], torch.zeros(1000))
