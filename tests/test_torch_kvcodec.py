"""The port's KV codec against the reference's, on the CPU.

A snapshot encoded by either package decodes in the other bit for bit, bf16
included (the port reads bf16 through a 16-bit view, the reference through
``ml_dtypes``), and both write the same leaf blobs and the same manifest but
for its clock reading."""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.core import LocalFSBackend as JaxFS
from repro.core import MemoryBackend as JaxMemory
from repro.core import kvcodec as jax_kv
from repro_torch.core import LocalFSBackend, MemoryBackend
from repro_torch.core import kvcodec as port_kv

DTYPES = ["float32", "bfloat16"]
CODECS = ["none", "zlib"]


def _cache(seed: int = 0) -> dict:
    """A stacked ``{"k","v": [L,B,T,Hkv,dh]}`` cache as numpy float32."""
    rng = np.random.default_rng(seed)
    return {n: rng.standard_normal((2, 1, 16, 2, 8), dtype=np.float32) for n in ("k", "v")}


def _jax_tree(cache: dict, dtype: str) -> dict:
    return {k: jnp.asarray(a).astype(dtype) for k, a in cache.items()}


def _port_tree(cache: dict, dtype: str) -> dict:
    return {k: torch.from_numpy(a).to(getattr(torch, dtype)) for k, a in cache.items()}


def _bits(t) -> np.ndarray:
    """The raw bits of a leaf of either package, as unsigned integers."""
    if isinstance(t, torch.Tensor):
        t = t.contiguous()
        width = {2: torch.int16, 4: torch.int32}[t.element_size()]
        return t.view(width).numpy().view(np.uint16 if t.element_size() == 2 else np.uint32)
    a = np.asarray(t)
    return a.view(np.uint16 if a.dtype.itemsize == 2 else np.uint32)


def _manifest(backend, key: str) -> dict:
    doc = json.loads(bytes(backend.read_blob(key, "manifest.json")))
    doc.pop("created_at")
    return doc


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_reference_snapshot_decodes_in_the_port_bit_for_bit(tmp_path, dtype, codec):
    cache = _cache()
    jtree = _jax_tree(cache, dtype)
    jax_kv.save_kv(JaxFS(tmp_path), "kv/a", jtree, 11, codec=codec, prefill_s=0.25)
    tree, length, info = port_kv.load_kv(LocalFSBackend(tmp_path), "kv/a", verify=True)
    assert length == 11 and info.prefill_s == 0.25 and info.codec == codec
    assert sorted(tree) == ["k", "v"]
    for name in ("k", "v"):
        assert tree[name].dtype == getattr(torch, dtype)
        assert tuple(tree[name].shape) == cache[name].shape
        np.testing.assert_array_equal(_bits(tree[name]), _bits(jtree[name]))
    assert info.nbytes_raw == sum(np.asarray(a).nbytes for a in jtree.values())


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_port_snapshot_decodes_in_the_reference_bit_for_bit(tmp_path, dtype, codec):
    cache = _cache(seed=1)
    ptree = _port_tree(cache, dtype)
    port_kv.save_kv(LocalFSBackend(tmp_path), "kv/b", ptree, 7, codec=codec, prefill_s=1.5)
    tree, length, info = jax_kv.load_kv(JaxFS(tmp_path), "kv/b", verify=True)
    assert length == 7 and info.prefill_s == 1.5
    for name in ("k", "v"):
        assert str(tree[name].dtype) == dtype
        np.testing.assert_array_equal(_bits(tree[name]), _bits(ptree[name]))


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_both_packages_write_the_same_blobs_and_manifest(dtype, codec):
    cache = _cache(seed=2)
    jb, pb = JaxMemory(), MemoryBackend()
    jinfo = jax_kv.save_kv(jb, "kv/c", _jax_tree(cache, dtype), 16, codec=codec)
    pinfo = port_kv.save_kv(pb, "kv/c", _port_tree(cache, dtype), 16, codec=codec)
    # nbytes_disk counts the manifest, whose clock reading may differ in length
    assert (jinfo.n_leaves, jinfo.nbytes_raw) == (pinfo.n_leaves, pinfo.nbytes_raw)
    assert _manifest(jb, "kv/c") == _manifest(pb, "kv/c")
    for entry in _manifest(pb, "kv/c")["leaves"]:
        assert bytes(jb.read_blob("kv/c", entry["name"])) == bytes(
            pb.read_blob("kv/c", entry["name"]))
    assert port_kv.read_kv_info(pb, "kv/c").n_leaves == 2


def test_container_kinds_round_trip_in_the_port():
    """Dicts, lists and tuples come back as they went in, leaves as tensors."""
    rng = np.random.default_rng(3)
    tree = {"layers": [{"k": torch.from_numpy(rng.standard_normal((2, 3), dtype=np.float32))},
                       (torch.arange(4, dtype=torch.int32), torch.ones(2, dtype=torch.bfloat16))]}
    backend = MemoryBackend()
    port_kv.save_kv(backend, "kv/d", tree, 3)
    got, length, _ = port_kv.load_kv(backend, "kv/d", verify=True)
    assert length == 3
    assert isinstance(got["layers"], list) and isinstance(got["layers"][1], tuple)
    torch.testing.assert_close(got["layers"][0]["k"], tree["layers"][0]["k"], rtol=0, atol=0)
    assert torch.equal(got["layers"][1][0], tree["layers"][1][0])
    assert got["layers"][1][1].dtype == torch.bfloat16
    assert torch.equal(got["layers"][1][1], tree["layers"][1][1])
