"""Deterministic KV-pytree codec: device cache -> host bytes -> any backend.

A serving engine's prefix KV snapshot is a pytree of device arrays (per-layer
key/value blocks, or MLA's compressed ``c_kv``/``k_rope``).  This module turns
that pytree into a first-class *artifact* — the same "namespace key holding
named blobs" shape :class:`~repro.core.store.IntermediateStore` uses — so a
snapshot can live on any :class:`~repro.core.backends.StorageBackend` and be
reused across serving processes.

Design constraints, in order:

* **Deterministic.**  Two processes snapshotting the same cache produce
  byte-identical blobs and manifests: dict keys are walked sorted, leaf bytes
  are the raw C-contiguous little-endian buffer, and the manifest is
  canonical JSON (sorted keys, no whitespace).  Determinism is what makes
  cross-process reuse content-addressable rather than trust-based.
* **Exact.**  The round trip is bit-exact — a loaded snapshot must produce
  logits identical to a fresh prefill (tested in ``tests/test_serve_fabric``).
  Per-leaf SHA-256 of the *raw* bytes rides in the manifest so corruption is
  detectable regardless of which compression codec wrapped the payload.
* **Stream once.**  Leaf payloads are handed to ``write_blob`` as a
  ``memoryview`` over the host array — the only materialization.  A
  ``RemoteBackend`` slices that view into wire-v2 chunk frames, so a
  multi-GB snapshot crosses the wire without a second in-memory copy.
* **Registry-pluggable compression.**  The per-leaf payload codec is any
  codec from :mod:`repro.core.codecs` (``resolve_codec``); the manifest
  records which one so readers need no out-of-band configuration.  The
  default is ``"none"``: KV activations are high-entropy floats and the
  zero-copy raw path is the point.

Blob layout of one snapshot artifact ``key``::

    manifest.json        canonical JSON: leaf table + length + provenance
    kv0.bin[.zst]        leaf 0 payload (raw or codec-compressed)
    kv1.bin[.zst]        ...

``manifest.json`` is written **last**, so a torn writer never publishes a
readable-but-partial snapshot (``StorageBackend.exists`` keys off the
manifest blob, same as workflow artifacts).

The port's copy differs at its tensor seam only: a leaf may be a tensor
(moved to the host with ``.detach().cpu()``), and a bf16 leaf is written as
the bytes of a 16-bit view under the dtype name ``"bfloat16"``, the name the
reference records; ``load_kv`` returns tensors, bf16 leaves decoded through
that 16-bit view (no ``ml_dtypes``).  Blobs and manifests are the
reference's byte for byte.
"""
from __future__ import annotations

import hashlib
import json
import time
from dataclasses import dataclass, field
from typing import Any, Iterator, Mapping

import numpy as np
import torch

from .backends import StorageBackend
from .codecs import resolve_codec

__all__ = ["KV_FORMAT", "KVSnapshotInfo", "load_kv", "read_kv_info", "save_kv"]

#: manifest blob name — deliberately the same name the workflow store uses,
#: because every backend's ``exists``/``exists_many`` treats a committed
#: ``manifest.json`` as *the* presence marker for an artifact key
MANIFEST = "manifest.json"
KV_FORMAT = 1


def _flatten(tree: Any, path: tuple = ()) -> Iterator[tuple[tuple, Any]]:
    """Deterministic (path, leaf) walk over dict/list/tuple pytrees.

    Dict keys are visited sorted and must be strings (they travel as JSON);
    anything that is not a container is a leaf.
    """
    if isinstance(tree, Mapping):
        for k in sorted(tree):
            if not isinstance(k, str):
                raise TypeError(f"KV pytree dict keys must be str, got {k!r}")
            yield from _flatten(tree[k], path + (["d", k],))
    elif isinstance(tree, (list, tuple)):
        tag = "l" if isinstance(tree, list) else "t"
        for i, v in enumerate(tree):
            yield from _flatten(v, path + ([tag, i],))
    else:
        yield path, tree


def _unflatten(items: list[tuple[list, Any]]) -> Any:
    """Rebuild the pytree from ``_flatten``'s (path, leaf) pairs.

    Every path step carries its container tag, so the original container
    kinds (dict vs list vs tuple) are restored exactly.
    """
    if not items:
        raise ValueError("empty KV snapshot")

    def build(group: list[tuple[list, Any]], depth: int) -> Any:
        first_path = group[0][0]
        if len(first_path) == depth:
            if len(group) != 1:
                raise ValueError("KV manifest paths collide")
            return group[0][1]
        tag = first_path[depth][0]
        children: dict[Any, list[tuple[list, Any]]] = {}
        for path, leaf in group:
            children.setdefault(path[depth][1], []).append((path, leaf))
        if tag == "d":
            return {k: build(v, depth + 1) for k, v in sorted(children.items())}
        seq = [build(children[i], depth + 1) for i in sorted(children)]
        return tuple(seq) if tag == "t" else seq

    return build(items, 0)


def _resolve_dtype(name: str) -> np.dtype:
    # numpy has no bfloat16 without ml_dtypes: its bytes travel as int16
    return np.dtype(np.int16) if name == "bfloat16" else np.dtype(name)


def _host(leaf: Any) -> tuple[np.ndarray, str]:
    """A leaf on the host as a numpy array, and its dtype's manifest name."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), "bfloat16"
        host = t.numpy()
    else:
        host = np.asarray(leaf)
    return host, str(host.dtype)


def _tensor(arr: np.ndarray, name: str) -> torch.Tensor:
    # a decompressed leaf lies in read-only bytes, which torch will not wrap
    t = torch.from_numpy(arr if arr.flags.writeable else arr.copy())
    return t.view(torch.bfloat16) if name == "bfloat16" else t


def _raw_view(host: np.ndarray) -> memoryview:
    """Flat little-endian byte view of a host array — zero copy."""
    if host.dtype.byteorder == ">":  # pragma: no cover - no BE producers here
        host = host.astype(host.dtype.newbyteorder("<"))
    flat = np.ascontiguousarray(host).reshape(-1)
    return memoryview(flat.view(np.uint8))


@dataclass(frozen=True)
class KVSnapshotInfo:
    """Manifest-level description of one stored KV snapshot."""

    key: str
    length: int  # valid cache positions (the prefix length in tokens)
    n_leaves: int
    nbytes_raw: int
    nbytes_disk: int
    codec: str
    prefill_s: float  # measured seconds to recompute this prefix from scratch
    created_at: float
    meta: Mapping[str, Any] = field(default_factory=dict)


def save_kv(
    backend: StorageBackend,
    key: str,
    cache: Any,
    length: int,
    *,
    codec: str | None = "none",
    level: int | None = None,
    prefill_s: float = 0.0,
    meta: Mapping[str, Any] | None = None,
) -> KVSnapshotInfo:
    """Encode ``cache`` (pytree of device/host arrays) as artifact ``key``.

    Each leaf is moved device->host once (``np.asarray``) and handed to the
    backend as a memoryview over that buffer; the manifest commits last.
    Returns the :class:`KVSnapshotInfo` the manifest records.
    """
    c = resolve_codec(codec, level)
    entries: list[dict[str, Any]] = []
    nbytes_raw = 0
    nbytes_disk = 0
    for i, (path, leaf) in enumerate(_flatten(cache)):
        host, dtype_name = _host(leaf)  # device -> host (no-op for numpy leaves)
        mv = _raw_view(host)
        name = f"kv{i}.bin{c.suffix}"
        if c.name == "none":
            disk = backend.write_blob(key, name, mv)
        else:
            disk = backend.write_blob(key, name, c.compress(bytes(mv)))
        nbytes_raw += mv.nbytes
        nbytes_disk += disk
        entries.append(
            {
                "path": [list(p) for p in path],
                "name": name,
                "dtype": dtype_name,
                "shape": list(host.shape),
                "nbytes": mv.nbytes,
                "sha256": hashlib.sha256(mv).hexdigest(),
            }
        )
    created_at = time.time()
    doc = {
        "kind": "kv",
        "format": KV_FORMAT,
        "codec": c.name,
        "length": int(length),
        "prefill_s": float(prefill_s),
        "created_at": created_at,
        "leaves": entries,
        "meta": dict(meta or {}),
    }
    manifest = json.dumps(doc, sort_keys=True, separators=(",", ":")).encode()
    nbytes_disk += backend.write_blob(key, MANIFEST, manifest)
    return KVSnapshotInfo(
        key=key,
        length=int(length),
        n_leaves=len(entries),
        nbytes_raw=nbytes_raw,
        nbytes_disk=nbytes_disk,
        codec=c.name,
        prefill_s=float(prefill_s),
        created_at=created_at,
        meta=dict(meta or {}),
    )


def _read_manifest(backend: StorageBackend, key: str) -> dict[str, Any]:
    doc = json.loads(bytes(backend.read_blob(key, MANIFEST)))
    if doc.get("kind") != "kv":
        raise ValueError(f"artifact {key!r} is not a KV snapshot")
    if int(doc.get("format", 0)) > KV_FORMAT:
        raise ValueError(
            f"KV snapshot {key!r} has format {doc.get('format')}, "
            f"newer than this reader ({KV_FORMAT})"
        )
    return doc


def read_kv_info(backend: StorageBackend, key: str) -> KVSnapshotInfo:
    """Manifest-only read: size/cost/length without touching leaf payloads.

    Raises ``KeyError``/``FileNotFoundError`` when the snapshot is absent —
    same contract as ``read_blob``.
    """
    doc = _read_manifest(backend, key)
    leaves = doc.get("leaves", [])
    return KVSnapshotInfo(
        key=key,
        length=int(doc.get("length", 0)),
        n_leaves=len(leaves),
        nbytes_raw=sum(int(e["nbytes"]) for e in leaves),
        nbytes_disk=0,
        codec=str(doc.get("codec", "none")),
        prefill_s=float(doc.get("prefill_s", 0.0) or 0.0),
        created_at=float(doc.get("created_at", 0.0) or 0.0),
        meta=doc.get("meta", {}),
    )


def load_kv(
    backend: StorageBackend,
    key: str,
    *,
    verify: bool = False,
) -> tuple[Any, int, KVSnapshotInfo]:
    """Decode artifact ``key`` back into ``(host pytree, length, info)``,
    its leaves CPU tensors.

    Raw (codec ``"none"``) leaves stream through ``open_blob_reader`` into a
    preallocated array — constant extra memory on file-backed backends.
    ``verify=True`` re-hashes every leaf against the manifest (transport
    integrity is already covered by the wire protocol's digests; this guards
    bytes at rest).
    """
    doc = _read_manifest(backend, key)
    c = resolve_codec(str(doc.get("codec", "none")))
    items: list[tuple[list, Any]] = []
    nbytes_disk = 0
    for entry in doc.get("leaves", []):
        dtype = _resolve_dtype(entry["dtype"])
        shape = tuple(int(s) for s in entry["shape"])
        want = int(entry["nbytes"])
        if c.name == "none":
            out = np.empty(want, np.uint8)
            view = memoryview(out)
            with backend.open_blob_reader(key, entry["name"]) as reader:
                nbytes_disk += reader.size
                got = 0
                while got < want:
                    n = reader.readinto(view[got:])
                    if n <= 0:
                        raise ValueError(
                            f"KV leaf {key}/{entry['name']}: short read "
                            f"({got}/{want} bytes)"
                        )
                    got += n
            raw: Any = out
        else:
            payload = backend.read_blob(key, entry["name"])
            nbytes_disk += len(payload)
            raw = np.frombuffer(c.decompress(payload), np.uint8)
            if raw.nbytes != want:
                raise ValueError(
                    f"KV leaf {key}/{entry['name']}: decompressed to "
                    f"{raw.nbytes} bytes, manifest says {want}"
                )
        if verify and hashlib.sha256(raw).hexdigest() != entry["sha256"]:
            raise ValueError(f"KV leaf {key}/{entry['name']} failed digest check")
        arr = _tensor(raw.view(dtype).reshape(shape), entry["dtype"])
        items.append(([tuple(p) for p in entry["path"]], arr))
    info = KVSnapshotInfo(
        key=key,
        length=int(doc.get("length", 0)),
        n_leaves=len(items),
        nbytes_raw=sum(a.numel() * a.element_size() for _, a in items),
        nbytes_disk=nbytes_disk,
        codec=c.name,
        prefill_s=float(doc.get("prefill_s", 0.0) or 0.0),
        created_at=float(doc.get("created_at", 0.0) or 0.0),
        meta=doc.get("meta", {}),
    )
    return _unflatten([(list(map(tuple, p)), a) for p, a in items]), info.length, info
