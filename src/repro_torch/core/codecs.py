"""Compression-codec registry for intermediate-data blobs.

The seed store hard-required ``zstandard``; on a bare environment that broke
import of the whole ``repro.core`` package.  Codecs are now pluggable:

  * ``zstd`` — best ratio/speed; registered only if ``zstandard`` imports.
  * ``zlib`` — stdlib fallback, always available.
  * ``none`` — identity; for ``MemoryBackend`` hot tiers where the bytes are
    re-read constantly and compression would only burn CPU.

``resolve_codec(None)`` picks the best available (zstd > zlib), so existing
callers keep their compression without naming a codec.  The codec *name* is
recorded in each artifact manifest, so a store written with zstd refuses
cleanly (rather than corrupting) when read on a host without zstandard.
"""
from __future__ import annotations

import zlib
from dataclasses import dataclass
from typing import Callable


@dataclass(frozen=True)
class Codec:
    """A named pair of bytes->bytes transforms plus the blob-file suffix."""

    name: str
    compress: Callable[[bytes], bytes]
    decompress: Callable[[bytes], bytes]
    suffix: str  # appended to blob file names, e.g. ".zst"


_REGISTRY: dict[str, Codec] = {}


def register_codec(codec: Codec) -> None:
    _REGISTRY[codec.name] = codec


def available_codecs() -> tuple[str, ...]:
    return tuple(_REGISTRY)


def resolve_codec(spec: str | Codec | None, level: int | None = None) -> Codec:
    """Resolve a codec name (or None => best available) to a Codec.

    ``level`` selects the compression level for codecs that support one
    (zstd/zlib); ``None`` keeps the registry default.
    """
    if isinstance(spec, Codec):
        return spec
    if spec is None:
        for name in ("zstd", "zlib"):
            if name in _REGISTRY:
                spec = name
                break
        else:  # pragma: no cover - none/zlib are always registered
            spec = "none"
    if spec not in _REGISTRY:
        raise KeyError(
            f"unknown codec {spec!r}; available: {available_codecs()}"
            + (" (install 'zstandard' for zstd)" if spec == "zstd" else "")
        )
    if level is not None and spec in _LEVELED:
        return _LEVELED[spec](level)
    return _REGISTRY[spec]


register_codec(Codec("none", lambda b: b, lambda b: b, ""))
register_codec(
    Codec(
        "zlib",
        lambda b: zlib.compress(b, 6),
        zlib.decompress,
        ".z",
    )
)

_LEVELED: dict[str, Callable[[int], Codec]] = {
    "zlib": lambda lvl: Codec(
        "zlib", lambda b: zlib.compress(b, min(lvl, 9)), zlib.decompress, ".z"
    ),
}

try:  # optional dependency: zstd gives ~2x better ratio at similar speed
    import zstandard as _zstd

    def _make_zstd(level: int = 3) -> Codec:
        cctx = _zstd.ZstdCompressor(level=level)
        dctx = _zstd.ZstdDecompressor()
        return Codec("zstd", cctx.compress, dctx.decompress, ".zst")

    register_codec(_make_zstd())
    _LEVELED["zstd"] = _make_zstd
    HAVE_ZSTD = True
except ImportError:  # pragma: no cover - exercised on bare environments
    HAVE_ZSTD = False
