"""Build the port's CUDA sources with nvcc and load them with ctypes.

Every ``kernels/*/csrc/*.cu`` is compiled for ``sm_90a`` into its own shared
library with a plain C interface, under ``build/repro_torch/`` at the root of
the checkout; the headers the sources share live in ``kernels/include/``.
Each library's name carries a hash of its source, the shared headers and the
flags, so a changed source or header is rebuilt and an unchanged one is
loaded as it is.  Only the sources in this package are used; a failed build
raises with nvcc's stderr.  ``vector_width`` picks the load width that the
gather kernels take as an argument.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)
KERNELS_DIR = Path(__file__).resolve().parent
INCLUDE_DIR = KERNELS_DIR / "include"
BUILD_DIR = KERNELS_DIR.parents[2] / "build" / "repro_torch"

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


class KernelBuildError(RuntimeError):
    pass


def sources() -> list[Path]:
    """Every CUDA source of the port."""
    return sorted(KERNELS_DIR.glob("*/csrc/*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise KernelBuildError("nvcc not found: the CUDA kernels cannot be built")


def _target(src: Path) -> Path:
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    for header in sorted(INCLUDE_DIR.glob("*.cuh")):
        digest.update(header.read_bytes())
    h = digest.hexdigest()[:16]
    return BUILD_DIR / f"{src.stem}-{h}.so"


def _start(src: Path) -> tuple[subprocess.Popen, Path, Path] | None:
    """Start nvcc for ``src`` unless its library is already built."""
    out = _target(src)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(INCLUDE_DIR), "-o", str(tmp), str(src)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return proc, tmp, out


def _finish(src: Path, job: tuple[subprocess.Popen, Path, Path]) -> None:
    proc, tmp, out = job
    _, err = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise KernelBuildError(f"nvcc failed on {src.name} (exit {proc.returncode}):\n{err}")
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file


def build_all() -> float:
    """Compile every source not yet built, all nvcc processes at once.
    Returns the wall seconds it took."""
    t0 = time.perf_counter()
    jobs = [(src, _start(src)) for src in sources()]
    errors = []
    for src, job in jobs:
        if job is None:
            continue
        try:
            _finish(src, job)
        except KernelBuildError as e:  # wait for every nvcc before raising
            errors.append(str(e))
    if errors:
        raise KernelBuildError("\n".join(errors))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The library built from ``kernels/<name>/csrc/<name>.cu`` (built now
    if needed)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            src = KERNELS_DIR / name / "csrc" / f"{name}.cu"
            if not src.exists():
                raise KernelBuildError(f"no CUDA source {src}")
            job = _start(src)
            if job is not None:
                _finish(src, job)
            lib = ctypes.CDLL(str(_target(src)))
            _libs[name] = lib
        return lib


def vector_width(dim: int, itemsize: int, *tensors) -> int:
    """Elements per load: the widest power of two, at most 16 bytes, that
    divides ``dim`` and keeps every row of ``tensors`` aligned to its bytes."""
    vec = 16 // itemsize
    while vec > 1 and (dim % vec or any(t.data_ptr() % (vec * itemsize) for t in tensors)):
        vec //= 2
    return vec
