"""Build the port's CUDA kernels with ``nvcc`` into shared libraries with a
plain C interface, and load them with ``ctypes``.

A library is built at first use and cached on disk by the hash of its
source, every shared header (``csrc/*.cuh``) and the flags
(``build/kernels/`` at the repository root, or ``$REPRO_TORCH_BUILD_DIR``).
Nothing here runs on import: a machine without ``nvcc`` can import every
module of the port.

    lib = build("grouped_lora_matmul")      # ctypes.CDLL, built on demand
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LOADED: dict[str, ctypes.CDLL] = {}
#: per library: {"seconds": build time (0.0 when cached), "log": nvcc's
#: output (the ptxas report), kept beside the library, "path"}
BUILD_INFO: dict[str, dict] = {}


def aligned16(*tensors) -> bool:
    """Whether every tensor's base address is a multiple of 16 bytes, as TMA
    and 16-byte vector loads need.  A contiguous view at an odd element
    offset is not: the route functions take this as a pure input."""
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[3] / "build" / "kernels"


def nvcc_path() -> str:
    for cand in (os.environ.get("NVCC"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"),
                 shutil.which("nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or NVCC): the port's "
                       "CUDA kernels are built from source at first use")


def source_digest(name: str, csrc: Path = CSRC) -> str:
    """The cache key of library ``name``: a hash of ``<name>.cu``, of every
    ``*.cuh`` header beside it (by name and content, so that an edit to a
    header rebuilds the libraries that may include it) and of the flags."""
    h = hashlib.sha256((csrc / f"{name}.cu").read_bytes())
    for header in sorted(csrc.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build(name: str) -> ctypes.CDLL:
    """Return the loaded library built from ``csrc/<name>.cu``, compiling
    it first unless a library for the same sources and flags exists."""
    if name in _LOADED:
        return _LOADED[name]
    src = CSRC / f"{name}.cu"
    out = build_dir() / f"{name}-{source_digest(name)}.so"
    info = {"seconds": 0.0, "log": "", "path": str(out)}
    if not out.exists():
        t0 = time.perf_counter()
        out.parent.mkdir(parents=True, exist_ok=True)
        # build to a private name, then rename: a concurrent process never
        # loads a half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
        os.close(fd)
        proc = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(src)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed for {src}:\n{proc.stdout}")
        out.with_suffix(".log").write_text(proc.stdout)
        os.replace(tmp, out)
        info["seconds"] = time.perf_counter() - t0
    log = out.with_suffix(".log")
    info["log"] = log.read_text() if log.exists() else ""
    _LOADED[name] = lib = ctypes.CDLL(str(out))
    BUILD_INFO[name] = info
    return lib


__all__ = ["BUILD_INFO", "aligned16", "build", "build_dir", "nvcc_path",
           "source_digest"]
