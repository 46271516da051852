"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface under ``build/`` and loaded with
ctypes.  Nothing here runs at import: a wrapper calls :func:`load` at its
first launch on a CUDA tensor, and a library is rebuilt only when its
source, a shared header (``csrc/*.cuh``) or the flags change.  A missing
``nvcc`` raises; there is no fallback.  ``ptxas`` reports each kernel's
registers and spills; :data:`logs` keeps nvcc's output of this process's
builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD = _PKG / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_loaded: dict[str, ctypes.CDLL] = {}
logs: dict[str, str] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        candidate = Path(home) / "bin" / "nvcc"
        if candidate.is_file():
            path = str(candidate)
    if path is None:
        raise RuntimeError(
            "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin); "
            "the port's CUDA kernels are built from source at first use"
        )
    return path


def _library_path(name: str) -> Path:
    """The library of ``csrc/<name>.cu``, named by a digest of its source,
    every shared header and the flags."""
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.name.encode() + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD / f"lib{name}-{digest.hexdigest()[:16]}.so"


def _start(name: str, nvcc: str):
    """Start nvcc for one source into a temporary file; returns
    (process, temporary path, final path)."""
    BUILD.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD)
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return proc, tmp, _library_path(name)


def build(names=None) -> list[str]:
    """Compile the named sources (default: every ``csrc/*.cu``), one nvcc
    each, all started together.  Returns the names that were compiled."""
    if names is None:
        names = sorted(p.stem for p in CSRC.glob("*.cu"))
    pending = {}
    nvcc = None
    for name in names:
        if _library_path(name).exists():
            continue
        nvcc = nvcc or _nvcc()
        pending[name] = _start(name, nvcc)
    failures = []
    for name, (proc, tmp, target) in pending.items():
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode != 0:
            os.unlink(tmp)
            failures.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, target)  # atomic: a concurrent loader sees all or nothing
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return list(pending)


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed.
    ``signatures`` maps each C function to (argtypes, restype)."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(_library_path(name)))
        for fn, (argtypes, restype) in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        _loaded[name] = lib
    return lib
