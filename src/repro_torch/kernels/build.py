"""Build the port's CUDA kernels at first use and load them with ctypes.

Each kernel source under ``kernels/<name>/csrc/`` exposes a plain C
interface, so it compiles in seconds with ``nvcc`` alone (no PyTorch
headers) into a shared library that :func:`load` opens with ``ctypes``.
Libraries land in ``kernels/_build/`` (listed in ``.gitignore``), named by a
hash of the source and the flags, so an edited source rebuilds and an
unchanged one is reused.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

KERNELS_DIR = Path(__file__).resolve().parent
BUILD_DIR = KERNELS_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: kernel name -> its CUDA source
SOURCES = {
    name: KERNELS_DIR / name / "csrc" / f"{name}.cu"
    for name in ("fused_query", "intersect", "topk_score", "dvbyte_decode")
}

_LOADED: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of the CUDA compiler (CUDA_HOME, then PATH, then the default
    toolkit location); raises when there is none."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ((Path(home) / "bin" / "nvcc") if home else None,
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and Path(cand).is_file():
            return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME)")


def library_path(name: str) -> Path:
    src = SOURCES[name]
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _start(name: str):
    """Start ``nvcc`` for one kernel; None when its library is current."""
    lib = library_path(name)
    if lib.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, lib


def _finish(name: str, job) -> None:
    proc, tmp, lib = job
    out, _ = proc.communicate()
    lib.with_suffix(".log").write_text(out)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name} "
                           f"(exit {proc.returncode}):\n{out}")
    os.replace(tmp, lib)       # atomic: a concurrent build never sees half


def build_all(names=None) -> dict[str, Path]:
    """Build every named kernel (default: all), one ``nvcc`` per source,
    all started together.  Returns name -> library path."""
    names = list(SOURCES if names is None else names)
    jobs = {n: _start(n) for n in names}
    for n, job in jobs.items():
        if job is not None:
            _finish(n, job)
    return {n: library_path(n) for n in names}


def build_log(name: str) -> str:
    """The compiler's output (``-Xptxas -v``: registers, shared memory,
    spills) from the build of ``name``'s current library."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        path = build_all([name])[name]
        lib = _LOADED[name] = ctypes.CDLL(str(path))
    return lib
