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
import threading
from pathlib import Path

KERNELS_DIR = Path(__file__).resolve().parent
BUILD_DIR = KERNELS_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: kernel name -> its CUDA source
SOURCES = {
    name: KERNELS_DIR / name / "csrc" / f"{name}.cu"
    for name in ("fused_query", "intersect", "topk_score", "dvbyte_decode",
                 "retrieval_dot")
}

#: kernel name -> its loaded library, written under ``_LOAD_LOCK`` only
_LOADED: dict[str, ctypes.CDLL] = {}
#: one first load at a time: two threads that launch a kernel for the first
#: time together (a fleet's fan-out pool) must not both run ``nvcc`` into
#: one library path and both open it
_LOAD_LOCK = threading.Lock()


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


def _library(src: Path, tag: str) -> Path:
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{tag}-{digest}.so"


def library_path(name: str) -> Path:
    return _library(SOURCES[name], name)


def _start(src: Path, lib: Path):
    """Start ``nvcc`` for one source; None when its library is current."""
    if lib.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, lib


def _finish(tag: str, job) -> None:
    proc, tmp, lib = job
    out, _ = proc.communicate()
    lib.with_suffix(".log").write_text(out)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {tag} "
                           f"(exit {proc.returncode}):\n{out}")
    os.replace(tmp, lib)       # atomic: a concurrent build never sees half


def build_sources(sources: dict[str, Path]) -> dict[str, Path]:
    """Build each source (tag -> path) into ``lib<tag>-<hash>.so``, one
    ``nvcc`` per source, all started together.  Returns tag -> library
    path.  Sources outside :data:`SOURCES` (another revision's kernel, for
    an A/B on one card) build under their own tags."""
    libs = {t: _library(Path(s), t) for t, s in sources.items()}
    jobs = {t: _start(Path(s), libs[t]) for t, s in sources.items()}
    for t, job in jobs.items():
        if job is not None:
            _finish(t, job)
    return libs


def build_all(names=None) -> dict[str, Path]:
    """Build every named kernel (default: all) of this checkout."""
    names = list(SOURCES if names is None else names)
    return build_sources({n: SOURCES[n] for n in names})


def build_log(name: str) -> str:
    """The compiler's output (``-Xptxas -v``: registers, shared memory,
    spills) from the build of ``name``'s current library."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load(name: str, setup=None) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed.

    Thread-safe: the first callers wait on one lock while one of them
    builds and opens the library and runs ``setup(lib)`` on it (declaring
    ``argtypes``), so no caller sees a library whose functions are not yet
    declared."""
    lib = _LOADED.get(name)
    if lib is not None:
        return lib
    with _LOAD_LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            path = build_all([name])[name]
            lib = ctypes.CDLL(str(path))
            if setup is not None:
                setup(lib)
            _LOADED[name] = lib
    return lib
