"""Build and load the port's CUDA kernels.

``nvcc`` compiles each ``csrc/*.cu`` for ``sm_90a`` into an object, all
sources at once in parallel processes, and links the objects into one
shared library with a plain C interface, which ``ctypes`` loads. The build
happens at first launch, never at import, into ``build/repro_torch/`` at
the root of the checkout; the library's file name carries a hash of the
sources and flags, so an edited source is rebuilt and an unchanged one is
reused.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(
            "nvcc not found (PATH, CUDA_HOME); the CUDA kernels are built "
            "from source on first launch")
    return str(path)


def _sources() -> list[Path]:
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"librepro_torch_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless this exact build exists; returns its path.

    One ``nvcc -c`` per source runs in parallel, then one link. The
    compiler's report (``-Xptxas -v``: registers, shared memory and spills
    per kernel) is kept beside the library as ``<name>.log``.
    """
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, tag = _nvcc(), f"{out.stem}.{os.getpid()}"
    sources = [p for p in _sources() if p.suffix == ".cu"]
    objs = [BUILD_DIR / f"{tag}.{p.stem}.o" for p in sources]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(p)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for p, o in zip(sources, objs)]
    logs = [proc.communicate()[0] for proc in procs]
    try:
        failed = [f"{p.name} ({proc.returncode}):\n{log}"
                  for p, proc, log in zip(sources, procs, logs) if proc.returncode]
        if failed:
            raise RuntimeError("nvcc failed on " + "\n".join(failed))
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        link = subprocess.run([nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp),
                               *(str(o) for o in objs)], capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{link.stderr}")
    finally:
        for o in objs:
            o.unlink(missing_ok=True)
    out.with_suffix(".log").write_text("".join(logs) + link.stdout + link.stderr)
    os.replace(tmp, out)  # atomic: a concurrent build never sees a torn file
    return out


def load_library() -> ctypes.CDLL:
    """The loaded kernel library (built first if needed), with every entry
    point's argument and return types declared."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            ptr, i32 = ctypes.c_void_p, ctypes.c_int
            lib.knn_scan.argtypes = [ptr] * 12 + [i32] * 14 + [ptr]
            lib.knn_int8_scan.argtypes = [ptr] * 12 + [i32] * 10 + [ptr]
            lib.knn_merge.argtypes = [ptr] * 4 + [i32] * 4 + [ptr]
            lib.topk_scan.argtypes = [ptr] * 4 + [i32] * 7 + [ptr]
            lib.l2dist.argtypes = [ptr] * 5 + [i32] * 8 + [ptr]
            for fn in (lib.knn_scan, lib.knn_int8_scan, lib.knn_merge, lib.topk_scan,
                       lib.l2dist):
                fn.restype = i32
            _lib = lib
        return _lib
