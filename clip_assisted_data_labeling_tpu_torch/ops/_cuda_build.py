"""Build and load the port's hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` into its own shared library with a plain
C interface for ``sm_90a`` and loaded with ``ctypes`` (no PyTorch headers, so
a build takes seconds). Builds run at first use into ``_build/`` next to this
package (listed in ``.gitignore``), keyed by a hash of the source, the shared
headers and the flags, so an edited kernel is rebuilt and a stale library is
never loaded.
``build_all()`` starts one ``nvcc`` per source at once and waits for all.

Nothing here runs at import: the CPU test suite imports every module on a
machine with no ``nvcc`` and no card.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                           "-Xptxas", "-v"]
SMEM_LIMIT = 232448  # bytes of shared memory one H100 block may use

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def sources() -> list[str]:
    """Kernel names, one per ``csrc/<name>.cu``."""
    return sorted(f[:-3] for f in os.listdir(CSRC_DIR) if f.endswith(".cu"))


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(cuda_home, "bin", "nvcc")
    found = cand if os.path.exists(cand) else shutil.which("nvcc")
    if not found:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
            "PATH); the CUDA kernels are built from csrc/ at first use"
        )
    return found


def _lib_path(name: str) -> str:
    """The library's path, keyed by the source, every shared header in
    ``csrc/`` (``*.cuh``) and the flags."""
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in [name + ".cu", *headers]:
        with open(os.path.join(CSRC_DIR, f), "rb") as fh:
            h.update(fh.read())
    return os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:12]}.so")


def _start(name: str):
    """Start nvcc for one source unless its library is built; returns
    (proc, tmp, out) or None."""
    out = _lib_path(name)
    if os.path.exists(out):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, name + ".cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, job) -> str:
    """Wait for one nvcc; returns its output (ptxas register/smem report)."""
    proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
    os.replace(tmp, out)  # atomic: a concurrent loader never sees a partial file
    with open(out[:-3] + ".log", "w") as f:
        f.write(log)
    return log


def build_all() -> dict[str, str]:
    """Compile every kernel source in parallel; returns {name: nvcc output}
    for the ones built now (already-built libraries are skipped)."""
    with _lock:
        jobs = {n: _start(n) for n in sources()}
        logs = {}
        try:
            for n, job in jobs.items():
                if job is not None:
                    logs[n] = _finish(n, job)
        finally:
            for job in jobs.values():
                if job is not None and job[0].poll() is None:
                    job[0].kill()
                    job[0].wait()
        return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it first if needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        if name not in _libs:
            job = _start(name)
            if job is not None:
                _finish(name, job)
            _libs[name] = ctypes.CDLL(_lib_path(name))
        return _libs[name]


def check(err: int, what: str) -> None:
    """Raise if a launch returned a nonzero cudaError_t."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {err}")
