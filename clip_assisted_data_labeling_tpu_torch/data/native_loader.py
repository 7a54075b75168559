"""ctypes binding of the repo's native batch JPEG decoder
(``native/fastloader.cpp``; port of the JAX package's
``data/native_loader.py``).

The library decodes a batch of JPEGs on a thread pool (DCT-domain prescale
for oversized images, then an exact area filter) straight into centered
[canvas, canvas, 3] slots. It is built at first use with ``g++ … -ljpeg``
into ``clip_assisted_data_labeling_tpu_torch/_build/`` (gitignored), keyed by
a hash of the source and the flags. It is a host decoder, not a kernel:
where the toolchain or libjpeg's header is missing the build fails, the
failure is logged at warning level (``build_error()`` says why), and the
loader falls back to cv2/PIL, as the JAX package's loader does. Nothing
builds at import.
"""
from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
import threading

import numpy as np

log = logging.getLogger(__name__)

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(os.path.dirname(_PKG_DIR), "native", "fastloader.cpp")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]
LINK_FLAGS = ["-ljpeg", "-pthread"]

_lock = threading.Lock()
_state: dict = {"lib": None, "tried": False, "error": None}


def _lib_path() -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS + LINK_FLAGS).encode())
    with open(SRC, "rb") as fh:
        h.update(fh.read())
    return os.path.join(BUILD_DIR, f"libfastloader_{h.hexdigest()[:12]}.so")


def _build(out: str) -> None:
    """Compile the decoder into ``out`` (atomically); raises on failure."""
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    proc = subprocess.run([cxx, *CXX_FLAGS, SRC, "-o", tmp, *LINK_FLAGS],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed: {proc.stderr.strip()[-500:]}")
    os.replace(tmp, out)


def get_lib() -> ctypes.CDLL | None:
    """The decoder library (built on the first call), or None where it
    cannot be built or loaded — then :func:`build_error` says why."""
    with _lock:
        if _state["tried"]:
            return _state["lib"]
        _state["tried"] = True
        try:
            if not os.path.exists(SRC):
                raise RuntimeError(f"{SRC} is missing")
            path = _lib_path()
            if not os.path.exists(path):
                _build(path)
            try:
                lib = ctypes.CDLL(path)
            except OSError:
                # a library built on another machine (a copied checkout)
                # may link a libjpeg this one lacks: build it here once
                _build(path)
                lib = ctypes.CDLL(path)
        except (OSError, RuntimeError, subprocess.SubprocessError) as e:
            _state["error"] = str(e)
            log.warning("native JPEG decoder unavailable (%s); decoding with cv2/PIL", e)
            return None
        lib.decode_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int), ctypes.c_int,
        ]
        lib.decode_batch.restype = None
        _state["lib"] = lib
        return lib


def build_error() -> str | None:
    """Why the decoder is unavailable (None if it loaded or was not tried)."""
    return _state["error"]


def decode_batch_native(paths: list[str], canvas_size: int, n_threads: int = 8):
    """Decode a batch of JPEGs → (canvases [n, C, C, 3] uint8, dims [n, 2]
    (w, h) int32), each image centered in its canvas. dims[i] == (0, 0)
    marks a file the decoder refused (not a JPEG, corrupt): the caller
    decodes it another way. Returns None where the library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(paths)
    canvases = np.zeros((n, canvas_size, canvas_size, 3), np.uint8)
    dims = np.zeros((n, 2), np.int32)
    # os.fsencode round-trips surrogate-escaped (non-UTF-8) file names
    arr = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    lib.decode_batch(arr, n, canvas_size,
                     canvases.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                     dims.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), n_threads)
    return canvases, dims
