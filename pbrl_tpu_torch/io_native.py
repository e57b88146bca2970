"""ctypes binding of the native C++ clip loader, ``native/pbrl_io.cpp``
(counterpart of ``pbrl_tpu/io_native.py``, with the same API).

The library is built from the source with the host C++ compiler on first
use, into ``build/pbrl_tpu_torch/`` under a name that carries the source's
hash (under a temporary name, then renamed, so a build cut off halfway
leaves nothing that a later run would load); ``native/``'s own files are
never written. As in pbrl_tpu, ``PBRL_NATIVE=0`` or a host without a C++
compiler leaves the loader unavailable and the callers
(:func:`pbrl_tpu_torch.mocap.convert.parse_deepmimic`) parse the clip with
Python's ``json``; a compiler that fails on the source raises. This is
host code, off the device's path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from typing import List, Optional, Tuple

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_ROOT, "native", "pbrl_io.cpp")
BUILD_DIR = os.path.join(_ROOT, "build", "pbrl_tpu_torch")
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared")
_LOOP_NAMES = {0: "none", 1: "wrap", 2: "mirror"}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _compiler() -> Optional[str]:
    return shutil.which(os.environ.get("CXX", "c++")) or shutil.which("g++")


def build() -> Optional[str]:
    """Compile the loader (once per source content); its path, or None
    without a compiler."""
    cxx = _compiler()
    if cxx is None:
        return None
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    os.makedirs(BUILD_DIR, exist_ok=True)
    path = os.path.join(BUILD_DIR, f"libpbrl_io_{digest}.so")
    if not os.path.exists(path):
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, SOURCE, "-lpthread"],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"{cxx} failed on {SOURCE} ({proc.returncode}):\n"
                               f"{proc.stderr[-4000:]}")
        os.replace(tmp, path)
    return path


def get_library() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native library, or None."""
    global _lib, _tried
    if os.environ.get("PBRL_NATIVE", "1") == "0":
        return None
    with _lock:
        if _tried:
            return _lib
        _tried = True
        path = build()
        if path is None:
            return None
        lib = ctypes.CDLL(path)
        lib.pbrl_load_clip.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.POINTER(ctypes.c_double)),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.pbrl_load_clip.restype = ctypes.c_int
        lib.pbrl_load_clips.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_double)),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ]
        lib.pbrl_load_clips.restype = ctypes.c_int
        lib.pbrl_free.argtypes = [ctypes.POINTER(ctypes.c_double)]
        lib.pbrl_last_error.restype = ctypes.c_char_p
        _lib = lib
        return _lib


def available() -> bool:
    return get_library() is not None


def load_frames(path: str) -> Tuple[np.ndarray, str]:
    """(frames (T, W) float64, loop) by the native parser; a parse failure
    raises RuntimeError with the parser's message."""
    lib = get_library()
    if lib is None:
        raise RuntimeError("native loader unavailable")
    data = ctypes.POINTER(ctypes.c_double)()
    rows, cols, loop = ctypes.c_int64(), ctypes.c_int64(), ctypes.c_int()
    rc = lib.pbrl_load_clip(path.encode(), ctypes.byref(data), ctypes.byref(rows),
                            ctypes.byref(cols), ctypes.byref(loop))
    if rc != 0:
        raise RuntimeError(f"native clip load failed ({rc}): "
                           f"{lib.pbrl_last_error().decode()}: {path}")
    try:
        n = rows.value * cols.value
        arr = np.ctypeslib.as_array(data, shape=(n,)).reshape(rows.value, cols.value).copy()
    finally:
        lib.pbrl_free(data)
    return arr, _LOOP_NAMES.get(loop.value, "none")


def load_frames_batch(paths: List[str]):
    """Many clips parsed in parallel threads: [(frames, loop) | None]."""
    lib = get_library()
    if lib is None:
        raise RuntimeError("native loader unavailable")
    n = len(paths)
    c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    data = (ctypes.POINTER(ctypes.c_double) * n)()
    rows, cols = (ctypes.c_int64 * n)(), (ctypes.c_int64 * n)()
    loops, status = (ctypes.c_int * n)(), (ctypes.c_int * n)()
    lib.pbrl_load_clips(c_paths, n, data, rows, cols, loops, status)
    out = []
    for i in range(n):
        if status[i] != 0 or not data[i]:
            out.append(None)
            continue
        cnt = rows[i] * cols[i]
        arr = np.ctypeslib.as_array(data[i], shape=(cnt,)).reshape(rows[i], cols[i]).copy()
        lib.pbrl_free(data[i])
        out.append((arr, _LOOP_NAMES.get(loops[i], "none")))
    return out
