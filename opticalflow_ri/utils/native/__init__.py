"""ctypes bindings for the native IO runtime (libofri_io.so).

The library is built from ``ofri_io.cpp`` on first use (g++, ~1 s) into
``build/native/`` at the root of the checkout, which git ignores, and
rebuilt when the source is newer.  Every entry point has a pure-Python
fallback in utils/io.py, so the engine works without a toolchain.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "ofri_io.cpp")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(_DIR))), "build", "native")
LIB_PATH = os.path.join(BUILD_DIR, "libofri_io.so")
_lib = None
_tried = False


def build_library(path: str = LIB_PATH) -> None:
    """Compile ``ofri_io.cpp`` to ``path``.  The compiler writes a
    per-process temporary that is renamed into place, so concurrent builders
    never load a half-written library.  Raises on failure."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        subprocess.run(["sh", os.path.join(_DIR, "build.sh"), tmp],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _load():
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if (not os.path.exists(LIB_PATH)
            or os.path.getmtime(LIB_PATH) < os.path.getmtime(_SRC)):
        try:
            build_library()
        except (OSError, subprocess.SubprocessError):
            return None
    try:
        lib = ctypes.CDLL(LIB_PATH)
    except OSError:
        return None
    lib.ofri_tiff_read.restype = ctypes.c_int
    lib.ofri_tiff_read.argtypes = [
        ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
    ]
    lib.ofri_tiff_read_batch.restype = ctypes.c_int
    lib.ofri_tiff_read_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int32, ctypes.c_void_p,
        ctypes.c_int32, ctypes.c_int32,
    ]
    lib.ofri_save_flow.restype = ctypes.c_int
    lib.ofri_save_flow.argtypes = [
        ctypes.c_char_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int32, ctypes.c_int32,
    ]
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def tiff_read(path: str) -> np.ndarray | None:
    """Decode an uncompressed grayscale TIFF to float32; None if the file
    layout is unsupported (caller falls back to PIL)."""
    lib = _load()
    if lib is None:
        return None
    h = ctypes.c_int32()
    w = ctypes.c_int32()
    rc = lib.ofri_tiff_read(path.encode(), None, 0, ctypes.byref(h), ctypes.byref(w))
    if rc != 0:
        return None
    out = np.empty((h.value, w.value), np.float32)
    rc = lib.ofri_tiff_read(
        path.encode(), out.ctypes.data_as(ctypes.c_void_p), out.size,
        ctypes.byref(h), ctypes.byref(w),
    )
    return out if rc == 0 else None


def tiff_read_batch(paths) -> np.ndarray | None:
    """Threaded decode of equally-sized TIFFs into one (N, H, W) array."""
    lib = _load()
    if lib is None or not paths:
        return None
    first = tiff_read(paths[0])
    if first is None:
        return None
    h, w = first.shape
    out = np.empty((len(paths), h, w), np.float32)
    arr = (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])
    rc = lib.ofri_tiff_read_batch(
        arr, len(paths), out.ctypes.data_as(ctypes.c_void_p), h, w
    )
    return out if rc == 0 else None


def save_flow(path: str, u: np.ndarray, v: np.ndarray) -> bool:
    lib = _load()
    if lib is None:
        return False
    u = np.ascontiguousarray(u, np.float32)
    v = np.ascontiguousarray(v, np.float32)
    rc = lib.ofri_save_flow(
        path.encode(),
        u.ctypes.data_as(ctypes.c_void_p), v.ctypes.data_as(ctypes.c_void_p),
        u.shape[0], u.shape[1],
    )
    return rc == 0
