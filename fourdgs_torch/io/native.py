"""ctypes bridge to the repo's native C++ IO library (native/fastio.cpp,
native/libfourdgs_native.so): a copy of fourdgs/io/native.py.

Nothing is loaded or built at import: `_load()` runs at the first call, and
builds the library with make/g++ only if it is missing. Every entry point
returns None (or False) when the library cannot be loaded, and io/vdata.py
then parses in Python.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "native")
_LIB_PATH = os.path.abspath(os.path.join(_NATIVE_DIR, "libfourdgs_native.so"))

_lock = threading.Lock()
_lib = None
_lib_tried = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _lib_tried
    with _lock:
        if _lib_tried:
            return _lib
        _lib_tried = True
        if not os.path.exists(_LIB_PATH):
            try:
                subprocess.run(["make", "-C", os.path.abspath(_NATIVE_DIR)],
                               check=True, capture_output=True, timeout=120)
            except Exception:
                return None
        try:
            lib = ctypes.CDLL(_LIB_PATH)
        except OSError:
            return None
        lib.fourdgs_read_floats.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
            ctypes.POINTER(ctypes.c_int64)]
        lib.fourdgs_read_floats.restype = ctypes.c_int
        lib.fourdgs_free.argtypes = [ctypes.POINTER(ctypes.c_float)]
        lib.fourdgs_write_cache.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
            ctypes.c_int32]
        lib.fourdgs_write_cache.restype = ctypes.c_int
        lib.fourdgs_read_cache.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32)]
        lib.fourdgs_read_cache.restype = ctypes.c_int
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def read_floats(path: str) -> Optional[np.ndarray]:
    """All whitespace-separated floats in `path` as float32, or None if the
    native library is unavailable (callers fall back to Python parsing)."""
    lib = _load()
    if lib is None:
        return None
    out = ctypes.POINTER(ctypes.c_float)()
    n = ctypes.c_int64()
    rc = lib.fourdgs_read_floats(path.encode(), ctypes.byref(out), ctypes.byref(n))
    if rc != 0:
        raise IOError(f"native float read failed (rc={rc}): {path}")
    try:
        return np.ctypeslib.as_array(out, shape=(n.value,)).copy()
    finally:
        lib.fourdgs_free(out)


def write_cache(path: str, records: np.ndarray) -> bool:
    """Write a (N, F) float32 record array as a binary cache. Returns False
    when the native library is unavailable."""
    lib = _load()
    if lib is None:
        return False
    rec = np.ascontiguousarray(records, dtype=np.float32)
    n, f = rec.shape
    rc = lib.fourdgs_write_cache(
        path.encode(), rec.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        n, f)
    if rc != 0:
        raise IOError(f"native cache write failed (rc={rc}): {path}")
    return True


def read_cache(path: str) -> Optional[np.ndarray]:
    lib = _load()
    if lib is None:
        return None
    out = ctypes.POINTER(ctypes.c_float)()
    n = ctypes.c_int64()
    f = ctypes.c_int32()
    rc = lib.fourdgs_read_cache(path.encode(), ctypes.byref(out),
                                ctypes.byref(n), ctypes.byref(f))
    if rc != 0:
        raise IOError(f"native cache read failed (rc={rc}): {path}")
    try:
        return np.ctypeslib.as_array(out, shape=(n.value * f.value,)).reshape(
            n.value, f.value).copy()
    finally:
        lib.fourdgs_free(out)
