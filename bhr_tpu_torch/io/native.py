"""ctypes bindings for the native C++ I/O runtime (native/bhr_native.cpp
and native/bhr_exr.cpp, built into native/libbhr_native.so by
native/Makefile): the port's own copy of bhr_tpu/io/native.py.

The library is built with `make` at first use (`_build_and_open`). The
PNG writer and its frame queue (`write_png`, `submit_frame`, `drain`,
`pending`) write frames on the library's worker threads; where it is missing,
`submit_frame` writes through the pure-Python PNG codec of io/image.py
(`write_png_fallback`) and `write_png` raises. Where the toolchain or the
system OpenEXR is missing, `exr_available()` is False and io/skybox.py
decodes with its pure-Python reader (scanline NONE/ZIPS/ZIP); a PIZ file
then raises that reader's "unsupported EXR compression". BHR_NO_NATIVE=1
disables the library explicitly.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess
import threading

import numpy as np

_NATIVE_DIR = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "..", "native"))
_LIB_PATH = os.path.join(_NATIVE_DIR, "libbhr_native.so")

_lock = threading.Lock()
_lib = None
_tried = False

# OpenEXR's compression enum
EXR_COMPRESSION = {"none": 0, "rle": 1, "zips": 2, "zip": 3, "piz": 4}


def _build_and_open() -> ctypes.CDLL:
    """The library, where it opens as it is; else built under an exclusive
    lock on native/.build.lock, by make into a temporary name renamed into
    place, so that no process opens a half-written file."""
    try:
        return ctypes.CDLL(_LIB_PATH)
    except OSError:
        pass  # missing, or half-written by bhr_tpu's unlocked in-place build
    with open(os.path.join(_NATIVE_DIR, ".build.lock"), "a") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            return ctypes.CDLL(_LIB_PATH)  # built while this process waited
        except OSError:
            tmp = f".libbhr_native.{os.getpid()}.so"
            subprocess.run(["make", "-s", f"TARGET={tmp}"], cwd=_NATIVE_DIR, check=True,
                           capture_output=True, timeout=120)
            os.replace(os.path.join(_NATIVE_DIR, tmp), _LIB_PATH)
            return ctypes.CDLL(_LIB_PATH)


def _load():
    """The loaded library with its signatures declared, or None. Tried once
    per process."""
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        if os.environ.get("BHR_NO_NATIVE"):
            return None
        try:
            lib = _build_and_open()
            png_args = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
                        ctypes.c_int]
            lib.bhr_write_png.argtypes = png_args
            lib.bhr_write_png.restype = ctypes.c_int
            lib.bhr_submit_frame.argtypes = png_args
            lib.bhr_submit_frame.restype = ctypes.c_int
            lib.bhr_drain.restype = ctypes.c_int
            lib.bhr_pending.restype = ctypes.c_int
        except (OSError, subprocess.SubprocessError, AttributeError):
            return None  # no toolchain, a failed build, or a library without the PNG writer
        try:
            c_float_p = ctypes.POINTER(ctypes.c_float)
            c_int_p = ctypes.POINTER(ctypes.c_int)
            lib.bhr_exr_available.restype = ctypes.c_int
            lib.bhr_exr_error.restype = ctypes.c_char_p
            lib.bhr_exr_size.argtypes = [ctypes.c_char_p, c_int_p, c_int_p]
            lib.bhr_exr_size.restype = ctypes.c_int
            lib.bhr_exr_read.argtypes = [ctypes.c_char_p, c_float_p]
            lib.bhr_exr_read.restype = ctypes.c_int
            lib.bhr_exr_write.argtypes = [ctypes.c_char_p, c_float_p, ctypes.c_int, ctypes.c_int,
                                          ctypes.c_int, ctypes.c_int]
            lib.bhr_exr_write.restype = ctypes.c_int
        except AttributeError:  # a library built without the EXR codec
            pass
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def _as_ptr(rgba: np.ndarray):
    rgba = np.ascontiguousarray(rgba, np.uint8)
    return rgba, rgba.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def write_png(path: str, rgba: np.ndarray) -> None:
    """Synchronous native PNG write of uint8 (H, W, 4) RGBA."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    h, w = rgba.shape[:2]
    arr, ptr = _as_ptr(rgba)
    rc = lib.bhr_write_png(path.encode(), ptr, w, h)
    if rc != 0:
        raise IOError(f"bhr_write_png failed with code {rc} for {path}")


def submit_frame(path: str, rgba: np.ndarray) -> None:
    """Asynchronous PNG write on the native worker pool (the library copies
    the buffer); without the library, a synchronous pure-Python write."""
    lib = _load()
    if lib is None:
        write_png_fallback(path, rgba)
        return
    h, w = rgba.shape[:2]
    arr, ptr = _as_ptr(rgba)
    lib.bhr_submit_frame(path.encode(), ptr, w, h)


def drain() -> int:
    """Wait for all queued native writes; returns the number of failures."""
    lib = _load()
    return lib.bhr_drain() if lib is not None else 0


def pending() -> int:
    """Frames queued and not yet written."""
    lib = _load()
    return lib.bhr_pending() if lib is not None else 0


def write_png_fallback(path: str, rgba: np.ndarray) -> None:
    """The pure-Python PNG codec of io/image.py."""
    from .image import write_png as py_write_png

    py_write_png(path, np.ascontiguousarray(rgba, np.uint8))


def exr_available() -> bool:
    lib = _load()
    return bool(lib is not None and hasattr(lib, "bhr_exr_available")
                and lib.bhr_exr_available())


def _exr_err(lib) -> str:
    try:
        return lib.bhr_exr_error().decode(errors="replace")
    except Exception:
        return "unknown native EXR error"


def _require():
    lib = _load()
    if lib is None or not exr_available():
        raise RuntimeError("native EXR support unavailable")
    return lib


def read_exr_native(path: str) -> np.ndarray:
    """Decode any EXR to fp32 (H, W, 4) RGBA via OpenEXR."""
    lib = _require()
    w = ctypes.c_int()
    h = ctypes.c_int()
    if lib.bhr_exr_size(path.encode(), ctypes.byref(w), ctypes.byref(h)):
        raise IOError(f"EXR open failed for {path}: {_exr_err(lib)}")
    out = np.empty((h.value, w.value, 4), np.float32)
    if lib.bhr_exr_read(path.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float))):
        raise IOError(f"EXR decode failed for {path}: {_exr_err(lib)}")
    return out


def write_exr_native(path: str, rgba: np.ndarray, compression: str = "piz",
                     half: bool = True) -> None:
    """Encode fp32 (H, W, >=3) RGBA to EXR via OpenEXR (PIZ by default, the
    scheme real star-map assets ship with)."""
    lib = _require()
    rgba = np.asarray(rgba, np.float32)
    if rgba.ndim != 3 or rgba.shape[2] < 3:
        raise ValueError("expected (H, W, >=3) RGBA array")
    if rgba.shape[2] == 3:
        rgba = np.concatenate([rgba, np.ones(rgba.shape[:2] + (1,), np.float32)], axis=-1)
    rgba = np.ascontiguousarray(rgba[..., :4])
    hgt, wid = rgba.shape[:2]
    comp = EXR_COMPRESSION[compression] if isinstance(compression, str) else int(compression)
    rc = lib.bhr_exr_write(path.encode(), rgba.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                           wid, hgt, comp, int(bool(half)))
    if rc:
        raise IOError(f"EXR encode failed for {path}: {_exr_err(lib)}")
