"""ctypes binding to the repository's native IO library (counterpart of
``stereo_vo_tpu/data/native_loader.py``).

The library is ``native/libsvo_io.so``, built from ``native/svo_io.cpp`` by
``native/Makefile`` (g++ and zlib) at first use and shared with the JAX
package: zlib-based PNG decode and a multi-threaded prefetching replay loader.
When it cannot be built, ``native_available()`` is false and
``build_error()`` says why; the KITTI loader then falls back to cv2 or PIL.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess
from typing import Iterator, Optional

import numpy as np

_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native",
)
_LIB_PATH = os.path.join(_NATIVE_DIR, "libsvo_io.so")
_lib = None
_build_error: Optional[str] = None


def _build() -> None:
    """Run ``make`` once per checkout; concurrent callers wait on a lock held
    on the Makefile, so no process loads a half-written library."""
    global _build_error
    with open(os.path.join(_NATIVE_DIR, "Makefile")) as fh:
        fcntl.flock(fh, fcntl.LOCK_EX)
        if os.path.exists(_LIB_PATH):
            return
        try:
            subprocess.run(["make", "-C", _NATIVE_DIR], check=True, capture_output=True,
                           text=True)
        except FileNotFoundError as e:
            _build_error = f"make not found: {e}"
        except subprocess.CalledProcessError as e:
            _build_error = f"make failed ({e.returncode}): {e.stderr.strip()[-2000:]}"


def _load_lib(build: bool = True):
    global _lib
    if _lib is not None:
        return _lib
    if build and not os.path.exists(_LIB_PATH):
        _build()
    if not os.path.exists(_LIB_PATH):
        return None
    lib = ctypes.CDLL(_LIB_PATH)
    lib.svo_png_read_gray.restype = ctypes.c_int
    lib.svo_png_read_gray.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.c_long,
    ]
    lib.svo_loader_open.restype = ctypes.c_void_p
    lib.svo_loader_open.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_int
    ]
    lib.svo_loader_count.restype = ctypes.c_long
    lib.svo_loader_count.argtypes = [ctypes.c_void_p]
    lib.svo_loader_next.restype = ctypes.c_int
    lib.svo_loader_next.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int), ctypes.c_long,
    ]
    lib.svo_loader_close.restype = None
    lib.svo_loader_close.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def native_available() -> bool:
    return _load_lib() is not None


def build_error() -> Optional[str]:
    """Why the library could not be built, if a build was tried and failed."""
    return _build_error


def read_png_gray(path: str, max_shape=(2048, 4096)) -> Optional[np.ndarray]:
    """Decode a PNG to a grayscale uint8 array with the native decoder
    (``None`` when the library is unavailable)."""
    lib = _load_lib()
    if lib is None:
        return None
    buf = np.empty(max_shape[0] * max_shape[1], np.uint8)
    w = ctypes.c_int()
    h = ctypes.c_int()
    rc = lib.svo_png_read_gray(
        path.encode(), buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.byref(w), ctypes.byref(h), buf.size,
    )
    if rc != 0:
        raise IOError(f"native png decode failed ({rc}): {path}")
    return buf[: w.value * h.value].reshape(h.value, w.value).copy()


class NativeStereoLoader:
    """In-order threaded replay of a left/right PNG directory pair."""

    def __init__(self, left_dir: str, right_dir: str, prefetch: int = 8,
                 n_threads: int = 4, max_shape=(2048, 4096)):
        lib = _load_lib()
        if lib is None:
            raise RuntimeError(f"native IO library unavailable: {_build_error}")
        self._lib = lib
        self._handle = lib.svo_loader_open(
            left_dir.encode(), right_dir.encode(), prefetch, n_threads
        )
        if not self._handle:
            raise RuntimeError("svo_loader_open failed")
        self._max = max_shape
        self._count = lib.svo_loader_count(self._handle)

    def __len__(self) -> int:
        return int(self._count)

    def __iter__(self) -> Iterator:
        cap = self._max[0] * self._max[1]
        while True:
            lbuf = np.empty(cap, np.uint8)
            rbuf = np.empty(cap, np.uint8)
            w = ctypes.c_int()
            h = ctypes.c_int()
            rc = self._lib.svo_loader_next(
                self._handle,
                lbuf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                rbuf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                ctypes.byref(w), ctypes.byref(h), cap,
            )
            if rc == 1:
                return
            if rc != 0:
                raise IOError(f"native loader error {rc}")
            n = w.value * h.value
            yield (
                lbuf[:n].reshape(h.value, w.value),
                rbuf[:n].reshape(h.value, w.value),
            )

    def close(self):
        if getattr(self, "_handle", None):
            self._lib.svo_loader_close(self._handle)
            self._handle = None

    def __del__(self):  # pragma: no cover
        self.close()
