"""Native (C++) host-side image preprocessing, loaded via ctypes.

Compiled lazily with g++ on first use (the image ships no pybind11; the
C ABI + ctypes is the binding layer). Falls back to a NumPy/PIL path if
no compiler is available.
"""

from __future__ import annotations

import ctypes
import subprocess
import threading
from pathlib import Path

import numpy as np

_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None
_TRIED = False


def _build_and_load() -> ctypes.CDLL | None:
    src = Path(__file__).parent / "resize.cc"
    out = Path(__file__).parent / "_resize.so"
    if not out.exists() or out.stat().st_mtime < src.stat().st_mtime:
        cmd = [
            "g++", "-O3", "-march=native", "-shared", "-fPIC",
            "-o", str(out), str(src),
        ]
        try:
            subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        except (OSError, subprocess.SubprocessError):
            return None
    lib = ctypes.CDLL(str(out))
    lib.resize_shorter_center_crop.restype = ctypes.c_int
    lib.resize_shorter_center_crop.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
    ]
    lib.resize_batch.restype = ctypes.c_int
    lib.resize_batch.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.c_int, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
    ]
    return lib


def get_lib() -> ctypes.CDLL | None:
    global _LIB, _TRIED
    if _LIB is None and not _TRIED:
        with _LOCK:
            if _LIB is None and not _TRIED:
                _LIB = _build_and_load()
                _TRIED = True
    return _LIB


def native_available() -> bool:
    return get_lib() is not None


def resize_center_crop(img: np.ndarray, out_size: int) -> np.ndarray:
    """Aspect-preserving shorter-side resize + center crop (uint8 HWC).

    Uses the C++ core when available, NumPy bilinear otherwise.
    """
    assert img.dtype == np.uint8 and img.ndim == 3 and img.shape[2] == 3
    lib = get_lib()
    if lib is not None:
        src = np.ascontiguousarray(img)
        dst = np.empty((out_size, out_size, 3), np.uint8)
        rc = lib.resize_shorter_center_crop(
            src.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            src.shape[0],
            src.shape[1],
            dst.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            out_size,
        )
        if rc == 0:
            return dst
    return _numpy_resize_center_crop(img, out_size)


def _numpy_resize_center_crop(img: np.ndarray, out_size: int) -> np.ndarray:
    """Fallback: PIL's own antialiased bilinear (same semantics as the
    native core)."""
    from PIL import Image

    h, w = img.shape[:2]
    scale = out_size / min(h, w)
    h_r = max(out_size, round(h * scale))
    w_r = max(out_size, round(w * scale))
    pil = Image.fromarray(img).resize((w_r, h_r), Image.BILINEAR)
    top = (h_r - out_size) // 2
    left = (w_r - out_size) // 2
    return np.asarray(
        pil.crop((left, top, left + out_size, top + out_size)), np.uint8
    )
