"""ctypes binding of the repository's native C++ image loader
(``native/imgloader.cpp``, built into ``native/libimgloader.so``).

The port's copy of the part of ``dinomc_tpu/data/native_loader.py`` its
host readers use: one-image JPEG/PNG/TIFF decode with a fused resize
(``decode``), the same over a batch on a native thread pool
(``decode_batch``, the packed-corpus writer's path) and one band of a TIFF
as raw float32 values (``read_band``, the multispectral reader's). The
library is built with ``make -C native`` at first use when it is missing;
callers handle ``available() == False`` (or a ``None`` result) and decode
with PIL instead.
"""

from __future__ import annotations

import ctypes
import functools
import os
import subprocess
from typing import Optional, Sequence

import numpy as np

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_NATIVE_DIR = os.path.join(_REPO_ROOT, "native")
_SO_PATH = os.path.join(_NATIVE_DIR, "libimgloader.so")


@functools.cache
def _load() -> Optional[ctypes.CDLL]:
    if not os.path.exists(_SO_PATH):
        try:
            subprocess.run(["make", "-C", _NATIVE_DIR], check=True, capture_output=True, timeout=120)
        except Exception:
            return None
    try:
        lib = ctypes.CDLL(_SO_PATH)
    except OSError:
        return None
    lib.imgloader_decode.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
    ]
    lib.imgloader_decode.restype = ctypes.c_int
    lib.imgloader_decode_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.POINTER(ctypes.c_int),
    ]
    lib.imgloader_decode_batch.restype = ctypes.c_int
    lib.imgloader_band_size.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
    ]
    lib.imgloader_band_size.restype = ctypes.c_int
    lib.imgloader_read_band.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
    ]
    lib.imgloader_read_band.restype = ctypes.c_int
    return lib


def available() -> bool:
    return _load() is not None


def decode(path: str, out_h: int, out_w: int) -> Optional[np.ndarray]:
    """Decode one image to (out_h, out_w, 3) uint8, or None on failure."""
    lib = _load()
    if lib is None:
        return None
    out = np.empty((out_h, out_w, 3), np.uint8)
    rc = lib.imgloader_decode(path.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                              out_h, out_w)
    return out if rc == 0 else None


def decode_batch(
    paths: Sequence[str], out_h: int, out_w: int, n_threads: int = 8
) -> Optional[np.ndarray]:
    """Decode many images to (N, out_h, out_w, 3) uint8 on a native thread
    pool; None if the library is unavailable or any file failed."""
    lib = _load()
    if lib is None:
        return None
    count = len(paths)
    out = np.empty((count, out_h, out_w, 3), np.uint8)
    status = np.zeros(count, np.int32)
    arr = (ctypes.c_char_p * count)(*[p.encode() for p in paths])
    failures = lib.imgloader_decode_batch(
        arr, count, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), out_h, out_w,
        n_threads, status.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
    )
    return out if failures == 0 else None


def read_band(path: str, band: int = 1) -> Optional[np.ndarray]:
    """One band (1-indexed) of a TIFF as raw float32 DN values (H, W): the
    rasterio-free multispectral path (Sentinel-2 uint16 GeoTIFFs). None on
    failure."""
    lib = _load()
    if lib is None:
        return None
    w, h = ctypes.c_int(), ctypes.c_int()
    if lib.imgloader_band_size(path.encode(), ctypes.byref(w), ctypes.byref(h)):
        return None
    out = np.empty((h.value, w.value), np.float32)
    rc = lib.imgloader_read_band(path.encode(), band,
                                 out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), out.size)
    return out if rc == 0 else None
