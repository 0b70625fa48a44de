"""ctypes binding of the repository's native C++ image loader
(``native/imgloader.cpp``, built into ``native/libimgloader.so``).

The port's copy of the part of ``dinomc_tpu/data/native_loader.py`` its
host readers use: one-image JPEG/PNG/TIFF decode with a fused resize. The
library is built with ``make -C native`` at first use when it is missing;
callers handle ``available() == False`` and decode with PIL instead.
"""

from __future__ import annotations

import ctypes
import functools
import os
import subprocess
from typing import Optional

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
