"""ctypes wrapper for the native (C++) frame loader.

Port of `handsonvlm_tpu/data/native_loader.py`. Builds
`_native/frame_loader.cpp` (libjpeg) with g++ on first use into
`build/handsonvlm_torch/` (data/native_build.py) and exposes
`load_frames_native`. Where the toolchain or libjpeg is missing, or a frame
fails to decode, `load_frames` decodes through the PIL pipeline in
data/video_io.py, so every caller can use `load_frames(paths)`
unconditionally. `DECODED` counts the frames each decoder returned, so a
caller can tell which one ran.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Sequence, Tuple

import numpy as np

from handsonvlm_torch.data.native_build import build_native

_lock = threading.Lock()
_lib = None
_tried = False
# frames returned by each decoder since import (or since a caller reset it)
DECODED = {"native": 0, "pil": 0}


def get_lib():
    """Load (building if needed) the native library, or None."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = build_native("frame_loader.cpp", ["-O3", "-march=native"],
                            libs=["-ljpeg", "-lpthread"])
        if path is None:
            return None
        lib = ctypes.CDLL(str(path))
        lib.decode_preprocess_batch.restype = ctypes.c_int
        lib.decode_preprocess_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_ubyte),
        ]
        _lib = lib
        return _lib


def native_available() -> bool:
    return get_lib() is not None


def load_frames_native(
    paths: Sequence[str], size: int = 224, num_threads: int = 0
) -> Tuple[np.ndarray, np.ndarray]:
    """JPEG paths -> ((N,3,size,size) float32, ok (N,) bool)."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native loader unavailable")
    n = len(paths)
    out = np.zeros((n, 3, size, size), np.float32)
    ok = np.zeros((n,), np.uint8)
    c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    lib.decode_preprocess_batch(
        c_paths, n,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        size, num_threads,
        ok.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
    )
    return out, ok.astype(bool)


def load_frames(paths: Sequence[str], size: int = 224) -> np.ndarray:
    """Native fast path with PIL fallback (API used by datasets)."""
    from handsonvlm_torch.data.video_io import load_image

    if not native_available():
        DECODED["pil"] += len(paths)
        return np.stack([load_image(p, cache_dir=None, size=size) for p in paths], axis=0)
    out, ok = load_frames_native(paths, size)
    DECODED["native"] += int(ok.sum())
    for i in np.nonzero(~ok)[0]:  # decode any failed frames with PIL
        out[i] = load_image(paths[i], cache_dir=None, size=size)
        DECODED["pil"] += 1
    return out
