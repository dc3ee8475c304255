"""ctypes bridge to the native C++ data-loader kernels (host code).

The port's own copy of ``phendiff_tpu/data/native.py``.  It builds the
repo's ``native/phendiff_native.cpp`` with ``g++`` into
``phendiff_tpu_torch/build/`` under a file name that hashes the source and
the flags, compiling to a temporary file and renaming it into place, so a
concurrent process never loads half a library.  The loader uses its
batched resize, normalise and flip, with a numpy + PIL fallback when no
compiler is available.  See the C++ source for the algorithms.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

_ROOT = Path(__file__).resolve().parents[2]
SOURCE = _ROOT / "native" / "phendiff_native.cpp"
BUILD = Path(__file__).resolve().parents[1] / "build"
FLAGS = ("-O3", "-march=native", "-ffast-math", "-shared", "-fPIC")

_lock = threading.Lock()
_lib = None
_tried = False


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(FLAGS).encode())
    return BUILD / f"libphendiff_native-{digest.hexdigest()[:16]}.so"


def _build(out: Path) -> bool:
    cxx = shutil.which("g++")
    if cxx is None or not SOURCE.exists():
        return False
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    try:
        subprocess.run([cxx, *FLAGS, "-o", str(tmp), str(SOURCE)], check=True,
                       capture_output=True, timeout=300)
        os.replace(tmp, out)  # atomic: never load half a file
        return True
    except (subprocess.SubprocessError, OSError):
        tmp.unlink(missing_ok=True)
        return False


def get_lib() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native library; None if unavailable."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not SOURCE.exists():
            return None
        path = library_path()
        if not path.exists() and not _build(path):
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError:
            return None
        lib.batch_resize_f32.argtypes = [
            ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.POINTER(ctypes.c_int), ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.POINTER(ctypes.c_int), ctypes.c_int,
        ]
        lib.resize_image_u8.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ]
        _lib = lib
        return _lib


def available() -> bool:
    return get_lib() is not None


def _as_u8_ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def batch_resize_normalize(
    imgs: List[np.ndarray],
    definition: Tuple[int, int],
    *,
    normalize: bool = True,
    flips: Optional[np.ndarray] = None,  # [n, 2] int (flip_h, flip_v)
    antialias: bool = True,
) -> np.ndarray:
    """Batch of variably sized HWC uint8 images -> [n, dh, dw, C] float32."""
    lib = get_lib()
    dh, dw = definition
    n = len(imgs)
    if n == 0:
        return np.empty((0, dh, dw, 3), dtype=np.float32)
    ch = imgs[0].shape[2]
    if lib is None:
        return np.stack([
            _fallback_resize(
                im, definition, normalize,
                bool(flips[i, 0]) if flips is not None else False,
                bool(flips[i, 1]) if flips is not None else False,
            )
            for i, im in enumerate(imgs)
        ])
    imgs = [np.ascontiguousarray(im) for im in imgs]
    ptrs = (ctypes.POINTER(ctypes.c_uint8) * n)(*[_as_u8_ptr(im) for im in imgs])
    dims = np.array([[im.shape[0], im.shape[1], im.shape[2]] for im in imgs], dtype=np.int32)
    flips_arr = (
        np.ascontiguousarray(flips, dtype=np.int32)
        if flips is not None else np.zeros((n, 2), dtype=np.int32)
    )
    out = np.empty((n, dh, dw, ch), dtype=np.float32)
    lib.batch_resize_f32(
        ptrs, dims.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), n,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), dh, dw,
        int(normalize), flips_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        int(antialias),
    )
    return out


def resize_u8(img: np.ndarray, definition: Tuple[int, int], antialias: bool = True) -> np.ndarray:
    """One HWC uint8 image -> [dh, dw, C] uint8, the resize rounded to the
    nearest level."""
    lib = get_lib()
    dh, dw = definition
    if lib is None:
        f = _fallback_resize(img, definition, False, False, False)
        return np.clip(f + 0.5, 0, 255).astype(np.uint8)
    img = np.ascontiguousarray(img)
    sh, sw, ch = img.shape
    out = np.empty((dh, dw, ch), dtype=np.uint8)
    lib.resize_image_u8(_as_u8_ptr(img), sh, sw, ch, _as_u8_ptr(out), dh, dw, int(antialias))
    return out


def _fallback_resize(img, definition, normalize, flip_h, flip_v):
    from PIL import Image

    pil = Image.fromarray(img).resize((definition[1], definition[0]), Image.BILINEAR)
    arr = np.asarray(pil, dtype=np.float32)
    if flip_h:
        arr = arr[:, ::-1]
    if flip_v:
        arr = arr[::-1]
    if normalize:
        arr = arr / 127.5 - 1.0
    return np.ascontiguousarray(arr)
