"""Native C++ meshing backend, loaded with ctypes (counterpart of
dnsplatter_tpu/native).

`meshing.cpp` is the port's own copy of the JAX package's source. It
compiles with g++ on first use into
`dnsplatter_torch/_build/libmeshing-<hash>.so` (the hash covers the source
and the flags, so an edited source rebuilds), never next to the JAX
package's library. `marching_tetrahedra_native` returns None when the build
failed; `mesh/marching.py` then falls back to numpy under `backend="auto"`
and raises under `backend="native"`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parent / "meshing.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
GXX_FLAGS = ("-O3", "-shared", "-fPIC")

_LIB: Optional[ctypes.CDLL] = None
_ERROR: Optional[str] = None


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(GXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libmeshing-{digest[:16]}.so"


def _build_and_load() -> Optional[ctypes.CDLL]:
    """The library, built on first use; None (and `build_error()` says
    why) if g++ is missing or fails."""
    global _LIB, _ERROR
    if _LIB is not None or _ERROR is not None:
        return _LIB
    out = library_path()
    try:
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            subprocess.run(["g++", *GXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                           check=True, capture_output=True, text=True)
            os.replace(tmp, out)  # atomic: a concurrent build never sees half
        lib = ctypes.CDLL(str(out))
    except subprocess.CalledProcessError as exc:
        _ERROR = f"g++ exit {exc.returncode}: {exc.stderr}"
        return None
    except OSError as exc:
        _ERROR = str(exc)
        return None
    lib.mt_run.restype = ctypes.c_void_p
    lib.mt_run.argtypes = [ctypes.POINTER(ctypes.c_float), ctypes.c_int,
                           ctypes.c_int, ctypes.c_int, ctypes.c_float]
    lib.mt_num_verts.restype = ctypes.c_int64
    lib.mt_num_verts.argtypes = [ctypes.c_void_p]
    lib.mt_num_faces.restype = ctypes.c_int64
    lib.mt_num_faces.argtypes = [ctypes.c_void_p]
    lib.mt_copy.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
                            ctypes.POINTER(ctypes.c_int32)]
    lib.mt_free.argtypes = [ctypes.c_void_p]
    _LIB = lib
    return _LIB


def available() -> bool:
    return _build_and_load() is not None


def build_error() -> Optional[str]:
    """Why the library could not be built (None if it was, or has not been
    tried)."""
    return _ERROR


def marching_tetrahedra_native(field: np.ndarray, level: float = 0.0
                               ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """C++ marching tetrahedra; None when the library is unavailable."""
    lib = _build_and_load()
    if lib is None:
        return None
    f = np.ascontiguousarray(field, np.float32)
    nx, ny, nz = f.shape
    h = lib.mt_run(f.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                   nx, ny, nz, ctypes.c_float(level))
    try:
        nv = lib.mt_num_verts(h)
        nf = lib.mt_num_faces(h)
        verts = np.empty((nv, 3), np.float32)
        faces = np.empty((nf, 3), np.int32)
        if nv:
            lib.mt_copy(h,
                        verts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                        faces.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        return verts, faces
    finally:
        lib.mt_free(h)
