"""ctypes wrapper of the native OBJ parser, ``native/mesh_loader.cpp``
(port of the OBJ half of sdmm_tpu/native.py).

The source sits beside both packages. At first use it is compiled with
``g++ -O3 -fPIC -std=c++17 -shared`` into ``build/native/`` at the root of
the checkout, keyed by a hash of the source and the flags, then loaded with
``ctypes``. A failed build or load raises: the Python parser
(``scene/shapes.load_obj(..., native=False)``) runs only when the caller
asks for it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / "native" / "mesh_loader.cpp"
BUILD_DIR = ROOT / "build" / "native"
CXX = ["g++"]
CXX_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-shared"]

_lib: ctypes.CDLL | None = None


def library_path() -> Path:
    """The library of ``native/mesh_loader.cpp``, keyed by its source and
    the flags."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"mesh_loader-{h.hexdigest()[:16]}.so"


def load() -> ctypes.CDLL:
    """The loaded parser library, compiled first if needed; raises
    ``RuntimeError`` if it cannot be built or loaded."""
    global _lib
    if _lib is not None:
        return _lib
    out = library_path()
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        try:
            res = subprocess.run([*CXX, *CXX_FLAGS, "-o", str(tmp),
                                  str(SOURCE)],
                                 capture_output=True, text=True, timeout=300)
        except OSError as exc:
            raise RuntimeError(
                f"cannot build {SOURCE.name}: {exc}") from exc
        if res.returncode != 0:
            raise RuntimeError(f"building {SOURCE.name} failed (rc "
                               f"{res.returncode}):\n{res.stderr}")
        os.replace(tmp, out)
    try:
        lib = ctypes.CDLL(str(out))
    except OSError as exc:
        raise RuntimeError(f"cannot load {out}: {exc}") from exc
    lib.obj_load.restype = ctypes.c_int
    lib.obj_load.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_void_p),
                             ctypes.POINTER(ctypes.c_int64)]
    lib.obj_copy.restype = None
    lib.obj_copy.argtypes = [ctypes.c_void_p] * 4
    lib.obj_free.restype = None
    lib.obj_free.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def obj_load(path: str):
    """Parse an OBJ natively. Returns (v [T,3,3], n [T,3,3], uv [T,3,2])
    float64 arrays: fan-triangulated faces, per-corner attributes, a face
    normal where a corner has no ``vn``, zero uv where one has no ``vt``."""
    lib = load()
    handle = ctypes.c_void_p()
    n_tris = ctypes.c_int64()
    if lib.obj_load(os.fsencode(path), ctypes.byref(handle),
                    ctypes.byref(n_tris)) != 0:
        raise OSError(f"{path}: cannot open the OBJ file")
    t = int(n_tris.value)
    v = np.empty((t, 3, 3), np.float64)
    n = np.empty((t, 3, 3), np.float64)
    uv = np.empty((t, 3, 2), np.float64)
    try:
        if t:
            lib.obj_copy(handle, v.ctypes.data, n.ctypes.data, uv.ctypes.data)
    finally:
        lib.obj_free(handle)
    return v, n, uv
