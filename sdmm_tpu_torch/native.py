"""ctypes wrappers of the native host libraries: the OBJ parser
``native/mesh_loader.cpp`` and the median-split BVH builder
``native/bvh_builder.cpp`` (port of sdmm_tpu/native.py).

The sources sit beside both packages. At first use each is compiled with
``g++ -O3 -fPIC -std=c++17 -shared`` into ``build/native/`` at the root of
the checkout, keyed by a hash of its source and the flags, then loaded with
``ctypes``. A failed build or load raises: the Python parser
(``scene/shapes.load_obj(..., native=False)``) and the numpy BVH build
(``render/bvh.build_bvh``) run in their place only when the caller asks,
or when SDMM_TPU_NO_NATIVE is set (``disabled``), as in the reference.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
SOURCES = {"mesh_loader": ROOT / "native" / "mesh_loader.cpp",
           "bvh_builder": ROOT / "native" / "bvh_builder.cpp"}
BUILD_DIR = ROOT / "build" / "native"
CXX = ["g++"]
CXX_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-shared"]

_lib: ctypes.CDLL | None = None  # the parser
_bvh_lib: ctypes.CDLL | None = None


def disabled() -> bool:
    """SDMM_TPU_NO_NATIVE (any non-empty value) asks for the Python
    parser and the numpy BVH build."""
    return bool(os.environ.get("SDMM_TPU_NO_NATIVE"))


def library_path(name: str = "mesh_loader") -> Path:
    """The library of ``native/<name>.cpp``, keyed by its source and the
    flags."""
    h = hashlib.sha256(SOURCES[name].read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _build(name: str) -> ctypes.CDLL:
    out = library_path(name)
    src = SOURCES[name]
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        try:
            res = subprocess.run([*CXX, *CXX_FLAGS, "-o", str(tmp),
                                  str(src)],
                                 capture_output=True, text=True, timeout=300)
        except OSError as exc:
            raise RuntimeError(f"cannot build {src.name}: {exc}") from exc
        if res.returncode != 0:
            raise RuntimeError(f"building {src.name} failed (rc "
                               f"{res.returncode}):\n{res.stderr}")
        os.replace(tmp, out)
    try:
        return ctypes.CDLL(str(out))
    except OSError as exc:
        raise RuntimeError(f"cannot load {out}: {exc}") from exc


def load() -> ctypes.CDLL:
    """The loaded parser library, compiled first if needed; raises
    ``RuntimeError`` if it cannot be built or loaded."""
    global _lib
    if _lib is not None:
        return _lib
    lib = _build("mesh_loader")
    lib.obj_load.restype = ctypes.c_int
    lib.obj_load.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_void_p),
                             ctypes.POINTER(ctypes.c_int64)]
    lib.obj_copy.restype = None
    lib.obj_copy.argtypes = [ctypes.c_void_p] * 4
    lib.obj_free.restype = None
    lib.obj_free.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def load_bvh() -> ctypes.CDLL:
    """The loaded BVH builder library, compiled first if needed; raises
    ``RuntimeError`` if it cannot be built or loaded."""
    global _bvh_lib
    if _bvh_lib is not None:
        return _bvh_lib
    lib = _build("bvh_builder")
    lib.bvh_build.restype = ctypes.c_int
    lib.bvh_build.argtypes = [ctypes.c_void_p, ctypes.c_int32,
                              ctypes.c_int32] + [ctypes.c_void_p] * 8
    _bvh_lib = lib
    return lib


def bvh_build_native(verts: np.ndarray, leaf_size: int = 4) -> dict:
    """Native median-split BVH over [T, 3, 3] triangle vertices (T > 0),
    in ``render/bvh.build_bvh``'s layout: lo/hi [M, 3], leaf_start [M]
    (-1 inner), leaf_count [M], miss [M], perm [T'] (-1 padding)."""
    lib = load_bvh()
    verts = np.ascontiguousarray(verts, dtype=np.float32)
    n = len(verts)
    if n == 0:
        raise ValueError("bvh_build_native: no triangles")
    max_nodes = 2 * n + 2
    node_lo = np.empty((max_nodes, 3), np.float32)
    node_hi = np.empty((max_nodes, 3), np.float32)
    leaf_start = np.empty(max_nodes, np.int32)
    leaf_count = np.empty(max_nodes, np.int32)
    miss = np.empty(max_nodes, np.int32)
    perm = np.empty(n + max_nodes * leaf_size, np.int32)
    n_nodes = ctypes.c_int32(0)
    n_perm = ctypes.c_int32(0)
    rc = lib.bvh_build(verts.ctypes.data, n, leaf_size, node_lo.ctypes.data,
                       node_hi.ctypes.data, leaf_start.ctypes.data,
                       leaf_count.ctypes.data, miss.ctypes.data,
                       perm.ctypes.data, ctypes.addressof(n_nodes),
                       ctypes.addressof(n_perm))
    if rc != 0:
        raise RuntimeError(f"bvh_build failed (rc {rc})")
    m = n_nodes.value
    return {"lo": node_lo[:m].copy(), "hi": node_hi[:m].copy(),
            "leaf_start": leaf_start[:m].copy(),
            "leaf_count": leaf_count[:m].copy(), "miss": miss[:m].copy(),
            "perm": perm[:n_perm.value].copy()}


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
