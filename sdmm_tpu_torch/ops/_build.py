"""Build and load the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` for ``sm_90a`` into ``build/kernels/<name>-<hash>.so`` at the root
of the checkout, keyed by a hash of the source, the shared headers
``csrc/*.cuh`` and the flags, then loaded with ``ctypes``. Nothing is
compiled when the package is imported: the first launch (or ``build_all``)
compiles.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
# Per-source flags: these sources round every multiply and add on their own,
# as their plain twins' separate PyTorch operations do.
EXTRA_FLAGS = {name: ["-fmad=false"]
               for name in ("bounce", "mt_sweep", "clas_cull")}

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return str(path)


def _flags(name: str) -> list[str]:
    return NVCC_FLAGS + EXTRA_FLAGS.get(name, [])


def library_path(name: str) -> Path:
    """The library of ``csrc/<name>.cu``, keyed by the source, every shared
    header ``csrc/*.cuh`` it may include, and the flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(_flags(name)).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start nvcc for ``name`` unless its library exists; returns
    (process or None, output path)."""
    out = library_path(name)
    if out.exists():
        return None, out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    log = out.with_suffix(".log").open("w")
    try:
        proc = subprocess.Popen(
            [_nvcc(), *_flags(name), "-I", str(CSRC), "-o", str(tmp),
             str(CSRC / f"{name}.cu")],
            stdout=log, stderr=subprocess.STDOUT)
    finally:
        log.close()
    return proc, out


def _finish(name: str, proc, out: Path):
    if proc is None:
        return
    rc = proc.wait()
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    if rc != 0:
        msg = out.with_suffix(".log").read_text()
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu (rc {rc}):\n{msg}")
    os.replace(tmp, out)


def build_all(names) -> dict[str, str]:
    """Compile every named kernel, one nvcc per source, all started
    together. Returns each kernel's compiler report (``-Xptxas -v``)."""
    started = {n: _start(n) for n in names}
    for n, (proc, out) in started.items():
        _finish(n, proc, out)
    return {n: out.with_suffix(".log").read_text()
            if out.with_suffix(".log").exists() else ""
            for n, (_, out) in started.items()}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        proc, out = _start(name)
        _finish(name, proc, out)
        lib = ctypes.CDLL(str(out))
        _loaded[name] = lib
    return lib


def check_inputs(kernel: str, specs):
    """Raise ``ValueError`` unless every ``(name, tensor, shape, dtype)`` of
    ``specs`` is a contiguous CUDA tensor of that dtype and shape on the
    first one's device."""
    dev = specs[0][1].device
    if dev.type != "cuda":
        raise ValueError(f"{kernel}: tensors on {dev}: the kernel takes CUDA "
                         "tensors, the plain twin CPU tensors")
    for name, t, shape, dt in specs:
        if (t.device != dev or t.dtype != dt or tuple(t.shape) != shape
                or not t.is_contiguous()):
            raise ValueError(
                f"{kernel}: {name} must be a contiguous {dt} tensor of shape "
                f"{shape} on {dev}, got {t.dtype} {tuple(t.shape)} on "
                f"{t.device}")


def check(rc: int, name: str):
    """Raise on a non-zero ``cudaError_t`` returned by a launch function."""
    if rc != 0:
        raise RuntimeError(f"CUDA launch of {name} failed: cudaError {rc}")


def kernel_info(name: str, symbol: str, kernels,
                arg: int = 0) -> dict[str, dict[str, int]]:
    """Per kernel of ``csrc/<name>.cu``: registers, spilled (local) bytes,
    static shared bytes and resident blocks an SM, from the source's
    ``symbol(int which, int arg, int* info)``, which fills four ints for
    kernel number ``which`` of ``kernels`` (``arg``: what the launch's
    dynamic shared memory depends on, if anything)."""
    fn = getattr(load(name), symbol)
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = {}
    for which, kernel in enumerate(kernels):
        info = (ctypes.c_int * 4)()
        check(fn(which, arg, ctypes.cast(info, ctypes.c_void_p)), symbol)
        out[kernel] = dict(zip(("registers", "spill_bytes", "shared_bytes",
                                "blocks_per_sm"), info))
    return out
