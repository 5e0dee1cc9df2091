"""Build and load the port's CUDA kernels (nvcc + ctypes).

The sources under ``csrc/`` have a plain C interface. On first use they
are compiled with ``nvcc`` for ``sm_90a`` into one shared library in
``_build/`` beside this file (git-ignored), keyed by a hash of the
sources and flags, and loaded with ctypes. Nothing is compiled when the
module is imported: :func:`load` runs only from a wrapper that is about
to launch a kernel on a CUDA tensor, so CPU-only hosts never need
``nvcc``.
"""

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

from ..utility.errors import SdpRuntimeError

_HERE = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_LIB = None
build_info = {"seconds": None, "log": "", "path": None}


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if cand and os.path.isfile(cand):
            return cand
    raise SdpRuntimeError(
        "nvcc not found (CUDA_HOME, /usr/local/cuda/bin, PATH): the "
        "CUDA kernels cannot be built")


def _sources():
    return sorted(glob.glob(os.path.join(_CSRC, "*.cu"))
                  + glob.glob(os.path.join(_CSRC, "*.cuh")))


def _build() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources():
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + f.read())
    os.makedirs(BUILD_DIR, exist_ok=True)
    so_path = os.path.join(BUILD_DIR, f"packed_tap_{h.hexdigest()[:16]}.so")
    if os.path.exists(so_path):
        build_info.update(seconds=0.0, path=so_path)
        return so_path
    tmp = so_path + f".tmp{os.getpid()}"
    cu = [p for p in _sources() if p.endswith(".cu")]
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *cu]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise SdpRuntimeError(
            f"nvcc failed ({' '.join(cmd)}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, so_path)
    build_info.update(seconds=time.perf_counter() - t0,
                      log=proc.stdout + proc.stderr, path=so_path)
    return so_path


def load() -> ctypes.CDLL:
    """The compiled kernel library (built on first call)."""
    global _LIB
    if _LIB is None:
        with _LOCK:
            if _LIB is None:
                lib = ctypes.CDLL(_build())
                p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
                lib.sdp_torch_error_string.argtypes = [i]
                lib.sdp_torch_error_string.restype = ctypes.c_char_p
                lib.sdp_torch_grid_packed_stack.argtypes = [
                    p, p, p, i, p, p, p, i, p, p, p, i64, i, i, i, i, p, p]
                lib.sdp_torch_grid_packed_stack.restype = i
                lib.sdp_torch_degrid_stack.argtypes = [
                    p, p, p, p, i, p, p, p, i, p, i64, i, i, i, i, p, p]
                lib.sdp_torch_degrid_stack.restype = i
                _LIB = lib
    return _LIB


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if err:
        msg = lib.sdp_torch_error_string(err).decode(errors="replace")
        raise SdpRuntimeError(f"{what} launch failed: CUDA error {err} "
                              f"({msg})")
