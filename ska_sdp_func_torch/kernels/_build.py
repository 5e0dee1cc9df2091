"""Build and load the port's CUDA kernels (nvcc + ctypes).

The sources under ``csrc/`` have a plain C interface. On first use each
``.cu`` file is compiled with ``nvcc`` for ``sm_90a`` into an object,
all of them at once in parallel processes, and the objects are linked
into one shared library ``sdp_kernels_<hash>.so`` in ``_build/`` beside
this file (git-ignored), keyed by a hash of the sources and flags, and
loaded with ctypes. Nothing is compiled when the module is imported:
:func:`load` runs only from a wrapper that is about to launch a kernel
on a CUDA tensor, so CPU-only hosts never need ``nvcc``.
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
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
_TIMEOUT = 900

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


def _run_all(cmds):
    """Run the commands concurrently; raise on the first failure."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    logs, failed = [], []
    for cmd, proc in zip(cmds, procs):
        try:
            out, _ = proc.communicate(timeout=_TIMEOUT)
        except subprocess.TimeoutExpired:
            for p in procs:
                p.kill()
            raise SdpRuntimeError(f"nvcc timed out: {' '.join(cmd)}")
        logs.append(out)
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({' '.join(cmd)}):\n{out}")
    if failed:
        raise SdpRuntimeError("\n".join(failed))
    return "".join(logs)


def _build() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources():
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + f.read())
    os.makedirs(BUILD_DIR, exist_ok=True)
    tag = h.hexdigest()[:16]
    so_path = os.path.join(BUILD_DIR, f"sdp_kernels_{tag}.so")
    if os.path.exists(so_path):
        build_info.update(seconds=0.0, path=so_path)
        return so_path
    nvcc = _nvcc()
    suffix = f"{tag}.{os.getpid()}"
    cu = [p for p in _sources() if p.endswith(".cu")]
    objs = [os.path.join(BUILD_DIR, f"{os.path.basename(p)[:-3]}_{suffix}.o")
            for p in cu]
    tmp = so_path + f".tmp{os.getpid()}"
    t0 = time.perf_counter()
    log = _run_all([[nvcc, *NVCC_FLAGS, "-c", src, "-o", obj]
                    for src, obj in zip(cu, objs)])
    log += _run_all([[nvcc, "-shared", "-o", tmp, *objs]])
    os.replace(tmp, so_path)
    for obj in objs:
        os.remove(obj)
    build_info.update(seconds=time.perf_counter() - t0, log=log,
                      path=so_path)
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
                lib.sdp_torch_tower_grid.argtypes = [
                    p, p, p, p, p, p, p, i64, i, i, i, i, i, p, p]
                lib.sdp_torch_tower_grid.restype = i
                lib.sdp_torch_tower_grid_sparse.argtypes = (
                    [p] * 8 + [i64] + [i] * 6 + [p, p])
                lib.sdp_torch_tower_grid_sparse.restype = i
                lib.sdp_torch_tower_degrid.argtypes = [
                    p, p, p, p, p, p, i64, i, i, i, i, p, p]
                lib.sdp_torch_tower_degrid.restype = i
                f, pp = ctypes.c_float, ctypes.POINTER(ctypes.c_void_p)
                lib.sdp_torch_fused_grid_stack.argtypes = (
                    [p] * 13 + [i, f, f] + [i] * 7 + [p, p])
                lib.sdp_torch_fused_grid_stack.restype = i
                lib.sdp_torch_fused_degrid_stack.argtypes = (
                    [p] * 12 + [i, f, f, i64] + [i] * 6 + [p, p])
                lib.sdp_torch_fused_degrid_stack.restype = i
                lib.sdp_torch_band_grid.argtypes = [p] * 9 + [i] * 7 + [p, p]
                lib.sdp_torch_band_grid.restype = i
                lib.sdp_torch_band_grid_fused.argtypes = (
                    [p] * 8 + [i, f, f] + [i] * 7 + [p, p])
                lib.sdp_torch_band_grid_fused.restype = i
                lib.sdp_torch_band_degrid.argtypes = (
                    [p] * 9 + [i] * 3 + [i64] + [i] * 5 + [p, p])
                lib.sdp_torch_band_degrid.restype = i
                lib.sdp_torch_band_degrid_fused.argtypes = (
                    [p] * 9 + [i, f, f] + [i] * 3 + [i64] + [i] * 5
                    + [p, p])
                lib.sdp_torch_band_degrid_fused.restype = i
                lib.sdp_torch_place_stream.argtypes = [
                    p, p, pp, pp, i, i64, i, i, p]
                lib.sdp_torch_place_stream.restype = i
                lib.sdp_torch_stream_prep.argtypes = (
                    [p] * 8 + [i] * 3 + [f, f, i64] + [p] * 3 + [i, p])
                lib.sdp_torch_stream_prep.restype = i
                lib.sdp_torch_fold_windows.argtypes = [p, p] + [i] * 6 + [p, p]
                lib.sdp_torch_fold_windows.restype = i
                lib.sdp_torch_read_streams.argtypes = [pp, i, i, i, i, f, p, p]
                lib.sdp_torch_read_streams.restype = i
                lib.sdp_torch_prep_variant.argtypes = (
                    [i] + [p] * 9 + [i, f, f, i64] + [p] * 4)
                lib.sdp_torch_prep_variant.restype = i
                lib.sdp_torch_bucket_dot.argtypes = (
                    [i] + [p] * 5 + [i64, i, i, p, i64, i64, i64, p])
                lib.sdp_torch_bucket_dot.restype = i
                lib.sdp_torch_overlap.argtypes = [i, p, p, p, i, i, i, i, p, p,
                                                  p]
                lib.sdp_torch_overlap.restype = i
                _LIB = lib
    return _LIB


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if err:
        msg = lib.sdp_torch_error_string(err).decode(errors="replace")
        raise SdpRuntimeError(f"{what} launch failed: CUDA error {err} "
                              f"({msg})")
