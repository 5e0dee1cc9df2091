"""Native C++/OpenMP host runtime for the port's planners, bound via ctypes.

The port plans on the host exactly as the JAX package does. Its C++
source, ``src/host_runtime.cpp`` beside this file (task boxes, uvw
bounds, the two-pass packed bucket planner, the plan digest, the rows'
sort by w and the prefix sum), is the
port's own copy of the JAX package's ``native/src/host_runtime.cpp``,
byte for byte (a test holds the two equal), so both packages produce
byte-identical plans while the port reads nothing of the JAX package.

The library is built with ``g++ -O3 -fopenmp`` on first use into
``_build/`` beside this file, keyed by a hash of the source. A host
compiler is always present where the port's CUDA kernels build (``nvcc``
needs one), so there is no NumPy fallback: a failed build raises.
"""

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Tuple

import numpy as np

from ..utility.errors import SdpRuntimeError

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src",
                    "host_runtime.cpp")
_BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "_build")
_LOCK = threading.Lock()
_LIB = None

_i64 = ctypes.c_int64
_dbl = ctypes.c_double
_p_dbl = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
_p_f32 = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
_p_i32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_p_i64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_p_u8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")


def _build_and_load() -> ctypes.CDLL:
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    os.makedirs(_BUILD_DIR, exist_ok=True)
    so_path = os.path.join(_BUILD_DIR, f"host_runtime_{digest}.so")
    if not os.path.exists(so_path):
        tmp = so_path + f".tmp{os.getpid()}"
        cmd = ["g++", "-O3", "-fopenmp", "-shared", "-fPIC",
               "-std=c++17", _SRC, "-o", tmp]
        try:
            subprocess.run(cmd, check=True, capture_output=True,
                           timeout=300)
        except (OSError, subprocess.SubprocessError) as exc:
            detail = getattr(exc, "stderr", b"") or b""
            raise SdpRuntimeError(
                f"building the host runtime failed ({' '.join(cmd)}): "
                f"{exc} {detail.decode(errors='replace')}") from exc
        os.replace(tmp, so_path)
    lib = ctypes.CDLL(so_path)

    lib.sdp_tpu_uvw_bounds.argtypes = [
        _p_dbl, _i64, _dbl, _dbl, _p_i32, _p_i32, _p_dbl, _p_dbl]
    lib.sdp_tpu_uvw_bounds.restype = None
    lib.sdp_tpu_plan_wstack.argtypes = [
        _p_dbl, _i64, _dbl, _dbl, _i64, _dbl, _dbl,
        _i64, _i64, _i64, _i64, _i64, _i64, _p_i64, _p_dbl, _p_dbl]
    lib.sdp_tpu_plan_wstack.restype = None
    lib.sdp_tpu_packed_buckets.argtypes = [
        _p_dbl, _i64, _dbl, _dbl, _i64,
        _dbl, _dbl, _dbl, _dbl,
        _i64, _i64, _i64, _i64, _i64,
        _p_i64, _p_i64, _p_i64, _p_i64,
        _i64, _i64, _i64,
        _p_i64, _p_i64]
    lib.sdp_tpu_packed_buckets.restype = _i64
    lib.sdp_tpu_packed_fill.argtypes = [
        _p_dbl, _i64, _dbl, _dbl, _i64,
        _dbl, _dbl, _dbl, _dbl,
        _i64, _i64, _i64, _i64, _i64,
        _p_i64, _p_i64, _p_i64,
        _p_i64, _p_i64, _i64,
        _p_dbl, _p_dbl,
        _p_i64, _p_u8, _p_i32, _p_i32,
        _p_f32, _p_f32, _p_f32,
        _p_i32, _p_i32, _p_i32]
    lib.sdp_tpu_packed_fill.restype = None
    lib.sdp_tpu_packed_tasks.argtypes = [
        _p_dbl, _i64, _dbl, _dbl, _i64, _dbl, _dbl, _i64,
        _p_i64, _p_i64, _p_dbl, _p_dbl]
    lib.sdp_tpu_packed_tasks.restype = _i64
    lib.sdp_tpu_hash64.argtypes = [_p_u8, _i64, ctypes.c_uint64]
    lib.sdp_tpu_hash64.restype = ctypes.c_uint64
    lib.sdp_tpu_sort_rows_by_w.argtypes = [_p_dbl, _i64, _p_i64]
    lib.sdp_tpu_sort_rows_by_w.restype = None
    lib.sdp_tpu_prefix_sum.argtypes = [_p_i64, _i64, _p_i64]
    lib.sdp_tpu_prefix_sum.restype = None
    return lib


def _get_lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        with _LOCK:
            if _LIB is None:
                _LIB = _build_and_load()
    return _LIB


def available() -> bool:
    """True once the host runtime is built and loaded. There is no
    NumPy fallback: a failed build raises :class:`SdpRuntimeError`."""
    return _get_lib() is not None


def uvw_bounds(uvw, freq0_hz: float, dfreq_hz: float, start_chs,
               end_chs) -> Tuple[np.ndarray, np.ndarray]:
    """Scaled (u, v, w) minima and maxima over the given channel ranges."""
    uvw = np.ascontiguousarray(uvw, np.float64)
    start_chs = np.ascontiguousarray(start_chs, np.int32)
    end_chs = np.ascontiguousarray(end_chs, np.int32)
    lo = np.empty(3)
    hi = np.empty(3)
    _get_lib().sdp_tpu_uvw_bounds(uvw, uvw.shape[0], freq0_hz, dfreq_hz,
                                  start_chs, end_chs, lo, hi)
    return lo, hi


def plan_wstack_boxes(uvw, freq0_hz: float, dfreq_hz: float,
                      num_chan: int, eff_sg_dist: float,
                      w_stack_dist: float, iu_range, iv_range, iw_range
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Counts and scaled-w bounds for every (iw, iu, iv) box, each
    shaped [n_iw, n_iu, n_iv]."""
    min_iu, max_iu = iu_range
    min_iv, max_iv = iv_range
    min_iw, max_iw = iw_range
    n_iu = max_iu - min_iu + 1
    n_iv = max_iv - min_iv + 1
    n_iw = max_iw - min_iw + 1
    uvw = np.ascontiguousarray(uvw, np.float64)
    counts = np.empty(n_iw * n_iu * n_iv, np.int64)
    wmin = np.empty(counts.shape, np.float64)
    wmax = np.empty_like(wmin)
    _get_lib().sdp_tpu_plan_wstack(
        uvw, uvw.shape[0], freq0_hz, dfreq_hz, num_chan, eff_sg_dist,
        w_stack_dist, min_iu, n_iu, min_iv, n_iv, min_iw, n_iw,
        counts, wmin, wmax)
    shape = (n_iw, n_iu, n_iv)
    return counts.reshape(shape), wmin.reshape(shape), wmax.reshape(shape)


def packed_tasks(uvw, freq0_hz: float, dfreq_hz: float, num_chan: int,
                 eff_sg_dist: float, w_stack_dist: float):
    """Task enumeration for the packed planner.

    Returns (task_id [rows*chan], boxes [T, 3] as (biw, biu, biv),
    wmin_t, wmax_t) with tasks in ascending packed-key order.
    """
    uvw = np.ascontiguousarray(uvw, np.float64)
    num_rows = uvw.shape[0]
    max_tasks = 1 << 20
    task_id = np.empty(num_rows * num_chan, np.int64)
    keys = np.empty(max_tasks, np.int64)
    wmin = np.empty(max_tasks, np.float64)
    wmax = np.empty(max_tasks, np.float64)
    n = int(_get_lib().sdp_tpu_packed_tasks(
        uvw, num_rows, freq0_hz, dfreq_hz, num_chan, eff_sg_dist,
        w_stack_dist, max_tasks, task_id, keys, wmin, wmax))
    if n < 0:
        raise SdpRuntimeError(
            f"packed plan: more than {max_tasks} (w-plane, sub-grid) tasks")
    keys = keys[:n]
    span = 1 << 20
    boxes = np.stack([keys // (span * span) - span // 2,
                      (keys // span) % span - span // 2,
                      keys % span - span // 2], axis=1)
    return task_id, boxes, wmin[:n].copy(), wmax[:n].copy()


def packed_plan_arrays(uvw, freq0_hz, dfreq_hz, num_chan, eff_sg_dist,
                       theta, w_step, height, ov, w_ov, sgs, support,
                       w_support, task_id, first_t, off_w_t,
                       num_planes_t, num_slabs, num_octets, block_v,
                       uv_table, w_table):
    """The two-pass packed-ingest planner (JAX native/__init__.py:234):
    per-visibility bucket ids and bucket counts, the padding of each
    bucket to ``block_v`` (``None``: chosen by
    ``parallel.packed._auto_block_v``), then the stable placement of every
    visibility into its padded slot with the tap-table fills. Returns the
    padded sorted-stream arrays (``sort_index``, ``valid``, ``u_off``,
    ``iv0``, ``uk``, ``vk``, ``wk``, ``u_frac``, ``v_frac``, ``w_row``)
    with the bucket ``counts``, their ``padded`` sizes, the stream's
    ``total`` and ``block_v``. Raises :class:`SdpRuntimeError` on the
    processed-visibility invariant (sdp_grid_wstack_wtower.cpp:442-448).
    """
    lib = _get_lib()
    uvw = np.ascontiguousarray(uvw, np.float64)
    task_id = np.ascontiguousarray(task_id, np.int64)
    first_t = np.ascontiguousarray(first_t, np.int64)
    off_w_t = np.ascontiguousarray(off_w_t, np.int64)
    num_planes_t = np.ascontiguousarray(num_planes_t, np.int64)
    uv_table = np.ascontiguousarray(uv_table, np.float64)
    w_table = np.ascontiguousarray(w_table, np.float64)
    num_rows = uvw.shape[0]
    num_vis = num_rows * num_chan
    num_buckets = int(first_t.shape[0]) * num_slabs * num_octets

    bucket = np.empty(num_vis, np.int64)
    counts = np.empty(num_buckets, np.int64)
    bad = lib.sdp_tpu_packed_buckets(
        uvw, num_rows, freq0_hz, dfreq_hz, num_chan,
        eff_sg_dist, theta, w_step, height,
        ov, w_ov, sgs, support, w_support,
        task_id, first_t, off_w_t, num_planes_t,
        num_slabs, num_octets, num_buckets, bucket, counts)
    if bad:
        raise SdpRuntimeError(
            f"packed plan: {int(bad)} of {num_vis} visibilities fall "
            "outside their task's w-tower range")

    if block_v is None:
        from ..parallel.packed import _auto_block_v

        block_v = _auto_block_v(counts)
    padded = -(-counts // block_v) * block_v            # 0 stays 0
    pad_off = prefix_sum(padded)
    total = int(pad_off[-1])
    # np.empty: the fill writes every valid slot and zeroes pad tails.
    out = dict(sort_index=np.empty(total, np.int64),
               valid=np.empty(total, np.uint8),
               u_off=np.empty(total, np.int32),
               iv0=np.empty(total, np.int32),
               uk=np.empty((total, support), np.float32),
               vk=np.empty((total, support), np.float32),
               wk=np.empty((total, w_support), np.float32),
               u_frac=np.empty(total, np.int32),
               v_frac=np.empty(total, np.int32),
               w_row=np.empty(total, np.int32))
    lib.sdp_tpu_packed_fill(
        uvw, num_rows, freq0_hz, dfreq_hz, num_chan,
        eff_sg_dist, theta, w_step, height,
        ov, w_ov, sgs, support, w_support,
        task_id, first_t, off_w_t,
        bucket, pad_off, num_buckets,
        uv_table, w_table,
        out["sort_index"], out["valid"], out["u_off"], out["iv0"],
        out["uk"], out["vk"], out["wk"],
        out["u_frac"], out["v_frac"], out["w_row"])
    out["valid"] = out["valid"].astype(bool)
    out.update(counts=counts, padded=padded, total=total, block_v=block_v)
    return out


def sort_rows_by_w(uvw) -> np.ndarray:
    """Stable argsort of the rows by w (int64): the host bucket sort that
    gives the device kernels w-locality."""
    uvw = np.ascontiguousarray(uvw, np.float64)
    perm = np.empty(uvw.shape[0], np.int64)
    _get_lib().sdp_tpu_sort_rows_by_w(uvw, uvw.shape[0], perm)
    return perm


def prefix_sum(counts) -> np.ndarray:
    """Exclusive prefix sum with the total appended (int64, length
    n + 1)."""
    counts = np.ascontiguousarray(counts, np.int64).reshape(-1)
    out = np.empty(counts.size + 1, np.int64)
    _get_lib().sdp_tpu_prefix_sum(counts, counts.size, out)
    return out


def hash_arrays(arrays) -> str:
    """Chained 64-bit content digest over a sequence of ndarrays (the
    packed plan's cache identity)."""
    lib = _get_lib()
    acc = 14695981039346656037
    for a in arrays:
        buf = np.ascontiguousarray(a).view(np.uint8).reshape(-1)
        acc = int(lib.sdp_tpu_hash64(buf, buf.size,
                                     ctypes.c_uint64(acc).value))
    return f"fnv64:{acc:016x}"


__all__ = [
    "available",
    "hash_arrays",
    "packed_plan_arrays",
    "packed_tasks",
    "plan_wstack_boxes",
    "prefix_sum",
    "sort_rows_by_w",
    "uvw_bounds",
]
