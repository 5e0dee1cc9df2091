#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA card. Phases, one
line of output each (or a few), failing loudly on the first fault:

1. toolchain: the card's name and power limit (nvidia-smi), torch, CUDA
   and nvcc versions;
2. build: compiles the port's CUDA kernels from ``csrc/`` (timed);
3. kernels vs plain: each kernel against its plain PyTorch version on the
   card, all three precision modes, on the small test scenario and on
   the main path's plan;
4. main path at the bench scenario (512^2 image, 128^2 sub-grids,
   16384 rows x 64 channels = 1,048,576 visibilities, seed 1):
   ``plan_wstack`` -> ``plan_packed`` -> ``packed_gridder(device=cuda)``,
   ``grid_sorted``, ``degrid_sorted`` of a unit point, and two
   ``major_cycle_imager(bucketed=True)`` iterations, with the kernels'
   launch counters read around it; the kernel-path dirty image is held
   against the plain-path image on the card, and a small point-source
   solve against the CPU port;
5. times: grid, degrid and one major-cycle iteration at the bench
   scenario, and each kernel beside its plain version at the main path's
   shapes.

The line before the last is a JSON object describing each kernel; the
last line is ``{"ok": true, "device": {...}}``. Without a CUDA device the
script exits non-zero and prints no result. It imports nothing of jax.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

C_0 = 299792458.0
# bench.py's seeded main-path scenario.
IMAGE, SUBGRID = 512, 128
THETA, W_STEP, HEIGHT = 0.002, 100.0, 4.0
ROWS, CHANS = 16384, 64
# The small test scenario (tests/_torch_scenario.py).
SMALL = dict(image=256, rows=150, chans=2, w_step=50.0, seed=5)
MODES = {"highest": dict(precision="highest"),
         "high": dict(precision="high"),
         "bf16": dict(fast=True)}
TOL = 1e-5           # relative to max|reference| (f32 reordering only)
KERNEL_SOURCE = "ska_sdp_func_torch/kernels/csrc/packed_tap.cu"


def say(msg: str) -> None:
    print(msg, flush=True)


def run(cmd) -> str:
    return subprocess.run(cmd, capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip()


def rel_err(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max())


def cuda_ms(torch, fn, iters: int, warmup: int = 2) -> float:
    """Mean ms per call by CUDA events over ``iters`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def small_inputs():
    rng = np.random.default_rng(SMALL["seed"])
    uvw = rng.uniform(-1, 1, (SMALL["rows"], 3))
    uvw[:, :2] *= 0.3 * SMALL["image"] / 2 / THETA
    uvw[:, 2] *= 2.0 * SMALL["w_step"] * HEIGHT / 2
    vis = (rng.standard_normal((SMALL["rows"], SMALL["chans"]))
           + 1j * rng.standard_normal((SMALL["rows"], SMALL["chans"]))
           ).astype(np.complex64)
    return uvw, vis


def bench_inputs():
    rng = np.random.default_rng(1)
    uvw = rng.uniform(-1, 1, (ROWS, 3))
    uvw[:, :2] *= 0.45 * IMAGE / 2 / THETA
    uvw[:, 2] *= 1.5 * W_STEP * HEIGHT
    vis = (rng.standard_normal((ROWS, CHANS))
           + 1j * rng.standard_normal((ROWS, CHANS))).astype(np.complex64)
    return uvw, vis


def kernel_operands(torch, g, pplan, dev, seed):
    """Seeded stream and stack operands at the plan's shapes."""
    rng = np.random.default_rng(seed)
    vre = torch.as_tensor(rng.standard_normal(pplan.total),
                          dtype=torch.float32, device=dev)
    vim = torch.as_tensor(rng.standard_normal(pplan.total),
                          dtype=torch.float32, device=dev)
    g_p = pplan.wplan.subgrid_size
    stack = torch.as_tensor(rng.standard_normal(
        (len(pplan.tasks), 2, pplan.num_layers * (g_p + 8), g_p)),
        dtype=torch.float32, device=dev)
    grid_args = (g.t_idx, g.k_idx, g.g_idx, g.ubase, g.vband,
                 (g.wk_t, vre, vim), len(pplan.tasks), pplan.num_layers,
                 g_p, pplan.wplan.w_support)
    degrid_args = (stack, g.t_idx, g.k_idx, g.g_idx, g.ubase, g.vband_t,
                   g.wk_t, pplan.wplan.w_support)
    return grid_args, degrid_args


def check_kernels(torch, tk, PackedGridder, pplan, dev, label):
    """Each kernel against its plain version in every mode; returns the
    "high" (default) mode's absolute errors."""
    out = {}
    for mode, kw in MODES.items():
        g = PackedGridder(pplan, device=dev, **kw)
        grid_args, degrid_args = kernel_operands(torch, g, pplan, dev, 11)
        bv = pplan.block_v
        got = tk.grid_packed_stack(*grid_args, block_v=bv)
        want = tk.grid_packed_stack_reference(*grid_args, block_v=bv)
        e_grid = rel_err(got, want)
        a_grid = float((got - want).abs().max())
        got = tk.degrid_stack(*degrid_args, block_v=bv)
        want = tk.degrid_stack_reference(*degrid_args, block_v=bv)
        e_degrid = rel_err(got, want)
        a_degrid = float((got - want).abs().max())
        torch.cuda.synchronize()
        say(f"# kernels vs plain [{label}, {mode}]: grid_packed_stack "
            f"rel err {e_grid:.3e}, degrid_stack rel err {e_degrid:.3e} "
            f"(tolerance {TOL:g}; {pplan.num_blocks} blocks of "
            f"{pplan.block_v}, {len(pplan.tasks)} tasks, "
            f"{pplan.num_layers} layers)")
        if not (e_grid <= TOL and e_degrid <= TOL):
            raise SystemExit(f"kernel disagrees with its plain version "
                             f"[{label}, {mode}]")
        if mode == "high":
            out = dict(grid=a_grid, degrid=a_degrid)
        del g
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from ska_sdp_func_torch.grid_data import grid_correct_pswf
    from ska_sdp_func_torch.kernels import _build
    from ska_sdp_func_torch.kernels import packed_tap as tk
    from ska_sdp_func_torch.parallel import (
        PackedGridder,
        packed_gridder,
        plan_packed,
        plan_wstack,
    )
    from ska_sdp_func_torch.pipeline import major_cycle as mc
    from ska_sdp_func_torch.pipeline import major_cycle_imager

    # True f32 products everywhere (the plain versions are references).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    # 1. toolchain ------------------------------------------------------
    gpu = run(["nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader"]).splitlines()[0]
    say(gpu)
    say(f"# torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")
    say("# " + run([_build._nvcc(), "--version"]).splitlines()[-1])

    # 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    _build.load()
    say(f"# build: {time.perf_counter() - t0:.1f} s wall "
        f"(nvcc {_build.build_info['seconds']:.1f} s) -> "
        f"{os.path.relpath(_build.build_info['path'])}")
    for line in _build.build_info["log"].splitlines():
        if "registers" in line or "spill" in line:
            say("#   ptxas" + line.split("ptxas", 1)[-1])

    # 3. kernels vs plain ----------------------------------------------
    uvw_s, vis_s = small_inputs()
    plan_s = plan_wstack(uvw_s, C_0, C_0 / 100, SMALL["chans"],
                         SMALL["image"], SUBGRID, THETA, SMALL["w_step"],
                         support=8, w_support=4, w_tower_height=HEIGHT)
    check_kernels(torch, tk, PackedGridder,
                  plan_packed(plan_s, uvw_s, block_v=128), dev, "small")
    uvw, vis = bench_inputs()
    num_vis = ROWS * CHANS
    t0 = time.perf_counter()
    plan = plan_wstack(uvw, C_0, C_0 / (100 * CHANS), CHANS, IMAGE, SUBGRID,
                       THETA, W_STEP, support=8, w_support=4,
                       w_tower_height=HEIGHT)
    pplan = plan_packed(plan, uvw)
    plan_time = time.perf_counter() - t0
    say(f"# main plan: {len(pplan.tasks)} tasks, {pplan.num_layers} layers, "
        f"block_v {pplan.block_v}, {pplan.total} slots, "
        f"{pplan.num_blocks} blocks ({plan_time:.2f} s host)")
    abs_err = check_kernels(torch, tk, PackedGridder, pplan, dev, "main")

    # 4. main path -------------------------------------------------------
    g = packed_gridder(pplan, device=dev)
    torch.cuda.synchronize()
    tk.reset_launch_counts()
    vre, vim = g.sort(vis)
    img = g.grid_sorted(vre, vim)
    model = torch.zeros((IMAGE, IMAGE), dtype=torch.float32, device=dev)
    model[300, 200] = 1.0
    pred = g.degrid_sorted(model)
    res = major_cycle_imager(plan, vis, uvw, n_major=2, bucketed=True,
                             device=dev)
    torch.cuda.synchronize()
    launches = tk.launch_counts()
    say(f"# main path launches: {json.dumps(launches)}")
    if min(launches.values()) < 1:
        raise SystemExit("a kernel of the main path was never launched")
    for name, t in (("dirty image", img), ("degrid", pred),
                    ("model", res.model), ("restored", res.restored)):
        if not bool(torch.isfinite(t).all()):
            raise SystemExit(f"{name} is not finite")
    if tuple(img.shape) != (IMAGE, IMAGE) or pred.shape[0] != pplan.total:
        raise SystemExit("main-path outputs have the wrong shape")
    # Kernel path vs plain path on the card, taper-weighted (the
    # 1/PSWF-corrected border is ill-conditioned).
    stack = tk.grid_packed_stack_reference(
        g.t_idx, g.k_idx, g.g_idx, g.ubase, g.vband, (g.wk_t, vre, vim),
        len(pplan.tasks), pplan.num_layers, SUBGRID, 4,
        block_v=pplan.block_v)
    img_plain = g._image_from_stack(stack)
    taper = 1.0 / grid_correct_pswf(
        IMAGE, THETA, W_STEP, 0.0, 0.0, 8, 4,
        torch.ones((IMAGE, IMAGE), device=dev))
    e_img = rel_err(img * taper, img_plain * taper)
    say(f"# dirty image, kernel vs plain path: taper-weighted rel err "
        f"{e_img:.3e} (tolerance {TOL:g}); degrid |vis| max "
        f"{float(pred.abs().max()):.4g}; major-cycle peaks "
        f"{res.peak_history}")
    if not e_img <= TOL:
        raise SystemExit("kernel-path image disagrees with the plain path")
    # A point source through the whole solver: card vs CPU port.
    img_pt = np.zeros((SMALL["image"], SMALL["image"]), np.float32)
    src = (SMALL["image"] // 2 + 12, SMALL["image"] // 2 - 9)
    img_pt[src] = 1.0
    vis_pt = packed_gridder(plan_packed(plan_s, uvw_s)).degrid(img_pt)
    r_gpu = major_cycle_imager(plan_s, vis_pt, uvw_s, bucketed=True,
                               device=dev)
    r_cpu = major_cycle_imager(plan_s, vis_pt, uvw_s, bucketed=True)
    e_mc = rel_err(r_gpu.model.cpu(), r_cpu.model)
    flux = float(r_gpu.model[src])
    say(f"# small point-source solve, card vs CPU: model rel err "
        f"{e_mc:.3e} (tolerance 1e-4), recovered flux {flux:.4f}")
    if not (e_mc <= 1e-4 and abs(flux - 1.0) < 0.05):
        raise SystemExit("the point-source solve disagrees")

    # 5. times -----------------------------------------------------------
    t_grid = cuda_ms(torch, lambda: g.grid_sorted(vre, vim), 10)
    t_degrid = cuda_ms(torch, lambda: g.degrid_sorted(model), 10)
    psf_pplan = plan_packed(mc.make_psf_plan(plan, uvw), uvw)
    psf = packed_gridder(psf_pplan, device=dev).grid(
        np.ones((ROWS, CHANS), np.complex64))
    peak = psf[IMAGE, IMAGE]
    border = IMAGE // 16
    psf = mc._norm_mask(psf, peak, 2 * border)
    stop = torch.zeros((), device=dev)
    state = {"model": torch.zeros((IMAGE, IMAGE), device=dev)}

    def mc_step():
        p = g.degrid_sorted(state["model"])
        rre, rim = mc._packed_residual(vre, vim, p, None)
        dirty = mc._norm_mask(g.grid_sorted(rre, rim), peak, border)
        delta, _ = mc._minor_cycle(dirty, psf, 0.1, stop, 50)
        state["model"] = state["model"] + delta

    t_mc = cuda_ms(torch, mc_step, 5, warmup=1)
    say(f"# [{gpu}] grid {num_vis / t_grid / 1e3:.2f} Mvis/s "
        f"({t_grid:.3f} ms), degrid {num_vis / t_degrid / 1e3:.2f} Mvis/s "
        f"({t_degrid:.3f} ms), major cycle {1e3 / t_mc:.3f} iters/s "
        f"({t_mc:.3f} ms; minor cycle 50 components)")

    grid_args, degrid_args = kernel_operands(torch, g, pplan, dev, 12)
    bv = pplan.block_v
    times = {}
    for name, kern, ref, args in (
            ("grid_packed_stack", tk.grid_packed_stack,
             tk.grid_packed_stack_reference, grid_args),
            ("degrid_stack", tk.degrid_stack, tk.degrid_stack_reference,
             degrid_args)):
        # Turns: plain, kernel, kernel, plain; keep the second of each.
        p1 = cuda_ms(torch, lambda: ref(*args, block_v=bv), 5)
        k1 = cuda_ms(torch, lambda: kern(*args, block_v=bv), 10)
        k2 = cuda_ms(torch, lambda: kern(*args, block_v=bv), 10)
        p2 = cuda_ms(torch, lambda: ref(*args, block_v=bv), 5)
        times[name] = (k2, p2)
        say(f"# [{gpu}] {name} at main-path shapes, 'high': kernel "
            f"{k1:.3f}/{k2:.3f} ms, plain {p1:.3f}/{p2:.3f} ms")

    kernels = [
        dict(name="grid_packed_stack", route="cuda", source=KERNEL_SOURCE,
             replaces="ska_sdp_func_tpu/kernels/packed_tap.py:249",
             launches=launches["grid_packed_stack"],
             max_abs_err=abs_err["grid"],
             ms=times["grid_packed_stack"][0],
             plain_ms=times["grid_packed_stack"][1]),
        dict(name="degrid_stack", route="cuda", source=KERNEL_SOURCE,
             replaces="ska_sdp_func_tpu/kernels/packed_tap.py:839",
             launches=launches["degrid_stack"],
             max_abs_err=abs_err["degrid"],
             ms=times["degrid_stack"][0],
             plain_ms=times["degrid_stack"][1]),
    ]
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
