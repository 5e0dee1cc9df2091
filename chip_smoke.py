#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py
    (cd CHECKOUT && python3 /path/to/chip_smoke.py --packed-times)
    (cd CHECKOUT && python3 /path/to/chip_smoke.py --predict-times)
    (cd CHECKOUT && python3 /path/to/chip_smoke.py --ingest-times)
    (cd CHECKOUT && python3 /path/to/chip_smoke.py --experiment-times)
    (cd CHECKOUT && python3 /path/to/chip_smoke.py --sparse-place-times)

Run from the repository root on a machine with a CUDA card. With
``--packed-times`` it only times the packed path (K1/K2 in "high" and
"bf16", ``grid_sorted``, ``degrid_sorted``, one major-cycle iteration;
with K1/K2's output digests and a digest of their machine code) on the
package of the working directory and prints one JSON line, so two
checkouts compare on one card in turns; ``--predict-times`` does the same
for the three predicts (the stream, non-packable and ES-FFT degrids, by
stage), the window-gather kernels K4, K11, K13 and K19 and the tap
preparation K7 (f32 and bf16; with a digest of each output, equal where
two checkouts' results are bit-equal), and ``--ingest-times`` for the
ingests (the stream's ``accumulate``, the non-packable one in f32 and
fast, the ES-FFT 3-D grid, by stage; the packed fused and compact
``grid_sorted``), the window-scatter kernels K3, K8, K12 and K18 and the
tap preparation K6 (f32 and bf16, with its output digests), and
``--experiment-times`` for the experiments' kernels P2c-P2e (every
``bucket_dot`` variant, beside ``torch.bmm`` in f32 and bf16, and
``grid_parity`` at slots 1, 2 and 4) and P1 (``read_streams`` at 6 streams
and 1, beside ATen's block sums), one JSON line a kernel with each
output's digest, and ``--sparse-place-times`` for K20 and K5 (wall, host
and device time, device operations a call and output digests; the
dense stream's plan + K5 stages with their placed arrays' digests). Phases, one line of output each (or a few), failing
loudly on the first fault:

1. toolchain: the card's name and power limit (nvidia-smi), torch, CUDA
   and nvcc versions;
2. build: compiles the port's CUDA kernels from ``csrc/`` (one nvcc per
   source, in parallel; timed), and prints the registers and spills
   ptxas reports for each instance of the window-gather kernel (K4, K11,
   K13, K19), of the window-scatter kernel (K3, K12, K8, K18) and of the
   tap preparation's kernel (K6, K7: unrolled and generic, f32 and bf16),
   of the experiments' band products (P2c-P2e, ``bucket_dot_kernel``),
   read probe (P1, ``read_streams_kernel``) and build/product probe (P2b,
   ``overlap_kernel``) and of the window fold (``fold_windows_kernel``),
   with the SASS digests of the last two, and the shared-memory atomics
   and bulk reductions in each kernel's SASS (``cuobjdump -sass``);
3. kernels vs plain: each kernel against its plain PyTorch version on the
   card: the packed kernels (K1, K2: "high" and "bf16" on the tensor
   cores over the plan's bucket runs, "highest" on the CUDA cores) and
   the fused kernels (K3, K4) in all three precision modes, the placement
   kernel (K5) bit for bit, the w-towers tap kernels (K14-K17; K16/K17
   both over a whole fallback stream of tasks, also at supports 12, 20
   and 56, and on one task), and
   the non-packable streaming
   branch's tap preparation (K6, K7) and window fold (K9 + K10, also
   with NaN in every unvisited window) with K5, K8 and K11 at its shapes,
   f32 and bf16 (K6, K7 and the fold bit for bit), each on the small
   test scenario (the non-packable kernels on 64-slot blocks) and at the
   shapes of the main paths below (K3-K11 with the very arguments the
   streaming paths pass them); K6/K7 also through their generic instance
   (other fits on window j's fields), bit for bit;
4. main paths, each driven with the launch counters set to 0 just before
   it and read just after; each path must launch its own kernels and
   none of another path's:
   a. the packed path (K1, K2) at the bench scenario (512^2 image, 128^2
      sub-grids, 16384 rows x 64 channels = 1,048,576 visibilities,
      seed 1): ``plan_wstack`` -> ``plan_packed`` ->
      ``packed_gridder(device=cuda)``, ``grid_sorted``, ``degrid_sorted``
      of a unit point and two ``major_cycle_imager(bucketed=True)``
      iterations; the kernel-path dirty image and degrid against the
      plain path on the card, and a small point-source solve against the
      CPU port; then, in a window of its own, ``packed_gridder(fast=True)``
      (bf16 K1/K2) ``grid_sorted`` and ``degrid_sorted`` against its plain
      path (and, reported, against "high");
   b. the bucketed fallback (K16, K17) at the same data with 64^2
      sub-grids (a geometry the packed path cannot take):
      ``plan_wstack`` -> ``plan_bucketed``, ``grid_all_bucketed``,
      ``degrid_all_bucketed`` of a unit point and two
      ``major_cycle_imager(bucketed=True)`` iterations on that point's
      visibilities, each grid call launching K16 and each degrid call
      K17 exactly once over all 218 tasks (the counters read around every
      call, the solver's included); each held against the same calls on
      the plain path on the card;
   c. the task drivers (K14, K15) at the same full width:
      ``grid_all_tasks``, ``degrid_all_tasks`` and a one-cycle
      ``major_cycle_imager(bucketed=False)`` solve (the default) of the
      unit point on the first SOLVE_ROWS rows, each
      timed and held against the plain path on the card, and against
      the bucketed fallback's image and visibilities; then the active
      entries of every plane the grid call grids (median, maximum) and
      of the plane K14/K15 are timed on;
   d. the sub-grid gridder (K16, K17): ``GridderWtowerUVW``
      ``degrid_subgrid`` / ``grid_subgrid`` on complex64 on a 336-row
      sub-grid scenario, with an adjointness check and against the CPU
      port;
   e. the reference-API whole-image drivers (K16, K17) at REF_ROWS bench
      rows: ``wstack_wtower_{degrid,grid}_all(engine="reference")``
      against the bucketed drivers; then a small
      ``major_cycle_imager(bucketed=False)`` point-source solve against
      the CPU port;
   f. the device-planned streaming path (K3, K4, K5) on bench.py's dense
      stream (the same rows and seed, 256 channels: 4,194,304
      visibilities per chunk, block_v 1024, cap_factor 1.4):
      ``stream_tasks`` -> ``plan_stream`` -> ``StreamingGridder`` with the
      full chunk and a short chunk of its first SHORT_ROWS rows ->
      ``finalize()``, and ``StreamingDegridder.set_model(unit point)`` ->
      ``predict`` -> ``check()``; held against the same calls on the plain
      path on the card and against the host-planned packed path;
   g. the packed gridder's ``engine="fused"`` (K3, K4) at the bench
      scenario, "highest" and "high", against the band engine;
   h. the ES-FFT gridder (K8, K11) on the bench data (pixel THETA / 512,
      epsilon 1e-5, complex64): ``GridderUvwEsFft`` 3-D (w-stacking) and
      2-D, ``grid_uvw_es_fft`` and ``ifft_degrid_uvw_es_fft`` of a unit
      point; held against the plain path and the ES oracle in f32 and in
      f64 on the card, and checked for adjointness;
   i. the packed gridder's ``engine="compact"`` (K12, K13) at the bench
      scenario, "highest" and "bf16", against the plain path and the band
      engine;
   j. the streaming path's non-packable branch (K5, K6, K8, the fold, K7,
      K11): window f's dense stream and calls with the plan at
      oversampling 65536 (beyond the fused kernels' plan words), held
      against the same calls on the plain path on the card and against
      the host-planned packed path on that plan;
   k. the same branch with ``fast=True``: window j's plan, chunk and
      calls, the bf16 modes of K6, K7, K8 and K11 (K5 and the fold as
      in j), held against the same calls on the plain path on the card
      and against window j's f32 result at the bf16 envelope (5e-3);
   l. the word-fed bucket-window kernels K18 (``grid_fused``) and K19
      (``degrid_fused2``), which no entry point of either package runs:
      driven once each on window f's placed plan words, visibilities and
      plane-major model stack (``block_bucket``, ``nonempty``), in a
      window of their own, then held against their plain versions in all
      three precision modes and, at "highest", against K8/K11 fed the
      same taps;
   m. the sparse all-layer grid K20 (``grid_all_layers_sparse``), which no
      entry point runs: once in each mode on the fallback's largest task
      in the sparse form the bucketed driver makes before it densifies the
      w taps, each in a window of its own; then against its plain version
      and against K16 fed ``_slab_weights`` of the same taps; then its
      calls' wall time, device time and device operations a call
      (``torch.profiler``), failing if a call makes more than one device
      operation or two calls differ in a bit;
   n. the bf16 mode of K14-K17: once each on window c's plane and the
      fallback's largest task, against the bf16 plain versions and the
      f32 kernels (within JAX's 4e-3 envelope); then window d's sub-grid
      gridder with ``SKA_SDP_FUNC_TPU_FAST_MXU=1``, which must launch
      K16/K17 in bf16 mode, each call held to the bf16 rounding bound of
      its f32 twin, the outputs against the plain path and window d's
      f32 results;
   o. the solvers at the bench scenario on visibilities of a sky of
      points and a Gaussian source: ``major_cycle_imager(bucketed=True,
      clean_algorithm="msclean", scale_list=(0, 8, 16), n_major=2)`` and
      ``fista_imager(n_iter=10)``, which must launch K1/K2 and nothing
      else, against the same calls on the plain path on the card; small
      point-source msclean and FISTA solves against the CPU port; and a
      ``checkpoint_path`` resume (two cycles, then three) against three
      uninterrupted cycles;
   p. the experiments' A/B kernels, which no entry point runs, through
      their drivers (``ska_sdp_func_torch.experiments``) at each
      experiment's own scale, one window each: bench.py's read probe
      (``read_streams``, 6 streams and 1 of [4096, 8192]; a read rate
      above 1.05 x 3.35 TB/s fails), exp_place_dma (K5 on 4 payloads,
      bit for bit against the NumPy oracle, beside the placement sort),
      exp_prep (``prep_variant`` in five modes, bit for bit), exp_dot's
      ``_call`` and ``_call_npair`` forms (``bucket_dot``: three TF32
      tensor-core products for f32, bf16, and ``prod_simt`` on the CUDA
      cores; each at 1e-5 of its plain version, bf16 also at 5e-2 of f32
      prod), exp_parity (``grid_parity`` at slots 1, 2, 4) and
      exp_overlap (``overlap``, each block's sum |acc| included, and the
      overlap fraction of ``both`` and ``both2``); each window launches
      each variant once, then holds it against its plain version and
      times it;
5. times: grid, degrid and one major-cycle iteration of the packed path
   (and one msclean and one FISTA iteration beside the Hogbom one; and
   ``packed_times``: wall, host enqueue and device time, busy share and
   device operations a call) and
   the fallback at the bench scenario (with its device operations per
   call and busy share by ``torch.profiler``), the task drivers' calls of
   4c with one task's calls split per plane by CUDA events (geometry,
   the K14/K15 wrapper, the rest), streaming ingest and predict beside
   their plain paths, the non-packable ingest and predict beside the
   packable ones with their stages, and the fast (bf16) ones beside the
   f32 ones, the fused and compact engines beside the band engine, the
   ES-FFT gridder beside the packed path, the three predicts (stream,
   non-packable in f32 and fast, ES-FFT 3-D degrid) by stage (plan, the
   run table, K4, K7, K11, unsort, the rest), and each kernel beside its
   plain version at the main paths' shapes (K11 also at window j's dense
   stream) (K1/K2 in "high" and "bf16",
   with the product alone by ``torch.bmm`` beside them; K12/K13 also
   beside K3/K4 on the same plan; K14/K15 also on an all-masked plane;
   K16/K17 over window b's whole stream, also at supports 12, 20 and 56,
   and on its largest task alone).

The line before the last is a JSON object describing each kernel: its
launches in its path's window, its largest absolute difference from its
plain version, its time and the plain version's, and its bound: the
larger of the bytes it must move (each input read once, each output
written once) over the H100's 3.35 TB/s and the f32 operations of the
valid slots its plan gives it (the non-zero tap products, two
operations each, and the fused kernels' and the tap preparation's tap
evaluation) over its 67 TFLOP/s outside the tensor cores; the fold
counts only the visited windows it must read, and the per-plane kernels
K14/K15 (redesigned: their rows carry ``redesigned``) the mask, their
active entries' operands and the stack or result
(``plane_bytes``). K16/K17's rows (redesigned: ``entry`` names the
batched wrapper) carry the batched call at window b's stream, its
launches in window b, and ``single_task_*`` for the one-task call on the
largest task. K4, K11, K13 and K19 (redesigned: one template in
``csrc/window_gather.cu``) carry ``redesigned``, their template
``instance`` and its ``ptxas`` registers and spills; K11 has a row at
window j's dense stream (``degrid_fused[dense stream]``) beside its
ES-FFT one. K3, K8, K12 and K18 (redesigned: one template in
``csrc/window_scatter.cu``) carry the same keys (``instance``:
``window_scatter_kernel<...>``); K8 has a row at window j's dense stream
(``grid_packed[dense stream]``) beside its ES-FFT one. K6 and K7
(redesigned: one template in ``csrc/stream_prep.cu``) carry the same
keys (``instance``: ``stream_prep_kernel<GRID, BF16, NCOEF, S>``, the
instance window j's fits take). One kernel
replaces both TPU folds (K9, K10): it has a row for each (redesigned:
``instance`` ``fold_windows_kernel<4>``, as are P1, P2b-P2e's rows with
their templates, and K20's and K5's with P2f, which also carry
``device_ms`` and ``device_ops``, a call's device time and operations by
``torch.profiler``); the bf16
modes of K6, K7, K8 and K11 have rows of their own (``[bf16]``, window
k's operands), bytes counted for the bf16 ``vk``; so do K20 and the bf16
modes of K14-K17 (window m's and n's operands, which the bf16 modes read
as f32 and round in registers). ``library_ms`` is null (no single PyTorch
call computes any of these functions) but for K1/K2 and their ``[bf16]``
rows (window a's fast run): the product alone, ``torch.bmm`` of the plain
version's materialised operands (f32 with TF32 off, or bf16), labelled
in ``library``. The experiments' kernels (window p)
have a row for each TPU kernel site (P1, P2a-P2f): the numbers of its
headline variant and a ``variants`` list with each variant's; their
bounds divide tensor-core operations by the published dense peaks (TF32
495 TFLOP/s, three passes for an f32 product; bf16 989 TFLOP/s), and P1's
and exp_dot's lhs_stream and npair rows carry ``library_ms`` (ATen's block
sums; ``torch.bmm`` with TF32 off, on npair's even and odd blocks made
contiguous beforehand). Every kernel row also carries
``bound_ms_read_rate``: its bound with the bytes over P1's measured read
rate. The last line is ``{"ok": true, "device": {...}}``.
Without a CUDA device the script exits non-zero and prints no result. It
imports nothing of jax.
"""

import contextlib
import functools
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

C_0 = 299792458.0
ROOT = os.path.dirname(os.path.abspath(__file__))
# bench.py's seeded main-path scenario.
IMAGE, SUBGRID = 512, 128
THETA, W_STEP, HEIGHT = 0.002, 100.0, 4.0
ROWS, CHANS = 16384, 64
# The w-towers path: the same data on 64^2 sub-grids.
TOWER_SUBGRID = 64
# The reference-API whole-image drivers (a host sync per sub-grid and
# every visibility through every sub-grid) take the first REF_ROWS bench
# rows; the sub-grid gridder uses its own scenario (below).
REF_ROWS = 256
# Window c's one-cycle task-driver solve (a PSF grid on the 2N plan, a
# degrid and a grid, each O(tasks x V) through the host-bound task loop,
# on the kernel and the plain path) takes the first SOLVE_ROWS bench rows:
# a cut of depth made when window o was added (about 100 s at all 16384
# rows; the grid and degrid of window c keep every row).
SOLVE_ROWS = 4096
# The small test scenario (tests/_torch_scenario.py).
SMALL = dict(image=256, rows=150, chans=2, w_step=50.0, seed=5)
MODES = {"highest": dict(precision="highest"),
         "high": dict(precision="high"),
         "bf16": dict(fast=True)}
TOL = 1e-5           # relative to max|reference| (f32 reordering only)
# K1/K2's "high" and "bf16" modes, redesigned for the tensor cores.
WGMMA_SOURCE = "ska_sdp_func_torch/kernels/csrc/packed_wgmma.cu"
PACKED_REDESIGN = ("redesigned: one CTA an SM walks the plan's bucket runs "
                   "(x 128-lane tiles); a producer warp streams 64-slot "
                   "stages by TMA through a ring under mbarriers; two "
                   "consumer warpgroups run bf16 wgmma (hi/lo split at "
                   "'high'), chunk sums added on the CUDA cores; the grid "
                   "flushes once a run with float4 atomics, the degrid "
                   "keeps the run's window in shared memory")
# K1/K2's yardstick: the product alone, torch.bmm of the plain version's
# materialised operands, in f32 with TF32 off for "high" and in bf16 for
# "bf16" (each row carries the other as library_f32_ms / library_bf16_ms);
# the port never calls it.
LIBRARY_NOTE = ("product only: torch.bmm of the plain version's operands "
                "[NB, rows, block_v] @ [NB, block_v, lanes] (grid) or "
                "[NB, rows, lanes] @ [NB, lanes, block_v] (degrid), f32 with "
                "TF32 off ('high') or bf16 ('bf16')")
TOWER_SOURCE = "ska_sdp_func_torch/kernels/csrc/tower_tap.cu"
# K14/K15, redesigned for the card: active-entry compaction on the device,
# then work for the active entries only.
PLANE_SOURCE = "ska_sdp_func_torch/kernels/csrc/plane_tap.cu"
PLANE_REDESIGN = ("redesigned: compacts the plane's active entries on the "
                  "device and gathers their taps in the kernel")
# bench.py's dense stream: the bench rows and seed at 256 channels, one
# chunk of 4,194,304 visibilities; then a short chunk of its first rows.
STREAM_CHANS, STREAM_BLOCK_V, STREAM_CAP_FACTOR = 256, 1024, 1.4
SHORT_ROWS = 12288
# The streaming path's kernels: name, module, source, replaced TPU kernel.
STREAM_KERNELS = (
    ("grid_fused_stack", "fused_tap", "csrc/window_scatter.cu",
     "ska_sdp_func_tpu/kernels/fused_tap.py:426"),
    ("degrid_fused2_stack", "fused_tap", "csrc/window_gather.cu",
     "ska_sdp_func_tpu/kernels/fused_tap.py:924"),
    ("place_stream", "place", "csrc/place.cu",
     "ska_sdp_func_tpu/kernels/place.py:92"),
)
TOWER_KERNELS = (
    ("grid_plane", "ska_sdp_func_tpu/kernels/pallas_tap.py:147"),
    ("degrid_plane", "ska_sdp_func_tpu/kernels/pallas_tap.py:220"),
    ("grid_all_layers", "ska_sdp_func_tpu/kernels/pallas_tap.py:309"),
    ("degrid_all_layers", "ska_sdp_func_tpu/kernels/pallas_tap.py:369"),
)
# K16/K17, redesigned for the card: one launch over every task of a
# fallback call (the one-task wrappers above launch the same kernels with
# a one-task table). Their rows in the kernels line carry the batched
# call's numbers at window b's stream, the one-task call's beside them.
TASK_KERNELS = (
    ("grid_all_layers_tasks", "grid_all_layers"),
    ("degrid_all_layers_tasks", "degrid_all_layers"),
)
TASK_REDESIGN = ("redesigned: one launch over every task of a fallback "
                 "call (a CTA per task plane in shared memory, a thread "
                 "per slot to degrid)")
# Supports past 8 take the batched kernels' wider bodies (to grid, 12: 16
# taps a row in one pass, 20: two passes, 56: 13 passes with the tap rows
# read from memory, past the 54 whose staged rows fill shared memory; to
# degrid, tap rows read from memory); checked and timed on window b's
# stream with random taps.
WIDE_SUPPORTS = (12, 20, 56)
# The ES-FFT gridder on the bench data, and its kernels.
ES_EPSILON = 1e-5
ES_LAYOUTS = {"3-D": True, "2-D": False}
ES_ORACLE_TOL = 5e-6    # complex64 path vs the f64 oracle, of max|oracle|
ES_KERNELS = (
    ("grid_packed", "ska_sdp_func_tpu/kernels/packed_tap.py:397"),
    ("degrid_fused", "ska_sdp_func_tpu/kernels/packed_tap.py:935"),
)
# K4, K11, K13 and K19, redesigned for the card: one kernel template,
# window_gather_kernel<MODE, FORM>, over the plan's bucket runs.
GATHER_SOURCE = "ska_sdp_func_torch/kernels/csrc/window_gather.cu"
GATHER_REDESIGN = ("redesigned: one CTA a bucket run (or part of one), the "
                   "run's window read into shared memory once by cp.async "
                   "under mbarriers (the next unit's while this one is "
                   "gathered; the ES window in groups of slabs), a warp a "
                   "slot gathering its taps from there without bank "
                   "conflicts")
GATHER_FORMS = {0: "kStackWords", 1: "kStackTaps", 2: "kBandTaps",
                3: "kBandWords"}
GATHER_MODES = {0: "kF32", 1: "kHigh", 2: "kBf16"}
# Each redesigned row's template instance (mode, form).
GATHER_ROWS = {"degrid_fused2_stack": (0, 0), "degrid_compact": (0, 1),
               "degrid_fused": (0, 2), "degrid_fused[dense stream]": (0, 2),
               "degrid_fused[bf16]": (2, 2), "degrid_fused2": (0, 3)}
# K3, K8, K12 and K18, redesigned for the card: one kernel template,
# window_scatter_kernel<MODE, FORM>, over the same run tables (the forms
# and modes are numbered as the gather's).
SCATTER_SOURCE = "ska_sdp_func_torch/kernels/csrc/window_scatter.cu"
SCATTER_REDESIGN = ("redesigned: CTAs walk the run table, a bucket run (or "
                    "part of one) a unit; 256 slots staged at a time "
                    "(taps, scales, first cell; dead slots compacted "
                    "out); each warp owns whole window planes in shared "
                    "memory and adds a slot's cells with plain loads and "
                    "stores, lane (q, sv) on 32 distinct banks; one bulk "
                    "reduce-add (cp.reduce.async.bulk) a window row a unit; "
                    "the ES window in groups of planes")
SCATTER_ROWS = {"grid_fused_stack": (0, 0), "grid_compact": (0, 1),
                "grid_packed": (0, 2), "grid_packed[dense stream]": (0, 2),
                "grid_packed[bf16]": (2, 2), "grid_fused": (0, 3)}
# The packed engine="compact"'s kernels.
COMPACT_KERNELS = (
    ("grid_compact", "ska_sdp_func_tpu/kernels/fused_tap.py:555"),
    ("degrid_compact", "ska_sdp_func_tpu/kernels/fused_tap.py:636"),
)
COMPACT_MODES = {"highest": dict(precision="highest"),
                 "bf16": dict(fast=True)}
# Window j: the dense stream made non-packable (an oversampling beyond
# the fused kernels' plan words), and the kernels of that branch: its tap
# preparation (K6, K7) and the window fold (K9 and K10 in one kernel);
# it also runs K5, K8 and K11.
NP_OVERSAMPLING, NP_W_OVERSAMPLING = 65536, 16384
PREP_SOURCE = "ska_sdp_func_torch/kernels/csrc/stream_prep.cu"
# K6/K7, redesigned for the card: one kernel template,
# stream_prep_kernel<GRID, BF16, NCOEF, S>, unrolled at the streaming
# paths' fits (ncoef 12, S 8) and generic (0, 0) for the wrapper's range.
PREP_REDESIGN = ("redesigned: persistent CTAs walk 256-slot tiles; a thread "
                 "a (slot, tap) evaluates uk and vk, so a warp stores 4 "
                 "slots' taps as one 128 B run; a thread a (slot, w tap) "
                 "evaluates wk into shared memory and each scale row is "
                 "written as one contiguous run; the unrolled instance "
                 "holds its coefficient columns in registers and unrolls "
                 "the chains")
# The generic instance's fits in phase 3, on window j's fields: (S, Sw,
# ncoef), random coefficients.
PREP_GENERIC_FITS = ((8, 8, 16), (5, 4, 12), (8, 3, 12))
FOLD_SOURCE = "ska_sdp_func_torch/kernels/csrc/fold.cu"
PREP_KERNELS = (
    ("stream_prep_grid", "ska_sdp_func_tpu/kernels/packed_tap.py:524"),
    ("stream_prep_degrid", "ska_sdp_func_tpu/kernels/packed_tap.py:642"),
)
FOLD_REPLACES = (
    ("fold_groups", "ska_sdp_func_tpu/kernels/packed_tap.py:720"),
    ("fold_layers", "ska_sdp_func_tpu/kernels/packed_tap.py:770"),
)
# Window k: window j's stream with fast=True, the bf16 modes of these four
# (name, source, the TPU kernel whose bf16 mode it is).
BF16_KERNELS = (
    ("stream_prep_grid", PREP_SOURCE,
     "ska_sdp_func_tpu/kernels/packed_tap.py:524"),
    ("stream_prep_degrid", PREP_SOURCE,
     "ska_sdp_func_tpu/kernels/packed_tap.py:642"),
    ("grid_packed", SCATTER_SOURCE,
     "ska_sdp_func_tpu/kernels/packed_tap.py:397"),
    ("degrid_fused", GATHER_SOURCE,
     "ska_sdp_func_tpu/kernels/packed_tap.py:935"),
)
FAST_TOL = 5e-3      # bf16 against f32, of peak (the JAX bf16 envelope)
# The word-fed bucket-window kernels (window l, on window f's operands).
WORD_KERNELS = (
    ("grid_fused", "ska_sdp_func_tpu/kernels/fused_tap.py:328"),
    ("degrid_fused2", "ska_sdp_func_tpu/kernels/fused_tap.py:814"),
)
# Window m: the sparse all-layer grid (K20), on the fallback's largest task.
SPARSE_SOURCE = "ska_sdp_func_torch/kernels/csrc/sparse_tap.cu"
SPARSE_REPLACES = "ska_sdp_func_tpu/kernels/sparse_tap.py:80"
SPARSE_REDESIGN = ("redesigned: one launch writes the complex64 output "
                   "whole; a cluster of CTAs (8 at the largest task) owns a "
                   "tile (4 rows, the width that fits, 9 layers), each "
                   "CTA's 8 warps a share of the slots by chunks of 32: "
                   "hits appended to a ring in shared memory, up to 32 "
                   "hits' records staged and waited for, lane (layer, "
                   "column) summing a run of hits on one cell in registers "
                   "into the warp's private copy of the tile; the copies "
                   "added in warp order, then the cluster's in rank order "
                   "through distributed shared memory: no atomics, two "
                   "calls give equal bits")
# K5 (and P2f on it), redesigned: persistent CTAs, 16-byte vectors.
PLACE_SOURCE = "ska_sdp_func_torch/kernels/csrc/place.cu"
PLACE_REDESIGN = ("redesigned: persistent CTAs (8 an SM) walk the output "
                  "as 16-byte vectors of 4 slots of one block, every "
                  "payload's 4-byte source loads of a vector in flight "
                  "before its 16-byte stores; word by word where "
                  "bv % 4 != 0")
# Window n: the bf16 mode of K14-K17 against the f32 kernels, within JAX's
# stated envelope of the single-pass bf16 dot (wtower.py:685). The
# sub-grid gridder's outputs are held at CHAIN_TOL instead: its tap sums
# cancel (a point's phase turns across the 8 x 8 support; the w layers
# sum with the w-pattern ladder), so the kernels' per-term rounding
# (each call held exactly to its bound, 2^-7 of the sum of |terms|) reads
# as 2.1e-2 of the predicted visibilities and 3.8e-2 of the raw sub-grid
# image on the CPU port's test scenario (tests/test_torch_tower_fast.py).
TOWER_FAST_TOL = 4e-3
CHAIN_TOL = 5e-2
FAST_MXU = "SKA_SDP_FUNC_TPU_FAST_MXU"
# Window o: the solvers at the bench scenario.
MS_SCALES = (0, 8, 16)
FISTA_ITERS = 10
SOLVE_TOL = 1e-4     # of max|model|; FISTA's residual norms, of the first
# The H100 SXM's published peaks (NVIDIA H100 datasheet): HBM bytes/s
# and f32 operations/s outside the tensor cores.
HBM_BYTES_S = 3.35e12
F32_OPS_S = 67e12
# Window p: each experiment's TPU kernel sites, as (row name, driver,
# variants launched in its window or None for all, the wrapper it counts,
# CUDA source, replaced TPU kernel, headline variant).
KDIR = "ska_sdp_func_torch/kernels/csrc/"
EXPERIMENT_SITES = (
    ("read_streams[P1]", "rooflines", None, "read_streams",
     KDIR + "read_probe.cu", "bench.py:168", "6 streams"),
    ("place_stream[P2f exp_place_dma]", "exp_place_dma", None,
     "place_stream", KDIR + "place.cu", "experiments/exp_place_dma.py:74",
     "4 payloads"),
    ("prep_variant[P2a exp_prep]", "exp_prep", None, "prep_variant",
     KDIR + "prep_variants.cu", "experiments/exp_prep.py:115", "full"),
    ("bucket_dot[P2c exp_dot _call]", "exp_dot",
     ("prod", "prod_bf16", "prod_simt", "lhs_stream", "lhs_stream_bf16",
      "ksplit2", "ksplit2_bf16", "ksplit4", "ksplit4_bf16", "nodot"),
     "bucket_dot", KDIR + "bucket_dot.cu", "experiments/exp_dot.py:175",
     "prod"),
    ("bucket_dot[P2d exp_dot _call_npair]", "exp_dot",
     ("npair", "npair_bf16"), "bucket_dot", KDIR + "bucket_dot.cu",
     "experiments/exp_dot.py:199", "npair"),
    ("grid_parity[P2e exp_parity]", "exp_parity", None, "grid_parity",
     KDIR + "bucket_dot.cu", "experiments/exp_parity.py:94", "slots1"),
    ("overlap[P2b exp_overlap]", "exp_overlap", None, "overlap",
     KDIR + "overlap.cu", "experiments/exp_overlap.py:129", "both"),
)
# The wrappers only window p may launch.
EXPERIMENT_KERNELS = ("read_streams", "prep_variant", "bucket_dot",
                      "grid_parity", "overlap")
# P1 and P2c-P2e, redesigned for the card: the template and the instance
# of each site's headline variant.
DOT_REDESIGN = ("redesigned: one CTA an SM takes the bucket runs (a unit a "
                "whole run, all 128 columns) longest first from a shared "
                "counter; a producer thread streams 64-slot stages by TMA "
                "through a ring under mbarriers; two consumer warpgroups "
                "own 64 of U's rows each: TF32 x 3 as out^T = V^T U^T (A = "
                "vband from registers split hi/lo, B = U^T hi/lo planes in "
                "shared memory, wgmma m64n64k8), bf16 as U V (wgmma "
                "m64n128k16); each stage summed fresh, added on the CUDA "
                "cores; slots and npair as passes over the run; stored once "
                "a pass, no atomics; unvisited buckets zeroed by the "
                "producer warpgroup's other warps")
PROBE_REDESIGN = ("redesigned: a thread keeps at least 4 float4 loads in "
                  "flight at any stream count (4 rows a step at one "
                  "stream, 2 at two or three), the adds in the one-row "
                  "order")
OVERLAP_REDESIGN = ("redesigned: one CTA an SM walks the blocks in 64-slot "
                    "stages; a thread a (slot, tap) builds U^T's TF32 hi/lo "
                    "planes (K-major, 128-byte swizzle, conflict-free rows) "
                    "and V's compact record, its slots' Clenshaw chains in "
                    "lockstep; two consumer warpgroups own 64 lanes each: "
                    "out^T = V^T U^T, A expanded from the record into "
                    "registers, wgmma m64n128k8 x 3 a k-step, each stage "
                    "summed fresh and added on the CUDA cores; dot, vpu, "
                    "both: builder warps (two warpgroups, one for dot) fill "
                    "a 3-stage ring under mbarriers; both2: each warpgroup "
                    "builds the next stage while its products run")
# K9/K10, redesigned: the instance window j takes (L 128, aligned).
FOLD_REDESIGN = ("redesigned: a CTA an (octet, layer, task) from the launch "
                 "grid, its visited flags read once into shared memory and "
                 "tested uniformly (unvisited windows cost no load), float4 "
                 "rows with a plane group's loads issued before its adds, "
                 "re/im written as two 16-byte stores")
EXPERIMENT_REDESIGN = {
    "read_streams[P1]": (PROBE_REDESIGN, "read_streams_kernel", (1, 8)),
    "overlap[P2b exp_overlap]": (OVERLAP_REDESIGN, "overlap_kernel", (2,)),
    "fold_windows[fold_groups]": (FOLD_REDESIGN, "fold_windows_kernel",
                                  (4,)),
    "fold_windows[fold_layers]": (FOLD_REDESIGN, "fold_windows_kernel",
                                  (4,)),
    "place_stream[P2f exp_place_dma]": (PLACE_REDESIGN, "place_stream_kernel",
                                        (1,)),
    "bucket_dot[P2c exp_dot _call]": (DOT_REDESIGN, "bucket_dot_kernel",
                                      (0, 0, 1, 1, 0)),
    "bucket_dot[P2d exp_dot _call_npair]": (DOT_REDESIGN,
                                            "bucket_dot_kernel",
                                            (0, 0, 2, 1, 1)),
    "grid_parity[P2e exp_parity]": (DOT_REDESIGN, "bucket_dot_kernel",
                                    (0, 0, 1, 1, 0)),
}


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


def bench_sky(torch, dev, size=IMAGE):
    """Window o's sky on a ``size``^2 image (the bench image's by
    default): three points and a Gaussian source (sigma 4 px), inside the
    CLEAN window."""
    x = np.arange(size) - size // 2
    sky = 0.4 * np.exp(-((x[:, None] + 60 * size // IMAGE) ** 2
                         + (x[None, :] - 40 * size // IMAGE) ** 2) / 32.0)
    for (px, py), flux in (((300, 200), 1.0), ((180, 330), 0.7),
                           ((260, 120), 0.5)):
        sky[px * size // IMAGE, py * size // IMAGE] += flux
    return torch.as_tensor(sky, dtype=torch.float32, device=dev)


def subgrid_inputs():
    """The sub-grid gridder scenario of tests/test_wtower.py: earth-
    rotation coverage of 8 antennas over 12 times (336 rows x 3
    channels) inside a 64^2 sub-grid, and a two-source image."""
    rng = np.random.default_rng(42)
    ants = rng.uniform(-2000.0, 2000.0, (8, 3))
    ants[:, 2] *= 0.02
    bl = np.array([ants[i] - ants[j] for i in range(8)
                   for j in range(i + 1, 8)])
    sd, cd = np.sin(np.radians(40.0)), np.cos(np.radians(40.0))
    rows = []
    for ha in np.linspace(0, np.pi / 3, 12, endpoint=False):
        sh, ch = np.sin(ha), np.cos(ha)
        rows.append(np.stack([sh * bl[:, 0] + ch * bl[:, 1],
                              -sd * ch * bl[:, 0] + sd * sh * bl[:, 1]
                              + cd * bl[:, 2],
                              cd * ch * bl[:, 0] - cd * sh * bl[:, 1]
                              + sd * bl[:, 2]], axis=-1))
    uvw = np.concatenate(rows)
    uvw[:, :2] *= 16.0 / THETA / np.abs(uvw[:, :2]).max()
    uvw[:, 2] *= 350.0 / np.abs(uvw[:, 2]).max()
    image = np.zeros((TOWER_SUBGRID, TOWER_SUBGRID), np.complex64)
    image[16, 16] = 1.0
    image[53, 21] = 0.5
    return uvw, 3, image


def stream_inputs():
    """bench.py's dense stream: the bench rows, the same draws in the same
    order (the two 64-channel planes skipped), 256 channels."""
    rng = np.random.default_rng(1)
    uvw = rng.uniform(-1, 1, (ROWS, 3))
    uvw[:, :2] *= 0.45 * IMAGE / 2 / THETA
    uvw[:, 2] *= 1.5 * W_STEP * HEIGHT
    rng.standard_normal((ROWS, CHANS))
    rng.standard_normal((ROWS, CHANS))
    vis = (rng.standard_normal((ROWS, STREAM_CHANS))
           + 1j * rng.standard_normal((ROWS, STREAM_CHANS))
           ).astype(np.complex64)
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
    """Each packed kernel against its plain version in every mode;
    returns each mode's absolute errors."""
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
        out[mode] = dict(grid=a_grid, degrid=a_degrid)
        del g
    return out


# -- w-towers kernels ----------------------------------------------------------

def plane_geometry(plan, uvw_dev, s_uv, e_uv, off, w_plane):
    """One w-plane's geometry over every row, as the task drivers make
    it (``_grid_all_planes`` / ``_degrid_all_planes``)."""
    from ska_sdp_func_torch.grid_data import wtower

    return wtower._plane_geometry(
        uvw_dev, s_uv, e_uv, w_plane, *off, plan.freq0_hz, plan.dfreq_hz,
        plan.num_chan, plan.theta, plan.w_step, plan.support,
        plan.oversampling, plan.w_support, plan.w_oversampling,
        plan.subgrid_size, 0, uvw_dev.shape[0])


def plane_census(torch, plan, uvw_dev, st, en):
    """Active entries of every plane that ``grid_all_tasks`` grids, task
    by task (one mask per task plane)."""
    from ska_sdp_func_torch.parallel import wstack as pw

    counts = []
    for _, tasks in pw._plane_tasks(plan, uvw_dev, st, en):
        for task, s_uv, e_uv in tasks:
            off = pw._task_offsets(plan, task)
            counts += [plane_geometry(plan, uvw_dev, s_uv, e_uv, off,
                                      task.first_w_plane + p)[0].sum()
                       for p in range(task.num_planes)]
    return torch.stack(counts).cpu().numpy()


def plane_split(torch, plan, uvw_dev, vis_dev, sub_image, plane_task):
    """ms per plane of one task's ``_grid_all_planes`` and
    ``_degrid_all_planes`` call (as the task drivers make them) by CUDA
    events: the whole call, its planes' geometry, its planes' kernel
    wrapper calls on those geometries, and the rest (the rolling stack,
    its FFTs and adds)."""
    from ska_sdp_func_torch.grid_data import wtower
    from ska_sdp_func_torch.kernels import tower_tap as tt

    task, s_uv, e_uv, off = plane_task
    dev = uvw_dev.device
    n, first, num = plan.subgrid_size, task.first_w_plane, task.num_planes
    uv_k, w_k, w_pattern = plan.kernel().tables(torch.complex64, dev)
    tail = (plan.freq0_hz, plan.dfreq_hz, num, plan.theta, plan.w_step,
            plan.support, plan.oversampling, plan.w_support,
            plan.w_oversampling, n, 0, uvw_dev.shape[0])

    def geoms():
        return [plane_geometry(plan, uvw_dev, s_uv, e_uv, off, first + p)
                for p in range(num)]

    ready = geoms()
    stack = torch.zeros((plan.w_support, n, n), dtype=torch.complex64,
                        device=dev)
    zero_vis = torch.zeros_like(vis_dev)
    calls = dict(
        grid=(lambda: wtower._grid_all_planes(
                  vis_dev, w_pattern, uv_k, w_k, uvw_dev, s_uv, e_uv,
                  torch.zeros((n, n), dtype=torch.complex64, device=dev),
                  *off, first, *tail),
              lambda: [tt.grid_plane(stack, vis_dev, uv_k, w_k, g,
                                     plan.support, plan.w_support)
                       for g in ready]),
        degrid=(lambda: wtower._degrid_all_planes(
                    sub_image, w_pattern.to(torch.complex64), uv_k, w_k,
                    uvw_dev, s_uv, e_uv, zero_vis, *off, first, *tail),
                lambda: [tt.degrid_plane(stack, uv_k, w_k, g, plan.support,
                                         plan.w_support) for g in ready]))
    t_geom = cuda_ms(torch, geoms, 5, warmup=1) / num
    out = {}
    for what, (whole, wrappers) in calls.items():
        t_call = cuda_ms(torch, whole, 5, warmup=1) / num
        t_wrap = cuda_ms(torch, wrappers, 5, warmup=1) / num
        out[what] = dict(call=t_call, geometry=t_geom, wrapper=t_wrap,
                         rest=t_call - t_geom - t_wrap)
    return num, out


def tower_operands(torch, dev, plan, uvw_dev, vis_dev, bplan, sort_index,
                   valid, seed):
    """Operands of the four w-towers kernels at a main path's shapes.

    grid_all_layers_tasks / degrid_all_layers_tasks: the taps of the
    bucketed plan's whole stream and its task table (as
    ``grid_all_bucketed`` builds them); grid_all_layers /
    degrid_all_layers: the slice of its largest task; grid_plane /
    degrid_plane: one w-plane of that task's tower over every row and
    channel of ``uvw_dev`` (as the task drivers build it). Also returns
    each kernel's valid slots: the bucketed plan's valid slots in the
    stream or the task's slice, and the plane geometry's active
    visibilities; and the plane's task with its clamped channel ranges
    and offsets (for the per-plane split of window c's times).
    """
    from ska_sdp_func_torch.parallel import bucketed as bk
    from ska_sdp_func_torch.parallel import wstack as pw

    rng = np.random.default_rng(seed)
    uvw_s, chan_idx, _, vld = bk._sorted_inputs(bplan, uvw_dev, sort_index,
                                                valid)
    taps = bk._stream_taps(bplan, bk._device_constants(bplan, dev)["terms"],
                           uvw_s, chan_idx, vld, plan.freq0_hz,
                           plan.dfreq_hz)
    k = max(range(len(bplan.tasks)), key=lambda i: bplan.tasks[i].size)
    task = bplan.tasks[k]
    sl = slice(task.start, task.start + task.size)
    iu0, iv0, uk, vk = (t[sl] for t in taps[:4])
    weights = taps[4][sl, :task.num_layers].contiguous()
    n = plan.subgrid_size
    num_k = task.num_layers

    def rnd(shape, cplx=False):
        x = rng.standard_normal(shape)
        if cplx:
            x = x + 1j * rng.standard_normal(shape)
        return torch.as_tensor(x, dtype=torch.complex64 if cplx
                               else torch.float32, device=dev)

    vre, vim = rnd(task.size), rnd(task.size)
    layers = rnd((num_k, n, n), cplx=True)
    ops = dict(
        grid_all_layers=((vre, vim, iu0, iv0, uk, vk, weights, num_k, n,
                          plan.support), {}),
        degrid_all_layers=((layers, iu0, iv0, uk, vk, weights,
                            plan.support), {}))

    ptask = plan.tasks[k]
    s_w, e_w = pw.clamp_channels_single(
        uvw_dev, 2, plan.freq0_hz, plan.dfreq_hz,
        torch.zeros(uvw_dev.shape[0], dtype=torch.int32, device=dev),
        torch.full((uvw_dev.shape[0],), plan.num_chan, dtype=torch.int32,
                   device=dev), *pw._wslab_bounds(plan, ptask.iw))
    s_uv, e_uv = pw.clamp_channels_uv(uvw_dev, plan.freq0_hz, plan.dfreq_hz,
                                      s_w, e_w, *pw._box_bounds(plan, ptask))
    off = pw._task_offsets(plan, ptask)
    geom = plane_geometry(plan, uvw_dev, s_uv, e_uv, off,
                          ptask.first_w_plane + ptask.num_planes // 2)
    uv_k, w_k, _ = plan.kernel().tables(torch.float32, dev)
    sub = rnd((plan.w_support, n, n), cplx=True)
    ops["grid_plane"] = ((sub, vis_dev, uv_k, w_k, geom, plan.support,
                          plan.w_support), {})
    ops["degrid_plane"] = ((sub, uv_k, w_k, geom, plan.support,
                            plan.w_support), {})
    # The batched kernels on the whole stream, as window b's calls.
    tasks = bk._device_constants(bplan, dev)["tasks"]
    ops["grid_all_layers_tasks"] = ((rnd(bplan.total), rnd(bplan.total),
                                     *taps, tasks, n, plan.support), {})
    ops["degrid_all_layers_tasks"] = ((rnd((tasks.planes, n, n), cplx=True),
                                       *taps, tasks, plan.support), {})
    active = int(geom[0].sum())         # geom[0]: the plane's mask
    in_task = int(valid[task.start:task.start + task.size].sum())
    in_stream = int(valid.sum())
    counts = dict(grid_plane=active, degrid_plane=active,
                  grid_all_layers=in_task, degrid_all_layers=in_task,
                  grid_all_layers_tasks=in_stream,
                  degrid_all_layers_tasks=in_stream)
    shapes = (f"stream of {bplan.total} taps ({in_stream} valid), "
              f"{len(tasks.rows)} tasks, {tasks.planes} planes; largest task "
              f"{task.size} taps ({in_task} valid) x {num_k} layers; plane "
              f"{tuple(geom[0].shape)} with {active} active")
    return ops, shapes, counts, (ptask, s_uv, e_uv, off)


def wide_task_operands(torch, ops, support, seed):
    """The batched K16/K17 operands of ``ops`` at another ``support``:
    random uk, vk rows and the cells clipped to N - support."""
    gen = torch.Generator(device=ops["grid_all_layers_tasks"][0][0].device)
    gen.manual_seed(seed)
    wide = {}
    for name, _ in TASK_KERNELS:
        args, kw = ops[name]
        grid = name.startswith("grid")
        # grid: (vre, vim, iu0, ..., n, S); degrid: (layers, iu0, ..., S)
        j, n = (2, args[-2]) if grid else (1, args[0].shape[-1])
        iu0, iv0 = args[j], args[j + 1]
        rows = [torch.randn((iu0.shape[0], support), generator=gen,
                            device=iu0.device) for _ in range(2)]
        wide[name] = (args[:j] + (iu0.clamp(max=n - support),
                                  iv0.clamp(max=n - support), *rows)
                      + args[j + 4:-1] + (support,), kw)
    return wide


def task_bytes(args, weights, tasks, out_bytes) -> int:
    """Bytes K16 or K17 must move over a stream of tasks: each operand and
    the output once, but of the weights [V, Kw] only each task's own K_t
    columns of its slots (Kw is the largest K_t)."""
    own = sum(count * layers for _, count, layers, _ in tasks.rows)
    return (nbytes(args) - nbytes(weights) + own * weights.element_size()
            + out_bytes)


def check_tower_kernels(torch, tt, ops, label, names=None):
    """Each w-towers kernel (or those of ``names``) against its plain
    version; returns the absolute errors. The plane kernels compare their
    contribution (the input stack subtracted)."""
    errs = {}
    for name in names or [n for n, _ in TOWER_KERNELS + TASK_KERNELS]:
        args, kw = ops[name]
        got = getattr(tt, name)(*args, **kw)
        want = getattr(tt, name + "_reference")(*args, **kw)
        if name == "grid_plane":
            got, want = got - args[0], want - args[0]
        torch.cuda.synchronize()
        errs[name] = (rel_err(got, want), float((got - want).abs().max()))
        del got, want
    say(f"# tower kernels vs plain [{label}]: " + ", ".join(
        f"{n} rel err {e[0]:.3e}" for n, e in errs.items())
        + f" (tolerance {TOL:g})")
    bad = [n for n, e in errs.items() if not e[0] <= TOL]
    if bad:
        raise SystemExit(f"kernel disagrees with its plain version "
                         f"[{label}]: {bad}")
    return {n: e[1] for n, e in errs.items()}


@contextlib.contextmanager
def plain_tower_kernels(bk, tt):
    """The w-towers drivers on the tap kernels' plain versions (the plain
    path the kernel path is held against). The bucketed drivers import the
    batched wrappers by name; the sub-grid gridder reaches the others
    through ``tower_tap``."""
    names = [n for n, _ in TOWER_KERNELS + TASK_KERNELS]
    batched = [n for n, _ in TASK_KERNELS]
    saved = ([getattr(tt, n) for n in names],
             [getattr(bk, n) for n in batched])
    for n in names:
        setattr(tt, n, getattr(tt, n + "_reference"))
    for n in batched:
        setattr(bk, n, getattr(tt, n + "_reference"))
    try:
        yield
    finally:
        for n, f in zip(names, saved[0]):
            setattr(tt, n, f)
        for n, f in zip(batched, saved[1]):
            setattr(bk, n, f)


@contextlib.contextmanager
def plain_kernels(swaps, record=None):
    """A path on its kernels' plain versions (the plain path the kernel
    path is held against): ``swaps`` lists (module the path calls
    through, kernel name, module holding ``<name>_reference``). With
    ``record``, each call's arguments are appended under the kernel's
    name: the very operands the path passes its kernels."""
    saved = [getattr(m, n) for m, n, _ in swaps]

    def plain_of(name, ref):
        def plain(*args, **kw):
            if record is not None:
                record.setdefault(name, []).append((args, kw))
            return ref(*args, **kw)
        return plain

    for m, n, src in swaps:
        setattr(m, n, plain_of(n, getattr(src, n + "_reference")))
    try:
        yield record
    finally:
        for (m, n, _), f in zip(swaps, saved):
            setattr(m, n, f)


def plain_stream_kernels(record=None):
    """The streaming path and the fused engine on the plain versions of
    K3, K4 and K5."""
    from ska_sdp_func_torch.kernels import fused_tap, place

    return plain_kernels(
        [(fused_tap, name, fused_tap) for name, mod, _, _ in STREAM_KERNELS
         if mod == "fused_tap"] + [(place, "place_stream", place)], record)


def plain_es_kernels(record=None):
    """The ES-FFT gridder on the plain versions of K8 and K11 (its module
    imports the wrappers by name)."""
    from ska_sdp_func_torch.grid_data import es_fft_packed
    from ska_sdp_func_torch.kernels import band_tap

    return plain_kernels([(es_fft_packed, n, band_tap)
                          for n, _ in ES_KERNELS], record)


def plain_compact_kernels(record=None):
    """The compact engine on the plain versions of K12 and K13."""
    from ska_sdp_func_torch.kernels import fused_tap

    return plain_kernels([(fused_tap, n, fused_tap)
                          for n, _ in COMPACT_KERNELS], record)


def np_modules():
    """Kernel name -> the module that holds it, for the non-packable
    streaming branch (the streaming module calls each through it)."""
    from ska_sdp_func_torch.kernels import band_tap, fold, place, stream_prep

    return dict(place_stream=place, stream_prep_grid=stream_prep,
                grid_packed=band_tap, fold_windows=fold,
                stream_prep_degrid=stream_prep, degrid_fused=band_tap)


def plain_np_kernels(record=None):
    """The non-packable streaming branch on the plain versions of K5-K11."""
    return plain_kernels([(m, n, m) for n, m in np_modules().items()],
                         record)


# -- bounds ------------------------------------------------------------------

def nbytes(*objs) -> int:
    """Bytes of every tensor among ``objs`` (tuples and lists searched)."""
    total = 0
    for o in objs:
        if isinstance(o, (tuple, list)):
            total += nbytes(*o)
        elif hasattr(o, "element_size"):
            total += o.numel() * o.element_size()
    return total


def bound(args, out, ops, moved=None):
    """(ms, "bytes" or "operations"): the least time the card could take
    to read ``args`` once, write ``out`` once (or move ``moved`` bytes,
    where the data leaves part of ``args`` unread) and do ``ops`` f32
    operations."""
    if moved is None:
        moved = nbytes(args) + nbytes(out)
    t_bytes = moved / HBM_BYTES_S * 1e3
    t_ops = ops / F32_OPS_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def plane_bytes(geom, stack, active, support, w_support, grid) -> int:
    """Bytes K14 (``grid``) or K15 must move for one plane: the mask
    once; for each active entry its cells and kernel rows (5 int32), its
    two uv-kernel rows and its w-kernel row (f32) and, to grid, its
    complex64 visibility; the complex64 stack read once; and the stack
    written once (grid) or the complex64 [R, C] result (degrid). The
    masked entries' operands are never needed."""
    mask = geom[0]
    per_entry = 5 * 4 + (2 * support + w_support) * 4 + (8 if grid else 0)
    written = nbytes(stack) if grid else mask.numel() * 8
    return mask.numel() + int(active) * per_entry + nbytes(stack) + written


def tap_ops(valid, support, w_support):
    """f32 operations of the non-zero tap products of ``valid`` slots: 2
    halves x Sw x S x S products, a multiply and an add each."""
    return int(valid) * 2 * w_support * support * support * 2


def cheb_ops(valid, support, w_support, ncoef):
    """f32 operations of the fused kernels' tap evaluation: three
    Chebyshev bases and 2S + Sw sums of ``ncoef`` terms per slot."""
    return int(valid) * (3 + 2 * support + w_support) * 2 * ncoef


def prep_ops(valid, support, w_support, ncoef, scale_rows):
    """f32 operations of the streaming tap preparation (K6, K7) of
    ``valid`` slots: three row coordinates (2 each), Clenshaw's
    recurrence over 2S + Sw taps (3 per term) and ``scale_rows`` x Sw
    products."""
    return int(valid) * (6 + (2 * support + w_support) * 3 * ncoef
                         + scale_rows * w_support)


def fold_reads(wins, visited, num_octets) -> int:
    """f32 window elements the window fold (K9 + K10) reads, one add
    each: the 16 rows of each visited window, 8 of a last octet's (its
    straddle half is clipped); an unvisited window is never read."""
    v = visited.reshape(-1, num_octets)
    rows = int(v[:, :-1].sum()) * 16 + int(v[:, -1].sum()) * 8
    return rows * wins.shape[0] * wins.shape[3]


def fold_bytes(wins, visited, num_octets, out) -> int:
    """Bytes the window fold must move: the window rows it reads once,
    the mask, the layers written once."""
    return fold_reads(wins, visited, num_octets) * wins.element_size() \
        + nbytes(visited, out)


def check_stream_kernels(torch, StreamingGridder, StreamingDegridder, sp,
                         uvw, vis, model, label):
    """K3 and K4 (three modes) and K5 against their plain versions on the
    operands one streaming accumulate and predict pass them (captured on
    the plain path). Returns the absolute errors of the path's own mode,
    the captured operands and K3/K4's valid slots (the chunk's processed
    count of the stream's device plan)."""
    from ska_sdp_func_torch.kernels import fused_tap, place

    dev = uvw.device
    captured = {}
    sg = StreamingGridder(sp, device=dev)
    sd = StreamingDegridder(sp, device=dev).set_model(model)
    with plain_stream_kernels(captured):
        sg.accumulate(uvw, vis)
        sd.predict(uvw)
    counts = dict(grid_fused_stack=int(sg.counters()[0]),
                  degrid_fused2_stack=int(sd.counters()[0]))
    errs, lines = {}, []
    for name in ("grid_fused_stack", "degrid_fused2_stack"):
        args, kw = captured[name][0]
        for mode in MODES:
            kw_m = {**kw, "precision": mode}
            got = getattr(fused_tap, name)(*args, **kw_m)
            want = getattr(fused_tap, name + "_reference")(*args, **kw_m)
            torch.cuda.synchronize()
            e = rel_err(got, want)
            lines.append(f"{name}[{mode}] {e:.3e}")
            if not e <= TOL:
                raise SystemExit(f"{name} disagrees with its plain version "
                                 f"[{label}, {mode}]: {e:.3e}")
            if kw_m["precision"] == kw["precision"]:
                errs[name] = float((got - want).abs().max())
            del got, want
    # K5: the grid plan's call (int32 words and f32 visibilities in one
    # launch) is a copy, so bit for bit.
    args, kw = captured["place_stream"][0]
    got = place.place_stream(*args, **kw)
    want = place.place_stream_reference(*args, **kw)
    same = all(torch.equal(a.view(torch.int32), b.view(torch.int32))
               for a, b in zip(got, want))
    errs["place_stream"] = max(float((a.float() - b.float()).abs().max())
                               for a, b in zip(got, want))
    lines.append(f"place_stream {'bit-equal' if same else 'DIFFERS'}")
    k3 = captured["grid_fused_stack"][0][0]
    say(f"# stream kernels vs plain [{label}]: " + ", ".join(lines)
        + f" (tolerance {TOL:g}; {k3[0].shape[0]} blocks of "
        f"{sp.block_v}, {k3[3].shape[0]} slots, {len(args[2])} payloads)")
    if not same:
        raise SystemExit(f"place_stream disagrees with its plain version "
                         f"[{label}]")
    return errs, captured, counts


def check_np_kernels(torch, StreamingGridder, StreamingDegridder, sp, uvw,
                     vis, model, label, fast=False):
    """K6, K7 and the fold kernel, with K5, K8 and K11 at these shapes,
    against their plain versions on the operands one non-packable
    accumulate and predict (``fast`` as given) pass them (captured on the
    plain path); the fold also with NaN in every unvisited window, which
    it must never read. Returns the absolute errors, the captured operands
    and the chunk's valid slots."""
    dev = uvw.device
    captured = {}
    sg = StreamingGridder(sp, fast=fast, device=dev)
    sd = StreamingDegridder(sp, fast=fast, device=dev).set_model(model)
    if sg._engine.packable:
        raise SystemExit(f"the {label} plan is packable")
    with plain_np_kernels(captured):
        sg.accumulate(uvw, vis)
        sd.predict(uvw)
    valid = int(sg.counters()[0])
    errs, lines = {}, []
    for name, mod in np_modules().items():
        args, kw = captured[name][0]
        if name == "fold_windows":
            nan_wins = args[0].clone()
            nan_wins[:, ~args[1]] = float("nan")
            calls = [("", args), (" (NaN unvisited)", (nan_wins,) + args[1:])]
        else:
            calls = [("", args)]
        want = getattr(mod, name + "_reference")(*args, **kw)
        want = want if isinstance(want, (tuple, list)) else (want,)
        for tag, c_args in calls:
            got = getattr(mod, name)(*c_args, **kw)
            got = got if isinstance(got, (tuple, list)) else (got,)
            torch.cuda.synchronize()
            if name == "place_stream":
                # A copy: bit for bit.
                same = all(torch.equal(a.view(torch.int32),
                                       b.view(torch.int32))
                           for a, b in zip(got, want))
                e = 0.0 if same else float("inf")
            else:
                e = max(rel_err(a, b) for a, b in zip(got, want))
            finite(torch, [(f"{name}{tag}", a) for a in got])
            bits = all(torch.equal(a, b) for a, b in zip(got, want))
            if (name.startswith("stream_prep") or name == "fold_windows") \
                    and not bits:
                raise SystemExit(f"{name} is not bit-equal to its plain "
                                 f"version [{label}]")
            lines.append(f"{name}{tag} {e:.3e}"
                         + (" (bit-equal)" if bits else ""))
            if not e <= TOL:
                raise SystemExit(f"{name}{tag} disagrees with its plain "
                                 f"version [{label}]: {e:.3e}")
            errs.setdefault(name, max(
                float((a.to(b.dtype if b.is_complex() else torch.float64)
                       - b).abs().max()) for a, b in zip(got, want)))
            del got
        del want
    say(f"# non-packable stream kernels vs plain [{label}]: "
        + ", ".join(lines) + f" (tolerance {TOL:g}; {sp.num_blocks} blocks "
        f"of {sp.block_v}, {sp.cap} slots, {valid} valid, "
        f"{int(captured['fold_windows'][0][0][1].sum())} visited buckets "
        f"of {sp.num_buckets})")
    return errs, captured, valid


def check_prep_instances(torch, captured, label):
    """K6 and K7 through both kernel instances, f32 and bf16, bit for bit
    against their plain versions on the fields of ``captured`` (one
    non-packable pass's calls, :func:`check_np_kernels`): the unrolled
    instance on the pass's own fits, the generic one on the fits of
    PREP_GENERIC_FITS (seeded random coefficients)."""
    from ska_sdp_func_torch.kernels import stream_prep

    rng = np.random.default_rng(14)
    lines = []
    for name in ("stream_prep_grid", "stream_prep_degrid"):
        args, _ = captured[name][0]
        head, (c_uv, c_w, ov, wov) = args[:-4], args[-4:]
        fits = [(c_uv, c_w)] + [
            tuple(torch.as_tensor(rng.standard_normal((n, k)),
                                  dtype=torch.float32, device=c_uv.device)
                  for k in (s_, sw)) for s_, sw, n in PREP_GENERIC_FITS]
        for uv, w in fits:
            for fast in (False, True):
                call = (*head, uv, w, ov, wov)
                got = getattr(stream_prep, name)(*call, fast=fast)
                want = getattr(stream_prep, name + "_reference")(
                    *call, fast=fast)
                torch.cuda.synchronize()
                inst = stream_prep.instance(name == "stream_prep_grid", fast,
                                            *uv.shape, w.shape[1])
                if not all(torch.equal(a, b) for a, b in zip(got, want)):
                    raise SystemExit(f"{name} ({inst}, Sw {w.shape[1]}) is "
                                     f"not bit-equal to its plain version "
                                     f"[{label}]")
                lines.append(f"{inst} Sw {w.shape[1]}")
                del got, want
    say(f"# K6/K7 instances vs plain [{label}], each bit-equal: "
        + ", ".join(lines))


def word_operands(torch, sp, uvw, vis, model):
    """Window l's operands, from window f's packable stream: the engine's
    placed plan words, visibilities, block table and occupancy for the
    chunk ``uvw``/``vis``, and the plane-major form ``[2, T K, G + 8, G]``
    of its model stack with each block's tile (plane ``task * K + slab``,
    octet ``g``, ``hv`` 0), as the JAX engine derives them
    (streaming.py:1090-1095). Returns (K18 arguments, K19 arguments,
    keywords, valid slots, K19's own keywords: ``raw`` and, where the
    package has the window-gather kernels, the run table built once as a
    plan's would be)."""
    from ska_sdp_func_torch.parallel import streaming

    dev = uvw.device
    eng = streaming._stream_engine(sp, False, dev)
    if not eng.packable:
        raise SystemExit("window f's plan is not packable")
    _, uvw32, mask = streaming._padded_chunk(sp, uvw, dev)
    arrays, _, bb, _, processed, _, _ = eng._plan_chunk(
        uvw32, mask, vis.real.contiguous(), vis.imag.contiguous(),
        need_unsort=False)
    task, slab, octet = eng._block_coords(bb)
    g = sp.wplan.subgrid_size
    planes = eng._model_stack(model).reshape(
        -1, 2, sp.num_layers, g + 8, g).transpose(0, 1).reshape(
            2, len(sp.tasks) * sp.num_layers, g + 8, g).contiguous()
    words = (arrays["packed_a"], arrays["packed_b"])
    coeffs = (eng.uv_coeffs, eng.w_coeffs)
    grid_args = (bb, *words, arrays["vre"], arrays["vim"], *coeffs,
                 sp.num_buckets, g)
    degrid_args = (planes, (task * sp.num_layers + slab).to(torch.int32),
                   octet, torch.zeros_like(octet), *words, *coeffs, g)
    kw = dict(support=sp.wplan.support, w_support=sp.wplan.w_support,
              oversampling=sp.wplan.oversampling,
              w_oversampling=sp.wplan.w_oversampling, block_v=sp.block_v,
              nonempty=arrays["nonempty"])
    from ska_sdp_func_torch.kernels import packed_tap

    degrid_kw = dict(raw=True)
    if hasattr(packed_tap, "degrid_runs"):
        degrid_kw["runs"] = packed_tap.degrid_runs(degrid_args[1:4])
    return grid_args, degrid_args, kw, int(processed), degrid_kw


def check_word_kernels(torch, grid_args, degrid_args, kw, degrid_kw,
                       grid_kw):
    """K18 and K19 against their plain versions in the three modes, and
    at "highest" against K8/K11 fed the same taps (``cheb_taps`` of the
    words; w taps times ``valid``, visibilities and taps of empty blocks
    zero). Returns their absolute errors at "highest"."""
    from ska_sdp_func_torch.kernels import band_tap as bt
    from ska_sdp_func_torch.kernels import fused_tap as tf

    calls = (("grid_fused", grid_args, grid_kw),
             ("degrid_fused2", degrid_args, degrid_kw))
    errs, lines, out = {}, [], {}
    for name, args, extra in calls:
        for mode in MODES:
            kw_m = {**kw, **extra, "precision": mode}
            got = getattr(bt, name)(*args, **kw_m)
            want = getattr(bt, name + "_reference")(*args, **kw_m)
            torch.cuda.synchronize()
            finite(torch, [(f"{name}[{mode}]", got)])
            e = rel_err(got, want)
            lines.append(f"{name}[{mode}] {e:.3e}")
            if not e <= TOL:
                raise SystemExit(f"{name} disagrees with its plain version "
                                 f"[{mode}]: {e:.3e}")
            if mode == "highest":
                errs[name] = float((got - want).abs().max())
                out[name] = got
            del want
    # K8 and K11 fed the words' taps.
    bb, pa, pb, vre, vim, c_uv, c_w, num_buckets, lanes = grid_args
    occ = torch.repeat_interleave(kw["nonempty"] != 0, kw["block_v"])
    iv0, u_off, w_row, u_frac, v_frac, valid = tf.unpack_plan_words(pa, pb)
    uk = tf.cheb_taps(u_frac, c_uv, kw["oversampling"])
    vk = tf.cheb_taps(v_frac, c_uv, kw["oversampling"])
    wk_t = tf.cheb_taps(w_row, c_w, kw["w_oversampling"]).T.contiguous()
    e_grid = rel_err(out["grid_fused"], bt.grid_packed(
        bb, u_off, iv0, uk, vk, (wk_t, vre * occ, vim * occ), num_buckets,
        lanes, kw["w_support"], block_v=kw["block_v"]))
    planes, p_idx, g_idx, hv_idx = degrid_args[:4]
    e_degrid = rel_err(out["degrid_fused2"], bt.degrid_fused(
        planes, p_idx, g_idx, hv_idx, u_off, iv0, uk, vk,
        (wk_t * valid * occ).contiguous(), kw["w_support"], lanes,
        block_v=kw["block_v"], raw=True))
    torch.cuda.synchronize()
    say(f"# word-fed bucket-window kernels vs plain (window f's operands: "
        f"{pa.shape[0]} slots, {num_buckets} buckets, windows "
        f"{tuple(out['grid_fused'].shape)}): " + ", ".join(lines)
        + f" (tolerance {TOL:g}); at 'highest' vs K8/K11 on the same taps: "
        f"grid {e_grid:.3e}, degrid {e_degrid:.3e} (tolerance {TOL:g})")
    if not (e_grid <= TOL and e_degrid <= TOL):
        raise SystemExit("K18/K19 disagree with K8/K11 on the same taps")
    return errs


@contextlib.contextmanager
def launch_window(torch, tkern, label, need, idle=()):
    """Counts the kernel launches of one main path: zeroes the counters,
    runs the block, reads them into the yielded dict. Fails if a kernel
    in ``need`` was never launched, or one in ``idle`` was."""
    counts = {}
    idle = set(idle) | (set(EXPERIMENT_KERNELS) - set(need))
    torch.cuda.synchronize()
    tkern.reset_launch_counts()
    yield counts
    torch.cuda.synchronize()
    counts.update(tkern.launch_counts())
    say(f"# {label} launches: {json.dumps(counts)}")
    missing = [n for n in need if counts[n] < 1]
    stray = [n for n in sorted(idle) if counts[n] > 0]
    if missing or stray:
        raise SystemExit(f"{label}: kernels never launched {missing}, "
                         f"launched off their path {stray}")


def device_us(torch, fn, iters: int = 20):
    """(microseconds of device work per call, kernel names, device
    operations per call) by ``torch.profiler`` over ``iters`` calls after
    one warm-up: the device's own kernels, memsets and copies (not the
    host calls that launched them, which carry the same time); (None, [],
    0) where the trace holds no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    total = sum(e.self_device_time_total for e in rows) / iters
    count = sum(e.count for e in rows) / iters
    names = set()
    for e in rows:
        words = [w for w in re.findall(r"([A-Za-z_]\w*)\s*[<(]", e.key)
                 if w not in ("void", "anonymous")]
        names.add(words[0] if words else e.key.strip()[:40])
    return (total or None), sorted(names), count


def fallback_times(torch, dev, tplan, bplan, sort_index, valid, inv, uvw,
                   uvw_dev, vis_dev, model):
    """Window b's fallback calls, timed: for ``grid_all_bucketed``,
    ``degrid_all_bucketed`` of ``model`` and one major-cycle iteration
    (degrid, residual, grid, a 50-component Hogbom minor cycle), the ms
    per call by CUDA events (5, 5 and 2 calls after a warm-up) and the
    device time (us) and device operations per call by ``torch.profiler``.
    Only the drivers and the solver's steps are called, as every version
    of the port has them, so two checkouts compare on one card in turns.
    """
    from ska_sdp_func_torch.parallel import (
        degrid_all_bucketed,
        grid_all_bucketed,
        plan_bucketed,
    )
    from ska_sdp_func_torch.pipeline import major_cycle as mc

    def grid():
        return grid_all_bucketed(bplan, vis_dev, uvw_dev, sort_index, valid)

    def degrid():
        return degrid_all_bucketed(bplan, model, uvw_dev, sort_index, valid,
                                   inv)

    border = IMAGE // 16
    pb, ps, pv = plan_bucketed(mc.make_psf_plan(tplan, uvw), uvw)
    psf = grid_all_bucketed(pb, torch.ones_like(vis_dev), uvw_dev, ps, pv)
    peak = psf[IMAGE, IMAGE]
    psf = mc._norm_mask(psf, peak, 2 * border)
    stop = torch.zeros((), device=dev)
    state = {"model": torch.zeros((IMAGE, IMAGE), device=dev)}

    def major_cycle():
        p = degrid_all_bucketed(bplan, state["model"], uvw_dev, sort_index,
                                valid, inv)
        dirty = mc._norm_mask(grid_all_bucketed(
            bplan, vis_dev - p, uvw_dev, sort_index, valid), peak, border)
        delta, _ = mc._minor_cycle(dirty, psf, 0.1, stop, 50)
        state["model"] = state["model"] + delta

    out = {}
    for what, fn, iters in (("grid", grid, 5), ("degrid", degrid, 5),
                            ("major cycle", major_cycle, 2)):
        ms = cuda_ms(torch, fn, iters, warmup=1)
        d_us, _, d_ops = device_us(torch, fn, iters)
        out[what] = (ms, d_us, d_ops)
    return out


def packed_times(torch, dev):
    """Window a's calls and kernels, timed, on the package that is
    imported (so two checkouts compare on one card in turns, each run
    from its own root with ``--packed-times``): K1/K2 in "high" and
    "bf16" at the main path's operands (CUDA events, 20 calls, twice),
    and ``grid_sorted``, ``degrid_sorted`` and one major-cycle iteration
    (degrid, residual, grid, a 50-component Hogbom minor cycle): ms per
    call by CUDA events (10, 10 and 5 calls after a warm-up), then device
    time, busy share and device operations per call by ``torch.profiler``.
    Also the digests of two calls' outputs of each K1/K2 call (the grid
    adds each run's window by atomics, so its bits may move from call to
    call) and of K1/K2's machine code (:func:`sass_digests`). Only calls
    every version of the port has are made."""
    from ska_sdp_func_torch.kernels import _build
    from ska_sdp_func_torch.kernels import packed_tap as tk
    from ska_sdp_func_torch.parallel import (
        packed_gridder,
        plan_packed,
        plan_wstack,
    )
    from ska_sdp_func_torch.pipeline import major_cycle as mc

    uvw, vis = bench_inputs()
    plan = plan_wstack(uvw, C_0, C_0 / (100 * CHANS), CHANS, IMAGE, SUBGRID,
                       THETA, W_STEP, support=8, w_support=4,
                       w_tower_height=HEIGHT)
    pplan = plan_packed(plan, uvw)
    model = torch.zeros((IMAGE, IMAGE), dtype=torch.float32, device=dev)
    model[300, 200] = 1.0
    out = {"kernels": {}, "digests": {}, "calls": {},
           "sass": sass_digests(_build.build_info["path"],
                                ("grid_runs_kernel", "degrid_runs_kernel"))}
    for mode, kw in (("high", {}), ("bf16", dict(fast=True))):
        g = packed_gridder(pplan, device=dev, **kw)
        grid_args, degrid_args = kernel_operands(torch, g, pplan, dev, 12)
        # The run table where the gridder has one (built once a plan).
        call_kw = dict(block_v=pplan.block_v)
        if getattr(g, "runs", None) is not None:
            call_kw["runs"] = g.runs
        for name, fn, args in (("grid_packed_stack", tk.grid_packed_stack,
                                grid_args),
                               ("degrid_stack", tk.degrid_stack,
                                degrid_args)):
            out["kernels"][f"{name}[{mode}]"] = [
                cuda_ms(torch, lambda: fn(*args, **call_kw), 20)
                for _ in range(2)]
            out["digests"][f"{name}[{mode}]"] = [
                digest(fn(*args, **call_kw)) for _ in range(2)]
        del g, grid_args, degrid_args
    g = packed_gridder(pplan, device=dev)
    vre, vim = g.sort(vis)
    psf = packed_gridder(plan_packed(mc.make_psf_plan(plan, uvw), uvw),
                         device=dev).grid(np.ones((ROWS, CHANS), np.complex64))
    peak = psf[IMAGE, IMAGE]
    border = IMAGE // 16
    psf = mc._norm_mask(psf, peak, 2 * border)
    stop = torch.zeros((), device=dev)
    state = {"model": torch.zeros((IMAGE, IMAGE), device=dev)}

    def major_cycle():
        p = g.degrid_sorted(state["model"])
        rre, rim = mc._packed_residual(vre, vim, p, None)
        dirty = mc._norm_mask(g.grid_sorted(rre, rim), peak, border)
        delta, _ = mc._minor_cycle(dirty, psf, 0.1, stop, 50)
        state["model"] = state["model"] + delta

    for what, fn, iters in (
            ("grid_sorted", lambda: g.grid_sorted(vre, vim), 10),
            ("degrid_sorted", lambda: g.degrid_sorted(model), 10),
            ("major cycle", major_cycle, 5)):
        ms = cuda_ms(torch, fn, iters, warmup=1)
        d_us, _, d_ops = device_us(torch, fn, iters)
        out["calls"][what] = dict(
            ms=ms, device_ms=d_us / 1e3 if d_us else None,
            busy=d_us / 1e3 / ms if d_us else None, device_ops=d_ops,
            host_ms=host_ms(torch, fn, iters))
    return out


def host_ms(torch, fn, iters: int) -> float:
    """Host ms per call to enqueue ``fn`` (no synchronisation inside the
    timed calls): where it nears the wall time, the host sets the pace."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t = (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize()
    return t


def digest(out) -> str:
    """The first 16 hex digits of the SHA-256 of a kernel's output bytes
    (a tuple's outputs in order): two checkouts whose kernel sums in a
    fixed order (the window-gather degrids, the tap preparation) give
    equal digests when their results are bit-equal."""
    import hashlib

    import torch

    h = hashlib.sha256()
    for t in out if isinstance(out, (tuple, list)) else (out,):
        raw = torch.view_as_real(t) if t.is_complex() else t
        if raw.dtype == torch.bfloat16:
            raw = raw.view(torch.int16)
        h.update(raw.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def predict_times(torch, dev):
    """The three predicts and the window-gather kernels, timed on the
    package that is imported (two checkouts compare on one card in turns,
    each run from its own root with ``--predict-times``): the stages of
    :func:`predict_stages` on bench.py's dense stream (packable, and at
    oversampling 65536 in f32 and fast) and of the ES-FFT 3-D degrid of
    the bench data, then each kernel on its path's operands (CUDA events,
    20 calls, twice): K4 and K11 (f32, bf16) at the dense stream, K11 at
    the ES-FFT shapes, K7 (f32, bf16) on window j's and k's operands, K4
    and K13 of the packed engines at the bench scenario ("highest"), and
    K19 on window f's words (with the kernels' run table where the package
    has one), with the digest of each kernel's output (:func:`digest`).
    Only calls every version of the port has are made."""
    from ska_sdp_func_torch.grid_data import GridderUvwEsFft
    from ska_sdp_func_torch.kernels import band_tap, fused_tap, stream_prep
    from ska_sdp_func_torch.parallel import (
        PackedGridder,
        StreamingDegridder,
        packed,
        plan_packed,
        plan_stream,
        plan_wstack,
        stream_tasks,
    )

    uvw_d, vis_d = stream_inputs()
    uvw_dd = torch.as_tensor(uvw_d, device=dev)
    vis_dd = torch.as_tensor(vis_d, device=dev)
    model = torch.zeros((IMAGE, IMAGE), dtype=torch.float32, device=dev)
    model[300, 200] = 1.0

    def stream_plan(**kw):
        wplan = plan_wstack(uvw_d, C_0, C_0 / (100 * STREAM_CHANS),
                            STREAM_CHANS, IMAGE, SUBGRID, THETA, W_STEP,
                            support=8, w_support=4, w_tower_height=HEIGHT,
                            **kw)
        return plan_stream(wplan, stream_tasks(wplan, uvw_d),
                           chunk_rows=ROWS, block_v=STREAM_BLOCK_V,
                           cap_factor=STREAM_CAP_FACTOR)

    sp_d = stream_plan()
    sp_j = stream_plan(oversampling=NP_OVERSAMPLING,
                       w_oversampling=NP_W_OVERSAMPLING)
    sds = [StreamingDegridder(sp, fast=fast, device=dev).set_model(model)
           for sp, fast in ((sp_d, False), (sp_j, False), (sp_j, True))]
    uvw, vis = bench_inputs()
    freq = C_0 + np.arange(CHANS) * (C_0 / (100 * CHANS))
    pix = THETA / IMAGE
    es = GridderUvwEsFft(
        uvw, freq, vis, np.ones(vis.shape, np.float32),
        np.zeros((IMAGE, IMAGE), np.float32), pix, pix, ES_EPSILON,
        *GridderUvwEsFft.get_w_range(uvw, freq), True, device=dev)
    e_uvw, e_freq = (torch.as_tensor(x, device=dev) for x in (uvw, freq))
    e_zeros = torch.zeros(vis.shape, dtype=torch.complex64, device=dev)
    e_weight = torch.ones(vis.shape, device=dev)
    stages, calls = predict_stages(
        torch, *sds, lambda: es.ifft_degrid_uvw_es_fft(
            e_uvw, e_freq, e_zeros, e_weight, model), uvw_dd)
    kernels, digests = {}, {}

    def twice(name, fn, args, kw):
        kernels[name] = [cuda_ms(torch, lambda: fn(*args, **kw), 20)
                         for _ in range(2)]
        digests[name] = digest(fn(*args, **kw))

    for name, fn, key in (
            ("degrid_fused2_stack[dense stream]",
             fused_tap.degrid_fused2_stack, "degrid_fused2_stack"),
            ("degrid_fused[dense stream]", band_tap.degrid_fused,
             "non-packable predict"),
            ("degrid_fused[dense stream, bf16]", band_tap.degrid_fused,
             "non-packable predict, fast"),
            ("degrid_fused[ES-FFT 3-D]", band_tap.degrid_fused,
             "es degrid"),
            ("stream_prep_degrid[dense stream]",
             stream_prep.stream_prep_degrid, "non-packable predict K7"),
            ("stream_prep_degrid[dense stream, bf16]",
             stream_prep.stream_prep_degrid,
             "non-packable predict, fast K7")):
        twice(name, fn, *calls[key])
    del sds, calls, es
    wplan = plan_wstack(uvw, C_0, C_0 / (100 * CHANS), CHANS, IMAGE, SUBGRID,
                        THETA, W_STEP, support=8, w_support=4,
                        w_tower_height=HEIGHT)
    pplan = plan_packed(wplan, uvw)
    for engine, name in (("fused", "degrid_fused2_stack"),
                         ("compact", "degrid_compact")):
        g = PackedGridder(pplan, precision="highest", engine=engine,
                          device=dev)
        rec = []
        with recorded(packed, "fused_tap", (name,), rec):
            g.degrid_sorted(model)
        twice(f"{name}[packed bench]", getattr(fused_tap, name),
              *rec[-1][1:])
        del g, rec
    _, w_args, w_kw, _, w_dkw = word_operands(torch, sp_d, uvw_dd, vis_dd,
                                              model)
    twice("degrid_fused2[dense stream]", band_tap.degrid_fused2, w_args,
          dict(w_kw, **w_dkw))
    return dict(stages=stages, kernels=kernels, digests=digests)


def scatter_units(runs, block_v):
    """The window-scatter kernels' work in a call's run table: units (rows
    of count > 0) and most slots a unit; None where the call carries no
    table (a checkout before the redesign)."""
    if runs is None:
        return None
    slots = runs[:, 1][runs[:, 1] > 0].long() * block_v
    return dict(units=int(slots.numel()), max_slots=int(slots.max()))


def ingest_stages(torch, sg_f, sg_j, sg_k, es_plan, es, uvw, vis):
    """CUDA-event ms (10 calls each) of the ingests and their stages on
    the chunk ``uvw``/``vis``: the packable stream's ``accumulate``
    ``sg_f`` (plan + K5, the run table where the package builds one, K3,
    the drain), the non-packable ones ``sg_j`` (f32) and ``sg_k`` (fast):
    plan + K5, K6, the K8 stage (its run table included), the fold, the
    drain, K8 alone on the stage's own operands and the call three times
    more (``call repeats``: the host-bound calls' spread); and the ES-FFT 3-D
    grid ``es()`` of the plan ``es_plan``: K8 alone, the slab fold and the
    rest (FFTs, screens, the sort). Each rest is the whole call's time
    less its timed stages. The non-packable ingests also give the digest
    of the fold of seeded windows with NaN where unvisited (``fold
    digest``: equal where two checkouts' folds agree bit for bit). Also
    returns the kernels' captured calls (K6's under "<ingest> K6"), for
    their rows."""
    from ska_sdp_func_torch.grid_data import es_fft_packed
    from ska_sdp_func_torch.kernels import band_tap, fused_tap, packed_tap
    from ska_sdp_func_torch.parallel import streaming

    out, calls = {}, {}
    vre = vis.real.contiguous()
    vim = vis.imag.contiguous()

    def ms(fn):
        return cuda_ms(torch, fn, 10, warmup=1)

    def chunk(sg):
        eng = sg._engine
        _, uvw32, mask = streaming._padded_chunk(sg.splan, uvw, uvw.device)
        return eng, lambda: eng._plan_chunk(uvw32, mask, vre, vim,
                                            need_unsort=False)

    def rest(st):
        st["rest"] = st["call"] - sum(v for k, v in st.items()
                                      if k != "call")

    eng, plan = chunk(sg_f)
    rec = []
    with recorded(streaming, "fused_tap", ("grid_fused_stack",), rec):
        sg_f.accumulate(uvw, vis)
    args, kw = calls["stream ingest"] = rec[-1][1:]
    _, _, bb, visited, *_ = plan()
    tvis = visited.reshape(len(sg_f.splan.tasks), -1).any(dim=1)
    stack = fused_tap.grid_fused_stack(*args, **kw)
    st = dict(call=ms(lambda: sg_f.accumulate(uvw, vis)), plan=ms(plan))
    if "runs" in kw:
        st["run table"] = ms(lambda: packed_tap.degrid_runs((bb,)))
    st["K3"] = ms(lambda: fused_tap.grid_fused_stack(*args, **kw))
    st["drain"] = ms(lambda: eng._image_from_stack(stack, tvis))
    rest(st)
    st["units"] = scatter_units(kw.get("runs"), kw["block_v"])
    out["stream ingest"] = st
    del stack
    for name, sg in (("non-packable ingest", sg_j),
                     ("non-packable ingest, fast", sg_k)):
        eng, plan = chunk(sg)
        rec, prep = [], []
        with recorded(streaming, "band_tap", ("grid_packed",), rec), \
                recorded(streaming, "stream_prep", ("stream_prep_grid",),
                         prep):
            sg.accumulate(uvw, vis)
        args, kw = calls[name] = rec[-1][1:]
        calls[name + " K6"] = prep[-1][1:]
        a, _, bb, visited, *_ = plan()
        taps = eng._prep_grid(a)
        wins = eng._grid_windows(a, bb, *taps)
        layers = eng._fold_windows(wins, visited)
        st = dict(call=ms(lambda: sg.accumulate(uvw, vis)), plan=ms(plan),
                  K6=ms(lambda: eng._prep_grid(a)),
                  **{"K8 stage": ms(lambda: eng._grid_windows(
                      a, bb, *taps))},
                  fold=ms(lambda: eng._fold_windows(wins, visited)),
                  drain=ms(lambda: eng._drain(layers)))
        rest(st)
        # The fold of seeded windows (NaN where unvisited): its bits do not
        # hang on K8's sum order, so two checkouts' digests compare.
        gen = torch.Generator(device=wins.device).manual_seed(16)
        seeded = torch.randn(wins.shape, generator=gen, device=wins.device)
        seeded[:, ~visited] = float("nan")
        st["fold digest"] = digest(eng._fold_windows(seeded, visited))
        del seeded
        st["K8 alone"] = ms(lambda: band_tap.grid_packed(*args, **kw))
        st["call repeats"] = [ms(lambda: sg.accumulate(uvw, vis))
                              for _ in range(3)]
        st["units"] = scatter_units(kw.get("runs"), kw["block_v"])
        out[name] = st
        del a, bb, taps, wins, layers
    rec = []
    with captured_calls(es_fft_packed, "grid_packed", rec):
        es()
    calls["es grid"] = rec[-1]
    ep = es_plan._packed
    wins = [band_tap.grid_packed(*a, **k) for a, k in rec]
    visited = ep.dev["visited"]
    st = dict(call=ms(es),
              K8=ms(lambda: [band_tap.grid_packed(*a, **k) for a, k in rec]),
              fold=ms(lambda: [es_fft_packed._fold_slab(
                  w, visited[s], ep.gu, ep.gv, ep.w_support, ep.rows_pad,
                  ep.lanes_pad) for s, w in enumerate(wins)]))
    rest(st)
    st["units"] = scatter_units(rec[-1][1].get("runs"), ep.block_v)
    out["ES-FFT 3-D grid"] = st
    return out, calls


def ingest_times(torch, dev):
    """The ingests and the window-scatter kernels, timed on the package
    that is imported (two checkouts compare on one card in turns, each run
    from its own root with ``--ingest-times``): the stages of
    :func:`ingest_stages` on bench.py's dense stream (packable, and at
    oversampling 65536 in f32 and fast) and of the ES-FFT 3-D grid of the
    bench data; the packed ``engine="compact"`` and ``engine="fused"``
    ``grid_sorted`` at the bench scenario ("highest"); then each grid
    kernel on its path's operands (CUDA events, 20 calls, twice): K3 at
    the dense stream and the packed bench scenario, K8 (f32, bf16) at the
    dense stream and at the ES-FFT shapes, K6 (f32, bf16) on window j's
    and k's operands, with the digest of each K6 output (:func:`digest`),
    K12 at the packed bench scenario, and K18 on window f's words (with a
    run table built once, as a plan's, where the package takes one). Only
    calls every version of the port has are made."""
    import inspect

    from ska_sdp_func_torch.grid_data import GridderUvwEsFft
    from ska_sdp_func_torch.kernels import band_tap, fused_tap, packed_tap
    from ska_sdp_func_torch.kernels import stream_prep
    from ska_sdp_func_torch.parallel import (
        PackedGridder,
        StreamingGridder,
        packed,
        plan_packed,
        plan_stream,
        plan_wstack,
        stream_tasks,
    )

    uvw_d, vis_d = stream_inputs()
    uvw_dd = torch.as_tensor(uvw_d, device=dev)
    vis_dd = torch.as_tensor(vis_d, device=dev)
    model = torch.zeros((IMAGE, IMAGE), dtype=torch.float32, device=dev)
    model[300, 200] = 1.0

    def stream_plan(**kw):
        wplan = plan_wstack(uvw_d, C_0, C_0 / (100 * STREAM_CHANS),
                            STREAM_CHANS, IMAGE, SUBGRID, THETA, W_STEP,
                            support=8, w_support=4, w_tower_height=HEIGHT,
                            **kw)
        return plan_stream(wplan, stream_tasks(wplan, uvw_d),
                           chunk_rows=ROWS, block_v=STREAM_BLOCK_V,
                           cap_factor=STREAM_CAP_FACTOR)

    sp_d = stream_plan()
    sp_j = stream_plan(oversampling=NP_OVERSAMPLING,
                       w_oversampling=NP_W_OVERSAMPLING)
    sgs = [StreamingGridder(sp, fast=fast, device=dev)
           for sp, fast in ((sp_d, False), (sp_j, False), (sp_j, True))]
    uvw, vis = bench_inputs()
    freq = C_0 + np.arange(CHANS) * (C_0 / (100 * CHANS))
    pix = THETA / IMAGE
    es = GridderUvwEsFft(
        uvw, freq, vis, np.ones(vis.shape, np.float32),
        np.zeros((IMAGE, IMAGE), np.float32), pix, pix, ES_EPSILON,
        *GridderUvwEsFft.get_w_range(uvw, freq), True, device=dev)
    e_args = [torch.as_tensor(x, device=dev) for x in (uvw, freq, vis)]
    e_weight = torch.ones(vis.shape, device=dev)
    e_dirty = torch.zeros((IMAGE, IMAGE), device=dev)

    def es_grid():
        return es.grid_uvw_es_fft(*e_args, e_weight, e_dirty)

    stages, calls = ingest_stages(torch, *sgs, es, es_grid, uvw_dd, vis_dd)
    kernels, digests = {}, {}

    def twice(name, fn, args, kw):
        kernels[name] = [cuda_ms(torch, lambda: fn(*args, **kw), 20)
                         for _ in range(2)]

    for name, key in (("stream_prep_grid[dense stream]",
                       "non-packable ingest K6"),
                      ("stream_prep_grid[dense stream, bf16]",
                       "non-packable ingest, fast K6")):
        twice(name, stream_prep.stream_prep_grid, *calls[key])
        digests[name] = digest(stream_prep.stream_prep_grid(
            *calls[key][0], **calls[key][1]))

    for name, fn, key in (
            ("grid_fused_stack[dense stream]", fused_tap.grid_fused_stack,
             "stream ingest"),
            ("grid_packed[dense stream]", band_tap.grid_packed,
             "non-packable ingest"),
            ("grid_packed[dense stream, bf16]", band_tap.grid_packed,
             "non-packable ingest, fast"),
            ("grid_packed[ES-FFT 3-D]", band_tap.grid_packed, "es grid")):
        twice(name, fn, *calls[key])
    del sgs, calls, es
    wplan = plan_wstack(uvw, C_0, C_0 / (100 * CHANS), CHANS, IMAGE, SUBGRID,
                        THETA, W_STEP, support=8, w_support=4,
                        w_tower_height=HEIGHT)
    pplan = plan_packed(wplan, uvw)
    vis_b = torch.as_tensor(vis, device=dev)
    for engine, name in (("fused", "grid_fused_stack"),
                         ("compact", "grid_compact")):
        g = PackedGridder(pplan, precision="highest", engine=engine,
                          device=dev)
        vre, vim = g.sort(vis_b)
        rec = []
        with recorded(packed, "fused_tap", (name,), rec):
            g.grid_sorted(vre, vim)
        stages[f"packed grid_sorted, engine={engine!r}"] = dict(
            call=cuda_ms(torch, lambda: g.grid_sorted(vre, vim), 10,
                         warmup=1))
        twice(f"{name}[packed bench]", getattr(fused_tap, name),
              *rec[-1][1:])
        del g, rec
    w_args, _, w_kw, _, _ = word_operands(torch, sp_d, uvw_dd, vis_dd,
                                          model)
    if "runs" in inspect.signature(band_tap.grid_fused).parameters:
        w_kw = dict(w_kw, runs=packed_tap.degrid_runs((w_args[0],)))
    twice("grid_fused[dense stream]", band_tap.grid_fused, w_args, w_kw)
    return dict(stages=stages, kernels=kernels, digests=digests)


def sparse_place_times(torch, dev):
    """K20 and K5, timed on the package that is imported (two checkouts
    compare on one card in turns, each run from its own root with
    ``--sparse-place-times``): K20 in both modes on window m's operands
    (the fallback's largest task) and on random taps of the same count at
    N = 256; K5 at exp_place_dma's scale (P2f: 4 payloads) and on the
    dense stream's grid-plan call (window f's payloads, captured from one
    ``accumulate``). Each: wall ms a call by CUDA events (20 calls,
    twice), host ms to enqueue a call (:func:`host_ms`), device ms and
    device operations a call by ``torch.profiler`` (20 calls), the digest of its output (:func:`digest`) and whether two
    calls give equal bits; P2f also as exp_place_dma measures it (its
    chained wall ms, the NumPy oracle checked). Then the dense stream's
    plan stage (plan + K5) of the ingest and of the predict: ms (CUDA
    events, 10 calls, twice) and the digest of its placed arrays. Only
    calls every version of the port has are made."""
    from ska_sdp_func_torch.experiments import exp_place_dma
    from ska_sdp_func_torch.kernels import place
    from ska_sdp_func_torch.kernels import sparse_tap as ts
    from ska_sdp_func_torch.parallel import (
        StreamingDegridder,
        StreamingGridder,
        plan_bucketed,
        plan_stream,
        plan_wstack,
        stream_tasks,
        streaming,
    )

    out = {}

    def measure(name, fn):
        wall = [cuda_ms(torch, fn, 20) for _ in range(2)]
        d_us, names, ops = device_us(torch, fn)
        first = digest(fn())
        out[name] = dict(ms=wall, host_ms=host_ms(torch, fn, 20),
                         device_ms=d_us and d_us / 1e3, device_ops=ops,
                         device_kernels=names, digest=first,
                         repeat_equal=first == digest(fn()))

    uvw, vis = bench_inputs()
    uvw_dev = torch.as_tensor(uvw, device=dev)
    tplan = plan_wstack(uvw, C_0, C_0 / (100 * CHANS), CHANS, IMAGE,
                        TOWER_SUBGRID, THETA, W_STEP, support=8, w_support=4,
                        w_tower_height=HEIGHT)
    bplan, sort_index, valid = plan_bucketed(tplan, uvw)
    ops, _, _, _ = tower_operands(
        torch, dev, tplan, uvw_dev, torch.as_tensor(vis, device=dev), bplan,
        sort_index, valid, 22)
    sp_args, _, _ = sparse_operands(torch, dev, tplan, uvw_dev, bplan,
                                    sort_index, valid,
                                    ops["grid_all_layers"])
    del ops
    rng = np.random.default_rng(17)
    total, num_layers, wide = sp_args[0].shape[0], sp_args[8], 256

    def put(a, dtype):
        return torch.as_tensor(a, dtype=dtype, device=dev)

    wide_args = (put(rng.standard_normal(total), torch.float32),
                 put(rng.standard_normal(total), torch.float32),
                 put(rng.integers(0, wide - 7, total), torch.int32),
                 put(rng.integers(0, wide - 7, total), torch.int32),
                 put(rng.integers(0, num_layers - 3, total), torch.int32),
                 put(rng.standard_normal((total, 8)), torch.float32),
                 put(rng.standard_normal((total, 8)), torch.float32),
                 put(rng.uniform(0.1, 1, (total, 4)), torch.float32),
                 num_layers, wide, 8, 4)
    for tag, fast in (("", False), ("[bf16]", True)):
        for where, args in (("largest task", sp_args),
                            (f"N {wide}", wide_args)):
            measure(f"grid_all_layers_sparse{tag}[{where}]",
                    lambda a=args, f=fast: ts.grid_all_layers_sparse(
                        *a, fast=f))
    del sp_args, wide_args

    p2f = exp_place_dma.operands("cuda")
    uvw_d, vis_d = stream_inputs()
    uvw_dd = torch.as_tensor(uvw_d, device=dev)
    vis_dd = torch.as_tensor(vis_d, device=dev)
    wplan = plan_wstack(uvw_d, C_0, C_0 / (100 * STREAM_CHANS),
                        STREAM_CHANS, IMAGE, SUBGRID, THETA, W_STEP,
                        support=8, w_support=4, w_tower_height=HEIGHT)
    sp = plan_stream(wplan, stream_tasks(wplan, uvw_d), chunk_rows=ROWS,
                     block_v=STREAM_BLOCK_V, cap_factor=STREAM_CAP_FACTOR)
    sg = StreamingGridder(sp, device=dev)
    rec = []
    with recorded(streaming, "place", ("place_stream",), rec):
        sg.accumulate(uvw_dd, vis_dd)
    k5_args, k5_kw = rec[-1][1:]
    measure("place_stream[P2f]", lambda: place.place_stream(
        p2f["src0"], p2f["vcnt"], p2f["payloads"], p2f["bv"], p2f["cap"]))
    row = exp_place_dma.measure(p2f, exp_place_dma.launch(p2f))[0]
    out["P2f exp_place_dma"] = {k: row.get(k) for k in (
        "ms", "plain_ms", "sort_ms", "bound_ms", "bytes")}
    measure("place_stream[dense stream]",
            lambda: place.place_stream(*k5_args, **k5_kw))
    del p2f

    model = torch.zeros((IMAGE, IMAGE), dtype=torch.float32, device=dev)
    model[300, 200] = 1.0
    sd = StreamingDegridder(sp, device=dev).set_model(model)
    _, uvw32, mask = streaming._padded_chunk(sp, uvw_dd, dev)
    vre, vim = vis_dd.real.contiguous(), vis_dd.imag.contiguous()
    for name, eng, kw in (
            ("ingest plan + K5", sg._engine,
             dict(vre=vre, vim=vim, need_unsort=False)),
            ("predict plan + K5", sd._engine, {})):
        def plan(eng=eng, kw=kw):
            return eng._plan_chunk(uvw32, mask, **kw)

        arrays = plan()[0]
        out[name] = dict(
            ms=[cuda_ms(torch, plan, 10, warmup=1) for _ in range(2)],
            digest=digest(tuple(arrays[k] for k in sorted(arrays)
                                if torch.is_tensor(arrays[k]))))
    return out


def experiment_times(torch, dev):
    """The experiments' kernels P2b-P2e and P1, timed on the package that
    is imported (two checkouts compare on one card in turns, each run from
    its own root with ``--experiment-times``), at each experiment's scale:
    every ``bucket_dot`` variant at exp_dot's; ``grid_parity`` at slots 1,
    2 and 4 at exp_parity's; ``read_streams`` at 6 streams and at 1 at
    rooflines', with ATen's block sums and the wrapper's host ms a call
    (where it nears the kernel's time, the host sets the pace); the four
    ``overlap`` variants at exp_overlap's, with the overlap fraction of
    ``both`` and of ``both2`` each round. ms by CUDA events over 10 calls
    (after 2), twice, and a digest of each output (the first call's).
    Last, the SASS digests of K1/K2's, bucket_dot's, P1's, P2b's and the
    fold's kernels (equal digests: equal machine code).
    Calls only what every version of the port has (the drivers'
    ``operands``, the wrappers), with the drivers' run tables where they
    build them; ``torch.bmm``'s time in both dtypes (exp_dot's
    ``library_ms``: lhs_stream's and npair's operands, the product only)
    where the checkout's driver has it: it does not depend on the
    checkout. Returns one record a kernel."""
    from ska_sdp_func_torch.experiments import exp_dot, exp_overlap, \
        exp_parity, rooflines
    from ska_sdp_func_torch.kernels import _build
    from ska_sdp_func_torch.kernels import bucket_dot as bd
    from ska_sdp_func_torch.kernels import overlap as ov
    from ska_sdp_func_torch.kernels import read_probe

    def twice(fn):
        return [cuda_ms(torch, fn, 10) for _ in range(2)]

    def timed(fn):
        out = fn()
        return dict(ms=twice(fn), digest=digest(out))

    records = []
    ops = exp_dot.operands(dev)
    nbk, bv = ops["num_buckets"], ops["block_v"]
    dot = {}
    for variant, (form, _) in exp_dot.VARIANTS.items():
        _, ins = exp_dot.inputs(ops, variant)
        kw = {}
        if "runs" in ops:
            kw["runs"] = ops["pair_runs" if form == "npair" else "runs"]
        dot[variant] = timed(lambda: bd.bucket_dot(
            form, ops["ids"], ins, nbk, bv, **kw))
    library = {v: [exp_dot.library_ms(ops, v) for _ in range(2)]
               for v in ("lhs_stream", "lhs_stream_bf16", "npair",
                         "npair_bf16")
               if hasattr(exp_dot, "library_ms")}
    records.append(dict(kernel="bucket_dot[P2c, P2d]", variants=dot,
                        library=library))
    del ops
    torch.cuda.empty_cache()

    ops = exp_parity.operands(dev)
    kw = {"runs": ops["runs"]} if "runs" in ops else {}
    records.append(dict(kernel="grid_parity[P2e]", variants={
        f"slots{s_}": timed(lambda: bd.grid_parity(
            *exp_parity.args(ops), slots=s_, **kw))
        for s_ in (1, 2, 4)}))
    del ops
    torch.cuda.empty_cache()

    ops = rooflines.operands(dev)
    br, bc = ops["block_rows"], ops["block_cols"]
    probe, library = {}, {}
    for name, xs in (("6 streams", ops["xs"]), ("1 stream", ops["xs"][:1])):
        probe[name] = timed(
            lambda: read_probe.read_streams(xs, 1.0, br, bc)[1])
        probe[name]["host_ms"] = host_ms(
            torch, lambda: read_probe.read_streams(xs, 1.0, br, bc), 50)
        rows = xs[0].shape[0]
        library[name] = twice(
            lambda: [x.view(rows // br, br, -1).sum(1) for x in xs])
    records.append(dict(kernel="read_streams[P1]", variants=probe,
                        library=library))
    del ops
    torch.cuda.empty_cache()

    ops = exp_overlap.operands(dev)
    variants = {v: timed(lambda v=v: ov.overlap(
        v, ops["pa"], ops["pb"], ops["c"], exp_overlap.BLOCK,
        exp_overlap.SUB)) for v in ov.VARIANTS}
    fraction = {}
    for form in ("both", "both2"):
        fraction[form] = []
        for i in range(2):
            t = {v: r["ms"][i] for v, r in variants.items()}
            both = t["vpu"] + t["dot"]
            fraction[form].append((both - t[form]) / max(
                both - max(t["vpu"], t["dot"]), 1e-9))
    records.append(dict(kernel="overlap[P2b]", variants=variants,
                        overlap_fraction=fraction))
    del ops
    records.append(dict(kernel="sass", digests=sass_digests(
        _build.build_info["path"],
        ("grid_runs_kernel", "degrid_runs_kernel", "bucket_dot_kernel",
         "read_streams_kernel", "overlap_kernel", "fold_windows_kernel"))))
    return records


def product_library_ms(torch, tk, grid_args, degrid_args, block_v):
    """The K1/K2 rows' yardstick, the product alone: ms of one
    ``torch.bmm`` of the plain versions' materialised operands (f32 with
    TF32 off, then bf16), {name: (f32 ms, bf16 ms)}. The port never calls
    it."""
    t_idx, k_idx, g_idx, ubase, vband, (wk_t, vre, vim), _, num_layers, \
        lanes, w_support = grid_args
    stack, vband_t = degrid_args[0], degrid_args[5]
    nb = ubase.shape[1] // block_v

    def f32(band):
        return (band[0].float() + band[1].float()
                if isinstance(band, tuple) else band.float())

    def blocks(x):                       # [R, V] -> [NB, R, block_v]
        return x.reshape(x.shape[0], nb, block_v).permute(1, 0, 2)

    wk = blocks(wk_t)
    s_all = torch.cat([wk * vre.reshape(nb, 1, block_v),
                       wk * vim.reshape(nb, 1, block_v)], dim=1)
    u_all = (blocks(ubase)[:, None] * s_all[:, :, None]).reshape(
        nb, -1, block_v).contiguous()
    band = f32(vband).reshape(nb, block_v, lanes)
    rows = tk._window_rows(t_idx, k_idx, g_idx, w_support, num_layers, lanes)
    win = stack.reshape(-1, lanes)[rows.reshape(-1)].reshape(nb, -1, lanes)
    band_t = blocks(f32(vband_t)).contiguous()
    out = {}
    for name, a, b in (("grid_packed_stack", u_all, band),
                       ("degrid_stack", win, band_t)):
        a16, b16 = a.to(torch.bfloat16), b.to(torch.bfloat16)
        out[name] = (cuda_ms(torch, lambda: torch.bmm(a, b), 10),
                     cuda_ms(torch, lambda: torch.bmm(a16, b16), 10))
    return out


def timed(torch, fn):
    """(result, wall seconds) of one call, the card synchronised."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def solve_err(a, b, taper) -> float:
    """Two solves apart: the larger of the model's relative error and the
    final residual's, taper-weighted."""
    return max(rel_err(a.model, b.model),
               rel_err(a.residual * taper, b.residual * taper))


def finite(torch, named):
    for name, t in named:
        if not bool(torch.isfinite(t).all()):
            raise SystemExit(f"{name} is not finite")


def es_phase(torch, tkern, dev, uvw, vis, model):
    """4h: the ES-FFT gridder (K8, K11) on the bench data, 3-D and 2-D.
    Returns the plans, the window's launches, the kernels' absolute
    errors on the main path's operands and those operands."""
    from ska_sdp_func_torch.grid_data import GridderUvwEsFft
    from ska_sdp_func_torch.kernels import band_tap

    freq = C_0 + np.arange(CHANS) * (C_0 / (100 * CHANS))
    pix = THETA / IMAGE
    t0 = time.perf_counter()
    plans = {name: GridderUvwEsFft(
        uvw, freq, vis, np.ones(vis.shape, np.float32),
        np.zeros((IMAGE, IMAGE), np.float32), pix, pix, ES_EPSILON,
        *GridderUvwEsFft.get_w_range(uvw, freq), ws, device=dev)
        for name, ws in ES_LAYOUTS.items()}
    plan_time = time.perf_counter() - t0
    for name, p in plans.items():
        ep = p._packed
        say(f"# ES-FFT plan [{name}]: grid {p.grid_size}, support "
            f"{p.support}, {p.num_total_w_grids} w-planes, {ep.num_slabs} "
            f"slab(s), {ep.total} slots in {ep.num_blocks} blocks of "
            f"{ep.block_v}, {int(ep.arrays['visited'].sum())} occupied "
            f"buckets of {ep.gu * ep.gv} per slab, {ep.num_clipped} clipped")
    say(f"# ES-FFT plans: {plan_time:.2f} s host (both)")
    a = dict(uvw=torch.as_tensor(uvw, device=dev),
             freq=torch.as_tensor(freq, device=dev),
             vis=torch.as_tensor(vis, device=dev),
             weight=torch.ones(vis.shape, device=dev),
             dirty=torch.zeros((IMAGE, IMAGE), device=dev))
    zeros = torch.zeros_like(a["vis"])

    def es_grid(p, v=None):
        return p.grid_uvw_es_fft(a["uvw"], a["freq"],
                                 a["vis"] if v is None else v, a["weight"],
                                 a["dirty"])

    def es_degrid(p, image):
        return p.ifft_degrid_uvw_es_fft(a["uvw"], a["freq"], zeros,
                                        a["weight"], image)

    names = [n for n, _ in ES_KERNELS]
    others = [n for n in tkern.launch_counts() if n not in names]
    with launch_window(torch, tkern, "ES-FFT gridder", names,
                       others) as launches:
        out = {k: (es_grid(p), es_degrid(p, model))
               for k, p in plans.items()}
    ops = {}
    with plain_es_kernels(ops):
        plain = {k: (es_grid(p), es_degrid(p, model))
                 for k, p in plans.items()}
    rng = np.random.default_rng(7)
    x = torch.as_tensor(rng.standard_normal((IMAGE, IMAGE)),
                        dtype=torch.float32, device=dev)
    lines, ok = [], True
    for k, p in plans.items():
        img, pred = out[k]
        finite(torch, ((f"ES image [{k}]", img), (f"ES degrid [{k}]", pred)))
        if tuple(img.shape) != (IMAGE, IMAGE) or \
                tuple(pred.shape) != (ROWS, CHANS):
            raise SystemExit("ES-FFT outputs have the wrong shape")
        e_plain = max(rel_err(img, plain[k][0]), rel_err(pred, plain[k][1]))
        # The oracle path (per-plane scatter, FFT, screen) on the card.
        packed, p._packed = p._packed, None
        try:
            o_img, o_pred = es_grid(p), es_degrid(p, model)
        finally:
            p._packed = packed
        e_ogrid, e_odegrid = rel_err(img, o_img), rel_err(pred, o_pred)
        del o_img, o_pred
        # The independent witness: the oracle in f64 (complex128 inputs
        # take it by rule), against which the complex64 path is held.
        o_img = p.grid_uvw_es_fft(
            a["uvw"], a["freq"], a["vis"].to(torch.complex128),
            a["weight"].double(), a["dirty"].double())
        o_pred = p.ifft_degrid_uvw_es_fft(
            a["uvw"], a["freq"], zeros.to(torch.complex128),
            a["weight"].double(), model.double())
        e_fgrid = rel_err(img.double(), o_img)
        e_fdegrid = rel_err(pred.to(torch.complex128), o_pred)
        del o_img, o_pred
        # Adjointness: <grid(vis), x> against <vis * weight, degrid(x)>.
        ax = es_degrid(p, x).to(torch.complex128)
        lhs = float((img.double() * x.double()).sum())
        rhs = float((a["vis"].to(torch.complex128).conj() * a["weight"]
                     * ax).sum().real)
        e_adj = abs(lhs - rhs) / max(abs(lhs), abs(rhs))
        lines.append(f"[{k}] kernel vs plain path rel err {e_plain:.3e}, "
                     f"vs the f32 ES oracle: grid {e_ogrid:.3e}, degrid "
                     f"{e_odegrid:.3e} (tolerance {TOL:g}), vs the f64 ES "
                     f"oracle: grid {e_fgrid:.3e}, degrid {e_fdegrid:.3e} "
                     f"(tolerance {ES_ORACLE_TOL:g}), adjointness "
                     f"{e_adj:.3e} (tolerance 1e-5)")
        ok = ok and max(e_plain, e_ogrid, e_odegrid) <= TOL \
            and max(e_fgrid, e_fdegrid) <= ES_ORACLE_TOL and e_adj <= 1e-5
    # Taper-free (ES has no 1/PSWF border). The f64 oracle is the witness
    # the complex64 path is held to, at tests/test_es_fft.py's 5e-6 of
    # peak. The f32 oracle is a third f32 summation order over 1,048,576
    # visibilities, so two f32 orders meet at TOL.
    say("# ES-FFT gridder (bench visibilities, unit-point degrid): "
        + "; ".join(lines))
    if not ok:
        raise SystemExit("the ES-FFT gridder disagrees")
    # The kernels on the operands the path passed them (3-D, then 2-D),
    # K8 also with the scale stack built from the split form.
    errs, lines = {}, []
    g_args, g_kw = ops["grid_packed"][0]
    wk_t, vre, vim = g_args[5]
    stack_call = (g_args[:5] + (torch.cat([wk_t * vre, wk_t * vim]),)
                  + g_args[6:], g_kw)
    calls = [(n, c) for n in names for c in ops[n]] + [
        ("grid_packed", stack_call)]
    for i, (name, (args, kw)) in enumerate(calls):
        got = getattr(band_tap, name)(*args, **kw)
        want = getattr(band_tap, name + "_reference")(*args, **kw)
        torch.cuda.synchronize()
        e = rel_err(got, want)
        lines.append(f"{name} {e:.3e}")
        if not e <= TOL:
            raise SystemExit(f"{name} disagrees with its plain version "
                             f"[ES-FFT call {i}]: {e:.3e}")
        errs.setdefault(name, float((got - want).abs().max()))
        del got, want
    say("# ES-FFT kernels vs plain (3-D, 2-D, 3-D with the scale stack): "
        + ", ".join(lines) + f" (tolerance {TOL:g})")
    return dict(plans=plans, launches=launches, errs=errs, ops=ops,
                grid=es_grid, degrid=es_degrid)


def np_stage_times(torch, sd, uvw, vis):
    """CUDA-event ms of each stage of one non-packable accumulate step
    (plan + K5, K6, K8, fold, drain) and predict step (plan + K5 with the
    unsort map, K7, K11, unsort) of the degridder ``sd``'s stream, 10
    calls each on the chunk ``uvw``/``vis``: the engine's own stage
    methods, the ones its steps compose."""
    from ska_sdp_func_torch.parallel import streaming

    eng = sd._engine
    _, uvw32, mask = streaming._padded_chunk(sd.splan, uvw, uvw.device)
    vre, vim = vis.real.contiguous(), vis.imag.contiguous()
    out = {}

    def stage(name, fn):
        out[name] = cuda_ms(torch, fn, 10, warmup=1)
        return fn()

    a, _, bb, visited, *_ = stage("plan + K5", lambda: eng._plan_chunk(
        uvw32, mask, vre, vim, need_unsort=False))
    taps = stage("K6", lambda: eng._prep_grid(a))
    wins = stage("K8", lambda: eng._grid_windows(a, bb, *taps))
    layers = stage("fold", lambda: eng._fold_windows(wins, visited))
    stage("drain", lambda: eng._drain(layers))
    del a, taps, wins, layers
    a, dest, bb, *_ = stage("predict plan + K5", lambda: eng._plan_chunk(
        uvw32, mask))
    taps = stage("K7", lambda: eng._prep_degrid(a))
    raw = stage("K11", lambda: eng._degrid_windows(sd._st, a, bb, *taps))
    stage("unsort", lambda: eng._unsort(raw, dest))
    return out


def window_ptxas(log, kernel="window_gather_kernel",
                 pattern=r"ILi(\d)ELi(\d)E"):
    """{template arguments: registers, spill stores and loads} of each
    instance of the template ``kernel`` in nvcc's ``-Xptxas -v`` log, the
    arguments the integer groups of ``pattern`` after its mangled name
    (the window templates' (mode, form) by default)."""
    out, key = {}, None
    for line in log.splitlines():
        m = re.search(kernel + pattern, line)
        if m and "Compiling entry" in line:
            key = tuple(int(g) for g in m.groups())
            continue
        if key is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out.setdefault(key, {}).update(spill_stores=int(m[1]),
                                           spill_loads=int(m[2]))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out.setdefault(key, {})["registers"] = int(m[1])
            key = None
    return out


@functools.lru_cache(maxsize=None)
def sass_of(path):
    """``cuobjdump -sass`` of the kernel library at ``path``; None where
    the toolkit has no cuobjdump."""
    from ska_sdp_func_torch.kernels import _build

    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    if not os.path.isfile(tool):
        return None
    return subprocess.run([tool, "-sass", path], capture_output=True,
                          text=True, check=True, timeout=300).stdout


def sass_digests(path, names):
    """{mangled function: first 16 hex digits of the SHA-256 of its SASS
    instruction lines} for the functions of the kernel library at ``path``
    whose names hold one of ``names``: equal digests, equal machine code;
    None where the toolkit has no cuobjdump."""
    import hashlib

    sass = sass_of(path)
    if sass is None:
        return None
    out, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m[1] if any(n in m[1] for n in names) else None
            if name:
                out[name] = hashlib.sha256()
            continue
        if name and "/*" in line:
            out[name].update(line.strip().encode())
    return {k: h.hexdigest()[:16] for k, h in sorted(out.items())}


def sass_atomics(path):
    """{kernel: {instruction: count}} of the shared-memory atomics
    (``ATOMS.*``: a CAS loop shows as ``ATOMS.CAST.SPIN``) and the bulk
    reductions (``UBLKRED.*``) in the SASS of the kernel library at
    ``path`` (``cuobjdump -sass``), by kernel name; None where the toolkit
    has no cuobjdump."""
    sass = sass_of(path)
    if sass is None:
        return None
    out, kernel = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : \S*?\d+([a-z_]+_kernel)", line)
        if m:
            kernel = m[1]
            continue
        m = re.search(r"\b((?:ATOMS|UBLKRED)(?:\.[A-Z0-9]+)*)", line)
        if m and kernel:
            counts = out.setdefault(kernel, {})
            counts[m[1]] = counts.get(m[1], 0) + 1
    return out


@contextlib.contextmanager
def captured_calls(owner, attr, sink):
    """``owner.attr``, a wrapper the module ``owner`` imported by name,
    records each call's (arguments, keywords) into ``sink`` and launches
    as usual (the wrapper and its counter untouched; for a wrapper called
    through its module, see :func:`recorded`)."""
    fn = getattr(owner, attr)

    def call(*args, **kw):
        sink.append((args, kw))
        return fn(*args, **kw)

    setattr(owner, attr, call)
    try:
        yield sink
    finally:
        setattr(owner, attr, fn)


def gather_units(runs, block_v, w_support, width):
    """The window-gather kernels' work in a call's run table: units (rows
    of count > 0), most slots a unit, and MB of windows read (2 Sw slabs
    of 16 rows x width f32 a unit; a window too wide for shared memory
    whole is read again for each 1024 slots of a unit, which no unit of
    these paths reaches); None where the call carries no table (a
    checkout before the redesign)."""
    if runs is None:
        return None
    slots = runs[:, 1][runs[:, 1] > 0].long() * block_v
    return dict(units=int(slots.numel()), max_slots=int(slots.max()),
                window_mb=slots.numel() * 2 * w_support * 16 * width * 4
                / 1e6)


def predict_stages(torch, sd_f, sd_j, sd_k, es_degrid, uvw):
    """CUDA-event ms (10 calls each) of the three predicts and their
    stages on the chunk ``uvw``: the packable stream predict ``sd_f``
    (plan + K5 with the unsort map, the run table where the package
    builds one, K4, the rest), the non-packable predicts ``sd_j`` (f32)
    and ``sd_k`` (fast): plan + K5, K7, the K11 stage (its run table
    included), unsort, K11 alone on the stage's own operands and the call
    three times more (``call repeats``); and the ES-FFT 3-D degrid
    ``es_degrid()``: K11 alone and the rest. Each rest
    is the whole call's time less its timed stages. Also returns the
    kernels' captured calls (K7's under "<predict> K7"), for their
    rows."""
    from ska_sdp_func_torch.grid_data import es_fft_packed
    from ska_sdp_func_torch.kernels import band_tap, fused_tap
    from ska_sdp_func_torch.kernels import packed_tap
    from ska_sdp_func_torch.parallel import streaming

    table = getattr(packed_tap, "degrid_runs", None)
    out, calls = {}, {}

    def ms(fn):
        return cuda_ms(torch, fn, 10, warmup=1)

    eng = sd_f._engine
    _, uvw32, mask = streaming._padded_chunk(sd_f.splan, uvw, uvw.device)
    rec = []
    with recorded(streaming, "fused_tap", ("degrid_fused2_stack",), rec):
        sd_f.predict(uvw)
    args, kw = calls["degrid_fused2_stack"] = rec[-1][1:]
    bb = eng._plan_chunk(uvw32, mask)[2]
    st = dict(call=ms(lambda: sd_f.predict(uvw)),
              plan=ms(lambda: eng._plan_chunk(uvw32, mask)))
    if table is not None:
        st["run table"] = ms(lambda: table((bb,)))
    st["K4"] = ms(lambda: fused_tap.degrid_fused2_stack(*args, **kw))
    st["rest"] = st["call"] - sum(v for k, v in st.items() if k != "call")
    st["units"] = gather_units(kw.get("runs"), kw["block_v"],
                               kw["w_support"], args[0].shape[3])
    out["stream predict"] = st
    for name, sd in (("non-packable predict", sd_j),
                     ("non-packable predict, fast", sd_k)):
        eng = sd._engine
        _, uvw32, mask = streaming._padded_chunk(sd.splan, uvw, uvw.device)
        rec, prep = [], []
        with recorded(streaming, "band_tap", ("degrid_fused",), rec), \
                recorded(streaming, "stream_prep", ("stream_prep_degrid",),
                         prep):
            sd.predict(uvw)
        args, kw = calls[name] = rec[-1][1:]
        calls[name + " K7"] = prep[-1][1:]
        a, dest, bb, *_ = eng._plan_chunk(uvw32, mask)
        taps = eng._prep_degrid(a)
        raw = eng._degrid_windows(sd._st, a, bb, *taps)
        st = dict(call=ms(lambda: sd.predict(uvw)),
                  plan=ms(lambda: eng._plan_chunk(uvw32, mask)),
                  K7=ms(lambda: eng._prep_degrid(a)),
                  **{"K11 stage": ms(lambda: eng._degrid_windows(
                      sd._st, a, bb, *taps))},
                  unsort=ms(lambda: eng._unsort(raw, dest)))
        st["rest"] = st["call"] - sum(v for k, v in st.items()
                                      if k != "call")
        st["K11 alone"] = ms(lambda: band_tap.degrid_fused(*args, **kw))
        st["call repeats"] = [ms(lambda: sd.predict(uvw)) for _ in range(3)]
        st["units"] = gather_units(kw.get("runs"), kw["block_v"], args[9],
                                   args[10])
        out[name] = st
        del a, dest, bb, taps, raw
    rec = []
    with captured_calls(es_fft_packed, "degrid_fused", rec):
        es_degrid()
    args, kw = calls["es degrid"] = rec[-1]
    st = dict(call=ms(es_degrid),
              K11=ms(lambda: band_tap.degrid_fused(*args, **kw)))
    st["rest"] = st["call"] - st["K11"]
    st["units"] = gather_units(kw.get("runs"), kw["block_v"], args[9],
                               args[10])
    out["ES-FFT 3-D degrid"] = st
    return out, calls


def stage_text(stages):
    """One line of :func:`predict_stages`' numbers."""
    parts = []
    for name, st in stages.items():
        times = ", ".join(
            f"{k} " + ("/".join(f"{x:.3f}" for x in v)
                       if isinstance(v, list) else f"{v:.3f}")
            for k, v in st.items() if k not in ("call", "units"))
        u = st.get("units")
        parts.append(f"{name} {st['call']:.3f} ms = {times}" + (
            f" ({u['units']} work units of at most {u['max_slots']} slots, "
            f"{u['window_mb']:.1f} MB of windows read)" if u else ""))
    return "; ".join(parts)


def compact_phase(torch, tkern, PackedGridder, pplan, dev, vre, vim, model,
                  taper):
    """4i: the packed engine="compact" (K12, K13) at the bench scenario,
    "highest" and "bf16", against the plain path and the band engine.
    Returns the gridders, the window's launches, the kernels' absolute
    errors ("highest") and their operands."""
    from ska_sdp_func_torch.kernels import fused_tap

    band = {}
    for mode, kw in COMPACT_MODES.items():
        g = PackedGridder(pplan, engine="bands", device=dev, **kw)
        band[mode] = (g.grid_sorted(vre, vim), g.degrid_sorted(model))
        del g
    comp = {mode: PackedGridder(pplan, engine="compact", device=dev, **kw)
            for mode, kw in COMPACT_MODES.items()}
    if [g.engine for g in comp.values()] != ["compact"] * 2 or \
            comp["highest"].precision != "highest":
        raise SystemExit("the bench plan did not take the compact engine")
    names = [n for n, _ in COMPACT_KERNELS]
    others = [n for n in tkern.launch_counts() if n not in names]

    def run():
        return {m: (g.grid_sorted(vre, vim), g.degrid_sorted(model))
                for m, g in comp.items()}

    with launch_window(torch, tkern, "compact engine", names,
                       others) as launches:
        out = run()
    ops = {}
    with plain_compact_kernels(ops):
        plain = run()
    m = IMAGE // 8
    lines, ok = [], True
    for mode, (img, pred) in out.items():
        finite(torch, ((f"compact image [{mode}]", img),
                       (f"compact degrid [{mode}]", pred)))
        e_plain = max(rel_err(img * taper, plain[mode][0] * taper),
                      rel_err(pred, plain[mode][1]))
        b_img, b_pred = band[mode]
        e_int = rel_err(img[m:-m, m:-m], b_img[m:-m, m:-m])
        e_int_plain = rel_err(img[m:-m, m:-m], plain[mode][0][m:-m, m:-m])
        e_tap = rel_err(img * taper, b_img * taper)
        e_deg = rel_err(pred, b_pred)
        # bf16 rounds the same two factors in both engines; the f32 sums
        # come in another order, as in the CPU tests. The raw interior is
        # printed, not held: any two f32 summation orders of one image,
        # the kernel's and its own plain path's included, differ there
        # by ~1e-4 of peak once the 1/PSWF correction lifts the noise
        # next to the border (PERF.md).
        tol = 2e-6 if mode == "highest" else 1e-5
        lines.append(f"'{mode}' kernel vs plain path {e_plain:.3e} "
                     f"(tolerance {TOL:g}); vs the band engine: "
                     f"taper-weighted {e_tap:.3e}, degrid {e_deg:.3e} "
                     f"(tolerance {tol:g}); raw interior (margin {m}) vs "
                     f"the band engine {e_int:.3e}, vs the plain path "
                     f"{e_int_plain:.3e}")
        ok = ok and e_plain <= TOL and max(e_tap, e_deg) <= tol
    say("# compact engine (bench scenario): " + "; ".join(lines))
    if not ok:
        raise SystemExit("the compact engine disagrees")
    errs, lines = {}, []
    for name in names:
        args, kw = ops[name][0]          # the "highest" gridder's call
        for mode in ("highest", "bf16"):
            kw_m = {**kw, "precision": mode}
            got = getattr(fused_tap, name)(*args, **kw_m)
            want = getattr(fused_tap, name + "_reference")(*args, **kw_m)
            torch.cuda.synchronize()
            e = rel_err(got, want)
            lines.append(f"{name}[{mode}] {e:.3e}")
            if not e <= TOL:
                raise SystemExit(f"{name} disagrees with its plain version "
                                 f"[{mode}]: {e:.3e}")
            if mode == "highest":
                errs[name] = float((got - want).abs().max())
            del got, want
    say("# compact kernels vs plain (bench scenario): " + ", ".join(lines)
        + f" (tolerance {TOL:g})")
    return dict(gridders=comp, launches=launches, errs=errs, ops=ops)


def sparse_operands(torch, dev, plan, uvw_dev, bplan, sort_index, valid,
                    dense_ops):
    """Window m's operands: the fallback's largest task in the sparse form
    the bucketed driver makes before ``_slab_weights`` densifies it
    (``bucketed._stream_sparse_taps``: first layer ``j``, w taps ``wk``,
    ``keep``), ``wk`` zeroed where not kept; the visibilities of
    ``dense_ops`` (the same task's K16 operands). Returns (K20 arguments,
    the dense weights ``_slab_weights`` makes of them, valid slots)."""
    from ska_sdp_func_torch.grid_data.wtower import _slab_weights
    from ska_sdp_func_torch.parallel import bucketed as bk

    uvw_s, chan_idx, _, vld = bk._sorted_inputs(bplan, uvw_dev, sort_index,
                                                valid)
    iu0, iv0, uk, vk, j, wk, keep = bk._stream_sparse_taps(
        bplan, bk._device_constants(bplan, dev)["terms"], uvw_s, chan_idx,
        vld, plan.freq0_hz, plan.dfreq_hz)
    task = max(bplan.tasks, key=lambda t: t.size)
    sl = slice(task.start, task.start + task.size)
    wk = torch.where(keep[:, None], wk, 0.0)[sl].contiguous()
    vre, vim = dense_ops[0][:2]
    args = (vre, vim, iu0[sl], iv0[sl], j[sl].contiguous(), uk[sl],
            vk[sl], wk, task.num_layers, plan.subgrid_size, plan.support,
            plan.w_support)
    weights = _slab_weights(wk, j[sl], keep[sl], task.num_layers)
    return args, weights, int(keep[sl].sum())


def check_sparse_kernel(torch, ts, tt, args, weights):
    """K20 against its plain version in both modes, and against K16 fed
    ``_slab_weights`` of the same taps; returns the absolute errors."""
    errs, lines = {}, []
    for fast in (False, True):
        got = ts.grid_all_layers_sparse(*args, fast=fast)
        want = ts.grid_all_layers_sparse_reference(*args, fast=fast)
        torch.cuda.synchronize()
        finite(torch, [("grid_all_layers_sparse", got)])
        e = rel_err(got, want)
        tag = "[bf16]" if fast else ""
        lines.append(f"grid_all_layers_sparse{tag} {e:.3e}")
        if not e <= TOL:
            raise SystemExit(f"grid_all_layers_sparse{tag} disagrees with "
                             f"its plain version: {e:.3e}")
        errs[tag] = float((got - want).abs().max())
        if not fast:
            vre, vim, iu0, iv0, _, uk, vk, _, k, n, support, _ = args
            e_dense = rel_err(got, tt.grid_all_layers(
                vre, vim, iu0, iv0, uk, vk, weights, k, n, support))
            torch.cuda.synchronize()
        del got, want
    say(f"# sparse all-layer grid (K20) vs plain (the fallback's largest "
        f"task, {args[0].shape[0]} slots x {args[8]} layers): "
        + ", ".join(lines) + f"; vs K16 on _slab_weights of the same taps "
        f"{e_dense:.3e} (tolerance {TOL:g})")
    if not e_dense <= TOL:
        raise SystemExit("K20 disagrees with K16 on the same taps")
    return errs


def sparse_calls(torch, ts, args):
    """K20's calls in both modes on window m's operands: wall ms a call by
    CUDA events (20 calls, twice), device ms and device operations a call
    by ``torch.profiler`` (20 calls), and whether two calls give equal
    bits; fails if a call makes more than one device operation, if the
    trace holds no device time, or if two calls differ."""
    out, lines = {}, []
    for tag, fast in (("", False), ("[bf16]", True)):
        def call(fast=fast):
            return ts.grid_all_layers_sparse(*args, fast=fast)

        wall = [cuda_ms(torch, call, 20) for _ in range(2)]
        d_us, names, ops = device_us(torch, call)
        same = digest(call()) == digest(call())
        out[tag] = dict(wall_ms=wall, device_ms=d_us and d_us / 1e3,
                        device_ops=ops, device_kernels=names,
                        repeat_equal=same)
        lines.append(
            f"grid_all_layers_sparse{tag} {wall[0]:.4f}/{wall[1]:.4f} ms "
            f"wall, device " + (f"{d_us / 1e3:.4f} ms in {ops:g} operations "
                                f"({', '.join(names)})" if d_us
                                else "not measured (no device time in the "
                                "trace)")
            + f", two calls {'bit-equal' if same else 'DIFFER'}")
    say("# sparse all-layer grid (K20) calls (CUDA events 20 calls twice; "
        "torch.profiler 20 calls): " + "; ".join(lines))
    bad = [tag or "f32" for tag, r in out.items()
           if not r["device_ms"] or r["device_ops"] > 1
           or not r["repeat_equal"]]
    if bad:
        raise SystemExit(f"K20 {bad}: more than one device operation a "
                         f"call, no device time, or two calls differ")
    return out


def check_tower_fast(torch, tt, ops):
    """K14-K17 with ``fast=True`` against their bf16 plain versions (at
    TOL) and their f32 kernels (within TOWER_FAST_TOL, not equal);
    returns the absolute errors against the bf16 plain versions."""
    errs, lines = {}, []
    for name, _ in TOWER_KERNELS:
        args, kw = ops[name]
        kern = getattr(tt, name)
        got = kern(*args, **kw, fast=True)
        want = getattr(tt, name + "_reference")(*args, **kw, fast=True)
        f32 = kern(*args, **kw)
        torch.cuda.synchronize()
        if name == "grid_plane":
            got, want, f32 = got - args[0], want - args[0], f32 - args[0]
        e, e32 = rel_err(got, want), rel_err(got, f32)
        lines.append(f"{name}[bf16] vs plain {e:.3e}, vs f32 {e32:.3e}")
        if not (e <= TOL and 0 < e32 <= TOWER_FAST_TOL):
            raise SystemExit(f"{name}[bf16] disagrees: plain {e:.3e}, f32 "
                             f"{e32:.3e}")
        errs[name] = float((got - want).abs().max())
        del got, want, f32
    say("# w-towers kernels, bf16 mode: " + "; ".join(lines)
        + f" (tolerances {TOL:g} and {TOWER_FAST_TOL:g})")
    return errs


@contextlib.contextmanager
def recorded(owner, attr, names, record):
    """``owner.attr``, the kernel module a path calls its wrappers
    through, is replaced by a proxy whose named wrappers record each
    call's (name, arguments, keywords) into ``record`` and then launch
    as usual (the wrappers themselves, and their counters, untouched)."""
    module = getattr(owner, attr)

    class Proxy:
        def __getattr__(self, name):
            fn = getattr(module, name)
            if name not in names:
                return fn

            def call(*args, **kw):
                record.append((name, args, kw))
                return fn(*args, **kw)
            return call

    setattr(owner, attr, Proxy())
    try:
        yield record
    finally:
        setattr(owner, attr, module)


def bf16_bound_ok(torch, tt, name, args, got):
    """An all-layer call's bf16 result against its f32 twin, per output:
    within 2^-7 (1 + 2^-9) of the sum of |terms| (each term's two rounded
    operands, u = 2^-8), plus 1e-6 of max|f32| for the sum order."""
    ref = getattr(tt, name + "_reference")
    f32 = getattr(tt, name)(*args)
    if name == "grid_all_layers":
        vre, vim, iu0, iv0, uk, vk, w = args[:7]
        bound = ref(vre.abs(), vim.abs(), iu0, iv0, uk.abs(), vk.abs(),
                    w.abs(), *args[7:])
    else:
        layers, iu0, iv0, uk, vk, w = args[:6]
        bound = ref(torch.complex(layers.real.abs(), layers.imag.abs()),
                    iu0, iv0, uk.abs(), vk.abs(), w.abs(), *args[6:])
    ok = True
    for part in (torch.real, torch.imag):
        err = (part(got) - part(f32)).abs()
        ok = ok and not bool((err > 2 ** -7 * (1 + 2 ** -9) * part(bound)
                              + 1e-6 * part(f32).abs().max()).any())
    return ok


def fast_subgrid_phase(torch, tkern, tt, bk, wtower, subgrid_pair, dev,
                       ax, atv, idle):
    """4n, second part: window d's sub-grid gridder with the JAX
    package's switch set (restored after). Its fused drivers must call
    K16/K17 in bf16 mode, each call within the bf16 bound of its f32 twin;
    the outputs against the plain path on the card and against window d's
    f32 results ``ax``/``atv``. Returns the window's launches."""
    calls = []
    saved_env = os.environ.get(FAST_MXU)
    os.environ[FAST_MXU] = "1"
    try:
        with launch_window(torch, tkern, f"sub-grid gridder, {FAST_MXU}=1",
                           ("grid_all_layers", "degrid_all_layers"), idle
                           ) as launches, \
                recorded(wtower, "tower_tap",
                         ("grid_all_layers", "degrid_all_layers"), calls):
            fax, fatv, _, _ = subgrid_pair(dev)
        with plain_tower_kernels(bk, tt):
            pax, patv, _, _ = subgrid_pair(dev)
    finally:
        if saved_env is None:
            os.environ.pop(FAST_MXU)
        else:
            os.environ[FAST_MXU] = saved_env
    modes = sorted({(n, kw.get("fast")) for n, _, kw in calls})
    bound_ok = all(bf16_bound_ok(torch, tt, n, args,
                                 getattr(tt, n)(*args, fast=True))
                   for n, args, _ in calls)
    e_fplain = max(rel_err(fax, pax), rel_err(fatv, patv))
    e_fvis, e_fimg = rel_err(fax, ax), rel_err(fatv, atv)
    say(f"# sub-grid gridder with {FAST_MXU}=1: wrapper calls {modes}; "
        f"each call within the bf16 bound of its f32 twin: {bound_ok}; "
        f"kernel vs plain path rel err {e_fplain:.3e} (tolerance 1e-4); vs "
        f"window d's f32: visibilities {e_fvis:.3e}, sub-grid image "
        f"{e_fimg:.3e} (tolerance {CHAIN_TOL:g}; the kernels' envelope is "
        f"{TOWER_FAST_TOL:g})")
    if not (modes == [("degrid_all_layers", True), ("grid_all_layers", True)]
            and bound_ok and e_fplain <= 1e-4
            and 0 < e_fvis <= CHAIN_TOL and 0 < e_fimg <= CHAIN_TOL):
        raise SystemExit("the sub-grid gridder's bf16 mode disagrees")
    return launches


def solver_phase(torch, tkern, tk, dev, plan, uvw, g, small):
    """4o: ``major_cycle_imager(clean_algorithm="msclean")`` and
    ``fista_imager`` on ``plan``/``uvw`` with visibilities of
    :func:`bench_sky` predicted by the packed gridder ``g``, launching
    K1/K2 and nothing else, against the same calls on the plain path;
    then ``small`` = (plan, visibilities, uvw, source pixel) solved on
    the card against the CPU port, and a ``checkpoint_path`` resume.
    Returns the window's launches."""
    from ska_sdp_func_torch.parallel import packed as tpacked
    from ska_sdp_func_torch.pipeline import fista_imager, major_cycle_imager

    n = plan.image_size
    vis = g.degrid(bench_sky(torch, dev, n))
    kernels = ["grid_packed_stack", "degrid_stack"]
    ms_kw = dict(bucketed=True, clean_algorithm="msclean",
                 scale_list=MS_SCALES, device=dev)

    def solves():
        return (major_cycle_imager(plan, vis, uvw, n_major=2, **ms_kw),
                fista_imager(plan, vis, uvw, n_iter=FISTA_ITERS,
                             device=dev))

    with launch_window(torch, tkern, "solvers (msclean, FISTA)", kernels,
                       [k for k in tkern.launch_counts()
                        if k not in kernels]) as launches:
        (ms_res, fi_res), seconds = timed(torch, solves)
    with plain_kernels([(tpacked, k, tk) for k in kernels]):
        ms_plain, fi_plain = solves()
    finite(torch, (("msclean model", ms_res.model),
                   ("msclean restored", ms_res.restored),
                   ("FISTA model", fi_res.model)))
    if tuple(ms_res.model.shape) != (n, n) or \
            tuple(fi_res.model.shape) != (n, n):
        raise SystemExit("solver outputs have the wrong shape")
    e_ms = rel_err(ms_res.model, ms_plain.model)
    e_fi = rel_err(fi_res.model, fi_plain.model)
    # FISTA's residual norms |V - A y| against the data norm (the first
    # entry): the error of the difference scales with V, not with the
    # shrinking norm.
    e_fh = max(abs(a - b) for a, b in zip(fi_res.residual_norm,
                                          fi_plain.residual_norm)
               ) / fi_plain.residual_norm[0]
    ms_hist, fi_hist = ms_res.peak_history, fi_res.residual_norm
    say(f"# solvers ({vis.numel()} visibilities, {n}^2, {seconds:.2f} s "
        f"both): msclean scales {MS_SCALES}, 2 major cycles, peaks "
        f"{ms_hist}; FISTA {FISTA_ITERS} iterations, residual norms "
        f"{fi_hist[0]:.6g} -> {fi_hist[-1]:.6g}; kernel vs plain path: "
        f"msclean model rel err {e_ms:.3e}, FISTA model {e_fi:.3e}, FISTA "
        f"residual norms {e_fh:.3e} of the first (tolerance {SOLVE_TOL:g})")
    if not (max(e_ms, e_fi, e_fh) <= SOLVE_TOL
            and ms_hist[-1] < ms_hist[0] and fi_hist[-1] < fi_hist[0]):
        raise SystemExit("the solvers disagree with their plain path")
    del ms_plain, fi_plain
    # Small point-source solves: card vs CPU port.
    plan_s, vis_s, uvw_s, src = small
    small_kw = dict(bucketed=True, clean_algorithm="msclean",
                    scale_list=(0, 4, 8))
    ms_card = major_cycle_imager(plan_s, vis_s, uvw_s, device=dev,
                                 **small_kw)
    ms_cpu = major_cycle_imager(plan_s, vis_s, uvw_s, device="cpu",
                                **small_kw)
    fi_card = fista_imager(plan_s, vis_s, uvw_s, n_iter=5, device=dev)
    fi_cpu = fista_imager(plan_s, vis_s, uvw_s, n_iter=5, device="cpu")
    e_sms = rel_err(ms_card.model.cpu(), ms_cpu.model)
    e_sfi = rel_err(fi_card.model.cpu(), fi_cpu.model)
    say(f"# small point-source solves, card vs CPU: msclean model rel err "
        f"{e_sms:.3e}, FISTA model rel err {e_sfi:.3e} (tolerance "
        f"{SOLVE_TOL:g}); msclean flux at the source "
        f"{float(ms_card.model[src]):.4f}")
    if not (e_sms <= SOLVE_TOL and e_sfi <= SOLVE_TOL):
        raise SystemExit("the small solves disagree with the CPU port")
    # Checkpointing on the card: two cycles, then a resume to three,
    # against three uninterrupted cycles.
    path = os.path.join(ROOT, "build", "chip_smoke", "solve.npz")
    if os.path.exists(path):
        os.remove(path)
    full = major_cycle_imager(plan, vis, uvw, n_major=3, **ms_kw)
    major_cycle_imager(plan, vis, uvw, n_major=2, checkpoint_path=path,
                       **ms_kw)
    resumed = major_cycle_imager(plan, vis, uvw, n_major=3,
                                 checkpoint_path=path, **ms_kw)
    os.remove(path)
    e_ck = rel_err(resumed.model, full.model)
    say(f"# checkpoint_path (msclean, {n}^2): 2 cycles + resume to 3 vs 3 "
        f"uninterrupted: model rel err {e_ck:.3e} (tolerance "
        f"{SOLVE_TOL:g}: f32 atomics reorder the grid sums from run to "
        f"run), peaks {resumed.peak_history} vs {full.peak_history}")
    if not (e_ck <= SOLVE_TOL
            and len(resumed.peak_history) == len(full.peak_history)):
        raise SystemExit("the resumed solve disagrees")
    return launches


def experiments_phase(torch, tkern, gpu):
    """4p: each experiment's kernels through its driver at the experiment's
    own scale: one launch a variant in a window of its own, then each held
    against its plain version (the drivers raise past their tolerances)
    and timed. Returns {row name: (launches, result rows)}."""
    from ska_sdp_func_torch import experiments

    drivers = {d.NAME: d for d in experiments.drivers()}
    everything = list(tkern.launch_counts())
    sites = {}
    ops, ops_of = None, None
    for name, drv_name, variants, kernel, _, _, _ in EXPERIMENT_SITES:
        drv = drivers[drv_name]
        t0 = time.perf_counter()
        if ops_of != drv_name:      # exp_dot's two sites share operands
            ops = None
            torch.cuda.empty_cache()
            ops, ops_of = drv.operands("cuda"), drv_name
        with launch_window(torch, tkern, f"experiment {name}", [kernel],
                           [n for n in everything if n != kernel]) as cnt:
            outs = drv.launch(ops) if variants is None \
                else drv.launch(ops, variants)
        result = drv.measure(ops, outs)
        del outs
        sites[name] = (cnt[kernel], result)
        say(f"# [{gpu}] {name} ({time.perf_counter() - t0:.1f} s): " + "; "
            .join(f"{r['variant']} {r['ms']:.4f} ms (plain {r['plain_ms']:.3f}"
                  f", bound {r['bound_ms']:.4f} by {r['bound_by']}, rel err "
                  f"{r['rel_err']:.2e}" + (
                      f"; device {r['device_ms']:.4f} ms in "
                      f"{r['device_ops']:g} operations a call"
                      if r.get("device_ms") else "") + ")" for r in result))
        if drv_name == "exp_overlap":
            say(f"# [{gpu}] exp_overlap: overlap fraction "
                f"{drv.overlap_fraction(result):.3f} (both), "
                f"{drv.overlap_fraction(result, 'both2'):.3f} (both2) (1: "
                f"the build hides under the products; 0: they serialise)")
    del ops
    torch.cuda.empty_cache()
    return sites


def exp_row(name, source, where, launched, rows, headline, read_rate):
    """A kernel row of window p: the headline variant's numbers, every
    variant's in ``variants``."""
    head = next(r for r in rows if r["variant"] == headline)
    lib = next((r for r in rows if r.get("library_ms") is not None), None)
    return dict(name=name, route="cuda", source=source, replaces=where,
                launches=launched,
                max_abs_err=max(r["max_abs_err"] for r in rows),
                ms=head["ms"], plain_ms=head["plain_ms"],
                bound_ms=head["bound_ms"], bound_by=head["bound_by"],
                library_ms=None if lib is None else lib["library_ms"],
                library_variant=None if lib is None else lib["variant"],
                bound_ms_read_rate=read_rate_bound(
                    head["bytes"], head["bound_ms"], head["bound_by"],
                    read_rate),
                variants=rows)


def read_rate_bound(moved, bound_ms, bound_by, read_rate):
    """The bound with the bytes over the measured read rate (bytes/s)."""
    return max(moved / read_rate * 1e3,
               bound_ms if bound_by == "operations" else 0.0)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from ska_sdp_func_torch import kernels as tkern
    from ska_sdp_func_torch.grid_data import (
        GridderWtowerUVW,
        grid_correct_pswf,
        wstack_wtower_degrid_all,
        wstack_wtower_grid_all,
    )
    from ska_sdp_func_torch.grid_data import wtower
    from ska_sdp_func_torch.kernels import _build, fused_tap, place
    from ska_sdp_func_torch.kernels import packed_tap as tk
    from ska_sdp_func_torch.kernels import tower_tap as tt
    from ska_sdp_func_torch.parallel import (
        PackedGridder,
        StreamingDegridder,
        StreamingGridder,
        degrid_all_bucketed,
        degrid_all_tasks,
        grid_all_bucketed,
        grid_all_tasks,
        inverse_index_of,
        packed_gridder,
        plan_bucketed,
        plan_packed,
        plan_stream,
        plan_wstack,
        stream_tasks,
    )
    from ska_sdp_func_torch.parallel import bucketed as bk
    from ska_sdp_func_torch.kernels import sparse_tap as ts
    from ska_sdp_func_torch.pipeline import fista as fi
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
        if "registers" in line or "spill" in line or "Compiling" in line \
                or "wgmma" in line:
            say("#   ptxas" + line.split("ptxas", 1)[-1])
    ptxas, scatter_ptxas = (window_ptxas(_build.build_info["log"], k)
                            for k in ("window_gather_kernel",
                                      "window_scatter_kernel"))
    for kernel, found, names in (
            ("window_gather_kernel", ptxas,
             "K4 kStackWords, K13 kStackTaps, K11 kBandTaps, K19 "
             "kBandWords"),
            ("window_scatter_kernel", scatter_ptxas,
             "K3 kStackWords, K12 kStackTaps, K8 kBandTaps, K18 "
             "kBandWords")):
        say(f"# ptxas, {kernel}<MODE, FORM> ({names}): " + "; ".join(
            f"<{GATHER_MODES[m]}, {GATHER_FORMS[f]}> {v.get('registers')} "
            f"registers, spills {v.get('spill_stores')} B stored / "
            f"{v.get('spill_loads')} B loaded"
            for (m, f), v in sorted(found.items())))
        if _build.build_info["log"] and \
                len(found) != len(GATHER_MODES) * len(GATHER_FORMS):
            raise SystemExit(f"the build log lacks {kernel} entries")
    # (grid, bf16, ncoef, S) of each stream_prep_kernel instance.
    prep_regs = window_ptxas(_build.build_info["log"], "stream_prep_kernel",
                             r"ILb(\d)ELb(\d)ELi(\d+)ELi(\d+)E")
    say("# ptxas, stream_prep_kernel<GRID, BF16, NCOEF, S> (K6 GRID true, "
        "K7 false; unrolled 12, 8, generic 0, 0): " + "; ".join(
            f"<{str(bool(g)).lower()}, {str(bool(b)).lower()}, {n}, {s_}> "
            f"{v.get('registers')} "
            f"registers, spills {v.get('spill_stores')} B stored / "
            f"{v.get('spill_loads')} B loaded"
            for (g, b, n, s_), v in sorted(prep_regs.items())))
    if _build.build_info["log"] and len(prep_regs) != 8:
        raise SystemExit("the build log lacks stream_prep_kernel entries")
    # (compute, source, passes, ksplit, side) of each bucket_dot_kernel
    # instance and (unroll, streams) of each read_streams_kernel one.
    exp_ptxas = {}
    for kernel, pattern, names, count in (
            ("bucket_dot_kernel", r"ILi(\d)ELi(\d)ELi(\d)ELi(\d)ELb(\d)E",
             "<COMPUTE, ASRC, PASSES, KSPLIT, SIDE> (P2c-P2e; TF32X3 0, "
             "BF16 1; build 0, stream 1)", 12),
            ("read_streams_kernel", r"ILi(\d)ELi(\d)E",
             "<UNROLL, NMAX> (P1)", 3)):
        found = exp_ptxas[kernel] = window_ptxas(_build.build_info["log"],
                                                 kernel, pattern)
        say(f"# ptxas, {kernel}{names}: " + "; ".join(
            f"<{', '.join(map(str, k))}> {v.get('registers')} registers, "
            f"spills {v.get('spill_stores')} B stored / "
            f"{v.get('spill_loads')} B loaded"
            for k, v in sorted(found.items())))
        if _build.build_info["log"] and len(found) != count:
            raise SystemExit(f"the build log lacks {kernel} entries")
    # overlap_kernel<VARIANT> (P2b) and fold_windows_kernel<VEC> (K9 +
    # K10): registers, spills and a digest of each instance's SASS.
    for kernel, names, count, pattern in (
            ("overlap_kernel", "<VARIANT> (P2b; 0 dot, 1 vpu, 2 both, "
             "3 both2)", 4, r"ILi(\d)E"),
            ("fold_windows_kernel", "<VEC> (K9 + K10; 4 float4 rows, 1 "
             "single lanes)", 2, r"ILi(\d)E"),
            ("sparse_grid_kernel", "<BF16> (K20)", 2, r"ILb(\d)E"),
            ("place_stream_kernel", "<VEC> (K5, P2f; 1 16-byte vectors, 0 "
             "word by word)", 2, r"ILb(\d)E")):
        found = exp_ptxas[kernel] = window_ptxas(_build.build_info["log"],
                                                 kernel, pattern)
        say(f"# ptxas, {kernel}{names}: " + "; ".join(
            f"<{', '.join(map(str, k))}> {v.get('registers')} registers, "
            f"spills "
            f"{v.get('spill_stores')} B stored / {v.get('spill_loads')} B "
            f"loaded" for k, v in sorted(found.items())))
        if _build.build_info["log"] and len(found) != count:
            raise SystemExit(f"the build log lacks {kernel} entries")
    say("# SASS digests (cuobjdump -sass): " + json.dumps(sass_digests(
        _build.build_info["path"], ("overlap_kernel", "fold_windows_kernel",
                                    "sparse_grid_kernel",
                                    "place_stream_kernel"))))
    census = sass_atomics(_build.build_info["path"])
    say("# SASS (cuobjdump -sass), shared-memory atomics and bulk "
        "reductions by kernel: " + ("; ".join(
            f"{k} " + ", ".join(f"{i} x{n}" for i, n in sorted(v.items()))
            for k, v in sorted(census.items())) if census is not None
            else "not measured (no cuobjdump)"))

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

    uvw_dev = torch.as_tensor(uvw, device=dev)
    vis_dev = torch.as_tensor(vis, device=dev)
    plan_ss = plan_wstack(uvw_s, C_0, C_0 / 100, SMALL["chans"],
                          SMALL["image"], TOWER_SUBGRID, THETA,
                          SMALL["w_step"], support=8, w_support=4,
                          w_tower_height=HEIGHT)
    bplan_ss, sort_ss, valid_ss = plan_bucketed(plan_ss, uvw_s, block_v=128)
    ops_ss, shapes, _, _ = tower_operands(
        torch, dev, plan_ss, torch.as_tensor(uvw_s, device=dev),
        torch.as_tensor(vis_s, device=dev), bplan_ss, sort_ss, valid_ss, 21)
    say(f"# small tower operands: {shapes}")
    check_tower_kernels(torch, tt, ops_ss, "small")
    t0 = time.perf_counter()
    tplan = plan_wstack(uvw, C_0, C_0 / (100 * CHANS), CHANS, IMAGE,
                        TOWER_SUBGRID, THETA, W_STEP, support=8, w_support=4,
                        w_tower_height=HEIGHT)
    bplan, sort_index, valid = plan_bucketed(tplan, uvw)
    inv = inverse_index_of(sort_index, valid, num_vis)
    plan_time = time.perf_counter() - t0
    slabs = sorted({t.iw for t in tplan.tasks})
    say(f"# tower plan: {len(bplan.tasks)} tasks over {len(slabs)} w-slabs, "
        f"{min(t.num_layers for t in bplan.tasks)}-"
        f"{max(t.num_layers for t in bplan.tasks)} layers, {bplan.total} "
        f"slots ({plan_time:.2f} s host)")
    ops, shapes, tower_valid, plane_task = tower_operands(
        torch, dev, tplan, uvw_dev, vis_dev, bplan, sort_index, valid, 22)
    say(f"# main tower operands: {shapes}")
    tower_err = check_tower_kernels(torch, tt, ops, "main")
    task_names = [n for n, _ in TASK_KERNELS]
    wide_ops = {sup: wide_task_operands(torch, ops, sup, 30 + sup)
                for sup in WIDE_SUPPORTS}
    for sup, w_ops in wide_ops.items():
        check_tower_kernels(torch, tt, w_ops, f"main, support {sup}",
                            task_names)

    # The streaming path's kernels (K3, K4, K5): the small scenario, then
    # bench.py's dense stream (the operands of 4f).
    model = torch.zeros((IMAGE, IMAGE), dtype=torch.float32, device=dev)
    model[300, 200] = 1.0
    model_s = torch.zeros((SMALL["image"],) * 2, device=dev)
    model_s[SMALL["image"] // 3, SMALL["image"] // 2] = 1.0
    n_small = SMALL["rows"] * SMALL["chans"]
    sp_s = plan_stream(plan_s, stream_tasks(plan_s, uvw_s),
                       chunk_rows=SMALL["rows"], block_v=128,
                       cap_slots=128 * n_small)
    check_stream_kernels(torch, StreamingGridder, StreamingDegridder, sp_s,
                         torch.as_tensor(uvw_s, device=dev),
                         torch.as_tensor(vis_s, device=dev), model_s,
                         "small")
    uvw_d, vis_d = stream_inputs()
    num_vis_d = ROWS * STREAM_CHANS
    t0 = time.perf_counter()
    plan_d = plan_wstack(uvw_d, C_0, C_0 / (100 * STREAM_CHANS), STREAM_CHANS,
                         IMAGE, SUBGRID, THETA, W_STEP, support=8, w_support=4,
                         w_tower_height=HEIGHT)
    sp_d = plan_stream(plan_d, stream_tasks(plan_d, uvw_d), chunk_rows=ROWS,
                       block_v=STREAM_BLOCK_V, cap_factor=STREAM_CAP_FACTOR)
    plan_time = time.perf_counter() - t0
    stack_bytes = (len(sp_d.tasks) * 2 * sp_d.num_layers * (SUBGRID + 8)
                   * SUBGRID * 4)
    say(f"# stream plan: {len(sp_d.tasks)} tasks, {sp_d.num_layers} layers, "
        f"block_v {sp_d.block_v}, cap {sp_d.cap} slots ({sp_d.num_blocks} "
        f"blocks) for {num_vis_d} visibilities per chunk, task stack "
        f"{stack_bytes} bytes ({plan_time:.2f} s host)")
    uvw_dd = torch.as_tensor(uvw_d, device=dev)
    vis_dd = torch.as_tensor(vis_d, device=dev)
    stream_err, stream_ops, stream_valid = check_stream_kernels(
        torch, StreamingGridder, StreamingDegridder, sp_d, uvw_dd, vis_dd,
        model, "dense stream")
    # The non-packable branch's kernels (K6, K7, the fold; K5, K8 and K11
    # at its shapes): the small scenario on 64-slot blocks, then window
    # j's dense stream at oversampling 65536 (the operands of 4j).
    sp_s64 = plan_stream(plan_s, stream_tasks(plan_s, uvw_s),
                         chunk_rows=SMALL["rows"], block_v=64,
                         cap_slots=128 * n_small)
    check_np_kernels(torch, StreamingGridder, StreamingDegridder, sp_s64,
                     torch.as_tensor(uvw_s, device=dev),
                     torch.as_tensor(vis_s, device=dev), model_s,
                     "small, block_v 64")
    t0 = time.perf_counter()
    plan_j = plan_wstack(uvw_d, C_0, C_0 / (100 * STREAM_CHANS), STREAM_CHANS,
                         IMAGE, SUBGRID, THETA, W_STEP, support=8,
                         oversampling=NP_OVERSAMPLING, w_support=4,
                         w_oversampling=NP_W_OVERSAMPLING,
                         w_tower_height=HEIGHT)
    sp_j = plan_stream(plan_j, stream_tasks(plan_j, uvw_d), chunk_rows=ROWS,
                       block_v=STREAM_BLOCK_V, cap_factor=STREAM_CAP_FACTOR)
    plan_time = time.perf_counter() - t0
    say(f"# non-packable stream plan (oversampling {NP_OVERSAMPLING}, w "
        f"oversampling {NP_W_OVERSAMPLING}): {len(sp_j.tasks)} tasks, "
        f"{sp_j.num_layers} layers, block_v {sp_j.block_v}, cap {sp_j.cap} "
        f"slots ({sp_j.num_blocks} blocks), {sp_j.num_buckets} buckets "
        f"({plan_time:.2f} s host)")
    np_err, np_ops, np_valid = check_np_kernels(
        torch, StreamingGridder, StreamingDegridder, sp_j, uvw_dd, vis_dd,
        model, "dense stream, non-packable")
    # K6/K7's unrolled instance (the paths' fits) and generic instance.
    check_prep_instances(torch, np_ops, "dense stream, non-packable")
    # Their bf16 modes (K6, K7 bit for bit): the small case, then window
    # k's operands.
    check_np_kernels(torch, StreamingGridder, StreamingDegridder, sp_s64,
                     torch.as_tensor(uvw_s, device=dev),
                     torch.as_tensor(vis_s, device=dev), model_s,
                     "small, block_v 64, bf16", fast=True)
    bf_err, bf_ops, _ = check_np_kernels(
        torch, StreamingGridder, StreamingDegridder, sp_j, uvw_dd, vis_dd,
        model, "dense stream, non-packable, bf16", fast=True)

    # 4a. packed main path ---------------------------------------------
    g = packed_gridder(pplan, device=dev)
    tower_names = [n for n, _ in TOWER_KERNELS + TASK_KERNELS]
    stream_names = [n for n, _, _, _ in STREAM_KERNELS]
    with launch_window(torch, tkern, "packed path",
                       ("grid_packed_stack", "degrid_stack"),
                       tower_names + stream_names) as launches:
        vre, vim = g.sort(vis)
        img = g.grid_sorted(vre, vim)
        pred = g.degrid_sorted(model)
        res = major_cycle_imager(plan, vis, uvw, n_major=2, bucketed=True,
                                 device=dev)
    finite(torch, (("dirty image", img), ("degrid", pred),
                   ("model", res.model), ("restored", res.restored)))
    if tuple(img.shape) != (IMAGE, IMAGE) or pred.shape[0] != pplan.total:
        raise SystemExit("packed-path outputs have the wrong shape")
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
    e_pred = rel_err(pred, tk.degrid_stack_reference(
        g._model_stack(model), g.t_idx, g.k_idx, g.g_idx, g.ubase,
        g.vband_t, g.wk_t, 4, block_v=pplan.block_v))
    say(f"# packed dirty image, kernel vs plain path: taper-weighted rel "
        f"err {e_img:.3e}, degrid rel err {e_pred:.3e} (tolerance "
        f"{TOL:g}); degrid |vis| max {float(pred.abs().max()):.4g}; "
        f"major-cycle peaks {res.peak_history}")
    if not (e_img <= TOL and e_pred <= TOL):
        raise SystemExit("kernel-path image or degrid disagrees with the "
                         "plain path")
    # The packed path's fast mode (bf16 K1/K2), once, in a window of its
    # own: against its plain path on the card, and (reported) against the
    # "high" image.
    with launch_window(torch, tkern, "packed path, fast (bf16)",
                       ("grid_packed_stack", "degrid_stack"),
                       tower_names + stream_names) as fast_launches:
        gf = packed_gridder(pplan, fast=True, device=dev)
        img_f = gf.grid_sorted(vre, vim)
        pred_f = gf.degrid_sorted(model)
    finite(torch, (("bf16 dirty image", img_f), ("bf16 degrid", pred_f)))
    img_fp = gf._image_from_stack(tk.grid_packed_stack_reference(
        gf.t_idx, gf.k_idx, gf.g_idx, gf.ubase, gf.vband,
        (gf.wk_t, vre, vim), len(pplan.tasks), pplan.num_layers, SUBGRID, 4,
        block_v=pplan.block_v))
    pred_fp = tk.degrid_stack_reference(
        gf._model_stack(model), gf.t_idx, gf.k_idx, gf.g_idx, gf.ubase,
        gf.vband_t, gf.wk_t, 4, block_v=pplan.block_v)
    e_fimg = rel_err(img_f * taper, img_fp * taper)
    e_fpred = rel_err(pred_f, pred_fp)
    say(f"# packed path, fast (bf16), kernel vs plain path: taper-weighted "
        f"image rel err {e_fimg:.3e}, degrid rel err {e_fpred:.3e} "
        f"(tolerance {TOL:g}); against 'high': image "
        f"{rel_err(img_f * taper, img * taper):.3e}, degrid "
        f"{rel_err(pred_f, pred):.3e}")
    if not (e_fimg <= TOL and e_fpred <= TOL):
        raise SystemExit("the bf16 packed path disagrees with its plain path")
    del gf, img_fp, pred_fp
    # A point source through the whole solver: card vs CPU port.
    img_pt = np.zeros((SMALL["image"], SMALL["image"]), np.float32)
    src = (SMALL["image"] // 2 + 12, SMALL["image"] // 2 - 9)
    img_pt[src] = 1.0
    vis_pt = packed_gridder(plan_packed(plan_s, uvw_s),
                            device="cpu").degrid(img_pt)
    r_gpu = major_cycle_imager(plan_s, vis_pt, uvw_s, bucketed=True,
                               device=dev)
    r_cpu = major_cycle_imager(plan_s, vis_pt, uvw_s, bucketed=True,
                               device="cpu")
    e_mc = rel_err(r_gpu.model.cpu(), r_cpu.model)
    flux = float(r_gpu.model[src])
    say(f"# small point-source solve (packed), card vs CPU: model rel err "
        f"{e_mc:.3e} (tolerance 1e-4), recovered flux {flux:.4f}")
    if not (e_mc <= 1e-4 and abs(flux - 1.0) < 0.05):
        raise SystemExit("the point-source solve disagrees")

    # 4b. w-towers path, bucketed fallback, full width -----------------
    # Each grid_all_bucketed call must launch K16 once and each
    # degrid_all_bucketed call K17 once (the counters read around every
    # call, the solver's included).
    fb_calls = {"grid_all_layers_tasks": [], "degrid_all_layers_tasks": []}

    def one_launch(fn, name):
        def call(*args, **kw):
            before = tt.launch_counts()[name]
            out = fn(*args, **kw)
            fb_calls[name].append(tt.launch_counts()[name] - before)
            return out
        return call

    fb_grid = one_launch(grid_all_bucketed, "grid_all_layers_tasks")
    fb_degrid = one_launch(degrid_all_bucketed, "degrid_all_layers_tasks")
    saved_mc = (mc.grid_all_bucketed, mc.degrid_all_bucketed)
    mc.grid_all_bucketed, mc.degrid_all_bucketed = fb_grid, fb_degrid
    try:
        with launch_window(torch, tkern, "bucketed fallback", task_names,
                           ("grid_plane", "degrid_plane", "grid_all_layers",
                            "degrid_all_layers", *stream_names)
                           ) as fb_launches:
            t_img = fb_grid(bplan, vis_dev, uvw_dev, sort_index, valid)
            t_pred = fb_degrid(bplan, model, uvw_dev, sort_index, valid, inv)
            # The solve images the unit point's visibilities: on the noise
            # of the bench data CLEAN's argmax meets near-ties, and a
            # 1e-7 difference between two sum orders then picks another
            # component.
            t_res = major_cycle_imager(tplan, t_pred, uvw, n_major=2,
                                       bucketed=True, device=dev)
    finally:
        mc.grid_all_bucketed, mc.degrid_all_bucketed = saved_mc
    say(f"# fallback K16/K17 launches per call: grid_all_bucketed "
        f"{fb_calls['grid_all_layers_tasks']}, degrid_all_bucketed "
        f"{fb_calls['degrid_all_layers_tasks']}")
    if any(n != 1 for c in fb_calls.values() for n in c) or \
            len(fb_calls["degrid_all_layers_tasks"]) < 2 or \
            len(fb_calls["grid_all_layers_tasks"]) < 3:
        raise SystemExit("a fallback call did not launch its all-layer "
                         "kernel exactly once")
    finite(torch, (("tower dirty image", t_img), ("tower degrid", t_pred),
                   ("tower model", t_res.model),
                   ("tower restored", t_res.restored)))
    if tuple(t_img.shape) != (IMAGE, IMAGE) or \
            tuple(t_pred.shape) != (ROWS, CHANS):
        raise SystemExit("w-towers outputs have the wrong shape")
    with plain_tower_kernels(bk, tt):
        t_img_plain = grid_all_bucketed(bplan, vis_dev, uvw_dev, sort_index,
                                        valid)
        t_pred_plain = degrid_all_bucketed(bplan, model, uvw_dev,
                                           sort_index, valid, inv)
        t_res_plain = major_cycle_imager(tplan, t_pred, uvw, n_major=2,
                                         bucketed=True, device=dev)
    e_timg = rel_err(t_img * taper, t_img_plain * taper)
    e_tpred = rel_err(t_pred, t_pred_plain)
    e_tres = solve_err(t_res, t_res_plain, taper)
    flux = float(t_res.model[300, 200])
    say(f"# fallback, kernel vs plain path: dirty image taper-weighted rel "
        f"err {e_timg:.3e}, degrid rel err {e_tpred:.3e}, two major cycles "
        f"of the unit point (model, taper-weighted residual) rel err "
        f"{e_tres:.3e} (tolerance {TOL:g}); recovered flux {flux:.4f}, "
        f"peaks {t_res.peak_history}")
    if not (e_timg <= TOL and e_tpred <= TOL and e_tres <= TOL
            and abs(flux - 1.0) < 0.05):
        raise SystemExit("the bucketed fallback disagrees with the plain "
                         "path")

    # 4c. w-towers path, task drivers (bucketed=False), full width -------
    st = torch.zeros((ROWS,), dtype=torch.int32, device=dev)
    en = torch.full((ROWS,), CHANS, dtype=torch.int32, device=dev)

    solve_plan = plan_wstack(uvw[:SOLVE_ROWS], C_0, C_0 / (100 * CHANS),
                             CHANS, IMAGE, TOWER_SUBGRID, THETA, W_STEP,
                             support=8, w_support=4, w_tower_height=HEIGHT)

    def task_drivers():
        d_img, s_grid = timed(torch, lambda: grid_all_tasks(
            tplan, tplan.kernel(), vis_dev, uvw_dev, st, en).real)
        d_pred, s_degrid = timed(torch, lambda: degrid_all_tasks(
            tplan, tplan.kernel(), model, uvw_dev, st, en, torch.complex64))
        d_res, s_solve = timed(torch, lambda: major_cycle_imager(
            solve_plan, t_pred[:SOLVE_ROWS], uvw[:SOLVE_ROWS], n_major=1,
            device=dev))
        return d_img, d_pred, d_res, (s_grid, s_degrid, s_solve)

    with launch_window(torch, tkern, "task drivers",
                       ("grid_plane", "degrid_plane"),
                       ("grid_all_layers", "degrid_all_layers",
                        *task_names, *stream_names)) as td_launches:
        d_img, d_pred, d_res, td_s = task_drivers()
    finite(torch, (("task-driver image", d_img),
                   ("task-driver degrid", d_pred),
                   ("task-driver model", d_res.model)))
    with plain_tower_kernels(bk, tt):
        d_img_p, d_pred_p, d_res_p, td_plain_s = task_drivers()
    e_dimg = rel_err(d_img * taper, d_img_p * taper)
    e_dpred = rel_err(d_pred, d_pred_p)
    e_dres = solve_err(d_res, d_res_p, taper)
    flux = float(d_res.model[300, 200])
    # The two formulations of one operator: O(tasks x V) and bucketed.
    e_dfb = max(rel_err(d_img * taper, t_img * taper),
                rel_err(d_pred, t_pred))
    say(f"# task drivers ({len(tplan.tasks)} tasks, "
        f"{sum(t.num_planes for t in tplan.tasks)} planes), kernel vs plain "
        f"path: dirty image taper-weighted rel err {e_dimg:.3e}, degrid rel "
        f"err {e_dpred:.3e}, one major cycle of the unit point on the "
        f"first {SOLVE_ROWS} rows (model, "
        f"taper-weighted residual) rel err {e_dres:.3e} (tolerance "
        f"{TOL:g}), component flux {flux:.4f}; vs the bucketed fallback "
        f"{e_dfb:.3e} (tolerance 1e-4)")
    if not (e_dimg <= TOL and e_dpred <= TOL and e_dres <= TOL
            and e_dfb <= 1e-4 and flux > 0.5):
        raise SystemExit("the task drivers disagree")
    census = plane_census(torch, tplan, uvw_dev, st, en)
    say(f"# task-driver planes: {census.size} in the grid call, active "
        f"entries of {num_vis} each: median {float(np.median(census)):g}, "
        f"max {int(census.max())}, sum {int(census.sum())}; the timed plane "
        f"(K14/K15's operands) {tower_valid['grid_plane']}")
    if census.size != sum(t.num_planes for t in tplan.tasks):
        raise SystemExit("the plane census missed planes")

    # 4d. the sub-grid gridder (reference API), complex64 ----------------
    uvw_g, ch_g, img_g = subgrid_inputs()
    rows_g = uvw_g.shape[0]
    kern_g = GridderWtowerUVW(IMAGE, TOWER_SUBGRID, THETA, W_STEP, 0.0, 0.0,
                              8, 16384, 4, 16384)
    st_g = np.zeros(rows_g, np.int32)
    en_g = np.full(rows_g, ch_g, np.int32)

    def subgrid_pair(d):
        args = [torch.as_tensor(a, device=d) for a in (uvw_g, st_g, en_g)]
        x = torch.as_tensor(img_g, device=d)
        # The vis template sets the precision (without one it follows
        # uvw's f64, the complex128 path).
        ax = kern_g.degrid_subgrid(
            x, (10, -6, 1), ch_g, C_0, C_0 / 100, *args,
            vis=torch.zeros((rows_g, ch_g), dtype=torch.complex64, device=d),
            device=d)
        rng = np.random.default_rng(3)
        v = torch.as_tensor((rng.standard_normal((rows_g, ch_g))
                             + 1j * rng.standard_normal((rows_g, ch_g))
                             ).astype(np.complex64), device=d)
        atv = kern_g.grid_subgrid(v, *args, ch_g, C_0, C_0 / 100,
                                  torch.zeros_like(x), (10, -6, 1), device=d)
        return ax.cpu(), atv.cpu(), v.cpu(), x.cpu()

    with launch_window(torch, tkern, "sub-grid gridder",
                       ("grid_all_layers", "degrid_all_layers"),
                       ("grid_plane", "degrid_plane", *task_names,
                        *stream_names)):
        ax, atv, v, x = subgrid_pair(dev)
    ax_cpu, atv_cpu, _, _ = subgrid_pair(torch.device("cpu"))
    lhs, rhs = complex(np.vdot(v.numpy(), ax.numpy())), \
        complex(np.vdot(atv.numpy(), x.numpy()))
    e_adj = abs(lhs - rhs) / abs(lhs)
    e_sub = max(rel_err(ax, ax_cpu), rel_err(atv, atv_cpu))
    say(f"# sub-grid gridder ({rows_g} rows x {ch_g} channels, complex64): "
        f"adjointness rel err {e_adj:.3e} (tolerance 1e-4), card vs CPU "
        f"rel err {e_sub:.3e} (tolerance 1e-4)")
    if not (e_adj <= 1e-4 and e_sub <= 1e-4):
        raise SystemExit("the sub-grid gridder disagrees")

    # 4e. the reference-API whole-image drivers, reduced rows ------------
    uvw_r = uvw[:REF_ROWS]
    uvw_rd = torch.as_tensor(uvw_r, device=dev)
    geom = dict(subgrid_size=TOWER_SUBGRID, theta=THETA, w_step=W_STEP,
                shear_u=0.0, shear_v=0.0, support=8, oversampling=16384,
                w_support=4, w_oversampling=16384, subgrid_frac=2.0 / 3.0,
                w_tower_height=HEIGHT)
    with launch_window(torch, tkern, "reference engine",
                       ("grid_all_layers", "degrid_all_layers"),
                       ("grid_plane", "degrid_plane", *task_names,
                        *stream_names)):
        ref_vis = wstack_wtower_degrid_all(
            model, C_0, C_0 / (100 * CHANS), uvw_rd,
            vis=torch.zeros((REF_ROWS, CHANS), dtype=torch.complex64,
                            device=dev), **geom)
        ref_img = wstack_wtower_grid_all(
            vis_dev[:REF_ROWS], C_0, C_0 / (100 * CHANS), uvw_rd,
            image=torch.zeros((IMAGE, IMAGE), device=dev), **geom)
    finite(torch, (("reference-engine vis", ref_vis),
                   ("reference-engine image", ref_img)))
    ref_plan = plan_wstack(uvw_r, C_0, C_0 / (100 * CHANS), CHANS, IMAGE,
                           TOWER_SUBGRID, THETA, W_STEP, support=8,
                           w_support=4, w_tower_height=HEIGHT)
    b_r, s_r, v_r = plan_bucketed(ref_plan, uvw_r)
    b_vis = degrid_all_bucketed(b_r, model, uvw_rd, s_r, v_r,
                                inverse_index_of(s_r, v_r, REF_ROWS * CHANS))
    b_img = grid_all_bucketed(b_r, vis_dev[:REF_ROWS], uvw_rd, s_r, v_r)
    e_rvis = rel_err(ref_vis, b_vis)
    e_rimg = rel_err(ref_img * taper, b_img * taper)
    say(f"# reference engine ({REF_ROWS} rows x {CHANS} channels) vs the "
        f"bucketed drivers: degrid rel err {e_rvis:.3e}, grid taper-weighted "
        f"rel err {e_rimg:.3e} (tolerance 1e-4: two f32 formulations)")
    if not (e_rvis <= 1e-4 and e_rimg <= 1e-4):
        raise SystemExit("the reference engine disagrees")

    # A point source through the task-driver solve: card vs CPU port.
    plan_ts = plan_wstack(uvw_s, C_0, C_0 / 100, SMALL["chans"],
                          SMALL["image"], TOWER_SUBGRID, THETA,
                          SMALL["w_step"], support=8, w_support=4,
                          w_tower_height=HEIGHT)
    r_tgpu = major_cycle_imager(plan_ts, vis_pt, uvw_s, n_major=1,
                                device=dev)
    r_tcpu = major_cycle_imager(plan_ts, vis_pt, uvw_s, n_major=1,
                                device="cpu")
    e_tmc = rel_err(r_tgpu.model.cpu(), r_tcpu.model)
    flux = float(r_tgpu.model[src])
    say(f"# small point-source solve (task drivers, bucketed=False), card "
        f"vs CPU: model rel err {e_tmc:.3e} (tolerance 1e-4), component "
        f"flux {flux:.4f}")
    if not (e_tmc <= 1e-4 and flux > 0.5):
        raise SystemExit("the task-driver solve disagrees")

    # 4f. the device-planned streaming path (K3, K4, K5), dense stream --
    packed_names = ["grid_packed_stack", "degrid_stack"]
    expected = (ROWS + SHORT_ROWS) * STREAM_CHANS

    def stream_pass(sp, fast=False):
        sg = StreamingGridder(sp, fast=fast, device=dev)
        sg.accumulate(uvw_dd, vis_dd)
        sg.accumulate(uvw_dd[:SHORT_ROWS], vis_dd[:SHORT_ROWS])
        s_img = sg.finalize()
        sd = StreamingDegridder(sp, fast=fast, device=dev).set_model(model)
        s_pred = sd.predict(uvw_dd)
        sd.check()
        return (s_img, s_pred, [int(x) for x in sg.counters()],
                [int(x) for x in sd.counters()])

    def check_stream_outputs(label, s_img, s_pred, s_cnt, d_cnt):
        finite(torch, ((f"{label} image", s_img),
                       (f"{label} predict", s_pred)))
        if tuple(s_img.shape) != (IMAGE, IMAGE) or \
                tuple(s_pred.shape) != (ROWS, STREAM_CHANS):
            raise SystemExit(f"{label} outputs have the wrong shape")
        if s_cnt != [expected, 0, 0] or d_cnt != [num_vis_d, 0, 0]:
            raise SystemExit(f"{label} counters (processed, dropped, "
                             f"voided) {s_cnt} / {d_cnt}, expected "
                             f"{expected} / {num_vis_d} with none dropped "
                             f"or voided")

    def against_packed(wplan, s_img, s_pred):
        """The streaming image and predictions against the host-planned
        packed path at "highest" on the same plan (band engine, K1/K2,
        run outside the launch windows): the full chunk plus the short
        one. The JAX suite's interior is a margin of 1/8 of the side (32
        px at 256^2, test_streaming.py:93-96): 64 px here. The two plans
        tile the towers to different depths, and next to the 1/PSWF
        border that reads as ~4e-3 of the interior peak at 32 px."""
        pp = plan_packed(wplan, uvw_d)
        g_p = PackedGridder(pp, precision="highest", device=dev)
        vis_short = vis_dd.clone()
        vis_short[SHORT_ROWS:] = 0
        r_img = g_p.grid(vis_dd) + g_p.grid(vis_short)
        r_pred = g_p.degrid(model)
        m = IMAGE // 8
        errs = dict(interior=rel_err(s_img[m:-m, m:-m], r_img[m:-m, m:-m]),
                    margin32=rel_err(s_img[32:-32, 32:-32],
                                     r_img[32:-32, 32:-32]),
                    taper=rel_err(s_img * taper, r_img * taper),
                    predict=rel_err(s_pred, r_pred))
        text = (f"vs the packed path at 'highest' ({len(pp.tasks)} tasks, "
                f"{pp.num_layers} layers): interior (margin {m}) rel err "
                f"{errs['interior']:.3e}, predict rel err "
                f"{errs['predict']:.3e} (tolerance 2e-4); margin 32 "
                f"{errs['margin32']:.3e}, whole image taper-weighted "
                f"{errs['taper']:.3e}")
        return errs["interior"] <= 2e-4 and errs["predict"] <= 2e-4, text

    torch.cuda.reset_peak_memory_stats(dev)
    np_names = list(np_modules())
    np_only = [n for n in np_names if n != "place_stream"]
    with launch_window(torch, tkern, "streaming path", stream_names,
                       packed_names + tower_names + np_only) as st_launches:
        s_img, s_pred, s_cnt, d_cnt = stream_pass(sp_d)
    peak_bytes = torch.cuda.max_memory_allocated(dev)
    check_stream_outputs("streaming", s_img, s_pred, s_cnt, d_cnt)
    with plain_stream_kernels():
        p_img, p_pred, _, _ = stream_pass(sp_d)
    e_simg = rel_err(s_img * taper, p_img * taper)
    e_spred = rel_err(s_pred, p_pred)
    del p_img, p_pred
    ok_packed, packed_text = against_packed(plan_d, s_img, s_pred)
    say(f"# streaming ({len(sp_d.tasks)} tasks, cap {sp_d.cap}, task stack "
        f"{stack_bytes} bytes, peak device memory {peak_bytes} bytes): "
        f"processed {s_cnt[0]} of {expected} (dropped {s_cnt[1]}, voided "
        f"{s_cnt[2]}), predicted {d_cnt[0]}; kernel vs plain path: image "
        f"taper-weighted rel err {e_simg:.3e}, predict rel err "
        f"{e_spred:.3e} (tolerance {TOL:g}); " + packed_text)
    if not (e_simg <= TOL and e_spred <= TOL and ok_packed):
        raise SystemExit("the streaming path disagrees")

    # 4g. the packed gridder's engine="fused" (K3, K4), bench scenario --
    fused_out = {}
    for prec in ("highest", "high"):
        band = PackedGridder(pplan, precision=prec, device=dev)
        fused_out[prec] = [band.grid_sorted(vre, vim),
                           band.degrid_sorted(model)]
        del band
    fused_g = {prec: PackedGridder(pplan, precision=prec, engine="fused",
                                   device=dev) for prec in fused_out}
    if any(fg.engine != "fused" for fg in fused_g.values()):
        raise SystemExit("the bench plan did not take the fused engine")
    with launch_window(torch, tkern, "fused engine", stream_names[:2],
                       packed_names + ["place_stream"] + tower_names):
        for prec, fg in fused_g.items():
            fused_out[prec] += [fg.grid_sorted(vre, vim),
                                fg.degrid_sorted(model)]
    lines, ok = [], True
    for prec, (b_img, b_pred, f_img, f_pred) in fused_out.items():
        finite(torch, ((f"fused image [{prec}]", f_img),
                       (f"fused degrid [{prec}]", f_pred)))
        e_fi = rel_err(f_img * taper, b_img * taper)
        e_fp = rel_err(f_pred, b_pred)
        lines.append(f"'{prec}' image taper-weighted rel err {e_fi:.3e}, "
                     f"degrid rel err {e_fp:.3e}")
        ok = ok and e_fi <= TOL and e_fp <= TOL
    say("# fused engine vs band engine (bench scenario): "
        + "; ".join(lines) + f" (tolerance {TOL:g})")
    if not ok:
        raise SystemExit("the fused engine disagrees with the band engine")
    del fused_out

    # 4h. the ES-FFT gridder (K8, K11), bench data -----------------------
    es = es_phase(torch, tkern, dev, uvw, vis, model)

    # 4i. the packed gridder's engine="compact" (K12, K13), bench scenario
    cp = compact_phase(torch, tkern, PackedGridder, pplan, dev, vre, vim,
                       model, taper)

    # 4j. the streaming path's non-packable branch (K5-K11), dense stream
    others = [n for n in tkern.launch_counts() if n not in np_names]
    with launch_window(torch, tkern, "non-packable streaming", np_names,
                       others) as np_launches:
        j_img, j_pred, j_cnt, jd_cnt = stream_pass(sp_j)
    check_stream_outputs("non-packable streaming", j_img, j_pred, j_cnt,
                         jd_cnt)
    with plain_np_kernels():
        p_img, p_pred, _, _ = stream_pass(sp_j)
    e_jimg = rel_err(j_img * taper, p_img * taper)
    e_jpred = rel_err(j_pred, p_pred)
    del p_img, p_pred
    ok_packed, packed_text = against_packed(plan_j, j_img, j_pred)
    say(f"# non-packable streaming ({len(sp_j.tasks)} tasks, cap "
        f"{sp_j.cap}, oversampling {NP_OVERSAMPLING}): processed "
        f"{j_cnt[0]} of {expected}, predicted {jd_cnt[0]}; kernel vs plain "
        f"path: image taper-weighted rel err {e_jimg:.3e}, predict rel err "
        f"{e_jpred:.3e} (tolerance {TOL:g}); " + packed_text)
    if not (e_jimg <= TOL and e_jpred <= TOL and ok_packed):
        raise SystemExit("the non-packable streaming path disagrees")

    # 4k. the non-packable branch with fast=True (bf16 K6, K7, K8, K11) --
    with launch_window(torch, tkern, "non-packable streaming, fast",
                       np_names, others) as k_launches:
        k_img, k_pred, k_cnt, kd_cnt = stream_pass(sp_j, fast=True)
    check_stream_outputs("non-packable streaming, fast", k_img, k_pred,
                         k_cnt, kd_cnt)
    with plain_np_kernels():
        p_img, p_pred, _, _ = stream_pass(sp_j, fast=True)
    e_kimg = rel_err(k_img * taper, p_img * taper)
    e_kpred = rel_err(k_pred, p_pred)
    del p_img, p_pred
    # bf16 against f32 (window j), the unit point's prediction bounded.
    e_fimg = rel_err(k_img * taper, j_img * taper)
    e_fpred = rel_err(k_pred, j_pred)
    say(f"# non-packable streaming, fast (bf16): processed {k_cnt[0]} of "
        f"{expected}, predicted {kd_cnt[0]}; kernel vs plain path: image "
        f"taper-weighted rel err {e_kimg:.3e}, predict rel err {e_kpred:.3e} "
        f"(tolerance {TOL:g}); vs window j's f32 result: image "
        f"taper-weighted {e_fimg:.3e}, predict {e_fpred:.3e} (tolerance "
        f"{FAST_TOL:g})")
    if not (e_kimg <= TOL and e_kpred <= TOL and e_fimg <= FAST_TOL
            and e_fpred <= FAST_TOL and e_fimg > 0):
        raise SystemExit("the fast non-packable streaming path disagrees")
    del j_img, j_pred, k_img, k_pred

    # 4l. K18 and K19, driven once on window f's operands ----------------
    word_grid, word_degrid, word_kw, word_valid, word_dkw = word_operands(
        torch, sp_d, uvw_dd, vis_dd, model)
    # K18's run table, built once as a plan's would be (K19's is in
    # word_dkw).
    word_gkw = dict(runs=tk.degrid_runs((word_grid[0],)))
    word_names = [n for n, _ in WORD_KERNELS]
    with launch_window(torch, tkern, "word-fed bucket-window kernels",
                       word_names, [n for n in tkern.launch_counts()
                                    if n not in word_names]) as w_launches:
        tkern.band_tap.grid_fused(*word_grid, **word_kw, **word_gkw)
        tkern.band_tap.degrid_fused2(*word_degrid, **word_kw, **word_dkw)
    word_err = check_word_kernels(torch, word_grid, word_degrid, word_kw,
                                  word_dkw, word_gkw)

    # 4m. K20, the sparse all-layer grid, on the fallback's largest task,
    # once in each mode ------------------------------------------------
    sp_args, sp_weights, sparse_valid = sparse_operands(
        torch, dev, tplan, uvw_dev, bplan, sort_index, valid,
        ops["grid_all_layers"])
    not_sparse = [n for n in tkern.launch_counts()
                  if n != "grid_all_layers_sparse"]
    m_launches = {}
    for tag, fast in (("", False), ("[bf16]", True)):
        with launch_window(torch, tkern, f"sparse all-layer grid{tag}",
                           ["grid_all_layers_sparse"], not_sparse) as cnt:
            ts.grid_all_layers_sparse(*sp_args, fast=fast)
        m_launches[tag] = cnt["grid_all_layers_sparse"]
    sparse_err = check_sparse_kernel(torch, ts, tt, sp_args, sp_weights)
    sparse_dev = sparse_calls(torch, ts, sp_args)

    # 4n. the bf16 mode of K14-K17: once each on the main paths' operands
    # (window c's plane, the fallback's largest task), then the sub-grid
    # gridder with the JAX package's switch set -------------------------
    fast_names = [n for n, _ in TOWER_KERNELS]
    with launch_window(torch, tkern, "w-towers kernels, bf16 mode",
                       fast_names, [n for n in tkern.launch_counts()
                                    if n not in fast_names]) as n_launches:
        for name in fast_names:
            args, kw = ops[name]
            getattr(tt, name)(*args, **kw, fast=True)
    fast_err = check_tower_fast(torch, tt, ops)
    nd_launches = fast_subgrid_phase(
        torch, tkern, tt, bk, wtower, subgrid_pair, dev, ax, atv,
        ("grid_plane", "degrid_plane", *task_names, *stream_names))

    # 4o. the solvers at the bench scenario (K1, K2): the multi-scale
    # major cycle and FISTA on the bench uvw, visibilities predicted from
    # a sky of points and an extended source --------------------------
    solver_phase(torch, tkern, tk, dev, plan, uvw, g,
                 (plan_s, vis_pt, uvw_s, src))

    # 4p. the experiments' A/B kernels through their drivers -------------
    say(f"# before window p: {torch.cuda.memory_allocated() / 1e9:.1f} GB "
        f"allocated")
    t0 = time.perf_counter()
    exp_sites = experiments_phase(torch, tkern, gpu)
    read_rate = exp_sites["read_streams[P1]"][1][0]["read_gb_s"] * 1e9
    say(f"# window p: {time.perf_counter() - t0:.1f} s; measured read rate "
        f"{read_rate / 1e9:.1f} GB/s ({read_rate / HBM_BYTES_S:.3f} of the "
        f"published 3.35 TB/s)")

    # 5. times -----------------------------------------------------------
    # The packed path's calls and K1/K2 (packed_times, as --packed-times
    # runs it on any checkout).
    pt = packed_times(torch, dev)
    t_grid, t_degrid, t_mc = (pt["calls"][w]["ms"] for w in (
        "grid_sorted", "degrid_sorted", "major cycle"))
    say(f"# [{gpu}] packed: grid {num_vis / t_grid / 1e3:.2f} Mvis/s "
        f"({t_grid:.3f} ms), degrid {num_vis / t_degrid / 1e3:.2f} Mvis/s "
        f"({t_degrid:.3f} ms), major cycle {1e3 / t_mc:.3f} iters/s "
        f"({t_mc:.3f} ms; minor cycle 50 components); K1/K2 (ms): "
        + "; ".join(f"{k} {v[0]:.3f}/{v[1]:.3f}"
                    for k, v in pt["kernels"].items())
        + "; per call: " + "; ".join(
            f"{k} host enqueue {v['host_ms']:.3f} ms, device "
            + (f"{v['device_ms']:.3f} ms, busy {v['busy']:.1%}"
               if v["device_ms"] else "time not measured")
            + f", {v['device_ops']:.0f} device operations"
            for k, v in pt["calls"].items()))
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

    # One msclean and one FISTA iteration beside it; turns: Hogbom,
    # msclean, FISTA, FISTA, msclean, Hogbom.
    ms_minor = mc._make_msclean_minor(psf, MS_SCALES, 0.1, 50)

    def ms_step():
        p = g.degrid_sorted(state["model"])
        rre, rim = mc._packed_residual(vre, vim, p, None)
        dirty = mc._norm_mask(g.grid_sorted(rre, rim), peak, border)
        delta, _ = ms_minor(dirty, stop)
        state["model"] = state["model"] + delta

    fmask = mc._mask_border(torch.ones((IMAGE, IMAGE), device=dev),
                            IMAGE // 8)
    f32 = dict(dtype=torch.float32, device=dev)
    fstate = dict(x=torch.zeros((IMAGE, IMAGE), **f32),
                  y=torch.zeros((IMAGE, IMAGE), **f32),
                  t=torch.tensor(1.0, **f32))
    f_step, f_thresh = torch.tensor(1e-3, **f32), torch.tensor(1e-6, **f32)

    def fista_step():
        x, y, t, rre, rim = fi._fista_step(
            g, lambda re, im: fmask * g.grid_sorted(re, im), vre, vim, None,
            f_step, f_thresh, fstate["x"], fstate["y"], fstate["t"])
        fstate.update(x=x, y=y, t=t)
        float(fi._norm(rre, rim))

    iters = []
    for fn in (mc_step, ms_step, fista_step, fista_step, ms_step, mc_step):
        state["model"] = torch.zeros((IMAGE, IMAGE), device=dev)
        iters.append(cuda_ms(torch, fn, 5, warmup=1))
    say(f"# [{gpu}] one solver iteration, bench scenario (degrid, "
        f"residual, grid; CUDA events over 5): Hogbom (50 components) "
        f"{iters[0]:.3f}/{iters[5]:.3f} ms, msclean scales {MS_SCALES} (50 "
        f"components) {iters[1]:.3f}/{iters[4]:.3f} ms, FISTA "
        f"{iters[2]:.3f}/{iters[3]:.3f} ms")

    fb = fallback_times(torch, dev, tplan, bplan, sort_index, valid, inv,
                        uvw, uvw_dev, vis_dev, model)
    tt_grid, tt_degrid, tt_mc = (fb[w][0] for w in ("grid", "degrid",
                                                    "major cycle"))
    say(f"# [{gpu}] w-towers fallback ({len(bplan.tasks)} tasks): grid "
        f"{num_vis / tt_grid / 1e3:.2f} Mvis/s ({tt_grid:.3f} ms), degrid "
        f"{num_vis / tt_degrid / 1e3:.2f} Mvis/s ({tt_degrid:.3f} ms), "
        f"major cycle {1e3 / tt_mc:.3f} iters/s ({tt_mc:.3f} ms; minor "
        f"cycle 50 components)")
    say(f"# [{gpu}] w-towers fallback, per call (torch.profiler): "
        + "; ".join(
            f"{what} {d_ops:.0f} device operations a call, device "
            + (f"{d_us / 1e3:.3f} ms, busy {d_us / 1e3 / wall:.1%}" if d_us
               else "time not measured (no device time in the trace)")
            for what, (wall, d_us, d_ops) in fb.items())
        + f"; K16/K17 launches per grid / degrid call in window b: "
        f"{fb_calls['grid_all_layers_tasks']} / "
        f"{fb_calls['degrid_all_layers_tasks']}")
    say(f"# [{gpu}] task drivers ({len(tplan.tasks)} tasks, one call each "
        f"at full width): grid {td_s[0]:.3f} s, degrid {td_s[1]:.3f} s, "
        f"one-cycle solve on {SOLVE_ROWS} rows (PSF grid, degrid, grid) "
        f"{td_s[2]:.3f} s; plain "
        f"path {td_plain_s[0]:.3f} s, {td_plain_s[1]:.3f} s, "
        f"{td_plain_s[2]:.3f} s")
    num_p, split = plane_split(
        torch, tplan, uvw_dev, vis_dev, ops["degrid_plane"][0][0][0],
        plane_task)
    say(f"# [{gpu}] task drivers, per plane of the timed plane's task "
        f"({num_p} planes; ms, CUDA events, 5 calls each): " + "; ".join(
            f"{what} call {t['call']:.3f} = geometry {t['geometry']:.3f} + "
            f"{what}_plane wrapper {t['wrapper']:.3f} + rest {t['rest']:.3f}"
            for what, t in split.items()))

    # Streaming: bench's stream_ingest_mvis_s (visibilities / accumulate
    # step over chained steps) and the predict twin, then the plain path.
    sg_t = StreamingGridder(sp_d, device=dev)
    sd_t = StreamingDegridder(sp_d, device=dev).set_model(model)
    ingest, predict = (lambda: sg_t.accumulate(uvw_dd, vis_dd),
                       lambda: sd_t.predict(uvw_dd))
    t_ing = cuda_ms(torch, ingest, 10, warmup=1)
    t_pre = cuda_ms(torch, predict, 10, warmup=1)
    with plain_stream_kernels():
        tp_ing = cuda_ms(torch, ingest, 3, warmup=1)
        tp_pre = cuda_ms(torch, predict, 3, warmup=1)
    say(f"# [{gpu}] streaming (dense stream, {num_vis_d} visibilities per "
        f"chunk): ingest {num_vis_d / t_ing / 1e3:.2f} Mvis/s "
        f"({t_ing:.3f} ms per accumulate, 10 steps), predict "
        f"{num_vis_d / t_pre / 1e3:.2f} Mvis/s ({t_pre:.3f} ms); plain path "
        f"ingest {num_vis_d / tp_ing / 1e3:.2f} Mvis/s ({tp_ing:.3f} ms, 3 "
        f"steps), predict {num_vis_d / tp_pre / 1e3:.2f} Mvis/s "
        f"({tp_pre:.3f} ms)")
    # The non-packable branch (window j) beside the packable one (window
    # f) on the same chunk; turns: f, j, j, f. Then window j's stages and
    # its plain path.
    sg_j = StreamingGridder(sp_j, device=dev)
    sd_j = StreamingDegridder(sp_j, device=dev).set_model(model)
    ingest_j, predict_j = (lambda: sg_j.accumulate(uvw_dd, vis_dd),
                           lambda: sd_j.predict(uvw_dd))
    lines = []
    for what, f_fn, j_fn in (("ingest", ingest, ingest_j),
                             ("predict", predict, predict_j)):
        t = [cuda_ms(torch, fn, 10, warmup=1)
             for fn in (f_fn, j_fn, j_fn, f_fn)]
        lines.append(f"{what} non-packable {num_vis_d / t[2] / 1e3:.2f} "
                     f"Mvis/s ({t[1]:.3f}/{t[2]:.3f} ms), packable "
                     f"{num_vis_d / t[3] / 1e3:.2f} Mvis/s ({t[0]:.3f}/"
                     f"{t[3]:.3f} ms)")
    with plain_np_kernels():
        jp_ing = cuda_ms(torch, ingest_j, 3, warmup=1)
        jp_pre = cuda_ms(torch, predict_j, 3, warmup=1)
    # Window k (fast) beside window j; turns: j, k, k, j.
    sg_k = StreamingGridder(sp_j, fast=True, device=dev)
    sd_k = StreamingDegridder(sp_j, fast=True, device=dev).set_model(model)
    fast_lines = []
    for what, j_fn, k_fn in (
            ("ingest", ingest_j, lambda: sg_k.accumulate(uvw_dd, vis_dd)),
            ("predict", predict_j, lambda: sd_k.predict(uvw_dd))):
        t = [cuda_ms(torch, fn, 10, warmup=1)
             for fn in (j_fn, k_fn, k_fn, j_fn)]
        fast_lines.append(
            f"{what} fast {num_vis_d / t[2] / 1e3:.2f} Mvis/s ({t[1]:.3f}/"
            f"{t[2]:.3f} ms), f32 {num_vis_d / t[3] / 1e3:.2f} Mvis/s "
            f"({t[0]:.3f}/{t[3]:.3f} ms)")
    sg_t.finalize()
    sd_t.check()
    sg_j.finalize()
    sd_j.check()
    sg_k.finalize()
    sd_k.check()
    fast_stages = np_stage_times(torch, sd_k, uvw_dd, vis_dd)
    stages = np_stage_times(torch, sd_j, uvw_dd, vis_dd)
    say(f"# [{gpu}] streaming, non-packable (oversampling "
        f"{NP_OVERSAMPLING}) vs packable, dense stream (10 steps each): "
        + "; ".join(lines) + f"; non-packable plain path ingest "
        f"{jp_ing:.3f} ms, predict {jp_pre:.3f} ms (3 steps); stages (ms, "
        f"CUDA events, 10 calls each): " + ", ".join(
            f"{k} {v:.3f}" for k, v in stages.items()))
    say(f"# [{gpu}] streaming, non-packable, fast (bf16) vs f32, dense stream "
        f"(10 steps each): " + "; ".join(fast_lines) + "; fast stages (ms, "
        f"CUDA events, 10 calls each): " + ", ".join(
            f"{k} {v:.3f}" for k, v in fast_stages.items()))
    # The three predicts by stage (K4, K11 and their run tables), the ES
    # degrid on window h's 3-D plan.
    p_stages, _ = predict_stages(
        torch, sd_t, sd_j, sd_k,
        lambda: es["degrid"](es["plans"]["3-D"], model), uvw_dd)
    say(f"# [{gpu}] predicts by stage (ms, CUDA events, 10 calls each; "
        f"rest = the call less its stages): " + stage_text(p_stages))
    del sg_t, sd_t, sg_j, sd_j, sg_k, sd_k
    # The fused engine beside the band engine, "high"; turns: band,
    # fused, fused, band.
    fg = fused_g["high"]
    for what, band_fn, fused_fn in (
            ("grid", lambda: g.grid_sorted(vre, vim),
             lambda: fg.grid_sorted(vre, vim)),
            ("degrid", lambda: g.degrid_sorted(model),
             lambda: fg.degrid_sorted(model))):
        b1 = cuda_ms(torch, band_fn, 10)
        f1 = cuda_ms(torch, fused_fn, 10)
        f2 = cuda_ms(torch, fused_fn, 10)
        b2 = cuda_ms(torch, band_fn, 10)
        say(f"# [{gpu}] packed {what}, 'high': fused engine "
            f"{num_vis / f2 / 1e3:.2f} Mvis/s ({f1:.3f}/{f2:.3f} ms), band "
            f"engine {num_vis / b2 / 1e3:.2f} Mvis/s ({b1:.3f}/{b2:.3f} ms)")
    del fused_g, fg

    # The ES-FFT gridder beside the packed path (band engine, "high", its
    # sort and unsort included) on the same data; turns: packed, ES, ES,
    # packed.
    lines = []
    for what, packed_fn, es_fn in (
            ("grid", lambda: g.grid(vis_dev),
             lambda p: es["grid"](p)),
            ("degrid", lambda: g.degrid(model),
             lambda p: es["degrid"](p, model))):
        b1 = cuda_ms(torch, packed_fn, 10)
        es_t = {k: [cuda_ms(torch, lambda: es_fn(p), 10) for _ in range(2)]
                for k, p in es["plans"].items()}
        b2 = cuda_ms(torch, packed_fn, 10)
        lines.append(f"{what}: " + ", ".join(
            f"ES-FFT {k} {num_vis / t[1] / 1e3:.2f} Mvis/s ({t[0]:.3f}/"
            f"{t[1]:.3f} ms)" for k, t in es_t.items())
            + f"; packed path {num_vis / b2 / 1e3:.2f} Mvis/s ({b1:.3f}/"
            f"{b2:.3f} ms)")
    say(f"# [{gpu}] ES-FFT gridder vs packed path (bench data, "
        f"{num_vis} visibilities): " + "; ".join(lines))
    # The compact engine beside the band and fused engines, "highest" (the
    # compact engine's precision); turns: band, fused, compact, compact,
    # fused, band.
    cg = cp["gridders"]["highest"]
    bg = PackedGridder(pplan, precision="highest", device=dev)
    fh = PackedGridder(pplan, precision="highest", engine="fused",
                       device=dev)
    for what, fn in (("grid", lambda x: x.grid_sorted(vre, vim)),
                     ("degrid", lambda x: x.degrid_sorted(model))):
        t = [cuda_ms(torch, lambda: fn(x), 10)
             for x in (bg, fh, cg, cg, fh, bg)]
        say(f"# [{gpu}] packed {what}, 'highest': compact engine "
            f"{num_vis / t[3] / 1e3:.2f} Mvis/s ({t[2]:.3f}/{t[3]:.3f} ms), "
            f"fused engine {num_vis / t[4] / 1e3:.2f} Mvis/s ({t[1]:.3f}/"
            f"{t[4]:.3f} ms), band engine {num_vis / t[5] / 1e3:.2f} Mvis/s "
            f"({t[0]:.3f}/{t[5]:.3f} ms)")
    # K3/K4's operands on the same plan, for K12/K13 beside them.
    fused_ops = {}
    with plain_stream_kernels(fused_ops):
        fh.grid_sorted(vre, vim)
        fh.degrid_sorted(model)
    del bg, fh

    grid_args, degrid_args = kernel_operands(torch, g, pplan, dev, 12)
    bv = pplan.block_v
    valid_p = int(pplan.arrays["valid"].sum())
    times = {}
    moved_bytes = {}

    def time_kernel(name, kern, ref, args, kw, ops, k_iters=10, p_iters=5,
                    p_warmup=2, moved=None):
        """Turns: plain, kernel, kernel, plain; keeps the second of each
        and the bound of one call's operands and output (or of ``moved``
        bytes)."""
        p1 = cuda_ms(torch, lambda: ref(*args, **kw), p_iters, p_warmup)
        k1 = cuda_ms(torch, lambda: kern(*args, **kw), k_iters)
        k2 = cuda_ms(torch, lambda: kern(*args, **kw), k_iters)
        p2 = cuda_ms(torch, lambda: ref(*args, **kw), p_iters, p_warmup)
        out = kern(*args, **kw)
        times[name] = (k2, p2) + bound(args, out, ops, moved)
        moved_bytes[name] = nbytes(args) + nbytes(out) if moved is None \
            else moved
        return f"kernel {k1:.3f}/{k2:.3f} ms, plain {p1:.3f}/{p2:.3f} ms, " \
            f"bound {times[name][2]:.4f} ms by {times[name][3]}"

    # K1/K2 as the gridders call them (the plan's run table given), in
    # both tensor-core modes; then the product alone by torch.bmm.
    gfast = packed_gridder(pplan, fast=True, device=dev)
    for tag, gx in (("", g), ("[bf16]", gfast)):
        args2 = (grid_args, degrid_args) if gx is g else kernel_operands(
            torch, gx, pplan, dev, 12)
        for (name, kern, ref), args in zip(
                (("grid_packed_stack", tk.grid_packed_stack,
                  tk.grid_packed_stack_reference),
                 ("degrid_stack", tk.degrid_stack,
                  tk.degrid_stack_reference)), args2):
            say(f"# [{gpu}] {name}{tag} at main-path shapes "
                f"('{gx.precision}'): " + time_kernel(
                    name + tag, kern, ref, args,
                    dict(block_v=bv, runs=gx.runs), tap_ops(valid_p, 8, 4)))
        del args2
    del gfast
    library = product_library_ms(torch, tk, grid_args, degrid_args, bv)
    say(f"# [{gpu}] K1/K2 yardstick, the product alone (torch.bmm of the "
        f"plain versions' operands, ms f32 / bf16): " + "; ".join(
            f"{k} {f:.3f} / {b:.3f}" for k, (f, b) in library.items()))

    for name, _ in TOWER_KERNELS:
        args, kw = ops[name]
        # Each valid slot's S x S taps on its Sw layers (the plane kernels'
        # stack, the all-layer kernels' window of the tower). The plane
        # kernels move the mask and their active entries' operands only.
        moved = None
        if name.endswith("plane"):
            p_geom, p_stack = args[-3], args[0]
            moved = plane_bytes(p_geom, p_stack, tower_valid[name], 8, 4,
                                name == "grid_plane")
        say(f"# [{gpu}] {name} at main-path shapes: " + time_kernel(
            name, getattr(tt, name), getattr(tt, name + "_reference"), args,
            kw, tap_ops(tower_valid[name], 8, 4), k_iters=20, moved=moved))
        # The bf16 mode reads the same f32 operands and rounds them in
        # registers: the same bytes and operations.
        say(f"# [{gpu}] {name} [bf16] at main-path shapes: " + time_kernel(
            f"{name}[bf16]", getattr(tt, name),
            getattr(tt, name + "_reference"), args, {**kw, "fast": True},
            tap_ops(tower_valid[name], 8, 4), k_iters=20, moved=moved))
        if name.endswith("plane"):
            # The same call on an all-masked plane: the stack copy (grid)
            # or the result's zeroing (degrid), the compaction and an empty
            # consumer launch, the floor of the two-launch design.
            p_empty = list(args)
            p_empty[-3] = (torch.zeros_like(p_geom[0]),) + tuple(p_geom[1:])
            p_fn = getattr(tt, name)
            t_empty = [cuda_ms(torch, lambda: p_fn(*p_empty, **kw), 20)
                       for _ in range(2)]
            d_full, d_names, _ = device_us(torch,
                                           lambda: p_fn(*args, **kw))
            d_empty, _, _ = device_us(torch, lambda: p_fn(*p_empty, **kw))
            say(f"# [{gpu}] {name} on an all-masked plane of the same "
                f"shapes: {t_empty[0]:.4f}/{t_empty[1]:.4f} ms; device "
                f"time per call (torch.profiler, 20 calls): "
                + (f"{d_full:.1f} us, all-masked {d_empty:.1f} us "
                   f"({', '.join(d_names)})" if d_full and d_empty
                   else "not measured (no device time in the trace)")
                + f"; old bound (every entry's taps read) "
                f"{bound(args, p_fn(*args, **kw), 0)[0]:.4f} ms")
    # K16/K17 as the fallback launches them: once over window b's stream
    # (then at the wider supports, on random taps).
    def task_moved(name, args):
        tasks = args[-3] if name.startswith("grid") else args[-2]
        weights = args[-4] if name.startswith("grid") else args[-3]
        out = (tasks.planes * args[-2] ** 2 if name.startswith("grid")
               else weights.shape[0]) * 8            # complex64
        return task_bytes(args, weights, tasks, out)

    for name, kernel_name in TASK_KERNELS:
        args, kw = ops[name]
        say(f"# [{gpu}] {name} ({kernel_name} over every task) at window "
            f"b's stream: " + time_kernel(
                name, getattr(tt, name), getattr(tt, name + "_reference"),
                args, kw, tap_ops(tower_valid[name], 8, 4), k_iters=20,
                p_iters=1, p_warmup=1, moved=task_moved(name, args)))
        d_us, d_names, _ = device_us(torch, lambda: getattr(tt, name)(
            *args, **kw))
        say(f"# [{gpu}] {name} device time per call (torch.profiler, 20 "
            f"calls): " + (f"{d_us:.1f} us ({', '.join(d_names)})" if d_us
                           else "not measured (no device time in the "
                           "trace)"))
    for sup, w_ops in wide_ops.items():
        for name, _ in TASK_KERNELS:
            args, kw = w_ops[name]
            say(f"# [{gpu}] {name} at support {sup} (window b's stream, "
                f"random taps): " + time_kernel(
                    f"{name}[S={sup}]", getattr(tt, name),
                    getattr(tt, name + "_reference"), args, kw,
                    tap_ops(tower_valid[name], sup, 4), k_iters=20, p_iters=1,
                    p_warmup=1, moved=task_moved(name, args)))
    for tag, fast in (("", False), ("[bf16]", True)):
        say(f"# [{gpu}] grid_all_layers_sparse{tag} on the fallback's "
            f"largest task: " + time_kernel(
                f"grid_all_layers_sparse{tag}", ts.grid_all_layers_sparse,
                ts.grid_all_layers_sparse_reference, sp_args,
                dict(fast=fast), tap_ops(sparse_valid, 8, 4), k_iters=20))
    stream_mods = {"fused_tap": fused_tap, "place": place}
    # The fused kernels' Chebyshev terms: the stream plan's uv tap fit.
    from ska_sdp_func_torch.grid_data.wtower import _tap_coeffs_cached

    ncoef = _tap_coeffs_cached(sp_d.wplan.support,
                               sp_d.wplan.oversampling).shape[0]
    for name, mod, _, _ in STREAM_KERNELS:
        args, kw = stream_ops[name][0]
        v = stream_valid.get(name, 0)
        n_ops = tap_ops(v, 8, 4) + cheb_ops(v, 8, 4, ncoef)
        say(f"# [{gpu}] {name} at the dense stream's shapes, "
            f"'{kw.get('precision', 'copy')}': " + time_kernel(
                name, getattr(stream_mods[mod], name),
                getattr(stream_mods[mod], name + "_reference"), args, kw,
                n_ops, p_iters=2, p_warmup=1))
    k5_args, k5_kw = stream_ops["place_stream"][0]
    d_us, d_names, d_ops = device_us(
        torch, lambda: place.place_stream(*k5_args, **k5_kw))
    place_dev = dict(device_ms=d_us and d_us / 1e3, device_ops=d_ops)
    say(f"# [{gpu}] place_stream at the dense stream's shapes ("
        f"{len(k5_args[2])} payloads, {k5_args[0].shape[0]} blocks of "
        f"{k5_args[3]}): device time per call (torch.profiler, 20 calls) "
        + (f"{d_us / 1e3:.4f} ms in {d_ops:g} operations "
           f"({', '.join(d_names)})" if d_us
           else "not measured (no device time in the trace)"))
    from ska_sdp_func_torch.kernels import band_tap

    es_valid = int(es["plans"]["3-D"]._packed.arrays["valid"].sum())
    for name, _ in ES_KERNELS:
        args, kw = es["ops"][name][0]        # the 3-D plan's call
        say(f"# [{gpu}] {name} at the ES-FFT 3-D shapes: " + time_kernel(
            name, getattr(band_tap, name),
            getattr(band_tap, name + "_reference"), args, kw,
            tap_ops(es_valid, 8, 8), p_iters=2, p_warmup=1))
    # K8 and K11 at window j's dense stream (f32; their bf16 modes below).
    for name in ("grid_packed", "degrid_fused"):
        args, kw = np_ops[name][0]
        say(f"# [{gpu}] {name} at the non-packable dense stream's shapes: "
            + time_kernel(f"{name}[dense stream]", getattr(band_tap, name),
                          getattr(band_tap, name + "_reference"), args, kw,
                          tap_ops(np_valid, 8, 4), p_iters=2, p_warmup=1))
    # K6, K7 and the fold kernel on window j's operands (captured in 3).
    from ska_sdp_func_torch.kernels import fold, stream_prep

    ncoef_j = _tap_coeffs_cached(8, NP_OVERSAMPLING).shape[0]
    for name, _ in PREP_KERNELS:
        args, kw = np_ops[name][0]
        scale_rows = 2 if name == "stream_prep_grid" else 1
        say(f"# [{gpu}] {name} at the non-packable dense stream's shapes: "
            + time_kernel(name, getattr(stream_prep, name),
                          getattr(stream_prep, name + "_reference"), args,
                          kw, prep_ops(np_valid, 8, 4, ncoef_j, scale_rows),
                          p_iters=2, p_warmup=1))
    args, kw = np_ops["fold_windows"][0]
    wins, visited, num_octets = args[0], args[1], sp_j.num_octets
    say(f"# [{gpu}] fold_windows at the non-packable dense stream's shapes "
        f"({int(visited.sum())} visited buckets of {visited.numel()}, "
        f"{int(visited.reshape(-1, num_octets)[:, -1].sum())} of them last "
        f"octets): " + time_kernel(
            "fold_windows", fold.fold_windows, fold.fold_windows_reference,
            args, kw, fold_reads(wins, visited, num_octets), p_iters=2,
            p_warmup=1, moved=fold_bytes(wins, visited, num_octets,
                                         fold.fold_windows(*args, **kw))))
    # The bf16 modes of K6, K7, K8 and K11 on window k's operands.
    bf16_mods = {"stream_prep_grid": stream_prep, "stream_prep_degrid":
                 stream_prep, "grid_packed": band_tap,
                 "degrid_fused": band_tap}
    for name, _, _ in BF16_KERNELS:
        args, kw = bf_ops[name][0]
        if name.startswith("stream_prep"):
            n_ops = prep_ops(np_valid, 8, 4, ncoef_j,
                             2 if name == "stream_prep_grid" else 1)
        else:
            n_ops = tap_ops(np_valid, 8, 4)
        say(f"# [{gpu}] {name} [bf16] at the non-packable dense stream's "
            f"shapes: " + time_kernel(
                f"{name}[bf16]", getattr(bf16_mods[name], name),
                getattr(bf16_mods[name], name + "_reference"), args, kw,
                n_ops, p_iters=2, p_warmup=1))
    # K18 and K19 at "highest" on window f's operands; the bound counts
    # each slot's taps once (the kernels evaluate them per window plane,
    # K18, or per warp lane, K19).
    for name, args, extra in (("grid_fused", word_grid, word_gkw),
                              ("degrid_fused2", word_degrid, word_dkw)):
        say(f"# [{gpu}] {name} at the dense stream's shapes, 'highest': "
            + time_kernel(name, getattr(band_tap, name),
                          getattr(band_tap, name + "_reference"), args,
                          {**word_kw, **extra},
                          tap_ops(word_valid, 8, 4)
                          + cheb_ops(word_valid, 8, 4, ncoef),
                          p_iters=2, p_warmup=1))
    # K12/K13 at "highest" beside K3/K4 on the same plan and stream (the
    # price of the fused kernels' Chebyshev evaluation); turns: fused,
    # compact, compact, fused.
    for name, fused_name in (("grid_compact", "grid_fused_stack"),
                             ("degrid_compact", "degrid_fused2_stack")):
        args, kw = cp["ops"][name][0]
        say(f"# [{gpu}] {name} at main-path shapes, 'highest': "
            + time_kernel(name, getattr(fused_tap, name),
                          getattr(fused_tap, name + "_reference"), args, kw,
                          tap_ops(valid_p, 8, 4), p_iters=2, p_warmup=1))
        f_args, f_kw = fused_ops[fused_name][0]
        f_kern = getattr(fused_tap, fused_name)
        f1 = cuda_ms(torch, lambda: f_kern(*f_args, **f_kw), 10)
        c1 = cuda_ms(torch, lambda: getattr(fused_tap, name)(*args, **kw), 10)
        c2 = cuda_ms(torch, lambda: getattr(fused_tap, name)(*args, **kw), 10)
        f2 = cuda_ms(torch, lambda: f_kern(*f_args, **f_kw), 10)
        say(f"# [{gpu}] {name} beside {fused_name} on the same plan, "
            f"'highest': {c1:.3f}/{c2:.3f} ms vs {f1:.3f}/{f2:.3f} ms")

    def row(name, source, where, launched, err):
        k, p, b, by = times[name]
        return dict(name=name, route="cuda", source=source, replaces=where,
                    launches=launched, max_abs_err=err, ms=k, plain_ms=p,
                    bound_ms=b, bound_by=by, library_ms=None,
                    bound_ms_read_rate=read_rate_bound(
                        moved_bytes[name], b, by, read_rate))

    def window_row(r):
        """The rows of the window kernels (K4, K11, K13, K19: the gather;
        K3, K8, K12, K18: the scatter) name their redesigned kernel, its
        template instance and its ptxas registers and spills."""
        for rows, source, note, kernel, found in (
                (GATHER_ROWS, GATHER_SOURCE, GATHER_REDESIGN,
                 "window_gather_kernel", ptxas),
                (SCATTER_ROWS, SCATTER_SOURCE, SCATTER_REDESIGN,
                 "window_scatter_kernel", scatter_ptxas)):
            key = rows.get(r["name"])
            if key is not None:
                r.update(source=source, redesigned=note,
                         instance=f"{kernel}<{GATHER_MODES[key[0]]}, "
                                  f"{GATHER_FORMS[key[1]]}>",
                         ptxas=found.get(key))
        return r

    def prep_row(r):
        """K6/K7's rows (f32 and bf16) name their redesigned kernel, the
        template instance the path's fits take and its ptxas registers
        and spills."""
        name, _, tag = r["name"].partition("[")
        if name.startswith("stream_prep"):
            grid, fast = name == "stream_prep_grid", tag == "bf16]"
            uv, w = (bf_ops if fast else np_ops)[name][0][0][-4:-2]
            ncoef_r, support_r = uv.shape
            inst = stream_prep.instance(grid, fast, ncoef_r, support_r,
                                        w.shape[1])
            key = (int(grid), int(fast)) + (
                (ncoef_r, support_r) if inst.endswith("12, 8>") else (0, 0))
            r.update(redesigned=PREP_REDESIGN, instance=inst,
                     ptxas=prep_regs.get(key))
        return r

    def plane_row(r):
        """K14/K15's rows name their redesigned kernels' source."""
        if r["name"].split("[")[0].endswith("plane"):
            r.update(source=PLANE_SOURCE, redesigned=PLANE_REDESIGN)
        return r

    def task_row(name, where):
        """K16/K17's rows: the batched call's numbers at window b's stream
        and launches in window b, the one-task call's on the largest task
        beside them."""
        batched = {k: b for b, k in TASK_KERNELS}[name]
        r = row(batched, TOWER_SOURCE, where, fb_launches[batched],
                tower_err[batched])
        k, p, b, _ = times[name]
        r.update(name=name, entry=batched, redesigned=TASK_REDESIGN,
                 single_task_ms=k, single_task_plain_ms=p,
                 single_task_bound_ms=b)
        return r

    def packed_row(name, tag, where, launched, err):
        """K1/K2's rows: the tensor-core kernels, the product alone by
        torch.bmm as their yardstick."""
        r = row(name + tag, WGMMA_SOURCE, where, launched, err)
        f32_ms, bf16_ms = library[name]
        r.update(library_ms=bf16_ms if tag else f32_ms,
                 library_f32_ms=f32_ms, library_bf16_ms=bf16_ms,
                 library=LIBRARY_NOTE, redesigned=PACKED_REDESIGN)
        return r

    kernels = [
        packed_row(name, tag, where, won[name], abs_err[mode][kind])
        for tag, mode, won in (("", "high", launches),
                               ("[bf16]", "bf16", fast_launches))
        for name, kind, where in (
            ("grid_packed_stack", "grid",
             "ska_sdp_func_tpu/kernels/packed_tap.py:249"),
            ("degrid_stack", "degrid",
             "ska_sdp_func_tpu/kernels/packed_tap.py:839"))
    ] + [
        row(name, "ska_sdp_func_torch/kernels/" + src, where,
            st_launches[name], stream_err[name])
        for name, _, src, where in STREAM_KERNELS
    ] + [
        plane_row(row(name, TOWER_SOURCE, where, td_launches[name],
                      tower_err[name])) if name.endswith("plane")
        else task_row(name, where)
        for name, where in TOWER_KERNELS
    ] + [
        row(name, SCATTER_SOURCE, where, es["launches"][name],
            es["errs"][name])
        for name, where in ES_KERNELS
    ] + [
        row(name, SCATTER_SOURCE, where, cp["launches"][name],
            cp["errs"][name])
        for name, where in COMPACT_KERNELS
    ] + [
        row(name, PREP_SOURCE, where, np_launches[name], np_err[name])
        for name, where in PREP_KERNELS
    ] + [
        # One kernel replaces both folds: a row for each, its numbers.
        dict(row("fold_windows", FOLD_SOURCE, where,
                 np_launches["fold_windows"], np_err["fold_windows"]),
             name=f"fold_windows[{tpu_name}]")
        for tpu_name, where in FOLD_REPLACES
    ] + [
        row(f"{name}[dense stream]", source, where, np_launches[name],
            np_err[name])
        for (name, where), source in zip(ES_KERNELS, (SCATTER_SOURCE,
                                                      GATHER_SOURCE))
    ] + [
        row(f"{name}[bf16]", source, where, k_launches[name], bf_err[name])
        for name, source, where in BF16_KERNELS
    ] + [
        row(name, SCATTER_SOURCE, where, w_launches[name],
            word_err[name])
        for name, where in WORD_KERNELS
    ] + [
        dict(row(f"grid_all_layers_sparse{tag}", SPARSE_SOURCE,
                 SPARSE_REPLACES, m_launches[tag], sparse_err[tag]),
             redesigned=SPARSE_REDESIGN,
             instance=f"sparse_grid_kernel<{str(bool(tag)).lower()}>",
             ptxas=exp_ptxas["sparse_grid_kernel"].get((int(bool(tag)),)),
             **sparse_dev[tag]) for tag in ("", "[bf16]")
    ] + [
        # K16/K17 reach the mode through the sub-grid gridder's switch
        # (window n's second run); K14/K15 through their wrappers only.
        plane_row(row(f"{name}[bf16]", TOWER_SOURCE, where,
                      (n_launches if name.endswith("plane")
                       else nd_launches)[name], fast_err[name]))
        for name, where in TOWER_KERNELS
    ] + [
        exp_row(name, source, where, exp_sites[name][0], exp_sites[name][1],
                headline, read_rate)
        for name, _, _, _, source, where, headline in EXPERIMENT_SITES]
    for r in kernels:
        if r["name"] in EXPERIMENT_REDESIGN:
            note, kernel, key = EXPERIMENT_REDESIGN[r["name"]]
            r.update(redesigned=note,
                     instance=f"{kernel}<{', '.join(map(str, key))}>",
                     ptxas=exp_ptxas[kernel].get(key))
    for r in kernels:
        if r["name"] == "place_stream":
            r.update(source=PLACE_SOURCE, redesigned=PLACE_REDESIGN,
                     instance="place_stream_kernel<true>",
                     ptxas=exp_ptxas["place_stream_kernel"].get((1,)),
                     **place_dev)
    kernels = [prep_row(window_row(r)) for r in kernels]
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def times_main(times) -> int:
    """``chip_smoke.py --packed-times`` (and the other timing modes):
    ``times`` of the package at the working directory (a checkout's root),
    one JSON line (or one a record, for a list)."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.getcwd())
    import ska_sdp_func_torch
    from ska_sdp_func_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gpu = run(["nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader"]).splitlines()[0]
    _build.load()
    head = {"checkout": os.path.dirname(ska_sdp_func_torch.__file__),
            "gpu": gpu}
    out = times(torch, torch.device("cuda", 0))
    for record in out if isinstance(out, list) else [out]:
        say(json.dumps({**head, **record}))
    return 0


TIMES = {"--packed-times": packed_times, "--predict-times": predict_times,
         "--ingest-times": ingest_times,
         "--experiment-times": experiment_times,
         "--sparse-place-times": sparse_place_times}


if __name__ == "__main__":
    if len(sys.argv) == 2 and sys.argv[1] in TIMES:
        sys.exit(times_main(TIMES[sys.argv[1]]))
    sys.exit(main())
