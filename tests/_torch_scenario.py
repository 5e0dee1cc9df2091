"""Shared small scenario for the PyTorch-port parity tests.

The 150-row x 2-channel, 256^2 scenario of test_packed_driver.py, drawn
from a NumPy seed so the JAX package and the port see identical inputs.
"""

import numpy as np

C_0 = 299792458.0

PARAMS = dict(
    subgrid_size=128,
    theta=0.002,
    w_step=50.0,
    shear_u=0.0,
    shear_v=0.0,
    support=8,
    oversampling=16 * 1024,
    w_support=4,
    w_oversampling=16 * 1024,
    subgrid_frac=2.0 / 3.0,
    w_tower_height=4.0,
)
IMAGE_SIZE = 256
NUM_ROWS, NUM_CHAN = 150, 2
FREQ0, DFREQ = C_0, C_0 / 100


def make_inputs(seed: int = 5):
    """(uvw [rows, 3] f64, vis [rows, chan] complex64)."""
    rng = np.random.default_rng(seed)
    uvw = rng.uniform(-1, 1, (NUM_ROWS, 3))
    uvw[:, :2] *= 0.3 * IMAGE_SIZE / 2 / PARAMS["theta"]
    uvw[:, 2] *= 2.0 * PARAMS["w_step"] * PARAMS["w_tower_height"] / 2
    vis = (rng.standard_normal((NUM_ROWS, NUM_CHAN))
           + 1j * rng.standard_normal((NUM_ROWS, NUM_CHAN))
           ).astype(np.complex64)
    return uvw, vis


def two_point_image() -> np.ndarray:
    """The bounded two-point model test_packed_driver.py degrids."""
    img = np.zeros((IMAGE_SIZE, IMAGE_SIZE), np.float32)
    img[IMAGE_SIZE // 2 + 12, IMAGE_SIZE // 2 - 9] = 1.0
    img[IMAGE_SIZE // 2 - 20, IMAGE_SIZE // 2 + 15] = 0.5
    return img


def taper(jax_plan) -> np.ndarray:
    """1 / grid_correct(ones): weights the 1/PSWF-amplified border down
    so images compare where they are well conditioned
    (test_packed_driver.py:350-368)."""
    import jax.numpy as jnp

    kern = jax_plan.kernel()
    n = jax_plan.image_size
    return 1.0 / np.asarray(kern.grid_correct(
        jnp.ones((n, n), jnp.float32)))


# The w-towers sub-grid scenario of test_wtower.py:239-295: earth-rotation
# coverage of 8 antennas over 12 times (336 rows x 3 channels), scaled
# inside a 64^2 sub-grid with a few w-planes, and a two-source sub-grid
# image.
WTOWER_PARAMS = dict(
    image_size=256,
    subgrid_size=64,
    theta=0.002,
    w_step=100.0,
    shear_u=0.1,
    shear_v=-0.15,
    support=8,
    oversampling=16 * 1024,
    w_support=4,
    w_oversampling=16 * 1024,
)


def wtower_scenario(num_ant=8, num_times=12, max_bl=4000.0, seed=42):
    """(uvw [rows, 3] f64, ch_count, subgrid image [64, 64] f64)."""
    rng = np.random.default_rng(seed)
    ants = rng.uniform(-max_bl / 2, max_bl / 2, (num_ant, 3))
    ants[:, 2] *= 0.02
    baselines = np.array([ants[i] - ants[j] for i in range(num_ant)
                          for j in range(i + 1, num_ant)])
    sd, cd = np.sin(np.radians(40.0)), np.cos(np.radians(40.0))
    rows = []
    for ha in np.linspace(0, np.pi / 3, num_times, endpoint=False):
        sh, ch = np.sin(ha), np.cos(ha)
        bx, by, bz = baselines.T
        rows.append(np.stack([sh * bx + ch * by,
                              -sd * ch * bx + sd * sh * by + cd * bz,
                              cd * ch * bx - cd * sh * by + sd * bz],
                             axis=-1))
    uvw = np.concatenate(rows, axis=0)
    uvw[:, :2] *= 16.0 / WTOWER_PARAMS["theta"] / np.abs(uvw[:, :2]).max()
    uvw[:, 2] *= 350.0 / np.abs(uvw[:, 2]).max()
    sg = WTOWER_PARAMS["subgrid_size"]
    image = np.zeros((sg, sg))
    image[sg // 4, sg // 4] = 1.0
    image[5 * sg // 6, 2 * sg // 6] = 0.5
    return uvw, 3, image


# Operands of the fused kernels (K3/K4) at the small scenario's geometry:
# 12 plan blocks of 128 slots over 3 tasks of 6 layers, two blocks marked
# empty, random plan words (a few v columns past the 128 lanes) and a
# random task stack.
FUSED = dict(lanes=128, support=8, w_support=4, oversampling=16384,
             w_oversampling=16384, tasks=3, layers=6, block_v=128, blocks=12)


def fused_kernel_operands(seed: int = 17):
    """NumPy plan fields, packed words, block indices, visibilities and a
    stack for the fused kernels (``FUSED`` geometry)."""
    f = FUSED
    rng = np.random.default_rng(seed)
    total = f["blocks"] * f["block_v"]
    s, lanes = f["support"], f["lanes"]
    fields = dict(
        iv0=rng.integers(0, lanes - s + 1, total),
        u_off=rng.integers(0, 8, total),
        w_row=rng.integers(0, f["w_oversampling"] + 1, total),
        u_frac=rng.integers(0, f["oversampling"] + 1, total),
        v_frac=rng.integers(0, f["oversampling"] + 1, total),
        valid=rng.random(total) < 0.9)
    fields["iv0"][:5] = lanes - np.arange(1, 6)
    fields = {k: v.astype(np.int32) for k, v in fields.items()}
    pa = ((fields["iv0"] << 20) | (fields["u_off"] << 17)
          | fields["w_row"]).astype(np.int32)
    pb = ((fields["valid"] << 30) | (fields["u_frac"] << 15)
          | fields["v_frac"]).astype(np.int32)
    valid = fields["valid"].astype(bool)
    nonempty = np.ones(f["blocks"], np.int32)
    nonempty[[1, 6]] = 0
    ops = dict(
        t=np.repeat(np.arange(f["tasks"]),
                    f["blocks"] // f["tasks"]).astype(np.int32),
        k=rng.integers(0, f["layers"] - f["w_support"] + 1,
                       f["blocks"]).astype(np.int32),
        g=rng.integers(0, lanes // 8, f["blocks"]).astype(np.int32),
        pa=pa, pb=pb,
        vre=np.where(valid, rng.standard_normal(total), 0.0
                     ).astype(np.float32),
        vim=np.where(valid, rng.standard_normal(total), 0.0
                     ).astype(np.float32),
        nonempty=nonempty,
        stack=rng.standard_normal(
            (f["tasks"], 2, f["layers"] * (lanes + 8), lanes)
        ).astype(np.float32))
    return fields, ops


def es_scenario(seed: int = 42):
    """tests/test_es_fft.py's ES-FFT data: 150 rows x 2 channels inside a
    64^2 image of 2 degrees, complex128 visibilities, unit weights."""
    rng = np.random.default_rng(seed)
    num_rows, num_chan = 150, 2
    image_size = 64
    pixel_size = 2.0 * np.pi / 180.0 / image_size
    max_u = 0.4 * image_size / 2 / (image_size * pixel_size)
    uvw = rng.uniform(-1, 1, (num_rows, 3)) * max_u
    uvw[:, 2] *= 0.1
    freq = np.array([C_0, 1.1 * C_0])
    vis = (rng.standard_normal((num_rows, num_chan))
           + 1j * rng.standard_normal((num_rows, num_chan)))
    return dict(uvw=uvw, freq=freq, vis=vis,
                weight=np.ones((num_rows, num_chan)), image_size=image_size,
                pixel_size=pixel_size)


# The per-plane tap kernels' (K14/K15) compaction cases: one w-plane's
# [rows, chans] geometry whose active entries are none ("masked"), only
# the last (row, channel) ("last"), a few rows with contiguous channel
# ranges whose cells drift along the channels, as the task drivers make
# them ("clustered"), or half the entries with cells at the clip edge
# N - S ("edge").
PLANE_CASES = ("masked", "last", "clustered", "edge")


def plane_case(case: str, size: int, rows: int = 48, chans: int = 8,
               support: int = 8, w_support: int = 4, ov: int = 64,
               seed: int = 0):
    """(geometry, uv_kernel [ov + 1, S], w_kernel [ov + 1, Sw], vis
    [rows, chans] complex64, stack [Sw, size, size] complex64) as NumPy:
    int32 cells and kernel rows, a bool mask, random tables."""
    rng = np.random.default_rng(seed)
    shape = (rows, chans)
    top = size - support
    iu0 = rng.integers(0, top + 1, shape)
    iv0 = rng.integers(0, top + 1, shape)
    mask = np.zeros(shape, bool)
    if case == "last":
        mask[-1, -1] = True
    elif case == "clustered":
        for r in rng.choice(rows, 4, replace=False):
            lo = rng.integers(0, chans - 1)
            mask[r, lo:rng.integers(lo + 1, chans + 1)] = True
            ramp = np.arange(chans)
            iu0[r] = np.clip(rng.integers(0, top + 1) + ramp // 2, 0, top)
            iv0[r] = np.clip(rng.integers(0, top + 1) - ramp // 3, 0, top)
    elif case == "edge":
        mask = rng.random(shape) < 0.5
        iu0[rng.random(shape) < 0.5] = top
        iv0[rng.random(shape) < 0.5] = top
    elif case != "masked":
        raise ValueError(case)
    geom = (mask, iu0.astype(np.int32), iv0.astype(np.int32),
            *(rng.integers(0, ov + 1, shape).astype(np.int32)
              for _ in range(3)))

    def cplx(shp):
        return (rng.standard_normal(shp)
                + 1j * rng.standard_normal(shp)).astype(np.complex64)

    return (geom, rng.uniform(-1, 1, (ov + 1, support)).astype(np.float32),
            rng.uniform(0.1, 1, (ov + 1, w_support)).astype(np.float32),
            cplx(shape), cplx((w_support, size, size)))


# Ragged task streams for the batched all-layer kernels (K16/K17 over
# every task of a call): (slots, layers) per task in slot order, with
# layer counts 6-10, a single 128-slot block, a task whose slots are all
# padding (zero weights and visibilities), an empty task, a gap of
# GAP_SLOTS slots no task holds before the last task and TAIL_SLOTS more
# after it.
TASK_SPECS = ((300, 6), (128, 10), (256, 8), (0, 7), (200, 7), (140, 6))
PADDING_TASK = 2
GAP_SLOTS, TAIL_SLOTS = 16, 40


def task_stream(size: int, seed: int = 0, support: int = 8,
                w_support: int = 4, specs=TASK_SPECS):
    """(vre, vim [V] f32, iu0, iv0 [V] int32, uk, vk [V, S] f32, weights
    [V, Kw] f32, rows) as NumPy: each slot weighted on a window of
    ``w_support`` consecutive layers of its task (zero beyond the task's
    layers; a tenth of the slots and the padding task all zero), cells in
    range with a few at the clip edge N - S, and the task rows ``(start,
    count, layers, base)`` with the plane bases in a random task order."""
    rng = np.random.default_rng(seed)
    kw = max(k for _, k in specs)
    starts, pos = [], 0
    for i, (count, _) in enumerate(specs):
        if i == len(specs) - 1:
            pos += GAP_SLOTS
        starts.append(pos)
        pos += count
    total = pos + TAIL_SLOTS
    top = size - support
    iu0 = rng.integers(0, top + 1, total)
    iv0 = rng.integers(0, top + 1, total)
    iu0[rng.random(total) < 0.05] = top
    iv0[rng.random(total) < 0.05] = top
    weights = np.zeros((total, kw), np.float32)
    vre = rng.standard_normal(total).astype(np.float32)
    vim = rng.standard_normal(total).astype(np.float32)
    for i, ((count, k), start) in enumerate(zip(specs, starts)):
        sl = slice(start, start + count)
        if i == PADDING_TASK:
            vre[sl] = vim[sl] = 0.0
            continue
        j = rng.integers(0, k - w_support + 1, count)
        for layer in range(w_support):
            weights[start + np.arange(count), j + layer] = rng.uniform(
                0.1, 1, count)
        weights[sl][rng.random(count) < 0.1] = 0.0
    bases, planes = {}, 0
    for i in rng.permutation(len(specs)):
        bases[i] = planes
        planes += specs[i][1]
    rows = tuple((s, c, k, bases[i])
                 for i, ((c, k), s) in enumerate(zip(specs, starts)))
    return (vre, vim, iu0.astype(np.int32), iv0.astype(np.int32),
            rng.standard_normal((total, support)).astype(np.float32),
            rng.standard_normal((total, support)).astype(np.float32),
            weights, rows)


def task_taps(taps, task):
    """One bucketed task's slice of the fallback's stream taps ``(iu0, iv0,
    uk, vk, weights)``, its weights cut to its own layers: the operands of
    the one-task all-layer kernels."""
    sl = slice(task.start, task.start + task.size)
    iu0, iv0, uk, vk, weights = taps
    return (iu0[sl], iv0[sl], uk[sl], vk[sl],
            weights[sl, :task.num_layers].contiguous())


# bench.py's seeded main-path scenario (chip_smoke.py's window a): 512^2
# image, 128^2 sub-grids, 16384 rows x 64 channels, seed 1.
BENCH = dict(image=512, subgrid=128, theta=0.002, w_step=100.0, height=4.0,
             rows=16384, chans=64, seed=1)


def bench_uvw() -> np.ndarray:
    """The bench scenario's uvw [rows, 3] f64 (its visibility draws
    follow in the same generator and are not needed for a plan)."""
    b = BENCH
    rng = np.random.default_rng(b["seed"])
    uvw = rng.uniform(-1, 1, (b["rows"], 3))
    uvw[:, :2] *= 0.45 * b["image"] / 2 / b["theta"]
    uvw[:, 2] *= 1.5 * b["w_step"] * b["height"]
    return uvw
