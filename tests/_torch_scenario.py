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
