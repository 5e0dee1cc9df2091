"""The one traffic generator: inputs made from the configuration and
``--seed``.

A traffic file (``traffic/<name>.json``) holds parameters only; every
cell's inputs come from these functions, so two runs with one seed see
the same inputs, and a new traffic mix is a new data file:

- ``uvw``: baseline coordinates in metres of the configuration's array
  (``config["array"]``, :func:`stations`) observing a field at
  declination ``dec_deg``, one correlator dump of every baseline after
  another, the first at hour angle ``hour_angle_h`` and each the
  configuration's ``dump_s`` seconds of sidereal rotation after the one
  before. The array and the pointing are the deployment's, so uvw is
  the same for every seed;
- ``vis``: complex visibilities, each part normal with ``sigma``;
- ``sky``: model images: point sources and one Gaussian (truncated at
  ``radius_px``), each image moved by a seeded shift of up to
  ``shift_px`` pixels, positions given on a ``base_size`` image and
  scaled to the configuration's.

Each seeded draw has a generator of its own (``stream``), so adding a
draw to one cell never moves another draw's numbers.
"""

import math

import numpy as np
import torch

_STREAMS = {"vis": 2, "sky": 3, "check": 4}


def generator(seed: int, stream: str, device) -> torch.Generator:
    """A generator on ``device`` for one named draw of ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) * 8 + _STREAMS[stream]) % (1 << 63))
    return gen


# Radians of sidereal rotation a second.
SIDEREAL_RAD_S = 2 * math.pi / 86164.0905


def stations(array: dict) -> np.ndarray:
    """Station positions [S, 3] (east, north, up) in metres, drawn from
    ``array["layout_seed"]``: ``core_stations`` at random inside a disc
    of ``core_radius_m``, no two closer than ``station_spacing_m``; then
    ``arms`` logarithmic spiral arms of ``clusters_per_arm`` clusters,
    their centres from ``arm_inner_m`` to ``arm_outer_m`` in equal
    ratios, turning by ``arm_winding_rad`` along the arm, each cluster
    ``cluster_stations`` stations on a circle of ``cluster_radius_m``
    (turned by a random angle). The array is coplanar (up 0)."""
    rng = np.random.default_rng(array["layout_seed"])
    radius, spacing = array["core_radius_m"], array["station_spacing_m"]
    core = np.zeros((0, 2))
    while core.shape[0] < array["core_stations"]:
        r = radius * math.sqrt(rng.random())
        t = 2 * math.pi * rng.random()
        p = np.array([[r * math.cos(t), r * math.sin(t)]])
        if np.all(np.hypot(*(core - p).T) >= spacing):
            core = np.concatenate([core, p])
    inner, outer = array["arm_inner_m"], array["arm_outer_m"]
    n = array["clusters_per_arm"]
    per = array["cluster_stations"]
    out = [core]
    for arm in range(array["arms"]):
        for j in range(n):
            rc = inner * (outer / inner) ** (j / (n - 1))
            ang = (2 * math.pi * arm / array["arms"]
                   + array["arm_winding_rad"] * j / (n - 1))
            turn = 2 * math.pi * rng.random()
            t = turn + 2 * math.pi * np.arange(per) / per
            out.append(rc * np.array([[math.cos(ang), math.sin(ang)]])
                       + array["cluster_radius_m"]
                       * np.stack([np.cos(t), np.sin(t)], axis=1))
    east_north = np.concatenate(out)
    return np.concatenate([east_north, np.zeros((len(east_north), 1))],
                          axis=1)


def baselines(config: dict) -> int:
    s = len(stations(config["array"]))
    return s * (s - 1) // 2


def uvw(config: dict, params: dict, dumps: int, device) -> torch.Tensor:
    """uvw [dumps * B, 3] float64 on ``device``: the first ``dumps``
    dumps of the ``B`` baselines ``(i, j)``, ``i < j``, of the
    configuration's array (``params``: ``dec_deg``, ``hour_angle_h``)."""
    enu = stations(config["array"])
    i, j = np.triu_indices(len(enu), 1)
    east, north, up = (enu[j] - enu[i]).T
    lat = math.radians(config["array"]["latitude_deg"])
    dec = math.radians(params["dec_deg"])
    # Equatorial baseline components.
    x = -math.sin(lat) * north + math.cos(lat) * up
    y = east
    z = math.cos(lat) * north + math.sin(lat) * up
    out = []
    for d in range(dumps):
        ha = (params["hour_angle_h"] * math.pi / 12
              + d * config["dump_s"] * SIDEREAL_RAD_S)
        sh, ch = math.sin(ha), math.cos(ha)
        sd, cd = math.sin(dec), math.cos(dec)
        out.append(np.stack([sh * x + ch * y,
                             -sd * ch * x + sd * sh * y + cd * z,
                             cd * ch * x - cd * sh * y + sd * z], axis=1))
    return torch.as_tensor(np.concatenate(out), dtype=torch.float64,
                           device=device)


def vis(seed: int, shape, params: dict, device,
        index: int = 0) -> torch.Tensor:
    """complex64 visibilities [*shape], real and imaginary parts normal
    with ``params["sigma"]``."""
    gen = generator(seed + index * 7919, "vis", device)
    parts = torch.randn((*shape, 2), generator=gen, dtype=torch.float32,
                        device=device) * params["sigma"]
    return torch.view_as_complex(parts)


def skies(seed: int, config: dict, params: dict, device) -> torch.Tensor:
    """``params["count"]`` model images [count, N, N] float32."""
    n = config["image_size"]
    scale = n / params["base_size"]
    count = params["count"]
    gen = generator(seed, "sky", device)
    shifts = torch.randint(-params["shift_px"], params["shift_px"] + 1,
                           (count, 2), generator=gen, device=device)
    shifts = (shifts.to(torch.float64) * scale).round().to(torch.int64)
    shifts = shifts.cpu().tolist()
    x = torch.arange(n, dtype=torch.float64, device=device)
    g = params["gaussian"]
    sigma = g["sigma_px"] * scale
    radius = g["radius_px"] * scale
    out = torch.zeros((count, n, n), dtype=torch.float32, device=device)
    for i, (dx, dy) in enumerate(shifts):
        cx = g["center"][0] * scale + dx
        cy = g["center"][1] * scale + dy
        r2 = (x[:, None] - cx) ** 2 + (x[None, :] - cy) ** 2
        gauss = g["amplitude"] * torch.exp(-r2 / (2 * sigma * sigma))
        img = torch.where(r2 <= radius * radius, gauss, 0.0)
        for px, py, flux in params["points"]:
            img[int(round(px * scale)) + dx, int(round(py * scale)) + dy] \
                += flux
        out[i] = img.to(torch.float32)
    return out


def check_pixels(seed: int, config: dict, params: dict, device):
    """Seeded pixel indices ``(il, im)`` [P] int64 inside the central box
    of ``box_fraction`` of the image on each axis, where the
    PSWF-corrected image is well conditioned."""
    n = config["image_size"]
    half = int(params["box_fraction"] * n / 2)
    gen = generator(seed, "check", device)
    idx = torch.randint(n // 2 - half, n // 2 + half,
                        (2, params["pixels"]), generator=gen, device=device)
    return idx[0], idx[1]


def check_choice(seed: int, population: int, count: int, device,
                 salt: int = 0) -> torch.Tensor:
    """``count`` distinct seeded indices of ``range(population)``."""
    gen = generator(seed + salt * 104729, "check", device)
    count = min(count, population)
    return torch.randperm(population, generator=gen,
                          device=device)[:count]
