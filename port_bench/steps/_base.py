"""What the step kinds share: the base of their ``Cell``, the
w-stacking plan of a configuration and a pool of seeded chunks.

A step kind is a module ``steps/<kind>.py`` with a class ``Cell``
(a :class:`BaseCell`):

- ``setup()``: inputs, plans, the program's objects, warm-up of every
  shape the cell's steps use, its phases timed in ``phases``;
- ``step(i)``: enqueue step ``i`` (the harness synchronises);
- ``vis_per_step``: visibilities gridded plus degridded in a step;
- ``kernels()``: per kernel, the problem's shapes its launches work on
  (the metrics count operations and bytes from them);
- ``after_window()``: what a user does once the stream ends (outside
  the window); ``spans()``: the program's own stage reports (traced runs);
- ``collect()``: the outputs to judge, taken from the program's state;
  ``free()``: drop the program's state;
- ``check()``: ``[(name, value, limit), ...]`` against the reference,
  and ``notes``: lines for standard error.
"""

import time

import torch

from .. import generator as gen


class Phases:
    """Host-clock seconds of the named phases of a set-up."""

    def __init__(self):
        self.t = time.perf_counter()
        self.items = []

    def mark(self, name: str) -> None:
        now = time.perf_counter()
        self.items.append((name, now - self.t))
        self.t = now

    def line(self) -> str:
        return "set-up phases (s): " + ", ".join(
            f"{n} {sec:.3f}" for n, sec in self.items)


class BaseCell:
    """A cell's state and the steps that need nothing of their own."""

    def __init__(self, config, traffic, seed, device, fast=False):
        self.config, self.traffic = config, traffic
        self.seed, self.device, self.fast = seed, device, fast
        self.notes = []

    def after_window(self):
        pass

    def spans(self):
        return {}

    def collect(self):
        pass


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def plan_wstack_args(config: dict) -> dict:
    """Keyword arguments of the port's ``plan_wstack`` beyond uvw."""
    return dict(
        freq0_hz=config["freq0_hz"], dfreq_hz=config["dfreq_hz"],
        num_chan=config["num_chan"], image_size=config["image_size"],
        subgrid_size=config["subgrid_size"], theta=config["theta"],
        w_step=config["w_step"], support=config["support"],
        oversampling=config["oversampling"],
        w_support=config["w_support"],
        w_oversampling=config["w_oversampling"],
        subgrid_frac=config["subgrid_frac"],
        w_tower_height=config["w_tower_height"])


def dumps(config: dict, rows: int) -> int:
    """Correlator dumps in ``rows`` rows of the configuration's array."""
    per = gen.baselines(config)
    if rows % per:
        raise ValueError(f"{rows} rows are not whole dumps of {per} "
                         "baselines")
    return rows // per


def chunk_pool(seed: int, config: dict, params: dict, device):
    """``params["pool_chunks"]`` chunks of consecutive dumps: uvw
    [K, R, 3] float64 and vis [K, R, C] complex64 (``with_vis``), the
    visibilities one seeded draw per chunk."""
    rows, chans = config["chunk_rows"], config["num_chan"]
    count = params["pool_chunks"]
    per = dumps(config, rows)
    uvw = gen.uvw(config, params["uvw"], count * per,
                  device).reshape(count, rows, 3)
    vis = None
    if params.get("with_vis", True):
        vis = torch.stack([gen.vis(seed, (rows, chans), params["vis"],
                                   device, index=k) for k in range(count)])
    return uvw, vis
