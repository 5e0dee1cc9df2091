"""Step kind ``stream_ingest``: chunk after chunk through
``StreamingGridder.accumulate``, an observation finalised every
``chunks_per_observation`` chunks.

Set-up: a pool of seeded chunks (uvw and visibilities on the device),
``plan_wstack`` over the pool's uvw, the union of ``stream_tasks`` of
each chunk, ``plan_stream``; one gridder warmed through accumulate and
finalize. Step ``i``: ``accumulate`` of pool chunk ``i % K``; after an
observation's last chunk the step also calls ``finalize()`` (one host
readback and the count cross-check, which users pay for) and starts the
next observation with a new gridder on the same plan (its engine is
cached). After the window the open observation is finalised too.

Judged: every finalised image at seeded pixels of the well-conditioned
box, against the reference's dirty image of the chunks it took, each
counted as often as it was taken. ``finalize`` raising (chunks voided or
visibilities dropped) fails the run.
"""

import numpy as np
import torch

from ska_sdp_func_torch.parallel.streaming import (
    StreamingGridder,
    plan_stream,
    stream_tasks,
)
from ska_sdp_func_torch.parallel.wstack import plan_wstack
from ska_sdp_func_torch.utility.errors import SdpRuntimeError

from .. import reference as ref
from .. import generator as gen
from ._base import BaseCell, Phases, chunk_pool, plan_wstack_args, sync


def stream_plan(cfg, uvw_pool):
    """``plan_wstack`` over the pool, the union of each chunk's
    ``stream_tasks``, and ``plan_stream`` (host)."""
    host = uvw_pool.cpu().numpy()
    wplan = plan_wstack(host.reshape(-1, 3), **plan_wstack_args(cfg))
    boxes = np.unique(np.concatenate(
        [stream_tasks(wplan, chunk) for chunk in host]), axis=0)
    return plan_stream(wplan, boxes, chunk_rows=cfg["chunk_rows"],
                       block_v=cfg["block_v"], cap_factor=cfg["cap_factor"])


def stream_kernels(cell, grid: bool):
    """Shapes of the stream cells' kernel launches (one a chunk)."""
    sp, cfg = cell.splan, cell.config
    vis = cfg["chunk_rows"] * cfg["num_chan"]
    stack = len(sp.tasks) * sp.num_layers * cfg["subgrid_size"] ** 2
    mode = "bf16" if cell.fast else cfg["precision"]
    common = dict(vis=vis, rows=cfg["chunk_rows"], stack=stack, mode=mode,
                  support=cfg["support"], w_support=cfg["w_support"])
    out = {"K5": dict(common, kind="place", values=grid,
                      name="place_stream_kernel")}
    if grid:
        out["K3"] = dict(common, kind="grid", name="window_scatter_kernel")
    else:
        out["K4"] = dict(common, kind="degrid", name="window_gather_kernel")
    return out


def describe_stream(cell) -> str:
    sp = cell.splan
    return (f"stream plan: {len(sp.tasks)} tasks, {sp.num_layers} layers, "
            f"cap {sp.cap} slots in {sp.num_blocks} blocks of {sp.block_v}, "
            f"{cell.config['chunk_rows'] * cell.config['num_chan']} "
            f"visibilities a chunk, pool of {cell.uvw.shape[0]} chunks")


class Cell(BaseCell):
    def __init__(self, config, traffic, seed, device, fast=False):
        super().__init__(config, traffic, seed, device, fast)
        self.vis_per_step = config["chunk_rows"] * config["num_chan"]
        self.per_obs = traffic["chunks_per_observation"]

    def setup(self):
        cfg, tr, dev = self.config, self.traffic, self.device
        self.phases = ph = Phases()
        self.uvw, self.vis = chunk_pool(self.seed, cfg, tr, dev)
        sync(dev)
        ph.mark("inputs")
        self.splan = stream_plan(cfg, self.uvw)
        ph.mark("plans")
        # Warm every shape: accumulate, finalize, a fresh gridder.
        g = StreamingGridder(self.splan, fast=self.fast, device=dev)
        for k in range(2):
            g.accumulate(self.uvw[k], self.vis[k])
        g.finalize()
        sync(dev)
        ph.mark("warm-up")
        self.finished = []                    # (image, chunk counts)
        self.failures = []
        self._open()

    def _open(self):
        self.gridder = StreamingGridder(self.splan, fast=self.fast,
                                        device=self.device)
        self.taken = np.zeros(self.uvw.shape[0], np.int64)

    def _close(self):
        try:
            image = self.gridder.finalize()
        except SdpRuntimeError as exc:
            self.failures.append(str(exc))
            image = None
        self.finished.append((image, self.taken))
        self._open()

    def step(self, i):
        k = i % self.uvw.shape[0]
        self.gridder.accumulate(self.uvw[k], self.vis[k])
        self.taken[k] += 1
        if self.taken.sum() == self.per_obs:
            self._close()

    def kernels(self):
        return stream_kernels(self, grid=True)

    def after_window(self):
        if self.taken.sum():
            self._close()
        self.notes.append(f"observations finalised: {len(self.finished)} "
                          f"({self.per_obs} chunks each, the last "
                          f"{int(self.finished[-1][1].sum())})")

    def free(self):
        del self.gridder

    def check(self):
        cfg, tr = self.config, self.traffic
        freqs = ref.frequencies(cfg, self.device)
        il, im = gen.check_pixels(self.seed, cfg, tr["check"], self.device)
        # The dirty image of each pool chunk once, then each observation
        # as the sum of the chunks it took.
        per_chunk = torch.stack([
            ref.dirty(self.uvw[k], freqs, self.vis[k], il, im,
                      cfg["image_size"], cfg["theta"])
            for k in range(self.uvw.shape[0])])
        worst = 0.0
        for n, (image, taken) in enumerate(self.finished):
            if image is None:
                worst = float("inf")
                continue
            want = torch.as_tensor(taken, dtype=torch.float64,
                                   device=self.device) @ per_chunk
            err = ref.relative_error(image[il, im], want)
            worst = max(worst, err)
            if n < 3 or n == len(self.finished) - 1:
                self.notes.append(f"observation {n}: image_err {err:.6e}")
        for msg in self.failures:
            self.notes.append(f"finalize raised: {msg}")
        if not self.finished:
            worst = float("nan")
        return [("image_err", worst, tr["limits"]["image_err"])]

    def describe(self) -> str:
        return describe_stream(self)
