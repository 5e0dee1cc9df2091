"""Step kind ``packed_cycle``: one major cycle's operator pair on one
packed plan, in the sorted stream.

Set-up: uvw and visibilities from the seed, ``plan_wstack`` ->
``plan_packed`` -> ``PackedGridder``, the visibilities sorted once, the
model images. Step ``i``: ``pred = degrid_sorted(model[i % M])``, the
residual ``vis - pred``, ``grid_sorted(residual)``. The harness
synchronises after it.

Judged: the last prediction and residual image of each model, for a
seeded choice of ``check.outputs`` models. The prediction against the
reference's prediction of the model at every visibility
(``degrid_err``); the residual image at seeded pixels of the
well-conditioned box against the reference's dirty image of the
residual it makes from its own prediction (``grid_err``: nothing the
program made).
"""

import numpy as np
import torch

from ska_sdp_func_torch.parallel.packed import PackedGridder, plan_packed
from ska_sdp_func_torch.parallel.wstack import plan_wstack

from .. import reference as ref
from .. import generator as gen
from ._base import BaseCell, Phases, dumps, plan_wstack_args, sync


class Cell(BaseCell):
    def __init__(self, config, traffic, seed, device, fast=False):
        super().__init__(config, traffic, seed, device, fast)
        self.vis_per_step = 2 * config["rows"] * config["num_chan"]
        self._held = {}

    def setup(self):
        cfg, tr, dev = self.config, self.traffic, self.device
        self.phases = ph = Phases()
        rows = cfg["rows"]
        self.uvw = gen.uvw(cfg, tr["uvw"], dumps(cfg, rows), dev)
        self.vis = gen.vis(self.seed, (rows, cfg["num_chan"]), tr["vis"],
                           dev)
        self.models = gen.skies(self.seed, cfg, tr["sky"], dev)
        uvw_host = self.uvw.cpu().numpy()
        ph.mark("inputs")
        wplan = plan_wstack(uvw_host, **plan_wstack_args(cfg))
        self.pplan = plan_packed(wplan, uvw_host)
        ph.mark("plans")
        precision = None if self.fast else cfg["precision"]
        self.gridder = PackedGridder(self.pplan, fast=self.fast,
                                     precision=precision, device=dev)
        self.vre, self.vim = self.gridder.sort(self.vis)
        sync(dev)
        ph.mark("gridder and sort")
        for i in range(2):                     # every shape, twice
            self.step(i)
        sync(dev)
        ph.mark("warm-up")
        self._held.clear()

    def step(self, i):
        g = self.gridder
        m = i % self.models.shape[0]
        pred = g.degrid_sorted(self.models[m])
        image = g.grid_sorted(self.vre - pred.real, self.vim - pred.imag)
        self._held[m] = (pred, image)

    def kernels(self):
        p, cfg = self.pplan, self.config
        vis = cfg["rows"] * cfg["num_chan"]
        stack = len(p.tasks) * p.num_layers * cfg["subgrid_size"] ** 2
        mode = "bf16" if self.fast else cfg["precision"]
        common = dict(vis=vis, rows=cfg["rows"], stack=stack, mode=mode,
                      support=cfg["support"], w_support=cfg["w_support"])
        return {"K1": dict(common, kind="grid", name="grid_runs_kernel"),
                "K2": dict(common, kind="degrid",
                           name="degrid_runs_kernel")}

    def spans(self):
        g = self.gridder
        return {"grid": g.report_timing(self.vre, self.vim, iters=10,
                                        print_fn=None),
                "degrid": g.report_timing_degrid(self.models[0], iters=10,
                                                 print_fn=None)}

    def collect(self):
        keys = sorted(self._held)
        pick = gen.check_choice(self.seed, len(keys),
                                self.traffic["check"]["outputs"],
                                self.device).cpu().tolist()
        self._judged = {}
        for j in sorted(pick):
            m = keys[j]
            pred, image = self._held[m]
            # The program's natural-order view of its sorted prediction.
            self._judged[m] = (self.gridder.unsort(pred), image)

    def free(self):
        self._held.clear()
        del self.gridder, self.vre, self.vim

    def check(self):
        cfg, tr = self.config, self.traffic
        limits = tr["limits"]
        freqs = ref.frequencies(cfg, self.device)
        il, im = gen.check_pixels(self.seed, cfg, tr["check"], self.device)
        vis = self.vis.to(torch.complex128)
        worst = dict.fromkeys(limits, 0.0)
        for m, (pred, image) in self._judged.items():
            want = ref.predict(self.uvw, freqs, self.models[m], cfg["theta"])
            derr = ref.relative_error(pred, want)
            # The grid judged on the residual the reference makes from
            # its own prediction: nothing the program made. The model
            # lies below the noise, so the degrid's error gridded back
            # stays under the grid's own.
            own = ref.dirty(self.uvw, freqs, vis - want, il, im,
                            cfg["image_size"], cfg["theta"])
            del want
            gerr = ref.relative_error(image[il, im], own)
            self.notes.append(f"model {m}: degrid_err {derr:.6e}, "
                              f"grid_err {gerr:.6e}")
            worst["degrid_err"] = max(worst["degrid_err"], derr)
            worst["grid_err"] = max(worst["grid_err"], gerr)
        if not self._judged:
            worst = {k: float("nan") for k in worst}
        return [(k, v, limits[k]) for k, v in worst.items()]

    def describe(self) -> str:
        p = self.pplan
        return (f"packed plan: {len(p.tasks)} tasks, {p.num_layers} layers, "
                f"{p.total} slots in {p.num_blocks} blocks of "
                f"{p.block_v}, "
                f"{int(np.count_nonzero(p.arrays['valid']))} visibilities")
