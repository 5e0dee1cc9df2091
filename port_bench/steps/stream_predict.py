"""Step kind ``stream_predict``: the selfcal predict, chunk after chunk
through ``StreamingDegridder.predict``, against a model set once per
observation of ``chunks_per_observation`` chunks.

Set-up: the pool of seeded chunks' uvw (no visibilities), the stream plan
as ``stream_ingest`` makes it, the model images, one degridder with the
first model set and warmed. Step ``i``: at an observation's first chunk
(after the first) ``set_model`` of the next model; then ``predict`` of
pool chunk ``i % K``.

Judged: the last prediction of each pool chunk, at a seeded sample of
``check.visibilities`` visibilities of each, against the reference's
prediction of the model it was made with. ``check()`` of the degridder
raising (chunks voided or visibilities dropped) fails the run.
"""

from ska_sdp_func_torch.parallel.streaming import StreamingDegridder
from ska_sdp_func_torch.utility.errors import SdpRuntimeError

from .. import reference as ref
from .. import generator as gen
from ._base import BaseCell, Phases, chunk_pool, sync
from .stream_ingest import describe_stream, stream_kernels, stream_plan


class Cell(BaseCell):
    def __init__(self, config, traffic, seed, device, fast=False):
        super().__init__(config, traffic, seed, device, fast)
        self.vis_per_step = config["chunk_rows"] * config["num_chan"]
        self.per_obs = traffic["chunks_per_observation"]

    def setup(self):
        cfg, tr, dev = self.config, self.traffic, self.device
        self.phases = ph = Phases()
        self.uvw, _ = chunk_pool(self.seed, cfg, dict(tr, with_vis=False),
                                 dev)
        self.models = gen.skies(self.seed, cfg, tr["sky"], dev)
        sync(dev)
        ph.mark("inputs")
        self.splan = stream_plan(cfg, self.uvw)
        ph.mark("plans")
        self.degridder = StreamingDegridder(self.splan, fast=self.fast,
                                            device=dev)
        self.degridder.set_model(self.models[1 % self.models.shape[0]])
        for k in range(2):
            self.degridder.predict(self.uvw[k])
        self.degridder.set_model(self.models[0])
        sync(dev)
        self.degridder.check()
        ph.mark("warm-up")
        self.model_of = 0
        self.held = {}                  # chunk -> (prediction, model)
        self.failures = []

    def step(self, i):
        k = i % self.uvw.shape[0]
        if i and i % self.per_obs == 0:
            self.model_of = (i // self.per_obs) % self.models.shape[0]
            self.degridder.set_model(self.models[self.model_of])
        self.held[k] = (self.degridder.predict(self.uvw[k]), self.model_of)

    def kernels(self):
        return stream_kernels(self, grid=False)

    def after_window(self):
        try:
            self.degridder.check()
        except SdpRuntimeError as exc:
            self.failures.append(str(exc))

    def free(self):
        del self.degridder

    def check(self):
        cfg, tr = self.config, self.traffic
        freqs = ref.frequencies(cfg, self.device)
        chans = cfg["num_chan"]
        worst = 0.0
        for k in sorted(self.held):
            got, m = self.held[k]
            pick = gen.check_choice(self.seed, got.numel(),
                                    tr["check"]["visibilities"],
                                    self.device, salt=k + 1)
            want = ref.predict_at(self.uvw[k][pick // chans],
                                  freqs[pick % chans], self.models[m],
                                  cfg["theta"])
            err = ref.relative_error(got.reshape(-1)[pick], want)
            self.notes.append(f"chunk {k} (model {m}): predict_err "
                              f"{err:.6e}")
            worst = max(worst, err)
        for msg in self.failures:
            self.notes.append(f"check raised: {msg}")
            worst = float("inf")
        if not self.held:
            worst = float("nan")
        return [("predict_err", worst, tr["limits"]["predict_err"])]

    def describe(self) -> str:
        return describe_stream(self)
