"""Cells at a size a CPU test holds: the benchmark's own files, with
sizes cut so that a run takes seconds on the CPU."""

import copy
import os

from port_bench import harness

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BENCH = os.path.join(ROOT, "BENCHMARK.json")
C_0 = 299792458.0
# 16 stations (120 baselines) out to 12 km: a core of 4 in 300 m and two
# clusters of 2 on each of three arms.
TINY_ARRAY = dict(layout_seed=1, latitude_deg=-26.8247, stations=16,
                  core_stations=4, core_radius_m=300.0,
                  station_spacing_m=40.0, arms=3, clusters_per_arm=2,
                  cluster_stations=2, cluster_radius_m=60.0,
                  arm_inner_m=1500.0, arm_outer_m=12000.0,
                  arm_winding_rad=1.6)
TINY_CONFIG = {
    "packed_low": dict(image_size=256, rows=240, num_chan=4,
                       array=TINY_ARRAY),
    # Dumps a minute apart, so that the pool's two chunks differ by more
    # than a check's limit on this short array.
    "stream_low": dict(image_size=256, chunk_rows=120, num_chan=8,
                       block_v=128, cap_factor=64.0, array=TINY_ARRAY,
                       dump_s=60.0),
}
TINY_TRAFFIC = dict(pool_chunks=2, chunks_per_observation=4,
                    trace=dict(warmup_steps=1, active_steps=2))


def tiny_spec(workload: str) -> harness.CellSpec:
    spec = harness.load_cell(BENCH, workload)
    spec.config = copy.deepcopy(spec.config)
    spec.traffic = copy.deepcopy(spec.traffic)
    spec.config.update(TINY_CONFIG[spec.config["name"]])
    for key, value in TINY_TRAFFIC.items():
        if key in spec.traffic:
            spec.traffic[key] = value
    spec.traffic["check"]["pixels"] = 64
    if "visibilities" in spec.traffic["check"]:
        spec.traffic["check"]["visibilities"] = 256
    return spec
