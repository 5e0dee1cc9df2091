"""Operations and bytes of a kernel's launch, counted from the problem's
shapes alone, and its least time on the published peaks
(``peaks.json``).

What counts, whatever the kernel reads or writes to get there:

- each visibility's value (complex64, 8 B) read once where it is
  gridded or placed, and written once where it is predicted;
- its position: its row's ``(u, v, w)`` (3 x f32) read once a row;
- the plan's sub-grid layer stack (tasks x layers x subgrid^2 complex64)
  written once by a grid kernel and read once by a degrid kernel;
- ``support^2 x w_support`` complex multiply-adds (8 flops each) per
  visibility gridded or degridded, on the unit the precision mode uses
  (``peaks.json`` ``modes``: "high" is three bf16 passes, so a third of
  the bf16 peak).

Nothing is counted from the kernel's argument tensors (padded slots,
band tables, plan words), so a redesign of the same kernel is counted
for the same work. A placement moves no problem bytes but the values it
places: its share shows how much of its traffic the problem needs.
"""

import json
import os

_PEAKS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "peaks.json")
VALUE_BYTES = 8
POSITION_BYTES = 12
CELL_BYTES = 8
FLOPS_PER_CMAC = 8


def peaks() -> dict:
    with open(_PEAKS) as f:
        return json.load(f)


def work(k: dict):
    """(flops, bytes) of one launch with shapes ``k``."""
    positions = k["rows"] * POSITION_BYTES
    values = k["vis"] * VALUE_BYTES
    if k["kind"] == "place":
        moved = 2 * values if k.get("values") else 0
        return 0.0, float(positions + moved)
    flops = (k["vis"] * k["support"] ** 2 * k["w_support"]
             * FLOPS_PER_CMAC)
    return float(flops), float(positions + values + k["stack"] * CELL_BYTES)


def least_seconds(k: dict, peak: dict = None):
    """(seconds, "operations" or "bytes"): the larger bound of one
    launch."""
    peak = peak or peaks()
    flops, nbytes = work(k)
    mode = peak["modes"][k["mode"]]
    t_ops = flops * mode["passes"] / peak["flops_per_s"][mode["unit"]]
    t_bytes = nbytes / peak["hbm_bytes_per_s"]
    return (t_ops, "operations") if t_ops > t_bytes else \
        (t_bytes, "bytes")


def share(ctx: dict, kernel: str):
    """Percent of the least time in the mean device time of the traced
    launches of ``kernel`` (None without a trace or a launch)."""
    shapes = ctx["kernels"].get(kernel)
    trace = ctx.get("trace")
    if shapes is None or trace is None:
        return None
    durations = trace.durations(shapes["name"])
    if not durations:
        return None
    least, _ = least_seconds(shapes)
    return 100.0 * least / (sum(durations) / len(durations))
