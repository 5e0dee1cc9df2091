"""Stage sweep of the streaming tap preparation (K6/K7): which stage costs
the time?

Counterpart of experiments/exp_prep.py: :func:`..kernels.prep_variants.
prep_variant` in its five modes (full, novband, vbonly, vbnochb, ubonly)
over the experiment's CAP = 5,872,640 slots (S 8, Sw 4, oversampling
16384 in u, v and w, seed 3). Every mode writes all three outputs (zeros
where it skips a stage), so the modes move nearly the same bytes and
differ in compute and store pattern. Each mode is held bit for bit
against its plain version and timed by CUDA events, the input ``u_frac``
chained from the outputs as the experiment chains it.

    python -m ska_sdp_func_torch.experiments.exp_prep [--check]
"""

import numpy as np
import torch

from ..grid_data.wtower import _tap_coeffs_cached
from ..kernels import prep_variants
from ..utility.tensors import resolve_device
from ._common import bound, card_name, chained_ms, main, nbytes

NAME = "exp_prep"
PREP_G = 1024
CAP = 5_872_640 // PREP_G * PREP_G
CHECK_CAP = 2 * PREP_G
S, SW = prep_variants.SUPPORT, prep_variants.W_SUPPORT
OV = WOV = 16 * 1024
# The modes in the experiment's order.
MODES = ("ubonly", "novband", "vbnochb", "vbonly", "full")
# Inputs each mode reads.
_READS = {"full": ("u_off", "u_frac", "w_row", "vre", "vim", "iv0",
                   "v_frac"),
          "novband": ("u_off", "u_frac", "w_row", "vre", "vim"),
          "vbonly": ("iv0", "v_frac"), "vbnochb": ("iv0", "v_frac"),
          "ubonly": ("u_off", "u_frac")}
_FIELDS = ("u_off", "u_frac", "w_row", "vre", "vim", "iv0", "v_frac")


def operands(device="cuda", check: bool = False) -> dict:
    cap = CHECK_CAP if check else CAP
    dev = resolve_device(device)
    rng = np.random.default_rng(3)
    ints = lambda hi: rng.integers(0, hi, cap).astype(np.int32)  # noqa: E731
    u_off, u_frac, v_frac, w_row, iv0 = (ints(8), ints(OV), ints(OV),
                                         ints(WOV), ints(120))
    vre = rng.standard_normal(cap).astype(np.float32)
    vim = rng.standard_normal(cap).astype(np.float32)
    put = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    ops = dict(u_off=put(u_off), u_frac=put(u_frac), w_row=put(w_row),
               vre=put(vre), vim=put(vim), iv0=put(iv0), v_frac=put(v_frac))
    ops["uv_coeffs"] = put(np.asarray(_tap_coeffs_cached(S, OV), np.float32))
    ops["w_coeffs"] = put(np.asarray(_tap_coeffs_cached(SW, WOV),
                                     np.float32))
    return ops


def _args(ops):
    return tuple(ops[f] for f in _FIELDS) + (ops["uv_coeffs"],
                                              ops["w_coeffs"], OV, WOV)


def launch(ops) -> dict:
    """One launch a mode."""
    return {mode: prep_variants.prep_variant(mode, *_args(ops))
            for mode in MODES}


def _ops_count(mode: str, cap: int, ncoef: int) -> int:
    """f32 operations: a Clenshaw evaluation is 3 a term and 3 for x; the
    scale rows one product each."""
    do_ub, do_sc, do_vb = prep_variants.stages(mode)
    cheb = 3 * (ncoef - 1) + 3
    taps = S * do_ub + SW * do_sc + S * (mode == "full" or mode == "vbonly")
    return cap * (taps * cheb + 2 * SW * do_sc)


def measure(ops, outs) -> list:
    """Each mode against its plain version, bit for bit; on the card, its
    time (20 chained calls) and the plain version's."""
    cap = ops["u_off"].shape[0]
    ncoef = ops["uv_coeffs"].shape[0]
    rows = []
    for mode in MODES:
        got = outs[mode]
        want = prep_variants.prep_variant_reference(mode, *_args(ops))
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise RuntimeError(f"prep_variant {mode} differs from its plain "
                               f"version")
        moved = nbytes(*(ops[f] for f in _READS[mode]), *got)
        row = dict(variant=mode, max_abs_err=0.0, rel_err=0.0, bytes=moved,
                   slots=cap)
        row["bound_ms"], row["bound_by"] = bound(
            moved, _ops_count(mode, cap, ncoef))
        if ops["u_off"].device.type == "cuda":
            del want
            fed = ops["u_frac"] if mode != "vbonly" and mode != "vbnochb" \
                else ops["v_frac"]

            def feed(out):
                fed[:1].add_((out[1][0, :1] * 0).to(torch.int32))

            row["ms"] = chained_ms(
                lambda: prep_variants.prep_variant(mode, *_args(ops)), feed,
                20)
            row["plain_ms"] = chained_ms(
                lambda: prep_variants.prep_variant_reference(mode,
                                                             *_args(ops)),
                feed, 2, warmup=1)
        rows.append(row)
        outs[mode] = None
    return rows


def run(device="cuda", check: bool = False) -> dict:
    ops = operands(device, check)
    rows = measure(ops, launch(ops))
    return dict(experiment=NAME, device=card_name(ops["u_off"].device),
                rows=rows)


if __name__ == "__main__":
    main(run, __doc__)
