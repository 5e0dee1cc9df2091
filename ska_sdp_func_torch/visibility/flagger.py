"""RFI flagger ("FluctuFlagger"): dynamic-threshold flagging.

Counterpart of ska_sdp_func_tpu.visibility.flagger (reference
visibility/sdp_flagger.{h,cpp}). Per (baseline, pol), three methods over
``vis[time, baseline, chan, pol]``:

1. magnitude outliers: modified z-score ``0.6795 * (val - median) / mad``
   of |vis| against the channel-sampled median / MAD of each time step
   (sdp_flagger.cpp:171-247);
2. fluctuation outliers: z-scores of a recursive EWMA "transit score" of
   |d|vis|/dt|, flagging both t and t-1 (:251-341);
3. broadband: the z-score of the current median against a trailing window
   of median history flags the whole time step (:190-212).

Flags are dilated by ``window`` channels either side; the dilation never
writes channel 0 (the reference's `c - w - 1 > 0` bound).

Reference quirks kept, for bit-parity:

- the "median" is sorted[round(n/2)] with C's round-half-away, one above
  the true median for odd n and the UPPER middle element for even n
  (median_calc, :83-88): a sort and an index, never ``torch.median``;
- the MAD-zero sentinel: z is 0 where val == median, else 1e7;
- the fluctuation MAD is taken around the *magnitude* median, not the
  fluctuation median (:292-295);
- transit scores start afresh at t == 1 (:266-269).

Every (baseline, pol) plane is batched at once as ``[B, P, T, C]``: sorts
for the medians, the EWMA a loop over time of elementwise steps on all
planes, shifts for the dilation. Runs on ``device`` (None: the CUDA card).
"""

import torch

from ..utility.data_model import is_complex
from ..utility.errors import SdpDataTypeError, SdpShapeError
from ..utility.tensors import on_device

_ZSCORE_SCALE = 0.6795
_MAD_ZERO_SENTINEL = 10000000.0


def _c_mid(n: int) -> int:
    """int(round(0.5 * n)) with C's round-half-away."""
    return (n + 1) // 2 if n % 2 else n // 2


def _modified_zscore(median, mad, val):
    plain = _ZSCORE_SCALE * (val - median) / torch.where(mad == 0, 1.0, mad)
    sentinel = torch.where(val == median, 0.0, _MAD_ZERO_SENTINEL).to(
        plain.dtype)
    return torch.where(mad == 0, sentinel, plain)


def _median_and_mad(values, mid: int):
    """The reference's median / MAD: sorted[mid] and sorted(|x - med|)[mid]
    along the last axis."""
    median = torch.sort(values, dim=-1).values[..., mid]
    devs = torch.sort((values - median[..., None]).abs(), dim=-1).values
    return median, devs[..., mid]


def _dilate(trigger: torch.Tensor, window: int) -> torch.Tensor:
    """Flag channels within ``window`` of a trigger; channel 0 only
    triggers itself."""
    if window <= 0:
        return trigger
    out = trigger.clone()
    for d in range(1, window + 1):
        out[..., :-d] |= trigger[..., d:]
        out[..., d:] |= trigger[..., :-d]
    out[..., 0] = trigger[..., 0]
    return out


def _flag_planes(mags, alpha, threshold_magnitudes, threshold_variations,
                 threshold_broadband, sampling_step: int, window: int,
                 window_median_history: int, scores: bool = False):
    """Flags of every (baseline, pol) plane; ``mags`` is |vis| as
    ``[B, P, T, C]``. With ``scores`` also returns the z-scores each
    method compared with its threshold: ``z_mag`` [B, P, T, C], ``z_med``
    [B, P, T] (method 3, time 0 unused) and ``z_var`` [B, P, T-1, C]
    (method 2, the step from t to t+1)."""
    dt = mags.dtype
    dev = mags.device
    alpha = torch.tensor(alpha, dtype=dt, device=dev)
    thr_mag, thr_var, thr_bb = (torch.tensor(t, dtype=dt, device=dev)
                                for t in (threshold_magnitudes,
                                          threshold_variations,
                                          threshold_broadband))
    num_t, num_c = mags.shape[-2:]
    num_samples = num_c // sampling_step
    mid = _c_mid(num_samples)
    samples = mags[..., ::sampling_step][..., :num_samples]

    # Method 1: magnitude z-scores a time step.
    median, mad = _median_and_mad(samples, mid)            # [B, P, T]
    z_mag = _modified_zscore(median[..., None], mad[..., None], mags)
    trig_mag = z_mag.abs() > thr_mag

    # Method 3: broadband, against the trailing median history, padded
    # with inf where it reaches before time 0.
    hist_len = window_median_history
    t_idx = torch.arange(num_t, device=dev)
    src = t_idx[:, None] - torch.arange(hist_len, device=dev)[None, :]
    inf = torch.tensor(float("inf"), dtype=dt, device=dev)
    hist = torch.where(src >= 0, median[..., src.clamp(min=0)], inf)
    medwindow = torch.clamp(t_idx + 1, max=hist_len)       # [T]
    mid_w = torch.where(medwindow % 2 == 1, (medwindow + 1) // 2,
                        medwindow // 2).clamp(max=hist_len - 1)
    gather = mid_w[:, None].expand(hist.shape)[..., :1]
    medmed = torch.sort(hist, dim=-1).values.gather(-1, gather)
    devs = torch.sort((hist - medmed).abs(), dim=-1).values
    medmeddev = devs.gather(-1, gather)[..., 0]
    z_med = _modified_zscore(medmed[..., 0], medmeddev, median)
    situation = (z_med.abs() > thr_bb) & (t_idx != 0)

    flags = _dilate(trig_mag | situation[..., None], window)
    out = {"z_mag": z_mag, "z_med": z_med}

    # Method 2: fluctuation (EWMA transit score) z-scores.
    if num_t > 1:
        rate = (mags[..., 1:, :] - mags[..., :-1, :]).abs()  # [B, P, T-1, C]
        ts = torch.empty_like(rate)
        ts[..., 0, :] = rate[..., 0, :]
        one_minus = 1.0 - alpha
        for t in range(1, num_t - 1):
            ts[..., t, :] = alpha * rate[..., t, :] \
                + one_minus * ts[..., t - 1, :]
        ts_samples = ts[..., ::sampling_step][..., :num_samples]
        medianvar = torch.sort(ts_samples, dim=-1).values[..., mid]
        # Deviations around the *magnitude* median (reference :292-295).
        mediandevvar = torch.sort(
            (ts_samples - median[..., 1:, None]).abs(),
            dim=-1).values[..., mid]
        z_var = _modified_zscore(medianvar[..., None],
                                 mediandevvar[..., None], ts)
        trig_var = _dilate(z_var.abs() > thr_var, window)
        flags[..., 1:, :] |= trig_var                     # at t
        flags[..., :-1, :] |= trig_var                    # at t - 1
        out["z_var"] = z_var
    return (flags, out) if scores else flags


def flagger_dynamic_threshold(vis, alpha: float = 0.5,
                              threshold_magnitudes: float = 3.5,
                              threshold_variations: float = 3.5,
                              threshold_broadband: float = 3.5,
                              sampling_step: int = 1, window: int = 0,
                              window_median_history: int = 10,
                              device=None) -> torch.Tensor:
    """Run the FluctuFlagger on ``device`` (None: the CUDA card); returns
    int32 flags (1 = RFI) shaped like ``vis``
    (`sdp_flagger_dynamic_threshold`, sdp_flagger.h:53-64, the flags
    returned instead of written into a preallocated array)."""
    if vis.ndim != 4:
        raise SdpShapeError("vis must be 4D [time, baseline, chan, pol]")
    if not is_complex(vis.dtype):
        raise SdpDataTypeError("vis must be complex")
    (vis,) = on_device(vis, device=device)
    planes = vis.abs().permute(1, 3, 0, 2)                # [B, P, T, C]
    flags = _flag_planes(planes, alpha, threshold_magnitudes,
                         threshold_variations, threshold_broadband,
                         int(sampling_step), int(window),
                         int(window_median_history))
    return flags.permute(2, 0, 3, 1).to(torch.int32)
