"""Glover hemodynamic-response-function (HRF) weights, numpy and scipy only.

Counterpart of ``phantom_vlb_tpu/data/hrf.py`` (:37-161), the same
arithmetic in the same order, so every weight is bit-equal to the JAX
package's. A stimulus token's weight is the value at ``t = time_diff`` of a
Glover-HRF-convolved boxcar event (onset 0, duration 1 s, amplitude 1), as
nilearn's ``compute_regressor`` computes it (``_gamma_difference_hrf`` /
``_sample_condition`` / ``_resample_regressor``). The builder asks for few
distinct ``time_diff`` values (7 per geometry for vision, a word-onset grid
for language), so :func:`get_hrf_weight` is cached per value.
"""

from __future__ import annotations

import functools

import numpy as np

__all__ = [
    "glover_hrf",
    "compute_glover_regressor",
    "get_hrf_weight",
    "get_hrf_weights",
]

# Glover (1999) double-gamma parameters as fixed by nilearn's ``glover_hrf``.
_GLOVER = dict(delay=6.0, undershoot=12.0, dispersion=0.9, u_dispersion=0.9, ratio=0.35)


def glover_hrf(
    tr: float,
    oversampling: int = 50,
    time_length: float = 32.0,
    onset: float = 0.0,
) -> np.ndarray:
    """Sampled Glover HRF kernel, identical to nilearn ``glover_hrf``.

    The kernel is sampled at ``dt = tr / oversampling`` over ``time_length``
    seconds and normalized to unit sum. scipy is imported here (~70 MB of
    host memory), not where the module is imported.
    """
    from scipy.stats import gamma as _gamma_dist

    delay = _GLOVER["delay"]
    undershoot = _GLOVER["undershoot"]
    dispersion = _GLOVER["dispersion"]
    u_dispersion = _GLOVER["u_dispersion"]
    ratio = _GLOVER["ratio"]

    dt = tr / oversampling
    time_stamps = np.linspace(
        0, time_length, np.rint(float(time_length) / dt).astype(int)
    )
    time_stamps -= onset

    peak_gamma = _gamma_dist.pdf(time_stamps, delay / dispersion, loc=dt, scale=dispersion)
    undershoot_gamma = _gamma_dist.pdf(
        time_stamps, undershoot / u_dispersion, loc=dt, scale=u_dispersion
    )
    hrf = peak_gamma - ratio * undershoot_gamma
    hrf /= hrf.sum()
    return hrf


def _sample_condition(
    exp_condition,
    frame_times: np.ndarray,
    oversampling: int = 50,
    min_onset: float = -24.0,
):
    """High-resolution event regressor (nilearn ``_sample_condition``)."""
    n = frame_times.size
    min_onset = float(min_onset)
    n_hr = (
        (n - 1)
        * 1.0
        / (frame_times.max() - frame_times.min())
        * (frame_times.max() * (1 + 1.0 / (n - 1)) - frame_times.min() - min_onset)
        * oversampling
    ) + 1
    hr_frame_times = np.linspace(
        frame_times.min() + min_onset,
        frame_times.max() * (1 + 1.0 / (n - 1)),
        np.rint(n_hr).astype(int),
    )

    onsets, durations, values = tuple(map(np.asanyarray, exp_condition))

    tmax = len(hr_frame_times)
    regressor = np.zeros_like(hr_frame_times).astype(np.float64)
    t_onset = np.minimum(np.searchsorted(hr_frame_times, onsets), tmax - 1)
    for t, v in zip(t_onset, values):
        regressor[t] += v
    t_offset = np.minimum(np.searchsorted(hr_frame_times, onsets + durations), tmax - 1)
    for i, t in enumerate(t_offset):
        if t < (tmax - 1) and t == t_onset[i]:
            t_offset[i] += 1
    regressor[t_offset] -= values
    regressor = np.cumsum(regressor)

    return regressor, hr_frame_times


def compute_glover_regressor(
    frame_times: np.ndarray,
    onset: float = 0.0,
    duration: float = 1.0,
    amplitude: float = 1.0,
    oversampling: int = 50,
    min_onset: float = -24.0,
) -> np.ndarray:
    """Glover-convolved event regressor sampled at ``frame_times``.

    Equivalent to nilearn ``compute_regressor(exp_condition, 'glover',
    frame_times)`` with a single condition; the single-regressor
    orthogonalization step is an identity and therefore omitted.
    """
    frame_times = np.asarray(frame_times, dtype=np.float64)
    exp_condition = (
        np.array([onset], dtype=np.float64),
        np.array([duration], dtype=np.float64),
        np.array([amplitude], dtype=np.float64),
    )
    # nilearn: tr inferred from the frame grid.
    tr = float(frame_times.max()) / (np.size(frame_times) - 1)
    hr_regressor, hr_frame_times = _sample_condition(
        exp_condition, frame_times, oversampling, min_onset
    )
    hkernel = glover_hrf(tr, oversampling)
    # Linear resampling at frame_times (nilearn uses scipy interp1d linear)
    # of ``np.convolve(hr_regressor, hkernel)[: hr_regressor.size]``. The
    # interpolation reads the convolution at the two grid points around
    # each frame time only, so only those entries are computed, each by the
    # dot product np.convolve computes for it (:func:`_convolve_at`): a
    # weight at a small ``time_diff`` convolves ~24k points with a ~32k-point
    # kernel, tens of thousands of BLAS dots, which stall when the
    # machine's cores are busy.
    out = np.empty_like(frame_times)
    last = hr_frame_times.size - 1
    for k, t in enumerate(frame_times):
        j = int(np.searchsorted(hr_frame_times, t, side="right")) - 1
        window = [min(max(j, 0), last), min(max(j + 1, 0), last)]
        conv = [_convolve_at(hr_regressor, hkernel, i) for i in window]
        out[k] = np.interp(t, hr_frame_times[window], conv)
    return out


def _convolve_at(a: np.ndarray, v: np.ndarray, i: int) -> float:
    """``np.convolve(a, v)[i]``, by the same dot product: numpy convolves
    the longer array with the shorter one reversed, and its full-mode
    entry i is the dot of their overlap there (``_pyarray_correlate``)."""
    if v.size > a.size:
        a, v = v, a
    vr = v[::-1].copy()
    n2 = vr.size
    lo = max(0, i - (n2 - 1))
    hi = min(a.size, i + 1)
    return float(np.dot(a[lo:hi], vr[n2 - 1 - (i - lo): n2 - 1 - (i - lo) + (hi - lo)]))


@functools.lru_cache(maxsize=65536)
def _hrf_weight_cached(time_diff: float) -> float:
    reg = compute_glover_regressor(np.array([0.0, time_diff]))
    return float(reg[-1])


def get_hrf_weight(time_diff: float) -> float:
    """HRF weight of a stimulus ``time_diff`` seconds before the target TR.

    Parity contract with reference ``get_hrf_weight`` (src/utils.py:14-37):
    value at ``t = time_diff`` of a unit boxcar event at t=0 (duration 1 s)
    convolved with the Glover HRF, where the convolution grid resolution is
    ``time_diff / 50`` (nilearn infers ``tr`` from the 2-point frame grid
    ``[0, time_diff]``).
    """
    return _hrf_weight_cached(round(float(time_diff), 12))


def get_hrf_weights(time_diffs: np.ndarray) -> np.ndarray:
    """Vectorized batch variant of :func:`get_hrf_weight` (cached per value)."""
    flat = np.asarray(time_diffs, dtype=np.float64).reshape(-1)
    out = np.array([get_hrf_weight(t) for t in flat], dtype=np.float64)
    return out.reshape(np.shape(time_diffs))
