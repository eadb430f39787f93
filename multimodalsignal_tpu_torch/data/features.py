"""Handcrafted physiological features per 60 s window (a copy of
multimodalsignal_tpu/data/features.py: the same float64 NumPy/SciPy
operations in the same order, so the features come out bitwise equal, and
the same FEATURE_NAMES and FEATURE_EXTRACTOR_VERSION, which a hybrid run's
stamp is checked against).

Parity target: reference preprocess.py:77-123 (`extract_handcrafted_features`),
which produces, per window:

  HRV_RMSSD, HRV_SDNN, HRV_LFHF, HRV_HF, HRV_SampEn   (ECG via neurokit2)
  EDA_SCR_Peaks_N, EDA_Tonic_Slope                     (EDA @16 Hz via neurokit2)
  RESP_Rate_Mean, RESP_RRV_SDNN                        (Resp via neurokit2)
  EMG_Amplitude_Mean                                   (mean |EMG|)

neurokit2 is not a dependency here; each feature is re-implemented with the
same semantics on top of scipy/numpy (documented divergence: values are not
bit-identical to neurokit2's pipelines, but names, units and failure-to-NaN
behaviour match; the reference itself fillna(0)s failures, preprocess.py:211).

Design for throughput: the reference runs one python/neurokit2 call per window
(the L1 hot loop, SURVEY.md §3.2). Here the linear DSP (bandpass filtering,
EDA downsampling/decomposition) is batched across ALL windows of a subject as
single vectorized FFT/convolution ops; only the per-window peak bookkeeping
stays in a tight host loop.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
from scipy import signal as sps
from scipy.stats import linregress

from multimodalsignal_tpu_torch.data.resample import fourier_resample_np


@lru_cache(maxsize=None)
def _butter_sos(order: int, lo: float, hi: float | None, btype: str, fs: float):
    """Cached filter design: scipy.signal.butter dominates per-window cost
    when re-designed for every window (654 designs/subject in profiling); the
    coefficients depend only on (order, cutoffs, fs)."""
    wn = lo if hi is None else (lo, hi)
    return sps.butter(order, wn, btype=btype, fs=fs, output="sos")

# Bump whenever the feature MATH changes (same input -> different values):
#   1 = linear tachogram interpolation for HRV spectra (rounds 1-4)
#   2 = PCHIP tachogram interpolation, the neurokit2 family (round 5)
# The preprocessor stamps this into the feature target's
# _preprocess_meta.json; hybrid runs embed it in config.json, and the
# deployment paths (Predictor / ExportedPredictor) refuse checkpoints whose
# cached training features came from a different extractor — otherwise
# live serving-time features silently skew against what the model learned.
FEATURE_EXTRACTOR_VERSION = 2

# Measured power recovery of the PCHIP tachogram interpolant (the estimator
# _rr_band_powers uses) for a sinusoidal RR modulation sampled by ~1.25 Hz
# beats: at ~0.1 Hz (LF band) and 0.3 Hz (HF band). Single source of truth
# for the validation fixtures — pinned by
# tests/test_features.py::test_rr_band_powers_sinusoidal_tachogram and
# consumed by benchmarks/feature_validation.py; re-measure there if the
# interpolant or Welch settings ever change.
PCHIP_POWER_RECOVERY = {"lf": 0.9941, "hf": 0.8408}

FEATURE_NAMES = (
    "HRV_RMSSD",
    "HRV_SDNN",
    "HRV_LFHF",
    "HRV_HF",
    "HRV_SampEn",
    "EDA_SCR_Peaks_N",
    "EDA_Tonic_Slope",
    "RESP_Rate_Mean",
    "RESP_RRV_SDNN",
    "EMG_Amplitude_Mean",
)

# The sensors the extractors read (reference preprocess.py:82-122); the
# offline feature target gathers exactly these (data/preprocess.py), and the
# hybrid deployment pipeline (experiments/predict.py
# recording_to_hybrid_windows, experiments/streaming.py) reads them from the
# recording grid regardless of the model's channel subset.
FEATURE_SENSOR_CHANNELS = ("chest_ECG", "chest_EDA", "chest_EMG", "chest_Resp")


# --------------------------------------------------------------------------
# ECG / HRV
# --------------------------------------------------------------------------

def detect_r_peaks(ecg: np.ndarray, fs: float, filt: np.ndarray | None = None) -> np.ndarray:
    """R-peak detection: QRS bandpass -> squared energy -> moving integration
    -> adaptive-threshold peaks (Pan-Tompkins-style).

    `filt` optionally supplies the QRS-bandpassed signal (the batch extractor
    filters all windows of a subject in one vectorized sosfiltfilt call)."""
    if filt is None:
        sos = _butter_sos(3, 5.0, 30.0, "bandpass", fs)
        filt = sps.sosfiltfilt(sos, ecg)
    energy = filt**2
    win = max(int(0.12 * fs), 1)
    integ = np.convolve(energy, np.ones(win) / win, mode="same")
    thresh = 0.35 * integ.std() + integ.mean() * 0.5
    min_dist = int(0.3 * fs)  # refractory period: max ~200 bpm
    peaks, _ = sps.find_peaks(integ, height=thresh, distance=min_dist)
    if len(peaks) == 0:
        return peaks
    # Snap each energy peak to the local ECG maximum (true R location).
    half = int(0.05 * fs)
    snapped = []
    for p in peaks:
        lo, hi = max(p - half, 0), min(p + half + 1, len(ecg))
        snapped.append(lo + int(np.argmax(ecg[lo:hi])))
    return np.unique(snapped)


def sample_entropy(x: np.ndarray, m: int = 2, r_factor: float = 0.2) -> float:
    """SampEn(m, r=0.2*std) — the HRV_SampEn convention."""
    x = np.asarray(x, dtype=np.float64)
    n = len(x)
    if n <= m + 1:
        return np.nan
    r = r_factor * np.std(x, ddof=0)
    if r == 0:
        return np.nan

    def _count(mm: int) -> int:
        templates = np.lib.stride_tricks.sliding_window_view(x, mm)
        # Chebyshev distance between all template pairs (i < j).
        d = np.max(np.abs(templates[:, None, :] - templates[None, :, :]), axis=-1)
        iu = np.triu_indices(len(templates), k=1)
        return int(np.sum(d[iu] <= r))

    b = _count(m)
    a = _count(m + 1)
    if a == 0 or b == 0:
        return np.nan
    return -np.log(a / b)


def hrv_features(ecg: np.ndarray, fs: float, filt: np.ndarray | None = None) -> dict[str, float]:
    """Time/frequency/complexity HRV metrics from one ECG window."""
    rpeaks = detect_r_peaks(np.asarray(ecg, dtype=np.float64), fs, filt=filt)
    if len(rpeaks) < 4:
        raise ValueError("too few R peaks for HRV")
    rr_ms = np.diff(rpeaks) / fs * 1000.0
    # Discard physiologically impossible intervals (artifact guard).
    rr_ms = rr_ms[(rr_ms > 300) & (rr_ms < 2000)]
    if len(rr_ms) < 3:
        raise ValueError("too few valid RR intervals")
    out = {
        "HRV_RMSSD": float(np.sqrt(np.mean(np.diff(rr_ms) ** 2))),
        "HRV_SDNN": float(np.std(rr_ms, ddof=1)),
    }
    # Frequency domain: interpolate the RR tachogram at 4 Hz, Welch PSD.
    lf, hf = _rr_band_powers(rpeaks, rr_ms, fs)
    out["HRV_HF"] = hf
    out["HRV_LFHF"] = lf / hf if hf > 0 else np.nan
    out["HRV_SampEn"] = sample_entropy(rr_ms)
    return out


def _rr_band_powers(rpeaks: np.ndarray, rr_ms: np.ndarray, fs: float) -> tuple[float, float]:
    """LF (0.04-0.15 Hz) and HF (0.15-0.4 Hz) power of the RR tachogram (ms^2).

    The beat-domain tachogram is resampled onto a uniform 4 Hz grid with
    MONOTONE CUBIC (PCHIP) interpolation — the interpolant family
    neurokit2's hrv_frequency uses — before the Welch PSD. Linear
    interpolation (the previous choice) low-passes the modulation by
    sinc^2(f*RR) in amplitude: at 0.3 Hz on a 75 bpm tachogram that is a
    ~32% HF power loss and a systematic LF/HF overestimate. PCHIP halves
    it (~16% at 0.3 Hz, ~0.6% at 0.1 Hz — measured factors pinned in
    tests/test_features.py); the residual is inherent to interpolating a
    ~1.25 Hz beat-sampled process and is shared by neurokit2's own
    estimator, whose PCHIP curve through the same beats is identical
    regardless of its denser evaluation grid (delta table:
    benchmarks/BENCHMARK.md "neurokit2-formula oracle", fixture
    benchmarks/golden/nk_hrv_oracle.json)."""
    from scipy.interpolate import PchipInterpolator

    # Times of each RR interval = time of the later beat.
    t = rpeaks[1:] / fs
    if len(t) != len(rr_ms):
        t = t[-len(rr_ms):]
    interp_fs = 4.0
    t_uniform = np.arange(t[0], t[-1], 1.0 / interp_fs)
    if len(t_uniform) < 16:
        return np.nan, np.nan
    rr_uniform = PchipInterpolator(t, rr_ms)(t_uniform)
    rr_uniform = rr_uniform - rr_uniform.mean()
    nperseg = min(len(rr_uniform), 256)
    freqs, psd = sps.welch(rr_uniform, fs=interp_fs, nperseg=nperseg)
    df = freqs[1] - freqs[0]
    lf = float(np.sum(psd[(freqs >= 0.04) & (freqs < 0.15)]) * df)
    hf = float(np.sum(psd[(freqs >= 0.15) & (freqs < 0.4)]) * df)
    return lf, hf


# --------------------------------------------------------------------------
# EDA
# --------------------------------------------------------------------------

def eda_features(eda: np.ndarray, fs: float) -> dict[str, float]:
    """SCR peak count + tonic slope from one EDA window.

    Mirrors the reference flow (preprocess.py:96-109): downsample to
    min(16, fs) Hz, split tonic/phasic, count SCR peaks, linregress the tonic.
    """
    eda = np.asarray(eda, dtype=np.float64)
    # Detrend before the Fourier resample: EDA has strong tonic drift, and
    # FFT-resampling a non-periodic window rings (Gibbs) off the wrap-around
    # discontinuity — enough to fabricate SCR peaks above the amplitude gate
    # (pinned by tests/test_features.py's linear-ramp golden test). The
    # linear trend is removed, the residual resampled, and the trend
    # re-evaluated on the new time base.
    x, target_fs = _eda_resample_detrended(eda, fs)
    # Tonic = slow component (highpass-method decomposition at 0.05 Hz,
    # the same cutoff neurokit2's default eda_phasic uses).
    sos = _butter_sos(2, 0.05, None, "lowpass", target_fs)
    tonic = sps.sosfiltfilt(sos, x)
    phasic = x - tonic
    return _eda_from_decomposed(tonic, phasic, target_fs)


def _eda_resample_detrended(eda: np.ndarray, fs: float) -> tuple[np.ndarray, float]:
    """Detrend-resample-retrend one or many EDA windows ([T] or [N, T]) to
    min(16, fs) Hz along the last axis; returns (resampled, target_fs)."""
    t_len = eda.shape[-1]
    target_fs = min(16.0, fs)
    num = int(t_len * (target_fs / fs))
    t0 = np.arange(t_len, dtype=np.float64)
    coef = np.polyfit(t0, eda.T if eda.ndim == 2 else eda, 1)
    slope0, intercept0 = coef[0], coef[1]  # scalars or [N]
    if eda.ndim == 2:
        slope0, intercept0 = slope0[:, None], intercept0[:, None]
    resid = eda - (intercept0 + slope0 * t0)
    t_new = np.arange(num, dtype=np.float64) * (t_len / max(num, 1))
    return fourier_resample_np(resid, num, axis=-1) + intercept0 + slope0 * t_new, target_fs


def _eda_from_decomposed(tonic: np.ndarray, phasic: np.ndarray, target_fs: float) -> dict[str, float]:
    """SCR count + tonic slope from one window's tonic/phasic decomposition."""
    # SCR peaks: amplitude-gated local maxima of the phasic component.
    amp_min = max(0.01, 0.05 * np.std(phasic))
    peaks, _ = sps.find_peaks(phasic, height=amp_min, distance=int(0.5 * target_fs))
    slope, *_ = linregress(np.arange(len(tonic), dtype=np.float64), tonic)
    return {"EDA_SCR_Peaks_N": float(len(peaks)), "EDA_Tonic_Slope": float(slope)}


# --------------------------------------------------------------------------
# Respiration
# --------------------------------------------------------------------------

def resp_features(resp: np.ndarray, fs: float, filt: np.ndarray | None = None) -> dict[str, float]:
    """Breath-rate mean and variability (the RSP_Rate mean/std the reference
    pulls from neurokit2's rsp_process, preprocess.py:110-117)."""
    resp = np.asarray(resp, dtype=np.float64)
    if filt is None:
        sos = _butter_sos(2, 0.05, 1.0, "bandpass", fs)
        filt = sps.sosfiltfilt(sos, resp)
    min_dist = int(fs / 0.8)  # max 48 breaths/min
    prominence = 0.2 * np.std(filt)
    peaks, _ = sps.find_peaks(filt, distance=min_dist, prominence=prominence)
    if len(peaks) < 3:
        raise ValueError("too few breaths for respiration rate")
    periods = np.diff(peaks) / fs
    rates = 60.0 / periods  # breaths/min per breath interval
    # Per-sample rate series (interpolated), matching RSP_Rate's sampling so
    # mean/std weight time, not breaths.
    t = peaks[1:] / fs
    t_all = np.arange(len(resp)) / fs
    rate_series = np.interp(t_all, t, rates)
    return {
        "RESP_Rate_Mean": float(rate_series.mean()),
        "RESP_RRV_SDNN": float(rate_series.std()),
    }


# --------------------------------------------------------------------------
# Window-level extraction
# --------------------------------------------------------------------------

def extract_handcrafted_features(window_data: dict[str, np.ndarray], fs: float) -> dict[str, float]:
    """One window's feature dict; failures produce NaN per feature group,
    matching the reference's try/except-to-NaN contract (preprocess.py:92-122)."""
    features: dict[str, float] = {}
    try:
        features.update(hrv_features(window_data["chest_ECG"], fs))
    except Exception:
        for k in ("HRV_RMSSD", "HRV_SDNN", "HRV_LFHF", "HRV_HF", "HRV_SampEn"):
            features[k] = np.nan
    try:
        features.update(eda_features(window_data["chest_EDA"], fs))
    except Exception:
        features["EDA_SCR_Peaks_N"] = np.nan
        features["EDA_Tonic_Slope"] = np.nan
    try:
        features.update(resp_features(window_data["chest_Resp"], fs))
    except Exception:
        features["RESP_Rate_Mean"] = np.nan
        features["RESP_RRV_SDNN"] = np.nan
    emg = window_data.get("chest_EMG")
    features["EMG_Amplitude_Mean"] = float(np.mean(np.abs(emg))) if emg is not None else np.nan
    return {k: features[k] for k in FEATURE_NAMES}


def extract_features_batch(
    windows: dict[str, np.ndarray], fs: float
) -> np.ndarray:
    """Feature matrix [N, F] for N windows.

    `windows` maps channel name -> [N, T] arrays. The linear DSP — ECG QRS
    bandpass, Resp bandpass, EDA detrend/Fourier-resample/tonic lowpass — runs
    ONCE per subject as vectorized [N, T] calls (sosfiltfilt/rfft/polyfit all
    operate per-row along the last axis, so results match the per-window
    extractors; pinned by tests/test_features.py::test_batch_matches_per_window).
    Only the per-window peak bookkeeping (find_peaks, RR math, SampEn) stays in
    the host loop. Failures stay NaN per window per feature group, matching the
    reference's try/except contract (preprocess.py:92-122).
    """
    n = next(iter(windows.values())).shape[0]
    out = np.empty((n, len(FEATURE_NAMES)), dtype=np.float64)
    if n == 0:
        return out

    def _batch_dsp(key: str, f):
        """Vectorized whole-subject DSP; None disables the precomputed path
        (the per-window extractors then recompute their own, preserving the
        one-window failure envelope)."""
        if key not in windows:
            return None
        try:
            return f(np.asarray(windows[key], dtype=np.float64))
        except Exception:
            return None

    ecg_filt = _batch_dsp("chest_ECG", lambda x: sps.sosfiltfilt(
        _butter_sos(3, 5.0, 30.0, "bandpass", fs), x, axis=-1))
    resp_filt = _batch_dsp("chest_Resp", lambda x: sps.sosfiltfilt(
        _butter_sos(2, 0.05, 1.0, "bandpass", fs), x, axis=-1))

    def _eda_decompose(x_all: np.ndarray):
        x, target_fs = _eda_resample_detrended(x_all, fs)
        tonic = sps.sosfiltfilt(
            _butter_sos(2, 0.05, None, "lowpass", target_fs), x, axis=-1)
        return tonic, x - tonic, target_fs

    eda_parts = _batch_dsp("chest_EDA", _eda_decompose)

    for i in range(n):
        w = {k: v[i] for k, v in windows.items()}
        feats: dict[str, float] = {}
        try:
            feats.update(hrv_features(
                w["chest_ECG"], fs,
                filt=None if ecg_filt is None else ecg_filt[i]))
        except Exception:
            for k in ("HRV_RMSSD", "HRV_SDNN", "HRV_LFHF", "HRV_HF", "HRV_SampEn"):
                feats[k] = np.nan
        try:
            if eda_parts is not None:
                tonic, phasic, target_fs = eda_parts
                feats.update(_eda_from_decomposed(tonic[i], phasic[i], target_fs))
            else:
                feats.update(eda_features(w["chest_EDA"], fs))
        except Exception:
            feats["EDA_SCR_Peaks_N"] = np.nan
            feats["EDA_Tonic_Slope"] = np.nan
        try:
            feats.update(resp_features(
                w["chest_Resp"], fs,
                filt=None if resp_filt is None else resp_filt[i]))
        except Exception:
            feats["RESP_Rate_Mean"] = np.nan
            feats["RESP_RRV_SDNN"] = np.nan
        emg = w.get("chest_EMG")
        feats["EMG_Amplitude_Mean"] = float(np.mean(np.abs(emg))) if emg is not None else np.nan
        out[i] = [feats[k] for k in FEATURE_NAMES]
    return out
