"""Fourier-domain resampling with scipy.signal.resample parity, NumPy only.

Counterpart of multimodalsignal_tpu/data/resample.py's host path
(`fourier_resample_np`, `resample_signal` with the numpy backend): the
spectrum is truncated or zero-padded over one axis in float64, with scipy's
Nyquist split/join rules, in one batched rfft/irfft pair for all columns.
"""

from __future__ import annotations

import numpy as np


def _resample_spectrum(X: np.ndarray, nx: int, num: int) -> np.ndarray:
    """X: rfft of the input along the last axis, [..., nx//2+1] ->
    Y [..., num//2+1] following scipy's component copy and Nyquist rules."""
    n_keep = min(num, nx)
    nyq = n_keep // 2 + 1  # slice end that includes Nyquist if present
    Y = X[..., :nyq]
    pad = num // 2 + 1 - nyq
    if pad > 0:
        Y = np.pad(Y, [(0, 0)] * (Y.ndim - 1) + [(0, pad)])
    if n_keep % 2 == 0:
        scale = np.ones((Y.shape[-1],), dtype=Y.real.dtype)
        if num < nx:  # downsampling: fold -N/2 into +N/2
            scale[n_keep // 2] = 2.0
        elif num > nx:  # upsampling: halve the split Nyquist bin
            scale[n_keep // 2] = 0.5
        Y = Y * scale
    return Y


def fourier_resample_np(x: np.ndarray, num: int, axis: int = -1) -> np.ndarray:
    """Resample real input to `num` samples along `axis` in float64
    (scipy.signal.resample(x, num, axis) without a window)."""
    x = np.moveaxis(np.asarray(x, dtype=np.float64), axis, -1)
    nx = x.shape[-1]
    X = np.fft.rfft(x, axis=-1)
    Y = _resample_spectrum(X, nx, num)
    y = np.fft.irfft(Y, num, axis=-1) * (float(num) / float(nx))
    return np.moveaxis(y, -1, axis)


def resample_signal(signal_data: np.ndarray, original_fs: int,
                    target_fs: int) -> np.ndarray:
    """Resample a [T] or [T, A] signal from original_fs to target_fs along
    time; the output has int(len * target_fs / original_fs) samples."""
    signal_data = np.asarray(signal_data)
    num = int(len(signal_data) * (target_fs / original_fs))
    return fourier_resample_np(signal_data, num, axis=0)
