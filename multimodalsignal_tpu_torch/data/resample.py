"""Fourier-domain resampling with scipy.signal.resample parity, and the
causal polyphase resampler of live feeds, NumPy only.

Counterpart of multimodalsignal_tpu/data/resample.py's host path
(`fourier_resample_np`, `resample_signal` with the numpy backend): the
spectrum is truncated or zero-padded over one axis in float64, with scipy's
Nyquist split/join rules, in one batched rfft/irfft pair for all columns.
`StreamingPolyResampler` is the streaming classifier's front end
(experiments/streaming.py), the same arithmetic as the JAX package's.
"""

from __future__ import annotations

import math

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


class StreamingPolyResampler:
    """Causal polyphase FIR resampler for live feeds (e.g. 700 -> 128 Hz).

    A Fourier resample needs the whole signal; a live feed instead goes
    through the classical polyphase resampler: up/down = target/original
    reduced by their gcd (128/700 -> 32/175), one Kaiser-windowed-sinc
    lowpass at the upsampled rate with scipy.signal.resample_poly's default
    design (cutoff 1/max(up, down), half-length 10*max(up, down), beta 5.0),
    applied causally: output k uses input samples <= floor(k*down/up) only,
    so the stream lags the zero-phase batch resampler by the filter's group
    delay

        delay_sec = half_len / (up * original_fs)
        (= 1750 / (32*700) ~= 78 ms for 700 -> 128 Hz),

    `delay_out_samples` in output samples. Outputs do not depend on how the
    signal is chunked, and the whole stream equals scipy.signal.upfirdn(h,
    x, up, down) cut to its causal prefix.
    """

    def __init__(self, original_fs: int, target_fs: int,
                 num_channels: int = 1, beta: float = 5.0,
                 half_len_mult: int = 10):
        g = math.gcd(int(original_fs), int(target_fs))
        self.up = int(target_fs) // g
        self.down = int(original_fs) // g
        self.original_fs = int(original_fs)
        self.target_fs = int(target_fs)
        self.num_channels = int(num_channels)
        if self.up == self.down:  # identity (already at the target rate)
            self._h = None
            self.delay_out_samples = 0.0
            self.delay_sec = 0.0
            return
        max_rate = max(self.up, self.down)
        half_len = half_len_mult * max_rate
        n = np.arange(-half_len, half_len + 1, dtype=np.float64)
        # Windowed sinc at cutoff 1/max_rate of the upsampled Nyquist, unity
        # DC gain, then *up to undo the zero-stuffing's attenuation.
        h = np.sinc(n / max_rate) / max_rate * np.kaiser(2 * half_len + 1, beta)
        h = h / h.sum() * self.up
        self._h = h
        self.delay_sec = half_len / (self.up * self.original_fs)
        self.delay_out_samples = self.delay_sec * self.target_fs
        # Polyphase rows: y[k] = sum_j hp[p_k, j] * x[n_k - j], p_k =
        # (k*down) % up, n_k = (k*down) // up; rows padded to L taps.
        L = -(-len(h) // self.up)
        hp = np.zeros((self.up, L), dtype=np.float64)
        for p in range(self.up):
            taps = h[p::self.up]
            hp[p, : len(taps)] = taps
        self._hp = hp
        self._L = L
        # State: the last L-1 input samples (zeros at t=0: a zero-padded
        # start) and absolute input/output counters.
        self._hist = np.zeros((L - 1, self.num_channels), dtype=np.float64)
        self._hist_start = -(L - 1)  # absolute index of _hist[0]
        self._n_in = 0               # input samples consumed
        self._k_out = 0              # next output index

    def push(self, chunk: np.ndarray) -> np.ndarray:
        """Feed [n] or [n, C] input samples; returns every output sample
        whose causal support is now complete, [m, C] float64."""
        chunk = np.asarray(chunk, dtype=np.float64)
        if chunk.ndim == 1:
            chunk = chunk[:, None]
        if chunk.shape[1] != self.num_channels:
            raise ValueError(
                f"chunk has {chunk.shape[1]} channels, resampler expects "
                f"{self.num_channels}")
        if self._h is None:
            return chunk
        buf = np.concatenate([self._hist, chunk])       # [L-1+n, C]
        buf_start = self._hist_start                     # abs idx of buf[0]
        self._n_in += len(chunk)
        # Output k needs input up to n_k = floor(k*down/up): emit every k
        # with n_k < n_in, i.e. k < ceil(n_in*up/down).
        k_hi = (self._n_in * self.up + self.down - 1) // self.down
        ks = np.arange(self._k_out, k_hi, dtype=np.int64)
        out = np.empty((len(ks), self.num_channels), dtype=np.float64)
        if len(ks):
            n_k = (ks * self.down) // self.up
            p_k = (ks * self.down) % self.up
            # Gather [m, L, C] windows x[n_k - j], j = 0..L-1.
            idx = n_k[:, None] - np.arange(self._L)[None, :] - buf_start
            win = buf[idx]
            out = np.einsum("mlc,ml->mc", win, self._hp[p_k])
            self._k_out = int(ks[-1]) + 1
        # Keep exactly the last L-1 samples as history for the next push.
        self._hist = buf[len(buf) - (self._L - 1):]
        self._hist_start = buf_start + len(buf) - (self._L - 1)
        return out


def resample_signal(signal_data: np.ndarray, original_fs: int,
                    target_fs: int) -> np.ndarray:
    """Resample a [T] or [T, A] signal from original_fs to target_fs along
    time; the output has int(len * target_fs / original_fs) samples."""
    signal_data = np.asarray(signal_data)
    num = int(len(signal_data) * (target_fs / original_fs))
    return fourier_resample_np(signal_data, num, axis=0)
