"""Sliding-window segmentation and label assignment (counterpart of
multimodalsignal_tpu/data/windowing.py; sliding_windows_fast gathers with
the port's host window engine, native/).

Parity target: reference preprocess.py:160-200 — per protocol row, minute
timestamps are converted to sample indices at the original rate, scaled to the
resampled rate, and sliced into 60 s windows at a 10 s stride. The reference
does this with nested python loops appending lists; here window extraction is
a single strided-view gather so the whole subject segments in one shot.
"""

from __future__ import annotations

import numpy as np


def window_starts(start_idx: int, end_idx: int, window_samples: int, stride_samples: int) -> np.ndarray:
    """Start indices of complete windows inside [start_idx, end_idx).

    Matches reference preprocess.py:174/189:
    range(start, end - window + 1, stride).
    """
    return np.arange(start_idx, end_idx - window_samples + 1, stride_samples, dtype=np.int64)


def sliding_windows(signal: np.ndarray, starts: np.ndarray, window_samples: int) -> np.ndarray:
    """Gather windows [N, window_samples, ...] from signal [T, ...].

    Equivalent to stacking signal[s : s + window] for each start s, but as a
    single vectorized gather.
    """
    if len(starts) == 0:
        trailing = signal.shape[1:]
        return np.empty((0, window_samples) + trailing, dtype=signal.dtype)
    idx = starts[:, None] + np.arange(window_samples)[None, :]
    return signal[idx]


def sliding_windows_fast(signal: np.ndarray, starts: np.ndarray,
                         window_samples: int) -> np.ndarray:
    """sliding_windows through the host window engine's gather for float32
    signals where it is built; bit for bit the NumPy gather."""
    from multimodalsignal_tpu_torch import native

    if len(starts) > 0 and signal.dtype == np.float32 and native.available():
        return native.sliding_windows_f32(signal, starts, window_samples)
    return sliding_windows(signal, starts, window_samples)


def segment_protocol(
    protocol_rows,
    task_to_label: dict[str, int],
    original_fs: int,
    target_fs: int,
    window_sec: int,
    stride_sec: int,
) -> tuple[np.ndarray, np.ndarray]:
    """Compute (window_starts, labels) in resampled-sample units for a protocol.

    Mirrors the reference's index math exactly (preprocess.py:160-189):
      start_idx_orig = int(start_min * 60 * original_fs)
      start_idx      = int(start_idx_orig * (target_fs / original_fs))
    Tasks whose (whitespace-stripped) name is not in the label map are skipped.
    """
    window_samples = int(window_sec * target_fs)
    stride_samples = int(stride_sec * target_fs)
    all_starts: list[np.ndarray] = []
    all_labels: list[np.ndarray] = []
    for row in protocol_rows:
        task = row.task.replace(" ", "").strip()
        label = task_to_label.get(task)
        if label is None:
            continue
        start_idx_orig = int(row.start_min * 60 * original_fs)
        end_idx_orig = int(row.end_min * 60 * original_fs)
        start_idx = int(start_idx_orig * (target_fs / original_fs))
        end_idx = int(end_idx_orig * (target_fs / original_fs))
        starts = window_starts(start_idx, end_idx, window_samples, stride_samples)
        all_starts.append(starts)
        all_labels.append(np.full(len(starts), label, dtype=np.int64))
    if not all_starts:
        return np.empty((0,), dtype=np.int64), np.empty((0,), dtype=np.int64)
    return np.concatenate(all_starts), np.concatenate(all_labels)
