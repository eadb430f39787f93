"""The host window engine: C++ window gather and normalization over ctypes
(counterpart of multimodalsignal_tpu/native/, from the port's own copy of
its source, window_engine.cpp).

The source is built with g++ at first use (`-O3 -fopenmp`, then again
without OpenMP if that fails, as the JAX package builds it) into
`native/build/libwindow_engine-<hash of the source>.so`, git-ignored, and
rebuilt when the source changes; the build writes a temporary file and
renames it, so processes or threads building at once never load a partial
library. `available()` is False when there is no compiler or the build
fails; the callers (data/dataset.py, data/windowing.py) then take their
NumPy paths, which stay the behavioral reference.

Each wrapper counts its calls in its `calls` attribute (`call_counts`,
`reset_call_counts`), so a run can show that it went through the engine.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).parent / "window_engine.cpp"
BUILD_DIR = Path(__file__).parent / "build"
BUILD_FLAGS = (["-O3", "-shared", "-fPIC", "-std=c++17", "-fopenmp"],
               ["-O3", "-shared", "-fPIC", "-std=c++17"])

_LOCK = threading.Lock()
_COUNT_LOCK = threading.Lock()
_STATE: dict = {}


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"libwindow_engine-{digest}.so"


def _build(lib_path: Path) -> list[str] | None:
    """g++ the source into lib_path; the flags that built it, or None."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    for flags in BUILD_FLAGS:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            result = subprocess.run(["g++", *flags, str(SOURCE), "-o", tmp],
                                    capture_output=True, timeout=120)
        except (OSError, subprocess.TimeoutExpired):
            os.unlink(tmp)
            return None
        if result.returncode == 0:
            os.replace(tmp, lib_path)
            return flags
        os.unlink(tmp)
    return None


def _load() -> ctypes.CDLL | None:
    with _LOCK:
        if "lib" in _STATE:
            return _STATE["lib"]
        _STATE["lib"] = None
        lib_path = library_path()
        if lib_path.exists():
            _STATE["flags"] = None   # built by an earlier process
        else:
            flags = _build(lib_path)
            if flags is None:
                return None
            _STATE["flags"] = flags
        try:
            lib = ctypes.CDLL(str(lib_path))
        except OSError:
            return None
        i64 = ctypes.c_int64
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        lib.sliding_windows_f32.argtypes = [f32p, i64, i64, i64p, i64, i64, f32p]
        lib.sliding_windows_f32.restype = None
        lib.normalize_windows_f32.argtypes = [f32p, i64, i64, i64, f64p, f64p, u8p]
        lib.normalize_windows_f32.restype = None
        lib.channel_stats_f32.argtypes = [f32p, i64, i64, i64, u8p, f64p, f64p]
        lib.channel_stats_f32.restype = None
        lib.pack_subject_f32.argtypes = [f32p, i64, i64, i64, i64p, i64, u8p, u8p, u8p,
                                         ctypes.c_double, f32p]
        lib.pack_subject_f32.restype = None
        _STATE["lib"] = lib
        return lib


def available() -> bool:
    """Whether the engine is built and loaded (building it at first call)."""
    return _load() is not None


def build_flags() -> list[str] | None:
    """The g++ flags this process built the engine with (None where it
    loaded a library an earlier process built, or none was built)."""
    _load()
    return _STATE.get("flags")


def _count(wrapper) -> None:
    with _COUNT_LOCK:   # the packers call from a pool of threads
        wrapper.calls += 1


def _lib() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError(f"the native window engine did not build ({SOURCE})")
    return lib


def sliding_windows_f32(signal: np.ndarray, starts: np.ndarray, window: int) -> np.ndarray:
    """[T, C] float32 + starts [N] -> [N, window, C] (native gather)."""
    lib = _lib()
    signal = np.ascontiguousarray(signal, dtype=np.float32)
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    t_total, channels = signal.shape
    # The C++ gather copies with no bounds check: an out-of-range start must
    # fail as the NumPy path's IndexError does, not read past the signal.
    if len(starts) and (int(starts.min()) < 0 or int(starts.max()) + window > t_total):
        raise IndexError(f"window [{int(starts.max())}, {int(starts.max()) + window}) "
                         f"out of bounds for signal of length {t_total}")
    out = np.empty((len(starts), window, channels), dtype=np.float32)
    lib.sliding_windows_f32(signal, t_total, channels, starts, len(starts), window, out)
    _count(sliding_windows_f32)
    return out


def pack_subject_f32(x: np.ndarray, chan_idx: np.ndarray, log1p_mask: np.ndarray,
                     stat_rows: np.ndarray, keep_rows: np.ndarray,
                     eps: float = 1e-8) -> np.ndarray:
    """Fused channel select + per-channel z-score (log1p first where the mask
    says) + transpose: [W, T, C_all] float32, C-contiguous (a memory map
    will do) -> [keep, C_sel, T]. The statistics come from the windows of
    stat_rows (double accumulators, population std + eps), the output holds
    the windows of keep_rows."""
    lib = _lib()
    if x.dtype != np.float32 or not x.flags["C_CONTIGUOUS"] or x.ndim != 3:
        raise TypeError("x must be a C-contiguous float32 [W, T, C_all] array")
    w_total, t_len, c_all = x.shape
    stat = np.ascontiguousarray(stat_rows, dtype=np.uint8)
    keep = np.ascontiguousarray(keep_rows, dtype=np.uint8)
    idx = np.ascontiguousarray(chan_idx, dtype=np.int64)
    if stat.shape != (w_total,) or keep.shape != (w_total,):
        raise ValueError(f"stat_rows and keep_rows must be [{w_total}]")
    if not stat.any():
        raise ValueError("stat_rows must select at least one window")
    if len(idx) and (idx.min() < 0 or idx.max() >= c_all):
        raise IndexError(f"channel index out of range for C_all={c_all}")
    out = np.empty((int(keep.sum()), len(idx), t_len), dtype=np.float32)
    lib.pack_subject_f32(x, w_total, t_len, c_all, idx, len(idx),
                         np.ascontiguousarray(log1p_mask, dtype=np.uint8), stat, keep,
                         float(eps), out)
    _count(pack_subject_f32)
    return out


def channel_stats_f32(windows: np.ndarray, log1p_mask: np.ndarray):
    """Per-channel (mean, std) of [N, W, C] float32 windows, log1p first
    where the mask says (population std, as NumPy's .std())."""
    lib = _lib()
    windows = np.ascontiguousarray(windows, dtype=np.float32)
    n, w, c = windows.shape
    mask = np.ascontiguousarray(log1p_mask, dtype=np.uint8)
    mean = np.empty(c, dtype=np.float64)
    std = np.empty(c, dtype=np.float64)
    lib.channel_stats_f32(windows, n, w, c, mask, mean, std)
    _count(channel_stats_f32)
    return mean, std


def normalize_windows_f32(windows: np.ndarray, mean: np.ndarray, std: np.ndarray,
                          log1p_mask: np.ndarray) -> np.ndarray:
    """In-place per-channel z-score of [N, W, C] float32 windows; returns
    the same array."""
    lib = _lib()
    if windows.dtype != np.float32 or not windows.flags["C_CONTIGUOUS"]:
        raise TypeError("windows must be a C-contiguous float32 array")
    n, w, c = windows.shape
    lib.normalize_windows_f32(windows, n, w, c, np.ascontiguousarray(mean, dtype=np.float64),
                              np.ascontiguousarray(std, dtype=np.float64),
                              np.ascontiguousarray(log1p_mask, dtype=np.uint8))
    _count(normalize_windows_f32)
    return windows


_WRAPPERS = (sliding_windows_f32, pack_subject_f32, channel_stats_f32, normalize_windows_f32)
for _w in _WRAPPERS:
    _w.calls = 0


def call_counts() -> dict[str, int]:
    """Engine calls since the last reset, by wrapper."""
    return {w.__name__: w.calls for w in _WRAPPERS}


def reset_call_counts() -> None:
    for w in _WRAPPERS:
        w.calls = 0
