"""Dataset layer: windowed npy files -> dense, normalized [N, C, T] arrays,
and the sharded sweep's packed corpus (counterpart of
multimodalsignal_tpu/data/dataset.py, NumPy float64 path; the JAX package's
C++ engine, its on-disk pack cache and the hybrid datasets are not ported:
ROADMAP.md, queue 1, preprocessing and data).

The preprocessed data directory holds, per subject, `S*_X.npy` [N, T, C_all]
windows and `S*_y.npy` raw labels (1 Base, 2 TSST, 3 Fun, 4 Medi), plus
`_channel_names.txt` (one name per line) and, where the preprocessor wrote
it, `_preprocess_meta.json`."""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path

import numpy as np

EDA_CHANNEL = "chest_EDA"
# Floor for the EDA log1p (keeps it defined when FFT resampling rings below
# -1 at artifact steps).
_LOG1P_FLOOR = -1.0 + 1e-6
NORMALIZATION_SCHEMES = ("all", "baseline", "none")


def read_channel_names(data_path: Path | str) -> list[str]:
    """The _channel_names.txt contract: one channel name per line."""
    with open(Path(data_path) / "_channel_names.txt") as f:
        return [line.strip() for line in f if line.strip()]


def read_preprocess_meta(data_path: Path | str) -> dict | None:
    """_preprocess_meta.json beside the windowed npy files (the fs, window
    and stride contract), or None for data written without it."""
    path = Path(data_path) / "_preprocess_meta.json"
    if not path.exists():
        return None
    return json.loads(path.read_text())


def experiment_preprocess_meta(cfg) -> dict | None:
    """The preprocess meta a run directory embeds in config.json. The hybrid
    model is not ported, so this is the raw windows' meta."""
    return read_preprocess_meta(cfg.data_path)


def load_subject_windows(data_path: Path | str, sid: str):
    """One subject's (X [N, T, C_all], y_raw [N]), or None with a warning
    when its files are missing."""
    data_path = Path(data_path)
    x_file = data_path / f"{sid}_X.npy"
    y_file = data_path / f"{sid}_y.npy"
    if not x_file.exists() or not y_file.exists():
        print(f"Warning: Skipping subject {sid} for data, file not found.")
        return None
    return np.load(x_file), np.load(y_file)


def map_labels(y_raw: np.ndarray, mode: str) -> tuple[np.ndarray, np.ndarray]:
    """Raw labels {1: Base, 2: TSST, 3: Fun, 4: Medi} -> (labels, keep mask)
    by classification mode. stress_binary and ternary keep every window;
    amusement_binary keeps Base and Fun only. "binary" is an alias of
    stress_binary."""
    if mode == "binary":
        mode = "stress_binary"
    if mode == "stress_binary":
        return np.where(y_raw == 2, 1, 0).astype(np.int32), np.ones(len(y_raw), bool)
    if mode == "ternary":
        y = np.where(y_raw == 1, 0, np.where(y_raw == 3, 1, np.where(y_raw == 2, 2, 0)))
        return y.astype(np.int32), np.ones(len(y_raw), bool)
    if mode == "amusement_binary":
        keep = np.isin(y_raw, (1, 3))
        return np.where(y_raw == 3, 1, 0).astype(np.int32), keep
    raise ValueError(f"Unknown classification_mode: {mode}")


def normalize_subject(x: np.ndarray, y_raw: np.ndarray,
                      channel_names: list[str], scheme: str = "all") -> np.ndarray:
    """Per-subject normalization of [N, T, C] windows with float64 stats.

    scheme="all":      z-score per channel over all windows; chest_EDA gets
                       log1p first and its own log-domain stats (eps 1e-8).
    scheme="baseline": stats from Base-only (y_raw == 1) windows, with the
                       all-window stats when a subject has none.
    scheme="none":     passthrough.
    """
    if scheme == "none":
        return x.astype(np.float32)
    if scheme not in NORMALIZATION_SCHEMES:
        raise ValueError(f"Unknown normalization scheme: {scheme}")
    x = np.asarray(x, dtype=np.float64)
    out = np.empty_like(x, dtype=np.float32)
    if scheme == "baseline":
        ref = x[y_raw == 1] if (y_raw == 1).any() else x
        if not (y_raw == 1).any():
            print("Warning: no baseline windows; falling back to all-data stats.")
    else:
        ref = x
    for c, name in enumerate(channel_names):
        if name == EDA_CHANNEL:
            log_all = np.log1p(np.maximum(x[:, :, c], _LOG1P_FLOOR))
            log_ref = np.log1p(np.maximum(ref[:, :, c], _LOG1P_FLOOR))
            mean, std = log_ref.mean(), log_ref.std() + 1e-8
            out[:, :, c] = ((log_all - mean) / std).astype(np.float32)
        else:
            mean, std = ref[:, :, c].mean(), ref[:, :, c].std() + 1e-8
            out[:, :, c] = ((x[:, :, c] - mean) / std).astype(np.float32)
    return out


@dataclass
class WindowDataset:
    """Dense dataset: x [N, C, T] float32 (channels first, the model's
    input layout), y [N] int32, and the subjects it holds in order."""

    x: np.ndarray
    y: np.ndarray
    subjects: tuple[str, ...]

    def __len__(self) -> int:
        return len(self.y)


def build_dataset(data_path: Path | str, subjects: list[str],
                  channels_to_use: list[str], all_channel_names: list[str],
                  classification_mode: str = "stress_binary",
                  normalization: str = "all") -> WindowDataset:
    """Select the channels, map the labels, normalize each subject on its
    own and concatenate the subjects in order; subjects whose files are
    missing are skipped, and none loaded raises ValueError."""
    channel_indices = [all_channel_names.index(ch) for ch in channels_to_use]
    xs, ys, loaded = [], [], []
    for sid in subjects:
        item = load_subject_windows(data_path, sid)
        if item is None:
            continue
        x_raw, y_raw = item
        x_sel = x_raw[:, :, channel_indices]
        y, keep = map_labels(y_raw, classification_mode)
        x_norm = normalize_subject(x_sel, y_raw, channels_to_use, normalization)
        xs.append(x_norm[keep])
        ys.append(y[keep])
        loaded.append(sid)
    if not xs:
        raise ValueError(
            f"No data loaded for subjects: {subjects}. Check paths and data existence.")
    x = np.concatenate(xs, axis=0).transpose(0, 2, 1)  # [N, C, T]
    y = np.concatenate(ys, axis=0)
    return WindowDataset(np.ascontiguousarray(x), y, tuple(loaded))


@dataclass
class PackedCorpus:
    """All subjects padded to a common window count for the sharded sweep.

    x    [S, Wmax, C, T] float32, normalized per subject
    y    [S, Wmax] int32 (mapped labels; padded rows hold 0)
    mask [S, Wmax] bool (True = a real window that the mode's filter kept)
    """

    x: np.ndarray
    y: np.ndarray
    mask: np.ndarray
    subjects: tuple[str, ...]

    def flat(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """The [S*Wmax, C, T] view with labels and mask, for the sweep's
        index pools (subject s, window w -> s * Wmax + w)."""
        s, wmax = self.x.shape[:2]
        return (self.x.reshape(s * wmax, *self.x.shape[2:]), self.y.reshape(s * wmax),
                self.mask.reshape(s * wmax))


def _stack_packed(per_subject) -> PackedCorpus:
    """Pad per-subject (sid, x [n, C, T], y [n]) tuples to a common window
    count and stack them into one PackedCorpus."""
    wmax = max(x.shape[0] for _, x, _ in per_subject)
    c, t = per_subject[0][1].shape[1:]
    x_out = np.zeros((len(per_subject), wmax, c, t), dtype=np.float32)
    y_out = np.zeros((len(per_subject), wmax), dtype=np.int32)
    mask = np.zeros((len(per_subject), wmax), dtype=bool)
    for i, (_, x, y) in enumerate(per_subject):
        x_out[i, :len(x)] = x
        y_out[i, :len(x)] = y
        mask[i, :len(x)] = True
    return PackedCorpus(x_out, y_out, mask, tuple(sid for sid, _, _ in per_subject))


def pack_corpus(data_path: Path | str, subjects: list[str], channels_to_use: list[str],
                all_channel_names: list[str], classification_mode: str = "stress_binary",
                normalization: str = "all") -> PackedCorpus:
    """Load and normalize every subject once and pad to [S, Wmax, C, T].
    Normalization is per subject, so one packed corpus serves every LOSO
    fold. Subjects pack in a pool of up to 8 threads, the result in subject
    order. Subjects whose files are missing are skipped; none loaded raises
    ValueError."""
    from concurrent.futures import ThreadPoolExecutor

    channel_indices = [all_channel_names.index(ch) for ch in channels_to_use]

    def pack_one(sid):
        item = load_subject_windows(data_path, sid)
        if item is None:
            return None
        x_raw, y_raw = item
        y, keep = map_labels(y_raw, classification_mode)
        x_norm = normalize_subject(x_raw[:, :, channel_indices], y_raw, channels_to_use,
                                   normalization)
        return sid, x_norm[keep].transpose(0, 2, 1), y[keep]

    with ThreadPoolExecutor(max_workers=max(1, min(8, len(subjects)))) as ex:
        packed = list(ex.map(pack_one, subjects))
    per_subject = [p for p in packed if p is not None]
    if not per_subject:
        raise ValueError(f"No data loaded for subjects: {subjects}.")
    return _stack_packed(per_subject)
