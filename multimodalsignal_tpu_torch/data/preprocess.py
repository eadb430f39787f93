"""Offline preprocessing: WESAD pickles -> windowed .npy tensors + features
(counterpart of multimodalsignal_tpu/data/preprocess.py, NumPy and SciPy on
the host; it writes the same files, byte for byte).

Output contract (consumed by the dataset layer):

  <out>/chest_raw/_channel_names.txt, S*_X.npy [N, T, 8], S*_y.npy [N]
  <out>/chest_raw_align/...           (raw windows padded/truncated to the
                                       feature window count)
  <out>/chest_feature/_feature_names.txt, S*_X.npy [N, F], S*_y.npy [N]

and a `_preprocess_meta.json` in each: the resample/window/stride contract
beside the raw targets, the feature extractor's version beside the feature
target. Labels are the original protocol labels {1: Base, 2: TSST, 3: Fun,
4: Medi}; the dataset layer maps them per classification mode.

Per subject: every chest sensor resamples 700 -> 128 Hz in one FFT per
sensor (data/resample.py), the protocol's 60 s windows at a 10 s stride are
one gather (data/windowing.py; the JAX package's optional C++ gather gives
the same float32 windows), and the raw and feature targets share one
resampled array when their rates match.

    python -m multimodalsignal_tpu_torch.data.preprocess --wesad-root ./WESAD \\
        --output ./data [--targets raw raw-align feature] [--subjects S2 S3] \\
        [--workers 8] [--include-wrist]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from multimodalsignal_tpu_torch.config import (
    ALL_CHANNEL_NAMES,
    CHEST_SENSORS,
    TASK_TO_LABEL_MAP,
    WRIST_CHANNEL_NAMES,
    WRIST_SENSORS,
    PreprocessConfig,
)
from multimodalsignal_tpu_torch.data.features import (
    FEATURE_EXTRACTOR_VERSION,
    FEATURE_NAMES,
    extract_features_batch,
)
from multimodalsignal_tpu_torch.data.protocol import parse_quest_csv
from multimodalsignal_tpu_torch.data.resample import resample_signal
from multimodalsignal_tpu_torch.data.wesad_io import (
    WRIST_RATES,
    chest_signals,
    load_subject_pkl,
    wrist_signals,
)
from multimodalsignal_tpu_torch.data.windowing import segment_protocol, sliding_windows


def _write_names(path: Path, names) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text("".join(f"{n}\n" for n in names))


def _resample_all(chest: dict[str, np.ndarray], original_fs: int, target_fs: int) -> np.ndarray:
    """Resample every chest sensor and concatenate to [T', 8] in the order
    chest_ACC_{x,y,z}, chest_{ECG,EDA,EMG,Resp,Temp}."""
    cols = []
    for sensor in CHEST_SENSORS:
        sig = np.asarray(chest[sensor])
        if sig.ndim == 1:
            sig = sig[:, None]
        cols.append(resample_signal(sig, original_fs, target_fs))
    return np.concatenate(cols, axis=1)


def _resample_wrist(wrist: dict[str, np.ndarray], target_fs: int,
                    target_len: int) -> np.ndarray:
    """Resample each wrist sensor from its native rate onto the common grid
    and trim or pad (repeating the last sample) to the chest grid's length
    -> [target_len, 6] (wrist_ACC_{x,y,z}, wrist_BVP, wrist_EDA, wrist_TEMP)."""
    cols = []
    for sensor in WRIST_SENSORS:
        sig = np.asarray(wrist[sensor])
        if sig.ndim == 1:
            sig = sig[:, None]
        res = resample_signal(sig, WRIST_RATES[sensor], target_fs)
        if res.shape[0] < target_len:  # device clocks drift by a few samples
            pad = np.repeat(res[-1:], target_len - res.shape[0], axis=0)
            res = np.concatenate([res, pad], axis=0)
        cols.append(res[:target_len])
    return np.concatenate(cols, axis=1)


def preprocess_subject(sid: str, cfg: PreprocessConfig
                       ) -> dict[str, tuple[np.ndarray, np.ndarray]] | None:
    """This subject's arrays per target: {'raw': (X, y), ...}. X raw:
    [N, window_samples, C] float32; X feature: [N, F] float64 with failed
    feature groups set to 0; y: original labels. None when the subject's
    pickle is missing."""
    data = load_subject_pkl(sid, cfg.wesad_root)
    if data is None:
        return None
    protocol = parse_quest_csv(sid, cfg.wesad_root)
    chest = chest_signals(data)
    out: dict[str, tuple[np.ndarray, np.ndarray]] = {}

    want_raw = "raw" in cfg.targets or "raw-align" in cfg.targets
    raw = feat = None
    if want_raw:
        raw = _resample_all(chest, cfg.original_chest_fs, cfg.raw_fs)
        if cfg.include_wrist:
            wrist = wrist_signals(data)
            if wrist is None:
                print(f"Warning: {sid} has no wrist data; "
                      f"wrist channels filled with zeros.")
                raw = np.concatenate(
                    [raw, np.zeros((raw.shape[0], len(WRIST_CHANNEL_NAMES)))], axis=1)
            else:
                raw = np.concatenate(
                    [raw, _resample_wrist(wrist, cfg.raw_fs, raw.shape[0])], axis=1)
    if "feature" in cfg.targets:
        if want_raw and cfg.feature_fs == cfg.raw_fs:
            feat = raw  # the same resample
        else:
            feat = _resample_all(chest, cfg.original_chest_fs, cfg.feature_fs)

    X_raw = None
    if want_raw:
        raw_starts, raw_labels = segment_protocol(
            protocol, TASK_TO_LABEL_MAP, cfg.original_chest_fs, cfg.raw_fs,
            cfg.raw_window_sec, cfg.raw_stride_sec)
        # float32 before the gather: the npy holds float32 windows.
        X_raw = sliding_windows(raw.astype(np.float32), raw_starts, cfg.raw_window_samples)
        if "raw" in cfg.targets:
            out["raw"] = (X_raw, raw_labels)

    if "feature" in cfg.targets:
        f_starts, f_labels = segment_protocol(
            protocol, TASK_TO_LABEL_MAP, cfg.original_chest_fs, cfg.feature_fs,
            cfg.feature_window_sec, cfg.feature_stride_sec)
        window_samples = cfg.feature_window_sec * cfg.feature_fs
        # Only the 4 feature sensors, float64, each 1-D channel windowed
        # through a strided view into a contiguous [N, T] array.
        ch_index = {name: i for i, name in enumerate(ALL_CHANNEL_NAMES)}
        channel_windows = {}
        for s in ("ECG", "EDA", "EMG", "Resp"):
            sig = np.ascontiguousarray(feat[:, ch_index[f"chest_{s}"]])
            if len(f_starts) == 0:
                channel_windows[f"chest_{s}"] = np.empty((0, window_samples), sig.dtype)
                continue
            view = np.lib.stride_tricks.sliding_window_view(sig, window_samples)
            channel_windows[f"chest_{s}"] = view[f_starts]
        X_feat = extract_features_batch(channel_windows, cfg.feature_fs)
        X_feat = np.nan_to_num(X_feat, nan=0.0, posinf=0.0, neginf=0.0)
        out["feature"] = (X_feat, f_labels)

        if "raw-align" in cfg.targets:
            # Pad (repeating the last window) or truncate the raw windows to
            # the feature window count, so hybrid training pairs them
            # window for window.
            n_feat, n_raw = len(f_labels), len(X_raw)
            if n_raw < n_feat:
                pad = np.repeat(X_raw[-1:], n_feat - n_raw, axis=0)
                X_align = np.concatenate([X_raw, pad], axis=0)
            else:
                X_align = X_raw[:n_feat]
            out["raw-align"] = (X_align, f_labels.copy())
    elif "raw-align" in cfg.targets:
        print(f"Warning: 'raw-align' needs 'feature' to align window counts; "
              f"skipping raw-align for {sid}.")
    return out


TARGET_DIRS = {"raw": "chest_raw", "raw-align": "chest_raw_align", "feature": "chest_feature"}


def _process_and_save(args) -> list[str]:
    """One subject end to end (module level, for the process pool)."""
    sid, cfg, output = args
    result = preprocess_subject(sid, cfg)
    if result is None:
        return []
    lines = []
    for target, (X, y) in result.items():
        d = Path(output) / TARGET_DIRS[target]
        np.save(d / f"{sid}_X.npy", X)
        np.save(d / f"{sid}_y.npy", y)
        lines.append(f"  - {sid} ({target}): saved {len(y)} windows, X shape {X.shape}")
    return lines


def run_preprocessing(cfg: PreprocessConfig, workers: int = 0) -> None:
    """Process every subject and write the npy outputs, the name files and
    the meta files. workers > 1 spreads the subjects over that many
    processes."""
    output = Path(cfg.output_path)
    channel_names = list(ALL_CHANNEL_NAMES)
    if cfg.include_wrist:
        channel_names += list(WRIST_CHANNEL_NAMES)
    for target in cfg.targets:
        d = output / TARGET_DIRS[target]
        d.mkdir(parents=True, exist_ok=True)
        if target in ("raw", "raw-align"):
            _write_names(d / "_channel_names.txt", channel_names)
            # The serving-time contract: the Predictor replays this
            # resample/window/stride on raw recordings.
            meta = {"original_fs": cfg.original_chest_fs, "fs": cfg.raw_fs,
                    "window_sec": cfg.raw_window_sec, "stride_sec": cfg.raw_stride_sec,
                    "include_wrist": cfg.include_wrist}
        else:
            _write_names(d / "_feature_names.txt", FEATURE_NAMES)
            # Which extractor made these features: a hybrid deployment checks
            # that the live extractor is the same one.
            meta = {"feature_extractor_version": FEATURE_EXTRACTOR_VERSION}
        (d / "_preprocess_meta.json").write_text(json.dumps(meta, indent=2) + "\n")

    jobs = [(sid, cfg, str(output)) for sid in cfg.subjects]
    if workers and workers > 1 and len(jobs) > 1:
        import multiprocessing as mp

        with mp.get_context("spawn").Pool(min(workers, len(jobs))) as pool:
            for lines in pool.imap(_process_and_save, jobs):
                for line in lines:
                    print(line)
    else:
        for job in jobs:
            for line in _process_and_save(job):
                print(line)
    print("Preprocessing complete.")


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--wesad-root", default="./WESAD")
    p.add_argument("--output", default="./data")
    p.add_argument("--targets", nargs="+", default=["raw", "raw-align", "feature"],
                   choices=list(TARGET_DIRS))
    p.add_argument("--subjects", nargs="*", default=None)
    p.add_argument("--workers", type=int, default=0,
                   help="process this many subjects in parallel (0 = serial)")
    p.add_argument("--include-wrist", action="store_true",
                   help="also window the wrist device's channels "
                        "(BVP/EDA/TEMP/ACC, each resampled from its native rate)")
    args = p.parse_args(argv)
    cfg = PreprocessConfig(
        wesad_root=args.wesad_root,
        output_path=args.output,
        targets=tuple(args.targets),
        subjects=tuple(args.subjects) if args.subjects else PreprocessConfig.subjects,
        include_wrist=args.include_wrist,
    )
    run_preprocessing(cfg, workers=args.workers)


if __name__ == "__main__":
    main()
