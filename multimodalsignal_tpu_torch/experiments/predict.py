"""Inference: load a trained fold checkpoint and classify a raw recording.

Counterpart of multimodalsignal_tpu/experiments/predict.py for a CnnGru,
CnnGruAttention or hybrid_cnn_gru checkpoint, written by either package:

    python -m multimodalsignal_tpu_torch.experiments.predict \\
        --checkpoint output/.../fold_test_on_S2/best_model.msgpack \\
        --config output/.../config.json \\
        --pkl WESAD/S16/S16.pkl --out predictions.json [--device cuda]

or programmatically::

    predictor = Predictor.from_run(run_dir, fold="S2")      # on the GPU
    result = predictor.predict_recording(pkl_path)

or, with --run-dir and no --fold (or --fold all), the fold ensemble
(`EnsemblePredictor.from_run(run_dir)`): every fold's checkpoint a lane of
one FoldStackedModel, the softmax averaged over folds. A hierarchical run
(its config.json has m1_channels; serial or sharded) needs --fold
<subject> and goes to `HierarchicalPredictor.from_run(run_dir, fold)`:
that fold's M1 and M2 on the union channels, labels by the hard gate.

Pipeline per recording: resample 700 -> 128 Hz, slide 60 s / 10 s windows
over the whole recording, normalize with the recording's own statistics,
then forward in batches zero-padded to a fixed size. A hybrid model also
takes each window's handcrafted features, extracted from the unnormalized
resampled chest sensors (recording_to_hybrid_windows); its run must carry
the feature extractor version this package computes (a missing stamp warns,
another version raises). Inference runs on "cuda" unless the caller passes
device="cpu"; asking for CUDA where there is none raises. A checkpoint
trained on wrist channels (preprocess --include-wrist) gets the wrist block
appended to the chest grid, as preprocessing makes it.
"""

from __future__ import annotations

import argparse
import json
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from multimodalsignal_tpu_torch.config import (
    ALL_CHANNEL_NAMES,
    CHEST_SENSORS,
    WRIST_CHANNEL_NAMES,
    ExperimentConfig,
    HierarchicalConfig,
    config_from_dict,
    union_channel_indices,
)
from multimodalsignal_tpu_torch.data.dataset import normalize_features, normalize_subject
from multimodalsignal_tpu_torch.data.features import (
    FEATURE_EXTRACTOR_VERSION,
    FEATURE_NAMES,
    FEATURE_SENSOR_CHANNELS,
    extract_features_batch,
)
from multimodalsignal_tpu_torch.data.preprocess import _resample_wrist
from multimodalsignal_tpu_torch.data.resample import resample_signal
from multimodalsignal_tpu_torch.data.wesad_io import chest_signals, load_pkl, wrist_signals
from multimodalsignal_tpu_torch.data.windowing import (
    sliding_windows,
    sliding_windows_fast,
    window_starts,
)
from multimodalsignal_tpu_torch.models.cnn_gru import build_model
from multimodalsignal_tpu_torch.models.convert import load_jax_variables, stack_variables
from multimodalsignal_tpu_torch.models.fold_stack import build_fold_model
from multimodalsignal_tpu_torch.train.checkpoints import read_flax_checkpoint

CLASS_NAMES = {
    "stress_binary": ("non_stress", "stress"),
    "amusement_binary": ("baseline", "amusement"),
    "ternary": ("baseline", "amusement", "stress"),
}


def resolve_device(device: str | torch.device) -> torch.device:
    """torch.device for `device`; raises if it names CUDA and there is none
    (nothing falls back to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' was asked for but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU")
    return device


@dataclass
class PredictionResult:
    starts_sec: np.ndarray   # [N] window start times in seconds
    labels: np.ndarray       # [N] argmax class ids
    probs: np.ndarray        # [N, num_classes]
    class_names: tuple[str, ...]

    def to_json(self) -> str:
        return json.dumps({
            "class_names": list(self.class_names),
            "windows": [
                {
                    "start_sec": float(t),
                    "label": self.class_names[int(l)],
                    "probs": [round(float(p), 6) for p in row],
                }
                for t, l, row in zip(self.starts_sec, self.labels, self.probs)
            ],
        }, indent=2)


def _recording_grid(pkl_path: Path | str, channels_to_use: list[str],
                    original_fs: int, target_fs: int) -> tuple[np.ndarray, list[str]]:
    """Raw WESAD pickle -> resampled channel grid [T', C_all] + its names:
    always the 8-channel chest block (the handcrafted features read their
    sensors from it whatever the model's channels), then the wrist block
    when a wrist channel is asked for, made as preprocessing makes it
    (data/preprocess.py --include-wrist), zeros for a chest-only
    recording."""
    data = load_pkl(pkl_path)
    chest = chest_signals(data)
    cols = []
    for sensor in CHEST_SENSORS:
        sig = np.asarray(chest[sensor])
        if sig.ndim == 1:
            sig = sig[:, None]
        cols.append(resample_signal(sig, original_fs, target_fs))
    full = np.concatenate(cols, axis=1)  # [T', 8]
    names = list(ALL_CHANNEL_NAMES)
    if any(ch not in ALL_CHANNEL_NAMES for ch in channels_to_use):
        wrist = wrist_signals(data)
        if wrist is None:
            print(f"Warning: {pkl_path} has no wrist data; "
                  f"wrist channels filled with zeros.")
            block = np.zeros((full.shape[0], len(WRIST_CHANNEL_NAMES)))
        else:
            block = _resample_wrist(wrist, target_fs, full.shape[0])
        full = np.concatenate([full, block], axis=1)
        names += list(WRIST_CHANNEL_NAMES)
    return full, names


def _inference_norm_scheme(normalization: str) -> str:
    """Map the training scheme to its inference-time equivalent."""
    if normalization == "baseline":
        print(
            "WARNING: model was trained with 'baseline' (Base-windows-"
            "only) normalization statistics; at inference the recording "
            "has no protocol labels, so all-window statistics are used "
            "instead. Expect a shifted input distribution.",
            flush=True,
        )
        return "all"
    return normalization


def recording_to_windows(
    pkl_path: Path | str,
    channels_to_use: list[str],
    normalization: str,
    original_fs: int = 700,
    target_fs: int = 128,
    window_sec: int = 60,
    stride_sec: int = 10,
) -> tuple[np.ndarray, np.ndarray]:
    """Raw WESAD pickle -> normalized [N, C, T] float32 windows + start
    times (s): resample, slide windows over the whole recording, normalize
    with the recording's own statistics."""
    full, names = _recording_grid(pkl_path, channels_to_use, original_fs,
                                  target_fs)
    window_samples = window_sec * target_fs
    starts = window_starts(0, full.shape[0], window_samples,
                           stride_sec * target_fs)
    x = _normalized_raw_windows(full, names, channels_to_use, normalization, starts,
                                window_samples)
    return x, starts / target_fs


def _normalized_raw_windows(full, names, channels_to_use, normalization, starts,
                            window_samples) -> np.ndarray:
    """The raw stream of both serving pipelines: select the channels,
    window, normalize with the recording's own statistics -> [N, C, T]."""
    ch_idx = [names.index(ch) for ch in channels_to_use]
    win = sliding_windows_fast(full[:, ch_idx].astype(np.float32), starts,
                               window_samples)  # [N, T, C]
    y_dummy = np.ones(len(win), dtype=np.int64)
    win = normalize_subject(win, y_dummy, list(channels_to_use),
                            _inference_norm_scheme(normalization))
    return np.ascontiguousarray(win.transpose(0, 2, 1))


def recording_to_hybrid_windows(
    pkl_path: Path | str,
    channels_to_use: list[str],
    normalization: str,
    features_to_use: list[str] | None = None,
    original_fs: int = 700,
    target_fs: int = 128,
    window_sec: int = 60,
    stride_sec: int = 10,
) -> tuple[tuple[np.ndarray, np.ndarray], np.ndarray]:
    """Raw WESAD pickle -> ((raw [N, C, T], feat [N, F]), start times (s)),
    as training saw them: the raw stream as recording_to_windows makes it;
    the features extracted per window from the unnormalized resampled
    feature sensors (chest ECG, EDA, EMG, Resp, whatever the model's
    channels), failed groups zero-filled, then z-scored with the
    recording's own statistics (normalize_features). Both streams share one
    window grid."""
    full, names = _recording_grid(pkl_path, channels_to_use, original_fs,
                                  target_fs)
    window_samples = window_sec * target_fs
    starts = window_starts(0, full.shape[0], window_samples, stride_sec * target_fs)
    x_raw = _normalized_raw_windows(full, names, channels_to_use, normalization, starts,
                                    window_samples)
    channel_windows = {
        ch: sliding_windows(full[:, names.index(ch)].astype(np.float64), starts,
                            window_samples)
        for ch in FEATURE_SENSOR_CHANNELS
    }
    feats = extract_features_batch(channel_windows, target_fs)
    feats = np.nan_to_num(feats, nan=0.0, posinf=0.0, neginf=0.0)
    if features_to_use:
        feats = feats[:, [FEATURE_NAMES.index(f) for f in features_to_use]]
    y_dummy = np.ones(len(x_raw), dtype=np.int64)
    x_feat = normalize_features(feats, y_dummy, _inference_norm_scheme(normalization))
    return (x_raw, x_feat), starts / target_fs


def hybrid_feature_names(cfg: ExperimentConfig) -> tuple[str, ...]:
    """The feature columns a hybrid_cnn_gru checkpoint expects, in order."""
    return tuple(cfg.features_to_use) or FEATURE_NAMES


def _check_feature_extractor_version(meta: dict) -> None:
    """The features a hybrid model trained on must come from the extractor
    that computes them live here (data/features.py
    FEATURE_EXTRACTOR_VERSION): no stamp warns, another version raises."""
    trained = meta.get("feature_extractor_version")
    if trained is None:
        import warnings

        warnings.warn(
            "hybrid checkpoint carries no feature_extractor_version stamp "
            "(preprocessed before the stamp existed); live features are "
            f"v{FEATURE_EXTRACTOR_VERSION} and may be skewed vs training; "
            "re-preprocess the feature target and retrain to clear this",
            stacklevel=3)
    elif int(trained) != FEATURE_EXTRACTOR_VERSION:
        raise ValueError(
            f"hybrid checkpoint was trained on feature extractor v{trained} but this "
            f"package computes v{FEATURE_EXTRACTOR_VERSION} features live at inference; "
            "re-preprocess the feature target and retrain (or serve with the matching "
            "package version)")


def map_streams(fn, x):
    """fn on a batch: windows, or each stream of a hybrid (windows,
    features) pair."""
    return tuple(fn(a) for a in x) if isinstance(x, (tuple, list)) else fn(x)


def num_windows(x) -> int:
    """Window count of a batch: windows [N, C, T] or a hybrid (windows,
    features) pair."""
    return int((x[0] if isinstance(x, (tuple, list)) else x).shape[0])


def padded_batches(x, batch_size: int):
    """Yield (real windows, batch) over x (windows, or a hybrid pair) in
    batches of exactly batch_size windows, float32, the last zero-padded."""
    x = map_streams(lambda a: np.asarray(a, dtype=np.float32), x)
    for i in range(0, num_windows(x), batch_size):
        xb = map_streams(lambda a: a[i : i + batch_size], x)
        n = num_windows(xb)
        if n < batch_size:
            xb = map_streams(lambda a: np.concatenate(
                [a, np.zeros((batch_size - n,) + a.shape[1:], a.dtype)]), xb)
        yield n, xb


class Predictor:
    """Batched inference for one trained model on one device.

    `variables` is the flax {"params", "batch_stats"} pair (numpy), as
    `read_flax_checkpoint` returns it. For a hybrid_cnn_gru checkpoint a
    batch is the pair (windows [N, C, T], features [N, F]), and
    `feature_names` are its F columns."""

    def __init__(self, cfg: ExperimentConfig, variables: dict,
                 device: str | torch.device = "cuda",
                 original_fs: int = 700, target_fs: int = 128,
                 window_sec: int = 60, stride_sec: int = 10):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.original_fs = original_fs
        self.target_fs = target_fs
        self.window_sec = window_sec
        self.stride_sec = stride_sec
        self.is_hybrid = cfg.model.name == "hybrid_cnn_gru"
        self.feature_names = hybrid_feature_names(cfg) if self.is_hybrid else ()
        self.model = self._build(variables).to(self.device).eval()

    def _build(self, variables: dict) -> torch.nn.Module:
        model = build_model(self.cfg.model, self.cfg.num_classes,
                            len(self.cfg.channels_to_use), len(self.feature_names))
        load_jax_variables(model, variables["params"], variables["batch_stats"])
        return model

    # -- constructors ---------------------------------------------------------
    @classmethod
    def from_cfg_and_checkpoint(cls, cfg: ExperimentConfig, checkpoint: Path | str,
                                preprocess_meta: dict | None = None,
                                device: str | torch.device = "cuda") -> "Predictor":
        """Build from a config + checkpoint file. preprocess_meta carries the
        training-time resample/window/stride so serving replays them (and a
        hybrid run's feature extractor version)."""
        return cls(cfg, read_flax_checkpoint(checkpoint), device=device,
                   **_geometry(cfg, preprocess_meta))

    @classmethod
    def from_files(cls, checkpoint: Path | str, config: Path | str,
                   device: str | torch.device = "cuda") -> "Predictor":
        raw = json.loads(Path(config).read_text())
        cfg = config_from_dict(ExperimentConfig, raw)
        return cls.from_cfg_and_checkpoint(cfg, checkpoint,
                                           raw.get("preprocess_meta"), device)

    @classmethod
    def from_run(cls, run_dir: Path | str, fold: str,
                 device: str | torch.device = "cuda") -> "Predictor":
        run_dir = Path(run_dir)
        return cls.from_files(
            run_dir / f"fold_test_on_{fold}" / "best_model.msgpack",
            run_dir / "config.json", device)

    # -- inference ------------------------------------------------------------
    def windows_from_recording(self, pkl_path: Path | str):
        """Raw WESAD pickle -> normalized [N, C, T] windows (for a hybrid
        model the pair with its [N, F] features) + start times."""
        if self.is_hybrid:
            return recording_to_hybrid_windows(
                pkl_path, list(self.cfg.channels_to_use), self.cfg.normalization,
                list(self.feature_names), self.original_fs, self.target_fs,
                self.window_sec, self.stride_sec)
        return recording_to_windows(
            pkl_path, list(self.cfg.channels_to_use), self.cfg.normalization,
            self.original_fs, self.target_fs, self.window_sec, self.stride_sec,
        )

    def predict_windows(self, x, batch_size: int = 64) -> np.ndarray:
        """[N, C, T] (or the hybrid pair) -> probs [N, num_classes]. Every
        forward takes exactly batch_size windows: the last batch is
        zero-padded."""
        probs = []
        with torch.inference_mode():
            for n, xb in padded_batches(x, batch_size):
                xt = map_streams(lambda a: torch.from_numpy(a).to(self.device), xb)
                probs.append(self.predict_tensor(xt)[:n].cpu().numpy())
        return np.concatenate(probs, axis=0)

    def predict_tensor(self, x) -> torch.Tensor:
        """Windows [B, C, T] (or the hybrid pair) on the device -> softmax
        [B, K]."""
        return torch.softmax(self.model(x), dim=-1)

    def predict_recording(self, pkl_path: Path | str) -> PredictionResult:
        x, starts_sec = self.windows_from_recording(pkl_path)
        probs = self.predict_windows(x)
        return PredictionResult(
            starts_sec=starts_sec,
            labels=probs.argmax(axis=-1),
            probs=probs,
            class_names=CLASS_NAMES[self.cfg.classification_mode],
        )


def _geometry(cfg: ExperimentConfig, meta: dict | None) -> dict:
    """Predictor's resample/window/stride arguments from a run's
    preprocess meta; for a hybrid run, its feature extractor stamp is
    checked first."""
    meta = meta or {}
    if cfg.model.name == "hybrid_cnn_gru":
        _check_feature_extractor_version(meta)
    return dict(original_fs=int(meta.get("original_fs", 700)),
                target_fs=int(meta.get("fs", 128)),
                window_sec=int(meta.get("window_sec", 60)),
                stride_sec=int(meta.get("stride_sec", 10)))


class EnsemblePredictor(Predictor):
    """Every fold checkpoint of a LOSO run as the lanes of one
    FoldStackedModel (counterpart of the JAX package's EnsemblePredictor):
    each batch of windows goes to all F lanes and the softmax is averaged
    over folds. `variables` is the stacked flax pair (leaves [F, ...]),
    `fold_names` the held-out subject of each lane."""

    def __init__(self, cfg: ExperimentConfig, variables: dict, fold_names,
                 device: str | torch.device = "cuda", **geometry):
        self.fold_names = tuple(fold_names)
        super().__init__(cfg, variables, device, **geometry)

    def _build(self, variables: dict) -> torch.nn.Module:
        model = build_fold_model(self.cfg.model, self.cfg.num_classes,
                                 len(self.cfg.channels_to_use), len(self.fold_names),
                                 num_features=len(self.feature_names))
        load_jax_variables(model, variables["params"], variables["batch_stats"])
        return model

    def predict_tensor(self, x) -> torch.Tensor:
        # every lane sees the batch: [F, B, ...] views, no copy
        lanes = map_streams(lambda a: a.expand((self.model.folds,) + tuple(a.shape)), x)
        return torch.softmax(self.model(lanes), dim=-1).mean(dim=0)

    @classmethod
    def from_run(cls, run_dir: Path | str, fold: str = "all",
                 device: str | torch.device = "cuda") -> Predictor:
        """fold="all": the ensemble of every fold_test_on_*/best_model.msgpack,
        in sorted order; a subject id: that fold's Predictor alone."""
        if fold != "all":
            return Predictor.from_run(run_dir, fold, device)
        run_dir = Path(run_dir)
        ckpts = sorted(run_dir.glob("fold_test_on_*/best_model.msgpack"))
        if not ckpts:
            raise FileNotFoundError(f"no fold_test_on_*/best_model.msgpack under {run_dir}")
        raw = json.loads((run_dir / "config.json").read_text())
        cfg = config_from_dict(ExperimentConfig, raw)
        return cls(cfg, stack_variables([read_flax_checkpoint(c) for c in ckpts]),
                   tuple(c.parent.name.removeprefix("fold_test_on_") for c in ckpts),
                   device, **_geometry(cfg, raw.get("preprocess_meta")))


class HierarchicalPredictor:
    """Composed two-stage ternary inference from one fold of a hierarchical
    run (counterpart of the JAX package's HierarchicalPredictor; reference
    main.py:159-247).

    M1 (stress vs non-stress) and M2 (amusement vs baseline) each see their
    own channels of union-channel windows. Labels are the reference's hard
    gate (main.py:241-244): stress where M1 says stress, else M2's class.
    Probabilities are the product rule [p1(non) p2(base), p1(non) p2(fun),
    p1(stress)]; their argmax can differ from the gated label near M1's
    boundary."""

    def __init__(self, m1: Predictor, m2: Predictor):
        self.m1, self.m2 = m1, m2
        union, i1, i2 = union_channel_indices(m1.cfg.channels_to_use, m2.cfg.channels_to_use)
        self.channels = tuple(union)
        self.device = m1.device
        self._i1 = torch.tensor(i1, device=self.device)
        self._i2 = torch.tensor(i2, device=self.device)
        self.class_names = CLASS_NAMES["ternary"]
        # Geometry and normalization travel with the stages (one run).
        self.original_fs = m1.original_fs
        self.target_fs = m1.target_fs
        self.window_sec = m1.window_sec
        self.stride_sec = m1.stride_sec
        self.normalization = m1.cfg.normalization

    @classmethod
    def from_run(cls, run_dir: Path | str, fold: str,
                 device: str | torch.device = "cuda") -> "HierarchicalPredictor":
        """One fold's M1 and M2 checkpoints of a hierarchical run directory
        (serial or sharded: fold_test_on_<fold>/model_m{1,2}/)."""
        import dataclasses

        run_dir = Path(run_dir)
        raw = json.loads((run_dir / "config.json").read_text())
        hcfg = config_from_dict(HierarchicalConfig, raw)
        meta = raw.get("preprocess_meta")
        fold_dir = run_dir / f"fold_test_on_{fold}"

        def stage(channels, model_cfg, mode, sub):
            cfg = dataclasses.replace(hcfg.base, channels_to_use=tuple(channels),
                                      model=model_cfg, classification_mode=mode,
                                      num_classes=2)
            return Predictor.from_cfg_and_checkpoint(
                cfg, fold_dir / sub / "best_model.msgpack", meta, device)

        return cls(stage(hcfg.m1_channels, hcfg.m1_model, "stress_binary", "model_m1"),
                   stage(hcfg.m2_channels, hcfg.m2_model, "amusement_binary", "model_m2"))

    def windows_from_recording(self, pkl_path: Path | str) -> tuple[np.ndarray, np.ndarray]:
        return recording_to_windows(
            pkl_path, list(self.channels), self.normalization, self.original_fs,
            self.target_fs, self.window_sec, self.stride_sec)

    def predict_tensor(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """x [B, C_union, T] on the device -> (product probs [B, 3], gated
        labels [B])."""
        p1 = torch.softmax(self.m1.model(x.index_select(1, self._i1)), dim=-1)
        p2 = torch.softmax(self.m2.model(x.index_select(1, self._i2)), dim=-1)
        probs = torch.stack([p1[:, 0] * p2[:, 0], p1[:, 0] * p2[:, 1], p1[:, 1]], dim=-1)
        labels = torch.where(p1.argmax(dim=-1) == 1, 2, p2.argmax(dim=-1))
        return probs, labels

    def predict_windows_labeled(self, x: np.ndarray, batch_size: int = 64
                                ) -> tuple[np.ndarray, np.ndarray]:
        """[N, C_union, T] -> (product probs [N, 3], gated labels [N]); every
        forward takes exactly batch_size windows, the last zero-padded."""
        probs, labels = [], []
        with torch.inference_mode():
            for n, xb in padded_batches(x, batch_size):
                p, lab = self.predict_tensor(torch.from_numpy(xb).to(self.device))
                probs.append(p[:n].cpu().numpy())
                labels.append(lab[:n].cpu().numpy())
        return np.concatenate(probs), np.concatenate(labels)

    def predict_windows(self, x: np.ndarray, batch_size: int = 64) -> np.ndarray:
        return self.predict_windows_labeled(x, batch_size)[0]

    def predict_recording(self, pkl_path: Path | str) -> PredictionResult:
        x, starts_sec = self.windows_from_recording(pkl_path)
        probs, labels = self.predict_windows_labeled(x)
        return PredictionResult(starts_sec=starts_sec, labels=labels, probs=probs,
                                class_names=self.class_names)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--checkpoint", help="one fold's best_model.msgpack")
    p.add_argument("--config", help="the run's config.json")
    p.add_argument("--run-dir", help="run directory; replaces --checkpoint/--config")
    p.add_argument("--fold", default="all",
                   help="with --run-dir: a subject id, or 'all' for the fold "
                        "ensemble (default); a hierarchical run needs a subject id")
    p.add_argument("--pkl", required=True, help="raw WESAD S*.pkl recording")
    p.add_argument("--out", default=None, help="write JSON here (default stdout)")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda)")
    args = p.parse_args(argv)
    if args.run_dir:
        if args.checkpoint or args.config:
            p.error("--run-dir replaces --checkpoint/--config")
        raw = json.loads((Path(args.run_dir) / "config.json").read_text())
        if "m1_channels" in raw:   # a hierarchical run: the composed two stages
            if args.fold == "all":
                p.error("hierarchical runs need --fold <subject> "
                        "(per-fold M1+M2 composition)")
            predictor = HierarchicalPredictor.from_run(args.run_dir, args.fold, args.device)
        else:
            predictor = EnsemblePredictor.from_run(args.run_dir, args.fold, args.device)
    elif args.checkpoint and args.config:
        predictor = Predictor.from_files(args.checkpoint, args.config, args.device)
    else:
        p.error("provide --run-dir, or --checkpoint with --config")
    result = predictor.predict_recording(args.pkl)
    text = result.to_json()
    if args.out:
        Path(args.out).write_text(text)
        counts = np.bincount(result.labels, minlength=len(result.class_names))
        print(f"Wrote {len(result.labels)} window predictions to {args.out}")
        for name, c in zip(result.class_names, counts):
            print(f"  {name}: {int(c)}")
    else:
        print(text)


if __name__ == "__main__":
    main()
