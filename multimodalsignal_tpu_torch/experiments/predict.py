"""Inference: load a trained fold checkpoint and classify a raw recording.

Counterpart of multimodalsignal_tpu/experiments/predict.py for one CnnGru /
CnnGruAttention checkpoint written by the JAX package:

    python -m multimodalsignal_tpu_torch.experiments.predict \\
        --checkpoint output/.../fold_test_on_S2/best_model.msgpack \\
        --config output/.../config.json \\
        --pkl WESAD/S16/S16.pkl --out predictions.json [--device cuda]

or programmatically::

    predictor = Predictor.from_run(run_dir, fold="S2")      # on the GPU
    result = predictor.predict_recording(pkl_path)

Pipeline per recording: resample 700 -> 128 Hz, slide 60 s / 10 s windows
over the whole recording, normalize with the recording's own statistics,
then forward in batches zero-padded to a fixed size. Inference runs on
"cuda" unless the caller passes device="cpu"; asking for CUDA where there is
none raises. The fold ensemble, hierarchical and hybrid predictors are not
ported yet (ROADMAP.md).
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
    ExperimentConfig,
    config_from_dict,
)
from multimodalsignal_tpu_torch.data.dataset import normalize_subject
from multimodalsignal_tpu_torch.data.resample import resample_signal
from multimodalsignal_tpu_torch.data.wesad_io import chest_signals, load_pkl
from multimodalsignal_tpu_torch.data.windowing import sliding_windows, window_starts
from multimodalsignal_tpu_torch.models.cnn_gru import build_model
from multimodalsignal_tpu_torch.models.convert import load_jax_variables
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
    """Raw WESAD pickle -> resampled 8-channel chest grid [T', 8] + names."""
    if any(ch not in ALL_CHANNEL_NAMES for ch in channels_to_use):
        raise NotImplementedError(
            "wrist channels are not ported yet (ROADMAP.md, queue 1: "
            "preprocessing)")
    chest = chest_signals(load_pkl(pkl_path))
    cols = []
    for sensor in CHEST_SENSORS:
        sig = np.asarray(chest[sensor])
        if sig.ndim == 1:
            sig = sig[:, None]
        cols.append(resample_signal(sig, original_fs, target_fs))
    return np.concatenate(cols, axis=1), list(ALL_CHANNEL_NAMES)


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
    ch_idx = [names.index(ch) for ch in channels_to_use]
    win = sliding_windows(full[:, ch_idx].astype(np.float32), starts,
                          window_samples)  # [N, T, C]
    y_dummy = np.ones(len(win), dtype=np.int64)
    win = normalize_subject(win, y_dummy, list(channels_to_use),
                            _inference_norm_scheme(normalization))
    return np.ascontiguousarray(win.transpose(0, 2, 1)), starts / target_fs


class Predictor:
    """Batched inference for one trained model on one device.

    `variables` is the flax {"params", "batch_stats"} pair (numpy), as
    `read_flax_checkpoint` returns it."""

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
        self.model = build_model(cfg.model, cfg.num_classes,
                                 in_channels=len(cfg.channels_to_use))
        load_jax_variables(self.model, variables["params"],
                           variables["batch_stats"])
        self.model.to(self.device).eval()

    # -- constructors ---------------------------------------------------------
    @classmethod
    def from_cfg_and_checkpoint(cls, cfg: ExperimentConfig, checkpoint: Path | str,
                                preprocess_meta: dict | None = None,
                                device: str | torch.device = "cuda") -> "Predictor":
        """Build from a config + checkpoint file. preprocess_meta carries the
        training-time resample/window/stride so serving replays them."""
        meta = preprocess_meta or {}
        return cls(
            cfg, read_flax_checkpoint(checkpoint), device=device,
            original_fs=int(meta.get("original_fs", 700)),
            target_fs=int(meta.get("fs", 128)),
            window_sec=int(meta.get("window_sec", 60)),
            stride_sec=int(meta.get("stride_sec", 10)),
        )

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
        """Raw WESAD pickle -> normalized [N, C, T] windows + start times."""
        return recording_to_windows(
            pkl_path, list(self.cfg.channels_to_use), self.cfg.normalization,
            self.original_fs, self.target_fs, self.window_sec, self.stride_sec,
        )

    def predict_windows(self, x: np.ndarray, batch_size: int = 64) -> np.ndarray:
        """[N, C, T] -> probs [N, num_classes]. Every forward takes exactly
        batch_size windows: the last batch is zero-padded."""
        x = np.asarray(x, dtype=np.float32)
        probs = []
        with torch.inference_mode():
            for i in range(0, len(x), batch_size):
                xb = x[i : i + batch_size]
                n = len(xb)
                if n < batch_size:
                    xb = np.concatenate(
                        [xb, np.zeros((batch_size - n,) + xb.shape[1:], xb.dtype)])
                logits = self.model(torch.from_numpy(xb).to(self.device))
                probs.append(torch.softmax(logits, dim=-1)[:n].cpu().numpy())
        return np.concatenate(probs, axis=0)

    def predict_recording(self, pkl_path: Path | str) -> PredictionResult:
        x, starts_sec = self.windows_from_recording(pkl_path)
        probs = self.predict_windows(x)
        return PredictionResult(
            starts_sec=starts_sec,
            labels=probs.argmax(axis=-1),
            probs=probs,
            class_names=CLASS_NAMES[self.cfg.classification_mode],
        )


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--checkpoint", help="one fold's best_model.msgpack")
    p.add_argument("--config", help="the run's config.json")
    p.add_argument("--run-dir", help="run directory (with --fold)")
    p.add_argument("--fold", default=None,
                   help="with --run-dir: the subject id of the fold to load")
    p.add_argument("--pkl", required=True, help="raw WESAD S*.pkl recording")
    p.add_argument("--out", default=None, help="write JSON here (default stdout)")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda)")
    args = p.parse_args(argv)
    if args.run_dir:
        if args.checkpoint or args.config:
            p.error("--run-dir replaces --checkpoint/--config")
        if args.fold in (None, "all"):
            p.error("the fold ensemble is not ported yet (ROADMAP.md, queue 1: "
                    "EnsemblePredictor); give --fold <subject>")
        predictor = Predictor.from_run(args.run_dir, args.fold, args.device)
    elif args.checkpoint and args.config:
        predictor = Predictor.from_files(args.checkpoint, args.config, args.device)
    else:
        p.error("provide --checkpoint with --config, or --run-dir with --fold")
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
