"""Serial LOSO cross-validation (counterpart of
multimodalsignal_tpu/experiments/loso.py).

For each held-out subject: assemble the train, validation and test sets,
train a fresh model with the port's Trainer, evaluate it on the held-out
subject, and finally write the mean and spread of accuracy and weighted F1
to `cv_summary.txt` with the config echoed above them. The run directory
holds `config.json` (readable by both packages' `config_from_dict`),
`cv_summary.txt` and, per fold, `fold_test_on_<subject>/` with the
Trainer's artifacts (`training_log.txt`, `best_model.msgpack`,
`test_probs.npy`, the confusion matrix where matplotlib imports).

A hybrid_cnn_gru run reads the raw-align and feature targets
(`raw_align_path`, `feature_path`) and trains on (windows, features) pairs
(data/dataset.py build_hybrid_dataset).

Each fold's model is initialised from torch's generator seeded with
`cfg.seed`, so every fold starts from the same weights, as every fold of the
JAX package starts from PRNGKey(seed); the two packages' initial weights
differ. Runs on "cuda" unless the caller passes device="cpu".
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from multimodalsignal_tpu_torch.config import (
    ExperimentConfig,
    config_to_dict,
    save_config,
    validate_experiment,
)
from multimodalsignal_tpu_torch.data.dataset import (
    HybridWindowDataset,
    WindowDataset,
    build_dataset,
    build_hybrid_dataset,
    experiment_preprocess_meta,
    read_channel_names,
)
from multimodalsignal_tpu_torch.experiments.predict import hybrid_feature_names, resolve_device
from multimodalsignal_tpu_torch.experiments.splits import loso_folds
from multimodalsignal_tpu_torch.models.cnn_gru import build_model
from multimodalsignal_tpu_torch.train.trainer import Trainer


@dataclass
class FoldResult:
    subject: str
    accuracy: float
    f1_score: float
    test_loss: float = float("nan")
    best_epoch: int = -1
    epochs_run: int = -1
    wall_s: float = float("nan")


def summarize_results(results: list[FoldResult]) -> dict:
    accs = np.array([r.accuracy for r in results])
    f1s = np.array([r.f1_score for r in results])
    return {
        "mean_accuracy": float(accs.mean()),
        "std_accuracy": float(accs.std()),
        "mean_f1": float(f1s.mean()),
        "std_f1": float(f1s.std()),
        "num_folds": len(results),
    }


def write_cv_summary(path: Path, cfg: ExperimentConfig, results: list[FoldResult]) -> dict:
    """cv_summary.txt: the config echo, the per-fold table and mean ± std,
    in the JAX package's text."""
    summary = summarize_results(results)
    lines = ["Experiment config:"]
    for key, value in config_to_dict(cfg).items():
        lines.append(f"{key}: {value}")
    lines.append("")
    lines.append("Per-fold results:")
    for r in results:
        extra = ""
        if r.epochs_run >= 0:
            extra = f" (epochs: {r.epochs_run}, best: {r.best_epoch}"
            extra += f", test loss: {r.test_loss:.4f}" if np.isfinite(r.test_loss) else ""
            extra += f", {r.wall_s:.1f}s" if np.isfinite(r.wall_s) else ""
            extra += ")"
        lines.append(f"  - test {r.subject}: Accuracy = {r.accuracy:.4f}, "
                     f"F1-score = {r.f1_score:.4f}{extra}")
    lines.append("")
    lines.append("Final mean performance:")
    lines.append(
        f"Mean accuracy: {summary['mean_accuracy']:.4f} ± {summary['std_accuracy']:.4f}")
    lines.append(f"Mean weighted F1: {summary['mean_f1']:.4f} ± {summary['std_f1']:.4f}")
    path.write_text("\n".join(lines) + "\n")
    return summary


def balanced_class_weights(y: np.ndarray, num_classes: int) -> np.ndarray:
    """sklearn's compute_class_weight('balanced'): n / (K * count), a class
    with no sample counted as one."""
    counts = np.bincount(y, minlength=num_classes).astype(np.float64)
    counts = np.maximum(counts, 1.0)
    return (len(y) / (num_classes * counts)).astype(np.float32)


def run_simple_experiment(cfg: ExperimentConfig, run_output_dir: Path | str,
                          all_channel_names: list[str] | None = None,
                          device: str | torch.device = "cuda",
                          ) -> tuple[list[FoldResult], dict]:
    """Run the whole LOSO sweep serially; returns (per-fold results, summary)."""
    device = resolve_device(device)
    run_output_dir = Path(run_output_dir)
    run_output_dir.mkdir(parents=True, exist_ok=True)
    validate_experiment(cfg, fold_execution="serial")
    hybrid = cfg.model.name == "hybrid_cnn_gru"
    raw_path = cfg.raw_align_path if hybrid else cfg.data_path
    save_config(cfg, run_output_dir / "config.json",
                extra={"preprocess_meta": experiment_preprocess_meta(cfg)})
    if all_channel_names is None:
        all_channel_names = read_channel_names(raw_path)

    print("=" * 80)
    print(f"LOSO experiment (mode: {cfg.classification_mode}, "
          f"folds: {len(cfg.subjects)}, execution: serial, device: {device}"
          f"{', hybrid raw+feature' if hybrid else ''})")
    print("=" * 80)

    def build_one(sid: str):
        if hybrid:
            return build_hybrid_dataset(
                cfg.raw_align_path, cfg.feature_path, [sid], list(cfg.channels_to_use),
                all_channel_names, list(cfg.features_to_use) or None,
                cfg.classification_mode, cfg.normalization)
        return build_dataset(cfg.data_path, [sid], list(cfg.channels_to_use),
                             all_channel_names, cfg.classification_mode, cfg.normalization)

    # Normalization is per subject, so each subject loads and normalizes
    # once and the folds assemble by concatenation, in build_dataset's order.
    cache: dict[str, WindowDataset | HybridWindowDataset | None] = {}

    def cached(sid: str):
        if sid not in cache:
            try:
                cache[sid] = build_one(sid)
            except ValueError:
                # Only missing subject files are skippable (the loader
                # warned); configuration errors propagate.
                if (Path(raw_path) / f"{sid}_X.npy").exists():
                    raise
                cache[sid] = None
        return cache[sid]

    def make_ds(subjects):
        parts = [p for p in (cached(s) for s in subjects) if p is not None]
        if not parts:
            raise ValueError(f"No data loaded for subjects: {subjects}.")
        if len(parts) == 1:
            return parts[0]
        joined = dict(y=np.concatenate([p.y for p in parts]),
                      subjects=tuple(s for p in parts for s in p.subjects))
        if hybrid:
            return HybridWindowDataset(x_raw=np.concatenate([p.x_raw for p in parts]),
                                       x_feat=np.concatenate([p.x_feat for p in parts]),
                                       **joined)
        return WindowDataset(x=np.concatenate([p.x for p in parts]), **joined)

    results: list[FoldResult] = []
    for fold in loso_folds(cfg.subjects, cfg.val_fraction, cfg.seed):
        t0 = time.time()
        print(f"\n--- Fold: test subject {fold.test_subject} ---")
        fold_dir = run_output_dir / f"fold_test_on_{fold.test_subject}"
        fold_dir.mkdir(parents=True, exist_ok=True)
        train_ds = make_ds(list(fold.train_subjects))
        val_ds = make_ds(list(fold.val_subjects))
        test_ds = make_ds([fold.test_subject])
        class_weights = (balanced_class_weights(train_ds.y, cfg.num_classes)
                         if cfg.trainer.use_class_weights else None)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(cfg.seed)
            model = build_model(cfg.model, cfg.num_classes, len(cfg.channels_to_use),
                                len(hybrid_feature_names(cfg)))
        trainer = Trainer(model, fold_dir, cfg.trainer, cfg.num_classes, seed=cfg.seed,
                          class_weights=class_weights, device=device)
        trainer.train(train_ds, val_ds)
        test_loss, test_acc, test_f1 = trainer.evaluate(test_ds, is_test=True)
        results.append(FoldResult(
            subject=fold.test_subject,
            accuracy=test_acc,
            f1_score=test_f1,
            test_loss=test_loss,
            # As the JAX package records it: the last epoch run.
            best_epoch=(trainer.history[-1].epoch if trainer.history else -1),
            epochs_run=len(trainer.history),
            wall_s=time.time() - t0,
        ))

    summary = write_cv_summary(run_output_dir / "cv_summary.txt", cfg, results)
    print("\n--- Final mean performance ---")
    print(f"Mean accuracy: {summary['mean_accuracy']:.4f} ± {summary['std_accuracy']:.4f}")
    print(f"Mean weighted F1: {summary['mean_f1']:.4f} ± {summary['std_f1']:.4f}")
    print(f"Summary saved to: {run_output_dir / 'cv_summary.txt'}")
    return results, summary
