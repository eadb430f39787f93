"""Hierarchical two-stage ternary classification, one fold after another
(counterpart of multimodalsignal_tpu/experiments/hierarchical.py).

Per LOSO fold: train M1 (stress vs non-stress, mode `stress_binary`) and M2
(amusement vs baseline, mode `amusement_binary`) with the port's Trainer
under fold_test_on_<subject>/model_m{1,2}/, evaluate M1 alone on the
held-out subject, then compose ternary predictions on the union-channel
test windows: Stress (2) where M1 says stress, else M2's Fun (1) / Base
(0). A fold whose M2 has no training or validation windows, or whose
held-out subject has no ternary windows, is skipped, as in the JAX
package. `hierarchical_summary.txt` holds the JAX package's text: the
per-fold table and the window-level composed accuracy, F1 and confusion
matrix over every fold.

The union channel list keeps order (M1's channels, then M2's that M1 does
not have). Each stage's model starts from torch's generator seeded with
`base.seed`, as experiments/loso.py's folds do. Runs on "cuda" unless the
caller passes device="cpu".
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from multimodalsignal_tpu_torch.config import (
    HierarchicalConfig,
    ModelConfig,
    save_config,
    union_channel_indices,
)
from multimodalsignal_tpu_torch.data.dataset import (
    build_dataset,
    read_channel_names,
    read_preprocess_meta,
)
from multimodalsignal_tpu_torch.experiments.predict import resolve_device
from multimodalsignal_tpu_torch.experiments.splits import loso_folds
from multimodalsignal_tpu_torch.models.cnn_gru import build_model
from multimodalsignal_tpu_torch.train import metrics as M
from multimodalsignal_tpu_torch.train.trainer import Trainer


@dataclass
class HierarchicalFoldResult:
    subject: str
    m1_accuracy: float
    m1_f1: float
    composed_accuracy: float
    composed_f1: float
    num_test_windows: int
    wall_s: float


def composed_predict(model_m1, model_m2, m1_idx: torch.Tensor, m2_idx: torch.Tensor,
                     x: torch.Tensor) -> torch.Tensor:
    """Ternary labels of union-channel windows x [..., B, C_union, T]: each
    stage sees its own channels (indices on x's device), both argmax, and
    the label is 2 where M1 says stress, else M2's class (reference
    main.py:237-244). Works for single-fold models ([B, C, T]) and
    FoldStackedModels ([F, B, C, T]) alike; call it in eval mode."""
    p1 = model_m1(x.index_select(-2, m1_idx)).argmax(dim=-1)
    p2 = model_m2(x.index_select(-2, m2_idx)).argmax(dim=-1)
    return torch.where(p1 == 1, 2, p2)


def _seeded_model(model_cfg: ModelConfig, seed: int, in_channels: int):
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return build_model(model_cfg, 2, in_channels)


def run_hierarchical_experiment(cfg: HierarchicalConfig, run_output_dir: Path | str,
                                all_channel_names: list[str] | None = None,
                                device: str | torch.device = "cuda",
                                ) -> tuple[list[HierarchicalFoldResult], dict]:
    """The two-stage experiment, fold after fold; returns (per-fold
    results, summary)."""
    device = resolve_device(device)
    base = cfg.base
    run_output_dir = Path(run_output_dir)
    run_output_dir.mkdir(parents=True, exist_ok=True)
    save_config(cfg, run_output_dir / "config.json",
                extra={"preprocess_meta": read_preprocess_meta(base.data_path)})
    if all_channel_names is None:
        all_channel_names = read_channel_names(base.data_path)

    print("=" * 80)
    print("Hierarchical two-stage experiment (M1 stress | M2 amusement)")
    print("=" * 80)

    union, m1_idx, m2_idx = union_channel_indices(cfg.m1_channels, cfg.m2_channels)
    i1 = torch.tensor(m1_idx, device=device)
    i2 = torch.tensor(m2_idx, device=device)
    batch = base.trainer.batch_size

    def _ds(subjects, channels, mode):
        return build_dataset(base.data_path, list(subjects), list(channels),
                             all_channel_names, mode, base.normalization)

    results: list[HierarchicalFoldResult] = []
    all_preds: list[np.ndarray] = []
    all_true: list[np.ndarray] = []
    for fold in loso_folds(base.subjects, base.val_fraction, base.seed):
        t0 = time.time()
        print(f"\n--- Fold: test subject {fold.test_subject} ---")
        fold_dir = run_output_dir / f"fold_test_on_{fold.test_subject}"

        print("--- Stage 1: train stress vs non-stress classifier (M1) ---")
        m1_train = _ds(fold.train_subjects, cfg.m1_channels, "stress_binary")
        m1_val = _ds(fold.val_subjects, cfg.m1_channels, "stress_binary")
        trainer_m1 = Trainer(_seeded_model(cfg.m1_model, base.seed, len(cfg.m1_channels)),
                             fold_dir / "model_m1", base.trainer, 2, seed=base.seed,
                             device=device)
        trainer_m1.train(m1_train, m1_val)

        print("--- Stage 2: train amusement vs baseline classifier (M2) ---")
        m2_train = _ds(fold.train_subjects, cfg.m2_channels, "amusement_binary")
        m2_val = _ds(fold.val_subjects, cfg.m2_channels, "amusement_binary")
        if len(m2_train) == 0 or len(m2_val) == 0:
            print("Warning: no amusement_binary data for this fold; skipping.")
            continue
        trainer_m2 = Trainer(_seeded_model(cfg.m2_model, base.seed, len(cfg.m2_channels)),
                             fold_dir / "model_m2", base.trainer, 2, seed=base.seed,
                             device=device)
        trainer_m2.train(m2_train, m2_val)

        m1_test = _ds([fold.test_subject], cfg.m1_channels, "stress_binary")
        _, m1_acc, m1_f1 = trainer_m1.evaluate(m1_test, is_test=True)
        print(f"M1 on {fold.test_subject}: acc = {m1_acc:.4f}, F1 = {m1_f1:.4f}")

        test_ternary = _ds([fold.test_subject], union, "ternary")
        if len(test_ternary) == 0:
            print(f"Warning: no ternary test data for {fold.test_subject}.")
            continue
        models = (trainer_m1.model.eval(), trainer_m2.model.eval())
        preds = []
        with torch.inference_mode():
            for i in range(0, len(test_ternary), batch):
                xb = torch.from_numpy(test_ternary.x[i:i + batch]).to(device)
                preds.append(composed_predict(*models, i1, i2, xb).cpu().numpy())
        preds = np.concatenate(preds)
        true = test_ternary.y
        cm = M.confusion_matrix(torch.from_numpy(true.astype(np.int64)),
                                torch.from_numpy(preds), 3)
        comp_acc = float(M.accuracy_from_cm(cm))
        comp_f1 = float(M.weighted_f1_from_cm(cm))
        print(f"Composed ternary on {fold.test_subject}: "
              f"acc = {comp_acc:.4f}, F1 = {comp_f1:.4f}")
        all_preds.append(preds)
        all_true.append(true)
        results.append(HierarchicalFoldResult(
            subject=fold.test_subject, m1_accuracy=m1_acc, m1_f1=m1_f1,
            composed_accuracy=comp_acc, composed_f1=comp_f1,
            num_test_windows=len(true), wall_s=time.time() - t0))

    summary = _write_summary(run_output_dir, results, all_preds, all_true)
    return results, summary


def summary_numbers(results: list[HierarchicalFoldResult], cm: torch.Tensor) -> dict:
    """The summary's numbers: window-level accuracy and F1 of the overall
    confusion matrix, and the per-fold means."""
    return {
        "num_folds": len(results),
        "overall_accuracy": float(M.accuracy_from_cm(cm)),
        "overall_f1": float(M.weighted_f1_from_cm(cm)),
        "mean_m1_accuracy": float(np.mean([r.m1_accuracy for r in results])),
        "mean_composed_accuracy": float(np.mean([r.composed_accuracy for r in results])),
        "std_composed_accuracy": float(np.std([r.composed_accuracy for r in results])),
        "mean_composed_f1": float(np.mean([r.composed_f1 for r in results])),
    }


def summary_lines(title: str, results: list[HierarchicalFoldResult], summary: dict,
                  cm_text: str) -> list[str]:
    """hierarchical_summary.txt's lines (the serial and the sharded text
    differ in the title only)."""
    lines = [title, "", "Per-fold results:"]
    for r in results:
        lines.append(
            f"  - test {r.subject}: M1 acc = {r.m1_accuracy:.4f} | "
            f"composed acc = {r.composed_accuracy:.4f}, F1 = {r.composed_f1:.4f} "
            f"({r.num_test_windows} windows)")
    return lines + [
        "",
        f"Overall window-level accuracy: {summary['overall_accuracy']:.4f}",
        f"Overall window-level weighted F1: {summary['overall_f1']:.4f}",
        f"Mean composed accuracy: {summary['mean_composed_accuracy']:.4f} "
        f"± {summary['std_composed_accuracy']:.4f}",
        "",
        "Overall confusion matrix (rows=true, cols=pred; 0=Base, 1=Fun, 2=Stress):",
        cm_text,
    ]


def _write_summary(run_dir: Path, results, all_preds, all_true) -> dict:
    """Overall (window-level) and per-fold composed metrics."""
    if not results:
        (run_dir / "hierarchical_summary.txt").write_text("No folds completed.\n")
        return {"num_folds": 0}
    cm = M.confusion_matrix(torch.from_numpy(np.concatenate(all_true).astype(np.int64)),
                            torch.from_numpy(np.concatenate(all_preds)), 3)
    summary = summary_numbers(results, cm)
    lines = summary_lines("Hierarchical experiment summary", results, summary,
                          str(cm.numpy().astype(int)))
    (run_dir / "hierarchical_summary.txt").write_text("\n".join(lines) + "\n")
    print(f"\nHierarchical summary saved to: {run_dir / 'hierarchical_summary.txt'}")
    return summary
