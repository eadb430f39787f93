"""Sharded hierarchical experiment on one GPU: two fold sweeps and a composed
evaluation with every fold a lane (counterpart of
multimodalsignal_tpu/parallel/hierarchical_sweep.py).

The serial path (experiments/hierarchical.py) trains 2 models x F folds one
at a time. Here it is two sweeps of parallel/fold_sweep.py, M1 (stress vs
non-stress) and M2 (amusement vs baseline), each with its own ModelConfig
and channels, then one composed ternary evaluation: both stages' best
states as the lanes of two FoldStackedModels, every fold's test windows of
the union-channel `ternary` corpus in sequential batches, each stage
reading its channels of the batch, M2 gated by M1 (reference
main.py:237-244); the result is one confusion matrix per fold. The three
corpora hold the same subjects (a subject whose amusement windows are all
filtered out stays with an empty pool), so their folds are the same lanes.

Each fold's M1 and M2 are written as fold_test_on_<subject>/model_m{1,2}/
best_model.msgpack in the serial layout, so the hierarchical predictor
(experiments/predict.py HierarchicalPredictor) and the JAX package's read
sharded runs too, and hierarchical_summary.txt in the JAX package's
sharded text. With base.from_pickles the three corpora are packed from the
pickles through one subject cache, so each pickle is preprocessed once.
Runs on "cuda" unless the caller passes device="cpu".

Under several processes (parallel/multihost.py) both sweeps split their
folds into the same rank blocks (fold_sweep.rank_block), so each rank
holds both stages of its folds and runs their composed evaluation; the
ranks gather the confusion matrices, and only the primary writes and
prints.
"""

from __future__ import annotations

import dataclasses
import time
from pathlib import Path

import numpy as np
import torch

from multimodalsignal_tpu_torch.config import HierarchicalConfig, save_config, union_channel_indices
from multimodalsignal_tpu_torch.data.dataset import (
    PackedCorpus,
    from_pickles_meta,
    pack_corpus,
    pack_corpus_from_pickles,
    read_channel_names,
    read_preprocess_meta,
)
from multimodalsignal_tpu_torch.experiments.hierarchical import (
    HierarchicalFoldResult,
    composed_predict,
    summary_lines,
    summary_numbers,
)
from multimodalsignal_tpu_torch.experiments.predict import resolve_device
from multimodalsignal_tpu_torch.models.convert import lane_variables, load_jax_variables
from multimodalsignal_tpu_torch.models.fold_stack import build_fold_model
from multimodalsignal_tpu_torch.parallel import multihost
from multimodalsignal_tpu_torch.parallel.fold_sweep import (
    FoldBatch,
    _stack_grids,
    build_fold_batch,
    corpus_tensor,
    grid_steps,
    rank_block,
    run_fold_sweep,
    sequential_grid,
    take_lanes,
)
from multimodalsignal_tpu_torch.train import metrics as M
from multimodalsignal_tpu_torch.train.checkpoints import write_initial_train_state


def composed_fold_cms(corpus: PackedCorpus, fb: FoldBatch, stages, batch_size: int,
                      device: str | torch.device = "cuda",
                      block: tuple[int, int] | None = None) -> np.ndarray:
    """Every fold's composed ternary confusion matrix [F, 3, 3] over its
    test pool of the union-channel corpus. `stages` is (M1, M2), each a
    (ModelConfig, stacked flax variables [F, ...], channel indices into
    the corpus's channels) triple whose lane f is fold f of `fb`. With
    `block` (lo, hi), only folds lo..hi-1, in the whole run's batches."""
    device = resolve_device(device)
    steps = grid_steps(fb.n_test, batch_size)
    if block is not None:
        fb = take_lanes(fb, *block)
    folds = len(fb.test_subjects)
    models, idx = [], []
    for model_cfg, variables, channels in stages:
        if block is not None:
            variables = take_lanes(variables, *block)
        model = build_fold_model(model_cfg, 2, len(channels), folds)
        load_jax_variables(model, variables["params"], variables["batch_stats"])
        models.append(model.to(device).eval())
        idx.append(torch.tensor(channels, device=device))
    x, y, _ = corpus.flat()
    x = corpus_tensor(x, np.float32, device)
    y = corpus_tensor(y, np.int64, device)
    rows, weights = (torch.from_numpy(a).to(device) for a in _stack_grids(
        sequential_grid(fb.test_pool[f], fb.n_test[f], steps, batch_size)
        for f in range(folds)))
    cm = torch.zeros((folds, 3, 3), device=device)
    with torch.inference_mode():
        for s in range(steps):
            r = rows[:, s].long()
            xb = x[r.T].transpose(0, 1)          # [F, B, C, T], batch-major memory
            preds = composed_predict(*models, *idx, xb)
            cm += M.confusion_matrix(y[r], preds, 3, weights[:, s])
    return cm.cpu().numpy()


def run_hierarchical_sharded(cfg: HierarchicalConfig, run_output_dir: Path | str,
                             all_channel_names: list[str] | None = None,
                             device: str | torch.device = "cuda",
                             ) -> tuple[list[HierarchicalFoldResult], dict]:
    """Two sweeps and the composed evaluation; returns (per-fold results,
    summary)."""
    device = resolve_device(device)
    primary = multihost.is_primary()
    base = cfg.base
    t0 = time.time()
    run_output_dir = Path(run_output_dir)
    run_output_dir.mkdir(parents=True, exist_ok=True)
    union, m1_idx, m2_idx = union_channel_indices(cfg.m1_channels, cfg.m2_channels)
    if base.from_pickles:
        subject_cache: dict = {}
        _, meta = from_pickles_meta(union)
    else:
        meta = read_preprocess_meta(base.data_path)
        if all_channel_names is None:
            all_channel_names = read_channel_names(base.data_path)
    if primary:
        save_config(cfg, run_output_dir / "config.json", extra={"preprocess_meta": meta})

    def stage(channels, mode) -> tuple[PackedCorpus, FoldBatch]:
        if base.from_pickles:
            corpus, _, _ = pack_corpus_from_pickles(
                base.from_pickles, list(base.subjects), list(channels), mode,
                base.normalization, subject_cache=subject_cache)
        else:
            corpus = pack_corpus(base.data_path, list(base.subjects), list(channels),
                                 all_channel_names, mode, base.normalization)
        return corpus, build_fold_batch(corpus, list(base.subjects), base.val_fraction,
                                        base.seed)

    multihost.log("=" * 80)
    multihost.log(f"Sharded hierarchical experiment: 2 fold sweeps + composed eval on {device}")
    multihost.log("=" * 80)

    def sweep(channels, mode, model_cfg, tag):
        corpus, fb = stage(channels, mode)
        multihost.log(f"\n--- Sweep {tag}: mode={mode}, channels={list(channels)} ---")
        point_cfg = dataclasses.replace(base, channels_to_use=tuple(channels),
                                        classification_mode=mode, num_classes=2,
                                        model=model_cfg)
        return run_fold_sweep(corpus, fb, point_cfg, device), fb, point_cfg

    m1_result, fb1, m1_cfg = sweep(cfg.m1_channels, "stress_binary", cfg.m1_model, "M1")
    m2_result, fb2, m2_cfg = sweep(cfg.m2_channels, "amusement_binary", cfg.m2_model, "M2")
    corpus_u, fb_u = stage(union, "ternary")
    if not fb1.test_subjects == fb2.test_subjects == fb_u.test_subjects:
        raise ValueError("the M1, M2 and union corpora hold different folds: "
                         f"{fb1.test_subjects}, {fb2.test_subjects}, {fb_u.test_subjects}")
    cms = multihost.to_host(multihost.agree(lambda: composed_fold_cms(
        corpus_u, fb_u, ((cfg.m1_model, m1_result.final_variables, m1_idx),
                         (cfg.m2_model, m2_result.final_variables, m2_idx)),
        base.trainer.batch_size, device, block=rank_block(len(fb_u.test_subjects))),
        "composed evaluation"), "composed confusion matrices")

    results: list[HierarchicalFoldResult] = []
    for i, subject in enumerate(fb_u.test_subjects):
        m1_cm = torch.from_numpy(m1_result.test_cm[i])
        cm = torch.from_numpy(cms[i])
        results.append(HierarchicalFoldResult(
            subject=subject,
            m1_accuracy=float(M.accuracy_from_cm(m1_cm)),
            m1_f1=float(M.weighted_f1_from_cm(m1_cm)),
            composed_accuracy=float(M.accuracy_from_cm(cm)),
            composed_f1=float(M.weighted_f1_from_cm(cm)),
            num_test_windows=int(cms[i].sum()),
            wall_s=float("nan")))
        if not primary:
            continue
        fold_dir = run_output_dir / f"fold_test_on_{subject}"
        for sub, result, stage_cfg in (("model_m1", m1_result, m1_cfg),
                                       ("model_m2", m2_result, m2_cfg)):
            (fold_dir / sub).mkdir(parents=True, exist_ok=True)
            write_initial_train_state(fold_dir / sub / "best_model.msgpack",
                                      lane_variables(result.final_variables, i),
                                      stage_cfg.trainer.learning_rate)

    total_cm = cms.astype(np.float64).sum(axis=0)
    if not primary:
        summary = summary_numbers(results, torch.from_numpy(total_cm).float())
        summary["sweep_wall_s"] = time.time() - t0
        return results, summary
    summary = _write_summary_from_cms(run_output_dir, results, total_cm)
    summary["sweep_wall_s"] = time.time() - t0
    print(f"\nHierarchical sharded wall-clock: {summary['sweep_wall_s']:.2f}s")
    return results, summary


def _write_summary_from_cms(run_dir: Path, results, total_cm: np.ndarray) -> dict:
    """The serial summary's contract, from the summed confusion matrix."""
    summary = summary_numbers(results, torch.from_numpy(total_cm).float())
    lines = summary_lines("Hierarchical experiment summary (sharded)", results, summary,
                          str(total_cm.astype(int)))
    (run_dir / "hierarchical_summary.txt").write_text("\n".join(lines) + "\n")
    print(f"Hierarchical summary saved to: {run_dir / 'hierarchical_summary.txt'}")
    return summary
