"""Seed-replicated LOSO sweep: folds x seeds as the lanes of one sweep on one
GPU (counterpart of multimodalsignal_tpu/parallel/replicated_sweep.py).

The reference reports one LOSO run at one seed (reference main.py:60, 71-72):
its headline accuracy carries no error bar for training noise (initial
weights, shuffles, dropout). Here the fold axis of the sweep
(parallel/fold_sweep.py) holds S copies of the fold batch, and copy s gets
the streams of a plain sweep at seeds[s] (run_fold_sweep's `seeds`), so
seed group s is the single-seed sweep at that seed: 15 folds x 4 seeds are
60 lanes of the same kernels, with no traffic between lanes until the
metrics. The subject splits stay those of cfg.seed for every seed group:
the replication isolates training noise.

`seed_chunk` runs at most that many seed groups a launch, one launch after
another; a launch that runs out of device memory (torch.cuda.
OutOfMemoryError, nothing else) is retried with the chunk halved, keeping
the groups already finished. One GPU needs no mesh padding, so a group is
exactly the F folds.

Under several processes (parallel/multihost.py) each launch's S*F lanes
are split into rank blocks as a plain sweep's are (fold_sweep.rank_block):
lane s*F+f keeps its seed group's streams and dropout generator. The
matrices come from the gathered result; a rank out of device memory makes
every rank halve alike (multihost.agree); only the primary writes and
prints.

CLI::

    python -m multimodalsignal_tpu_torch.main --seeds 42 43 44 [--seed-chunk N]
"""

from __future__ import annotations

import json
import time
from pathlib import Path

import numpy as np
import torch

from multimodalsignal_tpu_torch.config import ExperimentConfig, validate_experiment
from multimodalsignal_tpu_torch.experiments.predict import resolve_device
from multimodalsignal_tpu_torch.parallel import multihost
from multimodalsignal_tpu_torch.parallel.fold_sweep import (
    FoldBatch,
    build_fold_batch,
    run_fold_sweep,
    stage_corpus,
)
from multimodalsignal_tpu_torch.train import metrics as M


def replicate_fold_batch(fb: FoldBatch, num_seeds: int) -> FoldBatch:
    """Tile every fold-axis array S times: lane s*F+f is fold f under seed
    group s. The pools are the same in every group (the splits are fixed);
    only the streams differ (run_fold_sweep's `seeds`)."""
    def tile(a):
        return np.concatenate([a] * num_seeds, axis=0)

    return FoldBatch(
        train_pool=tile(fb.train_pool), n_train=tile(fb.n_train),
        val_pool=tile(fb.val_pool), n_val=tile(fb.n_val),
        test_pool=tile(fb.test_pool), n_test=tile(fb.n_test),
        test_subjects=fb.test_subjects)


def _acc_f1_matrices(test_cm: np.ndarray, num_seeds: int,
                     per_group: int) -> tuple[np.ndarray, np.ndarray]:
    """Per-(seed, fold) accuracy and F1 [S, F] from stacked [S*F, K, K]
    confusion matrices."""
    cm = torch.from_numpy(np.asarray(test_cm, np.float32)).reshape(
        num_seeds, per_group, *test_cm.shape[1:])
    return (M.accuracy_from_cm(cm).double().numpy(),
            M.weighted_f1_from_cm(cm).double().numpy())


def summarize_from_matrices(acc: np.ndarray, f1: np.ndarray, seeds: tuple[int, ...],
                            subjects: tuple[str, ...]) -> dict:
    """Variance decomposition of a per-(seed, fold) accuracy and F1 matrix:
    per-seed fold values, the grand means, the across-seed std of the
    per-seed means (the training-noise error bar on the headline number),
    and the mean per-fold across-seed std (how seed-sensitive a subject
    is)."""
    seed_means = acc.mean(axis=1)
    return {
        "seeds": list(seeds),
        "subjects": list(subjects),
        "accuracy": acc.tolist(),
        "f1": f1.tolist(),
        "per_seed_mean_accuracy": seed_means.tolist(),
        "per_seed_mean_f1": f1.mean(axis=1).tolist(),
        "grand_mean_accuracy": float(acc.mean()),
        "grand_mean_f1": float(f1.mean()),
        # ddof=1: an error bar from S samples of the run-level mean.
        "seed_std_of_mean_accuracy": float(seed_means.std(ddof=1))
        if len(seeds) > 1 else 0.0,
        "mean_fold_seed_std": float(acc.std(axis=0, ddof=1).mean())
        if len(seeds) > 1 else 0.0,
        "fold_std_of_mean_accuracy": float(acc.mean(axis=0).std()),
    }


def summarize_replicated(result, fb: FoldBatch, seeds: tuple[int, ...],
                         per_group: int) -> dict:
    """Variance decomposition of one stacked [S*F, ...] sweep result."""
    acc, f1 = _acc_f1_matrices(result.test_cm, len(seeds), per_group)
    return summarize_from_matrices(acc, f1, seeds, fb.test_subjects)


def write_seed_summary(path: Path, cfg: ExperimentConfig, summary: dict) -> None:
    """seed_summary.txt in the JAX package's text."""
    seeds = summary["seeds"]
    lines = [
        "Seed-replicated LOSO sweep summary",
        "=" * 60,
        f"model: {cfg.model.name} | channels: {list(cfg.channels_to_use)} | "
        f"mode: {cfg.classification_mode}",
        f"seeds: {seeds} (subject splits fixed; init/shuffle/dropout vary)",
        "",
        f"{'seed':>6} {'mean accuracy':>16} {'mean weighted F1':>18}",
        "-" * 60,
    ]
    for i, s in enumerate(seeds):
        lines.append(f"{s:>6} {summary['per_seed_mean_accuracy'][i]:>16.4f} "
                     f"{summary['per_seed_mean_f1'][i]:>18.4f}")
    lines += [
        "-" * 60,
        f"grand mean accuracy: {summary['grand_mean_accuracy']:.4f}",
        f"  across-seed std of the run mean (training noise): "
        f"±{summary['seed_std_of_mean_accuracy']:.4f}",
        f"  across-fold std of the seed-averaged accuracy (subject shift): "
        f"±{summary['fold_std_of_mean_accuracy']:.4f}",
        f"  mean per-fold across-seed std: ±{summary['mean_fold_seed_std']:.4f}",
        f"grand mean weighted F1: {summary['grand_mean_f1']:.4f}",
    ]
    path.write_text("\n".join(lines) + "\n")
    print("\n".join(lines))


def run_replicated_experiment(cfg: ExperimentConfig, seeds: tuple[int, ...],
                              run_output_dir: Path | str,
                              all_channel_names: list[str] | None = None,
                              device: str | torch.device = "cuda",
                              seed_chunk: int | None = None) -> dict:
    """Pack once, sweep folds x seeds, and write seed_summary.{txt,json}
    and the per-(seed, fold) matrices (seed_fold_matrix.npz). seed_chunk:
    at most this many seed groups a launch, one launch after another; on
    torch.cuda.OutOfMemoryError the remaining seeds are retried with the
    chunk halved (down to 1), any other error propagates."""
    t0 = time.time()
    validate_experiment(cfg, fold_execution="sharded")
    if seed_chunk is not None and seed_chunk < 1:
        raise ValueError(f"seed_chunk must be >= 1, got {seed_chunk}")
    device = resolve_device(device)
    run_output_dir = Path(run_output_dir)
    run_output_dir.mkdir(parents=True, exist_ok=True)
    corpus = stage_corpus(cfg, run_output_dir, all_channel_names,
                          save_extra={"replicate_seeds": list(seeds)})
    fb = build_fold_batch(corpus, list(cfg.subjects), cfg.val_fraction, cfg.seed)
    per_group = len(fb.test_subjects)
    chunk = min(seed_chunk or len(seeds), len(seeds))
    staging_s = time.time() - t0
    accs, f1s, chunk_walls = [], [], []
    remaining = list(seeds)
    launch_idx = 0
    while remaining:   # an OOM retry re-chunks only the seeds not yet run
        chunk_seeds = tuple(remaining[:chunk])
        total = launch_idx + -(-len(remaining) // chunk)
        tc = time.time()
        multihost.log("=" * 80)
        multihost.log(f"Seed-replicated sweep [launch {launch_idx + 1}/{total}]: "
                      f"{per_group} folds x {len(chunk_seeds)} seeds = "
                      f"{per_group * len(chunk_seeds)} lanes on {device}")
        if launch_idx == 0:
            multihost.log(f"  staging: {staging_s:.1f}s")
        multihost.log("=" * 80)
        try:
            result = run_fold_sweep(corpus, replicate_fold_batch(fb, len(chunk_seeds)),
                                    cfg, device, seeds=chunk_seeds)
        except torch.cuda.OutOfMemoryError:
            if chunk <= 1:
                raise
            chunk = -(-chunk // 2)
            multihost.log(f"Launch ran out of device memory; keeping the {launch_idx} "
                          f"completed launch(es) and retrying the remaining {len(remaining)} "
                          f"seeds with seed_chunk={chunk}. Consider model.dtype=bfloat16.")
            result = None
        if result is None:   # outside the handler, so the failed launch's tensors are freed
            if device.type == "cuda":
                torch.cuda.empty_cache()
            continue
        a, f = _acc_f1_matrices(result.test_cm, len(chunk_seeds), per_group)
        accs.append(a)
        f1s.append(f)
        chunk_walls.append(time.time() - tc)
        remaining = remaining[len(chunk_seeds):]
        launch_idx += 1

    summary = summarize_from_matrices(np.concatenate(accs, axis=0),
                                      np.concatenate(f1s, axis=0),
                                      tuple(seeds), fb.test_subjects)
    summary["wall_s"] = time.time() - t0
    summary["seed_chunk"] = chunk
    summary["launch_walls_s"] = [round(w, 2) for w in chunk_walls]
    if not multihost.is_primary():
        return summary
    write_seed_summary(run_output_dir / "seed_summary.txt", cfg, summary)
    (run_output_dir / "seed_summary.json").write_text(json.dumps(summary, indent=2) + "\n")
    np.savez(run_output_dir / "seed_fold_matrix.npz",
             accuracy=np.asarray(summary["accuracy"]), f1=np.asarray(summary["f1"]),
             seeds=np.asarray(seeds), subjects=np.asarray(fb.test_subjects))
    print(f"\nReplicated sweep wall-clock: {summary['wall_s']:.2f}s")
    return summary
