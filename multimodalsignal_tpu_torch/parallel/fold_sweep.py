"""Sharded LOSO fold sweep on one GPU: every fold a lane, all in lockstep
(counterpart of multimodalsignal_tpu/parallel/fold_sweep.py).

The JAX package vmaps one fold's whole training over a fold axis sharded
across devices. Here the folds are the lanes of one FoldStackedModel
(models/fold_stack.py) on one device, trained by FoldAdam (train/optim.py):
every train step, eval batch and GRU walk serves all F folds at once, so
the host issues one launch sequence for the sweep, not one per fold.

Semantics carried over from the JAX sweep:
  * Ragged folds: per-fold index pools (valid windows first, padded with the
    fold's own first window) select from one flat corpus on the device;
    every fold runs the same [steps, B] schedule with 0/1 sample weights.
  * A fold whose batch weighs nothing does not move: parameters, batch-norm
    running statistics, Adam moments and count stay (FoldAdam's mask, the
    model's `update`).
  * After each epoch, per fold: validation, the plateau scheduler (its lr
    becomes the fold's Adam lr), early stopping, and the best (parameters,
    BN statistics) kept by a select over the fold axis. A fold that has
    stopped coasts: its train state and schedules are put back after every
    epoch, as the JAX sweep does.
  * finalize restores each fold's best state (unless
    legacy_restore_only_on_early_stop and it never stopped) and evaluates
    the held-out subject, with per-window probabilities.

Where the port differs: the epoch's shuffled grid is drawn on the host by a
numpy default_rng per fold (the JAX sweep draws it in-graph from threefry
keys, which numpy cannot match), so the card and the CPU see the same order;
FoldSweep.epoch takes the grid as an argument. The host syncs once per epoch
(the logs and stop flags), never per step.

The corpus comes from the npy contract (pack_corpus), straight from WESAD
pickles (cfg.from_pickles: pack_corpus_from_pickles), or, for
hybrid_cnn_gru, from the raw-align and feature targets (pack_hybrid_corpus):
the features sit on the device beside the windows and every batch gathers
both by the same indices.

One device, no mesh: folds across GPUs, the sweep's resume
(checkpoint_every / resume), the on-disk pack cache, trainer.remat and a
profiler trace directory are not ported (ROADMAP.md, queue 1).
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from multimodalsignal_tpu_torch.config import ExperimentConfig, save_config, validate_experiment
from multimodalsignal_tpu_torch.data.dataset import (
    PackedCorpus,
    experiment_preprocess_meta,
    pack_corpus,
    pack_corpus_from_pickles,
    pack_hybrid_corpus,
    read_channel_names,
)
from multimodalsignal_tpu_torch.experiments.loso import (
    FoldResult,
    balanced_class_weights,
    write_cv_summary,
)
from multimodalsignal_tpu_torch.experiments.predict import resolve_device
from multimodalsignal_tpu_torch.experiments.splits import loso_folds
from multimodalsignal_tpu_torch.models.convert import (
    export_jax_variables,
    lane_variables,
    load_jax_variables,
)
from multimodalsignal_tpu_torch.models.fold_stack import build_fold_model
from multimodalsignal_tpu_torch.train import metrics as M
from multimodalsignal_tpu_torch.train.checkpoints import write_initial_train_state
from multimodalsignal_tpu_torch.train.optim import (
    FoldAdam,
    early_stopping_init,
    early_stopping_update,
    plateau_init,
    plateau_update,
)
from multimodalsignal_tpu_torch.train.trainer import cross_entropy

DISPATCHES = ("per_epoch", "segmented")


# ---------------------------------------------------------------------------
# Fold batch construction (host side)
# ---------------------------------------------------------------------------

@dataclass
class FoldBatch:
    """Per-fold index pools into the flat corpus, padded to common sizes:
    pool[f, :n[f]] are flat window indices (subject * Wmax + window) of real
    windows, the rest the fold's own first window."""

    train_pool: np.ndarray  # [F, Ptr] int32
    n_train: np.ndarray     # [F] int32
    val_pool: np.ndarray    # [F, Pva] int32
    n_val: np.ndarray       # [F] int32
    test_pool: np.ndarray   # [F, Pte] int32
    n_test: np.ndarray      # [F] int32
    test_subjects: tuple[str, ...]


def _pack_pools(pools: list[np.ndarray]) -> tuple[np.ndarray, np.ndarray]:
    size = max(max(len(p) for p in pools), 1)
    out = np.zeros((len(pools), size), dtype=np.int32)
    n = np.zeros(len(pools), dtype=np.int32)
    for i, p in enumerate(pools):
        out[i, :len(p)] = p
        # The fold's own first window, not flat index 0: padded rows still
        # enter train-mode batch statistics, and index 0 belongs to one
        # fold's held-out subject.
        if len(p) > 0:
            out[i, len(p):] = p[0]
        n[i] = len(p)
    return out, n


def build_fold_batch(corpus: PackedCorpus, subjects: list[str], val_fraction: float = 0.2,
                     seed: int = 42) -> FoldBatch:
    """The LOSO folds (experiments/splits.py) as index pools, one fold per
    held-out subject that the corpus holds."""
    sid_to_row = {sid: i for i, sid in enumerate(corpus.subjects)}
    wmax = corpus.x.shape[1]
    folds = [f for f in loso_folds(subjects, val_fraction, seed)
             if f.test_subject in sid_to_row]

    def pool_for(sids) -> np.ndarray:
        parts = [sid_to_row[s] * wmax + np.nonzero(corpus.mask[sid_to_row[s]])[0]
                 for s in sids if s in sid_to_row]
        return np.concatenate(parts) if parts else np.zeros(0, np.int64)

    train_pool, n_train = _pack_pools([pool_for(f.train_subjects) for f in folds])
    val_pool, n_val = _pack_pools([pool_for(f.val_subjects) for f in folds])
    test_pool, n_test = _pack_pools([pool_for([f.test_subject]) for f in folds])
    return FoldBatch(train_pool, n_train, val_pool, n_val, test_pool, n_test,
                     tuple(f.test_subject for f in folds))


# ---------------------------------------------------------------------------
# Batch schedules
# ---------------------------------------------------------------------------

def shuffled_grid(rng: np.random.Generator, pool: np.ndarray, n_valid: int, steps: int,
                  batch_size: int) -> tuple[np.ndarray, np.ndarray]:
    """[steps, B] flat corpus indices and 0/1 weights: a permutation of the
    n_valid real windows first, then the pool's padding, wrapped to fill
    the grid; the weights are 1 on the first n_valid entries only."""
    p = len(pool)
    order = np.concatenate([rng.permutation(n_valid), np.arange(n_valid, p)])
    total = steps * batch_size
    idx = pool[order[np.arange(total) % p]]
    w = (np.arange(total) < n_valid).astype(np.float32)
    return idx.reshape(steps, batch_size), w.reshape(steps, batch_size)


def sequential_grid(pool: np.ndarray, n_valid: int, steps: int,
                    batch_size: int) -> tuple[np.ndarray, np.ndarray]:
    """The evaluation grid: the pool in order, wrapped; weights as above."""
    total = steps * batch_size
    idx = pool[np.arange(total) % len(pool)]
    w = (np.arange(total) < n_valid).astype(np.float32)
    return idx.reshape(steps, batch_size), w.reshape(steps, batch_size)


def _stack_grids(grids) -> tuple[np.ndarray, np.ndarray]:
    idx, w = zip(*grids)
    return np.stack(idx), np.stack(w)


def grid_steps(n: np.ndarray, batch_size: int) -> int:
    """Steps of a grid that covers the largest fold's n windows."""
    return max(-(-int(n.max()) // batch_size), 1)


# ---------------------------------------------------------------------------
# The sweep's state and programs
# ---------------------------------------------------------------------------

class SweepHistory(NamedTuple):
    train_loss: np.ndarray  # [F, E]
    val_loss: np.ndarray
    val_acc: np.ndarray
    val_f1: np.ndarray
    lr: np.ndarray


class SweepResult(NamedTuple):
    history: SweepHistory
    best_epoch: np.ndarray      # [F] 0-based
    stop_epoch: np.ndarray      # [F] epochs run before the fold stopped
    test_loss: np.ndarray       # [F]
    test_cm: np.ndarray         # [F, K, K]
    final_variables: dict       # flax {"params", "batch_stats"}, leaves [F, ...]
    test_probs: np.ndarray      # [F, steps_te * B, K] (trim to n_test per fold)


def _lanes(mask: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    return mask.view((-1,) + (1,) * (t.dim() - 1))


def _select(dst: list[torch.Tensor], src: list[torch.Tensor], mask) -> None:
    """dst[f] = src[f] in the folds of the bool mask [F], in place."""
    if not np.any(mask):
        return
    m = torch.as_tensor(np.asarray(mask), device=dst[0].device)
    with torch.no_grad():
        for d, s in zip(dst, src):
            d.copy_(torch.where(_lanes(m, d), s, d))


class FoldSweep:
    """Every fold's train state on one device, with the JAX sweep's epoch
    and finalize programs. `variables`, if given, is a stacked flax
    {"params", "batch_stats"} pair (leaves [F, ...]) to start from;
    otherwise fold f is initialised from torch's generator seeded with
    `init_seeds[f]`."""

    def __init__(self, corpus: PackedCorpus, fb: FoldBatch, cfg: ExperimentConfig,
                 device: str | torch.device = "cuda", variables: dict | None = None,
                 init_seeds: list[int] | None = None):
        tcfg = cfg.trainer
        if tcfg.checkpoint_every > 0 or tcfg.resume:
            raise NotImplementedError(
                "the sweep's resume (TrainerConfig.checkpoint_every / resume) is not "
                "ported yet (ROADMAP.md, queue 1, item 1: mid-run resume)")
        self.device = resolve_device(device)
        self.cfg = cfg
        folds = fb.train_pool.shape[0]
        x, y, _ = corpus.flat()
        feat = corpus.flat_feat()
        self.model = build_fold_model(cfg.model, cfg.num_classes, x.shape[1], folds,
                                      seeds=None if variables is not None else init_seeds,
                                      **({} if feat is None else {"num_features": feat.shape[1]}))
        if variables is not None:
            load_jax_variables(self.model, variables["params"], variables["batch_stats"])
        self.model.to(self.device)
        self.opt = FoldAdam(self.model.parameters(), tcfg.learning_rate, tcfg.weight_decay)
        self.x = torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(self.device)
        # The hybrid corpus's features [S*Wmax, nF], indexed as x.
        self.feat = (None if feat is None else
                     torch.from_numpy(np.ascontiguousarray(feat, np.float32)).to(self.device))
        self.y = torch.from_numpy(y.astype(np.int64)).to(self.device)
        self.cw = None
        if tcfg.use_class_weights:
            cw = np.stack([balanced_class_weights(y[fb.train_pool[f, :fb.n_train[f]]],
                                                  cfg.num_classes) for f in range(folds)])
            self.cw = torch.from_numpy(cw).to(self.device)
        self.fb = fb
        batch = tcfg.batch_size
        self.steps_tr = grid_steps(fb.n_train, batch)
        self.val_grid = self.to_device(_stack_grids(
            sequential_grid(fb.val_pool[f], fb.n_val[f], grid_steps(fb.n_val, batch), batch)
            for f in range(folds)))
        self.test_grid = self.to_device(_stack_grids(
            sequential_grid(fb.test_pool[f], fb.n_test[f], grid_steps(fb.n_test, batch), batch)
            for f in range(folds)))
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(cfg.seed)
        self.pl = plateau_init(tcfg.learning_rate, folds)
        self.es = early_stopping_init(folds)
        self.stopped = np.zeros(folds, bool)
        self.best = [t.detach().clone() for t in self._tracked()]

    def to_device(self, grid):
        idx, w = grid
        return (torch.tensor(np.asarray(idx, np.int64), device=self.device),
                torch.tensor(np.asarray(w, np.float32), device=self.device))

    def _tracked(self) -> list[torch.Tensor]:
        """What the best state holds: parameters and BN running statistics."""
        return list(self.model.parameters()) + [
            b for name, b in self.model.named_buffers() if "running" in name]

    def train_grid(self, rngs: list[np.random.Generator]) -> tuple[np.ndarray, np.ndarray]:
        """One epoch's shuffled [F, steps, B] grid, fold f drawn by rngs[f]."""
        fb, batch = self.fb, self.cfg.trainer.batch_size
        return _stack_grids(shuffled_grid(rng, fb.train_pool[f], fb.n_train[f],
                                          self.steps_tr, batch)
                            for f, rng in enumerate(rngs))

    def _batch(self, idx: torch.Tensor):
        """Windows [F, B, C, T] of idx [F, B], gathered batch-major (the
        model's grouped convolutions then read them without a copy); for a
        hybrid corpus the pair with the features [F, B, nF] of the same
        indices."""
        x = self.x[idx.T].transpose(0, 1)
        return x if self.feat is None else (x, self.feat[idx])

    def train_step(self, idx: torch.Tensor, w: torch.Tensor):
        """One Adam step of every fold on idx, w [F, B]; a fold whose
        weights sum to 0 does not move. Returns (loss, sum of weights,
        stepped) per fold, device tensors [F]."""
        self.model.train()
        valid = w.sum(dim=1) > 0
        logits = self.model(self._batch(idx), self.generator, update=valid)
        loss, wsum = cross_entropy(logits, self.y[idx], w, self.cw)
        self.opt.zero_grad()
        loss.sum().backward()
        self.opt.step(valid)
        return loss.detach(), wsum.detach(), valid

    def evaluate(self, grid, with_probs: bool = False):
        """(weighted loss [F], confusion matrices [F, K, K], and with
        `with_probs` the softmax [F, steps * B, K]) over grid [F, steps, B]."""
        idx, w = grid
        k, folds = self.cfg.num_classes, idx.shape[0]
        loss_sum = torch.zeros(folds, device=self.device)
        w_sum = torch.zeros(folds, device=self.device)
        cm = torch.zeros((folds, k, k), device=self.device)
        probs = []
        self.model.eval()
        with torch.inference_mode():
            for s in range(idx.shape[1]):
                rows, wb = idx[:, s], w[:, s]
                yb = self.y[rows]
                logits = self.model(self._batch(rows))
                loss, wsum = cross_entropy(logits, yb, wb, self.cw)
                cm += M.confusion_matrix(yb, logits.argmax(dim=-1), k, wb)
                loss_sum += loss * wsum
                w_sum += wsum
                if with_probs:
                    probs.append(torch.softmax(logits, dim=-1))
        return (loss_sum / w_sum.clamp(min=1e-12), cm,
                torch.cat(probs, dim=1) if with_probs else None)

    def epoch(self, idx: np.ndarray, w: np.ndarray, epoch: int):
        """One training epoch of every fold on the grid idx, w [F, steps, B]
        (0-based `epoch`). Returns the log, numpy [F] each: (train loss, val
        loss, val acc, val F1, lr, whether the fold was still training)."""
        tcfg = self.cfg.trainer
        es_cfg = tcfg.early_stopping
        stopped = self.stopped
        state = self._tracked() + self.opt.state()
        before = [t.detach().clone() for t in state] if stopped.any() else None
        idx_t, w_t = self.to_device((idx, w))
        loss_sum = torch.zeros(idx.shape[0], device=self.device)
        w_sum = torch.zeros(idx.shape[0], device=self.device)
        for s in range(idx.shape[1]):
            loss, wsum, valid = self.train_step(idx_t[:, s], w_t[:, s])
            loss_sum += torch.where(valid, loss * wsum, 0.0)
            w_sum += wsum
        val_loss, val_cm, _ = self.evaluate(self.val_grid)
        train_loss, val_loss, val_acc, val_f1 = torch.stack([
            loss_sum / w_sum.clamp(min=1e-12), val_loss, M.accuracy_from_cm(val_cm),
            M.weighted_f1_from_cm(val_cm)]).cpu().numpy()      # the epoch's one sync

        new_pl = plateau_update(self.pl, val_loss, factor=tcfg.lr_plateau_factor,
                                patience=tcfg.lr_plateau_patience,
                                threshold=tcfg.lr_plateau_threshold)
        new_es = early_stopping_update(self.es, val_loss, epoch, patience=es_cfg.patience,
                                       delta=es_cfg.delta,
                                       legacy_inverted=es_cfg.legacy_inverted)
        _select(self.best, self._tracked(), new_es.improved & ~stopped)
        # A stopped fold coasts: its train state and schedules go back.
        if before is not None:
            _select(state, before, stopped)

        def keep(new, old):
            return type(new)(*(np.where(stopped, o, n) for n, o in zip(new, old)))

        self.es, self.pl = keep(new_es, self.es), keep(new_pl, self.pl)
        self.opt.lr.copy_(torch.from_numpy(self.pl.lr))
        self.stopped = stopped | (es_cfg.enabled & self.es.should_stop)
        return train_loss, val_loss, val_acc, val_f1, self.pl.lr.copy(), ~stopped

    def finalize(self):
        """Restore each fold's best state and evaluate its held-out subject:
        (test loss [F], confusion matrices [F, K, K], best epoch [F],
        probabilities [F, steps_te * B, K]), numpy."""
        tcfg = self.cfg.trainer
        restore = tcfg.early_stopping.enabled & (
            (not tcfg.legacy_restore_only_on_early_stop) | self.es.should_stop)
        _select(self._tracked(), self.best, restore)
        loss, cm, probs = self.evaluate(self.test_grid, with_probs=True)
        return (loss.cpu().numpy(), cm.cpu().numpy(), self.es.best_epoch.copy(),
                probs.cpu().numpy())


def fold_streams(seed: int, folds: int) -> tuple[list[int], list[np.random.Generator]]:
    """Per fold: a torch seed for the initial weights and a numpy generator
    for the shuffles, both drawn from `seed`."""
    init, shuffle = np.random.SeedSequence(seed).spawn(2)
    return ([int(s.generate_state(1)[0]) for s in init.spawn(folds)],
            [np.random.default_rng(s) for s in shuffle.spawn(folds)])


def run_fold_sweep(corpus: PackedCorpus, fb: FoldBatch, cfg: ExperimentConfig,
                   device: str | torch.device = "cuda") -> SweepResult:
    """Train every fold in lockstep on one device and evaluate it; returns
    per-fold stacked results (fold axis first). The stop flags are read
    after every epoch and the sweep ends once every fold has stopped.

    Both values of cfg.sweep_dispatch run so. The JAX package's "segmented"
    scans several epochs in one device program to save host dispatches;
    here every epoch is a host loop of launches that syncs once at its end
    either way, so checking the flags less often would only run epochs in
    which every fold coasts, which "segmented" then drops again."""
    if cfg.sweep_dispatch not in DISPATCHES:
        raise ValueError(f"unknown sweep_dispatch {cfg.sweep_dispatch!r}: expected one of "
                         f"{DISPATCHES}")
    folds = fb.train_pool.shape[0]
    init_seeds, rngs = fold_streams(cfg.seed, folds)
    sweep = FoldSweep(corpus, fb, cfg, device, init_seeds=init_seeds)
    epochs = cfg.trainer.epochs
    logs = []
    t_train = time.time()
    for epoch in range(epochs):
        logs.append(sweep.epoch(*sweep.train_grid(rngs), epoch))
        stopped = sweep.stopped
        if epoch == 0 or (epoch + 1) % 10 == 0 or stopped.all():
            print(f"  epoch {epoch + 1}/{epochs} | mean val loss {logs[-1][1].mean():.4f} | "
                  f"{int((~stopped).sum())} folds active | {time.time() - t_train:.1f}s",
                  flush=True)
        if stopped.all():
            print(f"  all folds early-stopped at epoch {epoch + 1}")
            break
    t_eval = time.time()
    test_loss, test_cm, best_epoch, test_probs = sweep.finalize()
    print(f"  test eval: {time.time() - t_eval:.1f}s", flush=True)

    history = []
    for column in zip(*logs):
        out = np.zeros((folds, epochs), dtype=np.asarray(column[0]).dtype)
        out[:, :len(logs)] = np.stack(column, axis=1)
        history.append(out)
    *hist, ran = history
    return SweepResult(
        history=SweepHistory(*hist), best_epoch=best_epoch,
        stop_epoch=ran.astype(np.int32).sum(axis=1), test_loss=test_loss, test_cm=test_cm,
        final_variables=export_jax_variables(sweep.model), test_probs=test_probs)


def stage_corpus(cfg: ExperimentConfig, run_output_dir: Path,
                 all_channel_names: list[str] | None = None) -> PackedCorpus:
    """Stage the sweep's corpus and write the run's config.json: straight
    from the pickles (its preprocess meta is the pickles' windowing), the
    hybrid raw-align and feature pack, or the npy pack."""
    if cfg.from_pickles:
        # validate_experiment has refused the hybrid model here.
        corpus, _, meta = pack_corpus_from_pickles(
            cfg.from_pickles, list(cfg.subjects), list(cfg.channels_to_use),
            cfg.classification_mode, cfg.normalization)
        save_config(cfg, run_output_dir / "config.json", extra={"preprocess_meta": meta})
        return corpus
    hybrid = cfg.model.name == "hybrid_cnn_gru"
    save_config(cfg, run_output_dir / "config.json",
                extra={"preprocess_meta": experiment_preprocess_meta(cfg)})
    if all_channel_names is None:
        all_channel_names = read_channel_names(cfg.raw_align_path if hybrid else cfg.data_path)
    if hybrid:
        return pack_hybrid_corpus(
            cfg.raw_align_path, cfg.feature_path, list(cfg.subjects),
            list(cfg.channels_to_use), all_channel_names,
            list(cfg.features_to_use) or None, cfg.classification_mode, cfg.normalization)
    return pack_corpus(cfg.data_path, list(cfg.subjects), list(cfg.channels_to_use),
                       all_channel_names, cfg.classification_mode, cfg.normalization)


def run_sharded_experiment(cfg: ExperimentConfig, run_output_dir: Path | str,
                           all_channel_names: list[str] | None = None,
                           device: str | torch.device = "cuda"
                           ) -> tuple[list[FoldResult], dict]:
    """End-to-end LOSO as one sweep: pack the corpus, train every fold in
    lockstep, write the artifacts of experiments/loso.py's serial run (per
    fold training_log.txt, best_model.msgpack, test_probs.npy; the run's
    config.json and cv_summary.txt)."""
    t0 = time.time()
    validate_experiment(cfg, fold_execution="sharded")
    device = resolve_device(device)
    run_output_dir = Path(run_output_dir)
    run_output_dir.mkdir(parents=True, exist_ok=True)
    corpus = stage_corpus(cfg, run_output_dir, all_channel_names)
    fb = build_fold_batch(corpus, list(cfg.subjects), cfg.val_fraction, cfg.seed)
    print("=" * 80)
    print(f"Sharded LOSO sweep: {len(fb.test_subjects)} folds as lanes on {device}")
    print(f"  staging (pack + fold batch): {time.time() - t0:.1f}s")
    print("=" * 80)
    result = run_fold_sweep(corpus, fb, cfg, device)

    t_write = time.time()
    results = []
    for i, subject in enumerate(fb.test_subjects):
        cm = torch.from_numpy(result.test_cm[i])
        results.append(FoldResult(
            subject=subject, accuracy=float(M.accuracy_from_cm(cm)),
            f1_score=float(M.weighted_f1_from_cm(cm)),
            test_loss=float(result.test_loss[i]), best_epoch=int(result.best_epoch[i]) + 1,
            epochs_run=int(result.stop_epoch[i])))

    def write_fold(i: int) -> None:
        r = results[i]
        fold_dir = run_output_dir / f"fold_test_on_{r.subject}"
        _write_fold_log(fold_dir, result.history, result.test_loss, i, r)
        write_initial_train_state(fold_dir / "best_model.msgpack",
                                  lane_variables(result.final_variables, i),
                                  cfg.trainer.learning_rate)
        np.save(fold_dir / "test_probs.npy", result.test_probs[i][: int(fb.n_test[i])])

    with ThreadPoolExecutor(max_workers=8) as ex:
        list(ex.map(write_fold, range(len(results))))
    summary = write_cv_summary(run_output_dir / "cv_summary.txt", cfg, results)
    summary["sweep_wall_s"] = time.time() - t0
    print(f"  artifacts: {time.time() - t_write:.1f}s")
    print(f"\nSweep wall-clock: {summary['sweep_wall_s']:.2f}s "
          f"({len(results)} folds in lockstep)")
    print(f"Mean accuracy: {summary['mean_accuracy']:.4f} ± {summary['std_accuracy']:.4f}")
    print(f"Mean weighted F1: {summary['mean_f1']:.4f} ± {summary['std_f1']:.4f}")
    return results, summary


def _write_fold_log(fold_dir: Path, h: SweepHistory, test_loss, i: int, r: FoldResult) -> None:
    """Fold i's training_log.txt from the sweep's stacked history, in the
    JAX sweep's text."""
    fold_dir.mkdir(parents=True, exist_ok=True)
    lines = [f"Training log (sharded sweep fold {i})", "=" * 50]
    for e in range(r.epochs_run):
        lines.append(
            f"Epoch {e + 1} | train loss: {h.train_loss[i, e]:.4f} | "
            f"val loss: {h.val_loss[i, e]:.4f} | "
            f"val acc: {h.val_acc[i, e]:.4f} | val F1: {h.val_f1[i, e]:.4f} | "
            f"lr: {h.lr[i, e]:.2e}")
    lines.append(f"Best epoch: {r.best_epoch}")
    lines.append("--- Final test results ---")
    lines.append(f"test loss: {test_loss[i]:.4f} | test acc: {r.accuracy:.4f} | "
                 f"test F1: {r.f1_score:.4f}")
    (fold_dir / "training_log.txt").write_text("\n".join(lines) + "\n")
