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

Mid-run resume, as the JAX sweep does it (run_fold_sweep with a run_dir):
every checkpoint_every epochs the whole carry is saved as
`sweep_resume.msgpack` in the JAX carry's flax layout (state, best, early
stopping, plateau, rng, stop flags; every lane's parameters, BN statistics,
FoldAdam moments, count and lr), the per-epoch logs as
`sweep_resume_logs.npz` and the next epoch in `sweep_resume_meta.json`;
with trainer.resume and such a bundle the sweep goes on from it. The JAX
rng leaf (threefry keys) means nothing here: it is written as zeros of its
shape and ignored on read; the per-fold numpy shuffle streams are replayed
instead, and the dropout generators' states sit in `sweep_resume_rng.pt`.
`abort_after_epoch` is the JAX preemption drill (SweepAborted).
run_sharded_experiment's `profile_dir` writes a torch.profiler trace of the
sweep there.

The corpus comes through data/dataset.py's on-disk pack cache: a hit's
windows are a read-only memory map, copied into memory before they become
the device tensor (corpus_tensor). Every gru_impl runs under the fold axis;
pallas_fused walks all folds' two directions as 2F lanes of the fused pair
(models/fold_stack.py). With MMS_GRU_FOLD_GROUP >= 2 the per-direction
F-lane walks take G folds as one lane of width G·H in float32 (fold
grouping: auto, pallas and cuda every layer, every impl's pruned last layer;
models/fold_stack.py says which walks and why).

Several processes (parallel/multihost.py, MMS_COORDINATOR /
MMS_NUM_PROCESSES / MMS_PROCESS_ID): each rank trains one contiguous block
of the lanes (rank_block) on its own GPU, two ranks may share one, with
the streams those lanes have in one process and the whole sweep's dropout
masks, so the split run equals the one-process run; the ranks gather the
log columns and stop flags once an epoch and the results at the end, and
only the primary writes.

trainer.remat (default True, as in the JAX package): the train step runs
the model's forward under FoldStackedModel.forward_remat, which recomputes
the activations in the backward instead of keeping them (the JAX sweep's
jax.checkpoint of apply_train): every forward walk then runs twice a step,
every adjoint once; the results are those without remat (bit for bit on
one CPU thread).
"""

from __future__ import annotations

import dataclasses
import json
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
    summarize_results,
    write_cv_summary,
)
from multimodalsignal_tpu_torch.experiments.predict import resolve_device
from multimodalsignal_tpu_torch.experiments.splits import loso_folds
from multimodalsignal_tpu_torch.models.convert import (
    _layout,
    _to_tensor,
    export_jax_variables,
    get_leaf,
    lane_variables,
    load_jax_variables,
    put_leaf,
)
from multimodalsignal_tpu_torch.models.fold_stack import build_fold_model
from multimodalsignal_tpu_torch.parallel import multihost
from multimodalsignal_tpu_torch.train import metrics as M
from multimodalsignal_tpu_torch.train.checkpoints import (
    unpackb,
    variables_tree,
    write_initial_train_state,
    write_tree,
)
from multimodalsignal_tpu_torch.train.optim import (
    FoldAdam,
    early_stopping_init,
    early_stopping_update,
    fold_adam_state_tree,
    load_fold_adam_state_tree,
    plateau_init,
    plateau_update,
    state_from_tree,
    state_tree,
)
from multimodalsignal_tpu_torch.train.trainer import cross_entropy, deterministic_convolutions

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
# A sweep split over processes (parallel/multihost.py)
# ---------------------------------------------------------------------------

def rank_block(lanes: int, rank: int | None = None, world: int | None = None
               ) -> tuple[int, int]:
    """Lanes [lo, hi) of `rank` of `world` ranks (default: this process's):
    contiguous blocks in fold order, sized as np.array_split sizes them
    (15 lanes over 2 ranks: 8 + 7)."""
    rank = multihost.rank() if rank is None else rank
    world = multihost.world_size() if world is None else world
    if world > lanes:
        raise ValueError(f"{world} processes for a sweep of {lanes} lanes: each process "
                         "needs at least one")
    size, extra = divmod(lanes, world)
    lo = rank * size + min(rank, extra)
    return lo, lo + size + (rank < extra)


def take_lanes(tree, lo: int, hi: int):
    """Lanes lo..hi-1 of every leaf of a fold-major tree (dicts, a
    FoldBatch, arrays or tensors [F, ...]); a FoldBatch keeps its
    test_subjects' slice."""
    if isinstance(tree, FoldBatch):
        return FoldBatch(**{f.name: take_lanes(getattr(tree, f.name), lo, hi)
                            for f in dataclasses.fields(tree)})
    if isinstance(tree, dict):
        return {k: take_lanes(v, lo, hi) for k, v in tree.items()}
    return tree[lo:hi]


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


def corpus_tensor(a: np.ndarray, dtype, device) -> torch.Tensor:
    """A corpus array as a tensor on `device`. A pack cache hit's windows
    are a read-only memory map: they are copied into memory first, so that
    no tensor aliases the file (torch.from_numpy of a read-only array
    warns, and .to("cpu") would keep the alias)."""
    a = np.ascontiguousarray(a, dtype)
    if not a.flags.writeable:
        a = a.copy()
    return torch.from_numpy(a).to(device)


class FoldSweep:
    """Every fold's train state on one device, with the JAX sweep's epoch
    and finalize programs. `variables`, if given, is a stacked flax
    {"params", "batch_stats"} pair (leaves [F, ...]) to start from;
    otherwise fold f is initialised from torch's generator seeded with
    `init_seeds[f]`. Dropout draws from one generator per seed of
    `dropout_seeds` (default: cfg.seed), each for its own equal group of
    lanes (the seed groups of a replicated sweep).

    `block` (lo, hi): this sweep holds only lanes lo..hi-1 of the sweep
    that fb, init_seeds and variables describe (one rank's block of a sweep
    split over processes, rank_block). Its grids keep the whole sweep's
    steps and its dropout draws the whole sweep's masks, so each lane
    trains as it does in one process; the grids that epoch and train_grid
    take and give, and everything it returns, are the block's."""

    def __init__(self, corpus: PackedCorpus, fb: FoldBatch, cfg: ExperimentConfig,
                 device: str | torch.device = "cuda", variables: dict | None = None,
                 init_seeds: list[int] | None = None,
                 dropout_seeds: tuple[int, ...] | None = None,
                 block: tuple[int, int] | None = None):
        tcfg = cfg.trainer
        self.device = resolve_device(device)
        self.cfg = cfg
        total = fb.train_pool.shape[0]
        lo, hi = self.block = block or (0, total)
        folds = hi - lo
        steps = [grid_steps(n, tcfg.batch_size) for n in (fb.n_train, fb.n_val, fb.n_test)]
        fb = take_lanes(fb, lo, hi)
        x, y, _ = corpus.flat()
        feat = corpus.flat_feat()
        self.model = build_fold_model(
            cfg.model, cfg.num_classes, x.shape[1], folds,
            seeds=None if variables is not None or init_seeds is None else init_seeds[lo:hi],
            **({} if feat is None else {"num_features": feat.shape[1]}))
        if variables is not None:
            variables = take_lanes(variables, lo, hi)
            load_jax_variables(self.model, variables["params"], variables["batch_stats"])
        if block is not None:
            self.model.lane_span = (lo, total)
        self.model.to(self.device)
        self.opt = FoldAdam(self.model.parameters(), tcfg.learning_rate, tcfg.weight_decay)
        self.x = corpus_tensor(x, np.float32, self.device)
        # The hybrid corpus's features [S*Wmax, nF], indexed as x.
        self.feat = None if feat is None else corpus_tensor(feat, np.float32, self.device)
        self.y = corpus_tensor(y, np.int64, self.device)
        self.cw = None
        if tcfg.use_class_weights:
            cw = np.stack([balanced_class_weights(y[fb.train_pool[f, :fb.n_train[f]]],
                                                  cfg.num_classes) for f in range(folds)])
            self.cw = torch.from_numpy(cw).to(self.device)
        self.fb = fb
        batch = tcfg.batch_size
        self.steps_tr = steps[0]
        self.val_grid = self.to_device(_stack_grids(
            sequential_grid(fb.val_pool[f], fb.n_val[f], steps[1], batch) for f in range(folds)))
        self.test_grid = self.to_device(_stack_grids(
            sequential_grid(fb.test_pool[f], fb.n_test[f], steps[2], batch)
            for f in range(folds)))
        self.generators = [torch.Generator(device=self.device).manual_seed(s)
                           for s in (dropout_seeds or (cfg.seed,))]
        if total % len(self.generators):
            raise ValueError(f"{total} lanes do not split into {len(self.generators)} "
                             "equal seed groups")
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

    def _best_layout(self) -> list:
        """(collection, flax path, best-state tensor, transform) of every
        leaf the best state holds, as models/convert.py _layout gives the
        model's own."""
        where = {id(t): i for i, t in enumerate(self._tracked())}
        return [(coll, path, self.best[where[id(t)]], transform)
                for coll, path, t, transform in _layout(self.model)]

    def train_grid(self, rngs: list[np.random.Generator]) -> tuple[np.ndarray, np.ndarray]:
        """One epoch's shuffled [F, steps, B] grid of the block's lanes, lane
        f drawn by rngs[f] of the whole sweep's generators."""
        fb, batch = self.fb, self.cfg.trainer.batch_size
        return _stack_grids(shuffled_grid(rng, fb.train_pool[f], fb.n_train[f],
                                          self.steps_tr, batch)
                            for f, rng in enumerate(rngs[self.block[0]:self.block[1]]))

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
        forward = self.model.forward_remat if self.cfg.trainer.remat else self.model
        with deterministic_convolutions():
            logits = forward(self._batch(idx), self.generators, update=valid)
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

    def carry_tree(self) -> dict:
        """The JAX sweep's carry (state, best, es, pl, rng, stopped) as
        flax's tree, every leaf [F, ...]: the TrainState of every lane
        (parameters, BN statistics, FoldAdam's state in optax's layout),
        the best (parameters, BN statistics), the early-stopping and
        plateau states, zeros in place of the threefry keys [F, 2], and the
        stop flags."""
        best = {"params": {}, "batch_stats": {}}
        for coll, path, tensor, transform in self._best_layout():
            put_leaf(best[coll], path, transform(tensor).clone())
        state = {**variables_tree(self.model),
                 "opt_state": fold_adam_state_tree(self.model, self.opt)}
        carry = (state, {"0": best["params"], "1": best["batch_stats"]},
                 state_tree(self.es), state_tree(self.pl),
                 np.zeros((self.model.folds, 2), np.uint32), self.stopped.copy())
        return {str(i): t for i, t in enumerate(carry)}

    def load_carry_tree(self, carry: dict) -> None:
        """The inverse of carry_tree (this package's carry or the JAX
        sweep's); the rng leaf is not read."""
        state = carry["0"]
        load_jax_variables(self.model, state["params"], state["batch_stats"])
        load_fold_adam_state_tree(self.model, self.opt, state["opt_state"])
        best = {"params": carry["1"]["0"], "batch_stats": carry["1"]["1"]}
        with torch.no_grad():
            for coll, path, tensor, transform in self._best_layout():
                value = transform(_to_tensor(get_leaf(best[coll], path)))
                if value.shape != tensor.shape:
                    raise ValueError(f"best {coll}/{'/'.join(path)} has shape "
                                     f"{list(value.shape)}; the model {list(tensor.shape)}")
                tensor.copy_(value)
        self.es = state_from_tree(self.es, carry["2"])
        self.pl = state_from_tree(self.pl, carry["3"])
        self.stopped = np.asarray(carry["5"], bool).reshape(self.stopped.shape)

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


def seed_group_streams(seeds: tuple[int, ...], lanes: int
                       ) -> tuple[list[int], list[np.random.Generator]]:
    """fold_streams of `lanes` lanes in len(seeds) equal seed groups: lane
    s*F+f takes fold f's streams of a plain F-fold sweep at seeds[s]."""
    per_group = lanes // len(seeds)
    if per_group * len(seeds) != lanes:
        raise ValueError(f"{lanes} lanes are not {len(seeds)} equal seed groups")
    init_seeds, rngs = [], []
    for seed in seeds:
        group_init, group_rngs = fold_streams(seed, per_group)
        init_seeds += group_init
        rngs += group_rngs
    return init_seeds, rngs


class SweepAborted(RuntimeError):
    """Raised by run_fold_sweep's abort_after_epoch preemption drill."""


_RESUME_STATE = "sweep_resume.msgpack"
_RESUME_LOGS = "sweep_resume_logs.npz"
_RESUME_META = "sweep_resume_meta.json"
_RESUME_RNG = "sweep_resume_rng.pt"


def _save_sweep_resume(run_dir: Path, carry: dict, generators: list[torch.Generator],
                       logs: list, next_epoch: int) -> None:
    """The whole carry (every lane's), the per-epoch logs (columns c0..c5,
    [F, epochs]) and the dropout generators' states, as the JAX sweep saves
    them."""
    write_tree(run_dir / _RESUME_STATE, carry)
    np.savez(run_dir / _RESUME_LOGS,
             **{f"c{j}": np.stack(col, axis=1) for j, col in enumerate(zip(*logs))})
    torch.save([g.get_state() for g in generators], run_dir / _RESUME_RNG)
    (run_dir / _RESUME_META).write_text(json.dumps({"next_epoch": next_epoch}))


def _load_sweep_resume(run_dir: Path, sweep: FoldSweep) -> tuple[list, int]:
    """Restore the bundle (a JAX sweep's too: without the generators' file
    they stay as seeded) into `sweep`, its block's lanes of the carry;
    returns (the whole sweep's logs, next epoch)."""
    next_epoch = int(json.loads((run_dir / _RESUME_META).read_text())["next_epoch"])
    sweep.load_carry_tree(take_lanes(unpackb((run_dir / _RESUME_STATE).read_bytes()),
                                     *sweep.block))
    if (run_dir / _RESUME_RNG).exists():
        states = torch.load(run_dir / _RESUME_RNG, weights_only=True)
        for g, state in zip(sweep.generators, states):
            g.set_state(state)
    with np.load(run_dir / _RESUME_LOGS) as data:
        cols = [data[f"c{j}"] for j in range(len(data.files))]
    return [tuple(c[:, e] for c in cols) for e in range(next_epoch)], next_epoch


def run_fold_sweep(corpus: PackedCorpus, fb: FoldBatch, cfg: ExperimentConfig,
                   device: str | torch.device = "cuda",
                   seeds: tuple[int, ...] | None = None,
                   run_dir: Path | str | None = None,
                   abort_after_epoch: int | None = None) -> SweepResult:
    """Train every fold in lockstep on one device and evaluate it; returns
    per-fold stacked results (fold axis first). The stop flags are read
    after every epoch and the sweep ends once every fold has stopped.

    Under several processes (parallel/multihost.py) each rank trains its
    rank_block of the lanes with the streams those lanes have in one
    process; after every epoch the ranks gather the log columns and stop
    flags, so all of them stop at the same epoch, and at the end the
    results, so every rank returns the whole sweep's. Only the primary
    prints and writes the resume bundle.

    Resume, with the JAX sweep's rules: checkpoints only with a `run_dir`
    (every cfg.trainer.checkpoint_every epochs); cfg.trainer.resume is live
    only where run_dir holds a bundle; `abort_after_epoch` raises
    SweepAborted right after that epoch (and its checkpoint). The shuffle
    streams are replayed over the epochs before the bundle's, so a resumed
    sweep launches only the remaining epochs' work.

    `seeds` (a seed-replicated sweep, parallel/replicated_sweep.py): fb's
    lanes are len(seeds) copies of one fold batch, and lane s*F+f takes
    fold f's streams of a plain sweep at seeds[s] (fold_streams and the
    dropout generator), so seed group s is the sweep run with seeds=
    (seeds[s],); seeds=(cfg.seed,) is the plain sweep.

    Both values of cfg.sweep_dispatch run so. The JAX package's "segmented"
    scans several epochs in one device program to save host dispatches;
    here every epoch is a host loop of launches that syncs once at its end
    either way, so checking the flags less often would only run epochs in
    which every fold coasts, which "segmented" then drops again. As in the
    JAX package, "segmented" refuses checkpoints, a live resume and the
    drill."""
    if cfg.sweep_dispatch not in DISPATCHES:
        raise ValueError(f"unknown sweep_dispatch {cfg.sweep_dispatch!r}: expected one of "
                         f"{DISPATCHES}")
    run_dir = None if run_dir is None else Path(run_dir)
    checkpoint_every = cfg.trainer.checkpoint_every if run_dir is not None else 0
    resume_live = (cfg.trainer.resume and run_dir is not None
                   and (run_dir / _RESUME_STATE).exists())
    if run_dir is not None and cfg.trainer.resume:
        # A file read that gates a raise and the restore: every rank must
        # see the same bundle.
        multihost.assert_agreement(int(resume_live), "sweep_resume existence")
    if cfg.sweep_dispatch == "segmented" and (checkpoint_every > 0 or resume_live
                                              or abort_after_epoch is not None):
        raise ValueError(
            "checkpoint/resume and the preemption drill are per_epoch "
            "features (they need an epoch-granular host boundary); "
            "segmented dispatch does not support them")
    folds = fb.train_pool.shape[0]
    seeds = (cfg.seed,) if seeds is None else tuple(seeds)
    init_seeds, rngs = seed_group_streams(seeds, folds)
    primary = multihost.is_primary()
    block = rank_block(folds)
    sweep = multihost.agree(lambda: FoldSweep(corpus, fb, cfg, device, init_seeds=init_seeds,
                                              dropout_seeds=seeds, block=block),
                            "sweep build")
    epochs = cfg.trainer.epochs
    logs, start_epoch = [], 0
    if resume_live:
        logs, start_epoch = _load_sweep_resume(run_dir, sweep)
        multihost.assert_agreement(start_epoch, "resume epoch")
        for _ in range(start_epoch):   # replay the shuffle streams
            sweep.train_grid(rngs)
        if primary:
            print(f"  resumed sweep from epoch {start_epoch}", flush=True)
    t_train = time.time()
    for epoch in range(start_epoch, epochs):
        # The epoch's one gather: every rank's log columns and stop flags,
        # also on a rank whose own folds have all stopped.
        *log, stopped = multihost.to_host(multihost.agree(
            lambda: (*sweep.epoch(*sweep.train_grid(rngs), epoch), sweep.stopped),
            "sweep epoch"), "sweep epoch log")
        logs.append(tuple(log))
        if primary and (epoch == start_epoch or (epoch + 1) % 10 == 0 or stopped.all()):
            print(f"  epoch {epoch + 1}/{epochs} | mean val loss {logs[-1][1].mean():.4f} | "
                  f"{int((~stopped).sum())} folds active | {time.time() - t_train:.1f}s",
                  flush=True)
        if checkpoint_every > 0 and (epoch + 1) % checkpoint_every == 0:
            carry = multihost.to_host(sweep.carry_tree(), "sweep carry")
            if primary:
                _save_sweep_resume(run_dir, carry, sweep.generators, logs, epoch + 1)
        if abort_after_epoch is not None and epoch + 1 >= abort_after_epoch:
            raise SweepAborted(f"aborted after epoch {epoch + 1} (drill)")
        if stopped.all():
            if primary:
                print(f"  all folds early-stopped at epoch {epoch + 1}")
            break
    t_eval = time.time()
    test_loss, test_cm, best_epoch, test_probs, final_variables = multihost.to_host(
        multihost.agree(lambda: (*sweep.finalize(), export_jax_variables(sweep.model)),
                        "sweep finalize"), "sweep results")
    if primary:
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
        final_variables=final_variables, test_probs=test_probs)


def stage_corpus(cfg: ExperimentConfig, run_output_dir: Path,
                 all_channel_names: list[str] | None = None,
                 save_extra: dict | None = None) -> PackedCorpus:
    """Stage the sweep's corpus and write the run's config.json (with
    `save_extra`'s keys beside the config; the primary process only): straight
    from the pickles (its preprocess meta is the pickles' windowing), the
    hybrid raw-align and feature pack, or the npy pack."""
    extra = save_extra or {}

    def save(meta) -> None:
        if multihost.is_primary():
            save_config(cfg, run_output_dir / "config.json",
                        extra={"preprocess_meta": meta, **extra})

    if cfg.from_pickles:
        # validate_experiment has refused the hybrid model here.
        corpus, _, meta = pack_corpus_from_pickles(
            cfg.from_pickles, list(cfg.subjects), list(cfg.channels_to_use),
            cfg.classification_mode, cfg.normalization)
        save(meta)
        return corpus
    hybrid = cfg.model.name == "hybrid_cnn_gru"
    save(experiment_preprocess_meta(cfg))
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
                           device: str | torch.device = "cuda",
                           profile_dir: Path | str | None = None
                           ) -> tuple[list[FoldResult], dict]:
    """End-to-end LOSO as one sweep: pack the corpus, train every fold in
    lockstep, write the artifacts of experiments/loso.py's serial run (per
    fold training_log.txt, best_model.msgpack, test_probs.npy; the run's
    config.json and cv_summary.txt). The run directory holds the sweep's
    resume bundle (cfg.trainer.checkpoint_every, resume). With
    `profile_dir`, the sweep runs under torch.profiler (CPU and CUDA
    activities) and a Chrome trace of it is written there: sweep_trace.json,
    or sweep_trace_rank{r}.json from rank r > 0 of several processes.

    Under several processes every rank stages the corpus and trains its
    block of the folds (run_fold_sweep); only the primary writes the run
    directory and prints, and every rank returns the whole run's
    results."""
    t0 = time.time()
    validate_experiment(cfg, fold_execution="sharded")
    device = resolve_device(device)
    primary = multihost.is_primary()
    run_output_dir = Path(run_output_dir)
    run_output_dir.mkdir(parents=True, exist_ok=True)
    corpus = stage_corpus(cfg, run_output_dir, all_channel_names)
    fb = build_fold_batch(corpus, list(cfg.subjects), cfg.val_fraction, cfg.seed)
    if primary:
        print("=" * 80)
        print(f"Sharded LOSO sweep: {len(fb.test_subjects)} folds as lanes on {device}"
              + (f", split over {multihost.world_size()} processes"
                 if multihost.world_size() > 1 else ""))
        print(f"  staging (pack + fold batch): {time.time() - t0:.1f}s")
        print("=" * 80)
    profiler = None
    if profile_dir is not None:
        activities = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        profiler = torch.profiler.profile(activities=activities)
        profiler.start()
    try:
        result = run_fold_sweep(corpus, fb, cfg, device, run_dir=run_output_dir)
    finally:
        if profiler is not None:
            profiler.stop()
            Path(profile_dir).mkdir(parents=True, exist_ok=True)
            name = "sweep_trace.json" if primary else f"sweep_trace_rank{multihost.rank()}.json"
            profiler.export_chrome_trace(str(Path(profile_dir) / name))
            print(f"Profiler trace written to: {profile_dir}")

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

    if not primary:
        summary = summarize_results(results)
        summary["sweep_wall_s"] = time.time() - t0
        return results, summary
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
