"""Optimizer and the scheduler / early-stopping state machines (counterpart
of multimodalsignal_tpu/train/optim.py).

  * torch.optim.Adam with weight_decay is the reference's own optimizer: the
    L2 term is added to the gradient before the moments (the JAX package's
    optax.add_decayed_weights -> scale_by_adam -> -lr chain reproduces it).
  * ReduceLROnPlateau(mode='min', rel threshold) and early stopping are pure
    functions over small NamedTuple states. They compare in float32
    (np.float32), as the JAX state machines do on float32 arrays: a float64
    comparison could flip a decision at the threshold.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


def make_optimizer(params, learning_rate: float, weight_decay: float) -> torch.optim.Adam:
    """Adam with L2 weight decay folded into the gradient (not AdamW)."""
    return torch.optim.Adam(params, lr=float(np.float32(learning_rate)),
                            betas=(0.9, 0.999), eps=1e-8, weight_decay=weight_decay)


def set_learning_rate(optimizer: torch.optim.Optimizer, lr) -> None:
    """Write lr (as the JAX package's float32 hyperparameter) into every
    parameter group."""
    value = float(np.float32(lr))
    for group in optimizer.param_groups:
        group["lr"] = value


# ---------------------------------------------------------------------------
# ReduceLROnPlateau
# ---------------------------------------------------------------------------

class PlateauState(NamedTuple):
    lr: np.float32       # current learning rate
    best: np.float32     # best (lowest) metric so far
    num_bad: int         # epochs since last improvement


def plateau_init(lr: float) -> PlateauState:
    return PlateauState(lr=np.float32(lr), best=np.float32(np.inf), num_bad=0)


def plateau_update(state: PlateauState, metric, factor: float = 0.1,
                   patience: int = 3, threshold: float = 1e-4,
                   min_lr: float = 0.0) -> PlateauState:
    """One scheduler step on a to-minimize metric (torch's rel-threshold
    rule: improvement iff metric < best * (1 - threshold))."""
    metric = np.float32(metric)
    improved = bool(metric < state.best * np.float32(1.0 - threshold))
    best = metric if improved else state.best
    num_bad = 0 if improved else state.num_bad + 1
    lr = state.lr
    if num_bad > patience:
        lr = max(np.float32(state.lr * np.float32(factor)), np.float32(min_lr))
        num_bad = 0
    return PlateauState(lr=np.float32(lr), best=np.float32(best), num_bad=num_bad)


# ---------------------------------------------------------------------------
# EarlyStopping
# ---------------------------------------------------------------------------

class EarlyStoppingState(NamedTuple):
    best_score: np.float32  # monitored value at the best epoch (nan before any)
    counter: int            # epochs since improvement
    should_stop: bool       # latched stop flag
    improved: bool          # this step was an improvement (=> checkpoint)
    best_epoch: int


def early_stopping_init() -> EarlyStoppingState:
    return EarlyStoppingState(best_score=np.float32(np.nan), counter=0,
                              should_stop=False, improved=False, best_epoch=-1)


def early_stopping_update(state: EarlyStoppingState, score, epoch: int,
                          patience: int = 20, delta: float = 0.0,
                          legacy_inverted: bool = False) -> EarlyStoppingState:
    """One early-stopping step on the monitored score.

    Default: score is a loss, improvement = score < best - delta.
    legacy_inverted: the reference's literal comparison, improvement =
    score >= best + delta (a rising loss counts as improvement); kept for
    bit-faithful replication studies."""
    score = np.float32(score)
    first = bool(np.isnan(state.best_score))
    if legacy_inverted:
        better = bool(score >= state.best_score + np.float32(delta))
    else:
        better = bool(score < state.best_score - np.float32(delta))
    improved = first or better
    counter = 0 if improved else state.counter + 1
    return EarlyStoppingState(
        best_score=score if improved else state.best_score,
        counter=counter,
        should_stop=state.should_stop or counter >= patience,
        improved=improved and not state.should_stop,
        best_epoch=int(epoch) if improved else state.best_epoch,
    )
