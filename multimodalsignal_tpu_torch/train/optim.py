"""Optimizer and the scheduler / early-stopping state machines (counterpart
of multimodalsignal_tpu/train/optim.py).

  * torch.optim.Adam with weight_decay is the reference's own optimizer: the
    L2 term is added to the gradient before the moments (the JAX package's
    optax.add_decayed_weights -> scale_by_adam -> -lr chain reproduces it).
  * ReduceLROnPlateau(mode='min', rel threshold) and early stopping are pure
    NumPy functions over small NamedTuple states, of one run (scalars) or of
    the sweep's folds (arrays [F], as jax.vmap runs the JAX machines). They
    compare in float32 (np.float32), as the JAX state machines do on float32
    arrays: a float64 comparison could flip a decision at the threshold.
  * FoldAdam is the same Adam over fold-stacked parameters [F, ...], with a
    step count, a learning rate and an update mask per fold (the sweep's
    optax state under jax.vmap).
  * Every state here goes to and from the JAX package's tree layout (flax's
    state dict of its optax and NamedTuple states), which its checkpoints
    and resume bundles hold: `adam_state_tree`/`load_adam_state_tree`,
    `fold_adam_state_tree`/`load_fold_adam_state_tree`, and
    `state_tree`/`state_from_tree` for the plateau and early-stopping
    states.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from multimodalsignal_tpu_torch.models.convert import _layout, _to_tensor, get_leaf, put_leaf

BETAS, EPS = (0.9, 0.999), 1e-8


def make_optimizer(params, learning_rate: float, weight_decay: float) -> torch.optim.Adam:
    """Adam with L2 weight decay folded into the gradient (not AdamW)."""
    return torch.optim.Adam(params, lr=float(np.float32(learning_rate)),
                            betas=BETAS, eps=EPS, weight_decay=weight_decay)


class FoldAdam:
    """Adam with L2 weight decay over parameters whose leading axis is the
    fold, with per-fold state: `count` [F] (int32), `lr` [F] (float32) and
    the moments `mu`, `nu` [F, P] of all P parameter elements of a fold, in
    parameter order (`sizes` gives each parameter's share). A step takes
    `mask` [F] (bool): a fold outside it keeps its parameters, moments and
    count, as the JAX sweep's masked step keeps the whole train state of a
    fold whose batch weighs nothing (fold_sweep.py:304-318). The arithmetic
    is optax's add_decayed_weights -> scale_by_adam -> scale(-lr) chain, on
    the parameters and gradients gathered into [F, P], so a step is a few
    launches over all parameters, not a few per parameter. torch.optim.Adam
    keeps one count per tensor and one learning rate per group, which a
    sweep cannot use."""

    def __init__(self, params, learning_rate: float, weight_decay: float):
        self.params = list(params)
        lead = self.params[0]
        folds, dev = lead.shape[0], lead.device
        self.sizes = [p[0].numel() for p in self.params]
        self.weight_decay = weight_decay
        self.lr = torch.full((folds,), float(np.float32(learning_rate)), device=dev)
        self.count = torch.zeros(folds, dtype=torch.int32, device=dev)
        self.mu = torch.zeros((folds, sum(self.sizes)), device=dev)
        self.nu = torch.zeros_like(self.mu)

    def state(self) -> list[torch.Tensor]:
        """Every tensor of the optimizer's state, for snapshots."""
        return [self.lr, self.count, self.mu, self.nu]

    def _flat(self, tensors) -> torch.Tensor:
        return torch.cat([t.reshape(t.shape[0], -1) for t in tensors], dim=1)

    @torch.no_grad()
    def step(self, mask: torch.Tensor) -> None:
        b1, b2 = BETAS
        count = torch.where(mask, self.count + 1, self.count)
        c = count.float()[:, None]
        keep = mask[:, None]
        p = self._flat(self.params)
        g = self._flat([q.grad for q in self.params]) + self.weight_decay * p
        m_new = (1 - b1) * g + b1 * self.mu
        v_new = (1 - b2) * (g * g) + b2 * self.nu
        u = (m_new / (1 - b1 ** c)) / (torch.sqrt(v_new / (1 - b2 ** c)) + EPS)
        p = torch.where(keep, p + -self.lr[:, None] * u, p)
        for q, new in zip(self.params, p.split(self.sizes, dim=1)):
            q.copy_(new.view(q.shape))
        self.mu.copy_(torch.where(keep, m_new, self.mu))
        self.nu.copy_(torch.where(keep, v_new, self.nu))
        self.count.copy_(count)

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None


# ---------------------------------------------------------------------------
# Optimizer state in optax's layout
# ---------------------------------------------------------------------------

def optax_state(mu: dict, nu: dict, count, lr) -> dict:
    """The opt_state tree of make_optimizer's optax chain,
    inject_hyperparams(add_decayed_weights -> scale_by_adam -> scale): the
    moment trees `mu`, `nu` in the params layout, the step `count` (int32)
    and the learning rate (float32), scalars or [F] per fold."""
    count = _as(count, np.int32, torch.int32)
    return {
        "count": count,
        "hyperparams": {"learning_rate": _as(lr, np.float32, torch.float32)},
        "hyperparams_states": {},
        "inner_state": {"0": {}, "1": {"count": count, "mu": mu, "nu": nu}, "2": {}},
    }


def _as(value, np_dtype, torch_dtype):
    if isinstance(value, torch.Tensor):
        return value.detach().to(torch_dtype).clone()
    return np.asarray(value, np_dtype)


def _param_layout(model):
    """(flax path, parameter, transform) of every parameter of `model`."""
    return [(path, t, transform) for coll, path, t, transform in _layout(model)
            if coll == "params"]


def adam_state_tree(model, optimizer: torch.optim.Adam | None = None) -> dict:
    """torch Adam's state over `model`'s parameters as optax's opt_state
    (optax_state): exp_avg / exp_avg_sq as mu / nu with the weights'
    transposes, the step as the count, the first group's lr. Leaves are
    tensors; a parameter without state has zero moments. No optimizer
    gives the state of a fresh one at lr 0."""
    state = optimizer.state if optimizer is not None else {}
    mu, nu, step = {}, {}, 0
    for path, param, transform in _param_layout(model):
        moments = state.get(param, {})
        for tree, key in ((mu, "exp_avg"), (nu, "exp_avg_sq")):
            m = moments.get(key)
            put_leaf(tree, path, torch.zeros_like(transform(param.detach())) if m is None
                     else transform(m.detach()).clone())
        if "step" in moments:
            step = int(moments["step"])
    lr = optimizer.param_groups[0]["lr"] if optimizer is not None else 0.0
    return optax_state(mu, nu, step, lr)


def load_adam_state_tree(model, optimizer: torch.optim.Adam, opt_state: dict) -> None:
    """The inverse of adam_state_tree: optax's opt_state (tensor or numpy
    leaves) into torch Adam's per-parameter state and every group's lr. A
    count of 0 leaves the parameters without state, as a fresh optimizer
    has them."""
    inner = opt_state["inner_state"]["1"]
    count = int(np.asarray(inner["count"]))
    for path, param, transform in _param_layout(model):
        if count == 0:
            optimizer.state.pop(param, None)
            continue
        moments = {}
        for key, name in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
            value = transform(_to_tensor(get_leaf(inner[key], path)))
            if value.shape != param.shape:
                raise ValueError(f"opt_state {key}/{'/'.join(path)} has shape "
                                 f"{list(value.shape)}; the parameter {list(param.shape)}")
            moments[name] = torch.empty_like(param).copy_(value)
        optimizer.state[param] = {"step": torch.tensor(float(count), dtype=torch.float32),
                                  **moments}
    set_learning_rate(optimizer, np.asarray(opt_state["hyperparams"]["learning_rate"]))


def _fold_offsets(model, opt: FoldAdam) -> list[tuple[tuple, torch.Tensor, object, int, int]]:
    """(flax path, parameter, transform, offset, size) of every parameter
    in FoldAdam's flat [F, P] moments."""
    offsets, start = {}, 0
    for p, size in zip(opt.params, opt.sizes):
        offsets[id(p)] = (start, size)
        start += size
    out = [(path, p, transform, *offsets[id(p)]) for path, p, transform in _param_layout(model)]
    if sum(size for *_, size in out) != start:
        raise ValueError("FoldAdam holds parameters the flax layout does not name")
    return out


def fold_adam_state_tree(model, opt: FoldAdam) -> dict:
    """FoldAdam's state over a FoldStackedModel as the JAX sweep's stacked
    optax opt_state (every leaf [F, ...]; count and lr [F]). Tensor leaves."""
    mu, nu = {}, {}
    for path, p, transform, start, size in _fold_offsets(model, opt):
        for tree, flat in ((mu, opt.mu), (nu, opt.nu)):
            put_leaf(tree, path, transform(flat[:, start:start + size].reshape(p.shape)).clone())
    return optax_state(mu, nu, opt.count, opt.lr)


@torch.no_grad()
def load_fold_adam_state_tree(model, opt: FoldAdam, opt_state: dict) -> None:
    """The inverse of fold_adam_state_tree: moments, counts and learning
    rates of every fold from a stacked optax opt_state."""
    inner = opt_state["inner_state"]["1"]
    for path, p, transform, start, size in _fold_offsets(model, opt):
        for key, flat in (("mu", opt.mu), ("nu", opt.nu)):
            value = transform(_to_tensor(get_leaf(inner[key], path)))
            if value.shape != p.shape:
                raise ValueError(f"opt_state {key}/{'/'.join(path)} has shape "
                                 f"{list(value.shape)}; the parameter {list(p.shape)}")
            flat[:, start:start + size].copy_(value.reshape(p.shape[0], size))
    opt.count.copy_(_to_tensor(np.asarray(inner["count"], np.int32)))
    opt.lr.copy_(_to_tensor(np.asarray(opt_state["hyperparams"]["learning_rate"], np.float32)))


def state_tree(state: NamedTuple) -> dict:
    """A plateau or early-stopping state as flax's state dict of the JAX
    NamedTuple: {field: array}."""
    return {name: np.asarray(value) for name, value in zip(state._fields, state)}


def state_from_tree(template: NamedTuple, tree: dict) -> NamedTuple:
    """The inverse of state_tree: a state of template's type, each field in
    template's dtype and shape. Raises where the fields differ, as flax's
    restore does."""
    if set(tree) != set(template._fields):
        raise ValueError(f"state fields {sorted(tree)} are not "
                         f"{type(template).__name__}'s {sorted(template._fields)}")
    return type(template)(*(
        np.asarray(tree[name], np.asarray(old).dtype).reshape(np.shape(old))
        for name, old in zip(template._fields, template)))


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
    lr: np.ndarray       # current learning rate (float32)
    best: np.ndarray     # best (lowest) metric so far (float32)
    num_bad: np.ndarray  # epochs since last improvement


def plateau_init(lr, folds: int | None = None) -> PlateauState:
    """One run's state, or `folds` runs' (arrays [folds])."""
    shape = () if folds is None else (folds,)
    return PlateauState(lr=np.full(shape, lr, np.float32),
                        best=np.full(shape, np.inf, np.float32),
                        num_bad=np.zeros(shape, np.int32))


def plateau_update(state: PlateauState, metric, factor: float = 0.1,
                   patience: int = 3, threshold: float = 1e-4,
                   min_lr: float = 0.0) -> PlateauState:
    """One scheduler step on a to-minimize metric (torch's rel-threshold
    rule: improvement iff metric < best * (1 - threshold)), elementwise."""
    metric = np.asarray(metric, np.float32)
    improved = metric < state.best * np.float32(1.0 - threshold)
    best = np.where(improved, metric, state.best)
    num_bad = np.where(improved, 0, state.num_bad + 1)
    reduce = num_bad > patience
    lr = np.where(reduce, np.maximum(state.lr * np.float32(factor), np.float32(min_lr)),
                  state.lr)
    return PlateauState(lr=lr.astype(np.float32), best=best.astype(np.float32),
                        num_bad=np.where(reduce, 0, num_bad).astype(np.int32))


# ---------------------------------------------------------------------------
# EarlyStopping
# ---------------------------------------------------------------------------

class EarlyStoppingState(NamedTuple):
    best_score: np.ndarray  # monitored value at the best epoch (nan before any)
    counter: np.ndarray     # epochs since improvement
    should_stop: np.ndarray  # latched stop flag
    improved: np.ndarray    # this step was an improvement (=> checkpoint)
    best_epoch: np.ndarray


def early_stopping_init(folds: int | None = None) -> EarlyStoppingState:
    """One run's state, or `folds` runs' (arrays [folds])."""
    shape = () if folds is None else (folds,)
    return EarlyStoppingState(best_score=np.full(shape, np.nan, np.float32),
                              counter=np.zeros(shape, np.int32),
                              should_stop=np.zeros(shape, bool),
                              improved=np.zeros(shape, bool),
                              best_epoch=np.full(shape, -1, np.int32))


def early_stopping_update(state: EarlyStoppingState, score, epoch: int,
                          patience: int = 20, delta: float = 0.0,
                          legacy_inverted: bool = False) -> EarlyStoppingState:
    """One early-stopping step on the monitored score, elementwise.

    Default: score is a loss, improvement = score < best - delta.
    legacy_inverted: the reference's literal comparison, improvement =
    score >= best + delta (a rising loss counts as improvement); kept for
    bit-faithful replication studies."""
    score = np.asarray(score, np.float32)
    if legacy_inverted:
        better = score >= state.best_score + np.float32(delta)
    else:
        better = score < state.best_score - np.float32(delta)
    improved = np.isnan(state.best_score) | better
    counter = np.where(improved, 0, state.counter + 1).astype(np.int32)
    return EarlyStoppingState(
        best_score=np.where(improved, score, state.best_score).astype(np.float32),
        counter=counter,
        should_stop=state.should_stop | (counter >= patience),
        improved=improved & ~state.should_stop,
        best_epoch=np.where(improved, epoch, state.best_epoch).astype(np.int32),
    )
