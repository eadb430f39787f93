"""Single-fold trainer (counterpart of multimodalsignal_tpu/train/trainer.py).

    model = build_model(cfg.model, cfg.num_classes, in_channels=3)
    trainer = Trainer(model, "output/run/fold_test_on_S2", cfg.trainer,
                      num_classes=2, seed=42)              # on the GPU
    trainer.train((x_train, y_train), (x_val, y_val))
    trainer.evaluate((x_test, y_test), is_test=True)

Artifacts, as the JAX trainer writes them: `training_log.txt`,
`best_model.msgpack` (rewritten at every improvement, in the JAX package's
TrainState layout, which both packages read), and at a test evaluation
`test_probs.npy` and `test_confusion_matrix.png` (logged and skipped where
matplotlib is missing).

Semantics carried over from the JAX trainer:
  * The fold's data is staged on the device once (the hybrid model's pair
    of streams alike); batches are gathered there
    through a wrap-padded [steps, B] index grid with 0/1 sample weights
    (`batch_indices`), shuffled each epoch by numpy's
    default_rng(seed).permutation, so both packages see the same order.
  * Batch norm sees the whole B-row batch, zero-weight rows included; the
    loss is sum(ce * w) / max(sum(w), 1e-12) with optional class weights.
  * A step whose weights sum to 0 changes nothing (no parameter, BN buffer,
    Adam moment or step count); it is skipped whole, forward included.
  * The epoch's train loss is sum(loss * wsum) / sum(wsum).
  * After each epoch: evaluate, plateau_update, set_learning_rate, early
    stopping, checkpoint on improvement; the best state (weights, buffers,
    optimizer) is restored at the end unless
    legacy_restore_only_on_early_stop and no early stop fired.

Dropout draws from one `torch.Generator` on the model's device seeded with
`seed`; `TrainerConfig.dropout_rng` is accepted and does not change that
(the port has one generator kind). Masks cannot match the JAX package's.

Mid-run resume, as the JAX trainer does it: with `checkpoint_every` = k > 0
the state is saved every k epochs (after early stopping's check, so the
epoch that stops writes none) as `resume_state.msgpack`, the JAX bundle
(state, best state, early-stopping state, plateau state) in flax's layout,
with `resume_meta.json` ({"next_epoch": k}) and the dropout generator's
state in `resume_rng.pt` beside it (the JAX bundle has no place for it).
With `resume` and a bundle present, train() restores all of it (a JAX
bundle too; without resume_rng.pt the generator stays as seeded), replays
the shuffle stream over the epochs before the cut and goes on from there;
the log keeps the epochs logged before the cut. On one CPU thread a run cut
and resumed equals the uncut run bit for bit.
Runs on "cuda" unless the caller passes device="cpu"; asking for CUDA where
there is none raises.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from multimodalsignal_tpu_torch.config import TrainerConfig
from multimodalsignal_tpu_torch.experiments.predict import map_streams, resolve_device
from multimodalsignal_tpu_torch.models.convert import load_jax_variables
from multimodalsignal_tpu_torch.train import metrics as M
from multimodalsignal_tpu_torch.train.checkpoints import (
    load_train_state_tree,
    train_state_tree,
    unpackb,
    write_tree,
)
from multimodalsignal_tpu_torch.train.optim import (
    early_stopping_init,
    early_stopping_update,
    make_optimizer,
    plateau_init,
    plateau_update,
    set_learning_rate,
    state_from_tree,
    state_tree,
)
from multimodalsignal_tpu_torch.utils.run import TeeLogger


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, weights: torch.Tensor,
                  class_weights: torch.Tensor | None = None):
    """Weighted-mean CE with torch.nn.CrossEntropyLoss semantics: with class
    weights the denominator is the sum of the per-sample weights. Returns
    (loss, sum of weights). Leading axes are lanes, each its own mean:
    logits [F, B, K], labels and weights [F, B], class_weights [F, K] give
    a loss and a sum per lane, [F]."""
    log_probs = F.log_softmax(logits, dim=-1)
    ce = -log_probs.gather(-1, labels[..., None])[..., 0]
    w = weights
    if class_weights is not None:
        w = w * class_weights.gather(-1, labels)
    wsum = w.sum(dim=-1)
    return (ce * w).sum(dim=-1) / wsum.clamp(min=1e-12), wsum


def batch_indices(n: int, batch_size: int, steps: int | None = None,
                  rng: np.random.Generator | None = None) -> tuple[np.ndarray, np.ndarray]:
    """Wrap-padded [steps, B] index grid + 0/1 weights. With rng: shuffled
    (training). steps > ceil(n/B) appends all-zero-weight batches; the padded
    tail of the last real batch points at index 0 with weight 0."""
    real_steps = max(-(-n // batch_size), 1)
    steps = steps or real_steps
    order = rng.permutation(n) if rng is not None else np.arange(n)
    total = steps * batch_size
    idx = np.zeros(total, dtype=np.int64)
    w = np.zeros(total, dtype=np.float32)
    take = min(n, total)
    idx[:take] = order[:take]
    w[:take] = 1.0
    return idx.reshape(steps, batch_size), w.reshape(steps, batch_size)


def take(x, rows: torch.Tensor):
    """Rows of a batch: windows [N, ...], or both streams of the hybrid
    model's (windows, features) pair by the same rows."""
    return map_streams(lambda a: a[rows], x)


class EpochLog(NamedTuple):
    epoch: int
    duration_s: float
    train_loss: float
    val_loss: float
    val_acc: float
    val_f1: float
    lr: float


class Trainer:
    """Single-fold trainer with the reference's artifact contract.

    `model` is a port model (models/cnn_gru.py build_model); `variables`, if
    given, is a flax {"params", "batch_stats"} pair loaded into it first
    (load_jax_variables), so a run can start from the JAX package's weights.
    """

    def __init__(self, model, fold_output_dir: Path | str, cfg: TrainerConfig,
                 num_classes: int, seed: int = 42,
                 class_weights: np.ndarray | None = None,
                 steps_per_epoch: int | None = None,
                 device: str | torch.device = "cuda",
                 variables: dict | None = None):
        self.device = resolve_device(device)
        self.model = model
        if variables is not None:
            load_jax_variables(model, variables["params"], variables["batch_stats"])
        model.to(self.device)
        self.cfg = cfg
        self.num_classes = num_classes
        self.seed = seed
        self.steps_per_epoch = steps_per_epoch
        self.fold_dir = Path(fold_output_dir)
        self.fold_dir.mkdir(parents=True, exist_ok=True)
        self.log_file = self.fold_dir / "training_log.txt"
        # A resumed run appends to the log, keeping the epochs before the cut.
        self._log = TeeLogger(self.log_file, header="Training log for run starting at "
                              f"{time.strftime('%Y-%m-%d %H:%M:%S')}", append=cfg.resume)
        self.optimizer = make_optimizer(model.parameters(), cfg.learning_rate,
                                        cfg.weight_decay)
        self.class_weights = (None if class_weights is None else torch.as_tensor(
            np.asarray(class_weights, np.float32), device=self.device))
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self.history: list[EpochLog] = []
        self.best_epoch: int | None = None  # 0-based, as EarlyStoppingState
        self._t0 = time.time()

    # -- data -----------------------------------------------------------------
    def _stage(self, ds):
        """(x, y) or a dataset with .x/.y -> float32 x and int64 y on the
        device, once per call. x is windows [N, C, T] or, for the hybrid
        model, the pair (windows, features [N, F])."""
        x, y = (ds.x, ds.y) if hasattr(ds, "x") else ds
        x = map_streams(lambda a: torch.as_tensor(np.asarray(a, np.float32), device=self.device), x)
        return x, torch.as_tensor(np.asarray(y, np.int64), device=self.device)

    def _grid(self, idx: np.ndarray, w: np.ndarray):
        return (torch.from_numpy(idx).to(self.device),
                torch.from_numpy(w).to(self.device))

    # -- state ----------------------------------------------------------------
    def _snapshot(self) -> dict:
        """The train state as the JAX package's TrainState tree (copies on
        the device): what best_model.msgpack and the resume bundle hold."""
        return train_state_tree(self.model, self.optimizer)

    def _restore(self, snap: dict) -> None:
        load_train_state_tree(self.model, self.optimizer, snap)

    # -- mid-run resume (JAX trainer.py _resume_path/_save_resume/_load_resume)
    def _resume_path(self) -> Path:
        return self.fold_dir / "resume_state.msgpack"

    def _save_resume(self, best: dict, es_state, pl_state, next_epoch: int) -> None:
        bundle = (self._snapshot(), best, state_tree(es_state), state_tree(pl_state))
        write_tree(self._resume_path(), {str(i): t for i, t in enumerate(bundle)})
        torch.save(self.generator.get_state(), self.fold_dir / "resume_rng.pt")
        (self.fold_dir / "resume_meta.json").write_text(json.dumps({"next_epoch": next_epoch}))

    def _load_resume(self, es_state, pl_state):
        """Restore the bundle into the model, optimizer and generator;
        returns (best snapshot, early-stopping state, plateau state, next
        epoch)."""
        bundle = unpackb(self._resume_path().read_bytes())
        self._restore(bundle["1"])
        best = self._snapshot()
        self._restore(bundle["0"])
        es_state = state_from_tree(es_state, bundle["2"])
        pl_state = state_from_tree(pl_state, bundle["3"])
        set_learning_rate(self.optimizer, pl_state.lr)
        rng = self.fold_dir / "resume_rng.pt"
        if rng.exists():
            self.generator.set_state(torch.load(rng, weights_only=True))
        meta = json.loads((self.fold_dir / "resume_meta.json").read_text())
        return best, es_state, pl_state, int(meta["next_epoch"])

    # -- training -------------------------------------------------------------
    def train_step(self, xb: torch.Tensor, yb: torch.Tensor, wb: torch.Tensor):
        """One Adam step on one batch in training mode. Returns (loss, sum of
        weights) as device tensors; the parameters keep their gradients."""
        self.model.train()
        logits = self.model(xb, self.generator)
        loss, wsum = cross_entropy(logits, yb, wb, self.class_weights)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        self.optimizer.step()
        return loss.detach(), wsum.detach()

    def _train_epoch(self, x, y, idx: np.ndarray, w: np.ndarray) -> float:
        idx_t, w_t = self._grid(idx, w)
        loss_sum = torch.zeros((), dtype=torch.float32, device=self.device)
        w_sum = torch.zeros((), dtype=torch.float32, device=self.device)
        for step in range(idx.shape[0]):
            if w[step].sum() == 0:  # an empty step changes nothing
                continue
            rows = idx_t[step]
            loss, wsum = self.train_step(take(x, rows), y[rows], w_t[step])
            loss_sum += loss * wsum
            w_sum += wsum
        return float(loss_sum / w_sum.clamp(min=1e-12))

    def _eval(self, x, y, idx: np.ndarray, w: np.ndarray):
        """(weighted loss, confusion matrix, softmax probs [steps*B, K])."""
        idx_t, w_t = self._grid(idx, w)
        k = self.num_classes
        loss_sum = torch.zeros((), dtype=torch.float32, device=self.device)
        w_sum = torch.zeros((), dtype=torch.float32, device=self.device)
        cm = torch.zeros((k, k), dtype=torch.float32, device=self.device)
        probs = []
        self.model.eval()
        with torch.inference_mode():
            for step in range(idx.shape[0]):
                rows, wb = idx_t[step], w_t[step]
                yb = y[rows]
                logits = self.model(take(x, rows))
                loss, wsum = cross_entropy(logits, yb, wb, self.class_weights)
                cm += M.confusion_matrix(yb, logits.argmax(dim=-1), k, wb)
                probs.append(torch.softmax(logits, dim=-1))
                loss_sum += loss * wsum
                w_sum += wsum
        return float(loss_sum / w_sum.clamp(min=1e-12)), cm, torch.cat(probs)

    def train(self, train_ds, val_ds):
        cfg = self.cfg
        x_tr, y_tr = self._stage(train_ds)
        x_va, y_va = self._stage(val_ds)
        n = int(y_tr.shape[0])
        order_rng = np.random.default_rng(self.seed) if cfg.shuffle else None
        es_state = early_stopping_init()
        pl_state = plateau_init(cfg.learning_rate)
        es_cfg = cfg.early_stopping
        best = self._snapshot()
        val_idx, val_w = batch_indices(int(y_va.shape[0]), cfg.batch_size)

        start_epoch = 0
        if cfg.resume and self._resume_path().exists():
            best, es_state, pl_state, start_epoch = self._load_resume(es_state, pl_state)
            self._log(f"Resumed from epoch {start_epoch}")
            for _ in range(start_epoch):   # replay the shuffle stream
                batch_indices(n, cfg.batch_size, self.steps_per_epoch, order_rng)

        stopped = False
        for epoch in range(start_epoch, cfg.epochs):
            t_start = time.time()
            idx, w = batch_indices(n, cfg.batch_size, self.steps_per_epoch, order_rng)
            train_loss = self._train_epoch(x_tr, y_tr, idx, w)
            val_loss, cm, _ = self._eval(x_va, y_va, val_idx, val_w)
            val_acc = float(M.accuracy_from_cm(cm))
            val_f1 = float(M.weighted_f1_from_cm(cm))

            # ReduceLROnPlateau on val loss (reference trainer.py:160).
            pl_state = plateau_update(
                pl_state, val_loss, factor=cfg.lr_plateau_factor,
                patience=cfg.lr_plateau_patience, threshold=cfg.lr_plateau_threshold)
            set_learning_rate(self.optimizer, pl_state.lr)

            duration = time.time() - t_start
            self.history.append(EpochLog(epoch + 1, duration, train_loss, val_loss,
                                         val_acc, val_f1, float(pl_state.lr)))
            self._log(
                f"Epoch {epoch + 1}/{cfg.epochs} | {duration:.2f}s | "
                f"train loss: {train_loss:.4f} | val loss: {val_loss:.4f} | "
                f"val acc: {val_acc:.4f} | val F1: {val_f1:.4f}")

            if es_cfg.enabled:
                es_state = early_stopping_update(
                    es_state, val_loss, epoch, patience=es_cfg.patience,
                    delta=es_cfg.delta, legacy_inverted=es_cfg.legacy_inverted)
                if es_state.improved:
                    best = self._snapshot()
                    write_tree(self.fold_dir / "best_model.msgpack", best)
                if es_state.should_stop:
                    self._log("Early stopping triggered")
                    stopped = True
                    break

            if cfg.checkpoint_every > 0 and (epoch + 1) % cfg.checkpoint_every == 0:
                self._save_resume(best, es_state, pl_state, epoch + 1)

        if es_cfg.enabled:
            self.best_epoch = es_state.best_epoch
            if stopped or not cfg.legacy_restore_only_on_early_stop:
                # The reference reloads the best weights only after an early
                # stop (trainer.py:185-187); by default they are always restored.
                self._restore(best)
                self._log(f"Restored best model (epoch {es_state.best_epoch + 1})")
        self._log(f"--- Training complete --- total: {time.time() - self._t0:.2f}s")
        return self.model

    # -- evaluation -----------------------------------------------------------
    def evaluate(self, ds, is_test: bool = False, is_val: bool = False):
        x, y = self._stage(ds)
        n = int(y.shape[0])
        idx, w = batch_indices(n, self.cfg.batch_size)
        loss, cm, probs = self._eval(x, y, idx, w)
        acc = float(M.accuracy_from_cm(cm))
        f1 = float(M.weighted_f1_from_cm(cm))
        probs_np = probs[:n].cpu().numpy()
        preds_np = probs_np.argmax(axis=-1)
        labels_np = y.cpu().numpy()
        if is_test:
            self.plot_confusion_matrix(labels_np, preds_np, "test_confusion_matrix.png")
            # Per-window softmax probabilities (reference trainer.py:224-231).
            np.save(self.fold_dir / "test_probs.npy", probs_np)
            self._log("\n--- Final test results ---")
            self._log(f"test loss: {loss:.4f} | test acc: {acc:.4f} | test F1: {f1:.4f}")
            return loss, acc, f1
        if is_val:
            return loss, acc, f1, preds_np, labels_np
        return loss, acc, f1

    def plot_confusion_matrix(self, true_labels, pred_labels,
                              filename: str = "confusion_matrix.png") -> None:
        """Heatmap PNG with the reference's class-count-dependent label sets
        (trainer.py:249-273)."""
        try:
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt

            if len(np.unique(true_labels)) == 2:
                labels = ["Non-Stress", "Stress"]
            else:
                labels = ["Neutral/Baseline", "Amusement", "Stress/TSST"]
            cm = np.zeros((len(labels), len(labels)), dtype=int)
            for t, p in zip(true_labels, pred_labels):
                if t < len(labels) and p < len(labels):
                    cm[int(t), int(p)] += 1
            fig, ax = plt.subplots(figsize=(8, 6))
            im = ax.imshow(cm, cmap="Blues")
            ax.set_xticks(range(len(labels)), labels, rotation=30, ha="right")
            ax.set_yticks(range(len(labels)), labels)
            for i in range(len(labels)):
                for j in range(len(labels)):
                    ax.text(j, i, str(cm[i, j]), ha="center", va="center",
                            color="white" if cm[i, j] > cm.max() / 2 else "black")
            ax.set_xlabel("Predicted Label")
            ax.set_ylabel("True Label")
            ax.set_title("Confusion Matrix")
            fig.colorbar(im)
            fig.tight_layout()
            path = self.fold_dir / filename
            fig.savefig(path)
            plt.close(fig)
            self._log(f"Confusion matrix saved to: {path}")
        except Exception as e:  # parity: the reference logs and continues
            self._log(f"Failed to save confusion matrix: {e}")
