"""The port's Trainer (multimodalsignal_tpu_torch/train/trainer.py) against the
JAX package's Trainer on the CPU, from the same weights, with dropout 0 and
shuffle=True (both shuffle with numpy's default_rng(seed), so the batch
orders agree).

The task is tests/test_trainer.py's `_toy_problem` at a small size (n = 40
train windows, not a multiple of B = 16, so every epoch has a padded last
batch). The validation windows' labels are flipped, so learning the train
rule raises the validation loss: with an early-stopping patience of 2 and a
plateau patience of 0 the learning rate drops and training stops within the
4-epoch horizon.

Tolerances. Per-epoch losses rtol 1e-4 and final parameters atol 1e-4:
both runs do the same float32 arithmetic in other summation orders for
about ten Adam steps, and Adam's normalized step amplifies the round-off of
near-zero gradients. Accuracy, F1, learning rates, the stop epoch and the
best epoch must agree exactly."""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodalsignal_tpu.config import EarlyStoppingConfig, ModelConfig, TrainerConfig
from multimodalsignal_tpu.models import build_model as build_jax_model
from multimodalsignal_tpu.train.checkpoints import restore_state
from multimodalsignal_tpu.train.trainer import TrainState
from multimodalsignal_tpu.train.trainer import Trainer as JaxTrainer
from multimodalsignal_tpu.train.trainer import init_train_state
from multimodalsignal_tpu_torch.config import EarlyStoppingConfig as PortES
from multimodalsignal_tpu_torch.config import ModelConfig as PortModelConfig
from multimodalsignal_tpu_torch.config import TrainerConfig as PortTrainerConfig
from multimodalsignal_tpu_torch.models.cnn_gru import build_model
from multimodalsignal_tpu_torch.models.convert import export_jax_variables
from multimodalsignal_tpu_torch.train.checkpoints import read_flax_checkpoint
from multimodalsignal_tpu_torch.train.trainer import Trainer, batch_indices

C, T, H, CLASSES, SEED = 3, 256, 8, 2, 0
MODEL = dict(gru_hidden_size=H, cnn_out_channels=8, dropout=0.0)
TRAINER = dict(epochs=4, batch_size=16, learning_rate=3e-3, lr_plateau_patience=0)
PATIENCE = 2


def _toy_problem(rng, n, c=C, t=T):
    """Class 1 = higher-frequency oscillation (tests/test_trainer.py)."""
    y = rng.integers(0, 2, n).astype(np.int32)
    tt = np.arange(t) / 128.0
    freq = np.where(y == 1, 8.0, 2.0)
    x = np.sin(2 * np.pi * freq[:, None, None] * tt[None, None, :])
    x = np.repeat(x, c, axis=1) + 0.1 * rng.standard_normal((n, c, t))
    return x.astype(np.float32), y


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(7)
    xv, yv = _toy_problem(rng, 20)
    return _toy_problem(rng, 40), (xv, 1 - yv), _toy_problem(rng, 12)


@pytest.fixture(scope="module")
def jax_run(data, tmp_path_factory):
    """The JAX trainer from flax-initialised weights; returns (trainer,
    initial variables, model)."""
    (x, y), val, _ = data
    jm = build_jax_model(ModelConfig(gru_impl="scan", **MODEL), CLASSES)
    cfg = TrainerConfig(early_stopping=EarlyStoppingConfig(patience=PATIENCE), **TRAINER)
    trainer = JaxTrainer(jm, tmp_path_factory.mktemp("jax"), cfg, CLASSES, seed=SEED)
    variables = jm.init(jax.random.PRNGKey(3), jnp.asarray(x[:2]), train=False)
    variables = jax.tree_util.tree_map(np.asarray, dict(variables))
    trainer.state = TrainState(params=variables["params"],
                               batch_stats=variables["batch_stats"],
                               opt_state=trainer.tx.init(variables["params"]))
    trainer.train((x, y), val)
    return trainer, variables, jm


def _port_trainer(tmp_path, variables, impl="torch", **cfg_fields):
    pm = build_model(PortModelConfig(gru_impl=impl, **MODEL), CLASSES, in_channels=C)
    cfg = PortTrainerConfig(early_stopping=PortES(patience=PATIENCE),
                            **dict(TRAINER, **cfg_fields))
    return Trainer(pm, tmp_path, cfg, CLASSES, seed=SEED, device="cpu",
                   variables=variables)


@pytest.mark.parametrize("impl", ["torch", "cuda"])
def test_trainer_matches_jax_trainer(impl, data, jax_run, tmp_path):
    """Per epoch: train loss, val loss, accuracy, F1 and LR; the stop and
    best epochs; the final (best) parameters and BN statistics."""
    (x, y), val, _ = data
    jt, variables, _ = jax_run
    pt = _port_trainer(tmp_path, variables, impl)
    pt.train((x, y), val)
    assert len(jt.history) < TRAINER["epochs"], "early stopping did not fire"
    assert len(pt.history) == len(jt.history)
    assert pt.best_epoch == int(np.argmin([h.val_loss for h in jt.history]))
    lrs = {h.lr for h in jt.history}
    assert len(lrs) > 1, "the plateau scheduler never changed the LR"
    for got, want in zip(pt.history, jt.history):
        assert got.epoch == want.epoch
        np.testing.assert_allclose(got.train_loss, want.train_loss, rtol=1e-4)
        np.testing.assert_allclose(got.val_loss, want.val_loss, rtol=1e-4)
        assert (got.val_acc, got.val_f1, got.lr) == (want.val_acc, want.val_f1, want.lr)
    final = export_jax_variables(pt.model)
    for coll, want_tree in (("params", jt.state.params),
                            ("batch_stats", jt.state.batch_stats)):
        want_leaves = jax.tree_util.tree_leaves_with_path(want_tree)
        for path, want in want_leaves:
            node = final[coll]
            for key in path:
                node = node[key.key]
            np.testing.assert_allclose(node, np.asarray(want), rtol=0, atol=1e-4,
                                       err_msg=f"{coll} {jax.tree_util.keystr(path)}")
    log = (tmp_path / "training_log.txt").read_text()
    assert "val acc" in log and "Early stopping triggered" in log
    assert "Restored best model" in log


def test_checkpoint_is_read_by_both_packages(data, jax_run, tmp_path):
    """best_model.msgpack restores into the JAX package's TrainState
    template (restore_state) and gives the port's logits, and the port's
    reader gives back the model's weights bit for bit."""
    (x, y), val, (xt, _) = data
    _, variables, jm = jax_run
    pt = _port_trainer(tmp_path, variables)
    pt.train((x, y), val)
    path = tmp_path / "best_model.msgpack"
    template = init_train_state(jm, jax.random.PRNGKey(1), jnp.asarray(x[:1]),
                                JaxTrainer(jm, tmp_path / "tpl", TrainerConfig(),
                                           CLASSES).tx)
    restored = restore_state(path, template)
    pt.model.eval()
    with torch.inference_mode():
        got = pt.model(torch.from_numpy(xt)).numpy()
    want = np.asarray(jm.apply({"params": restored.params,
                                "batch_stats": restored.batch_stats},
                               jnp.asarray(xt), train=False))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert int(restored.opt_state.count) == int(restored.opt_state.inner_state[1].count) > 0
    assert float(restored.opt_state.hyperparams["learning_rate"]) > 0
    back = read_flax_checkpoint(path)
    exported = export_jax_variables(pt.model)
    for coll in ("params", "batch_stats"):
        for (_, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(back[coll]),
                                  jax.tree_util.tree_leaves_with_path(exported[coll])):
            np.testing.assert_array_equal(a, b)


def test_artifacts_and_missing_matplotlib(data, jax_run, tmp_path, monkeypatch):
    """training_log.txt, test_probs.npy (rows summing to 1, argmax gives the
    reported accuracy), and the confusion-matrix PNG: written where
    matplotlib imports, logged and skipped where it does not."""
    (x, y), val, (xt, yt) = data
    _, variables, _ = jax_run
    pt = _port_trainer(tmp_path, variables, epochs=1)
    pt.train((x, y), val)
    _, acc, _ = pt.evaluate((xt, yt), is_test=True)
    probs = np.load(tmp_path / "test_probs.npy")
    assert probs.shape == (len(yt), CLASSES)
    np.testing.assert_allclose(probs.sum(axis=1), 1.0, rtol=1e-5)
    assert (probs.argmax(axis=1) == yt).mean() == pytest.approx(acc, abs=1e-6)
    assert (tmp_path / "test_confusion_matrix.png").exists()
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    pt.plot_confusion_matrix(yt, probs.argmax(axis=1), "again.png")
    assert not (tmp_path / "again.png").exists()
    log = (tmp_path / "training_log.txt").read_text()
    assert "Final test results" in log and "Failed to save confusion matrix" in log


def test_empty_steps_change_nothing(data, tmp_path):
    """Lockstep padding: extra all-zero-weight steps are skipped whole, so
    the run equals the unpadded one bit for bit (no BN update, no Adam
    step)."""
    (x, y), val, _ = data
    pm = build_model(PortModelConfig(**MODEL), CLASSES, in_channels=C)
    variables = export_jax_variables(pm)
    runs = []
    for steps in (None, 6):
        pm = build_model(PortModelConfig(**MODEL), CLASSES, in_channels=C)
        cfg = PortTrainerConfig(epochs=2, batch_size=16,
                                early_stopping=PortES(enabled=False))
        t = Trainer(pm, tmp_path / str(steps), cfg, CLASSES, seed=SEED, device="cpu",
                    steps_per_epoch=steps, variables=variables)
        t.train((x, y), val)
        runs.append(t)
    assert [h.train_loss for h in runs[0].history] == [h.train_loss for h in runs[1].history]
    for (k, a), (_, b) in zip(runs[0].model.state_dict().items(),
                              runs[1].model.state_dict().items()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=k)
    assert runs[1].optimizer.state_dict()["state"][0]["step"] == 6  # 3 real steps x 2


def test_batch_indices_contract():
    idx, w = batch_indices(10, 4, rng=np.random.default_rng(0))
    assert idx.shape == (3, 4) and w.shape == (3, 4) and w.sum() == 10
    assert sorted(idx.reshape(-1)[w.reshape(-1) > 0].tolist()) == list(range(10))
    assert idx[2, 2:].tolist() == [0, 0]  # padded tail wraps to index 0
    idx2, w2 = batch_indices(10, 4, steps=5, rng=np.random.default_rng(0))
    assert idx2.shape == (5, 4) and w2[3:].sum() == 0 and w2.sum() == 10
    np.testing.assert_array_equal(idx2[:3], idx)  # same permutation


@pytest.mark.parametrize("field", [dict(checkpoint_every=1), dict(resume=True)])
def test_mid_run_resume_is_refused(field, tmp_path):
    pm = build_model(PortModelConfig(**MODEL), CLASSES, in_channels=C)
    with pytest.raises(NotImplementedError, match="mid-run resume"):
        Trainer(pm, tmp_path, PortTrainerConfig(**field), CLASSES, device="cpu")
