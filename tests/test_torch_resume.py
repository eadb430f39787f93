"""Mid-run resume of the port (multimodalsignal_tpu_torch: train/trainer.py,
parallel/fold_sweep.py, train/checkpoints.py, train/optim.py, utils/run.py):
a run cut after epoch k and resumed against the run that was not cut, and
the resume bundles across the two packages, on the CPU at a small size (C=3,
T=256, H=8, 4 subjects, 6 epochs).

Tolerances. Cut and resumed against uncut: bit for bit (one torch thread;
every state a run carries is in the bundle or replayed: the numpy shuffle
streams, the dropout generators, Adam's moments and counts, the plateau's
and early stopping's counters, the best snapshot with its BN statistics, a
stopped fold's coasting state). Across the packages, dropout 0: the bundles'
leaves exactly; a run resumed by one package from the other's bundle
against the other's own resumed run, losses rtol 1e-4 and parameters atol
1e-4 (both packages do the same float32 arithmetic in other summation
orders, as tests/test_torch_trainer.py), accuracy, F1, learning rates and the
best epoch exactly.
"""

import dataclasses
import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodalsignal_tpu import config as jcfg
from multimodalsignal_tpu.models import build_model as build_jax_model
from multimodalsignal_tpu.parallel import fold_sweep as jfs
from multimodalsignal_tpu.train import optim as jax_optim
from multimodalsignal_tpu.train.checkpoints import restore_state
from multimodalsignal_tpu.train.trainer import Trainer as JaxTrainer
from multimodalsignal_tpu.train.trainer import TrainState, init_train_state
from multimodalsignal_tpu_torch import config as pcfg
from multimodalsignal_tpu_torch.data import dataset as pdata
from multimodalsignal_tpu_torch.models.cnn_gru import build_model
from multimodalsignal_tpu_torch.models.convert import export_jax_variables
from multimodalsignal_tpu_torch.parallel import fold_sweep as pfs
from multimodalsignal_tpu_torch.train.checkpoints import read_train_state, unpackb
from multimodalsignal_tpu_torch.train.optim import adam_state_tree
from multimodalsignal_tpu_torch.train.trainer import Trainer
from tests.test_torch_fold_sweep import CHANNELS, SUBJECTS, write_tree

C, T, H, K, SEED, EPOCHS = 3, 256, 8, 2, 0, 6
MODEL = dict(gru_hidden_size=H, cnn_out_channels=8)
TRAINER = dict(epochs=EPOCHS, batch_size=16, learning_rate=3e-3, lr_plateau_patience=0)
PATIENCE = 10   # the serial runs do not stop; the sweep's folds do (SWEEP_ES)
SWEEP_ES = dict(patience=1, delta=0.0)
SWEEP_TRAINER = dict(epochs=EPOCHS, batch_size=4, learning_rate=5e-3, lr_plateau_patience=0)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Bitwise equality needs one reduction order: one intra-op thread (it
    also keeps the sweep's many small CPU ops fast under xdist)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


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
    """40 train windows (a padded last batch of 16) and 20 validation
    windows with flipped labels: the validation loss rises, so the best
    epoch is early, before the cut, and the plateau lowers the lr."""
    rng = np.random.default_rng(7)
    train = _toy_problem(rng, 40)
    xv, yv = _toy_problem(rng, 20)
    return train, (xv, 1 - yv)


@pytest.fixture(scope="module")
def variables():
    pm = build_model(pcfg.ModelConfig(**MODEL), K, in_channels=C)
    return export_jax_variables(pm)


def _trainer(fold_dir, variables, dropout=0.0, **fields):
    pm = build_model(pcfg.ModelConfig(dropout=dropout, **MODEL), K, in_channels=C)
    cfg = pcfg.TrainerConfig(early_stopping=pcfg.EarlyStoppingConfig(patience=PATIENCE),
                             **dict(TRAINER, **fields))
    return Trainer(pm, fold_dir, cfg, K, seed=SEED, device="cpu", variables=variables)


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    else:
        yield "/".join(prefix), np.asarray(tree)


def _assert_trees_equal(got, want, what):
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert got.keys() == want.keys(), what
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=f"{what} {name}")
        assert got[name].dtype == want[name].dtype, f"{what} {name}"


def _history(trainer):
    return [(h.epoch, h.train_loss, h.val_loss, h.val_acc, h.val_f1, h.lr)
            for h in trainer.history]


@pytest.mark.parametrize("dropout", [0.0, 0.5])
def test_serial_cut_and_resumed_equals_uncut(dropout, data, variables, tmp_path):
    """Trainer cut after epoch 3 (checkpoint_every=3) and resumed in a new
    Trainer: parameters, BN statistics, Adam's moments and counts, the
    history and the best epoch bit for bit the uncut run's; the log keeps
    the epochs before the cut."""
    train, val = data
    full = _trainer(tmp_path / "full", variables, dropout)
    full.train(train, val)
    cut = _trainer(tmp_path / "part", variables, dropout, epochs=3, checkpoint_every=3)
    cut.train(train, val)
    meta = json.loads((tmp_path / "part" / "resume_meta.json").read_text())
    assert meta == {"next_epoch": 3}
    resumed = _trainer(tmp_path / "part", None, dropout, resume=True)
    resumed.train(train, val)

    assert [h.epoch for h in resumed.history] == [4, 5, 6]
    assert _history(cut) + _history(resumed) == _history(full)
    assert len({h.lr for h in full.history}) > 1, "the plateau never changed the lr"
    assert resumed.best_epoch == full.best_epoch < 3, "the best epoch is not before the cut"
    _assert_trees_equal(export_jax_variables(resumed.model), export_jax_variables(full.model),
                        "variables")
    _assert_trees_equal(adam_state_tree(resumed.model, resumed.optimizer),
                        adam_state_tree(full.model, full.optimizer), "opt_state")
    # The best state was restored at the end: best_model.msgpack, read whole,
    # holds it with its optimizer state.
    _assert_trees_equal(read_train_state(tmp_path / "full" / "best_model.msgpack")["opt_state"],
                        adam_state_tree(full.model, full.optimizer), "best_model opt_state")
    log = (tmp_path / "part" / "training_log.txt").read_text()
    assert "Epoch 1/3" in log and "Epoch 3/3" in log and "Epoch 6/6" in log
    assert log.index("Epoch 3/3") < log.index("Resumed from epoch 3") < log.index("Epoch 4/6")
    assert "\n--- Training log for run starting at" in log


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return write_tree(tmp_path_factory.mktemp("resume") / "data", t=T)


@pytest.fixture(scope="module")
def staged(tree):
    corpus = pdata.pack_corpus(tree, list(SUBJECTS), CHANNELS, pdata.read_channel_names(tree))
    cfg = _sweep_config(tree)
    return corpus, pfs.build_fold_batch(corpus, list(SUBJECTS), cfg.val_fraction, cfg.seed)


def _sweep_config(tree, dropout=0.0, sweep_dispatch="per_epoch", **trainer):
    return pcfg.ExperimentConfig(
        subjects=SUBJECTS, data_path=str(tree), seed=5, val_fraction=0.3,
        channels_to_use=tuple(CHANNELS), sweep_dispatch=sweep_dispatch,
        model=pcfg.ModelConfig(dropout=dropout, **MODEL),
        trainer=pcfg.TrainerConfig(early_stopping=pcfg.EarlyStoppingConfig(**SWEEP_ES),
                                   **dict(SWEEP_TRAINER, **trainer)))


def _assert_sweeps_equal(got, want):
    for name in ("test_cm", "test_loss", "best_epoch", "stop_epoch", "test_probs"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)
    for name in pfs.SweepHistory._fields:
        np.testing.assert_array_equal(getattr(got.history, name), getattr(want.history, name),
                                      err_msg=name)
    _assert_trees_equal(got.final_variables, want.final_variables, "final variables")


@pytest.mark.parametrize("dropout,every,abort", [(0.0, 3, 3), (0.5, 3, 4), (0.5, 4, 4)])
def test_sweep_cut_and_resumed_equals_uncut(dropout, every, abort, staged, tree, tmp_path):
    """run_fold_sweep with abort_after_epoch raising SweepAborted, then
    resumed from the last checkpoint: every result bit for bit the uncut
    sweep's, with folds that stopped before, at and after the cut."""
    corpus, fb = staged
    full = pfs.run_fold_sweep(corpus, fb, _sweep_config(tree, dropout), "cpu")
    stops = full.stop_epoch.tolist()
    assert len({s for s in stops if s < EPOCHS}) >= 2, f"folds stopped at {stops}"
    assert min(stops) <= every < max(stops), f"no fold coasts across the cut: {stops}"
    cfg = _sweep_config(tree, dropout, checkpoint_every=every, resume=True)
    with pytest.raises(pfs.SweepAborted, match=f"after epoch {abort}"):
        pfs.run_fold_sweep(corpus, fb, cfg, "cpu", run_dir=tmp_path, abort_after_epoch=abort)
    meta = json.loads((tmp_path / "sweep_resume_meta.json").read_text())
    assert meta == {"next_epoch": every}
    with np.load(tmp_path / "sweep_resume_logs.npz") as logs:
        assert sorted(logs.files) == [f"c{j}" for j in range(6)]
        assert logs["c1"].shape == (len(fb.test_subjects), every)
    resumed = pfs.run_fold_sweep(corpus, fb, cfg, "cpu", run_dir=tmp_path)
    _assert_sweeps_equal(resumed, full)


@pytest.mark.parametrize("where", ["no run_dir", "no bundle"])
def test_sweep_resume_is_inert_without_a_bundle(where, staged, tree, tmp_path):
    """resume=True with no run_dir, or a run_dir without a bundle, trains
    from epoch 0 as the plain sweep; checkpoints are written only into a
    run_dir."""
    corpus, fb = staged
    plain = pfs.run_fold_sweep(corpus, fb, _sweep_config(tree), "cpu")
    cfg = _sweep_config(tree, checkpoint_every=1, resume=True)
    run_dir = None if where == "no run_dir" else tmp_path
    _assert_sweeps_equal(pfs.run_fold_sweep(corpus, fb, cfg, "cpu", run_dir=run_dir), plain)
    assert (tmp_path / "sweep_resume.msgpack").exists() == (run_dir is not None)


@pytest.mark.parametrize("case", ["checkpoint", "live resume", "drill"])
def test_segmented_refuses_resume(case, staged, tree, tmp_path):
    """sweep_dispatch="segmented" (run as per_epoch here) refuses what the
    JAX package refuses: a checkpoint, a live resume and the drill, before
    any restore; resume=True without a bundle stays inert."""
    corpus, fb = staged
    seg = _sweep_config(tree, sweep_dispatch="segmented", resume=True)
    kwargs = dict(run_dir=tmp_path)
    if case == "checkpoint":
        seg = dataclasses.replace(seg, trainer=dataclasses.replace(seg.trainer,
                                                                   checkpoint_every=2))
    elif case == "live resume":
        pfs.run_fold_sweep(corpus, fb, _sweep_config(tree, checkpoint_every=1, epochs=1),
                           "cpu", run_dir=tmp_path)
    else:
        kwargs["abort_after_epoch"] = 1
    with pytest.raises(ValueError, match="segmented dispatch does not support them"):
        pfs.run_fold_sweep(corpus, fb, seg, "cpu", **kwargs)
    if case != "live resume":   # no bundle in run_dir: resume=True is inert
        short = _sweep_config(tree, sweep_dispatch="segmented", resume=True, epochs=1)
        pfs.run_fold_sweep(corpus, fb, short, "cpu", run_dir=tmp_path)


# ---------------------------------------------------------------------------
# Across the packages (dropout 0)
# ---------------------------------------------------------------------------

def _jax_trainer(fold_dir, variables, jm, **fields):
    cfg = jcfg.TrainerConfig(early_stopping=jcfg.EarlyStoppingConfig(patience=PATIENCE),
                             **dict(TRAINER, **fields))
    trainer = JaxTrainer(jm, fold_dir, cfg, K, seed=SEED)
    trainer.state = TrainState(params=variables["params"],
                               batch_stats=variables["batch_stats"],
                               opt_state=trainer.tx.init(variables["params"]))
    return trainer


def _jax_bundle_template(jm, x):
    tx = jax_optim.make_optimizer(TRAINER["learning_rate"], 0.0)
    state = init_train_state(jm, jax.random.PRNGKey(1), jnp.asarray(x[:1]), tx)
    return (state, state, jax_optim.early_stopping_init(),
            jax_optim.plateau_init(TRAINER["learning_rate"]))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_serial_bundle_resumed_across_packages(writer, data, variables, tmp_path):
    """One package cuts after epoch 3 and the other resumes from its
    bundle: the other package's restore reads it (JAX's restore_state with
    JAX's template: the port's leaves exactly), and the run ends within
    the tolerances of the writer's own resumed run."""
    train, val = data
    jm = build_jax_model(jcfg.ModelConfig(gru_impl="scan", dropout=0.0, **MODEL), K)
    cut_dir = tmp_path / "cut"
    if writer == "jax":
        _jax_trainer(cut_dir, variables, jm, epochs=3, checkpoint_every=3).train(train, val)
    else:
        _trainer(cut_dir, variables, epochs=3, checkpoint_every=3).train(train, val)
        restored = restore_state(cut_dir / "resume_state.msgpack",
                                 _jax_bundle_template(jm, train[0]))
        _assert_trees_equal(unpackb((cut_dir / "resume_state.msgpack").read_bytes()),
                            jax.tree_util.tree_map(np.asarray, flax_state_dict(restored)),
                            "bundle")
    for name in ("jax", "port"):
        shutil.copytree(cut_dir, tmp_path / name)
    jt = _jax_trainer(tmp_path / "jax", variables, jm, resume=True)
    jt.train(train, val)
    pt = _trainer(tmp_path / "port", None, resume=True)
    pt.train(train, val)

    assert [h.epoch for h in pt.history] == [h.epoch for h in jt.history] == [4, 5, 6]
    for got, want in zip(pt.history, jt.history):
        np.testing.assert_allclose(got.train_loss, want.train_loss, rtol=1e-4)
        np.testing.assert_allclose(got.val_loss, want.val_loss, rtol=1e-4)
        assert (got.val_acc, got.val_f1, got.lr) == (want.val_acc, want.val_f1, want.lr)
    final = export_jax_variables(pt.model)
    for coll, want_tree in (("params", jt.state.params), ("batch_stats", jt.state.batch_stats)):
        for path, want in jax.tree_util.tree_leaves_with_path(want_tree):
            node = final[coll]
            for key in path:
                node = node[key.key]
            np.testing.assert_allclose(node, np.asarray(want), rtol=0, atol=1e-4,
                                       err_msg=f"{coll} {jax.tree_util.keystr(path)}")
    assert "Resumed from epoch 3" in (tmp_path / "port" / "training_log.txt").read_text()


def test_sweep_bundle_read_by_jax(staged, tree, tmp_path):
    """The port's sweep bundle through the JAX package's _load_sweep_resume
    with the template of its own sweep's carry: every leaf equal to the
    port's (the rng leaf, threefry keys there, is exempt), the logs and the
    next epoch too; it needs the port's dropout generators' file for
    nothing."""
    corpus, fb = staged
    cfg = _sweep_config(tree, checkpoint_every=2)
    with pytest.raises(pfs.SweepAborted):
        pfs.run_fold_sweep(corpus, fb, cfg, "cpu", run_dir=tmp_path, abort_after_epoch=2)
    folds, batch = len(fb.test_subjects), cfg.trainer.batch_size
    steps = [pfs.grid_steps(n, batch) for n in (fb.n_train, fb.n_val, fb.n_test)]
    jcfg_ = jcfg.config_from_dict(jcfg.ExperimentConfig, json.loads(json.dumps(
        dataclasses.asdict(cfg))))
    jm = build_jax_model(jcfg_.model, K, fold_parallel=True)
    tx = jax_optim.make_optimizer(cfg.trainer.learning_rate, cfg.trainer.weight_decay)
    programs = jfs._make_fold_program(jm, tx, jcfg_, *steps, K)
    keys = jax.random.split(jax.random.PRNGKey(0), folds)
    init = jax.vmap(lambda k: init_train_state(jm, k, jnp.zeros((2, C, T)), tx))(keys)
    template = jax.vmap(programs["init_carry"])(init, keys)
    carry, logs, next_epoch = jfs._load_sweep_resume(tmp_path, template)
    assert next_epoch == 2 and len(logs) == 2
    mine = unpackb((tmp_path / "sweep_resume.msgpack").read_bytes())
    names = ("state", "best", "early stopping", "plateau", "rng", "stopped")
    for i, (name, got) in enumerate(zip(names, carry)):
        if name == "rng":
            assert np.shape(got) == np.shape(mine["4"]) == (folds, 2)
            continue
        want = jax.tree_util.tree_map(np.asarray, flax_state_dict(got))
        _assert_trees_equal(mine[str(i)], want, name)
    with np.load(tmp_path / "sweep_resume_logs.npz") as saved:
        for e, log in enumerate(logs):
            for j, column in enumerate(log):
                np.testing.assert_array_equal(column, saved[f"c{j}"][:, e])


def flax_state_dict(tree):
    from flax import serialization

    return serialization.to_state_dict(tree)
