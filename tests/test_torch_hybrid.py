"""The port's hybrid_cnn_gru slice (multimodalsignal_tpu_torch: models/hybrid.py,
the feature branch of models/fold_stack.py and models/convert.py, the hybrid
datasets of data/dataset.py, the Trainer's pairs, experiments/loso.py,
parallel/fold_sweep.py, experiments/predict.py and serving.py) against the
JAX package's, on the CPU at small widths (H = 8, conv 8, T = 128 a window
in training, 512 when serving recordings at 64 Hz).

Tolerances. The model's logits from the same flax weights: float32 rtol =
atol = 1e-4 (tests/test_torch_models.py), bfloat16 atol 5e-2. The fold axis
against jax.vmap of the flax model and against single-fold models: float32
atol 1e-5, gradients rtol 1e-4 atol 1e-5 (tests/test_torch_fold_sweep.py).
Train steps and sweep epochs from the same weights: losses rtol 1e-4 and
parameters atol 1e-4 (float32 round-off in other summation orders that
Adam's normalized step amplifies where a gradient is near zero); accuracy,
F1, learning rates and stop flags exactly. Datasets and the recording
pipeline: bitwise, with the JAX package's optional C++ engine off.
Predictor and ensemble probabilities: atol 1e-5; over HTTP 1e-5 (replies
round to 6 decimals)."""

import base64
import dataclasses
import io
import json
import threading
import urllib.error
import urllib.request
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import multimodalsignal_tpu.native as jnative
import multimodalsignal_tpu_torch.native as pnative
from multimodalsignal_tpu import config as jcfg
from multimodalsignal_tpu.data import dataset as jdata
from multimodalsignal_tpu.experiments import loso as jloso
from multimodalsignal_tpu.experiments import predict as jpredict
from multimodalsignal_tpu.models import build_model as build_jax_model
from multimodalsignal_tpu.parallel import fold_sweep as jfs
from multimodalsignal_tpu.train import optim as jax_optim
from multimodalsignal_tpu.train.checkpoints import restore_state, save_state
from multimodalsignal_tpu.train.trainer import Trainer as JaxTrainer
from multimodalsignal_tpu.train.trainer import TrainState, init_train_state, make_epoch_fns
from multimodalsignal_tpu_torch import config as pcfg
from multimodalsignal_tpu_torch import main as pmain
from multimodalsignal_tpu_torch.data import dataset as pdata
from multimodalsignal_tpu_torch.data.features import FEATURE_NAMES
from multimodalsignal_tpu_torch.data.synthetic import write_synthetic_wesad
from multimodalsignal_tpu_torch.experiments import loso as ploso
from multimodalsignal_tpu_torch.experiments import predict as ppredict
from multimodalsignal_tpu_torch.models.cnn_gru import build_model
from multimodalsignal_tpu_torch.models.convert import (
    _layout,
    export_jax_variables,
    lane_variables,
    load_jax_variables,
)
from multimodalsignal_tpu_torch.models.fold_stack import FoldStackedModel, build_fold_model
from multimodalsignal_tpu_torch.models.hybrid import HybridCnnGruModel
from multimodalsignal_tpu_torch.parallel import fold_sweep as pfs
from multimodalsignal_tpu_torch.serving import PredictionService, make_server
from multimodalsignal_tpu_torch.train.trainer import Trainer as PortTrainer
from multimodalsignal_tpu_torch.train.trainer import cross_entropy

from tests.test_torch_fold_sweep import N_WIN, one_torch_thread, write_tree  # noqa: F401

SUBJECTS = ("S2", "S3", "S4", "S5")
C, T, H, K, NF = 3, 128, 8, 2, len(FEATURE_NAMES)
CHANNELS = ["chest_ECG", "chest_EDA", "chest_Resp"]
MODEL = dict(name="hybrid_cnn_gru", gru_hidden_size=H, cnn_out_channels=8, dropout=0.0)
RAW_META = {"original_fs": 700, "fs": 16, "window_sec": 8, "stride_sec": 4,
            "include_wrist": False}


def write_hybrid_tree(root, subjects=SUBJECTS, seed=0):
    """The raw-align target (tests/test_torch_fold_sweep.py write_tree at
    T = 128, with its meta) and a feature target of the same windows and
    labels: [n, 10] float64, the stress windows shifted."""
    raw = write_tree(root / "chest_raw_align", subjects)
    (raw / "_preprocess_meta.json").write_text(json.dumps(RAW_META))
    feat = root / "chest_feature"
    feat.mkdir(parents=True)
    (feat / "_feature_names.txt").write_text("".join(f"{n}\n" for n in FEATURE_NAMES))
    (feat / "_preprocess_meta.json").write_text('{"feature_extractor_version": 2}')
    rng = np.random.default_rng(seed + 1)
    for sid in subjects:
        y = np.load(raw / f"{sid}_y.npy")
        x = rng.standard_normal((len(y), NF)) * rng.uniform(0.5, 3.0, NF) + 1.0
        x[y == 2] += 1.5
        np.save(feat / f"{sid}_X.npy", x)
        np.save(feat / f"{sid}_y.npy", y)
    return raw, feat


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return write_hybrid_tree(tmp_path_factory.mktemp("hybrid"))


@pytest.fixture
def numpy_engine(monkeypatch):
    """Both packages' NumPy paths (their C++ engines normalize float32 in
    another summation order, with an OpenMP reduction) and no on-disk pack
    cache."""
    monkeypatch.setattr(jnative, "available", lambda: False)
    monkeypatch.setattr(pnative, "available", lambda: False)
    monkeypatch.setenv("MMS_PACK_CACHE", "0")


# ---------------------------------------------------------------------------
# (e) datasets
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("features", [None, ["HRV_SDNN", "EDA_SCR_Peaks_N", "RESP_Rate_Mean"]])
@pytest.mark.parametrize("mode,normalization", [("stress_binary", "baseline"),
                                                ("ternary", "all"),
                                                ("amusement_binary", "none")])
def test_hybrid_datasets_match_jax(mode, normalization, features, tree, numpy_engine):
    """(e) build_hybrid_dataset and pack_hybrid_corpus against JAX's, bit
    for bit (S9 has no files and is skipped)."""
    raw, feat = tree
    names = pdata.read_channel_names(raw)
    subjects = list(SUBJECTS) + ["S9"]
    got = pdata.build_hybrid_dataset(raw, feat, subjects, CHANNELS, names, features, mode,
                                     normalization)
    want = jdata.build_hybrid_dataset(raw, feat, subjects, CHANNELS, names, features, mode,
                                      normalization)
    assert got.subjects == want.subjects == SUBJECTS and len(got) == len(want)
    for name in ("x_raw", "x_feat", "y"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert got.x[0] is got.x_raw and got.x_feat.shape[1] == len(features or FEATURE_NAMES)
    assert pdata.read_feature_names(feat) == jdata.read_feature_names(feat)
    pc = pdata.pack_hybrid_corpus(raw, feat, subjects, CHANNELS, names, features, mode,
                                  normalization)
    jc = jdata.pack_hybrid_corpus(raw, feat, subjects, CHANNELS, names, features, mode,
                                  normalization)
    assert pc.subjects == jc.subjects
    for name in ("x", "y", "mask", "feat"):
        a, b = getattr(pc, name), np.asarray(getattr(jc, name))
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert np.array_equal(pc.flat_feat(), jc.flat_feat())
    assert pdata.pack_corpus(raw, subjects, CHANNELS, names).flat_feat() is None


def test_normalize_features_matches_jax():
    x = np.random.default_rng(0).standard_normal((9, 4)) * 3
    x[:, 2] = 5.0                                    # a constant column: std 0 + 1e-3
    y = np.array([1, 2, 1, 3, 4, 1, 2, 2, 3])
    for scheme in ("baseline", "all", "none"):
        for labels in (y, np.full(9, 2)):            # no Base windows: all-window stats
            got = pdata.normalize_features(x, labels, scheme)
            assert got.dtype == np.float32
            assert np.array_equal(got, jdata.normalize_features(x, labels, scheme)), scheme
    assert np.abs(pdata.normalize_features(x, y, "all")[:, 2]).max() == 0.0


def test_mismatched_streams_raise(tmp_path, numpy_engine):
    """A feature target with a window fewer, or missing for a subject."""
    raw, feat = write_hybrid_tree(tmp_path / "t", SUBJECTS[:2])
    np.save(feat / "S3_X.npy", np.load(feat / "S3_X.npy")[:-1])
    np.save(feat / "S3_y.npy", np.load(feat / "S3_y.npy")[:-1])
    names = pdata.read_channel_names(raw)
    with pytest.raises(ValueError, match="disagree"):
        pdata.build_hybrid_dataset(raw, feat, list(SUBJECTS[:2]), CHANNELS, names)
    with pytest.raises(AssertionError):
        jdata.build_hybrid_dataset(raw, feat, list(SUBJECTS[:2]), CHANNELS, names)
    for mod in (pdata, jdata):
        with pytest.raises(ValueError, match="disagree for S3"):
            mod.pack_hybrid_corpus(raw, feat, list(SUBJECTS[:2]), CHANNELS, names)
    (feat / "S3_X.npy").unlink()
    for mod in (pdata, jdata):
        with pytest.raises(ValueError, match="no feature files"):
            mod.pack_hybrid_corpus(raw, feat, list(SUBJECTS[:2]), CHANNELS, names)


def test_experiment_preprocess_meta_merges_the_feature_stamp(tree):
    """The run's preprocess meta: the raw-align contract plus the feature
    target's extractor version for a hybrid run, as JAX's."""
    raw, feat = tree
    for cfgmod, datamod in ((pcfg, pdata), (jcfg, jdata)):
        hybrid = cfgmod.ExperimentConfig(model=cfgmod.ModelConfig(name="hybrid_cnn_gru"),
                                         raw_align_path=str(raw), feature_path=str(feat))
        assert datamod.experiment_preprocess_meta(hybrid) == dict(
            RAW_META, feature_extractor_version=2)
        plain = cfgmod.ExperimentConfig(data_path=str(raw))
        assert datamod.experiment_preprocess_meta(plain) == RAW_META


# ---------------------------------------------------------------------------
# (f) the model
# ---------------------------------------------------------------------------

def _jax_hybrid(ratio=4, dtype="float32", **fields):
    return build_jax_model(jcfg.ModelConfig(**dict(MODEL, reduction_ratio=ratio,
                                                    dtype=dtype, **fields)), K)


def _port_hybrid(ratio=4, dtype="float32", channels=C, **fields):
    return build_model(pcfg.ModelConfig(**dict(MODEL, reduction_ratio=ratio, dtype=dtype,
                                               **fields)), K, channels, NF)


def _inputs(rng, batch, channels=C, t=T):
    return (rng.standard_normal((batch, channels, t)).astype(np.float32),
            rng.standard_normal((batch, NF)).astype(np.float32))


def _flax_variables(jm, sample, seed):
    v = jm.init(jax.random.PRNGKey(seed), tuple(jnp.asarray(a) for a in sample), train=False)
    variables = jax.tree_util.tree_map(np.asarray, dict(v))
    rng = np.random.default_rng(seed)
    for bn in ("bn1", "bn2"):   # non-trivial running statistics
        stats = variables["batch_stats"]["cnn_encoder"][bn]
        stats["mean"] = rng.uniform(-0.3, 0.3, stats["mean"].shape).astype(np.float32)
        stats["var"] = rng.uniform(0.5, 2.0, stats["var"].shape).astype(np.float32)
    return variables


@pytest.mark.parametrize("dtype,atol", [("float32", 1e-4), ("bfloat16", 5e-2)])
@pytest.mark.parametrize("channels,ratio", [(3, 4), (4, 1)])
def test_hybrid_model_matches_flax(channels, ratio, dtype, atol):
    """(f) The same flax weights give the same logits (C=3, r=4: the
    constant 0.5 gate; C=4, r=1: a real one); the tree round-trips."""
    x = _inputs(np.random.default_rng(channels), 6, channels)
    jm = _jax_hybrid(ratio, dtype)
    variables = _flax_variables(jm, x, seed=channels)
    want = np.asarray(jax.jit(lambda v, a, b: jm.apply(v, (a, b), train=False))(
        variables, *x))
    pm = _port_hybrid(ratio, dtype, channels)
    assert isinstance(pm, HybridCnnGruModel)
    load_jax_variables(pm, variables["params"], variables["batch_stats"])
    with torch.inference_mode():
        got = pm.eval()(tuple(torch.from_numpy(a) for a in x))
    assert got.dtype == torch.float32 and got.shape == (6, K)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4 if dtype == "float32" else 0,
                               atol=atol)
    back = export_jax_variables(pm)
    assert back["params"]["feat1"]["kernel"].shape == (NF, 32)
    assert back["params"]["head1"]["kernel"].shape == (2 * H + 32, 64)
    for path, leaf in jax.tree_util.tree_leaves_with_path(variables):
        node = back
        for k in path:
            node = node[k.key]
        np.testing.assert_array_equal(node, leaf, err_msg=jax.tree_util.keystr(path))


def test_hybrid_fold_model_matches_jax_vmap_and_single_folds():
    """The fold axis with the feature branch: FoldStackedModel against
    jax.vmap of the flax hybrid model (eval logits, train-mode losses,
    every gradient, new BN statistics) and its lanes against single-fold
    port models."""
    folds, batch = 3, 5
    rng = np.random.default_rng(4)
    jm = _jax_hybrid(1)
    keys = jax.random.split(jax.random.PRNGKey(2), folds)
    sample = tuple(jnp.asarray(a) for a in _inputs(rng, 2, 4))
    variables = jax.tree_util.tree_map(
        np.asarray, dict(jax.vmap(lambda k: jm.init(k, sample, train=False))(keys)))
    x = rng.standard_normal((folds, batch, 4, T)).astype(np.float32)
    f = rng.standard_normal((folds, batch, NF)).astype(np.float32)
    y = rng.integers(0, K, (folds, batch)).astype(np.int32)
    w = np.ones((folds, batch), np.float32)

    def loss_fn(p, bs, xb, fb, yb, wb):
        logits, new = jm.apply({"params": p, "batch_stats": bs}, (xb, fb), train=True,
                               mutable=["batch_stats"])
        lp = jax.nn.log_softmax(logits)
        ce = -jnp.take_along_axis(lp, yb[:, None], axis=-1)[:, 0]
        return (ce * wb).sum() / wb.sum(), new["batch_stats"]

    (want_loss, want_stats), want_grads = jax.vmap(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"], variables["batch_stats"], x, f, y, w)
    want_logits = jax.vmap(lambda v, a, b: jm.apply(v, (a, b), train=False))(variables, x, f)
    fm = build_fold_model(pcfg.ModelConfig(**dict(MODEL, reduction_ratio=1)), K, 4, folds,
                          num_features=NF)
    load_jax_variables(fm, variables["params"], variables["batch_stats"])
    pair = (torch.from_numpy(x), torch.from_numpy(f))
    fm.eval()
    with torch.inference_mode():
        logits = fm(pair)
        np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits), rtol=0, atol=1e-5)
        for lane in range(folds):
            m = _port_hybrid(1, channels=4)
            load_jax_variables(m, **lane_variables(export_jax_variables(fm), lane))
            torch.testing.assert_close(logits[lane], m.eval()((pair[0][lane], pair[1][lane])),
                                       rtol=0, atol=1e-5)
    fm.train()
    loss, _ = cross_entropy(fm(pair), torch.from_numpy(y).long(), torch.from_numpy(w))
    loss.sum().backward()
    np.testing.assert_allclose(loss.detach().numpy(), np.asarray(want_loss), rtol=1e-5)
    grads = {"/".join(p): tf(t.grad).numpy() for coll, p, t, tf in _layout(fm) if coll == "params"}
    assert "feat1/kernel" in grads
    for path, g in jax.tree_util.tree_leaves_with_path(want_grads):
        name = "/".join(k.key for k in path)
        np.testing.assert_allclose(grads[name], np.asarray(g), rtol=1e-4, atol=1e-5, err_msg=name)
    stats = export_jax_variables(fm)["batch_stats"]["cnn_encoder"]
    for bn in ("bn1", "bn2"):
        for s in ("mean", "var"):
            np.testing.assert_allclose(stats[bn][s], np.asarray(want_stats["cnn_encoder"][bn][s]),
                                       rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# (g) train steps, (h) sweep epochs
# ---------------------------------------------------------------------------

def test_train_steps_match_jax_trainer(tree, numpy_engine):
    """(g) Three Trainer.train_steps (dropout 0; the third batch padded)
    against the JAX trainer's train_epoch one step at a time, from the same
    weights: each step's loss and the parameters and BN statistics after."""
    raw, feat = tree
    ds = pdata.build_hybrid_dataset(raw, feat, list(SUBJECTS[:3]), CHANNELS,
                                    pdata.read_channel_names(raw))
    jm = _jax_hybrid()
    variables = _flax_variables(jm, (ds.x_raw[:2], ds.x_feat[:2]), seed=5)
    tcfg = dict(batch_size=8, learning_rate=3e-3)
    tx = jax_optim.make_optimizer(tcfg["learning_rate"], 1e-4)
    train_epoch, _ = make_epoch_fns(jm, tx, K)
    state = TrainState(variables["params"], variables["batch_stats"],
                       tx.init(variables["params"]))
    rng = np.random.default_rng(0)
    rows = [rng.choice(len(ds), 8, replace=False) for _ in range(3)]
    ws = [np.ones(8, np.float32), np.ones(8, np.float32),
          np.array([1, 1, 1, 1, 0, 0, 0, 0], np.float32)]
    x_j = (jnp.asarray(ds.x_raw), jnp.asarray(ds.x_feat))
    want = []
    for r, w in zip(rows, ws):
        state, loss = train_epoch(state, x_j, jnp.asarray(ds.y), jnp.asarray(r[None]),
                                  jnp.asarray(w[None]), jax.random.PRNGKey(0))
        want.append(float(loss))
    trainer = PortTrainer(_port_hybrid(), tmp := raw.parent / "port_steps",
                          pcfg.TrainerConfig(**tcfg), K, device="cpu", variables=variables)
    assert tmp.is_dir()
    x, y = trainer._stage(ds)
    assert isinstance(x, tuple) and x[1].shape == (len(ds), NF)
    got = []
    for r, w in zip(rows, ws):
        idx = torch.from_numpy(r)
        loss, _ = trainer.train_step((x[0][idx], x[1][idx]), y[idx], torch.from_numpy(w))
        got.append(loss.item())
    np.testing.assert_allclose(got, want, rtol=1e-4)
    after = export_jax_variables(trainer.model)
    for coll, tree_ in (("params", state.params), ("batch_stats", state.batch_stats)):
        for path, leaf in jax.tree_util.tree_leaves_with_path(tree_):
            node = after[coll]
            for k in path:
                node = node[k.key]
            np.testing.assert_allclose(node, np.asarray(leaf), rtol=0, atol=1e-4,
                                       err_msg=coll + jax.tree_util.keystr(path))


def test_hybrid_sweep_epochs_match_jax(tree, numpy_engine):
    """(h) Three FoldSweep epochs on the hybrid corpus against
    jax.jit(jax.vmap(programs["epoch"])) on JAX's grids from the same
    stacked weights, then finalize (as tests/test_torch_fold_sweep.py does
    for the CnnGru sweep): both streams gathered by one index grid."""
    raw, feat = tree
    fields = dict(subjects=SUBJECTS, raw_align_path=str(raw), feature_path=str(feat),
                  seed=5, val_fraction=0.3, channels_to_use=tuple(CHANNELS),
                  normalization="all")
    tr = dict(epochs=3, batch_size=4, learning_rate=5e-3, lr_plateau_patience=0)
    cfg_j = jcfg.ExperimentConfig(
        model=jcfg.ModelConfig(**MODEL), **fields,
        trainer=jcfg.TrainerConfig(early_stopping=jcfg.EarlyStoppingConfig(patience=1), **tr))
    cfg_p = pcfg.ExperimentConfig(
        model=pcfg.ModelConfig(**MODEL), **fields,
        trainer=pcfg.TrainerConfig(early_stopping=pcfg.EarlyStoppingConfig(patience=1), **tr))
    corpus = pdata.pack_hybrid_corpus(raw, feat, list(SUBJECTS), CHANNELS,
                                      pdata.read_channel_names(raw))
    fb = pfs.build_fold_batch(corpus, list(SUBJECTS), cfg_p.val_fraction, cfg_p.seed)
    folds, batch = len(fb.test_subjects), tr["batch_size"]
    steps = [pfs.grid_steps(n, batch) for n in (fb.n_train, fb.n_val, fb.n_test)]
    jm = build_jax_model(cfg_j.model, K, fold_parallel=True)
    tx = jax_optim.make_optimizer(tr["learning_rate"], cfg_j.trainer.weight_decay)
    programs = jfs._make_fold_program(jm, tx, cfg_j, *steps, K)
    sample = (jnp.zeros((2, C, T)), jnp.zeros((2, NF)))
    keys = jax.random.split(jax.random.PRNGKey(11), folds)
    variables = jax.tree_util.tree_map(
        np.asarray, dict(jax.vmap(lambda k: jm.init(k, sample, train=False))(keys)))
    carry = jax.vmap(programs["init_carry"])(
        jax.vmap(lambda p, bs: TrainState(p, bs, tx.init(p)))(
            variables["params"], variables["batch_stats"]),
        jax.random.split(jax.random.PRNGKey(cfg_j.seed), folds))
    epoch_fn = jax.jit(jax.vmap(programs["epoch"], in_axes=(None, None, 0, 0, 0, 0, 0, 0, None)))
    x, y, _ = corpus.flat()
    xs = (x, corpus.flat_feat())
    pools = (fb.train_pool, fb.n_train, fb.val_pool, fb.n_val)
    cw = np.ones((folds, K), np.float32)
    grid_fn = jax.vmap(lambda r, p, n: jfs._shuffled_grid(jax.random.split(r, 3)[1], p, n,
                                                          steps[0], batch))
    sweep = pfs.FoldSweep(corpus, fb, cfg_p, "cpu", variables=variables)
    assert sweep.feat.shape == (x.shape[0], NF)
    stops = []
    for epoch in range(tr["epochs"]):
        idx, w = grid_fn(carry[4], fb.train_pool, fb.n_train)
        carry, want = epoch_fn(xs, y, *pools, cw, carry, epoch)
        got = sweep.epoch(np.asarray(idx), np.asarray(w), epoch)
        np.testing.assert_allclose(got[0], np.asarray(want[0]), rtol=1e-4, err_msg="train loss")
        np.testing.assert_allclose(got[1], np.asarray(want[1]), rtol=1e-4, err_msg="val loss")
        for i in (2, 3, 4, 5):
            np.testing.assert_array_equal(got[i], np.asarray(want[i]), err_msg=str(i))
        np.testing.assert_array_equal(sweep.stopped, np.asarray(carry[5]))
        stops.append(sweep.stopped.copy())
    assert stops[-1].any(), "no fold stopped"
    final = export_jax_variables(sweep.model)["params"]
    for path, want in jax.tree_util.tree_leaves_with_path(carry[0].params):
        node = final
        for k in path:
            node = node[k.key]
        np.testing.assert_allclose(node, np.asarray(want), rtol=0, atol=1e-4,
                                   err_msg=jax.tree_util.keystr(path))
    finalize = jax.jit(jax.vmap(programs["finalize"], in_axes=(None, None, 0, 0, 0, 0)))
    t_loss, t_cm, best, _, _, probs = finalize(xs, y, fb.test_pool, fb.n_test, cw, carry)
    got = sweep.finalize()
    np.testing.assert_allclose(got[0], np.asarray(t_loss), rtol=1e-4)
    np.testing.assert_array_equal(got[1], np.asarray(t_cm))
    np.testing.assert_array_equal(got[2], np.asarray(best))
    np.testing.assert_allclose(got[3], np.asarray(probs), rtol=0, atol=1e-4)


# ---------------------------------------------------------------------------
# (k) the CLIs
# ---------------------------------------------------------------------------

def _cli_argv(raw, feat, out, *extra):
    return ["--device", "cpu", "--output-dir", str(out), "--set", "model.name=hybrid_cnn_gru",
            "--set", f"raw_align_path={raw}", "--set", f"feature_path={feat}",
            "--set", "subjects=" + ",".join(SUBJECTS), "--set", "model.gru_hidden_size=8",
            "--set", "model.cnn_out_channels=8", "--set", "trainer.epochs=2",
            "--set", "trainer.batch_size=8", *extra]


@pytest.mark.parametrize("execution", ["serial", "sharded"])
def test_hybrid_main_writes_a_run_jax_reads(execution, tree, tmp_path):
    """(k) main --device cpu with model.name=hybrid_cnn_gru, serial and the
    default sharded sweep: config.json with the feature stamp, 4 folds in
    cv_summary.txt, each checkpoint read by JAX's restore_state into a
    hybrid template and giving the port Predictor's probabilities."""
    raw, feat = tree
    pmain.main(_cli_argv(raw, feat, tmp_path / "out", "--execution", execution))
    (run_dir,) = (tmp_path / "out" / "simple_binary").iterdir()
    saved = json.loads((run_dir / "config.json").read_text())
    assert saved["preprocess_meta"] == dict(RAW_META, feature_extractor_version=2)
    cfg = jcfg.config_from_dict(jcfg.ExperimentConfig, saved)
    assert cfg.model.name == "hybrid_cnn_gru" and cfg.fold_execution == "sharded"
    summary = (run_dir / "cv_summary.txt").read_text()
    assert summary.count("  - test S") == 4 and "Mean weighted F1" in summary
    jm = build_jax_model(cfg.model, K)
    tx = jax_optim.make_optimizer(cfg.trainer.learning_rate, cfg.trainer.weight_decay)
    template = init_train_state(jm, jax.random.PRNGKey(0),
                                (jnp.zeros((1, C, T)), jnp.zeros((1, NF))), tx)
    x = _inputs(np.random.default_rng(3), 5)
    for sid in SUBJECTS:
        state = restore_state(run_dir / f"fold_test_on_{sid}" / "best_model.msgpack", template)
        want = jax.nn.softmax(jm.apply({"params": state.params, "batch_stats": state.batch_stats},
                                       x, train=False))
        got = ppredict.Predictor.from_run(run_dir, sid, device="cpu").predict_windows(x)
        np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-5)
        assert np.load(run_dir / f"fold_test_on_{sid}" / "test_probs.npy").shape == (N_WIN[sid], K)


def test_serial_hybrid_loso_matches_jax(tree, tmp_path, numpy_engine, monkeypatch):
    """Both packages' serial hybrid run_simple_experiment, every fold from
    the same flax weights, dropout 0, shuffle off: per-fold accuracy and F1
    equal, test losses within rtol 1e-4."""
    raw, feat = tree
    fields = dict(subjects=SUBJECTS[:3], raw_align_path=str(raw), feature_path=str(feat),
                  seed=5, fold_execution="serial")
    trainer = dict(epochs=2, batch_size=8, shuffle=False, learning_rate=3e-3)
    cfg_j = jcfg.ExperimentConfig(model=jcfg.ModelConfig(**MODEL),
                                  trainer=jcfg.TrainerConfig(**trainer), **fields)
    cfg_p = pcfg.ExperimentConfig(model=pcfg.ModelConfig(**MODEL),
                                  trainer=pcfg.TrainerConfig(**trainer), **fields)
    jm = build_jax_model(cfg_j.model, K)
    variables = _flax_variables(jm, _inputs(np.random.default_rng(0), 2), seed=3)

    class SeededJaxTrainer(JaxTrainer):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.state = TrainState(params=variables["params"],
                                    batch_stats=variables["batch_stats"],
                                    opt_state=self.tx.init(variables["params"]))

    monkeypatch.setattr(jloso, "Trainer", SeededJaxTrainer)
    monkeypatch.setattr(ploso, "Trainer",
                        lambda *a, **k: PortTrainer(*a, variables=variables, **k))
    want, want_summary = jloso.run_simple_experiment(cfg_j, tmp_path / "jax")
    got, got_summary = ploso.run_simple_experiment(cfg_p, tmp_path / "port", device="cpu")
    assert [r.subject for r in got] == list(SUBJECTS[:3]) == [r.subject for r in want]
    for g, w in zip(got, want):
        assert (g.accuracy, g.f1_score, g.epochs_run) == (w.accuracy, w.f1_score, w.epochs_run)
        np.testing.assert_allclose(g.test_loss, w.test_loss, rtol=1e-4, err_msg=g.subject)
    assert got_summary == want_summary


def test_hybrid_refusals():
    """Without both targets, or staged from pickles, the hybrid model is
    refused before anything runs."""
    for extra in ([], ["--set", "raw_align_path=a"]):
        with pytest.raises(ValueError, match="requires raw_align_path"):
            pmain.main(["--device", "cpu", "--set", "model.name=hybrid_cnn_gru", *extra])
    with pytest.raises(ValueError, match="hybrid"):
        pmain.main(["--device", "cpu", "--set", "model.name=hybrid_cnn_gru",
                    "--set", "raw_align_path=a", "--set", "feature_path=b",
                    "--from-pickles", "WESAD"])


# ---------------------------------------------------------------------------
# (i) recording pipeline, Predictor and ensemble; (j) serving
# ---------------------------------------------------------------------------

SERVE_META = {"original_fs": 700, "fs": 64, "window_sec": 8, "stride_sec": 4,
              "include_wrist": False, "feature_extractor_version": 2}


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """A hybrid run directory written by the JAX package (two folds of
    flax-initialised weights, features_to_use a subset), and a recording."""
    root = tmp_path_factory.mktemp("jaxrun")
    features = ("HRV_RMSSD", "HRV_HF", "EDA_Tonic_Slope", "RESP_Rate_Mean", "EMG_Amplitude_Mean")
    cfg = jcfg.ExperimentConfig(model=jcfg.ModelConfig(**MODEL), features_to_use=features,
                                raw_align_path="a", feature_path="b", normalization="all")
    jm = build_jax_model(cfg.model, K)
    tx = jax_optim.make_optimizer(cfg.trainer.learning_rate, cfg.trainer.weight_decay)
    sample = (jnp.zeros((1, C, 512)), jnp.zeros((1, len(features))))
    run = root / "run"
    for i, sid in enumerate(("S2", "S3")):
        save_state(run / f"fold_test_on_{sid}" / "best_model.msgpack",
                   init_train_state(jm, jax.random.PRNGKey(i), sample, tx))
    jcfg.save_config(cfg, run / "config.json", extra={"preprocess_meta": SERVE_META})
    write_synthetic_wesad(root / "wesad", ["S5"], tasks=(("Base", 1.0), ("TSST", 1.0)), seed=2)
    return run, root / "wesad" / "S5" / "S5.pkl", features


def test_recording_to_hybrid_windows_matches_jax(jax_run, numpy_engine):
    """(i) Both streams of the recording pipeline, bit for bit."""
    _, pkl, features = jax_run
    for feats in (None, list(features)):
        (gx, gf), gs = ppredict.recording_to_hybrid_windows(pkl, CHANNELS, "all", feats,
                                                            700, 64, 8, 4)
        (wx, wf), ws = jpredict.recording_to_hybrid_windows(pkl, CHANNELS, "all", feats,
                                                            700, 64, 8, 4)
        assert gx.shape == (len(gs), C, 512) and gf.shape == (len(gs), len(feats or FEATURE_NAMES))
        assert np.array_equal(gs, ws) and np.array_equal(gx, wx) and np.array_equal(gf, wf)
        assert gf.dtype == np.float32 and np.isfinite(gf).all()
    assert ppredict.hybrid_feature_names(pcfg.ExperimentConfig()) == FEATURE_NAMES


def test_hybrid_predictor_and_ensemble_match_jax(jax_run):
    """(i) The port's Predictor (one fold) and EnsemblePredictor on the
    JAX-written run, against JAX's, on a recording and on given pairs."""
    run, pkl, features = jax_run
    for fold in ("S2", "all"):
        got = ppredict.EnsemblePredictor.from_run(run, fold, device="cpu")
        want = jpredict.EnsemblePredictor.from_run(run, fold)
        assert got.is_hybrid and got.feature_names == features == want.feature_names
        assert (got.target_fs, got.window_sec) == (64, 8)
        g, w = got.predict_recording(pkl), want.predict_recording(pkl)
        np.testing.assert_array_equal(g.starts_sec, w.starts_sec)
        np.testing.assert_allclose(g.probs, w.probs, rtol=0, atol=1e-5)
        pair = _inputs(np.random.default_rng(1), 70, t=512)
        pair = (pair[0], pair[1][:, :len(features)])
        np.testing.assert_allclose(got.predict_windows(pair), want.predict_windows(pair),
                                   rtol=0, atol=1e-5)
    ens = ppredict.EnsemblePredictor.from_run(run, device="cpu")
    mean = np.mean([ppredict.Predictor.from_run(run, s, device="cpu").predict_windows(pair)
                    for s in ens.fold_names], axis=0)
    np.testing.assert_allclose(ens.predict_windows(pair), mean, rtol=0, atol=1e-6)


@pytest.mark.parametrize("stamp", [None, 1])
def test_feature_extractor_stamp_is_checked(stamp, jax_run, tmp_path):
    """(i) No stamp warns; another extractor's stamp raises, for the one
    fold and the ensemble alike."""
    run, _, _ = jax_run
    cfg = json.loads((run / "config.json").read_text())
    meta = {k: v for k, v in SERVE_META.items() if k != "feature_extractor_version"}
    if stamp is not None:
        meta["feature_extractor_version"] = stamp
    cfg["preprocess_meta"] = meta
    copy = tmp_path / "run"
    for sid in ("S2", "S3"):
        (copy / f"fold_test_on_{sid}").mkdir(parents=True)
        (copy / f"fold_test_on_{sid}" / "best_model.msgpack").write_bytes(
            (run / f"fold_test_on_{sid}" / "best_model.msgpack").read_bytes())
    (copy / "config.json").write_text(json.dumps(cfg))
    for fold in ("S2", "all"):
        if stamp is None:
            with pytest.warns(UserWarning, match="no feature_extractor_version"):
                ppredict.EnsemblePredictor.from_run(copy, fold, device="cpu")
        else:
            with pytest.raises(ValueError, match="feature extractor v1"):
                ppredict.EnsemblePredictor.from_run(copy, fold, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        ppredict.Predictor.from_run(run, "S2", device="cpu")


def _post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as exc:
        return exc.code, json.loads(exc.read())


def _b64(a):
    buf = io.BytesIO()
    np.save(buf, a)
    return base64.b64encode(buf.getvalue()).decode()


def test_hybrid_serving_contract(jax_run):
    """(j) /healthz names the features; /v1/predict answers windows with
    their features (lists or base64 .npy) as predict_windows does, and
    refuses with 400 a missing, misshapen or non-finite feature stream;
    concurrent requests are micro-batched pair by pair."""
    run, pkl, features = jax_run
    predictor = ppredict.EnsemblePredictor.from_run(run, device="cpu")
    service = PredictionService(predictor, batch_size=8, micro_batch_ms=50.0)
    httpd = make_server(service, host="127.0.0.1", port=0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    x, f = _inputs(np.random.default_rng(5), 11, t=512)
    f = f[:, :len(features)]
    try:
        with urllib.request.urlopen(url + "/healthz") as resp:
            card = json.loads(resp.read())
        assert card["feature_names"] == list(features) and card["window_shape"] == [C, 512]
        status, out = _post(url + "/v1/predict", {"windows": x.tolist(), "features": f.tolist()})
        assert status == 200 and out["num_windows"] == 11
        want = predictor.predict_windows((x, f), 8)
        np.testing.assert_allclose(out["probs"], want, rtol=0, atol=1e-5)
        status, out = _post(url + "/v1/predict", {"windows_b64": _b64(x[:1]),
                                                  "features_b64": _b64(f[0])})
        assert status == 200
        np.testing.assert_allclose(out["probs"], want[:1], rtol=0, atol=1e-5)
        bad = f.copy()
        bad[3, 1] = np.nan
        for payload, message in (
                ({"windows": x.tolist()}, "must also contain 'features'"),
                ({"windows": x.tolist(), "features": f[:5].tolist()}, "expected features"),
                ({"windows": x.tolist(), "features": f[:, :2].tolist()}, "expected features"),
                ({"windows": x.tolist(), "features": bad.tolist()}, "NaN/Inf"),
                ({"windows": x.tolist(), "features_b64": "notnpy"}, "not a valid .npy")):
            status, out = _post(url + "/v1/predict", payload)
            assert status == 400 and message in out["error"], out
        status, out = _post(url + "/v1/predict_recording", {"pkl_path": str(pkl)})
        assert status == 200
        np.testing.assert_allclose([w["probs"] for w in out["windows"]],
                                   predictor.predict_recording(pkl).probs, rtol=0, atol=1e-5)
        batches = service._batcher.batches_run
        replies = [None] * 3
        threads = [threading.Thread(target=lambda i=i: replies.__setitem__(i, _post(
            url + "/v1/predict", {"windows": x[i:i + 2].tolist(),
                                  "features": f[i:i + 2].tolist()}))) for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for i, (status, out) in enumerate(replies):
            assert status == 200
            np.testing.assert_allclose(out["probs"], want[i:i + 2], rtol=0, atol=1e-5)
        assert service._batcher.batches_run - batches <= 3
        assert service.health()["requests_served"] >= 5
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
        service.close()


def test_plain_models_keep_an_empty_feature_card():
    cfg = pcfg.ExperimentConfig(model=pcfg.ModelConfig(gru_hidden_size=8))
    variables = export_jax_variables(build_model(cfg.model, K, C))
    predictor = ppredict.Predictor(cfg, variables, device="cpu", window_sec=2)
    assert not predictor.is_hybrid and predictor.feature_names == ()
    service = PredictionService(predictor, micro_batch_ms=0)
    assert service.health()["feature_names"] == [] and not service.is_hybrid
    out = service.predict_windows({"windows": np.zeros((2, C, 256), np.float32).tolist()})
    assert out["num_windows"] == 2


def test_fold_stack_refuses_a_plain_input_for_the_hybrid_model():
    """A FoldStackedModel of hybrid lanes takes the pair only."""
    fm = FoldStackedModel([_port_hybrid()] * 2)
    with pytest.raises((TypeError, ValueError)):
        fm(torch.zeros(2, 1, C, T))
    m = dataclasses.replace(pcfg.ModelConfig(**MODEL), name="cnn_gru")
    assert not hasattr(build_model(m, K, C), "feat1")
