"""The port's serial LOSO slice (multimodalsignal_tpu_torch: config helpers,
data/dataset.py, experiments/splits.py, utils/run.py, experiments/loso.py,
main.py) against the JAX package's, on the CPU.

The slice as a whole: both packages' `run_simple_experiment` on the same
npy tree of 3 subjects (T = 256 samples a window), gru_impl="pallas_fused"
(the port's fused plain versions, the JAX package's Pallas kernels in
interpret mode), H = 8, dropout 0, shuffle off, 2 epochs, every fold
starting from the same flax-initialised weights. Per-fold accuracy and F1
must be equal, test losses within rtol 1e-4 (float32 round-off in other
summation orders over a few Adam steps), and the means in cv_summary.txt
equal. The datasets agree at atol 1e-5: the JAX side may normalize float32
windows in its C++ engine, which sums in another order."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from multimodalsignal_tpu import config as jcfg
from multimodalsignal_tpu.data import dataset as jdata
from multimodalsignal_tpu.experiments import loso as jloso
from multimodalsignal_tpu.experiments import splits as jsplits
from multimodalsignal_tpu.models import build_model as build_jax_model
from multimodalsignal_tpu.train.trainer import Trainer as JaxTrainer
from multimodalsignal_tpu.train.trainer import TrainState
from multimodalsignal_tpu.utils.run import make_run_dir as jax_make_run_dir
from multimodalsignal_tpu_torch import config as pcfg
from multimodalsignal_tpu_torch import main as pmain
from multimodalsignal_tpu_torch.data import dataset as pdata
from multimodalsignal_tpu_torch.experiments import loso as ploso
from multimodalsignal_tpu_torch.experiments import splits as psplits
from multimodalsignal_tpu_torch.train.checkpoints import read_flax_checkpoint
from multimodalsignal_tpu_torch.train.trainer import Trainer as PortTrainer
from multimodalsignal_tpu_torch.utils.run import make_run_dir

SUBJECTS = ("S2", "S3", "S4")
WINDOW_T, N_WIN = 256, 24


def _write_tree(root, subjects=SUBJECTS, n=N_WIN, t=WINDOW_T, seed=0):
    """A preprocessed data directory: per subject X [n, t, 8] float32 and raw
    labels 1-4; stress (label 2) windows oscillate faster, so two epochs
    learn something. Every subject has Base (1) windows."""
    rng = np.random.default_rng(seed)
    root.mkdir(parents=True, exist_ok=True)
    (root / "_channel_names.txt").write_text("\n".join(pcfg.ALL_CHANNEL_NAMES) + "\n")
    tt = np.arange(t) / 128.0
    for k, sid in enumerate(subjects):
        y = rng.integers(1, 5, n)
        y[:2] = (1, 2)
        freq = np.where(y == 2, 8.0, 2.0)[:, None, None]
        x = np.sin(2 * np.pi * freq * tt[None, :, None]) + 0.3 * rng.standard_normal((n, t, 8))
        x[..., 4] = 2.0 + 0.5 * x[..., 4] + k  # EDA-like, above -1 for log1p
        np.save(root / f"{sid}_X.npy", x.astype(np.float32))
        np.save(root / f"{sid}_y.npy", y.astype(np.int64))
    return root


@pytest.mark.parametrize("seed", [0, 42, 123])
@pytest.mark.parametrize("val_fraction", [0.2, 0.3, 0.5])
def test_loso_folds_match_jax(seed, val_fraction):
    """The port's ShuffleSplit replica against the JAX package's
    train_val_split (sklearn's train_test_split where sklearn imports)."""
    want = jsplits.loso_folds(jcfg.ALL_SUBJECTS, val_fraction, seed)
    got = psplits.loso_folds(pcfg.ALL_SUBJECTS, val_fraction, seed)
    assert len(got) == len(want) == 15
    for g, w in zip(got, want):
        assert (g.test_subject, g.train_subjects, g.val_subjects) == (
            w.test_subject, w.train_subjects, w.val_subjects)


@pytest.mark.parametrize("normalization", ["all", "baseline"])
@pytest.mark.parametrize("mode", ["stress_binary", "ternary", "amusement_binary"])
def test_build_dataset_matches_jax(mode, normalization, tmp_path):
    root = _write_tree(tmp_path / "data", n=10, t=64)
    names = pdata.read_channel_names(root)
    assert names == jdata.read_channel_names(root) == list(pcfg.ALL_CHANNEL_NAMES)
    channels = ["chest_ECG", "chest_EDA", "chest_Resp"]
    subjects = ["S2", "S9", "S4"]  # S9 has no files: skipped with a warning
    got = pdata.build_dataset(root, subjects, channels, names, mode, normalization)
    want = jdata.build_dataset(root, subjects, channels, names, mode, normalization)
    assert got.subjects == want.subjects == ("S2", "S4")
    assert got.x.dtype == np.float32 and got.x.shape == want.x.shape
    np.testing.assert_array_equal(got.y, want.y)
    np.testing.assert_allclose(got.x, want.x, rtol=0, atol=1e-5)
    y_raw = np.array([1, 2, 3, 4, 3])
    for a, b in zip(pdata.map_labels(y_raw, mode), jdata.map_labels(y_raw, mode)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="No data loaded"):
        pdata.build_dataset(root, ["S9"], channels, names, mode, normalization)


def test_overrides_and_config_json_agree_with_jax(tmp_path):
    overrides = {"model.gru_impl": "pallas_fused", "trainer.epochs": 3,
                 "classification_mode": "ternary", "num_classes": 3,
                 "channels_to_use": "chest_ECG", "subjects": ["S2", "S3"],
                 "trainer.early_stopping.patience": 5}
    got = pcfg.apply_overrides(pcfg.ExperimentConfig(), overrides)
    want = jcfg.apply_overrides(jcfg.ExperimentConfig(), overrides)
    assert pcfg.config_to_dict(got) == jcfg.config_to_dict(want)
    assert got.channels_to_use == ("chest_ECG",)
    pcfg.save_config(got, tmp_path / "port.json", extra={"preprocess_meta": {"fs": 128}})
    jcfg.save_config(want, tmp_path / "jax.json", extra={"preprocess_meta": {"fs": 128}})
    assert (tmp_path / "port.json").read_text() == (tmp_path / "jax.json").read_text()
    back = jcfg.config_from_dict(jcfg.ExperimentConfig,
                                 jcfg.load_config_file(tmp_path / "port.json"))
    assert back == want
    assert pcfg.config_from_dict(pcfg.ExperimentConfig,
                                 pcfg.load_config_file(tmp_path / "port.json")) == got
    (tmp_path / "cfg.yaml").write_text("trainer:\n  epochs: 7\n")
    assert pcfg.load_config_file(tmp_path / "cfg.yaml") == {"trainer": {"epochs": 7}}
    with pytest.raises(ValueError, match="requires raw_align_path"):
        pcfg.validate_experiment(dataclasses.replace(
            got, model=dataclasses.replace(got.model, name="hybrid_cnn_gru")))


def test_summary_text_and_class_weights_match_jax(tmp_path):
    results = [(s, a, f, l) for s, a, f, l in
               (("S2", 0.75, 0.7, 0.51), ("S3", 0.5, 0.45, 0.9), ("S4", 1.0, 1.0, 0.1))]
    cfg_p, cfg_j = pcfg.ExperimentConfig(), jcfg.ExperimentConfig()
    got = ploso.write_cv_summary(tmp_path / "p.txt", cfg_p, [
        ploso.FoldResult(s, a, f, l, 2, 3, 1.5) for s, a, f, l in results])
    want = jloso.write_cv_summary(tmp_path / "j.txt", cfg_j, [
        jloso.FoldResult(s, a, f, l, 2, 3, 1.5) for s, a, f, l in results])
    assert got == want
    assert (tmp_path / "p.txt").read_text() == (tmp_path / "j.txt").read_text()
    y = np.array([0, 0, 0, 1, 2, 2])
    np.testing.assert_array_equal(ploso.balanced_class_weights(y, 4),
                                  jloso.balanced_class_weights(y, 4))


def test_make_run_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("MMS_RUN_ID", "shared")
    monkeypatch.delenv("MMS_NUM_PROCESSES", raising=False)
    lone = make_run_dir(tmp_path / "p", "exp")
    want = jax_make_run_dir(tmp_path / "j", "exp")
    assert lone.is_dir() and lone.parent == tmp_path / "p" / "exp"
    assert lone.name.startswith("run_") and lone.name != "run_shared"
    assert want.name != "run_shared"
    monkeypatch.setenv("MMS_NUM_PROCESSES", "2")
    assert make_run_dir(tmp_path / "p", "exp") == tmp_path / "p" / "exp" / "run_shared"
    assert jax_make_run_dir(tmp_path / "j", "exp") == tmp_path / "j" / "exp" / "run_shared"


def _slice_configs(data_path):
    fields = dict(
        subjects=SUBJECTS, data_path=str(data_path), seed=5, fold_execution="serial")
    model = dict(gru_impl="pallas_fused", gru_hidden_size=8, cnn_out_channels=8,
                 dropout=0.0)
    trainer = dict(epochs=2, batch_size=16, shuffle=False, learning_rate=3e-3)
    return (jcfg.ExperimentConfig(model=jcfg.ModelConfig(**model),
                                  trainer=jcfg.TrainerConfig(**trainer), **fields),
            pcfg.ExperimentConfig(model=pcfg.ModelConfig(**model),
                                  trainer=pcfg.TrainerConfig(**trainer), **fields))


def _mean_lines(path):
    return [ln for ln in path.read_text().splitlines() if ln.startswith("Mean ")]


def test_run_simple_experiment_matches_jax(tmp_path, monkeypatch):
    """The slice as a whole: both packages' serial LOSO, every fold from the
    same flax-initialised weights."""
    data = _write_tree(tmp_path / "data")
    cfg_j, cfg_p = _slice_configs(data)
    jm = build_jax_model(cfg_j.model, 2)
    variables = jm.init(jax.random.PRNGKey(3), jnp.zeros((2, 3, WINDOW_T)), train=False)
    variables = jax.tree_util.tree_map(np.asarray, dict(variables))

    class SeededJaxTrainer(JaxTrainer):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.state = TrainState(params=variables["params"],
                                    batch_stats=variables["batch_stats"],
                                    opt_state=self.tx.init(variables["params"]))

    def seeded_port_trainer(*args, **kwargs):
        return PortTrainer(*args, variables=variables, **kwargs)

    monkeypatch.setattr(jloso, "Trainer", SeededJaxTrainer)
    monkeypatch.setattr(ploso, "Trainer", seeded_port_trainer)
    want, want_summary = jloso.run_simple_experiment(cfg_j, tmp_path / "jax")
    got, got_summary = ploso.run_simple_experiment(cfg_p, tmp_path / "port", device="cpu")
    assert [r.subject for r in got] == list(SUBJECTS) == [r.subject for r in want]
    for g, w in zip(got, want):
        assert (g.accuracy, g.f1_score) == (w.accuracy, w.f1_score), g.subject
        assert (g.epochs_run, g.best_epoch) == (w.epochs_run, w.best_epoch)
        np.testing.assert_allclose(g.test_loss, w.test_loss, rtol=1e-4, err_msg=g.subject)
    assert got_summary == want_summary
    assert _mean_lines(tmp_path / "port" / "cv_summary.txt") == _mean_lines(
        tmp_path / "jax" / "cv_summary.txt")
    cfg_back = jcfg.config_from_dict(
        jcfg.ExperimentConfig, json.loads((tmp_path / "port" / "config.json").read_text()))
    assert cfg_back == cfg_j
    for s in SUBJECTS:
        fold = tmp_path / "port" / f"fold_test_on_{s}"
        assert read_flax_checkpoint(fold / "best_model.msgpack")["params"]
        assert np.load(fold / "test_probs.npy").shape[1] == 2


def test_main_cli_on_cpu_writes_the_run_directory(tmp_path, capsys):
    data = _write_tree(tmp_path / "data", n=12, t=WINDOW_T)
    pmain.main(["--execution", "serial", "--device", "cpu",
                "--output-dir", str(tmp_path / "out"),
                "--set", f"data_path={data}", "--set", "subjects=S2,S3,S4",
                "--set", "model.gru_impl=pallas_fused",
                "--set", "model.gru_hidden_size=8", "--set", "model.cnn_out_channels=8",
                "--set", "trainer.epochs=1", "--set", "trainer.batch_size=16"])
    (run_dir,) = (tmp_path / "out" / "simple_binary").iterdir()
    assert f"Run directory: {run_dir}" in capsys.readouterr().out
    cfg = jcfg.config_from_dict(jcfg.ExperimentConfig,
                                json.loads((run_dir / "config.json").read_text()))
    assert cfg.model.gru_impl == "pallas_fused" and cfg.subjects == SUBJECTS
    summary = (run_dir / "cv_summary.txt").read_text()
    assert summary.count("  - test S") == 3 and "Mean weighted F1" in summary
    for s in SUBJECTS:
        assert (run_dir / f"fold_test_on_{s}" / "best_model.msgpack").is_file()


@pytest.mark.parametrize("argv,what", [
    (["--execution", "serial", "--from-pickles", "WESAD"], "--from-pickles"),
])
def test_main_refuses_what_is_not_ported(argv, what, tmp_path):
    """--from-pickles is ported for the sharded sweep and refused with
    --execution serial, as the JAX package refuses it. (--hierarchical and
    --seeds are ported: tests/test_torch_hierarchical.py and
    tests/test_torch_replicated.py hold their refusals.)"""
    item = {"--from-pickles": "requires --execution sharded"}[what]
    with pytest.raises(SystemExit) as exc:
        pmain.main(argv + ["--device", "cpu", "--output-dir", str(tmp_path)])
    assert what in str(exc.value.code)
    assert item in str(exc.value.code)
    assert not any(tmp_path.iterdir())


def test_hybrid_model_is_refused(tmp_path):
    """The serial hybrid run is ported (tests/test_torch_hybrid.py); it is
    still refused without both preprocess targets, and where they are
    missing on disk, before any fold runs."""
    cfg = pcfg.ExperimentConfig(model=pcfg.ModelConfig(name="hybrid_cnn_gru"),
                                raw_align_path="a")
    with pytest.raises(ValueError, match="requires raw_align_path and feature_path"):
        ploso.run_simple_experiment(cfg, tmp_path / "r1", device="cpu")
    cfg = dataclasses.replace(cfg, raw_align_path=str(tmp_path / "a"),
                              feature_path=str(tmp_path / "b"))
    with pytest.raises(FileNotFoundError, match="_channel_names.txt"):
        ploso.run_simple_experiment(cfg, tmp_path / "r2", device="cpu")
    assert not (tmp_path / "r2" / "cv_summary.txt").exists()
