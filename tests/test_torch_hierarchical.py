"""The port's hierarchical two-stage experiment (multimodalsignal_tpu_torch:
config.HierarchicalConfig, experiments/hierarchical.py,
parallel/hierarchical_sweep.py, experiments/predict.py
HierarchicalPredictor, main --hierarchical) against the JAX package's, on
the CPU at small widths (H = 8, conv 8, T = 128, 3 subjects).

Tolerances. The composed evaluation's confusion matrices against JAX's
make_composed_predict per fold, from the same flax weights: exactly (both
take argmaxes of float32 logits that agree to ~1e-6). The hierarchical
predictor against JAX's on the same run directory: labels exactly,
probabilities atol 1e-5 (float32 logits in other op orders, as the
single-fold Predictor's parity test). The summaries byte for byte.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from multimodalsignal_tpu import config as jcfg
from multimodalsignal_tpu.data import dataset as jdata
from multimodalsignal_tpu.experiments import hierarchical as jh
from multimodalsignal_tpu.experiments.predict import HierarchicalPredictor as JaxHierarchical
from multimodalsignal_tpu.models import build_model as build_jax_model
from multimodalsignal_tpu.parallel import hierarchical_sweep as jhs
from multimodalsignal_tpu_torch import config as pcfg
from multimodalsignal_tpu_torch import main as pmain
from multimodalsignal_tpu_torch.data import dataset as pdata
from multimodalsignal_tpu_torch.data import preprocess as ppre
from multimodalsignal_tpu_torch.data import synthetic as psyn
from multimodalsignal_tpu_torch.experiments import hierarchical as ph
from multimodalsignal_tpu_torch.experiments import predict as ppredict
from multimodalsignal_tpu_torch.experiments.predict import HierarchicalPredictor, Predictor
from multimodalsignal_tpu_torch.parallel import fold_sweep as pfs
from multimodalsignal_tpu_torch.parallel import hierarchical_sweep as phs
from multimodalsignal_tpu_torch.train.checkpoints import read_flax_checkpoint

from tests.test_torch_ensemble import _write_recording
from tests.test_torch_fold_sweep import one_torch_thread, write_tree  # noqa: F401

SUBJECTS = ("S2", "S3", "S4")
T = 128
M1_CHANNELS = ("chest_ECG", "chest_EDA")
M2_CHANNELS = ("chest_EDA", "chest_Resp")
UNION = ("chest_ECG", "chest_EDA", "chest_Resp")
M1 = dict(gru_hidden_size=8, cnn_out_channels=8, dropout=0.0)
M2 = dict(name="cnn_gru", gru_hidden_size=8, cnn_out_channels=8, gru_num_layers=1,
          dropout=0.0)


def _hier_argv(data, out, execution=None):
    argv = ["--hierarchical", "--device", "cpu", "--output-dir", str(out),
            "--set", f"base.data_path={data}", "--set", "base.subjects=" + ",".join(SUBJECTS),
            "--set", "m1_channels=" + ",".join(M1_CHANNELS),
            "--set", "m2_channels=" + ",".join(M2_CHANNELS),
            "--set", "base.trainer.epochs=2", "--set", "base.trainer.batch_size=4"]
    for stage, fields in (("m1_model", M1), ("m2_model", M2)):
        argv += [a for k, v in fields.items() for a in ("--set", f"{stage}.{k}={v}")]
    return argv + (["--execution", execution] if execution else [])


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """3 subjects (every one with Base, TSST and Fun windows); the preprocess
    meta (16 Hz, 8 s windows at a 4 s stride) makes a recording's windows
    the trained T = 128."""
    root = write_tree(tmp_path_factory.mktemp("hier") / "data", SUBJECTS)
    (root / "_preprocess_meta.json").write_text(json.dumps(
        {"original_fs": 700, "fs": 16, "window_sec": 8, "stride_sec": 4}))
    return root


@pytest.fixture(scope="module")
def runs(data, tmp_path_factory):
    """The run directories of main --hierarchical, sharded (the default) and
    --execution serial."""
    out = {}
    for execution in ("sharded", "serial"):
        root = tmp_path_factory.mktemp(execution)
        pmain.main(_hier_argv(data, root, None if execution == "sharded" else execution))
        (out[execution],) = (root / "hierarchical_binary").iterdir()
    return out


def test_hierarchical_config_matches_jax_and_takes_overrides():
    """HierarchicalConfig's defaults are the JAX package's (M2: H=32, one
    layer), config_from_dict rebuilds it from either package's dict, and
    dotted overrides reach base, m1_model and m2_model."""
    assert pcfg.config_to_dict(pcfg.HierarchicalConfig()) == jcfg.config_to_dict(
        jcfg.HierarchicalConfig())
    cfg = pcfg.HierarchicalConfig()
    assert (cfg.m2_model.gru_hidden_size, cfg.m2_model.gru_num_layers) == (32, 1)
    assert cfg.m1_model == pcfg.ModelConfig()
    again = pcfg.config_from_dict(pcfg.HierarchicalConfig,
                                  jcfg.config_to_dict(jcfg.HierarchicalConfig()))
    assert again == cfg
    cfg = pcfg.apply_overrides(cfg, {"base.trainer.epochs": 2, "m2_model.gru_hidden_size": 16,
                                     "m1_channels": "chest_ECG"})
    assert (cfg.base.trainer.epochs, cfg.m2_model.gru_hidden_size, cfg.m1_channels) == (
        2, 16, ("chest_ECG",))
    assert pcfg._ordered_union(M1_CHANNELS, M2_CHANNELS) == jh._ordered_union(
        M1_CHANNELS, M2_CHANNELS) == list(UNION)


def _jax_lane_variables(model_fields, channels, folds, seed):
    jm = build_jax_model(jcfg.ModelConfig(**model_fields), 2)
    keys = jax.random.split(jax.random.PRNGKey(seed), folds)
    v = jax.vmap(lambda k: jm.init(k, jnp.zeros((2, len(channels), T)), train=False))(keys)
    return jm, jax.tree_util.tree_map(np.asarray, dict(v))


def test_composed_eval_matches_jax_make_composed_predict_per_fold(data):
    """composed_fold_cms (both stages as lanes of FoldStackedModels, every
    fold's test pool of the union corpus in batches of 4) against JAX's
    make_composed_predict on that fold's test windows with that lane's
    variables: the same confusion matrix, exactly. M1 has 2 layers, M2 one
    (a lone pruned walk), on different channels."""
    names = pdata.read_channel_names(data)
    corpus = pdata.pack_corpus(data, list(SUBJECTS), list(UNION), names, "ternary")
    fb = pfs.build_fold_batch(corpus, list(SUBJECTS), 0.2, 42)
    folds = len(fb.test_subjects)
    jm1, v1 = _jax_lane_variables(M1, M1_CHANNELS, folds, seed=1)
    jm2, v2 = _jax_lane_variables(M2, M2_CHANNELS, folds, seed=2)
    i1 = [UNION.index(c) for c in M1_CHANNELS]
    i2 = [UNION.index(c) for c in M2_CHANNELS]
    got = phs.composed_fold_cms(corpus, fb, ((pcfg.ModelConfig(**M1), v1, i1),
                                             (pcfg.ModelConfig(**M2), v2, i2)), 4, "cpu")
    predict = jh.make_composed_predict(jm1, jm2, i1, i2)
    x, y, _ = corpus.flat()
    lane = lambda v, f: jax.tree_util.tree_map(lambda a: a[f], v)  # noqa: E731
    for f in range(folds):
        pool = fb.test_pool[f, :fb.n_test[f]]
        preds = np.asarray(predict(lane(v1, f), lane(v2, f), jnp.asarray(x[pool])))
        want = np.zeros((3, 3))
        np.add.at(want, (y[pool], preds), 1)
        np.testing.assert_array_equal(got[f], want, err_msg=fb.test_subjects[f])
    assert got.sum() == fb.n_test.sum()


@pytest.mark.parametrize("execution", ["sharded", "serial"])
def test_hierarchical_predictor_matches_jax_on_the_ports_run(execution, runs):
    """The port's HierarchicalPredictor and the JAX package's, both from the
    run directory the port wrote: the same gated labels, the same product
    probabilities (atol 1e-5); the port's labels are the hard gate of its
    two stage Predictors run by hand."""
    run_dir = runs[execution]
    x = np.random.default_rng(0).standard_normal((9, 3, T)).astype(np.float32)
    hp = HierarchicalPredictor.from_run(run_dir, "S3", device="cpu")
    assert hp.channels == UNION and hp.class_names == ("baseline", "amusement", "stress")
    probs, labels = hp.predict_windows_labeled(x, batch_size=4)
    jprobs, jlabels = JaxHierarchical.from_run(run_dir, "S3").predict_windows_labeled(
        x, batch_size=4)
    np.testing.assert_array_equal(labels, np.asarray(jlabels))
    np.testing.assert_allclose(probs, np.asarray(jprobs), rtol=0, atol=1e-5)
    np.testing.assert_allclose(probs.sum(axis=1), 1.0, rtol=1e-6)
    p1 = Predictor.from_cfg_and_checkpoint(
        hp.m1.cfg, run_dir / "fold_test_on_S3" / "model_m1" / "best_model.msgpack",
        device="cpu").predict_windows(x[:, [0, 1]])
    p2 = Predictor.from_cfg_and_checkpoint(
        hp.m2.cfg, run_dir / "fold_test_on_S3" / "model_m2" / "best_model.msgpack",
        device="cpu").predict_windows(x[:, [1, 2]])
    np.testing.assert_array_equal(labels, np.where(p1.argmax(1) == 1, 2, p2.argmax(1)))
    np.testing.assert_allclose(probs, np.stack(
        [p1[:, 0] * p2[:, 0], p1[:, 0] * p2[:, 1], p1[:, 1]], axis=1), rtol=0, atol=1e-6)
    assert hp.m2.cfg.model.gru_num_layers == 1
    assert hp.m2.cfg.classification_mode == "amusement_binary"


@pytest.mark.parametrize("execution", ["sharded", "serial"])
def test_main_hierarchical_writes_the_jax_run_layout(execution, runs):
    """main --hierarchical (sharded by default, or --execution serial) at
    --device cpu: config.json readable as JAX's HierarchicalConfig, a
    summary of 3 finite folds in the execution's text, and per fold both
    stages' best_model.msgpack; M2's holds one GRU layer."""
    run_dir = runs[execution]
    cfg = jcfg.config_from_dict(jcfg.HierarchicalConfig,
                                json.loads((run_dir / "config.json").read_text()))
    assert cfg.m1_channels == M1_CHANNELS and cfg.m2_model.gru_num_layers == 1
    assert cfg.base.subjects == SUBJECTS and cfg.base.trainer.epochs == 2
    text = (run_dir / "hierarchical_summary.txt").read_text()
    title = "Hierarchical experiment summary" + (" (sharded)" if execution == "sharded" else "")
    assert text.splitlines()[0] == title
    assert text.count("  - test S") == 3 and "nan" not in text
    for s in SUBJECTS:
        for sub in ("model_m1", "model_m2"):
            ckpt = read_flax_checkpoint(run_dir / f"fold_test_on_{s}" / sub / "best_model.msgpack")
            gru = ckpt["params"]["gru"]
            assert ("l1_fwd_w_hh" in gru) == (sub == "model_m1"), sorted(gru)


def _results(n=3):
    rng = np.random.default_rng(4)
    return [jh.HierarchicalFoldResult(f"S{i + 2}", *rng.uniform(0, 1, 4).tolist(),
                                      int(rng.integers(5, 40)), float(rng.uniform(1, 9)))
            for i in range(n)]


def test_summaries_match_jax_byte_for_byte(tmp_path):
    """hierarchical_summary.txt of both executions, and the empty one, from
    the same results, predictions and confusion matrices."""
    results = _results()
    port_results = [ph.HierarchicalFoldResult(**dataclasses.asdict(r)) for r in results]
    rng = np.random.default_rng(5)
    preds = [rng.integers(0, 3, r.num_test_windows) for r in results]
    true = [rng.integers(0, 3, r.num_test_windows) for r in results]
    cms = rng.integers(0, 9, (3, 3, 3)).astype(np.float32)
    total = np.zeros((3, 3))
    for cm in cms:
        total += cm
    for name, write_port, write_jax in (
            ("serial", lambda d, r: ph._write_summary(d, r, preds, true),
             lambda d, r: jh._write_summary(d, r, preds, true)),
            ("sharded", lambda d, r: phs._write_summary_from_cms(d, r, total),
             lambda d, r: jhs._write_summary_from_cms(d, r, total)),
            ("empty", lambda d, r: ph._write_summary(d, [], [], []),
             lambda d, r: jh._write_summary(d, [], [], []))):
        (tmp_path / name / "port").mkdir(parents=True)
        (tmp_path / name / "jax").mkdir()
        got = write_port(tmp_path / name / "port", port_results)
        want = write_jax(tmp_path / name / "jax", results)
        assert got == want, name
        assert ((tmp_path / name / "port" / "hierarchical_summary.txt").read_bytes()
                == (tmp_path / name / "jax" / "hierarchical_summary.txt").read_bytes()), name


def test_predict_cli_routes_a_hierarchical_run(runs, tmp_path, capsys):
    """predict --run-dir on a hierarchical run: --fold <subject> gives the
    composed ternary predictions, --fold all (the default) is refused."""
    pkl = tmp_path / "S99.pkl"
    _write_recording(pkl)
    run_dir = runs["sharded"]
    ppredict.main(["--run-dir", str(run_dir), "--fold", "S2", "--pkl", str(pkl),
                   "--device", "cpu", "--out", str(tmp_path / "h.json")])
    got = json.loads((tmp_path / "h.json").read_text())
    want = HierarchicalPredictor.from_run(run_dir, "S2", device="cpu").predict_recording(pkl)
    assert got["class_names"] == ["baseline", "amusement", "stress"]
    assert [w["label"] for w in got["windows"]] == [want.class_names[i] for i in want.labels]
    np.testing.assert_allclose([w["probs"] for w in got["windows"]], want.probs, rtol=0,
                               atol=1e-6)
    assert len(got["windows"]) == 17      # 8 s windows at a 4 s stride in 75 s
    with pytest.raises(SystemExit):
        ppredict.main(["--run-dir", str(run_dir), "--pkl", str(pkl), "--device", "cpu"])
    assert "need --fold <subject>" in capsys.readouterr().err


def test_main_refuses_what_jax_refuses(data, tmp_path):
    """--hierarchical with --seeds, and with --from-pickles under --execution
    serial, exit with JAX's messages before a run directory is made."""
    with pytest.raises(SystemExit, match="--seeds is not supported with --hierarchical"):
        pmain.main(_hier_argv(data, tmp_path / "a") + ["--seeds", "1", "2"])
    with pytest.raises(SystemExit, match="--from-pickles requires --execution sharded"):
        pmain.main(_hier_argv(data, tmp_path / "b", "serial") + ["--from-pickles", "WESAD"])
    assert not (tmp_path / "a").exists() and not (tmp_path / "b").exists()


@pytest.mark.parametrize("execution", ["sharded", "serial"])
def test_main_hierarchical_asks_for_cuda_by_default(execution, data, tmp_path):
    """Without --device cpu the hierarchical CLI raises where there is no
    CUDA, before it makes a run directory; so do both entry points."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without CUDA")
    argv = [a for a in _hier_argv(data, tmp_path / "out", None if execution == "sharded"
                                  else execution) if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="cuda"):
        pmain.main(argv)
    assert not (tmp_path / "out").exists()
    run = ph.run_hierarchical_experiment if execution == "serial" else phs.run_hierarchical_sharded
    with pytest.raises(RuntimeError, match="cuda"):
        run(pcfg.HierarchicalConfig(), tmp_path / "lib")
    assert not (tmp_path / "lib").exists()


def test_sharded_from_pickles_preprocesses_each_subject_once(tmp_path, monkeypatch):
    """--hierarchical --from-pickles: the M1, M2 and union corpora come from
    one subject cache (each pickle preprocessed once), config.json carries
    from_pickles in base and the union's preprocess meta."""
    tasks = (("Base", 2.0), ("TSST", 1.5), ("Medi 1", 1.0), ("Fun", 1.5), ("Medi 2", 1.0))
    wesad = psyn.write_synthetic_wesad(tmp_path / "wesad", list(SUBJECTS), tasks=tasks, seed=7)
    calls = []
    real = ppre.preprocess_subject
    monkeypatch.setattr(ppre, "preprocess_subject",
                        lambda sid, cfg: (calls.append(sid), real(sid, cfg))[1])
    argv = _hier_argv(tmp_path / "nodata", tmp_path / "out") + ["--from-pickles", str(wesad)]
    argv[argv.index("base.trainer.epochs=2")] = "base.trainer.epochs=1"
    pmain.main(argv)
    assert sorted(calls) == sorted(SUBJECTS)
    (run_dir,) = (tmp_path / "out" / "hierarchical_binary").iterdir()
    saved = json.loads((run_dir / "config.json").read_text())
    assert saved["base"]["from_pickles"] == str(wesad)
    assert saved["preprocess_meta"] == pdata.from_pickles_meta(list(UNION))[1]
    assert saved["preprocess_meta"] == jdata.from_pickles_meta(list(UNION))[1]
    assert (run_dir / "hierarchical_summary.txt").read_text().count("  - test S") == 3
