"""The port's fold ensemble (multimodalsignal_tpu_torch/experiments/predict.py
EnsemblePredictor, the predict and serving CLIs with --run-dir) against the
mean of its per-fold Predictors and against the JAX package's
EnsemblePredictor, on the CPU, on a run directory written by the port's
sharded sweep (3 folds, H = 8, conv 8, T = 128), and on one of the serial
LOSO CLI trained with gru_impl="pallas_fused".

Tolerances: against the mean of the port's per-fold Predictors 1e-6 (the
same lanes' arithmetic in other op orders, then a mean of 3); against the
JAX package's ensemble float32 atol 1e-5, as the single-fold Predictor's
parity test; over HTTP 1e-5, the replies rounding to 6 decimals."""

import json
import pickle
import re
import subprocess
import sys
import urllib.request
from pathlib import Path

import numpy as np
import pytest

from multimodalsignal_tpu.experiments.predict import EnsemblePredictor as JaxEnsemble
from multimodalsignal_tpu_torch import main as pmain
from multimodalsignal_tpu_torch.experiments import predict as ppredict
from multimodalsignal_tpu_torch.experiments.predict import EnsemblePredictor, Predictor

from tests.test_torch_fold_sweep import one_torch_thread, write_tree  # noqa: F401

SUBJECTS = ("S2", "S3", "S4")
REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    """The sweep's run directory; its preprocess meta (16 Hz, 8 s windows
    at a 4 s stride) makes a recording's windows the trained T = 128."""
    root = tmp_path_factory.mktemp("ensemble")
    data = write_tree(root / "data", SUBJECTS)
    (data / "_preprocess_meta.json").write_text(json.dumps(
        {"original_fs": 700, "fs": 16, "window_sec": 8, "stride_sec": 4}))
    pmain.main(["--device", "cpu", "--output-dir", str(root / "out"),
                "--set", f"data_path={data}", "--set", "subjects=" + ",".join(SUBJECTS),
                "--set", "model.gru_hidden_size=8", "--set", "model.cnn_out_channels=8",
                "--set", "trainer.epochs=1", "--set", "trainer.batch_size=4"])
    (run,) = (root / "out" / "simple_binary").iterdir()
    return run


@pytest.fixture(scope="module")
def windows():
    return np.random.default_rng(0).standard_normal((70, 3, 128)).astype(np.float32)


def test_ensemble_is_the_mean_of_the_fold_predictors(run_dir, windows):
    ens = EnsemblePredictor.from_run(run_dir, device="cpu")
    assert ens.fold_names == SUBJECTS and ens.model.folds == 3
    got = ens.predict_windows(windows)          # 2 padded batches of 64
    want = np.mean([Predictor.from_run(run_dir, s, device="cpu").predict_windows(windows)
                    for s in SUBJECTS], axis=0)
    assert got.shape == (70, 2)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.sum(axis=1), 1.0, rtol=1e-6)
    one = EnsemblePredictor.from_run(run_dir, fold="S3", device="cpu")
    assert type(one) is Predictor
    with pytest.raises(FileNotFoundError):
        EnsemblePredictor.from_run(run_dir / "fold_test_on_S2", device="cpu")


def test_ensemble_matches_jax(run_dir, windows):
    """The JAX package's EnsemblePredictor reads the same run directory."""
    got = EnsemblePredictor.from_run(run_dir, device="cpu").predict_windows(windows[:9])
    want = JaxEnsemble.from_run(run_dir).predict_windows(windows[:9])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.fixture(scope="module")
def fused_run_dir(tmp_path_factory):
    """A serial LOSO run trained with gru_impl="pallas_fused" (config.json
    keeps it), 1 epoch: what the fold ensemble must serve."""
    root = tmp_path_factory.mktemp("fused")
    data = write_tree(root / "data", SUBJECTS)
    pmain.main(["--device", "cpu", "--execution", "serial", "--output-dir", str(root / "out"),
                "--set", f"data_path={data}", "--set", "subjects=" + ",".join(SUBJECTS),
                "--set", "model.gru_impl=pallas_fused", "--set", "model.gru_hidden_size=8",
                "--set", "model.cnn_out_channels=8", "--set", "trainer.epochs=1",
                "--set", "trainer.batch_size=4"])
    (run,) = (root / "out" / "simple_binary").iterdir()
    assert json.loads((run / "config.json").read_text())["model"]["gru_impl"] == "pallas_fused"
    return run


def test_ensemble_of_a_pallas_fused_run_matches_jax(fused_run_dir, windows):
    """The ensemble of a pallas_fused run: its folds as 2F lanes of the
    fused pair (the plain versions here), against the mean of the fold
    Predictors (the single-fold fused pair, 1e-6) and the JAX package's
    EnsemblePredictor (jax.vmap of the fused model, interpret mode: atol
    1e-5). Building this ensemble raised before the fused pair took the
    fold axis."""
    ens = EnsemblePredictor.from_run(fused_run_dir, device="cpu")
    assert ens.model.impl == "fused" and ens.fold_names == SUBJECTS
    got = ens.predict_windows(windows[:9])
    want = np.mean([Predictor.from_run(fused_run_dir, s, device="cpu").predict_windows(
        windows[:9]) for s in SUBJECTS], axis=0)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    jax_probs = JaxEnsemble.from_run(fused_run_dir).predict_windows(windows[:9])
    np.testing.assert_allclose(got, jax_probs, rtol=0, atol=1e-5)


def _write_recording(path: Path, seconds: int = 75, seed: int = 2) -> None:
    """A WESAD-format chest recording at 700 Hz, byte-keyed as the
    original pickles are."""
    rng = np.random.default_rng(seed)
    n = seconds * 700
    chest = {key: rng.normal(0, 1, (n, 3 if key == b"ACC" else 1))
             for key in (b"ACC", b"ECG", b"EMG", b"Resp", b"Temp")}
    chest[b"EDA"] = 2.0 + rng.normal(0, 0.1, (n, 1))
    with open(path, "wb") as f:
        pickle.dump({b"signal": {b"chest": chest}}, f)


def test_predict_cli_run_dir_defaults_to_the_ensemble(run_dir, tmp_path):
    pkl = tmp_path / "S99.pkl"
    _write_recording(pkl)
    ppredict.main(["--run-dir", str(run_dir), "--pkl", str(pkl), "--device", "cpu",
                   "--out", str(tmp_path / "ens.json")])
    ppredict.main(["--run-dir", str(run_dir), "--fold", "S2", "--pkl", str(pkl),
                   "--device", "cpu", "--out", str(tmp_path / "s2.json")])
    got = json.loads((tmp_path / "ens.json").read_text())["windows"]
    want = EnsemblePredictor.from_run(run_dir, device="cpu").predict_recording(pkl)
    assert len(got) == len(want.probs) == 17      # 8 s windows at a 4 s stride in 75 s
    np.testing.assert_allclose([w["probs"] for w in got], want.probs, rtol=0, atol=1e-6)
    one = json.loads((tmp_path / "s2.json").read_text())["windows"]
    s2 = Predictor.from_run(run_dir, "S2", device="cpu").predict_recording(pkl)
    np.testing.assert_allclose([w["probs"] for w in one], s2.probs, rtol=0, atol=1e-6)


def test_serving_run_dir_answers_predict(run_dir):
    """`python -m multimodalsignal_tpu_torch.serving --run-dir` serves the
    ensemble: /healthz names it, /v1/predict answers with its
    probabilities."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "multimodalsignal_tpu_torch.serving", "--run-dir",
         str(run_dir), "--device", "cpu", "--port", "0"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        seen = []
        for line in proc.stdout:      # the server's start-up line names its port
            seen.append(line)
            match = re.search(r"^Serving .* on (http://\S+) ", line)
            if match:
                break
        assert match, "".join(seen)
        url = match.group(1)
        with urllib.request.urlopen(url + "/healthz", timeout=60) as resp:
            card = json.loads(resp.read())
        assert card["backend"] == "checkpoint-ensemble[3]" and card["platform"] == "cpu"
        x = np.random.default_rng(1).standard_normal((2,) + tuple(card["window_shape"]))
        req = urllib.request.Request(url + "/v1/predict",
                                     data=json.dumps({"windows": x.tolist()}).encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as resp:
            reply = json.loads(resp.read())
    finally:
        proc.terminate()
        proc.wait(timeout=60)
    assert reply["num_windows"] == 2
    want = EnsemblePredictor.from_run(run_dir, device="cpu").predict_windows(
        x.astype(np.float32))
    np.testing.assert_allclose(reply["probs"], want, rtol=0, atol=1e-5)
