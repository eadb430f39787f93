"""The port's serving slice end to end on the CPU, against the JAX package:
one flax checkpoint + config.json written by the JAX package, served by
multimodalsignal_tpu.experiments.predict.Predictor and by the port's
Predictor (device="cpu"), then the port's HTTP server.

Default ModelConfig (cnn_gru_attention, C=3, 2 layers) at H=16. Tolerances:
probs atol 1e-4; windows rtol 1e-5 (the JAX side normalizes float32 through
its C++ engine, which matches the NumPy float64 path to float32 round-off)."""

import base64
import io
import json
import threading
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest

from multimodalsignal_tpu.config import ExperimentConfig, ModelConfig, save_config
from multimodalsignal_tpu.data.synthetic import write_synthetic_wesad
from multimodalsignal_tpu.experiments.predict import Predictor as JaxPredictor
from multimodalsignal_tpu.models import build_model
from multimodalsignal_tpu.train.checkpoints import save_state
from multimodalsignal_tpu.train.optim import make_optimizer
from multimodalsignal_tpu.train.trainer import init_train_state
from multimodalsignal_tpu_torch.experiments.predict import Predictor
from multimodalsignal_tpu_torch.serving import PredictionService, make_server

from tests.conftest import TASKS_SMALL

C, T = 3, 7680


@pytest.fixture(scope="module")
def run_files(tmp_path_factory):
    """(checkpoint, config) of a JAX run: default widths at H=16, with
    non-trivial BN statistics."""
    root = tmp_path_factory.mktemp("run")
    cfg = ExperimentConfig(model=ModelConfig(gru_hidden_size=16))
    model = build_model(cfg.model, cfg.num_classes)
    state = init_train_state(model, jax.random.PRNGKey(3),
                             np.zeros((1, C, T), np.float32),
                             make_optimizer(1e-3, 1e-4))
    rng = np.random.default_rng(3)
    stats = jax.tree_util.tree_map(np.asarray, state.batch_stats)
    for bn in ("bn1", "bn2"):
        n = stats["cnn_encoder"][bn]["mean"].shape
        stats["cnn_encoder"][bn]["mean"] = rng.uniform(-0.3, 0.3, n).astype(np.float32)
        stats["cnn_encoder"][bn]["var"] = rng.uniform(0.5, 2.0, n).astype(np.float32)
    state = state.replace(batch_stats=stats)
    ckpt, config = root / "best_model.msgpack", root / "config.json"
    save_state(ckpt, state)
    save_config(cfg, config)
    return ckpt, config


@pytest.fixture(scope="module")
def predictors(run_files):
    return (JaxPredictor.from_files(*run_files),
            Predictor.from_files(*run_files, device="cpu"))


@pytest.fixture(scope="module")
def recording(tmp_path_factory):
    root = tmp_path_factory.mktemp("wesad")
    write_synthetic_wesad(root, ["S2"], tasks=TASKS_SMALL, seed=5)
    return root / "S2" / "S2.pkl"


def _windows(n, seed=0):
    return np.random.default_rng(seed).standard_normal((n, C, T)).astype(np.float32)


def test_predict_windows_matches_jax(predictors):
    jp, tp = predictors
    x = _windows(70)  # one full padded batch of 64 and one of 6
    want = jp.predict_windows(x)
    got = tp.predict_windows(x)
    assert got.shape == (70, 2)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_predict_recording_matches_jax(predictors, recording):
    jp, tp = predictors
    want_x, want_starts = jp.windows_from_recording(recording)
    got_x, got_starts = tp.windows_from_recording(recording)
    assert got_x.dtype == np.float32 and got_x.shape == want_x.shape
    np.testing.assert_array_equal(got_starts, want_starts)
    np.testing.assert_allclose(got_x, want_x, rtol=1e-5, atol=1e-5)
    want = jp.predict_recording(recording)
    got = tp.predict_recording(recording)
    assert got.class_names == want.class_names
    np.testing.assert_allclose(got.probs, want.probs, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(got.starts_sec, want.starts_sec)


@pytest.fixture(scope="module")
def server(predictors):
    service = PredictionService(predictors[1], batch_size=8,
                                max_request_windows=12)
    httpd = make_server(service, host="127.0.0.1", port=0)  # ephemeral port
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{httpd.server_address[1]}", service
    httpd.shutdown()
    httpd.server_close()
    thread.join(timeout=30)
    assert not thread.is_alive()
    service.close()


def _post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"},
                                 method="POST")
    try:
        with urllib.request.urlopen(req) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as exc:
        return exc.code, json.loads(exc.read())


def test_http_healthz(server):
    url, _ = server
    with urllib.request.urlopen(url + "/healthz") as resp:
        card = json.loads(resp.read())
    assert card["status"] == "ok"
    assert card["platform"] == "cpu"
    assert card["model"] == "cnn_gru_attention"
    assert card["window_shape"] == [C, T]
    assert card["channels"] == ["chest_ECG", "chest_EDA", "chest_Resp"]


def test_http_predict_equals_predict_windows(server, predictors):
    url, _ = server
    x = _windows(11, seed=1)  # batch_size 8: one full and one padded batch
    status, out = _post(url + "/v1/predict", {"windows": x.tolist()})
    assert status == 200 and out["num_windows"] == 11
    np.testing.assert_allclose(out["probs"], predictors[1].predict_windows(x, 8),
                               rtol=0, atol=1e-6)
    buf = io.BytesIO()
    np.save(buf, x[:2])
    status, out = _post(url + "/v1/predict",
                        {"windows_b64": base64.b64encode(buf.getvalue()).decode()})
    assert status == 200
    np.testing.assert_allclose(out["probs"], predictors[0].predict_windows(x[:2]),
                               rtol=0, atol=1e-4)


def test_http_predict_recording(server, predictors, recording):
    url, _ = server
    status, out = _post(url + "/v1/predict_recording", {"pkl_path": str(recording)})
    assert status == 200
    want = predictors[0].predict_recording(recording)
    np.testing.assert_allclose([w["probs"] for w in out["windows"]], want.probs,
                               rtol=0, atol=1e-4)
    assert sum(out["class_counts"].values()) == len(want.probs)


def test_http_errors(server):
    url, _ = server
    status, out = _post(url + "/v1/predict",
                        {"windows": np.zeros((1, C + 1, 8), np.float32).tolist()})
    assert status == 400 and "expected windows of shape" in out["error"]
    buf = io.BytesIO()
    np.save(buf, np.zeros((13, C, T), np.float32))  # over max_request_windows=12
    status, out = _post(url + "/v1/predict",
                        {"windows_b64": base64.b64encode(buf.getvalue()).decode()})
    assert status == 413 and "limit is 12" in out["error"]
    status, _ = _post(url + "/v1/predict_recording", {"pkl_path": "/nonexistent.pkl"})
    assert status == 400


# -- wrist channels in the Predictor ------------------------------------------------

WRIST = ["chest_ECG", "wrist_BVP", "wrist_EDA"]


@pytest.mark.parametrize("has_wrist", [True, False])
def test_wrist_grid_and_windows_match_jax(recording, has_wrist, tmp_path, monkeypatch, capsys):
    """A wrist checkpoint's recording grid: the chest block, then the wrist
    block resampled as preprocessing does (zeros and a warning for a
    chest-only recording), and its windows, bitwise the JAX package's (its
    NumPy normalization path)."""
    from multimodalsignal_tpu import native
    from multimodalsignal_tpu.experiments import predict as jpredict
    from multimodalsignal_tpu_torch.experiments import predict as ppredict

    from tests.test_torch_ensemble import _write_recording

    monkeypatch.setattr(native, "available", lambda: False)
    pkl = recording
    if not has_wrist:
        pkl = tmp_path / "S99.pkl"
        _write_recording(pkl, seconds=100)
    got, names = ppredict._recording_grid(pkl, WRIST, 700, 128)
    out = capsys.readouterr().out
    want, want_names = jpredict._recording_grid(pkl, WRIST, 700, 128)
    assert names == want_names and names[8:] == ["wrist_ACC_x", "wrist_ACC_y", "wrist_ACC_z",
                                                 "wrist_BVP", "wrist_EDA", "wrist_TEMP"]
    np.testing.assert_array_equal(got, want)
    assert ("no wrist data" in out) == (not has_wrist)
    assert (got[:, 8:] == 0).all() == (not has_wrist)
    chest, chest_names = ppredict._recording_grid(pkl, ["chest_ECG"], 700, 128)
    assert chest_names == names[:8]
    np.testing.assert_array_equal(chest, got[:, :8])
    (x, starts), (jx, jstarts) = (mod.recording_to_windows(pkl, WRIST, "all")
                                  for mod in (ppredict, jpredict))
    assert x.shape[1:] == (3, 7680)
    np.testing.assert_array_equal(starts, jstarts)
    np.testing.assert_array_equal(x, jx)


def test_wrist_predictor_matches_jax(recording, tmp_path):
    """A random-weight checkpoint on chest_ECG, wrist_BVP, wrist_EDA
    classifies a recording as the JAX Predictor does."""
    from tests.test_torch_streaming import write_run

    cfg = ExperimentConfig(channels_to_use=tuple(WRIST), model=ModelConfig(gru_hidden_size=8))
    run = write_run(tmp_path / "wrist", cfg, folds=("S2",), meta={})
    got = Predictor.from_run(run, "S2", device="cpu").predict_recording(recording)
    want = JaxPredictor.from_run(run, "S2").predict_recording(recording)
    np.testing.assert_allclose(got.probs, want.probs, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got.starts_sec, want.starts_sec)
