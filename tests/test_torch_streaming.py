"""The port's streaming classifier (multimodalsignal_tpu_torch/experiments/
streaming.py), its causal resampler (data/resample.py StreamingPolyResampler)
and the calibration statistics (data/dataset.py channel_norm_stats,
apply_channel_norm) against the JAX package's, on the CPU.

Checkpoints are random weights from a torch seed written as run directories
that both packages read (H = 8, conv 8; preprocess meta 700 -> 16 Hz, 8 s
windows at a 4 s stride, T = 128): one fold, a 3-fold ensemble, a hybrid
model, and a hierarchical run (M1 2 layers, M2 1 layer).

Tolerances: the resampler and the statistics bitwise; the stream's events
against JAX's: index and times equal, labels equal, probabilities within
1e-5 (both sides in float32, other op orders); the port's own semantics as
the JAX package's tests/test_streaming.py holds them (atol 1e-5 stream
against batch, bitwise across chunkings, 0.02 for the native-rate feed
against the batch pipeline's FFT resampling)."""

import io
import json
import re
import sys

import numpy as np
import pytest
import torch

from multimodalsignal_tpu.data import dataset as jdata
from multimodalsignal_tpu.data.resample import StreamingPolyResampler as JaxResampler
from multimodalsignal_tpu.experiments import streaming as jstream
from multimodalsignal_tpu.experiments.predict import EnsemblePredictor as JaxEnsemble
from multimodalsignal_tpu.experiments.predict import HierarchicalPredictor as JaxHierarchical
from multimodalsignal_tpu.experiments.predict import Predictor as JaxPredictor
from multimodalsignal_tpu_torch.config import (
    ExperimentConfig,
    HierarchicalConfig,
    ModelConfig,
    save_config,
)
from multimodalsignal_tpu_torch.data.dataset import (
    apply_channel_norm,
    channel_norm_stats,
    normalize_subject,
)
from multimodalsignal_tpu_torch.data.features import FEATURE_EXTRACTOR_VERSION
from multimodalsignal_tpu_torch.data.resample import StreamingPolyResampler, resample_signal
from multimodalsignal_tpu_torch.experiments import streaming as pstream
from multimodalsignal_tpu_torch.experiments.predict import (
    EnsemblePredictor,
    HierarchicalPredictor,
    Predictor,
)
from multimodalsignal_tpu_torch.experiments.streaming import StreamingClassifier
from multimodalsignal_tpu_torch.models.cnn_gru import build_model
from multimodalsignal_tpu_torch.models.convert import export_jax_variables
from multimodalsignal_tpu_torch.train.checkpoints import write_initial_train_state

from tests.test_torch_ensemble import _write_recording
from tests.test_torch_fold_sweep import one_torch_thread  # noqa: F401

META = {"original_fs": 700, "fs": 16, "window_sec": 8, "stride_sec": 4}
FOLDS = ("S2", "S3", "S4")
SMALL = dict(gru_hidden_size=8, cnn_out_channels=8)


def random_variables(model_cfg: ModelConfig, num_classes: int, channels: int,
                     seed: int, num_features: int = 10) -> dict:
    """flax-layout weights of a freshly built port model under a torch seed,
    with batch-norm statistics away from 0 and 1."""
    torch.manual_seed(seed)
    variables = export_jax_variables(build_model(model_cfg, num_classes, channels,
                                                 num_features))
    rng = np.random.default_rng(seed)
    for bn in variables["batch_stats"]["cnn_encoder"].values():
        bn["mean"] = rng.uniform(-0.3, 0.3, bn["mean"].shape).astype(np.float32)
        bn["var"] = rng.uniform(0.5, 2.0, bn["var"].shape).astype(np.float32)
    return variables


def write_run(root, cfg, folds=FOLDS, seed=0, meta=META):
    """A run directory both packages read: config.json with the preprocess
    meta, a random-weight best_model.msgpack per fold."""
    hybrid = cfg.model.name == "hybrid_cnn_gru"
    for i, sid in enumerate(folds):
        v = random_variables(cfg.model, cfg.num_classes, len(cfg.channels_to_use), seed + i)
        write_initial_train_state(root / f"fold_test_on_{sid}" / "best_model.msgpack", v, 1e-3)
    extra = dict(meta, feature_extractor_version=FEATURE_EXTRACTOR_VERSION) if hybrid else meta
    save_config(cfg, root / "config.json", extra={"preprocess_meta": extra})
    return root


def write_hierarchical_run(root, seed=10):
    hcfg = HierarchicalConfig(m1_model=ModelConfig(**SMALL),
                              m2_channels=("chest_ECG", "chest_EMG"),
                              m2_model=ModelConfig(gru_num_layers=1, **SMALL))
    fold = root / "fold_test_on_S2"
    for sub, channels, model_cfg, s in (("model_m1", hcfg.m1_channels, hcfg.m1_model, seed),
                                        ("model_m2", hcfg.m2_channels, hcfg.m2_model, seed + 1)):
        write_initial_train_state(fold / sub / "best_model.msgpack",
                                  random_variables(model_cfg, 2, len(channels), s), 1e-3)
    save_config(hcfg, root / "config.json", extra={"preprocess_meta": META})
    return root


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("stream_runs")
    return {
        "raw": write_run(root / "raw", ExperimentConfig(model=ModelConfig(**SMALL))),
        "hybrid": write_run(root / "hybrid", ExperimentConfig(
            model=ModelConfig(name="hybrid_cnn_gru", **SMALL)), folds=("S2",), seed=5),
        "hier": write_hierarchical_run(root / "hier"),
    }


def predictors(runs, kind):
    """(port predictor on the CPU, JAX predictor) of one kind of run."""
    if kind == "single":
        return (Predictor.from_run(runs["raw"], "S2", device="cpu"),
                JaxPredictor.from_run(runs["raw"], "S2"))
    if kind == "ensemble":
        return (EnsemblePredictor.from_run(runs["raw"], device="cpu"),
                JaxEnsemble.from_run(runs["raw"]))
    if kind == "hybrid":
        return (Predictor.from_run(runs["hybrid"], "S2", device="cpu"),
                JaxPredictor.from_run(runs["hybrid"], "S2"))
    return (HierarchicalPredictor.from_run(runs["hier"], "S2", device="cpu"),
            JaxHierarchical.from_run(runs["hier"], "S2"))


def _feed_native(total_sec, seed):
    """A band-limited [n, 2] (ECG-like, EDA-like) feed at 700 Hz."""
    rng = np.random.default_rng(seed)
    n = total_sec * 700
    t = np.arange(n) / 700
    ecg = (np.sin(2 * np.pi * 1.1 * t) + 0.4 * np.sin(2 * np.pi * 8.0 * t)
           + 0.05 * rng.standard_normal(n))
    eda = 2.0 + 0.5 * np.sin(2 * np.pi * 0.05 * t) + 0.02 * rng.standard_normal(n)
    return np.stack([ecg, eda], axis=1).astype(np.float32)


def native_feed(channels, seconds, seed, fs=700):
    """[n, C] at `fs`: tones and noise, EDA-like columns positive."""
    rng = np.random.default_rng(seed)
    t = np.arange(seconds * fs) / fs
    cols = []
    for i, ch in enumerate(channels):
        x = np.sin(2 * np.pi * (0.3 + 0.7 * i) * t) + 0.3 * rng.standard_normal(len(t))
        cols.append(2.0 + 0.2 * x if "EDA" in ch else x)
    return np.stack(cols, axis=1).astype(np.float32)


def assert_events_match(got, want, atol=1e-5):
    assert [e.index for e in got] == [e.index for e in want]
    assert [(e.t_start_sec, e.t_end_sec) for e in got] == [(e.t_start_sec, e.t_end_sec)
                                                          for e in want]
    gp, wp = np.stack([e.probs for e in got]), np.stack([e.probs for e in want])
    np.testing.assert_allclose(gp, wp, rtol=0, atol=atol)
    top2 = np.sort(wp, axis=1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > 1e-5
    assert [e.label for e, c in zip(got, clear) if c] == [e.label for e, c in zip(want, clear)
                                                          if c]


# -- the causal resampler and the calibration statistics ---------------------

@pytest.mark.parametrize("chunk", [1, 37, 700, "all"])
def test_poly_resampler_is_jax_bitwise_in_any_chunking(chunk):
    x = np.random.default_rng(11).standard_normal((5 * 700, 3))
    whole = StreamingPolyResampler(700, 128, num_channels=3).push(x)
    step = len(x) if chunk == "all" else chunk
    port, jax_r = StreamingPolyResampler(700, 128, 3), JaxResampler(700, 128, 3)
    got = np.concatenate([port.push(x[i : i + step]) for i in range(0, len(x), step)])
    want = np.concatenate([jax_r.push(x[i : i + step]) for i in range(0, len(x), step)])
    assert got.dtype == np.float64 and len(got) == int(np.ceil(len(x) * 32 / 175))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, whole)
    assert (port.up, port.down, port.delay_sec, port.delay_out_samples) == (
        jax_r.up, jax_r.down, jax_r.delay_sec, jax_r.delay_out_samples) == (32, 175, 1750 / 22400,
                                                                            10.0)
    np.testing.assert_array_equal(port._h, jax_r._h)
    ident = StreamingPolyResampler(128, 128, 2)
    assert ident.delay_sec == 0.0 and ident.push(x[:9, :2]) is not None
    with pytest.raises(ValueError, match="channels"):
        port.push(np.zeros((4, 2)))


def test_poly_resampler_tracks_fft_resample_after_delay():
    """Mid-signal, the causal stream advanced by its group delay (10.0
    output samples at 700 -> 128 Hz) follows the batch FFT resampler."""
    feed = _feed_native(60, seed=12).astype(np.float64)
    stream = StreamingPolyResampler(700, 128, 2).push(feed)
    batch = resample_signal(feed, 700, 128)
    mid = slice(5 * 128, 50 * 128)
    np.testing.assert_allclose(stream[10:][mid], batch[mid], atol=0.02)


def test_norm_helpers_are_jax_and_normalize_subject_bitwise():
    names = ["chest_ECG", "chest_EDA", "chest_Resp"]
    rng = np.random.default_rng(1)
    x = rng.standard_normal((5, 64, 3))
    x[:, :, 1] = np.abs(x[:, :, 1]) - 0.5       # some below the log1p floor's reach
    mean, std = channel_norm_stats(x.reshape(-1, 3), names)
    jmean, jstd = jdata.channel_norm_stats(x.reshape(-1, 3), names)
    np.testing.assert_array_equal(mean, jmean)
    np.testing.assert_array_equal(std, jstd)
    got = apply_channel_norm(x, names, mean, std)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, jdata.apply_channel_norm(x, names, jmean, jstd))
    np.testing.assert_array_equal(got, normalize_subject(x, np.ones(5), names, "all"))


# -- the stream against JAX's ----------------------------------------------------

@pytest.mark.parametrize("kind", ["single", "ensemble", "hybrid", "hierarchical"])
def test_stream_matches_jax(runs, kind):
    """The same checkpoint streamed by both packages from a native 700 Hz
    feed in ragged chunks: the same events (hierarchical: the gated
    labels)."""
    port, jax_p = predictors(runs, kind)
    sc = StreamingClassifier.for_predictor(port, calib_sec=20, input_fs=700)
    jsc = jstream.StreamingClassifier.for_predictor(jax_p, calib_sec=20, input_fs=700)
    assert sc.feed_channels == jsc.feed_channels and sc.class_names == jsc.class_names
    feed = native_feed(sc.feed_channels, 70, seed=3)
    rng = np.random.default_rng(4)
    got, want, i = [], [], 0
    while i < len(feed):
        n = int(rng.uniform(0.3, 9) * 700)
        got += sc.push(feed[i : i + n])
        want += jsc.push(feed[i : i + n])
        i += n
    got += sc.flush()
    want += jsc.flush()
    assert len(got) == 16            # 8 s windows at 4 s in 70 s less the 0.625 s delay
    np.testing.assert_array_equal(sc.stats[0], jsc.stats[0])
    np.testing.assert_array_equal(sc.stats[1], jsc.stats[1])
    if kind == "hybrid":
        np.testing.assert_allclose(sc.feat_stats[0], jsc.feat_stats[0], rtol=1e-12)
    assert_events_match(got, want)
    if kind == "hierarchical":   # the gate's label, whatever the product's argmax
        x = np.stack([e.probs for e in got])
        assert x.shape[1] == 3 and all(e.label in sc.class_names for e in got)


def test_hybrid_stream_guards_its_calibration(runs):
    port, _ = predictors(runs, "hybrid")
    with pytest.raises(ValueError, match="calib_sec >= window_sec"):
        StreamingClassifier.for_predictor(port, calib_sec=11)
    sc = StreamingClassifier.for_predictor(port, calib_sec=12)
    assert sc.feed_channels == ["chest_ECG", "chest_EDA", "chest_Resp", "chest_EMG"]
    assert sc.feature_names == port.feature_names


# -- the stream's own semantics (the JAX package's tests/test_streaming.py) ------

FS, WIN_S, STRIDE_S = 128, 60, 10
CHANNELS = ("chest_ECG", "chest_EDA")


@pytest.fixture(scope="module")
def tiny():
    """A one-layer H=4 model at the real 60 s / 128 Hz geometry."""
    cfg = ExperimentConfig(channels_to_use=CHANNELS,
                           model=ModelConfig(cnn_out_channels=4, gru_hidden_size=4,
                                             gru_num_layers=1))
    return Predictor(cfg, random_variables(cfg.model, 2, 2, seed=3), device="cpu")


def _feed(total_sec=400, seed=0):
    rng = np.random.default_rng(seed)
    n = total_sec * FS
    eda = 2.0 + 0.5 * np.sin(np.arange(n) / FS) + 0.1 * rng.standard_normal(n)
    return np.stack([rng.standard_normal(n), eda], axis=1).astype(np.float32)


def _batch_probs(predictor, sig, calib_sec):
    mean, std = channel_norm_stats(sig[: calib_sec * FS], list(CHANNELS))
    n_win = (len(sig) - WIN_S * FS) // (STRIDE_S * FS) + 1
    wins = np.stack([sig[k * STRIDE_S * FS : k * STRIDE_S * FS + WIN_S * FS]
                     for k in range(n_win)])
    x = np.ascontiguousarray(apply_channel_norm(wins, list(CHANNELS), mean, std)
                             .transpose(0, 2, 1))
    return predictor.predict_windows(x)


def test_stream_matches_batch_with_same_stats(tiny):
    feed = _feed()
    sc = StreamingClassifier.for_predictor(tiny, calib_sec=120)
    events, rng, i = [], np.random.default_rng(2), 0
    while i < len(feed):  # ragged chunks: 0.4 s .. 37 s
        n = int(rng.uniform(0.4, 37) * FS)
        events += sc.push(feed[i : i + n])
        i += n
    events += sc.flush()
    want = _batch_probs(tiny, feed, 120)
    assert [e.index for e in events] == list(range(len(want)))
    np.testing.assert_allclose(np.stack([e.probs for e in events]), want, rtol=0, atol=1e-5)
    assert (events[0].t_start_sec, events[0].t_end_sec, events[1].t_start_sec) == (0.0, 60.0,
                                                                                   10.0)
    assert all(e.label in sc.class_names for e in events)


def test_chunking_invariance(tiny):
    feed = _feed(total_sec=200, seed=3)
    one = StreamingClassifier.for_predictor(tiny, calib_sec=60)
    ev_one = one.push(feed) + one.flush()
    dribble = StreamingClassifier.for_predictor(tiny, calib_sec=60)
    ev_dots = []
    for i in range(0, len(feed), 1111):
        ev_dots += dribble.push(feed[i : i + 1111])
    ev_dots += dribble.flush()
    assert len(ev_one) == len(ev_dots) > 0
    np.testing.assert_array_equal(np.stack([e.probs for e in ev_one]),
                                  np.stack([e.probs for e in ev_dots]))


def test_no_events_before_calibration_and_input_validation(tiny):
    sc = StreamingClassifier.for_predictor(tiny, calib_sec=90)
    assert sc.push(_feed(total_sec=89, seed=4)) == [] and sc.stats is None
    assert sc.flush() == []
    with pytest.raises(ValueError, match="channels"):
        sc.push(np.zeros((5, 3), np.float32))
    with pytest.raises(ValueError, match="NaN"):
        sc.push(np.full((5, 2), np.nan, np.float32))
    with pytest.raises(ValueError, match="calib_sec"):
        StreamingClassifier.for_predictor(tiny, calib_sec=0)


def test_buffer_stays_bounded(tiny):
    sc = StreamingClassifier.for_predictor(tiny, calib_sec=60)
    rng = np.random.default_rng(5)
    chunk_n, events = 5 * FS, []
    for _ in range(80):  # 400 s of feed
        events += sc.push(rng.standard_normal((chunk_n, 2)).astype(np.float32))
        assert (0 if sc._buf is None else len(sc._buf)) <= sc.window_samples + 2 * chunk_n
    assert [e.index for e in events] == list(range(len(events)))
    assert len(events) == (80 * chunk_n - sc.window_samples) // sc.stride_samples + 1


def test_native_rate_stream_matches_batch_pipeline(tiny):
    """A 700 Hz feed through the causal front end classifies window for
    window like the batch pipeline (FFT resample, the same frozen stats)."""
    feed = _feed_native(260, seed=13)
    sc = StreamingClassifier.for_predictor(tiny, calib_sec=60, input_fs=700)
    events, rng, i = [], np.random.default_rng(14), 0
    while i < len(feed):
        n = int(rng.uniform(0.3, 11) * 700)
        events += sc.push(feed[i : i + n])
        i += n
    events += sc.flush()
    batch = _batch_probs(tiny, resample_signal(feed.astype(np.float64), 700, FS)
                         .astype(np.float32), 60)
    assert len(batch) - 1 <= len(events) <= len(batch)
    got = np.stack([e.probs for e in events])
    np.testing.assert_allclose(got, batch[: len(got)], rtol=0, atol=0.02)
    assert (got.argmax(1) == batch[: len(got)].argmax(1)).all()


# -- the mms-stream CLI against JAX's --------------------------------------------

@pytest.fixture(scope="module")
def recording(tmp_path_factory):
    pkl = tmp_path_factory.mktemp("stream_rec") / "S99.pkl"
    _write_recording(pkl, seconds=75)
    return pkl


def _run_cli(main, argv, out, capsys):
    main(argv + ["--out", str(out)])
    err = capsys.readouterr().err
    return [json.loads(line) for line in out.read_text().splitlines()], err


def _assert_cli_lines(got, want):
    assert [(g["index"], g["t_start_sec"], g["t_end_sec"]) for g in got] == [
        (w["index"], w["t_start_sec"], w["t_end_sec"]) for w in want]
    gp, wp = np.array([g["probs"] for g in got]), np.array([w["probs"] for w in want])
    np.testing.assert_allclose(gp, wp, rtol=0, atol=1e-5 + 1e-6)   # 6-decimal JSON
    top2 = np.sort(wp, axis=1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > 1e-5
    assert [g["label"] for g, c in zip(got, clear) if c] == [w["label"] for w, c in
                                                             zip(want, clear) if c]


@pytest.mark.parametrize("mode", ["native", "resampled", "stdin", "run_dir", "hier_fold"])
def test_stream_cli_matches_jax(runs, recording, mode, tmp_path, capsys, monkeypatch):
    run = runs["hier" if mode == "hier_fold" else "raw"]
    if mode in ("native", "resampled", "stdin"):
        source = ["--checkpoint", str(run / "fold_test_on_S2" / "best_model.msgpack"),
                  "--config", str(run / "config.json")]
    else:
        source = ["--run-dir", str(run)] + (["--fold", "S2"] if mode == "hier_fold" else [])
    if mode == "stdin":
        rows = native_feed(("chest_ECG", "chest_EDA", "chest_Resp"), 40, seed=8, fs=16)
        text = "# one sample a line\n" + "\n".join(",".join(f"{v:.6f}" for v in r) for r in rows)
        feed = ["--stdin"]
    else:
        feed = ["--pkl", str(recording), "--feed", "resampled" if mode == "resampled" else "native"]
    argv = source + feed + ["--calib-sec", "20", "--chunk-sec", "3"]
    results = []
    for main, extra in ((pstream.main, ["--device", "cpu"]), (jstream.main, [])):
        if mode == "stdin":
            monkeypatch.setattr(sys, "stdin", io.StringIO(text))
        results.append(_run_cli(main, argv + extra, tmp_path / f"{len(results)}.jsonl", capsys))
    (got, got_err), (want, want_err) = results
    assert len(got) == (9 if mode == "stdin" else 17)     # 40 s at 16 Hz, or 75 s
    _assert_cli_lines(got, want)
    for err in (got_err, want_err):
        assert re.search(r"^feed channels \(in order\): \[.*\]$", err, re.M)
        assert re.search(rf"^{len(got)} events in \S+s", err, re.M)
    assert got_err.splitlines()[0] == want_err.splitlines()[0]


def test_stream_cli_refuses_what_jax_refuses(runs, recording, tmp_path, capsys):
    base = ["--run-dir", str(runs["hier"]), "--pkl", str(recording), "--device", "cpu"]
    for argv, match in ((base, "hierarchical runs need --fold"),
                        (base[:2] + ["--device", "cpu"], "exactly one feed source"),
                        (base + ["--artifact", "x.mms"], "mutually exclusive")):
        with pytest.raises(SystemExit):
            pstream.main(argv)
        assert match in capsys.readouterr().err
    wrist_cfg = ExperimentConfig(channels_to_use=("chest_ECG", "wrist_BVP"),
                                 model=ModelConfig(**SMALL))
    wrist = write_run(tmp_path / "wrist", wrist_cfg, folds=("S2",))
    with pytest.raises(SystemExit, match="native feed is chest-only"):
        pstream.main(["--run-dir", str(wrist), "--pkl", str(recording), "--device", "cpu"])
