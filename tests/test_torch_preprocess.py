"""The port's data front end (multimodalsignal_tpu_torch/data: synthetic.py,
protocol.py, features.py, preprocess.py, config.PreprocessConfig) against
the JAX package's, on the CPU.

Everything here is host NumPy/SciPy in float64 with the same operations in
the same order, so the comparisons are exact: the synthetic pickles and
quest CSVs byte for byte, the features bitwise (NaN where both are NaN), and
every file the two preprocess CLIs write byte for byte. The synthetic trees
are small (2-3 subjects, tasks of 1-2 minutes)."""

import dataclasses

import numpy as np
import pytest

from multimodalsignal_tpu import config as jcfg
from multimodalsignal_tpu.data import features as jfeat
from multimodalsignal_tpu.data import preprocess as jpre
from multimodalsignal_tpu.data import protocol as jproto
from multimodalsignal_tpu.data import synthetic as jsyn
from multimodalsignal_tpu_torch import config as pcfg
from multimodalsignal_tpu_torch.data import features as pfeat
from multimodalsignal_tpu_torch.data import preprocess as ppre
from multimodalsignal_tpu_torch.data import protocol as pproto
from multimodalsignal_tpu_torch.data import synthetic as psyn

SUBJECTS = ["S2", "S3", "S4"]
TASKS = (("Base", 2.0), ("TSST", 1.5), ("Medi 1", 1.0), ("Fun", 1.5), ("Medi 2", 1.0))
HARD = jsyn.Hardness(fun_laughter_rate_per_min=6.0, channel_dropout_prob=0.5)


def _tree_files(root):
    return sorted(p.relative_to(root) for p in root.rglob("*") if p.is_file())


def _assert_same_trees(a, b):
    files = _tree_files(a)
    assert files == _tree_files(b)
    for rel in files:
        assert (a / rel).read_bytes() == (b / rel).read_bytes(), str(rel)
    return files


@pytest.fixture(scope="module")
def wesad(tmp_path_factory):
    """One synthetic tree, written by the port's generator."""
    return psyn.write_synthetic_wesad(tmp_path_factory.mktemp("wesad"), SUBJECTS,
                                      tasks=TASKS, seed=3)


def test_constants_match_jax():
    assert pcfg.WRIST_SENSORS == jcfg.WRIST_SENSORS
    assert pcfg.WRIST_CHANNEL_NAMES == jcfg.WRIST_CHANNEL_NAMES
    assert pcfg.TASK_TO_LABEL_MAP == jcfg.TASK_TO_LABEL_MAP
    assert pcfg.CHEST_SENSORS == jcfg.CHEST_SENSORS
    got, want = pcfg.PreprocessConfig(), jcfg.PreprocessConfig()
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (got.raw_window_samples, got.raw_stride_samples) == (
        want.raw_window_samples, want.raw_stride_samples) == (7680, 1280)
    assert psyn.DEFAULT_TASKS == jsyn.DEFAULT_TASKS
    assert psyn.BENCHMARK_TASKS == jsyn.BENCHMARK_TASKS
    assert dataclasses.asdict(psyn.BENCHMARK_HARDNESS) == dataclasses.asdict(
        jsyn.BENCHMARK_HARDNESS)


@pytest.mark.parametrize("generator", ["easy", "easy_noisy", "hard", "hard_default"])
def test_synthetic_wesad_is_byte_identical(generator, tmp_path):
    """(a) Both packages' write_synthetic_wesad from one seed: the same
    .pkl and _quest.csv bytes, with the easy and the hard generator."""
    kwargs = {"easy": {}, "easy_noisy": dict(subject_variability=2.5, noise=4.0),
              "hard": dict(hardness=HARD),
              "hard_default": dict(hardness=jsyn.Hardness())}[generator]
    pkw = dict(kwargs)
    if "hardness" in pkw:  # the port's own Hardness, the same knobs
        pkw["hardness"] = psyn.Hardness(**dataclasses.asdict(pkw["hardness"]))
    tasks = TASKS[:3] if generator.startswith("hard") else TASKS
    psyn.write_synthetic_wesad(tmp_path / "p", SUBJECTS[:2], tasks=tasks, seed=11, **pkw)
    jsyn.write_synthetic_wesad(tmp_path / "j", SUBJECTS[:2], tasks=tasks, seed=11, **kwargs)
    files = _assert_same_trees(tmp_path / "p", tmp_path / "j")
    assert len(files) == 4
    for sid in SUBJECTS[:2]:
        got = pproto.parse_quest_csv(sid, tmp_path / "p")
        want = jproto.parse_quest_csv(sid, tmp_path / "j")
        assert [(r.task, r.start_min, r.end_min) for r in got] == [
            (r.task, r.start_min, r.end_min) for r in want]
    # S2's Base window starts at its midpoint (reference preprocess.py:53-57)
    assert got[0].start_min == (tasks[0][1] / 2 if sid == "S2" else 0.0)


def test_synthesize_subject_with_an_explicit_seed():
    got, got_csv = psyn.synthesize_subject("S7", tasks=TASKS[:2], seed=5)
    want, want_csv = jsyn.synthesize_subject("S7", tasks=TASKS[:2], seed=5)
    assert got_csv == want_csv
    for dev in (b"chest", b"wrist"):
        for key, value in want[b"signal"][dev].items():
            np.testing.assert_array_equal(got[b"signal"][dev][key], value)


def test_parse_quest_csv_padding_and_errors(tmp_path):
    """Trailing empty and NaN cells are dropped; missing rows and ragged
    rows raise in both packages."""
    (tmp_path / "S9").mkdir()
    (tmp_path / "S9" / "S9_quest.csv").write_text(
        "# Subj;S9;;\n# ORDER;Base;TSST;;nan\n# START;1.5;20.25;;\n# END;11.5;30;;\n")
    got = pproto.parse_quest_csv("S9", tmp_path)
    assert got == [pproto.ProtocolRow("Base", 1.5, 11.5), pproto.ProtocolRow("TSST", 20.25, 30.0)]
    assert [tuple(dataclasses.astuple(r)) for r in got] == [
        tuple(dataclasses.astuple(r)) for r in jproto.parse_quest_csv("S9", tmp_path)]
    (tmp_path / "S9" / "S9_quest.csv").write_text("# ORDER;Base;TSST\n# START;1\n# END;2;3\n")
    for mod in (pproto, jproto):
        with pytest.raises(ValueError, match="mismatch"):
            mod.parse_quest_csv("S9", tmp_path)
    (tmp_path / "S9" / "S9_quest.csv").write_text("# ORDER;Base\n")
    for mod in (pproto, jproto):
        with pytest.raises(ValueError, match="missing"):
            mod.parse_quest_csv("S9", tmp_path)


def _feature_windows(rng, n, t, fs):
    """Per-channel windows [n, t] of synthetic ECG, EDA, EMG and Resp; one
    flat ECG and one flat Resp window make their groups fail to NaN."""
    tt = np.arange(t) / fs
    hr = rng.uniform(0.9, 1.8, (n, 1))
    phase = (tt * hr + rng.uniform(0, 1, (n, 1))) % 1.0
    ecg = np.exp(-((phase - 0.5) ** 2) / 0.006) + 0.02 * rng.standard_normal((n, t))
    ecg[0] = 0.0
    eda = 2.0 + 0.01 * tt + 0.3 * np.sin(2 * np.pi * 0.05 * tt) + 0.01 * rng.standard_normal((n, t))
    resp = np.sin(2 * np.pi * rng.uniform(0.2, 0.4, (n, 1)) * tt)
    resp[1] = 0.0
    emg = 0.05 * rng.standard_normal((n, t))
    return {"chest_ECG": ecg, "chest_EDA": eda, "chest_EMG": emg, "chest_Resp": resp}


@pytest.mark.parametrize("fs,seconds", [(128, 60), (64, 30), (16, 8)])
def test_extract_features_batch_is_bitwise_equal(fs, seconds):
    """(b) The feature matrix, bitwise (NaN where JAX's is NaN), and the
    per-window extractor."""
    rng = np.random.default_rng(fs)
    windows = _feature_windows(rng, 6, fs * seconds, fs)
    got = pfeat.extract_features_batch(windows, fs)
    want = jfeat.extract_features_batch(windows, fs)
    assert got.shape == want.shape == (6, 10) and got.dtype == np.float64
    assert np.array_equal(got, want, equal_nan=True)
    one = {k: v[2] for k, v in windows.items()}
    got1 = pfeat.extract_handcrafted_features(one, fs)
    want1 = jfeat.extract_handcrafted_features(one, fs)
    assert list(got1) == list(want1) == list(pfeat.FEATURE_NAMES)
    assert np.array_equal(list(got1.values()), list(want1.values()), equal_nan=True)
    if fs == 128:  # the flat ECG and the flat Resp window fail to NaN
        assert np.isnan(got[0, :5]).all() and np.isnan(got[1, 7:9]).all()
        assert np.isfinite(got[2:]).all()


def test_feature_names_and_version_match_jax():
    assert pfeat.FEATURE_NAMES == jfeat.FEATURE_NAMES and len(pfeat.FEATURE_NAMES) == 10
    assert pfeat.FEATURE_EXTRACTOR_VERSION == jfeat.FEATURE_EXTRACTOR_VERSION == 2
    assert pfeat.FEATURE_SENSOR_CHANNELS == jfeat.FEATURE_SENSOR_CHANNELS
    assert pfeat.PCHIP_POWER_RECOVERY == jfeat.PCHIP_POWER_RECOVERY
    x = np.sin(np.arange(120) / 3.0) + 0.1 * np.random.default_rng(1).standard_normal(120)
    assert np.isfinite(pfeat.sample_entropy(x))
    assert pfeat.sample_entropy(x) == jfeat.sample_entropy(x)
    assert pfeat.extract_features_batch({"chest_ECG": np.zeros((0, 128))}, 128).shape == (0, 10)


@pytest.mark.parametrize("argv", [[], ["--include-wrist"], ["--targets", "raw"],
                                  ["--targets", "feature", "raw-align"]])
def test_preprocess_clis_write_identical_files(argv, wesad, tmp_path, capsys):
    """(c) Both preprocess CLIs on the same tree write the same files, byte
    for byte: every npy, name file and meta file (S9 has no pickle and is
    skipped by both)."""
    subjects = ["--subjects", *SUBJECTS, "S9"]
    ppre.main(["--wesad-root", str(wesad), "--output", str(tmp_path / "p"), *subjects, *argv])
    port_out = capsys.readouterr().out
    jpre.main(["--wesad-root", str(wesad), "--output", str(tmp_path / "j"), *subjects, *argv])
    assert port_out == capsys.readouterr().out
    files = _assert_same_trees(tmp_path / "p", tmp_path / "j")
    targets = {str(f).split("/")[0] for f in files}
    if "--targets" not in argv:
        assert targets == {"chest_raw", "chest_raw_align", "chest_feature"}
        x = np.load(tmp_path / "p" / "chest_raw" / "S3_X.npy")
        assert x.dtype == np.float32 and x.shape[1:] == (7680, 14 if argv else 8)
        xf = np.load(tmp_path / "p" / "chest_feature" / "S3_X.npy")
        xa = np.load(tmp_path / "p" / "chest_raw_align" / "S3_X.npy")
        assert xf.shape == (len(xa), 10) and np.isfinite(xf).all()
    elif argv[1] == "feature":   # raw-align listed after feature still aligns
        assert targets == {"chest_raw_align", "chest_feature"}


def test_preprocess_subject_matches_jax_at_other_rates(wesad):
    """preprocess_subject with a PreprocessConfig at other rates (raw 32 Hz,
    features 64 Hz, 20 s windows at a 5 s stride, wrist channels): each
    target's arrays equal JAX's."""
    fields = dict(wesad_root=str(wesad), raw_fs=32, raw_window_sec=20, raw_stride_sec=5,
                  feature_fs=64, feature_window_sec=20, feature_stride_sec=5,
                  include_wrist=True)
    got = ppre.preprocess_subject("S4", pcfg.PreprocessConfig(**fields))
    want = jpre.preprocess_subject("S4", jcfg.PreprocessConfig(**fields))
    assert set(got) == set(want) == {"raw", "raw-align", "feature"}
    for target in got:
        for a, b in zip(got[target], want[target]):
            assert a.dtype == b.dtype and np.array_equal(a, b, equal_nan=True), target
    assert got["raw"][0].shape[1:] == (640, 14)
    assert ppre.preprocess_subject("S9", pcfg.PreprocessConfig(**fields)) is None
