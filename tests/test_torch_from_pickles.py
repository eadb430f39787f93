"""The port's pickle-staged corpus (multimodalsignal_tpu_torch/data/dataset.py
from_pickles_meta, pack_corpus_from_pickles; main --from-pickles) against
the JAX package's and against its own two-step pipeline, on the CPU.

The comparisons are bitwise: the port preprocesses each subject with the
same float32 windows the preprocess CLI writes and packs them with the
NumPy float64 normalization pack_corpus uses. The JAX package is called with
cache=False (no .pack_cache written) and with its optional C++ engine off:
the engine normalizes float32 windows in another summation order, and its
NumPy path is the behaviour both packages share."""

import json

import numpy as np
import pytest

import multimodalsignal_tpu.native as jnative
from multimodalsignal_tpu import config as jcfg
from multimodalsignal_tpu.data import dataset as jdata
from multimodalsignal_tpu_torch import config as pcfg
from multimodalsignal_tpu_torch import main as pmain
from multimodalsignal_tpu_torch.data import dataset as pdata
from multimodalsignal_tpu_torch.data import preprocess as ppre
from multimodalsignal_tpu_torch.data import synthetic as psyn

from tests.test_torch_fold_sweep import one_torch_thread  # noqa: F401

SUBJECTS = ["S2", "S3", "S4"]
TASKS = (("Base", 2.0), ("TSST", 1.5), ("Medi 1", 1.0), ("Fun", 1.5), ("Medi 2", 1.0))
CHANNELS = ["chest_ECG", "chest_EDA", "chest_Resp"]


@pytest.fixture(autouse=True)
def numpy_engine(monkeypatch):
    monkeypatch.setattr(jnative, "available", lambda: False)


@pytest.fixture(scope="module")
def wesad(tmp_path_factory):
    return psyn.write_synthetic_wesad(tmp_path_factory.mktemp("wesad"), SUBJECTS,
                                      tasks=TASKS, seed=7)


@pytest.fixture(scope="module")
def preprocessed(wesad, tmp_path_factory):
    out = tmp_path_factory.mktemp("data")
    ppre.main(["--wesad-root", str(wesad), "--output", str(out), "--targets", "raw",
               "--include-wrist", "--subjects", *SUBJECTS])
    return out / "chest_raw"


def _assert_same(got, want):
    assert got.subjects == want.subjects
    for name in ("x", "y", "mask"):
        a, b = getattr(got, name), np.asarray(getattr(want, name))
        assert a.dtype == b.dtype and np.array_equal(a, b), name


@pytest.mark.parametrize("channels", [CHANNELS, ["chest_ECG"], ["chest_EDA", "wrist_BVP"]])
@pytest.mark.parametrize("mode,normalization", [("stress_binary", "all"),
                                                ("ternary", "baseline"),
                                                ("amusement_binary", "all")])
def test_pack_corpus_from_pickles_matches_jax_and_two_step(channels, mode, normalization,
                                                          wesad, preprocessed):
    """(d) The pickle-staged corpus equals JAX's (cache=False) and the
    port's own preprocess-then-pack_corpus, bit for bit; the channel names
    and the preprocess meta are the CLI's (wrist channels where asked for)."""
    subjects = SUBJECTS + ["S9"]            # S9 has no pickle: skipped
    got, names, meta = pdata.pack_corpus_from_pickles(wesad, subjects, channels, mode,
                                                      normalization)
    want, jnames, jmeta = jdata.pack_corpus_from_pickles(wesad, subjects, channels, mode,
                                                         normalization, cache=False)
    _assert_same(got, want)
    assert (names, meta) == (jnames, jmeta)
    wrist = any(c.startswith("wrist_") for c in channels)
    assert meta == {"original_fs": 700, "fs": 128, "window_sec": 60, "stride_sec": 10,
                    "include_wrist": wrist}
    assert names == list(pcfg.ALL_CHANNEL_NAMES) + (list(pcfg.WRIST_CHANNEL_NAMES) * wrist)
    assert pdata.from_pickles_meta(channels) == jdata.from_pickles_meta(channels)
    all_names = pdata.read_channel_names(preprocessed)
    two_step = pdata.pack_corpus(preprocessed, subjects, channels, all_names, mode,
                                 normalization)
    _assert_same(got, two_step)
    assert got.x.shape[1:] == (got.mask.sum(1).max(), len(channels), 7680)
    assert not (preprocessed.parent.parent / ".pack_cache").exists()
    assert not (wesad / ".pack_cache").exists()


def test_subject_cache_preprocesses_each_subject_once(wesad, monkeypatch):
    """Two corpora from one subject_cache: every subject preprocessed once,
    both packs equal to fresh ones."""
    calls = []
    real = ppre.preprocess_subject
    monkeypatch.setattr(ppre, "preprocess_subject",
                        lambda sid, cfg: (calls.append(sid), real(sid, cfg))[1])
    memo = {}
    first, _, _ = pdata.pack_corpus_from_pickles(wesad, SUBJECTS[:2], CHANNELS,
                                                 subject_cache=memo)
    second, _, _ = pdata.pack_corpus_from_pickles(wesad, SUBJECTS[:2], ["chest_ECG"],
                                                  "ternary", subject_cache=memo)
    assert sorted(calls) == SUBJECTS[:2] and len(memo) == 2
    monkeypatch.setattr(ppre, "preprocess_subject", real)
    _assert_same(first, pdata.pack_corpus_from_pickles(wesad, SUBJECTS[:2], CHANNELS)[0])
    _assert_same(second, pdata.pack_corpus_from_pickles(wesad, SUBJECTS[:2], ["chest_ECG"],
                                                        "ternary")[0])


def test_unknown_channels_and_no_pickles_are_refused(wesad, tmp_path):
    with pytest.raises(ValueError, match="Unknown channels"):
        pdata.pack_corpus_from_pickles(wesad, SUBJECTS, ["chest_ECG", "chest_FOO"])
    with pytest.raises(ValueError, match="No pickles loaded"):
        pdata.pack_corpus_from_pickles(tmp_path, ["S2"], CHANNELS)


def test_validation_of_from_pickles_configs():
    """from_pickles is for the sharded sweep and not for the hybrid model,
    in both packages."""
    for cfgmod in (pcfg, jcfg):
        cfg = cfgmod.ExperimentConfig(from_pickles="/some/WESAD", fold_execution="serial")
        with pytest.raises(ValueError, match="sharded"):
            cfgmod.validate_experiment(cfg)
        cfgmod.validate_experiment(cfg, fold_execution="sharded")
        hybrid = cfgmod.ExperimentConfig(
            from_pickles="/some/WESAD", model=cfgmod.ModelConfig(name="hybrid_cnn_gru"),
            raw_align_path="x", feature_path="y")
        with pytest.raises(ValueError, match="hybrid"):
            cfgmod.validate_experiment(hybrid)


def test_main_from_pickles_runs_the_sweep(wesad, tmp_path, capsys):
    """(k) main --device cpu --from-pickles at tiny width (H = 8, conv 8):
    the sweep's run directory with no npy files anywhere, config.json
    carrying from_pickles and the pickles' preprocess meta, and the serial
    execution refused."""
    argv = ["--device", "cpu", "--from-pickles", str(wesad),
            "--set", "subjects=" + ",".join(SUBJECTS), "--set", "model.gru_hidden_size=8",
            "--set", "model.cnn_out_channels=8", "--set", "model.gru_num_layers=1",
            "--set", "trainer.epochs=1", "--set", "trainer.batch_size=16"]
    pmain.main(argv + ["--output-dir", str(tmp_path / "out")])
    (run_dir,) = (tmp_path / "out" / "simple_binary").iterdir()
    assert "Sharded LOSO sweep: 3 folds" in capsys.readouterr().out
    saved = json.loads((run_dir / "config.json").read_text())
    assert saved["from_pickles"] == str(wesad)
    assert saved["preprocess_meta"] == pdata.from_pickles_meta(CHANNELS)[1]
    summary = (run_dir / "cv_summary.txt").read_text()
    assert summary.count("  - test S") == 3 and "Mean weighted F1" in summary
    assert not list(tmp_path.rglob("*.npy")) or all(
        p.name == "test_probs.npy" for p in tmp_path.rglob("*.npy"))
    with pytest.raises(SystemExit, match="--execution sharded"):
        pmain.main(argv + ["--execution", "serial", "--output-dir", str(tmp_path / "serial")])
    assert not (tmp_path / "serial").exists()
