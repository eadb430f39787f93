"""The port's host analysis tools (multimodalsignal_tpu_torch/analysis/
preprocess_check.py, feature_importance.py, feature_distributions.py)
against the JAX package's on the same preprocessed files (the `preprocessed`
fixture of tests/test_preprocess.py: 4 synthetic subjects through the JAX
preprocessing CLI), on the CPU.

Everything must agree exactly: the checker's verdicts, its messages and its
CLI's exit codes; the feature rankings (the same scikit-learn fit from the
same seed on the same matrix); the distribution tool's data frame, top-5
features and the files it writes. Where scikit-learn, pandas, matplotlib or
seaborn is missing, the function that needs it raises ImportError naming
it."""

import shutil
import sys

import numpy as np
import pytest

from multimodalsignal_tpu.analysis import feature_distributions as jdist
from multimodalsignal_tpu.analysis import feature_importance as jimp
from multimodalsignal_tpu.analysis import preprocess_check as jcheck
from multimodalsignal_tpu_torch.analysis import PreprocessChecker
from multimodalsignal_tpu_torch.analysis import feature_distributions as pdist
from multimodalsignal_tpu_torch.analysis import feature_importance as pimp
from multimodalsignal_tpu_torch.analysis import preprocess_check as pcheck
from tests.conftest import SUBJECTS_SMALL
from tests.test_preprocess import preprocessed  # noqa: F401  (fixture reuse)


@pytest.fixture(scope="module")
def corrupted(preprocessed, tmp_path_factory):  # noqa: F811
    """A copy whose S2 feature labels hold an out-of-protocol label."""
    bad = tmp_path_factory.mktemp("bad") / "data"
    shutil.copytree(preprocessed, bad)
    y_file = bad / "chest_feature" / "S2_y.npy"
    y = np.load(y_file)
    y[0] = 9
    np.save(y_file, y)
    return bad


@pytest.mark.parametrize("subject,mode,data", [
    ("S2", "stress_binary", "good"), ("S3", "ternary", "good"),
    ("S4", "amusement_binary", "good"), ("S99", "stress_binary", "good"),
    ("S2", "ternary", "corrupted")])
def test_preprocess_checker_matches_jax(subject, mode, data, preprocessed, corrupted):  # noqa: F811
    root = preprocessed if data == "good" else corrupted
    got = PreprocessChecker(root, subject, mode)
    want = jcheck.PreprocessChecker(root, subject, mode)
    results = got.run_all_checks()
    assert results == want.run_all_checks()
    assert got.messages == want.messages
    assert results["ok"] == (data == "good" and subject != "S99")


@pytest.mark.parametrize("subject,code", [("S2", 0), ("S99", 1)])
def test_preprocess_check_cli_exit_codes(subject, code, preprocessed):  # noqa: F811
    for main in (pcheck.main, jcheck.main):
        with pytest.raises(SystemExit) as exc:
            main(["--data", str(preprocessed), "--subject", subject])
        assert exc.value.code == code


def test_feature_importance_matches_jax(preprocessed, tmp_path):  # noqa: F811
    features = preprocessed / "chest_feature"
    got_corpus = pimp.load_feature_corpus(features, SUBJECTS_SMALL)
    want_corpus = jimp.load_feature_corpus(features, SUBJECTS_SMALL)
    for got, want in zip(got_corpus, want_corpus):
        np.testing.assert_array_equal(got, want)
    got = pimp.analyze_feature_importance(features, tmp_path / "port", tuple(SUBJECTS_SMALL))
    want = jimp.analyze_feature_importance(features, tmp_path / "jax", tuple(SUBJECTS_SMALL))
    assert got == want
    assert len(got["ternary"]) == len(got_corpus[2])
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == sorted(
        p.name for p in (tmp_path / "jax").iterdir()) == [
        "amusement_feature_importance.png", "three_class_feature_importance.png"]


def test_feature_distributions_match_jax(preprocessed, tmp_path):  # noqa: F811
    features = preprocessed / "chest_feature"
    (got_df, got_names), (want_df, want_names) = (
        m.prepare_dataframe(features, SUBJECTS_SMALL) for m in (pdist, jdist))
    assert got_names == want_names and got_df.equals(want_df)
    got = pdist.explore_feature_distributions(features, tmp_path / "port",
                                              tuple(SUBJECTS_SMALL))
    want = jdist.explore_feature_distributions(features, tmp_path / "jax",
                                               tuple(SUBJECTS_SMALL))
    assert got == want and len(got) == 5
    written = [sorted(p.name for p in (tmp_path / n).iterdir()) for n in ("port", "jax")]
    assert written[0] == written[1] == ["feature_distributions_violin.png",
                                        "feature_pairplot.png", "feature_projections.png"]


@pytest.mark.parametrize("blocked,call,named", [
    ("sklearn", lambda f, out: pimp.analyze_feature_importance(f, out, tuple(SUBJECTS_SMALL)),
     "scikit-learn"),
    ("matplotlib", lambda f, out: pimp._plot_ranking([("a", 1.0)], "t", out / "a.png"),
     "matplotlib"),
    ("pandas", lambda f, out: pdist.prepare_dataframe(f, SUBJECTS_SMALL), "pandas"),
    ("seaborn", lambda f, out: pdist.explore_feature_distributions(
        f, out, tuple(SUBJECTS_SMALL)), "seaborn")])
def test_a_missing_package_is_named(blocked, call, named, preprocessed, tmp_path,  # noqa: F811
                                    monkeypatch):
    for name in list(sys.modules):
        if name == blocked or name.startswith(blocked + "."):
            monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, blocked, None)
    monkeypatch.setitem(sys.modules, "xgboost", None)
    with pytest.raises(ImportError, match=f"{named} is missing"):
        call(preprocessed / "chest_feature", tmp_path)
