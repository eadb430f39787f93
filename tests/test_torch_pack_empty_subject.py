"""A subject with no windows, on the CPU: the port's three packers
(pack_corpus, pack_corpus_from_pickles and the hybrid packer,
build_hybrid_dataset) give what the JAX package's give for it, an empty
pack beside the other subject's windows (masks [5, 0] where the packer
pads), with the host window engine on where it built. The engine's fused
pack needs statistics rows, so such a subject takes the NumPy path; the
engine itself keeps refusing an empty selection.

Values within 2e-5 (the engine normalizes float32 windows in another
summation order than the NumPy path; tests/test_torch_native.py); labels
and masks equal."""

import numpy as np
import pytest

from multimodalsignal_tpu.data import dataset as jdata
from multimodalsignal_tpu_torch import native as pnative
from multimodalsignal_tpu_torch.config import ALL_CHANNEL_NAMES
from multimodalsignal_tpu_torch.data import dataset as pdata
from multimodalsignal_tpu_torch.data import synthetic as psyn

CHANNELS = ["chest_ECG", "chest_EDA", "chest_Resp"]
WINDOWS = {"S2": 5, "S3": 0}
T = 64
ATOL = 2e-5


def _write_npy(root, seed):
    """S2 with 5 windows (labels 1-4), S3 with none, [N, T, 8] float32."""
    rng = np.random.default_rng(seed)
    root.mkdir(parents=True, exist_ok=True)
    (root / "_channel_names.txt").write_text("\n".join(ALL_CHANNEL_NAMES) + "\n")
    for sid, n in WINDOWS.items():
        x = rng.standard_normal((n, T, len(ALL_CHANNEL_NAMES))).astype(np.float32)
        x[..., ALL_CHANNEL_NAMES.index("chest_EDA")] = np.abs(x[..., 1]) + 0.5
        np.save(root / f"{sid}_X.npy", x)
        np.save(root / f"{sid}_y.npy", (np.arange(n) % 4 + 1).astype(np.int64))
    return root


def _write_features(root, seed):
    rng = np.random.default_rng(seed)
    root.mkdir(parents=True, exist_ok=True)
    (root / "_feature_names.txt").write_text("\n".join(f"f{i}" for i in range(6)) + "\n")
    for sid, n in WINDOWS.items():
        np.save(root / f"{sid}_X.npy", rng.standard_normal((n, 6)).astype(np.float32))
        np.save(root / f"{sid}_y.npy", (np.arange(n) % 4 + 1).astype(np.int64))
    return root


def _close(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL, err_msg=what)


def _same_corpus(got, want):
    assert got.subjects == tuple(want.subjects)
    _close(got.x, want.x, "x")
    assert np.array_equal(got.y, np.asarray(want.y)) and np.array_equal(
        got.mask, np.asarray(want.mask))
    assert got.mask.sum(axis=1).tolist() == [5, 0]


def test_engine_still_refuses_an_empty_selection():
    if not pnative.available():
        pytest.skip("the host window engine did not build here")
    x = np.zeros((0, T, 8), np.float32)
    with pytest.raises(ValueError, match="at least one window"):
        pnative.pack_subject_f32(x, np.arange(3), np.zeros(3, np.uint8),
                                 np.zeros(0, bool), np.zeros(0, bool))


@pytest.mark.parametrize("normalization", ["all", "baseline"])
@pytest.mark.parametrize("packer", ["pack_corpus", "pack_corpus_from_pickles", "hybrid"])
def test_zero_window_subject_packs_as_jax(packer, normalization, tmp_path):
    """Two subjects, 5 windows and 0: the port's packer returns the JAX
    package's windows, labels and masks."""
    mode = "ternary"
    if packer == "pack_corpus":
        data = _write_npy(tmp_path / "npy", seed=1)
        args = (data, list(WINDOWS), CHANNELS, ALL_CHANNEL_NAMES, mode, normalization)
        _same_corpus(pdata.pack_corpus(*args, cache=False),
                     jdata.pack_corpus(*args, cache=False))
    elif packer == "pack_corpus_from_pickles":
        wesad = tmp_path / "wesad"
        psyn.write_synthetic_wesad(wesad, ["S2"], tasks=(("Base", 1.5), ("TSST", 1.5)),
                                   seed=3)
        psyn.write_synthetic_wesad(wesad, ["S3"], tasks=(("Base", 0.25),), seed=4)
        args = (wesad, list(WINDOWS), CHANNELS, mode, normalization)
        got, names, meta = pdata.pack_corpus_from_pickles(*args, cache=False)
        want, jnames, jmeta = jdata.pack_corpus_from_pickles(*args, cache=False)
        assert got.mask.sum(axis=1)[1] == 0 and got.mask.sum(axis=1)[0] > 0
        assert got.subjects == tuple(want.subjects) and (names, meta) == (jnames, jmeta)
        _close(got.x, want.x, "x")
        assert np.array_equal(got.y, np.asarray(want.y))
        assert np.array_equal(got.mask, np.asarray(want.mask))
    else:
        raw = _write_npy(tmp_path / "raw_align", seed=2)
        feat = _write_features(tmp_path / "feature", seed=5)
        args = (raw, feat, list(WINDOWS), CHANNELS, ALL_CHANNEL_NAMES, None, mode,
                normalization)
        got = pdata.build_hybrid_dataset(*args)
        want = jdata.build_hybrid_dataset(*args)
        assert got.x_raw.shape[0] == WINDOWS["S2"]
        _close(got.x_raw, want.x_raw, "x_raw")
        _close(got.x_feat, want.x_feat, "x_feat")
        assert np.array_equal(got.y, np.asarray(want.y))
