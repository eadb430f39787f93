"""The port's host window engine (multimodalsignal_tpu_torch/native/, its
own copy of the C++ source) and the data paths routed through it, on the
CPU: the cases of tests/test_native.py against the port's engine (the
gather bitwise the NumPy gather, the bounds check, the statistics and the
z-score, the production normalize_subject path, the fused pack against the
NumPy pipeline, pack_corpus through the engine against its NumPy path, the
log1p floor below -1: all to float32 round-off, rtol and atol 2e-5 as
there), the port's pack_corpus bitwise the JAX package's (both engines: the
same source and flags; the fused pack's statistics are a serial double
sum), the calls each wrapper counts, and the pack cache's version bump."""

import json

import numpy as np
import pytest

from multimodalsignal_tpu import native as jnative
from multimodalsignal_tpu.data import dataset as jdata
from multimodalsignal_tpu.data import windowing as jwin
from multimodalsignal_tpu_torch import native
from multimodalsignal_tpu_torch.data import dataset as pdata
from multimodalsignal_tpu_torch.data import windowing as pwin

NAMES = ["chest_ECG", "chest_EDA", "chest_Resp"]
TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.fixture
def engine():
    """The port's engine, built (skip where this host has no g++), with its
    call counts at 0."""
    if not native.available():
        pytest.skip("g++ unavailable or the engine's build failed")
    native.reset_call_counts()
    return native


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def _write_subjects(root, rng, sids=("S2", "S3", "S4"), w=9, t=48, c_all=5):
    """npy files of float32 windows [w, t, c_all] (squared normals, so
    log1p is defined) and raw labels 1-4 with Base windows first."""
    root.mkdir(parents=True, exist_ok=True)
    for k, sid in enumerate(sids):
        x = (rng.standard_normal((w + k, t, c_all)) ** 2 + k).astype(np.float32)
        y = rng.integers(1, 5, w + k).astype(np.int64)
        y[:2] = 1
        np.save(root / f"{sid}_X.npy", x)
        np.save(root / f"{sid}_y.npy", y)
    return ["chest_ACC_x", *NAMES, "chest_Temp"]


def test_engine_builds_into_its_own_build_dir(engine):
    """The source is the port's own copy, built into native/build/ under a
    name that carries the source's hash."""
    path = engine.library_path()
    assert path.exists() and path.parent == engine.BUILD_DIR
    assert engine.BUILD_DIR.parent == engine.SOURCE.parent
    assert engine.SOURCE.parent.name == "native"
    assert engine.SOURCE.parent.parent.name == "multimodalsignal_tpu_torch"


def test_sliding_windows_matches_numpy(engine, rng):
    signal = rng.standard_normal((5000, 4)).astype(np.float32)
    starts = np.arange(0, 5000 - 640, 177, dtype=np.int64)
    want = pwin.sliding_windows(signal, starts, 640)
    np.testing.assert_array_equal(engine.sliding_windows_f32(signal, starts, 640), want)
    np.testing.assert_array_equal(pwin.sliding_windows_fast(signal, starts, 640), want)
    np.testing.assert_array_equal(jwin.sliding_windows_fast(signal, starts, 640), want)
    assert engine.call_counts()["sliding_windows_f32"] == 2
    # float64 signals and empty starts take the NumPy gather
    pwin.sliding_windows_fast(signal.astype(np.float64), starts, 640)
    assert pwin.sliding_windows_fast(signal, starts[:0], 640).shape == (0, 640, 4)
    assert engine.call_counts()["sliding_windows_f32"] == 2


def test_sliding_windows_bounds_check(engine, rng):
    """Out-of-range starts raise IndexError instead of copying past the
    signal."""
    sig = rng.standard_normal((100, 3)).astype(np.float32)
    with pytest.raises(IndexError):
        engine.sliding_windows_f32(sig, np.asarray([0, 90], np.int64), window=20)
    with pytest.raises(IndexError):
        engine.sliding_windows_f32(sig, np.asarray([-1], np.int64), window=20)
    with pytest.raises(IndexError):
        pwin.sliding_windows_fast(sig, np.asarray([85], np.int64), 20)


def test_channel_stats_and_normalize(engine, rng):
    windows = np.abs((rng.standard_normal((30, 128, 3)) * 3 + 5)).astype(np.float32)
    mask = np.array([0, 1, 0], dtype=np.uint8)
    mean, std = engine.channel_stats_f32(windows, mask)
    x64 = windows.astype(np.float64)
    for c in range(3):
        vals = np.log1p(x64[:, :, c]) if mask[c] else x64[:, :, c]
        assert mean[c] == pytest.approx(vals.mean(), rel=1e-9)
        assert std[c] == pytest.approx(vals.std(), rel=1e-7)
    got = engine.normalize_windows_f32(windows.copy(), mean, std + 1e-8, mask)
    for c in range(3):
        vals = np.log1p(x64[:, :, c]) if mask[c] else x64[:, :, c]
        want = ((vals - mean[c]) / (std[c] + 1e-8)).astype(np.float32)
        np.testing.assert_allclose(got[:, :, c], want, rtol=1e-5, atol=1e-6)
    assert engine.call_counts()["channel_stats_f32"] == 1
    assert engine.call_counts()["normalize_windows_f32"] == 1


def test_matches_dataset_normalize_subject(engine, rng):
    """The engine's statistics and z-score agree with normalize_subject's
    NumPy float64 path ("all", EDA log1p) to float32 round-off."""
    x = np.abs(rng.standard_normal((20, 256, 3)) + 2).astype(np.float32)
    want = pdata.normalize_subject(x, np.ones(20, dtype=np.int64), NAMES, "all",
                                   use_native=False)
    mask = np.array([n == "chest_EDA" for n in NAMES], dtype=np.uint8)
    mean, std = engine.channel_stats_f32(x, mask)
    got = engine.normalize_windows_f32(x.copy(), mean, std + 1e-8, mask)
    np.testing.assert_allclose(got, want, **TOL)


def test_normalize_subject_native_production_path(engine, rng):
    """normalize_subject routes float32 windows through the engine by
    default (use_native=None) and float64 ones through NumPy; both schemes,
    and the all-window fallback of a subject with no Base windows, agree
    with the NumPy oracle to float32 round-off."""
    x = np.abs(rng.standard_normal((24, 128, 3)) + 2).astype(np.float32)
    y_raw = rng.integers(1, 5, 24)
    for y in (y_raw, np.full(24, 2)):
        for scheme in ("all", "baseline"):
            before = engine.call_counts()["channel_stats_f32"]
            got = pdata.normalize_subject(x, y, NAMES, scheme)
            assert engine.call_counts()["channel_stats_f32"] == before + 1
            want = pdata.normalize_subject(x, y, NAMES, scheme, use_native=False)
            np.testing.assert_allclose(got, want, **TOL)
    before = engine.call_counts()
    pdata.normalize_subject(x.astype(np.float64), y_raw, NAMES, "all")
    assert engine.call_counts() == before


def test_pack_subject_fused_matches_pipeline(engine, rng, monkeypatch):
    """The packers' fused pack (select + z-score + transpose in the engine,
    from a memory map as pack_corpus reads it) agrees with the NumPy
    pipeline to float32 round-off, both schemes, a keep-filtering mode."""
    x = (rng.standard_normal((12, 64, 5)) ** 2).astype(np.float32)
    y_raw = rng.integers(1, 5, size=12).astype(np.int64)
    y_raw[:3] = 1
    idx = [1, 2, 3]
    for mode in ("stress_binary", "amusement_binary"):
        for scheme in ("all", "baseline"):
            got_x, got_y = pdata._pack_subject(x, y_raw, idx, NAMES, mode, scheme)
            with monkeypatch.context() as m:
                m.setattr(native, "available", lambda: False)
                want_x, want_y = pdata._pack_subject(x, y_raw, idx, NAMES, mode, scheme)
            np.testing.assert_array_equal(got_y, want_y)
            np.testing.assert_allclose(got_x, want_x, **TOL, err_msg=f"{mode}/{scheme}")
    assert engine.call_counts()["pack_subject_f32"] == 4


def test_pack_corpus_engine_vs_numpy_path(engine, rng, tmp_path, monkeypatch):
    """pack_corpus does not depend on whether the engine's fused pack is
    taken (to float32 round-off); through the engine it packs each subject
    once, from a memory map."""
    names = _write_subjects(tmp_path, rng)
    loaded = []
    real = pdata.load_subject_windows
    monkeypatch.setattr(pdata, "load_subject_windows",
                        lambda path, sid, **kw: (loaded.append(kw), real(path, sid, **kw))[1])
    fused = pdata.pack_corpus(tmp_path, ["S2", "S3", "S4"], NAMES, names, cache=False)
    assert engine.call_counts()["pack_subject_f32"] == 3
    assert loaded == [{"mmap": True}] * 3
    monkeypatch.setattr(native, "available", lambda: False)
    plain = pdata.pack_corpus(tmp_path, ["S2", "S3", "S4"], NAMES, names, cache=False)
    assert fused.subjects == plain.subjects
    np.testing.assert_array_equal(fused.y, plain.y)
    np.testing.assert_array_equal(fused.mask, plain.mask)
    np.testing.assert_allclose(fused.x, plain.x, **TOL)


@pytest.mark.parametrize("mode,normalization", [("stress_binary", "all"),
                                                ("ternary", "baseline"),
                                                ("amusement_binary", "baseline")])
def test_pack_corpus_equals_jax_engine_bitwise(engine, rng, tmp_path, mode, normalization):
    """The port's pack_corpus through its engine equals the JAX package's
    through its own, bit for bit, on the same npy files (cache off)."""
    if not jnative.available():
        pytest.skip("the JAX package's engine did not build")
    names = _write_subjects(tmp_path, rng)
    subjects = ["S2", "S3", "S4", "S9"]   # S9 has no files: skipped by both
    got = pdata.pack_corpus(tmp_path, subjects, NAMES, names, mode, normalization,
                            cache=False)
    want = jdata.pack_corpus(tmp_path, subjects, NAMES, names, mode, normalization,
                             cache=False)
    assert engine.call_counts()["pack_subject_f32"] == 3
    assert got.subjects == tuple(want.subjects)
    for name in ("x", "y", "mask"):
        a, b = getattr(got, name), np.asarray(getattr(want, name))
        assert a.dtype == b.dtype and np.array_equal(a, b), name


def test_log1p_total_below_minus_one(engine, rng):
    """EDA ringing below -1: the floored log1p keeps every path finite, and
    the NumPy, engine and fused paths agree."""
    x = rng.standard_normal((6, 32, 2)).astype(np.float32)
    x[:, :5, 1] = -1.8
    y_raw = np.ones(6, np.int64)
    chans = ["chest_ECG", "chest_EDA"]
    out_np = pdata.normalize_subject(x, y_raw, chans, "all", use_native=False)
    out_nat = pdata.normalize_subject(x, y_raw, chans, "all", use_native=True)
    assert np.isfinite(out_np).all() and np.isfinite(out_nat).all()
    np.testing.assert_allclose(out_nat, out_np, **TOL)
    x_fused, _ = pdata._pack_subject(x, y_raw, [0, 1], chans, "stress_binary", "all")
    assert np.isfinite(x_fused).all()
    np.testing.assert_allclose(x_fused, out_np.transpose(0, 2, 1), **TOL)


def test_pack_cache_version_bump_misses_an_older_entry(engine, rng, tmp_path, monkeypatch,
                                                       capsys):
    """An entry written under the pack cache's previous version (the packs
    before the engine) is a miss: the port packs again and writes its own
    entry beside it; the next call hits that one."""
    names = _write_subjects(tmp_path, rng)
    args = (tmp_path, ["S2", "S3"], NAMES, names)
    with monkeypatch.context() as m:
        m.setattr(pdata, "_PACK_CACHE_VERSION", pdata._PACK_CACHE_VERSION - 1)
        m.setattr(native, "available", lambda: False)
        pdata.pack_corpus(*args, cache=True)
    entries = sorted((tmp_path / ".pack_cache").iterdir())
    assert len(entries) == 1
    assert json.loads((entries[0] / "meta.json").read_text())["version"] == 1
    capsys.readouterr()
    fresh = pdata.pack_corpus(*args, cache=True)
    assert "pack cache hit" not in capsys.readouterr().out
    assert engine.call_counts()["pack_subject_f32"] == 2
    assert len(list((tmp_path / ".pack_cache").iterdir())) == 2
    hit = pdata.pack_corpus(*args, cache=True)
    assert "pack cache hit" in capsys.readouterr().out
    assert engine.call_counts()["pack_subject_f32"] == 2
    np.testing.assert_array_equal(np.asarray(hit.x), fresh.x)
