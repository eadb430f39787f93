"""The port's on-disk pack cache (multimodalsignal_tpu_torch/data/dataset.py:
pack_corpus and pack_corpus_from_pickles `cache=`, MMS_PACK_CACHE,
MMS_PACK_CACHE_GB), the cases of tests/test_pack_cache.py run against the
port, and two of its own: an entry the JAX package wrote in the same data
directory is never read by the port (the two packs agree only to float32
round-off), and a sweep on a cache hit equals a sweep on the miss bitwise
(one CPU thread).

Every comparison is bitwise: a hit is the bytes the miss wrote."""

import warnings

import numpy as np
import pytest
import torch

from multimodalsignal_tpu.data import dataset as jdata
from multimodalsignal_tpu_torch.data import dataset as D
from multimodalsignal_tpu_torch.parallel import fold_sweep as pfs

from tests.test_torch_fold_sweep import (  # noqa: F401
    SUBJECTS,
    _sweep_configs,
    one_torch_thread,
    write_tree,
)

CHANNELS = ["chest_ECG", "chest_EDA", "chest_Resp"]


def _write_subject(data_dir, sid, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 64, len(CHANNELS))).astype(np.float32)
    y = rng.integers(1, 5, size=n).astype(np.int64)
    np.save(data_dir / f"{sid}_X.npy", x)
    np.save(data_dir / f"{sid}_y.npy", y)


@pytest.fixture()
def data_dir(tmp_path):
    d = tmp_path / "chest_raw"
    d.mkdir()
    _write_subject(d, "S2", 11, seed=2)
    _write_subject(d, "S3", 7, seed=3)
    return d


def _pack(data_dir, cache, channels=CHANNELS):
    return D.pack_corpus(data_dir, ["S2", "S3"], list(channels), CHANNELS,
                         "stress_binary", "all", cache=cache)


def _entries(data_dir):
    return sorted(e.name for e in (data_dir / ".pack_cache").iterdir() if e.is_dir())


def _boom(*a, **k):
    raise AssertionError("a cache hit must not touch the subject loaders")


def _assert_same(got, want):
    assert got.subjects == want.subjects
    for name in ("x", "y", "mask"):
        a, b = np.asarray(getattr(got, name)), np.asarray(getattr(want, name))
        assert a.dtype == b.dtype and np.array_equal(a, b), name


def test_cache_hit_is_bit_identical_and_skips_loaders(data_dir, monkeypatch, capsys):
    fresh = _pack(data_dir, cache=True)
    assert (data_dir / ".pack_cache").is_dir() and len(_entries(data_dir)) == 1
    monkeypatch.setattr(D, "load_subject_windows", _boom)
    cached = _pack(data_dir, cache=True)
    assert "pack cache hit" in capsys.readouterr().out
    _assert_same(cached, fresh)
    assert isinstance(cached.x, np.memmap) and not cached.x.flags.writeable


def test_source_change_invalidates(data_dir):
    stale = _pack(data_dir, cache=True)
    _write_subject(data_dir, "S2", 11, seed=99)  # same shape, new content
    fresh = _pack(data_dir, cache=True)
    assert not np.array_equal(np.asarray(fresh.x), np.asarray(stale.x))
    np.testing.assert_array_equal(fresh.y[1], stale.y[1])   # S3 unchanged
    _assert_same(fresh, _pack(data_dir, cache=False))


def test_cache_disabled_writes_nothing(data_dir):
    _pack(data_dir, cache=False)
    assert not (data_dir / ".pack_cache").exists()


def test_env_switch_disables(data_dir, monkeypatch):
    monkeypatch.setenv("MMS_PACK_CACHE", "0")
    _pack(data_dir, cache=None)
    assert not (data_dir / ".pack_cache").exists()
    monkeypatch.setenv("MMS_PACK_CACHE", "1")
    _pack(data_dir, cache=None)
    assert len(_entries(data_dir)) == 1


def test_lru_prune_keeps_newest(data_dir, monkeypatch):
    """A cap far below one entry: every write evicts every older entry but
    keeps the one just written, and packing its inputs again is a hit."""
    monkeypatch.setenv("MMS_PACK_CACHE_GB", "1e-6")
    _pack(data_dir, cache=True)
    _pack(data_dir, cache=True, channels=CHANNELS[:2])  # a second key
    assert len(_entries(data_dir)) == 1
    monkeypatch.setattr(D, "load_subject_windows", _boom)
    _pack(data_dir, cache=True, channels=CHANNELS[:2])


def test_hybrid_pack_uses_cache(data_dir, tmp_path, monkeypatch):
    """pack_hybrid_corpus routes its raw stream through pack_corpus: the
    second hybrid pack reads the raw windows from the cache and the feature
    stream from its files again (features stay uncached)."""
    feat_dir = tmp_path / "chest_feature"
    feat_dir.mkdir()
    rng = np.random.default_rng(0)
    for sid, n in (("S2", 11), ("S3", 7)):
        np.save(feat_dir / f"{sid}_X.npy", rng.normal(size=(n, 4)).astype(np.float32))
        np.save(feat_dir / f"{sid}_y.npy", np.load(data_dir / f"{sid}_y.npy"))
    (feat_dir / "_feature_names.txt").write_text("f0\nf1\nf2\nf3\n")
    kw = dict(classification_mode="stress_binary", normalization="all")
    first = D.pack_hybrid_corpus(data_dir, feat_dir, ["S2", "S3"], CHANNELS, CHANNELS, **kw)
    loaded, real = [], D.load_subject_windows

    def counting(path, sid):
        loaded.append(path)
        return real(path, sid)

    monkeypatch.setattr(D, "load_subject_windows", counting)
    second = D.pack_hybrid_corpus(data_dir, feat_dir, ["S2", "S3"], CHANNELS, CHANNELS, **kw)
    assert loaded == [feat_dir, feat_dir]     # the raw stream came from the cache
    _assert_same(second, first)
    np.testing.assert_array_equal(second.feat, first.feat)


def test_an_entry_the_jax_package_wrote_is_not_read(data_dir, monkeypatch):
    """The JAX package's entry for the same inputs in the same directory is
    a miss for the port (the key names the package), which packs and
    writes its own; the port's hit is its own pack, bitwise."""
    jdata.pack_corpus(data_dir, ["S2", "S3"], CHANNELS, CHANNELS, "stress_binary", "all",
                      cache=True)
    (jax_entry,) = _entries(data_dir)
    loaded, real = [], D.load_subject_windows
    monkeypatch.setattr(D, "load_subject_windows",
                        lambda path, sid, **kw: (loaded.append(sid), real(path, sid, **kw))[1])
    fresh = _pack(data_dir, cache=True)
    assert loaded == ["S2", "S3"] and len(_entries(data_dir)) == 2
    monkeypatch.setattr(D, "load_subject_windows", _boom)
    _assert_same(_pack(data_dir, cache=True), fresh)
    assert jax_entry in _entries(data_dir)


def test_sweep_on_a_hit_equals_the_sweep_on_the_miss(tmp_path):
    """run_fold_sweep on the corpus a miss packed and on the hit that reads
    it back: the same history, test results and final weights, bitwise, on
    one CPU thread; the hit's read-only windows are copied before they
    become a tensor (no warning, no alias of the file)."""
    tree = write_tree(tmp_path / "data")
    _, cfg = _sweep_configs(tree, epochs=2)
    names = D.read_channel_names(tree)
    miss = D.pack_corpus(tree, list(SUBJECTS), CHANNELS, names, cache=True)
    hit = D.pack_corpus(tree, list(SUBJECTS), CHANNELS, names, cache=True)
    assert isinstance(hit.x, np.memmap) and not isinstance(miss.x, np.memmap)
    results = []
    for corpus in (miss, hit):
        fb = pfs.build_fold_batch(corpus, list(SUBJECTS), cfg.val_fraction, cfg.seed)
        with warnings.catch_warnings():
            warnings.simplefilter("error")     # torch.from_numpy of a read-only array warns
            results.append(pfs.run_fold_sweep(corpus, fb, cfg, "cpu"))
    a, b = results
    for name in pfs.SweepHistory._fields:
        np.testing.assert_array_equal(getattr(a.history, name), getattr(b.history, name),
                                      err_msg=name)
    for name in ("best_epoch", "stop_epoch", "test_loss", "test_cm", "test_probs"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name), err_msg=name)
    leaves = lambda tree: [np.asarray(v) for v in _leaves(tree)]  # noqa: E731
    for x, y in zip(leaves(a.final_variables), leaves(b.final_variables)):
        np.testing.assert_array_equal(x, y)
    sweep = pfs.FoldSweep(hit, pfs.build_fold_batch(hit, list(SUBJECTS), cfg.val_fraction,
                                                    cfg.seed), cfg, "cpu")
    assert sweep.x.data_ptr() != np.asarray(hit.x).ctypes.data
    assert torch.equal(sweep.x, torch.from_numpy(np.array(hit.x).reshape(sweep.x.shape)))


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    else:
        yield tree
