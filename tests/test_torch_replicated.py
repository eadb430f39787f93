"""The port's seed-replicated sweep (multimodalsignal_tpu_torch/parallel/
replicated_sweep.py, run_fold_sweep's `seeds`, main --seeds) on the CPU at
small widths (H = 8, conv 8, T = 128, 3 subjects), against the JAX
package's helpers and against the port's own single-seed sweeps.

Comparisons are bitwise: a seed group runs the same per-lane arithmetic as
the single-seed sweep (lanes never mix; dropout masks are drawn per seed
group from that seed's generator), and the summaries are NumPy on the same
matrices as the JAX package's.
"""

import json

import numpy as np
import pytest
import torch

from multimodalsignal_tpu import config as jcfg
from multimodalsignal_tpu.parallel import fold_sweep as jfs
from multimodalsignal_tpu.parallel import replicated_sweep as jrs
from multimodalsignal_tpu_torch import config as pcfg
from multimodalsignal_tpu_torch import main as pmain
from multimodalsignal_tpu_torch.data import dataset as pdata
from multimodalsignal_tpu_torch.parallel import fold_sweep as pfs
from multimodalsignal_tpu_torch.parallel import replicated_sweep as prs

from tests.test_torch_fold_sweep import one_torch_thread, write_tree  # noqa: F401

SUBJECTS = ("S2", "S3", "S4")
CHANNELS = ("chest_ECG", "chest_EDA", "chest_Resp")
SEEDS = (42, 7)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return write_tree(tmp_path_factory.mktemp("replicated") / "data", SUBJECTS)


def _cfg(tree, **trainer):
    """dropout 0.5, so the seed groups' dropout streams matter."""
    return pcfg.ExperimentConfig(
        subjects=SUBJECTS, data_path=str(tree), channels_to_use=CHANNELS,
        model=pcfg.ModelConfig(gru_hidden_size=8, cnn_out_channels=8, dropout=0.5),
        trainer=pcfg.TrainerConfig(**dict(dict(epochs=2, batch_size=4), **trainer)))


def _corpus_fb(tree, cfg):
    corpus = pdata.pack_corpus(tree, list(SUBJECTS), list(CHANNELS),
                               pdata.read_channel_names(tree))
    return corpus, pfs.build_fold_batch(corpus, list(SUBJECTS), cfg.val_fraction, cfg.seed)


def test_replicate_fold_batch_matches_jax(tree):
    cfg = _cfg(tree)
    _, fb = _corpus_fb(tree, cfg)
    got = prs.replicate_fold_batch(fb, 3)
    want = jrs.replicate_fold_batch(jfs.FoldBatch(
        fb.train_pool, fb.n_train, fb.val_pool, fb.n_val, fb.test_pool, fb.n_test,
        np.ones(len(fb.test_subjects), bool), fb.test_subjects), 3)
    for name in ("train_pool", "n_train", "val_pool", "n_val", "test_pool", "n_test"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert got.test_subjects == want.test_subjects == SUBJECTS
    assert got.train_pool.shape[0] == 3 * len(SUBJECTS)


@pytest.mark.parametrize("num_seeds", [1, 3])
def test_summaries_match_jax(num_seeds, tmp_path):
    """summarize_from_matrices and write_seed_summary's text, byte for byte,
    from the same matrices; seed_summary.json as run_replicated_experiment
    writes it."""
    rng = np.random.default_rng(num_seeds)
    acc, f1 = rng.uniform(0.3, 1.0, (2, num_seeds, 4))
    seeds, subjects = tuple(range(40, 40 + num_seeds)), ("S2", "S3", "S4", "S5")
    got = prs.summarize_from_matrices(acc, f1, seeds, subjects)
    want = jrs.summarize_from_matrices(acc, f1, seeds, subjects)
    assert got == want
    assert json.dumps(got, indent=2) == json.dumps(want, indent=2)
    prs.write_seed_summary(tmp_path / "port.txt", pcfg.ExperimentConfig(), got)
    jrs.write_seed_summary(tmp_path / "jax.txt", jcfg.ExperimentConfig(), want)
    assert (tmp_path / "port.txt").read_bytes() == (tmp_path / "jax.txt").read_bytes()


def test_acc_f1_matrices_match_jax_per_lane():
    """The per-(seed, fold) accuracy and F1 of stacked confusion matrices,
    as the JAX package computes them lane by lane."""
    cms = np.random.default_rng(2).integers(0, 7, (6, 2, 2)).astype(np.float32)
    cms[4] = 0                                 # a fold without test windows
    acc, f1 = prs._acc_f1_matrices(cms, 2, 3)
    result = type("R", (), {"test_cm": cms})
    jacc, jf1 = jrs._acc_f1_matrices(result, type("F", (), {"test_subjects": "abc"}), 2, 3)
    np.testing.assert_array_equal(acc, jacc)
    np.testing.assert_array_equal(f1, jf1)


def _assert_same_sweep(got, want, lanes, what):
    for name, a in got.history._asdict().items():
        np.testing.assert_array_equal(a[lanes], getattr(want.history, name), err_msg=name)
    for name in ("best_epoch", "stop_epoch", "test_loss", "test_cm", "test_probs"):
        np.testing.assert_array_equal(getattr(got, name)[lanes], getattr(want, name),
                                      err_msg=f"{what} {name}")
    for coll in ("params", "batch_stats"):
        def walk(a, b, path=()):
            if isinstance(a, dict):
                for k in a:
                    walk(a[k], b[k], path + (k,))
            else:
                np.testing.assert_array_equal(a[lanes], b, err_msg=f"{what} {path}")
        walk(got.final_variables[coll], want.final_variables[coll])


def test_seed_groups_are_the_single_seed_sweeps(tree):
    """A 2-seed sweep (6 lanes): seed group s is bitwise the sweep with
    seeds=(s,), and seeds=(cfg.seed,) is the plain sweep; the groups
    differ from each other."""
    cfg = _cfg(tree)
    corpus, fb = _corpus_fb(tree, cfg)
    folds = len(fb.test_subjects)
    rep = pfs.run_fold_sweep(corpus, prs.replicate_fold_batch(fb, 2), cfg, "cpu", seeds=SEEDS)
    for g, seed in enumerate(SEEDS):
        one = pfs.run_fold_sweep(corpus, fb, cfg, "cpu", seeds=(seed,))
        _assert_same_sweep(rep, one, slice(g * folds, (g + 1) * folds), f"group {g}")
    plain = pfs.run_fold_sweep(corpus, fb, cfg, "cpu")
    _assert_same_sweep(rep, plain, slice(0, folds), "plain")
    assert not np.array_equal(rep.history.train_loss[:folds], rep.history.train_loss[folds:])
    summary = prs.summarize_replicated(rep, fb, SEEDS, folds)
    acc = np.asarray(summary["accuracy"])
    assert acc.shape == (len(SEEDS), folds) and summary["subjects"] == list(SUBJECTS)
    cm = torch.from_numpy(rep.test_cm[folds + 1])
    assert acc[1, 1] == float(prs.M.accuracy_from_cm(cm))
    assert summary["grand_mean_accuracy"] == pytest.approx(acc.mean())
    with pytest.raises(ValueError, match="equal seed groups"):
        pfs.run_fold_sweep(corpus, prs.replicate_fold_batch(fb, 2), cfg, "cpu",
                           seeds=(1, 2, 3, 4))


def test_seed_chunks_equal_the_monolithic_launch(tree, tmp_path):
    """seed_chunk=1 (one launch a seed group) gives the monolithic launch's
    per-(seed, fold) matrices exactly; the run directory holds JAX's files."""
    cfg = _cfg(tree)
    mono = prs.run_replicated_experiment(cfg, SEEDS, tmp_path / "mono", device="cpu")
    chunked = prs.run_replicated_experiment(cfg, SEEDS, tmp_path / "chunked", device="cpu",
                                            seed_chunk=1)
    assert chunked["accuracy"] == mono["accuracy"] and chunked["f1"] == mono["f1"]
    assert (chunked["seed_chunk"], len(chunked["launch_walls_s"])) == (1, 2)
    assert (mono["seed_chunk"], len(mono["launch_walls_s"])) == (2, 1)
    saved = json.loads((tmp_path / "mono" / "seed_summary.json").read_text())
    assert saved["accuracy"] == mono["accuracy"] and saved["seeds"] == list(SEEDS)
    npz = np.load(tmp_path / "mono" / "seed_fold_matrix.npz")
    np.testing.assert_array_equal(npz["accuracy"], np.asarray(mono["accuracy"]))
    np.testing.assert_array_equal(npz["seeds"], SEEDS)
    assert tuple(npz["subjects"]) == SUBJECTS
    config = json.loads((tmp_path / "mono" / "config.json").read_text())
    assert config["replicate_seeds"] == list(SEEDS)
    assert jcfg.config_from_dict(jcfg.ExperimentConfig, config).subjects == SUBJECTS
    assert (tmp_path / "mono" / "seed_summary.txt").read_text().startswith(
        "Seed-replicated LOSO sweep summary\n")
    with pytest.raises(ValueError, match="seed_chunk"):
        prs.run_replicated_experiment(cfg, SEEDS, tmp_path / "bad", device="cpu", seed_chunk=0)


def test_out_of_memory_halves_the_chunk_and_keeps_finished_groups(tree, tmp_path,
                                                                  monkeypatch):
    """4 seeds at seed_chunk=2: the second launch runs out of device memory
    (torch.cuda.OutOfMemoryError, monkeypatched in), the first launch's
    groups are kept, the rest run one a launch, and the matrices equal the
    one-seed-a-launch run's. Any other error, and an OOM at chunk 1,
    propagate."""
    cfg = _cfg(tree, epochs=1)
    seeds = (42, 7, 3, 5)
    real = prs.run_fold_sweep
    calls = []

    def flaky(corpus, fb, cfg, device, seeds):
        calls.append(seeds)
        if len(calls) == 2:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory (simulated)")
        return real(corpus, fb, cfg, device, seeds=seeds)

    monkeypatch.setattr(prs, "run_fold_sweep", flaky)
    got = prs.run_replicated_experiment(cfg, seeds, tmp_path / "oom", device="cpu",
                                        seed_chunk=2)
    assert calls == [(42, 7), (3, 5), (3,), (5,)]
    assert got["seed_chunk"] == 1 and len(got["launch_walls_s"]) == 3
    monkeypatch.setattr(prs, "run_fold_sweep", real)
    want = prs.run_replicated_experiment(cfg, seeds, tmp_path / "ref", device="cpu",
                                         seed_chunk=1)
    assert got["accuracy"] == want["accuracy"] and got["f1"] == want["f1"]

    def fails(error):
        def run(*args, **kwargs):
            raise error
        return run

    monkeypatch.setattr(prs, "run_fold_sweep", fails(RuntimeError("not memory")))
    with pytest.raises(RuntimeError, match="not memory"):
        prs.run_replicated_experiment(cfg, seeds, tmp_path / "other", device="cpu")
    monkeypatch.setattr(prs, "run_fold_sweep",
                        fails(torch.cuda.OutOfMemoryError("CUDA out of memory")))
    with pytest.raises(torch.cuda.OutOfMemoryError):
        prs.run_replicated_experiment(cfg, seeds, tmp_path / "one", device="cpu",
                                      seed_chunk=1)


def test_main_seeds_writes_the_seed_summary(tree, tmp_path, capsys):
    """main --seeds at --device cpu: the replicated sweep's run directory;
    --seeds with --execution serial is refused as the JAX package refuses
    it, before a run directory is made."""
    argv = ["--device", "cpu", "--set", f"data_path={tree}",
            "--set", "subjects=" + ",".join(SUBJECTS), "--set", "model.gru_hidden_size=8",
            "--set", "model.cnn_out_channels=8", "--set", "trainer.epochs=1",
            "--set", "trainer.batch_size=4", "--seeds", "42", "7", "5"]
    pmain.main(argv + ["--seed-chunk", "2", "--output-dir", str(tmp_path / "out")])
    (run_dir,) = (tmp_path / "out" / "simple_binary").iterdir()
    out = capsys.readouterr().out
    assert "3 folds x 2 seeds = 6 lanes" in out and "3 folds x 1 seeds = 3 lanes" in out
    summary = json.loads((run_dir / "seed_summary.json").read_text())
    assert summary["seeds"] == [42, 7, 5] and np.asarray(summary["accuracy"]).shape == (3, 3)
    assert summary["seed_chunk"] == 2 and len(summary["launch_walls_s"]) == 2
    assert (run_dir / "seed_summary.txt").is_file() and (run_dir / "seed_fold_matrix.npz").is_file()
    with pytest.raises(SystemExit, match="--seeds requires --execution sharded"):
        pmain.main(argv + ["--execution", "serial", "--output-dir", str(tmp_path / "serial")])
    assert not (tmp_path / "serial").exists()


def test_replicated_experiment_asks_for_cuda_by_default(tree, tmp_path):
    """Without a device the replicated sweep raises where there is no CUDA,
    before it makes a run directory."""
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without CUDA")
    with pytest.raises(RuntimeError, match="cuda"):
        prs.run_replicated_experiment(_cfg(tree), SEEDS, tmp_path / "out")
    assert not (tmp_path / "out").exists()
