"""The port's sweep split over processes (multimodalsignal_tpu_torch:
parallel/multihost.py over torch.distributed's gloo, fold_sweep.rank_block
and FoldSweep's block, the rank split of the plain, --seeds and
--hierarchical sweeps, main's MMS_* entry) on the CPU at small widths
(4 subjects, C = 2, T = 128, H = 8, conv 8, 1-4 epochs).

Two processes of the experiment CLI (main.main, `--device cpu`) join over
MMS_COORDINATOR / MMS_NUM_PROCESSES / MMS_PROCESS_ID on a free port, with
one MMS_RUN_ID, on one intra-op thread each (OMP_NUM_THREADS=1, as the
in-process one-rank baselines run); each pair is killed if it outlives its
deadline. Their run directory must equal the one-process run's bitwise.
For that both sides run PyTorch's own CPU convolution (oneDNN off): it
computes each group of a grouped convolution on its own, where oneDNN
picks its blocking by the group count, so that a rank's 2 lanes and the
one process's 4 differ at round-off (1.5e-8 in a parameter after one step,
test_a_block_keeps_its_lanes_streams_and_dropout with oneDNN on). The
runs keep the model's dropout (0.5): a rank draws the whole sweep's masks.

Tolerances. Each rank's FoldSweep against its lanes of JAX's
jax.vmap(programs["epoch"]) / ["finalize"] on JAX's grids: those of
tests/test_torch_fold_sweep.py (losses rtol 1e-4, parameters atol 1e-4,
the rest exactly), at dropout 0 (the two packages' masks cannot match).
"""

import dataclasses
import json
import os
import re
import shutil
import socket
import subprocess
import sys
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from multimodalsignal_tpu.models import build_model as build_jax_model
from multimodalsignal_tpu.parallel import fold_sweep as jfs
from multimodalsignal_tpu.train import optim as jax_optim
from multimodalsignal_tpu.train.trainer import TrainState
from multimodalsignal_tpu_torch import config as pcfg
from multimodalsignal_tpu_torch import main as pmain
from multimodalsignal_tpu_torch.data import dataset as pdata
from multimodalsignal_tpu_torch.models.convert import export_jax_variables
from multimodalsignal_tpu_torch.models.cnn_gru import build_model
from multimodalsignal_tpu_torch.models.fold_stack import FoldStackedModel
from multimodalsignal_tpu_torch.parallel import fold_sweep as pfs
from multimodalsignal_tpu_torch.parallel import multihost
from multimodalsignal_tpu_torch.parallel.replicated_sweep import replicate_fold_batch
from multimodalsignal_tpu_torch.train.checkpoints import unpackb

from tests.test_torch_fold_sweep import (  # noqa: F401
    CHANNELS,
    SUBJECTS,
    _jax_fold_variables,
    _sweep_configs,
    one_torch_thread,
    write_tree,
)

REPO = Path(__file__).resolve().parents[1]
PAIR_TIMEOUT_S = 120
MODEL = dict(gru_hidden_size=8, cnn_out_channels=8)
BASE = ["--device", "cpu", "--set", "subjects=" + ",".join(SUBJECTS),
        "--set", "channels_to_use=chest_ECG,chest_EDA", "--set", "trainer.batch_size=4",
        "--set", "trainer.epochs=4", "--set", "trainer.checkpoint_every=1",
        "--set", "trainer.resume=true", "--set", "val_fraction=0.3",
        "--set", "trainer.early_stopping.patience=1",
        "--set", "trainer.early_stopping.delta=0.03",
        *(a for k, v in MODEL.items() for a in ("--set", f"model.{k}={v}"))]
# The experiment CLI on PyTorch's own convolution; with "drill", under the
# preemption drill (SweepAborted after epoch 1).
CLI = ("import functools, sys, torch\n"
       "torch.backends.mkldnn.enabled = False\n"
       "from multimodalsignal_tpu_torch import main\n"
       "from multimodalsignal_tpu_torch.parallel import fold_sweep as fs\n"
       "if sys.argv[1] == 'drill':\n"
       "    fs.run_fold_sweep = functools.partial(fs.run_fold_sweep, abort_after_epoch=1)\n"
       "try:\n"
       "    main.main(sys.argv[2:])\n"
       "except fs.SweepAborted as exc:\n"
       "    print('aborted:', exc)\n")


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = write_tree(tmp_path_factory.mktemp("multihost") / "data")
    (root / "_preprocess_meta.json").write_text(json.dumps(
        {"original_fs": 700, "fs": 16, "window_sec": 8, "stride_sec": 4}))
    return root


@pytest.fixture(autouse=True, scope="module")
def native_convolutions():
    enabled = torch.backends.mkldnn.enabled
    torch.backends.mkldnn.enabled = False
    yield
    torch.backends.mkldnn.enabled = enabled


@pytest.fixture(autouse=True, scope="module")
def one_process():
    """The in-process baselines run as one process, whatever the caller's
    environment says."""
    with pytest.MonkeyPatch.context() as mp:
        for name in ("MMS_COORDINATOR", "MMS_NUM_PROCESSES", "MMS_PROCESS_ID", "MMS_RUN_ID"):
            mp.delenv(name, raising=False)
        yield


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_pair(args: list[str], run_id: str, code: str = CLI, check: bool = True) -> list[str]:
    """Two ranks of `python -c code *args` (by default the CLI, args
    starting with "run" or "drill") joined on a free port; both must exit
    within PAIR_TIMEOUT_S, or both are killed, and with `check` exit 0.
    Returns their outputs, each after a line with its exit code."""
    port = _free_port()
    procs = []
    for rank in range(2):
        env = dict(os.environ, MMS_COORDINATOR=f"127.0.0.1:{port}", MMS_NUM_PROCESSES="2",
                   MMS_PROCESS_ID=str(rank), MMS_RUN_ID=run_id, MMS_DIST_TIMEOUT="60",
                   OMP_NUM_THREADS="1", PYTHONPATH=f"{REPO}:{os.environ.get('PYTHONPATH', '')}")
        procs.append(subprocess.Popen([sys.executable, "-c", code, *args], env=env, cwd=REPO,
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=PAIR_TIMEOUT_S)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        pytest.fail(f"the ranks did not finish within {PAIR_TIMEOUT_S} s:\n" + "\n".join(outs))
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 or not check, f"rank {rank} exited {p.returncode}:\n{out}"
    return [f"exit {p.returncode}\n{out}" for p, out in zip(procs, outs)]


def _files(root: Path) -> dict[str, Path]:
    return {str(p.relative_to(root)): p for p in sorted(root.rglob("*")) if p.is_file()}


def _leaves(tree, prefix=""):
    for key in sorted(tree):
        if isinstance(tree[key], dict):
            yield from _leaves(tree[key], f"{prefix}{key}/")
        else:
            yield prefix + key, np.asarray(tree[key])


def assert_runs_equal(got: Path, want: Path, skip=("config.json",)) -> None:
    """Every file of two run directories equal: texts and npy arrays
    exactly, msgpack trees leaf for leaf (bitwise)."""
    files, want_files = _files(got), _files(want)
    assert files.keys() == want_files.keys()
    for name, path in want_files.items():
        if name in skip:
            continue
        if path.suffix == ".msgpack":
            a = dict(_leaves(unpackb(files[name].read_bytes())))
            b = dict(_leaves(unpackb(path.read_bytes())))
            assert a.keys() == b.keys(), name
            for leaf in b:
                np.testing.assert_array_equal(a[leaf], b[leaf], err_msg=f"{name} {leaf}")
        elif path.suffix == ".npy":
            np.testing.assert_array_equal(np.load(files[name]), np.load(path), err_msg=name)
        elif path.suffix == ".npz":
            with np.load(files[name]) as a, np.load(path) as b:
                assert a.files == b.files, name
                for k in b.files:
                    np.testing.assert_array_equal(a[k], b[k], err_msg=f"{name} {k}")
        elif path.suffix == ".pt":
            a, b = torch.load(files[name]), torch.load(path)
            assert all(torch.equal(x, y) for x, y in zip(a, b)) and len(a) == len(b), name
        else:
            assert files[name].read_text() == path.read_text(), name


def _run_dir(out: Path) -> Path:
    (run_dir,) = (p for p in out.rglob("run_*") if p.is_dir())
    return run_dir


# Single process ------------------------------------------------------------

def test_single_process_helpers_are_identities(capsys):
    """No process group: rank 0 of 1, the primary; to_host gives its tree
    back, agree calls through (and lets an error out), assert_agreement,
    sync and shutdown do nothing, log prints; maybe_initialize_from_env
    joins nothing unless all three variables are set."""
    assert (multihost.rank(), multihost.world_size(), multihost.is_primary()) == (0, 1, True)
    tree = {"a": np.arange(3), "b": (np.ones((3, 2)),)}
    assert multihost.to_host(tree) is tree
    assert multihost.agree(lambda: 7, "x") == 7
    with pytest.raises(torch.cuda.OutOfMemoryError):
        multihost.agree(lambda: (_ for _ in ()).throw(torch.cuda.OutOfMemoryError("oom")), "x")
    multihost.assert_agreement(3, "anything")
    multihost.sync()
    multihost.shutdown()
    multihost.log("from the primary")
    assert capsys.readouterr().out == "from the primary\n"
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MMS_COORDINATOR", "127.0.0.1:1")
        mp.setenv("MMS_NUM_PROCESSES", "2")
        assert multihost.maybe_initialize_from_env() is False    # MMS_PROCESS_ID unset
    assert not torch.distributed.is_initialized()


def test_a_group_that_cannot_form_raises():
    """Rank 1 of 2 with nobody at the coordinator's address: an error once
    the timeout passes, no single-process fallback."""
    with pytest.MonkeyPatch.context() as mp, pytest.raises(RuntimeError, match="timed out"):
        mp.setenv("MMS_DIST_TIMEOUT", "1")
        multihost.initialize(f"127.0.0.1:{_free_port()}", 2, 1)
    assert not torch.distributed.is_initialized()


# The rank's block and its streams ------------------------------------------

@pytest.mark.parametrize("lanes,world", [(15, 2), (4, 2), (60, 4), (5, 3), (3, 3)])
def test_rank_blocks_are_array_splits_in_fold_order(lanes, world):
    blocks = [pfs.rank_block(lanes, r, world) for r in range(world)]
    want = np.array_split(np.arange(lanes), world)
    assert [list(range(lo, hi)) for lo, hi in blocks] == [w.tolist() for w in want]
    assert pfs.rank_block(lanes) == (0, lanes)      # one process: every lane
    with pytest.raises(ValueError, match="at least one"):
        pfs.rank_block(lanes, 0, lanes + 1)


@pytest.mark.parametrize("seeds,block", [((5,), (1, 3)), ((5, 6), (3, 6)), ((5, 6), (4, 8))])
def test_a_block_keeps_its_lanes_streams_and_dropout(seeds, block, data):
    """A FoldSweep holding lanes lo..hi-1 against the one-process sweep:
    the same initial weights, shuffled grids, class weights and evaluation
    grids as those lanes, and a train step (dropout 0.5 on the head and
    between the GRU layers, seed groups crossing the block) whose losses,
    new parameters and generator states equal the one-process step's."""
    _, cfg = _sweep_configs(data)
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, dropout=0.5),
                              trainer=dataclasses.replace(cfg.trainer,
                                                          use_class_weights=True))
    corpus = pdata.pack_corpus(data, list(SUBJECTS), CHANNELS, pdata.read_channel_names(data))
    fb = replicate_fold_batch(pfs.build_fold_batch(corpus, list(SUBJECTS), cfg.val_fraction,
                                                   cfg.seed), len(seeds))
    lo, hi = block
    init, rngs = pfs.seed_group_streams(seeds, fb.train_pool.shape[0])
    _, rngs_part = pfs.seed_group_streams(seeds, fb.train_pool.shape[0])
    whole = pfs.FoldSweep(corpus, fb, cfg, "cpu", init_seeds=init, dropout_seeds=seeds)
    part = pfs.FoldSweep(corpus, fb, cfg, "cpu", init_seeds=init, dropout_seeds=seeds,
                         block=block)
    for a, b in zip(whole.model.parameters(), part.model.parameters()):
        torch.testing.assert_close(b, a[lo:hi], rtol=0, atol=0)
    grid, grid_part = whole.train_grid(rngs), part.train_grid(rngs_part)
    for a, b in zip(grid, grid_part):
        np.testing.assert_array_equal(b, a[lo:hi])
    for a, b in zip(whole.val_grid + whole.test_grid, part.val_grid + part.test_grid):
        torch.testing.assert_close(b, a[lo:hi], rtol=0, atol=0)
    torch.testing.assert_close(part.cw, whole.cw[lo:hi], rtol=0, atol=0)
    assert part.steps_tr == whole.steps_tr
    idx, w = whole.to_device(grid)
    loss, _, _ = whole.train_step(idx[:, 0], w[:, 0])
    idx, w = part.to_device(grid_part)
    loss_part, _, _ = part.train_step(idx[:, 0], w[:, 0])
    torch.testing.assert_close(loss_part, loss[lo:hi], rtol=0, atol=0)
    for a, b in zip(whole.model.parameters(), part.model.parameters()):
        torch.testing.assert_close(b, a[lo:hi], rtol=0, atol=0)
    for g, h in zip(whole.generators, part.generators):
        assert torch.equal(g.get_state(), h.get_state())


@pytest.mark.parametrize("lo,hi", [(0, 6), (2, 5), (0, 3), (3, 6), (5, 6)])
def test_the_fold_stacked_dropout_draws_the_whole_sweeps_masks(lo, hi):
    """Dropout of a model holding lanes lo..hi-1 of a 6-lane sweep in two
    seed groups: the six-lane model's on those lanes, from generators
    seeded alike, and the generators left in the same states."""
    cfg = pcfg.ModelConfig(gru_hidden_size=8, cnn_out_channels=8, dropout=0.5)
    singles = [build_model(cfg, 2, 2) for _ in range(6)]
    whole, part = FoldStackedModel(singles, cfg.gru_impl), FoldStackedModel(singles[lo:hi])
    part.lane_span = (lo, 6)
    y = torch.from_numpy(np.random.default_rng(0).standard_normal((6, 5, 7)).astype(np.float32))
    gens, gens_part = ([torch.Generator().manual_seed(s) for s in (1, 2)] for _ in range(2))
    want = whole.train()._dropout(y, 0.5, gens)
    got = part.train()._dropout(y[lo:hi], 0.5, gens_part)
    torch.testing.assert_close(got, want[lo:hi], rtol=0, atol=0)
    assert (got == 0).any() and (got != 0).any()
    for g, h in zip(gens, gens_part):
        assert torch.equal(g.get_state(), h.get_state())


# Two ranks against one process ---------------------------------------------

def _cli_argv(data) -> list[str]:
    return [*BASE, "--set", f"data_path={data}"]


def _hier_argv(data) -> list[str]:
    argv = ["--hierarchical", "--device", "cpu", "--set", f"base.data_path={data}",
            "--set", "base.subjects=" + ",".join(SUBJECTS), "--set", "base.val_fraction=0.3",
            "--set", "m1_channels=chest_ECG,chest_EDA", "--set", "m2_channels=chest_EDA,chest_Resp",
            "--set", "base.trainer.epochs=2", "--set", "base.trainer.batch_size=4"]
    return argv + [a for stage in ("m1_model", "m2_model") for k, v in MODEL.items()
                   for a in ("--set", f"{stage}.{k}={v}")]


@pytest.fixture(scope="module")
def plain_runs(data, tmp_path_factory):
    """The sharded sweep (4 epochs, a resume bundle each epoch, dropout
    0.5; early stopping stops S3 after epoch 2 and rank 1's S4 and S5
    too, so rank 1 coasts through the epochs rank 0 still trains) in this
    process and as two ranks: (one run, two-rank run, the ranks'
    outputs)."""
    root = tmp_path_factory.mktemp("plain")
    pmain.main([*_cli_argv(data), "--output-dir", str(root / "one")])
    outs = run_pair(["run", *_cli_argv(data), "--output-dir", str(root / "two"),
                     "--profile-dir", str(root / "trace")], "two")
    return _run_dir(root / "one"), root / "two" / "simple_binary" / "run_two", outs


def test_two_ranks_write_the_one_process_run(plain_runs):
    """Every file of the run directory (config.json, cv_summary.txt, each
    fold's training_log.txt, test_probs.npy and best_model.msgpack, the
    resume bundle) bitwise the one-process run's (which ran without
    --profile-dir); each rank wrote its own trace; only rank 0 names the
    run directory, each rank reports itself up."""
    one, two, outs = plain_runs
    assert_runs_equal(two, one, skip=())
    assert sorted(p.name for p in (two.parents[2] / "trace").iterdir()) == [
        "sweep_trace.json", "sweep_trace_rank1.json"]
    assert len(list(two.glob("fold_test_on_*/best_model.msgpack"))) == len(SUBJECTS)
    epochs = re.findall(r"test (S\d): .*\(epochs: (\d+)", (two / "cv_summary.txt").read_text())
    assert epochs == [("S2", "4"), ("S3", "2"), ("S4", "2"), ("S5", "2")]
    for rank, out in enumerate(outs):
        assert f"[multihost] process {rank}/2 up" in out
        assert ("Run directory:" in out) == (rank == 0), out
        assert ("Sharded LOSO sweep: 4 folds" in out) == (rank == 0), out


# Each rank against JAX's sweep ---------------------------------------------

def test_each_ranks_block_matches_its_lanes_of_the_jax_sweep(data):
    """Each of two ranks' FoldSweep (lanes 0-1 and 2-3 of 4 folds) against
    its lanes of jax.vmap(programs["epoch"]) from JAX's initial carry, on
    its lanes of the grid JAX's _shuffled_grid draws, for 3 epochs, then
    finalize: per epoch losses, accuracy, F1, lr and the stop flags; the
    parameters after; the test loss, confusion matrix, best epoch and
    probabilities."""
    cfg_j, cfg_p = _sweep_configs(data)
    corpus = pdata.pack_corpus(data, list(SUBJECTS), CHANNELS, pdata.read_channel_names(data))
    fb = pfs.build_fold_batch(corpus, list(SUBJECTS), cfg_p.val_fraction, cfg_p.seed)
    folds, batch = len(fb.test_subjects), cfg_p.trainer.batch_size
    steps = [pfs.grid_steps(n, batch) for n in (fb.n_train, fb.n_val, fb.n_test)]
    jm = build_jax_model(cfg_j.model, 2, fold_parallel=True)
    tx = jax_optim.make_optimizer(cfg_j.trainer.learning_rate, cfg_j.trainer.weight_decay)
    programs = jfs._make_fold_program(jm, tx, cfg_j, *steps, 2)
    variables = _jax_fold_variables(jm, folds, seed=11)
    carry = jax.vmap(programs["init_carry"])(
        jax.vmap(lambda p, bs: TrainState(p, bs, tx.init(p)))(
            variables["params"], variables["batch_stats"]),
        jax.random.split(jax.random.PRNGKey(cfg_j.seed), folds))
    epoch_fn = jax.jit(jax.vmap(programs["epoch"], in_axes=(None, None, 0, 0, 0, 0, 0, 0, None)))
    x, y, _ = corpus.flat()
    pools = (fb.train_pool, fb.n_train, fb.val_pool, fb.n_val)
    cw = np.ones((folds, 2), np.float32)
    grid_fn = jax.vmap(lambda r, p, n: jfs._shuffled_grid(jax.random.split(r, 3)[1], p, n,
                                                          steps[0], batch))
    blocks = [pfs.rank_block(folds, r, 2) for r in range(2)]
    ranks = [pfs.FoldSweep(corpus, fb, cfg_p, "cpu", variables=variables, block=b)
             for b in blocks]
    for epoch in range(cfg_p.trainer.epochs):
        idx, w = (np.asarray(a) for a in grid_fn(carry[4], fb.train_pool, fb.n_train))
        carry, want = epoch_fn(x, y, *pools, cw, carry, epoch)
        for (lo, hi), sweep in zip(blocks, ranks):
            got = sweep.epoch(idx[lo:hi], w[lo:hi], epoch)
            for i in (0, 1):
                np.testing.assert_allclose(got[i], np.asarray(want[i])[lo:hi], rtol=1e-4)
            for i in (2, 3, 4, 5):
                np.testing.assert_array_equal(got[i], np.asarray(want[i])[lo:hi], err_msg=str(i))
            np.testing.assert_array_equal(sweep.stopped, np.asarray(carry[5])[lo:hi])
    finalize = jax.jit(jax.vmap(programs["finalize"], in_axes=(None, None, 0, 0, 0, 0)))
    t_loss, t_cm, best, _, _, probs = (np.asarray(a) for a in finalize(
        x, y, fb.test_pool, fb.n_test, cw, carry))
    for (lo, hi), sweep in zip(blocks, ranks):
        final = export_jax_variables(sweep.model)["params"]
        for path, want in jax.tree_util.tree_leaves_with_path(carry[0].params):
            node = final
            for k in path:
                node = node[k.key]
            np.testing.assert_allclose(node, np.asarray(want)[lo:hi], rtol=0, atol=1e-4,
                                       err_msg=jax.tree_util.keystr(path))
        got = sweep.finalize()
        np.testing.assert_allclose(got[0], t_loss[lo:hi], rtol=1e-4)
        np.testing.assert_array_equal(got[1], t_cm[lo:hi])
        np.testing.assert_array_equal(got[2], best[lo:hi])
        np.testing.assert_allclose(got[3], probs[lo:hi], rtol=0, atol=1e-4)


# Cut and resumed -----------------------------------------------------------

def test_a_cut_two_rank_sweep_resumes_in_two_ranks_and_in_one(plain_runs, data, tmp_path):
    """Two ranks under the preemption drill (cut after epoch 1 of 4): a
    bundle in today's format with next_epoch 1; resumed by two ranks, and a
    copy of it by one process: both run directories bitwise the uncut
    one-process run's."""
    one, _, _ = plain_runs
    argv = [*_cli_argv(data), "--output-dir", str(tmp_path)]
    outs = run_pair(["drill", *argv], "cut")
    assert all("aborted: aborted after epoch 1 (drill)" in out for out in outs), outs
    cut = tmp_path / "simple_binary" / "run_cut"
    assert json.loads((cut / "sweep_resume_meta.json").read_text()) == {"next_epoch": 1}
    assert not list(cut.glob("fold_test_on_*"))
    shutil.copytree(cut, tmp_path / "simple_binary" / "run_alone")
    outs = run_pair(["run", *argv], "cut")
    assert "resumed sweep from epoch 1" in outs[0] and "resumed" not in outs[1]
    assert_runs_equal(cut, one, skip=())
    with pytest.MonkeyPatch.context() as mp:   # one process, the copy's directory
        mp.setenv("MMS_NUM_PROCESSES", "1")
        mp.setenv("MMS_RUN_ID", "alone")
        pmain.main(argv)
    assert_runs_equal(tmp_path / "simple_binary" / "run_alone", one, skip=())


# --seeds and --hierarchical ------------------------------------------------

@pytest.mark.parametrize("kind", ["seeds", "hierarchical"])
def test_seeds_and_hierarchical_split_over_two_ranks(kind, data, tmp_path):
    """main --seeds 42 43 (8 lanes, 4 a rank: each rank one seed group)
    and main --hierarchical (both stages' 4 folds, 2 a rank, and their
    composed evaluation) as two ranks: the run directory bitwise the
    one-process run's (seed_summary.json but for its wall times)."""
    argv = _cli_argv(data) + ["--seeds", "42", "43"] if kind == "seeds" else _hier_argv(data)
    pmain.main([*argv, "--output-dir", str(tmp_path / "one")])
    run_pair(["run", *argv, "--output-dir", str(tmp_path / "two")], "two")
    one, two = _run_dir(tmp_path / "one"), _run_dir(tmp_path / "two")
    assert_runs_equal(two, one, skip=("seed_summary.json",))
    if kind == "seeds":
        got, want = (json.loads((d / "seed_summary.json").read_text()) for d in (two, one))
        for summary in (got, want):
            del summary["wall_s"], summary["launch_walls_s"]
        assert got == want and len(want["accuracy"]) == 2
    else:
        assert len(list(two.glob("fold_test_on_*/model_m*/best_model.msgpack"))) == 8


def test_serial_execution_is_refused_under_several_processes(data, tmp_path, monkeypatch):
    monkeypatch.setattr(multihost, "world_size", lambda: 2)
    for argv in (_cli_argv(data) + ["--execution", "serial"],
                 _hier_argv(data) + ["--execution", "serial"]):
        with pytest.raises(SystemExit, match="serial execution runs every fold"):
            pmain.main([*argv, "--output-dir", str(tmp_path)])


# Collectives of two ranks --------------------------------------------------

GROUP = """
import json, numpy as np, torch
from multimodalsignal_tpu_torch.parallel import multihost as mh
assert mh.maybe_initialize_from_env()
r = mh.rank()
out = {"rank": r, "world": mh.world_size(), "primary": mh.is_primary()}
got = mh.to_host({"a": np.arange(3 - r) + 10 * r, "b": (torch.full((3 - r, 2), float(r)),)},
                 "blocks")
out["a"], out["b"] = got["a"].tolist(), got["b"][0].tolist()

def step():
    if r == 1:
        raise torch.cuda.OutOfMemoryError("card full")
    return "fine"

try:
    out["agree"] = mh.agree(step, "step")
except torch.cuda.OutOfMemoryError as exc:
    out["agree"] = str(exc)
mh.assert_agreement(5, "the same value")
try:
    mh.assert_agreement(r, "resume epoch")
except RuntimeError as exc:
    out["disagree"] = str(exc)
try:
    mh.to_host(np.zeros(1), f"gather {r}")
except RuntimeError as exc:
    out["out_of_step"] = str(exc)
mh.sync()
print("RESULT", json.dumps(out), flush=True)
mh.shutdown()
"""


def test_collectives_of_two_ranks():
    """to_host joins uneven blocks in rank order; agree raises on every rank
    where one ran out of memory; assert_agreement passes on agreement and
    raises the JAX package's message on a disagreement; gathers under
    different names raise."""
    outs = run_pair([], "group", code=GROUP)
    results = [json.loads(out.split("RESULT ", 1)[1]) for out in outs]
    for rank, got in enumerate(results):
        assert (got["rank"], got["world"], got["primary"]) == (rank, 2, rank == 0)
        assert got["a"] == [0, 1, 2, 10, 11]
        assert got["b"] == [[0.0, 0.0]] * 3 + [[1.0, 1.0]] * 2
        assert got["disagree"].startswith(
            "multi-host disagreement on resume epoch: per-process values [0, 1]")
        assert "collectives out of step" in got["out_of_step"]
    assert results[0]["agree"] == "rank 1 failed in step: card full"
    assert results[1]["agree"] == "card full"


def test_a_rank_that_fails_leaves_no_peer_waiting(data, tmp_path):
    """Rank 1 of the CLI stops on a config error that rank 0 does not have,
    while rank 0 goes on: rank 0's first collective raises at once (gloo
    sees the closed connection), and both exit non-zero well inside the
    deadline, not at MMS_DIST_TIMEOUT."""
    code = "import os\n" + CLI.replace(
        "main.main(sys.argv[2:])", "main.main(sys.argv[2:] + (['--set', 'trainer.epochs=0x']"
        " if os.environ['MMS_PROCESS_ID'] == '1' else []))")
    t0 = time.monotonic()
    outs = run_pair(["run", *_cli_argv(data), "--output-dir", str(tmp_path)], "fail",
                    code=code, check=False)
    assert time.monotonic() - t0 < 50
    assert all(not out.startswith("exit 0") for out in outs), outs


def test_the_losing_pack_cache_store_is_quiet(data, tmp_path, monkeypatch, capsys):
    """Two ranks that miss the pack cache at once both store the entry:
    the rename that loses to the other's leaves the winner's entry, removes
    its own temporary directory and warns of nothing."""
    corpus = pdata.pack_corpus(data, list(SUBJECTS), CHANNELS, pdata.read_channel_names(data),
                               cache=False)
    real = os.rename

    def other_rank_first(src, dst):
        shutil.copytree(src, dst)   # the other rank's rename of the same pack, first
        real(src, dst)

    monkeypatch.setattr(pdata.os, "rename", other_rank_first)
    pdata._pack_cache_store(tmp_path, "key", corpus)
    monkeypatch.setattr(pdata.os, "rename", real)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["key"]
    np.testing.assert_array_equal(pdata._pack_cache_load(tmp_path, "key").x, corpus.x)
    assert "Warning" not in capsys.readouterr().out
