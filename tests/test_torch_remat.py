"""trainer.remat in the port's sweep (FoldStackedModel.forward_remat,
FoldSweep.train_step) on the CPU at small widths (H = 8, conv 8, T = 128).

Remat recomputes the fold-stacked model's train forward in the backward.
It changes no result, so on one intra-op thread a sweep step with remat
equals one without bit for bit: the losses, every gradient, the batch-norm
running statistics (moved once a step, not again by the recompute) and
each dropout generator's state after the step (the recompute replays the
forward's masks), at dropout 0.3, for the plain sweep under every kind of
walk, a rank block of lanes (whose generators draw their whole group's
masks) and a hybrid sweep. At dropout 0 the port's sweep epoch matches the
JAX package's with trainer.remat both on and off, under the sweep tests'
tolerances (tests/test_torch_fold_sweep.py: losses rtol 1e-4, parameters
atol 1e-4).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from multimodalsignal_tpu import config as jcfg
from multimodalsignal_tpu.models import build_model as build_jax_model
from multimodalsignal_tpu.parallel import fold_sweep as jfs
from multimodalsignal_tpu.train import optim as jax_optim
from multimodalsignal_tpu.train.trainer import TrainState
from multimodalsignal_tpu_torch import config as pcfg
from multimodalsignal_tpu_torch.data import dataset as pdata
from multimodalsignal_tpu_torch.models.convert import export_jax_variables
from multimodalsignal_tpu_torch.ops import gru_cuda
from multimodalsignal_tpu_torch.parallel import fold_sweep as pfs

SUBJECTS = ("S2", "S3", "S4", "S5")
CHANNELS = ["chest_ECG", "chest_EDA", "chest_Resp"]
T, H, K, STEPS = 128, 8, 2, 3


def write_tree(root, t=T, seed=0):
    """A preprocessed data directory as tests/test_torch_fold_sweep.py
    writes it: per subject X [n, t, 8] float32 (ragged n), raw labels 1-4,
    the stress windows oscillating faster."""
    rng = np.random.default_rng(seed)
    root.mkdir(parents=True, exist_ok=True)
    (root / "_channel_names.txt").write_text("\n".join(pcfg.ALL_CHANNEL_NAMES) + "\n")
    tt = np.arange(t) / 128.0
    for k, sid in enumerate(SUBJECTS):
        n = (12, 9, 11, 10)[k]
        y = rng.integers(1, 5, n)
        y[:3] = (1, 2, 3)
        freq = np.where(y == 2, 8.0, 1.0)[:, None, None]
        x = np.sin(2 * np.pi * freq * tt[None, :, None]) + 0.3 * rng.standard_normal((n, t, 8))
        x[..., 4] = 2.0 + 0.5 * x[..., 4] + k
        np.save(root / f"{sid}_X.npy", x.astype(np.float32))
        np.save(root / f"{sid}_y.npy", y.astype(np.int64))
    return root


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return write_tree(tmp_path_factory.mktemp("remat") / "data")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Bitwise comparisons on one intra-op thread (several split the
    reductions in other orders from call to call)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _config(tree, remat: bool, dropout: float, gru_impl: str = "auto",
            name: str = "cnn_gru") -> pcfg.ExperimentConfig:
    return pcfg.ExperimentConfig(
        subjects=SUBJECTS, data_path=str(tree), seed=5, val_fraction=0.3,
        channels_to_use=tuple(CHANNELS),
        model=pcfg.ModelConfig(name=name, gru_hidden_size=H, cnn_out_channels=8,
                               dropout=dropout, gru_impl=gru_impl),
        trainer=pcfg.TrainerConfig(batch_size=4, learning_rate=5e-3, remat=remat))


def _corpus(tree, hybrid: bool):
    corpus = pdata.pack_corpus(tree, list(SUBJECTS), CHANNELS, pdata.read_channel_names(tree),
                               cache=False)
    if hybrid:   # features window for window with x
        rng = np.random.default_rng(3)
        feat = rng.standard_normal(corpus.y.shape + (6,)).astype(np.float32)
        corpus = dataclasses.replace(corpus, feat=feat)
    return corpus


def _steps(tree, remat: bool, gru_impl: str = "auto", block=None, hybrid: bool = False,
           dropout: float = 0.3):
    """STEPS train steps of a fresh sweep; per step the losses, every
    parameter's gradient, the batch-norm running statistics and every
    dropout generator's state, and the launches of the walks' wrappers
    (their plain versions on the CPU)."""
    cfg = _config(tree, remat, dropout, gru_impl, "hybrid_cnn_gru" if hybrid else "cnn_gru")
    corpus = _corpus(tree, hybrid)
    fb = pfs.build_fold_batch(corpus, list(SUBJECTS), cfg.val_fraction, cfg.seed)
    seeds, rngs = pfs.fold_streams(cfg.seed, len(fb.test_subjects))
    sweep = pfs.FoldSweep(corpus, fb, cfg, "cpu", init_seeds=seeds, block=block)
    idx, w = sweep.to_device(sweep.train_grid(rngs))
    record = []
    for s in range(STEPS):
        loss, _, _ = sweep.train_step(idx[:, s], w[:, s])
        record.append(dict(
            loss=loss.clone(),
            grads={n: p.grad.clone() for n, p in sweep.model.named_parameters()},
            stats={n: b.clone() for n, b in sweep.model.named_buffers() if "running" in n},
            gens=[g.get_state() for g in sweep.generators]))
    return record


def _assert_bitwise(got, want):
    for step, (g, w) in enumerate(zip(got, want)):
        assert torch.equal(g["loss"], w["loss"]), f"step {step}: losses"
        assert g["grads"].keys() == w["grads"].keys()
        for n in w["grads"]:
            assert torch.equal(g["grads"][n], w["grads"][n]), f"step {step}: grad {n}"
        for n in w["stats"]:
            assert torch.equal(g["stats"][n], w["stats"][n]), f"step {step}: {n}"
        assert len(g["gens"]) == len(w["gens"])
        for a, b in zip(g["gens"], w["gens"]):
            assert torch.equal(a, b), f"step {step}: a generator's state"


class _Counted:
    """Counts the calls of gru_cuda's forward and adjoint wrappers."""

    def __init__(self, monkeypatch):
        self.counts = dict.fromkeys(gru_cuda.launch_counts(), 0)
        for entry, wrapper in gru_cuda._WRAPPERS.items():
            def counted(*args, _w=wrapper, _e=entry, **kwargs):
                self.counts[_e] += 1
                return _w(*args, **kwargs)
            monkeypatch.setattr(gru_cuda, wrapper.__name__, counted)


@pytest.mark.parametrize("gru_impl", ["auto", "pallas", "pallas_fused"])
def test_remat_step_equals_no_remat_bitwise(tree, gru_impl, monkeypatch):
    """Three sweep steps of 4 lanes at dropout 0.3 under every kind of walk
    (the plain loop, the F-lane walks, the fused pair, all by their
    wrappers' plain versions): remat on equals remat off bit for bit; with
    remat each forward walk runs twice a step and each adjoint once."""
    counted = _Counted(monkeypatch)
    want = _steps(tree, remat=False, gru_impl=gru_impl)
    plain = dict(counted.counts)
    counted.counts.update(dict.fromkeys(counted.counts, 0))
    got = _steps(tree, remat=True, gru_impl=gru_impl)
    _assert_bitwise(got, want)
    for entry, n in counted.counts.items():
        twice = entry in ("gru_fwd", "gru_fwd_fb", "gru_bifwd")
        assert n == plain[entry] * (2 if twice else 1), (entry, n, plain[entry])
    if gru_impl != "auto":
        assert counted.counts["gru_fwd_fb"] > 0 and counted.counts["gru_bwd_fb"] > 0


def test_remat_rank_block_equals_no_remat_bitwise(tree):
    """A rank block (lanes 1-2 of 4, the generators drawing the whole
    group's masks through lane_span): remat on equals off bit for bit."""
    _assert_bitwise(_steps(tree, remat=True, gru_impl="pallas", block=(1, 3)),
                    _steps(tree, remat=False, gru_impl="pallas", block=(1, 3)))


def test_remat_hybrid_sweep_equals_no_remat_bitwise(tree):
    """A hybrid sweep (the feature branch beside the GRU): remat on equals
    off bit for bit."""
    _assert_bitwise(_steps(tree, remat=True, hybrid=True),
                    _steps(tree, remat=False, hybrid=True))


def test_remat_forward_leaves_eval_and_grads_alone(tree):
    """forward_remat gives the forward's logits, and the running statistics
    move once per call, as the plain forward moves them."""
    cfg = _config(tree, True, 0.0)
    corpus = _corpus(tree, hybrid=False)
    fb = pfs.build_fold_batch(corpus, list(SUBJECTS), cfg.val_fraction, cfg.seed)
    seeds, _ = pfs.fold_streams(cfg.seed, len(fb.test_subjects))
    a = pfs.FoldSweep(corpus, fb, cfg, "cpu", init_seeds=seeds).model.train()
    b = pfs.FoldSweep(corpus, fb, cfg, "cpu", init_seeds=seeds).model.train()
    x = torch.from_numpy(corpus.x[:, :4].copy())
    got, want = a.forward_remat(x), b(x)
    assert torch.equal(got, want)
    got.sum().backward()
    want.sum().backward()
    for (n, ga), (_, gb) in zip(a.named_buffers(), b.named_buffers()):
        assert torch.equal(ga, gb), n
    for (n, pa), (_, pb) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(pa.grad, pb.grad), n


def _jax_variables(jm, folds, seed=11):
    keys = jax.random.split(jax.random.PRNGKey(seed), folds)
    v = jax.vmap(lambda k: jm.init(k, np.zeros((2, len(CHANNELS), T), np.float32),
                                   train=False))(keys)
    return jax.tree_util.tree_map(np.asarray, dict(v))


@pytest.mark.parametrize("remat", [True, False])
def test_sweep_epoch_matches_jax_with_and_without_remat(tree, remat):
    """At dropout 0, one FoldSweep.epoch against jax.vmap(programs["epoch"])
    from the same weights on the same grid, trainer.remat the same on both
    sides: the epoch's train and validation losses within rtol 1e-4,
    accuracy, F1 and lr exactly, the parameters within atol 1e-4."""
    fields = dict(subjects=SUBJECTS, data_path=str(tree), seed=5, val_fraction=0.3,
                  channels_to_use=tuple(CHANNELS))
    model = dict(gru_hidden_size=H, cnn_out_channels=8, dropout=0.0)
    tr = dict(epochs=1, batch_size=4, learning_rate=5e-3, remat=remat)
    cfg_j = jcfg.ExperimentConfig(model=jcfg.ModelConfig(**model), **fields,
                                  trainer=jcfg.TrainerConfig(**tr))
    cfg_p = pcfg.ExperimentConfig(model=pcfg.ModelConfig(**model), **fields,
                                  trainer=pcfg.TrainerConfig(**tr))
    corpus = _corpus(tree, hybrid=False)
    fb = pfs.build_fold_batch(corpus, list(SUBJECTS), cfg_p.val_fraction, cfg_p.seed)
    folds, batch = len(fb.test_subjects), cfg_p.trainer.batch_size
    steps = [pfs.grid_steps(n, batch) for n in (fb.n_train, fb.n_val, fb.n_test)]
    jm = build_jax_model(cfg_j.model, K, fold_parallel=True)
    tx = jax_optim.make_optimizer(cfg_j.trainer.learning_rate, cfg_j.trainer.weight_decay)
    programs = jfs._make_fold_program(jm, tx, cfg_j, *steps, K)
    variables = _jax_variables(jm, folds)
    carry = jax.vmap(programs["init_carry"])(
        jax.vmap(lambda p, bs: TrainState(p, bs, tx.init(p)))(
            variables["params"], variables["batch_stats"]),
        jax.random.split(jax.random.PRNGKey(cfg_j.seed), folds))
    epoch_fn = jax.jit(jax.vmap(programs["epoch"], in_axes=(None, None, 0, 0, 0, 0, 0, 0, None)))
    grid_fn = jax.vmap(lambda r, p, n: jfs._shuffled_grid(jax.random.split(r, 3)[1], p, n,
                                                          steps[0], batch))
    x, y, _ = corpus.flat()
    idx, w = grid_fn(carry[4], fb.train_pool, fb.n_train)
    carry, want = epoch_fn(x, y, fb.train_pool, fb.n_train, fb.val_pool, fb.n_val,
                           np.ones((folds, K), np.float32), carry, 0)
    sweep = pfs.FoldSweep(corpus, fb, cfg_p, "cpu", variables=variables)
    got = sweep.epoch(np.asarray(idx), np.asarray(w), 0)
    np.testing.assert_allclose(got[0], np.asarray(want[0]), rtol=1e-4, err_msg="train loss")
    np.testing.assert_allclose(got[1], np.asarray(want[1]), rtol=1e-4, err_msg="val loss")
    for i in (2, 3, 4):
        np.testing.assert_array_equal(got[i], np.asarray(want[i]), err_msg=str(i))
    final = export_jax_variables(sweep.model)["params"]
    for path, leaf in jax.tree_util.tree_leaves_with_path(carry[0].params):
        node = final
        for k in path:
            node = node[k.key]
        np.testing.assert_allclose(node, np.asarray(leaf), rtol=0, atol=1e-4,
                                   err_msg=jax.tree_util.keystr(path))
