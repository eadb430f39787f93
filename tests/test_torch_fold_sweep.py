"""The port's sharded LOSO sweep (multimodalsignal_tpu_torch: models/fold_stack.py,
train/optim.py FoldAdam and the batched state machines, data/dataset.py
pack_corpus, parallel/fold_sweep.py, main.py's default execution) against
the JAX package's, on the CPU at small widths (H = 8, conv 8, T = 128).

Tolerances. The fold-stacked model against the single-fold port model and
against jax.vmap of the flax model: float32 atol 1e-5 (the same arithmetic
in other op orders: grouped convolutions, batched products). FoldAdam
against jax.vmap of optax's update: rtol 1e-6, atol 1e-7 (float32
round-off of a few Adam steps, as tests/test_torch_optim_metrics.py). The
sweep's epochs against jax.vmap(programs["epoch"]) from the same weights on
the same grids: losses rtol 1e-4 and parameters atol 1e-4 (float32 round-off
over a dozen Adam steps, which Adam's normalized step amplifies where a
gradient is near zero, as tests/test_torch_trainer.py); accuracy, F1, the
learning rates and the stop flags exactly.
"""

import dataclasses
import json
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from multimodalsignal_tpu import config as jcfg
from multimodalsignal_tpu.data import dataset as jdata
from multimodalsignal_tpu.models import build_model as build_jax_model
from multimodalsignal_tpu.parallel import fold_sweep as jfs
from multimodalsignal_tpu.train import optim as jax_optim
from multimodalsignal_tpu.train.checkpoints import restore_state
from multimodalsignal_tpu.train.trainer import TrainState, init_train_state
from multimodalsignal_tpu.train.trainer import cross_entropy as jax_cross_entropy
from multimodalsignal_tpu_torch import config as pcfg
from multimodalsignal_tpu_torch import main as pmain
from multimodalsignal_tpu_torch.data import dataset as pdata
from multimodalsignal_tpu_torch.experiments.predict import Predictor
from multimodalsignal_tpu_torch.models.cnn_gru import build_model
from multimodalsignal_tpu_torch.models.convert import (
    _layout,
    export_jax_variables,
    lane_variables,
    load_jax_variables,
    stack_variables,
)
from multimodalsignal_tpu_torch.models.fold_stack import FoldStackedModel, build_fold_model
from multimodalsignal_tpu_torch.parallel import fold_sweep as pfs
from multimodalsignal_tpu_torch.train import metrics, optim
from multimodalsignal_tpu_torch.train.trainer import cross_entropy

SUBJECTS = ("S2", "S3", "S4", "S5")
N_WIN = {"S2": 12, "S3": 9, "S4": 11, "S5": 10}   # ragged folds
C, T, H, K = 3, 128, 8, 2
MODEL = dict(gru_hidden_size=H, cnn_out_channels=8, dropout=0.0)
CHANNELS = ["chest_ECG", "chest_EDA", "chest_Resp"]


def write_tree(root, subjects=SUBJECTS, t=T, seed=0):
    """A preprocessed data directory (per subject X [n, t, 8] float32, raw
    labels 1-4, stress windows oscillating faster); S5's stress windows
    oscillate slower, so a fold validated on S5 sees its loss rise."""
    rng = np.random.default_rng(seed)
    root.mkdir(parents=True, exist_ok=True)
    (root / "_channel_names.txt").write_text("\n".join(pcfg.ALL_CHANNEL_NAMES) + "\n")
    tt = np.arange(t) / 128.0
    for k, sid in enumerate(subjects):
        n = N_WIN.get(sid, 10)
        y = rng.integers(1, 5, n)
        y[:3] = (1, 2, 3)
        fast, slow = (1.0, 8.0) if sid == "S5" else (8.0, 1.0)
        freq = np.where(y == 2, fast, slow)[:, None, None]
        x = np.sin(2 * np.pi * freq * tt[None, :, None]) + 0.3 * rng.standard_normal((n, t, 8))
        x[..., 4] = 2.0 + 0.5 * x[..., 4] + k
        np.save(root / f"{sid}_X.npy", x.astype(np.float32))
        np.save(root / f"{sid}_y.npy", y.astype(np.int64))
    return root


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return write_tree(tmp_path_factory.mktemp("sweep") / "data")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The sweep's thousands of small CPU ops on one intra-op thread: where
    the test workers share the cores, threaded small ops wait on each other
    (a 4 s test took 150 s so)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("mode", ["stress_binary", "amusement_binary"])
def test_pack_corpus_and_fold_batch_match_jax(mode, tree):
    """The packed corpus (ragged, the mode's keep filter) and the index
    pools, padded with each fold's own first window."""
    names = pdata.read_channel_names(tree)
    subjects = list(SUBJECTS) + ["S9"]             # S9 has no files: skipped
    got = pdata.pack_corpus(tree, subjects, CHANNELS, names, mode)
    want = jdata.pack_corpus(tree, subjects, CHANNELS, names, mode, cache=False)
    assert got.subjects == want.subjects == SUBJECTS
    np.testing.assert_array_equal(got.mask, want.mask)
    np.testing.assert_array_equal(got.y, want.y)
    np.testing.assert_allclose(got.x, want.x, rtol=0, atol=1e-5)
    assert got.x.dtype == np.float32 and got.y.dtype == np.int32
    fb = pfs.build_fold_batch(got, list(SUBJECTS), 0.3, seed=7)
    jfb = jfs.build_fold_batch(want, list(SUBJECTS), 0.3, seed=7)
    assert fb.test_subjects == jfb.test_subjects
    for name in ("train_pool", "n_train", "val_pool", "n_val", "test_pool", "n_test"):
        np.testing.assert_array_equal(getattr(fb, name), getattr(jfb, name), err_msg=name)
    pools = [np.array([5, 6, 7]), np.array([9]), np.array([], np.int64)]
    for a, b in zip(pfs._pack_pools(pools), jfs._pack_pools(pools, 3)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="No data loaded"):
        pdata.pack_corpus(tree, ["S9"], CHANNELS, names)


def test_grids():
    """shuffled_grid: the real windows once each, first, then the pool's
    padding, wrapped; sequential_grid equals the JAX package's."""
    pool = np.arange(100, 117, dtype=np.int32)
    idx, w = pfs.shuffled_grid(np.random.default_rng(0), pool, 11, steps=3, batch_size=8)
    assert idx.shape == w.shape == (3, 8) and w.sum() == 11
    flat = idx.reshape(-1)
    assert sorted(flat[:11].tolist()) == list(range(100, 111))
    assert flat[11:17].tolist() == list(range(111, 117)) and (w.reshape(-1)[11:] == 0).all()
    np.testing.assert_array_equal(flat[17:], flat[:7])
    again, _ = pfs.shuffled_grid(np.random.default_rng(0), pool, 11, 3, 8)
    np.testing.assert_array_equal(again, idx)
    for got, want in zip(pfs.sequential_grid(pool[:10], 7, 2, 8),
                         jfs._sequential_grid(jnp.asarray(pool[:10]), 7, 2, 8)):
        np.testing.assert_array_equal(got, np.asarray(want))


def _jax_fold_variables(jm, folds, seed=0, t=T):
    keys = jax.random.split(jax.random.PRNGKey(seed), folds)
    v = jax.vmap(lambda k: jm.init(k, jnp.zeros((2, C, t)), train=False))(keys)
    return jax.tree_util.tree_map(np.asarray, dict(v))


def _grads(model) -> dict:
    """The parameters' gradients in the flax layout."""
    return {"/".join(path): transform(t.grad).numpy()
            for coll, path, t, transform in _layout(model) if coll == "params"}


@pytest.mark.parametrize("gru_impl,single_impl", [
    ("auto", "auto"), ("pallas", "cuda"), ("pallas_db", "cuda")])
def test_fold_model_lanes_match_single_fold_models(gru_impl, single_impl):
    """Lane f of a FoldStackedModel against the single-fold port model with
    fold f's weights: eval logits, train-mode logits, every gradient and
    the new BN statistics (the CUDA impls run their kernels' plain versions
    here); a fold outside `update` keeps its statistics."""
    folds, batch = 3, 4
    cfg = pcfg.ModelConfig(gru_impl=single_impl, reduction_ratio=1, **MODEL)
    singles = []
    for f in range(folds):
        torch.manual_seed(f)
        singles.append(build_model(cfg, K, C))
    fm = FoldStackedModel(singles, gru_impl)
    x = np.random.default_rng(1).standard_normal((folds, batch, C, T)).astype(np.float32)
    y = torch.tensor([[0, 1, 1, 0], [1, 1, 0, 0], [0, 0, 1, 1]])
    w = torch.ones(folds, batch)
    fm.eval()
    with torch.inference_mode():
        got = fm(torch.from_numpy(x))
        for f, m in enumerate(singles):
            m.eval()
            torch.testing.assert_close(got[f], m(torch.from_numpy(x[f])), rtol=0, atol=1e-5)
    fm.train()
    update = torch.tensor([True, False, True])
    stats_before = fm.cnn_encoder.bn1.running_mean.clone()
    loss, wsum = cross_entropy(fm(torch.from_numpy(x), update=update), y, w)
    loss.sum().backward()
    got_grads = _grads(fm)
    torch.testing.assert_close(fm.cnn_encoder.bn1.running_mean[1], stats_before[1],
                               rtol=0, atol=0)
    for f, m in enumerate(singles):
        m.train()
        want, _ = cross_entropy(m(torch.from_numpy(x[f])), y[f], w[f])
        want.backward()
        torch.testing.assert_close(loss[f], want.detach(), rtol=0, atol=1e-5)
        for name, g in _grads(m).items():
            np.testing.assert_allclose(got_grads[name][f], g, rtol=1e-4, atol=1e-5,
                                       err_msg=name)
        if update[f]:
            for key, value in export_jax_variables(m)["batch_stats"]["cnn_encoder"].items():
                for stat in ("mean", "var"):
                    np.testing.assert_allclose(
                        lane_variables(export_jax_variables(fm), f)["batch_stats"]
                        ["cnn_encoder"][key][stat], value[stat], rtol=0, atol=1e-6)
    assert float(wsum.sum()) == folds * batch


def test_fold_model_bfloat16_lanes_match_single_fold_models():
    """bfloat16: lane by lane against the port's own single-fold model
    (float32 logits within 3e-2: bf16 rounding in other op orders)."""
    cfg = pcfg.ModelConfig(dtype="bfloat16", gru_impl="pallas", **MODEL)
    fm = build_fold_model(cfg, K, C, 2, seeds=[3, 4])
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((2, 4, C, T)).astype(np.float32))
    fm.eval()
    with torch.inference_mode():
        got = fm(x)
        for f in range(2):
            m = build_model(dataclasses.replace(cfg, gru_impl="cuda"), K, C)
            load_jax_variables(m, **lane_variables(export_jax_variables(fm), f))
            m.eval()
            assert got.dtype == torch.float32
            torch.testing.assert_close(got[f], m(x[f]), rtol=0, atol=3e-2)


def test_fold_model_matches_jax_vmap():
    """FoldStackedModel (auto: the plain loop on CPU) against jax.vmap of
    the flax model (fold_parallel: scan) on the same stacked weights: eval
    logits, train-mode per-fold losses, every gradient and the new BN
    statistics."""
    folds, batch = 3, 5
    jm = build_jax_model(jcfg.ModelConfig(**MODEL), K, fold_parallel=True)
    variables = _jax_fold_variables(jm, folds)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((folds, batch, C, T)).astype(np.float32)
    y = rng.integers(0, K, (folds, batch)).astype(np.int32)
    w = np.ones((folds, batch), np.float32)
    w[1, 3:] = 0.0

    def loss_fn(p, bs, xb, yb, wb):
        logits, new = jm.apply({"params": p, "batch_stats": bs}, xb, train=True,
                               mutable=["batch_stats"])
        return jax_cross_entropy(logits, yb, wb)[0], new["batch_stats"]

    (want_loss, want_stats), want_grads = jax.vmap(
        jax.value_and_grad(loss_fn, has_aux=True))(
            variables["params"], variables["batch_stats"], x, y, w)
    want_logits = jax.vmap(lambda v, xb: jm.apply(v, xb, train=False))(variables, x)

    fm = build_fold_model(pcfg.ModelConfig(**MODEL), K, C, folds)
    load_jax_variables(fm, variables["params"], variables["batch_stats"])
    fm.eval()
    with torch.inference_mode():
        np.testing.assert_allclose(fm(torch.from_numpy(x)).numpy(), np.asarray(want_logits),
                                   rtol=0, atol=1e-5)
    fm.train()
    loss, _ = cross_entropy(fm(torch.from_numpy(x)), torch.from_numpy(y).long(),
                            torch.from_numpy(w))
    loss.sum().backward()
    np.testing.assert_allclose(loss.detach().numpy(), np.asarray(want_loss), rtol=1e-5)
    got = _grads(fm)
    for path, g in jax.tree_util.tree_leaves_with_path(want_grads):
        name = "/".join(k.key for k in path)
        np.testing.assert_allclose(got[name], np.asarray(g), rtol=1e-4, atol=1e-5,
                                   err_msg=name)
    stats = export_jax_variables(fm)["batch_stats"]["cnn_encoder"]
    for bn in ("bn1", "bn2"):
        for s in ("mean", "var"):
            np.testing.assert_allclose(stats[bn][s], np.asarray(want_stats["cnn_encoder"][bn][s]),
                                       rtol=0, atol=1e-5)


@pytest.mark.parametrize("dtype,tol", [("float32", None), ("bfloat16", 2e-2)])
def test_fold_model_pallas_fused_matches_jax_vmap(dtype, tol):
    """gru_impl="pallas_fused" under the fold axis: every fold's two
    directions as 2F lanes of the fused pair (its plain versions here; the
    pruned last layer F lanes of the fb walk) against jax.vmap of the flax
    model built with pallas_fused and fold_parallel=True (interpret-mode
    Pallas: Pallas's batching rule walks each fold's two lanes), on the same
    stacked weights: eval logits, train-mode per-fold losses, every gradient
    and the new BN statistics. float32 at the tolerances of
    test_fold_model_matches_jax_vmap; bfloat16 atol 2e-2 (bf16 rounding in
    other op orders; the fused layer itself runs in float32 on both sides).
    T = 64 keeps the interpret-mode walks short."""
    folds, batch, t = 3, 5, 64
    fields = dict(MODEL, gru_impl="pallas_fused", dtype=dtype)
    jm = build_jax_model(jcfg.ModelConfig(**fields), K, fold_parallel=True)
    variables = _jax_fold_variables(jm, folds, t=t)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((folds, batch, C, t)).astype(np.float32)
    y = rng.integers(0, K, (folds, batch)).astype(np.int32)
    w = np.ones((folds, batch), np.float32)
    w[1, 3:] = 0.0

    def loss_fn(p, bs, xb, yb, wb):
        logits, new = jm.apply({"params": p, "batch_stats": bs}, xb, train=True,
                               mutable=["batch_stats"])
        return jax_cross_entropy(logits, yb, wb)[0], new["batch_stats"]

    (want_loss, want_stats), want_grads = jax.vmap(
        jax.value_and_grad(loss_fn, has_aux=True))(
            variables["params"], variables["batch_stats"], x, y, w)
    want_logits = jax.vmap(lambda v, xb: jm.apply(v, xb, train=False))(variables, x)

    fm = build_fold_model(pcfg.ModelConfig(**fields), K, C, folds)
    assert fm.impl == "fused"
    load_jax_variables(fm, variables["params"], variables["batch_stats"])
    logit_tol = dict(rtol=0, atol=tol or 1e-5)
    fm.eval()
    with torch.inference_mode():
        np.testing.assert_allclose(fm(torch.from_numpy(x)).numpy(), np.asarray(want_logits),
                                   **logit_tol)
    fm.train()
    loss, _ = cross_entropy(fm(torch.from_numpy(x)), torch.from_numpy(y).long(),
                            torch.from_numpy(w))
    loss.sum().backward()
    np.testing.assert_allclose(loss.detach().numpy(), np.asarray(want_loss),
                               **(dict(rtol=1e-5) if tol is None else logit_tol))
    got = _grads(fm)
    grad_tol = dict(rtol=1e-4, atol=1e-5) if tol is None else logit_tol
    for path, g in jax.tree_util.tree_leaves_with_path(want_grads):
        name = "/".join(k.key for k in path)
        np.testing.assert_allclose(got[name], np.asarray(g), **grad_tol, err_msg=name)
    stats = export_jax_variables(fm)["batch_stats"]["cnn_encoder"]
    for bn in ("bn1", "bn2"):
        for s in ("mean", "var"):
            np.testing.assert_allclose(stats[bn][s], np.asarray(want_stats["cnn_encoder"][bn][s]),
                                       rtol=0, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fold_model_pallas_fused_lanes_match_single_fold_models(dtype):
    """Lane f of a pallas_fused FoldStackedModel (2F lanes of the fused
    pair) against the single-fold port model with cuda_fused (the pair's
    two lanes) and fold f's weights: eval logits, float32 within 1e-5,
    bfloat16 within 3e-2 (as test_fold_model_bfloat16_lanes_match_single_fold_models)."""
    cfg = pcfg.ModelConfig(gru_impl="pallas_fused", dtype=dtype, **MODEL)
    fm = build_fold_model(cfg, K, C, 3, seeds=[3, 4, 5])
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((3, 4, C, T)).astype(np.float32))
    fm.eval()
    with torch.inference_mode():
        got = fm(x)
        for f in range(3):
            m = build_model(dataclasses.replace(cfg, gru_impl="cuda_fused"), K, C)
            load_jax_variables(m, **lane_variables(export_jax_variables(fm), f))
            m.eval()
            torch.testing.assert_close(got[f], m(x[f]).float(), rtol=0,
                                       atol=1e-5 if dtype == "float32" else 3e-2)


def test_fold_adam_matches_optax_vmap():
    """FoldAdam against jax.vmap of make_optimizer's update with a learning
    rate per fold and an update mask per fold: a masked fold keeps its
    parameters, moments and count (fold 1 is masked at the first step)."""
    folds = 3
    rng = np.random.default_rng(1)
    w0 = rng.standard_normal((folds, 6, 4)).astype(np.float32)
    b0 = rng.standard_normal((folds, 4)).astype(np.float32)
    lr, wd = 1e-3, 1e-4
    masks = [[1, 0, 1], [1, 1, 1], [0, 1, 1], [1, 1, 0], [1, 0, 1], [1, 1, 1]]
    lrs = {3: [1e-4, 1e-3, 5e-4]}
    pw = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    pb = torch.nn.Parameter(torch.from_numpy(b0.copy()))
    opt = optim.FoldAdam([pw, pb], lr, wd)
    tx = jax_optim.make_optimizer(lr, wd)
    params = {"w": jnp.asarray(w0), "b": jnp.asarray(b0)}
    state = jax.vmap(tx.init)(params)
    for step, mask in enumerate(masks):
        gw = rng.standard_normal(w0.shape).astype(np.float32)
        gb = rng.standard_normal(b0.shape).astype(np.float32)
        if step in lrs:
            lr_f = np.asarray(lrs[step], np.float32)
            state.hyperparams["learning_rate"] = jnp.asarray(lr_f)
            opt.lr.copy_(torch.from_numpy(lr_f))
        updates, new_state = jax.vmap(tx.update)({"w": jnp.asarray(gw), "b": jnp.asarray(gb)},
                                                 state, params)
        new_params = jax.vmap(optax.apply_updates)(params, updates)
        m = jnp.asarray(mask, bool)
        params, state = jax.tree_util.tree_map(
            lambda n, o: jnp.where(m.reshape((-1,) + (1,) * (n.ndim - 1)), n, o),
            (new_params, new_state), (params, state))
        pw.grad, pb.grad = torch.from_numpy(gw), torch.from_numpy(gb)
        opt.step(torch.tensor(mask, dtype=torch.bool))
    np.testing.assert_array_equal(opt.count.numpy(), np.asarray(state.count))
    assert opt.count.tolist() == [5, 4, 5]
    np.testing.assert_array_equal(opt.lr.numpy(), np.asarray(state.hyperparams["learning_rate"]))
    assert opt.sizes == [24, 4] and opt.mu.shape == opt.nu.shape == (folds, 28)
    mu_w, mu_b = opt.mu.split(opt.sizes, dim=1)
    nu_w, nu_b = opt.nu.split(opt.sizes, dim=1)
    inner = state.inner_state[1]
    for got, want in ((pw, params["w"]), (pb, params["b"]), (mu_w.reshape(w0.shape), inner.mu["w"]),
                      (mu_b, inner.mu["b"]), (nu_w.reshape(w0.shape), inner.nu["w"]),
                      (nu_b, inner.nu["b"])):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)


LOSSES = np.array([[1.0, 0.5, 0.7], [0.9, 0.5, 0.7], [0.95, 0.49995, 0.69],
                   [0.9, 0.4, 0.69], [0.91, 0.4, 0.8], [0.5, 0.45, 0.8],
                   [0.5, 0.5, 0.2], [0.6, 0.5, 0.2]], np.float32)


@pytest.mark.parametrize("legacy_inverted", [False, True])
def test_batched_state_machines_match_jax_vmap(legacy_inverted):
    """plateau_update and early_stopping_update over [F] against jax.vmap
    of the JAX machines, on per-fold sequences with ties."""
    folds = LOSSES.shape[1]
    jp = jax.tree_util.tree_map(lambda a: jnp.broadcast_to(a, (folds,)),
                                jax_optim.plateau_init(1e-3))
    je = jax.tree_util.tree_map(lambda a: jnp.broadcast_to(a, (folds,)),
                                jax_optim.early_stopping_init())
    pp, pe = optim.plateau_init(1e-3, folds), optim.early_stopping_init(folds)
    for epoch, loss in enumerate(LOSSES):
        jp = jax.vmap(partial(jax_optim.plateau_update, factor=0.1, patience=1))(jp, loss)
        pp = optim.plateau_update(pp, loss, factor=0.1, patience=1)
        je = jax.vmap(partial(jax_optim.early_stopping_update, patience=3, delta=0.01,
                              legacy_inverted=legacy_inverted),
                      in_axes=(0, 0, None))(je, loss, epoch)
        pe = optim.early_stopping_update(pe, loss, epoch, patience=3, delta=0.01,
                                         legacy_inverted=legacy_inverted)
        for got, want in zip(tuple(pp) + tuple(pe), tuple(jp) + tuple(je)):
            np.testing.assert_array_equal(got, np.asarray(want))
    assert pe.should_stop.any() and len(set(pp.lr.tolist())) > 1


def test_batched_metrics_match_per_lane():
    rng = np.random.default_rng(0)
    yt = torch.from_numpy(rng.integers(0, 3, (4, 20)))
    yp = torch.from_numpy(rng.integers(0, 3, (4, 20)))
    mask = torch.from_numpy((rng.random((4, 20)) > 0.3).astype(np.float32))
    mask[2] = 0
    cm = metrics.confusion_matrix(yt, yp, 3, mask)
    for f in range(4):
        one = metrics.confusion_matrix(yt[f], yp[f], 3, mask[f])
        torch.testing.assert_close(cm[f], one, rtol=0, atol=0)
        for fn in (metrics.accuracy_from_cm, metrics.weighted_f1_from_cm):
            assert float(fn(cm)[f]) == float(fn(one))


def _sweep_configs(data, gru_impl="auto", **trainer):
    fields = dict(subjects=SUBJECTS, data_path=str(data), seed=5, val_fraction=0.3,
                  channels_to_use=tuple(CHANNELS))
    tr = dict(dict(epochs=3, batch_size=4, learning_rate=5e-3, lr_plateau_patience=0),
              **trainer)
    return (jcfg.ExperimentConfig(
                model=jcfg.ModelConfig(gru_impl=gru_impl, **MODEL), **fields,
                trainer=jcfg.TrainerConfig(early_stopping=jcfg.EarlyStoppingConfig(patience=1),
                                           **tr)),
            pcfg.ExperimentConfig(
                model=pcfg.ModelConfig(gru_impl=gru_impl, **MODEL), **fields,
                trainer=pcfg.TrainerConfig(early_stopping=pcfg.EarlyStoppingConfig(patience=1),
                                           **tr)))


def test_sweep_epochs_and_finalize_match_jax(tree):
    """Three epochs of FoldSweep.epoch against jax.jit(jax.vmap(programs
    ["epoch"])) from the JAX package's initial carry, each epoch on the grid
    that JAX's _shuffled_grid draws from the carry's rng, then finalize: per
    epoch losses, accuracy, F1, lr and whether each fold still trained; the
    parameters after; the test loss, confusion matrix, best epoch and
    probabilities."""
    _check_sweep_matches_jax(tree, "auto")


def test_fused_sweep_epochs_and_finalize_match_jax(tree):
    """The same with gru_impl="pallas_fused" on both sides: the port's
    fused pair at 2F lanes (plain versions) against the JAX sweep's
    vmapped interpret-mode fused kernels, at the same tolerances."""
    _check_sweep_matches_jax(tree, "pallas_fused")


def _check_sweep_matches_jax(tree, gru_impl: str) -> None:
    cfg_j, cfg_p = _sweep_configs(tree, gru_impl=gru_impl)
    names = pdata.read_channel_names(tree)
    corpus = pdata.pack_corpus(tree, list(SUBJECTS), CHANNELS, names)
    fb = pfs.build_fold_batch(corpus, list(SUBJECTS), cfg_p.val_fraction, cfg_p.seed)
    folds, batch = len(fb.test_subjects), cfg_p.trainer.batch_size
    steps = [pfs.grid_steps(n, batch) for n in (fb.n_train, fb.n_val, fb.n_test)]
    jm = build_jax_model(cfg_j.model, K, fold_parallel=True)
    tx = jax_optim.make_optimizer(cfg_j.trainer.learning_rate, cfg_j.trainer.weight_decay)
    programs = jfs._make_fold_program(jm, tx, cfg_j, *steps, K)
    variables = _jax_fold_variables(jm, folds, seed=11)
    run_rngs = jax.random.split(jax.random.PRNGKey(cfg_j.seed), folds)
    carry = jax.vmap(programs["init_carry"])(
        jax.vmap(lambda p, bs: TrainState(p, bs, tx.init(p)))(
            variables["params"], variables["batch_stats"]), run_rngs)
    epoch_fn = jax.jit(jax.vmap(programs["epoch"], in_axes=(None, None, 0, 0, 0, 0, 0, 0, None)))
    x, y, _ = corpus.flat()
    pools = (fb.train_pool, fb.n_train, fb.val_pool, fb.n_val)
    cw = np.ones((folds, K), np.float32)
    grid_fn = jax.vmap(lambda r, p, n: jfs._shuffled_grid(jax.random.split(r, 3)[1], p, n,
                                                          steps[0], batch))
    sweep = pfs.FoldSweep(corpus, fb, cfg_p, "cpu", variables=variables)
    stops, lrs = [], []
    for epoch in range(cfg_p.trainer.epochs):
        idx, w = grid_fn(carry[4], fb.train_pool, fb.n_train)
        carry, want = epoch_fn(x, y, *pools, cw, carry, epoch)
        got = sweep.epoch(np.asarray(idx), np.asarray(w), epoch)
        np.testing.assert_allclose(got[0], np.asarray(want[0]), rtol=1e-4, err_msg="train loss")
        np.testing.assert_allclose(got[1], np.asarray(want[1]), rtol=1e-4, err_msg="val loss")
        for i in (2, 3, 4, 5):
            np.testing.assert_array_equal(got[i], np.asarray(want[i]), err_msg=str(i))
        np.testing.assert_array_equal(sweep.stopped, np.asarray(carry[5]))
        stops.append(sweep.stopped.copy())
        lrs.append(got[4])
    assert stops[1].any() and not stops[-1].all(), "no fold stopped, or every fold did"
    assert len(set(np.concatenate(lrs).tolist())) > 1, "the plateau never changed an lr"
    final = export_jax_variables(sweep.model)["params"]
    for path, want in jax.tree_util.tree_leaves_with_path(carry[0].params):
        node = final
        for k in path:
            node = node[k.key]
        np.testing.assert_allclose(node, np.asarray(want), rtol=0, atol=1e-4,
                                   err_msg=jax.tree_util.keystr(path))
    finalize = jax.jit(jax.vmap(programs["finalize"], in_axes=(None, None, 0, 0, 0, 0)))
    t_loss, t_cm, best, _, _, probs = finalize(x, y, fb.test_pool, fb.n_test, cw, carry)
    got = sweep.finalize()
    np.testing.assert_allclose(got[0], np.asarray(t_loss), rtol=1e-4)
    np.testing.assert_array_equal(got[1], np.asarray(t_cm))
    np.testing.assert_array_equal(got[2], np.asarray(best))
    np.testing.assert_allclose(got[3], np.asarray(probs), rtol=0, atol=1e-4)


@pytest.mark.parametrize("dispatch", ["per_epoch", "segmented"])
def test_run_fold_sweep_ends_once_every_fold_stopped(dispatch, tree):
    """run_fold_sweep, whichever sweep_dispatch the config names, against
    FoldSweep driven epoch by epoch with the same streams: the same history,
    stop epochs and test results, the loop ended at the epoch after which
    every fold had stopped, and the history zero beyond it."""
    _, cfg = _sweep_configs(tree, epochs=8)
    es = dataclasses.replace(cfg.trainer.early_stopping, delta=0.05)
    cfg = dataclasses.replace(cfg, sweep_dispatch=dispatch, sweep_segment_epochs=4,
                              trainer=dataclasses.replace(cfg.trainer, early_stopping=es))
    names = pdata.read_channel_names(tree)
    corpus = pdata.pack_corpus(tree, list(SUBJECTS), CHANNELS, names)
    fb = pfs.build_fold_batch(corpus, list(SUBJECTS), cfg.val_fraction, cfg.seed)
    got = pfs.run_fold_sweep(corpus, fb, cfg, "cpu")
    seeds, rngs = pfs.fold_streams(cfg.seed, len(fb.test_subjects))
    sweep = pfs.FoldSweep(corpus, fb, cfg, "cpu", init_seeds=seeds)
    logs = []
    while len(logs) < cfg.trainer.epochs and not sweep.stopped.all():
        logs.append(sweep.epoch(*sweep.train_grid(rngs), len(logs)))
    assert sweep.stopped.all() and len(logs) < cfg.trainer.epochs, "the sweep ran to its end"
    ran = len(logs)
    for i, name in enumerate(pfs.SweepHistory._fields):
        np.testing.assert_array_equal(getattr(got.history, name)[:, :ran],
                                      np.stack([log[i] for log in logs], axis=1), err_msg=name)
        assert not getattr(got.history, name)[:, ran:].any(), name
    np.testing.assert_array_equal(got.stop_epoch, np.stack([log[5] for log in logs]).sum(axis=0))
    assert got.stop_epoch.max() == ran and got.stop_epoch.min() < ran, "no fold coasted"
    for name, want in zip(("test_loss", "test_cm", "best_epoch", "test_probs"), sweep.finalize()):
        np.testing.assert_array_equal(getattr(got, name), want, err_msg=name)


def test_run_fold_sweep_refuses_an_unknown_dispatch(tree):
    _, cfg = _sweep_configs(tree)
    names = pdata.read_channel_names(tree)
    corpus = pdata.pack_corpus(tree, list(SUBJECTS), CHANNELS, names)
    fb = pfs.build_fold_batch(corpus, list(SUBJECTS), cfg.val_fraction, cfg.seed)
    with pytest.raises(ValueError, match="sweep_dispatch"):
        pfs.run_fold_sweep(corpus, fb, dataclasses.replace(cfg, sweep_dispatch="fused"), "cpu")


def test_main_runs_the_sweep_by_default_and_jax_reads_its_checkpoints(tree, tmp_path, capsys):
    """`main` with no --execution at --device cpu: the sharded sweep's run
    directory (config.json, cv_summary.txt; per fold training_log.txt,
    test_probs.npy trimmed to the fold's test windows, best_model.msgpack),
    each checkpoint read by the JAX package's restore_state with the
    optimizer state tx.init gives, its weights those of the port's
    Predictor for that fold."""
    pmain.main(["--device", "cpu", "--output-dir", str(tmp_path / "out"),
                "--set", f"data_path={tree}", "--set", "subjects=" + ",".join(SUBJECTS),
                "--set", "model.gru_hidden_size=8", "--set", "model.cnn_out_channels=8",
                "--set", "trainer.epochs=2", "--set", "trainer.batch_size=4",
                "--set", "trainer.learning_rate=0.002"])
    (run_dir,) = (tmp_path / "out" / "simple_binary").iterdir()
    out = capsys.readouterr().out
    assert "Sharded LOSO sweep: 4 folds" in out
    cfg = jcfg.config_from_dict(jcfg.ExperimentConfig,
                                json.loads((run_dir / "config.json").read_text()))
    assert cfg.fold_execution == "sharded" and cfg.subjects == SUBJECTS
    summary = (run_dir / "cv_summary.txt").read_text()
    assert summary.count("  - test S") == 4 and "Mean weighted F1" in summary
    jm = build_jax_model(cfg.model, K)
    tx = jax_optim.make_optimizer(cfg.trainer.learning_rate, cfg.trainer.weight_decay)
    template = init_train_state(jm, jax.random.PRNGKey(0), jnp.zeros((1, C, T)), tx)
    x = np.random.default_rng(3).standard_normal((5, C, T)).astype(np.float32)
    apply = jax.jit(lambda p, bs: jax.nn.softmax(
        jm.apply({"params": p, "batch_stats": bs}, jnp.asarray(x), train=False)))
    for sid in SUBJECTS:
        fold = run_dir / f"fold_test_on_{sid}"
        log = (fold / "training_log.txt").read_text()
        assert "Epoch 2 |" in log and "Final test results" in log
        probs = np.load(fold / "test_probs.npy")
        assert probs.shape == (N_WIN[sid], K)
        np.testing.assert_allclose(probs.sum(axis=1), 1.0, rtol=1e-5)
        state = restore_state(fold / "best_model.msgpack", template)
        assert int(state.opt_state.count) == 0
        assert float(state.opt_state.hyperparams["learning_rate"]) == np.float32(0.002)
        assert not np.asarray(state.opt_state.inner_state[1].mu["head2"]["kernel"]).any()
        want = apply(state.params, state.batch_stats)
        got = Predictor.from_run(run_dir, sid, device="cpu").predict_windows(x)
        np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-5)


def test_main_profile_dir_and_checkpoints(tree, tmp_path, capsys):
    """`main --profile-dir D` (the JAX CLI's flag) runs the sharded sweep
    under torch.profiler and writes a Chrome trace into D; with
    --set trainer.checkpoint_every=1 the run directory holds the sweep's
    resume bundle after its last epoch."""
    trace_dir = tmp_path / "trace"
    pmain.main(["--device", "cpu", "--output-dir", str(tmp_path / "out"),
                "--profile-dir", str(trace_dir),
                "--set", f"data_path={tree}", "--set", "subjects=" + ",".join(SUBJECTS),
                "--set", "model.gru_hidden_size=8", "--set", "model.cnn_out_channels=8",
                "--set", "trainer.epochs=1", "--set", "trainer.batch_size=4",
                "--set", "trainer.checkpoint_every=1"])
    assert f"Profiler trace written to: {trace_dir}" in capsys.readouterr().out
    events = json.loads((trace_dir / "sweep_trace.json").read_text())["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any(n.startswith("aten::") for n in names), sorted(names)[:20]
    (run_dir,) = (tmp_path / "out").glob("*/run_*")
    meta = json.loads((run_dir / "sweep_resume_meta.json").read_text())
    assert meta == {"next_epoch": 1} and (run_dir / "sweep_resume.msgpack").exists()


def test_main_default_asks_for_cuda(tmp_path):
    """Without --device cpu the default (sharded) run raises where there is
    no CUDA, before it makes a run directory."""
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without CUDA")
    with pytest.raises(RuntimeError, match="cuda"):
        pmain.main(["--output-dir", str(tmp_path)])
    assert not any(tmp_path.iterdir())


def test_what_the_sweep_does_not_port_is_refused(tree, tmp_path):
    """From-pickles and hybrid staging are ported
    (tests/test_torch_from_pickles.py, tests/test_torch_hybrid.py), and
    refused together, as in the JAX package; a sweep of pickles that are
    not there is refused. (pallas_fused under the fold axis is ported:
    test_fold_model_pallas_fused_matches_jax_vmap; the sweep's resume too:
    tests/test_torch_resume.py.)"""
    _, base = _sweep_configs(tree)
    with pytest.raises(ValueError, match="No pickles loaded"):
        pfs.run_sharded_experiment(dataclasses.replace(base, from_pickles=str(tmp_path / "w")),
                                   tmp_path / "p", device="cpu")
    hybrid = dataclasses.replace(base, raw_align_path="a", feature_path="b",
                                 model=dataclasses.replace(base.model, name="hybrid_cnn_gru"))
    with pytest.raises(ValueError, match="does not support hybrid_cnn_gru"):
        pfs.run_sharded_experiment(dataclasses.replace(hybrid, from_pickles="WESAD"),
                                   tmp_path / "h", device="cpu")
    assert not (tmp_path / "h").exists()


def test_stack_and_lane_variables_round_trip():
    """stack_variables then lane_variables gives each fold's pair back, and
    a FoldStackedModel of single-fold models exports their stack."""
    cfg = pcfg.ModelConfig(**MODEL)
    singles = [build_model(cfg, K, C) for _ in range(3)]
    per_fold = [export_jax_variables(m) for m in singles]
    stacked = export_jax_variables(FoldStackedModel(singles))
    again = stack_variables(per_fold)
    for f, want in enumerate(per_fold):
        for coll in ("params", "batch_stats"):
            for (_, a), (_, b), (_, c) in zip(
                    jax.tree_util.tree_leaves_with_path(lane_variables(stacked, f)[coll]),
                    jax.tree_util.tree_leaves_with_path(want[coll]),
                    jax.tree_util.tree_leaves_with_path(lane_variables(again, f)[coll])):
                np.testing.assert_array_equal(a, b)
                np.testing.assert_array_equal(np.asarray(c), b)
