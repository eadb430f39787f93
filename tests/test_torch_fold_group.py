"""Fold grouping (MMS_GRU_FOLD_GROUP) in the port, on the CPU: G folds walk
as one lane of width G·H with a block-diagonal W (gru_cuda.gru_lanes_cuda,
the counterpart of the grouped branches of the custom_vmap rules in
multimodalsignal_tpu/ops/gru_pallas.py). The port's wrappers run their
plain versions at H' = G·H here; the JAX side runs its Pallas kernels in
interpret mode under jax.vmap, grouping as its rule does with the variable
set (monkeypatch), as tests/test_gru_pallas.py's fold-batched tests do.

Tolerances: grouped against JAX's grouped path, forward and every gradient,
rtol 1e-4 / atol 1e-5 (the zero blocks join each step's product in another
summation order, as that JAX test states); a lane count with no group
(F=5) bitwise equal to the ungrouped port; a grouped sweep against the
ungrouped one: losses rtol 1e-4 and parameters within 1e-5 (float32
round-off of a few Adam steps)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodalsignal_tpu.ops import gru_pallas
from multimodalsignal_tpu_torch import config as pcfg
from multimodalsignal_tpu_torch.data import dataset as pdata
from multimodalsignal_tpu_torch.models.fold_stack import build_fold_model
from multimodalsignal_tpu_torch.ops import gru_cuda
from multimodalsignal_tpu_torch.parallel import fold_sweep as pfs
from tests.test_torch_fold_sweep import CHANNELS, SUBJECTS, _sweep_configs, write_tree

T, B, H = 11, 3, 8
GROUP = "4"


def _inputs(seed: int, folds: int):
    rng = np.random.default_rng(seed)
    xg = rng.standard_normal((folds, B, T, 3 * H)).astype(np.float32)
    w = (rng.standard_normal((folds, 3 * H, H)) * 0.3).astype(np.float32)
    b = (rng.standard_normal((folds, 3 * H)) * 0.1).astype(np.float32)
    h0 = (rng.standard_normal((folds, B, H)) * 0.5).astype(np.float32)
    return xg, w, b, h0


def _jax(arrays, reverse: bool):
    """jax.vmap of gru_sequence_pallas over the folds (its custom_vmap rule
    groups them when the variable says so): ys [F, B, T, H] and the
    gradients of sum(ys^2) per fold."""
    def run(a, w, c, d):
        return gru_pallas.gru_sequence_pallas(a, w, c, d, reverse=reverse)

    def loss(a, w, c, d):
        return jnp.sum(run(a, w, c, d) ** 2)

    args = tuple(jnp.asarray(a) for a in arrays)
    ys = jax.jit(jax.vmap(run))(*args)
    grads = jax.jit(jax.vmap(jax.grad(loss, argnums=(0, 1, 2, 3))))(*args)
    return [np.asarray(ys)] + [np.asarray(g) for g in grads]


def _port(arrays, reverse: bool):
    """gru_lanes_cuda on the time-major view of the same inputs: ys [F, B,
    T, H] and the gradients of sum(ys^2) (the lanes are independent, so
    each fold's gradient is its own loss's)."""
    xg, w, b, h0 = (torch.from_numpy(a).requires_grad_() for a in arrays)
    ys = gru_cuda.gru_lanes_cuda(xg.transpose(1, 2), w, b, h0, reverse=reverse)
    ys.square().sum().backward()
    return [ys.transpose(1, 2).detach().numpy()] + [t.grad.numpy() for t in (xg, w, b, h0)]


@pytest.fixture
def walks(monkeypatch):
    """(entry, lanes, H) of every walk launched through the wrappers (their
    plain versions, on the CPU)."""
    seen = []
    for name, entry in (("gru_forward_fb", "gru_fwd_fb"), ("gru_backward_fb", "gru_bwd_fb"),
                        ("gru_bifwd", "gru_bifwd"), ("gru_bibwd", "gru_bibwd")):
        fn = getattr(gru_cuda, name)

        def call(xg, *args, _fn=fn, _entry=entry, **kwargs):
            lanes = xg.shape[1] if _entry.startswith("gru_bi") else xg.shape[0]
            seen.append((_entry, lanes, xg.shape[-1] // 3))
            return _fn(xg, *args, **kwargs)

        monkeypatch.setattr(gru_cuda, name, call)
    return seen


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("folds,group", [(4, 4), (6, 3), (5, 1)])
def test_grouped_lanes_match_jax_grouped_path(folds, group, reverse, monkeypatch, walks):
    """With MMS_GRU_FOLD_GROUP=4, F=4 walks as one lane of 4·H, F=6 as two
    of 3·H (no group of 4 divides it), F=5 ungrouped; ys and the gradients
    of xg, W_hh, b_hh and h0 match the JAX package's vmapped path, which
    groups the same way."""
    monkeypatch.setenv("MMS_GRU_FOLD_GROUP", GROUP)
    assert gru_cuda.pick_group(folds) == group
    arrays = _inputs(folds + int(reverse), folds)
    want = _jax(arrays, reverse)
    got = _port(arrays, reverse)
    for name, g, w in zip(("ys", "dxg", "dW_hh", "db_hh", "dh0"), got, want):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5, err_msg=name)
    assert set(walks) == {("gru_fwd_fb", folds // group, group * H),
                          ("gru_bwd_fb", folds // group, group * H)}


def test_no_group_is_bitwise_the_ungrouped_walk(monkeypatch):
    """F=5 has no divisor up to 4: with the variable set the port's forward
    and gradients are bitwise its own without it."""
    arrays = _inputs(9, 5)
    monkeypatch.delenv("MMS_GRU_FOLD_GROUP", raising=False)
    plain = _port(arrays, False)
    monkeypatch.setenv("MMS_GRU_FOLD_GROUP", GROUP)
    grouped = _port(arrays, False)
    for a, b in zip(grouped, plain):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("value,lanes,group", [
    (None, 15, 1), ("1", 15, 1), ("0", 4, 1), ("2", 15, 1), ("2", 4, 2), ("3", 15, 3),
    ("3", 60, 3), ("4", 60, 4), ("4", 15, 3), ("4", 6, 3), ("4", 5, 1), ("8", 8, 8),
    ("8", 12, 4)])
def test_pick_group_follows_jax(value, lanes, group, monkeypatch):
    """pick_group is _pick_group: 1 unless the variable is at least 2, then
    the first of (its value, 4, 3, 2) no larger than it that divides the
    lanes."""
    if value is None:
        monkeypatch.delenv("MMS_GRU_FOLD_GROUP", raising=False)
    else:
        monkeypatch.setenv("MMS_GRU_FOLD_GROUP", value)
    assert gru_cuda.pick_group(lanes) == gru_pallas._pick_group(lanes) == group


def test_regrouping_round_trips_and_blockdiag_holds_each_fold():
    """_group_cols/_ungroup_cols and _group_h/_ungroup_h are inverses and
    equal the JAX package's; _blockdiag_w puts each fold's W on the
    diagonal, gate-major, zeros elsewhere, as _blockdiag_w does there."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((6, 2, 5, 3 * H)).astype(np.float32)
    h = rng.standard_normal((6, 2, 5, H)).astype(np.float32)
    w = rng.standard_normal((6, 3 * H, H)).astype(np.float32)
    tx, th, tw = (torch.from_numpy(a) for a in (x, h, w))
    np.testing.assert_array_equal(gru_cuda._group_cols(tx, 2, 3).numpy(),
                                  np.asarray(gru_pallas._group_cols(jnp.asarray(x), 2, 3)))
    np.testing.assert_array_equal(gru_cuda._group_h(th, 2, 3).numpy(),
                                  np.asarray(gru_pallas._group_h(jnp.asarray(h), 2, 3)))
    np.testing.assert_array_equal(gru_cuda._blockdiag_w(tw, 2, 3).numpy(),
                                  np.asarray(gru_pallas._blockdiag_w(jnp.asarray(w), 2, 3)))
    assert torch.equal(gru_cuda._ungroup_cols(gru_cuda._group_cols(tx, 2, 3), 2, 3), tx)
    assert torch.equal(gru_cuda._ungroup_h(gru_cuda._group_h(th, 2, 3), 2, 3), th)


def _fold_model(gru_impl: str, folds: int = 4, layers: int = 2, prune: bool = True):
    cfg = pcfg.ModelConfig(gru_hidden_size=H, cnn_out_channels=8, dropout=0.0,
                           gru_impl=gru_impl, gru_num_layers=layers, gru_last_prune=prune)
    return build_fold_model(cfg, 2, 3, folds, seeds=list(range(folds)))


@pytest.mark.parametrize("gru_impl,want", [
    # every layer's two directions and the pruned layer grouped
    ("pallas", [("gru_fwd_fb", 1, 4 * H)] * 3),
    ("cuda", [("gru_fwd_fb", 1, 4 * H)] * 3),
    # the fused pair never; the pruned last layer's forward walk grouped
    ("pallas_fused", [("gru_bifwd", 8, H), ("gru_fwd_fb", 1, 4 * H)]),
    # dirbatch layers reach the fold axis through the fb kernels' rule: never grouped
    ("pallas_db", [("gru_fwd_fb", 4, H)] * 2 + [("gru_fwd_fb", 1, 4 * H)]),
])
def test_fold_model_groups_only_where_jax_does(gru_impl, want, monkeypatch, walks):
    """The fold-stacked model under MMS_GRU_FOLD_GROUP=4 at F=4 groups the
    walks whose fold axis reaches the JAX package's per-direction rule
    (_FWD_CV) and no other: never the fused pair, never pallas_db's
    dirbatch layers; the single-fold dirbatch pair stays two lanes of H."""
    monkeypatch.setenv("MMS_GRU_FOLD_GROUP", GROUP)
    model = _fold_model(gru_impl).eval()
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((4, 2, 3, 64))
                         .astype(np.float32))
    with torch.no_grad():
        model(x)
    assert walks == want
    walks.clear()
    z = torch.zeros
    gru_cuda.gru_bidirectional_dirbatch(z(2, 5, 3 * H), z(2, 5, 3 * H), z(3 * H, H),
                                        z(3 * H, H), z(3 * H), z(3 * H), z(2, H))
    assert walks == [("gru_fwd_fb", 2, H)]


def test_unpruned_fused_and_db_models_never_group(monkeypatch, walks):
    """Without last-step pruning the last layer runs its impl's own walk:
    pallas_fused and pallas_db then group nothing."""
    monkeypatch.setenv("MMS_GRU_FOLD_GROUP", GROUP)
    x = torch.zeros(4, 2, 3, 64)
    with torch.no_grad():
        _fold_model("pallas_fused", prune=False).eval()(x)
        _fold_model("pallas_db", prune=False).eval()(x)
    assert walks == [("gru_bifwd", 8, H)] * 2 + [("gru_fwd_fb", 4, H)] * 4


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return write_tree(tmp_path_factory.mktemp("group") / "data")


def test_grouped_sweep_epoch_matches_ungrouped(tree, monkeypatch):
    """One epoch of the F=4 sweep (H=8, gru_impl "pallas": the F-lane
    walks' plain versions) grouped as one lane of 4·H against ungrouped,
    from the same weights on the same grid: losses rtol 1e-4, parameters
    atol 1e-5, accuracy and F1 alike."""
    _, cfg = _sweep_configs(tree, gru_impl="pallas", epochs=1)
    corpus = pdata.pack_corpus(tree, list(SUBJECTS), CHANNELS, pdata.read_channel_names(tree))
    fb = pfs.build_fold_batch(corpus, list(SUBJECTS), cfg.val_fraction, cfg.seed)
    runs = {}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for value in (None, GROUP):
            if value is None:
                monkeypatch.delenv("MMS_GRU_FOLD_GROUP", raising=False)
            else:
                monkeypatch.setenv("MMS_GRU_FOLD_GROUP", value)
            seeds, rngs = pfs.fold_streams(cfg.seed, len(fb.test_subjects))
            sweep = pfs.FoldSweep(corpus, fb, cfg, "cpu", init_seeds=seeds)
            idx, w = sweep.train_grid(rngs)
            runs[value] = (sweep.epoch(idx, w, 0), sweep.model)
    finally:
        torch.set_num_threads(threads)
    (plain, m_plain), (grouped, m_grouped) = runs[None], runs[GROUP]
    np.testing.assert_allclose(grouped[0], plain[0], rtol=1e-4, err_msg="train loss")
    np.testing.assert_allclose(grouped[1], plain[1], rtol=1e-4, err_msg="val loss")
    for (name, a), (_, b) in zip(m_grouped.named_parameters(), m_plain.named_parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), rtol=0, atol=1e-5,
                                   err_msg=name)
    np.testing.assert_array_equal(grouped[2], plain[2], err_msg="val accuracy")
