"""The port's metrics and optimizer state machines (multimodalsignal_tpu_torch/
train/{metrics,optim}.py) against the JAX package's, on the CPU.

Metrics and the plateau / early-stopping decisions must agree exactly (both
compare in float32); Adam with a mid-run learning-rate change agrees with
optax to float32 round-off (rtol 1e-6, atol 1e-7, as
tests/test_torch_parity.py's Adam test)."""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from multimodalsignal_tpu.train import metrics as jax_metrics
from multimodalsignal_tpu.train import optim as jax_optim
from multimodalsignal_tpu_torch.train import metrics, optim


@pytest.mark.parametrize("case", ["random", "zero_support", "all_masked"])
def test_metrics_match_jax(case):
    """Weighted confusion matrix, accuracy and weighted F1 (sklearn's
    zero_division=0), with a mask; `zero_support` leaves class 2 without
    true samples and class 0 never predicted."""
    rng = np.random.default_rng(0)
    k = 3
    y_true = rng.integers(0, k, 50)
    y_pred = rng.integers(0, k, 50)
    mask = (rng.random(50) > 0.3).astype(np.float32)
    if case == "zero_support":
        y_true = np.where(y_true == 2, 1, y_true)
        y_pred = np.where(y_pred == 0, 2, y_pred)
    if case == "all_masked":
        mask[:] = 0
    want_cm = jax_metrics.confusion_matrix(jnp.asarray(y_true), jnp.asarray(y_pred), k,
                                           jnp.asarray(mask))
    got_cm = metrics.confusion_matrix(torch.from_numpy(y_true), torch.from_numpy(y_pred),
                                      k, torch.from_numpy(mask))
    assert got_cm.dtype == torch.float32
    np.testing.assert_array_equal(got_cm.numpy(), np.asarray(want_cm))
    for name in ("accuracy_from_cm", "weighted_f1_from_cm"):
        got = float(getattr(metrics, name)(got_cm))
        want = float(getattr(jax_metrics, name)(want_cm))
        assert got == want, name
    unmasked = metrics.confusion_matrix(torch.from_numpy(y_true), torch.from_numpy(y_pred), k)
    np.testing.assert_array_equal(unmasked.numpy(), np.asarray(jax_metrics.confusion_matrix(
        jnp.asarray(y_true), jnp.asarray(y_pred), k)))


LOSSES = [1.0, 0.9, 0.95, 0.9, 0.91, 0.92, 0.5, 0.5, 0.6, 0.7, 0.8, 0.49]


@pytest.mark.parametrize("patience", [0, 1, 3])
def test_plateau_matches_jax(patience):
    """Same decisions and float32 LR as the JAX state machine, including a
    value that sits exactly on the rel threshold: best * (1 - 1e-4) in
    float32 is not an improvement (strict <), one float32 ulp below is."""
    best = np.float32(0.5)
    on = np.float32(best * np.float32(1 - 1e-4))
    below = np.nextafter(on, np.float32(0))
    seq = LOSSES + [float(best), float(on), float(below), float(on)]
    js = jax_optim.plateau_init(1e-3)
    ps = optim.plateau_init(1e-3)
    for loss in seq:
        js = jax_optim.plateau_update(js, loss, factor=0.1, patience=patience)
        ps = optim.plateau_update(ps, loss, factor=0.1, patience=patience)
        assert ps.lr == np.float32(js.lr) and ps.lr.dtype == np.float32
        assert ps.best == np.float32(js.best)
        assert ps.num_bad == int(js.num_bad)


@pytest.mark.parametrize("legacy_inverted", [False, True])
@pytest.mark.parametrize("delta", [0.0, 0.05])
def test_early_stopping_matches_jax(legacy_inverted, delta):
    """Every field after every step, on a sequence with a tie, values on the
    delta threshold in float32, and enough non-improving steps to stop."""
    seq = LOSSES + [0.44, 0.49, 0.49, 0.3, 0.35]
    js = jax_optim.early_stopping_init()
    ps = optim.early_stopping_init()
    for epoch, loss in enumerate(seq):
        js = jax_optim.early_stopping_update(js, loss, epoch, patience=3, delta=delta,
                                             legacy_inverted=legacy_inverted)
        ps = optim.early_stopping_update(ps, loss, epoch, patience=3, delta=delta,
                                         legacy_inverted=legacy_inverted)
        np.testing.assert_array_equal(ps.best_score, np.asarray(js.best_score))
        assert (ps.counter, ps.should_stop, ps.improved, ps.best_epoch) == (
            int(js.counter), bool(js.should_stop), bool(js.improved), int(js.best_epoch))
    assert ps.should_stop


def test_adam_with_lr_change_matches_optax():
    """torch Adam (L2 weight decay before the moments) with
    set_learning_rate halfway against make_optimizer + set_learning_rate +
    optax.apply_updates."""
    rng = np.random.default_rng(1)
    w0 = rng.standard_normal((6, 4)).astype(np.float32)
    b0 = rng.standard_normal(4).astype(np.float32)
    grads = [(rng.standard_normal((6, 4)).astype(np.float32),
              rng.standard_normal(4).astype(np.float32)) for _ in range(6)]
    lr, wd = 1e-3, 1e-4

    pw = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    pb = torch.nn.Parameter(torch.from_numpy(b0.copy()))
    opt = optim.make_optimizer([pw, pb], lr, wd)
    tx = jax_optim.make_optimizer(lr, wd)
    params = {"w": jnp.asarray(w0), "b": jnp.asarray(b0)}
    state = tx.init(params)
    for step, (gw, gb) in enumerate(grads):
        if step == 3:
            optim.set_learning_rate(opt, np.float32(lr) * np.float32(0.1))
            state = jax_optim.set_learning_rate(state, np.float32(lr) * np.float32(0.1))
        opt.zero_grad()
        pw.grad, pb.grad = torch.from_numpy(gw.copy()), torch.from_numpy(gb.copy())
        opt.step()
        updates, state = tx.update({"w": jnp.asarray(gw), "b": jnp.asarray(gb)},
                                   state, params)
        params = optax.apply_updates(params, updates)
    assert opt.param_groups[0]["lr"] == float(jax_optim.get_learning_rate(state))
    np.testing.assert_allclose(pw.detach().numpy(), np.asarray(params["w"]),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(pb.detach().numpy(), np.asarray(params["b"]),
                               rtol=1e-6, atol=1e-7)
