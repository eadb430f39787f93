"""One training-mode step of the port's CnnGruAttentionModel against the JAX
model with train=True and mutable=["batch_stats"], from the same weights
(load_jax_variables) and numpy-seeded inputs, with dropout 0: the weighted
cross-entropy, every parameter's gradient (mapped through the flax layout)
and the updated batch statistics.

Port impl "torch" (autograd through the plain loop) is held against JAX
"scan", port "cuda" (its autograd Functions: plain forward and plain adjoint
on the CPU) against JAX "pallas_db" (interpret mode). B=6 with two
zero-weight rows, which batch norm still sees.

Tolerances. float32: loss rtol 1e-5; gradients atol 1e-5 + rtol 1e-4 of the
tensor's largest magnitude (sums over B*T terms in another order);
statistics 1e-5. bfloat16: the JAX side runs op by op (not under jit,
where XLA keeps fused bf16 intermediates in float32), so both sides round
each op's result to bf16 as the model's code says; they still round bf16
products and their cotangents at slightly different points, and at this
size bf16 noise moves the JAX model's own gradients by up to ~50 % of a
tensor's largest magnitude away from its float32 ones. Measured port-vs-JAX
differences in bf16 are up to 5.1 % ("scan") and 1.8 % ("pallas_db") of a
tensor's largest magnitude, so gradients within 8 % of it, loss within
2e-2, statistics within 1e-2."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodalsignal_tpu.config import ModelConfig
from multimodalsignal_tpu.models import build_model as build_jax_model
from multimodalsignal_tpu.train.trainer import cross_entropy as jax_cross_entropy
from multimodalsignal_tpu_torch.config import ModelConfig as PortModelConfig
from multimodalsignal_tpu_torch.models.cnn_gru import build_model
from multimodalsignal_tpu_torch.models.convert import _layout, load_jax_variables
from multimodalsignal_tpu_torch.train.trainer import cross_entropy

B, C, T, H, CLASSES = 6, 3, 256, 8, 2
TOL = {"float32": dict(loss=1e-5, grad=1e-4, grad_abs=1e-5, stats=1e-5),
       "bfloat16": dict(loss=2e-2, grad=8e-2, grad_abs=0.0, stats=1e-2)}


def _variables(model, x, seed):
    """flax init, then non-trivial BN statistics and affine terms."""
    variables = model.init(jax.random.PRNGKey(seed), jnp.asarray(x), train=False)
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    stats = jax.tree_util.tree_map(np.asarray, variables["batch_stats"])
    rng = np.random.default_rng(seed)
    for bn in ("bn1", "bn2"):
        n = stats["cnn_encoder"][bn]["mean"].shape
        stats["cnn_encoder"][bn]["mean"] = rng.uniform(-0.5, 0.5, n).astype(np.float32)
        stats["cnn_encoder"][bn]["var"] = rng.uniform(0.5, 2.0, n).astype(np.float32)
        params["cnn_encoder"][bn]["scale"] = rng.uniform(0.5, 1.5, n).astype(np.float32)
        params["cnn_encoder"][bn]["bias"] = rng.uniform(-0.2, 0.2, n).astype(np.float32)
    return params, stats


def _leaf(tree, path):
    for key in path:
        tree = tree[key]
    return np.asarray(jnp.asarray(tree, jnp.float32))


def _jax_step(fields, params, stats, x, y, w):
    """(loss, new batch_stats), grads of one JAX train-mode step; jitted in
    float32, op by op in bfloat16."""
    jm = build_jax_model(ModelConfig(**fields), CLASSES)

    def loss_fn(p, xb, yb, wb):
        logits, new = jm.apply({"params": p, "batch_stats": stats}, xb,
                               train=True, mutable=["batch_stats"])
        loss, _ = jax_cross_entropy(logits, yb, wb)
        return loss, new["batch_stats"]

    step = jax.value_and_grad(loss_fn, has_aux=True)
    if fields["dtype"] == "float32":
        step = jax.jit(step)
    return step(params, jnp.asarray(x), jnp.asarray(y), jnp.asarray(w))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl,port_impl", [("scan", "torch"), ("pallas_db", "cuda")])
def test_train_step_matches_flax(impl, port_impl, dtype):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, C, T)).astype(np.float32)
    y = rng.integers(0, CLASSES, B).astype(np.int32)
    w = np.array([1, 1, 1, 1, 0, 0], np.float32)
    fields = dict(gru_hidden_size=H, cnn_out_channels=8, gru_impl=impl,
                  dropout=0.0, dtype=dtype)
    params, stats = _variables(build_jax_model(ModelConfig(**fields), CLASSES), x, seed=4)
    (want_loss, want_stats), want_grads = _jax_step(fields, params, stats, x, y, w)

    pm = build_model(PortModelConfig(**dict(fields, gru_impl=port_impl)), CLASSES,
                     in_channels=C)
    assert pm.gru.impl == port_impl and pm.gru.dropout == 0.0
    load_jax_variables(pm, params, stats)
    pm.train()
    loss, wsum = cross_entropy(pm(torch.from_numpy(x)), torch.from_numpy(y).long(),
                               torch.from_numpy(w))
    loss.backward()
    tol = TOL[dtype]
    assert float(wsum) == 4.0
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=tol["loss"],
                               atol=tol["loss"] if dtype == "bfloat16" else 0)
    checked = 0
    for coll, path, tensor, transform in _layout(pm):
        name = "/".join(path)
        if coll == "params":
            got = transform(tensor.grad).numpy()
            want = _leaf(want_grads, path)
            atol = tol["grad_abs"] + tol["grad"] * np.abs(want).max()
            np.testing.assert_allclose(got, want, rtol=0, atol=atol, err_msg=name)
        else:
            np.testing.assert_allclose(tensor.numpy(), _leaf(want_stats, path),
                                       rtol=0, atol=tol["stats"], err_msg=name)
        checked += 1
    assert checked == len(jax.tree_util.tree_leaves(params)) + 4


def test_eval_mode_leaves_statistics_and_ignores_dropout():
    """In eval() the forward is the inference forward: running statistics
    stay as they were and dropout is off, whatever its rate."""
    pm = build_model(PortModelConfig(gru_hidden_size=H, dropout=0.5), CLASSES,
                     in_channels=C)
    assert pm.gru.dropout == 0.5 and pm.dropout == 0.5
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((B, C, T)).astype(np.float32))
    before = {k: v.clone() for k, v in pm.state_dict().items()}
    pm.eval()
    with torch.inference_mode():
        a, b = pm(x), pm(x)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    for k, v in pm.state_dict().items():
        torch.testing.assert_close(v, before[k], rtol=0, atol=0, msg=k)


def test_training_dropout_follows_the_generator():
    """Training mode draws its dropout masks from the generator it is given:
    the same seed gives the same logits, another seed other logits, and a
    mask keeps about 1 - rate of the elements, scaled by 1 / (1 - rate)."""
    from multimodalsignal_tpu_torch.models.gru import dropout

    pm = build_model(PortModelConfig(gru_hidden_size=H, dropout=0.5), CLASSES,
                     in_channels=C).train()
    x = torch.from_numpy(np.random.default_rng(6).standard_normal((B, C, T)).astype(np.float32))

    def run(seed):
        with torch.no_grad():
            return pm(x, torch.Generator().manual_seed(seed))

    torch.testing.assert_close(run(1), run(1), rtol=0, atol=0)
    assert not torch.equal(run(1), run(2))
    ones = torch.ones(200_000)
    kept = dropout(ones, 0.5, torch.Generator().manual_seed(0), active=True)
    assert set(kept.unique().tolist()) == {0.0, 2.0}
    assert abs(float((kept > 0).float().mean()) - 0.5) < 0.01
    assert dropout(ones, 0.5, None, active=False) is ones
