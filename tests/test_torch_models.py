"""Port models (multimodalsignal_tpu_torch/models) vs the flax models, on the
CPU: the same flax variables, moved into the port through
`load_jax_variables`, and the same numpy-seeded input give the same logits.

Port impl "torch" is held against JAX gru_impl "scan", port "cuda" (its
plain versions on the CPU) against JAX "pallas" (interpret mode). C=3 runs
the constant-0.5 channel gate, C=8 a real one. Tolerances: float32 1e-4, as
tests/test_torch_parity.py; bfloat16 atol 5e-2 on the logits."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodalsignal_tpu.config import ModelConfig
from multimodalsignal_tpu.models import build_model as build_jax_model
from multimodalsignal_tpu_torch.config import ModelConfig as PortModelConfig
from multimodalsignal_tpu_torch.models.cnn_gru import build_model
from multimodalsignal_tpu_torch.models.convert import (
    export_jax_variables,
    load_jax_variables,
)

B, T, H, CLASSES = 5, 1024, 16, 3
PORT_IMPL = {"scan": "torch", "pallas": "cuda"}


def _jax_variables(model, x, seed):
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


def _logits_pair(name, prune, channels, impl, dtype, seed=0):
    x = np.random.default_rng(seed + 100).standard_normal(
        (B, channels, T)).astype(np.float32)
    fields = dict(name=name, gru_hidden_size=H, gru_impl=impl,
                  gru_last_prune=prune, dtype=dtype)
    jm = build_jax_model(ModelConfig(**fields), CLASSES)
    params, stats = _jax_variables(jm, x, seed)
    want = np.asarray(jax.jit(lambda v, xb: jm.apply(v, xb, train=False))(
        {"params": params, "batch_stats": stats}, jnp.asarray(x)))
    pm = build_model(PortModelConfig(**fields), CLASSES, in_channels=channels)
    load_jax_variables(pm, params, stats)
    assert pm.gru.impl == PORT_IMPL[impl]
    with torch.inference_mode():
        got = pm.eval()(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (B, CLASSES)
    return got.numpy(), want


@pytest.mark.parametrize("impl", ["scan", "pallas"])
@pytest.mark.parametrize("channels", [3, 8])
@pytest.mark.parametrize("prune", [True, False])
@pytest.mark.parametrize("name", ["cnn_gru_attention", "cnn_gru"])
def test_logits_match_flax_float32(name, prune, channels, impl):
    got, want = _logits_pair(name, prune, channels, impl, "float32")
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("impl,name,channels", [
    ("scan", "cnn_gru_attention", 3),
    ("pallas", "cnn_gru_attention", 8),
    ("pallas", "cnn_gru", 3),
])
def test_logits_match_flax_bfloat16(impl, name, channels):
    got, want = _logits_pair(name, True, channels, impl, "bfloat16")
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-2)


def test_channel_gate_quirk_constant_half():
    """C < reduction_ratio: the gate is 0.5 for every channel and there are
    no attention parameters to load."""
    pm = build_model(PortModelConfig(gru_hidden_size=H), 2, in_channels=3)
    assert pm.channel_attention.constant_gate
    assert not any(n.startswith("channel_attention") for n, _ in pm.named_parameters())
    x = torch.randn(2, 3, 16)
    torch.testing.assert_close(pm.channel_attention(x), x * 0.5)


def test_load_rejects_missing_and_extra_leaves():
    pm = build_model(PortModelConfig(gru_hidden_size=H), 2, in_channels=3)
    variables = export_jax_variables(pm)
    params, stats = variables["params"], variables["batch_stats"]
    extra = dict(params, stray={"kernel": np.zeros((1, 1), np.float32)})
    with pytest.raises(ValueError, match="stray"):
        load_jax_variables(pm, extra, stats)
    missing = {k: v for k, v in params.items() if k != "head2"}
    with pytest.raises(ValueError, match="head2"):
        load_jax_variables(pm, missing, stats)
    wrong = dict(params, head2={"kernel": np.zeros((3, 3), np.float32),
                                "bias": params["head2"]["bias"]})
    with pytest.raises(ValueError, match="shape"):
        load_jax_variables(pm, wrong, stats)


def test_export_then_load_round_trips():
    """export_jax_variables is the inverse of load_jax_variables."""
    torch.manual_seed(0)
    src = build_model(PortModelConfig(gru_hidden_size=H), 2, in_channels=8)
    dst = build_model(PortModelConfig(gru_hidden_size=H), 2, in_channels=8)
    variables = export_jax_variables(src)
    load_jax_variables(dst, variables["params"], variables["batch_stats"])
    for (name, a), (_, b) in zip(src.state_dict().items(), dst.state_dict().items()):
        if a.is_floating_point():
            torch.testing.assert_close(a, b, rtol=0, atol=0, msg=name)
