"""The port's flax checkpoint reader (multimodalsignal_tpu_torch/train/
checkpoints.py) against checkpoints the JAX package writes: a real
TrainState (params, batch_stats, Adam opt_state) saved with
multimodalsignal_tpu.train.checkpoints.save_state, float32 plus one
bfloat16 leaf, must read back bit for bit; and the port's writer must make
the bytes flax's codec makes (tests/test_torch_trainer.py restores a
written train state with the JAX package's restore_state)."""

import jax
import numpy as np
import pytest
import torch
from flax import serialization

from multimodalsignal_tpu.config import ModelConfig
from multimodalsignal_tpu.models import build_model
from multimodalsignal_tpu.train.checkpoints import save_state
from multimodalsignal_tpu.train.optim import make_optimizer
from multimodalsignal_tpu.train.trainer import TrainState, init_train_state
from multimodalsignal_tpu_torch.train.checkpoints import packb, read_flax_checkpoint, unpackb


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, prefix + (k,))
    else:
        yield prefix, tree


def test_reads_train_state_bit_identical(tmp_path):
    model = build_model(ModelConfig(gru_hidden_size=8, cnn_out_channels=4), 2)
    state = init_train_state(model, jax.random.PRNGKey(0),
                             np.zeros((1, 3, 256), np.float32),
                             make_optimizer(1e-3, 1e-4))
    params = jax.tree_util.tree_map(np.asarray, state.params)
    params["head2"]["bias"] = np.asarray(
        jax.numpy.asarray([0.5, -1.25], jax.numpy.bfloat16))
    stats = jax.tree_util.tree_map(np.asarray, state.batch_stats)
    stats["cnn_encoder"]["bn1"]["var"] = np.linspace(
        0.5, 2.0, 16).astype(np.float32)
    path = tmp_path / "best_model.msgpack"
    save_state(path, TrainState(params=params, batch_stats=stats,
                                opt_state=state.opt_state))

    got = read_flax_checkpoint(path)
    assert set(got) == {"params", "batch_stats"}
    for want_tree, got_tree in ((params, got["params"]), (stats, got["batch_stats"])):
        want_leaves, got_leaves = dict(_flat(want_tree)), dict(_flat(got_tree))
        assert want_leaves.keys() == got_leaves.keys()
        for key, want in want_leaves.items():
            leaf = got_leaves[key]
            if want.dtype.name == "bfloat16":
                assert isinstance(leaf, torch.Tensor) and leaf.dtype == torch.bfloat16
                np.testing.assert_array_equal(leaf.view(torch.int16).numpy(),
                                              want.view(np.int16))
            else:
                assert leaf.dtype == want.dtype and leaf.shape == want.shape
                np.testing.assert_array_equal(leaf, want)


@pytest.mark.parametrize("value", [
    None, True, False, 0, 127, 128, 65535, 2**32, -1, -33, -2**40, 1.5,
    "", "x" * 40, "ü" * 300, b"\x00\x01", b"z" * 70000,
    [], list(range(20)), {"a": {"b": [1, 2.5]}}, {str(i): i for i in range(20)},
    np.arange(6, dtype=np.int64).reshape(2, 3), np.float32(2.5),
])
def test_unpackb_matches_flax_encoding(value):
    """Every msgpack type the reader handles, encoded by flax's codec."""
    got = unpackb(serialization.msgpack_serialize({"v": value}))["v"]
    if isinstance(value, np.ndarray):
        np.testing.assert_array_equal(got, value)
        assert got.dtype == value.dtype
    else:
        assert got == value and type(got) is type(value)


def test_unpackb_rejects_truncated_data():
    data = serialization.msgpack_serialize({"w": np.ones(4, np.float32)})
    with pytest.raises(ValueError, match="truncated"):
        unpackb(data[:-3])


@pytest.mark.parametrize("value", [
    0, 127, 128, 65535, 2**32, -1, -33, -2**40, "", "x" * 31, "x" * 32, "ü" * 300,
    b"\x00\x01", b"z" * 70000, [], list(range(20)), {"b": {"a": [1, 2]}},
    {str(i): i for i in range(20)}, np.arange(6, dtype=np.int64).reshape(2, 3),
    np.zeros((), np.int32), np.ones(300, np.float32),
])
def test_packb_writes_flax_bytes(value):
    """The writer's encoding is byte for byte flax's (map keys sorted as
    flax's tree_map sorts them), and the reader decodes it."""
    got = packb({"v": value})
    assert got == serialization.msgpack_serialize({"v": value})
    back = unpackb(got)["v"]
    if isinstance(value, np.ndarray):
        np.testing.assert_array_equal(back, value)
    else:
        assert back == value


def test_packb_refuses_types_a_train_state_does_not_hold():
    with pytest.raises(TypeError, match="float"):
        packb({"v": 1.5})
