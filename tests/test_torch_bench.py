"""The port's bench (multimodalsignal_tpu_torch/bench.py) on the CPU.

`make_train_step` is the body of bench.py's `bench_jax` train_step on the
port. At B=4, T=256, H=16 and dropout 0, three steps from the same weights
(the JAX model's init, carried across by `load_jax_variables`) and the same
numpy batch are held against three steps of the JAX package's
CnnGruAttentionModel (gru_impl "scan"), `make_optimizer` and `cross_entropy`
(the port's "scan" is its plain loop), and against `Trainer.train_step`,
which must give the same bits. The CLI at `--device cpu` prints exactly one
JSON line with bench.py's four keys. The CUDA graph itself needs the card:
chip_smoke.py's phase 17 holds the captured step against the eager one.

Tolerances are chip_smoke.py's TRAIN_TOL for float32: losses rtol 1e-4;
parameters every element within 2 lr a step (Adam's first steps move an
element by about lr whatever its gradient, so a gradient within round-off
of zero can land 2 lr apart), all but 0.1 % within 1e-5; the batch-norm
statistics atol 1e-5.
"""

import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from multimodalsignal_tpu.models import CnnGruAttentionModel
from multimodalsignal_tpu.train.optim import make_optimizer as jax_make_optimizer
from multimodalsignal_tpu.train.trainer import cross_entropy as jax_cross_entropy
from multimodalsignal_tpu_torch import bench
from multimodalsignal_tpu_torch.config import ModelConfig, TrainerConfig
from multimodalsignal_tpu_torch.models.cnn_gru import build_model
from multimodalsignal_tpu_torch.models.convert import export_jax_variables, load_jax_variables
from multimodalsignal_tpu_torch.train.optim import make_optimizer
from multimodalsignal_tpu_torch.train.trainer import Trainer

from tests.test_torch_fold_sweep import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
B, C, T, H, STEPS, LR, WD = 4, 3, 256, 16, 3, 1e-3, 1e-4
TRAIN_TOL = dict(loss=1e-4, elem=1e-5, share=1e-3)
RESULT_KEYS = {"metric", "value", "unit", "vs_baseline"}


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(0)
    return (rng.standard_normal((B, C, T)).astype(np.float32),
            rng.integers(0, 2, B).astype(np.int32), np.ones(B, np.float32))


@pytest.fixture(scope="module")
def jax_run(batch):
    """Initial flax variables, then the JAX bench's train_step three times at
    dropout 0: (variables, losses, params, batch_stats)."""
    x, y, w = (jnp.asarray(a) for a in batch)
    model = CnnGruAttentionModel(num_classes=2, gru_impl="scan", gru_last_prune=True,
                                 gru_hidden_size=H, dropout=0.0)
    rng = jax.random.PRNGKey(0)
    variables = model.init(rng, x, train=False)
    tx = jax_make_optimizer(LR, WD)

    @jax.jit
    def train_step(params, batch_stats, opt_state):
        def loss_fn(p):
            logits, new_bs = model.apply({"params": p, "batch_stats": batch_stats}, x,
                                         train=True, rngs={"dropout": rng},
                                         mutable=["batch_stats"])
            return jax_cross_entropy(logits, y, w)[0], new_bs["batch_stats"]

        (loss, new_bs), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        updates, new_opt = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), new_bs, new_opt, loss

    params, stats = variables["params"], variables["batch_stats"]
    opt_state = tx.init(params)
    losses = []
    for _ in range(STEPS):
        params, stats, opt_state, loss = train_step(params, stats, opt_state)
        losses.append(float(loss))
    host = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
    return host(variables), losses, host(params), host(stats)


def _port(variables):
    model = build_model(ModelConfig(gru_impl="scan", gru_hidden_size=H, dropout=0.0), 2, C)
    load_jax_variables(model, variables["params"], variables["batch_stats"])
    return model


def _bench_steps(variables, batch):
    """Three steps of make_train_step on the CPU: (model, losses)."""
    model = _port(variables)
    x, y, w = (torch.from_numpy(a) for a in batch)
    generator = torch.Generator().manual_seed(0)
    step = bench.make_train_step(model, make_optimizer(model.parameters(), LR, WD),
                                 x, y.long(), w, generator)
    return model, [step() for _ in range(STEPS)]


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, np.asarray(tree, np.float32)


def test_make_train_step_matches_the_jax_bench_step(jax_run, batch):
    variables, want_losses, want_params, want_stats = jax_run
    model, losses = _bench_steps(variables, batch)
    got = export_jax_variables(model)
    np.testing.assert_allclose([v.item() for v in losses], want_losses,
                               rtol=TRAIN_TOL["loss"], atol=0)
    far = total = 0
    for (name, a), (name_w, b) in zip(_leaves(got["params"]), _leaves(want_params),
                                      strict=True):
        assert name == name_w
        d = np.abs(a - b)
        assert d.max() <= 2 * LR * STEPS + 1e-6, (name, d.max())
        far += int((d > TRAIN_TOL["elem"]).sum())
        total += d.size
    assert far / total <= TRAIN_TOL["share"], (far, total)
    for (name, a), (name_w, b) in zip(_leaves(got["batch_stats"]), _leaves(want_stats),
                                      strict=True):
        assert name == name_w
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5, err_msg=name)


def test_make_train_step_is_trainer_train_step(jax_run, batch, tmp_path):
    """The bench's step and Trainer.train_step from the same weights: the
    same losses and parameters, bit for bit."""
    variables = jax_run[0]
    model, losses = _bench_steps(variables, batch)
    trainer = Trainer(_port(variables), tmp_path, TrainerConfig(learning_rate=LR,
                      weight_decay=WD), 2, device="cpu")
    x, y, w = (torch.from_numpy(a) for a in batch)
    want = [trainer.train_step(x, y.long(), w)[0] for _ in range(STEPS)]
    assert [v.item() for v in losses] == [v.item() for v in want]
    for (k, a), (k_w, b) in zip(model.state_dict().items(),
                                trainer.model.state_dict().items(), strict=True):
        assert k == k_w and torch.equal(a, b), k


def test_make_capturable_before_the_first_step_only():
    """make_capturable puts Adam's step count on the device (capturable
    groups) and refuses an optimizer that already stepped, whose count
    lives on the host."""
    model = build_model(ModelConfig(gru_hidden_size=H, gru_impl="scan"), 2, C)
    opt = bench.make_capturable(make_optimizer(model.parameters(), LR, WD))
    assert all(g["capturable"] for g in opt.param_groups)
    stepped = make_optimizer(model.parameters(), LR, WD)
    for p in model.parameters():
        p.grad = torch.zeros_like(p)
    stepped.step()
    with pytest.raises(ValueError, match="before its first step"):
        bench.make_capturable(stepped)


def test_bench_needs_cuda_unless_asked_for_the_cpu():
    with pytest.raises(RuntimeError, match="cuda"):
        bench.main(["--batch", "2", "--seq", "256", "--steps", "1"])


def test_bench_cli_prints_one_json_line():
    proc = subprocess.run(
        [sys.executable, "-m", "multimodalsignal_tpu_torch.bench", "--device", "cpu",
         "--batch", "2", "--seq", "256", "--steps", "2", "--warmup", "1"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    lines = [line for line in proc.stdout.splitlines() if line.strip().startswith("{")]
    assert len(lines) == 1 and proc.stdout.strip().splitlines()[-1] == lines[0]
    result = json.loads(lines[0])
    assert set(result) == RESULT_KEYS
    assert result["unit"] == "steps/sec/chip" and result["value"] > 0
    assert "B=2, C=3, T=256, bfloat16, eager" in result["metric"]
    assert "baseline torch-CPU float32 nn.GRU" in result["metric"]
    assert result["vs_baseline"] is None or result["vs_baseline"] > 0


def test_bench_torch_on_the_cpu_steps_eagerly():
    """On the CPU bench_torch takes the step eagerly: a rate and its ms, and
    neither a graph nor launches per captured step."""
    out = bench.bench_torch(2, C, T, steps=1, warmup=0, dtype="float32", device="cpu")
    assert out["graph"] is None and out["launches"] is None
    assert out["steps_per_sec"] > 0 and out["ms"] == pytest.approx(1e3 / out["steps_per_sec"])
