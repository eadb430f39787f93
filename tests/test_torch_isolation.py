"""The port imports neither JAX, flax, optax, scikit-learn, msgpack nor
anything of the JAX package (the GPU machine has none of them), and asks for
CUDA by default.

A subprocess blocks those names in sys.modules (matched exactly, so
`multimodalsignal_tpu_torch` still imports), imports
every module of the port (the trainer, optimizer, metrics and checkpoint
writer among them), runs one CPU forward and one CPU training epoch that
writes a checkpoint, and checks that the Predictor, the Trainer and the
experiment CLI raise without CUDA when no device is named. The data front
end (preprocess, features, synthetic, protocol), the hybrid model and the
experiments beyond plain LOSO (hierarchical, its sweep, the
replicated sweep, ablation) and the deployment tier (streaming, export,
import) are among the modules imported; an artifact exported in the
subprocess runs on the CPU, and ExportedPredictor.load and the stream CLI
raise without CUDA when no device is named."""

import subprocess
import sys
import textwrap
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

SCRIPT = textwrap.dedent("""
    import importlib, pkgutil, sys

    BLOCKED = ("jax", "jaxlib", "flax", "optax", "sklearn", "msgpack",
               "multimodalsignal_tpu")

    def blocked(name):
        return any(name == b or name.startswith(b + ".") for b in BLOCKED)

    # A None entry makes `import name` (and of its submodules) raise
    # ImportError, while importlib.util.find_spec(name), which torch uses to
    # probe for optional packages, answers None (not installed).
    for name in list(sys.modules):
        if blocked(name):
            del sys.modules[name]
    for name in BLOCKED:
        sys.modules[name] = None

    import multimodalsignal_tpu_torch as pkg
    names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
    for name in names:
        importlib.import_module(name)
    print("imported", len(names))

    import numpy as np, torch
    from multimodalsignal_tpu_torch.config import ExperimentConfig, ModelConfig
    from multimodalsignal_tpu_torch.experiments.predict import Predictor
    from multimodalsignal_tpu_torch.models.cnn_gru import build_model
    from multimodalsignal_tpu_torch.models.convert import export_jax_variables

    cfg = ExperimentConfig(model=ModelConfig(gru_hidden_size=8))
    variables = export_jax_variables(build_model(cfg.model, 2, in_channels=3))
    probs = Predictor(cfg, variables, device="cpu").predict_windows(
        np.zeros((2, 3, 512), np.float32), batch_size=4)
    assert probs.shape == (2, 2) and np.allclose(probs.sum(-1), 1.0)
    assert not torch.cuda.is_available()
    try:
        Predictor(cfg, variables)
    except RuntimeError as exc:
        assert "cuda" in str(exc)
        print("default device raised")
    else:
        raise AssertionError("Predictor ran without CUDA instead of raising")
    import tempfile
    from multimodalsignal_tpu_torch.config import TrainerConfig
    from multimodalsignal_tpu_torch.train.checkpoints import read_flax_checkpoint
    from multimodalsignal_tpu_torch.train.trainer import Trainer
    for name in ("trainer", "optim", "metrics", "checkpoints"):
        assert f"multimodalsignal_tpu_torch.train.{name}" in names, name
    with tempfile.TemporaryDirectory() as tmp:
        tcfg = TrainerConfig(epochs=1, batch_size=4)
        model = build_model(cfg.model, 2, in_channels=3)
        trainer = Trainer(model, tmp, tcfg, 2, device="cpu")
        x = np.random.default_rng(0).standard_normal((6, 3, 512)).astype(np.float32)
        y = np.array([0, 1, 0, 1, 1, 0])
        trainer.train((x, y), (x, y))
        assert read_flax_checkpoint(tmp + "/best_model.msgpack")["params"]
        try:
            Trainer(build_model(cfg.model, 2, in_channels=3), tmp, tcfg, 2)
        except RuntimeError as exc:
            assert "cuda" in str(exc)
            print("trainer default device raised")
        else:
            raise AssertionError("Trainer ran without CUDA instead of raising")
    for name in ("main", "experiments.loso", "experiments.splits", "utils.run",
                 "data.preprocess", "data.features", "data.synthetic", "data.protocol",
                 "models.hybrid", "parallel.fold_sweep", "experiments.hierarchical",
                 "experiments.ablation", "parallel.hierarchical_sweep",
                 "parallel.replicated_sweep"):
        assert f"multimodalsignal_tpu_torch.{name}" in names, name
    from multimodalsignal_tpu_torch.main import main
    with tempfile.TemporaryDirectory() as tmp:
        try:
            main(["--execution", "serial", "--output-dir", tmp])
        except RuntimeError as exc:
            assert "cuda" in str(exc)
            import os
            assert not os.listdir(tmp)
            print("cli default device raised")
        else:
            raise AssertionError("the CLI ran without CUDA instead of raising")
    # The deployment tier: an artifact exported here loads on the CPU when
    # asked, and it and the stream CLI ask for CUDA by default.
    for name in ("experiments.streaming", "experiments.export", "experiments.import_torch"):
        assert f"multimodalsignal_tpu_torch.{name}" in names, name
    from multimodalsignal_tpu_torch.config import save_config
    from multimodalsignal_tpu_torch.experiments import streaming
    from multimodalsignal_tpu_torch.experiments.export import ExportedPredictor, export_predictor
    from multimodalsignal_tpu_torch.train.checkpoints import write_initial_train_state
    with tempfile.TemporaryDirectory() as tmp:
        small = Predictor(cfg, variables, device="cpu", window_sec=4, target_fs=16)
        export_predictor(small, tmp + "/m.mms")
        probs = ExportedPredictor.load(tmp + "/m.mms", device="cpu").predict_windows(
            np.zeros((3, 3, 64), np.float32))
        assert probs.shape == (3, 2)
        try:
            ExportedPredictor.load(tmp + "/m.mms")
        except RuntimeError as exc:
            assert "cuda" in str(exc)
            print("artifact default device raised")
        else:
            raise AssertionError("ExportedPredictor ran without CUDA instead of raising")
        write_initial_train_state(tmp + "/best_model.msgpack", variables, 1e-3)
        save_config(cfg, tmp + "/config.json")
        try:
            streaming.main(["--checkpoint", tmp + "/best_model.msgpack",
                            "--config", tmp + "/config.json", "--stdin"])
        except RuntimeError as exc:
            assert "cuda" in str(exc)
            print("stream cli default device raised")
        else:
            raise AssertionError("the stream CLI ran without CUDA instead of raising")
    leaked = sorted(n for n, m in sys.modules.items() if blocked(n) and m is not None)
    assert not leaked, leaked
    print("ok")
""")


def test_port_imports_no_jax_and_needs_cuda_by_default():
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "default device raised" in proc.stdout
    assert "trainer default device raised" in proc.stdout
    assert "cli default device raised" in proc.stdout
    assert "artifact default device raised" in proc.stdout
    assert "stream cli default device raised" in proc.stdout
    # 38 modules before the deployment tier, then streaming, export, import_torch.
    assert int(proc.stdout.split("imported ")[1].split()[0]) >= 41
    assert proc.stdout.strip().endswith("ok")
