"""The port imports neither JAX, flax, optax, scikit-learn, msgpack,
matplotlib, seaborn, pandas nor anything of the JAX package (the GPU machine
has none of them), and asks for CUDA by default.

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
raise without CUDA when no device is named. The analysis package (the
preprocess checker, the feature tools, the attention probe) imports too: its
plotting and scikit-learn imports sit inside the functions."""

import ast
import subprocess
import sys
import textwrap
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

SCRIPT = textwrap.dedent("""
    import importlib, pkgutil, sys

    BLOCKED = ("jax", "jaxlib", "flax", "optax", "sklearn", "msgpack",
               "matplotlib", "seaborn", "pandas", "multimodalsignal_tpu")

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
    for name in ("analysis", "analysis.preprocess_check", "analysis.feature_importance",
                 "analysis.feature_distributions", "analysis.attention_probe"):
        assert f"multimodalsignal_tpu_torch.{name}" in names, name
    from multimodalsignal_tpu_torch.analysis.feature_importance import require
    try:
        require("sklearn.ensemble")
    except ImportError as exc:
        assert "scikit-learn is missing" in str(exc)
        print("analysis names sklearn")
    else:
        raise AssertionError("sklearn imported while blocked")
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
    assert "analysis names sklearn" in proc.stdout
    # 38 modules before the deployment tier, then streaming, export, import_torch,
    # then the analysis package and its four modules.
    assert int(proc.stdout.split("imported ")[1].split()[0]) >= 46
    assert proc.stdout.strip().endswith("ok")


# The port's host window engine: built from its own source into its own
# build directory, with every file the build, the load and a pack open, and
# every process the build starts, recorded by audit hooks.
NATIVE_SCRIPT = textwrap.dedent("""
    import sys, tempfile
    from pathlib import Path

    for name in list(sys.modules):
        if name == "multimodalsignal_tpu" or name.startswith("multimodalsignal_tpu."):
            del sys.modules[name]
    sys.modules["multimodalsignal_tpu"] = None

    seen = []
    def audit(event, args):
        if event in ("open", "os.listdir", "os.scandir"):
            seen.append(str(args[0]))
        elif event == "ctypes.dlopen":
            seen.append(str(args[0]))
        elif event == "subprocess.Popen":
            seen.extend(str(a) for a in args[1])
    sys.addaudithook(audit)

    import numpy as np
    from multimodalsignal_tpu_torch import native
    from multimodalsignal_tpu_torch.data import dataset, windowing
    with tempfile.TemporaryDirectory() as tmp:
        native.BUILD_DIR = Path(tmp) / "build"      # a fresh build
        assert native.available()
        assert native.library_path().parent == native.BUILD_DIR
        rng = np.random.default_rng(0)
        data = Path(tmp) / "data"
        data.mkdir()
        names = ["chest_ECG", "chest_EDA", "chest_Resp"]
        for sid in ("S2", "S3"):
            np.save(data / f"{sid}_X.npy", (rng.standard_normal((6, 32, 3)) ** 2).astype(np.float32))
            np.save(data / f"{sid}_y.npy", np.array([1, 1, 2, 3, 4, 2]))
        dataset.pack_corpus(data, ["S2", "S3"], names, names, cache=False)
        windowing.sliding_windows_fast(np.zeros((64, 3), np.float32), np.array([0, 8]), 16)
        dataset.normalize_subject(np.ones((4, 16, 3), np.float32), np.ones(4), names)
        counts = native.call_counts()
        assert counts["pack_subject_f32"] == 2 and counts["sliding_windows_f32"] == 1, counts
        assert counts["channel_stats_f32"] == 1, counts
    for path in seen:
        print("touched", path)
    print("ok")
""")


def test_native_engine_never_reads_or_loads_the_jax_packages():
    """The port's engine imports nothing of the JAX package and never reads,
    builds from or loads anything under multimodalsignal_tpu/native/: its
    g++ takes the port's own window_engine.cpp, and the library it loads is
    the one it built, under its own build directory."""
    proc = subprocess.run([sys.executable, "-c", NATIVE_SCRIPT], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip().endswith("ok")
    touched = [line[len("touched "):] for line in proc.stdout.splitlines()
               if line.startswith("touched ")]
    jax_native = (REPO / "multimodalsignal_tpu" / "native").resolve()
    port_source = (REPO / "multimodalsignal_tpu_torch" / "native" / "window_engine.cpp")
    assert str(port_source) in touched          # g++ built the port's source
    assert any(t.endswith(".so") and "libwindow_engine-" in t for t in touched)
    for path in touched:
        resolved = Path(path).resolve() if path.startswith("/") else (REPO / path).resolve()
        assert jax_native not in resolved.parents and resolved != jax_native, path
    tree = ast.parse((REPO / "multimodalsignal_tpu_torch" / "native" / "__init__.py").read_text())
    for node in ast.walk(tree):
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            mods = [a.name for a in node.names] if isinstance(node, ast.Import) else [node.module]
            assert not any(m == "multimodalsignal_tpu" or m.startswith("multimodalsignal_tpu.")
                           for m in mods), mods
