"""The port's ablation sweep (multimodalsignal_tpu_torch/experiments/
ablation.py) against the JAX package's, on the CPU at small widths (H = 8,
conv 8, T = 128, 3 subjects): the grid's defaults, the summary files byte
for byte from the same points, and the CLI over the sharded sweep and the
serial experiment, each point the run that experiment gives on its own.
"""

import dataclasses
import json

import numpy as np
import pytest

from multimodalsignal_tpu.experiments import ablation as jab
from multimodalsignal_tpu_torch import config as pcfg
from multimodalsignal_tpu_torch.experiments import ablation as pab
from multimodalsignal_tpu_torch.parallel.fold_sweep import run_sharded_experiment

from tests.test_torch_fold_sweep import one_torch_thread, write_tree  # noqa: F401

SUBJECTS = ("S2", "S3", "S4")
SMALL = ["--set", "model.gru_hidden_size=8", "--set", "model.cnn_out_channels=8",
         "--set", "trainer.epochs=1", "--set", "trainer.batch_size=4"]


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return write_tree(tmp_path_factory.mktemp("ablation") / "data", SUBJECTS)


def test_grid_defaults_match_jax():
    assert pab.DEFAULT_CHANNEL_SUBSETS == jab.DEFAULT_CHANNEL_SUBSETS
    assert pab.DEFAULT_MODELS == jab.DEFAULT_MODELS
    assert pab.AblationConfig().channel_subsets == jab.AblationConfig().channel_subsets


def test_summary_files_match_jax_byte_for_byte(tmp_path):
    """ablation_summary.txt (ranked by accuracy) and ablation_results.json
    from the same points."""
    rng = np.random.default_rng(0)
    points = [jab.AblationPoint(f"{s}__{m}", jab.DEFAULT_CHANNEL_SUBSETS[s], m,
                                *rng.uniform(0, 1, 4).tolist(), float(rng.uniform(1, 300)))
              for s in ("ecg", "fusion4", "wrist2") for m in jab.DEFAULT_MODELS]
    port = [pab.AblationPoint(**dataclasses.asdict(p)) for p in points]
    for d in ("port", "jax"):
        (tmp_path / d).mkdir()
    pab._write_summary(tmp_path / "port", port)
    jab._write_summary(tmp_path / "jax", points)
    for name in ("ablation_summary.txt", "ablation_results.json"):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()


@pytest.mark.parametrize("execution,subsets,models", [
    ("sharded", ("ecg", "fusion4"), ("cnn_gru_attention", "cnn_gru")),
    ("serial", ("eda",), ("cnn_gru",))])
def test_ablation_cli_runs_the_grid(execution, subsets, models, tree, tmp_path):
    """The CLI at --device cpu: a point per (subset, model) in its own run
    directory, the summary of finite points, and each point's mean
    accuracy that of its LOSO run alone (C=1 takes the channel gate's
    constant path, C=4 the active one)."""
    pab.main(["--device", "cpu", "--out", str(tmp_path / "out"), "--execution", execution,
              "--subsets", *subsets, "--models", *models,
              "--set", f"data_path={tree}", "--set", "subjects=" + ",".join(SUBJECTS)] + SMALL)
    (run_dir,) = (tmp_path / "out").iterdir()
    results = json.loads((run_dir / "ablation_results.json").read_text())
    names = [f"{s}__{m}" for s in subsets for m in models]
    assert [r["name"] for r in results] == names
    assert all(np.isfinite([r[k] for k in ("mean_accuracy", "std_accuracy", "mean_f1",
                                           "std_f1", "wall_s")]).all() for r in results)
    text = (run_dir / "ablation_summary.txt").read_text()
    assert text.startswith("Ablation sweep summary (ranked by mean LOSO accuracy)\n")
    assert all(n in text for n in names)
    base = json.loads((run_dir / "base_config.json").read_text())
    assert base["model"]["gru_hidden_size"] == 8 and tuple(base["subjects"]) == SUBJECTS
    for r in results:
        summary = (run_dir / r["name"] / "cv_summary.txt").read_text()
        assert summary.count("  - test S") == 3
    if execution == "sharded":
        cfg = pcfg.config_from_dict(pcfg.ExperimentConfig, base)
        point = results[0]
        alone = dataclasses.replace(
            cfg, run_name=point["name"], channels_to_use=tuple(point["channels"]),
            model=dataclasses.replace(cfg.model, name=point["model"]))
        _, summary = run_sharded_experiment(alone, tmp_path / "alone", device="cpu")
        assert summary["mean_accuracy"] == point["mean_accuracy"]


def test_ablation_cli_refuses_an_unknown_subset(tmp_path):
    with pytest.raises(SystemExit):
        pab.main(["--device", "cpu", "--out", str(tmp_path), "--subsets", "ecg", "nose"])
    assert not any(tmp_path.iterdir())


def test_ablation_asks_for_cuda_by_default(tree, tmp_path):
    """Without --device cpu the ablation CLI raises where there is no CUDA,
    before it makes a run directory."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without CUDA")
    with pytest.raises(RuntimeError, match="cuda"):
        pab.main(["--out", str(tmp_path / "out"), "--subsets", "ecg",
                  "--set", f"data_path={tree}"])
    assert not (tmp_path / "out").exists()
