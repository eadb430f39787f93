"""Channel and model ablation sweep (counterpart of
multimodalsignal_tpu/experiments/ablation.py).

The reference runs ablations by editing CHANNELS_TO_USE / MODEL_TO_USE
between runs (reference README.md:84-85, main.py:41-55). Here the grid of
channel subsets x model families is one entry point: every grid point is a
whole LOSO run, the sharded sweep (parallel/fold_sweep.py) or the serial
experiment (experiments/loso.py), in <run>/<subset>__<model>/, and
ablation_summary.txt ranks the points by mean LOSO accuracy the way the
reference's README compares multimodal fusion with single channels;
ablation_results.json holds the same numbers. Both in the JAX package's
text. Runs on "cuda" unless the caller passes --device cpu.

CLI::

    python -m multimodalsignal_tpu_torch.experiments.ablation \\
        --config cfg.json --out ./output --subsets ecg fusion4 \\
        --models cnn_gru_attention cnn_gru --set trainer.epochs=50
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from dataclasses import dataclass, field
from pathlib import Path

import torch

from multimodalsignal_tpu_torch.config import (
    ExperimentConfig,
    load_experiment_config,
    save_config,
)

# Named channel subsets of the reference's documented ablations (README.md:
# 84-85: single channels against fusion). "fusion6" is the README's
# multimodal set (chest ECG/EDA/EMG/Resp, wrist BVP/EDA), where the channel
# gate is active (C >= reduction_ratio); the wrist subsets need data
# preprocessed with --include-wrist.
DEFAULT_CHANNEL_SUBSETS: dict[str, tuple[str, ...]] = {
    "fusion6": ("chest_ECG", "chest_EDA", "chest_EMG", "chest_Resp",
                "wrist_BVP", "wrist_EDA"),
    "fusion4": ("chest_ECG", "chest_EDA", "chest_EMG", "chest_Resp"),
    "fusion3": ("chest_ECG", "chest_EDA", "chest_Resp"),
    "ecg": ("chest_ECG",),
    "eda": ("chest_EDA",),
    "resp": ("chest_Resp",),
    "wrist2": ("wrist_BVP", "wrist_EDA"),
}
DEFAULT_MODELS = ("cnn_gru_attention", "cnn_gru")


@dataclass
class AblationPoint:
    name: str
    channels: tuple[str, ...]
    model_name: str
    mean_accuracy: float = float("nan")
    std_accuracy: float = float("nan")
    mean_f1: float = float("nan")
    std_f1: float = float("nan")
    wall_s: float = float("nan")


@dataclass
class AblationConfig:
    base: ExperimentConfig = field(default_factory=ExperimentConfig)
    channel_subsets: dict[str, tuple[str, ...]] = field(
        default_factory=lambda: dict(DEFAULT_CHANNEL_SUBSETS))
    models: tuple[str, ...] = DEFAULT_MODELS


def run_ablation(cfg: AblationConfig, run_output_dir: Path | str,
                 all_channel_names: list[str] | None = None, execution: str = "sharded",
                 device: str | torch.device = "cuda") -> list[AblationPoint]:
    """Run the whole grid; each point's artifacts in <run>/<subset>__<model>/,
    the comparison in ablation_summary.txt and ablation_results.json."""
    from multimodalsignal_tpu_torch.experiments.loso import run_simple_experiment
    from multimodalsignal_tpu_torch.parallel.fold_sweep import run_sharded_experiment

    run = {"sharded": run_sharded_experiment, "serial": run_simple_experiment}[execution]
    run_output_dir = Path(run_output_dir)
    run_output_dir.mkdir(parents=True, exist_ok=True)
    save_config(cfg.base, run_output_dir / "base_config.json")

    points: list[AblationPoint] = []
    for subset_name, channels in cfg.channel_subsets.items():
        for model_name in cfg.models:
            point_name = f"{subset_name}__{model_name}"
            print("\n" + "#" * 80)
            print(f"Ablation point: {point_name} (channels={list(channels)})")
            print("#" * 80)
            point_cfg = dataclasses.replace(
                cfg.base, run_name=point_name, channels_to_use=tuple(channels),
                model=dataclasses.replace(cfg.base.model, name=model_name))
            t0 = time.time()
            _, summary = run(point_cfg, run_output_dir / point_name, all_channel_names,
                             device=device)
            points.append(AblationPoint(
                name=point_name, channels=tuple(channels), model_name=model_name,
                mean_accuracy=summary["mean_accuracy"], std_accuracy=summary["std_accuracy"],
                mean_f1=summary["mean_f1"], std_f1=summary["std_f1"],
                wall_s=time.time() - t0))

    _write_summary(run_output_dir, points)
    return points


def _write_summary(run_dir: Path, points: list[AblationPoint]) -> None:
    ranked = sorted(points, key=lambda p: -p.mean_accuracy)
    lines = [
        "Ablation sweep summary (ranked by mean LOSO accuracy)",
        "",
        f"{'point':<32} {'accuracy':>18} {'weighted F1':>18} {'wall s':>8}",
        "-" * 80,
    ]
    for p in ranked:
        lines.append(
            f"{p.name:<32} {p.mean_accuracy:>8.4f} ± {p.std_accuracy:<7.4f} "
            f"{p.mean_f1:>8.4f} ± {p.std_f1:<7.4f} {p.wall_s:>8.1f}")
    (run_dir / "ablation_summary.txt").write_text("\n".join(lines) + "\n")
    (run_dir / "ablation_results.json").write_text(json.dumps(
        [{"name": p.name, "channels": list(p.channels), "model": p.model_name,
          "mean_accuracy": p.mean_accuracy, "std_accuracy": p.std_accuracy,
          "mean_f1": p.mean_f1, "std_f1": p.std_f1, "wall_s": p.wall_s}
         for p in points], indent=2) + "\n")
    print("\n" + "\n".join(lines))
    print(f"\nAblation summary saved to: {run_dir / 'ablation_summary.txt'}")


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config", type=Path, default=None,
                   help="JSON or YAML for the base ExperimentConfig")
    p.add_argument("--out", type=Path, default=Path("./output/ablation"))
    p.add_argument("--execution", choices=("serial", "sharded"), default="sharded")
    p.add_argument("--models", nargs="*", default=list(DEFAULT_MODELS))
    p.add_argument("--subsets", nargs="*", default=list(DEFAULT_CHANNEL_SUBSETS),
                   help=f"named subsets from {list(DEFAULT_CHANNEL_SUBSETS)}")
    p.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                   help="dotted-path override of the BASE config for every grid "
                        "point (main.py's syntax), e.g. trainer.epochs=50")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where to train (default cuda; raises without it)")
    args = p.parse_args(argv)
    base = load_experiment_config(ExperimentConfig, args.config, args.set)
    unknown = [k for k in args.subsets if k not in DEFAULT_CHANNEL_SUBSETS]
    if unknown:
        p.error(f"unknown subsets {unknown}; expected some of {list(DEFAULT_CHANNEL_SUBSETS)}")
    cfg = AblationConfig(base=base,
                         channel_subsets={k: DEFAULT_CHANNEL_SUBSETS[k] for k in args.subsets},
                         models=tuple(args.models))
    from multimodalsignal_tpu_torch.experiments.predict import resolve_device

    device = resolve_device(args.device)
    run_dir = args.out / f"run_{time.strftime('%Y%m%d_%H%M%S')}"
    print(f"Run directory: {run_dir}")
    run_ablation(cfg, run_dir, execution=args.execution, device=device)


if __name__ == "__main__":
    main()
