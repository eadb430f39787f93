"""Experiment CLI of the port (counterpart of multimodalsignal_tpu/main.py).

    python -m multimodalsignal_tpu_torch.main                    # sharded sweep
    python -m multimodalsignal_tpu_torch.main --execution serial \
        --config cfg.json --set model.gru_impl=pallas_fused --set trainer.epochs=50
    python -m multimodalsignal_tpu_torch.main --device cpu
    python -m multimodalsignal_tpu_torch.main --from-pickles ./WESAD
    python -m multimodalsignal_tpu_torch.main --set model.name=hybrid_cnn_gru \
        --set raw_align_path=./data/chest_raw_align --set feature_path=./data/chest_feature

Creates <output_dir>/<run_name>/run_<timestamp>/, writes config.json there
and runs the LOSO experiment on the GPU, or on the CPU with --device cpu:
the sharded sweep (parallel/fold_sweep.py: every fold a lane of one model,
all in lockstep on one device), which is the config's default
fold_execution, or with --execution serial one fold after another
(experiments/loso.py). --from-pickles stages the sweep straight from the
raw WESAD pickles (sharded only; the serial path reads the preprocess CLI's
npy files). Not ported yet, and refused with a non-zero exit rather than run
another way: `--hierarchical` and `--seeds`.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from pathlib import Path

from multimodalsignal_tpu_torch.config import (
    ExperimentConfig,
    apply_overrides,
    config_from_dict,
    load_config_file,
    validate_experiment,
)


def _not_ported(item: int, what: str) -> str:
    return f"is not ported yet (ROADMAP.md, queue 1, item {item}: {what})"


def _parse_value(raw: str):
    """Parse a --set value: JSON first, then a comma list, then a string."""
    try:
        return json.loads(raw)
    except (json.JSONDecodeError, ValueError):
        if "," in raw:
            return tuple(v.strip() for v in raw.split(",") if v.strip())
        return raw


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config", type=Path, default=None,
                   help="JSON or YAML config file (ExperimentConfig)")
    p.add_argument("--execution", choices=("serial", "sharded"), default=None,
                   help="fold execution strategy (overrides the config's "
                        "fold_execution, sharded by default)")
    p.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                   help="dotted-path config override, e.g. trainer.epochs=50")
    p.add_argument("--output-dir", type=Path, default=None,
                   help="override the run output root")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where to train (default cuda; raises without it)")
    p.add_argument("--hierarchical", action="store_true",
                   help="the two-stage ternary experiment (not ported yet)")
    p.add_argument("--seeds", nargs="+", type=int, default=None,
                   help="seed-replicated sweep (not ported yet)")
    p.add_argument("--from-pickles", type=Path, default=None, metavar="WESAD",
                   help="stage straight from the raw WESAD pickles at this root: "
                        "preprocessing (resample + window) and the corpus pack in "
                        "memory, no npy files (sharded execution only; sets "
                        "cfg.from_pickles)")
    return p


def load_config(args) -> ExperimentConfig:
    cfg = (config_from_dict(ExperimentConfig, load_config_file(args.config))
           if args.config is not None else ExperimentConfig())
    overrides = {}
    for item in args.set:
        key, _, raw = item.partition("=")
        overrides[key.strip()] = _parse_value(raw.strip())
    if overrides:
        cfg = apply_overrides(cfg, overrides)
    if args.from_pickles is not None:
        cfg = dataclasses.replace(cfg, from_pickles=str(args.from_pickles))
    return cfg


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    if args.hierarchical:
        raise SystemExit("--hierarchical (the two-stage experiment) "
                         + _not_ported(2, "the hierarchical experiment"))
    if args.seeds:
        raise SystemExit("--seeds (the seed-replicated sweep) "
                         + _not_ported(3, "the other sweeps"))
    cfg = load_config(args)
    execution = args.execution or cfg.fold_execution
    if cfg.from_pickles and execution != "sharded":
        raise SystemExit("--from-pickles requires --execution sharded (the serial "
                         "path reads the preprocess CLI's npy files)")
    validate_experiment(cfg, fold_execution=execution)

    from multimodalsignal_tpu_torch.experiments.loso import run_simple_experiment
    from multimodalsignal_tpu_torch.experiments.predict import resolve_device
    from multimodalsignal_tpu_torch.parallel.fold_sweep import run_sharded_experiment
    from multimodalsignal_tpu_torch.utils.run import make_run_dir

    device = resolve_device(args.device)
    run_dir = make_run_dir(args.output_dir or Path(cfg.output_dir), cfg.run_name)
    print(f"Run directory: {run_dir}")
    run = run_simple_experiment if execution == "serial" else run_sharded_experiment
    run(cfg, run_dir, device=device)


if __name__ == "__main__":
    main()
