"""Experiment CLI of the port (counterpart of multimodalsignal_tpu/main.py).

    python -m multimodalsignal_tpu_torch.main                    # sharded sweep
    python -m multimodalsignal_tpu_torch.main --execution serial \
        --config cfg.json --set model.gru_impl=pallas_fused --set trainer.epochs=50
    python -m multimodalsignal_tpu_torch.main --device cpu
    python -m multimodalsignal_tpu_torch.main --from-pickles ./WESAD
    python -m multimodalsignal_tpu_torch.main --set model.name=hybrid_cnn_gru \
        --set raw_align_path=./data/chest_raw_align --set feature_path=./data/chest_feature
    python -m multimodalsignal_tpu_torch.main --seeds 42 43 44 45 [--seed-chunk 2]
    python -m multimodalsignal_tpu_torch.main --hierarchical [--execution serial] \
        --set base.trainer.epochs=50 --set m2_model.gru_hidden_size=32
    python -m multimodalsignal_tpu_torch.main --profile-dir ./trace
    python -m multimodalsignal_tpu_torch.main --output-dir ./out \
        --set trainer.checkpoint_every=5 [--set trainer.resume=true]

Creates <output_dir>/<run_name>/run_<timestamp>/, writes config.json there
and runs the LOSO experiment on the GPU, or on the CPU with --device cpu:
the sharded sweep (parallel/fold_sweep.py: every fold a lane of one model,
all in lockstep on one device), which is the config's default
fold_execution, or with --execution serial one fold after another
(experiments/loso.py). --from-pickles stages the sweep straight from the
raw WESAD pickles (sharded only; the serial path reads the preprocess CLI's
npy files). --seeds runs the seed-replicated sweep (parallel/
replicated_sweep.py: folds x seeds as lanes, sharded only; --seed-chunk
bounds the seed groups a launch). --hierarchical takes a HierarchicalConfig
(overrides under base., m1_model., m2_model.) and runs the two-stage
experiment: two sweeps and a composed evaluation (parallel/
hierarchical_sweep.py, the default) or, with --execution serial, fold
after fold (experiments/hierarchical.py); --from-pickles goes into its
base config, sharded only. --profile-dir writes a torch.profiler trace of
the sharded sweep (the plain LOSO sweep only). Mid-run resume has no flag,
as in the JAX CLI: trainer.checkpoint_every=N saves the state every N
epochs (the sweep's bundle in the run directory, the serial Trainer's in
each fold's directory) and trainer.resume=true goes on from it; a resumed
run names its earlier run directory (MMS_RUN_ID with MMS_NUM_PROCESSES, as
utils/run.py says, or the library calls).

Several processes (parallel/multihost.py), as the JAX CLI joins them: with
MMS_COORDINATOR=host:port, MMS_NUM_PROCESSES=N and MMS_PROCESS_ID=r set
(and one MMS_RUN_ID for all, so they share the run directory), each of the
N processes joins a gloo process group before anything touches CUDA,
trains on cuda:{r % device_count} (two ranks may share one GPU) and takes
its block of the folds of the sharded sweep, the --seeds sweep or the
--hierarchical sweep; only rank 0 writes the run directory. A group that
cannot form raises. --execution serial is refused under more than one
process (the serial loops know nothing of processes).

    MMS_COORDINATOR=localhost:29511 MMS_NUM_PROCESSES=2 MMS_PROCESS_ID=0 \
        MMS_RUN_ID=r1 python -m multimodalsignal_tpu_torch.main &
    MMS_COORDINATOR=localhost:29511 MMS_NUM_PROCESSES=2 MMS_PROCESS_ID=1 \
        MMS_RUN_ID=r1 python -m multimodalsignal_tpu_torch.main
"""

from __future__ import annotations

import argparse
import dataclasses
from pathlib import Path

from multimodalsignal_tpu_torch.config import (
    ExperimentConfig,
    HierarchicalConfig,
    load_experiment_config,
    validate_experiment,
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config", type=Path, default=None,
                   help="JSON or YAML config file (ExperimentConfig, or "
                        "HierarchicalConfig with --hierarchical)")
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
                   help="the two-stage ternary experiment (reference main.py:20)")
    p.add_argument("--seeds", nargs="+", type=int, default=None,
                   help="seed-replicated sweep: the whole LOSO at each seed, folds "
                        "x seeds as lanes of one sweep, with training-noise error "
                        "bars (parallel/replicated_sweep.py; sharded only)")
    p.add_argument("--seed-chunk", type=int, default=None,
                   help="with --seeds: at most this many seed groups a launch, one "
                        "launch after another (bounds device memory); halved on "
                        "running out of device memory either way")
    p.add_argument("--from-pickles", type=Path, default=None, metavar="WESAD",
                   help="stage straight from the raw WESAD pickles at this root: "
                        "preprocessing (resample + window) and the corpus pack in "
                        "memory, no npy files (sharded execution only; sets "
                        "cfg.from_pickles)")
    p.add_argument("--profile-dir", type=Path, default=None,
                   help="write a torch.profiler trace of the sharded sweep here")
    return p


def load_config(args) -> ExperimentConfig | HierarchicalConfig:
    cfg = load_experiment_config(HierarchicalConfig if args.hierarchical else ExperimentConfig,
                                 args.config, args.set)
    if args.from_pickles is not None:
        if args.hierarchical:
            cfg = dataclasses.replace(cfg, base=dataclasses.replace(
                cfg.base, from_pickles=str(args.from_pickles)))
        else:
            cfg = dataclasses.replace(cfg, from_pickles=str(args.from_pickles))
    return cfg


def main(argv=None) -> None:
    from multimodalsignal_tpu_torch.parallel import multihost

    # Join the processes before anything touches CUDA.
    if multihost.maybe_initialize_from_env():
        print(f"[multihost] process {multihost.rank()}/{multihost.world_size()} up "
              "(gloo)", flush=True)
    try:
        _main(argv)
        multihost.sync("main done")
    finally:
        multihost.shutdown()


def _device(name: str):
    """The device of this process: a rank of several takes
    cuda:{rank % device_count}."""
    import torch

    from multimodalsignal_tpu_torch.experiments.predict import resolve_device
    from multimodalsignal_tpu_torch.parallel import multihost

    device = resolve_device(name)
    if device.type == "cuda" and multihost.world_size() > 1:
        device = torch.device("cuda", multihost.rank() % torch.cuda.device_count())
        torch.cuda.set_device(device)
    return device


def _main(argv) -> None:
    from multimodalsignal_tpu_torch.parallel import multihost
    from multimodalsignal_tpu_torch.utils.run import make_run_dir

    args = build_parser().parse_args(argv)
    cfg = load_config(args)
    if args.hierarchical:
        execution = args.execution or cfg.base.fold_execution
        if args.seeds:
            raise SystemExit(
                "--seeds is not supported with --hierarchical (the "
                "seed-replicated sweep covers the simple LOSO experiment); "
                "it would otherwise be silently ignored.")
        if cfg.base.from_pickles and execution != "sharded":
            raise SystemExit(
                "--from-pickles requires --execution sharded (the serial "
                "hierarchical path reads the preprocessed npy contract)")
        from multimodalsignal_tpu_torch.experiments.hierarchical import (
            run_hierarchical_experiment,
        )
        from multimodalsignal_tpu_torch.parallel.hierarchical_sweep import (
            run_hierarchical_sharded,
        )

        run = run_hierarchical_experiment if execution == "serial" else run_hierarchical_sharded
        output_dir = cfg.base.output_dir
    else:
        execution = args.execution or cfg.fold_execution
        if cfg.from_pickles and execution != "sharded":
            raise SystemExit("--from-pickles requires --execution sharded (the serial "
                             "path reads the preprocess CLI's npy files)")
        if args.seeds and execution != "sharded":
            raise SystemExit("--seeds requires --execution sharded "
                             "(the replicated sweep is a sharded program)")
        validate_experiment(cfg, fold_execution=execution)
        from multimodalsignal_tpu_torch.experiments.loso import run_simple_experiment
        from multimodalsignal_tpu_torch.parallel.fold_sweep import run_sharded_experiment
        from multimodalsignal_tpu_torch.parallel.replicated_sweep import (
            run_replicated_experiment,
        )

        def run_replicated(cfg, run_dir, device):
            run_replicated_experiment(cfg, tuple(args.seeds), run_dir, device=device,
                                      seed_chunk=args.seed_chunk)

        def run_sharded(cfg, run_dir, device):
            run_sharded_experiment(cfg, run_dir, device=device, profile_dir=args.profile_dir)

        run = (run_replicated if args.seeds else
               run_simple_experiment if execution == "serial" else run_sharded)
        output_dir = cfg.output_dir

    if execution == "serial" and multihost.world_size() > 1:
        raise SystemExit(
            "serial execution runs every fold in every process: with "
            f"MMS_NUM_PROCESSES={multihost.world_size()} run the sharded sweep (the "
            "default execution), which splits the folds over the processes")
    device = _device(args.device)
    run_dir = make_run_dir(args.output_dir or Path(output_dir), cfg.run_name)
    multihost.log(f"Run directory: {run_dir}")
    run(cfg, run_dir, device=device)


if __name__ == "__main__":
    main()
