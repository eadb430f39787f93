"""One-command CI on the GPU: CUDA kernel tier + perf bench + regression gate.

Counterpart of multimodalsignal_tpu/tpu_ci.py for the port. It

  1. runs the CUDA kernel tier (`pytest -m cuda` over
     tests/test_torch_cuda_kernels.py with MMS_TEST_CUDA=1: the hand-written
     kernels on the card against their plain versions; every other test of
     the port runs the plain versions on the CPU). `--noconftest`, because
     tests/conftest.py sets up JAX, which the GPU machine does not have;
  2. runs the port's bench (`python -m multimodalsignal_tpu_torch.bench`:
     train steps/sec of a captured CUDA graph of the flagship step);
  3. compares the measured value against the committed baseline
     (multimodalsignal_tpu_torch/gpu_bench_baseline.json) and exits 2 when it
     regresses below baseline*(1-tolerance); 1, with no verdict, when the
     bench's metric (dtype, shape, mode) is not the pin's.

Run on a GPU host, from the repository's root:

    python -m multimodalsignal_tpu_torch.gpu_ci [-- --steps 100]

--update-baseline re-pins the baseline to the freshly measured value (commit
the diff deliberately, with the reason in PERF.md); a missing baseline file
is created from the run. The 5 % tolerance is tpu_ci's.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
BASELINE = Path(__file__).resolve().parent / "gpu_bench_baseline.json"
KERNEL_TIER = REPO / "tests" / "test_torch_cuda_kernels.py"


def _require_cuda() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit(
            "gpu_ci must run on a CUDA host (torch.cuda.is_available() is "
            "False). Launch it where PyTorch sees a GPU.")


def card() -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "a card nvidia-smi could not name"


def run_kernel_tier() -> None:
    env = dict(os.environ, MMS_TEST_CUDA="1")
    print("[gpu_ci] CUDA kernel tier: pytest -m cuda", flush=True)
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "--noconftest", "-p", "no:cacheprovider",
         str(KERNEL_TIER), "-m", "cuda", "-q"],
        env=env, cwd=REPO,
    )
    if proc.returncode != 0:
        raise SystemExit(f"[gpu_ci] kernel tier FAILED (exit {proc.returncode})")


def run_bench(bench_args: list[str]) -> dict:
    print("[gpu_ci] perf bench: python -m multimodalsignal_tpu_torch.bench", *bench_args,
          flush=True)
    proc = subprocess.run(
        [sys.executable, "-m", "multimodalsignal_tpu_torch.bench", *bench_args],
        capture_output=True, text=True, cwd=REPO,
    )
    sys.stdout.write(proc.stdout)
    if proc.returncode != 0:
        sys.stderr.write(proc.stderr)
        raise SystemExit(f"[gpu_ci] bench FAILED (exit {proc.returncode})")
    for line in reversed(proc.stdout.splitlines()):
        line = line.strip()
        if line.startswith("{"):
            return json.loads(line)
    raise SystemExit("[gpu_ci] bench printed no JSON result line")


def check_baseline(result: dict, baseline_path: Path, update: bool) -> int:
    value = float(result["value"])
    if update or not baseline_path.exists():
        baseline_path.parent.mkdir(parents=True, exist_ok=True)
        baseline_path.write_text(json.dumps({
            "metric": result["metric"],
            "steps_per_sec": value,
            "tolerance": 0.05,
            "note": f"GPU-path perf pin for gpu_ci, measured on {card()}; re-pin "
                    "with `python -m multimodalsignal_tpu_torch.gpu_ci "
                    "--update-baseline` and record why in PERF.md",
        }, indent=2) + "\n")
        print(f"[gpu_ci] baseline {'re-pinned' if update else 'created'}: "
              f"{value:.1f} steps/s -> {baseline_path}")
        return 0
    base = json.loads(baseline_path.read_text())
    if base["metric"] != result["metric"]:
        # Another dtype, shape or mode measures another rate: no verdict.
        print(f"[gpu_ci] the bench measured {result['metric']!r}, the baseline pins "
              f"{base['metric']!r}: not compared. Run the pinned configuration, or "
              "re-pin with --update-baseline")
        return 1
    pin, tol = float(base["steps_per_sec"]), float(base["tolerance"])
    floor = pin * (1.0 - tol)
    ratio = value / pin
    if value < floor:
        print(f"[gpu_ci] PERF REGRESSION: {value:.1f} steps/s < floor "
              f"{floor:.1f} (baseline {pin:.1f}, tolerance {tol:.0%}, "
              f"ratio {ratio:.3f})")
        return 2
    verdict = "OK"
    if value > pin * (1.0 + tol):
        verdict = ("OK (above the +tolerance band — consider re-pinning "
                   "with --update-baseline)")
    print(f"[gpu_ci] perf {verdict}: {value:.1f} steps/s vs baseline "
          f"{pin:.1f} (ratio {ratio:.3f}, floor {floor:.1f})")
    return 0


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--skip-tests", action="store_true",
                   help="run only the bench + regression gate")
    p.add_argument("--skip-bench", action="store_true",
                   help="run only the kernel tier")
    p.add_argument("--update-baseline", action="store_true",
                   help="re-pin the committed baseline to this run's value")
    p.add_argument("--baseline", type=Path, default=BASELINE)
    p.add_argument("bench_args", nargs="*",
                   help="extra args forwarded to the bench (after '--')")
    return p


def main(argv=None) -> None:
    args = parser().parse_args(argv)
    _require_cuda()
    if not args.skip_tests:
        run_kernel_tier()
    rc = 0
    if not args.skip_bench:
        result = run_bench(args.bench_args)
        rc = check_baseline(result, args.baseline, args.update_baseline)
    raise SystemExit(rc)


if __name__ == "__main__":
    main()
