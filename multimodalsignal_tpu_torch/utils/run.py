"""Run directories and the training log (counterpart of
multimodalsignal_tpu/utils/run.py's `make_run_dir` and `TeeLogger`; the JAX
compilation cache has no counterpart here)."""

from __future__ import annotations

import os
import time
from pathlib import Path


def make_run_dir(output_root: Path | str, run_name: str) -> Path:
    """Create <output_root>/<run_name>/run_<timestamp>/.

    MMS_RUN_ID replaces the timestamp only beside MMS_NUM_PROCESSES (a
    launch of several processes that must agree on one directory), so a
    stale exported MMS_RUN_ID cannot make a later single-process run reuse
    and overwrite an old directory."""
    run_id = None
    if os.environ.get("MMS_NUM_PROCESSES"):
        run_id = os.environ.get("MMS_RUN_ID")
    run_dir = (Path(output_root) / run_name
               / f"run_{run_id or time.strftime('%Y%m%d_%H%M%S')}")
    run_dir.mkdir(parents=True, exist_ok=True)
    return run_dir


class TeeLogger:
    """Messages to stdout and to a log file that starts with `header`.

    With append=True an existing log is kept and the header is appended as
    a `--- header ---` banner, so a resumed run (TrainerConfig.resume)
    keeps the epochs logged before the cut."""

    def __init__(self, log_file: Path | str, header: str | None = None,
                 append: bool = False):
        self.log_file = Path(log_file)
        self.log_file.parent.mkdir(parents=True, exist_ok=True)
        if header is not None:
            if append and self.log_file.exists():
                with open(self.log_file, "a") as f:
                    f.write("\n--- " + header + " ---\n")
            else:
                self.log_file.write_text(header + "\n" + "=" * 50 + "\n")

    def __call__(self, message: str) -> None:
        print(message)
        with open(self.log_file, "a") as f:
            f.write(message + "\n")
