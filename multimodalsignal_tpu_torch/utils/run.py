"""Run directories (counterpart of multimodalsignal_tpu/utils/run.py's
`make_run_dir`; the JAX compilation cache has no counterpart here)."""

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
