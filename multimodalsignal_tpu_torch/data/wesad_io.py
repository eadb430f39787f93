"""WESAD raw pickle loading (a copy of multimodalsignal_tpu/data/wesad_io.py).

Parity target: reference preprocess.py:60-68 (`load_pkl`) — byte-keyed dicts
from the original WESAD pickles, decoded into str-keyed channel arrays.
"""

from __future__ import annotations

import pickle
from pathlib import Path

import numpy as np


def load_pkl(pkl_path: Path | str) -> dict:
    """Load any WESAD-format pickle by path (byte-keyed), e.g. for inference
    on a new recording."""
    with open(pkl_path, "rb") as f:
        return pickle.load(f, encoding="bytes")


def load_subject_pkl(subject_id: str, wesad_root: Path | str) -> dict | None:
    """Load S*/S*.pkl with encoding='bytes'; returns None if missing
    (reference prints a warning and skips the subject, preprocess.py:66-68)."""
    pkl_path = Path(wesad_root) / subject_id / f"{subject_id}.pkl"
    try:
        with open(pkl_path, "rb") as f:
            return pickle.load(f, encoding="bytes")
    except FileNotFoundError:
        print(f"Warning: could not find file {pkl_path}")
        return None


def chest_signals(data: dict) -> dict[str, np.ndarray]:
    """Extract the chest-device channel dict with str keys
    (reference preprocess.py:143-144 decodes the byte keys)."""
    chest = data[b"signal"][b"chest"]
    return {k.decode("utf-8"): np.asarray(v) for k, v in chest.items()}


# Native sampling rates of the wrist (Empatica E4) device in WESAD.
# The reference never ingests the wrist device (its code is chest-only;
# its README's wrist mentions are drift — SURVEY.md §7 quirk e). Supported
# here as an extension: each sensor is recorded at its own rate and must be
# resampled individually onto the common grid.
WRIST_RATES = {"ACC": 32, "BVP": 64, "EDA": 4, "TEMP": 4}


def wrist_signals(data: dict) -> dict[str, np.ndarray] | None:
    """Extract the wrist-device channel dict with str keys, or None when the
    recording has no wrist data."""
    wrist = data.get(b"signal", {}).get(b"wrist")
    if wrist is None:
        return None
    return {k.decode("utf-8"): np.asarray(v) for k, v in wrist.items()}
