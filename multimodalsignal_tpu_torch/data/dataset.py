"""Per-subject normalization of windows (counterpart of
multimodalsignal_tpu/data/dataset.py's `normalize_subject`, NumPy float64
path). The rest of the JAX package's dataset layer serves training and is
not ported yet."""

from __future__ import annotations

import numpy as np

EDA_CHANNEL = "chest_EDA"
# Floor for the EDA log1p (keeps it defined when FFT resampling rings below
# -1 at artifact steps).
_LOG1P_FLOOR = -1.0 + 1e-6
NORMALIZATION_SCHEMES = ("all", "baseline", "none")


def normalize_subject(x: np.ndarray, y_raw: np.ndarray,
                      channel_names: list[str], scheme: str = "all") -> np.ndarray:
    """Per-subject normalization of [N, T, C] windows with float64 stats.

    scheme="all":      z-score per channel over all windows; chest_EDA gets
                       log1p first and its own log-domain stats (eps 1e-8).
    scheme="baseline": stats from Base-only (y_raw == 1) windows, with the
                       all-window stats when a subject has none.
    scheme="none":     passthrough.
    """
    if scheme == "none":
        return x.astype(np.float32)
    if scheme not in NORMALIZATION_SCHEMES:
        raise ValueError(f"Unknown normalization scheme: {scheme}")
    x = np.asarray(x, dtype=np.float64)
    out = np.empty_like(x, dtype=np.float32)
    if scheme == "baseline":
        ref = x[y_raw == 1] if (y_raw == 1).any() else x
        if not (y_raw == 1).any():
            print("Warning: no baseline windows; falling back to all-data stats.")
    else:
        ref = x
    for c, name in enumerate(channel_names):
        if name == EDA_CHANNEL:
            log_all = np.log1p(np.maximum(x[:, :, c], _LOG1P_FLOOR))
            log_ref = np.log1p(np.maximum(ref[:, :, c], _LOG1P_FLOOR))
            mean, std = log_ref.mean(), log_ref.std() + 1e-8
            out[:, :, c] = ((log_all - mean) / std).astype(np.float32)
        else:
            mean, std = ref[:, :, c].mean(), ref[:, :, c].std() + 1e-8
            out[:, :, c] = ((x[:, :, c] - mean) / std).astype(np.float32)
    return out
