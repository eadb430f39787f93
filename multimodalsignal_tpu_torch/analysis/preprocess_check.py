"""Preprocess-output checker (counterpart of
multimodalsignal_tpu/analysis/preprocess_check.py; the reference's test
surrogate).

Parity target: reference preprocess_check.py:33-238 (`PreprocessChecker`) —
validates, for one subject, that preprocessing wrote a coherent dataset:
  1. file existence: name files + X/y npy for the raw-align and feature
     targets (reference :50-83);
  2. shapes/content: X/y window-count agreement, raw-align vs feature sample
     counts, channel/feature dimension vs the name files, NaN/Inf scan
     (reference :85-140);
  3. labels: raw-align vs feature label equality, post-mapping label sets
     within the mode's expected set (reference :142-208).

Differences (documented): mode names follow the current dataset layer
("stress_binary"/"ternary"; the reference checker still used the legacy
"binary"), and results are returned as a dict so the test suite can assert on
them instead of parsing logs.

CLI: python -m multimodalsignal_tpu_torch.analysis.preprocess_check \
        --data ./data --subject S16 --mode stress_binary
"""

from __future__ import annotations

import argparse
from collections import Counter
from pathlib import Path

import numpy as np

from multimodalsignal_tpu_torch.data.dataset import map_labels

EXPECTED_LABELS = {
    "stress_binary": {0, 1},
    "amusement_binary": {0, 1},
    "ternary": {0, 1, 2},
}

_COLORS = {"INFO": "\033[92m", "ERROR": "\033[91m",
           "WARNING": "\033[93m", "HEADER": "\033[95m"}


class PreprocessChecker:
    """Validates integrity, shapes and label consistency of preprocessing
    outputs for one subject."""

    def __init__(
        self,
        data_path: Path | str,
        subject_id: str = "S16",
        classification_mode: str = "stress_binary",
        raw_dir: str = "chest_raw_align",
        feature_dir: str = "chest_feature",
    ):
        data_path = Path(data_path)
        self.raw_path = data_path / raw_dir
        self.feature_path = data_path / feature_dir
        self.sid = subject_id
        self.mode = classification_mode
        self.messages: list[tuple[str, str]] = []

    def _log(self, message: str, level: str = "INFO") -> None:
        self.messages.append((level, message))
        color = _COLORS.get(level, "")
        print(f"{color}[{level}] {message}\033[0m")

    # -- 1. existence ---------------------------------------------------------
    def check_file_existence(self) -> bool:
        self._log(f"--- 1. File existence (subject {self.sid}) ---", "HEADER")
        ok = True
        self.channel_names_path = self.raw_path / "_channel_names.txt"
        self.feature_names_path = self.feature_path / "_feature_names.txt"
        self.raw_x_path = self.raw_path / f"{self.sid}_X.npy"
        self.raw_y_path = self.raw_path / f"{self.sid}_y.npy"
        self.feat_x_path = self.feature_path / f"{self.sid}_X.npy"
        self.feat_y_path = self.feature_path / f"{self.sid}_y.npy"
        for path, what in (
            (self.channel_names_path, "_channel_names.txt"),
            (self.feature_names_path, "_feature_names.txt"),
            (self.raw_x_path, f"{self.sid} raw-align X.npy"),
            (self.raw_y_path, f"{self.sid} raw-align y.npy"),
            (self.feat_x_path, f"{self.sid} feature X.npy"),
            (self.feat_y_path, f"{self.sid} feature y.npy"),
        ):
            if not path.exists():
                self._log(f"{what} not found at {path}!", "ERROR")
                ok = False
        if ok:
            self._log("All required files found.")
        else:
            self._log("Critical files missing; check preprocessing output.", "ERROR")
        return ok

    # -- 2. shapes + content --------------------------------------------------
    def check_data_shape_and_content(self) -> bool:
        self._log(f"--- 2. Shapes and content (subject {self.sid}) ---", "HEADER")
        ok = True
        try:
            channel_names = self.channel_names_path.read_text().split()
            feature_names = self.feature_names_path.read_text().split()
            raw_x = np.load(self.raw_x_path)
            raw_y = np.load(self.raw_y_path)
            feat_x = np.load(self.feat_x_path)
            feat_y = np.load(self.feat_y_path)

            self._log(f"raw-align X shape: {raw_x.shape}; y shape: {raw_y.shape}")
            self._log(f"feature   X shape: {feat_x.shape}; y shape: {feat_y.shape}")
            self._log(f"channels: {len(channel_names)}; features: {len(feature_names)}")

            if raw_x.shape[0] != raw_y.shape[0]:
                self._log("raw-align X/y window counts differ!", "ERROR")
                ok = False
            if feat_x.shape[0] != feat_y.shape[0]:
                self._log("feature X/y window counts differ!", "ERROR")
                ok = False
            if raw_x.shape[0] != feat_x.shape[0]:
                self._log("raw-align vs feature sample counts differ!", "ERROR")
                ok = False
            if raw_x.shape[2] != len(channel_names):
                self._log("raw-align channel count != _channel_names.txt!", "ERROR")
                ok = False
            if feat_x.shape[1] != len(feature_names):
                self._log("feature count != _feature_names.txt!", "ERROR")
                ok = False
            if np.isnan(raw_x).any() or np.isnan(feat_x).any():
                self._log("X data contains NaN values!", "WARNING")
            if np.isinf(raw_x).any() or np.isinf(feat_x).any():
                self._log("X data contains Inf values!", "WARNING")
            if ok:
                self._log("Shape and content checks passed.")
            return ok
        except Exception as e:  # parity: reference logs and fails the check
            self._log(f"Unexpected error while checking data: {e}", "ERROR")
            return False

    # -- 3. labels ------------------------------------------------------------
    def check_label_distribution_and_mapping(self) -> bool:
        self._log(f"--- 3. Label distribution and mapping (subject {self.sid}) ---",
                  "HEADER")
        ok = True
        try:
            raw_y = np.load(self.raw_y_path)
            feat_y = np.load(self.feat_y_path)
            self._log(f"raw-align raw-label counts: {dict(Counter(raw_y.tolist()))}")
            self._log(f"feature   raw-label counts: {dict(Counter(feat_y.tolist()))}")

            if not np.array_equal(raw_y, feat_y):
                self._log("raw-align vs feature raw labels differ!", "ERROR")
                diff = np.where(raw_y != feat_y)[0]
                self._log(f"first mismatching indices: {diff[:10].tolist()}", "ERROR")
                ok = False

            mapped_raw, keep_raw = map_labels(raw_y, self.mode)
            mapped_feat, keep_feat = map_labels(feat_y, self.mode)
            mapped_raw, mapped_feat = mapped_raw[keep_raw], mapped_feat[keep_feat]
            self._log(f"mapped raw-align counts: {dict(Counter(mapped_raw.tolist()))}")
            self._log(f"mapped feature   counts: {dict(Counter(mapped_feat.tolist()))}")

            expected = EXPECTED_LABELS[self.mode]
            if not set(mapped_raw.tolist()) <= expected:
                self._log(f"unexpected mapped raw-align labels: "
                          f"{set(mapped_raw.tolist()) - expected}", "ERROR")
                ok = False
            if not set(mapped_feat.tolist()) <= expected:
                self._log(f"unexpected mapped feature labels: "
                          f"{set(mapped_feat.tolist()) - expected}", "ERROR")
                ok = False
            if not np.array_equal(mapped_raw, mapped_feat):
                self._log("mapped raw-align vs feature labels differ!", "ERROR")
                ok = False
            if ok:
                self._log(f"Label checks passed ({self.mode} mode).")
            return ok
        except Exception as e:
            self._log(f"Unexpected error while checking labels: {e}", "ERROR")
            return False

    # -- all checks -----------------------------------------------------------
    def run_all_checks(self) -> dict:
        self._log(f"===== Checking preprocessed data (subject {self.sid}) =====",
                  "HEADER")
        results = {"files": self.check_file_existence()}
        if results["files"]:
            results["shapes"] = self.check_data_shape_and_content()
            results["labels"] = self.check_label_distribution_and_mapping()
        results["ok"] = all(results.values())
        if results["ok"]:
            self._log("All checks passed; data looks healthy.")
        else:
            self._log("Checks FAILED; fix preprocessing or the data files.", "ERROR")
        self._log("===== Checks complete =====", "HEADER")
        return results


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--data", default="./data", help="preprocessing output root")
    p.add_argument("--subject", default="S16")
    p.add_argument("--mode", default="stress_binary",
                   choices=tuple(EXPECTED_LABELS))
    args = p.parse_args(argv)
    results = PreprocessChecker(args.data, args.subject, args.mode).run_all_checks()
    raise SystemExit(0 if results["ok"] else 1)


if __name__ == "__main__":
    main()
