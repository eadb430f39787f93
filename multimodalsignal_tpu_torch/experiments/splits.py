"""LOSO fold construction (counterpart of multimodalsignal_tpu/experiments/splits.py).

For each held-out test subject the remaining subjects are split into train
and validation as sklearn's train_test_split(..., test_size=val_fraction,
random_state=seed) splits them. The port does not depend on scikit-learn:
it always runs the replica of sklearn's ShuffleSplit (a permutation by a
seeded legacy RandomState; the first ceil(val_fraction * n) permuted entries
are validation), which gives the same subjects in the same order.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Sequence

import numpy as np


@dataclass(frozen=True)
class FoldSpec:
    """One LOSO fold: which subject is held out and how the rest split."""

    test_subject: str
    train_subjects: tuple[str, ...]
    val_subjects: tuple[str, ...]


def train_val_split(subjects: Sequence[str], val_fraction: float = 0.2,
                    seed: int = 42) -> tuple[list[str], list[str]]:
    """sklearn.model_selection.train_test_split's split of a subject list,
    through its ShuffleSplit algorithm: (train, val)."""
    n = len(subjects)
    n_val = int(math.ceil(val_fraction * n))
    perm = np.random.RandomState(seed).permutation(n)
    val_idx = perm[:n_val]
    train_idx = perm[n_val:]
    return [subjects[i] for i in train_idx], [subjects[i] for i in val_idx]


def loso_folds(subjects: Sequence[str], val_fraction: float = 0.2,
               seed: int = 42) -> list[FoldSpec]:
    """All leave-one-subject-out folds, in the order of `subjects`."""
    folds = []
    for test_subject in subjects:
        rest = [s for s in subjects if s != test_subject]
        train, val = train_val_split(rest, val_fraction, seed)
        folds.append(FoldSpec(test_subject, tuple(train), tuple(val)))
    return folds
