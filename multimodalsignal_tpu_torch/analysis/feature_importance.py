"""Handcrafted-feature importance analysis (counterpart of
multimodalsignal_tpu/analysis/feature_importance.py).

Parity target: reference analyze_features.py:10-85 — load every subject's
feature matrix, train a gradient-boosted classifier, rank + plot feature
importances for (a) the three-state problem and (b) Neutral-vs-Amusement.

Deliberate fixes (as in the JAX package):
  * The reference feeds labels `y - 1` into a "3-class" XGBoost while the
    data still contains Medi windows (raw label 4 -> class 3), silently
    training a 4-class model under a 3-class title. Here labels go through
    the dataset layer's ternary mapping (Base/Medi -> Neutral), matching the
    classifier the plots claim to describe.
  * xgboost is not a hard dependency: it is used when importable, else
    scikit-learn's RandomForest importances.

A host tool: scikit-learn (or xgboost) and matplotlib are imported where
they are used, and a missing one raises ImportError naming it.

CLI: python -m multimodalsignal_tpu_torch.analysis.feature_importance \
        --data ./data/chest_feature --out ./analysis_out
"""

from __future__ import annotations

import argparse
import importlib
from pathlib import Path

import numpy as np

from multimodalsignal_tpu_torch.config import ALL_SUBJECTS
from multimodalsignal_tpu_torch.data.dataset import map_labels


def require(module: str):
    """import_module(module), or an ImportError that names the missing
    package: the feature analysis needs scikit-learn, matplotlib, seaborn
    and pandas, which a GPU host may not have."""
    try:
        return importlib.import_module(module)
    except ImportError as exc:
        package = {"sklearn": "scikit-learn"}.get(module.split(".")[0], module.split(".")[0])
        raise ImportError(f"{package} is missing: the feature analysis "
                          f"(multimodalsignal_tpu_torch.analysis) needs it for {module}") from exc


def load_feature_corpus(
    feature_path: Path | str, subjects=ALL_SUBJECTS
) -> tuple[np.ndarray, np.ndarray, list[str]]:
    """Concatenate all subjects' (X, y_raw) plus the feature-name contract
    (reference analyze_features.py:14-31)."""
    feature_path = Path(feature_path)
    xs, ys = [], []
    for sid in subjects:
        x_file = feature_path / f"{sid}_X.npy"
        if not x_file.exists():
            print(f"Warning: skipping {sid}, feature file not found.")
            continue
        xs.append(np.load(x_file))
        ys.append(np.load(feature_path / f"{sid}_y.npy"))
    if not xs:
        raise ValueError(f"No feature data found under {feature_path}")
    x = np.concatenate(xs, axis=0)
    y = np.concatenate(ys, axis=0)
    names = (feature_path / "_feature_names.txt").read_text().split()
    return np.nan_to_num(x), y, names


def _fit_importances(x: np.ndarray, y: np.ndarray, seed: int = 42) -> np.ndarray:
    try:
        import xgboost as xgb
    except ImportError:
        model = require("sklearn.ensemble").RandomForestClassifier(n_estimators=200,
                                                                   random_state=seed)
    else:
        model = xgb.XGBClassifier(eval_metric="mlogloss", random_state=seed)
    model.fit(x, y)
    return np.asarray(model.feature_importances_, dtype=np.float64)


def rank_features(names: list[str], importances: np.ndarray) -> list[tuple[str, float]]:
    order = np.argsort(importances)[::-1]
    return [(names[i], float(importances[i])) for i in order]


def pyplot():
    """matplotlib.pyplot on the Agg backend (no display)."""
    require("matplotlib").use("Agg")
    return require("matplotlib.pyplot")


def _plot_ranking(ranking: list[tuple[str, float]], title: str, out_file: Path) -> None:
    plt = pyplot()
    names = [n for n, _ in ranking][::-1]
    values = [v for _, v in ranking][::-1]
    fig, ax = plt.subplots(figsize=(10, max(4, 0.4 * len(names))))
    ax.barh(names, values)
    ax.set_xlabel("Importance")
    ax.set_title(title)
    fig.tight_layout()
    fig.savefig(out_file, dpi=150)
    plt.close(fig)
    print(f"Saved: {out_file}")


def analyze_feature_importance(
    feature_path: Path | str,
    out_dir: Path | str = ".",
    subjects=ALL_SUBJECTS,
    seed: int = 42,
) -> dict[str, list[tuple[str, float]]]:
    """Returns {'ternary': ranking, 'amusement': ranking} and writes the two
    PNG artifacts the reference produces (analyze_features.py:55,82)."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    x, y_raw, names = load_feature_corpus(feature_path, subjects)
    print(f"Loaded {x.shape[0]} samples x {x.shape[1]} features")

    # (a) three-state: Neutral vs Amusement vs Stress.
    y3, _ = map_labels(y_raw, "ternary")
    print("\n--- Three-class feature importance ---")
    ranking3 = rank_features(names, _fit_importances(x, y3, seed))
    for name, value in ranking3:
        print(f"  {name}: {value:.4f}")
    _plot_ranking(ranking3,
                  "Feature Importance: Neutral vs Amusement vs Stress",
                  out_dir / "three_class_feature_importance.png")

    # (b) Neutral vs Amusement only (reference analyze_features.py:60-67).
    y2, keep = map_labels(y_raw, "amusement_binary")
    print("\n--- Neutral vs Amusement feature importance ---")
    ranking2 = rank_features(names, _fit_importances(x[keep], y2[keep], seed))
    for name, value in ranking2:
        print(f"  {name}: {value:.4f}")
    _plot_ranking(ranking2,
                  "Feature Importance: Neutral vs Amusement",
                  out_dir / "amusement_feature_importance.png")

    return {"ternary": ranking3, "amusement": ranking2}


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--data", default="./data/chest_feature")
    p.add_argument("--out", default=".")
    p.add_argument("--subjects", nargs="*", default=list(ALL_SUBJECTS))
    args = p.parse_args(argv)
    analyze_feature_importance(args.data, args.out, tuple(args.subjects))


if __name__ == "__main__":
    main()
