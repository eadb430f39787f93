"""Handcrafted-feature distribution exploration (counterpart of
multimodalsignal_tpu/analysis/feature_distributions.py).

Parity target: reference explore_feature_distributions.py:21-177 —
  * violin + strip plot per feature across the three states
    (reference :60-87, artifact feature_distributions_violin.png);
  * pairplot of the top-5 features, colorblind-safe palette
    (reference :90-115, artifact feature_pairplot.png);
  * PCA + t-SNE 2-D projections colored by state
    (reference :119-177, artifact feature_projections.png).

Top-5 selection uses ANOVA F-scores (sklearn f_classif) — an explicit,
reproducible criterion (the reference hand-maintains its top list).
State naming follows the reference's LABEL_INT_TO_STR_MAP
(preprocess_check.py:20-26): Base/Medi -> baseline, TSST -> stress,
Fun -> amusement.

A host tool: pandas, scikit-learn, matplotlib and seaborn are imported
where they are used, and a missing one raises ImportError naming it.

CLI: python -m multimodalsignal_tpu_torch.analysis.feature_distributions \
        --data ./data/chest_feature --out ./analysis_out
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from multimodalsignal_tpu_torch.analysis.feature_importance import (
    load_feature_corpus,
    pyplot,
    require,
)
from multimodalsignal_tpu_torch.config import ALL_SUBJECTS

LABEL_INT_TO_STR = {1: "baseline", 2: "stress", 3: "amusement", 4: "baseline"}
STATE_ORDER = ["baseline", "amusement", "stress"]
# Colorblind-safe palette (reference explore_feature_distributions.py:107).
PALETTE = {"baseline": "#0072B2", "amusement": "#009E73", "stress": "#D55E00"}


def prepare_dataframe(feature_path: Path | str, subjects=ALL_SUBJECTS):
    """Features + human-readable state labels as a pandas DataFrame
    (reference explore_feature_distributions.py:21-57)."""
    pd = require("pandas")
    x, y_raw, names = load_feature_corpus(feature_path, subjects)
    df = pd.DataFrame(x, columns=names)
    df["label_int"] = y_raw
    df["label"] = df["label_int"].map(LABEL_INT_TO_STR)
    if df["label"].isnull().any():
        print("Warning: unmapped raw labels:",
              df.loc[df["label"].isnull(), "label_int"].unique())
        df = df.dropna(subset=["label"])
    return df, names


def top_features_by_anova(df, names: list[str], k: int = 5) -> list[str]:
    f_classif = require("sklearn.feature_selection").f_classif
    f_scores, _ = f_classif(df[names].to_numpy(), df["label"].to_numpy())
    f_scores = np.nan_to_num(f_scores)
    order = np.argsort(f_scores)[::-1]
    return [names[i] for i in order[:k]]


def plot_univariate_distributions(df, names, out_file: Path) -> None:
    plt, sns = pyplot(), require("seaborn")
    n_cols = 4
    n_rows = -(-len(names) // n_cols)
    fig, axes = plt.subplots(n_rows, n_cols, figsize=(20, 5 * n_rows),
                             squeeze=False)
    axes = axes.ravel()
    for i, feature in enumerate(names):
        sns.violinplot(x="label", y=feature, data=df, order=STATE_ORDER,
                       hue="label", palette=PALETTE, legend=False, ax=axes[i])
        sns.stripplot(x="label", y=feature, data=df, order=STATE_ORDER,
                      color="k", alpha=0.1, size=2, ax=axes[i])
        axes[i].set_title(f"Distribution of {feature}")
        axes[i].set_xlabel("Condition")
    for ax in axes[len(names):]:
        ax.set_visible(False)
    fig.suptitle("Univariate Feature Distributions Across States", fontsize=18)
    fig.tight_layout()
    fig.savefig(out_file, dpi=150)
    plt.close(fig)
    print(f"Saved: {out_file}")


def plot_bivariate_relationships(df, top_features: list[str], out_file: Path) -> None:
    plt, sns = pyplot(), require("seaborn")
    grid = sns.pairplot(df[top_features + ["label"]], vars=top_features,
                        hue="label", hue_order=STATE_ORDER, palette=PALETTE,
                        plot_kws={"alpha": 0.5, "s": 15})
    grid.fig.suptitle("Pairwise Relationships of Top Features by State", y=1.02)
    grid.fig.savefig(out_file, dpi=150)
    plt.close(grid.fig)
    print(f"Saved: {out_file}")


def plot_multivariate_projection(df, names, out_file: Path, seed: int = 42) -> None:
    plt, sns = pyplot(), require("seaborn")
    PCA = require("sklearn.decomposition").PCA
    TSNE = require("sklearn.manifold").TSNE
    StandardScaler = require("sklearn.preprocessing").StandardScaler

    x = StandardScaler().fit_transform(df[names].to_numpy())
    labels = df["label"].to_numpy()
    pca = PCA(n_components=2).fit_transform(x)
    perplexity = min(30, max(2, len(x) // 4))
    tsne = TSNE(n_components=2, perplexity=perplexity, random_state=seed).fit_transform(x)

    fig, axes = plt.subplots(1, 2, figsize=(16, 7))
    for ax, proj, title in ((axes[0], pca, "PCA"), (axes[1], tsne, "t-SNE")):
        sns.scatterplot(x=proj[:, 0], y=proj[:, 1], hue=labels,
                        hue_order=STATE_ORDER, palette=PALETTE,
                        s=40, alpha=0.7, ax=ax)
        ax.set_title(f"{title} projection of handcrafted features")
    fig.tight_layout()
    fig.savefig(out_file, dpi=150)
    plt.close(fig)
    print(f"Saved: {out_file}")


def explore_feature_distributions(
    feature_path: Path | str,
    out_dir: Path | str = ".",
    subjects=ALL_SUBJECTS,
) -> list[str]:
    """Produce all three artifact PNGs; returns the top-5 feature list."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    df, names = prepare_dataframe(feature_path, subjects)
    top5 = top_features_by_anova(df, names, k=5)
    print(f"Top-5 features by ANOVA F-score: {top5}")
    plot_univariate_distributions(df, names, out_dir / "feature_distributions_violin.png")
    plot_bivariate_relationships(df, top5, out_dir / "feature_pairplot.png")
    plot_multivariate_projection(df, names, out_dir / "feature_projections.png")
    return top5


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--data", default="./data/chest_feature")
    p.add_argument("--out", default=".")
    p.add_argument("--subjects", nargs="*", default=list(ALL_SUBJECTS))
    args = p.parse_args(argv)
    explore_feature_distributions(args.data, args.out, tuple(args.subjects))


if __name__ == "__main__":
    main()
