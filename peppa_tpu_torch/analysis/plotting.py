"""Figures over the evaluation's result files, in matplotlib.

The port's copy of peppa_tpu/analysis/plotting.py (reference
pig/plotting.py, plotnine there): the per-ablation score boxplots, the
recall@1..N curve, the duration-effect scatter and trend plots and the
GRSA coefficient plots (reference pig/stats.py:62-73).  They read the files
the evaluation writes (`torch.save`d lists of dicts, CSV) and write PDFs
under results/.  matplotlib, pandas and yaml are imported inside the
functions; the condition columns come from the port's
`evaluation.add_condition` and `pretraining`.
"""

from __future__ import annotations

import os
from typing import Dict, List, Sequence

import numpy as np


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def flatten(X):
    return [y for Y in X for y in Y]


def score_points(data: Sequence[Dict]):
    """Explode bootstrap tensors into per-sample score rows.

    Reference pig/plotting.py:8-24.
    """
    import pandas as pd

    metrics = ["triplet_acc", "recall_at_10_fixed", "recall_at_10_jitter"]
    rows = []
    for row in data:
        for metric in metrics:
            values = np.asarray(row[metric])
            for score in values:
                point = {k: v for k, v in row.items() if k not in metrics
                         and k not in ("recall_fixed", "recall_jitter")}
                point["score"] = (float(score) if metric == "triplet_acc"
                                  else float(np.mean(score)))
                point["metric"] = metric
                rows.append(point)
    return pd.DataFrame.from_records(rows)


def group_runs(conditions: Dict[str, List[int]]) -> Dict[str, List[int]]:
    """Ablation -> run IDs involved (reference pig/plotting.py:26-32)."""
    return dict(
        pretraining=(conditions["base"] + conditions["pretraining_v"]
                     + conditions["pretraining_a"]
                     + conditions["pretraining_none"]),
        freeze_wav2vec=conditions["base"] + conditions["freeze_wav2vec"],
        jitter=conditions["base"] + conditions["jitter"],
        static=conditions["pretraining_a"] + conditions["static"])


def _boxplot_by(ax, data, x_col: str, y_col: str = "score"):
    groups = sorted(data[x_col].dropna().unique(), key=str)
    values = [data.loc[data[x_col] == g, y_col].to_numpy() for g in groups]
    ax.boxplot(values, tick_labels=[str(g) for g in groups], showfliers=False)


def plots(conditions_path: str = "conditions.yaml",
          results_dir: str = "results") -> None:
    """Per-ablation boxplots (reference pig/plotting.py:31-100)."""
    import pandas as pd
    import torch
    import yaml

    from peppa_tpu_torch.evaluation.evaluation import (add_condition,
                                                       pretraining)

    plt = _plt()
    with open(conditions_path) as f:
        configs = yaml.safe_load(f)
    conditions = group_runs(configs)
    versions = flatten(conditions.values())
    data = flatten([torch.load(
        os.path.join(results_dir, f"full_scores_v{v}.pt"), weights_only=False)
        for v in versions])
    data = add_condition(data)
    data = score_points(data)
    data["pretraining"] = pd.Categorical(
        data.apply(pretraining, axis=1), categories=["None", "V", "A", "AV"])
    data["version"] = data["version"].astype(int)
    os.makedirs(os.path.join(results_dir, "ablations"), exist_ok=True)

    for condition, vers in conditions.items():
        sub = data[data["version"].isin(vers)
                   & ~data["scrambled_video"].astype(bool)]
        metrics = (["triplet_acc", "recall_at_10_fixed"]
                   if condition != "jitter"
                   else ["recall_at_10_fixed", "recall_at_10_jitter"])
        fig, axes = plt.subplots(1, len(metrics),
                                 figsize=(5 * len(metrics), 4))
        axes = np.atleast_1d(axes)
        x_col = condition if condition in sub.columns else "fragment_type"
        for ax, metric in zip(axes, metrics):
            _boxplot_by(ax, sub[sub["metric"] == metric], x_col)
            ax.set_title(metric)
            ax.set_xlabel(x_col)
        fig.tight_layout()
        fig.savefig(os.path.join(results_dir, "ablations",
                                 f"{condition}.pdf"))
        plt.close(fig)

    # scrambled-video control on the base runs
    sub = data[data["version"].isin(configs["base"])]
    metrics = ["triplet_acc", "recall_at_10_fixed"]
    fig, axes = plt.subplots(1, len(metrics), figsize=(10, 4))
    for ax, metric in zip(np.atleast_1d(axes), metrics):
        _boxplot_by(ax, sub[sub["metric"] == metric], "scrambled_video")
        ax.set_title(metric)
        ax.set_xlabel("scrambled_video")
    fig.tight_layout()
    fig.savefig(os.path.join(results_dir, "ablations", "scrambled_video.pdf"))
    plt.close(fig)


def recall_at_1_to_n_plot(results_dir: str = "results") -> None:
    """recall@1..N curves on the test set (reference pig/plotting.py:103-120)."""
    import torch

    plt = _plt()
    data = torch.load(os.path.join(results_dir, "full_test_scores.pt"),
                      weights_only=False)
    rows = [d for d in data if not d["scrambled_video"]]
    fig, ax = plt.subplots(figsize=(7, 3.5))
    for key, label, color in (("recall_fixed", "fixed", "C0"),
                              ("recall_jitter", "jitter", "C1")):
        # (n_samples, N+1, size) -> per-sample mean over subjects
        curves = np.concatenate([np.asarray(r[key]).mean(axis=2)
                                 for r in rows])  # (samples, N+1)
        ns = np.arange(1, curves.shape[1])
        mean = curves[:, 1:].mean(axis=0)
        lo = np.percentile(curves[:, 1:], 2.5, axis=0)
        hi = np.percentile(curves[:, 1:], 97.5, axis=0)
        ax.plot(ns, mean, label=label, color=color)
        ax.fill_between(ns, lo, hi, alpha=0.25, color=color)
    ax.set_xlabel("N")
    ax.set_ylabel("recall@N")
    ax.legend()
    fig.tight_layout()
    fig.savefig(os.path.join(results_dir, "recall_at_1_to_n_test.pdf"))
    plt.close(fig)


def duration_effect_plot(conditions_path: str = "conditions.yaml",
                         results_dir: str = "results",
                         scramble: bool = False) -> None:
    """Triplet-success difference vs clip duration (pig/plotting.py:123-147)."""
    import pandas as pd
    import torch
    import yaml

    plt = _plt()
    name = "duration_effect_scramble" if scramble else "duration_effect"
    duration = torch.load(os.path.join(results_dir, f"{name}.pt"),
                          weights_only=False)
    with open(conditions_path) as f:
        static = yaml.safe_load(f)["static"]
    frames = []
    for ft in duration:
        for i, version in enumerate(ft["model_ids"]):
            frames.append(pd.DataFrame(dict(
                fragment_type=ft["fragment_type"], version=version,
                success=np.asarray(ft["success"][i]),
                duration=np.asarray(ft["duration"]))))
    data = pd.concat(frames)
    split_col = "scrambled" if scramble else "static"
    if scramble:
        data[split_col] = False  # comparative variant carries its own flags
    else:
        data[split_col] = data["version"].map(lambda v: v in static)
    grouped = (data.groupby([split_col, "duration", "fragment_type"])
               ["success"].agg(["mean", "size"]))
    diff = (grouped.xs(False, level=split_col)[["mean"]]
            - grouped.xs(True, level=split_col)[["mean"]]
            if grouped.index.get_level_values(0).nunique() > 1
            else grouped.droplevel(0)[["mean"]])
    size = (grouped.xs(grouped.index.get_level_values(0)[0],
                       level=split_col)[["size"]])
    wdata = pd.concat([diff, size], axis=1).reset_index()
    frag_types = wdata["fragment_type"].unique()
    fig, axes = plt.subplots(1, len(frag_types),
                             figsize=(5 * len(frag_types), 4), squeeze=False)
    for ax, ftype in zip(axes[0], frag_types):
        sub = wdata[wdata["fragment_type"] == ftype]
        ax.scatter(sub["duration"], sub["mean"],
                   s=np.sqrt(sub["size"]) * 4, alpha=0.5)
        if len(sub) > 2:
            coef = np.polyfit(sub["duration"], sub["mean"], 2,
                              w=sub["size"])
            xs = np.linspace(sub["duration"].min(), sub["duration"].max(), 50)
            ax.plot(xs, np.polyval(coef, xs), color="C1")
        ax.set_title(ftype)
        ax.set_xlabel("duration")
        ax.set_ylabel("difference")
    fig.tight_layout()
    fig.savefig(os.path.join(results_dir, f"{name}.pdf"))
    plt.close(fig)


def plot_coef(table, fragment_type: str, multiword: bool,
              results_dir: str = "results") -> None:
    """GRSA OLS coefficient plot (reference pig/stats.py:62-73)."""
    plt = _plt()
    sub = table[(table["multiword"] == multiword)
                & (table["fragment_type"] == fragment_type)]
    if not len(sub):
        return
    fig, ax = plt.subplots(figsize=(6, 4))
    variables = [v for v in sub["Variable"].unique() if v != "Intercept"]
    for vi, var in enumerate(variables):
        rows = sub[sub["Variable"] == var]
        for ri, (_, row) in enumerate(rows.iterrows()):
            y = vi + ri * 0.15
            ax.errorbar(row["Coefficient"], y,
                        xerr=[[max(row["Coefficient"] - row["Lower"], 0.0)],
                              [max(row["Upper"] - row["Coefficient"], 0.0)]],
                        fmt="o", color=f"C{ri}", capsize=3)
    ax.axvline(0, color="gray", linestyle="--")
    ax.set_yticks(range(len(variables)))
    ax.set_yticklabels(variables)
    ax.set_xlabel("Coefficient")
    fig.tight_layout()
    os.makedirs(results_dir, exist_ok=True)
    fig.savefig(os.path.join(
        results_dir,
        f"grsa_{fragment_type}_{'multi' if multiword else ''}word_coef.pdf"))
    plt.close(fig)
