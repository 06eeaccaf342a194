"""Minimal-pairs CLI of the port: `python -m peppa_tpu_torch.targeted_eval`.

The `--run` half of the repository's `evaluation_targeted_triplets.py`,
plus `--device` (default: the card; `cpu` for a run on the host):

    python -m peppa_tpu_torch.targeted_eval --run --versions 0 1 \\
        [--log_dir lightning_logs] [--data_dir data]

For each version (a run directory of the port, the JAX package or the
reference), the best model scores the targeted triplets of
`--data_dir/eval/eval_set_narration_{ADJ,VERB,NOUN}.csv`, with the video
scrambled and not, into
`--results_dir/version_N/minimal_pairs_scores.csv`: the eval set's columns
(`id` first) and `result`, `pos`, `fragment`, `scrambled_video`, in the
JAX CLI's row order, written with the `csv` module.  The eval set's cells
are written as read; `result` as Python prints the float.

    python -m peppa_tpu_torch.targeted_eval --plot [--versions 0 1] \
        [--results_dir results/targeted_triplets] [--data_dir data] \
        [--conditions conditions.yaml]

is host work (pandas, scipy and matplotlib, imported inside the
functions): the bootstrapped table of every version's scores
(`minimal_pairs.{csv,tex}` beside `--results_dir`, the bootstrap from
`default_rng(666)` as in the JAX CLI), the per-word and the duration plots
of each condition of `--conditions` (`condition_{name}/*.pdf`), and for
each of `--versions` the accuracy against the words' log frequency in the
dialog train episodes of `--data_dir/out/realign` and, when the
Brysbaert et al. (2014) ratings are in `--data_dir/eval`, against their
concreteness (`version_N/correlation_*.png`).
"""

from __future__ import annotations

import csv
import logging
import os
from argparse import ArgumentParser
from typing import List, Optional

import numpy as np

FRAGMENTS = ["narration"]  # reference evaluation_targeted_triplets.py:20
POS_TAGS = ["ADJ", "VERB", "NOUN"]  # reference :21
RESULTS_DIR = os.path.join("results", "targeted_triplets")


def evaluate(version, log_dir: str = "lightning_logs", data_dir: str = "data",
             batch_size: int = 8, results_dir: str = RESULTS_DIR,
             device=None) -> str:
    """Score one run version; returns the CSV's path."""
    from peppa_tpu_torch.evaluation.evaluation import make_predict
    from peppa_tpu_torch.evaluation.targeted import (get_eval_set_info,
                                                     targeted_triplet_score)
    from peppa_tpu_torch.training.checkpoint import load_best_model

    dirname = os.path.join(log_dir, f"version_{version}")
    model, config, _ = load_best_model(dirname, device=device)
    predict_fn = make_predict(model, device)
    header: List[str] = []
    rows: List[List[str]] = []
    for fragment in FRAGMENTS:
        for pos in POS_TAGS:
            for scrambled in (False, True):
                logging.info("Evaluating %s/%s scrambled=%s", fragment, pos,
                             scrambled)
                scores = targeted_triplet_score(
                    fragment, pos, predict_fn, batch_size=batch_size,
                    scrambled_video=scrambled,
                    target_size=config.data.target_size,
                    audio_sample_rate=config.data.audio_sample_rate,
                    data_dir=data_dir)
                columns, info = get_eval_set_info(fragment, pos, data_dir)
                if len(scores) != len(info):
                    raise AssertionError(f"{len(scores)} scores vs "
                                         f"{len(info)} eval rows")
                cols = columns + ["result", "pos", "fragment",
                                  "scrambled_video"]
                if header and header != cols:
                    raise ValueError(f"eval set {pos}: columns {columns} "
                                     f"differ from the first set's")
                header = cols
                rows += [[r[c] for c in columns]
                         + [repr(float(s)), pos, fragment, str(scrambled)]
                         for r, s in zip(info, scores)]
    outdir = os.path.join(results_dir, f"version_{version}")
    os.makedirs(outdir, exist_ok=True)
    path = os.path.join(outdir, "minimal_pairs_scores.csv")
    with open(path, "w", newline="") as f:
        writer = csv.writer(f, lineterminator="\n")
        writer.writerow(header)
        writer.writerows(rows)
    logging.info("Wrote %s", path)
    return path


def _conditions(conditions_path: str) -> dict:
    import yaml

    try:
        with open(conditions_path) as f:
            return yaml.safe_load(f)
    except FileNotFoundError:
        return {}


def _condition_for_version(version,
                           conditions_path: str = "conditions.yaml") -> str:
    for name, versions in _conditions(conditions_path).items():
        if version in versions:
            return name
    return "unknown"


def create_results_table(results_dir: str = RESULTS_DIR,
                         conditions_path: str = "conditions.yaml") -> str:
    """Each version's accuracy per POS tag and scrambling, bootstrapped 500
    times, into minimal_pairs.{csv,tex} in the parent of `results_dir`
    (reference evaluation_targeted_triplets.py:314-373); returns the CSV's
    path."""
    import glob

    import pandas as pd

    rng = np.random.default_rng(666)
    rows = []
    for path in sorted(glob.glob(os.path.join(results_dir, "version_*",
                                              "minimal_pairs_scores.csv"))):
        version = int(path.split("version_")[-1].split(os.sep)[0])
        data = pd.read_csv(path)
        condition = _condition_for_version(version, conditions_path)
        for (pos, scrambled), group in data.groupby(["pos", "scrambled_video"]):
            scores = group["result"].to_numpy()
            boot = [scores[rng.integers(0, len(scores), len(scores))].mean()
                    for _ in range(500)]
            rows.append({"version": version, "condition": condition,
                         "pos": pos, "scrambled_video": scrambled,
                         "accuracy": float(np.mean(boot)),
                         "std": float(np.std(boot)),
                         "n": len(scores)})
    table = pd.DataFrame.from_records(rows)
    out_dir = os.path.dirname(os.path.abspath(results_dir))
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "minimal_pairs.csv")
    table.to_csv(path, index=False)
    table.to_latex(os.path.join(out_dir, "minimal_pairs.tex"), index=False,
                   float_format="%.3f")
    logging.info("Wrote %s", path)
    return path


def get_bootstrapped_scores(values, n_resamples=100, seed=666):
    """Bootstrap means (reference :159-162)."""
    rng = np.random.default_rng(seed)
    for _ in range(n_resamples):
        yield rng.choice(values, size=len(values), replace=True).mean()


def bootstrap_scores_for_column(results, column_name):
    """Bootstrap means of `result` per value of a column (reference
    :165-173)."""
    import pandas as pd

    rows = []
    for value in results[column_name].unique():
        scores = results[results[column_name] == value].result.values
        rows.extend({"score": s, column_name: value}
                    for s in get_bootstrapped_scores(scores))
    return pd.DataFrame.from_records(rows)


def get_all_results_df(version, pos_tags, per_word_results=False,
                       min_samples=None, results_dir: str = RESULTS_DIR):
    """One version's unscrambled scores of `pos_tags` (reference :84-106):
    with `min_samples`, the pairs with a word seen more often; with
    `per_word_results`, one row per word of each pair."""
    import pandas as pd

    path = os.path.join(results_dir, f"version_{version}",
                        "minimal_pairs_scores.csv")
    data = pd.read_csv(path)
    data = data[data.pos.isin(pos_tags)]
    if "scrambled_video" in data.columns:
        data = data[~data.scrambled_video.astype(bool)]
    if min_samples:
        counts = data.target_word.value_counts()
        enough = counts[counts > min_samples].keys().to_list()
        data = data[data.target_word.isin(enough)
                    | data.distractor_word.isin(enough)]
    if per_word_results:
        d1 = data.copy()
        d1["word"] = d1["target_word"]
        d2 = data.copy()
        d2["word"] = d2["distractor_word"]
        data = pd.concat([d1, d2], ignore_index=True)
    data["duration"] = data["clipEnd"] - data["clipStart"]
    return data


def _save_boxplot(df, x_col, out_path, figsize=(6, 4), sort_by_score=True):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    order = (df.groupby(x_col)["score"].mean().sort_values().index
             if sort_by_score else sorted(df[x_col].unique(), key=str))
    values = [df[df[x_col] == v]["score"].values for v in order]
    fig, ax = plt.subplots(figsize=figsize)
    ax.boxplot(values, vert=False, tick_labels=[str(v) for v in order],
               showfliers=False)
    ax.set_xlabel("accuracy")
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    fig.tight_layout()
    fig.savefig(out_path)
    plt.close(fig)


def create_per_word_result_plots(condition, versions, min_samples=10,
                                 results_dir: str = RESULTS_DIR):
    """Per-word accuracy boxplots of a condition (reference :184-209)."""
    import pandas as pd

    for pos in ["NOUN", "VERB"]:
        frames = []
        for version in versions:
            data = get_all_results_df(version, [pos], per_word_results=True,
                                      min_samples=min_samples,
                                      results_dir=results_dir)
            if len(data):
                frames.append(bootstrap_scores_for_column(data, "word"))
        if frames:
            df = pd.concat(frames, ignore_index=True)
            _save_boxplot(df, "word",
                          os.path.join(results_dir, f"condition_{condition}",
                                       f"acc_per_word_{pos}.pdf"),
                          figsize=(6, 10) if pos == "NOUN" else (6, 4))


def create_duration_results_plots(condition, versions,
                                  results_dir: str = RESULTS_DIR):
    """Accuracy by clip duration and phrase length (reference :132-157)."""
    import pandas as pd

    dur_frames, tok_frames = [], []
    for version in versions:
        data = get_all_results_df(version, POS_TAGS, results_dir=results_dir)
        if not len(data):
            continue
        data = data.copy()
        data["duration_bin"] = pd.qcut(data["duration"], 3).astype(str)
        dur_frames.append(bootstrap_scores_for_column(data, "duration_bin"))
        if "tokenized" in data.columns:
            import ast

            data["num_tokens"] = data.tokenized.apply(
                lambda t: len(ast.literal_eval(t)) if isinstance(t, str)
                else len(t))
            data["num_tokens_bin"] = pd.cut(data["num_tokens"], 3).astype(str)
            tok_frames.append(
                bootstrap_scores_for_column(data, "num_tokens_bin"))
    base = os.path.join(results_dir, f"condition_{condition}")
    if dur_frames:
        _save_boxplot(pd.concat(dur_frames, ignore_index=True),
                      "duration_bin", os.path.join(base, "acc_per_duration.pdf"),
                      sort_by_score=False)
    if tok_frames:
        _save_boxplot(pd.concat(tok_frames, ignore_index=True),
                      "num_tokens_bin",
                      os.path.join(base, "acc_per_num_tokens.pdf"),
                      sort_by_score=False)


def create_correlation_results_plots(version, min_samples=10,
                                     realign_dir="data/out/realign",
                                     concreteness_csv=None,
                                     results_dir: str = RESULTS_DIR):
    """Accuracy against each word's log frequency in the dialog train
    episodes and, when the Brysbaert et al. (2014) ratings CSV is there,
    against its concreteness (reference :207-250)."""
    from collections import Counter

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import pandas as pd
    from scipy.stats import pearsonr

    from peppa_tpu_torch.evaluation.eval_set_generation import (
        get_lemmatized_words, load_realigned_data)

    data = get_all_results_df(version, POS_TAGS, per_word_results=True,
                              min_samples=min_samples, results_dir=results_dir)
    mean_acc = data.groupby("word")["result"].agg("mean")
    outdir = os.path.join(results_dir, f"version_{version}")
    os.makedirs(outdir, exist_ok=True)

    def scatter(xs, ys, labels, xlabel, out_name):
        corr = pearsonr(xs, ys)
        fig, ax = plt.subplots()
        ax.scatter(xs, ys, marker="x")
        for x, y, lab in zip(xs, ys, labels):
            ax.text(x + 0.01, y, lab, size="small")
        ax.set_title(f"pearson r={corr[0]:.2f} (p={corr[1]:.3f})")
        ax.set_xlabel(xlabel)
        ax.set_ylabel("Accuracy")
        fig.tight_layout()
        fig.savefig(os.path.join(outdir, out_name), dpi=300)
        plt.close(fig)
        logging.info("Pearson correlation %s-acc: %s", xlabel, corr)

    try:
        _, tokens = load_realigned_data(realign_dir)
        freqs = Counter(get_lemmatized_words(tokens, "train",
                                             fragments=["dialog"]))
        xs = [np.log(max(freqs.get(w, 1), 1)) for w in mean_acc.keys()]
        scatter(xs, mean_acc.values, list(mean_acc.keys()),
                "Log Frequency", "correlation_frequency_acc.png")
    except Exception as e:  # the JAX CLI's: a tree it cannot tag or read
        logging.warning("frequency correlation skipped: %s", e)

    path = concreteness_csv or os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(realign_dir))),
        "eval", "13428_2013_403_MOESM1_ESM.csv")
    if os.path.exists(path):
        ratings = pd.read_csv(path)
        table = dict(zip(ratings["Word"], ratings["Conc.M"]))
        xs = [table.get(w, 2.5) for w in mean_acc.keys()]
        scatter(xs, mean_acc.values, list(mean_acc.keys()),
                "Concreteness", "correlation_concreteness_acc.png")
    else:
        logging.warning("concreteness ratings CSV not found at %s; skipped",
                        path)


def plot(versions, results_dir: str = RESULTS_DIR, data_dir: str = "data",
         conditions_path: str = "conditions.yaml") -> None:
    """The `--plot` branch: the table, each condition's plots, and each
    version's correlation plots."""
    create_results_table(results_dir, conditions_path)
    for condition, cond_versions in _conditions(conditions_path).items():
        have = [v for v in cond_versions if os.path.exists(os.path.join(
            results_dir, f"version_{v}", "minimal_pairs_scores.csv"))]
        if not have:
            continue
        create_per_word_result_plots(condition, have, results_dir=results_dir)
        create_duration_results_plots(condition, have,
                                      results_dir=results_dir)
    for version in versions:
        create_correlation_results_plots(
            version, realign_dir=os.path.join(data_dir, "out", "realign"),
            results_dir=results_dir)


def parser() -> ArgumentParser:
    p = ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--run", action="store_true")
    p.add_argument("--plot", action="store_true")
    p.add_argument("--versions", type=str, nargs="+", default=[])
    p.add_argument("--log_dir", type=str, default="lightning_logs")
    p.add_argument("--data_dir", type=str, default="data")
    p.add_argument("--results_dir", type=str, default=RESULTS_DIR)
    p.add_argument("--conditions", type=str, default="conditions.yaml")
    p.add_argument("--device", type=str, default=None,
                   help="cuda (default) or cpu")
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = parser().parse_args(argv)
    logging.getLogger().setLevel(logging.INFO)
    if args.run:
        for version in args.versions:
            evaluate(version, log_dir=args.log_dir, data_dir=args.data_dir,
                     results_dir=args.results_dir, device=args.device)
    if args.plot:
        plot(args.versions, results_dir=args.results_dir,
             data_dir=args.data_dir, conditions_path=args.conditions)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
