"""Regression and probing statistics over pairwise-similarity tables.

The port's copy of peppa_tpu/analysis/stats.py (reference pig/stats.py):
data massaging (sum-coding, scaling), OLS coefficient tables with
intervals (`analysis/ols.py` in place of statsmodels), partial R², RidgeCV
"backprobes" with one variable ablated at a time, the unpairwise OLS and
the covariates' correlation table.  Host work: pandas and sklearn are
imported inside the functions.

    python -m peppa_tpu_torch.analysis.stats [--pairwise_csv F]
        [--results_dir R]

writes `R/coef.csv`, the coefficient plots and the correlation tables from
`grsa`'s pairwise CSV.
"""

from __future__ import annotations

import os
from argparse import ArgumentParser
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from peppa_tpu_torch.analysis.ols import ols


def scale(x) -> np.ndarray:
    x = np.asarray(x, np.float64)
    sd = x.std()
    return (x - x.mean()) / (sd if sd > 0 else 1.0)


def sumcode(col) -> np.ndarray:
    """Boolean column -> {-1, +1} (reference pig/stats.py:10-11)."""
    return (np.asarray(col).astype(int) * 2 - 1).astype(int)


def massage(dat, scaleall: bool = False):
    """The pairwise table prepared for regression (pig/stats.py:13-27)."""
    dat = dat.copy()
    dat["durationsum"] = dat["duration1"] + dat["duration2"]
    keep = ["samespeaker", "sameepisode", "sametype", "semsim",
            "durationdiff", "durationsum", "sim_1", "sim_2"]
    data = dat[keep].dropna().query("semsim != 0.0")
    code = scale if scaleall else sumcode
    return data.assign(
        samespeaker=lambda x: code(x.samespeaker),
        sameepisode=lambda x: code(x.sameepisode),
        sametype=lambda x: code(x.sametype),
        semsim=lambda x: scale(x.semsim),
        durationdiff=lambda x: scale(x.durationdiff),
        durationsum=lambda x: scale(x.durationsum),
        sim_1=lambda x: scale(x.sim_1),
        sim_2=lambda x: scale(x.sim_2))


def standardize(data):
    """Every regression column z-scored (pig/stats.py:29-34)."""
    import pandas as pd

    keep = ["samespeaker", "sameepisode", "sametype", "semsim", "distance",
            "durationdiff", "durationsum", "sim_1", "sim_2"]
    sub = data[keep].astype(float)
    return pd.DataFrame({c: scale(sub[c]) for c in keep}, index=sub.index)


def rer(red: float, full: float) -> float:
    """Relative error reduction (pig/stats.py:41-42)."""
    return (red - full) / red


def partial_r2(formula: str, data):
    """Each predictor's partial R² by leave-one-out refits
    (pig/stats.py:44-60)."""
    import pandas as pd

    lhs, rhs = [s.strip() for s in formula.split("~")]
    predictors = [p.strip() for p in rhs.split("+") if p.strip()]
    mse_full = ols(formula, data).mse_resid
    r2 = [rer(ols(formula, data, drop_intercept=True).mse_resid, mse_full)]
    for predictor in predictors:
        rest = " + ".join(p for p in predictors if p != predictor)
        mse_red = ols(f"{lhs} ~ {rest}", data).mse_resid
        r2.append(rer(mse_red, mse_full))
    return pd.DataFrame(index=["Intercept"] + predictors,
                        data=dict(partial_r2=r2))


# ------------------------------------------------------------- ridge probes

def frameit(matrix: np.ndarray, prefix: str = "dim"):
    import pandas as pd

    return pd.DataFrame(matrix,
                        columns=[f"{prefix}{i}" for i in range(matrix.shape[1])])


def ridge(X, y, X_val, y_val) -> Dict:
    """RidgeCV fit and validation (pig/stats.py:125-137)."""
    from sklearn.linear_model import RidgeCV
    from sklearn.metrics import mean_squared_error
    from sklearn.pipeline import make_pipeline
    from sklearn.preprocessing import StandardScaler

    model = make_pipeline(
        StandardScaler(),
        RidgeCV(alphas=[10.0 ** n for n in range(-3, 11)],
                fit_intercept=True, scoring="neg_mean_squared_error",
                alpha_per_target=False))
    model.fit(X, y)
    pred = model.predict(X_val)
    rcv = model.steps[-1][1]
    return dict(mse=mean_squared_error(y_val, pred), alpha=rcv.alpha_,
                best_cv=-rcv.best_score_)


def ablate(variables: Dict) -> Iterator[Tuple[str, object]]:
    """All-but-one variable sets (pig/stats.py:139-142)."""
    import pandas as pd

    for this in variables:
        yield this, pd.concat([v for n, v in variables.items() if n != this],
                              axis=1)


def backprobe(records: Sequence[Dict], seed: int = 0):
    """Embeddings predicted from metadata, one variable ablated at a time
    (pig/stats.py:82-110).  `records` carry each word's embedding_{0,1,2}
    (arrays), semsim vector, speaker, episode and duration."""
    import pandas as pd

    rng = np.random.default_rng(seed)
    embs = {name: frameit(scale_matrix(np.stack(
        [np.asarray(r[name]) for r in records])), prefix=name)
        for name in ("embedding_2", "embedding_1", "embedding_0")}
    semsim = frameit(np.stack([np.asarray(r["semsim"]) for r in records]),
                     prefix="semsim")
    speaker = pd.get_dummies([r["speaker"] for r in records], prefix="speaker")
    episode = pd.get_dummies([r["episode"] for r in records], prefix="episode")
    duration = pd.DataFrame(dict(duration=[r["duration"] for r in records]))

    n = len(records)
    train_ix = rng.choice(n, n // 2, replace=False)
    val_ix = np.setdiff1d(np.arange(n), train_ix)
    predictors = dict(semsim=semsim, speaker=speaker, episode=episode,
                      duration=duration)
    rows = []
    for outname, y in embs.items():
        X = pd.concat(list(predictors.values()), axis=1)
        full = ridge(X.iloc[train_ix], y.iloc[train_ix],
                     X.iloc[val_ix], y.iloc[val_ix])
        rows.append(dict(var="NONE", outcome=outname, **full,
                         rer=rer(full["mse"], full["mse"])))
        for name, X_red in ablate(predictors):
            red = ridge(X_red.iloc[train_ix], y.iloc[train_ix],
                        X_red.iloc[val_ix], y.iloc[val_ix])
            rows.append(dict(var=name, outcome=outname, **red,
                             rer=rer(red["mse"], full["mse"])))
    return pd.DataFrame.from_records(rows)


def scale_matrix(x: np.ndarray) -> np.ndarray:
    sd = x.std(axis=0)
    sd[sd == 0] = 1.0
    return (x - x.mean(axis=0)) / sd


def unpairwise_ols(rawdata):
    """OLS of sim_1 and sim_2 on the pair covariates (pig/stats.py:144-152)."""
    import pandas as pd

    data = standardize(rawdata)
    out = []
    for dep in ("sim_1", "sim_2"):
        res = ols(f"{dep} ~ semsim + distance + durationdiff + durationsum"
                  " + samespeaker + sameepisode", data)
        table = res.summary_table().rename(columns={"Coef.": "Value"})
        table["Dependent Var."] = dep
        out.append(table)
    return pd.concat(out)


def correlation_table(rawdata, fragment_type: str,
                      results_dir: str = "results"):
    """results/rsa_{fragment}_correlations.{csv,tex}: the Pearson
    correlation matrix of the pairwise covariates; the text-similarity
    column keeps the reference's shipped name 'glovesim'."""
    sub = rawdata
    if "fragment_type" in rawdata.columns:
        sub = rawdata[rawdata.fragment_type == fragment_type]
    elif "dialog" in rawdata.columns:
        sub = rawdata[rawdata.dialog == (fragment_type == "dialog")]
    cols = ["samespeaker", "sameepisode", "sametype", "semsim", "distance",
            "durationdiff", "sim_0", "sim_1", "sim_2"]
    avail = [c for c in cols if c in sub.columns]
    mat = sub[avail].astype(float).corr()
    mat = mat.rename(index={"semsim": "glovesim"},
                     columns={"semsim": "glovesim"})
    os.makedirs(results_dir, exist_ok=True)
    path = os.path.join(results_dir, f"rsa_{fragment_type}_correlations")
    mat.to_csv(path + ".csv")
    try:
        with open(path + ".tex", "w") as f:
            f.write(mat.style.format(precision=3).to_latex())
    except Exception:  # older pandas without Styler.to_latex
        pass
    return mat


def main(pairwise_csv: str = "data/out/pairwise_similarities.csv",
         results_dir: str = "results"):
    """Each condition's OLS coefficient table, and the plots
    (pig/stats.py:154-182)."""
    import pandas as pd

    from peppa_tpu_torch.analysis.plotting import plot_coef

    rawdata = pd.read_csv(pairwise_csv)
    tables = []
    for multiword in (False, True):
        for fragment_type in ("dialog", "narration"):
            for version in rawdata["version"].unique():
                subset = rawdata.query(
                    f"multiword == {multiword} & fragment_type == "
                    f"'{fragment_type}' & version == {version}")
                if not len(subset):
                    continue
                samespeaker = "" if fragment_type == "narration" \
                    else " + samespeaker"
                data = massage(subset, scaleall=True)
                res = ols("sim_2 ~ semsim + durationdiff + durationsum"
                          f" + sametype{samespeaker} + sameepisode", data)
                table = res.summary_table()
                table["multiword"] = multiword
                table["fragment_type"] = fragment_type
                table["version"] = version
                tables.append(table)
    tables = pd.concat(tables, axis=0).rename(columns={
        "Coef.": "Coefficient", "[0.025": "Lower", "0.975]": "Upper"})
    os.makedirs(results_dir, exist_ok=True)
    tables.to_csv(os.path.join(results_dir, "coef.csv"), index=True,
                  header=True)
    for multiword in (False, True):
        for fragment_type in ("dialog", "narration"):
            plot_coef(tables, fragment_type, multiword,
                      results_dir=results_dir)
    for fragment_type in ("dialog", "narration"):
        correlation_table(rawdata, fragment_type, results_dir=results_dir)
    return tables


def cli(argv: Optional[List[str]] = None) -> int:
    p = ArgumentParser(description="GRSA coefficient tables and plots")
    p.add_argument("--pairwise_csv", default="data/out/pairwise_similarities.csv")
    p.add_argument("--results_dir", default="results")
    args = p.parse_args(argv)
    main(args.pairwise_csv, args.results_dir)
    return 0


if __name__ == "__main__":
    raise SystemExit(cli())
