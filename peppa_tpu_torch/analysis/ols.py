"""Ordinary least squares with a statsmodels-style coefficient table.

The port's copy of peppa_tpu/analysis/ols.py: coefficients, standard
errors, t statistics, p values and 95% intervals from numpy and scipy, in a
pandas DataFrame with statsmodels' `summary2()` column names (`Variable`,
`Coef.`, `Std.Err.`, `t`, `P>|t|`, `[0.025`, `0.975]`).  pandas and scipy
are imported inside the functions.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np


class OLSResult:
    def __init__(self, names: Sequence[str], beta: np.ndarray, se: np.ndarray,
                 df_resid: int, mse_resid: float, r2: float):
        from scipy import stats as sps

        self.names = list(names)
        self.params = beta
        self.bse = se
        self.df_resid = df_resid
        self.mse_resid = mse_resid
        self.rsquared = r2
        self.tvalues = beta / se
        self.pvalues = 2 * sps.t.sf(np.abs(self.tvalues), df_resid)

    def summary_table(self):
        import pandas as pd
        from scipy import stats as sps

        ci = sps.t.ppf(0.975, self.df_resid) * self.bse
        return pd.DataFrame({
            "Variable": self.names,
            "Coef.": self.params,
            "Std.Err.": self.bse,
            "t": self.tvalues,
            "P>|t|": self.pvalues,
            "[0.025": self.params - ci,
            "0.975]": self.params + ci,
        })


def ols_fit(y: np.ndarray, X: np.ndarray, names: Sequence[str]) -> OLSResult:
    y = np.asarray(y, np.float64)
    X = np.asarray(X, np.float64)
    n, k = X.shape
    beta, *_ = np.linalg.lstsq(X, y, rcond=None)
    resid = y - X @ beta
    df = max(n - k, 1)
    mse = float(resid @ resid) / df
    xtx_inv = np.linalg.pinv(X.T @ X)
    se = np.sqrt(np.clip(np.diag(xtx_inv) * mse, 0, None))
    ss_tot = float(((y - y.mean()) ** 2).sum())
    r2 = 1.0 - float(resid @ resid) / ss_tot if ss_tot > 0 else 0.0
    return OLSResult(names, beta, se, df, mse, r2)


def ols(formula: str, data, drop_intercept: bool = False) -> OLSResult:
    """`"y ~ x1 + x2"` OLS over a DataFrame's columns: one response,
    `+`-separated numeric predictors, an implicit intercept."""
    lhs, rhs = [s.strip() for s in formula.split("~")]
    predictors = [p.strip() for p in rhs.split("+") if p.strip()]
    cols = [data[p].to_numpy(np.float64) for p in predictors]
    names: List[str] = []
    mats: List[np.ndarray] = []
    if not drop_intercept:
        names.append("Intercept")
        mats.append(np.ones(len(data)))
    names.extend(predictors)
    mats.extend(cols)
    X = np.stack(mats, axis=1)
    return ols_fit(data[lhs].to_numpy(np.float64), X, names)
