"""The port's GRSA pair analyses (`analysis/grsa.py`) against the JAX
package's, on the run directory and realign tree of
tests/torch_port_grsa_run.py (the random inits carried across from the
JAX package):

- `pairwise`: sim_1 and sim_2 within 1e-4, every other field equal, and
  the random init drawn from the run's config unchanged;
- `main`: the same columns and rows in its CSV, the similarities within
  1e-4, and its CLI.
(`embed_utterances`, `unpairwise_data` and `unpairwise` are in
tests/test_torch_port_grsa_utterances.py.)
"""

import numpy as np
import pandas as pd

import peppa_tpu.analysis.grsa as J
from peppa_tpu_torch.analysis import grsa as G
from torch_port_grsa_run import INIT_CALLS, TOL, grsa_run  # noqa: F401

SIMS = ("sim_1", "sim_2")


def test_pairwise_matches_jax(grsa_run):
    kw = dict(fragment_type="dialog", multiword=False, embedder="hashing",
              log_dir=grsa_run["log_dir"], data_dir=grsa_run["data_dir"])
    INIT_CALLS.clear()
    got = list(G.pairwise(0, device="cpu", **kw))
    cfg = grsa_run["cfg"].audio
    assert INIT_CALLS == [(cfg.pooling, cfg.project, cfg.pretrained, 1)]
    want = list(J.pairwise(0, **kw))
    assert len(got) == len(want) == 8 * 7 // 2
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for k in g:
            if k in SIMS:
                assert abs(g[k] - w[k]) <= TOL, k
            else:
                assert g[k] == w[k] and type(g[k]) is type(w[k]), k
    assert all(r["distance"] is not None for r in got)


def test_main_csv_matches_jax(grsa_run, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)  # "auto": the text embedder finds nothing
    kw = dict(log_dir=grsa_run["log_dir"], data_dir=grsa_run["data_dir"])
    G.main([0], out_csv=str(tmp_path / "port.csv"), device="cpu", **kw)
    J.main([0], out_csv=str(tmp_path / "jax.csv"), **kw)
    got, want = (pd.read_csv(tmp_path / f"{s}.csv") for s in ("port", "jax"))
    assert list(got.columns) == list(want.columns)
    assert len(got) == 2 * (4 * 3 // 2 + 8 * 7 // 2)
    rest = [c for c in got.columns if c not in SIMS]
    pd.testing.assert_frame_equal(got[rest], want[rest])
    for k in SIMS:
        np.testing.assert_allclose(got[k], want[k], atol=TOL)


def test_cli_calls_main(monkeypatch):
    calls = []
    monkeypatch.setattr(G, "main", lambda *a, **kw: calls.append((a, kw)))
    assert G.cli(["--versions", "0", "2", "--out_csv", "p.csv", "--device",
                  "cpu", "--log_dir", "L", "--data_dir", "D"]) == 0
    assert calls == [(([0, 2],), dict(log_dir="L", data_dir="D",
                                      out_csv="p.csv", device="cpu"))]
