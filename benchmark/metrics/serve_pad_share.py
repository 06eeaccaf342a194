"""serve_pad_share: the share (%) of the rows the towers ran that were
padding: rows each encode call of the service received, counted by the
benchmark's wrapper around the model, against the clips the requests
sent (the untraced half of the window)."""


def read(run):
    reqs = [r for r in run.get("requests", [])
            if not r["traced"] and "rows_run" in r]
    run_rows = sum(r["rows_run"] for r in reqs)
    if not run_rows:
        return None
    return 100.0 * (1.0 - sum(r["rows_real"] for r in reqs) / run_rows)
