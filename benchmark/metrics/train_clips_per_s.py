"""train_clips_per_s: clips trained in the window, optimizer steps
included, over the window closed by a synchronise (host clock; in a traced
run, its untraced half)."""


def read(run):
    steps = [s for s in run.get("steps", []) if not s["traced"]]
    if not steps:
        return None
    return sum(s["rows"] for s in steps) / run["window_s"]
