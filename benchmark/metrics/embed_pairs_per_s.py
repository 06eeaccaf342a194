"""embed_pairs_per_s: audio/video pairs embedded (and scored) in the window
over the window (host clock; in a traced run, its untraced half)."""


def read(run):
    pairs = sum(r["pairs"] for r in run.get("requests", [])
                if not r["traced"])
    return pairs / run["window_s"] if pairs else None
