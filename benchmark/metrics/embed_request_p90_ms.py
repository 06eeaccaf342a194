"""embed_request_p90_ms: the 90th percentile (nearest rank) of every
request's time in the window, from the call to the returned numpy; a
failed request counts as infinitely late (host clock)."""

import math


def read(run):
    lat = sorted(r["latency_s"] for r in run.get("requests", [])
                 if not r["traced"])
    if not lat:
        return None
    return 1e3 * lat[max(0, math.ceil(0.9 * len(lat)) - 1)]
