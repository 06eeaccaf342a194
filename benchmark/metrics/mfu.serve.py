"""mfu.serve: forward FLOPs of the real pairs served in the window (each
tower at the bucket shape its clip ran at, counted on the reference) over
the time the service spent on them (each request from the start of its
first call to its answer), as a share (%) of the card's dense peak for the
precision."""

from collections import Counter

from benchmark import flops


def read(run):
    reqs = [r for r in run.get("requests", [])
            if not r["traced"] and "service_s" in r]
    if not reqs:
        return None
    total = 0.0
    for (video_s, audio_s), n in Counter(b for r in reqs
                                         for b in r["buckets"]).items():
        total += n * (flops.tower_flops(run["hp"], video_s, False)["video"]
                      + flops.tower_flops(run["hp"], audio_s, False)["audio"])
    return flops.mfu(total, sum(r["service_s"] for r in reqs),
                     flops.precision(run["hp"]))
