"""mfu.embed: forward FLOPs of the real pairs embedded in the window (each
tower at the bucket shape its clip ran at, counted on the reference) over
the window (its untraced half), as a share (%) of the card's dense peak
for the precision."""

from collections import Counter

from benchmark import flops


def read(run):
    pairs = Counter(b for r in run.get("requests", []) if not r["traced"]
                    for b in r.get("buckets", []))
    if not pairs:
        return None
    total = 0.0
    for (video_s, audio_s), n in pairs.items():
        total += n * (flops.tower_flops(run["hp"], video_s, False)["video"]
                      + flops.tower_flops(run["hp"], audio_s, False)["audio"])
    return flops.mfu(total, run["window_s"], flops.precision(run["hp"]))
