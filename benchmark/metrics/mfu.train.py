"""mfu.train: model FLOPs of the window's training clips (forward and
backward at each clip's bucket shape, counted on the reference) over the
window (its untraced half), as a share (%) of the card's dense peak for
the precision."""

from benchmark import flops


def read(run):
    steps = [s for s in run.get("steps", []) if not s["traced"]]
    if not steps:
        return None
    total = 0.0
    for s in steps:
        f = flops.tower_flops(run["hp"], s["bucket"], train=True)
        total += s["rows"] * (f["video"] + f["audio"])
    return flops.mfu(total, run["window_s"], flops.precision(run["hp"]))
