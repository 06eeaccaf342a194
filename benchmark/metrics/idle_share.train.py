"""idle_share.train: the share (%) of the traced window in which no kernel,
copy or set ran on the card (the profiler's CUDA activity)."""

from benchmark.trace import idle_share


def read(run):
    return idle_share(run)
