"""idle_share.serve: the share (%) of the time the host spent inside a
request's calls (the benchmark's embed_video, embed_audio and similarity
ranges) in which no kernel, copy or set ran on the card (the profiler's
CUDA activity); the open loop's own pauses between requests are left
out."""

from benchmark.trace import idle_share


def read(run):
    return idle_share(run, within_ranges=True)
