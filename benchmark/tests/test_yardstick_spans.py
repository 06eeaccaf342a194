"""The program's spans and counters inside the benchmark's runs, on the CPU
at test size: each micro-step a train cell runs is a `train.step` over its
phases, `train.optimizer` in every k-th; each request the serving cell
makes is counted by the service as the benchmark's row counter counts it,
so that the service's padding share of the untraced half is
`serve_pad_share`; each batch the encode cell runs is one span per
tower."""

import pytest

from benchmark import run as bench_run
from benchmark import trace
from benchmark.kinds.train import CHECKED_GROUPS
from benchmark.tests.tiny import tiny_root
from peppa_tpu_torch.utils.profiling import counters, drain, recording

SEED = 2 ** 31 + 2025
PHASES = ["train.step", "train.forward", "model.video", "model.audio",
          "train.loss", "train.backward", "train.accumulate"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("bench"))


@pytest.fixture
def window_counters(monkeypatch):
    """The counters when the window starts, when its traced half starts
    and when it stops."""
    seen = {}
    start, running, stop = (trace.Window.start, trace.Window.running,
                            trace.Window.stop)

    def start_(self):
        start(self)
        seen["start"] = counters()

    def running_(self):
        was = self.traced
        out = running(self)
        if self.traced and not was:
            seen["split"] = counters()
        return out

    def stop_(self):
        stop(self)
        seen["stop"] = counters()

    monkeypatch.setattr(trace.Window, "start", start_)
    monkeypatch.setattr(trace.Window, "running", running_)
    monkeypatch.setattr(trace.Window, "stop", stop_)
    return seen


def run(root, workload, traced, seconds=0.6):
    drain()
    with recording():
        rec = bench_run.run_cell(workload, SEED, seconds, traced, "cpu",
                                 root=root)
    return rec, drain()


def test_every_micro_step_has_its_phases(root):
    rec, spans = run(root, "base-train-8x8", traced=True, seconds=2.5)
    assert rec["correct"]
    k = int(rec["hp"]["training"]["trainer_args"]["accumulate_grad_batches"])
    roots = [s for s in spans if s["name"] == "train.step"]
    # the checked groups of the set-up, then the window's micro-steps
    assert len(roots) == CHECKED_GROUPS * k + rec["attempted"]
    assert any(s["traced"] for s in rec["steps"])  # both halves ran
    for i, step in enumerate(roots):
        names = [s["name"] for s in spans if s["root"] == step["id"]]
        assert names == PHASES + (["train.optimizer"]
                                  if i % k == k - 1 else [])


def test_service_counts_the_benchmarks_rows(root, window_counters):
    rec, spans = run(root, "base-serve-mixed8", traced=True)
    assert rec["correct"] and rec["failed"] == 0
    first = [r for r in rec["requests"] if not r["traced"]]
    assert first and len(first) < len(rec["requests"])

    def rows(a, b, kind):
        return sum(window_counters[b][f"serve.rows_{kind}.{t}"]
                   - window_counters[a][f"serve.rows_{kind}.{t}"]
                   for t in ("audio", "video"))

    for a, b, reqs in (("start", "split", first),
                       ("start", "stop", rec["requests"])):
        assert rows(a, b, "real") == sum(r["rows_real"] for r in reqs)
        assert rows(a, b, "run") == sum(r["rows_run"] for r in reqs)
    share = 100.0 * (1.0 - rows("start", "split", "real")
                     / rows("start", "split", "run"))
    assert share == pytest.approx(rec["metrics"]["serve_pad_share"]["value"],
                                  rel=1e-12)
    # three roots a request, and the set-up's one similarity
    roots = [s["name"] for s in spans if s["parent"] is None]
    n = len(rec["requests"])
    assert (roots.count("serve.embed_video"), roots.count(
        "serve.embed_audio"), roots.count("serve.similarity")) \
        == (n, n, n + 1)


def test_each_encode_batch_is_one_span_per_tower(root):
    rec, spans = run(root, "prod-encode-b256", traced=False)
    assert rec["correct"]
    # the set-up's batch, the window's and the reference check's none
    for name in ("model.video", "model.audio"):
        assert sum(s["name"] == name for s in spans) \
            == 1 + rec["attempted"]
    assert all(s["parent"] is None for s in spans)

