"""The traffic generators: shapes, bucket shares and seed determinism."""

import json
import math
from collections import Counter

import numpy as np
import pytest
import torch

from benchmark import generate
from benchmark.cells import Bench
from benchmark.reference import serve as rserve
from benchmark.tests.tiny import tiny_hparams

BENCH = Bench()
BASE = BENCH.config("peppa-base")["hparams"]
PROD = BENCH.config("peppa-production")["hparams"]


def phi(x):
    return 0.5 * (1.0 + math.erf(x / math.sqrt(2.0)))


def test_train_plan_warms_every_bucket_then_keeps_the_cycle():
    traffic = BENCH.traffic("train-jitter")
    plan = generate.train_plan(traffic, 2 ** 31 + 11, 3 + 25 * 40)
    assert plan[:3] == [2.3, 3.2, 4.0]
    assert Counter(plan[3:]) == {2.3: 480, 3.2: 480, 4.0: 40}
    assert plan != generate.train_plan(traffic, 5, len(plan))
    assert plan == generate.train_plan(traffic, 2 ** 31 + 11, len(plan))


@pytest.mark.parametrize("bucket", [2.3, 3.2, 4.0])
def test_train_batch_lengths_and_padding(bucket):
    traffic = BENCH.traffic("train-jitter")
    hp = tiny_hparams(PROD)
    hp["tpu"]["bucket_durations"] = [2.3, 3.2, 4.0, 6.0]
    b = generate.train_batch(traffic, hp, 2 ** 31 + 3, 7, bucket, 16, "cpu")
    frames, samples = generate.shape(hp, bucket)
    w, h = hp["data"]["target_size"]
    assert b["video"].shape == (16, frames, h, w, 3)
    assert b["video"].dtype == torch.uint8
    assert b["audio"].shape == (16, samples)
    lo = {2.3: 0.5, 3.2: 2.3, 4.0: 3.2}[bucket]
    assert bool(((b["durations"] > lo) & (b["durations"] <= bucket)).all())
    assert len(set(b["video_frames"].tolist())) > 1  # lengths vary
    for j in range(16):
        f, s = int(b["video_frames"][j]), int(b["audio_samples"][j])
        assert not b["video"][j, f:].any() and not b["audio"][j, s:].any()
        assert b["audio"][j, :s].abs().sum() > 0
    again = generate.train_batch(traffic, hp, 2 ** 31 + 3, 7, bucket, 16,
                                 "cpu")
    other = generate.train_batch(traffic, hp, 2 ** 31 + 3, 8, bucket, 16,
                                 "cpu")
    assert torch.equal(b["video"], again["video"])
    assert torch.equal(b["audio"], again["audio"])
    assert not torch.equal(b["audio"], other["audio"])


def test_serve_bucket_shares_follow_the_log_normal():
    traffic = BENCH.traffic("serve-mixed8")
    hp = json.loads(json.dumps(BASE))
    hp["data"]["target_size"] = [4, 4]
    hp["data"]["audio_sample_rate"] = 800
    pool = generate.serve_requests(traffic, hp, 2 ** 31 + 5)
    n = traffic["pool"] * traffic["pairs_per_request"]
    assert len(pool) == traffic["pool"]
    assert all(len(r["video"]) == len(r["audio"]) == 8 for r in pool)
    d = np.concatenate([r["durations"] for r in pool])
    assert d.min() >= 0.5 and d.max() <= 8.0
    other = np.concatenate([r["durations"] for r in generate.serve_requests(
        traffic, hp, 2 ** 31 + 6)])
    assert np.array_equal(np.sort(d), np.sort(other))  # one set, reordered
    assert not np.array_equal(d, other)

    def shares(edges):
        z = [phi(math.log(e / 2.3) / 0.5) for e in edges]
        return [z[0], z[1] - z[0], z[2] - z[1], 1.0 - z[2]]

    # durations: 50 / 24.5 / 12.0 / 13.4 %; a clip's frames round to the
    # nearest tenth of a second, so its video bucket ends 0.05 s later
    assert shares([2.3, 3.2, 4.0]) == pytest.approx(
        [0.5, 0.2455, 0.1203, 0.1342], abs=2e-3)
    by_duration = [np.mean(d <= 2.3), np.mean((d > 2.3) & (d <= 3.2)),
                   np.mean((d > 3.2) & (d <= 4.0)), np.mean(d > 4.0)]
    assert np.allclose(by_duration, shares([2.3, 3.2, 4.0]), atol=1 / n)
    counts = Counter(rserve.bucket_length(v.shape[0], generate.buckets(hp),
                                          generate.FPS)
                     for r in pool for v in r["video"])
    got = [counts[f] / n for f in (23, 32, 40, 60)]
    assert np.allclose(got, shares([2.35, 3.25, 4.05]), atol=1 / n)
    for r in pool:  # each clip as long as its duration says
        for v, a, d in zip(r["video"], r["audio"], r["durations"]):
            assert v.shape[0] == max(1, round(d * 10))
            assert a.shape[0] == round(d * 800)


def test_serve_pool_and_order_are_the_seeds():
    traffic = dict(BENCH.traffic("serve-mixed8"), pool=6)
    hp = tiny_hparams(BASE)
    a = generate.serve_requests(traffic, hp, 2 ** 31 + 9)
    b = generate.serve_requests(traffic, hp, 2 ** 31 + 9)
    c = generate.serve_requests(traffic, hp, 2 ** 31 + 10)
    for x, y in zip(a, b):
        assert all(np.array_equal(u, v) for u, v in zip(x["video"],
                                                        y["video"]))
        assert all(np.array_equal(u, v) for u, v in zip(x["audio"],
                                                        y["audio"]))
    assert not np.array_equal(a[0]["audio"][0][:100], c[0]["audio"][0][:100])
    order = generate.serve_order(traffic, 1)
    first = [next(order) for _ in range(12)]
    assert sorted(first[:6]) == list(range(6))
    assert sorted(first[6:]) == list(range(6))


def test_encode_variants_are_distinct_and_repeatable():
    traffic = dict(BENCH.traffic("encode-b256"), batch=4)
    hp = tiny_hparams(PROD)
    v, a = generate.encode_base(traffic, hp, 2 ** 31 + 1, "cpu")
    frames, samples = generate.shape(hp, traffic["duration_s"])
    assert v.shape[:2] == (4, frames) and a.shape == (4, samples)
    b0 = generate.encode_batch(v, a, 2 ** 31 + 1, 0)
    b1 = generate.encode_batch(v, a, 2 ** 31 + 1, 1)
    assert not torch.equal(b0[0], b1[0]) and not torch.equal(b0[1], b1[1])
    assert torch.equal(b0[0], generate.encode_batch(v, a, 2 ** 31 + 1, 0)[0])
    byte, scale = generate.encode_variant(2 ** 31 + 1, 0)
    assert 0 <= byte < 256 and abs(scale - 1.0) <= 1e-3
