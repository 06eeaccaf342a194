"""The metric arithmetic: the roofline's bytes and FLOPs, the model FLOPs,
the idle share's interval union, the tail over all requests, the
optimizer step's extra time and the padding share."""

import math

import pytest

from benchmark import flops
from benchmark.cells import Bench
from benchmark.kinds.train import opt_step_extra_ms
from benchmark.trace import idle_share, union_length

BENCH = Bench()


def read(name, run):
    return BENCH.reader(name)(run)


def test_attention_roofline_at_the_encode_shape():
    # B=256 pairs of 2.3 s: T = 316 frames, 12 heads of 64, bf16
    work = flops.attention_fwd((256, 316, 12, 64), 2)
    assert work["bytes"] == 4 * 256 * 316 * 768 * 2
    assert work["flops"] == 4 * 256 * 12 * 316 ** 2 * 64
    bound = flops.roofline_seconds((256, 316, 12, 64), 2)
    assert bound * 1e3 == pytest.approx(0.1484, abs=5e-5)  # bytes bind
    assert work["flops"] / flops.PEAK_BF16_FLOPS < bound


def test_roofline_reader_sums_every_call():
    call = {"name": "peppa_tpu_torch::mha_attention",
            "shapes": [[256, 316, 12, 64]] * 3 + [[], []],
            "dtypes": ["c10::BFloat16"] * 3, "device_s": 0.530e-3}
    other = dict(call, name="aten::mm", device_s=1.0)
    run = {"hp": BENCH.config("peppa-production")["hparams"],
           "trace": {"calls": [call, call, other]}}
    assert read("attn_fwd_roofline", run) == pytest.approx(
        100 * 0.1484 / 0.530, rel=1e-3)
    assert read("attn_fwd_roofline", dict(run, trace={"calls": []})) is None


def test_model_flops_of_the_production_pair():
    hp = BENCH.config("peppa-production")["hparams"]
    f = flops.tower_flops(hp, 2.3, train=False)
    # the port's bench.py counted 0.254077 TFLOP a pair on this tower
    assert (f["video"] + f["audio"]) / 1e12 == pytest.approx(0.254077,
                                                             abs=1e-6)
    t = flops.tower_flops(hp, 2.3, train=True)
    assert 2.5 < (t["video"] + t["audio"]) / (f["video"] + f["audio"]) < 3.5


def test_mfu_readers():
    hp = BENCH.config("peppa-production")["hparams"]
    f = flops.tower_flops(hp, 2.3, train=False)
    run = {"hp": hp, "window_s": 2.0, "requests": [
        {"traced": False, "buckets": [(2.3, 2.3)] * 50}] * 2 + [
        {"traced": True, "buckets": [(2.3, 2.3)] * 50}]}
    assert read("mfu.embed", run) == pytest.approx(
        100 * 100 * (f["video"] + f["audio"]) / 2.0 / 989e12)
    t = flops.tower_flops(hp, 3.2, train=True)
    steps = [{"bucket": 3.2, "rows": 16, "opt": False, "traced": False}] * 3
    steps = steps + [dict(steps[0], traced=True)] * 5
    assert read("mfu.train", {"hp": hp, "window_s": 1.5, "steps": steps}) \
        == pytest.approx(100 * 48 * (t["video"] + t["audio"]) / 1.5 / 989e12)


def test_interval_union_and_idle_share():
    busy, gaps = union_length([(1.0, 2.0), (1.5, 3.0), (4.0, 5.0),
                               (4.2, 4.4), (9.0, 12.0)], 0.0, 10.0)
    assert busy == pytest.approx(4.0)
    assert gaps == [(0.0, 1.0), (3.0, 4.0), (5.0, 9.0)]
    assert idle_share({"trace": {"busy_s": 4.0, "window_s": 10.0}}) \
        == pytest.approx(60.0)
    assert idle_share({}) is None
    assert read("idle_share.train", {"trace": {"busy_s": 9.0,
                                               "window_s": 10.0}}) \
        == pytest.approx(10.0)


def requests(latencies, traced=False):
    return {"requests": [{"latency_s": x, "traced": traced, "pairs": 8}
                         for x in latencies]}


def test_p90_is_over_every_request_failed_ones_late():
    lat = [0.1 * (i + 1) for i in range(100)]  # 0.1 .. 10 s
    assert read("embed_request_p90_ms", requests(lat)) \
        == pytest.approx(9000.0)
    lat[-15:] = [math.inf] * 15  # 15 failures: the tail is theirs
    assert read("embed_request_p90_ms", requests(lat)) == math.inf
    run = requests([0.3] * 9 + [2.0])
    run["requests"] += requests([5.0] * 10, traced=True)["requests"]
    assert read("embed_request_p90_ms", run) == pytest.approx(300.0)


def test_rates_cover_the_whole_window():
    steps = [{"bucket": 2.3, "rows": 16, "opt": i % 4 == 3, "traced": False}
             for i in range(10)]
    assert read("train_clips_per_s", {"steps": steps, "window_s": 4.0}) \
        == pytest.approx(40.0)
    run = dict(requests([0.3] * 100), window_s=40.0)
    assert read("embed_pairs_per_s", run) == pytest.approx(20.0)
    assert read("setup_s", {"setup_s": 12.5}) == 12.5


def test_opt_step_extra_is_weighted_by_bucket():
    steps = ([{"bucket": 2.3, "opt": False, "ms": 400.0}] * 6
             + [{"bucket": 2.3, "opt": True, "ms": 480.0}] * 2
             + [{"bucket": 3.2, "opt": False, "ms": 550.0}] * 3
             + [{"bucket": 3.2, "opt": True, "ms": 650.0}]
             + [{"bucket": 4.0, "opt": False, "ms": 700.0}])
    steps = [dict(s, traced=False) for s in steps]
    assert opt_step_extra_ms(steps) == pytest.approx((8 * 80 + 4 * 100) / 12)
    assert opt_step_extra_ms(steps[:6]) is None


def test_pad_share():
    req = {"rows_real": 16, "rows_run": 48, "traced": False}
    run = {"requests": [req, dict(req, rows_run=16, traced=True)]}
    assert read("serve_pad_share", run) == pytest.approx(100 * 2 / 3)
    assert read("serve_pad_share", {"requests": []}) is None
