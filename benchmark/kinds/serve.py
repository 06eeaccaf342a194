"""The `serve` driver: an open loop of requests to `serving.EncoderService`.

Requests are due one every 1 / `rate_per_s` seconds, whether or not the
service has finished the last (the service is called from one thread, so
a request that is due while another is served waits).  Each request embeds
its clips' video (`embed_video`), then their audio (`embed_audio`), then
takes the cosine matrix of the two (`similarity`), and is timed from when
it was due to the returned matrix; its service time runs from its first
call.  The window closes when the last request due in it is answered.  Set-up builds
the service on the drawn weights, makes the request pool on the host and
runs `EncoderService.warmup` (every bucket at the service's batch size,
the only shapes the service runs) and one `similarity`.  The check, after
the window, embeds a seeded sample of the answered requests (with the one
that holds the longest clip) with the reference, padded and cropped to
its buckets as the service does, and compares every answer the window
gave them: the largest gap of an embedding element and of a cosine.
"""

from __future__ import annotations

import itertools
import time

import numpy as np
import torch
from torch.profiler import record_function

from benchmark import generate, kinds
from benchmark.program import RowCounter, build_model, port_config
from benchmark.reference import model as ref
from benchmark.reference import serve as rserve
from benchmark.trace import Window
from peppa_tpu_torch.serving import EncoderService

REFERENCE_ROWS = 16  # the reference's rows per block
CHECKED_REQUESTS = 32  # answered requests the reference checks


def run(ctx: dict) -> dict:
    hp, traffic, seed, dev = ctx["hp"], ctx["traffic"], ctx["seed"], \
        ctx["device"]
    weights = ref.draw_weights(hp, seed, dev)
    model = RowCounter(build_model(hp, weights, dev))
    ctx["marks"].append(("built", time.perf_counter()))
    del weights
    svc = EncoderService(model, port_config(hp),
                         batch_size=int(traffic["batch_size"]), device=dev)
    pool = generate.serve_requests(traffic, hp, seed)
    order = generate.serve_order(traffic, seed)
    ctx["marks"].append(("requests made", time.perf_counter()))
    svc.warmup()
    svc.similarity(np.zeros((len(pool[0]["video"]), 512), np.float32),
                   np.zeros((len(pool[0]["audio"]), 512), np.float32))
    model.rows = {"audio": 0, "video": 0}
    win = Window(dev, ctx["seconds"], ctx["traced"])
    win.start()
    setup_s = win.t0 - ctx["t0"]
    answers, requests, failed = [], [], 0
    bks, sr = generate.buckets(hp), hp["data"]["audio_sample_rate"]
    period = 1.0 / float(traffic["rate_per_s"])
    for i in itertools.count():
        due = win.t0 + i * period
        if due - win.t0 >= ctx["seconds"]:
            break
        wait = due - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        win.running()
        r = next(order)
        req = pool[r]
        rows_before = model.rows["audio"] + model.rows["video"]
        t = time.perf_counter()
        try:
            with record_function("embed_video"):
                v = svc.embed_video(req["video"])
            with record_function("embed_audio"):
                a = svc.embed_audio(req["audio"])
            with record_function("similarity"):
                s = svc.similarity(v, a)
        except RuntimeError:
            failed += 1
            requests.append({"latency_s": float("inf"), "pairs": 0,
                             "traced": win.traced})
            continue
        done = time.perf_counter()
        answers.append((r, v, a, s))
        requests.append({
            "latency_s": done - due, "service_s": done - t,
            "traced": win.traced, "pairs": len(req["video"]),
            "rows_real": len(req["video"]) + len(req["audio"]),
            "rows_run": model.rows["audio"] + model.rows["video"]
            - rows_before,
            "buckets": [(rserve.bucket_length(x.shape[0], bks, generate.FPS)
                         / generate.FPS,
                         rserve.bucket_length(y.shape[0], bks, sr) / sr)
                        for x, y in zip(req["video"], req["audio"])]})
    win.stop()
    record = {"setup_s": setup_s, "window_s": win.seconds,
              "memory_peak_bytes": kinds.peak_bytes(dev),
              "attempted": len(requests), "failed": failed,
              "requests": requests}
    t = time.perf_counter()
    record["trace"] = win.reduce()
    record["trace_s"] = time.perf_counter() - t
    del svc, model
    kinds.release(dev)
    t_ref = time.perf_counter()

    checked = checked_requests(pool, [r for r, *_ in answers], seed)
    answers = [x for x in answers if x[0] in checked]
    refs = reference_answers(hp, seed, pool, sorted(checked), dev)
    emb_gap = sim_gap = 0.0
    for r, v, a, s in answers:
        rv, ra, rs = refs[r]
        emb_gap = max(emb_gap, float(np.abs(v - rv).max()),
                      float(np.abs(a - ra).max()))
        sim_gap = max(sim_gap, float(np.abs(s - rs).max()))
    readings = {"emb_gap": emb_gap, "sim_gap": sim_gap,
                "failed_requests": failed + (0 if answers else 1)}
    record["readings"] = readings
    record["reference_s"] = time.perf_counter() - t_ref
    record["checks"] = kinds.checks(readings, ctx["limits"])
    return record


def checked_requests(pool, answered, seed: int) -> set:
    """A seeded sample of the answered requests, with the one that holds
    the longest clip."""
    distinct = sorted(set(answered))
    if not distinct:
        return set()
    rng = np.random.default_rng([seed, 9])
    picked = set(rng.choice(distinct, min(CHECKED_REQUESTS, len(distinct)),
                            replace=False).tolist())
    picked.add(max(distinct, key=lambda r: max(pool[r]["durations"])))
    return picked


def reference_answers(hp: dict, seed: int, pool, indices, dev):
    """{request: (V, A, cosine matrix)} of the reference, float64 numpy."""
    w = ref.draw_weights(hp, seed, dev)
    ops = ref.Ops()
    bks = generate.buckets(hp)
    sr = hp["data"]["audio_sample_rate"]
    video, audio = {}, {}  # bucket length -> [(request, row, padded)]
    for r in indices:
        for j, (x, y) in enumerate(zip(pool[r]["video"], pool[r]["audio"])):
            f = rserve.bucket_length(x.shape[0], bks, generate.FPS)
            video.setdefault(f, []).append((r, j, rserve.padded(
                rserve.as_uint8(x), f)))
            s = rserve.bucket_length(y.shape[0], bks, sr)
            audio.setdefault(s, []).append((r, j, rserve.padded(y, s)))
    out = {r: (np.zeros((len(pool[r]["video"]), 512)),
               np.zeros((len(pool[r]["audio"]), 512))) for r in indices}
    with torch.no_grad():
        for tower, groups in ((0, video), (1, audio)):
            for items in groups.values():
                for lo in range(0, len(items), REFERENCE_ROWS):
                    chunk = items[lo:lo + REFERENCE_ROWS]
                    x = torch.from_numpy(np.stack([c[2] for c in chunk])).to(
                        dev)
                    e = (ref.video_embed(w, hp, x, None, False, ops)
                         if tower == 0 else ref.audio_embed(w, hp, x, ops))
                    e = e.double().cpu().numpy()
                    for (r, j, _), row in zip(chunk, e):
                        out[r][tower][j] = row
    return {r: (v, a, ref.cosine(torch.from_numpy(v),
                                 torch.from_numpy(a)).numpy())
            for r, (v, a) in out.items()}
