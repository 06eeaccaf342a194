"""The plain reference against `peppa_tpu_torch` on the CPU, at one
transformer layer and small frames, float32: the towers in eval mode, the
first two accumulation groups of training (dropout and layer-drop masks,
the loss, the mean gradient, BertAdam's clip, moments and parameters'
change), and the int8 control well away from both; the reference runs
with TF32 off whatever the process set."""

import pytest
import torch

from benchmark import generate
from benchmark.cells import Bench
from benchmark.kinds.train import (CHECKED_GROUPS, clip_batch,
                                    optimizer_grad_norms, param_change_norms)
from benchmark.program import build_model, port_config
from benchmark.reference import model as ref
from benchmark.reference import train as rtrain
from benchmark.tests.tiny import TRAFFIC, tiny_hparams
from peppa_tpu_torch.training.state import TrainState
from peppa_tpu_torch.training.step import train_step

BENCH = Bench()


@pytest.fixture(params=["peppa-base", "peppa-production"])
def hp(request):
    torch.set_num_threads(4)
    return tiny_hparams(BENCH.config(request.param)["hparams"])


def test_param_spec_is_the_programs(hp):
    weights = ref.draw_weights(hp, 3, "cpu")
    model = build_model(hp, weights, "cpu")  # strict: names and shapes
    assert set(model.state_dict()) == set(weights)
    again = ref.draw_weights(hp, 3, "cpu")
    assert all(torch.equal(weights[k], again[k]) for k in weights)


def test_eval_towers_match(hp):
    w = ref.draw_weights(hp, 11, "cpu")
    model = build_model(hp, w, "cpu")
    g = torch.Generator().manual_seed(0)
    width, height = hp["data"]["target_size"]
    video = torch.randint(0, 256, (3, 12, height, width, 3), generator=g,
                          dtype=torch.uint8)
    audio = torch.randn((3, 9600), generator=g) * 0.1
    frames = torch.tensor([12, 7, 2], dtype=torch.int32)
    with torch.no_grad():
        v = model.encode_video(video, frames)
        a = model.encode_audio(audio)
        rv = ref.video_embed(w, hp, video, frames, False, ref.Ops())
        ra = ref.audio_embed(w, hp, audio, ref.Ops())
        qa = ref.audio_embed(w, hp, audio, ref.Ops(quant=True))
    assert (v - rv).abs().max() < 1e-5
    assert (a - ra).abs().max() < 1e-5
    assert (qa - ra).abs().max() > 1e-3


def test_first_optimizer_step_matches(hp):
    seed = 2 ** 31 + 17
    traffic = dict(BENCH.traffic("train-jitter"), **TRAFFIC["train-jitter"])
    rows = hp["data"]["train"]["batch_size"]
    k = hp["training"]["trainer_args"]["accumulate_grad_batches"]
    plan = generate.train_plan(traffic, seed, CHECKED_GROUPS * k)
    batches = [generate.train_batch(traffic, hp, seed, i, b, rows, "cpu")
               for i, b in enumerate(plan)]
    w = ref.draw_weights(hp, seed, "cpu")
    state = TrainState.create(build_model(hp, w, "cpu"), port_config(hp))
    losses = []
    for i, b in enumerate(batches):
        state, out = train_step(state, clip_batch(b), seed, device="cpu")
        losses.append(float(out["train_loss"]))
        if i == k - 1:
            prog_g = optimizer_grad_norms(state, hp["optimizer"]["b1"])
            assert max(param_change_norms(state, w).values()) == 0.0
    prog_dp = param_change_norms(state, w)
    r = rtrain.optimizer_steps(hp, w, batches, seed, ref.Ops(),
                               CHECKED_GROUPS)
    assert rtrain.loss_gap(losses, r["losses"]) < 1e-5
    got = rtrain.readings(losses, prog_g, prog_dp, r)
    assert got["grad_gap"] < 1e-4
    assert got["change_gap"] < 1e-3
    assert min(rtrain.norms(r["dp"]).values()) > 0.0
    unmoved = rtrain.readings(losses, prog_g, dict.fromkeys(prog_dp, 0.0), r)
    assert unmoved["change_gap"] == 1.0
    q = rtrain.optimizer_steps(hp, w, batches, seed, ref.Ops(quant=True),
                               CHECKED_GROUPS)
    assert rtrain.loss_gap(q["losses"], r["losses"]) > 1e-3


def test_reference_runs_without_tf32(hp, monkeypatch):
    seen = []
    real = ref.attention_pool

    def pool(*args, **kw):
        seen.append((torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32))
        return real(*args, **kw)
    monkeypatch.setattr(ref, "attention_pool", pool)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    w = ref.draw_weights(hp, 5, "cpu")
    width, height = hp["data"]["target_size"]
    with torch.no_grad():
        ref.video_embed(w, hp, torch.zeros((1, 4, height, width, 3),
                                           dtype=torch.uint8), None, False,
                        ref.Ops())
        ref.audio_embed(w, hp, torch.zeros((1, 4000)), ref.Ops())
    assert seen == [(False, False)] * 2
    assert torch.backends.cuda.matmul.allow_tf32
    assert torch.backends.cudnn.allow_tf32
