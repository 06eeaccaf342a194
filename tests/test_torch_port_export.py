"""The port's deployment path (`peppa_tpu_torch/export.py`) against the
JAX package's (`peppa_tpu/export.py`), on the CPU.

tests/test_export.py's configuration with the transformer in
(`audio.full`, 2 layers), so that the attention op is in the graph: 32x32
frames, 800 Hz audio, R3D-18, float32, buckets of 0.5 and 1.0 s, batch 3.
The JAX model's variables are carried across with `load_jax_variables`;
both packages export them.

- The port's artifact reloads to the port's live `EncoderService` bit for
  bit (embeddings and similarity), float and W8A8.
- It matches the JAX package's artifact of the same weights within TOL
  (float).  A W8A8 tower runs free at rounding ties: one float32 ulp
  before a quantization moves an int8 value, and it grows, so the two
  packages' int8 embeddings differ about as much as int8 differs from
  float (tests/test_torch_port_quant.py).  So the W8A8 artifacts are
  held as that file holds the towers: the JAX artifact equal to the JAX
  model on the batch, and the port's model, each int8 product fed the JAX
  call's input, within that file's TOL of it; the port's artifact is the
  port's model bit for bit.
- The audio graph holds one `peppa_tpu_torch.mha_attention` node per layer
  and no einsum; the programs hold no weights.
"""

import json
import os
import shutil
import subprocess
import sys
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from peppa_tpu.config import Config as JaxConfig
from peppa_tpu.export import ExportedEncoders as JaxExported
from peppa_tpu.export import export_encoders as jax_export_encoders
from peppa_tpu.models.dual_encoder import PeppaPig as JaxPeppaPig
from peppa_tpu.models.dual_encoder import init_model as jax_init_model
from peppa_tpu.utils.request_batching import padded_chunk
from peppa_tpu_torch import export as E
from peppa_tpu_torch.config import Config
from peppa_tpu_torch.models.convert import load_jax_variables
from peppa_tpu_torch.models.dual_encoder import PeppaPig, init_model
from peppa_tpu_torch.ops.cuda.attention import attention_op
from peppa_tpu_torch.serving import EncoderService
from peppa_tpu_torch.training import checkpoint as C
from test_torch_port_quant import TOL as INT8_TOL
from test_torch_port_quant import _feed_jax_inputs, _record_jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-4  # the slice test's, float32
RAW = {"data": {"target_size": [32, 32], "audio_sample_rate": 800},
       "audio": {"full": True, "num_layers": 2},
       "video": {"version": "r3d_18"},
       "training": {"trainer_args": {"precision": 32}},
       "tpu": {"bucket_durations": [0.5, 1.0]}}
RAW_INT8 = {**RAW, "tpu": {**RAW["tpu"], "quantize_int8": True}}
BATCH = 3
OP = "peppa_tpu_torch.mha_attention.default"


def _requests():
    rng = np.random.default_rng(0)
    waves = [rng.normal(size=(s,)).astype(np.float32)
             for s in (200, 380, 400, 750, 123)]
    clips = [rng.uniform(size=(t, 32, 32, 3)).astype(np.float32)
             for t in (3, 5, 9)]
    return waves, clips


@pytest.fixture(scope="module")
def made(tmp_path_factory):
    """Both packages' float and W8A8 artifacts of the same weights, and the
    port's live services."""
    torch.set_num_threads(2)
    root = tmp_path_factory.mktemp("export")
    jcfg, cfg = JaxConfig.from_dict(RAW), Config.from_dict(RAW)
    jmodel, variables = jax_init_model(jcfg, jax.random.PRNGKey(0))
    variables = jax.tree.map(np.asarray, variables)
    port = init_model(cfg, seed=0, device="cpu")
    load_jax_variables(port, variables)
    qcfg = Config.from_dict(RAW_INT8)
    port_q = PeppaPig(qcfg)
    port_q.load_state_dict(port.state_dict())
    port_q.eval()
    jq = JaxPeppaPig(JaxConfig.from_dict(RAW_INT8))
    out = {k: str(root / k) for k in ("port", "jax", "port_q", "jax_q")}
    manifest = E.export_encoders(port, cfg, out["port"], batch_size=BATCH)
    E.export_encoders(port_q, qcfg, out["port_q"], batch_size=BATCH)
    jax_export_encoders(jmodel, variables, jcfg, out["jax"],
                        batch_size=BATCH)
    jax_export_encoders(jq, variables, JaxConfig.from_dict(RAW_INT8),
                        out["jax_q"], batch_size=BATCH)
    yield SimpleNamespace(
        root=root, out=out, manifest=manifest, variables=variables,
        port=port, port_q=port_q, jq=jq, cfg=cfg,
        svc=EncoderService(port, cfg, batch_size=BATCH, device="cpu"),
        svc_q=EncoderService(port_q, qcfg, batch_size=BATCH, device="cpu"))
    shutil.rmtree(root, ignore_errors=True)


def test_manifest_and_files(made):
    out, manifest = made.out["port"], made.manifest
    assert manifest["format"] == "peppa-tpu-torch-export-v1"
    assert manifest["platforms"] == ["cpu"]
    assert manifest["torch_version"] == torch.__version__
    # 2 buckets x 2 encoders, named by size and platform
    assert sorted(p["file"] for p in manifest["programs"]) == [
        "audio_s400.cpu.pt2", "audio_s800.cpu.pt2", "video_t10.cpu.pt2",
        "video_t5.cpu.pt2"]
    for prog in manifest["programs"]:
        assert prog["platform"] == "cpu"
        assert os.path.getsize(os.path.join(out, prog["file"])) > 0
    with open(os.path.join(out, "manifest.json")) as f:
        assert json.load(f)["batch_size"] == BATCH
    assert manifest["config"]["data"]["audio_sample_rate"] == 800
    # the JAX manifest's keys, with torch's version in place of jax's
    with open(os.path.join(made.out["jax"], "manifest.json")) as f:
        jax_keys = set(json.load(f)) - {"jax_version"}
    assert jax_keys | {"torch_version"} == set(manifest)


@pytest.mark.parametrize("flavour", ["float", "w8a8"])
def test_reload_equals_live_service(made, flavour):
    """Bit for bit: the programs run the eager model's ATen ops."""
    out, svc = ((made.out["port"], made.svc) if flavour == "float"
                else (made.out["port_q"], made.svc_q))
    enc = E.ExportedEncoders(out, device="cpu")
    waves, clips = _requests()
    a, v = enc.embed_audio(waves), enc.embed_video(clips)
    a_live, v_live = svc.embed_audio(waves), svc.embed_video(clips)
    assert a.shape == (5, 512) and v.shape == (3, 512)
    assert np.array_equal(a, a_live) and np.array_equal(v, v_live)
    assert np.array_equal(enc.similarity(v, a), svc.similarity(v_live,
                                                               a_live))
    np.testing.assert_allclose(np.linalg.norm(a, axis=1), 1.0, rtol=1e-5)


def test_float_artifact_matches_jax_artifact(made):
    waves, clips = _requests()
    enc = E.ExportedEncoders(made.out["port"], device="cpu")
    jenc = JaxExported(made.out["jax"])
    a, v = enc.embed_audio(waves), enc.embed_video(clips)
    ja, jv = jenc.embed_audio(waves), jenc.embed_video(clips)
    np.testing.assert_allclose(a, ja, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(v, jv, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(enc.similarity(v, a),
                               jenc.similarity(jv, ja), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("kind", ["audio", "video"])
def test_w8a8_artifact_matches_jax_artifact(made, monkeypatch, kind):
    """One batch of the first bucket: the JAX artifact equal to the JAX
    int8 model; the port's int8 model, each product fed the JAX call's
    input, within the quant test's TOL of the JAX artifact; the port's
    artifact equal to the port's int8 model."""
    waves, clips = _requests()
    if kind == "audio":
        items, size, dtype = waves[:BATCH], 400, np.float32
        method = made.jq.encode_audio
    else:
        items = [np.clip(np.rint(c * 255.0), 0, 255).astype(np.uint8)
                 for c in clips]
        size, dtype, method = 5, np.uint8, made.jq.encode_video
    batch = padded_chunk(items, list(range(BATCH)), size, BATCH,
                         items[0].shape[1:], dtype)
    embed = "embed_audio" if kind == "audio" else "embed_video"
    jax_art = getattr(JaxExported(made.out["jax_q"]), embed)(
        [items[i][:size] for i in range(BATCH)])
    port_art = getattr(E.ExportedEncoders(made.out["port_q"], device="cpu"),
                       embed)([items[i][:size] for i in range(BATCH)])
    calls = _record_jax(monkeypatch)
    jax_live = np.asarray(made.jq.apply(made.variables, batch,
                                        method=method))
    np.testing.assert_allclose(jax_art, jax_live, rtol=0, atol=INT8_TOL)
    x = torch.from_numpy(batch)
    with torch.no_grad():
        port_live = (made.port_q.encode_audio(x) if kind == "audio"
                     else made.port_q.encode_video(x)).numpy()
    assert np.array_equal(port_art, port_live)
    seen = _feed_jax_inputs(monkeypatch, calls)
    with torch.no_grad():
        fed = (made.port_q.encode_audio(x) if kind == "audio"
               else made.port_q.encode_video(x)).numpy()
    assert seen["n"] == len(calls) > 0
    np.testing.assert_allclose(fed, jax_art, rtol=0, atol=INT8_TOL)


def test_graphs_hold_the_attention_op_and_no_weights(made):
    out = made.out["port"]
    sizes = {}
    for prog in made.manifest["programs"]:
        path = os.path.join(out, prog["file"])
        sizes[prog["file"]] = os.path.getsize(path)
        counts = E.op_counts(path)
        assert not any("einsum" in k for k in counts), counts
        if prog["kind"] == "audio":
            assert counts.get(OP) == 2, counts  # one per layer
        else:
            assert OP not in counts
    # the weights are written once, outside the programs
    variables = os.path.getsize(os.path.join(out, "variables.pt"))
    assert sum(sizes.values()) < 0.05 * variables, (sizes, variables)
    assert variables > sum(p.numel() * 4 for p in made.port.parameters())
    q_counts = E.op_counts(os.path.join(made.out["port_q"],
                                        "audio_s400.cpu.pt2"))
    # on the CPU the int8 matmuls are `_int_mm` (proj, 6 per layer) and the
    # convs a float64 conv
    assert q_counts.get("aten._int_mm.default") == 1 + 6 * 2, q_counts


def test_overlong_crops_to_last_bucket(made):
    enc = E.ExportedEncoders(made.out["port"], device="cpu")
    wave = np.random.default_rng(1).normal(size=(1280,)).astype(np.float32)
    assert np.array_equal(enc.embed_audio([wave]),
                          enc.embed_audio([wave[:800]]))


def test_rejects_wrong_format_and_missing_platform(made, tmp_path):
    bad = tmp_path / "bad"
    bad.mkdir()
    with open(bad / "manifest.json", "w") as f:
        json.dump({"format": "something-else"}, f)
    for path in (str(bad), made.out["jax"]):  # the JAX package's artifact
        with pytest.raises(ValueError,
                           match="not a peppa-tpu-torch export artifact"):
            E.ExportedEncoders(path, device="cpu")
    # an artifact of the card's programs only: no fallback to the CPU
    cuda_only = tmp_path / "cuda_only"
    cuda_only.mkdir()
    manifest = dict(made.manifest, platforms=["cuda"], programs=[
        dict(p, platform="cuda") for p in made.manifest["programs"]])
    with open(cuda_only / "manifest.json", "w") as f:
        json.dump(manifest, f)
    with pytest.raises(ValueError, match="no program for platform 'cpu'"):
        E.ExportedEncoders(str(cuda_only), device="cpu")


@pytest.mark.parametrize("lengths", [None, [7, 3]], ids=["full", "lengths"])
def test_attention_op_passes_opcheck(lengths):
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 7, 3, 16, generator=gen) for _ in range(3))
    lens = None if lengths is None else torch.tensor(lengths)
    torch.library.opcheck(attention_op, (q, k, v, lens, 0.25))


_LOAD_PROBE = r"""
import sys
for blocked in ("jax", "flax", "msgpack"):
    sys.modules[blocked] = None
import numpy as np
from peppa_tpu_torch.export import ExportedEncoders
enc = ExportedEncoders(sys.argv[1], device="cpu")
emb = enc.embed_audio([np.zeros(300, np.float32)])
print(emb.shape, sorted(m for m in sys.modules
                        if m.startswith(("peppa_tpu_torch.models",
                                         "peppa_tpu_torch.training",
                                         "peppa_tpu."))))
"""


def test_loading_needs_no_model_code(made):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _LOAD_PROBE,
                          made.out["port"]], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.strip().splitlines()[-1] == "(1, 512) []"


def _port_run_dir(made, root):
    """A port run directory of the fixture's weights: hparams.yaml and a
    best checkpoint (the model only) with its sidecar."""
    vdir = os.path.join(root, "version_0")
    os.makedirs(vdir)
    made.cfg.dump(os.path.join(vdir, "hparams.yaml"))
    path = os.path.join(vdir, "checkpoints",
                        "epoch=3-valnarr_triplet=0.75.ckpt")
    C.save_checkpoint(path, SimpleNamespace(
        state_dict=lambda: {"model": made.port.state_dict()}),
        {"monitor": "valnarr_triplet", "mode": "max",
         "best_model_score": 0.75, "best_model_path": path, "epoch": 3,
         "metrics": {}})
    return vdir


def test_main_exports_a_run_dir_and_writes_a_reference_ckpt(made, tmp_path,
                                                             capsys):
    vdir = _port_run_dir(made, str(tmp_path))
    out = str(tmp_path / "artifact")
    E.main([vdir, out, "--batch_size", str(BATCH), "--platforms", "cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == {"out_dir": out, "programs": 4, "platforms": ["cpu"]}
    waves, _ = _requests()
    assert np.array_equal(
        E.ExportedEncoders(out, device="cpu").embed_audio(waves),
        made.svc.embed_audio(waves))
    shutil.rmtree(out)

    ref = os.path.join(str(tmp_path), "ref")
    path = os.path.join(ref, "checkpoints", "best.ckpt")
    E.main([vdir, "--reference_ckpt", path, "--platforms", "cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert (line["monitor"], line["score"]) == ("valnarr_triplet", 0.75)
    shutil.copy(os.path.join(vdir, "hparams.yaml"), ref)
    loaded, _, got = C.load_best_model(ref, device="cpu")
    assert got == path
    want = made.port.state_dict()
    state = loaded.state_dict()
    assert set(state) == set(want)
    assert all(torch.equal(state[k], want[k]) for k in want)


def test_main_checks_arguments_before_loading(tmp_path):
    with pytest.raises(SystemExit):
        E.main([str(tmp_path / "absent")])  # no out_dir, no reference
