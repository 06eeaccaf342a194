"""The forced aligner (`preprocess/forced_align.py`) against the JAX
package's: the tokenizer; the native Viterbi DP, the port's Python DP and
the JAX package's Python DP bit for bit; `align_ctc`; the CTC acoustic
model (`make_ctc_logits_fn`) on carried-across weights within 1e-4, its
frame counts, and the key lengths it gives the attention kernel's
wrapper; and `realign` end to end, byte for byte with a fake acoustic
model and with equal word timings with the tiny real one.

Small sizes: tests/test_models.py's tiny wav2vec2 (2 layers, 32 wide,
float32), 16 kHz episodes of 10-25 s.
"""

import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch

import peppa_tpu.preprocess.forced_align as JF
import peppa_tpu_torch.preprocess.forced_align as F
from peppa_tpu.models.wav2vec2 import Wav2Vec2 as JaxWav2Vec2
from peppa_tpu_torch.models import wav2vec2 as W
from peppa_tpu_torch.models.convert import export_wav2vec2_torchaudio
from test_forced_align import synth_logits
from test_models import TINY_W2V as JAX_TINY
from test_torch_port_convert import _two_threads  # noqa: F401
from torch_port_prep_data import tree_bytes, write_in_tree

TINY = W.Wav2Vec2Config(**{k: getattr(JAX_TINY, k) for k in (
    "embed_dim", "num_layers", "num_heads", "ffn_dim", "num_out",
    "pos_conv_kernel", "pos_conv_groups", "layer_drop")})
SR = 16000
TOL = 1e-4  # the towers' tolerance (PARITY.md)
BUCKETS = (1.0, 2.0)


@pytest.fixture(scope="module")
def jax_variables():
    variables = JaxWav2Vec2(JAX_TINY).init(jax.random.PRNGKey(0),
                                           np.zeros((1, SR), np.float32))
    return jax.tree.map(np.asarray, variables)


def _log_probs(rng, T, V=len(F.CTC_CHARS), dtype=np.float64):
    lp = rng.normal(scale=2.0, size=(T, V))
    return (lp - np.log(np.exp(lp).sum(axis=1, keepdims=True))).astype(dtype)


def _wav(path, n, freq=0.05):
    F._write_wav(str(path), np.sin(np.arange(n) * freq) * 0.25, SR)
    return str(path)


@pytest.mark.parametrize("text", [
    "the cat", "hello [laughs] world", "Peppa's  muddy\tpuddles!",
    "  ", "[all bracketed]", "naïve café 42"])
def test_tokenizer_equals_jax(text):
    assert F.clean(text) == JF.clean(text)
    assert F.text_to_tokens(text) == JF.text_to_tokens(text)
    assert F.CTC_CHARS == JF.CTC_CHARS
    assert (F.BLANK, F.WORD_SEP) == (JF.BLANK, JF.WORD_SEP)


def _dp_cases():
    rng = np.random.default_rng(7)
    return [F.text_to_tokens("hi mum")[0],      # with a word separator
            F.text_to_tokens("mummmy emme")[0],  # repeats: no skip arcs
            [5] * 6, [6, 6, 7, 7, 6], [9],
            list(rng.integers(5, 27, size=40))]


@pytest.mark.parametrize("case", range(len(_dp_cases())))
def test_dps_bit_identical(case):
    """The native DP, the port's Python DP and the JAX package's Python DP
    give the same labels and score bit for bit, at T == N, N + 1 and
    4N + 3, on float32 and float64 log-probs."""
    tokens = _dp_cases()[case]
    rng = np.random.default_rng(100 + case)
    for T in (len(tokens), len(tokens) + 1, 4 * len(tokens) + 3):
        for dtype in (np.float32, np.float64):
            lp = _log_probs(rng, T, dtype=dtype)
            la_c, sc_c = F.ctc_forced_align(lp, tokens)
            la_p, sc_p = F._ctc_align_python(lp, tokens)
            la_j, sc_j = JF._ctc_align_python(lp, tokens)
            np.testing.assert_array_equal(la_c, la_p)
            np.testing.assert_array_equal(la_c, la_j)
            assert sc_c == sc_p == sc_j
            if T == len(tokens) and all(  # one frame per token, when
                    a != b for a, b in zip(tokens, tokens[1:])):  # no blank
                np.testing.assert_array_equal(la_c, np.arange(T))


def test_dp_rejects_what_jax_rejects():
    lp = np.zeros((5, 4))
    with pytest.raises(ValueError, match="out of range"):
        F.ctc_forced_align(lp, [1, 99])
    with pytest.raises(IndexError):
        F._ctc_align_python(lp, [1, 99])
    with pytest.raises(IndexError):
        JF._ctc_align_python(lp, [1, 99])
    for tokens, T in (([], 5), ([5, 6, 7], 2)):
        for fn in (F.ctc_forced_align, JF.ctc_forced_align):
            with pytest.raises(ValueError, match="cannot align"):
                fn(np.zeros((T, 28)), tokens)


def test_native_library_is_the_ports_own():
    from peppa_tpu_torch.native import build

    path = build.build("ctc_align")
    assert path.endswith("libpeppa_ctc_align.so")
    assert os.path.dirname(os.path.dirname(path)) == build.BUILD_ROOT
    assert F._native_align_lib()._name == path


@pytest.mark.parametrize("transcript,spans,T", [
    ("hi mum", [(5, 9), (10, 14), (15, 17), (20, 24), (25, 28), (30, 34)],
     40),
    ("hello world", [(0, 1), (1, 2)], 3),  # too short: not found
    ("[noise]", [], 10),
    ("big muddy puddles", [(3 * i, 3 * i + 2) for i in range(17)], 60)])
def test_align_ctc_equals_jax(transcript, spans, T):
    tokens, _ = F.text_to_tokens(transcript)
    logits = synth_logits(tokens[:len(spans)], spans, T=T)
    got = F.align_ctc(logits, transcript, frame_seconds=0.02)
    assert got == JF.align_ctc(logits, transcript, frame_seconds=0.02)


def test_ctc_logits_fn_equals_jax(tmp_path, jax_variables, monkeypatch):
    """0.5 s and 1.7 s wavs in buckets of 1 and 2 s: log-probs within 1e-4
    of the JAX package's, one row per conv frame of the true length, rows
    summing to 1; each layer's attention gets the true frame count as its
    key length over the bucket's frames."""
    calls = []
    real = W.mha_attention

    def recorded(q, k, v, lengths=None, scale=None):
        calls.append((q.shape, None if lengths is None
                      else lengths.tolist()))
        return real(q, k, v, lengths=lengths, scale=scale)

    monkeypatch.setattr(W, "mha_attention", recorded)
    fn = F.make_ctc_logits_fn(variables=jax_variables, cfg=TINY,
                              bucket_seconds=BUCKETS, sample_rate=SR,
                              device="cpu")
    want_fn = JF.make_ctc_logits_fn(variables=jax_variables, cfg=JAX_TINY,
                                    bucket_seconds=BUCKETS, sample_rate=SR)
    for seconds, bucket in ((0.5, 1.0), (1.7, 2.0)):
        n = int(seconds * SR)
        path = _wav(tmp_path / f"{seconds}.wav", n)
        calls.clear()
        got = fn(path)
        want = want_fn(path)
        frames = int(W.conv_output_length(n))
        assert got.shape == want.shape == (frames, len(F.CTC_CHARS))
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
        np.testing.assert_allclose(np.exp(got).sum(axis=1), 1.0, atol=1e-4)
        t_bucket = int(W.conv_output_length(int(bucket * SR)))
        assert calls == [((1, t_bucket, TINY.num_heads,
                           TINY.embed_dim // TINY.num_heads),
                          [frames])] * TINY.num_layers
    with pytest.raises(ValueError, match="checkpoint_path or variables"):
        F.make_ctc_logits_fn(device="cpu")


def test_ctc_logits_fn_from_checkpoints(tmp_path, jax_variables, caplog):
    """A torchaudio-named checkpoint with the aux head gives the same
    log-probs as `variables`; a fairseq-named one without it warns, in
    both packages."""
    from test_torch_port_convert import _fairseq_state

    path = _wav(tmp_path / "a.wav", int(1.3 * SR))
    want = F.make_ctc_logits_fn(variables=jax_variables, cfg=TINY,
                                bucket_seconds=BUCKETS, device="cpu")(path)
    ckpt = str(tmp_path / "ta.pt")
    torch.save({"state_dict": export_wav2vec2_torchaudio(
        jax_variables["params"])}, ckpt)
    got = F.make_ctc_logits_fn(ckpt, cfg=TINY, bucket_seconds=BUCKETS,
                               device="cpu")(path)
    np.testing.assert_array_equal(got, want)
    jax_got = JF.make_ctc_logits_fn(ckpt, cfg=JAX_TINY,
                                    bucket_seconds=BUCKETS)(path)
    np.testing.assert_allclose(got, jax_got, atol=TOL, rtol=0)

    fairseq = str(tmp_path / "fs.pt")
    torch.save({"model": _fairseq_state(jax_variables["params"])}, fairseq)
    for make, cfg in ((lambda *a, **k: F.make_ctc_logits_fn(
            *a, device="cpu", **k), TINY), (JF.make_ctc_logits_fn, JAX_TINY)):
        caplog.clear()
        lp = make(fairseq, cfg=cfg, bucket_seconds=BUCKETS)(path)
        assert lp.shape == want.shape and np.isfinite(lp).all()
        assert "no 28-d aux head" in caplog.text


def _fake_logits(wav_path):
    """tests/test_forced_align.py's fake acoustic model: a frame count from
    the wav's duration, the tokens of "hi mum" peaked from frame 25."""
    import wave

    with wave.open(wav_path) as w:
        dur = w.getnframes() / w.getframerate()
    T = max(int(dur / 0.02), 8)
    tokens, _ = F.text_to_tokens("hi mum")
    span = max(T // (2 * len(tokens)), 1)
    spans = [(25 + i * span, 25 + i * span + span)
             for i in range(len(tokens))]
    return synth_logits(tokens, spans, T=T)


def _realign_both(data_dir, make_fns, nthreads):
    """Run each package's realign (narration and dialog, val) on one tree
    in turn; returns their out/realign trees as {path: bytes}."""
    out = []
    for realign, fn in zip((JF.realign, F.realign), make_fns()):
        for fragment in ("narration", "dialog"):
            realign(fragment, data_dir=data_dir, ctc_logits_fn=fn,
                    splits=("val",), nthreads=nthreads)
        root = os.path.join(data_dir, "out", "realign")
        out.append(tree_bytes(root))
        shutil.rmtree(root)
    return out


@pytest.mark.parametrize("nthreads", [1, 3])
def test_realign_files_equal_jax(tmp_path, nthreads):
    """realign with the fake acoustic model: every wav and JSON of the
    narration and dialog val lines, byte for byte the JAX package's, with
    `nthreads` workers; the speaker file of a dialog episode wins over its
    annotation, as in the JAX package."""
    import yaml

    data_dir = str(tmp_path / "data")
    write_in_tree(data_dir, episodes=(1, 2, 197))
    with open(os.path.join(data_dir, "in", "peppa", "episodes",
                           "ep_197.json")) as f:
        annotation = json.load(f)
    annotation["narrator_splits"][0]["context"]["subtitles"][0][
        "speaker"] = "Suzy Sheep"
    os.makedirs(os.path.join(data_dir, "out", "speaker_id"))
    with open(os.path.join(data_dir, "out", "speaker_id", "ep_197.yaml"),
              "w") as f:
        yaml.safe_dump(annotation, f)
    got, want = _realign_both(data_dir, lambda: (_fake_logits,) * 2,
                              nthreads)
    assert got == want
    names = sorted(got)
    assert len(names) == 3 * 2 * 2 * 2  # 3 episodes, 2 parts, 2 lines
    first = json.loads(got["dialog/ep_197/0/0.json"])
    assert first["speaker"] == "Suzy Sheep"
    assert first["episode_metadata_path"].endswith("ep_197.yaml")
    assert all(w["case"] == "success"
               for w in json.loads(got["narration/ep_1/0/0.json"])["words"])


def test_realign_with_the_tiny_model_equals_jax(tmp_path, jax_variables):
    """realign with each package's tiny CTC model on the same weights
    (buckets of 2 and 4 s): the same words, cases and timings, and the
    same wavs."""
    data_dir = str(tmp_path / "data")
    write_in_tree(data_dir, episodes=(1, 197), parts=1)
    kw = dict(variables=jax_variables, bucket_seconds=(2.0, 4.0))
    got, want = _realign_both(data_dir, lambda: (
        JF.make_ctc_logits_fn(cfg=JAX_TINY, **kw),
        F.make_ctc_logits_fn(cfg=TINY, device="cpu", **kw)), 2)
    assert got.keys() == want.keys() and len(got) == 8
    for name in got:
        if name.endswith(".wav"):
            assert got[name] == want[name], name
            continue
        g, w = json.loads(got[name]), json.loads(want[name])
        assert g["words"] == w["words"], name
        # a sum over the frames of log-probs within 1e-4 each
        np.testing.assert_allclose(g.pop("log_likelihood"),
                                   w.pop("log_likelihood"), rtol=1e-4)
        assert g == w, name
