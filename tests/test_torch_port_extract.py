"""Episode extraction (`preprocess/extract.py`) against the JAX package's:
`extract_from_episode` on an `.npz` episode and on an mpeg4 `.avi` one,
into either container; `extract` over a `data/in` tree; `extract_realines`
over a realign tree; and `PigData.prepare_data` with `data.extract: true`
followed by the statistics pass.  Clips compare by their arrays (frames,
audio, fps, rate, duration: `.npz` archives carry the time they were
written) and, for `.avi`, byte for byte; the sidecar JSONs byte for byte.

Small sizes: 60x40 episodes at 25 fps cut to 32x24, 800 Hz or 16 kHz
audio, episodes of 10-25 s.
"""

import os
import shutil

import numpy as np
import pytest

import peppa_tpu.preprocess.extract as JE
import peppa_tpu_torch.preprocess.extract as E
from peppa_tpu.config import Config as JaxConfig
from peppa_tpu.data.datamodule import PigData as JaxPigData
from peppa_tpu.data.stats import load_stats as jax_load_stats
from peppa_tpu_torch.config import Config
from peppa_tpu_torch.data import decode as D
from peppa_tpu_torch.data.datamodule import PigData
from peppa_tpu_torch.data.stats import load_stats
from torch_port_prep_data import tree_bytes, write_in_tree

TS = (32, 24)


def _contents(root):
    """{relative path: arrays of an .npz, or bytes} under `root`."""
    out = {}
    for rel, data in tree_bytes(root).items():
        if rel.endswith(".npz"):
            with np.load(os.path.join(root, rel)) as z:
                out[rel] = {k: z[k] for k in z.files}
        else:
            out[rel] = data
    return out


def assert_same_contents(got, want):
    assert sorted(got) == sorted(want)
    for rel, w in want.items():
        g = got[rel]
        if isinstance(w, dict):
            assert g.keys() == w.keys(), rel
            for k in w:
                np.testing.assert_array_equal(g[k], w[k], f"{rel}:{k}")
                assert g[k].dtype == w[k].dtype, f"{rel}:{k}"
        else:
            assert g == w, rel


def _both(data_dir, run):
    """`run(module)` for the JAX package's module, then the port's, on one
    tree; returns the contents each wrote under `data_dir/out`."""
    out = []
    for module in (JE, E):
        run(module)
        root = os.path.join(data_dir, "out")
        out.append(_contents(root))
        shutil.rmtree(root)
    return out


ANNOTATION = {
    "id": 7, "title": "test",
    "narrator_splits": [{
        "context": {"tokenized": [
            {"token": "hi", "begin": "00:00:01", "end": "00:00:02"},
            {"token": "pig", "begin": "00:00:02", "end": "00:00:04.250"}],
            "subtitles": []},
        "narration": {"tokenized": [
            {"token": "peppa", "begin": "0:00:05.5", "end": "0:00:08.125"}],
            "subtitles": []},
    }, {
        "context": {"tokenized": [], "subtitles": []},
        "narration": {"tokenized": [
            {"token": "jumps", "begin": "0:00:09", "end": "0:00:11.9"}],
            "subtitles": []},
    }],
}


def test_extract_from_episode_npz_equals_jax(tmp_path, rng):
    """tests/test_preprocess.py's case, with `H:MM:SS` and `H:MM:SS.fff`
    stamps and two parts: the same clips and sidecars."""
    sr, fps, dur = 800, 25, 12.0
    episode = str(tmp_path / "episode.npz")
    D.save_clip_npz(episode,
                    (rng.uniform(size=(int(dur * fps), 40, 60, 3)) * 255)
                    .astype(np.uint8),
                    rng.normal(size=(int(dur * sr),)).astype(np.float32),
                    fps=fps, sample_rate=sr)
    data_dir = str(tmp_path / "data")
    got, want = _both(data_dir, lambda m: m.extract_from_episode(
        ANNOTATION, episode, (60, 40), data_dir=data_dir))
    assert_same_contents(got, want)
    assert sorted(got) == ["60x40/dialog/7/0.json", "60x40/dialog/7/0.npz",
                           "60x40/narration/7/0.json",
                           "60x40/narration/7/0.npz",
                           "60x40/narration/7/1.json",
                           "60x40/narration/7/1.npz"]
    clip = got["60x40/dialog/7/0.npz"]
    assert 30 <= clip["video"].shape[0] <= 33  # 3.25 s at 10 fps
    assert clip["audio"].shape[0] == pytest.approx(3.25 * 44100, abs=4410)


@pytest.mark.parametrize("container", ["npz", "avi"])
def test_extract_from_episode_avi_equals_jax(tmp_path, rng, container):
    """An mpeg4 + PCM `.avi` episode (decoded by cv2, resized to 32x24;
    its audio through the AVI reader): the same clips and sidecars."""
    pytest.importorskip("cv2")
    from peppa_tpu_torch.data.avi import write_clip_avi

    episode = str(tmp_path / "episode.avi")
    write_clip_avi(episode, rng.integers(0, 256, (300, 40, 60, 3),
                                         dtype=np.uint8),
                   rng.normal(size=(12 * 8000,)).astype(np.float32) * 0.2,
                   fps=25, rate=8000)
    data_dir = str(tmp_path / "data")
    got, want = _both(data_dir, lambda m: m.extract_from_episode(
        ANNOTATION, episode, TS, data_dir=data_dir, container=container))
    assert_same_contents(got, want)
    assert len(got) == 6
    if container == "npz":
        frames = got["32x24/narration/7/1.npz"]["video"]
        assert frames.shape[1:] == (24, 32, 3) and len(frames) >= 28


@pytest.mark.parametrize("container", ["npz", "avi"])
def test_extract_equals_jax(tmp_path, container):
    """`extract` over a data/in tree of three `.npz` episodes (list CSV,
    annotations, media): every clip and sidecar."""
    if container == "avi":
        pytest.importorskip("cv2")
    data_dir = str(tmp_path / "data")
    write_in_tree(data_dir, episodes=(1, 2, 197), container="npz", fps=25,
                  size=(60, 40), sample_rate=800)
    got, want = _both(data_dir, lambda m: m.extract(
        TS, data_dir=data_dir, container=container))
    assert_same_contents(got, want)
    # 3 episodes x 2 parts x (dialog, narration) x (clip, sidecar)
    assert len(got) == 24
    assert set(E.episode_titles(data_dir).values()) == {
        os.path.join(data_dir, "in", "peppa", f"ep_{n}.npz")
        for n in (1, 2, 197)}


def test_extract_realines_equals_jax(tmp_path):
    """The realigned utterances (the port's realign with a fake acoustic
    model) re-cut from their first to their last aligned word."""
    from peppa_tpu_torch.preprocess.forced_align import realign
    from test_torch_port_forced_align import _fake_logits

    data_dir = str(tmp_path / "data")
    write_in_tree(data_dir, episodes=(1, 197), container="npz", fps=25,
                  size=(60, 40), sample_rate=16000)
    for fragment in ("narration", "dialog"):
        realign(fragment, data_dir=data_dir, ctc_logits_fn=_fake_logits,
                nthreads=2)
    realigned = _contents(os.path.join(data_dir, "out", "realign"))
    want = []
    for module in (JE, E):
        module.extract_realines(TS, data_dir=data_dir)
        root = os.path.join(data_dir, "out", "realign")
        out = _contents(root)
        want.append(out)
        for rel in out:
            if rel.endswith(".npz"):
                os.unlink(os.path.join(root, rel))
    assert_same_contents(want[1], want[0])
    clips = [r for r in want[1] if r.endswith(".npz")]
    assert len(clips) == len([r for r in realigned if r.endswith(".json")])
    assert len(clips) == 8


def test_prepare_data_extracts_then_collects_stats(tmp_path):
    """`PigData.prepare_data` with `data.extract` and `data.prepare`: the
    tree extracted from data/in as the JAX package extracts it, then the
    same statistics of its dialog train clips."""
    import random

    raw = {"data": {"target_size": list(TS), "audio_sample_rate": 800,
                    "extract": True, "prepare": True,
                    "train": {"duration": 0.8, "jitter": False}}}
    data_dir = str(tmp_path / "data")
    write_in_tree(data_dir, episodes=(1, 2, 197), container="npz", fps=25,
                  size=(60, 40), sample_rate=800)
    out = []
    for cls, config, load in ((JaxPigData, JaxConfig, jax_load_stats),
                              (PigData, Config, load_stats)):
        cfg = config.from_dict(raw)
        cfg.data.data_dir = data_dir
        random.seed(1)
        cls(cfg).prepare_data()
        stats = load(os.path.join(data_dir, "out", "stats.npz"))
        out.append((_contents(os.path.join(data_dir, "out", "32x24")),
                    stats))
        shutil.rmtree(os.path.join(data_dir, "out"))
    (want, want_stats), (got, got_stats) = out
    assert_same_contents(got, want)
    assert len(got) == 24
    for k in ("video_mean", "video_std", "audio_mean", "audio_std"):
        np.testing.assert_array_equal(getattr(got_stats, k),
                                      getattr(want_stats, k), k)
