"""The port's data modules against the JAX package's, on the same seeded
inputs: the synthetic episode tree, time stamps, segmentation, decode, the
datasets and their item cache, statistics, the AVI audio reader and the
audio loaders.  Every comparison is exact (array equality), except where a
test says otherwise.

Small sizes: 32x24 frames, 800 Hz audio, a few episodes of 7 s clips.
"""

import glob
import json
import os
import random

import numpy as np
import pandas as pd
import pytest

from peppa_tpu.data import audio as jax_audio
from peppa_tpu.data import avi as jax_avi
from peppa_tpu.data import dataset as jax_dataset
from peppa_tpu.data import decode as jax_decode
from peppa_tpu.data import segment as jax_segment
from peppa_tpu.data.stats import compute_stats as jax_compute_stats
from peppa_tpu.data.synthetic import \
    make_synthetic_episode_tree as jax_make_tree
from peppa_tpu.data.types import RawSegment as JaxRawSegment
from peppa_tpu_torch.data import audio, avi, dataset, decode, segment
from peppa_tpu_torch.data.stats import compute_stats, load_stats, save_stats
from peppa_tpu_torch.data.synthetic import make_synthetic_episode_tree
from peppa_tpu_torch.data.types import RawSegment

TS = (32, 24)
SR = 800
EPISODES = {"dialog": (1, 2, 197, 198), "narration": (1, 2)}


def _tree(root, make, correlated=True):
    for fragment, episodes in EPISODES.items():
        make(str(root), target_size=TS, fragment_type=fragment,
             episodes=episodes, clips_per_episode=2, clip_seconds=7.0,
             sample_rate=SR, seed=3, correlated=correlated)
    return str(root)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """An episode tree written by the port (read by both packages)."""
    return _tree(tmp_path_factory.mktemp("data"), make_synthetic_episode_tree)


def _same_clip(got, want):
    assert got.video.dtype == want.video.dtype
    np.testing.assert_array_equal(got.video, want.video)
    assert got.audio.dtype == want.audio.dtype
    np.testing.assert_array_equal(got.audio, want.audio)
    assert got.video_duration == want.video_duration
    assert got.audio_duration == want.audio_duration
    assert got.filename == want.filename
    assert got.offset == want.offset


def _same_clips(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        _same_clip(g, w)


@pytest.mark.parametrize("correlated", [True, False])
def test_episode_tree_equals_jax(tmp_path, correlated):
    port = _tree(tmp_path / "port", make_synthetic_episode_tree, correlated)
    ref = _tree(tmp_path / "jax", jax_make_tree, correlated)
    files = sorted(os.path.relpath(p, port) for p in
                   glob.glob(os.path.join(port, "**", "*.*"), recursive=True))
    assert files == sorted(
        os.path.relpath(p, ref) for p in
        glob.glob(os.path.join(ref, "**", "*.*"), recursive=True))
    assert len(files) == 2 * 2 * sum(map(len, EPISODES.values()))
    for name in files:
        a, b = os.path.join(port, name), os.path.join(ref, name)
        if name.endswith(".json"):
            with open(a) as fa, open(b) as fb:
                assert json.load(fa) == json.load(fb), name
            continue
        with np.load(a) as za, np.load(b) as zb:
            assert sorted(za.files) == sorted(zb.files)
            for k in za.files:
                assert za[k].dtype == zb[k].dtype, (name, k)
                np.testing.assert_array_equal(za[k], zb[k], err_msg=name)


def _stamps():
    rng = np.random.default_rng(0)
    out = ["00:00:00.000", "00:00:07.000", "01:02:03", "0:0:1.1",
           "00:00:61", "24:00:00", "99:00:00.123456789",
           "00:00:01.123456789", " 00:00:01.5 ", "1:2:3"]
    for _ in range(200):  # the HH:MM:SS.fff of extraction and _ts
        s = rng.uniform(0, 7200)
        m, sec = divmod(s, 60.0)
        hh, mm = divmod(int(m), 60)
        out.append(f"{hh:02d}:{mm:02d}:{sec:06.3f}")
    for digits in range(1, 10):
        out.append("00:12:34." + "".join(
            str(d) for d in rng.integers(0, 10, size=digits)))
    return out


def test_total_seconds_equals_pandas_timedelta():
    for stamp in _stamps():
        assert segment.total_seconds(stamp) == \
            pd.Timedelta(stamp).total_seconds(), stamp


@pytest.mark.parametrize("stamp", ["12:34.567", "01:02", "01:02.5",
                                   "00:00:02.", "ab:cd:ef"])
def test_total_seconds_rejects_what_pandas_rejects(stamp):
    """pandas takes `H:MM:SS[.f]` only; the minutes-and-seconds form
    `MM:SS.fff` is refused by both."""
    with pytest.raises(ValueError):
        pd.Timedelta(stamp)
    with pytest.raises(ValueError):
        segment.total_seconds(stamp)


def _segments(segs):
    return [(s.path, s.video_start, s.video_end, s.audio_start, s.audio_end,
             s.offset, s.meta, s.duration, s.audio_duration) for s in segs]


@pytest.mark.parametrize("duration", [0.8, 2.0, 2.3, 3.2, 7.0, 9.0])
def test_segment_equals_jax(duration):
    got = list(segment.segment("x.npz", 7.0, duration=duration))
    want = list(jax_segment.segment("x.npz", 7.0, duration=duration))
    assert _segments(got) == _segments(want)
    assert all(isinstance(s, RawSegment) for s in got)


@pytest.mark.parametrize("sd", [None, 0.5, 3.0])
def test_segment_jitter_equals_jax(sd):
    """From the global `random` module, seeded alike before each side, and
    from a `random.Random` of its own."""
    random.seed(11)
    got = _segments(segment.segment("x.npz", 12.0, duration=2.3, jitter=True,
                                    jitter_sd=sd))
    random.seed(11)
    want = _segments(jax_segment.segment("x.npz", 12.0, duration=2.3,
                                         jitter=True, jitter_sd=sd))
    assert got == want and len(got) == 5
    got = _segments(segment.segment_jitter("x.npz", 12.0, 2.3, sd,
                                           random.Random(4)))
    want = _segments(jax_segment.segment_jitter("x.npz", 12.0, 2.3, sd,
                                                random.Random(4)))
    assert got == want


def test_lines_equal_jax(tree):
    paths = sorted(glob.glob(os.path.join(tree, "out", "32x24", "*", "*",
                                          "*.json")))
    assert paths
    for p in paths:
        with open(p) as f:
            meta = json.load(f)
        for clip_duration in (7.0, 4.5):  # 4.5: lines past the end
            got = list(segment.lines("c.npz", clip_duration, meta))
            want = list(jax_segment.lines("c.npz", clip_duration, meta))
            assert _segments(got) == _segments(want)
    # time stamps that leave a fraction in the difference: floored
    meta = {"subtitles": [{"begin": "00:00:01.700", "end": "00:00:03.650"},
                          {"begin": "00:00:03.650", "end": "00:00:06.100"},
                          {"begin": "00:01:00.000", "end": "00:01:02.000"}]}
    got = list(segment.lines("c.npz", 30.0, meta))
    assert _segments(got) == _segments(jax_segment.lines("c.npz", 30.0, meta))
    assert [(s.video_start, s.video_end) for s in got] == [(0.0, 1.0),
                                                           (1.0, 4.0)]
    assert list(segment.lines("c.npz", 3.0, {"subtitles": []})) == []


def test_decode_equals_jax(tree):
    path = sorted(glob.glob(os.path.join(tree, "out", "32x24", "dialog", "1",
                                         "*.npz")))[0]
    assert decode.media_duration(path) == jax_decode.media_duration(path)
    spans = [(0.0, 2.3, 0.0, 2.3), (1.26, 3.31, 0.74, 4.05),
             (6.95, 7.0, 6.9, 7.0), (2.04, 2.05, 3.3333, 3.3334)]
    for sr in (SR, 1000, 600):  # the file's rate, and resampled
        for vs, ve, as_, ae in spans:
            got = decode.decode_segment(
                RawSegment(path, vs, ve, as_, ae, offset=vs), sr)
            want = jax_decode.decode_segment(
                JaxRawSegment(path, vs, ve, as_, ae, offset=vs), sr)
            _same_clip(got, want)
            assert got.video.dtype == np.float32
    _same_clip(decode.load_clip_npz(path), jax_decode.load_clip_npz(path))
    with pytest.raises(RuntimeError, match="No audio decode backend"):
        decode.decode_audio(os.path.join(tree, "a.mp3"), 0.0, 1.0)


def test_avi_audio_equals_jax(tmp_path):
    """A two-stream AVI muxed by the port reads back the same audio through
    both packages (the decode path for `.avi` without ffmpeg), and the
    muxed bytes are the JAX package's."""
    pytest.importorskip("cv2")
    rng = np.random.default_rng(0)
    video = rng.integers(0, 256, size=(12, 24, 32, 3), dtype=np.uint8)
    wave = (0.3 * rng.standard_normal(1000)).astype(np.float32)
    path = str(tmp_path / "clip.avi")
    avi.write_clip_avi(path, video, wave, fps=10, rate=SR)
    with open(path, "rb") as f:
        blob = f.read()
    video_only = jax_avi.parse_avi(blob)
    assert len(video_only[1]) == 2
    got, got_sr = avi.read_avi_audio(path)
    want, want_sr = jax_avi.read_avi_audio(path)
    assert got_sr == want_sr == SR
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got, np.clip(wave, -1, 1), atol=1 / 32767)
    if not decode.have_ffmpeg():
        np.testing.assert_array_equal(
            decode.decode_audio(path, 0.2, 1.1, 1000),
            jax_decode.decode_audio(path, 0.2, 1.1, 1000))


def _iterable_kwargs(tree, **kw):
    return dict(dict(split=["train"], target_size=TS, fragment_type="dialog",
                     duration=2.3, audio_sample_rate=SR, data_dir=tree), **kw)


@pytest.mark.parametrize("kw", [
    dict(),
    dict(jitter=True, jitter_sd=0.5),
    dict(split=["val"], duration=None),
    dict(split=["val"], fragment_type="narration", duration=None),
    dict(split=["val", "test"], fragment_type="narration", duration=3.2,
         audio_sample_rate=1000),
], ids=["fixed", "jitter", "lines", "narration-lines", "resampled"])
def test_iterable_dataset_equals_jax(tree, kw):
    kw = _iterable_kwargs(tree, **kw)
    got = dataset.PeppaPigIterableDataset(**kw)
    want = jax_dataset.PeppaPigIterableDataset(**kw)
    assert got.config_id() == want.config_id()
    random.seed(5)  # the jitter's draws, from the global module
    got_clips = list(got)
    random.seed(5)
    _same_clips(got_clips, list(want))
    # a seeded dataset draws from its own generator
    got = dataset.PeppaPigIterableDataset(seed=2, **kw)
    want = jax_dataset.PeppaPigIterableDataset(seed=2, **kw)
    _same_clips(got, want)


def test_iterable_shards_equal_jax(tree):
    kw = _iterable_kwargs(tree)
    names = []
    for i in range(2):
        got = list(dataset.PeppaPigIterableDataset(**kw).shard(i, 2))
        want = list(jax_dataset.PeppaPigIterableDataset(**kw).shard(i, 2))
        _same_clips(got, want)
        names.extend(c.filename for c in got)
    assert sorted(names) == sorted(
        c.filename for c in dataset.PeppaPigIterableDataset(**kw))
    with pytest.raises(ValueError, match="list of strings"):
        dataset.PeppaPigIterableDataset(split="train")
    with pytest.raises(RuntimeError, match="No clips found"):
        list(dataset.PeppaPigIterableDataset(
            **_iterable_kwargs(tree, fragment_type="narration",
                               split=["train", "test"])))


@pytest.mark.parametrize("kw", [
    dict(), dict(duration=None), dict(jitter=True), dict(jitter=True,
                                                         jitter_sd=0.5),
    dict(split=["val", "test"], target_size=(180, 100), duration=3.2,
         audio_sample_rate=44100, fragment_type="narration")])
def test_config_id_equals_jax(kw):
    kw = dict(dict(split=["train"], target_size=TS, fragment_type="dialog",
                   duration=2.3, audio_sample_rate=SR), **kw)
    assert dataset.PeppaPigIterableDataset(**kw).config_id() == \
        jax_dataset.PeppaPigIterableDataset(**kw).config_id()


def test_compute_stats_equals_jax(tree, tmp_path):
    kw = _iterable_kwargs(tree)
    got = compute_stats(dataset.PeppaPigIterableDataset(**kw))
    want = jax_compute_stats(jax_dataset.PeppaPigIterableDataset(**kw))
    for k in ("video_mean", "video_std", "audio_mean", "audio_std"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k), k)
    path = str(tmp_path / "stats.npz")
    save_stats(path, got)
    back = load_stats(path)
    np.testing.assert_array_equal(back.video_std, got.video_std)
    assert back.audio_std == np.float32(got.audio_std)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_item_cache_read_across_packages(tmp_path, writer):
    """Either package builds the cache into the same `items-*` directory;
    the other reads it as its own build would be read.  The stored video is
    the decoded float32 quantised by numpy's float32 x 255 and floored, as
    the JAX package stores it."""
    root = _tree(tmp_path / "data", make_synthetic_episode_tree)
    kw = _iterable_kwargs(root, jitter=True, jitter_sd=0.5, seed=1)
    kw.pop("data_dir")
    build, read = ((dataset.PeppaPigDataset, jax_dataset.PeppaPigDataset)
                   if writer == "port" else
                   (jax_dataset.PeppaPigDataset, dataset.PeppaPigDataset))
    built = build(data_dir=root, **kw)
    other = read(data_dir=root, **kw)
    assert other.cache_dir == built.cache_dir and len(other) == len(built)
    assert os.path.basename(built.cache_dir) == "items-" + \
        dataset.PeppaPigIterableDataset(**kw).config_id()
    _same_clips((other[i] for i in range(len(other))),
                (built[i] for i in range(len(built))))
    decoded = list(dataset.PeppaPigIterableDataset(data_dir=root, **kw))
    for i, clip in enumerate(decoded):
        item = other[i]
        assert item.video.dtype == np.uint8 and item.index == i
        np.testing.assert_array_equal(
            item.video, (np.clip(clip.video, 0, 1) * 255).astype(np.uint8))
        np.testing.assert_array_equal(item.audio, clip.audio)
        assert item.video_duration == np.float32(clip.video_duration)
    # float video is floored, not rounded: just under a level stays below
    levels = np.arange(1, 256, dtype=np.float32) / 255
    clip = decoded[0]
    clip.video = np.broadcast_to(np.nextafter(levels, 0)[None, None, :, None],
                                 (1, 1, 255, 3))
    for pkg in (dataset, jax_dataset):
        pkg.PeppaPigDataset._save_item_in(str(tmp_path), 0, clip)
        with np.load(os.path.join(tmp_path, "0.npz")) as z:
            np.testing.assert_array_equal(
                z["video"][0, 0, :, 0], np.arange(255, dtype=np.uint8))
    loaded = dataset.PeppaPigDataset.load(built.cache_dir)
    _same_clips(loaded, (built[i] for i in range(len(built))))
    with pytest.raises(IndexError):
        loaded[len(loaded)]
    a = dataset.PeppaPigDataset(cache_dir=built.cache_dir,
                                scrambled_video=True, scramble_seed=0)
    b = jax_dataset.PeppaPigDataset(cache_dir=built.cache_dir,
                                    scrambled_video=True, scramble_seed=0)
    for i in range(3):
        got = a[i].video
        np.testing.assert_array_equal(got, b[i].video)
        assert (np.sort(got, axis=None)
                == np.sort(built[i].video, axis=None)).all()


# ------------------------- the failure cases of the cache build (carried
# over from tests/test_iterable_dataset.py)
def test_failed_cache_build_leaves_nothing(tree, monkeypatch, tmp_path):
    root = _tree(tmp_path / "data", make_synthetic_episode_tree)
    kw = _iterable_kwargs(root)
    src = dataset.PeppaPigIterableDataset(**kw)
    real_iter = dataset.PeppaPigIterableDataset.__iter__

    class Boom(Exception):
        pass

    def exploding(self):
        it = real_iter(self)
        yield next(it)  # one item lands in the temporary directory
        raise Boom()

    monkeypatch.setattr(dataset.PeppaPigIterableDataset, "__iter__",
                        exploding)
    with pytest.raises(Boom):
        dataset.PeppaPigDataset(**kw)
    monkeypatch.undo()
    assert not os.path.isdir(
        os.path.join(root, "out", f"items-{src.config_id()}"))
    assert glob.glob(os.path.join(root, "out", "items-*.building-*")) == []
    assert len(dataset.PeppaPigDataset(**kw)) == 12


def test_empty_source_raises_and_leftover_is_rebuilt(monkeypatch, tmp_path):
    root = _tree(tmp_path / "data", make_synthetic_episode_tree)
    kw = _iterable_kwargs(root)
    cache = os.path.join(root, "out", "items-" +
                         dataset.PeppaPigIterableDataset(**kw).config_id())
    monkeypatch.setattr(dataset.PeppaPigIterableDataset, "__iter__",
                        lambda self: iter(()))
    with pytest.raises(RuntimeError, match="produced no items"):
        dataset.PeppaPigDataset(**kw)
    monkeypatch.undo()
    assert not os.path.isdir(cache)
    assert glob.glob(os.path.join(root, "out", "items-*.building-*")) == []
    os.makedirs(cache)  # an items-* directory without items is rebuilt
    with open(os.path.join(cache, "settings.pkl"), "wb") as f:
        f.write(b"stale")
    assert len(dataset.PeppaPigDataset(**kw)) == 12
    with pytest.raises(RuntimeError, match="no source config"):
        dataset.PeppaPigDataset(cache_dir=str(tmp_path / "nothing"))


def test_concurrent_cache_builders_race_benignly(tmp_path):
    cache = str(tmp_path / "items-race")

    def build(tmp):
        np.savez(os.path.join(tmp, "0.npz"), x=np.zeros(1))
        os.makedirs(cache, exist_ok=True)  # another process publishes first
        np.savez(os.path.join(cache, "0.npz"), x=np.ones(1))
        np.savez(os.path.join(cache, "1.npz"), x=np.ones(1))

    dataset.atomic_cache_build(cache, build)
    assert sorted(os.listdir(cache)) == ["0.npz", "1.npz"]
    with np.load(os.path.join(cache, "0.npz")) as z:
        assert z["x"][0] == 1.0  # the winner's items
    assert glob.glob(cache + ".building-*") == []
    # a published cache is reused; force rebuilds it
    dataset.atomic_cache_build(cache, lambda tmp: pytest.fail("rebuilt"))
    dataset.atomic_cache_build(
        cache, lambda tmp: np.savez(os.path.join(tmp, "7.npz"),
                                    x=np.zeros(1)), force=True)
    assert os.listdir(cache) == ["7.npz"]


def test_import_reference_cache_equals_jax(tmp_path):
    torch = pytest.importorskip("torch")
    from types import SimpleNamespace

    ref_dir = tmp_path / "ref_items"
    ref_dir.mkdir()
    rng = np.random.default_rng(0)
    for i in range(3):
        clip = SimpleNamespace(
            video=torch.tensor(rng.uniform(size=(3, 4, 8, 6))
                               .astype(np.float32)),
            audio=torch.tensor(rng.normal(size=(1, 160)).astype(np.float32)),
            video_duration=0.4, audio_duration=0.4, filename="ep_1/0.avi")
        torch.save(clip, str(ref_dir / f"{i}.pt"))
    got = dataset.PeppaPigDataset.import_reference_cache(
        str(ref_dir), str(tmp_path / "port"))
    want = jax_dataset.PeppaPigDataset.import_reference_cache(
        str(ref_dir), str(tmp_path / "jax"))
    assert len(got) == 3
    _same_clips(got, want)
    assert got[1].video.shape == (4, 8, 6, 3)


def test_audio_loaders_equal_jax(tree):
    rng = np.random.default_rng(1)
    arrays = [rng.normal(size=(int(n),)).astype(np.float32)
              for n in rng.integers(100, 400, size=11)]
    arrays += arrays[:3]  # equal lengths for the grouped loaders
    pairs = [(audio.audioarray_loader(arrays, 4),
              jax_audio.audioarray_loader(arrays, 4)),
             (audio.grouped_audioarray_loader(arrays, 2),
              jax_audio.grouped_audioarray_loader(arrays, 2))]
    paths = sorted(glob.glob(os.path.join(tree, "out", "32x24", "dialog",
                                          "*", "*.npz")))[:3]
    pairs += [(audio.audiofile_loader(paths, 2, 1000),
               jax_audio.audiofile_loader(paths, 2, 1000)),
              (audio.grouped_audiofile_loader(paths, 2, SR),
               jax_audio.grouped_audiofile_loader(paths, 2, SR))]
    for got, want in pairs:
        got, want = list(got), list(want)
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    got = list(audio.videofile_loader(paths, 2, SR))
    want = list(jax_audio.videofile_loader(paths, 2, SR))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        for k in ("video", "audio", "video_duration", "audio_duration",
                  "video_frames", "audio_samples"):
            np.testing.assert_array_equal(getattr(g, k), getattr(w, k), k)
