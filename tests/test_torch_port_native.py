"""The port's packed cache and native loader against the JAX package's: the
pack format read and written across packages (versions 1 and 2), the
corrupt-pack rejections, the C++ loader's batches and `bucket_plan`, all
exact.  The native library is built here with g++ at first use.
"""

import os
import struct

import numpy as np
import pytest
import torch

from peppa_tpu.data import cache as jax_cache
from peppa_tpu.data.types import Clip as JaxClip
from peppa_tpu.native.loader import bucket_plan as jax_bucket_plan
from peppa_tpu_torch.data import cache
from peppa_tpu_torch.data.types import Clip
from peppa_tpu_torch.native import build as native_build
from peppa_tpu_torch.native.loader import (NativeBatchLoader, NativePack,
                                           bucket_plan)
from peppa_tpu_torch.utils.profiling import counters

FIELDS = ("video", "audio", "video_duration", "audio_duration",
          "video_frames", "audio_samples")


def make_clips(rng, n=7, h=24, w=32, cls=Clip, int16=False):
    clips = []
    for _ in range(n):
        t = int(rng.integers(3, 9))
        s = int(rng.integers(800, 2000))
        audio = (rng.integers(-32768, 32768, size=(s,)).astype(np.int16)
                 if int16 else rng.normal(size=(s,)).astype(np.float32))
        clips.append(cls(
            video=rng.uniform(size=(t, h, w, 3)).astype(np.float32),
            audio=audio, video_duration=t / 10.0, audio_duration=s / 800.0))
    return clips


def _quantised(clip):
    return (np.clip(clip.video, 0, 1) * 255).astype(np.uint8)


@pytest.mark.parametrize("int16", [False, True], ids=["v1", "v2"])
def test_packs_are_the_jax_packages_byte_for_byte(tmp_path, int16):
    """The same clips give the same file from either package, and each
    package's readers read the other's pack."""
    rng = np.random.default_rng(0)
    clips = make_clips(rng)
    port, ref = str(tmp_path / "port.pack"), str(tmp_path / "jax.pack")
    assert cache.write_pack(port, clips, audio_int16=int16) == len(clips)
    jax_cache.write_pack(ref, [JaxClip(**vars(c)) for c in clips],
                         audio_int16=int16)
    with open(port, "rb") as a, open(ref, "rb") as b:
        assert a.read() == b.read()
    assert sorted(os.listdir(tmp_path)) == ["jax.pack", "port.pack"]
    got, want = cache.PackReader(ref), jax_cache.PackReader(port)
    native = NativePack(ref)
    assert got.version == want.version == native.version == (2 if int16
                                                              else 1)
    assert len(got) == len(want) == len(native) == len(clips)
    np.testing.assert_array_equal(got.durations(), want.durations())
    np.testing.assert_array_equal(native.durations(), want.durations())
    for i, clip in enumerate(clips):
        g, w = got[i], want[i]
        np.testing.assert_array_equal(g.video, _quantised(clip))
        np.testing.assert_array_equal(g.video, w.video)
        assert g.audio.dtype == w.audio.dtype
        np.testing.assert_array_equal(g.audio, w.audio)
        assert got.meta(i) == want.meta(i) == native.meta(i)
        video, audio, vd, ad = native.item(i)
        np.testing.assert_array_equal(video, g.video)
        np.testing.assert_array_equal(audio, g.audio)
        assert (vd, ad) == (g.video_duration, g.audio_duration)
    native.close()


def test_pack_v2_int16_rounding(tmp_path):
    """int16 audio passes through; float audio lands on the 1/32768 grid,
    rounded, as the JAX package stores it."""
    rng = np.random.default_rng(1)
    i16 = rng.integers(-32768, 32768, size=(1500,)).astype(np.int16)
    f32 = np.concatenate([(rng.normal(size=(900,)) * 0.1),
                          [1.5, -1.5, 0.5 / 32768, -0.5 / 32768]]
                         ).astype(np.float32)
    clips = [Clip(video=np.zeros((2, 4, 4, 3), np.uint8), audio=a,
                  video_duration=0.2, audio_duration=0.3) for a in (i16, f32)]
    path = str(tmp_path / "v2.pack")
    cache.pack_from_dataset(clips, path, audio_int16=True)
    reader = cache.PackReader(path)
    np.testing.assert_array_equal(reader[0].audio, i16)
    want = np.clip(np.round(f32.astype(np.float64) * 32768.0), -32768,
                   32767).astype(np.int16)
    np.testing.assert_array_equal(reader[1].audio, want)


def test_failed_pack_write_leaves_nothing(tmp_path):
    def clips():
        yield Clip(video=np.zeros((2, 4, 4, 3), np.uint8),
                   audio=np.zeros(8, np.float32), video_duration=0.2,
                   audio_duration=0.01)
        raise KeyError("boom")

    with pytest.raises(KeyError):
        cache.write_pack(str(tmp_path / "x.pack"), clips())
    assert os.listdir(tmp_path) == []


def test_native_pack_rejects_corrupt_files(tmp_path):
    """Opening bounds-checks the whole pack: a truncated or corrupt file
    raises IOError, never a fault in a worker thread later (carried over
    from tests/test_native_loader.py)."""
    rng = np.random.default_rng(0)
    path = str(tmp_path / "ok.pack")
    cache.write_pack(path, make_clips(rng))
    with open(path, "rb") as f:
        blob = f.read()
    entry = struct.Struct("<QIIIIQQff")

    def variant(name, data):
        p = str(tmp_path / name)
        with open(p, "wb") as f:
            f.write(bytes(data))
        return p

    def with_entry(**fields):
        data = bytearray(blob)
        vals = list(entry.unpack_from(data, 16))
        for i, v in fields.items():
            vals[int(i[1:])] = v
        entry.pack_into(data, 16, *vals)
        return data

    bad = [variant("trunc", blob[:len(blob) // 2]),
           variant("overcount", struct.pack(
               "<IIQ", *struct.unpack_from("<II", blob), 10 ** 6)
               + blob[16:]),
           variant("offset", with_entry(f0=len(blob) + 4096)),
           variant("magic", b"XXXX" + blob[4:]),
           variant("version", blob[:4] + struct.pack("<I", 3) + blob[8:]),
           # dims whose uint64 product wraps to a small value
           variant("wrap", with_entry(f1=2 ** 31, f2=2 ** 31, f3=2, f4=1)),
           # audio length whose byte count wraps
           variant("awrap", with_entry(f6=2 ** 62)),
           variant("empty", b""),
           variant("header", blob[:12])]
    for p in bad:
        with pytest.raises(IOError):
            NativePack(p)
    with pytest.raises(IOError):
        NativePack(str(tmp_path / "missing.pack"))
    pack = NativePack(path)
    assert len(pack) == 7
    with pytest.raises(IndexError):
        pack.meta(7)
    pack.close()


def test_native_batch_loader_padding_and_order(tmp_path):
    rng = np.random.default_rng(2)
    clips = make_clips(rng, n=10)
    path = str(tmp_path / "test.pack")
    cache.write_pack(path, clips)
    pack = NativePack(path)
    pad_t, pad_s = 10, 2048
    plan = [([0, 3, 5], (pad_t, 24, 32, 3, pad_s)),
            ([1, 2], (pad_t, 24, 32, 3, pad_s)),
            ([9, 8, 7, 6], (pad_t, 24, 32, 3, pad_s)),
            ([4], (5, 24, 32, 3, 900))]  # cropped to a smaller pad
    before = counters()["NativeBatchLoader.served"]
    batches = list(NativeBatchLoader(pack, plan, n_threads=3, depth=2))
    assert counters()["NativeBatchLoader.served"] - before \
        == len(plan) == len(batches)
    for (idx_list, (pt, _, _, _, ps)), batch in zip(plan, batches):
        assert batch.video.shape == (len(idx_list), pt, 24, 32, 3)
        assert batch.video.dtype == torch.uint8
        assert batch.audio.shape == (len(idx_list), ps)
        assert batch.audio.dtype == torch.float32
        assert batch.video_frames.dtype == batch.audio_samples.dtype \
            == torch.int32
        assert not any(getattr(batch, f).is_pinned() for f in FIELDS)
        for row, i in enumerate(idx_list):
            clip = clips[i]
            t = min(clip.video.shape[0], pt)
            s = min(clip.audio.shape[0], ps)
            np.testing.assert_array_equal(batch.video[row, :t].numpy(),
                                          _quantised(clip)[:t])
            assert not batch.video[row, t:].any()
            np.testing.assert_array_equal(batch.audio[row, :s].numpy(),
                                          clip.audio[:s])
            assert not batch.audio[row, s:].any()
            assert batch.video_frames[row] == t
            assert batch.audio_samples[row] == s
            assert batch.video_duration[row].item() == np.float32(
                clip.video_duration)
    pack.close()


def test_native_loader_stress_many_batches(tmp_path):
    """Order and content under thread contention: 64 batches, 8 threads,
    a ring of 3, and a consumer that leaves early (carried over from
    tests/test_native_loader.py)."""
    rng = np.random.default_rng(3)
    clips = make_clips(rng, n=16, h=8, w=8, int16=True)
    path = str(tmp_path / "stress.pack")
    cache.write_pack(path, clips, audio_int16=True)
    pack = NativePack(path)
    r = np.random.default_rng(1)
    plan = [(r.choice(16, size=3, replace=False).tolist(), (10, 8, 8, 3, 2048))
            for _ in range(64)]
    n = 0
    for (idx_list, _), batch in zip(plan, NativeBatchLoader(
            pack, plan, n_threads=8, depth=3)):
        assert batch.audio.dtype == torch.int16
        for row, i in enumerate(idx_list):
            s = clips[i].audio.shape[0]
            np.testing.assert_array_equal(batch.audio[row, :s].numpy(),
                                          clips[i].audio)
            assert batch.audio_samples[row] == s
        n += 1
    assert n == 64
    early = iter(NativeBatchLoader(pack, plan, n_threads=8, depth=3))
    next(early)
    del early  # the workers stop and join
    pack.close()


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("drop_last", [True, False])
def test_bucket_plan_equals_jax(seed, drop_last):
    rng = np.random.default_rng(seed)
    durations = rng.uniform(0.2, 7.0, size=(57, 2)).astype(np.float32)
    for buckets, shuffle in (((2.3, 3.2, 4.0, 6.0), True), ((2.3,), False),
                             ((0.8, 2.0), True)):
        kw = dict(buckets=buckets, batch_size=4, target_hw=(32, 24),
                  sample_rate=800, shuffle=shuffle, seed=seed,
                  drop_last=drop_last)
        got = bucket_plan(durations, **kw)
        assert got == jax_bucket_plan(durations, **kw)
        assert got and all(p[1][1:4] == (24, 32, 3) for p in got)


def test_failed_build_raises(tmp_path, monkeypatch):
    """Without g++, or when it fails, the build raises: nothing falls back
    to the Python loader behind the caller's back."""
    monkeypatch.setattr(native_build, "library_path",
                        lambda target: str(tmp_path / "b" /
                                           "libpeppa_loader.so"))
    monkeypatch.setattr(native_build.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native_build.build()
    monkeypatch.setattr(native_build.shutil, "which",
                        lambda name: "/bin/false")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native_build.build()
    assert os.listdir(tmp_path / "b") == []
    monkeypatch.undo()
    path = native_build.build()
    assert path.endswith("libpeppa_loader.so") and os.path.exists(path)
    assert os.path.basename(os.path.dirname(path)).startswith("native-")
    assert os.path.dirname(os.path.dirname(path)) == native_build.BUILD_ROOT
