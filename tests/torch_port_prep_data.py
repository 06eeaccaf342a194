"""A raw episode tree in the reference's `data/in` layout, for the
corpus-preparation tests (extraction, realignment, eval-set generation).

`write_in_tree(data_dir, ...)` writes

- `in/peppa_pig_dataset-video_list.csv` (`id;'title';'mnt/ep_N.ext'`);
- `in/peppa/episodes/ep_{N}.json`: `id`, `title` and `narrator_splits`,
  each part with a `context` (dialog) and a `narration` fragment, each
  holding `subtitles` (`text`, `begin`, `end`; a `speaker` on dialog
  lines) and `tokenized` word spans;
- `in/peppa/ep_{N}.{wav,npz,avi}`: the episode's media (a 16-bit WAV of
  audio alone, an `.npz` clip, or an mpeg4 + PCM `.avi` through cv2).

The lines come from a small template grammar, so that the eval-set
generation finds NOUN, ADJ and VERB minimal pairs; their time stamps are
`H:MM:SS.fff`, or `H:MM:SS` where they fall on a whole second.
"""

import json
import os
import wave

import numpy as np

SUBJECTS = ("peppa", "george", "daddy", "mummy")
VERBS = ("jumps", "runs", "plays", "sings")
ADJECTIVES = ("muddy", "big", "little", "red")
NOUNS = ("puddles", "boots", "garden", "ball")
SPEAKERS = ("Peppa", "George", "Daddy Pig", "Mummy Pig")


def sentence(rng) -> str:
    pick = lambda words: words[int(rng.integers(len(words)))]  # noqa: E731
    return (f"{pick(SUBJECTS)} {pick(VERBS)} in the {pick(ADJECTIVES)} "
            f"{pick(NOUNS)}")


def stamp(t: float) -> str:
    """`H:MM:SS` on a whole second (of a whole number of milliseconds),
    else `H:MM:SS.fff`."""
    ms = int(round(t * 1000))
    h, rest = divmod(ms, 3600_000)
    m, rest = divmod(rest, 60_000)
    s, frac = divmod(rest, 1000)
    return f"{h}:{m:02d}:{s:02d}" + (f".{frac:03d}" if frac else "")


def _fragment(rng, t0: float, n_lines: int, speakers: bool,
              line_seconds=(1.5, 3.0)):
    subtitles, tokenized, t = [], [], t0
    for _ in range(n_lines):
        text = sentence(rng)
        length = round(float(rng.uniform(*line_seconds)), 1)
        sub = {"text": text, "begin": stamp(t), "end": stamp(t + length)}
        if speakers:
            sub["speaker"] = SPEAKERS[int(rng.integers(len(SPEAKERS)))]
        subtitles.append(sub)
        words = text.split()
        step = length / len(words)
        for k, w in enumerate(words):
            tokenized.append({"token": w, "begin": stamp(t + k * step),
                              "end": stamp(t + (k + 1) * step)})
        t += length + 0.5
    return {"subtitles": subtitles, "tokenized": tokenized}, t


def write_in_tree(data_dir, episodes=(1, 197), parts: int = 2,
                  lines: int = 2, seconds=None, fps: float = 10.0,
                  size=(40, 30), sample_rate: int = 16000,
                  container: str = "wav", seed: int = 0,
                  line_seconds=(1.5, 3.0)) -> dict:
    """The tree under `data_dir`; returns {episode id: media path}.  Each
    part holds `lines` dialog lines, then `lines` narration lines; the
    media last `seconds` (None: one second past the last line)."""
    rng = np.random.default_rng(seed)
    data_dir = str(data_dir)
    ep_dir = os.path.join(data_dir, "in", "peppa", "episodes")
    os.makedirs(ep_dir, exist_ok=True)
    media = {}
    listing = []
    for epid in episodes:
        title = f"Episode {epid}"
        path = os.path.join(data_dir, "in", "peppa", f"ep_{epid}.{container}")
        listing.append(f"{epid};'{title}';'mnt/ep_{epid}.{container}'\n")
        splits, t = [], 0.5
        for _ in range(parts):
            context, t = _fragment(rng, t, lines, True, line_seconds)
            narration, t = _fragment(rng, t, lines, False, line_seconds)
            splits.append({"context": context, "narration": narration})
        length = float(np.ceil(t)) + 1.0 if seconds is None else seconds
        if t > length:
            raise ValueError(f"episode {epid}: lines end at {t} s, past "
                             f"{length} s")
        with open(os.path.join(ep_dir, f"ep_{epid}.json"), "w") as f:
            json.dump({"id": epid, "title": title, "narrator_splits": splits},
                      f)
        n = int(length * sample_rate)
        tt = np.arange(n) / sample_rate
        audio = (0.3 * np.sin(2 * np.pi * rng.uniform(100, 400) * tt)
                 + 0.05 * rng.standard_normal(n)).astype(np.float32)
        if container == "wav":
            with wave.open(path, "wb") as w:
                w.setnchannels(1)
                w.setsampwidth(2)
                w.setframerate(sample_rate)
                w.writeframes((audio * 32767).astype("<i2").tobytes())
        else:
            w, h = size
            video = rng.integers(0, 256, (int(length * fps), h, w, 3),
                                 dtype=np.uint8)
            if container == "npz":
                from peppa_tpu_torch.data.decode import save_clip_npz

                save_clip_npz(path, video, audio, fps=fps,
                              sample_rate=sample_rate)
            else:
                from peppa_tpu_torch.data.avi import write_clip_avi

                write_clip_avi(path, video, audio, fps=fps, rate=sample_rate)
        media[epid] = path
    with open(os.path.join(data_dir, "in",
                           "peppa_pig_dataset-video_list.csv"), "w") as f:
        f.writelines(listing)
    return media


def tree_bytes(root) -> dict:
    """{relative path: bytes} of every file under `root`."""
    out = {}
    for r, _, files in os.walk(root):
        for name in files:
            p = os.path.join(r, name)
            with open(p, "rb") as f:
                out[os.path.relpath(p, root)] = f.read()
    return out
