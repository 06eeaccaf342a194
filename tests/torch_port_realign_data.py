"""A small realign tree, as the reference's forced aligner leaves it, for the
analysis tests of the port: `{data_dir}/out/realign/{fragment}/ep_{N}/0/
{i}.{wav,json}`, 44.1 kHz mono 16-bit WAV utterances with gentle-style JSON
(transcript, word spans, ARPAbet `phones` with position tags, a speaker:
one of three on the dialog lines, "Narrator" on the narration ones).

Each utterance holds two words, of 0.25 s and 0.5 s in either order, so
that the word snippets come in two lengths and the utterances in one, and
the JAX package compiles few shapes.
"""

import json
import os
import wave

import numpy as np

SAMPLE_RATE = 44100
# word -> ARPAbet phones
LEXICON = {
    "peppa": ["P", "EH1", "P", "AH0"],
    "george": ["JH", "AO1", "R", "JH"],
    "muddy": ["M", "AH1", "D", "IY0"],
    "puddle": ["P", "AH1", "D", "AH0", "L"],
    "jump": ["JH", "AH1", "M", "P"],
    "daddy": ["D", "AE1", "D", "IY0"],
    "pig": ["P", "IH1", "G"],
    "big": ["B", "IH1", "G"],
    "house": ["HH", "AW1", "S"],
    "run": ["R", "AH1", "N"],
}
SPEAKERS = ("Peppa", "George", "Daddy")
EPISODES = {"dialog": (197, 198), "narration": (1, 2)}


def _phones(word):
    arpa = LEXICON[word]
    tags = ["B"] + ["I"] * (len(arpa) - 2) + ["E"] if len(arpa) > 1 else ["S"]
    return [{"phone": f"{p.lower()}_{t}", "duration": 0.05}
            for p, t in zip(arpa, tags)]


def write_realign_tree(data_dir, seed=0, per_episode=2, episodes=EPISODES):
    """Write the tree (`episodes`: fragment type -> episode numbers);
    returns the number of utterances."""
    rng = np.random.default_rng(seed)
    words = sorted(LEXICON)
    n = 0
    for fragment, numbers in episodes.items():
        for ep in numbers:
            base = os.path.join(data_dir, "out", "realign", fragment,
                                f"ep_{ep}", "0")
            os.makedirs(base, exist_ok=True)
            for i in range(per_episode):
                pair = [words[j] for j in rng.choice(len(words), 2,
                                                     replace=False)]
                spans = (0.25, 0.5) if rng.integers(2) else (0.5, 0.25)
                t, entries = 0.0, []
                for word, span in zip(pair, spans):
                    entries.append({"word": word, "alignedWord": word,
                                    "case": "success", "start": t,
                                    "end": t + span, "phones": _phones(word)})
                    t += span
                meta = {"transcript": " ".join(pair), "words": entries}
                meta["speaker"] = (SPEAKERS[int(rng.integers(3))]
                                   if fragment == "dialog" else "Narrator")
                stem = os.path.join(base, str(i))
                with open(stem + ".json", "w") as f:
                    json.dump(meta, f)
                samples = int(round(t * SAMPLE_RATE))
                tt = np.arange(samples) / SAMPLE_RATE
                audio = (0.3 * np.sin(2 * np.pi * rng.uniform(100, 400) * tt)
                         + 0.05 * rng.standard_normal(samples))
                with wave.open(stem + ".wav", "wb") as w:
                    w.setnchannels(1)
                    w.setsampwidth(2)
                    w.setframerate(SAMPLE_RATE)
                    w.writeframes((audio * 32767).astype("<i2").tobytes())
                n += 1
    return n
