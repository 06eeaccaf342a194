"""Minimal-pairs eval-set generation (`evaluation/eval_set_generation.py`,
`python -m peppa_tpu_torch.generate_eval_sets`) against the JAX package's:
the pair-search helpers on seeded token lists; `generate` end to end over
one realign tree, its CSVs byte for byte, with `mimic_reference_order` on
and off, without shipped annotation CSVs and with them (written where the
output goes, so both packages keep them under `reference_originals/`);
and the CLI against the root generate_targeted_triplets_eval_sets.py.

The tree: tests/test_eval_set_generation.py's sentences, or sentences of
a small template grammar (subject, verb, adjective, noun) with word
spans of 0.4 s, over narration val episodes.
"""

import io
import os
import shutil
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest

import peppa_tpu.evaluation.eval_set_generation as JG
import peppa_tpu_torch.evaluation.eval_set_generation as G
from peppa_tpu_torch import generate_eval_sets
from test_eval_set_generation import make_realign
from torch_port_prep_data import sentence, tree_bytes

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
POS = ["ADJ", "VERB", "NOUN"]


def _masked_lists(rng, n):
    vocab = ["a", "b", "c", "d", "e", G.TOKEN_MASK]
    out = []
    for _ in range(n):
        s1 = list(rng.choice(vocab[:5], size=int(rng.integers(1, 9))))
        s1.insert(int(rng.integers(len(s1) + 1)), G.TOKEN_MASK)
        s2 = list(rng.choice(vocab, size=int(rng.integers(1, 9))))
        out.append((s1, s2))
    return out


def test_pair_search_helpers_equal_jax():
    rng = np.random.default_rng(0)
    for s1, s2 in _masked_lists(rng, 300):
        got = G.longest_intersection(s1, s2)
        assert got == JG.longest_intersection(s1, s2)
        if got:
            assert (G.get_start_and_end_of_sublist(s1, got)
                    == JG.get_start_and_end_of_sublist(s1, got))
    for text in ("Peppa jumps!  ", "big - muddy puddles.", "George's [x] ok"):
        assert G.clean_transcript(text) == JG.clean_transcript(text)
    for word in ("Granddad", "puddle,", "mommy", "It's"):
        assert G.clean_lemma(word) == JG.clean_lemma(word)
    tokens = [w for _ in range(20) for w in sentence(rng).split()]
    assert G.fallback_tagger(tokens) == JG.fallback_tagger(tokens)
    words = [{"case": "success", "start": 0.5 * i, "end": 0.5 * i + 0.4}
             for i in range(5)]
    example = {"tokenized": list("abcde"), "words": words,
               "clipStart": 10.0, "transcript": "a b c d e"}
    for start, end in ((0, 4), (1, 2), (3, 3)):
        assert (G.crop_and_create_example(example, start, end, "x", "y")
                == JG.crop_and_create_example(example, start, end, "x",
                                              "y"))
        for duration in (0.3, 1.0):
            assert (G._span_ok(words, start, end, duration)
                    == JG._span_ok(words, start, end, duration))


def _grammar_tree(root, episodes=range(1, 9), per_episode=6, seed=3):
    rng = np.random.default_rng(seed)
    for ep in episodes:
        for i in range(per_episode):
            make_realign(root, "narration", ep, i // 3, i % 3,
                         sentence(rng).split())
    # a dialog episode and a narration test episode: not in the val split
    make_realign(root, "dialog", 197, 0, 0, sentence(rng).split())
    make_realign(root, "narration", 105, 0, 0, sentence(rng).split())


def _test_tree(root):
    """tests/test_eval_set_generation.py::test_generate_end_to_end's."""
    for ep in range(1, 9):
        make_realign(root, "narration", ep, 0, 0,
                     ["peppa", "jumps", "in", "muddy", "puddles"])
        make_realign(root, "narration", ep, 0, 1,
                     ["george", "runs", "in", "muddy", "puddles"])
        make_realign(root, "narration", ep, 1, 0,
                     ["peppa", "loves", "the", "big", "ball"])
        make_realign(root, "narration", ep, 1, 1,
                     ["george", "loves", "the", "little", "ball"])


TREES = {"grammar": (_grammar_tree, 2), "test": (_test_tree, 4)}


def _generate_both(realign, out, **kw):
    """Each package's `generate` over one realign tree, into its own eval
    dir; returns the two dirs' files as {name: bytes}."""
    dirs = []
    for name, module in (("jax", JG), ("port", G)):
        eval_dir = os.path.join(out, f"eval_{name}")
        module.generate(realign_dir=str(realign), eval_dir=eval_dir,
                        pos_tags=POS, **kw)
        dirs.append(tree_bytes(eval_dir))
    return dirs


@pytest.mark.parametrize("mimic", [True, False])
@pytest.mark.parametrize("tree", list(TREES))
def test_generate_equals_jax(tmp_path, tree, mimic):
    make, min_occurrences = TREES[tree]
    realign = tmp_path / "data" / "out" / "realign"
    make(realign)
    want, got = _generate_both(realign, str(tmp_path),
                               min_occurrences=min_occurrences,
                               mimic_reference_order=mimic)
    assert got == want
    assert sorted(got) == [f"eval_set_narration_{p}.csv" for p in
                           ("ADJ", "NOUN", "VERB")]
    sets = {p: pd.read_csv(tmp_path / "eval_port"
                           / f"eval_set_narration_{p}.csv") for p in POS}
    if tree == "grammar":  # pairs of every tag
        assert all(len(s) > 0 and len(s) % 2 == 0 for s in sets.values())
    for s in sets.values():
        for _, row in s.iterrows():
            ce = s[s["id"] == row["id_counterexample"]].iloc[0]
            assert row["target_word"] == ce["distractor_word"]
            assert row["clipStart"] < row["clipEnd"]


def _shipped(csv_text: str) -> str:
    """A stand-in for the reference's shipped CSV: the pairs of a
    generated eval set in reverse order, their ids renumbered."""
    df = pd.read_csv(io.StringIO(csv_text))
    pairs = [df[df["id"] // 2 == k] for k in sorted(set(df["id"] // 2))]
    df = pd.concat(pairs[::-1], ignore_index=True)
    df["id"] = range(len(df))
    df["id_counterexample"] = [i + 1 if i % 2 == 0 else i - 1
                               for i in df["id"]]
    return df.to_csv(index=False)


def test_generate_with_shipped_annotations_equals_jax(tmp_path):
    """With shipped CSVs in the eval dir (the reference's layout), both
    packages snapshot them to `reference_originals/` before writing, read
    their tags and order from the snapshot, and write the same bytes; a
    second run reads the snapshot again."""
    realign = tmp_path / "data" / "out" / "realign"
    _grammar_tree(realign)
    plain, _ = _generate_both(realign, str(tmp_path), min_occurrences=2,
                              mimic_reference_order=False)
    shipped = {name: _shipped(text.decode()) for name, text in plain.items()}
    out = []
    for name, module in (("jax", JG), ("port", G)):
        eval_dir = tmp_path / f"shipped_{name}"
        eval_dir.mkdir()
        for csv_name, text in shipped.items():
            (eval_dir / csv_name).write_text(text)
        for _ in range(2):
            module.generate(realign_dir=str(realign), eval_dir=str(eval_dir),
                            annotations_dir=str(eval_dir), min_occurrences=2,
                            pos_tags=POS)
        out.append(tree_bytes(eval_dir))
    want, got = out
    assert got == want
    for csv_name, text in shipped.items():
        assert got[f"reference_originals/{csv_name}"] == text.encode()
        assert got[csv_name] != text.encode()
    assert G.default_annotations_dir(str(tmp_path / "x" / "out" / "realign")
                                     ) == str(tmp_path / "x" / "eval")


def test_cli_writes_what_the_root_script_writes(tmp_path):
    realign = tmp_path / "data" / "out" / "realign"
    _grammar_tree(realign)
    args = ["--min-occurrences", "2", "--min-phrase-duration", "0.5",
            "--realign-dir", str(realign)]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    subprocess.run([sys.executable, "generate_targeted_triplets_eval_sets.py",
                    *args, "--eval-dir", str(tmp_path / "root")], cwd=ROOT,
                   env=env, check=True, capture_output=True, timeout=300)
    generate_eval_sets.main([*args, "--eval-dir", str(tmp_path / "port")])
    want = tree_bytes(tmp_path / "root")
    assert tree_bytes(tmp_path / "port") == want and len(want) == 3
    shutil.rmtree(tmp_path / "port")
