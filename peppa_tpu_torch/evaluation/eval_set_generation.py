"""Minimal-pairs eval-set generation from the realigned transcripts.

The port's copy of peppa_tpu/evaluation/eval_set_generation.py (reference
generate_targeted_triplets_eval_sets.py): POS-tag and lemmatize the
realigned transcripts (spaCy when installed, else a tagger distilled from
the reference's shipped annotations, else the built-in lexicon tagger),
pick frequent same-POS word pairs (lemma_1, lemma_2), and for each sentence
holding lemma_1 find the counterexample holding lemma_2 whose masked token
sequence shares the longest phrase covering the mask; crop both to that
phrase and write `data/eval/eval_set_{fragment}_{pos}.csv` rows with
clipStart/clipEnd/target_word/distractor_word/id_counterexample
(`generate`).  The output depends on the order of the pairs and of the
sentences: with `mimic_reference_order` and the reference's shipped CSVs,
`apply_reference_order` recovers that order from them; a `generate` that
writes where the shipped CSVs are keeps them first under
`reference_originals/`.  pandas and spaCy are imported inside the
functions.
"""

from __future__ import annotations

import glob
import itertools
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
    or its `reference_originals/` snapshot when `generate` has kept one
    there (`preserve_reference_annotations`)."""
    d = os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(realign_dir))),
        "eval")
    preserved = os.path.join(d, "reference_originals")
    if glob.glob(os.path.join(preserved, "eval_set_*.csv")):
        return preserved
    return d


def preserve_reference_annotations(annotations_dir: str) -> str:
    """Snapshot the shipped eval_set_*.csv files before generate() overwrites
    them.

    generate()'s default output dir is the reference's own (data/eval — path
    parity with generate_targeted_triplets_eval_sets.py:405-441), which is
    ALSO where the shipped spaCy-annotated CSVs live that our tagger and
    apply_reference_order consume.  Writing there would destroy the
    authoritative artifacts and make every regeneration distill our own
    previous output.  This copies each CSV once into
    `{annotations_dir}/reference_originals/` (never overwritten afterwards)
    and returns that directory as the annotation source.
    """
    preserved = os.path.join(annotations_dir, "reference_originals")
    csvs = glob.glob(os.path.join(annotations_dir, "eval_set_*.csv"))
    if not csvs and not os.path.isdir(preserved):
        return annotations_dir  # nothing shipped, nothing to preserve
    os.makedirs(preserved, exist_ok=True)
    import shutil

    for p in csvs:
        dst = os.path.join(preserved, os.path.basename(p))
        if not os.path.exists(dst):
            shutil.copy2(p, dst)
    return preserved


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


# ------------------------------------------------------- pair-finding logic

def longest_intersection(tokens_1: List[str], tokens_2: List[str]
                         ) -> List[str]:
    """Longest common contiguous sublist whose span in tokens_1 covers the
    mask (reference :206-220, O(n^4) there; O(n*m) suffix DP here)."""
    mask_index = tokens_1.index(TOKEN_MASK)
    n, m = len(tokens_1), len(tokens_2)
    best_len, best_end = 0, -1
    prev = [0] * (m + 1)
    for i in range(1, n + 1):
        cur = [0] * (m + 1)
        for j in range(1, m + 1):
            if tokens_1[i - 1] == tokens_2[j - 1]:
                cur[j] = prev[j - 1] + 1
                start = i - cur[j]  # span [start, i-1] in tokens_1
                if cur[j] > best_len and start <= mask_index <= i - 1:
                    best_len, best_end = cur[j], i
        prev = cur
    if best_len == 0:
        return []
    return tokens_1[best_end - best_len:best_end]


def get_start_and_end_of_sublist(sentence: List[str], sublist: List[str]
                                 ) -> Tuple[int, int]:
    """First occurrence span (reference :223-234)."""
    for i in range(len(sentence) - len(sublist) + 1):
        if sentence[i:i + len(sublist)] == sublist:
            return i, i + len(sublist) - 1
    raise RuntimeError(f"Could not find {sublist} in {sentence}")


def _span_ok(words: List[Dict], start: int, end: int,
             min_phrase_duration: float) -> bool:
    first, last = words[start], words[end]
    return (first.get("case") == "success" and last.get("case") == "success"
            and "start" in first and "end" in last
            and last["end"] - first["start"] >= min_phrase_duration)


def crop_and_create_example(example: Dict, start: int, end: int,
                            target_word: str, distractor_word: str) -> Dict:
    """Parity: reference :237-254."""
    example = dict(example)
    example["tokenized"] = example["tokenized"][start:end + 1]
    example["words"] = example["words"][start:end + 1]
    example["start_token_idx"] = start
    example["end_token_idx"] = end
    example["clipOffset"] = example["clipStart"]
    example["clipStart"] = example["clipOffset"] + example["words"][0]["start"]
    example["clipEnd"] = example["clipOffset"] + example["words"][-1]["end"]
    assert example["clipStart"] < example["clipEnd"]
    example["target_word"] = target_word
    example["distractor_word"] = distractor_word
    return example


def _as_records(data) -> List[Dict]:
    """DataFrame (or record list) -> plain dicts with precomputed lemma sets.

    pandas iterrows materializes a Series per row per tuple — converting once
    and caching set(lemmatized) makes the pair search ~50x faster with
    identical results.
    """
    if isinstance(data, list):
        records = [dict(r) for r in data]
    else:
        records = data.to_dict("records")
    for i, r in enumerate(records):
        r["_row"] = r.get("_row", i)
        r["_lemmas"] = set(r["lemmatized"])
    return records


def find_minimal_pairs_for_tuple(pair: Tuple[str, str], data,
                                 min_phrase_duration: float = 0.3
                                 ) -> List[Dict]:
    """Parity: reference :257-352 (greedy longest-phrase matching)."""
    lemma_1, lemma_2 = pair
    records = _as_records(data)
    results: List[Dict] = []
    used_counterexamples: set = set()
    logging.info("Looking for: (%s, %s)", lemma_1, lemma_2)
    # candidate counterexamples and their masked forms, computed once
    cands = []
    for s2 in records:
        if lemma_2 not in s2["_lemmas"] or lemma_1 in s2["_lemmas"]:
            continue
        s2_masked = [w if lemma != lemma_2 else TOKEN_MASK
                     for w, lemma in zip(s2["tokenized"], s2["lemmatized"])]
        cands.append((s2, s2_masked, Counter(s2_masked)))
    for s1 in records:
        if lemma_1 not in s1["_lemmas"] or lemma_2 in s1["_lemmas"]:
            continue
        s1_masked = [w if lemma != lemma_1 else TOKEN_MASK
                     for w, lemma in zip(s1["tokenized"], s1["lemmatized"])]
        s1_counts = Counter(s1_masked)
        best = None
        best_len = 0
        for s2, s2_masked, s2_counts in cands:
            if s2["_row"] in used_counterexamples:
                continue
            # upper bound: a common substring can't be longer than the
            # MULTISET intersection of tokens (a plain set bound undercounts
            # repeated tokens, e.g. 'the ... the')
            if sum((s1_counts & s2_counts).values()) <= best_len:
                continue
            intersection = longest_intersection(s1_masked, s2_masked)
            if len(intersection) <= best_len:
                continue
            start, end = get_start_and_end_of_sublist(s1_masked, intersection)
            if not _span_ok(s1["words"], start, end, min_phrase_duration):
                continue
            ce_start, ce_end = get_start_and_end_of_sublist(s2_masked,
                                                            intersection)
            if not _span_ok(s2["words"], ce_start, ce_end,
                            min_phrase_duration):
                continue
            best_len = len(intersection)
            best = (crop_and_create_example(dict(s1), start, end,
                                            lemma_1, lemma_2),
                    crop_and_create_example(dict(s2), ce_start, ce_end,
                                            lemma_2, lemma_1),
                    s2["_row"])
        if best is not None:
            results.extend(best[:2])
            used_counterexamples.add(best[2])
    return results


def find_minimal_pairs(pairs, data, min_phrase_duration: float = 0.3):
    """Parity: reference :355-371."""
    import pandas as pd

    records = _as_records(data)
    results = [find_minimal_pairs_for_tuple(p, records, min_phrase_duration)
               for p in pairs]
    flat = []
    for rows in results:
        for r in rows:
            r = dict(r)
            r.pop("_lemmas", None)
            r.pop("_row", None)
            flat.append(r)
    eval_set = pd.DataFrame(flat)
    if len(eval_set) > 0:
        eval_set.reset_index(drop=True, inplace=True)
        eval_set["id"] = eval_set.index
        eval_set["id_counterexample"] = eval_set.id.apply(
            lambda x: x + 1 if x % 2 == 0 else x - 1)
        eval_set.set_index("id", inplace=True)
    return eval_set


# --------------------------------------- reference enumeration-order recovery

def _sentence_key(rec) -> Tuple:
    try:
        return (str(rec["transcript"]), int(rec["episode"]),
                int(rec["partIndex"]), int(rec["clipIndex"]))
    except (KeyError, TypeError, ValueError):
        return (str(rec.get("transcript", "")),)


def _masked(rec, lemma: str) -> List[str]:
    return [w if l != lemma else TOKEN_MASK
            for w, l in zip(rec["tokenized"], rec["lemmatized"])]


def _valid_intersection_len(s1_masked, s1_words, s2_masked, s2_words,
                            min_phrase_duration: float) -> int:
    """Length of the longest common mask-covering sublist if both spans pass
    the alignment/duration checks, else 0 (mirrors the candidate loop)."""
    intersection = longest_intersection(s1_masked, s2_masked)
    if not intersection:
        return 0
    start, end = get_start_and_end_of_sublist(s1_masked, intersection)
    if not _span_ok(s1_words, start, end, min_phrase_duration):
        return 0
    ce_start, ce_end = get_start_and_end_of_sublist(s2_masked, intersection)
    if not _span_ok(s2_words, ce_start, ce_end, min_phrase_duration):
        return 0
    return len(intersection)


def apply_reference_order(annotations_csv: str, pairs, data,
                          min_phrase_duration: float = 0.3):
    """Recover the reference run's enumeration order from its shipped CSV.

    The reference's output depends on two orderings its code never pins down
    (both fall out of ITS machine's os.walk order, reference :67-70):
    - the word-pair list: Counter insertion order -> combinations() order
      decides tuple sequence AND which word is target vs distractor;
    - the sentence iteration order: drives the greedy used-counterexample
      bookkeeping and first-wins tie-breaks (reference :262-352).

    Both are recoverable from the shipped artifact:
    - even-id rows are the `lemma_1` examples of each tuple in processing
      order, and within a tuple example rows appear in data order — ordered
      chains over example sentences;
    - each example's RECORDED counterexample c won a first-wins scan at some
      intersection length L, so every other then-unused candidate that (in
      our data) also achieves exactly L must come AFTER c in the reference's
      order — precedence edges over counterexample sentences.
    A topological sort merges all constraints into one global order (ties
    keep our deterministic order; contradictory constraints from residual
    tagging differences are dropped by breaking cycles at the smallest
    default rank).  Returns (ordered_pairs, reordered_data); on failure
    returns the inputs unchanged.
    """
    import heapq

    import pandas as pd

    try:
        df = pd.read_csv(annotations_csv).sort_values("id")
    except Exception:
        return pairs, data
    if not {"id", "target_word", "distractor_word"} <= set(df.columns):
        return pairs, data

    # ---- tuple order + direction
    seen: Dict[Tuple[str, str], int] = {}
    for _, r in df[df.id % 2 == 0].iterrows():
        t = (str(r.target_word), str(r.distractor_word))
        if t not in seen:
            seen[t] = int(r.id)
    ref_pairs = [t for t, _ in sorted(seen.items(), key=lambda kv: kv[1])]
    covered = {frozenset(t) for t in ref_pairs}
    ordered_pairs = ref_pairs + [p for p in pairs
                                 if frozenset(p) not in covered]

    records = _as_records(data)
    nodes = {_sentence_key(r) for r in records}
    by_key: Dict[Tuple, Dict] = {}
    for r in records:
        by_key.setdefault(_sentence_key(r), r)
    edges: Dict[Tuple, set] = {}

    def add_edge(a, b):
        if a != b and a in nodes and b in nodes:
            edges.setdefault(a, set()).add(b)

    # ---- example-order chains (even ids, per tuple, in id order)
    ev = df[df.id % 2 == 0]
    for _, grp in ev.groupby(["target_word", "distractor_word"], sort=False):
        chain = [k for k in (_sentence_key(r) for _, r in
                             grp.sort_values("id").iterrows()) if k in nodes]
        for a, b in zip(chain, chain[1:]):
            add_edge(a, b)

    # ---- counterexample precedence from recorded assignments
    rows_by_id = {int(r.id): r for _, r in df.iterrows()}
    for (lemma_1, lemma_2), grp in ev.groupby(
            ["target_word", "distractor_word"], sort=False):
        lemma_1, lemma_2 = str(lemma_1), str(lemma_2)
        cands = []
        for rec in records:
            if lemma_2 in rec["_lemmas"] and lemma_1 not in rec["_lemmas"]:
                cands.append((_sentence_key(rec), rec,
                              _masked(rec, lemma_2)))
        used: set = set()
        for _, e_row in grp.sort_values("id").iterrows():
            c_row = rows_by_id.get(int(e_row.id) + 1)
            if c_row is None:
                continue
            e_key, c_key = _sentence_key(e_row), _sentence_key(c_row)
            e_rec = by_key.get(e_key)
            c_entry = next((c for c in cands if c[0] == c_key), None)
            if e_rec is None or c_entry is None:
                continue
            s1_masked = _masked(e_rec, lemma_1)
            l_ref = _valid_intersection_len(
                s1_masked, e_rec["words"], c_entry[2], c_entry[1]["words"],
                min_phrase_duration)
            if l_ref:
                for key, rec, masked in cands:
                    if key in used or key == c_key:
                        continue
                    l_alt = _valid_intersection_len(
                        s1_masked, e_rec["words"], masked, rec["words"],
                        min_phrase_duration)
                    if l_alt == l_ref:  # equal-length loser: must come later
                        add_edge(c_key, key)
            used.add(c_key)

    # ---- topological merge, cycle-tolerant, ties by our default order
    default_pos: Dict[Tuple, int] = {}
    for i, r in enumerate(records):
        default_pos.setdefault(_sentence_key(r), i)
    indeg = Counter()
    for a, succ in edges.items():
        for b in succ:
            indeg[b] += 1
    heap = [(default_pos.get(k, len(records)), k)
            for k in nodes if indeg[k] == 0]
    heapq.heapify(heap)
    rank: Dict[Tuple, int] = {}
    pending = set(nodes)
    while pending:
        while heap:
            _, k = heapq.heappop(heap)
            if k in rank:
                continue
            rank[k] = len(rank)
            pending.discard(k)
            for b in edges.get(k, ()):
                indeg[b] -= 1
                if indeg[b] == 0 and b in pending:
                    heapq.heappush(heap, (default_pos.get(b, len(records)), b))
        if pending:  # cycle from contradictory constraints: break it
            k = min(pending, key=lambda k: default_pos.get(k, len(records)))
            rank[k] = len(rank)
            pending.discard(k)
            for b in edges.get(k, ()):
                indeg[b] -= 1
                if indeg[b] == 0 and b in pending:
                    heapq.heappush(heap, (default_pos.get(b, len(records)), b))
    order = sorted(range(len(records)),
                   key=lambda i: (rank.get(_sentence_key(records[i]),
                                           len(records)), i))
    return ordered_pairs, [records[i] for i in order]


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


def generate(realign_dir: str = "data/out/realign",
             eval_dir: str = "data/eval", min_occurrences: int = 10,
             min_phrase_duration: float = 0.3,
             fragments=FRAGMENTS, pos_tags=POS_TAGS,
             tagger: Optional[Callable] = None,
             annotations_dir: Optional[str] = None,
             mimic_reference_order: bool = True) -> None:
    """Full generation pass (reference :405-441).

    With `mimic_reference_order` (default) and the reference's shipped eval
    CSVs available, the word-pair and sentence enumeration orders are
    recovered from those artifacts (see apply_reference_order) so the run
    reproduces the shipped eval sets — the reference's own output depends on
    its machine's directory iteration order, which only its artifacts record.
    """
    os.makedirs(eval_dir, exist_ok=True)
    annotations_dir = annotations_dir or default_annotations_dir(realign_dir)
    if os.path.abspath(eval_dir) == os.path.abspath(annotations_dir):
        # the output dir IS the annotation source (the reference writes its
        # CSVs where it ships them): snapshot the originals first so this
        # run — and every regeneration after it — reads the authoritative
        # artifacts, not our own previous output
        annotations_dir = preserve_reference_annotations(annotations_dir)
    data_sentences, data_tokens = load_realigned_data(
        realign_dir, tagger, annotations_dir=annotations_dir)
    from peppa_tpu_torch.data.dataset import SPLIT_SPEC

    for pos_name in pos_tags:
        words = get_lemmatized_words(data_tokens, "val", fragments, pos_name)
        counter = Counter(words)
        words = [w for w, occ in counter.items()
                 if occ > min_occurrences and w not in WORDS_IGNORE[pos_name]]
        logging.info("Considered %s words: %s", pos_name, words)
        pairs = list(itertools.combinations(words, 2))
        for fragment in fragments:
            sub = data_sentences[data_sentences.fragment == fragment]
            sub = sub[sub.episode.isin(SPLIT_SPEC[fragment]["val"])]
            frag_pairs = pairs
            if mimic_reference_order:
                frag_pairs, sub = apply_reference_order(
                    os.path.join(annotations_dir,
                                 f"eval_set_{fragment}_{pos_name}.csv"),
                    pairs, sub)
            eval_set = find_minimal_pairs(frag_pairs, sub, min_phrase_duration)
            eval_set["fragment"] = fragment
            if len(eval_set):
                eval_set["clipDuration"] = (eval_set["clipEnd"]
                                            - eval_set["clipStart"])
                eval_set = eval_set.sort_values(by=["clipDuration"])
            eval_set.to_csv(os.path.join(
                eval_dir, f"eval_set_{fragment}_{pos_name}.csv"))
