"""ARPAbet -> IPA phoneme mapping for the phoneme-distance analysis.

The port's copy of peppa_tpu/preprocess/ipa.py: the 39-phoneme CMUdict
ARPAbet set with its IPA equivalents (reference pig/ipa.py).
"""

from __future__ import annotations

import logging
from typing import Optional

ARPA_TO_IPA = {
    # vowels
    "AA": "ɑ", "AE": "æ", "AH": "ʌ", "AO": "ɔ", "AW": "aʊ", "AY": "aɪ",
    "EH": "ɛ", "ER": "ɝ", "EY": "eɪ", "IH": "ɪ", "IY": "i", "OW": "oʊ",
    "OY": "ɔɪ", "UH": "ʊ", "UW": "u",
    # consonants
    "B": "b", "CH": "tʃ", "D": "d", "DH": "ð", "F": "f", "G": "ɡ",
    "HH": "h", "JH": "dʒ", "K": "k", "L": "l", "M": "m", "N": "n",
    "NG": "ŋ", "P": "p", "R": "ɹ", "S": "s", "SH": "ʃ", "T": "t",
    "TH": "θ", "V": "v", "W": "w", "Y": "j", "Z": "z", "ZH": "ʒ",
}


def arpa2ipa(arpa: str, default: Optional[str] = None) -> Optional[str]:
    """One ARPAbet phoneme (stress digits and gentle's position tags, as in
    'ah_I', stripped) in IPA; an unknown one logs a warning and gives
    `default`."""
    key = arpa.rstrip("012").upper()
    key = key.split("_")[0].upper()
    try:
        return ARPA_TO_IPA[key]
    except KeyError:
        logging.warning("Key not found: %s", arpa)
        return default


def phones_to_ipa(phones) -> str:
    """A gentle `phones` list (dicts with 'phone', or strings) as one IPA
    string; unknown phonemes are left out."""
    out = []
    for p in phones:
        name = p["phone"] if isinstance(p, dict) else str(p)
        ipa = arpa2ipa(name, default="")
        if ipa:
            out.append(ipa)
    return "".join(out)
