"""Copied from ``tts_tpu/text/cmudict.py`` (the port imports nothing of ``tts_tpu``);
unchanged apart from this line.

CMU Pronouncing Dictionary wrapper (reference
``TTS/tts/utils/text/cmudict.py:94``): loads keithito-format cmudict
files and swaps known words for ``{ARPABET}`` markup in cleaners."""

from __future__ import annotations

import re
from typing import Dict, List, Optional

__all__ = ["CMUDict", "VALID_SYMBOLS", "get_arpabet"]

VALID_SYMBOLS = [
    "AA", "AA0", "AA1", "AA2", "AE", "AE0", "AE1", "AE2", "AH", "AH0", "AH1",
    "AH2", "AO", "AO0", "AO1", "AO2", "AW", "AW0", "AW1", "AW2", "AY", "AY0",
    "AY1", "AY2", "B", "CH", "D", "DH", "EH", "EH0", "EH1", "EH2", "ER", "ER0",
    "ER1", "ER2", "EY", "EY0", "EY1", "EY2", "F", "G", "HH", "IH", "IH0",
    "IH1", "IH2", "IY", "IY0", "IY1", "IY2", "JH", "K", "L", "M", "N", "NG",
    "OW", "OW0", "OW1", "OW2", "OY", "OY0", "OY1", "OY2", "P", "R", "S", "SH",
    "T", "TH", "UH", "UH0", "UH1", "UH2", "UW", "UW0", "UW1", "UW2", "V", "W",
    "Y", "Z", "ZH",
]
_VALID = set(VALID_SYMBOLS)
_ALT_RE = re.compile(r"\([0-9]+\)")


class CMUDict:
    """word → list of ARPAbet pronunciations."""

    def __init__(self, file_or_path, keep_ambiguous: bool = True):
        if isinstance(file_or_path, str):
            with open(file_or_path, encoding="latin-1") as f:
                entries = _parse(f)
        else:
            entries = _parse(file_or_path)
        if not keep_ambiguous:
            entries = {w: p for w, p in entries.items() if len(p) == 1}
        self._entries = entries

    def __len__(self) -> int:
        return len(self._entries)

    def lookup(self, word: str) -> Optional[List[str]]:
        return self._entries.get(word.upper())


def _parse(file) -> Dict[str, List[str]]:
    entries: Dict[str, List[str]] = {}
    for line in file:
        if not line or line.startswith(";;;"):
            continue
        parts = line.split("  ")
        if len(parts) != 2 or not (line[0].isalpha() or line[0] == "'"):
            continue
        word = _ALT_RE.sub("", parts[0])
        pron = " ".join(parts[1].strip().split())
        if any(p not in _VALID for p in pron.split(" ")):
            continue
        entries.setdefault(word, []).append(pron)
    return entries


def get_arpabet(word: str, cmudict: CMUDict, punctuation_symbols: str = "!'(),.:;?") -> str:
    """Word → ``{ARPABET}`` markup when known (reference ``:114``),
    preserving leading/trailing punctuation."""
    first, last = "", ""
    while len(word) > 1 and word[0] in punctuation_symbols:
        first += word[0]
        word = word[1:]
    while len(word) > 1 and word[-1] in punctuation_symbols:
        last = word[-1] + last
        word = word[:-1]
    arpabet = cmudict.lookup(word)
    if arpabet is not None:
        return first + "{%s}" % arpabet[0] + last
    return first + word + last
