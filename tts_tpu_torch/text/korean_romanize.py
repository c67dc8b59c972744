"""Copied from ``tts_tpu/text/korean_romanize.py`` (the port imports nothing of ``tts_tpu``);
unchanged apart from this line and import paths.

Hangul → Latin romanization (academic/scholarly system), the XTTS
Korean preprocessing step (reference ``xtts/tokenizer.py:584`` uses the
``hangul_romanize`` package's ``academic`` rule).

Pure-Python reimplementation: decompose each Hangul syllable (U+AC00
block arithmetic) into (initial, medial, final) jamo and map with the
academic transliteration tables.
"""

from __future__ import annotations

__all__ = ["korean_transliterate"]

# academic-system jamo transliterations
_INITIALS = (
    "g", "kk", "n", "d", "tt", "r", "m", "b", "pp",
    "s", "ss", "", "j", "jj", "ch", "k", "t", "p", "h",
)
_MEDIALS = (
    "a", "ae", "ya", "yae", "eo", "e", "yeo", "ye", "o", "wa",
    "wae", "oe", "yo", "u", "wo", "we", "wi", "yu", "eu", "ui", "i",
)
_FINALS = (
    "", "g", "kk", "gs", "n", "nj", "nh", "d", "l", "lg", "lm",
    "lb", "ls", "lt", "lp", "lh", "m", "b", "bs", "s", "ss",
    "ng", "j", "ch", "k", "t", "p", "h",
)

_BASE, _LAST = 0xAC00, 0xD7A3


def korean_transliterate(text: str) -> str:
    out = []
    for ch in text:
        code = ord(ch)
        if _BASE <= code <= _LAST:
            idx = code - _BASE
            initial = idx // (21 * 28)
            medial = (idx % (21 * 28)) // 28
            final = idx % 28
            out.append(_INITIALS[initial] + _MEDIALS[medial] + _FINALS[final])
        else:
            out.append(ch)
    return "".join(out)
