"""Copied from ``tts_tpu/text/japanese.py`` (the port imports nothing of ``tts_tpu``);
unchanged apart from this line and import paths.

Japanese text frontend (reference
``TTS/tts/utils/text/japanese/phonemizer.py`` — Julius segmentation-kit
phoneme set — and the XTTS ``cutlet`` romaji path, ``xtts/tokenizer.py:578``).

Original implementation: instead of the reference's 300-line lookup table,
the katakana→phoneme map is *generated* from the gojūon grid plus the
standard digraph/irregular rules, producing the same Julius phoneme set
(``a i u e o``, ``ky/sh/ch/ts/…`` onsets, ``N`` moraic nasal, ``q`` sokuon,
``:`` long vowel).  Kanji→kana conversion needs a morphological analyzer:
used when ``fugashi``/``MeCab`` is importable, otherwise kana/romaji input
is processed directly and kanji pass through with a warning.
"""

from __future__ import annotations

import re
import unicodedata
from typing import Dict, List

__all__ = ["japanese_text_to_phonemes", "japanese_to_romaji", "kata_to_phonemes"]

_VOWELS = {"ア": "a", "イ": "i", "ウ": "u", "エ": "e", "オ": "o"}

# consonant rows of the gojūon grid: row kana (a i u e o order) → onset
_ROWS = {
    "カキクケコ": "k", "ガギグゲゴ": "g",
    "サシスセソ": "s", "ザジズゼゾ": "z",
    "タチツテト": "t", "ダヂヅデド": "d",
    "ナニヌネノ": "n", "ハヒフヘホ": "h",
    "バビブベボ": "b", "パピプペポ": "p",
    "マミムメモ": "m", "ラリルレロ": "r",
}
# positional irregulars (kana → onset override)
_IRREGULAR = {
    "シ": "sh", "ジ": "j", "チ": "ch", "ヂ": "j", "ツ": "ts", "ヅ": "z", "フ": "f",
}
_YOON_VOWEL = {"ャ": "a", "ュ": "u", "ョ": "o"}
_SMALL_VOWEL = {"ァ": "a", "ィ": "i", "ゥ": "u", "ェ": "e", "ォ": "o"}


def _build_kana_map() -> Dict[str, List[str]]:
    m: Dict[str, List[str]] = {}
    for kana, v in _VOWELS.items():
        m[kana] = [v]
    for row, onset in _ROWS.items():
        for kana, v in zip(row, "aiueo"):
            # irregulars change the onset only; the grid vowel stays
            m[kana] = [_IRREGULAR.get(kana, onset), v]
    m.update({"ヤ": ["y", "a"], "ユ": ["y", "u"], "ヨ": ["y", "o"],
              "ワ": ["w", "a"], "ヲ": ["o"], "ン": ["N"]})
    # yōon digraphs: i-column kana + small ya/yu/yo
    palatal = {
        "キ": "ky", "ギ": "gy", "シ": "sh", "ジ": "j", "チ": "ch", "ヂ": "j",
        "ニ": "ny", "ヒ": "hy", "ビ": "by", "ピ": "py", "ミ": "my", "リ": "ry",
    }
    for kana, onset in palatal.items():
        for small, v in _YOON_VOWEL.items():
            m[kana + small] = [onset, v]
    # foreign-sound combos: kana + small vowel
    foreign = {
        "フ": "f", "ヴ": "v", "ウ": "w", "テ": "t", "デ": "d", "ト": "t", "ド": "d",
        "チ": "ch", "ジ": "j", "シ": "sh", "ツ": "ts",
    }
    for kana, onset in foreign.items():
        for small, v in _SMALL_VOWEL.items():
            m.setdefault(kana + small, [onset, v])
    m["ヴ"] = ["b", "u"]
    return m


_KANA_MAP = _build_kana_map()
_PUNCT = {"、": "pau", "。": "sil", "・": "pau", "？": "pau", "！": "pau"}


def kata_to_phonemes(text: str) -> List[str]:
    """Katakana string → Julius phoneme list."""
    out: List[str] = []
    i = 0
    while i < len(text):
        two = text[i : i + 2]
        ch = text[i]
        if len(two) == 2 and two in _KANA_MAP:
            out.extend(_KANA_MAP[two])
            i += 2
            continue
        if ch == "ッ":
            out.append("q")
        elif ch == "ー":
            if out and out[-1][-1] in "aiueo":
                out[-1] = out[-1] + ":"
        elif ch in _KANA_MAP:
            out.extend(_KANA_MAP[ch])
        elif ch in _PUNCT:
            out.append(_PUNCT[ch])
        elif not ch.isspace():
            out.append(ch)  # pass through unknown symbols (incl. kanji)
        i += 1
    return out


def _hira_to_kata(text: str) -> str:
    return "".join(
        chr(ord(c) + 0x60) if "ぁ" <= c <= "ゖ" else c for c in text
    )


_TAGGER = None
_WARNED_KANJI = False

# particle は/へ between a katakana-converted word and a non-hiragana
# continuation (or sentence end) reads wa/e
_PARTICLE_WA = re.compile(r"(?<=[ァ-ヶー])は(?=[^ぁ-ゖ]|$)|(?<=[ぁ-ゖ])は(?=[ァ-ヶ])")
_PARTICLE_E = re.compile(r"(?<=[ァ-ヶー])へ(?=[^ぁ-ゖ]|$)|(?<=[ぁ-ゖ])へ(?=[ァ-ヶ])")


def _warn_kanji_passthrough() -> None:
    """Emit one warning when some kanji remain untransliterated because no
    morphological analyzer (fugashi/MeCab) is importable and the bundled
    lexicon (``tts_tpu.text.ja_kanji``) has no entry — reference uses cutlet
    romaji here (``xtts/tokenizer.py:578``) and fails hard without MeCab."""
    global _WARNED_KANJI
    if not _WARNED_KANJI:
        import warnings

        warnings.warn(
            "Japanese input contains kanji outside the bundled lexicon and "
            "fugashi/MeCab is not installed; those kanji pass through "
            "untransliterated. Install fugashi (+unidic) for full coverage.",
            stacklevel=3,
        )
        _WARNED_KANJI = True


def _text_to_kata(text: str) -> str:
    """Kanji-bearing text → katakana via MeCab when available."""
    global _TAGGER
    if _TAGGER is None:
        try:
            import fugashi

            _TAGGER = fugashi.Tagger()
        except ImportError:
            try:
                import MeCab

                _TAGGER = MeCab.Tagger()
            except ImportError:
                _TAGGER = False
    if _TAGGER is False:
        from .ja_kanji import has_kanji, kanji_to_kata

        if has_kanji(text):
            # bundled lexicon: greedy longest match on the raw text (word
            # keys carry hiragana okurigana), warn only for residual kanji
            text, unmatched = kanji_to_kata(text)
            if unmatched:
                _warn_kanji_passthrough()
        # topic/direction particles read wa/e: after a converted (katakana)
        # word and not inside a hiragana run — a tagger-free approximation
        text = _PARTICLE_WA.sub("ワ", text)
        text = _PARTICLE_E.sub("エ", text)
        for greeting, kana in (("こんにちは", "コンニチワ"), ("こんばんは", "コンバンワ")):
            text = text.replace(greeting, kana)
        return _hira_to_kata(text)
    text = _hira_to_kata(text)
    if not re.search(r"[一-鿿]", text):
        return text
    try:  # fugashi word objects expose .feature.kana / MeCab parses to CSV
        words = []
        for w in _TAGGER(text):  # type: ignore[operator]
            kana = getattr(getattr(w, "feature", None), "kana", None) or w.surface
            words.append(_hira_to_kata(kana))
        return "".join(words)
    except TypeError:
        return text


def japanese_text_to_phonemes(text: str) -> str:
    """Reference-compatible entry: text → space-joined Julius phonemes."""
    text = unicodedata.normalize("NFKC", text)
    global _TAGGER
    _text_to_kata("")  # resolve tagger availability once
    from .numbers_multilingual import expand_numbers_ja, expand_numbers_ja_kana

    # kanji numerals need a tagger to read back; without one go via kana
    text = expand_numbers_ja(text) if _TAGGER else expand_numbers_ja_kana(text)
    kata = _text_to_kata(text)
    return " ".join(kata_to_phonemes(kata))


_PH_TO_ROMAJI = {"N": "n", "q": "", "pau": ", ", "sil": ". "}


def japanese_to_romaji(text: str) -> str:
    """XTTS preprocessing stand-in for ``cutlet.romaji``: phonemize, then
    join phonemes into Hepburn-ish romaji (sokuon doubles the onset)."""
    phonemes = japanese_text_to_phonemes(text).split(" ")
    out: List[str] = []
    for i, p in enumerate(phonemes):
        if p == "q":
            nxt = phonemes[i + 1] if i + 1 < len(phonemes) else ""
            out.append(nxt[:1])
        elif p in _PH_TO_ROMAJI:
            out.append(_PH_TO_ROMAJI[p])
        elif p.endswith(":"):
            base = p[:-1]
            out.append(base + (base[-1] if base and base[-1] in "aiueo" else ""))
        else:
            out.append(p)
    return "".join(out)
