"""Copied from ``tts_tpu/text/en_g2p.py`` (the port imports nothing of ``tts_tpu``);
unchanged apart from this line.

Self-contained English grapheme→phoneme fallback.

The reference G2P path shells out to the espeak/espeak-ng binary
(``TTS/tts/utils/text/phonemizers/espeak_wrapper.py:47-83``); when neither
binary is installed, phoneme-based models silently degraded to graphemes.
This module provides a pure-Python fallback so ``use_phonemes: true``
configs always produce IPA:

* an exceptions lexicon for common irregular words,
* an optional CMUdict (``TTS_CMUDICT`` env var or explicit path) consulted
  before the rules,
* a context-sensitive letter-to-sound rule engine in the style of the
  classic NRL translator (Elovitz et al., 1976, public domain): rules are
  ``(left-context, pattern, right-context) → ARPAbet`` with the usual
  context classes (``#`` vowels+, ``:`` consonants*, ``^`` one consonant,
  ``.`` voiced consonant, ``+`` front vowel, ``%`` common suffix),
* ARPAbet → IPA mapping compatible with the ``IPAPhonemes`` character set.

Quality is below a trained neural G2P or espeak but far above graphemes;
the selection logic warns once when it engages.
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Optional

# ---------------------------------------------------------------------------
# ARPAbet → IPA (espeak-compatible symbols, stress digits dropped)
# ---------------------------------------------------------------------------

ARPABET_TO_IPA: Dict[str, str] = {
    "AA": "ɑ", "AE": "æ", "AH": "ʌ", "AH0": "ə", "AO": "ɔ", "AW": "aʊ",
    "AY": "aɪ", "B": "b", "CH": "tʃ", "D": "d", "DH": "ð", "EH": "ɛ",
    "ER": "ɜ", "EY": "eɪ", "F": "f", "G": "ɡ", "HH": "h", "IH": "ɪ",
    "IY": "i", "JH": "dʒ", "K": "k", "L": "l", "M": "m", "N": "n",
    "NG": "ŋ", "OW": "oʊ", "OY": "ɔɪ", "P": "p", "R": "ɹ", "S": "s",
    "SH": "ʃ", "T": "t", "TH": "θ", "UH": "ʊ", "UW": "u", "V": "v",
    "W": "w", "Y": "j", "Z": "z", "ZH": "ʒ",
}


def arpabet_to_ipa(phones: List[str]) -> str:
    out = []
    for p in phones:
        stress = ""
        base = p
        if p and p[-1].isdigit():
            base = p[:-1]
            if p[-1] == "1":
                stress = "ˈ"
            elif p[-1] == "2":
                stress = "ˌ"
            if p[-1] == "0" and base == "AH":
                out.append("ə")
                continue
        out.append(stress + ARPABET_TO_IPA.get(base, ""))
    return "".join(out)


# ---------------------------------------------------------------------------
# Exceptions lexicon — common irregular words (ARPAbet, stress marked)
# ---------------------------------------------------------------------------

EXCEPTIONS: Dict[str, str] = {
    "a": "AH0", "an": "AE1 N", "the": "DH AH0", "of": "AH1 V", "to": "T UW1",
    "and": "AH0 N D", "in": "IH1 N", "is": "IH1 Z", "was": "W AA1 Z",
    "he": "HH IY1", "she": "SH IY1", "we": "W IY1", "be": "B IY1",
    "are": "AA1 R", "were": "W ER1", "his": "HH IH1 Z", "has": "HH AE1 Z",
    "have": "HH AE1 V", "had": "HH AE1 D", "as": "AE1 Z", "at": "AE1 T",
    "they": "DH EY1", "their": "DH EH1 R", "there": "DH EH1 R",
    "these": "DH IY1 Z", "those": "DH OW1 Z", "this": "DH IH1 S",
    "that": "DH AE1 T", "them": "DH EH1 M", "then": "DH EH1 N",
    "than": "DH AE1 N", "though": "DH OW1", "through": "TH R UW1",
    "thought": "TH AO1 T", "you": "Y UW1", "your": "Y AO1 R",
    "one": "W AH1 N", "once": "W AH1 N S", "two": "T UW1",
    "who": "HH UW1", "whom": "HH UW1 M", "whose": "HH UW1 Z",
    "what": "W AH1 T", "where": "W EH1 R", "why": "W AY1",
    "do": "D UW1", "does": "D AH1 Z", "done": "D AH1 N",
    "don't": "D OW1 N T", "been": "B IH1 N", "said": "S EH1 D",
    "says": "S EH1 Z", "again": "AH0 G EH1 N", "against": "AH0 G EH1 N S T",
    "any": "EH1 N IY0", "many": "M EH1 N IY0", "some": "S AH1 M",
    "come": "K AH1 M", "comes": "K AH1 M Z", "give": "G IH1 V",
    "live": "L IH1 V", "love": "L AH1 V", "move": "M UW1 V",
    "lose": "L UW1 Z", "gone": "G AO1 N",
    "because": "B IH0 K AH1 Z", "eye": "AY1", "eyes": "AY1 Z",
    "only": "OW1 N L IY0", "other": "AH1 DH ER0", "mother": "M AH1 DH ER0",
    "father": "F AA1 DH ER0", "brother": "B R AH1 DH ER0",
    "very": "V EH1 R IY0", "every": "EH1 V ER0 IY0", "people": "P IY1 P AH0 L",
    "water": "W AO1 T ER0", "great": "G R EY1 T", "break": "B R EY1 K",
    "steak": "S T EY1 K", "heart": "HH AA1 R T", "earth": "ER1 TH",
    "early": "ER1 L IY0", "learn": "L ER1 N", "heard": "HH ER1 D",
    "word": "W ER1 D", "world": "W ER1 L D", "work": "W ER1 K",
    "from": "F R AH1 M", "front": "F R AH1 N T", "month": "M AH1 N TH",
    "money": "M AH1 N IY0", "honey": "HH AH1 N IY0", "among": "AH0 M AH1 NG",
    "enough": "IH0 N AH1 F", "young": "Y AH1 NG", "touch": "T AH1 CH",
    "tough": "T AH1 F", "rough": "R AH1 F", "laugh": "L AE1 F",
    "cough": "K AO1 F", "could": "K UH1 D", "would": "W UH1 D",
    "should": "SH UH1 D", "put": "P UH1 T", "push": "P UH1 SH",
    "pull": "P UH1 L", "full": "F UH1 L", "woman": "W UH1 M AH0 N",
    "women": "W IH1 M AH0 N", "busy": "B IH1 Z IY0", "business": "B IH1 Z N AH0 S",
    "friend": "F R EH1 N D", "pretty": "P R IH1 T IY0", "build": "B IH1 L D",
    "built": "B IH1 L T", "guide": "G AY1 D", "guy": "G AY1",
    "buy": "B AY1", "island": "AY1 L AH0 N D", "iron": "AY1 ER0 N",
    "answer": "AE1 N S ER0", "often": "AO1 F AH0 N", "listen": "L IH1 S AH0 N",
    "castle": "K AE1 S AH0 L", "half": "HH AE1 F", "calm": "K AA1 M",
    "talk": "T AO1 K", "walk": "W AO1 K", "folk": "F OW1 K",
    "yolk": "Y OW1 K", "salmon": "S AE1 M AH0 N", "sword": "S AO1 R D",
    "knee": "N IY1", "know": "N OW1", "knew": "N UW1",
    "knight": "N AY1 T", "wrong": "R AO1 NG", "write": "R AY1 T",
    "written": "R IH1 T AH0 N", "hour": "AW1 ER0", "honest": "AA1 N AH0 S T",
    "honor": "AA1 N ER0", "ghost": "G OW1 S T", "school": "S K UW1 L",
    "stomach": "S T AH1 M AH0 K", "ache": "EY1 K", "echo": "EH1 K OW0",
    "chorus": "K AO1 R AH0 S", "chemistry": "K EH1 M AH0 S T R IY0",
    "character": "K EH1 R AH0 K T ER0", "machine": "M AH0 SH IY1 N",
    "chef": "SH EH1 F", "onion": "AH1 N Y AH0 N", "ocean": "OW1 SH AH0 N",
    "sugar": "SH UH1 G ER0", "sure": "SH UH1 R", "truth": "T R UW1 TH",
    "beauty": "B Y UW1 T IY0", "beautiful": "B Y UW1 T AH0 F AH0 L",
    "europe": "Y UH1 R AH0 P", "use": "Y UW1 Z", "used": "Y UW1 Z D",
    "usual": "Y UW1 ZH AH0 W AH0 L", "measure": "M EH1 ZH ER0",
    "pleasure": "P L EH1 ZH ER0", "treasure": "T R EH1 ZH ER0",
    "vision": "V IH1 ZH AH0 N", "decision": "D IH0 S IH1 ZH AH0 N",
    "television": "T EH1 L AH0 V IH2 ZH AH0 N", "asia": "EY1 ZH AH0",
    "yes": "Y EH1 S", "quite": "K W AY1 T",
    "eight": "EY1 T", "weight": "W EY1 T", "height": "HH AY1 T",
    "either": "IY1 DH ER0", "neither": "N IY1 DH ER0",
    "leather": "L EH1 DH ER0", "weather": "W EH1 DH ER0",
    "feather": "F EH1 DH ER0", "breath": "B R EH1 TH",
    "breathe": "B R IY1 DH", "dead": "D EH1 D", "death": "D EH1 TH",
    "bread": "B R EH1 D", "head": "HH EH1 D", "read": "R IY1 D",
    "ready": "R EH1 D IY0", "heavy": "HH EH1 V IY0",
    "heaven": "HH EH1 V AH0 N", "instead": "IH0 N S T EH1 D",
    "sweat": "S W EH1 T", "threat": "TH R EH1 T", "meant": "M EH1 N T",
    "leant": "L EH1 N T", "blood": "B L AH1 D", "flood": "F L AH1 D",
    "door": "D AO1 R", "floor": "F L AO1 R", "poor": "P UH1 R",
    "shoe": "SH UW1", "shoes": "SH UW1 Z", "canoe": "K AH0 N UW1",
    "goes": "G OW1 Z", 
    "pint": "P AY1 N T", "minute": "M IH1 N AH0 T", "biscuit": "B IH1 S K AH0 T",
    "circuit": "S ER1 K AH0 T", "colonel": "K ER1 N AH0 L",
    "choir": "K W AY1 ER0", "one's": "W AH1 N Z", "anything": "EH1 N IY0 TH IH2 NG",
    "science": "S AY1 AH0 N S", "scissors": "S IH1 Z ER0 Z",
    "learning": "L ER1 N IH0 NG", "earn": "ER1 N", "yearn": "Y ER1 N",
    "search": "S ER1 CH", "research": "R IY1 S ER0 CH", "heary": "HH IH1 R IY0",
    "something": "S AH1 M TH IH0 NG", "nothing": "N AH1 TH IH0 NG",
}


# ---------------------------------------------------------------------------
# NRL-style rule engine
# ---------------------------------------------------------------------------
# Context classes:
#   '#'  one or more vowels            ':'  zero or more consonants
#   '^'  exactly one consonant         '.'  one voiced consonant (bdvgjlmnrwz)
#   '+'  one front vowel (e i y)       '%'  suffix (er e es ed ing ely)
#   ' '  word boundary
_CLASS_RE = {
    "#": r"[aeiouy]+",
    ":": r"[bcdfghjklmnpqrstvwxz]*",
    "^": r"[bcdfghjklmnpqrstvwxz]",
    ".": r"[bdvgjlmnrwz]",
    "+": r"[eiy]",
    "%": r"(?:er|ely|es|ed|ing|e)",
}


def _ctx_to_re(ctx: str, left: bool) -> re.Pattern:
    parts = []
    for c in ctx:
        if c == " ":  # word boundary: words are bare letter strings here
            parts.append("^" if left else "$")
        else:
            parts.append(_CLASS_RE.get(c, re.escape(c)))
    pat = "".join(parts)
    return re.compile(pat + "$") if left else re.compile("^" + pat)


class _Rule:
    __slots__ = ("pattern", "left", "right", "phones")

    def __init__(self, left: str, pattern: str, right: str, phones: str):
        self.pattern = pattern
        self.left = _ctx_to_re(left, True) if left else None
        self.right = _ctx_to_re(right, False) if right else None
        self.phones = phones.split() if phones else []

    def matches(self, word: str, i: int) -> bool:
        if not word.startswith(self.pattern, i):
            return False
        if self.left is not None and not self.left.search(word[:i]):
            return False
        if self.right is not None and not self.right.search(word[i + len(self.pattern):]):
            return False
        return True


# (left, pattern, right, ARPAbet) — checked in order within each bucket;
# first match wins and consumes len(pattern) letters.
_RAW_RULES = [
    # --- a ---
    ("", "ation", "", "EY1 SH AH0 N"),
    ("", "augh", "", "AO1"),
    ("", "aught", "", "AO1 T"),
    ("c", "ase", "", "EY1 S"),
    ("", "ai", "", "EY1"),
    ("", "ay", "", "EY1"),
    ("", "au", "", "AO1"),
    ("", "aw", "", "AO1"),
    ("", "ar", "#", "EH1 R"),
    (" ", "ar", " ", "AA1 R"),
    ("", "ar", "", "AA1 R"),
    ("", "al", "k", "AO1"),
    ("", "all", " ", "AO1 L"),
    ("", "able", " ", "AH0 B AH0 L"),
    ("", "ange", "", "EY1 N JH"),
    ("", "a", "^e ", "EY1"),
    ("", "a", "^i ", "EY1"),
    ("", "a", "^%", "EY1"),
    ("", "a", "^^", "AE1"),
    (" ", "a", " ", "AH0"),
    ("", "a", " ", "AH0"),
    ("", "a", "", "AE1"),
    # --- b ---
    ("", "bb", "", "B"),
    ("m", "b", " ", ""),  # dumb, lamb
    ("", "b", "", "B"),
    # --- c ---
    ("", "ch", "", "CH"),
    ("", "ck", "", "K"),
    ("", "cc", "+", "K S"),
    ("", "cc", "", "K"),
    ("", "cial", "", "SH AH0 L"),
    ("", "cious", "", "SH AH0 S"),
    ("", "ce", "ous", "SH"),
    ("", "c", "+", "S"),
    ("", "c", "", "K"),
    # --- d ---
    ("", "dd", "", "D"),
    ("", "dge", "", "JH"),
    ("#:", "ded", " ", "D IH0 D"),
    ("t", "ed", " ", "IH0 D"),
    ("d", "ed", " ", "IH0 D"),
    ("", "d", "", "D"),
    # --- e ---
    ("", "ealth", "", "EH1 L TH"),
    ("", "eau", "", "OW1"),
    ("", "ee", "", "IY1"),
    ("", "ea", "", "IY1"),
    ("", "ey", " ", "IY0"),
    ("", "ei", "", "IY1"),
    ("", "eigh", "", "EY1"),
    ("", "ew", "", "UW1"),
    ("", "er", " ", "ER0"),
    ("", "er", "", "ER1"),
    ("#:", "e", " ", ""),  # silent magic-e
    ("^", "e", " ", ""),  # silent final e after consonant
    (" ", "e", " ", "IY1"),
    ("", "e", " ", ""),
    ("", "e", "", "EH1"),
    # --- f ---
    ("", "ff", "", "F"),
    ("", "f", "", "F"),
    # --- g ---
    ("", "gg", "", "G"),
    ("", "gh", "t", ""),  # light, night
    (" ", "gh", "", "G"),
    ("", "gh", " ", ""),
    ("", "gn", " ", "N"),  # sign
    (" ", "gn", "", "N"),  # gnome
    ("", "giv", "", "G IH1 V"),
    ("", "g", "+", "JH"),
    ("", "g", "", "G"),
    # --- h ---
    (" ", "h", "#", "HH"),
    ("", "h", "", ""),
    # --- i ---
    ("", "ight", "", "AY1 T"),
    ("", "ign", " ", "AY1 N"),
    ("", "ind", " ", "AY1 N D"),
    ("", "ious", "", "IY0 AH0 S"),
    ("", "ier", "", "IY0 ER0"),
    ("", "ie", " ", "AY1"),
    ("", "ie", "", "IY1"),
    ("", "ing", " ", "IH0 NG"),
    ("", "ion", " ", "AH0 N"),
    ("", "i", "^e ", "AY1"),
    ("", "i", "^i ", "AY1"),
    (" ", "i", " ", "AY1"),
    ("", "i", "^^", "IH1"),
    ("", "i", "", "IH1"),
    # --- j ---
    ("", "j", "", "JH"),
    # --- k ---
    (" ", "kn", "", "N"),
    ("", "k", "", "K"),
    # --- l ---
    ("", "ll", "", "L"),
    ("", "le", " ", "AH0 L"),
    ("", "l", "", "L"),
    # --- m ---
    ("", "mm", "", "M"),
    ("", "m", "", "M"),
    # --- n ---
    ("", "nn", "", "N"),
    ("", "ng", "+", "N JH"),
    ("", "ng", "", "NG"),
    ("", "nk", "", "NG K"),
    ("", "n", "", "N"),
    # --- o ---
    ("", "ought", "", "AO1 T"),
    ("", "ough", " ", "OW1"),
    ("", "ormer", "", "AO1 R M ER0"),
    ("", "oo", "k", "UH1"),
    ("", "oo", "", "UW1"),
    ("", "oa", "", "OW1"),
    ("", "ow", " ", "OW1"),
    ("", "ow", "", "AW1"),
    ("", "ou", "s ", "AH0"),
    ("", "ou", "", "AW1"),
    ("", "oy", "", "OY1"),
    ("", "oi", "", "OY1"),
    ("", "or", " ", "AO1 R"),
    ("", "or", "", "AO1 R"),
    ("", "o", "^e ", "OW1"),
    ("", "o", "^%", "OW1"),
    ("", "o", " ", "OW1"),
    ("", "o", "", "AA1"),
    # --- p ---
    ("", "pp", "", "P"),
    ("", "ph", "", "F"),
    (" ", "ps", "", "S"),
    ("", "p", "", "P"),
    # --- q ---
    ("", "qu", "", "K W"),
    ("", "q", "", "K"),
    # --- r ---
    ("", "rr", "", "R"),
    ("", "r", "", "R"),
    # --- s ---
    ("", "ssion", "", "SH AH0 N"),
    ("", "ss", "", "S"),
    ("", "sion", "", "ZH AH0 N"),
    ("", "sh", "", "SH"),
    ("", "sch", "", "S K"),
    ("#", "s", " ", "Z"),
    (".", "s", " ", "Z"),
    (" ", "s", "", "S"),
    ("", "s", "", "S"),
    # --- t ---
    ("", "tion", "", "SH AH0 N"),
    ("", "tious", "", "SH AH0 S"),
    ("", "ture", "", "CH ER0"),
    ("", "tt", "", "T"),
    (" ", "th", "e ", "DH"),
    ("", "th", "", "TH"),
    ("", "t", "", "T"),
    # --- u ---
    ("", "ue", " ", "UW1"),
    ("", "ui", "", "UW1"),
    ("", "ur", "", "ER1"),
    ("", "u", "^e ", "UW1"),
    ("", "u", "^^", "AH1"),
    ("", "u", "", "AH1"),
    # --- v ---
    ("", "v", "", "V"),
    # --- w ---
    (" ", "wh", "o", "HH"),
    ("", "wh", "", "W"),
    (" ", "wr", "", "R"),
    ("", "w", "", "W"),
    # --- x ---
    (" ", "x", "", "Z"),
    ("", "x", "", "K S"),
    # --- y ---
    (" ", "y", "", "Y"),
    ("", "y", " ", "IY0"),
    ("", "y", "^e", "AY1"),
    ("", "y", "", "IH1"),
    # --- z ---
    ("", "zz", "", "Z"),
    ("", "z", "", "Z"),
]

_RULES: Dict[str, List[_Rule]] = {}
for left, pat, right, ph in _RAW_RULES:
    _RULES.setdefault(pat[0], []).append(_Rule(left, pat, right, ph))


def word_to_arpabet(word: str) -> List[str]:
    """One lowercase word → ARPAbet phones via exceptions then rules."""
    word = word.lower()
    if word in EXCEPTIONS:
        return EXCEPTIONS[word].split()
    phones: List[str] = []
    # pad with spaces so boundary contexts can match literally via \b
    i = 0
    while i < len(word):
        ch = word[i]
        matched = False
        for rule in _RULES.get(ch, ()):
            if rule.matches(word, i):
                phones.extend(rule.phones)
                i += len(rule.pattern)
                matched = True
                break
        if not matched:
            i += 1  # unknown character: skip
    return phones


class EnglishG2P:
    """Word-level English G2P: exceptions → CMUdict (optional) → rules."""

    def __init__(self, cmudict_path: Optional[str] = None):
        self.cmudict = None
        path = cmudict_path or os.environ.get("TTS_CMUDICT")
        if path and os.path.isfile(path):
            from .cmudict import CMUDict

            self.cmudict = CMUDict(path, keep_ambiguous=False)

    def word_phones(self, word: str) -> List[str]:
        w = word.lower()
        if w in EXCEPTIONS:
            return EXCEPTIONS[w].split()
        if self.cmudict is not None:
            hit = self.cmudict.lookup(w)
            if hit:
                return hit[0].split()
        return word_to_arpabet(w)

    def phonemize(self, text: str, separator: str = "") -> str:
        """Sentence → IPA; words separated by spaces, phones by
        ``separator`` inside each word (espeak-wrapper convention)."""
        words = re.findall(r"[a-zA-Z']+", text)
        out = []
        for w in words:
            phones = self.word_phones(w)
            if separator:
                # one separator between phone tokens; multi-char phones kept
                toks = [arpabet_to_ipa([p]) for p in phones]
                ipa = separator.join(t for t in toks if t)
            else:
                ipa = arpabet_to_ipa(phones)
            if ipa:
                first = ipa.find("ˈ")
                if first != -1:  # espeak marks one primary stress per word
                    ipa = ipa[: first + 1] + ipa[first + 1:].replace("ˈ", "")
                out.append(ipa)
        return " ".join(out)
