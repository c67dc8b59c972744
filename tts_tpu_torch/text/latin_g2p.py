"""Copied from ``tts_tpu/text/latin_g2p.py`` (the port imports nothing of ``tts_tpu``);
unchanged apart from this line and the package named in this docstring.

Self-contained grapheme→phoneme fallback for
es/it/de/fr/pt/tr/pl/cs/hu/fi/nl/ro/ca.

The reference phonemizes these languages only through the espeak binary
(``TTS/tts/utils/text/phonemizers/espeak_wrapper.py:47-83``); without it,
their ``use_phonemes: true`` configs silently degrade to graphemes.
These orthographies are regular enough for a compact rule transducer:

* per-language ordered context rules ``(left, pattern, right) → IPA``
  (first match wins, consumes ``len(pattern)`` letters),
* orthographic accents carry an inline stress marker through the rules,
* a stress assigner places ``ˈ`` at the onset of the stressed syllable
  using each language's default rule (Spanish: penult if the word ends in
  a vowel/n/s else final; Italian: penult; German: first syllable, or the
  first root syllable after an unstressed verbal prefix),
* a small exceptions lexicon for words the rules cannot reach
  (Italian proparoxytones, German function words with irregular length).

Output is phonemic IPA restricted to the ``IPAPhonemes`` character set
(``tts_tpu_torch/text/characters.py``): no narrow diacritics, no syllable dots.
Quality is below espeak but far above graphemes; selection logic in
``tts_tpu_torch.text.phonemizers`` warns once when the fallback engages.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

# IPA vowel characters (a nucleus is a maximal run of these, incl. ``ː``)
_IPA_VOWELS = set("aeiouɛɔɪʊœøyʏəɐɑæʌɯɨɒɤ")
_GLIDES = set("jwɥ")
_LIQUIDS = set("lrɾʁʎ")
# two-symbol units the onset scanner must not split
_AFFRICATES = {"tʃ", "dʒ", "ts", "dz", "pf", "kv", "ks", "tɕ", "dʑ"}

_STRESS = "ˈ"


class _Rule:
    __slots__ = ("pattern", "left", "right", "out")

    def __init__(self, left: str, pattern: str, right: str, out: str):
        self.pattern = pattern
        self.left = re.compile("(?:" + left + ")$") if left else None
        self.right = re.compile("^(?:" + right + ")") if right else None
        self.out = out

    def matches(self, word: str, i: int) -> bool:
        if not word.startswith(self.pattern, i):
            return False
        if self.left is not None and not self.left.search(word[:i]):
            return False
        if self.right is not None and not self.right.search(word[i + len(self.pattern):]):
            return False
        return True


class RuleG2P:
    """Ordered-rule letter→IPA transducer with syllable-stress placement."""

    #: subclasses fill these in
    RULES: List[Tuple[str, str, str, str]] = []
    EXCEPTIONS: Dict[str, str] = {}
    #: orthographic vowel letters (for language-default stress decisions)
    VOWEL_LETTERS = "aeiou"
    #: absorb a preceding s/ʃ into the stressed onset (German s-clusters;
    #: Spanish/Italian syllabify /s/+C heterosyllabically: es.tán)
    ONSET_S_CLUSTERS = False
    #: languages without falling diphthongs (Hungarian, Czech): adjacent
    #: vowels are hiatus — each vowel symbol is its own syllable nucleus
    HIATUS = False

    def __init__(self):
        # bucket rules by first letter for O(1) candidate lookup
        self._buckets: Dict[str, List[_Rule]] = {}
        for left, pattern, right, out in self.RULES:
            self._buckets.setdefault(pattern[0], []).append(_Rule(left, pattern, right, out))

    # -- per-language hook -------------------------------------------------
    def default_stress_index(self, word: str, n_nuclei: int) -> int:
        """Index (0-based) of the stressed nucleus when no accent mark is
        present.  Default: penultimate."""
        return max(0, n_nuclei - 2)

    # -- core --------------------------------------------------------------
    def _transduce(self, word: str) -> str:
        out = []
        i = 0
        while i < len(word):
            for rule in self._buckets.get(word[i], ()):
                if rule.matches(word, i):
                    out.append(rule.out)
                    i += len(rule.pattern)
                    break
            else:
                out.append(word[i])  # unknown letter passes through
                i += 1
        return "".join(out)

    @classmethod
    def _nuclei(cls, phones: str) -> List[Tuple[int, int]]:
        """(start, end) spans of vowel nuclei.  A run of vowel symbols forms
        one nucleus (diphthong), except that a long mark ``ː`` closes the
        nucleus and ``ə`` always starts its own (German hiatus: ``eːə`` in
        *stehen* is two syllables, not one).  With ``HIATUS`` every vowel
        symbol is its own nucleus (+ its length mark)."""
        spans = []
        i = 0
        n = len(phones)
        while i < n:
            if phones[i] in _IPA_VOWELS:
                j = i
                while j < n and (phones[j] in _IPA_VOWELS or phones[j] == "ː"):
                    if j > i and phones[j] == "ə":
                        break
                    j += 1
                    if phones[j - 1] == "ː":
                        break
                    if cls.HIATUS:
                        if j < n and phones[j] == "ː":
                            j += 1
                        break
                spans.append((i, j))
                i = j
            else:
                i += 1
        return spans

    @classmethod
    def _onset_start(cls, phones: str, nucleus_start: int, prev_end: int) -> int:
        """Start index of the stressed syllable's onset: glides, then an
        optional liquid, then one obstruent (kept whole across affricates),
        then — where the language allows onset s-clusters — a sibilant."""
        k = nucleus_start
        while k > prev_end and phones[k - 1] in _GLIDES:
            k -= 1
        took_liquid = False
        if k > prev_end and phones[k - 1] in _LIQUIDS:
            k -= 1
            took_liquid = True
        prev = phones[k - 1] if k > prev_end else ""
        # the obstruent slot: never a liquid (a second liquid is a coda,
        # par.la.re) and, after a liquid, never a nasal either (en.la.ce)
        if (
            prev
            and prev not in _IPA_VOWELS
            and prev != "ː"
            and prev not in _LIQUIDS
            and not (took_liquid and prev in "mnɲŋ")
        ):
            k -= 1
            if k > prev_end and phones[k - 1 : k + 1] in _AFFRICATES:
                k -= 1
            if cls.ONSET_S_CLUSTERS and k > prev_end and phones[k - 1] in "sʃ":
                k -= 1
        return k

    def _place_stress(self, word: str, phones: str) -> str:
        marked = phones.find(_STRESS)
        if marked >= 0:
            phones = phones.replace(_STRESS, "")
        nuclei = self._nuclei(phones)
        if not nuclei:
            return phones
        if marked < 0 and len(nuclei) < 2:
            return phones  # unaccented monosyllables carry no stress mark
        if marked >= 0:
            # the inline marker sat immediately before its vowel; after
            # removal that vowel starts at ``marked``
            idx = next((n for n, (s, e) in enumerate(nuclei) if s <= marked < e), len(nuclei) - 1)
        else:
            idx = self.default_stress_index(word, len(nuclei))
        start, _ = nuclei[idx]
        if idx == 0:
            # initial stress marks the word onset whole (ˈʃpʁɛçən, ˈprʒiːtɛl)
            at = 0
        else:
            at = self._onset_start(phones, start, nuclei[idx - 1][1])
        return phones[:at] + _STRESS + phones[at:]

    def phonemize_word(self, word: str) -> str:
        word = word.lower()
        hit = self.EXCEPTIONS.get(word)
        if hit is not None:
            return hit
        return self._place_stress(word, self._transduce(word))

    def phonemize(self, text: str, separator: str = "") -> str:
        parts = []
        for token in text.split():
            # peel leading/trailing non-letter chars (digits, stray symbols)
            m = re.match(r"^(\W*)(.*?)(\W*)$", token, re.UNICODE)
            pre, core, post = m.groups()
            parts.append(pre + (self.phonemize_word(core) if core else "") + post)
        return " ".join(parts)


# ---------------------------------------------------------------------------
# Spanish (Castilian — distinción: c/z → θ, ll → ʎ)
# ---------------------------------------------------------------------------

_ES_V = "[aáeéiíoóuúü]"
_ES_STRONG = "[aáeéoó]"


class SpanishG2P(RuleG2P):
    VOWEL_LETTERS = "aáeéiíoóuú"

    RULES = [
        ("", "ch", "", "tʃ"),
        ("", "ll", "", "ʎ"),
        ("", "rr", "", "r"),
        ("^|[nls]", "r", "", "r"),  # trill word-initially / after n,l,s
        ("", "r", "", "ɾ"),
        ("", "qu", "[eéií]", "k"),
        ("", "gü", "", "ɡw"),
        ("", "gu", "[eéií]", "ɡ"),
        ("", "c", "[eéií]", "θ"),
        ("", "cc", "", "kθ"),
        ("", "c", "", "k"),
        ("", "z", "", "θ"),
        ("", "j", "", "x"),
        ("", "g", "[eéií]", "x"),
        ("", "g", "", "ɡ"),
        ("", "ñ", "", "ɲ"),
        ("", "v", "", "b"),
        ("", "h", "", ""),
        ("", "x", "", "ks"),
        ("", "y", "$", "i"),
        ("^", "y", "$", "i"),
        ("", "y", "", "ʝ"),
        ("", "w", "", "w"),
        # weak vowels as glides next to a following vowel
        ("", "i", _ES_STRONG + "|u|ú", "j"),
        ("", "u", _ES_STRONG + "|i|í", "w"),
        ("", "á", "", "ˈa"),
        ("", "é", "", "ˈe"),
        ("", "í", "", "ˈi"),
        ("", "ó", "", "ˈo"),
        ("", "ú", "", "ˈu"),
        ("", "ü", "", "w"),
    ] + [("", c, "", c) for c in "abdefiklmnopstu"]

    EXCEPTIONS = {
        "y": "i",
        "el": "el",
        "de": "de",
        "que": "ke",
        "la": "la",
        "los": "los",
        "las": "las",
        "un": "un",
        "una": "ˈuna",
        "mexico": "ˈmexiko",
        "méxico": "ˈmexiko",
    }

    def default_stress_index(self, word: str, n_nuclei: int) -> int:
        # ends in vowel, n or s → penult; otherwise final syllable
        if word and (word[-1] in "aeiou" or word[-1] in "ns"):
            return max(0, n_nuclei - 2)
        return n_nuclei - 1


# ---------------------------------------------------------------------------
# Italian
# ---------------------------------------------------------------------------

_IT_V = "[aàeèéiìoòóuù]"
_IT_BACK = "[aàoòuù]"
_IT_FRONT = "[eèéiì]"


class ItalianG2P(RuleG2P):
    VOWEL_LETTERS = "aàeèéiìoòóuù"

    RULES = [
        ("", "sci", _IT_V, "ʃ"),
        ("", "sc", _IT_FRONT, "ʃ"),
        ("", "cch", "", "kk"),
        ("", "ch", "", "k"),
        ("", "ggh", "", "ɡɡ"),
        ("", "gh", "", "ɡ"),
        ("", "gn", "", "ɲ"),
        ("", "gli", _IT_V, "ʎ"),
        ("", "gli", "", "ʎi"),
        ("", "cci", _IT_BACK, "ttʃ"),
        ("", "cc", _IT_FRONT, "ttʃ"),
        ("", "cc", "", "kk"),
        ("", "ci", _IT_BACK, "tʃ"),
        ("", "c", _IT_FRONT, "tʃ"),
        ("", "c", "", "k"),
        ("", "ggi", _IT_BACK, "ddʒ"),
        ("", "gg", _IT_FRONT, "ddʒ"),
        ("", "gg", "", "ɡɡ"),
        ("", "gi", _IT_BACK, "dʒ"),
        ("", "g", _IT_FRONT, "dʒ"),
        ("", "g", "", "ɡ"),
        ("", "qu", "", "kw"),
        ("", "h", "", ""),
        ("", "zz", "", "tts"),
        (_IT_V, "z", _IT_V, "tts"),  # intervocalic z geminates (grazie)
        ("", "z", "", "ts"),
        (_IT_V, "s", _IT_V, "z"),
        ("", "s", "[bdgvlmnr]", "z"),
        ("", "s", "", "s"),
        ("", "i", _IT_V, "j"),
        ("", "u", _IT_V, "w"),
        ("", "à", "", "ˈa"),
        ("", "è", "", "ˈɛ"),
        ("", "é", "", "ˈe"),
        ("", "ì", "", "ˈi"),
        ("", "ò", "", "ˈɔ"),
        ("", "ó", "", "ˈo"),
        ("", "ù", "", "ˈu"),
        ("", "j", "", "j"),
    ] + [("", c, "", c) for c in "abdefiklmnoprtuvw"]

    EXCEPTIONS = {
        # proparoxytones and irregular stress the penult rule cannot reach
        "tavolo": "ˈtavolo",
        "numero": "ˈnumeɾo".replace("ɾ", "r"),
        "musica": "ˈmuzika",
        "camera": "ˈkamera",
        "medico": "ˈmɛdiko",
        "essere": "ˈɛssere",
        "zero": "ˈdzɛro",
        "zona": "ˈdzɔna",
        "mezzo": "ˈmɛddzo",
        "e": "e",
        "il": "il",
        "di": "di",
        "la": "la",
        "un": "un",
        "che": "ke",
    }


# ---------------------------------------------------------------------------
# German
# ---------------------------------------------------------------------------

_DE_C = "[bcdfghjklmnpqrstvwxzß]"
# one consonant letter then a vowel (open-ish syllable → long vowel) is the
# default; two consonant letters → short.  The -lich suffix boundary does not
# close the stem syllable (mög-lich keeps øː); loanword -tion shortens.
_DE_SHORT = _DE_C + "(?!lich$)" + _DE_C + "|" + _DE_C + "?tion$"
_DE_VL = "[aeiouäöüy]"

# unstressed verbal/nominal prefixes: phonemized as-is, stress goes to the root
_DE_PREFIXES = [
    ("ver", "fɛɐ"),
    ("zer", "tsɛɐ"),
    ("ent", "ɛnt"),
    ("emp", "ɛmp"),
    ("er", "ɛɐ"),
    ("be", "bə"),
    ("ge", "ɡə"),
]


class GermanG2P(RuleG2P):
    VOWEL_LETTERS = "aeiouäöüy"

    RULES = [
        # orthographic gemination marks vowel shortness only — degeminate
        # (must precede the single-letter rules in each bucket)
        ("", "tt", "", "t"),
        ("", "nn", "", "n"),
        ("", "mm", "", "m"),
        ("", "ll", "", "l"),
        ("", "pp", "", "p"),
        ("", "ff", "", "f"),
        ("", "rr", "", "ʁ"),
        ("", "dd", "", "d"),
        ("", "bb", "", "b"),
        ("", "tsch", "", "tʃ"),
        ("", "sch", "", "ʃ"),
        ("", "chs", "", "ks"),
        ("(?:^|[eä])[aou]|(?:^|[^eä])[aou]u", "ch", "", "x"),  # placeholder; fixed below
        ("", "ck", "", "k"),
        ("", "dt", "", "t"),
        ("", "th", "", "t"),
        ("", "ph", "", "f"),
        ("", "pf", "", "pf"),
        ("", "qu", "", "kv"),
        ("", "tz", "", "ts"),
        ("", "tion", "$", "tsjˈoːn"),
        ("", "ität", "$", "itˈɛːt"),
        ("^", "sp", "", "ʃp"),
        ("^", "st", "", "ʃt"),
        ("", "ss", "", "s"),
        ("", "ß", "", "s"),
        # vowel digraphs / h-lengthening
        ("", "ie", "", "iː"),
        ("", "ei", "", "aɪ"),
        ("", "ai", "", "aɪ"),
        ("", "au", "", "aʊ"),
        ("", "eu", "", "ɔʏ"),
        ("", "äu", "", "ɔʏ"),
        ("", "aa", "", "aː"),
        ("", "ee", "", "eː"),
        ("", "oo", "", "oː"),
        ("", "ah", "", "aː"),
        ("", "eh", "", "eː"),
        ("", "ih", "", "iː"),
        ("", "oh", "", "oː"),
        ("", "uh", "", "uː"),
        ("", "äh", "", "ɛː"),
        ("", "öh", "", "øː"),
        ("", "üh", "", "yː"),
        # unstressed final syllables
        (_DE_VL + r"[a-zäöüß]*", "er", "$", "ɐ"),
        (_DE_VL + r"[a-zäöüß]*", "en", "$", "ən"),
        (_DE_VL + r"[a-zäöüß]*", "el", "$", "əl"),
        (_DE_VL + r"[a-zäöüß]*", "em", "$", "əm"),
        (_DE_VL + r"[a-zäöüß]*", "es", "$", "əs"),
        (_DE_VL + r"[a-zäöüß]*", "e", "$", "ə"),
        ("", "ig", "$", "ɪç"),
        # single vowels: short before a consonant cluster, else long
        ("", "a", _DE_SHORT, "a"),
        ("", "a", "", "aː"),
        ("", "e", _DE_SHORT, "ɛ"),
        ("", "e", "", "eː"),
        ("", "i", _DE_SHORT, "ɪ"),
        ("", "i", "", "iː"),
        ("", "o", _DE_SHORT, "ɔ"),
        ("", "o", "", "oː"),
        ("", "u", _DE_SHORT, "ʊ"),
        ("", "u", "", "uː"),
        ("", "ä", _DE_SHORT, "ɛ"),
        ("", "ä", "", "ɛː"),
        ("", "ö", _DE_SHORT, "œ"),
        ("", "ö", "", "øː"),
        ("", "ü", _DE_SHORT, "ʏ"),
        ("", "ü", "", "yː"),
        ("", "y", _DE_SHORT, "ʏ"),
        ("", "y", "", "yː"),
        # consonants
        # coda devoicing: word-final (incl. -bt/-bs) and before the
        # consonant-initial suffixes -lich/-bar/-chen
        ("", "b", "s?$|t|lich|bar$|chen$", "p"),
        ("", "d", "s?$|t|lich|bar$|chen$", "t"),
        ("", "g", "s?$|t|lich|bar$|chen$", "k"),
        ("", "w", "", "v"),
        ("", "v", "", "f"),
        ("", "z", "", "ts"),
        ("", "s", _DE_VL, "z"),
        ("", "s", "", "s"),
        ("", "ng", "", "ŋ"),
        ("", "nk", "", "ŋk"),
        ("", "j", "", "j"),
        ("ː", "r", _DE_C + "|$", "ɐ"),  # vocalized coda r after long vowel
        ("", "r", "", "ʁ"),
        ("", "g", "", "ɡ"),  # ASCII g → IPA ɡ (U+0261)
        ("", "x", "", "ks"),
        ("", "c", "", "k"),
    ] + [("", c, "", c) for c in "fhklmnpt"]

    EXCEPTIONS = {
        # function words whose vowel length the cluster rule gets wrong
        "das": "das",
        "es": "ɛs",
        "was": "vas",
        "man": "man",
        "an": "an",
        "am": "am",
        "ab": "ap",
        "in": "ɪn",
        "im": "ɪm",
        "mit": "mɪt",
        "um": "ʊm",
        "ob": "ɔp",
        "von": "fɔn",
        "vom": "fɔm",
        "zum": "tsʊm",
        "bis": "bɪs",
        "bin": "bɪn",
        "hat": "hat",
        "ein": "aɪn",
        "un": "ʊn",
        "der": "deːɐ",
        "er": "eːɐ",
        "wir": "viːɐ",
        "mir": "miːɐ",
        "dir": "diːɐ",
        "vor": "foːɐ",
        "nur": "nuːɐ",
        "für": "fyːɐ",
        "herr": "hɛʁ",
        "ist": "ɪst",
        "und": "ʊnt",
        "auch": "aʊx",
        # vowel length before "ch" is lexical (Buch long, doch short); the
        # cluster rule guesses short, so long-vowel words are listed
        "buch": "buːx",
        "hoch": "hoːx",
        "nach": "naːx",
        "sprache": "ˈʃpʁaːxə",
        "suchen": "ˈzuːxən",
        "mädchen": "ˈmɛːtçən",
        "universität": "univɛʁziˈtɛːt",
    }
    ONSET_S_CLUSTERS = True

    def __init__(self):
        # the ach-laut left-context is awkward as a table literal: x after
        # a/o/u/au but NOT after the front diphthongs eu/äu (where the
        # preceding letter is also "u")
        rules = [r for r in self.RULES if r[1] != "ch"]
        rules.insert(3, (r"(?:^|[^eä])[aou]", "ch", "", "x"))
        rules.insert(4, ("", "ch", "", "ç"))
        self.RULES = rules
        super().__init__()

    def default_stress_index(self, word: str, n_nuclei: int) -> int:
        return 0

    def phonemize_word(self, word: str) -> str:
        word = word.lower()
        hit = self.EXCEPTIONS.get(word)
        if hit is not None:
            return hit
        for prefix, prefix_ipa in _DE_PREFIXES:
            root = word[len(prefix):]
            if (
                word.startswith(prefix)
                and sum(c in self.VOWEL_LETTERS for c in root) >= 1
                and len(root) >= 3
            ):
                return prefix_ipa + self._place_stress(root, self._transduce(root))
        return self._place_stress(word, self._transduce(word))


# ---------------------------------------------------------------------------
# French
# ---------------------------------------------------------------------------

# vowel letters (nasalization blockers / glide contexts)
_FR_VL = "aàâeéèêëiîïoôuùûüyœ"
# nasal vowel context: the n/m nasalizes when followed by end-of-word or a
# consonant other than n/m/h (année, immense keep the oral vowel; the silent
# h in bonheur blocks nasalization: /bɔnœʁ/)
_FR_NAS = "$|[^" + _FR_VL + "nmh]"
_FR_C = "[bcçdfgjklmnpqrstvwxz]"  # h excluded: digraph second letters
#: nasal vowels use the standard combining tilde (U+0303, espeak-compatible);
#: configs whose vocabulary lacks it degrade to the oral vowel, still far
#: better than graphemes
_TILDE = "̃"


class FrenchG2P(RuleG2P):
    """French: nearly-deterministic in the reading direction — nasal vowel
    contexts, silent final consonants, and uniform final-syllable stress.
    Known fallback approximations: 3pl ``-ent`` verb endings read as nasal
    nouns, ``-ien-`` before a consonant reads /jɛ̃/ (``science``), no liaison
    across words."""

    VOWEL_LETTERS = _FR_VL

    RULES = [
        # --- a ---
        ("", "ain", _FR_NAS, "ɛ" + _TILDE),
        ("", "aim", _FR_NAS, "ɛ" + _TILDE),
        ("", "aill", "", "aj"),
        ("", "ail", "$", "aj"),
        ("", "an", _FR_NAS, "ɑ" + _TILDE),
        ("", "am", _FR_NAS, "ɑ" + _TILDE),
        ("", "au", "", "o"),
        ("", "ay", "[" + _FR_VL + "]", "ɛj"),
        ("", "aî", "", "ɛ"),
        ("", "ai", "", "ɛ"),
        ("", "à", "", "a"),
        ("", "â", "", "ɑ"),
        ("", "a", "", "a"),
        # --- e ---
        ("^", "ex", "[" + _FR_VL + "]", "ɛɡz"),
        ("", "eau", "", "o"),
        ("", "eill", "", "ɛj"),
        ("", "eil", "$", "ɛj"),
        ("", "euill", "", "œj"),
        ("", "euil", "$", "œj"),
        ("", "ein", _FR_NAS, "ɛ" + _TILDE),
        ("", "eim", _FR_NAS, "ɛ" + _TILDE),
        ("", "en", _FR_NAS, "ɑ" + _TILDE),
        ("", "em", _FR_NAS, "ɑ" + _TILDE),
        ("", "eu", "$", "ø"),
        # /œ/ before a coda r/l (fleur, seul); /ø/ in open syllables
        ("", "eu", "[rl](?:$|[^" + _FR_VL + "])", "œ"),
        ("", "eu", "", "ø"),
        (".*[" + _FR_VL + "].*", "er", "$", "e"),  # -er suffix; mer/cher via ɛ rule/exceptions
        ("", "ez", "$", "e"),
        ("", "et", "$", "ɛ"),
        # closed syllable: geminate or a true 2-consonant cluster (not C+l/r
        # onsets: secret /səkʁɛ/)
        ("", "e", "ll|rr|" + _FR_C + "[bcçdfgjkmnpqstvwxz]", "ɛ"),
        ("", "e", _FR_C + "$", "ɛ"),
        ("", "e", "$", ""),  # silent final e
        ("", "e", "", "ə"),
        ("", "é", "", "e"),
        ("", "è", "", "ɛ"),
        ("", "ê", "", "ɛ"),
        ("", "ë", "", "ɛ"),
        # --- i ---
        ("", "ill", "", "ij"),  # fille; ville/mille are exceptions
        ("", "ien", _FR_NAS, "jɛ" + _TILDE),
        ("", "in", _FR_NAS, "ɛ" + _TILDE),
        ("", "im", _FR_NAS, "ɛ" + _TILDE),
        # glide only before a *pronounced* vowel — not a silent final e (vie)
        ("", "i", "[aàâéèêëoôuùûüyœ]|e.", "j"),
        ("", "î", "", "i"),
        ("", "ï", "", "i"),
        ("", "i", "", "i"),
        # --- o ---
        ("", "oin", _FR_NAS, "wɛ" + _TILDE),
        ("", "on", _FR_NAS, "ɔ" + _TILDE),
        ("", "om", _FR_NAS, "ɔ" + _TILDE),
        ("", "où", "", "u"),
        ("", "oû", "", "u"),
        ("", "ou", "[aàâéèêëiîïy]|e.", "w"),
        ("", "ou", "", "u"),
        ("", "oy", "[" + _FR_VL + "]", "waj"),
        ("", "oî", "", "wa"),
        ("", "oi", "", "wa"),
        ("", "ô", "", "o"),
        ("", "o", "$", "o"),
        ("", "o", "[sz][" + _FR_VL + "]", "o"),  # chose, rose
        ("", "o", "", "ɔ"),
        # --- u ---
        ("", "un", _FR_NAS, "œ" + _TILDE),
        ("", "um", _FR_NAS, "œ" + _TILDE),
        ("", "ue", "$", "y"),  # rue (u-glide otherwise: actuel)
        ("", "u", "[aàâeéèêëiîïoôyœ]", "ɥ"),
        ("", "ù", "", "y"),
        ("", "û", "", "y"),
        ("", "ü", "", "y"),
        ("", "u", "", "y"),
        # --- y ---
        ("", "yn", _FR_NAS, "ɛ" + _TILDE),
        ("", "ym", _FR_NAS, "ɛ" + _TILDE),
        ("", "y", "[" + _FR_VL + "]", "j"),
        ("", "y", "", "i"),
        # --- œ ---
        ("", "œu", "$", "ø"),
        ("", "œu", "", "œ"),
        ("", "œ", "", "e"),
        # --- consonants ---
        ("", "ch", "r", "k"),  # chrétien
        ("", "ch", "", "ʃ"),
        ("", "ck", "", "k"),
        ("", "cc", "[eéèêëiîïy]", "ks"),
        ("", "c", "[eéèêëiîïy]", "s"),
        ("", "c", "", "k"),
        ("", "ç", "", "s"),
        ("", "gn", "", "ɲ"),
        ("", "gu", "[eéèêëiîïy]", "ɡ"),
        ("", "ge", "[aàoô]", "ʒ"),  # mangeons
        ("", "gg", "", "ɡ"),
        ("", "g", "[eéèêëiîïy]", "ʒ"),
        ("", "g", "", "ɡ"),
        ("", "h", "", ""),
        ("", "j", "", "ʒ"),
        ("", "ph", "", "f"),
        ("", "pp", "", "p"),
        ("", "qu", "", "k"),
        ("", "q", "", "k"),
        ("", "rr", "", "ʁ"),
        ("", "r", "", "ʁ"),
        ("", "ss", "", "s"),
        ("[" + _FR_VL + "]", "s", "[" + _FR_VL + "]", "z"),
        ("", "s", "", "s"),
        ("[^s]|^", "ti", "on", "sj"),  # nation; question keeps /t/
        ("", "tt", "", "t"),
        ("", "th", "", "t"),
        ("", "x", "", "ks"),
        ("", "w", "", "w"),
        ("", "ll", "", "l"),
        ("", "mm", "", "m"),
        ("", "nn", "", "n"),
        ("", "dd", "", "d"),
        ("", "bb", "", "b"),
        ("", "ff", "", "f"),
    ] + [("", c, "", c) for c in "bdfklmnptvz"]

    EXCEPTIONS = {
        # closed-class words the final-e / stripping rules would empty or wrong
        "le": "lə", "de": "də", "ne": "nə", "me": "mə", "te": "tə", "se": "sə",
        "ce": "sə", "je": "ʒə", "que": "kə",
        "les": "le", "des": "de", "mes": "me", "tes": "te", "ses": "se",
        "ces": "se", "et": "e", "est": "ɛ", "es": "ɛ", "aux": "o", "eux": "ø",
        "un": "œ" + _TILDE, "en": "ɑ" + _TILDE, "on": "ɔ" + _TILDE,
        "monsieur": "məsjø", "messieurs": "mesjø", "femme": "fam",
        "ville": "vil", "mille": "mil", "tranquille": "tʁɑ" + _TILDE + "kil",
        "village": "vilaʒ", "fils": "fis", "six": "sis", "dix": "dis",
        "sept": "sɛt", "huit": "ɥit", "sud": "syd", "donc": "dɔ" + _TILDE + "k",
        "gaz": "ɡaz", "ouest": "wɛst", "août": "ut", "pays": "pɛi",
        "hiver": "ivɛʁ", "cher": "ʃɛʁ", "fier": "fjɛʁ", "hier": "jɛʁ",
        "amer": "amɛʁ", "enfer": "ɑ" + _TILDE + "fɛʁ", "eu": "y",
        "œil": "œj", "aujourd'hui": "oʒuʁdɥi", "plus": "ply", "tous": "tus",
    }

    #: silent final consonants stripped before transduction (repeatedly:
    #: temps → tem); c is silent only after n (blanc, franc)
    _SILENT_FINAL = "dtsxzpg"
    #: elided single-letter clitics keep their consonant reading
    _ELISION = {"c": "s", "qu": "k", "j": "ʒ", "l": "l", "d": "d", "n": "n",
                "m": "m", "s": "s", "t": "t"}

    def default_stress_index(self, word: str, n_nuclei: int) -> int:
        return n_nuclei - 1  # French: uniform final-syllable stress

    def phonemize_word(self, word: str) -> str:
        word = word.lower()
        hit = self.EXCEPTIONS.get(word)
        if hit is not None:
            return hit
        if "'" in word or "-" in word:
            parts = re.split(r"['-]", word)
            return "".join(
                self._ELISION.get(p, None) or self.phonemize_word(p)
                for p in parts if p
            )
        core = word
        while len(core) > 2 and core[-1] in self._SILENT_FINAL:
            core = core[:-1]
        if len(core) > 3 and core.endswith("nc"):
            core = core[:-1]
        phones = self._transduce(core)
        if not any(c in _IPA_VOWELS for c in phones) and word.endswith("e"):
            phones += "ə"  # final e is a real schwa when it is the only nucleus
        return self._place_stress(core, phones)


# ---------------------------------------------------------------------------
# Portuguese (Brazilian — the zoo's YourTTS/CV variants are pt-br)
# ---------------------------------------------------------------------------

_PT_VL = "aáâãàeéêiíoóôõuú"
_PT_NAS = "$|[^" + _PT_VL + "nmh]"
_PT_FRONT = "[eéêií]"


class PortugueseG2P(RuleG2P):
    """Brazilian Portuguese: nasal vowels/diphthongs, final-vowel reduction
    (a→ɐ, e→i, o→u), t/d palatalization before /i/, coda l→w and coda r→ʁ.
    Stress: orthographic accents win; otherwise penult for words ending in
    a/e/o(+s) or -am/-em, final elsewhere (r/l/z/i/u/nasal diphthongs)."""

    VOWEL_LETTERS = _PT_VL

    RULES = [
        # --- a ---
        ("", "ãe", "", "ɐ" + _TILDE + "j"),
        ("", "ão", "", "ɐ" + _TILDE + "w"),
        ("", "ã", "", "ɐ" + _TILDE),
        ("", "am", "$", "ɐ" + _TILDE + "w"),  # 3pl verb ending: falam
        ("", "am", _PT_NAS, "ɐ" + _TILDE),
        ("", "an", _PT_NAS, "ɐ" + _TILDE),
        ("", "ai", "", "aj"),
        ("", "au", "", "aw"),
        ("", "á", "", "ˈa"),
        ("", "â", "", "ˈɐ"),
        ("", "à", "", "a"),
        ("", "a", "s?$", "ɐ"),
        ("", "a", "", "a"),
        # --- e ---
        ("", "ém", "$", "ˈẽj".replace("ẽ", "e" + _TILDE)),
        ("", "em", "$", "e" + _TILDE + "j"),
        ("", "ens", "$", "e" + _TILDE + "js"),
        ("", "em", _PT_NAS, "e" + _TILDE),
        ("", "en", _PT_NAS, "e" + _TILDE),
        ("", "ei", "", "ej"),
        ("", "eu", "", "ew"),
        ("", "é", "", "ˈɛ"),
        ("", "ê", "", "ˈe"),
        ("", "e", "s?$", "i"),  # pt-br final-vowel raising
        ("", "e", "", "e"),
        # --- i ---
        ("", "im", "$", "i" + _TILDE),
        ("", "im", _PT_NAS, "i" + _TILDE),
        ("", "in", _PT_NAS, "i" + _TILDE),
        ("", "í", "", "ˈi"),
        ("", "i", "", "i"),
        # --- o ---
        ("", "õe", "", "o" + _TILDE + "j"),
        ("", "õ", "", "o" + _TILDE),
        ("", "om", _PT_NAS, "o" + _TILDE),
        ("", "on", _PT_NAS, "o" + _TILDE),
        ("", "ou", "", "o"),
        ("", "oi", "", "oj"),
        ("", "ó", "", "ˈɔ"),
        ("", "ô", "", "ˈo"),
        ("", "o", "s?$", "u"),
        ("", "o", "", "o"),
        # --- u ---
        ("", "um", "$", "u" + _TILDE),
        ("", "um", _PT_NAS, "u" + _TILDE),
        ("", "un", _PT_NAS, "u" + _TILDE),
        ("", "ú", "", "ˈu"),
        ("", "u", "", "u"),
        # --- consonants ---
        ("", "ch", "", "ʃ"),
        ("", "lh", "", "ʎ"),
        ("", "nh", "", "ɲ"),
        ("", "ss", "", "s"),
        ("[" + _PT_VL + "]", "s", "[" + _PT_VL + "]", "z"),
        ("", "s", "", "s"),
        ("", "ç", "", "s"),
        ("", "cc", _PT_FRONT, "ks"),
        ("", "c", _PT_FRONT, "s"),
        ("", "c", "", "k"),
        ("", "qu", _PT_FRONT, "k"),
        ("", "qu", "", "kw"),
        ("", "q", "", "k"),
        ("", "gu", _PT_FRONT, "ɡ"),
        ("", "g", _PT_FRONT, "ʒ"),
        ("", "g", "", "ɡ"),
        ("", "j", "", "ʒ"),
        ("", "h", "", ""),
        ("", "rr", "", "ʁ"),
        ("^", "r", "", "ʁ"),  # word-initial: strong rhotic
        ("", "r", "[" + _PT_VL + "]", "ɾ"),  # onset tap
        ("", "r", "", "ʁ"),  # coda
        ("", "x", "", "ʃ"),
        ("", "z", "$", "s"),
        ("", "z", "", "z"),
        ("", "l", "$|[bcçdfgjklmnpqrstvwxz]", "w"),  # coda l vocalizes
        ("", "l", "", "l"),
        ("", "d", "[ií]", "dʒ"),  # pt-br palatalization
        ("", "d", "es?$", "dʒ"),
        ("", "t", "[ií]", "tʃ"),
        ("", "t", "es?$", "tʃ"),
    ] + [("", c, "", c) for c in "bfkmnpvw"]

    EXCEPTIONS = {
        "e": "i", "o": "u", "os": "us", "a": "ɐ", "as": "ɐs",
        "de": "dʒi", "que": "ki", "muito": "ˈmu" + _TILDE + "jtu",
        "muita": "ˈmu" + _TILDE + "jtɐ", "mulher": "muˈʎɛʁ",
        "mais": "majs", "mas": "majs", "eu": "ew", "ele": "ˈeli",
        "ela": "ˈɛlɐ", "está": "isˈta", "você": "voˈse",
    }

    def default_stress_index(self, word: str, n_nuclei: int) -> int:
        if re.search(r"(?<![ãõ])[aeo]s?$|[ae]m$|[ae]ns$", word):
            return max(0, n_nuclei - 2)
        return n_nuclei - 1


# ---------------------------------------------------------------------------
# Turkish — near-perfect letter↔phone mapping, fixed final stress
# ---------------------------------------------------------------------------

_TR_V = "aâeıioöuü"


class TurkishG2P(RuleG2P):
    VOWEL_LETTERS = _TR_V

    RULES = (
        # yumuşak ge: lengthens a preceding vowel before a consonant or at
        # the word end; silent between vowels
        [("", v + "ğ", "$|[^" + _TR_V + "]", ipa + "ː")
         for v, ipa in [("a", "a"), ("e", "e"), ("ı", "ɯ"), ("i", "i"),
                        ("o", "o"), ("ö", "ø"), ("u", "u"), ("ü", "y")]]
        + [
            ("", "ğ", "", ""),
            ("", "ç", "", "tʃ"),
            ("", "c", "", "dʒ"),
            ("", "ş", "", "ʃ"),
            ("", "j", "", "ʒ"),
            ("", "y", "", "j"),
            ("", "ı", "", "ɯ"),
            ("", "â", "", "aː"),
            ("", "ö", "", "ø"),
            ("", "ü", "", "y"),
            ("", "r", "", "ɾ"),
            ("", "g", "", "ɡ"),
        ]
        + [("", c, "", c) for c in "abdefhiklmnopstuvz"]
    )

    def default_stress_index(self, word: str, n_nuclei: int) -> int:
        return n_nuclei - 1  # Turkish: regular final-syllable stress


# ---------------------------------------------------------------------------
# Polish — regular digraph orthography, fixed penultimate stress
# ---------------------------------------------------------------------------

_PL_V = "[aąeęioóuy]"


class PolishG2P(RuleG2P):
    VOWEL_LETTERS = "aąeęioóuy"

    RULES = [
        ("", "ch", "", "x"),
        ("", "ci", _PL_V, "tɕ"),
        ("", "ci", "", "tɕi"),
        ("", "cz", "", "tʂ"),
        ("", "ć", "", "tɕ"),
        ("", "c", "", "ts"),
        ("", "dzi", _PL_V, "dʑ"),
        ("", "dzi", "", "dʑi"),
        ("", "dź", "$", "tɕ"),  # final devoicing
        ("", "dź", "", "dʑ"),
        ("", "dż", "", "dʐ"),
        ("", "dz", "", "dz"),
        ("", "d", "$", "t"),
        ("", "si", _PL_V, "ɕ"),
        ("", "si", "", "ɕi"),
        ("", "sz", "", "ʂ"),
        ("", "ś", "", "ɕ"),
        ("", "zi", _PL_V, "ʑ"),
        ("", "zi", "", "ʑi"),
        ("", "ź", "", "ʑ"),
        ("", "ż", "$", "ʂ"),
        ("", "ż", "", "ʐ"),
        ("", "z", "$", "s"),
        ("", "ni", _PL_V, "ɲ"),
        ("", "ni", "", "ɲi"),
        ("", "ń", "", "ɲ"),
        ("[ptkfsc]", "rz", "", "ʂ"),  # devoiced after a voiceless obstruent
        ("", "rz", "$", "ʂ"),
        ("", "rz", "", "ʐ"),
        ("", "ą", "", "ɔ" + _TILDE),
        ("", "ę", "$", "ɛ"),  # word-final ę denasalizes
        ("", "ę", "", "ɛ" + _TILDE),
        ("", "ł", "", "w"),
        ("", "ó", "", "u"),
        ("", "y", "", "ɨ"),
        ("", "e", "", "ɛ"),
        ("", "o", "", "ɔ"),
        ("", "h", "", "x"),
        ("", "i", _PL_V, "j"),
        ("", "w", "$", "f"),
        ("", "w", "[ptkfscśćh]", "f"),  # voicing assimilation
        ("", "w", "", "v"),
        ("", "b", "$", "p"),
        ("", "g", "$", "k"),
        ("", "g", "", "ɡ"),
    ] + [("", c, "", c) for c in "afijklmnprstu"]

    # default (penultimate) stress is the base-class default


# ---------------------------------------------------------------------------
# Czech — regular orthography with vowel length, fixed initial stress
# ---------------------------------------------------------------------------


class CzechG2P(RuleG2P):
    VOWEL_LETTERS = "aáeéěiíoóuúůyý"

    RULES = [
        ("", "ch", "", "x"),
        ("", "č", "", "tʃ"),
        ("", "š", "", "ʃ"),
        ("", "ž", "$", "ʃ"),  # final devoicing
        ("", "ž", "", "ʒ"),
        # ř has no charset-exact symbol (raised alveolar trill r̝);
        # the standard approximation is the /rʒ/ cluster, devoiced /rʃ/
        # finally and after voiceless obstruents
        ("[ptksf]", "ř", "", "rʃ"),
        ("", "ř", "$", "rʃ"),
        ("", "ř", "", "rʒ"),
        ("", "c", "", "ts"),
        ("", "ď", "", "ɟ"),
        ("", "ť", "", "c"),
        ("", "ň", "", "ɲ"),
        # ě palatalizes a preceding d/t/n (mě → mňe)
        ("", "dě", "", "ɟɛ"),
        ("", "tě", "", "cɛ"),
        ("", "ně", "", "ɲɛ"),
        ("", "mě", "", "mɲɛ"),
        ("", "bě", "", "bjɛ"),
        ("", "pě", "", "pjɛ"),
        ("", "vě", "", "vjɛ"),
        ("", "ě", "", "jɛ"),
        ("", "di", "", "ɟɪ"),
        ("", "ti", "", "cɪ"),
        ("", "ni", "", "ɲɪ"),
        ("", "dí", "", "ɟiː"),
        ("", "tí", "", "ciː"),
        ("", "ní", "", "ɲiː"),
        ("", "á", "", "aː"),
        ("", "é", "", "ɛː"),
        ("", "í", "", "iː"),
        ("", "ó", "", "oː"),
        ("", "ú", "", "uː"),
        ("", "ů", "", "uː"),
        ("", "ý", "", "iː"),
        ("", "y", "", "ɪ"),
        ("", "i", "", "ɪ"),
        ("", "e", "", "ɛ"),
        ("", "h", "$", "x"),  # final devoicing (sníh)
        ("", "h", "", "ɦ"),
        ("", "g", "$", "k"),
        ("", "g", "", "ɡ"),
        ("", "b", "$", "p"),
        ("", "d", "$", "t"),
        ("", "v", "$", "f"),
        ("", "z", "$", "s"),
    ] + [("", c, "", c) for c in "abdfjklmnoprstuvz"]

    def default_stress_index(self, word: str, n_nuclei: int) -> int:
        return 0  # Czech: fixed initial stress


# ---------------------------------------------------------------------------
# Hungarian — regular digraph orthography, fixed initial stress
# ---------------------------------------------------------------------------


class HungarianG2P(RuleG2P):
    VOWEL_LETTERS = "aáeéiíoóöőuúüű"

    RULES = [
        ("", "dzs", "", "dʒ"),
        ("", "dz", "", "dz"),
        ("", "cs", "", "tʃ"),
        ("", "c", "", "ts"),
        ("", "gy", "", "ɟ"),
        ("", "g", "", "ɡ"),
        ("", "ly", "", "j"),
        ("", "ny", "", "ɲ"),
        ("", "ty", "", "c"),
        ("", "sz", "", "s"),  # sz = /s/, bare s = /ʃ/ (inverse of Polish)
        ("", "zs", "", "ʒ"),
        ("", "s", "", "ʃ"),
        ("", "a", "", "ɒ"),
        ("", "á", "", "aː"),
        ("", "e", "", "ɛ"),
        ("", "é", "", "eː"),
        ("", "í", "", "iː"),
        ("", "ó", "", "oː"),
        ("", "ö", "", "ø"),
        ("", "ő", "", "øː"),
        ("", "ú", "", "uː"),
        ("", "ü", "", "y"),
        ("", "ű", "", "yː"),
    ] + [("", c, "", c) for c in "bdfhijklmnoprtuvz"]

    HIATUS = True  # no falling diphthongs: szia is two syllables

    def default_stress_index(self, word: str, n_nuclei: int) -> int:
        return 0  # Hungarian: fixed initial stress


# ---------------------------------------------------------------------------
# Finnish — near-perfectly phonemic: doubled letters are long/geminate,
# fixed initial stress
# ---------------------------------------------------------------------------


class FinnishG2P(RuleG2P):
    VOWEL_LETTERS = "aäeiouöy"

    RULES = (
        [("", v * 2, "", ipa + "ː")
         for v, ipa in zip("aäeiouöy", "ɑæeiouøy")]
        + [("", c * 2, "", c + "ː") for c in "bdfghjklmnprstv"]
        + [
            ("", "kk", "", "kː"),
            ("", "pp", "", "pː"),
            ("", "tt", "", "tː"),
            ("", "ng", "", "ŋː"),   # sangen /sɑŋːen/
            ("", "nk", "", "ŋk"),
            ("", "a", "", "ɑ"),
            ("", "ä", "", "æ"),
            ("", "ö", "", "ø"),
            ("", "v", "", "ʋ"),
        ]
        + [("", c, "", c) for c in "eiouybdfghjklmnprst"]
    )

    def default_stress_index(self, word: str, n_nuclei: int) -> int:
        return 0  # Finnish: fixed initial stress


# ---------------------------------------------------------------------------
# Dutch — open-syllable vowel length approximated with a C+V right context;
# final obstruent devoicing; Germanic initial stress with unstressed
# ge-/be-/ver- prefixes
# ---------------------------------------------------------------------------

_NL_C = "[bcdfghjklmnpqrstvwxz]"
_NL_V = "[aeiouy]"


class DutchG2P(RuleG2P):
    VOWEL_LETTERS = "aeiouy"
    ONSET_S_CLUSTERS = True

    RULES = [
        # vowel digraphs / diphthongs (incl. the -uw/-ouw/-ooi glide forms)
        ("", "aai", "", "aːj"),
        ("", "ooi", "", "oːj"),
        ("", "oei", "", "uj"),
        ("", "eeuw", "", "eːu"),
        ("", "ieuw", "", "iu"),
        ("", "ouw", "", "ɑu"),
        ("", "auw", "", "ɑu"),
        ("", "uw", "", "yu"),
        ("", "aa", "", "aː"),
        ("", "ee", "", "eː"),
        ("", "oo", "", "oː"),
        ("", "uu", "", "yː"),
        ("", "oe", "", "u"),
        ("", "ie", "", "i"),
        ("", "ij", "", "ɛi"),
        ("", "ei", "", "ɛi"),
        ("", "ui", "", "œy"),
        ("", "ou", "", "ɑu"),
        ("", "au", "", "ɑu"),
        ("", "eu", "", "øː"),
        # consonant digraphs
        ("", "sch", "$", "s"),    # praktisch → -is
        ("", "sch", "", "sx"),
        ("", "ch", "", "x"),
        ("", "ng", "", "ŋ"),
        ("", "nk", "", "ŋk"),
        ("", "sj", "", "ʃ"),
        ("", "tj", "$", "tʃ"),
        ("", "qu", "", "kw"),
        # schwa: final -e / -en / -er / -el / -es (unstressed endings)
        (".", "e", "n$", "ə"),
        (".", "e", "r$", "ə"),
        (".", "e", "l$", "ə"),
        (".", "e", "s$", "ə"),
        (".", "e", "$", "ə"),
        # open syllable (V·CV) → long vowel; else short
        ("", "a", _NL_C + _NL_V, "aː"),
        ("", "e", _NL_C + _NL_V, "eː"),
        ("", "o", _NL_C + _NL_V, "oː"),
        ("", "u", _NL_C + _NL_V, "yː"),
        ("", "a", "$", "aː"),
        ("", "o", "$", "oː"),
        ("", "u", "$", "y"),
        ("", "a", "", "ɑ"),
        ("", "e", "", "ɛ"),
        ("", "i", "", "ɪ"),
        ("", "o", "", "ɔ"),
        ("", "u", "", "ʏ"),
        ("", "y", "", "i"),
        # doubled consonants are written double but spoken single
        *[("", c * 2, "", c) for c in "bdfgklmnprst"],
        ("", "ck", "", "k"),
        # final devoicing (huid → /hœyt/)
        ("", "b", "$", "p"),
        ("", "d", "$", "t"),
        ("", "g", "$", "x"),
        ("", "g", "", "ɣ"),
        ("", "w", "", "ʋ"),
        ("", "c", "[eiy]", "s"),
        ("", "c", "", "k"),
        ("", "x", "", "ks"),
    ] + [("", c, "", c) for c in "bdfhjklmnprstvz"]

    def default_stress_index(self, word: str, n_nuclei: int) -> int:
        # unstressed verbal/nominal prefixes (vergeten → verˈgeten)
        for p in ("ge", "be", "ver", "ont", "her"):
            if word.startswith(p) and len(word) > len(p) + 2 and n_nuclei >= 2:
                return 1
        return 0


# ---------------------------------------------------------------------------
# Romanian — shallow orthography: ă/â(î) central vowels, c/g palatalization
# before e/i (with ch/gh blockers); stress heuristic: final syllable for
# consonant-final words, penult otherwise
# ---------------------------------------------------------------------------


class RomanianG2P(RuleG2P):
    VOWEL_LETTERS = "aăâeiîouy"

    RULES = [
        ("", "che", "", "ke"),
        ("", "chi", "", "ki"),
        ("", "ghe", "", "ɡe"),
        ("", "ghi", "", "ɡi"),
        ("", "ce", "", "tʃe"),
        ("", "ci", "", "tʃi"),
        ("", "ge", "", "dʒe"),
        ("", "gi", "", "dʒi"),
        ("", "âi", "", "ɨj"),   # pâine /ˈpɨjne/
        ("", "ă", "", "ə"),
        ("", "â", "", "ɨ"),
        ("", "î", "", "ɨ"),
        ("", "ș", "", "ʃ"),
        ("", "ş", "", "ʃ"),   # legacy cedilla codepoints
        ("", "ț", "", "ts"),
        ("", "ţ", "", "ts"),
        ("", "j", "", "ʒ"),
        ("", "c", "", "k"),
        ("", "g", "", "ɡ"),
        ("", "x", "", "ks"),
    ] + [("", c, "", c) for c in "aebdfhiklmnoprstuvz"]

    def default_stress_index(self, word: str, n_nuclei: int) -> int:
        if word and word[-1].lower() not in self.VOWEL_LETTERS:
            return n_nuclei - 1
        return max(0, n_nuclei - 2)


# ---------------------------------------------------------------------------
# Catalan (Central/Eastern) — Spanish-like consonants plus ʒ/ʃ and ʎ, with
# the Eastern vowel reduction (unstressed a,e → ə; o → u) applied as a
# post-pass once stress is placed; final -r of polysyllables is silent
# ---------------------------------------------------------------------------

_CA_VVL = "aeiouàèéíòóúï"


class CatalanG2P(RuleG2P):
    VOWEL_LETTERS = "aeiouàèéíòóú"
    HIATUS = True  # dia is di-a; falling diphthongs are listed explicitly

    RULES = [
        # accented vowels carry the stress inline (à is always stressed)
        ("", "à", "", _STRESS + "a"),
        ("", "è", "", _STRESS + "ɛ"),
        ("", "é", "", _STRESS + "e"),
        ("", "í", "", _STRESS + "i"),
        ("", "ò", "", _STRESS + "ɔ"),
        ("", "ó", "", _STRESS + "o"),
        ("", "ú", "", _STRESS + "u"),
        ("", "ï", "", "i"),
        # falling diphthongs (HIATUS splits everything else)
        ("", "au", "", "aw"),
        ("", "eu", "", "ew"),
        ("", "iu", "", "iw"),
        ("", "ou", "", "ow"),
        ("", "ai", "(?!x)", "aj"),  # but aix → a + ʃ (caixa)
        ("", "ei", "(?!x)", "ej"),
        ("", "oi", "(?!x)", "oj"),
        ("", "ui", "(?!x)", "uj"),
        # consonant clusters/digraphs
        ("", "l·l", "", "l"),
        ("", "ny", "", "ɲ"),
        ("", "ll", "", "ʎ"),
        ("", "ss", "", "s"),
        ("", "rr", "", "r"),
        ("", "tx", "", "tʃ"),
        ("", "tg", "[eiéíè]", "dʒ"),
        ("", "tj", "", "dʒ"),
        ("", "ç", "", "s"),
        ("", "qu", "[eiéíè]", "k"),
        ("", "qü", "", "kw"),
        ("", "qu", "", "kw"),
        ("", "gu", "[eiéíè]", "ɡ"),
        ("", "gü", "", "ɡw"),
        ("", "c", "[eiéíè]", "s"),
        ("", "c", "$", "k"),
        ("", "c", "", "k"),
        ("", "g", "[eiéíè]", "ʒ"),
        ("", "g", "$", "k"),
        ("", "g", "", "ɡ"),
        ("", "j", "", "ʒ"),
        ("[" + _CA_VVL + "]", "ix", "", "ʃ"),  # caixa → ˈkaʃə
        ("", "x", "", "ʃ"),
        ("", "h", "", ""),
        ("", "v", "", "b"),
        ("[" + _CA_VVL + "]", "s", "[" + _CA_VVL + "]", "z"),
        ("", "z", "", "z"),
        # final -r silent after ≥2 vowels (parlar, carrer; monosyllabic
        # cor/mar/per keep it)
        ("[" + _CA_VVL + "].*[" + _CA_VVL + "].*", "r", "$", ""),
        ("^", "r", "", "r"),
        ("", "b", "$", "p"),
        ("", "d", "$", "t"),
        ("", "r", "", "ɾ"),
    ] + [("", c, "", c) for c in "aeioubdfklmnpst"]

    def default_stress_index(self, word: str, n_nuclei: int) -> int:
        # like Spanish: vowel/-n/-s final → penult, else final
        w = word.rstrip(".,;:!?")
        if w and (w[-1] in "aeiou" or (w[-1] in "ns" and len(w) > 1 and w[-2] in "aeiou")):
            return max(0, n_nuclei - 2)
        return n_nuclei - 1

    def phonemize_word(self, word: str) -> str:
        word = word.lower()
        hit = self.EXCEPTIONS.get(word)
        if hit is not None:
            return hit
        phones = self._place_stress(word, self._transduce(word))
        return self._reduce(phones)

    @classmethod
    def _reduce(cls, phones: str) -> str:
        """Eastern vowel reduction outside the stressed nucleus."""
        at = phones.find(_STRESS)
        if at < 0:
            return phones
        bare = phones.replace(_STRESS, "")
        spans = cls._nuclei(bare)
        stressed = next((s for s in spans if s[0] >= at), spans[-1] if spans else None)
        out = []
        for i, ch in enumerate(bare):
            if stressed and stressed[0] <= i < stressed[1]:
                out.append(ch)
            elif ch in "aɛe":
                out.append("ə")
            elif ch in "ɔo":
                out.append("u")
            else:
                out.append(ch)
        return "".join(out[:at]) + _STRESS + "".join(out[at:])


_ENGINES: Dict[str, RuleG2P] = {}


def get_latin_g2p(language: str) -> Optional[RuleG2P]:
    """Engine for a supported language code
    (es/it/de/fr/pt/tr/pl/cs/hu/fi/nl/ro/ca here, plus the
    sk/hr/sl/lt/lv/et/bg/uk/el extension set in ``rule_g2p_ext`` and the
    da/sv/ga/mt/fa set in ``rule_g2p_ext3``; region variants accepted)."""
    base = language.lower().split("-")[0]
    cls = {"es": SpanishG2P, "it": ItalianG2P, "de": GermanG2P,
           "fr": FrenchG2P, "pt": PortugueseG2P, "tr": TurkishG2P,
           "pl": PolishG2P, "cs": CzechG2P, "hu": HungarianG2P,
           "fi": FinnishG2P, "nl": DutchG2P, "ro": RomanianG2P,
           "ca": CatalanG2P}.get(base)
    if cls is None:
        from .rule_g2p_ext import EXT_ENGINES

        cls = EXT_ENGINES.get(base)
    if cls is None:
        from .rule_g2p_ext3 import EXT_ENGINES3

        cls = EXT_ENGINES3.get(base)
    if cls is None:
        return None
    if base not in _ENGINES:
        _ENGINES[base] = cls()
    return _ENGINES[base]
