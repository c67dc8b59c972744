"""Copied from ``tts_tpu/text/rule_g2p_ext.py`` (the port imports nothing of ``tts_tpu``);
unchanged apart from this line and the package named in this docstring.

Offline rule-G2P fallback, extension set: sk/hr/sl/lt/lv/et (Latin),
bg/uk (Cyrillic) and el (Greek).

Same contract as ``tts_tpu_torch.text.latin_g2p`` (which also hosts the shared
:class:`~tts_tpu_torch.text.latin_g2p.RuleG2P` machinery): the reference reaches
these languages only through the espeak binary
(``TTS/tts/utils/text/phonemizers/espeak_wrapper.py:47-83``), so with espeak
absent its ``use_phonemes`` zoo configs (bg/hr/sk/sl/lt/lv/et/uk/el VITS
entries in ``.models.json``) silently degrade to graphemes.  These nine
orthographies are regular enough for compact ordered-rule transducers:

* Slovak/Croatian/Latvian/Estonian carry fixed initial stress; Greek marks
  stress orthographically (tonos) — those five are phonemically tight.
* Slovenian/Lithuanian/Bulgarian/Ukrainian have free lexical stress; the
  penultimate default plus a small exceptions lexicon is an approximation
  (segments are still correct — far above graphemes, below espeak).

Broad-transcription simplifications, called out per engine: Slovak ``v``
vocalization in codas is skipped; Slovenian vowels collapse to the ɛ/ɔ
qualities; Lithuanian/Ukrainian consonant palatalization before front
vowels is dropped (Ukrainian keeps the phonemic soft sign as ``ʲ``).

Output stays inside the ``IPAPhonemes`` charset.  Engines register through
``latin_g2p.get_latin_g2p`` so phonemizer selection logic is unchanged.
"""

from __future__ import annotations

from typing import Dict

from .latin_g2p import RuleG2P

# ---------------------------------------------------------------------------
# Slovak — fixed initial stress, Czech-like consonants, rising diphthongs
# ia/ie/iu → ja/je/ju, ô → uo, final devoicing.
# ---------------------------------------------------------------------------


class SlovakG2P(RuleG2P):
    VOWEL_LETTERS = "aáäeéiíoóôuúyý"

    RULES = [
        ("", "ch", "", "x"),
        ("", "dž", "$", "tʃ"),
        ("", "dž", "", "dʒ"),
        ("", "dz", "$", "ts"),
        ("", "dz", "", "dz"),
        ("", "č", "", "tʃ"),
        ("", "š", "", "ʃ"),
        ("", "ž", "$", "ʃ"),  # final devoicing
        ("", "ž", "", "ʒ"),
        ("", "c", "", "ts"),
        ("", "ď", "", "ɟ"),
        ("", "ť", "", "c"),
        ("", "ň", "", "ɲ"),
        ("", "ľ", "", "ʎ"),
        # d/t/n/l palatalize before e, i/í and the i-diphthongs (the
        # diphthong-context rule must run first so ``dia`` → ɟ + ja, not
        # ɟi + a)
        ("", "d", "i[aeu]", "ɟ"),
        ("", "di", "", "ɟi"),
        ("", "dí", "", "ɟiː"),
        ("", "de", "", "ɟe"),
        ("", "t", "i[aeu]", "c"),
        ("", "ti", "", "ci"),
        ("", "tí", "", "ciː"),
        ("", "te", "", "ce"),
        ("", "n", "i[aeu]", "ɲ"),
        ("", "ni", "", "ɲi"),
        ("", "ní", "", "ɲiː"),
        ("", "ne", "", "ɲe"),
        ("", "l", "i[aeu]", "ʎ"),
        ("", "li", "", "ʎi"),
        ("", "lí", "", "ʎiː"),
        ("", "le", "", "ʎe"),
        # rising diphthongs
        ("", "ia", "", "ja"),
        ("", "ie", "", "je"),
        ("", "iu", "", "ju"),
        ("", "ô", "", "uo"),
        # long vowels
        ("", "á", "", "aː"),
        ("", "ä", "", "æ"),
        ("", "é", "", "eː"),
        ("", "í", "", "iː"),
        ("", "ó", "", "oː"),
        ("", "ú", "", "uː"),
        ("", "ý", "", "iː"),
        ("", "y", "", "i"),
        # final devoicing of the remaining voiced obstruents
        ("", "b", "$", "p"),
        ("", "d", "$", "t"),
        ("", "g", "$", "k"),
        ("", "z", "$", "s"),
        ("", "h", "$", "x"),
        ("", "h", "", "ɦ"),
        ("", "v", "$", "f"),
        ("", "g", "", "ɡ"),
        ("", "x", "", "ks"),
    ] + [("", c, "", c) for c in "abdefijklmnopqrstuvwz"]

    def default_stress_index(self, word, n_nuclei):
        return 0


# ---------------------------------------------------------------------------
# Croatian — Gaj's alphabet, one letter (or digraph) per phoneme; stress is
# pitch-accent and never word-final, almost always retracted to the first
# syllable in 2-3 syllable words → fixed initial default.
# ---------------------------------------------------------------------------


class CroatianG2P(RuleG2P):
    VOWEL_LETTERS = "aeiou"

    RULES = [
        ("", "dž", "", "dʒ"),
        ("", "đ", "", "dʑ"),
        ("", "lj", "", "ʎ"),
        ("", "nj", "", "ɲ"),
        ("", "č", "", "tʃ"),
        ("", "ć", "", "tɕ"),
        ("", "š", "", "ʃ"),
        ("", "ž", "", "ʒ"),
        ("", "c", "", "ts"),
        ("", "h", "", "x"),
        ("", "g", "", "ɡ"),
    ] + [("", c, "", c) for c in "abdefijklmnoprstuvz"]

    def default_stress_index(self, word, n_nuclei):
        return 0


# ---------------------------------------------------------------------------
# Slovenian — broad: e/o collapse to ɛ/ɔ (true mid qualities are lexical),
# v → ʋ prevocalically, lj/nj stay literal clusters.  Free stress →
# penultimate default.
# ---------------------------------------------------------------------------


class SlovenianG2P(RuleG2P):
    VOWEL_LETTERS = "aeiou"

    RULES = [
        ("", "č", "", "tʃ"),
        ("", "š", "", "ʃ"),
        ("", "ž", "", "ʒ"),
        ("", "c", "", "ts"),
        ("", "h", "", "x"),
        ("", "v", "", "ʋ"),
        ("", "e", "", "ɛ"),
        ("", "o", "", "ɔ"),
        ("", "g", "", "ɡ"),
    ] + [("", c, "", c) for c in "abdfijklmnprstuz"]


# ---------------------------------------------------------------------------
# Lithuanian — nasal letters are plain long vowels, y/į → iː, o is long in
# native words; ``i`` between a consonant and a back vowel is a (dropped)
# palatalization marker.  Free stress → penultimate default.
# ---------------------------------------------------------------------------


class LithuanianG2P(RuleG2P):
    VOWEL_LETTERS = "aąeęėiįyouųū"

    RULES = [
        ("", "ch", "", "x"),
        ("", "dž", "", "dʒ"),
        ("", "dz", "", "dz"),
        ("", "č", "", "tʃ"),
        ("", "š", "", "ʃ"),
        ("", "ž", "", "ʒ"),
        ("", "c", "", "ts"),
        # palatalization marker i before a back vowel (broad: dropped)
        ("[^aąeęėiįyouųū]", "i", "[aąouųū]", ""),
        # native falling diphthongs
        ("", "uo", "", "uo"),
        ("", "ie", "", "iɛ"),
        ("", "ą", "", "aː"),
        ("", "ę", "", "ɛː"),
        ("", "ė", "", "eː"),
        ("", "e", "", "ɛ"),
        ("", "į", "", "iː"),
        ("", "y", "", "iː"),
        ("", "i", "", "ɪ"),
        ("", "ų", "", "uː"),
        ("", "ū", "", "uː"),
        ("", "u", "", "ʊ"),
        ("", "o", "", "oː"),
        ("", "h", "", "ɦ"),
        ("", "g", "", "ɡ"),
    ] + [("", c, "", c) for c in "abdfjklmnprstvz"]


# ---------------------------------------------------------------------------
# Latvian — fixed initial stress; macrons are long vowels; native ``o``
# spells the /uo/ diphthong; ģ/ķ/ļ/ņ are palatals.
# ---------------------------------------------------------------------------


class LatvianG2P(RuleG2P):
    VOWEL_LETTERS = "aāeēiīouū"

    RULES = [
        ("", "dž", "", "dʒ"),
        ("", "dz", "", "dz"),
        ("", "č", "", "tʃ"),
        ("", "š", "", "ʃ"),
        ("", "ž", "", "ʒ"),
        ("", "c", "", "ts"),
        ("", "ģ", "", "ɟ"),
        ("", "ķ", "", "c"),
        ("", "ļ", "", "ʎ"),
        ("", "ņ", "", "ɲ"),
        ("", "ā", "", "aː"),
        ("", "ē", "", "ɛː"),
        ("", "e", "", "ɛ"),
        ("", "ī", "", "iː"),
        ("", "ū", "", "uː"),
        ("", "ie", "", "iɛ"),
        ("", "o", "", "uo"),
        ("", "h", "", "x"),
        ("", "g", "", "ɡ"),
    ] + [("", c, "", c) for c in "abdfijklmnprstuvz"]

    def default_stress_index(self, word, n_nuclei):
        return 0


# ---------------------------------------------------------------------------
# Estonian — fixed initial stress; doubled letters are long; õ → ɤ.  The
# lenis b/d/g are kept as written (broad).
# ---------------------------------------------------------------------------


class EstonianG2P(RuleG2P):
    VOWEL_LETTERS = "aeiouõäöü"

    RULES = (
        # doubled letters → long segment
        [("", 2 * v, "", ipa + "ː") for v, ipa in [
            ("a", "a"), ("e", "e"), ("i", "i"), ("o", "o"), ("u", "u"),
            ("õ", "ɤ"), ("ä", "æ"), ("ö", "ø"), ("ü", "y"),
        ]]
        + [("", 2 * c, "", c + "ː") for c in "lmnrsv"]
        + [("", 2 * c, "", c + "ː") for c in ("p", "t", "k")]
        + [
            ("", "š", "", "ʃ"),
            ("", "ž", "", "ʒ"),
            ("", "õ", "", "ɤ"),
            ("", "ä", "", "æ"),
            ("", "ö", "", "ø"),
            ("", "ü", "", "y"),
            ("", "g", "", "ɡ"),
        ]
        + [("", c, "", c) for c in "abdefhijklmnoprstuv"]
    )

    def default_stress_index(self, word, n_nuclei):
        return 0


# ---------------------------------------------------------------------------
# Bulgarian — Cyrillic; one letter per phoneme, ъ → ɤ, щ → ʃt, final
# devoicing.  Free stress → penultimate default + exceptions.
# ---------------------------------------------------------------------------


class BulgarianG2P(RuleG2P):
    VOWEL_LETTERS = "аеиоуъюя"

    RULES = [
        ("", "щ", "", "ʃt"),
        ("", "ьо", "", "jo"),
        ("", "ю", "", "ju"),
        ("", "я", "", "ja"),
        ("", "ж", "$", "ʃ"),  # final devoicing
        ("", "ж", "", "ʒ"),
        ("", "ч", "", "tʃ"),
        ("", "ш", "", "ʃ"),
        ("", "ц", "", "ts"),
        ("", "б", "$", "p"),
        ("", "б", "", "b"),
        ("", "в", "$", "f"),
        ("", "в", "", "v"),
        ("", "г", "$", "k"),
        ("", "г", "", "ɡ"),
        ("", "д", "$", "t"),
        ("", "д", "", "d"),
        ("", "з", "$", "s"),
        ("", "з", "", "z"),
        ("", "а", "", "a"),
        ("", "е", "", "ɛ"),
        ("", "и", "", "i"),
        ("", "й", "", "j"),
        ("", "к", "", "k"),
        ("", "л", "", "l"),
        ("", "м", "", "m"),
        ("", "н", "", "n"),
        ("", "о", "", "o"),
        ("", "п", "", "p"),
        ("", "р", "", "r"),
        ("", "с", "", "s"),
        ("", "т", "", "t"),
        ("", "у", "", "u"),
        ("", "ф", "", "f"),
        ("", "х", "", "x"),
        ("", "ъ", "", "ɤ"),
        ("", "ь", "", "j"),
    ]

    EXCEPTIONS = {
        "вода": "voˈda",
        "добре": "doˈbrɛ",
        "жена": "ʒɛˈna",
        "дете": "dɛˈtɛ",
        "език": "ɛˈzik",
        "благодаря": "blaɡodaˈrja",
    }


# ---------------------------------------------------------------------------
# Ukrainian — Cyrillic; г → ɦ, и → ɪ, в → ʋ, the soft sign survives as the
# phonemic ʲ, iotated vowels are Cʲ+V after consonants and j+V elsewhere.
# No final devoicing (voiced obstruents stay voiced).  Free stress →
# penultimate default + exceptions.
# ---------------------------------------------------------------------------

_UK_C = "[бвгґджзклмнпрстфхцчшщ]"


class UkrainianG2P(RuleG2P):
    VOWEL_LETTERS = "аеєиіїоуюя"

    RULES = [
        ("", "щ", "", "ʃtʃ"),
        ("", "дж", "", "dʒ"),
        ("", "дз", "", "dz"),
        # iotated vowels: soft after consonants, j-glide elsewhere
        (_UK_C, "я", "", "ʲa"),
        ("", "я", "", "ja"),
        (_UK_C, "ю", "", "ʲu"),
        ("", "ю", "", "ju"),
        (_UK_C, "є", "", "ʲɛ"),
        ("", "є", "", "jɛ"),
        ("", "ї", "", "ji"),
        ("", "ь", "", "ʲ"),
        ("", "'", "", ""),
        ("", "ж", "", "ʒ"),
        ("", "ч", "", "tʃ"),
        ("", "ш", "", "ʃ"),
        ("", "ц", "", "ts"),
        ("", "а", "", "a"),
        ("", "б", "", "b"),
        ("", "в", "", "ʋ"),
        ("", "г", "", "ɦ"),
        ("", "ґ", "", "ɡ"),
        ("", "д", "", "d"),
        ("", "е", "", "ɛ"),
        ("", "з", "", "z"),
        ("", "и", "", "ɪ"),
        ("", "і", "", "i"),
        ("", "й", "", "j"),
        ("", "к", "", "k"),
        ("", "л", "", "l"),
        ("", "м", "", "m"),
        ("", "н", "", "n"),
        ("", "о", "", "ɔ"),
        ("", "п", "", "p"),
        ("", "р", "", "r"),
        ("", "с", "", "s"),
        ("", "т", "", "t"),
        ("", "у", "", "u"),
        ("", "ф", "", "f"),
        ("", "х", "", "x"),
    ]

    EXCEPTIONS = {
        "дякую": "ˈdʲakuju",
        "вода": "ʋɔˈda",
        "добрий": "ˈdɔbrɪj",
        "будь": "budʲ",
        "ласка": "ˈlaska",
    }


# ---------------------------------------------------------------------------
# Greek — modern monotonic orthography: digraph vowels (ου/αι/ει/οι/υι),
# voicing-sensitive αυ/ευ, prenasalized stop digraphs (μπ/ντ/γκ), fricative
# softening before front vowels (γ→ʝ, χ→ç, κ stays plosive), doubled
# consonants reduce, and the tonos IS the stress mark.
# ---------------------------------------------------------------------------

_EL_FRONT = "[εηιυeέήίύϊΐ]|αι|ει|οι"
_EL_VOICELESS = "[θκξπστφχψ]"


class GreekG2P(RuleG2P):
    VOWEL_LETTERS = "αάεέηήιίϊΐοόυύϋωώ"
    ONSET_S_CLUSTERS = True  # ευ.χα.ρι.στώ — /s/+stop syllabifies as onset

    RULES = [
        # doubled consonants
        ("", "λλ", "", "l"),
        ("", "σσ", "", "s"),
        ("", "νν", "", "n"),
        ("", "μμ", "", "m"),
        ("", "ρρ", "", "r"),
        ("", "κκ", "", "k"),
        ("", "ππ", "", "p"),
        ("", "ττ", "", "t"),
        # prenasalized / voiced stop digraphs
        ("^", "μπ", "", "b"),
        ("", "μπ", "", "mb"),
        ("^", "ντ", "", "d"),
        ("", "ντ", "", "nd"),
        ("^", "γκ", "", "ɡ"),
        ("", "γκ", "", "ŋɡ"),
        ("", "γγ", "", "ŋɡ"),
        ("", "τσ", "", "ts"),
        ("", "τζ", "", "dz"),
        # vowel digraphs (stressed variants carry the inline mark)
        ("", "ου", "", "u"),
        ("", "ού", "", "ˈu"),
        ("", "αι", "", "ɛ"),
        ("", "αί", "", "ˈɛ"),
        ("", "ει", "", "i"),
        ("", "εί", "", "ˈi"),
        ("", "οι", "", "i"),
        ("", "οί", "", "ˈi"),
        ("", "υι", "", "i"),
        # αυ/ευ: fricative v before voiced, f before voiceless
        ("", "αυ", _EL_VOICELESS, "af"),
        ("", "αύ", _EL_VOICELESS, "ˈaf"),
        ("", "αυ", "", "av"),
        ("", "αύ", "", "ˈav"),
        ("", "ευ", _EL_VOICELESS, "ɛf"),
        ("", "εύ", _EL_VOICELESS, "ˈɛf"),
        ("", "ευ", "", "ɛv"),
        ("", "εύ", "", "ˈɛv"),
        # front-vowel softening
        ("", "γ", _EL_FRONT, "ʝ"),
        ("", "χ", _EL_FRONT, "ç"),
        ("", "γ", "", "ɣ"),
        ("", "χ", "", "x"),
        # plain letters
        ("", "α", "", "a"),
        ("", "ά", "", "ˈa"),
        ("", "β", "", "v"),
        ("", "δ", "", "ð"),
        ("", "ε", "", "ɛ"),
        ("", "έ", "", "ˈɛ"),
        ("", "ζ", "", "z"),
        ("", "η", "", "i"),
        ("", "ή", "", "ˈi"),
        ("", "θ", "", "θ"),
        ("", "ι", "", "i"),
        ("", "ί", "", "ˈi"),
        ("", "ϊ", "", "i"),
        ("", "ΐ", "", "ˈi"),
        ("", "κ", "", "k"),
        ("", "λ", "", "l"),
        ("", "μ", "", "m"),
        ("", "ν", "", "n"),
        ("", "ξ", "", "ks"),
        ("", "ο", "", "ɔ"),
        ("", "ό", "", "ˈɔ"),
        ("", "π", "", "p"),
        ("", "ρ", "", "r"),
        ("", "σ", "", "s"),
        ("", "ς", "", "s"),
        ("", "τ", "", "t"),
        ("", "υ", "", "i"),
        ("", "ύ", "", "ˈi"),
        ("", "ϋ", "", "i"),
        ("", "φ", "", "f"),
        ("", "ψ", "", "ps"),
        ("", "ω", "", "ɔ"),
        ("", "ώ", "", "ˈɔ"),
    ]

    EXCEPTIONS = {
        "γεια": "ʝa",
        "και": "kɛ",
    }


EXT_ENGINES: Dict[str, type] = {
    "sk": SlovakG2P,
    "hr": CroatianG2P,
    "sl": SlovenianG2P,
    "lt": LithuanianG2P,
    "lv": LatvianG2P,
    "et": EstonianG2P,
    "bg": BulgarianG2P,
    "uk": UkrainianG2P,
    "el": GreekG2P,
}
