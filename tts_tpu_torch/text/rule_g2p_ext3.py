"""Copied from ``tts_tpu/text/rule_g2p_ext3.py`` (the port imports nothing of ``tts_tpu``);
unchanged apart from this line and the package named in this docstring.

Offline rule-G2P fallback, third set: da/sv/ga/mt (Latin) and fa
(Perso-Arabic script).

Same contract as ``tts_tpu_torch.text.latin_g2p`` (shared :class:`RuleG2P`
machinery): the reference reaches these languages only through the espeak
binary (``TTS/tts/utils/text/phonemizers/espeak_wrapper.py:47-83``), so
with espeak absent its ``use_phonemes`` zoo configs (da/ga/mt/sv
Common-Voice VITS and the fa custom GlowTTS in ``.models.json``) silently
degrade to graphemes.  Broad-transcription simplifications, called out per
engine:

* Danish: stød is dropped (it is suprasegmental and untranscribable in the
  ``IPAPhonemes`` charset); vowel-quality lowering around /r/ is
  approximated; soft d/g lenition is applied by context rules.
* Swedish: tonal word accent is dropped; the sj-sound is transcribed ɧ and
  retroflexion of r+coronal clusters is applied.
* Irish: Connacht-leaning; consonant slenderization is marked with ʲ the
  same way the Ukrainian engine keeps the soft sign (orthography makes the
  broad/slender split recoverable — caol le caol).
* Maltese: għ and h are silent (standard pronunciation), gemination is
  kept as ``ː``, word-final obstruents devoice.
* Persian: the script omits short vowels, so segments come from (1) a
  frequent-word lexicon with full vocalization, (2) long vowels and
  consonants read off the script, (3) /e/ epenthesis to break the
  consonant clusters Persian phonotactics forbid.  Stress is word-final
  (the regular Persian pattern for nouns/adjectives).

Output stays inside the ``IPAPhonemes`` charset.  Engines register through
``latin_g2p.get_latin_g2p`` so phonemizer selection logic is unchanged.
"""

from __future__ import annotations

import re
from typing import Dict

from .latin_g2p import RuleG2P

# ---------------------------------------------------------------------------
# Danish — soft d (ð) and soft g by context, å/æ/ø qualities, coda r
# vocalizes to ɐ, initial stress default.  Stød dropped (broad).
# ---------------------------------------------------------------------------

_DA_V = "[aeiouyæøå]"


class DanishG2P(RuleG2P):
    VOWEL_LETTERS = "aeiouyæøå"

    RULES = [
        # digraphs first
        ("", "aa", "", "ɔː"),
        ("", "ej", "", "ɑj"),
        ("", "eg", "$", "ɑj"),  # jeg, dejg-like codas
        ("", "øj", "", "ʌj"),
        ("", "av", "", "ɑw"),
        ("", "af", "$", "ɑw"),
        ("", "ov", "", "ʌw"),
        ("", "ng", "", "ŋ"),
        ("", "kk", "", "k"),
        ("", "pp", "", "p"),
        ("", "tt", "", "t"),
        ("", "bb", "", "b"),
        ("", "dd", "", "d"),
        ("", "gg", "", "ɡ"),
        ("", "ll", "", "l"),
        ("", "mm", "", "m"),
        ("", "nn", "", "n"),
        ("", "rr", "", "ʁ"),
        ("", "ss", "", "s"),
        ("", "ff", "", "f"),
        # sj / sk+j
        ("", "sj", "", "ɕ"),
        ("^", "hj", "", "j"),
        ("^", "hv", "", "v"),
        # soft d: after a vowel, word-final or before e/schwa ("gade",
        # "mad"); hard after l/n/r where it is silent instead
        ("[lnr]", "d", "$", ""),
        ("[lnr]", "d", "e$", "ə"),  # "-lde/-nde": d silent, e → schwa
        (_DA_V, "d", "$", "ð"),
        (_DA_V, "d", "e", "ð"),
        # soft g: after a vowel word-final it lenites/vanishes ("dag"),
        # lengthening that vowel (the vowel rules below see the g coming)
        ("", "a", "g$", "æː"),
        ("", "o", "g$", "oː"),
        ("", "e", "g$", "ɑj"),
        ("", "u", "g$", "uː"),
        ("", "y", "g$", "yː"),
        ("", "ø", "g$", "øː"),
        ("", "å", "g$", "ɔː"),
        ("", "o", "r$", "o"),
        ("", "o", "l$", "oː"),
        (_DA_V, "g", "$", ""),
        # vowels — long in open syllable (single consonant + vowel)
        ("", "a", "[bdfghjklmnpstv]" + _DA_V, "æː"),
        ("", "a", "[rk]", "ɑ"),
        ("r", "a", "", "ɑ"),
        ("", "a", "", "a"),
        ("", "e", "$", "ə"),
        ("", "e", "[bdfghjklmnpstv]" + _DA_V, "eː"),
        ("", "e", "r$", "ə"),  # unstressed -er
        ("", "e", "", "ɛ"),
        ("", "i", "[bdfghjklmnpstv]" + _DA_V, "iː"),
        ("", "i", "", "i"),
        ("", "o", "[bdfghjklmnpstv]" + _DA_V, "oː"),
        ("", "o", "", "ʌ"),
        ("", "u", "[bdfghjklmnpstv]" + _DA_V, "uː"),
        ("", "u", "", "u"),
        ("", "y", "[bdfghjklmnpstv]" + _DA_V, "yː"),
        ("", "y", "", "y"),
        ("", "æ", "[bdfghjklmnpstv]" + _DA_V, "ɛː"),
        ("", "æ", "", "ɛ"),
        ("", "ø", "[bdfghjklmnpstv]" + _DA_V, "øː"),
        ("", "ø", "", "ø"),
        ("", "å", "[bdfghjklmnpstv]" + _DA_V, "ɔː"),
        ("", "å", "", "ɔ"),
        # consonants
        ("", "r", "$", "ɐ"),  # coda r vocalizes
        ("", "r", "[bdfghjklmnpstv]", "ɐ"),
        ("", "r", "", "ʁ"),
        ("", "v", "$", "w"),
        ("", "g", "", "ɡ"),
        ("", "c", "[eiy]", "s"),
        ("", "c", "", "k"),
        ("", "w", "", "v"),
        ("", "x", "", "ks"),
        ("", "z", "", "s"),
    ] + [("", c, "", c) for c in "bdfhjklmnpstv"]

    EXCEPTIONS = {
        "og": "ʌw",
        "jeg": "jɑj",
        "det": "de",
        "er": "ɛɐ",
        "ikke": "ˈeɡə",
        "hvad": "væð",
        "hvor": "vɔɐ",
        "de": "di",
    }

    def default_stress_index(self, word, n_nuclei):
        return 0


# ---------------------------------------------------------------------------
# Swedish — sj-sound ɧ, tj-sound ɕ, k/g/sk softening before front vowels,
# retroflexion of r+coronal, quantity from syllable shape.  Word accents
# (acute/grave tones) dropped (broad).
# ---------------------------------------------------------------------------

_SV_V = "[aeiouyäåö]"
_SV_FRONT = "[eiyäö]"


class SwedishG2P(RuleG2P):
    VOWEL_LETTERS = "aeiouyäåö"

    RULES = [
        # sj-sound spellings
        ("", "stj", "", "ɧ"),
        ("", "skj", "", "ɧ"),
        ("", "sj", "", "ɧ"),
        ("", "sk", _SV_FRONT, "ɧ"),
        ("", "sch", "", "ɧ"),
        ("", "ssion", "", "ɧuːn"),
        ("", "tion", "", "ɧuːn"),
        # tj-sound
        ("", "tj", "", "ɕ"),
        ("", "kj", "", "ɕ"),
        ("^", "k", _SV_FRONT, "ɕ"),
        ("^", "g", _SV_FRONT, "j"),
        # retroflexion
        ("", "rs", "", "ʂ"),
        ("", "rt", "", "ʈ"),
        ("", "rd", "", "ɖ"),
        ("", "rn", "", "ɳ"),
        ("", "rl", "", "ɭ"),
        # clusters / digraphs
        ("", "ng", "", "ŋ"),
        ("", "gn", "", "ŋn"),
        ("", "ck", "", "k"),
        ("^", "dj", "", "j"),
        ("^", "hj", "", "j"),
        ("^", "lj", "", "j"),
        ("", "kk", "", "k"),
        ("", "pp", "", "p"),
        ("", "tt", "", "t"),
        ("", "bb", "", "b"),
        ("", "dd", "", "d"),
        ("", "gg", "", "ɡ"),
        ("", "ll", "", "l"),
        ("", "mm", "", "m"),
        ("", "nn", "", "n"),
        ("", "rr", "", "r"),
        ("", "ss", "", "s"),
        ("", "ff", "", "f"),
        # vowels: long in open syllable (single consonant + vowel) or
        # word-final, else short
        ("", "a", "[bdfghjklmnprstv](?:" + _SV_V + "|$)", "ɑː"),
        ("", "a", "", "a"),
        # unstressed suffixes -en/-er/-el/-et keep a short vowel
        ("" , "e", "[nrlt]$", "ɛ"),
        ("", "e", "[bdfghjklmnprstv](?:" + _SV_V + "|$)|$", "eː"),
        ("", "e", "", "ɛ"),
        ("", "i", "[bdfghjklmnprstv](?:" + _SV_V + "|$)|$", "iː"),
        ("", "i", "", "ɪ"),
        ("", "o", "[bdfghjklmnprstv](?:" + _SV_V + "|$)|$", "uː"),
        ("", "o", "", "ɔ"),
        ("", "u", "[bdfghjklmnprstv](?:" + _SV_V + "|$)|$", "ʉː"),
        ("", "u", "", "ɵ"),
        ("", "y", "[bdfghjklmnprstv](?:" + _SV_V + "|$)|$", "yː"),
        ("", "y", "", "ʏ"),
        ("", "ä", "[bdfghjklmnprstv](?:" + _SV_V + "|$)|$", "ɛː"),
        ("", "ä", "", "ɛ"),
        ("", "å", "[bdfghjklmnprstv](?:" + _SV_V + "|$)|$", "oː"),
        ("", "å", "", "ɔ"),
        ("", "ö", "[bdfghjklmnprstv](?:" + _SV_V + "|$)|$", "øː"),
        ("", "ö", "", "œ"),
        # consonants
        ("", "g", "", "ɡ"),
        ("", "c", "[eiy]", "s"),
        ("", "c", "", "k"),
        ("", "w", "", "v"),
        ("", "x", "", "ks"),
        ("", "z", "", "s"),
        ("", "q", "", "k"),
    ] + [("", c, "", c) for c in "bdfhjklmnprstv"]

    EXCEPTIONS = {
        "och": "ɔk",
        "jag": "jɑː",
        "det": "deː",
        "är": "ɛː",
        "de": "dɔm",
        "mig": "mɛj",
        "dig": "dɛj",
        "sig": "sɛj",
    }


# ---------------------------------------------------------------------------
# Irish — broad/slender consonants recovered from the flanking-vowel rule
# (caol le caol agus leathan le leathan), lenition digraphs (bh/mh/dh/gh/
# th/sh/fh/ch), fada long vowels, initial stress (Connacht default).
# ---------------------------------------------------------------------------

_GA_SLENDER = "[eiéí]"


class IrishG2P(RuleG2P):
    VOWEL_LETTERS = "aeiouáéíóú"

    RULES = [
        # lenited digraphs (context decides broad w~v vs slender vʲ/j)
        ("", "fh", "", ""),
        ("", "bh", _GA_SLENDER, "vʲ"),
        (_GA_SLENDER, "bh", "", "vʲ"),
        ("", "bh", "", "w"),
        ("", "mh", _GA_SLENDER, "vʲ"),
        (_GA_SLENDER, "mh", "", "vʲ"),
        ("", "mh", "", "w"),
        ("", "dh", _GA_SLENDER, "j"),
        (_GA_SLENDER, "dh", "$", ""),
        ("", "dh", "$", ""),
        ("", "dh", "", "ɣ"),
        ("", "gh", _GA_SLENDER, "j"),
        (_GA_SLENDER, "gh", "$", ""),
        ("", "gh", "$", ""),
        ("", "gh", "", "ɣ"),
        ("", "th", "$", "h"),
        ("", "th", "", "h"),
        ("", "sh", "", "h"),
        ("", "ch", _GA_SLENDER, "ç"),
        (_GA_SLENDER, "ch", "", "ç"),
        ("", "ch", "", "x"),
        # slender s → ʃ (the one alternation everyone hears)
        ("", "s", _GA_SLENDER, "ʃ"),
        (_GA_SLENDER, "s", "", "ʃ"),
        # slender coronals/labials/velars marked ʲ
        ("", "t", _GA_SLENDER, "tʲ"),
        (_GA_SLENDER, "t", "", "tʲ"),
        ("", "d", _GA_SLENDER, "dʲ"),
        (_GA_SLENDER, "d", "", "dʲ"),
        ("", "n", _GA_SLENDER, "nʲ"),
        (_GA_SLENDER, "n", "", "nʲ"),
        ("", "l", _GA_SLENDER, "lʲ"),
        (_GA_SLENDER, "l", "", "lʲ"),
        ("", "r", _GA_SLENDER, "ɾʲ"),
        (_GA_SLENDER, "r", "", "ɾʲ"),
        ("", "c", _GA_SLENDER, "c"),
        (_GA_SLENDER, "c", "", "c"),
        ("", "g", _GA_SLENDER, "ɟ"),
        (_GA_SLENDER, "g", "", "ɟ"),
        # vowel digraphs (glide vowels mark consonant quality; the spoken
        # nucleus is the marked/long member)
        ("", "aío", "", "iː"),
        ("", "aoi", "", "iː"),
        ("", "ao", "", "iː"),
        ("", "eái", "", "aː"),
        ("", "eá", "", "aː"),
        ("", "éa", "", "eː"),
        ("", "éi", "", "eː"),
        ("", "ái", "", "aː"),
        ("", "eai", "", "a"),
        ("", "ea", "", "a"),
        ("", "ai", "", "a"),
        ("", "ei", "", "e"),
        ("", "eoi", "", "oː"),
        ("", "eo", "", "oː"),
        ("", "iú", "", "uː"),
        ("", "ío", "", "iː"),
        ("", "ia", "", "iə"),
        ("", "ua", "", "uə"),
        ("", "uí", "", "iː"),
        ("", "ui", "", "i"),
        ("", "io", "", "i"),
        ("", "iu", "", "u"),
        ("", "ói", "", "oː"),
        ("", "oí", "", "iː"),
        ("", "oi", "", "e"),
        ("", "úi", "", "uː"),
        ("", "aí", "", "iː"),
        ("", "á", "", "aː"),
        ("", "é", "", "eː"),
        ("", "í", "", "iː"),
        ("", "ó", "", "oː"),
        ("", "ú", "", "uː"),
        # final unstressed e reduces to schwa
        ("", "e", "$", "ə"),
        # plain consonants (broad)
        ("", "c", "", "k"),
        ("", "g", "", "ɡ"),
        ("", "r", "", "ɾ"),
        ("", "v", "", "v"),
        ("", "p", "", "p"),
    ] + [("", c, "", c) for c in "abdefhijlmnostu"]

    EXCEPTIONS = {
        "agus": "ˈaɡəs",
        "go": "ɡə",
        "an": "ən",
        "na": "nə",
        "is": "əs",
        "raibh": "ɾɛvʲ",
    }

    def default_stress_index(self, word, n_nuclei):
        return 0


# ---------------------------------------------------------------------------
# Maltese — near-phonemic Latin orthography with Semitic consonants:
# x → ʃ, ħ → ħ, q → ʔ, għ/h silent, z → ts vs ż → z, gemination kept.
# ---------------------------------------------------------------------------

_MT_V = "[aeiou]"


class MalteseG2P(RuleG2P):
    VOWEL_LETTERS = "aeiou"

    RULES = [
        ("", "għi", "", "aj"),  # għi ≈ /ej/~/aj/ broadly
        ("", "għu", "", "aw"),
        ("", "għ", "$", "ħ"),  # word-final għ is pronounced ħ
        ("", "għ", "", ""),  # otherwise silent (vowel colouring dropped)
        ("", "ie", "", "iː"),
        # geminates → long consonant
        ("", "bb", "", "bː"),
        ("", "ċċ", "", "tːʃ"),
        ("", "dd", "", "dː"),
        ("", "ff", "", "fː"),
        ("", "ġġ", "", "dːʒ"),
        ("", "gg", "", "ɡː"),
        ("", "ħħ", "", "ħː"),
        ("", "jj", "", "jː"),
        ("", "kk", "", "kː"),
        ("", "ll", "", "lː"),
        ("", "mm", "", "mː"),
        ("", "nn", "", "nː"),
        ("", "pp", "", "pː"),
        ("", "qq", "", "ʔː"),
        ("", "rr", "", "rː"),
        ("", "ss", "", "sː"),
        ("", "tt", "", "tː"),
        ("", "vv", "", "vː"),
        ("", "ww", "", "wː"),
        ("", "xx", "", "ʃː"),
        ("", "zz", "", "tːs"),
        ("", "żż", "", "zː"),
        # single letters
        ("", "ċ", "", "tʃ"),
        ("", "ġ", "$", "tʃ"),  # final devoicing
        ("", "ġ", "", "dʒ"),
        ("", "ħ", "", "ħ"),
        ("", "h", "", ""),  # silent
        ("", "x", "", "ʃ"),
        ("", "z", "", "ts"),
        ("", "ż", "$", "s"),
        ("", "ż", "", "z"),
        ("", "q", "", "ʔ"),
        ("", "b", "$", "p"),
        ("", "d", "$", "t"),
        ("", "g", "$", "k"),
        ("", "g", "", "ɡ"),
        ("", "v", "$", "f"),
        ("", "w", "", "w"),
        ("", "j", "", "j"),
        ("", "c", "", "k"),
        ("", "y", "", "j"),
    ] + [("", c, "", c) for c in "abdefiklmnoprstuv"]

    EXCEPTIONS = {
        "hi": "iː",
        "hu": "uː",
        "huwa": "ˈuwa",
        "hija": "ˈija",
    }


# ---------------------------------------------------------------------------
# Persian (Farsi) — Perso-Arabic script.  Consonants and long vowels are
# read off the script; short vowels are unwritten, recovered from a
# frequent-word lexicon or approximated by /e/ epenthesis where Persian
# phonotactics forbid the written consonant cluster (no onset clusters).
# Stress: word-final (regular for nouns/adjectives).
# ---------------------------------------------------------------------------

_FA_CONS = {
    "ب": "b", "پ": "p", "ت": "t", "ث": "s", "ج": "dʒ", "چ": "tʃ",
    "ح": "h", "خ": "x", "د": "d", "ذ": "z", "ر": "ɾ", "ز": "z",
    "ژ": "ʒ", "س": "s", "ش": "ʃ", "ص": "s", "ض": "z", "ط": "t",
    "ظ": "z", "ع": "ʔ", "غ": "ɣ", "ف": "f", "ق": "ɣ", "ک": "k",
    "ك": "k", "گ": "ɡ", "ل": "l", "م": "m", "ن": "n", "ه": "h",
    "ة": "t", "ء": "ʔ", "ئ": "ʔ", "ؤ": "ʔ",
}

# harakat (rarely written, honored when present)
_FA_DIACRITICS = {"َ": "æ", "ِ": "e", "ُ": "o", "ْ": ""}

_FA_LEXICON = {
    "سلام": "sælɒːm", "من": "mæn", "تو": "to", "او": "uː", "ما": "mɒː",
    "شما": "ʃomɒː", "است": "æst", "هست": "hæst", "بود": "buːd",
    "ایران": "iːɾɒːn", "خوب": "xuːb", "بد": "bæd", "آب": "ɒːb",
    "نان": "nɒːn", "دوست": "duːst", "کتاب": "ketɒːb", "بله": "bæle",
    "نه": "næ", "شب": "ʃæb", "روز": "ɾuːz", "سال": "sɒːl",
    "چه": "tʃe", "که": "ke", "در": "dæɾ", "به": "be",
    "از": "æz", "با": "bɒː", "را": "ɾɒː", "و": "væ", "این": "iːn",
    "آن": "ɒːn", "یک": "jek", "دو": "do", "سه": "se", "چهار": "tʃæhɒːɾ",
    "پنج": "pændʒ", "شش": "ʃeʃ", "هفت": "hæft", "هشت": "hæʃt",
    "نُه": "noh", "ده": "dæh", "صد": "sæd", "هزار": "hezɒːɾ",
    "زن": "zæn", "مرد": "mæɾd", "بچه": "bætʃtʃe", "خانه": "xɒːne",
    "شهر": "ʃæhɾ", "کشور": "keʃvæɾ", "زبان": "zæbɒːn",
    "فارسی": "fɒːɾsiː", "سلامت": "sælɒːmæt", "خدا": "xodɒː",
    "بزرگ": "bozoɾɡ", "کوچک": "kuːtʃek", "نو": "now", "کهنه": "kohne",
    "سفید": "sefiːd", "سیاه": "siːɒːh", "سرخ": "soɾx", "سبز": "sæbz",
    "آبی": "ɒːbiː", "زرد": "zæɾd", "امروز": "emɾuːz", "فردا": "fæɾdɒː",
    "دیروز": "diːɾuːz", "حالا": "hɒːlɒː", "وقت": "væɣt", "کار": "kɒːɾ",
    "راه": "ɾɒːh", "دست": "dæst", "پا": "pɒː", "سر": "sæɾ",
    "چشم": "tʃeʃm", "دل": "del", "جان": "dʒɒːn", "نام": "nɒːm",
    "اسم": "esm", "چیز": "tʃiːz", "هم": "hæm", "همه": "hæme",
    "هیچ": "hiːtʃ", "خیلی": "xejliː", "کم": "kæm", "زیاد": "ziːɒːd",
    "مادر": "mɒːdæɾ", "پدر": "pedæɾ", "برادر": "bæɾɒːdæɾ",
    "خواهر": "xɒːhæɾ", "پسر": "pesæɾ", "دختر": "doxtæɾ",
    "دنیا": "donjɒː", "زندگی": "zendeɡiː", "عشق": "eʃɣ",
    "موسیقی": "muːsiːɣiː", "صدا": "sedɒː", "آواز": "ɒːvɒːz",
}

_FA_VOWEL_IPA = set("ɒæeiou")


class PersianG2P(RuleG2P):
    """Engine with its own transducer — the Arabic-script logic (positional
    ا/و/ی readings, epenthesis) does not fit the ordered-rule scheme."""

    VOWEL_LETTERS = "اآویً"

    def default_stress_index(self, word, n_nuclei):
        return n_nuclei - 1

    def _transduce(self, word: str) -> str:
        # strip tatweel and normalize Arabic variants
        word = word.replace("ـ", "").replace("ي", "ی").replace("أ", "ا").replace("إ", "ا")
        out = []
        n = len(word)
        for i, ch in enumerate(word):
            prev_v = bool(out) and out[-1] and out[-1][-1] in _FA_VOWEL_IPA | {"ː"}
            if ch == "آ":
                out.append("ɒː")
            elif ch == "ا":
                if i == 0:
                    # initial alef carries an unwritten short vowel; the
                    # following letter decides it only in the lexicon —
                    # default /æ/ unless it precedes و/ی (then it is the
                    # long-vowel seat and stays silent)
                    nxt = word[i + 1] if i + 1 < n else ""
                    out.append("" if nxt in "وی" else "æ")
                else:
                    out.append("ɒː")
            elif ch == "و":
                if i == 0:
                    out.append("v")
                elif prev_v:
                    out.append("v")
                else:
                    out.append("uː")
            elif ch == "ی":
                if i == 0:
                    out.append("j")
                elif prev_v:
                    out.append("j")
                else:
                    out.append("iː")
            elif ch in _FA_CONS:
                # final ه after a consonant is usually the silent -e marker
                if ch == "ه" and i == n - 1 and not prev_v and i > 0:
                    out.append("e")
                else:
                    out.append(_FA_CONS[ch])
            elif ch in _FA_DIACRITICS:
                out.append(_FA_DIACRITICS[ch])
            # anything else (ZWNJ handled upstream, digits, latin) drops
        phones = "".join(out)
        return self._epenthesize(phones)

    @staticmethod
    def _epenthesize(phones: str) -> str:
        """Insert /e/ so every consonant run is syllabifiable: Persian
        allows no onset clusters and at most CC codas."""
        units = []
        i = 0
        while i < len(phones):
            if phones[i : i + 2] in ("dʒ", "tʃ"):
                units.append(phones[i : i + 2])
                i += 2
            elif phones[i + 1 : i + 2] == "ː":
                units.append(phones[i : i + 2])
                i += 2
            else:
                units.append(phones[i])
                i += 1
        is_v = [u[0] in _FA_VOWEL_IPA for u in units]
        if not units:
            return phones
        # final -Cn (infinitives -تن/-دن, plural -ان read off consonant
        # skeletons) takes the regular /æ/ nucleus before the n
        if len(units) >= 2 and units[-1] == "n" and not is_v[-2]:
            units.insert(len(units) - 1, "æ")
            is_v.insert(len(is_v) - 1, True)
        out = []
        run = 0  # consonants since the last vowel
        any_vowel_ahead_done = False
        for k, (u, v) in enumerate(zip(units, is_v)):
            if v:
                run = 0
                any_vowel_ahead_done = True
                out.append(u)
                continue
            # before appending a consonant: if we already have 2 consonants
            # since the last vowel and another follows, break with /e/
            if run >= 2:
                out.append("e")
                run = 0
                any_vowel_ahead_done = True
            # a cluster at word start (no vowel yet) breaks after the first C
            elif run == 1 and not any_vowel_ahead_done:
                out.append("e")
                run = 0
                any_vowel_ahead_done = True
            out.append(u)
            run += 1
        # a word that ended with 3+ consonants got fixed above; a word with
        # no vowel at all ("من" lexicon-missed shapes) gets a final /e/? no —
        # give it a default /æ/ nucleus before the last consonant instead
        s = "".join(out)
        if not any(c in _FA_VOWEL_IPA for c in s) and len(units) >= 2:
            s = s[:-len(units[-1])] + "æ" + units[-1]
        return s

    def phonemize_word(self, word: str) -> str:
        word = word.strip()
        # ZWNJ joins compound members: phonemize each part, stress the last
        if "‌" in word:
            parts = [p for p in word.split("‌") if p]
            return "".join(self.phonemize_word(p).replace("ˈ", "") for p in parts[:-1]) + (
                self.phonemize_word(parts[-1]) if parts else ""
            )
        hit = _FA_LEXICON.get(word)
        if hit is not None:
            return self._place_stress(word, hit)
        return self._place_stress(word, self._transduce(word))

    def phonemize(self, text: str, separator: str = "") -> str:
        parts = []
        for token in text.split():
            m = re.match(r"^(\W*)(.*?)(\W*)$", token, re.UNICODE)
            pre, core, post = m.groups()
            parts.append(pre + (self.phonemize_word(core) if core else "") + post)
        return " ".join(parts)


EXT_ENGINES3: Dict[str, type] = {
    "da": DanishG2P,
    "sv": SwedishG2P,
    "ga": IrishG2P,
    "mt": MalteseG2P,
    "fa": PersianG2P,
}
