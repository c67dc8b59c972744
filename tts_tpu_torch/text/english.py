"""Copied from ``tts_tpu/text/english.py`` (the port imports nothing of ``tts_tpu``);
unchanged apart from this line.

English text normalization: numbers, times, abbreviations.

Feature-equivalent rebuild of the reference's
``TTS/tts/utils/text/english/{number_norm,time_norm,abbreviations}.py``.
The reference delegates number verbalization to the ``inflect`` package;
here it is implemented directly (integers, ordinals, decimals, currency,
year-style pronunciation for 4-digit numbers).
"""

from __future__ import annotations

import re

# ---------------------------------------------------------------------------
# number → words
# ---------------------------------------------------------------------------

_ONES = [
    "zero", "one", "two", "three", "four", "five", "six", "seven", "eight",
    "nine", "ten", "eleven", "twelve", "thirteen", "fourteen", "fifteen",
    "sixteen", "seventeen", "eighteen", "nineteen",
]
_TENS = [
    "", "", "twenty", "thirty", "forty", "fifty", "sixty", "seventy",
    "eighty", "ninety",
]
_SCALES = [
    (10**12, "trillion"),
    (10**9, "billion"),
    (10**6, "million"),
    (10**3, "thousand"),
    (10**2, "hundred"),
]

_ORDINAL_IRREGULAR = {
    "one": "first",
    "two": "second",
    "three": "third",
    "five": "fifth",
    "eight": "eighth",
    "nine": "ninth",
    "twelve": "twelfth",
}


def _number_below_1000(n: int) -> str:
    parts = []
    if n >= 100:
        parts.append(_ONES[n // 100] + " hundred")
        n %= 100
    if n >= 20:
        if n % 10:
            parts.append(_TENS[n // 10] + "-" + _ONES[n % 10])
        else:
            parts.append(_TENS[n // 10])
    elif n > 0 or not parts:
        parts.append(_ONES[n])
    return " ".join(parts)


def number_to_words(n: int) -> str:
    """Integer to English words ("1234" → "one thousand two hundred thirty-four")."""
    if n < 0:
        return "minus " + number_to_words(-n)
    if n < 1000:
        return _number_below_1000(n)
    parts = []
    for value, name in _SCALES:
        if value == 100:
            continue
        if n >= value:
            parts.append(number_to_words(n // value) + " " + name)
            n %= value
    if n > 0:
        parts.append(_number_below_1000(n))
    return " ".join(parts)


def ordinal_to_words(n: int) -> str:
    """Integer to English ordinal words ("2" → "second")."""
    words = number_to_words(n)
    pieces = words.rsplit(" ", 1)
    last = pieces[-1]
    if "-" in last:
        head, tail = last.rsplit("-", 1)
        last_ord = head + "-" + _ordinalize_word(tail)
    else:
        last_ord = _ordinalize_word(last)
    pieces[-1] = last_ord
    return " ".join(pieces)


def _ordinalize_word(w: str) -> str:
    if w in _ORDINAL_IRREGULAR:
        return _ORDINAL_IRREGULAR[w]
    if w.endswith("y"):
        return w[:-1] + "ieth"
    if w.endswith("hundred") or w.endswith("thousand") or w.endswith("llion"):
        return w + "th"
    return w + "th"


def _two_digit(n: int) -> str:
    return _number_below_1000(n)


def year_to_words(n: int) -> str:
    """4-digit year pronunciation ("1999" → "nineteen ninety-nine")."""
    if n < 1000 or n > 3000:
        return number_to_words(n)
    if n % 1000 < 100 and n % 1000 != 0:  # 1905 -> nineteen oh five
        if n % 100 < 10 and n % 100 != 0:
            return _two_digit(n // 100) + " oh " + _ONES[n % 100]
    if n % 100 == 0:
        if n % 1000 == 0:
            return number_to_words(n)
        return _two_digit(n // 100) + " hundred"
    return _two_digit(n // 100) + " " + _two_digit(n % 100)


# ---------------------------------------------------------------------------
# regex pipeline (reference number_norm.py)
# ---------------------------------------------------------------------------

_comma_number_re = re.compile(r"([0-9][0-9\,]+[0-9])")
_decimal_number_re = re.compile(r"([0-9]+\.[0-9]+)")
_currency_re = re.compile(r"(£|\$|¥)([0-9\,\.]*[0-9]+)")
_ordinal_re = re.compile(r"[0-9]+(st|nd|rd|th)")
_number_re = re.compile(r"-?[0-9]+")


def _remove_commas(m):
    return m.group(1).replace(",", "")


def _expand_decimal_point(m):
    int_part, frac = m.group(1).split(".")
    digits = " ".join(_ONES[int(d)] for d in frac)
    return number_to_words(int(int_part)) + " point " + digits


def _expand_currency(m):
    unit_names = {"£": ("pound", "pence"), "$": ("dollar", "cent"), "¥": ("yen", None)}
    unit, sub = unit_names[m.group(1)]
    amount = m.group(2).replace(",", "")
    if "." in amount:
        whole_s, frac_s = amount.split(".")
        whole = int(whole_s) if whole_s else 0
        frac = int((frac_s + "0")[:2]) if frac_s else 0
    else:
        whole, frac = int(amount), 0
    parts = []
    if whole or not frac:
        unit_w = unit if (whole == 1 and unit != "yen") else (unit + "s" if unit != "yen" else unit)
        parts.append(number_to_words(whole) + " " + unit_w)
    if frac and sub:
        sub_w = sub if frac == 1 and sub != "pence" else (sub + "s" if sub == "cent" else sub)
        parts.append(number_to_words(frac) + " " + sub_w)
    return ", ".join(parts)


def _expand_ordinal(m):
    return ordinal_to_words(int(m.group(0)[:-2]))


def _expand_number(m):
    num = int(m.group(0))
    if 1000 < num < 3000:
        if num == 2000:
            return "two thousand"
        if 2000 < num < 2010:
            return "two thousand " + number_to_words(num % 100)
        return year_to_words(num)
    return number_to_words(num)


def normalize_numbers(text: str) -> str:
    """Expand numeric expressions to words (reference ``number_norm.py:86``)."""
    text = re.sub(_comma_number_re, _remove_commas, text)
    text = re.sub(_currency_re, _expand_currency, text)
    text = re.sub(_decimal_number_re, _expand_decimal_point, text)
    text = re.sub(_ordinal_re, _expand_ordinal, text)
    text = re.sub(_number_re, _expand_number, text)
    return text


# ---------------------------------------------------------------------------
# time ("3:30pm" → "three thirty pm"; reference time_norm.py)
# ---------------------------------------------------------------------------

_time_re = re.compile(
    r"\b((0?[0-9])|(1[0-1])|(1[2-9])|(2[0-3]))" r":([0-5][0-9])\s*(a\.m\.|am|pm|p\.m\.|a\.m|p\.m)?\b"
)


def _expand_time(m):
    hour = int(m.group(1))
    minute = int(m.group(6))
    ampm = m.group(7)
    parts = [number_to_words(hour)]
    if minute == 0:
        if not ampm:
            parts.append("o'clock")
    elif minute < 10:
        parts.append("oh " + _ONES[minute])
    else:
        parts.append(_two_digit(minute))
    if ampm:
        parts.append(ampm.replace(".", " ").strip())
    return " ".join(parts)


def expand_time_english(text: str) -> str:
    return re.sub(_time_re, _expand_time, text)


# ---------------------------------------------------------------------------
# abbreviations (reference english/abbreviations.py, french/abbreviations.py)
# ---------------------------------------------------------------------------

abbreviations_en = [
    (re.compile(r"\b%s\." % abbr, re.IGNORECASE), full)
    for abbr, full in [
        ("mrs", "misess"),
        ("mr", "mister"),
        ("dr", "doctor"),
        ("st", "saint"),
        ("co", "company"),
        ("jr", "junior"),
        ("maj", "major"),
        ("gen", "general"),
        ("drs", "doctors"),
        ("rev", "reverend"),
        ("lt", "lieutenant"),
        ("hon", "honorable"),
        ("sgt", "sergeant"),
        ("capt", "captain"),
        ("esq", "esquire"),
        ("ltd", "limited"),
        ("col", "colonel"),
        ("ft", "fort"),
    ]
]

abbreviations_fr = [
    (re.compile(r"\b%s\." % abbr, re.IGNORECASE), full)
    for abbr, full in [
        ("M", "monsieur"),
        ("Mlle", "mademoiselle"),
        ("Mlles", "mesdemoiselles"),
        ("Mme", "Madame"),
        ("Mmes", "Mesdames"),
        ("N.B", "nota bene"),
        ("p.c.q", "parce que"),
        ("Pr", "professeur"),
        ("qqch", "quelque chose"),
        ("rdv", "rendez-vous"),
        ("max", "maximum"),
        ("min", "minimum"),
        ("no", "numéro"),
        ("adr", "adresse"),
        ("dr", "docteur"),
        ("st", "saint"),
        ("co", "companie"),
        ("jr", "junior"),
        ("sgt", "sergent"),
        ("capt", "capitain"),
        ("col", "colonel"),
        ("av", "avenue"),
        ("av. J.-C", "avant Jésus-Christ"),
        ("apr. J.-C", "après Jésus-Christ"),
        ("art", "article"),
        ("boul", "boulevard"),
        ("c.-à-d", "c’est-à-dire"),
        ("etc", "et cetera"),
        ("ex", "exemple"),
        ("excl", "exclusivement"),
    ]
] + [
    # titles also expand without a trailing dot (reference
    # french/abbreviations.py:41-48)
    (re.compile(r"\b%s" % abbr), full)
    for abbr, full in [
        ("Mlles", "mesdemoiselles"),
        ("Mlle", "mademoiselle"),
        ("Mmes", "Mesdames"),
        ("Mme", "Madame"),
    ]
]
