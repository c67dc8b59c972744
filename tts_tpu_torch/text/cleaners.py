"""Copied from ``tts_tpu/text/cleaners.py`` (the port imports nothing of ``tts_tpu``);
unchanged apart from this line.

Text cleaner pipelines (reference ``TTS/tts/utils/text/cleaners.py``).

Each cleaner is a ``str -> str`` function referenced by name from model
configs (``text_cleaner`` field).
"""

from __future__ import annotations

import re

from .english import abbreviations_en, abbreviations_fr, expand_time_english, normalize_numbers

_whitespace_re = re.compile(r"\s+")


def expand_abbreviations(text: str, lang: str = "en") -> str:
    abbreviations = abbreviations_en if lang == "en" else abbreviations_fr
    for regex, replacement in abbreviations:
        text = re.sub(regex, replacement, text)
    return text


def lowercase(text: str) -> str:
    return text.lower()


def collapse_whitespace(text: str) -> str:
    return re.sub(_whitespace_re, " ", text).strip()


def remove_aux_symbols(text: str) -> str:
    return re.sub(r"[\<\>\(\)\[\]\"]+", "", text)


def replace_symbols(text: str, lang: str = "en") -> str:
    """Language-aware symbol spelling (reference ``cleaners.py:46``)."""
    text = text.replace(";", ",")
    text = text.replace("-", " ") if lang != "ca" else text.replace("-", "")
    text = text.replace(":", ",")
    if lang == "en":
        text = text.replace("&", " and ")
    elif lang == "fr":
        text = text.replace("&", " et ")
    elif lang == "pt":
        text = text.replace("&", " e ")
    elif lang == "ca":
        text = text.replace("&", " i ")
        text = text.replace("'", "")
    return text


def basic_cleaners(text: str) -> str:
    """Lowercase + collapse whitespace, no transliteration."""
    return collapse_whitespace(lowercase(text))


def transliteration_cleaners(text: str) -> str:
    return collapse_whitespace(lowercase(text))


def basic_german_cleaners(text: str) -> str:
    return collapse_whitespace(lowercase(text))


def basic_turkish_cleaners(text: str) -> str:
    text = text.replace("I", "ı")
    return collapse_whitespace(lowercase(text))


def english_cleaners(text: str) -> str:
    """Lowercase, expand times/numbers/abbreviations, normalize symbols."""
    text = lowercase(text)
    text = expand_time_english(text)
    text = normalize_numbers(text)
    text = expand_abbreviations(text)
    text = replace_symbols(text)
    text = remove_aux_symbols(text)
    return collapse_whitespace(text)


def phoneme_cleaners(text: str) -> str:
    """Pre-phonemization pipeline: numbers + abbreviations, keep case."""
    text = normalize_numbers(text)
    text = expand_abbreviations(text)
    text = replace_symbols(text)
    text = remove_aux_symbols(text)
    return collapse_whitespace(text)


def french_cleaners(text: str) -> str:
    text = expand_abbreviations(text, lang="fr")
    text = lowercase(text)
    text = replace_symbols(text, lang="fr")
    text = remove_aux_symbols(text)
    return collapse_whitespace(text)


def portuguese_cleaners(text: str) -> str:
    text = lowercase(text)
    text = replace_symbols(text, lang="pt")
    text = remove_aux_symbols(text)
    return collapse_whitespace(text)


def chinese_mandarin_cleaners(text: str) -> str:
    # number verbalization for zh is handled by the phonemizer backend
    return text


def multilingual_cleaners(text: str) -> str:
    text = lowercase(text)
    text = replace_symbols(text, lang=None)
    text = remove_aux_symbols(text)
    return collapse_whitespace(text)


def no_cleaners(text: str) -> str:
    return text.replace("\n", "")
