"""Copied from ``tts_tpu/text/cleaners.py`` (the port imports nothing of
``tts_tpu``): ``lowercase`` and ``collapse_whitespace``, which the XTTS
tokenizer calls, and ``english_cleaners`` with what it calls, which the
LJSpeech VITS recipe names. ``expand_abbreviations`` and ``replace_symbols``
keep only their English branch; the cleaner pipelines of other languages are
left out.

Each cleaner is a ``str -> str`` function referenced by name from model
configs (``text_cleaner`` field).
"""

from __future__ import annotations

import re

from .english import abbreviations_en, expand_time_english, normalize_numbers

_whitespace_re = re.compile(r"\s+")


def expand_abbreviations(text: str) -> str:
    for regex, replacement in abbreviations_en:
        text = re.sub(regex, replacement, text)
    return text


def lowercase(text: str) -> str:
    return text.lower()


def collapse_whitespace(text: str) -> str:
    return re.sub(_whitespace_re, " ", text).strip()


def remove_aux_symbols(text: str) -> str:
    return re.sub(r"[\<\>\(\)\[\]\"]+", "", text)


def replace_symbols(text: str) -> str:
    """English symbol spelling (reference ``cleaners.py:46``, ``lang="en"``)."""
    text = text.replace(";", ",")
    text = text.replace("-", " ")
    text = text.replace(":", ",")
    return text.replace("&", " and ")


def english_cleaners(text: str) -> str:
    """Lowercase, expand times/numbers/abbreviations, normalize symbols."""
    text = lowercase(text)
    text = expand_time_english(text)
    text = normalize_numbers(text)
    text = expand_abbreviations(text)
    text = replace_symbols(text)
    text = remove_aux_symbols(text)
    return collapse_whitespace(text)
