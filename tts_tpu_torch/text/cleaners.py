"""Copied from ``tts_tpu/text/cleaners.py`` (the port imports nothing of
``tts_tpu``): the two cleaners the XTTS tokenizer calls, ``lowercase`` and
``collapse_whitespace``; the cleaner pipelines of other families are left
out.
"""

from __future__ import annotations

import re

_whitespace_re = re.compile(r"\s+")


def lowercase(text: str) -> str:
    return text.lower()


def collapse_whitespace(text: str) -> str:
    return re.sub(_whitespace_re, " ", text).strip()
