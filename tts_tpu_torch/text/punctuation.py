"""Copied from ``tts_tpu/text/punctuation.py`` (the port imports nothing of ``tts_tpu``);
unchanged apart from this line.

Punctuation stripping/restoration around phonemization.

Behavior-equivalent rebuild of reference ``TTS/tts/utils/text/punctuation.py``:
phonemizer backends can't see punctuation, so text is split on punctuation
runs, each chunk phonemized separately, and the marks re-inserted afterwards.
"""

from __future__ import annotations

import collections
import re
from enum import Enum
from typing import List, Tuple

_DEF_PUNCS = ';:,.!?¡¿—…"«»“”'

PuncIdx = collections.namedtuple("PuncIdx", ["punc", "position"])


class PuncPosition(Enum):
    BEGIN = 0
    END = 1
    MIDDLE = 2


class Punctuation:
    """Strip punctuation, or strip-then-restore (reference ``punctuation.py:21``)."""

    def __init__(self, puncs: str = _DEF_PUNCS):
        self.puncs = puncs

    @staticmethod
    def default_puncs() -> str:
        return _DEF_PUNCS

    @property
    def puncs(self) -> str:
        return self._puncs

    @puncs.setter
    def puncs(self, value: str) -> None:
        if not isinstance(value, str):
            raise ValueError("[!] Punctuations must be of type str.")
        self._puncs = "".join(dict.fromkeys(list(value)))  # dedupe, keep order
        self.puncs_regular_exp = re.compile(rf"(\s*[{re.escape(self._puncs)}]+\s*)+")

    def strip(self, text: str) -> str:
        """Replace punctuation runs with a single space and trim."""
        return re.sub(self.puncs_regular_exp, " ", text).strip()

    def strip_to_restore(self, text: str) -> Tuple[List[str], List[PuncIdx]]:
        """Split text on punctuation runs, keeping a map for :meth:`restore`."""
        matches = list(re.finditer(self.puncs_regular_exp, text))
        if not matches:
            return [text], []
        if len(matches) == 1 and matches[0].group() == text:
            # text is punctuation only
            return [], [PuncIdx(text, PuncPosition.BEGIN)]
        puncs = []
        for match in matches:
            position = PuncPosition.MIDDLE
            if match == matches[0] and text.startswith(match.group()):
                position = PuncPosition.BEGIN
            elif match == matches[-1] and text.endswith(match.group()):
                position = PuncPosition.END
            puncs.append(PuncIdx(match.group(), position))
        splitted: List[str] = []
        rest = text
        for idx, punc in enumerate(puncs):
            split = rest.split(punc.punc)
            prefix, suffix = split[0], punc.punc.join(split[1:])
            rest = suffix
            if prefix != "":
                splitted.append(prefix)
            if idx == len(puncs) - 1 and len(suffix) > 0:
                splitted.append(suffix)
        return splitted, puncs

    @classmethod
    def restore(cls, text: List[str], puncs: List[PuncIdx]) -> List[str]:
        """Re-insert punctuation marks into phonemized chunks."""
        if not puncs:
            return text
        if not text:
            return ["".join(m.punc for m in puncs)]
        current = puncs[0]
        if current.position == PuncPosition.BEGIN:
            return cls.restore([current.punc + text[0]] + text[1:], puncs[1:])
        if current.position == PuncPosition.END:
            return [text[0] + current.punc] + cls.restore(text[1:], puncs[1:])
        if len(text) == 1:  # final chunk unphonemized corner case
            return cls.restore([text[0] + current.punc], puncs[1:])
        return cls.restore([text[0] + current.punc + text[1]] + text[2:], puncs[1:])
