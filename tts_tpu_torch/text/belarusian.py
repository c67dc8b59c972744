"""Copied from ``tts_tpu/text/belarusian.py`` (the port imports nothing of ``tts_tpu``);
unchanged apart from this line.

Belarusian phonemizer (reference
``TTS/tts/utils/text/belarusian/phonemizer.py``): delegates to the
Fanetyka Java library through jpype, gated exactly like the reference
(``jpype1`` installed + ``BEL_FANETYKA_JAR`` env var)."""

from __future__ import annotations

import os

__all__ = ["belarusian_text_to_phonemes"]

_finder = None


def _init():
    global _finder
    try:
        import jpype
        import jpype.imports  # noqa: F401
    except ModuleNotFoundError as e:
        raise ModuleNotFoundError(
            "Belarusian phonemizer requires the 'jpype1' package."
        ) from e
    jar_path = os.environ.get("BEL_FANETYKA_JAR")
    if not jar_path:
        raise KeyError(
            "Set BEL_FANETYKA_JAR to the path of the fanetyka.jar file."
        )
    jpype.startJVM(classpath=[jar_path])
    from org.alex73.korpus.base import GrammarDB2, GrammarFinder  # type: ignore

    _finder = GrammarFinder(GrammarDB2.initializeFromJar())


def belarusian_text_to_phonemes(text: str) -> str:
    if _finder is None:
        _init()
    from org.alex73.fanetyka.impl import FanetykaText  # type: ignore

    return str(FanetykaText(_finder, text).ipa)
