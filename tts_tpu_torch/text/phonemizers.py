"""Copied from ``tts_tpu/text/phonemizers.py`` (the port imports nothing of ``tts_tpu``);
unchanged apart from this line and the package named in docstrings and in the
fallback warning, which names the port's module.

Phonemizer backends (G2P) — host-side, outside jit.

Rebuild of reference ``TTS/tts/utils/text/phonemizers/``: an abstract
:class:`BasePhonemizer` implementing the strip-punctuation → phonemize →
restore-punctuation pipeline (``base.py:7``), an espeak/espeak-ng
subprocess wrapper (``espeak_wrapper.py:83``), optional third-party
backends (gruut, pypinyin, g2pkk, …) gated on availability, and a
language→backend registry.
"""

from __future__ import annotations

import abc
import logging
import re
import shutil
import subprocess
from typing import Dict, List, Optional, Tuple

from .punctuation import Punctuation

__all__ = [
    "BasePhonemizer",
    "ESpeak",
    "Gruut",
    "ZH_CN_Phonemizer",
    "KO_KR_Phonemizer",
    "BN_Phonemizer",
    "EN_Phonemizer",
    "MultiPhonemizer",
    "PHONEMIZERS",
    "DEF_LANG_TO_PHONEMIZER",
    "get_phonemizer_by_name",
]


class BasePhonemizer(abc.ABC):
    """Punctuation-aware phonemization pipeline (reference ``base.py:7``)."""

    def __init__(self, language, punctuations=Punctuation.default_puncs(), keep_puncs=False):
        if not self.is_available():
            raise RuntimeError(f"{self.name()} not installed on your system")
        self._language = self._init_language(language)
        self._keep_puncs = keep_puncs
        self._punctuator = Punctuation(punctuations)

    def _init_language(self, language):
        if not self.is_supported_language(language):
            raise RuntimeError(f'language "{language}" is not supported by the {self.name()} backend')
        return language

    @property
    def language(self):
        return self._language

    @staticmethod
    @abc.abstractmethod
    def name() -> str: ...

    @classmethod
    @abc.abstractmethod
    def is_available(cls) -> bool: ...

    @classmethod
    @abc.abstractmethod
    def version(cls) -> str: ...

    @staticmethod
    @abc.abstractmethod
    def supported_languages() -> Dict: ...

    def is_supported_language(self, language: str) -> bool:
        return language in self.supported_languages()

    @abc.abstractmethod
    def _phonemize(self, text: str, separator: str) -> str: ...

    def _phonemize_preprocess(self, text: str) -> Tuple[List[str], List]:
        text = text.strip()
        if self._keep_puncs:
            return self._punctuator.strip_to_restore(text)
        return [self._punctuator.strip(text)], []

    def _phonemize_postprocess(self, phonemized: List[str], punctuations: List) -> str:
        if self._keep_puncs:
            return self._punctuator.restore(phonemized, punctuations)[0]
        return phonemized[0]

    def phonemize(self, text: str, separator: str = "|", language: str = None) -> str:
        chunks, punctuations = self._phonemize_preprocess(text)
        phonemized = [self._phonemize(chunk, separator) for chunk in chunks]
        return self._phonemize_postprocess(phonemized, punctuations)

    def print_logs(self, level: int = 0):
        indent = "\t" * level
        print(f"{indent}| > phoneme language: {self.language}")
        print(f"{indent}| > phoneme backend: {self.name()}")


# ---------------------------------------------------------------------------
# espeak / espeak-ng
# ---------------------------------------------------------------------------


def _which(name: str) -> Optional[str]:
    return shutil.which(name)


def _espeak_exe(espeak_lib: str, args: List[str]) -> List[bytes]:
    """Run espeak synchronously and return stdout lines
    (reference ``espeak_wrapper.py:47``)."""
    cmd = [espeak_lib, "-q", "-b", "1"] + args
    logging.debug("espeak: executing %r", cmd)
    p = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, check=False)
    return p.stdout.splitlines(keepends=True)


def _espeak_version(binary: str) -> Optional[str]:
    try:
        out = _espeak_exe(binary, ["--version"])
        return out[0].decode().strip().split()[2] if out else None
    except Exception:
        return None


class ESpeak(BasePhonemizer):
    """espeak/espeak-ng subprocess G2P (reference ``espeak_wrapper.py:83``)."""

    def __init__(self, language: str, backend=None, punctuations=Punctuation.default_puncs(), keep_puncs=True):
        self._espeak_lib = backend or ("espeak-ng" if _which("espeak-ng") else "espeak")
        if language == "en":
            language = "en-us"
        if language == "zh-cn":
            language = "cmn"
        super().__init__(language, punctuations=punctuations, keep_puncs=keep_puncs)

    @property
    def backend(self) -> str:
        return self._espeak_lib

    @staticmethod
    def name():
        return "espeak"

    @classmethod
    def is_available(cls) -> bool:
        return bool(_which("espeak-ng") or _which("espeak"))

    @classmethod
    def version(cls) -> str:
        binary = "espeak-ng" if _which("espeak-ng") else "espeak"
        return _espeak_version(binary) or "unknown"

    @staticmethod
    def supported_languages() -> Dict:
        binary = "espeak-ng" if _which("espeak-ng") else ("espeak" if _which("espeak") else None)
        if binary is None:
            return {}
        langs = {}
        for line in _espeak_exe(binary, ["--voices"])[1:]:
            cols = line.decode("utf8").strip().split()
            if len(cols) > 3:
                langs[cols[1]] = cols[3]
        return langs

    def phonemize_espeak(self, text: str, separator: str = "|", tie: bool = False) -> str:
        args = ["-v", f"{self._language}"]
        if tie:
            args.append("--ipa=3" if self.backend == "espeak-ng" else "--ipa=1")
            args.append(f"--tie={tie}")
        else:
            args.append("--ipa=1")
        args.append(text)
        phonemes = ""
        for line in _espeak_exe(self.backend, args):
            ph_decoded = line.decode("utf8").strip()
            # espeak-ng can inject language-switch flags "(en)...(fr)"
            ph_decoded = re.sub(r"\(.+?\)", "", ph_decoded)
            phonemes += ph_decoded.strip()
        if not tie:
            phonemes = phonemes.replace("_", separator)
        return phonemes

    def _phonemize(self, text: str, separator: str = "") -> str:
        return self.phonemize_espeak(text, separator, tie=False)


# ---------------------------------------------------------------------------
# optional third-party backends (present only if their libs are installed)
# ---------------------------------------------------------------------------


class Gruut(BasePhonemizer):
    """gruut G2P (reference ``gruut_wrapper.py:14``)."""

    def __init__(self, language: str, punctuations=Punctuation.default_puncs(), keep_puncs=True, use_espeak_phonemes=False):
        super().__init__(language, punctuations=punctuations, keep_puncs=keep_puncs)
        self.use_espeak_phonemes = use_espeak_phonemes

    @staticmethod
    def name():
        return "gruut"

    @classmethod
    def is_available(cls) -> bool:
        try:
            import gruut  # noqa: F401

            return True
        except ImportError:
            return False

    @classmethod
    def version(cls) -> str:
        import gruut

        return gruut.__version__

    @staticmethod
    def supported_languages() -> List[str]:
        if not Gruut.is_available():
            return []
        import gruut

        return list(gruut.get_supported_languages())

    def _phonemize(self, text: str, separator: str = "|") -> str:
        import gruut

        ph_list = []
        for sentence in gruut.sentences(text, lang=self.language, espeak=self.use_espeak_phonemes):
            for word in sentence:
                if word.is_break:
                    if ph_list:
                        ph_list[-1].append(word.text)
                    else:
                        ph_list.append([word.text])
                elif word.phonemes:
                    ph_list.append(list(word.phonemes))
        return " ".join(separator.join(w) for w in ph_list)


class ZH_CN_Phonemizer(BasePhonemizer):
    """Mandarin pinyin G2P via pypinyin (reference ``zh_cn_phonemizer.py``)."""

    def __init__(self, punctuations=Punctuation.default_puncs(), keep_puncs=False, language="zh-cn", **kwargs):
        super().__init__("zh-cn", punctuations=punctuations, keep_puncs=keep_puncs)

    @staticmethod
    def name():
        return "zh_cn_phonemizer"

    @classmethod
    def is_available(cls) -> bool:
        try:
            import pypinyin

            # functional check: a bare test stub registers the module name
            # without a working API
            return callable(getattr(pypinyin, "lazy_pinyin", None))
        except ImportError:
            return False

    @classmethod
    def version(cls) -> str:
        return "0.0.1"

    @staticmethod
    def supported_languages() -> Dict:
        return {"zh-cn": "Chinese (China)"}

    def _phonemize(self, text: str, separator: str = "|") -> str:
        from .chinese_mandarin import chinese_text_to_phonemes

        return chinese_text_to_phonemes(text, separator)


class KO_KR_Phonemizer(BasePhonemizer):
    """Korean G2P via g2pkk (reference ``ko_kr_phonemizer.py``)."""

    def __init__(self, punctuations=Punctuation.default_puncs(), keep_puncs=True, language="ko-kr", **kwargs):
        super().__init__("ko-kr", punctuations=punctuations, keep_puncs=keep_puncs)

    @staticmethod
    def name():
        return "ko_kr_phonemizer"

    @classmethod
    def is_available(cls) -> bool:
        try:
            import g2pkk

            return getattr(g2pkk, "G2p", None) not in (None, object)
        except ImportError:
            return False

    @classmethod
    def version(cls) -> str:
        return "0.0.2"

    @staticmethod
    def supported_languages() -> Dict:
        return {"ko-kr": "hangeul(korean)"}

    def _phonemize(self, text: str, separator: str = "") -> str:
        from g2pkk import G2p

        if not hasattr(self, "_g2p"):
            self._g2p = G2p()
        tokens = self._g2p(text)
        return separator.join(tokens)


class BN_Phonemizer(BasePhonemizer):
    """Bangla G2P (reference ``bangla_phonemizer.py``)."""

    def __init__(self, punctuations=Punctuation.default_puncs(), keep_puncs=False, language="bn", **kwargs):
        super().__init__("bn", punctuations=punctuations, keep_puncs=keep_puncs)

    @staticmethod
    def name():
        return "bn_phonemizer"

    @classmethod
    def is_available(cls) -> bool:
        try:
            import bangla

            return callable(getattr(bangla, "convert_english_digit_to_bn", None))
        except ImportError:
            return False

    @classmethod
    def version(cls) -> str:
        return "0.0.1"

    @staticmethod
    def supported_languages() -> Dict:
        return {"bn": "Bangla"}

    def _phonemize(self, text: str, separator: str = "") -> str:
        import bangla
        from bnnumerizer import numerize
        from bnunicodenormalizer import Normalizer

        bnorm = Normalizer()
        text = numerize(text)
        words = [bnorm(w)["normalized"] for w in text.split()]
        return " ".join(w for w in words if w is not None)


class MultiPhonemizer:
    """lang → phonemizer dispatch (reference ``multi_phonemizer.py``)."""

    lang_to_phonemizer: Dict[str, BasePhonemizer] = {}

    def __init__(self, lang_to_phonemizer_name: Dict[str, str] = None):
        lang_to_phonemizer_name = lang_to_phonemizer_name or {}
        for k, v in lang_to_phonemizer_name.items():
            if v == "":
                lang_to_phonemizer_name[k] = DEF_LANG_TO_PHONEMIZER[k]
        self.lang_to_phonemizer_name = lang_to_phonemizer_name
        self.lang_to_phonemizer = {
            k: get_phonemizer_by_name(v, language=k) for k, v in self.lang_to_phonemizer_name.items()
        }

    @staticmethod
    def name():
        return "multi-phonemizer"

    def phonemize(self, text: str, separator: str = "|", language: str = ""):
        if language == "":
            raise ValueError("Language must be set for multi-phonemizer.")
        return self.lang_to_phonemizer[language].phonemize(text, separator)

    def supported_languages(self) -> List[str]:
        return list(self.lang_to_phonemizer.keys())

    def print_logs(self, level: int = 0):
        indent = "\t" * level
        print(f"{indent}| > phoneme language: {self.supported_languages()}")
        print(f"{indent}| > phoneme backend: {self.name()}")


# ---------------------------------------------------------------------------
class JA_JP_Phonemizer(BasePhonemizer):
    """Japanese G2P — Julius phoneme set (reference
    ``ja_jp_phonemizer.py``; native table in ``tts_tpu_torch.text.japanese``,
    kanji via MeCab/fugashi when importable)."""

    def __init__(self, punctuations=Punctuation.default_puncs(), keep_puncs=True, language="ja-jp", **kwargs):
        super().__init__("ja-jp", punctuations=punctuations, keep_puncs=keep_puncs)

    @staticmethod
    def name():
        return "ja_jp_phonemizer"

    @classmethod
    def is_available(cls) -> bool:
        return True  # kana path is dependency-free

    @classmethod
    def version(cls) -> str:
        return "0.0.2"

    @staticmethod
    def supported_languages() -> Dict:
        return {"ja-jp": "Japanese (Japan)"}

    def _phonemize(self, text: str, separator: str = "|") -> str:
        from .japanese import japanese_text_to_phonemes

        ph = japanese_text_to_phonemes(text).split(" ")
        return (separator or "").join(ph)


class BEL_Phonemizer(BasePhonemizer):
    """Belarusian G2P via the Fanetyka JVM library (reference
    ``bel_phonemizer.py``; needs jpype1 + BEL_FANETYKA_JAR)."""

    def __init__(self, punctuations=Punctuation.default_puncs() + "-", keep_puncs=True, language="be", **kwargs):
        super().__init__("be", punctuations=punctuations, keep_puncs=keep_puncs)

    @staticmethod
    def name():
        return "bel_phonemizer"

    @classmethod
    def is_available(cls) -> bool:
        try:
            import jpype  # noqa: F401

            return "BEL_FANETYKA_JAR" in __import__("os").environ
        except ImportError:
            return False

    @classmethod
    def version(cls) -> str:
        return "0.0.1"

    @staticmethod
    def supported_languages() -> Dict:
        return {"be": "Belarusian"}

    def _phonemize(self, text: str, separator: str = "|") -> str:
        from .belarusian import belarusian_text_to_phonemes

        return belarusian_text_to_phonemes(text)


class EN_Phonemizer(BasePhonemizer):
    """Pure-Python English G2P (``tts_tpu_torch.text.en_g2p``): exceptions lexicon
    + optional CMUdict + NRL-style letter-to-sound rules → IPA.  The
    dependency-free fallback for ``use_phonemes`` English configs when
    neither espeak binary is installed (reference behavior would silently
    fall back to graphemes)."""

    def __init__(self, language: str = "en-us", punctuations=Punctuation.default_puncs(),
                 keep_puncs=True, **kwargs):
        if language == "en":
            language = "en-us"
        super().__init__(language, punctuations=punctuations, keep_puncs=keep_puncs)
        from .en_g2p import EnglishG2P

        self._g2p = EnglishG2P()

    @staticmethod
    def name():
        return "en_g2p"

    @classmethod
    def is_available(cls) -> bool:
        return True  # dependency-free

    @classmethod
    def version(cls) -> str:
        return "0.0.1"

    @staticmethod
    def supported_languages() -> Dict:
        return {"en-us": "English (fallback G2P)", "en-gb": "English (fallback G2P)"}

    def _phonemize(self, text: str, separator: str = "|") -> str:
        return self._g2p.phonemize(text, separator="")


class Latin_Phonemizer(BasePhonemizer):
    """Pure-Python rule G2P for 22 languages (``tts_tpu_torch.text.latin_g2p`` +
    the ``rule_g2p_ext`` extension set): ordered context rules + stress
    assignment → phonemic IPA.  The dependency-free fallback for
    ``use_phonemes`` es/it/de/fr/pt/tr/pl/cs/hu/fi/nl/ro/ca/sk/hr/sl/lt/lv/
    et/bg/uk/el configs when the espeak binary is absent (reference
    phonemizes these languages only through espeak,
    ``espeak_wrapper.py:47-83``, and would otherwise silently degrade to
    graphemes)."""

    def __init__(self, language: str = "es", punctuations=Punctuation.default_puncs(),
                 keep_puncs=True, **kwargs):
        super().__init__(language, punctuations=punctuations, keep_puncs=keep_puncs)
        from .latin_g2p import get_latin_g2p

        self._g2p = get_latin_g2p(language)
        if self._g2p is None:
            raise ValueError(f"latin_g2p does not support language {language!r}")

    @staticmethod
    def name():
        return "latin_g2p"

    def is_supported_language(self, language: str) -> bool:
        from .latin_g2p import get_latin_g2p

        return get_latin_g2p(language) is not None

    @classmethod
    def is_available(cls) -> bool:
        return True  # dependency-free

    @classmethod
    def version(cls) -> str:
        return "0.0.1"

    @staticmethod
    def supported_languages() -> Dict:
        langs = {
            "es": "Spanish", "it": "Italian", "de": "German", "fr": "French",
            "pt": "Portuguese", "pt-br": "Portuguese", "tr": "Turkish",
            "pl": "Polish", "cs": "Czech", "hu": "Hungarian", "fi": "Finnish",
            "nl": "Dutch", "ro": "Romanian", "ca": "Catalan", "sk": "Slovak",
            "hr": "Croatian", "sl": "Slovenian", "lt": "Lithuanian",
            "lv": "Latvian", "et": "Estonian", "bg": "Bulgarian",
            "uk": "Ukrainian", "el": "Greek", "da": "Danish", "sv": "Swedish",
            "ga": "Irish", "mt": "Maltese", "fa": "Persian",
        }
        return {code: f"{name} (fallback G2P)" for code, name in langs.items()}

    def _phonemize(self, text: str, separator: str = "|") -> str:
        return self._g2p.phonemize(text, separator="")


# registry
# ---------------------------------------------------------------------------

PHONEMIZERS = {
    b.name(): b
    for b in (ESpeak, Gruut, KO_KR_Phonemizer, BN_Phonemizer, JA_JP_Phonemizer,
              BEL_Phonemizer, EN_Phonemizer, Latin_Phonemizer)
    if b.is_available()
}

DEF_LANG_TO_PHONEMIZER: Dict[str, str] = {}
if Gruut.is_available():
    DEF_LANG_TO_PHONEMIZER.update({lang: Gruut.name() for lang in Gruut.supported_languages()})
if ESpeak.is_available():
    DEF_LANG_TO_PHONEMIZER.update({lang: ESpeak.name() for lang in ESpeak.supported_languages()})
    if "en-us" in DEF_LANG_TO_PHONEMIZER:
        DEF_LANG_TO_PHONEMIZER["en"] = DEF_LANG_TO_PHONEMIZER["en-us"]
if ZH_CN_Phonemizer.is_available():
    DEF_LANG_TO_PHONEMIZER["zh-cn"] = ZH_CN_Phonemizer.name()
if KO_KR_Phonemizer.is_available():
    DEF_LANG_TO_PHONEMIZER["ko-kr"] = KO_KR_Phonemizer.name()
if BN_Phonemizer.is_available():
    DEF_LANG_TO_PHONEMIZER["bn"] = BN_Phonemizer.name()
DEF_LANG_TO_PHONEMIZER["ja-jp"] = JA_JP_Phonemizer.name()
if BEL_Phonemizer.is_available():
    DEF_LANG_TO_PHONEMIZER["be"] = BEL_Phonemizer.name()
# English always has a G2P: pure-Python fallback when espeak/gruut are absent
for _en in ("en", "en-us", "en-gb"):
    DEF_LANG_TO_PHONEMIZER.setdefault(_en, EN_Phonemizer.name())
# likewise the 27 rule-G2P languages (latin_g2p + rule_g2p_ext + ext3)
for _lt in ("es", "es-es", "it", "it-it", "de", "de-de", "fr", "fr-fr",
            "pt", "pt-br", "tr", "pl", "cs", "hu", "fi", "nl", "ro", "ca",
            "sk", "hr", "sl", "lt", "lv", "et", "bg", "uk", "el",
            "da", "sv", "ga", "mt", "fa", "fa-ir"):
    DEF_LANG_TO_PHONEMIZER.setdefault(_lt, Latin_Phonemizer.name())

_WARNED_FALLBACK: set = set()


def _warn_fallback(requested: str, module: str, desc: str) -> None:
    if module not in _WARNED_FALLBACK:
        import warnings

        warnings.warn(
            f"{requested} is not installed; falling back to the built-in "
            f"rule-based {desc} (tts_tpu_torch.text.{module}). Phoneme quality "
            "is below espeak — install espeak-ng for full fidelity.",
        )
        _WARNED_FALLBACK.add(module)


def _warn_en_fallback(requested: str) -> None:
    _warn_fallback(requested, "en_g2p", "English G2P")


def get_phonemizer_by_name(name: str, **kwargs) -> BasePhonemizer:
    """Instantiate a phonemizer backend by registry name
    (reference ``phonemizers/__init__.py:49``).  A request for espeak on a
    machine without the binary falls back to the built-in English G2P when
    the language is English (with a warning) instead of failing or silently
    degrading to graphemes."""
    if name == "espeak":
        lang = str(kwargs.get("language", ""))
        if not ESpeak.is_available():
            if lang.startswith("en"):
                _warn_en_fallback("espeak")
                return EN_Phonemizer(**kwargs)
            from .latin_g2p import get_latin_g2p

            if get_latin_g2p(lang) is not None:
                _warn_fallback("espeak", "latin_g2p", "offline rule G2P")
                return Latin_Phonemizer(**kwargs)
        return ESpeak(**kwargs)
    if name == "en_g2p":
        return EN_Phonemizer(**kwargs)
    if name == "latin_g2p":
        return Latin_Phonemizer(**kwargs)
    if name == "gruut":
        return Gruut(**kwargs)
    if name == "zh_cn_phonemizer":
        return ZH_CN_Phonemizer(**kwargs)
    if name == "ko_kr_phonemizer":
        return KO_KR_Phonemizer(**kwargs)
    if name == "bn_phonemizer":
        return BN_Phonemizer(**kwargs)
    if name == "ja_jp_phonemizer":
        return JA_JP_Phonemizer(**kwargs)
    if name == "bel_phonemizer":
        return BEL_Phonemizer(**kwargs)
    raise ValueError(f"Phonemizer {name} not found")
