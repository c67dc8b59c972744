"""XTTS BPE tokenizer and multilingual text cleaning (port of
``tts_tpu/models/xtts/tokenizer.py``).

The JAX package reads ``vocab.json`` with the HF ``tokenizers`` library; the
port reads the same file with a small pure-Python BPE (:class:`BpeTokenizer`)
so it needs no ``tokenizers`` install. It covers what XTTS vocabularies use:
a BPE model with ``vocab``/``merges``/``unk_token``, ``added_tokens`` split
out before BPE, no normalizer, and no pre-tokenizer or the ``Whitespace``
one. Any other feature raises instead of tokenizing differently.
"""

from __future__ import annotations

import json
import re
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from tts_tpu_torch.text.cleaners import collapse_whitespace, lowercase
from tts_tpu_torch.text.english import normalize_numbers
from tts_tpu_torch.text.japanese import japanese_to_romaji
from tts_tpu_torch.text.korean_romanize import korean_transliterate
from tts_tpu_torch.text.numbers_multilingual import (
    expand_abbreviations_multilingual,
    expand_numbers_hi,
    expand_numbers_ko,
    expand_numbers_multilingual,
    expand_numbers_zh,
    normalize_arabic_indic_digits,
)

_CHAR_LIMITS = {
    "en": 250, "de": 253, "fr": 273, "es": 239, "it": 213, "pt": 203,
    "pl": 224, "zh": 82, "ar": 166, "cs": 186, "ru": 182, "nl": 251,
    "tr": 226, "ja": 71, "hu": 224, "ko": 95, "hi": 250,
}

_SYMBOL_MAP = {
    "en": {"&": " and ", "@": " at ", "%": " percent ", "+": " plus "},
    "fr": {"&": " et ", "@": " arobase ", "%": " pour cent ", "+": " plus "},
    "de": {"&": " und ", "@": " at ", "%": " prozent ", "+": " plus "},
    "es": {"&": " y ", "@": " arroba ", "%": " por ciento ", "+": " más "},
    "it": {"&": " e ", "@": " chiocciola ", "%": " per cento ", "+": " più "},
    "pt": {"&": " e ", "@": " arroba ", "%": " por cento ", "+": " mais "},
}


def multilingual_cleaners(text: str, lang: str) -> str:
    """Lowercase, symbol and number expansion, bracket removal and script
    transliteration, as ``tts_tpu``'s ``multilingual_cleaners``."""
    text = text.replace('"', "")
    if lang == "ar":
        text = normalize_arabic_indic_digits(text)
    if lang == "tr":
        text = text.replace("İ", "i").replace("Ö", "ö").replace("Ü", "ü")
    text = lowercase(text)
    text = expand_abbreviations_multilingual(text, lang)
    for sym, replacement in _SYMBOL_MAP.get(lang, _SYMBOL_MAP["en"]).items():
        text = text.replace(sym, replacement)
    if lang == "en":
        text = normalize_numbers(text)
    elif lang == "zh":
        text = expand_numbers_zh(text)
    elif lang == "ko":
        text = expand_numbers_ko(text)
    elif lang == "ja":
        pass  # numbers expand inside japanese_to_romaji
    elif lang == "hi":
        text = expand_numbers_hi(text)
    else:
        text = expand_numbers_multilingual(text, lang)
    text = re.sub(r"[\(\)\[\]]+", "", text)
    text = collapse_whitespace(text)
    if lang == "zh":
        text = _chinese_transliterate(text)
    elif lang == "ko":
        text = korean_transliterate(text)
    elif lang == "ja":
        text = japanese_to_romaji(text)
    return text


def _chinese_transliterate(text: str) -> str:
    """hanzi → TONE3 pinyin when ``pypinyin`` is installed, else unchanged."""
    try:
        import pypinyin

        pypinyin.pinyin  # a test stub may register a bare module
    except (ImportError, AttributeError):
        return text
    return "".join(
        p[0]
        for p in pypinyin.pinyin(
            text, style=pypinyin.Style.TONE3, heteronym=False, neutral_tone_with_five=True
        )
    )


# ---------------------------------------------------------------------------
_WHITESPACE_PRE = re.compile(r"\w+|[^\w\s]+")


class BpeTokenizer:
    """Greedy BPE over an HF-format tokenizer file (``vocab.json``).

    Encoding follows the ``tokenizers`` library: added tokens are matched
    first (leftmost, longest); the text between them is pre-tokenized, and
    each piece starts as characters (unknown ones become ``unk_token``) that
    are merged pairwise, always the pair of lowest merge rank and, among
    equal ranks, the leftmost."""

    def __init__(self, spec: Dict):
        model = spec.get("model") or {}
        if model.get("type", "BPE") != "BPE":
            raise NotImplementedError(f"tokenizer model {model.get('type')!r} (only BPE)")
        for key in ("continuing_subword_prefix", "end_of_word_suffix", "dropout",
                    "byte_fallback", "fuse_unk", "ignore_merges"):
            if model.get(key):
                raise NotImplementedError(f"BPE option {key}={model[key]!r}")
        if spec.get("normalizer") is not None:
            raise NotImplementedError(f"normalizer {spec['normalizer']!r}")
        if spec.get("post_processor") is not None:
            raise NotImplementedError(f"post_processor {spec['post_processor']!r}")
        pre = spec.get("pre_tokenizer")
        if pre is not None and pre.get("type") != "Whitespace":
            raise NotImplementedError(f"pre_tokenizer {pre!r}")
        self._split_whitespace = pre is not None

        self.vocab: Dict[str, int] = dict(model.get("vocab") or {})
        self.unk_token: Optional[str] = model.get("unk_token")
        self.merges: Dict[Tuple[int, int], Tuple[int, int]] = {}
        for rank, m in enumerate(model.get("merges") or []):
            a, b = m.split(" ", 1) if isinstance(m, str) else m
            self.merges[(self.vocab[a], self.vocab[b])] = (rank, self.vocab[a + b])

        self.added: Dict[str, int] = {}
        for tok in spec.get("added_tokens") or []:
            if tok.get("lstrip") or tok.get("rstrip") or tok.get("single_word"):
                raise NotImplementedError(f"added token options of {tok['content']!r}")
            self.added[tok["content"]] = tok["id"]
        self._added_re = (
            re.compile("|".join(re.escape(t) for t in sorted(self.added, key=len, reverse=True)))
            if self.added
            else None
        )
        self.id_to_token = {i: t for t, i in self.vocab.items()}
        self.id_to_token.update({i: t for t, i in self.added.items()})

    @classmethod
    def from_file(cls, path: str) -> "BpeTokenizer":
        with open(path, encoding="utf-8") as f:
            return cls(json.load(f))

    def token_to_id(self, token: str) -> Optional[int]:
        if token in self.added:
            return self.added[token]
        return self.vocab.get(token)

    def _bpe(self, word: str) -> List[int]:
        ids: List[int] = []
        for ch in word:
            if ch in self.vocab:
                ids.append(self.vocab[ch])
            elif self.unk_token is not None:
                ids.append(self.vocab[self.unk_token])
            else:
                raise KeyError(f"character {ch!r} not in the vocabulary and no unk_token")
        while len(ids) > 1:
            best = None
            for pos in range(len(ids) - 1):
                hit = self.merges.get((ids[pos], ids[pos + 1]))
                if hit is not None and (best is None or hit[0] < best[0]):
                    best = (hit[0], pos, hit[1])
            if best is None:
                break
            _, pos, new_id = best
            ids[pos : pos + 2] = [new_id]
        return ids

    def _pieces(self, text: str) -> Iterable[str]:
        if self._split_whitespace:
            return _WHITESPACE_PRE.findall(text)
        return [text] if text else []

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        pos = 0
        matches = self._added_re.finditer(text) if self._added_re else ()
        for m in matches:
            for piece in self._pieces(text[pos : m.start()]):
                ids += self._bpe(piece)
            ids.append(self.added[m.group(0)])
            pos = m.end()
        for piece in self._pieces(text[pos:]):
            ids += self._bpe(piece)
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        return "".join(self.id_to_token[int(i)] for i in ids)


def write_char_vocab(path: str, chars: str, languages: Sequence[str] = ("en",)) -> None:
    """Write a character-level HF-format ``vocab.json``: ``[STOP]``,
    ``[UNK]``, ``[SPACE]``, ``[START]`` and the ``[lang]`` tags as added
    tokens (ids first), then one id per character, no merges."""
    added = ["[STOP]", "[UNK]", "[SPACE]", "[START]"] + [f"[{lang}]" for lang in languages]
    vocab: Dict[str, int] = {t: i for i, t in enumerate(added)}
    for ch in sorted(set(chars) - set(vocab)):
        vocab[ch] = len(vocab)
    spec = {
        "version": "1.0",
        "truncation": None,
        "padding": None,
        "added_tokens": [
            {"id": vocab[t], "content": t, "single_word": False, "lstrip": False,
             "rstrip": False, "normalized": False, "special": True}
            for t in added
        ],
        "normalizer": None,
        "pre_tokenizer": {"type": "Whitespace"},
        "post_processor": None,
        "decoder": None,
        "model": {
            "type": "BPE", "dropout": None, "unk_token": "[UNK]",
            "continuing_subword_prefix": None, "end_of_word_suffix": None,
            "fuse_unk": False, "byte_fallback": False, "vocab": vocab, "merges": [],
        },
    }
    with open(path, "w", encoding="utf-8") as f:
        json.dump(spec, f, ensure_ascii=False)


class VoiceBpeTokenizer:
    """XTTS text → token ids: clean, prefix ``[lang]``, spaces → ``[SPACE]``, BPE."""

    def __init__(self, vocab_file: Optional[str] = None):
        self.tokenizer = BpeTokenizer.from_file(vocab_file) if vocab_file else None
        self.char_limits = dict(_CHAR_LIMITS)

    def check_input_length(self, txt: str, lang: str) -> None:
        lang = lang.split("-")[0]
        limit = self.char_limits.get(lang, 250)
        if len(txt) > limit:
            print(
                f"[!] Warning: text length exceeds the {limit}-char limit for "
                f"language '{lang}'; audio may truncate."
            )

    def preprocess_text(self, txt: str, lang: str) -> str:
        return multilingual_cleaners(txt, lang.split("-")[0])

    def encode(self, txt: str, lang: str) -> List[int]:
        lang = lang.split("-")[0]
        self.check_input_length(txt, lang)
        txt = self.preprocess_text(txt, lang)
        lang = "zh-cn" if lang == "zh" else lang
        txt = f"[{lang}]{txt}"
        txt = txt.replace(" ", "[SPACE]")
        return self.tokenizer.encode(txt)

    def decode(self, seq: List[int]) -> str:
        txt = self.tokenizer.decode(seq).replace(" ", "")
        return txt.replace("[SPACE]", " ").replace("[STOP]", "").replace("[UNK]", "")
