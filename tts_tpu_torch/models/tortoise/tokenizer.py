"""Tortoise text tokenizer: byte-pair encoding in plain Python (copied from
``tts_tpu/models/tortoise/tokenizer.py``, reference
``TTS/tts/layers/tortoise/tokenizer.py:1-37``, which wraps the HF
``tokenizers`` BPE over the bundled 255-entry vocabulary).

The vocabulary and merges are the port's own copy of the JAX package's
asset, ``tts_tpu_torch/zoo/assets/tortoise_bpe.json``; an HF-format
``tokenizer.json`` is read too. Text is cleaned with the port's
``english_cleaners``.
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict, List, Sequence, Tuple

from tts_tpu_torch.text.cleaners import english_cleaners

DEFAULT_VOCAB_FILE = os.path.join(
    os.path.dirname(os.path.realpath(__file__)), "..", "..", "zoo", "assets", "tortoise_bpe.json"
)

# HF `Whitespace` pre-tokenizer rule: word runs or punctuation runs
_WHITESPACE_PRETOK = re.compile(r"\w+|[^\w\s]+")


def _parse_vocab(data: dict) -> Tuple[Dict[str, int], List[str], List[str]]:
    """The asset's schema, or an HF ``tokenizer.json``."""
    if "model" in data:  # HF format
        model = data["model"]
        specials = [t["content"] for t in data.get("added_tokens", [])]
        return model["vocab"], model["merges"], specials
    return data["vocab"], data["merges"], data.get("specials", ["[STOP]", "[UNK]", "[SPACE]"])


class VoiceBpeTokenizer:
    """Greedy lowest-rank BPE with the special tokens split out first."""

    def __init__(self, vocab_file: str = None, vocab_str: str = None):
        if vocab_str is not None:
            data = json.loads(vocab_str)
        else:
            with open(vocab_file or DEFAULT_VOCAB_FILE, encoding="utf-8") as f:
                data = json.load(f)
        vocab, merges, specials = _parse_vocab(data)
        self.vocab: Dict[str, int] = dict(vocab)
        self.id_to_token = {i: t for t, i in self.vocab.items()}
        # the merge list's order is the rank
        self.ranks: Dict[Tuple[str, str], int] = {}
        for rank, merge in enumerate(merges):
            a, b = merge.split(" ") if isinstance(merge, str) else merge
            self.ranks[(a, b)] = rank
        self.specials = [s for s in specials if s in self.vocab]
        self.unk_id = self.vocab.get("[UNK]", 1)
        self._special_re = re.compile(
            "(" + "|".join(re.escape(s) for s in self.specials) + ")"
        ) if self.specials else None

    def _bpe_word(self, word: str) -> List[int]:
        parts: List[str] = list(word)
        while len(parts) > 1:
            best_rank, best_i = None, -1
            for i in range(len(parts) - 1):
                r = self.ranks.get((parts[i], parts[i + 1]))
                if r is not None and (best_rank is None or r < best_rank):
                    best_rank, best_i = r, i
            if best_rank is None:
                break
            parts[best_i : best_i + 2] = [parts[best_i] + parts[best_i + 1]]
        return [self.vocab.get(p, self.unk_id) for p in parts]

    def preprocess_text(self, txt: str) -> str:
        return english_cleaners(txt)

    def encode(self, txt: str) -> List[int]:
        txt = self.preprocess_text(txt)
        txt = txt.replace(" ", "[SPACE]")
        ids: List[int] = []
        chunks = self._special_re.split(txt) if self._special_re else [txt]
        for chunk in chunks:
            if not chunk:
                continue
            if chunk in self.specials:
                ids.append(self.vocab[chunk])
                continue
            for word in _WHITESPACE_PRETOK.findall(chunk):
                ids.extend(self._bpe_word(word))
        return ids

    def decode(self, seq: Sequence[int]) -> str:
        txt = "".join(self.id_to_token.get(int(i), "[UNK]") for i in seq)
        txt = txt.replace("[SPACE]", " ").replace("[STOP]", "").replace("[UNK]", "")
        return txt
