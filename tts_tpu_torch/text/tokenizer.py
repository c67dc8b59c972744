"""Copied from ``tts_tpu/text/tokenizer.py`` (the port imports nothing of
``tts_tpu``), for graphemes: text → clean → encode → intersperse blank →
add BOS/EOS. Phonemes are not ported yet (``text/phonemizers.py``,
ROADMAP.md slice 2b): a config with ``use_phonemes=True`` raises, it does not
fall back to graphemes.
"""

from __future__ import annotations

from typing import Callable, List

from . import cleaners as cleaners_mod
from .characters import BaseCharacters, BaseVocabulary, Graphemes

__all__ = ["TTSTokenizer"]

# ``characters_class`` names in configs (this package's, the JAX package's or
# the coqui reference's module path) resolve by class name to these
_CHARACTER_CLASSES = {c.__name__: c for c in (BaseVocabulary, BaseCharacters, Graphemes)}


class TTSTokenizer:
    """Convert input text to token IDs (reference ``tokenizer.py:10``)."""

    def __init__(
        self,
        text_cleaner: Callable = None,
        characters: BaseCharacters = None,
        add_blank: bool = False,
        use_eos_bos: bool = False,
    ):
        self.text_cleaner = text_cleaner
        self.add_blank = add_blank
        self.use_eos_bos = use_eos_bos
        self.characters = characters
        self.not_found_characters: List[str] = []

    @property
    def characters(self):
        return self._characters

    @characters.setter
    def characters(self, new_characters):
        self._characters = new_characters
        self.pad_id = self.characters.char_to_id(self.characters.pad) if self.characters.pad else None
        self.blank_id = self.characters.char_to_id(self.characters.blank) if self.characters.blank else None

    def encode(self, text: str) -> List[int]:
        """Characters → ids; OOV chars are discarded (and remembered)."""
        token_ids = []
        for char in text:
            try:
                token_ids.append(self.characters.char_to_id(char))
            except KeyError:
                if char not in self.not_found_characters:
                    self.not_found_characters.append(char)
                    print(f" [!] Character {repr(char)} not found in the vocabulary. Discarding it.")
        return token_ids

    def text_to_ids(self, text: str) -> List[int]:
        """clean → encode → blanks → bos/eos (reference ``tokenizer.py:87-116``)."""
        if self.text_cleaner is not None:
            text = self.text_cleaner(text)
        ids = self.encode(text)
        if self.add_blank:
            ids = self.intersperse_blank_char(ids, True)
        if self.use_eos_bos:
            ids = self.pad_with_bos_eos(ids)
        return ids

    def pad_with_bos_eos(self, char_sequence: List[int]) -> List[int]:
        return [self.characters.bos_id] + list(char_sequence) + [self.characters.eos_id]

    def intersperse_blank_char(self, char_sequence: List[int], use_blank_char: bool = False) -> List[int]:
        char_to_use = self.characters.blank_id if use_blank_char else self.characters.pad
        result = [char_to_use] * (len(char_sequence) * 2 + 1)
        result[1::2] = char_sequence
        return result

    @staticmethod
    def init_from_config(config):
        """Build tokenizer (+updated config) from a model config
        (reference ``tokenizer.py:149-216``)."""
        if config.use_phonemes:
            raise NotImplementedError(
                "tts_tpu_torch: phonemes are not ported yet (text/phonemizers.py, "
                "ROADMAP.md slice 2b); use a grapheme config (use_phonemes=False)"
            )
        text_cleaner = None
        if isinstance(getattr(config, "text_cleaner", None), str):
            if not hasattr(cleaners_mod, config.text_cleaner):
                raise NotImplementedError(
                    f"tts_tpu_torch: text cleaner {config.text_cleaner!r} is not ported yet"
                )
            text_cleaner = getattr(cleaners_mod, config.text_cleaner)

        characters_class = Graphemes
        if config.characters is not None and config.characters.characters_class:
            cls_name = config.characters.characters_class.rsplit(".", 1)[-1]
            if cls_name not in _CHARACTER_CLASSES:
                raise NotImplementedError(
                    f"tts_tpu_torch: characters class {cls_name!r} is not ported yet "
                    f"(ported: {sorted(_CHARACTER_CLASSES)})"
                )
            characters_class = _CHARACTER_CLASSES[cls_name]
        characters, new_config = characters_class.init_from_config(config)
        new_config.characters.characters_class = (
            type(characters).__module__ + "." + type(characters).__name__
        )
        return (
            TTSTokenizer(text_cleaner, characters, config.add_blank, config.enable_eos_bos_chars),
            new_config,
        )
