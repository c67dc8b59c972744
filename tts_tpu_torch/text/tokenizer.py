"""Copied from ``tts_tpu/text/tokenizer.py`` (the port imports nothing of
``tts_tpu``): text → clean → (phonemize) → encode → intersperse blank → add
BOS/EOS. One change: a config's ``characters_class`` names a class by module
path, and the port resolves it by class name among its own vocabularies
(``text/characters.py``) instead of importing that path, so a config written
by the coqui reference (``TTS.…``), the JAX package (``tts_tpu.…``) or the
port loads the same class; a class the port lacks raises.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Union

from . import cleaners as cleaners_mod
from .characters import BaseCharacters, BaseVocabulary, Graphemes, IPAPhonemes, VitsCharacters
from .phonemizers import (
    DEF_LANG_TO_PHONEMIZER,
    BasePhonemizer,
    MultiPhonemizer,
    get_phonemizer_by_name,
)

__all__ = ["TTSTokenizer"]

_CHARACTER_CLASSES = {c.__name__: c for c in (BaseVocabulary, BaseCharacters, Graphemes,
                                                IPAPhonemes, VitsCharacters)}


class TTSTokenizer:
    """Convert input text to token IDs and back (reference ``tokenizer.py:10``)."""

    def __init__(
        self,
        use_phonemes: bool = False,
        text_cleaner: Callable = None,
        characters: BaseCharacters = None,
        phonemizer: Union[BasePhonemizer, MultiPhonemizer, Dict] = None,
        add_blank: bool = False,
        use_eos_bos: bool = False,
    ):
        self.text_cleaner = text_cleaner
        self.use_phonemes = use_phonemes
        self.add_blank = add_blank
        self.use_eos_bos = use_eos_bos
        self.characters = characters
        self.not_found_characters: List[str] = []
        self.phonemizer = phonemizer

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

    def decode(self, token_ids: List[int]) -> str:
        return "".join(self.characters.id_to_char(t) for t in token_ids)

    def text_to_ids(self, text: str, language: str = None) -> List[int]:
        """clean → phonemize → encode → blanks → bos/eos
        (reference ``tokenizer.py:87-116``)."""
        if self.text_cleaner is not None:
            text = self.text_cleaner(text)
        if self.use_phonemes:
            text = self.phonemizer.phonemize(text, separator="", language=language)
        ids = self.encode(text)
        if self.add_blank:
            ids = self.intersperse_blank_char(ids, True)
        if self.use_eos_bos:
            ids = self.pad_with_bos_eos(ids)
        return ids

    def ids_to_text(self, id_sequence: List[int]) -> str:
        return self.decode(id_sequence)

    def pad_with_bos_eos(self, char_sequence: List[int]) -> List[int]:
        return [self.characters.bos_id] + list(char_sequence) + [self.characters.eos_id]

    def intersperse_blank_char(self, char_sequence: List[int], use_blank_char: bool = False) -> List[int]:
        char_to_use = self.characters.blank_id if use_blank_char else self.characters.pad
        result = [char_to_use] * (len(char_sequence) * 2 + 1)
        result[1::2] = char_sequence
        return result

    def print_logs(self, level: int = 0):
        indent = "\t" * level
        print(f"{indent}| > add_blank: {self.add_blank}")
        print(f"{indent}| > use_eos_bos: {self.use_eos_bos}")
        print(f"{indent}| > use_phonemes: {self.use_phonemes}")
        if self.use_phonemes:
            print(f"{indent}| > phonemizer:")
            self.phonemizer.print_logs(level + 1)

    @staticmethod
    def init_from_config(config):
        """Build tokenizer (+updated config) from a model config
        (reference ``tokenizer.py:149-216``)."""
        text_cleaner = None
        if isinstance(getattr(config, "text_cleaner", None), str):
            text_cleaner = getattr(cleaners_mod, config.text_cleaner)

        if config.characters is not None and config.characters.characters_class:
            cls_name = config.characters.characters_class.rsplit(".", 1)[-1]
            if cls_name not in _CHARACTER_CLASSES:
                raise NotImplementedError(
                    f"tts_tpu_torch: characters class {cls_name!r} is not ported yet "
                    f"(ported: {sorted(_CHARACTER_CLASSES)})"
                )
            characters, new_config = _CHARACTER_CLASSES[cls_name].init_from_config(config)
        elif config.use_phonemes:
            characters, new_config = IPAPhonemes.init_from_config(config)
        else:
            characters, new_config = Graphemes.init_from_config(config)
        new_config.characters.characters_class = (
            type(characters).__module__ + "." + type(characters).__name__
        )

        phonemizer = None
        if config.use_phonemes:
            if "phonemizer" in config and config.phonemizer == "multi_phonemizer":
                lang_to_phonemizer_name = {}
                for dataset in config.datasets:
                    if dataset.language == "":
                        raise ValueError("Multi phonemizer requires language to be set for each dataset.")
                    lang_to_phonemizer_name[dataset.language] = dataset.phonemizer
                phonemizer = MultiPhonemizer(lang_to_phonemizer_name)
            else:
                phonemizer_kwargs = {"language": config.phoneme_language}
                if getattr(config, "phonemizer", None):
                    phonemizer = get_phonemizer_by_name(config.phonemizer, **phonemizer_kwargs)
                else:
                    try:
                        phonemizer = get_phonemizer_by_name(
                            DEF_LANG_TO_PHONEMIZER[config.phoneme_language], **phonemizer_kwargs
                        )
                        new_config.phonemizer = phonemizer.name()
                    except KeyError as e:
                        raise ValueError(
                            f"No phonemizer found for language {config.phoneme_language}."
                        ) from e

        return (
            TTSTokenizer(
                config.use_phonemes,
                text_cleaner,
                characters,
                phonemizer,
                config.add_blank,
                config.enable_eos_bos_chars,
            ),
            new_config,
        )
