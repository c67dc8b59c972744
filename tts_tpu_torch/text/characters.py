"""Copied from ``tts_tpu/text/characters.py`` (the port imports nothing of
``tts_tpu``): the grapheme and IPA phoneme symbol sets with
``parse_symbols``, ``BaseVocabulary``, ``BaseCharacters``, ``IPAPhonemes``,
``Graphemes``, ``FairseqVocab``, ``VitsCharacters`` and ``_chars_kwargs``,
unchanged apart from this docstring and import paths.

Vocab construction order matches the reference exactly ([pad][eos][bos]
[blank] + sorted characters + punctuations) so token ids are interchangeable
with reference checkpoints.
"""

from __future__ import annotations

from dataclasses import replace
from typing import Dict

from tts_tpu_torch.config.shared import CharactersConfig

# default grapheme set (reference characters.py:19-24)
_pad = "<PAD>"
_eos = "<EOS>"
_bos = "<BOS>"
_blank = "<BLNK>"
_characters = "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz"
_punctuations = "!'(),-.:;? "

# default IPA phoneme set (reference characters.py:29-35)
_vowels = "iyɨʉɯuɪʏʊeøɘəɵɤoɛœɜɞʌɔæɐaɶɑɒᵻ"
_non_pulmonic_consonants = "ʘɓǀɗǃʄǂɠǁʛ"
_pulmonic_consonants = "pbtdʈɖcɟkɡqɢʔɴŋɲɳnɱmʙrʀⱱɾɽɸβfvθðszʃʒʂʐçʝxɣχʁħʕhɦɬɮʋɹɻjɰlɭʎʟ"
_suprasegmentals = "ˈˌːˑ"
_other_symbols = "ʍwɥʜʢʡɕʑɺɧʲ"
_diacrilics = "ɚ˞ɫ"
_phonemes = (
    _vowels
    + _non_pulmonic_consonants
    + _pulmonic_consonants
    + _suprasegmentals
    + _other_symbols
    + _diacrilics
)


def parse_symbols():
    return {
        "pad": _pad,
        "eos": _eos,
        "bos": _bos,
        "characters": _characters,
        "punctuations": _punctuations,
        "phonemes": _phonemes,
    }


class BaseVocabulary:
    """Vocabulary from an explicit token→id dict (reference ``characters.py:38``)."""

    def __init__(self, vocab: Dict, pad: str = None, blank: str = None, bos: str = None, eos: str = None):
        self.vocab = vocab
        self.pad = pad
        self.blank = blank
        self.bos = bos
        self.eos = eos

    @property
    def pad_id(self) -> int:
        return self.char_to_id(self.pad) if self.pad else len(self.vocab)

    @property
    def blank_id(self) -> int:
        return self.char_to_id(self.blank) if self.blank else len(self.vocab)

    @property
    def bos_id(self) -> int:
        return self.char_to_id(self.bos) if self.bos else len(self.vocab)

    @property
    def eos_id(self) -> int:
        return self.char_to_id(self.eos) if self.eos else len(self.vocab)

    @property
    def vocab(self):
        return self._vocab

    @vocab.setter
    def vocab(self, vocab):
        self._vocab, self._char_to_id, self._id_to_char = None, None, None
        if vocab is not None:
            self._vocab = vocab
            self._char_to_id = {char: idx for idx, char in enumerate(self._vocab)}
            self._id_to_char = {idx: char for idx, char in enumerate(self._vocab)}

    @property
    def num_chars(self) -> int:
        return len(self._vocab)

    def char_to_id(self, char: str) -> int:
        try:
            return self._char_to_id[char]
        except KeyError as e:
            raise KeyError(f" [!] {repr(char)} is not in the vocabulary.") from e

    def id_to_char(self, idx: int) -> str:
        return self._id_to_char[idx]

    @staticmethod
    def init_from_config(config, **kwargs):
        if config.characters is not None:
            return (
                BaseVocabulary(
                    config.characters.vocab_dict,
                    config.characters.pad,
                    config.characters.blank,
                    config.characters.bos,
                    config.characters.eos,
                ),
                config,
            )
        return BaseVocabulary(**kwargs), config

    def to_config(self) -> CharactersConfig:
        return CharactersConfig(
            vocab_dict=self._vocab,
            pad=self.pad,
            eos=self.eos,
            bos=self.bos,
            blank=self.blank,
            is_unique=False,
            is_sorted=False,
        )


class BaseCharacters:
    """Character set with special tokens (reference ``characters.py:138``).

    Vocab order: ``[pad][eos][bos][blank]`` + (optionally deduped/sorted)
    characters + punctuations.
    """

    def __init__(
        self,
        characters: str = None,
        punctuations: str = None,
        pad: str = None,
        eos: str = None,
        bos: str = None,
        blank: str = None,
        is_unique: bool = False,
        is_sorted: bool = True,
    ) -> None:
        self._characters = characters
        self._punctuations = punctuations
        self._pad = pad
        self._eos = eos
        self._bos = bos
        self._blank = blank
        self.is_unique = is_unique
        self.is_sorted = is_sorted
        self._create_vocab()

    @property
    def pad_id(self) -> int:
        return self.char_to_id(self.pad) if self.pad else len(self.vocab)

    @property
    def blank_id(self) -> int:
        return self.char_to_id(self.blank) if self.blank else len(self.vocab)

    @property
    def eos_id(self) -> int:
        return self.char_to_id(self.eos) if self.eos else len(self.vocab)

    @property
    def bos_id(self) -> int:
        return self.char_to_id(self.bos) if self.bos else len(self.vocab)

    # mutating any piece rebuilds the vocab (reference semantics)
    def _prop(name):  # noqa: N805
        def getter(self):
            return getattr(self, f"_{name}")

        def setter(self, value):
            setattr(self, f"_{name}", value)
            self._create_vocab()

        return property(getter, setter)

    characters = _prop("characters")
    punctuations = _prop("punctuations")
    pad = _prop("pad")
    eos = _prop("eos")
    bos = _prop("bos")
    blank = _prop("blank")
    del _prop

    @property
    def vocab(self):
        return self._vocab

    @vocab.setter
    def vocab(self, vocab):
        self._vocab = vocab
        self._char_to_id = {char: idx for idx, char in enumerate(self._vocab)}
        self._id_to_char = {idx: char for idx, char in enumerate(self._vocab)}

    @property
    def num_chars(self) -> int:
        return len(self._vocab)

    def _create_vocab(self) -> None:
        _vocab = self._characters
        if self.is_unique:
            _vocab = list(set(_vocab))
        if self.is_sorted:
            _vocab = sorted(_vocab)
        _vocab = list(_vocab)
        for special in (self._blank, self._bos, self._eos, self._pad):
            if special is not None and len(special) > 0:
                _vocab = [special] + _vocab
        self.vocab = _vocab + list(self._punctuations)
        if self.is_unique:
            assert len(self.vocab) == len(self._char_to_id) == len(self._id_to_char), (
                " [!] There are duplicate characters in the character set."
            )

    def char_to_id(self, char: str) -> int:
        try:
            return self._char_to_id[char]
        except KeyError as e:
            raise KeyError(f" [!] {repr(char)} is not in the vocabulary.") from e

    def id_to_char(self, idx: int) -> str:
        return self._id_to_char[idx]

    @staticmethod
    def init_from_config(config):
        if config.characters is not None:
            return BaseCharacters(**_chars_kwargs(config.characters)), config
        characters = BaseCharacters()
        return characters, replace(config, characters=characters.to_config())

    def to_config(self) -> CharactersConfig:
        return CharactersConfig(
            characters=self._characters,
            punctuations=self._punctuations,
            pad=self._pad,
            eos=self._eos,
            bos=self._bos,
            blank=self._blank,
            is_unique=self.is_unique,
            is_sorted=self.is_sorted,
        )


def _chars_kwargs(cc: CharactersConfig) -> dict:
    return dict(
        characters=cc.characters,
        punctuations=cc.punctuations,
        pad=cc.pad,
        eos=cc.eos,
        bos=cc.bos,
        blank=cc.blank,
        is_unique=cc.is_unique,
        is_sorted=cc.is_sorted,
    )


class IPAPhonemes(BaseCharacters):
    """IPA phoneme vocabulary (reference ``characters.py:348``)."""

    def __init__(
        self,
        characters: str = _phonemes,
        punctuations: str = _punctuations,
        pad: str = _pad,
        eos: str = _eos,
        bos: str = _bos,
        blank: str = _blank,
        is_unique: bool = False,
        is_sorted: bool = True,
    ) -> None:
        super().__init__(characters, punctuations, pad, eos, bos, blank, is_unique, is_sorted)

    @staticmethod
    def init_from_config(config):
        if config.characters is not None:
            cc = config.characters
            # legacy configs store the phoneme set under "phonemes"
            if getattr(cc, "phonemes", None):
                cc.characters = cc.phonemes
            return IPAPhonemes(**_chars_kwargs(cc)), config
        characters = IPAPhonemes()
        return characters, replace(config, characters=characters.to_config())


class Graphemes(BaseCharacters):
    """Raw grapheme vocabulary (reference ``characters.py:426``)."""

    def __init__(
        self,
        characters: str = _characters,
        punctuations: str = _punctuations,
        pad: str = _pad,
        eos: str = _eos,
        bos: str = _bos,
        blank: str = _blank,
        is_unique: bool = False,
        is_sorted: bool = True,
    ) -> None:
        super().__init__(characters, punctuations, pad, eos, bos, blank, is_unique, is_sorted)

    @staticmethod
    def init_from_config(config):
        if config.characters is not None:
            return Graphemes(**_chars_kwargs(config.characters)), config
        characters = Graphemes()
        return characters, replace(config, characters=characters.to_config())


class FairseqVocab(BaseVocabulary):
    """Vocabulary from a fairseq MMS ``vocab.txt`` (one symbol per line;
    line 0 is the blank token, pad is space — reference ``vits.py:1982``)."""

    def __init__(self, vocab_file: str):
        with open(vocab_file, encoding="utf-8") as f:
            symbols = [line.rstrip("\n") for line in f]
        super().__init__(
            vocab={s: i for i, s in enumerate(symbols)},
            pad=" ",
            blank=symbols[0] if symbols else None,
        )


class VitsCharacters(BaseCharacters):
    """VITS-compatible vocab: ``[pad] + punctuations + characters + [blank]``
    (reference ``vits.py:1934`` — pretrained-checkpoint embedding indices
    depend on this exact order)."""

    def __init__(
        self,
        graphemes: str = _characters,
        punctuations: str = _punctuations,
        pad: str = _pad,
        ipa_characters: str = _phonemes,
    ) -> None:
        if ipa_characters is not None:
            graphemes += ipa_characters
        super().__init__(graphemes, punctuations, pad, None, None, "<BLNK>", is_unique=False, is_sorted=True)

    def _create_vocab(self):
        self._vocab = [self._pad] + list(self._punctuations) + list(self._characters) + [self._blank]
        self._char_to_id = {char: idx for idx, char in enumerate(self._vocab)}
        self._id_to_char = {idx: char for idx, char in enumerate(self._vocab)}

    @staticmethod
    def init_from_config(config):
        if config.characters is not None:
            cc = config.characters
            return (
                VitsCharacters(
                    graphemes=cc.characters,
                    ipa_characters=cc.phonemes,
                    punctuations=cc.punctuations,
                    pad=cc.pad,
                ),
                config,
            )
        characters = VitsCharacters()
        return characters, replace(config, characters=characters.to_config())

    def to_config(self) -> CharactersConfig:
        return CharactersConfig(
            characters=self._characters,
            punctuations=self._punctuations,
            pad=self._pad,
            eos=None,
            bos=None,
            blank=self._blank,
            is_unique=False,
            is_sorted=True,
        )
