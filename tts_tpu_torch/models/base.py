"""The text front end of a mel model (port of ``tts_tpu/models/base.py:27``,
``init_tokenizer``), shared by GlowTTS, Tacotron2 and ForwardTTS.

Differences from the source: a text cleaner or phonemizer the port lacks
raises ``NotImplementedError`` naming it when the model loads, not at the
first sentence; a ``num_chars`` below the vocabulary raises (ROADMAP.md F7)
where the JAX package would embed out of range.
"""

from __future__ import annotations

from tts_tpu_torch.text import cleaners
from tts_tpu_torch.text.tokenizer import TTSTokenizer


def init_front_end(config):
    """``TTSTokenizer.init_from_config``, with a text cleaner or a phonemizer
    that the port lacks raised as ``NotImplementedError`` naming it."""
    cleaner = getattr(config, "text_cleaner", None)
    if isinstance(cleaner, str) and not hasattr(cleaners, cleaner):
        raise NotImplementedError(f"the text cleaner {cleaner!r} is not in "
                                  f"tts_tpu_torch.text.cleaners")
    try:
        return TTSTokenizer.init_from_config(config)
    except (ValueError, RuntimeError) as e:
        if not config.use_phonemes:
            raise
        raise NotImplementedError(
            f"no phonemizer of tts_tpu_torch serves phoneme_language "
            f"{config.phoneme_language!r} (phonemizer {config.phonemizer!r}): {e}") from e


def init_tokenizer(config):
    """``(tokenizer, config)`` with ``num_chars`` (of ``config.model_args``
    where that has one, as ForwardTTS's does, else of ``config``) set to the
    vocabulary's size when it is ``None``; a smaller ``num_chars`` raises."""
    tokenizer, config = init_front_end(config)
    n_symbols = tokenizer.characters.num_chars
    target = config.model_args if hasattr(getattr(config, "model_args", None), "num_chars") \
        else config
    if target.num_chars is None:
        target.num_chars = n_symbols
    if target.num_chars < n_symbols:
        raise ValueError(
            f"num_chars={target.num_chars} is smaller than the {n_symbols} symbols of "
            f"{type(tokenizer.characters).__name__}: set it to {n_symbols}, or to None to "
            f"take the vocabulary's size"
        )
    return tokenizer, config
