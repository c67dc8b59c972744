"""Bark config (port of ``tts_tpu/models/bark/config.py``, reference
``TTS/tts/configs/bark_config.py`` and ``layers/bark/model.py`` GPTConfig).

Redeclared on the port's own ``config.base.Config``; the fields, defaults
and generation constants are the JAX package's, so a ``config.json``
written by either package loads in the other. One addition: ``audio`` is
the reference's ``BarkAudioConfig`` (24 kHz in and out), where the JAX
config keeps ``BaseTTSConfig``'s 22.05 kHz audio section, under which the
JAX ``Synthesizer`` labels a default config's 24 kHz output 22.05 kHz
(ROADMAP.md F52).

The JAX defaults are 12 layers 768 wide; the published ``text_2.pt``,
``coarse_2.pt`` and ``fine_2.pt`` (suno's large models) are 24 layers 1024
wide with 16 heads, which a ``config.json`` sets. The loader reads each
GPT's vocabularies and position table from its checkpoint (F48).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from tts_tpu_torch.config.base import Config
from tts_tpu_torch.config.shared import BaseTTSConfig


@dataclass
class BarkGPTArgs(Config):
    block_size: int = 1024
    input_vocab_size: int = 10_048
    output_vocab_size: int = 10_048
    n_layer: int = 12
    n_head: int = 12
    n_embd: int = 768
    dropout: float = 0.0
    bias: bool = False
    n_codes_total: int = 8  # fine model only
    n_codes_given: int = 1


@dataclass
class BarkAudioConfig(Config):
    sample_rate: int = 24000
    output_sample_rate: int = 24000


@dataclass
class BarkConfig(BaseTTSConfig):
    model: str = "bark"
    num_chars: int = 0
    audio: BarkAudioConfig = field(default_factory=BarkAudioConfig)
    semantic_config: BarkGPTArgs = field(
        default_factory=lambda: BarkGPTArgs(input_vocab_size=129_600, output_vocab_size=129_600)
    )
    coarse_config: BarkGPTArgs = field(default_factory=lambda: BarkGPTArgs(
        input_vocab_size=12_096, output_vocab_size=12_096))
    fine_config: BarkGPTArgs = field(default_factory=lambda: BarkGPTArgs(
        block_size=1024, input_vocab_size=1056, output_vocab_size=1056))
    # generation constants (reference bark/inference_funcs.py)
    CONTEXT_WINDOW_SIZE: int = 1024
    SEMANTIC_RATE_HZ: float = 49.9
    SEMANTIC_VOCAB_SIZE: int = 10_000
    CODEBOOK_SIZE: int = 1024
    N_COARSE_CODEBOOKS: int = 2
    N_FINE_CODEBOOKS: int = 8
    COARSE_RATE_HZ: int = 75
    SAMPLE_RATE: int = 24_000
    TEXT_ENCODING_OFFSET: int = 10_048
    SEMANTIC_PAD_TOKEN: int = 10_000
    TEXT_PAD_TOKEN: int = 129_595
    SEMANTIC_INFER_TOKEN: int = 129_599
    COARSE_SEMANTIC_PAD_TOKEN: int = 12_048
    COARSE_INFER_TOKEN: int = 12_050
