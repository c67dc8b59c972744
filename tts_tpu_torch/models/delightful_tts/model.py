"""DelightfulTTS text → waveform inference (port of
``tts_tpu/models/delightful_tts/model.py:26-177``, reference
``TTS/tts/models/delightful_tts.py``): the acoustic model
(``acoustic_model.py``) and its joint HiFiGAN generator (the port's
``HifiganGenerator`` at ``config.vocoder``'s widths, ``upsample_rates_decoder``
[8, 8, 2, 2]: 256 samples a frame), in one ``DelightfulTTSModule``, and
the host wrapper ``DelightfulTTS``.

F28 (ROADMAP.md), settled in the port: the JAX wrapper computes the joint
vocoder's ``waveform`` beside the mel, but its ``synthesis`` reads only
``model_outputs``, the mel, so the JAX ``Synthesizer`` speaks a
DelightfulTTS through Griffin-Lim or an outside vocoder, or raises "No
vocoder or Griffin-Lim available". The port makes DelightfulTTS a waveform
model (``emits_waveform``): ``inference`` returns the waveform as
``model_outputs`` ``[B, max_frames × hop, 1]`` (the generator run on the
whole ``max_frames`` mel, zeros after ``y_lengths``, as the JAX wrapper
runs it) and the mel as ``mel``; ``synthesis`` cuts the waveform at
``y_lengths × hop``.

The discriminator and the joint GAN step serve training and wait for it
(ROADMAP.md item 17). The JAX package's reference-layout converter for
DelightfulTTS is on none of its load paths, so the port loads its own
checkpoint (``model_torch.pt``) and the JAX package's parameters
(``utils.convert.delightful_tts_from_jax_params``); a reference-layout file
raises, naming ROADMAP.md item 16.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import torch
import torch.nn as nn

from tts_tpu_torch import resolve_device
from tts_tpu_torch.models.base import init_tokenizer
from tts_tpu_torch.text.tokenizer import TTSTokenizer
from tts_tpu_torch.vocoder.models.hifigan_generator import HifiganGenerator

from .acoustic import EmbeddingPadded, RelativeMultiHeadAttention
from .acoustic_model import AcousticModel
from .config import DelightfulTTSConfig

PORT_WEIGHTS = "model_torch.pt"  # the port's state_dict of DelightfulTTSModule


class DelightfulTTSModule(nn.Module):
    """The acoustic model and its joint vocoder."""

    def __init__(self, config: DelightfulTTSConfig):
        super().__init__()
        v = config.vocoder
        self.acoustic_model = AcousticModel(config.model_args, num_mels=config.audio.num_mels)
        self.vocoder = HifiganGenerator(
            in_channels=config.audio.num_mels, out_channels=1,
            resblock_type=v.resblock_type_decoder,
            resblock_dilation_sizes=tuple(map(tuple, v.resblock_dilation_sizes_decoder)),
            resblock_kernel_sizes=tuple(v.resblock_kernel_sizes_decoder),
            upsample_kernel_sizes=tuple(v.upsample_kernel_sizes_decoder),
            upsample_initial_channel=v.upsample_initial_channel_decoder,
            upsample_factors=tuple(v.upsample_rates_decoder))

    def inference(self, x, x_lengths, aux_input: Optional[Dict] = None,
                  max_frames: int = 500) -> Dict[str, Any]:
        """Token ids → ``model_outputs``, the waveform ``[B, max_frames ×
        hop, 1]``, with the ``mel`` ``[B, max_frames, num_mels]`` and
        ``y_lengths``; ``aux_input`` may hold ``d_vectors`` or
        ``speaker_ids``."""
        aux_input = aux_input or {}
        out = self.acoustic_model.inference(x, x_lengths, d_vectors=aux_input.get("d_vectors"),
                                            speaker_idx=aux_input.get("speaker_ids"),
                                            max_frames=max_frames)
        out["mel"] = out["model_outputs"]
        out["model_outputs"] = self.vocoder(out["mel"])
        return out


class DelightfulTTS:
    """Host wrapper: tokenizer and weights around :class:`DelightfulTTSModule`."""

    # inference() returns the joint vocoder's waveform (F28)
    emits_waveform = True

    def __init__(self, config: DelightfulTTSConfig):
        self.config = config
        self.args = config.model_args
        self.module = DelightfulTTSModule(config)
        self.tokenizer: Optional[TTSTokenizer] = None

    @classmethod
    def init_from_config(cls, config: DelightfulTTSConfig) -> "DelightfulTTS":
        """Tokenizer and model for ``config``; the embedding has the
        vocabulary's size when ``model_args.num_chars`` is ``None`` (a
        smaller one raises, ROADMAP.md F7)."""
        tokenizer, config = init_tokenizer(config)
        model = cls(config)
        model.tokenizer = tokenizer
        return model

    @property
    def device(self) -> torch.device:
        return self.module.acoustic_model.src_word_emb.embeddings.device

    @property
    def hop_length(self) -> int:
        """Samples a mel frame: the joint vocoder's upsampling."""
        hop = 1
        for u in self.config.vocoder.upsample_rates_decoder:
            hop *= u
        return hop

    # ------------------------------------------------------------------
    @torch.no_grad()
    def init_params(self, seed: int = 0, device="cuda") -> "DelightfulTTS":
        """Random fp32 weights from ``seed``, drawn on the CPU (the same on
        every machine), then moved to ``device``: norm scales 1 and biases
        0; linear and conv weights N(0, 1/fan_in) (a transposed conv's
        fan-in is its input channels times its taps per output); the token
        embedding N(0, 2/C) (the JAX package's initialiser); the attention
        biases N(0, 1/head width). The duration predictor's output is a
        tenth of its scale with the bias ``DURATION_BIAS`` of GlowTTS, so
        that a token lasts about 6 frames."""
        from tts_tpu_torch.models.glow_tts.model import DURATION_BIAS

        device = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        module = self.module.to_empty(device="cpu")
        for name, p in module.named_parameters():
            owner_name, leaf = name.rsplit(".", 1)
            owner = module.get_submodule(owner_name)
            fan_in = p[0].numel() if p.dim() > 1 else 1
            if isinstance(owner, (nn.LayerNorm, nn.GroupNorm)):
                p.fill_(0.0 if leaf == "bias" else 1.0)
            elif owner_name == "acoustic_model.duration_predictor.linear_layer":
                p.copy_(torch.randn(p.shape, generator=gen) * 0.1 / fan_in**0.5
                        if leaf == "weight" else torch.full(p.shape, DURATION_BIAS))
            elif isinstance(owner, EmbeddingPadded):
                p.copy_(torch.randn(p.shape, generator=gen) * (2 / p.shape[1]) ** 0.5)
            elif isinstance(owner, RelativeMultiHeadAttention) and leaf.endswith("_bias"):
                p.copy_(torch.randn(p.shape, generator=gen) * p.shape[1] ** -0.5)
            elif leaf == "bias":
                p.zero_()
            else:
                if isinstance(owner, nn.ConvTranspose1d):  # weight [in, out, k]
                    fan_in = p.shape[0] * p.shape[2] // owner.stride[0]
                p.copy_(torch.randn(p.shape, generator=gen) / fan_in**0.5)
        self.module.to(device).requires_grad_(False)
        return self

    def load_state_dict(self, state: Dict[str, torch.Tensor]) -> None:
        """Take the tensors as they are (strict: no key missing or extra)."""
        self.module.load_state_dict(state, strict=True, assign=True)
        self.module.requires_grad_(False)

    def load_checkpoint(self, config: DelightfulTTSConfig, checkpoint_dir: Optional[str] = None,
                        checkpoint_path: Optional[str] = None,
                        device="cuda") -> "DelightfulTTS":
        """Weights from the port's state_dict of :class:`DelightfulTTSModule`
        (``model_torch.pt`` in ``checkpoint_dir``, or ``checkpoint_path``).
        A reference-layout checkpoint raises: no load path of the JAX
        package converts one (ROADMAP.md item 16)."""
        device = resolve_device(device)
        if checkpoint_path is None:
            checkpoint_path = os.path.join(checkpoint_dir, PORT_WEIGHTS)
            if not os.path.isfile(checkpoint_path):
                raise FileNotFoundError(f"No model weights in {checkpoint_dir} (need "
                                        f"{PORT_WEIGHTS})")
        state = torch.load(checkpoint_path, map_location="cpu", weights_only=True)
        if isinstance(state, dict) and "model" in state:
            state = state["model"]
        if not set(state) >= set(self.module.state_dict()):
            raise NotImplementedError("no reference-layout loader for DelightfulTTS in "
                                      "tts_tpu_torch (ROADMAP.md item 16): load the port's "
                                      f"{PORT_WEIGHTS}")
        self.load_state_dict({k: v.to(device) for k, v in state.items()})
        return self

    # ------------------------------------------------------------------
    def inference(self, x, x_lengths, max_frames: int = 500,
                  aux_input: Optional[Dict] = None) -> Dict[str, Any]:
        """Text ids → waveform (:meth:`DelightfulTTSModule.inference`)."""
        return self.module.inference(x, x_lengths, aux_input=aux_input, max_frames=max_frames)
