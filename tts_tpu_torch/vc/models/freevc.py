"""FreeVC, any-to-any voice conversion, at inference (port of
``tts_tpu/vc/models/freevc.py``; reference ``TTS/vc/models/freevc.py:298``).

VITS-style: WavLM content features → prior encoder (``enc_p``); the
residual-coupling flow, run in reverse and conditioned on the target
speaker's embedding, turns a prior sample into the posterior's latent; the
HiFiGAN decoder speaks it. The target embedding comes from the in-model
LSTM speaker encoder (``enc_spk``) over the target's log-mel, averaged over
128-frame windows. ``enc_q`` (the posterior encoder) serves training only;
it is built so that a checkpoint loads strictly. The training call, with
its random segments, waits for ROADMAP.md item 17.

The noise of :meth:`FreeVCModule.voice_conversion` comes from
``tts_tpu_torch.models.vits.modules.normal``, the port's one noise
function, unless ``noise`` is given; the host wrapper seeds a generator
with 0 on every call, as the JAX package draws from ``PRNGKey(0)`` on every
call, so a call is deterministic.

The default ``FreeVCConfig`` decodes 320 samples a WavLM frame (``[10, 8,
2, 2]``), 16 000 a second, while its ``output_sample_rate`` says 24 000: such
a model plays 1.5 times fast (ROADMAP.md F42). The port keeps that, as the
JAX package has it; a config that sets its own ``upsample_rates`` decodes
at the rate it names.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from tts_tpu_torch import resolve_device
from tts_tpu_torch.layers.wavenet import WN
from tts_tpu_torch.models.vits import modules as vits_modules
from tts_tpu_torch.models.vits.modules import PosteriorEncoder, ResidualCouplingBlocks
from tts_tpu_torch.ops.helpers import sequence_mask
from tts_tpu_torch.vc.configs import FreeVCArgs, FreeVCConfig
from tts_tpu_torch.vocoder.models.hifigan_generator import HifiganGenerator


class ContentEncoder(nn.Module):
    """SSL features ``[B, T, ssl_dim]`` → prior stats (reference freevc
    ``Encoder``): Dense ``pre``, a 16-layer WN of kernel 5, Dense ``proj``."""

    def __init__(self, in_channels: int, out_channels: int, hidden_channels: int,
                 kernel_size: int = 5, n_layers: int = 16):
        super().__init__()
        self.pre = nn.Linear(in_channels, hidden_channels)
        self.enc = WN(hidden_channels, kernel_size, 1, n_layers)
        self.proj = nn.Linear(hidden_channels, out_channels * 2)

    def forward(self, x: torch.Tensor, x_lengths: torch.Tensor):
        x_mask = sequence_mask(x_lengths, x.shape[1])[:, :, None].to(x.dtype)
        h = self.enc(self.pre(x) * x_mask, x_mask)
        m, logs = torch.chunk(self.proj(h) * x_mask, 2, dim=-1)
        return m, logs, x_mask


class FreeVCSpeakerEncoder(nn.Module):
    """The reference's in-model speaker encoder (``freevc.py:256``): a plain
    3-layer LSTM over mels ``[B, T, 80]`` → the last layer's final hidden
    state → Linear → ReLU → L2 normalisation."""

    def __init__(self, mel_n_channels: int = 80, num_layers: int = 3, hidden_size: int = 256,
                 embedding_size: int = 256):
        super().__init__()
        self.lstm = nn.LSTM(mel_n_channels, hidden_size, num_layers, batch_first=True)
        self.linear = nn.Linear(hidden_size, embedding_size)

    def forward(self, mels: torch.Tensor) -> torch.Tensor:  # [B, T, M] → [B, E]
        _, (h, _) = self.lstm(mels)
        e = F.relu(self.linear(h[-1]))
        return e / torch.clamp(torch.linalg.vector_norm(e, dim=1, keepdim=True), min=1e-12)


def embed_utterance_partials(apply_fn: Callable[[torch.Tensor], torch.Tensor], mel: torch.Tensor,
                             partial_frames: int = 128, partial_hop: int = 64) -> torch.Tensor:
    """Reference ``SpeakerEncoder.embed_utterance`` (``freevc.py:277``; port
    of ``tts_tpu/vc/models/freevc.py:69-83``): the mean embedding of
    128-frame windows hopped by 64, plus the last window, all in one batch;
    one window (the whole mel) when ``T <= 128``. ``apply_fn([N, F, M]) →
    [N, E]``; ``mel`` is ``[1, T, M]``."""
    T = mel.shape[1]
    last = mel[:, -partial_frames:]
    if T > partial_frames:
        starts = range(0, T - partial_frames, partial_hop)
        windows = torch.stack([mel[0, s: s + partial_frames] for s in starts] + [last[0]])
        return torch.mean(apply_fn(windows), dim=0, keepdim=True)
    return apply_fn(last)


class FreeVCModule(nn.Module):
    """FreeVC's networks under the JAX module's names (``enc_p``, ``enc_q``,
    ``flow``, ``dec``, and ``enc_spk`` unless ``use_spk``)."""

    def __init__(self, args: FreeVCArgs):
        super().__init__()
        a = args
        self.enc_p = ContentEncoder(a.ssl_dim, a.inter_channels, a.hidden_channels)
        self.enc_q = PosteriorEncoder(a.spec_channels, a.inter_channels, a.hidden_channels,
                                      kernel_size=5, dilation_rate=1, num_layers=16,
                                      cond_channels=a.gin_channels)
        self.flow = ResidualCouplingBlocks(a.inter_channels, a.hidden_channels, kernel_size=5,
                                           dilation_rate=1, num_layers=4,
                                           cond_channels=a.gin_channels)
        self.dec = HifiganGenerator(
            in_channels=a.inter_channels, out_channels=1, resblock_type=a.resblock,
            resblock_dilation_sizes=a.resblock_dilation_sizes,
            resblock_kernel_sizes=a.resblock_kernel_sizes,
            upsample_kernel_sizes=a.upsample_kernel_sizes,
            upsample_initial_channel=a.upsample_initial_channel,
            upsample_factors=a.upsample_rates, cond_channels=a.gin_channels,
            conv_post_bias=False,  # reference freevc.py:127
        )
        if not a.use_spk:
            self.enc_spk = FreeVCSpeakerEncoder(hidden_size=a.gin_channels,
                                                embedding_size=a.gin_channels)

    def voice_conversion(self, c: torch.Tensor, c_lengths: torch.Tensor, g: torch.Tensor,
                         noise: Optional[torch.Tensor] = None,
                         generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Content features ``[B, T, ssl_dim]`` and the target speaker's
        embedding ``g`` ``[B, gin]`` → waveform ``[B, T * hop, 1]``:
        ``z_p = m_p + exp(logs_p) * ε * 0.5``, the reverse flow on ``z_p *
        mask``, then ``dec(z * mask, g)``. ``ε`` is ``noise`` (``[B, T,
        inter]``) where given, else a draw from ``generator``."""
        m_p, logs_p, x_mask = self.enc_p(c, c_lengths)
        if noise is None:
            noise = vits_modules.normal(m_p.shape, generator)
        z_p = m_p + torch.exp(logs_p) * noise * 0.5
        z = self.flow(z_p * x_mask, x_mask, g=g, reverse=True)
        return self.dec(z * x_mask, g=g)


class FreeVC:
    """Host wrapper (reference ``FreeVC``): weights, the content extractor
    (WavLM-Large from ``$TTS_HOME/wavlm/`` unless one is set) and the target
    speaker's embedding around :class:`FreeVCModule`."""

    def __init__(self, config: FreeVCConfig):
        self.config = config
        self.args = config.model_args
        self.module = FreeVCModule(self.args)
        # wav [B, T] at 16 kHz → SSL content features [B, T', ssl_dim]
        self.content_extractor: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
        self.speaker_encoder = None  # an external d-vector model when use_spk

    @classmethod
    def init_from_config(cls, config: FreeVCConfig) -> "FreeVC":
        return cls(config)

    @property
    def device(self) -> torch.device:
        return self.module.enc_p.pre.weight.device

    @torch.no_grad()
    def init_params(self, seed: int = 0, device="cuda") -> "FreeVC":
        """Random fp32 weights from ``seed``, drawn on the CPU, then moved to
        ``device``: weights N(0, 1/fan_in) (a transposed conv's fan-in is its
        input channels times its taps per output), the last projection of
        each coupling flow a tenth of that (the flows start near the
        identity), biases 0."""
        device = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        module = self.module.to_empty(device="cpu")
        for name, p in module.named_parameters():
            owner = module.get_submodule(name.rsplit(".", 1)[0])
            if "bias" in name.rsplit(".", 1)[-1]:
                p.zero_()
                continue
            if isinstance(owner, nn.ConvTranspose1d):
                fan_in = p.shape[0] * p.shape[2] // owner.stride[0]
            else:
                fan_in = p[0].numel()
            scale = 0.1 if name.startswith("flow.") and name.endswith(".post.weight") else 1.0
            p.copy_(torch.randn(p.shape, generator=gen) * scale / fan_in**0.5)
        self.module.to(device).requires_grad_(False)
        return self

    def load_state_dict(self, state) -> None:
        """Take the tensors as they are (strict: no key missing or extra)."""
        self.module.load_state_dict(state, strict=True, assign=True)
        self.module.eval().requires_grad_(False)

    def load_checkpoint(self, config: FreeVCConfig, checkpoint_path: str,
                        device="cuda") -> "FreeVC":
        """Weights from a file: the port's state_dict of :class:`FreeVCModule`
        or a reference-layout checkpoint (``model.pth``, under ``"model"``
        or bare; weight norm folded and converted)."""
        device = resolve_device(device)
        state = torch.load(checkpoint_path, map_location="cpu", weights_only=True)
        if isinstance(state, dict) and "model" in state:
            state = state["model"]
        if not set(state) >= set(self.module.state_dict()):
            from tts_tpu_torch.utils.convert import load_reference_freevc

            state = load_reference_freevc(state)
        self.load_state_dict({k: v.to(device) for k, v in state.items()})
        return self

    def voice_conversion(self, c, c_lengths, g, noise: Optional[torch.Tensor] = None,
                         generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """:meth:`FreeVCModule.voice_conversion` on the model's device, the
        noise drawn from ``generator`` (seeded 0 by default)."""
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        with torch.no_grad():
            return self.module.voice_conversion(
                torch.as_tensor(c, device=self.device),
                torch.as_tensor(c_lengths, device=self.device),
                torch.as_tensor(g, device=self.device), noise=noise, generator=generator)

    @torch.no_grad()
    def voice_conversion_from_files(self, source_wav: str, target_wav) -> np.ndarray:
        """Source and target wav files (``target_wav`` a path or a list whose
        first path is taken) → the converted waveform, float32 numpy. Both
        load at ``input_sample_rate`` (16 kHz), resampled where needed
        (reference ``freevc.py voice_conversion`` driven from
        ``synthesizer.py:250``)."""
        from tts_tpu_torch.audio.numpy_transforms import load_wav

        if self.content_extractor is None:
            from tts_tpu_torch.vc.modules.wavlm import load_wavlm

            self.content_extractor = load_wavlm(device=self.device)
        sr = self.config.audio.input_sample_rate
        src = load_wav(filename=source_wav, sample_rate=sr, resample=True)
        tgt_path = target_wav[0] if isinstance(target_wav, (list, tuple)) else target_wav
        tgt = load_wav(filename=tgt_path, sample_rate=sr, resample=True)

        c = self.content_extractor(torch.from_numpy(np.asarray(src, np.float32))[None]
                                   .to(self.device))  # [1, T', ssl]
        c_lengths = torch.tensor([c.shape[1]], device=self.device)
        g = self.embed_target_speaker(tgt)
        wav = self.voice_conversion(c, c_lengths, g)
        return wav.float().cpu().numpy().reshape(-1)

    @torch.no_grad()
    def embed_target_speaker(self, wav_16k: np.ndarray) -> torch.Tensor:
        """Target wav at 16 kHz → speaker embedding ``[1, gin]``: the external
        encoder when ``use_spk`` (which must then be attached, as in the
        JAX package), else ``enc_spk`` over the log-mel (``center=False``,
        the audio config's 1280/320/1280 STFT, 80 mels) in 128-frame
        windows."""
        from tts_tpu_torch.audio.torch_transforms import wav_to_mel

        if self.args.use_spk:
            if self.speaker_encoder is None:
                raise RuntimeError(
                    "FreeVC config has use_spk=True (external speaker encoder) "
                    "but no speaker_encoder is attached; set model.speaker_encoder "
                    "or use a checkpoint with the in-model enc_spk (use_spk=False).")
            emb = self.speaker_encoder.embed_utterance(wav_16k)
            return torch.as_tensor(np.asarray(emb, np.float32).reshape(1, -1), device=self.device)
        a = self.config.audio
        mel = wav_to_mel(torch.from_numpy(np.asarray(wav_16k, np.float32))[None].to(self.device),
                         n_fft=a.filter_length, num_mels=a.n_mel_channels,
                         sample_rate=a.input_sample_rate, hop_length=a.hop_length,
                         win_length=a.win_length, fmin=a.mel_fmin, fmax=a.mel_fmax,
                         center=False)
        return embed_utterance_partials(self.module.enc_spk, mel.transpose(1, 2))
