"""Speaker encoders (port of ``tts_tpu/encoder/model.py``, reference
``TTS/encoder/models/{resnet,lstm}.py``): the SE-ResNet
(``ResNetSpeakerEncoder``, also embedded in the XTTS HiFi decoder), the
stacked LSTM with projections (``LSTMSpeakerEncoder``), the host wrapper
``SpeakerEncoder`` (a clip → a d-vector) and ``load_speaker_encoder``.

The JAX module is channels-last over (time, mel): ``[B, T, M, C]``. The port
is channels-first over the same axes, ``[B, C, T, M]``, so a flax ``HWIO``
kernel maps to torch ``OIHW`` by a plain transpose. Order of operations is
the reference's: conv → relu → norm in the stem and the first half of each
block. Norms are the "folded" kind (eval-mode BatchNorm as ``x·scale + shift``),
which is what converted checkpoints carry. Before pooling, each frame's
features are flattened channel-major (feature ``c*M + m``), as the reference
reshapes ``[B, C, M, T]``.

The LSTM encoder keeps the reference's names (``layers.<i>.lstm``, an
``nn.LSTM``, and ``layers.<i>.linear``, a projection without bias). Flax's
``OptimizedLSTMCell`` has the gates i, f, g, o of torch's LSTM and one bias
a gate, which ``utils.convert`` puts on the hidden side.

``SpeakerEncoder`` computes its features as the JAX wrapper does: the
port's ``wav_to_mel`` (no pre-emphasis, a Hann window, a magnitude
spectrogram, ``center=False``, no ``fmax``) at the config's audio settings
and the module's ``input_dim`` mels; a clip longer than ``num_frames``
frames is cut into windows every ``num_frames // 2`` frames, which go
through the module in one batch, and their d-vectors are averaged and
normalised. The reference computes other features (pre-emphasis 0.97, a
Hamming window, a power mel) and takes 10 evenly spaced windows without
renormalising (ROADMAP.md F25, recorded, not settled). One divergence from
the JAX wrapper, settled here (ROADMAP.md F21): ``wav_to_mel`` is already a
log-mel, and a ResNet with ``log_input`` takes the log again, which gives
NaN in the JAX package; the port hands such a module ``exp`` of the log-mel,
as both packages' XTTS do before their copy of this encoder.
"""

from __future__ import annotations

import os
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F


class FoldedNorm(nn.Module):
    """Per-channel affine ``x·weight + bias`` over dim 1."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        shape = (1, -1) + (1,) * (x.dim() - 2)
        return x * self.weight.view(shape) + self.bias.view(shape)


class SELayer(nn.Module):
    """Squeeze-and-excitation over ``[B, C, T, M]``."""

    def __init__(self, channel: int, reduction: int = 8):
        super().__init__()
        self.fc1 = nn.Linear(channel, channel // reduction)
        self.fc2 = nn.Linear(channel // reduction, channel)

    def forward(self, x):
        y = torch.sigmoid(self.fc2(F.relu(self.fc1(x.mean(dim=(2, 3))))))
        return x * y[:, :, None, None]


class SEBasicBlock(nn.Module):
    def __init__(self, inplanes: int, planes: int, stride: Tuple[int, int] = (1, 1),
                 downsample: bool = False):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 3, stride=stride, padding=1, bias=False)
        self.bn1 = FoldedNorm(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1, bias=False)
        self.bn2 = FoldedNorm(planes)
        self.se = SELayer(planes)
        if downsample:
            self.downsample_conv = nn.Conv2d(inplanes, planes, 1, stride=stride, bias=False)
            self.downsample_bn = FoldedNorm(planes)

    def forward(self, x):
        out = self.bn1(F.relu(self.conv1(x)))
        out = self.se(self.bn2(self.conv2(out)))
        residual = x
        if hasattr(self, "downsample_conv"):
            residual = self.downsample_bn(self.downsample_conv(x))
        return F.relu(out + residual)


class ResNetSpeakerEncoder(nn.Module):
    """SE-ResNet34 + attentive statistics pooling → d-vector."""

    def __init__(
        self,
        input_dim: int = 64,
        proj_dim: int = 512,
        layers: Sequence[int] = (3, 4, 6, 3),
        num_filters: Sequence[int] = (32, 64, 128, 256),
        log_input: bool = False,
        encoder_type: str = "ASP",
    ):
        super().__init__()
        self.log_input = log_input
        self.input_dim = input_dim
        self.encoder_type = encoder_type
        self.conv1 = nn.Conv2d(1, num_filters[0], 3, padding=1)
        self.bn1 = FoldedNorm(num_filters[0])
        inplanes = num_filters[0]
        for li, (n_blocks, planes) in enumerate(zip(layers, num_filters)):
            blocks = []
            for bi in range(n_blocks):
                stride = (2, 2) if (li > 0 and bi == 0) else (1, 1)
                downsample = bi == 0 and (li > 0 or planes != num_filters[0])
                blocks.append(SEBasicBlock(inplanes, planes, stride, downsample))
                inplanes = planes
            setattr(self, f"layer{li + 1}", nn.ModuleList(blocks))
        self.n_layers = len(layers)
        # mel bins after the three stride-2 stages
        out_dim = num_filters[-1] * _stride2_len(input_dim, len(layers) - 1)
        attn_ch = 128
        self.attn_conv1 = nn.Conv1d(out_dim, attn_ch, 1)
        self.attn_bn = FoldedNorm(attn_ch)
        self.attn_conv2 = nn.Conv1d(attn_ch, out_dim, 1)
        # attentive statistics pooling: mean and deviation (ASP), or the mean alone (SAP)
        self.fc = nn.Linear(2 * out_dim if encoder_type == "ASP" else out_dim, proj_dim)

    def forward(self, x: torch.Tensor, l2_norm: bool = True) -> torch.Tensor:
        """x: ``[B, T, n_mels]`` mel features → ``[B, proj_dim]``."""
        x = x.float()
        if self.log_input:
            x = torch.log(x + 1e-6)
        # instance norm over time per mel bin
        mean = x.mean(dim=1, keepdim=True)
        var = x.var(dim=1, keepdim=True, unbiased=False)
        x = ((x - mean) / torch.sqrt(var + 1e-5))[:, None]  # [B, 1, T, M]
        x = self.bn1(F.relu(self.conv1(x)))
        for li in range(self.n_layers):
            for block in getattr(self, f"layer{li + 1}"):
                x = block(x)
        B, C, T, M = x.shape
        x = x.permute(0, 2, 1, 3).reshape(B, T, C * M)  # feature index c*M + m
        w = self.attn_conv2(self.attn_bn(F.relu(self.attn_conv1(x.transpose(1, 2)))))
        w = torch.softmax(w, dim=2).transpose(1, 2)  # over time, [B, T, F]
        mu = torch.sum(x * w, dim=1)
        sg = torch.sqrt(torch.clamp(torch.sum(x * x * w, dim=1) - mu * mu, min=1e-5))
        out = self.fc(torch.cat([mu, sg], dim=-1) if self.encoder_type == "ASP" else mu)
        if l2_norm:
            out = out / torch.clamp(torch.linalg.vector_norm(out, dim=-1, keepdim=True), min=1e-8)
        return out


def _stride2_len(n: int, times: int) -> int:
    """Length after ``times`` convs of kernel 3, stride 2, padding 1."""
    for _ in range(times):
        n = (n - 1) // 2 + 1
    return n


def _l2_normalise(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=1e-8)


def _instance_norm_over_time(x: torch.Tensor) -> torch.Tensor:
    mean = x.mean(dim=1, keepdim=True)
    var = x.var(dim=1, keepdim=True, unbiased=False)
    return (x - mean) / torch.sqrt(var + 1e-5)


class LSTMWithProjection(nn.Module):
    def __init__(self, input_size: int, hidden_size: int, proj_size: int):
        super().__init__()
        self.lstm = nn.LSTM(input_size, hidden_size, batch_first=True)
        self.linear = nn.Linear(hidden_size, proj_size, bias=False)

    def forward(self, x):
        return self.linear(self.lstm(x)[0])


class LSTMSpeakerEncoder(nn.Module):
    """Instance norm over time, ``num_lstm_layers`` × (LSTM of ``lstm_dim``,
    projection to ``proj_dim``), the last frame, the L2 norm."""

    def __init__(self, input_dim: int = 80, proj_dim: int = 256, lstm_dim: int = 768,
                 num_lstm_layers: int = 3):
        super().__init__()
        self.input_dim = input_dim
        self.layers = nn.ModuleList(
            LSTMWithProjection(input_dim if i == 0 else proj_dim, lstm_dim, proj_dim)
            for i in range(num_lstm_layers))

    def forward(self, x: torch.Tensor, l2_norm: bool = True) -> torch.Tensor:
        """x: ``[B, T, input_dim]`` mels → ``[B, proj_dim]``."""
        x = _instance_norm_over_time(x.float())
        for layer in self.layers:
            x = layer(x)
        d = x[:, -1]
        return _l2_normalise(d) if l2_norm else d


class SpeakerEncoder:
    """Host wrapper: the module that ``config.model_params`` names (``lstm``
    or ``resnet``, as the JAX wrapper reads them) and a clip → d-vector."""

    def __init__(self, config):
        self.config = config
        model_params = dict(getattr(config, "model_params", {}) or {})
        if model_params.get("model_name", "resnet") == "lstm":
            self.module = LSTMSpeakerEncoder(
                input_dim=model_params.get("input_dim", 80),
                proj_dim=model_params.get("proj_dim", 256),
                lstm_dim=model_params.get("lstm_dim", 768),
                num_lstm_layers=model_params.get("num_lstm_layers", 3),
            )
        else:
            self.module = ResNetSpeakerEncoder(
                input_dim=model_params.get("input_dim", 64),
                proj_dim=model_params.get("proj_dim", 512),
                log_input=model_params.get("log_input", False),
            )
        self.module.eval().requires_grad_(False)

    @property
    def device(self) -> torch.device:
        return next(self.module.parameters()).device

    @torch.no_grad()
    def init_params(self, seed: int = 0, device="cuda") -> "SpeakerEncoder":
        """Random fp32 weights from ``seed``, drawn on the CPU, then moved to
        ``device``: weights N(0, 1/fan_in), biases 0, folded norms 1 and 0."""
        from tts_tpu_torch import resolve_device

        device = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        for name, p in self.module.named_parameters():
            owner = self.module.get_submodule(name.rsplit(".", 1)[0])
            if isinstance(owner, FoldedNorm):
                p.fill_(1.0 if name.endswith("weight") else 0.0)
            elif "bias" in name.rsplit(".", 1)[-1]:
                p.zero_()
            else:
                p.copy_(torch.randn(p.shape, generator=gen) / p[0].numel() ** 0.5)
        self.module.to(device)
        return self

    def load_state_dict(self, state) -> "SpeakerEncoder":
        """Take the tensors as they are (strict: no key missing or extra)."""
        self.module.load_state_dict(state, strict=True, assign=True)
        self.module.eval().requires_grad_(False)
        return self

    def features(self, wav) -> torch.Tensor:
        """A clip (numpy or a tensor) → ``[1, T, input_dim]`` features on the
        module's device: the log-mel, or its ``exp`` for a ResNet with
        ``log_input`` (ROADMAP.md F21)."""
        from tts_tpu_torch.audio import torch_transforms as tt

        audio = self.config.audio
        y = torch.as_tensor(np.asarray(wav, np.float32), device=self.device)[None]
        mel = tt.wav_to_mel(y, n_fft=audio.fft_size, num_mels=self.module.input_dim,
                            sample_rate=audio.sample_rate, hop_length=audio.hop_length,
                            win_length=audio.win_length)
        if getattr(self.module, "log_input", False):
            mel = torch.exp(mel)
        return mel.transpose(1, 2)

    @torch.no_grad()
    def compute_embedding_from_wav(self, wav, num_frames: int = 250) -> np.ndarray:
        """A clip → its d-vector ``[proj_dim]`` (numpy): one pass up to
        ``num_frames`` frames; a longer clip's windows every ``num_frames //
        2`` frames in one batch, their mean normalised."""
        mel = self.features(wav)
        T = mel.shape[1]
        if T <= num_frames:
            return self.module(mel)[0].float().cpu().numpy()
        offsets = range(0, T - num_frames + 1, num_frames // 2)
        windows = torch.cat([mel[:, o : o + num_frames] for o in offsets])
        emb = _l2_normalise(self.module(windows).mean(dim=0))
        return emb.float().cpu().numpy()


def load_speaker_encoder(model_path: str, config_path: str, device="cuda"):
    """A speaker encoder checkpoint and its ``config.json`` → ``(encoder,
    AudioProcessor)``. The file is a reference-layout checkpoint (``.pth``
    or ``.pth.tar``, its state under ``"model"``: the zoo's
    ``model_se.pth.tar``) or the port's state_dict of the module."""
    from tts_tpu_torch import resolve_device
    from tts_tpu_torch.audio.processor import AudioProcessor
    from tts_tpu_torch.config import read_json_with_comments
    from tts_tpu_torch.encoder.configs import SpeakerEncoderConfig

    device = resolve_device(device)
    if not config_path or not os.path.isfile(config_path):
        raise ValueError(f"the speaker encoder {model_path} needs its config.json "
                         f"(encoder_config_path; got {config_path!r})")
    config = SpeakerEncoderConfig.from_dict(read_json_with_comments(config_path))
    with torch.device("meta"):
        encoder = SpeakerEncoder(config)
    state = torch.load(model_path, map_location="cpu", weights_only=True)
    if isinstance(state, dict) and "model" in state:
        state = state["model"]
    if not set(state) >= set(encoder.module.state_dict()):
        from tts_tpu_torch.utils.convert import load_reference_speaker_encoder

        state = load_reference_speaker_encoder(state, config)
    encoder.load_state_dict({k: v.to(device) for k, v in state.items()})
    return encoder, AudioProcessor.init_from_config(config.audio, verbose=False)
