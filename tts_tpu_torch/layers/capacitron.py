"""Capacitron VAE, inference half (port of ``tts_tpu/layers/capacitron.py``,
reference ``TTS/tts/layers/tacotron/capacitron_layers.py``):
``CapacitronReferenceEncoder``, ``TextSummary``, ``PostEncoderMLP`` and
``CapacitronVAE``, which returns a prosody vector ``z``: drawn from the
posterior when a reference mel is given, else from the prior ``N(0, I)``.

The posterior's softplus output is a variance, as in the reference (which
feeds it to a multivariate normal as the covariance diagonal), with 1e-6
added. The standard normal draw ``eps`` is taken as a tensor where the
caller has one (the tests hand over the JAX package's draw), else drawn by
:func:`normal` on the host from the caller's ``torch.Generator``, so that
the card and the CPU draw the same values. The loss (``capacitron_loss``)
serves training and waits for it (ROADMAP.md item 17); ``beta`` is kept as
a parameter so that checkpoints load strictly.

Module and parameter names are the flax ones; the LSTMs are torch's
``nn.LSTM`` over the whole (padded) sequence, read at each row's last valid
step, as the JAX modules read theirs.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .tacotron_v1 import (REFERENCE_CHANNELS, add_ref_convs, ref_conv_step, ref_flat_width,
                          ref_flatten)


def normal(shape, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Standard normal draws of ``shape`` on the host, from ``generator``
    (a CPU generator, or torch's global one when ``None``)."""
    return torch.randn(shape, generator=generator)


def _last_valid(outs: torch.Tensor, lengths: Optional[torch.Tensor]) -> torch.Tensor:
    """``outs[b, lengths[b] - 1]`` (clipped into the sequence), or the last
    step when ``lengths`` is ``None``."""
    if lengths is None:
        return outs[:, -1]
    last = torch.clamp(lengths.long() - 1, 0, outs.shape[1] - 1)
    return outs[torch.arange(outs.shape[0], device=outs.device), last.to(outs.device)]


class CapacitronReferenceEncoder(nn.Module):
    """Mel ``[B, T, M]`` (with lengths) → prosody embedding ``[B, out_dim]``
    (reference ``capacitron_layers.py:84``): six 3x3 stride-2 convolutions
    (padding 2), each output zeroed past the row's valid width
    (``ceil(valid / 2) + 1`` after each), then the LSTM's output at the last
    valid step."""

    def __init__(self, num_mel: int, out_dim: int = 128, norm_type: str = "layer"):
        super().__init__()
        add_ref_convs(self, norm_type, padding=2)
        self.lstm = nn.LSTM(ref_flat_width(num_mel, 2), out_dim, batch_first=True)

    def forward(self, mel: torch.Tensor, mel_lengths: Optional[torch.Tensor] = None):
        B, T, _ = mel.shape
        valid = (torch.full((B,), float(T), device=mel.device) if mel_lengths is None
                 else mel_lengths.to(mel.device).float())
        h = mel[:, None]
        for i in range(len(REFERENCE_CHANNELS)):
            h = ref_conv_step(self, i, h)
            valid = torch.ceil(valid / 2.0) + 1.0
            keep = torch.arange(h.shape[2], device=h.device)[None, :] < valid.long()[:, None]
            h = h * keep[:, None, :, None]
        return _last_valid(self.lstm(ref_flatten(h))[0], valid.long())


class TextSummary(nn.Module):
    """Text-encoder outputs → the LSTM's output at the last valid token
    (reference ``capacitron_layers.py:167``)."""

    def __init__(self, in_channels: int, embedding_dim: int):
        super().__init__()
        self.lstm = nn.LSTM(in_channels, embedding_dim, batch_first=True)

    def forward(self, text_embeddings: torch.Tensor,
                text_lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        return _last_valid(self.lstm(text_embeddings)[0], text_lengths)


class PostEncoderMLP(nn.Module):
    """Linear → tanh → Linear to ``2 × hidden``: the mean and the softplus
    variance (reference ``capacitron_layers.py:189``)."""

    def __init__(self, in_channels: int, hidden_size: int):
        super().__init__()
        self.hidden = nn.Linear(in_channels, hidden_size)
        self.out = nn.Linear(hidden_size, 2 * hidden_size)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        mu, var = self.out(torch.tanh(self.hidden(x))).chunk(2, dim=-1)
        return mu, F.softplus(var)


class CapacitronVAE(nn.Module):
    """Reference-audio posterior, conditioned on a summary of the text, or
    the prior: a prosody vector ``z`` ``[B, capacitron_VAE_embedding_dim]``
    (JAX ``CapacitronVAE.__call__``, ``capacitron.py:138-172``)."""

    def __init__(self, num_mel: int, text_channels: int,
                 capacitron_VAE_embedding_dim: int = 128, reference_encoder_out_dim: int = 128,
                 text_summary_embedding_dim: int = 128, norm_type: str = "layer"):
        super().__init__()
        self.embedding_dim = capacitron_VAE_embedding_dim
        self.ref_encoder = CapacitronReferenceEncoder(num_mel, reference_encoder_out_dim,
                                                      norm_type)
        self.text_summary = TextSummary(text_channels, text_summary_embedding_dim)
        self.post_mlp = PostEncoderMLP(reference_encoder_out_dim + text_summary_embedding_dim,
                                       capacitron_VAE_embedding_dim)
        self.beta = nn.Parameter(torch.tensor(math.log(math.e - 1.0)))  # training only

    def posterior_stats(self, reference_mel, mel_lengths=None, text_embeddings=None,
                        text_lengths=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """The posterior's mean and (softplus) variance, before the 1e-6."""
        cond = [self.ref_encoder(reference_mel, mel_lengths)]
        if text_embeddings is not None:
            cond.append(self.text_summary(text_embeddings, text_lengths))
        return self.post_mlp(torch.cat(cond, -1))

    def forward(self, reference_mel: Optional[torch.Tensor], text_embeddings: torch.Tensor,
                text_lengths: Optional[torch.Tensor] = None,
                mel_lengths: Optional[torch.Tensor] = None, eps: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``z = mu + √(var + 1e-6) · eps`` for a reference mel, else
        ``z = eps``; ``eps`` ``[B, D]`` is drawn by :func:`normal` when not
        given."""
        B, D = text_embeddings.shape[0], self.embedding_dim
        if eps is None:
            eps = normal((B, D), generator)
        eps = eps.to(text_embeddings.device, text_embeddings.dtype)
        if reference_mel is None:
            return eps
        mu, var = self.posterior_stats(reference_mel, mel_lengths, text_embeddings, text_lengths)
        return mu + torch.sqrt(var + 1e-6) * eps
