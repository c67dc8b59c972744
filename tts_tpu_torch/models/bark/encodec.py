"""EnCodec 24 kHz in PyTorch: residual-VQ codebooks and the causal SEANet
decoder and encoder (port of ``tts_tpu/models/bark/encodec.py``; reference
``bark/inference_funcs.py:599 codec_decode`` through the ``encodec``
package or HF ``EncodecModel``; Défossez et al., 2022, arXiv:2210.13438).

Bark's waveform stage: 8 × 1024 residual codebooks → summed embeddings →
causal conv stack (weight norm folded by the converter) with a 2-layer
LSTM and its skip connection → (8, 5, 4, 2) transposed-conv upsampling to
24 kHz mono. The encoder mirrors it for voice prompts.

Module names follow the JAX modules' flax names, which are the HF
``EncodecDecoder.layers`` / ``EncodecEncoder.layers`` indices (an ELU takes
an index there too): ``layer_<i>`` holds a ``conv`` (a convolution, a
transposed convolution or a resnet block's ``block_1``/``block_3``/
``shortcut``); the LSTMs are one ``nn.LSTM`` named ``lstm``.
:func:`tts_tpu_torch.utils.convert.encodec_from_jax_params` carries flax
params, :func:`tts_tpu_torch.utils.convert.load_reference_encodec` reads a
reference checkpoint.

Tensors are channels-first ``[B, C, T]`` inside (PyTorch's convolutions);
:meth:`EncodecVocoder.decode` takes codes ``[n_q, T]`` and returns samples
``[T * 320]``. Codes outside a codebook raise: the JAX package's gather
clamps them, ``nn.Embedding`` and CUDA gathers would fault.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

__all__ = ["EncodecDecoder", "EncodecEncoder", "EncodecVocoder", "rvq_decode", "rvq_encode"]


def _pad_causal(x: torch.Tensor, left: int, right: int = 0, mode: str = "reflect") -> torch.Tensor:
    """Pad the time axis of ``[B, C, T]``, as HF ``_pad1d`` does: reflect
    padding needs ``pad < T``, so a short input gets zeros on its right
    first, trimmed afterwards."""
    if left == 0 and right == 0:
        return x
    if mode != "reflect":
        return F.pad(x, (left, right))
    L = x.shape[-1]
    extra = max(0, max(left, right) - L + 1)
    if extra:
        x = F.pad(x, (0, extra))
    y = F.pad(x, (left, right), mode="reflect")
    return y[..., : y.shape[-1] - extra] if extra else y


class CausalConv1d(nn.Module):
    """Causal conv: left pad ``(K-1)·dilation + 1 - stride``, plus zeros on
    the right to a whole number of frames (HF ``EncodecConv1d``)."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int, dilation: int = 1,
                 stride: int = 1, pad_mode: str = "reflect"):
        super().__init__()
        self.kernel_size, self.dilation, self.stride = kernel_size, dilation, stride
        self.pad_mode = pad_mode
        self.conv = nn.Conv1d(in_ch, out_ch, kernel_size, stride=stride, dilation=dilation)

    def forward(self, x):
        K = (self.kernel_size - 1) * self.dilation + 1  # effective kernel
        pad_total = K - self.stride
        L = x.shape[-1]
        n_frames = -(-(L - K + pad_total) // self.stride)
        ideal = n_frames * self.stride + K - pad_total
        extra = max(0, ideal - L)
        return self.conv(_pad_causal(x, pad_total, extra, self.pad_mode))


class CausalConvTranspose1d(nn.Module):
    """Transposed conv with the right side of its padding trimmed
    (``trim_right_ratio=1``): ``[B, C, T]`` → ``[B, C', T·stride]``."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int, stride: int):
        super().__init__()
        self.stride = stride
        self.conv = nn.ConvTranspose1d(in_ch, out_ch, kernel_size, stride=stride)

    def forward(self, x):
        return self.conv(x)[..., : x.shape[-1] * self.stride]


class EncodecResnetBlock(nn.Module):
    """SEANet residual block: ELU → conv(k, dilation) → ELU → conv(1), plus
    a 1×1 shortcut."""

    def __init__(self, dim: int, dilation: int, residual_kernel_size: int = 3,
                 compress: int = 2, pad_mode: str = "reflect"):
        super().__init__()
        hidden = dim // compress
        self.block_1 = CausalConv1d(dim, hidden, residual_kernel_size, dilation,
                                    pad_mode=pad_mode)
        self.block_3 = CausalConv1d(hidden, dim, 1, pad_mode=pad_mode)
        self.shortcut = CausalConv1d(dim, dim, 1, pad_mode=pad_mode)

    def forward(self, x):
        h = self.block_3(F.elu(self.block_1(F.elu(x))))
        return self.shortcut(x) + h


class _Seanet(nn.Module):
    def __init__(self, hidden_size: int = 128, num_filters: int = 32,
                 upsampling_ratios: Sequence[int] = (8, 5, 4, 2), kernel_size: int = 7,
                 last_kernel_size: int = 7, residual_kernel_size: int = 3,
                 num_lstm_layers: int = 2, compress: int = 2, dilation_growth_rate: int = 2,
                 num_residual_layers: int = 1, pad_mode: str = "reflect"):
        super().__init__()
        self.hidden_size, self.num_filters = hidden_size, num_filters
        self.upsampling_ratios = tuple(upsampling_ratios)
        self.kernel_size, self.last_kernel_size = kernel_size, last_kernel_size
        self.residual_kernel_size, self.num_lstm_layers = residual_kernel_size, num_lstm_layers
        self.compress, self.dilation_growth_rate = compress, dilation_growth_rate
        self.num_residual_layers, self.pad_mode = num_residual_layers, pad_mode

    def _resblocks(self, dim: int, idx: int) -> int:
        for j in range(self.num_residual_layers):
            idx += 1
            self.add_module(f"layer_{idx}", EncodecResnetBlock(
                dim, self.dilation_growth_rate**j, self.residual_kernel_size, self.compress,
                self.pad_mode))
        return idx

    def _lstm(self, x):  # [B, C, T] → the LSTM stack's output, [B, C, T]
        return self.lstm(x.transpose(1, 2))[0].transpose(1, 2)


class EncodecDecoder(_Seanet):
    """Causal SEANet decoder: latents ``[B, hidden, T]`` → wav ``[B, 1,
    T·hop]`` (hop = prod(ratios) = 320 for the 24 kHz model)."""

    def __init__(self, audio_channels: int = 1, **kw):
        super().__init__(**kw)
        dim = 2 ** len(self.upsampling_ratios) * self.num_filters
        self.layer_0 = CausalConv1d(self.hidden_size, dim, self.kernel_size,
                                    pad_mode=self.pad_mode)
        self.lstm = nn.LSTM(dim, dim, self.num_lstm_layers, batch_first=True)
        idx = 2
        self.order = []
        for ratio in self.upsampling_ratios:
            idx += 1  # the ELU occupies an index in the HF ModuleList
            self.add_module(f"layer_{idx}", CausalConvTranspose1d(dim, dim // 2, ratio * 2, ratio))
            first = idx
            dim //= 2
            idx = self._resblocks(dim, idx)
            self.order.append(list(range(first, idx + 1)))
            idx += 1
        idx += 1
        self.out_index = idx
        self.add_module(f"layer_{idx}", CausalConv1d(dim, audio_channels, self.last_kernel_size,
                                                     pad_mode=self.pad_mode))

    def forward(self, x):
        x = self.layer_0(x)
        x = x + self._lstm(x)
        for stage in self.order:
            x = F.elu(x)
            for i in stage:
                x = getattr(self, f"layer_{i}")(x)
        return getattr(self, f"layer_{self.out_index}")(F.elu(x))


class EncodecEncoder(_Seanet):
    """Causal SEANet encoder (HF ``EncodecEncoder``): wav ``[B, 1, T]`` →
    latents ``[B, hidden, T/hop]``, for Bark's voice prompts."""

    def __init__(self, **kw):
        super().__init__(**kw)
        dim = self.num_filters
        self.layer_0 = CausalConv1d(1, dim, self.kernel_size, pad_mode=self.pad_mode)
        idx = 0
        self.order = []
        for ratio in reversed(self.upsampling_ratios):
            first = idx + 1
            idx = self._resblocks(dim, idx)
            idx += 2  # the ELU, then the strided conv
            self.add_module(f"layer_{idx}", CausalConv1d(dim, dim * 2, ratio * 2, stride=ratio,
                                                         pad_mode=self.pad_mode))
            self.order.append((list(range(first, idx - 1)), idx))
            dim *= 2
        self.lstm = nn.LSTM(dim, dim, self.num_lstm_layers, batch_first=True)
        self.out_index = idx + 3
        self.add_module(f"layer_{idx + 3}", CausalConv1d(dim, self.hidden_size,
                                                         self.last_kernel_size,
                                                         pad_mode=self.pad_mode))

    def forward(self, x):
        x = self.layer_0(x)
        for blocks, down in self.order:
            for i in blocks:
                x = getattr(self, f"layer_{i}")(x)
            x = getattr(self, f"layer_{down}")(F.elu(x))
        x = F.elu(x + self._lstm(x))
        return getattr(self, f"layer_{self.out_index}")(x)


def _check_codes(codes: torch.Tensor, bins: int) -> None:
    if codes.numel() and (int(codes.min()) < 0 or int(codes.max()) >= bins):
        raise ValueError(f"EnCodec codes must lie in [0, {bins}); got "
                         f"[{int(codes.min())}, {int(codes.max())}]")


def rvq_decode(codes: torch.Tensor, codebooks: torch.Tensor) -> torch.Tensor:
    """Residual-VQ decode: codes ``[n_q, T]`` and codebooks ``[n_q, bins,
    D]`` → latents ``[1, D, T]``, the sum of each stage's embedding (HF
    ``EncodecResidualVectorQuantizer.decode``)."""
    n_q = codes.shape[0]
    _check_codes(codes, codebooks.shape[1])
    emb = torch.stack([codebooks[q][codes[q]] for q in range(n_q)])  # [n_q, T, D]
    return emb.sum(dim=0).T[None]


def rvq_encode(latents: torch.Tensor, codebooks: torch.Tensor,
               n_q: Optional[int] = None) -> torch.Tensor:
    """Residual-VQ encode: latents ``[1, D, T]`` → codes ``[n_q, T]``, each
    stage the nearest entry to the residual (HF
    ``EncodecResidualVectorQuantizer.encode``: argmax of 2·x·e − |e|²)."""
    x = latents[0].T  # [T, D]
    n_q = codebooks.shape[0] if n_q is None else n_q
    codes = []
    for q in range(n_q):
        e = codebooks[q]
        idx = torch.argmax(2 * x @ e.T - (e**2).sum(dim=-1)[None], dim=-1)
        codes.append(idx)
        x = x - e[idx]
    return torch.stack(codes)


class EncodecVocoder(nn.Module):
    """The codebooks ``[n_q, bins, D]`` and the decoder (and the encoder,
    where the checkpoint holds one): ``decode(codes)`` / ``encode(wav)``.
    Bark decodes at 6 kbps: 8 codebooks (reference ``bark.py:43``)."""

    def __init__(self, decoder: EncodecDecoder, codebooks: torch.Tensor,
                 encoder: Optional[EncodecEncoder] = None, n_q: int = 8):
        super().__init__()
        self.decoder = decoder
        self.encoder = encoder
        self.register_buffer("codebooks", codebooks)
        self.n_q = min(n_q, codebooks.shape[0])

    @property
    def can_encode(self) -> bool:
        return self.encoder is not None

    @property
    def hop(self) -> int:
        return int(np.prod(self.decoder.upsampling_ratios))

    @torch.no_grad()
    def decode(self, codes) -> torch.Tensor:
        """``[n_q, T]`` integer codes → ``[T·hop]`` float samples."""
        codes = torch.as_tensor(codes, device=self.codebooks.device).long()
        return self.decoder(rvq_decode(codes, self.codebooks))[0, 0]

    @torch.no_grad()
    def encode(self, wav, n_q: Optional[int] = None) -> torch.Tensor:
        """``[T]`` float samples at 24 kHz → ``[n_q, T/hop]`` codes."""
        x = torch.as_tensor(np.asarray(wav, np.float32)).reshape(1, 1, -1)
        codes = rvq_encode(self.encoder(x.to(self.codebooks.device)), self.codebooks, self.n_q)
        return codes[: n_q or self.n_q]
