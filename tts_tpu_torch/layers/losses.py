"""Masked losses of the acoustic models (port of ``tts_tpu/layers/losses.py``,
reference ``TTS/tts/layers/losses.py``): masked L1, MSE and Huber, the
masked binary cross-entropy, SSIM with its Gaussian window and per-sample
min-max normalisation, the CTC forward-sum alignment loss, the binary
alignment loss and the differential spectral loss.

Every loss takes padded time-major tensors and a length vector, as in the
JAX package. Two forms differ from the JAX package's while computing the
same function:

* ``forward_sum_loss`` is ``F.ctc_loss(zero_infinity=True)`` over the
  aligner's log-probabilities with a blank column at ``blank_logprob``,
  the reference's ``ForwardSumLoss``; the JAX package runs the CTC lattice
  as a ``lax.scan`` over the frames. Where a sample cannot be aligned
  (fewer frames than tokens) torch's ``zero_infinity`` gives it 0 and the
  JAX lattice's finite -1e9 gives it ~1e9 / tokens
  (``tests/test_torch_tts_losses.py`` names the case).
* ``ssim_loss`` blurs with two ``conv1d`` passes (zero padding, as
  ``jnp.convolve(mode="same")``), and its min and max share their
  gradient evenly between ties (``torch.amin``/``amax``, as JAX's
  reductions do).
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from tts_tpu_torch.ops.helpers import sequence_mask

__all__ = [
    "l1_loss_masked",
    "mse_loss_masked",
    "bce_loss_masked",
    "ssim_loss",
    "forward_sum_loss",
    "binary_alignment_loss",
    "huber_loss",
    "differential_spectral_loss",
]


def _frame_mask(lengths: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return sequence_mask(lengths, y.shape[1])[:, :, None].to(y.dtype)


def l1_loss_masked(y_hat, y, lengths, seq_len_norm: bool = False):
    """L1 over the valid frames ``[B, T, C]`` (reference ``losses.py:16``)."""
    mask = _frame_mask(lengths, y)
    err = torch.abs(y_hat - y) * mask
    if seq_len_norm:
        per_sample = err.sum(dim=(1, 2)) / (torch.clamp(lengths, min=1) * y.shape[2])
        return per_sample.mean()
    return err.sum() / torch.clamp(mask.sum() * y.shape[2], min=1.0)


def mse_loss_masked(y_hat, y, lengths, seq_len_norm: bool = False):
    """MSE over the valid frames ``[B, T, C]`` (reference ``losses.py:55``)."""
    mask = _frame_mask(lengths, y)
    err = (y_hat - y) ** 2 * mask
    if seq_len_norm:
        per_sample = err.sum(dim=(1, 2)) / (torch.clamp(lengths, min=1) * y.shape[2])
        return per_sample.mean()
    return err.sum() / torch.clamp(mask.sum() * y.shape[2], min=1.0)


def huber_loss(y_hat, y, lengths, delta: float = 1.0):
    """Huber over the valid frames, divided by the frame count (the JAX
    package's norm: not by the channels)."""
    mask = _frame_mask(lengths, y)
    diff = (y_hat - y) * mask
    abs_diff = torch.abs(diff)
    err = torch.where(abs_diff <= delta, 0.5 * diff**2, delta * (abs_diff - 0.5 * delta))
    return err.sum() / torch.clamp(mask.sum(), min=1.0)


def bce_loss_masked(logits, targets, lengths, pos_weight: float = 1.0):
    """Binary cross-entropy of ``logits [B, T]`` over the valid frames with
    the positive class weighted (reference ``losses.py:157``)."""
    mask = sequence_mask(lengths, targets.shape[1]).to(logits.dtype)
    bce = -(pos_weight * targets * F.logsigmoid(logits)
            + (1.0 - targets) * F.logsigmoid(-logits))
    return (bce * mask).sum() / torch.clamp(mask.sum(), min=1.0)


# ---------------------------------------------------------------------------
# SSIM
# ---------------------------------------------------------------------------


def _gaussian_kernel(size: int = 11, sigma: float = 1.5, device=None) -> torch.Tensor:
    x = torch.arange(size, device=device, dtype=torch.float32) - size // 2
    g = torch.exp(-(x**2) / (2 * sigma**2))
    return g / g.sum()


def _blur(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """``[B, H, W]`` convolved with ``kernel`` along H, then along W (zero
    padding, the output the input's size)."""
    B, H, W = x.shape
    k = kernel.to(x.dtype)[None, None, :]
    pad = kernel.shape[0] // 2
    x = F.conv1d(x.transpose(1, 2).reshape(B * W, 1, H), k, padding=pad)
    x = x.reshape(B, W, H).transpose(1, 2)
    x = F.conv1d(x.reshape(B * H, 1, W), k, padding=pad)
    return x.reshape(B, H, W)


def _ssim_2d(a, b, k1: float = 0.01, k2: float = 0.03, win: int = 11, sigma: float = 1.5):
    """Mean SSIM over ``[B, H, W]`` images in [0, 1] (a separable Gaussian
    window)."""
    kernel = _gaussian_kernel(win, sigma, a.device)
    mu_a, mu_b = _blur(a, kernel), _blur(b, kernel)
    var_a = _blur(a * a, kernel) - mu_a**2
    var_b = _blur(b * b, kernel) - mu_b**2
    cov = _blur(a * b, kernel) - mu_a * mu_b
    c1, c2 = k1**2, k2**2
    ssim_map = ((2 * mu_a * mu_b + c1) * (2 * cov + c2)) / (
        (mu_a**2 + mu_b**2 + c1) * (var_a + var_b + c2))
    return ssim_map.mean()


def ssim_loss(y_hat, y, lengths):
    """``1 - SSIM`` of the valid frames, each sample min-max normalised over
    its valid frames, clipped to [0, 1] (reference ``losses.py:105`` and
    ``ssim.py``)."""
    mask = _frame_mask(lengths, y)
    valid = mask > 0

    def norm(x):
        mn = torch.amin(torch.where(valid, x, math.inf), dim=(1, 2), keepdim=True)
        mx = torch.amax(torch.where(valid, x, -math.inf), dim=(1, 2), keepdim=True)
        return (x - mn) / torch.clamp(mx - mn, min=1e-8)

    val = 1.0 - _ssim_2d(norm(y) * mask, norm(y_hat) * mask)
    return torch.clamp(val, 0.0, 1.0)


# ---------------------------------------------------------------------------
# alignment losses
# ---------------------------------------------------------------------------


def forward_sum_loss(attn_logprob, in_lens, out_lens, blank_logprob: float = -1.0):
    """CTC forward-sum over the monotonic alignments of tokens ``1..K`` to
    the frames (reference ``losses.py:279`` ForwardSumLoss).

    Args:
        attn_logprob: ``[B, T_de, T_en]`` unnormalised alignment logits (the
            aligner's ``attn_logp``).
        in_lens: ``[B]`` text lengths.
        out_lens: ``[B]`` mel lengths.
    """
    B, T_de, T_en = attn_logprob.shape
    logp = F.pad(attn_logprob, (1, 0), value=blank_logprob)  # the blank class first
    key_ids = torch.arange(T_en + 1, device=logp.device)[None, None, :]
    logp = torch.where(key_ids <= in_lens[:, None, None], logp, torch.full_like(logp, -1e9))
    logp = torch.log_softmax(logp.float(), dim=-1)
    targets = torch.arange(1, T_en + 1, device=logp.device).expand(B, T_en)
    return F.ctc_loss(logp.transpose(0, 1), targets, out_lens.long(), in_lens.long(),
                      blank=0, reduction="mean", zero_infinity=True)


def binary_alignment_loss(alignment_hard, alignment_soft):
    """Pull the soft attention toward the hard MAS path (reference
    ``losses.py:821``)."""
    log_sum = (torch.log(torch.clamp(alignment_soft, min=1e-12)) * alignment_hard).sum()
    return -log_sum / torch.clamp(alignment_hard.sum(), min=1.0)


def differential_spectral_loss(y_hat, y, lengths,
                               loss_fn: Optional[Callable] = None):
    """``loss_fn`` (masked MSE by default) on the frames' first differences
    (reference ``losses.py:208`` DifferentialSpectralLoss)."""
    fn = loss_fn or mse_loss_masked
    return fn(y_hat[:, 1:] - y_hat[:, :-1], y[:, 1:] - y[:, :-1], lengths - 1)
