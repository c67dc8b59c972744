"""Piecewise rational-quadratic spline (Durkan et al., Neural Spline Flows)
used by the VITS stochastic duration predictor (port of
``tts_tpu/models/vits/transforms.py``), both directions.

As in the JAX package the spline is evaluated for every element and
blended with the identity tails by ``torch.where`` (no boolean indexing), so
the result does not depend on which elements lie inside the interval.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

DEFAULT_MIN_BIN_WIDTH = 1e-3
DEFAULT_MIN_BIN_HEIGHT = 1e-3
DEFAULT_MIN_DERIVATIVE = 1e-3


def _knots(unnormalized: torch.Tensor, min_bin: float, tail_bound: float):
    """Softmaxed bin sizes → (cumulative knots ``[..., n+1]``, sizes ``[..., n]``)
    on ``[-tail_bound, tail_bound]``, end knots pinned exactly."""
    num_bins = unnormalized.shape[-1]
    sizes = torch.softmax(unnormalized, dim=-1)
    sizes = min_bin + (1 - min_bin * num_bins) * sizes
    cum = F.pad(torch.cumsum(sizes, dim=-1), (1, 0))
    cum = (2 * tail_bound) * cum - tail_bound
    cum[..., 0] = -tail_bound
    cum[..., -1] = tail_bound
    return cum, cum[..., 1:] - cum[..., :-1]


def piecewise_rational_quadratic_transform(
    inputs: torch.Tensor,
    unnormalized_widths: torch.Tensor,
    unnormalized_heights: torch.Tensor,
    unnormalized_derivatives: torch.Tensor,
    inverse: bool = False,
    tails: str = "linear",
    tail_bound: float = 5.0,
    min_bin_width: float = DEFAULT_MIN_BIN_WIDTH,
    min_bin_height: float = DEFAULT_MIN_BIN_HEIGHT,
    min_derivative: float = DEFAULT_MIN_DERIVATIVE,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Monotonic RQ spline on ``[-tail_bound, tail_bound]``, identity outside.

    ``inputs``: ``[...]``; ``unnormalized_*``: ``[..., num_bins(|num_bins-1)]``.
    Returns (outputs, logabsdet) elementwise.
    """
    if tails != "linear":
        raise ValueError("only linear tails are used by VITS")
    num_bins = unnormalized_widths.shape[-1]
    inside = (inputs >= -tail_bound) & (inputs <= tail_bound)

    # linear tails: pad derivative endpoints with the constant whose
    # softplus is exactly 1 (identity slope at the boundary)
    constant = math.log(math.exp(1 - min_derivative) - 1)
    unnormalized_derivatives = F.pad(unnormalized_derivatives, (1, 1), value=constant)

    cumwidths, widths = _knots(unnormalized_widths, min_bin_width, tail_bound)
    cumheights, heights = _knots(unnormalized_heights, min_bin_height, tail_bound)
    # softplus as log(exp(u) + 1), the JAX package's logaddexp(u, 0)
    derivatives = min_derivative + torch.logaddexp(
        unnormalized_derivatives, torch.zeros_like(unnormalized_derivatives))

    # clamp to the interval so tail elements still index a valid bin
    x = torch.clamp(inputs, -tail_bound, tail_bound)
    bins = cumheights if inverse else cumwidths
    # bin index: number of knots <= x, minus 1 (reference searchsorted)
    idx = torch.sum((x[..., None] >= bins[..., 1:]).to(torch.int64), dim=-1)
    idx = torch.clamp(idx, 0, num_bins - 1)[..., None]

    def pick(t):
        return torch.gather(t, -1, idx)[..., 0]

    input_cumwidths = pick(cumwidths)
    input_bin_widths = pick(widths)
    input_cumheights = pick(cumheights)
    input_heights = pick(heights)
    delta = input_heights / input_bin_widths
    input_derivatives = pick(derivatives)
    input_derivatives_p1 = pick(derivatives[..., 1:])

    if inverse:
        y_rel = x - input_cumheights
        term = y_rel * (input_derivatives + input_derivatives_p1 - 2 * delta)
        a = input_heights * (delta - input_derivatives) + term
        b = input_heights * input_derivatives - term
        c = -delta * y_rel
        discriminant = torch.clamp(b**2 - 4 * a * c, min=0.0)
        root = (2 * c) / (-b - torch.sqrt(discriminant))
        outputs = root * input_bin_widths + input_cumwidths
        theta_one_minus_theta = root * (1 - root)
        denominator = delta + (
            (input_derivatives + input_derivatives_p1 - 2 * delta) * theta_one_minus_theta
        )
        derivative_numerator = delta**2 * (
            input_derivatives_p1 * root**2
            + 2 * delta * theta_one_minus_theta
            + input_derivatives * (1 - root) ** 2
        )
        logabsdet = -(torch.log(derivative_numerator) - 2 * torch.log(denominator))
    else:
        theta = (x - input_cumwidths) / input_bin_widths
        theta_one_minus_theta = theta * (1 - theta)
        numerator = input_heights * (delta * theta**2 + input_derivatives * theta_one_minus_theta)
        denominator = delta + (
            (input_derivatives + input_derivatives_p1 - 2 * delta) * theta_one_minus_theta
        )
        outputs = input_cumheights + numerator / denominator
        derivative_numerator = delta**2 * (
            input_derivatives_p1 * theta**2
            + 2 * delta * theta_one_minus_theta
            + input_derivatives * (1 - theta) ** 2
        )
        logabsdet = torch.log(derivative_numerator) - 2 * torch.log(denominator)

    outputs = torch.where(inside, outputs, inputs)
    logabsdet = torch.where(inside, logabsdet, torch.zeros_like(logabsdet))
    return outputs, logabsdet
