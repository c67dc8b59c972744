"""bf16 mixed precision (port of ``tts_tpu/trainer/precision.py``).

The JAX package's ``mp_value_and_grad`` casts the differentiated
parameters and every float input to bf16 and upcasts the gradients, so its
forward runs on bf16 copies of the weights. The port keeps the fp32
parameters as they are and runs the forward under ``torch.autocast`` in
bf16: matmuls and convolutions compute in bf16, reductions and losses that
autocast keeps in fp32 stay fp32, and the gradients land on the fp32
parameters. That is a named divergence: the two agree in fp32 (mixed
precision off), and in bf16 the port's step is held only to be finite and
near its fp32 step. No loss scaling is needed: bf16 has fp32's exponent
range.
"""

from __future__ import annotations

import contextlib

import torch

__all__ = ["is_mixed_precision", "autocast"]


def is_mixed_precision(config) -> bool:
    """``mixed_precision`` on and ``precision`` bf16 (the JAX package's test)."""
    return bool(getattr(config, "mixed_precision", False)) and (
        getattr(config, "precision", "bf16") in ("bf16", "bfloat16"))


def autocast(device: torch.device, enabled: bool):
    """bf16 autocast on ``device``'s type when ``enabled``, else nothing."""
    if not enabled:
        return contextlib.nullcontext()
    return torch.autocast(device_type=torch.device(device).type, dtype=torch.bfloat16)
