"""tts_tpu_torch — the PyTorch/CUDA port of tts_tpu for one NVIDIA H100.

Mirrors ``tts_tpu/``'s file tree, one port file per counterpart. Plain
tensor code is PyTorch; each Pallas kernel of ``tts_tpu`` becomes a kernel
written by hand for Hopper (``csrc/``), built from source at first use. The
package imports ``torch`` and never ``jax``, ``flax`` or ``tokenizers``, and
nothing of ``tts_tpu`` either: what it needs of the JAX package's jax-free
host modules (config classes, text front ends, checkpoint converters) it
keeps as its own copies, each docstring naming the source.

The API, synthesizer and server take a ``device`` that defaults to
``"cuda"`` and raise when CUDA is missing; nothing picks the CPU by itself.
"""

__version__ = "0.1.0"


def resolve_device(device="cuda"):
    """``torch.device`` for a user-facing entry point. A CUDA device must
    exist; the CPU is used only when asked for by name."""
    import torch

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "tts_tpu_torch: CUDA is not available; pass device='cpu' explicitly "
            "to run the plain PyTorch path on the CPU"
        )
    return device
