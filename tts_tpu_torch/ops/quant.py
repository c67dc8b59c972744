"""Weight-only int8 serving (port of ``tts_tpu/ops/quant.py``) and K4, the
W8A16 product.

``quantize_int8`` gives a weight one fp32 scale per output channel,
``scale = max(max|w| / 127, 1e-12)`` over every other axis, and stores
``clip(round(w / scale), -127, 127)`` as int8 (round half to even, as
``jnp.round``): the JAX function's values and scales, bit for bit, on the
same weights. As there, it applies to a matmul or convolution weight of at
least :data:`MIN_ELEMS` elements; biases, norms and embeddings stay float.

The JAX package keeps the int8 tree in device memory and dequantizes inside
its jitted steps, where XLA fuses ``convert(int8) * scale`` into the
consuming dot. Eager PyTorch fuses nothing, so the port swaps the modules:
:func:`quantize_modules` replaces each eligible ``nn.Linear`` by an
:class:`Int8Linear` and each eligible ``nn.Conv1d`` by an
:class:`Int8Conv1d`, in place, and drops the float weights. The quantized
set is the image of the JAX set under the port's name map (a flax
``[in, out]`` / ``[k, in, out]`` kernel is torch's ``[out, in]`` /
``[out, in, k]`` weight; the scale is per output channel in both).

:class:`Int8Linear` runs :func:`int8_linear`: on CUDA tensors K4, the
hand-written kernel in ``csrc/int8_linear.cu`` (CUDA C++ for ``sm_90a``,
built by ``ops/cuda_build.py`` at first use, bound through ``ctypes``); on
CPU tensors, and only there, its plain version :func:`int8_linear_torch`.
K4 replaces no Pallas kernel: it stands for XLA's fusion of ``dequantize``
into the dot. :class:`Int8Conv1d` (Tortoise's conditioning encoder, run once
a voice) dequantizes into a transient float weight and runs ``F.conv1d``, as
the JAX package's eager paths do; its kernel-size-1 convolutions are not
routed through K4.

:func:`install_int8` is the model-side wiring (``quantize_weights_int8`` of
``Xtts``, ``Tortoise`` and ``Bark``); :func:`maybe_dequantize` gives the
float weight of a linear or convolution module, quantized or not.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import Iterable, List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .cuda_build import check_cuda, load_library

MIN_ELEMS = 4096  # the JAX ``quantize_int8``'s ``min_elems``


def quantize_int8(weight: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """A float weight ``[out, ...]`` in torch's layout → ``(int8 [out, ...],
    fp32 scale [out])``, symmetric per output channel, computed in fp32."""
    a = weight.detach().float()
    shape = (-1,) + (1,) * (a.dim() - 1)
    scale = torch.clamp(a.abs().amax(dim=tuple(range(1, a.dim()))) / 127.0, min=1e-12)
    q = torch.clamp(torch.round(a / scale.reshape(shape)), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """Inverse of :func:`quantize_int8`: ``q * scale`` in ``dtype``, each
    factor cast first, as the JAX ``dequantize`` does."""
    return q.to(dtype) * scale.to(dtype).reshape((-1,) + (1,) * (q.dim() - 1))


def int8_linear_torch(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                      bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of K4: ``(x · qᵀ) ⊙ scale (+ bias)`` in fp32, cast to
    ``x``'s type. ``x [..., K]``, ``q [N, K]`` int8, ``scale [N]``."""
    y = (x.reshape(-1, x.shape[-1]).float() @ q.float().T) * scale.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype).reshape(*x.shape[:-1], q.shape[0])


_NUM_ARGS = 13
_args = (ctypes.c_longlong * _NUM_ARGS)()  # filled and passed under _launch_lock
_launch_lock = threading.Lock()
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.lru_cache(maxsize=None)
def _kernel():
    """Build (at first use) and bind the C entry point, which takes its
    arguments packed in one int64 array (``enum Arg`` in the source)."""
    built = load_library("int8_linear")
    fn = built.lib.tts_int8_linear
    fn.argtypes = [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    n_args = built.lib.tts_int8_linear_num_args()
    if n_args != _NUM_ARGS:
        raise RuntimeError(f"int8_linear: the kernel takes {n_args} arguments, not {_NUM_ARGS}")
    return built, fn


def int8_linear(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``y [..., N] = (x [..., K] · q [N, K]ᵀ) ⊙ scale [N] (+ bias [N])``, the
    sum in fp32, ``y`` in ``x``'s type (fp32 or bf16). CPU tensors take
    :func:`int8_linear_torch`; CUDA tensors launch K4 on the current stream,
    or raise. ``x``'s rows may be strided; its last dim is made contiguous
    if it is not."""
    dev = x.device
    if dev.type == "cpu":
        return int8_linear_torch(x, q, scale, bias)
    if dev.type != "cuda":
        raise ValueError(f"int8_linear: unsupported device {dev}")
    N, K = q.shape
    if x.shape[-1] != K:
        raise ValueError(f"int8_linear: x {tuple(x.shape)} against weight {tuple(q.shape)}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"int8_linear: the kernel takes fp32 or bf16 activations, got {x.dtype}")
    if q.dtype != torch.int8 or not q.is_contiguous():
        raise TypeError(f"int8_linear: want a contiguous int8 weight, got {q.dtype}")
    if scale.dtype != torch.float32 or scale.shape != (N,) or not scale.is_contiguous():
        raise TypeError(f"int8_linear: want a contiguous fp32 scale [{N}], got "
                        f"{scale.dtype} {tuple(scale.shape)}")
    if q.device != dev or scale.device != dev or (bias is not None and bias.device != dev):
        raise ValueError(f"int8_linear: x on {dev}, weight on {q.device}, scale on {scale.device}")
    if bias is not None:
        if bias.shape != (N,):
            raise ValueError(f"int8_linear: bias {tuple(bias.shape)}, N={N}")
        bias = bias.to(x.dtype).contiguous()
    x2 = x.reshape(-1, K)
    if x2.stride(1) != 1:
        x2 = x2.contiguous()
    M = x2.shape[0]
    out = torch.empty((M, N), dtype=x.dtype, device=dev)
    if M == 0:
        return out.reshape(*x.shape[:-1], N)
    built, fn = _kernel()
    device = dev.index if dev.index is not None else torch.cuda.current_device()
    stream = torch._C._cuda_getCurrentRawStream(device)
    # 16-byte weight loads need rows that start on 16 bytes
    vec = int(K % 16 == 0 and q.data_ptr() % 16 == 0)
    with _launch_lock:  # several serving threads may decode at once
        _args[:] = (
            x2.data_ptr(), x2.stride(0), q.data_ptr(), scale.data_ptr(),
            0 if bias is None else bias.data_ptr(), out.data_ptr(), M, N, K,
            _DTYPES[x.dtype], vec, device, stream,
        )
        check_cuda(built, fn(_args), "int8_linear kernel launch")
        int8_linear.launches += 1
    return out.reshape(*x.shape[:-1], N)


int8_linear.launches = 0  # kernel launches since the count was last reset


class _Int8Weight(nn.Module):
    """An int8 weight ``weight_int8 [out, ...]`` with its fp32 ``scale
    [out]`` (buffers) and an optional float ``bias``. Moving the module to
    another dtype casts the bias; the scales stay fp32."""

    def _apply(self, fn, recurse=True):
        scale = self.scale
        super()._apply(fn, recurse)
        # fn casts floating tensors only: the int32 view keeps the bits
        self.scale = fn(scale.view(torch.int32)).view(torch.float32)
        return self

    def _init_from(self, module: nn.Module) -> None:
        q, scale = quantize_int8(module.weight)
        self.register_buffer("weight_int8", q)
        self.register_buffer("scale", scale)
        self.bias = module.bias  # the same float parameter, or None
        if self.bias is not None:
            self.bias.requires_grad_(False)  # inference only, as the int8 weight


class Int8Linear(_Int8Weight):
    """``nn.Linear`` with int8 weights ``[out_features, in_features]``
    through K4."""

    def __init__(self, linear: nn.Linear):
        super().__init__()
        self.in_features, self.out_features = linear.in_features, linear.out_features
        self._init_from(linear)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return int8_linear(x, self.weight_int8, self.scale, self.bias)

    def extra_repr(self) -> str:
        return (f"in_features={self.in_features}, out_features={self.out_features}, "
                f"bias={self.bias is not None}")


class Int8Conv1d(_Int8Weight):
    """``nn.Conv1d`` with int8 weights ``[out, in / groups, k]``: dequantized
    into a transient weight of ``compute_dtype`` (the input's type where it
    is None) for each call."""

    def __init__(self, conv: nn.Conv1d, compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        if conv.padding_mode != "zeros" or isinstance(conv.padding, str):
            raise ValueError(f"Int8Conv1d: padding {conv.padding!r} / {conv.padding_mode!r} "
                             f"is not taken")
        self.stride, self.padding = conv.stride, conv.padding
        self.dilation, self.groups = conv.dilation, conv.groups
        self.compute_dtype = compute_dtype
        self._init_from(conv)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = maybe_dequantize(self, self.compute_dtype or x.dtype)
        dt = torch.promote_types(x.dtype, w.dtype)  # flax promotes input and kernel alike
        bias = None if self.bias is None else self.bias.to(dt)
        return F.conv1d(x.to(dt), w.to(dt), bias, self.stride, self.padding, self.dilation,
                        self.groups)


def maybe_dequantize(module: nn.Module, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The float weight of a linear or convolution module: its ``weight``, or
    the dequantized int8 one (in ``dtype``, fp32 by default)."""
    if isinstance(module, _Int8Weight):
        return dequantize(module.weight_int8, module.scale, dtype or torch.float32)
    return module.weight if dtype is None else module.weight.to(dtype)


def _eligible(module: nn.Module, min_elems: int) -> bool:
    return (type(module) in (nn.Linear, nn.Conv1d) and module.weight.is_floating_point()
            and module.weight.numel() >= min_elems)


def quantize_modules(root: nn.Module, min_elems: int = MIN_ELEMS,
                     compute_dtype: Optional[torch.dtype] = None) -> List[str]:
    """Swap every ``nn.Linear`` and ``nn.Conv1d`` under ``root`` whose weight
    has at least ``min_elems`` elements for its int8 counterpart, in place;
    the float weights go with the old modules. Returns the swapped modules'
    names, relative to ``root``."""
    swaps = [(parent, child_name, f"{name}.{child_name}".lstrip("."), child)
             for name, parent in root.named_modules()
             for child_name, child in parent.named_children() if _eligible(child, min_elems)]
    for parent, child_name, _, child in swaps:
        new = Int8Linear(child) if type(child) is nn.Linear else Int8Conv1d(child, compute_dtype)
        setattr(parent, child_name, new)
    return [name for _, _, name, _ in swaps]


def install_int8(model: nn.Module, attr_names: Iterable[str],
                 compute_dtype: Optional[torch.dtype] = None) -> None:
    """Model-side wiring: quantize the named submodules of ``model`` in place
    (``is_quantized`` then tells). ``compute_dtype`` is the type of the
    transient weights the quantized convolutions dequantize into (None:
    their input's); K4's products sum in fp32 whatever it is."""
    for attr in attr_names:
        sub = getattr(model, attr, None)
        if sub is not None:
            quantize_modules(sub, compute_dtype=compute_dtype)


def is_quantized(module: nn.Module) -> bool:
    """True if any submodule holds int8 weights."""
    return any(isinstance(m, _Int8Weight) for m in module.modules())


def quantized_bytes(module: nn.Module) -> int:
    """Bytes of the module's parameters and buffers, each tensor once."""
    seen = {}
    for t in list(module.parameters()) + list(module.buffers()):
        seen[t.data_ptr(), t.numel()] = t.numel() * t.element_size()
    return sum(seen.values())
