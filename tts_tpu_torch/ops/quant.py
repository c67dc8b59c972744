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

:class:`Int8Linear` runs K4, the hand-written kernel in
``csrc/int8_linear.cu`` (CUDA C++ for ``sm_90a``, built by
``ops/cuda_build.py`` at first use, bound through ``ctypes``), on CUDA
tensors; on CPU tensors, and only there, its plain version
:func:`int8_linear_torch`. K4 replaces no Pallas kernel: it stands for XLA's
fusion of ``dequantize`` into the dot. The module checks its buffers when
it is built and after every move, and keeps one C descriptor of them for
each activation type it takes, so a call checks only ``x`` and passes six
arguments to the kernel; the public :func:`int8_linear` checks bare tensors on
every call. Launches share no state between threads: no lock, a descriptor
per weight, and a launch count kept per thread (``int8_linear.launches``).
:class:`Int8Conv1d` (Tortoise's conditioning encoder, run once a voice)
dequantizes into a transient float weight and runs ``F.conv1d``, as the JAX
package's eager paths do; its kernel-size-1 convolutions are not routed
through K4.

:func:`install_int8` is the model-side wiring (``quantize_weights_int8`` of
``Xtts``, ``Tortoise`` and ``Bark``); :func:`maybe_dequantize` gives the
float weight of a linear or convolution module, quantized or not.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import Dict, Iterable, List, Optional, Tuple

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


def bf16_split3(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The exact split K4 makes of fp32 activations: ``hi = bf16(x)``,
    ``mid = bf16(x - hi)``, ``lo = bf16(x - hi - mid)`` (each remainder exact
    in fp32), returned as bf16 tensors. ``hi + mid + lo == x`` bit for bit
    barring underflow below ~2^-110 and overflow within 2^-8 of the fp32
    maximum, and each part's product with an int8 value is exact in fp32."""
    x = x.float()
    hi = x.bfloat16()
    r = x - hi.float()
    mid = r.bfloat16()
    return hi, mid, (r - mid.float()).bfloat16()


def int8_linear_split_torch(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                            bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The arithmetic of K4's fp32 path in plain PyTorch: the three parts of
    :func:`bf16_split3` multiplied with ``q`` apiece (exact products, fp32
    sums) and added as ``hi + (mid + lo)`` before the scale and bias."""
    parts = [(p.float().reshape(-1, x.shape[-1]) @ q.float().T) for p in bf16_split3(x)]
    y = (parts[0] + (parts[1] + parts[2])) * scale.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype).reshape(*x.shape[:-1], q.shape[0])


_DTYPES = {torch.float32: 0, torch.bfloat16: 1}  # bit 0 of the descriptor's flags
VARIANTS = {"auto": 0, "gemv": 1, "skinny": 2, "tile": 3}  # bits 1-2 (``csrc`` enum Variant)


class _Desc(ctypes.Structure):
    """One weight's constants for the C entry point (``struct Desc`` in the
    source, field for field)."""

    _fields_ = [("q", ctypes.c_void_p), ("scale", ctypes.c_void_p), ("bias", ctypes.c_void_p),
                ("N", ctypes.c_int), ("K", ctypes.c_int), ("flags", ctypes.c_int),
                ("device", ctypes.c_int)]


@functools.lru_cache(maxsize=None)
def _kernel():
    """Build (at first use) and bind the C entry point ``tts_int8_linear(desc,
    x, x_row_stride, out, M, stream)``."""
    built = load_library("int8_linear")
    fn = built.lib.tts_int8_linear
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    size = built.lib.tts_int8_linear_desc_bytes()
    if size != ctypes.sizeof(_Desc):
        raise RuntimeError(f"int8_linear: the kernel's descriptor has {size} bytes, the "
                           f"wrapper's {ctypes.sizeof(_Desc)}")
    return built, fn


class _Launcher:
    """K4's launch for one checked weight: a C descriptor for each activation
    type it takes (both without a bias, the bias's own with one), holding the
    pointers of ``q``, ``scale`` and ``bias``, which it keeps alive. A call
    passes x, its row stride, a new output, M and the current stream, and
    shares nothing with another thread's call."""

    __slots__ = ("N", "K", "device", "index", "addrs", "_descs", "_tensors", "_built", "_fn")

    def __init__(self, q, scale, bias, dtypes, variant: int = 0):
        self._built, self._fn = _kernel()
        self.N, self.K = q.shape
        self.device, self.index = q.device, q.device.index
        self._descs = {dt: _Desc(q.data_ptr(), scale.data_ptr(),
                                 0 if bias is None else bias.data_ptr(), self.N, self.K,
                                 _DTYPES[dt] | variant << 1, self.index) for dt in dtypes}
        self.addrs = {dt: ctypes.addressof(d) for dt, d in self._descs.items()}
        self._tensors = (q, scale, bias)

    def __call__(self, x: torch.Tensor, addr: int) -> torch.Tensor:
        K = self.K
        if x.is_contiguous():
            rows, stride = x, K
        else:
            rows = x.reshape(-1, K)
            if rows.stride(1) != 1:
                rows = rows.contiguous()
            stride = rows.stride(0)
        out = torch.empty(x.shape[:-1] + (self.N,), dtype=x.dtype, device=self.device)
        M = x.numel() // K
        if M:
            code = self._fn(addr, rows.data_ptr(), stride, out.data_ptr(), M,
                            torch._C._cuda_getCurrentRawStream(self.index))
            if code:
                check_cuda(self._built, code, "int8_linear kernel launch")
            int8_linear.count()
        return out


class _LaunchCounted:
    """A kernel wrapper with its launch count: ``f.launches`` is the sum over
    threads since the last reset (``f.launches = 0``). Each thread counts in
    an entry of its own, so concurrent launches share no counter; reset
    while no thread launches."""

    def __init__(self, fn):
        functools.update_wrapper(self, fn)
        self._per_thread: Dict[int, int] = {}

    def __call__(self, *args, **kwargs):
        return self.__wrapped__(*args, **kwargs)

    def count(self) -> None:
        ident = threading.get_ident()
        self._per_thread[ident] = self._per_thread.get(ident, 0) + 1

    @property
    def launches(self) -> int:
        return sum(list(self._per_thread.values()))

    @launches.setter
    def launches(self, value: int) -> None:
        if value != 0:
            raise ValueError(f"a launch count is reset to 0, not set to {value}")
        self._per_thread.clear()


@_LaunchCounted
def int8_linear(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                bias: Optional[torch.Tensor] = None, variant: str = "auto") -> torch.Tensor:
    """``y [..., N] = (x [..., K] · q [N, K]ᵀ) ⊙ scale [N] (+ bias [N])``, the
    sum in fp32, ``y`` in ``x``'s type (fp32 or bf16). CPU tensors take
    :func:`int8_linear_torch`; CUDA tensors launch K4 on the current stream,
    or raise; every check runs on every call. ``x``'s rows may be strided.
    ``variant`` forces one of K4's kernels (:data:`VARIANTS`; ``"gemv"`` and
    ``"skinny"`` take M ≤ 16 with ``K % 16 == 0`` and a 16-byte aligned
    ``q``), for tests and timings; ``"auto"`` picks by shape."""
    dev = x.device
    if dev.type == "cpu":
        return int8_linear_torch(x, q, scale, bias)
    if q.dim() != 2 or x.shape[-1] != q.shape[1]:
        raise ValueError(f"int8_linear: x {tuple(x.shape)} against weight {tuple(q.shape)}")
    N = q.shape[0]
    if x.dtype not in _DTYPES:
        raise TypeError(f"int8_linear: the kernel takes fp32 or bf16 activations, got {x.dtype}")
    if q.dtype != torch.int8 or not q.is_contiguous():
        raise TypeError(f"int8_linear: want a contiguous int8 weight, got {q.dtype}")
    if scale.dtype != torch.float32 or scale.shape != (N,) or not scale.is_contiguous():
        raise TypeError(f"int8_linear: want a contiguous fp32 scale [{N}], got "
                        f"{scale.dtype} {tuple(scale.shape)}")
    if bias is not None and bias.shape != (N,):
        raise ValueError(f"int8_linear: bias {tuple(bias.shape)}, N={N}")
    if q.device != dev or scale.device != dev or (bias is not None and bias.device != dev):
        raise ValueError(f"int8_linear: x on {dev}, weight on {q.device}, scale on {scale.device}")
    if variant not in VARIANTS:
        raise ValueError(f"int8_linear: variant {variant!r}, not one of {sorted(VARIANTS)}")
    if dev.type != "cuda":
        raise ValueError(f"int8_linear: unsupported device {dev}")
    if bias is not None:
        bias = bias.to(x.dtype).contiguous()
    k4 = _Launcher(q, scale, bias, (x.dtype,), VARIANTS[variant])
    return k4(x, k4.addrs[x.dtype])


class _Int8Weight(nn.Module):
    """An int8 weight ``weight_int8 [out, ...]`` with its fp32 ``scale
    [out]`` (buffers) and an optional float ``bias``. Moving the module to
    another dtype casts the bias; the scales stay fp32. The three are checked
    when the module is built and after every move (:meth:`_prepare`);
    assigning one of them drops what was prepared until the next check."""

    _WEIGHTS = ("weight_int8", "scale", "bias")
    _k4: Optional[_Launcher] = None

    def _apply(self, fn, recurse=True):
        scale = self.scale
        super()._apply(fn, recurse)
        # fn casts floating tensors only: the int32 view keeps the bits
        self.scale = fn(scale.view(torch.int32)).view(torch.float32)
        self._prepare()
        return self

    def __setattr__(self, name, value):
        super().__setattr__(name, value)
        if name in self._WEIGHTS:
            self.__dict__["_k4"] = None

    def __getstate__(self):
        state = super().__getstate__()
        state["_k4"] = None  # raw pointers stay with the tensors they point into
        return state

    def _init_from(self, module: nn.Module) -> None:
        q, scale = quantize_int8(module.weight)
        self.register_buffer("weight_int8", q)
        self.register_buffer("scale", scale)
        self.bias = module.bias  # the same float parameter, or None
        if self.bias is not None:
            self.bias.requires_grad_(False)  # inference only, as the int8 weight
        self._prepare()

    def _prepare(self) -> Optional[_Launcher]:
        """Refuse a weight, scale or bias that the int8 path cannot take."""
        q, scale, bias = self.weight_int8, self.scale, self.bias
        name = type(self).__name__
        if q.dtype != torch.int8 or q.dim() < 2 or not q.is_contiguous():
            raise TypeError(f"{name}: want a contiguous int8 weight [out, ...], got {q.dtype} "
                            f"{tuple(q.shape)}")
        N = q.shape[0]
        if scale.dtype != torch.float32 or scale.shape != (N,) or not scale.is_contiguous():
            raise TypeError(f"{name}: want a contiguous fp32 scale [{N}], got {scale.dtype} "
                            f"{tuple(scale.shape)}")
        if bias is not None and (not bias.is_floating_point() or bias.shape != (N,)):
            raise ValueError(f"{name}: want a float bias [{N}], got {bias.dtype} "
                             f"{tuple(bias.shape)}")
        if scale.device != q.device or (bias is not None and bias.device != q.device):
            raise ValueError(f"{name}: weight on {q.device}, scale on {scale.device}, bias on "
                             f"{None if bias is None else bias.device}")
        return None


class Int8Linear(_Int8Weight):
    """``nn.Linear`` with int8 weights ``[out_features, in_features]``
    through K4. On a card, the checked buffers' launch is prepared once (a
    descriptor a working type), so a call checks only ``x``."""

    def __init__(self, linear: nn.Linear):
        super().__init__()
        self.in_features, self.out_features = linear.in_features, linear.out_features
        self._init_from(linear)

    def _prepare(self) -> Optional[_Launcher]:
        super()._prepare()
        q, bias = self.weight_int8, self.bias
        if q.shape != (self.out_features, self.in_features):
            raise ValueError(f"Int8Linear: weight {tuple(q.shape)}, want "
                             f"{(self.out_features, self.in_features)}")
        k4 = None
        if q.is_cuda:
            if bias is None:
                dtypes = tuple(_DTYPES)
            else:  # x in the bias's type; another takes the checked path, which casts it
                dtypes = (bias.dtype,) if bias.dtype in _DTYPES and bias.is_contiguous() else ()
            k4 = _Launcher(q, self.scale, bias, dtypes)
        self.__dict__["_k4"] = k4
        return k4

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k4 = self._k4
        if k4 is None and x.is_cuda:
            k4 = self._prepare()
        if k4 is not None and x.get_device() == k4.index and x.shape[-1] == k4.K:
            addr = k4.addrs.get(x.dtype)
            if addr is not None:
                return k4(x, addr)
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
