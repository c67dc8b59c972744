"""Device ops of the port: hand-written CUDA kernels with their plain
PyTorch versions."""

from .decode_attention import decode_attention, decode_attention_torch  # noqa: F401
from .mas import maximum_path, maximum_path_torch  # noqa: F401
