"""Build and load the hand-written CUDA kernels under ``tts_tpu_torch/csrc``.

Each ``csrc/<name>.cu`` exports a plain C interface. At first use it is
compiled by ``nvcc`` for Hopper (``sm_90a``) into a shared library under
``tts_tpu_torch/_build/`` (git-ignored), keyed by a hash of the source and
the flags, and loaded with ``ctypes``. No PyTorch headers are involved, so a
build takes seconds. A missing ``nvcc`` or a failed build raises; nothing
falls back to another implementation.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from dataclasses import dataclass
from pathlib import Path
from typing import Dict

_PKG = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers / shared memory / spills into the build log
)


@dataclass(frozen=True)
class CudaLibrary:
    lib: ctypes.CDLL
    path: Path
    build_log: str  # nvcc's output, including ptxas' resource usage


_loaded: Dict[str, CudaLibrary] = {}
_lock = threading.Lock()  # guards _locks
_locks: Dict[str, threading.Lock] = {}  # one a library: two sources build at once


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH, else the default
    toolkit location; raises if none exists."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for path in candidates:
        if os.path.isfile(path) and os.access(path, os.X_OK):
            return path
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH); the CUDA kernels "
        "of tts_tpu_torch are built from source at first use"
    )


def load_library(name: str) -> CudaLibrary:
    """Compile ``csrc/<name>.cu`` if its build is missing, load it, cache it
    for the process. Other libraries may build meanwhile, from other
    threads."""
    with _lock:
        lock = _locks.setdefault(name, threading.Lock())
    with lock:
        if name in _loaded:
            return _loaded[name]
        src = CSRC_DIR / f"{name}.cu"
        digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
        so_path = BUILD_DIR / f"lib{name}-{digest}.so"
        log_path = so_path.with_suffix(".log")
        if not so_path.is_file():
            nvcc = find_nvcc()
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so_path.with_name(f"{so_path.name}.{os.getpid()}.tmp")
            proc = subprocess.run(
                [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
                capture_output=True, text=True,
            )
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed to build {src} (exit {proc.returncode}):\n"
                    f"{proc.stdout}{proc.stderr}"
                )
            log_path.write_text(proc.stdout + proc.stderr)
            os.replace(tmp, so_path)
        built = CudaLibrary(
            lib=ctypes.CDLL(str(so_path)),
            path=so_path,
            build_log=log_path.read_text() if log_path.is_file() else "",
        )
        err = built.lib.tts_cuda_error_string
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        _loaded[name] = built
        return built


def check_cuda(lib: CudaLibrary, code: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if code != 0:
        msg = lib.lib.tts_cuda_error_string(code).decode()
        raise RuntimeError(f"{what} failed: CUDA error {code} ({msg})")
