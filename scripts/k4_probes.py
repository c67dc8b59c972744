#!/usr/bin/env python3
"""What bounds K4's tensor-core kernels (``tts_tpu_torch/csrc/int8_linear.cu``)
on one card. Run from the repository root on a machine with a CUDA card::

    python3 scripts/k4_probes.py

It builds three variants of the source with ``nvcc`` (at once, into
``tts_tpu_torch/_build/probes/``), binds each with ``ctypes`` in place of the
wrapper's own build, and prints, with the card's name and power limit:

1. the ``mma.sync.m16n8k16`` bf16 rate of a kernel that does nothing else
   (cycles per instruction per warp, and TFLOP/s by the wall clock), at 1, 4,
   8 and 16 warps a multiprocessor;
2. ``k4_tile`` with ``clock64`` probes (block (0, 0), thread 0): cycles a
   64-k stage spent in the ``cp.async`` wait, the barrier, the ``cp.async``
   issue and the rest (fragments, conversion, ``mma``), and the SM clock
   against ``%globaltimer``;
3. ``k4_skinny`` whole and with its cluster reduction cut out (no pushes,
   no cluster barrier; its results are then wrong, only its time counts),
   by CUDA graph replays over 32 weight copies.

Nothing here is on a served path; the numbers guide the kernels' design.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import time

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from tts_tpu_torch.ops import cuda_build, quant  # noqa: E402

SRC = cuda_build.CSRC_DIR / "int8_linear.cu"
OUT = cuda_build.BUILD_DIR / "probes"

MMA_RATE = r"""
#include <cuda_runtime.h>
#include <stdint.h>
__global__ void mma_rate(float* out, long long* cycles, int iters) {
  float acc[8][4] = {};
  uint32_t a0 = threadIdx.x, a1 = a0 * 3, a2 = a0 * 5, a3 = a0 * 7, b0 = a0 * 11, b1 = a0 * 13;
  long long t0 = clock64();
  for (int it = 0; it < iters; ++it)
#pragma unroll
    for (int i = 0; i < 8; ++i)
      asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
                   "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
                   : "+f"(acc[i][0]), "+f"(acc[i][1]), "+f"(acc[i][2]), "+f"(acc[i][3])
                   : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
  long long t1 = clock64();
  float s = 0.f;
  for (int i = 0; i < 8; ++i) for (int j = 0; j < 4; ++j) s += acc[i][j];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
  if (threadIdx.x == 0) cycles[blockIdx.x] = t1 - t0;
}
extern "C" int run(float* out, long long* cycles, int blocks, int threads, int iters) {
  mma_rate<<<blocks, threads>>>(out, cycles, iters);
  return (int)cudaDeviceSynchronize();
}
"""


def edit(text: str, old: str, new: str) -> str:
    if text.count(old) != 1:
        raise RuntimeError(f"the source changed; cannot place a probe at {old[:60]!r}")
    return text.replace(old, new)


def tile_probes(src: str) -> str:
    """k4_tile with clock64 around its stage's phases, into g_probe."""
    s = edit(src, "namespace cg = cooperative_groups;",
             "namespace cg = cooperative_groups;\n__device__ long long g_probe[8];")
    s = edit(s, "  const int nkt_all = (K + kTileK - 1) / kTileK;",
             "  const bool probe = blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0 && tid == 0;\n"
             "  long long c0 = clock64(), tw = 0, ts = 0, ti = 0;\n"
             "  unsigned long long g0;\n"
             "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(g0));\n"
             "  const int nkt_all = (K + kTileK - 1) / kTileK;")
    s = edit(s, "    cp_async_wait<kTileStages - 2>();  // this thread's copies of tile kt have landed\n"
                "    __syncthreads();  // everyone's; and every warp is done with the stage refilled below\n"
                "    if (kt + kTileStages - 1 < nkt)\n"
                "      issue(kt0 + kt + kTileStages - 1, (kt + kTileStages - 1) % kTileStages);\n"
                "    cp_async_commit();",
             "    long long a0 = clock64();\n"
             "    cp_async_wait<kTileStages - 2>();\n"
             "    long long a1 = clock64();\n"
             "    __syncthreads();\n"
             "    long long a2 = clock64();\n"
             "    if (kt + kTileStages - 1 < nkt)\n"
             "      issue(kt0 + kt + kTileStages - 1, (kt + kTileStages - 1) % kTileStages);\n"
             "    cp_async_commit();\n"
             "    tw += a1 - a0; ts += a2 - a1; ti += clock64() - a2;")
    s = edit(s, "  cp_async_wait<0>();  // no copy outlives the block\n",
             "  cp_async_wait<0>();\n"
             "  if (probe) {\n"
             "    unsigned long long g1;\n"
             "    asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(g1));\n"
             "    const long long c = clock64() - c0;\n"
             "    g_probe[0] = c; g_probe[1] = tw; g_probe[2] = ts; g_probe[3] = ti;\n"
             "    g_probe[4] = nkt; g_probe[5] = (long long)(g1 - g0);\n"
             "  }\n")
    return edit(s, "int tts_int8_linear_desc_bytes()",
                "void tts_probe(long long* out) { cudaMemcpyFromSymbol(out, g_probe, sizeof(g_probe)); }\n"
                "int tts_int8_linear_desc_bytes()")


def skinny_without_reduction(src: str) -> str:
    """k4_skinny without its pushes and cluster barrier (wrong results)."""
    start = src.index("  cluster_wait();  // every block of the cluster has started")
    end = src.index("  cluster_arrive();\n  cluster_wait();\n") + len("  cluster_arrive();\n  cluster_wait();\n")
    keep = ("  if (acc[0][0] == 12345.0f) recv[threadIdx.x] = acc[NT - 1][3];  // keeps the sums live\n")
    return src[:start] + keep + src[end:]


def build(variants: dict) -> dict:
    OUT.mkdir(parents=True, exist_ok=True)
    nvcc = cuda_build.find_nvcc()
    procs = {}
    for name, text in variants.items():
        (OUT / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [nvcc, *cuda_build.NVCC_FLAGS, "-o", str(OUT / f"lib{name}.so"), str(OUT / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on the {name} variant:\n{log}")
        libs[name] = ctypes.CDLL(str(OUT / f"lib{name}.so"))
    return libs


def use(lib) -> None:
    """Make the wrapper launch `lib`'s K4 in place of its own build."""
    fn = lib.tts_int8_linear
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.tts_cuda_error_string.argtypes = [ctypes.c_int]
    lib.tts_cuda_error_string.restype = ctypes.c_char_p
    built = cuda_build.CudaLibrary(lib=lib, path=None, build_log="")
    quant._kernel = lambda: (built, fn)


def main() -> int:
    if not torch.cuda.is_available():
        print("k4_probes: needs a CUDA card", file=sys.stderr)
        return 2
    card = chip_smoke.card_line()
    src = SRC.read_text()
    libs = build({"mma_rate": MMA_RATE, "tile_probes": tile_probes(src),
                  "skinny": src, "skinny_cut": skinny_without_reduction(src)})
    print(card, flush=True)

    run = libs["mma_rate"].run
    out = torch.empty(132 * 1024, device="cuda")
    cycles = torch.zeros(132, dtype=torch.int64, device="cuda")
    iters = 4096
    for warps in (1, 4, 8, 16):
        args = (ctypes.c_void_p(out.data_ptr()), ctypes.c_void_p(cycles.data_ptr()), 132,
                32 * warps, iters)
        run(*args)
        t0 = time.perf_counter()
        run(*args)
        wall = time.perf_counter() - t0
        flop = 132 * warps * iters * 8 * 4096
        print(f"mma.sync m16n8k16 bf16, {warps} warp(s) a multiprocessor: "
              f"{cycles.float().mean().item() / (iters * 8):.2f} cycles an instruction a warp, "
              f"{flop / wall / 1e12:.1f} TFLOP/s by the wall clock | {card}", flush=True)

    gen = torch.Generator(device="cuda").manual_seed(0)
    lib = libs["tile_probes"]
    use(lib)
    for M, K, N, dtype in ((32, 1024, 512, torch.bfloat16), (80, 1024, 3072, torch.bfloat16),
                           (513, 1024, 3072, torch.bfloat16), (513, 1024, 3072, torch.float32),
                           (1024, 1024, 1056, torch.bfloat16)):
        x = torch.randn(M, K, device="cuda", generator=gen).to(dtype)
        q, s = quant.quantize_int8(torch.randn(N, K, device="cuda", generator=gen))
        us = chip_smoke.time_device([lambda: quant.int8_linear(x, q, s, variant="tile")]) * 1e3
        quant.int8_linear(x, q, s, variant="tile")
        torch.cuda.synchronize()
        p = (ctypes.c_longlong * 8)()
        lib.tts_probe(p)
        total, wait, sync, issue, stages, ns = p[0], p[1], p[2], p[3], p[4], p[5]
        rest = total - wait - sync - issue
        print(f"k4_tile {str(dtype)[6:]} {M} x {K} x {N}: {us:.2f} us; block (0, 0) "
              f"{total} cycles in {ns} ns ({total / max(ns, 1):.2f} GHz), {stages} stages of 64 k, "
              f"a stage: wait {wait / stages:.0f}, barrier {sync / stages:.0f}, cp.async issue "
              f"{issue / stages:.0f}, the rest {rest / stages:.0f} cycles | {card}", flush=True)

    for name in ("skinny", "skinny_cut"):
        use(libs[name])
        times = []
        for M, K, N, dtype in ((4, 1024, 3072, torch.bfloat16), (16, 1024, 3072, torch.bfloat16),
                               (4, 4096, 1024, torch.bfloat16), (4, 1024, 1026, torch.bfloat16)):
            x = torch.randn(M, K, device="cuda", generator=gen).to(dtype)
            ws = [quant.quantize_int8(torch.randn(N, K, device="cuda", generator=gen))
                  for _ in range(32)]
            us = chip_smoke.time_device([lambda q=q, s=s: quant.int8_linear(x, q, s, variant="skinny")
                                         for q, s in ws]) * 1e3
            times.append(f"{str(dtype)[6:]} {M} x {K} x {N} {us:.2f}")
        label = "whole" if name == "skinny" else "without its cluster reduction"
        print(f"k4_skinny {label}: " + ", ".join(times) + f" us | {card}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
