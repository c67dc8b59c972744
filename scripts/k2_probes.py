#!/usr/bin/env python3
"""What bounds K2, the MAS kernels (``tts_tpu_torch/csrc/mas.cu``), on one
card. Run from the repository root on a machine with a CUDA card::

    python3 scripts/k2_probes.py

At the VITS recipe's batch (B=32 x 381 tokens x 861 frames, fp32, the
lengths of ``chip_smoke.py``'s synthetic batch, scores from seed 1) it
prints, with the card's name and power limit:

1. the columns kernel (the first design): device microseconds by CUDA graph
   replays, and block 0's four parts by ``clock64`` (the forward pass, the
   zeroing, the start count, the walk back; ``chip_smoke.k2_parts``); then
   the same kernel built with its forward pass reading one column at every
   frame (no strided loads; its paths are wrong, only its time counts): the
   share of a frame's cycles that the column loads take;
2. the ring kernel: the wrapper's plan and its parts; the bits in scratch;
   1, 2 and 4 scoring warps (at 381 tokens 12, 6 and 3 tokens a lane) with
   tiles of 8, 16 and 32 frames; and the same at the aligners' 190 tokens
   (the corpus without the blanks);
3. the ring kernel built three more ways: without its copies (the scoring
   warps compute on whatever the ring holds: their own pace), at 1-4
   scoring warps; with its scoring cut to an add a cell (the copies' pace),
   over rings of 2-8 tiles of 8, 16 and 32 frames; and with its copies' L2
   fetch hint at 128 bytes or none, under the wrapper's plan;
4. the wrapper's plan with 2, 3, 5 and 7 copying warps.

Nothing here is on a trained path; the numbers guide the kernel's design.
"""

from __future__ import annotations

import ctypes
import dataclasses
import os
import subprocess
import sys

sys.path.insert(0, os.getcwd())

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from tts_tpu_torch.ops import cuda_build, mas  # noqa: E402

SRC = cuda_build.CSRC_DIR / "mas.cu"
OUT = cuda_build.BUILD_DIR / "probes"


def without_column_loads(src: str) -> str:
    """The columns kernel reading frame 0's column at every frame."""
    for old, new in (("to_f32(mb[x * msx + j * msy]);", "to_f32(mb[x * msx]);"),
                     ("to_f32(vb[x * vsx + j * vsy])", "to_f32(vb[x * vsx])")):
        if src.count(old) != 1:
            raise RuntimeError(f"the source changed; cannot cut the load {old!r}")
        src = src.replace(old, new)
    return src


def edit(src: str, old: str, new: str) -> str:
    if old not in src:
        raise RuntimeError(f"the source changed; cannot edit {old[:60]!r}")
    return src.replace(old, new)


def variants(src: str) -> dict:
    copies = ("cp_async4(dst + 128 * k, qv);\n"
              "            cp_async4(dst + 128 * k + moff, qm);\n")
    hint = "cp.async.ca.shared.global.L2::256B"
    cells = ("float r = cell(st.v[k], k ? st.v[k - 1] : up, __fmul_rn(cv[k], cm[k]), cm[k], bit,\n"
             "                   st.acc[k]);")
    return {"no_column_loads": without_column_loads(src),
            "no_copies": edit(src, copies, ""),
            "copy_only": edit(src, cells, "float r = cv[k] + cm[k] + up;"),
            "hint_128": edit(src, hint, "cp.async.ca.shared.global.L2::128B"),
            "no_hint": edit(src, hint, "cp.async.ca.shared.global")}


def build(texts: dict) -> dict:
    """Each variant built by its own nvcc, all at once, and bound."""
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in texts.items():
        (OUT / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [cuda_build.find_nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(OUT / f"lib{name}.so"),
             str(OUT / f"{name}.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    bound = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on the {name} variant:\n{log}")
        lib = ctypes.CDLL(str(OUT / f"lib{name}.so"))
        lib.tts_cuda_error_string.argtypes = [ctypes.c_int]
        lib.tts_cuda_error_string.restype = ctypes.c_char_p
        bound[name] = mas.bind(cuda_build.CudaLibrary(lib=lib, path=OUT / f"lib{name}.so",
                                                      build_log=log))
    return bound


class using:
    """Launch K2 from a variant's build inside the block."""

    def __init__(self, variant):
        self.variant = variant

    def __enter__(self):
        self.own, mas._kernel = mas._kernel, lambda: self.variant

    def __exit__(self, *exc):
        mas._kernel = self.own


def inputs(T_x: int, device):
    """Scores and the batch's mask at ``T_x`` tokens (381: with blanks; 190:
    the same texts without them)."""
    x_len, y_len = chip_smoke.train_lengths(np.random.RandomState(0))
    if T_x < chip_smoke.TRAIN_TEXT[1]:
        x_len = (x_len - 1) // 2
    T_y = chip_smoke.TRAIN_FRAMES[1]
    gen = torch.Generator(device=device).manual_seed(1)
    value = -torch.rand(len(x_len), T_x, T_y, generator=gen, device=device) * 100
    mask = chip_smoke.length_mask(torch.from_numpy(x_len).to(device),
                                  torch.from_numpy(y_len).to(device), T_x, T_y)
    return value, mask


def us(fn) -> float:
    return chip_smoke.time_device([fn], rounds=5, replays=4) * 1e3


def main() -> int:
    if not torch.cuda.is_available():
        print("k2_probes: needs a CUDA card", file=sys.stderr)
        return 2
    card = chip_smoke.card_line()
    dev = torch.device("cuda")
    limit = mas.shared_limit(0)
    built = build(variants(SRC.read_text()))
    print(card, flush=True)

    value, mask = inputs(381, dev)
    want = mas.maximum_path_torch(value, mask)
    if not torch.equal(mas.launch_columns(value, mask), want):
        raise AssertionError("the columns kernel's path differs from the plain version's")
    print(f"columns kernel, 381 x 861: {us(lambda: mas.launch_columns(value, mask)):.1f} us "
          f"(bits in scratch {us(lambda: mas.launch_columns(value, mask, False)):.1f}); "
          f"block 0: {chip_smoke.format_parts(chip_smoke.k2_parts(value, mask))} | {card}",
          flush=True)
    with using(built["no_column_loads"]):
        print(f"columns kernel without its column loads: "
              f"{us(lambda: mas.launch_columns(value, mask)):.1f} us; block 0: "
              f"{chip_smoke.format_parts(chip_smoke.k2_parts(value, mask))} | {card}", flush=True)

    for T_x in (381, 190):
        value, mask = inputs(T_x, dev)
        want = mas.maximum_path_torch(value, mask)
        T_y = value.shape[2]
        plans = {"default": mas.ring_plan(T_x, T_y, limit),
                 "bits in scratch": mas.ring_plan(T_x, T_y, limit, shared_bits=False)}
        for warps in (1, 2, 4):
            for frames in (8, 16, 32):
                plans[f"{warps} scoring warp(s), {frames}-frame tiles"] = mas.ring_plan(
                    T_x, T_y, limit, scoring_warps=warps, frames=frames)
        for name, plan in plans.items():
            if plan is None:
                print(f"ring kernel {T_x} x {T_y}, {name}: no plan fits | {card}", flush=True)
                continue
            got = mas.launch_ring(value, mask, plan)
            if not torch.equal(got, want):
                raise AssertionError(f"ring kernel ({name}): the path differs from the plain "
                                     f"version's")
            t = us(lambda plan=plan: mas.launch_ring(value, mask, plan))
            parts = chip_smoke.k2_parts(value, mask, plan)
            print(f"ring kernel {T_x} x {T_y}, {name}: {t:.1f} us (k {plan.k}, "
                  f"{plan.copying_warps} copying warps, {plan.stages} tiles of {plan.frames}, "
                  f"bits {'shared' if plan.bits_shared else 'scratch'}"
                  f"{', copied' if plan.bits_copied else ''}, {plan.smem_bytes} B); block 0: "
                  f"{chip_smoke.format_parts(parts)} | {card}", flush=True)
        for P in (2, 3, 5, 7):
            plan = dataclasses.replace(mas.ring_plan(T_x, T_y, limit), copying_warps=P)
            t = us(lambda plan=plan: mas.launch_ring(value, mask, plan))
            parts = chip_smoke.k2_parts(value, mask, plan)
            print(f"ring kernel {T_x} x {T_y}, the plan with {P} copying warps: {t:.1f} us; block "
                  f"0: {chip_smoke.format_parts(parts)} | {card}", flush=True)
        runs = ([("no_copies", {"scoring_warps": w}) for w in (1, 2, 3, 4)]
                + [("copy_only", {"frames": f, "stages": s, "shared_bits": False}) for f, s in
                   ((8, 2), (8, 4), (8, 8), (16, 2), (16, 4), (32, 2), (32, 3))]
                + [("hint_128", {}), ("no_hint", {})])
        for name, kw in runs:
            plan = mas.ring_plan(T_x, T_y, limit, **kw)
            if plan is None:
                continue
            with using(built[name]):
                t = us(lambda plan=plan: mas.launch_ring(value, mask, plan))
                parts = chip_smoke.k2_parts(value, mask, plan)
            print(f"ring kernel {T_x} x {T_y}, {name.replace('_', ' ')}, "
                  f"{plan.scoring_warps} scoring warp(s), {plan.stages} tiles of {plan.frames} "
                  f"({plan.smem_bytes} B): "
                  f"{t:.1f} us; block 0: {chip_smoke.format_parts(parts)} | {card}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
