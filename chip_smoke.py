#!/usr/bin/env python3
"""Drive the PyTorch port (``tts_tpu_torch``) once on one CUDA card.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

Phases; each raises on failure and the script then exits non-zero:

1. environment: torch / CUDA / nvcc versions, the card's name and power
   limit; TF32 is switched off for the comparison phases;
2. build: the hand-written kernels of the serving path are compiled from
   ``tts_tpu_torch/csrc`` (ptxas register / shared-memory use printed);
3. kernels: each kernel against its plain PyTorch version on the card at the
   decode shapes (B 1 and 4, S 685, 720 and 1024, H 16, dh 64, fp32 and
   bf16 caches, per-row, scalar and the real decode's lengths), each call
   made twice and the two results required bit-identical; then timed
   beside its bound, its plain version and one PyTorch library call
   (``scaled_dot_product_attention``) computing the same function;
4. slice: XTTS v2 at full width (``XttsConfig()``; fp32 weights drawn from a
   seed) conditions on a reference wav and decodes 40 greedy tokens twice,
   through the kernel and through the plain attention; tokens must match
   and latents agree within 1e-4. Then the decode step is timed in bf16;
5. serving: the same weights (GPT in bf16) go into a model directory, the
   port's HTTP server starts from its command line (``--stream_batch 4``) on
   a free local port, and 4 concurrent ``/api/tts-stream`` requests and one
   ``/api/tts`` request clone the reference voice. The decode-attention
   launch count of this phase proves the decode went through the kernel.
   Then one stream on the idle server, and its time to first audio split
   into conditioning, prefill, one chunk's decode and its vocoding. Last,
   one call of the ``tts`` command line (``tts_tpu_torch.bin.synthesize``)
   on the same model directory clones the voice into a file; the kernel's
   launches in that call must be 30 x its decode steps;
6. VITS: the LJSpeech VITS recipe as published, phonemes from the rule G2P
   (``english_cleaners``, ``use_phonemes=True``, ``phoneme_language="en-us"``,
   blanks; the ``VitsArgs`` defaults, the embedding sized by the phoneme
   set; fp32 weights drawn from seed 0, TF32 off) synthesizes three
   sentences on the card and, on the same weights and the same noise
   (drawn once on the host, by shape), on the CPU: ``y_lengths`` must be
   equal and the waveforms agree within 1e-4. Then three concurrent
   ``/api/tts`` requests through the server, ``/details``, ``/locales``,
   ``/voices`` and a ``POST /process``, one file through
   ``TTS.tts_to_file`` and one through the ``tts`` command line (the same
   samples within one int16 step), and the timings: real-time factor at B=1
   for a short, a medium and a long sentence, the time of each stage of the
   medium one, the device busy share and top kernels under
   ``torch.profiler``, and the peak device memory. VITS runs no
   hand-written kernel (the JAX package reaches no Pallas kernel there).

It prints the card's name and power limit, then ``{"kernels": [...]}`` on
the line before the last and, as the last line, ``{"ok": true, "device":
{...}}``. The port must have imported nothing of ``tts_tpu``, JAX, flax or
``tokenizers`` by then. Without CUDA, or outside a
checkout, it exits 2 and prints no result.
"""

from __future__ import annotations

import contextlib
import gc
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.parse
import urllib.request

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
H, DH = 16, 64  # XTTS v2 attention heads and head width
STREAM_CHUNK = 20  # tokens per streamed chunk (XTTS default)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    """``name, power.limit`` of the first card, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    return out.splitlines()[0]


def time_host(fn, iters: int = 200, warmup: int = 20) -> float:
    """Milliseconds per call for back-to-back calls (CUDA events around the
    run): includes the host's launch cost, which bounds small ops."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_device(fns, rounds: int = 10, replays: int = 10) -> float:
    """Device milliseconds per call: ``rounds`` passes over ``fns`` are
    captured into one CUDA graph, replayed ``replays`` times between CUDA
    events, so the host's launch cost is out of the measurement."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for fn in fns:
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(rounds):
            for fn in fns:
                fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * rounds * len(fns))


@contextlib.contextmanager
def plain_decode_attention():
    """The GPT's decode step calls the plain PyTorch attention instead of the
    kernel, for one comparison only."""
    from tts_tpu_torch.models.xtts import gpt_core
    from tts_tpu_torch.ops.decode_attention import decode_attention, decode_attention_torch

    gpt_core.decode_attention = decode_attention_torch
    try:
        yield
    finally:
        gpt_core.decode_attention = decode_attention


@contextlib.contextmanager
def forced_splits(keys: int, splits: int):
    """The kernel's wrapper cuts ``keys`` keys into ``splits`` splits in
    place of its plan's count, for one measurement only."""
    import importlib

    dec = importlib.import_module("tts_tpu_torch.ops.decode_attention")
    plan = dec.split_plan
    dec.split_plan = lambda *args: dec.cut_keys(keys, splits)
    try:
        yield
    finally:
        dec.split_plan = plan


def sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def reference_wav(seconds: float = 6.0, sr: int = 22050, seed: int = 0) -> np.ndarray:
    """A voiced-sounding test clip: a gliding harmonic tone plus noise."""
    t = np.arange(int(seconds * sr), dtype=np.float64) / sr
    f0 = 140 + 30 * np.sin(2 * np.pi * 0.5 * t)
    phase = 2 * np.pi * np.cumsum(f0) / sr
    wav = sum(0.2 / k * np.sin(k * phase) for k in range(1, 6))
    wav = wav + 0.02 * np.random.RandomState(seed).randn(len(t))
    return wav.astype(np.float32)


# ---------------------------------------------------------------------------
def phase_environment() -> str:
    import torch

    from tts_tpu_torch.ops.cuda_build import find_nvcc

    nvcc_ver = subprocess.run(
        [find_nvcc(), "--version"], capture_output=True, text=True, check=True
    ).stdout.strip().splitlines()[-1]
    log(f"python {sys.version.split()[0]} | torch {torch.__version__} cuda {torch.version.cuda} "
        f"| nvcc: {nvcc_ver}")
    card = card_line()
    log(card)  # name and power limit, exactly as nvidia-smi prints them
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("TF32 off for matmuls and cuDNN convolutions: comparisons run in full fp32")
    return card


def phase_build() -> None:
    from tts_tpu_torch.ops.cuda_build import load_library

    t0 = time.time()
    built = load_library("decode_attention")
    log(f"built {os.path.relpath(built.path, REPO)} in {time.time() - t0:.1f} s")
    for line in built.build_log.splitlines():
        if "entry function" in line:
            kind = "bf16" if "bfloat16" in line else "fp32" if "IfE" in line else "?"
            log(f"  ptxas: {line.strip().split(' for ')[0]} ({kind} instance)")
        elif "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")


HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet, at 700 W
FP32_FLOPS_PER_S = 67e12  # H100 SXM fp32 outside the tensor cores


def attention_bound_ms(B: int, n: int, dtype) -> tuple:
    """Least time for one decode-attention call: each input read once (q and
    the valid K/V rows), the fp32 output written once, over the memory rate;
    ~4 flops per K/V element (q.k and p.v) over the fp32 rate. Returns
    ``(ms, "bytes" or "operations", bytes)``."""
    import torch

    elt = torch.finfo(dtype).bits // 8
    nbytes = 2 * B * n * H * DH * elt + B * H * DH * elt + B * H * DH * 4
    flops = 4 * B * n * H * DH
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations", nbytes)


def phase_kernels(card: str) -> dict:
    """K1 against its plain version at the decode shapes (and repeated calls
    bit-identical), then timed beside its bound, the plain version and one
    library call computing the same function."""
    import torch
    import torch.nn.functional as F

    from tts_tpu_torch.ops.decode_attention import (
        decode_attention,
        decode_attention_torch,
        split_plan,
    )

    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(0)
    tol = {torch.float32: 1e-5, torch.bfloat16: 1e-3}
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    n_checks = 0

    def check(B, S, dtype, lengths):
        nonlocal n_checks
        q = torch.randn(B, H, DH, generator=gen, device=dev).to(dtype)
        k = torch.randn(B, S, H, DH, generator=gen, device=dev).to(dtype)
        v = torch.randn(B, S, H, DH, generator=gen, device=dev).to(dtype)
        for cache_len in lengths:
            got = decode_attention(q, k, v, cache_len)
            again = decode_attention(q, k, v, cache_len)
            # bf16: the plain version runs in fp32 on the same bf16 values
            want = decode_attention_torch(q.float(), k.float(), v.float(), cache_len)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            worst[dtype] = max(worst[dtype], err)
            n_checks += 1
            if not err <= tol[dtype]:
                raise AssertionError(
                    f"decode_attention B={B} S={S} {dtype} cache_len={cache_len}: "
                    f"max abs err {err} > {tol[dtype]}"
                )
            if not torch.equal(got, again):
                raise AssertionError(
                    f"decode_attention B={B} S={S} {dtype} cache_len={cache_len}: two calls on "
                    f"the same inputs differ by {(got - again).abs().max().item()}"
                )

    for B in (1, 4):
        for S in (685, 1024):
            for dtype in (torch.float32, torch.bfloat16):
                lengths = [
                    torch.tensor([(1, 37, S)[(b + r) % 3] for b in range(B)],
                                 dtype=torch.int32, device=dev)
                    for r in range(3)
                ] + [S - 3, torch.tensor(37, device=dev)]
                check(B, S, dtype, lengths)
    # the cache lengths of a real decode (20-token chunks after a ~33-token
    # prefix), at the streaming capacity S=720 and at S=1024 with B=4
    for B, S in ((1, 720), (4, 720), (4, 1024)):
        for dtype in (torch.float32, torch.bfloat16):
            check(B, S, dtype, [33, 95, 300])
    log(f"decode_attention: {n_checks} cases agree with the plain version, each called twice "
        f"with bit-identical results; max abs err fp32 {worst[torch.float32]:.3g} (tol 1e-5), "
        f"bf16 {worst[torch.bfloat16]:.3g} (tol 1e-3)")

    # timing: 32 caches, one per layer as in the model (more bytes than the
    # 50 MB L2 holds at B=1), so each call reads its cache from device memory
    times = {}
    shapes = [(B, dtype, 685, 685) for B in (1, 4) for dtype in (torch.bfloat16, torch.float32)]
    shapes += [(1, torch.bfloat16, 720, 95), (1, torch.bfloat16, 720, 300)]
    for B, dtype, S, n in shapes:
        q = torch.randn(B, H, DH, generator=gen, device=dev).to(dtype)
        caches = [(torch.randn(B, S, H, DH, generator=gen, device=dev).to(dtype),
                   torch.randn(B, S, H, DH, generator=gen, device=dev).to(dtype))
                  for _ in range(32)]
        lens = torch.full((B,), n, dtype=torch.int32, device=dev)
        kern = [lambda k=k, v=v: decode_attention(q, k, v, n) for k, v in caches]
        plain = [lambda k=k, v=v: decode_attention_torch(q, k, v, lens) for k, v in caches]
        # the library yardstick: q as [B, H, 1, dh], the caches as [B, H, S, dh]
        # views, a [B, 1, 1, S] mask made here, outside the timed calls
        mask = (torch.arange(S, device=dev) < n)[None, None, None, :].expand(B, 1, 1, S)
        lib = [lambda k=k, v=v: F.scaled_dot_product_attention(
            q[:, :, None], k.transpose(1, 2), v.transpose(1, 2), attn_mask=mask)
            for k, v in caches]
        lib_out = lib[0]()[:, :, 0].float()
        lib_err = (lib_out - decode_attention_torch(q.float(), caches[0][0].float(),
                                                    caches[0][1].float(), n)).abs().max().item()
        t = {"kernel": time_device(kern), "plain": time_device(plain), "library": time_device(lib)}
        t["kernel2"] = time_device(kern)
        t["kernel_call"] = time_host(kern[0])
        t["plain_call"] = time_host(plain[0])
        bound, bound_by, nbytes = attention_bound_ms(B, n, dtype)
        t.update(bound=bound, bound_by=bound_by, bytes=nbytes)
        times[(B, dtype, S, n)] = t
        splits, chunk = split_plan(B, H, S, n, sms)
        log(f"decode_attention {str(dtype)[6:]} B={B} S={S} n={n} ({splits} splits of {chunk} "
            f"keys, {splits * B * H} blocks): device {t['kernel'] * 1e3:.2f} / "
            f"{t['kernel2'] * 1e3:.2f} us kernel, {t['plain'] * 1e3:.2f} us plain, "
            f"{t['library'] * 1e3:.2f} us library (SDPA, max abs diff {lib_err:.2g}); "
            f"bound {bound * 1e3:.2f} us ({nbytes / 1e6:.2f} MB, {bound_by}): "
            f"{100 * bound / t['kernel']:.1f} % of bound, {nbytes / t['kernel'] / 1e9:.3f} TB/s; "
            f"per call with launch {t['kernel_call'] * 1e3:.2f} us kernel, "
            f"{t['plain_call'] * 1e3:.2f} us plain | {card}")
    # the split plan against other split counts, at the main path's shape
    q = torch.randn(1, H, DH, generator=gen, device=dev).to(torch.bfloat16)
    caches = [(torch.randn(1, 685, H, DH, generator=gen, device=dev).to(torch.bfloat16),
               torch.randn(1, 685, H, DH, generator=gen, device=dev).to(torch.bfloat16))
              for _ in range(32)]
    fns = [lambda k=k, v=v: decode_attention(q, k, v, 685) for k, v in caches]
    planned = split_plan(1, H, 685, 685, sms)[0]
    plan_us = {}
    for splits in sorted({planned, 1, 6, 9, 16}):
        with forced_splits(685, splits):
            plan_us[splits] = time_device(fns) * 1e3
    log(f"decode_attention split plan on {sms} SMs, bf16 B=1 n=685, device us by split count "
        f"(blocks = 16 x splits): " + ", ".join(f"{s}{' (plan)' if s == planned else ''} "
                                                f"{us:.2f}" for s, us in plan_us.items())
        + f" | {card}")

    t = times[(1, torch.bfloat16, 685, 685)]
    return {
        "name": "decode_attention",
        "route": "cuda",
        "source": "tts_tpu_torch/csrc/decode_attention.cu",
        "replaces": "tts_tpu/ops/pallas_attention.py:52",
        "max_abs_err": max(worst.values()),
        "ms": t["kernel"],
        "plain_ms": t["plain"],
        "bound_ms": t["bound"],
        "bound_by": t["bound_by"],
        "library_ms": t["library"],
        "tb_per_s": t["bytes"] / t["kernel"] / 1e9,
    }


def phase_slice(card: str, device="cuda", config=None):
    """Full-width XTTS v2 (``config`` defaults to ``XttsConfig()``), greedy
    40-token decode through the kernel and through the plain attention;
    then the bf16 decode step timed."""
    import torch

    from tts_tpu_torch.models.xtts.config import XttsConfig
    from tts_tpu_torch.models.xtts.model import Xtts
    from tts_tpu_torch.ops.decode_attention import decode_attention

    t0 = time.time()
    model = Xtts(config or XttsConfig()).init_params(seed=0, device=device, dtype=torch.float32)
    n_params = sum(p.numel() for p in model.parameters())
    n_layers = len(model.gpt.gpt.h)
    log(f"XTTS v2: {n_layers} layers, width {model.args.gpt_n_model_channels}, "
        f"{model.args.gpt_n_heads} heads, {n_params / 1e6:.1f} M parameters "
        f"(random, seed 0), ready in {time.time() - t0:.1f} s")

    wav = reference_wav()
    cond = model.get_gpt_cond_latents(wav, 22050, chunk_length=4)
    spk = model.get_speaker_embedding(wav, 22050)
    if cond.shape != (1, 32, model.args.gpt_n_model_channels) or spk.shape != (1, 512):
        raise AssertionError(f"conditioning shapes {tuple(cond.shape)}, {tuple(spk.shape)}")
    if not (torch.isfinite(cond).all() and torch.isfinite(spk).all()):
        raise AssertionError("conditioning is not finite")

    n_text = min(200, model.args.gpt_number_text_tokens)
    text = torch.from_numpy(np.random.RandomState(0).randint(5, n_text, (1, 40))).to(device)
    lengths = torch.tensor([40], device=device)
    kw = dict(max_new_tokens=40, temperature=0.75, top_k=1, top_p=0.85, repetition_penalty=5.0)

    before = decode_attention.launches
    with_kernel = model.gpt.generate(cond, text, lengths, None, **kw)
    sync(device)
    if device == "cuda" and decode_attention.launches - before != n_layers * 40:
        raise AssertionError(f"{decode_attention.launches - before} kernel launches, "
                             f"want {n_layers * 40}")
    with plain_decode_attention():
        with_plain = model.gpt.generate(cond, text, lengths, None, **kw)
    sync(device)
    if device == "cuda" and decode_attention.launches - before != n_layers * 40:
        raise AssertionError("the plain run launched the kernel")
    if not torch.equal(with_kernel["codes"], with_plain["codes"]):
        raise AssertionError(f"tokens differ:\n{with_kernel['codes']}\n{with_plain['codes']}")
    lat_err = (with_kernel["latents"] - with_plain["latents"]).abs().max().item()
    if not lat_err <= 1e-4:
        raise AssertionError(f"latents differ by {lat_err} > 1e-4")
    audio = model.hifigan_decoder(with_kernel["latents"], spk)
    # 40 codes → 160 frames → int(160 · 24000/22050) = 174 frames → × 256 samples
    if audio.shape != (1, int(160 * 24000 / 22050) * 256, 1):
        raise AssertionError(f"decoder output shape {tuple(audio.shape)}")
    if not torch.isfinite(audio).all():
        raise AssertionError("decoder output is not finite")
    log(f"slice: 40 greedy tokens identical through kernel and plain attention, latents "
        f"max abs diff {lat_err:.3g} (tol 1e-4); {audio.shape[1]} samples of finite audio, "
        f"peak {audio.abs().max().item():.3f}")

    # decode step time in the serving dtype (bf16 GPT), kernel vs plain
    model.gpt.to(torch.bfloat16)
    for B in (1, 4):
        step_ms = {}
        for name in ("kernel", "plain", "kernel "):
            ctx = plain_decode_attention() if name == "plain" else contextlib.nullcontext()
            with ctx:
                state = model.gpt.prefill(cond.expand(B, -1, -1), text.expand(B, -1),
                                          lengths.expand(B), max_new_tokens=120)
                state, _, _ = model.gpt.decode_chunk(state, None, chunk_size=20, top_k=1)
                sync(device)
                t1 = time.perf_counter()
                model.gpt.decode_chunk(state, None, chunk_size=100, top_k=1)
                sync(device)
                step_ms[name] = (time.perf_counter() - t1) * 1e3 / 100
        log(f"decode step, bf16 GPT, B={B}, cache ~{state['cur_index']}: "
            f"{step_ms['kernel']:.2f} / {step_ms['kernel ']:.2f} ms kernel, "
            f"{step_ms['plain']:.2f} ms plain attention (host clock, synchronized) | {card}")
    profile_decode(model, cond, text, lengths, card, device)
    return model


def log_profile(prof, what: str, wall_us: float, card: str, top: int = 6) -> None:
    """Device busy share and top kernels of a profiled window. Only the
    kernel rows count: an operator's row repeats the device time of the
    kernels it launched."""
    from torch.autograd import DeviceType

    rows = [e for e in prof.key_averages() if e.device_type != DeviceType.CPU
            and e.self_device_time_total > 0]
    if not rows:
        log(f"profile, {what}: the profiler reported no device time (busy share not measured)")
        return
    busy_us = sum(e.self_device_time_total for e in rows)
    all_rows_us = sum(e.self_device_time_total for e in prof.key_averages())
    log(f"profile, {what}: device busy {busy_us / 1e3:.2f} ms of {wall_us / 1e3:.2f} ms wall "
        f"({100 * busy_us / wall_us:.1f} % busy; {sum(e.count for e in rows)} kernels; the sum "
        f"over operator and kernel rows together is {all_rows_us / 1e3:.2f} ms) | {card}")
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:top]:
        log(f"  {e.self_device_time_total / 1e3:8.3f} ms {e.count:6d}x  {e.key[:90]}")


def profile_decode(model, cond, text, lengths, card: str, device="cuda") -> None:
    """Device busy share of a bf16 B=1 decode chunk, from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    state = model.gpt.prefill(cond, text, lengths, max_new_tokens=60)
    model.gpt.decode_chunk(state, None, chunk_size=20, top_k=1)
    sync(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        model.gpt.decode_chunk(state, None, chunk_size=20, top_k=1)
        sync(device)
        wall_us = (time.perf_counter() - t1) * 1e6
    log_profile(prof, "bf16 B=1, 20 decode steps", wall_us, card)


def ttfa_parts(model, wav_path: str, text: str, device) -> dict:
    """Milliseconds of each stage before a stream's first audio, one stream
    on an idle device (host clock, synchronized)."""
    import torch

    parts = {}

    def timed(name, fn):
        sync(device)
        t0 = time.perf_counter()
        out = fn()
        sync(device)
        parts[name] = (time.perf_counter() - t0) * 1e3
        return out

    cond, spk = timed("conditioning",
                      lambda: model.resolve_conditioning(model.config, speaker_wav=wav_path))
    tokens, lengths = model._text_batch([text], "en")
    state = timed("prefill", lambda: model.gpt.prefill(cond, tokens, lengths,
                                                       max_new_tokens=STREAM_CHUNK))
    _, _, latents = timed("decode", lambda: model.gpt.decode_chunk(
        state, None, chunk_size=STREAM_CHUNK, top_k=1))
    audio = timed("vocoder", lambda: model.hifigan_decoder(latents, spk))
    if not torch.isfinite(audio).all():
        raise AssertionError("vocoder output is not finite")
    return parts


def _fetch(url: str, out: dict, key: str) -> None:
    t0 = time.perf_counter()
    with urllib.request.urlopen(url, timeout=900) as r:
        status = r.status
        head = r.read(44)
        first = r.read(2)  # blocks until the first audio bytes
        ttfa = time.perf_counter() - t0
        body = head + first + r.read()
    out[key] = {"status": status, "body": body, "ttfa": ttfa, "total": time.perf_counter() - t0}


def xtts_cli_call(model_dir: str, text: str, n_layers: int, card: str, device="cuda") -> None:
    """One ``tts`` command-line call on the XTTS model directory, cloning its
    reference voice into a file: a new model loads and decodes to the token
    limit (the stop token is suppressed). The decode-attention launches of
    the call must be ``n_layers`` x its decode steps, counted by the GPT of
    the model the command line built."""
    import scipy.io.wavfile

    import tts_tpu_torch.api as api
    from tts_tpu_torch.bin.synthesize import main as synthesize_cli
    from tts_tpu_torch.ops.decode_attention import decode_attention

    built = []

    class RecordedTTS(api.TTS):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            built.append(self)

    out = os.path.join(model_dir, "cli.wav")
    real, api.TTS = api.TTS, RecordedTTS
    try:
        decode_attention.launches = 0
        t0 = time.perf_counter()
        synthesize_cli(["--text", text, "--model_path", model_dir, "--speaker_wav",
                        os.path.join(model_dir, "ref.wav"), "--language_idx", "en",
                        "--out_path", out, "--device", str(device)])
        sync(device)
        seconds = time.perf_counter() - t0
        launches = decode_attention.launches
    finally:
        api.TTS = real
    steps = built[0].synthesizer.tts_model.gpt.decode_steps
    sr, pcm = scipy.io.wavfile.read(out)
    if sr != 24000 or len(pcm) < STREAM_CHUNK * 1024 or pcm.std() < 30:
        raise AssertionError(f"tts command line (XTTS): {len(pcm)} samples at {sr} Hz, "
                             f"std {pcm.std():.1f}")
    if steps == 0 or (device == "cuda" and launches != n_layers * steps):
        raise AssertionError(f"tts command line (XTTS): decode_attention launched {launches} "
                             f"times for {steps} decode steps of {n_layers} layers")
    log(f"tts command line (XTTS, --speaker_wav, --language_idx en): {len(pcm) / sr:.1f} s of "
        f"audio in {seconds:.2f} s including the model's load; {steps} decode steps, "
        f"decode_attention launches {launches} = {n_layers} x {steps} | {card}")


def phase_serving(model, card: str, device="cuda") -> int:
    """Serve 4 concurrent streams and one full request through the port's
    HTTP server; returns the decode-attention launches of this phase."""
    import io

    import scipy.io.wavfile
    import torch

    from tts_tpu_torch.audio.numpy_transforms import save_wav
    from tts_tpu_torch.models.xtts.tokenizer import write_char_vocab
    from tts_tpu_torch.ops.decode_attention import decode_attention
    from tts_tpu_torch.server.server import build_parser, close_server, server_from_args

    texts = ["the quick brown fox jumps over the lazy dog.",
             "a port of a streaming voice model to one card.",
             "four voices speak at once through one batch.",
             "each request gets its own stream of audio."]
    full_text = "this request waits for the whole utterance."
    with tempfile.TemporaryDirectory() as d:
        with open(os.path.join(d, "config.json"), "w") as f:
            json.dump(model.config.to_dict(), f, default=str)
        write_char_vocab(os.path.join(d, "vocab.json"), "abcdefghijklmnopqrstuvwxyz.,!?'-")
        # random weights sample the stop token now and then; forbid it so
        # every stream decodes its full length and the checks are exact
        model.gpt.mel_head.bias[model.gpt.stop_audio_token] = -1e4
        torch.save(model.state_dict_with_stats(), os.path.join(d, "model_torch.pt"))
        save_wav(wav=reference_wav(seed=1), path=os.path.join(d, "ref.wav"), sample_rate=22050)

        args = build_parser().parse_args(
            ["--model_path", d, "--port", "0", "--stream_batch", "4", "--stream_window_ms", "300",
             "--device", str(device)]
        )
        srv = server_from_args(args)
        served = srv.stream_batcher.model
        if served.gpt.dtype != torch.bfloat16:
            raise AssertionError(f"served GPT dtype {served.gpt.dtype}, want bf16")
        n_layers = len(served.gpt.gpt.h)
        thread = threading.Thread(target=srv.serve_forever, daemon=True)
        thread.start()
        base = f"http://127.0.0.1:{srv.server_address[1]}"
        ref = urllib.parse.quote(os.path.join(d, "ref.wav"))
        urls = {t: f"{base}/api/tts-stream?text={urllib.parse.quote(t)}&language_id=en"
                   f"&speaker_wav={ref}" for t in texts}
        urls["full"] = f"{base}/api/tts?text={urllib.parse.quote(full_text)}&language_id=en" \
                       f"&speaker_wav={ref}"
        results: dict = {}
        cuda = torch.device(device).type == "cuda"
        try:
            if cuda:
                torch.cuda.reset_peak_memory_stats()
            decode_attention.launches = 0
            served.gpt.decode_steps = served.gpt.decode_tokens = 0
            t0 = time.perf_counter()
            clients = [threading.Thread(target=_fetch, args=(u, results, k)) for k, u in urls.items()]
            for c in clients:
                c.start()
            for c in clients:
                c.join(timeout=900)
            elapsed = time.perf_counter() - t0
            launches, steps = decode_attention.launches, served.gpt.decode_steps
            tokens = served.gpt.decode_tokens
            peak_gb = torch.cuda.max_memory_allocated() / 1e9 if cuda else float("nan")
            if any(c.is_alive() for c in clients) or set(results) != set(urls):
                raise AssertionError(f"requests unanswered: {sorted(set(urls) - set(results))}")
            # then one stream alone on the idle server: its time to first audio
            # is conditioning + batching window + prefill + one chunk + vocoder
            _fetch(urls[texts[0]], results, "alone")
            # one more chunk straight from the model: the float audio is finite
            cond, spk = served.resolve_conditioning(served.config,
                                                    speaker_wav=os.path.join(d, "ref.wav"))
            probe = next(iter(served.inference_stream(texts[0], "en", cond, spk,
                                                      max_new_tokens=STREAM_CHUNK)))
            parts = ttfa_parts(served, os.path.join(d, "ref.wav"), texts[0], device)
        finally:
            close_server(srv)
            thread.join(timeout=60)
        xtts_cli_call(d, texts[0], n_layers, card, device)

    sr = served.config.model_args.output_sample_rate
    min_samples = STREAM_CHUNK * 1024
    for key, res in results.items():
        body = res["body"]
        if res["status"] != 200 or body[:4] != b"RIFF":
            raise AssertionError(f"{key!r}: HTTP {res['status']}, body starts {body[:4]!r}")
        if key == "full":
            _, pcm = scipy.io.wavfile.read(io.BytesIO(body))
        else:
            pcm = np.frombuffer(body[44:], dtype="<i2")
        if len(pcm) < min_samples:
            raise AssertionError(f"{key!r}: {len(pcm)} samples, want >= {min_samples}")
        if np.count_nonzero(pcm) < len(pcm) // 2 or pcm.std() < 30:
            raise AssertionError(f"{key!r}: silent audio (std {pcm.std():.1f} of 32767)")
        res["seconds"] = len(pcm) / sr
    if not np.isfinite(probe).all() or len(probe) < min_samples:
        raise AssertionError("direct streaming chunk is not finite or too short")
    if steps == 0 or (device == "cuda" and launches != n_layers * steps):
        raise AssertionError(
            f"decode_attention launched {launches} times for {steps} decode steps of "
            f"{n_layers} layers ({tokens} tokens)"
        )
    ttfa = sorted(results[t]["ttfa"] for t in texts)
    audio_s = sum(r["seconds"] for k, r in results.items() if k != "alone")
    log(f"serving: {len(texts)} concurrent /api/tts-stream + 1 /api/tts, {audio_s:.1f} s of "
        f"audio in {elapsed:.2f} s; {steps} decode steps, {tokens} tokens, decode_attention "
        f"launches {launches} = {n_layers} x {steps}")
    log(f"serving: TTFA median {ttfa[len(ttfa) // 2] * 1e3:.0f} ms, max {ttfa[-1] * 1e3:.0f} ms "
        f"under load, {results['alone']['ttfa'] * 1e3:.0f} ms alone (300 ms batching window "
        f"included); aggregate decode {tokens / elapsed:.1f} tokens/s; /api/tts "
        f"{results['full']['total']:.2f} s for {results['full']['seconds']:.1f} s of audio; "
        f"peak device memory {peak_gb:.2f} GB | {card}")
    log("serving: TTFA parts, one stream on an idle device: "
        + ", ".join(f"{k} {v:.1f} ms" for k, v in parts.items())
        + f" (host clock, synchronized; bf16 GPT, {STREAM_CHUNK} decode steps) | {card}")
    return launches


# ---------------------------------------------------------------------------
VITS_SENTENCES = {
    "short": "Be a voice, not an echo.",
    "medium": "It took me quite a long time to develop a voice, and now that I have it "
              "I'm not going to be silent.",
    "long": "The Commission has not been able to find any credible evidence that the "
            "assassin had any help in planning or carrying out the shooting. On November "
            "22, 1963, at 12:30 p.m., the motorcade turned onto Elm Street, and within "
            "seconds three shots had been fired from the sixth floor of the depository.",
}
VITS_WAV_TOL = 1e-4  # card vs CPU, fp32 with TF32 off


def vits_recipe_config():
    """``recipes/ljspeech/vits/train_vits.py``'s inference fields (its
    ``add_blank`` is ``VitsConfig``'s default) at the ``VitsArgs`` defaults.
    ``num_chars`` is left to the tokenizer, which sizes the embedding to the
    131 IPA symbols as the reference's VITS does (the default 100 would
    leave the punctuation ids past the table, ROADMAP.md F7)."""
    from tts_tpu_torch.models.vits import VitsConfig

    config = VitsConfig(text_cleaner="english_cleaners", use_phonemes=True,
                        phoneme_language="en-us")
    config.model_args.num_chars = None
    return config


@contextlib.contextmanager
def host_noise(seed: int = 0):
    """Every VITS noise draw comes from one table on the host, keyed by
    shape and drawn on first use from a CPU generator, then copied to the
    generator's device: a card run and a CPU run get the same noise, and a
    durations pass gets the draw of the inference after it."""
    import torch

    from tts_tpu_torch.models.vits import modules

    gen = torch.Generator().manual_seed(seed)
    table = {}

    def normal(shape, generator):
        key = tuple(shape)
        if key not in table:
            table[key] = torch.randn(key, generator=gen)
        return table[key].to(generator.device)

    real = modules.normal
    modules.normal = normal
    try:
        yield
    finally:
        modules.normal = real


def hifigan_gflop(args, frames: int) -> float:
    """Operations (2 per multiply-add) of VITS's HiFiGAN decoder for
    ``frames`` latent frames: ``conv_pre``, each transposed conv (every
    input frame meets ``k`` taps), each ResBlock1's two convs per dilation
    at the upsampled rate, and ``conv_post``."""
    ch = args.upsample_initial_channel_decoder
    flops = 2 * args.hidden_channels * ch * 7 * frames
    n = frames
    for i, (u, k) in enumerate(zip(args.upsample_rates_decoder,
                                   args.upsample_kernel_sizes_decoder)):
        cin, cout = ch // 2**i, ch // 2 ** (i + 1)
        flops += 2 * cin * cout * k * n
        n *= u
        for kr, dils in zip(args.resblock_kernel_sizes_decoder,
                            args.resblock_dilation_sizes_decoder):
            flops += 2 * len(dils) * 2 * cout * cout * kr * n
    flops += 2 * cout * 7 * n
    return flops / 1e9


def vits_stage_ms(model, text: str, device, reps: int = 5) -> dict:
    """Milliseconds of each stage of one sentence's inference on the card
    (host clock around synchronized calls, median of ``reps``), and of the
    whole ``synthesis`` call."""
    import torch

    from tts_tpu_torch.ops.helpers import generate_path, sequence_mask
    from tts_tpu_torch.utils.synthesis import synthesis

    vm = model.module
    a = model.args
    ids = model.tokenizer.text_to_ids(text)
    T = ((len(ids) + 15) // 16) * 16
    x = torch.zeros(1, T, dtype=torch.long, device=device)
    x[0, : len(ids)] = torch.tensor(ids, device=device)
    xl = torch.tensor([len(ids)], device=device)
    gen = torch.Generator(device=device).manual_seed(0)
    times: dict = {}

    def timed(name, fn):
        runs = []
        for _ in range(reps):
            sync(device)
            t0 = time.perf_counter()
            out = fn()
            sync(device)
            runs.append((time.perf_counter() - t0) * 1e3)
        times[name] = sorted(runs)[reps // 2]
        return out

    with torch.no_grad():
        h, m_p, logs_p, x_mask = timed("text encoder", lambda: vm.text_encoder(x, xl))
        logw = timed("duration predictor", lambda: vm.duration_predictor(
            h, x_mask, gen.manual_seed(0), noise_scale=a.inference_noise_scale_dp))
        w_ceil = torch.ceil(torch.exp(logw) * x_mask * a.length_scale) * x_mask
        frames = int(w_ceil.sum())
        budget = ((frames + 31) // 32) * 32

        def expand():
            y_mask = sequence_mask(torch.tensor([frames], device=device), budget)[:, :, None]
            attn = generate_path(w_ceil[:, :, 0], x_mask * y_mask.transpose(1, 2).float())
            m = torch.bmm(attn.transpose(1, 2), m_p)
            lg = torch.bmm(attn.transpose(1, 2), logs_p)
            noise = torch.randn(m.shape, generator=gen, device=device)
            return (m + noise * torch.exp(lg) * a.inference_noise_scale), y_mask.float()

        z_p, y_mask = timed("path + prior", expand)
        z = timed("flow", lambda: vm.flow(z_p * y_mask, y_mask))
        timed("HiFiGAN", lambda: vm.waveform_decoder(z * y_mask))
        # the decoder alone, device-bound: CUDA events around 10 calls
        hifigan_ms = time_host(lambda: vm.waveform_decoder(z * y_mask), iters=10,
                               warmup=2) if torch.device(device).type == "cuda" else None
    timed("synthesis (all, incl. durations pass)", lambda: synthesis(model, text))
    return {"times": times, "frames": frames, "budget": budget, "tokens": len(ids),
            "hifigan_ms": hifigan_ms}


def profile_vits(model, text: str, card: str) -> None:
    """Device busy share of one ``synthesis`` call, from torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from tts_tpu_torch.utils.synthesis import synthesis

    synthesis(model, text)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        synthesis(model, text)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t1) * 1e6
    log_profile(prof, "VITS, one medium sentence through synthesis()", wall_us, card, top=8)


def _http(url: str, data: bytes = None) -> tuple:
    """``(status, content type, body)`` of one request; ``data`` makes it a
    POST of a form body."""
    try:
        with urllib.request.urlopen(urllib.request.Request(url, data=data), timeout=600) as r:
            return r.status, r.headers["Content-Type"], r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers["Content-Type"], e.read()


def check_vits_routes(routes: dict, short_tts_body: bytes) -> None:
    """``/details`` names the recipe's model and phoneme language, the
    MaryTTS routes answer as the JAX server does, and ``POST /process``
    gives a wav of ``/api/tts``'s length for the same text."""
    import io

    import scipy.io.wavfile

    status, ctype, body = routes["/details"]
    details = json.loads(body) if status == 200 else {}
    config = details.get("tts_config") or {}
    if (ctype, config.get("model"), config.get("phoneme_language")) != (
            "application/json", "vits", "en-us") or details.get("speakers") != []:
        raise AssertionError(f"/details: HTTP {status} {ctype}, model {config.get('model')!r}, "
                             f"phoneme_language {config.get('phoneme_language')!r}")
    for path, want in (("/locales", b"en_US\n"), ("/voices", b"default en_US u\n")):
        if routes[path] != (200, "text/plain", want):
            raise AssertionError(f"{path}: {routes[path]!r}")
    status, ctype, body = routes["POST /process"]
    want = scipy.io.wavfile.read(io.BytesIO(short_tts_body))[1]
    if status != 200 or ctype != "audio/wav":
        raise AssertionError(f"POST /process: HTTP {status} {ctype}")
    got = scipy.io.wavfile.read(io.BytesIO(body))[1]
    if got.shape != want.shape or got.std() < 30:
        raise AssertionError(f"POST /process: {got.shape} samples, /api/tts {want.shape}")
    log(f"VITS routes: /details (model vits, phoneme_language en-us), /locales, /voices as the "
        f"JAX server; POST /process {len(got)} samples = /api/tts's")


def phase_vits(card: str, device="cuda", config=None) -> None:
    """Full-width single-speaker VITS on the card: card against CPU on three
    sentences, three served ``/api/tts`` requests, one file through the API,
    then RTF, stage times, busy share and peak memory."""
    import io

    import scipy.io.wavfile
    import torch

    from tts_tpu_torch.api import TTS
    from tts_tpu_torch.bin.synthesize import main as synthesize_cli
    from tts_tpu_torch.models.vits import Vits
    from tts_tpu_torch.ops.decode_attention import decode_attention
    from tts_tpu_torch.server.server import build_parser, close_server, server_from_args
    from tts_tpu_torch.utils.synthesis import synthesis
    from tts_tpu_torch.utils.synthesizer import SENTENCE_GAP

    cuda = torch.device(device).type == "cuda"
    config = config or vits_recipe_config()
    decode_attention.launches = 0  # K1 is not on this path: the count must stay 0
    if cuda:
        gc.collect()  # what earlier phases left in reference cycles (their server)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
    t0 = time.time()
    model = Vits.init_from_config(config).init_params(seed=0, device=device)
    a = model.args
    n_params = sum(p.numel() for p in model.module.parameters())
    tokens = {k: len(model.tokenizer.text_to_ids(t)) for k, t in VITS_SENTENCES.items()}
    log(f"VITS text front end: {config.text_cleaner}, phonemizer "
        f"{model.tokenizer.phonemizer.name()} ({config.phoneme_language}), "
        f"{type(model.tokenizer.characters).__name__} with num_chars {a.num_chars}, blanks "
        f"{config.add_blank}; token counts " + ", ".join(f"{k} {n}" for k, n in tokens.items()))
    log(f"VITS (LJSpeech recipe, phonemes): hidden {a.hidden_channels}, FFN "
        f"{a.hidden_channels_ffn_text_encoder}, {a.num_layers_text_encoder} encoder layers, "
        f"{a.num_heads_text_encoder} heads, 4 flows of {a.num_layers_flow} WN layers, "
        f"stochastic durations, HiFiGAN {a.upsample_initial_channel_decoder} ch x "
        f"{a.upsample_rates_decoder}; {n_params / 1e6:.2f} M parameters (random, seed 0), "
        f"ready in {time.time() - t0:.1f} s")

    # card against CPU: same weights (drawn on the host), same host noise
    texts = list(VITS_SENTENCES.values())
    cpu_model = Vits.init_from_config(config).init_params(seed=0, device="cpu")
    worst, lengths = 0.0, []
    with host_noise(seed=0):
        for text in texts:
            got = synthesis(model, text)
            want = synthesis(cpu_model, text)
            g_len, w_len = got["outputs"]["y_lengths"].cpu(), want["outputs"]["y_lengths"]
            if not torch.equal(g_len, w_len):
                raise AssertionError(f"VITS y_lengths card {g_len.tolist()} != CPU "
                                     f"{w_len.tolist()} for {text!r}")
            if got["wav"].shape != want["wav"].shape or not np.isfinite(got["wav"]).all():
                raise AssertionError(f"VITS waveform {got['wav'].shape} vs {want['wav'].shape}")
            err = float(np.abs(got["wav"] - want["wav"]).max())
            worst = max(worst, err)
            lengths.append(int(g_len[0]))
            if not err <= VITS_WAV_TOL:
                raise AssertionError(f"VITS card vs CPU: max abs diff {err} > {VITS_WAV_TOL} "
                                     f"for {text!r}")
    del cpu_model
    log(f"VITS card vs CPU, three sentences on host noise: y_lengths {lengths} equal, "
        f"waveform max abs diff {worst:.3g} (tol {VITS_WAV_TOL})")

    with tempfile.TemporaryDirectory() as d:
        with open(os.path.join(d, "config.json"), "w") as f:
            json.dump(model.config.to_dict(), f)
        torch.save(model.module.state_dict(), os.path.join(d, "model_torch.pt"))
        # three concurrent /api/tts requests through the server's command line
        args = build_parser().parse_args(["--model_path", d, "--port", "0",
                                          "--device", str(device)])
        srv = server_from_args(args)
        thread = threading.Thread(target=srv.serve_forever, daemon=True)
        thread.start()
        base = f"http://127.0.0.1:{srv.server_address[1]}"
        results: dict = {}
        try:
            t1 = time.perf_counter()
            clients = [threading.Thread(target=_fetch, args=(
                f"{base}/api/tts?text={urllib.parse.quote(t)}", results, k))
                for k, t in VITS_SENTENCES.items()]
            for c in clients:
                c.start()
            for c in clients:
                c.join(timeout=600)
            served_s = time.perf_counter() - t1
            routes = {path: _http(base + path) for path in ("/details", "/locales", "/voices")}
            form = urllib.parse.urlencode({"INPUT_TEXT": VITS_SENTENCES["short"]}).encode()
            routes["POST /process"] = _http(base + "/process", data=form)
        finally:
            close_server(srv)
            thread.join(timeout=60)
        if set(results) != set(VITS_SENTENCES):
            raise AssertionError(f"VITS requests unanswered: "
                                 f"{sorted(set(VITS_SENTENCES) - set(results))}")
        audio_s = 0.0
        for key, res in results.items():
            body = res["body"]
            if res["status"] != 200 or body[:4] != b"RIFF":
                raise AssertionError(f"VITS /api/tts {key!r}: HTTP {res['status']}")
            sr, pcm = scipy.io.wavfile.read(io.BytesIO(body))
            if sr != 22050 or len(pcm) <= SENTENCE_GAP or pcm[:-SENTENCE_GAP].std() < 30:
                raise AssertionError(f"VITS /api/tts {key!r}: {sr} Hz, {len(pcm)} samples")
            audio_s += len(pcm) / sr
        log(f"VITS serving: 3 concurrent /api/tts requests, {audio_s:.2f} s of audio in "
            f"{served_s:.2f} s (one lock: served one after another) | {card}")
        check_vits_routes(routes, results["short"]["body"])

        # one file through the API, one through the command line: same noise
        # (each call seeds its generator), same samples
        tts = TTS(model_path=d, device=device)
        path = tts.tts_to_file(VITS_SENTENCES["medium"], file_path=os.path.join(d, "api.wav"))
        sr, pcm = scipy.io.wavfile.read(path)
        if sr != 22050 or len(pcm) <= SENTENCE_GAP:
            raise AssertionError(f"TTS.tts_to_file wrote {len(pcm)} samples at {sr} Hz")
        del tts
        cli_path = os.path.join(d, "cli.wav")
        synthesize_cli(["--text", VITS_SENTENCES["medium"], "--model_path", d,
                        "--out_path", cli_path, "--device", str(device)])
        cli_sr, cli_pcm = scipy.io.wavfile.read(cli_path)
        step = np.abs(cli_pcm.astype(np.int32) - pcm.astype(np.int32)).max()
        if cli_sr != sr or cli_pcm.shape != pcm.shape or pcm.dtype != np.int16 or step > 1:
            raise AssertionError(f"tts command line {cli_pcm.shape} {cli_pcm.dtype} at {cli_sr} Hz "
                                 f"vs TTS.tts_to_file {pcm.shape} {pcm.dtype}: {step} int16 steps")
        log(f"VITS TTS.tts_to_file and the tts command line: {len(pcm)} 16-bit samples at {sr} Hz "
            f"each, at most {step} int16 step apart")

    # real-time factor at B=1: audio seconds per wall second, median of 5
    synthesis(model, VITS_SENTENCES["medium"])
    sync(device)
    for key, text in VITS_SENTENCES.items():
        runs = []
        for _ in range(5):
            sync(device)
            t1 = time.perf_counter()
            out = synthesis(model, text)
            sync(device)
            runs.append(time.perf_counter() - t1)
        wall = sorted(runs)[2]
        seconds = len(out["wav"]) / 22050
        log(f"VITS RTF {key}: {seconds:.2f} s of audio ({int(out['outputs']['y_lengths'][0])} "
            f"frames, {out['text_inputs'].shape[1]} padded tokens) in {wall * 1e3:.1f} ms "
            f"(median of 5; {min(runs) * 1e3:.1f}-{max(runs) * 1e3:.1f}), RTF "
            f"{seconds / wall:.1f} x real time | {card}")
    stages = vits_stage_ms(model, VITS_SENTENCES["medium"], device)
    log(f"VITS stages, medium sentence ({stages['tokens']} tokens, {stages['frames']} frames, "
        f"budget {stages['budget']}), ms (host clock, synchronized, median of 5): "
        + ", ".join(f"{k} {v:.2f}" for k, v in stages["times"].items()) + f" | {card}")
    gflop = hifigan_gflop(model.args, stages["budget"])
    per_s = hifigan_gflop(model.args, 1) * model.config.audio.sample_rate / model.hop_length
    line = (f"VITS HiFiGAN: {gflop:.1f} GFLOP for the {stages['budget']}-frame budget "
            f"({per_s:.2f} GFLOP per second of audio); fp32 bound "
            f"{gflop / FP32_FLOPS_PER_S * 1e12:.2f} ms at 67 TFLOP/s")
    if stages["hifigan_ms"] is not None:
        ms = stages["hifigan_ms"]
        line += (f"; {ms:.2f} ms per call (CUDA events, 10 calls), {gflop / ms:.1f} TFLOP/s, "
                 f"{100 * gflop / ms * 1e12 / FP32_FLOPS_PER_S:.1f} % of the fp32 peak")
    log(line + f" | {card}")
    if decode_attention.launches:
        raise AssertionError(f"decode_attention launched {decode_attention.launches} times "
                             f"during the VITS phase")
    log("VITS: no hand-written kernel on this path (decode_attention launches 0)")
    if cuda:
        profile_vits(model, VITS_SENTENCES["medium"], card)
        peak = torch.cuda.max_memory_allocated()
        log(f"VITS peak device memory {peak / 1e9:.3f} GB allocated, {(peak - resident) / 1e9:.3f} "
            f"GB above the {resident / 1e9:.3f} GB resident before the phase | {card}")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on the card only",
              file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, "tts_tpu_torch")):
        print("chip_smoke: run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)

    card = phase_environment()
    phase_build()
    kernel = phase_kernels(card)
    model = phase_slice(card)
    kernel["launches"] = phase_serving(model, card)
    del model
    phase_vits(card)
    leaked = sorted(m for m in sys.modules if m in ("jax", "flax", "tokenizers", "tts_tpu")
                    or m.startswith("tts_tpu."))
    if leaked:
        raise AssertionError(f"the port imported {leaked}")
    print(json.dumps({"kernels": [kernel]}))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
