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
   launch count of this phase proves the decode went through the kernel,
   and each request decodes ``max_mel_tokens - 3`` tokens (602), a
   stream's last chunk cut short there. Then one stream on the idle server, and its time to first audio split
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
   hand-written kernel (the JAX package reaches no Pallas kernel there);
7. batched VITS: the same recipe and seed from a model directory. A
   three-sentence request through the ``Synthesizer``'s packed path on the
   card and on the CPU on host noise (plans and ``y_lengths`` equal,
   waveform within 1e-4); on the card, each packed segment (batch noise
   layout) against its sentence decoded alone with masks (within 1e-4);
   the request's wall time packed against the serial loop, with kernels
   and busy share under ``torch.profiler``; the packed decode timed under
   plans billing rows by eights (the JAX package's) and by ones; the
   server from its command line with ``--max_batch 1`` and ``--max_batch
   4`` answering 8 concurrent ``/api/tts`` requests (2 short, 4 medium,
   2 long), with the batch sizes its worker formed and the plans'
   utilization; peak memory. ``decode_attention`` must not launch;
8. multi-speaker VITS: the VCTK recipe (109 speakers, the flags set on
   ``model_args``), the multilingual recipe (16 kHz, the multi-phonemizer,
   language and speaker embeddings, the M-AILABS language codes) and a
   512-wide d-vector model, full width from seed 0. VCTK card against CPU
   on host noise for two speakers, on one sentence and on one packed
   three-sentence request (``y_lengths`` and plans equal, waveform within
   1e-4; the two speakers differ); one packed grid of four speakers, each
   segment within 1e-4 of its own masked decode; ``/api/tts`` with
   ``speaker_id`` (an unknown one answered 400), ``/details`` listing the
   109 speakers, ``tts --list_speaker_idxs`` and a ``--speaker_idx`` file
   within one int16 step of ``TTS.tts_to_file``'s; the serving mix over
   four speakers with ``--max_batch 1`` and ``4``; the medium sentence's
   latency beside phase 6's, busy share, peak memory. Multilingual: card
   against CPU for each language a phonemizer here serves, and one batched
   turn mixing them and their speakers. d-vectors: card against CPU.
   ``decode_attention`` must not launch;
9. zoo, voice conversion and VITS variants, full width from seed 0: the
   VCTK recipe saved as a zoo directory (reference-layout
   ``model_file.pth``, ``config.json``, ``speakers.pth``) under a temporary
   ``TTS_HOME`` with a copy of the catalog as ``TTS_TPU_MODELS_FILE``
   (any fetch raises); ``TTS(model_name=...)`` and ``tts --model_name``
   against the same files loaded by path; a p225 recording the port speaks
   converted to p226, card against CPU on host noise; the MB-iSTFT-VITS
   decoder (arXiv:2210.15975's widths) and an encoder-rate model (44.1 kHz
   out, encoders at 22.05 kHz, ``interpolate_z``), card against CPU on three
   sentences, the medium sentence's latency and RTF; the grouped
   dispatch's ``overhead`` fitted on the iSTFT model (a dispatch's floor
   over its marginal ms per frame·row); one grouped batcher turn card
   against CPU and the serving mix with ``--max_batch 1`` and 4 on the
   iSTFT model, with the groups formed. ``decode_attention`` must not
   launch;
10. GlowTTS with Multiband-MelGAN, the ``tts`` command line's default
    pairing, at the LJSpeech recipes' widths (``phoneme_cleaners``,
    ``en-us`` phonemes from the rule G2P and the ``GlowTTSConfig``
    defaults; the ``MultibandMelganConfig`` defaults), fp32 weights from
    seed 0: the fidelity fixtures ``glow_tts.npz`` and
    ``multiband_melgan.npz`` replayed on the card through the port's
    converters (``y_lengths`` equal and mel RMSE under 5e-3; under 0.5 dB);
    the three phase 6 sentences card against CPU (``y_lengths`` equal, mel
    and waveform within 1e-4); latency and RTF at B=1 with a stage split
    (encoder with durations, path expansion, flow decoder, host bridge,
    MB-MelGAN by CUDA events), MB-MelGAN's TFLOP/s, the busy share and
    kernels under ``torch.profiler``, peak memory; Griffin-Lim without a
    vocoder, card against CPU after one ``np.random.seed``; the pair by zoo
    name from reference-layout directories (the vocoder's ``stats_path``
    rewritten, F17), equal to the path load; ``tts --vocoder_path`` within
    one int16 step of the API; the server with ``--vocoder_path`` and
    ``--max_batch 4``, which says it serves serially and answers three
    ``/api/tts`` requests. ``decode_attention`` must not launch.

It prints the card's name and power limit, then ``{"kernels": [...]}`` on
the line before the last and, as the last line, ``{"ok": true, "device":
{...}}``. The port must have imported nothing of ``tts_tpu``, JAX, flax or
``tokenizers`` by then. Without CUDA, or outside a
checkout, it exits 2 and prints no result.
"""

from __future__ import annotations

import contextlib
import functools
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
    # every request decodes to the bound of every decode, max_mel_tokens - 3
    # tokens: a stream's last chunk is cut short there (ROADMAP.md F5)
    max_new = served.gpt.max_mel_tokens - 3
    if tokens != len(urls) * max_new:
        raise AssertionError(f"{tokens} tokens decoded for {len(urls)} requests, want "
                             f"{len(urls)} x {max_new}")
    ttfa = sorted(results[t]["ttfa"] for t in texts)
    audio_s = sum(r["seconds"] for k, r in results.items() if k != "alone")
    log(f"serving: {len(texts)} concurrent /api/tts-stream + 1 /api/tts, {audio_s:.1f} s of "
        f"audio in {elapsed:.2f} s; {steps} decode steps, {tokens} tokens = {len(urls)} x "
        f"{max_new}, decode_attention launches {launches} = {n_layers} x {steps}")
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


def phase_vits(card: str, device="cuda", config=None) -> dict:
    """Full-width single-speaker VITS on the card: card against CPU on three
    sentences, three served ``/api/tts`` requests, one file through the API,
    then RTF, stage times, busy share and peak memory. Returns each
    sentence's median latency in ms."""
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
    latency_ms = {}
    for key, text in VITS_SENTENCES.items():
        runs = []
        for _ in range(5):
            sync(device)
            t1 = time.perf_counter()
            out = synthesis(model, text)
            sync(device)
            runs.append(time.perf_counter() - t1)
        wall = sorted(runs)[2]
        latency_ms[key] = wall * 1e3
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
    return latency_ms


# ---------------------------------------------------------------------------
VITS_MASKED_TOL = 1e-4  # packed segment vs its own masked decode, both on the card
# the serving mix: requests by sentence length, as (key, count); "long" is two sentences
VITS_MIX = (("short", 2), ("medium", 4), ("long", 2))


def vits_request() -> str:
    """Three sentences of phase 6's: the short, the medium, and the long
    one's first."""
    from tts_tpu_torch.utils.synthesizer import split_into_sentences

    first = split_into_sentences(VITS_SENTENCES["long"])[0]
    return " ".join([VITS_SENTENCES["short"], VITS_SENTENCES["medium"], first])


@contextlib.contextmanager
def recorded_plans():
    """Every pack plan ``decode_packed`` makes inside, in order."""
    from tts_tpu_torch.utils import synthesis as synthesis_module

    plans = []
    real = synthesis_module.plan_pack_layout

    def recording(*args, **kwargs):
        plans.append(real(*args, **kwargs))
        return plans[-1]

    synthesis_module.plan_pack_layout = recording
    try:
        yield plans
    finally:
        synthesis_module.plan_pack_layout = real


@contextlib.contextmanager
def recorded_y_lengths(model, methods=("inference_packed",)):
    """``y_lengths`` of every call of ``model``'s ``methods`` inside."""
    seen = []

    def recording(real):
        def call(*args, **kwargs):
            out = real(*args, **kwargs)
            seen.append(out["y_lengths"].cpu().tolist())
            return out
        return call

    for name in methods:
        setattr(model, name, recording(getattr(model, name)))
    try:
        yield seen
    finally:
        for name in methods:
            delattr(model, name)


def padded_ids(model, sentences, rows: int):
    """Token ids of ``sentences`` in ``rows`` rows (rows past them length
    1), padded to a multiple of 16: ``(x, x_lengths)`` on the model's
    device, as the batcher pads them."""
    import torch

    ids = [model.tokenizer.text_to_ids(s) for s in sentences]
    width = ((max(len(i) for i in ids) + 15) // 16) * 16
    x = torch.zeros(rows, width, dtype=torch.long)
    x_lengths = torch.ones(rows, dtype=torch.long)
    for row, i in enumerate(ids):
        x[row, : len(i)] = torch.tensor(i)
        x_lengths[row] = len(i)
    return x.to(model.device), x_lengths.to(model.device)


def masked_decodes(model, x, x_lengths, noise_frames: int, aux=None) -> list:
    """Each row of ``x`` decoded alone at its own length, with its own
    speaker from ``aux`` (``aux_input``), zero-padded by 16 frames and
    masked after every layer and conv, on the noise
    ``inference_packed(noise_layout="batch")`` draws from a generator seeded
    0 on the model's device: the reference each packed segment must equal."""
    import torch

    from tts_tpu_torch.models.vits import modules
    from tts_tpu_torch.ops.helpers import generate_path, sequence_mask

    vm, a, dev = model.module, model.args, model.device
    gen = torch.Generator(device=dev).manual_seed(0)
    wavs = []
    with torch.no_grad():
        g, lang = vm._cond_vectors(aux)
        w_ceil, m_p, logs_p, x_mask = vm._durations(x, x_lengths, gen, g, lang)
        noise = modules.normal((x.shape[0], noise_frames, m_p.shape[-1]), gen)
        for i in range(x.shape[0]):
            frames = int(w_ceil[i].sum())
            y_mask = sequence_mask(torch.tensor([frames], device=dev),
                                   frames + 16)[:, :, None].float()
            attn = generate_path(w_ceil[i : i + 1, :, 0],
                                 x_mask[i : i + 1] * y_mask.transpose(1, 2))
            mean = torch.bmm(attn.transpose(1, 2), m_p[i : i + 1])
            log_scale = torch.bmm(attn.transpose(1, 2), logs_p[i : i + 1])
            eps = torch.zeros_like(mean)
            eps[0, :frames] = noise[i, :frames]
            z_p = (mean + eps * torch.exp(log_scale) * a.inference_noise_scale) * y_mask
            g_i = None if g is None else g[i : i + 1]
            z = vm.flow(z_p, y_mask, g=g_i)
            o = vm.waveform_decoder(z * y_mask, g=g_i, x_mask=y_mask)
            wavs.append(o[0, : frames * model.hop_length, 0].cpu().numpy())
    return wavs


def median_ms(fn, device, reps: int = 5) -> tuple:
    """``(median, min, max)`` milliseconds of ``reps`` synchronized calls."""
    runs = []
    for _ in range(reps):
        sync(device)
        t0 = time.perf_counter()
        fn()
        sync(device)
        runs.append((time.perf_counter() - t0) * 1e3)
    runs.sort()
    return runs[reps // 2], runs[0], runs[-1]


def profile_call(fn, what: str, card: str) -> None:
    """Kernels launched and device busy share of one call of ``fn``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t1) * 1e6
    log_profile(prof, what, wall_us, card, top=4)


def serve_mix(model_dir: str, max_batch: int, device, speakers=()) -> dict:
    """The serving mix as concurrent ``/api/tts`` requests to a server
    started from its command line with ``--max_batch``, the requests'
    ``speaker_id`` taken from ``speakers`` in turn: audio seconds, wall
    seconds, the batch sizes its worker formed (read by wrapping the
    batcher's ``_dispatch``) and the plans made."""
    import io

    import scipy.io.wavfile

    from tts_tpu_torch.server.server import build_parser, close_server, server_from_args
    from tts_tpu_torch.utils.synthesizer import SENTENCE_GAP

    args = build_parser().parse_args(["--model_path", model_dir, "--port", "0", "--max_batch",
                                      str(max_batch), "--device", str(device)])
    srv = server_from_args(args)
    sizes = []
    if max_batch > 1:
        real = srv.batcher._dispatch

        def dispatch(batch):
            sizes.append(len(batch))
            real(batch)

        srv.batcher._dispatch = dispatch
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    urls = {f"{key}{n}": f"{base}/api/tts?text={urllib.parse.quote(VITS_SENTENCES[key])}"
            for key, count in VITS_MIX for n in range(count)}
    for i, key in enumerate(urls if speakers else ()):
        urls[key] += f"&speaker_id={speakers[i % len(speakers)]}"
    results: dict = {}
    try:
        with recorded_plans() as plans:
            t0 = time.perf_counter()
            clients = [threading.Thread(target=_fetch, args=(u, results, k))
                       for k, u in urls.items()]
            for c in clients:
                c.start()
            for c in clients:
                c.join(timeout=600)
            wall = time.perf_counter() - t0
    finally:
        close_server(srv)
        thread.join(timeout=60)
    if set(results) != set(urls):
        raise AssertionError(f"--max_batch {max_batch}: unanswered {sorted(set(urls) - set(results))}")
    audio_s = 0.0
    for key, res in results.items():
        sr, pcm = scipy.io.wavfile.read(io.BytesIO(res["body"]))
        if res["status"] != 200 or sr != 22050 or len(pcm) <= SENTENCE_GAP \
                or pcm[:-SENTENCE_GAP].std() < 30:
            raise AssertionError(f"--max_batch {max_batch} {key!r}: HTTP {res['status']}, "
                                 f"{len(pcm)} samples")
        audio_s += len(pcm) / sr
    return {"audio_s": audio_s, "wall_s": wall, "sizes": sizes, "plans": list(plans)}


def time_row_billing(model, name: str, sentences, rows: int, card: str, device) -> dict:
    """The packed decode of ``sentences`` (``rows`` padded rows) under plans
    billed by eights and by ones: milliseconds (synchronized host clock,
    median of 5 each, in turns 8, 1, 1, 8, ...), rows, row length and
    utilization of each plan."""
    from tts_tpu_torch.utils.packing import plan_pack_layout
    from tts_tpu_torch.utils.synthesis import _frame_budget

    x, x_lengths = padded_ids(model, sentences, rows)
    budget = _frame_budget(max(len(model.tokenizer.text_to_ids(s)) for s in sentences))
    lens = model.infer_durations(x, x_lengths)[: len(sentences)].cpu().numpy()
    plans = {m: plan_pack_layout(lens, row_pad_multiple=m) for m in (8, 1)}

    def decode(plan):
        return model.inference_packed(x, x_lengths, plan.seg_sample, plan.seg_pos,
                                      noise_frames=budget, noise_layout="packed")

    for plan in plans.values():
        decode(plan)  # first call of each grid shape
    runs = {8: [], 1: []}
    for m in (8, 1, 1, 8, 8, 1, 1, 8, 8, 1):
        runs[m].append(median_ms(lambda: decode(plans[m]), device, reps=1)[0])
    out = {}
    for m, plan in plans.items():
        ms = sorted(runs[m])[2]
        out[m] = ms
        log(f"VITS row billing, {name} ({len(sentences)} sentences, {sum(lens)} frames): "
            f"row_pad_multiple {m}: {plan.n_rows} x {plan.row_len} grid, utilization "
            f"{plan.utilization:.3f}, packed decode {ms:.2f} ms (median of 5; "
            f"{min(runs[m]):.2f}-{max(runs[m]):.2f}) | {card}")
    return out


def save_model_dir(config, d: str) -> None:
    """Random fp32 weights from seed 0, drawn on the host, and the config
    into the model directory ``d``."""
    import torch

    from tts_tpu_torch.models.vits import Vits

    model = Vits.init_from_config(config).init_params(seed=0, device="cpu")
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump(model.config.to_dict(), f)
    torch.save(model.module.state_dict(), os.path.join(d, "model_torch.pt"))


def card_against_cpu(synth, cpu_synth, text: str, **names) -> tuple:
    """One request through the card's and the CPU's ``Synthesizer`` on host
    noise: ``(samples, max abs diff, y_lengths, plans)``; raises unless the
    plans and ``y_lengths`` are equal and the waveforms within
    ``VITS_WAV_TOL``."""
    both = ("inference", "inference_packed")
    with host_noise(seed=0), recorded_plans() as plans, \
            recorded_y_lengths(synth.tts_model, both) as got_y, \
            recorded_y_lengths(cpu_synth.tts_model, both) as want_y:
        got = np.asarray(synth.tts(text, **names), np.float32)
        want = np.asarray(cpu_synth.tts(text, **names), np.float32)
    if plans:
        a, b = plans
        if (a.slices, a.n_rows, a.row_len) != (b.slices, b.n_rows, b.row_len) or not (
                np.array_equal(a.seg_sample, b.seg_sample) and np.array_equal(a.seg_pos, b.seg_pos)):
            raise AssertionError(f"{names}: pack plans differ, card {a.slices} CPU {b.slices}")
    if not got_y or got_y != want_y:
        raise AssertionError(f"{names}: y_lengths card {got_y} CPU {want_y}")
    err = float(np.abs(got - want).max()) if got.shape == want.shape else float("inf")
    if not np.isfinite(got).all() or not err <= VITS_WAV_TOL:
        raise AssertionError(f"{names} card vs CPU: {got.shape} vs {want.shape}, "
                             f"max abs diff {err} (tol {VITS_WAV_TOL})")
    return got, err, got_y, plans


def phase_batched_vits(card: str, device="cuda", config=None) -> None:
    """Batched VITS serving at full width: card against CPU on one
    three-sentence request through the packed path, packed segments against
    their own masked decodes on the card, packed against serial wall time,
    the server's ``--max_batch 4`` against ``--max_batch 1`` on the serving
    mix, the row-billing timings and peak memory."""
    import torch

    from tts_tpu_torch.ops.decode_attention import decode_attention
    from tts_tpu_torch.utils.packing import ROW_PAD_MULTIPLE, plan_pack_layout
    from tts_tpu_torch.utils.synthesis import _frame_budget, synthesis
    from tts_tpu_torch.utils.synthesizer import Synthesizer, split_into_sentences

    cuda = torch.device(device).type == "cuda"
    config = config or vits_recipe_config()
    decode_attention.launches = 0  # K1 is not on this path: the count must stay 0
    if cuda:
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
    request = vits_request()
    sens = split_into_sentences(request)
    with tempfile.TemporaryDirectory() as d:
        save_model_dir(config, d)
        synth = Synthesizer(model_dir=d, device=device)
        model = synth.tts_model
        cpu_synth = Synthesizer(model_dir=d, device="cpu")

        # card against CPU, one three-sentence request on host noise
        got, err, got_y, plans = card_against_cpu(synth, cpu_synth, request)
        del cpu_synth
        if len(sens) != 3 or len(plans) != 2 or len(got_y) != 1:
            raise AssertionError(f"packed request: {len(sens)} sentences, {len(plans)} plans, "
                                 f"y_lengths {got_y}")
        a = plans[0]
        tokens = [len(model.tokenizer.text_to_ids(sen)) for sen in sens]
        log(f"VITS packed request ({len(sens)} sentences of {tokens} tokens, one decode): "
            f"card vs CPU on host "
            f"noise: plans equal ({a.n_rows} x {a.row_len} grid, utilization "
            f"{a.utilization:.3f}, row_pad_multiple {ROW_PAD_MULTIPLE}), y_lengths {got_y[0]} "
            f"equal, waveform max abs diff {err:.3g} (tol {VITS_WAV_TOL}); "
            f"{len(got) / 22050:.2f} s of audio")

        # on the card: packed segments (batch noise layout) vs their own masked decodes
        x, x_lengths = padded_ids(model, sens, len(sens))
        budget = _frame_budget(x.shape[1])
        lens = model.infer_durations(x, x_lengths).cpu().numpy()
        plan = plan_pack_layout(lens)
        grid = model.inference_packed(x, x_lengths, plan.seg_sample, plan.seg_pos,
                                      noise_frames=budget, noise_layout="batch")["model_outputs"]
        hop = model.hop_length
        grid = grid[..., 0].cpu().numpy()
        worst = 0.0
        for (row, start, n), ref in zip(plan.slices, masked_decodes(model, x, x_lengths, budget)):
            seg = grid[row, start * hop : (start + n) * hop]
            if seg.shape != ref.shape:
                raise AssertionError(f"packed segment {seg.shape} vs masked decode {ref.shape}")
            worst = max(worst, float(np.abs(seg - ref).max()))
        if not worst <= VITS_MASKED_TOL:
            raise AssertionError(f"packed vs masked decodes: max abs diff {worst}")
        log(f"VITS packed (batch noise layout) vs each sentence's own masked decode, on the "
            f"card: lengths {lens.tolist()}, max abs diff {worst:.3g} (tol {VITS_MASKED_TOL})")

        # packed against the serial loop: the request's sentences to waveforms
        def packed():
            return synth._tts_sentences_packed(sens)

        def serial():
            return [synthesis(model, sen)["wav"] for sen in sens]

        audio_s = sum(len(w) for w in packed()) / 22050
        times = {"packed": [], "serial": []}
        for name in ("packed", "serial", "serial", "packed", "packed", "serial"):
            times[name].append(median_ms(packed if name == "packed" else serial, device)[0])
        for name, runs in times.items():
            log(f"VITS {name} three-sentence request: {audio_s:.2f} s of audio, {sorted(runs)[1]:.1f} "
                f"ms (median of 3 medians of 5; {min(runs):.1f}-{max(runs):.1f}) | {card}")
        if cuda:
            profile_call(packed, "VITS three-sentence request, packed (one decode)", card)
            profile_call(serial, "VITS three-sentence request, serial loop (three decodes)", card)

        # row billing: by eights (the JAX package's) against by ones
        short, medium = VITS_SENTENCES["short"], VITS_SENTENCES["medium"]
        long_a, long_b = split_into_sentences(VITS_SENTENCES["long"])
        mix = [short] * 2 + [medium] * 4 + [long_a, long_b] * 2
        billing = {"request": time_row_billing(model, "the three-sentence request", sens, 3,
                                               card, device),
                   "batch of 4": time_row_billing(model, "a batch of 4", [short, medium, long_a,
                                                                          long_b], 4, card, device),
                   "mix": time_row_billing(model, "the serving mix as one batch", mix, 16,
                                           card, device)}
        log("VITS row billing: faster by "
            + ", ".join(f"{k}: {'ones' if v[1] < v[8] else 'eights'} ({v[8]:.2f} vs {v[1]:.2f} ms)"
                        for k, v in billing.items())
            + f"; the port bills by {ROW_PAD_MULTIPLE} | {card}")

        # the server: --max_batch 1 and 4 on the serving mix, in turns 1, 4, 4, 1
        served = {1: [], 4: []}
        for max_batch in (1, 4, 4, 1):
            served[max_batch].append(serve_mix(d, max_batch, device))
        for max_batch, runs in served.items():
            rates = [r["audio_s"] / r["wall_s"] for r in runs]
            line = (f"VITS serving mix ({sum(c for _, c in VITS_MIX)} concurrent /api/tts: "
                    + ", ".join(f"{c} {k}" for k, c in VITS_MIX) + f"), --max_batch {max_batch}: "
                    + "; ".join(f"{r['audio_s']:.2f} s of audio in {r['wall_s']:.3f} s" for r in runs)
                    + f", {' and '.join(f'{v:.1f}' for v in rates)} audio s per wall s")
            if max_batch > 1:
                line += (f"; batch sizes formed {[r['sizes'] for r in runs]}; plan utilization "
                         + str([[round(p.utilization, 3) for p in r["plans"]] for r in runs]))
            log(line + f" | {card}")
        for r in served[4]:
            if sum(r["sizes"]) != sum(len(split_into_sentences(VITS_SENTENCES[k])) * c
                                      for k, c in VITS_MIX):
                raise AssertionError(f"--max_batch 4: batch sizes {r['sizes']}")
    if decode_attention.launches:
        raise AssertionError(f"decode_attention launched {decode_attention.launches} times "
                             f"during the batched VITS phase")
    log("VITS batched: no hand-written kernel on this path (decode_attention launches 0)")
    if cuda:
        peak = torch.cuda.max_memory_allocated()
        log(f"VITS batched peak device memory {peak / 1e9:.3f} GB allocated, "
            f"{(peak - resident) / 1e9:.3f} GB above the {resident / 1e9:.3f} GB resident before "
            f"the phase | {card}")


# ---------------------------------------------------------------------------
# VCTK's speakers as the recipe counts them: 109 names in VCTK's style (the
# corpus, and so its own list, is not in the repository)
VCTK_SPEAKERS = [f"p{n}" for n in range(225, 334)]
# the M-AILABS folders the multilingual recipe reads its languages from
# (``os.path.basename(path).split("_")[0]``); its speakers come from the
# data, which the repository lacks: ten stand-in names
MAILABS_FOLDERS = ("de_DE", "en_UK", "en_US", "es_ES", "fr_FR", "it_IT", "pl_PL", "ru_RU",
                   "uk_UK")
MAILABS_SPEAKERS = [f"speaker_{n}" for n in range(10)]
MULTI_SENTENCES = {
    "de": "Die Brücke über den Fluss wurde vor hundert Jahren gebaut.",
    "en": "The bridge over the river was built a hundred years ago.",
    "es": "El puente sobre el río fue construido hace cien años.",
    "fr": "Le pont sur la rivière a été construit il y a cent ans.",
    "it": "Il ponte sul fiume fu costruito cento anni fa.",
    "pl": "Most na rzece zbudowano sto lat temu.",
    "ru": "Мост через реку построили сто лет назад.",
    "uk": "Міст через річку збудували сто років тому.",
}
MIX_SPEAKERS = ("p225", "p243", "p270", "p301")  # the serving mix, in turn


def write_json(path: str, obj) -> str:
    with open(path, "w") as f:
        json.dump(obj, f)
    return path


def vctk_recipe_config(speakers_file: str):
    """``recipes/vctk/vits/train_vits.py:23-37``'s inference fields at the
    ``VitsArgs`` defaults: ``english_cleaners``, phonemes for
    ``phoneme_language="en"`` (the rule G2P ``en_g2p``), blanks, 22.05 kHz;
    ``use_speaker_embedding`` set on ``model_args``, as the recipe sets it
    (ROADMAP.md F11), with 256 speaker channels and the duration predictor
    conditioned on the speaker (both defaults); the speakers from
    ``speakers_file``. ``num_chars`` is left to the tokenizer."""
    from tts_tpu_torch.models.vits import VitsConfig

    config = VitsConfig(text_cleaner="english_cleaners", use_phonemes=True, phoneme_language="en")
    a = config.model_args
    a.num_chars = None
    a.use_speaker_embedding = True
    a.speakers_file = speakers_file
    return config


def multilingual_recipe_config(d: str):
    """``recipes/multilingual/vits_tts/train_vits_tts_phonemes.py:30-54``:
    16 kHz, ``multilingual_cleaners``, the ``multi_phonemizer``, language
    embeddings of 4 channels, speaker embeddings, the deterministic duration
    predictor; the languages of its M-AILABS folders in a
    ``language_ids.json``, all of them in the embedding, and datasets (which
    pick the phonemizers) for the languages a phonemizer on this machine
    serves. Returns ``(config, served languages)``."""
    from tts_tpu_torch.config.shared import BaseDatasetConfig
    from tts_tpu_torch.models.vits import VitsConfig
    from tts_tpu_torch.text.phonemizers import DEF_LANG_TO_PHONEMIZER

    codes = sorted({folder.split("_")[0] for folder in MAILABS_FOLDERS})
    served = [c for c in codes if c in DEF_LANG_TO_PHONEMIZER]
    datasets = [BaseDatasetConfig(formatter="mailabs", dataset_name="mailabs",
                                  path=os.path.join(d, folder), language=folder.split("_")[0])
                for folder in MAILABS_FOLDERS if folder.split("_")[0] in served]
    config = VitsConfig(text_cleaner="multilingual_cleaners", use_phonemes=True,
                        phoneme_language=None, phonemizer="multi_phonemizer", datasets=datasets)
    config.audio.sample_rate = 16000
    a = config.model_args
    a.num_chars = None
    a.use_language_embedding = True
    a.embedded_language_dim = 4
    a.use_speaker_embedding = True
    a.use_sdp = False
    a.speakers_file = write_json(os.path.join(d, "speakers.json"),
                                 {n: i for i, n in enumerate(MAILABS_SPEAKERS)})
    a.language_ids_file = write_json(os.path.join(d, "language_ids.json"),
                                     {c: i for i, c in enumerate(codes)})
    return config, served


def batched_turn(synth, requests) -> list:
    """One ``DynamicBatcher`` dispatch of ``requests`` ``(text, speaker,
    language)``, each resolved and tokenized as the batcher's ``tts`` does:
    the items, with their waveforms."""
    from tts_tpu_torch.server.batching import DynamicBatcher, _Pending

    batcher = DynamicBatcher(synth, max_batch=len(requests))
    try:
        items = []
        for text, speaker, language in requests:
            speaker_id, _ = synth._resolve_speaker(speaker)
            language_id = synth._resolve_language(language)
            ids = synth.tts_model.tokenizer.text_to_ids(text, synth._language_name(language_id))
            items.append(_Pending(np.asarray(ids, np.int64), speaker_id, language_id))
        batcher._dispatch(items)
    finally:
        batcher.close()
    return items


def phase_multispeaker(card: str, single_ms: dict = None, device="cuda", cut=None) -> None:
    """Multi-speaker and multi-language VITS at the recipes' full widths on
    the card: VCTK (109 speakers) card against CPU for two speakers on one
    sentence and one packed request; a packed grid of four speakers against
    their own masked decodes; ``/api/tts`` with speakers, ``/details`` and
    the ``tts`` command line's speaker flags; the serving mix over four
    speakers, ``--max_batch 4`` against 1; the latency, busy share and peak
    memory of a medium sentence; then the multilingual recipe card against
    CPU for each language served, with one batched turn of mixed languages
    and speakers; and d-vectors, card against CPU. ``cut`` shrinks each
    config in place, for rehearsals on the CPU."""
    import io

    import scipy.io.wavfile
    import torch

    from tts_tpu_torch.api import TTS
    from tts_tpu_torch.bin.synthesize import main as synthesize_cli
    from tts_tpu_torch.ops.decode_attention import decode_attention
    from tts_tpu_torch.server.server import build_parser, close_server, server_from_args
    from tts_tpu_torch.utils.managers import save_file
    from tts_tpu_torch.utils.packing import plan_pack_layout
    from tts_tpu_torch.utils.synthesis import _frame_budget, aux_input, synthesis
    from tts_tpu_torch.utils.synthesizer import SENTENCE_GAP, Synthesizer, split_into_sentences

    t_phase = time.time()
    cuda = torch.device(device).type == "cuda"
    cut = cut or (lambda config: config)
    decode_attention.launches = 0  # K1 is not on this path: the count must stay 0
    if cuda:
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
    medium = VITS_SENTENCES["medium"]
    request = vits_request()
    with tempfile.TemporaryDirectory() as d:
        speakers_file = write_json(os.path.join(d, "speakers.json"),
                                   {n: i for i, n in enumerate(VCTK_SPEAKERS)})
        save_model_dir(cut(vctk_recipe_config(speakers_file)), d)
        synth = Synthesizer(model_dir=d, device=device)
        cpu_synth = Synthesizer(model_dir=d, device="cpu")
        model = synth.tts_model
        a = model.args
        log(f"VITS VCTK recipe: {model.speaker_manager.num_speakers} speakers (speakers_file "
            f"on model_args), emb_g {tuple(model.module.emb_g.weight.shape)}, duration predictor "
            f"conditioned {a.condition_dp_on_speaker}; hidden {a.hidden_channels}, "
            f"{sum(p.numel() for p in model.module.parameters()) / 1e6:.2f} M parameters "
            f"(random, seed 0), phonemizer {model.tokenizer.phonemizer.name()}")

        # card against CPU: two speakers, one sentence and one packed request each
        worst, lines, wavs = 0.0, [], {}
        for speaker in ("p225", "p226"):
            for what, text in (("one sentence", medium), ("3-sentence request", request)):
                wav, err, y, plans = card_against_cpu(synth, cpu_synth, text, speaker_name=speaker)
                worst = max(worst, err)
                wavs[(speaker, what)] = wav
                lines.append(f"{speaker} {what}: y_lengths {y}"
                             + (f", plan {plans[0].n_rows} x {plans[0].row_len}" if plans else ""))
        del cpu_synth
        for what in ("one sentence", "3-sentence request"):
            x, y = wavs[("p225", what)], wavs[("p226", what)]
            n = min(len(x), len(y)) - SENTENCE_GAP
            if not np.abs(x[:n] - y[:n]).max() > 1e-3:
                raise AssertionError(f"speakers p225 and p226 speak the {what} alike")
        log(f"VITS VCTK card vs CPU on host noise, plans and y_lengths equal: " + "; ".join(lines)
            + f"; waveform max abs diff {worst:.3g} (tol {VITS_WAV_TOL}); p225 and p226 differ")

        # one packed grid, four sentences of four speakers, against their own decodes
        short, (long_a, long_b) = VITS_SENTENCES["short"], split_into_sentences(
            VITS_SENTENCES["long"])
        sens = [short, medium, long_a, long_b]
        x, x_lengths = padded_ids(model, sens, len(sens))
        ids = [model.speaker_manager.name_to_id[s] for s in MIX_SPEAKERS]
        aux = aux_input(model.device, len(sens), speaker_ids=ids)
        budget = _frame_budget(x.shape[1])
        lens = model.infer_durations(x, x_lengths, aux_input=aux).cpu().numpy()
        plan = plan_pack_layout(lens)
        grid = model.inference_packed(x, x_lengths, plan.seg_sample, plan.seg_pos,
                                      noise_frames=budget, noise_layout="batch",
                                      aux_input=aux)["model_outputs"][..., 0].cpu().numpy()
        hop, worst = model.hop_length, 0.0
        for (row, start, n), ref in zip(plan.slices, masked_decodes(model, x, x_lengths, budget,
                                                                    aux)):
            seg = grid[row, start * hop : (start + n) * hop]
            if seg.shape != ref.shape:
                raise AssertionError(f"packed segment {seg.shape} vs masked decode {ref.shape}")
            worst = max(worst, float(np.abs(seg - ref).max()))
        if not worst <= VITS_MASKED_TOL:
            raise AssertionError(f"mixed-speaker packed vs masked decodes: max abs diff {worst}")
        log(f"VITS packed grid of 4 speakers {list(MIX_SPEAKERS)} ({plan.n_rows} x "
            f"{plan.row_len}, lengths {lens.tolist()}) vs each one's own masked decode on the "
            f"card: max abs diff {worst:.3g} (tol {VITS_MASKED_TOL})")

        # HTTP: speakers through /api/tts, an unknown one refused, /details
        srv = server_from_args(build_parser().parse_args(
            ["--model_path", d, "--port", "0", "--device", str(device)]))
        thread = threading.Thread(target=srv.serve_forever, daemon=True)
        thread.start()
        base = f"http://127.0.0.1:{srv.server_address[1]}"
        try:
            spoken = _http(f"{base}/api/tts?text={urllib.parse.quote(medium)}&speaker_id=p226")
            unknown = _http(f"{base}/api/tts?text=hello&speaker_id=p999")
            details = json.loads(_http(f"{base}/details")[2])
        finally:
            close_server(srv)
            thread.join(timeout=60)
        if spoken[:2] != (200, "audio/wav") or unknown[0] != 400 or \
                b"not in the available speakers" not in unknown[2]:
            raise AssertionError(f"/api/tts with speakers: HTTP {spoken[0]}, unknown speaker "
                                 f"HTTP {unknown[0]} {unknown[2][:80]!r}")
        if details["speakers"] != VCTK_SPEAKERS:
            raise AssertionError(f"/details: {len(details['speakers'])} speakers")
        pcm = scipy.io.wavfile.read(io.BytesIO(spoken[2]))[1]
        log(f"VITS VCTK server: /api/tts?speaker_id=p226 {len(pcm)} samples; unknown speaker "
            f"HTTP 400; /details lists {len(details['speakers'])} speakers")

        # the tts command line: --list_speaker_idxs, then a file per --speaker_idx
        listed = io.StringIO()
        with contextlib.redirect_stdout(listed):
            synthesize_cli(["--model_path", d, "--list_speaker_idxs", "--device", str(device)])
        if str(VCTK_SPEAKERS) not in listed.getvalue():
            raise AssertionError("tts --list_speaker_idxs does not list the 109 speakers")
        cli_path, api_path = os.path.join(d, "cli.wav"), os.path.join(d, "api.wav")
        synthesize_cli(["--text", medium, "--model_path", d, "--speaker_idx", "p226",
                        "--out_path", cli_path, "--device", str(device)])
        TTS(model_path=d, device=device).tts_to_file(medium, speaker="p226", file_path=api_path)
        (sr, cli_pcm), (_, api_pcm) = (scipy.io.wavfile.read(p) for p in (cli_path, api_path))
        step = (np.abs(cli_pcm.astype(np.int32) - api_pcm.astype(np.int32)).max()
                if cli_pcm.shape == api_pcm.shape else None)
        if step is None or step > 1:
            raise AssertionError(f"tts --speaker_idx {cli_pcm.shape} vs TTS.tts_to_file "
                                 f"{api_pcm.shape}: {step} int16 steps")
        log(f"VITS VCTK tts command line: --list_speaker_idxs lists 109; --speaker_idx p226 "
            f"{len(cli_pcm)} samples at {sr} Hz, at most {step} int16 step from "
            f"TTS.tts_to_file's")

        # the serving mix over four speakers: --max_batch 1 and 4, in turns 1, 4, 4, 1
        served = {1: [], 4: []}
        for max_batch in (1, 4, 4, 1):
            served[max_batch].append(serve_mix(d, max_batch, device, MIX_SPEAKERS))
        for max_batch, runs in served.items():
            rates = [r["audio_s"] / r["wall_s"] for r in runs]
            line = (f"VITS VCTK serving mix over speakers {list(MIX_SPEAKERS)}, --max_batch "
                    f"{max_batch}: " + "; ".join(f"{r['audio_s']:.2f} s of audio in "
                                                 f"{r['wall_s']:.3f} s" for r in runs)
                    + f", {' and '.join(f'{v:.1f}' for v in rates)} audio s per wall s")
            if max_batch > 1:
                line += f"; batch sizes formed {[r['sizes'] for r in runs]}"
            log(line + f" | {card}")
        n_sentences = sum(len(split_into_sentences(VITS_SENTENCES[k])) * c for k, c in VITS_MIX)
        for r in served[4]:
            if sum(r["sizes"]) != n_sentences or max(r["sizes"]) < 2:
                raise AssertionError(f"--max_batch 4 with speakers: batch sizes {r['sizes']}")

        # the medium sentence of one speaker: latency, busy share
        synthesis(model, medium, speaker_id=1)
        ms, lo, hi = median_ms(lambda: synthesis(model, medium, speaker_id=1), device)
        single = f"; phase 6's single-speaker medium sentence {single_ms['medium']:.1f} ms" \
            if single_ms else ""
        log(f"VITS VCTK medium sentence, speaker p226: {ms:.1f} ms (median of 5; "
            f"{lo:.1f}-{hi:.1f}){single} | {card}")
        if cuda:
            profile_call(lambda: synthesis(model, medium, speaker_id=1),
                         "VITS VCTK, one medium sentence of one speaker", card)
        del synth, model

    with tempfile.TemporaryDirectory() as d:
        config, served_languages = multilingual_recipe_config(d)
        save_model_dir(cut(config), d)
        synth = Synthesizer(model_dir=d, device=device)
        cpu_synth = Synthesizer(model_dir=d, device="cpu")
        model = synth.tts_model
        log(f"VITS multilingual recipe: languages {model.language_manager.language_names} "
            f"(emb_l {tuple(model.module.emb_l.weight.shape)}), served by this machine's "
            f"phonemizers {served_languages}; {model.speaker_manager.num_speakers} speakers; "
            f"{model.config.audio.sample_rate} Hz, duration predictor "
            f"{type(model.module.duration_predictor).__name__}")
        worst, lengths = 0.0, {}
        for n, language in enumerate(served_languages):
            speaker = MAILABS_SPEAKERS[n % len(MAILABS_SPEAKERS)]
            _, err, y, _ = card_against_cpu(synth, cpu_synth, MULTI_SENTENCES[language],
                                            speaker_name=speaker, language_name=language)
            worst = max(worst, err)
            lengths[language] = y[0]
        requests = [(MULTI_SENTENCES[lang], MAILABS_SPEAKERS[n], lang)
                    for n, lang in enumerate(served_languages)]
        with host_noise(seed=0):
            got, want = batched_turn(synth, requests), batched_turn(cpu_synth, requests)
        turn = max(float(np.abs(g.wav - w.wav).max()) if g.wav.shape == w.wav.shape
                   else float("inf") for g, w in zip(got, want))
        if not turn <= VITS_WAV_TOL or any(g.wav.std() == 0 for g in got):
            raise AssertionError(f"multilingual batched turn card vs CPU: max abs diff {turn}")
        del cpu_synth, synth, model
        log(f"VITS multilingual card vs CPU on host noise, one sentence per language "
            f"{served_languages}: waveform max abs diff {worst:.3g}; one batched turn of "
            f"{len(requests)} sentences in {len(requests)} languages and speakers: max abs diff "
            f"{turn:.3g} (tol {VITS_WAV_TOL})")

    with tempfile.TemporaryDirectory() as d:
        rs = np.random.RandomState(0)
        clips = {f"{s}_{n}.wav": {"name": s, "embedding": rs.randn(512).tolist()}
                 for s in VCTK_SPEAKERS[:8] for n in range(2)}
        save_file(clips, os.path.join(d, "d_vectors.npz"))
        config = vctk_recipe_config(None)
        a = config.model_args
        a.use_speaker_embedding, a.use_d_vector_file, a.d_vector_dim = False, True, 512
        a.d_vector_file = os.path.join(d, "d_vectors.npz")
        save_model_dir(cut(config), d)
        synth = Synthesizer(model_dir=d, device=device)
        cpu_synth = Synthesizer(model_dir=d, device="cpu")
        worst = 0.0
        for text in (medium, request):
            worst = max(worst, card_against_cpu(synth, cpu_synth, text, speaker_name="p226")[1])
        log(f"VITS d-vectors (512 wide, 8 speakers of 2 clips, VCTK widths) card vs CPU on host "
            f"noise, one sentence and one packed request: max abs diff {worst:.3g} "
            f"(tol {VITS_WAV_TOL})")
        del cpu_synth, synth

    if decode_attention.launches:
        raise AssertionError(f"decode_attention launched {decode_attention.launches} times "
                             f"during the multi-speaker phase")
    log(f"VITS multi-speaker: no hand-written kernel on this path (decode_attention launches "
        f"0); phase 8 took {time.time() - t_phase:.1f} s")
    if cuda:
        peak = torch.cuda.max_memory_allocated()
        log(f"VITS multi-speaker peak device memory {peak / 1e9:.3f} GB allocated, "
            f"{(peak - resident) / 1e9:.3f} GB above the {resident / 1e9:.3f} GB resident "
            f"before the phase | {card}")


# ---------------------------------------------------------------------------
ZOO_VCTK = "tts_models/en/vctk/vits"
GROUP_FIT_ROWS = (2, 4, 8)
GROUP_FIT_FRAMES = (512, 1024, 2048)


def mb_istft_config():
    """Phase 6's LJSpeech recipe with the MB-iSTFT-VITS decoder as published
    (arXiv:2210.15975, its ``ljs_mb_istft_vits`` config): a HiFiGAN trunk of
    [4, 4] with kernels [16, 16] from 512 channels, then a 16-point iSTFT at
    hop 4 in each of 4 PQMF bands: 4 x 4 x 4 x 4 = the hop of 256."""
    config = vits_recipe_config()
    a = config.model_args
    a.decoder_type = "istft"
    a.upsample_rates_decoder = [4, 4]
    a.upsample_kernel_sizes_decoder = [16, 16]
    a.istft_n_fft_decoder, a.istft_hop_decoder, a.istft_subbands_decoder = 16, 4, 4
    return config


def encoder_rate_config():
    """Phase 6's LJSpeech recipe at a 44.1 kHz output, its text encoder,
    durations, posterior encoder and flow at 22.05 kHz (the reference's
    ``VitsArgs.encoder_sample_rate``), the latent upsampled twice
    (``interpolate_z``) into the default HiFiGAN (hop 256). No published
    checkpoint fixes the pair: the factor of 2 is the JAX package's own
    test's (``tests/test_vits_upsampling.py``), here at full width."""
    config = vits_recipe_config()
    config.audio.sample_rate = 44100
    config.model_args.encoder_sample_rate = 22050
    config.model_args.interpolate_z = True
    return config


@contextlib.contextmanager
def offline_zoo(home: str):
    """``TTS_HOME`` at ``home`` and ``TTS_TPU_MODELS_FILE`` at a copy of the
    port's catalog there; any fetch raises."""
    import shutil
    import urllib.request as request

    from tts_tpu_torch.utils import manage

    models_file = os.path.join(home, "models.json")
    shutil.copy(manage._DEFAULT_MODELS_FILE, models_file)
    saved = {k: os.environ.get(k) for k in ("TTS_HOME", "TTS_TPU_MODELS_FILE")}
    real = request.urlretrieve

    def no_fetch(url, *args, **kwargs):
        raise AssertionError(f"the zoo phase tried to fetch {url}")

    os.environ.update(TTS_HOME=home, TTS_TPU_MODELS_FILE=models_file)
    request.urlretrieve = no_fetch
    try:
        yield
    finally:
        request.urlretrieve = real
        for key, value in saved.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value


@contextlib.contextmanager
def recorded_groups(plans=None):
    """Every group plan the batcher's grouped dispatch makes inside: the
    sizes and buckets of each (and, into ``plans``, the predicted lengths
    and the plan)."""
    from tts_tpu_torch.server import batching

    groups = []
    real = batching.plan_decode_groups

    def recording(y_preds, *args, **kwargs):
        plan = real(y_preds, *args, **kwargs)
        groups.append([(len(idx), frames) for idx, frames in plan])
        if plans is not None:
            plans.append((list(y_preds), plan))
        return plan

    batching.plan_decode_groups = recording
    try:
        yield groups
    finally:
        batching.plan_decode_groups = real


def planned_against_decoded(plan_record, decoded) -> str:
    """The lengths the grouped dispatch planned against those its groups'
    decodes drew, and how many were cut at their group's bucket."""
    y_preds, plan = plan_record
    planned = [int(y_preds[i]) for idx, _ in plan for i in idx]
    lengths = [n for (idx, _), ys in zip(plan, decoded) for n in ys[: len(idx)]]
    cut_at = sum(n == frames for (idx, frames), ys in zip(plan, decoded) for n in ys[: len(idx)])
    return f"planned lengths {planned}, decoded {lengths} ({cut_at} cut at their bucket)"


def fit_group_overhead(model, device) -> dict:
    """``plan_decode_groups``' ``overhead``, in frame·row units: one decode
    dispatch's fixed floor (``inference`` of one row at 32 frames, median of
    5) over its marginal cost per latent frame of one row (the least-squares
    slope of ``inference`` timed at ``GROUP_FIT_ROWS`` x ``GROUP_FIT_FRAMES``,
    median of 3 each, sizes at which the device's work outlasts the host's
    dispatch). Each row holds the medium sentence."""
    rows_max = max(GROUP_FIT_ROWS)
    x, x_lengths = padded_ids(model, [VITS_SENTENCES["medium"]] * rows_max, rows_max)

    def timed(rows, frames, reps):
        def call():
            model.inference(x[:rows], x_lengths[:rows], max_frames=frames)
        call()
        return median_ms(call, device, reps=reps)[0]

    floor = timed(1, 32, 5)
    points = [(rows * frames, timed(rows, frames, 3))
              for rows in GROUP_FIT_ROWS for frames in GROUP_FIT_FRAMES]
    units = np.array([u for u, _ in points], np.float64)
    ms = np.array([t for _, t in points], np.float64)
    (intercept, slope), *_ = np.linalg.lstsq(np.stack([np.ones_like(units), units], 1), ms,
                                             rcond=None)
    resid = ms - (intercept + slope * units)
    return {"floor_ms": floor, "slope_ms": float(slope), "intercept_ms": float(intercept),
            "overhead": float(floor / slope), "points": points,
            "max_resid_ms": float(np.abs(resid).max())}


def phase_zoo_and_variants(card: str, device="cuda", cut=None) -> None:
    """The zoo, voice conversion and the iSTFT and encoder-rate variants at
    full width: (a) the VCTK recipe (phase 8) saved as a zoo directory in
    the reference layout under a temporary ``TTS_HOME``, loaded by name
    through ``TTS`` and ``tts --model_name`` against the same files loaded
    by path; (b) a wav the port speaks as p225 converted to p226, card
    against CPU on host noise; (c) the MB-iSTFT-VITS decoder and an
    encoder-rate model, card against CPU on three sentences, the medium
    sentence's latency and RTF, and the grouped dispatch's overhead fitted
    on the iSTFT model; (d) the iSTFT model behind the batcher: one grouped
    turn card against CPU, and the serving mix with ``--max_batch 1`` and 4
    with the groups formed. ``cut`` shrinks each config in place, for
    rehearsals on the CPU."""
    import scipy.io.wavfile
    import torch

    from tts_tpu_torch.api import TTS
    from tts_tpu_torch.audio.numpy_transforms import load_wav
    from tts_tpu_torch.audio.torch_transforms import wav_to_spec
    from tts_tpu_torch.bin.synthesize import main as synthesize_cli
    from tts_tpu_torch.models.vits import Vits
    from tts_tpu_torch.ops.decode_attention import decode_attention
    from tts_tpu_torch.server import batching
    from tts_tpu_torch.utils.convert import reference_vits_state
    from tts_tpu_torch.utils.synthesis import DECODE_GROUP_OVERHEAD, synthesis
    from tts_tpu_torch.utils.synthesizer import Synthesizer, split_into_sentences

    t_phase = time.time()
    cuda = torch.device(device).type == "cuda"
    cut = cut or (lambda config: config)
    decode_attention.launches = 0  # K1 is not on this path: the count must stay 0
    if cuda:
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
    medium = VITS_SENTENCES["medium"]

    # (a) the zoo: the VCTK recipe as a zoo directory, by name against by path
    with tempfile.TemporaryDirectory() as home, offline_zoo(home):
        d = os.path.join(home, "tts_tpu", ZOO_VCTK.replace("/", "--"))
        os.makedirs(d)
        torch.save({n: i for i, n in enumerate(VCTK_SPEAKERS)}, os.path.join(d, "speakers.pth"))
        model = Vits.init_from_config(cut(vctk_recipe_config(os.path.join(d, "speakers.pth")))
                                      ).init_params(seed=0, device="cpu")
        saved = model.config.to_dict()
        saved["model_args"]["speakers_file"] = "/published/vctk/speakers.pth"
        write_json(os.path.join(d, "config.json"), saved)
        weights = os.path.join(d, "model_file.pth")
        torch.save({"model": {k: torch.from_numpy(v) for k, v in
                              reference_vits_state(model.module.state_dict()).items()}}, weights)
        del model
        t0 = time.time()
        by_name = TTS(model_name=ZOO_VCTK, device=device)
        load_s = time.time() - t0
        config_path = os.path.join(d, "config.json")
        by_path = TTS(model_path=weights, config_path=config_path, device=device)
        if by_name.speakers != VCTK_SPEAKERS:
            raise AssertionError(f"zoo load: {len(by_name.speakers)} speakers")
        a = np.asarray(by_name.tts(medium, speaker="p226"), np.float32)
        b = np.asarray(by_path.tts(medium, speaker="p226"), np.float32)
        err = float(np.abs(a - b).max()) if a.shape == b.shape else float("inf")
        if not err <= VITS_WAV_TOL or a.std() == 0:
            raise AssertionError(f"TTS(model_name) vs path load: {a.shape} vs {b.shape}, {err}")
        del by_name
        cli_path, api_path = os.path.join(home, "cli.wav"), os.path.join(home, "api.wav")
        synthesize_cli(["--text", medium, "--model_name", ZOO_VCTK, "--speaker_idx", "p226",
                        "--out_path", cli_path, "--device", str(device)])
        by_path.tts_to_file(medium, speaker="p226", file_path=api_path)
        (sr, cli_pcm), (_, api_pcm) = (scipy.io.wavfile.read(p) for p in (cli_path, api_path))
        step = (np.abs(cli_pcm.astype(np.int32) - api_pcm.astype(np.int32)).max()
                if cli_pcm.shape == api_pcm.shape else None)
        if step is None or step > 1:
            raise AssertionError(f"tts --model_name {cli_pcm.shape} vs path load "
                                 f"{api_pcm.shape}: {step} int16 steps")
        log(f"zoo: {ZOO_VCTK} from a TTS_HOME holding model_file.pth (reference layout), "
            f"config.json (speakers path rewritten) and speakers.pth ({len(VCTK_SPEAKERS)} "
            f"speakers), nothing fetched; TTS(model_name) loaded in {load_s:.1f} s and speaks "
            f"the path-loaded model's medium sentence (p226) within {err:.3g}; tts --model_name "
            f"{len(cli_pcm)} samples at {sr} Hz, at most {step} int16 step from the path load")

        # (b) voice conversion: the port's own p225 recording into p226's voice
        ref_wav = os.path.join(home, "p225.wav")
        by_path.tts_to_file(medium, speaker="p225", file_path=ref_wav)
        synth = by_path.synthesizer
        cpu_synth = Synthesizer(tts_checkpoint=weights, tts_config_path=config_path,
                                device="cpu")

        def convert(s):
            return np.asarray(s.tts(reference_wav=ref_wav, speaker_name="p226",
                                    reference_speaker_name="p225"), np.float32)

        with host_noise(seed=0):
            got, want = convert(synth), convert(cpu_synth)
        err = float(np.abs(got - want).max()) if got.shape == want.shape else float("inf")
        if not err <= VITS_WAV_TOL or not np.isfinite(got).all() or got.std() == 0:
            raise AssertionError(f"voice conversion card vs CPU: {got.shape} vs {want.shape}, "
                                 f"max abs diff {err}")
        ms, lo, hi = median_ms(lambda: convert(synth), device)
        seconds = len(got) / 22050
        # the sizes the posterior meets: the spectrogram, its log-scale, its sample
        audio = synth.tts_config.audio
        wav = torch.from_numpy(load_wav(filename=ref_wav, sample_rate=22050)[None]).to(device)
        spec = wav_to_spec(wav, audio.fft_size, audio.hop_length, audio.win_length)
        with host_noise(seed=0):
            z, _, logs, _ = synth.tts_model.module.posterior_encoder(
                spec.transpose(1, 2), torch.tensor([spec.shape[2]], device=device),
                torch.Generator(device=device), g=synth.tts_model.module.emb_g(
                    torch.tensor([0], device=device)))
        sizes = (f"max |spectrogram| {float(spec.abs().max()):.1f}, max log-scale "
                 f"{float(logs.max()):.2f}, max |z| {float(z.abs().max()):.1f}")
        log(f"voice conversion p225 -> p226 of the port's own {seconds:.2f} s recording, card "
            f"vs CPU on host noise: {len(got)} samples each, max abs diff {err:.3g} (tol "
            f"{VITS_WAV_TOL}); {ms:.1f} ms on {device} (median of 5; {lo:.1f}-{hi:.1f}), RTF "
            f"{seconds / ms * 1e3:.1f}; posterior of random weights: {sizes} | {card}")
        del cpu_synth, synth, by_path

    # (c) the variants, card against CPU, latency, and the grouped dispatch's overhead
    fit = None
    for name, config in (("MB-iSTFT", mb_istft_config()), ("encoder rate", encoder_rate_config())):
        config = cut(config)
        model = Vits.init_from_config(config).init_params(seed=0, device=device)
        cpu_model = Vits.init_from_config(config).init_params(seed=0, device="cpu")
        a, sr = model.args, model.config.audio.sample_rate
        worst, lengths = 0.0, []
        with host_noise(seed=0):
            for text in VITS_SENTENCES.values():
                g, w = synthesis(model, text), synthesis(cpu_model, text)
                g_len, w_len = g["outputs"]["y_lengths"].cpu(), w["outputs"]["y_lengths"]
                if not torch.equal(g_len, w_len) or g["wav"].shape != w["wav"].shape:
                    raise AssertionError(f"{name}: y_lengths card {g_len.tolist()} CPU "
                                         f"{w_len.tolist()}")
                err = float(np.abs(g["wav"] - w["wav"]).max())
                if not err <= VITS_WAV_TOL or not np.isfinite(g["wav"]).all():
                    raise AssertionError(f"{name} card vs CPU: max abs diff {err}")
                worst, lengths = max(worst, err), lengths + [int(g_len[0])]
        del cpu_model
        synthesis(model, medium)
        ms, lo, hi = median_ms(lambda: synthesis(model, medium), device)
        seconds = len(synthesis(model, medium)["wav"]) / sr
        log(f"VITS {name} ({a.decoder_type} decoder, upsampling {a.upsample_rates_decoder}"
            + (f", iSTFT n_fft {a.istft_n_fft_decoder} hop {a.istft_hop_decoder} x "
               f"{a.istft_subbands_decoder} bands" if a.decoder_type == "istft" else "")
            + f"; {sr} Hz out, encoder rate {a.encoder_sample_rate}, {model.hop_length} samples "
            f"per latent frame; {sum(p.numel() for p in model.module.parameters()) / 1e6:.2f} M "
            f"parameters, seed 0): card vs CPU on host noise, y_lengths {lengths} equal, "
            f"waveform max abs diff {worst:.3g} (tol {VITS_WAV_TOL}); medium sentence "
            f"{seconds:.2f} s of audio in {ms:.1f} ms (median of 5; {lo:.1f}-{hi:.1f}), RTF "
            f"{seconds / ms * 1e3:.1f} | {card}")
        if cuda:
            profile_call(lambda: synthesis(model, medium), f"VITS {name}, one medium sentence",
                         card)
        if a.decoder_type == "istft":
            fit = fit_group_overhead(model, device)
            log(f"grouped-dispatch overhead fit on the {name} VITS (inference of the medium "
                f"sentence): floor {fit['floor_ms']:.2f} ms per dispatch (1 row x 32 frames, "
                f"median of 5); slope {fit['slope_ms'] * 1e3:.3f} us per frame-row "
                f"(least squares over rows {list(GROUP_FIT_ROWS)} x frames "
                f"{list(GROUP_FIT_FRAMES)}, median of 3 each; intercept "
                f"{fit['intercept_ms']:.2f} ms, largest residual {fit['max_resid_ms']:.2f} ms); "
                f"overhead = floor / slope = {fit['overhead']:.0f} frame-rows "
                f"(DECODE_GROUP_OVERHEAD in the port: {DECODE_GROUP_OVERHEAD}); points "
                f"(frame-rows, ms) " + ", ".join(f"({u}, {t:.2f})" for u, t in fit["points"])
                + f" | {card}")
        del model

    # (d) the iSTFT model behind the batcher: the grouped dispatch
    with tempfile.TemporaryDirectory() as d:
        save_model_dir(cut(mb_istft_config()), d)
        synth = Synthesizer(model_dir=d, device=device)
        cpu_synth = Synthesizer(model_dir=d, device="cpu")
        long_a, long_b = split_into_sentences(VITS_SENTENCES["long"])
        requests = [(t, None, None) for t in (VITS_SENTENCES["short"], medium, long_a, long_b)]
        plans = []
        with host_noise(seed=0), recorded_groups(plans) as groups, \
                recorded_y_lengths(synth.tts_model, ("inference",)) as decoded:
            got, want = batched_turn(synth, requests), batched_turn(cpu_synth, requests)
        turn = max(float(np.abs(g.wav - w.wav).max()) if g.wav.shape == w.wav.shape
                   else float("inf") for g, w in zip(got, want))
        if not turn <= VITS_WAV_TOL or groups[0] != groups[1] or any(
                g.wav.std() == 0 for g in got):
            raise AssertionError(f"grouped turn card vs CPU: max abs diff {turn}, groups {groups}")
        log(f"VITS MB-iSTFT grouped dispatch of 4 sentences, card vs CPU on host noise: groups "
            f"(size, bucket) {groups[0]} on both, max abs diff {turn:.3g} (tol {VITS_WAV_TOL}); "
            + planned_against_decoded(plans[0], decoded))
        # two groups (a dispatch priced at 0): each group's decode redraws its durations
        # with another shape than the plan's pass (ROADMAP.md F16)
        plans, real = [], batching.plan_decode_groups
        batching.plan_decode_groups = functools.partial(real, overhead=0)
        try:
            with recorded_groups(plans), \
                    recorded_y_lengths(synth.tts_model, ("inference",)) as decoded:
                batched_turn(synth, requests)
        finally:
            batching.plan_decode_groups = real
        log(f"VITS MB-iSTFT grouped dispatch priced at overhead 0, on the card: groups "
            f"{[(len(idx), frames) for idx, frames in plans[0][1]]}; "
            + planned_against_decoded(plans[0], decoded))
        del cpu_synth, synth
        served = {1: [], 4: []}
        for max_batch in (1, 4, 4, 1):
            with recorded_groups() as groups:
                run = serve_mix(d, max_batch, device)
            run["groups"] = list(groups)
            served[max_batch].append(run)
        n_sentences = sum(len(split_into_sentences(VITS_SENTENCES[k])) * c for k, c in VITS_MIX)
        for max_batch, runs in served.items():
            rates = [r["audio_s"] / r["wall_s"] for r in runs]
            line = (f"VITS MB-iSTFT serving mix, --max_batch {max_batch}: "
                    + "; ".join(f"{r['audio_s']:.2f} s of audio in {r['wall_s']:.3f} s"
                                for r in runs)
                    + f", {' and '.join(f'{v:.1f}' for v in rates)} audio s per wall s")
            if max_batch > 1:
                line += (f"; batch sizes {[r['sizes'] for r in runs]}, groups (size, bucket) "
                         f"{[r['groups'] for r in runs]}")
                for r in runs:
                    if sum(r["sizes"]) != n_sentences or not r["groups"]:
                        raise AssertionError(f"--max_batch 4 on the iSTFT model: batch sizes "
                                             f"{r['sizes']}, groups {r['groups']}")
            log(line + f" | {card}")

    if decode_attention.launches:
        raise AssertionError(f"decode_attention launched {decode_attention.launches} times "
                             f"during the zoo and variants phase")
    log(f"zoo, voice conversion and VITS variants: no hand-written kernel on this path "
        f"(decode_attention launches 0); phase 9 took {time.time() - t_phase:.1f} s")
    if cuda:
        peak = torch.cuda.max_memory_allocated()
        log(f"phase 9 peak device memory {peak / 1e9:.3f} GB allocated, "
            f"{(peak - resident) / 1e9:.3f} GB above the {resident / 1e9:.3f} GB resident "
            f"before the phase | {card}")


# ---------------------------------------------------------------------------
ZOO_GLOW = "tts_models/en/ljspeech/glow-tts"
ZOO_MBMELGAN = "vocoder_models/en/ljspeech/multiband-melgan"
FOREIGN_STATS = "/published/ljspeech/multiband-melgan/scale_stats.npy"
GLOW_MEL_TOL = 1e-4  # card vs CPU, the GlowTTS mel, fp32 with TF32 off
GL_REL_TOL = 1e-2  # card vs CPU, Griffin-Lim's waveform, as a share of its peak
FIDELITY_RMSE, FIDELITY_LSD_DB = 5e-3, 0.5  # tests/test_fidelity_corpus.py's thresholds


def glow_recipe_config():
    """``recipes/ljspeech/glow_tts/train_glowtts.py:21-33`` as published:
    ``phoneme_cleaners``, ``en-us`` phonemes (from the rule G2P where
    ``espeak`` is absent) and the ``GlowTTSConfig`` defaults, the embedding
    sized by the phoneme set."""
    from tts_tpu_torch.models.glow_tts import GlowTTSConfig

    return GlowTTSConfig(text_cleaner="phoneme_cleaners", use_phonemes=True,
                         phoneme_language="en-us")


def mb_melgan_recipe_config():
    """``recipes/ljspeech/multiband_melgan/train_multiband_melgan.py:15-25``:
    the ``MultibandMelganConfig`` defaults (384 base channels, upsampling
    [8, 4, 2], 4 residual blocks a stage, 4 PQMF bands; 22.05 kHz, hop 256,
    80 mels)."""
    from tts_tpu_torch.vocoder.configs import MultibandMelganConfig

    return MultibandMelganConfig()


def random_vocoder(config, seed: int = 0):
    """The generator ``config`` names, on the CPU, with fp32 weights drawn
    from ``seed``: N(0, 1/fan_in) (a transposed conv's fan-in is its input
    channels times its taps per output, kernel / stride), biases 0."""
    import torch

    from tts_tpu_torch.vocoder.utils import make_generator_from_config

    gen = make_generator_from_config(config)
    draw = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in gen.named_parameters():
            owner = gen.get_submodule(name.rsplit(".", 1)[0])
            if name.endswith("bias"):
                p.zero_()
                continue
            if isinstance(owner, torch.nn.ConvTranspose1d):
                fan_in = p.shape[0] * p.shape[2] // owner.stride[0]
            else:
                fan_in = p[0].numel()
            p.copy_(torch.randn(p.shape, generator=draw) / fan_in**0.5)
    return gen.eval().requires_grad_(False)


def melgan_gflop(gen, frames: int, padded: bool = True) -> float:
    """Operations (2 per multiply-add) of a MelGAN generator's ``inference``
    on ``frames`` mel frames (with its edge padding unless ``padded`` is
    false): ``conv_pre``, each transposed
    conv (every input frame meets its ``2u`` taps), each residual block's
    dilated conv, 1x1 conv and 1x1 shortcut at the upsampled rate,
    ``conv_post``, and the PQMF synthesis filter of a multi-band one."""
    n = frames + (2 * gen.inference_padding if padded else 0)
    flops = 2 * gen.conv_pre.in_channels * gen.conv_pre.out_channels * gen.proj_kernel * n
    for i, up in enumerate(gen.ups):
        flops += 2 * up.in_channels * up.out_channels * up.kernel_size[0] * n
        n *= up.stride[0]
        stack = getattr(gen, f"res_{i}")
        c = up.out_channels
        flops += stack.num_res_blocks * 2 * c * c * (stack.kernel_size + 2) * n
    flops += 2 * gen.conv_post.in_channels * gen.conv_post.out_channels * gen.proj_kernel * n
    if hasattr(gen, "pqmf"):
        flops += 2 * gen.pqmf.N * (gen.pqmf.taps + 1) * n * gen.pqmf.N
    return flops / 1e9


def write_scale_stats(path: str, audio: dict, seed: int = 0) -> None:
    """A ``scale_stats.npy`` as the reference's statistics script writes it
    (mel and linear means and deviations in decibels, and the audio config
    they were computed with), drawn from ``seed``."""
    rs = np.random.RandomState(seed)
    n, lin = audio["num_mels"], audio["fft_size"] // 2 + 1
    np.save(path, {"mel_mean": rs.randn(n) * 5 - 40, "mel_std": rs.rand(n) * 5 + 10,
                   "linear_mean": rs.randn(lin) * 5 - 40, "linear_std": rs.rand(lin) * 5 + 10,
                   "audio_config": dict(audio)}, allow_pickle=True)


def _lsd_db(ref: np.ndarray, ours: np.ndarray) -> float:
    """``tests/test_fidelity_corpus.py``'s log-mel distance in dB (a 64-point
    STFT, 20 mels at 1.6 kHz: the fixtures' waveforms are a few hundred
    samples), through the port's numpy transforms."""
    from tts_tpu_torch.audio.numpy_transforms import build_mel_basis, stft

    def log_mel(wav):
        spec = np.abs(stft(y=wav.astype(np.float32), fft_size=64, hop_length=16, win_length=64,
                           pad_mode="reflect"))
        basis = build_mel_basis(sample_rate=1600, fft_size=64, num_mels=20)
        return 20.0 * np.log10(np.maximum(basis @ spec, 1e-5))

    a, b = log_mel(ref), log_mel(ours)
    return float(np.mean(np.sqrt(np.mean((a - b) ** 2, axis=0))))


def fidelity_replays(device) -> str:
    """``glow_tts.npz`` and ``multiband_melgan.npz`` (reference-layout state
    dicts with the reference code's outputs) through the port's converters
    on ``device``, at ``test_fidelity_corpus``'s thresholds."""
    import torch

    from tts_tpu_torch.models.glow_tts import GlowTTS, GlowTTSConfig
    from tts_tpu_torch.utils.convert import load_reference_glow_tts, load_reference_vocoder
    from tts_tpu_torch.vocoder.configs import MultibandMelganConfig
    from tts_tpu_torch.vocoder.utils import make_generator_from_config

    def fixture(name):
        npz = np.load(os.path.join(REPO, "tests", "fixtures", "fidelity", f"{name}.npz"))
        meta = json.loads(bytes(npz["meta"]).decode())
        part = {p: {k[len(p) + 1:]: npz[k] for k in npz.files if k.startswith(p + "/")}
                for p in ("sd", "in", "out")}
        return part["sd"], part["in"], part["out"], meta

    state, ins, outs, meta = fixture("glow_tts")
    config = GlowTTSConfig()
    for k, v in meta["config"].items():
        setattr(config, k, v)
    glow = GlowTTS(config)
    glow.load_state_dict({k: v.to(device) for k, v in load_reference_glow_tts(state,
                                                                               config).items()})
    ref_lens = outs["y_lengths"]
    with torch.no_grad():
        out = glow.inference(torch.from_numpy(ins["text"]).to(device),
                             torch.from_numpy(ins["text_lengths"]).to(device),
                             max_frames=int(((ref_lens.max() + 31) // 32) * 32))
    lens = out["y_lengths"].cpu().numpy()
    mel = out["model_outputs"].float().cpu().numpy()
    ours = np.concatenate([mel[b, :n] for b, n in enumerate(ref_lens)])
    ref = np.concatenate([outs["mel"][b, :n] for b, n in enumerate(ref_lens)])
    rmse = float(np.sqrt(np.mean((ours - ref) ** 2))) if ours.shape == ref.shape else np.inf
    if not np.array_equal(lens, ref_lens) or not rmse < FIDELITY_RMSE:
        raise AssertionError(f"glow_tts.npz on {device}: y_lengths {lens} vs {ref_lens}, "
                             f"mel RMSE {rmse}")

    state, ins, outs, meta = fixture("multiband_melgan")
    vconfig = MultibandMelganConfig()
    vconfig.audio.num_mels = ins["mel"].shape[1]
    vconfig.generator_model_params = {"upsample_factors": [2, 2], "base_channels": 32,
                                      "num_res_blocks": meta["num_res_blocks"]}
    gen = make_generator_from_config(vconfig)
    gen.load_state_dict(load_reference_vocoder(state, vconfig))
    gen = gen.to(device).eval()
    with torch.no_grad():
        wav = gen.inference(torch.from_numpy(ins["mel"].transpose(0, 2, 1)).to(device))
    wav = wav.float().cpu().numpy()[0, :, 0]
    lsd = _lsd_db(outs["wav"][0, 0], wav) if len(wav) == outs["wav"].shape[-1] else np.inf
    if not lsd < FIDELITY_LSD_DB:
        raise AssertionError(f"multiband_melgan.npz on {device}: {len(wav)} samples, LSD {lsd}")
    return (f"glow_tts.npz y_lengths {lens.tolist()} equal, mel RMSE {rmse:.3g} (< "
            f"{FIDELITY_RMSE}); multiband_melgan.npz LSD {lsd:.3g} dB (< {FIDELITY_LSD_DB}), max "
            f"abs diff {float(np.abs(outs['wav'][0, 0] - wav).max()):.3g}")


def glow_stage_ms(synth, text: str, device, reps: int = 5) -> dict:
    """One sentence's stages on the card, medians of ``reps``: the encoder
    with the duration predictor, the path expansion (durations, monotonic
    path, prior), the flow decoder in reverse and MB-MelGAN by CUDA events;
    the host bridge (mel to the host, denormalise, renormalise, back to the
    card) by the host clock."""
    import torch

    from tts_tpu_torch.utils.synthesis import _frame_budget

    model = synth.tts_model
    gm = model.module
    ids = model.tokenizer.text_to_ids(text)
    T = ((len(ids) + 15) // 16) * 16
    x = torch.zeros(1, T, dtype=torch.long, device=device)
    x[0, : len(ids)] = torch.tensor(ids, device=device)
    xl = torch.tensor([len(ids)], device=device)
    budget = _frame_budget(len(ids))
    runs: dict = {}
    with torch.no_grad():
        for _ in range(reps):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
            ev[0].record()
            o_mean, o_log_scale, o_dur_log, x_mask = gm.enc(x, xl)
            ev[1].record()
            e = gm.encode(x, xl, max_frames=budget)  # the path expansion, after the encoder
            ev[2].record()
            y, _, _ = gm.dec(e["y_mean"] * e["y_mask"], e["y_mask"], reverse=True)
            ev[3].record()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            frames = int(e["y_lengths"][0])
            mel = y[0, :frames].float().cpu().numpy()
            voc_in = synth.vocoder_ap.normalize(synth.ap.denormalize(mel.T))
            c = torch.from_numpy(np.ascontiguousarray(voc_in.T[None], np.float32)).to(device)
            torch.cuda.synchronize()
            bridge = (time.perf_counter() - t0) * 1e3
            v0, v1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            v0.record()
            synth.vocoder_model.inference(c)
            v1.record()
            torch.cuda.synchronize()
            encode_ms = ev[0].elapsed_time(ev[1])
            times = {"encoder + durations": encode_ms,
                     "path expansion": ev[1].elapsed_time(ev[2]) - encode_ms,
                     "flow decoder": ev[2].elapsed_time(ev[3]), "host bridge": bridge,
                     "MB-MelGAN": v0.elapsed_time(v1)}
            for k, v in times.items():
                runs.setdefault(k, []).append(v)
    return {"times": {k: sorted(v)[reps // 2] for k, v in runs.items()}, "frames": frames,
            "budget": budget, "tokens": len(ids)}


def phase_glow_tts(card: str, device="cuda", cut=None) -> None:
    """GlowTTS with Multiband-MelGAN at the LJSpeech recipes' widths (the
    ``tts`` command line's default pairing): the two fidelity fixtures
    replayed on the card; the three phase 6 sentences card against CPU
    (``y_lengths`` and mel, then the waveform through the vocoder bridge);
    latency and RTF at B=1 with a stage split, MB-MelGAN's TFLOP/s, busy
    share, kernels and peak memory; Griffin-Lim without a vocoder, card
    against CPU under one ``np.random.seed``; the pair by zoo name from
    reference-layout directories (nothing fetched; the vocoder's
    ``stats_path`` names its trainer's file, F17) against the path load;
    the ``tts`` command line's vocoder flags; and the server with
    ``--vocoder_path`` and ``--max_batch 4``, which serves serially.
    ``decode_attention`` must not launch. ``cut`` shrinks both configs in
    place, for rehearsals on the CPU."""
    import io
    import shutil

    import scipy.io.wavfile
    import torch

    from tts_tpu_torch.api import TTS
    from tts_tpu_torch.bin.synthesize import main as synthesize_cli
    from tts_tpu_torch.models.glow_tts import GlowTTS
    from tts_tpu_torch.ops.decode_attention import decode_attention
    from tts_tpu_torch.server.server import build_parser, close_server, server_from_args
    from tts_tpu_torch.utils.convert import reference_glow_tts_state, reference_melgan_state
    from tts_tpu_torch.utils.synthesis import synthesis
    from tts_tpu_torch.utils.synthesizer import SENTENCE_GAP, Synthesizer

    t_phase = time.time()
    cuda = torch.device(device).type == "cuda"
    cut = cut or (lambda glow_config, voc_config: None)
    decode_attention.launches = 0  # K1 is not on this path: the count must stay 0
    if cuda:
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
    medium = VITS_SENTENCES["medium"]

    def silent(fn, *args, **kwargs):
        """``fn(*args, **kwargs)`` without the Synthesizer's per-call lines."""
        with contextlib.redirect_stdout(io.StringIO()):
            return fn(*args, **kwargs)

    log(f"fidelity replays on {device}: " + fidelity_replays(device) + f" | {card}")

    glow_config, voc_config = glow_recipe_config(), mb_melgan_recipe_config()
    cut(glow_config, voc_config)
    with tempfile.TemporaryDirectory() as d:
        glow_dir, voc_dir = os.path.join(d, "glow"), os.path.join(d, "voc")
        os.makedirs(glow_dir)
        os.makedirs(voc_dir)
        glow = GlowTTS.init_from_config(glow_config).init_params(seed=0, device="cpu")
        write_json(os.path.join(glow_dir, "config.json"), glow.config.to_dict())
        torch.save(glow.module.state_dict(), os.path.join(glow_dir, "model_torch.pt"))
        gen = random_vocoder(voc_config, seed=0)
        write_json(os.path.join(voc_dir, "config.json"), voc_config.to_dict())
        torch.save(gen.state_dict(), os.path.join(voc_dir, "model_torch.pt"))
        c = glow.config
        n_glow = sum(p.numel() for p in glow.module.parameters())
        n_voc = sum(p.numel() for p in gen.parameters())
        per_s = (melgan_gflop(gen, 1, padded=False) * voc_config.audio.sample_rate
                 / voc_config.audio.hop_length)
        gp = voc_config.generator_model_params
        log(f"GlowTTS (LJSpeech recipe, phonemes from {glow.tokenizer.phonemizer.name()}, "
            f"{c.text_cleaner}, num_chars {c.num_chars}): encoder {c.hidden_channels_enc} ch, "
            f"{c.encoder_params['num_layers']} relative-attention layers, "
            f"{c.encoder_params['num_heads']} heads, FFN {c.encoder_params['hidden_channels_ffn']}"
            f", prenet, duration predictor {c.hidden_channels_dp}; decoder "
            f"{c.num_flow_blocks_dec} flow blocks of {c.num_block_layers} WN layers at "
            f"{c.hidden_channels_dec} ch, kernel {c.kernel_size_dec}, {c.num_splits} splits, "
            f"squeeze {c.num_squeeze}; {n_glow / 1e6:.2f} M parameters (seed 0; zero-init leaves "
            f"drawn at a tenth scale, duration bias for ~6 frames a token). MB-MelGAN: "
            f"{gen.conv_pre.out_channels} base channels, upsampling {gp['upsample_factors']}, "
            f"{gp['num_res_blocks']} residual blocks a stage, {gen.pqmf.N} PQMF bands, "
            f"{voc_config.audio.sample_rate} Hz, hop {voc_config.audio.hop_length}; "
            f"{n_voc / 1e6:.2f} M parameters (seed 0); {per_s:.2f} GFLOP per second of audio")
        del glow, gen
        glow_args = ["--model_path", os.path.join(glow_dir, "model_torch.pt"), "--config_path",
                     os.path.join(glow_dir, "config.json")]
        voc_args = ["--vocoder_path", os.path.join(voc_dir, "model_torch.pt"),
                    "--vocoder_config_path", os.path.join(voc_dir, "config.json")]

        def load(dev, vocoder=True):
            kw = dict(vocoder_checkpoint=voc_args[1], vocoder_config=voc_args[3]) \
                if vocoder else {}
            return Synthesizer(tts_checkpoint=glow_args[1], tts_config_path=glow_args[3],
                               device=dev, **kw)

        # card against CPU: the mel, then the waveform through the bridge
        synth, cpu_synth = load(device), load("cpu")
        worst_mel = worst_wav = 0.0
        lengths, budgets, audio_s = [], [], []
        with torch.no_grad():
            for text in VITS_SENTENCES.values():
                g, w = synthesis(synth.tts_model, text), synthesis(cpu_synth.tts_model, text)
                g_len, w_len = g["outputs"]["y_lengths"].cpu(), w["outputs"]["y_lengths"]
                if not torch.equal(g_len, w_len) or g["model_outputs"].shape != \
                        w["model_outputs"].shape:
                    raise AssertionError(f"GlowTTS y_lengths card {g_len.tolist()} != CPU "
                                         f"{w_len.tolist()} for {text!r}")
                err = float(np.abs(g["model_outputs"] - w["model_outputs"]).max())
                if not err <= GLOW_MEL_TOL or not np.isfinite(g["model_outputs"]).all():
                    raise AssertionError(f"GlowTTS mel card vs CPU: max abs diff {err}")
                gw, ww = synth._vocode(g["model_outputs"]), cpu_synth._vocode(w["model_outputs"])
                werr = float(np.abs(gw - ww).max()) if gw.shape == ww.shape else np.inf
                if not werr <= VITS_WAV_TOL or not np.isfinite(gw).all() or gw.std() == 0:
                    raise AssertionError(f"GlowTTS + MB-MelGAN card vs CPU: {gw.shape} vs "
                                         f"{ww.shape}, max abs diff {werr}")
                worst_mel, worst_wav = max(worst_mel, err), max(worst_wav, werr)
                lengths.append(int(g_len[0]))
                budgets.append(int(g["outputs"]["model_outputs"].shape[1]))
                audio_s.append(len(gw) / synth.output_sample_rate)
        cut_note = ", ".join(f"{n}/{b}" for n, b in zip(lengths, budgets))
        log(f"GlowTTS + MB-MelGAN card vs CPU, the three phase 6 sentences: y_lengths {lengths} "
            f"equal, mel max abs diff {worst_mel:.3g} (tol {GLOW_MEL_TOL}), waveform through "
            f"the vocoder bridge {worst_wav:.3g} (tol {VITS_WAV_TOL}); frames/budget {cut_note}"
            f" ({'none' if all(n < b for n, b in zip(lengths, budgets)) else 'some'} cut at "
            f"the frame budget)")

        # speed at B=1: Synthesizer.tts per sentence (trim included), median of 5
        silent(synth.tts, medium)
        for key, text in VITS_SENTENCES.items():
            ms, lo, hi = median_ms(lambda: silent(synth.tts, text), device)
            seconds = (len(silent(synth.tts, text)) - SENTENCE_GAP) / synth.output_sample_rate
            log(f"GlowTTS + MB-MelGAN {key}: {seconds:.2f} s of audio (after the trim) in "
                f"{ms:.1f} ms (median of 5; {lo:.1f}-{hi:.1f}), RTF {seconds / ms * 1e3:.1f} "
                f"| {card}")
        if cuda:
            st = glow_stage_ms(synth, medium, device)
            mb = st["times"]["MB-MelGAN"]
            gflop = melgan_gflop(synth.vocoder_model, st["frames"])
            log(f"GlowTTS stages, medium sentence ({st['tokens']} tokens, {st['frames']} frames, "
                f"budget {st['budget']}), ms (median of 5; CUDA events, the bridge by the host "
                f"clock): " + ", ".join(f"{k} {v:.2f}" for k, v in st["times"].items())
                + f"; MB-MelGAN {gflop:.2f} GFLOP, {gflop / mb:.1f} TFLOP/s, "
                f"{100 * gflop / mb * 1e12 / FP32_FLOPS_PER_S:.1f} % of the fp32 peak | {card}")
            profile_call(lambda: silent(synth.tts, medium),
                         "GlowTTS + MB-MelGAN, one medium sentence through Synthesizer.tts", card)

        # Griffin-Lim: no vocoder, the same first phases on card and CPU
        gl, cpu_gl = load(device, vocoder=False), load("cpu", vocoder=False)
        np.random.seed(0)
        a = np.asarray(silent(gl.tts, medium), np.float32)
        np.random.seed(0)
        b = np.asarray(silent(cpu_gl.tts, medium), np.float32)
        peak = float(np.abs(b).max())
        err = float(np.abs(a - b).max()) if a.shape == b.shape else np.inf
        if not err <= GL_REL_TOL * peak or not np.isfinite(a).all() or peak == 0:
            raise AssertionError(f"Griffin-Lim card vs CPU: {a.shape} vs {b.shape}, max abs diff "
                                 f"{err} of peak {peak}")
        mel = synthesis(gl.tts_model, medium)["model_outputs"]
        np.random.seed(0)
        t0 = time.perf_counter()
        gl.ap.inv_melspectrogram(mel.T)
        gl_ms = (time.perf_counter() - t0) * 1e3
        log(f"Griffin-Lim ({gl.ap.griffin_lim_iters} iterations, no vocoder), medium sentence: "
            f"card vs CPU after np.random.seed(0), {len(a)} samples each, max abs diff "
            f"{err:.3g} of peak {peak:.3g} (tol {GL_REL_TOL} of the peak); Griffin-Lim alone "
            f"{gl_ms:.0f} ms on the host")
        del gl, cpu_gl, cpu_synth

        # the zoo by name: reference-layout directories, nothing fetched
        with tempfile.TemporaryDirectory() as home, offline_zoo(home):
            zg = os.path.join(home, "tts_tpu", ZOO_GLOW.replace("/", "--"))
            zv = os.path.join(home, "tts_tpu", ZOO_MBMELGAN.replace("/", "--"))
            os.makedirs(zg)
            os.makedirs(zv)
            glow_state = torch.load(glow_args[1], weights_only=True)
            torch.save({"model": {k: torch.from_numpy(v) for k, v in
                                  reference_glow_tts_state(glow_state).items()}},
                       os.path.join(zg, "model_file.pth"))
            shutil.copy(glow_args[3], os.path.join(zg, "config.json"))
            torch.save({"model": {k: torch.from_numpy(v) for k, v in reference_melgan_state(
                torch.load(voc_args[1], weights_only=True)).items()}},
                os.path.join(zv, "model_file.pth"))
            vsaved = voc_config.to_dict()
            vsaved["audio"]["stats_path"] = FOREIGN_STATS
            write_json(os.path.join(zv, "config.json"), vsaved)
            write_scale_stats(os.path.join(zv, "scale_stats.npy"), vsaved["audio"], seed=0)
            t0 = time.time()
            by_name = TTS(model_name=ZOO_GLOW, device=device)
            load_s = time.time() - t0
            with open(os.path.join(zv, "config.json")) as f:
                stats_path = json.load(f)["audio"]["stats_path"]
            if stats_path != os.path.join(zv, "scale_stats.npy") or not hasattr(
                    by_name.synthesizer.vocoder_ap, "mel_scaler"):
                raise AssertionError(f"zoo vocoder stats_path {stats_path!r} (F17)")
            by_path = TTS(model_path=os.path.join(zg, "model_file.pth"),
                          config_path=os.path.join(zg, "config.json"),
                          vocoder_path=os.path.join(zv, "model_file.pth"),
                          vocoder_config_path=os.path.join(zv, "config.json"), device=device)
            a = np.asarray(silent(by_name.tts, medium), np.float32)
            b = np.asarray(silent(by_path.tts, medium), np.float32)
            zerr = float(np.abs(a - b).max()) if a.shape == b.shape else np.inf
            if zerr != 0 or a.std() == 0:
                raise AssertionError(f"TTS(model_name={ZOO_GLOW}) vs path load: {a.shape} vs "
                                     f"{b.shape}, max abs diff {zerr}")
            log(f"zoo: {ZOO_GLOW} with its default vocoder {ZOO_MBMELGAN} from reference-layout "
                f"directories (model_file.pth, config.json; the vocoder's scale_stats.npy, its "
                f"stats_path rewritten from the trainer's, F17), nothing fetched; loaded in "
                f"{load_s:.1f} s; the medium sentence differs from the path load by {zerr}")
            del by_name, by_path

        # the command line with the vocoder flags against the API
        api = TTS(model_path=glow_args[1], config_path=glow_args[3], vocoder_path=voc_args[1],
                  vocoder_config_path=voc_args[3], device=device)
        api_path, cli_path = os.path.join(d, "api.wav"), os.path.join(d, "cli.wav")
        silent(api.tts_to_file, medium, file_path=api_path)
        silent(synthesize_cli, ["--text", medium, "--out_path", cli_path, "--device",
                                str(device)] + glow_args + voc_args)
        (sr, api_pcm), (cli_sr, cli_pcm) = (scipy.io.wavfile.read(p) for p in (api_path,
                                                                              cli_path))
        step = (np.abs(cli_pcm.astype(np.int32) - api_pcm.astype(np.int32)).max()
                if cli_pcm.shape == api_pcm.shape else None)
        if step is None or step > 1 or cli_sr != sr or sr != voc_config.audio.sample_rate:
            raise AssertionError(f"tts --vocoder_path {cli_pcm.shape} at {cli_sr} Hz vs the API "
                                 f"{api_pcm.shape} at {sr} Hz: {step} int16 steps")
        log(f"tts --model_path --config_path --vocoder_path --vocoder_config_path: "
            f"{len(cli_pcm)} samples at {cli_sr} Hz, at most {step} int16 step from "
            f"TTS.tts_to_file")
        del api

        # the server with the vocoder flags and --max_batch 4: served serially
        said = io.StringIO()
        with contextlib.redirect_stdout(said):
            srv = server_from_args(build_parser().parse_args(
                glow_args + voc_args + ["--max_batch", "4", "--port", "0",
                                        "--device", str(device)]))
        if "serving serially" not in said.getvalue() or srv.batcher is not None:
            raise AssertionError(f"server with a vocoder and --max_batch 4: {said.getvalue()!r}")
        thread = threading.Thread(target=srv.serve_forever, daemon=True)
        thread.start()
        base = f"http://127.0.0.1:{srv.server_address[1]}"
        results: dict = {}
        try:
            t1 = time.perf_counter()
            clients = [threading.Thread(target=_fetch, args=(
                f"{base}/api/tts?text={urllib.parse.quote(t)}", results, k))
                for k, t in VITS_SENTENCES.items()]
            with contextlib.redirect_stdout(io.StringIO()):
                for cl in clients:
                    cl.start()
                for cl in clients:
                    cl.join(timeout=600)
            served_s = time.perf_counter() - t1
        finally:
            close_server(srv)
            thread.join(timeout=60)
        served_audio = 0.0
        for key in VITS_SENTENCES:
            res = results.get(key) or {}
            if res.get("status") != 200:
                raise AssertionError(f"GlowTTS /api/tts {key!r}: {res.get('status')}")
            rate, pcm = scipy.io.wavfile.read(io.BytesIO(res["body"]))
            if rate != sr or len(pcm) <= SENTENCE_GAP or pcm[:-SENTENCE_GAP].std() < 30:
                raise AssertionError(f"GlowTTS /api/tts {key!r}: {rate} Hz, {len(pcm)} samples")
            served_audio += len(pcm) / rate
        line = [ln for ln in said.getvalue().splitlines() if "serially" in ln][0].strip()
        log(f"GlowTTS server (--vocoder_path, --max_batch 4): said {line!r}; 3 concurrent "
            f"/api/tts requests, {served_audio:.2f} s of audio in {served_s:.2f} s | {card}")
        del synth

    if decode_attention.launches:
        raise AssertionError(f"decode_attention launched {decode_attention.launches} times "
                             f"during the GlowTTS phase")
    line = "GlowTTS + MB-MelGAN: no hand-written kernel on this path (decode_attention launches 0)"
    if cuda:
        peak = torch.cuda.max_memory_allocated()
        line += (f"; peak device memory {peak / 1e9:.3f} GB allocated, "
                 f"{(peak - resident) / 1e9:.3f} GB above the {resident / 1e9:.3f} GB resident")
    log(line + f"; phase 10 took {time.time() - t_phase:.1f} s | {card}")


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
    single_ms = phase_vits(card)
    phase_batched_vits(card)
    phase_multispeaker(card, single_ms)
    phase_zoo_and_variants(card)
    phase_glow_tts(card)
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
