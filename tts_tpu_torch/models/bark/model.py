"""Bark: three-stage autoregressive audio generation in PyTorch (port of
``tts_tpu/models/bark/model.py``; reference ``TTS/tts/models/bark.py`` and
``layers/bark/{model,model_fine,inference_funcs}.py``).

text → semantic tokens (a causal GPT, KV-cached) → coarse EnCodec codes (a
causal GPT over sliding windows, KV-cached) → fine codes (a non-causal GPT
per codebook over 1024-wide windows) → waveform through the EnCodec
decoder (``encodec.py``). The causal GPTs run on the port's ``GPT2Core``
without biases and with the exact gelu; every single-token decode step
launches the decode-attention kernel once a layer on CUDA.

PyTorch runs eagerly: the JAX package's ``lax.while_loop`` and ``lax.scan``
loops are Python loops here. The semantic loop reads its done flags every
``DONE_CHECK_EVERY`` steps and stops once every row has emitted EOS (the
JAX loop stops at the step itself; the tokens after a row's EOS are EOS
either way). The coarse stage reuses one cache across windows: each window
prefills a fixed 887-token prompt (256 semantic tokens, the infer token, a
630-wide tail) under a mask that hides the tail's unwritten part, then
decodes from the end of its valid part; the decode's ``cache_len`` hides
every slot past the token being written, so nothing stale is ever read.

All draws come from one ``torch.Generator``, through ``sample_logits`` and
``_categorical`` of this module's namespace. Differences from the JAX
package, each named in a test:

* **F48.** Each GPT's vocabularies and position table are read from its
  checkpoint: the published ``text_2.pt`` has a 10,048-wide head over a
  129,600-token input, where ``BarkConfig``'s semantic defaults say 129,600
  for both, and the JAX loader then fails on the head's shape.
* **F49.** Without EnCodec weights in the model directory (the zoo's file
  list has none) ``synthesize`` raises before generating, where the JAX
  package returns ``wav=None`` and its ``Synthesizer`` fails on it.
* **F50.** The text is always UTF-8 byte ids. The JAX package tries
  ``transformers``' ``bert-base-multilingual-cased`` from a local cache
  first (the reference's tokenizer); neither the vocabulary nor
  ``transformers`` is available to the port.
* **F51.** The loader strips the ``_orig_mod.`` prefix of a checkpoint
  saved from a compiled model, as suno's and the reference's loaders do;
  the JAX loader does not.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn

from tts_tpu_torch import resolve_device
from tts_tpu_torch.models.xtts.gpt_core import GPT2Core, _categorical, sample_logits

from .config import BarkConfig, BarkGPTArgs
from .encodec import EncodecVocoder

DONE_CHECK_EVERY = 8  # semantic decode steps between reads of the done flags
ENCODEC_FILES = ("encodec_24khz.pth", "encodec.pth", "encodec_model_24khz.pth")


def _dynamic_slice(x: torch.Tensor, start: int, size: int) -> torch.Tensor:
    """``x[:, start:start + size]`` with XLA's ``dynamic_slice`` clamping:
    the start moves left so that the slice fits."""
    start = max(0, min(int(start), x.shape[1] - size))
    return x[:, start : start + size]


class BarkGPT(nn.Module):
    """Causal GPT with learned positions and separate input and output
    vocabularies (reference ``bark/model.py:233``)."""

    def __init__(self, args: BarkGPTArgs):
        super().__init__()
        self.args = args
        self.wte = nn.Embedding(args.input_vocab_size, args.n_embd)
        self.wpe = nn.Parameter(torch.empty(args.block_size, args.n_embd))
        self.core = GPT2Core(args.n_layer, args.n_embd, args.n_head, bias=args.bias,
                             gelu_exact=True)
        self.lm_head = nn.Linear(args.n_embd, args.output_vocab_size, bias=False)
        self.decode_steps = 0  # single-token steps run, for the launch count

    def forward(self, idx: torch.Tensor, cache=None, cache_index: int = 0,
                position_offset: int = 0, attn_mask: Optional[torch.Tensor] = None,
                cache_len=None, merge_context: bool = False) -> torch.Tensor:
        """Token ids ``[B, T]`` → logits ``[B, T', V]``. ``merge_context``
        sums the embeddings of the first 256 (text) and the next 256
        (history) tokens, which then share positions (reference
        ``model.py:259``): ``T' = T - 256``."""
        if merge_context:
            h = torch.cat([self.wte(idx[:, :256]) + self.wte(idx[:, 256:512]),
                           self.wte(idx[:, 512:])], dim=1)
        else:
            h = self.wte(idx)
        T = h.shape[1]
        if position_offset + T > self.wpe.shape[0]:  # the JAX slice would clamp
            raise ValueError(f"positions {position_offset}..{position_offset + T - 1} pass the "
                             f"{self.wpe.shape[0]}-row position table")
        h = h + self.wpe[position_offset : position_offset + T][None]
        if T == 1 and cache_len is not None:
            self.decode_steps += 1
        h = self.core(h, causal=True, cache=cache, cache_index=cache_index, cache_len=cache_len,
                      attn_mask=attn_mask)
        return self.lm_head(h)

    def _decode(self, tok: torch.Tensor, cache, cur: int) -> torch.Tensor:
        """One token ``[B]`` at position ``cur`` → the next logits ``[B, V]``."""
        return self(tok[:, None], cache=cache, cache_index=cur, position_offset=cur,
                    cache_len=cur + 1)[:, -1]

    @torch.no_grad()
    def generate(self, prompt: torch.Tensor, generator: Optional[torch.Generator],
                 max_new_tokens: int, eos_token: int, temperature: float = 0.7,
                 top_k: int = 50, top_p: float = 0.95, logit_slice: Optional[int] = None,
                 merge_context: bool = False) -> Dict[str, torch.Tensor]:
        """KV-cached sampling → ``tokens [B, max_new_tokens]`` (EOS after
        each row's end) and ``lengths [B]``; ``logit_slice`` samples from
        the first N classes."""
        B = prompt.shape[0]
        L_pre = prompt.shape[1] - (256 if merge_context else 0)
        dev = prompt.device
        cache = self.core.init_cache(B, L_pre + max_new_tokens, self.wte.weight.dtype, dev)
        logits = self(prompt, cache=cache, cache_index=0, merge_context=merge_context)[:, -1]
        done = torch.zeros((B,), dtype=torch.bool, device=dev)
        n = torch.zeros((B,), dtype=torch.int32, device=dev)
        toks = []
        for s in range(max_new_tokens):
            lg = logits[:, :logit_slice] if logit_slice is not None else logits
            tok = sample_logits(lg, generator, temperature=temperature, top_k=top_k, top_p=top_p)
            tok = torch.where(done, eos_token, tok)
            done = done | (tok == eos_token)
            n = n + (~done).to(torch.int32)
            toks.append(tok)
            logits = self._decode(tok, cache, L_pre + s)
            if (s + 1) % DONE_CHECK_EVERY == 0 and s + 1 < max_new_tokens and bool(done.all()):
                break
        tokens = torch.stack(toks, dim=1)
        if tokens.shape[1] < max_new_tokens:
            tokens = torch.cat([tokens, tokens.new_full((B, max_new_tokens - tokens.shape[1]),
                                                        eos_token)], dim=1)
        return {"tokens": tokens, "lengths": n}

    @torch.no_grad()
    def generate_coarse_windows(self, sem_padded: torch.Tensor, coarse_init: torch.Tensor,
                                sem_starts: Sequence[int], tail_starts: Sequence[int],
                                valid_tails: Sequence[int], write_starts: Sequence[int],
                                generator: Optional[torch.Generator], window_steps: int,
                                max_coarse_history: int, infer_token: int, temperature: float,
                                top_k: int, top_p: float, codebook_cycle: tuple) -> torch.Tensor:
        """The coarse stage over its windows (reference sliding-window loop,
        ``inference_funcs.py:330``): each window slices its 256-token
        semantic context and its ``max_coarse_history``-wide coarse tail out
        of the buffers, prefills them behind the infer token under a mask
        hiding the tail past ``valid_tail``, decodes ``window_steps`` tokens
        from there, step ``s`` sampling from codebook ``s % n`` of
        ``codebook_cycle=(base, size, n)`` (the vocabulary slice ``[base +
        (s % n)·size, base + (s % n + 1)·size)``), and writes them back at
        ``write_start``. ``sem_padded [1, S]``, ``coarse_init [1, C]`` → the
        coarse buffer ``[1, C]``."""
        W_PROMPT = 256 + 1 + max_coarse_history
        dev = sem_padded.device
        cache = self.core.init_cache(1, W_PROMPT + window_steps, self.wte.weight.dtype, dev)
        rows = torch.arange(W_PROMPT, device=dev)
        causal = rows[None, :] <= rows[:, None]
        infer = torch.full((1, 1), infer_token, dtype=sem_padded.dtype, device=dev)
        base, size, n_cb = codebook_cycle
        v = torch.arange(self.lm_head.out_features, device=dev)
        windows = [(v >= base + i * size) & (v < base + (i + 1) * size) for i in range(n_cb)]
        buf = coarse_init.clone()
        for ss, ts, vt, ws in zip(sem_starts, tail_starts, valid_tails, write_starts):
            valid_len = 257 + int(vt)
            prompt = torch.cat([_dynamic_slice(sem_padded, ss, 256), infer,
                                _dynamic_slice(buf, ts, max_coarse_history)], dim=1)
            mask = causal & (rows[None, :] < valid_len)
            logits = self(prompt, cache=cache, cache_index=0, attn_mask=mask)[:, valid_len - 1]
            toks = []
            for s in range(window_steps):
                lg = logits.masked_fill(~windows[s % n_cb], float("-inf"))
                tok = sample_logits(lg, generator, temperature=temperature, top_k=top_k,
                                    top_p=top_p)
                toks.append(tok)
                logits = self._decode(tok, cache, valid_len + s)
            start = max(0, min(int(ws), buf.shape[1] - window_steps))
            buf[:, start : start + window_steps] = torch.stack(toks, dim=1).to(buf.dtype)
        return buf


class BarkFineGPT(nn.Module):
    """Non-causal GPT predicting codebook ``k`` from codebooks ``≤ k``
    (reference ``bark/model_fine.py:142``): one embedding per codebook, the
    core with biases and the exact gelu, one head per predicted codebook."""

    def __init__(self, args: BarkGPTArgs):
        super().__init__()
        self.args = args
        for i in range(args.n_codes_total):
            self.add_module(f"wte_{i}", nn.Embedding(args.input_vocab_size, args.n_embd))
        self.wpe = nn.Parameter(torch.empty(args.block_size, args.n_embd))
        self.core = GPT2Core(args.n_layer, args.n_embd, args.n_head, gelu_exact=True)
        for i in range(args.n_codes_given, args.n_codes_total):
            self.add_module(f"lm_head_{i}", nn.Linear(args.n_embd, args.output_vocab_size,
                                                      bias=False))

    def forward(self, pred_idx: int, idx: torch.Tensor) -> torch.Tensor:
        """Codes ``[B, T, n_codes_total]`` → logits ``[B, T, V]`` of codebook
        ``pred_idx``, attending over the whole sequence."""
        T = idx.shape[1]
        h = sum(getattr(self, f"wte_{i}")(idx[:, :, i]) for i in range(pred_idx + 1))
        h = h + self.wpe[None, :T]
        return getattr(self, f"lm_head_{pred_idx}")(self.core(h, causal=False))

    @torch.no_grad()
    def generate_fine_windows(self, buf: torch.Tensor, starts: Sequence[int],
                              rels: Sequence[int], generator: Optional[torch.Generator],
                              n_coarse: int, window: int, temperature: Optional[float],
                              codebook_size: int) -> torch.Tensor:
        """The fine stage over its windows (reference ``inference_funcs.py:
        561-588``): each window takes a ``window``-wide view of the codes
        buffer ``[1, T, n_codes_total]``, predicts codebooks ``n_coarse`` on
        in order (argmax for ``temperature=None``, else a categorical draw),
        keeps every frame before ``rel`` as it was, and writes the window
        back."""
        n_fine = self.args.n_codes_total
        buf = buf.clone()
        pos = torch.arange(window, device=buf.device)
        for start, rel in zip(starts, rels):
            start = max(0, min(int(start), buf.shape[1] - window))
            win = buf[:, start : start + window].clone()
            for k in range(n_coarse, n_fine):
                logits = self(k, win)[:, :, :codebook_size]
                if temperature is None:
                    sampled = torch.argmax(logits, dim=-1)
                else:
                    sampled = _categorical(logits / temperature, generator)
                win[:, :, k] = torch.where(pos[None] < int(rel), win[:, :, k],
                                           sampled.to(win.dtype))
            buf[:, start : start + window] = win
        return buf


class Bark(nn.Module):
    """The host pipeline (reference ``models/bark.py:30``). The EnCodec
    vocoder (``encodec``) is built when its weights load (a file of
    ``ENCODEC_FILES`` in the model directory) or by :meth:`init_params`."""

    def __init__(self, config: BarkConfig):
        super().__init__()
        self.config = config
        self.semantic_model = BarkGPT(config.semantic_config)
        self.coarse_model = BarkGPT(config.coarse_config)
        self.fine_model = BarkFineGPT(config.fine_config)
        self.encodec: Optional[EncodecVocoder] = None
        self.output_sample_rate = config.SAMPLE_RATE

    @classmethod
    def init_from_config(cls, config: BarkConfig):
        return cls(config)

    @property
    def device(self) -> torch.device:
        return self.semantic_model.wpe.device

    @torch.no_grad()
    def init_params(self, seed: int = 0, device="cuda", dtype=torch.float32,
                    encodec: bool = True) -> "Bark":
        """Random weights from ``seed``, drawn on ``device`` by a generator of
        that device (a CPU draw is the same on every machine; a card's differs
        from it), then cast to ``dtype``: norm scales 1 and biases 0, linear,
        conv and LSTM weights N(0, 1/fan_in), embeddings and position tables
        N(0, 0.02²); with ``encodec``, an EnCodec at the 24 kHz model's dims
        with codebooks N(0, 1)."""
        from .encodec import EncodecDecoder, EncodecEncoder

        device = resolve_device(device)
        gen = torch.Generator(device).manual_seed(seed)
        if encodec:
            self.encodec = EncodecVocoder(EncodecDecoder(), torch.empty(8, 1024, 128),
                                          EncodecEncoder())
        self.to(device)
        for module in self.modules():
            for name, p in module.named_parameters(recurse=False):
                if isinstance(module, nn.LayerNorm):
                    p.fill_(1.0 if name == "weight" else 0.0)
                elif name.startswith("bias"):
                    p.zero_()
                elif isinstance(module, nn.LSTM):
                    p.copy_(torch.randn(p.shape, generator=gen, device=device) / p.shape[1] ** 0.5)
                elif isinstance(module, (nn.Linear, nn.Conv1d)):
                    p.copy_(torch.randn(p.shape, generator=gen, device=device) / p[0].numel() ** 0.5)
                elif isinstance(module, nn.ConvTranspose1d):
                    fan_in = p.shape[0] * p.shape[2] // module.stride[0]
                    p.copy_(torch.randn(p.shape, generator=gen, device=device) / fan_in**0.5)
                else:
                    p.copy_(torch.randn(p.shape, generator=gen, device=device) * 0.02)
        if encodec:
            self.encodec.codebooks.copy_(torch.randn(8, 1024, 128, generator=gen, device=device))
        return self.requires_grad_(False).to(device=device, dtype=dtype)

    def load_checkpoint(self, config=None, checkpoint_dir: str = None, device="cuda", **kwargs):
        """A model directory in the reference's bark layout
        (:func:`load_bark_checkpoint`)."""
        return load_bark_checkpoint(self, checkpoint_dir, device=device)

    def quantize_weights_int8(self, compute_dtype: Optional[torch.dtype] = None) -> None:
        """Store the matmul weights of all three GPTs (semantic, coarse,
        fine) as int8 with per-output-channel scales (``ops/quant.py``), in
        place, the float weights freed; they then multiply through K4. The
        embeddings and EnCodec stay float, as in the JAX package."""
        from tts_tpu_torch.ops.quant import install_int8

        install_int8(self, ("semantic_model", "coarse_model", "fine_model"), compute_dtype)

    # -- voice prompts (reference inference_funcs.py:105 generate_voice) ----
    @torch.no_grad()
    def generate_voice(self, wav: np.ndarray, hubert, tokenizer, output_path: str = None,
                       sample_rate: int = 16000) -> Dict[str, np.ndarray]:
        """A reference clip → Bark's voice-prompt dict: semantic tokens from
        HuBERT's layer-9 features and the LSTM tokenizer
        (``hubert.semantic_tokens_from_audio``); coarse and fine codes from
        the EnCodec encoder at 24 kHz where it is loaded. Saved as an
        ``.npz`` at ``output_path`` when given."""
        from tts_tpu_torch.audio.numpy_transforms import resample_wav

        from .hubert import semantic_tokens_from_audio

        wav16 = np.asarray(wav, np.float32)
        if sample_rate != 16000:  # HuBERT runs at 16 kHz
            wav16 = resample_wav(wav16, sample_rate, 16000)
        prompt = {"semantic_prompt": semantic_tokens_from_audio(wav16, hubert, tokenizer)}
        if self.encodec is not None and self.encodec.can_encode:
            wav24 = resample_wav(np.asarray(wav, np.float32), sample_rate, 24000)
            codes = self.encodec.encode(wav24).cpu().numpy()  # [n_q, T]
            prompt["coarse_prompt"] = codes[: self.config.N_COARSE_CODEBOOKS]
            prompt["fine_prompt"] = codes
        if output_path:
            np.savez(output_path, **prompt)
        return prompt

    # -- stage 1: text → semantic (reference inference_funcs.py:178) --------
    def semantic_prompt(self, text_tokens, semantic_history=None) -> torch.Tensor:
        """The semantic stage's 513-token prompt ``[1, 513]`` on the model's
        device: 256 text tokens (offset, cut, right-padded), the last 256
        history tokens (right-padded; reference ``inference_funcs.py:214``),
        the infer token."""
        c = self.config
        text = (np.asarray(text_tokens, np.int64) + c.TEXT_ENCODING_OFFSET)[:256]
        text = np.pad(text, (0, 256 - len(text)), constant_values=c.TEXT_PAD_TOKEN)
        if semantic_history is not None:
            history = np.asarray(semantic_history, np.int64)[-256:]
            history = np.pad(history, (0, 256 - len(history)),
                             constant_values=c.SEMANTIC_PAD_TOKEN)
        else:
            history = np.full(256, c.SEMANTIC_PAD_TOKEN)
        prompt = np.concatenate([text, history, [c.SEMANTIC_INFER_TOKEN]])[None]
        return torch.from_numpy(prompt.astype(np.int64)).to(self.device)

    def generate_text_semantic(self, text_tokens, generator: Optional[torch.Generator] = None,
                               max_gen_duration_s: float = 8.0, temperature: float = 0.7,
                               top_k: int = 50, top_p: float = 0.95,
                               semantic_history=None) -> np.ndarray:
        c = self.config
        out = self.semantic_model.generate(
            self.semantic_prompt(text_tokens, semantic_history), generator,
            max_new_tokens=int(max_gen_duration_s * c.SEMANTIC_RATE_HZ),
            eos_token=c.SEMANTIC_VOCAB_SIZE, temperature=temperature, top_k=top_k, top_p=top_p,
            logit_slice=c.SEMANTIC_VOCAB_SIZE + 1, merge_context=True)
        toks = out["tokens"][0].cpu().numpy()
        return toks[: int(out["lengths"][0])]

    # -- stage 2: semantic → coarse (reference inference_funcs.py:330) ------
    def generate_coarse(self, semantic_tokens, generator: Optional[torch.Generator] = None,
                        temperature: float = 0.7, top_k: int = 50, top_p: float = 0.95,
                        history=None, max_coarse_history: int = 630,
                        sliding_window_len: int = 60) -> np.ndarray:
        """The reference's sliding windows: per window the prompt is the
        256-token (padded) semantic context, the coarse infer token and the
        last ≤ 630 coarse tokens, and each step samples from its codebook's
        slice. ``history``: ``(semantic_prompt [T], coarse_prompt [2, T'])``
        of a voice prompt, trimmed as the reference trims it (its
        off-by-two time-alignment cut included). → codes ``[2, T]``."""
        c = self.config
        block = self.coarse_model.args.block_size  # small models shrink the layout
        sliding_window_len = min(sliding_window_len, max(1, (block - 257) // 2))
        max_coarse_history = min(max_coarse_history, block - 257 - sliding_window_len)
        ratio = c.COARSE_RATE_HZ / c.SEMANTIC_RATE_HZ * c.N_COARSE_CODEBOOKS
        max_sem_hist = int(np.floor(max_coarse_history / ratio))
        sem = np.asarray(semantic_tokens, np.int32)
        if history is not None:
            sem_hist = np.asarray(history[0], np.int32)
            cb2d = np.asarray(history[1], np.int32)
            # interleave the codebooks with their vocabulary offsets
            flat = (cb2d + np.arange(cb2d.shape[0])[:, None] * c.CODEBOOK_SIZE).T.reshape(-1)
            flat = flat + c.SEMANTIC_VOCAB_SIZE
            n_sem = min(max_sem_hist, len(sem_hist) - len(sem_hist) % 2,
                        int(np.floor(len(flat) / ratio)))
            n_coarse = int(round(n_sem * ratio))
            sem_hist = sem_hist[-n_sem:] if n_sem > 0 else sem_hist[:0]
            flat = (flat[-n_coarse:] if n_coarse > 0 else flat[:0])[:-2]
        else:
            sem_hist = np.array([], np.int32)
            flat = np.array([], np.int32)

        n_steps = int(round(np.floor(len(sem) * ratio / c.N_COARSE_CODEBOOKS))
                      * c.N_COARSE_CODEBOOKS)
        n_steps = max(n_steps, c.N_COARSE_CODEBOOKS)
        x_semantic = np.concatenate([sem_hist, sem]).astype(np.int64)
        base_idx = len(sem_hist)
        n_hist_coarse = len(flat)
        swl, mch = int(sliding_window_len), int(max_coarse_history)
        n_windows = -(-n_steps // swl)
        buf_len = max(mch, n_hist_coarse + n_windows * swl)
        coarse_init = np.zeros(buf_len, np.int64)
        coarse_init[:n_hist_coarse] = flat
        sem_padded = np.pad(x_semantic, (0, 256), constant_values=c.COARSE_SEMANTIC_PAD_TOKEN)
        pos = n_hist_coarse + swl * np.arange(n_windows)
        sem_idx = base_idx + np.round(swl * np.arange(n_windows) / ratio).astype(int)
        dev = self.device
        buf = self.coarse_model.generate_coarse_windows(
            torch.from_numpy(sem_padded[None]).to(dev), torch.from_numpy(coarse_init[None]).to(dev),
            np.maximum(0, sem_idx - max_sem_hist).tolist(), np.maximum(0, pos - mch).tolist(),
            np.minimum(mch, pos).tolist(), pos.tolist(), generator, window_steps=swl,
            max_coarse_history=mch, infer_token=c.COARSE_INFER_TOKEN, temperature=temperature,
            top_k=top_k, top_p=top_p,
            codebook_cycle=(c.SEMANTIC_VOCAB_SIZE, c.CODEBOOK_SIZE, c.N_COARSE_CODEBOOKS))
        toks = buf[0].cpu().numpy()[n_hist_coarse:][:n_steps]
        # de-interleave into [N_COARSE, T] and remove the vocabulary offsets
        toks = np.array(toks.reshape(-1, c.N_COARSE_CODEBOOKS).T)
        for i in range(c.N_COARSE_CODEBOOKS):
            toks[i] = np.clip(toks[i] - c.SEMANTIC_VOCAB_SIZE - i * c.CODEBOOK_SIZE, 0,
                              c.CODEBOOK_SIZE - 1)
        return toks

    # -- stage 3: coarse → fine (reference inference_funcs.py:495) ----------
    def generate_fine(self, coarse_codes: np.ndarray, generator: Optional[torch.Generator] = None,
                      temperature: Optional[float] = 0.5, history=None) -> np.ndarray:
        """``history``: a fine voice prompt ``[8, T_hist]``, whose last ≤ 512
        frames are prepended as context and stripped after (reference
        ``inference_funcs.py:520``). The windows are the reference's
        (1024 wide, 512 hop, the overlap held fixed). → codes ``[8, T]``."""
        c = self.config
        n_fine = c.N_FINE_CODEBOOKS
        win = min(1024, self.fine_model.args.block_size)  # small models shrink
        hop = win // 2
        n_coarse, t_gen = coarse_codes.shape
        codes = np.full((n_fine, t_gen), c.CODEBOOK_SIZE, np.int64)
        codes[:n_coarse] = coarse_codes
        n_hist = 0
        if history is not None:
            hist = np.asarray(history, np.int64)[:, -hop:]
            n_hist = hist.shape[1]
            codes = np.concatenate([hist[:n_fine], codes], axis=1)
        # right-pad to at least one window, then to a whole number of hops
        T = -(-max(win, codes.shape[1]) // hop) * hop
        if T > codes.shape[1]:
            codes = np.concatenate(
                [codes, np.full((n_fine, T - codes.shape[1]), c.CODEBOOK_SIZE, np.int64)], axis=1)
        n_loops = max(0, int(np.ceil((t_gen - (win - n_hist)) / hop))) + 1
        starts = np.minimum(hop * np.arange(n_loops), T - win)
        fills = np.minimum(n_hist + hop * np.arange(n_loops), T - hop)
        buf = self.fine_model.generate_fine_windows(
            torch.from_numpy(np.ascontiguousarray(codes.T[None])).to(self.device),
            starts.tolist(), (fills - starts).tolist(), generator, n_coarse=n_coarse,
            window=win, temperature=temperature, codebook_size=c.CODEBOOK_SIZE)
        return buf[0].cpu().numpy().T[:, n_hist : n_hist + t_gen]

    def codes_to_audio(self, fine_codes) -> np.ndarray:
        """Fine codes ``[8, T]`` → ``[T·320]`` samples at 24 kHz through the
        EnCodec decoder (reference ``inference_funcs.py:599 codec_decode``)."""
        if self.encodec is None:
            raise RuntimeError(self._no_encodec())
        return self.encodec.decode(np.asarray(fine_codes)).float().cpu().numpy()

    @staticmethod
    def _no_encodec() -> str:
        return ("Bark has no EnCodec weights: put the 24 kHz EnCodec checkpoint in the model "
                f"directory as one of {', '.join(ENCODEC_FILES)} (the zoo's bark lists none; "
                "ROADMAP.md F49)")

    def synthesize(self, text: str, config=None, speaker_id: Optional[str] = None,
                   voice_dirs=None, history_prompt=None, speaker_wav=None, language=None,
                   generator: Optional[torch.Generator] = None, **kwargs) -> Dict:
        """Text → speech through the three stages and EnCodec. The voice is a
        prompt dict (``history_prompt``: ``semantic_prompt``,
        ``coarse_prompt``, ``fine_prompt``, or the path of an ``.npz``
        holding them), ``voice_dirs/<speaker_id>.npz``, or none (the random
        voice, also for ``speaker_id`` ``"random"``). The text is UTF-8 byte
        ids (F50); the language is implicit in it. ``generator`` (seeded
        ``seed``, 0 by default, on the model's device) draws the three
        stages in turn; ``kwargs`` (``max_gen_duration_s``, ``temperature``,
        ``top_k``, ``top_p``) go to the semantic stage, as in the JAX
        package. Returns ``{"semantic", "coarse", "fine", "wav"}``."""
        if self.encodec is None:
            raise RuntimeError(self._no_encodec())
        if speaker_wav is not None:
            raise ValueError("Bark speaks from voice prompts: make one from the clip with "
                             "Bark.generate_voice and name it as the speaker with voice_dir")
        seed = int(kwargs.pop("seed", 0))
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(seed)
        text_tokens = text_ids(text)
        prompt = history_prompt
        if prompt is None and speaker_id not in (None, "random") and voice_dirs:
            dirs = [voice_dirs] if isinstance(voice_dirs, str) else list(voice_dirs)
            found = [os.path.join(d, f"{speaker_id}.npz") for d in dirs
                     if os.path.isfile(os.path.join(d, f"{speaker_id}.npz"))]
            if not found:
                raise ValueError(f"no bark voice prompt {speaker_id}.npz in {dirs} "
                                 "(create one with Bark.generate_voice)")
            prompt = found[0]
        elif prompt is None and speaker_id not in (None, "random"):
            raise ValueError(f"speaker {speaker_id!r} requested but no voice_dirs given: pass "
                             "voice_dirs (<dir>/<speaker>.npz) or use speaker_id='random'")
        if isinstance(prompt, str):
            with np.load(prompt) as data:
                prompt = {k: data[k] for k in data.files}
        sem_hist = coarse_hist = fine_hist = None
        if prompt is not None:
            sem_hist = prompt.get("semantic_prompt")
            fine_hist = prompt.get("fine_prompt")
            coarse_hist = prompt.get("coarse_prompt")
            if coarse_hist is None and fine_hist is not None:
                coarse_hist = np.asarray(fine_hist)[: self.config.N_COARSE_CODEBOOKS]
        semantic = self.generate_text_semantic(text_tokens, generator,
                                               semantic_history=sem_hist, **kwargs)
        coarse = self.generate_coarse(
            semantic, generator,
            history=(sem_hist, coarse_hist)
            if sem_hist is not None and coarse_hist is not None else None)
        fine = self.generate_fine(coarse, generator, history=fine_hist)
        return {"semantic": semantic, "coarse": coarse, "fine": fine,
                "wav": self.codes_to_audio(fine)}


def text_ids(text: str) -> np.ndarray:
    """The text's token ids: its UTF-8 bytes (F50)."""
    return np.frombuffer(text.encode("utf-8"), dtype=np.uint8).astype(np.int64)


def _read_state(path: str) -> Dict[str, np.ndarray]:
    """A torch checkpoint's state dict as numpy: ``{"model": state, ...}``
    or the state itself, the ``_orig_mod.`` prefix of a compiled model's
    state stripped (F51)."""
    from tts_tpu_torch.utils.convert import _to_numpy

    state = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(state, dict) and "model" in state:
        state = state["model"]
    return {k[len("_orig_mod."):] if k.startswith("_orig_mod.") else k: _to_numpy(v)
            for k, v in state.items()}


def _gpt_args(args: BarkGPTArgs, state: Dict[str, np.ndarray], wte: str,
              head: str) -> BarkGPTArgs:
    """``args`` with the vocabularies, the position table and the width read
    from the checkpoint (F48); its depth must be the config's."""
    n_layer = len({k.split(".")[2] for k in state if k.startswith("transformer.h.")})
    if n_layer != args.n_layer:
        raise ValueError(f"the checkpoint holds {n_layer} layers, the config says {args.n_layer}")
    fields = args.to_dict()
    fields.update(input_vocab_size=int(state[wte].shape[0]),
                  output_vocab_size=int(state[head].shape[0]),
                  block_size=int(state["transformer.wpe.weight"].shape[0]),
                  n_embd=int(state[wte].shape[1]),
                  bias="transformer.h.0.ln_1.bias" in state)
    return BarkGPTArgs(**fields)


def load_bark_checkpoint(model: Bark, checkpoint_dir: str, device="cuda") -> Bark:
    """The reference bark directory (``text_2.pt``, ``coarse_2.pt``,
    ``fine_2.pt``, and EnCodec as one of ``ENCODEC_FILES``), each file
    converted as it is read (reference ``bark/load_model.py``; the JAX
    package converts each to a flax ``.msgpack`` once). The three GPTs must
    be there; EnCodec is optional (F49)."""
    from tts_tpu_torch.utils import convert as C

    device = resolve_device(device)
    c = model.config
    path = lambda name: os.path.join(checkpoint_dir, name)  # noqa: E731
    for name in ("text_2.pt", "coarse_2.pt", "fine_2.pt"):
        if not os.path.isfile(path(name)):
            raise FileNotFoundError(f"No {name} in {checkpoint_dir} (the bark layout)")

    def assign(attr, module_cls, args, params):
        with torch.device("meta"):
            module = module_cls(args)
        module.load_state_dict({k: v.to(device) for k, v in C.flax_to_state_dict(params).items()},
                               strict=True, assign=True)
        setattr(model, attr, module.requires_grad_(False))

    for name, attr, args in (("text_2.pt", "semantic_model", c.semantic_config),
                             ("coarse_2.pt", "coarse_model", c.coarse_config)):
        state = _read_state(path(name))
        args = _gpt_args(args, state, "transformer.wte.weight", "lm_head.weight")
        assign(attr, BarkGPT, args, C.convert_bark_gpt(state, args.n_layer))
        del state
    f = c.fine_config
    state = _read_state(path("fine_2.pt"))
    args = _gpt_args(f, state, "transformer.wtes.0.weight", "lm_heads.0.weight")
    assign("fine_model", BarkFineGPT, args,
           C.convert_bark_fine(state, args.n_layer, args.n_codes_total, args.n_codes_given))
    del state
    for name in ENCODEC_FILES:
        if os.path.isfile(path(name)):
            load_bark_encodec(model, path(name), device=device)
            break
    return model


def load_bark_encodec(model: Bark, path: str, device="cuda") -> Bark:
    """An EnCodec 24 kHz checkpoint (HF ``EncodecModel`` or the ``encodec``
    package's state dict) → ``model.encodec``: the decoder, the codebooks
    and, where the checkpoint holds it, the encoder; the SEANet dims are
    read off the checkpoint (``infer_encodec_dims``)."""
    from tts_tpu_torch.utils.convert import load_reference_encodec

    model.encodec = load_reference_encodec(_read_state(path), device=resolve_device(device))
    return model
