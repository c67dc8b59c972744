"""XTTS: multilingual zero-shot voice-cloning TTS (port of
``tts_tpu/models/xtts/model.py``).

Pipeline: reference audio → (GPT conditioning latents through the
perceiver, or one per coarse mel frame in the v1 layout; speaker d-vector
through the SE-ResNet) → KV-cached GPT decode of
mel codes → GPT latents → HiFi decoder → 24 kHz waveform. Streaming yields
crossfaded chunks every ``stream_chunk_size`` tokens.

PyTorch runs eagerly, so the JAX package's per-config cache of jitted
streaming functions has no counterpart here. Each streamed chunk's audio,
token ids and done flags come back to the host in one copy.
"""

from __future__ import annotations

import os
from typing import Dict, Iterator, List, Optional, Union

import numpy as np
import torch
import torch.nn as nn

from tts_tpu_torch import resolve_device
from tts_tpu_torch.audio import torch_transforms as tt
from tts_tpu_torch.audio.numpy_transforms import load_wav, resample_wav

from .config import XttsConfig
from .gpt import XttsGPT
from .hifi_decoder import HifiDecoder
from .tokenizer import VoiceBpeTokenizer

PORT_WEIGHTS = "model_torch.pt"  # the port's own state_dict file
REFERENCE_WEIGHTS = "model.pth"  # a reference-layout checkpoint


def wav_to_mel_cloning(
    wav: torch.Tensor,  # [B, T]
    mel_norms: Optional[torch.Tensor] = None,
    n_fft: int = 2048,
    hop_length: int = 256,
    win_length: int = 1024,
    sample_rate: int = 22050,
    f_min: float = 0.0,
    f_max: float = 8000.0,
    n_mels: int = 80,
) -> torch.Tensor:
    """Power-2 HTK mel, log, per-channel norm → ``[B, T_frames, n_mels]``."""
    power = tt.stft_magnitude(wav, n_fft, hop_length, win_length, center=True) ** 2
    basis = tt.mel_basis(sample_rate, n_fft, n_mels, f_min, f_max, htk=True, norm=None,
                         device=wav.device)
    mel = torch.log(torch.clamp(torch.einsum("mk,bkt->bmt", basis, power), min=1e-5))
    if mel_norms is not None:
        mel = mel / mel_norms.to(mel)[None, :, None]
    return mel.transpose(1, 2)


class Xtts(nn.Module):
    def __init__(self, config: XttsConfig):
        super().__init__()
        self.config = config
        self.args = a = config.model_args
        self.gpt = XttsGPT(
            layers=a.gpt_layers,
            model_dim=a.gpt_n_model_channels,
            heads=a.gpt_n_heads,
            number_text_tokens=a.gpt_number_text_tokens,
            num_audio_tokens=a.gpt_num_audio_tokens,
            start_audio_token=a.gpt_start_audio_token,
            stop_audio_token=a.gpt_stop_audio_token,
            start_text_token=a.gpt_start_text_token or 261,
            stop_text_token=a.gpt_stop_text_token or 0,
            max_text_tokens=a.gpt_max_text_tokens,
            max_mel_tokens=a.gpt_max_audio_tokens,
            use_perceiver_resampler=a.gpt_use_perceiver_resampler,
        )
        self.hifigan_decoder = HifiDecoder(
            input_sample_rate=a.input_sample_rate,
            output_sample_rate=a.output_sample_rate,
            output_hop_length=a.output_hop_length,
            ar_mel_length_compression=a.gpt_code_stride_len,
            decoder_input_dim=a.decoder_input_dim,
            d_vector_dim=a.d_vector_dim,
            cond_d_vector_in_each_upsampling_layer=a.cond_d_vector_in_each_upsampling_layer,
        )
        self.tokenizer = VoiceBpeTokenizer()
        self.mel_stats: Optional[torch.Tensor] = None
        self.speaker_manager: Dict[str, Dict[str, torch.Tensor]] = {}

    @classmethod
    def init_from_config(cls, config: XttsConfig):
        return cls(config)

    @property
    def device(self) -> torch.device:
        return self.gpt.mel_pos_embedding.device

    # ------------------------------------------------------------------
    @torch.no_grad()
    def init_params(self, seed: int = 0, device="cuda", dtype=torch.float32) -> "Xtts":
        """Random weights from ``seed``, drawn on ``device`` by a generator of
        that device (a CPU draw is the same on every machine; a card's differs
        from it), then cast to ``dtype``. Norm scales are 1 and biases 0;
        linear and conv weights are N(0, 1/fan_in); embeddings, the position
        tables and the perceiver latents are N(0, 0.02²)."""
        device = resolve_device(device)
        self.to(device)
        gen = torch.Generator(device).manual_seed(seed)
        norms = (nn.LayerNorm, nn.GroupNorm)
        for module in self.modules():
            for name, p in module.named_parameters(recurse=False):
                if isinstance(module, norms) or type(module).__name__ == "FoldedNorm":
                    p.fill_(1.0 if name == "weight" else 0.0)
                elif name == "bias":
                    p.zero_()
                elif name == "norm_gamma":
                    p.fill_(1.0)
                elif isinstance(module, (nn.Linear, nn.Conv1d, nn.Conv2d, nn.ConvTranspose1d)):
                    fan_in = p[0].numel() if not isinstance(module, nn.ConvTranspose1d) else (
                        p.shape[0] * p.shape[2])
                    p.copy_(torch.randn(p.shape, generator=gen, device=device) / fan_in**0.5)
                else:  # embeddings, position tables, perceiver latents
                    p.copy_(torch.randn(p.shape, generator=gen, device=device) * 0.02)
        self.requires_grad_(False).to(device=device, dtype=dtype)
        if self.args.gpt_int8_weights:
            self.quantize_weights_int8()
        return self

    def quantize_weights_int8(self, compute_dtype: Optional[torch.dtype] = None) -> None:
        """Store every GPT matmul weight of at least 4096 elements as int8
        with a per-output-channel fp32 scale (``ops/quant.py``), in place;
        the float weights are freed. The conditioning encoder, the perceiver,
        the decoder core and both heads then multiply through K4. The JAX
        package quantizes the same set (``gpt_params``)."""
        from tts_tpu_torch.ops.quant import install_int8

        install_int8(self, ("gpt",), compute_dtype)

    # ------------------------------------------------------------------
    def load_checkpoint(self, config: XttsConfig, checkpoint_dir: str, device="cuda"):
        """Load a model directory: ``vocab.json`` (BPE), weights from the
        port's ``model_torch.pt`` or a reference-layout ``model.pth``, and
        an optional ``speakers_xtts.pth`` speaker bank."""
        device = resolve_device(device)
        vocab = os.path.join(checkpoint_dir, "vocab.json")
        if os.path.isfile(vocab):
            self.tokenizer = VoiceBpeTokenizer(vocab_file=vocab)
            # the text start/stop ids come from the vocabulary
            start = self.tokenizer.tokenizer.token_to_id("[START]")
            stop = self.tokenizer.tokenizer.token_to_id("[STOP]")
            if start is not None and stop is not None:
                self.args.gpt_start_text_token = self.gpt.start_text_token = start
                self.args.gpt_stop_text_token = self.gpt.stop_text_token = stop

        port_path = os.path.join(checkpoint_dir, PORT_WEIGHTS)
        ref_path = os.path.join(checkpoint_dir, REFERENCE_WEIGHTS)
        if os.path.isfile(port_path):
            state = torch.load(port_path, map_location=device, weights_only=True)
        elif os.path.isfile(ref_path):
            from tts_tpu_torch.utils.convert import load_reference_xtts

            state = load_reference_xtts(ref_path, layers=self.args.gpt_layers,
                                        heads=self.args.gpt_n_heads)
            state = {k: v.to(device) for k, v in state.items()}
        else:
            raise FileNotFoundError(
                f"No model weights in {checkpoint_dir} (need {PORT_WEIGHTS} or {REFERENCE_WEIGHTS})"
            )
        self.load_state_dict_with_stats(state)
        del state  # the float weights go as the quantization swaps their modules

        spk_file = os.path.join(checkpoint_dir, "speakers_xtts.pth")
        if os.path.isfile(spk_file):
            table = torch.load(spk_file, map_location=device, weights_only=True)
            for name, entry in table.items():
                self.speaker_manager[name] = {
                    "gpt_cond_latent": entry["gpt_cond_latent"].to(self.gpt.dtype),
                    "speaker_embedding": entry["speaker_embedding"].reshape(1, -1).to(
                        self.hifigan_decoder.dtype),
                }
        if self.args.gpt_int8_weights:
            self.quantize_weights_int8()
        return self

    def load_state_dict_with_stats(self, state: Dict[str, torch.Tensor]) -> None:
        """Take the tensors as they are (device and dtype: a bf16 GPT stays
        bf16); an optional ``mel_stats`` entry holds the cloning-mel norms."""
        state = dict(state)
        mel_stats = state.pop("mel_stats", None)
        self.load_state_dict(state, strict=True, assign=True)
        self.requires_grad_(False)  # inference only
        self.mel_stats = mel_stats if mel_stats is not None and mel_stats.numel() else None

    def state_dict_with_stats(self) -> Dict[str, torch.Tensor]:
        state = self.state_dict()
        if self.mel_stats is not None:
            state["mel_stats"] = self.mel_stats
        return state

    # ------------------------------------------------------------------
    @torch.no_grad()
    def get_gpt_cond_latents(
        self, audio: np.ndarray, sr: int, length: int = 30, chunk_length: int = 6
    ) -> torch.Tensor:
        """Reference audio → GPT conditioning latents: ``[1, 32, D]``, the
        mean over ``chunk_length``-second chunks; in the v1 layout (no
        perceiver) one coarse mel over the whole clip (``n_fft`` 4096, hop
        1024), each frame a latent ``[1, T, D]``, as the JAX package does."""
        if sr != 22050:
            audio = resample_wav(audio, sr, 22050)
        if length > 0:
            audio = audio[: 22050 * length]
        dev = self.device
        if not self.args.gpt_use_perceiver_resampler:
            mel = wav_to_mel_cloning(torch.as_tensor(audio, device=dev)[None],
                                     mel_norms=self.mel_stats, n_fft=4096, hop_length=1024,
                                     win_length=4096)
            return self.gpt.get_style_emb(mel)
        style_embs = []
        step = 22050 * chunk_length
        for i in range(0, len(audio), step):
            chunk = audio[i : i + step]
            if len(chunk) < 22050 * 0.33:
                continue
            mel = wav_to_mel_cloning(torch.as_tensor(chunk, device=dev)[None],
                                     mel_norms=self.mel_stats)
            style_embs.append(self.gpt.get_style_emb(mel))
        if not style_embs:
            raise ValueError("Reference audio too short for conditioning.")
        return torch.stack(style_embs).mean(dim=0)

    @torch.no_grad()
    def get_speaker_embedding(self, audio: np.ndarray, sr: int) -> torch.Tensor:
        """Reference audio → speaker d-vector ``[1, 512]``."""
        audio_16k = torch.as_tensor(resample_wav(audio, sr, 16000), device=self.device)
        mel = tt.wav_to_mel(audio_16k[None], n_fft=512, num_mels=64, sample_rate=16000,
                            hop_length=160, win_length=400, fmax=8000.0, center=True)
        # the speaker encoder applies its own log: undo the log-mel here
        feats = torch.exp(mel).transpose(1, 2)
        return self.hifigan_decoder.embed_speaker(feats)

    def get_conditioning_latents(
        self,
        audio_path: Union[str, List[str]],
        max_ref_length: int = 30,
        gpt_cond_len: int = 30,
        gpt_cond_chunk_len: int = 6,
        sound_norm_refs: bool = False,
        load_sr: int = 22050,
    ):
        """Reference wav path(s) → (GPT conditioning latents, speaker embedding)."""
        paths = [audio_path] if isinstance(audio_path, str) else audio_path
        speaker_embs, audios = [], []
        for path in paths:
            audio = load_wav(filename=path, sample_rate=load_sr, resample=True)
            audio = audio[: load_sr * max_ref_length]
            if sound_norm_refs:
                audio = (audio / np.abs(audio).max()) * 0.75
            speaker_embs.append(self.get_speaker_embedding(audio, load_sr))
            audios.append(audio)
        gpt_cond_latent = self.get_gpt_cond_latents(
            np.concatenate(audios), load_sr, length=gpt_cond_len, chunk_length=gpt_cond_chunk_len
        )
        return gpt_cond_latent, torch.stack(speaker_embs).mean(dim=0)

    def resolve_conditioning(self, config, speaker_id: Optional[str] = None, speaker_wav=None):
        """A known ``speaker_id`` resolves through the speaker bank, otherwise
        ``speaker_wav`` is encoded. Returns ``(gpt_cond_latent [1,L,D],
        speaker_embedding [1,512])``."""
        if speaker_wav is None and speaker_id is not None:
            if speaker_id not in self.speaker_manager:
                raise ValueError(
                    f" [!] Unknown XTTS speaker {speaker_id!r}; known: "
                    f"{sorted(self.speaker_manager)[:16]}…"
                )
            entry = self.speaker_manager[speaker_id]
            return entry["gpt_cond_latent"], entry["speaker_embedding"]
        if speaker_wav is None:
            raise ValueError(
                " [!] XTTS needs a `speaker_wav` reference clip (or a known "
                "`speaker_id` from speakers_xtts.pth) for voice cloning."
            )
        return self.get_conditioning_latents(
            speaker_wav,
            gpt_cond_len=config.gpt_cond_len,
            gpt_cond_chunk_len=config.gpt_cond_chunk_len,
            max_ref_length=config.max_ref_len,
            sound_norm_refs=config.sound_norm_refs,
        )

    # ------------------------------------------------------------------
    def _generator(self, generator: Optional[torch.Generator]) -> torch.Generator:
        return generator if generator is not None else torch.Generator(self.device).manual_seed(0)

    def _text_batch(self, texts: List[str], language: str):
        rows = [self.tokenizer.encode(t, language) for t in texts]
        T = max(len(r) for r in rows)
        if T >= self.args.gpt_max_text_tokens:
            raise ValueError("XTTS can only process ~250 characters per call; split the text.")
        tokens = torch.tensor([r + [0] * (T - len(r)) for r in rows], dtype=torch.int64,
                              device=self.device)
        lengths = torch.tensor([len(r) for r in rows], dtype=torch.int64, device=self.device)
        return tokens, lengths

    @torch.no_grad()
    def inference(
        self,
        text: str,
        language: str,
        gpt_cond_latent: torch.Tensor,
        speaker_embedding: torch.Tensor,
        temperature: float = 0.75,
        top_k: int = 50,
        top_p: float = 0.85,
        repetition_penalty: float = 5.0,
        max_new_tokens: Optional[int] = None,
        generator: Optional[torch.Generator] = None,
    ) -> Dict[str, np.ndarray]:
        """Full (non-streaming) synthesis. The latents come from the decode
        itself (no second, teacher-forced GPT pass)."""
        tokens, lengths = self._text_batch([text], language)
        gen = self.gpt.generate(
            gpt_cond_latent, tokens, lengths, self._generator(generator),
            max_new_tokens=max_new_tokens or self.gpt.max_mel_tokens - 3,
            temperature=temperature, top_k=top_k, top_p=top_p,
            repetition_penalty=repetition_penalty,
        )
        latents = gen["latents"]
        wav = self.hifigan_decoder(latents, speaker_embedding)
        samples_per_code = wav.shape[1] // latents.shape[1]
        codes, code_len = gen["codes"].cpu().numpy(), gen["code_lengths"].cpu().numpy()
        wav = wav[0, : int(code_len[0]) * samples_per_code, 0].float().cpu().numpy()
        return {"wav": wav, "gpt_codes": codes, "code_lengths": code_len}

    def inference_stream(
        self,
        text: str,
        language: str,
        gpt_cond_latent: torch.Tensor,
        speaker_embedding: torch.Tensor,
        stream_chunk_size: int = 20,
        overlap_wav_len: int = 1024,
        max_new_tokens: Optional[int] = None,
        generator: Optional[torch.Generator] = None,
        temperature: float = 0.75,
        top_k: int = 50,
        top_p: float = 0.85,
        repetition_penalty: float = 5.0,
    ) -> Iterator[np.ndarray]:
        """Incremental streaming: prefill once, then decode
        ``stream_chunk_size`` tokens at a time, vocode each chunk and yield
        crossfaded audio. The one-stream case of
        :meth:`inference_stream_batched`."""
        for chunks in self.inference_stream_batched(
            [text], language, gpt_cond_latent, speaker_embedding,
            stream_chunk_size=stream_chunk_size, overlap_wav_len=overlap_wav_len,
            max_new_tokens=max_new_tokens, generator=generator, temperature=temperature,
            top_k=top_k, top_p=top_p, repetition_penalty=repetition_penalty,
        ):
            if chunks[0] is not None:
                yield chunks[0]

    @torch.no_grad()
    def inference_stream_batched(
        self,
        texts: List[str],
        language: str,
        gpt_cond_latent: torch.Tensor,  # [1|B, L, D]
        speaker_embedding: torch.Tensor,  # [1|B, 512]
        stream_chunk_size: int = 20,
        overlap_wav_len: int = 1024,
        max_new_tokens: Optional[int] = None,
        generator: Optional[torch.Generator] = None,
        temperature: float = 0.75,
        top_k: int = 50,
        top_p: float = 0.85,
        repetition_penalty: float = 5.0,
    ) -> Iterator[List[Optional[np.ndarray]]]:
        """Decode B utterances in one KV-cached batch (the weight reads of
        each step are shared). Yields one list per chunk: item i is stream
        i's crossfaded audio chunk, or None once that stream has finished."""
        B = len(texts)
        tokens, lengths = self._text_batch(texts, language)
        cond = gpt_cond_latent.expand(B, *gpt_cond_latent.shape[1:])
        spk = speaker_embedding.expand(B, *speaker_embedding.shape[1:])
        # at most the non-streaming bound; the last chunk is cut short rather
        # than rounded up, so no mel position passes the table
        max_new = max_new_tokens or self.gpt.max_mel_tokens - 3
        generator = self._generator(generator)
        stop_tok = float(self.gpt.stop_audio_token)

        state = self.gpt.prefill(cond, tokens, lengths, max_new_tokens=max_new)
        tails: List[Optional[np.ndarray]] = [None] * B
        finished = [False] * B
        for first in range(0, max_new, stream_chunk_size):
            chunk_size = min(stream_chunk_size, max_new - first)
            state, toks, latents = self.gpt.decode_chunk(
                state, generator, chunk_size=chunk_size, temperature=temperature,
                top_k=top_k, top_p=top_p, repetition_penalty=repetition_penalty,
            )
            wav = self.hifigan_decoder(latents, spk)
            # one device→host copy per chunk: audio, token ids (exact in fp32),
            # done flags
            packed = torch.cat(
                [wav[:, :, 0].float(), toks.float(), state["done"][:, None].float()], dim=1
            ).cpu().numpy()
            wavs = packed[:, : -chunk_size - 1]
            toks_np = packed[:, -chunk_size - 1 : -1]
            done_np = packed[:, -1] > 0.5
            samples_per_code = wavs.shape[1] // latents.shape[1]
            out: List[Optional[np.ndarray]] = []
            for i in range(B):
                n_valid = int(np.sum(toks_np[i] != stop_tok))
                if finished[i] or n_valid == 0:
                    finished[i] = True
                    out.append(None)
                    continue
                chunk = wavs[i, : n_valid * samples_per_code].copy()
                if tails[i] is not None and len(chunk) >= overlap_wav_len:
                    fade = np.linspace(0, 1, overlap_wav_len, dtype=np.float32)
                    chunk[:overlap_wav_len] = chunk[:overlap_wav_len] * fade + tails[i] * (1 - fade)
                tails[i] = chunk[-overlap_wav_len:].copy() if len(chunk) >= overlap_wav_len else None
                out.append(chunk)
                finished[i] = bool(done_np[i])
            if any(c is not None for c in out):
                yield out
            if all(finished):
                break

    # ------------------------------------------------------------------
    def synthesize(self, text: str, config, speaker_wav=None, language: str = "en",
                   speaker_id: Optional[str] = None, **kwargs):
        gpt_cond_latent, speaker_embedding = self.resolve_conditioning(
            config, speaker_id=speaker_id, speaker_wav=speaker_wav
        )
        return self.inference(
            text, language, gpt_cond_latent, speaker_embedding,
            temperature=config.temperature, top_k=config.top_k, top_p=config.top_p,
            repetition_penalty=config.repetition_penalty, **kwargs,
        )

    def synthesize_stream(self, text: str, config, speaker_wav=None, language: str = "en",
                          speaker_id: Optional[str] = None, stream_chunk_size: int = 20,
                          **kwargs) -> Iterator[np.ndarray]:
        """Streaming twin of :meth:`synthesize`."""
        gpt_cond_latent, speaker_embedding = self.resolve_conditioning(
            config, speaker_id=speaker_id, speaker_wav=speaker_wav
        )
        return self.inference_stream(
            text, language, gpt_cond_latent, speaker_embedding,
            stream_chunk_size=stream_chunk_size, temperature=config.temperature,
            top_k=config.top_k, top_p=config.top_p,
            repetition_penalty=config.repetition_penalty, **kwargs,
        )
