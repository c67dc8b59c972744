"""Synthesizer: load a model once, render text many times (port of
``tts_tpu/utils/synthesizer.py`` for XTTS, VITS, DelightfulTTS, and
GlowTTS, Tacotron2, the ForwardTTS family, Overflow, NeuralHMM and AlignTTS
with a vocoder).

A model loads from a directory (``config.json`` plus weights: the port's
``model_torch.pt`` or a reference-layout ``model.pth``; XTTS also needs its
``vocab.json``) or, for the others (``FILE_MODELS``), from a checkpoint
file and its ``config.json``. A vocoder (``vocoder_checkpoint`` with its
``vocoder_config``: any generator of ``vocoder.models``, the port's
state_dict or a reference-layout checkpoint, which the iSTFT generator has
not) turns a mel model's output into audio; a mel
model without one speaks through Griffin-Lim (``use_griffin_lim``, on by
default, as in the JAX package), on the host.

Models with their own ``synthesize`` (XTTS) render each sentence through
it. For the waveform models (VITS), a request of two or more sentences is
decoded as one sequence-packed grid
(:func:`~tts_tpu_torch.utils.synthesis.decode_packed`), and a single
sentence through :func:`~tts_tpu_torch.utils.synthesis.synthesis`;
DelightfulTTS, which speaks through its joint vocoder (ROADMAP.md F28),
decodes sentence by sentence. A mel model (GlowTTS, Tacotron2, ForwardTTS,
Overflow, NeuralHMM, AlignTTS) decodes sentence by sentence, and each mel goes
to the vocoder through the bridge of ``_vocode``: denormalised with the TTS
model's ``AudioProcessor``, normalised with the vocoder's, resampled in time
when the two sample rates differ, then ``generator.inference`` on the
model's device. The output sample rate is then the vocoder's.
The JAX package's ``Synthesizer`` gates its packed path on ``not use_gl``
as well, which its default ``use_griffin_lim=True`` makes false for a
vocoder-less VITS, so by default it decodes sentence by sentence; the port
takes the packed path that gate was meant to allow (ROADMAP.md F1). An
error in the packed decode reaches the caller: there is no fallback to the
serial loop.

A model loaded from a checkpoint file has each sentence cut at its first
long quiet stretch when its audio config has ``do_trim_silence`` on, as
the JAX package's does (:func:`~tts_tpu_torch.utils.synthesis.trim_silence`,
with the TTS model's ``AudioProcessor``); one loaded from a model directory
is not trimmed. A VITS config's audio section (``VitsAudioConfig``) has no
such field, so VITS is trimmed by neither package, nor is DelightfulTTS
(``DelightfulTtsAudioConfig``); the mel models' (``BaseAudioConfig``) have
it on by default.

Speakers and languages of a VITS or ForwardTTS model are named through its
managers (``utils/managers.py``), with the JAX ``Synthesizer``'s errors: an
unknown name, no speaker for a multi-speaker model or no language for a
multi-language model raise ``ValueError``; a manager of one entry is taken
when none is named. ``speakers_file_path`` and ``language_ids_file_path``
override the config's files, on its top level and in ``model_args``. A model
without a speaker (or language) manager takes no speaker (or language)
name.

``speaker_wav`` (a clip, or a list of clips) clones a voice with a d-vector
model (YourTTS): the speaker encoder of ``encoder_checkpoint`` and
``encoder_config`` computes its d-vector (``SpeakerManager.
compute_embedding_from_clip``), which takes the place of a named speaker.
Without an encoder the request raises ``ValueError`` naming
``--encoder_path`` and ``encoder_path=``; the JAX ``Synthesizer`` decodes it
without any speaker conditioning (ROADMAP.md F22). A zoo directory that
holds the reference's speaker encoder (``model_se.pth.tar`` or
``model_se.pth``, with ``config_se.json``), to which the model manager has
pointed ``model_args.speaker_encoder_model_path`` and
``speaker_encoder_config_path``, loads that encoder when none is given; the
JAX package loads none there (F23). Those config paths are read only when
they name files in the model's own directory: otherwise they point at the
trainer's disk. An encoder given to a model whose speakers are not
d-vectors raises.

``tts(reference_wav=..., speaker_name=..., reference_speaker_name=...)``
transfers a recording spoken by one of a multi-speaker VITS model's
speakers into another's voice (``Vits.voice_conversion``). The posterior
encoder is fed the VITS linear magnitude spectrogram (``wav_to_spec``:
``center=False``, reflect padding of ``(n_fft - hop) / 2``,
``sqrt(|X|² + 1e-6)``), which the reference's voice conversion and every
reference-layout checkpoint's training use. The JAX ``Synthesizer`` feeds it
its ``AudioProcessor``'s spectrogram instead (centred STFT, decibels,
normalised), which is not what the encoder was trained on (ROADMAP.md F15).

``vc_checkpoint`` (with ``vc_config``) loads a voice-conversion model, FreeVC
(port of ``tts_tpu/utils/synthesizer.py:154-169,512-519``): a reference-layout
``model.pth`` or the port's ``model_torch.pt``. :meth:`Synthesizer.voice_conversion` converts a source
wav into a target wav's voice through it, WavLM-Large read from
``$TTS_HOME/wavlm/WavLM-Large.pt`` on first use, and sets
``output_sample_rate`` to the VC config's ``audio.output_sample_rate``.
"""

from __future__ import annotations

import os
import re
import time
from typing import List, Optional

import numpy as np
import torch

from tts_tpu_torch import resolve_device
from tts_tpu_torch.audio.numpy_transforms import load_wav, resample_wav, save_wav
from tts_tpu_torch.audio.processor import AudioProcessor
from tts_tpu_torch.audio.torch_transforms import wav_to_spec
from tts_tpu_torch.config import read_json_with_comments
from tts_tpu_torch.models import config_from_dict, setup_model
from tts_tpu_torch.vocoder.models.wavegrad import compute_noise_schedule, wavegrad_inference
from tts_tpu_torch.vocoder.utils import interpolate_vocoder_input, make_generator_from_config
from tts_tpu_torch.utils.synthesis import (
    _frame_budget,
    aux_input,
    decode_packed,
    synthesis,
    trim_silence,
)

_SENTENCE_RE = re.compile(r"(?<=[.!?;:])\s+(?=[^\s])")
SENTENCE_GAP = 10000  # zero samples after each sentence (reference synthesizer.py:441)


def split_into_sentences(text: str) -> List[str]:
    """Split after sentence punctuation followed by whitespace."""
    text = text.strip()
    if not text:
        return []
    return [p.strip() for p in _SENTENCE_RE.split(text) if p.strip()]


_NO_ENCODER = ("speaker_wav needs a speaker encoder to compute its d-vector: load one with "
               "--encoder_path and --encoder_config_path (TTS(encoder_path=..., "
               "encoder_config_path=...)); without it the JAX package decodes with no speaker "
               "(ROADMAP.md F22)")
# models that load from a checkpoint file and its config.json
FILE_MODELS = ("vits", "glow_tts", "tacotron2", "tacotron", "fast_pitch", "fast_speech",
               "fastspeech2", "speedy_speech", "forward_tts", "overflow", "neuralhmm_tts",
               "align_tts", "delightful_tts")


class Synthesizer:
    def __init__(self, tts_checkpoint: str = "", tts_config_path: str = "", model_dir: str = "",
                 device="cuda", speakers_file_path: str = "", language_ids_file_path: str = "",
                 vocoder_checkpoint: str = "", vocoder_config: str = "",
                 use_griffin_lim: bool = True, encoder_checkpoint: str = "",
                 encoder_config: str = "", vc_checkpoint: str = "", vc_config: str = ""):
        self.device = resolve_device(device)
        self.speakers_file_path = speakers_file_path
        self.language_ids_file_path = language_ids_file_path
        self.use_griffin_lim = use_griffin_lim
        self.tts_model = None
        self.tts_config = None
        self.ap = None  # the TTS model's AudioProcessor (not for XTTS)
        self.vocoder_model = None
        self.vocoder_config = None
        self.vocoder_ap = None
        self.vc_model = None
        self.vc_config = None
        self.from_file = False  # loaded from a checkpoint file: may trim silence
        self.output_sample_rate = 24000
        path = model_dir or tts_checkpoint
        if path:
            self._load_tts(path, self._config_path(path, tts_config_path))
            self._load_encoder(path, encoder_checkpoint, encoder_config)
        if vocoder_checkpoint:
            if self.tts_config is not None and self.tts_config.model == "tacotron":
                raise NotImplementedError(
                    "Tacotron v1 emits a linear spectrogram, which a mel vocoder cannot take: "
                    "leave the vocoder out, and Griffin-Lim speaks it (ROADMAP.md F40)")
            self._load_vocoder(vocoder_checkpoint,
                               self._config_path(vocoder_checkpoint, vocoder_config))
        if vc_checkpoint:
            self._load_vc(vc_checkpoint, self._config_path(vc_checkpoint, vc_config))

    @staticmethod
    def _config_path(path: str, config_path: str) -> str:
        """``config_path``, or a directory's ``config.json``."""
        if config_path:
            return config_path
        if not os.path.isdir(path):
            raise ValueError(f"the checkpoint file {path} needs its config.json")
        return os.path.join(path, "config.json")

    def _load_tts(self, path: str, config_path: str) -> None:
        """A model directory, or a checkpoint file of ``FILE_MODELS`` with
        its config."""
        config = config_from_dict(read_json_with_comments(config_path))
        for target in (config, getattr(config, "model_args", None)):
            if self.speakers_file_path and hasattr(target, "speakers_file"):
                target.speakers_file = self.speakers_file_path
            if self.language_ids_file_path and hasattr(target, "language_ids_file"):
                target.language_ids_file = self.language_ids_file_path
        # build on the meta device: the checkpoint's tensors are assigned,
        # so nothing is allocated twice
        with torch.device("meta"):
            model = setup_model(config)
        if os.path.isdir(path):
            model = model.load_checkpoint(config, checkpoint_dir=path, device=self.device)
        elif config.model in FILE_MODELS:
            model = model.load_checkpoint(config, checkpoint_path=path, device=self.device)
        else:
            raise ValueError(f"{config.model!r} loads from a model directory, not a file")
        self.tts_model = model
        self.tts_config = config  # as loaded, as the JAX package keeps it (/details shows it)
        self.from_file = not os.path.isdir(path)
        if config.model != "xtts":
            self.ap = AudioProcessor.init_from_config(config.audio, verbose=False)
        self.output_sample_rate = (
            getattr(getattr(config, "model_args", None), "output_sample_rate", None)
            or config.audio.sample_rate)

    def _load_encoder(self, path: str, checkpoint: str, config_path: str) -> None:
        """The speaker encoder for ``speaker_wav``: ``checkpoint`` with its
        config, or else the one the model's config names inside the model's
        own directory (a zoo directory, F23)."""
        if not checkpoint:
            args = getattr(self.tts_config, "model_args", None)
            home = os.path.abspath(path if os.path.isdir(path) else os.path.dirname(path))
            found = [getattr(args, f, None) or "" for f in ("speaker_encoder_model_path",
                                                            "speaker_encoder_config_path")]
            if not all(os.path.isfile(f) and os.path.dirname(os.path.abspath(f)) == home
                       for f in found):
                return
            checkpoint, config_path = found
        if not getattr(self.tts_model, "uses_d_vectors", False):
            raise ValueError(f"{self.tts_config.model!r} takes no speaker encoder: its speakers "
                             f"are not d-vectors")
        self.tts_model.speaker_manager.init_encoder(checkpoint, config_path, device=self.device)

    def _load_vocoder(self, path: str, config_path: str) -> None:
        """A vocoder checkpoint file with its config: the generator its
        config names, its own
        ``AudioProcessor`` for the bridge, and its sample rate for the
        output (port of ``tts_tpu/utils/synthesizer.py:131-152``)."""
        config = config_from_dict(read_json_with_comments(config_path))
        if not hasattr(config, "generator_model"):
            raise ValueError(f"{config_path} is not a vocoder config (model {config.model!r})")
        with torch.device("meta"):
            generator = make_generator_from_config(config)
        state = torch.load(path, map_location="cpu", weights_only=True)
        if isinstance(state, dict) and "model" in state:
            state = state["model"]
        if not set(state) >= set(generator.state_dict()):
            from tts_tpu_torch.utils.convert import load_reference_vocoder

            state = load_reference_vocoder(state, config)
        generator.load_state_dict({k: v.to(self.device) for k, v in state.items()}, strict=True,
                                  assign=True)
        self.vocoder_model = generator.eval().requires_grad_(False)
        self.vocoder_config = config
        self.vocoder_ap = AudioProcessor.init_from_config(config.audio, verbose=False)
        self.output_sample_rate = self.vocoder_ap.sample_rate

    def _load_vc(self, path: str, config_path: str) -> None:
        """A voice-conversion checkpoint file with its config: the model its
        ``model`` names (``vc.models.setup_model``; FreeVC)."""
        from tts_tpu_torch.vc.models import setup_model as setup_vc_model

        config = config_from_dict(read_json_with_comments(config_path))
        with torch.device("meta"):
            model = setup_vc_model(config)
        self.vc_model = model.load_checkpoint(config, checkpoint_path=path, device=self.device)
        self.vc_config = config

    def voice_conversion(self, source_wav: str, target_wav) -> List[float]:
        """``source_wav`` spoken in the voice of ``target_wav`` (a path, or a
        list whose first path is taken) through the loaded VC model
        (reference ``synthesizer.py:250``); the output sample rate becomes
        the VC config's ``audio.output_sample_rate``."""
        if self.vc_model is None:
            raise RuntimeError("No voice-conversion model loaded (vc_checkpoint).")
        wav = self.vc_model.voice_conversion_from_files(source_wav, target_wav)
        self.output_sample_rate = self.vc_config.audio.output_sample_rate
        return list(np.asarray(wav, np.float32).reshape(-1))

    @torch.no_grad()
    def _vocode(self, mel: np.ndarray) -> np.ndarray:
        """A TTS model's normalised mel ``[T, C]`` → waveform through the
        vocoder: back to decibels with the TTS model's processor, normalised
        with the vocoder's, resampled in time when the rates differ, then on
        the device ``generator.inference``, WaveGrad's reverse diffusion over
        its ``test_noise_schedule`` (50 steps by default) or WaveRNN's
        ``generate`` (port of ``tts_tpu/utils/synthesizer.py:223-262``). The
        vocoders that draw noise draw it from a generator on the device
        seeded 0 at each call, as the JAX package keys each call with
        ``PRNGKey(0)``; ParallelWaveGAN's and UnivNet's ``inference``, which
        the JAX modules lack, are the port's (ROADMAP.md F31)."""
        voc_in = self.vocoder_ap.normalize(self.ap.denormalize(mel.T))  # [C, T]
        scale_factor = self.vocoder_ap.sample_rate / self.ap.sample_rate
        if scale_factor != 1.0:
            print(" > interpolating tts model output.")
            voc_in = interpolate_vocoder_input([1, scale_factor], voc_in)
        c = torch.from_numpy(np.ascontiguousarray(voc_in.T[None], np.float32)).to(self.device)
        name = self.vocoder_config.generator_model.lower()
        if name == "wavegrad":
            sched = getattr(self.vocoder_config, "test_noise_schedule", None) or {}
            schedule = compute_noise_schedule(int(sched.get("num_steps", 50)),
                                              float(sched.get("min_val", 1e-6)),
                                              float(sched.get("max_val", 1e-2)))
            wav = wavegrad_inference(self.vocoder_model, c, schedule)
        elif name == "wavernn":
            wav = self.vocoder_model.generate(c)
        else:
            wav = self.vocoder_model.inference(c)
        return wav.float().cpu().numpy().reshape(-1)

    # ------------------------------------------------------------------
    def tts(
        self,
        text: str = "",
        speaker_name: Optional[str] = None,
        language_name: Optional[str] = None,
        speaker_wav=None,
        style_wav=None,
        style_text: Optional[str] = None,
        reference_wav=None,
        reference_speaker_name: Optional[str] = None,
        split_sentences: bool = True,
        **kwargs,
    ) -> List[float]:
        """Text → waveform samples, with 10000 zero samples after each
        sentence; or, with ``reference_wav``, that recording of
        ``reference_speaker_name`` in the voice of ``speaker_name``.
        ``style_wav`` (a path or samples) and ``style_text`` style a GST or
        Capacitron model, sentence by sentence; other models ignore them,
        as in the JAX package."""
        start = time.time()
        if not text and not reference_wav:
            raise ValueError("You need to define either `text` (for synthesis) or a "
                             "`reference_wav` (for voice conversion) to use the TTS API.")
        if reference_wav is not None:
            wavs = self._voice_transfer(reference_wav, speaker_name, reference_speaker_name)
        else:
            sens = split_into_sentences(text) if split_sentences else [text.strip()]
            if not sens:
                raise ValueError("No text to speak.")
            wavs = self._tts_sentences(sens, speaker_name, language_name, speaker_wav,
                                       style_wav=style_wav, style_text=style_text, **kwargs)
        process_time = time.time() - start
        audio_time = len(wavs) / self.output_sample_rate
        print(f" > Processing time: {process_time}")
        print(f" > Real-time factor: {process_time / max(audio_time, 1e-9)}")
        return wavs

    def _tts_sentences(self, sens: List[str], speaker_name, language_name, speaker_wav,
                       style_wav=None, style_text=None, **kwargs) -> List[float]:
        model = self.tts_model
        wavs: List[float] = []
        if hasattr(model, "synthesize"):
            for sen in sens:
                outputs = model.synthesize(
                    text=sen, config=self.tts_config, speaker_id=speaker_name,
                    speaker_wav=speaker_wav, language=language_name or "en", **kwargs,
                )
                wavs += list(np.asarray(outputs["wav"], np.float32))
                wavs += [0] * SENTENCE_GAP
            return wavs
        given = sorted(k for k, v in kwargs.items() if v is not None)
        if given:
            raise ValueError(f"{self.tts_config.model!r} takes no {', '.join(given)}")
        speaker_id, d_vector = self._resolve_speaker(speaker_name, speaker_wav)
        language_id = self._resolve_language(language_name)
        styled = style_wav is not None or style_text is not None
        if len(sens) > 1 and getattr(model, "supports_packed_decode", False) and not styled:
            pieces = self._tts_sentences_packed(sens, speaker_id, d_vector, language_id)
        else:
            language = self._language_name(language_id)
            use_gl = self.vocoder_model is None and self.use_griffin_lim
            pieces = []
            for sen in sens:
                out = synthesis(model, sen, speaker_id, d_vector, language_id, language,
                                use_griffin_lim=use_gl, ap=self.ap, style_wav=style_wav,
                                style_text=style_text)
                if out["wav"] is not None:
                    pieces.append(out["wav"])
                elif self.vocoder_model is not None:
                    pieces.append(self._vocode(out["model_outputs"]))
                else:
                    raise RuntimeError("No vocoder or Griffin-Lim available.")
        trim = self.from_file and getattr(self.tts_config.audio, "do_trim_silence", False)
        for wav in pieces:
            if trim:
                wav = trim_silence(wav, self.ap)
            wavs += list(wav)
            wavs += [0] * SENTENCE_GAP
        return wavs

    def _voice_transfer(self, reference_wav: str, speaker_name: Optional[str],
                        reference_speaker_name: Optional[str]) -> List[float]:
        """``reference_wav``, spoken by ``reference_speaker_name``, in the
        voice of ``speaker_name`` (port of ``tts_tpu/utils/synthesizer.py:473-509``):
        the wav at the model's rate (at ``encoder_sample_rate`` where the
        model has one), its VITS linear spectrogram, ``Vits.voice_conversion``.
        Both names are required; d-vector models take each speaker's mean
        d-vector."""
        model = self.tts_model
        if not hasattr(model, "voice_conversion"):
            raise NotImplementedError(f"Model {self.tts_config.model!r} has no voice_conversion "
                                      f"path.")
        if speaker_name is None or reference_speaker_name is None:
            raise ValueError(" [!] Voice transfer needs both `speaker_name` (target) and "
                             "`reference_speaker_name` (source).")
        audio = self.tts_config.audio
        wav = load_wav(filename=reference_wav, sample_rate=audio.sample_rate, resample=True)
        enc_sr = model.args.encoder_sample_rate
        if enc_sr and enc_sr != audio.sample_rate:
            wav = resample_wav(wav, audio.sample_rate, enc_sr)
        y = torch.from_numpy(np.asarray(wav, np.float32)[None]).to(model.device)
        spec = wav_to_spec(y, audio.fft_size, audio.hop_length, audio.win_length)  # [1, C, T]
        y_lengths = torch.tensor([spec.shape[2]], device=model.device)

        def speaker(name):
            speaker_id, d_vector = self._resolve_speaker(name)
            return torch.from_numpy(d_vector[None]) if d_vector is not None else \
                torch.tensor([speaker_id])

        out = model.voice_conversion(spec.transpose(1, 2), y_lengths,
                                     speaker(reference_speaker_name), speaker(speaker_name))
        return list(out.reshape(-1).float().cpu().numpy())

    # ------------------------------------------------------------------
    def _resolve_speaker(self, speaker_name: Optional[str], speaker_wav=None):
        """A speaker name, or a ``speaker_wav`` through the speaker encoder,
        → ``(speaker_id, d_vector)``, one of them ``None`` (both for a model
        without speakers), with the JAX ``Synthesizer``'s errors; a
        ``speaker_wav`` without an encoder raises (ROADMAP.md F22)."""
        sm = getattr(self.tts_model, "speaker_manager", None)
        if speaker_wav is not None:
            if getattr(sm, "encoder", None) is None:
                raise ValueError(_NO_ENCODER)
            return None, np.asarray(sm.compute_embedding_from_clip(speaker_wav), np.float32)
        if sm is None or not sm.name_to_id:
            if speaker_name is not None:
                raise ValueError(f"{self.tts_config.model!r} is a single-speaker model "
                                 f"(no speakers file): speaker_name not taken")
            return None, None
        if speaker_name is None:
            if len(sm.name_to_id) != 1:
                raise ValueError(" [!] Looks like you are using a multi-speaker model. "
                                 "You need to define either a `speaker_idx` or a `speaker_wav`.")
            speaker_name = next(iter(sm.name_to_id))
        if speaker_name not in sm.name_to_id:
            raise ValueError(f" [!] Speaker {speaker_name!r} not in the available "
                             f"speakers: {sorted(sm.name_to_id)[:16]}…")
        if self.tts_model.uses_d_vectors:
            return None, np.asarray(sm.get_mean_embedding(speaker_name), np.float32)
        return sm.name_to_id[speaker_name], None

    def _resolve_language(self, language_name: Optional[str]) -> Optional[int]:
        """A language name → its id (``None`` for a model without languages),
        with the JAX ``Synthesizer``'s errors."""
        lm = getattr(self.tts_model, "language_manager", None)
        if lm is None or not lm.name_to_id:
            if language_name is not None:
                raise ValueError(f"{self.tts_config.model!r} is a single-language model "
                                 f"(no language ids file): language_name not taken")
            return None
        if len(lm.name_to_id) == 1:
            return next(iter(lm.name_to_id.values()))
        if language_name is None:
            raise ValueError(" [!] Looks like you are using a multi-lingual model. "
                             "You need to define a `language_name`.")
        if language_name not in lm.name_to_id:
            raise ValueError(f" [!] Language {language_name!r} is not in the available "
                             f"languages: {sorted(lm.name_to_id)}.")
        return lm.name_to_id[language_name]

    def _language_name(self, language_id: Optional[int]) -> Optional[str]:
        """The name of ``language_id`` (``None`` for none), for the tokenizer:
        a ``multi_phonemizer`` picks its phonemizer by it."""
        if language_id is None:
            return None
        lm = self.tts_model.language_manager
        return next(name for name, i in lm.name_to_id.items() if i == language_id)

    def _tts_sentences_packed(self, sens: List[str], speaker_id=None, d_vector=None,
                              language_id=None) -> List[np.ndarray]:
        """All sentences of a request in one packed decode: one row of ids
        per sentence, padded to a multiple of ``pad_to_multiple_text``, at
        the frame budget of the padded width, as the JAX package pads
        them; every row takes the request's speaker and language."""
        model = self.tts_model
        language = self._language_name(language_id)
        rows = [model.tokenizer.text_to_ids(sen, language) for sen in sens]
        bucket = int(getattr(self.tts_config, "pad_to_multiple_text", 16) or 16)
        width = max(max(len(r) for r in rows), 1)
        width = ((width + bucket - 1) // bucket) * bucket
        ids = np.zeros((len(rows), width), np.int64)
        lengths = np.ones((len(rows),), np.int64)
        for i, r in enumerate(rows):
            ids[i, : len(r)] = r
            lengths[i] = max(1, len(r))
        x = torch.from_numpy(ids).to(model.device)
        x_lengths = torch.from_numpy(lengths).to(model.device)
        aux = aux_input(model.device, len(rows), speaker_id, d_vector, language_id)
        return decode_packed(model, x, x_lengths, len(rows), _frame_budget(width), aux)

    def tts_stream(
        self,
        text: str,
        speaker_name: Optional[str] = None,
        language_name: Optional[str] = None,
        speaker_wav=None,
        split_sentences: bool = True,
        **kwargs,
    ):
        """Yield float32 audio chunks as they decode, sentence by sentence
        (streaming models only, XTTS)."""
        if not hasattr(self.tts_model, "synthesize_stream"):
            raise NotImplementedError(
                f"Model {self.tts_config.model!r} has no streaming path; use tts() instead."
            )
        sens = split_into_sentences(text) if split_sentences else [text.strip()]
        if not any(sens):
            raise ValueError("No text to speak.")
        for sen in sens:
            yield from self.tts_model.synthesize_stream(
                text=sen, config=self.tts_config, speaker_id=speaker_name,
                speaker_wav=speaker_wav, language=language_name or "en", **kwargs,
            )

    def save_wav(self, wav: List[float], path: str, pipe_out=None) -> None:
        save_wav(wav=np.asarray(wav), path=path, sample_rate=self.output_sample_rate,
                 pipe_out=pipe_out)
