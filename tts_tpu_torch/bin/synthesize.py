"""The ``tts`` command line of the port (counterpart of
``tts_tpu/bin/synthesize.py``): text → wav file, or wav bytes on stdout.

Examples::

    python -m tts_tpu_torch.bin.synthesize --text "Hello world." \\
        --model_path vits_dir/ --out_path out.wav
    python -m tts_tpu_torch.bin.synthesize --text "Hello world." \\
        --model_path vits/model_torch.pt --config_path vits/config.json --device cpu
    python -m tts_tpu_torch.bin.synthesize --text "Hello world." \\
        --model_path xtts_dir/ --speaker_wav ref.wav --language_idx en
    python -m tts_tpu_torch.bin.synthesize --model_path vctk_dir/ \\
        --speakers_file_path vctk_dir/speakers.json --list_speaker_idxs
    python -m tts_tpu_torch.bin.synthesize --text "Hello world." \\
        --model_path vctk_dir/ --speaker_idx p226 --out_path out.wav
    python -m tts_tpu_torch.bin.synthesize --list_models
    python -m tts_tpu_torch.bin.synthesize --model_info_by_idx tts_models/3
    python -m tts_tpu_torch.bin.synthesize --text "Hello world." \\
        --model_name tts_models/en/vctk/vits --speaker_idx p226
    python -m tts_tpu_torch.bin.synthesize --model_path vctk_dir/ \\
        --reference_wav p225.wav --reference_speaker_idx p225 --speaker_idx p226
    python -m tts_tpu_torch.bin.synthesize --text "Hello world." \\
        --model_path glow/model_file.pth --config_path glow/config.json \\
        --vocoder_path mbmelgan/model_file.pth --vocoder_config_path mbmelgan/config.json
    python -m tts_tpu_torch.bin.synthesize --text "Hello world." \\
        --model_name tts_models/en/ljspeech/glow-tts \\
        --vocoder_name vocoder_models/en/ljspeech/hifigan_v2
    python -m tts_tpu_torch.bin.synthesize --text "Hello world." \\
        --model_name tts_models/en/blizzard2013/capacitron-t2-c50 \\
        --style_wav style.wav --capacitron_style_text "The style's words."
    python -m tts_tpu_torch.bin.synthesize --text "Hello world." \
        --model_path yourtts/model_file.pth --config_path yourtts/config.json \
        --encoder_path se/model_se.pth.tar --encoder_config_path se/config_se.json \
        --speaker_wav ref.wav --language_idx en

    python -m tts_tpu_torch.bin.synthesize \\
        --model_name voice_conversion_models/multilingual/vctk/freevc24 \\
        --source_wav source.wav --target_wav target.wav --out_path out.wav
    python -m tts_tpu_torch.bin.synthesize --text "Hello world." \\
        --model_name tts_models/en/multi-dataset/tortoise-v2 \\
        --voice_dir voices/ --speaker_idx emma --out_path out.wav

``--model_name`` loads a zoo model from ``$TTS_HOME/tts_tpu/`` (fetched if
absent; ``TTS_TPU_MODELS_FILE`` replaces the catalog); a family the port
does not run yet raises ``NotImplementedError`` before anything is fetched.
``--reference_wav`` with ``--reference_speaker_idx`` (the speaker of the
recording) and ``--speaker_idx`` (the voice wanted) converts a recording
with a multi-speaker VITS model. ``--vocoder_path`` with
``--vocoder_config_path``, or a zoo ``--vocoder_name``, gives a mel model
(GlowTTS, Tacotron2, FastPitch, Overflow, NeuralHMM, AlignTTS) its vocoder,
in place of a zoo entry's
default one; without any, Griffin-Lim speaks it. ``--encoder_path`` with
``--encoder_config_path`` loads a speaker encoder, which turns
``--speaker_wav`` into a d-vector for a d-vector model (YourTTS); the zoo's
``your_tts`` loads the one its directory ships. ``--style_wav`` (or its
aliases ``--gst_style`` and ``--capacitron_style_wav``) gives a GST or
Capacitron Tacotron its style reference; ``--capacitron_style_text``, its
transcription, changes nothing, as in the JAX package (ROADMAP.md F37).
``--source_wav`` with ``--target_wav`` converts the source recording into the
target's voice with a voice-conversion model (``--model_name
voice_conversion_models/multilingual/vctk/freevc24``: FreeVC, WavLM-Large
read from ``$TTS_HOME/wavlm/WavLM-Large.pt``) and writes ``--out_path``.

``--device`` defaults to ``cuda`` and raises without CUDA; ``--device cpu``
runs the plain PyTorch path. ``--use_cuda``, ``--save_spectogram`` and
``--progress_bar`` are accepted for compatibility with the reference
command line and change nothing. With ``--pipe_out`` the wav bytes are the
only thing written to stdout: the log lines go to stderr (the JAX
command line prints them into the same stream).

``--voice_dir`` gives Tortoise and Bark their voices: for Tortoise
``--speaker_idx emma`` clones ``<voice_dir>/emma/*.wav``, for Bark it takes
the voice prompt ``<voice_dir>/emma.npz`` (made by ``Bark.generate_voice``);
``--speaker_idx random`` (or none) speaks with a random voice. Other models
ignore the flag, as in the JAX command line.
"""

from __future__ import annotations

import argparse
import contextlib
import sys


def str2bool(v):
    if isinstance(v, bool):
        return v
    return v.lower() in ("yes", "true", "t", "y", "1")


def make_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="tts_tpu_torch synthesis command line")
    parser.add_argument("--list_models", action="store_true", help="list the zoo's models")
    parser.add_argument("--model_info_by_idx", type=str, default=None,
                        help="model info by query idx: <model_type>/<model_query_idx>")
    parser.add_argument("--model_info_by_name", type=str, default=None,
                        help="model info by full name: <model_type>/<language>/<dataset>/<model_name>")
    parser.add_argument("--text", type=str, default=None, help="Text to synthesize.")
    parser.add_argument("--model_name", type=str, default=None, help="zoo model name")
    parser.add_argument("--vocoder_name", type=str, default=None,
                        help="zoo vocoder name (overrides the model's default_vocoder)")
    parser.add_argument("--model_path", type=str, default=None,
                        help="model directory, or a checkpoint file with --config_path")
    parser.add_argument("--config_path", type=str, default=None,
                        help="config.json of a checkpoint file given as --model_path")
    parser.add_argument("--vocoder_path", type=str, default=None,
                        help="vocoder checkpoint for a mel model (GlowTTS, Tacotron2, ...)")
    parser.add_argument("--vocoder_config_path", type=str, default=None,
                        help="config.json of --vocoder_path")
    parser.add_argument("--encoder_path", type=str, default=None,
                        help="speaker-encoder checkpoint for d-vectors from --speaker_wav")
    parser.add_argument("--encoder_config_path", type=str, default=None,
                        help="config.json of --encoder_path")
    parser.add_argument("--out_path", type=str, default="tts_output.wav")
    parser.add_argument("--pipe_out", action="store_true", help="also write the wav to stdout")
    parser.add_argument("--speaker_idx", type=str, default=None)
    parser.add_argument("--language_idx", type=str, default=None)
    parser.add_argument("--speaker_wav", nargs="+", default=None)
    parser.add_argument("--speakers_file_path", type=str, default=None,
                        help="JSON speakers file for a multi-speaker model (replaces the "
                             "config's)")
    parser.add_argument("--language_ids_file_path", type=str, default=None,
                        help="JSON language-ids file for a multi-lingual model (replaces the "
                             "config's)")
    parser.add_argument("--list_speaker_idxs", action="store_true",
                        help="print the model's speaker names and exit")
    parser.add_argument("--list_language_idxs", action="store_true",
                        help="print the model's language names and exit")
    parser.add_argument("--reference_wav", type=str, default=None,
                        help="convert this recording to --speaker_idx's voice")
    parser.add_argument("--reference_speaker_idx", type=str, default=None,
                        help="the speaker of --reference_wav")
    parser.add_argument("--style_wav", "--gst_style", "--capacitron_style_wav",
                        dest="style_wav", type=str, default=None,
                        help="GST/Capacitron style-reference wav")
    parser.add_argument("--capacitron_style_text", dest="style_text", type=str, default=None,
                        help="transcription of the Capacitron style reference")
    parser.add_argument("--source_wav", type=str, default=None,
                        help="voice conversion: the recording to convert")
    parser.add_argument("--target_wav", type=str, default=None,
                        help="voice conversion: a recording of the voice wanted")
    parser.add_argument("--voice_dir", type=str, default=None,
                        help="Tortoise's voices (<voice_dir>/<speaker_idx>/*.wav) or Bark's "
                             "(<voice_dir>/<speaker_idx>.npz)")
    parser.add_argument("--device", type=str, default="cuda", help="torch device (default cuda)")
    # accepted for compatibility with the reference command line
    parser.add_argument("--use_cuda", action="store_true",
                        help="accepted for compatibility; --device selects the device")
    parser.add_argument("--save_spectogram", action="store_true",
                        help="accepted for compatibility (a no-op in the reference too)")
    parser.add_argument("--progress_bar", type=str2bool, nargs="?", const=True, default=True,
                        help="accepted for compatibility (downloads show no bar)")
    return parser


def main(argv=None):
    args = make_parser().parse_args(argv)
    pipe_out = sys.stdout if args.pipe_out else None
    with contextlib.redirect_stdout(sys.stderr if pipe_out else sys.stdout):
        if args.list_models or args.model_info_by_idx or args.model_info_by_name:
            from tts_tpu_torch.utils.manage import ModelManager

            manager = ModelManager(progress_bar=args.progress_bar)
            if args.list_models:
                for name in manager.list_models():
                    print(name)
            if args.model_info_by_idx:
                manager.model_info_by_idx(args.model_info_by_idx)
            if args.model_info_by_name:
                manager.model_info_by_name(args.model_info_by_name)
            return
        from tts_tpu_torch.api import TTS, download_vocoder

        vocoder_path, vocoder_config_path = args.vocoder_path, args.vocoder_config_path
        if args.vocoder_name and not vocoder_path:
            vocoder_path, vocoder_config_path = download_vocoder(args.vocoder_name)
        tts = TTS(model_name=args.model_name or "", model_path=args.model_path,
                  config_path=args.config_path, vocoder_path=vocoder_path,
                  vocoder_config_path=vocoder_config_path, device=args.device,
                  speakers_file_path=args.speakers_file_path,
                  language_ids_file_path=args.language_ids_file_path,
                  encoder_path=args.encoder_path, encoder_config_path=args.encoder_config_path,
                  voice_dir=args.voice_dir)

        if args.list_speaker_idxs:
            print(" > Available speaker ids: (set --speaker_idx to one of these):")
            print(tts.speakers)
            return
        if args.list_language_idxs:
            print(" > Available language ids: (set --language_idx to one of these):")
            print(tts.languages)
            return

        if args.source_wav is not None and args.target_wav is not None:
            tts.voice_conversion_to_file(source_wav=args.source_wav, target_wav=args.target_wav,
                                         file_path=args.out_path)
            print(f" > Saving output to {args.out_path}")
            return

        if args.reference_wav is not None:
            wav = tts.synthesizer.tts(reference_wav=args.reference_wav,
                                      speaker_name=args.speaker_idx,
                                      reference_speaker_name=args.reference_speaker_idx)
            tts.synthesizer.save_wav(wav, args.out_path, pipe_out=pipe_out)
            print(f" > Saving output to {args.out_path}")
            return

        if args.text is None:
            print(" [!] Provide --text", file=sys.stderr)
            sys.exit(1)

        # guard: multi-speaker model with no speaker selected (reference
        # synthesize.py:456-461)
        if tts.is_multi_speaker and not (args.speaker_idx or args.speaker_wav):
            print(" [!] This is a multi-speaker model: set --speaker_idx (see "
                  "--list_speaker_idxs) or --speaker_wav.", file=sys.stderr)
            sys.exit(1)

        tts.tts_to_file(
            args.text,
            speaker=args.speaker_idx,
            language=args.language_idx,
            speaker_wav=args.speaker_wav,
            style_wav=args.style_wav,
            style_text=args.style_text,
            file_path=args.out_path,
            pipe_out=pipe_out,
        )
        print(f" > Saving output to {args.out_path}")


if __name__ == "__main__":
    main()
