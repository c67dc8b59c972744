"""Train a vocoder from a config file (port of
``tts_tpu/bin/train_vocoder.py``; reference ``TTS/bin/train_vocoder.py``)::

    python -m tts_tpu_torch.bin.train_vocoder --config_path config.json
    python -m tts_tpu_torch.bin.train_vocoder --config_path config.json --coqpit.batch_size 8
    python -m tts_tpu_torch.bin.train_vocoder --continue_path run/
    python -m tts_tpu_torch.bin.train_vocoder --config_path config.json \
        --restore_path best_model.pth
    python -m tts_tpu_torch.bin.train_vocoder --config_path config.json --device cpu

The flags are the JAX command's (``--config_path``, ``--continue_path``,
``--restore_path``, ``--output_path`` and the dotted ``--coqpit.*``
overrides), plus ``--device``: ``cuda`` by default, which raises without
CUDA; ``--device cpu`` runs the plain PyTorch path on the CPU. With
``--continue_path`` alone, the run folder's ``config.json`` is the config.
The wavs are every ``*.wav`` under ``config.data_path``, the first
``eval_split_size`` of a seeded shuffle held out (``vocoder.dataset.
load_wav_data``). ``config.model`` picks the wrapper
(``vocoder.models.setup_model``): every GAN family, WaveGrad or WaveRNN.
The run folder gets ``config.json``, ``checkpoint_<step>.pth`` and
``best_model.pth``, whose generator the ``tts`` command line vocodes with
(``--vocoder_path <run>/best_model.pth --vocoder_config_path
<run>/config.json``).
"""

from __future__ import annotations

import argparse
import os
import sys


def main(argv=None, callbacks=None):
    """Parse ``argv`` (``sys.argv[1:]`` by default), train, and return the
    ``Trainer`` after its ``fit``. ``callbacks`` (the ``Trainer``'s
    ``{event: fn or [fn, ...]}``) reach the trainer from Python callers."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--config_path", type=str, default="")
    parser.add_argument("--continue_path", type=str, default="")
    parser.add_argument("--restore_path", type=str, default="")
    parser.add_argument("--output_path", type=str, default=None)
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device (default cuda; cpu only when asked for)")
    args, rest = parser.parse_known_args(sys.argv[1:] if argv is None else argv)

    from tts_tpu_torch import resolve_device
    from tts_tpu_torch.config import read_json_with_comments
    from tts_tpu_torch.models import config_from_dict
    from tts_tpu_torch.trainer.trainer import Trainer, TrainerArgs
    from tts_tpu_torch.vocoder.dataset import load_wav_data
    from tts_tpu_torch.vocoder.models import setup_model

    device = resolve_device(args.device)
    config_path = args.config_path
    if not config_path and args.continue_path:
        config_path = os.path.join(args.continue_path, "config.json")
    if not config_path:
        parser.error("--config_path is required (or --continue_path with a config.json)")
    config = config_from_dict(read_json_with_comments(config_path))
    rest = config.parse_args(rest)  # dotted --coqpit.* overrides
    if rest:
        print(f" [!] Unused CLI args: {rest}")
    output_path = (args.continue_path or args.output_path or config.output_path
                   or os.path.join(os.getcwd(), "run_vocoder"))

    eval_samples, train_samples = load_wav_data(config.data_path, config.eval_split_size)
    model = setup_model(config)
    trainer = Trainer(
        TrainerArgs(continue_path=args.continue_path, restore_path=args.restore_path),
        config,
        output_path,
        model,
        train_samples,
        eval_samples,
        callbacks=callbacks,
        device=device,
    )
    trainer.fit()
    return trainer


if __name__ == "__main__":
    main()
