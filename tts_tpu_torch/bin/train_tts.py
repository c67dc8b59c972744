"""Train a TTS model from a config file (port of ``tts_tpu/bin/train_tts.py``;
reference ``TTS/bin/train_tts.py``)::

    python -m tts_tpu_torch.bin.train_tts --config_path config.json
    python -m tts_tpu_torch.bin.train_tts --config_path config.json --coqpit.batch_size 8
    python -m tts_tpu_torch.bin.train_tts --continue_path run/
    python -m tts_tpu_torch.bin.train_tts --config_path config.json --restore_path best_model.pth
    python -m tts_tpu_torch.bin.train_tts --config_path config.json --device cpu

The flags are the JAX command's (``--config_path``, ``--continue_path``,
``--restore_path``, ``--output_path`` and the dotted ``--coqpit.*``
overrides), plus ``--device``: ``cuda`` by default, which raises without
CUDA; ``--device cpu`` runs the plain PyTorch path on the CPU. With
``--continue_path`` alone, the run folder's ``config.json`` is the config.
The run folder gets ``config.json``, ``checkpoint_<step>.pth`` and
``best_model.pth``, which the ``tts`` command line
(``tts_tpu_torch.bin.synthesize --model_path <run>/best_model.pth
--config_path <run>/config.json``) speaks.
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
    from tts_tpu_torch.data import load_tts_samples
    from tts_tpu_torch.models import config_from_dict, setup_model
    from tts_tpu_torch.trainer.trainer import Trainer, TrainerArgs

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

    if args.output_path:
        output_path = args.output_path
    elif config.output_path:
        # config.output_path is the experiment ROOT: a fresh
        # <run_name>-<date>-<git hash> run folder under it (reference
        # ``get_experiment_folder_path``)
        from tts_tpu_torch.utils.generic import get_experiment_folder_path

        output_path = get_experiment_folder_path(config.output_path, config.run_name or "run")
    else:
        output_path = os.path.join(os.getcwd(), "run")
    if args.continue_path:
        output_path = args.continue_path

    train_samples, eval_samples = load_tts_samples(
        [d.to_dict() for d in config.datasets],
        eval_split=True,
        eval_split_max_size=config.eval_split_max_size,
        eval_split_size=config.eval_split_size,
    )
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
