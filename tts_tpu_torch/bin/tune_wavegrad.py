"""Search WaveGrad's inference noise schedule against held-out audio (port
of ``tts_tpu/bin/tune_wavegrad.py``; reference
``TTS/bin/tune_wavegrad.py``)::

    python -m tts_tpu_torch.bin.tune_wavegrad --config_path config.json \
        --checkpoint_path best_model.pth [--num_iter 6] [--search_depth 3] [--device cpu]

Each schedule of the grid (:func:`schedule_grid`: for every tuple of
``search_depth`` exponents in -6..-1, ``num_iter`` betas spaced
logarithmically from 10 to the least to 10 to the greatest) vocodes the
first four held-out clips' mels (``GANDataset``'s eval segments) from the
same noise (a generator seeded 0 at each schedule, as the JAX command keys
each with ``PRNGKey(0)``); its error is the mean L1 between the log-mels
(``audio.torch_transforms.wav_to_mel``) of the vocoded and the real
segments. The command prints each new best and, last, the best schedule.
``--device`` as ``train_vocoder``'s: ``cuda`` unless ``cpu`` is asked for.
"""

from __future__ import annotations

import argparse
import itertools
import sys
from typing import Iterator, List, Tuple

import numpy as np
import torch

EXPONENTS = (-6, -5, -4, -3, -2, -1)


def schedule_grid(num_iter: int, search_depth: int) -> Iterator[np.ndarray]:
    """The betas of every schedule searched, in the JAX command's order."""
    for exponents in itertools.product(EXPONENTS, repeat=search_depth):
        yield np.logspace(min(exponents), max(exponents), num_iter)


def schedule_of(betas: np.ndarray):
    """``(β, α, ᾱ, noise levels)`` of a beta sequence, float64."""
    alpha = 1 - betas
    alpha_hat = np.cumprod(alpha)
    return betas, alpha, alpha_hat, np.concatenate([[1.0], alpha_hat**0.5])


@torch.no_grad()
def search(model, batch, audio, num_iter: int, search_depth: int,
           noise=None) -> List[Tuple[np.ndarray, float]]:
    """``(betas, mel L1)`` of every schedule of the grid on ``batch``
    (``mel [B, T, M]``, ``waveform [B, T * hop, 1]``, on the model's
    device). ``noise(betas)`` may give a schedule's draws (``[num_iter + 1,
    B, T * hop, 1]``, as ``wavegrad_inference`` takes them); without it
    each schedule draws from a generator seeded 0 on the device."""
    from tts_tpu_torch.audio.torch_transforms import wav_to_mel
    from tts_tpu_torch.vocoder.models.wavegrad import wavegrad_inference

    mel_kw = dict(n_fft=audio.fft_size, num_mels=audio.num_mels, sample_rate=audio.sample_rate,
                  hop_length=audio.hop_length, win_length=audio.win_length)
    device = batch["mel"].device
    mel_ref = wav_to_mel(batch["waveform"][..., 0], **mel_kw)
    out = []
    for betas in schedule_grid(num_iter, search_depth):
        given = None if noise is None else noise(betas)
        generator = None if given is not None else torch.Generator(device=device).manual_seed(0)
        y = wavegrad_inference(model, batch["mel"], schedule_of(betas), generator, noise=given)
        err = float(torch.mean(torch.abs(wav_to_mel(y[..., 0], **mel_kw) - mel_ref)))
        out.append((betas, err))
    return out


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config_path", required=True)
    parser.add_argument("--checkpoint_path", required=True)
    parser.add_argument("--num_iter", type=int, default=6)
    parser.add_argument("--search_depth", type=int, default=3)
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device (default cuda; cpu only when asked for)")
    args = parser.parse_args(sys.argv[1:] if argv is None else argv)

    from tts_tpu_torch import resolve_device
    from tts_tpu_torch.config import read_json_with_comments
    from tts_tpu_torch.models import config_from_dict
    from tts_tpu_torch.vocoder.dataset import GANDataset, load_wav_data
    from tts_tpu_torch.vocoder.models.wavegrad import WavegradVocoder

    device = resolve_device(args.device)
    config = config_from_dict(read_json_with_comments(args.config_path))
    state = torch.load(args.checkpoint_path, map_location="cpu", weights_only=True)
    if isinstance(state, dict) and "model" in state:
        state = state["model"]
    vocoder = WavegradVocoder(config)
    vocoder.load_state_dict({k: v.to(device) for k, v in state.items()})
    eval_samples, _ = load_wav_data(config.data_path, config.eval_split_size)
    batch = next(GANDataset(config, eval_samples[:4], is_eval=True).batches(4, shuffle=False))
    batch = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
    best = (None, np.inf)
    for betas, err in search(vocoder.module.eval(), batch, config.audio, args.num_iter,
                             args.search_depth):
        if err < best[1]:
            best = (betas, err)
            print(f" > new best mel L1 {err:.4f} for schedule {betas}")
    print(" > Best schedule:", best[0])
    return best


if __name__ == "__main__":
    main()
