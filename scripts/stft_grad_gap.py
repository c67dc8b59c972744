#!/usr/bin/env python3
"""Where the port's STFT-loss generator gradients lose precision on the CPU.
Run from the repository root where the CPU tests run (the JAX package and
the port side by side; no card needed)::

    python3 scripts/stft_grad_gap.py

For MelGAN and multi-band MelGAN at ``tests/test_torch_gan_train.py``'s
tiny widths, weights and batch, it prints the largest distance of the
port's fp32 generator gradients of one step from a float64 evaluation of
the same step (as a share of each tensor's float64 peak), computed:

1. as the port stands (the STFT a strided convolution, oneDNN's
   convolutions on);
2. with every convolution through PyTorch's plain im2col and GEMM path
   (``torch.backends.mkldnn`` off);
3. with the STFT as an explicit DFT product (frames unfolded, one matmul);
4. with the STFT alone outside oneDNN, and with everything but the STFT
   outside oneDNN;

then the largest distance, over the test's three teacher-forced steps, of
the port's generator gradients from the JAX package's, with oneDNN on and
off. The JAX package's own distance from float64 (6.4e-4) is
``test_generator_gradients_against_float64``'s.
"""

import contextlib
import copy
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

import torch_threads  # noqa: E402,F401  (caps torch's CPU threads)
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

import test_torch_gan_train as gan_tests  # noqa: E402
import tts_tpu_torch.audio.torch_transforms as tt  # noqa: E402

STFT = tt.stft_real_imag


def generator_grads(port, config, batch, double: bool = False) -> dict:
    """The generator's gradients of one step's generator loss, in fp32 or
    wholly in float64 (``float_means_double``)."""
    p = copy.deepcopy(port)
    p.module.requires_grad_(True)
    p.discriminator.requires_grad_(True)
    ctx = contextlib.nullcontext()
    if double:
        p.module.double()
        p.discriminator.double()
        if p.pqmf is not None:
            p.pqmf.H, p.pqmf.G = p.pqmf.H.double(), p.pqmf.G.double()
        ctx = gan_tests.float_means_double()
    tb = {k: torch.from_numpy(v).to(torch.float64 if double else torch.float32)
          for k, v in batch.items()}
    with ctx:
        loss, _, _ = p.losses(tb, torch.Generator(), config.steps_to_start_discriminator == 0)
        grads = torch.autograd.grad(loss, list(p.module.parameters()))
    return {n: g.double() for (n, _), g in zip(p.module.named_parameters(), grads)}


def stft_as_dft_product(y, fft_size, hop_length, win_length, window="hann", center=True,
                        pad_mode="reflect", pad_wav=False):
    """``stft_real_imag`` with the frames unfolded and one matmul with the
    windowed DFT basis in place of the strided convolution."""
    squeeze = y.dim() == 1
    y = (y[None] if squeeze else y).float()
    p = fft_size // 2 if center else ((fft_size - hop_length) // 2 if pad_wav else 0)
    if p:
        y = F.pad(y[:, None], (p, p), mode="reflect" if pad_mode == "reflect" else "constant")[:, 0]
    basis = torch.from_numpy(tt.stft_basis(fft_size, win_length, window)).to(y)[:, 0]
    out = torch.matmul(y.unfold(-1, fft_size, hop_length), basis.t()).transpose(1, 2)
    n_bins = fft_size // 2 + 1
    re, im = out[:, :n_bins], out[:, n_bins:]
    return (re[0], im[0]) if squeeze else (re, im)


def stft_with_onednn(enabled: bool):
    def stft(*args, **kwargs):
        with torch.backends.mkldnn.flags(enabled=enabled):
            return STFT(*args, **kwargs)
    return stft


@contextlib.contextmanager
def stft_as(fn):
    tt.stft_real_imag = fn
    try:
        yield
    finally:
        tt.stft_real_imag = STFT


def main() -> None:
    print(f"torch {torch.__version__}, CPU, {torch.get_num_threads()} thread(s)")
    for family in ("melgan", "multiband_melgan"):
        port, config, batch, want = gan_tests.run(family)
        exact = generator_grads(port, config, batch, double=True)

        def distance(grads):
            return max(float((grads[n] - e).abs().max()) / float(e.abs().max())
                       for n, e in exact.items())

        rows = [("as it stands (strided convolution, oneDNN on)", contextlib.nullcontext(), None)]
        rows.append(("every convolution outside oneDNN", None, False))
        rows.append(("the STFT as a DFT product", stft_as(stft_as_dft_product), None))
        rows.append(("the STFT alone outside oneDNN", stft_as(stft_with_onednn(False)), None))
        rows.append(("everything but the STFT outside oneDNN",
                     stft_as(stft_with_onednn(True)), False))
        for what, ctx, onednn in rows:
            with ctx or contextlib.nullcontext():
                flags = (torch.backends.mkldnn.flags(enabled=onednn) if onednn is not None
                         else contextlib.nullcontext())
                with flags:
                    d = distance(generator_grads(port, config, batch))
            print(f"{family}: {what}: {d:.3g} of the float64 peak")
        for enabled in (True, False):
            with torch.backends.mkldnn.flags(enabled=enabled):
                got = gan_tests.port_run(copy.deepcopy(port), config, batch, want,
                                         teacher_forced=True)
            gap = max(float((g["grads"]["gen"][n] - w["grads"]["gen"][n]).abs().max())
                      / float(w["grads"]["gen"][n].abs().max())
                      for g, w in zip(got, want) for n in w["grads"]["gen"]
                      if float(w["grads"]["gen"][n].abs().max()) > 0)
            print(f"{family}: the port against the JAX package over {len(want)} steps, oneDNN "
                  f"{'on' if enabled else 'off'}: {gap:.3g} of the JAX gradients' peaks")


if __name__ == "__main__":
    main()
