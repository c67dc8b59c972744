"""Matplotlib training visuals (port of ``tts_tpu/utils/visual.py``,
copied unchanged; reference ``TTS/tts/utils/visual.py:11,36``): alignment,
spectrogram and pitch figures for the dashboard logger. matplotlib is
imported only inside the plotting functions (``_mpl``), so a machine
without it runs everything else; :func:`matplotlib_available` tells the
trainer whether to make figures at all.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

__all__ = [
    "matplotlib_available",
    "plot_alignment",
    "plot_spectrogram",
    "plot_pitch",
    "plot_results",
    "alignment_diagonal_score",
]


def matplotlib_available() -> bool:
    """Whether matplotlib imports here."""
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        return False
    return True


def _mpl():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_alignment(alignment: np.ndarray, title: Optional[str] = None, fig_size=(8, 5)):
    """Attention/alignment heatmap: x = decoder steps, y = encoder steps."""
    plt = _mpl()
    align = np.asarray(alignment, np.float32)
    if align.ndim == 3:
        align = align[0]
    fig, ax = plt.subplots(figsize=fig_size)
    im = ax.imshow(align.T, aspect="auto", origin="lower", interpolation="none")
    fig.colorbar(im, ax=ax)
    ax.set_xlabel("Decoder timestep")
    ax.set_ylabel("Encoder timestep")
    if title:
        ax.set_title(title)
    fig.tight_layout()
    return fig


def plot_spectrogram(spectrogram: np.ndarray, fig_size=(16, 10)):
    """Spectrogram heatmap ([T, C] or [C, T] — plotted frames on x)."""
    plt = _mpl()
    spec = np.asarray(spectrogram, np.float32)
    if spec.ndim == 3:
        spec = spec[0]
    if spec.shape[0] < spec.shape[1]:  # [C, T] → [T, C]
        spec = spec.T
    fig = plt.figure(figsize=fig_size)
    plt.imshow(spec.T, aspect="auto", origin="lower", interpolation="none")
    plt.colorbar()
    plt.tight_layout()
    return fig


def plot_pitch(pitch: np.ndarray, spectrogram: Optional[np.ndarray] = None, fig_size=(30, 10)):
    """Pitch contour, optionally over the spectrogram."""
    plt = _mpl()
    pitch = np.asarray(pitch, np.float32).reshape(-1)
    fig, ax = plt.subplots(figsize=fig_size)
    if spectrogram is not None:
        spec = np.asarray(spectrogram, np.float32)
        if spec.shape[0] < spec.shape[1]:
            spec = spec.T
        ax.imshow(spec.T, aspect="auto", origin="lower", interpolation="none")
        ax2 = ax.twinx()
        ax2.plot(pitch, linewidth=2.0, color="red")
        ax2.set_ylabel("F0 (Hz)")
    else:
        ax.plot(pitch, linewidth=2.0)
        ax.set_ylabel("F0 (Hz)")
    ax.set_xlabel("Frames")
    fig.tight_layout()
    return fig


def plot_results(y_hat: np.ndarray, y: np.ndarray, ap, name_prefix: str = "") -> dict:
    """Vocoder eval figures (reference ``vocoder/utils/generic_utils.py:32``):
    real/generated/diff mel spectrograms plus a stacked waveform comparison,
    keyed for the dashboard logger."""
    plt = _mpl()
    y_hat = np.asarray(y_hat, np.float32).squeeze()
    y = np.asarray(y, np.float32).squeeze()
    if y_hat.ndim > 1:
        y_hat = y_hat[0].squeeze()
    if y.ndim > 1:
        y = y[0].squeeze()

    spec_fake = ap.melspectrogram(y_hat).T
    spec_real = ap.melspectrogram(y).T
    spec_diff = np.abs(spec_fake - spec_real)

    fig_wave = plt.figure()
    ax = fig_wave.add_subplot(2, 1, 1)
    ax.plot(y)
    ax.set_title("groundtruth speech")
    ax = fig_wave.add_subplot(2, 1, 2)
    ax.plot(y_hat)
    ax.set_title("generated speech")
    fig_wave.tight_layout()

    return {
        name_prefix + "spectrogram/fake": plot_spectrogram(spec_fake),
        name_prefix + "spectrogram/real": plot_spectrogram(spec_real),
        name_prefix + "spectrogram/diff": plot_spectrogram(spec_diff),
        name_prefix + "speech_comparison": fig_wave,
    }


def alignment_diagonal_score(alignments: np.ndarray, binary: bool = False) -> float:
    """How diagonal an alignment is (reference ``tts/utils/measures.py``):
    mean of per-decoder-step max attention (optionally binarized)."""
    align = np.asarray(alignments, np.float32)
    if align.ndim == 2:
        align = align[None]
    maxs = align.max(axis=-1)  # [B, T_de] — max over encoder steps
    if binary:
        maxs = (maxs > 0.5).astype(np.float32)
    return float(maxs.mean())
