"""Small corpora on disk for the port's data and trainer tests: LJSpeech,
VCTK and M-AILABS layouts of 16-bit wavs drawn from a seed (voiced tones
with noise), with texts whose lengths follow the clips' lengths. Also the
tiny VITS training config those tests share."""

import os

import numpy as np
import scipy.io.wavfile

WORDS = ("the quick brown fox jumps over a lazy dog while seven bright "
         "stars glow above quiet hills").split()
SR = 16000
AUDIO = dict(sample_rate=SR, fft_size=128, win_length=128, hop_length=16, num_mels=20)


def clip(rs, seconds: float, sr: int = SR) -> np.ndarray:
    """A voiced 16-bit clip: a tone with two harmonics and a little noise."""
    n = int(seconds * sr)
    t = np.arange(n) / sr
    f0 = rs.uniform(90, 240)
    wav = sum(np.sin(2 * np.pi * f0 * k * t + rs.uniform(0, 6.28)) / k for k in (1, 2, 3))
    wav = 0.3 * wav / np.abs(wav).max() + 0.01 * rs.randn(n)
    return (np.clip(wav, -1, 1) * 32767).astype(np.int16)


def sentence(rs, n_words: int) -> str:
    return " ".join(rs.choice(WORDS, n_words)).capitalize() + "."


def write_ljspeech(root, n: int, seed: int = 0, seconds=(0.06, 0.14), sr: int = SR) -> str:
    """``root/wavs/*.wav`` and ``root/metadata.csv`` (``id|text|text``)."""
    rs = np.random.RandomState(seed)
    os.makedirs(os.path.join(root, "wavs"), exist_ok=True)
    lines = []
    for i in range(n):
        s = rs.uniform(*seconds)
        name = f"LJ{seed:03d}-{i:04d}"
        scipy.io.wavfile.write(os.path.join(root, "wavs", name + ".wav"), sr, clip(rs, s, sr))
        text = sentence(rs, max(1, int(s * 30)))
        lines.append(f"{name}|{text}|{text}")
    with open(os.path.join(root, "metadata.csv"), "w", encoding="utf-8") as f:
        f.write("\n".join(lines) + "\n")
    return str(root)


def write_vctk(root, speakers=("p225", "p226", "p227"), per_speaker: int = 4, seed: int = 0,
               sr: int = SR) -> str:
    """VCTK 0.92's layout: ``txt/<spk>/<id>.txt`` and
    ``wav48_silence_trimmed/<spk>/<id>_mic1.flac`` (the formatter only checks
    that the audio exists; these hold wav bytes)."""
    rs = np.random.RandomState(seed)
    for spk in speakers:
        os.makedirs(os.path.join(root, "wav48_silence_trimmed", spk), exist_ok=True)
        os.makedirs(os.path.join(root, "txt", spk), exist_ok=True)
        for i in range(per_speaker):
            name = f"{spk}_{i + 1:03d}"
            scipy.io.wavfile.write(
                os.path.join(root, "wav48_silence_trimmed", spk, name + "_mic1.flac"), sr,
                clip(rs, rs.uniform(0.06, 0.14), sr))
            with open(os.path.join(root, "txt", spk, name + ".txt"), "w") as f:
                f.write(sentence(rs, 3) + "\n")
    return str(root)


def write_mailabs(root, languages=("en_US", "de_DE"), speakers=("ann", "bob"), per_speaker=3,
                  seed: int = 0, sr: int = SR) -> list:
    """``root/<lang>/by_book/<gender>/<speaker>/<book>/{metadata.csv,wavs}``;
    returns the language folders."""
    rs = np.random.RandomState(seed)
    folders = []
    for lang in languages:
        for g, spk in zip(("female", "male"), speakers):
            book = os.path.join(root, lang, "by_book", g, f"{spk}_{lang}", "book")
            os.makedirs(os.path.join(book, "wavs"), exist_ok=True)
            lines = []
            for i in range(per_speaker):
                name = f"{spk}_{lang}_{i:03d}"
                scipy.io.wavfile.write(os.path.join(book, "wavs", name + ".wav"), sr,
                                       clip(rs, rs.uniform(0.06, 0.14), sr))
                text = sentence(rs, 3)
                lines.append(f"{name}|{text}|{text}")
            with open(os.path.join(book, "metadata.csv"), "w", encoding="utf-8") as f:
                f.write("\n".join(lines) + "\n")
        folders.append(os.path.join(root, lang))
    return folders
