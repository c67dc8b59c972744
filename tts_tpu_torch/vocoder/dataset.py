"""The vocoders' data (port of ``tts_tpu/vocoder/dataset.py``; reference
``TTS/vocoder/datasets/``): ``load_wav_data`` (every wav under a folder,
the eval split) and ``GANDataset`` (a random segment of ``seq_len`` samples
of each clip with the mel under it).

Draws: the JAX package shuffles the paths after ``np.random.seed(0)`` and
draws each segment's start and the noise augmentation from numpy's global
state. The port never touches the global state: ``load_wav_data`` shuffles
with ``np.random.RandomState(0)``, which draws the same permutation, and
``GANDataset`` draws from the ``np.random.RandomState`` it is given
(``rng``), in the JAX order (a clip's start, then its noise, clip by clip
in batch order), so a state seeded as the JAX global one was gives batches
bit-equal to the JAX ``GANDataset.batches``. Without ``rng`` each call of
``batches(seed=epoch)`` draws from a state of its own seeded from
``(seed, epoch)`` (``seed``: the config's), so an epoch's batches depend on
nothing before it and ``--continue_path`` resumes them exactly.

Workers (``num_workers``, threads or forked processes, as the TTS data
pipeline's) load the clips and compute the mels of later batches while the
consumer trains; the draws stay with the consumer, in order, between the
two, so the batches are the same, in the same order, with or without
workers.
"""

from __future__ import annotations

import glob
import os
from typing import Iterator, List, Optional

import numpy as np

from tts_tpu_torch.audio.processor import AudioProcessor


def load_wav_data(data_path: str, eval_split_size: int):
    """``(eval paths, train paths)``: every ``*.wav`` under ``data_path``
    (recursively), sorted, shuffled by ``RandomState(0)``, the first
    ``eval_split_size`` held out (reference ``preprocess.py``)."""
    wav_paths = sorted(glob.glob(os.path.join(data_path, "**", "*.wav"), recursive=True))
    np.random.RandomState(0).shuffle(wav_paths)
    return wav_paths[:eval_split_size], wav_paths[eval_split_size:]


_FORKED = None  # the dataset a forked worker process serves


def _load_forked(idxs):
    return [_FORKED.load(int(i)) for i in idxs]


def _build_forked(segments, noises):
    return _FORKED.collate(segments, noises)


class GANDataset:
    """Random fixed-length segments with their mels: every batch has one
    shape."""

    def __init__(self, config, samples: List[str], is_eval: bool = False,
                 rng: Optional[np.random.RandomState] = None):
        self.config = config
        self.samples = samples
        self.is_eval = is_eval
        self.rng = rng
        self.seed = int(getattr(config, "seed", 54321))
        self.ap = AudioProcessor.init_from_config(config.audio, verbose=False)
        self.seq_len = config.seq_len
        self.hop_len = self.ap.hop_length
        self.pad_short = getattr(config, "pad_short", 0)
        self.use_noise_augment = getattr(config, "use_noise_augment", False) and not is_eval
        self.feat_frames = self.seq_len // self.hop_len
        self._cache = {} if getattr(config, "use_cache", False) else None

    def __len__(self):
        return len(self.samples)

    def load(self, idx: int) -> np.ndarray:
        """Clip ``idx``'s waveform, zero-padded to ``seq_len + pad_short``
        when shorter (kept when ``use_cache``)."""
        path = self.samples[idx]
        if self._cache is not None and path in self._cache:
            return self._cache[path]
        wav = self.ap.load_wav(path)
        if len(wav) < self.seq_len + self.pad_short:
            wav = np.pad(wav, (0, self.seq_len + self.pad_short - len(wav)))
        if self._cache is not None:
            self._cache[path] = wav
        return wav

    def draw(self, wav: np.ndarray, rng: np.random.RandomState):
        """A clip's segment (its start snapped to a hop) and its noise
        augmentation (``None`` without one), drawn from ``rng`` as the JAX
        dataset draws them from numpy's global state."""
        max_start = len(wav) - self.seq_len - 1
        start = 0 if self.is_eval or max_start <= 0 else rng.randint(0, max_start)
        start = (start // self.hop_len) * self.hop_len
        noise = (1.0 / 32768.0) * rng.randn(self.seq_len) if self.use_noise_augment else None
        return wav[start:start + self.seq_len], noise

    def item(self, seg: np.ndarray, noise: Optional[np.ndarray]) -> dict:
        """``{"waveform": [seq_len, 1], "mel": [seq_len // hop, M]}``, float32."""
        if noise is not None:
            seg = seg + noise
        mel = self.ap.melspectrogram(seg).astype(np.float32)[:, :self.feat_frames]
        return {"waveform": seg.astype(np.float32)[:, None], "mel": mel.T}

    def collate(self, segments, noises) -> dict:
        items = [self.item(s, n) for s, n in zip(segments, noises)]
        return {"waveform": np.stack([it["waveform"] for it in items]),
                "mel": np.stack([it["mel"] for it in items])}

    def epoch_rng(self, seed: int) -> np.random.RandomState:
        """The draws of ``batches(seed=seed)``: the dataset's ``rng`` when
        given, else a state seeded from ``(config seed, seed)``."""
        if self.rng is not None:
            return self.rng
        return np.random.RandomState(
            np.random.SeedSequence([self.seed, int(seed)]).generate_state(1))

    def batches(self, batch_size: int, shuffle: bool = True, seed: int = 0,
                drop_last: bool = False, num_workers: int = 0, prefetch: int = 2,
                worker_mode: str = "thread") -> Iterator[dict]:
        """Batches of ``batch_size`` in an order shuffled by
        ``RandomState(seed)`` (the JAX order), the last short one kept
        unless ``drop_last``. ``num_workers > 0`` loads and builds ahead on
        threads (``worker_mode="thread"``) or forked processes
        (``"process"``), ``prefetch`` batches deep."""
        order = np.arange(len(self.samples))
        if shuffle:
            np.random.RandomState(seed).shuffle(order)
        groups = [order[i:i + batch_size] for i in range(0, len(order), batch_size)]
        if drop_last:
            groups = [g for g in groups if len(g) == batch_size]
        rng = self.epoch_rng(seed)
        if not num_workers or num_workers <= 0 or len(groups) < 2:
            for idxs in groups:
                drawn = [self.draw(self.load(int(i)), rng) for i in idxs]
                yield self.collate([d[0] for d in drawn], [d[1] for d in drawn])
            return
        yield from self._pipelined(groups, rng, num_workers, max(1, prefetch), worker_mode)

    def _pipelined(self, groups, rng, num_workers: int, depth: int,
                   worker_mode: str) -> Iterator[dict]:
        """Loads and builds on workers, the draws here in batch order between
        the two: up to ``depth`` batches loading and ``depth`` building."""
        global _FORKED
        if worker_mode == "process":
            import multiprocessing as mp

            _FORKED = self
            pool = mp.get_context("fork").Pool(processes=num_workers)
            submit = lambda fn, *a: pool.apply_async(fn, a)  # noqa: E731
            get = lambda job: job.get()  # noqa: E731
            load, build = _load_forked, _build_forked
        else:
            from concurrent.futures import ThreadPoolExecutor

            pool = ThreadPoolExecutor(max_workers=num_workers)
            submit = pool.submit
            get = lambda job: job.result()  # noqa: E731
            load = lambda idxs: [self.load(int(i)) for i in idxs]  # noqa: E731
            build = self.collate
        try:
            loading = [submit(load, g) for g in groups[:depth]]
            next_load, building = depth, []
            while loading or building:
                while loading and len(building) < depth:
                    wavs = get(loading.pop(0))
                    if next_load < len(groups):
                        loading.append(submit(load, groups[next_load]))
                        next_load += 1
                    drawn = [self.draw(w, rng) for w in wavs]
                    building.append(submit(build, [d[0] for d in drawn],
                                           [d[1] for d in drawn]))
                yield get(building.pop(0))
        finally:
            if worker_mode == "process":
                pool.terminate()
                _FORKED = None
            else:
                pool.shutdown(wait=True, cancel_futures=True)
