"""TTS dataset with length-bucketed batching (port of
``tts_tpu/data/dataset.py``, copied unchanged; reference
``TTS/tts/datasets/dataset.py``).

Samples are sorted by audio length, grouped into consecutive batches, and
every batch is padded up to ``pad_to_multiple_*`` boundaries, so a run sees
few distinct shapes. :meth:`TTSDataset.batches` yields the same numpy
batches, in the same order for the same seed, as the JAX package's: the
features come from the port's ``AudioProcessor`` (a copy of the JAX one),
the weighted picks and the shuffle from ``np.random.RandomState(seed)``.
With ``compute_mel=False`` (a port option for models that read only the
waveform, as VITS's step does) the batch is the same without
``mel_input``: ``mel_lengths`` counts the frames the mel would have.
Workers (threads, or processes) build batches ahead of the consumer
without changing them or their order.

Feature caches (token ids, f0, energy) mirror the reference's
``PhonemeDataset``/``F0Dataset``/``EnergyDataset`` (``dataset.py:577-973``)
as simple on-disk ``.npy`` caches.

F60, settled in the port: the JAX pipeline feeds the models raw f0 in Hz
and raw energy. The reference normalises both by the training set's
statistics, and the port does too: :meth:`TTSDataset.feature_stats` fills a
feature's cache over the samples and takes the mean and standard deviation
of the voiced (non-zero) frames, written to ``pitch_stats.npy`` /
``energy_stats.npy`` in the cache directory (the reference's ``{"mean",
"std"}`` file) and read back when that file exists; with ``pitch_stats`` /
``energy_stats`` set, each item's voiced frames become ``(x - mean) / std``
and its unvoiced frames stay 0. The raw cached features, and every batch
of a dataset without statistics, are the JAX package's bit for bit.
"""

from __future__ import annotations

import os
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from tts_tpu_torch.ops.helpers import compute_attn_prior


def _pad_to(x: np.ndarray, length: int, axis: int = 0, mode="constant") -> np.ndarray:
    pad = [(0, 0)] * x.ndim
    pad[axis] = (0, max(0, length - x.shape[axis]))
    return np.pad(x, pad, mode=mode)


def audio_length_samples(path: str, target_sr: Optional[int] = None) -> float:
    """Audio length in samples, decoded from the container header only
    (no full decode; fixes the reference-era ``filesize/2`` estimate that
    was wrong for flac/mp3).  Returns samples at the file's native rate,
    rescaled to ``target_sr`` when given."""
    n, sr = None, None
    try:
        ext = os.path.splitext(path)[1].lower()
        if ext == ".wav":
            import wave

            with wave.open(path, "rb") as w:
                n, sr = w.getnframes(), w.getframerate()
        elif ext == ".flac":
            with open(path, "rb") as f:
                if f.read(4) == b"fLaC":
                    # STREAMINFO is the mandatory first metadata block
                    f.read(4)  # block header
                    info = f.read(34)
                    sr = (info[10] << 12) | (info[11] << 4) | (info[12] >> 4)
                    n = ((info[13] & 0x0F) << 32) | int.from_bytes(info[14:18], "big")
        elif ext == ".mp3":
            size = os.path.getsize(path)
            with open(path, "rb") as f:
                head = f.read(65536)
            # skip ID3v2 tag if present
            off = 0
            if head[:3] == b"ID3":
                off = 10 + int.from_bytes(bytes(b & 0x7F for b in head[6:10]), "big")
            i = head.find(b"\xff", off)
            while i >= 0 and i + 4 <= len(head):
                b1, b2 = head[i + 1], head[i + 2]
                if (b1 & 0xE0) == 0xE0 and (b1 & 0x18) != 0x08 and (b2 >> 4) not in (0, 15):
                    ver = (b1 >> 3) & 3  # 3=MPEG1, 2=MPEG2, 0=MPEG2.5
                    br_idx, sr_idx = b2 >> 4, (b2 >> 2) & 3
                    sr_tab = {3: (44100, 48000, 32000), 2: (22050, 24000, 16000), 0: (11025, 12000, 8000)}
                    br_v1 = (0, 32, 40, 48, 56, 64, 80, 96, 112, 128, 160, 192, 224, 256, 320)
                    br_v2 = (0, 8, 16, 24, 32, 40, 48, 56, 64, 80, 96, 112, 128, 144, 160)
                    if sr_idx < 3 and ver in sr_tab:
                        sr = sr_tab[ver][sr_idx]
                        kbps = (br_v1 if ver == 3 else br_v2)[br_idx]
                        if kbps:
                            n = size * 8.0 / (kbps * 1000.0) * sr  # CBR estimate
                        break
                i = head.find(b"\xff", i + 1)
    except (OSError, EOFError, ValueError):
        pass
    if n is None or not sr:
        return os.path.getsize(path) / 2  # legacy 16-bit-PCM estimate
    if target_sr and sr and target_sr != sr:
        return float(n) * target_sr / sr
    return float(n)


_FORKED_DATASET = None


def normalize_voiced(feat: np.ndarray, stats: Optional[Tuple[float, float]]) -> np.ndarray:
    """``(feat - mean) / std`` on the non-zero frames, 0 on the others
    (reference ``F0Dataset.normalize``), in float32; ``feat`` as it is
    without ``stats``."""
    if stats is None:
        return feat
    mean, std = np.float32(stats[0]), np.float32(stats[1])
    return np.where(feat != 0.0, (feat - mean) / std, np.float32(0.0)).astype(np.float32)


def _init_worker(dataset):
    """Pool initializer for the ``spawn`` start method: the pickled dataset
    arrives once per worker instead of being inherited by fork."""
    global _FORKED_DATASET
    _FORKED_DATASET = dataset


def _build_batch_forked(batch_idxs):
    ds = _FORKED_DATASET
    return ds.collate([ds[int(i)] for i in batch_idxs])


def round_up(x: int, multiple: int) -> int:
    return ((x + multiple - 1) // multiple) * multiple


class TTSDataset:
    """Host-side dataset: wav → features, text → token ids, bucketed batches.

    Args mirror the reference's ``TTSDataset`` (``dataset.py:56``) where they
    matter; iteration yields numpy dict batches with the reference's keys.
    """

    def __init__(
        self,
        samples: List[dict],
        ap,
        tokenizer,
        outputs_per_step: int = 1,
        compute_linear_spec: bool = False,
        compute_mel: bool = True,
        return_wav: bool = False,
        compute_f0: bool = False,
        compute_energy: bool = False,
        use_attn_prior: bool = False,
        min_text_len: int = 0,
        max_text_len: float = float("inf"),
        min_audio_len: int = 0,
        max_audio_len: float = float("inf"),
        phoneme_cache_path: Optional[str] = None,
        f0_cache_path: Optional[str] = None,
        energy_cache_path: Optional[str] = None,
        speaker_id_mapping: Optional[Dict] = None,
        language_id_mapping: Optional[Dict] = None,
        d_vector_mapping: Optional[Dict] = None,
        pad_to_multiple_text: int = 16,
        pad_to_multiple_mel: int = 32,
        use_noise_augment: bool = False,
        verbose: bool = False,
        pitch_stats: Optional[Tuple[float, float]] = None,
        energy_stats: Optional[Tuple[float, float]] = None,
    ):
        self.samples = samples
        self.ap = ap
        self.tokenizer = tokenizer
        self.outputs_per_step = outputs_per_step
        self.compute_linear_spec = compute_linear_spec
        self.compute_mel = compute_mel
        self.return_wav = return_wav
        self.compute_f0 = compute_f0
        self.compute_energy = compute_energy
        self.use_attn_prior = use_attn_prior
        self.min_text_len = min_text_len
        self.max_text_len = max_text_len
        self.min_audio_len = min_audio_len
        self.max_audio_len = max_audio_len
        self.phoneme_cache_path = phoneme_cache_path
        self.f0_cache_path = f0_cache_path
        self.energy_cache_path = energy_cache_path
        self.speaker_id_mapping = speaker_id_mapping
        self.language_id_mapping = language_id_mapping
        self.d_vector_mapping = d_vector_mapping
        self.pad_to_multiple_text = pad_to_multiple_text
        self.pad_to_multiple_mel = pad_to_multiple_mel
        self.use_noise_augment = use_noise_augment
        self.verbose = verbose
        self.pitch_stats = pitch_stats
        self.energy_stats = energy_stats
        self._token_cache: Dict[str, np.ndarray] = {}
        if phoneme_cache_path:
            os.makedirs(phoneme_cache_path, exist_ok=True)

    # ------------------------------------------------------------------
    def __len__(self) -> int:
        return len(self.samples)

    def _token_ids(self, sample: dict) -> np.ndarray:
        key = sample["audio_unique_name"]
        if key in self._token_cache:
            return self._token_cache[key]
        if self.phoneme_cache_path:
            cache_file = os.path.join(
                self.phoneme_cache_path, key.replace("#", "_").replace(os.sep, "_") + ".npy"
            )
            if os.path.exists(cache_file):
                ids = np.load(cache_file)
                self._token_cache[key] = ids
                return ids
        ids = np.asarray(
            self.tokenizer.text_to_ids(sample["text"], language=sample.get("language") or None),
            dtype=np.int32,
        )
        if self.phoneme_cache_path:
            np.save(cache_file, ids)
        self._token_cache[key] = ids
        return ids

    def preprocess_samples(self) -> None:
        """Drop samples outside the length limits (reference ``dataset.py:353``)."""
        kept = []
        target_sr = getattr(self.ap, "sample_rate", None)
        for s in self.samples:
            audio_len = audio_length_samples(s["audio_file"], target_sr)
            text_len = len(self._token_ids(s))
            if (
                self.min_text_len <= text_len <= self.max_text_len
                and self.min_audio_len <= audio_len <= self.max_audio_len
            ):
                s["audio_length"] = audio_len
                s["text_length"] = text_len
                kept.append(s)
        if self.verbose:
            print(f" | > Preprocessing: kept {len(kept)}/{len(self.samples)} samples")
        self.samples = kept

    def __getitem__(self, idx: int) -> dict:
        s = self.samples[idx]
        wav = self.ap.load_wav(s["audio_file"])
        if self.use_noise_augment:
            wav = wav + (1.0 / 32768.0) * np.random.rand(*wav.shape)
        token_ids = self._token_ids(s)
        item = {
            "raw_text": s["text"],
            "token_ids": token_ids,
            "wav": wav.astype(np.float32),
            "n_frames": self._n_frames(len(wav)),
            "item_idx": s["audio_file"],
            "speaker_name": s.get("speaker_name"),
            "language_name": s.get("language"),
            "audio_unique_name": s["audio_unique_name"],
        }
        if self.compute_mel:
            item["mel"] = self.ap.melspectrogram(wav).astype(np.float32).T  # time-major [T, M]
        if self.compute_linear_spec:
            item["linear"] = self.ap.spectrogram(wav).astype(np.float32).T
        if self.compute_f0:
            item["pitch"] = normalize_voiced(self._cached_feature("f0", s, wav),
                                             self.pitch_stats)
        if self.compute_energy:
            item["energy"] = normalize_voiced(self._cached_feature("energy", s, wav),
                                              self.energy_stats)
        return item

    def feature_stats(self, kind: str) -> Tuple[float, float]:
        """F60: the mean and standard deviation of ``kind``'s (``"f0"`` or
        ``"energy"``) voiced frames over every sample, the cache filled on
        the way; read from, or written to, ``pitch_stats.npy`` /
        ``energy_stats.npy`` in the feature's cache directory (reference
        ``F0Dataset.compute_pitch_stats``)."""
        cache_dir = self.f0_cache_path if kind == "f0" else self.energy_cache_path
        name = "pitch_stats.npy" if kind == "f0" else "energy_stats.npy"
        path = os.path.join(cache_dir, name) if cache_dir else None
        if path and os.path.exists(path):
            stats = np.load(path, allow_pickle=True).item()
            return float(stats["mean"]), float(stats["std"])
        voiced = []
        for s in self.samples:
            feat = self._cached_feature(kind, s, None)
            voiced.append(feat[feat != 0.0])
        voiced = np.concatenate(voiced).astype(np.float64)
        mean, std = float(np.mean(voiced)), float(np.std(voiced))
        if path:
            os.makedirs(cache_dir, exist_ok=True)
            np.save(path, {"mean": np.float64(mean), "std": np.float64(std)})
        return mean, std

    def _n_frames(self, n_samples: int) -> int:
        """The spectrograms' frame count for ``n_samples`` (``stft``'s centred
        framing)."""
        fft, hop = self.ap.fft_size, self.ap.hop_length
        return 1 + (n_samples + 2 * (fft // 2) - fft) // hop

    def _cached_feature(self, kind: str, sample: dict, wav: np.ndarray) -> np.ndarray:
        cache_dir = self.f0_cache_path if kind == "f0" else self.energy_cache_path
        key = sample["audio_unique_name"].replace("#", "_").replace(os.sep, "_")
        if cache_dir:
            os.makedirs(cache_dir, exist_ok=True)
            cache_file = os.path.join(cache_dir, f"{key}_{kind}.npy")
            if os.path.exists(cache_file):
                return np.load(cache_file)
        if wav is None:
            wav = self.ap.load_wav(sample["audio_file"])
        if kind == "f0":
            feat = self.ap.compute_f0(wav).astype(np.float32)
        else:
            from tts_tpu_torch.audio.numpy_transforms import compute_energy as _ce

            feat = _ce(wav, **self.ap._stft_kwargs()).astype(np.float32)
        if cache_dir:
            np.save(cache_file, feat)
        return feat

    # ------------------------------------------------------------------
    def lengths(self) -> List[int]:
        return [
            int(s.get("audio_length", audio_length_samples(s["audio_file"])))
            for s in self.samples
        ]

    def batches(
        self,
        batch_size: int,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = False,
        weights: Optional[np.ndarray] = None,
        num_workers: int = 0,
        prefetch: int = 2,
        worker_mode: str = "thread",
    ) -> Iterator[dict]:
        """Yield padded batches, bucketed by length for static shapes.

        Samples are sorted by audio length, grouped into consecutive
        batches (like the reference's length-sorted batching +
        ``batch_group_size`` shuffle), and each batch is padded up to
        ``pad_to_multiple_*`` boundaries.

        ``weights`` resamples indices proportionally per epoch (the
        reference's WeightedRandomSampler path, ``vits.py:1548``).
        ``num_workers > 0`` loads/collates batches on a thread pool with a
        bounded ``prefetch`` queue so host DSP overlaps device compute
        (replaces the reference's multi-worker DataLoader).
        """
        rng = np.random.RandomState(seed)
        if weights is not None:
            w = np.asarray(weights, np.float64)
            w = w / w.sum()
            picked = rng.choice(len(self.samples), size=len(self.samples), p=w)
            lengths = np.asarray([self.samples[i].get("audio_length", 0) for i in picked])
            order = picked[np.argsort(lengths)]
        else:
            order = np.argsort([s.get("audio_length", 0) for s in self.samples])
        batches = [
            order[i : i + batch_size] for i in range(0, len(order), batch_size)
        ]
        if drop_last and len(batches) and len(batches[-1]) < batch_size:
            batches = batches[:-1]
        if shuffle:
            rng.shuffle(batches)
        if num_workers and num_workers > 0 and len(batches) > 1:
            if worker_mode == "process":
                yield from self._prefetched_processes(batches, num_workers, prefetch)
            else:
                yield from self._prefetched(batches, num_workers, prefetch)
        else:
            for batch_idxs in batches:
                yield self.collate([self[int(i)] for i in batch_idxs])

    def _prefetched(self, batches, num_workers: int, prefetch: int) -> Iterator[dict]:
        """Assemble batches on a bounded thread pool (pipeline depth
        ``prefetch``): the consumer pops batch k while workers build k+1…"""
        from concurrent.futures import ThreadPoolExecutor

        def build(batch_idxs):
            return self.collate([self[int(i)] for i in batch_idxs])

        with ThreadPoolExecutor(max_workers=num_workers) as pool:
            depth = max(1, prefetch)
            pending = [pool.submit(build, b) for b in batches[:depth]]
            next_submit = depth
            while pending:
                fut = pending.pop(0)
                if next_submit < len(batches):
                    pending.append(pool.submit(build, batches[next_submit]))
                    next_submit += 1
                yield fut.result()

    def _prefetched_processes(
        self, batches, num_workers: int, prefetch: int, start_method: Optional[str] = None
    ) -> Iterator[dict]:
        """Assemble batches in worker PROCESSES (GIL-free; the thread-pool
        path only overlaps inside numpy's GIL releases, so heavy text or f0
        pipelines still starve the device; the reference uses DataLoader
        worker processes).

        Start method: ``fork`` (children inherit the dataset without
        pickling, and only run numpy, so a live CUDA context in this
        process is no obstacle), unless JAX has started its backends in
        this process: forking live JAX threads can deadlock the child (fork
        clones only the calling thread), so then ``spawn``, whose workers
        receive the dataset once through the pool initializer. Only a
        process that runs both packages meets that case; this module never
        imports JAX.
        """
        import multiprocessing as mp

        if start_method is None:
            import sys

            jax_live = False
            jax_mod = sys.modules.get("jax")
            if jax_mod is not None:
                try:
                    jax_live = bool(jax_mod._src.xla_bridge._backends)
                except Exception:
                    jax_live = True  # imported but unprobeable: play safe
            start_method = "spawn" if jax_live else "fork"

        global _FORKED_DATASET
        ctx = mp.get_context(start_method)
        _FORKED_DATASET = self
        pool_kwargs = (
            {"initializer": _init_worker, "initargs": (self,)}
            if start_method != "fork"
            else {}
        )
        try:
            with ctx.Pool(processes=num_workers, **pool_kwargs) as pool:
                depth = max(1, prefetch)
                idx_lists = [[int(i) for i in b] for b in batches]
                pending = [
                    pool.apply_async(_build_batch_forked, (b,)) for b in idx_lists[:depth]
                ]
                next_submit = depth
                while pending:
                    res = pending.pop(0)
                    if next_submit < len(idx_lists):
                        pending.append(
                            pool.apply_async(_build_batch_forked, (idx_lists[next_submit],))
                        )
                        next_submit += 1
                    yield res.get()
        finally:
            _FORKED_DATASET = None

    def collate(self, items: List[dict]) -> dict:
        """Pad a list of items into one static-shape numpy batch."""
        B = len(items)
        r = self.outputs_per_step
        text_lens = np.asarray([len(it["token_ids"]) for it in items], np.int32)
        mel_lens = np.asarray([it["n_frames"] for it in items], np.int32)
        T_en = round_up(int(text_lens.max()), self.pad_to_multiple_text)
        # bucket boundary first, then the reduction factor on top so T_de
        # stays divisible by r even when r doesn't divide the mel multiple
        # (gradual-training r ∈ {7,5,3,…})
        T_de = round_up(round_up(int(mel_lens.max()), self.pad_to_multiple_mel), r)

        token_ids = np.stack([_pad_to(it["token_ids"], T_en) for it in items])
        stop_targets = np.zeros((B, T_de), np.float32)
        for i, L in enumerate(mel_lens):
            stop_targets[i, L - 1 :] = 1.0

        batch = {
            "text_input": token_ids.astype(np.int32),
            "text_lengths": text_lens,
            "mel_lengths": mel_lens,
            "stop_targets": stop_targets,
            "item_idxs": [it["item_idx"] for it in items],
            "speaker_names": [it["speaker_name"] for it in items],
            "raw_text": [it["raw_text"] for it in items],
            "audio_unique_names": [it["audio_unique_name"] for it in items],
        }
        if self.compute_mel:
            batch["mel_input"] = np.stack([_pad_to(it["mel"], T_de) for it in items]).astype(
                np.float32
            )
        if self.compute_linear_spec:
            batch["spec"] = np.stack([_pad_to(it["linear"], T_de) for it in items]).astype(
                np.float32
            )
            batch["spec_lengths"] = mel_lens
        if self.return_wav:
            T_wav = T_de * self.ap.hop_length
            wavs = []
            for it in items:
                w = _pad_to(it["wav"][:T_wav], T_wav)
                wavs.append(w)
            batch["waveform"] = np.stack(wavs)[:, :, None].astype(np.float32)
        if self.compute_f0:
            batch["pitch"] = np.stack(
                [_pad_to(it["pitch"][:T_de], T_de) for it in items]
            ).astype(np.float32)[:, :, None]
        if self.compute_energy:
            batch["energy"] = np.stack(
                [_pad_to(it["energy"][:T_de], T_de) for it in items]
            ).astype(np.float32)[:, :, None]
        if self.use_attn_prior:
            prior = np.zeros((B, T_de, T_en), np.float32)
            for i, it in enumerate(items):
                p = compute_attn_prior(int(text_lens[i]), int(mel_lens[i]))
                prior[i, : p.shape[0], : p.shape[1]] = p
            batch["attn_priors"] = prior
        if self.speaker_id_mapping:
            batch["speaker_ids"] = np.asarray(
                [self.speaker_id_mapping[it["speaker_name"]] for it in items], np.int32
            )
        if self.language_id_mapping:
            batch["language_ids"] = np.asarray(
                [self.language_id_mapping[it["language_name"]] for it in items], np.int32
            )
        if self.d_vector_mapping:
            batch["d_vectors"] = np.asarray(
                [self.d_vector_mapping[it["audio_unique_name"]]["embedding"] for it in items],
                np.float32,
            )
        return batch
