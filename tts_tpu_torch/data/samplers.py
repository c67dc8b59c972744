"""Weighted and balanced sampling (port of ``tts_tpu/data/samplers.py``,
copied unchanged; reference ``TTS/utils/samplers.py`` and the language and
speaker balancer weights of ``tts/utils/languages.py:96`` / ``speakers.py``):
inverse-frequency weights by language, speaker or length decile,
``WeightedSampler``, ``PerfectBatchSampler`` and ``BucketBatchSampler``.
Host numpy; on one device no distributed sampler is needed.
"""

from __future__ import annotations

import random
from typing import List, Optional

import numpy as np


def get_attribute_balancer_weights(items: List[dict], attr_name: str, multi_dict=None) -> np.ndarray:
    """Inverse-frequency weights per sample for the given attribute
    (reference ``languages.py:96`` pattern)."""
    attr_names = [item[attr_name] for item in items]
    unique_names = sorted(set(attr_names))
    counts = {name: attr_names.count(name) for name in unique_names}
    weights = np.array([1.0 / counts[name] for name in attr_names])
    if multi_dict is not None:
        weights = weights * np.array([multi_dict.get(name, 1.0) for name in attr_names])
    return weights / weights.sum() * len(weights)


def get_language_balancer_weights(items: List[dict]) -> np.ndarray:
    return get_attribute_balancer_weights(items, "language")


def get_speaker_balancer_weights(items: List[dict]) -> np.ndarray:
    return get_attribute_balancer_weights(items, "speaker_name")


def get_length_balancer_weights(items: List[dict], num_buckets: int = 10) -> np.ndarray:
    """Inverse-frequency weights over audio-length deciles
    (reference ``tts/utils/data.py``)."""
    lengths = np.array([item.get("audio_length", 0) for item in items], dtype=np.float64)
    edges = np.quantile(lengths, np.linspace(0, 1, num_buckets + 1)[1:-1])
    bucket_ids = np.searchsorted(edges, lengths)
    counts = np.bincount(bucket_ids, minlength=num_buckets).astype(np.float64)
    counts[counts == 0] = 1
    weights = 1.0 / counts[bucket_ids]
    return weights / weights.sum() * len(weights)


class WeightedSampler:
    """Sample indices proportionally to weights (torch WeightedRandomSampler
    equivalent)."""

    def __init__(self, weights: np.ndarray, num_samples: Optional[int] = None, seed: int = 0):
        self.weights = np.asarray(weights, np.float64)
        self.weights = self.weights / self.weights.sum()
        self.num_samples = num_samples or len(weights)
        self.rng = np.random.RandomState(seed)

    def __iter__(self):
        return iter(self.rng.choice(len(self.weights), self.num_samples, p=self.weights))

    def __len__(self):
        return self.num_samples


class PerfectBatchSampler:
    """Class-balanced batches: each batch has ``batch_size/num_classes``
    samples per class (reference ``utils/samplers.py:27``; used by the
    speaker-encoder GE2E training)."""

    def __init__(
        self,
        dataset_items: List[dict],
        classes: List[str],
        batch_size: int,
        num_classes_in_batch: int,
        num_gpus: int = 1,
        shuffle: bool = True,
        drop_last: bool = False,
        label_key: str = "class_name",
    ):
        assert batch_size % (num_classes_in_batch * num_gpus) == 0, (
            "Batch size must be divisible by number of classes times the number of data parallel devices."
        )
        label_indices = {}
        for idx, item in enumerate(dataset_items):
            label = item[label_key]
            label_indices.setdefault(label, []).append(idx)
        self.shuffle = shuffle
        self._samplers = {c: label_indices[c] for c in classes if c in label_indices}
        self._classes = [c for c in classes if c in label_indices]
        self._batch_size = batch_size
        self._drop_last = drop_last
        self._dp_devices = num_gpus
        self._num_classes_in_batch = num_classes_in_batch

    def __iter__(self):
        batch = []
        if self._num_classes_in_batch != len(self._classes):
            valid_classes = random.sample(self._classes, self._num_classes_in_batch)
        else:
            valid_classes = list(self._classes)
        iters = {}
        for c in self._classes:
            idxs = list(self._samplers[c])
            if self.shuffle:
                random.shuffle(idxs)
            iters[c] = iter(idxs)
        done = False
        while not done:
            for c in valid_classes:
                try:
                    batch.append(next(iters[c]))
                except StopIteration:
                    done = True
                    break
                if len(batch) == self._batch_size:
                    yield batch
                    batch = []
        if not self._drop_last and batch:
            groups = len(batch) // self._num_classes_in_batch
            if groups % self._dp_devices == 0 and batch:
                yield batch

    def __len__(self):
        class_batch_size = self._batch_size // self._num_classes_in_batch
        return min(
            (len(s) + class_batch_size - 1) // class_batch_size for s in self._samplers.values()
        )


class BucketBatchSampler:
    """Batch indices whose lengths fall in the same bucket
    (reference ``utils/samplers.py:153``)."""

    def __init__(
        self,
        lengths: List[int],
        batch_size: int,
        num_buckets: int = 10,
        shuffle: bool = True,
        drop_last: bool = False,
        seed: int = 0,
    ):
        lengths = np.asarray(lengths)
        edges = np.quantile(lengths, np.linspace(0, 1, num_buckets + 1)[1:-1])
        bucket_ids = np.searchsorted(edges, lengths)
        self.buckets = [np.nonzero(bucket_ids == b)[0] for b in range(num_buckets)]
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.rng = np.random.RandomState(seed)

    def __iter__(self):
        batches = []
        for bucket in self.buckets:
            idxs = bucket.copy()
            if self.shuffle:
                self.rng.shuffle(idxs)
            for i in range(0, len(idxs), self.batch_size):
                b = idxs[i : i + self.batch_size]
                if self.drop_last and len(b) < self.batch_size:
                    continue
                if len(b):
                    batches.append(list(b))
        if self.shuffle:
            self.rng.shuffle(batches)
        return iter(batches)
