"""Data layer (port of ``tts_tpu/data/__init__.py``, copied unchanged;
reference ``TTS/tts/datasets/__init__.py``): sample loading through the
formatters, the speaker-aware eval split (the same ``np.random.seed(0)``
shuffle, so both packages split a corpus alike), the extra keys, and the
formatter lookup by name. Datasets and samplers live in ``dataset.py`` and
``samplers.py``.
"""

from __future__ import annotations

import os
from collections import Counter
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np

from . import formatters as _formatters


def split_dataset(items, eval_split_max_size=None, eval_split_size=0.01):
    """Speaker-aware train/eval split (reference ``datasets/__init__.py:13``)."""
    speakers = [item["speaker_name"] for item in items]
    is_multi_speaker = len(set(speakers)) > 1
    if eval_split_size > 1:
        eval_split_size = int(eval_split_size)
    else:
        if eval_split_max_size:
            eval_split_size = min(eval_split_max_size, int(len(items) * eval_split_size))
        else:
            eval_split_size = int(len(items) * eval_split_size)
    assert eval_split_size > 0, (
        " [!] You do not have enough samples for the evaluation set. "
        f"You can work around this setting the 'eval_split_size' parameter to a minimum of {1 / len(items)}"
    )
    np.random.seed(0)
    np.random.shuffle(items)
    if is_multi_speaker:
        items_eval = []
        speaker_counter = Counter(item["speaker_name"] for item in items)
        while len(items_eval) < eval_split_size:
            item_idx = np.random.randint(0, len(items))
            speaker_to_be_removed = items[item_idx]["speaker_name"]
            if speaker_counter[speaker_to_be_removed] > 1:
                items_eval.append(items[item_idx])
                speaker_counter[speaker_to_be_removed] -= 1
                del items[item_idx]
        return items_eval, items
    return items[:eval_split_size], items[eval_split_size:]


def add_extra_keys(metadata, language, dataset_name):
    for item in metadata:
        item["language"] = language
        relfilepath = os.path.splitext(os.path.relpath(item["audio_file"], item["root_path"]))[0]
        item["audio_unique_name"] = f"{dataset_name}#{relfilepath}"
    return metadata


def load_tts_samples(
    datasets: Union[List, Dict],
    eval_split: bool = True,
    formatter: Optional[Callable] = None,
    eval_split_max_size=None,
    eval_split_size: float = 0.01,
) -> Tuple[List[dict], Optional[List[dict]]]:
    """Parse dataset configs into (train, eval) sample lists
    (reference ``datasets/__init__.py:70``)."""
    meta_data_train_all: List[dict] = []
    meta_data_eval_all: Optional[List[dict]] = [] if eval_split else None
    if not isinstance(datasets, list):
        datasets = [datasets]
    for dataset in datasets:
        formatter_name = dataset["formatter"]
        dataset_name = dataset["dataset_name"]
        root_path = dataset["path"]
        meta_file_train = dataset["meta_file_train"]
        meta_file_val = dataset["meta_file_val"]
        ignored_speakers = dataset.get("ignored_speakers")
        language = dataset["language"]

        fmt = formatter or get_formatter_by_name(formatter_name)
        meta_data_train = fmt(root_path, meta_file_train, ignored_speakers=ignored_speakers)
        assert len(meta_data_train) > 0, f" [!] No training samples found in {root_path}/{meta_file_train}"
        meta_data_train = add_extra_keys(meta_data_train, language, dataset_name)
        print(f" | > Found {len(meta_data_train)} files in {Path(root_path).resolve()}")

        if eval_split:
            if meta_file_val:
                meta_data_eval = fmt(root_path, meta_file_val, ignored_speakers=ignored_speakers)
                meta_data_eval = add_extra_keys(meta_data_eval, language, dataset_name)
            else:
                eval_size_per_dataset = (
                    eval_split_max_size // len(datasets) if eval_split_max_size else None
                )
                meta_data_eval, meta_data_train = split_dataset(
                    meta_data_train, eval_size_per_dataset, eval_split_size
                )
            meta_data_eval_all += meta_data_eval
        meta_data_train_all += meta_data_train
    return meta_data_train_all, meta_data_eval_all


def get_formatter_by_name(name: str) -> Callable:
    """Look up a formatter function by lowercase name."""
    fmt = getattr(_formatters, name.lower(), None)
    if fmt is None:
        raise ValueError(f" [!] Unknown dataset formatter {name!r}")
    return fmt
