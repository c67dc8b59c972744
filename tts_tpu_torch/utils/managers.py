"""Speaker, language and embedding managers (copied from
``tts_tpu/utils/managers.py``, reference ``TTS/tts/utils/managers.py``,
``speakers.py``, ``languages.py``; the port imports nothing of ``tts_tpu``).

Speaker, language and embedding files are JSON (``.json``), numpy archives
(``.npz``) or the reference's torch files (``.pth``, as the zoo ships
``speakers.pth``), which the port reads with ``torch.load(...,
weights_only=True)``; the JAX package's zoo converter rewrites those into
``.npz`` first.

Three differences from the source:

* ``SpeakerManager.init_from_config`` and ``LanguageManager.init_from_config``
  read each field from the top level of the config or from its
  ``model_args``, whichever sets it (:func:`config_setting`). The JAX
  package reads the top level only, so a VITS config that sets the speaker
  and language fields on ``model_args``, as both of the repo's recipes do,
  gets no manager there (ROADMAP.md F11).
* The speaker encoder (``init_encoder``, ``compute_embedding_from_clip``)
  is not ported: both raise ``NotImplementedError``.
* ``load_file`` reads ``.pth`` files natively.
"""

from __future__ import annotations

import json
import random
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch

__all__ = ["BaseIDManager", "EmbeddingManager", "SpeakerManager", "LanguageManager",
           "config_setting", "init_speaker_manager"]

_ENCODER = ("the speaker encoder (--encoder_path, d-vectors from a clip) is not ported to "
            "tts_tpu_torch yet (ROADMAP.md slice 3, item 15)")


def config_setting(config, name: str):
    """``name`` from the top level of ``config`` or from its ``model_args``,
    whichever sets it (the top level first); ``None`` where neither does."""
    for target in (config, getattr(config, "model_args", None)):
        value = getattr(target, name, None)
        if value:
            return value
    return None


def _plain(value):
    """Tensors of a torch-loaded file as lists, so that ids and embeddings
    read as they do from JSON."""
    if isinstance(value, dict):
        return {k: _plain(v) for k, v in value.items()}
    if isinstance(value, torch.Tensor):
        return value.tolist()
    return value


def load_file(path: str) -> Dict:
    if path.endswith(".pth"):
        return _plain(torch.load(path, map_location="cpu", weights_only=True))
    if path.endswith(".json"):
        with open(path, "r", encoding="utf-8") as f:
            return json.load(f)
    if path.endswith(".npz"):
        data = np.load(path, allow_pickle=True)
        return data["data"].item()
    raise ValueError(f" [!] Unsupported embedding file format {path}")


def save_file(obj: Any, path: str) -> None:
    if path.endswith(".json"):
        with open(path, "w", encoding="utf-8") as f:
            json.dump(obj, f, default=lambda o: np.asarray(o).tolist())
    elif path.endswith(".npz"):
        np.savez_compressed(path, data=np.asarray(obj, dtype=object))
    else:
        raise ValueError(f" [!] Unsupported embedding file format {path}")


class BaseIDManager:
    """name → id mapping (reference ``managers.py:36``)."""

    def __init__(self, id_file_path: str = ""):
        self.name_to_id: Dict[str, int] = {}
        if id_file_path:
            self.load_ids_from_file(id_file_path)

    def set_ids_from_data(self, items: List, parse_key: str) -> None:
        self.name_to_id = self.parse_ids_from_data(items, parse_key)

    def load_ids_from_file(self, file_path: str) -> None:
        self.name_to_id = load_file(file_path)

    def save_ids_to_file(self, file_path: str) -> None:
        save_file(self.name_to_id, file_path)

    def get_random_id(self) -> Any:
        if self.name_to_id:
            return self.name_to_id[random.choice(list(self.name_to_id))]
        return None

    @staticmethod
    def parse_ids_from_data(items: List, parse_key: str) -> Dict:
        classes = sorted({item[parse_key] for item in items})
        return {name: i for i, name in enumerate(classes)}


class EmbeddingManager(BaseIDManager):
    """d-vector storage (reference ``managers.py:109``)."""

    def __init__(
        self,
        embedding_file_path: Union[str, List[str]] = "",
        id_file_path: str = "",
        encoder_model_path: str = "",
        encoder_config_path: str = "",
    ):
        super().__init__(id_file_path)
        self.embeddings: Dict[str, Dict] = {}
        self.embeddings_by_names: Dict[str, List] = {}
        self.clip_ids: List[str] = []
        self.encoder = None
        self.encoder_ap = None
        if embedding_file_path:
            if isinstance(embedding_file_path, list):
                self.load_embeddings_from_list_of_files(embedding_file_path)
            else:
                self.load_embeddings_from_file(embedding_file_path)
        if encoder_model_path and encoder_config_path:
            self.init_encoder(encoder_model_path, encoder_config_path)

    # ------------------------------------------------------------------
    @property
    def num_embeddings(self) -> int:
        return len(self.embeddings)

    @property
    def embedding_dim(self) -> int:
        if self.embeddings:
            return len(list(self.embeddings.values())[0]["embedding"])
        return 0

    @property
    def embedding_names(self) -> List[str]:
        return list(self.embeddings_by_names.keys())

    def save_embeddings_to_file(self, file_path: str) -> None:
        save_file(self.embeddings, file_path)

    def load_embeddings_from_file(self, file_path: str) -> None:
        self._merge_embeddings(load_file(file_path))

    def load_embeddings_from_list_of_files(self, file_paths: List[str]) -> None:
        self.name_to_id = {}
        self.clip_ids = []
        self.embeddings = {}
        self.embeddings_by_names = {}
        for path in file_paths:
            self._merge_embeddings(load_file(path))

    def _merge_embeddings(self, embeddings: Dict) -> None:
        self.embeddings.update(embeddings)
        self.clip_ids = list(set(self.clip_ids + [e["name"] for e in embeddings.values()]))
        names = sorted({x["name"] for x in self.embeddings.values()})
        self.name_to_id = {name: i for i, name in enumerate(names)}
        self.embeddings_by_names = {}
        for x in self.embeddings.values():
            self.embeddings_by_names.setdefault(x["name"], []).append(x["embedding"])

    def get_embedding_by_clip(self, clip_idx: str) -> List:
        return self.embeddings[clip_idx]["embedding"]

    def get_embeddings_by_name(self, idx: str) -> List[List]:
        return self.embeddings_by_names[idx]

    def get_mean_embedding(self, idx: str, num_samples: Optional[int] = None,
                           randomize: bool = False) -> np.ndarray:
        embeddings = np.array(self.get_embeddings_by_name(idx))
        if num_samples is None:
            return embeddings.mean(0)
        assert len(embeddings) >= num_samples, f" [!] {idx} has <{num_samples} embeddings."
        if randomize:
            embeddings = np.random.permutation(embeddings)[:num_samples]
        else:
            embeddings = embeddings[:num_samples]
        return embeddings.mean(0)

    def get_random_embedding(self) -> Any:
        if self.embeddings:
            return self.embeddings[random.choice(list(self.embeddings))]["embedding"]
        return None

    def get_clips(self) -> List:
        return sorted(self.embeddings.keys())

    # ------------------------------------------------------------------
    def init_encoder(self, model_path: str, config_path: str, use_cuda: bool = False) -> None:
        raise NotImplementedError(_ENCODER)

    def compute_embedding_from_clip(self, wav_file: Union[str, List[str]]) -> List:
        raise NotImplementedError(_ENCODER)


class SpeakerManager(EmbeddingManager):
    """(reference ``speakers.py:14``)"""

    def __init__(
        self,
        data_items: Optional[List] = None,
        d_vectors_file_path: str = "",
        speaker_id_file_path: str = "",
        encoder_model_path: str = "",
        encoder_config_path: str = "",
        use_cuda: bool = False,
    ):
        super().__init__(
            embedding_file_path=d_vectors_file_path,
            id_file_path=speaker_id_file_path,
            encoder_model_path=encoder_model_path,
            encoder_config_path=encoder_config_path,
        )
        if data_items:
            self.set_ids_from_data(data_items, parse_key="speaker_name")

    @property
    def num_speakers(self) -> int:
        return len(self.name_to_id)

    @property
    def speaker_names(self) -> List[str]:
        return list(self.name_to_id.keys())

    @staticmethod
    def init_from_config(config, samples: Optional[List] = None) -> Optional["SpeakerManager"]:
        """(reference ``speakers.py:86``), each field from the top level or
        from ``model_args``."""
        speaker_manager = None
        if config_setting(config, "use_speaker_embedding"):
            if samples:
                speaker_manager = SpeakerManager(data_items=samples)
            if config_setting(config, "speaker_file"):
                speaker_manager = SpeakerManager(
                    speaker_id_file_path=config_setting(config, "speaker_file"))
            if config_setting(config, "speakers_file"):
                speaker_manager = SpeakerManager(
                    speaker_id_file_path=config_setting(config, "speakers_file"))
        if config_setting(config, "use_d_vector_file"):
            speaker_manager = SpeakerManager()
            if config_setting(config, "d_vector_file"):
                speaker_manager = SpeakerManager(
                    d_vectors_file_path=config_setting(config, "d_vector_file"))
        return speaker_manager


class LanguageManager(BaseIDManager):
    """(reference ``languages.py:13``)"""

    def __init__(self, language_ids_file_path: str = "", config=None):
        super().__init__(id_file_path=language_ids_file_path)
        if config:
            self.set_language_ids_from_config(config)

    @property
    def num_languages(self) -> int:
        return len(self.name_to_id)

    @property
    def language_names(self) -> List[str]:
        return list(self.name_to_id.keys())

    def set_language_ids_from_config(self, c) -> None:
        languages = set()
        for dataset in c.datasets:
            lang = dataset["language"] if isinstance(dataset, dict) else dataset.language
            if lang:
                languages.add(lang)
            else:
                raise ValueError(f" [!] Dataset {dataset} has no language specified.")
        self.name_to_id = {name: i for i, name in enumerate(sorted(languages))}

    @staticmethod
    def init_from_config(config) -> Optional["LanguageManager"]:
        """Each field from the top level or from ``model_args``."""
        if config_setting(config, "language_ids_file"):
            return LanguageManager(language_ids_file_path=config_setting(config, "language_ids_file"))
        if config_setting(config, "use_language_embedding") and getattr(config, "datasets", None):
            return LanguageManager(config=config)
        return None


def init_speaker_manager(model, config, samples=None):
    """Attach ``speaker_manager`` and ``language_manager`` to ``model`` and
    write their counts into ``num_speakers`` and ``num_languages`` of the
    config's top level and ``model_args``, where those fields exist (copied
    from ``tts_tpu/models/base.py``, reference ``base_tts.py:79``
    ``init_multispeaker``)."""
    speaker_manager = SpeakerManager.init_from_config(config, samples)
    language_manager = LanguageManager.init_from_config(config)
    model.speaker_manager = speaker_manager
    model.language_manager = language_manager
    num_speakers = speaker_manager.num_speakers if speaker_manager else 0
    for target in (config, getattr(config, "model_args", None)):
        if target is None:
            continue
        if hasattr(target, "num_speakers") and num_speakers:
            target.num_speakers = num_speakers
        if language_manager and hasattr(target, "num_languages"):
            target.num_languages = language_manager.num_languages
    return model
