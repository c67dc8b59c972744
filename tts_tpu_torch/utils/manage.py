"""Model zoo manager of the port (copied from ``tts_tpu/utils/manage.py:1-273``,
reference ``TTS/utils/manage.py``; the port imports nothing of ``tts_tpu``).

The catalog is the port's own copy of the zoo list
(``tts_tpu_torch/zoo/models.json``, 88 entries: 70 tts, 17 vocoder, 1 vc),
held equal to the JAX package's by ``tests/test_torch_host_copies.py``.
Models live in the JAX package's data directory, ``$TTS_HOME/tts_tpu`` or
``$XDG_DATA_HOME/tts_tpu`` (``~/.local/share/tts_tpu``), one directory per
model named ``<type>--<lang>--<dataset>--<model>``; ``TTS_TPU_MODELS_FILE``
replaces the catalog. A directory that already holds the model's files is
used as it is: nothing is fetched.

Differences from the source:

* ``download_model`` converts nothing: the port loads the reference-layout
  ``.pth`` itself, where the JAX package converts it to a flax
  ``.msgpack`` on first use (``tts_tpu.utils.zoo_convert``).
* ``_find_files`` never returns a ``.msgpack`` or ``.flax`` file, which the
  JAX package may have written into the same shared directory: it takes the
  reference checkpoint.
* The fairseq MMS models (``tts_models/<lang>/fairseq/vits``) raise
  ``NotImplementedError`` before any fetch: the JAX package cannot load
  them and the reference's loader is not in the repository (ROADMAP.md
  F35); ``utils.convert.convert_fairseq_vits`` and ``FairseqVocab`` are
  ported.
* ``_update_paths`` also points ``audio.stats_path`` at the directory's
  ``scale_stats.npy``, as the reference does and the JAX copy does not
  (ROADMAP.md F17), and ``speaker_encoder_model_path`` and
  ``speaker_encoder_config_path`` (top level and ``model_args``) at the
  directory's ``model_se.pth.tar`` (or ``model_se.pth``) and
  ``config_se.json``, as the reference does for YourTTS; the JAX copy
  leaves them at the trainer's paths (ROADMAP.md F23).

:func:`unported_reason` says, from a zoo name and the catalog alone, why
the port cannot load a model yet; ``TTS`` asks it before any download.
"""

from __future__ import annotations

import json
import os
import tarfile
import zipfile
from typing import Dict, List, Optional, Tuple

__all__ = ["ModelManager", "get_user_data_dir", "unported_reason"]

_DEFAULT_MODELS_FILE = os.path.join(os.path.dirname(os.path.dirname(__file__)), "zoo",
                                    "models.json")


def get_user_data_dir(appname: str = "tts_tpu") -> str:
    if os.environ.get("TTS_HOME"):
        return os.path.join(os.environ["TTS_HOME"], appname)
    base = os.environ.get("XDG_DATA_HOME", os.path.join(os.path.expanduser("~"), ".local", "share"))
    return os.path.join(base, appname)


# the catalog's vocoder families, every one the registry's generators run
_VOCODER_FAMILIES = ("multiband-melgan", "fullband-melgan", "hifigan", "parallel-wavegan",
                     "univnet", "wavegrad")
FAIRSEQ_REASON = ("the fairseq MMS models (tts_models/<lang>/fairseq/vits) cannot be loaded: "
                  "the JAX package cannot load them and the reference's loader is not in the "
                  "repository (ROADMAP.md item 16, F35)")


def _family_reason(model: str, model_item: Dict) -> Optional[str]:
    if model.startswith(("xtts", "tortoise", "bark")):
        return None
    if model in ("your_tts", "fast_pitch", "overflow", "neural_hmm"):
        return None
    if "vits" in model.lower() or "vits" in (model_item.get("description") or "").lower():
        return None
    if "GST" in model:
        return (f"{model} is Mandarin, and the Mandarin phonemizer imports a pinyin table "
                f"that neither package has (ROADMAP.md F36)")
    if "glow" in model or "tacotron2" in model or "capacitron" in model:
        return None
    if model.startswith("tacotron"):
        return (f"{model}: no converter reads a reference Tacotron v1 checkpoint, whose "
                f"network the port's is not (ROADMAP.md F41)")
    return f"{model} is not ported yet (ROADMAP.md item 16)"


def unported_reason(model_name: str, models_dict: Dict) -> Optional[str]:
    """Why the port cannot load the zoo model ``model_name`` of the catalog
    ``models_dict`` yet, naming its ROADMAP.md item, or ``None`` for what it
    runs: VITS (by its name or its description), YourTTS, XTTS v2 and v1.1,
    Tortoise (``tortoise-v2``) and Bark (``bark``), each from its multi-file
    directory, GlowTTS,
    Tacotron2 (Capacitron's too), FastPitch, Overflow and NeuralHMM whose
    ``default_vocoder`` it runs (or that has none: Griffin-Lim speaks it),
    every vocoder of the catalog (the MelGANs, HiFiGAN, ParallelWaveGAN,
    UnivNet, WaveGrad) and the voice converter FreeVC (``freevc24``). The Mandarin GST Tacotron2 names F36; Tacotron v1
    names F41 and SpeedySpeech item 16: neither package converts their
    reference checkpoints. A model whose family is not ported names its own
    item, whatever its vocoder."""
    model_type, lang, dataset, model = model_name.split("/")
    if model_type == "voice_conversion_models":
        if "freevc" in model:
            return None
        return f"the voice conversion model {model} is not ported yet (ROADMAP.md item 16)"
    if model_type == "vocoder_models":
        if any(family in model for family in _VOCODER_FAMILIES):
            return None
        return f"the vocoder {model} is not ported yet (ROADMAP.md item 16)"
    if dataset == "fairseq":  # the MMS models, named by language outside the catalog
        return FAIRSEQ_REASON
    model_item = models_dict[model_type][lang][dataset][model]
    reason = _family_reason(model, model_item)
    vocoder = model_item.get("default_vocoder")
    if reason is None and vocoder:
        vocoder_reason = unported_reason(vocoder, models_dict)
        if vocoder_reason:
            return f"{model_name} needs the vocoder {vocoder}: {vocoder_reason}"
    return reason


class ModelManager:
    """Name → files resolution for the model zoo (reference ``manage.py``)."""

    def __init__(self, models_file: Optional[str] = None, output_prefix: Optional[str] = None,
                 progress_bar: bool = False):
        self.progress_bar = progress_bar
        self.output_prefix = output_prefix or get_user_data_dir()
        self.models_file = models_file or os.environ.get("TTS_TPU_MODELS_FILE") or _DEFAULT_MODELS_FILE
        with open(self.models_file, "r", encoding="utf-8") as f:
            self.models_dict = json.load(f)

    # ------------------------------------------------------------------
    def _list(self) -> List[str]:
        names = []
        for model_type, langs in self.models_dict.items():
            for lang, datasets in langs.items():
                for dataset, models in datasets.items():
                    for model in models:
                        names.append(f"{model_type}/{lang}/{dataset}/{model}")
        return names

    def list_models(self) -> List[str]:
        return self._list()

    def list_tts_models(self) -> List[str]:
        return [n for n in self._list() if n.startswith("tts_models")]

    def list_vocoder_models(self) -> List[str]:
        return [n for n in self._list() if n.startswith("vocoder_models")]

    def list_vc_models(self) -> List[str]:
        return [n for n in self._list() if n.startswith("voice_conversion_models")]

    def list_langs(self) -> List[str]:
        return sorted({n.split("/")[1] for n in self._list()})

    def model_info_by_full_name(self, name: str) -> Dict:
        model_type, lang, dataset, model = name.split("/")
        return self.models_dict[model_type][lang][dataset][model]

    def model_info_by_name(self, model_query_name: str) -> None:
        """Print a zoo entry's details from its full name (reference
        ``manage.py model_info_by_full_name``)."""
        parts = model_query_name.split("/")
        if len(parts) != 4:
            print("> model_query_name should be in format <model_type>/<language>/<dataset>/<model_name>")
            return
        model_type, lang, dataset, model = parts
        try:
            item = self.models_dict[model_type][lang][dataset][model]
        except KeyError as e:
            print(f"> {e.args[0]} does not exist in the model list.")
            return
        self._print_model_item(model_type, lang, dataset, model, item)

    def model_info_by_idx(self, model_query: str) -> None:
        """Print a zoo entry's details from ``<model_type>/<idx>`` (1-based;
        reference ``manage.py model_info_by_idx``)."""
        try:
            model_type, idx_str = model_query.split("/")
            idx = int(idx_str)
        except ValueError:
            print("> model_query should be in format <model_type>/<model_query_idx> with an integer idx")
            return
        if idx <= 0:
            print("> model_query_idx should be a positive integer!")
            return
        names = [n for n in self._list() if n.startswith(model_type + "/")]
        if not names:
            print(f"> model_type {model_type} does not exist in the list.")
            return
        if idx > len(names):
            print(f"model query idx exceeds the number of available models [{len(names)}]")
            return
        model_type, lang, dataset, model = names[idx - 1].split("/")
        self._print_model_item(model_type, lang, dataset, model, self.models_dict[model_type][lang][dataset][model])

    @staticmethod
    def _print_model_item(model_type: str, lang: str, dataset: str, model: str, item: Dict) -> None:
        print(f"> model type : {model_type}")
        print(f"> language supported : {lang}")
        print(f"> dataset used : {dataset}")
        print(f"> model name : {model}")
        print(f"> description : {item.get('description') or 'coming soon'}")
        if item.get("default_vocoder"):
            print(f"> default_vocoder : {item['default_vocoder']}")

    # ------------------------------------------------------------------
    def _set_model_item(self, model_name: str) -> Tuple[Dict, str, str]:
        model_type, lang, dataset, model = model_name.split("/")
        model_item = dict(self.models_dict[model_type][lang][dataset][model])
        model_item["model_type"] = model_type
        model_full_name = f"{model_type}--{lang}--{dataset}--{model}"
        output_path = os.path.join(self.output_prefix, model_full_name)
        return model_item, model_full_name, output_path

    def download_model(self, model_name: str) -> Tuple[str, Optional[str], Dict]:
        """Resolve a zoo model, fetching its files when its directory does
        not exist yet (reference ``manage.py:371``). Returns ``(model_path,
        config_path, model_item)``; ``model_path`` is the directory itself
        for multi-file models (XTTS), with ``config_path`` ``None``."""
        if "fairseq" in model_name:
            raise NotImplementedError(FAIRSEQ_REASON)
        model_item, _, output_path = self._set_model_item(model_name)
        if not os.path.exists(output_path):
            os.makedirs(output_path, exist_ok=True)
            urls = model_item.get("github_rls_url") or model_item.get("hf_url") or model_item.get("model_url")
            if urls is None:
                raise ValueError(f" [!] No download URL for {model_name}")
            if isinstance(urls, str):
                urls = [urls]
            for url in urls:
                self._download_file(url, output_path)
        model_path, config_path = self._find_files(output_path)
        if config_path is not None:
            self._update_paths(output_path, config_path)
        return model_path, config_path, model_item

    _MODEL_FILE_NAMES = (
        "model_file.pth",
        "model_file.pth.tar",
        "model.pth",
        "checkpoint.pth",
        "best_model.pth",
        "G_100000.pth",  # fairseq MMS
    )
    # multi-file model dirs: XTTS (vocab/dvae), Tortoise (autoregressive),
    # Bark (text_2) — reference layouts from the zoo entries
    _DIR_MARKERS = ("vocab.json", "vocab.txt", "dvae.pth", "tokenizer.json",
                    "autoregressive.pth", "text_2.pt")

    @classmethod
    def _find_files(cls, output_path: str) -> Tuple[str, Optional[str]]:
        """``(model file or directory, config.json or None)`` of a model
        directory. The JAX package's converted ``.msgpack``/``.flax`` files
        are never taken."""
        files = sorted(os.listdir(output_path))
        config_file = os.path.join(output_path, "config.json") if "config.json" in files else None
        if any(m in files for m in cls._DIR_MARKERS):
            return output_path, None if "vocab.json" in files or "vocab.txt" in files else config_file
        model_file = None
        for f in files:
            if f in cls._MODEL_FILE_NAMES:
                model_file = os.path.join(output_path, f)
                break
        if model_file is None:
            # fall back to the largest checkpoint-looking file
            cands = [
                os.path.join(output_path, f)
                for f in files
                if f.endswith((".pth", ".pth.tar", ".pt", ".ckpt"))
                and not f.startswith(("speakers", "language", "dvae", "mel_stats"))
            ]
            cands = [f for f in cands if os.path.isfile(f)]
            if cands:
                model_file = max(cands, key=os.path.getsize)
        if model_file is None:
            raise ValueError(f" [!] Model file not found in {output_path}")
        return model_file, config_file

    @staticmethod
    def _update_paths(output_path: str, config_path: str) -> None:
        """Rewrite aux-file paths inside a downloaded config to the local
        download dir (reference ``manage.py:463 _update_paths``): the
        speaker, d-vector and language files, and ``audio.stats_path`` when
        the directory holds ``scale_stats.npy``, as the reference does. The
        JAX package's copy leaves ``stats_path`` at the trainer's path, where
        the ``AudioProcessor`` then fails to read it or reads other stats
        (ROADMAP.md F17). The speaker encoder's paths, where the config sets
        them, go to the directory's ``model_se.pth.tar`` (or
        ``model_se.pth``) and ``config_se.json`` when those are there
        (F23)."""
        with open(config_path, "r", encoding="utf-8") as f:
            cfg = json.load(f)

        def _set(d, key, fname):
            path = os.path.join(output_path, fname)
            if key in d and d[key] and os.path.isfile(path):
                d[key] = path

        encoder = next((f for f in ("model_se.pth.tar", "model_se.pth")
                        if os.path.isfile(os.path.join(output_path, f))), "model_se.pth.tar")
        changed = False
        for d in (cfg, cfg.get("model_args") or {}):
            before = dict(d)
            _set(d, "speaker_encoder_model_path", encoder)
            _set(d, "speaker_encoder_config_path", "config_se.json")
            _set(d, "speakers_file", "speakers.json")
            if not os.path.isfile(os.path.join(output_path, "speakers.json")):
                _set(d, "speakers_file", "speakers.pth")
            _set(d, "language_ids_file", "language_ids.json")
            _set(d, "d_vector_file", "speakers.json")
            if not os.path.isfile(os.path.join(output_path, "speakers.json")):
                _set(d, "d_vector_file", "speakers.pth")
            changed = changed or before != d
        stats = os.path.join(output_path, "scale_stats.npy")
        audio = cfg.get("audio")
        if isinstance(audio, dict) and os.path.isfile(stats) and audio.get("stats_path") != stats:
            audio["stats_path"] = stats
            changed = True
        if changed:
            with open(config_path, "w", encoding="utf-8") as f:
                json.dump(cfg, f, indent=2)

    def _download_file(self, url: str, output_path: str) -> None:
        """Fetch ``url`` into ``output_path`` and unpack an archive there
        (reference ``manage.py:528``)."""
        import urllib.request

        filename = url.split("/")[-1].split("?")[0]
        target = os.path.join(output_path, filename)
        print(f" > Downloading {url}")
        urllib.request.urlretrieve(url, target)
        if filename.endswith(".zip"):
            with zipfile.ZipFile(target) as z:
                z.extractall(output_path)
            os.remove(target)
            self._flatten(output_path)
        elif filename.endswith((".tar.gz", ".tgz", ".tar")):
            with tarfile.open(target) as t:
                t.extractall(output_path)
            os.remove(target)
            self._flatten(output_path)

    @staticmethod
    def _flatten(output_path: str) -> None:
        """Move files out of a single extracted subdirectory."""
        entries = [os.path.join(output_path, e) for e in os.listdir(output_path)]
        dirs = [e for e in entries if os.path.isdir(e)]
        if len(dirs) == 1 and len(entries) == 1:
            for f in os.listdir(dirs[0]):
                os.replace(os.path.join(dirs[0], f), os.path.join(output_path, f))
            os.rmdir(dirs[0])
