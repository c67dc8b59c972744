"""The port's model zoo (``tts_tpu_torch.utils.manage``, ``TTS(model_name=...)``,
``tts --model_name`` and the listing flags) against the JAX package's
``ModelManager``, on the CPU and offline.

Every test points ``TTS_HOME`` at a temporary directory and, where it loads
a model, ``TTS_TPU_MODELS_FILE`` at a temporary catalog; the model's zoo
directory is written there beforehand, so nothing is fetched. The fetching
code runs on local archives through ``file://`` URLs, which
``urllib.request.urlretrieve`` takes.

The loaded model is a tiny VCTK-style VITS (hidden 32, 2 layers, 4
speakers from a torch ``speakers.pth``, the zoo's format) whose weights sit
in the reference layout as ``model_file.pth``, and a tiny XTTS v2
directory. Audio loaded by name must equal the audio of the same files
loaded by path, sample for sample.

Divergence from the JAX package, named in its test: ``_find_files`` takes
the reference ``.pth`` where the JAX one takes its own converted
``.msgpack`` from the same shared directory.
"""

import torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import contextlib
import io
import json
import os
import shutil
import tarfile
import urllib.request
import zipfile

import jax
import numpy as np
import pytest
import scipy.io.wavfile
import torch
from helpers import fast_init_model, tiny_xtts_config
from test_torch_multispeaker import reference_layout
from test_torch_vits_model import tiny_vits_args

from tts_tpu.utils import manage as jax_manage
from tts_tpu_torch.api import TTS
from tts_tpu_torch.bin.synthesize import main as port_cli
from tts_tpu_torch.models.vits import Vits, VitsConfig
from tts_tpu_torch.utils import manage
from tts_tpu_torch.utils.convert import reference_vits_state, xtts_from_jax_params
from tts_tpu_torch.utils.managers import SpeakerManager

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VCTK = "tts_models/en/vctk/vits"
XTTS = "tts_models/multilingual/multi-dataset/xtts_v2"
SPEAKERS = ["p225", "p226", "p227", "p228"]
TEXT = "Be a voice, not an echo."
RECIPE = dict(text_cleaner="english_cleaners", use_phonemes=False, add_blank=True)
STALE = "/home/someone/vctk/speakers.pth"  # where the published config points


def zoo_dir(home, name):
    return home / "tts_tpu" / name.replace("/", "--")


@pytest.fixture(scope="module")
def zoo_home(tmp_path_factory):
    """A ``TTS_HOME`` holding the VCTK VITS and XTTS v2 zoo directories,
    and a catalog of the two entries plus the real catalog's others."""
    home = tmp_path_factory.mktemp("tts_home")
    d = zoo_dir(home, VCTK)
    d.mkdir(parents=True)
    torch.save({n: i for i, n in enumerate(SPEAKERS)}, d / "speakers.pth")
    config = VitsConfig(**RECIPE)
    for k, v in tiny_vits_args(num_chars=None).items():
        setattr(config.model_args, k, v)
    config.model_args.use_speaker_embedding = True
    config.model_args.speakers_file = str(d / "speakers.pth")
    model = Vits.init_from_config(config).init_params(seed=0, device="cpu")
    saved = model.config.to_dict()
    saved["model_args"]["speakers_file"] = STALE
    with open(d / "config.json", "w") as f:
        json.dump(saved, f)
    reference = reference_vits_state(model.module.state_dict())
    torch.save({"model": {k: torch.from_numpy(v) for k, v in reference.items()}},
               d / "model_file.pth")

    from tts_tpu.models.xtts import Xtts as JaxXtts
    from tts_tpu_torch.models.xtts.config import XttsConfig
    from tts_tpu_torch.models.xtts.model import Xtts
    from tts_tpu_torch.models.xtts.tokenizer import write_char_vocab

    x = zoo_dir(home, XTTS)
    x.mkdir(parents=True)
    xconfig = tiny_xtts_config()
    gpt, dec = fast_init_model(JaxXtts(xconfig), jax.random.PRNGKey(0),
                               attrs=("gpt_params", "decoder_params"), scale=0.04)
    with open(x / "config.json", "w") as f:
        json.dump(xconfig.to_dict(), f, default=str)
    write_char_vocab(str(x / "vocab.json"), "abcdefghijklmnopqrstuvwxyz.,!?'")
    port = Xtts(XttsConfig.from_dict(xconfig.to_dict()))
    port.load_state_dict_with_stats(xtts_from_jax_params(gpt, dec))
    torch.save(port.state_dict_with_stats(), x / "model_torch.pt")

    with open(manage._DEFAULT_MODELS_FILE) as f:
        catalog = json.load(f)
    models_file = home / "models.json"
    with open(models_file, "w") as f:
        json.dump(catalog, f)
    return home, models_file, model.module.state_dict()


@pytest.fixture
def offline_zoo(zoo_home, monkeypatch):
    """``TTS_HOME`` and ``TTS_TPU_MODELS_FILE`` set; any fetch fails."""
    home, models_file, _ = zoo_home
    monkeypatch.setenv("TTS_HOME", str(home))
    monkeypatch.setenv("TTS_TPU_MODELS_FILE", str(models_file))

    def no_fetch(url, *args, **kwargs):
        raise AssertionError(f"fetched {url}")

    monkeypatch.setattr(urllib.request, "urlretrieve", no_fetch)
    return home


def printed(fn, *args):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        fn(*args)
    return out.getvalue()


# ---------------------------------------------------------------------------
# the catalog, listing and info, against the JAX ModelManager
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("catalog", ["bundled", "override"])
def test_listing_matches_jax(catalog, tmp_path, monkeypatch):
    """The same names, in the same order, from the bundled catalog and from
    a ``TTS_TPU_MODELS_FILE`` of two entries."""
    if catalog == "override":
        models = {"tts_models": {"en": {"vctk": {"vits": {"description": "d"}}}},
                  "vocoder_models": {"xx": {"set": {"voc": {}}}}}
        (tmp_path / "m.json").write_text(json.dumps(models))
        monkeypatch.setenv("TTS_TPU_MODELS_FILE", str(tmp_path / "m.json"))
    ours, theirs = manage.ModelManager(), jax_manage.ModelManager()
    for method in ("list_models", "list_tts_models", "list_vocoder_models", "list_vc_models",
                   "list_langs"):
        assert getattr(ours, method)() == getattr(theirs, method)(), method
    n = len(ours.list_models())
    assert n == (88 if catalog == "bundled" else 2)


@pytest.mark.parametrize("query", [
    "tts_models/1", "tts_models/16", "vocoder_models/3", "voice_conversion_models/1",
    "tts_models/0", "tts_models/999", "tts_models/x", "bad_models/1", "tts_models",
])
def test_model_info_by_idx_matches_jax(query):
    ours = printed(manage.ModelManager().model_info_by_idx, query)
    assert ours == printed(jax_manage.ModelManager().model_info_by_idx, query)
    assert ours


@pytest.mark.parametrize("query", [
    VCTK, XTTS, "tts_models/en/ljspeech/glow-tts", "tts_models/en/vctk/nope",
    "tts_models/en/vctk",
])
def test_model_info_by_name_matches_jax(query):
    ours = printed(manage.ModelManager().model_info_by_name, query)
    assert ours == printed(jax_manage.ModelManager().model_info_by_name, query)
    assert ours


def test_cli_listing_flags_print_what_the_jax_manager_prints(capsys):
    port_cli(["--list_models"])
    assert capsys.readouterr().out.split() == jax_manage.ModelManager().list_models()
    port_cli(["--model_info_by_idx", "tts_models/3", "--model_info_by_name", VCTK])
    want = printed(jax_manage.ModelManager().model_info_by_idx, "tts_models/3") + printed(
        jax_manage.ModelManager().model_info_by_name, VCTK)
    assert capsys.readouterr().out == want


def test_server_lists_models(capsys):
    from tts_tpu_torch.server.server import main as server_main

    server_main(["--list_models"])
    assert capsys.readouterr().out.split() == manage.ModelManager().list_models()


def test_catalog_copy_is_the_port_own_file():
    """The port reads its own copy, never the JAX package's file."""
    ours = os.path.realpath(manage.ModelManager().models_file)
    assert ours == os.path.join(REPO, "tts_tpu_torch", "zoo", "models.json")
    assert ours != os.path.realpath(jax_manage._DEFAULT_MODELS_FILE)


@pytest.mark.parametrize("env", [{"TTS_HOME": "/h"}, {"XDG_DATA_HOME": "/x"}, {}])
def test_data_directory_matches_jax(env, monkeypatch):
    for key in ("TTS_HOME", "XDG_DATA_HOME"):
        monkeypatch.delenv(key, raising=False)
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    assert manage.get_user_data_dir() == jax_manage.get_user_data_dir()
    assert manage.ModelManager().output_prefix == jax_manage.ModelManager().output_prefix
    assert manage.ModelManager()._set_model_item(VCTK) == \
        jax_manage.ModelManager()._set_model_item(VCTK)


# ---------------------------------------------------------------------------
# files of a model directory
# ---------------------------------------------------------------------------


LAYOUTS = {
    "vits": ["config.json", "model_file.pth", "speakers.pth"],
    "best_model": ["config.json", "best_model.pth", "checkpoint_1000.pth"],
    "largest": ["config.json", "a.pth", "big.pt", "speakers.pth", "language_ids.json"],
    "xtts": ["config.json", "model.pth", "vocab.json", "speakers_xtts.pth"],
    "tortoise": ["autoregressive.pth", "config.json"],
    "bark": ["coarse_2.pt", "config.json", "fine_2.pt", "text_2.pt", "hubert.pt"],
    "empty": ["config.json", "notes.txt"],
}


def _touch(d, names, sizes=None):
    d.mkdir(parents=True, exist_ok=True)
    for name in names:
        (d / name).write_bytes(b"x" * (sizes or {}).get(name, 10))


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_find_files_matches_jax(layout, tmp_path):
    _touch(tmp_path, LAYOUTS[layout], {"big.pt": 100})
    if layout == "empty":
        for cls in (manage.ModelManager, jax_manage.ModelManager):
            with pytest.raises(ValueError, match="Model file not found"):
                cls._find_files(str(tmp_path))
        return
    ours = manage.ModelManager._find_files(str(tmp_path))
    assert ours == jax_manage.ModelManager._find_files(str(tmp_path))
    assert ours[0] != str(tmp_path / "speakers.pth")


@pytest.mark.parametrize("jax_file", ["model_file_flax.msgpack", "model_file.flax"])
def test_find_files_takes_the_reference_checkpoint_not_the_jax_conversion(jax_file, tmp_path):
    """Divergence: the JAX package converts a zoo ``.pth`` into its own
    ``.msgpack`` beside it and takes that; the port loads the reference
    checkpoint, in the same directory."""
    _touch(tmp_path, ["config.json", "model_file.pth", jax_file])
    theirs = jax_manage.ModelManager._find_files(str(tmp_path))
    ours = manage.ModelManager._find_files(str(tmp_path))
    if jax_file.endswith(".msgpack"):
        assert theirs[0] == str(tmp_path / jax_file)
    assert ours == (str(tmp_path / "model_file.pth"), str(tmp_path / "config.json"))
    (tmp_path / "model_file.pth").unlink()  # nothing but the conversion: no model
    _touch(tmp_path, ["big.msgpack"], {"big.msgpack": 100})
    with pytest.raises(ValueError, match="Model file not found"):
        manage.ModelManager._find_files(str(tmp_path))


@pytest.mark.parametrize("files", [
    ["speakers.json", "language_ids.json"], ["speakers.pth"], [],
], ids=["json", "pth", "none"])
def test_update_paths_matches_jax(files, tmp_path):
    """Speaker, d-vector and language files of a published config point to
    the directory's own files, on the top level and in ``model_args``."""
    config = {"speakers_file": STALE, "d_vector_file": None, "model_args": {
        "speakers_file": STALE, "d_vector_file": "/x/speakers.pth",
        "language_ids_file": "/x/language_ids.json"}, "other": "/x/keep"}
    texts = {}
    for cls in (manage.ModelManager, jax_manage.ModelManager):
        d = tmp_path / cls.__module__
        _touch(d, files + ["config.json"])
        (d / "config.json").write_text(json.dumps(config))
        cls._update_paths(str(d), str(d / "config.json"))
        texts[cls] = (d / "config.json").read_text().replace(str(d), "<dir>")
    ours = texts[manage.ModelManager]
    assert ours == texts[jax_manage.ModelManager]
    if files:
        assert STALE not in ours and json.loads(ours)["other"] == "/x/keep"


def _archive(tmp_path, kind, nested):
    src = tmp_path / "src"
    root = src / "tts_models--xx--set--vits" if nested else src
    _touch(root, ["config.json", "model_file.pth"])
    (root / "config.json").write_text("{}")
    path = tmp_path / ("model.zip" if kind == "zip" else "model.tar.gz")
    if kind == "zip":
        with zipfile.ZipFile(path, "w") as z:
            for f in root.rglob("*"):
                z.write(f, f.relative_to(src))
    else:
        with tarfile.open(path, "w:gz") as t:
            for f in root.iterdir():
                t.add(f, f.relative_to(src))
    return path


@pytest.mark.parametrize("nested", [True, False], ids=["nested", "flat"])
@pytest.mark.parametrize("kind", ["zip", "tar.gz"])
def test_file_url_download_extracts_and_flattens(kind, nested, tmp_path):
    """A local archive fetched through a ``file://`` URL is unpacked, its one
    top directory flattened and the archive removed, as the JAX manager
    does; ``download_model`` then finds the files."""
    archive = _archive(tmp_path, kind, nested)
    url = archive.as_uri()
    listings = []
    for cls in (manage.ModelManager, jax_manage.ModelManager):
        out = tmp_path / f"out_{cls.__module__}"
        out.mkdir()
        printed(cls(output_prefix=str(tmp_path))._download_file, url, str(out))
        listings.append(sorted(os.listdir(out)))
    assert listings[0] == listings[1] == ["config.json", "model_file.pth"]

    catalog = {"tts_models": {"xx": {"set": {"vits": {"github_rls_url": url}}}}}
    (tmp_path / "m.json").write_text(json.dumps(catalog))
    manager = manage.ModelManager(models_file=str(tmp_path / "m.json"),
                                  output_prefix=str(tmp_path / "home"))
    model_path, config_path, item = manager.download_model("tts_models/xx/set/vits")
    d = tmp_path / "home" / "tts_models--xx--set--vits"
    assert (model_path, config_path) == (str(d / "model_file.pth"), str(d / "config.json"))
    assert item["model_type"] == "tts_models"


# ---------------------------------------------------------------------------
# loading by name
# ---------------------------------------------------------------------------


def test_reference_layout_writer_matches_the_test_helper(zoo_home):
    """``convert.reference_vits_state`` (which the zoo fixture and the card
    run use) writes what ``test_torch_multispeaker.reference_layout`` writes."""
    state = zoo_home[2]
    ours, theirs = reference_vits_state(state), reference_layout(state)
    assert sorted(ours) == sorted(theirs)
    for key in ours:
        np.testing.assert_array_equal(ours[key], theirs[key], err_msg=key)


def test_vits_by_name_speaks_like_the_same_files_by_path(offline_zoo, zoo_home):
    """``TTS(model_name=...)`` loads the reference-layout checkpoint, the
    speakers from ``speakers.pth`` (the config's stale path rewritten), and
    speaks as the same files loaded by path, sample for sample."""
    tts = TTS(model_name=VCTK, device="cpu")
    d = zoo_dir(offline_zoo, VCTK)
    assert json.loads((d / "config.json").read_text())["model_args"]["speakers_file"] == \
        str(d / "speakers.pth")
    assert tts.speakers == SPEAKERS and tts.synthesizer.from_file
    state = tts.synthesizer.tts_model.module.state_dict()
    for key, value in zoo_home[2].items():
        np.testing.assert_array_equal(state[key].numpy(), value.numpy(), err_msg=key)
    by_path = TTS(model_path=str(d / "model_file.pth"), config_path=str(d / "config.json"),
                  device="cpu")
    got = np.asarray(tts.tts(TEXT, speaker="p226"), np.float32)
    want = np.asarray(by_path.tts(TEXT, speaker="p226"), np.float32)
    np.testing.assert_array_equal(got, want)
    assert np.abs(got).max() > 0


def test_cli_by_name_writes_the_path_loaded_audio(offline_zoo, tmp_path):
    d = zoo_dir(offline_zoo, VCTK)
    by_name, by_path = tmp_path / "name.wav", tmp_path / "path.wav"
    port_cli(["--text", TEXT, "--model_name", VCTK, "--speaker_idx", "p227",
              "--out_path", str(by_name), "--device", "cpu"])
    TTS(model_path=str(d / "model_file.pth"), config_path=str(d / "config.json"),
        device="cpu").tts_to_file(TEXT, speaker="p227", file_path=str(by_path))
    (sr, a), (_, b) = (scipy.io.wavfile.read(p) for p in (by_name, by_path))
    assert sr == 22050 and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def test_xtts_v2_by_name_loads_its_directory(offline_zoo):
    tts = TTS(model_name=XTTS, device="cpu")
    x = zoo_dir(offline_zoo, XTTS)
    assert tts.synthesizer.tts_config.model == "xtts"
    by_path = TTS(model_path=str(x), device="cpu")
    ours = tts.synthesizer.tts_model.state_dict_with_stats()
    for key, value in by_path.synthesizer.tts_model.state_dict_with_stats().items():
        np.testing.assert_array_equal(ours[key].numpy(), value.numpy(), err_msg=key)


def write_tiny_bark(d):
    """A small random Bark (2 layers 32 wide, the 24 kHz EnCodec) as the
    reference's bark directory."""
    from tts_tpu_torch.models.bark.config import BarkConfig, BarkGPTArgs
    from tts_tpu_torch.models.bark.model import Bark
    from tts_tpu_torch.utils.convert import reference_bark_gpt_state, reference_encodec_state

    gpt = dict(block_size=640, n_layer=2, n_head=2, n_embd=32)
    config = BarkConfig(
        SEMANTIC_VOCAB_SIZE=100, SEMANTIC_PAD_TOKEN=100, TEXT_ENCODING_OFFSET=104,
        TEXT_PAD_TOKEN=380, SEMANTIC_INFER_TOKEN=383, CODEBOOK_SIZE=16,
        COARSE_SEMANTIC_PAD_TOKEN=132, COARSE_INFER_TOKEN=134,
        semantic_config=BarkGPTArgs(input_vocab_size=384, output_vocab_size=104, **gpt),
        coarse_config=BarkGPTArgs(input_vocab_size=144, output_vocab_size=144, **gpt),
        fine_config=BarkGPTArgs(input_vocab_size=20, output_vocab_size=20, **gpt))
    model = Bark(config).init_params(seed=0, device="cpu")
    d.mkdir(parents=True)
    for name, fname in (("semantic_model", "text_2.pt"), ("coarse_model", "coarse_2.pt"),
                        ("fine_model", "fine_2.pt")):
        state = reference_bark_gpt_state(getattr(model, name).state_dict())
        torch.save({"model": {k: torch.from_numpy(v) for k, v in state.items()}}, d / fname)
    torch.save({k: torch.from_numpy(v) for k, v in
                reference_encodec_state(model.encodec.state_dict()).items()},
               d / "encodec_24khz.pth")
    with open(d / "config.json", "w") as f:
        json.dump(config.to_dict(), f)


def test_bark_by_name_loads_its_directory(offline_zoo, tmp_path, monkeypatch):
    """``TTS(model_name=".../bark")`` loads the multi-file directory
    (``text_2.pt`` marks it) with nothing fetched, and speaks at 24 kHz as
    the same files loaded by path."""
    home = tmp_path / "home"
    write_tiny_bark(zoo_dir(home, BARK))
    monkeypatch.setenv("TTS_HOME", str(home))
    manager = manage.ModelManager()
    assert manage.unported_reason(BARK, manager.models_dict) is None
    model_path, config_path, _ = manager.download_model(BARK)
    assert model_path.endswith("bark") and config_path.endswith("config.json")
    by_name = TTS(model_name=BARK, device="cpu")
    by_path = TTS(model_path=model_path, device="cpu")
    assert by_name.synthesizer.output_sample_rate == 24000
    a, b = (np.asarray(t.tts(TEXT, max_gen_duration_s=0.2)) for t in (by_name, by_path))
    assert a.shape == b.shape and np.isfinite(a).all()
    np.testing.assert_array_equal(a, b)


def test_speakers_pth_reads_natively(tmp_path):
    """The zoo's ``speakers.pth`` (ids, or d-vectors as tensors) loads with
    ``torch.load(weights_only=True)``."""
    torch.save({"a": 0, "b": 1}, tmp_path / "ids.pth")
    assert SpeakerManager(speaker_id_file_path=str(tmp_path / "ids.pth")).name_to_id == \
        {"a": 0, "b": 1}
    torch.save({"clip1": {"name": "a", "embedding": torch.ones(4)},
                "clip2": {"name": "a", "embedding": torch.zeros(4)}}, tmp_path / "dv.pth")
    sm = SpeakerManager(d_vectors_file_path=str(tmp_path / "dv.pth"))
    assert sm.speaker_names == ["a"] and sm.embedding_dim == 4
    np.testing.assert_allclose(sm.get_mean_embedding("a"), np.full(4, 0.5))


def _unported():
    manager = manage.ModelManager()
    names = [n for n in manager.list_models() if manage.unported_reason(n, manager.models_dict)]
    return names + ["tts_models/de/fairseq/vits"]


GLOW_TTS = ["tts_models/en/ljspeech/glow-tts", "tts_models/uk/mai/glow-tts",
            "tts_models/tr/common-voice/glow-tts", "tts_models/be/common-voice/glow-tts",
            "tts_models/it/mai_female/glow-tts", "tts_models/it/mai_male/glow-tts",
            "tts_models/fa/custom/glow-tts"]


YOURTTS = "tts_models/multilingual/multi-dataset/your_tts"
FAST_PITCH = ["tts_models/en/ljspeech/fast_pitch", "tts_models/en/vctk/fast_pitch"]
TACOTRON2 = ["tts_models/en/ljspeech/tacotron2-DDC", "tts_models/en/ljspeech/tacotron2-DCA",
             "tts_models/es/mai/tacotron2-DDC", "tts_models/fr/mai/tacotron2-DDC",
             "tts_models/de/thorsten/tacotron2-DCA", "tts_models/de/thorsten/tacotron2-DDC",
             "tts_models/ja/kokoro/tacotron2-DDC", "tts_models/en/ek1/tacotron2",
             "tts_models/en/ljspeech/tacotron2-DDC_ph", "tts_models/nl/mai/tacotron2-DDC"]
HMM = ["tts_models/en/ljspeech/overflow", "tts_models/en/ljspeech/neural_hmm"]
XTTS_V1 = "tts_models/multilingual/multi-dataset/xtts_v1.1"
TORTOISE = "tts_models/en/multi-dataset/tortoise-v2"
BARK = "tts_models/multilingual/multi-dataset/bark"
CAPACITRON = ["tts_models/en/blizzard2013/capacitron-t2-c50",
              "tts_models/en/blizzard2013/capacitron-t2-c150_v2"]


def test_every_family_is_sorted_into_ported_or_an_item():
    """38 entries named VITS, the VITS ``jenny`` (by its description),
    YourTTS, XTTS v2 and v1.1, Tortoise, Bark, the 7 GlowTTS entries (with a Multiband-MelGAN or
    HiFiGAN default vocoder, or none), the 10 Tacotron2 entries (their
    default vocoders a HiFiGAN, a MelGAN, ``ek1``'s WaveGrad, ``DDC_ph``'s
    UnivNet, ``nl/mai``'s ParallelWaveGAN), the 2 Capacitron Tacotron2
    entries (with the blizzard2013 HiFiGAN v2), the 2 FastPitch entries
    (LJSpeech with HiFiGAN v2, VCTK with none), Overflow and NeuralHMM (both
    with HiFiGAN v2), all 17 vocoders (Multiband-MelGAN, Fullband-MelGAN,
    HiFiGAN, ParallelWaveGAN, UnivNet, WaveGrad) and the voice converter
    ``freevc24`` load; each of the catalog's other 5, and the fairseq MMS
    models, names a
    ROADMAP.md item or fault: the Mandarin GST Tacotron2 F36 (its
    phonemizer), Tacotron v1 F41 (no converter reads its checkpoint) and
    SpeedySpeech item 16."""
    manager = manage.ModelManager()
    ported = [n for n in manager.list_models()
              if not manage.unported_reason(n, manager.models_dict)]
    assert len([n for n in ported if "vits" in n]) == 38
    assert sorted(n for n in ported if "vits" not in n and n.startswith("tts_models/")) == \
        sorted(["tts_models/en/jenny/jenny", XTTS, XTTS_V1, TORTOISE, BARK, YOURTTS] + GLOW_TTS
               + TACOTRON2 + CAPACITRON + FAST_PITCH + HMM)
    vocoders = [n for n in ported if n.startswith("vocoder_models/")]
    assert len(vocoders) == 17 and all(
        any(f in n for f in ("multiband-melgan", "fullband-melgan", "hifigan",
                             "parallel-wavegan", "univnet", "wavegrad")) for n in vocoders)
    assert "voice_conversion_models/multilingual/vctk/freevc24" in ported
    assert len(_unported()) == 88 - 85 + 1
    tacotrons = sorted(n for n in _unported() if "tacotron" in n)
    assert [manage.unported_reason(n, manager.models_dict).split("(")[-1] for n in tacotrons] \
        == ["ROADMAP.md F41)", "ROADMAP.md F36)"]
    assert "item 16" in manage.unported_reason("tts_models/en/ljspeech/speedy-speech",
                                               manager.models_dict)


@pytest.mark.parametrize("name", _unported())
def test_unported_families_raise_before_any_download(name, offline_zoo):
    """Each family the port does not run raises ``NotImplementedError``
    naming its ROADMAP.md item, or the fault that keeps it out (F36 for the
    Mandarin GST Tacotron2, F41 for Tacotron v1), before any file is fetched
    or any directory made."""
    before = sorted(p.name for p in (offline_zoo / "tts_tpu").iterdir())
    with pytest.raises(NotImplementedError, match=r"ROADMAP\.md (items? 1[2-6]|F36|F41)"):
        TTS(model_name=name, device="cpu")
    assert sorted(p.name for p in (offline_zoo / "tts_tpu").iterdir()) == before


def test_vocoder_name_raises(offline_zoo):
    """A ``--vocoder_name`` that is no ``vocoder_models/`` entry (a TTS
    model's name) raises ``ValueError`` before anything is fetched: every
    vocoder of the catalog runs, so none raises for its family."""
    before = sorted(p.name for p in (offline_zoo / "tts_tpu").iterdir())
    with pytest.raises(ValueError, match="is not a vocoder_models/ entry"):
        port_cli(["--text", TEXT, "--model_name", VCTK, "--speaker_idx", "p225",
                  "--vocoder_name", "tts_models/en/ljspeech/tacotron2-DDC_ph", "--device",
                  "cpu"])
    assert sorted(p.name for p in (offline_zoo / "tts_tpu").iterdir()) == before


def test_missing_directory_is_fetched(offline_zoo, zoo_home, monkeypatch):
    """A ported model whose directory is absent is fetched from its URL (a
    ``file://`` zip of the VCTK directory here)."""
    home = offline_zoo
    d = zoo_dir(home, VCTK)
    archive = shutil.make_archive(str(home / "vctk"), "zip", root_dir=d)
    models_file = home / "fetch.json"
    models_file.write_text(json.dumps({"tts_models": {"xx": {"vctk": {"vits": {
        "github_rls_url": "file://" + archive, "default_vocoder": None}}}}}))
    monkeypatch.setenv("TTS_TPU_MODELS_FILE", str(models_file))
    monkeypatch.setattr(urllib.request, "urlretrieve", _real_urlretrieve)
    tts = TTS(model_name="tts_models/xx/vctk/vits", device="cpu")
    assert tts.speakers == SPEAKERS
    assert (home / "tts_tpu" / "tts_models--xx--vctk--vits" / "model_file.pth").is_file()


_real_urlretrieve = urllib.request.urlretrieve
