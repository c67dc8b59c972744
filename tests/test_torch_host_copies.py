"""The port's own copies of the JAX package's jax-free host modules.

``tts_tpu_torch`` imports nothing of ``tts_tpu``: it keeps copies of the
config classes (``config/base.py``, ``config/shared.py``,
``read_json_with_comments``, the VITS configs), the text front ends (the XTTS
tokenizer's normalisation; the VITS tokenizer with every cleaner pipeline of
``cleaners.py`` and ``english.py``; the phoneme front end: ``punctuation``,
``cmudict``, ``en_g2p``, ``latin_g2p`` with ``rule_g2p_ext`` and
``rule_g2p_ext3``, ``belarusian``, ``phonemizers``, ``IPAPhonemes`` and
``VitsCharacters``), the Tacotron2, ForwardTTS, speaker encoder, Overflow,
NeuralHMM, AlignTTS and DelightfulTTS configs, the vocoder configs, the
reference → flax-layout XTTS, VITS, GlowTTS, MelGAN, ParallelWaveGAN,
UnivNet, WaveGrad, WaveRNN, Tacotron2, speaker encoder, ForwardTTS and
Overflow converters (``utils/convert.py``), the pack planner
(``utils/packing.py``), the
trailing-silence endpoint (``db_to_amp``, ``find_endpoint``) and the
speaker and language managers (``utils/managers.py``, apart from their
``init_from_config``, which reads ``model_args`` too: ROADMAP.md F11, held
in ``tests/test_torch_multispeaker.py``), the zoo catalog
(``zoo/models.json``) and the zoo manager (``utils/manage.py``; its
listing, files and fetching are held in ``tests/test_torch_zoo.py``). Each
copy must
behave exactly as its source: the config dicts, the normalised text, the
token ids, the converted leaves, the plans and the endpoints are compared
for equality, no tolerance. The grapheme path is held here; the
phoneme front end in ``tests/test_torch_phonemes.py``.
"""

import torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import os

import numpy as np
import pytest
from helpers import tiny_xtts_config
from test_fidelity_corpus import _load as load_fidelity_fixture
from test_torch_convert import reference_state

from tts_tpu.config import read_json_with_comments as jax_read_json
from tts_tpu.models.xtts.config import XttsConfig as JaxXttsConfig
from tts_tpu.models.xtts.tokenizer import VoiceBpeTokenizer as JaxTokenizer
from tts_tpu.models.vits import VitsConfig as JaxVitsConfig
from tts_tpu.text import TTSTokenizer as JaxTTSTokenizer
from tts_tpu.utils.convert import convert_vits_generator as jax_convert_vits_generator
from tts_tpu.utils.convert import convert_xtts as jax_convert_xtts
from tts_tpu_torch.config import read_json_with_comments
from tts_tpu_torch.models.xtts.config import XttsConfig
from tts_tpu_torch.models.xtts.tokenizer import VoiceBpeTokenizer
from tts_tpu_torch.models.vits import VitsConfig
from tts_tpu_torch.text.tokenizer import TTSTokenizer
from tts_tpu_torch.utils.convert import convert_vits_generator, convert_xtts


def test_xtts_config_to_dict_matches_jax():
    assert XttsConfig().to_dict() == JaxXttsConfig().to_dict()
    tiny = tiny_xtts_config().to_dict()
    assert XttsConfig.from_dict(tiny).to_dict() == tiny


def test_json_with_comments_round_trips_through_both(tmp_path):
    config = JaxXttsConfig()
    config.top_k = 7
    config.model_args.gpt_layers = 3
    body = config.to_json()
    commented = (
        "// an XTTS config with comments\n"
        + body.replace('"top_k": 7,', '"top_k": 7, // greedy-ish\n', 1)
        .replace('"model": "xtts",', '/* the model name,\n   on two lines */ "model": "xtts",', 1)
    )
    assert commented.count("//") == 2 and "/*" in commented
    path = tmp_path / "config.json"
    path.write_text(commented, encoding="utf-8")
    got, want = read_json_with_comments(str(path)), jax_read_json(str(path))
    assert got == want
    assert got["top_k"] == 7 and got["model_args"]["gpt_layers"] == 3
    assert XttsConfig.from_dict(got).to_dict() == JaxXttsConfig.from_dict(want).to_dict()


# every language of the XTTS tokenizer, with numbers, ordinals, currency,
# abbreviations, times and mixed whitespace
TEXTS = [
    ("en", "Dr. Smith paid $12.50 on the 3rd of May 2021 at 10:30,\t with  2,500 friends & 50% more."),
    ("en", "Mr. and Mrs. Jones  owe £1,000.05 and ¥300 since 1999; the 21st item costs 0.75."),
    ("es", "El Sr. García pagó 1250,75 € el 2º día a las 10:30  con 21 amigos & 5% más."),
    ("fr", "M. Dupont a payé 99,99 € le 1er mai à 14h30,\tavec 80 amis @ 71 %."),
    ("de", "Herr Dr. Müller zahlte 1234,56 € am 3. Mai um 10:30 Uhr  mit 21 Freunden + 97."),
    ("it", "Il sig. Rossi ha pagato 13,50 € il 2° giorno alle 10:30 con 33 amici."),
    ("pt", "O Sr. Silva pagou R$ 25,90 no 1º dia às 10:30   com 71 amigos."),
    ("pl", "Pan Kowalski zapłacił 125 zł 3 maja o 10:30 z 22 przyjaciółmi."),
    ("tr", "İstanbul'da Dr. Öztürk 1500 TL ödedi, saat 10:30'da 3. kez Ümit ile."),
    ("ru", "Доктор Иванов заплатил 1234 рубля 3-го мая в 10:30  с 21 другом."),
    ("nl", "Dhr. de Vries betaalde € 45,50 op de 2e dag om 10:30 met 99 vrienden."),
    ("cs", "Pan Novák zaplatil 250 Kč 3. května v 10:30 s 42 přáteli."),
    ("ar", "دفع الدكتور أحمد ١٢٣ دولارا في الساعة 10:30 مع 5 أصدقاء."),
    ("hu", "Dr. Kovács 1500 Ft-ot fizetett május 3-án 10:30-kor  21 barátjával."),
    ("zh-cn", "我在2021年5月3日10:30花了12.5元，和 3 个朋友。"),
    ("ja", "東京で3人の友達と10時30分に1500円を払いました。"),
    ("ja", "こんにちは、すしを 2 つ ください。"),
    ("ko", "저는 3명의 친구와 10시 30분에 1500원을 냈어요."),
    ("hi", "मैंने 10:30 बजे ३ दोस्तों के साथ 1500 रुपये दिए।"),
]


@pytest.mark.parametrize("lang,text", TEXTS, ids=[f"{lang}{i}" for i, (lang, _) in enumerate(TEXTS)])
def test_tokenizer_normalisation_matches_jax(lang, text):
    want = JaxTokenizer().preprocess_text(text, lang)
    got = VoiceBpeTokenizer().preprocess_text(text, lang)
    assert got == want
    assert got.strip() and "  " not in got


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _leaves(tree[key], path + (key,))
    else:
        yield "/".join(path), tree


def test_convert_xtts_matches_jax_leaf_for_leaf():
    args = tiny_xtts_config().model_args
    state = {k: v for k, v in reference_state(args).items() if k != "mel_stats"}
    kw = dict(layers=args.gpt_layers, heads=args.gpt_n_heads)
    got = [dict(_leaves(tree)) for tree in convert_xtts(dict(state), **kw)]
    want = [dict(_leaves(tree)) for tree in jax_convert_xtts(dict(state), **kw)]
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for key in w:
            a, b = np.asarray(g[key]), np.asarray(w[key])
            assert a.dtype == b.dtype and a.shape == b.shape, key
            np.testing.assert_array_equal(a, b, err_msg=key)
    assert sum(len(g) for g in got) > 100


def test_vits_config_to_dict_matches_jax():
    assert VitsConfig().to_dict() == JaxVitsConfig().to_dict()
    recipe = JaxVitsConfig(text_cleaner="english_cleaners", use_phonemes=False)
    recipe.model_args.num_layers_flow = 3
    assert VitsConfig.from_dict(recipe.to_dict()).to_dict() == recipe.to_dict()


# English text through english_cleaners: numbers, ordinals, currency, times,
# abbreviations, symbols, brackets, quotes, case and characters outside the
# vocabulary (dropped)
VITS_TEXTS = [
    "Prior to November 22, 1963.",
    "It took me quite a long time to develop a voice, and now that I have it I'm not going to be silent.",
    "Dr. Smith and Mrs. Jones met at 10:30 pm with Lt. Col. Brown, Esq.",
    "He paid $12.50, then £3 & 45% more; the 21st item was 0.75 of a 1,000-pound lot.",
    "At 7:05 a.m. the St. Louis Co. train (No. 9) left — on time!",
    "\"Quoted\" [bracketed] <angled> text: semi; colon: hyphen-ated.",
    "Be a voice,   not an echo?!",
    "Café naïve façade — über résumé 東京 ☃",
    "I'm sorry Dave. I'm afraid I can't do that.",
    "The 1990s ended in 2000, and 1,234,567 people counted 3.14159 twice.",
]


@pytest.mark.parametrize("text", VITS_TEXTS, ids=[f"t{i}" for i in range(len(VITS_TEXTS))])
def test_vits_tokenizer_matches_jax(text):
    """The LJSpeech VITS recipe's front end, graphemes in place of phonemes."""
    fields = dict(text_cleaner="english_cleaners", use_phonemes=False, add_blank=True)
    want_tok, want_cfg = JaxTTSTokenizer.init_from_config(JaxVitsConfig(**fields))
    got_tok, got_cfg = TTSTokenizer.init_from_config(VitsConfig(**fields))
    want = want_tok.text_to_ids(text)
    assert got_tok.text_to_ids(text) == want
    assert len(want) > 20 and want[0] == want_tok.characters.blank_id
    got_chars, want_chars = got_cfg.characters.to_dict(), want_cfg.characters.to_dict()
    assert got_chars.pop("characters_class").endswith(".Graphemes")
    assert want_chars.pop("characters_class").endswith(".Graphemes")
    assert got_chars == want_chars


def test_convert_vits_generator_matches_jax_leaf_for_leaf():
    """The reference-layout VITS state dict of ``vits.npz`` (weight norm in
    the new parametrization API) through both converters."""
    state, _, _, meta = load_fidelity_fixture("vits")
    args = VitsConfig().model_args
    jax_args = JaxVitsConfig().model_args
    for k, v in meta["args"].items():
        setattr(args, k, v)
        setattr(jax_args, k, v)
    got = dict(_leaves(convert_vits_generator(dict(state), args)))
    want = dict(_leaves(jax_convert_vits_generator(dict(state), jax_args)))
    assert sorted(got) == sorted(want)
    for key in want:
        a, b = np.asarray(got[key]), np.asarray(want[key])
        assert a.dtype == b.dtype and a.shape == b.shape, key
        np.testing.assert_array_equal(a, b, err_msg=key)
    assert len(got) > 300


def test_db_to_amp_and_find_endpoint_match_jax():
    """Seeded waveforms with quiet stretches (near zero, and far below zero:
    the endpoint tests the window's maximum, not its magnitude) at two
    rates, two thresholds and both log bases."""
    from tts_tpu.audio import numpy_transforms as jax_nt
    from tts_tpu_torch.audio import numpy_transforms as nt

    rs = np.random.RandomState(0)
    for base in (10, np.e):
        for gain in (20.0, 10.0):
            x = rs.randn(7) * 40
            np.testing.assert_array_equal(nt.db_to_amp(x=x, gain=gain, base=base),
                                          jax_nt.db_to_amp(x=x, gain=gain, base=base))
    cut = 0
    for trial in range(24):
        sr = (22050, 16000)[trial % 2]
        wav = (0.3 * rs.randn(int(sr * rs.uniform(0.5, 4.0)))).astype(np.float32)
        if trial % 3:
            start = rs.randint(0, max(1, len(wav) - sr // 2))
            level = -0.5 if trial % 3 == 2 else 1e-4
            wav[start : start + int(sr * rs.uniform(0.5, 1.5))] = level * np.abs(rs.randn())
        kw = dict(wav=wav, trim_db=(45, 60)[trial % 4 // 2], sample_rate=sr, gain=20.0,
                  base=(10, np.e)[trial % 5 == 0])
        got = nt.find_endpoint(**kw)
        assert got == jax_nt.find_endpoint(**kw)
        cut += got < len(wav)
    assert cut >= 4  # some stretches are long enough to be found


def test_pack_planner_edge_cases_match_jax():
    """A fixed row length, one utterance, zero lengths (billed as one
    frame), other gaps and row multiples, and the refusal of an utterance
    longer than a row."""
    import tts_tpu.utils.packing as jax_packing
    from tts_tpu_torch.utils import packing

    cases = [([300, 120, 77, 260], dict(row_len=256)), ([5], {}), ([0, 3, 0], {}),
             ([100] * 9, dict(gap=16, row_pad_multiple=4)),
             ([4000, 4000, 10], dict(max_row_len=4096, len_multiple=128))]
    for lens, kw in cases:
        got, want = packing.plan_pack_layout(lens, **kw), jax_packing.plan_pack_layout(lens, **kw)
        np.testing.assert_array_equal(got.seg_sample, want.seg_sample)
        np.testing.assert_array_equal(got.seg_pos, want.seg_pos)
        assert (got.slices, got.row_len, got.n_rows, got.lengths, got.utilization) == (
            want.slices, want.row_len, want.n_rows, want.lengths, want.utilization)
    for module in (packing, jax_packing):
        with pytest.raises(ValueError, match="exceeds max_row_len=4096"):
            module.plan_pack_layout([10, 9000], max_row_len=4096)


def _speaker_files(tmp_path):
    """A speakers JSON, and d-vector files as JSON and as npz (three speakers,
    one to three clips each), written by the JAX package's ``save_file``."""
    from tts_tpu.utils.managers import save_file

    rs = np.random.RandomState(0)
    speakers = {"p225": 0, "p226": 1, "p227": 2}
    clips = {f"{name}_{n}.wav": {"name": name, "embedding": rs.randn(8).tolist()}
             for i, name in enumerate(speakers) for n in range(i + 1)}
    paths = {"ids": str(tmp_path / "speakers.json"), "json": str(tmp_path / "d_vectors.json"),
             "npz": str(tmp_path / "d_vectors.npz")}
    save_file(speakers, paths["ids"])
    save_file(clips, paths["json"])
    save_file(clips, paths["npz"])
    return paths


@pytest.mark.parametrize("kind", ["ids", "json", "npz", "both"])
def test_speaker_managers_match_jax(tmp_path, kind):
    """Speaker ids, and d-vectors from JSON and npz files (one file, or a
    list of both): names, ids, clips, dimension and mean embeddings (all
    clips and the first one) equal the JAX package's."""
    from tts_tpu.utils.managers import SpeakerManager as JaxSpeakerManager
    from tts_tpu_torch.utils.managers import SpeakerManager

    paths = _speaker_files(tmp_path)
    kw = ({"speaker_id_file_path": paths["ids"]} if kind == "ids" else
          {"d_vectors_file_path": [paths["json"], paths["npz"]] if kind == "both"
           else paths[kind]})
    got, want = SpeakerManager(**kw), JaxSpeakerManager(**kw)
    assert got.name_to_id == want.name_to_id and got.num_speakers == want.num_speakers == 3
    assert (got.speaker_names, got.embedding_dim, got.get_clips(), sorted(got.clip_ids)) == (
        want.speaker_names, want.embedding_dim, want.get_clips(), sorted(want.clip_ids))
    for name in got.embedding_names:
        for n in (None, 1):
            np.testing.assert_array_equal(got.get_mean_embedding(name, num_samples=n),
                                          want.get_mean_embedding(name, num_samples=n))


def test_language_managers_match_jax(tmp_path):
    """Language ids from a JSON file and from datasets (the multilingual
    recipe's way, codes from M-AILABS folder names), and the same error
    for a dataset without a language."""
    from tts_tpu.utils.managers import LanguageManager as JaxLanguageManager
    from tts_tpu.utils.managers import save_file
    from tts_tpu_torch.utils.managers import LanguageManager

    path = str(tmp_path / "language_ids.json")
    save_file({"de": 0, "en": 1, "es": 2, "fr": 3}, path)
    got, want = LanguageManager(language_ids_file_path=path), JaxLanguageManager(path)
    assert got.name_to_id == want.name_to_id and got.num_languages == want.num_languages == 4
    datasets = [{"language": f.split("_")[0]} for f in ("de_DE", "en_US", "en_UK", "pl_PL")]
    config = type("C", (), {"datasets": datasets})()
    got, want = LanguageManager(config=config), JaxLanguageManager(config=config)
    assert got.language_names == want.language_names == ["de", "en", "pl"]
    config.datasets = datasets + [{"language": ""}]
    for manager in (LanguageManager, JaxLanguageManager):
        with pytest.raises(ValueError, match="has no language"):
            manager(config=config)


def test_zoo_catalog_copy_equals_jax():
    """``tts_tpu_torch/zoo/models.json`` is the JAX package's catalog, byte
    for byte (88 entries)."""
    from tts_tpu.utils import manage as jax_manage
    from tts_tpu_torch.utils import manage

    with open(manage._DEFAULT_MODELS_FILE, "rb") as f:
        ours = f.read()
    with open(jax_manage._DEFAULT_MODELS_FILE, "rb") as f:
        assert ours == f.read()
    assert os.path.realpath(manage._DEFAULT_MODELS_FILE) != os.path.realpath(
        jax_manage._DEFAULT_MODELS_FILE)
    assert len(manage.ModelManager().list_models()) == 88


def test_manage_copies_match_jax(tmp_path):
    """The copied parts of ``utils/manage.py``: the checkpoint names and
    directory markers ``_find_files`` reads, ``_set_model_item`` for every
    entry, ``_flatten`` on one nested directory and on two, and the catalog
    queries, against the JAX package's."""
    from tts_tpu.utils import manage as jax_manage
    from tts_tpu_torch.utils import manage

    ours, theirs = manage.ModelManager(output_prefix=str(tmp_path)), jax_manage.ModelManager(
        output_prefix=str(tmp_path))
    assert ours._MODEL_FILE_NAMES == theirs._MODEL_FILE_NAMES
    assert ours._DIR_MARKERS == theirs._DIR_MARKERS
    for name in ours.list_models():
        assert ours._set_model_item(name) == theirs._set_model_item(name)
        assert ours.model_info_by_full_name(name) == theirs.model_info_by_full_name(name)
    for cls in (manage.ModelManager, jax_manage.ModelManager):
        for dirs in (["only"], ["one", "two"]):
            d = tmp_path / f"{cls.__module__}-{len(dirs)}"
            for sub in dirs:
                (d / sub).mkdir(parents=True)
                (d / sub / f"{sub}.pth").write_bytes(b"x")
            cls._flatten(str(d))
    for n in (1, 2):
        assert sorted(os.listdir(tmp_path / f"{manage.__name__}-{n}")) == sorted(
            os.listdir(tmp_path / f"{jax_manage.__name__}-{n}"))
    assert sorted(os.listdir(tmp_path / f"{manage.__name__}-1")) == ["only.pth"]


# ---------------------------------------------------------------------------
# The AudioProcessor and numpy transforms (``audio/processor.py``,
# ``audio/numpy_transforms.py``), the GlowTTS and MelGAN converters, the
# vocoder input interpolation and the GlowTTS config: equal to the JAX
# package's, no tolerance.
# ---------------------------------------------------------------------------

AUDIO_CASES = {
    "symmetric": dict(),
    "one_sided": dict(symmetric_norm=False, max_norm=1.0, ref_level_db=10, min_level_db=-90),
    "unclipped": dict(clip_norm=False, log_func="np.log"),
    "no_norm": dict(signal_norm=False, preemphasis=0.97),
    "mean_var": dict(stats=True),
}


def _processors(tmp_path, case):
    """The port's and the JAX package's ``AudioProcessor`` for one audio
    config (16 kHz, 256-point FFT, 20 mels), with ``scale_stats.npy``
    written for the mean-var case."""
    from tts_tpu.audio.processor import AudioProcessor as JaxAudioProcessor
    from tts_tpu.config.shared import BaseAudioConfig as JaxAudioConfig
    from tts_tpu_torch.audio.processor import AudioProcessor
    from tts_tpu_torch.config.shared import BaseAudioConfig

    kw = dict(AUDIO_CASES[case])
    audio = dict(sample_rate=16000, fft_size=256, win_length=256, hop_length=64, num_mels=20,
                 griffin_lim_iters=4)
    if kw.pop("stats", False):
        rs = np.random.RandomState(1)
        audio["stats_path"] = str(tmp_path / "scale_stats.npy")
        np.save(audio["stats_path"], {
            "mel_mean": rs.randn(20) - 30, "mel_std": rs.rand(20) + 5,
            "linear_mean": rs.randn(128), "linear_std": rs.rand(128) + 1,
            "audio_config": dict(audio)}, allow_pickle=True)
    audio.update(kw)
    assert BaseAudioConfig(**audio).to_dict() == JaxAudioConfig(**audio).to_dict()
    return (AudioProcessor.init_from_config(BaseAudioConfig(**audio), verbose=False),
            JaxAudioProcessor.init_from_config(JaxAudioConfig(**audio), verbose=False))


@pytest.mark.parametrize("case", list(AUDIO_CASES))
def test_audio_processor_matches_jax(case, tmp_path):
    """``normalize`` and ``denormalize`` both ways (mels and linear
    spectrograms, values past the clip range included), ``load_stats``,
    ``melspectrogram``, ``spectrogram``, ``inv_melspectrogram`` under one
    ``np.random.seed``, ``find_endpoint`` and ``trim_silence``."""
    ours, theirs = _processors(tmp_path, case)
    rs = np.random.RandomState(0)
    wav = (0.3 * rs.randn(4000)).astype(np.float32)
    wav[2500:] *= 1e-4
    for x in (rs.randn(20, 30) * 60 - 20, rs.randn(128, 30) * 60 - 20, rs.randn(20, 9) * 6):
        np.testing.assert_array_equal(ours.normalize(x), theirs.normalize(x))
        np.testing.assert_array_equal(ours.denormalize(x), theirs.denormalize(x))
    if ours.stats_path:
        for a, b in zip(ours.load_stats(ours.stats_path), theirs.load_stats(theirs.stats_path)):
            np.testing.assert_equal(a, b)
    mel = ours.melspectrogram(wav)
    np.testing.assert_array_equal(mel, theirs.melspectrogram(wav))
    if ours.stats_path:  # 129 linear bins against the stats' fft_size / 2, in both
        for ap in (ours, theirs):
            with pytest.raises(RuntimeError, match="does not match"):
                ap.spectrogram(wav)
    else:
        np.testing.assert_array_equal(ours.spectrogram(wav), theirs.spectrogram(wav))
    np.random.seed(3)
    got = ours.inv_melspectrogram(mel)
    np.random.seed(3)
    np.testing.assert_array_equal(got, theirs.inv_melspectrogram(mel))
    assert ours.find_endpoint(wav) == theirs.find_endpoint(wav)
    np.testing.assert_array_equal(ours.trim_silence(wav), theirs.trim_silence(wav))


@pytest.mark.parametrize("center", [True, False])
def test_stft_istft_mel_to_spec_and_griffin_lim_match_jax(center):
    from tts_tpu.audio import numpy_transforms as jax_nt
    from tts_tpu_torch.audio import numpy_transforms as nt

    rs = np.random.RandomState(2)
    y = rs.randn(3000)
    kw = dict(fft_size=256, hop_length=64, win_length=200, center=center)
    D = nt.stft(y=y, **kw)
    np.testing.assert_array_equal(D, jax_nt.stft(y=y, **kw))
    np.testing.assert_array_equal(nt.istft(y=D, hop_length=64, win_length=200, center=center),
                                  jax_nt.istft(y=D, hop_length=64, win_length=200,
                                               center=center))
    basis = nt.build_mel_basis(sample_rate=16000, fft_size=256, num_mels=20)
    mel = nt.spec_to_mel(spec=np.abs(D), mel_basis=basis)
    np.testing.assert_array_equal(mel, jax_nt.spec_to_mel(spec=np.abs(D), mel_basis=basis))
    np.testing.assert_array_equal(nt.mel_to_spec(mel=mel, mel_basis=basis),
                                  jax_nt.mel_to_spec(mel=mel, mel_basis=basis))
    np.testing.assert_array_equal(nt.amp_to_db(x=np.abs(D), gain=20, base=10),
                                  jax_nt.amp_to_db(x=np.abs(D), gain=20, base=10))
    np.testing.assert_array_equal(nt.deemphasis(x=nt.preemphasis(x=y)),
                                  jax_nt.deemphasis(x=jax_nt.preemphasis(x=y)))
    gl = dict(spec=np.abs(D[:, :20]), num_iter=3, fft_size=256, hop_length=64, win_length=200)
    np.random.seed(5)
    got = nt.griffin_lim(**gl)
    np.random.seed(5)
    np.testing.assert_array_equal(got, jax_nt.griffin_lim(**gl))


def test_convert_glow_tts_matches_jax_leaf_for_leaf():
    """The reference-layout GlowTTS state dict of ``glow_tts.npz`` (weight
    norm in the new parametrization API) through both converters."""
    from tts_tpu.models.glow_tts.config import GlowTTSConfig as JaxGlowTTSConfig
    from tts_tpu.utils.convert import convert_glow_tts as jax_convert_glow_tts
    from tts_tpu_torch.models.glow_tts import GlowTTSConfig
    from tts_tpu_torch.utils.convert import convert_glow_tts

    state, _, _, meta = load_fidelity_fixture("glow_tts")
    config, jax_config = GlowTTSConfig(), JaxGlowTTSConfig()
    for k, v in meta["config"].items():
        setattr(config, k, v)
        setattr(jax_config, k, v)
    assert config.to_dict() == jax_config.to_dict()
    got = dict(_leaves(convert_glow_tts(dict(state), config)))
    want = dict(_leaves(jax_convert_glow_tts(dict(state), jax_config)))
    assert sorted(got) == sorted(want) and len(got) > 80
    for key in want:
        np.testing.assert_array_equal(np.asarray(got[key]), np.asarray(want[key]), err_msg=key)


def test_convert_melgan_generator_matches_jax_leaf_for_leaf():
    from tts_tpu.utils.convert import convert_melgan_generator as jax_convert_melgan_generator
    from tts_tpu_torch.utils.convert import convert_melgan_generator

    state, _, _, meta = load_fidelity_fixture("multiband_melgan")
    kw = dict(num_upsample_stages=meta["num_upsample_stages"],
              num_res_blocks=meta["num_res_blocks"])
    got = dict(_leaves(convert_melgan_generator(dict(state), **kw)))
    want = dict(_leaves(jax_convert_melgan_generator(dict(state), **kw)))
    assert sorted(got) == sorted(want) and len(got) > 20
    for key in want:
        np.testing.assert_array_equal(np.asarray(got[key]), np.asarray(want[key]), err_msg=key)


@pytest.mark.parametrize("scale", [22050 / 16000, 16000 / 22050, 2.0])
def test_interpolate_vocoder_input_matches_jax(scale):
    from tts_tpu.vocoder.utils import interpolate_vocoder_input as jax_interpolate
    from tts_tpu_torch.vocoder.utils import interpolate_vocoder_input

    spec = np.random.RandomState(4).randn(20, 37).astype(np.float32)
    got = interpolate_vocoder_input([1, scale], spec)
    np.testing.assert_array_equal(got, jax_interpolate([1, scale], spec))
    assert got.shape == (20, int(np.floor(37 * scale)))


def test_tacotron2_config_to_dict_matches_jax():
    from tts_tpu.models.tacotron2 import Tacotron2Config as JaxTacotron2Config
    from tts_tpu.models.tacotron2 import TacotronConfig as JaxTacotronConfig
    from tts_tpu_torch.models.tacotron2 import Tacotron2Config, TacotronConfig

    assert TacotronConfig().to_dict() == JaxTacotronConfig().to_dict()
    assert Tacotron2Config().to_dict() == JaxTacotron2Config().to_dict()
    recipe = JaxTacotron2Config(r=6, gradual_training=[[0, 6, 64], [10000, 4, 32]],
                                double_decoder_consistency=True, text_cleaner="phoneme_cleaners",
                                use_phonemes=True, phoneme_language="en-us")
    assert Tacotron2Config.from_dict(recipe.to_dict()).to_dict() == recipe.to_dict()


def _reference_style_layers():
    """A GST (64 wide, 4 heads, 10 tokens) and a Capacitron (32 wide) in the
    reference's names and shapes, values from a numpy seed."""
    import torch

    from tts_tpu_torch.layers.capacitron import CapacitronVAE
    from tts_tpu_torch.layers.tacotron_v1 import GST
    from tts_tpu_torch.utils.convert import reference_tacotron2_state

    rs = np.random.RandomState(1)
    layers = torch.nn.ModuleDict({"gst_layer": GST(80, 4, 10, 64, "folded"),
                                  "capacitron_vae_layer": CapacitronVAE(80, 576, 32,
                                                                        norm_type="folded")})
    state = {k: torch.from_numpy(np.asarray(rs.randn(*v.shape), np.float32))
             for k, v in layers.state_dict().items()}
    return reference_tacotron2_state(state)


@pytest.mark.parametrize("attention", ["location", "dca", "style"])
def test_convert_tacotron2_matches_jax_leaf_for_leaf(attention):
    """The reference-layout state of ``tacotron2.npz`` (location attention),
    the same with its attention swapped for DCA's layers and no
    ``inputs_layer``, and the same with a reference-layout GST and
    Capacitron added (``convert_gst``, ``convert_capacitron``), through
    both converters."""
    from tts_tpu.utils.convert import convert_tacotron2 as jax_convert_tacotron2
    from tts_tpu_torch.utils.convert import convert_tacotron2

    state, _, _, _ = load_fidelity_fixture("tacotron2")
    if attention == "dca":
        rs = np.random.RandomState(0)
        state = {k: v for k, v in state.items() if not k.startswith("decoder.attention.")}
        for name, shape in (("query_layer.weight", (128, 1024)), ("query_layer.bias", (128,)),
                            ("key_layer.weight", (168, 128)),
                            ("static_filter_conv.weight", (8, 1, 21)),
                            ("static_filter_layer.weight", (128, 8)),
                            ("dynamic_filter_layer.weight", (128, 8)),
                            ("dynamic_filter_layer.bias", (128,)), ("v.weight", (1, 128))):
            state["decoder.attention." + name] = rs.randn(*shape).astype(np.float32)
    if attention == "style":
        state.update(_reference_style_layers())
    got = dict(_leaves(convert_tacotron2(dict(state))))
    want = dict(_leaves(jax_convert_tacotron2(dict(state))))
    assert sorted(got) == sorted(want) and len(got) > 60
    for key in want:
        np.testing.assert_array_equal(np.asarray(got[key]), np.asarray(want[key]), err_msg=key)


def test_forward_tts_and_encoder_configs_to_dict_match_jax():
    """The five ForwardTTS configs and the three encoder configs, at their
    defaults and round-tripped from a recipe's fields."""
    from tts_tpu.encoder import configs as jax_encoder_configs
    from tts_tpu.models.forward_tts import config as jax_forward_config
    from tts_tpu_torch.encoder import configs as encoder_configs
    from tts_tpu_torch.models.forward_tts import config as forward_config

    for module, jax_module, names in (
            (forward_config, jax_forward_config, ("ForwardTTSConfig", "FastPitchConfig",
                                                  "FastSpeechConfig", "Fastspeech2Config",
                                                  "SpeedySpeechConfig")),
            (encoder_configs, jax_encoder_configs, ("BaseEncoderConfig", "SpeakerEncoderConfig",
                                                    "EmotionEncoderConfig"))):
        for name in names:
            assert getattr(module, name)().to_dict() == getattr(jax_module, name)().to_dict(), name
    recipe = jax_forward_config.FastPitchConfig(use_speaker_embedding=True, use_phonemes=True,
                                                phoneme_language="en-us")
    recipe.model_args.num_speakers = 109
    assert forward_config.FastPitchConfig.from_dict(recipe.to_dict()).to_dict() == \
        recipe.to_dict()
    se = jax_encoder_configs.SpeakerEncoderConfig(model_params={
        "model_name": "resnet", "input_dim": 64, "use_torch_spec": True, "log_input": True,
        "proj_dim": 512})
    assert encoder_configs.SpeakerEncoderConfig.from_dict(se.to_dict()).to_dict() == se.to_dict()


@pytest.mark.parametrize("kind", ["resnet", "lstm"])
def test_convert_speaker_encoder_matches_jax_leaf_for_leaf(kind):
    """``speaker_encoder_resnet.npz``'s reference-layout SE-ResNet34, and a
    reference-layout LSTM encoder (3 layers of 768 projected to 256, the
    ``BaseEncoderConfig`` defaults' shapes, drawn from a seed), through both
    packages' ``convert_speaker_encoder``."""
    from tts_tpu.encoder.configs import SpeakerEncoderConfig as JaxSpeakerEncoderConfig
    from tts_tpu.utils.convert import convert_speaker_encoder as jax_convert_speaker_encoder
    from tts_tpu_torch.encoder.configs import SpeakerEncoderConfig
    from tts_tpu_torch.utils.convert import convert_speaker_encoder

    if kind == "resnet":
        state, _, _, _ = load_fidelity_fixture("speaker_encoder_resnet")
        model_params = {"model_name": "resnet", "input_dim": 64, "proj_dim": 512}
    else:
        rs = np.random.RandomState(0)
        state = {}
        for i in range(3):
            width = 80 if i == 0 else 256
            for leaf, shape in (("lstm.weight_ih_l0", (3072, width)),
                                ("lstm.weight_hh_l0", (3072, 768)), ("lstm.bias_ih_l0", (3072,)),
                                ("lstm.bias_hh_l0", (3072,)), ("linear.weight", (256, 768))):
                state[f"layers.{i}.{leaf}"] = rs.randn(*shape).astype(np.float32)
        model_params = {"model_name": "lstm", "num_lstm_layers": 3}
    got = dict(_leaves(convert_speaker_encoder(dict(state),
                                               SpeakerEncoderConfig(model_params=model_params))))
    want = dict(_leaves(jax_convert_speaker_encoder(
        dict(state), JaxSpeakerEncoderConfig(model_params=model_params))))
    assert sorted(got) == sorted(want) and len(got) > (30 if kind == "lstm" else 150)
    for key in want:
        np.testing.assert_array_equal(np.asarray(got[key]), np.asarray(want[key]), err_msg=key)


def test_convert_forward_tts_matches_jax_leaf_for_leaf():
    """``fastpitch.npz``'s reference-layout FastPitch (aligner included)
    through both packages' ``convert_forward_tts``."""
    from tts_tpu.models.forward_tts.config import ForwardTTSArgs as JaxForwardTTSArgs
    from tts_tpu.utils.convert import convert_forward_tts as jax_convert_forward_tts
    from tts_tpu_torch.models.forward_tts import ForwardTTSArgs
    from tts_tpu_torch.utils.convert import convert_forward_tts

    state, _, _, _ = load_fidelity_fixture("fastpitch")
    fft = {"hidden_channels_ffn": 64, "num_heads": 2, "num_layers": 2, "dropout_p": 0.0}
    got = dict(_leaves(convert_forward_tts(dict(state), ForwardTTSArgs(
        encoder_params=fft, decoder_params=fft))))
    want = dict(_leaves(jax_convert_forward_tts(dict(state), JaxForwardTTSArgs(
        encoder_params=fft, decoder_params=fft))))
    assert sorted(got) == sorted(want) and len(got) > 70
    for key in want:
        np.testing.assert_array_equal(np.asarray(got[key]), np.asarray(want[key]), err_msg=key)


def test_overflow_align_and_delightful_configs_to_dict_match_jax():
    """The Overflow, NeuralHMM, AlignTTS and DelightfulTTS configs, at their
    defaults and round-tripped from their LJSpeech recipes' fields."""
    from tts_tpu.models.align_tts import config as jax_align_config
    from tts_tpu.models.delightful_tts import config as jax_delightful_config
    from tts_tpu.models.overflow import config as jax_overflow_config
    from tts_tpu_torch.models.align_tts import config as align_config
    from tts_tpu_torch.models.delightful_tts import config as delightful_config
    from tts_tpu_torch.models.overflow import config as overflow_config

    for module, jax_module, names in (
            (overflow_config, jax_overflow_config, ("NeuralhmmTTSConfig", "OverflowConfig")),
            (align_config, jax_align_config, ("AlignTTSArgs", "AlignTTSConfig")),
            (delightful_config, jax_delightful_config,
             ("DelightfulTtsAudioConfig", "VocoderConfig", "DelightfulTtsArgs",
              "DelightfulTTSConfig"))):
        for name in names:
            assert getattr(module, name)().to_dict() == getattr(jax_module, name)().to_dict(), name
    recipes = (
        (overflow_config.OverflowConfig, jax_overflow_config.OverflowConfig(
            text_cleaner="phoneme_cleaners", use_phonemes=True, phoneme_language="en-us")),
        (overflow_config.NeuralhmmTTSConfig, jax_overflow_config.NeuralhmmTTSConfig(
            text_cleaner="phoneme_cleaners", use_phonemes=True, mel_statistics_mean=-5.5)),
        (align_config.AlignTTSConfig, jax_align_config.AlignTTSConfig(
            text_cleaner="english_cleaners", phase_start_steps=[0, 40000])),
        (delightful_config.DelightfulTTSConfig, jax_delightful_config.DelightfulTTSConfig(
            text_cleaner="english_cleaners", use_phonemes=True, phoneme_language="en-us")))
    for cls, recipe in recipes:
        assert cls.from_dict(recipe.to_dict()).to_dict() == recipe.to_dict()


@pytest.mark.parametrize("kind", ["overflow", "neuralhmm"])
def test_convert_overflow_matches_jax_leaf_for_leaf(kind):
    """A reference-layout Overflow (post-flow of two blocks) and NeuralHMM,
    each with an output net of two layers, drawn from a seed in the
    reference's names (``utils.convert.reference_overflow_state`` of a
    folded port model), through both packages' ``convert_overflow``."""
    from tts_tpu.models.overflow import NeuralhmmTTSConfig as JaxNeuralhmmTTSConfig
    from tts_tpu.models.overflow import OverflowConfig as JaxOverflowConfig
    from tts_tpu.utils.convert import convert_overflow as jax_convert_overflow
    from tts_tpu_torch.models.overflow import NeuralhmmTTS, NeuralhmmTTSConfig, Overflow, \
        OverflowConfig
    from tts_tpu_torch.utils.convert import convert_overflow, reference_overflow_state

    kw = dict(num_chars=30, out_channels=16, encoder_in_out_features=32, memory_rnn_dim=32,
              prenet_dim=16, outputnet_size=[32, 24], norm_type="folded")
    if kind == "overflow":
        kw.update(hidden_channels_dec=16, num_flow_blocks_dec=2, num_block_layers=2)
        cls, config, jax_config = Overflow, OverflowConfig(**kw), JaxOverflowConfig(**kw)
    else:
        cls, config, jax_config = NeuralhmmTTS, NeuralhmmTTSConfig(**kw), \
            JaxNeuralhmmTTSConfig(**kw)
    model = cls(config).init_params(seed=5, device="cpu")
    state = reference_overflow_state(model.module.state_dict(), mean=-4.0, std=2.5)
    got = dict(_leaves(convert_overflow(dict(state), config)))
    want = dict(_leaves(jax_convert_overflow(dict(state), jax_config)))
    assert sorted(got) == sorted(want) and len(got) > (60 if kind == "overflow" else 30)
    for key in want:
        np.testing.assert_array_equal(np.asarray(got[key]), np.asarray(want[key]), err_msg=key)


# ---------------------------------------------------------------------------
# The ParallelWaveGAN, UnivNet, WaveGrad and WaveRNN converters and configs
# (``utils/convert.py``, ``vocoder/configs.py``): equal to the JAX package's.
# ---------------------------------------------------------------------------

VOCODER_CONVERTERS = {
    "parallel_wavegan": ("convert_parallel_wavegan_generator",
                         lambda meta: dict(num_res_blocks=meta["num_res_blocks"],
                                           num_upsample_stages=meta["num_upsample_stages"])),
    "univnet": ("convert_univnet_generator",
                lambda meta: dict(num_blocks=meta["num_blocks"],
                                  kpnet_res_blocks=meta["kpnet_res_blocks"])),
    "wavegrad": ("convert_wavegrad", lambda meta: {}),
    "wavernn": ("convert_wavernn", lambda meta: dict(
        num_res_blocks=meta["num_res_blocks"], num_upsample_stages=meta["num_upsample_stages"])),
}


@pytest.mark.parametrize("family", list(VOCODER_CONVERTERS))
def test_convert_vocoders_match_jax_leaf_for_leaf(family):
    """The reference-layout state dict of ``<family>.npz`` through both
    packages' converters (``_shared_tap`` and ``_gru_cell`` included)."""
    from tts_tpu.utils import convert as jax_convert
    from tts_tpu_torch.utils import convert

    name, kwargs = VOCODER_CONVERTERS[family]
    state, _, _, meta = load_fidelity_fixture(family)
    got = dict(_leaves(getattr(convert, name)(dict(state), **kwargs(meta))))
    want = dict(_leaves(getattr(jax_convert, name)(dict(state), **kwargs(meta))))
    assert sorted(got) == sorted(want) and len(got) > 20
    for key in want:
        np.testing.assert_array_equal(np.asarray(got[key]), np.asarray(want[key]), err_msg=key)


def test_vocoder_configs_to_dict_match_jax():
    """``ParallelWaveganConfig``, ``UnivnetConfig``, ``GANConfig``,
    ``WavegradConfig`` and ``WavernnConfig``, at their defaults and
    round-tripped from changed fields."""
    from tts_tpu.vocoder import configs as jax_configs
    from tts_tpu_torch.vocoder import configs

    for name in ("ParallelWaveganConfig", "UnivnetConfig", "GANConfig", "WavegradConfig",
                 "WavernnConfig"):
        assert getattr(configs, name)().to_dict() == getattr(jax_configs, name)().to_dict(), name
    changed = (
        jax_configs.ParallelWaveganConfig(generator_model_params={"stacks": 2}, seq_len=1024),
        jax_configs.UnivnetConfig(generator_model_params={"upsample_factors": [8, 8, 4]}),
        jax_configs.WavegradConfig(test_noise_schedule={"min_val": 1e-6, "max_val": 0.5,
                                                        "num_steps": 6}),
        jax_configs.WavernnConfig(mode=10, mulaw=False))
    for recipe in changed:
        cls = getattr(configs, type(recipe).__name__)
        assert cls.from_dict(recipe.to_dict()).to_dict() == recipe.to_dict()


# ---------------------------------------------------------------------------
# The FreeVC config and the WavLM and FreeVC converters (``vc/configs.py``,
# ``utils/convert.py``): equal to the JAX package's.
# ---------------------------------------------------------------------------


def test_freevc_configs_to_dict_match_jax():
    """``FreeVCAudioConfig``, ``FreeVCArgs`` and ``FreeVCConfig`` at their
    defaults, round-tripped from changed fields, and read by the port's
    registry (``models.config_from_dict``) from a ``config.json`` dict."""
    from tts_tpu.vc import configs as jax_configs
    from tts_tpu_torch.models import config_from_dict
    from tts_tpu_torch.vc import configs

    for name in ("FreeVCAudioConfig", "FreeVCArgs", "FreeVCConfig"):
        assert getattr(configs, name)().to_dict() == getattr(jax_configs, name)().to_dict(), name
    changed = jax_configs.FreeVCConfig()
    changed.model_args.upsample_rates = [10, 6, 2, 2]
    changed.audio.output_sample_rate = 16000
    got = config_from_dict(changed.to_dict())
    assert isinstance(got, configs.FreeVCConfig) and got.to_dict() == changed.to_dict()


@pytest.mark.parametrize("kind", ["freevc", "wavlm"])
def test_convert_freevc_and_wavlm_match_jax_leaf_for_leaf(kind):
    """A reference-layout FreeVC (written by ``reference_freevc_state`` from
    random port weights at small widths) and a WavLM-Large-style WavLM
    (``reference_wavlm_state``: its positional conv under weight norm over
    ``dim=2``) through both packages' ``convert_freevc`` and
    ``convert_wavlm_state``."""
    import torch

    from tts_tpu.utils import convert as jax_convert
    from tts_tpu.vc.modules.wavlm import WavLMConfig as JaxWavLMConfig
    from tts_tpu_torch.utils import convert
    from tts_tpu_torch.vc.configs import FreeVCConfig
    from tts_tpu_torch.vc.models.freevc import FreeVC
    from tts_tpu_torch.vc.modules.wavlm import WavLM, WavLMConfig

    torch.manual_seed(0)
    if kind == "freevc":
        config = FreeVCConfig()
        for k, v in dict(ssl_dim=12, inter_channels=8, hidden_channels=16, gin_channels=16,
                         spec_channels=21, resblock_kernel_sizes=[3],
                         resblock_dilation_sizes=[[1, 3, 5]], upsample_rates=[4, 4],
                         upsample_kernel_sizes=[8, 8], upsample_initial_channel=32).items():
            setattr(config.model_args, k, v)
        model = FreeVC(config).init_params(seed=1, device="cpu")
        state = convert.reference_freevc_state(model.module.state_dict())
        got = dict(_leaves(convert.convert_freevc(dict(state))))
        want = dict(_leaves(jax_convert.convert_freevc(dict(state))))
    else:
        kw = dict(encoder_layers=2, encoder_embed_dim=32, encoder_ffn_embed_dim=64,
                  encoder_attention_heads=4, conv_feature_layers=((24, 10, 5), (24, 3, 2)),
                  conv_pos=16, conv_pos_groups=4, extractor_mode="layer_norm",
                  layer_norm_first=True, relative_position_embedding=True, num_buckets=16,
                  max_distance=64, gru_rel_pos=True)
        model = WavLM(WavLMConfig(**kw))
        state = convert.reference_wavlm_state(model.state_dict())
        got = dict(_leaves(convert.convert_wavlm_state(dict(state), WavLMConfig(**kw))))
        want = dict(_leaves(jax_convert.convert_wavlm_state(dict(state), JaxWavLMConfig(**kw))))
    assert sorted(got) == sorted(want) and len(got) > 40
    for key in want:
        np.testing.assert_array_equal(np.asarray(got[key]), np.asarray(want[key]), err_msg=key)
