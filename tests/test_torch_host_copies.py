"""The port's own copies of the JAX package's jax-free host modules.

``tts_tpu_torch`` imports nothing of ``tts_tpu``: it keeps copies of the
config classes (``config/base.py``, ``config/shared.py``,
``read_json_with_comments``, the VITS configs), the text front ends (the XTTS
tokenizer's normalisation; the VITS tokenizer with every cleaner pipeline of
``cleaners.py`` and ``english.py``; the phoneme front end: ``punctuation``,
``cmudict``, ``en_g2p``, ``latin_g2p`` with ``rule_g2p_ext`` and
``rule_g2p_ext3``, ``belarusian``, ``phonemizers``, ``IPAPhonemes`` and
``VitsCharacters``), the reference → flax-layout XTTS and VITS converters
(``utils/convert.py``), the pack planner (``utils/packing.py``) and the
trailing-silence endpoint (``db_to_amp``, ``find_endpoint``). Each copy must
behave exactly as its source: the config dicts, the normalised text, the
token ids, the converted leaves, the plans and the endpoints are compared
for equality, no tolerance. The grapheme path is held here; the
phoneme front end in ``tests/test_torch_phonemes.py``.
"""

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
