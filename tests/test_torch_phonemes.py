"""The port's phoneme front end against the JAX package's, on the CPU.

``tts_tpu_torch.text`` keeps its own copies of ``punctuation``, ``cmudict``,
``en_g2p``, ``latin_g2p`` (with ``rule_g2p_ext`` and ``rule_g2p_ext3``),
``belarusian``, ``phonemizers``, the cleaner pipelines, ``IPAPhonemes`` /
``VitsCharacters`` and the tokenizer's phoneme branch. Each must behave
exactly as its source: phonemes, cleaned text, vocabularies, token ids and
the config written back are compared for equality, no tolerance, on inputs
from fixed lists.

Neither ``espeak`` nor ``gruut`` is known on the machines the port runs on,
so a request for ``espeak`` falls back to the built-in rule G2P with one
warning, in both packages alike; the tests hold whatever backend this
machine offers to be the same in both. Which backends a machine offers is
read in a fresh interpreter: other test files install stub modules
(``tests/ref_stubs.py``, a ``gruut`` whose ``sentences`` is None) that the
backend probes take for installed libraries, so in a shared test process
the registries could name a backend the machine lacks. While these tests
run, both packages' registries hold what the fresh interpreter read
(:func:`machine_registries`).

One divergence is named here (ROADMAP.md F7): the JAX package sizes the
VITS token embedding from the vocabulary only when ``num_chars`` is unset,
so the LJSpeech recipe as published (``VitsArgs.num_chars`` 100, 131 IPA
symbols) embeds its punctuation and late phonemes past the table, which
flax reads as NaN. The port raises on such a config instead.
"""

import contextlib
import json
import os
import subprocess
import sys
import warnings

import pytest

from tts_tpu.config.shared import BaseDatasetConfig as JaxDatasetConfig
from tts_tpu.config.shared import CharactersConfig as JaxCharactersConfig
from tts_tpu.models.vits import Vits as JaxVits
from tts_tpu.models.vits import VitsConfig as JaxVitsConfig
from tts_tpu.text import characters as jax_characters
from tts_tpu.text import cleaners as jax_cleaners
from tts_tpu.text import phonemizers as jax_phonemizers
from tts_tpu.text.latin_g2p import get_latin_g2p as jax_get_latin_g2p
from tts_tpu.text.punctuation import Punctuation as JaxPunctuation
from tts_tpu.text.tokenizer import TTSTokenizer as JaxTTSTokenizer
from tts_tpu_torch.config.shared import BaseDatasetConfig, CharactersConfig
from tts_tpu_torch.models.vits import Vits, VitsConfig
from tts_tpu_torch.text import characters, cleaners, phonemizers
from tts_tpu_torch.text.latin_g2p import get_latin_g2p
from tts_tpu_torch.text.punctuation import Punctuation
from tts_tpu_torch.text.tokenizer import TTSTokenizer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_READ_REGISTRIES = (
    "import json\n"
    "from tts_tpu.text import phonemizers as jax_module\n"
    "from tts_tpu_torch.text import phonemizers as port_module\n"
    "print(json.dumps({key: [sorted(m.PHONEMIZERS), m.DEF_LANG_TO_PHONEMIZER]\n"
    "                  for key, m in (('jax', jax_module), ('port', port_module))}))\n"
)


@contextlib.contextmanager
def machine_registries():
    """Both packages' ``PHONEMIZERS`` and ``DEF_LANG_TO_PHONEMIZER`` set in
    place to what a fresh interpreter builds on this machine, restored on
    exit. Yields ``{"jax": [names, defaults], "port": [names, defaults]}``."""
    proc = subprocess.run([sys.executable, "-c", _READ_REGISTRIES], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    fresh = json.loads(proc.stdout.splitlines()[-1])
    saved = []
    for key, module in (("jax", jax_phonemizers), ("port", phonemizers)):
        names, defaults = fresh[key]
        backends = {c.name(): c for c in vars(module).values() if isinstance(c, type)
                    and issubclass(c, module.BasePhonemizer) and c is not module.BasePhonemizer}
        saved.append((module, dict(module.PHONEMIZERS), dict(module.DEF_LANG_TO_PHONEMIZER)))
        module.PHONEMIZERS.clear()
        module.PHONEMIZERS.update({name: backends[name] for name in names})
        module.DEF_LANG_TO_PHONEMIZER.clear()
        module.DEF_LANG_TO_PHONEMIZER.update(defaults)
    try:
        yield fresh
    finally:
        for module, registry, defaults in saved:
            module.PHONEMIZERS.clear()
            module.PHONEMIZERS.update(registry)
            module.DEF_LANG_TO_PHONEMIZER.clear()
            module.DEF_LANG_TO_PHONEMIZER.update(defaults)


@pytest.fixture(scope="module", autouse=True)
def registries():
    with machine_registries() as fresh:
        yield fresh


# one sentence per language, with punctuation, numbers, accents and stress
LANG_TEXTS = {
    "en-us": "Dr. Smith read 3 books; then, quietly, he thought: \"Photography isn't chemistry!\"",
    "en-gb": "The colour of the aluminium boat — schedule it for Tuesday, 21 June?",
    "es": "¿Cuántos años tenía el pingüino? ¡Cinco, y corría rápido por la ciudad!",
    "it": "Perché l'università è chiusa? Gli gnocchi, però, costano 12 euro.",
    "de": "Über die Brücke gingen 3 Mädchen; sie sprachen Deutsch, nicht Englisch.",
    "fr": "Où est la bibliothèque? Les garçons mangent 2 croissants, évidemment.",
    "pt": "Não sei se a estação está aberta; os pães custam 4 reais, então.",
    "tr": "Çocuklar 5 gün boyunca İstanbul'da ağaçları izlediler, değil mi?",
    "pl": "Zażółć gęślą jaźń: w Szczebrzeszynie chrząszcz brzmi w trzcinie 7 razy.",
    "cs": "Příliš žluťoučký kůň úpěl ďábelské ódy, řekl 8 lidem.",
    "hu": "Árvíztűrő tükörfúrógép; a gyerekek 9 almát ettek, szép!",
    "fi": "Hyvää huomenta! Järvellä uivat 2 joutsenta, äänettömästi.",
    "nl": "De schaapjes liepen gisteren 6 keer over de dijk, nietwaar?",
    "ro": "Știința și țara își găsesc 3 căi, într-adevăr!",
    "ca": "L'home va dir: «Què passa?» i la nena, en 1 minut, va marxar.",
    "sk": "Ďateľ ťukal do stromu; ľudia počuli 4 údery, však?",
    "hr": "Čašu ćemo piti u džepu 2 puta, đakone!",
    "sl": "Žaba skače čez 3 široke potoke; šele potem poje.",
    "lt": "Ąžuolas ir ėglė auga čia, už 5 kilometrų; šaunu!",
    "lv": "Ķēniņš ēda ļoti garšīgu ābolu, 6 reizes; ņem!",
    "et": "Jõgi voolab läbi öö; 7 õuna ja üks ämber, tõesti!",
    "bg": "Здравейте, приятели! Днес е 8 юни; щастлив ден.",
    "uk": "Привіт, друзі! Сьогодні 9 травня; їжак і ґанок.",
    "el": "Καλημέρα, φίλοι! Σήμερα είναι 3 Μαΐου; ευχαριστώ.",
    "da": "Rødgrød med fløde, sagde 2 mænd; hvorfor ikke?",
    "sv": "Sju sjösjuka sjömän sköttes av 7 sköterskor, eller hur?",
    "ga": "Dia dhuit! Tá 4 bhád sa chuan, agus tá sé fuar.",
    "mt": "Il-ħobż huwa għażiż; xtrajt 3 ħbub, hux?",
    "fa": "سلام دوستان! امروز ۵ کتاب خواندم؛ خیلی خوب بود.",
}


def _registry_name(lang):
    """The backend a config without ``phonemizer`` gets for ``lang``."""
    assert jax_phonemizers.DEF_LANG_TO_PHONEMIZER[lang] == phonemizers.DEF_LANG_TO_PHONEMIZER[lang]
    return phonemizers.DEF_LANG_TO_PHONEMIZER[lang]


def test_every_rule_g2p_language_is_in_the_corpus():
    codes = {"es", "it", "de", "fr", "pt", "tr", "pl", "cs", "hu", "fi", "nl", "ro", "ca",
             "sk", "hr", "sl", "lt", "lv", "et", "bg", "uk", "el", "da", "sv", "ga", "mt", "fa"}
    assert all(get_latin_g2p(c) is not None and jax_get_latin_g2p(c) is not None for c in codes)
    assert get_latin_g2p("xx") is None and jax_get_latin_g2p("xx") is None
    assert codes | {"en-us", "en-gb"} == set(LANG_TEXTS)


def test_registries_match_jax(registries):
    """Read in a fresh interpreter: the machine's backends, not stubs."""
    assert registries["port"] == registries["jax"]
    names, defaults = registries["port"]
    for name in names:
        got, want = phonemizers.PHONEMIZERS[name], jax_phonemizers.PHONEMIZERS[name]
        assert got.__name__ == want.__name__ and got.version() == want.version()
    # English and the rule-G2P languages always have a backend
    assert {"en_g2p", "latin_g2p", "ja_jp_phonemizer"} <= set(names)
    assert all(lang in defaults for lang in LANG_TEXTS)


@pytest.mark.parametrize("lang", sorted(LANG_TEXTS))
def test_phonemize_matches_jax(lang):
    """By registry name and through the ``espeak`` request (its fallback
    where the binary is missing), with and without a separator."""
    text = LANG_TEXTS[lang]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        pairs = [
            (phonemizers.get_phonemizer_by_name(_registry_name(lang), language=lang),
             jax_phonemizers.get_phonemizer_by_name(_registry_name(lang), language=lang)),
            (phonemizers.get_phonemizer_by_name("espeak", language=lang),
             jax_phonemizers.get_phonemizer_by_name("espeak", language=lang)),
        ]
    for got, want in pairs:
        assert got.name() == want.name() and got.language == want.language
        for sep in ("", "|"):
            phones = want.phonemize(text, separator=sep)
            assert got.phonemize(text, separator=sep) == phones
            assert phones and phones != text
    # punctuation is restored where the backend keeps it
    if pairs[0][1]._keep_puncs:
        assert any(p in phones for p in ",;:!?.")


def test_espeak_fallback_warns_once_naming_the_port():
    if phonemizers.ESpeak.is_available():
        pytest.skip("espeak is installed: no fallback to hold against the JAX package")
    for module in (phonemizers, jax_phonemizers):
        module._WARNED_FALLBACK.clear()
    with pytest.warns(UserWarning, match=r"tts_tpu_torch\.text\.en_g2p") as record:
        got = phonemizers.get_phonemizer_by_name("espeak", language="en-us")
    with pytest.warns(UserWarning, match=r"tts_tpu\.text\.en_g2p") as jax_record:
        want = jax_phonemizers.get_phonemizer_by_name("espeak", language="en-us")
    assert str(record[0].message).replace("tts_tpu_torch.", "tts_tpu.") == str(jax_record[0].message)
    assert got.name() == want.name() == "en_g2p"
    with pytest.warns(UserWarning, match=r"tts_tpu_torch\.text\.latin_g2p"):
        assert phonemizers.get_phonemizer_by_name("espeak", language="de").name() == "latin_g2p"
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # once per backend: no second warning
        phonemizers.get_phonemizer_by_name("espeak", language="en-gb")
        phonemizers.get_phonemizer_by_name("espeak", language="it")
    with pytest.raises(RuntimeError, match="not installed"):
        phonemizers.get_phonemizer_by_name("espeak", language="xx")
    with pytest.raises(ValueError, match="not found"):
        phonemizers.get_phonemizer_by_name("nonesuch", language="en-us")


PUNC_TEXTS = [
    "Hello, world!",
    "¿Qué? ¡No! Sí...",
    "…and then — silence.",
    "no punctuation here",
    "!!!",
    "“Quoted,” she said; «fine».",
    "  spaced :  out ;  text  ",
    "a,b,c",
]


@pytest.mark.parametrize("text", PUNC_TEXTS, ids=[f"p{i}" for i in range(len(PUNC_TEXTS))])
def test_punctuation_strip_and_restore_match_jax(text):
    got_p, want_p = Punctuation(), JaxPunctuation()
    assert got_p.puncs == want_p.puncs and Punctuation.default_puncs() == want_p.default_puncs()
    assert got_p.strip(text) == want_p.strip(text)
    got_chunks, got_marks = got_p.strip_to_restore(text)
    want_chunks, want_marks = want_p.strip_to_restore(text)
    assert got_chunks == want_chunks
    assert [(m.punc, m.position.name) for m in got_marks] == \
        [(m.punc, m.position.name) for m in want_marks]
    upper = [c.upper() for c in got_chunks]
    assert Punctuation.restore(upper, got_marks) == JaxPunctuation.restore(upper, want_marks)


CLEANERS = ["english_cleaners", "phoneme_cleaners", "basic_cleaners", "transliteration_cleaners",
            "basic_german_cleaners", "basic_turkish_cleaners", "french_cleaners",
            "portuguese_cleaners", "chinese_mandarin_cleaners", "multilingual_cleaners",
            "no_cleaners"]
CLEANER_TEXTS = [
    "Dr. Smith paid $12.50 at 10:30 pm; Mrs. Jones & Co. owe 1,000 more.",
    "M. Dupont et Mme Martin, av. J.-C., etc. — rdv à 14h & après!",
    "Istanbul'da IŞIK ve İnci; Größe der Straße: 3 Äpfel.",
    "O Sr. Silva & a D. Maria: 25 pães (quentes) [frescos] \"já\".",
    "我在2021年花了12.5元。\nNext line\t with\ttabs  and   spaces.",
    "Hyphen-ated words; colons: and <angled> brackets — 21st of May.",
]


@pytest.mark.parametrize("name", CLEANERS)
def test_cleaner_pipelines_match_jax(name):
    for text in CLEANER_TEXTS:
        assert getattr(cleaners, name)(text) == getattr(jax_cleaners, name)(text), text
    for lang in ("en", "fr", "pt", "ca", None):
        for text in CLEANER_TEXTS:
            assert cleaners.replace_symbols(text, lang) == jax_cleaners.replace_symbols(text, lang)
    for lang in ("en", "fr"):
        for text in CLEANER_TEXTS:
            assert (cleaners.expand_abbreviations(text, lang)
                    == jax_cleaners.expand_abbreviations(text, lang))


def _vocab_pairs():
    zoo = dict(characters="ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz",
               phonemes="iyɨʉɯuɪʏʊeøɘəɵɤoɛœɜɞʌɔæɐaɶɑɒᴀɕʑɺɧʲɚ˞ɫ", punctuations="!'(),-.:;? ",
               pad="<PAD>", eos="<EOS>", bos="<BOS>", blank="<BLNK>")
    return [
        ("IPAPhonemes", characters.IPAPhonemes(), jax_characters.IPAPhonemes()),
        ("VitsCharacters", characters.VitsCharacters(), jax_characters.VitsCharacters()),
        ("VitsCharacters zoo layout",
         characters.VitsCharacters.init_from_config(VitsConfig(
             characters=CharactersConfig(**zoo)))[0],
         jax_characters.VitsCharacters.init_from_config(JaxVitsConfig(
             characters=JaxCharactersConfig(**zoo)))[0]),
    ]


@pytest.mark.parametrize("index", range(3), ids=["ipa", "vits", "vits_zoo"])
def test_phoneme_vocabularies_match_jax(index):
    what, got, want = _vocab_pairs()[index]
    assert characters.parse_symbols() == jax_characters.parse_symbols()
    assert got.vocab == want.vocab, what
    assert got.num_chars == want.num_chars
    for attr in ("pad_id", "blank_id", "bos_id", "eos_id"):
        assert getattr(got, attr) == getattr(want, attr), (what, attr)
    assert got.to_config().to_dict() == want.to_config().to_dict()
    if index == 0:
        assert got.num_chars == 131
    if index == 1:
        # checkpoint embedding rows depend on [pad] + punctuations + characters + [blank]
        assert got.num_chars == 181
        assert got.vocab[0] == "<PAD>" and got.vocab[1:12] == list("!'(),-.:;? ")
        assert got.vocab[-1] == "<BLNK>"


SENTENCES = [
    "It took me quite a long time to develop a voice, and now that I have it I'm not going "
    "to be silent.",
    "Dr. Smith paid $12.50 at 10:30; the 21st item was 0.75 of a 1,000-pound lot!",
    "\"Quoted\" [bracketed] text: hyphen-ated, naïve café?",
]


def _configs(pkg):
    """The three text front ends, built from the package ``pkg``'s classes."""
    Config, Chars, Dataset = pkg
    zoo_chars = Chars(characters_class="TTS.tts.models.vits.VitsCharacters",
                      **{k: v for k, v in jax_characters.VitsCharacters().to_config().to_dict().items()
                         if k not in ("characters_class",)})
    return {
        "recipe": Config(text_cleaner="english_cleaners", use_phonemes=True,
                         phoneme_language="en-us"),
        "zoo": Config(text_cleaner="phoneme_cleaners", use_phonemes=True,
                      phoneme_language="en-us", phonemizer="espeak", characters=zoo_chars),
        "multi": Config(text_cleaner="multilingual_cleaners", use_phonemes=True,
                        phonemizer="multi_phonemizer",
                        datasets=[Dataset(language="en-us", phonemizer=""),
                                  Dataset(language="es", phonemizer="latin_g2p")]),
    }


PORT = (VitsConfig, CharactersConfig, BaseDatasetConfig)
JAX = (JaxVitsConfig, JaxCharactersConfig, JaxDatasetConfig)


@pytest.mark.parametrize("kind", ["recipe", "zoo", "multi"])
def test_tokenizer_from_config_matches_jax(kind):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got_tok, got_cfg = TTSTokenizer.init_from_config(_configs(PORT)[kind])
        want_tok, want_cfg = JaxTTSTokenizer.init_from_config(_configs(JAX)[kind])
    languages = ["en-us", "es"] if kind == "multi" else [None]
    for lang in languages:
        for text in SENTENCES:
            want = want_tok.text_to_ids(text, language=lang)
            assert got_tok.text_to_ids(text, language=lang) == want, (lang, text)
            assert len(want) > 40 and want[0] == want_tok.characters.blank_id
            assert got_tok.decode(want) == want_tok.decode(want)
    got, want = got_cfg.to_dict(), want_cfg.to_dict()
    got_class = got["characters"].pop("characters_class")
    want_class = want["characters"].pop("characters_class")
    assert got_class == "tts_tpu_torch.text.characters." + want_class.rsplit(".", 1)[1]
    assert got == want
    assert type(got_tok.characters).__name__ == (
        "VitsCharacters" if kind == "zoo" else "IPAPhonemes")
    if kind == "recipe":  # no phonemizer named: the default one is written back
        assert got_cfg.phonemizer == want_cfg.phonemizer == phonemizers.DEF_LANG_TO_PHONEMIZER["en-us"]
    if kind == "multi":
        assert got_tok.phonemizer.lang_to_phonemizer_name == {"en-us": "en_g2p", "es": "latin_g2p"}
        with pytest.raises(ValueError, match="Language must be set"):
            got_tok.text_to_ids(SENTENCES[0], language="")


@pytest.mark.parametrize("kind", ["recipe", "zoo"])
def test_phoneme_vits_builds_the_jax_embedding(kind):
    """With ``num_chars`` left to the vocabulary, the port's token embedding
    has the JAX model's rows: 131 for the recipe's ``IPAPhonemes``, 181 for
    the zoo layout's ``VitsCharacters``."""
    def build(pkg, model_cls):
        config = _configs(pkg)[kind]
        config.model_args.num_chars = None
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            return model_cls.init_from_config(config)

    want = build(JAX, JaxVits).config.model_args.num_chars
    port = build(PORT, Vits)
    assert port.config.model_args.num_chars == want == {"recipe": 131, "zoo": 181}[kind]
    assert port.module.text_encoder.emb.weight.shape[0] == want


def test_embedding_smaller_than_the_vocabulary_raises():
    """ROADMAP.md F7: the recipe as published keeps ``VitsArgs.num_chars``
    at 100 in the JAX package while its tokenizer emits ids up to 130; the
    port refuses the config."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jm = JaxVits.init_from_config(_configs(JAX)["recipe"])
    assert jm.config.model_args.num_chars == 100
    assert max(jm.tokenizer.text_to_ids(SENTENCES[0])) >= 100
    with pytest.raises(ValueError, match="num_chars=100 is smaller than the 131 symbols"):
        Vits.init_from_config(_configs(PORT)["recipe"])
