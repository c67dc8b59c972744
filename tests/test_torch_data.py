"""The port's data pipeline (``tts_tpu_torch.data``, ``ops.helpers``'
attention prior) against the JAX package's (``tts_tpu.data``), with no
tolerance: the same samples, splits, formatter outputs, balancer weights,
sampler orders and priors, and ``TTSDataset.batches`` bit-equal batch for
batch in the same order (plain, weighted, thread and process workers, the
linear spectrogram, the waveform, the attention prior, speaker, language
and d-vector mappings).

Every corpus is written under ``tmp_path`` (``tests/torch_corpus.py``): the
reference's LJSpeech fixture is not in the repository. The JAX run here is
numpy on the host (its data layer never calls JAX), shared through one
module-scoped corpus.
"""

import torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import copy
import inspect
import os

import numpy as np
import pytest
from torch_corpus import AUDIO, write_ljspeech, write_mailabs, write_vctk

import tts_tpu.data as jax_data
import tts_tpu.data.formatters as jax_formatters
import tts_tpu.data.samplers as jax_samplers
from tts_tpu.audio.processor import AudioProcessor as JaxAudioProcessor
from tts_tpu.data.dataset import TTSDataset as JaxTTSDataset
from tts_tpu.ops.helpers import compute_attn_prior as jax_attn_prior
from tts_tpu.text import TTSTokenizer as JaxTTSTokenizer
from tts_tpu_torch import data as port_data
from tts_tpu_torch.audio.processor import AudioProcessor
from tts_tpu_torch.data import formatters, samplers
from tts_tpu_torch.data.dataset import TTSDataset, audio_length_samples
from tts_tpu_torch.models.vits import VitsConfig
from tts_tpu_torch.ops.helpers import beta_binomial_prior_distribution, compute_attn_prior
from tts_tpu_torch.text.tokenizer import TTSTokenizer

# the formatters the recipes under recipes/ name
RECIPE_FORMATTERS = ("bel_tts_formatter", "cml_tts", "kokoro", "libri_tts", "ljspeech",
                     "mailabs", "thorsten", "vctk")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("data")
    lj = write_ljspeech(str(root / "lj"), 21, seed=1)
    folders = write_mailabs(str(root / "mailabs"), per_speaker=4, seed=2)
    return {"lj": lj, "mailabs": folders}


def dataset_entries(corpus):
    lj = [dict(formatter="ljspeech", dataset_name="ljspeech", path=corpus["lj"],
               meta_file_train="metadata.csv", meta_file_val="", language="en",
               ignored_speakers=None)]
    ml = [dict(formatter="mailabs", dataset_name="mailabs", path=p, meta_file_train="",
               meta_file_val="", language=os.path.basename(p).split("_")[0],
               ignored_speakers=None) for p in corpus["mailabs"]]
    return {"single": lj, "multi": ml, "both": lj + ml}


@pytest.mark.parametrize("which", ["single", "multi", "both"])
@pytest.mark.parametrize("split", [dict(eval_split_size=0.25),
                                   dict(eval_split_size=3),
                                   dict(eval_split_size=0.5, eval_split_max_size=4)],
                         ids=["share", "count", "capped"])
def test_load_tts_samples_and_split_match_jax(corpus, which, split):
    datasets = dataset_entries(corpus)[which]
    got = port_data.load_tts_samples(copy.deepcopy(datasets), eval_split=True, **split)
    want = jax_data.load_tts_samples(copy.deepcopy(datasets), eval_split=True, **split)
    assert got == want
    assert len(got[1]) > 0 and len(got[0]) > len(got[1])
    speakers = {"single": 1, "multi": 4, "both": 5}[which]
    assert len({s["speaker_name"] for s in got[0] + got[1]}) == speakers


def test_split_dataset_matches_jax_on_speakers():
    rs = np.random.RandomState(0)
    items = [{"speaker_name": f"s{rs.randint(5)}", "text": str(i)} for i in range(40)]
    for size in (0.2, 7):
        got = port_data.split_dataset(copy.deepcopy(items), eval_split_size=size)
        want = jax_data.split_dataset(copy.deepcopy(items), eval_split_size=size)
        assert got == want


def test_every_formatter_is_the_jax_one():
    """The port's formatters module holds every function of the JAX one,
    each with the same source."""
    jax_fns = {n: f for n, f in inspect.getmembers(jax_formatters, inspect.isfunction)
               if f.__module__ == jax_formatters.__name__}
    port_fns = {n: f for n, f in inspect.getmembers(formatters, inspect.isfunction)
                if f.__module__ == formatters.__name__}
    assert set(port_fns) == set(jax_fns) and len(jax_fns) >= 32
    for name, fn in jax_fns.items():
        assert inspect.getsource(port_fns[name]) == inspect.getsource(fn), name
    for name in RECIPE_FORMATTERS:
        assert port_data.get_formatter_by_name(name) is port_fns[name]


def write_layout(name, root):
    """A small corpus in the layout formatter ``name`` reads; returns its
    ``(root_path, meta_file)``."""
    import scipy.io.wavfile

    def wav(path):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        scipy.io.wavfile.write(path, 16000, np.zeros(160, np.int16))

    lines = ["Hello there, I am here.", "A second line, with a comma.", "Third one."]
    if name in ("ljspeech", "thorsten", "kokoro"):
        for i in range(3):
            wav(os.path.join(root, "wavs", f"c{i}.wav"))
        body = "\n".join(f"c{i}|{t}|{t.lower()}" for i, t in enumerate(lines))
        meta = "metadata.csv"
    elif name == "bel_tts_formatter":
        for i in range(3):
            wav(os.path.join(root, "audio", f"c{i}.wav"))
        body = "\n".join(f"audio/c{i}.wav|{t}" for i, t in enumerate(lines))
        meta = "bel.csv"
    elif name == "cml_tts":
        for i in range(3):
            wav(os.path.join(root, "train", f"c{i}.wav"))
        body = "wav_filename|wav_filesize|transcript|client_id\n" + "\n".join(
            f"train/c{i}.wav|100|{t}|spk{i % 2}" for i, t in enumerate(lines))
        meta = "train.csv"
    elif name == "libri_tts":
        for i, (spk, ch) in enumerate((("19", "198"), ("19", "198"), ("26", "495"))):
            d = os.path.join(root, spk, ch)
            wav(os.path.join(d, f"{spk}_{ch}_00000{i}_000000.wav"))
            with open(os.path.join(d, f"{spk}_{ch}.trans.tsv"), "a", encoding="utf-8") as f:
                f.write(f"{spk}_{ch}_00000{i}_000000\t{lines[i]}\t{lines[i]}\n")
        return root, None
    elif name == "mailabs":
        write_mailabs(root, per_speaker=2, seed=5)
        return os.path.join(root, "en_US"), None
    elif name == "vctk":
        write_vctk(root, per_speaker=2, seed=6)
        return root, None
    else:
        raise ValueError(name)
    os.makedirs(root, exist_ok=True)
    with open(os.path.join(root, meta), "w", encoding="utf-8") as f:
        f.write(body + "\n")
    return root, meta


@pytest.mark.parametrize("name", RECIPE_FORMATTERS)
def test_recipe_formatters_match_jax(name, tmp_path):
    root, meta = write_layout(name, str(tmp_path / name))
    got = port_data.get_formatter_by_name(name)(root, meta)
    want = jax_data.get_formatter_by_name(name)(root, meta)
    assert got == want and len(got) >= 3


def test_balancer_weights_match_jax():
    rs = np.random.RandomState(3)
    items = [{"speaker_name": f"s{rs.randint(4)}", "language": ["en", "de", "fr"][rs.randint(3)],
              "audio_length": float(rs.randint(1000, 90000))} for _ in range(50)]
    for fn in ("get_language_balancer_weights", "get_speaker_balancer_weights",
               "get_length_balancer_weights"):
        np.testing.assert_array_equal(getattr(samplers, fn)(items), getattr(jax_samplers, fn)(items))
    w = samplers.get_attribute_balancer_weights(items, "speaker_name", {"s1": 3.0})
    np.testing.assert_array_equal(
        w, jax_samplers.get_attribute_balancer_weights(items, "speaker_name", {"s1": 3.0}))
    got = list(samplers.WeightedSampler(w, seed=4))
    assert got == list(jax_samplers.WeightedSampler(w, seed=4))


def test_batch_samplers_orders_match_jax():
    import random

    rs = np.random.RandomState(5)
    items = [{"class_name": f"c{rs.randint(3)}"} for _ in range(60)]
    orders = []
    for mod in (samplers, jax_samplers):
        random.seed(7)
        s = mod.PerfectBatchSampler(items, ["c0", "c1", "c2"], batch_size=6,
                                    num_classes_in_batch=3, shuffle=True)
        orders.append((list(s), len(s)))
    assert orders[0] == orders[1] and len(orders[0][0]) > 2
    lengths = rs.randint(50, 900, 70)
    got = list(samplers.BucketBatchSampler(lengths, 8, num_buckets=4, seed=9))
    want = list(jax_samplers.BucketBatchSampler(lengths, 8, num_buckets=4, seed=9))
    assert [list(map(int, b)) for b in got] == [list(map(int, b)) for b in want]
    assert sorted(i for b in got for i in b) == list(range(70))


@pytest.mark.parametrize("x_len,y_len", [(5, 17), (23, 61), (1, 3)])
def test_attention_prior_matches_jax(x_len, y_len):
    got = compute_attn_prior(x_len, y_len)
    np.testing.assert_array_equal(got, jax_attn_prior(x_len, y_len))
    assert got.shape == (y_len, x_len)
    np.testing.assert_array_equal(beta_binomial_prior_distribution(x_len, y_len, 0.5),
                                  jax_attn_prior(x_len, y_len, 0.5))


def test_audio_length_from_the_header(corpus):
    path = os.path.join(corpus["lj"], "wavs", sorted(os.listdir(
        os.path.join(corpus["lj"], "wavs")))[0])
    from tts_tpu.data.dataset import audio_length_samples as jax_len
    assert audio_length_samples(path) == jax_len(path)
    assert audio_length_samples(path, 8000) == jax_len(path, 8000) == audio_length_samples(path) / 2


def pair_of_datasets(samples, tokenizer_config, ap_kw=None, **kw):
    """The port's and the JAX package's ``TTSDataset`` over copies of the
    same samples, with tokenizers and audio processors of one config."""
    from tts_tpu.models.vits import VitsConfig as JaxVitsConfig

    out = []
    for tag, ds_cls, ap_cls, tok_cls, cfg_cls in (
            ("port", TTSDataset, AudioProcessor, TTSTokenizer, VitsConfig),
            ("jax", JaxTTSDataset, JaxAudioProcessor, JaxTTSTokenizer, JaxVitsConfig)):
        tok, cfg = tok_cls.init_from_config(cfg_cls.from_dict(tokenizer_config))
        ap = ap_cls(verbose=False, **(cfg.audio.to_dict() | (ap_kw or {})))
        # each package writes and reads its own caches
        own = {k: (v + "_" + tag if k.endswith("cache_path") else v) for k, v in kw.items()}
        ds = ds_cls(samples=copy.deepcopy(samples), ap=ap, tokenizer=tok, **own)
        ds.preprocess_samples()
        out.append(ds)
    return out


def assert_batches_equal(got, want):
    assert len(got) == len(want) and len(got) > 1
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            if isinstance(w[k], np.ndarray):
                assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
            else:
                assert g[k] == w[k], k


@pytest.fixture(scope="module")
def samples(corpus):
    datasets = dataset_entries(corpus)["both"]
    train, _ = jax_data.load_tts_samples(copy.deepcopy(datasets), eval_split=True,
                                         eval_split_size=2)
    config = VitsConfig(text_cleaner="english_cleaners", use_phonemes=False)
    for k, v in AUDIO.items():
        setattr(config.audio, k, v)
    return train, config.to_dict()


BATCH_CASES = {
    "plain": (dict(), dict()),
    "linear_wav_prior": (dict(compute_linear_spec=True, return_wav=True, use_attn_prior=True,
                              pad_to_multiple_text=8, pad_to_multiple_mel=16), dict()),
    "weighted": (dict(compute_linear_spec=True), dict(weights="speaker")),
    "threads": (dict(compute_linear_spec=True, return_wav=True),
                dict(num_workers=3, prefetch=2, worker_mode="thread")),
    "processes": (dict(compute_linear_spec=True, return_wav=True),
                  dict(num_workers=2, prefetch=2, worker_mode="process")),
    "speakers_languages": (dict(return_wav=True), dict()),
    "d_vectors": (dict(), dict(weights="language")),
    "f0_energy": (dict(compute_f0=True, compute_energy=True), dict()),
}


@pytest.mark.parametrize("case", sorted(BATCH_CASES))
def test_batches_match_jax_bit_for_bit(samples, case, tmp_path):
    train, config = samples
    ds_kw, batch_kw = copy.deepcopy(BATCH_CASES[case])
    if case == "speakers_languages":
        names = sorted({s["speaker_name"] for s in train})
        ds_kw["speaker_id_mapping"] = {n: i for i, n in enumerate(names)}
        ds_kw["language_id_mapping"] = {"en": 0, "en_US": 1, "de": 2}
        for s in train:  # the mailabs folders name their languages "en" and "de"
            assert s["language"] in ds_kw["language_id_mapping"]
    if case == "d_vectors":
        rs = np.random.RandomState(8)
        ds_kw["d_vector_mapping"] = {s["audio_unique_name"]: {"embedding": list(rs.randn(6))}
                                     for s in train}
    ap_kw = None
    if case == "f0_energy":
        ap_kw = dict(pitch_fmin=60.0, pitch_fmax=500.0)
        ds_kw["f0_cache_path"] = str(tmp_path / "f0")
        ds_kw["energy_cache_path"] = str(tmp_path / "energy")
        ds_kw["phoneme_cache_path"] = str(tmp_path / "ids")
    port_ds, jax_ds = pair_of_datasets(train, config, ap_kw, **ds_kw)
    assert [s["audio_file"] for s in port_ds.samples] == [s["audio_file"] for s in jax_ds.samples]
    weights = batch_kw.pop("weights", None)
    if weights is not None:
        fn = f"get_{weights}_balancer_weights"
        w = getattr(samplers, fn)(port_ds.samples)
        np.testing.assert_array_equal(w, getattr(jax_samplers, fn)(jax_ds.samples))
        batch_kw["weights"] = w
    for epoch in (0, 3):
        got = list(port_ds.batches(4, shuffle=True, seed=epoch, **batch_kw))
        want = list(jax_ds.batches(4, shuffle=True, seed=epoch, **batch_kw))
        assert_batches_equal(got, want)
    if case == "f0_energy":  # the second epoch read the caches both wrote
        assert len(os.listdir(tmp_path / "f0_port")) == len(train)
        # F60: the port's trainer normalises the voiced frames by the training
        # set's statistics, where the JAX pipeline feeds the raw features above
        stats = {"pitch": port_ds.feature_stats("f0"),
                 "energy": port_ds.feature_stats("energy")}
        port_ds.pitch_stats, port_ds.energy_stats = stats["pitch"], stats["energy"]
        normed = list(port_ds.batches(4, shuffle=True, seed=3))
        for g, w in zip(normed, want):
            for key, (mean, std) in stats.items():
                raw = w[key]
                expect = np.where(raw != 0, (raw - np.float32(mean)) / np.float32(std), 0)
                np.testing.assert_array_equal(g[key], expect.astype(np.float32), err_msg=key)
                assert not g[key][raw == 0].any() and g[key].std() < raw.std()
        port_ds.pitch_stats = port_ds.energy_stats = None
    got = list(port_ds.batches(5, shuffle=False, drop_last=True))
    assert_batches_equal(got, list(jax_ds.batches(5, shuffle=False, drop_last=True)))


@pytest.mark.parametrize("workers", [0, 2])
def test_batches_without_the_mel_are_the_jax_ones_without_it(samples, workers):
    """``compute_mel=False`` (what VITS's training reads: the waveform
    alone): the JAX batches without ``mel_input``, the same frame counts,
    padding and waveforms, in the same order."""
    train, config = samples
    port_ds, jax_ds = pair_of_datasets(train, config, None, return_wav=True)
    port_ds.compute_mel = False
    kw = dict(num_workers=workers, prefetch=2, worker_mode="thread") if workers else {}
    got = list(port_ds.batches(4, shuffle=True, seed=1, **kw))
    want = list(jax_ds.batches(4, shuffle=True, seed=1, **kw))
    for w in want:
        assert w.pop("mel_input").shape[1] == w["waveform"].shape[1] // port_ds.ap.hop_length
    assert_batches_equal(got, want)
