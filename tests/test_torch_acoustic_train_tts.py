"""The aligner families through the port's ``train_tts`` on the CPU:
FastPitch, GlowTTS and AlignTTS fit a corpus written under ``tmp_path``
(``tests/torch_corpus.py``: 24 LJSpeech-layout clips, 16 to train in two
steps of 8, 8 to evaluate), evaluate, checkpoint and resume bit-exactly,
and their checkpoints speak through the ``Synthesizer`` and the ``tts``
command line (Griffin-Lim). Tiny widths; the dropouts on.

F60, settled in the port (``test_f60_statistics_and_normalisation``): the
JAX pipeline feeds raw f0 in Hz and raw energy; the port normalises the
voiced frames by the training set's mean and deviation, written to
``pitch_stats.npy`` / ``energy_stats.npy`` in the caches and read back,
and the evaluation set takes the training set's. The raw cached features
stay the JAX package's (``test_torch_data.py``'s ``f0_energy`` case).
F61 and F62 through the loop: the binary alignment loss's weight follows
the epochs done, AlignTTS's phase the steps done, and a resumed run
computes what an uninterrupted one does.
"""

import torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import copy
import os

import numpy as np
import pytest
import scipy.io.wavfile
import torch
from torch_corpus import AUDIO, write_ljspeech

from tts_tpu_torch.bin import synthesize as port_synthesize
from tts_tpu_torch.bin import train_tts
from tts_tpu_torch.config.shared import BaseDatasetConfig
from tts_tpu_torch.data.dataset import normalize_voiced
from tts_tpu_torch.models.align_tts import AlignTTSConfig
from tts_tpu_torch.models.forward_tts.config import FastPitchConfig, Fastspeech2Config
from tts_tpu_torch.models.glow_tts.config import GlowTTSConfig
from tts_tpu_torch.utils.synthesizer import Synthesizer

FFT = {"hidden_channels_ffn": 48, "num_heads": 2, "num_layers": 1, "dropout_p": 0.1}
PITCH = dict(pitch_fmin=60.0, pitch_fmax=500.0)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return write_ljspeech(str(tmp_path_factory.mktemp("lj")), 24, seed=5)


def family_config(family, root, cache, **over):
    """A tiny config of ``family`` over the corpus: batches of 8, two steps
    an epoch, graphemes, the console dashboard."""
    fields = dict(batch_size=8, eval_batch_size=8, epochs=1, print_step=1, save_step=0,
                  save_n_checkpoints=5, dashboard_logger="console", test_sentences=[],
                  text_cleaner="english_cleaners", use_phonemes=False, eval_split_size=8,
                  datasets=[BaseDatasetConfig(formatter="ljspeech", dataset_name="ljspeech",
                                              meta_file_train="metadata.csv", path=root,
                                              language="en")]) | over
    if family in ("fast_pitch", "fastspeech2"):
        cls = FastPitchConfig if family == "fast_pitch" else Fastspeech2Config
        config = cls(f0_cache_path=os.path.join(cache, "f0"), **fields)
        if family == "fastspeech2":
            config.energy_cache_path = os.path.join(cache, "energy")
        a = config.model_args
        a.hidden_channels, a.out_channels = 32, AUDIO["num_mels"]
        a.encoder_params, a.decoder_params = dict(FFT), dict(FFT)
        a.duration_predictor_hidden_channels = a.pitch_predictor_hidden_channels = 24
        a.energy_predictor_hidden_channels = 24
        config.binary_loss_warmup_epochs = 2
    elif family == "glow_tts":
        config = GlowTTSConfig(out_channels=AUDIO["num_mels"], hidden_channels_enc=32,
                               hidden_channels_dec=24, hidden_channels_dp=32,
                               num_flow_blocks_dec=2, num_block_layers=2,
                               encoder_params={"kernel_size": 3, "dropout_p": 0.1,
                                               "num_layers": 1, "num_heads": 2,
                                               "hidden_channels_ffn": 48}, **fields)
    else:
        config = AlignTTSConfig(phase_start_steps=[0, 1, 3], **fields)
        a = config.model_args
        a.hidden_channels, a.hidden_channels_dp, a.out_channels = 32, 24, AUDIO["num_mels"]
        a.encoder_params, a.decoder_params = dict(FFT), dict(FFT)
    for k, v in (AUDIO | PITCH).items():
        setattr(config.audio, k, v)
    return config


def run_train_tts(config, tmp_path, name, *extra, callbacks=None):
    cfg_path = str(tmp_path / f"{name}.json")
    config.save_json(cfg_path)
    run = str(tmp_path / name)
    t = train_tts.main(["--config_path", cfg_path, "--output_path", run, "--device", "cpu",
                        *extra], callbacks=callbacks)
    return t, run


def hook_log(events):
    """Callbacks recording, at each step's start, the epochs done, the
    binary-loss weight and the phase the model holds."""
    def step_start(trainer):
        m = trainer.model
        events.append((trainer.global_step, trainer.epochs_done,
                       getattr(m, "binary_loss_weight", None), getattr(m, "phase", None)))
    return {"on_train_step_start": step_start}


@pytest.mark.parametrize("family", ["fast_pitch", "glow_tts", "align_tts"])
def test_train_tts_fits_checkpoints_and_resumes_bit_exactly(family, corpus, tmp_path):
    """Two epochs through ``train_tts`` against one epoch and a
    ``--continue_path`` run of a second: the files, the step, the epochs
    done, the best loss, the weights and the optimizer's moments bit-equal;
    F61's weight and F62's phase at each step as the schedules give them."""
    config = family_config(family, corpus, str(tmp_path / "cache"), epochs=2)
    whole_events, cut_events = [], []
    whole, _ = run_train_tts(config, tmp_path, "whole", callbacks=hook_log(whole_events))
    one = copy.deepcopy(config)
    one.epochs = 1
    first, run = run_train_tts(one, tmp_path, "cut", callbacks=hook_log(cut_events))
    assert first.global_step == 2 and np.isfinite(first.best_loss)
    assert sorted(os.listdir(run)) == ["best_model.pth", "checkpoint_2.pth", "config.json"]
    resumed = train_tts.main(["--continue_path", run, "--device", "cpu", "--coqpit.epochs", "2"],
                             callbacks=hook_log(cut_events))
    assert resumed.global_step == whole.global_step == 4
    assert resumed.epochs_done == whole.epochs_done == 2
    assert resumed.best_loss == whole.best_loss
    assert cut_events == whole_events
    for a, b in zip(resumed.state.params["model"], whole.state.params["model"]):
        assert torch.equal(a, b)
    sa = resumed.state.opt_states["model"].state_dict()
    sb = whole.state.opt_states["model"].state_dict()
    assert sa["count"] == sb["count"] == 4
    for i, st in sb["torch_optimizer"]["state"].items():
        for k, v in st.items():
            got = sa["torch_optimizer"]["state"][i][k]
            assert torch.equal(got, v) if torch.is_tensor(v) else got == v, (i, k)
    if family == "fast_pitch":  # F61: warmup over 2 epochs
        assert [w for _, _, w, _ in whole_events] == [0.0, 0.0, 0.5, 0.5]
    if family == "align_tts":  # F62: phases from [0, 1, 3] at each epoch's start
        assert [p for _, _, _, p in whole_events] == [0, 0, 1, 1]


@pytest.mark.parametrize("family", ["fast_pitch", "glow_tts", "align_tts"])
def test_checkpoint_speaks_through_the_synthesizer_and_the_cli(family, corpus, tmp_path):
    """The trained ``best_model.pth`` loads through the ``Synthesizer`` (its
    module's weights the trained ones, the aligner or MDN head among them)
    and speaks a sentence with Griffin-Lim; ``tts --model_path --config_path``
    writes it."""
    config = family_config(family, corpus, str(tmp_path / "cache"))
    t, run = run_train_tts(config, tmp_path, "run")
    best = os.path.join(run, "best_model.pth")
    synth = Synthesizer(tts_checkpoint=best, tts_config_path=os.path.join(run, "config.json"),
                        device="cpu")
    trained = t.model.module.state_dict()
    for k, v in synth.tts_model.module.state_dict().items():
        assert torch.equal(v, trained[k]), k
    assert any(k.startswith(("aligner.", "mdn_", "dec.")) for k in trained)
    wav = np.asarray(synth.tts("A quick test of the fox."))
    assert wav.size > 0 and np.isfinite(wav).all()
    out = str(tmp_path / "out.wav")
    port_synthesize.main(["--text", "A quick test.", "--model_path", best, "--config_path",
                          os.path.join(run, "config.json"), "--out_path", out, "--device", "cpu"])
    sr, audio = scipy.io.wavfile.read(out)
    assert sr == AUDIO["sample_rate"] and len(audio) > 0


@pytest.mark.parametrize("family", ["fast_pitch", "fastspeech2"])
def test_f60_statistics_and_normalisation(family, corpus, tmp_path):
    """F60: the training set's voiced-frame mean and deviation of f0 (and
    energy) land in ``pitch_stats.npy`` (``energy_stats.npy``); the training
    and evaluation batches hold ``(x - mean) / std`` on voiced frames and 0
    elsewhere, from the raw cached features; a second run reads the file
    (a changed file changes the batches)."""
    cache = str(tmp_path / "cache")
    config = family_config(family, corpus, cache)
    t, _ = run_train_tts(config, tmp_path, "run")
    kinds = [("f0", "pitch", config.f0_cache_path, "pitch_stats.npy")]
    if family == "fastspeech2":
        kinds.append(("energy", "energy", config.energy_cache_path, "energy_stats.npy"))
    train_ds = t.get_dataset(t.train_samples)
    eval_ds = t.get_dataset(t.eval_samples, is_eval=True)
    for kind, key, cache_dir, name in kinds:
        stats = np.load(os.path.join(cache_dir, name), allow_pickle=True).item()
        raw = [train_ds._cached_feature(kind, s, None) for s in train_ds.samples]
        voiced = np.concatenate([r[r != 0] for r in raw]).astype(np.float64)
        assert len(voiced) > 0 and (stats["mean"], stats["std"]) == (np.mean(voiced),
                                                                     np.std(voiced))
        assert t.feature_stats[kind][:2] == (stats["mean"], stats["std"])
        assert getattr(eval_ds, f"{key}_stats") == getattr(train_ds, f"{key}_stats") == \
            (stats["mean"], stats["std"])
        batch = next(eval_ds.batches(8, shuffle=False))
        for i, s_name in enumerate(batch["audio_unique_names"]):
            sample = next(s for s in eval_ds.samples if s["audio_unique_name"] == s_name)
            want = normalize_voiced(eval_ds._cached_feature(kind, sample, None),
                                    (stats["mean"], stats["std"]))
            got = batch[key][i, :len(want), 0]
            np.testing.assert_array_equal(got, want[:len(got)])
            assert not got[want[:len(got)] == 0].any()
        np.save(os.path.join(cache_dir, name), {"mean": np.float64(stats["mean"] + 1.0),
                                                "std": np.float64(stats["std"])})
    t2, _ = run_train_tts(copy.deepcopy(config), tmp_path, "again")
    assert t2.feature_stats["f0"][0] == t.feature_stats["f0"][0] + 1.0


def test_glow_tts_recipe_precision_trains(corpus, tmp_path):
    """The LJSpeech GlowTTS recipe sets ``mixed_precision``: the generic step
    runs under bf16 autocast (the flows' log-determinants and MAS's scores
    in fp32) and its losses stay finite."""
    config = family_config("glow_tts", corpus, str(tmp_path / "cache"), mixed_precision=True)
    t, _ = run_train_tts(config, tmp_path, "run")
    assert t.global_step == 2 and np.isfinite(t.best_loss)
    assert all(p.dtype == torch.float32 for p in t.model.module.parameters())
