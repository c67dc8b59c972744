"""The port's trainer (``tts_tpu_torch.trainer.trainer``), checkpoint files
(``utils/io.py``) and ``train_tts`` command, on the CPU.

F54: the posterior encoder reads the linear magnitude spectrogram of the
waveform (``wav_to_spec``, as the reference computes it on the device);
the JAX package feeds it the data pipeline's ``AudioProcessor``
spectrogram, in decibels. The JAX run here gets the linear one through its
model's ``format_batch`` (``linear_spec``; ``tts_tpu/`` unchanged), and
``test_f54_posterior_reads_the_linear_spectrogram`` names the divergence.

Against the JAX ``Trainer``: two steps of ``Trainer.fit`` on a tiny VITS
config (``train_args`` of ``tests/test_torch_vits_train.py``, dropout 0)
over a corpus written under ``tmp_path`` (``tests/torch_corpus.py``), then a
full evaluation. The JAX initial weights are carried across
(``vits_from_jax_params``, ``vits_discriminator_from_jax_params``); the JAX
run's draws are recorded inside its jitted step and replayed into the port
by shape, as ``tests/test_torch_vits_train.py`` replays them. Each step's
losses and the eval losses agree within the step tests' 1e-5 (5e-5 for the
duration NLL), and the parameters after the fit within the free-running
bound of two steps (2 x 1.5 lr: Adam turns gradient rounding into moves of
up to ~1.5 lr, ``tests/test_torch_vits_train_step.py``). The JAX trainer
runs on one CPU device here (its mesh cut to one device, so no batch row is
repeated to fill a mesh); the port has no mesh (ROADMAP.md item 18). The
batches are padded to one shape, so the JAX step compiles once.

The same run holds the callback order and the checkpoint names and pruning
against the JAX trainer's. The port alone: ``--continue_path`` after a
KeyboardInterrupt gives weights and optimizer states bit-equal to an
uninterrupted run; ``--restore_path`` copies and keeps as many tensors as
the JAX ``_partial_merge`` counts; ``logger_factory`` falls back to the
console; ``test_run`` makes no figures without matplotlib;
``train_tts --device cpu`` trains, the ``tts`` command line speaks its
``best_model.pth``, and ``--continue_path`` resumes it; ``train_tts``
without ``--device`` raises without CUDA.
"""

import torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import copy
import os
import sys

import jax
import numpy as np
import pytest
import scipy.io.wavfile
import torch
from helpers import fast_params
from test_torch_vits_model import WEIGHT_SCALE
from test_torch_vits_train import SDP_NLL_TOL, recorded_jax_draws, replayed_draws, train_args
from test_torch_vits_train_step import recorded_jax_grads
from torch_corpus import AUDIO, write_ljspeech

import tts_tpu.trainer.trainer as jax_trainer_mod
from tts_tpu.data import load_tts_samples as jax_load_tts_samples
from tts_tpu.models.vits import Vits as JaxVits
from tts_tpu.models.vits import VitsArgs as JaxVitsArgs
from tts_tpu.models.vits import VitsConfig as JaxVitsConfig
from tts_tpu.parallel import mesh as jax_mesh
from tts_tpu.trainer.logging import logger_factory as jax_logger_factory
from tts_tpu_torch.audio.torch_transforms import wav_to_spec
from tts_tpu_torch.bin import synthesize as port_synthesize
from tts_tpu_torch.bin import train_tts
from tts_tpu_torch.config.shared import BaseDatasetConfig
from tts_tpu_torch.models.vits import Vits, VitsConfig
from tts_tpu_torch.models.vits import train as port_train
from tts_tpu_torch.trainer import trainer as port_trainer_mod
from tts_tpu_torch.trainer.logging import ConsoleLogger, logger_factory
from tts_tpu_torch.trainer.trainer import Trainer, TrainerArgs, step_seed
from tts_tpu_torch.utils import io as port_io
from tts_tpu_torch.utils.convert import (
    flax_to_state_dict,
    vits_discriminator_from_jax_params,
    vits_from_jax_params,
)

LR = 2e-4  # the recipe's lr_gen and lr_disc
FREE_TOL = 2 * 1.5 * LR  # two free-running steps (see the module's docstring)
EVENTS = ("on_init_start", "on_init_end", "on_epoch_start", "on_epoch_end",
          "on_train_step_start", "on_train_step_end", "on_keyboard_interrupt")


def fit_config(cls, root, **over):
    """The tiny VITS (one layer a stack, a 1/16 discriminator) over the
    written LJSpeech corpus: batches of 8, 16 training clips (two steps an
    epoch), 8 for evaluation in one batch, graphemes, every batch padded to
    128 ids and 160 frames."""
    args_cls = JaxVitsArgs if cls is JaxVitsConfig else None
    kw = train_args(True, num_chars=None, out_channels=AUDIO["fft_size"] // 2 + 1)
    ds = dict(formatter="ljspeech", dataset_name="ljspeech", meta_file_train="metadata.csv",
              path=root, language="en")
    fields = dict(batch_size=8, eval_batch_size=8, epochs=1, print_step=1, save_step=1,
                  save_n_checkpoints=1, dashboard_logger="console", test_sentences=[],
                  text_cleaner="english_cleaners", use_phonemes=False, eval_split_size=8,
                  pad_to_multiple_text=128, pad_to_multiple_mel=160) | over
    if args_cls is not None:
        from tts_tpu.config.shared import BaseDatasetConfig as JaxDatasetConfig
        config = cls(model_args=args_cls(**kw), datasets=[JaxDatasetConfig(**ds)], **fields)
    else:
        config = cls(datasets=[BaseDatasetConfig(**ds)], **fields)
        for k, v in kw.items():
            setattr(config.model_args, k, v)
    for k, v in AUDIO.items():
        setattr(config.audio, k, v)
    return config


def linear_spec(format_batch, audio):
    """The JAX model's ``format_batch`` with the posterior's input replaced
    by the reference's linear magnitude spectrogram of the waveform, the
    one the port computes (``Vits.format_batch_on_device``), where the JAX
    package feeds the ``AudioProcessor``'s decibels (ROADMAP.md F54)."""

    def formatted(batch):
        batch = format_batch(batch)
        wav = torch.from_numpy(np.asarray(batch["waveform"], np.float32)[..., 0])
        spec = wav_to_spec(wav, audio.fft_size, audio.hop_length, audio.win_length)
        batch["spec"] = spec.transpose(1, 2).numpy()
        return batch

    return formatted


class Recorder(ConsoleLogger):
    """A dashboard that keeps every scalar and audio it is given."""

    def __init__(self):
        self.scalars, self.audios, self.figures = [], {}, {}

    def add_scalars(self, scope, scalars, step):
        self.scalars.append((scope, step, {k: float(v) for k, v in scalars.items()}))

    def add_audios(self, scope, audios, step, sample_rate):
        self.audios.update(audios)

    def add_figures(self, scope, figures, step):
        self.figures.update(figures)


def recording_callbacks(events):
    return {e: (lambda trainer, e=e: events.append(e)) for e in EVENTS}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return write_ljspeech(str(tmp_path_factory.mktemp("lj")), 24, seed=3)


@pytest.fixture(scope="module")
def parity(corpus, tmp_path_factory):
    """The JAX trainer's fit and the port's on the same samples, weights and
    draws: per run the dashboard's scalars, the callback events, the files
    written, and the weights after the fit."""
    jcfg = fit_config(JaxVitsConfig, corpus)
    jm = JaxVits.init_from_config(jcfg)
    gen_params, disc_params = fast_params(jm.init_params, jax.random.PRNGKey(0), seed=0,
                                          scale=WEIGHT_SCALE)
    jm.init_params = lambda rng, *a, **k: (gen_params, disc_params)
    jm.format_batch = linear_spec(jm.format_batch, jcfg.audio)  # F54
    pcfg = VitsConfig.from_dict(jcfg.to_dict())
    port = Vits.init_from_config(pcfg)
    port.load_state_dict(vits_from_jax_params(gen_params))
    port.discriminator = port.discriminator.to_empty(device="cpu")
    port.load_discriminator_state_dict(vits_discriminator_from_jax_params(disc_params))
    train, evals = jax_load_tts_samples([d.to_dict() for d in jcfg.datasets], eval_split=True,
                                        eval_split_size=jcfg.eval_split_size)
    assert len(train) == 16 and len(evals) == 8
    out = {}

    real_mesh = jax_mesh.get_mesh
    jax_trainer_mod.get_mesh = lambda data=-1, model=1, **kw: real_mesh(
        data=1, model=1, devices=jax.devices()[:1])
    try:
        events = []
        run_dir = str(tmp_path_factory.mktemp("jax_run"))
        with recorded_jax_draws() as draws, recorded_jax_grads() as grads:
            jt = jax_trainer_mod.Trainer(
                jax_trainer_mod.TrainerArgs(), jcfg, run_dir, jm, copy.deepcopy(train),
                copy.deepcopy(evals), callbacks=recording_callbacks(events))
            jt.dashboard = Recorder()
            jt.fit()
            jax.effects_barrier()
    finally:
        jax_trainer_mod.get_mesh = real_mesh
    out["jax"] = dict(scalars=jt.dashboard.scalars, events=events, files=sorted(os.listdir(run_dir)),
                      params={k: jax.tree.map(np.asarray, v) for k, v in jt.state.params.items()},
                      init=flax_to_state_dict(gen_params))
    draws = {k: list(v) for k, v in draws.items()}
    # the JAX step draws the posterior's and the duration posterior's
    # normals and the segments' uniforms; two steps, then one eval batch
    assert len(draws["normal"]) == 6 and len(draws["uniform"]) == 3 and len(grads) == 2
    grads = [{"gen": flax_to_state_dict(g), "disc": flax_to_state_dict(d)} for g, d in grads]

    for forced in (False, True):
        events = []
        run_dir = str(tmp_path_factory.mktemp("port_run"))
        with replayed_draws(draws):
            pt = Trainer(TrainerArgs(), copy.deepcopy(pcfg), run_dir, copy.deepcopy(port),
                         copy.deepcopy(train), copy.deepcopy(evals),
                         callbacks=recording_callbacks(events), device="cpu")
            if forced:  # each update applies the JAX step's gradients
                names, apply = port_train.param_names(pt.model), pt.state.apply_updates

                def teacher(g, names=names, apply=apply):
                    ref = grads[pt.state.step]
                    return apply({k: [ref[k][n] for n in names[k]] for k in g})

                pt.state.apply_updates = teacher
            pt.dashboard = Recorder()
            pt.fit()
        out["forced" if forced else "port"] = dict(
            scalars=pt.dashboard.scalars, events=events, files=sorted(os.listdir(run_dir)),
            trainer=pt)
    return out


LOSSES = ("loss", "loss_gen_total", "loss_disc", "loss_mel", "loss_kl", "loss_feat", "loss_gen",
          "loss_duration")


def test_fit_losses_match_jax(parity):
    """Every step's losses and the eval losses, the port's updates applying
    the JAX gradients (teacher-forced): free-running, the weights differ by
    up to ~1.5 lr a step, enough to flip a near-tie of the eval's MAS and
    move its duration loss by ~2e-3 (measured)."""
    got, want = parity["forced"]["scalars"], parity["jax"]["scalars"]
    assert [(s, n) for s, n, _ in got] == [(s, n) for s, n, _ in want] == [
        ("train", 1), ("train", 2), ("eval", 2)]
    for (_, _, g), (_, _, w) in zip(got, want):
        for k in LOSSES:
            tol = SDP_NLL_TOL if k == "loss_duration" else 1e-5
            assert abs(g[k] - w[k]) <= tol * abs(w[k]), (k, g[k], w[k])


def test_fit_parameters_match_jax(parity):
    """Free-running: within 2 x 1.5 lr of the JAX weights; teacher-forced,
    within 1e-6 (the optimizer, schedule and clip agree to rounding). The
    attention key biases (``conv_k.bias``) have zero gradient in exact
    arithmetic, so each package moves them by its own rounding noise, which
    Adam scales to steps of up to ~1.5 lr in either direction: each
    package's move from the initial value is held within 2 x 1.5 lr."""
    pt = parity["port"]["trainer"]
    want = {"gen": flax_to_state_dict(parity["jax"]["params"]["gen"]),
            "disc": flax_to_state_dict(parity["jax"]["params"]["disc"])}
    init = parity["jax"]["init"]
    names = port_train.param_names(pt.model)
    for group in ("gen", "disc"):
        got = dict(zip(names[group], pt.state.params[group]))
        assert set(got) == set(want[group])
        for name, w in want[group].items():
            if name.endswith("conv_k.bias"):
                for moved in (got[name].detach(), w):
                    assert float((moved - init[name]).abs().max()) <= FREE_TOL, name
                continue
            err = float((got[name].detach() - w).abs().max())
            assert err <= FREE_TOL, (group, name, err)
        forced = dict(zip(names[group], parity["forced"]["trainer"].state.params[group]))
        for name, w in want[group].items():
            err = float((forced[name].detach() - w).abs().max())
            assert err <= 1e-6, (group, name, err)
    assert pt.state.step == pt.global_step == 2
    assert all(o.count == 2 for o in pt.state.opt_states.values())


def test_callback_order_matches_jax(parity):
    assert parity["port"]["events"] == parity["jax"]["events"] == [
        "on_init_start", "on_init_end", "on_epoch_start", "on_train_step_start",
        "on_train_step_end", "on_train_step_start", "on_train_step_end", "on_epoch_end"]


def test_checkpoint_names_and_pruning_match_jax(parity):
    """``save_step`` 1 and ``save_n_checkpoints`` 1: both prune the first
    step's checkpoint and keep the best model. F53: the end of ``fit``
    saves the last state again under the name of step 2's checkpoint; the
    JAX trainer counts that file twice and prunes it, leaving no state to
    continue from; the port keeps it."""
    want = [f.replace(".msgpack", ".pth") for f in parity["jax"]["files"]]
    assert want == ["best_model.pth", "config.json"]
    assert parity["port"]["files"] == ["best_model.pth", "checkpoint_2.pth", "config.json"]


@pytest.mark.parametrize("keep", [1, 2, 3])
def test_pruning_keeps_the_last_checkpoints(parity, tmp_path, keep, monkeypatch):
    """Periodic checkpoints are pruned oldest first to ``save_n_checkpoints``,
    by the JAX trainer's rule (its ``save`` on the same names; both
    packages' file writers replaced by an empty file)."""
    import tts_tpu.trainer.trainer as jt

    empty = lambda path, *a, **k: open(path, "wb").close()  # noqa: E731
    monkeypatch.setattr(jt, "save_checkpoint", empty)
    monkeypatch.setattr(jt.jax, "device_get", lambda x: x)
    monkeypatch.setattr(port_trainer_mod, "save_checkpoint", empty)
    pt = parity["port"]["trainer"]
    kept = {}
    for name, trainer_cls, ext in (("port", Trainer, ".pth"), ("jax", jt.Trainer, ".msgpack")):
        d = tmp_path / name
        d.mkdir()
        fake = type("T", (), {})()
        fake.output_path, fake._saved_checkpoints = str(d), []
        fake.config = type("C", (), {"save_n_checkpoints": keep})()
        fake.global_step, fake.best_loss, fake.epochs_done = 0, 0.0, 0
        fake.state, fake.model = pt.state, pt.model
        fake._checkpoint_state = lambda: {"model": {}}
        for step in (1, 2, 3, 4):
            trainer_cls.save(fake, f"checkpoint_{step}{ext}")
        kept[name] = sorted(f.split(".")[0] for f in os.listdir(d))
    assert kept["port"] == kept["jax"] == [f"checkpoint_{s}" for s in range(5 - keep, 5)]


def test_checkpoint_file_layout(parity):
    pt = parity["port"]["trainer"]
    path = os.path.join(pt.output_path, "checkpoint_2.pth")
    payload = torch.load(path, map_location="cpu", weights_only=True)
    assert set(payload) == {"model", "discriminator", "optimizer", "config", "meta"}
    assert payload["meta"] == {"step": 2, "best_loss": pt.best_loss, "epochs_done": 1}
    assert set(payload["optimizer"]) == {"step", "gen", "disc"}
    assert payload["optimizer"]["gen"]["count"] == 2
    state, config, meta = port_io.load_checkpoint(path)
    assert config["model"] == "vits" and meta["step"] == 2
    for k, v in pt.model.module.state_dict().items():
        assert torch.equal(state[k], v)
    # the Vits loader reads the file as it stands
    fresh = Vits.init_from_config(VitsConfig.from_dict(config))
    fresh.load_checkpoint(fresh.config, checkpoint_path=path, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(fresh.module.state_dict().values(),
                                                 pt.model.module.state_dict().values()))


def port_fit(config, run_dir, samples, callbacks=None, args=None):
    model = Vits.init_from_config(copy.deepcopy(config))
    t = Trainer(args or TrainerArgs(), copy.deepcopy(config), run_dir, model,
                copy.deepcopy(samples[0]), copy.deepcopy(samples[1]), callbacks=callbacks,
                device="cpu")
    t.fit()
    return t


@pytest.fixture(scope="module")
def port_samples(corpus):
    from tts_tpu_torch.data import load_tts_samples

    config = fit_config(VitsConfig, corpus)
    return load_tts_samples([d.to_dict() for d in config.datasets], eval_split=True,
                            eval_split_size=config.eval_split_size)


def test_continue_after_interrupt_is_bit_exact(corpus, port_samples, tmp_path):
    """Two epochs uninterrupted against one epoch, a KeyboardInterrupt at
    the second epoch's start (``checkpoint_2_interrupted.pth``) and a
    ``--continue_path`` run: weights, optimizer moments and counts, step,
    best loss and epochs done bit-equal. The draws are reseeded from
    ``(seed, step)`` before each step, dropout on."""
    config = fit_config(VitsConfig, corpus, epochs=2, save_step=0)
    config.model_args.dropout_p_text_encoder = 0.1
    config.model_args.dropout_p_duration_predictor = 0.1
    whole = port_fit(config, str(tmp_path / "whole"), port_samples)

    def interrupt(trainer):
        if trainer.epochs_done == 1:
            raise KeyboardInterrupt

    events = []
    cb = recording_callbacks(events)
    cb["on_epoch_start"] = [cb["on_epoch_start"], interrupt]
    cut = port_fit(config, str(tmp_path / "cut"), port_samples, callbacks=cb)
    assert events[-2:] == ["on_epoch_start", "on_keyboard_interrupt"]
    assert "checkpoint_2_interrupted.pth" in os.listdir(tmp_path / "cut")
    assert cut.global_step == 2
    resumed = port_fit(config, str(tmp_path / "cut"), port_samples,
                       args=TrainerArgs(continue_path=str(tmp_path / "cut")))
    assert resumed.global_step == whole.global_step == 4
    assert resumed.epochs_done == whole.epochs_done == 2
    assert resumed.best_loss == whole.best_loss
    for group in ("gen", "disc"):
        for a, b in zip(resumed.state.params[group], whole.state.params[group]):
            assert torch.equal(a, b)
        sa = resumed.state.opt_states[group].state_dict()
        sb = whole.state.opt_states[group].state_dict()
        assert sa["count"] == sb["count"] == 4
        for i, st in sb["torch_optimizer"]["state"].items():
            for k, v in st.items():
                assert torch.equal(sa["torch_optimizer"]["state"][i][k], v), (group, i, k)


def test_step_seed_is_a_function_of_seed_and_step():
    assert step_seed(54321, 3) == step_seed(54321, 3)
    assert len({step_seed(s, n) for s in (1, 2) for n in range(4)}) == 8


def test_grad_accumulation_state_survives_a_checkpoint(tmp_path):
    """``OptimizerState.state_dict`` carries the accumulation buffer and the
    counts through a checkpoint file; a restored state's next updates equal
    the original's."""
    from tts_tpu_torch.trainer.optim import build_optimizer

    torch.manual_seed(0)
    ps = [torch.nn.Parameter(torch.randn(3, 2)), torch.nn.Parameter(torch.randn(4))]
    spec = build_optimizer("adamw", lambda n: 1e-2 * 0.5 ** n, {"weight_decay": 0.01},
                           grad_clip=1.0, grad_accum=3)
    a = spec.init(ps)
    for _ in range(4):  # one update and one gradient accumulated
        a.update([torch.randn_like(p) for p in ps])
    path = str(tmp_path / "opt.pth")
    port_io.save_checkpoint(path, {}, optimizer={"g": a.state_dict()})
    state = port_io.load_checkpoint_full(path)["optimizer"]["g"]
    assert state["mini_step"] == 1 and state["acc"] is not None and state["count"] == 1
    qs = [torch.nn.Parameter(p.detach().clone()) for p in ps]
    b = spec.init(qs)
    b.load_state_dict(state)
    g = [torch.randn_like(p) for p in ps]
    for opt, params in ((a, ps), (b, qs)):
        opt.update([x.clone() for x in g])
        opt.update([x.clone() for x in g])
    assert a.count == b.count == 2
    assert all(torch.equal(p, q) for p, q in zip(ps, qs))


def test_restore_path_counts_match_jax_partial_merge(corpus, port_samples, tmp_path, capsys):
    """A single-speaker checkpoint restored into a model with speaker
    embeddings: the tensors present in both with one shape are copied,
    the speaker layers kept, counted as the JAX ``_partial_merge`` counts
    the leaves of the same two models' trees."""
    single = fit_config(VitsConfig, corpus)
    multi = fit_config(VitsConfig, corpus)
    multi.model_args.use_speaker_embedding = True
    multi.model_args.num_speakers = 3
    multi.model_args.speaker_embedding_channels = 8
    source = Vits.init_from_config(copy.deepcopy(single)).init_params(seed=1, device="cpu",
                                                                      discriminator=True)
    path = str(tmp_path / "single.pth")
    port_io.save_checkpoint(path, source.module.state_dict(), config=single,
                            discriminator=source.discriminator.state_dict())
    t = Trainer(TrainerArgs(restore_path=path), copy.deepcopy(multi), str(tmp_path / "run"),
                Vits.init_from_config(copy.deepcopy(multi)), port_samples[0], port_samples[1],
                device="cpu")
    copied, kept = t.partial_restore
    assert kept > 0 and copied > kept
    got = dict(t.model.module.state_dict())
    for k, v in source.module.state_dict().items():
        if tuple(v.shape) == tuple(got[k].shape):
            assert torch.equal(got[k], v), k

    trees = {}
    for name, cfg in (("single", single), ("multi", multi)):
        jm = JaxVits.init_from_config(JaxVitsConfig.from_dict(copy.deepcopy(cfg).to_dict()))
        g, d = fast_params(jm.init_params, jax.random.PRNGKey(0), seed=0, scale=0.1)
        trees[name] = {"gen": g, "disc": d}
    capsys.readouterr()
    jax_trainer_mod.Trainer._partial_merge(trees["multi"], trees["single"])
    line = [ln for ln in capsys.readouterr().out.splitlines() if "Partial restore" in ln][-1]
    assert line.strip() == f"> Partial restore: {copied} tensors copied, {kept} kept from init"


@pytest.mark.parametrize("name", ["wandb", "clearml", "aim", "no_such_dashboard", "console"])
def test_logger_factory_falls_back_to_the_console(name, tmp_path, capsys):
    config = VitsConfig(dashboard_logger=name)
    got = logger_factory(config, str(tmp_path))
    want = jax_logger_factory(config, str(tmp_path))
    assert type(got).__name__ == type(want).__name__ == "ConsoleLogger"
    out = capsys.readouterr().out
    if name != "console":
        assert out.count("[!]") == 2  # one warning from each package


def test_tensorboard_falls_back_without_its_package(tmp_path, monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    got = logger_factory(VitsConfig(dashboard_logger="tensorboard"), str(tmp_path))
    assert type(got) is ConsoleLogger
    assert "TensorBoard unavailable" in capsys.readouterr().out


@pytest.mark.parametrize("with_matplotlib", [True, False])
def test_test_run_speaks_and_plots_where_matplotlib_is(parity, with_matplotlib, monkeypatch):
    """The test sentences are spoken (the audio reaches the dashboard);
    figures only where matplotlib imports: the card's machine has none."""
    if not with_matplotlib:
        monkeypatch.setitem(sys.modules, "matplotlib", None)
    pt = parity["port"]["trainer"]
    monkeypatch.setattr(pt.config, "test_sentences", ["A quick test.", "Another one here."])
    pt.dashboard = Recorder()
    pt.test_run()
    assert sorted(pt.dashboard.audios) == ["test_0/audio", "test_1/audio"]
    assert all(np.isfinite(w).all() and len(w) > 0 for w in pt.dashboard.audios.values())
    assert pt.last_test_audios.keys() == pt.dashboard.audios.keys()
    if with_matplotlib:
        assert sorted(pt.dashboard.figures) == ["test_0/alignment", "test_1/alignment"]
    else:
        assert pt.dashboard.figures == {}


def test_train_tts_trains_speaks_and_resumes(corpus, tmp_path):
    """``train_tts --device cpu``: config.json, checkpoint_<step>.pth and
    best_model.pth; the ``tts`` command line speaks best_model.pth; a
    ``--continue_path`` run with one more epoch continues the step count."""
    config = fit_config(VitsConfig, corpus, save_step=0, save_n_checkpoints=5)
    cfg_path = str(tmp_path / "config.json")
    config.save_json(cfg_path)
    run = str(tmp_path / "run")
    t = train_tts.main(["--config_path", cfg_path, "--output_path", run, "--device", "cpu",
                        "--coqpit.print_step", "2"])
    assert t.global_step == 2 and t.config.print_step == 2
    assert sorted(os.listdir(run)) == ["best_model.pth", "checkpoint_2.pth", "config.json"]
    wav = str(tmp_path / "out.wav")
    port_synthesize.main(["--text", "A quick test.", "--model_path",
                          os.path.join(run, "best_model.pth"), "--config_path",
                          os.path.join(run, "config.json"), "--out_path", wav, "--device", "cpu"])
    sr, audio = scipy.io.wavfile.read(wav)
    assert sr == AUDIO["sample_rate"] and len(audio) > 0
    r = train_tts.main(["--continue_path", run, "--device", "cpu", "--coqpit.epochs", "2"])
    assert r.global_step == 4 and r.epochs_done == 2
    assert "checkpoint_4.pth" in os.listdir(run)


def test_train_tts_needs_cuda_unless_asked_for_the_cpu(corpus, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    config = fit_config(VitsConfig, corpus)
    cfg_path = str(tmp_path / "config.json")
    config.save_json(cfg_path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_tts.main(["--config_path", cfg_path, "--output_path", str(tmp_path / "run")])
    assert not os.path.exists(tmp_path / "run")


def test_generic_step_waits_for_17c_and_17d(tmp_path):
    """The generic step came with 17c (the vocoders' training): a model
    with neither its own step nor a ``train_step`` loss still raises,
    naming 17d alone."""
    class NoStep:
        pass

    with pytest.raises(NotImplementedError, match="item 17d") as err:
        Trainer(TrainerArgs(), VitsConfig(), str(tmp_path), NoStep(), [], device="cpu")
    assert str(err.value) == port_trainer_mod.NO_STEP_REASON
    assert "17c" not in str(err.value)


def test_f54_posterior_reads_the_linear_spectrogram(parity, corpus):
    """F54: the step's ``spec`` is ``wav_to_spec`` of the batch's waveform
    (the reference's linear magnitude), not the data pipeline's decibel
    spectrogram, which the JAX package feeds; the batch's frames and
    lengths are the pipeline's. The port's pipeline computes neither that
    spectrogram nor the mel for VITS (``Vits.dataset_features``): the step
    reads the waveform alone."""
    from tts_tpu_torch.audio.processor import AudioProcessor

    pt = parity["port"]["trainer"]
    assert pt.config.compute_linear_spec  # the recipe's flag, which the port's VITS skips
    ds = pt.get_dataset(pt.train_samples)
    assert (ds.compute_linear_spec, ds.compute_mel, ds.return_wav) == (False, False, True)
    batch = next(iter(ds.batches(8, shuffle=False)))
    assert "spec" not in batch and "mel_input" not in batch
    got = pt._format_batch(dict(batch))
    audio = pt.config.audio
    want = wav_to_spec(torch.from_numpy(batch["waveform"][..., 0]), audio.fft_size,
                       audio.hop_length, audio.win_length).transpose(1, 2)
    assert torch.equal(got["spec"], want)
    frames = batch["waveform"].shape[1] // audio.hop_length
    assert got["spec"].shape == (8, frames, audio.fft_size // 2 + 1)
    assert np.array_equal(got["spec_lengths"].numpy(), batch["mel_lengths"])
    ap = AudioProcessor.init_from_config(audio, verbose=False)
    db = ap.spectrogram(batch["waveform"][0, :, 0])  # what the JAX pipeline feeds
    assert float(got["spec"].min()) > 0 and float(db.min()) < 0  # dB there


def test_encoder_rate_format_batch_matches_jax_lengths():
    """``encoder_sample_rate``: the spectrogram of the waveform resampled
    down and the JAX package's ``spec_lengths`` rule (``mel_lengths //
    factor``, capped at the frames); its values the reference's linear
    magnitude (F54), whose uncentred frames are one fewer than the JAX
    package's centred ``AudioProcessor`` frames: a frame a hop."""
    from tts_tpu_torch.audio import numpy_transforms as nt

    jcfg = JaxVitsConfig(model_args=JaxVitsArgs(**train_args(
        True, encoder_sample_rate=8000, interpolate_z=True)))
    for k, v in AUDIO.items():
        setattr(jcfg.audio, k, v)
    port = Vits(VitsConfig.from_dict(jcfg.to_dict()))
    rs = np.random.RandomState(3)
    batch = {"waveform": (0.1 * rs.randn(2, 40 * 16, 1)).astype(np.float32),
             "mel_lengths": np.asarray([40, 23], np.int32), "spec": np.zeros((2, 40, 65))}
    got = port.format_batch(dict(batch))
    want = JaxVits(jcfg).format_batch(dict(batch))
    frames = 40 * 16 // 2 // 16
    assert got["spec"].shape == (2, frames, 65) and want["spec"].shape == (2, frames + 1, 65)
    np.testing.assert_array_equal(got["spec_lengths"], np.minimum(want["spec_lengths"], frames))
    np.testing.assert_array_equal(got["spec_lengths"], [20, 11])
    low = nt.resample_wav(batch["waveform"][1, :, 0], 16000, 8000).astype(np.float32)
    ref = wav_to_spec(torch.from_numpy(low)[None], 128, 16, 128)[0].T.numpy()
    np.testing.assert_array_equal(got["spec"][1, : ref.shape[0]], ref)
    assert port.format_batch_on_device(got) is got  # the host's spectrogram stays
