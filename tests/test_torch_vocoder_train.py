"""Vocoder training in the port, on the CPU: the data
(``tts_tpu_torch.vocoder.dataset``), WaveGrad and WaveRNN through the
trainer's generic single-optimizer step, ``train_vocoder`` end to end, and
``tune_wavegrad``.

- ``load_wav_data``'s split and ``GANDataset.batches`` are bit-equal to the
  JAX package's over a corpus written under ``tmp_path`` (the JAX fixture
  corpus is absent): the JAX dataset draws from numpy's global state after
  ``np.random.seed(s)``, the port's from the ``RandomState(s)`` it is
  given; with loader workers (threads, processes) the batches are the same.
- WaveGrad and WaveRNN (mold, 9-bit classes, Gaussian): three steps of the
  port's ``Trainer`` generic step against the JAX ``Trainer``'s own
  ``_build_generic_step`` and ``_build_eval_step`` on carried params (drawn
  at unit gain, the WaveGrad head too, which flax zero-initialises), with
  WaveGrad's draws taken from the JAX step's keys (``fold_in(rng, step)``,
  then ``fold_in(., 1)`` split three ways) and given to the port: the
  losses within 1e-5, ``grad_norm`` within 1e-5, the gradients within 1e-4
  of each tensor's peak (the JAX ones ``jax.grad`` of the model's loss on
  the step's keys), the parameters after each step within 1e-6 when the
  port applies the JAX gradients, within 3 x 1.5 lr on its own. F59: the
  JAX WaveRNN's flax GRU cells have no recurrent bias for the reset and
  update gates, the reference's ``nn.GRU`` (and the port's ``GRUCell``)
  has; its gradient is that of the input bias of the same gate, which the
  test checks, and the JAX carrier sets it to 0.
- ``train_vocoder --device cpu`` (tiny HiFiGAN) trains, evaluates,
  checkpoints and resumes bit-exactly; its checkpoint vocodes through the
  ``Synthesizer`` as the trained module does; a trained WaveRNN (layer
  norms) loads there too (F58).
- ``tune_wavegrad``'s grid and each schedule's mel L1 against the JAX
  command's arithmetic on the same draws (its key chain replayed).
"""

import torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import copy
import functools
import io
import os
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_vocoders import jax_wavegrad_draws
from torch_vocoder_cases import AUDIO, fan_in_params, gan_configs, write_wavs

import tts_tpu.trainer.trainer as jax_trainer_mod
from tts_tpu.audio import jax_transforms as jt
from tts_tpu.vocoder import configs as jax_configs
from tts_tpu.vocoder import dataset as jax_dataset
from tts_tpu.vocoder.models import setup_model as jax_setup_model
from tts_tpu.vocoder.models.wavegrad import wavegrad_inference as jax_wavegrad_inference
from tts_tpu_torch.bin import train_vocoder, tune_wavegrad
from tts_tpu_torch.trainer.trainer import Trainer, TrainerArgs
from tts_tpu_torch.utils.convert import (
    vocoder_generator_from_jax_params,
    vocoder_train_state_from_jax_params,
)
from tts_tpu_torch.utils.synthesizer import Synthesizer
from tts_tpu_torch.vocoder import configs as port_configs
from tts_tpu_torch.vocoder import dataset as port_dataset
from tts_tpu_torch.vocoder.models import setup_model

LOSS_TOL = 1e-5
GRAD_TOL = 1e-4  # of each tensor's peak
PARAM_TOL = 1e-6  # teacher-forced
STEPS = 3


# --- the data ------------------------------------------------------------

@pytest.fixture(scope="module")
def wavs(tmp_path_factory):
    root = tmp_path_factory.mktemp("wavs")
    write_wavs(str(root), 11, seconds=(0.05, 0.3))
    return str(root)


def data_configs(**over):
    out = []
    for mod in (jax_configs, port_configs):
        c = mod.HifiganConfig(seq_len=2048, pad_short=500, use_noise_augment=True,
                              eval_split_size=3, **over)
        for k, v in AUDIO.items():
            setattr(c.audio, k, v)
        out.append(c)
    return out


def test_load_wav_data_splits_as_jax(wavs):
    """The same eval and train paths, in the same order; the global numpy
    state untouched."""
    np.random.seed(123)
    before = np.random.get_state()[1].copy()
    got = port_dataset.load_wav_data(wavs, 3)
    assert np.array_equal(np.random.get_state()[1], before)
    want = jax_dataset.load_wav_data(wavs, 3)
    assert got == want and len(got[0]) == 3 and len(got[1]) == 8


def _equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert set(x) == set(y)
        for k in x:
            assert x[k].dtype == y[k].dtype and np.array_equal(x[k], y[k]), k


@pytest.mark.parametrize("is_eval", [False, True])
def test_gan_dataset_batches_bit_equal_to_jax(wavs, is_eval):
    """Two epochs of batches (shuffled by epoch, the segments' starts and the
    noise augmentation drawn from one stream), the last batch short."""
    jcfg, pcfg = data_configs()
    _, train = port_dataset.load_wav_data(wavs, 3)
    np.random.seed(5)
    jds = jax_dataset.GANDataset(jcfg, train, is_eval=is_eval)
    want = [b for e in range(2) for b in jds.batches(3, shuffle=True, seed=e)]
    pds = port_dataset.GANDataset(pcfg, train, is_eval=is_eval, rng=np.random.RandomState(5))
    got = [b for e in range(2) for b in pds.batches(3, shuffle=True, seed=e)]
    _equal(got, want)
    assert got[0]["waveform"].shape == (3, 2048, 1) and got[0]["mel"].shape == (3, 32, 16)
    assert got[2]["waveform"].shape[0] == 2


@pytest.mark.parametrize("mode", ["thread", "process"])
def test_loader_workers_change_no_batch(wavs, mode):
    """Workers load and build ahead; the draws stay in order: the batches
    equal those of the loop without workers."""
    _, pcfg = data_configs()
    _, train = port_dataset.load_wav_data(wavs, 3)
    seq = list(port_dataset.GANDataset(pcfg, train).batches(2, seed=4))
    par = list(port_dataset.GANDataset(pcfg, train).batches(2, seed=4, num_workers=2,
                                                            worker_mode=mode, prefetch=2))
    _equal(par, seq)


def test_epochs_draw_from_their_own_seed(wavs):
    """Without ``rng`` an epoch's batches depend on ``(config seed, epoch)``
    alone: the same epoch twice is the same, two epochs differ."""
    _, pcfg = data_configs()
    _, train = port_dataset.load_wav_data(wavs, 3)
    ds = port_dataset.GANDataset(pcfg, train)
    a, b = list(ds.batches(4, seed=1)), list(ds.batches(4, seed=1))
    _equal(a, b)
    c = list(port_dataset.GANDataset(pcfg, train).batches(4, seed=2))
    assert not all(np.array_equal(x["waveform"], y["waveform"]) for x, y in zip(a, c))


# --- WaveGrad and WaveRNN through the generic step -------------------------

def wavegrad_configs():
    params = dict(y_conv_channels=8, x_conv_channels=16, dblock_out_channels=[8, 8, 16, 16],
                  ublock_out_channels=[16, 16, 8, 8, 8], upsample_factors=[2, 2, 2, 2, 2],
                  upsample_dilations=[[1, 2, 1, 2]] * 5, use_weight_norm=True)
    out = []
    for mod in (jax_configs, port_configs):
        c = mod.WavegradConfig(seq_len=256, model_params=dict(params),
                               train_noise_schedule={"min_val": 1e-6, "max_val": 1e-2,
                                                     "num_steps": 10})
        c.audio.num_mels, c.audio.hop_length = 16, 32
        out.append(c)
    return out


def wavernn_configs(mode):
    args = dict(rnn_dims=16, fc_dims=16, compute_dims=8, res_out_dims=8, num_res_blocks=1,
                upsample_factors=[2, 2, 2], use_upsample_net=True)
    out = []
    for mod in (jax_configs, port_configs):
        c = mod.WavernnConfig(seq_len=128, mode=mode, model_args=dict(args))
        c.audio.num_mels, c.audio.hop_length = 16, 8
        out.append(c)
    return out


CASES = {"wavegrad": wavegrad_configs, "wavernn_mold": lambda: wavernn_configs("mold"),
         "wavernn_bits": lambda: wavernn_configs(9),
         "wavernn_gauss": lambda: wavernn_configs("gauss")}


def vocoder_batch(config, B=2, seed=0):
    rs = np.random.RandomState(seed)
    T, hop = config.seq_len, config.audio.hop_length
    t = np.arange(T) / 22050
    wav = np.stack([0.5 * np.sin(2 * np.pi * rs.uniform(100, 400) * t) + 0.05 * rs.randn(T)
                    for _ in range(B)])
    return {"waveform": np.clip(wav, -0.99, 0.99).astype(np.float32)[..., None],
            "mel": rs.randn(B, T // hop, config.audio.num_mels).astype(np.float32)}


def jax_trainer(model, config, params):
    """The JAX ``Trainer``'s generic step and eval step around ``model``
    with ``params`` (its mesh and data plumbing left out)."""
    t = object.__new__(jax_trainer_mod.Trainer)
    t.config, t.model, t.grad_accum, t.mixed_precision = config, model, 1, False
    t.rng = jax.random.PRNGKey(config.seed)
    model.init_params = lambda rng: params
    t._build_generic_step()
    t._build_eval_step()
    return t


def wavegrad_keys_draws(model, key, y_shape):
    """WaveGrad's draws under the JAX step's noise key (``wavegrad.py:154-158``)."""
    B = y_shape[0]
    r1, r2, r3 = jax.random.split(key, 3)
    s = jax.random.randint(r1, (B,), 1, len(model.schedule[0]))
    u = jax.random.uniform(r2, (B,))
    noise = jax.random.normal(r3, y_shape)
    return tuple(torch.from_numpy(np.asarray(a)) for a in (s, u, noise))


@functools.lru_cache(maxsize=None)
def generic_case(kind):
    jcfg, pcfg = CASES[kind]()
    jm = jax_setup_model(jcfg)
    if kind == "wavegrad":
        hop = 32
        init = (jnp.zeros((1, jcfg.seq_len, 1)), jnp.zeros((1, jcfg.seq_len // hop, 16)),
                jnp.ones((1,)))
        params = fan_in_params(jm.model.init, jax.random.PRNGKey(0), *init, seed=1, scale=0.5)
    else:
        init = (jnp.zeros((1, 8)), jnp.zeros((1, jm.frames, 16)))
        params = fan_in_params(jm.model.init, jax.random.PRNGKey(0), *init, seed=1, scale=0.5)
    batch = vocoder_batch(pcfg)
    t = jax_trainer(jm, jcfg, params)
    step = jax.jit(t.train_step_fn)
    b = {k: jnp.asarray(v) for k, v in batch.items()}
    state, out = t.state, []
    grad = jax.jit(jax.grad(lambda p, rngs: jm.train_step(p, b, rngs=rngs)[0]))
    for i in range(STEPS):
        step_rng = jax.random.fold_in(t.rng, i)
        rngs = {"dropout": step_rng, "noise": jax.random.fold_in(step_rng, 1),
                "segments": jax.random.fold_in(step_rng, 2)}
        grads = grad(state.params["model"], rngs)
        draws = wavegrad_keys_draws(jm, rngs["noise"], batch["waveform"].shape) \
            if kind == "wavegrad" else None
        state, metrics = step(state, b, t.rng)
        out.append(dict(metrics={k: float(v) for k, v in metrics.items()}, draws=draws,
                        grads=vocoder_generator_from_jax_params(grads, jcfg.generator_model),
                        params=vocoder_generator_from_jax_params(state.params["model"],
                                                                 jcfg.generator_model)))
    eval_metrics = {k: float(v) for k, v in jax.jit(t.eval_step_fn)(state, b).items()}
    eval_draws = wavegrad_keys_draws(jm, jax.random.PRNGKey(0), batch["waveform"].shape) \
        if kind == "wavegrad" else None
    return pcfg, jcfg, params, batch, out, (eval_metrics, eval_draws)


def port_generic(kind, teacher_forced, tmp_path):
    pcfg, jcfg, params, batch, want, _ = generic_case(kind)
    model = setup_model(copy.deepcopy(pcfg))
    model.load_state_dict(vocoder_generator_from_jax_params(params, pcfg.generator_model))
    draws = iter([w["draws"] for w in want])
    if kind == "wavegrad":
        model.draw = lambda y, generator: next(draws)
    t = Trainer(TrainerArgs(), copy.deepcopy(pcfg), str(tmp_path), model, [], device="cpu")
    names = [n for n, _ in model.module.named_parameters()]
    apply, out = t.state.apply_updates, []

    def capture(grads):
        out[-1]["grads"] = dict(zip(names, (g.clone() for g in grads["model"])))
        if teacher_forced:
            grads = {"model": [want[len(out) - 1]["grads"][n] for n in names]}
        return apply(grads)

    t.state.apply_updates = capture
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    for _ in want:
        out.append({})
        t.state, metrics = t.train_step_fn(t.state, tb)
        out[-1]["metrics"] = {k: float(v) for k, v in metrics.items()}
        out[-1]["params"] = {n: p.detach().clone() for n, p in model.module.named_parameters()}
    return t, model, out


@pytest.mark.parametrize("kind", list(CASES))
def test_generic_step_matches_the_jax_trainer(kind, tmp_path):
    """Three teacher-forced steps: losses, ``grad_norm``, gradients, and the
    parameters after each step."""
    want = generic_case(kind)[4]
    _, _, got = port_generic(kind, True, tmp_path)
    for i, (g, w) in enumerate(zip(got, want)):
        assert set(g["metrics"]) == set(w["metrics"])
        for k, v in w["metrics"].items():
            assert abs(g["metrics"][k] - v) <= LOSS_TOL * max(abs(v), 1e-6), (i, k, g, w)
        for name, wg in w["grads"].items():
            got_g = g["grads"][name]
            if name.endswith("bias_hh"):  # F59: the JAX cells lack the r and z recurrent biases
                n = wg.shape[0] // 3
                ih = g["grads"][name[:-2] + "ih"]
                assert torch.equal(wg[:2 * n], torch.zeros(2 * n))
                assert float((got_g[:2 * n] - ih[:2 * n]).abs().max()) <= \
                    1e-6 * float(ih.abs().max())
                got_g, wg = got_g[2 * n:], wg[2 * n:]
            err = float((got_g - wg).abs().max())
            assert err <= GRAD_TOL * float(wg.abs().max()), (i, name, err)
        for name, p in w["params"].items():
            assert float((g["params"][name] - p).abs().max()) <= PARAM_TOL, (i, name)


@pytest.mark.parametrize("kind", ["wavegrad", "wavernn_mold"])
def test_generic_step_free_running_and_eval(kind, tmp_path):
    """The port on its own gradients: parameters within 3 x 1.5 lr after three
    steps; then the fallback evaluation (``train=False``; WaveGrad on the JAX
    eval key's draws) equals the JAX trainer's."""
    pcfg, _, _, batch, want, (eval_want, eval_draws) = generic_case(kind)
    t, model, got = port_generic(kind, False, tmp_path)
    for name, p in want[-1]["params"].items():
        err = float((got[-1]["params"][name] - p).abs().max())
        assert err <= STEPS * 1.5 * pcfg.lr, (name, err)
    # evaluation on the JAX run's final weights
    model.load_state_dict({n: p.clone() for n, p in want[-1]["params"].items()})
    if eval_draws is not None:
        model.draw = lambda y, generator: eval_draws
    got_eval = t.eval_step_fn(t.state, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert set(got_eval) == set(eval_want)
    for k, v in eval_want.items():
        assert abs(float(got_eval[k]) - v) <= LOSS_TOL * max(abs(v), 1e-6), k


def test_wavernn_targets_and_mulaw_match_jax():
    """The teacher-forcing input and targets of each mode, the mu-law labels
    bit-equal."""
    from tts_tpu.vocoder.models.wavernn import mulaw_encode_jnp
    from tts_tpu_torch.vocoder.models.wavernn import mulaw_encode

    w = np.random.RandomState(3).uniform(-1, 1, (2, 500)).astype(np.float32)
    assert np.array_equal(mulaw_encode(torch.from_numpy(w), 511).numpy(),
                          np.asarray(mulaw_encode_jnp(jnp.asarray(w), 511)))
    for kind in ("wavernn_mold", "wavernn_bits"):
        jcfg, pcfg = CASES[kind]()
        jm, pm = jax_setup_model(jcfg), setup_model(pcfg)
        wav = vocoder_batch(pcfg)["waveform"]
        for g, j in zip(pm.targets(torch.from_numpy(wav)), jm._targets(jnp.asarray(wav))):
            assert np.array_equal(g.numpy(), np.asarray(j)), kind


# --- train_vocoder end to end ----------------------------------------------

def hifigan_run_config(tmp_path, wavs_dir, **over):
    _, pcfg = gan_configs("hifigan")
    pcfg.data_path, pcfg.eval_split_size = wavs_dir, 2
    pcfg.batch_size, pcfg.eval_batch_size, pcfg.epochs = 3, 2, 1
    pcfg.print_step, pcfg.save_step, pcfg.dashboard_logger = 1, 0, "console"
    pcfg.pad_short, pcfg.use_noise_augment = 500, True
    for k, v in over.items():
        setattr(pcfg, k, v)
    path = str(tmp_path / "config.json")
    pcfg.save_json(path)
    return path


def test_train_vocoder_fits_checkpoints_and_resumes(tmp_path, wavs):
    """``train_vocoder --device cpu``: an epoch of steps, an evaluation, the
    checkpoints; ``--continue_path`` runs a second epoch whose weights and
    optimizer states equal those of an uninterrupted two-epoch run; the
    checkpoint's generator vocodes through the ``Synthesizer`` bit-equal to
    the trained module."""
    cfg = hifigan_run_config(tmp_path, wavs)
    run = str(tmp_path / "run")
    with redirect_stdout(io.StringIO()) as log:
        t1 = train_vocoder.main(["--config_path", cfg, "--output_path", run, "--device", "cpu"])
    assert t1.global_step == 3  # 9 clips to train at B=3
    files = sorted(os.listdir(run))
    assert files == ["best_model.pth", "checkpoint_3.pth", "config.json"], files
    assert "eval:" in log.getvalue() and np.isfinite(t1.best_loss)
    with redirect_stdout(io.StringIO()):
        t2 = train_vocoder.main(["--continue_path", run, "--device", "cpu",
                                 "--coqpit.epochs", "2"])
        whole = train_vocoder.main(["--config_path", cfg, "--output_path",
                                    str(tmp_path / "whole"), "--device", "cpu",
                                    "--coqpit.epochs", "2"])
    assert t2.global_step == whole.global_step == 6 and t2.epochs_done == 2
    for a, b in ((t2.model.module, whole.model.module),
                 (t2.model.discriminator, whole.model.discriminator)):
        for (n, p), q in zip(a.named_parameters(), b.parameters()):
            assert torch.equal(p, q), n
    sa, sb = t2.state.state_dict(), whole.state.state_dict()
    assert sa["step"] == sb["step"] and sa["gen"]["count"] == sb["gen"]["count"] == 6
    # the checkpoint's generator through the Synthesizer's vocoder path
    synth = Synthesizer(vocoder_checkpoint=os.path.join(run, "checkpoint_6.pth"),
                        vocoder_config=os.path.join(run, "config.json"), device="cpu")
    mel = torch.from_numpy(np.random.RandomState(0).randn(1, 20, 16).astype(np.float32))
    with torch.no_grad():
        assert torch.equal(synth.vocoder_model.inference(mel), t2.model.module.inference(mel))


def test_train_state_and_trained_wavernn_load(tmp_path):
    """A JAX train state (``{"gen", "disc"}``) carries into the port's
    checkpoint groups; a WaveRNN trained by the port (layer norms) loads
    through the ``Synthesizer`` and generates (F58: the JAX loader builds
    folded norms whatever the file holds)."""
    jcfg, pcfg = gan_configs("hifigan")
    from tts_tpu.vocoder.models.gan import GAN as JaxGAN
    from tts_tpu_torch.vocoder.models.gan import GAN

    jm = JaxGAN(jcfg)
    g = fan_in_params(jm.generator.init, jax.random.PRNGKey(0), jnp.zeros((1, 32, 16)))
    d = fan_in_params(jm.discriminator.init, jax.random.PRNGKey(0), jnp.zeros((1, 2048, 1)))
    groups = vocoder_train_state_from_jax_params({"gen": g, "disc": d}, "hifigan_generator")
    port = GAN(pcfg)
    port.load_state_dict(groups["model"])
    port.load_discriminator_state_dict(groups["discriminator"])
    assert set(vocoder_train_state_from_jax_params({"model": g}, "hifigan_generator")) == \
        {"model"}
    _, wcfg = wavernn_configs("mold")
    model = setup_model(wcfg).init_params(seed=0, device="cpu")
    path = str(tmp_path / "wavernn.pth")
    torch.save({"model": model.module.state_dict()}, path)
    wcfg.save_json(str(tmp_path / "wavernn.json"))
    synth = Synthesizer(vocoder_checkpoint=path, vocoder_config=str(tmp_path / "wavernn.json"),
                        device="cpu")
    assert synth.vocoder_model.upsample.resnet.norm_type == "layer"
    mel = torch.from_numpy(np.random.RandomState(1).randn(1, 6, 16).astype(np.float32))
    gen = torch.Generator().manual_seed(0)
    out = synth.vocoder_model.generate(mel, gen)
    want = model.module.generate(mel, torch.Generator().manual_seed(0))
    assert torch.equal(out, want) and out.shape == (1, 2 * 8)


# --- tune_wavegrad -----------------------------------------------------------

def test_tune_wavegrad_grid_and_errors_match_jax(tmp_path, wavs):
    """Each schedule of a depth-1 grid (6 schedules of 3 steps) vocodes the
    eval batch; its mel L1 on the JAX command's draws (``PRNGKey(0)``'s
    chain) equals the JAX arithmetic's; the command prints the best."""
    jcfg, pcfg = wavegrad_configs()
    for c in (jcfg, pcfg):
        c.data_path, c.eval_split_size, c.audio.sample_rate = wavs, 4, 22050
        c.audio.fft_size = c.audio.win_length = 128
    params = generic_case("wavegrad")[2]
    jm = jax_setup_model(jcfg)
    eval_samples, _ = jax_dataset.load_wav_data(wavs, 4)
    batch = next(jax_dataset.GANDataset(jcfg, eval_samples[:4], is_eval=True).batches(
        4, shuffle=False))
    audio = jcfg.audio
    mel_kw = dict(n_fft=audio.fft_size, num_mels=audio.num_mels, sample_rate=audio.sample_rate,
                  hop_length=audio.hop_length, win_length=audio.win_length)
    ref = jt.wav_to_mel(jnp.asarray(batch["waveform"][..., 0]), **mel_kw)
    want = []
    for betas in tune_wavegrad.schedule_grid(3, 1):
        sched = tuple(jnp.asarray(a) for a in tune_wavegrad.schedule_of(betas))
        y = jax_wavegrad_inference(jm.model, params, jnp.asarray(batch["mel"]),
                                   jax.random.PRNGKey(0), sched)
        want.append(float(jnp.mean(jnp.abs(jt.wav_to_mel(y[..., 0], **mel_kw) - ref))))
    model = setup_model(pcfg)
    model.load_state_dict(vocoder_generator_from_jax_params(params, "wavegrad"))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    shape = batch["waveform"].shape

    def noise(betas):
        return torch.from_numpy(jax_wavegrad_draws(shape, len(betas), jax.random.PRNGKey(0)))

    got = tune_wavegrad.search(model.module.eval(), tb, pcfg.audio, 3, 1, noise=noise)
    assert [list(b) for b, _ in got] == [list(np.logspace(e, e, 3)) for e in range(-6, 0)]
    for (_, g), w in zip(got, want):
        assert abs(g - w) <= 1e-4 * max(abs(w), 1e-6), (g, w)
    # the command: a checkpoint and a config, the best schedule printed
    ckpt = str(tmp_path / "wavegrad.pth")
    torch.save({"model": model.module.state_dict()}, ckpt)
    pcfg.save_json(str(tmp_path / "wavegrad.json"))
    with redirect_stdout(io.StringIO()) as log:
        best = tune_wavegrad.main(["--config_path", str(tmp_path / "wavegrad.json"),
                                   "--checkpoint_path", ckpt, "--num_iter", "3",
                                   "--search_depth", "1", "--device", "cpu"])
    assert "Best schedule" in log.getvalue() and np.isfinite(best[1])
    assert len(best[0]) == 3
