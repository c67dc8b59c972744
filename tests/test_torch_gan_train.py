"""The port's GAN vocoder step (``tts_tpu_torch.vocoder.models.gan``)
against the JAX package's (``tts_tpu.vocoder.models.gan``) on the CPU:
HiFiGAN (MPD and MSD, the mel L1, feature matching, mse), MelGAN (the
multi-scale MelGAN discriminator, the STFT loss) and multi-band MelGAN
(PQMF synthesis and analysis, the sub-band STFT loss, the discriminator
gate off for two steps, then on), each at the tiny widths of
``tests/torch_vocoder_cases.py`` with the configs' AdamW (betas (0.8,
0.99)), ExponentialLR and clip 5.

The JAX parameters are drawn at unit gain and carried strictly
(``flax_to_state_dict``, ``vocoder_discriminator_from_jax_params``); the
JAX step is jitted once a family (LLVM's cheap options). Per step: every
loss within 1e-5 of its value; the gradients of both groups within 1e-4 of
each tensor's peak (the JAX gradients are ``jax.grad`` of the step's own
loss function, at the step's parameters; the discriminator's are exactly
0 while the gate is off), the generator's under an STFT loss (MelGAN,
multi-band MelGAN) within 8e-3 (``STFT_GRAD_TOL``): the log-magnitude
term's gradient divides by each bin's magnitude, so fp32 rounding of the
small bins grows. A float64 evaluation of the port's step puts each
package's fp32 generator gradients of the first step up to 1.1e-3 (the
port's) and 6.4e-4 (the JAX step's) of the peak from the exact ones
(held within 2.5e-3), against 2.5e-6 for HiFiGAN's mel L1 (held within
1e-5; ``test_generator_gradients_against_float64``); the two packages'
differ by up to 3.7e-3 over the three steps (multi-band MelGAN's second,
with the JAX package's test settings); the parameters
after each of three steps within 1e-6 when the port's optimizer applies
the JAX gradients (teacher-forced), within 3 x 1.5 lr on the port's own
gradients (Adam turns gradient rounding into moves of up to ~1.5 lr,
``tests/test_torch_vits_train_step.py``).

Named divergences (ROADMAP.md §3):
- F55: the JAX GAN gives the generator no noise stream, so
  ParallelWaveGAN and UnivNet raise there; the port draws their noise from
  the step's generator and trains them (their forward with the noise given
  is held against JAX in ``tests/test_torch_vocoders.py``, their
  discriminators in ``tests/test_torch_vocoder_discriminators.py``, the
  losses in ``tests/test_torch_vocoder_losses.py``);
- F56: the JAX step gives the random window discriminator neither its
  ``windows`` stream nor the mel, so it raises; the port's step runs its
  conditional half too;
- F57: the JAX discriminator loss ignores ``use_hinge_gan_loss`` /
  ``use_mse_gan_loss``; the port reads them. Every config of the repo has
  mse on and hinge off, where both agree.
"""

import torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import contextlib
import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_vocoder_cases import AUDIO, SEQ_LEN, fan_in_params, gan_configs, waveform_batch

from tts_tpu.trainer.state import TrainState as JaxTrainState
from tts_tpu.vocoder import configs as jax_configs
from tts_tpu.vocoder.models import gan as jax_gan_mod
from tts_tpu.vocoder.models.gan import GAN as JaxGAN
from tts_tpu_torch.utils.convert import flax_to_state_dict, vocoder_discriminator_from_jax_params
from tts_tpu_torch.vocoder import configs as port_configs
from tts_tpu_torch.vocoder.models.gan import GAN

LOSS_TOL = 1e-5
GRAD_TOL = 1e-4  # of each tensor's peak
STFT_GRAD_TOL = 8e-3  # the generators under an STFT loss (see the docstring)
F64_TOL = {"hifigan": 1e-5, "melgan": 2.5e-3, "multiband_melgan": 2.5e-3}  # each package
PARAM_TOL = 1e-6  # teacher-forced
STEPS = 3
COMPILE_OPTIONS = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


def jax_pair(family, **over):
    """The JAX ``GAN`` with drawn params and the port's carrying them."""
    jcfg, pcfg = gan_configs(family, **over)
    jm = JaxGAN(jcfg)
    frames = SEQ_LEN // AUDIO["hop_length"]
    c = np.zeros((1, frames, AUDIO["num_mels"]), np.float32)
    wav = np.zeros((1, SEQ_LEN, 1), np.float32)
    g = fan_in_params(jm.generator.init, jax.random.PRNGKey(0), c, seed=1)
    d = fan_in_params(jm.discriminator.init, jax.random.PRNGKey(1), wav, seed=2)
    jm.init_params = lambda rng: (g, d)  # the drawn params, not flax's init
    port = GAN(pcfg)
    port.load_state_dict(flax_to_state_dict(g))
    port.load_discriminator_state_dict(vocoder_discriminator_from_jax_params(d))
    return jm, jcfg, port, pcfg


def jax_run(jm, jcfg, batch, n):
    """``n`` jitted JAX steps: per step its metrics, the gradients at the
    step's parameters (port names) and the parameters after it."""
    step, _, state = jm.make_train_step(jcfg, jax.random.PRNGKey(0))
    b = {k: jnp.asarray(v) for k, v in batch.items()}
    step = jax.jit(step).lower(state, b, jax.random.PRNGKey(0)).compile(
        compiler_options=COMPILE_OPTIONS)
    loss_fn = jm._eval_loss_fn
    grad = jax.jit(jax.grad(lambda g, d, on: loss_fn(g, d, b, on)[0], argnums=(0, 1)))
    d_start = getattr(jcfg, "steps_to_start_discriminator", 0)
    out = []
    for i in range(n):
        on = jnp.float32(1.0 if i >= d_start else 0.0)
        gg, dg = grad(state.params["gen"], state.params["disc"], on)
        state, metrics = step(state, b, jax.random.PRNGKey(0))
        out.append(dict(
            metrics={k: float(v) for k, v in metrics.items()},
            grads={"gen": flax_to_state_dict(gg),
                   "disc": vocoder_discriminator_from_jax_params(dg)},
            params={"gen": flax_to_state_dict(state.params["gen"]),
                    "disc": vocoder_discriminator_from_jax_params(state.params["disc"])}))
    return out


def port_run(port, pcfg, batch, jax_steps, teacher_forced: bool):
    """The port's steps; with ``teacher_forced`` each update applies the JAX
    gradients. Per step: gradients and parameters by name, metrics."""
    step, _, state = port.make_train_step(pcfg, torch.Generator(), device="cpu")
    names = {"gen": [n for n, _ in port.module.named_parameters()],
             "disc": [n for n, _ in port.discriminator.named_parameters()]}
    apply = state.apply_updates
    out = []

    def capture(grads):
        out[-1]["grads"] = {k: dict(zip(names[k], (g.clone() for g in grads[k]))) for k in grads}
        if teacher_forced:
            ref = jax_steps[len(out) - 1]["grads"]
            grads = {k: [ref[k][n] for n in names[k]] for k in grads}
        return apply(grads)

    state.apply_updates = capture
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    for _ in jax_steps:
        out.append({})
        state, metrics = step(state, tb)
        out[-1]["metrics"] = {k: float(v) for k, v in metrics.items()}
        out[-1]["params"] = {k: dict(zip(names[k], (p.detach().clone() for p in state.params[k])))
                             for k in ("gen", "disc")}
    return out


def check_step(got, want, grads: bool, gen_tol: float = GRAD_TOL):
    assert set(got["metrics"]) == set(want["metrics"])
    for k, w in want["metrics"].items():
        assert abs(got["metrics"][k] - w) <= LOSS_TOL * max(abs(w), 1e-6), (k, got["metrics"][k], w)
    if not grads:
        return
    for group in ("gen", "disc"):
        assert set(got["grads"][group]) == set(want["grads"][group])
        for name, w in want["grads"][group].items():
            g = got["grads"][group][name]
            peak = float(w.abs().max())
            if peak == 0.0:
                assert float(g.abs().max()) == 0.0, (group, name)
                continue
            err = float((g - w).abs().max())
            tol = gen_tol if group == "gen" else GRAD_TOL
            assert err <= tol * peak, (group, name, err, peak)


@functools.lru_cache(maxsize=None)
def run(family):
    jm, jcfg, port, pcfg = jax_pair(family)
    batch = waveform_batch()
    return port, pcfg, batch, jax_run(jm, jcfg, batch, STEPS)


@pytest.mark.parametrize("family", ["hifigan", "melgan", "multiband_melgan"])
def test_three_steps_teacher_forced(family):
    """Every step's losses and gradients; the parameters after each step
    within 1e-6 when the port applies the JAX gradients. Multi-band MelGAN
    starts its discriminator at step 2: its discriminator gradients are 0
    before, and its generator's mse term is the JAX gate's constant 1."""
    port, pcfg, batch, want = run(family)
    got = port_run(copy.deepcopy(port), pcfg, batch, want, teacher_forced=True)
    gen_tol = STFT_GRAD_TOL if pcfg.use_stft_loss else GRAD_TOL
    for i, (g, w) in enumerate(zip(got, want)):
        check_step(g, w, grads=True, gen_tol=gen_tol)
        for group in ("gen", "disc"):
            for name, p in w["params"][group].items():
                err = float((g["params"][group][name] - p).abs().max())
                assert err <= PARAM_TOL, (i, group, name, err)
    if family == "multiband_melgan":
        assert got[0]["metrics"]["G_mse_fake_loss"] == 1.0
        assert all(float(t.abs().max()) == 0 for t in got[1]["grads"]["disc"].values())
        assert max(float(t.abs().max()) for t in got[2]["grads"]["disc"].values()) > 0


@pytest.mark.parametrize("family", ["hifigan", "melgan", "multiband_melgan"])
def test_three_steps_free_running(family):
    """The port on its own gradients: the parameters after three steps within
    3 x 1.5 lr of the JAX step's; the generator moved."""
    port, pcfg, batch, want = run(family)
    got = port_run(copy.deepcopy(port), pcfg, batch, want, teacher_forced=False)
    for g, w in zip(got, want):
        check_step(g, w, grads=False)
    for group, lr in (("gen", pcfg.lr_gen), ("disc", pcfg.lr_disc)):
        for name, p in want[-1]["params"][group].items():
            err = float((got[-1]["params"][group][name] - p).abs().max())
            assert err <= STEPS * 1.5 * lr, (group, name, err)
    start = dict(port.module.named_parameters())
    assert max(float((got[-1]["params"]["gen"][n] - start[n]).abs().max()) for n in start) > \
        0.5 * pcfg.lr_gen


@contextlib.contextmanager
def float_means_double():
    """``Tensor.float()`` gives float64: the port's step, whose loss islands
    cast to fp32, runs wholly in float64 on float64 modules and batch."""
    orig = torch.Tensor.float
    torch.Tensor.float = lambda self: self.double()
    try:
        yield
    finally:
        torch.Tensor.float = orig


@pytest.mark.parametrize("family", ["hifigan", "melgan", "multiband_melgan"])
def test_generator_gradients_against_float64(family):
    """The first step's generator gradients of each package against a
    float64 evaluation of the port's step: within 1e-5 of each tensor's
    peak for HiFiGAN, 1.5e-3 under an STFT loss (the ground of
    ``STFT_GRAD_TOL``)."""
    port, pcfg, batch, want = run(family)
    got = port_run(copy.deepcopy(port), pcfg, batch, want[:1], teacher_forced=True)
    p = copy.deepcopy(port)
    p.module.double().requires_grad_(True)
    p.discriminator.double().requires_grad_(True)
    if p.pqmf is not None:
        p.pqmf.H, p.pqmf.G = p.pqmf.H.double(), p.pqmf.G.double()
    tb = {k: torch.from_numpy(v).double() for k, v in batch.items()}
    with float_means_double():
        gen_loss, _, _ = p.losses(tb, torch.Generator(), pcfg.steps_to_start_discriminator == 0)
        exact = torch.autograd.grad(gen_loss, list(p.module.parameters()))
    for (name, _), g64 in zip(p.module.named_parameters(), exact):
        peak = float(g64.abs().max())
        for who, g in (("port", got[0]["grads"]["gen"][name]),
                       ("jax", want[0]["grads"]["gen"][name])):
            err = float((g.double() - g64).abs().max())
            assert err <= F64_TOL[family] * peak, (who, name, err, peak)


def test_eval_step_matches_the_jax_eval_step():
    """``make_eval_step``: the losses without gradient, the discriminator on,
    as the JAX eval step gives them."""
    jm, jcfg, port, pcfg = jax_pair("hifigan")
    batch = waveform_batch(seed=4)
    jm.make_train_step(jcfg, jax.random.PRNGKey(0))
    g, d = jm.init_params(None)
    state = JaxTrainState.create({"gen": g, "disc": d}, {})
    want = jax.jit(jm.make_eval_step(jcfg))(state, {k: jnp.asarray(v) for k, v in batch.items()})
    port.make_train_step(pcfg, torch.Generator(), device="cpu")
    got = port.make_eval_step(pcfg)(None, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert set(got) == set(want)
    for k in want:
        assert abs(float(got[k]) - float(want[k])) <= LOSS_TOL * max(abs(float(want[k])), 1e-6), k


# --- F55, F56, F57 -------------------------------------------------------

NOISE_CASES = {
    "parallel_wavegan": ("ParallelWaveganConfig",
                         dict(upsample_factors=[8, 8], stacks=2, num_res_blocks=4,
                              res_channels=8, gate_channels=16, skip_channels=8),
                         dict(num_layers=4, conv_channels=8)),
    "univnet": ("UnivnetConfig", dict(hidden_channels=8, in_channels=8, upsample_factors=[8, 8],
                                      lvc_layers_each_block=2, kpnet_hidden_channels=8), None),
}


def noise_configs(family):
    name, gen, disc = NOISE_CASES[family]
    out = []
    for mod in (jax_configs, port_configs):
        kw = dict(seq_len=SEQ_LEN, pad_short=0, generator_model_params=dict(gen), batch_size=2,
                  stft_loss_params={"n_ffts": [256, 128], "hop_lengths": [64, 32],
                                    "win_lengths": [256, 128]})
        if disc is not None:
            kw["discriminator_model_params"] = dict(disc)
        config = getattr(mod, name)(**kw)
        for k, v in AUDIO.items():
            setattr(config.audio, k, v)
        out.append(config)
    return out


@pytest.mark.parametrize("family", ["parallel_wavegan", "univnet"])
def test_f55_noise_generators_train_in_the_port(family):
    """F55: the JAX GAN step cannot run these generators (no ``noise``
    stream); the port's step draws their noise from the step's generator:
    a step is the same on the same seed, its draw is the generator's, and
    the weights move."""
    jcfg, pcfg = noise_configs(family)
    if family == "univnet":
        # the univnet discriminator is full width: a 1/8 slice of its batch is enough here
        pcfg.discriminator_model = jcfg.discriminator_model = "parallel_wavegan_discriminator"
        pcfg.discriminator_model_params = jcfg.discriminator_model_params = dict(
            num_layers=4, conv_channels=8)
    jstep, _, jstate = JaxGAN(jcfg).make_train_step(jcfg, jax.random.PRNGKey(0))
    with pytest.raises(Exception, match="noise"):
        jstep(jstate, {k: jnp.asarray(v) for k, v in waveform_batch().items()},
              jax.random.PRNGKey(0))
    batch = {k: torch.from_numpy(v) for k, v in waveform_batch().items()}
    results = []
    for _ in range(2):
        model = GAN(copy.deepcopy(pcfg)).init_params(seed=0, device="cpu")
        before = {n: p.clone() for n, p in model.module.named_parameters()}
        gen = torch.Generator()
        step, _, state = model.make_train_step(pcfg, gen, device="cpu")
        gen.manual_seed(7)
        state, metrics = step(state, batch)
        results.append(({k: float(v) for k, v in metrics.items()},
                        {n: p.detach().clone() for n, p in model.module.named_parameters()}))
        assert all(np.isfinite(v) for v in results[-1][0].values())
        assert max(float((results[-1][1][n] - before[n]).abs().max()) for n in before) > 0
    assert results[0][0] == results[1][0]
    # the step's waveform is the generator on noise drawn from the step's generator
    c = batch["mel"]
    with torch.no_grad():
        a = model.generator_forward(c, torch.Generator().manual_seed(3))
        noise = model.module.noise(c, torch.Generator().manual_seed(3))
        assert torch.equal(a, model.module(c, noise))


def test_f56_random_window_discriminator_trains_with_the_mel():
    """F56: the JAX step's ``_run_disc`` gives the random window
    discriminator no ``windows`` stream (it raises); the port's passes the
    mel and the step's generator: ten scores (five conditional), and a step
    updates both groups."""
    over = dict(discriminator_model="random_window_discriminator",
                discriminator_model_params=dict(
                    cond_channels=AUDIO["num_mels"], hop_length=AUDIO["hop_length"],
                    window_sizes=(128, 256, 512, 1024, 2048),
                    uncond_disc_out_channels=(8, 16),
                    cond_disc_downsample_factors=((4, 2, 2, 2, 2), (4, 2, 2, 2), (4, 2, 2),
                                                  (4, 2), (2, 1, 2)),
                    cond_disc_out_channels=((8, 8, 16, 16), (8, 16, 16), (8, 16), (16,),
                                            (8, 16))))
    jcfg, pcfg = gan_configs("hifigan", **over)
    jm = JaxGAN(jcfg)
    wav = jnp.zeros((1, SEQ_LEN, 1))
    d = fan_in_params(jm.discriminator.init, jax.random.PRNGKey(0), wav,
                      jnp.zeros((1, SEQ_LEN // 64, AUDIO["num_mels"])), rng=jax.random.PRNGKey(1))
    with pytest.raises(Exception, match="windows"):
        jax_gan_mod._run_disc(jm.discriminator, d, wav)
    model = GAN(pcfg).init_params(seed=0, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in waveform_batch().items()}
    with torch.no_grad():
        scores, feats = model._run_disc(batch["waveform"], batch["mel"],
                                        torch.Generator().manual_seed(0))
    assert len(scores) == 10 and feats == [] and all(s.shape == (2, 1) for s in scores)
    disc0 = {n: p.clone() for n, p in model.discriminator.named_parameters()}
    gen = torch.Generator()
    step, _, state = model.make_train_step(pcfg, gen, device="cpu")
    gen.manual_seed(1)
    state, metrics = step(state, batch)
    assert np.isfinite(float(metrics["loss"])) and float(metrics["D_loss"]) > 0
    moved = [n for n, p in model.discriminator.named_parameters()
             if not torch.equal(p, disc0[n])]
    assert any(n.startswith("cond_") for n in moved) and any(n.startswith("uncond_") for n in moved)


def test_f57_discriminator_loss_reads_the_config():
    """F57: with ``use_hinge_gan_loss`` on, the port's discriminator loss
    adds the hinge (the reference's ``DiscriminatorLoss``), the JAX step's
    does not; every GAN config of the repo keeps mse on and hinge off, where
    the two agree (the teacher-forced tests hold them equal)."""
    for name in ("HifiganConfig", "MelganConfig", "MultibandMelganConfig",
                 "FullbandMelganConfig", "ParallelWaveganConfig", "UnivnetConfig", "GANConfig"):
        for mod in (jax_configs, port_configs):
            cfg = getattr(mod, name)()
            assert cfg.use_mse_gan_loss and not cfg.use_hinge_gan_loss, name
    jm, jcfg, port, pcfg = jax_pair("hifigan", use_hinge_gan_loss=True, hinge_G_loss_weight=0.5)
    batch = waveform_batch(seed=2)
    jm.make_train_step(jcfg, jax.random.PRNGKey(0))
    g, d = jm.init_params(None)
    _, want = jax.jit(jm._eval_loss_fn)(g, d, {k: jnp.asarray(v) for k, v in batch.items()},
                                        jnp.float32(1.0))
    port.make_train_step(pcfg, torch.Generator(), device="cpu")
    got = port.make_eval_step(pcfg)(None, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert "D_hinge_gan_loss" in got and "D_hinge_gan_loss" not in want
    assert abs(float(got["D_mse_gan_loss"]) - float(want["D_mse_gan_loss"])) <= \
        LOSS_TOL * float(want["D_mse_gan_loss"])
    assert float(got["D_loss"]) == pytest.approx(
        float(got["D_mse_gan_loss"]) + float(got["D_hinge_gan_loss"]), rel=1e-6)
    assert float(want["D_loss"]) == pytest.approx(float(want["D_mse_gan_loss"]), rel=1e-6)
    assert float(got["G_hinge_fake_loss"]) == pytest.approx(float(want["G_hinge_fake_loss"]),
                                                            rel=LOSS_TOL)
