"""Any generator against any discriminator: the GAN vocoders' training
wrapper (port of ``tts_tpu/vocoder/models/gan.py``; reference
``TTS/vocoder/models/gan.py:21``).

``GAN(config)`` builds the generator the config names (as the
``Synthesizer`` builds it, ``vocoder/utils.py::make_generator_from_config``)
and the discriminator, both without storage until ``init_params`` draws
them or ``load_state_dict`` fills them. The trainer's hooks:
``make_train_step``, ``make_eval_step``, ``eval_log`` (one eval mel vocoded,
its figures and audio), ``get_dataset`` (``vocoder/dataset.py``'s
``GANDataset``) and ``format_batch``.

A step, as the JAX step computes it:
- the generator vocodes the batch's mel; with ``use_pqmf`` its bands go
  through the PQMF synthesis and the real waveform through the analysis;
  both waveforms are cut to the shorter and taken in fp32;
- the discriminator runs once on the fake and once on the real waveform;
  its loss (mse and hinge as the config says, F57) and the generator's
  (``vocoder/losses.py``) come from those scores and feature maps;
- before ``steps_to_start_discriminator`` the adversarial terms are gated
  off as the JAX step gates them: the fake scores enter the generator loss
  multiplied by 0, and the total is ``G_gen_loss + on x (G_adv_loss +
  D_loss)``; the discriminator then gets zero gradients (and its
  optimizer still counts the update, as optax does), and runs without a
  graph;
- the discriminator's gradient is that of ``D_loss`` with respect to its
  parameters alone, the generator's that of ``G_gen_loss + G_adv_loss``
  with respect to its own alone (the real feature maps held constant): the
  JAX step's stop-gradients, taken in two backward passes over one forward
  where the JAX step takes one; both groups update from the parameters as
  they were (``trainer/state.py``).

ParallelWaveGAN's and UnivNet's generators take noise: the port draws it
from the step's ``torch.Generator``; the JAX step gives them no noise
stream and raises (ROADMAP.md F55). The random window discriminator gets
the mel and its window offsets from the same generator (F56). Each call of
the discriminator draws its own windows, the fake's first. With
``mixed_precision`` the networks run under bf16 autocast and the losses in
fp32 (``trainer/precision.py``).
"""

from __future__ import annotations

import functools
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from tts_tpu_torch import resolve_device
from tts_tpu_torch.trainer.optim import build_gan_optimizers
from tts_tpu_torch.trainer.precision import autocast, is_mixed_precision
from tts_tpu_torch.trainer.state import TrainState
from tts_tpu_torch.vocoder.layers import PQMF, init_weights, noise_generator
from tts_tpu_torch.vocoder.losses import GeneratorLossConfig, discriminator_loss, generator_loss
from tts_tpu_torch.vocoder.models import setup_discriminator
from tts_tpu_torch.vocoder.utils import make_generator_from_config

NOISE_GENERATORS = ("parallel_wavegan_generator", "univnet_generator")


def grads_of(loss: torch.Tensor, params: List[torch.Tensor], retain: bool) -> List[torch.Tensor]:
    """``d loss / d params``, zeros where ``loss`` does not depend on a
    parameter (or on none)."""
    if not loss.requires_grad:
        return [torch.zeros_like(p) for p in params]
    grads = torch.autograd.grad(loss, params, retain_graph=retain, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g for g, p in zip(grads, params)]


class GAN:
    """Generator ``module`` and ``discriminator`` of a GAN vocoder config,
    with the trainer's hooks."""

    def __init__(self, config):
        self.config = config
        name = config.generator_model.lower()
        self.noise_input = name in NOISE_GENERATORS
        self.windowed = config.discriminator_model.lower() == "random_window_discriminator"
        with torch.device("meta"):
            self.module = make_generator_from_config(config).eval()
            self.discriminator = setup_discriminator(config.discriminator_model)(
                **(config.discriminator_model_params or {}))
        self.use_pqmf = bool(getattr(config, "use_pqmf", False))
        self.pqmf = PQMF(N=getattr(self.module, "out_channels", 4)) if self.use_pqmf else None
        self.loss_cfg = GeneratorLossConfig(config)
        self.initialized = False
        self._eval_ap = None

    @torch.no_grad()
    def init_params(self, seed: int = 0, device="cuda", discriminator: bool = True) -> "GAN":
        """Random fp32 weights from ``seed`` (``vocoder.layers.init_weights``:
        drawn on the CPU, then moved to ``device``): the generator's, then,
        with ``discriminator``, the discriminator's from the same stream."""
        device = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        self.module = init_weights(self.module.to_empty(device="cpu"), gen).to(device)
        self.module.requires_grad_(False)
        self.initialized = True
        if discriminator:
            disc = init_weights(self.discriminator.to_empty(device="cpu"), gen)
            self.discriminator = disc.to(device).requires_grad_(False)
        return self

    def load_state_dict(self, state: Dict[str, torch.Tensor]) -> None:
        """The generator's weights as they are (strict)."""
        self.module.load_state_dict(state, strict=True, assign=True)
        self.module.requires_grad_(False)
        self.initialized = True

    def load_discriminator_state_dict(self, state: Dict[str, torch.Tensor]) -> None:
        """The discriminator's weights as they are (strict)."""
        self.discriminator.load_state_dict(state, strict=True, assign=True)
        self.discriminator.requires_grad_(False)

    # ------------------------------------------------------------------
    def generator_forward(self, c: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
        """The generator on the mel ``[B, T, M]`` as a step runs it: its
        bands, or its waveform ``[B, T', 1]`` (no PQMF); the input noise of
        ParallelWaveGAN and UnivNet drawn from ``generator`` (F55)."""
        if self.noise_input:
            return self.module(c, self.module.noise(c, generator))
        return self.module(c)

    @torch.no_grad()
    def generate(self, c: torch.Tensor, generator: Optional[torch.Generator] = None):
        """Mel ``[B, T, M]`` → waveform ``[B, T * hop, 1]`` (through the PQMF
        synthesis when ``use_pqmf``); noise, where the generator takes it,
        from ``generator`` (a generator seeded 0 on the mel's device
        without one)."""
        y_hat = self.generator_forward(c, generator or noise_generator(c.device))
        return self.pqmf.synthesis(y_hat) if self.use_pqmf else y_hat

    def _run_disc(self, x: torch.Tensor, c: torch.Tensor, generator: torch.Generator):
        """The discriminator's ``(scores, feature maps)`` as lists (port of
        ``gan.py:175-186``); the random window discriminator gets the mel
        and draws its windows from ``generator`` (F56)."""
        out = (self.discriminator(x, c, generator=generator) if self.windowed
               else self.discriminator(x))
        scores, feats = out
        if not isinstance(scores, (list, tuple)):
            scores, feats = [scores], [feats]
        return list(scores), list(feats)

    def losses(self, batch: Dict[str, torch.Tensor], generator: torch.Generator, disc_on: bool,
               mixed: bool = False) -> Tuple[torch.Tensor, torch.Tensor, Dict]:
        """One forward of both networks: ``(generator loss to differentiate,
        discriminator loss to differentiate, metrics)`` (port of the JAX
        step's ``loss_fn``, ``gan.py:80-112``). With ``disc_on`` false the
        discriminator runs without a graph and its loss is returned
        detached."""
        c, y = batch["mel"], batch["waveform"]
        device = c.device
        with autocast(device, mixed):
            y_hat = self.generator_forward(c, generator)
            y_hat_sub = y_sub = None
            if self.use_pqmf:
                y_hat_sub = y_hat
                y_hat = self.pqmf.synthesis(y_hat_sub)
                y_sub = self.pqmf.analysis(y)
        T = min(y_hat.shape[1], y.shape[1])
        y_hat_c, y_c = y_hat[:, :T].float(), y[:, :T].float()
        with autocast(device, mixed), torch.set_grad_enabled(disc_on and torch.is_grad_enabled()):
            scores_fake, feats_fake = self._run_disc(y_hat_c if disc_on else y_hat_c.detach(),
                                                     c, generator)
            scores_real, feats_real = self._run_disc(y_c, c, generator)
        cfg = self.loss_cfg
        d_losses = discriminator_loss(scores_fake, scores_real, use_mse=cfg.use_mse_gan_loss,
                                      use_hinge=cfg.use_hinge_gan_loss)
        on = 1.0 if disc_on else 0.0
        g_losses = generator_loss(
            cfg, y_hat=y_hat_c, y=y_c, scores_fake=[s.float() * on for s in scores_fake],
            feats_fake=feats_fake, feats_real=feats_real,
            y_hat_sub=None if y_hat_sub is None else y_hat_sub.float(),
            y_sub=None if y_sub is None else y_sub.float())
        total = g_losses["G_gen_loss"] + on * (g_losses["G_adv_loss"] + d_losses["D_loss"])
        metrics = {**g_losses, **d_losses, "loss": total}
        gen_loss = g_losses["G_gen_loss"] + (g_losses["G_adv_loss"] if disc_on else 0.0)
        return gen_loss, d_losses["D_loss"], metrics

    # ------------------------------------------------------------------
    def make_train_step(self, config, generator: torch.Generator, device="cuda"):
        """The training hook (port of ``gan.py:57-121``): ``(train_step,
        optimizers, state)`` on ``device`` (CUDA unless the caller asks for
        the CPU). ``train_step(state, batch)`` draws from ``generator``,
        which must live on ``device``; a discriminator not drawn yet is drawn
        from seed 0."""
        device = resolve_device(device)
        if generator.device.type != device.type:
            raise ValueError(f"the step's generator is on {generator.device}, the model on "
                             f"{device}")
        if any(p.is_meta for p in self.discriminator.parameters()):
            self.discriminator = init_weights(self.discriminator.to_empty(device="cpu"),
                                              torch.Generator().manual_seed(0))
        self.module.to(device).requires_grad_(True)
        self.discriminator.to(device).requires_grad_(True)
        optimizers = build_gan_optimizers(config)
        state = TrainState.create({"gen": list(self.module.parameters()),
                                   "disc": list(self.discriminator.parameters())}, optimizers)
        d_start = int(getattr(config, "steps_to_start_discriminator", 0) or 0)
        mixed = is_mixed_precision(config)

        def train_step(state: TrainState, batch, generator: torch.Generator):
            disc_on = state.step >= d_start
            gen_loss, d_loss, metrics = self.losses(batch, generator, disc_on, mixed)
            if disc_on:
                disc_grads = grads_of(d_loss, state.params["disc"], retain=True)
            else:
                disc_grads = [torch.zeros_like(p) for p in state.params["disc"]]
            gen_grads = grads_of(gen_loss, state.params["gen"], retain=False)
            state = state.apply_updates({"gen": gen_grads, "disc": disc_grads})
            return state, {k: v.detach() for k, v in metrics.items()}

        self._eval_step_fn = self.make_eval_step(config)
        return functools.partial(train_step, generator=generator), optimizers, state

    def make_eval_step(self, config):
        """The deterministic evaluation without gradient (port of
        ``gan.py:123-137``): the losses with the discriminator on, noise and
        windows from a generator seeded 0 on the batch's device."""
        mixed = is_mixed_precision(config)

        @torch.no_grad()
        def eval_step(state: TrainState, batch) -> Dict:
            generator = torch.Generator(device=batch["mel"].device).manual_seed(0)
            return self.losses(batch, generator, True, mixed)[2]

        return eval_step

    def eval_log(self, batch, state) -> Tuple[Dict, Dict]:
        """After an evaluation: the first eval mel vocoded; its figures
        (``utils.visual.plot_results``, where matplotlib is installed) and its
        audio for the dashboard (port of ``gan.py:139-157``)."""
        from tts_tpu_torch.audio.processor import AudioProcessor
        from tts_tpu_torch.utils.visual import matplotlib_available, plot_results

        if self._eval_ap is None:
            self._eval_ap = AudioProcessor.init_from_config(self.config.audio, verbose=False)
        y_hat = self.generate(batch["mel"][:1]).float().cpu().numpy()
        y = batch["waveform"][:1].float().cpu().numpy()
        figures = plot_results(y_hat, y, self._eval_ap) if matplotlib_available() else {}
        return figures, {"audio": y_hat[0].squeeze()}

    def get_dataset(self, config, samples, is_eval: bool = False):
        from tts_tpu_torch.vocoder.dataset import GANDataset

        return GANDataset(config, samples, is_eval=is_eval)

    def format_batch(self, batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        return batch
