"""VITS training step, the GAN update (port of
``tts_tpu/models/vits/train.py``; reference ``vits.py:1230-1340``).

One call takes a batch, runs the generator's training forward
(``VitsModule.forward``: posterior, flow, MAS through K2, duration loss, a
random segment decoded), cuts the matching real waveform segment, runs the
discriminator once on the fake and real segments stacked, and takes both
groups' gradients from that one graph:

- the discriminator's, of ``disc_loss_alpha * loss_disc`` with respect to
  its parameters only: the fake segment enters as a constant, as the JAX
  step's ``stop_gradient(wav_fake)`` makes it;
- the generator's, of the generator losses (mel L1, KL, feature matching,
  adversarial, duration) with respect to its parameters only: the
  discriminator's parameters act as constants, as the JAX step's frozen
  copy does, and its real features are detached.

So each gradient equals the JAX step's; the port takes them in two
backward passes over one forward where the JAX step takes one. Both groups
then update from the parameters as they were before the step (``trainer/
state.py``), as in the JAX step and not D then G as in the reference. The
mel loss goes through ``audio/torch_transforms.py::wav_to_mel`` in fp32.

Every draw of a step comes from the step's ``torch.Generator``: the
posterior's and the duration posterior's noise (``modules.normal``), the
segment starts (``ops.helpers.uniform``) and the dropout masks
(``layers.common.Dropout``). The module is in training mode only inside a
step. The batch's ``speaker_ids``, ``d_vectors`` and ``language_ids``
condition the training forward (``VitsModule.forward``), as the JAX step's
``aux_input`` does. ``mixed_precision`` runs the forward under bf16 autocast with fp32
master weights (``trainer/precision.py``). The YourTTS speaker-consistency
loss (``use_speaker_encoder_as_loss``) raises: it waits for its own slice
(ROADMAP.md item 17a's queue).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from tts_tpu_torch.audio.torch_transforms import wav_to_mel
from tts_tpu_torch.layers.common import use_dropout_generator
from tts_tpu_torch.ops.helpers import segment
from tts_tpu_torch.trainer.optim import build_gan_optimizers
from tts_tpu_torch.trainer.precision import autocast, is_mixed_precision
from tts_tpu_torch.trainer.state import TrainState

from .model import (
    Vits,
    discriminator_adv_loss,
    feature_loss,
    generator_adv_loss,
    kl_loss,
)

SPEAKER_LOSS_REASON = (
    "use_speaker_encoder_as_loss (the YourTTS speaker-consistency loss) is not ported yet: "
    "the JAX step resizes with jax.image.resize, which antialiases when it downsamples, and "
    "needs parity work of its own (ROADMAP.md item 17a's queue)")


def aux_input(batch) -> Dict:
    """The batch's conditioning, as the JAX step passes it
    (``tts_tpu/models/vits/train.py:126-128``): ``d_vectors``,
    ``speaker_ids`` and ``language_ids``, each ``None`` where absent."""
    return {k: batch.get(k) for k in ("d_vectors", "speaker_ids", "language_ids")}


def make_optimizers(config) -> Dict:
    """The ``gen`` and ``disc`` optimizers of ``config`` (port of
    ``tts_tpu/models/vits/train.py:35-47``; ``trainer.optim.build_gan_optimizers``)."""
    return build_gan_optimizers(config)


def param_names(model: Vits) -> Dict[str, List[str]]:
    """The names of each group's parameters, in the state's order."""
    return {"gen": [n for n, _ in model.module.named_parameters()],
            "disc": [n for n, _ in model.discriminator.named_parameters()]}


def create_train_state(model: Vits, config) -> TrainState:
    """The model's current weights as the ``gen`` and ``disc`` groups, with
    fresh optimizer states; gradients turned on for both (port of
    ``tts_tpu/models/vits/train.py:217-220``)."""
    model.module.requires_grad_(True)
    model.discriminator.requires_grad_(True)
    params = {"gen": list(model.module.parameters()),
              "disc": list(model.discriminator.parameters())}
    return TrainState.create(params, make_optimizers(config))


def make_train_step(model: Vits, config):
    """``(train_step, eval_step, optimizers)``. ``train_step(state, batch,
    generator) -> (state, metrics)`` updates both groups in place;
    ``eval_step(state, batch) -> metrics`` evaluates the losses without
    gradient on draws from a generator seeded 0. ``batch``: ``text_input
    [B, T_x]`` and ``text_lengths [B]``, the linear spectrogram ``spec [B,
    T_y, C]`` and ``spec_lengths [B]``, ``waveform [B, T_y * hop, 1]`` and,
    for a multi-speaker or multi-language model, ``speaker_ids [B]`` or
    ``d_vectors [B, C]`` and ``language_ids [B]``, on the model's device."""
    if getattr(model.args, "use_speaker_encoder_as_loss", False):
        raise NotImplementedError(SPEAKER_LOSS_REASON)
    audio = config.audio
    seg_frames = model.args.spec_segment_size
    # encoder_sample_rate: a latent frame spans hop * factor output samples
    hop = audio.hop_length * int(round(model.module.interpolate_factor))
    mel_kw = dict(n_fft=audio.fft_size, num_mels=audio.num_mels,
                  sample_rate=audio.sample_rate, hop_length=audio.hop_length,
                  win_length=audio.win_length, fmin=audio.mel_fmin, fmax=audio.mel_fmax)
    optimizers = make_optimizers(config)
    mixed = is_mixed_precision(config)

    def losses(batch, generator) -> Tuple[torch.Tensor, torch.Tensor, Dict]:
        device = batch["text_input"].device
        with autocast(device, mixed):
            out = model.module(batch["text_input"], batch["text_lengths"], batch["spec"],
                               batch["spec_lengths"], generator, aux_input=aux_input(batch))
            wav_fake = out["model_outputs"]  # [B, seg * hop, 1]
            wav_real = segment(batch["waveform"], out["slice_ids"] * hop, seg_frames * hop,
                               pad_short=True)
            scores_fake, feats_fake, scores_real, feats_real = model.discriminator(
                wav_fake, wav_real)
        # the losses in fp32 (the reference's AMP keeps them there, vits.py:1273)
        f32 = lambda ts: [t.float() for t in ts]  # noqa: E731
        scores_fake, scores_real = f32(scores_fake), f32(scores_real)
        feats_fake, feats_real = [f32(f) for f in feats_fake], [f32(f) for f in feats_real]
        loss_disc, _, _ = discriminator_adv_loss(scores_real, scores_fake)
        with autocast(device, False):
            mel_fake = wav_to_mel(wav_fake[..., 0].float(), **mel_kw)
            mel_real = wav_to_mel(wav_real[..., 0].float(), **mel_kw)
        loss_mel = torch.mean(torch.abs(mel_fake - mel_real)) * config.mel_loss_alpha
        loss_kl = kl_loss(out["z_p"].float(), out["logs_q"].float(), out["m_p"].float(),
                          out["logs_p"].float(), out["y_mask"]) * config.kl_loss_alpha
        loss_feat = feature_loss(feats_real, feats_fake) * config.feat_loss_alpha
        loss_gen = generator_adv_loss(scores_fake) * config.gen_loss_alpha
        loss_dur = out["loss_duration"].float() * config.dur_loss_alpha
        loss_gen_total = loss_mel + loss_kl + loss_feat + loss_gen + loss_dur
        total = loss_gen_total + loss_disc * config.disc_loss_alpha
        metrics = {
            "loss": total, "loss_gen_total": loss_gen_total, "loss_disc": loss_disc,
            "loss_mel": loss_mel, "loss_kl": loss_kl, "loss_feat": loss_feat,
            "loss_gen": loss_gen, "loss_duration": loss_dur,
        }
        return loss_gen_total, loss_disc * config.disc_loss_alpha, metrics

    def _grads(loss, params, retain: bool) -> List[torch.Tensor]:
        grads = torch.autograd.grad(loss, params, retain_graph=retain, allow_unused=True)
        return [torch.zeros_like(p) if g is None else g for g, p in zip(grads, params)]

    def train_step(state: TrainState, batch, generator: torch.Generator):
        model.module.train()
        use_dropout_generator(model.module, generator)
        try:
            loss_gen_total, loss_disc, metrics = losses(batch, generator)
            disc_grads = _grads(loss_disc, state.params["disc"], retain=True)
            gen_grads = _grads(loss_gen_total, state.params["gen"], retain=False)
        finally:
            use_dropout_generator(model.module, None)
            model.module.eval()
        state = state.apply_updates({"gen": gen_grads, "disc": disc_grads})
        return state, {k: v.detach() for k, v in metrics.items()}

    @torch.no_grad()
    def eval_step(state: TrainState, batch) -> Dict:
        """Fixed draws (a generator seeded 0 on the batch's device), dropout
        as in a step (the JAX eval step runs the training forward)."""
        generator = torch.Generator(device=batch["text_input"].device).manual_seed(0)
        model.module.train()
        use_dropout_generator(model.module, generator)
        try:
            return losses(batch, generator)[2]
        finally:
            use_dropout_generator(model.module, None)
            model.module.eval()

    return train_step, eval_step, optimizers
