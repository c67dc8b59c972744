"""The port's VITS training with speakers and languages against the JAX
package's step, on the CPU: the training forward's conditioning
(``VitsModule.forward`` with ``aux_input``), the losses, both groups'
gradients and the parameters after one AdamW step, with speaker ids, with
d-vectors, and with speaker ids plus language ids.

Configuration, draws and tolerances are those of
``tests/test_torch_vits_train_step.py`` (dropout 0; the JAX step's draws
and gradients recorded inside its jit and replayed by shape; losses within
1e-5, the duration NLL within 5e-5; gradients within 1e-4 of each tensor's
peak, the stochastic duration predictor's within 3e-4; parameters within
1e-6 when the port's optimizer applies the JAX gradients), whose helpers
this file uses.

One gradient is held otherwise: with languages, ``emb_l`` takes most of
its gradient through the stochastic duration predictor's NLL (its
``cond_lang``), whose fp32 rounding reaches ~1e-4 of that predictor's
peaks (``tests/test_torch_vits_train_step.py``); summed over the batch's
tokens into a 2 x 4 table, it cancels further. Measured against a float64
run of the port's step on the same draws, the port's fp32 gradient lies
3.3e-4 of the peak away and the JAX step's 1.2e-4, so the two differ by
4.5e-4. Each is held within ``EMB_L_TOL`` (5e-4) of the float64 gradient.

Two named divergences are held here:
- F26: the port L2-normalises d-vectors, the JAX package feeds them as
  they are; the d-vectors of these batches have unit length, where both
  agree.
- F12 with a language: the JAX package sizes the duration predictor's input
  layer from its training forward (the prior means, ``hidden_channels``
  wide); the port sizes it for the text encoder's output, which the
  language widens, and feeds the means zero-padded. The JAX tensors are
  carried across zero-padded (``widened``); the padded part's gradient is
  zero in both, so it stays zero.
"""

import torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import copy

import jax
import numpy as np
import pytest
import torch
from helpers import fast_params
from test_torch_vits_model import WEIGHT_SCALE
from test_torch_vits_train import train_batch, train_configs
from test_torch_vits_train_step import (
    PARAM_TOL,
    check_grads,
    check_losses,
    jax_steps,
    port_steps,
)

from tts_tpu.models.vits import Vits as JaxVits
from tts_tpu_torch.models.vits import Vits
from tts_tpu_torch.models.vits import train as port_train
from tts_tpu_torch.utils.convert import vits_discriminator_from_jax_params, vits_from_jax_params

EMB_L_TOL = 5e-4  # emb_l with languages: each package's fp32 against float64 (see above)

CASES = {
    "speaker_ids": (True, dict(use_speaker_embedding=True, num_speakers=3,
                               speaker_embedding_channels=8)),
    "d_vectors_dp": (False, dict(use_d_vector_file=True, d_vector_dim=8)),
    "speakers_languages": (True, dict(use_speaker_embedding=True, num_speakers=3,
                                      speaker_embedding_channels=8,
                                      use_language_embedding=True, num_languages=2,
                                      embedded_language_dim=4)),
}


def widened(src, like):
    """JAX tensors carried into the port's shapes: equal shapes as they
    are; a smaller JAX tensor (the duration predictor's layers sized from
    the prior means, F12) zero-padded at the end of each dimension."""
    out = {}
    for k, target in like.items():
        v = src[k]
        if tuple(v.shape) != tuple(target.shape):
            assert all(a <= b for a, b in zip(v.shape, target.shape)), (k, v.shape, target.shape)
            assert k.startswith("duration_predictor."), k
            pad = torch.zeros(target.shape, dtype=v.dtype)
            pad[tuple(slice(0, n) for n in v.shape)] = v
            v = pad
        out[k] = v
    assert set(out) == set(src)
    return out


def speaker_batch(case, seed=0):
    batch = train_batch(seed)
    B = batch["text_input"].shape[0]
    rs = np.random.RandomState(seed + 10)
    if "d_vectors" in case:
        d = rs.randn(B, 8).astype(np.float32)
        batch["d_vectors"] = d / np.linalg.norm(d, axis=1, keepdims=True)  # F26: unit length
    else:
        batch["speaker_ids"] = np.array([2, 0, 1][:B], np.int32)
    if "languages" in case:
        batch["language_ids"] = np.array([1, 1, 0][:B], np.int32)
    return batch


@pytest.fixture(scope="module", params=sorted(CASES))
def run(request):
    case = request.param
    use_sdp, kw = CASES[case]
    jcfg, pcfg = train_configs(use_sdp, **kw)
    jm = JaxVits(jcfg)
    gen_params, disc_params = fast_params(jm.init_params, jax.random.PRNGKey(0), seed=0,
                                          scale=WEIGHT_SCALE)
    port = Vits(pcfg)
    like = {k: v for k, v in port.module.state_dict().items()}
    port.load_state_dict(widened(vits_from_jax_params(gen_params), like))
    port.discriminator = port.discriminator.to_empty(device="cpu")
    port.load_discriminator_state_dict(vits_discriminator_from_jax_params(disc_params))
    batch = speaker_batch(case)
    jax_run = jax_steps(jm, jcfg, gen_params, disc_params, batch, 1)
    for j in jax_run:  # the JAX gradients and parameters in the port's shapes
        j["grads"]["gen"] = widened(j["grads"]["gen"], like)
        j["params"]["gen"] = widened(j["params"]["gen"], like)
    exact = None
    if "languages" in case:  # the port's step in float64 on the same draws
        port64 = copy.deepcopy(port)
        port64.module.double()
        port64.discriminator.double()
        batch64 = {k: v.astype(np.float64) if v.dtype == np.float32 else v
                   for k, v in batch.items()}
        exact = port_steps(port64, pcfg, batch64, jax_run, teacher_forced=False)[0]["grads"]
    got = port_steps(port, pcfg, batch, jax_run, teacher_forced=True)
    return case, use_sdp, got, jax_run, like, exact


def test_losses_and_gradients_match_jax(run):
    case, use_sdp, got, jax_run, _, exact = run
    check_losses(got[0]["metrics"], jax_run[0]["metrics"], use_sdp=use_sdp)
    got_grads, want_grads = copy.deepcopy(got[0]["grads"]), copy.deepcopy(jax_run[0]["grads"])
    if exact is not None:  # emb_l against float64 (see the module's docstring)
        ref = exact["gen"]["emb_l.weight"]
        peak = float(ref.abs().max())
        for grads in (got_grads, want_grads):
            g = grads["gen"].pop("emb_l.weight").double()
            assert float((g - ref).abs().max()) <= EMB_L_TOL * peak
    check_grads(got_grads, want_grads, sdp=use_sdp)


def test_parameters_after_a_step_match_jax(run):
    _, _, got, jax_run, _, _ = run
    for group in ("gen", "disc"):
        for name, want in jax_run[0]["params"][group].items():
            err = float((got[0]["params"][group][name] - want).abs().max())
            assert err <= PARAM_TOL, (group, name, err)


def test_conditioning_layers_are_trained(run):
    """The speaker (or d-vector) and language layers get gradients: ``g``
    reaches the posterior encoder, the flow, the decoder and the duration
    predictor, the language the text encoder and the stochastic predictor;
    the zero-padded part of the predictor's input layer gets none (F12)."""
    case, use_sdp, got, _, like, _ = run
    grads = got[0]["grads"]["gen"]

    def moved(prefix):
        return any(float(g.abs().max()) > 0 for n, g in grads.items()
                   if n.startswith(prefix) and ("cond" in n or "emb_" in n))

    for part in ("posterior_encoder.", "flow.", "waveform_decoder.", "duration_predictor."):
        assert moved(part), (case, part)
    if case != "d_vectors_dp":
        assert float(grads["emb_g.weight"].abs().max()) > 0
    if "languages" in case:
        assert float(grads["emb_l.weight"].abs().max()) > 0
        assert float(grads["duration_predictor.cond_lang.weight"].abs().max()) > 0
        hidden = 32
        assert like["duration_predictor.pre.weight"].shape[1] == hidden + 4
        assert float(grads["duration_predictor.pre.weight"][:, hidden:].abs().max()) == 0


def test_detach_dp_input_stops_the_speaker_gradient_at_the_predictor():
    """Under ``detach_dp_input`` (the default) the duration loss does not
    reach ``emb_g`` through the predictor: with every other loss weight 0,
    ``emb_g`` gets no gradient; without the detach it does."""
    grads = {}
    for detach in (True, False):
        _, pcfg = train_configs(True, **CASES["speaker_ids"][1], detach_dp_input=detach)
        for k in ("mel_loss_alpha", "kl_loss_alpha", "feat_loss_alpha", "gen_loss_alpha"):
            setattr(pcfg, k, 0.0)
        port = Vits(pcfg).init_params(seed=1, device="cpu", discriminator=True)
        step, _, state = port.make_train_step(pcfg, torch.Generator().manual_seed(0),
                                              device="cpu")
        captured = {}
        apply = state.apply_updates
        state.apply_updates = lambda g, apply=apply: (captured.update(g), apply(g))[1]
        batch = {k: torch.from_numpy(v) for k, v in speaker_batch("speaker_ids").items()}
        batch["text_input"] = batch["text_input"].long()
        step(state, batch)
        names = port_train.param_names(port)["gen"]
        grads[detach] = dict(zip(names, captured["gen"]))["emb_g.weight"]
    assert float(grads[True].abs().max()) == 0
    assert float(grads[False].abs().max()) > 0


def test_speaker_consistency_loss_still_raises():
    _, pcfg = train_configs(True, **CASES["speaker_ids"][1], use_speaker_encoder_as_loss=True)
    port = Vits(pcfg).init_params(seed=0, device="cpu", discriminator=True)
    with pytest.raises(NotImplementedError, match="17a"):
        port.make_train_step(pcfg, torch.Generator(), device="cpu")
