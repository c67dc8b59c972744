"""Multi-speaker and multi-language VITS in the port against the JAX package,
on the CPU at a small size (``test_torch_vits_model.tiny_vits_args``: hidden
32, 2 encoder layers; graphemes with ``english_cleaners`` and blanks).

The JAX parameters are carried into the port by ``vits_from_jax_params``
and the JAX package's noise is replayed into the port
(``record_jax_normals`` / ``replay_normals``): durations and ``y_lengths``
must be equal and waveforms agree within 1e-5.

Divergences from the JAX package, each named in its test (ROADMAP.md §3):

* F11: the JAX package builds speaker and language managers from the
  config's top level only, so a config that sets the fields on
  ``model_args`` (both of the repo's multi-speaker recipes do) gets none;
  the port reads either place. A JAX VITS config has no top-level language
  fields at all, so the JAX side of every language comparison here gets a
  ``LanguageManager`` attached by hand.
* F12: the JAX package sizes the duration predictor's input layer from its
  training forward, which feeds the prior means (``hidden_channels`` wide),
  while its inference feeds the text encoder's output, which a language
  embedding widens: a JAX multi-language model cannot run inference on its
  own initial parameters. The port sizes the layer for the encoder's
  output, as the reference does; ``tiny_jax_multi`` redraws that layer of
  the JAX parameters at the width the JAX inference takes.
* F13: the JAX converter of reference checkpoints drops the stochastic
  duration predictor's ``cond_lang`` and the whole ``use_sdp=False``
  predictor; the port's carries both. And the JAX package's init fails for
  a stochastic duration predictor with speakers and
  ``condition_dp_on_speaker=False`` (its training forward conditions the
  predictor regardless); ``tiny_jax_multi`` initialises with the flag on
  and drops the unused layer.
* F14: the JAX package tokenizes without the request's language, so its
  ``multi_phonemizer`` models (the multilingual recipe's) cannot
  synthesize; the port passes the language's name, as the reference does.
* F22: ``speaker_wav`` without a speaker encoder raises ``ValueError``
  in the port, naming ``--encoder_path``; the JAX ``Synthesizer`` decodes
  such a request without the voice.
* F26: the port L2-normalises d-vectors, as the reference VITS does, and
  the JAX package does not; the comparisons with the JAX package here feed
  unit d-vectors, on which the two agree
  (``tests/test_torch_speaker_slice.py`` names the divergence).
* A d-vector model with one speaker takes that speaker's d-vector when none
  is named; the JAX ``Synthesizer`` passes a speaker id, which a d-vector
  model ignores, and decodes unconditioned.
"""

import torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import io
import json
import re
import threading
import urllib.error
import urllib.parse
import urllib.request

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.io.wavfile
import torch
from helpers import fast_params
from test_torch_packed_serving import jax_eager_draws, masked_decode
from test_torch_vits_model import (
    WEIGHT_SCALE,
    record_jax_normals,
    replay_normals,
    tiny_vits_args,
)

from tts_tpu.models.vits import Vits as JaxVits
from tts_tpu.models.vits import VitsArgs as JaxVitsArgs
from tts_tpu.models.vits import VitsConfig as JaxVitsConfig
from tts_tpu.utils.convert import convert_vits_generator as jax_convert_vits_generator
from tts_tpu.utils.managers import LanguageManager as JaxLanguageManager
from tts_tpu.utils.synthesizer import Synthesizer as JaxSynthesizer
from tts_tpu_torch.api import TTS
from tts_tpu_torch.bin.synthesize import main as port_cli
from tts_tpu_torch.models.vits import Vits, VitsConfig
from tts_tpu_torch.server import batching
from tts_tpu_torch.server.batching import DynamicBatcher
from tts_tpu_torch.server.server import build_parser, close_server, create_server, server_from_args
from tts_tpu_torch.utils import packing
from tts_tpu_torch.utils.convert import (
    convert_vits_generator,
    load_reference_vits,
    vits_from_jax_params,
)
from tts_tpu_torch.utils.synthesizer import SENTENCE_GAP, Synthesizer

ATOL = 1e-5
HOP = 16  # tiny_vits_args: upsample 4 x 4
SPEAKERS = ["p225", "p226", "p227"]
LANGUAGES = ["de", "en", "fr"]  # M-AILABS codes, as the multilingual recipe derives them
D_VECTOR_DIM = 24
RECIPE = dict(text_cleaner="english_cleaners", use_phonemes=False, add_blank=True)
TEXT = "The 3 cats ate at 10:30. Be a voice, not an echo! Prior to November 22, 1963."

CASES = {
    "speakers": dict(use_speaker_embedding=True, num_speakers=3),
    "speakers_dp_unconditioned": dict(use_speaker_embedding=True, num_speakers=3,
                                      condition_dp_on_speaker=False),
    "speakers_deterministic_dp": dict(use_speaker_embedding=True, num_speakers=3,
                                      use_sdp=False),
    "speakers_deterministic_dp_unconditioned": dict(
        use_speaker_embedding=True, num_speakers=3, use_sdp=False,
        condition_dp_on_speaker=False),
    "d_vectors": dict(use_d_vector_file=True, d_vector_dim=D_VECTOR_DIM),
    "languages": dict(use_language_embedding=True, num_languages=3),
    "languages_speakers": dict(use_language_embedding=True, num_languages=3,
                               use_speaker_embedding=True, num_speakers=3),
    "languages_speakers_deterministic_dp": dict(
        use_language_embedding=True, num_languages=3, use_speaker_embedding=True,
        num_speakers=3, use_sdp=False),
}


def tiny_jax_multi(seed=0, config_kw=None, **kw):
    """A tiny conditioned JAX ``Vits`` and generator params its inference
    runs on (N(0, 0.1²) fill). Two faults of the JAX init are worked round
    here, the JAX package unchanged: F13, a stochastic predictor with
    speakers and ``condition_dp_on_speaker=False`` is initialised with the
    flag on and its unused ``cond`` dropped (the deterministic predictor's
    too, which its init makes whatever the flag); F12, the duration
    predictor's input layer (and the deterministic one's ``cond``, whose
    output joins that input) is redrawn at the width the JAX inference feeds
    it, the text encoder's plus the language embedding's."""
    args = tiny_vits_args(**kw)
    sdp = args.get("use_sdp", True)
    dp_on_speaker = args.get("condition_dp_on_speaker", True)
    init_args = dict(args, condition_dp_on_speaker=True)
    init = JaxVits(JaxVitsConfig(model_args=JaxVitsArgs(**init_args), **(config_kw or {})))
    params, _ = fast_params(init.init_params, jax.random.PRNGKey(0), seed=seed,
                            scale=WEIGHT_SCALE)
    params = flax.core.unfreeze(params)
    model = JaxVits(JaxVitsConfig(model_args=JaxVitsArgs(**args), **(config_kw or {})))
    dp = params["params"]["duration_predictor"]
    if not dp_on_speaker:
        dp.pop("cond", None)
    if args.get("use_language_embedding"):
        rs = np.random.RandomState(seed + 100)
        widen = args.get("embedded_language_dim", 4)

        def redraw(leaf, axis):
            shape = list(np.shape(leaf))
            shape[axis] += widen
            return jnp.asarray(rs.randn(*shape).astype(np.float32) * WEIGHT_SCALE)

        if sdp:
            dp["pre"]["kernel"] = redraw(dp["pre"]["kernel"], -2)
        else:
            conv = dp["conv_1"]["Conv_0"]
            conv["kernel"] = redraw(conv["kernel"], -2)
            if "cond" in dp:
                dp["cond"]["kernel"] = redraw(dp["cond"]["kernel"], -1)
                dp["cond"]["bias"] = redraw(dp["cond"]["bias"], -1)
    return model, params


def port_of(jax_model, params) -> Vits:
    port = Vits(VitsConfig.from_dict(jax_model.config.to_dict()))
    port.load_state_dict(vits_from_jax_params(params))
    return port


def conditioning(kw, rows, seed=0):
    """``aux_input`` for ``rows`` rows: speakers, d-vectors (unit vectors,
    which the port's normalisation leaves as they are, F26) and languages as
    the case takes them, each row different."""
    rs = np.random.RandomState(seed)
    aux = {}
    if kw.get("use_d_vector_file"):
        d = rs.randn(rows, D_VECTOR_DIM)
        aux["d_vectors"] = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    elif kw.get("use_speaker_embedding"):
        aux["speaker_ids"] = np.array([2, 0, 1, 2][:rows], np.int32)
    if kw.get("use_language_embedding"):
        aux["language_ids"] = np.array([1, 2, 0, 0][:rows], np.int32)
    return aux


def jax_aux(aux):
    return {k: jnp.asarray(v) for k, v in aux.items()}


def port_aux(aux):
    return {k: torch.from_numpy(v).long() if v.dtype.kind == "i" else torch.from_numpy(v)
            for k, v in aux.items()}


def _ids(seed=0, B=3, T=16):
    rs = np.random.RandomState(seed)
    x = rs.randint(1, 48, (B, T)).astype(np.int32)
    lengths = np.array([T, T - 5, T - 10][:B], np.int32)
    return x, lengths


def _torch(*arrays):
    return [torch.from_numpy(np.asarray(a)).long() for a in arrays]


def _close(got, want, what, atol=ATOL):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=atol, err_msg=what)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", list(CASES))
def test_inference_matches_jax_with_conditioning(case):
    """``Vits.inference`` with two rows of different speakers, d-vectors or
    languages against the JAX ``Vits.inference`` on its own noise: equal
    durations and ``y_lengths``, prior, flow and waveform within 1e-5; and
    the conditioning reaches the audio."""
    kw = CASES[case]
    jm, params = tiny_jax_multi(seed=1, **kw)
    port = port_of(jm, params)
    x, xl = _ids(seed=3, B=2)
    aux = conditioning(kw, 2)
    with record_jax_normals() as draws:
        want = jm.inference(params, jnp.asarray(x), jnp.asarray(xl), aux_input=jax_aux(aux),
                            max_frames=96)
    with replay_normals(draws):
        got = port.inference(*_torch(x, xl), max_frames=96, aux_input=port_aux(aux))
    np.testing.assert_array_equal(got["y_lengths"].numpy(), np.asarray(want["y_lengths"]))
    np.testing.assert_array_equal(got["durations"].numpy(), np.asarray(want["durations"]))
    assert (got["durations"] > 1).any()
    for key in ("m_p", "logs_p", "z_p", "z", "model_outputs"):
        _close(got[key], want[key], key)
    # the other row's conditioning on the same text changes the waveform
    swapped = {k: v[::-1].copy() for k, v in aux.items()}
    with replay_normals(draws):
        other = port.inference(*_torch(x, xl), max_frames=96, aux_input=port_aux(swapped))
    assert np.abs(other["model_outputs"].numpy() - got["model_outputs"].numpy()).max() > 1e-3


def test_infer_durations_take_the_conditioning():
    """The durations pass conditions as ``inference`` does: equal to the JAX
    package's ``infer_durations`` with the same speakers and languages."""
    kw = CASES["languages_speakers"]
    jm, params = tiny_jax_multi(seed=2, **kw)
    port = port_of(jm, params)
    x, xl = _ids(seed=4)
    aux = conditioning(kw, 3)
    with record_jax_normals() as draws:
        want = np.asarray(jm.infer_durations(params, jnp.asarray(x), jnp.asarray(xl),
                                             aux_input=jax_aux(aux)))
    with replay_normals(draws):
        got = port.infer_durations(*_torch(x, xl), aux_input=port_aux(aux))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("noise_layout", ["batch", "packed"])
@pytest.mark.parametrize("case", ["languages_speakers", "d_vectors"])
def test_inference_packed_with_per_slot_conditioning_matches_jax(case, noise_layout):
    """One packed grid of three utterances, each with its own speaker (or
    d-vector) and language: durations, lengths and the grid's waveform
    equal the JAX ``inference_packed``'s, whose flow and decoder gather
    the speaker vector per slot (``g_pk``)."""
    kw = CASES[case]
    jm, params = tiny_jax_multi(seed=5, **kw)
    port = port_of(jm, params)
    x, xl = _ids()
    aux = conditioning(kw, 3, seed=1)
    with record_jax_normals() as draws:
        durations = np.asarray(jm.infer_durations(params, jnp.asarray(x), jnp.asarray(xl),
                                                  aux_input=jax_aux(aux)))
        plan = packing.plan_pack_layout(durations)
        want = jm.inference_packed(params, jnp.asarray(x), jnp.asarray(xl), plan.seg_sample,
                                   plan.seg_pos, aux_input=jax_aux(aux), noise_frames=64,
                                   noise_layout=noise_layout)
    with replay_normals(draws):
        got_durations = port.infer_durations(*_torch(x, xl), aux_input=port_aux(aux))
        got = port.inference_packed(*_torch(x, xl), plan.seg_sample, plan.seg_pos,
                                    noise_frames=64, noise_layout=noise_layout,
                                    aux_input=port_aux(aux))
    np.testing.assert_array_equal(got_durations.numpy(), durations)
    np.testing.assert_array_equal(got["y_lengths"].numpy(), np.asarray(want["y_lengths"]))
    assert got["model_outputs"].shape == (plan.n_rows, plan.row_len * HOP, 1)
    _close(got["model_outputs"], want["model_outputs"], "packed grid")


@pytest.mark.parametrize("case", ["languages_speakers_deterministic_dp", "d_vectors"])
def test_packed_speakers_equal_their_own_conditioned_decodes(case):
    """Mirrors the JAX package's ``test_packed_multispeaker_conditioning``:
    utterances of different speakers and languages in one grid decode as
    each does alone with its own conditioning, masked, within 1e-5."""
    kw = CASES[case]
    jm, params = tiny_jax_multi(seed=6, **kw)
    port = port_of(jm, params)
    x, xl = _torch(*_ids(seed=1))
    aux = port_aux(conditioning(kw, 3, seed=2))
    want = masked_decode(port, x, xl, 0, noise_frames=256, aux=aux)
    durations = port.infer_durations(x, xl, aux_input=aux).numpy()
    assert durations.max() <= 256
    plan = packing.plan_pack_layout(durations)
    assert plan.n_rows == 1  # every segment shares the one row
    grid = port.inference_packed(x, xl, plan.seg_sample, plan.seg_pos, noise_frames=256,
                                 noise_layout="batch", aux_input=aux)["model_outputs"].numpy()
    pieces = packing.unpack_outputs(grid, plan, upsample=HOP)
    for i, (got, ref) in enumerate(zip(pieces, want, strict=True)):
        assert got.shape[0] == ref.shape[0]
        np.testing.assert_allclose(got[:, 0], ref.numpy(), rtol=0, atol=ATOL,
                                   err_msg=f"segment {i}")


# ---------------------------------------------------------------------------
# weights from a reference-layout checkpoint
# ---------------------------------------------------------------------------


def reference_layout(state):
    """The port's state_dict in the reference's (coqui) names and layouts:
    1x1 convolutions for the linear layers, ``gamma``/``beta`` norms, the
    stochastic predictor's flows numbered after its affine flow."""
    out = {}
    for key, value in state.items():
        v = value.numpy()
        k = re.sub(r"^text_encoder\.encoder\.(attn|ffn)\.", r"text_encoder.encoder.\1_layers.", key)
        k = re.sub(r"encoder\.norm([12])\.(\d+)\.", r"encoder.norm_layers_\1.\2.", k)
        k = re.sub(r"\.(in_layer|res_skip_layer)\.", r".\1s.", k)
        k = re.sub(r"^flow\.flow\.", "flow.flows.", k)
        k = re.sub(r"^duration_predictor\.(post_)?flow_affine\.",
                   lambda m: f"duration_predictor.{m.group(1) or ''}flows.0.", k)
        k = re.sub(r"^duration_predictor\.(post_)?flow\.(\d+)\.",
                   lambda m: f"duration_predictor.{m.group(1) or ''}flows.{int(m.group(2)) + 1}.", k)
        k = re.sub(r"\.conv_(sep|1x1)\.", r".convs_\1.", k)
        k = re.sub(r"convs\.norm([12])\.", r"convs.norms_\1.", k)
        if re.search(r"(norm_layers_\d\.\d+|norms_\d\.\d+|norm_[12])\.(weight|bias)$", k):
            k = k[: -len("weight")] + "gamma" if k.endswith("weight") else k[: -len("bias")] + "beta"
        if v.ndim == 2 and not key.endswith(("emb.weight", "emb_g.weight", "emb_l.weight")):
            v = v[:, :, None]
        if k.endswith(("translation", "log_scale")):
            v = v[:, None]
        out[k] = v
    return out


@pytest.mark.parametrize("case", ["languages_speakers", "d_vectors",
                                  "speakers_deterministic_dp"])
def test_load_reference_vits_carries_every_conditioning_layer(case):
    """A reference-layout state made from the port's own weights (``emb_g``,
    ``emb_l``, the ``cond_layer`` of the posterior encoder, the flows and the
    decoder, the duration predictor's ``cond`` and ``cond_lang``) loads back
    through ``load_reference_vits`` to the same tensors, strictly. F13: the
    JAX package's converter drops ``cond_lang`` and the ``use_sdp=False``
    predictor, which the port's carries."""
    kw = CASES[case]
    config = VitsConfig()
    for k, v in tiny_vits_args(**kw).items():
        setattr(config.model_args, k, v)
    port = Vits(config).init_params(seed=3, device="cpu")
    state = port.module.state_dict()
    reference = reference_layout(state)
    loaded = load_reference_vits(reference, config.model_args)
    assert sorted(loaded) == sorted(state)
    for key in state:
        np.testing.assert_array_equal(loaded[key].numpy(), state[key].numpy(), err_msg=key)
    conditioned = [k for k in state if re.search(r"(^emb_[gl]\.|cond)", k)]
    assert len(conditioned) >= (10 if case == "languages_speakers" else 8)

    jax_args = JaxVitsConfig(model_args=JaxVitsArgs(**tiny_vits_args(**kw))).model_args
    jax_tree = jax_convert_vits_generator(dict(reference), jax_args)["params"]
    ours = convert_vits_generator(dict(reference), config.model_args)["params"]
    if case == "languages_speakers":
        assert "cond_lang" in ours["duration_predictor"]
        assert "cond_lang" not in jax_tree["duration_predictor"]
    elif case == "speakers_deterministic_dp":
        assert "cond" in ours["duration_predictor"] and "duration_predictor" not in jax_tree
    else:
        assert ours.keys() == jax_tree.keys()


def test_reference_deterministic_dp_with_language_input_is_refused():
    """The reference's ``use_sdp=False`` predictor may carry ``cond_lang``;
    the JAX package's ``DurationPredictor`` has no language input, so the
    port refuses such a checkpoint instead of dropping the layer."""
    kw = CASES["languages_speakers_deterministic_dp"]
    config = VitsConfig()
    for k, v in tiny_vits_args(**kw).items():
        setattr(config.model_args, k, v)
    reference = reference_layout(Vits(config).init_params(seed=0, device="cpu").module.state_dict())
    reference["duration_predictor.cond_lang.weight"] = np.zeros((36, 4, 1), np.float32)
    reference["duration_predictor.cond_lang.bias"] = np.zeros((36,), np.float32)
    with pytest.raises(NotImplementedError, match="cond_lang"):
        load_reference_vits(reference, config.model_args)


# ---------------------------------------------------------------------------
# managers (F11)
# ---------------------------------------------------------------------------


def write_ids(path, names):
    with open(path, "w") as f:
        json.dump({name: i for i, name in enumerate(names)}, f)
    return str(path)


def write_d_vectors(path, names, seed=0):
    """Two clips per speaker, d-vectors of ``D_VECTOR_DIM``."""
    rs = np.random.RandomState(seed)
    clips = {f"{name}_{n}.wav": {"name": name, "embedding": rs.randn(D_VECTOR_DIM).tolist()}
             for name in names for n in range(2)}
    with open(path, "w") as f:
        json.dump(clips, f)
    return str(path)


def test_managers_from_model_args_only(tmp_path):
    """F11: speaker and language fields set on ``model_args`` alone, as the
    VCTK and multilingual recipes set them, give the port both managers and
    the counts in ``model_args`` (and ``emb_g``/``emb_l``); the JAX package
    builds neither and sizes nothing."""
    speakers = write_ids(tmp_path / "speakers.json", SPEAKERS)
    languages = write_ids(tmp_path / "language_ids.json", LANGUAGES)

    def configure(config):
        a = config.model_args
        for k, v in tiny_vits_args(num_chars=None).items():
            setattr(a, k, v)
        a.use_speaker_embedding, a.speakers_file = True, speakers
        a.use_language_embedding, a.language_ids_file = True, languages
        for k, v in RECIPE.items():
            setattr(config, k, v)
        return config

    port = Vits.init_from_config(configure(VitsConfig()))
    assert port.speaker_manager.speaker_names == SPEAKERS
    assert port.language_manager.language_names == LANGUAGES
    a = port.config.model_args
    assert (a.num_speakers, a.num_languages, port.config.num_speakers) == (3, 3, 3)
    assert port.module.emb_g.weight.shape[0] == 3 and port.module.emb_l.weight.shape[0] == 3

    jm = JaxVits.init_from_config(configure(JaxVitsConfig()))
    assert jm.speaker_manager is None and jm.language_manager is None
    assert (jm.config.model_args.num_speakers, jm.config.model_args.num_languages) == (0, 0)


def test_managers_from_the_top_level_match_jax(tmp_path):
    """Speakers set on the top level (the fields the JAX package reads) give
    both packages the same manager, and the top level's speaker fields are
    mirrored into ``model_args`` in both; a d-vector file gives both the same
    speakers and mean embeddings."""
    speakers = write_ids(tmp_path / "speakers.json", SPEAKERS)
    d_vectors = write_d_vectors(tmp_path / "d_vectors.json", SPEAKERS[:2])
    for fields in (dict(use_speaker_embedding=True, speakers_file=speakers),
                   dict(use_d_vector_file=True, d_vector_file=[d_vectors],
                        d_vector_dim=D_VECTOR_DIM)):
        port_config = VitsConfig(**RECIPE, **fields)
        jax_config = JaxVitsConfig(**RECIPE, **fields)
        for config in (port_config, jax_config):
            for k, v in tiny_vits_args(num_chars=None).items():
                setattr(config.model_args, k, v)
        port, jm = Vits.init_from_config(port_config), JaxVits.init_from_config(jax_config)
        assert port.speaker_manager.name_to_id == jm.speaker_manager.name_to_id
        for f in ("num_speakers", "use_speaker_embedding", "use_d_vector_file", "d_vector_dim"):
            assert getattr(port.config.model_args, f) == getattr(jm.config.model_args, f), f
        for name in port.speaker_manager.name_to_id:
            if "d_vector_file" in fields:
                np.testing.assert_array_equal(port.speaker_manager.get_mean_embedding(name),
                                              jm.speaker_manager.get_mean_embedding(name))


# ---------------------------------------------------------------------------
# the Synthesizer, the TTS API, the batcher, the server and the CLI
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    """A tiny speakers-and-languages VITS (stochastic durations) as the JAX
    package's ``model.msgpack`` and the port's ``model_torch.pt``, with
    ``speakers.json`` and ``language_ids.json``. The speakers are set on the
    config's top level, where the JAX package reads them; the languages on
    ``model_args``, where only the port does (F11)."""
    from tts_tpu.utils.io import save_checkpoint

    d = tmp_path_factory.mktemp("vits_multi")
    speakers = write_ids(d / "speakers.json", SPEAKERS)
    languages = write_ids(d / "language_ids.json", LANGUAGES)
    jm, params = tiny_jax_multi(
        seed=4, config_kw=dict(RECIPE, use_speaker_embedding=True, speakers_file=speakers),
        num_chars=100, language_ids_file=languages, **CASES["languages_speakers"])
    save_checkpoint(str(d / "model.msgpack"), params, config=jm.config)
    with open(d / "config.json", "w") as f:
        json.dump(jm.config.to_dict(), f)
    torch.save(port_of(jm, params).module.state_dict(), d / "model_torch.pt")
    return d


def jax_synth(model_dir):
    synth = JaxSynthesizer(tts_checkpoint=str(model_dir / "model.msgpack"),
                           tts_config_path=str(model_dir / "config.json"),
                           use_griffin_lim=False)
    # F11: the JAX package builds no language manager from model_args
    assert synth.tts_model.language_manager is None
    synth.tts_model.language_manager = JaxLanguageManager(
        language_ids_file_path=str(model_dir / "language_ids.json"))
    return synth


def port_synth(model_dir, **kwargs):
    return Synthesizer(tts_checkpoint=str(model_dir / "model_torch.pt"),
                       tts_config_path=str(model_dir / "config.json"), device="cpu", **kwargs)


@pytest.mark.parametrize("text,speaker,language", [
    (TEXT, "p226", "fr"),  # three sentences: one packed grid in both
    ("Be a voice, not an echo!", "p227", "de"),  # one sentence: the serial path
])
def test_synthesizer_and_api_speak_like_jax(model_dir, text, speaker, language):
    """The port's ``Synthesizer`` and ``TTS`` with a speaker and a language
    name against the JAX ``Synthesizer`` (packed path on), on its draws:
    the same samples within 1e-5, and another speaker gives other audio."""
    with jax_eager_draws() as draws:
        want = np.asarray(jax_synth(model_dir).tts(text, speaker_name=speaker,
                                                   language_name=language), np.float32)
    synth = port_synth(model_dir)
    with replay_normals(draws):
        got = np.asarray(synth.tts(text, speaker_name=speaker, language_name=language),
                         np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    tts = TTS(model_path=str(model_dir / "model_torch.pt"),
              config_path=str(model_dir / "config.json"), device="cpu")
    with replay_normals(draws):
        api = np.asarray(tts.tts(text, speaker=speaker, language=language), np.float32)
    np.testing.assert_array_equal(api, got)
    # on the port's own noise (each call seeds it), another speaker speaks otherwise
    mine, other = (np.asarray(synth.tts(text, speaker_name=name, language_name=language),
                              np.float32) for name in (speaker, "p225"))
    n = min(len(other), len(mine)) - SENTENCE_GAP
    assert np.abs(other[:n] - mine[:n]).max() > 1e-3


def test_api_lists_speakers_and_languages_like_jax(model_dir):
    """``is_multi_speaker``, ``speakers``, ``is_multi_lingual`` and
    ``languages`` of the port's ``TTS`` against the JAX ``TTS`` (whose
    language manager is attached by hand, F11); a single-speaker VITS has
    none of either."""
    from tts_tpu.api import TTS as JaxTTS

    tts = TTS(model_path=str(model_dir / "model_torch.pt"),
              config_path=str(model_dir / "config.json"), device="cpu")
    jtts = JaxTTS(model_path=str(model_dir / "model.msgpack"),
                  config_path=str(model_dir / "config.json"))
    jtts.synthesizer.tts_model.language_manager = JaxLanguageManager(
        language_ids_file_path=str(model_dir / "language_ids.json"))
    for name in ("is_multi_speaker", "speakers", "is_multi_lingual", "languages"):
        assert getattr(tts, name) == getattr(jtts, name), name
    assert tts.speakers == SPEAKERS and tts.languages == LANGUAGES


def test_speaker_and_language_files_override_the_configs(model_dir, tmp_path):
    """``speakers_file_path`` and ``language_ids_file_path`` replace the
    config's files on its top level and in ``model_args``, as the JAX
    ``Synthesizer``'s ``tts_speakers_file`` does for the top level."""
    renamed = write_ids(tmp_path / "speakers.json", ["ann", "bob", "cy"])
    langs = write_ids(tmp_path / "langs.json", ["es", "it", "pl"])
    synth = port_synth(model_dir, speakers_file_path=renamed, language_ids_file_path=langs)
    assert synth.tts_model.speaker_manager.speaker_names == ["ann", "bob", "cy"]
    assert synth.tts_model.language_manager.language_names == ["es", "it", "pl"]
    config = synth.tts_config
    assert config.speakers_file == config.model_args.speakers_file == renamed
    assert config.model_args.language_ids_file == langs
    with jax_eager_draws() as draws:
        jax_synth(model_dir).tts("Hello there.", speaker_name="p226", language_name="fr")
    with replay_normals(draws):
        want = np.asarray(port_synth(model_dir).tts("Hello there.", speaker_name="p226",
                                                    language_name="fr"))
    with replay_normals(draws):
        got = np.asarray(synth.tts("Hello there.", speaker_name="bob", language_name="pl"))
    np.testing.assert_array_equal(got, want)  # the same ids under other names


@pytest.mark.parametrize("given,error,match", [
    (dict(speaker_name="nobody", language_name="en"), ValueError, "not in the available speakers"),
    (dict(language_name="en"), ValueError, "multi-speaker model"),
    (dict(speaker_name="p225"), ValueError, "multi-lingual model"),
    (dict(speaker_name="p225", language_name="xx"), ValueError,
     "not in the available languages"),
])
def test_error_surface_matches_jax(model_dir, given, error, match):
    """An unknown speaker or language, or none named for a model with
    several: the same error, with the same words, from both packages."""
    with pytest.raises(error, match=match):
        jax_synth(model_dir).tts("Hello there.", **given)
    with pytest.raises(error, match=match):
        port_synth(model_dir).tts("Hello there.", **given)


def test_speaker_wav_raises_until_the_encoder_is_ported(model_dir, tmp_path):
    """F22: without a speaker encoder loaded, a ``speaker_wav`` raises
    ``ValueError`` naming ``--encoder_path`` and ``encoder_path=``, and the
    server answers it 400. The JAX ``Synthesizer`` decodes such a request
    without the voice."""
    with pytest.raises(ValueError, match="--encoder_path.*encoder_path=") as error:
        port_synth(model_dir).tts("Hello there.", speaker_name="p225", language_name="en",
                                  speaker_wav="ref.wav")
    assert "F22" in str(error.value)
    srv = create_server(port_synth(model_dir), port=0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        code, body = _get(f"http://127.0.0.1:{srv.server_address[1]}/api/tts?text=hi"
                          f"&speaker_id=p225&language_id=en&speaker_wav=ref.wav")
    finally:
        close_server(srv)
    assert code == 400 and b"--encoder_path" in body


def test_one_entry_managers_are_taken_by_default(tmp_path):
    """A manager of one entry is taken when no name is given, as in the JAX
    ``Synthesizer``: a one-speaker, one-language model speaks its speaker
    and language unnamed; a one-speaker d-vector model takes that speaker's
    mean d-vector (the JAX ``Synthesizer`` passes an id, which a d-vector
    model ignores)."""
    def save(name, **fields):
        config = VitsConfig(**RECIPE)
        for k, v in tiny_vits_args(num_chars=None, **fields).items():
            setattr(config.model_args, k, v)
        model = Vits.init_from_config(config).init_params(seed=0, device="cpu")
        (tmp_path / name).mkdir()
        with open(tmp_path / name / "config.json", "w") as f:
            json.dump(model.config.to_dict(), f)
        torch.save(model.module.state_dict(), tmp_path / name / "model_torch.pt")
        return Synthesizer(model_dir=str(tmp_path / name), device="cpu")

    synth = save("one", use_speaker_embedding=True,
                 speakers_file=write_ids(tmp_path / "one.json", ["p226"]),
                 use_language_embedding=True,
                 language_ids_file=write_ids(tmp_path / "one_lang.json", ["fr"]))
    assert synth._resolve_speaker(None) == (0, None) and synth._resolve_language(None) == 0
    assert synth._resolve_language("xx") == 0  # as the JAX one: its one language
    np.testing.assert_array_equal(
        np.asarray(synth.tts("Hello there.")),
        np.asarray(synth.tts("Hello there.", speaker_name="p226", language_name="fr")))

    dv = save("dv", use_d_vector_file=True, d_vector_dim=D_VECTOR_DIM,
              d_vector_file=write_d_vectors(tmp_path / "dv.json", ["p225"]))
    speaker_id, d_vector = dv._resolve_speaker(None)
    assert speaker_id is None
    np.testing.assert_array_equal(
        d_vector, dv.tts_model.speaker_manager.get_mean_embedding("p225").astype(np.float32))


@pytest.fixture(scope="module")
def quiet_model_dir(tmp_path_factory):
    """The speakers-and-languages model with both noise scales 0: every
    utterance then decodes to the same samples whichever grid holds it."""
    d = tmp_path_factory.mktemp("vits_multi_quiet")
    write_ids(d / "speakers.json", SPEAKERS)
    languages = write_ids(d / "language_ids.json", LANGUAGES)
    jm, params = tiny_jax_multi(
        seed=7, config_kw=RECIPE, num_chars=100, speakers_file=str(d / "speakers.json"),
        language_ids_file=languages, inference_noise_scale=0.0, inference_noise_scale_dp=0.0,
        **CASES["languages_speakers"])
    with open(d / "config.json", "w") as f:
        json.dump(jm.config.to_dict(), f)
    torch.save(port_of(jm, params).module.state_dict(), d / "model_torch.pt")
    return d


REQUESTS = [("The cats ate. Then they slept.", "p225", "en"),
            ("The cats ate. Then they slept.", "p227", "de"),
            ("Be a voice. Not an echo.", "p226", "fr")]


def test_batcher_mixes_speakers_and_languages_in_one_dispatch(quiet_model_dir):
    """Three concurrent requests of two sentences each, for three speakers
    and languages: the batcher decodes all six sentences in one dispatch,
    one packed grid with each row's ids, and each request's audio equals
    its own ``Synthesizer.tts`` (a grid of its two sentences) within 1e-5."""
    synth = Synthesizer(model_dir=str(quiet_model_dir), device="cpu")
    batcher = DynamicBatcher(synth, max_batch=8, window_ms=5000)
    sizes, rows = [], []
    real = batcher._dispatch

    def recording(batch):
        sizes.append(len(batch))
        rows.append([(it.speaker_id, it.language_id) for it in batch])
        real(batch)

    batcher._dispatch = recording
    results = {}
    try:
        threads = [threading.Thread(target=lambda r=r: results.__setitem__(
            r, batcher.tts(r[0], speaker_name=r[1], language_name=r[2]))) for r in REQUESTS]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=180)
        assert not any(th.is_alive() for th in threads)
    finally:
        batcher.close()
    assert sizes == [6]
    assert sorted(rows[0]) == sorted([(0, 1)] * 2 + [(2, 0)] * 2 + [(1, 2)] * 2)
    for text, speaker, language in REQUESTS:
        want = np.asarray(synth.tts(text, speaker_name=speaker, language_name=language),
                          np.float32)
        got = np.asarray(results[(text, speaker, language)], np.float32)
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    a, b = (np.asarray(results[r], np.float32) for r in REQUESTS[:2])
    n = min(len(a), len(b)) - SENTENCE_GAP
    assert np.abs(a[:n] - b[:n]).max() > 1e-3  # same text, other speaker and language


def test_batcher_pads_rows_with_ids_as_jax(quiet_model_dir):
    """Three sentences padded to four rows: the rows' speaker and language
    ids are the requests', the padding row's 0, as the JAX batcher pads."""
    synth = Synthesizer(model_dir=str(quiet_model_dir), device="cpu")
    batcher = DynamicBatcher(synth, max_batch=4)
    try:
        items = [batching._Pending(np.arange(1, 5, dtype=np.int64), s, l)
                 for s, l in ((2, 1), (0, 0), (1, 2))]
        aux = batcher._aux(items, 4)
    finally:
        batcher.close()
    assert aux["speaker_ids"].tolist() == [2, 0, 1, 0]
    assert aux["language_ids"].tolist() == [1, 0, 2, 0]


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=120) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


@pytest.mark.parametrize("max_batch", [1, 4])
def test_server_serves_speakers_and_languages(quiet_model_dir, tmp_path, max_batch):
    """The server from its command line with ``--speakers_file_path``
    (serially and with ``--max_batch 4``): ``/details`` names the file's
    speakers and the languages, ``/api/tts?speaker_id=…&language_id=…``
    answers with the ``Synthesizer``'s samples (within one int16 step), an
    unknown speaker 400, and the page carries the speaker and language
    selects."""
    renamed = write_ids(tmp_path / "speakers.json", ["ann", "bob", "cy"])
    args = build_parser().parse_args(["--model_path", str(quiet_model_dir), "--port", "0",
                                      "--speakers_file_path", renamed, "--device", "cpu",
                                      "--max_batch", str(max_batch)])
    srv = server_from_args(args)
    assert (srv.batcher is not None) == (max_batch > 1)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        details = json.loads(_get(f"{base}/details")[1])
        page = _get(f"{base}/")[1]
        ok = _get(f"{base}/api/tts?text={urllib.parse.quote(REQUESTS[0][0])}"
                  f"&speaker_id=cy&language_id=fr")
        unknown = _get(f"{base}/api/tts?text=hello&speaker_id=p225&language_id=fr")
    finally:
        close_server(srv)
    assert details["speakers"] == ["ann", "bob", "cy"] and details["languages"] == LANGUAGES
    assert b'id="speaker_id"' in page and b'id="language_id"' in page
    assert ok[0] == 200 and unknown[0] == 400 and b"not in the available speakers" in unknown[1]
    synth = Synthesizer(model_dir=str(quiet_model_dir), device="cpu",
                        speakers_file_path=renamed)
    want = np.asarray(synth.tts(REQUESTS[0][0], speaker_name="cy", language_name="fr"))
    sr, pcm = scipy.io.wavfile.read(io.BytesIO(ok[1]))
    assert sr == 22050 and pcm.shape == want.shape
    np.testing.assert_allclose(pcm, want * (32767 / max(0.01, float(np.abs(want).max()))),
                               rtol=0, atol=1.0)


def test_server_sends_d_vector_speakers_to_the_serial_path(tmp_path):
    """A d-vector model behind ``--max_batch 4``: every ``/api/tts`` request
    takes the serial path, chosen before the batcher (which dispatches
    nothing), and answers with the ``Synthesizer``'s samples; the batcher
    itself refuses a d-vector speaker."""
    jm, params = tiny_jax_multi(seed=8, config_kw=RECIPE, num_chars=100, **CASES["d_vectors"])
    config = VitsConfig.from_dict(jm.config.to_dict())
    config.model_args.d_vector_file = write_d_vectors(tmp_path / "dv.json", SPEAKERS)
    with open(tmp_path / "config.json", "w") as f:
        json.dump(config.to_dict(), f)
    torch.save(port_of(jm, params).module.state_dict(), tmp_path / "model_torch.pt")
    synth = Synthesizer(model_dir=str(tmp_path), device="cpu")
    srv = create_server(synth, port=0, max_batch=4)
    dispatched = []
    real = srv.batcher._dispatch
    srv.batcher._dispatch = lambda batch: dispatched.append(len(batch)) or real(batch)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        code, body = _get(f"http://127.0.0.1:{srv.server_address[1]}/api/tts?text=hello"
                          f"&speaker_id=p226")
        with pytest.raises(ValueError, match="serial path"):
            srv.batcher.tts("hello", speaker_name="p226")
    finally:
        close_server(srv)
    assert code == 200 and dispatched == []
    want = np.asarray(synth.tts("hello", speaker_name="p226"))
    pcm = scipy.io.wavfile.read(io.BytesIO(body))[1]
    np.testing.assert_allclose(pcm, want * (32767 / max(0.01, float(np.abs(want).max()))),
                               rtol=0, atol=1.0)


def test_cli_speaker_and_language_flags(quiet_model_dir, tmp_path, capsys):
    """``--list_speaker_idxs`` and ``--list_language_idxs`` print the names
    (of ``--speakers_file_path`` and ``--language_ids_file_path`` when
    given); ``--speaker_idx``/``--language_idx`` write the samples of
    ``TTS.tts_to_file``; a multi-speaker model with no speaker exits 1."""
    model = ["--model_path", str(quiet_model_dir), "--device", "cpu"]
    port_cli(model + ["--list_speaker_idxs"])
    assert str(SPEAKERS) in capsys.readouterr().out
    langs = write_ids(tmp_path / "langs.json", ["es", "it", "pl"])
    port_cli(model + ["--list_language_idxs", "--language_ids_file_path", langs])
    assert "['es', 'it', 'pl']" in capsys.readouterr().out
    renamed = write_ids(tmp_path / "speakers.json", ["ann", "bob", "cy"])
    port_cli(model + ["--list_speaker_idxs", "--speakers_file_path", renamed])
    assert "['ann', 'bob', 'cy']" in capsys.readouterr().out

    out = tmp_path / "cli.wav"
    port_cli(model + ["--text", REQUESTS[2][0], "--speaker_idx", "p226", "--language_idx", "fr",
                      "--out_path", str(out)])
    api = TTS(model_path=str(quiet_model_dir), device="cpu").tts_to_file(
        REQUESTS[2][0], speaker="p226", language="fr", file_path=str(tmp_path / "api.wav"))
    assert np.array_equal(scipy.io.wavfile.read(out)[1], scipy.io.wavfile.read(api)[1])
    with pytest.raises(SystemExit) as exit_info:
        port_cli(model + ["--text", "hi", "--language_idx", "fr"])
    assert exit_info.value.code == 1 and "--list_speaker_idxs" in capsys.readouterr().err


def test_multi_phonemizer_models_tokenize_in_the_requests_language(tmp_path):
    """F14: the multilingual recipe's ``multi_phonemizer`` picks a phonemizer
    by language. The port's ``Synthesizer`` and batcher hand the tokenizer
    each request's language, so a German and a Spanish request get the JAX
    tokenizer's ids for their own language; the JAX ``synthesis`` passes no
    language, and its tokenizer then fails."""
    from test_torch_phonemes import machine_registries

    from tts_tpu.config.shared import BaseDatasetConfig as JaxDataset
    from tts_tpu.text import TTSTokenizer as JaxTTSTokenizer
    from tts_tpu_torch.config.shared import BaseDatasetConfig

    languages = write_ids(tmp_path / "language_ids.json", ["de", "es"])
    fields = dict(text_cleaner="multilingual_cleaners", use_phonemes=True,
                  phonemizer="multi_phonemizer", phoneme_language=None)
    texts = {"de": "Guten Tag. Die Brücke ist alt.", "es": "Buenos días. El puente es viejo."}
    with machine_registries():
        config = VitsConfig(**fields, datasets=[BaseDatasetConfig(language=c) for c in texts])
        for k, v in tiny_vits_args(num_chars=None, use_language_embedding=True,
                                   language_ids_file=languages, use_sdp=False).items():
            setattr(config.model_args, k, v)
        model = Vits.init_from_config(config).init_params(seed=0, device="cpu")
        with open(tmp_path / "config.json", "w") as f:
            json.dump(model.config.to_dict(), f)
        torch.save(model.module.state_dict(), tmp_path / "model_torch.pt")
        synth = Synthesizer(model_dir=str(tmp_path), device="cpu")
        jax_tokenizer, _ = JaxTTSTokenizer.init_from_config(
            JaxVitsConfig(**fields, datasets=[JaxDataset(language=c) for c in texts]))
        seen = []
        tokenize = synth.tts_model.tokenizer.text_to_ids
        synth.tts_model.tokenizer.text_to_ids = lambda text, language=None: (
            seen.append((text, language)) or tokenize(text, language))
        batcher = DynamicBatcher(synth, max_batch=4)
        try:
            for language, text in texts.items():
                assert len(synth.tts(text, language_name=language)) > 2 * SENTENCE_GAP
                assert len(batcher.tts(text, language_name=language)) > 2 * SENTENCE_GAP
        finally:
            batcher.close()
        for text, language in seen:
            assert tokenize(text, language) == jax_tokenizer.text_to_ids(text, language)
        assert sorted({language for _, language in seen}) == ["de", "es"] and len(seen) == 8
        with pytest.raises(KeyError):
            jax_tokenizer.text_to_ids(texts["de"])  # what the JAX synthesis calls
