"""The fairseq MMS pieces of the port (``FairseqVocab``,
``rehash_fairseq_vits``, ``convert_fairseq_vits``) against the JAX
package's, on the CPU.

A fairseq-layout VITS state is made by renaming a random reference-layout
(coqui) one in reverse: the tiny VITS of ``test_torch_vits_model`` (hidden
32, 2 encoder layers, 2 flows, a 2-stage HiFiGAN; N(0, 0.1²) weights),
written by ``reference_vits_state``, its keys put back into fairseq's names
(the affine flows at even indices, the duration predictor's flows after
fairseq's numbering). The JAX ``convert_fairseq_vits`` and the port's then
give the same waveform on the same noise (the JAX draws replayed into the
port): ``y_lengths`` equal, the waveform within 1e-4, the VITS slice tests'
tolerance. Loading an MMS model directory stays refused before any fetch,
naming ROADMAP.md F35: the JAX package cannot load one.
"""

import torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_vits_model import (
    WAV_ATOL,
    _text_batch,
    record_jax_normals,
    replay_normals,
    tiny_jax_vits,
)

from tts_tpu.text.characters import FairseqVocab as JaxFairseqVocab
from tts_tpu.utils import convert as jax_convert
from tts_tpu_torch.api import TTS
from tts_tpu_torch.models.vits import Vits, VitsConfig
from tts_tpu_torch.text.characters import FairseqVocab
from tts_tpu_torch.utils import convert, manage

MMS = "tts_models/de/fairseq/vits"


def test_fairseq_rehash_mapping():
    """fairseq MMS key layout → coqui layout (reference fairseq.py:4), the
    JAX package's renames key for key."""
    src = {
        "enc_p.emb.weight": 0, "dec.conv_pre.weight": 1, "enc_q.pre.weight": 2,
        "flow.flows.0.pre.weight": 3, "flow.flows.2.pre.weight": 4,
        "flow.flows.4.pre.weight": 5, "flow.flows.6.pre.weight": 6,
        "dp.flows.0.m": 7, "dp.flows.0.logs": 8, "dp.flows.1.pre.weight": 9,
        "dp.flows.7.pre.weight": 10, "dp.post_flows.0.m": 11,
        "dp.post_flows.5.pre.weight": 12, "dp.pre.weight": 13,
        "emb_g.weight": 14,
    }
    out = convert.rehash_fairseq_vits(src)
    assert out["text_encoder.emb.weight"] == 0
    assert out["waveform_decoder.conv_pre.weight"] == 1
    assert out["posterior_encoder.pre.weight"] == 2
    assert out["flow.flows.0.pre.weight"] == 3
    assert out["flow.flows.1.pre.weight"] == 4
    assert out["flow.flows.3.pre.weight"] == 6
    assert out["duration_predictor.flows.0.translation"] == 7
    assert out["duration_predictor.flows.0.log_scale"] == 8
    assert out["duration_predictor.flows.1.pre.weight"] == 9
    assert out["duration_predictor.flows.4.pre.weight"] == 10
    assert out["duration_predictor.post_flows.0.translation"] == 11
    assert out["duration_predictor.post_flows.3.pre.weight"] == 12
    assert out["duration_predictor.pre.weight"] == 13
    assert out["emb_g.weight"] == 14
    assert len(out) == len(src)
    assert out == jax_convert.rehash_fairseq_vits(src)
    assert convert._FAIRSEQ_RENAMES == jax_convert._FAIRSEQ_RENAMES  # longest prefix first


def test_fairseq_vocab(tmp_path):
    vf = tmp_path / "vocab.txt"
    vf.write_text("_\na\nb\nc\n \nä\n", encoding="utf-8")
    v = FairseqVocab(str(vf))
    assert v.num_chars == 6
    assert v.blank == "_"
    assert v.pad == " "
    assert v.char_to_id("b") == 2 and v.id_to_char(5) == "ä"
    j = JaxFairseqVocab(str(vf))
    assert v.vocab == j.vocab and (v.pad_id, v.blank_id) == (j.pad_id, j.blank_id)


def fairseq_state(coqui: dict) -> dict:
    """The coqui-layout state in fairseq's names: the inverse renames,
    longest coqui prefix first."""
    inverse = sorted(((new, old) for old, new in convert._FAIRSEQ_RENAMES),
                     key=lambda pair: -len(pair[0]))
    out = {}
    for k, v in coqui.items():
        for new, old in inverse:
            if k.startswith(new):
                k = old + k[len(new):]
                break
        out[k] = v
    return out


def test_convert_fairseq_vits_waveform_matches_jax():
    """A fairseq-layout state (the stochastic duration predictor, as the MMS
    models have it; the JAX converter drops a deterministic one, F13)
    through the JAX ``convert_fairseq_vits`` and through the port's: the
    same waveform on the same noise."""
    jm, params = tiny_jax_vits(seed=2)
    port = Vits(VitsConfig.from_dict(jm.config.to_dict()))
    port.load_state_dict(convert.vits_from_jax_params(params))
    fairseq = fairseq_state(convert.reference_vits_state(port.module.state_dict()))
    assert "enc_p.emb.weight" in fairseq and "dec.conv_pre.weight" in fairseq
    assert "flow.flows.2.enc.in_layers.0.weight" in fairseq  # the second affine flow
    assert any(k.startswith("dp.") for k in fairseq)
    assert convert.rehash_fairseq_vits(fairseq).keys() == \
        convert.reference_vits_state(port.module.state_dict()).keys()

    jax_params = {"params": jax_convert.convert_fairseq_vits(fairseq, jm.args)["params"]}
    fresh = Vits(VitsConfig.from_dict(jm.config.to_dict()))
    fresh.module.load_state_dict(convert.convert_fairseq_vits(fairseq, fresh.args), strict=True)
    x, xl = _text_batch(seed=5)
    with record_jax_normals() as draws:
        want = jm.inference(jax_params, jnp.asarray(x), jnp.asarray(xl), max_frames=96)
    with replay_normals(draws):
        got = fresh.inference(torch.from_numpy(x).long(), torch.from_numpy(xl), max_frames=96)
    np.testing.assert_array_equal(got["y_lengths"].numpy(), np.asarray(want["y_lengths"]))
    wav = got["model_outputs"].detach().numpy()
    assert np.abs(wav).max() > 1e-3
    np.testing.assert_allclose(wav, np.asarray(want["model_outputs"]), rtol=0, atol=WAV_ATOL)


def test_mms_models_raise_before_any_fetch_naming_f35(tmp_path, monkeypatch):
    """The zoo's fairseq names are refused before anything is fetched or
    any directory made, naming F35, by ``TTS`` and by the manager."""
    monkeypatch.setenv("TTS_HOME", str(tmp_path))

    def no_fetch(url, *args, **kwargs):
        raise AssertionError(f"fetched {url}")

    monkeypatch.setattr(urllib.request, "urlretrieve", no_fetch)
    assert "F35" in manage.unported_reason(MMS, {})
    with pytest.raises(NotImplementedError, match="F35"):
        TTS(model_name=MMS, device="cpu")
    with pytest.raises(NotImplementedError, match="F35"):
        manage.ModelManager(output_prefix=str(tmp_path)).download_model(MMS)
    assert list(tmp_path.iterdir()) == []
