"""The port's WavLM content encoder (``tts_tpu_torch.vc.modules.wavlm``) and
its converters (``utils.convert.wavlm_from_jax_params``,
``load_reference_wavlm``, ``reference_wavlm_state``) against the JAX
package's ``WavLM``, on the CPU.

The same weights go into both packages: flax parameters with every leaf
drawn (:func:`drawn_wavlm_params`: kernels N(0, 1/fan_in), biases
N(0, 0.1²), norm scales 1 + N(0, 0.1²), the relative-position table
N(0, 1), ``grep_a`` 1 + N(0, 0.1²)), carried into the port by
``wavlm_from_jax_params``. Three configs: the base style and the
WavLM-Large style of ``tests/test_convert_wavlm.py`` (the latter with 16
buckets and a maximum distance of 64, so that a 159-frame input reaches the
logarithmic and the saturated buckets) and the tiny one of
``tests/test_freevc.py``. Features agree within 5e-6 of their peak (fp32;
the two packages sum the same products in other orders).

Divergence from the JAX package, named in its test: ``load_wavlm`` reads
the reference ``.pt`` directly and writes nothing beside it, where the JAX
package writes a converted ``.msgpack`` there
(``test_load_wavlm_reads_the_reference_layout_and_writes_nothing``).
Kept as the JAX package has it: F43, ``normalize`` unread
(``test_f43_normalize_is_not_applied``).
"""

import torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import os

import jax
import numpy as np
import pytest
import torch

from tts_tpu.vc.modules import wavlm as jax_wavlm
from tts_tpu_torch.utils.convert import (
    fold_weight_norm,
    load_reference_wavlm,
    reference_wavlm_state,
    wavlm_from_jax_params,
)
from tts_tpu_torch.vc.modules import wavlm

FEATURE_TOL = 5e-6  # of the features' peak

BASE = dict(encoder_layers=2, encoder_embed_dim=32, encoder_ffn_embed_dim=64,
            encoder_attention_heads=4, conv_feature_layers=((24, 10, 5), (24, 3, 2), (24, 3, 2)),
            conv_pos=16, conv_pos_groups=4)
LARGE_STYLE = dict(BASE, extractor_mode="layer_norm", layer_norm_first=True,
                   relative_position_embedding=True, num_buckets=16, max_distance=64,
                   gru_rel_pos=True)
TINY = dict(encoder_layers=1, encoder_embed_dim=32, encoder_ffn_embed_dim=32,
            encoder_attention_heads=2,
            conv_feature_layers=((16, 10, 5), (16, 4, 4), (32, 4, 4), (32, 2, 2), (32, 2, 2)),
            conv_pos=8, conv_pos_groups=2)
CONFIGS = {"base": BASE, "large-style": LARGE_STYLE, "tiny": TINY}


def drawn_wavlm_params(cfg, samples: int = 3200, seed: int = 0):
    """Numpy flax params of the JAX ``WavLM`` for ``cfg`` (traced, never
    run) with every leaf drawn as the module docstring says."""
    model = jax_wavlm.WavLM(cfg)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), np.zeros((1, samples), np.float32))
    rs = np.random.RandomState(seed)

    def fill(path, leaf):
        name = getattr(path[-1], "key", "")
        z = rs.standard_normal(leaf.shape).astype(np.float32)
        if name == "kernel":
            return z / np.sqrt(np.prod(leaf.shape[:-1]))
        if name == "scale" or name == "grep_a":
            return 1 + 0.1 * z
        if name == "relative_attention_bias":
            return z
        return 0.1 * z

    return jax.tree_util.tree_map_with_path(fill, shapes)


def wav(batch: int = 2, samples: int = 3200, seed: int = 0) -> np.ndarray:
    return (0.3 * np.random.RandomState(seed).randn(batch, samples)).astype(np.float32)


def pair(kind: str, **overrides):
    """The JAX config, its params, and the port's ``WavLM`` on the same weights."""
    jax_cfg = jax_wavlm.WavLMConfig(**CONFIGS[kind], **overrides)
    params = drawn_wavlm_params(jax_cfg)
    port = wavlm.WavLM(wavlm.WavLMConfig(**CONFIGS[kind], **overrides))
    port.load_state_dict(wavlm_from_jax_params(params), strict=True)
    return jax_cfg, params, port.eval()


def jax_features(cfg, params, x, output_layer=None) -> np.ndarray:
    model = jax_wavlm.WavLM(cfg)
    fn = jax.jit(lambda p, w: model.apply(p, w, output_layer=output_layer))
    return np.asarray(fn(params, x))


def assert_features_close(got, want):
    assert got.shape == want.shape
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= FEATURE_TOL, f"features differ by {err:.3g} of their peak"


@pytest.mark.parametrize("kind", list(CONFIGS))
def test_wavlm_matches_jax(kind):
    cfg, params, port = pair(kind)
    x = wav()
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    want = jax_features(cfg, params, x)
    assert_features_close(got, want)
    assert got.shape[1] == {"base": 159, "large-style": 159, "tiny": 9}[kind]


@pytest.mark.parametrize("kind,layers", [("large-style", 1), ("base", 1), ("large-style", 0)])
def test_output_layer_matches_jax(kind, layers):
    """``output_layer`` stops after that many layers; a pre-LN model then
    skips its final layer norm, as the JAX module does."""
    cfg, params, port = pair(kind)
    x = wav(batch=1, seed=1)
    with torch.no_grad():
        got = port(torch.from_numpy(x), output_layer=layers).numpy()
        full = port(torch.from_numpy(x)).numpy()
    assert_features_close(got, jax_features(cfg, params, x, output_layer=layers))
    assert not np.allclose(got, full)


@pytest.mark.parametrize("T", [1, 7, 50, 159, 333])
@pytest.mark.parametrize("buckets,distance", [(16, 64), (320, 800), (320, 1280)])
def test_bucket_ids_equal_jax_as_integers(T, buckets, distance):
    """The relative-position bucket ids, computed in float64 on the host as
    the JAX package computes them, equal its ids exactly, on the device
    tensor the attention reads; the table is built once per length."""
    want = jax_wavlm._relative_position_buckets(T, buckets, distance)
    got = wavlm.bucket_ids(T, buckets, distance, torch.device("cpu"))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    assert wavlm.bucket_ids(T, buckets, distance, torch.device("cpu")) is got
    assert got.max().item() < buckets


def test_pos_bias_passes_down_ungated():
    """Layer 0 builds the raw ``[H, T, T]`` table from its
    ``relative_attention_bias`` and hands it down ungated; each layer gates
    its own copy."""
    _, _, port = pair("large-style")
    x = torch.from_numpy(wav(batch=1))
    seen = []
    for i in range(2):
        layer = getattr(port, f"layer_{i}")
        layer.register_forward_hook(lambda mod, args, out: seen.append((args[1], out[1])))
    with torch.no_grad():
        port(x)
    (in0, out0), (in1, out1) = seen
    assert in0 is None and out0 is in1 and out1 is in1
    table = port.layer_0.self_attn.relative_attention_bias
    ids = wavlm.bucket_ids(out0.shape[-1], 16, 64, torch.device("cpu"))
    torch.testing.assert_close(out0, table[ids].permute(2, 0, 1), rtol=0, atol=0)
    assert not hasattr(port.layer_1.self_attn, "relative_attention_bias")


def test_config_reads_the_reference_string_layers():
    cfg = {"conv_feature_layers": "[(512,10,5)] + [(512,3,2)] * 4 + [(512,2,2)] * 2",
           "encoder_layers": 24, "normalize": True, "dropout": 0.1}
    got = wavlm.WavLMConfig.from_checkpoint_cfg(cfg)
    want = jax_wavlm.WavLMConfig.from_checkpoint_cfg(cfg)
    assert got.__dict__ == want.__dict__
    assert got.conv_feature_layers == wavlm._CONV_LAYERS
    large = wavlm.wavlm_large_config()
    assert large.__dict__ == jax_wavlm.wavlm_large_config().__dict__
    assert wavlm.WavLMConfig.from_checkpoint_cfg(large.to_checkpoint_cfg()) == large


def test_load_wavlm_reads_the_reference_layout_and_writes_nothing(tmp_path, monkeypatch):
    """``load_wavlm()`` reads ``$TTS_HOME/wavlm/WavLM-Large.pt`` (here a
    large-style WavLM in the reference layout): its weights equal the
    carried params, the positional conv's weight norm folded per tap
    (``dim=2``; the generic ``dim=0`` fold gives another weight), and its
    features the port's on the carried params. Unlike the JAX package,
    which writes a converted ``.msgpack`` beside the ``.pt``, nothing is
    written."""
    cfg, params, port = pair("large-style")
    carried = port.state_dict()
    reference = reference_wavlm_state(carried)
    assert "encoder.pos_conv.0.weight_g" in reference and "mask_emb" in reference
    home = tmp_path / "home"
    (home / "wavlm").mkdir(parents=True)
    torch.save({"cfg": port.cfg.to_checkpoint_cfg(),
                "model": {k: torch.from_numpy(v) for k, v in reference.items()}},
               home / "wavlm" / "WavLM-Large.pt")
    monkeypatch.setenv("TTS_HOME", str(home))
    before = sorted(os.listdir(home / "wavlm"))

    loaded = wavlm.load_wavlm(device="cpu")
    assert sorted(os.listdir(home / "wavlm")) == before
    state = loaded.state_dict()
    assert set(state) == set(carried)
    for k, v in carried.items():
        torch.testing.assert_close(state[k], v, rtol=1e-6, atol=1e-7, msg=k)
    generic = fold_weight_norm({k[len("encoder.pos_conv.0."):]: v for k, v in reference.items()
                                if k.startswith("encoder.pos_conv.0.")})["weight"]
    assert np.abs(generic - carried["pos_conv.weight"].numpy()).max() > 1e-3
    x = wav(batch=1, seed=2)
    with torch.no_grad():
        got = loaded(torch.from_numpy(x)).numpy()
    assert_features_close(got, jax_features(cfg, params, x))
    cfg2, _ = load_reference_wavlm(str(home / "wavlm" / "WavLM-Large.pt"))
    assert cfg2 == port.cfg


def test_load_wavlm_without_the_file_names_its_path(tmp_path, monkeypatch):
    monkeypatch.setenv("TTS_HOME", str(tmp_path))
    with pytest.raises(FileNotFoundError, match=str(tmp_path / "wavlm" / "WavLM-Large.pt")):
        wavlm.load_wavlm(device="cpu")
    assert not (tmp_path / "wavlm").exists()


def test_f43_normalize_is_not_applied():
    """F43 (kept): ``normalize=True`` (WavLM-Large's) is read but never
    applied, in the JAX ``WavLM.__call__`` and in the port: the features
    are those of ``normalize=False``, not those of a layer-normalised wave."""
    cfg, params, port = pair("large-style", normalize=True)
    x = 0.5 + wav(batch=1, seed=3)  # an offset that a layer norm would remove
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
        normed = port(torch.nn.functional.layer_norm(torch.from_numpy(x), x.shape[-1:])).numpy()
    jax_cfg_off = jax_wavlm.WavLMConfig(**LARGE_STYLE, normalize=False)
    want = jax_features(cfg, params, x)
    np.testing.assert_array_equal(want, jax_features(jax_cfg_off, params, x))
    assert_features_close(got, want)
    assert np.abs(normed - got).max() > 1e-2 * np.abs(got).max()
