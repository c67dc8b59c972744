"""Overflow and NeuralHMM-TTS inference (port of
``tts_tpu/models/overflow/model.py``, reference
``TTS/tts/models/{overflow,neuralhmm_tts}.py`` + ``layers/overflow/``):
``OverflowEncoder`` (embedding, conv blocks, a bidirectional LSTM giving
``state_per_phone`` states a token), ``Outputnet`` (memory and state →
mean, standard deviation and transition logit), ``NeuralHMMCore.sample``
(the autoregressive loop of prenet, memory ``LSTMCell`` and output net with
the stay/move rule), ``NeuralhmmTTSModule.inference`` (denormalisation by
``mel_statistics_mean/std``, and Overflow's Glow post-flow in reverse) and
the host wrappers ``NeuralhmmTTS`` and ``Overflow``.

The JAX ``sample`` scans all ``max_frames`` steps, evaluates the output
net on every state and picks the current one by a one-hot product; rows
are zeroed from the step at which they leave their last state. The port
gathers the current state's encoder row first and runs the output net on
that row alone (row by row the same function), and leaves once every row
is done, reading the rows' done flags back to the host every
:data:`DONE_CHECK_EVERY` steps: frames after a row's end are zeros in the
JAX package, so leaving early changes no valid frame. A decode whose
transitions never fire runs to ``max_frames``. ``transitions`` records the
current state's move probability at every step that ran.

The post-flow runs on the frames that ran, padded with zeros to a multiple
of ``num_squeeze``: its couplings see masked frames as zeros, so the valid
frames do not depend on how many padded frames follow. As in the JAX
package, ``squeeze`` takes each group's mask from its last frame, so the
last valid frame of an odd ``y_length`` leaves the flow as zero and the
denormalisation makes it ``mel_statistics_mean`` (ROADMAP.md F29). Frames
after ``y_lengths`` are ``mel_statistics_mean`` too.

Sampling follows the JAX defaults: the wrapper passes no temperature (the
means are emitted) and transitions are deterministic unless the config
says otherwise; a temperature above 0 and stochastic transitions draw from
an explicit ``torch.Generator``. F19: the prenet drops half its units at
inference when ``prenet_dropout_at_inference`` is set, masks from the same
generator; the JAX package never passes the flag and never drops.

The forward algorithm (the training likelihood) waits for the trainer
(ROADMAP.md item 17).
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import torch
import torch.nn as nn
from torch.nn.utils.rnn import pack_padded_sequence, pad_packed_sequence

from tts_tpu_torch import resolve_device
from tts_tpu_torch.layers.glow import ActNorm, GlowDecoder, InvConvNear
from tts_tpu_torch.layers.tacotron import ConvBNBlock, Prenet
from tts_tpu_torch.models.base import init_tokenizer
from tts_tpu_torch.ops.helpers import sequence_mask
from tts_tpu_torch.text.tokenizer import TTSTokenizer

from .config import NeuralhmmTTSConfig

PORT_WEIGHTS = "model_torch.pt"  # the port's state_dict of NeuralhmmTTSModule
REFERENCE_WEIGHTS = ("model_file.pth", "model.pth")  # reference-layout (coqui) checkpoints
FOLDED_NORM = "encoder.conv_0.weight"  # present when the conv blocks carry folded norms
OUTPUT_PROJECTION = "neural_hmm.output_net.proj.weight"  # absent from the reference layout

# decode steps between two reads of the rows' done flags: each read waits
# for the device, and a step costs less than that wait
DONE_CHECK_EVERY = 8


class OverflowEncoder(nn.Module):
    """Embedding, ``n_convolutions`` conv blocks and a bidirectional LSTM of
    ``half × state_per_phone`` units a direction (reference
    ``common_layers.py:12``), the output read as ``state_per_phone`` states
    of ``in_out_channels`` a token. The LSTM runs over a packed batch, so
    that the backward direction starts at each row's true end, as
    ``seq_lengths`` makes the JAX encoder's."""

    def __init__(self, num_chars: int, state_per_phone: int, in_out_channels: int = 512,
                 n_convolutions: int = 3, norm_type: str = "layer"):
        super().__init__()
        self.state_per_phone = state_per_phone
        self.n_convolutions = n_convolutions
        self.emb = nn.Embedding(num_chars, in_out_channels)
        for i in range(n_convolutions):
            self.add_module(f"conv_{i}", ConvBNBlock(in_out_channels, in_out_channels, 5, "relu",
                                                     norm_type))
        self.lstm = nn.LSTM(in_out_channels, in_out_channels // 2 * state_per_phone,
                            batch_first=True, bidirectional=True)

    def forward(self, x: torch.Tensor, x_lengths: torch.Tensor):
        """Token ids ``[B, T]`` → states ``[B, T·spp, C]`` and their counts
        ``x_lengths · spp``; states of padded tokens are zeros."""
        B, T = x.shape
        x_mask = sequence_mask(x_lengths, T)[:, :, None].float()
        h = self.emb(x)
        for i in range(self.n_convolutions):
            h = getattr(self, f"conv_{i}")(h * x_mask)
        packed = pack_padded_sequence(h * x_mask, x_lengths.cpu(), batch_first=True,
                                      enforce_sorted=False)
        o, _ = pad_packed_sequence(self.lstm(packed)[0], batch_first=True, total_length=T)
        return o.reshape(B, T * self.state_per_phone, -1), x_lengths * self.state_per_phone


class Outputnet(nn.Module):
    """(memory, state) → mean, standard deviation (at least ``std_floor``)
    and transition logit (reference ``common_layers.py:140``)."""

    def __init__(self, memory_channels: int, state_channels: int, frame_channels: int,
                 outputnet_size=(1024,), std_floor: float = 1e-2):
        super().__init__()
        self.frame_channels = frame_channels
        self.num_layers = len(outputnet_size)
        self.std_floor = std_floor
        sizes = (memory_channels + state_channels,) + tuple(outputnet_size)
        for i in range(self.num_layers):
            self.add_module(f"layer_{i}", nn.Linear(sizes[i], sizes[i + 1]))
        self.proj = nn.Linear(sizes[-1], 2 * frame_channels + 1)

    def forward(self, memory: torch.Tensor, states: torch.Tensor):
        """``memory [B, D_mem]`` with one state a row, ``states [B, D_enc]``
        → ``(mean, std, transition)``."""
        h = torch.cat([memory, states], dim=-1)
        for i in range(self.num_layers):
            h = torch.relu(getattr(self, f"layer_{i}")(h))
        out = self.proj(h)
        C = self.frame_channels
        std = torch.clamp(nn.functional.softplus(out[..., C:2 * C]), min=self.std_floor)
        return out[..., :C], std, out[..., -1]


class NeuralHMMCore(nn.Module):
    """The autoregressive memory and the output net of the neural HMM."""

    def __init__(self, frame_channels: int, state_channels: int, memory_rnn_dim: int,
                 prenet_dim: int, prenet_n_layers: int, prenet_dropout: float,
                 prenet_dropout_at_inference: bool, outputnet_size, std_floor: float):
        super().__init__()
        self.frame_channels = frame_channels
        self.memory_rnn_dim = memory_rnn_dim
        self.prenet = Prenet(frame_channels, (prenet_dim,) * prenet_n_layers,
                             prenet_dropout=prenet_dropout > 0,
                             dropout_at_inference=prenet_dropout_at_inference)
        self.memory_rnn = nn.LSTMCell(prenet_dim, memory_rnn_dim)
        self.output_net = Outputnet(memory_rnn_dim, state_channels, frame_channels,
                                    outputnet_size, std_floor)

    def sample(self, inputs: torch.Tensor, state_lengths: torch.Tensor, max_frames: int = 1000,
               sampling_temp: float = 0.0, duration_threshold: float = 0.43,
               deterministic_transition: bool = True,
               generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """Frames from the states ``inputs [B, N, C]`` (reference
        ``neural_hmm.py:386``): ``mels [B, steps, C]`` (zero from each row's
        end), ``y_lengths [B]`` (at least 1) and ``transitions [B, steps]``,
        the current state's move probability at each step that ran."""
        B, N, _ = inputs.shape
        dev = inputs.device
        h = inputs.new_zeros(B, self.memory_rnn_dim)
        c = inputs.new_zeros(B, self.memory_rnn_dim)
        prev = inputs.new_zeros(B, self.frame_channels)
        state = torch.zeros(B, dtype=torch.long, device=dev)
        done = torch.zeros(B, dtype=torch.bool, device=dev)
        rows = torch.arange(B, device=dev)
        frames, valid, moves = [], [], []
        for step in range(max_frames):
            h, c = self.memory_rnn(self.prenet(prev, generator), (h, c))
            mean, std, trans = self.output_net(h, inputs[rows, state.clamp(max=N - 1)])
            frame = mean
            if sampling_temp > 0:
                noise = torch.randn(mean.shape, generator=generator, device=dev)
                frame = mean + sampling_temp * std * noise
            p_move = torch.sigmoid(trans)
            if deterministic_transition:
                move = p_move > duration_threshold
            else:
                move = torch.rand(p_move.shape, generator=generator, device=dev) < p_move
            state = torch.where(move & ~done, state + 1, state)
            done = done | (state >= state_lengths)
            frames.append(frame)
            valid.append(~done)
            moves.append(p_move)
            prev = frame
            if (step + 1) % DONE_CHECK_EVERY == 0 and bool(done.all()):
                break
        valid = torch.stack(valid, 1)
        return {"mels": torch.stack(frames, 1) * valid[:, :, None],
                "y_lengths": valid.sum(1).clamp(min=1), "transitions": torch.stack(moves, 1)}


class NeuralhmmTTSModule(nn.Module):
    """The NeuralHMM network; with ``use_post_flow``, Overflow's."""

    def __init__(self, config: NeuralhmmTTSConfig, use_post_flow: bool = False):
        super().__init__()
        c = self.config = config
        self.use_post_flow = use_post_flow
        self.encoder = OverflowEncoder(c.num_chars, c.state_per_phone, c.encoder_in_out_features,
                                       c.encoder_n_convolutions, getattr(c, "norm_type", "layer"))
        self.neural_hmm = NeuralHMMCore(
            c.out_channels, c.encoder_in_out_features, c.memory_rnn_dim, c.prenet_dim,
            c.prenet_n_layers, c.prenet_dropout, c.prenet_dropout_at_inference,
            tuple(c.outputnet_size), c.std_floor)
        if use_post_flow:
            self.decoder = GlowDecoder(c.out_channels, c.hidden_channels_dec, c.kernel_size_dec,
                                       c.dilation_rate, c.num_flow_blocks_dec, c.num_block_layers,
                                       c.num_splits, c.num_squeeze, c.sigmoid_scale)

    def inference(self, text, text_lengths, max_frames: int = 400, sampling_temp: float = 0.0,
                  generator: Optional[torch.Generator] = None) -> Dict[str, Any]:
        """Token ids → ``model_outputs [B, T, C]`` (``T`` the steps that ran,
        rounded up to a multiple of ``num_squeeze`` with the post-flow) with
        ``y_lengths`` and ``transitions``."""
        c = self.config
        enc, state_lengths = self.encoder(text, text_lengths)
        out = self.neural_hmm.sample(enc, state_lengths, max_frames, sampling_temp,
                                     c.duration_threshold, c.deterministic_transition, generator)
        mels, y_lengths = out["mels"], out["y_lengths"]
        if self.use_post_flow:
            n = c.num_squeeze
            pad = -mels.shape[1] % n
            mels = nn.functional.pad(mels, (0, 0, 0, pad))
            y_mask = sequence_mask(y_lengths, mels.shape[1])[:, :, None].float()
            mels = self.decoder(mels, y_mask, reverse=True)[0]
        return {"model_outputs": mels * c.mel_statistics_std + c.mel_statistics_mean,
                "y_lengths": y_lengths, "transitions": out["transitions"]}


class _HMMBase:
    """Host wrapper: tokenizer and weights around :class:`NeuralhmmTTSModule`."""

    use_post_flow = False
    # inference() returns a mel for a vocoder or Griffin-Lim, not a waveform
    emits_waveform = False

    def __init__(self, config: NeuralhmmTTSConfig):
        self.config = config
        self.module = NeuralhmmTTSModule(config, self.use_post_flow)
        self.tokenizer: Optional[TTSTokenizer] = None

    @classmethod
    def init_from_config(cls, config: NeuralhmmTTSConfig):
        """Tokenizer and model for ``config``; the embedding has the
        vocabulary's size when ``num_chars`` is ``None`` (a smaller one
        raises, ROADMAP.md F7)."""
        tokenizer, config = init_tokenizer(config)
        model = cls(config)
        model.tokenizer = tokenizer
        return model

    @property
    def device(self) -> torch.device:
        return self.module.encoder.emb.weight.device

    @property
    def hop_length(self) -> int:
        return int(self.config.audio.hop_length)

    # ------------------------------------------------------------------
    @torch.no_grad()
    def init_params(self, seed: int = 0, device="cuda"):
        """Random fp32 weights from ``seed``, drawn on the CPU (the same on
        every machine), then moved to ``device``: linear, conv and LSTM
        weights N(0, 1/fan_in), biases 0, norm scales 1 and shifts 0, the
        token embedding N(0, 0.3²), each ``InvConvNear`` an orthogonal
        matrix; the flow's leaves that the JAX package starts at zero
        (``ActNorm``, each coupling's ``end``) at a tenth of their scale."""
        device = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        module = self.module.to_empty(device="cpu")
        for name, p in module.named_parameters():
            owner_name, leaf = name.rsplit(".", 1)
            owner = module.get_submodule(owner_name)
            fan_in = p[0].numel() if p.dim() > 1 else 1
            if isinstance(owner, (nn.LayerNorm, ConvBNBlock)):
                p.fill_(1.0 if leaf == "weight" else 0.0)
            elif isinstance(owner, InvConvNear):
                p.copy_(torch.linalg.qr(torch.randn(p.shape, generator=gen))[0])
            elif isinstance(owner, ActNorm) or owner_name.endswith(".end"):
                p.copy_(torch.randn(p.shape, generator=gen) * 0.1 / fan_in**0.5)
            elif leaf.startswith("bias"):
                p.zero_()
            elif isinstance(owner, nn.Embedding):
                p.copy_(torch.randn(p.shape, generator=gen) * 0.3)
            else:
                p.copy_(torch.randn(p.shape, generator=gen) / fan_in**0.5)
        self.module.to(device).requires_grad_(False)
        return self

    def load_state_dict(self, state: Dict[str, torch.Tensor]) -> None:
        """Take the tensors as they are (strict: no key missing or extra).
        The module is built anew (on the meta device) when the state's conv
        blocks carry another ``norm_type`` than the module's; the config
        takes that ``norm_type``."""
        norm_type = "folded" if FOLDED_NORM in state else "layer"
        built = "folded" if hasattr(self.module.encoder.conv_0, "weight") else "layer"
        self.config.norm_type = norm_type
        if norm_type != built:
            with torch.device("meta"):
                self.module = NeuralhmmTTSModule(self.config, self.use_post_flow)
        self.module.load_state_dict(state, strict=True, assign=True)
        self.module.requires_grad_(False)

    def load_checkpoint(self, config: NeuralhmmTTSConfig, checkpoint_dir: Optional[str] = None,
                        checkpoint_path: Optional[str] = None, device="cuda"):
        """Weights from a file: the port's state_dict of
        :class:`NeuralhmmTTSModule` (``model_torch.pt``, the mel statistics
        from the config) or a reference-layout checkpoint (``model_file.pth``
        or ``model.pth``: its BatchNorms folded, ``norm_type`` set to
        ``"folded"`` and ``mel_statistics_mean/std`` taken from its
        ``mean``/``std``, as the JAX package's zoo conversion does).
        ``checkpoint_dir`` looks for those names in turn."""
        device = resolve_device(device)
        if checkpoint_path is None:
            for name in (PORT_WEIGHTS,) + REFERENCE_WEIGHTS:
                if os.path.isfile(os.path.join(checkpoint_dir, name)):
                    checkpoint_path = os.path.join(checkpoint_dir, name)
                    break
            else:
                raise FileNotFoundError(f"No model weights in {checkpoint_dir} (need "
                                        f"{PORT_WEIGHTS} or one of {REFERENCE_WEIGHTS})")
        state = torch.load(checkpoint_path, map_location="cpu", weights_only=True)
        if isinstance(state, dict) and "model" in state:
            state = state["model"]
        if OUTPUT_PROJECTION not in state:
            from tts_tpu_torch.utils.convert import load_reference_overflow

            state = load_reference_overflow(state, self.config)
        self.load_state_dict({k: v.to(device) for k, v in state.items()})
        return self

    # ------------------------------------------------------------------
    def inference(self, x, x_lengths, max_frames: int = 400, aux_input: Optional[Dict] = None,
                  generator: Optional[torch.Generator] = None,
                  sampling_temp: float = 0.0) -> Dict[str, Any]:
        """Text ids → mel (:meth:`NeuralhmmTTSModule.inference`) within
        ``max_frames``. Where the decode draws (``sampling_temp`` above 0,
        stochastic transitions, the prenet's dropout at inference), it
        draws from ``generator``, seeded 0 on the model's device when none
        is passed. The model takes no speaker: ``aux_input`` is ignored, as
        in the JAX package."""
        c = self.config
        draws = sampling_temp > 0 or not c.deterministic_transition or (
            c.prenet_dropout_at_inference and c.prenet_dropout > 0)
        if draws and generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        return self.module.inference(x, x_lengths, max_frames=max_frames,
                                     sampling_temp=sampling_temp, generator=generator)


class NeuralhmmTTS(_HMMBase):
    """(reference ``models/neuralhmm_tts.py:23``)"""

    use_post_flow = False


class Overflow(_HMMBase):
    """(reference ``models/overflow.py:24``)"""

    use_post_flow = True
