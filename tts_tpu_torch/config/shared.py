"""Copied from ``tts_tpu/config/shared.py`` (the port imports nothing of ``tts_tpu``);
unchanged apart from this line and import paths.

Shared base configs mirroring the reference's ``TTS/config/shared_configs.py``.

Field names and defaults match ``BaseAudioConfig`` (reference
``shared_configs.py:9-154``), ``BaseDatasetConfig`` (``:192-234``) and
``BaseTrainingConfig`` (``:249-268``) so that reference JSON configs load
unchanged.  TPU-specific additions (mesh/sharding/precision) live in
:class:`BaseTrainingConfig` under clearly-named extra fields.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

from .base import Config

__all__ = [
    "BaseAudioConfig",
    "BaseDatasetConfig",
    "BaseTrainingConfig",
    "CharactersConfig",
    "BaseTTSConfig",
]


@dataclass
class CharactersConfig(Config):
    """Vocabulary definition (reference ``tts/configs/shared_configs.py:96``)."""

    characters_class: Optional[str] = None
    # using BaseVocabulary
    vocab_dict: Optional[dict] = None
    # using BaseCharacters
    pad: Optional[str] = None
    eos: Optional[str] = None
    bos: Optional[str] = None
    blank: Optional[str] = None
    characters: Optional[str] = None
    punctuations: Optional[str] = None
    phonemes: Optional[str] = None
    is_unique: bool = True
    is_sorted: bool = True


@dataclass
class BaseAudioConfig(Config):
    """Audio/DSP parameters (reference ``shared_configs.py:9-154``)."""

    # STFT
    fft_size: int = 1024
    win_length: int = 1024
    hop_length: int = 256
    frame_shift_ms: Optional[int] = None
    frame_length_ms: Optional[int] = None
    stft_pad_mode: str = "reflect"
    # audio
    sample_rate: int = 22050
    resample: bool = False
    preemphasis: float = 0.0
    ref_level_db: int = 20
    do_sound_norm: bool = False
    log_func: str = "np.log10"
    # silence trim
    do_trim_silence: bool = True
    trim_db: int = 45
    # rms volume norm
    do_rms_norm: bool = False
    db_level: Optional[float] = None
    # griffin-lim
    power: float = 1.5
    griffin_lim_iters: int = 60
    # mel
    num_mels: int = 80
    mel_fmin: float = 0.0
    mel_fmax: Optional[float] = None
    spec_gain: int = 20
    do_amp_to_db_linear: bool = True
    do_amp_to_db_mel: bool = True
    # f0
    pitch_fmax: float = 640.0
    pitch_fmin: float = 1.0
    # normalization
    signal_norm: bool = True
    min_level_db: int = -100
    symmetric_norm: bool = True
    max_norm: float = 4.0
    clip_norm: bool = True
    stats_path: Optional[str] = None


@dataclass
class BaseDatasetConfig(Config):
    """One dataset entry (reference ``shared_configs.py:192-234``)."""

    formatter: str = ""
    dataset_name: str = ""
    path: str = ""
    meta_file_train: str = ""
    ignored_speakers: Optional[List[str]] = None
    language: str = ""
    phonemizer: str = ""
    meta_file_val: str = ""
    meta_file_attn_mask: str = ""


@dataclass
class BaseTrainingConfig(Config):
    """Training-run parameters (reference ``shared_configs.py:249-268`` +
    the external coqui Trainer's ``TrainerConfig`` fields used throughout
    the reference recipes), plus TPU-native extras."""

    model: str = ""
    # run metadata
    run_name: str = "run"
    run_description: str = ""
    project_name: Optional[str] = None
    output_path: Optional[str] = None
    # loops
    epochs: int = 1000
    batch_size: int = 32
    eval_batch_size: int = 16
    run_eval: bool = True
    test_delay_epochs: int = 0
    print_step: int = 25
    plot_step: int = 100
    log_model_step: Optional[int] = None
    save_step: int = 10000
    save_n_checkpoints: int = 5
    save_checkpoints: bool = True
    save_best_after: int = 0
    save_all_best: bool = False
    print_eval: bool = False
    # optimization
    mixed_precision: bool = False
    precision: str = "bf16"  # TPU-native: "fp32" | "bf16"
    grad_clip: float = 0.0
    grad_accum_steps: int = 1
    # skip optimizer updates whose gradients contain NaN/Inf (reference
    # trainer ``check_update`` grad-norm guard); pure-XLA via
    # optax.apply_if_finite so the step stays a single compiled graph
    skip_non_finite_grads: bool = False
    lr: float = 0.001
    optimizer: str = "adamw"
    optimizer_params: dict = field(default_factory=dict)
    lr_scheduler: Optional[str] = None
    lr_scheduler_params: dict = field(default_factory=dict)
    scheduler_after_epoch: bool = True
    use_grad_scaler: bool = False
    # dataloading
    num_loader_workers: int = 0
    # "thread" (BLAS-parallel DSP) or "process" (GIL-free forked workers for
    # heavy text/F0 pipelines; reference uses torch DataLoader processes)
    loader_worker_mode: str = "thread"
    num_eval_loader_workers: int = 0
    use_noise_augment: bool = False
    shuffle: bool = True
    drop_last: bool = False
    # distributed / TPU mesh (replaces the reference's DDP fields)
    data_axis: int = -1  # -1 = all devices on the data axis
    model_axis: int = 1
    mesh_shape: Optional[List[int]] = None
    # logging
    dashboard_logger: str = "tensorboard"
    logger_uri: Optional[str] = None
    # data
    datasets: List[BaseDatasetConfig] = field(default_factory=list)
    # eval/test
    test_sentences: List = field(default_factory=list)
    eval_split_max_size: Optional[int] = None
    eval_split_size: float = 0.01
    # misc
    seed: int = 54321
    allow_tf32: bool = True  # unused on TPU; kept for config compat


@dataclass
class BaseTTSConfig(BaseTrainingConfig):
    """Shared TTS model config (reference ``tts/configs/shared_configs.py:168``):
    audio + text-frontend + dataloading + sampler fields common to all TTS
    models."""

    audio: BaseAudioConfig = field(default_factory=BaseAudioConfig)
    # text frontend
    use_phonemes: bool = False
    phonemizer: Optional[str] = None
    phoneme_language: Optional[str] = None
    compute_input_seq_cache: bool = False
    text_cleaner: Optional[str] = None
    enable_eos_bos_chars: bool = False
    test_sentences_file: str = ""
    phoneme_cache_path: Optional[str] = None
    characters: Optional[CharactersConfig] = None
    add_blank: bool = False
    # dataloading
    batch_group_size: int = 0
    loss_masking: Optional[bool] = None
    min_audio_len: int = 1
    max_audio_len: float = float("inf")
    min_text_len: int = 1
    max_text_len: float = float("inf")
    # static-shape bucket boundaries (XLA recompiles per distinct padded
    # shape; coarser multiples → fewer compiles, more padding compute)
    pad_to_multiple_text: int = 16
    pad_to_multiple_mel: int = 32
    compute_f0: bool = False
    compute_energy: bool = False
    compute_linear_spec: bool = False
    precompute_num_workers: int = 0
    start_by_longest: bool = False
    # optimizer defaults mirror the reference's BaseTTSConfig
    optimizer: str = "radam"
    optimizer_params: Optional[dict] = None
    lr_scheduler: Optional[str] = None
    lr_scheduler_params: dict = field(default_factory=dict)
    # weighted samplers
    use_speaker_weighted_sampler: bool = False
    speaker_weighted_sampler_alpha: float = 1.0
    use_language_weighted_sampler: bool = False
    language_weighted_sampler_alpha: float = 1.0
    use_length_weighted_sampler: bool = False
    length_weighted_sampler_alpha: float = 1.0
