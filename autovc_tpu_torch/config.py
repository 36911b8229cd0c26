"""Hyperparameters of the ported paths.

A copy of the fields this package reads from the JAX package's
``autovc_tpu/config.py`` (``AudioConfig``, ``ModelConfig``,
``SpeakerEncoderConfig``, ``TrainConfig``, ``Config``, ``WaveNetConfig`` and
``HiFiGANConfig``), with the same defaults: the feature contract of the
reference's make_spect.py, the published AutoVC generator and its training
contract, the GE2E d-vector speaker encoder, the r9y9 WaveNet vocoder and the
HiFi-GAN V1 vocoder.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass(frozen=True)
class AudioConfig:
    """Audio/feature contract (reference make_spect.py:21-27,51,82-86)."""

    sample_rate: int = 16_000
    n_fft: int = 1024
    hop_length: int = 256
    win_length: int = 1024
    n_mels: int = 80
    mel_fmin: float = 90.0
    mel_fmax: float = 7600.0
    # Butterworth highpass used to remove drifting noise (make_spect.py:30-34)
    highpass_cutoff_hz: float = 30.0
    highpass_order: int = 5
    # dB normalization: clip((20*log10(max(1e-5, .)) - ref + 100)/100, 0, 1)
    min_level_db: float = -100.0
    ref_level_db: float = 16.0
    # dither amplitude applied after the highpass (make_spect.py:76)
    dither_scale: float = 0.96
    dither_amp: float = 1e-6
    # RobustScaler quantile range for the raw-waveform variant (make_spect.py:88)
    robust_quantile_range: tuple[float, float] = (5.0, 95.0)
    # the legacy 512-pt pipeline ("old code/make_spect_old.py":19) -> 257 bins
    legacy_n_fft: int = 512

    @property
    def n_stft_bins(self) -> int:
        return self.n_fft // 2 + 1  # 513

    @property
    def n_legacy_bins(self) -> int:
        return self.legacy_n_fft // 2 + 1  # 257


@dataclass(frozen=True)
class ModelConfig:
    """AutoVC generator family widths. ``model_type`` selects the variant:
    'spmel' (80-bin mel autoencoder), 'stft' (513-bin magnitude-STFT
    autoencoder, the same generator at ``n_bins`` 513) or 'wav' (the
    raw-waveform generator: the AutoVC core between a ConvTasNet front end,
    a strided convolution of ``convtas_kernel`` samples at
    ``convtas_stride`` to ``convtas_channels`` channels and ``convtas_depth``
    conv + PReLU + BatchNorm blocks, and the mirrored transposed-convolution
    back end).

    ``compute_dtype`` is ``"float32"`` or ``"bfloat16"``, as in
    ``autovc_tpu/config.py``: in bfloat16 the products and convolutions run
    on bfloat16 operands while the parameters stay float32, cast at compute
    time, in inference and in training (the parameters, Adam's state and
    the losses float32). ``use_pallas_lstm`` picks which of the JAX
    package's two bfloat16 LSTMs the Generator's recurrences round as, with
    JAX's field name and default: False (the default), its ``lax.scan``
    (``_lstm_scan``: h and c carried in bfloat16, every gate op rounded; the
    CUDA kernels' scan forms), or True, its Pallas kernels (a float32 carry,
    the hidden sequence stored in bfloat16; the CUDA kernels' bfloat16
    forms). In float32 both run the same float32 kernels, as JAX's float32
    scan and Pallas kernel compute the same arithmetic."""

    model_type: str = "spmel"
    dim_neck: int = 32
    dim_emb: int = 256
    dim_pre: int = 512
    freq: int = 32  # bottleneck time-downsampling factor
    # ConvTasNet front/back end of the wav variant (model_vc_wav.py:21,44)
    convtas_depth: int = 1
    convtas_channels: int = 512
    convtas_kernel: int = 1024
    convtas_stride: int = 256
    enc_channels: int = 512
    dec_lstm_dim: int = 1024
    postnet_channels: int = 512
    compute_dtype: str = "float32"
    use_pallas_lstm: bool = False

    def __post_init__(self):
        if self.compute_dtype not in COMPUTE_DTYPES:
            raise ValueError(f"compute_dtype is one of {sorted(COMPUTE_DTYPES)}, not {self.compute_dtype!r}")

    @property
    def n_bins(self) -> int:
        """Feature width entering and leaving the AutoVC core."""
        if self.model_type == "spmel":
            return 80
        if self.model_type == "stft":
            return 513
        if self.model_type == "wav":
            return self.convtas_channels
        raise ValueError(f"unknown model_type: {self.model_type!r}")


@dataclass(frozen=True)
class HiFiGANConfig:
    """HiFi-GAN V1 generator. The upsample rates multiply to the hop, 256."""

    in_channels: int = 80
    upsample_initial_channel: int = 512
    upsample_rates: tuple[int, ...] = (8, 8, 2, 2)
    upsample_kernel_sizes: tuple[int, ...] = (16, 16, 4, 4)
    resblock_kernel_sizes: tuple[int, ...] = (3, 7, 11)
    resblock_dilations: tuple[tuple[int, ...], ...] = ((1, 3, 5), (1, 3, 5), (1, 3, 5))
    leaky_relu_slope: float = 0.1


@dataclass(frozen=True)
class WaveNetConfig:
    """WaveNet vocoder (r9y9 wavenet_vocoder): scalar input, 24 dilated-conv
    layers in 4 stacks (kernel 3, dilations 1..32), mixture-of-logistics
    output (10 mixtures), 80-mel conditioning upsampled x256 by transposed
    convs (scales 4, 4, 4, 4, freq kernel 3)."""

    out_channels: int = 30  # 10 logistic mixtures * (pi, mu, log_s)
    layers: int = 24
    stacks: int = 4
    residual_channels: int = 512
    gate_channels: int = 512  # split into tanh/sigmoid halves
    skip_channels: int = 256
    kernel_size: int = 3
    cin_channels: int = 80
    upsample_scales: tuple[int, ...] = (4, 4, 4, 4)
    freq_axis_kernel_size: int = 3
    log_scale_min: float = -32.23619130191664
    sample_rate: int = 16_000
    hop_size: int = 256  # = prod(upsample_scales): samples per mel frame

    @property
    def layers_per_stack(self) -> int:
        return self.layers // self.stacks

    def dilations(self) -> tuple[int, ...]:
        return tuple(2 ** (i % self.layers_per_stack) for i in range(self.layers))


@dataclass(frozen=True)
class SpeakerEncoderConfig:
    """GE2E d-vector encoder (reference model_bl.py:5-11, make_metadata.py:41).

    The Solver reads ``num_uttrs`` from ``Config.speaker``; the other fields
    are the one home of the defaults that ``DVector``, ``dvector_for_params``,
    ``embed_speaker``, ``eval.SpeakerEmbedder`` and ``train.step.windowed_embed``
    take (a checkpoint's own widths override the dims where one is loaded)."""

    dim_input: int = 80
    dim_cell: int = 768
    dim_emb: int = 256
    num_layers: int = 3
    num_uttrs: int = 10  # utterances averaged per speaker (make_metadata.py:21)
    len_crop: int = 128  # crop length fed to the encoder (make_metadata.py:23)


@dataclass(frozen=True)
class TrainConfig:
    """The training contract of the JAX ``TrainConfig``, with its defaults."""

    lambda_cd: float = 1.0
    lambda_sisnr: float = 1.0  # the wav variant's SI-SNR term
    batch_size: int = 2
    num_iters: int = 10_000_000
    len_crop: int = 128  # 128 frames for spmel/stft; 33536 samples for wav
    lr: float = 1e-4
    lr_scheduler: str | None = None  # None | 'Cosine' | 'CosineDecay' | 'Plateau'
    cosine_t_max: int = 10_000
    cosine_eta_min_ratio: float = 0.01  # CosineDecay: anneal to this fraction of lr
    plateau_factor: float = 0.1
    plateau_patience: int = 10
    # speaker-consistency auxiliary: within-batch cross-conversions are
    # re-embedded by a frozen GE2E encoder (spk_ckpt); 0.0 is the reference
    # objective. 'windowed' embeds the converted crop with the evaluation's
    # windowed protocol and puts a hinge at spk_margin on cos(e, target
    # centroid) - cos(e, source centroid); 'crop' is the single-window cosine
    # pull toward the conditioning embedding
    lambda_spk: float = 0.0
    spk_ckpt: str | None = None
    spk_protocol: str = "windowed"  # 'windowed' | 'crop'
    spk_margin: float = 1.5
    ema_decay: float = 0.9999  # a real per-step EMA
    log_step: int = 100
    checkpoint_step: int = 100
    watch_step: int = 0  # param/grad histograms every N steps; 0 disables
    seed: int = 0
    data_parallel: int = 1
    model_parallel: int = 1


@dataclass(frozen=True)
class Config:
    """Top-level config tree of the training and serving paths."""

    audio: AudioConfig = field(default_factory=AudioConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    speaker: SpeakerEncoderConfig = field(default_factory=SpeakerEncoderConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    hifigan: HiFiGANConfig = field(default_factory=HiFiGANConfig)
    main_dir: str = "."
    run_name: str = "run"
    run_id: str | None = None


def wav_len_crop(audio: AudioConfig, frames: int = 128) -> int:
    """The waveform crop whose ConvTasNet latent has ``frames`` frames:
    (frames - 1) * hop + win, 33536 for the defaults (reference main.py:59)."""
    return (frames - 1) * audio.hop_length + audio.win_length
