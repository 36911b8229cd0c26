"""Hyperparameters of the spmel conversion path.

A copy of the fields this package reads from the JAX package's
``autovc_tpu/config.py`` (``ModelConfig`` and ``HiFiGANConfig``), with the
same defaults: the published AutoVC generator and the HiFi-GAN V1 vocoder.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class ModelConfig:
    """AutoVC generator widths. Only ``model_type='spmel'`` (80 mel bins) is
    ported so far."""

    model_type: str = "spmel"
    dim_neck: int = 32
    dim_emb: int = 256
    dim_pre: int = 512
    freq: int = 32  # bottleneck time-downsampling factor
    enc_channels: int = 512
    dec_lstm_dim: int = 1024
    postnet_channels: int = 512

    @property
    def n_bins(self) -> int:
        if self.model_type == "spmel":
            return 80
        raise ValueError(f"model_type {self.model_type!r} is not ported yet")


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
