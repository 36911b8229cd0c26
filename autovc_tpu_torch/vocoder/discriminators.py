"""HiFi-GAN discriminators: multi-period (MPD, periods 2, 3, 5, 7, 11) and
multi-scale (MSD, 3 scales), with the LSGAN and feature-matching losses.

Counterpart of ``autovc_tpu/vocoder/discriminators.py``, as ``nn.Module``s
on PyTorch's convolutions (cuDNN on a card; no Pallas kernel in JAX). The
waveform is (B, T); the features are kept in PyTorch's (B, C, ...) layout,
which the L1 feature-matching loss does not see, and the scores are
flattened in the JAX order (time, then period). Parameter names follow the
JAX tree (``mpd{p}.conv{i}``, ``mpd{p}.post``, ``msd{i}.conv{j}``,
``msd{i}.post``); ``io.hifigan_state_from_jax`` and
``io.conv_state_to_jax`` carry flax's kernels ``(kh, kw, in, out)`` and
``(k, in, out)`` both ways.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

SLOPE = 0.1
MPD_CHANNELS = (32, 128, 512, 1024, 1024)  # conv0..conv4 of a period discriminator
MSD_SPECS = ((128, 15, 1), (128, 41, 2), (256, 41, 2), (512, 41, 4), (1024, 41, 4), (1024, 5, 1))


def _lecun_(conv: nn.Module, gen: torch.Generator) -> None:
    """flax's Conv initialisers: a normal truncated at two standard
    deviations, variance 1 / fan_in, and a zero bias."""
    fan_in = conv.weight[0].numel()
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(conv.weight, 0.0, std, -2.0 * std, 2.0 * std, generator=gen)
    nn.init.zeros_(conv.bias)


class PeriodDiscriminator(nn.Module):
    """The waveform reflect-padded to a multiple of ``period``, folded to
    (B, 1, T/p, p), and 2-D (5, 1) convolutions over it, of ``channels``
    (the published widths by default; narrower ones for tests)."""

    def __init__(self, period: int, channels: tuple[int, ...] = MPD_CHANNELS):
        super().__init__()
        self.period = period
        ch_in = 1
        for i, ch in enumerate(channels[:4]):
            self.add_module(f"conv{i}", nn.Conv2d(ch_in, ch, (5, 1), stride=(3, 1), padding=(2, 0)))
            ch_in = ch
        self.conv4 = nn.Conv2d(ch_in, channels[4], (5, 1), padding=(2, 0))
        self.post = nn.Conv2d(channels[4], 1, (3, 1), padding=(1, 0))

    def forward(self, y: torch.Tensor) -> tuple[torch.Tensor, list[torch.Tensor]]:
        b, t = y.shape
        pad = (-t) % self.period
        if pad:
            y = F.pad(y[:, None], (0, pad), mode="reflect" if t > 1 else "constant")[:, 0]
        h = y.reshape(b, 1, (t + pad) // self.period, self.period)
        feats = []
        for i in range(5):
            h = F.leaky_relu(getattr(self, f"conv{i}")(h), SLOPE)
            feats.append(h)
        return self.post(h).reshape(b, -1), feats


class ScaleDiscriminator(nn.Module):
    """A 1-D conv stack (``specs``: channels, kernel, stride a layer;
    MSD_SPECS by default) on the waveform."""

    def __init__(self, specs: tuple[tuple[int, int, int], ...] = MSD_SPECS):
        super().__init__()
        self.n = len(specs)
        ch_in = 1
        for i, (ch, k, s) in enumerate(specs):
            self.add_module(f"conv{i}", nn.Conv1d(ch_in, ch, k, stride=s, padding=k // 2))
            ch_in = ch
        self.post = nn.Conv1d(ch_in, 1, 3, padding=1)

    def forward(self, y: torch.Tensor) -> tuple[torch.Tensor, list[torch.Tensor]]:
        h = y[:, None]
        feats = []
        for i in range(self.n):
            h = F.leaky_relu(getattr(self, f"conv{i}")(h), SLOPE)
            feats.append(h)
        return self.post(h).reshape(y.shape[0], -1), feats


def avg_pool(y: torch.Tensor, k: int = 4, s: int = 2) -> torch.Tensor:
    """flax's ``avg_pool(window k, stride s, padding="SAME")`` over (B, T):
    ceil(T / s) outputs, the zeros padded in (1 and 1 at an even T, 1 and 2
    at an odd one, for k=4, s=2) counted in every window's mean."""
    t = y.shape[-1]
    out = -(-t // s)
    total = max((out - 1) * s + k - t, 0)
    padded = F.pad(y[:, None], (total // 2, total - total // 2))
    return F.avg_pool1d(padded, k, s)[:, 0]


class HiFiGANDiscriminators(nn.Module):
    """MPD (``periods``) and MSD (3 scales: the waveform, then twice pooled),
    at the published widths unless ``mpd_channels`` and ``msd_specs`` say
    otherwise."""

    def __init__(self, periods: tuple[int, ...] = (2, 3, 5, 7, 11), mpd_channels: tuple[int, ...] = MPD_CHANNELS,
                 msd_specs: tuple[tuple[int, int, int], ...] = MSD_SPECS):
        super().__init__()
        self.periods = periods
        for p in periods:
            self.add_module(f"mpd{p}", PeriodDiscriminator(p, mpd_channels))
        for i in range(3):
            self.add_module(f"msd{i}", ScaleDiscriminator(msd_specs))

    def reset_parameters(self, seed: int) -> None:
        """flax's initialisers from one seeded generator, in module order."""
        gen = torch.Generator().manual_seed(seed)
        for m in self.modules():
            if isinstance(m, (nn.Conv1d, nn.Conv2d)):
                _lecun_(m, gen)

    def forward(self, y: torch.Tensor) -> tuple[list[torch.Tensor], list[list[torch.Tensor]]]:
        """y (B, T) -> (the score vectors, the feature lists), MPD first."""
        scores, feats = [], []
        for p in self.periods:
            s, f = getattr(self, f"mpd{p}")(y)
            scores.append(s)
            feats.append(f)
        h = y
        for i in range(3):
            s, f = getattr(self, f"msd{i}")(h)
            scores.append(s)
            feats.append(f)
            h = avg_pool(h)
        return scores, feats


def discriminator_loss(real_scores, fake_scores) -> torch.Tensor:
    """LSGAN: real -> 1, fake -> 0."""
    loss = 0.0
    for r, f in zip(real_scores, fake_scores):
        loss = loss + torch.mean((r - 1.0) ** 2) + torch.mean(f ** 2)
    return loss


def generator_adversarial_loss(fake_scores) -> torch.Tensor:
    """LSGAN: fake -> 1."""
    loss = 0.0
    for f in fake_scores:
        loss = loss + torch.mean((f - 1.0) ** 2)
    return loss


def feature_matching_loss(real_feats, fake_feats) -> torch.Tensor:
    """The sum over every feature map of the mean absolute difference."""
    loss = 0.0
    for rf, ff in zip(real_feats, fake_feats):
        for r, f in zip(rf, ff):
            loss = loss + torch.mean(torch.abs(r - f))
    return loss
