"""HiFi-GAN V1 generator: mel (B, T, 80) -> waveform (B, T * 256).

Counterpart of ``autovc_tpu/vocoder/hifigan.py``: Conv(k7) -> 4x [leaky ReLU,
transposed-conv upsample, mean of the multi-receptive-field resblocks] ->
leaky ReLU -> Conv(k7) -> tanh; leaky ReLU slope 0.1. The public layout is
the JAX package's (B, T, C); inside, the network runs PyTorch's (B, C, T), so
the waveform needs no transposes. Submodule names follow the JAX parameter
tree (``pre``, ``up{i}``, ``res{i}_{j}.conv{1,2}_{k}``, ``post``).

In bfloat16 (``HiFiGANVocoder(dtype=torch.bfloat16)``) the parameters and
the mel are cast to bfloat16 and the waveform back to float32, as
``bench.py:107-118`` and ``serve.py`` run the JAX generator; every
operation then rounds where flax's does on bfloat16 operands: each
(transposed) convolution once, then its bias added in bfloat16, and the
leaky ReLU's slope is bfloat16's 0.1. There is no Pallas kernel here: the
convolutions run on cuDNN (on the CPU, PyTorch's own).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from autovc_tpu_torch import exact_f32, resolve_device
from autovc_tpu_torch.config import HiFiGANConfig
from autovc_tpu_torch.io import hifigan_state_from_jax, load_artifact


def _conv(conv: nn.Conv1d | nn.ConvTranspose1d, x: torch.Tensor) -> torch.Tensor:
    """``conv(x)``; in bfloat16 the convolution rounded, then the bias
    added in bfloat16 (flax's two roundings; a fused bias rounds once)."""
    if x.dtype != torch.bfloat16:
        return conv(x)
    if isinstance(conv, nn.ConvTranspose1d):
        y = F.conv_transpose1d(x, conv.weight, None, conv.stride, conv.padding, conv.output_padding, conv.groups,
                               conv.dilation)
    else:
        y = conv._conv_forward(x, conv.weight, None)
    return y + conv.bias[:, None]


def _leaky(x: torch.Tensor, slope: float) -> torch.Tensor:
    """Leaky ReLU with the slope in x's dtype, as ``jax.nn.leaky_relu``
    takes a Python slope (0.1 is 0.10009765625 in bfloat16)."""
    return F.leaky_relu(x, float(torch.tensor(slope, dtype=x.dtype)))


class ResBlock1(nn.Module):
    """Three [leaky ReLU, dilated conv, leaky ReLU, conv] residual branches."""

    def __init__(self, channels: int, kernel: int, dilations: tuple[int, ...], slope: float = 0.1):
        super().__init__()
        self.slope = slope
        self.n = len(dilations)
        for i, d in enumerate(dilations):
            self.add_module(f"conv1_{i}", nn.Conv1d(channels, channels, kernel, dilation=d,
                                                    padding=d * (kernel - 1) // 2))
            self.add_module(f"conv2_{i}", nn.Conv1d(channels, channels, kernel,
                                                    padding=(kernel - 1) // 2))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n):
            h = _conv(getattr(self, f"conv1_{i}"), _leaky(x, self.slope))
            x = x + _conv(getattr(self, f"conv2_{i}"), _leaky(h, self.slope))
        return x


class HiFiGANGenerator(nn.Module):
    def __init__(self, cfg: HiFiGANConfig = HiFiGANConfig()):
        super().__init__()
        self.cfg = cfg
        ch = cfg.upsample_initial_channel
        self.pre = nn.Conv1d(cfg.in_channels, ch, 7, padding=3)
        for i, (rate, k) in enumerate(zip(cfg.upsample_rates, cfg.upsample_kernel_sizes)):
            self.add_module(f"up{i}", nn.ConvTranspose1d(ch, ch // 2, k, stride=rate,
                                                         padding=(k - rate) // 2))
            ch //= 2
            for j, (rk, rd) in enumerate(zip(cfg.resblock_kernel_sizes, cfg.resblock_dilations)):
                self.add_module(f"res{i}_{j}", ResBlock1(ch, rk, rd, cfg.leaky_relu_slope))
        self.post = nn.Conv1d(ch, 1, 7, padding=3)

    def reset_parameters(self, seed: int) -> None:
        """Every weight and bias from U(-1/sqrt(fan_in), 1/sqrt(fan_in)),
        drawn from one seeded generator."""
        gen = torch.Generator().manual_seed(seed)
        for m in self.modules():
            if isinstance(m, (nn.Conv1d, nn.ConvTranspose1d)):
                bound = 1.0 / math.sqrt(m.in_channels * m.kernel_size[0])
                nn.init.uniform_(m.weight, -bound, bound, generator=gen)
                nn.init.uniform_(m.bias, -bound, bound, generator=gen)

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        """mel (B, T, 80) -> waveform (B, T * prod(upsample_rates))."""
        c = self.cfg
        nres = len(c.resblock_kernel_sizes)
        h = _conv(self.pre, mel.transpose(1, 2))
        for i in range(len(c.upsample_rates)):
            h = _conv(getattr(self, f"up{i}"), _leaky(h, c.leaky_relu_slope))
            acc = getattr(self, f"res{i}_0")(h)
            for j in range(1, nres):
                acc = acc + getattr(self, f"res{i}_{j}")(h)
            h = acc / nres
        h = _conv(self.post, _leaky(h, c.leaky_relu_slope))
        return torch.tanh(h)[:, 0]


class HiFiGANVocoder:
    """The vocoder entry point: weights from an exported JAX artifact
    (``artifacts/hifigan.npz``) or drawn from ``seed``, on ``device``, run in
    ``dtype`` (float32, or bfloat16: the parameters cast once here)."""

    def __init__(self, cfg: HiFiGANConfig = HiFiGANConfig(), *, artifact: str | None = None,
                 device: str | torch.device = "cuda", seed: int = 0, dtype: torch.dtype = torch.float32):
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"HiFi-GAN runs in float32 or bfloat16, not {dtype}")
        self.cfg = cfg
        self.dtype = dtype
        self.device = resolve_device(device)
        model = HiFiGANGenerator(cfg)
        if artifact is None:
            model.reset_parameters(seed)
        else:
            model.load_state_dict(hifigan_state_from_jax(load_artifact(artifact)[0]))
        self.model = model.to(self.device, dtype).eval().requires_grad_(False)

    @classmethod
    def from_checkpoint(cls, cfg: HiFiGANConfig, path: str | None, *,
                        device: str | torch.device = "cuda", dtype: torch.dtype = torch.float32) -> "HiFiGANVocoder":
        """The JAX ``from_checkpoint(cfg, path)``: an exported ``.npz``
        artifact, or weights drawn from seed 0 when ``path`` is None. A torch
        checkpoint raises: its importer is not ported yet (ROADMAP Queue 1 #9)."""
        if path is not None and path.endswith((".pt", ".pth", ".ckpt")):
            raise ValueError(f"{path}: torch HiFi-GAN checkpoints do not load yet (ROADMAP Queue 1 #9); "
                             f"export an .npz artifact")
        return cls(cfg, artifact=path, device=device, dtype=dtype)

    @torch.inference_mode()
    def generate(self, mel: np.ndarray | torch.Tensor) -> torch.Tensor:
        """mel (T, 80) or (B, T, 80) -> waveform (T * 256,) or (B, T * 256),
        float32 on the vocoder's device (in bfloat16, the mel is rounded to
        bfloat16 first and the waveform's bfloat16 values returned)."""
        mel = torch.as_tensor(mel, dtype=torch.float32, device=self.device).to(self.dtype)
        squeeze = mel.ndim == 2
        with exact_f32(self.device):
            wav = self.model(mel[None] if squeeze else mel).float()
        return wav[0] if squeeze else wav
