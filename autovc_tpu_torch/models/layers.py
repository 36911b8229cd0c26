"""Building blocks of the AutoVC generator, over (B, T, C) tensors.

Counterparts of ``autovc_tpu/models/layers.py``. Public layout is the JAX
package's channels-last (B, T, C); convolutions transpose to PyTorch's
(B, C, T) around ``F.conv1d``. Parameter names and layouts are those that
``autovc_tpu_torch.io`` maps the JAX artifacts onto.

Every layer creates its parameters uninitialised; ``reset_parameters(gen)``
draws them from a ``torch.Generator`` (the JAX package's initialisers, for
seeded random weights), or a state dict is loaded over them.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from autovc_tpu_torch.ops import lstm as lstm_ops

GAINS = {"linear": 1.0, "relu": math.sqrt(2.0), "tanh": 5.0 / 3.0}


class LinearNorm(nn.Module):
    """Dense layer, weight (out, in), xavier-uniform init."""

    def __init__(self, in_dim: int, out_dim: int, w_init_gain: str = "linear"):
        super().__init__()
        self.gain = GAINS[w_init_gain]
        self.weight = nn.Parameter(torch.empty(out_dim, in_dim))
        self.bias = nn.Parameter(torch.empty(out_dim))

    def reset_parameters(self, gen: torch.Generator) -> None:
        nn.init.xavier_uniform_(self.weight, self.gain, generator=gen)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight, self.bias)


class ConvNorm(nn.Module):
    """1-D conv over (B, T, C) with "same" padding for an odd kernel:
    ``dilation * (k - 1) / 2`` each side. Weight (out, in, k)."""

    def __init__(self, in_dim: int, out_dim: int, kernel_size: int, dilation: int = 1,
                 w_init_gain: str = "linear"):
        super().__init__()
        if kernel_size % 2 != 1:
            raise ValueError(f"ConvNorm needs an odd kernel, got {kernel_size}")
        self.gain = GAINS[w_init_gain]
        self.dilation = dilation
        self.padding = dilation * (kernel_size - 1) // 2
        self.weight = nn.Parameter(torch.empty(out_dim, in_dim, kernel_size))
        self.bias = nn.Parameter(torch.empty(out_dim))

    reset_parameters = LinearNorm.reset_parameters

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv1d(x.transpose(1, 2), self.weight, self.bias,
                     padding=self.padding, dilation=self.dilation)
        return y.transpose(1, 2)


class BatchNorm(nn.Module):
    """Per-channel BatchNorm over (B, T, C) in inference form: running
    statistics, eps 1e-5. (Training, with the two-pass batch variance of
    ``autovc_tpu/models/layers.py::BatchNorm``, is not ported yet.)"""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(channels))
        self.bias = nn.Parameter(torch.empty(channels))
        self.register_buffer("running_mean", torch.empty(channels))
        self.register_buffer("running_var", torch.empty(channels))

    def reset_parameters(self, gen: torch.Generator) -> None:
        del gen
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)
        nn.init.zeros_(self.running_mean)
        nn.init.ones_(self.running_var)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        scale = self.weight * torch.rsqrt(self.running_var + self.eps)
        return (x - self.running_mean) * scale + self.bias


class LSTM(nn.Module):
    """Multi-layer, optionally bidirectional LSTM over (B, T, C), zero initial
    state. Per layer ``k`` and direction ``d`` in (fwd, bwd): ``w_ih_l{k}_{d}``
    (in, 4H), ``w_hh_l{k}_{d}`` (H, 4H), ``b_l{k}_{d}`` (4H,). The input product
    ``x @ w_ih + b`` is one matmul over all steps; the recurrence is
    ``ops.lstm.lstm_sequence``. Returns (B, T, H), or (B, T, 2H) with the
    forward features first."""

    def __init__(self, in_dim: int, hidden: int, num_layers: int = 1, bidirectional: bool = False):
        super().__init__()
        self.hidden = hidden
        self.num_layers = num_layers
        self.directions = ("fwd", "bwd") if bidirectional else ("fwd",)
        for layer in range(num_layers):
            layer_in = in_dim if layer == 0 else hidden * len(self.directions)
            for d in self.directions:
                self.register_parameter(f"w_ih_l{layer}_{d}", nn.Parameter(torch.empty(layer_in, 4 * hidden)))
                self.register_parameter(f"w_hh_l{layer}_{d}", nn.Parameter(torch.empty(hidden, 4 * hidden)))
                self.register_parameter(f"b_l{layer}_{d}", nn.Parameter(torch.empty(4 * hidden)))

    def reset_parameters(self, gen: torch.Generator) -> None:
        bound = 1.0 / math.sqrt(self.hidden)
        for p in self.parameters():
            nn.init.uniform_(p, -bound, bound, generator=gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        for layer in range(self.num_layers):
            outs = []
            for d in self.directions:
                w_ih = getattr(self, f"w_ih_l{layer}_{d}")
                w_hh = getattr(self, f"w_hh_l{layer}_{d}")
                b = getattr(self, f"b_l{layer}_{d}")
                xproj = torch.matmul(h, w_ih) + b
                outs.append(lstm_ops.lstm_sequence(xproj, w_hh, reverse=(d == "bwd")))
            h = torch.cat(outs, dim=-1) if len(outs) > 1 else outs[0]
        return h


def reset_parameters(module: nn.Module, seed: int) -> None:
    """Draw the parameters of every layer of this file inside ``module`` from
    one seeded generator, in module order (on the CPU: move afterwards)."""
    gen = torch.Generator().manual_seed(seed)
    for m in module.modules():
        if isinstance(m, (LinearNorm, ConvNorm, BatchNorm, LSTM)):
            m.reset_parameters(gen)
