"""Building blocks of the AutoVC generator, over (B, T, C) tensors.

Counterparts of ``autovc_tpu/models/layers.py``. Public layout is the JAX
package's channels-last (B, T, C); convolutions transpose to PyTorch's
(B, C, T) around ``F.conv1d``. Parameter names and layouts are those that
``autovc_tpu_torch.io`` maps the JAX artifacts onto.

Every layer creates its parameters uninitialised; ``reset_parameters(gen)``
draws them from a ``torch.Generator`` (the JAX package's initialisers, for
seeded random weights), or a state dict is loaded over them.

``dtype`` is the compute dtype (float32 by default). The parameters stay
float32; in bfloat16 a layer casts its input, weights and bias at compute
time and rounds where the flax layer with ``dtype=jnp.bfloat16`` rounds:
the product (or convolution) once, then the bias added in bfloat16 (flax's
``Dense``/``Conv``, ``layers.LSTM``'s ``x @ w_ih + b``); BatchNorm takes
its statistics and normalises in float32 and rounds its output. The
gradients flow back through the same casts, so a parameter's gradient is
float32, summed from its bfloat16 products' gradients.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from autovc_tpu_torch.ops import lstm as lstm_ops

GAINS = {"linear": 1.0, "relu": math.sqrt(2.0), "tanh": 5.0 / 3.0}


def _bf16(dtype: torch.dtype) -> bool:
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"compute dtype is float32 or bfloat16, not {dtype}")
    return dtype == torch.bfloat16


class LinearNorm(nn.Module):
    """Dense layer, weight (out, in), xavier-uniform init."""

    def __init__(self, in_dim: int, out_dim: int, w_init_gain: str = "linear", dtype: torch.dtype = torch.float32):
        super().__init__()
        self.bf16 = _bf16(dtype)
        self.gain = GAINS[w_init_gain]
        self.weight = nn.Parameter(torch.empty(out_dim, in_dim))
        self.bias = nn.Parameter(torch.empty(out_dim))

    def reset_parameters(self, gen: torch.Generator) -> None:
        nn.init.xavier_uniform_(self.weight, self.gain, generator=gen)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.bf16:
            bf = torch.bfloat16
            return F.linear(x.to(bf), self.weight.to(bf)) + self.bias.to(bf)
        return F.linear(x, self.weight, self.bias)


class Conv(nn.Module):
    """flax's ``nn.Conv`` over (B, T, C) with explicit ``padding`` each side,
    ``stride`` and ``dilation``, and its default initialisers (the
    ConvTasNet front end's convolutions): a lecun-normal weight (a normal
    truncated at two standard deviations, variance 1 / fan_in) and a zero
    bias. Weight (out, in, k)."""

    def __init__(self, in_dim: int, out_dim: int, kernel_size: int, stride: int = 1, padding: int = 0,
                 dilation: int = 1, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.bf16 = _bf16(dtype)
        self.stride = stride
        self.padding = padding
        self.dilation = dilation
        self.weight = nn.Parameter(torch.empty(out_dim, in_dim, kernel_size))
        self.bias = nn.Parameter(torch.empty(out_dim))

    def reset_parameters(self, gen: torch.Generator) -> None:
        fan_in = self.weight.shape[1] * self.weight.shape[2]
        # the standard deviation of flax's truncated normal before its truncation
        std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
        nn.init.trunc_normal_(self.weight, 0.0, std, -2.0 * std, 2.0 * std, generator=gen)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        kw = dict(stride=self.stride, padding=self.padding, dilation=self.dilation)
        if self.bf16:
            bf = torch.bfloat16
            y = F.conv1d(x.to(bf).transpose(1, 2), self.weight.to(bf), **kw)
            return y.transpose(1, 2) + self.bias.to(bf)
        return F.conv1d(x.transpose(1, 2), self.weight, self.bias, **kw).transpose(1, 2)


class ConvNorm(Conv):
    """1-D conv over (B, T, C) with "same" padding for an odd kernel:
    ``dilation * (k - 1) / 2`` each side. Weight (out, in, k), xavier-uniform
    init."""

    def __init__(self, in_dim: int, out_dim: int, kernel_size: int, dilation: int = 1,
                 w_init_gain: str = "linear", dtype: torch.dtype = torch.float32):
        if kernel_size % 2 != 1:
            raise ValueError(f"ConvNorm needs an odd kernel, got {kernel_size}")
        super().__init__(in_dim, out_dim, kernel_size, padding=dilation * (kernel_size - 1) // 2, dilation=dilation,
                         dtype=dtype)
        self.gain = GAINS[w_init_gain]

    reset_parameters = LinearNorm.reset_parameters


class ConvTranspose1d(nn.Module):
    """Transposed 1-D conv over (B, T, C) with ``stride`` and ``padding``
    (``autovc_tpu/models/layers.py::ConvTranspose1d``, torch's
    ConvTranspose1d): output length (T - 1) * stride - 2 * padding + k.
    Weight (in, out, k) (``F.conv_transpose1d``; the JAX kernel is
    (k, out, in)); weight and bias uniform in +-1/sqrt(in * k)."""

    def __init__(self, in_dim: int, out_dim: int, kernel_size: int, stride: int = 1, padding: int = 0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.bf16 = _bf16(dtype)
        self.stride = stride
        self.padding = padding
        self.weight = nn.Parameter(torch.empty(in_dim, out_dim, kernel_size))
        self.bias = nn.Parameter(torch.empty(out_dim))

    def reset_parameters(self, gen: torch.Generator) -> None:
        bound = 1.0 / math.sqrt(self.weight.shape[0] * self.weight.shape[2])
        nn.init.uniform_(self.weight, -bound, bound, generator=gen)
        nn.init.uniform_(self.bias, -bound, bound, generator=gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.bf16:
            bf = torch.bfloat16
            y = F.conv_transpose1d(x.to(bf).transpose(1, 2), self.weight.to(bf), stride=self.stride,
                                   padding=self.padding)
            return y.transpose(1, 2) + self.bias.to(bf)
        y = F.conv_transpose1d(x.transpose(1, 2), self.weight, self.bias, stride=self.stride, padding=self.padding)
        return y.transpose(1, 2)


def prelu(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """``x`` where ``x >= 0``, else ``alpha * x`` (the JAX layer's
    ``jnp.where``: the gradient at 0 is that of the identity). A bfloat16
    ``x`` with the float32 slope gives float32, as JAX's type promotion
    does. ``train.compare.KinkTape`` replaces this function to record and
    replay the side of each element."""
    x = x.to(torch.promote_types(x.dtype, alpha.dtype))
    return torch.where(x >= 0, x, alpha * x)


class PReLU(nn.Module):
    """PReLU with one slope shared by every channel, initialised to 0.25
    (torch's ``nn.PReLU()``)."""

    def __init__(self):
        super().__init__()
        self.alpha = nn.Parameter(torch.empty(1))

    def reset_parameters(self, gen: torch.Generator) -> None:
        del gen
        nn.init.constant_(self.alpha, 0.25)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return prelu(x, self.alpha)


class BatchNorm(nn.Module):
    """Per-channel BatchNorm over (B, T, C), eps 1e-5, switched by
    ``module.train()``. In training form it normalises with the batch's
    statistics over (B, T), the two-pass biased variance ``mean((x - mean)^2)``
    of ``autovc_tpu/models/layers.py::BatchNorm`` (``use_fast_variance=False``),
    and moves the running statistics by momentum 0.1 toward the batch mean
    and the same biased variance, as flax does (``F.batch_norm`` would move
    the running variance toward the unbiased one). In eval form it uses the
    running statistics. In bfloat16 it computes the batch statistics from
    the input widened to float32 (the same two-pass variance; flax's
    ``_compute_stats`` with ``force_float32_reductions``), normalises in
    float32 and rounds the output (flax's ``_normalize``); the running
    statistics stay float32."""

    momentum = 0.1

    def __init__(self, channels: int, eps: float = 1e-5, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.bf16 = _bf16(dtype)
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
        if self.bf16:
            return self._normalize(x.float()).to(torch.bfloat16)
        return self._normalize(x)

    def _normalize(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            mean = x.mean(dim=(0, 1))
            var = ((x - mean) ** 2).mean(dim=(0, 1))
            with torch.no_grad():
                keep = 1.0 - self.momentum
                self.running_mean.copy_(keep * self.running_mean + self.momentum * mean)
                self.running_var.copy_(keep * self.running_var + self.momentum * var)
        else:
            mean, var = self.running_mean, self.running_var
        return (x - mean) * (self.weight * torch.rsqrt(var + self.eps)) + self.bias


class LSTM(nn.Module):
    """Multi-layer, optionally bidirectional LSTM over (B, T, C), zero initial
    state, differentiable (``ops.lstm.lstm_sequence`` goes through
    ``LSTMSequenceFn`` when grad is on). Per layer ``k`` and direction ``d`` in (fwd, bwd): ``w_ih_l{k}_{d}``
    (in, 4H), ``w_hh_l{k}_{d}`` (H, 4H), ``b_l{k}_{d}`` (4H,). The input product
    ``x @ w_ih + b`` is one matmul over all steps; the recurrence is
    ``ops.lstm.lstm_sequence``. Returns (B, T, H), or (B, T, 2H) with the
    forward features first. In bfloat16 the input product is rounded, then
    the bias added in bfloat16, and the recurrence takes bfloat16 xproj and
    w_hh, carries (h, c) in float32 and returns the sequence in bfloat16
    (``layers.LSTM`` with ``use_pallas=True`` in the JAX package); with
    ``scan=True`` it carries (h, c) in bfloat16 and rounds each gate op
    instead (``use_pallas=False``: ``_lstm_scan`` under ``jit``,
    ``ops.lstm.lstm_scan_bf16_train_ref``). ``dtype=None`` follows the
    input's dtype, as flax's ``dtype=None`` does: bfloat16 for a bfloat16
    input, float32 otherwise."""

    def __init__(self, in_dim: int, hidden: int, num_layers: int = 1, bidirectional: bool = False,
                 dtype: torch.dtype | None = torch.float32, scan: bool = False):
        super().__init__()
        self.bf16 = None if dtype is None else _bf16(dtype)
        self.scan = scan
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
        bf16 = x.dtype == torch.bfloat16 if self.bf16 is None else self.bf16
        h = x
        for layer in range(self.num_layers):
            # contiguous, the input product is one (B*T, C) product; a strided
            # h takes matmul's batched path, whose export (serve.py) guards
            # the batch against 1
            h = h.contiguous()
            outs = []
            for d in self.directions:
                w_ih = getattr(self, f"w_ih_l{layer}_{d}")
                w_hh = getattr(self, f"w_hh_l{layer}_{d}")
                b = getattr(self, f"b_l{layer}_{d}")
                if bf16:
                    bf = torch.bfloat16
                    xproj = torch.matmul(h.to(bf), w_ih.to(bf)) + b.to(bf)
                    w_hh = w_hh.to(bf)
                else:
                    xproj = torch.matmul(h, w_ih) + b
                if self.scan and bf16:
                    outs.append(lstm_ops.lstm_sequence(xproj, w_hh, reverse=(d == "bwd"), scan=True))
                else:
                    outs.append(lstm_ops.lstm_sequence(xproj, w_hh, reverse=(d == "bwd")))
            h = torch.cat(outs, dim=-1) if len(outs) > 1 else outs[0]
        return h


def reset_parameters(module: nn.Module, seed: int) -> None:
    """Draw the parameters of every layer of this file inside ``module`` from
    one seeded generator, in module order (on the CPU: move afterwards)."""
    gen = torch.Generator().manual_seed(seed)
    for m in module.modules():
        if isinstance(m, (LinearNorm, ConvNorm, Conv, ConvTranspose1d, PReLU, BatchNorm, LSTM)):
            m.reset_parameters(gen)
