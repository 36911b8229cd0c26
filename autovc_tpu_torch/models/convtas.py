"""The ConvTasNet-style waveform front and back end and the raw-waveform
AutoVC generator (the 'wav' variant), over (B, T, C) tensors.

Counterpart of ``autovc_tpu/models/convtas.py``, with the same submodule
names. The front end strides the waveform (B, L, 1) into a latent
(B, T, channels) at the mel frame rate (kernel 1024, stride 256, the STFT's
window and hop); the back end transposes it back to (B, (T - 1) * 256 + 1024,
1). The AutoVC core (``models.autovc.Encoder`` and ``Decoder`` at
``n_bins = channels``, no postnet) runs between them.

In bfloat16 each convolution rounds as flax's with ``dtype=jnp.bfloat16``,
and each PReLU, whose slope is float32, returns float32 (JAX's promotion),
so the BatchNorm after it takes a float32 input and rounds its output.
"""

from __future__ import annotations

import torch
from torch import nn

from autovc_tpu_torch.models.autovc import Decoder, Encoder, _cat
from autovc_tpu_torch.models.layers import BatchNorm, Conv, ConvTranspose1d, PReLU


class ConvTasEncoder(nn.Module):
    """Waveform (B, L, 1) -> latent (B, (L - kernel) // stride + 1, channels):
    a strided convolution, then ``depth`` x [conv (k 3, pad 1), PReLU,
    BatchNorm]."""

    def __init__(self, depth: int = 1, channels: int = 512, kernel: int = 1024, stride: int = 256,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.depth = depth
        self.conv_in = Conv(1, channels, kernel, stride=stride, dtype=dtype)
        for i in range(depth):
            self.add_module(f"conv{i}", Conv(channels, channels, 3, padding=1, dtype=dtype))
            self.add_module(f"prelu{i}", PReLU())
            self.add_module(f"bn{i}", BatchNorm(channels, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv_in(x)
        for i in range(self.depth):
            h = getattr(self, f"bn{i}")(getattr(self, f"prelu{i}")(getattr(self, f"conv{i}")(h)))
        return h


class ConvTasDecoder(nn.Module):
    """Latent (B, T, channels) -> waveform (B, (T - 1) * stride + kernel, 1):
    ``depth`` x [transposed conv (k 3, stride 1, pad 1), PReLU, BatchNorm],
    then the transposed convolution of ``kernel`` at ``stride`` to one
    channel."""

    def __init__(self, depth: int = 1, channels: int = 512, kernel: int = 1024, stride: int = 256,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.depth = depth
        for i in range(depth):
            self.add_module(f"convT{i}", ConvTranspose1d(channels, channels, 3, padding=1, dtype=dtype))
            self.add_module(f"prelu{i}", PReLU())
            self.add_module(f"bn{i}", BatchNorm(channels, dtype=dtype))
        self.convT_out = ConvTranspose1d(channels, 1, kernel, stride=stride, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        for i in range(self.depth):
            h = getattr(self, f"bn{i}")(getattr(self, f"prelu{i}")(getattr(self, f"convT{i}")(h)))
        return self.convT_out(h)


class GeneratorWav(nn.Module):
    """Raw-waveform AutoVC. ``forward(x, c_org, c_trg)`` with x (B, L, 1)
    returns ``(x_latent, x_identic, x_decoder, codes_flat)``: the front
    end's latent (B, T, C), the reconstructed waveform (B, L, 1), the core
    decoder's output (B, T, C), the target of the latent loss, and the
    content codes (B, T // freq * 2 * dim_neck). ``encode(x, c_org)`` takes
    a waveform and gives the flattened codes (the content-consistency
    branch)."""

    def __init__(self, dim_neck: int = 32, dim_emb: int = 256, dim_pre: int = 512, freq: int = 32,
                 depth: int = 1, channels: int = 512, kernel: int = 1024, stride: int = 256,
                 enc_channels: int = 512, dec_lstm_dim: int = 1024, dtype: torch.dtype = torch.float32, *,
                 scan: bool):
        super().__init__()
        self.dtype = dtype
        self.tas_encoder = ConvTasEncoder(depth, channels, kernel, stride, dtype)
        self.encoder = Encoder(dim_neck, freq, channels, dim_emb, enc_channels, dtype, scan=scan)
        self.decoder = Decoder(2 * dim_neck + dim_emb, channels, dim_pre, dec_lstm_dim, dtype, scan=scan)
        self.tas_decoder = ConvTasDecoder(depth, channels, kernel, stride, dtype)

    def _latent(self, x: torch.Tensor) -> torch.Tensor:
        if x.ndim != 3 or x.shape[-1] != 1:
            raise ValueError(f"GeneratorWav expects a waveform (B, L, 1), got {tuple(x.shape)}")
        return self.tas_encoder(x)

    def encode(self, x: torch.Tensor, c_org: torch.Tensor) -> torch.Tensor:
        codes = self.encoder(self._latent(x), c_org)
        return codes.reshape(codes.shape[0], -1)

    def forward(self, x: torch.Tensor, c_org: torch.Tensor, c_trg: torch.Tensor):
        lat = self._latent(x)
        t = lat.shape[1]
        codes = self.encoder(lat, c_org)
        dec_in = _cat(codes.repeat_interleave(t // codes.shape[1], dim=1), c_trg)
        x_decoder = self.decoder(dec_in)
        return lat, self.tas_decoder(x_decoder), x_decoder, codes.reshape(codes.shape[0], -1)
