"""The AutoVC content-bottleneck generator (spmel), over (B, T, C) tensors.

Counterpart of ``autovc_tpu/models/autovc.py``: ``Encoder``, ``Decoder``,
``Postnet`` and ``Generator`` with the same submodule names. ``train()``
mode is the JAX ``train=True``: BatchNorm normalises with the batch's
statistics and updates its running ones, also in ``encode``, the content
re-encoding of the training loss; ``eval()`` mode uses the running
statistics.

``dtype`` is the compute dtype of every layer (``models.layers``); in
bfloat16 the outputs are bfloat16, as the JAX Generator's with
``dtype=jnp.bfloat16``, and ``scan`` picks the LSTMs' bfloat16 rounding:
True (``ModelConfig.use_pallas_lstm=False``) JAX's ``lax.scan``'s, False its
Pallas kernels' (``layers.LSTM``). Where JAX concatenates a bfloat16 tensor with a
float32 embedding the result is float32 (its type promotion); ``_cat``
gives ``torch.cat`` the promoted dtype explicitly. The next layer rounds
the embedding to bfloat16 either way.
"""

from __future__ import annotations

import torch
from torch import nn

from autovc_tpu_torch.models.layers import BatchNorm, ConvNorm, LinearNorm, LSTM


def _cat(seq: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
    """(B, T, C) and an embedding (B, E) broadcast over T, concatenated in
    their promoted dtype."""
    b, t, _ = seq.shape
    dt = torch.promote_types(seq.dtype, emb.dtype)
    return torch.cat([seq.to(dt), emb.to(dt)[:, None, :].expand(b, t, emb.shape[-1])], dim=-1)


class Encoder(nn.Module):
    """(B, T, n_bins) + speaker embedding (B, dim_emb) -> codes
    (B, T // freq, 2 * dim_neck)."""

    def __init__(self, dim_neck: int = 32, freq: int = 32, n_bins: int = 80,
                 dim_emb: int = 256, channels: int = 512, dtype: torch.dtype = torch.float32, *, scan: bool):
        super().__init__()
        self.dim_neck = dim_neck
        self.freq = freq
        for i in range(3):
            self.add_module(f"conv{i}", ConvNorm(n_bins + dim_emb if i == 0 else channels,
                                                 channels, 5, w_init_gain="relu", dtype=dtype))
            self.add_module(f"bn{i}", BatchNorm(channels, dtype=dtype))
        self.blstm = LSTM(channels, dim_neck, num_layers=2, bidirectional=True, dtype=dtype, scan=scan)

    def forward(self, x: torch.Tensor, c_org: torch.Tensor) -> torch.Tensor:
        b, t, _ = x.shape
        if t % self.freq:
            raise ValueError(f"sequence length {t} is not a multiple of freq {self.freq}")
        h = _cat(x, c_org)
        for i in range(3):
            h = torch.relu(getattr(self, f"bn{i}")(getattr(self, f"conv{i}")(h)))
        out = self.blstm(h)
        # Per block of freq steps: the forward state at the block's end and
        # the backward state at its start. The contiguous output is viewed
        # as blocks before it is sliced, so that under torch.export
        # (``autovc_tpu_torch.serve``) no size of the batch or of T is
        # guarded on.
        blocks = out.reshape(b, t // self.freq, self.freq, 2 * self.dim_neck)
        return torch.cat([blocks[:, :, -1, : self.dim_neck], blocks[:, :, 0, self.dim_neck :]], dim=-1)


class Decoder(nn.Module):
    """(B, T, 2 * dim_neck + dim_emb) -> (B, T, n_bins)."""

    def __init__(self, in_dim: int = 320, n_bins: int = 80, dim_pre: int = 512, lstm_dim: int = 1024,
                 dtype: torch.dtype = torch.float32, *, scan: bool):
        super().__init__()
        self.lstm1 = LSTM(in_dim, dim_pre, num_layers=1, dtype=dtype, scan=scan)
        for i in range(3):
            self.add_module(f"conv{i}", ConvNorm(dim_pre, dim_pre, 5, w_init_gain="relu", dtype=dtype))
            self.add_module(f"bn{i}", BatchNorm(dim_pre, dtype=dtype))
        self.lstm2 = LSTM(dim_pre, lstm_dim, num_layers=2, dtype=dtype, scan=scan)
        self.proj = LinearNorm(lstm_dim, n_bins, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.lstm1(x)
        for i in range(3):
            h = torch.relu(getattr(self, f"bn{i}")(getattr(self, f"conv{i}")(h)))
        return self.proj(self.lstm2(h))


class Postnet(nn.Module):
    """Five convs: tanh after the first four BatchNormed ones, the last linear."""

    def __init__(self, n_bins: int = 80, channels: int = 512, dtype: torch.dtype = torch.float32):
        super().__init__()
        for i in range(5):
            self.add_module(f"conv{i}", ConvNorm(n_bins if i == 0 else channels,
                                                 n_bins if i == 4 else channels, 5,
                                                 w_init_gain="linear" if i == 4 else "tanh", dtype=dtype))
            self.add_module(f"bn{i}", BatchNorm(n_bins if i == 4 else channels, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        for i in range(5):
            h = getattr(self, f"bn{i}")(getattr(self, f"conv{i}")(h))
            if i < 4:
                h = torch.tanh(h)
        return h


class Generator(nn.Module):
    """forward(x, c_org, c_trg) -> (x_identic, x_identic_psnt, codes_flat):
    decoder output (B, T, n_bins), the same plus the postnet residual, and the
    content codes flattened to (B, T // freq * 2 * dim_neck)."""

    def __init__(self, dim_neck: int = 32, dim_emb: int = 256, dim_pre: int = 512,
                 freq: int = 32, n_bins: int = 80, enc_channels: int = 512,
                 dec_lstm_dim: int = 1024, postnet_channels: int = 512, dtype: torch.dtype = torch.float32, *,
                 scan: bool):
        super().__init__()
        self.dtype = dtype
        self.encoder = Encoder(dim_neck, freq, n_bins, dim_emb, enc_channels, dtype, scan=scan)
        self.decoder = Decoder(2 * dim_neck + dim_emb, n_bins, dim_pre, dec_lstm_dim, dtype, scan=scan)
        self.postnet = Postnet(n_bins, postnet_channels, dtype)

    def encode(self, x: torch.Tensor, c_org: torch.Tensor) -> torch.Tensor:
        codes = self.encoder(x, c_org)
        return codes.reshape(codes.shape[0], -1)

    def decode(self, codes: torch.Tensor, c_trg: torch.Tensor, t: int) -> tuple[torch.Tensor, torch.Tensor]:
        """codes (B, nb, 2 * dim_neck) + target embedding -> (x_identic,
        x_identic_psnt) over t = nb * freq steps (each code repeated freq
        times: a constant, which torch.export keeps provable)."""
        if t != codes.shape[1] * self.encoder.freq:
            raise ValueError(f"{t} steps are not {codes.shape[1]} blocks of freq {self.encoder.freq}")
        dec_in = _cat(codes.repeat_interleave(self.encoder.freq, dim=1), c_trg)
        x_identic = self.decoder(dec_in)
        return x_identic, x_identic + self.postnet(x_identic)

    def forward(self, x: torch.Tensor, c_org: torch.Tensor, c_trg: torch.Tensor):
        codes = self.encoder(x, c_org)
        x_identic, x_psnt = self.decode(codes, c_trg, x.shape[1])
        return x_identic, x_psnt, codes.reshape(codes.shape[0], -1)
