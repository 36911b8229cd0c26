"""GE2E d-vector speaker encoder (reference model_bl.py:5-20).

Counterpart of ``autovc_tpu/models/dvector.py``: a unidirectional LSTM of
``num_layers`` layers over mel frames (``layers.LSTM``, so the recurrence is
the CUDA kernel on a card and the plain loop on the CPU), a dense layer on
the last step's hidden state, and ``e / ||e||`` with no epsilon. Its dtype
follows its input, as JAX's ``DVector(dtype=None)``: a bfloat16 input (the
bfloat16 generator's conversion in the lambda_spk auxiliary) runs the LSTMs
in bfloat16 with the scan rounding (``layers.LSTM(scan=True)``: JAX runs
``_lstm_scan``, never Pallas, here) and the dense layer in float32. Used frozen
to build speaker embeddings and to score conversions; embeddings are always
computed from mel features, whatever the generator's model type.

Parameter names follow the JAX tree: ``lstm.w_ih_l{k}_fwd`` (in, 4H),
``lstm.w_hh_l{k}_fwd`` (H, 4H), ``lstm.b_l{k}_fwd`` (4H,), and
``embedding.kernel`` (dim_cell, dim_emb), ``embedding.bias`` (dim_emb,),
the dense layer kept in the JAX ``(in, out)`` layout.
"""

from __future__ import annotations

import math
import warnings
from typing import Mapping

import torch
from torch import nn

from autovc_tpu_torch.config import SpeakerEncoderConfig
from autovc_tpu_torch.models.layers import LSTM


class Dense(nn.Module):
    """``x @ kernel + bias`` with the kernel (in, out), as flax's Dense with
    ``dtype=None``: input and parameters promoted to their common dtype
    (``promote_dtype``; float32 for a bfloat16 input and float32
    parameters) before the product."""

    def __init__(self, in_dim: int, out_dim: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(in_dim, out_dim))
        self.bias = nn.Parameter(torch.empty(out_dim))

    def reset_parameters(self, gen: torch.Generator) -> None:
        # flax's default: lecun_normal (a normal truncated at two standard
        # deviations, rescaled to variance 1 / fan_in), zero bias
        std = math.sqrt(1.0 / self.kernel.shape[0]) / 0.87962566103423978
        nn.init.trunc_normal_(self.kernel, 0.0, std, -2 * std, 2 * std, generator=gen)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = torch.promote_types(x.dtype, self.kernel.dtype)
        return torch.matmul(x.to(dt), self.kernel.to(dt)) + self.bias.to(dt)


class DVector(nn.Module):
    def __init__(self, dim_input: int = SpeakerEncoderConfig.dim_input, dim_cell: int = SpeakerEncoderConfig.dim_cell,
                 dim_emb: int = SpeakerEncoderConfig.dim_emb, num_layers: int = SpeakerEncoderConfig.num_layers):
        super().__init__()
        self.dim_input, self.dim_cell, self.dim_emb, self.num_layers = dim_input, dim_cell, dim_emb, num_layers
        self.lstm = LSTM(dim_input, dim_cell, num_layers, dtype=None, scan=True)
        self.embedding = Dense(dim_cell, dim_emb)

    def reset_parameters(self, seed: int) -> None:
        """Draw the weights from ``seed`` (on the CPU: move afterwards)."""
        gen = torch.Generator().manual_seed(seed)
        self.lstm.reset_parameters(gen)
        self.embedding.reset_parameters(gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, T, dim_input) mel crops -> (B, dim_emb) unit vectors."""
        e = self.embedding(self.lstm(x)[:, -1])
        return e / torch.linalg.vector_norm(e, dim=-1, keepdim=True)


def dvector_for_params(params: Mapping) -> DVector:
    """A DVector sized to a checkpoint's parameter tree (numpy leaves): a
    GE2E tree (``{'dvector', 'w', 'b'}``) or bare DVector params. The
    embedding kernel is (dim_cell, dim_emb), the layer-0 input kernel
    (dim_input, 4*dim_cell), and layers are counted from the ``w_ih_l{k}_fwd``
    entries. A tree it cannot read gives the reference defaults
    (model_bl.py:42, ``SpeakerEncoderConfig``) with a warning."""
    p = params.get("dvector", params)
    try:
        k = p["embedding"]["kernel"]
        lstm = p["lstm"]
        return DVector(
            dim_input=int(lstm["w_ih_l0_fwd"].shape[0]),
            dim_cell=int(k.shape[0]),
            dim_emb=int(k.shape[1]),
            num_layers=sum(1 for n in lstm if n.startswith("w_ih_l")),
        )
    except (KeyError, TypeError, AttributeError) as e:
        d = SpeakerEncoderConfig()
        warnings.warn(
            f"dvector_for_params: checkpoint tree not understood ({e!r}); falling back to reference-default "
            f"DVector dims ({d.dim_input}/{d.dim_cell}/{d.dim_emb} x{d.num_layers})",
            stacklevel=2,
        )
        return DVector()
