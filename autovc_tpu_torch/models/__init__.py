"""AutoVC generator and its layers."""

from __future__ import annotations

import torch

from autovc_tpu_torch import resolve_device
from autovc_tpu_torch.config import ModelConfig
from autovc_tpu_torch.io import generator_state_from_jax, load_artifact
from autovc_tpu_torch.models.autovc import Decoder, Encoder, Generator, Postnet
from autovc_tpu_torch.models.layers import LSTM, BatchNorm, ConvNorm, LinearNorm, reset_parameters


def build_generator(cfg: ModelConfig = ModelConfig(), *, artifact: str | None = None,
                    device: str | torch.device = "cuda", seed: int = 0,
                    trainable: bool = False) -> Generator:
    """The generator for ``cfg`` on ``device``: weights from an exported JAX
    artifact (``artifacts/generator_spmel_f16.npz``), or drawn from ``seed``
    when ``artifact`` is None. Frozen in eval mode, or, with ``trainable``,
    in train mode with gradients on."""
    dev = resolve_device(device)
    model = Generator(cfg.dim_neck, cfg.dim_emb, cfg.dim_pre, cfg.freq, cfg.n_bins,
                      cfg.enc_channels, cfg.dec_lstm_dim, cfg.postnet_channels)
    if artifact is None:
        reset_parameters(model, seed)
    else:
        model.load_state_dict(generator_state_from_jax(load_artifact(artifact)[0]))
    model = model.to(dev)
    return model.train() if trainable else model.eval().requires_grad_(False)


__all__ = [
    "BatchNorm",
    "ConvNorm",
    "Decoder",
    "Encoder",
    "Generator",
    "LSTM",
    "LinearNorm",
    "Postnet",
    "build_generator",
]
