"""The AutoVC generators (spmel/stft and wav), the GE2E d-vector speaker
encoder and their layers."""

from __future__ import annotations

import torch

from autovc_tpu_torch import resolve_device
from autovc_tpu_torch.config import COMPUTE_DTYPES, ModelConfig
from autovc_tpu_torch.io import dvector_state_from_jax, generator_state_from_jax, load_artifact
from autovc_tpu_torch.models.autovc import Decoder, Encoder, Generator, Postnet
from autovc_tpu_torch.models.convtas import ConvTasDecoder, ConvTasEncoder, GeneratorWav
from autovc_tpu_torch.models.dvector import DVector, dvector_for_params
from autovc_tpu_torch.models.layers import (LSTM, BatchNorm, Conv, ConvNorm, ConvTranspose1d, LinearNorm, PReLU,
                                            reset_parameters)


def build_generator(cfg: ModelConfig = ModelConfig(), *, artifact: str | None = None,
                    device: str | torch.device = "cuda", seed: int = 0,
                    trainable: bool = False) -> Generator | GeneratorWav:
    """The generator of ``cfg.model_type`` on ``device``: the ``Generator``
    at ``cfg.n_bins`` for spmel and stft, ``GeneratorWav`` for wav. Weights
    from an exported JAX artifact (``artifacts/generator_spmel_f16.npz``, or
    what ``cli.train --export`` writes), or drawn from ``seed`` when
    ``artifact`` is None. Frozen in eval mode, or, with ``trainable``, in
    train mode with gradients on. ``cfg.compute_dtype`` sets the compute
    dtype; the weights, their gradients and the BatchNorm statistics stay
    float32 in bfloat16 too; ``cfg.use_pallas_lstm`` picks the LSTMs'
    bfloat16 rounding (False: the scan's, True: the Pallas kernels')."""
    dev = resolve_device(device)
    dtype = COMPUTE_DTYPES[cfg.compute_dtype]
    scan = not cfg.use_pallas_lstm
    if cfg.model_type in ("spmel", "stft"):
        model = Generator(cfg.dim_neck, cfg.dim_emb, cfg.dim_pre, cfg.freq, cfg.n_bins,
                          cfg.enc_channels, cfg.dec_lstm_dim, cfg.postnet_channels, dtype, scan=scan)
    elif cfg.model_type == "wav":
        model = GeneratorWav(cfg.dim_neck, cfg.dim_emb, cfg.dim_pre, cfg.freq, cfg.convtas_depth,
                             cfg.convtas_channels, cfg.convtas_kernel, cfg.convtas_stride,
                             cfg.enc_channels, cfg.dec_lstm_dim, dtype, scan=scan)
    else:
        raise ValueError(f"unknown model_type {cfg.model_type!r}")
    if artifact is None:
        reset_parameters(model, seed)
    else:
        model.load_state_dict(generator_state_from_jax(load_artifact(artifact)[0]))
    model = model.to(dev)
    return model.train() if trainable else model.eval().requires_grad_(False)


def build_dvector(params=None, *, device: str | torch.device = "cuda", seed: int = 0,
                  **dims: int) -> DVector:
    """A frozen d-vector encoder in eval mode on ``device``: sized to and
    loaded from a GE2E parameter tree (numpy; ``train.ge2e.load_params``),
    or, when ``params`` is None, drawn from ``seed`` at ``dims`` (the
    ``DVector`` arguments; the reference's 80/768/256 x3 by default)."""
    dev = resolve_device(device)
    if params is None:
        model = DVector(**dims)
        model.reset_parameters(seed)
    else:
        model = dvector_for_params(params)
        model.load_state_dict(dvector_state_from_jax(params))
    return model.to(dev).eval().requires_grad_(False)


__all__ = [
    "BatchNorm",
    "Conv",
    "ConvNorm",
    "ConvTasDecoder",
    "ConvTasEncoder",
    "ConvTranspose1d",
    "DVector",
    "Decoder",
    "Encoder",
    "Generator",
    "GeneratorWav",
    "LSTM",
    "LinearNorm",
    "PReLU",
    "Postnet",
    "build_dvector",
    "build_generator",
    "dvector_for_params",
]
