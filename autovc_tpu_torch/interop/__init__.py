"""Importers of the reference's torch checkpoints into the JAX package's
parameter trees, which the weight bridge (``autovc_tpu_torch.io``) loads into
the port's modules."""

from autovc_tpu_torch.interop.hifigan_import import hifigan_params_from_torch
from autovc_tpu_torch.interop.wavenet_import import wavenet_params_from_torch
from autovc_tpu_torch.interop.torch_import import (
    convert_lstm,
    convert_conv,
    convert_linear,
    convert_bn,
    generator_params_from_torch,
    generator_wav_params_from_torch,
    dvector_params_from_torch,
)

__all__ = [
    "convert_lstm",
    "convert_conv",
    "convert_linear",
    "convert_bn",
    "generator_params_from_torch",
    "generator_wav_params_from_torch",
    "dvector_params_from_torch",
    "wavenet_params_from_torch",
    "hifigan_params_from_torch",
]
