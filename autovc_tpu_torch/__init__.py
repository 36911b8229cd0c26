"""autovc_tpu_torch: the PyTorch/CUDA port of autovc_tpu.

The JAX package ``autovc_tpu`` is the reference; this package computes the
same functions with PyTorch on an NVIDIA GPU, and with hand-written CUDA
kernels where the JAX package had a Pallas kernel. It imports neither JAX
nor anything of ``autovc_tpu``.

Ported so far: spmel conversion inference, mel (B, T, 80) -> AutoVC
``Generator`` -> HiFi-GAN -> waveform (B, T*256).

    config     ModelConfig / HiFiGANConfig (the slice's fields)
    io         artifact loading and JAX-tree -> state-dict mapping
    ops        kernels with their plain PyTorch versions (ops.lstm)
    models     layers and the AutoVC generator
    vocoder    HiFi-GAN
    convert    pad_seq and the Converter entry point

Entry points take ``device=`` and default to ``"cuda"``; without a card they
raise. Pass ``device="cpu"`` to run the plain PyTorch versions on the CPU.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The device an entry point runs on; raises when CUDA is asked for and
    there is no card (there is no silent CPU fallback)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU"
        )
    return dev
