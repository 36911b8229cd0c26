"""Training losses of the spmel generator, in float32 (float64 for float64
inputs).

Counterparts of ``autovc_tpu/losses/__init__.py::mse`` and ``l1``: the
reconstruction MSE and the content L1 of the AutoVC objective. The SI-SDR
family of the wav variant is not ported yet.
"""

from __future__ import annotations

import torch


def _upcast(a: torch.Tensor, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    dt = torch.promote_types(torch.promote_types(a.dtype, b.dtype), torch.float32)
    return a.to(dt), b.to(dt)


def mse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = _upcast(a, b)
    return torch.mean((a - b) ** 2)


def l1(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = _upcast(a, b)
    return torch.mean(torch.abs(a - b))
