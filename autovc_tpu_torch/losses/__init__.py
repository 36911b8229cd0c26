"""Training losses of the generator family, in float32 (float64 for float64
inputs).

Counterparts of ``autovc_tpu/losses/__init__.py``: the reconstruction MSE
and the content L1 of the AutoVC objective, and the negative SDR family
(snr, sisdr, sdsdr; asteroid's sisdr_loss.py) with the ``EPS`` stabilizer,
whose SI-SNR form without zero-meaning is the wav variant's training term.
"""

from __future__ import annotations

import torch

EPS = 1e-8


def _upcast(a: torch.Tensor, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    dt = torch.promote_types(torch.promote_types(a.dtype, b.dtype), torch.float32)
    return a.to(dt), b.to(dt)


def mse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = _upcast(a, b)
    return torch.mean((a - b) ** 2)


def l1(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = _upcast(a, b)
    return torch.mean(torch.abs(a - b))


def neg_sdr(est: torch.Tensor, target: torch.Tensor, sdr_type: str = "sisdr", zero_mean: bool = True,
            take_log: bool = True, reduction: str = "mean") -> torch.Tensor:
    """Negative (SI-)SDR of (B, L) waveforms (sisdr_loss.py:58-86):
    ``sdr_type`` 'snr', 'sisdr' or 'sdsdr'; a scalar with ``reduction``
    'mean', else one value a row (B,)."""
    if sdr_type not in ("snr", "sisdr", "sdsdr"):
        raise ValueError(f"sdr_type is snr, sisdr or sdsdr, not {sdr_type!r}")
    if est.shape != target.shape:
        raise ValueError(f"estimate {tuple(est.shape)} and target {tuple(target.shape)} differ in shape")
    est, target = _upcast(est, target)
    if zero_mean:
        target = target - target.mean(dim=1, keepdim=True)
        est = est - est.mean(dim=1, keepdim=True)
    if sdr_type in ("sisdr", "sdsdr"):
        dot = torch.sum(est * target, dim=1, keepdim=True)
        s_energy = torch.sum(target**2, dim=1, keepdim=True) + EPS
        scaled_target = dot * target / s_energy
    else:
        scaled_target = target
    e_noise = est - target if sdr_type in ("sdsdr", "snr") else est - scaled_target
    ratio = torch.sum(scaled_target**2, dim=1) / (torch.sum(e_noise**2, dim=1) + EPS)
    losses = 10.0 * torch.log10(ratio + EPS) if take_log else ratio
    if reduction == "mean":
        losses = losses.mean()
    return -losses


def si_snr_loss(est: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """The wav variant's training SI-SNR (solver_encoder.py:281-287): no
    zero-meaning, the mean over the batch, ``EPS``-stabilized."""
    return neg_sdr(est, target, "sisdr", zero_mean=False, take_log=True, reduction="mean")
