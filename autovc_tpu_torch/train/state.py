"""Training state: the step, the model (parameters and BatchNorm running
statistics), the optimizer and the EMA of the parameters.

Counterpart of ``autovc_tpu/train/state.py``. The JAX state is a pure tree
that each step replaces; here the step updates it in place.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping

import torch
from torch import nn


@dataclass
class TrainState:
    step: int
    model: nn.Module
    optimizer: torch.optim.Optimizer
    ema_params: dict[str, torch.Tensor]  # a real exponential moving average


def init_ema(model: nn.Module) -> dict[str, torch.Tensor]:
    """A copy of every parameter, in its own buffers."""
    return {name: p.detach().clone() for name, p in model.named_parameters()}


@torch.no_grad()
def ema_update(ema: dict[str, torch.Tensor], params: Mapping[str, torch.Tensor], decay: float
               ) -> dict[str, torch.Tensor]:
    """In place, for every leaf: ema = decay * ema + (1 - decay) * param."""
    names = list(ema)
    e = [ema[n] for n in names]
    torch._foreach_mul_(e, decay)
    torch._foreach_add_(e, [params[n].detach() for n in names], alpha=1.0 - decay)
    return ema
