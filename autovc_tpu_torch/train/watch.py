"""Parameter and gradient histograms, the ``wandb.watch`` equivalent, under
the names of ``autovc_tpu/train/watch.py``: ``param/<module>`` and
``grad/<module>`` per top-level module, fixed bins built on the device so
only the counts cross to the host.

The JAX observer recomputes the gradients, because a jitted step keeps none;
here the gradients of the step just taken are still on the parameters
(``.grad``), as torch's hooks give them to ``wandb.watch``.
"""

from __future__ import annotations

import torch
from torch import nn


def _group_histogram(leaves: list[torch.Tensor], bins: int) -> dict:
    flat = torch.cat([x.detach().reshape(-1).float() for x in leaves])
    lo, hi = flat.min(), flat.max()
    span = torch.clamp(hi - lo, min=1e-12)  # an all-equal group, e.g. a zeroed bias
    counts = torch.histc(flat, bins=bins, min=float(lo), max=float(lo + span))
    return {"counts": counts, "lo": lo, "hi": hi, "rms": torch.sqrt(torch.mean(flat * flat))}


def tree_histograms(named: dict[str, torch.Tensor], bins: int = 64) -> dict:
    """{'encoder.conv0.weight': x, ...} -> {top-level module: histogram}."""
    groups: dict[str, list[torch.Tensor]] = {}
    for name, x in named.items():
        groups.setdefault(name.split(".", 1)[0], []).append(x)
    return {key: _group_histogram(leaves, bins) for key, leaves in groups.items()}


def watch_histograms(model: nn.Module, bins: int = 64) -> dict:
    """{'param/<module>': ..., 'grad/<module>': ...} of the model's
    parameters and of the gradients they hold."""
    params = dict(model.named_parameters())
    grads = {n: p.grad for n, p in params.items() if p.grad is not None}
    hists = {f"param/{k}": h for k, h in tree_histograms(params, bins).items()}
    hists.update({f"grad/{k}": h for k, h in tree_histograms(grads, bins).items()})
    return hists
