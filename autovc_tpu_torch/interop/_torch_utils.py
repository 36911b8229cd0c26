"""Shared helpers of the torch state-dict importers (counterpart of
``autovc_tpu/interop/_torch_utils.py``)."""

from __future__ import annotations

from typing import Mapping

import numpy as np


def to_np(t) -> np.ndarray:
    if hasattr(t, "detach"):
        t = t.detach().cpu().numpy()
    return np.asarray(t, np.float32)


def resolve_weight(sd: Mapping, prefix: str) -> np.ndarray:
    """Resolve a conv/linear weight, folding weight normalization.

    Handles three formats:
      - plain:                    <prefix>.weight
      - legacy weight_norm:       <prefix>.weight_g / <prefix>.weight_v
      - torch parametrizations:   <prefix>.parametrizations.weight.original0/1
    """
    if prefix + ".weight" in sd:
        return to_np(sd[prefix + ".weight"])
    if prefix + ".weight_g" in sd:
        g = to_np(sd[prefix + ".weight_g"])
        v = to_np(sd[prefix + ".weight_v"])
    elif prefix + ".parametrizations.weight.original0" in sd:
        g = to_np(sd[prefix + ".parametrizations.weight.original0"])
        v = to_np(sd[prefix + ".parametrizations.weight.original1"])
    else:
        raise KeyError(
            f"no weight found for {prefix!r} (tried .weight, .weight_g/_v, "
            f".parametrizations.weight.original0/1)"
        )
    norm = np.sqrt((v**2).sum(axis=tuple(range(1, v.ndim)), keepdims=True))
    return g * v / np.maximum(norm, 1e-12)
