"""Artifact loading and the JAX-parameter -> PyTorch state-dict mapping.

Artifacts are flat ``.npz`` files written by the JAX package
(``autovc_tpu/cli/export_ckpt.py``): keys ``params/...`` and
``batch_stats/...`` joined by ``/``, an optional ``__step__``, weights
possibly stored as float16. ``load_artifact`` returns the nested tree as
float32 numpy arrays; ``generator_state_from_jax`` and
``hifigan_state_from_jax`` turn a tree into the state dict of this package's
``Generator`` and ``HiFiGANGenerator``.

Layouts (JAX -> this package):

- conv kernel ``(k, in, out)`` -> ``(out, in, k)`` (``F.conv1d``);
- transposed-conv kernel ``(k, out, in)`` -> ``(in, out, k)``
  (``F.conv_transpose1d``): the same axis reversal;
- dense kernel ``(in, out)`` -> ``(out, in)`` (``F.linear``);
- BatchNorm ``scale``/``bias``/``mean``/``var`` -> ``weight``/``bias``/
  ``running_mean``/``running_var``;
- LSTM ``w_ih_l{k}_{d}`` ``(in, 4H)``, ``w_hh_l{k}_{d}`` ``(H, 4H)`` and
  ``b_l{k}_{d}`` ``(4H,)`` are kept as they are, gate order i, f, g, o along
  the 4H axis: the input product is ``x @ w_ih + b`` and the CUDA kernel
  reads ``w_hh`` row-major, row ``k`` holding the four gates' columns
  ``g*H + j`` of every hidden unit ``j``.

Flax wraps each conv, dense and BatchNorm in a child named ``Conv_0``,
``Dense_0`` or ``BatchNorm_0``; those path segments are dropped.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

_WRAPPERS = ("Conv_0", "Dense_0", "BatchNorm_0")
_LEAF_NAMES = {"kernel": "weight", "scale": "weight", "mean": "running_mean", "var": "running_var"}


def unflatten_params(flat: Mapping[str, np.ndarray]) -> dict:
    """``{'a/b/c': x}`` -> ``{'a': {'b': {'c': x}}}``."""
    out: dict = {}
    for key, value in flat.items():
        parts = key.split("/")
        node = out
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return out


def flatten_params(tree: Mapping, prefix: str = "") -> dict[str, np.ndarray]:
    """The inverse of ``unflatten_params``."""
    out: dict[str, np.ndarray] = {}
    for key, value in tree.items():
        path = f"{prefix}/{key}" if prefix else key
        if isinstance(value, Mapping):
            out.update(flatten_params(value, path))
        else:
            out[path] = np.asarray(value)
    return out


def load_artifact(path: str) -> tuple[dict, int]:
    """(tree, step) from an exported ``.npz``: ``__step__`` popped (-1 when
    absent), float16 storage upcast to float32."""
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    step = int(flat.pop("__step__", -1))
    flat = {k: v.astype(np.float32) if v.dtype == np.float16 else v for k, v in flat.items()}
    return unflatten_params(flat), step


def _leaf_to_torch(path: str, value: np.ndarray) -> tuple[str, torch.Tensor]:
    parts = [p for p in path.split("/") if p not in _WRAPPERS]
    leaf = parts[-1]
    arr = np.asarray(value, np.float32)
    if leaf == "kernel":
        arr = arr.transpose(2, 1, 0) if arr.ndim == 3 else arr.T
    parts[-1] = _LEAF_NAMES.get(leaf, leaf)
    return ".".join(parts), torch.from_numpy(np.array(arr, order="C"))  # a writable copy


def generator_state_from_jax(variables: Mapping) -> dict[str, torch.Tensor]:
    """``{'params': ..., 'batch_stats': ...}`` of the JAX ``Generator`` ->
    state dict of ``autovc_tpu_torch.models.Generator``."""
    state: dict[str, torch.Tensor] = {}
    for collection in ("params", "batch_stats"):
        for path, value in flatten_params(variables[collection]).items():
            key, tensor = _leaf_to_torch(path, value)
            state[key] = tensor
    return state


def hifigan_state_from_jax(params: Mapping) -> dict[str, torch.Tensor]:
    """The JAX ``HiFiGANGenerator`` params (no collection level, as the
    vocoder artifact stores them) -> state dict of
    ``autovc_tpu_torch.vocoder.hifigan.HiFiGANGenerator``."""
    return dict(_leaf_to_torch(path, value) for path, value in flatten_params(params).items())
