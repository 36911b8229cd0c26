"""optax's Adam state in a torch ``Adam`` or ``AdamW``, both ways: the leaves
the JAX vocoder trainers write to their ``.npz`` train states
(``jax.tree_util.tree_leaves`` of ``ScaleByAdamState(count, mu, nu)``: the
step count, then the first moments and the second moments in the order of
the parameters' leaves), read into and out of torch's per-parameter
``step``, ``exp_avg`` and ``exp_avg_sq``.

A module's parameters are matched to the JAX tree through the functions
that map its state dict to flat JAX leaves and back, which also give the
moments their layouts.
"""

from __future__ import annotations

from typing import Callable, Mapping

import numpy as np
import torch
from torch import nn

from autovc_tpu_torch.io import jax_leaf_order

ToFlat = Callable[[Mapping[str, torch.Tensor]], dict[str, np.ndarray]]
FromFlat = Callable[[Mapping[str, np.ndarray]], dict[str, torch.Tensor]]


class JaxLeaves:
    """A module's parameters in JAX's leaf order, each with its JAX path and
    its layout both ways: ``to_flat`` maps a state dict to flat JAX leaves,
    ``from_flat`` flat JAX leaves to a state dict (``io.conv_state_to_jax``
    and ``io.hifigan_state_from_jax``, say), one entry at a time."""

    def __init__(self, module: nn.Module, to_flat: ToFlat, from_flat: FromFlat):
        self.to_flat, self.from_flat = to_flat, from_flat
        by_path = {}
        for name, p in module.named_parameters():
            (path,) = to_flat({name: p.detach()})
            by_path[path] = (name, p)
        self.paths = jax_leaf_order(by_path)
        self.names = [by_path[path][0] for path in self.paths]
        self.params = [by_path[path][1] for path in self.paths]

    def to_jax(self, name: str, value: torch.Tensor) -> np.ndarray:
        return next(iter(self.to_flat({name: value}).values()))

    def from_jax(self, path: str, value: np.ndarray, like: torch.Tensor) -> torch.Tensor:
        (tensor,) = self.from_flat({path: np.asarray(value, np.float32)}).values()
        return tensor.to(like.device)

    def adam_leaves(self, optimizer: torch.optim.Optimizer) -> list[np.ndarray]:
        """[count, mu..., nu...] of optax's ``ScaleByAdamState``; zeros and a
        count of 0 before the first step."""
        count, mu, nu = 0, [], []
        for name, p in zip(self.names, self.params):
            st = optimizer.state.get(p)
            if st:
                count = int(st["step"])
                mu.append(self.to_jax(name, st["exp_avg"]))
                nu.append(self.to_jax(name, st["exp_avg_sq"]))
            else:
                zero = self.to_jax(name, torch.zeros_like(p))
                mu.append(zero)
                nu.append(zero)
        return [np.asarray(count, np.int32), *mu, *nu]

    def load_adam_leaves(self, optimizer: torch.optim.Optimizer, leaves: list[np.ndarray]) -> None:
        """The inverse of ``adam_leaves``: torch's state from optax's leaves."""
        n = len(self.params)
        if len(leaves) != 1 + 2 * n:
            raise ValueError(f"optax's Adam state of {n} parameters has {1 + 2 * n} leaves, got {len(leaves)}")
        count = int(leaves[0])
        optimizer.state.clear()
        if count == 0:
            return
        for k, (path, p) in enumerate(zip(self.paths, self.params)):
            optimizer.state[p] = {"step": torch.tensor(float(count)),
                                  "exp_avg": self.from_jax(path, leaves[1 + k], p),
                                  "exp_avg_sq": self.from_jax(path, leaves[1 + n + k], p)}
