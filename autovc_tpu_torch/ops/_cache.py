"""What a wrapper derives from a tensor once and reuses (a transposed copy,
the values on the host), keyed by the tensor's identity: its storage, its
version, its shape, strides and device. Each entry holds the tensor, so its
storage is not reused while the entry lives; a full cache is emptied."""

from __future__ import annotations

from typing import Any, Callable

import torch


class TensorCache:
    def __init__(self, size: int):
        self.size = size
        self._entries: dict[tuple, tuple[torch.Tensor, Any]] = {}

    @staticmethod
    def _key(t: torch.Tensor) -> tuple:
        return t.data_ptr(), t._version, tuple(t.shape), t.stride(), str(t.device)

    def put(self, tensor: torch.Tensor, value: Any) -> Any:
        if len(self._entries) >= self.size:
            self._entries.clear()
        self._entries[self._key(tensor)] = (tensor, value)
        return value

    def get(self, tensor: torch.Tensor, make: Callable[[torch.Tensor], Any]) -> Any:
        """The value kept for ``tensor``, made by ``make(tensor)`` at the
        first call."""
        hit = self._entries.get(self._key(tensor))
        return self.put(tensor, make(tensor)) if hit is None else hit[1]
