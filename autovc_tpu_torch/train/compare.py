"""Holding one train step's gradients against another's, leaf by leaf.

``grad_scale`` is the magnitude a gradient leaf is compared at.

``KinkTape`` handles the loss's kinks. The loss is not differentiable
everywhere: every ReLU of the generator, every PReLU of the wav variant's
ConvTasNet front and back end and the content L1's ``abs`` have a kink at
0. Where two steps that round differently (the CUDA kernels against the
plain recurrence, float32 against float64, the card against the CPU) put an
element within rounding of a kink on opposite sides, their gradients differ
by that element's whole contribution. One such element moves a leaf by
about one term of a sum over B*T positions, a few per cent of its scale at
full width. ``KinkTape.record`` notes the side of every kinked element in
one step; ``KinkTape.replay`` makes another step take the same sides, as
``x * mask`` for a ReLU, ``where(mask, x, alpha * x)`` for a PReLU and
``x * sign`` for ``abs``, and counts the elements that had fallen on the
other side (``flips``). The two steps' gradients can then be held to
rounding.
"""

from __future__ import annotations

import re
from contextlib import contextmanager
from typing import Iterator, Mapping
from unittest import mock

import torch

from autovc_tpu_torch.models import layers


_CONV = re.compile(r"^(.*)\.conv(\d+)$")


def grad_scale(name: str, grads: Mapping[str, torch.Tensor]) -> float:
    """A gradient leaf's largest magnitude; for the bias of a convolution
    that a BatchNorm directly follows (``<m>.conv<i>`` beside ``<m>.bn<i>``
    and no ``<m>.prelu<i>`` between them: the spmel/stft generator's
    encoder, decoder and postnet), whose gradient is zero in exact
    arithmetic (the BatchNorm subtracts the batch mean) and so only
    rounding, that of the convolution's weight gradient. Every other bias,
    the ConvTasNet front and back end's among them, is measured by its
    own."""
    module, leaf = name.rsplit(".", 1)
    conv = _CONV.match(module)
    if leaf == "bias" and conv:
        parent, i = conv.groups()
        has = {n.rsplit(".", 1)[0] for n in grads}
        if f"{parent}.bn{i}" in has and f"{parent}.prelu{i}" not in has:
            name = f"{module}.weight"
    return max(float(grads[name].abs().max()), 1e-30)


class KinkTape:
    """The side of every ReLU, PReLU and ``abs`` element of one step, in call
    order."""

    def __init__(self) -> None:
        self.sides: list[tuple[str, torch.Tensor]] = []
        self.flips = 0
        self.elements = 0

    @staticmethod
    @contextmanager
    def _patched(relu, absolute, prelu) -> Iterator[None]:
        with (mock.patch.object(torch, "relu", relu), mock.patch.object(torch, "abs", absolute),
              mock.patch.object(layers, "prelu", prelu)):
            yield

    @contextmanager
    def record(self) -> Iterator["KinkTape"]:
        relu, absolute, prelu = torch.relu, torch.abs, layers.prelu

        def rec_relu(x):
            self.sides.append(("relu", (x > 0).detach()))
            return relu(x)

        def rec_abs(x):
            self.sides.append(("abs", torch.sign(x).detach().to(torch.int8)))
            return absolute(x)

        def rec_prelu(x, alpha):
            self.sides.append(("prelu", (x >= 0).detach()))
            return prelu(x, alpha)

        self.sides = []
        with self._patched(rec_relu, rec_abs, rec_prelu):
            yield self
        self.elements = sum(side.numel() for _, side in self.sides)

    @contextmanager
    def replay(self) -> Iterator["KinkTape"]:
        """Run with the recorded sides; ``flips`` counts the elements whose
        own side differed. Raises if the calls do not match the record."""
        sides = iter(self.sides)
        flips = []

        def side(kind: str, x: torch.Tensor) -> torch.Tensor:
            got_kind, s = next(sides, (None, None))
            if got_kind != kind or s.shape != x.shape:
                raise RuntimeError(f"replayed {kind}{tuple(x.shape)} where the record has "
                                   f"{got_kind}{None if s is None else tuple(s.shape)}")
            return s.to(x.device)

        def rep_relu(x):
            mask = side("relu", x)
            flips.append(((x > 0) != mask).sum())
            return x * mask.to(x.dtype)

        def rep_abs(x):
            sign = side("abs", x)
            flips.append((torch.sign(x).to(torch.int8) != sign).sum())
            return x * sign.to(x.dtype)

        def rep_prelu(x, alpha):
            mask = side("prelu", x)
            flips.append(((x >= 0) != mask).sum())
            x = x.to(torch.promote_types(x.dtype, alpha.dtype))
            return torch.where(mask, x, alpha * x)

        with self._patched(rep_relu, rep_abs, rep_prelu):
            yield self
        if next(sides, None) is not None:
            raise RuntimeError("the replayed step made fewer kinked calls than the record")
        self.flips = int(sum(int(f) for f in flips))
