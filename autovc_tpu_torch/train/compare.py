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

``history_gap`` and ``moment_gap`` hold a whole run against another of the
same steps (a data- or tensor-parallel run against the single process).
Parameters after a few Adam steps cannot separate two such runs: Adam moves
every element by about the learning rate a step whatever its gradient, so
two runs differ by a few times lr even where one never averaged its
gradients over the ranks. These compare what the gradients make: the first
step's metrics (its ``grad_norm`` is the norm of the gradient before any
update) and Adam's moments after it (the first gradient itself), which only
rounding separates in sound runs, and a later step's loss terms, which see
the parameters after the updates (a rank that kept a stale slice of them
shows there). The first update moves each element by about lr * sign(g),
so rounding in a near-zero gradient becomes a step of 2 * lr there: from
the second step on, sound runs drift apart, by little at narrow widths and
by more at the published ones.
"""

from __future__ import annotations

import re
from contextlib import contextmanager
from typing import Any, Iterator, Mapping, Sequence
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


def history_gap(got: Sequence[Mapping[str, float]], want: Sequence[Mapping[str, float]],
                step: int = 1) -> tuple[float, str]:
    """The largest relative distance of one run's record of ``step`` from
    another's (as ``Solver.history`` or the metrics stream holds them) ->
    (distance, '<metric>@<step>'): at the first step every metric but
    ``lr``, at a later one its loss terms (``g_loss*``). Both runs must have
    logged the same metrics at that step."""
    g, w = ({r["step"]: r for r in run}.get(step) for run in (got, want))
    if g is None or w is None or g.keys() != w.keys():
        raise ValueError(f"step {step}: metrics {None if g is None else sorted(g)} against "
                         f"{None if w is None else sorted(w)}")
    return max((abs(g[k] - v) / max(abs(v), 1e-6), f"{k}@{step}") for k, v in w.items()
               if k not in ("step", "time", "lr") and (step == 1 or k.startswith("g_loss")))


def moment_gap(got: Mapping[str, Any], want: Mapping[str, Any], names: Sequence[str]) -> tuple[float, str]:
    """The largest distance of one Adam ``state_dict``'s moments from
    another's, each leaf's in units of its ``grad_scale`` among the other's
    moments of that kind -> (distance, '<kind>:<parameter>'). ``names``: the
    parameters in the optimizer's order."""
    worst = (0.0, "")
    for kind in ("exp_avg", "exp_avg_sq"):
        ref = {n: want["state"][i][kind] for i, n in enumerate(names)}
        for i, n in enumerate(names):
            dist = float((got["state"][i][kind] - ref[n]).abs().max()) / grad_scale(n, ref)
            worst = max(worst, (dist, f"{kind}:{n}"))
    return worst


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
