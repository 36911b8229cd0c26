"""The device mesh and its collectives on ``torch.distributed``.

Counterpart of ``autovc_tpu/parallel/mesh.py``. Where the JAX package lays a
('data', 'model') mesh over the devices of one program and lets GSPMD insert
the collectives, the port runs one process a rank and calls them itself:

- ``init_process_group`` starts this process's rank. The backend follows
  the device, as JAX's follows ``--platform``: ``gloo`` for the CPU and
  ``nccl`` for the card, each rank on its own card (``cuda:rank % cards``).
  Ranks that share a card cannot run NCCL (it refuses a duplicate device):
  the launcher sets ``AUTOVC_DIST_BACKEND=gloo`` for them, and the choice is
  printed. Two NCCL ranks on one card raise, naming both ranks' devices.
- ``Mesh`` lays the world's ranks out row-major over named axes, as
  ``make_mesh`` reshapes the device list: rank = data * model_size + model.
  Each rank holds one process group for each axis longer than 1, made of
  the ranks that differ from it only along that axis.
- ``all_reduce``, ``all_gather``, ``send``/``recv`` and ``exchange`` run
  over one axis of the mesh; ``all_reduce_sum`` is the differentiable sum
  that BatchNorm's global statistics take. Under gloo a CUDA tensor goes
  through host memory (gloo moves CPU tensors), under NCCL it stays on the
  card.
- ``param_shardings`` gives the axis of each parameter that tensor
  parallelism splits over 'model', by the port's copy of ``_TP_RULES``
  matched on the JAX parameter paths (``io.generator_jax_paths``);
  ``batch_split`` and ``put_global_batch`` are the batch's split over
  'data'.
"""

from __future__ import annotations

import math
import os
import re
from dataclasses import dataclass
from typing import Mapping, Sequence

import torch
import torch.distributed as dist
from torch import nn

from autovc_tpu_torch import resolve_device

BACKEND_ENV = "AUTOVC_DIST_BACKEND"


def backend_for(device: str | torch.device) -> str:
    """The process-group backend for ``device``: ``AUTOVC_DIST_BACKEND``
    where the launcher set it, else gloo for the CPU and nccl for the card."""
    chosen = os.environ.get(BACKEND_ENV)
    if chosen:
        if chosen not in ("gloo", "nccl"):
            raise ValueError(f"{BACKEND_ENV} is gloo or nccl, not {chosen!r}")
        return chosen
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def rank_device(device: str | torch.device, rank: int, world: int, backend: str) -> torch.device:
    """The device of ``rank``: the CPU, or card ``rank % cards``. Ranks share
    a card only under gloo: two NCCL ranks on one card raise."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return dev
    cards = torch.cuda.device_count()
    if backend == "nccl" and world > cards:
        other = rank + cards if rank + cards < world else rank - cards
        raise ValueError(f"NCCL ranks {min(rank, other)} and {max(rank, other)} would both run on "
                         f"cuda:{rank % cards} ({world} ranks, {cards} card(s)); NCCL refuses a duplicate device: "
                         f"set {BACKEND_ENV}=gloo for ranks that share a card")
    return torch.device("cuda", rank % cards)


def init_process_group(init_method: str, world_size: int, rank: int,
                       device: str | torch.device = "cuda") -> torch.device:
    """Start this process's rank of a world of ``world_size`` at
    ``init_method`` (``tcp://host:port`` or ``file://path``) and return its
    device, made current on the card. The backend and device are printed."""
    backend = backend_for(device)
    dev = rank_device(device, rank, world_size, backend)
    source = f"from {BACKEND_ENV}" if os.environ.get(BACKEND_ENV) else f"for {dev.type}"
    print(f"[parallel] rank {rank}/{world_size}: backend {backend} ({source}), device {dev}", flush=True)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method, world_size=world_size, rank=rank)
    return dev


@dataclass(frozen=True)
class Mesh:
    """This rank's place in a mesh of named axes over the world's ranks."""

    axes: tuple[str, ...]
    sizes: tuple[int, ...]
    rank: int
    device: torch.device
    backend: str | None  # None: a world of one
    groups: Mapping[str, object]  # axis -> this rank's ProcessGroup along it (axes longer than 1)
    group_ranks: Mapping[str, tuple[int, ...]]  # axis -> the global ranks of that group, in axis order

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axes, self.sizes))

    def size(self, axis: str) -> int:
        return self.shape[axis]

    def index(self, axis: str) -> int:
        """This rank's coordinate along ``axis``."""
        return self.group_ranks[axis].index(self.rank)

    def peer(self, axis: str, index: int) -> int:
        """The global rank at ``index`` along ``axis`` in this rank's group."""
        return self.group_ranks[axis][index]


def mesh_over(shape: Mapping[str, int], device: str | torch.device = "cpu") -> Mesh:
    """A mesh of ``shape`` (axis -> size, row-major) over the first
    prod(sizes) ranks of the process group, or over this process alone when
    no group is initialised; ``device`` is this rank's. Every rank of the
    world must call it, in the same order as its other group creations."""
    axes, sizes = tuple(shape), tuple(int(s) for s in shape.values())
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    n = math.prod(sizes)
    if n > world:
        raise ValueError(f"mesh {dict(shape)} > {world} ranks")
    coords = [_coords(r, sizes) for r in range(n)]
    groups, group_ranks = {}, {}
    for a, axis in enumerate(axes):
        # every group along this axis, each made by every rank of the world
        lines: dict[tuple, list[int]] = {}
        for r, c in enumerate(coords):
            lines.setdefault(c[:a] + c[a + 1:], []).append(r)
        mine = coords[rank][:a] + coords[rank][a + 1:] if rank < n else None
        for key, ranks in lines.items():
            group = dist.new_group(ranks) if sizes[a] > 1 else None
            if key == mine:
                groups[axis], group_ranks[axis] = group, tuple(ranks)
        if rank >= n:
            group_ranks[axis] = (rank,)
    return Mesh(axes, sizes, rank, torch.device(device), dist.get_backend() if dist.is_initialized() else None,
                groups, group_ranks)


def _coords(r: int, sizes: Sequence[int]) -> tuple[int, ...]:
    """Row-major coordinates of flat index ``r`` over ``sizes``."""
    out = []
    for s in reversed(sizes):
        r, c = divmod(r, s)
        out.append(c)
    return tuple(reversed(out))


def make_mesh(data: int = -1, model: int = 1, device: str | torch.device = "cpu") -> Mesh:
    """A ('data', 'model') mesh over the world's ranks; ``data=-1`` takes all
    the ranks that model parallelism leaves."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    if data == -1:
        assert n % model == 0, f"{n} ranks not divisible by model={model}"
        data = n // model
    assert data * model <= n, f"mesh {data}x{model} > {n} ranks"
    return mesh_over({"data": data, "model": model}, device)


# ------------------------------------------------------------ collectives


def _staged(t: torch.Tensor, mesh: Mesh) -> bool:
    return mesh.backend == "gloo" and t.device.type == "cuda"


def all_reduce(t: torch.Tensor, mesh: Mesh, axis: str, op: str = "sum") -> torch.Tensor:
    """The sum (or ``op="avg"`` the mean) of ``t`` over this rank's group
    along ``axis``, as a new tensor."""
    group = mesh.groups.get(axis)
    if group is None:
        return t.clone()
    buf = t.detach().to("cpu", copy=True) if _staged(t, mesh) else t.detach().clone()
    dist.all_reduce(buf, group=group)
    if op == "avg":
        buf /= mesh.size(axis)
    elif op != "sum":
        raise ValueError(f"op is sum or avg, not {op!r}")
    return buf.to(t.device)


def all_gather(t: torch.Tensor, mesh: Mesh, axis: str, dim: int = 0) -> torch.Tensor:
    """The group's tensors along ``axis``, concatenated along ``dim`` in
    axis order."""
    group = mesh.groups.get(axis)
    if group is None:
        return t
    src = t.detach().to("cpu") if _staged(t, mesh) else t.detach()
    src = src.contiguous()
    parts = [torch.empty_like(src) for _ in range(mesh.size(axis))]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=dim).to(t.device)


def send(t: torch.Tensor, mesh: Mesh, axis: str, index: int) -> None:
    """Send ``t`` to the rank at ``index`` along ``axis`` (blocking)."""
    src = t.detach().to("cpu") if _staged(t, mesh) else t.detach()
    dist.send(src.contiguous(), dst=mesh.peer(axis, index), group=mesh.groups[axis])


def recv(like: torch.Tensor, mesh: Mesh, axis: str, index: int) -> torch.Tensor:
    """Receive a tensor shaped as ``like`` from the rank at ``index`` along
    ``axis``, on ``like``'s device (blocking)."""
    buf = torch.empty(like.shape, dtype=like.dtype, device="cpu" if _staged(like, mesh) else like.device)
    dist.recv(buf, src=mesh.peer(axis, index), group=mesh.groups[axis])
    return buf.to(like.device)


def exchange(to_prev: torch.Tensor, to_next: torch.Tensor, mesh: Mesh, axis: str
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Each rank sends ``to_prev`` to its predecessor along ``axis`` and
    ``to_next`` to its successor, and gets (the predecessor's ``to_next``,
    the successor's ``to_prev``); zeros stand in at the two ends (no wrap)."""
    n, idx = mesh.size(axis), mesh.index(axis)
    from_prev, from_next = torch.zeros_like(to_next), torch.zeros_like(to_prev)
    if n == 1:
        return from_prev, from_next
    staged = _staged(to_prev, mesh)
    host = (lambda v: v.detach().to("cpu").contiguous()) if staged else (lambda v: v.detach().contiguous())
    bufs, ops = {}, []
    group = mesh.groups[axis]
    for side, peer_idx, out in (("prev", idx - 1, to_prev), ("next", idx + 1, to_next)):
        if 0 <= peer_idx < n:
            peer = mesh.peer(axis, peer_idx)
            like = to_next if side == "prev" else to_prev  # what the peer sends this way
            bufs[side] = torch.empty(like.shape, dtype=like.dtype, device="cpu" if staged else like.device)
            ops += [dist.P2POp(dist.isend, host(out), peer, group), dist.P2POp(dist.irecv, bufs[side], peer, group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    if "prev" in bufs:
        from_prev = bufs["prev"].to(to_next.device)
    if "next" in bufs:
        from_next = bufs["next"].to(to_prev.device)
    return from_prev, from_next


class _AllReduceSum(torch.autograd.Function):
    """The sum over a mesh axis, differentiable: the gradient of each rank's
    input is the sum of the output's gradients over the axis (every rank's
    loss depends on the one sum)."""

    @staticmethod
    def forward(ctx, t, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return all_reduce(t, mesh, axis)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad, ctx.mesh, ctx.axis), None, None


def all_reduce_sum(t: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """``all_reduce`` that autograd differentiates (BatchNorm's global sums)."""
    return _AllReduceSum.apply(t, mesh, axis)


# ----------------------------------------------------- data parallelism


def batch_split(x: torch.Tensor, mesh: Mesh, axis: str = "data") -> torch.Tensor:
    """This rank's rows of a global batch split over ``axis`` (JAX's
    ``batch_sharding``: the leading axis over 'data')."""
    n = mesh.size(axis)
    if x.shape[0] % n:
        raise ValueError(f"batch {x.shape[0]} does not split over {n} '{axis}' ranks")
    rows = x.shape[0] // n
    return x[mesh.index(axis) * rows : (mesh.index(axis) + 1) * rows]


def put_global_batch(x, mesh: Mesh) -> torch.Tensor:
    """This rank's shard of the global batch, as the host-sharded iterator
    gives it (each process holds only its rows), on the mesh's device."""
    return torch.as_tensor(x).to(mesh.device)


def roll_rows(t: torch.Tensor, mesh: Mesh, axis: str = "data") -> torch.Tensor:
    """This rank's rows of ``torch.roll(global, 1, 0)`` of the batch split
    over ``axis``: the roll crosses rank boundaries (data only: no
    gradient)."""
    if mesh.groups.get(axis) is None:
        return torch.roll(t, 1, dims=0)
    return batch_split(torch.roll(all_gather(t, mesh, axis), 1, dims=0), mesh, axis)


def sync_batch_norm(model: nn.Module, mesh: Mesh | None, axis: str = "data") -> nn.Module:
    """Make every BatchNorm of ``model`` take its training statistics over
    the batch split along ``axis`` (``None``: local statistics)."""
    from autovc_tpu_torch.models.layers import BatchNorm

    reduce = None
    if mesh is not None and mesh.groups.get(axis) is not None:
        def reduce(t: torch.Tensor) -> torch.Tensor:
            return all_reduce_sum(t, mesh, axis)
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.reduce = reduce
    return model


# ---------------------------------------------------- tensor parallelism

# The tensor-parallel rules of autovc_tpu/parallel/mesh.py, matched against
# the '/'-joined JAX parameter path; the first match wins. A spec shorter
# than the leaf right-aligns (PartitionSpec pads None on the left).
_TP_RULES: list[tuple[str, tuple[str | None, ...]]] = [
    # conv kernels (k, in, out): the wide interior convs' out-channels
    (r".*conv\d*/Conv_0/kernel$", (None, None, "model")),
    (r".*conv\d*/Conv_0/bias$", ("model",)),
    # LSTM input/hidden projections (in, 4H): the gate axis
    (r".*(w_ih|w_hh)_l\d+_(fwd|bwd)$", (None, "model")),
    (r".*b_l\d+_(fwd|bwd)$", ("model",)),
    # dense projections (in, out)
    (r".*(proj|embedding|Dense_0)/kernel$", (None, "model")),
]


def tp_axis(path: str, shape: Sequence[int], axis_size: int) -> int | None:
    """The axis of a JAX leaf (its path and shape) that ``_TP_RULES`` shards
    over a 'model' axis of ``axis_size``, or None (no rule, or a dimension
    the axis does not divide)."""
    if axis_size <= 1:
        return None
    for pattern, spec in _TP_RULES:
        if re.match(pattern, path) and len(spec) <= len(shape):
            full = (None,) * (len(shape) - len(spec)) + spec
            if all(name != "model" or dim % axis_size == 0 for dim, name in zip(shape, full)):
                return full.index("model")
    return None


def param_shardings(model: nn.Module, mesh: Mesh, tensor_parallel: bool = True) -> dict[str, int | None]:
    """Parameter name -> the axis of the tensor (in this package's layout)
    that tensor parallelism splits over 'model', or None (replicated; every
    leaf when ``tensor_parallel`` is False or 'model' has size 1)."""
    from autovc_tpu_torch.io import generator_jax_paths

    size = mesh.shape.get("model", 1) if tensor_parallel else 1
    state = dict(model.named_parameters())
    out = {}
    for name, (_, path, axes) in generator_jax_paths(state).items():
        jax_shape = [0] * len(axes)
        for here, there in enumerate(axes):
            jax_shape[there] = state[name].shape[here]
        jax_axis = tp_axis(path, jax_shape, size)
        out[name] = None if jax_axis is None else axes.index(jax_axis)
    return out


def shard_leaves(leaves: Mapping[str, torch.Tensor], shards: Mapping[str, int | None], mesh: Mesh,
                 axis: str = "model") -> dict[str, torch.Tensor]:
    """Each leaf that ``shards`` shards: this rank's contiguous slice of it
    along its axis (JAX's block of a dimension split over ``axis``), a copy
    (a view would keep the whole leaf's storage alive); the others as they
    are."""
    n, i = mesh.size(axis), mesh.index(axis)
    return {k: v if shards.get(k) is None else v.chunk(n, shards[k])[i].clone(memory_format=torch.contiguous_format)
            for k, v in leaves.items()}


def gather_leaves(leaves: Mapping[str, torch.Tensor], shards: Mapping[str, int | None], mesh: Mesh,
                  axis: str = "model") -> dict[str, torch.Tensor]:
    """The inverse of ``shard_leaves``: each sharded leaf's slices gathered
    over ``axis`` (a collective: every rank of the group calls it)."""
    return {k: v if shards.get(k) is None else all_gather(v, mesh, axis, dim=shards[k]) for k, v in leaves.items()}


@torch.no_grad()
def shard_params(model: nn.Module, shards: Mapping[str, int | None], mesh: Mesh, axis: str = "model") -> None:
    """In place: each sharded parameter holds this rank's slice."""
    params = dict(model.named_parameters())
    for name, value in shard_leaves({k: p.data for k, p in params.items()}, shards, mesh, axis).items():
        params[name].data = value


@torch.no_grad()
def gather_params(model: nn.Module, shards: Mapping[str, int | None], mesh: Mesh, axis: str = "model") -> None:
    """In place: each sharded parameter whole again (a collective)."""
    params = dict(model.named_parameters())
    for name, value in gather_leaves({k: p.data for k, p in params.items()}, shards, mesh, axis).items():
        params[name].data = value
