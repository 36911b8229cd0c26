"""A world of ranks started from one process.

``run_world(fn, n, *args, device=...)`` starts n processes (the ``spawn``
start method of ``torch.multiprocessing``), joins them into one process
group through a ``file://`` store in a temporary directory, and calls
``fn(rank_device, *args)`` in each; it returns each rank's result, in rank
order, and re-raises a rank's failure. ``fn`` must be importable by name
(a module-level function) and its arguments picklable; CPU tensors pass
through shared memory. Where ``fn`` lives outside the parent's ``__main__``
the ranks do not import the parent's main script (spawn's default), only
``fn``'s module. Rank r runs on ``cuda:r`` where the host has n cards;
ranks that share a card need ``AUTOVC_DIST_BACKEND=gloo``
(``parallel.mesh.rank_device``).
"""

from __future__ import annotations

import contextlib
import os
import sys
import tempfile
from typing import Any, Callable, Iterator

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from autovc_tpu_torch.parallel.mesh import backend_for, init_process_group, rank_device


def _rank_main(rank: int, fn: Callable, world: int, store: str, out_dir: str, device: str, threads: int | None,
               args: tuple) -> None:
    if threads:
        torch.set_num_threads(threads)
    dev = init_process_group(f"file://{store}", world, rank, device)
    try:
        result = fn(dev, *args)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))


@contextlib.contextmanager
def _main_unshared(fn: Callable) -> Iterator[None]:
    """While the ranks start: hide the parent's main module from spawn (it
    imports the script of ``__main__`` by path or name in every rank) unless
    ``fn`` lives there."""
    main = sys.modules["__main__"]
    saved = {k: getattr(main, k) for k in ("__file__", "__spec__") if hasattr(main, k)}
    if fn.__module__ != "__main__":
        main.__spec__ = None
        main.__dict__.pop("__file__", None)
    try:
        yield
    finally:
        main.__dict__.update(saved)


def run_world(fn: Callable, world: int, *args: Any, device: str | torch.device = "cuda",
              threads: int | None = None) -> list[Any]:
    """``fn(device_of_rank, *args)`` on each rank of a world of ``world``
    processes -> the ranks' results; ``threads`` sets each rank's
    ``torch.set_num_threads``."""
    rank_device(device, world - 1, world, backend_for(device))  # raises here, before any rank starts
    with tempfile.TemporaryDirectory(prefix="autovc_world_") as tmp:
        with _main_unshared(fn):
            ranks = mp.start_processes(_rank_main, nprocs=world, join=False, start_method="spawn",
                                       args=(fn, world, os.path.join(tmp, "store"), tmp, str(device), threads, args))
        while not ranks.join():
            pass
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False) for r in range(world)]
