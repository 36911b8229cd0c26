"""Work of one rank of ``chip_smoke.py`` phase 13a's worlds, in a module of
its own so that the spawned ranks import it alone (not the whole script):

    sp_rank(device, state, x, c_org, c_trg, reps, go=None) -> dict | None

``convert.sequence_parallel.SPGenerator`` at the published widths (its
weights from ``state``) over the world's 'seq' axis: the outputs of one call
(rank 0), that call's ``lstm_fwd.cu`` launches and the blocks it ran from a
received (h, c) (``parallel.sequence.relays``), and the host wall ms of
``reps`` warm calls, each ended by a synchronisation of the card. With
``go`` (a path), the rank waits, its model on the card, until that file
exists (having touched ``<go>.ready<rank>``): "go" runs the forwards;
"stop", or the starting process gone, returns None. Needs a CUDA card;
``chip_smoke.py`` starts the worlds (``parallel.launch.run_world``).
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from autovc_tpu_torch.config import ModelConfig
from autovc_tpu_torch.convert.sequence_parallel import SPGenerator
from autovc_tpu_torch.models import build_generator
from autovc_tpu_torch.ops import lstm as lstm_ops
from autovc_tpu_torch.parallel import mesh as pmesh
from autovc_tpu_torch.parallel import sequence as seq_ops


def sp_rank(dev: torch.device, state: dict, x: np.ndarray, c_org: np.ndarray, c_trg: np.ndarray, reps: int,
            go: str | None = None) -> dict | None:
    mesh = pmesh.mesh_over({"seq": torch.distributed.get_world_size()}, dev)
    gen = build_generator(ModelConfig(), device="cpu")
    gen.load_state_dict(state)
    sp = SPGenerator(gen.to(dev), mesh)
    if go is not None:
        open(f"{go}.ready{mesh.rank}", "w").close()
        parent = os.getppid()
        while not os.path.exists(go):
            if os.getppid() != parent:  # the process that started the world is gone
                return None
            time.sleep(0.05)
        with open(go) as f:
            if f.read() != "go":
                return None
    lstm_ops.launches = seq_ops.relays = 0
    outs = [o.cpu().numpy() for o in sp(x, c_org, c_trg)]
    launched, relayed = lstm_ops.launches, seq_ops.relays
    torch.distributed.barrier()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        sp(x, c_org, c_trg)
    torch.cuda.synchronize()
    return {"outs": outs if mesh.rank == 0 else None, "launches": launched, "relays": relayed,
            "ms": (time.perf_counter() - t0) * 1e3 / reps, "device": str(dev)}
