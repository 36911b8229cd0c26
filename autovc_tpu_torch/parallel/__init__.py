"""Parallelism on ``torch.distributed``: the ('data', 'model') mesh, data and
tensor parallelism's collectives and rules (``mesh``), sequence parallelism
(``sequence``) and a world of ranks started from one process (``launch``)."""

from autovc_tpu_torch.parallel.mesh import (Mesh, batch_split, init_process_group, make_mesh, mesh_over,
                                            param_shardings, put_global_batch)

__all__ = [
    "Mesh",
    "batch_split",
    "init_process_group",
    "make_mesh",
    "mesh_over",
    "param_shardings",
    "put_global_batch",
]
