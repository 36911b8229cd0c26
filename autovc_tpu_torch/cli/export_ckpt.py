"""Export a port training run's checkpoint to a flat .npz artifact.

    python -m autovc_tpu_torch.cli.export_ckpt --run_dir RUNDIR --out FILE.npz
        [--use_ema] [--dtype float32|float16|bfloat16]

Counterpart of ``autovc_tpu/cli/export_ckpt.py``, with its flags: the
newest ``checkpoints/step_*.pt`` that the port's ``train.Solver`` wrote
(``cli.convert.load_solver_checkpoint``) -> the artifact schema the JAX
package writes and both packages load (``params/...`` and
``batch_stats/...`` in the JAX layouts, ``__step__``): the step before
``cli.export_serving``. ``--use_ema`` takes the run's EMA parameters.
``--dtype`` quantizes the parameters: float16 is stored as float16,
bfloat16 rounded to nearest even and stored in float32 containers (NumPy
has no bfloat16); the BatchNorm statistics stay float32.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from autovc_tpu_torch.io import flatten_params, generator_state_to_jax

DTYPES = ("float32", "float16", "bfloat16")


def _quantize(a: np.ndarray, dtype: str) -> np.ndarray:
    if dtype == "float32" or a.dtype != np.float32:
        return a
    if dtype == "bfloat16":
        return torch.from_numpy(a).to(torch.bfloat16).float().numpy()
    return a.astype(np.float16)


def export(run_dir: str, out: str, use_ema: bool = False, dtype: str = "float32") -> None:
    from autovc_tpu_torch.cli.convert import load_solver_checkpoint

    if dtype not in DTYPES:
        raise ValueError(f"dtype is one of {DTYPES}, not {dtype!r}")
    tree, step = load_solver_checkpoint(run_dir)
    state = {**tree["ema_params" if use_ema else "params"], **tree["batch_stats"]}
    jax_tree = generator_state_to_jax(state)
    flat = {k: _quantize(v, dtype) for k, v in flatten_params(jax_tree["params"], "params").items()}
    flat.update(flatten_params(jax_tree["batch_stats"], "batch_stats"))
    flat["__step__"] = np.asarray(step, np.int64)
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    np.savez_compressed(out, **flat)
    print(f"[export_ckpt] step {step} -> {out} ({os.path.getsize(out) / 1e6:.1f} MB, {dtype})")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--run_dir", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--use_ema", action="store_true")
    ap.add_argument("--dtype", default="float32", choices=DTYPES)
    args = ap.parse_args(argv)
    export(args.run_dir, args.out, use_ema=args.use_ema, dtype=args.dtype)


if __name__ == "__main__":
    main()
