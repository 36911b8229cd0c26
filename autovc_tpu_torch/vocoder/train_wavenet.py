"""WaveNet vocoder training: the teacher-forced MoL NLL over hop-aligned
(waveform, mel) crops, Adam on a noam schedule, a per-step EMA, and
``.npz`` checkpoints in the JAX package's layouts.

Counterpart of ``autovc_tpu/vocoder/train_wavenet.py``. The forward is the
port's teacher-forced ``WaveNet.apply`` (no Pallas kernel in JAX: shifted
matrix products, here on cuBLAS); the loss ``discretized_mol_loss``.
``save`` writes the flat ``.npz`` that ``WaveNetVocoder.from_checkpoint``
reads in both packages; ``save_train_state`` and ``restore_train_state``
write and read the JAX trainer's resume file (``leaf_<i>`` in
``jax.tree_util`` order: the parameters, then optax's Adam state
``(count, mu, nu)`` and its schedule count), so that a run moves between
the packages.
"""

from __future__ import annotations

import os
import time
import warnings
from typing import Iterator

import numpy as np
import torch

from autovc_tpu_torch import exact_f32, resolve_device
from autovc_tpu_torch.config import WaveNetConfig
from autovc_tpu_torch.io import state_to_flat, unflatten_params, wavenet_state_from_jax
from autovc_tpu_torch.train.optax_state import JaxLeaves
from autovc_tpu_torch.train.state import ema_update, init_ema
from autovc_tpu_torch.vocoder.wavenet import WaveNet, discretized_mol_loss


def noam_schedule(warmup: int = 4000, init_step: int = 0):
    """lr scale = min(s^-0.5, s * warmup^-1.5) * warmup^0.5 at s = max(step +
    init_step, 1), in float32 as JAX computes it (hparams.py:142's
    ``noam_learning_rate_decay``); ``init_step`` continues the decay of a
    warm-started run."""
    w = np.float32(warmup)

    def fn(step: int) -> np.float32:
        s = np.float32(max(step + init_step, 1))
        return np.minimum(s ** np.float32(-0.5), s * w ** np.float32(-1.5)) * w ** np.float32(0.5)

    return fn


def crop_batch(wavs: list[np.ndarray], mels: list[np.ndarray], batch_size: int, max_time: int, hop: int,
               rng: np.random.Generator) -> tuple[np.ndarray, np.ndarray]:
    """Random hop-aligned (waveform (B, T, 1), mel (B, T / hop, C)) crops,
    the JAX function's draws from ``rng``: ``max_time`` rounded down to a
    whole number of hops (8000 -> 7936 at hop 256), short utterances
    zero-padded."""
    xs, cs = [], []
    frames = max_time // hop
    max_time = frames * hop
    for _ in range(batch_size):
        i = int(rng.integers(0, len(wavs)))
        w, m = wavs[i], mels[i]
        max_f = min(m.shape[0], w.shape[0] // hop) - frames
        f0 = int(rng.integers(0, max(1, max_f)))
        xw = w[f0 * hop : f0 * hop + max_time]
        xm = m[f0 : f0 + frames]
        if xw.shape[0] < max_time:
            xw = np.pad(xw, (0, max_time - xw.shape[0]))
        if xm.shape[0] < frames:
            xm = np.pad(xm, ((0, frames - xm.shape[0]), (0, 0)))
        xs.append(xw)
        cs.append(xm)
    return np.stack(xs).astype(np.float32)[..., None], np.stack(cs).astype(np.float32)


class WaveNetTrainer:
    """WaveNet from ``seed`` on ``device``, trained by ``train`` on
    ``crop_batch`` batches: Adam (0.9, 0.999, 1e-8) at ``lr * noam(count)``
    (count the updates this trainer has made), then the EMA of the
    parameters at ``ema_decay``."""

    def __init__(self, cfg: WaveNetConfig, lr: float = 1e-3, warmup: int = 4000, ema_decay: float = 0.9999,
                 seed: int = 0, init_step: int = 0, device: str | torch.device = "cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = WaveNet(cfg)
        self.model.reset_parameters(seed)
        self.model.to(self.device)
        self.lr, self.ema_decay, self.init_step = lr, ema_decay, init_step
        self.schedule = noam_schedule(warmup, init_step)
        self.leaves = JaxLeaves(self.model, state_to_flat,
                                lambda flat: wavenet_state_from_jax(unflatten_params(flat)))
        self._fresh_optimizer()
        self.history: list[float] = []

    def _fresh_optimizer(self) -> None:
        self.optimizer = torch.optim.Adam(self.model.parameters(), lr=self.lr, betas=(0.9, 0.999), eps=1e-8)
        self.count = 0  # optax's schedule count: updates made since construction (or restore)
        self.ema = init_ema(self.model)

    def step(self, x: np.ndarray | torch.Tensor, c: np.ndarray | torch.Tensor) -> torch.Tensor:
        """One update on waveform crops x (B, T, 1) and mels c (B, T/hop, C)
        -> the loss before it (a tensor on the device, not synchronised)."""
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        c = torch.as_tensor(c, dtype=torch.float32, device=self.device)
        with exact_f32(self.device):
            self.optimizer.zero_grad(set_to_none=True)
            loss = discretized_mol_loss(self.model.apply(x, c), x[..., 0], log_scale_min=self.cfg.log_scale_min)
            loss.backward()
            for group in self.optimizer.param_groups:
                group["lr"] = float(np.float32(self.lr) * self.schedule(self.count))
            self.optimizer.step()
            self.count += 1
            ema_update(self.ema, dict(self.model.named_parameters()), self.ema_decay)
        return loss.detach()

    def train(self, batches: Iterator, num_iters: int, log_step: int = 50) -> float:
        t0 = time.time()
        loss = float("nan")
        for i in range(1, num_iters + 1):
            loss_t = self.step(*next(batches))
            if i % log_step == 0 or i == num_iters:
                loss = float(loss_t)
                if not np.isfinite(loss):
                    # halt before the caller's save() can overwrite a good checkpoint
                    raise RuntimeError(f"[wavenet] non-finite nll at iter {i}; refusing to continue — resume from "
                                       f"the last saved checkpoint")
                self.history.append(loss)
                print(f"[wavenet] iter {i}/{num_iters} nll {loss:.4f} ({(time.time() - t0) / i:.2f}s/it)", flush=True)
        return loss

    def load(self, path: str) -> None:
        """Warm-start the parameters and the EMA from a saved ``.npz`` (f16
        storage upcast); the optimizer restarts."""
        with np.load(path) as z:
            flat = {k: z[k].astype(np.float32) if z[k].dtype == np.float16 else z[k] for k in z.files}
        self.model.load_state_dict(wavenet_state_from_jax(unflatten_params(flat)))
        self._fresh_optimizer()

    def save(self, path: str, use_ema: bool = True) -> None:
        """The ``.npz`` that ``WaveNetVocoder.from_checkpoint`` reads (both
        packages): the EMA parameters, or the raw ones."""
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        np.savez(path, **state_to_flat(self.ema if use_ema else dict(self.model.named_parameters())))

    def opt_count(self) -> int:
        """Optimizer steps since this trainer was built: the noam position is
        this plus ``init_step``."""
        return self.count

    def save_train_state(self, path: str) -> None:
        """The raw parameters, Adam's moments and count, the schedule count
        and ``init_step``, as the JAX trainer writes them."""
        params = [self.leaves.to_jax(n, p) for n, p in zip(self.leaves.names, self.leaves.params)]
        leaves = [*params, *self.leaves.adam_leaves(self.optimizer), np.asarray(self.count, np.int32)]
        np.savez(path, meta_init_step=np.int64(self.init_step), meta_count=np.int64(self.opt_count()),
                 **{f"leaf_{i}": np.asarray(x) for i, x in enumerate(leaves)})

    def restore_train_state(self, path: str) -> None:
        """The inverse of ``save_train_state``, after ``load`` (the EMA comes
        from the checkpoint). The trainer must have been built with the
        ``init_step`` of the run that wrote the state."""
        with np.load(path) as data:
            if "meta_init_step" in data:
                saved = int(data["meta_init_step"])
                if saved != self.init_step:
                    raise ValueError(f"train state {path} was written by a trainer with init_step={saved}; this "
                                     f"trainer was built with init_step={self.init_step}. Rebuild the trainer (or "
                                     f"pass --init_step {saved}) so the noam schedule resumes at the right position.")
            else:
                warnings.warn(f"{path} predates init_step metadata; trusting this trainer's "
                              f"init_step={self.init_step} to match the run that wrote it", stacklevel=2)
            n = len(self.leaves.params)
            leaves = [data[f"leaf_{i}"] for i in range(2 * n + 2 + n)]
        with torch.no_grad():
            for path_, p, value in zip(self.leaves.paths, self.leaves.params, leaves[:n]):
                p.copy_(self.leaves.from_jax(path_, value, p))
        self.leaves.load_adam_leaves(self.optimizer, leaves[n : 3 * n + 1])
        self.count = int(leaves[-1])
