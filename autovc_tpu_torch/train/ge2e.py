"""GE2E speaker-encoder training (Wan et al. 2018) and its checkpoints.

Counterpart of ``autovc_tpu/train/ge2e.py``: the softmax GE2E loss over a
batch of N speakers x M utterance crops with the learned similarity scale
and offset (w, b) and the leave-one-out centroid of an utterance's own
speaker, the batch sampler, and ``GE2ETrainer`` (the global-norm clip at
3.0, then Adam; an optional speaker-ID cross-entropy head; w held at 1e-2 or
more after each update). The encoder is the port's ``DVector`` in float32
with gradients on: its three LSTM layers run the kernels' training forms on
a card, forward, backward and the dW product (``ops.lstm``), at H=768 or
256 and B = N * M. Checkpoints are the flat ``.npz`` of the tree
``{'dvector', 'w', 'b'}`` in the JAX names and layouts (the head ``cls`` is
left out), which both packages' ``load_params`` read, such as
``artifacts/ge2e.npz``.
"""

from __future__ import annotations

import os
import time
from typing import Iterator

import numpy as np
import torch
import torch.nn.functional as F

from autovc_tpu_torch import exact_f32, resolve_device
from autovc_tpu_torch.io import dvector_state_from_jax, dvector_state_to_jax, flatten_params, unflatten_params
from autovc_tpu_torch.models.dvector import DVector


def load_params(path: str) -> dict:
    """The flat ``.npz`` of a GE2E checkpoint -> its nested tree
    (``{'dvector': {'lstm', 'embedding'}, 'w', 'b'}``), numpy leaves as
    stored, as ``GE2ETrainer.load_params`` returns it."""
    with np.load(path) as z:
        return unflatten_params({k: z[k] for k in z.files})


def ge2e_softmax_loss(embeds: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """embeds (N, M, D) unit vectors -> the mean over (j, i) of -log softmax_k
    S(j, i, k) at k = j, with S = w cos(e_ji, c_k) + b: c_k the normalised
    centroid of speaker k, and for k = j the centroid of speaker j's other
    M - 1 utterances (norms + 1e-6)."""
    n, m, _ = embeds.shape
    centroids = embeds.mean(dim=1)
    loo = (embeds.sum(dim=1, keepdim=True) - embeds) / (m - 1)
    loo = loo / (torch.linalg.vector_norm(loo, dim=-1, keepdim=True) + 1e-6)
    cnorm = centroids / (torch.linalg.vector_norm(centroids, dim=-1, keepdim=True) + 1e-6)
    sim = torch.einsum("nmd,kd->nmk", embeds, cnorm)
    own = torch.sum(embeds * loo, dim=-1)
    eye = torch.eye(n, dtype=embeds.dtype, device=embeds.device)[:, None, :]
    sim = sim * (1 - eye) + own[..., None] * eye
    logprob = torch.log_softmax(w * sim + b, dim=-1)
    return -torch.mean(torch.sum(logprob * eye, dim=-1))


def sample_ge2e_batch(features: list[list[np.ndarray]], n_speakers: int, m_utts: int, len_crop: int,
                      rng: np.random.Generator, return_labels: bool = False):
    """(N, M, len_crop, F) random crops of N distinct speakers, the JAX
    function's draws from ``rng`` (shorter utterances zero-padded); with
    ``return_labels`` also the (N,) speaker indices, int32."""
    spk = rng.choice(len(features), size=n_speakers, replace=False)
    out = np.zeros((n_speakers, m_utts, len_crop, features[0][0].shape[-1]), np.float32)
    for i, s in enumerate(spk):
        utts = features[s]
        for j in range(m_utts):
            u = utts[int(rng.integers(0, len(utts)))]
            if u.shape[0] <= len_crop:
                out[i, j, : u.shape[0]] = u
            else:
                off = int(rng.integers(0, u.shape[0] - len_crop))
                out[i, j] = u[off : off + len_crop]
    if return_labels:
        return out, spk.astype(np.int32)
    return out


class GE2ETrainer:
    """The d-vector (``dim_input``/``dim_cell``/``dim_emb``, 3 layers) drawn
    from ``seed``, w = 10 and b = -5, and with ``n_classes`` a linear
    speaker-ID head drawn from ``seed + 1`` (normal / sqrt(dim_emb), zero
    bias) whose cross-entropy is added at ``ce_weight``; trained on
    ``device``. ``wb_grad_scale`` scales the gradients of w and b before the
    clip (the paper's 0.01 under SGD; 1.0, a no-op, by default)."""

    def __init__(self, dim_input: int = 80, dim_cell: int = 768, dim_emb: int = 256, lr: float = 1e-4,
                 grad_clip: float = 3.0, seed: int = 0, wb_grad_scale: float = 1.0, n_classes: int = 0,
                 ce_weight: float = 1.0, device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.model = DVector(dim_input=dim_input, dim_cell=dim_cell, dim_emb=dim_emb)
        self.model.reset_parameters(seed)
        self.model.to(self.device).train()
        self.w = torch.nn.Parameter(torch.tensor(10.0, device=self.device))
        self.b = torch.nn.Parameter(torch.tensor(-5.0, device=self.device))
        self.n_classes, self.ce_weight = n_classes, ce_weight
        self.grad_clip, self.wb_grad_scale = grad_clip, wb_grad_scale
        self.cls: dict[str, torch.nn.Parameter] = {}
        if n_classes:
            gen = torch.Generator().manual_seed(seed + 1)
            kernel = torch.randn((dim_emb, n_classes), generator=gen) / np.sqrt(dim_emb)
            self.cls = {"kernel": torch.nn.Parameter(kernel.to(self.device)),
                        "bias": torch.nn.Parameter(torch.zeros(n_classes, device=self.device))}
        self.optimizer = torch.optim.Adam(self.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)
        self.history: list[float] = []

    def parameters(self) -> list[torch.nn.Parameter]:
        return [*self.model.parameters(), self.w, self.b, *self.cls.values()]

    @property
    def params(self) -> dict:
        """The JAX trainer's tree: ``{'dvector', 'w', 'b'}`` (and ``cls``),
        float32 numpy in the JAX layouts."""
        tree = {"dvector": dvector_state_to_jax(self.model.state_dict()),
                "w": self.w.detach().cpu().numpy(), "b": self.b.detach().cpu().numpy()}
        if self.cls:
            tree["cls"] = {k: v.detach().cpu().numpy() for k, v in self.cls.items()}
        return tree

    def load_tree(self, tree: dict) -> None:
        """Set the parameters from a JAX trainer's tree (the optimizer's
        state is kept)."""
        self.model.load_state_dict(dvector_state_from_jax(tree))
        with torch.no_grad():
            self.w.copy_(torch.as_tensor(np.array(tree["w"], np.float32)))
            self.b.copy_(torch.as_tensor(np.array(tree["b"], np.float32)))
            for k, v in self.cls.items():
                v.copy_(torch.as_tensor(np.array(tree["cls"][k], np.float32)))

    def loss(self, batch: torch.Tensor, labels: torch.Tensor | None = None) -> torch.Tensor:
        """The GE2E loss of an (N, M, T, F) batch (+ ``ce_weight`` x the
        cross-entropy of the head on the (N,) labels)."""
        n, m = batch.shape[:2]
        e = self.model(batch.reshape(n * m, *batch.shape[2:]))
        loss = ge2e_softmax_loss(e.reshape(n, m, -1), self.w, self.b)
        if self.n_classes:
            logits = e @ self.cls["kernel"] + self.cls["bias"]
            loss = loss + self.ce_weight * F.cross_entropy(logits, labels.long().repeat_interleave(m))
        return loss

    def step(self, batch, labels=None) -> torch.Tensor:
        """One update -> the loss before it (on the device)."""
        batch = torch.as_tensor(batch, device=self.device).float()
        if labels is not None:
            labels = torch.as_tensor(labels, device=self.device)
        with exact_f32(self.device):
            self.optimizer.zero_grad(set_to_none=True)
            loss = self.loss(batch, labels)
            loss.backward()
            with torch.no_grad():
                for p in (self.w, self.b):
                    p.grad.mul_(self.wb_grad_scale)
                # optax.clip_by_global_norm: g / |g| * clip where |g| >= clip
                grads = [p.grad for p in self.parameters()]
                norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
                for g in grads:
                    g.copy_(torch.where(norm < self.grad_clip, g, g / norm * self.grad_clip))
            self.optimizer.step()
            with torch.no_grad():
                self.w.clamp_(min=1e-2)  # w > 0, held after the update
        return loss.detach()

    def train(self, batches: Iterator, num_iters: int, log_step: int = 20) -> float | None:
        """``batches`` yield (N, M, T, F) crops, or (crops, (N,) labels) with
        the cross-entropy head."""
        t0 = time.time()
        for i in range(1, num_iters + 1):
            batch = next(batches)
            labels = None
            if isinstance(batch, tuple):
                batch, labels = batch
            elif self.n_classes:
                raise ValueError("GE2ETrainer was built with n_classes>0 but the batch iterator yields unlabeled "
                                 "arrays; use sample_ge2e_batch(..., return_labels=True)")
            loss = self.step(batch, labels)
            if i % log_step == 0 or i == num_iters:
                value = float(loss)
                self.history.append(value)
                print(f"[ge2e] iter {i}/{num_iters} loss {value:.4f} ({(time.time() - t0) / i:.2f}s/it)", flush=True)
        return self.history[-1] if self.history else None

    def save(self, path: str) -> None:
        """The flat ``.npz`` of ``{'dvector', 'w', 'b'}``: the head is a
        training scaffold and is not saved."""
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        tree = {k: v for k, v in self.params.items() if k != "cls"}
        np.savez(path, **flatten_params(tree))

    load_params = staticmethod(load_params)
