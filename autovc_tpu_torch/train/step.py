"""The train step of the spmel generator.

Counterpart of ``autovc_tpu/train/step.py``: the loss is the reference's
``g_loss_id + g_loss_id_psnt + lambda_cd * g_loss_cd``, with the content
re-encoding run on the postnet output in training mode, so that it updates
the encoder's BatchNorm statistics again as the JAX second forward does;
Adam with optax's defaults; the learning rate set from the step before its
increment; a real per-step EMA. On a CUDA device the step runs in exact
float32 (``exact_f32``) and its LSTMs forward and backward through the
hand-written kernels (``ops.lstm.LSTMSequenceFn``).
"""

from __future__ import annotations

from typing import Callable

import torch

from autovc_tpu_torch import exact_f32
from autovc_tpu_torch.config import Config
from autovc_tpu_torch.losses import l1, mse
from autovc_tpu_torch.models import Generator
from autovc_tpu_torch.train import schedule as sched
from autovc_tpu_torch.train.state import TrainState, ema_update


def make_optimizer(model: Generator, cfg: Config) -> torch.optim.Adam:
    """Adam over every parameter with optax's defaults: betas (0.9, 0.999),
    eps 1e-8, learning rate ``cfg.train.lr`` (the step sets it each time)."""
    return torch.optim.Adam(model.parameters(), lr=cfg.train.lr, betas=(0.9, 0.999), eps=1e-8)


def loss_fn(model: Generator, cfg: Config, x: torch.Tensor, emb: torch.Tensor, train: bool = True
            ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """(total, metrics) of one batch; ``train`` runs the generator in train
    mode (batch statistics, running statistics updated), else in eval mode.
    The model's mode is restored afterwards."""
    if cfg.model.model_type != "spmel":
        raise ValueError(f"model_type {cfg.model.model_type!r} is not ported (ROADMAP Queue 1 #5, #6)")
    if cfg.train.lambda_spk > 0:
        raise NotImplementedError("lambda_spk > 0 needs the speaker encoder, not ported yet "
                                  "(ROADMAP Queue 1 #4)")
    was_training = model.training
    model.train(train)
    try:
        x_identic, x_psnt, codes = model(x, emb, emb)
        g_loss_id = mse(x, x_identic)
        g_loss_id_psnt = mse(x, x_psnt)
        g_loss_cd = l1(codes, model.encode(x_psnt, emb))
    finally:
        model.train(was_training)
    total = g_loss_id + g_loss_id_psnt + cfg.train.lambda_cd * g_loss_cd
    metrics = {"g_loss": total, "g_loss_id": g_loss_id, "g_loss_id_psnt": g_loss_id_psnt,
               "g_loss_cd": g_loss_cd}
    return total, {k: v.detach() for k, v in metrics.items()}


def learning_rate(cfg: Config, step: int, lr_scale: float = 1.0) -> float:
    """base * (cosine(step) if enabled) * host scale (plateau)."""
    tc = cfg.train
    scale = lr_scale
    if tc.lr_scheduler == "Cosine":
        scale *= sched.cosine_annealing(step, tc.cosine_t_max)
    elif tc.lr_scheduler == "CosineDecay":
        scale *= sched.cosine_decay(step, tc.num_iters, tc.cosine_eta_min_ratio)
    return tc.lr * scale


def make_train_step(cfg: Config) -> Callable[..., dict[str, torch.Tensor]]:
    """The step: (state, x, emb, lr_scale) -> metrics, updating ``state`` in
    place. The metrics stay on the device (no host sync) and include ``lr``
    and ``grad_norm``, the global L2 norm of the gradients."""

    def step_fn(state: TrainState, x: torch.Tensor, emb: torch.Tensor, lr_scale: float = 1.0):
        model, opt = state.model, state.optimizer
        lr = learning_rate(cfg, state.step, lr_scale)
        params = dict(model.named_parameters())
        opt.zero_grad(set_to_none=True)
        with exact_f32(x.device):
            total, metrics = loss_fn(model, cfg, x, emb, train=True)
            total.backward()
            grad_norm = torch.linalg.vector_norm(
                torch.stack(torch._foreach_norm([p.grad for p in params.values()])))
            for group in opt.param_groups:
                group["lr"] = lr
            opt.step()
            ema_update(state.ema_params, params, cfg.train.ema_decay)
        state.step += 1
        return dict(metrics, lr=torch.tensor(lr), grad_norm=grad_norm)

    return step_fn


def make_eval_loss(model: Generator, cfg: Config) -> Callable[[torch.Tensor, torch.Tensor], dict]:
    """The eval-mode loss: running statistics, no gradient, nothing mutated."""

    def eval_fn(x: torch.Tensor, emb: torch.Tensor) -> dict[str, torch.Tensor]:
        with torch.no_grad(), exact_f32(x.device):
            return loss_fn(model, cfg, x, emb, train=False)[1]

    return eval_fn
