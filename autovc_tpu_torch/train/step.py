"""The train step of the generator family (spmel, stft and wav).

Counterpart of ``autovc_tpu/train/step.py``: the loss is the reference's
``g_loss_id + g_loss_id_psnt + lambda_cd * g_loss_cd`` for spmel and stft,
with the content re-encoding run on the postnet output in training mode, so
that it updates the encoder's BatchNorm statistics again as the JAX second
forward does (for wav, the reconstructed waveform re-encoded, and the
latent and SI-SNR terms added: ``loss_fn``);
Adam with optax's defaults; the learning rate set from the step before its
increment; a real per-step EMA. On a CUDA device the step runs in exact
float32 (``exact_f32``) and its LSTMs forward and backward through the
hand-written kernels (``ops.lstm.LSTMSequenceFn``). With
``cfg.model.compute_dtype="bfloat16"`` the generator computes in bfloat16
(its kernels' bfloat16 forms) while the parameters, their gradients, Adam's
state, the EMA, the BatchNorm statistics and the losses (which widen their
inputs) stay float32, as in the JAX step with ``--bf16``. Its LSTMs round as
``cfg.model.use_pallas_lstm`` says: by default as JAX's ``lax.scan`` (a
bfloat16 carry, each gate op rounded; JAX's ``--bf16``), and with it set as
the Pallas kernel (JAX's ``--bf16 --pallas``).

With ``cfg.train.lambda_spk > 0`` and a ``SpeakerAux``, the loss adds the
speaker-consistency auxiliary: the batch is converted within itself (the
target embeddings rolled by one row), the eval-mode postnet output is
re-embedded by the frozen d-vector encoder, and either a hinge on the
evaluation's own margin (protocol 'windowed') or a cosine pull toward the
target embedding (protocol 'crop') is added. The encoder's weights do not
require grad, so the gradient reaches the generator through the LSTM
kernels' backward without a weight gradient of the encoder. A bfloat16
generator's conversion goes to the encoder in bfloat16, whose dtype follows
its input as JAX's does: its LSTMs run in bfloat16 with the scan rounding
(a bfloat16 carry, each gate op rounded), its dense layer and the loss in
float32.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

from autovc_tpu_torch import exact_f32
from autovc_tpu_torch.config import Config, SpeakerEncoderConfig
from autovc_tpu_torch.eval import WINDOW_STRIDE
from autovc_tpu_torch.losses import l1, mse, si_snr_loss
from autovc_tpu_torch.models import DVector, Generator, GeneratorWav
from autovc_tpu_torch.parallel.mesh import Mesh, all_reduce, gather_params, roll_rows, shard_params
from autovc_tpu_torch.train import schedule as sched
from autovc_tpu_torch.train.state import TrainState, ema_update


class SpeakerAux(NamedTuple):
    """The frozen speaker encoder of the lambda_spk auxiliary, and the
    tables of its 'windowed' protocol.

    'crop': only ``model``: the single-window cosine pull toward the
    conditioning embedding.

    'windowed': ``emb_table`` and ``centroids`` present: the converted crop
    is embedded with the evaluation's windowed protocol
    (``eval.SpeakerEmbedder``), each row's speaker found as the nearest
    conditioning row of the train.pkl table, and a hinge enforces the
    evaluation's success criterion cos(e, target centroid) - cos(e, source
    centroid) >= spk_margin."""

    model: DVector  # frozen, on the generator's device
    emb_table: torch.Tensor | None = None  # (N, dim_emb) unit-norm train.pkl rows
    centroids: torch.Tensor | None = None  # (N, dim_emb) unit-norm evaluation centroids


def windowed_embed(dvector: DVector, mel: torch.Tensor, len_crop: int = SpeakerEncoderConfig.len_crop,
                   stride: int = WINDOW_STRIDE) -> torch.Tensor:
    """The differentiable twin of ``eval.SpeakerEmbedder.embed`` for a
    batch: (B, T, n_mels) -> (B, dim_emb) unit vectors from ``len_crop``-frame
    windows at ``stride`` (the tail window always included; a shorter input
    zero-padded to one window), one d-vector forward over all windows, the
    mean over each row's windows, L2-normalized."""
    b, t, c = mel.shape
    if t <= len_crop:
        wins = torch.nn.functional.pad(mel, (0, 0, 0, len_crop - t))[:, None]
    else:
        starts = list(range(0, t - len_crop + 1, stride))
        if starts[-1] != t - len_crop:  # always cover the tail
            starts.append(t - len_crop)
        wins = torch.stack([mel[:, s : s + len_crop] for s in starts], dim=1)
    n_win = wins.shape[1]
    e = dvector(wins.reshape(b * n_win, len_crop, c))
    e = e.reshape(b, n_win, e.shape[-1]).mean(dim=1)
    return e / (torch.linalg.vector_norm(e, dim=-1, keepdim=True) + 1e-12)


def _unit(v: torch.Tensor) -> torch.Tensor:
    return v / (torch.linalg.vector_norm(v, dim=-1, keepdim=True) + 1e-8)


def roll_batch(t: torch.Tensor, mesh: Mesh | None = None) -> torch.Tensor:
    """``torch.roll(t, 1, 0)`` of the global batch: each row takes the
    previous row's value; over a data-parallel mesh the roll crosses rank
    boundaries (``parallel.mesh.roll_rows``), as JAX's ``jnp.roll`` over a
    sharded batch axis does."""
    return torch.roll(t, 1, dims=0) if mesh is None else roll_rows(t, mesh, "data")


def speaker_loss(spk: SpeakerAux, cfg: Config, x_conv: torch.Tensor, emb: torch.Tensor, mesh: Mesh | None = None
                 ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """(g_loss_spk, extra metrics) of the cross-converted batch ``x_conv``
    (row i converted toward row i-1's embedding). Over a data-parallel
    ``mesh`` these are this rank's shares: the mean of the ranks' values is
    the global batch's (the 'windowed' mean divides by the global count of
    valid rows over the number of ranks)."""
    if cfg.train.spk_protocol == "windowed" and spk.centroids is not None:
        e_conv = windowed_embed(spk.model, x_conv)
        src_idx = torch.argmax(_unit(emb) @ spk.emb_table.T, dim=-1)
        trg_idx = roll_batch(src_idx, mesh)
        cos_trg = torch.sum(e_conv * spk.centroids[trg_idx], dim=-1)
        cos_src = torch.sum(e_conv * spk.centroids[src_idx], dim=-1)
        margin = cos_trg - cos_src
        valid = (src_idx != trg_idx).to(margin.dtype)
        if mesh is None:
            n_valid = torch.clamp(valid.sum(), min=1.0)
        else:
            n_valid = torch.clamp(all_reduce(valid.sum(), mesh, "data"), min=1.0) / mesh.size("data")
        g_loss_spk = torch.sum(torch.relu(cfg.train.spk_margin - margin) * valid) / n_valid
        return g_loss_spk, {"g_spk_margin": torch.sum(margin * valid) / n_valid}
    e_conv = spk.model(x_conv)
    e_trg = _unit(roll_batch(emb, mesh))
    return torch.mean(1.0 - torch.sum(e_conv * e_trg, dim=-1)), {}


def make_optimizer(model: Generator | GeneratorWav, cfg: Config) -> torch.optim.Adam:
    """Adam over every parameter with optax's defaults: betas (0.9, 0.999),
    eps 1e-8, learning rate ``cfg.train.lr`` (the step sets it each time)."""
    return torch.optim.Adam(model.parameters(), lr=cfg.train.lr, betas=(0.9, 0.999), eps=1e-8)


def loss_fn(model: Generator | GeneratorWav, cfg: Config, x: torch.Tensor, emb: torch.Tensor, train: bool = True,
            spk: SpeakerAux | None = None, mesh: Mesh | None = None) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """(total, metrics) of one batch; ``train`` runs the generator in train
    mode (batch statistics, running statistics updated), else in eval mode.
    The model's mode is restored afterwards.

    spmel and stft: ``g_loss_id + g_loss_id_psnt + lambda_cd * g_loss_cd``,
    the content re-encoded from the postnet output. ``spk`` enables the
    lambda_spk auxiliary (when ``cfg.train.lambda_spk > 0``, spmel only):
    its conversion runs in eval mode on the running statistics as they were
    before this batch, as the JAX loss runs it on the step's input
    statistics.

    wav: ``g_loss_id + lambda_sisnr * g_loss_sisnr + g_loss_gen + lambda_cd
    * g_loss_cd``: the waveform MSE, the SI-SNR of the waveform (float32),
    the MSE between the front end's latent and the core decoder's output
    (a gradient into both), and the content L1 against the codes of the
    reconstructed waveform, re-encoded with the statistics the first pass
    updated. ``spk`` is ignored, as the JAX wav loss ignores it.

    ``mesh``: x and emb are this rank's rows of a batch split over the
    mesh's 'data' axis. Each term is then this rank's share, whose mean over
    the ranks is the global batch's term (equal shards: a local mean), the
    within-batch cross-pairs are the global batch's, and BatchNorm takes
    the global statistics where ``parallel.mesh.sync_batch_norm`` set it."""
    mt = cfg.model.model_type
    if mt not in ("spmel", "stft", "wav"):
        raise ValueError(f"unknown model_type {mt!r}")
    use_spk = spk is not None and cfg.train.lambda_spk > 0 and mt != "wav"
    if use_spk and mt != "spmel":
        raise ValueError("lambda_spk requires mel-domain outputs (model_type spmel)")
    was_training = model.training
    try:
        x_conv = None
        if use_spk:
            model.eval()
            x_conv = model(x, emb, roll_batch(emb, mesh))[1]  # within-batch cross-pairs
        model.train(train)
        if mt == "wav":
            lat, x_identic, x_dec, codes = model(x, emb, emb)
            metrics = {"g_loss_id": mse(x, x_identic), "g_loss_gen": mse(lat, x_dec),
                       "g_loss_cd": l1(codes, model.encode(x_identic, emb)),
                       "g_loss_sisnr": si_snr_loss(x_identic[..., 0], x[..., 0])}
        else:
            x_identic, x_psnt, codes = model(x, emb, emb)
            metrics = {"g_loss_id": mse(x, x_identic), "g_loss_id_psnt": mse(x, x_psnt),
                       "g_loss_cd": l1(codes, model.encode(x_psnt, emb))}
    finally:
        model.train(was_training)
    if mt == "wav":
        total = (metrics["g_loss_id"] + cfg.train.lambda_sisnr * metrics["g_loss_sisnr"] + metrics["g_loss_gen"]
                 + cfg.train.lambda_cd * metrics["g_loss_cd"])
    else:
        total = metrics["g_loss_id"] + metrics["g_loss_id_psnt"] + cfg.train.lambda_cd * metrics["g_loss_cd"]
    if use_spk:
        g_loss_spk, extra = speaker_loss(spk, cfg, x_conv, emb, mesh)
        total = total + cfg.train.lambda_spk * g_loss_spk
        metrics.update(extra, g_loss_spk=g_loss_spk)
    return total, {k: v.detach() for k, v in dict(metrics, g_loss=total).items()}


def learning_rate(cfg: Config, step: int, lr_scale: float = 1.0) -> float:
    """base * (cosine(step) if enabled) * host scale (plateau)."""
    tc = cfg.train
    scale = lr_scale
    if tc.lr_scheduler == "Cosine":
        scale *= sched.cosine_annealing(step, tc.cosine_t_max)
    elif tc.lr_scheduler == "CosineDecay":
        scale *= sched.cosine_decay(step, tc.num_iters, tc.cosine_eta_min_ratio)
    return tc.lr * scale


def backward(model: Generator | GeneratorWav, cfg: Config, x: torch.Tensor, emb: torch.Tensor,
             spk: SpeakerAux | None = None, mesh: Mesh | None = None) -> dict[str, torch.Tensor]:
    """The training loss of one batch and its gradients in the parameters'
    ``.grad`` (which must be None or zero) -> the metrics. Over a mesh whose
    'data' axis is longer than 1, the gradients and metrics are averaged
    over it (one collective each): every rank then holds the global batch's
    gradient, as JAX's GSPMD step computes it."""
    total, metrics = loss_fn(model, cfg, x, emb, train=True, spk=spk, mesh=mesh)
    total.backward()
    if mesh is None or mesh.groups.get("data") is None:
        return metrics
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    flat = all_reduce(_flatten_dense_tensors(grads), mesh, "data", "avg")
    for g, v in zip(grads, _unflatten_dense_tensors(flat, grads)):
        g.copy_(v)
    names = sorted(metrics)
    values = all_reduce(torch.stack([metrics[k].float() for k in names]), mesh, "data", "avg")
    return dict(zip(names, values.unbind()))


def make_train_step(cfg: Config, spk: SpeakerAux | None = None, mesh: Mesh | None = None,
                    shards: dict[str, int | None] | None = None) -> Callable[..., dict[str, torch.Tensor]]:
    """The step: (state, x, emb, lr_scale) -> metrics, updating ``state`` in
    place. The metrics stay on the device (no host sync) and include ``lr``
    and ``grad_norm``, the global L2 norm of the gradients. ``spk``: the
    lambda_spk auxiliary's encoder (see ``loss_fn``). ``mesh``: data
    parallelism over its 'data' axis (``backward``). ``shards``: tensor
    parallelism over its 'model' axis, the sharded axis of each parameter
    (``parallel.mesh.param_shardings``): between steps each rank holds its
    slice of those parameters and of their EMA; the step gathers the slices,
    updates the whole parameters (Adam's moments are whole on every rank, as
    JAX keeps them replicated) and keeps its slice again."""
    tp = mesh is not None and shards is not None and any(a is not None for a in shards.values())

    def step_fn(state: TrainState, x: torch.Tensor, emb: torch.Tensor, lr_scale: float = 1.0):
        model, opt = state.model, state.optimizer
        lr = learning_rate(cfg, state.step, lr_scale)
        if tp:
            gather_params(model, shards, mesh)
        params = dict(model.named_parameters())
        opt.zero_grad(set_to_none=True)
        with exact_f32(x.device):
            metrics = backward(model, cfg, x, emb, spk, mesh)
            grad_norm = torch.linalg.vector_norm(
                torch.stack(torch._foreach_norm([p.grad for p in params.values()])))
            for group in opt.param_groups:
                group["lr"] = lr
            opt.step()
            if tp:
                shard_params(model, shards, mesh)
            ema_update(state.ema_params, dict(model.named_parameters()), cfg.train.ema_decay)
        state.step += 1
        return dict(metrics, lr=torch.tensor(lr), grad_norm=grad_norm)

    return step_fn


def make_eval_loss(model: Generator | GeneratorWav, cfg: Config, spk: SpeakerAux | None = None
                   ) -> Callable[[torch.Tensor, torch.Tensor], dict]:
    """The eval-mode loss: running statistics, no gradient, nothing mutated.
    ``spk`` is the train step's, so that with lambda_spk > 0 the eval
    g_loss holds the same terms as the training g_loss."""

    def eval_fn(x: torch.Tensor, emb: torch.Tensor) -> dict[str, torch.Tensor]:
        with torch.no_grad(), exact_f32(x.device):
            return loss_fn(model, cfg, x, emb, train=False, spk=spk)[1]

    return eval_fn
