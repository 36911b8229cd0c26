"""The port's training slice against the JAX package on the CPU: the LSTM
training forward and backward (the Pallas kernels in interpret mode), the
autograd Function, BatchNorm in training form, the loss and its gradients,
a three-step trajectory, the schedules, EMA, data pipeline, Solver and CLI.
The CUDA kernels are held against the plain versions on a card in
tests/test_torch_gpu.py."""

import os
import pickle
import sys
import threading
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from autovc_tpu.config import Config as JaxConfig
from autovc_tpu.config import ModelConfig as JaxModelConfig
from autovc_tpu.config import TrainConfig as JaxTrainConfig
from autovc_tpu.models.autovc import Decoder, Encoder, Generator as JaxGenerator, Postnet
from autovc_tpu.models.layers import BatchNorm as JaxBatchNorm
from autovc_tpu.ops import pallas_lstm as pk
from autovc_tpu.train import state as jax_state
from autovc_tpu.train import step as jax_step
from autovc_tpu_torch import exact_f32
from autovc_tpu_torch.config import Config, ModelConfig, TrainConfig
from autovc_tpu_torch.data import BatchIterator, SpeakerEntry, UtteranceDataset, save_train_manifest
from autovc_tpu_torch.data.prefetch import DevicePrefetcher
from autovc_tpu_torch.io import (flatten_params, generator_state_from_jax, generator_state_to_jax, load_artifact,
                                 save_generator_artifact)
from autovc_tpu_torch.models import build_generator
from autovc_tpu_torch.models.layers import BatchNorm
from autovc_tpu_torch.ops import lstm as lstm_ops
from autovc_tpu_torch.train import (ReduceLROnPlateau, Solver, TrainState, cosine_annealing, cosine_decay,
                                    ema_update, init_ema, loss_fn, make_optimizer, make_train_step)
from autovc_tpu_torch.train.compare import KinkTape, grad_scale

torch.set_num_threads(1)

B, T, H = 8, 12, 32


def _lstm_inputs(seed, b=B, t=T, hidden=H):
    rng = np.random.RandomState(seed)
    xproj = (rng.randn(b, t, 4 * hidden) * 0.5).astype(np.float32)
    w_hh = (rng.randn(hidden, 4 * hidden) * 0.2).astype(np.float32)
    h0, c0 = (rng.randn(b, hidden).astype(np.float32) * 0.5 for _ in range(2))
    dy = rng.randn(b, t, hidden).astype(np.float32)
    dhn, dcn = (rng.randn(b, hidden).astype(np.float32) for _ in range(2))
    return xproj, w_hh, h0, c0, dy, dhn, dcn


def _time_major(a, reverse):
    """(B, T, ...) -> the JAX chunk's (T, B, ...) in its order of steps."""
    a = np.swapaxes(np.asarray(a), 0, 1)
    return a[::-1] if reverse else a


# ---------------------------------------------------------------- (i) forward


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("kernel", ["chunk", "split"])
def test_train_forward_matches_pallas_interpret(kernel, reverse):
    """h_seq, c_seq, hN and cN of the plain training forward against the
    Pallas training kernels (``_lstm_kernel_train`` via ``_chunk_fwd``, and
    ``_lstm_kernel_split_train`` via ``_lstm_chunk_split_impl``), nonzero
    initial state, within 1e-5. reverse: the JAX chunk runs on the flipped
    sequence, as ``_lstm_sequence`` runs it."""
    xproj, w_hh, h0, c0 = _lstm_inputs(0)[:4]
    args = (jnp.asarray(_time_major(xproj, reverse).copy()), jnp.asarray(w_hh), jnp.asarray(h0), jnp.asarray(c0))
    if kernel == "chunk":
        want = pk._chunk_fwd(*args, interpret=True, with_residual=True)
    else:
        want = pk._lstm_chunk_split_impl(*args, True, with_residual=True)
    got = lstm_ops.lstm_sequence_train_ref(*map(torch.from_numpy, (xproj, w_hh, h0, c0)), reverse=reverse)
    np.testing.assert_allclose(_time_major(got[0].numpy(), reverse), np.asarray(want[0]), atol=1e-5, rtol=0)
    np.testing.assert_allclose(_time_major(got[1].numpy(), reverse), np.asarray(want[1]), atol=1e-5, rtol=0)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), atol=1e-5, rtol=0)
    np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]), atol=1e-5, rtol=0)


# --------------------------------------------------------------- (ii) backward


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("kernel", ["chunk", "split"])
def test_backward_matches_pallas_interpret(kernel, reverse):
    """The plain backward against ``_chunk_bwd_call`` (``_lstm_bwd_kernel``,
    dW accumulated in the kernel) and ``_split_bwd_rule``
    (``_lstm_bwd_kernel_split``, dW as one product outside), on the same
    residuals and cotangents; tolerances of tests/test_ops.py: dx 2e-5, dW
    2e-4, dh0 and dc0 2e-5. The split rule is called directly at H=32."""
    xproj, w_hh, h0, c0, dy, dhn, dcn = _lstm_inputs(1)
    t_ = [torch.from_numpy(a) for a in (xproj, w_hh, h0, c0)]
    h_seq, c_seq, _, _ = lstm_ops.lstm_sequence_train_ref(*t_, reverse=reverse)
    got = lstm_ops.lstm_backward_ref(*t_, h_seq, c_seq, torch.from_numpy(dy), torch.from_numpy(dhn),
                                     torch.from_numpy(dcn), reverse)
    xt = jnp.asarray(_time_major(xproj, reverse).copy())
    jw, jh0, jc0 = jnp.asarray(w_hh), jnp.asarray(h0), jnp.asarray(c0)
    jdy, jdhn, jdcn = jnp.asarray(_time_major(dy, reverse).copy()), jnp.asarray(dhn), jnp.asarray(dcn)
    if kernel == "chunk":
        jh = jnp.asarray(_time_major(h_seq.numpy(), reverse).copy())
        jc = jnp.asarray(_time_major(c_seq.numpy(), reverse).copy())
        want = pk._chunk_bwd_call(xt, jw, jh0, jc0, jh, jc, jdy, jdhn, jdcn, interpret=True)
    else:
        _, residuals = pk._split_fwd_rule(xt, jw, jh0, jc0, True)
        want = pk._split_bwd_rule(True, residuals, (jdy, jdhn, jdcn))
    np.testing.assert_allclose(_time_major(got[0].numpy(), reverse), np.asarray(want[0]), atol=2e-5, rtol=0)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=2e-4, rtol=0)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), atol=2e-5, rtol=0)
    np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]), atol=2e-5, rtol=0)


# ----------------------------------------------------- (iii) Function gradients


@pytest.mark.parametrize("reverse", [False, True])
def test_function_gradients_match_jax_grad(reverse):
    """torch autograd through ``LSTMSequenceFn`` (the plain versions on the
    CPU) against ``jax.grad`` of the Pallas ``_lstm_sequence`` in interpret
    mode with chunk=8 < T (two chunks, the (hN, cN) seam between them):
    dx 2e-5, dW 2e-4."""
    xproj, w_hh, _, _, dy = _lstm_inputs(2)[:5]

    def jax_loss(xp, w):
        return jnp.sum(pk._lstm_sequence(xp, w, reverse=reverse, interpret=True, chunk=8) * dy)

    want_dx, want_dw = jax.grad(jax_loss, argnums=(0, 1))(jnp.asarray(xproj), jnp.asarray(w_hh))
    x = torch.from_numpy(xproj).requires_grad_()
    w = torch.from_numpy(w_hh).requires_grad_()
    out = lstm_ops.lstm_sequence(x, w, reverse)
    (out * torch.from_numpy(dy)).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_dx), atol=2e-5, rtol=0)
    np.testing.assert_allclose(w.grad.numpy(), np.asarray(want_dw), atol=2e-4, rtol=0)


def test_function_state_gradients_match_autograd():
    """dh0 and dc0 of the Function (and its hN, cN cotangents) against torch
    autograd through the plain loop, both directions."""
    xproj, w_hh, h0, c0, dy, dhn, dcn = map(torch.from_numpy, _lstm_inputs(3))
    for reverse in (False, True):
        a = [v.clone().requires_grad_() for v in (xproj, w_hh, h0, c0)]
        r = [v.clone().requires_grad_() for v in (xproj, w_hh, h0, c0)]
        h_seq, hn, cn = lstm_ops.LSTMSequenceFn.apply(*a, reverse)
        ((h_seq * dy).sum() + (hn * dhn).sum() + (cn * dcn).sum()).backward()
        rh, _, rhn, rcn = lstm_ops.lstm_sequence_train_ref(*r, reverse)
        ((rh * dy).sum() + (rhn * dhn).sum() + (rcn * dcn).sum()).backward()
        for va, vr in zip(a, r):
            torch.testing.assert_close(va.grad, vr.grad, atol=1e-5, rtol=0)


@pytest.mark.parametrize("reverse", [False, True])
def test_function_computes_no_weight_gradient_for_a_frozen_w_hh(reverse):
    """With w_hh frozen (a frozen encoder), the backward leaves dW out (None,
    ``need_dw``) and gives the same dx as with dW; the plain backward's dW
    is None when not asked for."""
    xproj, w_hh, _, _, dy = _lstm_inputs(6)[:5]
    grads = []
    for frozen in (False, True):
        x = torch.from_numpy(xproj).requires_grad_()
        w = torch.from_numpy(w_hh).requires_grad_(not frozen)
        (lstm_ops.lstm_sequence(x, w, reverse) * torch.from_numpy(dy)).sum().backward()
        grads.append((x.grad, w.grad))
    assert grads[0][1] is not None and grads[1][1] is None
    assert torch.equal(grads[0][0], grads[1][0])
    t_ = [torch.from_numpy(a) for a in _lstm_inputs(7)[:4]]
    h_seq, c_seq, _, _ = lstm_ops.lstm_sequence_train_ref(*t_, reverse=reverse)
    args = (*t_, h_seq, c_seq, torch.from_numpy(dy), None, None, reverse)
    full, frozen = lstm_ops.lstm_backward_ref(*args), lstm_ops.lstm_backward_ref(*args, need_dw=False)
    assert frozen[1] is None and all(torch.equal(full[i], frozen[i]) for i in (0, 2, 3))


def test_lstm_sequence_without_grad_stays_plain():
    """Under no_grad (inference) the Function is not entered: no graph."""
    xproj, w_hh = (torch.from_numpy(a).requires_grad_() for a in _lstm_inputs(4)[:2])
    with torch.no_grad():
        out = lstm_ops.lstm_sequence(xproj, w_hh)
    assert out.grad_fn is None
    assert lstm_ops.lstm_sequence(xproj, w_hh).grad_fn is not None


# ------------------------------------------------------ (iv) BatchNorm training


def test_batchnorm_training_form_matches_flax():
    """Two training calls at N = B*T = 64 (where the biased and unbiased
    variances differ by 1.6%), then an eval call: outputs and running
    statistics against flax ``BatchNorm(use_running_average=False)`` with
    the two-pass variance, within 1e-6."""
    rng = np.random.RandomState(5)
    xs = [(rng.randn(2, 32, 16) * 2.0 + 3.0).astype(np.float32) for _ in range(3)]
    flax_bn = JaxBatchNorm()
    variables = flax_bn.init(jax.random.PRNGKey(0), jnp.asarray(xs[0]), use_running_average=False)
    bn = BatchNorm(16)
    bn.reset_parameters(torch.Generator())
    scale = rng.rand(16).astype(np.float32) + 0.5
    bias = rng.randn(16).astype(np.float32)
    params = {"BatchNorm_0": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}}
    bn.weight.data = torch.from_numpy(scale)
    bn.bias.data = torch.from_numpy(bias)
    stats = variables["batch_stats"]
    bn.train()
    for x in xs[:2]:
        want, upd = flax_bn.apply({"params": params, "batch_stats": stats}, jnp.asarray(x),
                                  use_running_average=False, mutable=["batch_stats"])
        stats = upd["batch_stats"]
        np.testing.assert_allclose(bn(torch.from_numpy(x)).detach().numpy(), np.asarray(want), atol=1e-6, rtol=0)
        np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(stats["BatchNorm_0"]["mean"]),
                                   atol=1e-6, rtol=0)
        np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(stats["BatchNorm_0"]["var"]),
                                   atol=1e-6, rtol=0)
    bn.eval()
    want = flax_bn.apply({"params": params, "batch_stats": stats}, jnp.asarray(xs[2]), use_running_average=True)
    np.testing.assert_allclose(bn(torch.from_numpy(xs[2])).detach().numpy(), np.asarray(want), atol=1e-6, rtol=0)


# ------------------------------------------------------- (v) loss and gradients

NARROW = dict(dim_neck=8, dim_emb=16, dim_pre=32, freq=8)


class NarrowGenerator(JaxGenerator):
    """The JAX generator at narrow widths: encoder channels 32, decoder
    lstm_dim 64, postnet channels 32 (the JAX package hard-codes the
    published ones)."""

    def setup(self):
        self.encoder = Encoder(self.dim_neck, self.freq, channels=32)
        self.decoder = Decoder(self.n_bins, self.dim_pre, lstm_dim=64)
        self.postnet = Postnet(self.n_bins, channels=32)


PORT_CFG = Config(model=ModelConfig(**NARROW, enc_channels=32, dec_lstm_dim=64, postnet_channels=32))


def _jax_cfg(**train):
    return JaxConfig(model=JaxModelConfig(model_type="spmel", **NARROW), train=JaxTrainConfig(**train))


def _batch(seed, b=4, t=32):
    rng = np.random.RandomState(seed)
    return rng.rand(b, t, 80).astype(np.float32), rng.randn(b, NARROW["dim_emb"]).astype(np.float32)


def _jax_init(seed=0):
    model = NarrowGenerator(**NARROW)
    x, emb = _batch(100)
    variables = model.init(jax.random.PRNGKey(seed), jnp.asarray(x), jnp.asarray(emb), jnp.asarray(emb))
    return model, variables["params"], variables["batch_stats"]


def _port_model(params, stats, cfg=PORT_CFG):
    model = build_generator(cfg.model, device="cpu", trainable=True)
    model.load_state_dict(generator_state_from_jax({"params": params, "batch_stats": stats}))
    return model


def test_loss_and_gradients_match_jax():
    """``loss_fn`` and every gradient leaf against ``jax.value_and_grad`` of
    the JAX ``loss_fn`` on the same weights and batch (training mode, the
    second encode included): the loss within 1e-5 relative, each leaf
    within 1e-4 of its ``grad_scale``, the updated BatchNorm statistics
    within 1e-5."""
    jmodel, params, stats = _jax_init()
    x, emb = _batch(1)
    (jtotal, (jm, jstats)), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jax_step.loss_fn(jmodel, _jax_cfg(), p, stats, jnp.asarray(x), jnp.asarray(emb)),
        has_aux=True))(params)
    model = _port_model(params, stats)
    total, metrics = loss_fn(model, PORT_CFG, torch.from_numpy(x), torch.from_numpy(emb))
    total.backward()
    assert abs(float(total.detach()) - float(jtotal)) <= 1e-5 * abs(float(jtotal))
    for k in ("g_loss_id", "g_loss_id_psnt", "g_loss_cd"):
        assert float(metrics[k]) == pytest.approx(float(jm[k]), rel=1e-5), k
    want = generator_state_from_jax({"params": jgrads, "batch_stats": jstats})
    for name, p in model.named_parameters():
        torch.testing.assert_close(p.grad, want[name], atol=1e-4 * grad_scale(name, want), rtol=0, msg=name)
    for name, buf in model.named_buffers():
        torch.testing.assert_close(buf, want[name], atol=1e-5, rtol=0, msg=name)


def test_loss_composition_and_eval_mode():
    """total = id + id_psnt + lambda_cd * cd; eval mode leaves the running
    statistics as they were; lambda_spk > 0 without a speaker encoder is the
    reference objective, as in the JAX loss (the auxiliary itself:
    tests/test_torch_speaker.py)."""
    cfg = Config(model=PORT_CFG.model, train=TrainConfig(lambda_cd=2.5))
    model = build_generator(cfg.model, device="cpu", seed=1, trainable=True)
    x, emb = map(torch.from_numpy, _batch(2))
    total, m = loss_fn(model, cfg, x, emb)
    assert float(total) == pytest.approx(float(m["g_loss_id"] + m["g_loss_id_psnt"] + 2.5 * m["g_loss_cd"]),
                                         rel=1e-6)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    with torch.no_grad():
        loss_fn(model, cfg, x, emb, train=False)
    assert all(torch.equal(before[k], v) for k, v in model.state_dict().items())
    assert model.training
    cfg_spk = Config(model=PORT_CFG.model, train=TrainConfig(lambda_cd=2.5, lambda_spk=0.5))
    with torch.no_grad():
        total_spk, m_spk = loss_fn(model, cfg_spk, x, emb, train=False)
        total_ref, m_ref = loss_fn(model, cfg, x, emb, train=False)
    assert "g_loss_spk" not in m_spk and torch.equal(total_spk, total_ref)


def test_kink_tape_replays_a_step_exactly():
    """A step replayed on its own record takes every kink as it did: no
    flips, the same loss to the bit and the same gradients within 1e-5 of
    each leaf's ``grad_scale`` (``x * mask`` in place of a ReLU changes the
    backward graph, and so the order in which autograd sums)."""
    x, emb = map(torch.from_numpy, _batch(3))
    grads, losses = [], []
    tape = KinkTape()
    for mode in (tape.record, tape.replay):
        model = build_generator(PORT_CFG.model, device="cpu", seed=2, trainable=True)
        with mode():
            total, _ = loss_fn(model, PORT_CFG, x, emb)
            total.backward()
        losses.append(total.detach())
        grads.append({n: p.grad for n, p in model.named_parameters()})
    # 9 ReLUs (encoder 3, decoder 3, the second encode 3) and the content L1
    assert [kind for kind, _ in tape.sides] == ["relu"] * 9 + ["abs"]
    assert tape.flips == 0 and tape.elements == sum(s.numel() for _, s in tape.sides)
    assert torch.equal(*losses)
    for n, g in grads[0].items():
        torch.testing.assert_close(grads[1][n], g, atol=1e-5 * grad_scale(n, grads[0]), rtol=0, msg=n)


def test_kink_tape_counts_and_forces_the_other_side():
    """An element recorded on one side of a kink and replayed from the
    other is counted and takes the recorded side's value and gradient; a
    replay whose calls differ from the record raises."""
    tape = KinkTape()
    with tape.record():
        torch.relu(torch.tensor([1.0, -1.0, 1e-9]))
        torch.abs(torch.tensor([2.0, -1e-9]))
    x = torch.tensor([1.0, -1.0, -1e-9], requires_grad=True)
    y = torch.tensor([2.0, 1e-9], requires_grad=True)
    with tape.replay():
        out = torch.relu(x)
        (out.sum() + torch.abs(y).sum()).backward()
    assert tape.flips == 2
    assert x.grad.tolist() == [1.0, 0.0, 1.0] and y.grad.tolist() == [1.0, -1.0]
    assert out[:2].tolist() == [1.0, 0.0]
    with pytest.raises(RuntimeError, match="record has"), tape.replay():
        torch.abs(torch.tensor([1.0, 2.0, 3.0]))
    with pytest.raises(RuntimeError, match="fewer kinked calls"), tape.replay():
        torch.relu(torch.tensor([1.0, -1.0, 1e-9]))


def test_grad_scale_measures_a_conv_bias_by_its_weight():
    grads = {"a.conv1.weight": torch.tensor([[-3.0, 1.0]]), "a.conv1.bias": torch.tensor([1e-9]),
             "a.bn1.bias": torch.tensor([0.5, -2.0])}
    assert [grad_scale(n, grads) for n in grads] == [3.0, 3.0, 2.0]


# ------------------------------------------------------ (vi) three-step trajectory


@pytest.mark.parametrize("scheduler", [None, "CosineDecay"])
def test_three_steps_match_jax_train_step(scheduler):
    """Three steps of the port's train step against the jitted JAX
    ``make_train_step`` from the same weights on the same batches.

    Tolerances: each step's loss within 1e-5 relative and its learning rate
    within 1e-6; the parameters within 6e-4, with at most 5% of the elements
    of any leaf other than a convolution's bias more than 2e-6 apart; the
    EMA within 1e-7; the BatchNorm statistics within 1e-4. Why so: Adam
    turns a gradient element well above its eps (1e-8) into an update of
    about lr = 1e-4 whatever its size, so an element whose gradient is at
    the rounding level of the two float32 engines can move by lr in either
    direction, and the two sides end up to 2 * 3 * lr = 6e-4 apart there.
    That is every element of a convolution's bias, whose gradient is zero in
    exact arithmetic (BatchNorm follows every convolution), and a few
    elements elsewhere; every other element follows within 2e-6. The EMA
    moves by 1e-4 of the parameters' steps, and the running statistics
    follow activations of parameters that are up to 6e-4 apart."""
    jcfg = _jax_cfg(lr_scheduler=scheduler, num_iters=3)
    cfg = Config(model=PORT_CFG.model, train=TrainConfig(lr_scheduler=scheduler, num_iters=3))
    jmodel, params, stats = _jax_init(seed=1)
    opt = jax_step.make_optimizer(jcfg)
    jstate = jax_state.TrainState(step=jnp.asarray(0, jnp.int32), params=params, batch_stats=stats,
                                  opt_state=opt.init(params), ema_params=jax_state.init_ema(params))
    jstep = jax.jit(jax_step.make_train_step(jmodel, jcfg, opt))
    model = _port_model(params, stats, cfg)
    state = TrainState(0, model, make_optimizer(model, cfg), init_ema(model))
    step = make_train_step(cfg)
    for i in range(3):
        x, emb = _batch(10 + i)
        jstate, jm = jstep(jstate, jnp.asarray(x), jnp.asarray(emb), jnp.asarray(1.0, jnp.float32))
        m = step(state, torch.from_numpy(x), torch.from_numpy(emb))
        assert float(m["g_loss"]) == pytest.approx(float(jm["g_loss"]), rel=1e-5), i
        assert float(m["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6), i
    assert state.step == int(jstate.step) == 3
    want = generator_state_from_jax({"params": jstate.params, "batch_stats": jstate.batch_stats})
    want_ema = generator_state_from_jax({"params": jstate.ema_params, "batch_stats": jstate.batch_stats})
    for name, p in model.named_parameters():
        apart = (p.detach() - want[name]).abs()
        assert float(apart.max()) <= 6e-4, name
        if not (name.endswith(".bias") and name.rsplit(".", 2)[-2].startswith("conv")):
            assert float((apart > 2e-6).float().mean()) <= 0.05, name
        torch.testing.assert_close(state.ema_params[name], want_ema[name], atol=1e-7, rtol=0, msg=name)
    for name, buf in model.named_buffers():
        torch.testing.assert_close(buf, want[name], atol=1e-4, rtol=0, msg=name)


# -------------------------------------------------------------- (vii) components


def test_ema_is_real_average():
    ema = {"w": torch.zeros(3)}
    out = ema_update(ema, {"w": torch.ones(3)}, 0.9)
    assert out is ema
    torch.testing.assert_close(ema["w"], torch.full((3,), 0.1), rtol=1e-6, atol=0)
    want = jax_state.ema_update({"w": jnp.zeros(3)}, {"w": jnp.ones(3)}, 0.9)
    np.testing.assert_allclose(ema["w"].numpy(), np.asarray(want["w"]), rtol=1e-6)


def test_cosine_schedules_match_jax():
    from autovc_tpu.train import schedule as jax_sched

    assert cosine_annealing(0, 10000) == pytest.approx(1.0)
    assert cosine_annealing(10000, 10000) == pytest.approx(0.0, abs=1e-6)
    assert cosine_annealing(5000, 10000) == pytest.approx(0.5, rel=1e-5)
    for step in (0, 1, 7, 50, 99, 100, 150):
        assert cosine_annealing(step, 100) == pytest.approx(float(jax_sched.cosine_annealing(step, 100)), abs=1e-6)
        assert cosine_decay(step, 100, 0.01) == pytest.approx(float(jax_sched.cosine_decay(step, 100, 0.01)),
                                                              abs=1e-6)


def test_plateau_reduces_after_patience():
    pl = ReduceLROnPlateau(factor=0.5, patience=2)
    pl.step(1.0)
    for _ in range(3):
        scale = pl.step(1.0)
    assert scale == pytest.approx(0.5)
    assert pl.step(float("nan")) == pytest.approx(0.5)


def _write_corpus(root, speakers=4, utts=3, seed=0, short=None):
    """A synthetic spmel/train.pkl directory; ``short`` frames for the first
    utterance of speaker 0 when given."""
    rng = np.random.RandomState(seed)
    mel_dir = os.path.join(root, "spmel")
    entries = []
    for s in range(speakers):
        os.makedirs(os.path.join(mel_dir, f"p{s}"), exist_ok=True)
        paths = []
        for u in range(utts):
            frames = short if (short and s == 0 and u == 0) else int(rng.randint(40, 120))
            np.save(os.path.join(mel_dir, f"p{s}", f"u{u}.npy"), rng.rand(frames, 80).astype(np.float32))
            paths.append(f"p{s}/u{u}.npy")
        entries.append(SpeakerEntry(f"p{s}", rng.randn(NARROW["dim_emb"]).astype(np.float32), paths))
    save_train_manifest(os.path.join(mel_dir, "train.pkl"), entries)
    return mel_dir


def test_batch_stream_matches_jax_iterator(tmp_path):
    """The same seed gives the JAX iterator's batches, each side reading a
    train.pkl the other's manifest functions understand."""
    from autovc_tpu.data import BatchIterator as JaxBatchIterator
    from autovc_tpu.data import UtteranceDataset as JaxUtteranceDataset
    from autovc_tpu.data.manifest import load_train_manifest as jax_load, save_train_manifest as jax_save

    mel_dir = _write_corpus(tmp_path)
    jax_entries = jax_load(os.path.join(mel_dir, "train.pkl"))
    jax_save(os.path.join(mel_dir, "train_jax.pkl"), jax_entries)
    with open(os.path.join(mel_dir, "train.pkl"), "rb") as a, open(os.path.join(mel_dir, "train_jax.pkl"), "rb") as b:
        assert pickle.load(a)[0][2:] == pickle.load(b)[0][2:]
    ours = BatchIterator(UtteranceDataset(mel_dir, "train_jax.pkl"), batch_size=3, len_crop=32, seed=7)
    theirs = JaxBatchIterator(JaxUtteranceDataset(mel_dir, use_native=False), batch_size=3, len_crop=32, seed=7)
    for _ in range(5):  # crosses an epoch boundary (4 speakers, batches of 3)
        (xa, ea), (xb, eb) = next(ours), next(theirs)
        np.testing.assert_array_equal(xa, xb)
        np.testing.assert_array_equal(ea, eb)


def test_short_utterances_are_zero_padded(tmp_path):
    mel_dir = _write_corpus(tmp_path, speakers=1, utts=1, short=20)
    ds = UtteranceDataset(mel_dir)
    crop = ds.sample(0, 64, np.random.default_rng(0))
    assert crop.shape == (64, 80)
    np.testing.assert_array_equal(crop[:20], ds.features[0][0])
    assert not crop[20:].any()
    with pytest.raises(ValueError, match="num_speakers"):
        BatchIterator(ds, batch_size=2, len_crop=64)


class _Flaky:
    """An iterator of numpy batches that fails at the given calls and ends
    after ``n`` batches."""

    def __init__(self, fail_at=(), n=None):
        self.i, self.fail_at, self.n, self.served = 0, set(fail_at), n, 0

    def __iter__(self):
        return self

    def __next__(self):
        self.i += 1
        if self.i in self.fail_at:
            raise OSError("transient read failure")
        if self.n is not None and self.served == self.n:
            raise StopIteration
        self.served += 1
        return np.full((2, 32, 80), self.served, np.float32), np.zeros((2, 16), np.float32)


def test_prefetcher_preserves_stream_and_forwards_errors():
    pf = DevicePrefetcher(_Flaky(fail_at=(2,)), "cpu", depth=1)
    got, errs = [], 0
    for _ in range(5):
        try:
            got.append(float(next(pf)[0][0, 0, 0]))
        except OSError:
            errs += 1
    pf.close()
    assert errs == 1 and got == [1.0, 2.0, 3.0, 4.0]
    assert not pf._thread.is_alive()


def test_prefetcher_signals_end_of_stream():
    pf = DevicePrefetcher(_Flaky(n=3), "cpu")
    out = list(pf)
    pf.close()
    assert len(out) == 3 and all(isinstance(x, torch.Tensor) for x, _ in out)


def _solver_cfg(root, **train):
    kw = dict(batch_size=2, len_crop=32, log_step=1, checkpoint_step=10_000, num_iters=4)
    kw.update(train)
    return Config(model=PORT_CFG.model, train=TrainConfig(**kw), main_dir=str(root), run_name="t")


def _solver(root, cfg, seed=0):
    mel_dir = os.path.join(str(root), "spmel")
    if not os.path.exists(mel_dir):
        _write_corpus(root)
    return Solver(cfg, BatchIterator(UtteranceDataset(mel_dir), 2, 32, seed=seed),
                  run_dir=os.path.join(str(root), "run"), device="cpu")


def test_nonfinite_loss_raises_and_saves_nothing(tmp_path):
    class NaNIter:
        def __iter__(self):
            return self

        def __next__(self):
            return np.full((2, 32, 80), np.nan, np.float32), np.zeros((2, 16), np.float32)

    solver = _solver(tmp_path, _solver_cfg(tmp_path, checkpoint_step=1))
    solver.data_iter = NaNIter()
    with pytest.raises(FloatingPointError):
        solver.train(num_iters=3, prefetch=0)
    assert solver.latest_step() is None


def test_transient_data_errors_are_retried(tmp_path):
    solver = _solver(tmp_path, _solver_cfg(tmp_path))
    good = solver.data_iter

    class Flaky:  # errors at calls 2 and 4, else real batches
        n = 0

        def __iter__(self):
            return self

        def __next__(self):
            Flaky.n += 1
            if Flaky.n in (2, 4):
                raise OSError("transient read failure")
            return next(good)

    solver.data_iter = Flaky()
    solver.train(num_iters=3, prefetch=0)
    assert solver.state.step == 3


# ------------------------------------------------------------- (viii) Solver, CLI


def test_solver_saves_resumes_and_keeps_three(tmp_path):
    """Checkpoints every 2 steps over 8 steps: the last three are kept; a
    new Solver resumes the latest with equal parameters, statistics, EMA and
    optimizer state, and its loss decreased from the start."""
    cfg = _solver_cfg(tmp_path, checkpoint_step=2, num_iters=8)
    s1 = _solver(tmp_path, cfg)
    s1.train()
    assert s1.checkpoint_steps() == [4, 6, 8]
    assert np.isfinite([h["g_loss"] for h in s1.history]).all() and len(s1.history) == 8
    s2 = _solver(tmp_path, cfg, seed=1)
    assert s2.state.step == 8
    for (k, a), b in zip(s1.state.model.state_dict().items(), s2.state.model.state_dict().values()):
        assert torch.equal(a, b), k
    assert all(torch.equal(v, s2.state.ema_params[k]) for k, v in s1.state.ema_params.items())
    sa, sb = s1.state.optimizer.state_dict()["state"], s2.state.optimizer.state_dict()["state"]
    assert all(torch.equal(sa[i]["exp_avg_sq"], sb[i]["exp_avg_sq"]) for i in sa)
    assert np.isfinite(s2.eval_loss(*next(s2.data_iter))["g_loss"])
    assert not [f for f in os.listdir(s1.ckpt_dir) if f.endswith(".tmp")]


def test_termination_signal_saves_and_stops(tmp_path):
    """SIGTERM during training (here its handler, called as the signal
    would call it) saves a checkpoint at the current step and stops; the
    caller's handler is back afterwards."""
    import signal

    solver = _solver(tmp_path, _solver_cfg(tmp_path, num_iters=10))
    before = signal.getsignal(signal.SIGTERM)
    good = solver.data_iter

    class Terminating:
        n = 0

        def __iter__(self):
            return self

        def __next__(self):
            Terminating.n += 1
            if Terminating.n == 3:
                signal.getsignal(signal.SIGTERM)(signal.SIGTERM, None)
            return next(good)

    solver.data_iter = Terminating()
    solver.train(prefetch=0)
    assert solver.state.step == 3 and solver.checkpoint_steps() == [3]
    assert signal.getsignal(signal.SIGTERM) is before


def test_periodic_saves_skip_while_previous_in_flight(tmp_path):
    """A periodic save that finds the previous one still writing is skipped;
    a final save (wait=True) blocks until the slot frees; a failed
    background save surfaces at the next save."""
    solver = _solver(tmp_path, _solver_cfg(tmp_path))
    calls, gate = [], threading.Event()

    def slow_write(step, snap):
        calls.append(step)
        gate.wait(10.0)

    solver._write = slow_write
    solver.save(1)
    t0 = time.time()
    solver.save(2)
    assert time.time() - t0 < 1.0 and solver._saves_skipped == 1
    gate.set()
    solver.save(3, wait=True)
    solver._save_thread.join()
    assert calls == [1, 3] and solver._saves_skipped == 0

    def bad_write(step, snap):
        raise RuntimeError("disk full")

    solver._write = bad_write
    solver.save(4)
    solver._save_thread.join()
    with pytest.raises(RuntimeError, match="disk full"):
        solver.save(5)


def test_solver_refuses_what_is_not_ported(tmp_path):
    with pytest.raises(NotImplementedError, match="Queue 1 #8"):
        _solver(tmp_path, _solver_cfg(tmp_path, data_parallel=2))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Solver(_solver_cfg(tmp_path), iter(()), run_dir=str(tmp_path / "r"))


def test_trained_generator_exports_for_jax_and_the_port(tmp_path):
    """What the Solver trained, written by ``io.save_generator_artifact``
    (the CLI's ``--export``): it loads into the JAX ``Generator.apply``
    (through ``autovc_tpu.cli.export_ckpt.load_artifact``) and into the
    port's ``build_generator(artifact=...)``; both give the trained model's
    eval-mode output within 1e-4."""
    from autovc_tpu.cli.export_ckpt import load_artifact as jax_load_artifact

    solver = _solver(tmp_path, _solver_cfg(tmp_path, num_iters=3))
    solver.train()
    out = str(tmp_path / "gen.npz")
    save_generator_artifact(solver.state.model.state_dict(), solver.state.step, out)
    variables, step = jax_load_artifact(out)
    assert step == 3
    port = build_generator(PORT_CFG.model, artifact=out, device="cpu")
    assert load_artifact(out)[1] == 3
    x, emb = (torch.from_numpy(a) for a in _batch(30))
    trained = solver.state.model.eval()
    with torch.no_grad():
        want = trained(x, emb, emb)
        got = port(x, emb, emb)
    jgot = NarrowGenerator(**NARROW).apply(variables, jnp.asarray(x.numpy()), jnp.asarray(emb.numpy()),
                                           jnp.asarray(emb.numpy()), train=False)
    for w, g, j in zip(want, got, jgot):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-4, rtol=0)
        np.testing.assert_allclose(np.asarray(j), w.numpy(), atol=1e-4, rtol=0)


def test_cli_trains_published_widths_and_exports(tmp_path, monkeypatch):
    """``python -m autovc_tpu_torch.cli.train``'s argument handling: the
    generator at the published widths, the training flags into
    ``TrainConfig``, ``--device`` into the Solver, ``--export`` writing the
    trained state with its step. The Solver is replaced by one holding a
    narrow model, so that no full-width model is trained on the CPU."""
    import autovc_tpu_torch.train as train_pkg
    from autovc_tpu_torch.cli.train import main

    seen = {}

    class NarrowSolver:
        def __init__(self, cfg, data_iter, device):
            seen.update(cfg=cfg, device=device, batch=next(iter(data_iter)))
            model = build_generator(PORT_CFG.model, device="cpu", seed=1)
            self.state = TrainState(0, model, None, None)

        def train(self):
            self.state.step = seen["cfg"].train.num_iters

    monkeypatch.setattr(train_pkg, "Solver", NarrowSolver)
    _write_corpus(tmp_path)
    out = str(tmp_path / "gen.npz")
    main(["--main_dir", str(tmp_path), "--run_name", "c", "--device", "cpu", "--num_iters", "3",
          "--batch_size", "2", "--len_crop", "32", "--lr", "3e-4", "--lambda_cd", "2", "--lr_scheduler",
          "CosineDecay", "--ema", "0.99", "--log_step", "1", "--checkpoint_step", "3", "--seed", "5",
          "--export", out])
    cfg = seen["cfg"]
    assert cfg.model == ModelConfig() and (cfg.model.enc_channels, cfg.model.dec_lstm_dim) == (512, 1024)
    assert (cfg.train.num_iters, cfg.train.batch_size, cfg.train.len_crop, cfg.train.lr, cfg.train.lambda_cd,
            cfg.train.lr_scheduler, cfg.train.ema_decay, cfg.train.checkpoint_step, cfg.train.seed) == (
        3, 2, 32, 3e-4, 2.0, "CosineDecay", 0.99, 3, 5)
    assert seen["device"] == "cpu" and seen["batch"][0].shape == (2, 32, 80)
    assert cfg.run_name.startswith("c_") and cfg.main_dir == str(tmp_path)
    tree, step = load_artifact(out)
    assert step == 3
    got = flatten_params(tree)
    want = flatten_params(generator_state_to_jax(build_generator(PORT_CFG.model, device="cpu", seed=1).state_dict()))
    assert got.keys() == want.keys() and all(np.array_equal(got[k], v) for k, v in want.items())


@pytest.mark.parametrize("flag, item", [(["--multihost"], "Queue 1 #8"),
                                        (["--lambda_spk", "0.5"], "requires --spk_ckpt"),
                                        (["--model_type", "stft", "--lambda_spk", "0.5", "--spk_ckpt", "ge2e.npz"],
                                         "mel-domain"), ([], "train.pkl")])
def test_cli_refuses_what_is_not_ported(tmp_path, flag, item):
    from autovc_tpu_torch.cli.train import main

    with pytest.raises(SystemExit, match=item):
        main(["--main_dir", str(tmp_path), "--run_name", "x", "--device", "cpu", *flag])


def test_watch_histograms_are_logged(tmp_path):
    """watch_step writes param/ and grad/ histograms per top-level module
    into the JSONL stream."""
    import json

    solver = _solver(tmp_path, _solver_cfg(tmp_path, watch_step=2, num_iters=2))
    solver.train()
    recs = [json.loads(line) for line in open(solver.metrics.path)]
    hists = [r["histograms"] for r in recs if "histograms" in r]
    assert len(hists) == 1
    assert set(hists[0]) == {f"{k}/{m}" for k in ("param", "grad") for m in ("encoder", "decoder", "postnet")}
    one = hists[0]["grad/decoder"]
    assert sum(one["counts"]) == sum(p.numel() for p in solver.state.model.decoder.parameters())
    assert np.isfinite(one["rms"]) and one["lo"] <= one["hi"]


def test_step_timer_and_trace(tmp_path):
    from autovc_tpu_torch.train.profiler import StepTimer, trace

    st = StepTimer(skip_first=1)
    for _ in range(5):
        st.tick()
        time.sleep(0.01)
    s = st.summary()
    assert s["steps_per_sec"] > 0 and s["step_ms_p50"] >= 5
    with trace(str(tmp_path / "trace")):
        torch.ones(8) @ torch.ones(8)
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0


def test_exact_f32_does_nothing_off_the_card():
    flags = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    with exact_f32("cpu"):
        assert (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32) == flags
    assert (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32) == flags


# ----------------------------------------------------------- (ix) kernel wrappers


@pytest.mark.parametrize(
    "change, error",
    [
        (dict(dy=torch.float64), TypeError),  # the kernels are float32 only
        (dict(h0=(8, 16)), ValueError),  # h0 is not (B, H)
        (dict(c_seq=(8, 12, 16)), ValueError),  # c_seq is not (B, T, H)
        (dict(w_hh=(24, 96)), ValueError),  # w_hh is not (H, 4H)
        (dict(gates=(8, 12, 32)), ValueError),  # the gate activations are not (B, T, 4H)
        ({}, ValueError),  # CPU tensors: the kernels take CUDA tensors only
    ],
)
def test_backward_wrapper_rejects_before_building(change, error, monkeypatch):
    """lstm_backward_cuda and lstm_weight_grad_cuda validate dtype, shapes
    and device before they build or launch."""
    monkeypatch.setattr(lstm_ops, "_library", lambda name: pytest.fail("built before validating"))
    shapes = dict(xproj=(8, 12, 128), w_hh=(32, 128), h0=(8, 32), c0=(8, 32), h_seq=(8, 12, 32),
                  c_seq=(8, 12, 32), dy=(8, 12, 32), dhn=(8, 32), dcn=(8, 32), gates=(8, 12, 128))
    args = {k: torch.zeros(v) for k, v in shapes.items()}
    for k, v in change.items():
        args[k] = torch.zeros(shapes[k], dtype=v) if isinstance(v, torch.dtype) else torch.zeros(v)
    with pytest.raises(error):
        lstm_ops.lstm_backward_cuda(**args)
    with pytest.raises(ValueError):  # a wrong h0, or CPU tensors
        lstm_ops.lstm_weight_grad_cuda(args["h_seq"], args["h0"], torch.zeros(8, 12, 128))
