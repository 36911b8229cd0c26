"""The port's bfloat16 training path against the JAX package's ``--bf16
--pallas`` path, on the CPU: the LSTM training forward and backward in
bfloat16 (the Pallas kernels in interpret mode), the autograd Function
against ``jax.grad`` of ``_lstm_sequence``, BatchNorm's bfloat16 training
form, a bfloat16 BLSTM layer forward and backward, the whole loss and its
gradients on a narrow generator, three Solver steps against the JAX train
step, and ``cli.train --bf16``.

Where both sides round the same float32 value at the same point they agree
bit for bit; where they sum in another order a value a hair from a rounding
boundary lands on the neighbouring bfloat16 value. So the LSTM and the
layers are held to one bfloat16 ulp and a share of bit-equal elements. A
whole network is not: one such flip moves a BatchNorm's batch statistics and
so every element of its channel, and the backward sums bfloat16 cotangents
in another order than XLA (which, on the CPU, also sums the cotangent of a
bfloat16 broadcast, a bias's, in bfloat16), so two bfloat16 engines that round
at the same points op by op still land a few bfloat16 ulps of a leaf apart,
nearly as far as bfloat16 lands from float32. The whole loss is held to
tolerances that are asserted to be tighter than JAX's own bfloat16 distance
from JAX's float32 on the same batch.
"""

import dataclasses
import functools
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from autovc_tpu.config import ModelConfig as JaxModelConfig
from autovc_tpu.models import layers as jax_layers
from autovc_tpu.models.autovc import Decoder, Encoder, Generator as JaxGenerator, Postnet
from autovc_tpu.ops import pallas_lstm as pk
from autovc_tpu.train import state as jax_state
from autovc_tpu.train import step as jax_step
from autovc_tpu_torch.config import Config, ModelConfig, TrainConfig
from autovc_tpu_torch.io import generator_state_from_jax, load_artifact
from autovc_tpu_torch.models import LSTM, BatchNorm, build_generator
from autovc_tpu_torch.ops import lstm as lstm_ops
from autovc_tpu_torch.train import Solver, loss_fn
from autovc_tpu_torch.train.compare import grad_scale

from test_torch_train import NARROW, _batch, _jax_cfg, _port_model, _time_major, _write_corpus

torch.set_num_threads(1)

BF = torch.bfloat16
B, T, H = 8, 24, 32
# The backward's float32 sums (dh's carry over 4H terms a step, dW over K =
# B*T rows) in another order differ by about sqrt(K) * 2^-24 of the peak,
# more than the bfloat16 ulp of an element near zero (2 ulps of 2^-12 of the
# peak at K = 1280 on the CPU; 12 of 2^-16 and 2 of 2^-10 at K = 8192 on an
# H100): the ulp of an element below 2^-8 of the output's peak is that of
# 2^-8 of the peak (the forward's h_seq: 2^-16).
BWD_FLOOR = 2.0 ** -8


def _ulps(got: np.ndarray, want: np.ndarray, floor: float = 2.0 ** -16) -> np.ndarray:
    """|got - want| in bfloat16 ulps of want, or of ``floor`` times want's
    largest magnitude where want is smaller; an all-zero want must be met
    exactly."""
    want = want.astype(np.float64)
    peak = np.abs(want).max()
    if peak == 0:
        return np.where(got == want, 0.0, np.inf)
    scale = np.maximum(np.abs(want), floor * peak)
    return np.abs(got.astype(np.float64) - want) / np.ldexp(1.0, np.frexp(scale)[1] - 8)


def _np(a) -> np.ndarray:
    """A torch tensor or a JAX array (bfloat16 or float32) as float32 NumPy."""
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _hold_bf16(got, want, floor: float = 2.0 ** -16) -> None:
    """Both bfloat16; every element within 1 ulp, at least 99% bit-equal."""
    assert got.dtype == BF and jnp.asarray(want).dtype == jnp.bfloat16
    g, w = _np(got), _np(want)
    assert g.shape == w.shape
    assert _ulps(g, w, floor).max() <= 1.0, _ulps(g, w, floor).max()
    assert (g == w).mean() >= 0.99, (g == w).mean()


def _hold_f32(got, want, atol: float) -> None:
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), _np(want), atol=atol, rtol=0)


def _inputs(seed, b=B, t=T, hidden=H):
    """bfloat16 xproj, w_hh and dy (as JAX rounds them), a float32 state and
    float32 cotangents of hN and cN, from a numpy seed."""
    rng = np.random.RandomState(seed)
    xproj = (rng.randn(b, t, 4 * hidden) * 0.5).astype(np.float32)
    bound = 1.0 / np.sqrt(hidden)
    w_hh = rng.uniform(-bound, bound, (hidden, 4 * hidden)).astype(np.float32)
    h0, c0 = (rng.randn(b, hidden).astype(np.float32) * 0.5 for _ in range(2))
    dy = rng.randn(b, t, hidden).astype(np.float32)
    dhn, dcn = (rng.randn(b, hidden).astype(np.float32) for _ in range(2))
    to_bf = lambda a: np.array(_np(jnp.asarray(a).astype(jnp.bfloat16)))  # noqa: E731
    return to_bf(xproj), to_bf(w_hh), h0, c0, to_bf(dy), dhn, dcn


def _torch(xproj, w_hh, h0, c0, dy, dhn, dcn):
    bf = [torch.from_numpy(a).to(BF) for a in (xproj, w_hh, dy)]
    return bf[0], bf[1], torch.from_numpy(h0), torch.from_numpy(c0), bf[2], torch.from_numpy(dhn), \
        torch.from_numpy(dcn)


def _jax_bf16(a, reverse=False, time_major=True):
    a = _time_major(a, reverse).copy() if time_major else a
    return jnp.asarray(a).astype(jnp.bfloat16)


# ---------------------------------------------------------- (a) LSTM forward


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("kernel", ["chunk", "split"])
def test_bf16_train_forward_matches_pallas_interpret(kernel, reverse):
    """The plain forward's bfloat16 training form (a float32 h0 and c0; h_seq
    rounded, c_seq, hN and cN float32) against ``_lstm_kernel_train`` via
    ``_chunk_fwd(..., with_residual=True)`` and ``_lstm_kernel_split_train``
    via ``_lstm_chunk_split_impl``: h_seq within 1 bfloat16 ulp and 99%
    bit-equal; the float32 state within 1e-5 (test_torch_train.py's)."""
    xproj, w_hh, h0, c0 = _inputs(0)[:4]
    args = (_jax_bf16(xproj, reverse), _jax_bf16(w_hh, time_major=False), jnp.asarray(h0), jnp.asarray(c0))
    if kernel == "chunk":
        want = pk._chunk_fwd(*args, interpret=True, with_residual=True)
    else:
        want = pk._lstm_chunk_split_impl(*args, True, with_residual=True)
    x, w, th0, tc0 = _torch(*_inputs(0))[:4]
    got = lstm_ops.lstm_sequence_train_ref(x, w, th0, tc0, reverse=reverse)
    _hold_bf16(torch.from_numpy(_time_major(_np(got[0]), reverse).copy()).to(BF), want[0])
    _hold_f32(torch.from_numpy(_time_major(got[1].numpy(), reverse).copy()), want[1], 1e-5)
    _hold_f32(got[2], want[2], 1e-5)
    _hold_f32(got[3], want[3], 1e-5)


# --------------------------------------------------------- (b) LSTM backward


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("kernel", ["chunk", "split"])
def test_bf16_backward_matches_pallas_interpret(kernel, reverse):
    """The plain backward in bfloat16 against ``_chunk_bwd_call``
    (``_lstm_bwd_kernel``: gates recomputed from the rounded h_seq, dx
    rounded from the float32 gate gradients, dW accumulated in float32 and
    rounded by ``_lstm_chunk_bwd_rule``) and against ``_split_fwd_rule`` and
    ``_split_bwd_rule`` (``_lstm_bwd_kernel_split``, dW as one product
    outside), called directly at H=32 on bfloat16 inputs: dxproj and dW
    within 1 bfloat16 ulp (the floor BWD_FLOOR) and 99% bit-equal, dh0 and
    dc0 within 2e-5 (tests/test_ops.py's)."""
    xproj, w_hh, h0, c0, dy, dhn, dcn = _inputs(1)
    tx, tw, th0, tc0, tdy, tdhn, tdcn = _torch(xproj, w_hh, h0, c0, dy, dhn, dcn)
    h_seq, c_seq, _, _ = lstm_ops.lstm_sequence_train_ref(tx, tw, th0, tc0, reverse)
    got = lstm_ops.lstm_backward_ref(tx, tw, th0, tc0, h_seq, c_seq, tdy, tdhn, tdcn, reverse)
    assert [g.dtype for g in got] == [BF, BF, torch.float32, torch.float32]
    xt, jw, jh0, jc0 = _jax_bf16(xproj, reverse), _jax_bf16(w_hh, time_major=False), jnp.asarray(h0), \
        jnp.asarray(c0)
    jdy, jdhn, jdcn = _jax_bf16(dy, reverse), jnp.asarray(dhn), jnp.asarray(dcn)
    if kernel == "chunk":
        jh = _jax_bf16(_np(h_seq), reverse)
        jc = jnp.asarray(_time_major(c_seq.numpy(), reverse).copy())
        dx, dw, dh0, dc0 = pk._chunk_bwd_call(xt, jw, jh0, jc0, jh, jc, jdy, jdhn, jdcn, interpret=True)
        dw = dw.astype(jnp.bfloat16)  # _lstm_chunk_bwd_rule's rounding
    else:
        _, residuals = pk._split_fwd_rule(xt, jw, jh0, jc0, True)
        dx, dw, dh0, dc0 = pk._split_bwd_rule(True, residuals, (jdy, jdhn, jdcn))
    _hold_bf16(torch.from_numpy(_time_major(_np(got[0]), reverse).copy()).to(BF), dx, BWD_FLOOR)
    _hold_bf16(got[1], dw, BWD_FLOOR)
    _hold_f32(got[2], dh0, 2e-5)
    _hold_f32(got[3], dc0, 2e-5)


def test_bf16_gates_from_the_rounded_sequence():
    """``lstm_gates_ref`` on a bfloat16 sequence is the Pallas backward's
    recompute (``xproj + hprev @ w_hh`` on the rounded h, the float32 h0 at
    the start), not the forward's activations on its float32 carry: the two
    differ, and the recompute is what the backward reads."""
    x, w, h0, c0 = _torch(*_inputs(2))[:4]
    h_seq, _, _, _ = lstm_ops.lstm_sequence_train_ref(x, w, h0, c0)
    gates = lstm_ops.lstm_gates_ref(x, w, h0, h_seq)
    hprev = torch.cat([h0[:, None], h_seq[:, :-1].float()], dim=1)
    pre = x.float() + hprev @ w.float()
    i, f, g, o = pre.split(H, dim=-1)
    torch.testing.assert_close(gates, torch.cat([i.sigmoid(), f.sigmoid(), g.tanh(), o.sigmoid()], -1),
                               atol=1e-6, rtol=0)
    carry = lstm_ops.lstm_sequence_train_ref(x.float(), w.float(), h0, c0)[0]
    assert not torch.allclose(lstm_ops.lstm_gates_ref(x.float(), w.float(), h0, carry), gates, atol=1e-6, rtol=0)


# ------------------------------------------------------ (c) Function gradients


# T > chunk: JAX hands each chunk the float32 carry as its h0, so the first
# step of every later chunk recomputes its gates from the float32 h where the
# port (one launch a sequence) uses the rounded h_seq, and JAX rounds each
# chunk's dW to bfloat16 and sums them in bfloat16. The largest difference
# over the peak, printed by the test (-s), at B=8, H=32 on the CPU: T=32
# against chunk=16 dxproj 1.1e-3 and 1.4e-3 (forward, reverse), dW 3.3e-3
# and 7.0e-3, 62% of dW bit-equal; T=160 against chunk=128 dxproj 9.0e-4
# and 1.1e-3, dW 3.1e-3 and 3.5e-3, 64% (ROADMAP Queue 3). The training
# crop, 128, is one chunk.
CHUNK_DX, CHUNK_DW = 2.0 ** -8, 2.0 ** -6


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("t, chunk", [(32, 32), (32, 16), (160, 128)])
def test_bf16_function_gradients_match_jax_grad(t, chunk, reverse):
    """torch autograd through ``LSTMSequenceFn`` in bfloat16 (the plain
    versions on the CPU) against ``jax.grad`` of the Pallas
    ``_lstm_sequence`` in interpret mode on the same bfloat16 xproj and w_hh:
    with one chunk (T=32, as the training crop of 128 runs) dxproj and dW_hh
    within 1 bfloat16 ulp and 99% bit-equal; with T > chunk (32 against 16,
    and the Pallas default 128 at T=160) the divergence at the seams, within
    CHUNK_DX and CHUNK_DW of the peak."""
    xproj, w_hh, _, _, dy = _inputs(3, t=t)[:5]

    def jax_loss(xp, w):
        out = pk._lstm_sequence(xp, w, reverse=reverse, interpret=True, chunk=chunk)
        return jnp.sum(out.astype(jnp.float32) * dy)

    want_dx, want_dw = jax.grad(jax_loss, argnums=(0, 1))(_jax_bf16(xproj, time_major=False),
                                                          _jax_bf16(w_hh, time_major=False))
    x = torch.from_numpy(xproj).to(BF).requires_grad_()
    w = torch.from_numpy(w_hh).to(BF).requires_grad_()
    out = lstm_ops.lstm_sequence(x, w, reverse)
    assert out.dtype == BF
    (out.float() * torch.from_numpy(dy)).sum().backward()
    if chunk >= t:
        _hold_bf16(x.grad, want_dx, BWD_FLOOR)
        _hold_bf16(w.grad, want_dw, BWD_FLOOR)
    else:
        for name, g, want, bound in (("dxproj", x.grad, want_dx, CHUNK_DX), ("dW", w.grad, want_dw, CHUNK_DW)):
            apart, peak = np.abs(_np(g) - _np(want)).max(), np.abs(_np(want)).max()
            print(f"T={t} chunk={chunk} reverse={reverse} {name}: {apart / peak:.2e} of the peak apart, "
                  f"{(_np(g) == _np(want)).mean():.4f} bit-equal")
            assert apart <= bound * peak, (apart / peak, bound)


# ------------------------------------------------------------ (d) BatchNorm


def test_bf16_batchnorm_training_form_matches_flax():
    """BatchNorm in bfloat16, two training calls then an eval call, against
    flax ``BatchNorm(dtype=bfloat16)``: statistics from the input widened to
    float32 (two-pass variance), normalised in float32, the output rounded:
    within 1 bfloat16 ulp and 99% bit-equal; the float32 running statistics
    within 1e-6."""
    rng = np.random.RandomState(5)
    xs = [jnp.asarray((rng.randn(2, 32, 16) * 2.0 + 3.0).astype(np.float32)).astype(jnp.bfloat16) for _ in range(3)]
    flax_bn = jax_layers.BatchNorm(dtype=jnp.bfloat16)
    variables = flax_bn.init(jax.random.PRNGKey(0), xs[0], use_running_average=False)
    scale = rng.rand(16).astype(np.float32) + 0.5
    bias = rng.randn(16).astype(np.float32)
    params = {"BatchNorm_0": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}}
    bn = BatchNorm(16, dtype=BF)
    bn.reset_parameters(torch.Generator())
    bn.weight.data, bn.bias.data = torch.from_numpy(scale), torch.from_numpy(bias)
    stats = variables["batch_stats"]
    bn.train()
    for x in xs[:2]:
        want, upd = flax_bn.apply({"params": params, "batch_stats": stats}, x, use_running_average=False,
                                  mutable=["batch_stats"])
        stats = upd["batch_stats"]
        _hold_bf16(bn(torch.from_numpy(_np(x)).to(BF)), want)
        _hold_f32(bn.running_mean, stats["BatchNorm_0"]["mean"], 1e-6)
        _hold_f32(bn.running_var, stats["BatchNorm_0"]["var"], 1e-6)
    bn.eval()
    want = flax_bn.apply({"params": params, "batch_stats": stats}, xs[2], use_running_average=True)
    _hold_bf16(bn(torch.from_numpy(_np(xs[2])).to(BF)), want)


# ------------------------------------------------------------ (e) BLSTM layer


def test_bf16_blstm_layer_forward_and_backward_match_jax(monkeypatch):
    """The encoder's 2-layer BLSTM (H=32) in bfloat16 on the LSTM kernels'
    plain versions against ``layers.LSTM(use_pallas=True,
    dtype=bfloat16)`` op by op (``jax.disable_jit``: every op rounds where
    flax says): the output and the input's gradient within 1 bfloat16 ulp
    and 99% bit-equal; every w_ih and w_hh gradient 99% bit-equal and within
    8 ulps (floor BWD_FLOOR): two layers of bfloat16 products and gate
    recomputes summed in another order leave a few elements of a
    near-cancelling sum apart (measured: 99.37% bit-equal, 4.5 ulps of
    2^-10 of the peak, in the top layer's backward direction). A bias's
    gradient is the cotangent of a
    bfloat16 broadcast, which XLA:CPU sums in bfloat16 and torch in float32:
    it is held to the float64 sum of its sequence's xproj cotangent instead,
    within 1 bfloat16 ulp."""
    rng = np.random.RandomState(6)
    x = rng.randn(4, 32, 48).astype(np.float32)
    ct = rng.randn(4, 32, 2 * H).astype(np.float32)
    jm = jax_layers.LSTM(H, num_layers=2, bidirectional=True, dtype=jnp.bfloat16, use_pallas=True)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]

    def jax_loss(p, xx):
        return jnp.sum(jm.apply({"params": p}, xx).astype(jnp.float32) * ct)

    with jax.disable_jit():
        out = jm.apply({"params": params}, jnp.asarray(x))
        gp, gx = jax.grad(jax_loss, argnums=(0, 1))(params, jnp.asarray(x))
    layer = LSTM(48, H, num_layers=2, bidirectional=True, dtype=BF)
    for name, p in layer.named_parameters():
        p.data = torch.from_numpy(np.asarray(params[name]))
    # the xproj cotangent of each sequence, in call order: l0 fwd, l0 bwd, l1 fwd, l1 bwd
    cotangents: list[list] = []
    real = lstm_ops.lstm_sequence

    def recording(xproj, w_hh, reverse=False):
        slot: list = []
        cotangents.append(slot)
        xproj.register_hook(slot.append)
        return real(xproj, w_hh, reverse)

    monkeypatch.setattr(lstm_ops, "lstm_sequence", recording)
    xt = torch.from_numpy(x).requires_grad_()
    got = layer(xt)
    _hold_bf16(got, out)
    (got.float() * torch.from_numpy(ct)).sum().backward()
    assert _ulps(xt.grad.numpy(), np.asarray(gx), BWD_FLOOR).max() <= 1.0
    biases = [f"b_l{i}_{d}" for i in range(2) for d in ("fwd", "bwd")]
    for name, p in layer.named_parameters():
        g = p.grad.numpy()
        if name in biases:
            exact = cotangents[biases.index(name)][0].double().sum(dim=(0, 1)).to(BF).float().numpy()
            assert _ulps(g, exact, BWD_FLOOR).max() <= 1.0, name
        else:
            want = np.asarray(gp[name])
            assert _ulps(g, want, BWD_FLOOR).max() <= 8.0 and (g == want).mean() >= 0.99, name


# ------------------------------------------------- (f) the loss and gradients


class NarrowGenerator(JaxGenerator):
    """The JAX generator at narrow widths (encoder channels 32, decoder
    lstm_dim 64, postnet channels 32), passing its dtype and use_pallas on
    as ``Generator.setup`` does."""

    def setup(self):
        self.encoder = Encoder(self.dim_neck, self.freq, channels=32, dtype=self.dtype, use_pallas=self.use_pallas)
        self.decoder = Decoder(self.n_bins, self.dim_pre, lstm_dim=64, dtype=self.dtype, use_pallas=self.use_pallas)
        self.postnet = Postnet(self.n_bins, channels=32, dtype=self.dtype)


PORT_MODEL = ModelConfig(**NARROW, enc_channels=32, dec_lstm_dim=64, postnet_channels=32, compute_dtype="bfloat16",
                         use_pallas_lstm=True)
PORT_CFG = Config(model=PORT_MODEL)
JAX_BF16 = NarrowGenerator(**NARROW, dtype=jnp.bfloat16, use_pallas=True)
JAX_F32 = NarrowGenerator(**NARROW)
# Tolerances of (f). A gradient leaf's distance is its largest difference
# over its grad_scale; "worst" is the largest over the parameters' leaves,
# "mean" their mean. JAX's own is JAX float32's distance from JAX bfloat16
# over the same leaves. Measured on the CPU (B=4, T=32; init seed, batch
# seed), the port from JAX bfloat16 and, in brackets, JAX's own:
#   (0, 1) training: loss 3.7e-5 (5.0e-6), worst 0.235 (0.348), mean 0.084 (0.154)
#          eval:     loss 2.0e-5 (2.2e-4), worst 0.103 (0.184), mean 0.026 (0.030)
#   (0, 2) training: loss 5.5e-5 (9.8e-5), worst 0.156 (0.589), mean 0.059 (0.230)
#          eval:     loss 6.9e-6 (7.7e-5), worst 0.367 (0.392), mean 0.045 (0.061)
#   (1, 1) training: loss 1.8e-5 (2.4e-4), worst 0.259 (1.327), mean 0.081 (0.289)
#          eval:     loss 2.6e-5 (4.2e-4), worst 0.110 (0.124), mean 0.023 (0.038)
#   (1, 2) training: loss 1.9e-4 (1.9e-4), worst 1.203 (0.699), mean 0.271 (0.341)
#          eval:     loss 7.1e-6 (2.4e-4), worst 0.150 (0.222), mean 0.024 (0.040)
# Two gates part bfloat16 from float32 on every batch measured: in training
# form the mean gradient distance (at most MEAN_SHARE of JAX's own: 0.26 to
# 0.79 of it), in eval form the loss (at most LOSS_SHARE of JAX's own: 0.03
# to 0.09 of it). A float32 port lands at JAX's own distance and fails them
# (test_whole_loss_gates_refuse_a_float32_port). The rest are not tighter
# than JAX's own on every batch: the training loss (JAX bfloat16 lands
# nearer float32 by cancellation on (0, 1)), the worst leaf in training form
# (on (1, 2) the decoder's first LSTM lies 1.2 of its scale from JAX's, 0.7
# for float32: ROADMAP Queue 3), and in eval form the worst leaf and the
# mean (0.94 and 0.87 of JAX's own at most). So (0, 1) keeps its fixed
# tolerances beside the shares, and the other batches are held to the
# shares and, in eval form, to JAX's own worst and mean.
LOSS_RTOL = 1e-4
GRAD_TOL = {True: (0.3, 0.1), False: (0.15, 0.04)}  # (worst, mean) in training and in eval form
MEAN_SHARE = 0.85
LOSS_SHARE = 0.25
MORE_BATCHES = [(0, 2), (1, 1), (1, 2)]
STEP_LOSS_RTOL = 3e-4  # (g): bfloat16 trajectories part further with each Adam step


def _jax_init(seed=0):
    x, emb = _batch(100)
    variables = JAX_F32.init(jax.random.PRNGKey(seed), jnp.asarray(x), jnp.asarray(emb), jnp.asarray(emb))
    return variables["params"], variables["batch_stats"]


def _jax_loss_and_grads(model, params, stats, x, emb, train):
    fn = jax.jit(jax.value_and_grad(
        lambda p: jax_step.loss_fn(model, _jax_cfg(), p, stats, jnp.asarray(x), jnp.asarray(emb), train=train),
        has_aux=True))
    (total, (_, new_stats)), grads = fn(params)
    return float(total), generator_state_from_jax({"params": grads, "batch_stats": new_stats})


@functools.lru_cache(maxsize=None)
def _jax_reference(init, batch, train):
    """JAX's loss and gradients in float32 and in bfloat16 (Pallas, interpret
    mode) from init seed ``init`` on batch seed ``batch``; shared by the
    tests of (f), which read and never change them."""
    params, stats = _jax_init(init)
    x, emb = _batch(batch)
    return (params, stats, x, emb, _jax_loss_and_grads(JAX_F32, params, stats, x, emb, train),
            _jax_loss_and_grads(JAX_BF16, params, stats, x, emb, train))


def _leaf_distances(got: dict, want: dict, names) -> np.ndarray:
    return np.array([float((got[n] - want[n]).abs().max()) / grad_scale(n, want) for n in names])


def _port_against_jax(compute_dtype, init, batch, train):
    """The port's ``loss_fn`` in ``compute_dtype`` and its gradients against
    JAX bfloat16's, and JAX float32's against JAX bfloat16's: (model, loss
    apart, JAX's own loss apart, leaf distances, JAX's own, JAX bfloat16's
    gradients and statistics)."""
    params, stats, x, emb, (loss32, g32), (loss_bf, g_bf) = _jax_reference(init, batch, train)
    cfg = Config(model=dataclasses.replace(PORT_MODEL, compute_dtype=compute_dtype))
    model = _port_model(params, stats, cfg)
    total, _ = loss_fn(model, cfg, torch.from_numpy(x), torch.from_numpy(emb), train=train)
    total.backward()
    got = {n: p.grad for n, p in model.named_parameters()}
    assert {g.dtype for g in got.values()} == {p.dtype for p in model.parameters()} == {torch.float32}
    loss_apart = abs(float(total.detach()) - loss_bf) / abs(loss_bf)
    jax_loss_apart = abs(loss_bf - loss32) / abs(loss32)
    port, jax_own = _leaf_distances(got, g_bf, got), _leaf_distances(g32, g_bf, got)
    print(f"({init}, {batch}) {'training' if train else 'eval'} form, port in {compute_dtype}: loss {loss_apart:.2e} "
          f"from JAX bf16 ({jax_loss_apart:.2e} JAX bf16 from f32); gradients worst {port.max():.3f}, mean "
          f"{port.mean():.3f} ({jax_own.max():.3f}, {jax_own.mean():.3f})")
    return model, loss_apart, jax_loss_apart, port, jax_own, g_bf


def _share_gates(train, loss_apart, jax_loss_apart, port, jax_own) -> dict:
    """The gates that part bfloat16 from float32 on every batch measured,
    and in eval form JAX's own worst and mean."""
    if train:
        return {"mean share": port.mean() <= MEAN_SHARE * jax_own.mean()}
    return {"loss share": loss_apart <= LOSS_SHARE * jax_loss_apart,
            "worst": port.max() <= jax_own.max(), "mean": port.mean() <= jax_own.mean()}


def _fixed_gates(train, loss_apart, jax_loss_apart, port, jax_own) -> dict:
    """(0, 1)'s fixed tolerances, each asserted tighter than JAX's own where
    the table above says so."""
    worst, mean = GRAD_TOL[train]
    return {"loss": loss_apart <= LOSS_RTOL and (train or LOSS_RTOL < jax_loss_apart),
            "worst": port.max() <= worst < jax_own.max(),
            "mean": port.mean() <= mean and (not train or mean < jax_own.mean())}


@pytest.mark.parametrize("train", [True, False])
def test_bf16_loss_and_gradients_match_jax(train):
    """``loss_fn`` of a bfloat16 narrow generator (trainable: f32 weights,
    their gradients f32) and every gradient leaf against ``jax.value_and_grad``
    of the JAX ``loss_fn`` with ``dtype=bfloat16, use_pallas=True`` on the
    same weights and batch, in training form (batch statistics, their update,
    the second encode) and in eval form: the loss within LOSS_RTOL (in eval
    form asserted tighter than JAX bfloat16's distance from JAX float32),
    the gradients within GRAD_TOL (asserted tighter than JAX bfloat16's as
    listed above), the shares of JAX's own distance above; the updated
    BatchNorm statistics, float32, within 1e-3 (a flip moves a channel's mean
    by a bfloat16 ulp of one element over B*T)."""
    model, *readings, g_bf = _port_against_jax("bfloat16", 0, 1, train)
    assert model.encoder.conv0.bf16 and model.training
    gates = {**_fixed_gates(train, *readings), **{f"{k} (share)": v for k, v in _share_gates(train, *readings).items()}}
    assert all(gates.values()), (gates, readings)
    for name, buf in model.named_buffers():
        assert buf.dtype == torch.float32
        torch.testing.assert_close(buf, g_bf[name], atol=1e-3, rtol=0, msg=name)


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("init, batch", MORE_BATCHES)
def test_bf16_gradient_shares_hold_on_more_batches(init, batch, train):
    """The same comparison from other weights and batches (the table above),
    held to the shares of JAX's own distance that part bfloat16 from
    float32."""
    _, *readings, _ = _port_against_jax("bfloat16", init, batch, train)
    gates = _share_gates(train, *readings)
    assert all(gates.values()), (gates, readings)


class WideGenerator(JaxGenerator):
    """The JAX generator at chosen widths: encoder channels ``enc``, decoder
    lstm_dim ``lstm``, postnet channels ``post``."""

    enc: int = 32
    lstm: int = 64
    post: int = 32

    def setup(self):
        self.encoder = Encoder(self.dim_neck, self.freq, channels=self.enc, dtype=self.dtype,
                               use_pallas=self.use_pallas)
        self.decoder = Decoder(self.n_bins, self.dim_pre, lstm_dim=self.lstm, dtype=self.dtype,
                               use_pallas=self.use_pallas)
        self.postnet = Postnet(self.n_bins, channels=self.post, dtype=self.dtype)


def test_bf16_gradients_on_wider_layers_nearer_jax_than_float32():
    """ROADMAP Queue 3's (1, 2): at the narrow widths the port's worst leaf
    (decoder.lstm1.w_hh_l0_fwd) lies 1.20 of its scale from JAX bfloat16's,
    1.72x JAX float32's own 0.70. The same step with layers four times as
    wide (encoder 128, lstm_dim 256, postnet 128), where one bfloat16 flip
    weighs less in a leaf's sums: the port's worst and mean leaf distances
    both below JAX float32's own (measured 0.409 against 0.961 and 0.154
    against 0.358, scripts/bf16_step_widths.py), as a rounding point the
    port missed would not let them fall."""
    wide = dict(enc=128, lstm=256, post=128)
    f32, bf = WideGenerator(**NARROW, **wide), WideGenerator(**NARROW, **wide, dtype=jnp.bfloat16, use_pallas=True)
    x0, e0 = _batch(100)
    variables = f32.init(jax.random.PRNGKey(1), jnp.asarray(x0), jnp.asarray(e0), jnp.asarray(e0))
    params, stats = variables["params"], variables["batch_stats"]
    x, emb = _batch(2)
    _, g32 = _jax_loss_and_grads(f32, params, stats, x, emb, True)
    _, g_bf = _jax_loss_and_grads(bf, params, stats, x, emb, True)
    cfg = Config(model=dataclasses.replace(PORT_MODEL, enc_channels=128, dec_lstm_dim=256, postnet_channels=128))
    model = _port_model(params, stats, cfg)
    total, _ = loss_fn(model, cfg, torch.from_numpy(x), torch.from_numpy(emb), train=True)
    total.backward()
    got = {n: p.grad for n, p in model.named_parameters()}
    port, own = _leaf_distances(got, g_bf, got), _leaf_distances(g32, g_bf, got)
    assert port.max() < own.max() and port.mean() <= MEAN_SHARE * own.mean(), (port.max(), own.max(),
                                                                                  port.mean(), own.mean())


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("init, batch", [(0, 1), *MORE_BATCHES])
def test_whole_loss_gates_refuse_a_float32_port(init, batch, train):
    """The control of the two tests above: the port in float32 against JAX
    bfloat16 fails at least one of their gates on every batch (it lands at
    JAX float32's own distance)."""
    _, *readings, _ = _port_against_jax("float32", init, batch, train)
    gates = _share_gates(train, *readings)
    if (init, batch) == (0, 1):
        gates.update(_fixed_gates(train, *readings))
    assert not all(gates.values()), (gates, readings)


# (f') the speaker auxiliary on a bfloat16 conversion: JAX's DVector takes
# its dtype from its input and runs its LSTMs in bfloat16 (lax.scan, a
# bfloat16 carry) on it, and so does the port's (the scan rounding). Before
# it did, the port widened the conversion to float32 for a float32 d-vector,
# whose embeddings lay 3.2e-3 (windowed) and 3.6e-3 (crop) from JAX's on the
# same conversion (B=4, T=136, a narrow generator and GE2E). Printed by the
# tests (-s): the port's distances from JAX bfloat16 and, in brackets, the
# widened float32 d-vector's (the control):
#   windowed: embeddings 8.9e-8 (3.2e-3); input cotangent 2.1e-5 (1.4e-2)
#             of its peak; loss 5.4e-5 (1.4e-4) relative; the auxiliary's
#             gradient mean 0.070 (0.099), median 0.011 (0.023), worst
#             1.015 (0.842)
#   crop:     embeddings 8.9e-8 (3.6e-3); input cotangent 2.1e-5 (1.6e-2);
#             loss 3.8e-5 (1.4e-4); gradient mean 0.010 (0.019), median
#             0.005 (0.011), worst 0.093 (0.232)
# The d-vector alone (embeddings, input cotangent) lands at float32 noise
# from JAX's. The loss and the generator's leaves also carry the two bfloat16
# generators' distance (the port's against Pallas in interpret mode, the
# whole-network rule of (f)), so they are held to shares of the control's.
# The worst leaf is not gated: on every seed below it is postnet.conv0.bias
# (postnet.conv1.bias once), a convolution's bias before a BatchNorm, whose
# gradient is zero in exact arithmetic and so all rounding (windowed (0, 9):
# JAX's auxiliary gradient there peaks at 2.4e-3 against the leaf's 1.5e-3
# without it, over a grad_scale of 1.0e-3), and it lies as far for both.
AUX_SHARES = {"embeddings": 0.01, "input cotangent": 0.1, "loss": 0.5, "mean": 0.8}
# On more (init, batch) seeds (the test after the control), the port's
# distances and the control's, the gradient's shares of the control's mean
# and median:
#   windowed (1, 10): embeddings 1.2e-7 (2.5e-3); input cotangent 1.3e-3
#     (1.3e-2); loss 5.5e-4 (3.6e-5); mean share 0.82, median 0.83
#   windowed (2, 11): 6.0e-8 (3.6e-3); 4e-21 (1.5e-2); 8.5e-5 (2.9e-4);
#     0.69, 0.51
#   windowed (0, 12): 6.0e-8 (3.7e-3); 4e-14 (1.6e-2); 1.9e-4 (3.0e-4);
#     0.61, 0.46
#   crop (1, 10): 8.9e-8 (3.1e-3); 1e-27 (1.7e-2); 6.2e-5 (4.8e-4); 0.72, 0.62
#   crop (2, 11): 6.0e-8 (2.4e-3); 9e-11 (1.2e-2); 4.3e-5 (6.4e-4); 0.68, 0.51
#   crop (0, 12): 8.9e-8 (4.7e-3); 1e-8 (1.6e-2); 1.6e-4 (7.9e-4); 0.52, 0.42
# There the embeddings' gate holds against the control's own distance, and
# the gradient's mean and median within MORE_SEED_SHARE of the control's.
# The loss is not gated there: on 'windowed' (1, 10) the port's lies 15x
# the control's distance from JAX's. Its d-vector's part is nil (the
# embeddings on the same conversion 1.2e-7 apart; relabelling the port
# d-vector's hidden units moves the loss by 0), so the distance is the two
# generators' conversions seen through the hinge, which the control's own
# offset happened to cancel there. Nor the input cotangent: on 'windowed'
# (1, 10) one bfloat16 flip in the backward puts it at 0.100 of the
# control's.
MORE_SPK_SEEDS = [(1, 10), (2, 11), (0, 12)]
MORE_SEED_SHARE = 0.9
WIDENED_APART = {"windowed": 3.2e-3, "crop": 3.6e-3}  # the control's embeddings (before this form)
SPK_LAMBDA = 0.7


class _WidenedDVector(torch.nn.Module):
    """The control: the float32 d-vector on the conversion widened to
    float32, as the port ran it before the scan rounding."""

    def __init__(self, dvector):
        super().__init__()
        self.dvector = dvector

    def forward(self, x):
        return self.dvector(x.float())


def _spk_batch(seed=9):
    rng = np.random.RandomState(seed)
    x = rng.rand(4, 136, 80).astype(np.float32)
    emb = rng.randn(4, NARROW["dim_emb"]).astype(np.float32)
    return x, emb, emb / np.linalg.norm(emb, axis=-1, keepdims=True)


@functools.lru_cache(maxsize=None)
def _jax_speaker_aux(protocol, init=0, batch=9):
    """JAX bfloat16's (``use_pallas=True``, interpret mode) loss with the
    auxiliary and its gradients with and without it, on init seed ``init``,
    batch seed ``batch``, the narrow GE2E of seed 2 and the batch's own
    table (windowed)."""
    from autovc_tpu.config import Config as JaxConfig
    from autovc_tpu.config import TrainConfig as JaxTrainConfig

    from test_torch_speaker import _narrow_pair

    x, emb, table = _spk_batch(batch)
    params, stats = _jax_init(init)
    _, jdvec, jdparams = _narrow_pair(2)
    tables = (jnp.asarray(table), jnp.asarray(table)) if protocol == "windowed" else ()
    jaux = jax_step.SpeakerAux(jdvec, jdparams, *tables)
    out = {}
    for lam in (SPK_LAMBDA, 0.0):
        jcfg = JaxConfig(model=JaxModelConfig(model_type="spmel", **NARROW),
                         train=JaxTrainConfig(lambda_spk=lam, spk_protocol=protocol, spk_ckpt="unused-here"))
        (_, (metrics, _)), grads = jax.jit(jax.value_and_grad(
            lambda p: jax_step.loss_fn(JAX_BF16, jcfg, p, stats, jnp.asarray(x), jnp.asarray(emb), spk=jaux),
            has_aux=True))(params)
        out[lam] = (float(metrics.get("g_loss_spk", 0.0)), generator_state_from_jax({"params": grads,
                                                                                     "batch_stats": stats}))
    return params, stats, out


@functools.lru_cache(maxsize=None)
def _port_speaker_aux(protocol, widen, init=0, batch=9):
    """The port's bfloat16 auxiliary against JAX bfloat16's: both d-vectors
    on the port's eval-mode conversion, their embeddings' distance and their
    input cotangents' (a seeded cotangent of the embeddings; over the peak of
    JAX's), and of the whole loss: the auxiliary loss's distance (relative)
    and the auxiliary's gradient's (the loss's with minus without, over each
    leaf's ``grad_scale``, mean and worst over the leaves); with the port's
    d-vector or, with ``widen``, the control."""
    from autovc_tpu_torch.train.step import SpeakerAux, windowed_embed

    from test_torch_speaker import _narrow_pair

    x, emb, table = _spk_batch(batch)
    params, stats, jax_out = _jax_speaker_aux(protocol, init, batch)
    port_dvec, jdvec, jdparams = _narrow_pair(2)
    dvec = _WidenedDVector(port_dvec) if widen else port_dvec
    tables = (torch.from_numpy(table), torch.from_numpy(table)) if protocol == "windowed" else ()
    aux = SpeakerAux(dvec, *tables)
    xt, et = torch.from_numpy(x), torch.from_numpy(emb)
    model = _port_model(params, stats, PORT_CFG).eval()  # the running statistics the step starts from
    with torch.no_grad():
        x_conv = model(xt, et, torch.roll(et, 1, dims=0))[1]
    assert x_conv.dtype == BF
    x_conv.requires_grad_()
    e_port = windowed_embed(dvec, x_conv) if protocol == "windowed" else dvec(x_conv)
    cot = np.random.RandomState(3).randn(*e_port.shape).astype(np.float32)
    (e_port * torch.from_numpy(cot)).sum().backward()
    if protocol == "windowed":
        embed = lambda v: jax_step.windowed_embed(jdvec, jdparams, v)  # noqa: E731
    else:
        embed = lambda v: jdvec.apply({"params": jdparams}, v)  # noqa: E731
    e_jax, vjp = jax.vjp(jax.jit(embed), jnp.asarray(_np(x_conv)).astype(jnp.bfloat16))
    dx_jax = _np(vjp(jnp.asarray(cot))[0])
    grads, loss_spk = {}, None
    for lam in (SPK_LAMBDA, 0.0):
        model = _port_model(params, stats, PORT_CFG)
        cfg = Config(model=PORT_MODEL, train=TrainConfig(lambda_spk=lam, spk_protocol=protocol))
        total, metrics = loss_fn(model, cfg, xt, et, spk=aux)
        total.backward()
        grads[lam] = {n: p.grad for n, p in model.named_parameters()}
        loss_spk = float(metrics["g_loss_spk"]) if lam else loss_spk
    got = {n: grads[SPK_LAMBDA][n] - grads[0.0][n] for n in grads[0.0]}
    want = {n: jax_out[SPK_LAMBDA][1][n] - jax_out[0.0][1][n] for n in got}
    names = list(got)
    leaves = _leaf_distances(got, want, names)
    jax_loss = jax_out[SPK_LAMBDA][0]
    readings = {"embeddings": float(np.abs(_np(e_port) - _np(e_jax)).max()),
                "input cotangent": float(np.abs(_np(x_conv.grad) - dx_jax).max() / np.abs(dx_jax).max()),
                "loss": abs(loss_spk - jax_loss) / abs(jax_loss), "mean": float(leaves.mean()),
                "median": float(np.median(leaves)), "worst": float(leaves.max())}
    worst = names[int(leaves.argmax())]
    # the worst leaf: its auxiliary gradient's peak against the whole loss's
    # gradient there (the auxiliary is then the difference of two near-equal
    # bfloat16 gradients) and the scale its distance is taken over
    worst_leaf = {"leaf": worst, "aux peak": float(want[worst].abs().max()),
                  "loss gradient peak": float(jax_out[0.0][1][worst].abs().max()),
                  "grad_scale": grad_scale(worst, want)}
    print(f"{protocol} ({init}, {batch}), {'widened float32' if widen else 'bfloat16'} d-vector: {readings}; "
          f"worst leaf {worst_leaf}")
    return readings


def _aux_gates(protocol, readings, control) -> dict:
    """Each gated reading within its share of the control's (the
    embeddings: of the widening's distance measured before this form)."""
    return {k: readings[k] <= AUX_SHARES[k] * (WIDENED_APART[protocol] if k == "embeddings" else control[k])
            for k in AUX_SHARES}


@pytest.mark.parametrize("protocol", ["windowed", "crop"])
def test_bf16_speaker_auxiliary_matches_jax(protocol):
    """``loss_fn`` with lambda_spk on a bfloat16 narrow generator runs the
    frozen d-vector in bfloat16 on the bfloat16 conversion, with the scan
    rounding, as JAX does: against JAX's ``--bf16 --pallas`` loss on the
    same weights and batch, its embeddings, its auxiliary loss and the
    auxiliary's gradient on the generator's leaves each within AUX_SHARES
    of the widened float32 d-vector's distance."""
    readings = _port_speaker_aux(protocol, widen=False)
    control = _port_speaker_aux(protocol, widen=True)
    gates = _aux_gates(protocol, readings, control)
    assert all(gates.values()), (gates, readings, control)


@pytest.mark.parametrize("protocol", ["windowed", "crop"])
def test_bf16_speaker_auxiliary_gates_refuse_a_float32_dvector(protocol):
    """The control of the test above: the widened float32 d-vector (the
    port before the scan rounding) fails the embeddings' gate, and lies at
    the widening's distance measured before (within 2x)."""
    control = _port_speaker_aux(protocol, widen=True)
    gates = _aux_gates(protocol, control, control)
    assert not gates["embeddings"], (gates, control)
    assert 0.5 * WIDENED_APART[protocol] <= control["embeddings"] <= 2 * WIDENED_APART[protocol]


@pytest.mark.parametrize("protocol", ["windowed", "crop"])
@pytest.mark.parametrize("init, batch", MORE_SPK_SEEDS)
def test_bf16_speaker_auxiliary_holds_on_more_seeds(protocol, init, batch):
    """The comparison of the two tests above from other weights and
    batches: the embeddings within 0.01 of the control's distance, the
    auxiliary's gradient's mean and median over the leaves within
    MORE_SEED_SHARE of the control's (which fails them: its share is 1)."""
    readings = _port_speaker_aux(protocol, False, init, batch)
    control = _port_speaker_aux(protocol, True, init, batch)
    gates = {"embeddings": readings["embeddings"] <= AUX_SHARES["embeddings"] * control["embeddings"],
             **{k: readings[k] <= MORE_SEED_SHARE * control[k] for k in ("mean", "median")}}
    assert all(gates.values()), (gates, readings, control)


# ------------------------------------------------------ (g) Solver and CLI


@functools.lru_cache(maxsize=None)
def _jax_trajectories():
    """Three jitted JAX train steps (``make_train_step``) in bfloat16 and in
    float32 from init seed 1 on batch seeds 10-12: the batches, the start,
    and per dtype the losses, the final parameters and statistics, and
    Adam's first moment after the first step (0.1 of its gradient)."""
    from autovc_tpu.config import Config as JaxConfig
    from autovc_tpu.config import TrainConfig as JaxTrainConfig

    jcfg = JaxConfig(model=JaxModelConfig(model_type="spmel", **NARROW), train=JaxTrainConfig(num_iters=3))
    params, stats = _jax_init(seed=1)
    batches = [_batch(10 + i) for i in range(3)]
    trajectories = {}
    for name, model in (("bf16", JAX_BF16), ("f32", JAX_F32)):
        opt = jax_step.make_optimizer(jcfg)
        st = jax_state.TrainState(step=jnp.asarray(0, jnp.int32), params=params, batch_stats=stats,
                                  opt_state=opt.init(params), ema_params=jax_state.init_ema(params))
        step = jax.jit(jax_step.make_train_step(model, jcfg, opt))
        losses, first_moment = [], None
        for x, emb in batches:
            st, m = step(st, jnp.asarray(x), jnp.asarray(emb), jnp.asarray(1.0, jnp.float32))
            losses.append(float(m["g_loss"]))
            if first_moment is None:
                first_moment = generator_state_from_jax({"params": st.opt_state.inner_state[0].mu,
                                                         "batch_stats": stats})
        trajectories[name] = (losses, generator_state_from_jax({"params": st.params, "batch_stats": st.batch_stats}),
                              first_moment)
    return batches, params, stats, trajectories


def _solver_gates(tmp_path, compute_dtype) -> tuple[dict, Solver]:
    """Three steps of the port's Solver in ``compute_dtype`` against the JAX
    bfloat16 steps (``_jax_trajectories``): the gates of (g) and the
    Solver."""
    batches, params, stats, trajectories = _jax_trajectories()
    cfg = Config(model=dataclasses.replace(PORT_MODEL, compute_dtype=compute_dtype),
                 train=TrainConfig(num_iters=3, batch_size=4, len_crop=32, log_step=1, checkpoint_step=100),
                 main_dir=str(tmp_path), run_name=compute_dtype)
    solver = Solver(cfg, iter(batches), run_dir=str(tmp_path / "run"), device="cpu")
    model = solver.state.model
    model.load_state_dict(_port_model(params, stats, cfg).state_dict())
    solver.state.ema_params = {k: v.detach().clone() for k, v in model.named_parameters()}
    names = {p: n for n, p in model.named_parameters()}
    first_moment = {}

    def keep_first_moment(opt, args, kwargs):
        if not first_moment:
            first_moment.update({names[p]: opt.state[p]["exp_avg"].clone() for p in names})

    solver.state.optimizer.register_step_post_hook(keep_first_moment)
    solver.train()
    assert solver.state.step == 3
    losses = [h["g_loss"] for h in solver.history]
    port_loss = [abs(g - w) / abs(w) for g, w in zip(losses, trajectories["bf16"][0], strict=True)]
    jax_loss = [abs(g - w) / abs(w) for g, w in zip(*(trajectories[k][0] for k in ("bf16", "f32")))]
    want_bf, want32 = trajectories["bf16"][1], trajectories["f32"][1]
    port_apart, jax_apart, params_within = [], [], True
    for name, p in model.named_parameters():
        assert p.dtype == torch.float32
        apart = (p.detach() - want_bf[name]).abs()
        params_within &= float(apart.max()) <= 6e-4
        port_apart.append(float((apart > 2e-6).float().mean()))
        jax_apart.append(float(((want32[name] - want_bf[name]).abs() > 2e-6).float().mean()))
    moment_bf, moment32 = trajectories["bf16"][2], trajectories["f32"][2]
    port_moment = _leaf_distances(first_moment, moment_bf, first_moment)
    jax_moment = _leaf_distances(moment32, moment_bf, first_moment)
    print(f"port in {compute_dtype}: losses a step from JAX bf16 {port_loss} (JAX bf16 from f32 {jax_loss}); "
          f"parameters more than 2e-6 from JAX bf16: {np.mean(port_apart):.3f} of them (JAX bf16 from f32: "
          f"{np.mean(jax_apart):.3f}); the first step's moment, mean leaf distance {port_moment.mean():.3f} "
          f"({jax_moment.mean():.3f})")
    gates = {"loss": max(port_loss) <= STEP_LOSS_RTOL and max(port_loss) <= 2 * max(jax_loss),
             "parameters": params_within, "share": np.mean(port_apart) <= np.mean(jax_apart),
             "first moment": port_moment.mean() <= MEAN_SHARE * jax_moment.mean()}
    return gates, solver


def test_three_bf16_solver_steps_match_jax_train_step(tmp_path):
    """Three steps of the port's Solver on a bfloat16 narrow generator
    against the jitted JAX ``make_train_step`` (``dtype=bfloat16,
    use_pallas=True``) from the same weights on the same batches: each
    step's loss within STEP_LOSS_RTOL of JAX's and no farther than twice JAX
    bfloat16's own loss from JAX float32's at its worst step (measured on the
    CPU: the port 2.1e-5, 1.4e-4, 1.5e-4 from JAX bfloat16; JAX bfloat16
    6.6e-5, 2.4e-5, 1.3e-4 from JAX float32; printed with -s), the parameters within 6e-4
    (2 * 3 * lr: Adam moves an element by about lr a step whatever its
    gradient's size; measured 5.9e-4), and the share of elements more than
    2e-6 apart no larger than JAX bfloat16's own share from JAX float32's
    trajectory (measured 0.78 and 0.87); Adam's first moment after the first
    step (its gradient) a mean leaf distance from JAX bfloat16's of at most
    MEAN_SHARE of JAX float32's, as in (f). Parameters, Adam state, EMA and
    statistics stay float32. Only that last gate parts bfloat16 from float32
    with room (measured 0.025 against 0.193; a float32 port fails it:
    test_three_solver_steps_refuse_a_float32_port). After three Adam steps
    the parameters need not: the share of elements more than 2e-6 from JAX
    bfloat16's is 0.822, 0.847 and 0.804 from init seeds 0, 2 and 3 (batch
    seeds 20, 30 and 40 on), against JAX float32's 0.840, 0.839 and 0.879, so
    from seed 2 the share gate would fail (ROADMAP Queue 3)."""
    gates, solver = _solver_gates(tmp_path, "bfloat16")
    assert all(gates.values()), gates
    assert solver.state.model.encoder.conv0.bf16
    opt_state = solver.state.optimizer.state_dict()["state"]
    assert {v.dtype for s in opt_state.values() for k, v in s.items() if k != "step"} == {torch.float32}
    assert {v.dtype for v in solver.state.ema_params.values()} == {torch.float32}


def test_three_solver_steps_refuse_a_float32_port(tmp_path):
    """The control of the test above: the port's Solver in float32 fails at
    least one of its gates against JAX bfloat16."""
    gates, _ = _solver_gates(tmp_path, "float32")
    assert not all(gates.values()), gates


def test_cli_train_bf16_trains_and_exports(tmp_path, monkeypatch):
    """``cli.train --bf16`` on the CPU: the Solver trains a bfloat16
    generator (the CLI's widths narrowed by a stand-in ModelConfig, so that
    no full-width model is trained here) for 3 steps to a finite loss, and
    ``--export`` writes float32 parameters that the JAX package and
    ``build_generator`` load."""
    from autovc_tpu.cli.export_ckpt import load_artifact as jax_load_artifact
    from autovc_tpu_torch.cli import train as cli_train

    narrow = functools.partial(ModelConfig, enc_channels=32, dec_lstm_dim=64, postnet_channels=32)
    monkeypatch.setattr(cli_train, "ModelConfig", narrow)
    seen = {}
    real_solver = Solver

    def solver(cfg, data_iter, device):
        seen["cfg"] = cfg
        return real_solver(cfg, data_iter, device=device)

    import autovc_tpu_torch.train as train_pkg
    monkeypatch.setattr(train_pkg, "Solver", solver)
    _write_corpus(tmp_path)
    out = str(tmp_path / "gen.npz")
    cli_train.main(["--main_dir", str(tmp_path), "--run_name", "b", "--device", "cpu", "--bf16", "--num_iters", "3",
                    "--batch_size", "2", "--len_crop", "32", "--dim_neck", "8", "--dim_emb", "16", "--dim_pre", "32",
                    "--freq", "8", "--log_step", "1", "--checkpoint_step", "3", "--export", out])
    assert seen["cfg"].model.compute_dtype == "bfloat16"
    tree, step = load_artifact(out)
    assert step == 3
    assert all(np.asarray(v).dtype == np.float32 for v in jax.tree_util.tree_leaves(tree))
    jax_tree = jax_load_artifact(out)
    assert jax_tree is not None
    model = build_generator(PORT_MODEL, artifact=out, device="cpu")
    x, emb = map(torch.from_numpy, _batch(2, b=2))
    with torch.no_grad():
        mel = model(x, emb, emb)[1]
    assert mel.dtype == BF and bool(torch.isfinite(mel.float()).all())
    assert os.path.isdir(os.path.join(str(tmp_path), "runs"))
