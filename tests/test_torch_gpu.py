"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here carries the ``gpu`` marker and skips without a CUDA device.
The file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest -p no:cacheprovider --noconftest -m gpu tests/test_torch_gpu.py
"""


import dataclasses
import os

import numpy as np
import pytest
import scipy.signal
import torch

from autovc_tpu_torch.cli import make_spect
from autovc_tpu_torch.config import AudioConfig, Config, TrainConfig, WaveNetConfig
from autovc_tpu_torch.convert import Converter
from autovc_tpu_torch.dsp import (MelFrontend, butter_highpass, butter_highpass_sos, mel_filterbank, sos_filtfilt,
                                  write_wav)
from autovc_tpu_torch.eval import SpeakerEmbedder
from autovc_tpu_torch.io import dvector_state_to_jax
from autovc_tpu_torch.models import build_dvector, build_generator
from autovc_tpu_torch.ops import lstm as lstm_ops
from autovc_tpu_torch.ops import mel as mel_ops
from autovc_tpu_torch.ops import sosfilt as sosfilt_ops
from autovc_tpu_torch.ops import wavenet as wavenet_ops
from autovc_tpu_torch.train import TrainState, init_ema, loss_fn, make_eval_loss, make_optimizer, make_train_step
from autovc_tpu_torch.train.compare import KinkTape, grad_scale
from autovc_tpu_torch.train.step import SpeakerAux
from autovc_tpu_torch.vocoder import HiFiGANVocoder, WaveNetVocoder

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(seed, b, t, hidden):
    rng = np.random.RandomState(seed)
    xproj = (rng.randn(b, t, 4 * hidden) * 0.5).astype(np.float32)
    bound = 1.0 / np.sqrt(hidden)
    w_hh = rng.uniform(-bound, bound, (hidden, 4 * hidden)).astype(np.float32)
    return xproj, w_hh


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("b, t, hidden", [(32, 64, 32), (32, 64, 512), (32, 64, 1024), (37, 20, 64), (1, 5, 8),
                                          (7, 24, 256), (64, 16, 768), (7, 1, 1024), (64, 24, 32), (1, 1, 256)])
def test_lstm_kernel_matches_plain(cuda, b, t, hidden, reverse):
    """Batch 37 spans two row tiles of the kernel (and batch 64 two tiles of
    regime (b)); batch 1 with H=8 is the smallest shape it takes; H=256 and
    768 are the d-vector's widths; T=1 is a sequence of one step, with no
    grid barrier. Tolerance 1e-4: f32 sums in another order."""
    xproj, w_hh = _inputs(4, b, t, hidden)
    x, w = torch.from_numpy(xproj).to(cuda), torch.from_numpy(w_hh).to(cuda)
    before = lstm_ops.launches
    got = lstm_ops.lstm_sequence(x, w, reverse)
    torch.cuda.synchronize()
    assert lstm_ops.launches == before + 1
    torch.testing.assert_close(got, lstm_ops.lstm_sequence_ref(x, w, reverse), atol=1e-4, rtol=0)


def test_lstm_kernel_takes_strided_input(cuda):
    """A non-contiguous xproj is made contiguous by the wrapper."""
    xproj, w_hh = _inputs(5, 16, 24, 64)
    x = torch.from_numpy(xproj).to(cuda).transpose(0, 1).contiguous().transpose(0, 1)
    w = torch.from_numpy(w_hh).to(cuda)
    assert not x.is_contiguous()
    torch.testing.assert_close(lstm_ops.lstm_sequence(x, w), lstm_ops.lstm_sequence_ref(x, w),
                               atol=1e-4, rtol=0)


def test_generator_on_card_matches_cpu(cuda):
    """Seeded full-width generator: the card (kernel, cuDNN convs without
    TF32) against the CPU (plain recurrence). Tolerance 1e-3 on the whole
    network, as chip_smoke.py holds the end-to-end mel."""
    cpu_gen = build_generator(device="cpu", seed=0)
    card_gen = build_generator(device=cuda, seed=0)
    rng = np.random.RandomState(6)
    x = torch.from_numpy(rng.rand(3, 64, 80).astype(np.float32))
    e = torch.from_numpy(rng.randn(3, 256).astype(np.float32))
    with torch.inference_mode():
        want = cpu_gen(x, e, e)
        before = lstm_ops.launches
        got = card_gen(x.to(cuda), e.to(cuda), e.to(cuda))
        torch.cuda.synchronize()
    assert lstm_ops.launches == before + 7
    for g, w in zip(got, want):
        torch.testing.assert_close(g.cpu(), w, atol=1e-3, rtol=0)


WAVENET_TINY = WaveNetConfig(out_channels=12, layers=6, stacks=2, residual_channels=16, gate_channels=16,
                             skip_channels=8)


def _first_apart(a, b, tol):
    """Per row, the first sample where |a - b| > tol (the length if none)."""
    apart = (a - b).abs() > tol
    idx = torch.arange(a.shape[1], device=a.device).expand_as(a)
    return torch.where(apart, idx, a.shape[1]).min(dim=1).values.tolist()


def _wavenet_case(cuda, cfg, b, frames, seed):
    voc = WaveNetVocoder(cfg, device=cuda, seed=seed)
    mel = torch.from_numpy(np.random.RandomState(seed).rand(b, frames, 80).astype(np.float32)).to(cuda)
    cond = voc.model.upsample_conditioning(mel)
    return voc, mel, cond, voc.uniforms(b, cond.shape[1], torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("b", [1, 3, 8])
@pytest.mark.parametrize("width", ["tiny", "full"])
def test_wavenet_kernel_matches_plain(cuda, width, b):
    """The kernel against the plain loop on the same uniforms: the first 32
    samples of every row within 1e-4 (f32 sums in another order; later the
    autoregressive feedback may carry the trajectories apart), and the
    kernel's logits within 1e-3 of the teacher-forced forward on its own
    waveform, which cannot drift. Tiny: 4 frames (1024 samples); full
    width: 2 frames (512 samples)."""
    cfg, frames = (WAVENET_TINY, 4) if width == "tiny" else (WaveNetConfig(), 2)
    voc, mel, cond, u = _wavenet_case(cuda, cfg, b, frames, seed=b)
    before = wavenet_ops.launches
    y, logits = wavenet_ops.generate(voc.packed, cfg.dilations(), cond, u, cfg.log_scale_min)
    torch.cuda.synchronize()
    assert wavenet_ops.launches == before + 1
    # one persistent cooperative launch for all T samples (the plan's count)
    assert wavenet_ops.last_cuda_launches == wavenet_ops.last_launch[0].launches == 1
    assert y.shape == (b, frames * 256) and bool(torch.isfinite(y).all()) and float(y.abs().max()) <= 1.0
    y_ref, _ = wavenet_ops.generate_ref(voc.packed, cfg.dilations(), cond, u, cfg.log_scale_min)
    assert min(_first_apart(y, y_ref, 1e-4)) >= 32
    torch.testing.assert_close(logits, voc.logits(y[..., None], mel), atol=1e-3, rtol=0)


def test_wavenet_kernel_full_width_batch_32(cuda):
    """B=32 at full width (the batch of the JAX package's hybrid kernel): 4
    batch tiles inside each phase. Teacher-forced logits within 1e-3, the
    first 32 samples of every row within 1e-4 of the plain loop (run over
    the first 64), and a second call the same waveform bit for bit."""
    cfg = WaveNetConfig()
    voc, mel, cond, u = _wavenet_case(cuda, cfg, 32, 2, seed=12)
    y, logits = wavenet_ops.generate(voc.packed, cfg.dilations(), cond, u, cfg.log_scale_min)
    y2, _ = wavenet_ops.generate(voc.packed, cfg.dilations(), cond, u, cfg.log_scale_min)
    torch.cuda.synchronize()
    assert torch.equal(y, y2)
    assert y.shape == (32, 512) and bool(torch.isfinite(y).all()) and float(y.abs().max()) <= 1.0
    y_ref, _ = wavenet_ops.generate_ref(voc.packed, cfg.dilations(), cond[:, :64].contiguous(),
                                        u[:, :64].contiguous(), cfg.log_scale_min)
    assert min(_first_apart(y[:, :64], y_ref, 1e-4)) >= 32
    torch.testing.assert_close(logits, voc.logits(y[..., None], mel), atol=1e-3, rtol=0)


def test_wavenet_kernel_with_blocks_that_own_nothing(cuda, monkeypatch):
    """A forced plan of 100 blocks at the tiny width (G/2 = 8 gate pairs,
    R+S = 24 residual and S = 8 head columns, one a block): 76 blocks own
    no column of any phase and still meet every grid barrier. A ring of 2
    layers, so that slots are reused within a sample."""
    widths = (16, 16, 8, 80, 12)
    plan = wavenet_ops.GeneratePlan(100, 1, 1, 1, 2, wavenet_ops._smem(3, widths, 1, 1, 1, 2))
    monkeypatch.setattr(wavenet_ops, "_plan_on_card", lambda b, w, device, esize=4: plan)
    voc, mel, cond, u = _wavenet_case(cuda, WAVENET_TINY, 3, 2, seed=13)
    y, logits = wavenet_ops.generate(voc.packed, WAVENET_TINY.dilations(), cond, u, WAVENET_TINY.log_scale_min)
    torch.cuda.synchronize()
    assert wavenet_ops.last_launch[0] == plan
    y_ref, _ = wavenet_ops.generate_ref(voc.packed, WAVENET_TINY.dilations(), cond, u, WAVENET_TINY.log_scale_min)
    assert min(_first_apart(y, y_ref, 1e-4)) >= 32
    torch.testing.assert_close(logits, voc.logits(y[..., None], mel), atol=1e-3, rtol=0)


def test_wavenet_plan_that_cannot_be_resident_raises(cuda, monkeypatch):
    """A grid larger than the card holds at once is refused before launch,
    with the blocks asked for and the card's resident blocks a SM and SMs."""
    widths = (16, 16, 8, 80, 12)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    plan = wavenet_ops.GeneratePlan(8 * sms, 1, 1, 1, 2, wavenet_ops._smem(1, widths, 1, 1, 1, 2))
    monkeypatch.setattr(wavenet_ops, "_plan_on_card", lambda b, w, device, esize=4: plan)
    voc, _, cond, u = _wavenet_case(cuda, WAVENET_TINY, 1, 1, seed=14)
    with pytest.raises(RuntimeError, match=rf"{8 * sms} blocks must be resident .* holds \d+ per SM on {sms} SMs"):
        wavenet_ops.generate(voc.packed, WAVENET_TINY.dilations(), cond, u)


def test_wavenet_kernel_takes_strided_cond(cuda):
    """A non-contiguous cond is made contiguous by the wrapper."""
    voc, _, cond, u = _wavenet_case(cuda, WAVENET_TINY, 3, 2, seed=9)
    strided = cond.transpose(0, 1).contiguous().transpose(0, 1)
    assert not strided.is_contiguous()
    dils = WAVENET_TINY.dilations()
    y, logits = wavenet_ops.generate(voc.packed, dils, strided, u)
    y_ref, logits_ref = wavenet_ops.generate_ref(voc.packed, dils, cond, u)
    assert min(_first_apart(y, y_ref, 1e-4)) >= 32
    torch.testing.assert_close(logits[:, :32], logits_ref[:, :32], atol=1e-4, rtol=0)


def test_wavenet_vocoder_on_card_matches_cpu(cuda):
    """The seeded vocoder's default stream on the card and on the CPU: the
    same waveform over a prefix of 32 samples."""
    mel = np.random.RandomState(10).rand(2, 1, 80).astype(np.float32)
    on_card = WaveNetVocoder(WAVENET_TINY, device=cuda, seed=4).generate(mel)
    on_cpu = WaveNetVocoder(WAVENET_TINY, device="cpu", seed=4).generate(mel)
    assert min(_first_apart(on_card.cpu(), on_cpu, 1e-4)) >= 32


def _train_inputs(seed, b, t, hidden):
    """Forward inputs with a nonzero initial state, and random cotangents."""
    rng = np.random.RandomState(seed)
    xproj, w_hh = _inputs(seed, b, t, hidden)
    h0, c0, dy = (rng.randn(*shape).astype(np.float32) * 0.5
                  for shape in [(b, hidden), (b, hidden), (b, t, hidden)])
    dhn, dcn = (rng.randn(b, hidden).astype(np.float32) for _ in range(2))
    return xproj, w_hh, h0, c0, dy, dhn, dcn


TRAIN_SHAPES = [(7, 128, 32), (7, 128, 512), (7, 64, 1024), (37, 20, 64), (1, 5, 8),
                (7, 24, 256), (64, 16, 768), (7, 1, 1024), (64, 12, 256), (1, 1, 32)]


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("b, t, hidden", TRAIN_SHAPES)
def test_lstm_train_forward_matches_plain(cuda, b, t, hidden, reverse):
    """The training form as ``LSTMSequenceFn`` runs it (h0, c0 in; h_seq,
    c_seq, hN, cN and the gate activations out) against the plain loop and
    ``lstm_gates_ref``, within 1e-4: f32 sums in another order."""
    xproj, w_hh, h0, c0 = (torch.from_numpy(a).to(cuda) for a in _train_inputs(1, b, t, hidden)[:4])
    before = lstm_ops.launches
    got = lstm_ops.lstm_forward_cuda(xproj, w_hh, h0, c0, reverse, with_cseq=True, with_gates=True)
    torch.cuda.synchronize()
    assert lstm_ops.launches == before + 1
    want = lstm_ops.lstm_sequence_train_ref(xproj, w_hh, h0, c0, reverse)
    want += (lstm_ops.lstm_gates_ref(xproj, w_hh, h0, want[0], reverse),)
    for g, w in zip(got, want, strict=True):
        torch.testing.assert_close(g, w, atol=1e-4, rtol=0)


@pytest.mark.parametrize("h0_kind", ["zero", "nonzero"])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("b, t", [(1, 1), (3, 37), (7, 128), (1, 8192)])
@pytest.mark.parametrize("hidden", [8, 32, 512, 1024])
def test_lstm_weight_grad_matches_plain(cuda, hidden, b, t, reverse, h0_kind):
    """The dW kernel against lstm_weight_grad_ref at every split of K its
    plan takes (none at K = 1 or H=1024, 14 at H=32, B*T=896, up to 32 at
    B*T=8192), within 1e-4 of the largest magnitude (a sum of B*T products
    an element, in another order); two calls give the same bits; one
    wrapper launch a call."""
    rng = np.random.RandomState(hidden + b * t)
    h_seq = torch.from_numpy(rng.randn(b, t, hidden).astype(np.float32)).to(cuda)
    dx = torch.from_numpy(rng.randn(b, t, 4 * hidden).astype(np.float32)).to(cuda)
    h0 = None if h0_kind == "zero" else torch.from_numpy(rng.randn(b, hidden).astype(np.float32)).to(cuda)
    before = lstm_ops.dw_launches
    got = lstm_ops.lstm_weight_grad_cuda(h_seq, h0, dx, reverse)
    again = lstm_ops.lstm_weight_grad_cuda(h_seq, h0, dx, reverse)
    torch.cuda.synchronize()
    assert lstm_ops.dw_launches == before + 2
    assert torch.equal(got, again)
    want = lstm_ops.lstm_weight_grad_ref(h_seq, h0, dx, reverse)
    torch.testing.assert_close(got, want, atol=1e-4 * float(want.abs().max()), rtol=0)


def _assert_backward_close(got, want):
    """dxproj, dh0 and dc0 within 1e-4; dW, a sum of B*T products per
    element, within 1e-4 of its largest magnitude."""
    for name, g, w in zip(("dxproj", "dW", "dh0", "dc0"), got, want):
        tol = 1e-4 * float(w.abs().max()) if name == "dW" else 1e-4
        torch.testing.assert_close(g, w, atol=tol, rtol=0, msg=name)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("b, t, hidden", TRAIN_SHAPES)
def test_lstm_backward_matches_plain(cuda, b, t, hidden, reverse):
    """The backward on the forward kernel's gate activations, as the main
    path runs it, against the plain reversed loop."""
    xproj, w_hh, h0, c0, dy, dhn, dcn = (torch.from_numpy(a).to(cuda) for a in _train_inputs(2, b, t, hidden))
    h_seq, c_seq, _, _ = lstm_ops.lstm_sequence_train_ref(xproj, w_hh, h0, c0, reverse)
    gates = lstm_ops.lstm_forward_cuda(xproj, w_hh, h0, c0, reverse, with_gates=True)[4]
    before = lstm_ops.bwd_launches, lstm_ops.dw_launches
    got = lstm_ops.lstm_backward_cuda(xproj, w_hh, h0, c0, h_seq, c_seq, dy, dhn, dcn, reverse, gates=gates)
    torch.cuda.synchronize()
    assert (lstm_ops.bwd_launches, lstm_ops.dw_launches) == (before[0] + 1, before[1] + 1)
    _assert_backward_close(got, lstm_ops.lstm_backward_ref(xproj, w_hh, h0, c0, h_seq, c_seq, dy, dhn, dcn,
                                                           reverse))


@pytest.fixture
def grid_plan_at_small_h(monkeypatch):
    """Launch regime (b), the cooperative kernels with their grid barrier,
    where regime (a) would serve: one unit a block, 4-row tiles, K chunks
    of 4 floats, so that every step stages h or dgates from global memory."""
    def plan(b, hidden, kind, device, wbytes=4):
        return lstm_ops.LaunchPlan(kind, "b", hidden, 1, 4, 4, lstm_ops._smem(kind, "b", hidden, 1, 4, 4, wbytes))
    monkeypatch.setattr(lstm_ops, "_plan_on_card", plan)


@pytest.mark.parametrize("regime", ["a", "b"])
@pytest.mark.parametrize("reverse", [False, True])
def test_lstm_steps_sharing_a_line(cuda, request, regime, reverse):
    """B=1, H=8, T=64: four steps of h_seq share a 128-byte line, and in
    regime (b) each step reads the line another block wrote just before the
    barrier, so a read through a stale L1 line would show here. Forward
    (training form) and backward within 1e-4 of the plain loops."""
    if regime == "b":
        request.getfixturevalue("grid_plan_at_small_h")
    xproj, w_hh, h0, c0, dy, dhn, dcn = (torch.from_numpy(a).to(cuda) for a in _train_inputs(5, 1, 64, 8))
    got = lstm_ops.lstm_forward_cuda(xproj, w_hh, h0, c0, reverse, with_cseq=True, with_gates=True)
    torch.cuda.synchronize()
    assert lstm_ops.last_launch["fwd"][0].regime == regime
    want = lstm_ops.lstm_sequence_train_ref(xproj, w_hh, h0, c0, reverse)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-4, rtol=0)
    args = (xproj, w_hh, h0, c0, want[0], want[1], dy, dhn, dcn, reverse)
    bgot = lstm_ops.lstm_backward_cuda(*args, gates=got[4])
    torch.cuda.synchronize()
    assert lstm_ops.last_launch["bwd"][0].regime == regime
    _assert_backward_close(bgot, lstm_ops.lstm_backward_ref(*args))


def test_lstm_grid_launch_is_resident(cuda):
    """At H=1024 both kernels launch cooperatively: one block a SM holds its
    slice of w_hh, and the occupancy query counts every block resident."""
    xproj, w_hh, h0, c0, dy, dhn, dcn = (torch.from_numpy(a).to(cuda) for a in _train_inputs(6, 7, 4, 1024))
    out = lstm_ops.lstm_forward_cuda(xproj, w_hh, h0, c0, with_cseq=True, with_gates=True)
    lstm_ops.lstm_backward_cuda(xproj, w_hh, h0, c0, out[0], out[1], dy, dhn, dcn, gates=out[4])
    torch.cuda.synchronize()
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for kind in ("fwd", "bwd"):
        plan, per_sm, card_sms = lstm_ops.last_launch[kind]
        assert plan.regime == "b" and card_sms == sms and plan.blocks <= per_sm * card_sms
        assert plan.smem > 48 * 1024  # above the default limit: the attribute was set


def test_lstm_backward_takes_strided_cotangent(cuda):
    """A non-contiguous dy (as a cat of two directions hands it back) is made
    contiguous by the wrapper; no initial state and no final cotangents."""
    xproj, w_hh, _, _, dy, _, _ = (torch.from_numpy(a).to(cuda) for a in _train_inputs(3, 5, 24, 64))
    strided = dy.transpose(0, 1).contiguous().transpose(0, 1)
    assert not strided.is_contiguous()
    h_seq, c_seq, _, _ = lstm_ops.lstm_sequence_train_ref(xproj, w_hh)
    gates = lstm_ops.lstm_forward_cuda(xproj, w_hh, with_gates=True)[4]
    got = lstm_ops.lstm_backward_cuda(xproj, w_hh, None, None, h_seq, c_seq, strided, gates=gates)
    _assert_backward_close(got, lstm_ops.lstm_backward_ref(xproj, w_hh, None, None, h_seq, c_seq, dy))


def test_lstm_function_gradients_on_card_match_autograd(cuda):
    """LSTMSequenceFn on the card against torch autograd through the plain
    loop, both directions, gradients in all four inputs."""
    for reverse in (False, True):
        xproj, w_hh, h0, c0, dy, dhn, dcn = (torch.from_numpy(a).to(cuda)
                                             for a in _train_inputs(4, 6, 40, 32))
        ins = [v.clone().requires_grad_() for v in (xproj, w_hh, h0, c0)]
        ref_ins = [v.clone().requires_grad_() for v in (xproj, w_hh, h0, c0)]
        h_seq, hn, cn = lstm_ops.LSTMSequenceFn.apply(*ins, reverse)
        ((h_seq * dy).sum() + (hn * dhn).sum() + (cn * dcn).sum()).backward()
        r_seq, _, r_hn, r_cn = lstm_ops.lstm_sequence_train_ref(*ref_ins, reverse)
        ((r_seq * dy).sum() + (r_hn * dhn).sum() + (r_cn * dcn).sum()).backward()
        _assert_backward_close([v.grad for v in ins], [v.grad for v in ref_ins])


def _small_batch(seed, b=2, t=64):
    rng = np.random.RandomState(seed)
    return (torch.from_numpy(rng.rand(b, t, 80).astype(np.float32)),
            torch.from_numpy(rng.randn(b, 256).astype(np.float32)))


def test_full_width_train_step_on_card_matches_cpu(cuda):
    """One train step of the seeded full-width generator (B=2, T=64): the
    card (the kernels forward and backward, cuDNN convs without TF32)
    against the CPU (the plain versions), and both against the CPU step in
    float64, the card's and the float64 step on the CPU step's side of every
    ReLU and abs kink (``KinkTape``). The loss within 1e-5 relative; 11 LSTM
    sequences forward and backward; every gradient leaf of the card's step
    within 1e-3 of its ``grad_scale`` of the float64 step's and of the CPU
    step's (some leaves, sums over B*T with cancellation, sit a few 1e-4 of
    their scale from float64 on either float32 engine, each in its own
    summation order)."""
    cfg = Config(train=TrainConfig(batch_size=2, len_crop=64))
    x, emb = _small_batch(7)
    states = {}
    for name, dev, dtype in (("cpu", "cpu", torch.float32), ("cuda", cuda, torch.float32),
                             ("f64", "cpu", torch.float64)):
        model = build_generator(cfg.model, device=dev, seed=3, trainable=True).to(dtype)
        states[name] = TrainState(0, model, make_optimizer(model, cfg), init_ema(model))
    step = make_train_step(cfg)
    tape = KinkTape()
    with tape.record():
        want = step(states["cpu"], x, emb)
    before = lstm_ops.launches, lstm_ops.bwd_launches, lstm_ops.dw_launches
    with tape.replay():
        got = step(states["cuda"], x.to(cuda), emb.to(cuda))
        torch.cuda.synchronize()
    assert (lstm_ops.launches, lstm_ops.bwd_launches, lstm_ops.dw_launches) == tuple(n + 11 for n in before)
    with tape.replay():
        step(states["f64"], x.double(), emb.double())
    assert abs(float(got["g_loss"]) - float(want["g_loss"])) <= 1e-5 * abs(float(want["g_loss"]))
    grads = {k: {n: p.grad.double().cpu() for n, p in st.model.named_parameters()} for k, st in states.items()}
    for ref in ("f64", "cpu"):
        for n, g in grads["cuda"].items():
            apart = float((g - grads[ref][n]).abs().max()) / grad_scale(n, grads[ref])
            assert apart <= 1e-3, f"{n}: the card's step {apart:.3e} of its scale from the {ref} step"


@pytest.fixture
def torch_default_flags():
    """torch's own TF32 defaults (cuDNN on, matmul off), restored after."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = True, False
    yield (True, False)
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def _flags():
    return torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32


def test_entry_points_run_exact_f32_under_default_flags(cuda, torch_default_flags):
    """Every entry point, called with torch's default flags, gives the
    TF32-off result and leaves the caller's flags as they were. Both sides
    are exact float32 on the same inputs, so the mel and the HiFi-GAN
    waveform are held to 1e-5, well below what TF32 convolutions move them
    by (the spmel mel 2.5e-4 in chip_smoke.py on an H100); the WaveNet
    waveform and logits as the tests above."""
    rng = np.random.RandomState(11)
    mel = rng.rand(2, 64, 80).astype(np.float32)
    emb = rng.randn(2, 256).astype(np.float32)
    specs = [type("Spec", (), dict(src_features=mel[i], src_embedding=emb[i], trg_embedding=emb[1 - i]))
             for i in range(2)]
    converter = Converter(build_generator(device=cuda, seed=5))
    hifigan = HiFiGANVocoder(device=cuda, seed=6)
    wavenet = WaveNetVocoder(WAVENET_TINY, device=cuda, seed=7)
    cfg = Config(train=TrainConfig(batch_size=2, len_crop=64))
    x, e = (v.to(cuda) for v in _small_batch(8))
    wn_mel = torch.from_numpy(mel[:, :2]).to(cuda)
    u = wavenet.uniforms(2, 512, torch.Generator().manual_seed(9))

    def run():
        model = build_generator(cfg.model, device=cuda, seed=4, trainable=True)
        state = TrainState(0, model, make_optimizer(model, cfg), init_ema(model))
        # the eval loss before the step: after it, Adam has turned the
        # rounding-level gradients of the convolutions' biases (zero in exact
        # arithmetic) into updates of either sign
        eval_loss = make_eval_loss(model, cfg)(x, e)["g_loss"]
        train_loss = make_train_step(cfg)(state, x, e)["g_loss"]
        wav = wavenet.generate(wn_mel, uniforms=u)
        return dict(mel=np.stack(converter.convert_batch(specs, batch_size=2)),
                    hifigan=hifigan.generate(mel), wavenet=wav,
                    logits=wavenet.logits(wav[..., None], wn_mel),
                    train=float(train_loss), eval=float(eval_loss))

    got = run()
    assert _flags() == torch_default_flags
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    want = run()
    assert _flags() == (False, False)
    np.testing.assert_allclose(got["mel"], want["mel"], atol=1e-5, rtol=0)
    torch.testing.assert_close(got["hifigan"], want["hifigan"], atol=1e-5, rtol=0)
    assert min(_first_apart(got["wavenet"], want["wavenet"], 1e-4)) >= 32
    torch.testing.assert_close(got["logits"][:, :32], want["logits"][:, :32], atol=1e-4, rtol=0)
    for key in ("train", "eval"):
        assert abs(got[key] - want[key]) <= 1e-5 * abs(want[key]), key


# ------------------------------------------------------ feature extraction

def _mags(seed, t, n_bins):
    """Non-negative magnitudes spanning both clips of the dB step."""
    return (np.random.RandomState(seed).rand(t, n_bins) ** 4 * 200.0).astype(np.float32)


@pytest.mark.parametrize("t, n_bins", [(32 * 513, 513), (1, 513), (1000, 513), (300, 257)])
def test_mel_kernel_matches_plain(cuda, t, n_bins):
    """chip_smoke.py's shapes: 32 utterances of 513 frames, one frame, a
    frame count that is no multiple of the tile, and the 257-bin legacy
    STFT. Tolerance 1e-5: every term of the dot is >= 0, so a reordered f32
    sum moves m by at most ~513 eps relative, ~5e-6 after 20 log10 / 100."""
    mag = torch.from_numpy(_mags(t, t, n_bins)).to(cuda)
    basis = torch.from_numpy(np.ascontiguousarray(mel_filterbank(16_000, 2 * (n_bins - 1), 80))).to(cuda)
    before = mel_ops.launches
    got = mel_ops.mel_normalize(mag, basis)
    torch.cuda.synchronize()
    assert mel_ops.launches == before + 1 and got.shape == (t, 80)
    torch.testing.assert_close(got, mel_ops.mel_normalize_ref(mag, basis), atol=1e-5, rtol=0)


@pytest.mark.parametrize("kind", ["mel", "dense", "gaps"])
def test_mel_kernel_walks_each_filters_span(cuda, kind):
    """The spans the wrapper derives on the card, once per basis, are
    ``filter_spans``'s; a dense basis (513 x 80 weights, staged in groups of
    filters) and one with an empty column and zeros inside a span match the
    plain version (1e-5), and so does a basis edited in place after a call
    (its spans derived anew)."""
    rng = np.random.RandomState(11)
    mag = torch.from_numpy(_mags(12, 300, 513)).to(cuda)
    basis = np.ascontiguousarray(mel_filterbank())
    if kind == "dense":
        basis = rng.rand(513, 80).astype(np.float32) / 40.0
    elif kind == "gaps":
        basis[:, 7] = 0.0
        basis[np.flatnonzero(basis[:, 9])[1:-1], 9] = 0.0
        basis[200:300, 3] = 1e-3
    basis = torch.from_numpy(basis).to(cuda)
    got = mel_ops.mel_normalize(mag, basis)
    assert torch.equal(mel_ops._prepare(basis)[1], mel_ops.filter_spans(basis))
    torch.testing.assert_close(got, mel_ops.mel_normalize_ref(mag, basis), atol=1e-5, rtol=0)
    basis[:, 0] = 0.0
    basis[100:140, 0] = 0.05
    torch.testing.assert_close(mel_ops.mel_normalize(mag, basis), mel_ops.mel_normalize_ref(mag, basis),
                               atol=1e-5, rtol=0)


def test_mel_kernel_refuses_what_it_does_not_take(cuda):
    mag = torch.from_numpy(_mags(1, 40, 513)).to(cuda)
    basis = torch.from_numpy(np.ascontiguousarray(mel_filterbank())).to(cuda)
    with pytest.raises(TypeError, match="float32"):
        mel_ops.mel_normalize(mag.double(), basis.double())
    with pytest.raises(ValueError, match="contiguous"):
        mel_ops.mel_normalize(mag.T.contiguous().T, basis)
    with pytest.raises(ValueError, match="one CUDA device"):
        mel_ops.mel_normalize(mag, basis.cpu())


def _sosfilt_f64(sos, x, zi):
    """scipy's float64 filter of each row, on the float32 inputs as given."""
    sos64 = sos.double().cpu().numpy()
    return np.stack([scipy.signal.sosfilt(sos64, r, zi=z)[0]
                     for r, z in zip(x.double().cpu().numpy(), zi.double().cpu().numpy())])


def assert_sosfilt_gate(got, want, exact, chunk):
    """The kernel's gate, row by row: its first ``chunk`` samples are the
    plain version's bit for bit, and it is no farther from the float64
    filter than twice the plain version's distance plus 1e-6 of the row's
    max-abs (the chunked scan rounds otherwise than the sequential pass)."""
    got, want = got.cpu(), want.cpu()
    assert torch.equal(got[:, :chunk], want[:, :chunk])
    far = np.abs(got.double().numpy() - exact).max(axis=1)
    plain = np.abs(want.double().numpy() - exact).max(axis=1)
    gate = 2 * plain + 1e-6 * np.abs(exact).max(axis=1)
    assert (far <= gate).all(), (far.tolist(), gate.tolist())


@pytest.mark.parametrize("length", [19, 4096, 80_000])
@pytest.mark.parametrize("b", [1, 3, 33])
def test_sosfilt_kernel_matches_plain(cuda, b, length):
    """One pass from a random state; 33 rows take 33 blocks; 19 samples are
    one chunk (the sequential pass), 4096 take 128 chunks of 32 and 80,000
    (a 5-s file) 500 chunks of 160. Held to ``assert_sosfilt_gate``."""
    rng = np.random.RandomState(b * length)
    sos = torch.from_numpy(butter_highpass_sos().astype(np.float32)).to(cuda)
    x = torch.from_numpy(rng.randn(b, length).astype(np.float32)).to(cuda)
    zi = torch.from_numpy((rng.randn(b, 3, 2) * 0.1).astype(np.float32)).to(cuda)
    before = sosfilt_ops.launches
    got = sosfilt_ops.sosfilt(sos, x, zi)
    torch.cuda.synchronize()
    assert sosfilt_ops.launches == before + 1
    want = sosfilt_ops.sosfilt_ref(sos, x, zi)
    assert want.device == got.device
    assert_sosfilt_gate(got, want, _sosfilt_f64(sos, x, zi), sosfilt_ops.scan_plan(length).chunk)
    if length == 19:
        assert torch.equal(got, want)


def test_sosfilt_kernel_reuses_its_tables(cuda):
    """A second call with the same sos values and chunk length makes no new
    tables (no host->device copy), from the same tensor or a fresh one;
    another length makes one entry."""
    sos = torch.from_numpy(butter_highpass_sos().astype(np.float32)).to(cuda)
    x = torch.from_numpy(np.random.RandomState(7).randn(2, 50_000).astype(np.float32)).to(cuda)
    zi = torch.zeros(2, 3, 2, device=cuda)
    sosfilt_ops.sosfilt(sos, x, zi)
    n = len(sosfilt_ops._tables)
    first = sosfilt_ops.sosfilt(sos, x, zi)
    assert len(sosfilt_ops._tables) == n
    sosfilt_ops.sosfilt(sos, x[:, :30_000].contiguous(), zi)
    assert len(sosfilt_ops._tables) == n + 1
    assert torch.equal(sosfilt_ops.sosfilt(sos, x, zi), first)
    assert torch.equal(sosfilt_ops.sosfilt(sos.clone(), x, zi), first)
    assert len(sosfilt_ops._tables) == n + 1


def test_sosfilt_tables_of_a_new_length_need_no_synchronisation(cuda):
    """The front end's sections on the card come with their host copy, so a
    row whose chunk length is met for the first time has its tables made on
    the host and copied to the card without a synchronisation."""
    x = torch.from_numpy(np.random.RandomState(8).randn(1, 61_234).astype(np.float32)).to(cuda)
    sos_filtfilt(butter_highpass_sos(), x[:, :5_000])  # the sections put on the card, once
    n = len(sosfilt_ops._tables)
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = sos_filtfilt(butter_highpass_sos(), x)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert len(sosfilt_ops._tables) <= n + 1 and torch.isfinite(got).all()


def test_sosfilt_kernel_refuses_float64(cuda):
    sos = torch.from_numpy(butter_highpass_sos()).to(cuda)
    x, zi = torch.zeros(2, 100, dtype=torch.float64, device=cuda), torch.zeros(2, 3, 2, dtype=torch.float64,
                                                                                 device=cuda)
    with pytest.raises(TypeError, match="float32"):
        sosfilt_ops.sosfilt(sos, x, zi)


def _voiced(seed, n):
    """A harmonic source with a pitch glide, noise and a silent gap."""
    rng = np.random.RandomState(seed)
    t = np.arange(n) / 16_000.0
    f0 = 120.0 + 30.0 * np.sin(2 * np.pi * 0.7 * t)
    phase = 2 * np.pi * np.cumsum(f0) / 16_000.0
    x = sum(0.3 / k * np.sin(k * phase) for k in range(1, 12)) + 0.003 * rng.randn(n)
    x[n // 3 : n // 3 + 2000] = 0.0
    return x.astype(np.float32)


def _exact_chain(wav, noise, model_type):
    """make_spect's float64 host chain (``--exact``) of each row."""
    b, a = butter_highpass()
    basis = mel_filterbank(dtype=np.float64)
    return np.stack([make_spect.exact_features(x, n.astype(np.float64), model_type, AudioConfig(), b, a, basis)
                     for x, n in zip(wav, noise)])


@pytest.mark.parametrize("model_type", ["spmel", "stft", "legacy", "wav"])
def test_mel_frontend_on_card_matches_cpu(cuda, model_type):
    """The float32 front end on the card (both kernels, cuFFT) against the
    CPU (their plain versions, pocketfft) on two 1.5-s rows with dither.
    After the highpass, the card's filtered rows through the CPU's stages:
    1e-4; 'stft' and 'legacy' 1e-4 in bins within 40 dB of their frame's
    loudest and 10x more for each further 20 dB (two FFTs' rounding,
    relative to the frame's peak, as tests/test_torch_dsp.py holds the port
    to JAX). The whole chain, whose highpass rounds otherwise on the two
    sides (the chunked scan against the sequential pass): the card no
    farther from the float64 chain than the CPU is, plus that tolerance.
    The mel kernel launches once and the filter twice a call."""
    wav = np.stack([_voiced(1, 24_000), _voiced(2, 24_000)])
    noise = ((np.random.RandomState(3).rand(*wav.shape) - 0.5) * 1e-6).astype(np.float32)
    on_card, on_cpu = MelFrontend(device=cuda), MelFrontend(device="cpu")
    before = mel_ops.launches, sosfilt_ops.launches
    got = on_card.extract(model_type, wav, noise)
    torch.cuda.synchronize()
    assert (mel_ops.launches - before[0], sosfilt_ops.launches - before[1]) == (int(model_type == "spmel"), 2)
    assert got.device.type == "cuda" and got.dtype == torch.float32
    got = got.cpu()
    after = on_cpu.from_filtered(model_type, on_card.highpass_dither(wav, noise).cpu())
    tol = torch.full_like(after, 1e-4)
    if model_type in ("stft", "legacy"):
        tol = 1e-4 * 10.0 ** (5.0 * (after.amax(dim=-1, keepdim=True) - after - 0.4).clamp(min=0.0))
    err = (got - after).abs()
    assert bool((err <= tol).all()), (float(err.max()), float((err / tol).max()))
    exact = torch.from_numpy(_exact_chain(wav, noise, model_type)).float()
    cpu = on_cpu.extract(model_type, wav, noise)
    card_far, cpu_far = ((got - exact).abs() / tol).max().item(), ((cpu - exact).abs() / tol).max().item()
    assert card_far <= cpu_far + 1.0, (card_far, cpu_far)


def test_mel_frontend_float64_on_card_raises(cuda):
    with pytest.raises(ValueError, match="CPU only"):
        MelFrontend(dtype=torch.float64, device=cuda)


def test_mel_frontend_ignores_default_tf32_flags(cuda, torch_default_flags):
    """The front end calls no cuDNN and no matmul on the card: torch's
    default flags and both TF32 flags on give the exact-f32 result, 1e-6."""
    wav = _voiced(4, 16_000)
    fe = MelFrontend(device=cuda)
    got = fe.mel_features(wav)
    assert _flags() == torch_default_flags
    torch.backends.cuda.matmul.allow_tf32 = True
    both_on = fe.mel_features(wav)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    want = fe.mel_features(wav)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=0)
    torch.testing.assert_close(both_on, want, atol=1e-6, rtol=0)


def test_make_spect_on_card_matches_exact(cuda, tmp_path):
    """The CLI without --device runs on the card: one mel and two filter
    launches a file, every file within 1e-3 of the --exact host chain (the
    JAX package's bound for its device path, tests/test_cli.py:170-177)."""
    roots = []
    for name in ("card", "exact"):
        root = tmp_path / name
        for s, spk in enumerate(("p301", "p302")):
            os.makedirs(root / "wavs" / spk)
            for u in range(2):
                write_wav(str(root / "wavs" / spk / f"{spk}_{u:03d}.wav"), _voiced(10 * s + u, 12_000 + 4000 * u))
        roots.append(str(root))
    before = mel_ops.launches, sosfilt_ops.launches
    written = make_spect.main(["--main_dir", roots[0]])
    assert (mel_ops.launches - before[0], sosfilt_ops.launches - before[1]) == (4, 8)
    make_spect.main(["--main_dir", roots[1], "--exact"])
    assert len(written) == 4
    for path in written:
        got = np.load(path)
        want = np.load(path.replace(roots[0], roots[1]))
        assert got.dtype == np.float32 and got.shape == want.shape and got.shape[1] == 80
        assert 0.0 <= got.min() and got.max() <= 1.0
        np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)


# ------------------------------------------------------- the speaker encoder

# the d-vector's shapes: make_metadata's single crops (B=1), the evaluation's
# padded window batches (B=8) and the training auxiliary's batch (B=7), at
# the published width (H=768) and the independent judge's (H=256)
DVECTOR_SHAPES = [(1, 128, 768), (8, 128, 768), (7, 128, 768), (8, 128, 256)]


@pytest.mark.parametrize("b, t, hidden", DVECTOR_SHAPES)
def test_lstm_kernels_at_the_dvector_shapes(cuda, b, t, hidden):
    """The forward kernel (inference form) and the backward kernel without
    dW (a frozen w_hh) against the plain versions, within 1e-4 (f32 sums in
    another order); the backward launches no dW."""
    xproj, w_hh, h0, c0, dy, dhn, dcn = (torch.from_numpy(a).to(cuda) for a in _train_inputs(8, b, t, hidden))
    torch.testing.assert_close(lstm_ops.lstm_sequence(xproj, w_hh), lstm_ops.lstm_sequence_ref(xproj, w_hh),
                               atol=1e-4, rtol=0)
    h_seq, c_seq, _, _ = lstm_ops.lstm_sequence_train_ref(xproj, w_hh, h0, c0)
    gates = lstm_ops.lstm_forward_cuda(xproj, w_hh, h0, c0, with_gates=True)[4]
    before = lstm_ops.bwd_launches, lstm_ops.dw_launches
    got = lstm_ops.lstm_backward_cuda(xproj, w_hh, h0, c0, h_seq, c_seq, dy, dhn, dcn, gates=gates, need_dw=False)
    torch.cuda.synchronize()
    assert (lstm_ops.bwd_launches, lstm_ops.dw_launches) == (before[0] + 1, before[1])
    want = lstm_ops.lstm_backward_ref(xproj, w_hh, h0, c0, h_seq, c_seq, dy, dhn, dcn, need_dw=False)
    assert got[1] is None and want[1] is None
    for name, g, w in zip(("dxproj", "dh0", "dc0"), (got[0], got[2], got[3]), (want[0], want[2], want[3])):
        torch.testing.assert_close(g, w, atol=1e-4, rtol=0, msg=name)


# GE2E training: N*M crops of 128 frames (4 speakers x 5) through the
# d-vector with gradients on, at the published width and the independent
# judge's: the backward's first caller with dW at these widths
GE2E_SHAPES = [(20, 128, 768), (20, 128, 256)]


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("b, t, hidden", GE2E_SHAPES)
def test_lstm_training_kernels_with_dw_at_the_ge2e_shapes(cuda, b, t, hidden, reverse):
    """The training forward and the backward with dW (one launch each and
    one dW) against the plain loops: within 1e-4, dW within 1e-4 of its
    largest magnitude."""
    xproj, w_hh, h0, c0, dy, dhn, dcn = (torch.from_numpy(a).to(cuda) for a in _train_inputs(9, b, t, hidden))
    before = lstm_ops.launches, lstm_ops.bwd_launches, lstm_ops.dw_launches
    out = lstm_ops.lstm_forward_cuda(xproj, w_hh, None, None, reverse, with_cseq=True, with_gates=True)
    got = lstm_ops.lstm_backward_cuda(xproj, w_hh, None, None, out[0], out[1], dy, None, None, reverse,
                                      gates=out[4])
    torch.cuda.synchronize()
    assert (lstm_ops.launches, lstm_ops.bwd_launches, lstm_ops.dw_launches) == tuple(n + 1 for n in before)
    want = lstm_ops.lstm_sequence_train_ref(xproj, w_hh, None, None, reverse)
    for g, w in zip(out[:2], want[:2]):
        torch.testing.assert_close(g, w, atol=1e-4, rtol=0)
    _assert_backward_close(got, lstm_ops.lstm_backward_ref(xproj, w_hh, None, None, want[0], want[1], dy, None, None,
                                                           reverse))


@pytest.mark.parametrize("dim_cell", [768, 256])
def test_ge2e_trainer_on_card_matches_the_plain_engine(cuda, dim_cell):
    """``GE2ETrainer``'s loss and gradients on the card (the kernels: 3
    forward, backward and dW launches) against the same trainer on the plain
    loops on the card: the loss within 1e-5 relative; every gradient leaf
    within 1e-4 of its largest magnitude, or, where its float32 sums over
    B*T = 2560 terms cancel below that (a bias of the first layer at H=768:
    1.2e-4 on the card), no farther from the plain loops' float64 step than
    twice the plain float32 step's distance plus 1e-4 (phase 4c's rule);
    then a step, finite."""
    import contextlib
    from unittest import mock

    from autovc_tpu_torch.train.ge2e import GE2ETrainer

    batch = torch.from_numpy(np.random.RandomState(dim_cell).rand(4, 5, 128, 80).astype(np.float32)).to(cuda)
    trainers = [GE2ETrainer(dim_cell=dim_cell, seed=2, device=cuda) for _ in range(3)]
    exact = trainers[2]
    exact.model.double()
    for p in (exact.w, exact.b):
        p.data = p.data.double()
    before = lstm_ops.launches, lstm_ops.bwd_launches, lstm_ops.dw_launches
    losses = []
    for i, tr in enumerate(trainers):
        with mock.patch.object(lstm_ops, "_device_kind", lambda x: "cpu") if i else contextlib.nullcontext():
            loss = tr.loss(batch.to(tr.w.dtype))
            loss.backward()
            losses.append(float(loss.detach()))
    torch.cuda.synchronize()
    assert (lstm_ops.launches, lstm_ops.bwd_launches, lstm_ops.dw_launches) == tuple(n + 3 for n in before)
    assert losses[0] == pytest.approx(losses[1], rel=1e-5)
    for g, p, e in zip(*([q.grad.double() for q in tr.parameters()] for tr in trainers)):
        scale = float(p.abs().max())
        apart, own, from_exact = (float((a - b).abs().max()) / scale for a, b in ((g, p), (p, e), (g, e)))
        assert apart <= 1e-4 or from_exact <= 2 * own + 1e-4, (apart, own, from_exact)
    assert np.isfinite(float(trainers[0].step(batch)))


@pytest.mark.parametrize("dim_cell", [768, 256])
def test_dvector_and_embedder_on_card_match_cpu(cuda, dim_cell):
    """The seeded d-vector (80/dim_cell/256 x3) on the card (the kernels)
    against the CPU (the plain recurrence): unit embeddings at B=1, 7 and 8
    within 1e-4, three launches a forward; the SpeakerEmbedder's embedding
    of a 317-frame utterance (4 windows, padded to 8) within 1e-4."""
    card = build_dvector(device=cuda, seed=4, dim_cell=dim_cell)
    cpu = build_dvector(device="cpu", seed=4, dim_cell=dim_cell)
    rng = np.random.RandomState(dim_cell)
    for b in (1, 7, 8):
        x = torch.from_numpy(rng.rand(b, 128, 80).astype(np.float32))
        before = lstm_ops.launches
        with torch.no_grad():
            got = card(x.to(cuda))
            torch.cuda.synchronize()
            assert lstm_ops.launches == before + 3
            torch.testing.assert_close(got.cpu(), cpu(x), atol=1e-4, rtol=0)
    params = dvector_state_to_jax(cpu.state_dict())
    mel = rng.rand(317, 80).astype(np.float32)
    got = SpeakerEmbedder(params, device=cuda).embed(mel)
    np.testing.assert_allclose(got, SpeakerEmbedder(params, device="cpu").embed(mel), atol=1e-4, rtol=0)


@pytest.mark.parametrize("protocol", ["windowed", "crop"])
def test_speaker_loss_on_card_matches_cpu(cuda, protocol):
    """The full-width generator's loss with the lambda_spk auxiliary (B=2,
    T=160: two windows a row; the 80/256/256 x3 d-vector): the card (the
    kernels) against the CPU on the CPU's side of every kink, the hinge's
    ReLU among them. The loss within 1e-5 relative, each gradient leaf
    within 1e-3 of its ``grad_scale`` (as the full-width train step); the
    frozen d-vector's three backward sequences launch no dW."""
    cfg = Config(train=TrainConfig(batch_size=2, len_crop=160, lambda_spk=1.0, spk_protocol=protocol))
    rng = np.random.RandomState(12)
    x = torch.from_numpy(rng.rand(2, 160, 80).astype(np.float32))
    emb = torch.from_numpy(rng.randn(2, 256).astype(np.float32))
    table = emb / emb.norm(dim=-1, keepdim=True)
    cents = torch.from_numpy(rng.randn(2, 256).astype(np.float32))
    cents = cents / cents.norm(dim=-1, keepdim=True)
    grads, totals = {}, {}
    tape = KinkTape()
    for dev in ("cpu", cuda):
        model = build_generator(cfg.model, device=dev, seed=3, trainable=True)
        dvec = build_dvector(device=dev, seed=5, dim_cell=256)
        tables = (table.to(dev), cents.to(dev)) if protocol == "windowed" else ()
        before = lstm_ops.launches, lstm_ops.bwd_launches, lstm_ops.dw_launches
        with tape.record() if dev == "cpu" else tape.replay():
            total, _ = loss_fn(model, cfg, x.to(dev), emb.to(dev), spk=SpeakerAux(dvec, *tables))
            total.backward()
        if dev != "cpu":
            torch.cuda.synchronize()
            # 7 eval-mode sequences for the conversion, 11 in training form, 3 of the d-vector
            assert (lstm_ops.launches, lstm_ops.bwd_launches, lstm_ops.dw_launches) == (
                before[0] + 21, before[1] + 21, before[2] + 18)
        totals[str(dev)] = float(total)
        grads[str(dev)] = {n: p.grad.double().cpu() for n, p in model.named_parameters()}
    assert abs(totals["cuda"] - totals["cpu"]) <= 1e-5 * abs(totals["cpu"])
    for n, g in grads["cuda"].items():
        apart = float((g - grads["cpu"][n]).abs().max()) / grad_scale(n, grads["cpu"])
        assert apart <= 1e-3, f"{n}: the card's gradient {apart:.3e} of its scale from the CPU's"


# -------------------------------------------------- bfloat16 inference paths

BF = torch.bfloat16


def _bf16_close(got, want, max_ulps=1.0, equal_share=0.99, floor=2.0 ** -16):
    """The bfloat16 kernels against their plain versions (the same rounding
    points, float32 sums in another order): every element within 1
    bfloat16 ulp of the plain one (of ``floor`` times its largest magnitude
    where it is smaller: two float32 sums that cancel differ by more than the
    element's own ulp; an all-zero want met exactly), and at least 99%
    bit-equal."""
    assert got.dtype == want.dtype == BF
    g, w = got.double(), want.double()
    if w.abs().max().item() == 0:
        assert torch.equal(g, w)
        return
    ulps = _bf16_ulps(got, want, floor)
    equal = (g == w).double().mean().item()
    assert ulps <= max_ulps and equal >= equal_share, (ulps, equal)


def _bf16_ulps(got, want, floor=2.0 ** -16) -> float:
    """The largest |got - want| in bfloat16 ulps of want (of ``floor``
    times want's largest magnitude where want is smaller)."""
    g, w = got.double(), want.double()
    scale = torch.clamp(w.abs(), min=floor * w.abs().max().item())
    # the exponent by frexp, exact (log2 on the card may round 2^k below k)
    return ((g - w).abs() / torch.ldexp(torch.ones_like(scale), torch.frexp(scale).exponent - 8)).max().item()


def _bf16_inputs(seed, b, t, hidden, device):
    x, w = (torch.from_numpy(a).to(device).to(BF) for a in _inputs(seed, b, t, hidden))
    return x, w


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("b, t, hidden, regime", [(32, 64, 32, "a"), (1, 5, 8, "a"), (37, 20, 64, "a"),
                                                  (7, 24, 160, "a"), (7, 24, 168, "b"), (32, 64, 512, "b"),
                                                  (32, 64, 1024, "b"), (64, 16, 768, "b"), (7, 1, 1024, "b"),
                                                  (1, 1, 256, "b")])
def test_lstm_bf16_kernel_matches_plain(cuda, b, t, hidden, regime, reverse):
    """The forward kernel's bfloat16 form against the plain loop in
    bfloat16 (float32 carry, the sequence rounded): regime (a) up to H=160
    (w_hh in bfloat16 halves its shared bytes), regime (b) above, one launch
    a sequence, counted as a bfloat16 launch."""
    x, w = _bf16_inputs(21, b, t, hidden, cuda)
    before = lstm_ops.launches, lstm_ops.bf16_launches
    got = lstm_ops.lstm_sequence(x, w, reverse)
    torch.cuda.synchronize()
    assert (lstm_ops.launches, lstm_ops.bf16_launches) == (before[0] + 1, before[1] + 1)
    assert lstm_ops.last_launch["fwd"][0].regime == regime
    _bf16_close(got, lstm_ops.lstm_sequence_ref(x, w, reverse))


def test_lstm_bf16_regime_b_carries_h_in_float32(cuda):
    """H=1024 (regime b, 128 blocks meeting at a grid barrier each step),
    T=1024: the kernel holds to the plain loop's float32 carry, and a loop
    that rounds the carry to bfloat16 each step, as reading h back from the
    bfloat16 h_seq would, fails the same check."""
    x, w = _bf16_inputs(22, 8, 1024, 1024, cuda)
    got = lstm_ops.lstm_sequence(x, w)
    torch.cuda.synchronize()
    assert lstm_ops.last_launch["fwd"][0].regime == "b"
    _bf16_close(got, lstm_ops.lstm_sequence_ref(x, w))
    wf = w.float()
    h = c = torch.zeros((8, 1024), device=cuda)
    rounded = []
    for step in range(1024):
        i, f, g, o = (x[:, step].float() + h @ wf).split(1024, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = (torch.sigmoid(o) * torch.tanh(c)).to(BF).float()
        rounded.append(h)
    with pytest.raises(AssertionError):
        _bf16_close(got, torch.stack(rounded, dim=1).to(BF))


def test_lstm_bf16_steps_sharing_a_line(cuda, grid_plan_at_small_h):
    """B=1, H=8, T=64 in regime (b) at one unit a block and K chunks of 4
    floats: every step stages h_{t-1} from the float32 exchange buffer that
    other blocks wrote just before the barrier."""
    x, w = _bf16_inputs(23, 1, 64, 8, cuda)
    for reverse in (False, True):
        got = lstm_ops.lstm_sequence(x, w, reverse)
        torch.cuda.synchronize()
        assert lstm_ops.last_launch["fwd"][0].regime == "b"
        _bf16_close(got, lstm_ops.lstm_sequence_ref(x, w, reverse))


def test_lstm_bf16_refuses_what_it_does_not_take(cuda):
    """Mixed xproj and w_hh dtypes raise a TypeError, as does a float32
    operand where the bfloat16 form takes bfloat16 (dy) or a bfloat16 one
    where it takes float32 (the gate gradients of dW, the initial state);
    the bfloat16 forward keeps no gate activations; the gates kernel takes
    only the bfloat16 form. Nothing is launched."""
    x, w = _bf16_inputs(24, 2, 3, 8, cuda)
    before = lstm_ops.launches, lstm_ops.bwd_launches, lstm_ops.dw_launches, lstm_ops.gates_launches
    with pytest.raises(TypeError, match="mixed"):
        lstm_ops.lstm_sequence(x, w.float())
    with pytest.raises(TypeError, match="mixed"):
        lstm_ops.lstm_sequence(x.float(), w)
    with pytest.raises(ValueError, match="gate activations"):
        lstm_ops.lstm_forward_cuda(x, w, with_cseq=True, with_gates=True)
    with pytest.raises(TypeError, match="h0"):
        lstm_ops.lstm_forward_cuda(x, w, h0=torch.zeros((2, 8), device=cuda, dtype=BF))
    h = torch.zeros((2, 3, 8), device=cuda, dtype=BF)
    act = torch.zeros((2, 3, 32), device=cuda)
    with pytest.raises(TypeError, match="dy"):
        lstm_ops.lstm_backward_cuda(x, w, None, None, h, h.float(), h.float(), gates=act)
    with pytest.raises(TypeError, match="dgates"):
        lstm_ops.lstm_weight_grad_cuda(h, None, x)
    with pytest.raises(TypeError, match="bfloat16 form"):
        lstm_ops.lstm_gates_cuda(x.float(), w.float(), None, h.float())
    assert (lstm_ops.launches, lstm_ops.bwd_launches, lstm_ops.dw_launches, lstm_ops.gates_launches) == before


# the bfloat16 WaveNet kernel's gates: 4x the plain bfloat16 loop's own
# spread measured on an H100 (its teacher-forced logits 2.6e-4 at full
# width, 5.7e-4 at the tiny width; its first 32 samples against the same
# loop summing in another order 1.2e-4), and no tighter than the float32
# gates
WN_BF16_TF_TOL, WN_BF16_PREFIX_TOL = 2.5e-3, 5e-4


def _wavenet_bf16_check(voc, mel, cond, u, cfg, plain_t=None):
    """One bfloat16 generate call against the plain loop (over its first
    ``plain_t`` samples) and the teacher-forced bfloat16 forward; returns
    the waveform."""
    packed = voc.packed_for(BF)
    assert packed["w3"].dtype == BF and packed["bg"].dtype == torch.float32
    before = wavenet_ops.launches, wavenet_ops.bf16_launches
    y, logits = wavenet_ops.generate(packed, cfg.dilations(), cond, u, cfg.log_scale_min)
    torch.cuda.synchronize()
    assert (wavenet_ops.launches, wavenet_ops.bf16_launches) == (before[0] + 1, before[1] + 1)
    assert wavenet_ops.last_cuda_launches == 1
    assert bool(torch.isfinite(y).all()) and float(y.abs().max()) <= 1.0
    n = plain_t or y.shape[1]
    y_ref, _ = wavenet_ops.generate_ref(packed, cfg.dilations(), cond[:, :n].contiguous(), u[:, :n].contiguous(),
                                        cfg.log_scale_min)
    assert min(_first_apart(y[:, :n], y_ref, WN_BF16_PREFIX_TOL)) >= 32
    torch.testing.assert_close(logits, voc.logits(y[..., None], mel, BF), atol=WN_BF16_TF_TOL, rtol=0)
    return y


def _wavenet_scan_check(voc, mel, cond, u, cfg, plain_t=None):
    """One generate call in the scan rounding against the plain scan loop
    (over its first ``plain_t`` samples) and the teacher-forced forward in
    the same rounding, at the bfloat16 form's gates; returns the waveform."""
    packed = voc.packed_for(BF)
    before = wavenet_ops.launches, wavenet_ops.scan_launches, wavenet_ops.bf16_launches
    y, logits = wavenet_ops.generate(packed, cfg.dilations(), cond, u, cfg.log_scale_min, scan=True)
    torch.cuda.synchronize()
    assert (wavenet_ops.launches, wavenet_ops.scan_launches, wavenet_ops.bf16_launches) == (
        before[0] + 1, before[1] + 1, before[2])
    assert wavenet_ops.last_cuda_launches == 1
    assert bool(torch.isfinite(y).all()) and float(y.abs().max()) <= 1.0
    n = plain_t or y.shape[1]
    y_ref, _ = wavenet_ops.generate_ref(packed, cfg.dilations(), cond[:, :n].contiguous(), u[:, :n].contiguous(),
                                        cfg.log_scale_min, scan=True)
    assert min(_first_apart(y[:, :n], y_ref, WN_BF16_PREFIX_TOL)) >= 32
    torch.testing.assert_close(logits, voc.logits(y[..., None], mel, BF, scan=True), atol=WN_BF16_TF_TOL, rtol=0)
    return y


@pytest.mark.parametrize("b", [1, 3, 8])
@pytest.mark.parametrize("width", ["tiny", "full"])
def test_wavenet_scan_kernel_matches_plain(cuda, width, b):
    """The scan rounding's form (bfloat16 weights, biases, first conv, h and
    skip sum, every op rounded; four reductions a gate) against the plain
    scan loop on the same uniforms: the first 32 samples within 5e-4, the
    logits within 2.5e-3 of the teacher-forced scan forward on the kernel's
    own waveform (the bfloat16 form's gates); a second call the same
    waveform bit for bit; the Pallas rounding's form another waveform."""
    cfg, frames = (WAVENET_TINY, 4) if width == "tiny" else (WaveNetConfig(), 2)
    voc, mel, cond, u = _wavenet_case(cuda, cfg, b, frames, seed=50 + b)
    with torch.inference_mode():
        y = _wavenet_scan_check(voc, mel, cond, u, cfg, plain_t=None if width == "tiny" else 128)
        y2, _ = wavenet_ops.generate(voc.packed_for(BF), cfg.dilations(), cond, u, cfg.log_scale_min, scan=True)
        pallas, _ = wavenet_ops.generate(voc.packed_for(BF), cfg.dilations(), cond, u, cfg.log_scale_min)
    assert torch.equal(y, y2) and not torch.equal(y, pallas)


@pytest.mark.parametrize("b", [1, 3, 8])
@pytest.mark.parametrize("width", ["tiny", "full"])
def test_wavenet_bf16_kernel_matches_plain(cuda, width, b):
    """The bfloat16 form (bfloat16 weights and rings, float32 biases,
    accumulators and head; two grid barriers a layer) against the plain
    bfloat16 loop on the same uniforms: the first 32 samples within 5e-4,
    the logits within 2.5e-3 of the teacher-forced bfloat16 forward on the
    kernel's own waveform; a second call the same waveform bit for bit."""
    cfg, frames = (WAVENET_TINY, 4) if width == "tiny" else (WaveNetConfig(), 2)
    voc, mel, cond, u = _wavenet_case(cuda, cfg, b, frames, seed=30 + b)
    with torch.inference_mode():
        y = _wavenet_bf16_check(voc, mel, cond, u, cfg)
        y2, _ = wavenet_ops.generate(voc.packed_for(BF), cfg.dilations(), cond, u, cfg.log_scale_min)
    assert torch.equal(y, y2)
    assert wavenet_ops.last_launch[0] == wavenet_ops.generate_plan(b, (cfg.residual_channels, cfg.gate_channels,
                                                                       cfg.skip_channels, cfg.cin_channels,
                                                                       cfg.out_channels),
                                                                  wavenet_ops._card_sms(0), 2)


def test_wavenet_bf16_kernel_full_width_batch_32(cuda):
    """B=32 at full width: one pass of four n8 tiles in each phase; the
    plain loop over the first 64 samples."""
    cfg = WaveNetConfig()
    voc, mel, cond, u = _wavenet_case(cuda, cfg, 32, 2, seed=40)
    with torch.inference_mode():
        _wavenet_bf16_check(voc, mel, cond, u, cfg, plain_t=64)
    assert wavenet_ops.last_launch[0].rows == 32


def test_wavenet_scan_kernel_full_width_batch_32(cuda):
    """The scan rounding's form at B=32, full width: one pass of four n8
    tiles; the plain scan loop over the first 64 samples."""
    cfg = WaveNetConfig()
    voc, mel, cond, u = _wavenet_case(cuda, cfg, 32, 2, seed=42)
    with torch.inference_mode():
        _wavenet_scan_check(voc, mel, cond, u, cfg, plain_t=64)
    assert wavenet_ops.last_launch[0].rows == 32


_WN_CHECKS = {"pallas": _wavenet_bf16_check, "scan": _wavenet_scan_check}


@pytest.mark.parametrize("engine", ["pallas", "scan"])
@pytest.mark.parametrize("b, rows, passes", [(16, 16, 1), (64, 32, 2), (512, 32, 16)])
def test_wavenet_bf16_kernels_full_width_batch_in_passes(cuda, engine, b, rows, passes):
    """Both bfloat16 forms at full width where the plan takes two n8 tiles
    in one pass (B=16), and in several passes (B=64, B=512: cond_t copied
    by each pass, the blocks' h and skip columns in device memory, the next
    gate's ring rows not copied ahead): the plain loop over the first 32
    samples (64 at B <= 64), the teacher-forced logits, the same gates."""
    cfg = WaveNetConfig()
    voc, mel, cond, u = _wavenet_case(cuda, cfg, b, 1, seed=60 + b)
    with torch.inference_mode():
        _WN_CHECKS[engine](voc, mel, cond, u, cfg, plain_t=64 if b <= 64 else 32)
    plan = wavenet_ops.last_launch[0]
    assert (plan.rows, -(-b // plan.rows)) == (rows, passes)


@pytest.mark.parametrize("engine", ["pallas", "scan"])
@pytest.mark.parametrize("b, rows", [(20, 8), (40, 16)])
def test_wavenet_bf16_kernels_with_forced_smaller_passes(cuda, monkeypatch, engine, b, rows):
    """Both bfloat16 forms at full width under the card's plan with its
    passes forced to 8 or 16 rows: three passes, the last one part empty."""
    cfg = WaveNetConfig()
    widths = (cfg.residual_channels, cfg.gate_channels, cfg.skip_channels, cfg.cin_channels, cfg.out_channels)
    plan = wavenet_ops.generate_plan(b, widths, wavenet_ops._card_sms(0), 2)
    plan = dataclasses.replace(plan, rows=rows, smem=wavenet_ops.bf16_smem(b, widths, rows, plan.head_cols, plan.depth))
    monkeypatch.setattr(wavenet_ops, "_plan_on_card", lambda b, w, device, esize=4: plan)
    voc, mel, cond, u = _wavenet_case(cuda, cfg, b, 1, seed=70 + b)
    with torch.inference_mode():
        _WN_CHECKS[engine](voc, mel, cond, u, cfg, plain_t=64)
    assert wavenet_ops.last_launch[0] == plan


def _forced_bf16_plan(monkeypatch, batch: int, widths: tuple) -> wavenet_ops.GeneratePlan:
    """A forced plan of 100 blocks (98 of them owning no column at the tiny
    width) with weight rings of 1 slot, so that each slot takes every
    layer's slice in turn."""
    plan = wavenet_ops.GeneratePlan(100, 8, 16, 1, 1, wavenet_ops.bf16_smem(batch, widths, 8, 1, 1), rows=8)
    monkeypatch.setattr(wavenet_ops, "_plan_on_card", lambda b, w, device, esize=4: plan)
    return plan


def test_wavenet_bf16_kernel_with_blocks_that_own_nothing(cuda, monkeypatch):
    """The bfloat16 form under a forced plan of 100 blocks at the tiny
    width, 98 of them owning no column."""
    plan = _forced_bf16_plan(monkeypatch, 3, (16, 16, 8, 80, 12))
    voc, mel, cond, u = _wavenet_case(cuda, WAVENET_TINY, 3, 2, seed=41)
    with torch.inference_mode():
        _wavenet_bf16_check(voc, mel, cond, u, WAVENET_TINY)
    assert wavenet_ops.last_launch[0] == plan


def test_wavenet_scan_kernel_with_blocks_that_own_nothing(cuda, monkeypatch):
    """The scan rounding's form under the same forced plan."""
    plan = _forced_bf16_plan(monkeypatch, 3, (16, 16, 8, 80, 12))
    voc, mel, cond, u = _wavenet_case(cuda, WAVENET_TINY, 3, 2, seed=43)
    with torch.inference_mode():
        _wavenet_scan_check(voc, mel, cond, u, WAVENET_TINY)
    assert wavenet_ops.last_launch[0] == plan


@pytest.mark.parametrize("engine", ["scan", "pallas"])
def test_wavenet_bf16_vocoder_on_card_matches_cpu(cuda, engine):
    """generate(dtype=bfloat16) with each engine's rounding on the card and
    on the CPU, the seeded vocoder's default stream: the same waveform over
    32 samples."""
    mel = np.random.RandomState(42).rand(2, 1, 80).astype(np.float32)
    on_card = WaveNetVocoder(WAVENET_TINY, device=cuda, seed=4).generate(mel, dtype=BF, engine=engine)
    on_cpu = WaveNetVocoder(WAVENET_TINY, device="cpu", seed=4).generate(mel, dtype=BF, engine=engine)
    assert min(_first_apart(on_card.cpu(), on_cpu, WN_BF16_PREFIX_TOL)) >= 32


def _deltas(a, b):
    d = (a.double().cpu() - b.double().cpu()).abs()
    return d.max().item(), d.mean().item()


def test_bf16_generator_and_hifigan_on_card_match_cpu(cuda):
    """The seeded full-width Generator with compute_dtype bfloat16 (7
    bfloat16 kernel launches) and HiFi-GAN with bfloat16 parameters, on the
    card: no farther from the CPU's float32 outputs than 1.25x the CPU's
    own bfloat16 outputs are, in max and mean (the rule the CPU tests hold
    the port to against JAX)."""
    from autovc_tpu_torch.config import ModelConfig

    rng = np.random.RandomState(43)
    x = torch.from_numpy(rng.rand(2, 64, 80).astype(np.float32))
    e = torch.from_numpy(rng.randn(2, 256).astype(np.float32))
    outs = {}
    for dev, dtype in (("cpu", "float32"), ("cpu", "bfloat16"), (cuda, "bfloat16")):
        gen = build_generator(ModelConfig(compute_dtype=dtype, use_pallas_lstm=True), device=dev, seed=8)
        voc = HiFiGANVocoder(device=dev, seed=9, dtype=BF if dtype == "bfloat16" else torch.float32)
        before = lstm_ops.bf16_launches
        with torch.inference_mode():
            mel = gen(x.to(dev), e.to(dev), e.to(dev))[1]
        if dev != "cpu":
            torch.cuda.synchronize()
            assert lstm_ops.bf16_launches == before + 7 and mel.dtype == BF
        outs[(str(dev), dtype)] = (mel.float(), voc.generate(x[:, :8].numpy()))
    ref, cpu_bf, card_bf = outs[("cpu", "float32")], outs[("cpu", "bfloat16")], outs[("cuda", "bfloat16")]
    for i in range(2):
        cpu_max, cpu_mean = _deltas(cpu_bf[i], ref[i])
        card_max, card_mean = _deltas(card_bf[i], ref[i])
        assert card_max <= 1.25 * cpu_max and card_mean <= 1.25 * cpu_mean, (i, card_max, cpu_max, card_mean,
                                                                             cpu_mean)


def test_bf16_entry_points_ignore_default_flags(cuda, torch_default_flags):
    """The bfloat16 conversion, HiFi-GAN and WaveNet called under torch's
    default flags (TF32 convolutions, bfloat16 reductions in cuBLAS) give
    the same outputs bit for bit as under exact flags: the entry points
    set their own, and restore the caller's."""
    from autovc_tpu_torch.config import ModelConfig

    rng = np.random.RandomState(44)
    mel = rng.rand(2, 64, 80).astype(np.float32)
    emb = rng.randn(2, 256).astype(np.float32)
    specs = [type("Spec", (), dict(src_features=mel[i], src_embedding=emb[i], trg_embedding=emb[1 - i]))
             for i in range(2)]
    converter = Converter(build_generator(ModelConfig(compute_dtype="bfloat16", use_pallas_lstm=True), device=cuda,
                                          seed=5))
    hifigan = HiFiGANVocoder(device=cuda, seed=6, dtype=BF)
    wavenet = WaveNetVocoder(WAVENET_TINY, device=cuda, seed=7)
    u = wavenet.uniforms(2, 512, torch.Generator().manual_seed(9))
    matmul = torch.backends.cuda.matmul

    def run():
        return (np.stack(converter.convert_batch(specs, batch_size=2)), hifigan.generate(mel[:, :8]),
                wavenet.generate(mel[:, :2], uniforms=u, dtype=BF))

    saved = matmul.allow_bf16_reduced_precision_reduction
    matmul.allow_bf16_reduced_precision_reduction = True
    try:
        got = run()
        assert _flags() == torch_default_flags and matmul.allow_bf16_reduced_precision_reduction
        torch.backends.cudnn.allow_tf32 = matmul.allow_tf32 = matmul.allow_bf16_reduced_precision_reduction = False
        want = run()
    finally:
        matmul.allow_bf16_reduced_precision_reduction = saved
    np.testing.assert_array_equal(got[0], want[0])
    for g, w in zip(got[1:], want[1:]):
        assert torch.equal(g, w)


# --------------------------------------------------- bfloat16 training paths

BF16_TRAIN_SHAPES = [(7, 128, 32), (7, 128, 512), (7, 64, 1024), (37, 20, 64), (1, 5, 8), (7, 24, 160),
                     (7, 24, 168), (64, 16, 768), (7, 1, 1024), (1, 1, 32)]
GATES_TOL = 1e-5  # float32 activations of a sum of H exact bfloat16 products, in another order
# The backward's float32 sums (dh's carry over 4H terms, dW over K = B*T
# rows) in another order differ by about sqrt(K) * 2^-24 of the peak (2^-17.5
# at K = 8192, a bfloat16 ulp of an element at 2^-10 of the peak; measured
# on an H100: 2 ulps of 2^-10 of the peak, 12 of 2^-16): the ulp of an
# element below 2^-8 of the peak is that of 2^-8 of the peak
# (tests/test_torch_bf16_train.py's BWD_FLOOR).
BWD_FLOOR = 2.0 ** -8


def _bf16_train_inputs(seed, b, t, hidden, device):
    """The training inputs of the bfloat16 form: xproj, w_hh and dy in
    bfloat16; the state and the cotangents of hN and cN in float32."""
    xproj, w_hh, h0, c0, dy, dhn, dcn = (torch.from_numpy(a).to(device) for a in _train_inputs(seed, b, t, hidden))
    return xproj.to(BF), w_hh.to(BF), h0, c0, dy.to(BF), dhn, dcn


def _assert_bf16_backward_close(got, want):
    """dxproj and dW in bfloat16 within 1 ulp (floor BWD_FLOOR), 99%
    bit-equal (``_bf16_close``); dh0 and dc0 in float32 at the float32
    kernels' 1e-4."""
    _bf16_close(got[0], want[0], floor=BWD_FLOOR)
    if want[1] is not None:
        _bf16_close(got[1], want[1], floor=BWD_FLOOR)
    for g, w in zip(got[2:], want[2:]):
        assert g.dtype == w.dtype == torch.float32
        torch.testing.assert_close(g, w, atol=1e-4, rtol=0)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("b, t, hidden", BF16_TRAIN_SHAPES)
def test_lstm_bf16_train_forward_matches_plain(cuda, b, t, hidden, reverse):
    """The forward's bfloat16 training form (a float32 h0 and c0 in; the
    bfloat16 h_seq, the float32 c_seq, hN and cN out) against the plain
    loop: h_seq by ``_bf16_close``, the float32 state within 1e-4; regime
    (a) up to H=160, (b) above; one launch, counted as a bfloat16 one."""
    x, w, h0, c0 = _bf16_train_inputs(31, b, t, hidden, cuda)[:4]
    before = lstm_ops.launches, lstm_ops.bf16_launches
    got = lstm_ops.lstm_forward_cuda(x, w, h0, c0, reverse, with_cseq=True)
    torch.cuda.synchronize()
    assert (lstm_ops.launches, lstm_ops.bf16_launches) == (before[0] + 1, before[1] + 1)
    want = lstm_ops.lstm_sequence_train_ref(x, w, h0, c0, reverse)
    _bf16_close(got[0], want[0])
    for g, wv in zip(got[1:], want[1:], strict=True):
        assert g.dtype == torch.float32
        torch.testing.assert_close(g, wv, atol=1e-4, rtol=0)


@pytest.mark.parametrize("h0_kind", ["zero", "nonzero"])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("b, t, hidden", [(7, 128, 32), (7, 128, 512), (7, 128, 1024), (37, 20, 64), (1, 5, 8),
                                          (3, 70, 104), (1, 1, 32)])
def test_lstm_gates_kernel_matches_plain(cuda, b, t, hidden, reverse, h0_kind):
    """The gate activations recomputed from a bfloat16 h_seq (the tensor
    cores' product of exact bfloat16 operands, summed in float32) against
    ``lstm_gates_ref`` within GATES_TOL; a float32 h0 at the sequence's
    first step (added in float32 FMAs); tiles past M = B*T and past 4H (H=104:
    4H = 416 is 6.5 tiles of 64, K = 104 three chunks of 32 and a part)."""
    x, w, h0 = _bf16_train_inputs(32, b, t, hidden, cuda)[:3]
    h0 = None if h0_kind == "zero" else h0
    h_seq = lstm_ops.lstm_sequence_train_ref(x, w, h0, None, reverse)[0]
    before = lstm_ops.gates_launches
    got = lstm_ops.lstm_gates_cuda(x, w, h0, h_seq, reverse)
    torch.cuda.synchronize()
    assert lstm_ops.gates_launches == before + 1 and got.dtype == torch.float32
    torch.testing.assert_close(got, lstm_ops.lstm_gates_ref(x, w, h0, h_seq, reverse), atol=GATES_TOL, rtol=0)


@pytest.mark.parametrize("h0_kind", ["zero", "nonzero"])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("t", [1, 127, 128, 200])
@pytest.mark.parametrize("b", [1, 7])
@pytest.mark.parametrize("hidden", [32, 256, 512, 768, 1024])
def test_lstm_gates_kernel_tiles(cuda, hidden, b, t, reverse, h0_kind):
    """The gates kernel's TMA boxes and wgmma tiles (``ops.lstm.gates_plan``:
    128 steps of one batch row by 128 or 256 columns) against
    ``lstm_gates_ref`` within GATES_TOL: a sequence shorter than a tile
    (T=1, 127), exactly one (128), a tile and a part (200); one batch row
    and seven; the box one step off zero-filled at either end; both tile
    widths (H=1024 at B=7 is 128 x 256)."""
    x, w, h0 = _bf16_train_inputs(33, b, t, hidden, cuda)[:3]
    h0 = None if h0_kind == "zero" else h0
    h_seq = lstm_ops.lstm_sequence_train_ref(x, w, h0, None, reverse)[0]
    before = lstm_ops.gates_launches
    got = lstm_ops.lstm_gates_cuda(x, w, h0, h_seq, reverse)
    torch.cuda.synchronize()
    assert lstm_ops.gates_launches == before + 1
    torch.testing.assert_close(got, lstm_ops.lstm_gates_ref(x, w, h0, h_seq, reverse), atol=GATES_TOL, rtol=0)


def test_lstm_gates_kernel_raises_for_what_tma_refuses(cuda):
    """H % 8 != 0 (TMA's 16-byte strides) is launched at the padded width
    (``pad_hidden``: 12 -> 16) and stripped, one launch; a misaligned view
    is copied to an aligned one first (``_dense``), and the kernel itself
    refuses misaligned pointers and a tile width it has no form for."""
    x, w = _bf16_inputs(34, 2, 6, 12, cuda)
    h_seq = lstm_ops.lstm_sequence_ref(x, w)
    before = lstm_ops.gates_launches
    got = lstm_ops.lstm_gates_cuda(x, w, None, h_seq)
    assert lstm_ops.gates_launches == before + 1 and got.shape == (2, 6, 48)
    torch.testing.assert_close(got, lstm_ops.lstm_gates_ref(x, w, None, h_seq), atol=GATES_TOL, rtol=0)
    x, w = _bf16_inputs(35, 2, 6, 16, cuda)
    h_seq = lstm_ops.lstm_sequence_ref(x, w)
    shifted = torch.empty(x.numel() + 1, device=cuda, dtype=BF)[1:].view_as(x)
    shifted.copy_(x)
    assert shifted.data_ptr() % 16
    torch.testing.assert_close(lstm_ops.lstm_gates_cuda(shifted, w, None, h_seq),
                               lstm_ops.lstm_gates_ref(x, w, None, h_seq), atol=GATES_TOL, rtol=0)
    lib = lstm_ops._library("lstm_gates")
    act = torch.empty((2, 6, 64), device=cuda)
    stream = torch.cuda.current_stream().cuda_stream
    for nsub, hp in ((1, h_seq.data_ptr() + 2), (3, h_seq.data_ptr())):
        err = lib.autovc_lstm_gates(x.data_ptr(), w.data_ptr(), None, hp, act.data_ptr(), 2, 6, 16, 0, nsub, stream)
        assert err == lstm_ops._ERR_PLAN


# The scan rounding's kernels (the d-vector's bfloat16 form) against their
# plain loops on the card. The plain loop's own spread is its distance from
# itself with the hidden units relabelled in RELABELLINGS ways (the same
# network, its sums in another order). The first SCAN_STEPS steps each
# direction takes: >= 99% bit-equal and within 1 bfloat16 ulp (floored at
# 2^-16 of the peak for the forward, at BWD_FLOOR for the backward), or
# within the plain loop's own largest ulps there where those are more: a
# bfloat16 carry keeps a flip, and each op after it rounds again, so an
# element near zero inherits its inputs' absolute error (H100, 700 W: the
# forward 21.5 ulps at H=768 reverse, 1.3e-6 of an element near zero; the
# backward 2 ulps). The whole sequence within SPREAD_MULT times the plain
# loop's own spread: at B=1 a flip in the carry happens in few orders of the
# sums (H100, 700 W: 1 in 32 at H=768 reverse), so the spread takes 32.
SCAN_STEPS, SPREAD_MULT, RELABELLINGS = 16, 2.0, 32
SCAN_SHAPES = [(7, 128, 32), (1, 128, 256), (7, 128, 256), (8, 128, 768), (7, 128, 768),
               # the Generator's training sequences; a regime (a) of two blocks and a k16 tail; two batch
               # tiles of 16 rows; a K of 2.5 swizzle atoms with a k16 tail
               (7, 128, 512), (7, 128, 1024), (11, 40, 24), (20, 48, 64), (3, 40, 40)]


def _scan_plain(x, w, dy, reverse, perm=None):
    """The plain scan forward (h_seq, c_seq, act) and backward (dxproj), with
    the hidden units relabelled by ``perm`` (and back) when given."""
    if perm is not None:
        cols = torch.cat([perm + g * len(perm) for g in range(4)])
        x, w, dy = x[..., cols], w[perm][:, cols], dy[..., perm]
    h_seq, c_seq, act, _, _ = lstm_ops.lstm_scan_bf16_train_ref(x, w, reverse=reverse)
    dx = lstm_ops.lstm_scan_bf16_backward_ref(w, act, c_seq, None, dy, reverse=reverse)[0]
    if perm is not None:
        inv = torch.argsort(perm)
        inv4 = torch.cat([inv + g * len(inv) for g in range(4)])
        h_seq, c_seq, act, dx = h_seq[..., inv], c_seq[..., inv], act[..., inv4], dx[..., inv4]
    return h_seq, c_seq, act, dx


def _scan_inputs(seed, b, t, hidden, device):
    x, w = _bf16_inputs(seed, b, t, hidden, device)
    dy = torch.from_numpy(np.random.RandomState(seed + 1).randn(b, t, hidden).astype(np.float32)).to(device).to(BF)
    return x, w, dy


def _hold_scan(got, want, others, first, floor, own_equal=False):
    """The first steps within 1 ulp, or the relabelled plain loops' (``others``)
    largest ulps there, and 99% bit-equal (with ``own_equal``, as past the
    package's widest H=1024, or the relabelled loops' own least share there);
    the sequence within SPREAD_MULT times their largest distance from
    ``want``."""
    own_ulps = max(_bf16_ulps(o[:, first], want[:, first], floor) for o in others)
    share = 0.99
    if own_equal:
        share = min([share] + [float((o[:, first].double() == want[:, first].double()).double().mean())
                               for o in others])
    _bf16_close(got[:, first], want[:, first], max_ulps=max(1.0, own_ulps), equal_share=share, floor=floor)
    spread = max(float((o.float() - want.float()).abs().max()) for o in others)
    apart = float((got.float() - want.float()).abs().max())
    assert apart <= SPREAD_MULT * spread, (apart, spread)
    return apart, spread, own_ulps


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("b, t, hidden", SCAN_SHAPES)
def test_lstm_scan_kernels_match_plain(cuda, b, t, hidden, reverse):
    """The forward's scan form (regime (a) at H=32, (b) at the d-vector's
    256 and 768) and the backward's (no dW) against
    ``lstm_scan_bf16_train_ref`` and ``lstm_scan_bf16_backward_ref``; the
    backward on the plain forward's residuals, so that each kernel is held
    alone. The residuals c_seq and act within the same rule."""
    x, w, dy = _scan_inputs(36, b, t, hidden, cuda)
    plan = lstm_ops.scan_plan(b, hidden, lstm_ops._card_sms(0))
    assert plan.regime == ("a" if hidden <= 32 else "b")
    before = [lstm_ops.launches, lstm_ops.scan_launches, lstm_ops.bwd_launches, lstm_ops.scan_bwd_launches,
              lstm_ops.bf16_launches, lstm_ops.dw_launches]
    h_seq, c_seq, act, hn, cn = lstm_ops.lstm_scan_forward_cuda(x, w, reverse=reverse, with_residuals=True)
    want = _scan_plain(x, w, dy, reverse)
    dx = lstm_ops.lstm_scan_backward_cuda(w, want[2].float(), want[1].float(), None, dy, reverse=reverse)[0]
    torch.cuda.synchronize()
    after = [lstm_ops.launches, lstm_ops.scan_launches, lstm_ops.bwd_launches, lstm_ops.scan_bwd_launches,
             lstm_ops.bf16_launches, lstm_ops.dw_launches]
    assert [a - b_ for a, b_ in zip(after, before)] == [1, 1, 1, 1, 0, 0]
    assert lstm_ops.last_launch["scan_fwd"][0] == plan
    assert lstm_ops.last_launch["scan_bwd"][0] == lstm_ops.scan_bwd_plan(b, hidden, lstm_ops._card_sms(0))
    others = [_scan_plain(x, w, dy, reverse, torch.from_numpy(np.random.RandomState(k).permutation(hidden)).to(cuda))
              for k in range(RELABELLINGS)]
    early, late = slice(0, SCAN_STEPS), slice(t - SCAN_STEPS, t)
    fwd_first, bwd_first = (late, early) if reverse else (early, late)
    fwd = _hold_scan(h_seq, want[0], [o[0] for o in others], fwd_first, 2.0 ** -16)
    for i, got in ((1, c_seq), (2, act)):
        assert got.dtype == torch.float32 and torch.equal(got, got.to(BF).float())
        _hold_scan(got.to(BF), want[i], [o[i] for o in others], fwd_first, 2.0 ** -16)
    torch.testing.assert_close(hn, h_seq[:, 0 if reverse else -1], atol=0, rtol=0)
    assert hn.dtype == cn.dtype == BF
    bwd = _hold_scan(dx, want[3], [o[3] for o in others], bwd_first, BWD_FLOOR)
    print(f"scan B={b} T={t} H={hidden} reverse={reverse}: h_seq {fwd[0]:.2e} (own spread {fwd[1]:.2e}; first "
          f"steps {_bf16_ulps(h_seq[:, fwd_first], want[0][:, fwd_first]):.1f} ulps, own {fwd[2]:.1f}), dxproj "
          f"{bwd[0]:.2e} ({bwd[1]:.2e}; {_bf16_ulps(dx[:, bwd_first], want[3][:, bwd_first], BWD_FLOOR):.1f}, "
          f"own {bwd[2]:.1f})")


def test_lstm_scan_forward_checks_the_backward_only_in_training(cuda, monkeypatch):
    """On a card of 100 SMs (fewer than H / 8 at H=1024) the scan forward's
    inference takes ``scan_plan``'s 16 units a block, within the scan rule
    against the plain loop; its training form (with residuals) checks the
    scan backward's plan first, which is regime (c)'s 16 units a block
    there, and its backward on those residuals holds the scan rule too."""
    b, t, hidden = 7, 24, 1024
    monkeypatch.setattr(lstm_ops, "_card_sms", lambda index: 100)
    assert lstm_ops.scan_bwd_plan(b, hidden, 100).regime == "c"
    x, w, dy = _scan_inputs(43, b, t, hidden, cuda)
    before = lstm_ops.scan_launches
    h_seq = lstm_ops.lstm_scan_forward_cuda(x, w)[0]
    torch.cuda.synchronize()
    assert lstm_ops.scan_launches == before + 1
    assert lstm_ops.last_launch["scan_fwd"][0] == lstm_ops.scan_plan(b, hidden, 100)
    assert lstm_ops.last_launch["scan_fwd"][0].units == 16
    want = _scan_plain(x, w, dy, False)
    others = [_scan_plain(x, w, dy, False, torch.from_numpy(np.random.RandomState(k).permutation(hidden)).to(cuda))
              for k in range(RELABELLINGS)]
    _hold_scan(h_seq, want[0], [o[0] for o in others], slice(0, SCAN_STEPS), 2.0 ** -16)
    train = lstm_ops.lstm_scan_forward_cuda(x, w, with_residuals=True)
    dx = lstm_ops.lstm_scan_backward_cuda(w, want[2].float(), want[1].float(), None, dy)[0]
    torch.cuda.synchronize()
    assert lstm_ops.scan_launches == before + 2 and torch.equal(train[0], h_seq)
    assert lstm_ops.last_launch["scan_bwd"][0] == lstm_ops.scan_bwd_plan(b, hidden, 100)
    _hold_scan(dx, want[3], [o[3] for o in others], slice(t - SCAN_STEPS, t), BWD_FLOOR)


def test_lstm_scan_function_on_card_runs_the_scan_kernels(cuda):
    """``LSTMSequenceFn`` in the scan rounding on the card is the scan
    kernels, bit for bit: a bfloat16 h0 and c0 in, h_seq out, and the
    gradients of xproj, h0 and c0, bfloat16; a frozen w_hh launches no dW,
    and a w_hh that requires grad gets the scan dW kernel's (one launch)."""
    x, w, dy = _scan_inputs(37, 7, 40, 256, cuda)
    h0, c0 = (torch.from_numpy(np.random.RandomState(s).randn(7, 256).astype(np.float32) * 0.5).to(cuda).to(BF)
              for s in (38, 39))
    leaves = [v.clone().requires_grad_() for v in (x, h0, c0)]
    before = lstm_ops.scan_dw_launches
    h_seq, hn, cn = lstm_ops.LSTMSequenceFn.apply(leaves[0], w, leaves[1], leaves[2], False, True)
    (h_seq.float() * dy.float()).sum().backward()
    assert lstm_ops.scan_dw_launches == before
    fwd = lstm_ops.lstm_scan_forward_cuda(x, w, h0, c0, with_residuals=True)
    bwd = lstm_ops.lstm_scan_backward_cuda(w, fwd[2], fwd[1], c0, dy)
    torch.cuda.synchronize()
    for got, want in zip([h_seq, hn, cn] + [v.grad for v in leaves], [fwd[0], fwd[3], fwd[4], *bwd]):
        assert got.dtype == want.dtype == BF and torch.equal(got, want)
    trained = w.clone().requires_grad_()
    lstm_ops.LSTMSequenceFn.apply(x, trained, h0, None, False, True)[0].backward(dy)
    assert lstm_ops.scan_dw_launches == before + 1
    fwd = lstm_ops.lstm_scan_forward_cuda(x, w, h0, None, with_residuals=True)
    dx = lstm_ops.lstm_scan_backward_cuda(w, fwd[2], fwd[1], None, dy)[0]
    want = lstm_ops.lstm_scan_weight_grad_cuda(fwd[0], h0, dx)
    assert trained.grad.dtype == BF and torch.equal(trained.grad, want)


def _scan_state_plain(x, w, h0, c0, reverse, perm=None):
    """The plain scan forward's (h_seq, c_seq, act, hN, cN) from (h0, c0),
    with the hidden units relabelled by ``perm`` (and back) when given."""
    if perm is not None:
        cols = torch.cat([perm + g * len(perm) for g in range(4)])
        x, w = x[..., cols], w[perm][:, cols]
        h0, c0 = (None if v is None else v[:, perm] for v in (h0, c0))
    out = lstm_ops.lstm_scan_bf16_train_ref(x, w, h0, c0, reverse)
    if perm is not None:
        inv = torch.argsort(perm)
        inv4 = torch.cat([inv + g * len(inv) for g in range(4)])
        out = tuple(o[..., idx] for o, idx in zip(out, (inv, inv, inv4, inv, inv)))
    return out


# The scan forward (csrc/lstm_scan_fwd.cu, wgmma) at shapes beside 10a's and
# 8d's: both regimes from a given bfloat16 (h0, c0) and from zero, B=37 in
# two 32-row tiles, H=40 at 8 units a block, B=1 (n8), B=20 (n24), T=1.
SCAN_STATE_SHAPES = [(37, 20, 64), (5, 20, 40), (1, 5, 8), (20, 24, 768), (32, 40, 1024), (7, 1, 512), (3, 30, 24)]


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("b, t, hidden", SCAN_STATE_SHAPES)
def test_lstm_scan_forward_matches_plain_from_a_state(cuda, b, t, hidden, reverse, with_state):
    """``lstm_scan_forward_cuda`` against ``lstm_scan_bf16_train_ref`` from
    the same bfloat16 (h0, c0), or from zero, by the scan rule (h_seq,
    c_seq, act; hN and cN the last step's); one launch of ``scan_plan``'s
    plan; two calls the same bits."""
    x, w, _ = _scan_inputs(43, b, t, hidden, cuda)
    h0 = c0 = None
    if with_state:
        h0, c0 = (torch.from_numpy(np.random.RandomState(s).randn(b, hidden).astype(np.float32) * 0.5).to(cuda).to(BF)
                  for s in (44, 45))
    before = lstm_ops.launches, lstm_ops.scan_launches
    got = lstm_ops.lstm_scan_forward_cuda(x, w, h0, c0, reverse, with_residuals=True)
    again = lstm_ops.lstm_scan_forward_cuda(x, w, h0, c0, reverse, with_residuals=True)
    torch.cuda.synchronize()
    assert (lstm_ops.launches, lstm_ops.scan_launches) == (before[0] + 2, before[1] + 2)
    assert lstm_ops.last_launch["scan_fwd"][0] == lstm_ops.scan_plan(b, hidden, lstm_ops._card_sms(0))
    assert all(torch.equal(g, a) for g, a in zip(got, again))
    want = _scan_state_plain(x, w, h0, c0, reverse)
    others = [_scan_state_plain(x, w, h0, c0, reverse,
                                torch.from_numpy(np.random.RandomState(k).permutation(hidden)).to(cuda))
              for k in range(RELABELLINGS)]
    steps = min(SCAN_STEPS, t)
    first = slice(t - steps, t) if reverse else slice(0, steps)
    for i, g in ((0, got[0]), (1, got[1].to(BF)), (2, got[2].to(BF))):
        _hold_scan(g, want[i], [o[i] for o in others], first, 2.0 ** -16)
    torch.testing.assert_close(got[3], got[0][:, 0 if reverse else -1], atol=0, rtol=0)
    assert got[4].dtype == BF and torch.equal(got[4].float(), got[1][:, 0 if reverse else -1])


@pytest.mark.parametrize("hidden", [512, 1024])
def test_lstm_scan_forward_units_a_block(cuda, hidden, monkeypatch):
    """The scan forward with 8 units a block (the default: the 64-column
    W^T half zeros) and with 16 (``scan_plan``'s choice where H / 8 blocks
    would outnumber the SMs, forced here by planning for a card of H / 16
    SMs) at B=32: both by the scan rule against the plain loop; a plan that
    does not fit the shapes is refused by the kernel, not run."""
    x, w, _ = _scan_inputs(46, 32, 48, hidden, cuda)
    want = _scan_state_plain(x, w, None, None, False)
    others = [_scan_state_plain(x, w, None, None, False,
                                torch.from_numpy(np.random.RandomState(k).permutation(hidden)).to(cuda))
              for k in range(RELABELLINGS)]
    card_plan = lstm_ops.scan_plan
    for units, sms in ((8, lstm_ops._card_sms(0)), (16, hidden // 16)):
        plan = card_plan(32, hidden, sms)
        assert (plan.units, plan.blocks) == (units, hidden // units)
        monkeypatch.setattr(lstm_ops, "scan_plan", lambda b, h, _sms, plan=plan: plan)
        got = lstm_ops.lstm_scan_forward_cuda(x, w)[0]
        torch.cuda.synchronize()
        assert lstm_ops.last_launch["scan_fwd"][0] == plan
        _hold_scan(got, want[0], [o[0] for o in others], slice(0, SCAN_STEPS), 2.0 ** -16)
    bad = dataclasses.replace(card_plan(32, hidden, lstm_ops._card_sms(0)), blocks=hidden // 16 - 1)
    monkeypatch.setattr(lstm_ops, "scan_plan", lambda b, h, _sms: bad)
    with pytest.raises(RuntimeError, match="refused the launch plan"):
        lstm_ops.lstm_scan_forward_cuda(x, w)


# The scan dW kernel against its plain loop on the same inputs: each step's
# float32 sum over the B rows in the plain product's order or another, then
# the same two roundings, so 1 bfloat16 ulp (floored at BWD_FLOOR of the
# peak) and 99% bit-equal.
SCAN_DW_SHAPES = [(7, 128, 32), (7, 128, 512), (7, 128, 1024), (32, 128, 256), (37, 20, 64), (1, 5, 8),
                  (20, 128, 768),
                  # batches past one box a step at the widest tile: a narrower tile; two slabs of 150 rows
                  # (past a TMA box's 256) in it and in the smallest tile; two of 80 (two buffers' bytes)
                  (96, 16, 1024), (300, 8, 1024), (300, 8, 32), (160, 8, 512)]


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("b, t, hidden", SCAN_DW_SHAPES)
def test_lstm_scan_weight_grad_kernel_matches_plain(cuda, b, t, hidden, reverse):
    """``lstm_scan_weight_grad_cuda`` against
    ``lstm_scan_bf16_weight_grad_ref`` on the plain scan chain's h_seq and
    dxproj (so the kernel is held alone), with a bfloat16 h0: within 1 ulp
    floored at BWD_FLOOR of the peak, 99% bit-equal; one launch; two calls
    the same bits. H=8 is one partial tile; B=96 at H=1024 takes a
    narrower tile than B=7 (one box a step no longer fits the widest), and
    B=300 and B=160 split each step's batch into slabs (``scan_dw_plan``)."""
    x, w, dy = _scan_inputs(40, b, t, hidden, cuda)
    h0 = torch.from_numpy(np.random.RandomState(41).randn(b, hidden).astype(np.float32) * 0.5).to(cuda).to(BF)
    h_seq, c_seq, act, _, _ = lstm_ops.lstm_scan_bf16_train_ref(x, w, h0, None, reverse)
    dx = lstm_ops.lstm_scan_bf16_backward_ref(w, act, c_seq, None, dy, reverse=reverse)[0]
    before = lstm_ops.scan_dw_launches, lstm_ops.dw_launches
    got = lstm_ops.lstm_scan_weight_grad_cuda(h_seq, h0, dx, reverse)
    again = lstm_ops.lstm_scan_weight_grad_cuda(h_seq, h0, dx, reverse)
    torch.cuda.synchronize()
    assert (lstm_ops.scan_dw_launches, lstm_ops.dw_launches) == (before[0] + 2, before[1])
    want = lstm_ops.lstm_scan_bf16_weight_grad_ref(h_seq, h0, dx, reverse)
    assert got.dtype == BF and got.shape == (hidden, 4 * hidden) and torch.equal(got, again)
    _bf16_close(got, want, floor=BWD_FLOOR)


def test_lstm_scan_weight_grad_refuses_what_it_does_not_take(cuda):
    """float32 operands and CPU tensors raise before a launch; H % 8 != 0
    is launched at the padded width and stripped (a zero dW stays zero)."""
    x, w, dy = _scan_inputs(42, 2, 3, 8, cuda)
    h_seq = torch.zeros(2, 3, 8, device=cuda, dtype=BF)
    dx = torch.zeros(2, 3, 32, device=cuda, dtype=BF)
    with pytest.raises(TypeError):
        lstm_ops.lstm_scan_weight_grad_cuda(h_seq.float(), None, dx)
    got = lstm_ops.lstm_scan_weight_grad_cuda(h_seq[..., :4].contiguous(), None, dx[..., :16].contiguous())
    assert got.shape == (4, 16) and not got.float().abs().max()
    with pytest.raises(ValueError, match="one CUDA device"):
        lstm_ops.lstm_scan_weight_grad_cuda(h_seq.cpu(), None, dx.cpu())


@pytest.mark.parametrize("protocol", ["windowed", "crop"])
def test_bf16_speaker_step_launches_the_scan_forms(cuda, protocol):
    """A bfloat16 generator's loss with the lambda_spk auxiliary on the card
    (B=2, T=160, the 80/256/256 x3 d-vector): the generator's 18 sequences
    (7 for the conversion, 11 in training form) in the bfloat16 forms with
    their gates, backwards and dW; the d-vector's 3 in the scan forms,
    forward and backward, and no dW; the auxiliary's loss finite."""
    from autovc_tpu_torch.config import ModelConfig

    cfg = Config(model=ModelConfig(compute_dtype="bfloat16", use_pallas_lstm=True),
                 train=TrainConfig(batch_size=2, len_crop=160, lambda_spk=1.0, spk_protocol=protocol))
    rng = np.random.RandomState(12)
    x = torch.from_numpy(rng.rand(2, 160, 80).astype(np.float32)).to(cuda)
    emb = torch.from_numpy(rng.randn(2, 256).astype(np.float32)).to(cuda)
    table = emb / emb.norm(dim=-1, keepdim=True)
    model = build_generator(cfg.model, device=cuda, seed=3, trainable=True)
    dvec = build_dvector(device=cuda, seed=5, dim_cell=256)
    counters = ("launches", "bf16_launches", "scan_launches", "bwd_launches", "bf16_bwd_launches",
                "scan_bwd_launches", "dw_launches", "gates_launches")
    before = [getattr(lstm_ops, c) for c in counters]
    total, metrics = loss_fn(model, cfg, x, emb, spk=SpeakerAux(dvec, *((table, table) if protocol == "windowed"
                                                                         else ())))
    total.backward()
    torch.cuda.synchronize()
    assert [getattr(lstm_ops, c) - n for c, n in zip(counters, before)] == [21, 18, 3, 21, 18, 3, 18, 18]
    assert np.isfinite(float(metrics["g_loss_spk"]))


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("b, t, hidden", BF16_TRAIN_SHAPES)
def test_lstm_bf16_backward_matches_plain(cuda, b, t, hidden, reverse):
    """The bfloat16 backward on the gates kernel's activations, as the main
    path runs it, against the plain reversed loop (gates from the rounded
    h_seq, float32 sums, dxproj and dW rounded at the end): one backward
    launch (a bfloat16 one) and one dW launch."""
    x, w, h0, c0, dy, dhn, dcn = _bf16_train_inputs(33, b, t, hidden, cuda)
    h_seq, c_seq, _, _ = lstm_ops.lstm_sequence_train_ref(x, w, h0, c0, reverse)
    gates = lstm_ops.lstm_gates_cuda(x, w, h0, h_seq, reverse)
    before = lstm_ops.bwd_launches, lstm_ops.bf16_bwd_launches, lstm_ops.dw_launches
    args = (x, w, h0, c0, h_seq, c_seq, dy, dhn, dcn, reverse)
    got = lstm_ops.lstm_backward_cuda(*args, gates=gates)
    torch.cuda.synchronize()
    assert (lstm_ops.bwd_launches, lstm_ops.bf16_bwd_launches, lstm_ops.dw_launches) == tuple(n + 1 for n in before)
    _assert_bf16_backward_close(got, lstm_ops.lstm_backward_ref(*args))


@pytest.mark.parametrize("h0_kind", ["zero", "nonzero"])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("b, t", [(1, 1), (3, 37), (7, 128), (1, 8192)])
@pytest.mark.parametrize("hidden", [8, 32, 512, 1024])
def test_lstm_bf16_weight_grad_matches_plain(cuda, hidden, b, t, reverse, h0_kind):
    """The dW kernel on a bfloat16 h_seq (a float32 h0) and float32 gate
    gradients, at every split of K its plan takes, against
    ``lstm_weight_grad_ref``: rounded once to bfloat16, by ``_bf16_close``
    (floor BWD_FLOOR; K = 1 from a zero state is all zeros, met exactly);
    two calls the same bits."""
    rng = np.random.RandomState(hidden + b * t + 1)
    h_seq = torch.from_numpy(rng.randn(b, t, hidden).astype(np.float32)).to(cuda).to(BF)
    dg = torch.from_numpy(rng.randn(b, t, 4 * hidden).astype(np.float32)).to(cuda)
    h0 = None if h0_kind == "zero" else torch.from_numpy(rng.randn(b, hidden).astype(np.float32)).to(cuda)
    got = lstm_ops.lstm_weight_grad_cuda(h_seq, h0, dg, reverse)
    again = lstm_ops.lstm_weight_grad_cuda(h_seq, h0, dg, reverse)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    _bf16_close(got, lstm_ops.lstm_weight_grad_ref(h_seq, h0, dg, reverse), floor=BWD_FLOOR)


@pytest.mark.parametrize("regime", ["a", "b"])
def test_lstm_bf16_train_steps_sharing_a_line(cuda, request, regime):
    """B=1, H=8, T=64, both directions: the bfloat16 training forward and
    backward where regime (b) stages h from the float32 exchange buffer and
    the float32 gate gradients that other blocks wrote just before the
    barrier, never the rounded sequences."""
    if regime == "b":
        request.getfixturevalue("grid_plan_at_small_h")
    x, w, h0, c0, dy, dhn, dcn = _bf16_train_inputs(34, 1, 64, 8, cuda)
    for reverse in (False, True):
        got = lstm_ops.lstm_forward_cuda(x, w, h0, c0, reverse, with_cseq=True)
        torch.cuda.synchronize()
        assert lstm_ops.last_launch["fwd"][0].regime == regime
        want = lstm_ops.lstm_sequence_train_ref(x, w, h0, c0, reverse)
        _bf16_close(got[0], want[0])
        args = (x, w, h0, c0, want[0], want[1], dy, dhn, dcn, reverse)
        bgot = lstm_ops.lstm_backward_cuda(*args, gates=lstm_ops.lstm_gates_cuda(x, w, h0, want[0], reverse))
        torch.cuda.synchronize()
        assert lstm_ops.last_launch["bwd"][0].regime == regime
        _assert_bf16_backward_close(bgot, lstm_ops.lstm_backward_ref(*args))


def test_lstm_bf16_function_gradients_on_card_match_plain(cuda):
    """LSTMSequenceFn in bfloat16 on the card (forward, gates, backward and
    dW kernels, one launch each) against the plain forward and backward on
    the same inputs, both directions, gradients in all four inputs: dxproj
    and dW_hh in bfloat16, dh0 and dc0 in float32."""
    for reverse in (False, True):
        x, w, h0, c0, dy, dhn, dcn = _bf16_train_inputs(35, 6, 40, 32, cuda)
        ins = [v.clone().requires_grad_() for v in (x, w, h0, c0)]
        before = (lstm_ops.bf16_launches, lstm_ops.gates_launches, lstm_ops.bf16_bwd_launches,
                  lstm_ops.dw_launches)
        h_seq, hn, cn = lstm_ops.LSTMSequenceFn.apply(*ins, reverse)
        assert h_seq.dtype == BF and hn.dtype == cn.dtype == torch.float32
        torch.autograd.backward((h_seq, hn, cn), (dy, dhn, dcn))
        torch.cuda.synchronize()
        assert (lstm_ops.bf16_launches, lstm_ops.gates_launches, lstm_ops.bf16_bwd_launches,
                lstm_ops.dw_launches) == tuple(n + 1 for n in before)
        r_seq, r_c, _, _ = lstm_ops.lstm_sequence_train_ref(x, w, h0, c0, reverse)
        want = lstm_ops.lstm_backward_ref(x, w, h0, c0, r_seq, r_c, dy, dhn, dcn, reverse)
        _assert_bf16_backward_close([v.grad for v in ins], want)


def _plain_engine():
    """Every LSTM of the models on the plain versions, on the card too: the
    forward and backward loops of ``LSTMSequenceFn``'s CPU path, with their
    rounding points (not torch autograd through the loop)."""
    from unittest import mock

    return mock.patch.object(lstm_ops, "_device_kind", lambda x: "cpu")


def test_bf16_train_step_on_card_matches_plain(cuda):
    """One train step of the seeded full-width generator in bfloat16 (B=2,
    T=64) with the kernels against the same step on the plain engine, both
    on the card, the plain step on the kernel step's side of every kink
    (``KinkTape``); and the plain step in float32 on the same kinks, whose
    distance from the bfloat16 one is bfloat16's own spread. 11 bfloat16
    LSTM sequences forward, 11 gate recomputes, backwards and dW launches.
    A flip in a bfloat16 sum moves a BatchNorm channel, so two bfloat16
    engines that sum in another order can land as far apart as bfloat16
    lands from float32 (tests/test_torch_bf16_train.py): the loss within
    1e-3 relative of the plain engine's and within twice its spread plus
    1e-5 relative; every gradient leaf no farther from the plain engine's
    (of its ``grad_scale``) than bfloat16 moves the median leaf from float32
    (a convolution's bias, zero in exact arithmetic, is all rounding, so a
    leaf's own spread is no gate); the parameters, their gradients and the
    BatchNorm statistics float32."""
    from autovc_tpu_torch.config import ModelConfig

    cfg = Config(model=ModelConfig(compute_dtype="bfloat16", use_pallas_lstm=True),
                 train=TrainConfig(batch_size=2, len_crop=64))
    x, emb = (v.to(cuda) for v in _small_batch(8))
    states = {}
    for name, model_cfg in (("kernels", cfg.model), ("plain", cfg.model), ("f32", ModelConfig())):
        model = build_generator(model_cfg, device=cuda, seed=3, trainable=True)
        states[name] = TrainState(0, model, make_optimizer(model, cfg), init_ema(model))
    step = make_train_step(cfg)
    step32 = make_train_step(Config(train=cfg.train))
    tape = KinkTape()
    counters = ("bf16_launches", "gates_launches", "bf16_bwd_launches", "dw_launches")
    before = [getattr(lstm_ops, c) for c in counters]
    with tape.record():
        got = step(states["kernels"], x, emb)
        torch.cuda.synchronize()
    assert [getattr(lstm_ops, c) - n for c, n in zip(counters, before)] == [11] * 4
    with _plain_engine():
        with tape.replay():
            want = step(states["plain"], x, emb)
        with tape.replay():
            want32 = step32(states["f32"], x, emb)
    loss, loss_plain, loss32 = (float(m["g_loss"]) for m in (got, want, want32))
    loss_tol = min(1e-3 * abs(loss_plain), 2 * abs(loss_plain - loss32) + 1e-5 * abs(loss_plain))
    assert abs(loss - loss_plain) <= loss_tol, (loss, loss_plain, loss32)
    model = states["kernels"].model
    assert {p.dtype for p in model.parameters()} == {p.grad.dtype for p in model.parameters()} == {torch.float32}
    assert {b.dtype for b in model.buffers()} == {torch.float32}
    grads = {k: {n: p.grad.double() for n, p in st.model.named_parameters()} for k, st in states.items()}

    def apart(a, b):
        return {n: float((grads[a][n] - grads[b][n]).abs().max()) / grad_scale(n, grads["plain"]) for n in grads[a]}

    tol = float(np.median(list(apart("f32", "plain").values())))
    worst = max(apart("kernels", "plain").items(), key=lambda kv: kv[1])
    assert worst[1] <= tol, (worst, tol)


# ------------------------------------------------------- the stft and wav variants


def _variant_batch(model_type, seed, b=2, frames=64):
    """(x, emb) of the variant: a (B, frames, 513) stft batch, or waveforms
    of (frames - 1) * 256 + 1024 samples (frames latent frames)."""
    rng = np.random.RandomState(seed)
    if model_type == "wav":
        n = (frames - 1) * 256 + 1024
        x = np.sin(np.arange(n)[None] * rng.uniform(0.02, 0.1, (b, 1))) + 0.1 * rng.randn(b, n)
        x = x.astype(np.float32)[..., None]
    else:
        x = rng.rand(b, frames, 513).astype(np.float32)
    return torch.from_numpy(x), torch.from_numpy(rng.randn(b, 256).astype(np.float32))


@pytest.mark.parametrize("model_type", ["stft", "wav"])
def test_variant_generator_on_card_matches_cpu(cuda, model_type):
    """The seeded full-width stft Generator and GeneratorWav (ConvTasNet
    depth 1, 512 channels): the card (7 LSTM kernel launches a forward,
    cuDNN convolutions without TF32) against the CPU (the plain recurrence),
    every output within 1e-3 of it (the waveform's and the latent's too)."""
    from autovc_tpu_torch.config import ModelConfig

    cfg = ModelConfig(model_type=model_type)
    cpu_gen = build_generator(cfg, device="cpu", seed=0)
    card_gen = build_generator(cfg, device=cuda, seed=0)
    x, e = _variant_batch(model_type, 6)
    with torch.inference_mode():
        want = cpu_gen(x, e, e)
        before = lstm_ops.launches
        got = card_gen(x.to(cuda), e.to(cuda), e.to(cuda))
        torch.cuda.synchronize()
    assert lstm_ops.launches == before + 7
    for g, w in zip(got, want):
        torch.testing.assert_close(g.cpu(), w, atol=1e-3, rtol=0)


@pytest.mark.parametrize("model_type", ["stft", "wav"])
def test_variant_train_step_on_card_matches_cpu(cuda, model_type):
    """One train step of the seeded full-width stft and wav generators
    (B=2, 64 frames; the wav loss's four terms): the card against the CPU,
    on the CPU step's side of every ReLU, PReLU and abs kink (``KinkTape``);
    the loss within 1e-5 relative, 11 LSTM sequences forward, backward and
    dW, every gradient leaf within 1e-3 of its ``grad_scale``."""
    from autovc_tpu_torch.config import ModelConfig

    frames = 64
    crop = (frames - 1) * 256 + 1024 if model_type == "wav" else frames
    cfg = Config(model=ModelConfig(model_type=model_type), train=TrainConfig(batch_size=2, len_crop=crop))
    x, emb = _variant_batch(model_type, 7)
    states = {}
    for name, dev in (("cpu", "cpu"), ("cuda", cuda)):
        model = build_generator(cfg.model, device=dev, seed=3, trainable=True)
        states[name] = TrainState(0, model, make_optimizer(model, cfg), init_ema(model))
    step = make_train_step(cfg)
    tape = KinkTape()
    with tape.record():
        want = step(states["cpu"], x, emb)
    before = lstm_ops.launches, lstm_ops.bwd_launches, lstm_ops.dw_launches
    with tape.replay():
        got = step(states["cuda"], x.to(cuda), emb.to(cuda))
        torch.cuda.synchronize()
    assert (lstm_ops.launches, lstm_ops.bwd_launches, lstm_ops.dw_launches) == tuple(n + 11 for n in before)
    assert ("prelu" in {k for k, _ in tape.sides}) == (model_type == "wav")
    assert abs(float(got["g_loss"]) - float(want["g_loss"])) <= 1e-5 * abs(float(want["g_loss"]))
    grads = {k: {n: p.grad.double().cpu() for n, p in st.model.named_parameters()} for k, st in states.items()}
    for n, g in grads["cuda"].items():
        apart = float((g - grads["cpu"][n]).abs().max()) / grad_scale(n, grads["cpu"])
        assert apart <= 1e-3, f"{n}: the card's step {apart:.3e} of its scale from the CPU step"


@pytest.mark.parametrize("compute_dtype,use_pallas_lstm,counter", [("float32", False, None),
                                                                   ("bfloat16", False, "scan_launches"),
                                                                   ("bfloat16", True, "bf16_launches")])
def test_serving_bundle_on_card_matches_live_converter(cuda, tmp_path, compute_dtype, use_pallas_lstm, counter):
    """A bundle exported for cuda at the published widths (seeded weights),
    called through ServingConverter at B=3, T=160 and at B=1, T=32: bit for
    bit against the live Converter on the same weights, 7 launches of its
    LSTM form a call, and a frame count off freq raised as ValueError."""
    from autovc_tpu_torch.io import generator_state_to_jax
    from autovc_tpu_torch.serve import ServingConverter, export_converter

    cfg = Config(model=dataclasses.replace(Config().model, compute_dtype=compute_dtype,
                                           use_pallas_lstm=use_pallas_lstm))
    gen = build_generator(cfg.model, device=cuda, seed=5)
    srv = ServingConverter(export_converter(generator_state_to_jax(gen.state_dict()), cfg, str(tmp_path / "b")),
                           device=cuda)
    converter = Converter(gen, cfg.model)
    rng = np.random.RandomState(5)
    for b, t in ((3, 160), (1, 32)):
        x = rng.rand(b, t, 80).astype(np.float32)
        eo, et = rng.rand(b, 256).astype(np.float32), rng.rand(b, 256).astype(np.float32)
        counts = (lstm_ops.launches, lstm_ops.bf16_launches, lstm_ops.scan_launches)
        got = srv(x, eo, et)
        torch.cuda.synchronize()
        launched = [a - c for a, c in zip((lstm_ops.launches, lstm_ops.bf16_launches, lstm_ops.scan_launches),
                                          counts)]
        assert launched == [7, 7 * (counter == "bf16_launches"), 7 * (counter == "scan_launches")]
        assert got.dtype == torch.float32 and got.shape == (b, t, 80)
        assert torch.equal(got, converter._forward(x, eo, et))
    with pytest.raises(ValueError, match="multiple of freq 32"):
        srv(np.zeros((1, 100, 80), np.float32), np.zeros((1, 256), np.float32), np.zeros((1, 256), np.float32))


def test_serving_vocoder_program_on_card_matches_live_hifigan(cuda, tmp_path):
    """The fused HiFi-GAN bundle on the card: a T=100 utterance's waveform
    (the pad stripped before the vocoder program) bit for bit against the
    live Converter + HiFiGANVocoder."""
    from autovc_tpu_torch.data import ConversionSpec
    from autovc_tpu_torch.io import conv_state_to_jax, generator_state_to_jax, unflatten_params
    from autovc_tpu_torch.serve import ServingConverter, export_converter

    cfg = Config()
    gen = build_generator(cfg.model, device=cuda, seed=6)
    voc = HiFiGANVocoder(device=cuda, seed=7)
    srv = ServingConverter(export_converter(generator_state_to_jax(gen.state_dict()), cfg, str(tmp_path / "b"),
                                            hifigan_params=unflatten_params(conv_state_to_jax(voc.model.state_dict()))),
                           device=cuda)
    rng = np.random.RandomState(6)
    feats, eo, et = rng.rand(100, 80).astype(np.float32), rng.rand(256).astype(np.float32), rng.rand(256).astype(
        np.float32)
    wav = srv.convert(feats, eo, et)
    mel = Converter(gen, cfg.model).convert(ConversionSpec(0, "u", eo, feats, "t", et))
    assert wav.shape == (100 * 256,) and np.isfinite(wav).all()
    np.testing.assert_array_equal(wav, voc.generate(mel).cpu().numpy())


# ------------------------------------------------------------ parallelism


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("hidden", [32, 512, 1024])
def test_sp_chunk_chain_on_card_matches_plain_chain(cuda, hidden, reverse):
    """Sequence parallelism's relay on one card: 4 blocks of 64 steps, each
    one launch of the forward kernel from the (h, c) the block before it
    handed on (zeros for the first), against the plain loop over the whole
    sequence on the CPU: within LSTM_TOL-like 1e-4, 4 launches."""
    xproj, w_hh = _inputs(11, 2, 256, hidden)
    want = lstm_ops.lstm_sequence_train_ref(torch.from_numpy(xproj), torch.from_numpy(w_hh), reverse=reverse)[0]
    x, w = torch.from_numpy(xproj).to(cuda), torch.from_numpy(w_hh).to(cuda)
    blocks = list(x.split(64, dim=1))
    order = range(3, -1, -1) if reverse else range(4)
    out, h, c = [None] * 4, None, None
    before = lstm_ops.launches
    with torch.no_grad():
        for i in order:
            out[i], _, h, c = lstm_ops.lstm_forward_cuda(blocks[i], w, h, c, reverse)
    assert lstm_ops.launches - before == 4
    torch.testing.assert_close(torch.cat(out, dim=1).cpu(), want, atol=1e-4, rtol=0)


def _gloo_card_world(dev, state: dict, model_cfg, x: np.ndarray, e1: np.ndarray, e2: np.ndarray) -> dict:
    """Two ranks sharing the card under gloo: SPGenerator over 'seq' (the
    state handed through host memory), a differentiable all-reduce, and a
    data-parallel BatchNorm's global statistics."""
    from autovc_tpu_torch.convert.sequence_parallel import SPGenerator
    from autovc_tpu_torch.models.layers import BatchNorm
    from autovc_tpu_torch.parallel import mesh as pmesh

    mesh = pmesh.mesh_over({"seq": 2}, dev)
    gen = build_generator(model_cfg, device="cpu")
    gen.load_state_dict(state)
    before = lstm_ops.launches
    outs = [o.cpu().numpy() for o in SPGenerator(gen.to(dev), mesh)(x, e1, e2)]
    launched = lstm_ops.launches - before
    data = pmesh.mesh_over({"data": 2}, dev)
    t = torch.full((3,), float(data.index("data") + 1), device=dev, requires_grad=True)
    s = pmesh.all_reduce_sum(t, data, "data")
    (s * s).sum().backward()
    bn = BatchNorm(4)
    bn.reset_parameters(None)
    bn = bn.to(dev).train()
    bn.reduce = lambda v: pmesh.all_reduce_sum(v, data, "data")
    rows = torch.arange(16.0, device=dev).reshape(4, 1, 4) * (data.index("data") + 1)
    bn(rows)
    return {"outs": outs, "launched": launched, "sum": s.detach().cpu(), "grad": t.grad.cpu(),
            "running_mean": bn.running_mean.cpu(), "device": str(dev)}


def test_two_rank_gloo_world_on_card(cuda, monkeypatch):
    """A 2-rank world on one card (AUTOVC_DIST_BACKEND=gloo): SPGenerator at
    narrow widths, T=128, against the dense Generator on the card (codes
    2e-5, x_identic 2e-4, x_psnt 2e-3; 7 forward launches a rank), an
    all-reduce and its gradient, and BatchNorm's global mean across the
    ranks' rows; both ranks on cuda:0."""
    from autovc_tpu_torch.config import ModelConfig
    from autovc_tpu_torch.parallel.launch import run_world

    monkeypatch.setenv("AUTOVC_DIST_BACKEND", "gloo")
    cfg = ModelConfig(dim_neck=8, dim_emb=16, dim_pre=32, enc_channels=32, dec_lstm_dim=64, postnet_channels=32)
    gen = build_generator(cfg, device="cpu", seed=4)
    rng = np.random.RandomState(12)
    x, e1, e2 = rng.rand(2, 128, 80).astype(np.float32), *rng.randn(2, 2, 16).astype(np.float32)
    with torch.no_grad():
        want = [o.cpu().numpy() for o in gen.to(cuda)(*(torch.from_numpy(a).to(cuda) for a in (x, e1, e2)))]
    got = run_world(_gloo_card_world, 2, {k: v.cpu() for k, v in gen.state_dict().items()}, cfg, x, e1, e2,
                    device="cuda")
    for rank in got:
        assert rank["device"] == "cuda:0" and rank["launched"] == 7
        for tol, g, w in zip((2e-4, 2e-3, 2e-5), rank["outs"], want):
            np.testing.assert_allclose(g, w, atol=tol, rtol=0)
        assert torch.equal(rank["sum"], torch.full((3,), 3.0)) and torch.equal(rank["grad"], torch.full((3,), 12.0))
        # rows 0..15 and 0..30 by 2: channel j's mean over both ranks' rows
        want_mean = 0.1 * (torch.arange(4.0) + 6.0) * 1.5
        torch.testing.assert_close(rank["running_mean"], want_mean, atol=1e-6, rtol=0)


# Widths off the package's own (pad_hidden: H = 20 -> 24, 44 -> 48) and past
# every block's shared memory (H = 2048: regime (c), w_hh's slices streamed
# every step), each LSTM wrapper against its plain version at the gates the
# package's widths are held to; both directions, from a nonzero state.
WIDTHS = [(7, 128, 20), (7, 128, 44), (7, 128, 2048)]


def _regime(hidden: int) -> str:
    """The regime the float32 and bfloat16 forms run a width of the WIDTHS in."""
    return "c" if hidden > 1024 else "a"


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("b, t, hidden", WIDTHS)
def test_lstm_kernels_at_any_width(cuda, b, t, hidden, reverse):
    """The float32 training forward (gate activations included), the
    backward on them and dW, within 1e-4 of the plain loops (dW 1e-4 of its
    peak); one launch each, in the regime the padded width plans."""
    xproj, w_hh, h0, c0, dy, dhn, dcn = (torch.from_numpy(a).to(cuda) for a in _train_inputs(51, b, t, hidden))
    before = lstm_ops.launches, lstm_ops.bwd_launches, lstm_ops.dw_launches
    got = lstm_ops.lstm_forward_cuda(xproj, w_hh, h0, c0, reverse, with_cseq=True, with_gates=True)
    want = lstm_ops.lstm_sequence_train_ref(xproj, w_hh, h0, c0, reverse)
    want += (lstm_ops.lstm_gates_ref(xproj, w_hh, h0, want[0], reverse),)
    for g, w in zip(got, want, strict=True):
        assert g.shape == w.shape
        torch.testing.assert_close(g, w, atol=1e-4, rtol=0)
    args = (xproj, w_hh, h0, c0, want[0], want[1], dy, dhn, dcn, reverse)
    grads = lstm_ops.lstm_backward_cuda(*args, gates=got[4])
    torch.cuda.synchronize()
    assert (lstm_ops.launches, lstm_ops.bwd_launches, lstm_ops.dw_launches) == tuple(n + 1 for n in before)
    assert lstm_ops.last_launch["fwd"][0].regime == lstm_ops.last_launch["bwd"][0].regime == _regime(hidden)
    _assert_backward_close(grads, lstm_ops.lstm_backward_ref(*args))


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("b, t, hidden", WIDTHS)
def test_lstm_bf16_kernels_at_any_width(cuda, b, t, hidden, reverse):
    """The bfloat16 (Pallas-rounding) training forward, the gates kernel and
    the bfloat16 backward with dW against their plain versions, at the
    bfloat16 forms' gates (1 ulp, 99% bit-equal; the float32 state 1e-4)."""
    x, w, h0, c0, dy, dhn, dcn = _bf16_train_inputs(52, b, t, hidden, cuda)
    got = lstm_ops.lstm_forward_cuda(x, w, h0, c0, reverse, with_cseq=True)
    want = lstm_ops.lstm_sequence_train_ref(x, w, h0, c0, reverse)
    # the forward's floor where float32 sums cancel grows as sqrt(H) past the package's widest H=1024
    # (chip_smoke.py's fwd_floor: both sides 1 ulp from a float64 oracle there)
    _bf16_close(got[0], want[0], floor=2.0 ** -16 * max(1.0, hidden / 1024) ** 0.5)
    for g, wv in zip(got[1:], want[1:], strict=True):
        torch.testing.assert_close(g, wv, atol=1e-4, rtol=0)
    assert lstm_ops.last_launch["fwd"][0].regime == _regime(hidden)
    gates = lstm_ops.lstm_gates_cuda(x, w, h0, want[0], reverse)
    torch.testing.assert_close(gates, lstm_ops.lstm_gates_ref(x, w, h0, want[0], reverse), atol=GATES_TOL, rtol=0)
    args = (x, w, h0, c0, want[0], want[1], dy, dhn, dcn, reverse)
    grads = lstm_ops.lstm_backward_cuda(*args, gates=gates)
    torch.cuda.synchronize()
    assert lstm_ops.last_launch["bwd"][0].regime == _regime(hidden)
    _assert_bf16_backward_close(grads, lstm_ops.lstm_backward_ref(*args))


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("b, t, hidden", WIDTHS)
def test_lstm_scan_kernels_at_any_width(cuda, b, t, hidden, reverse):
    """The scan forward with its residuals, the scan backward on the plain
    residuals and the scan dW on the plain chain, each against its plain
    loop by the scan rule (``_hold_scan``; dW 1 ulp, 99% bit-equal);
    regime (c) of both recurrences at H=2048."""
    x, w, dy = _scan_inputs(53, b, t, hidden, cuda)
    h_seq, c_seq, act, hn, cn = lstm_ops.lstm_scan_forward_cuda(x, w, reverse=reverse, with_residuals=True)
    want = _scan_plain(x, w, dy, reverse)
    dx = lstm_ops.lstm_scan_backward_cuda(w, want[2].float(), want[1].float(), None, dy, reverse=reverse)[0]
    dw = lstm_ops.lstm_scan_weight_grad_cuda(want[0], None, want[3], reverse)
    torch.cuda.synchronize()
    if hidden > 1024:
        assert lstm_ops.last_launch["scan_fwd"][0].regime == lstm_ops.last_launch["scan_bwd"][0].regime == "c"
    perms = [torch.from_numpy(np.random.RandomState(k).permutation(hidden)).to(cuda) for k in range(RELABELLINGS)]
    others = [_scan_plain(x, w, dy, reverse, p) for p in perms]
    early, late = slice(0, SCAN_STEPS), slice(t - SCAN_STEPS, t)
    fwd_first, bwd_first = (late, early) if reverse else (early, late)
    wide = hidden > 1024  # chip_smoke.py's scan_gate: 98.82% of the first steps bit-equal at H=2048
    fwd = _hold_scan(h_seq, want[0], [o[0] for o in others], fwd_first, 2.0 ** -16, wide)
    for i, got in ((1, c_seq), (2, act)):
        _hold_scan(got.to(BF), want[i], [o[i] for o in others], fwd_first, 2.0 ** -16, wide)
    bwd = _hold_scan(dx, want[3], [o[3] for o in others], bwd_first, BWD_FLOOR, wide)
    _bf16_close(dw, lstm_ops.lstm_scan_bf16_weight_grad_ref(want[0], None, want[3], reverse), floor=BWD_FLOOR)
    print(f"scan width H={hidden} reverse={reverse}: h_seq {fwd[0]:.2e} (own {fwd[1]:.2e}), dxproj {bwd[0]:.2e} "
          f"(own {bwd[1]:.2e})")


def test_lstm_scan_forward_streams_at_batch_32(cuda):
    """The scan forward at bench.py's batch past regime (b)'s shared memory
    (H=1536, B=32: regime (c), two of each half's 12 atoms resident),
    against 8 stacked relabelled plain loops by the scan rule."""
    b, t, hidden = 32, 48, 1536
    x, w, _ = _scan_inputs(54, b, t, hidden, cuda)
    assert lstm_ops.scan_plan(b, hidden, lstm_ops._card_sms(0)).regime == "c"
    got = lstm_ops.lstm_scan_forward_cuda(x, w)[0]
    want = lstm_ops.lstm_scan_bf16_ref(x, w)
    perms = [torch.from_numpy(np.random.RandomState(k).permutation(hidden)).to(cuda) for k in range(8)]
    others = []
    for p in perms:
        cols = torch.cat([p + g * hidden for g in range(4)])
        others.append(lstm_ops.lstm_scan_bf16_ref(x[..., cols], w[p][:, cols])[..., torch.argsort(p)])
    _hold_scan(got, want, others, slice(0, SCAN_STEPS), 2.0 ** -16, own_equal=True)


def test_lstm_function_pads_once_and_strips(cuda):
    """``LSTMSequenceFn`` at H=20 on the card: h_seq, hN and cN of 20
    units, the gradients of xproj, w_hh, h0 and c0 of the unpadded shapes,
    the same as the wrappers' (which pad and strip themselves) within the
    float32 gates; one launch of each kernel."""
    xproj, w_hh, h0, c0, dy, _, _ = (torch.from_numpy(a).to(cuda) for a in _train_inputs(55, 7, 40, 20))
    leaves = [v.clone().requires_grad_() for v in (xproj, w_hh, h0, c0)]
    before = lstm_ops.launches, lstm_ops.bwd_launches, lstm_ops.dw_launches
    h_seq, hn, cn = lstm_ops.LSTMSequenceFn.apply(*leaves, False, False)
    (h_seq * dy).sum().backward()
    torch.cuda.synchronize()
    assert (lstm_ops.launches, lstm_ops.bwd_launches, lstm_ops.dw_launches) == tuple(n + 1 for n in before)
    assert h_seq.shape == (7, 40, 20) and hn.shape == cn.shape == (7, 20)
    ref = lstm_ops.lstm_sequence_train_ref(xproj, w_hh, h0, c0)
    torch.testing.assert_close(h_seq, ref[0], atol=1e-4, rtol=0)
    grads = lstm_ops.lstm_backward_ref(xproj, w_hh, h0, c0, ref[0], ref[1], dy)
    for g, v in zip((grads[0], grads[1], grads[2], grads[3]), leaves):
        assert v.grad.shape == v.shape
        torch.testing.assert_close(v.grad, g, atol=1e-4 * max(1.0, float(g.abs().max())), rtol=0)


def test_dvector_at_dim_cell_1284_on_card_matches_cpu(cuda):
    """A seeded d-vector of dim_cell 1284 (padded to 1296, regime (c) in
    float32), B=8, T=128, on the card against the CPU within 1e-4."""
    rng = np.random.RandomState(56)
    x = torch.from_numpy(rng.rand(8, 128, 80).astype(np.float32))
    cpu = build_dvector(device="cpu", seed=7, dim_cell=1284)
    card = build_dvector(device=cuda, seed=7, dim_cell=1284)
    with torch.inference_mode():
        want = cpu(x)
        got = card(x.to(cuda))
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=0)
