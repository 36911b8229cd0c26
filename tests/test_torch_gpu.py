"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here carries the ``gpu`` marker and skips without a CUDA device.
The file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest -p no:cacheprovider --noconftest -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from autovc_tpu_torch.config import WaveNetConfig
from autovc_tpu_torch.models import build_generator
from autovc_tpu_torch.ops import lstm as lstm_ops
from autovc_tpu_torch.ops import wavenet as wavenet_ops
from autovc_tpu_torch.vocoder import WaveNetVocoder

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
@pytest.mark.parametrize("b, t, hidden", [(32, 64, 32), (32, 64, 512), (32, 64, 1024), (37, 20, 64), (1, 5, 8)])
def test_lstm_kernel_matches_plain(cuda, b, t, hidden, reverse):
    """Batch 37 spans two row tiles of the kernel; batch 1 with H=8 is the
    smallest shape it takes. Tolerance 1e-4: f32 sums in another order."""
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
    assert wavenet_ops.last_cuda_launches == cond.shape[1] * (2 * cfg.layers + 1)
    assert y.shape == (b, frames * 256) and bool(torch.isfinite(y).all()) and float(y.abs().max()) <= 1.0
    y_ref, _ = wavenet_ops.generate_ref(voc.packed, cfg.dilations(), cond, u, cfg.log_scale_min)
    assert min(_first_apart(y, y_ref, 1e-4)) >= 32
    torch.testing.assert_close(logits, voc.logits(y[..., None], mel), atol=1e-3, rtol=0)


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
