"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here carries the ``gpu`` marker and skips without a CUDA device.
The file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest -p no:cacheprovider --noconftest -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from autovc_tpu_torch.models import build_generator
from autovc_tpu_torch.ops import lstm as lstm_ops

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
