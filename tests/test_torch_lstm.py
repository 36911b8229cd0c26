"""The port's LSTM recurrence (autovc_tpu_torch.ops.lstm) against the JAX
package's: the Pallas sequence kernel in interpret mode and the lax.scan of
models.layers. The CUDA kernel is held against the plain version on a card
in tests/test_torch_gpu.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from autovc_tpu.models.layers import _lstm_scan
from autovc_tpu.ops.pallas_lstm import lstm_sequence as jax_lstm_sequence
from autovc_tpu_torch.ops import _build
from autovc_tpu_torch.ops import lstm as lstm_ops

torch.set_num_threads(1)

ATOL = 1e-5  # f32 on both sides, as tests/test_ops.py holds the Pallas kernel


def _inputs(seed, b, t, hidden):
    rng = np.random.RandomState(seed)
    xproj = (rng.randn(b, t, 4 * hidden) * 0.5).astype(np.float32)
    bound = 1.0 / np.sqrt(hidden)
    w_hh = rng.uniform(-bound, bound, (hidden, 4 * hidden)).astype(np.float32)
    return xproj, w_hh


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("hidden", [32, 128])
def test_ref_matches_jax_pallas_interpret(hidden, reverse):
    """T=140 with chunk=128: the JAX kernel carries (h, c) across a chunk
    boundary; the port has no chunks."""
    xproj, w_hh = _inputs(0, 4, 140, hidden)
    want = jax_lstm_sequence(jnp.asarray(xproj), jnp.asarray(w_hh), reverse=reverse,
                             interpret=True, chunk=128)
    got = lstm_ops.lstm_sequence_ref(torch.from_numpy(xproj), torch.from_numpy(w_hh), reverse)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("hidden", [32, 128])
def test_ref_matches_jax_scan(hidden, reverse):
    xproj, w_hh = _inputs(1, 4, 140, hidden)
    zeros = jnp.zeros((4, hidden), jnp.float32)
    want = _lstm_scan(jnp.asarray(xproj), jnp.asarray(w_hh), zeros, zeros, reverse=reverse)
    got = lstm_ops.lstm_sequence_ref(torch.from_numpy(xproj), torch.from_numpy(w_hh), reverse)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def test_reverse_is_forward_on_flipped_time():
    xproj, w_hh = _inputs(2, 3, 17, 8)
    x, w = torch.from_numpy(xproj), torch.from_numpy(w_hh)
    rev = lstm_ops.lstm_sequence_ref(x, w, reverse=True)
    fwd_flipped = lstm_ops.lstm_sequence_ref(x.flip(1), w).flip(1)
    torch.testing.assert_close(rev, fwd_flipped, atol=0, rtol=0)


def test_cpu_tensor_takes_plain_version_without_counting():
    xproj, w_hh = _inputs(3, 2, 9, 16)
    x, w = torch.from_numpy(xproj), torch.from_numpy(w_hh)
    before = lstm_ops.launches
    got = lstm_ops.lstm_sequence(x, w, reverse=True)
    torch.testing.assert_close(got, lstm_ops.lstm_sequence_ref(x, w, reverse=True), atol=0, rtol=0)
    assert lstm_ops.launches == before


def test_other_device_raises():
    x = torch.empty((2, 3, 32), device="meta")
    w = torch.empty((8, 32), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        lstm_ops.lstm_sequence(x, w)


@pytest.mark.parametrize(
    "xshape, wshape, dtype, error",
    [
        ((2, 3, 32), (8, 32), torch.float64, TypeError),  # kernel is float32 only
        ((2, 3, 32), (8, 16), torch.float32, ValueError),  # w_hh is not (H, 4H)
        ((2, 3, 24), (6, 24), torch.float32, ValueError),  # H % 8 != 0
    ],
)
def test_kernel_wrapper_rejects_before_building(xshape, wshape, dtype, error):
    """The wrapper validates its inputs before it builds or launches."""
    with pytest.raises(error):
        lstm_ops.lstm_sequence_cuda(torch.zeros(xshape, dtype=dtype), torch.zeros(wshape, dtype=dtype))


def test_library_path_keyed_by_source_and_flags():
    path = _build.library_path("lstm_fwd")
    assert path.parent == _build.BUILD_DIR
    assert path.name.startswith("lstm_fwd-") and path.suffix == ".so"
    assert "-arch=sm_90a" in _build.NVCC_FLAGS and "-shared" in _build.NVCC_FLAGS


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "isfile", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load("lstm_fwd")
    assert not (tmp_path / "kernels").exists()
