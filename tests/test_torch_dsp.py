"""The port's feature extraction (autovc_tpu_torch.dsp, ops.mel, ops.sosfilt
and cli.make_spect) against the JAX package's, on the CPU.

Both packages run in this process on the same seeded NumPy inputs. The
CUDA kernels are held against their plain versions on a card in
tests/test_torch_gpu.py.

Two facts set the tolerances below (measured by these tests on p225_003):
- The 30 Hz highpass has its poles near z = 1, so the rounding of each
  filter step is amplified at low frequencies: two float32 biquad cascades
  that round differently leave outputs about 1e-4 apart. The port rounds
  as XLA compiles the JAX scan for the CPU, so its float32 highpass is the
  JAX package's bit for bit. In float64, XLA's fused multiply-adds move
  the transfer-function filtfilt 3e-7 away from scipy's C loop
  (tests/test_dsp.py:52-61 names the same floor); the port's float64 path
  is scipy's arithmetic exactly, so it is compared with scipy exactly and
  with JAX stage by stage.
- Two float32 FFTs (torch's pocketfft on the CPU, XLA's for JAX, cuFFT on the card)
  round at about 1e-6 of the frame's largest |bin|, which the dB step
  turns into 0.0869 * 1e-6 * (peak / |bin|) of a feature. So the
  unprojected |STFT| features ('stft', 'legacy') are held to 1e-4 in bins
  within 40 dB of their frame's loudest (0.4 in feature units, where that
  product is 1e-5; 1.2e-5 measured), and below that to 1e-4 times 10 for
  each further 20 dB (``stft_tolerance``). The mel projection averages the
  quiet bins away ('spmel' 6e-6 everywhere).
"""

import os
import zlib

import numpy as np
import pytest
import scipy.signal
import torch

import jax.numpy as jnp
from jax import enable_x64

import autovc_tpu.dsp as jdsp
import autovc_tpu.dsp.features as jfeatures
import autovc_tpu.dsp.filters as jfilters
from autovc_tpu.cli import make_spect as jax_make_spect
from autovc_tpu.config import AudioConfig as JaxAudioConfig
from autovc_tpu.ops.pallas_mel import mel_normalize as jax_mel_normalize
import autovc_tpu_torch.dsp as pdsp
from autovc_tpu_torch.cli import make_spect
from autovc_tpu_torch.config import AudioConfig
from autovc_tpu_torch.ops import mel as mel_ops
from autovc_tpu_torch.ops import sosfilt as sosfilt_ops

torch.set_num_threads(1)

GOLDENS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens", "stft_ref")
F32_TOL = 1e-4  # the float32 front end against JAX's (spmel, wav; stft/legacy near their frame's peak)
NEAR_PEAK = 0.4  # 40 dB in feature units
F64_TOL = 1e-9  # the float64 front end against JAX's, the same filtered waveform on both sides
MODEL_TYPES = ("spmel", "stft", "legacy", "wav")


def _golden_wav():
    wav = np.load(os.path.join(GOLDENS, "p225_003.npz"))["wav"]
    return wav, jdsp.dither_reference(wav.shape[0], 225, 0)


def stft_tolerance(want):
    """Per bin of (..., T, bins) dB features: F32_TOL within 40 dB of the
    frame's loudest bin, 10x more for each further 20 dB (module docstring)."""
    below = np.clip(want.max(axis=-1, keepdims=True) - want - NEAR_PEAK, 0.0, None)
    return F32_TOL * 10.0 ** (5.0 * below)


def _np(t):
    return np.asarray(t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else t)


# ---------------------------------------------------------------- constants

@pytest.mark.parametrize("name", ["mel_filterbank", "mel_filterbank_f64", "mel_filterbank_legacy", "hz_to_mel",
                                  "mel_to_hz", "hann_window", "hann_window_f64", "butter_highpass",
                                  "butter_highpass_sos", "lfilter_zi", "dither_reference"])
def test_host_constants_equal_jax_bit_for_bit(name):
    mels = np.linspace(0.0, 40.0, 97)
    hz = np.linspace(0.0, 8000.0, 101)
    b, a = jdsp.butter_highpass()
    cases = {
        "mel_filterbank": lambda m: m.mel_filterbank(),
        "mel_filterbank_f64": lambda m: m.mel_filterbank(16_000, 1024, 80, 90.0, 7600.0, dtype=np.float64),
        "mel_filterbank_legacy": lambda m: m.mel_filterbank(16_000, 512, 40, 0.0, 8000.0),
        "hz_to_mel": lambda m: m.hz_to_mel(hz),
        "mel_to_hz": lambda m: m.mel_to_hz(mels),
        "hann_window": lambda m: m.hann_window(1024),
        "hann_window_f64": lambda m: m.hann_window(512, dtype=np.float64),
        "butter_highpass": lambda m: np.concatenate(m.butter_highpass(30.0, 16_000, 5)),
        "butter_highpass_sos": lambda m: m.butter_highpass_sos(30.0, 16_000, 5),
        "lfilter_zi": lambda m: m.lfilter_zi(b, a),
        "dither_reference": lambda m: m.dither_reference(5000, 225, n_prior=1234),
    }
    got, want = cases[name](pdsp), cases[name](jdsp)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_audio_config_matches_jax():
    port, jax_cfg = AudioConfig(), JaxAudioConfig()
    for field in JaxAudioConfig.__dataclass_fields__:
        assert getattr(port, field) == getattr(jax_cfg, field), field
    assert (port.n_stft_bins, port.n_legacy_bins) == (513, 257)


def test_wav_round_trip_reads_as_jax_reads(tmp_path):
    x = (np.random.RandomState(0).rand(1600) * 1.8 - 0.9).astype(np.float32)
    path = str(tmp_path / "a.wav")
    pdsp.write_wav(path, x)
    got, sr = pdsp.read_wav(path)
    want, _ = jdsp.read_wav(path)
    assert sr == 16_000 and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    # written as round(x * 32767), read as / 32768: within (|x| + 0.5) / 32768
    np.testing.assert_allclose(got, x, atol=1.5 / 32768)
    with pytest.raises(ValueError):
        pdsp.read_wav(path, expected_sr=22_050)


# ------------------------------------------------------------------ filters

@pytest.mark.parametrize("shape", [(3, 2000), (2, 19)])
def test_sos_filtfilt_float32_matches_jax(shape):
    """(2, 19): one sample above padlen 18. Tolerance 1e-5 of the max-abs,
    which only the same rounding meets (module docstring)."""
    x = np.random.RandomState(1).randn(*shape).astype(np.float32)
    sos = jdsp.butter_highpass_sos()
    got = pdsp.sos_filtfilt(sos, torch.from_numpy(x))
    want = np.asarray(jdsp.sos_filtfilt(sos, jnp.asarray(x)))
    assert got.dtype == torch.float32 and got.shape == shape
    np.testing.assert_allclose(_np(got), want, atol=1e-5 * np.abs(want).max(), rtol=0)


def test_sosfilt_pass_matches_jax_scan():
    """One pass of the cascade from a nonzero state: ops.sosfilt (the plain
    version on the CPU) against the JAX scan ``_sosfilt``, at 1e-5 of the
    max-abs."""
    rng = np.random.RandomState(2)
    sos = jdsp.butter_highpass_sos().astype(np.float32)
    x = rng.randn(3, 500).astype(np.float32)
    zi = (rng.randn(3, 3, 2) * 0.1).astype(np.float32)
    want = np.asarray(jfilters._sosfilt(jnp.asarray(sos), jnp.asarray(x), jnp.asarray(zi)))
    before = sosfilt_ops.launches
    got = sosfilt_ops.sosfilt(torch.from_numpy(sos), torch.from_numpy(x), torch.from_numpy(zi))
    assert sosfilt_ops.launches == before  # the CPU runs the plain version, no kernel
    np.testing.assert_allclose(_np(got), want, atol=1e-5 * np.abs(want).max(), rtol=0)


def test_filters_raise_at_padlen():
    sos = jdsp.butter_highpass_sos()
    b, a = jdsp.butter_highpass()
    x = torch.zeros(2, 18, dtype=torch.float64)
    with pytest.raises(ValueError, match="padlen 18"):
        pdsp.sos_filtfilt(sos, x.float())
    with pytest.raises(ValueError, match="padlen 18"):
        pdsp.filtfilt(b, a, x)
    with pytest.raises(ValueError):  # the JAX package raises at the same length
        jdsp.sos_filtfilt(sos, jnp.zeros((2, 18), jnp.float32))


def test_filtfilt_float64_equals_scipy_and_matches_jax():
    """The port's transfer-function filtfilt is scipy's arithmetic bit for
    bit; JAX's sits 8e-7 from both (its fused multiply-adds), within 1e-6
    of the max-abs, the floor tests/test_dsp.py:52-61 names."""
    x = np.random.RandomState(3).randn(2, 3000)
    b, a = jdsp.butter_highpass()
    got = _np(pdsp.filtfilt(b, a, torch.from_numpy(x)))
    np.testing.assert_array_equal(got, scipy.signal.filtfilt(b, a, x))
    with enable_x64():
        want = np.asarray(jdsp.filtfilt(b, a, jnp.asarray(x)))
    np.testing.assert_allclose(got, want, atol=1e-6 * np.abs(want).max(), rtol=0)


def test_lfilter_float64_equals_scipy_and_matches_jax():
    rng = np.random.RandomState(4)
    x = rng.randn(2, 1500)
    b, a = jdsp.butter_highpass()
    zi = np.tile(jdsp.lfilter_zi(b, a), (2, 1)) * rng.randn(2, 1)
    y, zf = pdsp.lfilter(b, a, torch.from_numpy(x), torch.from_numpy(zi))
    sy, szf = scipy.signal.lfilter(b, a, x, zi=zi)
    np.testing.assert_array_equal(_np(y), sy)
    np.testing.assert_array_equal(_np(zf), szf)
    with enable_x64():
        jy, jzf = jdsp.lfilter(b, a, jnp.asarray(x), jnp.asarray(zi))
    np.testing.assert_allclose(_np(y), np.asarray(jy), atol=1e-6 * np.abs(sy).max(), rtol=0)
    np.testing.assert_allclose(_np(zf), np.asarray(jzf), atol=1e-6 * np.abs(szf).max(), rtol=0)


def test_host_paths_refuse_other_devices():
    """The float64 transfer-function form runs on the CPU only, and each
    wrapper runs on a CUDA or a CPU tensor, nothing else."""
    b, a = jdsp.butter_highpass()
    meta = torch.empty(2, 100, dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="CPU only"):
        pdsp.lfilter(b, a, meta)
    with pytest.raises(ValueError, match="CPU only"):
        pdsp.filtfilt(b, a, meta)
    with pytest.raises(ValueError, match="cuda or cpu"):
        sosfilt_ops.sosfilt(torch.empty(3, 6, device="meta"), meta.float(), torch.empty(2, 3, 2, device="meta"))
    with pytest.raises(ValueError, match="cuda or cpu"):
        mel_ops.mel_normalize(torch.empty(4, 513, device="meta"), torch.empty(513, 80, device="meta"))


def test_kernel_wrappers_check_before_building():
    """On CPU tensors the CUDA wrappers raise (no fallback to the plain
    versions), and a dtype they do not take raises first."""
    sos = torch.from_numpy(jdsp.butter_highpass_sos().astype(np.float32))
    x, zi = torch.zeros(2, 100), torch.zeros(2, 3, 2)
    with pytest.raises(ValueError, match="CUDA"):
        sosfilt_ops.sosfilt_cuda(sos, x, zi)
    with pytest.raises(TypeError, match="float32"):
        sosfilt_ops.sosfilt_cuda(sos, x.double(), zi)
    with pytest.raises(ValueError, match=r"zi \(B, S, 2\)"):
        sosfilt_ops.sosfilt_cuda(sos, x, torch.zeros(2, 2, 2))
    mag, basis = torch.zeros(5, 513), torch.zeros(513, 80)
    with pytest.raises(ValueError, match="CUDA"):
        mel_ops.mel_normalize_cuda(mag, basis)
    with pytest.raises(TypeError, match="float32"):
        mel_ops.mel_normalize_cuda(mag.double(), basis)
    with pytest.raises(ValueError, match="contiguous"):
        mel_ops.mel_normalize_cuda(torch.zeros(513, 5).T, basis)
    with pytest.raises(ValueError, match="n_bins"):
        mel_ops.mel_normalize_cuda(mag, torch.zeros(512, 80))


# --------------------------------------------------------------------- STFT

@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("length", [300, 4096, 40960])
def test_frames_and_stft_magnitude_match_jax(length, dtype):
    """L=300 is shorter than the 512-sample pad: the reflection folds. The
    frames are equal; |STFT| within 1e-6 of its max in float32 (two FFTs'
    rounding, about 2e-7 measured) and 1e-10 in float64."""
    x = np.random.RandomState(length).randn(length).astype(dtype)
    with enable_x64():
        jframes = np.asarray(jdsp.frame_signal(jnp.asarray(x)))
        jmag = np.array(jdsp.stft_magnitude(jnp.asarray(x)))
    frames = _np(pdsp.frame_signal(torch.from_numpy(x)))
    mag = _np(pdsp.stft_magnitude(torch.from_numpy(x)))
    assert frames.dtype == jframes.dtype == np.dtype(dtype) and mag.shape == jmag.shape
    np.testing.assert_array_equal(frames, jframes)
    tol = 1e-6 * np.abs(jmag).max() if dtype == "float32" else 1e-10
    np.testing.assert_allclose(mag, jmag, atol=tol, rtol=0)


@pytest.mark.parametrize("length", [1, 2, 5])
def test_reflect_padding_folds_like_numpy(length):
    """Pads far longer than the signal, where torch's reflect pad refuses."""
    x = np.random.RandomState(5).randn(length)
    got = _np(pdsp.frame_signal(torch.from_numpy(x)))
    ref = np.pad(x, 512, mode="reflect")
    idx = np.arange(got.shape[0])[:, None] * 256 + np.arange(1024)[None, :]
    np.testing.assert_array_equal(got, ref[idx])


@pytest.mark.parametrize("length", [None, 17 * 256, 17 * 256 + 1000])
def test_istft_matches_jax(length):
    """T = 17 frames (not a multiple of the overlap 4); the requested length
    past the WOLA buffer is zero-filled. Tolerance 1e-4 on the overlap-add
    sum, the output times the window sum it was divided by: in the last
    half frame that sum falls toward 0 and magnifies the two inverse FFTs'
    rounding (3 of 5352 samples 2.5e-3 apart)."""
    x = np.random.RandomState(6).randn(16 * 256).astype(np.float32) * 0.3
    spec = np.array(jdsp.stft_complex(jnp.asarray(x)))
    want = np.asarray(jdsp.istft(jnp.asarray(spec), length=length))
    got = _np(pdsp.istft(torch.from_numpy(spec), length=length))
    assert got.shape == want.shape
    w2 = jdsp.hann_window(1024).astype(np.float64) ** 2
    wsum = np.zeros(1024 + 16 * 256 + 1024)
    for i in range(17):
        wsum[i * 256 : i * 256 + 1024] += w2
    wsum = wsum[512 : 512 + got.shape[0]]
    np.testing.assert_allclose(got * wsum, want * wsum, atol=1e-4, rtol=0)
    loud = wsum > 0.1
    np.testing.assert_allclose(got[loud], want[loud], atol=1e-4, rtol=0)
    if length is not None and length > 16 * 256 + 512:
        assert not got[16 * 256 + 512 :].any()


def test_griffin_lim_from_a_given_phase_matches_jax():
    rng = np.random.RandomState(7)
    x = rng.randn(8 * 256).astype(np.float32) * 0.3
    mag = np.array(jdsp.stft_magnitude(jnp.asarray(x)))
    phase = np.exp(2j * np.pi * rng.rand(*mag.shape)).astype(np.complex64)
    want = np.asarray(jdsp.griffin_lim(jnp.asarray(mag), n_iter=4, init_phase=jnp.asarray(phase)))
    got = _np(pdsp.griffin_lim(torch.from_numpy(mag), n_iter=4, init_phase=torch.from_numpy(phase)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    # a random start from a seeded generator: the same waveform twice
    a = pdsp.griffin_lim(torch.from_numpy(mag), n_iter=2, generator=torch.Generator().manual_seed(3))
    b = pdsp.griffin_lim(torch.from_numpy(mag), n_iter=2, generator=torch.Generator().manual_seed(3))
    assert torch.equal(a, b) and a.shape == (8 * 256,)


# ------------------------------------------------------------ mel and dB

def test_mel_normalize_ref_matches_pallas_kernel_in_interpret_mode():
    """The plain version against JAX ``mel_normalize`` (the Pallas kernel in
    interpret mode) on (161, 513) magnitudes of real speech, at 1e-6."""
    wav, _ = _golden_wav()
    mag = np.array(jdsp.stft_magnitude(jnp.asarray(wav[:40960], jnp.float32)))
    basis = jdsp.mel_filterbank()
    want = np.asarray(jax_mel_normalize(jnp.asarray(mag), jnp.asarray(basis), interpret=True))
    got = mel_ops.mel_normalize_ref(torch.from_numpy(mag), torch.from_numpy(basis))
    assert got.shape == want.shape == (161, 80)
    np.testing.assert_allclose(_np(got), want, atol=1e-6, rtol=0)
    before = mel_ops.launches
    assert torch.equal(mel_ops.mel_normalize(torch.from_numpy(mag), torch.from_numpy(basis)), got)
    assert mel_ops.launches == before


@pytest.mark.parametrize("n_bins, n_mels, t", [(513, 80, 1), (257, 80, 37), (513, 80, 300)])
def test_mel_normalize_ref_matches_jax_features(n_bins, n_mels, t):
    """Against the JAX front end's own arithmetic (mel_from_stft_mag +
    normalize_db), with both clips engaged, at 1e-6."""
    rng = np.random.RandomState(t)
    mag = (rng.rand(t, n_bins) ** 4 * 200.0).astype(np.float32)
    basis = jdsp.mel_filterbank(16_000, 2 * (n_bins - 1), n_mels)
    want = np.asarray(jdsp.normalize_db(jfeatures.mel_from_stft_mag(jnp.asarray(mag), jnp.asarray(basis))))
    got = _np(mel_ops.mel_normalize(torch.from_numpy(mag), torch.from_numpy(basis)))
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    np.testing.assert_allclose(_np(pdsp.mel_from_stft_mag(torch.from_numpy(mag), basis)),
                               np.asarray(jfeatures.mel_from_stft_mag(jnp.asarray(mag), jnp.asarray(basis))),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("n_fft, nnz, widest", [(1024, 941, 34), (512, 471, 17)])
def test_filter_spans_cover_each_filter_and_keep_the_product(n_fft, nnz, widest):
    """The spans of the spmel (513-bin) and legacy (257-bin) bases: each
    column's first and last nonzero, at most 34 bins wide. A float64 chain
    over each filter's span in increasing bin order equals the chain over
    all bins exactly (the skipped products are exact zeros)."""
    basis = jdsp.mel_filterbank(16_000, n_fft, 80, dtype=np.float64)
    spans = _np(mel_ops.filter_spans(torch.from_numpy(basis)))
    assert spans.dtype == np.int32 and spans.shape == (80, 2)
    nz = basis != 0
    assert nz.sum() == nnz and (spans[:, 1] - spans[:, 0]).max() == widest
    for j in range(80):
        rows = np.flatnonzero(nz[:, j])
        assert tuple(spans[j]) == (rows[0], rows[-1] + 1), j
    mag = np.random.RandomState(n_fft).rand(20, basis.shape[0]) ** 4 * 200.0
    dense = np.zeros((20, 80))
    for k in range(basis.shape[0]):
        dense = dense + mag[:, k : k + 1] * basis[k]
    span = np.zeros((20, 80))
    for j, (lo, hi) in enumerate(spans):
        for k in range(lo, hi):
            span[:, j] = span[:, j] + mag[:, k] * basis[k, j]
    np.testing.assert_array_equal(span, dense)


def test_filter_spans_of_dense_empty_and_gapped_columns():
    """Any basis: a dense column spans every bin, a column of zeros gets
    (0, 0), zeros between two nonzeros stay inside the span."""
    basis = np.zeros((10, 4), np.float32)
    basis[:, 0] = 1.0 + np.arange(10)
    basis[[3, 7], 2] = 0.5
    basis[9, 3] = 2.0
    spans = _np(mel_ops.filter_spans(torch.from_numpy(basis)))
    np.testing.assert_array_equal(spans, [[0, 10], [0, 0], [3, 8], [9, 10]])


@pytest.mark.parametrize("t, n_bins, n_mels, blocks, weights, smem", [
    (311, 513, 80, 10, 1024, 81_104), (16_416, 513, 80, 513, 1024, 81_104), (1, 257, 80, 1, 1024, 48_336),
    (70, 1025, 80, 3, 1025, 4 * (32 * 1025 + 1025 + 32 * 81 + 241) + 8)])
def test_mel_tile_plan(t, n_bins, n_mels, blocks, weights, smem):
    """32 frames a block (a 4.97-s file's 311 frames: 10 blocks), every mel,
    the packed weights at least one dense column, shared memory as the
    kernel lays it out."""
    plan = mel_ops.tile_plan(t, n_bins, n_mels)
    assert (plan.frames, plan.threads) == (mel_ops.TILE_FRAMES, mel_ops.THREADS) == (32, 640)
    assert (plan.blocks, plan.weights, plan.smem) == (blocks, weights, smem)
    assert plan.smem <= mel_ops.SMEM_MAX
    with pytest.raises(ValueError, match="shared memory"):
        mel_ops.tile_plan(t, 513, 2048)


def test_normalize_and_denormalize_db_match_jax():
    s = np.random.RandomState(8).rand(50, 80).astype(np.float32)
    m = np.asarray(jdsp.denormalize_db(jnp.asarray(s)))
    np.testing.assert_allclose(_np(pdsp.denormalize_db(torch.from_numpy(s))), m, rtol=1e-6)
    mags = np.concatenate([m, np.full((1, 80), 1e-7, np.float32), np.full((1, 80), 1e3, np.float32)])
    np.testing.assert_allclose(_np(pdsp.normalize_db(torch.from_numpy(mags))),
                               np.asarray(jdsp.normalize_db(jnp.asarray(mags))), atol=1e-6, rtol=0)


@pytest.mark.parametrize("shape", [(1000,), (1001,), (2, 999)])
def test_robust_scale_matches_jax(shape):
    """Even and odd lengths: the median is the midpoint, as jnp.median's."""
    x = np.random.RandomState(9).randn(*shape).astype(np.float32)
    want = np.asarray(jdsp.robust_scale(jnp.asarray(x)))
    np.testing.assert_allclose(_np(pdsp.robust_scale(torch.from_numpy(x))), want, atol=1e-6, rtol=0)


# --------------------------------------------------------------- front end

@pytest.mark.parametrize("model_type", MODEL_TYPES)
def test_mel_frontend_float32_matches_jax(model_type):
    """The float32 front end on the CPU (the plain versions of both kernels)
    against JAX's on the golden wav of p225_003 with its dither."""
    wav, noise = _golden_wav()
    fe = pdsp.MelFrontend(AudioConfig(), device="cpu")
    got = _np(fe.extract(model_type, wav, noise.astype(np.float32)))
    want = np.asarray(jdsp.MelFrontend(JaxAudioConfig()).extract(
        model_type, jnp.asarray(wav), jnp.asarray(noise, jnp.float32)))
    assert got.dtype == np.float32 and got.shape == want.shape
    err = np.abs(got - want)
    tol = stft_tolerance(want) if model_type in ("stft", "legacy") else F32_TOL
    assert (err <= tol).all(), (err.max(), (err / tol).max())


@pytest.mark.parametrize("model_type", MODEL_TYPES)
def test_mel_frontend_float64_matches_jax(model_type, monkeypatch):
    """float64 on p225_003. Stage by stage at 1e-9: the JAX front end with
    its transfer-function filter given scipy's arithmetic, which the port's
    is bit for bit. Whole chain: JAX's own filter leaves the features
    within the gate its golden tests use between two IIR implementations
    (tests/test_dsp.py:211-213)."""
    wav, noise = _golden_wav()
    got = _np(pdsp.MelFrontend(AudioConfig(), dtype=torch.float64, device="cpu").extract(model_type, wav, noise))
    assert got.dtype == np.float64
    with enable_x64():
        jfe = jdsp.MelFrontend(JaxAudioConfig(), dtype=jnp.float64)
        whole = np.asarray(jfe.extract(model_type, jnp.asarray(wav, jnp.float64), noise))
        monkeypatch.setattr(jfeatures, "filtfilt",
                            lambda b, a, x: jnp.asarray(scipy.signal.filtfilt(b, a, np.asarray(x))))
        staged = np.asarray(jfe.extract(model_type, jnp.asarray(wav, jnp.float64), noise))
    np.testing.assert_allclose(got, staged, atol=F64_TOL, rtol=0)
    err = np.abs(got - whole)
    assert err.mean() < 5e-6 and err.max() < 5e-2
    assert model_type == "wav" or err[whole > 0.4].max() < 2e-3


def test_float64_stft_and_db_match_golden_stft_iso():
    """The port's float64 STFT + dB on the golden's own filtered waveform
    against the reference's pySTFT + dB (the gate of tests/test_dsp.py:186-192)."""
    z = np.load(os.path.join(GOLDENS, "p225_003.npz"))
    mag = pdsp.stft_magnitude(torch.from_numpy(z["wav"].astype(np.float64)), 1024, 256)
    iso = _np(pdsp.normalize_db(mag, 16.0, -100.0)).astype(np.float32)
    assert z["stft_iso"].shape == (513, iso.shape[0])
    assert np.abs(iso - z["stft_iso"].T).max() < 1e-6


def test_mel_frontend_batches_rows():
    """A (2, L) batch gives each row's features (the mel step is one call
    over every frame of the batch)."""
    wav, noise = _golden_wav()
    fe = pdsp.MelFrontend(AudioConfig(), device="cpu")
    rows = np.stack([wav[:8000], wav[8000:16000]])
    both = _np(fe.mel_features(rows))
    assert both.shape == (2, 32, 80)
    for i in range(2):
        np.testing.assert_array_equal(both[i], _np(fe.mel_features(rows[i])))


def test_mel_frontend_device_and_dtype_rules():
    """cuda by default (raises without a card: no CPU fallback); float64 is
    the CPU's; other dtypes are refused."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card: tests/test_torch_gpu.py covers it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pdsp.MelFrontend()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pdsp.MelFrontend(dtype=torch.float64, device="cuda")
    with pytest.raises(TypeError):
        pdsp.MelFrontend(dtype=torch.float16, device="cpu")
    with pytest.raises(ValueError, match="unknown model_type"):
        pdsp.MelFrontend(device="cpu").extract("mfcc", np.zeros(1000, np.float32))


# --------------------------------------------------------------------- CLI

def _corpus(root, speakers=("p101", "p202"), n_utts=2, seed=0):
    """2 speakers x 2 utterances of 0.5 s (tones, noise and a gap), written
    with the port's write_wav, plus a mic1 file the CLI must skip."""
    rng = np.random.RandomState(seed)
    t = np.arange(8000) / 16_000.0
    for s, spk in enumerate(speakers):
        d = os.path.join(root, "wavs", spk)
        os.makedirs(d)
        for u in range(n_utts):
            f0 = 110.0 + 40 * s + 15 * u
            x = sum(0.2 / k * np.sin(2 * np.pi * k * f0 * t + rng.rand()) for k in range(1, 8))
            x = x + 0.01 * rng.randn(t.size)
            x[3000:4200] = 0.0
            pdsp.write_wav(os.path.join(d, f"{spk}_{u:03d}.wav"), x)
        pdsp.write_wav(os.path.join(d, f"{spk}_000_mic1.wav"), np.zeros(800))
    return root


def _outputs(root, model_type="spmel"):
    out = {}
    base = os.path.join(root, model_type)
    for spk in sorted(os.listdir(base)):
        for f in sorted(os.listdir(os.path.join(base, spk))):
            out[f"{spk}/{f}"] = np.load(os.path.join(base, spk, f))
    return out


def test_make_spect_cpu_matches_jax_device_path(tmp_path):
    """``--device cpu`` (the float32 front end with the plain versions)
    against the JAX CLI's float32 ``--device`` path (its ``extract_all``,
    which ``main([..., "--device"])`` calls), at 1e-4."""
    port_root = _corpus(str(tmp_path / "port"))
    jax_root = _corpus(str(tmp_path / "jax"))
    written = make_spect.main(["--main_dir", port_root, "--device", "cpu"])
    jax_make_spect.extract_all(jax_root, use_device=True)
    got, want = _outputs(port_root), _outputs(jax_root)
    assert len(written) == 4 and sorted(got) == sorted(want)
    assert not any("mic1" in k for k in got)  # the excluded microphone (make_spect.py:70)
    for key in want:
        assert got[key].dtype == np.float32 and got[key].shape == want[key].shape == (32, 80)
        np.testing.assert_allclose(got[key], want[key], atol=F32_TOL, rtol=0)


@pytest.mark.parametrize("model_type", MODEL_TYPES)
def test_make_spect_exact_matches_jax_default_path(tmp_path, model_type):
    """``--exact`` against the JAX CLI's default host chain at 1e-7; no
    kernel runs and ``--device`` is ignored."""
    port_root = _corpus(str(tmp_path / "port"))
    jax_root = _corpus(str(tmp_path / "jax"))
    before = (mel_ops.launches, sosfilt_ops.launches)
    make_spect.main(["--main_dir", port_root, "--model_type", model_type, "--exact", "--device", "cuda"])
    assert (mel_ops.launches, sosfilt_ops.launches) == before
    jax_make_spect.extract_all(jax_root, model_type=model_type)
    got, want = _outputs(port_root, model_type), _outputs(jax_root, model_type)
    assert sorted(got) == sorted(want) and len(got) == 4
    for key in want:
        assert got[key].dtype == np.float32 and got[key].shape == want[key].shape
        np.testing.assert_allclose(got[key], want[key], atol=1e-7, rtol=0)


def test_make_spect_digitless_speaker_gets_crc32_seed(tmp_path):
    """A speaker directory without digits seeds its dither with crc32 of its
    name: the exact chain with that seed, and the same files as JAX's."""
    root = _corpus(str(tmp_path / "port"), speakers=("alice",), n_utts=1)
    jax_root = _corpus(str(tmp_path / "jax"), speakers=("alice",), n_utts=1)
    assert make_spect.speaker_seed("alice") == zlib.crc32(b"alice") % (2**31)
    assert make_spect.speaker_seed("p225") == 225
    make_spect.main(["--main_dir", root, "--exact"])
    jax_make_spect.extract_all(jax_root)
    got = _outputs(root)["alice/alice_000.npy"]
    np.testing.assert_allclose(got, _outputs(jax_root)["alice/alice_000.npy"], atol=1e-7, rtol=0)
    x, _ = pdsp.read_wav(os.path.join(root, "wavs", "alice", "alice_000.wav"))
    noise = (np.random.RandomState(zlib.crc32(b"alice") % (2**31)).rand(x.shape[0]) - 0.5) * 1e-6
    cfg = AudioConfig()
    b, a = pdsp.butter_highpass()
    want = make_spect.exact_features(x, noise, "spmel", cfg, b, a, pdsp.mel_filterbank(dtype=np.float64))
    np.testing.assert_array_equal(got, want.astype(np.float32))


def test_make_spect_defaults_to_the_card(tmp_path):
    """Without ``--device`` the CLI runs on the card, and raises without one."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card: tests/test_torch_gpu.py covers it")
    root = _corpus(str(tmp_path / "c"), n_utts=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_spect.main(["--main_dir", root])
    with pytest.raises(SystemExit):
        make_spect.main(["--main_dir", root, "--model_type", "mfcc"])
