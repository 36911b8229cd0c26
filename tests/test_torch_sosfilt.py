"""The sosfilt kernel's chunked scan, checked on the CPU: its launch plan,
its float64 tables and the scheme itself (ops.sosfilt, csrc/sosfilt.cu).

The kernel runs only on a card (tests/test_torch_gpu.py). Here its three
phases are rebuilt from the host's tables: in float64 they reproduce
scipy's sequential filter to rounding, and with chunk 0 in the kernel's
float32 cascade (the plain version) they meet the gate the card is held to:
each row no farther from the float64 filter than twice the sequential
float32 pass, plus 1e-6 of the row's max-abs, and chunk 0 bit for bit the
sequential pass.
"""

import numpy as np
import pytest
import scipy.signal
import torch

from autovc_tpu_torch.dsp import butter_highpass_sos
from autovc_tpu_torch.ops import sosfilt as sosfilt_ops

torch.set_num_threads(1)

SOS64 = butter_highpass_sos()
SOS32 = SOS64.astype(np.float32)  # what the kernel is given; its tables come from these values
SMEM_MAX = 232_448  # bytes of shared memory one block may use on sm_90


@pytest.mark.parametrize("length, chunk, chunks, threads, levels", [
    (1, 32, 1, 32, 0), (19, 32, 1, 32, 0), (31, 32, 1, 32, 0), (32, 32, 1, 32, 0), (33, 32, 2, 32, 1),
    (32 * 512, 32, 512, 512, 9), (32 * 512 + 1, 36, 456, 480, 9), (80_036, 160, 501, 512, 9),
    (131_072 + 36, 260, 505, 512, 9)])
def test_scan_plan_cuts_a_row_into_chunks(length, chunk, chunks, threads, levels):
    """One chunk a thread, at least MIN_CHUNK samples each (a row of up to
    32 is one chunk: the sequential pass) and a multiple of 4 (whole 16-byte
    copies), at most 512 threads; the chunks cover the row and none is
    empty; the scan's levels reach every chunk."""
    plan = sosfilt_ops.scan_plan(length)
    assert (plan.chunk, plan.chunks, plan.threads, plan.levels) == (chunk, chunks, threads, levels)
    assert plan.chunk % 4 == 0 and (plan.chunks - 1) * plan.chunk < length <= plan.chunks * plan.chunk
    assert plan.threads % 32 == 0 and plan.chunks <= plan.threads <= sosfilt_ops.MAX_THREADS
    assert 2 ** plan.levels >= plan.chunks and (plan.levels == 0 or 2 ** (plan.levels - 1) < plan.chunks)
    assert plan.smem <= SMEM_MAX


def test_scan_plan_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="at least one sample"):
        sosfilt_ops.scan_plan(0)
    with pytest.raises(ValueError, match="1 to 4 sections"):
        sosfilt_ops.scan_plan(100, sections=5)
    assert sosfilt_ops.scan_plan(10**6, sections=4).smem <= SMEM_MAX


@pytest.mark.parametrize("chunk", [1, 32, 79])
def test_scan_tables_are_the_recurrence_in_float64(chunk):
    """``response`` maps a chunk's samples to its end state from zero and
    ``powers[j]`` carries a state across 2^j chunks, both as scipy's
    sequential filter does, to 1e-10 of the scale of their terms (the
    states are sums of terms up to ~100x larger that cancel; 7e-12
    measured)."""
    rng = np.random.RandomState(chunk)
    sos = SOS32.astype(np.float64)
    powers, response = sosfilt_ops.scan_tables(sos, chunk, 3)
    assert powers.shape == (3, 6, 6) and response.shape == (chunk, 6)
    x = rng.randn(chunk)
    _, zf = scipy.signal.sosfilt(sos, x, zi=np.zeros((3, 2)))
    np.testing.assert_allclose(x @ response, zf.ravel(), rtol=0, atol=1e-10 * (np.abs(x) @ np.abs(response)).max())
    z = rng.randn(3, 2)
    for j in range(3):
        _, zf = scipy.signal.sosfilt(sos, np.zeros(chunk * 2**j), zi=z)
        np.testing.assert_allclose(powers[j] @ z.ravel(), zf.ravel(), rtol=0,
                                   atol=1e-10 * (np.abs(powers[j]) @ np.abs(z.ravel())).max())


def _signal(rng, length):
    """A voiced row as the front end's highpass sees it: a low fundamental
    and its harmonics, a DC offset, noise and a silent gap."""
    t = np.arange(length) / 16_000.0
    f0 = 110.0 * (1.0 + 0.1 * np.sin(2 * np.pi * 0.8 * t))
    phase = 2 * np.pi * np.cumsum(f0) / 16_000.0
    x = sum(0.4 / k * np.sin(k * phase) for k in range(1, 6)) + 0.05 + 0.003 * rng.randn(length)
    x[length // 3 : length // 3 + length // 10] = 0.0
    return x


def _chunked(x, zi, phase3):
    """The kernel's three phases on one row: e_k = x_k @ response (chunk 0
    plus M zi), the Kogge-Stone scan of the carries in float64 level by
    level, then ``phase3(chunks (n, C) zero-padded, start states (n, S, 2))``."""
    plan = sosfilt_ops.scan_plan(x.shape[0])
    c, n = plan.chunk, plan.chunks
    powers, response = sosfilt_ops.scan_tables(SOS32.astype(np.float64), c, max(plan.levels, 1))
    rows = np.zeros((n, c))
    rows.reshape(-1)[: x.shape[0]] = x
    carry = rows @ response
    carry[0] += powers[0] @ zi.ravel()
    for j in range(plan.levels):
        d = 2**j
        carry[d:] = carry[d:] + carry[:-d] @ powers[j].T
    starts = np.concatenate([zi[None], carry[:-1].reshape(n - 1, 3, 2)])
    return phase3(rows, starts).reshape(-1)[: x.shape[0]], c


@pytest.mark.parametrize("length", [33, 500, 4096, 80_036])
def test_chunked_scan_in_float64_is_the_sequential_filter(length):
    """Phases 1 and 3 through scipy's sosfilt with each chunk's state, phase 2
    as the kernel orders it: scipy's float64 filter of the whole row from a
    nonzero zi, to 1e-9 of the row's max-abs. (Against the same recurrence
    in extended precision, scipy's sequential filter is 1e-13 of the row's
    max-abs off and this scheme 4e-11, its carries being sums of terms up
    to ~100x larger that cancel: either far below the float32 rounding, 6e-8,
    of the start states the card runs phase 3 from.)"""
    rng = np.random.RandomState(length)
    sos = SOS32.astype(np.float64)
    x = _signal(rng, length)
    zi = rng.randn(3, 2) * 0.1
    plan = sosfilt_ops.scan_plan(length)
    rows = np.zeros((plan.chunks, plan.chunk))  # the last chunk padded with zeros, as the kernel's tables see it
    rows.reshape(-1)[:length] = x
    ends = np.stack([scipy.signal.sosfilt(sos, r, zi=np.zeros((3, 2)))[1].ravel() for r in rows])
    response = sosfilt_ops.scan_tables(sos, plan.chunk, 1)[1]
    np.testing.assert_allclose(rows @ response, ends, rtol=0, atol=1e-10 * (np.abs(rows) @ np.abs(response)).max())
    got, _ = _chunked(x, zi, lambda rows, starts: np.stack(
        [scipy.signal.sosfilt(sos, r, zi=z)[0] for r, z in zip(rows, starts)]))
    want = scipy.signal.sosfilt(sos, x, zi=zi)[0]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9 * np.abs(want).max())


@pytest.mark.parametrize("length", [4096, 80_036])
def test_chunked_scan_meets_the_card_gate(length):
    """Phase 3 as the kernel runs it: chunk 0 from zi in the plain version's
    float32 arithmetic, the others from their float64 carries in float64
    (scipy's filter), each output rounded to float32; on a row as
    sos_filtfilt feeds the pass (the steady state scaled by the first
    sample). Chunk 0 is the sequential float32 pass bit for bit, and the row
    is no farther from the float64 filter than twice that pass, plus 1e-6 of
    its max-abs."""
    rng = np.random.RandomState(length + 1)
    x = _signal(rng, length).astype(np.float32)
    zi = (scipy.signal.sosfilt_zi(SOS64) * x[0]).astype(np.float32)
    sos_t = torch.from_numpy(SOS32)
    sos = SOS32.astype(np.float64)

    def phase3(rows, starts):
        first = sosfilt_ops.sosfilt_ref(sos_t, torch.from_numpy(rows[:1].astype(np.float32)),
                                        torch.from_numpy(starts[:1].astype(np.float32))).double().numpy()
        rest = [scipy.signal.sosfilt(sos, r, zi=z)[0] for r, z in zip(rows[1:], starts[1:])]
        return np.concatenate([first] + [np.stack(rest).astype(np.float32)] if rest else [first])

    got, chunk = _chunked(x.astype(np.float64), zi.astype(np.float64), phase3)
    plain = sosfilt_ops.sosfilt_ref(sos_t, torch.from_numpy(x)[None], torch.from_numpy(zi)[None])[0].numpy()
    exact = scipy.signal.sosfilt(sos, x.astype(np.float64), zi=zi.astype(np.float64))[0]
    np.testing.assert_array_equal(got[:chunk].astype(np.float32), plain[:chunk])
    gate = 2 * np.abs(plain - exact).max() + 1e-6 * np.abs(exact).max()
    assert np.abs(got - exact).max() <= gate, (np.abs(got - exact).max(), gate)


def test_tensor_cache_is_keyed_by_identity_and_version():
    """What a wrapper derives from a tensor is made once per tensor and
    made anew after an edit in place; a full cache starts over."""
    from autovc_tpu_torch.ops._cache import TensorCache

    cache, made = TensorCache(2), []

    def make(t):
        made.append(t.clone())
        return t.sum().item()

    a, b = torch.arange(4.0), torch.ones(3)
    assert cache.get(a, make) == 6.0 and cache.get(a, make) == 6.0 and len(made) == 1
    a[0] = 10.0
    assert cache.get(a, make) == 16.0 and len(made) == 2
    assert cache.get(a[1:], make) == 6.0 and len(made) == 3  # a view is another tensor
    assert cache.get(b, make) == 3.0 and cache.get(a, make) == 16.0 and len(made) == 5


@pytest.mark.parametrize("kind", ["float64", "float32", "list", "fortran"])
def test_sos_filtfilt_notes_the_sections_host_copy(kind):
    """sos_filtfilt takes the sections as any array-like, and gives the
    sections tensor it filters with ``ops.sosfilt`` together with their
    float32 values on the host, from which the card's tables are made with
    no device->host copy."""
    from autovc_tpu_torch.dsp import filters

    sos = {"float64": SOS64, "float32": SOS32, "list": SOS64.tolist(), "fortran": np.asfortranarray(SOS64)}[kind]
    x = torch.from_numpy(np.random.RandomState(3).randn(2, 400).astype(np.float32))
    got = filters.sos_filtfilt(sos, x)
    assert torch.equal(got, filters.sos_filtfilt(SOS64, x))
    sos_t, _ = filters._sos_tensors(SOS64.tobytes(), SOS64.shape, torch.float32, x.device)
    host = sosfilt_ops._host_sos.get(sos_t, lambda t: pytest.fail("no host copy was noted"))
    np.testing.assert_array_equal(host, SOS32.astype(np.float64))
