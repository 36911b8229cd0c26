"""DSP / feature-extraction layer (counterpart of ``autovc_tpu.dsp``;
reference make_spect.py).

Slaney mel filterbank, periodic-Hann STFT, the scipy-compatible zero-phase
Butterworth highpass (biquads through the ``ops.sosfilt`` kernel in float32,
the transfer-function form on the CPU in float64), dB normalization fused
with the mel projection (``ops.mel``), robust waveform scaling, iSTFT and
Griffin-Lim, WAV I/O.
"""

from autovc_tpu_torch.dsp.mel import mel_filterbank, hz_to_mel, mel_to_hz
from autovc_tpu_torch.dsp.stft import (
    hann_window,
    frame_signal,
    stft_magnitude,
    stft_complex,
    istft,
    griffin_lim,
)
from autovc_tpu_torch.dsp.filters import (
    butter_highpass,
    butter_highpass_sos,
    lfilter,
    lfilter_zi,
    filtfilt,
    sos_filtfilt,
)
from autovc_tpu_torch.dsp.features import (
    normalize_db,
    denormalize_db,
    robust_scale,
    dither_reference,
    mel_from_stft_mag,
    MelFrontend,
)
from autovc_tpu_torch.dsp.audio_io import read_wav, write_wav

__all__ = [
    "mel_filterbank",
    "hz_to_mel",
    "mel_to_hz",
    "hann_window",
    "frame_signal",
    "stft_magnitude",
    "stft_complex",
    "istft",
    "griffin_lim",
    "butter_highpass",
    "butter_highpass_sos",
    "lfilter",
    "lfilter_zi",
    "filtfilt",
    "sos_filtfilt",
    "normalize_db",
    "denormalize_db",
    "robust_scale",
    "dither_reference",
    "mel_from_stft_mag",
    "MelFrontend",
    "read_wav",
    "write_wav",
]
