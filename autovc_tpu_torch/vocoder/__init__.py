"""Vocoders: mel -> waveform. Ported so far: HiFi-GAN, the autoregressive
WaveNet and Griffin-Lim."""

from autovc_tpu_torch.vocoder.griffinlim import mel_to_linear, mel_to_waveform, stft_to_waveform
from autovc_tpu_torch.vocoder.hifigan import HiFiGANGenerator, HiFiGANVocoder, ResBlock1
from autovc_tpu_torch.vocoder.wavenet import WaveNet, WaveNetVocoder, sample_from_mol_uniforms

__all__ = ["HiFiGANGenerator", "HiFiGANVocoder", "ResBlock1", "WaveNet", "WaveNetVocoder", "mel_to_linear",
           "mel_to_waveform", "sample_from_mol_uniforms", "stft_to_waveform"]
