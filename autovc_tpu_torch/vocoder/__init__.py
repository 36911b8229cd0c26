"""Vocoders: mel -> waveform. Ported so far: HiFi-GAN and the
autoregressive WaveNet."""

from autovc_tpu_torch.vocoder.hifigan import HiFiGANGenerator, HiFiGANVocoder, ResBlock1
from autovc_tpu_torch.vocoder.wavenet import WaveNet, WaveNetVocoder, sample_from_mol_uniforms

__all__ = ["HiFiGANGenerator", "HiFiGANVocoder", "ResBlock1", "WaveNet", "WaveNetVocoder", "sample_from_mol_uniforms"]
