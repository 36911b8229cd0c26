"""Vocoders: mel -> waveform. Ported so far: HiFi-GAN."""

from autovc_tpu_torch.vocoder.hifigan import HiFiGANGenerator, HiFiGANVocoder, ResBlock1

__all__ = ["HiFiGANGenerator", "HiFiGANVocoder", "ResBlock1"]
