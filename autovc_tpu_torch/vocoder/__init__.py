"""Vocoders: mel -> waveform (HiFi-GAN, the autoregressive WaveNet,
Griffin-Lim and the hybrid of HiFi-GAN and Griffin-Lim), and their
training (``train_wavenet``, ``train_hifigan`` with the ``discriminators``)."""

from autovc_tpu_torch.vocoder.griffinlim import mel_to_linear, mel_to_waveform, stft_to_waveform
from autovc_tpu_torch.vocoder.hifigan import HiFiGANGenerator, HiFiGANVocoder, ResBlock1
from autovc_tpu_torch.vocoder.hybrid import HybridVocoder, refine_with_mel_magnitude
from autovc_tpu_torch.vocoder.wavenet import WaveNet, WaveNetVocoder, discretized_mol_loss, sample_from_mol_uniforms

__all__ = ["HiFiGANGenerator", "HiFiGANVocoder", "HybridVocoder", "ResBlock1", "WaveNet", "WaveNetVocoder",
           "discretized_mol_loss", "mel_to_linear", "mel_to_waveform", "refine_with_mel_magnitude",
           "sample_from_mol_uniforms", "stft_to_waveform"]
