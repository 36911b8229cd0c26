"""The native runtime: a threaded C++ WAV decoder, ``.npy`` reader and batch
packer (``loader.cc``), bound with ctypes and built with ``g++`` at first
use; counterpart of ``autovc_tpu/runtime``."""

from autovc_tpu_torch.runtime.bindings import FeatureStore, native_available, read_wavs

__all__ = ["FeatureStore", "native_available", "read_wavs"]
