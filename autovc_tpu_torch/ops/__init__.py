"""Kernels of the port, each beside its plain PyTorch version.

    lstm    forward LSTM recurrence (CUDA, csrc/lstm_fwd.cu)
    wavenet autoregressive WaveNet generation (CUDA, csrc/wavenet_gen.cu)
    _build  nvcc + ctypes build of csrc/*.cu into build/kernels/
"""
