"""Kernels of the port, each beside its plain PyTorch version.

    lstm    LSTM recurrence, forward and backward (CUDA, csrc/lstm_fwd.cu,
            csrc/lstm_bwd.cu; csrc/lstm_gates.cu, the bfloat16 backward's
            gate activations); the inference forward is also the operator
            torch.ops.autovc.lstm_sequence
    wavenet autoregressive WaveNet generation (CUDA, csrc/wavenet_gen.cu)
    mel     mel projection fused with the dB normalization (CUDA,
            csrc/mel_norm.cu)
    sosfilt one pass of a biquad cascade over time (CUDA, csrc/sosfilt.cu)
    _build  nvcc + ctypes build of csrc/*.cu into build/kernels/
    _cache  what a wrapper derives from a tensor, kept by the tensor's identity
"""
