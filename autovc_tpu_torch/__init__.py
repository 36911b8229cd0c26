"""autovc_tpu_torch: the PyTorch/CUDA port of autovc_tpu.

The JAX package ``autovc_tpu`` is the reference; this package computes the
same functions with PyTorch on an NVIDIA GPU, and with hand-written CUDA
kernels where the JAX package had a Pallas kernel. It imports neither JAX
nor anything of ``autovc_tpu``.

Ported so far: spmel conversion inference, mel (B, T, 80) -> AutoVC
``Generator`` -> HiFi-GAN -> waveform (B, T*256), and autoregressive WaveNet
vocoding, mel (B, Tc, 80) -> conditioning upsampler -> 24-layer generation ->
waveform (B, Tc*256), training of the spmel generator (``train.Solver``,
``python -m autovc_tpu_torch.cli.train``), and feature extraction, wav ->
highpass + dither -> STFT -> mel + dB -> spmel/stft/legacy/wav features
(``dsp.MelFrontend``, ``python -m autovc_tpu_torch.cli.make_spect``), and the
GE2E d-vector speaker encoder: speaker embeddings and manifests
(``python -m autovc_tpu_torch.cli.make_metadata``), its verification EER
(``cli.evaluate_speaker_encoder``), the similarity and MCD metrics (``eval``)
and the ``lambda_spk`` training auxiliary; and bfloat16 inference (the
Generator with ``ModelConfig(compute_dtype="bfloat16")``, HiFi-GAN and
WaveNet with bfloat16 weights) and vocoding of a results pkl
(``python -m autovc_tpu_torch.cli.synthesize``: Griffin-Lim, WaveNet or
HiFi-GAN); and the generator family's other two variants, stft (513 bins)
and wav (``models.GeneratorWav``, a ConvTasNet front and back end around
the core), trained and converted in float32 and bfloat16, with the
conversion and evaluation CLIs (``cli.convert``, ``cli.evaluate``,
``cli.evaluate_conversion``); and serving: ``torch.export`` bundles of the
converter and vocoder programs (``serve``), ``cli.export_ckpt``,
``cli.export_serving`` and the HTTP server ``cli.serve``; and parallelism on
``torch.distributed`` (data and tensor parallel training,
``cli.train --multihost``, sequence-parallel conversion,
``cli.convert --seq_devices``), the reference's torch checkpoints
(``interop``, ``cli.import_torch``), ``cli.visualize`` and the native loader.

    config     AudioConfig / ModelConfig / TrainConfig / Config / WaveNetConfig /
               HiFiGANConfig
    io         artifact loading and the JAX-tree <-> state-dict mappings
    dsp        mel filterbank, filters, STFT/iSTFT/Griffin-Lim, the feature
               front end, WAV I/O
    ops        kernels with their plain versions (ops.lstm, ops.wavenet,
               ops.mel, ops.sosfilt)
    models     layers, the AutoVC generators (spmel/stft, wav) and the GE2E
               d-vector
    losses     mse, l1 and the SDR family (the wav variant's SI-SNR)
    data       train.pkl, metadata.pkl and results manifests, the metadata builder, the
               utterance dataset and batch iterator, the device prefetcher
    train      schedules, EMA, the train step (with the lambda_spk
               auxiliary), metrics, profiling, the Solver, GE2E checkpoints
    eval       the windowed speaker embedder, centroids, similarity, EER,
               mel-cepstral distortion
    vocoder    HiFi-GAN, WaveNet and Griffin-Lim
    convert    Converter (spmel, stft: the mel projection, buckets),
               WavConverter, run_conversions, all_pairs_specs
    serve      export_converter and ServingConverter: exported programs
    parallel   the ('data', 'model') mesh and its collectives, tensor-parallel
               rules, sequence parallelism, a world of spawned ranks
    interop    the reference's torch state dicts as JAX parameter trees
    runtime    the native WAV/.npy loader and batch packer (C++, ctypes)
    cli        python -m autovc_tpu_torch.cli.train, cli.make_spect,
               cli.make_metadata, cli.evaluate_speaker_encoder,
               cli.synthesize, cli.convert, cli.evaluate,
               cli.evaluate_conversion, cli.export_ckpt,
               cli.export_serving, cli.serve, cli.import_torch,
               cli.visualize

Entry points take ``device=`` and default to ``"cuda"``; without a card they
raise. Pass ``device="cpu"`` to run the plain PyTorch versions on the CPU.
On the card they run in exact float32 (``exact_f32``).
"""

from __future__ import annotations

import contextlib
from typing import Iterator

import torch

__version__ = "0.1.0"


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The device an entry point runs on; raises when CUDA is asked for and
    there is no card (there is no silent CPU fallback)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU"
        )
    return dev


@contextlib.contextmanager
def exact_f32(device: str | torch.device) -> Iterator[None]:
    """Full float32 products and convolutions on a CUDA ``device`` for the
    duration: TF32 off for cuDNN and for matmuls (torch's default runs cuDNN
    convolutions in TF32), and bfloat16 matmuls summed in float32 to the end
    (torch's default lets cuBLAS reduce partial sums in bfloat16), the
    caller's flags restored on exit. Does nothing for another device."""
    if torch.device(device).type != "cuda":
        yield
        return
    matmul = torch.backends.cuda.matmul
    flags = torch.backends.cudnn.allow_tf32, matmul.allow_tf32, matmul.allow_bf16_reduced_precision_reduction
    torch.backends.cudnn.allow_tf32 = matmul.allow_tf32 = matmul.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, matmul.allow_tf32, matmul.allow_bf16_reduced_precision_reduction = flags
