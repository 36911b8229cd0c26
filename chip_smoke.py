"""Smoke run of the PyTorch/CUDA port on one GPU: builds the kernels, holds
each against its plain version, and drives spmel conversion, WaveNet
vocoding, spmel generator training, feature extraction, the GE2E speaker
encoder (speaker embeddings, its evaluation, the lambda_spk training
auxiliary), bfloat16 conversion and vocoding (``cli.synthesize``),
bfloat16 generator training (``cli.train --bf16 --pallas``), the stft and
wav variants' conversion and training with the conversion and evaluation
CLIs, the Generator's default bfloat16 rounding (JAX's ``lax.scan``) in
conversion and training, and the training of the speaker encoder and the
vocoders with ``cli.evaluate_vocoder``, end to end.

    python3 chip_smoke.py            # seeded random weights at full width
    python3 chip_smoke.py --trained  # the committed artifacts/*.npz weights
                                     # (generator, HiFi-GAN, wavenet_105k,
                                     # ge2e, ge2e_indep)

Phase 1 builds ``csrc/lstm_fwd.cu`` (plain nvcc) and runs the LSTM kernel
against ``lstm_sequence_ref`` at the main path's shapes (B=32, T=512,
H in {32, 512, 1024}, both directions), max-abs tolerance 1e-4, times
both beside cuDNN's LSTM, and prints each launch plan (regime, grid, shared
bytes a block, resident blocks a SM) and the time a step. Phase 2 runs ``Converter.convert_batch`` on 32
synthetic mels of 512 frames and the HiFi-GAN vocoder on its output, checks
that the generator went through the kernel (7 LSTM sequences per forward),
that the mel matches the same path with the plain recurrence (max-abs 1e-3)
and that the waveform is finite and (32, 131072), then times a warm
iteration. Phase 3 vocodes the first 8 frames of 8 of phase 2's converted
mels with the full-width WaveNet (24 layers, R=G=512, S=256) through
``WaveNetVocoder.generate`` and the CUDA kernel ``csrc/wavenet_gen.cu``
(B=8, T=2048 samples) and checks: (i) the kernel's logits within 1e-3 of the
teacher-forced forward on its own waveform; (ii) the first 32 samples of
every row within 1e-4 of ``generate_ref`` on the same uniforms (the first
divergence per row is printed); (iii) the waveform finite, in [-1, 1] and
(8, 2048); (iv) the plan's CUDA launches (one persistent cooperative launch)
for the one wrapper call, and a second identical call giving the same
waveform bit for bit. It prints the launch plan (blocks, columns a block,
shared bytes, resident blocks a SM, SMs) and times the kernel at B=1, 8 and
32 (T=2048): us a sample and us a phase (kernel time / (T x (L + 2)), a
phase being the work between two of the L + 2 grid barriers a sample),
beside the bound.
Phase 4 trains the full-width spmel generator at B=7, T=128 on synthetic
mels written as a ``train.pkl`` directory in a temporary directory: (a) the
forward kernel's training form and (b) the backward and dW kernels
(``csrc/lstm_bwd.cu``) against their plain versions at H in {32, 512, 1024},
both directions, nonzero initial state (1e-4; dW 1e-4 of its largest
magnitude), timed beside cuDNN's LSTM forward alone, backward alone and
forward+backward, with their launch plans; the dW kernel's plan (tile,
split of K) a case, its device time beside its bound and ``torch.matmul``'s
on the same operands (device time, torch.profiler), the step's sums of the
three, and two calls giving the same dW bit for bit; (a') the
time a step of both against B at H in {32, 512, 1024}, split by least
squares into what every step pays and what a batch row adds;
(c) one train step with the kernels against the same step with the plain
recurrence under torch autograd, the plain step made to take the kernel
step's side of every ReLU and abs kink (``train.compare.KinkTape``; the
elements that fell on the other side are counted and the unforced step's
gradients printed): loss 1e-5 relative, every gradient leaf within 1e-4 of
its scale (its largest magnitude; for a convolution's bias, whose exact
gradient is zero under the BatchNorm after it, that of its weight), 11
sequences forward and backward; and every leaf of the kernel step as near
the same step in float64 as twice the plain step's distance on that leaf
plus 1e-4; (d) 20 ``Solver`` steps (finite loss, the
mean of the last 5 below the first 5, step time, a profiler split of one
warm step); (e) a checkpoint at step 20 resumed by a new ``Solver``.
Phase 5 extracts features at full width (16 kHz, n_fft 1024, hop 256, 80
mels, the 30 Hz 5th-order highpass) from a synthetic corpus written to a
temporary directory (4 speakers x 24 utterances of 2-8 s: a gliding
fundamental and formant-shaped harmonics, a noise floor, silent gaps):
(a) ``csrc/mel_norm.cu`` against ``mel_normalize_ref`` on the |STFT| of 32
rows of 513 frames (16416 x 513 -> 80), one frame, 1000 frames and the
257-bin STFT (1e-5), its tile plan and the basis's nonzeros, its time
(CUDA events, and device time) beside the plain version's and
``torch.matmul``'s of the projection alone; (b) ``csrc/sosfilt.cu`` (the
chunked scan; its plans printed) against ``sosfilt_ref`` and scipy's
float64 filter in both passes on 4 x 16000 and 2 x 80000 samples: chunk 0
the plain pass bit for bit, each row no farther from float64 than twice
the plain pass plus 1e-6 of its max-abs; its time at 32 x 131072 (CUDA
events, and device time) beside the bytes bound, the chunked chain and one
SM's float64 FMAs, and the host's cost of a new chunk length's tables; (c)
``MelFrontend.mel_features`` on the card, one utterance of each speaker:
after the highpass, against the CPU's stages on the card's filtered
waveform (1e-4); the whole chain against the float64 host chain (1e-3);
with both TF32 flags on (1e-6); (d) ``cli.make_spect.main`` over the corpus
on the card (one mel_norm and two sosfilt launches a file; every file (T, 80), float32,
in [0, 1], within 1e-3 of ``--exact`` or, where the CPU's float32 highpass
takes ``--device cpu`` farther, within that distance plus 1e-4; the dB clip
engaged at both ends), its wall time, files/s and seconds of audio per
second, a profiler split of one warm file, and each kernel's device time a
file over the corpus; (e) the stft, legacy and wav features of two
utterances: after the highpass against the CPU's stages, and the whole
chain no farther from the float64 chain than the CPU's (in units of the
tolerance).
Phase 6 runs the GE2E d-vector (3 LSTM layers, the last step's dense layer,
L2 norm) on the LSTM kernels, on the spmel tree phase 5's make_spect wrote
on the card: (a) the d-vector with the kernels against the same d-vector on
the plain recurrence, both on the card, at H=768 (artifacts/ge2e.npz's
80/768/256 x3) and H=256 (ge2e_indep.npz's 80/256/256 x3) and B=1, 8 and 7
(make_metadata's crops, the evaluation's window batches, the auxiliary's
batch), T=128 (unit embeddings within 1e-4), timed (CUDA events and device
time) beside the plain version, cuDNN's 3-layer LSTM and the bound, with the
launch plan; the backward without dW at B=7 against its plain version; (b)
``cli.make_metadata`` with a seeded 80/768/256 GE2E .npz on the card and
with ``--device cpu`` (the same utterance lists, specs and metadata.log; the
embeddings within 1e-4), its wall time and the idle share of one speaker's
crops; (c) ``cli.evaluate_speaker_encoder --holdout 6`` on the card
(utterances/s, device time an utterance) against the same CLI with
``--device cpu`` (its embeddings within 1e-4; the EER, threshold and
cosine means within what that moves them by); (d) phase 4's Solver with
lambda_spk=1.0 on the 'windowed' protocol and that encoder: one step with
the kernels against the plain step on the same kinks (the hinge's ReLU
among them; loss 1e-5 relative, leaves 1e-4 of their scale), 21 forward, 21
backward and 18 dW sequences a step (none for the frozen d-vector), 12
steps with and 12 without the auxiliary (p50, p95), the device-time split
of one warm step and of the d-vector's forward and backward.
Phase 7 runs the bfloat16 inference paths: (a) the LSTM forward kernel's
bfloat16 form against ``lstm_sequence_ref`` in bfloat16 (a float32 carry,
the sequence rounded) at B=32, T=512, H in {32, 512, 1024}, both
directions: every element within 1 bfloat16 ulp (of 2^-16 of the sequence's
largest magnitude where the element is smaller), at least 99% bit-equal;
its time beside the float32 kernel's, the plain loop's, cuDNN's LSTM in
bfloat16 and the bound, with the plan; (b) the bench program in bfloat16
(``bench.py:107-118``): phase 2's 32 mels through ``Converter.convert_batch``
on the same seeded Generator with ``compute_dtype="bfloat16"`` and
``use_pallas_lstm=True`` (7 bfloat16 LSTM launches in the Pallas
rounding; 10a runs bench.py's default, the scan rounding) and the same HiFi-GAN in bfloat16, the waveform in float32:
the warm iteration, its realtime factor, the Generator / HiFi-GAN / LSTM
split, and ``bench.py``'s parity dict against phase 2's float32 run
(recorded, not a gate: seeded weights on synthetic mels); (c) phase 3's
WaveNet with bfloat16 weights through ``WaveNetVocoder.generate(dtype=
torch.bfloat16)`` (one launch; B=8, T=2048): the kernel's logits against the
teacher-forced bfloat16 forward on its own waveform, and the first 32
samples of every row against the plain bfloat16 loop (over its first
WN_BF16_PLAIN_T samples), each within WN_BF16_SPREAD times the plain loop's
own spread (its logits against the teacher-forced forward of its own
waveform; its samples against the same loop on the WaveNet with its
channels relabelled, which sums in another order) and no tighter than
phase 3's float32 gates; a second call the same waveform; its time at B=1, 8
and 32 beside the float32 kernel's and the bytes bound, and the profiler's
split; (d) ``cli.synthesize`` on the card on a results pkl of 8 of phase
2's converted mels (4-11 frames) in a temporary directory, ``--vocoder
wavenet --wavenet_engine pallas --batch 8`` (one launch of the bfloat16
form), ``--vocoder wavenet --bf16 --batch 8`` (one of the scan form) and
``--vocoder hifigan``: every wav finite, Tc*256 samples, and readme.md;
(e) phase 3's WaveNet in the JAX scan engine's bfloat16 rounding
(``WaveNetVocoder.generate``'s default engine: the kernel's scan form, one
launch, B=8, T=2048), held by (c)'s rule against the plain scan loop and
the teacher-forced forward in the same rounding, timed beside the bfloat16
form and the float32 kernel in turns.
Phase 8 runs bfloat16 training at phase 4's shapes (B=7, T=128, the
published widths, seeded weights): (a) the LSTM kernels' bfloat16 training
forms against their plain versions at H in {32, 512, 1024}, both
directions: the forward from a float32 state (h_seq within 1 bfloat16 ulp,
floored at 2^-16 of its peak, and 99% bit-equal; c_seq, hN, cN 1e-4), the
gate activations recomputed from the rounded h_seq by ``csrc/lstm_gates.cu``
(1e-5; its time a sequence beside its bound, ``torch.matmul`` of its
product and the wrapper's host microseconds a call), the backward and dW
(dxproj and dW within 1 bfloat16 ulp, floored at
2^-8 of the peak, 99% bit-equal; dh0, dc0 1e-4); each timed (CUDA events
and device time) beside the float32 kernels on the same inputs, the plain
versions, the bound (products with a float32 operand at 67 TFLOP/s, those
of two bfloat16 operands, the gates', at the bfloat16 tensor cores' 989,
bytes at 3.35 TB/s) and cuDNN's bfloat16
LSTM (forward alone, backward alone, forward+backward); (b) one ``Solver``-config step with
``compute_dtype="bfloat16"`` with the kernels against the same step on the
plain engine (``LSTMSequenceFn``'s plain loops) on the card, on its kinks
(``KinkTape``), every gradient leaf no farther from the plain step's, of
its scale, than the plain step's own bfloat16 spread (the median over the
leaves of its distance from the float32 step on the same kinks), the loss
within twice its spread, beside the float32 step's; 11 forward, 11 gates,
11 backward and 11 dW
launches a step; 20 ``Solver`` steps (finite, going down; p50, p95) and the
device-time split and idle share of a warm step; (c) ``cli.train --bf16``
for 3 steps in a temporary directory, once with ``--lambda_spk`` on a seeded
GE2E .npz (the bfloat16 d-vector's scan forms launched: 3 a step each way),
each exported and converted through ``Converter`` in bfloat16 and in
float32; (d) the scan forms of the LSTM kernels (the d-vector in bfloat16:
each op rounded, a bfloat16 carry) at the d-vector's widths (768, 256) and
batches (1, 8, 7), T=128, both directions, against their plain loops (the
first 16 steps >= 99% bit-equal and within 1 ulp or the plain loop's own
ulps there, the sequence within twice the plain loop's own spread with its
hidden units relabelled), timed (us a step beside the replaced form's
recorded time) beside the plain loops, the bound and
cuDNN's bfloat16 LSTM, the bfloat16 d-vector's forward beside the float32
one and cuDNN's bfloat16 3-layer LSTM; (e) 12 ``Solver`` steps in bfloat16
with lambda_spk=1.0 ('windowed') and 12 without (p50, p95), the launches a
step asserted (21 forward: 18 bfloat16, 3 scan; 21 backward; 18 dW and
gates), the device time and idle share of a warm step.
Phase 9 runs the stft and wav variants at the published widths (ConvTasNet
depth 1, 512 channels, kernel 1024, stride 256) on seeded weights: (a) the
stft Generator through ``Converter.convert_batch(to_mel=True)`` on 32
synthetic 513-bin spectra of 512 frames, then HiFi-GAN: 7 LSTM launches,
the mel within 1e-3 of the plain recurrence's, (32, 512, 80), the waveform
finite, the generator's and the projection's time; (b) the stft train step
at B=7, T=128 on a synthetic 513-bin tree against the plain step on the
same kinks (loss 1e-5 relative, every leaf 1e-4 of its scale, 11 sequences
forward, backward and dW), 10 Solver steps (finite; p50, p95) and the
profile of a warm step; (d) phase 5's corpus as wav features
(``cli.make_spect`` and ``cli.make_metadata --model_type wav``) and 4 of
its utterances through ``WavConverter.convert_to_mel`` (7 LSTM, 2 sosfilt
and 1 mel_norm launches an utterance; the waveform within 1e-3 of the
plain recurrence's; the re-extracted mel by phase 5's gates: after the
highpass within 1e-4 of the CPU's stages, against the float64 chain within
1e-3 or the CPU float32 path's own distance plus 1e-4); (c) the wav train
step at B=2, len_crop 33536 on those features, gated as (b) with the
PReLUs on the KinkTape, 10 Solver steps, the profile of a warm step, its
g_loss_sisnr and the ConvTasNet front and back end's device time; (e) the
CLIs on the card on phase 5's corpus: ``cli.make_spect`` and
``cli.make_metadata --model_type stft``, ``cli.train`` of stft and wav (3
steps each, exported), ``cli.convert --run_dir`` (stft ``--all_pairs``;
wav), ``cli.evaluate`` (stft) and ``cli.evaluate_conversion --through
mel`` with phase 6's GE2E checkpoint, each one's wall seconds, the results
pkls of the right length and finite; (f) both variants converted in
bfloat16 beside (a)'s and (d)'s float32 (the mel delta recorded, not
gated) and 3 bfloat16 Solver steps of each (finite).

Phase 10 runs the Generator's bfloat16 LSTMs in the scan rounding, the
default of ``ModelConfig.use_pallas_lstm=False`` as of JAX's (``lax.scan``:
h and c carried in bfloat16, every gate op rounded): (a) the scan forward
(``csrc/lstm_scan_fwd.cu``, wgmma; mma.sync at H=32) at the Generator's shapes (B=32, T=512;
H=32 both directions, 512, 1024) against its plain loop by 8d's scan rule
(its first 16 steps within 1 ulp or the plain loop's own ulps there and 99%
bit-equal; the sequence within twice the spread of 32 relabelled plain
loops run stacked), timed (us a step, the plan, the replaced form's
recorded time) beside the
plain loop, the bound and cuDNN's bfloat16 one-layer LSTM forward; then
bench.py's default program (7b's, with the scan rounding): 7 scan
launches, its iteration, realtime factor and parity dict beside 7b's; (b)
at B=7, T=128, H in {32, 512, 1024}, both directions, on the plain scan
chain's outputs: the scan backward (``csrc/lstm_scan_bwd.cu``, its dh
product on mma.sync) against ``lstm_scan_bf16_backward_ref`` by the scan
rule, and the scan dW kernel (``csrc/lstm_scan_dw.cu``: each step's
product rounded and added to a bfloat16 accumulator, as XLA transposes the
scan) against ``lstm_scan_bf16_weight_grad_ref`` (1 bfloat16 ulp floored
at 2^-8 of the peak, 99% bit-equal), each with its plan and timed beside
the replaced kernel's recorded time, the plain loop and the bound (the
backward beside cuDNN's bfloat16 backward, dW beside its latency bound and
``torch.matmul`` of the one-shot product); the scan forward's training
form at the same shapes by the scan rule, its us a step; one bfloat16
train step in the scan rounding against the plain engine on the same kinks
(8b's gate), 5 Solver steps (11 scan forward, backward and dW launches a
step, none of the Pallas forms) and a warm step's profile split into the
scan forward, backward, dW and the rest; ``cli.train --bf16`` and
``--bf16 --pallas``, 3 steps each, their launches.
Phase 11 trains the speaker encoder and the vocoders on phase 5's corpus:
(a) GE2E (every speaker, 5 crops of 128 frames each): at H=768 and 256 and
B=20 the scan forward by the scan rule (the bfloat16 d-vector at this
batch; us a step), the LSTM training forward and the backward with dW
against their plain versions (1e-4; dW 1e-4 of its peak), timed beside
cuDNN; one
``GE2ETrainer`` loss and gradient with the kernels against the plain engine
on the card (loss 1e-5 relative, leaves 1e-4 of their scale or, where a
leaf's sums cancel, phase 4c's float64 rule; 3 forward, backward and dW
launches), a step and its profile;
``cli.train_speaker_encoder`` for 3 steps and ``cli.make_metadata
--dvector_ckpt`` on its checkpoint; (b) HiFi-GAN V1 reconstruction and GAN
steps (MPD and MSD at their published widths) at B=2, 32 frames and the
r9y9 WaveNet at B=2, 8000 samples: step p50 and p95, a warm step's device
time and idle share; ``cli.train_vocoder`` for 3 steps of HiFi-GAN, of
``--gan --init`` on it and of WaveNet; (c) ``cli.evaluate_vocoder`` with
griffinlim, hifigan and hybrid on 4 utterances and wavenet on the shortest
one (11b's checkpoints), the launches of each asserted (one mel_norm and
two sosfilt an utterance, one WaveNet launch).

Phase 12 serves (``autovc_tpu_torch.serve``, ``cli.serve``): (a) bundles
of phase 2's Generator and HiFi-GAN in float32, in bfloat16 (the scan rounding, the default) and in the Pallas rounding,
loaded with ``ServingConverter`` on the card; each converter program at
B=32, T=512 bit for bit against the live ``Converter``, 7 launches of its
LSTM form a call and 7 ``autovc::lstm_sequence`` nodes in its graph, and
against the plain engine on the card (float32 1e-4; bfloat16 within half
the plain engine's own distance from float32); its ms and the vocoder's
beside the live pipeline's; (b) an stft bundle and a hybrid bundle
(gl_iters=2) converting one utterance each, within 5e-4 of the live
staging; (c) ``cli.serve``'s server in a thread (--batch_window 5
--max_batch 16 --bucket 256 --warmup 256,512): 32 requests of 228-484
frames from 8 client threads, each response within 1e-6 of a solo call at
the same bucket padding; requests/s, p50 and p95 latency, the mean batch; a request
without batching, and a malformed one (400).

Phase 13 runs the port's parallelism on torch.distributed, on phase 5's
corpus, after phase 12 and on processes started during phase 12 (after
12a's timed programs: their start, seconds of imports and of the card's
context, overlaps 12b-c; each waits for a signal before its timed or
training work): (a) ``convert.sequence_parallel.SPGenerator``
at the published widths on B=2 utterances of T=4096 frames, over a world of
2 ranks sharing the card under gloo (the LSTM state handed through host
memory) and over a world of 1 under NCCL, each against the single-process
Generator forward on the card (codes 2e-5, x_identic 2e-4, x_psnt 2e-3), 7
``lstm_fwd.cu`` launches a rank, every block after a direction's first run
from a received (h, c), the SP forward's ms beside the dense one's; then
``cli.convert --seq_devices 2`` against the dense Generator at its padding
(a multiple of 2 * freq) and against the same CLI without it where both
paddings agree (2e-3; the other utterances' distance recorded);
(b) ``cli.train --multihost`` as 2 OS processes on the card under gloo
(B=4 global, len_crop 128, 3 steps), at data_parallel 2 and at
--model_parallel 2, the two runs at once (let go once (a)'s worlds are
timed), each rank 0's --export against the single-process run's (params 1e-3, batch_stats 2e-2), 33 forward, backward
and dW launches a rank, each run's wall time.

The kernels are built first, one ``nvcc`` each, started together; the
LSTM kernels are waited for, the WaveNet and feature kernels finish
building while phases 1-2 run.

The output ends with the card's name and power limit, one JSON line of
kernel records, and ``{"ok": true, "device": {...}}``. Any failure raises and
exits non-zero; a watchdog ends a hung run with a stack dump. Without a CUDA
device it exits non-zero before doing anything. It writes nothing outside
the kernel build directory but the temporary directories of phases 4-13,
which it removes.
"""

from __future__ import annotations

import sys

sys.dont_write_bytecode = True  # keep the checkout free of __pycache__

import argparse  # noqa: E402
import contextlib  # noqa: E402
import dataclasses  # noqa: E402
import faulthandler  # noqa: E402
import functools  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import tempfile  # noqa: E402
import threading  # noqa: E402
import json  # noqa: E402
import pickle  # noqa: E402
import re  # noqa: E402
import subprocess  # noqa: E402
import time  # noqa: E402
import types  # noqa: E402
from pathlib import Path  # noqa: E402
from unittest import mock  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from scipy import signal as scipy_signal  # noqa: E402

from autovc_tpu_torch.cli import evaluate_speaker_encoder, make_metadata, make_spect, synthesize  # noqa: E402
from autovc_tpu_torch.cli import convert as cli_convert  # noqa: E402
from autovc_tpu_torch.cli import evaluate, evaluate_conversion  # noqa: E402
from autovc_tpu_torch.cli import train as cli_train  # noqa: E402
from autovc_tpu_torch.config import AudioConfig, Config, ModelConfig, TrainConfig, WaveNetConfig  # noqa: E402
from autovc_tpu_torch import exact_f32  # noqa: E402
from autovc_tpu_torch.convert import Converter, WavConverter, all_pairs_specs  # noqa: E402
from autovc_tpu_torch.dsp import (MelFrontend, butter_highpass, butter_highpass_sos, mel_filterbank,  # noqa: E402
                                  read_wav, stft_magnitude, write_wav)
from autovc_tpu_torch.data import (BatchIterator, SpeakerEntry, UtteranceDataset,  # noqa: E402
                                   load_conversion_metadata, load_results, load_train_manifest, save_results,
                                   save_train_manifest)
from autovc_tpu_torch.data.metadata_builder import embed_speaker  # noqa: E402
from autovc_tpu_torch.io import save_dvector_artifact  # noqa: E402
from autovc_tpu_torch.models import build_dvector, build_generator  # noqa: E402
from autovc_tpu_torch.ops import _build  # noqa: E402
from autovc_tpu_torch.ops import lstm as lstm_ops  # noqa: E402
from autovc_tpu_torch.ops import mel as mel_ops  # noqa: E402
from autovc_tpu_torch.ops import sosfilt as sosfilt_ops  # noqa: E402
from autovc_tpu_torch.ops import wavenet as wavenet_ops  # noqa: E402
from autovc_tpu_torch.train import Solver, TrainState, init_ema, make_optimizer, make_train_step  # noqa: E402
from autovc_tpu_torch.train.compare import KinkTape, grad_scale  # noqa: E402
from autovc_tpu_torch.train.ge2e import load_params  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent / "scripts"))
import scan_train_times as scan_times  # noqa: E402  (the scan training kernels' device times and work)
import parallel_ranks  # noqa: E402  (phase 13a's work of a rank)
from autovc_tpu_torch.train.step import windowed_embed  # noqa: E402
from autovc_tpu_torch.vocoder.hifigan import HiFiGANVocoder  # noqa: E402
from autovc_tpu_torch.vocoder.wavenet import WaveNetVocoder  # noqa: E402

WATCHDOG_S = 600
ROOT = Path(__file__).resolve().parent
B, T, N_MELS, HOP = 32, 512, 80, 256
LSTM_TOL = 1e-4  # f32 kernel vs f32 plain loop: summation order only
MEL_TOL = 1e-3  # on the whole generator, after 7 recurrences and 11 convs
KERNELS = ("lstm_fwd", "lstm_scan_fwd", "lstm_bwd", "lstm_scan_bwd", "lstm_gates", "lstm_scan_dw", "wavenet_gen",
           "mel_norm", "sosfilt")
LATE_KERNELS = ("wavenet_gen", "mel_norm", "sosfilt")  # built while phases 1-2 run (the longest nvcc runs)
WN_B, WN_FRAMES = 8, 8  # utterances and mel frames vocoded by WaveNet: T = 2048 samples
WN_TF_TOL = 1e-3  # kernel logits vs teacher-forced forward on its own waveform, f32
WN_PREFIX_TOL, WN_MIN_PREFIX = 1e-4, 32  # kernel vs plain loop, same uniforms
WN_PLAIN = 512  # samples of the plain loop held against the kernel, and timed
WN_TIME_B = (1, WN_B, 32)  # batches the kernel is timed at
# us a sample at B=8, T=2048 of the per-layer kernels this one replaced, 49
# launches a sample (PERF.md §6, NVIDIA H100 80GB HBM3, 700 W)
PER_LAYER_WN_US = 434.44
# H100 SXM peaks (NVIDIA data sheet): f32 outside the tensor cores, bfloat16
# on the tensor cores (dense), HBM3.
F32_FLOPS = 67e12
BF16_TC_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12
# (hidden, reverse, calls per Generator forward)
LSTM_CASES = [
    (32, False, 2), (32, True, 2),  # encoder BLSTM, 2 layers
    (512, False, 1), (512, True, 0),  # decoder lstm1 (reverse: coverage only)
    (1024, False, 2), (1024, True, 0),  # decoder lstm2, 2 layers
]
TRAIN_B, TRAIN_T, TRAIN_STEPS = 7, 128, 20  # the batch artifacts/generator_spmel_f16.npz was trained at
# (hidden, reverse, sequences per train step): the encoder BLSTM runs twice
# (the forward and the content re-encoding), the decoder LSTMs once
TRAIN_CASES = [(32, False, 4), (32, True, 4), (512, False, 1), (512, True, 0), (1024, False, 2), (1024, True, 0)]
SEQS_PER_STEP = sum(n for _, _, n in TRAIN_CASES)  # 11
# phase 4 (a'): the LSTM kernels' time a step against B, at these widths
SPLIT_HIDDEN, SPLIT_BATCH, SPLIT_T = (32, 512, 1024), (1, 4, 8, 16, 32), 256
# one step with the kernels vs the plain recurrence on the card, both on the
# same side of every kink: the loss, relative; each gradient leaf, of its scale
LOSS_RTOL, GRAD_TOL = 1e-5, 1e-4


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn`` on the card, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_us(fn, reps: int) -> float:
    """Mean microseconds of the host's time a call of ``fn`` (the wrapper's
    checks, allocation and launch), calls queued back to back without a
    synchronisation, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    us = (time.perf_counter() - t0) * 1e6 / reps
    torch.cuda.synchronize()
    return us


def device_ms(fn, reps: int) -> float:
    """Mean milliseconds of device activity (kernels and copies) of ``fn``
    over ``reps`` warm calls, from torch.profiler: the card's time alone,
    without the host's gaps between launches (CUDA events around a loop of
    short calls time the host's wrapper instead). CUDA events where the
    profiler records no device time. An LSTM launch whose record the
    profiler dropped counts at its kind's mean (``lstm_records``, the gates
    kernel's among them). torch.profiler drops records of other kernels too,
    more often after many profiles in one process, and a dropped record only
    lowers the total: so two profiles are taken and the larger total kept,
    of those that recorded every LSTM kind that was launched."""
    totals = []
    for _ in range(2):
        rows, _, launched = device_activity(fn, reps, profile_counts)
        missing, kinds = lstm_records(rows, launched, BF16_KINDS)
        if all(recorded or not made for _, recorded, made in kinds.values()):
            totals.append(sum(t for _, _, t in rows) + missing)
    if max(totals, default=0.0) <= 0:
        log("device_ms: the profiler recorded no device time of a launched kind; CUDA events instead")
        return cuda_ms(fn, reps)
    return max(totals) / 1e3 / reps


def lstm_work(b: int, t: int, h: int) -> tuple[float, float]:
    """(flops, bytes) of one sequence: the recurrent product's 2*B*T*H*4H
    flops (the cell's few elementwise operations per unit are not counted),
    and xproj + w_hh read once and h_seq written once, in float32."""
    return 2.0 * b * t * h * 4 * h, 4.0 * (b * t * 4 * h + h * 4 * h + b * t * h)


def bound_ms(flops: float, nbytes: float) -> tuple[float, str]:
    """The least time for the work: flops at the f32 peak or bytes at the HBM
    rate, whichever is larger, and which one it is."""
    ops_ms, bytes_ms = flops / F32_FLOPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def bf16_bound(flops: float, nbytes: float) -> tuple[float, str]:
    """The least time for work whose products take bfloat16 operands and sum
    in float32: flops at the bfloat16 tensor cores' peak (the card's peak
    for that operand type, whatever units a kernel uses) or bytes at the HBM
    rate, whichever is larger, and which one it is."""
    ops_ms, bytes_ms = flops / BF16_TC_FLOPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def plain_recurrence():
    """Every LSTM of the models in the plain loop (differentiable by torch
    autograd), so that no kernel is launched."""
    return mock.patch.object(lstm_ops, "lstm_sequence", lstm_ops.lstm_sequence_ref)


def phase_build():
    """Build every kernel from the checkout, one nvcc each, all started at
    once: returns when the LSTM kernels (phases 1-2's) are built; the
    longest builds (LATE_KERNELS) go on in a thread, and the function
    returned waits for them (before phase 3), raises a failed build and logs
    each build."""
    t0 = time.perf_counter()
    failed: list[Exception] = []

    def build_late() -> None:
        try:
            _build.build(list(LATE_KERNELS))
        except Exception as exc:  # raised by finish() on the main thread
            failed.append(exc)

    late = threading.Thread(target=build_late, daemon=True)
    late.start()
    _build.build([k for k in KERNELS if k not in LATE_KERNELS])
    log(f"build of the LSTM kernels: {time.perf_counter() - t0:.1f} s wall; {', '.join(LATE_KERNELS)} building on")

    def finish() -> None:
        late.join()
        if failed:
            raise failed[0]
        log(f"build {', '.join(KERNELS)}: {time.perf_counter() - t0:.1f} s wall since the first nvcc started")
        log_build()

    return finish


def log_build() -> None:
    """Each kernel's nvcc time, spills and ptxas registers."""
    for name in KERNELS:
        spills = [int(m) for m in re.findall(r"(\d+) bytes spill stores", _build.build_log.get(name, ""))]
        log(f"  {name}: nvcc {_build.build_seconds.get(name, 0.0):.1f} s, ptxas spill stores up to "
            f"{max(spills, default=0)} bytes a kernel")
        for line in _build.build_log.get(name, "").splitlines():
            if "registers" in line or "spill" in line:
                log(f"    ptxas: {line.strip()}")


def phase_kernel(dev: torch.device) -> dict:
    """Hold the LSTM kernel against the plain version."""
    rng = np.random.RandomState(0)
    record = {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "flops": 0.0, "bytes": 0.0}
    for hidden, reverse, calls in LSTM_CASES:
        xproj = torch.from_numpy((rng.randn(B, T, 4 * hidden) * 0.5).astype(np.float32)).to(dev)
        bound = 1.0 / np.sqrt(hidden)
        w_hh = torch.from_numpy(rng.uniform(-bound, bound, (hidden, 4 * hidden)).astype(np.float32)).to(dev)
        got = lstm_ops.lstm_sequence(xproj, w_hh, reverse)
        want = lstm_ops.lstm_sequence_ref(xproj, w_hh, reverse)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        ms = cuda_ms(lambda: lstm_ops.lstm_sequence(xproj, w_hh, reverse), reps=5)
        plain_ms = cuda_ms(lambda: lstm_ops.lstm_sequence_ref(xproj, w_hh, reverse), reps=2)
        flops, nbytes = lstm_work(B, T, hidden)
        case_bound_ms, bound_by = bound_ms(flops, nbytes)
        log(f"lstm_fwd H={hidden} {'reverse' if reverse else 'forward'}: max_abs_err={err:.3e} "
            f"ms={ms:.4f} ({ms / T * 1e3:.2f} us a step) plain_ms={plain_ms:.4f} bound_ms={case_bound_ms:.4f} "
            f"({bound_by}) calls_per_forward={calls}; {plan_line('fwd')}")
        if not err <= LSTM_TOL:
            raise AssertionError(f"lstm kernel H={hidden} reverse={reverse}: {err} > {LSTM_TOL}")
        record["max_abs_err"] = max(record["max_abs_err"], err)
        record["ms"] += calls * ms
        record["plain_ms"] += calls * plain_ms
        record["flops"] += calls * flops
        record["bytes"] += calls * nbytes
    record["library_ms"] = cudnn_lstm_ms(dev, rng)
    return record


def plan_line(kind: str) -> str:
    """The launch plan of the last ``kind`` launch ("scan_fwd", "scan_bwd",
    "scan_dw": the scan rounding's ``ScanPlan``, ``ScanBwdPlan``,
    ``ScanDwPlan``), with the occupancy query's resident blocks per SM."""
    plan, per_sm, sms = lstm_ops.last_launch[kind]
    threads = lstm_ops.THREADS
    if kind == "scan_dw":
        return (f"plan: {plan.blocks} blocks of {lstm_ops.SCAN_DW_WARPS} warps, tiles of {8 * plan.mi} units x "
                f"{32 * plan.nj} columns ({plan.mi} x {2 * plan.nj} a thread), {plan.slabs} box(es) of {plan.rows} "
                f"rows a step, {plan.slots} slots a buffer, "
                f"{plan.smem} shared bytes a block, {per_sm} resident a SM on {sms} SMs")
    if kind == "scan_fwd":
        grid = (f"{plan.blocks} blocks x {plan.rows} rows (mma.sync m16n8k16)" if plan.regime == "a"
                else f"{plan.blocks} blocks x {plan.units} units, {plan.rows}-row tiles (wgmma m64n{plan.rows}k16)")
    elif kind == "scan_bwd":
        grid = (f"{plan.blocks} blocks x {plan.rows} rows, 8 units a warp (mma.sync m16n8k16)" if plan.regime == "a"
                else f"{plan.blocks} blocks x {plan.units} units, {plan.rows}-row tiles, an eighth of K a warp "
                     f"(mma.sync m16n8k16)")
        threads = 32 * plan.units // 8 if plan.regime == "a" else threads
    elif plan.regime == "a":
        grid = f"{plan.blocks} blocks x {plan.rows} rows"
    else:
        grid = f"{plan.blocks} blocks x {plan.units} units, {plan.rows}-row tiles, K chunks of {plan.kc}"
    return (f"plan: regime ({plan.regime}), {grid}, {threads} threads, {plan.smem} shared bytes a block, "
            f"{per_sm} resident a SM on {sms} SMs")


def cudnn_lstm_ms(dev: torch.device, rng: np.random.RandomState, dtype: torch.dtype = torch.float32) -> float:
    """Yardstick only: torch.nn.LSTM (cuDNN) over the generator's three LSTM
    stacks at B=32, T=512, input product included, in ``dtype`` (in
    bfloat16 cuDNN rounds otherwise than the kernel: a yardstick, never a
    gate)."""
    total = 0.0
    for in_dim, hidden, layers, bidir in [(512, 32, 2, True), (320, 512, 1, False), (512, 1024, 2, False)]:
        net = torch.nn.LSTM(in_dim, hidden, layers, batch_first=True, bidirectional=bidir).to(dev, dtype)
        x = torch.from_numpy(rng.randn(B, T, in_dim).astype(np.float32)).to(dev, dtype)
        with torch.inference_mode():
            ms = cuda_ms(lambda: net(x), reps=5)
        log(f"cudnn nn.LSTM {str(dtype).removeprefix('torch.')} in={in_dim} H={hidden} layers={layers} "
            f"bidirectional={bidir}: ms={ms:.4f}")
        total += ms
    return total


def phase_end_to_end(dev: torch.device, trained: bool) -> tuple[int, np.ndarray, tuple]:
    """Converter.convert_batch + HiFi-GAN on (32, 512, 80) mels; returns the
    kernel launches of the main-path run, the converted mels and (the specs,
    the waveform) for phase 7b."""
    cfg = ModelConfig()
    art = ROOT / "artifacts"
    gen = build_generator(cfg, artifact=str(art / "generator_spmel_f16.npz") if trained else None,
                          device=dev, seed=1)
    voc = HiFiGANVocoder(artifact=str(art / "hifigan.npz") if trained else None, device=dev, seed=2)
    log(f"weights: {'committed artifacts' if trained else 'seeded random, full width'}")
    converter = Converter(gen, cfg)

    rng = np.random.RandomState(1)
    emb = rng.randn(2, cfg.dim_emb).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    specs = [
        types.SimpleNamespace(src_features=rng.rand(T, N_MELS).astype(np.float32),
                              src_embedding=emb[0], trg_embedding=emb[1])
        for _ in range(B)
    ]

    def run():
        mels = np.stack(converter.convert_batch(specs, batch_size=B))
        return mels, voc.generate(mels)

    torch.cuda.synchronize()
    lstm_ops.launches = 0
    t0 = time.perf_counter()
    mels, wav = run()
    torch.cuda.synchronize()
    launches = lstm_ops.launches
    log(f"main path (cold): {time.perf_counter() - t0:.3f} s, lstm kernel launches={launches}")
    if launches != 7:
        raise AssertionError(f"expected 7 lstm kernel launches per Generator forward, got {launches}")
    if wav.shape != (B, T * HOP) or not bool(torch.isfinite(wav).all()):
        raise AssertionError(f"waveform {tuple(wav.shape)} finite={bool(torch.isfinite(wav).all())}")
    if mels.shape != (B, T, N_MELS) or not np.isfinite(mels).all():
        raise AssertionError(f"mel {mels.shape} finite={np.isfinite(mels).all()}")

    with plain_recurrence():
        mels_plain = np.stack(converter.convert_batch(specs, batch_size=B))
    err = float(np.abs(mels - mels_plain).max())
    log(f"mel kernel path vs plain recurrence: max_abs_err={err:.3e} "
        f"(mel range {mels.min():.3f}..{mels.max():.3f})")
    if not err <= MEL_TOL:
        raise AssertionError(f"end-to-end mel differs from the plain path: {err} > {MEL_TOL}")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    audio_s = B * T * HOP / 16000
    x = torch.from_numpy(np.stack([s.src_features for s in specs])).to(dev)
    e_src, e_trg = (torch.from_numpy(np.tile(e, (B, 1))).to(dev) for e in emb)
    with torch.inference_mode():
        gen_ms = cuda_ms(lambda: gen(x, e_src, e_trg), reps=3)
        voc_ms = cuda_ms(lambda: voc.model(x), reps=3)
        # a measurement, not a check: what torch's default (cuDNN in TF32)
        # would make of the mel, which the entry points now refuse
        exact = gen(x, e_src, e_trg)[1]
        torch.backends.cudnn.allow_tf32 = True
        tf32 = gen(x, e_src, e_trg)[1]
        torch.backends.cudnn.allow_tf32 = False
        log(f"spmel mel with cuDNN TF32 on (torch's default) vs exact f32: "
            f"max_abs_delta={(tf32 - exact).abs().max().item():.3e}")
    log(f"warm iteration: {warm_s * 1e3:.1f} ms wall for {audio_s:.1f} s of audio "
        f"({audio_s / warm_s:.1f}x realtime); generator {gen_ms:.1f} ms, vocoder {voc_ms:.1f} ms "
        f"(card: {card_line()})")
    return launches, mels, (specs, wav)


def wavenet_work(cfg: WaveNetConfig, packed: dict, b: int, t: int) -> tuple[float, float]:
    """(flops, bytes) of generating t samples for b rows: per sample every
    packed weight read once (98.7 MB at full width: more than the L2 holds),
    two ring reads and one ring write of (B, R) per layer, the sample's cond
    and uniforms read and its sample and logits written; the products'
    2 * B * (multiply-adds) flops (activations and sampling not counted)."""
    r, g, s, c, nout = (cfg.residual_channels, cfg.gate_channels, cfg.skip_channels,
                        cfg.cin_channels, cfg.out_channels)
    macs = cfg.layers * ((3 * r + c) * g + g // 2 * (r + s)) + s * s + s * nout
    weight_bytes = sum(v.numel() * v.element_size() for v in packed.values())
    ring = packed["w3"].element_size()  # the rings' and cond's element: 4, or 2 in bfloat16
    step_bytes = weight_bytes + b * (ring * (3 * cfg.layers * r + c) + 4 * (nout // 3 + 1 + 1 + nout))
    return 2.0 * b * macs * t, float(step_bytes) * t


def first_apart(a: torch.Tensor, b: torch.Tensor, tol: float) -> list[int]:
    """Per row, the first sample where |a - b| > tol (the length if none)."""
    idx = torch.arange(a.shape[1], device=a.device).expand_as(a)
    return torch.where((a - b).abs() > tol, idx, a.shape[1]).min(dim=1).values.tolist()


def wavenet_profile(voc: WaveNetVocoder, cond: torch.Tensor, u: torch.Tensor, samples: int,
                    dtype: torch.dtype = torch.float32) -> None:
    """Device time by kernel over one generate call of ``samples`` samples
    (torch.profiler), and the device's busy share of that call's wall time."""
    from torch.profiler import ProfilerActivity, profile

    cond, u = cond[:, :samples].contiguous(), u[:, :samples].contiguous()
    packed = voc.packed_for(dtype)
    wavenet_ops.generate(packed, voc.cfg.dilations(), cond, u)  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        wavenet_ops.generate(packed, voc.cfg.dilations(), cond, u)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = [(e.key, e.count, getattr(e, "device_time_total", 0.0)) for e in prof.key_averages()
            if getattr(e, "device_time_total", 0.0) > 0 and "_kernel" in e.key]
    if not rows:
        log("wavenet profile: the profiler recorded no device time (not measured)")
        return
    busy = sum(r[2] for r in rows)
    for key, count, total in sorted(rows, key=lambda r: -r[2]):
        name = re.search(r"(\w+_kernel\w*)", key)
        log(f"wavenet profile: {name.group(1) if name else key[:40]}: {count} launches, {total / count:.2f} us each, "
            f"{total / samples:.1f} us per sample")
    log(f"wavenet profile: B={cond.shape[0]}, {samples} samples, device busy {busy:.0f} us of {wall_us:.0f} us wall "
        f"(idle share {1 - busy / wall_us:.3f})")


def phase_wavenet(dev: torch.device, trained: bool, mels: np.ndarray) -> dict:
    """WaveNet vocoding of the first WN_FRAMES frames of WN_B converted mels
    through WaveNetVocoder.generate, checks (i)-(iv), timings."""
    cfg = WaveNetConfig()
    art = ROOT / "artifacts" / "wavenet_105k.npz"
    voc = WaveNetVocoder(cfg, artifact=str(art) if trained else None, device=dev, seed=3)
    log(f"wavenet weights: {'artifacts/wavenet_105k.npz' if trained else 'seeded random, full width'}")
    mel = torch.from_numpy(np.ascontiguousarray(mels[:WN_B, :WN_FRAMES])).to(dev)
    t = WN_FRAMES * cfg.hop_size
    u = voc.uniforms(WN_B, t, torch.Generator().manual_seed(4))
    dils = cfg.dilations()

    torch.cuda.synchronize()
    wavenet_ops.launches = 0
    t0 = time.perf_counter()
    wav = voc.generate(mel, uniforms=u)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    launches, cuda_launches = wavenet_ops.launches, wavenet_ops.last_cuda_launches
    plan, per_sm, sms = wavenet_ops.last_launch
    log(f"wavenet main path (cold): {cold_s:.3f} s, wrapper launches={launches}, CUDA launches={cuda_launches} "
        f"(the plan's {plan.launches}; the per-layer kernels took T*(2L+1) = {t * (2 * cfg.layers + 1)})")
    log(f"wavenet plan: {plan.blocks} blocks, {per_sm} resident a SM on {sms} SMs; a block owns {plan.pairs} gate "
        f"column pairs, {plan.cols} residual columns and {plan.head_cols} head columns, a ring of {plan.depth} "
        f"phases of weights, {plan.smem} shared bytes; {cfg.layers + 2} grid barriers a sample")
    # (iv) one wrapper call, the plan's kernel launches
    if launches != 1 or cuda_launches != plan.launches:
        raise AssertionError(f"wavenet launches: wrapper {launches}, CUDA {cuda_launches}, plan {plan.launches}")
    # (iii) the waveform
    if wav.shape != (WN_B, t) or not bool(torch.isfinite(wav).all()) or float(wav.abs().max()) > 1.0:
        raise AssertionError(f"wavenet waveform {tuple(wav.shape)} finite={bool(torch.isfinite(wav).all())} "
                             f"max|x|={float(wav.abs().max())}")

    with torch.inference_mode():
        cond = voc.model.upsample_conditioning(mel)
        y, logits = wavenet_ops.generate(voc.packed, dils, cond, u, cfg.log_scale_min)
        torch.cuda.synchronize()
        # (iv) a second identical call, the same waveform bit for bit
        if not torch.equal(y, wav):
            raise AssertionError("the kernel gave another waveform on the same inputs")
        log("wavenet (iv) a second call on the same inputs: the same waveform bit for bit")
        # (i) teacher-forced forward on the kernel's own waveform
        tf_err = (logits - voc.logits(y[..., None], mel)).abs().max().item()
        log(f"wavenet (i) kernel logits vs teacher-forced forward: max_abs_err={tf_err:.3e} (tol {WN_TF_TOL})")
        if not tf_err <= WN_TF_TOL:
            raise AssertionError(f"wavenet teacher-forced check: {tf_err} > {WN_TF_TOL}")
        # (ii) the plain loop on the first WN_PLAIN samples of the same uniforms, timed
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        y_ref, _ = wavenet_ops.generate_ref(voc.packed, dils, cond[:, :WN_PLAIN].contiguous(),
                                            u[:, :WN_PLAIN].contiguous(), cfg.log_scale_min)
        end.record()
        torch.cuda.synchronize()
        plain_ms = start.elapsed_time(end)
        apart = first_apart(y[:, :WN_PLAIN], y_ref, WN_PREFIX_TOL)
        prefix = min(apart)
        prefix_err = (y[:, :prefix] - y_ref[:, :prefix]).abs().max().item() if prefix else float("inf")
        log(f"wavenet (ii) kernel vs plain loop over {WN_PLAIN} samples: first sample apart by > {WN_PREFIX_TOL} "
            f"per row {apart}; max_abs_err over the common prefix {prefix_err:.3e}")
        if prefix < WN_MIN_PREFIX:
            raise AssertionError(f"wavenet kernel leaves the plain loop at sample {prefix} < {WN_MIN_PREFIX}")
        ms = cuda_ms(lambda: wavenet_ops.generate(voc.packed, dils, cond, u, cfg.log_scale_min), reps=3)
        torch.cuda.synchronize()
        phases = cfg.layers + 2  # the grid barriers a sample
        for rows in WN_TIME_B:
            mel_b = torch.from_numpy(np.ascontiguousarray(mels[:rows, :WN_FRAMES])).to(dev)
            cond_b = voc.model.upsample_conditioning(mel_b)
            u_b = voc.uniforms(rows, t, torch.Generator().manual_seed(5))
            b_ms = ms if rows == WN_B else cuda_ms(
                lambda: wavenet_ops.generate(voc.packed, dils, cond_b, u_b, cfg.log_scale_min), reps=2)
            b_bound, _ = bound_ms(*wavenet_work(cfg, voc.packed, rows, t))
            log(f"wavenet B={rows}, T={t}: {b_ms:.3f} ms a call, {b_ms / t * 1e3:.2f} us a sample, "
                f"{b_ms / (t * phases) * 1e3:.3f} us a phase ({phases} phases a sample); bound {b_bound / t * 1e3:.2f} "
                f"us a sample; the per-layer kernels: {PER_LAYER_WN_US:.2f} us a sample at B=8 (card: {card_line()})")
        t0 = time.perf_counter()
        voc.generate(mel, uniforms=u)
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        for rows in (1, WN_B):
            wavenet_profile(voc, cond[:rows], u[:rows], samples=64)
    flops, nbytes = wavenet_work(cfg, voc.packed, WN_B, t)
    w_bound_ms, w_bound_by = bound_ms(flops, nbytes)
    audio_s = WN_B * t / cfg.sample_rate
    log(f"wavenet kernel: {ms:.3f} ms per call, {ms / t * 1e3:.2f} us per sample, "
        f"{WN_B * t / ms * 1e3:.0f} samples/s; bound {w_bound_ms:.3f} ms ({w_bound_by}), plain {plain_ms:.1f} ms over {WN_PLAIN} samples; "
        f"vocoder call {warm_s * 1e3:.1f} ms wall for {audio_s:.3f} s of audio ({audio_s / warm_s:.3f}x realtime) "
        f"(card: {card_line()})")
    # the larger of check (i)'s logit error and check (ii)'s sample error
    return {"launches": launches, "max_abs_err": max(tf_err, prefix_err), "ms": ms, "plain_ms": plain_ms,
            "plain_samples": WN_PLAIN,
            "bound_ms": w_bound_ms, "bound_by": w_bound_by}


def lstm_train_work(b: int, t: int, h: int) -> tuple[float, float]:
    """(flops, bytes) of one training-form forward sequence: the recurrent
    product, xproj + w_hh + h0 + c0 read once, h_seq, c_seq, hN, cN written
    once (c_seq is the training form's extra B*T*H floats)."""
    return 2.0 * b * t * h * 4 * h, 4.0 * (b * t * 4 * h + h * 4 * h + 2 * b * h + 2 * b * t * h + 2 * b * h)


def lstm_bwd_work(b: int, t: int, h: int) -> tuple[float, float]:
    """(flops, bytes) of one backward sequence with its dW: the gate
    recompute 2*B*T*H*4H, the dh contraction 2*B*T*4H*H and dW 2*T*B*H*4H;
    xproj, hprev, cprev, c and dy read once, w_hh read once, dxproj and dW
    written once."""
    return 3 * 2.0 * b * t * h * 4 * h, 4.0 * (2 * b * t * 4 * h + 4 * b * t * h + 2 * h * 4 * h)


def dw_work(b: int, t: int, h: int) -> tuple[float, float]:
    """(flops, bytes) of one dW product: 2*(B*T)*H*4H, hprev and dxproj
    read once, dW written once, float32."""
    return 2.0 * b * t * h * 4 * h, 4.0 * (b * t * h + b * t * 4 * h + h * 4 * h)


def cudnn_train_ms(dev: torch.device, hidden: int, h0: torch.Tensor, c0: torch.Tensor, dy: torch.Tensor,
                   dtype: torch.dtype = torch.float32) -> float:
    """Yardstick only: torch.nn.LSTM (cuDNN) in ``dtype``, one layer of H
    units on a (B, T, H) input, forward and backward from (h0, c0) with
    cotangent dy."""
    net = torch.nn.LSTM(hidden, hidden, batch_first=True).to(dev, dtype)
    x = torch.randn(dy.shape, device=dev, dtype=dtype, requires_grad=True)
    h0, c0, dy = h0.to(dtype), c0.to(dtype), dy.to(dtype)

    def run():
        out, _ = net(x, (h0[None], c0[None]))
        out.backward(dy)

    return cuda_ms(run, reps=3)


def cudnn_train_parts_ms(dev: torch.device, hidden: int, h0: torch.Tensor, c0: torch.Tensor, dy: torch.Tensor,
                         dtype: torch.dtype = torch.float32) -> tuple[float, float]:
    """Yardstick only: torch.nn.LSTM (cuDNN) in ``dtype``, one layer of H
    units on a (B, T, H) input that requires grad, from (h0, c0): the forward
    alone (its training form, which keeps what the backward needs) and the
    backward alone (data and weight gradients, over one retained graph; the
    input projection's included, which the port's kernels leave to other
    code)."""
    net = torch.nn.LSTM(hidden, hidden, batch_first=True).to(dev, dtype)
    x = torch.randn(dy.shape, device=dev, dtype=dtype, requires_grad=True)
    h0, c0, dy = h0.to(dtype), c0.to(dtype), dy.to(dtype)
    fwd_ms = cuda_ms(lambda: net(x, (h0[None], c0[None])), reps=3)
    out, _ = net(x, (h0[None], c0[None]))
    bwd_ms = cuda_ms(lambda: out.backward(dy, retain_graph=True), reps=3)
    return fwd_ms, bwd_ms


def phase_train_kernels(dev: torch.device) -> tuple[dict, dict]:
    """Phase 4 (a)-(b): the training-form forward, the backward and the dW
    kernels against their plain versions at the training shapes, timed."""
    rng = np.random.RandomState(10)
    b, t = TRAIN_B, TRAIN_T
    fwd = {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "flops": 0.0, "bytes": 0.0}
    bwd = {"max_abs_err": 0.0, "dw_rel_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "dw_ms": 0.0,
           "dw_library_ms": 0.0, "library_ms": 0.0, "library_fwd_bwd_ms": 0.0, "flops": 0.0, "bytes": 0.0}

    def arr(*shape, scale=1.0):
        return torch.from_numpy((rng.randn(*shape) * scale).astype(np.float32)).to(dev)

    for hidden, reverse, n in TRAIN_CASES:
        xproj = arr(b, t, 4 * hidden, scale=0.5)
        lim = 1.0 / np.sqrt(hidden)
        w_hh = torch.from_numpy(rng.uniform(-lim, lim, (hidden, 4 * hidden)).astype(np.float32)).to(dev)
        h0, c0 = arr(b, hidden, scale=0.5), arr(b, hidden, scale=0.5)
        dy, dhn, dcn = arr(b, t, hidden), arr(b, hidden), arr(b, hidden)
        fargs = (xproj, w_hh, h0, c0, reverse)
        # the training form as LSTMSequenceFn runs it: c_seq and the gate
        # activations kept for the backward, which takes them
        got = lstm_ops.lstm_forward_cuda(*fargs, with_cseq=True, with_gates=True)
        f_plan = plan_line("fwd")
        want = lstm_ops.lstm_sequence_train_ref(*fargs)
        gates_want = lstm_ops.lstm_gates_ref(xproj, w_hh, h0, want[0], reverse)
        torch.cuda.synchronize()
        f_err = max((g - w).abs().max().item() for g, w in zip(got, (*want, gates_want)))
        bargs = (xproj, w_hh, h0, c0, want[0], want[1], dy, dhn, dcn, reverse)
        bgot = lstm_ops.lstm_backward_cuda(*bargs, gates=got[4])
        b_plan = plan_line("bwd")
        bwant = lstm_ops.lstm_backward_ref(*bargs)
        torch.cuda.synchronize()
        b_err = max((bgot[i] - bwant[i]).abs().max().item() for i in (0, 2, 3))
        dw_rel = (bgot[1] - bwant[1]).abs().max().item() / bwant[1].abs().max().item()
        f_ms = cuda_ms(lambda: lstm_ops.lstm_forward_cuda(*fargs, with_cseq=True, with_gates=True), reps=3)
        f_plain = cuda_ms(lambda: lstm_ops.lstm_sequence_train_ref(*fargs), reps=1)
        b_ms = cuda_ms(lambda: lstm_ops.lstm_backward_cuda(*bargs, gates=got[4]), reps=3)
        b_plain = cuda_ms(lambda: lstm_ops.lstm_backward_ref(*bargs), reps=1)
        # the dW kernel alone: two calls the same bit for bit, its device time
        # beside torch.matmul's on the same operands (yardstick only) and its
        # bound; the wrapper's call time with CUDA events beside them
        dw_once = lstm_ops.lstm_weight_grad_cuda(want[0], h0, bgot[0], reverse)
        dw_same = torch.equal(dw_once, lstm_ops.lstm_weight_grad_cuda(want[0], h0, bgot[0], reverse))
        dw_plan = lstm_ops.dw_plan(b, t, hidden, torch.cuda.get_device_properties(dev).multi_processor_count)
        dw_call_ms = cuda_ms(lambda: lstm_ops.lstm_weight_grad_cuda(want[0], h0, bgot[0], reverse), reps=5)
        dw_ms = device_ms(lambda: lstm_ops.lstm_weight_grad_cuda(want[0], h0, bgot[0], reverse), reps=20)
        hprev = lstm_ops._hprev(want[0], h0, reverse).reshape(-1, hidden)
        dgates = bgot[0].reshape(-1, 4 * hidden)
        dw_lib = device_ms(lambda: hprev.T @ dgates, reps=20)
        dw_bound, dw_by = bound_ms(*dw_work(b, t, hidden))
        log(f"lstm dW H={hidden} {'reverse' if reverse else 'forward'}: plan {dw_plan.tiles_m} x {dw_plan.tiles_n} "
            f"tiles of {lstm_ops.DW_TILE} x {lstm_ops.DW_TILE}, K={b * t} split {dw_plan.splits} ways "
            f"({dw_plan.chunk} rows each), {dw_plan.blocks} blocks; device ms={dw_ms:.4f} torch.matmul={dw_lib:.4f} "
            f"bound_ms={dw_bound:.4f} ({dw_by}); wrapper call {dw_call_ms:.4f} ms (CUDA events); two calls "
            f"bit-identical: {dw_same}")
        if not dw_same:
            raise AssertionError(f"lstm dW kernel H={hidden}: two calls on the same inputs differ")
        lib_ms = cudnn_train_ms(dev, hidden, h0, c0, dy)
        lib_fwd_ms, lib_bwd_ms = cudnn_train_parts_ms(dev, hidden, h0, c0, dy)
        ff, fb = lstm_train_work(b, t, hidden)
        bf, bb = lstm_bwd_work(b, t, hidden)
        fbound, fby = bound_ms(ff, fb)
        bbound, bby = bound_ms(bf, bb)
        direction = "reverse" if reverse else "forward"
        log(f"lstm_fwd train form H={hidden} {direction}: max_abs_err={f_err:.3e} ms={f_ms:.4f} "
            f"({f_ms / t * 1e3:.2f} us a step) plain_ms={f_plain:.4f} bound_ms={fbound:.4f} ({fby}) "
            f"cudnn_fwd_ms={lib_fwd_ms:.4f} seqs_per_step={n}; {f_plan}")
        log(f"lstm_bwd H={hidden} {direction}: max_abs_err={b_err:.3e} dW_rel_err={dw_rel:.3e} ms={b_ms:.4f} "
            f"(dW {dw_call_ms:.4f}; recurrence {(b_ms - dw_call_ms) / t * 1e3:.2f} us a step) "
            f"plain_ms={b_plain:.4f} bound_ms={bbound:.4f} ({bby}) cudnn_bwd_ms={lib_bwd_ms:.4f} "
            f"cudnn_fwd_bwd_ms={lib_ms:.4f} seqs_per_step={n}; {b_plan}")
        if not (f_err <= LSTM_TOL and b_err <= LSTM_TOL and dw_rel <= LSTM_TOL):
            raise AssertionError(f"lstm training kernels H={hidden} reverse={reverse}: forward {f_err}, "
                                 f"backward {b_err}, dW relative {dw_rel} (tolerance {LSTM_TOL})")
        fwd["max_abs_err"] = max(fwd["max_abs_err"], f_err)
        bwd["max_abs_err"] = max(bwd["max_abs_err"], b_err)
        bwd["dw_rel_err"] = max(bwd["dw_rel_err"], dw_rel)
        for rec, vals in ((fwd, dict(ms=f_ms, plain_ms=f_plain, library_ms=lib_fwd_ms, flops=ff, bytes=fb)),
                          (bwd, dict(ms=b_ms, plain_ms=b_plain, dw_ms=dw_ms, dw_library_ms=dw_lib,
                                     dw_bound_ms=dw_bound, dw_call_ms=dw_call_ms, library_ms=lib_bwd_ms,
                                     library_fwd_bwd_ms=lib_ms, flops=bf, bytes=bb))):
            for k, v in vals.items():
                rec[k] = rec.get(k, 0.0) + n * v
    log(f"lstm dW a train step ({SEQS_PER_STEP} sequences): kernel {bwd['dw_ms']:.4f} ms (device), torch.matmul "
        f"{bwd['dw_library_ms']:.4f} ms (device), bound {bwd['dw_bound_ms']:.4f} ms; wrapper calls "
        f"{bwd['dw_call_ms']:.4f} ms (CUDA events) (card: {card_line()})")
    return fwd, bwd


def lstm_step_split(dev: torch.device) -> None:
    """Phase 4 (a'), a yardstick only: the microseconds a step of the
    training-form forward and of the backward's recurrence (dW taken out) at
    T=SPLIT_T for each H of SPLIT_HIDDEN and B of SPLIT_BATCH, and per H a
    least-squares line through B, us a step = fixed + per_row * B: what
    every step pays (the grid barrier, the staged loads' latency, the
    reduction) and what a batch row adds (the product)."""
    rng = np.random.RandomState(11)
    t = SPLIT_T
    for hidden in SPLIT_HIDDEN:
        steps = []
        for b in SPLIT_BATCH:
            lim = 1.0 / np.sqrt(hidden)
            w_hh = torch.from_numpy(rng.uniform(-lim, lim, (hidden, 4 * hidden)).astype(np.float32)).to(dev)
            xproj, h0, c0, dy = (torch.from_numpy(rng.randn(*shape).astype(np.float32) * 0.5).to(dev)
                                 for shape in [(b, t, 4 * hidden), (b, hidden), (b, hidden), (b, t, hidden)])
            out = lstm_ops.lstm_forward_cuda(xproj, w_hh, h0, c0, with_cseq=True, with_gates=True)
            f_ms = cuda_ms(lambda: lstm_ops.lstm_forward_cuda(xproj, w_hh, h0, c0, with_cseq=True, with_gates=True),
                           reps=5)
            f_plan = lstm_ops.last_launch["fwd"][0]
            b_ms = cuda_ms(lambda: lstm_ops.lstm_backward_cuda(xproj, w_hh, h0, c0, out[0], out[1], dy,
                                                               gates=out[4]), reps=5)
            b_plan = lstm_ops.last_launch["bwd"][0]
            dw_ms = cuda_ms(lambda: lstm_ops.lstm_weight_grad_cuda(out[0], h0, out[4]), reps=5)
            steps.append((b, f_ms / t * 1e3, (b_ms - dw_ms) / t * 1e3))
            log(f"lstm step split H={hidden} B={b} T={t}: forward {steps[-1][1]:.3f} us a step (regime "
                f"{f_plan.regime}, {f_plan.blocks} blocks, {f_plan.rows} rows), backward {steps[-1][2]:.3f} us a "
                f"step (regime {b_plan.regime}, {b_plan.blocks} blocks, {b_plan.rows} rows)")
        bs = np.array([s[0] for s in steps], dtype=float)
        for name, col in (("forward", 1), ("backward", 2)):
            per_row, fixed = np.polyfit(bs, np.array([s[col] for s in steps]), 1)
            log(f"lstm step split H={hidden} {name}: {fixed:.3f} us a step + {per_row:.3f} us a batch row "
                f"(least squares over B in {list(SPLIT_BATCH)})")


def synthetic_features(root: str, rng: np.random.RandomState, kind: str, n_bins: int, speakers: int = TRAIN_B,
                       utts: int = 4) -> str:
    """A train.pkl feature directory <root>/<kind> of smooth spectra in
    [0, 1] (an envelope a speaker, slow modulation, noise), 100-300 frames
    each, with unit-norm random embeddings."""
    feat_dir = os.path.join(root, kind)
    entries = []
    for s in range(speakers):
        os.makedirs(os.path.join(feat_dir, f"s{s}"))
        env = 0.3 + 0.4 * rng.rand(n_bins)
        paths = []
        for u in range(utts):
            t = rng.randint(100, 300)
            mod = 0.15 * np.sin(np.arange(t)[:, None] / rng.uniform(3, 12) + np.arange(n_bins)[None] / 9.0)
            feat = np.clip(env + mod + 0.05 * rng.randn(t, n_bins), 0.0, 1.0).astype(np.float32)
            np.save(os.path.join(feat_dir, f"s{s}", f"u{u}.npy"), feat)
            paths.append(f"s{s}/u{u}.npy")
        emb = rng.randn(256).astype(np.float32)
        entries.append(SpeakerEntry(f"s{s}", emb / np.linalg.norm(emb), paths))
    save_train_manifest(os.path.join(feat_dir, "train.pkl"), entries)
    return feat_dir


def counts() -> tuple[int, int, int]:
    return lstm_ops.launches, lstm_ops.bwd_launches, lstm_ops.dw_launches


# every LSTM wrapper's launch count (ops.lstm), in the order 8e reads them
LSTM_COUNTERS = ("launches", "bf16_launches", "scan_launches", "bwd_launches", "bf16_bwd_launches",
                 "scan_bwd_launches", "dw_launches", "gates_launches")


def zero_counts() -> None:
    for c in LSTM_COUNTERS + ("scan_dw_launches",):
        setattr(lstm_ops, c, 0)


def all_counts() -> tuple[int, ...]:
    return tuple(getattr(lstm_ops, c) for c in LSTM_COUNTERS)


def device_activity(fn, reps: int = 1, counter=counts) -> tuple[list[tuple[str, int, float]], float, tuple[int, ...]]:
    """``reps`` warm calls of ``fn`` under torch.profiler: (key, launches,
    device us) of every kernel and copy over them, the wall us a call, and
    the LSTM launches the wrappers counted over the ``reps`` calls (by
    ``counter``: forward, backward, dW)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()  # warm
    torch.cuda.synchronize()
    before = counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6 / reps
    # device activity only: kernels and copies, not the GPU ranges of
    # annotations such as Optimizer.step, which span kernels counted already
    rows = [(e.key, e.count, e.device_time_total) for e in prof.key_averages()
            if getattr(e, "device_type", None) == DeviceType.CUDA and e.device_time_total > 0
            and not getattr(e, "is_user_annotation", False) and "#" not in e.key]
    return rows, wall_us, tuple(a - b for a, b in zip(counter(), before))


# the LSTM kernels' name stems (lstm_fwd_block_kernel, lstm_fwd_grid_kernel,
# ...) -> the place of their wrapper's launch count in counts()
LSTM_KINDS = {"lstm_fwd": 0, "lstm_bwd": 1, "lstm_dw": 2}


# device_ms's and 8b's profiles: the wrappers' launch counts in this order,
# and the kernels' name stems (the gates kernel's included)
BF16_KINDS = {"lstm_fwd": 0, "lstm_bwd": 1, "lstm_dw": 2, "lstm_gates": 3}


def profile_counts() -> tuple[int, int, int, int]:
    """The launches in BF16_KINDS' order: forward, backward, dW, gates."""
    return lstm_ops.launches, lstm_ops.bwd_launches, lstm_ops.dw_launches, lstm_ops.gates_launches


def lstm_records(rows, launched: tuple[int, ...], kinds_of: dict[str, int] = LSTM_KINDS
                 ) -> tuple[float, dict[str, tuple[float, int, int]]]:
    """The device us of the LSTM launches whose records torch.profiler
    dropped (it drops some records of the cooperative kernels), each counted
    at its kind's mean over the records kept; and for each kind (mean us of a
    recorded launch, launches recorded, launches its wrapper counted).
    Raises where the profiler recorded more launches than were made."""
    missing, kinds = 0.0, {}
    for stem, i in kinds_of.items():
        total = sum(t for key, _, t in rows if stem + "_" in key)
        recorded = sum(c for key, c, _ in rows if stem + "_" in key)
        if recorded > launched[i]:
            raise AssertionError(f"the profiler recorded {recorded} {stem} launches, the wrapper made {launched[i]}")
        mean = total / recorded if recorded else 0.0
        missing += (launched[i] - recorded) * mean
        kinds[stem] = (mean, recorded, launched[i])
    return missing, kinds


def train_profile(solver: Solver, x: torch.Tensor, emb: torch.Tensor, launches: tuple[int, int, int],
                  shape: str = f"B={TRAIN_B}, T={TRAIN_T}") -> None:
    """Device time by kind over one warm train step (torch.profiler) and the
    device's idle share of that step's wall time; beside the LSTM kinds, how
    many of the step's ``launches`` (forward, backward, dW) the profiler
    recorded; a dropped record counts at its kind's mean (``lstm_records``).
    Raises unless the wrappers counted ``launches`` over the step."""
    rows, wall_us, launched = device_activity(lambda: solver._step_fn(solver.state, x, emb))
    if launched != tuple(launches):
        raise AssertionError(f"the profiled step launched {launched} (forward, backward, dW), expected {launches}")
    if not rows:
        log("train profile: the profiler recorded no device time (not measured)")
        return
    names = ["lstm forward (lstm_fwd_block_kernel, lstm_fwd_grid_kernel)",
             "lstm backward (lstm_bwd_block_kernel, lstm_bwd_grid_kernel)", "dW (lstm_dw_kernel)"]
    kinds = {k: [0.0, 0] for k in names + ["cuDNN convolutions", "rest"]}
    rest = []
    for key, count, total in rows:
        if "lstm_bwd_block_kernel" in key or "lstm_bwd_grid_kernel" in key:
            kind = names[1]
        elif "lstm_dw_kernel" in key:
            kind = names[2]
        elif "lstm_fwd_block_kernel" in key or "lstm_fwd_grid_kernel" in key:
            kind = names[0]
        elif any(w in key.lower() for w in ("conv", "cudnn", "xmma", "implicit", "wgrad", "dgrad", "fprop")):
            kind = "cuDNN convolutions"
        else:
            kind = "rest"
            rest.append((total, count, key[:70]))
        kinds[kind][0] += total
        kinds[kind][1] += count
    _, lstm = lstm_records(rows, launched)
    for name, (mean, recorded, made) in zip(names, lstm.values()):
        kinds[name][0] += (made - recorded) * mean
    busy = sum(total for total, _ in kinds.values())
    expected = dict(zip(names, launched))
    for kind, (total, count) in kinds.items():
        seen = (f"; {count} of its {expected[kind]} launches recorded, the rest at their mean"
                if kind in expected else "")
        log(f"train profile: {kind}: {total / 1e3:.3f} ms ({total / busy:.3f} of device time{seen})")
    for total, count, key in sorted(rest, reverse=True)[:6]:
        log(f"train profile:   rest: {key}: {count} launches, {total / 1e3:.3f} ms")
    log(f"train profile: one step at {shape}: device busy {busy / 1e3:.3f} ms of "
        f"{wall_us / 1e3:.3f} ms wall (idle share {1 - busy / wall_us:.3f})")


def step_gate(dev: torch.device, cfg: Config, x: torch.Tensor, emb: torch.Tensor, label: str) -> dict:
    """One train step with the kernels against the same step with the plain
    recurrence on the kernel step's side of every ReLU, PReLU and abs kink
    (``KinkTape``): the loss within LOSS_RTOL relative, every gradient leaf
    within GRAD_TOL of its scale, SEQS_PER_STEP sequences forward, backward
    and dW. Returns the readings, the tape, and both steps' gradients
    (float64 copies) as "kernels" and "plain_kinked"."""
    step = make_train_step(cfg)
    states = {}
    for name in ("kernels", "plain_kinked"):
        model = build_generator(cfg.model, device=dev, seed=7, trainable=True)
        states[name] = TrainState(0, model, make_optimizer(model, cfg), init_ema(model))
    tape = KinkTape()
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    with tape.record():
        mk = step(states["kernels"], x, emb)
        torch.cuda.synchronize()
    k_s, k_counts = time.perf_counter() - t0, counts()
    with plain_recurrence(), tape.replay():
        mp = step(states["plain_kinked"], x, emb)
        torch.cuda.synchronize()
    if counts() != k_counts or k_counts != (SEQS_PER_STEP,) * 3:
        raise AssertionError(f"{label}: the kernel step launched {k_counts} (forward, backward, dW), expected "
                             f"{SEQS_PER_STEP} each; the plain step {counts()}")
    loss_k, loss_p = mk["g_loss"].item(), mp["g_loss"].item()
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    grads = {k: {n: p.grad.double() for n, p in st.model.named_parameters()} for k, st in states.items()}
    errs = {n: (g - grads["plain_kinked"][n]).abs().max().item() / grad_scale(n, grads["plain_kinked"])
            for n, g in grads["kernels"].items()}
    worst = max(errs.items(), key=lambda kv: kv[1])
    kinds = sorted({k for k, _ in tape.sides})
    log(f"{label} one step with the kernels vs the plain recurrence on the same kinks ({', '.join(kinds)}: "
        f"{tape.elements} elements, {tape.flips} on the other side in the plain step): loss {loss_k!r} vs "
        f"{loss_p!r} (rel {loss_rel:.3e}, tol {LOSS_RTOL}); worst gradient leaf {worst[0]} at {worst[1]:.3e} of "
        f"its scale (tol {GRAD_TOL}); launches (fwd, bwd, dW) {k_counts}; first step {k_s * 1e3:.1f} ms; terms "
        + ", ".join(f"{k} {float(v):.5f}" for k, v in mk.items() if k.startswith("g_loss_")))
    if not (loss_rel <= LOSS_RTOL and worst[1] <= GRAD_TOL):
        raise AssertionError(f"{label}: the kernel step's loss {loss_rel} (tolerance {LOSS_RTOL}), gradient "
                             f"{worst} (tolerance {GRAD_TOL}) from the plain step on the same kinks")
    return {"loss_rel": loss_rel, "grad_err": worst[1], "kinds": kinds, "flips": tape.flips, "tape": tape,
            "grads": grads, "metrics": {k: float(v) for k, v in mk.items()}}


def phase_training(dev: torch.device) -> dict:
    """Phase 4 (c)-(e): the train step with the kernels against the plain
    recurrence, 20 Solver steps, a checkpoint round trip."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        rng = np.random.RandomState(20)
        mel_dir = synthetic_features(tmp, rng, "spmel", N_MELS)
        cfg = Config(train=TrainConfig(batch_size=TRAIN_B, len_crop=TRAIN_T, num_iters=TRAIN_STEPS, log_step=1,
                                       checkpoint_step=TRAIN_STEPS), main_dir=tmp, run_name="smoke")
        data = UtteranceDataset(mel_dir)
        x, emb = (torch.from_numpy(a).to(dev) for a in next(BatchIterator(data, TRAIN_B, TRAIN_T, seed=1)))

        # (c) one step with the kernels vs the same step with the plain
        # recurrence on the kernel step's side of every ReLU and abs kink
        # (step_gate); then the plain step as it falls, and in f64 on the
        # same kinks as the truth
        gate = step_gate(dev, cfg, x, emb, "train (c)")
        tape, grads = gate["tape"], gate["grads"]

        def plain_step(name: str, dtype=torch.float32):
            model = build_generator(cfg.model, device=dev, seed=7, trainable=True).to(dtype)
            state = TrainState(0, model, make_optimizer(model, cfg), init_ema(model))
            with plain_recurrence():
                t0 = time.perf_counter()
                m = step(state, x.to(dtype), emb.to(dtype))
                torch.cuda.synchronize()
            if {p.grad.dtype for p in model.parameters()} != {dtype}:
                raise AssertionError(f"the plain step did not compute its gradients in {dtype}")
            grads[name] = {n: p.grad.double() for n, p in model.named_parameters()}
            return m, time.perf_counter() - t0

        step = make_train_step(cfg)
        before = counts()
        _, p_s = plain_step("plain")
        with tape.replay():
            m64, _ = plain_step("f64", torch.float64)
        if counts() != before:
            raise AssertionError(f"the plain steps launched kernels: {before} -> {counts()}")

        def leaf_errors(a: str, b: str) -> dict[str, float]:
            return {n: (g - grads[b][n]).abs().max().item() / grad_scale(n, grads[b]) for n, g in grads[a].items()}

        pairs = (("kernels", "plain"), ("kernels", "f64"), ("plain_kinked", "f64"))
        errs = {pair: leaf_errors(*pair) for pair in pairs}
        worst = {pair: max(e.items(), key=lambda kv: kv[1]) for pair, e in errs.items()}
        # every leaf of the kernel step as near the f64 step as twice the
        # plain step's distance on that leaf, plus GRAD_TOL
        over_f64 = {n: (e, errs[("plain_kinked", "f64")][n]) for n, e in errs[("kernels", "f64")].items()
                    if e > 2 * errs[("plain_kinked", "f64")][n] + GRAD_TOL}
        log(f"train (c) f64 step loss {m64['g_loss'].item()!r} ({m64['g_loss'].dtype}); the plain step as it falls "
            f"{p_s * 1e3:.1f} ms; kinks on the other side of the kernel step's: {gate['flips']} in the plain f32 "
            f"step, {tape.flips} in the f64 step")
        for (a, b), (name, e) in worst.items():
            log(f"train (c) worst gradient leaf, {a} vs {b}: {name} at {e:.3e} of its scale")
        if over_f64:
            raise AssertionError(f"train step with the kernels: leaves farther from f64 than twice the plain "
                                 f"step's plus {GRAD_TOL}: {over_f64}")
        del grads, gate

        # (d) 20 Solver steps through the entry point
        run_dir = os.path.join(tmp, "run")
        solver = Solver(cfg, BatchIterator(data, TRAIN_B, TRAIN_T, seed=2), run_dir=run_dir, device=dev)
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        solver.train()
        torch.cuda.synchronize()
        train_s, train_counts = time.perf_counter() - t0, counts()
        losses = [h["g_loss"] for h in solver.history]
        timing = solver.timer.summary()
        first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
        log(f"train (d) {TRAIN_STEPS} Solver steps in {train_s:.2f} s wall (checkpoint included): g_loss "
            f"{losses[0]:.4f} -> {losses[-1]:.4f}, mean of first 5 {first:.4f}, last 5 {last:.4f}; "
            f"launches (fwd, bwd, dW) {train_counts}; step p50 {timing['step_ms_p50']:.2f} ms, "
            f"p95 {timing['step_ms_p95']:.2f} ms, {timing['steps_per_sec']:.2f} steps/s (card: {card_line()})")
        if len(losses) != TRAIN_STEPS or not np.isfinite(losses).all() or not last < first:
            raise AssertionError(f"training did not go down finitely: {losses}")
        if train_counts != (TRAIN_STEPS * SEQS_PER_STEP,) * 3:
            raise AssertionError(f"{TRAIN_STEPS} steps launched {train_counts}")

        # (e) resume from the step-20 checkpoint
        saved = {k: v.clone() for k, v in solver.state.model.state_dict().items()}
        resumed = Solver(cfg, BatchIterator(data, TRAIN_B, TRAIN_T, seed=3), run_dir=run_dir, device=dev)
        same = all(torch.equal(saved[k], v) for k, v in resumed.state.model.state_dict().items()) and all(
            torch.equal(solver.state.ema_params[k], v) for k, v in resumed.state.ema_params.items())
        log(f"train (e) resume: checkpoints {resumed.checkpoint_steps()}, step {resumed.state.step}, "
            f"parameters, statistics and EMA equal: {same}; save stalls {solver.save_stall_ms} ms")
        if resumed.state.step != TRAIN_STEPS or not same:
            raise AssertionError("the resumed Solver does not hold the step-20 state")
        del solver, saved
        train_profile(resumed, x, emb, (SEQS_PER_STEP,) * 3)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if os.path.exists(tmp):
        raise AssertionError(f"{tmp} was not removed")
    return {"launches": train_counts, "step_ms_p50": timing["step_ms_p50"]}


SR = 16_000
FEAT_SPEAKERS, FEAT_UTTS = 4, 24  # the corpus of phase 5: about 480 s of audio
TIME_B, TIME_L = 32, 512 * HOP  # the kernels' timing batch: 32 rows of 131072 samples, 513 frames each
MELNORM_TOL = 1e-5  # kernel vs plain: non-negative terms, a reordered f32 sum, after 20 log10 / 100
# sosfilt: each row no farther from scipy's float64 filter than twice the plain
# (sequential float32) pass, plus this share of the row's max-abs; chunk 0 the
# plain pass bit for bit (the chunked scan rounds otherwise, ops/sosfilt.py)
SOS_F64_SLACK = 1e-6
# card vs CPU front end; for stft/legacy within 40 dB (0.4) of each frame's loudest bin, and 10x more
# for each further 20 dB (two FFTs' rounding, ~1e-6 of the frame's peak, through the dB step)
FE_TOL, NEAR_PEAK = 1e-4, 0.4
EXACT_TOL = 1e-3  # the f32 card path vs the f64 host chain (tests/test_cli.py:170-177)
# ... which the CPU's sequential f32 highpass itself may exceed (its rounding
# near DC, PERF.md §6): in (d) the card is held to the f64 chain at EXACT_TOL
# or the CPU f32 chain's own distance plus FE_TOL, and (c) and (e) hold the
# stages after the highpass to the CPU's at FE_TOL (the two highpasses round
# otherwise)
SEQUENTIAL_CYCLES = 16  # a sample's dependent chain through one section: 4 f32 operations x ~4 cycles
F64_FMA_CYCLES = 8  # one dependent float64 FMA
SM_CLOCK_HZ = 1.98e9  # H100 SXM boost clock
F64_FMAS_PER_SM_CYCLE = 64  # an H100 SM's float64 lanes


def sosfilt_chain_cycles(plan: sosfilt_ops.ScanPlan) -> int:
    """The dependent chain of one pass of the chunked scan (csrc/sosfilt.cu):
    phase 1's C float64 FMAs a state entry, each scan level's 2S dependent
    float64 FMAs, phase 3's C samples of the float64 cascade at three
    dependent FMAs a sample (barriers not counted)."""
    return (plan.chunk * F64_FMA_CYCLES + plan.levels * 2 * plan.sections * F64_FMA_CYCLES
            + plan.chunk * 3 * F64_FMA_CYCLES)


def sosfilt_fma_cycles(length: int, sections: int = 3) -> float:
    """One pass's float64 FMAs on the row's one SM: 2S a sample in phase 1
    and 5S in phase 3's cascade (the conversions between float32 and
    float64 not counted)."""
    return length * 7 * sections / F64_FMAS_PER_SM_CYCLE


def utterance(rng: np.random.RandomState, n: int, f0_base: float, loud: float) -> np.ndarray:
    """A voiced utterance: a strong fundamental on a gliding pitch contour
    plus a sawtooth source through 2-3 formant-like resonators, a syllable
    envelope, a -60 dB noise floor and 1-3 silent gaps (digital zero, so
    only the dither remains there). Loud vowels clip the dB step at 1, the
    gaps at 0."""
    import scipy.signal

    t = np.arange(n) / SR
    f0 = f0_base * (1.0 + 0.12 * np.sin(2 * np.pi * rng.uniform(0.3, 1.2) * t + rng.uniform(0, 6.3)))
    phase = np.cumsum(f0 * (1.0 + 0.01 * rng.randn())) / SR
    saw = 2.0 * (phase % 1.0) - 1.0
    formants = np.zeros(n)
    for (lo, hi, bw), gain in list(zip(((250, 700, 40), (900, 2500, 120), (2200, 3300, 180)), (3.0, 1.0, 1.0)))[
            : rng.randint(2, 4)]:
        fc, r = rng.uniform(lo, hi), np.exp(-np.pi * bw / SR)
        formants += gain * scipy.signal.lfilter([1 - r], [1, -2 * r * np.cos(2 * np.pi * fc / SR), r * r], saw)
    y = np.sin(2 * np.pi * phase) + 0.35 * formants / np.abs(formants).max()
    y *= 0.55 + 0.45 * np.sin(2 * np.pi * rng.uniform(2, 5) * t + rng.uniform(0, 6.3))
    y *= loud / np.abs(y).max()
    y += 1e-3 * rng.randn(n)
    for _ in range(rng.randint(1, 4)):
        g0 = rng.randint(0, n - 6400)
        y[g0 : g0 + rng.randint(1600, 6400)] = 0.0
    return np.clip(y, -1.0, 1.0).astype(np.float32)


def write_corpus(root: str, rng: np.random.RandomState) -> list[str]:
    """<root>/wavs/<speaker>/<speaker>_<utt>.wav, 16 kHz 16-bit: FEAT_SPEAKERS
    speakers x FEAT_UTTS utterances of 2-8 s. Returns the paths in the CLI's
    order."""
    paths = []
    for s in range(FEAT_SPEAKERS):
        spk = f"p9{s:02d}"
        os.makedirs(os.path.join(root, "wavs", spk))
        for u in range(FEAT_UTTS):
            x = utterance(rng, int(rng.uniform(2.0, 8.0) * SR), (110.0, 150.0, 200.0, 240.0)[s], rng.uniform(0.5, 0.99))
            path = os.path.join(root, "wavs", spk, f"{spk}_{u:03d}.wav")
            write_wav(path, x)
            paths.append(path)
    return paths


def mel_work(t: int, spans: torch.Tensor) -> tuple[float, float]:
    """(flops, bytes) at T frames of a basis with these ``filter_spans``:
    2*T*nnz, the products over each filter's own bins (the epilogue's few
    operations and one log10 per output not counted); of mag only the bins
    that some filter spans (min lo .. max hi) read once, each filter's
    weights read once, out written once, float32."""
    spans = spans.cpu().long()
    nnz = int((spans[:, 1] - spans[:, 0]).sum())
    band = int(spans[:, 1].max() - spans[:, 0].min())
    return 2.0 * t * nnz, 4.0 * (t * band + nnz + t * spans.shape[0])


def dense_mel_work(t: int, k: int, m: int) -> tuple[float, float]:
    """(flops, bytes) of the dense product that PR 9's kernel ran: 2*T*K*M,
    all of mag and the basis read once, out written once."""
    return 2.0 * t * k * m, 4.0 * (t * k + k * m + t * m)


def feature_check_mel(dev: torch.device, batch: torch.Tensor) -> dict:
    """(a) the mel kernel against mel_normalize_ref on the |STFT| of the
    timing batch (32 x 513 frames, 513 bins), one frame, a frame count that
    is no multiple of the tile, and the 257-bin legacy STFT; timed beside
    the plain version and torch.matmul of the projection alone."""
    basis = torch.from_numpy(np.ascontiguousarray(mel_filterbank())).to(dev)
    mag = stft_magnitude(batch).reshape(-1, 513)  # (16416, 513)
    legacy = stft_magnitude(batch[:2], 512).reshape(-1, 257)
    legacy_basis = torch.from_numpy(np.ascontiguousarray(mel_filterbank(SR, 512, 80))).to(dev)
    err = 0.0
    for name, m, b in (("B*T=16416, 513 bins", mag, basis), ("T=1", mag[:1], basis),
                       ("T=1000", mag[:1000].contiguous(), basis), ("T=1026, 257 bins", legacy, legacy_basis)):
        got, want = mel_ops.mel_normalize(m, b), mel_ops.mel_normalize_ref(m, b)
        torch.cuda.synchronize()
        case_err = (got - want).abs().max().item()
        log(f"mel_norm (a) {name}: max_abs_err={case_err:.3e} (tol {MELNORM_TOL}); output at 0: "
            f"{(want == 0).float().mean().item():.4f}, at 1: {(want == 1).float().mean().item():.4f}")
        if not case_err <= MELNORM_TOL:
            raise AssertionError(f"mel kernel {name}: {case_err} > {MELNORM_TOL}")
        err = max(err, case_err)
    spans = mel_ops.filter_spans(basis)
    nnz = int((spans[:, 1] - spans[:, 0]).sum().item())
    plan = mel_ops.tile_plan(*mag.shape, basis.shape[1])
    log(f"mel_norm (a) plan at (16416, 513) x (513, 80): {plan}; the basis's nonzeros {nnz} of "
        f"{basis.numel()} in bins {int(spans[:, 0].min())}..{int(spans[:, 1].max()) - 1}, widest filter "
        f"{int((spans[:, 1] - spans[:, 0]).max())} bins")
    # CUDA events around a loop of calls, as every kernel's `ms`; and the
    # device time alone (torch.profiler), without the host's gaps between
    # calls this short
    ms = cuda_ms(lambda: mel_ops.mel_normalize(mag, basis), reps=50)
    plain_ms = cuda_ms(lambda: mel_ops.mel_normalize_ref(mag, basis), reps=50)
    lib_ms = cuda_ms(lambda: torch.matmul(mag, basis), reps=50)
    dev_ms = device_ms(lambda: mel_ops.mel_normalize(mag, basis), reps=50)
    plain_dev_ms = device_ms(lambda: mel_ops.mel_normalize_ref(mag, basis), reps=50)
    lib_dev_ms = device_ms(lambda: torch.matmul(mag, basis), reps=50)
    bound, bound_by = bound_ms(*mel_work(mag.shape[0], spans))
    dense_bound, _ = bound_ms(*dense_mel_work(*mag.shape, basis.shape[1]))
    log(f"mel_norm (a) at (16416, 513) x (513, 80), CUDA events: ms={ms:.4f} plain_ms={plain_ms:.4f} "
        f"torch.matmul (projection only)={lib_ms:.4f}; device time: {dev_ms:.4f} / {plain_dev_ms:.4f} / "
        f"{lib_dev_ms:.4f}; bound_ms={bound:.4f} ({bound_by}: the spanned bins of mag, the filters' weights, "
        f"the outputs; the dense product's bound {dense_bound:.4f})")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by,
            "library_ms": lib_ms, "device_ms": dev_ms, "plain_device_ms": plain_dev_ms,
            "library_device_ms": lib_dev_ms}


def sosfilt_gate(got: torch.Tensor, want: torch.Tensor, sos: torch.Tensor, x: torch.Tensor, zi: torch.Tensor,
                 what: str) -> tuple[float, float]:
    """Hold one pass to the kernel's gate, row by row, against scipy's float64
    filter of the same float32 inputs: chunk 0 the plain pass bit for bit,
    and the kernel no farther from float64 than twice the plain pass plus
    SOS_F64_SLACK of the row's max-abs. Returns the largest |kernel - plain|
    and the worst row's distance from float64 as a share of its gate."""
    sos64 = sos.double().cpu().numpy()
    exact = np.stack([scipy_signal.sosfilt(sos64, r, zi=z)[0]
                      for r, z in zip(x.double().cpu().numpy(), zi.double().cpu().numpy())])
    got, want = got.cpu(), want.cpu()
    chunk = sosfilt_ops.scan_plan(x.shape[1]).chunk
    same = torch.equal(got[:, :chunk], want[:, :chunk])
    far = np.abs(got.double().numpy() - exact).max(axis=1)
    plain = np.abs(want.double().numpy() - exact).max(axis=1)
    gate = 2 * plain + SOS_F64_SLACK * np.abs(exact).max(axis=1)
    err = (got - want).abs().max().item()
    log(f"sosfilt (b) {what}: max |kernel - plain| {err:.3e}; chunk 0 ({chunk} samples) bit for bit the plain "
        f"pass: {same}; from float64 the "
        f"kernel {far.max():.3e}, the plain pass {plain.max():.3e}; worst row at {(far / gate).max():.3f} of its "
        f"gate (2 x plain + {SOS_F64_SLACK} x row max-abs); rows bit for bit the plain pass: "
        f"{int(sum(torch.equal(a, b) for a, b in zip(got, want)))} of {got.shape[0]}")
    if not (same and (far <= gate).all()):
        raise AssertionError(f"sosfilt kernel {what}: chunk 0 equal {same}, distances {far.tolist()} against "
                             f"gates {gate.tolist()}")
    return err, float((far / gate).max())


def feature_check_sosfilt(dev: torch.device, batch: torch.Tensor) -> dict:
    """(b) the filter kernel against sosfilt_ref and scipy's float64 filter
    (``sosfilt_gate``) on 4 rows of 16000 samples and 2 rows of 80000 (a
    5-s file, 1013 chunks), forward and backward pass as sos_filtfilt runs
    them; both passes timed at 32 rows of 131072 samples, and beside the
    plain version on the first eighth of the same rows."""
    sos = torch.from_numpy(butter_highpass_sos().astype(np.float32)).to(dev)
    zi_unit = torch.from_numpy(scipy_signal.sosfilt_zi(butter_highpass_sos()).astype(np.float32)).to(dev)
    for length in (16_000, 80_036, TIME_L + 36):
        log(f"sosfilt (b) plan at L={length}: {sosfilt_ops.scan_plan(length)}")

    err = share = 0.0
    for x in (batch[:4, :16_000].contiguous(), batch[4:6, :80_000].contiguous()):
        for i in range(2):
            zi = zi_unit * x[:, :1, None]
            got, want = sosfilt_ops.sosfilt(sos, x, zi), sosfilt_ops.sosfilt_ref(sos, x, zi)
            torch.cuda.synchronize()
            case = sosfilt_gate(got, want, sos, x, zi, f"pass {i + 1} ({x.shape[0]} x {x.shape[1]})")
            err, share = max(err, case[0]), max(share, case[1])
            x = want.flip(-1).contiguous()  # the backward pass filters the plain forward pass, reversed
    # the two launches alone, on the inputs sos_filtfilt gives them
    zi1 = zi_unit * batch[:, :1, None]
    back = sosfilt_ops.sosfilt(sos, batch, zi1).flip(-1).contiguous()
    zi2 = zi_unit * back[:, :1, None]
    ms = cuda_ms(lambda: (sosfilt_ops.sosfilt(sos, batch, zi1), sosfilt_ops.sosfilt(sos, back, zi2)), reps=5)
    dev_ms = device_ms(lambda: (sosfilt_ops.sosfilt(sos, batch, zi1), sosfilt_ops.sosfilt(sos, back, zi2)),
                       reps=20)
    # the host's cost of a chunk length met for the first time (its tables
    # made on the host and copied to the card) against a call that finds them
    row = batch[:1, :100_000]
    zi_row = zi_unit * row[:, :1, None]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sosfilt_ops.sosfilt(sos, row, zi_row)
    new_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sosfilt_ops.sosfilt(sos, row, zi_row)
    warm_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    log(f"sosfilt (b) host time of a call at a new chunk length (L=100000, C="
        f"{sosfilt_ops.scan_plan(100_000).chunk}): {new_ms:.3f} ms, its tables made and copied; "
        f"the next call {warm_ms:.3f} ms")
    # the plain version, a Python loop a sample (the host's time), on the
    # first eighth of every row, beside the kernel's two launches on the
    # same eighth (the whole rows' plain loop took 28-32 s of the watchdog)
    b, length = batch.shape
    part = batch[:, : length // 8].contiguous()
    zp1 = zi_unit * part[:, :1, None]
    back_part = sosfilt_ops.sosfilt(sos, part, zp1).flip(-1).contiguous()
    zp2 = zi_unit * back_part[:, :1, None]
    part_ms = cuda_ms(lambda: (sosfilt_ops.sosfilt(sos, part, zp1), sosfilt_ops.sosfilt(sos, back_part, zp2)),
                      reps=5)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sosfilt_ops.sosfilt_ref(sos, part, zp1), sosfilt_ops.sosfilt_ref(sos, back_part, zp2)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    bound, bound_by = bound_ms(2 * b * length * 27.0, 2 * 8.0 * b * length)
    plan = sosfilt_ops.scan_plan(length)
    chain_ms = 2 * sosfilt_chain_cycles(plan) / SM_CLOCK_HZ * 1e3
    fma_ms = 2 * sosfilt_fma_cycles(length) / SM_CLOCK_HZ * 1e3
    sequential_ms = 2 * length * SEQUENTIAL_CYCLES / SM_CLOCK_HZ * 1e3
    log(f"sosfilt (b) two passes at ({b}, {length}): ms={ms:.4f} (CUDA events), device time {dev_ms:.4f}; "
        f"at ({b}, {length // 8}) {part_ms:.4f} ms beside plain_ms={plain_ms:.1f} (a Python loop: the host); "
        f"bound_ms={bound:.4f} ({bound_by}); the chunked "
        f"chain (C={plan.chunk}, {plan.levels} scan levels) {chain_ms:.4f} ms; one SM's float64 FMAs for a row "
        f"{fma_ms:.4f} ms; the sequential chain {sequential_ms:.3f} ms ({SEQUENTIAL_CYCLES} cycles a sample at "
        f"{SM_CLOCK_HZ / 1e9:.2f} GHz)")
    return {"max_abs_err": err, "gate_share": share, "gate_note": "the worst row's distance from scipy's float64 "
            "filter as a share of its gate (twice the plain pass's distance + 1e-6 of the row's max-abs)",
            "ms": ms, "plain_ms": plain_ms, "plain_shape": [b, length // 8], "ms_at_plain_shape": part_ms,
            "bound_ms": bound, "bound_by": bound_by, "chain_bound_ms": chain_ms,
            "f64_fma_bound_ms": fma_ms, "device_ms": dev_ms, "new_chunk_length_host_ms": new_ms}


def kernels_per_file(fe: MelFrontend, paths: list[str]) -> None:
    """Device time a file of each feature kernel over the corpus (torch.profiler
    over one warm spmel extraction of every file), beside their bounds: the
    bytes each moves and the chunked chain of the filter's two passes."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    wavs = [read_wav(p)[0] for p in paths]
    fe.mel_features(wavs[0])  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for x in wavs:
            fe.mel_features(x)
        torch.cuda.synchronize()
    total = {name: sum(e.device_time_total for e in prof.key_averages()
                       if getattr(e, "device_type", None) == DeviceType.CUDA and name in e.key)
             for name in ("sosfilt_scan_kernel", "mel_norm_kernel")}
    n = len(wavs)
    lengths = np.array([x.shape[0] for x in wavs])
    padded = lengths + 36  # the odd extension of sos_filtfilt, padlen 18 each side
    frames = lengths // HOP + 1
    chain_us = np.mean([2 * sosfilt_chain_cycles(sosfilt_ops.scan_plan(int(p))) for p in padded]) / SM_CLOCK_HZ * 1e6
    fma_us = np.mean([2 * sosfilt_fma_cycles(int(p)) for p in padded]) / SM_CLOCK_HZ * 1e6
    sos_bytes_us = np.mean(2 * 8.0 * padded) / HBM_BYTES_PER_S * 1e6
    spans = mel_ops.filter_spans(torch.from_numpy(fe.mel_basis))
    mel_bytes_us = np.mean([mel_work(int(t), spans)[1] for t in frames]) / HBM_BYTES_PER_S * 1e6
    log(f"features per file ({n} files of {lengths.min()}..{lengths.max()} samples, {frames.min()}..{frames.max()} "
        f"frames): sosfilt (two passes) {total['sosfilt_scan_kernel'] / n:.2f} us of device time a file (bytes bound "
        f"{sos_bytes_us:.3f} us, chunked chain {chain_us:.2f} us, one SM's float64 FMAs {fma_us:.2f} us); mel_norm "
        f"{total['mel_norm_kernel'] / n:.2f} us a file (bytes bound {mel_bytes_us:.3f} us)")


def feature_profile(fe: MelFrontend, x: np.ndarray, noise: np.ndarray) -> None:
    """Device time by kind over one warm spmel file (torch.profiler): the
    filter, the FFT, the mel kernel, copies, the rest; and the device's idle
    share of that file's wall time."""
    rows, wall_us, _ = device_activity(lambda: fe.extract("spmel", x, noise).cpu())
    if not rows:
        log("feature profile: the profiler recorded no device time (not measured)")
        return
    kinds = {"filter (sosfilt_scan_kernel)": 0.0, "FFT (cuFFT)": 0.0, "mel (mel_norm_kernel)": 0.0, "copies": 0.0,
             "rest": 0.0}
    rest = []
    for key, count, total in rows:
        low = key.lower()
        if "sosfilt_scan_kernel" in key:
            kind = "filter (sosfilt_scan_kernel)"
        elif "mel_norm_kernel" in key:
            kind = "mel (mel_norm_kernel)"
        elif "memcpy" in low or "memset" in low:
            kind = "copies"
        elif "fft" in low:
            kind = "FFT (cuFFT)"
        else:
            kind = "rest"
            rest.append((total, count, key[:70]))
        kinds[kind] += total
    busy = sum(kinds.values())
    for kind, total in kinds.items():
        log(f"feature profile: {kind}: {total:.1f} us ({total / busy:.3f} of device time)")
    for total, count, key in sorted(rest, reverse=True)[:5]:
        log(f"feature profile:   rest: {key}: {count} launches, {total:.1f} us")
    log(f"feature profile: one file of {x.shape[0] / SR:.2f} s: device busy {busy:.1f} us of {wall_us:.1f} us wall "
        f"(idle share {1 - busy / wall_us:.3f})")


def feature_counts() -> tuple[int, int]:
    return mel_ops.launches, sosfilt_ops.launches


def phase_features(dev: torch.device, tmp: str) -> tuple[dict, dict, str]:
    """Phase 5: feature extraction at full width on a synthetic corpus written
    into ``tmp``, checks (a)-(e). Returns the kernel records and the main
    directory the card's make_spect run wrote (its ``spmel/`` tree is phase
    6's corpus)."""
    rng = np.random.RandomState(50)
    t0 = time.perf_counter()
    paths = write_corpus(tmp, rng)
    batch_np = np.stack([utterance(rng, TIME_L, 110.0 + 5 * i, 0.9) for i in range(TIME_B)])
    audio_s = sum(read_wav(p)[0].shape[0] for p in paths) / SR
    log(f"features: corpus of {len(paths)} files, {audio_s:.1f} s of audio, written in "
        f"{time.perf_counter() - t0:.1f} s")
    batch = torch.from_numpy(batch_np).to(dev)
    mel_rec = feature_check_mel(dev, batch)
    sos_rec = feature_check_sosfilt(dev, batch)
    del batch

    # (c) the front end on the card vs its CPU float32 path and vs the
    # f64 host chain, one utterance of each speaker; the TF32 flags. The
    # highpass rounds otherwise on the two sides (the chunked scan against
    # the sequential pass), so the stages after it are held to the CPU on
    # the card's filtered waveform, and the whole chain to the f64 chain
    fe, fe_cpu = MelFrontend(device=dev), MelFrontend(device="cpu")
    b, a = butter_highpass()
    basis64 = mel_filterbank(dtype=np.float64)
    audio = AudioConfig()
    picks = paths[::FEAT_UTTS]
    worst = {"cpu": 0.0, "after": 0.0, "exact": 0.0, "cpu_exact": 0.0, "tf32": 0.0}
    for path in picks:
        x, _ = read_wav(path)
        noise = (rng.rand(x.shape[0]) - 0.5) * 1e-6
        got = fe.mel_features(x, noise.astype(np.float32)).cpu()
        cpu = fe_cpu.mel_features(x, noise.astype(np.float32))
        after = fe_cpu.from_filtered("spmel", fe.highpass_dither(x, noise.astype(np.float32)).cpu())
        exact = torch.from_numpy(make_spect.exact_features(x, noise, "spmel", audio, b, a, basis64)).float()
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
        tf32 = fe.mel_features(x, noise.astype(np.float32)).cpu()
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
        case = {"cpu": (got - cpu).abs().max().item(), "after": (got - after).abs().max().item(),
                "exact": (got - exact).abs().max().item(), "cpu_exact": (cpu - exact).abs().max().item(),
                "tf32": (tf32 - got).abs().max().item()}
        worst = {k: max(v, case[k]) for k, v in worst.items()}
        if not (case["after"] <= FE_TOL and case["exact"] <= EXACT_TOL and case["tf32"] <= 1e-6):
            raise AssertionError(f"front end on {os.path.basename(path)}: {case}")
    log(f"features (c) spmel on the card, {len(picks)} utterances: after the highpass vs the CPU's stages "
        f"max_abs_err {worst['after']:.3e} (tol {FE_TOL}); vs the f64 host chain {worst['exact']:.3e} (tol "
        f"{EXACT_TOL}; the CPU f32 path's {worst['cpu_exact']:.3e}); the "
        f"whole chain vs the CPU f32 path {worst['cpu']:.3e} (two highpass roundings); TF32 flags on vs off "
        f"{worst['tf32']:.3e} (tol 1e-6)")

    # (d) the CLI over the whole corpus on the card, then --exact and
    # --device cpu (the float32 chain with the plain versions; a host loop
    # of about half a second a file): --device cpu on the first speaker,
    # and on any other speaker with a file beyond EXACT_TOL of --exact,
    # whose gate reads it (a speaker at a time: its dither stream runs over
    # its files in order)
    dirs = {k: os.path.join(tmp, k) for k in ("card", "exact", "cpu")}
    wav_dir = os.path.join(tmp, "wavs")
    torch.cuda.synchronize()
    mel_ops.launches = sosfilt_ops.launches = 0
    t0 = time.perf_counter()
    written = make_spect.main(["--main_dir", dirs["card"], "--wav_dir", wav_dir, "--model_type", "spmel"])
    torch.cuda.synchronize()
    cli_s, launches = time.perf_counter() - t0, feature_counts()
    t0 = time.perf_counter()
    make_spect.main(["--main_dir", dirs["exact"], "--wav_dir", wav_dir, "--model_type", "spmel", "--exact"])
    exact_s = time.perf_counter() - t0
    cpu_s, cpu_speakers = 0.0, []

    def cpu_reference(path: str) -> np.ndarray:
        nonlocal cpu_s
        spk = os.path.basename(os.path.dirname(path))
        if spk not in cpu_speakers:
            one = os.path.join(tmp, f"wavs_{spk}")
            os.makedirs(one)
            os.symlink(os.path.join(wav_dir, spk), os.path.join(one, spk))
            t0 = time.perf_counter()
            make_spect.main(["--main_dir", dirs["cpu"], "--wav_dir", one, "--model_type", "spmel", "--device", "cpu"])
            cpu_s += time.perf_counter() - t0
            cpu_speakers.append(spk)
        return np.load(path.replace(dirs["card"], dirs["cpu"]))

    cpu_reference(written[0])
    n = len(written)
    worst = {"cpu": 0.0, "exact": 0.0, "cpu_exact": 0.0}
    over, zeros, ones, frames = [], 0, 0, 0
    for path in written:
        got = np.load(path)
        ref = {"exact": np.load(path.replace(dirs["card"], dirs["exact"]))}
        if np.abs(got - ref["exact"]).max() > EXACT_TOL or os.path.basename(os.path.dirname(path)) in cpu_speakers:
            ref["cpu"] = cpu_reference(path)
        else:
            ref["cpu"] = ref["exact"] + np.inf  # not made: this file's gate holds without it
        if got.dtype != np.float32 or got.ndim != 2 or got.shape != ref["exact"].shape or got.shape[1] != N_MELS:
            raise AssertionError(f"{path}: {got.dtype} {got.shape} against {ref['exact'].shape}")
        if not (got.min() >= 0.0 and got.max() <= 1.0):
            raise AssertionError(f"{path}: values outside [0, 1]: {got.min()} .. {got.max()}")
        err = {"cpu": float(np.abs(got - ref["cpu"]).max()), "exact": float(np.abs(got - ref["exact"]).max()),
               "cpu_exact": float(np.abs(ref["cpu"] - ref["exact"]).max())}
        worst = {k: max(v, err[k]) if np.isfinite(err[k]) else v for k, v in worst.items()}
        if err["exact"] > EXACT_TOL:
            diff = np.abs(got - ref["exact"])
            over.append((os.path.basename(path), err["exact"], err["cpu_exact"],
                         int(np.unravel_index(diff.argmax(), diff.shape)[1])))
        # the card may be no farther from the f64 chain than the f32
        # chain's own plain version is, plus the card-vs-CPU tolerance
        # (the two highpasses round otherwise: (c) holds the stages
        # after it to the CPU's)
        if not err["exact"] <= max(EXACT_TOL, err["cpu_exact"] + FE_TOL):
            raise AssertionError(f"{path}: card vs --exact {err['exact']} (tol {EXACT_TOL}, or the CPU's "
                                 f"{err['cpu_exact']} + {FE_TOL}); vs --device cpu {err['cpu']}")
        zeros, ones, frames = zeros + int((got == 0).sum()), ones + int((got == 1).sum()), frames + got.shape[0]
    if feature_counts() != launches:
        raise AssertionError(f"--exact or --device cpu launched kernels: {launches} -> {feature_counts()}")
    log(f"features (d) make_spect on the card: {n} files, {frames} frames, {cli_s:.3f} s wall, "
        f"{n / cli_s:.1f} files/s, {audio_s / cli_s:.1f} s of audio per wall second; launches (mel_norm, "
        f"sosfilt) {launches}; --exact (host f64) {exact_s:.3f} s, --device cpu {cpu_s:.1f} s on "
        f"{', '.join(cpu_speakers)}; max_abs_err vs --exact {worst['exact']:.3e} (--device cpu vs --exact "
        f"{worst['cpu_exact']:.3e}, on those speakers), vs --device cpu "
        f"{worst['cpu']:.3e} (two highpass roundings); outputs at 0: {zeros / (frames * N_MELS):.4f}, at 1: "
        f"{ones / (frames * N_MELS):.5f} (card: {card_line()})")
    log(f"features (d) files beyond {EXACT_TOL} of --exact: {len(over)} of {n}" + "".join(
        f"; {name}: card {e:.3e}, --device cpu {c:.3e}, worst mel bin {m}" for name, e, c, m in over))
    if n != len(paths) or launches != (n, 2 * n):
        raise AssertionError(f"{n} files of {len(paths)} with launches {launches}: expected one mel_norm "
                             f"and two sosfilt launches a file")
    if not (zeros and ones):
        raise AssertionError("the corpus did not engage the dB clip at both ends")
    x, _ = read_wav(paths[0])
    feature_profile(fe, x, ((rng.rand(x.shape[0]) - 0.5) * 1e-6).astype(np.float32))
    kernels_per_file(fe, paths)

    # (e) the other three model types on two utterances: after the
    # highpass, card vs the CPU's stages; the whole chain vs the f64 chain
    for model_type in ("stft", "legacy", "wav"):
        for path in paths[1:3]:
            x, _ = read_wav(path)
            noise = (rng.rand(x.shape[0]) - 0.5) * 1e-6
            got = fe.extract(model_type, x, noise.astype(np.float32)).cpu()
            after = fe_cpu.from_filtered(model_type, fe.highpass_dither(x, noise.astype(np.float32)).cpu())
            cpu = fe_cpu.extract(model_type, x, noise.astype(np.float32))
            exact = torch.from_numpy(make_spect.exact_features(x, noise, model_type, audio, b, a, basis64)).float()
            err = (got - after).abs()
            if got.shape != after.shape or not bool(torch.isfinite(got).all()):
                raise AssertionError(f"{model_type}: {tuple(got.shape)} against {tuple(after.shape)}")
            if model_type == "wav":
                tol, note = torch.full_like(after, FE_TOL), ""
            else:
                below = (after.amax(dim=-1, keepdim=True) - after - NEAR_PEAK).clamp(min=0.0)
                tol = FE_TOL * 10.0 ** (5.0 * below)
                note = f", within 40 dB of the frame's peak {err[below == 0].max().item():.3e}"
                if not (got.min().item() >= 0.0 and got.max().item() <= 1.0):
                    raise AssertionError(f"{model_type}: values outside [0, 1]")
            card_far = ((got - exact).abs() / tol).max().item()
            cpu_far = ((cpu - exact).abs() / tol).max().item()
            log(f"features (e) {model_type} {os.path.basename(path)} {tuple(got.shape)}: after the highpass "
                f"max_abs_err {err.max().item():.3e}{note}; worst share of the tolerance "
                f"{(err / tol).max().item():.3f}; from the f64 chain, in tolerances, the card {card_far:.3f}, "
                f"the CPU {cpu_far:.3f}")
            if not bool((err <= tol).all()):
                raise AssertionError(f"{model_type} card vs CPU after the highpass outside the tolerance "
                                     f"({FE_TOL} within 40 dB of the frame's peak, 10x more for each further "
                                     f"20 dB)")
            if not card_far <= cpu_far + 1.0:
                raise AssertionError(f"{model_type}: the card {card_far} tolerances from the f64 chain, the CPU "
                                     f"{cpu_far}")
    mel_rec["launches"], sos_rec["launches"] = launches
    mel_rec["cli_max_abs_err_vs_exact"] = worst["exact"]
    mel_rec["cli_audio_s_per_s"] = audio_s / cli_s
    return mel_rec, sos_rec, dirs["card"]


# phase 6: the GE2E d-vector at the published widths (artifacts/ge2e.npz,
# 80/768/256 x3) and the independent judge's (artifacts/ge2e_indep.npz,
# 80/256/256 x3), at the batches its paths give the LSTM kernels:
# make_metadata's single crops (1), the evaluation's padded window batches
# (8) and the training auxiliary's batch (7), T=128 frames
SPK_WIDTHS, SPK_BATCHES, SPK_T = (768, 256), (1, 8, 7), 128
SPK_ARTIFACTS = {768: "ge2e.npz", 256: "ge2e_indep.npz"}
SPK_TOL = 1e-4  # unit embeddings, kernels vs the plain recurrence: the LSTM kernel's gate
SPK_HOLDOUT = 6  # the last utterances a speaker that the evaluation on the card and on the CPU scores
SPK_REPS = 10  # profiled calls of a d-vector forward or backward in phase 6a
SPK_STEPS = 12  # Solver steps with lambda_spk (and as many without)
# LSTM sequences of one lambda_spk train step: the eval-mode conversion's 7,
# the training forward's and re-encoding's 11, the frozen d-vector's 3, each
# forward and backward; dW for all but the d-vector's
SPK_STEP_COUNTS = (21, 21, 18)


def speaker_encoder(dev: torch.device, trained: bool, hidden: int):
    """The frozen d-vector at width ``hidden``: the committed checkpoint with
    ``--trained``, else seeded."""
    if trained:
        return build_dvector(load_params(str(ROOT / "artifacts" / SPK_ARTIFACTS[hidden]))["dvector"], device=dev)
    return build_dvector(device=dev, seed=60 + hidden, dim_cell=hidden)


def device_split(fn, reps: int = 1) -> tuple[float, float, dict[str, tuple[float, int, int]], float]:
    """``reps`` warm calls of ``fn`` under torch.profiler: the device busy ms
    a call, each LSTM launch whose record the profiler dropped counted at its
    kind's mean; the busy ms of the records it kept; for each LSTM kind of
    ``LSTM_KINDS`` (mean ms of a recorded launch, launches recorded, launches
    its wrapper counted over the calls); and the wall ms a call."""
    rows, wall_us, launched = device_activity(fn, reps)
    missing, kinds = lstm_records(rows, launched)
    kept = sum(t for _, _, t in rows)
    return ((kept + missing) / 1e3 / reps, kept / 1e3 / reps,
            {k: (mean / 1e3, rec, made) for k, (mean, rec, made) in kinds.items()}, wall_us / 1e3)


def split_line(parts: dict[str, tuple[float, int, int]]) -> str:
    """The LSTM kinds that launched, from ``device_split``: ms a launch and
    how many of the wrapper's launches the profiler recorded."""
    return ", ".join(f"{k} {ms:.4f} ms a launch ({rec} of {made} launches recorded)"
                     for k, (ms, rec, made) in parts.items() if made)


def launched_by(parts: dict[str, tuple[float, int, int]]) -> tuple[int, int, int]:
    return tuple(parts[k][2] for k in LSTM_KINDS)


def lstm_bwd_nodw_work(b: int, t: int, h: int) -> tuple[float, float]:
    """(flops, bytes) of one backward sequence without dW, as the kernel
    runs it on the forward's gate activations: the dh contraction
    2*B*T*4H*H; the gates, c_seq, dy and w_hh read once, dxproj written
    once."""
    return 2.0 * b * t * 4 * h * h, 4.0 * (2 * b * t * 4 * h + 2 * b * t * h + h * 4 * h)


def phase_speaker_kernels(dev: torch.device, trained: bool) -> tuple[list[dict], list[dict]]:
    """Phase 6a: the d-vector with the kernels against the same d-vector on
    the plain recurrence, both on the card, at each width and batch; timed
    beside cuDNN's 3-layer LSTM and the bound; then the backward without dW
    at the auxiliary's batch."""
    rng = np.random.RandomState(60)
    fwd, bwd = [], []
    for hidden in SPK_WIDTHS:
        dvec = speaker_encoder(dev, trained, hidden)
        for b in SPK_BATCHES:
            x = torch.from_numpy(rng.rand(b, SPK_T, N_MELS).astype(np.float32)).to(dev)
            with torch.inference_mode():
                got = dvec(x)
                plan = plan_line("fwd")
                before = counts()
                with plain_recurrence():
                    want = dvec(x)
                    torch.cuda.synchronize()
                    plain_ms = cuda_ms(lambda: dvec(x), reps=1)
                if counts() != before:
                    raise AssertionError(f"the plain d-vector launched kernels: {before} -> {counts()}")
                err = (got - want).abs().max().item()
                ms = cuda_ms(lambda: dvec(x), reps=SPK_REPS)
                dev_ms, kept_ms, parts, wall_ms = device_split(lambda: dvec(x), reps=SPK_REPS)
                seq_ms, recorded, made = parts["lstm_fwd"]
                kern_ms = dvec.num_layers * seq_ms
                net = torch.nn.LSTM(N_MELS, hidden, 3, batch_first=True).to(dev)
                lib_ms = cuda_ms(lambda: net(x), reps=SPK_REPS)
            flops, nbytes = lstm_work(b, SPK_T, hidden)
            bound, bound_by = bound_ms(3 * flops, 3 * nbytes)
            log(f"speaker (a) d-vector H={hidden} B={b} T={SPK_T}: max_abs_err={err:.3e} (tol {SPK_TOL}) ms={ms:.4f} "
                f"device ms={dev_ms:.4f} ({kept_ms:.4f} in the records kept; the 3 lstm_fwd sequences "
                f"{kern_ms:.4f}: {seq_ms:.4f} a launch, {seq_ms / SPK_T * 1e3:.2f} us a step, over the {recorded} "
                f"of {made} launches the profiler recorded) plain_ms={plain_ms:.4f} cudnn 3-layer nn.LSTM "
                f"ms={lib_ms:.4f} bound_ms={bound:.4f} ({bound_by}); wall under the profiler {wall_ms:.4f} ms a call; "
                f"{plan} (card: {card_line()})")
            if not err <= SPK_TOL:
                raise AssertionError(f"d-vector H={hidden} B={b}: {err} > {SPK_TOL}")
            if launched_by(parts) != (dvec.num_layers * SPK_REPS, 0, 0):
                raise AssertionError(f"{SPK_REPS} profiled d-vector forwards launched {launched_by(parts)}")
            fwd.append({"hidden": hidden, "batch": b, "max_abs_err": err, "ms": ms, "device_ms": dev_ms,
                        "device_ms_recorded": kept_ms, "kernel_device_ms": kern_ms,
                        "kernel_launches_recorded": recorded, "kernel_launches": made,
                        "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": bound, "bound_by": bound_by})
        # the backward the frozen encoder runs in a lambda_spk step: no dW
        b = TRAIN_B
        lim = 1.0 / np.sqrt(hidden)
        w_hh = torch.from_numpy(rng.uniform(-lim, lim, (hidden, 4 * hidden)).astype(np.float32)).to(dev)
        xproj, h0, c0, dy = (torch.from_numpy((rng.randn(*shape) * 0.5).astype(np.float32)).to(dev)
                             for shape in [(b, SPK_T, 4 * hidden), (b, hidden), (b, hidden), (b, SPK_T, hidden)])
        h_seq, c_seq, _, _, gates = lstm_ops.lstm_forward_cuda(xproj, w_hh, with_cseq=True, with_gates=True)
        args = (xproj, w_hh, None, None, h_seq, c_seq, dy)
        before = counts()
        got = lstm_ops.lstm_backward_cuda(*args, gates=gates, need_dw=False)
        torch.cuda.synchronize()
        if counts() != (before[0], before[1] + 1, before[2]) or got[1] is not None:
            raise AssertionError(f"the backward without dW launched {before} -> {counts()}")
        want = lstm_ops.lstm_backward_ref(*args, need_dw=False)
        err = max((got[i] - want[i]).abs().max().item() for i in (0, 2, 3))
        ms = cuda_ms(lambda: lstm_ops.lstm_backward_cuda(*args, gates=gates, need_dw=False), reps=SPK_REPS)
        _, _, parts, _ = device_split(lambda: lstm_ops.lstm_backward_cuda(*args, gates=gates, need_dw=False),
                                      reps=SPK_REPS)
        dev_ms, recorded, made = parts["lstm_bwd"]
        if launched_by(parts) != (0, SPK_REPS, 0):
            raise AssertionError(f"{SPK_REPS} profiled backwards without dW launched {launched_by(parts)}")
        plain_ms = cuda_ms(lambda: lstm_ops.lstm_backward_ref(*args, need_dw=False), reps=1)
        _, lib_bwd_ms = cudnn_train_parts_ms(dev, hidden, h0, c0, dy)
        bound, bound_by = bound_ms(*lstm_bwd_nodw_work(b, SPK_T, hidden))
        log(f"speaker (a) lstm_bwd without dW H={hidden} B={b} T={SPK_T}: max_abs_err={err:.3e} ms={ms:.4f} "
            f"kernel device ms={dev_ms:.4f} a launch ({dev_ms / SPK_T * 1e3:.2f} us a step, over the {recorded} of "
            f"{made} launches the profiler recorded) plain_ms={plain_ms:.4f} "
            f"cudnn_bwd_ms={lib_bwd_ms:.4f} (with its weight gradients) bound_ms={bound:.4f} ({bound_by}); "
            f"{plan_line('bwd')}")
        if not err <= LSTM_TOL:
            raise AssertionError(f"lstm backward without dW H={hidden}: {err} > {LSTM_TOL}")
        bwd.append({"hidden": hidden, "batch": b, "max_abs_err": err, "ms": ms, "device_ms": dev_ms,
                    "kernel_launches_recorded": recorded, "kernel_launches": made, "plain_ms": plain_ms,
                    "library_ms": lib_bwd_ms, "bound_ms": bound, "bound_by": bound_by})
    return fwd, bwd


def _same_rows(got, want) -> float:
    """The largest distance between the arrays of two pickled manifests
    whose strings, ids and shapes agree; raises where they do not."""
    if isinstance(want, (list, tuple)):
        if type(got) is not type(want) or len(got) != len(want):
            raise AssertionError(f"manifest rows differ: {got!r:.200} vs {want!r:.200}")
        return max([_same_rows(g, w) for g, w in zip(got, want)], default=0.0)
    if isinstance(want, np.ndarray):
        if got.shape != want.shape or got.dtype != want.dtype:
            raise AssertionError(f"manifest arrays differ: {got.shape} {got.dtype} vs {want.shape} {want.dtype}")
        return float(np.abs(got - want).max()) if got.size else 0.0
    if got != want:
        raise AssertionError(f"manifest entries differ: {got!r} vs {want!r}")
    return 0.0


def _manifests(spmel: str) -> dict:
    out = {}
    for name in ("train.pkl", "metadata.pkl"):
        with open(os.path.join(spmel, name), "rb") as fh:
            out[name] = pickle.load(fh)
    with open(os.path.join(spmel, "metadata.log")) as fh:
        out["metadata.log"] = fh.read()
    return out


def phase_speaker_pipeline(dev: torch.device, trained: bool, main_dir: str) -> dict:
    """Phase 6b-c on phase 5's spmel tree: cli.make_metadata with the d-vector
    on the card and with --device cpu; cli.evaluate_speaker_encoder on the
    card and with --device cpu."""
    spmel = os.path.join(main_dir, "spmel")
    if trained:
        ckpt = str(ROOT / "artifacts" / SPK_ARTIFACTS[768])
    else:
        ckpt = os.path.join(main_dir, "ge2e_seeded.npz")
        save_dvector_artifact(speaker_encoder(torch.device("cpu"), False, 768).state_dict(), ckpt)
    speakers = sorted(d for d in os.listdir(spmel) if os.path.isdir(os.path.join(spmel, d)))

    # (b) make_metadata, the card then the CPU, on the same seed
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    make_metadata.main(["--main_dir", main_dir, "--dvector_ckpt", ckpt, "--seed", "0"])
    torch.cuda.synchronize()
    meta_s, meta_counts = time.perf_counter() - t0, counts()
    card = _manifests(spmel)
    t0 = time.perf_counter()
    make_metadata.main(["--main_dir", main_dir, "--dvector_ckpt", ckpt, "--seed", "0", "--device", "cpu"])
    meta_cpu_s = time.perf_counter() - t0
    if counts() != meta_counts:
        raise AssertionError(f"make_metadata --device cpu launched kernels: {meta_counts} -> {counts()}")
    cpu = _manifests(spmel)
    crops = 10 * len(speakers)
    if meta_counts != (3 * crops, 0, 0):
        raise AssertionError(f"make_metadata launched {meta_counts}, expected {3 * crops} forward sequences")
    meta_err = max(_same_rows(card[k], cpu[k]) for k in ("train.pkl", "metadata.pkl"))
    if card["metadata.log"] != cpu["metadata.log"] or not meta_err <= SPK_TOL:
        raise AssertionError(f"make_metadata on the card vs --device cpu: embeddings {meta_err} (tol {SPK_TOL}), "
                             f"the same metadata.log: {card['metadata.log'] == cpu['metadata.log']}")
    apply_fn = make_metadata.dvector_apply_fn(ckpt, dev)
    busy, kept, parts, wall = device_split(
        lambda: embed_speaker(apply_fn, spmel, speakers[0], np.random.default_rng(0)))
    if launched_by(parts) != (3 * crops // len(speakers), 0, 0):
        raise AssertionError(f"one speaker's crops launched {launched_by(parts)}")
    log(f"speaker (b) make_metadata on the card: {len(speakers)} speakers, {crops} crops of {SPK_T} frames (B=1), "
        f"{meta_s:.3f} s wall, launches (fwd, bwd, dW) {meta_counts}; --device cpu {meta_cpu_s:.3f} s; train.pkl and "
        f"metadata.pkl embeddings card vs CPU max_abs_err {meta_err:.3e} (tol {SPK_TOL}), utterance lists, specs "
        f"and metadata.log the same; one speaker's {crops // len(speakers)} crops: device busy {busy:.3f} ms "
        f"({kept:.3f} in the records kept) of {wall:.3f} ms wall, idle share {1 - busy / wall:.3f} "
        f"({split_line(parts)}) (card: {card_line()})")

    # (c) the speaker-encoder evaluation of the last SPK_HOLDOUT utterances a
    # speaker: the CLI on the card, its embeddings and report held against
    # the same CLI run with --device cpu
    args = ["--main_dir", main_dir, "--dvector_ckpt", ckpt, "--holdout", str(SPK_HOLDOUT)]
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    rep_card, e_card = evaluate_speaker_encoder.run(args)
    torch.cuda.synchronize()
    eval_s, eval_counts = time.perf_counter() - t0, counts()
    rep_cpu, e_cpu = evaluate_speaker_encoder.run(args + ["--device", "cpu"])
    if counts() != eval_counts:
        raise AssertionError(f"evaluate_speaker_encoder --device cpu launched kernels: {eval_counts} -> {counts()}")
    n_utt = rep_card["utterances"]
    busy, kept, parts, wall = device_split(lambda: evaluate_speaker_encoder.run(args))
    if launched_by(parts) != (3 * n_utt, 0, 0):
        raise AssertionError(f"a profiled evaluate_speaker_encoder run launched {launched_by(parts)}")
    emb_err = float(np.abs(e_card - e_cpu).max())
    # embeddings within SPK_TOL move a cosine by at most 2 * sqrt(D) * SPK_TOL;
    # the EER moves only by trials whose score lies within twice that of the
    # threshold, one part in the smaller of the same- and cross-speaker counts
    delta = 2.0 * np.sqrt(e_cpu.shape[1]) * SPK_TOL
    labels = np.repeat(np.arange(rep_cpu["speakers"]), SPK_HOLDOUT)
    if len(labels) != len(e_cpu):
        raise AssertionError(f"{len(e_cpu)} utterances scored, expected {SPK_HOLDOUT} of each speaker")
    sims = (e_cpu @ e_cpu.T)[np.triu_indices(len(e_cpu), k=1)]
    same = (labels[:, None] == labels[None, :])[np.triu_indices(len(e_cpu), k=1)]
    eer_tol = int((np.abs(sims - rep_cpu["threshold"]) <= 2 * delta).sum()) / min(same.sum(), (~same).sum())
    apart = {k: abs(rep_card[k] - rep_cpu[k]) for k in rep_cpu if isinstance(rep_cpu[k], float)}
    tol = {"eer": eer_tol, "threshold": delta, "intra_speaker_cos_mean": delta, "inter_speaker_cos_mean": delta,
           "separation": 2 * delta}
    log(f"speaker (c) evaluate_speaker_encoder --holdout {SPK_HOLDOUT} on the card: {n_utt} utterances of "
        f"{rep_card['speakers']} speakers in {eval_s:.3f} s wall, {n_utt / eval_s:.1f} utterances/s, launches (fwd, "
        f"bwd, dW) {eval_counts}; EER {rep_card['eer']:.4f}, separation {rep_card['separation']:.4f}; a profiled "
        f"run: device busy {busy * 1e3 / n_utt:.1f} us an utterance ({kept * 1e3 / n_utt:.1f} in the records kept), "
        f"idle share {1 - busy / wall:.3f} of {wall:.3f} ms wall ({split_line(parts)}) (card: {card_line()})")
    log(f"speaker (c) the card's run vs --device cpu: embeddings max_abs_err {emb_err:.3e} (tol {SPK_TOL}); "
        + ", ".join(f"{k} {apart[k]:.3e} (tol {tol[k]:.3e})" for k in tol))
    same_counts = all(rep_card[k] == rep_cpu[k] for k in ("utterances", "speakers", "holdout"))
    if not (emb_err <= SPK_TOL and all(apart[k] <= tol[k] for k in tol) and same_counts
            and eval_counts == (3 * n_utt, 0, 0)):
        raise AssertionError(f"evaluate_speaker_encoder on the card vs the CPU: embeddings {emb_err}, {apart} "
                             f"(tolerances {tol}); launches {eval_counts}")
    return {"ckpt": ckpt, "launches": tuple(m + e for m, e in zip(meta_counts, eval_counts)),
            "max_abs_err": max(meta_err, emb_err)}


def phase_speaker_training(dev: torch.device, ckpt: str) -> dict:
    """Phase 6d: phase 4's Solver with lambda_spk=1.0 ('windowed') on the
    frozen encoder of ``ckpt``: one step with the kernels against the plain
    step on the same kinks; SPK_STEPS steps with and without the auxiliary;
    the device-time split of one warm step and of the d-vector's forward and
    backward."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_spk_")
    try:
        mel_dir = synthetic_features(tmp, np.random.RandomState(70), "spmel", N_MELS)
        base = dict(batch_size=TRAIN_B, len_crop=TRAIN_T, num_iters=SPK_STEPS, log_step=1, checkpoint_step=10_000)
        cfg = Config(train=TrainConfig(**base, lambda_spk=1.0, spk_protocol="windowed", spk_ckpt=ckpt),
                     main_dir=tmp, run_name="spk")
        data = UtteranceDataset(mel_dir)
        solver = Solver(cfg, BatchIterator(data, TRAIN_B, TRAIN_T, seed=2), run_dir=os.path.join(tmp, "run"),
                        device=dev)
        x, emb = (torch.from_numpy(a).to(dev) for a in next(BatchIterator(data, TRAIN_B, TRAIN_T, seed=1)))

        # (c) the kernel step against the plain step on its kinks
        def fresh() -> TrainState:
            model = build_generator(cfg.model, device=dev, seed=7, trainable=True)
            return TrainState(0, model, make_optimizer(model, cfg), init_ema(model))

        step = make_train_step(cfg, spk=solver.spk_aux)
        states = {"kernels": fresh(), "plain": fresh()}
        tape = KinkTape()
        torch.cuda.synchronize()
        zero_counts()
        with tape.record():
            mk = step(states["kernels"], x, emb)
            torch.cuda.synchronize()
        k_counts = counts()
        with tape.replay(), plain_recurrence():
            mf = step(states["plain"], x, emb)
            torch.cuda.synchronize()
        if counts() != k_counts:
            raise AssertionError(f"the plain step launched kernels: {k_counts} -> {counts()}")
        if k_counts != SPK_STEP_COUNTS:
            raise AssertionError(f"one lambda_spk step launched {k_counts} (forward, backward, dW), "
                                 f"expected {SPK_STEP_COUNTS}")
        kinds = [kind for kind, _ in tape.sides]
        loss_rel = abs(mk["g_loss"].item() - mf["g_loss"].item()) / abs(mf["g_loss"].item())
        grads = {k: {n: p.grad.double() for n, p in st.model.named_parameters()} for k, st in states.items()}
        errs = {n: (g - grads["plain"][n]).abs().max().item() / grad_scale(n, grads["plain"])
                for n, g in grads["kernels"].items()}
        worst = max(errs.items(), key=lambda kv: kv[1])
        log(f"speaker (d) lambda_spk step with kernels vs plain recurrence on the same kinks: loss "
            f"{mk['g_loss'].item()!r} vs {mf['g_loss'].item()!r} (rel {loss_rel:.3e}, tol {LOSS_RTOL}); g_loss_spk "
            f"{mk['g_loss_spk'].item():.6f} vs {mf['g_loss_spk'].item():.6f}, g_spk_margin "
            f"{mk['g_spk_margin'].item():.6f}; worst gradient leaf {worst[0]} at {worst[1]:.3e} of its scale (tol "
            f"{GRAD_TOL}); {tape.elements} kinked elements ({kinds.count('relu')} ReLU calls, the hinge's last, "
            f"{kinds.count('abs')} abs), {tape.flips} on the other side in the plain step; launches (fwd, bwd, dW) "
            f"{k_counts}")
        if not (loss_rel <= LOSS_RTOL and worst[1] <= GRAD_TOL):
            raise AssertionError(f"lambda_spk step with the kernels: loss {loss_rel}, gradient {worst}")
        del states, grads

        # SPK_STEPS Solver steps with the auxiliary, then as many without
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        solver.train()
        torch.cuda.synchronize()
        spk_s, spk_counts = time.perf_counter() - t0, counts()
        hist = solver.history
        if (len(hist) != SPK_STEPS or not all(np.isfinite(h["g_loss"]) and "g_spk_margin" in h for h in hist)
                or spk_counts != tuple(SPK_STEPS * n for n in SPK_STEP_COUNTS)):
            raise AssertionError(f"{SPK_STEPS} lambda_spk steps: launches {spk_counts}, history {hist}")
        timing = solver.timer.summary()
        plain_cfg = Config(train=TrainConfig(**base), main_dir=tmp, run_name="base")
        ref = Solver(plain_cfg, BatchIterator(data, TRAIN_B, TRAIN_T, seed=2), run_dir=os.path.join(tmp, "run0"),
                     device=dev)
        ref.train()
        ref_timing = ref.timer.summary()
        log(f"speaker (d) {SPK_STEPS} Solver steps with lambda_spk=1.0 (windowed, margin {cfg.train.spk_margin}): "
            f"{spk_s:.2f} s wall, g_loss {hist[0]['g_loss']:.4f} -> {hist[-1]['g_loss']:.4f}, g_loss_spk "
            f"{hist[0]['g_loss_spk']:.4f} -> {hist[-1]['g_loss_spk']:.4f}; launches (fwd, bwd, dW) {spk_counts}; step "
            f"p50 {timing['step_ms_p50']:.2f} ms, p95 {timing['step_ms_p95']:.2f} ms; without lambda_spk p50 "
            f"{ref_timing['step_ms_p50']:.2f} ms, p95 {ref_timing['step_ms_p95']:.2f} ms (card: {card_line()})")
        train_profile(solver, x, emb, SPK_STEP_COUNTS)

        # the frozen d-vector's forward and backward alone, on the
        # auxiliary's windows: three sequences each way, no dW
        xc = torch.rand(TRAIN_B, TRAIN_T, N_MELS, device=dev, requires_grad=True)

        def dvector_fwd_bwd():
            windowed_embed(solver.spk_aux.model, xc).sum().backward()

        torch.cuda.synchronize()
        zero_counts()
        dvector_fwd_bwd()
        torch.cuda.synchronize()
        dv_counts = counts()
        reps = 5
        busy, kept, parts, wall = device_split(dvector_fwd_bwd, reps=reps)
        log(f"speaker (d) the frozen d-vector's forward and backward at B={TRAIN_B}, T={TRAIN_T}: launches (fwd, bwd, "
            f"dW) {dv_counts}; device busy {busy:.3f} ms ({kept:.3f} in the records kept) of {wall:.3f} ms wall a "
            f"call; {split_line(parts)}")
        if dv_counts != (3, 3, 0) or launched_by(parts) != (3 * reps, 3 * reps, 0):
            raise AssertionError(f"the frozen d-vector launched {dv_counts} (forward, backward, dW), expected "
                                 f"(3, 3, 0); {reps} profiled calls {launched_by(parts)}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if os.path.exists(tmp):
        raise AssertionError(f"{tmp} was not removed")
    return {"launches": spk_counts, "grad_err": worst[1], "step_ms_p50": timing["step_ms_p50"],
            "dvector_counts": dv_counts}


# ---------------------------------------------------------------- phase 7
# bfloat16 inference: the LSTM forward kernel's and WaveNet's bfloat16
# forms, the bench program in bfloat16 and cli.synthesize

BF16 = torch.bfloat16
LSTM_BF16_ULPS, LSTM_BF16_EQUAL = 1.0, 0.99  # the same rounding points, float32 sums in another order
BENCH_MEL_DELTA = 0.06  # bench.py:151-158's bound on the bf16-vs-f32 mel (recorded here, not a gate)
# 10a's iteration before serving, as PERF.md §5 records it (NVIDIA H100 80GB HBM3, 700.00 W)
RECORDED_BENCH_BF16_MS = 124.9
WN_BF16_PLAIN_T = 128  # samples of the plain bfloat16 loop (it and its reordered twin: ~3.4 s on the card)
# the bfloat16 kernel's gates: this many times the plain loop's own spread
# in this run, and no tighter than phase 3's float32 gates
WN_BF16_SPREAD = 4.0
SYN_UTTS = 8  # phase 7d: converted mels of 4 .. 11 frames


def bf16_ulps(got: torch.Tensor, want: torch.Tensor, floor: float = 2.0 ** -16) -> tuple[float, float]:
    """(the largest |got - want| in bfloat16 ulps of want, or of ``floor``
    times want's largest magnitude where want is smaller, the share of
    elements bit-equal); an all-zero want is met only exactly."""
    g, w = got.double(), want.double()
    peak = w.abs().max().item()
    if peak == 0:
        return (0.0 if torch.equal(g, w) else float("inf")), (g == w).double().mean().item()
    scale = torch.clamp(w.abs(), min=floor * peak)
    ulp = torch.ldexp(torch.ones_like(scale), torch.frexp(scale).exponent - 8)  # exact, where log2 may round 2^k down
    return ((g - w).abs() / ulp).max().item(), (g == w).double().mean().item()


def phase_bf16_lstm(dev: torch.device) -> dict:
    """7a: the LSTM forward kernel's bfloat16 form against the plain version
    at the Generator's shapes, timed beside the float32 kernel."""
    rng = np.random.RandomState(7)
    record = {"max_abs_err": 0.0, "max_ulps": 0.0, "min_equal_share": 1.0, "ms": 0.0, "f32_ms": 0.0,
              "plain_ms": 0.0, "flops": 0.0, "bytes": 0.0}
    for hidden, reverse, calls in LSTM_CASES:
        x = torch.from_numpy((rng.randn(B, T, 4 * hidden) * 0.5).astype(np.float32)).to(dev)
        bound = 1.0 / np.sqrt(hidden)
        w = torch.from_numpy(rng.uniform(-bound, bound, (hidden, 4 * hidden)).astype(np.float32)).to(dev)
        xb, wb = x.to(BF16), w.to(BF16)
        got = lstm_ops.lstm_sequence(xb, wb, reverse)
        want = lstm_ops.lstm_sequence_ref(xb, wb, reverse)
        torch.cuda.synchronize()
        if got.dtype != BF16:
            raise AssertionError(f"the bfloat16 lstm returned {got.dtype}")
        ulps, equal = bf16_ulps(got.float(), want.float())
        err = (got.float() - want.float()).abs().max().item()
        plan = plan_line("fwd")
        ms = cuda_ms(lambda: lstm_ops.lstm_sequence(xb, wb, reverse), reps=5)
        f32_ms = cuda_ms(lambda: lstm_ops.lstm_sequence(xb.float(), wb.float(), reverse), reps=5)
        plain_ms = cuda_ms(lambda: lstm_ops.lstm_sequence_ref(xb, wb, reverse), reps=1)
        flops, nbytes = lstm_work(B, T, hidden)
        nbytes /= 2  # xproj, w_hh and h_seq in bfloat16
        case_bound, bound_by = bound_ms(flops, nbytes)
        log(f"lstm_fwd bf16 H={hidden} {'reverse' if reverse else 'forward'}: max {ulps:.2f} bf16 ulps, "
            f"{equal:.5f} bit-equal, max_abs_err={err:.3e}; ms={ms:.4f} ({ms / T * 1e3:.2f} us a step), f32 kernel "
            f"{f32_ms:.4f}, plain_ms={plain_ms:.4f}, bound_ms={case_bound:.4f} ({bound_by}); {plan}")
        if not (ulps <= LSTM_BF16_ULPS and equal >= LSTM_BF16_EQUAL):
            raise AssertionError(f"bf16 lstm kernel H={hidden} reverse={reverse}: {ulps} ulps, {equal} bit-equal "
                                 f"(gate {LSTM_BF16_ULPS}, {LSTM_BF16_EQUAL})")
        record["max_abs_err"] = max(record["max_abs_err"], err)
        record["max_ulps"] = max(record["max_ulps"], ulps)
        record["min_equal_share"] = min(record["min_equal_share"], equal)
        for key, v in (("ms", ms), ("f32_ms", f32_ms), ("plain_ms", plain_ms), ("flops", flops), ("bytes", nbytes)):
            record[key] += calls * v
    record["bound_ms"], record["bound_by"] = bound_ms(record.pop("flops"), record.pop("bytes"))
    record["library_ms"] = cudnn_lstm_ms(dev, rng, BF16)
    log(f"lstm_fwd bf16 per Generator forward (7 sequences): {record['ms']:.3f} ms (f32 kernel "
        f"{record['f32_ms']:.3f}), plain {record['plain_ms']:.1f}, bound {record['bound_ms']:.3f} "
        f"({record['bound_by']}), cuDNN bf16 {record['library_ms']:.3f} (card: {card_line()})")
    return record


def phase_bf16_bench(dev: torch.device, trained: bool, mels32: np.ndarray, f32_run: tuple,
                     lstm_rec: dict, use_pallas_lstm: bool = True) -> dict:
    """7b: phase 2's program in bfloat16, as bench.py runs it: the same
    seeded Generator with compute_dtype bfloat16 and the same HiFi-GAN with
    bfloat16 parameters, the mel cast to bfloat16 on its way in and the
    waveform to float32 on its way out; its LSTMs in the Pallas rounding
    (``use_pallas_lstm``, JAX's ``--pallas``), or, in 10a, in the scan
    rounding, bench.py's default."""
    specs, wav32 = f32_run
    art = ROOT / "artifacts"
    cfg = ModelConfig(compute_dtype="bfloat16", use_pallas_lstm=use_pallas_lstm)
    form = "bf16_launches" if use_pallas_lstm else "scan_launches"
    label = "bf16" if use_pallas_lstm else "bf16 scan (bench.py's default)"
    gen = build_generator(cfg, artifact=str(art / "generator_spmel_f16.npz") if trained else None,
                          device=dev, seed=1)
    voc = HiFiGANVocoder(artifact=str(art / "hifigan.npz") if trained else None, device=dev, seed=2, dtype=BF16)
    converter = Converter(gen, cfg)

    def run():
        mels = np.stack(converter.convert_batch(specs, batch_size=B))
        return mels, voc.generate(mels)

    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    mels, wav = run()
    torch.cuda.synchronize()
    launches, form_launches = lstm_ops.launches, getattr(lstm_ops, form)
    log(f"{label} main path (cold): {time.perf_counter() - t0:.3f} s, lstm kernel launches={launches} "
        f"({form} {form_launches}; counts {all_counts()})")
    if launches != 7 or form_launches != 7:
        raise AssertionError(f"expected 7 lstm launches per Generator forward in {form}, got {launches} "
                             f"({form_launches}; counts {all_counts()})")
    if wav.dtype != torch.float32 or wav.shape != (B, T * HOP) or not bool(torch.isfinite(wav).all()):
        raise AssertionError(f"bf16 waveform {wav.dtype} {tuple(wav.shape)} finite={bool(torch.isfinite(wav).all())}")
    if mels.shape != (B, T, N_MELS) or not np.isfinite(mels).all():
        raise AssertionError(f"bf16 mel {mels.shape} finite={np.isfinite(mels).all()}")
    parity = {"mel_maxabs_delta": float(np.abs(mels - mels32).max()),
              "mel_meanabs_delta": float(np.abs(mels - mels32).mean()),
              "wav_maxabs_delta": float((wav - wav32).abs().max())}
    parity["ok"] = parity["mel_maxabs_delta"] <= BENCH_MEL_DELTA
    log(f"{label} parity against phase 2's f32 run (bench.py's dict; recorded, not a gate): {json.dumps(parity)}")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    audio_s = B * T * HOP / 16000
    x = torch.from_numpy(np.stack([s.src_features for s in specs])).to(dev)
    e_src = torch.from_numpy(np.stack([s.src_embedding for s in specs])).to(dev)
    e_trg = torch.from_numpy(np.stack([s.trg_embedding for s in specs])).to(dev)
    with torch.inference_mode():
        gen_ms = cuda_ms(lambda: gen(x, e_src, e_trg), reps=3)
        voc_ms = cuda_ms(lambda: voc.model(x.to(BF16)), reps=3)
    log(f"{label} warm iteration: {warm_s * 1e3:.1f} ms wall for {audio_s:.1f} s of audio ({audio_s / warm_s:.1f}x "
        f"realtime); generator {gen_ms:.1f} ms (of it the LSTM kernels {lstm_rec['ms']:.1f}), HiFi-GAN "
        f"{voc_ms:.1f} ms (card: {card_line()})")
    return {"launches": launches, "iteration_ms": warm_s * 1e3, "realtime": audio_s / warm_s,
            "generator_ms": gen_ms, "hifigan_ms": voc_ms, "parity": parity}


def permuted_wavenet(packed: dict, cfg: WaveNetConfig, seed: int) -> tuple[dict, torch.Tensor]:
    """The same WaveNet with its residual, gate, skip and cond channels
    relabelled (and the cond permutation to apply to cond): the same
    function in exact arithmetic, its products summed in another order."""
    gen = torch.Generator().manual_seed(seed)
    dev = packed["w3"].device
    r, g2, s, c = cfg.residual_channels, cfg.gate_channels // 2, cfg.skip_channels, cfg.cin_channels
    pr, pg, ps, pc = (torch.randperm(n, generator=gen).to(dev) for n in (r, g2, s, c))
    gcols = torch.cat([pg, pg + g2])
    p = dict(packed)
    p["w3"] = packed["w3"][:, torch.cat([pr, pr + r, pr + 2 * r])][:, :, gcols].contiguous()
    p["wcond"] = packed["wcond"][:, pc][:, :, gcols].contiguous()
    p["bg"] = packed["bg"][:, gcols].contiguous()
    p["wout"] = packed["wout"][:, pg][:, :, pr].contiguous()
    p["wskip"] = packed["wskip"][:, pg][:, :, ps].contiguous()
    p["bo"], p["bs"] = packed["bo"][:, pr].contiguous(), packed["bs"][:, ps].contiguous()
    p["fk"], p["fb"] = packed["fk"][pr].contiguous(), packed["fb"][pr].contiguous()
    p["l1k"] = packed["l1k"][ps].contiguous()
    return p, pc


def phase_bf16_wavenet(dev: torch.device, trained: bool, mels: np.ndarray) -> dict:
    """7c: phase 3's WaveNet with bfloat16 weights, its gates derived from
    the plain loop's own spread, timings beside the float32 kernel."""
    cfg = WaveNetConfig()
    art = ROOT / "artifacts" / "wavenet_105k.npz"
    voc = WaveNetVocoder(cfg, artifact=str(art) if trained else None, device=dev, seed=3)
    mel = torch.from_numpy(np.ascontiguousarray(mels[:WN_B, :WN_FRAMES])).to(dev)
    t = WN_FRAMES * cfg.hop_size
    u = voc.uniforms(WN_B, t, torch.Generator().manual_seed(4))
    dils = cfg.dilations()

    torch.cuda.synchronize()
    wavenet_ops.launches = wavenet_ops.bf16_launches = 0
    t0 = time.perf_counter()
    wav = voc.generate(mel, uniforms=u, dtype=BF16, engine="pallas")
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    launches, bf16_launches = wavenet_ops.launches, wavenet_ops.bf16_launches
    plan, per_sm, sms = wavenet_ops.last_launch
    log(f"wavenet bf16 main path (cold): {cold_s:.3f} s, wrapper launches={launches} (bfloat16 {bf16_launches}), "
        f"CUDA launches={wavenet_ops.last_cuda_launches}; plan: {plan.blocks} blocks, {per_sm} resident a SM on "
        f"{sms} SMs, {plan.pairs} pairs / {plan.cols} columns / {plan.head_cols} head columns a block, a ring "
        f"of {plan.depth} phases, {plan.smem} shared bytes; {2 * cfg.layers + 1} grid barriers a sample")
    if launches != 1 or bf16_launches != 1 or wavenet_ops.last_cuda_launches != plan.launches:
        raise AssertionError(f"wavenet bf16 launches: wrapper {launches} ({bf16_launches} bfloat16), CUDA "
                             f"{wavenet_ops.last_cuda_launches}, plan {plan.launches}")
    if wav.shape != (WN_B, t) or not bool(torch.isfinite(wav).all()) or float(wav.abs().max()) > 1.0:
        raise AssertionError(f"wavenet bf16 waveform {tuple(wav.shape)} finite={bool(torch.isfinite(wav).all())}")

    packed = voc.packed_for(BF16)
    n = WN_BF16_PLAIN_T
    with torch.inference_mode():
        cond = voc.model.upsample_conditioning(mel)
        y, logits = wavenet_ops.generate(packed, dils, cond, u, cfg.log_scale_min)
        torch.cuda.synchronize()
        if not torch.equal(y, wav):
            raise AssertionError("the bf16 kernel gave another waveform on the same inputs")
        tf_err = (logits - voc.logits(y[..., None], mel, BF16)).abs().max().item()
        cond_n, u_n = cond[:, :n].contiguous(), u[:, :n].contiguous()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        y_ref, logits_ref = wavenet_ops.generate_ref(packed, dils, cond_n, u_n, cfg.log_scale_min)
        end.record()
        torch.cuda.synchronize()
        plain_ms = start.elapsed_time(end)
        # the plain loop's own spread: its logits against the teacher-forced
        # forward on its own waveform; its samples against the same loop on
        # the relabelled WaveNet
        spread_tf = (logits_ref - voc.logits(y_ref[..., None], mel, BF16)).abs().max().item()
        twin, pc = permuted_wavenet(packed, cfg, seed=11)
        y_twin, _ = wavenet_ops.generate_ref(twin, dils, cond_n[..., pc].contiguous(), u_n, cfg.log_scale_min)
        spread_prefix = (y_ref[:, :WN_MIN_PREFIX] - y_twin[:, :WN_MIN_PREFIX]).abs().max().item()
        tf_tol = max(WN_TF_TOL, WN_BF16_SPREAD * spread_tf)
        prefix_tol = max(WN_PREFIX_TOL, WN_BF16_SPREAD * spread_prefix)
        apart = first_apart(y[:, :n], y_ref, prefix_tol)
        prefix = min(apart)
        prefix_err = (y[:, :prefix] - y_ref[:, :prefix]).abs().max().item() if prefix else float("inf")
        log(f"wavenet bf16 plain loop's spread: teacher-forced logits {spread_tf:.3e}, first {WN_MIN_PREFIX} samples "
            f"against its relabelled twin {spread_prefix:.3e} (twin first apart by > {WN_PREFIX_TOL}: "
            f"{first_apart(y_ref, y_twin, WN_PREFIX_TOL)})")
        log(f"wavenet bf16 (i) kernel logits vs teacher-forced bf16 forward: max_abs_err={tf_err:.3e} "
            f"(tol {tf_tol:.3e}); (ii) vs plain loop over {n} samples: first apart by > {prefix_tol:.3e} per row "
            f"{apart}, max_abs_err over the common prefix {prefix_err:.3e}")
        if not tf_err <= tf_tol:
            raise AssertionError(f"wavenet bf16 teacher-forced check: {tf_err} > {tf_tol}")
        if prefix < WN_MIN_PREFIX:
            raise AssertionError(f"wavenet bf16 kernel leaves the plain loop at sample {prefix} < {WN_MIN_PREFIX}")
        times = {}
        for rows in WN_TIME_B:
            mel_b = torch.from_numpy(np.ascontiguousarray(mels[:rows, :WN_FRAMES])).to(dev)
            cond_b = voc.model.upsample_conditioning(mel_b)
            u_b = voc.uniforms(rows, t, torch.Generator().manual_seed(5))
            reps = 3 if rows == WN_B else 2
            call = lambda pk: (lambda: wavenet_ops.generate(pk, dils, cond_b, u_b, cfg.log_scale_min))
            f32_a = cuda_ms(call(voc.packed), reps)
            bf_ms = cuda_ms(call(packed), reps)
            f32_b = cuda_ms(call(voc.packed), reps)
            b_bound, _ = bound_ms(*wavenet_work(cfg, packed, rows, t))
            f32_bound, _ = bound_ms(*wavenet_work(cfg, voc.packed, rows, t))
            times[rows] = (bf_ms / t * 1e3, (f32_a + f32_b) / 2 / t * 1e3)
            log(f"wavenet bf16 B={rows}, T={t}: {bf_ms:.3f} ms a call, {times[rows][0]:.2f} us a sample "
                f"({bf_ms / (t * (2 * cfg.layers + 1)) * 1e3:.3f} us a phase); f32 kernel in turn "
                f"{f32_a / t * 1e3:.2f}, {f32_b / t * 1e3:.2f} us a sample; bound {b_bound / t * 1e3:.2f} us a "
                f"sample (bytes; f32 {f32_bound / t * 1e3:.2f}) (card: {card_line()})")
            if rows == WN_B:
                ms = bf_ms
        for rows in (1, WN_B):
            wavenet_profile(voc, cond[:rows], u[:rows], samples=64, dtype=BF16)
    w_bound_ms, w_bound_by = bound_ms(*wavenet_work(cfg, packed, WN_B, t))
    log(f"wavenet bf16 kernel: {ms:.3f} ms per call (B={WN_B}, T={t}), bound {w_bound_ms:.3f} ms ({w_bound_by}), "
        f"plain {plain_ms:.1f} ms over {n} samples")
    return {"launches": launches, "max_abs_err": max(tf_err, prefix_err), "ms": ms, "plain_ms": plain_ms,
            "plain_samples": n, "bound_ms": w_bound_ms, "bound_by": w_bound_by, "library_ms": None,
            "tf_tol": tf_tol, "prefix_tol": prefix_tol,
            "us_per_sample": {str(rows): {"bf16": v[0], "f32": v[1]} for rows, v in times.items()}}


WN_SCAN_PLAIN_T = 64  # 7e: samples of the plain scan-rounding loop (it and its relabelled twin)


def phase_scan_wavenet(dev: torch.device, trained: bool, mels: np.ndarray) -> dict:
    """7e: phase 3's WaveNet with bfloat16 weights in the JAX scan engine's
    rounding (``WaveNetVocoder.generate``'s default engine, "scan": one
    launch of the kernel's scan form, B=8, T=2048): its logits against the
    teacher-forced forward in the same rounding on its own waveform, its
    first 32 samples against the plain scan loop (over WN_SCAN_PLAIN_T
    samples), each within WN_BF16_SPREAD times the plain loop's own spread
    and no tighter than phase 3's float32 gates (7c's rule); a second call
    the same waveform; us a sample at B=8 beside the Pallas-rounding
    bfloat16 form and the float32 kernel, in turns, and the bound."""
    cfg = WaveNetConfig()
    art = ROOT / "artifacts" / "wavenet_105k.npz"
    voc = WaveNetVocoder(cfg, artifact=str(art) if trained else None, device=dev, seed=3)
    mel = torch.from_numpy(np.ascontiguousarray(mels[:WN_B, :WN_FRAMES])).to(dev)
    t = WN_FRAMES * cfg.hop_size
    u = voc.uniforms(WN_B, t, torch.Generator().manual_seed(6))
    dils = cfg.dilations()
    torch.cuda.synchronize()
    wavenet_ops.launches = wavenet_ops.bf16_launches = wavenet_ops.scan_launches = 0
    wav = voc.generate(mel, uniforms=u, dtype=BF16)
    torch.cuda.synchronize()
    counted = (wavenet_ops.launches, wavenet_ops.scan_launches, wavenet_ops.bf16_launches)
    log(f"7e wavenet scan-bf16 main path (WaveNetVocoder.generate, engine scan): wrapper launches (all, scan, "
        f"bfloat16) {counted}, CUDA launches {wavenet_ops.last_cuda_launches}")
    if counted != (1, 1, 0) or wavenet_ops.last_cuda_launches != 1:
        raise AssertionError(f"7e: wavenet scan launches {counted}, CUDA {wavenet_ops.last_cuda_launches}")
    if wav.shape != (WN_B, t) or not bool(torch.isfinite(wav).all()) or float(wav.abs().max()) > 1.0:
        raise AssertionError(f"7e: wavenet scan waveform {tuple(wav.shape)} finite={bool(torch.isfinite(wav).all())}")
    packed = voc.packed_for(BF16)
    n = WN_SCAN_PLAIN_T
    with torch.inference_mode():
        cond = voc.model.upsample_conditioning(mel)
        y, logits = wavenet_ops.generate(packed, dils, cond, u, cfg.log_scale_min, scan=True)
        torch.cuda.synchronize()
        if not torch.equal(y, wav):
            raise AssertionError("7e: the scan kernel gave another waveform on the same inputs")
        tf_err = (logits - voc.logits(y[..., None], mel, BF16, scan=True)).abs().max().item()
        cond_n, u_n = cond[:, :n].contiguous(), u[:, :n].contiguous()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        y_ref, logits_ref = wavenet_ops.generate_ref(packed, dils, cond_n, u_n, cfg.log_scale_min, scan=True)
        end.record()
        torch.cuda.synchronize()
        plain_ms = start.elapsed_time(end)
        spread_tf = (logits_ref - voc.logits(y_ref[..., None], mel, BF16, scan=True)[:, :n]).abs().max().item()
        twin, pc = permuted_wavenet(packed, cfg, seed=12)
        y_twin, _ = wavenet_ops.generate_ref(twin, dils, cond_n[..., pc].contiguous(), u_n, cfg.log_scale_min,
                                             scan=True)
        spread_prefix = (y_ref[:, :WN_MIN_PREFIX] - y_twin[:, :WN_MIN_PREFIX]).abs().max().item()
        tf_tol = max(WN_TF_TOL, WN_BF16_SPREAD * spread_tf)
        prefix_tol = max(WN_PREFIX_TOL, WN_BF16_SPREAD * spread_prefix)
        apart = first_apart(y[:, :n], y_ref, prefix_tol)
        prefix = min(apart)
        prefix_err = (y[:, :prefix] - y_ref[:, :prefix]).abs().max().item() if prefix else float("inf")
        log(f"7e wavenet scan plain loop's spread: teacher-forced logits {spread_tf:.3e}, first {WN_MIN_PREFIX} "
            f"samples against its relabelled twin {spread_prefix:.3e} (twin first apart by > {WN_PREFIX_TOL}: "
            f"{first_apart(y_ref, y_twin, WN_PREFIX_TOL)})")
        log(f"7e wavenet scan (i) kernel logits vs teacher-forced scan forward: max_abs_err={tf_err:.3e} (tol "
            f"{tf_tol:.3e}); (ii) vs plain loop over {n} samples: first apart by > {prefix_tol:.3e} per row {apart}, "
            f"max_abs_err over the common prefix {prefix_err:.3e}")
        if not tf_err <= tf_tol:
            raise AssertionError(f"7e: wavenet scan teacher-forced check: {tf_err} > {tf_tol}")
        if prefix < WN_MIN_PREFIX:
            raise AssertionError(f"7e: wavenet scan kernel leaves the plain loop at sample {prefix} < {WN_MIN_PREFIX}")
        call = lambda pk, scan: (lambda: wavenet_ops.generate(pk, dils, cond, u, cfg.log_scale_min, scan))
        f32_a, bf_a = cuda_ms(call(voc.packed, False), 2), cuda_ms(call(packed, False), 2)
        ms = cuda_ms(call(packed, True), 3)
        bf_b, f32_b = cuda_ms(call(packed, False), 2), cuda_ms(call(voc.packed, False), 2)
    bound, bound_by = bound_ms(*wavenet_work(cfg, packed, WN_B, t))
    us = {"scan": ms / t * 1e3, "bf16": (bf_a + bf_b) / 2 / t * 1e3, "f32": (f32_a + f32_b) / 2 / t * 1e3}
    log(f"7e wavenet scan-bf16 B={WN_B}, T={t}: {ms:.3f} ms a call, {us['scan']:.2f} us a sample "
        f"({ms / (t * (2 * cfg.layers + 1)) * 1e3:.3f} us a phase); in turns the Pallas-rounding bf16 form "
        f"{bf_a / t * 1e3:.2f}, {bf_b / t * 1e3:.2f} and the f32 kernel {f32_a / t * 1e3:.2f}, {f32_b / t * 1e3:.2f} "
        f"us a sample; bound {bound:.3f} ms ({bound_by}), plain {plain_ms:.1f} ms over {n} samples "
        f"(card: {card_line()})")
    return {"launches": counted[0], "max_abs_err": max(tf_err, prefix_err), "ms": ms, "plain_ms": plain_ms,
            "plain_samples": n, "bound_ms": bound, "bound_by": bound_by, "library_ms": None, "tf_tol": tf_tol,
            "prefix_tol": prefix_tol, "us_per_sample": us}


def phase_synthesize(mels: np.ndarray, tmp: str) -> dict:
    """7d: cli.synthesize on the card on a results pkl of 8 converted mels
    of 4 .. 11 frames: WaveNet in bfloat16 in one batch of 8 through the
    pallas engine (the kernel's bfloat16 form) and through the default scan
    engine (its scan form), and HiFi-GAN one at a time."""
    results = [(f"conv{i:02d}", np.ascontiguousarray(mels[i, :4 + i])) for i in range(SYN_UTTS)]
    pkl = os.path.join(tmp, "results_0.pkl")
    save_results(pkl, results)
    out = {}
    # (vocoder, run, flags, wavenet launches: all, bfloat16, scan)
    runs = (("wavenet", "pallas", ["--wavenet_engine", "pallas", "--batch", str(SYN_UTTS)], (1, 1, 0)),
            ("wavenet", "scan", ["--bf16", "--batch", str(SYN_UTTS)], (1, 0, 1)),
            ("hifigan", "hifigan", [], (0, 0, 0)))
    for vocoder, run, extra, want in runs:
        out_dir = os.path.join(tmp, run)
        torch.cuda.synchronize()
        wavenet_ops.launches = wavenet_ops.bf16_launches = wavenet_ops.scan_launches = 0
        t0 = time.perf_counter()
        synthesize.main(["--results", pkl, "--out_dir", out_dir, "--vocoder", vocoder, *extra])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        for name, mel in results:
            x, sr = read_wav(os.path.join(out_dir, f"{name}.wav"))
            if sr != SR or x.shape != (mel.shape[0] * HOP,) or not np.isfinite(x).all():
                raise AssertionError(f"synthesize {vocoder}: {name}.wav {x.shape} at {sr} Hz, expected "
                                     f"({mel.shape[0] * HOP},) at {SR}")
        readme = open(os.path.join(out_dir, "readme.md")).read().splitlines()
        listed = [line.split()[1] for line in readme if line.startswith("- ")]
        if readme[0] != "# Synthesized conversions" or listed != [f"{name}.wav" for name, _ in results]:
            raise AssertionError(f"synthesize {vocoder}: readme.md lists {listed}")
        launched = (wavenet_ops.launches, wavenet_ops.bf16_launches, wavenet_ops.scan_launches)
        if launched != want:
            raise AssertionError(f"synthesize {vocoder} {extra}: {launched} (kernel, bfloat16, scan) launches")
        log(f"cli.synthesize --vocoder {vocoder} {' '.join(extra)}: {len(results)} wavs of 4-11 frames, "
            f"{wall:.2f} s wall; wavenet kernel launches (all, bfloat16, scan) {launched} (card: {card_line()})")
        out[run] = {"wall_s": wall, "wavenet_launches": launched[0]}
    return out


# ---------------------------------------------------------------- phase 8
# bfloat16 training: the LSTM kernels' bfloat16 training forms (the forward
# with its state and c_seq, the gates recomputed from the rounded h_seq, the
# backward and dW), the Solver and cli.train --bf16

GATES_TOL = 1e-5  # float32 activations of a sum of H exact bfloat16 products, in another order
# the ulp floor of the backward's bfloat16 outputs: float32 sums over 4H (dx)
# and B*T (dW) terms in another order (tests/test_torch_gpu.py)
BWD_FLOOR = 2.0 ** -8
# 8b: every gradient leaf of the kernel step no farther from the plain
# bfloat16 step than this many times the plain step's own bfloat16 spread,
# the median over the leaves of its distance from the float32 step on the
# same kinks (a flip in a bfloat16 sum moves a BatchNorm channel, so two
# bfloat16 engines can land as far apart as bfloat16 from float32; a
# convolution's bias, zero in exact arithmetic, is all rounding, so a leaf's
# own spread is no gate); the loss within twice its spread
BF16_SPREAD = 1.0
BF16_COUNTERS = ("bf16_launches", "gates_launches", "bf16_bwd_launches", "dw_launches")


def bf16_counts() -> tuple[int, int, int, int]:
    """The bfloat16 training launches: forward, gates, backward, dW."""
    return tuple(getattr(lstm_ops, c) for c in BF16_COUNTERS)


def plain_engine():
    """Every LSTM of the models on the plain versions, on the card too: the
    forward and backward loops of ``LSTMSequenceFn``'s CPU path, with their
    rounding points (torch autograd through the plain loop would carry h in
    float32 in the backward, where the Pallas backward reads the rounded h)."""
    return mock.patch.object(lstm_ops, "_device_kind", lambda x: "cpu")


def bf16_fwd_work(b: int, t: int, h: int) -> tuple[float, float]:
    """(flops, bytes) of one bfloat16 training forward: the recurrent product,
    whose h operand is the float32 carry (so priced at the float32 peak);
    xproj, w_hh and h_seq in bfloat16, h0, c0, c_seq, hN and cN in
    float32."""
    return 2.0 * b * t * h * 4 * h, 2.0 * (b * t * 4 * h + h * 4 * h + b * t * h) + 4.0 * (b * t * h + 4 * b * h)


def gates_work(b: int, t: int, h: int) -> tuple[float, float]:
    """(flops, bytes) of the gates kernel: hprev @ w_hh over all (b, t);
    xproj, w_hh and h_seq read in bfloat16, the activations written in
    float32."""
    return 2.0 * b * t * h * 4 * h, 2.0 * (b * t * 4 * h + h * 4 * h + b * t * h) + 4.0 * b * t * 4 * h


def bf16_bwd_work(b: int, t: int, h: int) -> tuple[float, float]:
    """(flops, bytes) of one bfloat16 backward with its dW: the dh
    contraction and dW, 2 * 2*B*T*H*4H, each with the float32 gate
    gradients as an operand (so priced at the float32 peak); the activations,
    c_seq (float32), dy, w_hh, h_seq (bfloat16) read, dxproj (bfloat16) and
    the float32 gate gradients written, dW (bfloat16) written."""
    return (2 * 2.0 * b * t * h * 4 * h,
            4.0 * (b * t * 4 * h + b * t * h + b * t * 4 * h) + 2.0 * (2 * b * t * h + h * 4 * h + b * t * 4 * h
                                                                      + h * 4 * h))


def phase_bf16_train_kernels(dev: torch.device) -> tuple[dict, dict, dict]:
    """8a: the bfloat16 training forward, the gates, the backward and dW
    kernels against their plain versions at the training shapes (B=7, T=128,
    the generator's H both directions), timed (CUDA events and device time)
    beside the float32 kernels on the same inputs, the plain versions, the
    bound and cuDNN's bfloat16 LSTM (the forward alone beside the forward,
    the backward alone and forward+backward beside the backward); sums a
    train step."""
    rng = np.random.RandomState(80)
    b, t = TRAIN_B, TRAIN_T
    fwd = {"max_ulps": 0.0, "min_equal_share": 1.0, "max_abs_err": 0.0}
    gates_rec = {"max_abs_err": 0.0}
    bwd = {"max_ulps": 0.0, "min_equal_share": 1.0, "max_abs_err": 0.0}

    def arr(*shape, scale=1.0):
        return torch.from_numpy((rng.randn(*shape) * scale).astype(np.float32)).to(dev)

    for hidden, reverse, n in TRAIN_CASES:
        lim = 1.0 / np.sqrt(hidden)
        x = arr(b, t, 4 * hidden, scale=0.5).to(BF16)
        w = torch.from_numpy(rng.uniform(-lim, lim, (hidden, 4 * hidden)).astype(np.float32)).to(dev).to(BF16)
        h0, c0 = arr(b, hidden, scale=0.5), arr(b, hidden, scale=0.5)
        dy, dhn, dcn = arr(b, t, hidden).to(BF16), arr(b, hidden), arr(b, hidden)
        direction = "reverse" if reverse else "forward"
        # forward: h_seq rounded, the float32 state
        got = lstm_ops.lstm_forward_cuda(x, w, h0, c0, reverse, with_cseq=True)
        f_plan = plan_line("fwd")
        want = lstm_ops.lstm_sequence_train_ref(x, w, h0, c0, reverse)
        torch.cuda.synchronize()
        f_ulps, f_equal = bf16_ulps(got[0].float(), want[0].float())
        f_err = max((g - wv).abs().max().item() for g, wv in zip(got[1:], want[1:]))
        # gates from the rounded h_seq
        act = lstm_ops.lstm_gates_cuda(x, w, h0, want[0], reverse)
        g_err = (act - lstm_ops.lstm_gates_ref(x, w, h0, want[0], reverse)).abs().max().item()
        # backward and dW on the kernel's activations
        bargs = (x, w, h0, c0, want[0], want[1], dy, dhn, dcn, reverse)
        bgot = lstm_ops.lstm_backward_cuda(*bargs, gates=act)
        b_plan = plan_line("bwd")
        bwant = lstm_ops.lstm_backward_ref(*bargs)
        torch.cuda.synchronize()
        dx_ulps, dx_equal = bf16_ulps(bgot[0].float(), bwant[0].float(), BWD_FLOOR)
        dw_ulps, dw_equal = bf16_ulps(bgot[1].float(), bwant[1].float(), BWD_FLOOR)
        b_err = max((bgot[i] - bwant[i]).abs().max().item() for i in (2, 3))
        log(f"lstm bf16 train H={hidden} {direction}: forward h_seq {f_ulps:.2f} ulps {f_equal:.5f} bit-equal, "
            f"state {f_err:.3e}; gates {g_err:.3e}; dx {dx_ulps:.2f} ulps {dx_equal:.5f} bit-equal, dW "
            f"{dw_ulps:.2f} ulps {dw_equal:.5f} bit-equal, dh0/dc0 {b_err:.3e}; fwd {f_plan}; bwd {b_plan}")
        if not (f_ulps <= LSTM_BF16_ULPS and f_equal >= LSTM_BF16_EQUAL and f_err <= LSTM_TOL and g_err <= GATES_TOL
                and max(dx_ulps, dw_ulps) <= LSTM_BF16_ULPS and min(dx_equal, dw_equal) >= LSTM_BF16_EQUAL
                and b_err <= LSTM_TOL):
            raise AssertionError(f"bf16 training kernels H={hidden} reverse={reverse}: forward {f_ulps} ulps "
                                 f"{f_equal} equal, state {f_err}; gates {g_err} (tolerance {GATES_TOL}); dx "
                                 f"{dx_ulps} ulps {dx_equal}, dW {dw_ulps} ulps {dw_equal}; dh0/dc0 {b_err}")
        # times: the bfloat16 kernels, the float32 ones on the same (widened) inputs
        xf, wf = x.float(), w.float()
        f32 = lstm_ops.lstm_forward_cuda(xf, wf, h0, c0, reverse, with_cseq=True, with_gates=True)
        bargs32 = (xf, wf, h0, c0, f32[0], f32[1], dy.float(), dhn, dcn, reverse)
        hprev = lstm_ops._hprev(want[0], h0, reverse).to(BF16).reshape(-1, hidden)
        fwd_fn = functools.partial(lstm_ops.lstm_forward_cuda, x, w, h0, c0, reverse, with_cseq=True)
        fwd32_fn = functools.partial(lstm_ops.lstm_forward_cuda, xf, wf, h0, c0, reverse, with_cseq=True,
                                     with_gates=True)
        gates_fn = functools.partial(lstm_ops.lstm_gates_cuda, x, w, h0, want[0], reverse)
        gates0_fn = functools.partial(lstm_ops.lstm_gates_cuda, x, w, None, want[0], reverse)
        bwd_fn = functools.partial(lstm_ops.lstm_backward_cuda, *bargs, gates=act)
        bwd32_fn = functools.partial(lstm_ops.lstm_backward_cuda, *bargs32, gates=f32[4])
        dw_fn = functools.partial(lstm_ops.lstm_weight_grad_cuda, want[0], h0, bgot[0].float(), reverse)
        lib_fwd_ms, lib_bwd_ms = cudnn_train_parts_ms(dev, hidden, h0, c0, dy, BF16)
        vals = {
            "fwd": dict(ms=cuda_ms(fwd_fn, 3), device_ms=device_ms(fwd_fn, 5), f32_ms=cuda_ms(fwd32_fn, 3),
                        f32_device_ms=device_ms(fwd32_fn, 5),
                        plain_ms=cuda_ms(lambda: lstm_ops.lstm_sequence_train_ref(x, w, h0, c0, reverse), 1),
                        library_ms=lib_fwd_ms),
            # the main path's gates (a zero initial state: h0 None), and 8a's with its float32 h0
            "gates": dict(ms=cuda_ms(gates0_fn, 5), device_ms=device_ms(gates0_fn, 10),
                          h0_device_ms=device_ms(gates_fn, 10),
                          plain_ms=cuda_ms(lambda: lstm_ops.lstm_gates_ref(x, w, None, want[0], reverse), 3),
                          matmul_ms=device_ms(lambda: hprev @ w, 10), host_us=host_us(gates0_fn, 50)),
            "bwd": dict(ms=cuda_ms(bwd_fn, 3), device_ms=device_ms(bwd_fn, 5), f32_ms=cuda_ms(bwd32_fn, 3),
                        f32_device_ms=device_ms(bwd32_fn, 5), dw_ms=cuda_ms(dw_fn, 5),
                        dw_device_ms=device_ms(dw_fn, 10),
                        plain_ms=cuda_ms(lambda: lstm_ops.lstm_backward_ref(*bargs), 1),
                        library_ms=lib_bwd_ms, library_fwd_bwd_ms=cudnn_train_ms(dev, hidden, h0, c0, dy, BF16)),
        }
        for rec, work, key in ((fwd, bf16_fwd_work, "fwd"), (gates_rec, gates_work, "gates"),
                               (bwd, bf16_bwd_work, "bwd")):
            flops, nbytes = work(b, t, hidden)
            for k, v in dict(vals[key], flops=flops, bytes=nbytes).items():
                rec[k] = rec.get(k, 0.0) + n * v
        v = vals
        g_bound, g_by = bf16_bound(*gates_work(b, t, hidden))
        gates_rec.setdefault("by_sequence", {})[f"H={hidden} {direction}"] = dict(
            device_ms=v["gates"]["device_ms"], h0_device_ms=v["gates"]["h0_device_ms"], ms=v["gates"]["ms"],
            bound_ms=g_bound, bound_by=g_by, matmul_ms=v["gates"]["matmul_ms"], host_us=v["gates"]["host_us"],
            plan=str(lstm_ops.gates_plan(b, t, hidden)))
        log(f"lstm gates H={hidden} {direction} a sequence (B={b}, T={t}, h0 None): {v['gates']['device_ms']:.4f} ms "
            f"of device time ({v['gates']['ms']:.4f} by CUDA events; with a float32 h0 "
            f"{v['gates']['h0_device_ms']:.4f}), bound {g_bound:.4f} ms ({g_by}; "
            f"{g_bound / v['gates']['device_ms']:.2f} of it reached), torch.matmul of the product alone "
            f"{v['gates']['matmul_ms']:.4f} ms, the wrapper's host {v['gates']['host_us']:.1f} us a call; "
            f"{lstm_ops.gates_plan(b, t, hidden)}")
        log(f"lstm bf16 train H={hidden} {direction} times (ms; device ms): forward {v['fwd']['ms']:.4f}; "
            f"{v['fwd']['device_ms']:.4f} (f32 kernel {v['fwd']['f32_ms']:.4f}; {v['fwd']['f32_device_ms']:.4f}), "
            f"gates {v['gates']['ms']:.4f}; {v['gates']['device_ms']:.4f} (torch.matmul of the product alone "
            f"{v['gates']['matmul_ms']:.4f}), backward with dW {v['bwd']['ms']:.4f}; {v['bwd']['device_ms']:.4f} "
            f"(f32 kernels {v['bwd']['f32_ms']:.4f}; {v['bwd']['f32_device_ms']:.4f}), of it dW "
            f"{v['bwd']['dw_ms']:.4f}; {v['bwd']['dw_device_ms']:.4f}; cuDNN bf16 fwd {v['fwd']['library_ms']:.4f} "
            f"bwd {v['bwd']['library_ms']:.4f} fwd+bwd {v['bwd']['library_fwd_bwd_ms']:.4f}; seqs_per_step={n}")
        fwd.update(max_ulps=max(fwd["max_ulps"], f_ulps), min_equal_share=min(fwd["min_equal_share"], f_equal),
                   max_abs_err=max(fwd["max_abs_err"], (got[0].float() - want[0].float()).abs().max().item(), f_err))
        gates_rec["max_abs_err"] = max(gates_rec["max_abs_err"], g_err)
        bwd.update(max_ulps=max(bwd["max_ulps"], dx_ulps, dw_ulps),
                   min_equal_share=min(bwd["min_equal_share"], dx_equal, dw_equal),
                   max_abs_err=max(bwd["max_abs_err"], b_err, *((bgot[i].float() - bwant[i].float()).abs().max().item()
                                                                 for i in (0, 1))))
    fwd["bound_ms"], fwd["bound_by"] = bound_ms(fwd.pop("flops"), fwd.pop("bytes"))
    gates_rec["bound_ms"], gates_rec["bound_by"] = bf16_bound(gates_rec.pop("flops"), gates_rec.pop("bytes"))
    gates_rec["host_us"] /= SEQS_PER_STEP  # a call's mean over the step's calls
    bwd["bound_ms"], bwd["bound_by"] = bound_ms(bwd.pop("flops"), bwd.pop("bytes"))
    log(f"lstm bf16 train per step ({SEQS_PER_STEP} sequences, B={b}, T={t}): forward {fwd['ms']:.3f} ms "
        f"({fwd['device_ms']:.3f} device; f32 kernel {fwd['f32_ms']:.3f}, {fwd['f32_device_ms']:.3f}), gates "
        f"{gates_rec['ms']:.3f} ({gates_rec['device_ms']:.3f} device, h0 None; with h0 {gates_rec['h0_device_ms']:.3f}; "
        f"bound {gates_rec['bound_ms']:.4f} "
        f"{gates_rec['bound_by']}; torch.matmul of the product {gates_rec['matmul_ms']:.4f}; host "
        f"{gates_rec['host_us']:.1f} us a call), backward with dW {bwd['ms']:.3f} ({bwd['device_ms']:.3f} device; f32 kernels "
        f"{bwd['f32_ms']:.3f}, {bwd['f32_device_ms']:.3f}); bounds fwd {fwd['bound_ms']:.4f} bwd "
        f"{bwd['bound_ms']:.4f}; cuDNN bf16 fwd {fwd['library_ms']:.3f} bwd {bwd['library_ms']:.3f} fwd+bwd "
        f"{bwd['library_fwd_bwd_ms']:.3f} (card: {card_line()})")
    return fwd, gates_rec, bwd


def bf16_train_profile(solver: Solver, x: torch.Tensor, emb: torch.Tensor) -> dict:
    """Device time by kind over one warm bfloat16 train step
    (torch.profiler), its idle share, and each LSTM kind's launches recorded
    against the wrappers' (a dropped record counted at its kind's mean,
    ``lstm_records``); raises unless the wrappers counted 11 of each."""
    rows, wall_us, launched = device_activity(lambda: solver._step_fn(solver.state, x, emb), counter=profile_counts)
    if launched != (SEQS_PER_STEP,) * 4:
        raise AssertionError(f"the profiled bf16 step launched {launched} (forward, backward, dW, gates)")
    if not rows:
        log("bf16 train profile: the profiler recorded no device time (not measured)")
        return {"device_ms": None, "idle_share": None}
    missing, kinds = lstm_records(rows, launched, BF16_KINDS)
    busy = sum(t for _, _, t in rows) + missing
    for stem, (mean, recorded, made) in kinds.items():
        log(f"bf16 train profile: {stem}: {mean * made / 1e3:.3f} ms ({recorded} of {made} launches recorded, the "
            f"rest at their mean)")
    convs = sum(t for key, _, t in rows if any(w in key.lower() for w in ("conv", "cudnn", "xmma", "implicit",
                                                                             "wgrad", "dgrad", "fprop")))
    log(f"bf16 train profile: cuDNN convolutions {convs / 1e3:.3f} ms; one step at B={TRAIN_B}, T={TRAIN_T}: device "
        f"busy {busy / 1e3:.3f} ms of {wall_us / 1e3:.3f} ms wall (idle share {1 - busy / wall_us:.3f})")
    return {"device_ms": busy / 1e3, "idle_share": 1 - busy / wall_us,
            "lstm_ms": {k: mean * made / 1e3 for k, (mean, _, made) in kinds.items()}}


def bf16_step_gate(dev: torch.device, cfg: Config, x: torch.Tensor, emb: torch.Tensor, label: str, counter,
                   kinds: str) -> dict:
    """One bfloat16 train step (``cfg``) with the kernels against the same
    step on the plain engine on the card, on the kernel step's kinks, and
    the float32 step on the same kinks: every gradient leaf no farther from
    the plain step than BF16_SPREAD times the plain engine's own bfloat16
    spread, the loss within twice its spread; ``counter`` (the launches
    named ``kinds``) counts SEQS_PER_STEP of each over the kernel step and
    none over the plain ones."""
    def fresh(model_cfg: ModelConfig) -> TrainState:
        model = build_generator(model_cfg, device=dev, seed=7, trainable=True)
        return TrainState(0, model, make_optimizer(model, cfg), init_ema(model))

    states = {"kernels": fresh(cfg.model), "plain": fresh(cfg.model), "f32": fresh(ModelConfig())}
    step, step32 = make_train_step(cfg), make_train_step(Config(train=cfg.train))
    tape = KinkTape()
    torch.cuda.synchronize()
    before = counter()
    t0 = time.perf_counter()
    with tape.record():
        mk = step(states["kernels"], x, emb)
        torch.cuda.synchronize()
    k_s = time.perf_counter() - t0
    k_counts = tuple(a - b for a, b in zip(counter(), before))
    if k_counts != (SEQS_PER_STEP,) * len(k_counts):
        raise AssertionError(f"{label}: one step launched {k_counts} {kinds}")
    with plain_engine():
        t0 = time.perf_counter()
        with tape.replay():
            mp = step(states["plain"], x, emb)
            torch.cuda.synchronize()
        p_s = time.perf_counter() - t0
        bf_flips = tape.flips
        with tape.replay():
            m32 = step32(states["f32"], x, emb)
    if tuple(a - b for a, b in zip(counter(), before)) != k_counts:
        raise AssertionError(f"{label}: the plain steps launched kernels")
    loss_k, loss_p, loss32 = (float(m["g_loss"]) for m in (mk, mp, m32))
    grads = {k: {n: p.grad.double() for n, p in st.model.named_parameters()} for k, st in states.items()}
    model = states["kernels"].model
    dtypes = {p.dtype for p in model.parameters()} | {p.grad.dtype for p in model.parameters()} | {
        b.dtype for b in model.buffers()}
    rows = []
    for n, g in grads["kernels"].items():
        scale = grad_scale(n, grads["plain"])
        rows.append(((g - grads["plain"][n]).abs().max().item() / scale,
                     (grads["f32"][n] - grads["plain"][n]).abs().max().item() / scale, n))
    grad_tol = BF16_SPREAD * float(np.median([r[1] for r in rows]))
    over = [r for r in rows if r[0] > grad_tol]
    worst = max(rows)
    loss_tol = min(1e-3 * abs(loss_p), 2 * abs(loss_p - loss32) + 1e-5 * abs(loss_p))
    rel_plain, rel_f32 = abs(loss_k - loss_p) / abs(loss_p), abs(loss_k - loss32) / abs(loss32)
    log(f"{label} step with kernels vs the plain engine (bf16, on the card): loss {loss_k!r} vs {loss_p!r} "
        f"({rel_plain:.3e} relative, tolerance {loss_tol / abs(loss_p):.3e}); the f32 step on the same batch and "
        f"kinks {loss32!r} (the bf16 kernel step {rel_f32:.3e} relative from it); launches {kinds} "
        f"{k_counts}; first step {k_s * 1e3:.1f} ms, plain {p_s * 1e3:.1f} ms; kinks {tape.elements} "
        f"elements, the f32 step on the other side of {tape.flips}, the plain bf16 step of {bf_flips}")
    log(f"{label} gradient gate {grad_tol:.3e} of a leaf's scale: {BF16_SPREAD}x the plain engine's own "
        f"bf16 spread (the median over leaves of its distance from the f32 step; max "
        f"{max(r[1] for r in rows):.3e}); kernel vs plain median {float(np.median([r[0] for r in rows])):.3e}, "
        f"worst {worst[2]} at {worst[0]:.3e}")
    if over or abs(loss_k - loss_p) > loss_tol or dtypes != {torch.float32}:
        raise AssertionError(f"{label}: the step with the kernels: leaves over their gate {over}; loss "
                             f"{loss_k} vs {loss_p} (tolerance {loss_tol}); dtypes {dtypes}")
    return {"loss_rel_to_plain": rel_plain, "loss_rel_to_f32": rel_f32, "grad_tol": grad_tol, "grad_worst": worst[0]}


def phase_bf16_training(dev: torch.device) -> dict:
    """8b: phase 4's Solver with compute_dtype bfloat16: one step with the
    kernels against the same step on the plain engine on the card (on the
    kernel step's kinks), the plain engine's own spread from the float32
    step on the same kinks; 20 Solver steps; the profile of a warm step."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_bf16_")
    try:
        mel_dir = synthetic_features(tmp, np.random.RandomState(20), "spmel", N_MELS)
        cfg = Config(model=ModelConfig(compute_dtype="bfloat16", use_pallas_lstm=True),
                     train=TrainConfig(batch_size=TRAIN_B, len_crop=TRAIN_T, num_iters=TRAIN_STEPS, log_step=1,
                                       checkpoint_step=TRAIN_STEPS), main_dir=tmp, run_name="smoke_bf16")
        data = UtteranceDataset(mel_dir)
        x, emb = (torch.from_numpy(a).to(dev) for a in next(BatchIterator(data, TRAIN_B, TRAIN_T, seed=1)))

        gate = bf16_step_gate(dev, cfg, x, emb, "train bf16 (b)", bf16_counts, "(fwd, gates, bwd, dW)")

        # 20 Solver steps through the entry point
        solver = Solver(cfg, BatchIterator(data, TRAIN_B, TRAIN_T, seed=2), run_dir=os.path.join(tmp, "run"),
                        device=dev)
        torch.cuda.synchronize()
        before = bf16_counts()
        t0 = time.perf_counter()
        solver.train()
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        train_counts = tuple(a - b for a, b in zip(bf16_counts(), before))
        losses = [h["g_loss"] for h in solver.history]
        timing = solver.timer.summary()
        first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
        log(f"train bf16 (b) {TRAIN_STEPS} Solver steps in {train_s:.2f} s wall (checkpoint included): g_loss "
            f"{losses[0]:.4f} -> {losses[-1]:.4f}, mean of first 5 {first:.4f}, last 5 {last:.4f}; launches (fwd, "
            f"gates, bwd, dW) {train_counts}; step p50 {timing['step_ms_p50']:.2f} ms, p95 "
            f"{timing['step_ms_p95']:.2f} ms, {timing['steps_per_sec']:.2f} steps/s (card: {card_line()})")
        if len(losses) != TRAIN_STEPS or not np.isfinite(losses).all() or not last < first:
            raise AssertionError(f"bf16 training did not go down finitely: {losses}")
        if train_counts != (TRAIN_STEPS * SEQS_PER_STEP,) * 4:
            raise AssertionError(f"{TRAIN_STEPS} bf16 steps launched {train_counts} (forward, gates, backward, dW)")
        if {p.dtype for p in solver.state.model.parameters()} != {torch.float32}:
            raise AssertionError("the bf16 Solver's parameters are not float32")
        prof = bf16_train_profile(solver, x, emb)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if os.path.exists(tmp):
        raise AssertionError(f"{tmp} was not removed")
    return {"launches": train_counts, "step_ms_p50": timing["step_ms_p50"], "step_ms_p95": timing["step_ms_p95"],
            **gate, **prof}


def phase_bf16_cli(dev: torch.device) -> dict:
    """8c: ``python -m autovc_tpu_torch.cli.train --bf16 --pallas`` for 3 steps on a
    synthetic spmel tree in a temporary directory, once with ``--lambda_spk``
    on a seeded GE2E .npz (the d-vector in the scan forms), the launch
    counts set to 0 before each run and read after it; each exported, and
    converted through ``Converter`` in bfloat16 and in float32."""
    from autovc_tpu_torch.cli import train as cli_train

    tmp = tempfile.mkdtemp(prefix="chip_smoke_cli_bf16_")
    out = {}
    try:
        synthetic_features(tmp, np.random.RandomState(90), "spmel", N_MELS)
        ckpt = os.path.join(tmp, "ge2e_seeded.npz")
        save_dvector_artifact(speaker_encoder(torch.device("cpu"), False, 768).state_dict(), ckpt)
        rng = np.random.RandomState(91)
        specs = [types.SimpleNamespace(src_features=rng.rand(TRAIN_T, N_MELS).astype(np.float32),
                                       src_embedding=rng.randn(256).astype(np.float32),
                                       trg_embedding=rng.randn(256).astype(np.float32)) for _ in range(4)]
        for name, extra in (("base", []), ("lambda_spk", ["--lambda_spk", "1.0", "--spk_ckpt", ckpt])):
            export = os.path.join(tmp, f"{name}.npz")
            torch.cuda.synchronize()
            zero_counts()
            t0 = time.perf_counter()
            cli_train.main(["--main_dir", tmp, "--run_name", name, "--bf16", "--pallas", "--num_iters", "3",
                            "--batch_size", str(TRAIN_B), "--len_crop", str(TRAIN_T), "--log_step", "1",
                            "--checkpoint_step", "3", "--export", export, *extra])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launched, scan = bf16_counts(), (lstm_ops.scan_launches, lstm_ops.scan_bwd_launches)
            # the generator's 11 sequences a step, each forward, gates, backward
            # and dW; with lambda_spk 7 more, the eval-mode conversion's, whose
            # gradient reaches the generator, and the bfloat16 d-vector's 3 a
            # step in the scan forms, forward and backward (no dW)
            want = (3 * (SEQS_PER_STEP + 7 * bool(extra)),) * 4
            want_scan = (3 * 3 * bool(extra),) * 2
            mels = {}
            for dtype in ("bfloat16", "float32"):
                model_cfg = ModelConfig(compute_dtype=dtype, use_pallas_lstm=True)
                gen = build_generator(model_cfg, artifact=export, device=dev)
                mels[dtype] = np.stack(Converter(gen, model_cfg).convert_batch(specs, batch_size=4))
            delta = float(np.abs(mels["bfloat16"] - mels["float32"]).max())
            log(f"cli.train --bf16 {' '.join(extra[:2])}: 3 steps in {wall:.2f} s wall, launches (bf16 fwd, gates, "
                f"bf16 bwd, dW) {launched}, scan forms (fwd, bwd) {scan}; exported {os.path.getsize(export)} bytes; "
                f"converted 4 mels of {TRAIN_T} frames in bf16 and f32: max-abs {delta:.4f} apart")
            if launched != want or scan != want_scan:
                raise AssertionError(f"cli.train --bf16 {extra[:2]} launched {launched}, scan forms {scan}, expected "
                                     f"{want}, {want_scan}")
            for dtype, m in mels.items():
                if m.shape != (4, TRAIN_T, N_MELS) or not np.isfinite(m).all():
                    raise AssertionError(f"conversion in {dtype} with the exported generator: {m.shape}")
            out[name] = {"wall_s": wall, "launches": launched, "scan_launches": scan, "bf16_f32_mel_delta": delta}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if os.path.exists(tmp):
        raise AssertionError(f"{tmp} was not removed")
    return out



# 8d: the scan rounding's forms (the d-vector in bfloat16: JAX's DVector
# follows its input's dtype and runs _lstm_scan, every op rounded to
# bfloat16, on the bfloat16 generator's conversion) at the d-vector's shapes,
# each against its plain loop: the first SCAN_STEPS steps each direction
# takes >= 99% bit-equal and within 1 bfloat16 ulp or the plain loop's own
# largest ulps there (floored at 2^-16 of the peak forward, BWD_FLOOR
# backward), the sequence within SCAN_SPREAD times the plain loop's own
# spread (its largest distance from itself with the hidden units relabelled
# in SCAN_RELABELLINGS ways: tests/test_torch_gpu.py's rule). At B=1 a flip
# in a bfloat16 carry happens in few orders of the sums (H100, 700 W: 1 in
# 32 at H=768 reverse), so the spread takes 32; h_seq, c_seq and act (the
# residuals the backward reads), the backward on the plain residuals and
# on the kernel's own (the two composed, as LSTMSequenceFn runs them; its
# first steps are not held bit-equal: the residuals carry the forward's
# flips); then the bfloat16 lambda_spk step. The relabelled plain loops run
# stacked, one loop for all (each problem its own products; the first is
# held bit for bit to its loop alone)
SCAN_STEPS, SCAN_SPREAD, SCAN_RELABELLINGS = 16, 2.0, 32
# LSTM launches of one bfloat16 lambda_spk step, in LSTM_COUNTERS' order: the
# generator's 18 sequences in the bfloat16 forms (7 for the conversion, 11 in
# training form), the frozen d-vector's 3 in the scan forms, no dW for them
BF16_SPK_STEP_COUNTS = (21, 18, 3, 21, 18, 3, 18, 18)


def scan_fwd_work(b: int, t: int, h: int) -> tuple[float, float]:
    """(flops, bytes) of one scan-form training forward: the recurrent
    product (bfloat16 h and w_hh, float32 sums); xproj, w_hh and h_seq in
    bfloat16, the residuals c_seq and act written as float32."""
    return 2.0 * b * t * h * 4 * h, 2.0 * (b * t * 4 * h + h * 4 * h + b * t * h) + 4.0 * (b * t * h + b * t * 4 * h)


def scan_plain(x, w, dy, reverse):
    """The plain scan forward's (h_seq, c_seq, act) and its backward's
    dxproj (stacked problems given stacked)."""
    h_seq, c_seq, act, _, _ = lstm_ops.lstm_scan_bf16_train_ref(x, w, reverse=reverse)
    dx = lstm_ops.lstm_scan_bf16_backward_ref(w, act, c_seq, None, dy, reverse=reverse)[0]
    return h_seq, c_seq, act, dx


def gate_columns(perm: torch.Tensor) -> torch.Tensor:
    """The 4H columns [i, f, g, o] of the hidden units in ``perm``'s order."""
    return torch.cat([perm + g * len(perm) for g in range(4)])


def relabelled(x, w, dy, perm):
    """(x, w, dy) with the hidden units relabelled by ``perm``."""
    cols = gate_columns(perm)
    return x[..., cols], w[perm][:, cols], dy[..., perm]


def labelled_back(outs, perm):
    """``scan_plain``'s outputs of a relabelled problem in the first labels."""
    inv = torch.argsort(perm)
    inv4 = gate_columns(inv)
    return tuple(o[..., idx] for o, idx in zip(outs, (inv, inv, inv4, inv4)))


def scan_plain_relabelled(x, w, dy, reverse, perms):
    """``scan_plain`` of every relabelling in ``perms``, in the first labels:
    one stacked plain loop, each problem making its own products (the
    stacked refs round each as alone); the first relabelling is also run
    alone and must come out bit for bit the same."""
    stacked = scan_plain(*(torch.stack(a) for a in zip(*(relabelled(x, w, dy, p) for p in perms))), reverse)
    outs = [labelled_back([o[r] for o in stacked], p) for r, p in enumerate(perms)]
    alone = labelled_back(scan_plain(*relabelled(x, w, dy, perms[0]), reverse), perms[0])
    if not all(torch.equal(a, b) for a, b in zip(alone, outs[0])):
        raise AssertionError("the stacked plain scan loop does not round the first relabelling as its loop alone")
    return outs


def scan_gate(got, want, others, first, floor, equal_gated=True) -> dict:
    """The scan rule of one output: its first steps' ulps against the plain
    loop's own (``others``: the relabelled plain loops), its bit-equal share
    there (not gated with ``equal_gated`` False), its distance against the
    plain loop's own spread; ``ok``."""
    ulps, equal = bf16_ulps(got[:, first].float(), want[:, first].float(), floor)
    own_ulps = max(bf16_ulps(o[:, first].float(), want[:, first].float(), floor)[0] for o in others)
    spread = max((o.float() - want.float()).abs().max().item() for o in others)
    apart = (got.float() - want.float()).abs().max().item()
    ok = bool(ulps <= max(LSTM_BF16_ULPS, own_ulps) and (equal >= LSTM_BF16_EQUAL or not equal_gated)
              and apart <= SCAN_SPREAD * spread)
    return {"ulps": ulps, "own_ulps": own_ulps, "equal": equal, "apart": apart, "spread": float(spread), "ok": ok}


def phase_scan_kernels(dev: torch.device, trained: bool) -> tuple[dict, dict]:
    """8d: the scan forms at the d-vector's widths and batches (T=128), each
    against its plain loop on the card by the scan rule, timed (CUDA events,
    device time) beside the plain loops, the bound and cuDNN's bfloat16
    LSTM (one layer: the forward alone, the backward alone); the bfloat16
    d-vector's forward (three scan sequences) beside the float32 one and
    cuDNN's bfloat16 3-layer LSTM."""
    rng = np.random.RandomState(85)
    fwd, bwd = {"max_abs_err": 0.0, "shapes": []}, {"max_abs_err": 0.0, "shapes": []}
    for hidden in SPK_WIDTHS:
        dvec = speaker_encoder(dev, trained, hidden)
        lim = 1.0 / np.sqrt(hidden)
        w = torch.from_numpy(rng.uniform(-lim, lim, (hidden, 4 * hidden)).astype(np.float32)).to(dev).to(BF16)
        for b in SPK_BATCHES:
            x = torch.from_numpy((rng.randn(b, SPK_T, 4 * hidden) * 0.5).astype(np.float32)).to(dev).to(BF16)
            dy = torch.from_numpy(rng.randn(b, SPK_T, hidden).astype(np.float32)).to(dev).to(BF16)
            cases = {}
            for reverse in (False, True):
                got = lstm_ops.lstm_scan_forward_cuda(x, w, reverse=reverse, with_residuals=True)
                plan = plan_line("scan_fwd")
                want = scan_plain(x, w, dy, reverse)
                dx = lstm_ops.lstm_scan_backward_cuda(w, want[2].float(), want[1].float(), None, dy, reverse=reverse)[0]
                b_plan = plan_line("scan_bwd")
                # the two kernels composed as LSTMSequenceFn runs them: the
                # forward's own residuals into the backward
                dx_both = lstm_ops.lstm_scan_backward_cuda(w, got[2], got[1], None, dy, reverse=reverse)[0]
                torch.cuda.synchronize()
                for res in got[1:3]:
                    if res.dtype != torch.float32 or not torch.equal(res, res.to(BF16).float()):
                        raise AssertionError(f"scan forward H={hidden} B={b}: a residual not bfloat16 values in "
                                             f"float32 ({res.dtype})")
                others = scan_plain_relabelled(
                    x, w, dy, reverse, [torch.from_numpy(np.random.RandomState(k).permutation(hidden)).to(dev)
                                        for k in range(SCAN_RELABELLINGS)])
                early, late = slice(0, SCAN_STEPS), slice(SPK_T - SCAN_STEPS, SPK_T)
                f_first, b_first = (late, early) if reverse else (early, late)
                held = {name: scan_gate(v, want[i], [o[i] for o in others], f_first, 2.0 ** -16)
                        for i, (name, v) in enumerate((("h_seq", got[0]), ("c_seq", got[1].to(BF16)),
                                                       ("act", got[2].to(BF16))))}
                held["dxproj"] = scan_gate(dx, want[3], [o[3] for o in others], b_first, BWD_FLOOR)
                # its first steps read residuals that carry the forward's flips,
                # so only their ulps and the spread are held
                held["dxproj composed"] = scan_gate(dx_both, want[3], [o[3] for o in others], b_first, BWD_FLOOR,
                                                    equal_gated=False)
                cases[reverse] = held
                log(f"lstm scan H={hidden} B={b} {'reverse' if reverse else 'forward'}: "
                    + "; ".join(f"{k} {json.dumps(v)}" for k, v in held.items()) + f"; fwd {plan}; bwd {b_plan}")
                if not all(v["ok"] for v in held.values()):
                    raise AssertionError(f"scan forms H={hidden} B={b} reverse={reverse}: {held}")
            # times of the forward direction, the d-vector's
            act, c_seq = want[2].float(), want[1].float()
            fwd_fn = functools.partial(lstm_ops.lstm_scan_forward_cuda, x, w, with_residuals=True)
            bwd_fn = functools.partial(lstm_ops.lstm_scan_backward_cuda, w, act, c_seq, None, dy)
            h0 = torch.zeros(b, hidden, device=dev)
            lib_fwd_ms, lib_bwd_ms = cudnn_train_parts_ms(dev, hidden, h0, h0, dy, BF16)
            f = dict(ms=cuda_ms(fwd_fn, 5), device_ms=device_ms(fwd_fn, 5),
                     plain_ms=cuda_ms(lambda: lstm_ops.lstm_scan_bf16_train_ref(x, w), 1), library_ms=lib_fwd_ms)
            bk = dict(ms=cuda_ms(bwd_fn, 5), device_ms=device_ms(bwd_fn, 5),
                      plain_ms=cuda_ms(lambda: lstm_ops.lstm_scan_bf16_backward_ref(w, want[2], want[1], None, dy), 1),
                      library_ms=lib_bwd_ms)
            f["bound_ms"], f["bound_by"] = bf16_bound(*scan_fwd_work(b, SPK_T, hidden))
            bk["bound_ms"], bk["bound_by"] = bf16_bound(*scan_times.bwd_work(b, SPK_T, hidden))
            # the bfloat16 d-vector's forward: three scan sequences
            mel = torch.from_numpy(rng.rand(b, SPK_T, N_MELS).astype(np.float32)).to(dev)
            with torch.inference_mode():
                net = torch.nn.LSTM(N_MELS, hidden, 3, batch_first=True).to(dev, BF16)
                mel_bf = mel.to(BF16)
                dvec_bf_ms = cuda_ms(lambda: dvec(mel_bf), reps=SPK_REPS)
                dvec_f32_ms = cuda_ms(lambda: dvec(mel), reps=SPK_REPS)
                lib3_ms = cuda_ms(lambda: net(mel_bf), reps=SPK_REPS)
                e = dvec(mel_bf)
            if e.dtype != torch.float32 or not torch.isfinite(e).all():
                raise AssertionError(f"the bfloat16 d-vector's embeddings: {e.dtype}")
            err_f = max(c[k]["apart"] for c in cases.values() for k in ("h_seq", "c_seq", "act"))
            err_b = max(c[k]["apart"] for c in cases.values() for k in ("dxproj", "dxproj composed"))
            for rec, vals, err in ((fwd, f, err_f), (bwd, bk, err_b)):
                rec["shapes"].append(dict(hidden=hidden, batch=b, max_abs_err=err, **vals))
                rec["max_abs_err"] = max(rec["max_abs_err"], err)
            fwd["shapes"][-1].update(dvector_bf16_ms=dvec_bf_ms, dvector_f32_ms=dvec_f32_ms,
                                     cudnn_bf16_3layer_ms=lib3_ms)
            log(f"lstm scan H={hidden} B={b} T={SPK_T} times (ms): forward {f['ms']:.4f} ({f['device_ms']:.4f} device, "
                f"{f['device_ms'] / SPK_T * 1e3:.2f} us a step; the replaced form {old_scan_us(b, hidden)}; "
                f"plain {f['plain_ms']:.2f}; bound {f['bound_ms']:.4f} {f['bound_by']}; cuDNN bf16 1-layer forward "
                f"{lib_fwd_ms:.4f}), backward without dW {bk['ms']:.4f} ({bk['device_ms']:.4f} device; plain "
                f"{bk['plain_ms']:.2f}; bound {bk['bound_ms']:.4f} {bk['bound_by']}; cuDNN bf16 backward "
                f"{lib_bwd_ms:.4f}); the bf16 d-vector forward {dvec_bf_ms:.4f} (f32 {dvec_f32_ms:.4f}; cuDNN bf16 "
                f"3-layer LSTM {lib3_ms:.4f}) (card: {card_line()})")
    return fwd, bwd


def phase_bf16_speaker_training(dev: torch.device) -> dict:
    """8e: phase 6d's Solver with compute_dtype bfloat16 and lambda_spk=1.0
    ('windowed') on a seeded 80/768/256 encoder: one step's launches (the
    generator's bfloat16 forms, the d-vector's scan forms), SPK_STEPS steps
    with the auxiliary and as many without (p50, p95), the device split of a
    warm step."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_bf16_spk_")
    try:
        mel_dir = synthetic_features(tmp, np.random.RandomState(71), "spmel", N_MELS)
        ckpt = os.path.join(tmp, "ge2e_seeded.npz")
        save_dvector_artifact(speaker_encoder(torch.device("cpu"), False, 768).state_dict(), ckpt)
        base = dict(batch_size=TRAIN_B, len_crop=TRAIN_T, num_iters=SPK_STEPS, log_step=1, checkpoint_step=10_000)
        model_cfg = ModelConfig(compute_dtype="bfloat16", use_pallas_lstm=True)
        cfg = Config(model=model_cfg, train=TrainConfig(**base, lambda_spk=1.0, spk_protocol="windowed",
                                                        spk_ckpt=ckpt), main_dir=tmp, run_name="spk")
        data = UtteranceDataset(mel_dir)
        solver = Solver(cfg, BatchIterator(data, TRAIN_B, TRAIN_T, seed=2), run_dir=os.path.join(tmp, "run"),
                        device=dev)
        x, emb = (torch.from_numpy(a).to(dev) for a in next(BatchIterator(data, TRAIN_B, TRAIN_T, seed=1)))
        torch.cuda.synchronize()
        zero_counts()
        solver.train()
        torch.cuda.synchronize()
        got = all_counts()
        hist = solver.history
        want = tuple(SPK_STEPS * n for n in BF16_SPK_STEP_COUNTS)
        if got != want or len(hist) != SPK_STEPS or not all(np.isfinite(h["g_loss_spk"]) for h in hist):
            raise AssertionError(f"{SPK_STEPS} bf16 lambda_spk steps launched {dict(zip(LSTM_COUNTERS, got))}, "
                                 f"expected {dict(zip(LSTM_COUNTERS, want))}; history {hist[-1:]}")
        timing = solver.timer.summary()
        ref = Solver(Config(model=model_cfg, train=TrainConfig(**base), main_dir=tmp, run_name="base"),
                     BatchIterator(data, TRAIN_B, TRAIN_T, seed=2), run_dir=os.path.join(tmp, "run0"), device=dev)
        ref.train()
        ref_timing = ref.timer.summary()
        rows, wall_us, launched = device_activity(lambda: solver._step_fn(solver.state, x, emb), counter=all_counts)
        if launched != BF16_SPK_STEP_COUNTS:
            raise AssertionError(f"the profiled bf16 lambda_spk step launched {launched}")
        missing, kinds = lstm_records(rows, (launched[0], launched[3], launched[6], launched[7]), BF16_KINDS)
        busy = sum(t for _, _, t in rows) + missing
        log(f"bf16 lambda_spk (e) {SPK_STEPS} Solver steps (windowed, B={TRAIN_B}, T={TRAIN_T}): launches "
            f"{dict(zip(LSTM_COUNTERS, got))}; g_loss_spk {hist[0]['g_loss_spk']:.4f} -> "
            f"{hist[-1]['g_loss_spk']:.4f}; step p50 {timing['step_ms_p50']:.2f} ms, p95 {timing['step_ms_p95']:.2f} "
            f"ms; without lambda_spk p50 {ref_timing['step_ms_p50']:.2f} ms, p95 {ref_timing['step_ms_p95']:.2f} ms; "
            f"one warm step: device busy {busy / 1e3:.3f} ms of {wall_us / 1e3:.3f} ms wall (idle share "
            f"{1 - busy / wall_us:.3f}); "
            + ", ".join(f"{k} {m * n / 1e3:.3f} ms ({r} of {n} recorded)" for k, (m, r, n) in kinds.items())
            + f" (card: {card_line()})")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if os.path.exists(tmp):
        raise AssertionError(f"{tmp} was not removed")
    return {"launches": dict(zip(LSTM_COUNTERS, got)), "step_ms_p50": timing["step_ms_p50"],
            "step_ms_p95": timing["step_ms_p95"], "base_step_ms_p50": ref_timing["step_ms_p50"],
            "device_ms": busy / 1e3, "idle_share": 1 - busy / wall_us}


# phase 9: the stft and wav variants at the published widths (ModelConfig
# defaults; ConvTasNet depth 1, 512 channels, kernel 1024, stride 256) on
# seeded weights
VAR_STEPS = 10  # Solver steps of 9b and 9c
WAV_B, WAV_L = 2, 33536  # the JAX CLI's batch and wav_len_crop: 128 latent frames
WAV_UTTS = 4  # 9d: utterances of phase 5's corpus converted as waveforms
WAVE_RTOL = 1e-4  # 9d: the converted waveform vs the plain recurrence's, of its peak (a seeded
# generator's waveform peaks near 2e-3, below MEL_TOL itself)
CLI_STEPS = 3  # 9e and 9f: cli.train steps, bfloat16 Solver steps
VAR_COUNTERS = LSTM_COUNTERS + ("mel_norm", "sosfilt")  # phase 9's launch counts, in this order


def variant_solver(dev: torch.device, cfg: Config, data: UtteranceDataset, run_dir: str, label: str,
                   steps: int) -> tuple[Solver, dict, tuple[int, ...]]:
    """``steps`` Solver steps from the entry point (no checkpoint): finite
    losses; the step's p50 and p95; the launches of every LSTM wrapper."""
    solver = Solver(cfg, BatchIterator(data, cfg.train.batch_size, cfg.train.len_crop, seed=2), run_dir=run_dir,
                    device=dev)
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    solver.train(steps)
    torch.cuda.synchronize()
    wall, launched = time.perf_counter() - t0, all_counts()
    losses = [h["g_loss"] for h in solver.history]
    # the timer skips the first two steps; a shorter run reports its mean
    timing = solver.timer.summary() or {"step_ms_p50": wall * 1e3 / steps, "step_ms_p95": wall * 1e3 / steps}
    log(f"{label} {steps} Solver steps in {wall:.2f} s wall: g_loss {losses[0]:.4f} -> {losses[-1]:.4f}; step p50 "
        f"{timing['step_ms_p50']:.2f} ms, p95 {timing['step_ms_p95']:.2f} ms; launches "
        + ", ".join(f"{c} {n}" for c, n in zip(LSTM_COUNTERS, launched) if n) + f" (card: {card_line()})")
    if len(losses) != steps or not np.isfinite(losses).all():
        raise AssertionError(f"{label}: the Solver's losses are not {steps} finite values: {losses}")
    return solver, timing, launched


def convtas_device_ms(model, x: torch.Tensor) -> float:
    """Device ms of the ConvTasNet front and back end alone, forward and
    backward, at the step's shapes (torch.profiler)."""
    def fwd_bwd():
        with exact_f32(x.device):
            lat = model.tas_encoder(x)
            (lat.square().mean() + model.tas_decoder(lat).square().mean()).backward()
    rows, _, _ = device_activity(fwd_bwd)
    model.zero_grad(set_to_none=True)
    return sum(t for _, _, t in rows) / 1e3


def phase_variant_conversion(dev: torch.device) -> dict:
    """9a: the stft variant's conversion, Converter.convert_batch(to_mel=True)
    at B=32, T=512, 513 bins, then HiFi-GAN; the mel against the plain
    recurrence's."""
    cfg = ModelConfig(model_type="stft")
    gen = build_generator(cfg, device=dev, seed=11)
    converter = Converter(gen, cfg)
    voc = HiFiGANVocoder(device=dev, seed=2)
    rng = np.random.RandomState(90)
    emb = rng.randn(2, cfg.dim_emb).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    specs = [types.SimpleNamespace(src_features=rng.rand(T, 513).astype(np.float32), src_embedding=emb[0],
                                   trg_embedding=emb[1]) for _ in range(B)]
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    mels = np.stack(converter.convert_batch(specs, batch_size=B, to_mel=True))
    wav = voc.generate(mels)
    torch.cuda.synchronize()
    cold_s, launched = time.perf_counter() - t0, all_counts()
    launches = launched[0]
    if launches != 7 or sum(launched) != 7:
        raise AssertionError(f"9a: expected 7 lstm kernel launches per stft Generator forward, got {launched}")
    if mels.shape != (B, T, N_MELS) or not np.isfinite(mels).all():
        raise AssertionError(f"9a: mel {mels.shape} finite={np.isfinite(mels).all()}")
    if wav.shape != (B, T * HOP) or not bool(torch.isfinite(wav).all()):
        raise AssertionError(f"9a: waveform {tuple(wav.shape)} finite={bool(torch.isfinite(wav).all())}")
    with plain_recurrence():
        plain = np.stack(converter.convert_batch(specs, batch_size=B, to_mel=True))
    err = float(np.abs(mels - plain).max())
    x = torch.from_numpy(np.stack([s.src_features for s in specs])).to(dev)
    e_src, e_trg = (torch.from_numpy(np.tile(e, (B, 1))).to(dev) for e in emb)
    with torch.inference_mode(), exact_f32(dev):
        gen_ms = cuda_ms(lambda: gen(x, e_src, e_trg), reps=3)
        busy, _, parts, _ = device_split(lambda: gen(x, e_src, e_trg))
        stft_out = gen(x, e_src, e_trg)[1]
        proj_ms = cuda_ms(lambda: torch.matmul(stft_out, converter.mel_basis), reps=20)
    lstm_ms = parts["lstm_fwd"][0] * parts["lstm_fwd"][2]
    log(f"variants (a) stft conversion, B={B}, T={T}, 513 bins -> 80 mels: cold {cold_s:.3f} s, lstm launches "
        f"{launches}; mel vs the plain recurrence max_abs_err {err:.3e} (tol {MEL_TOL}); generator {gen_ms:.2f} ms, "
        f"{busy:.2f} ms of device time, of it the LSTM kernel {lstm_ms:.2f} ({split_line(parts)}); projection "
        f"{proj_ms:.4f} ms (torch.matmul, exact f32) (card: {card_line()})")
    if not err <= MEL_TOL:
        raise AssertionError(f"9a: the stft mel differs from the plain path: {err} > {MEL_TOL}")
    return {"launches": launches, "max_abs_err": err, "gen_ms": gen_ms, "lstm_ms": lstm_ms, "proj_ms": proj_ms,
            "specs": specs, "mels": mels}


def phase_variant_stft_training(dev: torch.device, tmp: str) -> dict:
    """9b: the stft variant's train step at B=7, T=128 against the plain
    step, then VAR_STEPS Solver steps and the profile of a warm step."""
    feat_dir = synthetic_features(tmp, np.random.RandomState(91), "stft", 513)
    cfg = Config(model=ModelConfig(model_type="stft"),
                 train=TrainConfig(batch_size=TRAIN_B, len_crop=TRAIN_T, num_iters=VAR_STEPS, log_step=1,
                                   checkpoint_step=10**9), main_dir=tmp, run_name="stft")
    data = UtteranceDataset(feat_dir)
    x, emb = (torch.from_numpy(a).to(dev) for a in next(BatchIterator(data, TRAIN_B, TRAIN_T, seed=1)))
    gate = step_gate(dev, cfg, x, emb, "variants (b) stft")
    solver, timing, launched = variant_solver(dev, cfg, data, os.path.join(tmp, "run_stft"), "variants (b) stft",
                                              VAR_STEPS)
    if launched[0] != launched[3] or launched[3] != launched[6] or launched[0] != VAR_STEPS * SEQS_PER_STEP:
        raise AssertionError(f"9b: {VAR_STEPS} stft steps launched {launched}")
    train_profile(solver, x, emb, (SEQS_PER_STEP,) * 3)
    return {**gate, "launches": (launched[0], launched[3], launched[6]), "step_ms_p50": timing["step_ms_p50"],
            "step_ms_p95": timing["step_ms_p95"], "data": data}


def phase_variant_wav_conversion(dev: torch.device, main_dir: str) -> dict:
    """9d: phase 5's corpus as wav features (cli.make_spect --model_type wav,
    cli.make_metadata --model_type wav), WAV_UTTS utterances converted by
    WavConverter.convert_to_mel: the generator's outputs against the plain
    recurrence's (the waveform within WAVE_RTOL of its peak, the latent,
    the decoder's output and the codes within MEL_TOL), the re-extracted mel
    by the feature path's gates."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mel_ops.launches = sosfilt_ops.launches = 0
    written = make_spect.main(["--main_dir", main_dir, "--wav_dir", os.path.join(main_dir, "..", "wavs"),
                               "--model_type", "wav"])
    torch.cuda.synchronize()
    spect_s, spect_counts = time.perf_counter() - t0, feature_counts()
    t0 = time.perf_counter()
    make_metadata.main(["--main_dir", main_dir, "--model_type", "wav"])
    meta_s = time.perf_counter() - t0
    wav_dir = os.path.join(main_dir, "wav")
    entries = load_train_manifest(os.path.join(wav_dir, "train.pkl"))
    log(f"variants (d) make_spect --model_type wav: {len(written)} files in {spect_s:.2f} s (sosfilt, mel_norm "
        f"launches {spect_counts[1]}, {spect_counts[0]}); make_metadata --model_type wav {meta_s:.2f} s, "
        f"{len(entries)} speakers")
    if spect_counts != (0, 2 * len(written)):
        raise AssertionError(f"9d: make_spect wav launched {spect_counts} (mel_norm, sosfilt)")

    cfg = ModelConfig(model_type="wav")
    converter = WavConverter(build_generator(cfg, device=dev, seed=12), cfg)
    n_spk = len(entries)
    pairs = all_pairs_specs(entries, wav_dir)
    specs = [pairs[i * n_spk + (i + 1) % n_spk] for i in range(min(WAV_UTTS, n_spk))]  # each to the next speaker
    torch.cuda.synchronize()
    zero_counts()
    mel_ops.launches = sosfilt_ops.launches = 0
    t0 = time.perf_counter()
    mels = [converter.convert_to_mel(s) for s in specs]
    torch.cuda.synchronize()
    conv_s, lstm_n, feat_n = time.perf_counter() - t0, all_counts(), feature_counts()
    if lstm_n[0] != 7 * len(specs) or sum(lstm_n) != lstm_n[0] or feat_n != (len(specs), 2 * len(specs)):
        raise AssertionError(f"9d: {len(specs)} wav conversions launched lstm {lstm_n}, (mel_norm, sosfilt) "
                             f"{feat_n}; expected 7, 1 and 2 an utterance")
    fe_cpu, fe64 = MelFrontend(device="cpu"), MelFrontend(dtype=torch.float64, device="cpu")
    names = ("x_latent", "x_identic", "x_decoder", "codes")
    worst = {"wave": 0.0, "wave_rel": 0.0, "after": 0.0, "exact": 0.0, "cpu_exact": 0.0}
    worst.update({n: 0.0 for n in names if n != "x_identic"})
    peaks = dict.fromkeys(names, 0.0)
    for spec, mel in zip(specs, mels):
        outs = wav_generator_outputs(converter, spec)
        with plain_recurrence():
            plain = wav_generator_outputs(converter, spec)
        wave, plain_wave = outs[1][0, :, 0].numpy(), plain[1][0, :, 0].numpy()
        w_err = float(np.abs(wave - plain_wave).max())
        others = {n: (o - p).abs().max().item() for n, o, p in zip(names, outs, plain) if n != "x_identic"}
        peaks = {n: max(v, p.abs().max().item()) for (n, v), p in zip(peaks.items(), plain)}
        filtered = converter.frontend.highpass_dither(wave)
        after = fe_cpu.from_filtered("spmel", filtered.cpu())
        card = converter.frontend.from_filtered("spmel", filtered).cpu()
        exact = fe64.mel_features(wave.astype(np.float64)).float()
        cpu = fe_cpu.mel_features(wave)
        case = {"wave": w_err, "wave_rel": w_err / float(np.abs(plain_wave).max()), **others,
                "after": (card - after).abs().max().item(),
                "exact": float(np.abs(mel - exact.numpy()).max()), "cpu_exact": (cpu - exact).abs().max().item()}
        worst = {k: max(v, case[k]) for k, v in worst.items()}
        if mel.shape[1] != N_MELS or not np.isfinite(mel).all() or not (mel.min() >= 0 and mel.max() <= 1):
            raise AssertionError(f"9d: re-extracted mel {mel.shape}, {mel.min()} .. {mel.max()}")
        if not (case["wave_rel"] <= WAVE_RTOL and all(v <= MEL_TOL for v in others.values())
                and case["after"] <= FE_TOL and case["exact"] <= max(EXACT_TOL, case["cpu_exact"] + FE_TOL)):
            raise AssertionError(f"9d: {spec.src_name} -> {spec.trg_speaker}: {case}")
    log(f"variants (d) WavConverter.convert_to_mel, {len(specs)} utterances ({[m.shape[0] for m in mels]} frames) "
        f"in {conv_s:.3f} s: lstm launches {lstm_n[0]}, mel_norm {feat_n[0]}, sosfilt {feat_n[1]}; the waveform vs "
        f"the plain recurrence max_abs_err {worst['wave']:.3e}, {worst['wave_rel']:.3e} of its peak (tol "
        f"{WAVE_RTOL}); the other outputs vs the plain recurrence (tol {MEL_TOL}): " + ", ".join(
            f"{n} {worst[n]:.3e} (peak {peaks[n]:.3e})" for n in names if n != "x_identic")
        + f", the waveform's peak {peaks['x_identic']:.3e}; the mel after the highpass vs the CPU's stages "
        f"{worst['after']:.3e} (tol {FE_TOL}); vs the f64 host chain {worst['exact']:.3e} (tol {EXACT_TOL}, or the "
        f"CPU f32 path's {worst['cpu_exact']:.3e} plus {FE_TOL})")
    return {"launches": lstm_n[0], "feature_launches": tuple(a + b for a, b in zip(spect_counts, feat_n)),
            "max_abs_err": worst["wave"], "specs": specs, "mels": mels}


def wav_generator_outputs(converter: WavConverter, spec) -> list[torch.Tensor]:
    """The generator's four outputs (x_latent, x_identic, x_decoder, codes)
    on the card, float32 on the host, for the input WavConverter.convert
    gives it (the waveform cut to its valid length)."""
    x = np.asarray(spec.src_features, np.float32).reshape(len(spec.src_features), -1)
    n = converter.valid_length(x.shape[0])
    args = [torch.as_tensor(np.asarray(a, np.float32), device=converter.device)
            for a in (x[None, :n], spec.src_embedding[None], spec.trg_embedding[None])]
    with torch.inference_mode(), exact_f32(converter.device):
        return [o.float().cpu() for o in converter.generator(*args)]


def phase_variant_wav_training(dev: torch.device, main_dir: str, tmp: str) -> dict:
    """9c: the wav variant's train step at B=2, len_crop 33536 on phase 5's
    corpus (9d's wav features) against the plain step (PReLU on the
    KinkTape), VAR_STEPS Solver steps, the profile of a warm step and the
    ConvTasNet convolutions' share."""
    cfg = Config(model=ModelConfig(model_type="wav"),
                 train=TrainConfig(batch_size=WAV_B, len_crop=WAV_L, num_iters=VAR_STEPS, log_step=1,
                                   checkpoint_step=10**9), main_dir=main_dir, run_name="wav")
    data = UtteranceDataset(os.path.join(main_dir, "wav"))
    x, emb = (torch.from_numpy(a).to(dev) for a in next(BatchIterator(data, WAV_B, WAV_L, seed=1)))
    gate = step_gate(dev, cfg, x, emb, "variants (c) wav")
    if "prelu" not in gate["kinds"]:
        raise AssertionError("9c: the wav step's PReLUs are not on the KinkTape")
    solver, timing, launched = variant_solver(dev, cfg, data, os.path.join(tmp, "run_wav"), "variants (c) wav",
                                              VAR_STEPS)
    if launched[0] != launched[3] or launched[3] != launched[6] or launched[0] != VAR_STEPS * SEQS_PER_STEP:
        raise AssertionError(f"9c: {VAR_STEPS} wav steps launched {launched}")
    train_profile(solver, x, emb, (SEQS_PER_STEP,) * 3, f"B={WAV_B}, L={WAV_L}")
    tas_ms = convtas_device_ms(solver.state.model, x)
    log(f"variants (c) wav: g_loss_sisnr {solver.history[-1]['g_loss_sisnr']:.4f}; the ConvTasNet front and back "
        f"end alone, forward and backward at B={WAV_B}, L={WAV_L}: {tas_ms:.3f} ms of device time")
    return {**gate, "launches": (launched[0], launched[3], launched[6]), "step_ms_p50": timing["step_ms_p50"],
            "step_ms_p95": timing["step_ms_p95"], "convtas_ms": tas_ms, "data": data}


def _finite_results(path: str, n: int, width: int | None, label: str) -> None:
    results = load_results(path)
    bad = [name for name, m in results if not np.isfinite(m).all() or (width and m.shape[-1] != width)]
    if len(results) != n or bad:
        raise AssertionError(f"{label}: {path} holds {len(results)} results (expected {n}); bad {bad}")


def cli_expected(forwards: int = 0, train_seqs: int = 0, wav_convs: int = 0, files: int = 0) -> tuple[int, ...]:
    """The launches of a float32 CLI run: ``forwards`` LSTM sequences
    forward, ``train_seqs`` of them also backward and dW; one mel_norm and
    two sosfilt launches for each wav conversion's re-extraction, two
    sosfilt launches for each file make_spect writes."""
    return (forwards, 0, 0, train_seqs, 0, 0, train_seqs, 0, wav_convs, 2 * wav_convs + 2 * files)


def phase_variant_clis(dev: torch.device, main_dir: str, ckpt: str) -> dict:
    """9e: the CLIs end to end on the card on phase 5's corpus: make_spect and
    make_metadata --model_type stft, cli.train stft and wav (CLI_STEPS
    steps each, exported), cli.convert --run_dir (stft --all_pairs; wav),
    cli.evaluate (stft) and cli.evaluate_conversion --through mel with the
    seeded GE2E of phase 6. Each CLI runs with every count at 0, its model
    forwards counted (Generator, GeneratorWav, DVector), and launches 7 LSTM
    sequences a generator forward and 3 a d-vector forward, 11 a train step
    forward, backward and dW, 1 mel_norm and 2 sosfilt a wav conversion."""
    from autovc_tpu_torch.models import DVector, Generator, GeneratorWav

    walls, per_cli = {}, {}

    def timed(name, fn, *args):
        forwards = dict.fromkeys((Generator, GeneratorWav, DVector), 0)

        def hook(module, _inputs, _output):
            if type(module) in forwards:
                forwards[type(module)] += 1

        handle = torch.nn.modules.module.register_module_forward_hook(hook)
        try:
            torch.cuda.synchronize()
            zero_counts()
            mel_ops.launches = sosfilt_ops.launches = 0
            t0 = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            walls[name] = time.perf_counter() - t0
        finally:
            handle.remove()
        gens, wavs, dvecs = forwards[Generator] + forwards[GeneratorWav], forwards[GeneratorWav], forwards[DVector]
        if name.startswith("train"):
            want = cli_expected(CLI_STEPS * SEQS_PER_STEP, CLI_STEPS * SEQS_PER_STEP)
        elif name.startswith("make_spect"):
            want = cli_expected(files=len(out))
        else:
            want = cli_expected(7 * gens + 3 * dvecs, wav_convs=wavs)
        per_cli[name] = got = all_counts() + feature_counts()
        if got != want or (name.startswith(("convert", "evaluate")) and not gens):
            raise AssertionError(f"9e {name}: launched {dict(zip(VAR_COUNTERS, got))}, expected "
                                 f"{dict(zip(VAR_COUNTERS, want))} ({gens} generator forwards, {wavs} of them wav, "
                                 f"{dvecs} d-vector forwards)")
        return out

    timed("make_spect stft", make_spect.main, ["--main_dir", main_dir, "--wav_dir",
                                                os.path.join(main_dir, "..", "wavs"), "--model_type", "stft"])
    timed("make_metadata stft", make_metadata.main, ["--main_dir", main_dir, "--model_type", "stft"])
    n_spk = len(load_train_manifest(os.path.join(main_dir, "stft", "train.pkl")))
    arts = {}
    for mt in ("stft", "wav"):
        arts[mt] = os.path.join(main_dir, f"{mt}_cli.npz")
        timed(f"train {mt}", cli_train.main, ["--main_dir", main_dir, "--run_name", f"cli_{mt}", "--model_type", mt,
                                              "--num_iters", str(CLI_STEPS), "--log_step", "1", "--checkpoint_step",
                                              str(CLI_STEPS), "--export", arts[mt]])
    runs = {mt: next(os.path.join(main_dir, "runs", d) for d in os.listdir(os.path.join(main_dir, "runs"))
                     if d.startswith(f"cli_{mt}_")) for mt in ("stft", "wav")}
    out = {k: os.path.join(main_dir, f"results_{k}.pkl") for k in ("stft", "wav")}
    timed("convert stft --all_pairs", cli_convert.main, ["--main_dir", main_dir, "--run_dir", runs["stft"],
                                                         "--model_type", "stft", "--all_pairs", "--out", out["stft"]])
    _finite_results(out["stft"], n_spk * n_spk, N_MELS, "9e convert stft")
    timed("convert wav", cli_convert.main, ["--main_dir", main_dir, "--run_dir", runs["wav"], "--model_type", "wav",
                                            "--out", out["wav"]])
    n_wav = len(load_conversion_metadata(os.path.join(main_dir, "wav", "metadata.pkl")))
    _finite_results(out["wav"], n_wav, N_MELS, "9e convert wav")
    report = timed("evaluate stft", evaluate.main, ["--main_dir", main_dir, "--run_dir", runs["stft"],
                                                    "--model_type", "stft", "--max_utts", "16"])
    if report["utterances"] != 16 or not all(np.isfinite(v) for k, v in report.items() if k.startswith("recon")):
        raise AssertionError(f"9e evaluate: {report}")
    sim = timed("evaluate_conversion stft", evaluate_conversion.main,
                ["--main_dir", main_dir, "--artifact", arts["stft"], "--dvector_ckpt", ckpt, "--model_type", "stft",
                 "--through", "mel", "--centroid_utts", "4"])["summary"]
    if sim["pairs"] != n_spk * (n_spk - 1) or not np.isfinite(sim["mean_margin"]):
        raise AssertionError(f"9e evaluate_conversion: {sim}")
    launched = tuple(map(sum, zip(*per_cli.values())))
    log("variants (e) the CLIs on the card, wall s: " + ", ".join(f"{k} {v:.2f}" for k, v in walls.items())
        + f"; evaluate {json.dumps(report)}; evaluate_conversion success {sim['success_rate']:.3f}, mean margin "
        f"{sim['mean_margin']:.4f} (seeded weights); launches " + "; ".join(
            f"{k}: " + ", ".join(f"{c} {n}" for c, n in zip(VAR_COUNTERS, v) if n) for k, v in per_cli.items()))
    return {"walls": walls, "launched": launched, "train_pkl": out}


def phase_variant_bf16(dev: torch.device, conv: dict, wav: dict, stft_data: UtteranceDataset,
                       wav_data: UtteranceDataset, tmp: str) -> dict:
    """9f: the stft and wav variants converted in bfloat16 beside 9a's and
    9d's float32 (the mel max-abs recorded, not gated, as 7b's), and
    CLI_STEPS bfloat16 Solver steps of each (finite)."""
    zero_counts()
    mel_ops.launches = sosfilt_ops.launches = 0
    cfg = ModelConfig(model_type="stft", compute_dtype="bfloat16", use_pallas_lstm=True)
    t0 = time.perf_counter()
    stft = np.stack(Converter(build_generator(cfg, device=dev, seed=11), cfg).convert_batch(conv["specs"],
                                                                                            batch_size=B))
    stft_s = time.perf_counter() - t0
    cfg = ModelConfig(model_type="wav", compute_dtype="bfloat16", use_pallas_lstm=True)
    converter = WavConverter(build_generator(cfg, device=dev, seed=12), cfg)
    mels = [converter.convert_to_mel(s) for s in wav["specs"]]
    deltas = {"stft": float(np.abs(stft - conv["mels"]).max()),
              "wav": max(float(np.abs(m - w).max()) for m, w in zip(mels, wav["mels"]))}
    if not np.isfinite(stft).all() or not all(np.isfinite(m).all() for m in mels):
        raise AssertionError("9f: a bfloat16 conversion is not finite")
    launched = all_counts() + feature_counts()
    steps = {}
    for mt, data, b, crop in (("stft", stft_data, TRAIN_B, TRAIN_T), ("wav", wav_data, WAV_B, WAV_L)):
        cfg = Config(model=ModelConfig(model_type=mt, compute_dtype="bfloat16", use_pallas_lstm=True),
                     train=TrainConfig(batch_size=b, len_crop=crop, num_iters=CLI_STEPS, log_step=1,
                                       checkpoint_step=10**9), main_dir=tmp, run_name=f"bf16_{mt}")
        _, timing, by_solver = variant_solver(dev, cfg, data, os.path.join(tmp, f"run_bf16_{mt}"),
                                              f"variants (f) bf16 {mt}", CLI_STEPS)
        steps[mt] = timing["step_ms_p50"]
        launched = tuple(a + b for a, b in zip(launched, by_solver + (0, 0)))
    log(f"variants (f) bfloat16 conversion beside float32 (recorded, not a gate): stft mel max-abs delta "
        f"{deltas['stft']:.4f} (B={B}, T={T}, {stft_s:.2f} s cold), wav re-extracted mel {deltas['wav']:.4f}; "
        f"bf16 step p50 stft {steps['stft']:.2f} ms, wav {steps['wav']:.2f} ms; launches " + ", ".join(
            f"{c} {n}" for c, n in zip(VAR_COUNTERS, launched) if n))
    return {"mel_delta": deltas, "step_ms_p50": steps, "launched": launched}


def phase_variants(dev: torch.device, main_dir: str, ckpt: str) -> dict:
    """Phase 9 (a)-(f). Returns the launches a kernel took on each
    sub-path, in LSTM_COUNTERS' order then mel_norm and sosfilt."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_variants_")
    try:
        conv = phase_variant_conversion(dev)
        stft = phase_variant_stft_training(dev, tmp)
        wav_conv = phase_variant_wav_conversion(dev, main_dir)
        wav = phase_variant_wav_training(dev, main_dir, tmp)
        clis = phase_variant_clis(dev, main_dir, ckpt)
        bf16 = phase_variant_bf16(dev, conv, wav_conv, stft["data"], wav["data"], tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if os.path.exists(tmp):
        raise AssertionError(f"{tmp} was not removed")
    n = len(LSTM_COUNTERS)
    zeros = (0,) * n
    paths = {
        "convert_stft": (conv["launches"],) + zeros[1:] + (0, 0),
        "train_stft": (stft["launches"][0], 0, 0, stft["launches"][1], 0, 0, stft["launches"][2], 0, 0, 0),
        "convert_wav": (wav_conv["launches"],) + zeros[1:] + wav_conv["feature_launches"],
        "train_wav": (wav["launches"][0], 0, 0, wav["launches"][1], 0, 0, wav["launches"][2], 0, 0, 0),
        "clis": clis["launched"],
        "bf16": bf16["launched"],
    }
    return {"paths": paths, "conv": conv, "stft": stft, "wav_conv": wav_conv, "wav": wav, "clis": clis,
            "bf16": bf16}


# ------------------------------------------------ phase 10: the scan rounding
# The Generator's LSTMs in bfloat16 as JAX's default lax.scan rounds them
# (ModelConfig.use_pallas_lstm=False): (hidden, reverse, sequences a
# Generator forward) at phase 1's B=32, T=512, held by 8d's scan rule
SCAN_GEN_CASES = [(32, False, 2), (32, True, 2), (512, False, 1), (1024, False, 2)]
# 10b: the scan dW kernel at the training shapes, both directions
SCAN_DW_HIDDEN = (32, 512, 1024)
SCAN_TRAIN_STEPS = 5  # Solver steps in the scan rounding
SCAN_COUNTERS = ("scan_launches", "scan_bwd_launches", "scan_dw_launches")


def scan_counts() -> tuple[int, int, int]:
    """The scan rounding's training launches: forward, backward, dW."""
    return tuple(getattr(lstm_ops, c) for c in SCAN_COUNTERS)


def scan_fwd_relabelled(x, w, reverse, perms):
    """The plain scan forward's h_seq of every relabelling in ``perms``, in
    the first labels: one stacked plain loop (each problem its own
    products), the first relabelling held bit for bit to its loop alone."""
    cols = [gate_columns(p) for p in perms]
    stacked = lstm_ops.lstm_scan_bf16_ref(torch.stack([x[..., c] for c in cols]),
                                          torch.stack([w[p][:, c] for p, c in zip(perms, cols)]), reverse=reverse)
    outs = [stacked[r][..., torch.argsort(p)] for r, p in enumerate(perms)]
    alone = lstm_ops.lstm_scan_bf16_ref(x[..., cols[0]], w[perms[0]][:, cols[0]], reverse=reverse)
    if not torch.equal(alone[..., torch.argsort(perms[0])], outs[0]):
        raise AssertionError("the stacked plain scan loop does not round the first relabelling as its loop alone")
    return outs


def scan_inference_work(b: int, t: int, h: int) -> tuple[float, float]:
    """(flops, bytes) of one scan-form inference forward: the recurrent
    product of bfloat16 operands; xproj, w_hh and h_seq in bfloat16."""
    return 2.0 * b * t * h * 4 * h, 2.0 * (b * t * 4 * h + h * 4 * h + b * t * h)


# The form of csrc/lstm_fwd.cu that csrc/lstm_scan_fwd.cu replaced (float32
# FMAs on the CUDA cores), its last recorded device time, us a step, by
# (B, H) (PERF.md §6, NVIDIA H100 80GB HBM3, 700 W: the d-vector's at T=128,
# the Generator's at T=512); None where none was recorded
OLD_SCAN_FWD_US = {(32, 32): 1.17, (32, 512): 7.5, (32, 1024): 16.24, (7, 768): 5.63, (7, 256): 4.28,
                   (1, 768): 4.02, (1, 256): 3.95}
OLD_SCAN_GEN_DEVICE_MS = 23.03  # the replaced form's 7 sequences a Generator forward (B=32, T=512), as recorded


def old_scan_us(b: int, h: int) -> str:
    old = OLD_SCAN_FWD_US.get((b, h))
    return "not recorded" if old is None else f"{old:.2f} us a step"


def cudnn_fwd_ms(dev: torch.device, hidden: int, b: int, t: int, dtype: torch.dtype) -> float:
    """Yardstick only: torch.nn.LSTM (cuDNN), one layer of H units on a (B,
    T, H) input, inference forward in ``dtype`` (its input product
    included; it rounds otherwise than the scan forms)."""
    net = torch.nn.LSTM(hidden, hidden, batch_first=True).to(dev, dtype)
    x = torch.randn(b, t, hidden, device=dev, dtype=dtype)
    with torch.inference_mode():
        return cuda_ms(lambda: net(x), 3)


def scan_forward_case(dev: torch.device, label: str, b: int, t: int, hidden: int, reverse: bool,
                      rng: np.random.RandomState, train: bool = False) -> dict:
    """The scan forward (``lstm_scan_forward_cuda``; with ``train`` its
    training form, the residuals kept) at (B, T, H) on seeded inputs against
    its plain loop by the scan rule (SCAN_RELABELLINGS relabelled plain
    loops run stacked), one launch; its device time a step beside the bound,
    the plan and the replaced form's recorded time."""
    lim = 1.0 / np.sqrt(hidden)
    x = torch.from_numpy((rng.randn(b, t, 4 * hidden) * 0.5).astype(np.float32)).to(dev).to(BF16)
    w = torch.from_numpy(rng.uniform(-lim, lim, (hidden, 4 * hidden)).astype(np.float32)).to(dev).to(BF16)
    zero_counts()
    got = lstm_ops.lstm_scan_forward_cuda(x, w, reverse=reverse, with_residuals=train)[0]
    torch.cuda.synchronize()
    if (lstm_ops.launches, lstm_ops.scan_launches, lstm_ops.bf16_launches) != (1, 1, 0):
        raise AssertionError(f"{label}: the scan forward launched {all_counts()}")
    plan = plan_line("scan_fwd")
    want = lstm_ops.lstm_scan_bf16_ref(x, w, reverse=reverse)
    others = scan_fwd_relabelled(x, w, reverse, [torch.from_numpy(np.random.RandomState(k).permutation(hidden))
                                                 .to(dev) for k in range(SCAN_RELABELLINGS)])
    first = slice(t - SCAN_STEPS, t) if reverse else slice(0, SCAN_STEPS)
    held = scan_gate(got, want, others, first, 2.0 ** -16)
    del others
    fn = functools.partial(lstm_ops.lstm_scan_forward_cuda, x, w, reverse=reverse, with_residuals=train)
    dev_ms = device_ms(fn, 5)
    bound, bound_by = bf16_bound(*(scan_fwd_work if train else scan_inference_work)(b, t, hidden))
    log(f"{label} lstm scan forward{' (training form)' if train else ''} H={hidden} "
        f"{'reverse' if reverse else 'forward'} B={b} T={t}: {json.dumps(held)}; {dev_ms:.4f} ms device, "
        f"{dev_ms / t * 1e3:.2f} us a step (the replaced form: {old_scan_us(b, hidden)}), bound {bound:.4f} ms "
        f"({bound_by}); {plan}")
    if not held["ok"]:
        raise AssertionError(f"{label}: the scan forward H={hidden} B={b} reverse={reverse} fails the scan rule: "
                             f"{held}")
    return dict(hidden=hidden, batch=b, reverse=reverse, device_ms=dev_ms, us_a_step=dev_ms / t * 1e3,
                bound_ms=bound, bound_by=bound_by, **held)


def phase_scan_generator(dev: torch.device) -> dict:
    """10a: the forward kernel's scan form at the Generator's shapes (B=32,
    T=512) against its plain loop by the scan rule (the first SCAN_STEPS
    steps within 1 ulp or the plain loop's own ulps there and 99%
    bit-equal; the sequence within SCAN_SPREAD times the spread of
    SCAN_RELABELLINGS relabelled plain loops run stacked), timed beside the
    plain loop and the bound; the sums a Generator forward."""
    rng = np.random.RandomState(100)
    rec = {"max_abs_err": 0.0, "ms": 0.0, "device_ms": 0.0, "plain_ms": 0.0, "flops": 0.0, "bytes": 0.0,
           "cases": []}
    for hidden, reverse, calls in SCAN_GEN_CASES:
        lim = 1.0 / np.sqrt(hidden)
        x = torch.from_numpy((rng.randn(B, T, 4 * hidden) * 0.5).astype(np.float32)).to(dev).to(BF16)
        w = torch.from_numpy(rng.uniform(-lim, lim, (hidden, 4 * hidden)).astype(np.float32)).to(dev).to(BF16)
        zero_counts()
        got = lstm_ops.lstm_sequence(x, w, reverse, scan=True)
        torch.cuda.synchronize()
        if all_counts() != (1, 0, 1, 0, 0, 0, 0, 0) or got.dtype != BF16:
            raise AssertionError(f"the scan forward H={hidden} launched {all_counts()} ({got.dtype})")
        plan = plan_line("scan_fwd")
        want = lstm_ops.lstm_sequence_ref(x, w, reverse, scan=True)
        others = scan_fwd_relabelled(x, w, reverse, [torch.from_numpy(np.random.RandomState(k).permutation(hidden))
                                                     .to(dev) for k in range(SCAN_RELABELLINGS)])
        first = slice(T - SCAN_STEPS, T) if reverse else slice(0, SCAN_STEPS)
        held = scan_gate(got, want, others, first, 2.0 ** -16)
        del others
        fn = functools.partial(lstm_ops.lstm_sequence, x, w, reverse, True)
        ms, dev_ms = cuda_ms(fn, 5), device_ms(fn, 5)
        plain_ms = cuda_ms(lambda: lstm_ops.lstm_sequence_ref(x, w, reverse, scan=True), 1)
        lib_ms = cudnn_fwd_ms(dev, hidden, B, T, BF16)
        flops, nbytes = scan_inference_work(B, T, hidden)
        bound, bound_by = bf16_bound(flops, nbytes)
        log(f"10a lstm scan forward H={hidden} {'reverse' if reverse else 'forward'} B={B} T={T}: {json.dumps(held)}; "
            f"ms={ms:.4f} ({dev_ms:.4f} device; {dev_ms / T * 1e3:.2f} us a step; the replaced form: "
            f"{old_scan_us(B, hidden)}), plain_ms={plain_ms:.1f}, bound_ms={bound:.4f} ({bound_by}), cuDNN bf16 "
            f"1-layer forward {lib_ms:.4f}; {plan}")
        if not held["ok"]:
            raise AssertionError(f"10a: the scan forward H={hidden} reverse={reverse} fails the scan rule: {held}")
        rec["cases"].append(dict(hidden=hidden, reverse=reverse, ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                                 bound_ms=bound, library_ms=lib_ms, us_a_step=dev_ms / T * 1e3, **held))
        rec["max_abs_err"] = max(rec["max_abs_err"], held["apart"])
        for key, v in (("ms", ms), ("device_ms", dev_ms), ("plain_ms", plain_ms), ("library_ms", lib_ms),
                       ("flops", flops), ("bytes", nbytes)):
            rec[key] = rec.get(key, 0.0) + calls * v
    rec["bound_ms"], rec["bound_by"] = bf16_bound(rec.pop("flops"), rec.pop("bytes"))
    log(f"10a lstm scan forward per Generator forward (7 sequences): {rec['ms']:.3f} ms ({rec['device_ms']:.3f} "
        f"device; the replaced form {OLD_SCAN_GEN_DEVICE_MS} device as PERF.md §6 records it), plain "
        f"{rec['plain_ms']:.1f}, bound {rec['bound_ms']:.4f} ({rec['bound_by']}), cuDNN bf16 1-layer forwards "
        f"{rec['library_ms']:.3f} (card: {card_line()})")
    return rec


# The kernels csrc/lstm_scan_bwd.cu and csrc/lstm_scan_dw.cu replaced, device
# ms a sequence at B=7, T=128 by (H, reverse): the scan backward (the SCAN
# instance of lstm_bwd.cu: float32 FMAs, float32 gate gradients exchanged)
# and the scan dW (one block a 64 x 64 tile), as scripts/scan_train_times.py
# measured them on NVIDIA H100 80GB HBM3, 700.00 W (PERF.md §6).
OLD_SCAN_BWD_MS = {(32, False): 0.14391, (32, True): 0.14454, (512, False): 0.86788, (512, True): 0.96359,
                   (1024, False): 1.31988, (1024, True): 1.28765}
OLD_SCAN_DW_MS = {(32, False): 0.20580, (32, True): 0.20474, (512, False): 0.25605, (512, True): 0.25603,
                  (1024, False): 0.82735, (1024, True): 0.82728}
# cycles of one rounded add in a dependent chain, add.rn.bf16x2 (the scan
# dW's chain a step): scripts/scan_dw_phases.py, NVIDIA H100 80GB HBM3
DW_ADD_CYCLES = 8.13


def scan_dw_latency_ms(t: int) -> float:
    """The scan dW's latency bound: each output is a chain of T rounded adds,
    DW_ADD_CYCLES each at the SM clock, whatever the card's width."""
    return t * DW_ADD_CYCLES / SM_CLOCK_HZ * 1e3


# calls a device time of 10b's scan backward and dW queues (scan_times.queued_ms)
SCAN_TIME_REPS = 20

# a train step's 11 sequences: 8 at H=32 (the encoder's 4, run twice), 1 at
# H=512, 2 at H=1024, as phase 4 counts them
SCAN_STEP_CALLS = {32: 8, 512: 1, 1024: 2}


def per_step(cases: list[dict], key: str) -> float:
    """A per-sequence number of the forward-direction cases summed over a
    train step's SCAN_STEP_CALLS sequences."""
    by_h = {c["hidden"]: c for c in cases}
    return sum(n * by_h[h][key] for h, n in SCAN_STEP_CALLS.items())


def phase_scan_train_kernels(dev: torch.device) -> tuple[dict, dict]:
    """10b (kernels): at B=7, T=128, H in SCAN_DW_HIDDEN, both directions,
    on the plain scan chain's outputs: ``lstm_scan_backward_cuda`` on the
    plain forward's residuals against ``lstm_scan_bf16_backward_ref`` by the
    scan rule (its first SCAN_STEPS steps and the spread of
    SCAN_RELABELLINGS relabelled plain loops run stacked), one launch; and
    ``lstm_scan_weight_grad_cuda`` on the plain h_seq and dxproj against
    ``lstm_scan_bf16_weight_grad_ref`` by the bfloat16 backward rule (1 ulp
    floored at BWD_FLOOR of the peak, 99% bit-equal), one launch, two calls
    the same bits. Each timed in the forward direction (device time: calls
    queued behind a sleep, ``scripts/scan_train_times.py``'s) beside
    the replaced kernel's recorded time, its plan, the plain loop and the
    bound: the backward's beside cuDNN's bfloat16 LSTM backward alone (a
    yardstick the port never calls), dW's beside its latency bound and
    torch.matmul's one-shot product over K = B*T in bfloat16 (which rounds
    once: not the function); summed over a train step's 11 sequences."""
    rng = np.random.RandomState(101)
    b, t = TRAIN_B, TRAIN_T
    bwd = {"max_abs_err": 0.0, "cases": []}
    rec = {"max_abs_err": 0.0, "max_ulps": 0.0, "min_equal_share": 1.0, "shapes": []}
    for hidden in SCAN_DW_HIDDEN:
        lim = 1.0 / np.sqrt(hidden)
        x = torch.from_numpy((rng.randn(b, t, 4 * hidden) * 0.5).astype(np.float32)).to(dev).to(BF16)
        w = torch.from_numpy(rng.uniform(-lim, lim, (hidden, 4 * hidden)).astype(np.float32)).to(dev).to(BF16)
        dy = torch.from_numpy(rng.randn(b, t, hidden).astype(np.float32)).to(dev).to(BF16)
        for reverse in (False, True):
            h_seq, c_seq, act, dx = scan_plain(x, w, dy, reverse)
            act32, c32 = act.float(), c_seq.float()
            zero_counts()
            got_dx = lstm_ops.lstm_scan_backward_cuda(w, act32, c32, None, dy, reverse=reverse)[0]
            torch.cuda.synchronize()
            launched = all_counts() + (lstm_ops.scan_dw_launches,)
            if launched != (0, 0, 0, 1, 0, 1, 0, 0, 0):
                raise AssertionError(f"10b scan backward H={hidden}: launched {launched} (LSTM_COUNTERS, scan dW)")
            b_plan = plan_line("scan_bwd")
            others = scan_plain_relabelled(x, w, dy, reverse, [torch.from_numpy(np.random.RandomState(k)
                                                                                .permutation(hidden)).to(dev)
                                                               for k in range(SCAN_RELABELLINGS)])
            first = slice(0, SCAN_STEPS) if reverse else slice(t - SCAN_STEPS, t)  # the backward's first steps
            held = scan_gate(got_dx, dx, [o[3] for o in others], first, BWD_FLOOR)
            del others
            log(f"10b lstm scan backward H={hidden} {'reverse' if reverse else 'forward'} B={b} T={t}: "
                f"{json.dumps(held)}; {b_plan}")
            if not held["ok"]:
                raise AssertionError(f"10b: the scan backward H={hidden} reverse={reverse} fails the scan rule: "
                                     f"{held}")
            bwd["max_abs_err"] = max(bwd["max_abs_err"], held["apart"])
            zero_counts()
            got = lstm_ops.lstm_scan_weight_grad_cuda(h_seq, None, dx, reverse)
            again = lstm_ops.lstm_scan_weight_grad_cuda(h_seq, None, dx, reverse)
            torch.cuda.synchronize()
            d_plan = plan_line("scan_dw")
            want = lstm_ops.lstm_scan_bf16_weight_grad_ref(h_seq, None, dx, reverse)
            ulps, equal = bf16_ulps(got.float(), want.float(), BWD_FLOOR)
            err = (got.float() - want.float()).abs().max().item()
            if (lstm_ops.scan_dw_launches != 2 or lstm_ops.dw_launches or not torch.equal(got, again)
                    or not (ulps <= LSTM_BF16_ULPS and equal >= LSTM_BF16_EQUAL)):
                raise AssertionError(f"10b scan dW H={hidden} reverse={reverse}: {ulps} ulps, {equal} bit-equal, "
                                     f"launches {lstm_ops.scan_dw_launches}, repeatable {torch.equal(got, again)}")
            log(f"10b lstm scan dW H={hidden} {'reverse' if reverse else 'forward'} B={b} T={t}: {ulps:.2f} bf16 "
                f"ulps (floor {BWD_FLOOR} of the peak), {equal:.5f} bit-equal, max_abs_err={err:.3e}; {d_plan}")
            rec["max_abs_err"] = max(rec["max_abs_err"], err)
            rec["max_ulps"] = max(rec["max_ulps"], ulps)
            rec["min_equal_share"] = min(rec["min_equal_share"], equal)
            if reverse:
                continue
            # times, the forward direction
            fn = functools.partial(lstm_ops.lstm_scan_backward_cuda, w, act32, c32, None, dy)
            case = dict(hidden=hidden, ms=cuda_ms(fn, 5), device_ms=scan_times.queued_ms(fn, SCAN_TIME_REPS),
                        plain_ms=cuda_ms(lambda: lstm_ops.lstm_scan_bf16_backward_ref(w, act, c_seq, None, dy), 1),
                        library_ms=scan_times.cudnn_bwd_ms(dev, b, t, hidden, 5), **held)
            case["bound_ms"], case["bound_by"] = bf16_bound(*scan_times.bwd_work(b, t, hidden))
            bwd["cases"].append(case)
            log(f"10b lstm scan backward H={hidden} B={b} T={t}: {case['device_ms']:.4f} ms device "
                f"({case['device_ms'] / t * 1e3:.2f} us a step; {case['ms']:.4f} by events), the replaced kernel "
                f"{OLD_SCAN_BWD_MS[(hidden, False)]:.4f} as recorded, plain {case['plain_ms']:.1f}, bound {case['bound_ms']:.5f} "
                f"({case['bound_by']}), cuDNN bf16 backward alone {case['library_ms']:.4f} (a yardstick the port "
                f"never calls)")
            fn = functools.partial(lstm_ops.lstm_scan_weight_grad_cuda, h_seq, None, dx)
            hprev = torch.cat([torch.zeros_like(h_seq[:, :1]), h_seq[:, :-1]], dim=1).reshape(-1, hidden)
            dxk = dx.reshape(-1, 4 * hidden)
            case = dict(hidden=hidden, ms=cuda_ms(fn, 10), device_ms=scan_times.queued_ms(fn, SCAN_TIME_REPS),
                        plain_ms=cuda_ms(lambda: lstm_ops.lstm_scan_bf16_weight_grad_ref(h_seq, None, dx), 1),
                        library_ms=scan_times.queued_ms(lambda: hprev.T @ dxk, SCAN_TIME_REPS), ulps=ulps,
                        equal=equal, max_abs_err=err)
            case["bound_ms"], case["bound_by"] = bf16_bound(*scan_times.dw_work(b, t, hidden))
            rec["shapes"].append(case)
            log(f"10b lstm scan dW H={hidden} B={b} T={t}: {case['device_ms']:.4f} ms device ({case['ms']:.4f} by "
                f"events), the replaced kernel {OLD_SCAN_DW_MS[(hidden, False)]:.4f} as recorded, plain "
                f"{case['plain_ms']:.1f}, bound {case['bound_ms']:.5f} ({case['bound_by']}), latency bound "
                f"{scan_dw_latency_ms(t):.5f} (T x "
                f"{DW_ADD_CYCLES} cycles at {SM_CLOCK_HZ / 1e9:.2f} GHz), torch.matmul of the one-shot product "
                f"{case['library_ms']:.4f} ms (device)")
    for r, work_fn in ((bwd, scan_times.bwd_work), (rec, scan_times.dw_work)):
        cases = r["cases"] if r is bwd else r["shapes"]
        for key in ("ms", "device_ms", "plain_ms", "library_ms"):
            r[key] = per_step(cases, key)
        work = [work_fn(b, t, h) for h, n in SCAN_STEP_CALLS.items() for _ in range(n)]
        r["bound_ms"], r["bound_by"] = bf16_bound(sum(f for f, _ in work), sum(y for _, y in work))
    before = {name: sum(n * old[(h, False)] for h, n in SCAN_STEP_CALLS.items())
              for name, old in (("bwd", OLD_SCAN_BWD_MS), ("dw", OLD_SCAN_DW_MS))}
    log(f"10b lstm scan backward per train step (11 sequences): {bwd['device_ms']:.4f} ms device ({bwd['ms']:.4f} "
        f"events; the replaced kernel {before['bwd']:.4f} as recorded), plain {bwd['plain_ms']:.1f}, bound "
        f"{bwd['bound_ms']:.5f} ({bwd['bound_by']}), cuDNN bf16 backward {bwd['library_ms']:.4f}; scan dW "
        f"{rec['device_ms']:.4f} ms device ({rec['ms']:.4f} events; the replaced kernel {before['dw']:.4f} as "
        f"recorded), plain {rec['plain_ms']:.1f}, bound {rec['bound_ms']:.5f} ({rec['bound_by']}), latency bound "
        f"{scan_dw_latency_ms(t):.5f} (the 11 chains side by side), torch.matmul one-shot {rec['library_ms']:.4f} "
        f"(card: {card_line()})")
    return bwd, rec


def phase_scan_forward_train(dev: torch.device) -> list[dict]:
    """10b (forward): the scan forward's training form at phase 4's B=7,
    T=128, H in SCAN_DW_HIDDEN, against its plain loop by the scan rule,
    its device time a step beside the bound and the plan."""
    rng = np.random.RandomState(103)
    return [scan_forward_case(dev, "10b", TRAIN_B, TRAIN_T, hidden, False, rng, train=True)
            for hidden in SCAN_DW_HIDDEN]


# the scan forms' kernels by name stem, in SCAN_COUNTERS' order
SCAN_KINDS = {"scan forward": "lstm_fwd_scan_", "scan backward": "lstm_bwd_scan_", "scan dW": "lstm_scan_dw_"}


def scan_step_split(rows, launched: tuple[int, int, int]) -> dict[str, tuple[float, int | None, int | None]]:
    """A profiled scan train step's device time by kind: the scan forward,
    backward and dW (each launch whose record torch.profiler dropped counted
    at its kind's mean: it drops cooperative kernels' records) and the rest;
    (ms, launches recorded, launches the wrapper counted) each."""
    split = {}
    for (kind, stem), made in zip(SCAN_KINDS.items(), launched):
        total = sum(t for key, _, t in rows if stem in key)
        recorded = sum(c for key, c, _ in rows if stem in key)
        if recorded > made:
            raise AssertionError(f"the profiler recorded {recorded} {kind} launches, the wrapper made {made}")
        split[kind] = ((total + (made - recorded) * (total / recorded if recorded else 0.0)) / 1e3, recorded, made)
    rest = sum(t for key, _, t in rows if not any(stem in key for stem in SCAN_KINDS.values()))
    split["rest"] = (rest / 1e3, None, None)
    return split


def phase_scan_training(dev: torch.device) -> dict:
    """10b (training): phase 4's Solver in bfloat16 with the scan rounding
    (``use_pallas_lstm=False``, JAX's ``--bf16``): one step with the kernels
    against the plain engine on the same kinks (8b's gate), SCAN_TRAIN_STEPS
    Solver steps (11 scan forward, backward and dW launches a step, no
    Pallas-form launch), the profile of a warm step; then ``cli.train
    --bf16`` and ``--bf16 --pallas``, 3 steps each, their launches."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_scan_")
    try:
        mel_dir = synthetic_features(tmp, np.random.RandomState(102), "spmel", N_MELS)
        cfg = Config(model=ModelConfig(compute_dtype="bfloat16"),
                     train=TrainConfig(batch_size=TRAIN_B, len_crop=TRAIN_T, num_iters=SCAN_TRAIN_STEPS, log_step=1,
                                       checkpoint_step=10**9), main_dir=tmp, run_name="smoke_scan")
        data = UtteranceDataset(mel_dir)
        x, emb = (torch.from_numpy(a).to(dev) for a in next(BatchIterator(data, TRAIN_B, TRAIN_T, seed=1)))
        zero_counts()
        gate = bf16_step_gate(dev, cfg, x, emb, "10b train scan", scan_counts, "(scan fwd, bwd, dW)")
        if bf16_counts() != (0, 0, 0, 0):
            raise AssertionError(f"10b: the scan step launched Pallas-form kernels {bf16_counts()}")
        solver = Solver(cfg, BatchIterator(data, TRAIN_B, TRAIN_T, seed=2), run_dir=os.path.join(tmp, "run"),
                        device=dev)
        torch.cuda.synchronize()
        zero_counts()
        solver.train()
        torch.cuda.synchronize()
        launched, other = scan_counts(), bf16_counts()
        losses = [h["g_loss"] for h in solver.history]
        timing = solver.timer.summary()
        if (launched != (SCAN_TRAIN_STEPS * SEQS_PER_STEP,) * 3 or other != (0, 0, 0, 0)
                or len(losses) != SCAN_TRAIN_STEPS or not np.isfinite(losses).all()):
            raise AssertionError(f"10b: {SCAN_TRAIN_STEPS} scan Solver steps launched {launched} (Pallas forms "
                                 f"{other}), losses {losses}")
        rows, wall_us, prof_launched = device_activity(lambda: solver._step_fn(solver.state, x, emb),
                                                       counter=scan_counts)
        split = scan_step_split(rows, prof_launched)
        busy = sum(ms for ms, _, _ in split.values()) * 1e3
        scan_dw_us = split["scan dW"][0] * 1e3
        log(f"10b {SCAN_TRAIN_STEPS} scan Solver steps: g_loss {losses[0]:.4f} -> {losses[-1]:.4f}; launches "
            f"(scan fwd, bwd, dW) {launched}; step p50 {timing['step_ms_p50']:.2f} ms, p95 {timing['step_ms_p95']:.2f} "
            f"ms; one warm step: device busy {busy / 1e3:.3f} ms of {wall_us / 1e3:.3f} ms wall (idle share "
            f"{1 - busy / wall_us:.3f}); its split: "
            + ", ".join(f"{k} {ms:.3f} ms" + ("" if made is None else f" ({rec} of {made} launches recorded)")
                        for k, (ms, rec, made) in split.items()) + f" (card: {card_line()})")
        # every LSTM counter (LSTM_COUNTERS' order, then scan_dw_launches):
        # the scan rounding launches only the scan forms, --pallas only the
        # Pallas-rounding forms
        n = 3 * SEQS_PER_STEP
        cli = {}
        for name, extra, counter, want in (
                ("bf16", [], lambda: all_counts() + (lstm_ops.scan_dw_launches,), (n, 0, n, n, 0, n, 0, 0, n)),
                ("bf16_pallas", ["--pallas"], lambda: all_counts() + (lstm_ops.scan_dw_launches,),
                 (n, n, 0, n, n, 0, n, n, 0))):
            export = os.path.join(tmp, f"{name}.npz")
            torch.cuda.synchronize()
            zero_counts()
            t0 = time.perf_counter()
            cli_train.main(["--main_dir", tmp, "--run_name", name, "--bf16", *extra, "--num_iters", "3",
                            "--batch_size", str(TRAIN_B), "--len_crop", str(TRAIN_T), "--log_step", "1",
                            "--checkpoint_step", "3", "--export", export])
            torch.cuda.synchronize()
            wall, got = time.perf_counter() - t0, counter()
            log(f"10b cli.train --bf16 {' '.join(extra)}: 3 steps in {wall:.2f} s wall, launches (LSTM_COUNTERS, "
                f"scan dW) {got}")
            if got != want:
                raise AssertionError(f"10b cli.train --bf16 {extra} launched {got}, expected {want}")
            cli[name] = {"wall_s": wall, "launches": got}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if os.path.exists(tmp):
        raise AssertionError(f"{tmp} was not removed")
    return {"launches": launched, "step_ms_p50": timing["step_ms_p50"], "step_ms_p95": timing["step_ms_p95"],
            "device_ms": busy / 1e3, "idle_share": 1 - busy / wall_us, "scan_dw_step_ms": scan_dw_us / 1e3,
            "split_ms": {k: ms for k, (ms, _, _) in split.items()},
            "cli": cli, **gate}


# ----------------------------------------- phase 11: vocoder and GE2E training
GE2E_M, GE2E_CROP = 5, 128  # utterances a speaker and crop frames; every corpus speaker a batch
GE2E_CLI_STEPS = 3
VOC_STEPS = 5  # timed train steps of each vocoder trainer (the first one is the warm-up)
VOC_B, VOC_FRAMES, VOC_MAX_TIME = 2, 32, 8000  # the JAX CLI's --batch_size, --frames, --max_time
EVAL_UTTS = 4  # 11c: utterances of phase 5's corpus a vocoder is evaluated on (WaveNet: the shortest one)


def phase_ge2e(dev: torch.device, corpus: str, main_dir: str) -> dict:
    """11a: GE2E training on phase 5's spmel tree (every speaker, M=5, crops
    of 128): at H=768 and 256 and B = N*M, the LSTM training forward and
    the backward with dW against their plain versions (1e-4; dW 1e-4 of its
    peak), timed; one ``GE2ETrainer`` loss and gradient with the kernels
    against the plain engine on the card (loss 1e-5 relative, every leaf
    1e-4 of its scale, or no farther from the plain float64 step than twice
    the plain float32 step plus 1e-4; 3 forward, backward and dW
    launches), then a step;
    ``cli.train_speaker_encoder`` for 3 steps and ``cli.make_metadata
    --dvector_ckpt`` on the checkpoint it wrote, in a copy of the tree."""
    from autovc_tpu_torch.cli import train_speaker_encoder
    from autovc_tpu_torch.train.ge2e import GE2ETrainer, sample_ge2e_batch

    ds = train_speaker_encoder.speaker_dataset(os.path.join(main_dir, "spmel"))
    n = ds.num_speakers
    batch = sample_ge2e_batch(ds.features, n, GE2E_M, GE2E_CROP, np.random.default_rng(0))
    b = n * GE2E_M
    rng = np.random.RandomState(110)
    out = {"kernels": [], "launches": (0, 0, 0)}
    # the bfloat16 d-vector's scan forward at this batch (B = N*M), both widths
    out["scan_forward"] = [scan_forward_case(dev, "11a", b, GE2E_CROP, hidden, False, np.random.RandomState(111))
                           for hidden in SPK_WIDTHS]
    for hidden in SPK_WIDTHS:
        lim = 1.0 / np.sqrt(hidden)
        x = torch.from_numpy((rng.randn(b, GE2E_CROP, 4 * hidden) * 0.5).astype(np.float32)).to(dev)
        w = torch.from_numpy(rng.uniform(-lim, lim, (hidden, 4 * hidden)).astype(np.float32)).to(dev)
        dy = torch.from_numpy(rng.randn(b, GE2E_CROP, hidden).astype(np.float32)).to(dev)
        zero_counts()
        h_seq, c_seq, hn, cn, gates = lstm_ops.lstm_forward_cuda(x, w, with_cseq=True, with_gates=True)
        dx, dw, _, _ = lstm_ops.lstm_backward_cuda(x, w, None, None, h_seq, c_seq, dy, gates=gates)
        torch.cuda.synchronize()
        if counts() != (1, 1, 1):
            raise AssertionError(f"11a H={hidden}: launched {counts()} (forward, backward, dW)")
        want = lstm_ops.lstm_sequence_train_ref(x, w)
        wdx, wdw, _, _ = lstm_ops.lstm_backward_ref(x, w, None, None, want[0], want[1], dy)
        errs = {"h_seq": (h_seq - want[0]).abs().max().item(), "c_seq": (c_seq - want[1]).abs().max().item(),
                "dxproj": (dx - wdx).abs().max().item(), "dW_rel": ((dw - wdw).abs().max() / wdw.abs().max()).item()}
        if max(errs["h_seq"], errs["c_seq"], errs["dxproj"]) > LSTM_TOL or errs["dW_rel"] > LSTM_TOL:
            raise AssertionError(f"11a H={hidden} B={b}: the training kernels against the plain loops {errs}")

        def fwd_bwd():
            o = lstm_ops.lstm_forward_cuda(x, w, with_cseq=True, with_gates=True)
            return lstm_ops.lstm_backward_cuda(x, w, None, None, o[0], o[1], dy, gates=o[4])

        zeros = torch.zeros(b, hidden, device=dev)
        ms, dev_ms = cuda_ms(fwd_bwd, 5), device_ms(fwd_bwd, 5)
        plain_ms = cuda_ms(lambda: lstm_ops.lstm_backward_ref(x, w, None, None, want[0], want[1], dy), 1) + cuda_ms(
            lambda: lstm_ops.lstm_sequence_train_ref(x, w), 1)
        work = [lstm_train_work(b, GE2E_CROP, hidden), lstm_bwd_work(b, GE2E_CROP, hidden)]
        bound, bound_by = bound_ms(sum(f for f, _ in work), sum(y for _, y in work))
        lib_ms = cudnn_train_ms(dev, hidden, zeros, zeros, dy)
        out["kernels"].append(dict(hidden=hidden, batch=b, ms=ms, device_ms=dev_ms, plain_ms=plain_ms, bound_ms=bound,
                                   bound_by=bound_by, library_ms=lib_ms, **errs))
        log(f"11a lstm training kernels with dW H={hidden} B={b} T={GE2E_CROP}: {json.dumps(errs)}; forward+backward "
            f"with dW {ms:.4f} ms ({dev_ms:.4f} device), plain {plain_ms:.1f}, bound {bound:.4f} ({bound_by}), "
            f"cuDNN forward+backward {lib_ms:.4f}; fwd {plan_line('fwd')}; bwd {plan_line('bwd')}")

        # one trainer's loss and gradient, the kernels against the plain
        # engine, and the plain engine in float64 (phase 4c's rule where a
        # leaf's float32 sums over B*T terms cancel below GRAD_TOL)
        trainers = {k: GE2ETrainer(dim_cell=hidden, seed=3, device=dev) for k in ("kernels", "plain", "f64")}
        trainers["f64"].model.double()
        for p in (trainers["f64"].w, trainers["f64"].b):
            p.data = p.data.double()
        batch_t = torch.from_numpy(batch).to(dev)
        zero_counts()
        losses = {}
        for k, tr in trainers.items():
            with exact_f32(dev), (plain_engine() if k != "kernels" else contextlib.nullcontext()):
                loss = tr.loss(batch_t.to(tr.w.dtype))
                loss.backward()
                losses[k] = float(loss.detach())
            if k == "kernels":
                torch.cuda.synchronize()
                k_counts = counts()
        grads = {k: [p.grad.double() for p in tr.parameters()] for k, tr in trainers.items()}
        rows = []
        for g, p, e in zip(grads["kernels"], grads["plain"], grads["f64"]):
            scale = max(float(p.abs().max()), 1e-30)
            rows.append(tuple(float((a - c).abs().max()) / scale for a, c in ((g, p), (p, e), (g, e))))
        worst = max(r[0] for r in rows)
        over = [r for r in rows if r[0] > GRAD_TOL and r[2] > 2 * r[1] + GRAD_TOL]
        loss_rel = abs(losses["kernels"] - losses["plain"]) / abs(losses["plain"])
        if k_counts != (3, 3, 3) or counts() != k_counts or loss_rel > LOSS_RTOL or over:
            raise AssertionError(f"11a GE2E H={hidden}: launches {k_counts} (then {counts()}), loss {loss_rel}, "
                                 f"leaves over the gate (from plain, plain from f64, from f64) {over}")
        zero_counts()
        tr = trainers["kernels"]
        t0 = time.perf_counter()
        step_loss = float(tr.step(batch))
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3
        prof_rows, wall_us, launched = device_activity(lambda: tr.step(batch))
        busy = sum(t for _, _, t in prof_rows)
        out["launches"] = tuple(a + c for a, c in zip(out["launches"], k_counts))
        out.setdefault("steps", []).append(dict(hidden=hidden, loss_rel=loss_rel, grad_err=worst, step_ms=step_ms,
                                                device_ms=busy / 1e3, idle_share=1 - busy / wall_us))
        log(f"11a GE2ETrainer H={hidden} N={n} M={GE2E_M}: loss {losses['kernels']!r} vs the plain engine "
            f"{losses['plain']!r} (rel {loss_rel:.3e}, tol {LOSS_RTOL}); worst gradient leaf {worst:.3e} of its "
            f"scale (tol {GRAD_TOL}, else within twice the plain step's distance from float64 + {GRAD_TOL}: "
            f"{sum(r[0] > GRAD_TOL for r in rows)} leaves took that rule); launches (fwd, bwd, dW) {k_counts}; a step "
            f"{step_ms:.1f} ms (loss {step_loss:.4f}), a warm step's device busy {busy / 1e3:.3f} ms of "
            f"{wall_us / 1e3:.3f} ms wall (idle share {1 - busy / wall_us:.3f}; launches {launched})")

    # the CLIs in a copy of the spmel tree
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ge2e_", dir=corpus)
    shutil.copytree(os.path.join(main_dir, "spmel"), os.path.join(tmp, "spmel"))
    ckpt = os.path.join(tmp, "ge2e.npz")
    zero_counts()
    t0 = time.perf_counter()
    train_speaker_encoder.main(["--main_dir", tmp, "--num_iters", str(GE2E_CLI_STEPS), "--m_utts", str(GE2E_M),
                                "--log_step", "1", "--out", ckpt])
    torch.cuda.synchronize()
    cli_s, cli_counts = time.perf_counter() - t0, counts()
    zero_counts()
    t0 = time.perf_counter()
    make_metadata.main(["--main_dir", tmp, "--dvector_ckpt", ckpt, "--seed", "0"])
    torch.cuda.synchronize()
    meta_s, meta_counts = time.perf_counter() - t0, counts()
    entries = load_train_manifest(os.path.join(tmp, "spmel", "train.pkl"))
    norms = [float(np.linalg.norm(e.embedding)) for e in entries]
    log(f"11a cli.train_speaker_encoder {GE2E_CLI_STEPS} steps: {cli_s:.2f} s wall, launches (fwd, bwd, dW) "
        f"{cli_counts}; cli.make_metadata on its checkpoint: {meta_s:.2f} s wall, launches {meta_counts}, "
        f"{len(entries)} speakers, embedding norms {min(norms):.6f}..{max(norms):.6f}")
    # make_metadata's embeddings are means of 10 unit d-vectors a speaker
    if cli_counts != (3 * GE2E_CLI_STEPS,) * 3 or meta_counts[1:] != (0, 0) or len(entries) != n or not all(
            0.0 < v <= 1.0 + 1e-5 for v in norms):
        raise AssertionError(f"11a CLIs: launches {cli_counts}, make_metadata {meta_counts}, {len(entries)} speakers, "
                             f"norms {norms}")
    out.update(cli_launches=cli_counts, cli_s=cli_s, metadata_launches=meta_counts, metadata_s=meta_s)
    out["launches"] = tuple(a + c for a, c in zip(out["launches"], cli_counts))
    return out


def timed_steps(step, batches, label: str) -> dict:
    """VOC_STEPS synchronised train steps (the first a warm-up): the losses,
    p50 and p95 of the rest, and the device busy time and idle share of one
    more warm step (torch.profiler)."""
    times, losses = [], []
    for batch in batches[:VOC_STEPS]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = step(*batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append({k: float(v) for k, v in m.items()} if isinstance(m, dict) else float(m))
    rows, wall_us, _ = device_activity(lambda: step(*batches[VOC_STEPS]))
    busy = sum(t for _, _, t in rows)
    p50, p95 = float(np.percentile(times[1:], 50)), float(np.percentile(times[1:], 95))
    finite = all(np.isfinite(list(v.values()) if isinstance(v, dict) else v).all() for v in losses)
    log(f"11b {label}: step p50 {p50:.2f} ms, p95 {p95:.2f} ms (first {times[0]:.1f}); a warm step's device busy "
        f"{busy / 1e3:.3f} ms of {wall_us / 1e3:.3f} ms wall (idle share {1 - busy / wall_us:.3f}); losses "
        f"{losses[0]} -> {losses[-1]} (card: {card_line()})")
    if not finite:
        raise AssertionError(f"11b {label}: a loss is not finite: {losses}")
    return {"step_ms_p50": p50, "step_ms_p95": p95, "device_ms": busy / 1e3, "idle_share": 1 - busy / wall_us}


def phase_vocoder_training(dev: torch.device, corpus: str, main_dir: str, tmp: str) -> dict:
    """11b: HiFi-GAN V1 reconstruction and GAN steps at the JAX CLI's
    --batch_size 2 --frames 32, WaveNet (the r9y9 widths) at --batch_size 2
    --max_time 8000, on phase 5's (waveform, mel) pairs: step p50 and p95,
    device time and idle share; then ``cli.train_vocoder`` for 3 steps of
    HiFi-GAN, 3 of ``--gan --init`` on it, and 3 of WaveNet, each checkpoint
    finite; returns where they are."""
    from autovc_tpu_torch.cli import train_vocoder
    from autovc_tpu_torch.config import HiFiGANConfig
    from autovc_tpu_torch.vocoder.train_hifigan import HiFiGANGANTrainer, HiFiGANTrainer, hifigan_crop_batch
    from autovc_tpu_torch.vocoder.train_wavenet import WaveNetTrainer, crop_batch

    os.symlink(os.path.join(corpus, "wavs"), os.path.join(tmp, "wavs"))
    os.symlink(os.path.join(main_dir, "spmel"), os.path.join(tmp, "spmel"))
    wavs, mels = train_vocoder.load_corpus(tmp)
    rng = np.random.default_rng(0)
    hg_batches = [hifigan_crop_batch(wavs, mels, VOC_B, VOC_FRAMES, HOP, rng) for _ in range(VOC_STEPS + 1)]
    wn_batches = [crop_batch(wavs, mels, VOC_B, VOC_MAX_TIME, HOP, rng) for _ in range(VOC_STEPS + 1)]
    out = {}
    rec = HiFiGANTrainer(HiFiGANConfig(), device=dev, seed=0)
    out["hifigan"] = timed_steps(rec.step, hg_batches, f"HiFi-GAN reconstruction (B={VOC_B}, {VOC_FRAMES} frames)")
    gan = HiFiGANGANTrainer(HiFiGANConfig(), device=dev, seed=0)
    n_disc = sum(p.numel() for p in gan.disc.parameters())
    out["hifigan_gan"] = timed_steps(gan.gan_step, hg_batches, f"HiFi-GAN GAN step (MPD+MSD, {n_disc} discriminator "
                                                               f"parameters)")
    del gan, rec
    wn = WaveNetTrainer(WaveNetConfig(), device=dev, seed=0)
    out["wavenet"] = timed_steps(wn.step, wn_batches, f"WaveNet (B={VOC_B}, {VOC_MAX_TIME // HOP * HOP} samples)")
    del wn
    ckpts = {k: os.path.join(tmp, f"{k}.npz") for k in ("hifigan", "gan", "wavenet")}
    common = ["--main_dir", tmp, "--num_iters", "3", "--log_step", "1", "--batch_size", str(VOC_B)]
    runs = (("hifigan", ["--vocoder", "hifigan", "--frames", str(VOC_FRAMES)]),
            ("gan", ["--vocoder", "hifigan", "--gan", "--init", ckpts["hifigan"], "--frames", str(VOC_FRAMES)]),
            ("wavenet", ["--vocoder", "wavenet", "--max_time", str(VOC_MAX_TIME)]))
    for name, extra in runs:
        t0 = time.perf_counter()
        train_vocoder.main([*common, *extra, "--out", ckpts[name]])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        with np.load(ckpts[name]) as z:
            finite = all(np.isfinite(z[k]).all() for k in z.files)
            size = sum(z[k].size for k in z.files)
        state = ckpts[name] + ".train_state.npz"
        log(f"11b cli.train_vocoder {' '.join(extra[:3])}: 3 steps in {wall:.2f} s wall, checkpoint of {size} "
            f"parameters (finite {finite}), train state {os.path.exists(state)}")
        if not finite or os.path.exists(state) != (name != "hifigan"):
            raise AssertionError(f"11b cli.train_vocoder {name}: finite {finite}, train state {os.path.exists(state)}")
        out[f"cli_{name}_s"] = wall
        if os.path.exists(state):
            os.remove(state)  # the GAN's holds the discriminators and both Adam states: GBs on disk
    out["ckpts"] = ckpts
    return out


def phase_evaluate_vocoder(dev: torch.device, main_dir: str, tmp: str, ckpts: dict) -> dict:
    """11c: ``cli.evaluate_vocoder`` on EVAL_UTTS utterances of phase 5's
    spmel tree with griffinlim, hifigan and hybrid (11b's GAN checkpoint),
    and wavenet (11b's checkpoint, float32) on the corpus's shortest
    utterance alone; each one's launches from the wrappers' counts (the mel
    re-extracted: one mel_norm and two sosfilt launches an utterance;
    WaveNet: one generation launch) and its JSON line."""
    from autovc_tpu_torch.cli import evaluate_vocoder

    spmel = os.path.join(main_dir, "spmel")
    files = sorted((os.path.join(spmel, s, f) for s in os.listdir(spmel) if os.path.isdir(os.path.join(spmel, s))
                    for f in os.listdir(os.path.join(spmel, s)) if f.endswith(".npy")),
                   key=lambda p: np.load(p, mmap_mode="r").shape[0])
    short = os.path.join(tmp, "shortest", "spk")
    os.makedirs(short)
    shutil.copy(files[0], short)
    frames = np.load(files[0], mmap_mode="r").shape[0]
    out = {}
    for vocoder, args, n in (("griffinlim", ["--spmel_dir", spmel, "--max_utts", str(EVAL_UTTS)], EVAL_UTTS),
                             ("hifigan", ["--spmel_dir", spmel, "--max_utts", str(EVAL_UTTS), "--vocoder_ckpt",
                                          ckpts["gan"]], EVAL_UTTS),
                             ("hybrid", ["--spmel_dir", spmel, "--max_utts", str(EVAL_UTTS), "--vocoder_ckpt",
                                         ckpts["gan"]], EVAL_UTTS),
                             ("wavenet", ["--spmel_dir", os.path.dirname(short), "--vocoder_ckpt", ckpts["wavenet"],
                                          "--max_utts", "1"], 1)):
        torch.cuda.synchronize()
        mel_ops.launches = sosfilt_ops.launches = wavenet_ops.launches = 0
        t0 = time.perf_counter()
        rec = evaluate_vocoder.main(["--vocoder", vocoder, *args])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched = (mel_ops.launches, sosfilt_ops.launches, wavenet_ops.launches)
        want = (n, 2 * n, 1 if vocoder == "wavenet" else 0)
        log(f"11c cli.evaluate_vocoder --vocoder {vocoder}: {wall:.2f} s wall, launches (mel_norm, sosfilt, "
            f"wavenet_gen) {launched}; {json.dumps(rec)}" + (f" ({frames} frames)" if vocoder == "wavenet" else ""))
        if launched != want or rec["utterances"] != n or not np.isfinite(rec["mel_l1_mean"]):
            raise AssertionError(f"11c evaluate_vocoder {vocoder}: launches {launched} (expected {want}), {rec}")
        out[vocoder] = {"wall_s": wall, "launches": launched, **{k: rec[k] for k in ("mel_l1_mean", "mcd_db_mean")}}
    return out


# ------------------------------------------------------ phase 12: serving
# Bundles of the published spmel Generator and HiFi-GAN V1 (serve.py) at
# phase 2's cell (B=32, T=512); the server (cli.serve) on requests of phase
# 9d's utterance lengths. Cut: 32 requests from 8 clients.
SERVE_REQUESTS, SERVE_CLIENTS, SERVE_FRAMES = 32, 8, (228, 484)
SERVE_ARGS = ["--batch_window", "5", "--max_batch", "16", "--bucket", "256", "--warmup", "256,512"]
# a batched response against the same request alone at the bucket's padding
# (tests/test_serve.py's 1e-6): the LSTM plans and cuBLAS's and cuDNN's
# kernels are chosen by the batch, so a row's sums may take another order
SERVE_BATCH_TOL = 1e-6
SERVE_TOL = 5e-4  # the stft and hybrid bundles against the live staging (tests/test_serve.py:132's)
SERVE_BF16_SHARE = 0.5  # the bf16 program from the plain bf16 engine, of the plain engine's distance from f32


def serving_weights(trained: bool) -> tuple[dict, dict]:
    """The JAX-layout trees a bundle takes: phase 2's generator and HiFi-GAN
    (seeded, or the artifacts)."""
    from autovc_tpu_torch.io import conv_state_to_jax, generator_state_to_jax, load_artifact, unflatten_params

    art = ROOT / "artifacts"
    if trained:
        return load_artifact(str(art / "generator_spmel_f16.npz"))[0], load_artifact(str(art / "hifigan.npz"))[0]
    gen = build_generator(ModelConfig(), device="cpu", seed=1)
    voc = HiFiGANVocoder(device="cpu", seed=2)
    return generator_state_to_jax(gen.state_dict()), unflatten_params(conv_state_to_jax(voc.model.state_dict()))


def live_staging(dev: torch.device, cfg: Config, variables: dict, hifigan: dict | None, gl_iters: int | None = None):
    """The live pipeline on the same weights: Converter and HiFiGANVocoder
    (HybridVocoder with gl_iters)."""
    from autovc_tpu_torch.io import generator_state_from_jax, hifigan_state_from_jax
    from autovc_tpu_torch.vocoder import HybridVocoder

    gen = build_generator(cfg.model, device=dev)
    gen.load_state_dict(generator_state_from_jax(variables))
    voc = None
    if hifigan is not None:
        voc = HiFiGANVocoder(device=dev, dtype=BF16 if cfg.model.compute_dtype == "bfloat16" else torch.float32)
        voc.model.load_state_dict(hifigan_state_from_jax(hifigan))
        if gl_iters is not None:
            voc = HybridVocoder(voc, cfg.audio, n_iter=gl_iters)
    return Converter(gen, cfg.model, cfg.audio), voc


def serve_counts() -> tuple[int, int, int]:
    return lstm_ops.launches, lstm_ops.bf16_launches, lstm_ops.scan_launches


def phase_serving_programs(dev: torch.device, trained: bool, tmp: str, variables: dict, hifigan: dict) -> dict:
    """12a: bundles of the spmel Generator in float32 (with the HiFi-GAN
    program), in bfloat16 (the scan rounding, the default; with HiFi-GAN in
    bfloat16) and in the Pallas rounding (converter alone), exported for
    the card and loaded with ServingConverter there: the converter program
    at B=32, T=512 bit for bit against the live Converter, 7 launches of
    its form a call and 7 operator nodes in the graph, and against the
    plain engine on the card (float32 LSTM_TOL; bf16 the relative rule:
    within SERVE_BF16_SHARE of the plain engine's own distance from
    float32); its ms and the vocoder's beside the live pipeline's. Cut: no
    cpu program (a second trace of both programs on the host; the CPU
    tests hold it)."""
    from autovc_tpu_torch.serve import CONVERTER_NAME, ServingConverter, export_converter

    rng = np.random.RandomState(12)
    x = rng.rand(B, T, N_MELS).astype(np.float32)
    emb = rng.randn(2, 256).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    eo, et = np.tile(emb[0], (B, 1)), np.tile(emb[1], (B, 1))
    card = (dev.type,)
    forms = {"f32": (ModelConfig(), card, True, 0),
             "bf16": (ModelConfig(compute_dtype="bfloat16"), card, True, 2),
             "bf16_pallas": (ModelConfig(compute_dtype="bfloat16", use_pallas_lstm=True), card, False, 1)}
    out, served = {}, {}
    for name, (mcfg, platforms, with_voc, counter) in forms.items():
        cfg = Config(model=mcfg)
        t0 = time.perf_counter()
        bundle = export_converter(variables, cfg, os.path.join(tmp, name), hifigan_params=hifigan if with_voc else None,
                                  platforms=platforms)
        export_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        srv = ServingConverter(bundle, device=dev)
        load_s = time.perf_counter() - t0
        program = torch.export.load(os.path.join(bundle, CONVERTER_NAME.format(platform=dev.type)))
        nodes = sum(n.target == torch.ops.autovc.lstm_sequence.default for n in program.graph.nodes)
        converter, voc = live_staging(dev, cfg, variables, hifigan if with_voc else None)
        torch.cuda.synchronize()
        zero_counts()
        got = srv(x, eo, et)
        torch.cuda.synchronize()
        launched = serve_counts()
        want = converter._forward(x, eo, et)
        bits = bool(torch.equal(got, want))
        apart = float((got - want).abs().max())
        if launched[0] != 7 or launched[counter] != 7 or sum(launched[1:]) != (7 if counter else 0) or nodes != 7:
            raise AssertionError(f"12a {name}: launches (all, bf16, scan) {launched}, {nodes} operator nodes")
        with plain_recurrence():
            plain = converter._forward(x, eo, et)
        rec = {"export_s": export_s, "load_s": load_s, "launches": launched[counter], "nodes": nodes,
               "bit_equal_live": bits, "live_max_abs": apart,
               "plain_max_abs": float((got - plain).abs().max()), "plain_mean_abs": float((got - plain).abs().mean())}
        if name == "f32":
            held = rec["plain_max_abs"] <= LSTM_TOL
        else:
            rec["plain_f32_mean_abs"] = float((plain - served["f32"]).abs().mean())
            held = rec["plain_mean_abs"] <= SERVE_BF16_SHARE * rec["plain_f32_mean_abs"]
        with torch.inference_mode():
            rec["ms"] = cuda_ms(lambda: srv(x, eo, et), reps=3)
            rec["live_ms"] = cuda_ms(lambda: converter._forward(x, eo, et), reps=3)
            if with_voc:
                mels = got.clone()
                rec["vocoder_ms"] = cuda_ms(lambda: srv.vocode(mels), reps=3)
                rec["live_vocoder_ms"] = cuda_ms(lambda: voc.generate(mels), reps=3)
                wav = srv.vocode(mels)
                rec["vocoder_bit_equal_live"] = bool(torch.equal(wav, voc.generate(mels)))
                finite = bool(torch.isfinite(wav).all())
                if wav.shape != (B, T * HOP) or not finite:
                    raise AssertionError(f"12a {name}: waveform {tuple(wav.shape)} finite={finite}")
        log(f"12a serving {name}: export {export_s:.1f} s ({'+'.join(platforms)}), load {load_s:.1f} s; "
            f"converter at B={B}, T={T}: launches {launched} (all, bf16, scan), {nodes} operator nodes; bit-equal "
            f"to the live Converter {bits} (max abs {apart:.3e}); from the plain engine on the card max "
            f"{rec['plain_max_abs']:.3e}, mean {rec['plain_mean_abs']:.3e}"
            + (f" (the plain engine's mean from f32 {rec['plain_f32_mean_abs']:.3e})" if name != "f32" else "")
            + f"; converter {rec['ms']:.2f} ms a call, live {rec['live_ms']:.2f}"
            + (f"; vocoder {rec['vocoder_ms']:.2f} ms, live {rec['live_vocoder_ms']:.2f}, bit-equal "
               f"{rec['vocoder_bit_equal_live']}" if with_voc else "") + f" (card: {card_line()})")
        if not bits or not held or (with_voc and not rec["vocoder_bit_equal_live"]):
            raise AssertionError(f"12a {name}: served against live / plain: {rec}")
        if name == "f32":
            out["srv"] = srv
        served[name] = got
        out[name] = rec
    return out


def phase_serving_variants(dev: torch.device, tmp: str, variables: dict, hifigan: dict) -> dict:
    """12b: an stft bundle (a seeded 513-bin Generator, the mel projection in
    the vocoder program) and a hybrid bundle (gl_iters=2), each converting
    one utterance on the card: shape, finite, and within SERVE_TOL of the
    live staging (Converter, its mel projection and HiFiGANVocoder /
    HybridVocoder)."""
    from autovc_tpu_torch.io import generator_state_to_jax
    from autovc_tpu_torch.serve import ServingConverter, export_converter

    rng = np.random.RandomState(13)
    out = {}
    for name, mcfg, gl_iters in (("stft", ModelConfig(model_type="stft"), None), ("hybrid", ModelConfig(), 2)):
        cfg = Config(model=mcfg)
        v = variables if name == "hybrid" else generator_state_to_jax(
            build_generator(mcfg, device="cpu", seed=3).state_dict())
        t0 = time.perf_counter()
        srv = ServingConverter(export_converter(v, cfg, os.path.join(tmp, name), hifigan_params=hifigan,
                                                platforms=(dev.type,), gl_iters=gl_iters), device=dev)
        setup_s = time.perf_counter() - t0
        frames = 300
        feats = rng.rand(frames, mcfg.n_bins).astype(np.float32)
        e = rng.randn(2, 256).astype(np.float32)
        e /= np.linalg.norm(e, axis=1, keepdims=True)
        converter, voc = live_staging(dev, cfg, v, hifigan, gl_iters)
        zero_counts()
        wav = srv.convert(feats, e[0], e[1])
        torch.cuda.synchronize()
        launched = serve_counts()
        mel = converter.convert_to_mel(types.SimpleNamespace(src_features=feats, src_embedding=e[0],
                                                             trg_embedding=e[1]))
        want = voc.generate(mel).cpu().numpy()
        apart = float(np.abs(wav - want).max())
        log(f"12b serving {name}: export + load {setup_s:.1f} s; one utterance of {frames} frames -> {wav.shape}, "
            f"launches (all, bf16, scan) {launched}; from the live staging max abs {apart:.3e} (peak "
            f"{np.abs(want).max():.3f})")
        if (wav.shape != (frames * HOP,) or not np.isfinite(wav).all() or launched != (7, 0, 0)
                or not apart <= SERVE_TOL):
            raise AssertionError(f"12b {name}: {wav.shape}, finite {np.isfinite(wav).all()}, launches {launched}, "
                                 f"{apart} from the live staging")
        out[name] = {"setup_s": setup_s, "live_max_abs": apart, "launches": launched[0]}
    return out


def phase_serving_http(dev: torch.device, srv, bundle: str) -> dict:
    """12c: cli.serve's server (its parser and make_server: the bundle
    loaded on the card, --batch_window 5 --max_batch 16 --bucket 256) on
    127.0.0.1 at an ephemeral port, in a thread; SERVE_REQUESTS requests of
    SERVE_FRAMES frames from SERVE_CLIENTS client threads, each response
    held against a solo ServingConverter call at the same bucket padding
    (SERVE_BATCH_TOL); requests/s, p50/p95 latency, /stats' mean batch; then
    one request to the same bundle without batching (cli.serve's solo
    handler) and a malformed one, which gets 400."""
    import io as _io
    import threading
    import urllib.error
    import urllib.request
    from concurrent.futures import ThreadPoolExecutor
    from http.server import ThreadingHTTPServer

    from autovc_tpu_torch.cli import serve as cli_serve
    from autovc_tpu_torch.convert import bucket_length

    args = cli_serve.build_parser().parse_args(["--bundle", bundle, "--port", "0", "--device", dev.type, *SERVE_ARGS])
    httpd, server_srv, batcher = cli_serve.make_server(args)
    solo = ThreadingHTTPServer(("127.0.0.1", 0), cli_serve.make_handler(server_srv, threading.Lock()))
    threads = [threading.Thread(target=h.serve_forever, daemon=True) for h in (httpd, solo)]
    for th in threads:
        th.start()
    url, solo_url = (f"http://127.0.0.1:{h.server_address[1]}" for h in (httpd, solo))
    rng = np.random.RandomState(14)
    reqs = []
    for _ in range(SERVE_REQUESTS):
        t = int(rng.randint(SERVE_FRAMES[0], SERVE_FRAMES[1] + 1))
        e = rng.randn(2, 256).astype(np.float32)
        reqs.append((rng.rand(t, N_MELS).astype(np.float32), *(e / np.linalg.norm(e, axis=1, keepdims=True))))

    def post(base, req, **bad):
        buf = _io.BytesIO()
        np.savez(buf, **{"features": req[0], "emb_org": req[1], "emb_trg": req[2], **bad})
        t0 = time.perf_counter()
        body = urllib.request.urlopen(base + "/convert", data=buf.getvalue(), timeout=120).read()
        return np.load(_io.BytesIO(body)), time.perf_counter() - t0

    try:
        zero_counts()
        t0 = time.perf_counter()
        with ThreadPoolExecutor(SERVE_CLIENTS) as pool:
            results = list(pool.map(lambda r: post(url, r), reqs))
        wall = time.perf_counter() - t0
        launched = serve_counts()
        stats = json.loads(urllib.request.urlopen(url + "/stats", timeout=60).read())
        lat = np.array([s for _, s in results]) * 1e3
        worst = 0.0
        for (feats, eo, et), (got, _) in zip(reqs, results):
            tb = bucket_length(feats.shape[0], srv.manifest["freq"], 256)
            row = srv(np.pad(feats, ((0, tb - feats.shape[0]), (0, 0)))[None], eo[None], et[None])[0, : feats.shape[0]]
            want = srv.vocode(row[None])[0].cpu().numpy()
            worst = max(worst, float(np.abs(got - want).max()))
        solo_out, solo_s = post(solo_url, reqs[0])
        solo_apart = float(np.abs(solo_out - srv.convert(*reqs[0])).max())
        try:
            post(url, reqs[0], features=np.zeros((4, 3), np.float32))
            bad = None
        except urllib.error.HTTPError as exc:
            bad = exc.code
        healthy = urllib.request.urlopen(url + "/healthz", timeout=60).read() == b"ok"
    finally:
        for h in (httpd, solo):
            h.shutdown()
            h.server_close()
        batcher.close()
        for th in threads:
            th.join(timeout=30)
    rec = {"requests": SERVE_REQUESTS, "clients": SERVE_CLIENTS, "wall_s": wall,
           "requests_per_s": SERVE_REQUESTS / wall,
           "p50_ms": float(np.percentile(lat, 50)), "p95_ms": float(np.percentile(lat, 95)),
           "mean_batch": stats["mean_batch"], "program_calls": stats["program_calls"], "launches": launched[0],
           "max_abs_from_solo": worst, "solo_ms": solo_s * 1e3, "solo_max_abs": solo_apart, "malformed_status": bad}
    log(f"12c cli.serve ({' '.join(SERVE_ARGS)}): {SERVE_REQUESTS} requests of {SERVE_FRAMES[0]}-{SERVE_FRAMES[1]} "
        f"frames from {SERVE_CLIENTS} clients in {wall:.2f} s: {rec['requests_per_s']:.1f} requests/s, latency p50 "
        f"{rec['p50_ms']:.1f} ms, p95 {rec['p95_ms']:.1f} ms; /stats {json.dumps(stats)}; lstm launches "
        f"{launched} (all, bf16, scan); each response from its solo call at the bucket's padding max abs {worst:.3e}; "
        f"a request without batching {rec['solo_ms']:.1f} ms (max abs {solo_apart:.3e}); malformed -> {bad} "
        f"(card: {card_line()})")
    if (not worst <= SERVE_BATCH_TOL or solo_apart != 0.0 or bad != 400 or not healthy
            or stats["requests"] != SERVE_REQUESTS or launched[0] != 7 * stats["program_calls"]):
        raise AssertionError(f"12c: {rec}, /stats {stats}, healthy {healthy}")
    return rec


def phase_serving(dev: torch.device, trained: bool, after_programs=lambda: None, before_http=lambda: None) -> dict:
    """Phase 12: the serving path (12a-c), its bundles in a temp dir;
    ``after_programs()`` between 12a's timed programs and 12b,
    ``before_http()`` between 12b and 12c."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_serving_")
    try:
        variables, hifigan = serving_weights(trained)
        programs = phase_serving_programs(dev, trained, tmp, variables, hifigan)
        srv = programs.pop("srv")
        after_programs()
        variants = phase_serving_variants(dev, tmp, variables, hifigan)
        before_http()
        http = phase_serving_http(dev, srv, os.path.join(tmp, "f32"))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if os.path.exists(tmp):
        raise AssertionError(f"{tmp} was not removed")
    return {"programs": programs, "variants": variants, "http": http,
            "f32_launches": programs["f32"]["launches"] + sum(v["launches"] for v in variants.values())
            + http["launches"]}


# ---------------------------------------------------------------- phase 13
# parallelism on torch.distributed with ranks that share the one card:
# sequence-parallel conversion (13a) and multi-process training (13b)
SP_B, SP_T, SP_REPS = 2, 4096, 3  # 13a: utterances of 4096 frames
SP_TOLS = (2e-4, 2e-3, 2e-5)  # x_identic, x_psnt, codes: tests/test_parallel.py:127-129
SP_CLI_TOL = 2e-3  # cli.convert --seq_devices 2 against the dense Generator, and the CLI where both pad alike
MH_B, MH_STEPS = 4, 3  # 13b: cli.train --multihost, the global batch, at TRAIN_T frames
MH_PARAMS_TOL, MH_STATS_TOL = 1e-3, 2e-2  # tests/test_multihost.py's ceilings of the exported trees
# train.compare.history_gap's ceiling (relative) of the first step's metrics:
# the loss terms and grad_norm, the norm of the gradient averaged over
# 'data'. Ranks at B=2 round otherwise than one process at B=4, and without
# a KinkTape an element that falls on the other side of a kink moves
# grad_norm: a sound data-parallel run read 6.3e-5 on an H100, the planted
# fault (gradients not averaged) 1.7-1.9. The second step's loss terms are
# printed, not held: Adam's first update turns rounding in near-zero
# gradients into steps of 2 lr (1.2e-4 there in a sound run);
# tests/test_torch_dist_train.py holds them on the CPU at narrow widths
MH_STEP_TOL = 1e-3
MH_THREADS = 2  # host threads a process of 13b (six at once, on the card machine's cores)
# cli.train in a child process, started during phase 12: its imports and the
# card's context made, it touches MH_READY and waits for the file MH_GO names
# ("go": train, then print its LSTM launches a rank (forward, backward, dW)
# and its memory: allocated after the last step, the peak, the parameters it
# holds between steps; "stop", or its parent gone: leave). MH_FAULT=local_grads
# plants the fault 13b's gate must catch: each rank keeps its own gradient
# where the all-reduce over 'data' averaged them.
MH_STUB = ("import json, os, sys, time\nimport torch\ntorch.cuda.init()\n"
           "from autovc_tpu_torch.cli import train\nfrom autovc_tpu_torch.ops import lstm\n"
           "from autovc_tpu_torch.train import Solver, step\n"
           "if os.environ.get('MH_FAULT') == 'local_grads':\n"
           "    step._unflatten_dense_tensors = lambda flat, grads: grads\n"
           "mem, fit = {}, Solver.train\n"
           "def held(self, *args, **kwargs):\n    out = fit(self, *args, **kwargs)\n    torch.cuda.synchronize()\n"
           "    mem.update(held=torch.cuda.memory_allocated(), peak=torch.cuda.max_memory_allocated(),\n"
           "               params=sum(p.numel() * p.element_size() for p in self.state.model.parameters()))\n"
           "    return out\n"
           "Solver.train = held\nopen(os.environ['MH_READY'], 'w').close()\nparent = os.getppid()\n"
           "while not os.path.exists(os.environ['MH_GO']):\n"
           "    if os.getppid() != parent:\n        sys.exit(0)\n"
           "    time.sleep(0.05)\n"
           "if open(os.environ['MH_GO']).read() == 'go':\n    train.main(sys.argv[1:])\n"
           "    launched = [lstm.launches, lstm.bwd_launches, lstm.dw_launches]\n"
           "    print('LSTM_LAUNCHES ' + json.dumps(launched), flush=True)\n"
           "    print('MEMORY ' + json.dumps(mem), flush=True)")
MH_RUNS = {"data_parallel_2": [], "model_parallel_2": ["--model_parallel", "2"], "local_grads": ["--num_iters", "1"]}


@contextlib.contextmanager
def dist_backend(name: str | None):
    """AUTOVC_DIST_BACKEND set to ``name`` (None: unset) for the duration."""
    old = os.environ.pop("AUTOVC_DIST_BACKEND", None)
    if name:
        os.environ["AUTOVC_DIST_BACKEND"] = name
    try:
        yield
    finally:
        os.environ.pop("AUTOVC_DIST_BACKEND", None)
        if old is not None:
            os.environ["AUTOVC_DIST_BACKEND"] = old


def background(fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` in a daemon thread -> a function that joins it
    and returns its result or raises its exception."""
    box: dict = {}

    def run() -> None:
        try:
            box["result"] = fn(*args, **kwargs)
        except BaseException as exc:  # re-raised by join on the main thread
            box["error"] = exc

    thread = threading.Thread(target=run, daemon=True)
    thread.start()

    def join():
        thread.join()
        if "error" in box:
            raise box["error"]
        return box["result"]

    return join


def signal_ranks(path: str, word: str) -> None:
    """Tell the ranks waiting on ``path`` to go on ("go") or to leave ("stop")."""
    if not os.path.exists(path):
        with open(path + ".tmp", "w") as f:
            f.write(word)
        os.replace(path + ".tmp", path)


def mh_cmd(main_dir: str, name: str, export: str, *extra: str) -> list[str]:
    """cli.train for MH_STEPS steps exporting to ``export``, every step's
    metrics logged, no checkpoint (the multi-process save and restore:
    tests/test_torch_dist_train.py)."""
    return [sys.executable, "-c", MH_STUB, "--main_dir", main_dir, "--run_name", name, "--resume", "--batch_size",
            str(MH_B), "--len_crop", str(TRAIN_T), "--num_iters", str(MH_STEPS), "--log_step", "1",
            "--checkpoint_step", str(10 * MH_STEPS), "--export", export, *extra]


def prestart_parallel(dev: torch.device, main_dir: str, pre: dict) -> None:
    """Phase 13's processes, started after 12a's timed programs (their start
    beside 12b's exports; 12c waits until they are ready); each waits, idle,
    for its go-file: 13a's gloo world of 2 (each
    rank, its model on the card, touches ``go_sp.ready<rank>`` and waits for
    ``go_sp``) and 13b's six cli.train processes on phase 5's corpus under
    ``main_dir`` (each touches its ready file and waits for ``go_mh``); each
    recorded in ``pre`` as it starts. A waiting process leaves when this one
    is gone. Ranks that share the card run gloo: AUTOVC_DIST_BACKEND stays
    set until ``stop_parallel`` (nothing else in phase 12 reads it)."""
    from autovc_tpu_torch.parallel.launch import run_world

    tmp = tempfile.mkdtemp(prefix="chip_smoke_parallel_")
    pre.update(tmp=tmp, go_sp=os.path.join(tmp, "go_sp"), go_mh=os.path.join(tmp, "go_mh"), runs={},
               backend=os.environ.get("AUTOVC_DIST_BACKEND"), started=time.perf_counter())
    os.environ["AUTOVC_DIST_BACKEND"] = "gloo"
    gen = build_generator(ModelConfig(), device=dev, seed=13)
    pre["gen"] = gen
    pre["state"] = state = {k: v.detach().cpu() for k, v in gen.state_dict().items()}
    rng = np.random.RandomState(130)
    pre["x"] = rng.rand(SP_B, SP_T, N_MELS).astype(np.float32)
    pre["c_org"], pre["c_trg"] = (rng.randn(SP_B, 256).astype(np.float32) for _ in range(2))
    pre["sp_world"] = background(run_world, parallel_ranks.sp_rank, 2, state, pre["x"], pre["c_org"], pre["c_trg"],
                                 SP_REPS, pre["go_sp"], device="cuda", threads=MH_THREADS)
    pre["ready"] = [f"{pre['go_sp']}.ready{r}" for r in range(2)]
    for label, extra in MH_RUNS.items():
        env = dict(os.environ, AUTOVC_COORDINATOR=f"localhost:{socket_port()}", AUTOVC_NUM_PROCESSES="2",
                   MH_GO=pre["go_mh"], OMP_NUM_THREADS=str(MH_THREADS))
        if label == "local_grads":
            env["MH_FAULT"] = label
        export = os.path.join(tmp, f"mh_{label}.npz")
        ready = [os.path.join(tmp, f"mh_{label}.ready{r}") for r in range(2)]
        procs = [subprocess.Popen(mh_cmd(main_dir, f"mh_{label}", export, "--multihost", *extra), cwd=str(ROOT),
                                  env=dict(env, AUTOVC_PROCESS_ID=str(r), MH_READY=ready[r]), stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True) for r in range(2)]
        pre["ready"] += ready
        pre["runs"][label] = [extra, export, procs, None]
    log("phase 13's processes started (13a's world of 2, 13b's six cli.train ranks): they wait for their go-files")


def wait_ready(pre: dict, timeout: float = 180.0) -> float:
    """Wait until every process ``prestart_parallel`` started has its model
    or its context on the card -> seconds since they were started."""
    t0 = time.perf_counter()
    while not all(os.path.exists(p) for p in pre["ready"]):
        dead = [p.returncode for _, _, procs, _ in pre["runs"].values() for p in procs if p.poll() is not None]
        if dead or time.perf_counter() - t0 > timeout:
            raise AssertionError(f"phase 13: processes not ready ({[p for p in pre['ready'] if not os.path.exists(p)]}"
                                 f"; exit codes of those that left: {dead})")
        time.sleep(0.05)
    return time.perf_counter() - pre["started"]


def stop_parallel(pre: dict) -> None:
    """Let phase 13's processes leave (a stop where they were not let go),
    kill what is left, remove the temp dir, restore AUTOVC_DIST_BACKEND."""
    for key in ("go_sp", "go_mh"):
        signal_ranks(pre[key], "stop")
    for _, _, procs, _ in pre["runs"].values():
        for p in procs:
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
    try:
        if "sp_world" in pre:
            pre["sp_world"]()
    except Exception:  # already reported where it was joined, or moot after an earlier failure
        pass
    shutil.rmtree(pre["tmp"], ignore_errors=True)
    os.environ.pop("AUTOVC_DIST_BACKEND", None)
    if pre["backend"] is not None:
        os.environ["AUTOVC_DIST_BACKEND"] = pre["backend"]


def phase_sequence_parallel(dev: torch.device, main_dir: str, pre: dict) -> dict:
    """13a: SPGenerator on B=2 utterances of T=4096 frames over 2 ranks on
    the card under gloo (the world ``prestart_parallel`` started, let go
    now; every phase-13 process idle) and over 1 rank under NCCL (this
    process), each against the single-process Generator forward on the
    card (codes 2e-5, x_identic 2e-4, x_psnt 2e-3), 7 forward launches a
    rank, every block after a direction's first run from a received (h, c);
    the SP forward's ms beside the dense forward's. Then 13b's ranks let go,
    and beside their training ``cli.convert --seq_devices 2`` and the same
    CLI without it on phase 5's conversions and one more, the first's
    source cut to a length whose paddings differ, each held to the dense
    Generator."""
    from autovc_tpu_torch.data.manifest import save_conversion_metadata
    from autovc_tpu_torch.io import save_generator_artifact
    from autovc_tpu_torch.parallel.mesh import init_process_group

    gen, state, x, c_org, c_trg, tmp = (pre[k] for k in ("gen", "state", "x", "c_org", "c_trg", "tmp"))
    out = {"start_s": wait_ready(pre)}
    args = [torch.from_numpy(a).to(dev) for a in (x, c_org, c_trg)]
    with torch.inference_mode(), exact_f32(dev):
        want = [o.cpu().numpy() for o in gen(*args)]
        dense_ms = cuda_ms(lambda: gen(*args), SP_REPS)
    out.update(dense_ms=dense_ms, worlds={})
    for world, backend in ((2, "gloo"), (1, "nccl")):
        t0 = time.perf_counter()
        if world == 1:  # this process as the one rank: no process to start
            with dist_backend(None):
                init_process_group(f"file://{os.path.join(tmp, 'store')}", 1, 0, "cuda")
            try:
                ranks = [parallel_ranks.sp_rank(dev, state, x, c_org, c_trg, SP_REPS)]
            finally:
                torch.distributed.destroy_process_group()
        else:
            signal_ranks(pre["go_sp"], "go")
            ranks = pre["sp_world"]()
        wall = time.perf_counter() - t0
        worst = [float(np.abs(g - w).max()) for g, w in zip(ranks[0]["outs"], want)]
        rec = {"backend": backend, "ranks": world, "wall_s": wall, "sp_ms": ranks[0]["ms"],
               "launches": [r["launches"] for r in ranks], "relays": [r["relays"] for r in ranks],
               "max_abs": dict(zip(("x_identic", "x_psnt", "codes"), worst))}
        out["worlds"][f"{backend}_{world}"] = rec
        log(f"13a SPGenerator B={SP_B}, T={SP_T} over {world} rank(s) ({backend}, {[r['device'] for r in ranks]}): "
            f"{rec['sp_ms']:.1f} ms a forward beside the dense forward's {dense_ms:.1f} ms (card: {card_line()}); "
            f"lstm_fwd launches a rank {rec['launches']}, blocks run from a received (h, c) {rec['relays']}; "
            f"max abs from the dense forward {rec['max_abs']} ({wall:.1f} s wall from the go signal)")
        if (any(not w <= tol for w, tol in zip(worst, SP_TOLS)) or rec["launches"] != [7] * world
                or sum(rec["relays"]) != 7 * (world - 1)):
            raise AssertionError(f"13a: {rec}")
    signal_ranks(pre["go_mh"], "go")  # 13b trains from here, beside the CLIs
    for run in pre["runs"].values():
        run[3] = time.perf_counter()
    # the CLIs' corpus: phase 5's conversions and the first's source cut to
    # a length whose ceil(t / 32) is odd (the two paddings differ)
    specs = load_conversion_metadata(os.path.join(main_dir, "spmel", "metadata.pkl"))
    n = -(-specs[0].src_features.shape[0] // 32)
    specs.append(dataclasses.replace(specs[0], conversion_id=max(s.conversion_id for s in specs) + 1,
                                     src_features=specs[0].src_features[:32 * (n - 1 + n % 2) - 5]))
    cli_dir = os.path.join(tmp, "cli")
    os.makedirs(os.path.join(cli_dir, "spmel"))
    save_conversion_metadata(os.path.join(cli_dir, "spmel", "metadata.pkl"), specs)
    art = os.path.join(tmp, "sp_generator.npz")
    save_generator_artifact(gen.state_dict(), 0, art)
    results = {}
    for devices in (2, 0):
        t0 = time.perf_counter()
        results[devices] = cli_convert.main(["--main_dir", cli_dir, "--artifact", art, "--seq_devices", str(devices),
                                             "--out", os.path.join(tmp, f"sp_{devices}.pkl")])
        out[f"cli_seq_{devices}_s"] = time.perf_counter() - t0
    # --seq_devices 2 pads an utterance to a multiple of 2 * freq, the CLI
    # without it to a multiple of freq (as the JAX CLI's two paths): where the
    # paddings differ, the backward LSTM and the last convolutions see other
    # frames. Each result is held to the dense Generator at its own padding;
    # against the CLI without it where the two paddings agree.
    same_pad, at_pad, apart = [], [], []
    for spec, (_, sp_mel), (_, mel) in zip(specs, results[2], results[0]):
        t = spec.src_features.shape[0]
        padded = np.zeros((1, -(-t // 64) * 64, N_MELS), np.float32)
        padded[0, :t] = spec.src_features
        with torch.inference_mode(), exact_f32(dev):
            dense = gen(*(torch.from_numpy(a).to(dev) for a in (padded, spec.src_embedding[None],
                                                              spec.trg_embedding[None])))[1][0, :t].cpu().numpy()
        at_pad.append(float(np.abs(sp_mel - dense).max()))
        apart.append(float(np.abs(sp_mel - mel).max()))
        same_pad.append(-(-t // 32) == -(-t // 64) * 2)
    out.update(cli_max_abs_at_its_padding=max(at_pad), cli_max_abs_same_padding=max(
        [a for a, same in zip(apart, same_pad) if same], default=None), cli_max_abs_other_padding=max(
        [a for a, same in zip(apart, same_pad) if not same], default=None), cli_conversions=len(specs))
    log(f"13a cli.convert --seq_devices 2 (two ranks on the card, gloo, beside 13b's training): "
        f"{len(specs)} conversions in {out['cli_seq_2_s']:.1f} s (its ranks' start included); without it "
        f"{out['cli_seq_0_s']:.1f} s; from the dense Generator at the same padding (a multiple of 64 frames) max abs "
        f"{max(at_pad):.3e}; from the CLI without it {out['cli_max_abs_same_padding']} where both pad alike "
        f"({sum(same_pad)} of {len(specs)}), {out['cli_max_abs_other_padding']} where they do not (the padded "
        f"frames' context)")
    if ([k for k, _ in results[2]] != [k for k, _ in results[0]] or all(same_pad) or not max(at_pad) <= SP_CLI_TOL
            or not all(a <= SP_CLI_TOL for a, same in zip(apart, same_pad) if same)):
        raise AssertionError(f"13a cli.convert --seq_devices 2: {out}")
    return out


def finish_multihost(main_dir: str, pre: dict) -> dict:
    """13b: cli.train's single-process run of the same 3 steps (B=4 global,
    len_crop 128, on phase 5's corpus), then each multihost run held
    against it: both ranks' first step (``compare.history_gap``: the loss
    terms and grad_norm) within MH_STEP_TOL, rank 0's --export within
    tests/test_multihost.py's ceilings (params 1e-3, batch_stats 2e-2); the
    planted fault (local gradients, one step) must fail the step gate. Each
    run's wall time from its go signal, the second step's loss terms' gap,
    LSTM launches a rank and memory a rank."""
    from autovc_tpu_torch.io import flatten_params, load_artifact
    from autovc_tpu_torch.train.compare import history_gap
    from autovc_tpu_torch.train.metrics import read_metrics

    def steps(run: str, rank: int) -> list[dict]:
        return read_metrics(os.path.join(main_dir, "runs", run, f"metrics_{run}{f'.rank{rank}' if rank else ''}.jsonl"))

    solo = os.path.join(pre["tmp"], "mh_solo.npz")
    zero_counts()
    t0 = time.perf_counter()
    cli_train.main(mh_cmd(main_dir, "mh_solo", solo)[3:])
    torch.cuda.synchronize()
    out = {"solo": {"wall_s": time.perf_counter() - t0,
                    "launches": [lstm_ops.launches, lstm_ops.bwd_launches, lstm_ops.dw_launches]}}
    want, want_steps = flatten_params(load_artifact(solo)[0]), steps("mh_solo", 0)
    expect = [MH_STEPS * SEQS_PER_STEP] * 3
    for label, (extra, export, procs, t0) in pre["runs"].items():
        logs = [p.communicate(timeout=240)[0] for p in procs]
        wall = time.perf_counter() - t0
        for p, text in zip(procs, logs):
            if p.returncode != 0:
                raise AssertionError(f"13b {label}: a rank exited {p.returncode}:\n{text[-3000:]}")
        launched, memory = ([json.loads(next(ln for ln in text.splitlines() if ln.startswith(key))[len(key) + 1:])
                             for text in logs] for key in ("LSTM_LAUNCHES", "MEMORY"))
        got = flatten_params(load_artifact(export)[0])
        (worst_p, leaf_p), (worst_s, leaf_s) = (max((float(np.abs(got[k] - want[k]).max()), k) for k in got
                                                    if k.startswith(tree)) for tree in ("params/", "batch_stats/"))
        got_steps = [steps(f"mh_{label}", r) for r in range(2)]
        step_gap = [history_gap(g, want_steps) for g in got_steps]
        second = [history_gap(g, want_steps, step=2) if len(g) > 1 else None for g in got_steps]
        rec = {"wall_s": wall, "launches_per_rank": launched, "params_max_abs": worst_p, "params_leaf": leaf_p,
               "stats_max_abs": worst_s, "stats_leaf": leaf_s, "stats_leaf_peak": float(np.abs(want[leaf_s]).max()),
               "step_gap": step_gap, "second_step_gap": second, "memory_per_rank": memory,
               "data_parallel_line": f"data_parallel -> {1 if '--model_parallel' in extra else 2}" in logs[0]}
        out[label] = rec
        mib = [{k: round(v / 2**20, 1) for k, v in m.items()} for m in memory]
        log(f"13b cli.train --multihost {' '.join(extra) or '(data_parallel 2)'}"
            f"{' (data_parallel 2) with the planted fault (local gradients)' if label == 'local_grads' else ''}: 2 "
            f"ranks on the card (gloo; the other runs' 4 at the same time), B={MH_B} global, in {wall:.1f} s wall from "
            f"the go signal (the single process {out['solo']['wall_s']:.1f} s); LSTM launches a rank (fwd, bwd, dW) "
            f"{launched}; from the single process (relative): step 1 {step_gap}, step 2's loss terms {second}; "
            f"export params {worst_p:.3e} ({leaf_p}), batch_stats {worst_s:.3e} ({leaf_s}, whose peak is "
            f"{rec['stats_leaf_peak']:.3f}); MiB a rank (after the last step, peak, parameters held) {mib} "
            f"(card: {card_line()})")
        if label == "local_grads":
            if not max(g for g, _ in step_gap) >= MH_STEP_TOL:
                raise AssertionError(f"13b: the planted fault passed the step gate: {rec}")
            continue
        if (got.keys() != want.keys() or not worst_p < MH_PARAMS_TOL or not worst_s < MH_STATS_TOL
                or not max(g for g, _ in step_gap) < MH_STEP_TOL or launched != [expect] * 2
                or not rec["data_parallel_line"] or out["solo"]["launches"] != expect):
            raise AssertionError(f"13b {label}: {rec}, solo {out['solo']}, expected launches {expect}")
    return out


def socket_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def phase_parallel(dev: torch.device, main_dir: str, pre: dict) -> dict:
    """Phase 13 on the processes ``prestart_parallel`` started: 13a, then
    13b's checks; ``stop_parallel`` cleans up after it."""
    return {"sp": phase_sequence_parallel(dev, main_dir, pre), "multihost": finish_multihost(main_dir, pre)}


def variant_launches(var: dict, counter: str) -> dict[str, int]:
    """Phase 9's launches of one wrapper (an LSTM_COUNTERS name, mel_norm or
    sosfilt) by sub-path."""
    i = VAR_COUNTERS.index(counter)
    return {path: launched[i] for path, launched in var["paths"].items()}


def scan_entries(fwd: dict, bwd: dict, by_path: dict[str, tuple[int, int]], spk: dict, generator: dict,
                 more_shapes: dict, bwd_train: dict) -> list[dict]:
    """The scan forms' lines of the kernels JSON: launches on each main path
    (``by_path``: forward, backward; 8c's ``cli.train --bf16 --lambda_spk``,
    10a's bench program, 10b's Solver steps and ``cli.train --bf16``), the
    times a sequence at the lambda_spk step's d-vector shape (H=768, B=7,
    T=128), every shape of 8d beside them, 8e's step; 10a's Generator
    shapes beside the forward's, and ``more_shapes`` (10b's training form,
    11a's GE2E batch); 10b's training shapes beside the backward's
    (``bwd_train``: a sequence and a train step)."""
    entries = []
    for i, (name, rec, source) in enumerate((("lstm_scan_fwd", fwd, "lstm_scan_fwd.cu"),
                                             ("lstm_scan_bwd", bwd, "lstm_scan_bwd.cu"))):
        head = next(r for r in rec["shapes"] if (r["hidden"], r["batch"]) == (768, TRAIN_B))
        entries.append({
            "name": name, "route": "cuda", "source": f"autovc_tpu_torch/ops/csrc/{source}",
            "replaces": "autovc_tpu/models/layers.py:123 (_lstm_scan, the lax.scan JAX's DVector runs in bfloat16, "
                        "and its Generator in bfloat16 by default; no Pallas kernel)",
            "launches": sum(n[i] for n in by_path.values()),
            "launches_by_path": {path: n[i] for path, n in by_path.items()},
            "max_abs_err": max(rec["max_abs_err"], generator["max_abs_err"] if i == 0 else 0.0),
            "ms": head["device_ms"], "events_ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"], "library_ms": head["library_ms"],
            "shapes": rec["shapes"], "bf16_spk_step": spk,
            **({"generator": generator, **more_shapes} if i == 0 else {"train_b7": bwd_train})})
    return entries


def main(argv: list[str] | None = None) -> int:
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    started = time.perf_counter()
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--trained", action="store_true", help="load the committed artifacts instead of seeded weights")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    corpus = tempfile.mkdtemp(prefix="chip_smoke_features_")
    main_dir = os.path.join(corpus, "card")  # phase 5's corpus (phase_features writes it)
    pre: dict = {}
    try:
        finish_build = phase_build()
        record = phase_kernel(dev)
        launches, mels, f32_run = phase_end_to_end(dev, args.trained)
        finish_build()
        t0 = time.perf_counter()
        wn = phase_wavenet(dev, args.trained, mels)
        log(f"phase 3 (wavenet): {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        fwd_train, bwd = phase_train_kernels(dev)
        lstm_step_split(dev)
        train = phase_training(dev)
        log(f"phase 4 (training): {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        mel_rec, sos_rec, features_dir = phase_features(dev, corpus)
        assert features_dir == main_dir, (features_dir, main_dir)
        log(f"phase 5 (features): {time.perf_counter() - t0:.1f} s")
        # phase 6 runs on the spmel tree phase 5's make_spect wrote on the card
        t0 = time.perf_counter()
        spk_fwd, spk_bwd = phase_speaker_kernels(dev, args.trained)
        speaker = phase_speaker_pipeline(dev, args.trained, main_dir)
        spk_train = phase_speaker_training(dev, speaker["ckpt"])
        log(f"phase 6 (speaker encoder): {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        bf_lstm = phase_bf16_lstm(dev)
        bf_bench = phase_bf16_bench(dev, args.trained, mels, f32_run, bf_lstm)
        bf_wn = phase_bf16_wavenet(dev, args.trained, mels)
        scan_wn = phase_scan_wavenet(dev, args.trained, mels)
        syn_dir = tempfile.mkdtemp(prefix="chip_smoke_synthesize_")
        try:
            syn = phase_synthesize(mels, syn_dir)
        finally:
            shutil.rmtree(syn_dir, ignore_errors=True)
        if os.path.exists(syn_dir):
            raise AssertionError(f"{syn_dir} was not removed")
        log(f"phase 7 (bfloat16): {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        bf_fwd_train, bf_gates, bf_bwd_train = phase_bf16_train_kernels(dev)
        bf_train = phase_bf16_training(dev)
        bf_cli = phase_bf16_cli(dev)
        scan_fwd, scan_bwd = phase_scan_kernels(dev, args.trained)
        bf_spk = phase_bf16_speaker_training(dev)
        log(f"phase 8 (bfloat16 training): {time.perf_counter() - t0:.1f} s")
        # phase 9 converts and trains on phase 5's corpus too
        t0 = time.perf_counter()
        var = phase_variants(dev, main_dir, speaker["ckpt"])
        log(f"phase 9 (stft and wav variants): {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        scan_gen = phase_scan_generator(dev)
        scan_bench = phase_bf16_bench(dev, args.trained, mels, f32_run, scan_gen, use_pallas_lstm=False)
        log(f"10a bench.py's default bf16 program (scan) beside 7b's --pallas rounding: "
            f"{scan_bench['iteration_ms']:.1f} ms an iteration (PERF.md §5 recorded {RECORDED_BENCH_BF16_MS} ms), "
            f"{scan_bench['realtime']:.1f}x realtime, mel "
            f"{scan_bench['parity']['mel_maxabs_delta']:.4f} from f32; --pallas {bf_bench['iteration_ms']:.1f} ms, "
            f"{bf_bench['realtime']:.1f}x, mel {bf_bench['parity']['mel_maxabs_delta']:.4f}")
        scan_bwd_train, scan_dw = phase_scan_train_kernels(dev)
        scan_fwd_train = phase_scan_forward_train(dev)
        scan_train = phase_scan_training(dev)
        log(f"phase 10 (the scan rounding): {time.perf_counter() - t0:.1f} s")
        # phase 11 trains the speaker encoder and the vocoders on phase 5's corpus
        t0 = time.perf_counter()
        ge2e = phase_ge2e(dev, corpus, main_dir)
        voc_dir = tempfile.mkdtemp(prefix="chip_smoke_vocoders_", dir=corpus)
        voc = phase_vocoder_training(dev, corpus, main_dir, voc_dir)
        evals = phase_evaluate_vocoder(dev, main_dir, voc_dir, voc.pop("ckpts"))
        log(f"phase 11 (vocoder and speaker-encoder training): {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        # phase 13's processes start after 12a's timed programs, beside 12b's
        # exports, and wait idle for their go-files; 12c waits until they are
        # ready, so none of their start or work runs beside 12a's or 12c's
        # timed work
        serving = phase_serving(dev, args.trained, lambda: prestart_parallel(dev, main_dir, pre),
                                lambda: log(f"phase 13's processes ready {wait_ready(pre):.1f} s after their start"))
        log(f"phase 12 (serving): {time.perf_counter() - t0:.1f} s")
        # phase 13 on phase 5's corpus, on the processes started in phase 12
        t0 = time.perf_counter()
        par = phase_parallel(dev, main_dir, pre)
        log(f"phase 13 (parallelism): {time.perf_counter() - t0:.1f} s")
    finally:
        if pre:
            stop_parallel(pre)
        shutil.rmtree(corpus, ignore_errors=True)
    if os.path.exists(corpus):
        raise AssertionError(f"{corpus} was not removed")
    lstm_bound, lstm_bound_by = bound_ms(record["flops"], record["bytes"])
    fwd_train_bound, _ = bound_ms(fwd_train["flops"], fwd_train["bytes"])
    bwd_bound, bwd_bound_by = bound_ms(bwd["flops"], bwd["bytes"])
    train_fwd, train_bwd, train_dw = train["launches"]
    speaker_fwd = speaker["launches"][0]
    spk_fwd_n, spk_bwd_n, spk_dw_n = spk_train["launches"]
    bf_train_fwd, bf_train_gates, bf_train_bwd, bf_train_dw = bf_train["launches"]
    cli_launches = [sum(r["launches"][i] for r in bf_cli.values()) for i in range(4)]
    # phase 9's launches of each wrapper, by sub-path, and in all
    var_by = {c: variant_launches(var, c) for c in VAR_COUNTERS}
    var_n = {c: sum(by.values()) for c, by in var_by.items()}
    mel_rec["launches"] += var_n["mel_norm"]
    sos_rec["launches"] += var_n["sosfilt"]
    # 11c's launches of the feature kernels and WaveNet, by vocoder
    eval_by = {k: dict(zip(("mel_norm", "sosfilt", "wavenet_gen"), v["launches"])) for k, v in evals.items()}
    eval_n = {c: sum(v[c] for v in eval_by.values()) for c in ("mel_norm", "sosfilt", "wavenet_gen")}
    mel_rec["launches"] += eval_n["mel_norm"]
    sos_rec["launches"] += eval_n["sosfilt"]
    ge2e_fwd, ge2e_bwd, ge2e_dw = ge2e["launches"]
    cli_scan = scan_train["cli"]["bf16"]["launches"]  # LSTM_COUNTERS' order, then scan dW
    scan_paths = {"cli_train_bf16_lambda_spk": bf_cli["lambda_spk"]["scan_launches"],
                  "convert_bf16_default": (scan_bench["launches"], 0), "train_bf16_default": scan_train["launches"][:2],
                  "cli_train_bf16_default": (cli_scan[2], cli_scan[5]),
                  "serve_bf16": (serving["programs"]["bf16"]["launches"], 0)}
    serve_fwd = {"serve_f32": serving["f32_launches"], "serve_bf16": serving["programs"]["bf16_pallas"]["launches"]}
    # phase 13: 13a's SPGenerator forwards (every rank of both worlds) and
    # 13b's cli.train runs (both ranks of both multihost runs, the single
    # process beside them): (forward, backward, dW)
    sp_fwd = sum(sum(w["launches"]) for w in par["sp"]["worlds"].values())
    mh = par["multihost"]
    mh_n = [sum(rank[i] for k in ("data_parallel_2", "model_parallel_2") for rank in mh[k]["launches_per_rank"])
            + mh["solo"]["launches"][i] for i in range(3)]

    kernels = [{
        "name": "lstm_fwd",
        "route": "cuda",
        "source": "autovc_tpu_torch/ops/csrc/lstm_fwd.cu",
        "replaces": "autovc_tpu/ops/pallas_lstm.py:371 (_chunk_fwd: _lstm_kernel :55, _lstm_kernel_train :77) "
                    "and :328 (_lstm_chunk_split_impl: _lstm_kernel_split :102, _lstm_kernel_split_train :135)",
        # sequences launched on the four paths: conversion (one Generator
        # forward), training (20 steps), the speaker encoder (make_metadata
        # and evaluate_speaker_encoder on the card) and training with
        # lambda_spk (SPK_STEPS steps); the times are per Generator forward
        # in inference, the train_* ones per train step, the dvector ones
        # per d-vector forward (three sequences) at each width and batch
        # (the wrapper's "launches" count every forward, its bf16 ones too)
        "launches": launches + train_fwd + speaker_fwd + spk_fwd_n + bf_train_fwd + var_n["launches"] + ge2e_fwd
        + sum(serve_fwd.values()) + sp_fwd + mh_n[0],
        "launches_by_path": {"convert": launches, "train": train_fwd, "speaker": speaker_fwd,
                             "train_spk": spk_fwd_n, "train_bf16": bf_train_fwd,
                             "variants": var_by["launches"], "variants_bf16": var_by["bf16_launches"],
                             "ge2e_train": ge2e_fwd, **serve_fwd, "sequence_parallel": sp_fwd,
                             "train_multihost": mh_n[0]},
        # phase 13a: the SP forward at B=2, T=4096 a world beside the dense one
        "sequence_parallel": par["sp"],
        # phase 12: the exported programs (serve.py) through the operator
        # autovc::lstm_sequence: 12a's float32, bf16 (scan) and bf16 (Pallas
        # rounding) converter calls at B=32, T=512 with their times beside
        # the live pipeline's, 12b's stft and hybrid bundles, 12c's server
        "serving": serving,
        "max_abs_err": max(record["max_abs_err"], fwd_train["max_abs_err"], speaker["max_abs_err"],
                           *(r["max_abs_err"] for r in spk_fwd), *(r["h_seq"] for r in ge2e["kernels"])),
        "ms": record["ms"],
        "plain_ms": record["plain_ms"],
        "bound_ms": lstm_bound,
        "bound_by": lstm_bound_by,
        "library_ms": record["library_ms"],
        "train_ms": fwd_train["ms"],
        "train_plain_ms": fwd_train["plain_ms"],
        "train_bound_ms": fwd_train_bound,
        "train_library_ms": fwd_train["library_ms"],
        "dvector": spk_fwd,
        # phase 9a: the stft Generator forward at B=32, T=512 (CUDA events),
        # its LSTM launches' device time, the stft->mel product (torch.matmul)
        "variants_stft_convert": {"generator_ms": var["conv"]["gen_ms"], "lstm_device_ms": var["conv"]["lstm_ms"],
                                  "projection_ms": var["conv"]["proj_ms"]},
        # the bfloat16 form (phase 7a-b): launches on the bench program's
        # bfloat16 conversion; times per Generator forward (7 sequences)
        "bf16": {"launches": bf_bench["launches"], **bf_lstm, "bench": bf_bench},
        # the bfloat16 training form (phase 8a-c): launches of 8b's 20 Solver
        # steps and of 8c's cli.train runs; times per train step (11
        # sequences at B=7, T=128), the float32 kernel's on the same inputs
        # beside them; the library yardstick cuDNN's bfloat16 LSTM forward
        # alone (its training form)
        "bf16_train": {"launches": bf_train_fwd, "launches_by_path": {"train_bf16": bf_train_fwd,
                                                                      "cli_train_bf16": cli_launches[0]},
                       **bf_fwd_train},
    }, {
        "name": "lstm_bwd",
        "route": "cuda",
        "source": "autovc_tpu_torch/ops/csrc/lstm_bwd.cu",
        "replaces": "autovc_tpu/ops/pallas_lstm.py:462 (_chunk_bwd_call: _lstm_bwd_kernel :410) "
                    "and :262 (_split_bwd_rule: _lstm_bwd_kernel_split :169)",
        # per train step (11 sequences at B=7, T=128), dW included; the
        # library yardstick is cuDNN's LSTM backward alone at those shapes
        # (its forward+backward beside it), which does more: it also forms
        # the input projection's gradients (dx through w_ih, dW_ih, biases)
        # backward sequences of the two training paths; the dW launches
        # beside them: none for the frozen d-vector's three a step
        "launches": train_bwd + spk_bwd_n + bf_train_bwd + var_n["bwd_launches"] + ge2e_bwd + mh_n[1],
        "launches_by_path": {"train": train_bwd, "train_spk": spk_bwd_n, "train_bf16": bf_train_bwd,
                             "variants": var_by["bwd_launches"], "variants_bf16": var_by["bf16_bwd_launches"],
                             "ge2e_train": ge2e_bwd, "train_multihost": mh_n[1]},
        "dw_launches_by_path": {"train": train_dw, "train_spk": spk_dw_n, "train_bf16": bf_train_dw,
                                "variants": var_by["dw_launches"], "ge2e_train": ge2e_dw, "train_multihost": mh_n[2]},
        # phase 13b: cli.train --multihost, its runs' walls and exports' distances
        "multihost": mh,
        # 11a: GE2E training at H=768 and 256, B = N*M: the forward and the
        # backward with dW a sequence against the plain loops, timed; the
        # trainer's step against the plain engine
        "ge2e": ge2e,
        # phase 9's train steps of the stft and wav variants (B=7, T=128;
        # B=2, L=33536): p50 and the one-step gate's worst leaf
        "variants_step_ms_p50": {"stft": var["stft"]["step_ms_p50"], "wav": var["wav"]["step_ms_p50"]},
        "variants_grad_err": {"stft": var["stft"]["grad_err"], "wav": var["wav"]["grad_err"]},
        "dvector_fwd_bwd_launches": spk_train["dvector_counts"],
        "max_abs_err": max(bwd["max_abs_err"], *(r["max_abs_err"] for r in spk_bwd)),
        "dw_rel_err": bwd["dw_rel_err"],
        "ms": bwd["ms"],
        "plain_ms": bwd["plain_ms"],
        "bound_ms": bwd_bound,
        "bound_by": bwd_bound_by,
        "library_ms": bwd["library_ms"],
        "library_fwd_bwd_ms": bwd["library_fwd_bwd_ms"],
        # the dW kernel a train step: device time (torch.profiler) beside
        # torch.matmul's on the same operands and the bound
        "dw_ms": bwd["dw_ms"],
        "dw_library_ms": bwd["dw_library_ms"],
        "dw_bound_ms": bwd["dw_bound_ms"],
        "train_step_ms_p50": train["step_ms_p50"],
        "train_spk_step_ms_p50": spk_train["step_ms_p50"],
        "train_spk_grad_err": spk_train["grad_err"],
        # the backward without dW at the lambda_spk step's d-vector batch
        "dvector_bwd": spk_bwd,
        # the bfloat16 form (phase 8): the recurrence and dW a train step;
        # launches of 8b's 20 Solver steps and of 8c's cli.train runs; the
        # library yardstick cuDNN's bfloat16 LSTM backward alone (its
        # forward+backward beside it), as the float32 row's; 8b's step, its
        # device time and idle share
        "bf16_train": {"launches": bf_train_bwd, "dw_launches": bf_train_dw,
                       "launches_by_path": {"train_bf16": bf_train_bwd, "cli_train_bf16": cli_launches[2]},
                       **bf_bwd_train, "step": bf_train, "cli": bf_cli},
    }, {
        "name": "lstm_gates",
        "route": "cuda",
        "source": "autovc_tpu_torch/ops/csrc/lstm_gates.cu",
        "replaces": "autovc_tpu/ops/pallas_lstm.py:431 (the gate recompute of _lstm_bwd_kernel :410, run by "
                    "_chunk_bwd_call :462) and :214 (of _lstm_bwd_kernel_split :169, run by _split_bwd_rule :262)",
        # launches of 8b's 20 bfloat16 Solver steps (and 8c's beside them);
        # times per train step (11 sequences at B=7, T=128); the bound at the
        # bfloat16 tensor cores' peak; no single PyTorch call computes the
        # product and the activations, so library_ms is null and matmul_ms
        # the product alone (torch.matmul, bfloat16, device time)
        "launches": bf_train_gates + var_n["gates_launches"],
        "launches_by_path": {"train_bf16": bf_train_gates, "cli_train_bf16": cli_launches[1],
                             "variants_bf16": var_by["gates_launches"]},
        "library_ms": None,
        **bf_gates,
    }, *scan_entries(scan_fwd, scan_bwd, scan_paths, bf_spk, scan_gen,
                     {"train_form_b7": scan_fwd_train, "ge2e_batch": ge2e["scan_forward"]}, scan_bwd_train), {
        "name": "lstm_scan_dw",
        "route": "cuda",
        "source": "autovc_tpu_torch/ops/csrc/lstm_scan_dw.cu",
        "replaces": "autovc_tpu/models/layers.py:123 (the w_hh cotangent of _lstm_scan's transposed lax.scan in "
                    "bfloat16, a bfloat16 accumulator a step; no Pallas kernel)",
        # launches of 10b's Solver steps in the scan rounding (and of its
        # cli.train --bf16 beside them); times per train step of 11
        # sequences at B=7, T=128 (device time), the plain loop's, the
        # bound at the bfloat16 tensor cores' peak, and torch.matmul of the
        # one-shot product over K = B*T (which rounds once: not this
        # function); the replaced kernel's recorded time and the latency
        # bound are in the log only
        "launches": scan_train["launches"][2],
        "launches_by_path": {"train_bf16_default": scan_train["launches"][2],
                             "cli_train_bf16_default": cli_scan[8]},
        "max_abs_err": scan_dw["max_abs_err"], "max_ulps": scan_dw["max_ulps"],
        "min_equal_share": scan_dw["min_equal_share"],
        "ms": scan_dw["device_ms"], "events_ms": scan_dw["ms"], "plain_ms": scan_dw["plain_ms"],
        "bound_ms": scan_dw["bound_ms"], "bound_by": scan_dw["bound_by"], "library_ms": scan_dw["library_ms"],
        "shapes": scan_dw["shapes"], "train_step": scan_train, "bench_default_bf16": scan_bench,
    }, {
        "name": "wavenet_gen",
        "route": "cuda",
        "source": "autovc_tpu_torch/ops/csrc/wavenet_gen.cu",
        "replaces": "autovc_tpu/ops/pallas_wavenet.py:350 (generate_pallas: _wavenet_kernel :129 "
                    "and _wavenet_kernel_hybrid :176)",
        # no single PyTorch call computes autoregressive generation
        "library_ms": None,
        **wn,
        # bfloat16 weights (phase 7c-d): launches of 7c's main path, and of
        # cli.synthesize's wavenet run beside it
        "bf16": {**bf_wn, "cli_launches": syn["pallas"]["wavenet_launches"]},
        # 11c: cli.evaluate_vocoder --vocoder wavenet (float32) on one utterance
        "evaluate_vocoder_launches": eval_n["wavenet_gen"],
        # 11b: the vocoders' training (no Pallas kernel: cuDNN, cuBLAS, cuFFT)
        "vocoder_training": voc,
    }, {
        "name": "wavenet_gen.scan",
        "route": "cuda",
        "source": "autovc_tpu_torch/ops/csrc/wavenet_gen.cu",
        "replaces": "autovc_tpu/vocoder/wavenet.py:244 (_generate_scan in bfloat16, the JAX scan engine's "
                    "lax.scan, every op rounded; no Pallas kernel)",
        # launches: 7e's WaveNetVocoder.generate (default engine) and 7d's
        # cli.synthesize --bf16 beside it; times a call at B=8, T=2048; no
        # single PyTorch call computes autoregressive generation
        **scan_wn,
        "launches": scan_wn["launches"] + syn["scan"]["wavenet_launches"],
        "launches_by_path": {"generate_bf16": scan_wn["launches"], "cli_synthesize_bf16": syn["scan"]["wavenet_launches"]},
    }, {
        "name": "mel_norm",
        "route": "cuda",
        "source": "autovc_tpu_torch/ops/csrc/mel_norm.cu",
        "replaces": "autovc_tpu/ops/pallas_mel.py:34 (mel_normalize, pallas_call :53: _kernel :25)",
        # launches: one a file of phase 5's make_spect run; the times at
        # (16416, 513) x (513, 80); no single PyTorch call computes the whole
        # function, so the library time is torch.matmul of the projection alone
        "library_note": "torch.matmul of the projection alone, without the dB step",
        **mel_rec,
        "launches_by_path": {"make_spect": mel_rec["launches"] - var_n["mel_norm"] - eval_n["mel_norm"],
                             "variants": var_by["mel_norm"],
                             "evaluate_vocoder": {k: v["mel_norm"] for k, v in eval_by.items()}},
        "evaluate_vocoder": evals,
    }, {
        "name": "sosfilt",
        "route": "cuda",
        "source": "autovc_tpu_torch/ops/csrc/sosfilt.cu",
        "replaces": "autovc_tpu/dsp/filters.py:135 (_sosfilt, a lax.scan run twice by _sos_filtfilt_jit :164; "
                    "no Pallas kernel)",
        # launches: two a file of phase 5's make_spect run; the times are both
        # passes at B=32, L=131072; no PyTorch call runs an IIR cascade
        "library_ms": None,
        **sos_rec,
        "launches_by_path": {"make_spect": sos_rec["launches"] - var_n["sosfilt"] - eval_n["sosfilt"],
                             "variants": var_by["sosfilt"],
                             "evaluate_vocoder": {k: v["sosfilt"] for k, v in eval_by.items()}},
    }]
    faulthandler.cancel_dump_traceback_later()
    log(f"chip_smoke: {time.perf_counter() - started:.1f} s wall of the {WATCHDOG_S} s watchdog")
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
