"""Smoke run of the PyTorch/CUDA port on one GPU: builds the kernels, holds
each against its plain PyTorch version, and drives spmel conversion
inference end to end.

    python3 chip_smoke.py            # seeded random weights at full width
    python3 chip_smoke.py --trained  # the committed artifacts/*.npz weights

Phase 1 builds ``csrc/lstm_fwd.cu`` (plain nvcc) and runs the LSTM kernel
against ``lstm_sequence_ref`` at the main path's shapes (B=32, T=512,
H in {32, 512, 1024}, both directions), max-abs tolerance 1e-4, and times
both beside cuDNN's LSTM. Phase 2 runs ``Converter.convert_batch`` on 32
synthetic mels of 512 frames and the HiFi-GAN vocoder on its output, checks
that the generator went through the kernel (7 LSTM sequences per forward),
that the mel matches the same path with the plain recurrence (max-abs 1e-3)
and that the waveform is finite and (32, 131072), then times a warm
iteration.

The output ends with the card's name and power limit, one JSON line of
kernel records, and ``{"ok": true, "device": {...}}``. Any failure raises and
exits non-zero; a watchdog ends a hung run with a stack dump. Without a CUDA
device it exits non-zero before doing anything. It writes nothing outside
the kernel build directory.
"""

from __future__ import annotations

import sys

sys.dont_write_bytecode = True  # keep the checkout free of __pycache__

import argparse  # noqa: E402
import faulthandler  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import time  # noqa: E402
import types  # noqa: E402
from pathlib import Path  # noqa: E402
from unittest import mock  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from autovc_tpu_torch.config import ModelConfig  # noqa: E402
from autovc_tpu_torch.convert import Converter  # noqa: E402
from autovc_tpu_torch.models import build_generator  # noqa: E402
from autovc_tpu_torch.ops import _build  # noqa: E402
from autovc_tpu_torch.ops import lstm as lstm_ops  # noqa: E402
from autovc_tpu_torch.vocoder.hifigan import HiFiGANVocoder  # noqa: E402

WATCHDOG_S = 600
ROOT = Path(__file__).resolve().parent
B, T, N_MELS, HOP = 32, 512, 80, 256
LSTM_TOL = 1e-4  # f32 kernel vs f32 plain loop: summation order only
MEL_TOL = 1e-3  # on the whole generator, after 7 recurrences and 11 convs
# H100 SXM peaks (NVIDIA data sheet): f32 outside the tensor cores, HBM3.
F32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12
# (hidden, reverse, calls per Generator forward)
LSTM_CASES = [
    (32, False, 2), (32, True, 2),  # encoder BLSTM, 2 layers
    (512, False, 1), (512, True, 0),  # decoder lstm1 (reverse: coverage only)
    (1024, False, 2), (1024, True, 0),  # decoder lstm2, 2 layers
]


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


def phase_kernel(dev: torch.device) -> dict:
    """Build the LSTM kernel and hold it against the plain version."""
    t0 = time.perf_counter()
    _build.load("lstm_fwd")
    log(f"build lstm_fwd: {time.perf_counter() - t0:.1f} s "
        f"(nvcc {_build.build_seconds.get('lstm_fwd', 0.0):.1f} s)")
    for line in _build.build_log.get("lstm_fwd", "").splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")

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
            f"ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={case_bound_ms:.4f} ({bound_by}) "
            f"calls_per_forward={calls}")
        if not err <= LSTM_TOL:
            raise AssertionError(f"lstm kernel H={hidden} reverse={reverse}: {err} > {LSTM_TOL}")
        record["max_abs_err"] = max(record["max_abs_err"], err)
        record["ms"] += calls * ms
        record["plain_ms"] += calls * plain_ms
        record["flops"] += calls * flops
        record["bytes"] += calls * nbytes
    record["library_ms"] = cudnn_lstm_ms(dev, rng)
    return record


def cudnn_lstm_ms(dev: torch.device, rng: np.random.RandomState) -> float:
    """Yardstick only: torch.nn.LSTM (cuDNN) over the generator's three LSTM
    stacks at B=32, T=512, input product included."""
    total = 0.0
    for in_dim, hidden, layers, bidir in [(512, 32, 2, True), (320, 512, 1, False), (512, 1024, 2, False)]:
        net = torch.nn.LSTM(in_dim, hidden, layers, batch_first=True, bidirectional=bidir).to(dev)
        x = torch.from_numpy(rng.randn(B, T, in_dim).astype(np.float32)).to(dev)
        with torch.inference_mode():
            ms = cuda_ms(lambda: net(x), reps=5)
        log(f"cudnn nn.LSTM in={in_dim} H={hidden} layers={layers} bidirectional={bidir}: ms={ms:.4f}")
        total += ms
    return total


def phase_end_to_end(dev: torch.device, trained: bool) -> int:
    """Converter.convert_batch + HiFi-GAN on (32, 512, 80) mels; returns the
    kernel launches of the main-path run."""
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

    with mock.patch.object(lstm_ops, "lstm_sequence", lstm_ops.lstm_sequence_ref):
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
    log(f"warm iteration: {warm_s * 1e3:.1f} ms wall for {audio_s:.1f} s of audio "
        f"({audio_s / warm_s:.1f}x realtime); generator {gen_ms:.1f} ms, vocoder {voc_ms:.1f} ms "
        f"(card: {card_line()})")
    return launches


def main(argv: list[str] | None = None) -> int:
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--trained", action="store_true", help="load the committed artifacts instead of seeded weights")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    record = phase_kernel(dev)
    launches = phase_end_to_end(dev, args.trained)
    lstm_bound, lstm_bound_by = bound_ms(record["flops"], record["bytes"])

    kernels = [{
        "name": "lstm_fwd",
        "route": "cuda",
        "source": "autovc_tpu_torch/ops/csrc/lstm_fwd.cu",
        "replaces": "autovc_tpu/ops/pallas_lstm.py:371 (_chunk_fwd) and :328 (_lstm_chunk_split_impl)",
        "launches": launches,
        "max_abs_err": record["max_abs_err"],
        "ms": record["ms"],
        "plain_ms": record["plain_ms"],
        "bound_ms": lstm_bound,
        "bound_by": lstm_bound_by,
        "library_ms": record["library_ms"],
    }]
    faulthandler.cancel_dump_traceback_later()
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
