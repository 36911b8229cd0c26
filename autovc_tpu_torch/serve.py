"""Serving bundles: exported, shape-polymorphic conversion programs.

Counterpart of ``autovc_tpu/serve.py``, with ``torch.export`` in place of
``jax.export``. ``export_converter`` traces the conversion programs once
and saves them; ``ServingConverter`` loads and calls them without the
model-building code (it imports neither ``autovc_tpu_torch.models`` nor
``autovc_tpu_torch.vocoder``).

- **Shapes.** The converter program takes ``(b, 32*t, n_bins)``: any batch
  and any frame count that is a multiple of ``freq`` (the pad_seq
  contract) runs through one program; a frame count that is not trips the
  program's own shape guard, which ``ServingConverter.__call__`` raises as
  ``ValueError``. The vocoder program takes ``(b2, tm, n_bins)`` with
  ``tm >= 2`` (export guards a transposed length against 1), ``tm >= 4`` in
  the hybrid mode (its STFT's reflect padding).
- **Weights are call arguments**, as in the JAX bundle: the programs hold
  no parameters (``torch.func.functional_call`` over the model's state
  dict), so a checkpoint refresh needs no re-export and a program file is
  small. ``weights.npz`` holds the JAX flat names of ``{generator,
  batch_stats, hifigan}``, float32 (bfloat16 is a compute dtype: the
  Generator and HiFi-GAN cast inside the program, and outputs are float32).
- **Kernels.** Each LSTM recurrence is one node of the operator
  ``autovc::lstm_sequence`` (``ops.lstm``): the plain version on the CPU,
  ``lstm_fwd.cu`` (float32, and bfloat16 with ``use_pallas_lstm``) or
  ``lstm_scan_fwd.cu`` (bfloat16 by default) on the card.
- **Platforms.** An exported program records the device of the tensors it
  was traced with, so a bundle holds one program per platform in
  ``platforms`` (``cpu``, ``cuda``); exporting for ``cuda`` needs a card,
  and loading raises where the bundle has no program for the device asked
  for. A program is loaded by the torch version that wrote it (the
  manifest records it).

A bundle holds two programs, as the live pipeline's staging: the converter
(features -> converted features) and, optionally, the vocoder (features ->
waveform: HiFi-GAN, with the stft variant's mel projection baked in, or the
hybrid refinement after it). The server strips the pad between them, as
``Converter.convert`` + ``HiFiGANVocoder.generate`` do.

Layout of a bundle directory::

    converter.<platform>.pt2   torch.export.save of the Generator forward
    vocoder.<platform>.pt2     optional: HiFi-GAN (+ stft mel projection,
                               + hybrid Griffin-Lim)
    weights.npz                flat generator/batch_stats (+ hifigan/) params
    manifest.json              shapes, platforms, dtypes, calling convention
"""

from __future__ import annotations

import json
import os
from typing import Sequence

import numpy as np
import torch
from torch import nn
from torch.export import Dim

import autovc_tpu_torch.ops.lstm  # noqa: F401  (registers autovc::lstm_sequence before a program loads)
from autovc_tpu_torch import exact_f32, resolve_device
from autovc_tpu_torch.convert import pad_seq
from autovc_tpu_torch.io import flatten_params, generator_state_from_jax, hifigan_state_from_jax, unflatten_params

CONVERTER_NAME = "converter.{platform}.pt2"
VOCODER_NAME = "vocoder.{platform}.pt2"
WEIGHTS_NAME = "weights.npz"
MANIFEST_NAME = "manifest.json"
FORMAT = "autovc_tpu_torch.serve/1"
# the smallest vocoder input: the trace guards a transposed length against
# 1; the hybrid mode's STFT reflect-pads n_fft // 2 samples, which the
# waveform (hop * tm) must cover
VOCODER_MIN_FRAMES = {"hifigan": 2, "hybrid": 4}


def _converter_fn(model: nn.Module):
    """Served stage 1: normalized features -> converted features (reference
    conversion.py:90-95), float32 whatever the compute dtype."""

    def fn(weights, x, emb_org, emb_trg):
        _, x_psnt, _ = torch.func.functional_call(model, weights, (x, emb_org, emb_trg), strict=True)
        return x_psnt.float()

    return fn


def _vocoder_fn(vocoder_model: nn.Module, mel_basis: torch.Tensor | None, bf16: bool = False, audio=None,
                gl_iters: int | None = None):
    """Served stage 2: converted features -> waveform. The stft variant's
    mel projection (conversion.py:102) is baked in as a constant; bf16 casts
    the float32 weights and the mel inside the program (as
    ``HiFiGANVocoder(dtype=torch.bfloat16)`` runs); ``gl_iters`` bakes in
    the hybrid refinement (``vocoder.hybrid``) on the float32 mel. The
    waveform is float32."""
    from autovc_tpu_torch.vocoder.hybrid import refine_with_mel_magnitude

    def fn(weights, feats):
        mel = feats if mel_basis is None else torch.matmul(feats, mel_basis)
        mel_f32 = mel
        if bf16:
            weights = {k: v.to(torch.bfloat16) for k, v in weights.items()}
            mel = mel.to(torch.bfloat16)
        wav = torch.func.functional_call(vocoder_model, weights, (mel,), strict=True).float()
        if gl_iters is not None:
            wav = refine_with_mel_magnitude(wav, mel_f32, audio, n_iter=gl_iters)
        return wav

    return fn


class _Program(nn.Module):
    """A stage function as the module ``torch.export`` traces. The model it
    closes over is not a submodule, so the program holds no parameters:
    they are its first argument."""

    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, weights: dict[str, torch.Tensor], *inputs: torch.Tensor) -> torch.Tensor:
        return self.fn(weights, *inputs)


def _export(fn, weights: dict[str, torch.Tensor], inputs: tuple, shapes: tuple, path: str) -> None:
    """Trace ``fn(weights, *inputs)`` with ``shapes`` symbolic and save it
    without its example inputs (the weights). Sizes are traced
    size-obliviously, so that no guard excludes a batch or a block count of
    1 (the examples are 2)."""
    import torch.fx.experimental._config as fx_config

    with torch.no_grad(), fx_config.patch(backed_size_oblivious=True):
        program = torch.export.export(_Program(fn), (weights, *inputs),
                                      dynamic_shapes=({k: None for k in weights}, shapes))
    program.example_inputs = None
    torch.export.save(program, path)


def _state(tree: dict, device: torch.device) -> dict[str, torch.Tensor]:
    """A state dict on ``device`` in sorted key order: the order the
    programs' weights argument was traced in."""
    return {k: tree[k].to(device) for k in sorted(tree)}


def export_converter(variables: dict, cfg, out_dir: str, hifigan_params: dict | None = None,
                     platforms: Sequence[str] = ("cuda",), gl_iters: int | None = None) -> str:
    """Save the conversion program(s) for serving; returns the bundle dir.

    ``variables``: the JAX ``{'params': ..., 'batch_stats': ...}`` tree of
    the generator ``cfg.model`` describes (``io.load_artifact``'s tree, NumPy
    arrays); ``hifigan_params`` the JAX HiFi-GAN tree, which adds the
    vocoder program; ``gl_iters`` makes it the hybrid (HiFi-GAN phase +
    ``gl_iters`` Griffin-Lim projections on the mel magnitude). One program
    per platform of ``platforms``; ``cuda`` without a card raises."""
    from autovc_tpu_torch.dsp.mel import mel_filterbank
    from autovc_tpu_torch.models import build_generator
    from autovc_tpu_torch.vocoder.hifigan import HiFiGANGenerator

    platforms = list(platforms)
    if not platforms or any(p not in ("cpu", "cuda") for p in platforms):
        raise ValueError(f"platforms are cpu and cuda, got {platforms}")
    devices = [resolve_device(p) for p in platforms]  # raises before anything is written
    m = cfg.model
    b, t = Dim("b", min=1), Dim("t", min=1)
    gen_state = generator_state_from_jax(variables)
    bf16 = m.compute_dtype == "bfloat16"
    os.makedirs(out_dir, exist_ok=True)
    for platform, dev in zip(platforms, devices):
        model = build_generator(m, device=dev)
        x = torch.zeros((2, 2 * m.freq, m.n_bins), device=dev)
        # two tensors: export would trace one tensor passed twice as one input
        emb_org, emb_trg = torch.zeros((2, 2, m.dim_emb), device=dev)
        _export(_converter_fn(model), _state(gen_state, dev), (x, emb_org, emb_trg),
                ({0: b, 1: m.freq * t}, {0: b}, {0: b}),
                os.path.join(out_dir, CONVERTER_NAME.format(platform=platform)))

    flat = {**flatten_params(variables["params"], "generator"),
            **flatten_params(variables.get("batch_stats", {}), "batch_stats")}
    vocoder_mode = None if hifigan_params is None else ("hybrid" if gl_iters is not None else "hifigan")
    if hifigan_params is not None:
        voc_state = hifigan_state_from_jax(hifigan_params)
        b2, tm = Dim("b2", min=1), Dim("tm", min=VOCODER_MIN_FRAMES[vocoder_mode])
        for platform, dev in zip(platforms, devices):
            mel_basis = None
            if m.model_type == "stft":
                a = cfg.audio
                mel_basis = torch.tensor(np.ascontiguousarray(
                    mel_filterbank(a.sample_rate, a.n_fft, a.n_mels, a.mel_fmin, a.mel_fmax)), device=dev)
            voc = HiFiGANGenerator(cfg.hifigan).to(dev).eval().requires_grad_(False)
            feats = torch.zeros((2, 8, m.n_bins), device=dev)
            _export(_vocoder_fn(voc, mel_basis, bf16=bf16, audio=cfg.audio, gl_iters=gl_iters),
                    _state(voc_state, dev), (feats,), ({0: b2, 1: tm},),
                    os.path.join(out_dir, VOCODER_NAME.format(platform=platform)))
        flat.update(flatten_params(hifigan_params, "hifigan"))
    np.savez(os.path.join(out_dir, WEIGHTS_NAME), **flat)  # uncompressed: zlib took seconds a bundle

    manifest = {
        "format": FORMAT,
        "platforms": platforms,
        "model_type": m.model_type,
        "compute_dtype": m.compute_dtype,
        "use_pallas_lstm": m.use_pallas_lstm,
        "n_bins": m.n_bins,
        "freq": m.freq,
        "dim_emb": m.dim_emb,
        "with_vocoder": hifigan_params is not None,
        "vocoder_mode": vocoder_mode,
        "gl_iters": gl_iters,
        "vocoder_min_frames": VOCODER_MIN_FRAMES.get(vocoder_mode),
        "hop_size": cfg.audio.hop_length,
        "torch_version": torch.__version__,
        "call": "converter(weights, x(b,%d*t,%d) f32, emb_org(b,%d), emb_trg(b,%d)); "
                "vocoder(voc_weights, feats(b,tm,%d))" % (m.freq, m.n_bins, m.dim_emb, m.dim_emb, m.n_bins),
    }
    with open(os.path.join(out_dir, MANIFEST_NAME), "w") as f:
        json.dump(manifest, f, indent=1)
    return out_dir


class ServingConverter:
    """Loader and caller of an exported bundle on ``device``, without the
    model code.

    ``convert(features, emb_org, emb_trg)`` takes one utterance (T, n_bins),
    pads it to the freq multiple as the reference does (conversion.py:40-44),
    calls the converter program, strips the pad and, for a bundle with a
    vocoder, feeds the stripped features to the vocoder program: the
    staging of ``Converter.convert`` + ``HiFiGANVocoder.generate``. Every
    call runs in exact float32 (``exact_f32``): the backend's TF32 flags are
    not part of an exported program."""

    def __init__(self, bundle_dir: str, device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.bundle_dir = bundle_dir
        with open(os.path.join(bundle_dir, MANIFEST_NAME)) as f:
            self.manifest = json.load(f)
        platform = self.device.type
        if platform not in self.manifest["platforms"]:
            raise ValueError(f"{bundle_dir} holds programs for {self.manifest['platforms']}, not {platform}: "
                             f"export it with platforms including {platform!r}")
        self._converter = torch.export.load(
            os.path.join(bundle_dir, CONVERTER_NAME.format(platform=platform))).module()
        self._vocoder = None
        if self.manifest["with_vocoder"]:
            self._vocoder = torch.export.load(
                os.path.join(bundle_dir, VOCODER_NAME.format(platform=platform))).module()
        with np.load(os.path.join(bundle_dir, WEIGHTS_NAME)) as z:
            nested = unflatten_params({k: z[k] for k in z.files})
        self.weights = _state(generator_state_from_jax(
            {"params": nested["generator"], "batch_stats": nested.get("batch_stats", {})}), self.device)
        self.voc_weights = _state(hifigan_state_from_jax(nested["hifigan"]), self.device) if self._vocoder else None

    @property
    def with_vocoder(self) -> bool:
        return self._vocoder is not None

    def _tensor(self, a) -> torch.Tensor:
        if isinstance(a, np.ndarray):  # any strides, as NumPy callers hand them
            a = np.ascontiguousarray(a, np.float32)
        return torch.as_tensor(a, dtype=torch.float32, device=self.device)

    def __call__(self, x, emb_org, emb_trg) -> torch.Tensor:
        """Batched raw converter call: x (b, freq*t, n_bins), already padded
        -> (b, freq*t, n_bins) float32 on the device. A frame count that is
        not a multiple of freq raises ValueError (the program's guard)."""
        return self._run(self._converter, f"the frame count must be a multiple of freq {self.manifest['freq']}",
                         self.weights, x, emb_org, emb_trg)

    def vocode(self, feats) -> torch.Tensor:
        """Batched raw vocoder call: feats (b, tm, n_bins) -> waveform
        (b, tm * hop_size), float32 on the device; tm below the manifest's
        ``vocoder_min_frames`` raises ValueError (the program's guard)."""
        if self._vocoder is None:
            raise ValueError("the bundle was exported without a vocoder program")
        return self._run(self._vocoder, f"the vocoder takes at least {self.manifest['vocoder_min_frames']} frames",
                         self.voc_weights, feats)

    def _run(self, program, guard: str, weights: dict[str, torch.Tensor], *inputs) -> torch.Tensor:
        """``program(weights, *inputs)`` on the device in exact float32; the
        program's shape guards as ValueError with ``guard``, the contract
        they hold: its check of the inputs' shapes (RuntimeError, "Expected
        input ...") and the guards inside its graph (AssertionError, "Guard
        failed ...")."""
        with torch.inference_mode(), exact_f32(self.device):
            try:
                return program(weights, *(self._tensor(a) for a in inputs))
            except (RuntimeError, AssertionError) as exc:
                if not str(exc).startswith(("Expected input", "Guard failed")):
                    raise
                raise ValueError(f"{guard}: {exc}") from exc

    def convert(self, features: np.ndarray, emb_org: np.ndarray, emb_trg: np.ndarray) -> np.ndarray:
        """One utterance (T, n_bins) -> converted features (T, n_bins), or
        the waveform (T * hop_size,) for a bundle with a vocoder."""
        x, len_pad = pad_seq(np.asarray(features, np.float32), base=self.manifest["freq"])
        out = self(x[None], np.asarray(emb_org, np.float32)[None], np.asarray(emb_trg, np.float32)[None])[0]
        if len_pad:
            out = out[: out.shape[0] - len_pad]
        if self._vocoder is not None:
            out = self.vocode(out[None])[0]
        return out.cpu().numpy()
