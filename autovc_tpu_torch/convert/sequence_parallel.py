"""Sequence-parallel whole-utterance conversion.

Counterpart of ``autovc_tpu/convert/sequence_parallel.py``: the Generator's
eval-mode forward with the time axis split over the ranks of a 'seq' mesh
axis (``parallel.sequence``), for utterances longer than one device holds:

  encoder: speaker-embedding concat (local) -> 3x [halo conv + BatchNorm
           (eval) + relu] -> sequence-parallel BLSTM -> the bottleneck's
           downsampling (local: a block is a whole number of freq blocks)
  decoder: codes repeated and the target embedding concatenated (local) ->
           sp LSTM -> 3x [halo conv + BatchNorm + relu] -> 2x sp LSTM ->
           the projection (local)
  postnet: 5x [halo conv + BatchNorm (+ tanh)] + the residual (local)

Convolutions exchange k // 2-frame halos; the LSTMs hand their state from
block to block. Eval-mode BatchNorm is elementwise (running statistics), so
it stays local. ``convert_specs`` runs conversions on a world of ranks that
it starts itself (``parallel.launch``), as ``cli.convert --seq_devices``
does.
"""

from __future__ import annotations

import os
from typing import Any, Sequence

import numpy as np
import torch

from autovc_tpu_torch import exact_f32
from autovc_tpu_torch.config import AudioConfig, ModelConfig
from autovc_tpu_torch.convert import pad_seq
from autovc_tpu_torch.dsp.mel import mel_filterbank
from autovc_tpu_torch.models import Generator, build_generator
from autovc_tpu_torch.parallel.mesh import Mesh, all_gather, batch_split, mesh_over
from autovc_tpu_torch.parallel.sequence import halo_conv1d, sp_blstm, sp_lstm, time_block


def _cat(seq: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
    b, t, _ = seq.shape
    return torch.cat([seq, emb[:, None, :].expand(b, t, emb.shape[-1])], dim=-1)


class SPGenerator:
    """The eval-mode forward of a ``Generator`` over a 'seq' mesh axis (and,
    with ``batch_axis``, the batch over a second axis: data x sequence
    parallelism).

    It reads the Generator's float32 parameters and running statistics and
    computes in float32, as the JAX ``SPGenerator`` reads its parameter tree:
    the Generator's ``compute_dtype`` is ignored. T must split into blocks of
    a whole number of freq steps, one a rank (pad with ``pad_seq`` to a
    multiple of n * freq first)."""

    def __init__(self, generator: Generator, mesh: Mesh, axis: str = "seq", batch_axis: str | None = None):
        self.g = generator.eval()
        self.mesh = mesh
        self.axis = axis
        self.batch_axis = batch_axis
        self.freq = generator.encoder.freq
        self.neck = generator.encoder.dim_neck

    def _conv(self, h: torch.Tensor, module: torch.nn.Module, i: int) -> torch.Tensor:
        conv = getattr(module, f"conv{i}")
        return getattr(module, f"bn{i}")(halo_conv1d(h, conv.weight, conv.bias, self.mesh, self.axis))

    def _lstm(self, h: torch.Tensor, lstm: torch.nn.Module) -> torch.Tensor:
        for layer in range(lstm.num_layers):
            h = sp_lstm(h, getattr(lstm, f"w_ih_l{layer}_fwd"), getattr(lstm, f"w_hh_l{layer}_fwd"),
                        getattr(lstm, f"b_l{layer}_fwd"), self.mesh, self.axis)
        return h

    def encode(self, x: torch.Tensor, c_org: torch.Tensor) -> torch.Tensor:
        """This rank's block (B, Tb, n_bins) -> its codes (B, Tb // freq,
        2 * dim_neck)."""
        b, tb, _ = x.shape
        if tb % self.freq:
            raise ValueError(f"a block of {tb} steps is not a whole number of freq {self.freq} blocks: T must be "
                             f"divisible by n_ranks * freq = {self.mesh.size(self.axis) * self.freq}")
        enc = self.g.encoder
        h = _cat(x, c_org)
        for i in range(3):
            h = torch.relu(self._conv(h, enc, i))
        out = sp_blstm(h, dict(enc.blstm.named_parameters()), self.mesh, self.axis, num_layers=2)
        blocks = out.reshape(b, tb // self.freq, self.freq, 2 * self.neck)
        return torch.cat([blocks[:, :, -1, : self.neck], blocks[:, :, 0, self.neck :]], dim=-1)

    def decode(self, codes: torch.Tensor, c_trg: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """This rank's codes -> (x_identic, x_psnt) of its block."""
        dec = self.g.decoder
        h = self._lstm(_cat(codes.repeat_interleave(self.freq, dim=1), c_trg), dec.lstm1)
        for i in range(3):
            h = torch.relu(self._conv(h, dec, i))
        x_identic = dec.proj(self._lstm(h, dec.lstm2))
        g = x_identic
        for i in range(5):
            g = self._conv(g, self.g.postnet, i)
            if i < 4:
                g = torch.tanh(g)
        return x_identic, x_identic + g

    @torch.inference_mode()
    def forward_block(self, x: torch.Tensor, c_org: torch.Tensor, c_trg: torch.Tensor):
        """This rank's block of x (and the embeddings of its rows) -> its
        blocks of (x_identic, x_psnt, codes)."""
        with exact_f32(x.device):
            codes = self.encode(x, c_org)
            return (*self.decode(codes, c_trg), codes)

    def __call__(self, x, c_org, c_trg) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """The global batch (every rank passes the same x (B, T, n_bins) and
        embeddings, numpy or tensors) -> the global (x_identic, x_psnt,
        codes flattened), on every rank."""
        dev = next(self.g.parameters()).device
        x, c_org, c_trg = (torch.as_tensor(a, dtype=torch.float32, device=dev) for a in (x, c_org, c_trg))
        if self.batch_axis is not None:
            c_org, c_trg = (batch_split(c, self.mesh, self.batch_axis) for c in (c_org, c_trg))
        outs = []
        for o in self.forward_block(time_block(x, self.mesh, self.axis, self.batch_axis), c_org, c_trg):
            o = all_gather(o, self.mesh, self.axis, dim=1)
            outs.append(o if self.batch_axis is None else all_gather(o, self.mesh, self.batch_axis, dim=0))
        x_identic, x_psnt, codes = outs
        return x_identic, x_psnt, codes.reshape(codes.shape[0], -1)


def _convert_rank(device: torch.device, state: dict, cfg: ModelConfig, audio: AudioConfig, specs: Sequence[Any],
                  to_mel: bool) -> list[np.ndarray] | None:
    """One rank of ``convert_specs``: every spec padded to a multiple of
    n * freq, converted over the world's 'seq' axis, the padding stripped,
    and, with ``to_mel``, an stft output projected onto the mel bands (on
    the device, in exact float32); the outputs on rank 0, None elsewhere."""
    mesh = mesh_over({"seq": torch.distributed.get_world_size()}, device)
    gen = build_generator(cfg, device="cpu")
    gen.load_state_dict(state)
    sp = SPGenerator(gen.to(device), mesh)
    basis = torch.from_numpy(mel_filterbank(audio.sample_rate, audio.n_fft, audio.n_mels, audio.mel_fmin,
                                            audio.mel_fmax)).to(device)
    outs = []
    for spec in specs:
        x, len_pad = pad_seq(np.asarray(spec.src_features, np.float32), base=cfg.freq * mesh.size("seq"))
        _, x_psnt, _ = sp(x[None], np.asarray(spec.src_embedding)[None], np.asarray(spec.trg_embedding)[None])
        out = x_psnt[0, : x.shape[0] - len_pad]
        if to_mel and cfg.model_type == "stft":
            with exact_f32(device):
                out = torch.matmul(out, basis)
        outs.append(out.cpu().numpy())
    return outs if mesh.rank == 0 else None


def convert_specs(generator: Generator, cfg: ModelConfig, specs: Sequence[Any], n_ranks: int,
                  device: str | torch.device = "cuda", audio: AudioConfig = AudioConfig(),
                  to_mel: bool = True) -> list[np.ndarray]:
    """Each spec's conversion (``Converter.convert_to_mel``, or with
    ``to_mel=False`` ``convert``) computed by ``SPGenerator`` on a world of
    ``n_ranks`` processes started here (``parallel.launch.run_world``): rank
    r on ``cuda:r`` where the host has that many cards, else the ranks share
    the card under gloo (``AUTOVC_DIST_BACKEND=gloo``; NCCL raises), or the
    CPU under gloo; each rank takes its share of the host's cores."""
    from autovc_tpu_torch.parallel.launch import run_world

    state = {k: v.detach().cpu() for k, v in generator.state_dict().items()}
    return run_world(_convert_rank, n_ranks, state, cfg, audio, list(specs), to_mel, device=device,
                     threads=max(1, (os.cpu_count() or 1) // n_ranks))[0]
