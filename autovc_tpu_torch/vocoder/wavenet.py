"""WaveNet vocoder (r9y9 wavenet_vocoder): mel (B, Tc, 80) -> waveform
(B, Tc * 256), one sample at a time.

Counterpart of ``autovc_tpu/vocoder/wavenet.py``: 24 dilated-conv layers in
4 stacks (kernel 3, dilations 1..32), 512 residual / 512 gate (tanh and
sigmoid halves) / 256 skip channels, a mixture-of-logistics output (10
mixtures) and 80-mel conditioning upsampled x256 by channel-shared transposed
convs. Parameters keep the JAX names and layouts (``first_conv``,
``layers.<i>.{w_prev2, w_prev1, w_cur, bias, w_cond, w_out, b_out, w_skip,
b_skip}``, ``last1``, ``last2``, ``upsample.<j>.kernel``).

Two paths, as in the JAX package:

- ``WaveNet.apply``: the teacher-forced forward, causal dilated convs as
  shifted matrix products over the whole sequence (plain PyTorch);
- ``WaveNetVocoder.generate``: autoregressive generation through
  ``ops.wavenet.generate`` (the CUDA kernel on a card, the plain loop on the
  CPU), with float32 weights or, ``dtype=torch.bfloat16``, bfloat16 weights
  in the rounding of the JAX engine ``engine`` names: ``"scan"`` (the
  default, as in JAX) rounds as ``_generate_scan(dtype=bfloat16)`` does (h,
  the skip sum, the biases and the first conv in bfloat16 too, every op
  rounded), ``"pallas"`` as the Pallas engine does (``pack_weights(...,
  dtype=jnp.bfloat16)``: float32 h and skip accumulators and biases). In
  float32 both engines compute the same function and run the one float32
  kernel.

Randomness stays outside the network: generation consumes a (B, T, K+1)
stream of uniforms, given by the caller or drawn from a seeded
``torch.Generator``. JAX's ``key`` streams cannot be reproduced here, so the
same seed gives other samples than the JAX package; the same uniforms give
the same samples.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from autovc_tpu_torch import exact_f32, resolve_device
from autovc_tpu_torch.config import WaveNetConfig
from autovc_tpu_torch.io import load_artifact, wavenet_state_from_jax
from autovc_tpu_torch.ops import wavenet as wavenet_ops
from autovc_tpu_torch.ops.wavenet import SQRT_HALF, U_MAX, U_MIN, sample_from_mol_uniforms


class _Params(nn.Module):
    """A leaf module holding float32 parameters of the given shapes."""

    def __init__(self, **shapes: tuple[int, ...]):
        super().__init__()
        for name, shape in shapes.items():
            self.register_parameter(name, nn.Parameter(torch.zeros(shape)))


class WaveNet(nn.Module):
    def __init__(self, cfg: WaveNetConfig = WaveNetConfig()):
        super().__init__()
        self.cfg = cfg
        r, g, s, c = cfg.residual_channels, cfg.gate_channels, cfg.skip_channels, cfg.cin_channels
        self.first_conv = _Params(kernel=(1, r), bias=(r,))
        self.layers = nn.ModuleDict({
            str(i): _Params(w_prev2=(r, g), w_prev1=(r, g), w_cur=(r, g), bias=(g,), w_cond=(c, g),
                            w_out=(g // 2, r), b_out=(r,), w_skip=(g // 2, s), b_skip=(s,))
            for i in range(cfg.layers)
        })
        self.last1 = _Params(kernel=(s, s), bias=(s,))
        self.last2 = _Params(kernel=(s, cfg.out_channels), bias=(cfg.out_channels,))
        self.upsample = nn.ModuleDict({
            str(j): _Params(kernel=(cfg.freq_axis_kernel_size, 2 * scale))
            for j, scale in enumerate(cfg.upsample_scales)
        })

    def reset_parameters(self, seed: int) -> None:
        """The JAX package's initialisers from one seeded generator: matrices
        normal with std sqrt(1/fan_in), zero biases, and the upsampler's
        fixed interpolation kernels (1/s on the middle frequency row)."""
        gen = torch.Generator().manual_seed(seed)
        cfg = self.cfg

        def normal_(p: torch.Tensor, fan_in: int) -> None:
            with torch.no_grad():
                p.copy_(torch.randn(p.shape, generator=gen) * math.sqrt(1.0 / fan_in))

        normal_(self.first_conv.kernel, 1)
        normal_(self.last1.kernel, cfg.skip_channels)
        normal_(self.last2.kernel, cfg.skip_channels)
        for lp in self.layers.values():
            for name in ("w_prev2", "w_prev1", "w_cur"):
                normal_(getattr(lp, name), cfg.residual_channels * cfg.kernel_size)
            normal_(lp.w_cond, cfg.cin_channels)
            normal_(lp.w_out, cfg.gate_channels // 2)
            normal_(lp.w_skip, cfg.gate_channels // 2)
        with torch.no_grad():
            for name, p in self.named_parameters():
                if name.split(".")[-1] in ("bias", "b_out", "b_skip"):
                    p.zero_()
            for j, scale in enumerate(cfg.upsample_scales):
                k = self.upsample[str(j)].kernel
                k.zero_()
                k[cfg.freq_axis_kernel_size // 2] = 1.0 / scale

    def upsample_conditioning(self, c: torch.Tensor) -> torch.Tensor:
        """Mel (B, Tc, C) -> (B, Tc * prod(scales), C): the stacked
        channel-shared transposed convs, each torch's ConvTranspose2d with
        kernel (kf, 2s), stride (1, s), padding (kf//2, s//2), applied with
        the JAX kernel as stored."""
        tc = c.shape[1]
        h = c.transpose(1, 2)[:, None]  # (B, 1, C, Tc)
        for j, scale in enumerate(self.cfg.upsample_scales):
            k = self.upsample[str(j)].kernel
            h = F.conv_transpose2d(h, k[None, None], stride=(1, scale), padding=(k.shape[0] // 2, scale // 2))
        return h[:, 0].transpose(1, 2)[:, : tc * math.prod(self.cfg.upsample_scales)]

    def apply(self, x: torch.Tensor, c: torch.Tensor, dtype: torch.dtype = torch.float32,
              scan: bool = False) -> torch.Tensor:
        """Teacher-forced forward: x (B, T, 1) in [-1, 1], mel c (B, Tc, 80)
        with Tc * 256 >= T -> MoL logits (B, T, 3K); sample t is predicted
        from x[:t] (the input is shifted right by one inside). With
        ``dtype=torch.bfloat16``, at the rounding points of bfloat16
        generation (``ops.wavenet``): the layer weights, cond, each layer's
        input and z rounded to bfloat16, the products summed in float32, or,
        with ``scan``, every op rounded as the scan rounding rounds it (no
        JAX counterpart: it checks the bfloat16 generation on its own
        waveform)."""
        cond = self.upsample_conditioning(c)[:, : x.shape[1]]
        x_in = F.pad(x[:, :-1], (0, 0, 1, 0))

        def shift(a: torch.Tensor, n: int) -> torch.Tensor:
            return F.pad(a[:, : a.shape[1] - n], (0, 0, n, 0)) if n else a

        if scan:
            if dtype != torch.bfloat16:
                raise ValueError(f"the scan rounding is a bfloat16 form, not {dtype}")
            return self._apply_scan(x_in, cond, shift)
        h = x_in @ self.first_conv.kernel + self.first_conv.bias

        def rd(a: torch.Tensor) -> torch.Tensor:  # rounded to dtype, computed on in float32
            return a.to(dtype).float()

        cond = rd(cond)
        skip = h.new_zeros(h.shape[:2] + (self.cfg.skip_channels,))
        for i, d in enumerate(self.cfg.dilations()):
            lp = self.layers[str(i)]
            h_in = rd(h)
            gates = (shift(h_in, 2 * d) @ rd(lp.w_prev2) + shift(h_in, d) @ rd(lp.w_prev1) + h_in @ rd(lp.w_cur)
                     + lp.bias + cond @ rd(lp.w_cond))
            a, b = gates.chunk(2, dim=-1)
            z = rd(torch.tanh(a) * torch.sigmoid(b))
            skip = (skip + (z @ rd(lp.w_skip) + lp.b_skip)) * SQRT_HALF
            h = (h + (z @ rd(lp.w_out) + lp.b_out)) * SQRT_HALF
        out = torch.relu(torch.relu(skip) @ self.last1.kernel + self.last1.bias)
        return out @ self.last2.kernel + self.last2.bias

    def _apply_scan(self, x_in: torch.Tensor, cond: torch.Tensor, shift) -> torch.Tensor:
        """The teacher-forced forward in the scan rounding of
        ``ops.wavenet`` (its notes), each product over the whole sequence."""
        rb = wavenet_ops._rb
        half = wavenet_ops.SQRT_HALF_BF16
        cond = rb(cond)
        h = rb(rb(rb(x_in) * rb(self.first_conv.kernel[0])) + rb(self.first_conv.bias))
        skip = h.new_zeros(h.shape[:2] + (self.cfg.skip_channels,))
        for i, d in enumerate(self.cfg.dilations()):
            lp = self.layers[str(i)]
            gates = rb(rb(shift(h, 2 * d) @ rb(lp.w_prev2)) + rb(shift(h, d) @ rb(lp.w_prev1)))
            gates = rb(rb(rb(gates + rb(h @ rb(lp.w_cur))) + rb(lp.bias)) + rb(cond @ rb(lp.w_cond)))
            a, b = gates.chunk(2, dim=-1)
            z = rb(rb(torch.tanh(a)) * wavenet_ops._sigmoid_scan(b))
            skip = rb(rb(skip + rb(rb(z @ rb(lp.w_skip)) + rb(lp.b_skip))) * half)
            h = rb(rb(h + rb(rb(z @ rb(lp.w_out)) + rb(lp.b_out))) * half)
        out = torch.relu(torch.relu(skip) @ self.last1.kernel + self.last1.bias)
        return out @ self.last2.kernel + self.last2.bias


ENGINES = ("scan", "pallas")  # the JAX package's engine names: which bfloat16 rounding generate runs


def discretized_mol_loss(logits: torch.Tensor, target: torch.Tensor, num_classes: int = 65536,
                         log_scale_min: float = WaveNetConfig.log_scale_min, reduce: bool = True) -> torch.Tensor:
    """The discretized mixture-of-logistics NLL, the WaveNet training loss
    (``autovc_tpu/vocoder/wavenet.py:200-236``): logits (..., 3K) = (mixture
    logits, means, log scales clamped at ``log_scale_min``), target (...,)
    in [-1, 1]. A target below -0.999 takes the log CDF at its bin's upper
    edge, one above 0.999 the log of 1 - the CDF at its lower edge, the rest
    the log of the bin's mass where that exceeds 1e-5, else the log density
    at the bin's centre times the bin width. The mean over all samples, or
    the (...,) NLLs when not ``reduce``."""
    k = logits.shape[-1] // 3
    logit_probs = logits[..., :k]
    means = logits[..., k : 2 * k]
    log_scales = torch.clamp(logits[..., 2 * k :], min=log_scale_min)
    t = target[..., None] - means
    inv_s = torch.exp(-log_scales)
    half = 1.0 / (num_classes - 1)
    plus_in, minus_in = inv_s * (t + half), inv_s * (t - half)
    cdf_delta = torch.sigmoid(plus_in) - torch.sigmoid(minus_in)
    mid = inv_s * t
    log_pdf_mid = mid - log_scales - 2.0 * F.softplus(mid)
    log_cdf_plus = plus_in - F.softplus(plus_in)
    log_one_minus_cdf_min = -F.softplus(minus_in)
    inner = torch.where(cdf_delta > 1e-5, torch.log(torch.clamp(cdf_delta, min=1e-12)),
                        log_pdf_mid - math.log((num_classes - 1) / 2))
    edge = target[..., None]
    log_probs = torch.where(edge < -0.999, log_cdf_plus, torch.where(edge > 0.999, log_one_minus_cdf_min, inner))
    log_probs = log_probs + torch.log_softmax(logit_probs, dim=-1)
    nll = -torch.logsumexp(log_probs, dim=-1)
    return nll.mean() if reduce else nll


class WaveNetVocoder:
    """The WaveNet entry point: weights from an exported JAX artifact
    (``artifacts/wavenet_105k.npz``, ``artifacts/wavenet_f16.npz``) or drawn
    from ``seed``, on ``device``. The kernel's weight layout is packed once
    here in float32 (``packed``), and once in bfloat16 at the first bfloat16
    call."""

    def __init__(self, cfg: WaveNetConfig = WaveNetConfig(), *, artifact: str | None = None,
                 device: str | torch.device = "cuda", seed: int = 0):
        self.cfg = cfg
        self.device = resolve_device(device)
        model = WaveNet(cfg)
        if artifact is None:
            model.reset_parameters(seed)
        else:
            model.load_state_dict(wavenet_state_from_jax(load_artifact(artifact)[0]))
        self.model = model.to(self.device).eval().requires_grad_(False)
        self.packed = wavenet_ops.pack_weights(self.model.state_dict(), cfg.layers)
        self._packs = {torch.float32: self.packed}

    def packed_for(self, dtype: torch.dtype) -> dict[str, torch.Tensor]:
        """The packed weights in ``dtype`` (float32 or bfloat16), made once."""
        if dtype not in self._packs:
            self._packs[dtype] = wavenet_ops.pack_weights(self.model.state_dict(), self.cfg.layers, dtype)
        return self._packs[dtype]

    @classmethod
    def from_checkpoint(cls, cfg: WaveNetConfig, path: str | None, *,
                        device: str | torch.device = "cuda") -> "WaveNetVocoder":
        """The JAX ``from_checkpoint(cfg, path)``: an exported ``.npz``
        artifact (f16 storage is upcast to f32), or weights drawn from seed 0
        when ``path`` is None. A torch checkpoint raises: its importer is not
        ported yet (ROADMAP Queue 1 #9)."""
        if path is not None and not path.endswith(".npz"):
            raise ValueError(f"only exported .npz artifacts load here, not {path!r}: the torch WaveNet importer "
                             f"is not ported yet (ROADMAP Queue 1 #9)")
        return cls(cfg, artifact=path, device=device)

    def uniforms(self, batch: int, length: int, generator: torch.Generator | None = None) -> torch.Tensor:
        """(B, T, K+1) uniforms in [1e-5, 1 - 1e-5], drawn on the CPU from
        ``generator`` (seed 0 when None) and moved to the vocoder's device."""
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        u = torch.rand((batch, length, self.cfg.out_channels // 3 + 1), generator=gen)
        return (u * (U_MAX - U_MIN) + U_MIN).to(self.device)

    @torch.inference_mode()
    def generate(self, mel: np.ndarray | torch.Tensor, uniforms: torch.Tensor | None = None,
                 generator: torch.Generator | None = None, dtype: torch.dtype = torch.float32,
                 engine: str = "scan") -> torch.Tensor:
        """mel (Tc, 80) or (B, Tc, 80), normalized -> waveform (Tc*256,) or
        (B, Tc*256), float32 on the vocoder's device. ``uniforms`` (B, T,
        K+1) is the random stream; without it one is drawn from
        ``generator``. ``dtype`` is the layer weights' (float32 or
        bfloat16), ``engine`` the JAX engine whose bfloat16 rounding runs
        (``autovc_tpu/vocoder/wavenet.py:409-477``: "scan", the default, or
        "pallas"; in float32 both are the one float32 kernel); the same
        uniforms give the same stream as the JAX engine's."""
        if engine not in ENGINES:
            raise ValueError(f"engine is one of {ENGINES}, not {engine!r}")
        mel = torch.as_tensor(mel, dtype=torch.float32, device=self.device)
        squeeze = mel.ndim == 2
        if squeeze:
            mel = mel[None]
        length = mel.shape[1] * self.cfg.hop_size
        if uniforms is None:
            uniforms = self.uniforms(mel.shape[0], length, generator)
        elif squeeze and uniforms.ndim == 2:
            uniforms = uniforms[None]
        uniforms = torch.as_tensor(uniforms, dtype=torch.float32, device=self.device)
        with exact_f32(self.device):
            cond = self.model.upsample_conditioning(mel)[:, :length]
            wav, _ = wavenet_ops.generate(self.packed_for(dtype), self.cfg.dilations(), cond, uniforms,
                                          self.cfg.log_scale_min, dtype == torch.bfloat16 and engine == "scan")
        return wav[0] if squeeze else wav

    def generate_bucketed(self, mel: np.ndarray | torch.Tensor, bucket: int = 64,
                          uniforms: torch.Tensor | None = None,
                          generator: torch.Generator | None = None,
                          dtype: torch.dtype = torch.float32, engine: str = "scan") -> torch.Tensor:
        """``generate`` on one (Tc, 80) mel padded (edge replication) to a
        multiple of ``bucket`` frames, the waveform trimmed back to Tc*256
        samples. ``uniforms`` covers the padded length; bucket=0 pads
        nothing."""
        mel = torch.as_tensor(mel, dtype=torch.float32)
        if mel.ndim != 2:
            raise ValueError(f"generate_bucketed takes a single (Tc, C) mel, got {tuple(mel.shape)}")
        t = mel.shape[0]
        pad = (-t) % bucket if bucket else 0
        if pad:
            mel = torch.cat([mel, mel[-1:].expand(pad, -1)])
        return self.generate(mel, uniforms, generator, dtype, engine)[: t * self.cfg.hop_size]

    @torch.inference_mode()
    def logits(self, x: torch.Tensor, mel: torch.Tensor, dtype: torch.dtype = torch.float32,
               scan: bool = False) -> torch.Tensor:
        """Teacher-forced MoL logits (B, T, 3K) of waveform x (B, T, 1), at
        the rounding points of generation in ``dtype`` (``scan``: the scan
        rounding's)."""
        with exact_f32(self.device):
            return self.model.apply(x, mel, dtype, scan)
