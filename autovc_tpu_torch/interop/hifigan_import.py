"""Import public torch HiFi-GAN generator checkpoints (counterpart of
``autovc_tpu/interop/hifigan_import.py``).

The canonical public implementation stores the generator under module names
conv_pre / ups.{i} / resblocks.{k}.convs1.{j} / resblocks.{k}.convs2.{j} /
conv_post, all weight-normalized (weight_g/weight_v). This maps such a state
dict onto the JAX HiFiGANGenerator's parameter tree (weight norm folded into
dense kernels), which ``io.hifigan_state_from_jax`` loads into the port's
``vocoder.hifigan.HiFiGANGenerator``.

Layout notes:
  torch Conv1d weight (out, in, k)          -> flax Conv kernel (k, in, out)
  torch ConvTranspose1d weight (in, out, k) -> the JAX ConvTranspose1d (k, out, in)
  resblocks are ordered k = i*len(kernel_sizes) + j for upsample stage i and
  resblock j (generator construction order in the public repo).
"""

from __future__ import annotations

from typing import Mapping

from autovc_tpu_torch.config import HiFiGANConfig
from autovc_tpu_torch.interop._torch_utils import resolve_weight, to_np


def _conv(sd: Mapping, prefix: str) -> dict:
    # torch Conv1d (out, in, k) -> (k, in, out); torch ConvTranspose1d
    # (in, out, k) -> the JAX (k, out, in): the same transpose(2, 1, 0)
    return {
        "kernel": resolve_weight(sd, prefix).transpose(2, 1, 0),
        "bias": to_np(sd[prefix + ".bias"]),
    }


def hifigan_params_from_torch(sd: Mapping, cfg: HiFiGANConfig = HiFiGANConfig()) -> dict:
    """Public HiFi-GAN generator state dict -> params for HiFiGANGenerator."""
    if any(k.startswith("generator.") for k in sd):
        sd = {k[len("generator."):]: v for k, v in sd.items() if k.startswith("generator.")}

    params: dict = {"pre": _conv(sd, "conv_pre"), "post": _conv(sd, "conv_post")}
    n_res = len(cfg.resblock_kernel_sizes)
    for i in range(len(cfg.upsample_rates)):
        params[f"up{i}"] = _conv(sd, f"ups.{i}")
        for j in range(n_res):
            k = i * n_res + j
            block: dict = {}
            for conv_set in ("convs1", "convs2"):
                name = "conv1" if conv_set == "convs1" else "conv2"
                for d in range(len(cfg.resblock_dilations[j])):
                    block[f"{name}_{d}"] = _conv(sd, f"resblocks.{k}.{conv_set}.{d}")
            params[f"res{i}_{j}"] = block
    return params
