"""Import r9y9 wavenet_vocoder torch checkpoints (the reference's
checkpoint_step001000000_ema.pth, driven via synthesis.py:19-40) into the
JAX WaveNet's parameter tree, which ``io.wavenet_state_from_jax`` loads into
the port's ``vocoder.wavenet.WaveNet`` (counterpart of
``autovc_tpu/interop/wavenet_import.py``).

r9y9 module paths:
  first_conv.{weight (R,1,1), bias}
  conv_layers.{i}.conv.{weight (G,R,3), bias}          (dilated conv)
  conv_layers.{i}.conv1x1c.weight (G,C,1)              (mel conditioning)
  conv_layers.{i}.conv1x1_out.{weight (R,G/2,1), bias}
  conv_layers.{i}.conv1x1_skip.{weight (S,G/2,1), bias}
  last_conv_layers.{1,3}.{weight, bias}
  upsample_conv.{0,2,4,6}.weight (1,1,kf,kt)           (ConvTranspose2d)
Weight-normalized checkpoints store weight_g/weight_v; they are folded.
"""

from __future__ import annotations

from typing import Mapping

from autovc_tpu_torch.config import WaveNetConfig
from autovc_tpu_torch.interop._torch_utils import resolve_weight as _weight
from autovc_tpu_torch.interop._torch_utils import to_np as _np


def wavenet_params_from_torch(sd: Mapping, cfg: WaveNetConfig) -> dict:
    params: dict = {"layers": {}, "upsample": {}}

    w = _weight(sd, "first_conv")  # (R, 1, 1)
    params["first_conv"] = {"kernel": w[:, :, 0].T, "bias": _np(sd["first_conv.bias"])}

    for i in range(cfg.layers):
        p = f"conv_layers.{i}"
        wk = _weight(sd, f"{p}.conv")  # (G, R, 3): taps [t-2d, t-d, t]
        cond = _weight(sd, f"{p}.conv1x1c")  # (G, C, 1)
        wout = _weight(sd, f"{p}.conv1x1_out")  # (R, G/2, 1)
        wskip = _weight(sd, f"{p}.conv1x1_skip")  # (S, G/2, 1)
        params["layers"][str(i)] = {
            "w_prev2": wk[:, :, 0].T,
            "w_prev1": wk[:, :, 1].T,
            "w_cur": wk[:, :, 2].T,
            "bias": _np(sd[f"{p}.conv.bias"]),
            "w_cond": cond[:, :, 0].T,
            "w_out": wout[:, :, 0].T,
            "b_out": _np(sd[f"{p}.conv1x1_out.bias"]),
            "w_skip": wskip[:, :, 0].T,
            "b_skip": _np(sd[f"{p}.conv1x1_skip.bias"]),
        }

    w1 = _weight(sd, "last_conv_layers.1")
    w3 = _weight(sd, "last_conv_layers.3")
    params["last1"] = {"kernel": w1[:, :, 0].T, "bias": _np(sd["last_conv_layers.1.bias"])}
    params["last2"] = {"kernel": w3[:, :, 0].T, "bias": _np(sd["last_conv_layers.3.bias"])}

    # upsample convs sit at even indices of the Sequential (odd are ReLU)
    j = 0
    for idx in range(16):
        p = f"upsample_conv.{idx}"
        if any(
            k in sd
            for k in (p + ".weight", p + ".weight_g", p + ".parametrizations.weight.original0")
        ):
            w = _weight(sd, f"upsample_conv.{idx}")  # (1, 1, kf, kt)
            params["upsample"][str(j)] = {"kernel": w[0, 0]}
            j += 1
    return params
