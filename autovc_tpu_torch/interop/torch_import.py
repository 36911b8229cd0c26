"""Torch-checkpoint interop: the reference's state dicts as the JAX
package's parameter trees (counterpart of ``autovc_tpu/interop/torch_import.py``).

Users of the reference load their trained .ckpt files
(solver_encoder.py:334-346 format: {'epoch', 'state_dict', 'optimizer',
'loss'}) through these trees: the weight bridge (``io.generator_state_from_jax``,
``io.dvector_state_from_jax``) loads them into the port's modules, and
``cli.import_torch`` writes them as a Solver checkpoint.

All functions take a dict of numpy arrays or torch tensors (a state dict)
and return float32 numpy trees in the JAX layouts.

Layout mapping:
  torch Conv1d weight (out, in, k)      -> flax Conv kernel (k, in, out)
  torch Linear weight (out, in)         -> flax Dense kernel (in, out)
  torch LSTM weight_ih_l{k}[_reverse]   -> w_ih_l{k}_{fwd|bwd} transposed
  torch LSTM bias_ih + bias_hh          -> single bias b_l{k}_{d}
  torch BatchNorm1d                     -> flax BatchNorm scale/bias + stats
  torch ConvTranspose1d weight (in, out, k) -> the JAX kernel (k, out, in)
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np

from autovc_tpu_torch.interop._torch_utils import to_np as _np


def convert_conv(sd: Mapping[str, Any], prefix: str) -> dict:
    out = {"kernel": _np(sd[prefix + ".weight"]).transpose(2, 1, 0)}
    if prefix + ".bias" in sd:
        out["bias"] = _np(sd[prefix + ".bias"])
    return out


def convert_conv_transpose(sd: Mapping[str, Any], prefix: str) -> dict:
    # torch ConvTranspose1d weight: (in, out, k) -> the JAX layout (k, out, in)
    out = {"kernel": _np(sd[prefix + ".weight"]).transpose(2, 1, 0)}
    if prefix + ".bias" in sd:
        out["bias"] = _np(sd[prefix + ".bias"])
    return out


def convert_linear(sd: Mapping[str, Any], prefix: str) -> dict:
    out = {"kernel": _np(sd[prefix + ".weight"]).T}
    if prefix + ".bias" in sd:
        out["bias"] = _np(sd[prefix + ".bias"])
    return out


def convert_bn(sd: Mapping[str, Any], prefix: str) -> tuple[dict, dict]:
    params = {"scale": _np(sd[prefix + ".weight"]), "bias": _np(sd[prefix + ".bias"])}
    stats = {
        "mean": _np(sd[prefix + ".running_mean"]),
        "var": _np(sd[prefix + ".running_var"]),
    }
    return params, stats


def convert_lstm(sd: Mapping[str, Any], prefix: str, num_layers: int, bidirectional: bool) -> dict:
    """torch nn.LSTM params -> the ``layers.LSTM`` param dict."""
    out: dict = {}
    p = prefix + "." if prefix else ""
    dirs = [("", "fwd"), ("_reverse", "bwd")] if bidirectional else [("", "fwd")]
    for layer in range(num_layers):
        for suf, d in dirs:
            out[f"w_ih_l{layer}_{d}"] = _np(sd[f"{p}weight_ih_l{layer}{suf}"]).T
            out[f"w_hh_l{layer}_{d}"] = _np(sd[f"{p}weight_hh_l{layer}{suf}"]).T
            out[f"b_l{layer}_{d}"] = _np(sd[f"{p}bias_ih_l{layer}{suf}"]) + _np(
                sd[f"{p}bias_hh_l{layer}{suf}"]
            )
    return out


def _strip(sd: Mapping[str, Any], prefix: str) -> dict:
    """Strip a prefix (e.g. DataParallel's 'module.', make_metadata.py:44-47)."""
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def generator_params_from_torch(
    sd: Mapping[str, Any], with_postnet: bool | None = None
) -> tuple[dict, dict]:
    """Reference Generator state_dict -> (params, batch_stats) for models.autovc.Generator.

    Reference module paths (model_vc_mel.py):
      encoder.convolutions.{i}.0.conv / .1 (BN); encoder.lstm
      decoder.lstm1; decoder.convolutions.{i}.0.conv / .1; decoder.lstm2;
      decoder.linear_projection.linear_layer
      postnet.convolutions.{i}.0.conv / .1
    Also accepts GeneratorSTFT checkpoints (same tree under 'model.').
    """
    if any(k.startswith("model.") for k in sd):
        sd = _strip(sd, "model.")
    if with_postnet is None:
        with_postnet = any(k.startswith("postnet.") for k in sd)

    params: dict = {"encoder": {}, "decoder": {}}
    stats: dict = {"encoder": {}, "decoder": {}}

    for i in range(3):
        params["encoder"][f"conv{i}"] = {
            "Conv_0": convert_conv(sd, f"encoder.convolutions.{i}.0.conv")
        }
        p, s = convert_bn(sd, f"encoder.convolutions.{i}.1")
        params["encoder"][f"bn{i}"] = {"BatchNorm_0": p}
        stats["encoder"][f"bn{i}"] = {"BatchNorm_0": s}
    params["encoder"]["blstm"] = convert_lstm(sd, "encoder.lstm", 2, True)

    params["decoder"]["lstm1"] = convert_lstm(sd, "decoder.lstm1", 1, False)
    for i in range(3):
        params["decoder"][f"conv{i}"] = {
            "Conv_0": convert_conv(sd, f"decoder.convolutions.{i}.0.conv")
        }
        p, s = convert_bn(sd, f"decoder.convolutions.{i}.1")
        params["decoder"][f"bn{i}"] = {"BatchNorm_0": p}
        stats["decoder"][f"bn{i}"] = {"BatchNorm_0": s}
    params["decoder"]["lstm2"] = convert_lstm(sd, "decoder.lstm2", 2, False)
    params["decoder"]["proj"] = {
        "Dense_0": convert_linear(sd, "decoder.linear_projection.linear_layer")
    }

    if with_postnet:
        params["postnet"] = {}
        stats["postnet"] = {}
        for i in range(5):
            params["postnet"][f"conv{i}"] = {
                "Conv_0": convert_conv(sd, f"postnet.convolutions.{i}.0.conv")
            }
            p, s = convert_bn(sd, f"postnet.convolutions.{i}.1")
            params["postnet"][f"bn{i}"] = {"BatchNorm_0": p}
            stats["postnet"][f"bn{i}"] = {"BatchNorm_0": s}

    return params, stats


def generator_wav_params_from_torch(sd: Mapping[str, Any]) -> tuple[dict, dict]:
    """Reference GeneratorWav state_dict -> (params, batch_stats) for
    models.convtas.GeneratorWav (module paths per model_vc_wav.py)."""
    core_params, core_stats = generator_params_from_torch(sd)
    # core decoder projection in the wav model maps to 512 channels
    params = {
        "encoder": core_params["encoder"],
        "decoder": core_params["decoder"],
        "tas_encoder": {},
        "tas_decoder": {},
    }
    stats = {
        "encoder": core_stats["encoder"],
        "decoder": core_stats["decoder"],
        "tas_encoder": {},
        "tas_decoder": {},
    }

    te, td = params["tas_encoder"], params["tas_decoder"]
    te["conv_in"] = convert_conv(sd, "tasEncoder.conv1x1")
    depth = len({k.split(".")[2] for k in sd if k.startswith("tasEncoder.convD.")})
    for i in range(depth):
        te[f"conv{i}"] = convert_conv(sd, f"tasEncoder.convD.{i}.0")
        te[f"prelu{i}"] = {"alpha": _np(sd[f"tasEncoder.convD.{i}.1.weight"])}
        p, s = convert_bn(sd, f"tasEncoder.convD.{i}.2")
        stats["tas_encoder"][f"bn{i}"] = {"BatchNorm_0": s}
        te[f"bn{i}"] = {"BatchNorm_0": p}

        td[f"convT{i}"] = convert_conv_transpose(sd, f"tasDecoder.convTD.{i}.0")
        td[f"prelu{i}"] = {"alpha": _np(sd[f"tasDecoder.convTD.{i}.1.weight"])}
        p, s = convert_bn(sd, f"tasDecoder.convTD.{i}.2")
        stats["tas_decoder"][f"bn{i}"] = {"BatchNorm_0": s}
        td[f"bn{i}"] = {"BatchNorm_0": p}
    td["convT_out"] = convert_conv_transpose(sd, "tasDecoder.convT1x1")

    return params, stats


def dvector_params_from_torch(sd: Mapping[str, Any]) -> dict:
    """Reference D_VECTOR state_dict (model_bl.py; 'module.'-prefixed in the
    3000000-BL.ckpt) -> params of the JAX models.dvector.DVector."""
    if any(k.startswith("module.") for k in sd):
        sd = _strip(sd, "module.")
    return {
        "lstm": convert_lstm(sd, "lstm", 3, False),
        "embedding": convert_linear(sd, "embedding"),
    }
