"""Artifact loading and the JAX-parameter -> PyTorch state-dict mapping.

Artifacts are flat ``.npz`` files written by the JAX package
(``autovc_tpu/cli/export_ckpt.py``): keys ``params/...`` and
``batch_stats/...`` joined by ``/``, an optional ``__step__``, weights
possibly stored as float16. ``load_artifact`` returns the nested tree as
float32 numpy arrays; ``generator_state_from_jax`` and
``hifigan_state_from_jax`` turn a tree into the state dict of this package's
``Generator`` and ``HiFiGANGenerator``, and ``generator_state_to_jax`` turns
a ``Generator`` state dict back into the JAX tree, which
``save_generator_artifact`` writes in the JAX artifact schema (what
``cli/train.py --export`` writes); ``wavenet_state_from_jax`` turns the
flat WaveNet artifact (no ``params/`` level) into the state dict of
``autovc_tpu_torch.vocoder.wavenet.WaveNet``; ``dvector_state_from_jax``
and ``dvector_state_to_jax`` map a GE2E d-vector tree to the state dict of
``autovc_tpu_torch.models.DVector`` and back. ``hifigan_state_from_jax`` and
``conv_state_to_jax`` carry the HiFiGAN generator and its discriminators
both ways (the trainers' checkpoints), ``state_to_flat`` the
WaveNet and the d-vector back, and ``jax_leaf_order`` gives the order of a
JAX tree's leaves, in which the trainers' ``.npz`` train states store their
optimizer states.

Layouts (JAX -> this package):

- conv kernel ``(k, in, out)`` -> ``(out, in, k)`` (``F.conv1d``), a 2-D
  conv's ``(kh, kw, in, out)`` -> ``(out, in, kh, kw)`` (``F.conv2d``);
- transposed-conv kernel ``(k, out, in)`` -> ``(in, out, k)``
  (``F.conv_transpose1d``): the same axis reversal, no flip along k;
- dense kernel ``(in, out)`` -> ``(out, in)`` (``F.linear``);
- BatchNorm ``scale``/``bias``/``mean``/``var`` -> ``weight``/``bias``/
  ``running_mean``/``running_var``;
- LSTM ``w_ih_l{k}_{d}`` ``(in, 4H)``, ``w_hh_l{k}_{d}`` ``(H, 4H)`` and
  ``b_l{k}_{d}`` ``(4H,)`` are kept as they are, gate order i, f, g, o along
  the 4H axis: the input product is ``x @ w_ih + b`` and the CUDA kernel
  reads ``w_hh`` row-major, row ``k`` holding the four gates' columns
  ``g*H + j`` of every hidden unit ``j``.

The WaveNet's leaves keep their JAX names and layouts (dense ``(in, out)``,
``first_conv/kernel`` ``(1, R)``, ``upsample/<j>/kernel`` ``(kf, 2s)``): the
CUDA generation kernel reads the layer matrices row-major as the Pallas kernel
did, and ``/`` becomes ``.``.

Flax wraps each conv, dense and BatchNorm in a child named ``Conv_0``,
``Dense_0`` or ``BatchNorm_0``; those path segments are dropped. The wav
variant's ConvTasNet convolutions have no wrapper, and its PReLU slopes
(``prelu{i}/alpha``) keep their names.

bfloat16 is a compute dtype here, not a weight format: every mapping keeps
the float32 parameters, and the bfloat16 paths (``ModelConfig.compute_dtype``,
``HiFiGANVocoder(dtype=...)``, ``WaveNetVocoder.generate(dtype=...)``) cast
them at compute time, as the JAX package does.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

_WRAPPERS = ("Conv_0", "Dense_0", "BatchNorm_0")
_LEAF_NAMES = {"kernel": "weight", "scale": "weight", "mean": "running_mean", "var": "running_var"}


def unflatten_params(flat: Mapping[str, np.ndarray]) -> dict:
    """``{'a/b/c': x}`` -> ``{'a': {'b': {'c': x}}}``."""
    out: dict = {}
    for key, value in flat.items():
        parts = key.split("/")
        node = out
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return out


def flatten_params(tree: Mapping, prefix: str = "") -> dict[str, np.ndarray]:
    """The inverse of ``unflatten_params``."""
    out: dict[str, np.ndarray] = {}
    for key, value in tree.items():
        path = f"{prefix}/{key}" if prefix else key
        if isinstance(value, Mapping):
            out.update(flatten_params(value, path))
        else:
            out[path] = np.asarray(value)
    return out


def load_artifact(path: str) -> tuple[dict, int]:
    """(tree, step) from an exported ``.npz``: ``__step__`` popped (-1 when
    absent), float16 storage upcast to float32."""
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    step = int(flat.pop("__step__", -1))
    flat = {k: v.astype(np.float32) if v.dtype == np.float16 else v for k, v in flat.items()}
    return unflatten_params(flat), step


def _kernel_to_torch(arr: np.ndarray) -> np.ndarray:
    """A flax kernel in the PyTorch layout: a 2-D conv's ``(kh, kw, in,
    out)`` -> ``(out, in, kh, kw)``, a 1-D conv's ``(k, in, out)`` -> ``(out,
    in, k)``, a dense ``(in, out)`` -> ``(out, in)``."""
    if arr.ndim == 4:
        return arr.transpose(3, 2, 0, 1)
    return arr.transpose(2, 1, 0) if arr.ndim == 3 else arr.T


def _kernel_to_jax(arr: np.ndarray) -> np.ndarray:
    """The inverse of ``_kernel_to_torch``."""
    if arr.ndim == 4:
        return arr.transpose(2, 3, 1, 0)
    return arr.transpose(2, 1, 0) if arr.ndim == 3 else arr.T


def _leaf_to_torch(path: str, value: np.ndarray) -> tuple[str, torch.Tensor]:
    parts = [p for p in path.split("/") if p not in _WRAPPERS]
    leaf = parts[-1]
    arr = np.asarray(value, np.float32)
    if leaf == "kernel":
        arr = _kernel_to_torch(arr)
    parts[-1] = _LEAF_NAMES.get(leaf, leaf)
    return ".".join(parts), torch.from_numpy(np.array(arr, order="C"))  # a writable copy


def generator_state_from_jax(variables: Mapping) -> dict[str, torch.Tensor]:
    """``{'params': ..., 'batch_stats': ...}`` of the JAX ``Generator`` or
    ``GeneratorWav`` -> state dict of ``autovc_tpu_torch.models.Generator``
    or ``GeneratorWav``."""
    state: dict[str, torch.Tensor] = {}
    for collection in ("params", "batch_stats"):
        for path, value in flatten_params(variables[collection]).items():
            key, tensor = _leaf_to_torch(path, value)
            state[key] = tensor
    return state


_WRAPPER_BY_NDIM = {3: "Conv_0", 2: "Dense_0", 1: "BatchNorm_0"}
_JAX_LEAF = {"running_mean": "mean", "running_var": "var"}


_BARE_CONVS = ("tas_encoder.", "tas_decoder.")


def _wrapper(key: str, weight: torch.Tensor) -> str | None:
    """The flax wrapper of the module owning ``weight``: 3-D a conv, 2-D a
    dense layer, 1-D a BatchNorm, but for the ConvTasNet front and back end,
    whose convolutions (a bare ``nn.Conv`` and ``layers.ConvTranspose1d``)
    hold their kernel directly."""
    if weight.ndim == 3 and key.startswith(_BARE_CONVS):
        return None
    return _WRAPPER_BY_NDIM[weight.ndim]


def generator_state_to_jax(state: Mapping[str, torch.Tensor]) -> dict:
    """State dict of ``autovc_tpu_torch.models.Generator`` or
    ``GeneratorWav`` -> ``{'params': ..., 'batch_stats': ...}`` of the JAX
    ``Generator`` or ``GeneratorWav``, float32 numpy in JAX layouts: the
    inverse of ``generator_state_from_jax``. A module's flax wrapper follows
    from its ``weight`` (``_wrapper``); the LSTM leaves and the PReLU slopes
    (``alpha``) have none."""
    wrappers = {key.rsplit(".", 1)[0]: _wrapper(key, v) for key, v in state.items() if key.endswith(".weight")}
    flat: dict[str, np.ndarray] = {}
    for key, value in state.items():
        module, leaf = key.rsplit(".", 1)
        arr = value.detach().cpu().numpy().astype(np.float32)
        wrapper = wrappers.get(module)
        collection = "batch_stats" if leaf in _JAX_LEAF else "params"
        if leaf == "weight":
            leaf = "scale" if wrapper == "BatchNorm_0" else "kernel"
            arr = arr.transpose(2, 1, 0) if arr.ndim == 3 else arr.T
        leaf = _JAX_LEAF.get(leaf, leaf)
        parts = [collection, *module.split("."), *([wrapper] if wrapper else []), leaf]
        flat["/".join(parts)] = np.ascontiguousarray(arr)
    return unflatten_params(flat)


def save_generator_artifact(state: Mapping[str, torch.Tensor], step: int, path: str) -> None:
    """Write a ``Generator`` or ``GeneratorWav`` state dict as the JAX CLI's
    ``--export`` does: a flat ``.npz`` of ``params/...`` and
    ``batch_stats/...`` in the JAX layouts plus ``__step__``, which
    ``load_artifact`` (and the JAX package's) reads back."""
    tree = generator_state_to_jax(state)
    flat = {**flatten_params(tree["params"], "params"), **flatten_params(tree["batch_stats"], "batch_stats")}
    np.savez(path, **flat, __step__=np.asarray(step, np.int64))


def hifigan_state_from_jax(params: Mapping) -> dict[str, torch.Tensor]:
    """The JAX ``HiFiGANGenerator`` params (no collection level, as the
    vocoder artifact stores them) -> state dict of
    ``autovc_tpu_torch.vocoder.hifigan.HiFiGANGenerator``; the same for the
    JAX ``HiFiGANDiscriminators`` params (``mpd{p}/conv{i}``, 2-D kernels
    ``(kh, kw, in, out)``; ``msd{i}/conv{i}``) and the port's
    ``vocoder.discriminators.HiFiGANDiscriminators``."""
    return dict(_leaf_to_torch(path, value) for path, value in flatten_params(params).items())


def conv_state_to_jax(state: Mapping[str, torch.Tensor]) -> dict[str, np.ndarray]:
    """State dict of ``HiFiGANGenerator`` or ``vocoder.discriminators
    .HiFiGANDiscriminators`` -> the flat JAX parameters (``'pre/kernel'``,
    ``'mpd2/conv0/kernel'``, ...), float32 numpy in the flax layouts (the
    inverse of ``hifigan_state_from_jax``). ``np.savez(path, **it)`` is the
    ``.npz`` the JAX package's ``HiFiGANVocoder.from_checkpoint`` reads."""
    flat = {}
    for key, value in state.items():
        module, leaf = key.rsplit(".", 1)
        arr = value.detach().cpu().numpy().astype(np.float32)
        if leaf == "weight":
            leaf, arr = "kernel", _kernel_to_jax(arr)
        flat[f"{module.replace('.', '/')}/{leaf}"] = np.ascontiguousarray(arr)
    return flat


def jax_leaf_order(paths) -> list[str]:
    """The order ``jax.tree_util.tree_leaves`` gives the leaves of a tree of
    nested dicts with these ``/`` paths: each level's keys sorted."""
    return sorted(paths, key=lambda p: p.split("/"))


def _flat_state(tree: Mapping) -> dict[str, torch.Tensor]:
    """A nested numpy tree -> a state dict of float32 C-order tensors, its
    names the tree's paths with '.' for '/', layouts unchanged."""
    return {
        path.replace("/", "."): torch.from_numpy(np.array(value, np.float32, order="C"))
        for path, value in flatten_params(tree).items()
    }


def wavenet_state_from_jax(tree: Mapping) -> dict[str, torch.Tensor]:
    """The JAX WaveNet parameter tree (``first_conv``, ``layers/<i>``,
    ``last1``, ``last2``, ``upsample/<j>``) -> state dict of
    ``autovc_tpu_torch.vocoder.wavenet.WaveNet``, layouts unchanged."""
    return _flat_state(tree)


def state_to_flat(state: Mapping[str, torch.Tensor]) -> dict[str, np.ndarray]:
    """A state dict whose leaves keep the JAX layouts (``WaveNet``,
    ``DVector``) -> the flat JAX parameters, ``.`` becoming ``/``: the
    inverse of ``wavenet_state_from_jax``. ``np.savez(path, **it)`` is the
    ``.npz`` the JAX package's ``WaveNetVocoder.from_checkpoint`` reads."""
    return {key.replace(".", "/"): np.ascontiguousarray(value.detach().cpu().numpy().astype(np.float32))
            for key, value in state.items()}


def dvector_state_from_jax(params: Mapping) -> dict[str, torch.Tensor]:
    """A GE2E tree (``{'dvector', 'w', 'b'}``, the layout of
    ``artifacts/ge2e*.npz``) or bare ``DVector`` params -> state dict of
    ``autovc_tpu_torch.models.DVector``, names and layouts unchanged (the
    LSTM leaves as ``layers.LSTM`` keeps them, the dense kernel (in, out))."""
    return _flat_state(params.get("dvector", params))


def dvector_state_to_jax(state: Mapping[str, torch.Tensor]) -> dict:
    """State dict of ``autovc_tpu_torch.models.DVector`` -> bare ``DVector``
    params of the JAX package (float32 numpy): the inverse of
    ``dvector_state_from_jax``. ``{'dvector': ...}`` of it, flattened, is a
    GE2E ``.npz`` that both packages load."""
    return unflatten_params({key.replace(".", "/"): value.detach().cpu().numpy().astype(np.float32)
                             for key, value in state.items()})


def save_dvector_artifact(state: Mapping[str, torch.Tensor], path: str) -> None:
    """Write a ``DVector`` state dict as a GE2E checkpoint ``.npz``: the flat
    ``dvector/...`` leaves in the JAX layouts, which ``train.ge2e.load_params``
    (and the JAX package's ``GE2ETrainer.load_params``) read back. The GE2E
    loss's scale and offset (``w``, ``b``), which only training reads, are
    not written."""
    np.savez(path, **flatten_params({"dvector": dvector_state_to_jax(state)}))
