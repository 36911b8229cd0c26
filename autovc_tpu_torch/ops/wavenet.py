"""Autoregressive WaveNet generation: the CUDA kernel and its plain PyTorch
version.

Counterpart of ``autovc_tpu/ops/pallas_wavenet.py::generate_pallas`` (both
ring variants) and of the eager scan ``_generate_scan`` in
``autovc_tpu/vocoder/wavenet.py``. For each output sample t and each layer
with dilation d, the layer input h and the ring of the layer's last 2d inputs
give

    gates = [x(t-2d), x(t-d), h] @ w3 + cond_t @ wcond + bias      (B, G)
    z     = tanh(gates[:, :G/2]) * sigmoid(gates[:, G/2:])
    skip  = (skip + z @ wskip + b_skip) * sqrt(0.5)
    h     = (h + z @ wout + b_out) * sqrt(0.5)

where ring slot ``t mod 2d`` holds x(t-2d), slot ``(t+d) mod 2d`` holds
x(t-d), and the layer input is stored into slot ``t mod 2d`` after both reads.
The first layer's input is ``x_prev * fk + fb``; after the last layer the MoL
head (relu -> last1 -> relu -> last2) gives the logits and
``sample_from_mol_uniforms`` draws x_t from the caller's uniforms. Rings start
at zero and x_prev at t=0 is 0.

``generate`` launches the kernel in ``csrc/wavenet_gen.cu`` for a CUDA tensor
and runs ``generate_ref`` for a CPU tensor; there is no fallback from one to
the other.
"""

from __future__ import annotations

import ctypes
import math
from typing import Mapping, Sequence

import torch

from autovc_tpu_torch.ops import _build

SQRT_HALF = math.sqrt(0.5)
LOG_SCALE_MIN = -32.23619130191664
U_MIN, U_MAX = 1e-5, 1.0 - 1e-5

# Calls of generate that launched the CUDA kernels (one call = one utterance
# batch). Callers reset it to 0 and read it back.
launches = 0
# CUDA kernel launches made by the last call of generate_cuda: T * (2L + 1).
last_cuda_launches = 0

PACKED_KEYS = ("w3", "wcond", "wout", "wskip", "bg", "bo", "bs", "fk", "fb", "l1k", "l1b", "l2k", "l2b")


def pack_weights(state: Mapping[str, torch.Tensor], n_layers: int) -> dict[str, torch.Tensor]:
    """The WaveNet state dict (JAX names, ``layers.<i>.w_prev2`` ...) ->
    the kernel's float32 layout, counterpart of ``pallas_wavenet.pack_weights``:
    w3 (L, 3R, G) = [w_prev2; w_prev1; w_cur], wcond (L, C, G), wout (L, G/2, R),
    wskip (L, G/2, S), biases bg (L, G), bo (L, R), bs (L, S), first conv fk,
    fb (R,), head l1k (S, S), l1b (S,), l2k (S, 3K), l2b (3K,)."""
    f32 = lambda key: state[key].detach().float()
    layer = lambda i, name: f32(f"layers.{i}.{name}")
    stack = lambda name: torch.stack([layer(i, name) for i in range(n_layers)]).contiguous()
    return {
        "w3": torch.stack([
            torch.cat([layer(i, "w_prev2"), layer(i, "w_prev1"), layer(i, "w_cur")]) for i in range(n_layers)
        ]).contiguous(),
        "wcond": stack("w_cond"),
        "wout": stack("w_out"),
        "wskip": stack("w_skip"),
        "bg": stack("bias"),
        "bo": stack("b_out"),
        "bs": stack("b_skip"),
        "fk": f32("first_conv.kernel")[0].contiguous(),
        "fb": f32("first_conv.bias").contiguous(),
        "l1k": f32("last1.kernel").contiguous(),
        "l1b": f32("last1.bias").contiguous(),
        "l2k": f32("last2.kernel").contiguous(),
        "l2b": f32("last2.bias").contiguous(),
    }


def sample_from_mol_uniforms(logits: torch.Tensor, uniforms: torch.Tensor, log_scale_min: float) -> torch.Tensor:
    """Sample from MoL logits (..., 3K) given uniforms (..., K+1): Gumbel-max
    mixture choice (ties to the first index), then a logistic sample from the
    chosen mixture, clipped to [-1, 1]."""
    k = logits.shape[-1] // 3
    logit_probs, means = logits[..., :k], logits[..., k:2 * k]
    log_scales = torch.clamp(logits[..., 2 * k:], min=log_scale_min)
    u_sel = torch.clamp(uniforms[..., :k], U_MIN, U_MAX)
    u_x = torch.clamp(uniforms[..., k], U_MIN, U_MAX)
    sel = torch.argmax(logit_probs - torch.log(-torch.log(u_sel)), dim=-1, keepdim=True)
    mu = torch.gather(means, -1, sel)[..., 0]
    log_s = torch.gather(log_scales, -1, sel)[..., 0]
    x = mu + torch.exp(log_s) * (torch.log(u_x) - torch.log1p(-u_x))
    return torch.clamp(x, -1.0, 1.0)


def generate_ref(packed: Mapping[str, torch.Tensor], dilations: Sequence[int], cond: torch.Tensor,
                 uniforms: torch.Tensor, log_scale_min: float = LOG_SCALE_MIN) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version: a Python loop over samples and layers in float32.
    cond (B, T, C), uniforms (B, T, K+1) -> samples (B, T), logits (B, T, 3K)."""
    b, t, _ = cond.shape
    cond, uniforms = cond.float(), uniforms.float()
    r, g2, s = packed["fk"].shape[0], packed["wout"].shape[1], packed["wskip"].shape[-1]
    rings = [cond.new_zeros((b, 2 * d, r)) for d in dilations]
    x_prev = cond.new_zeros(b)
    ys, all_logits = [], []
    for step in range(t):
        h = x_prev[:, None] * packed["fk"] + packed["fb"]
        skip = cond.new_zeros((b, s))
        c_t = cond[:, step]
        for i, d in enumerate(dilations):
            slot, slot_d = step % (2 * d), (step + d) % (2 * d)
            x_all = torch.cat([rings[i][:, slot], rings[i][:, slot_d], h], dim=-1)
            gates = x_all @ packed["w3"][i] + c_t @ packed["wcond"][i] + packed["bg"][i]
            z = torch.tanh(gates[:, :g2]) * torch.sigmoid(gates[:, g2:])
            skip = (skip + (z @ packed["wskip"][i] + packed["bs"][i])) * SQRT_HALF
            new_h = (h + (z @ packed["wout"][i] + packed["bo"][i])) * SQRT_HALF
            rings[i][:, slot] = h
            h = new_h
        out = torch.relu(torch.relu(skip) @ packed["l1k"] + packed["l1b"])
        logits = out @ packed["l2k"] + packed["l2b"]
        x_prev = sample_from_mol_uniforms(logits, uniforms[:, step], log_scale_min)
        ys.append(x_prev)
        all_logits.append(logits)
    return torch.stack(ys, dim=1), torch.stack(all_logits, dim=1)


def _library() -> ctypes.CDLL:
    lib = _build.load("wavenet_gen")
    fn = lib.autovc_wavenet_gen
    fn.argtypes = ([ctypes.c_void_p] * 22 + [ctypes.c_void_p] + [ctypes.c_int] * 8
                   + [ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.autovc_cuda_error_string.argtypes = [ctypes.c_int]
    lib.autovc_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check_layout(packed: Mapping[str, torch.Tensor], dilations: Sequence[int], cond: torch.Tensor,
                  uniforms: torch.Tensor) -> tuple[int, int, int, int, int, int]:
    """(L, R, G, S, C, 3K) after checking what the kernel takes."""
    n_layers = len(dilations)
    g = packed["w3"].shape[-1]
    r, s, c, nout = packed["fk"].shape[0], packed["wskip"].shape[-1], packed["wcond"].shape[1], packed["l2b"].shape[0]
    want = {
        "w3": (n_layers, 3 * r, g), "wcond": (n_layers, c, g), "wout": (n_layers, g // 2, r),
        "wskip": (n_layers, g // 2, s), "bg": (n_layers, g), "bo": (n_layers, r), "bs": (n_layers, s),
        "fk": (r,), "fb": (r,), "l1k": (s, s), "l1b": (s,), "l2k": (s, nout), "l2b": (nout,),
    }
    for key, shape in want.items():
        t = packed[key]
        if tuple(t.shape) != shape:
            raise ValueError(f"packed[{key!r}] has shape {tuple(t.shape)}, expected {shape}")
        if t.dtype != torch.float32 or t.device != cond.device or not t.is_contiguous():
            raise ValueError(f"packed[{key!r}] must be contiguous float32 on {cond.device}")
        if t.data_ptr() % 16:
            raise ValueError(f"packed[{key!r}] is not 16-byte aligned")
    b, t_len, c_in = cond.shape
    if c_in != c or tuple(uniforms.shape) != (b, t_len, nout // 3 + 1):
        raise ValueError(f"cond {tuple(cond.shape)} / uniforms {tuple(uniforms.shape)} do not match C={c}, 3K={nout}")
    if g % 16 or r % 8 or s % 8 or c % 4 or s > 4096 or nout % 3:
        raise ValueError(f"wavenet kernel needs G % 16 == 0, R % 8 == 0, S % 8 == 0, S <= 4096, C % 4 == 0 "
                         f"(G={g}, R={r}, S={s}, C={c})")
    if min(dilations) < 1:
        raise ValueError(f"dilations must be >= 1, got {tuple(dilations)}")
    return n_layers, r, g, s, c, nout


def generate_cuda(packed: Mapping[str, torch.Tensor], dilations: Sequence[int], cond: torch.Tensor,
                  uniforms: torch.Tensor, log_scale_min: float = LOG_SCALE_MIN) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernels on the current stream (no synchronisation):
    T * (2L + 1) launches from one host call."""
    global launches, last_cuda_launches
    if cond.dtype != torch.float32 or uniforms.dtype != torch.float32:
        raise TypeError(f"wavenet kernel takes float32, got {cond.dtype} and {uniforms.dtype}")
    if uniforms.device != cond.device:
        raise ValueError(f"cond on {cond.device}, uniforms on {uniforms.device}")
    cond, uniforms = cond.contiguous(), uniforms.contiguous()
    n_layers, r, g, s, c, nout = _check_layout(packed, dilations, cond, uniforms)
    lib = _library()
    b, t, _ = cond.shape
    dev = cond.device
    zeros = lambda *shape: torch.zeros(shape, device=dev, dtype=torch.float32)
    y, logits = zeros(b, t), zeros(b, t, nout)
    # Scratch: the rings (sum 2d slots of (B, R)), h, skip, z and x_prev.
    ring, h, skip, z, x_prev = zeros(2 * sum(dilations), b, r), zeros(b, r), zeros(b, s), zeros(b, g // 2), zeros(b)
    dils = (ctypes.c_int * n_layers)(*dilations)
    n_launched = ctypes.c_longlong(0)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.autovc_wavenet_gen(
            *(packed[k].data_ptr() for k in PACKED_KEYS),
            cond.data_ptr(), uniforms.data_ptr(), y.data_ptr(), logits.data_ptr(),
            ring.data_ptr(), h.data_ptr(), skip.data_ptr(), z.data_ptr(), x_prev.data_ptr(),
            ctypes.cast(dils, ctypes.c_void_p),
            n_layers, b, t, r, g, s, c, nout, log_scale_min,
            ctypes.cast(ctypes.pointer(n_launched), ctypes.c_void_p), stream,
        )
    if err:
        raise RuntimeError(f"wavenet kernel launch failed: {lib.autovc_cuda_error_string(err).decode()}")
    launches += 1
    last_cuda_launches = n_launched.value
    return y, logits


def generate(packed: Mapping[str, torch.Tensor], dilations: Sequence[int], cond: torch.Tensor,
             uniforms: torch.Tensor, log_scale_min: float = LOG_SCALE_MIN) -> tuple[torch.Tensor, torch.Tensor]:
    """cond (B, T, C), uniforms (B, T, K+1) -> samples (B, T), logits
    (B, T, 3K): the kernel for a CUDA tensor, the plain version for a CPU
    tensor."""
    if cond.device.type == "cuda":
        return generate_cuda(packed, dilations, cond, uniforms, log_scale_min)
    if cond.device.type == "cpu":
        return generate_ref(packed, dilations, cond, uniforms, log_scale_min)
    raise ValueError(f"generate runs on cuda or cpu tensors, not {cond.device}")
