"""The Generator's bfloat16 LSTMs in the scan rounding, the default of
``ModelConfig.use_pallas_lstm=False`` as of JAX's: the port's bfloat16
Generator against JAX's default bfloat16 Generator (``_lstm_scan``) on the
trained spmel artifact, the scan rounding's weight gradient
(``lstm_scan_bf16_weight_grad_ref``) against ``jax.vjp`` of ``_lstm_scan``,
a narrow bfloat16 train step against JAX's ``--bf16`` loss and gradients
run op by op, and ``cli.train --bf16`` with and without ``--pallas``. The
scan dW kernel on a card is held to its plain version in
tests/test_torch_gpu.py."""

import dataclasses
import functools
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from autovc_tpu import models as jax_models
from autovc_tpu.cli.export_ckpt import load_artifact as jax_load_artifact
from autovc_tpu.config import Config as JaxConfig
from autovc_tpu.models.layers import _lstm_scan
from autovc_tpu_torch.config import Config, ModelConfig
from autovc_tpu_torch.models import LSTM, build_generator
from autovc_tpu_torch.ops import lstm as lstm_ops
from autovc_tpu_torch.train import Solver, loss_fn

from test_torch_bf16_train import (JAX_F32, PORT_MODEL, NarrowGenerator, _batch, _jax_cfg, _jax_init,
                                   _leaf_distances, _port_model, _write_corpus)
from test_torch_bf16_train import MEAN_SHARE
from test_torch_speaker import _scan_inputs
from test_torch_train import NARROW

torch.set_num_threads(1)

BF = torch.bfloat16
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GEN_ARTIFACT = os.path.join(REPO, "artifacts", "generator_spmel_f16.npz")

# The whole Generator (B=2, T=128, the trained artifact): the port's bfloat16
# mel from JAX's default bfloat16 mel. With the Pallas rounding it lay
# 0.0781 max / 0.00857 mean from it (0.0137 / 0.00123 from JAX's Pallas
# path); the scan rounding must come at least twice as close. A bfloat16
# carry keeps every flip of a float32 sum of another order, so no tighter.
SCAN_MEL_MAX, SCAN_MEL_MEAN = 0.039, 0.0043
REL = 1.25  # no farther from JAX float32 than 1.25x JAX bfloat16-scan's own distance
SPREAD_MULT = 2.0
RELABELLINGS = 32


def _bf16_np(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _deltas(a, b) -> tuple[float, float]:
    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    return float(d.max()), float(d.mean())


@pytest.fixture(scope="module")
def scan_generator_mels():
    """B=2, T=128 uniform mels and two unit embeddings through JAX's float32
    and default bfloat16 (scan) Generators and the port's default bfloat16
    Generator, on the committed weights."""
    variables, _ = jax_load_artifact(GEN_ARTIFACT)
    rng = np.random.RandomState(0)
    x = rng.rand(2, 128, 80).astype(np.float32)
    e = rng.randn(2, 256).astype(np.float32)
    e /= np.linalg.norm(e, axis=1, keepdims=True)
    e_org, e_trg = np.repeat(e[:1], 2, 0), np.repeat(e[1:], 2, 0)
    base = JaxConfig().model

    def jax_mel(**kw):
        return jax_models.build_generator(dataclasses.replace(base, **kw)).apply(
            variables, jnp.asarray(x), jnp.asarray(e_org), jnp.asarray(e_trg), train=False)

    gen = build_generator(ModelConfig(compute_dtype="bfloat16"), artifact=GEN_ARTIFACT, device="cpu")
    with torch.inference_mode():
        port = gen(torch.from_numpy(x), torch.from_numpy(e_org), torch.from_numpy(e_trg))
    return {"f32": _bf16_np(jax_mel()[1]), "scan": jax_mel(compute_dtype="bfloat16"), "port": port, "gen": gen}


def test_generator_defaults_to_the_scan_rounding(scan_generator_mels):
    """``ModelConfig()`` has JAX's default ``use_pallas_lstm=False``, and
    every LSTM of the bfloat16 Generator takes the scan rounding; True
    gives the Pallas rounding."""
    assert ModelConfig().use_pallas_lstm is False
    lstms = [m for m in scan_generator_mels["gen"].modules() if isinstance(m, LSTM)]
    assert len(lstms) == 3 and all(m.scan for m in lstms)
    pallas = build_generator(dataclasses.replace(PORT_MODEL, use_pallas_lstm=True), device="cpu")
    assert not any(m.scan for m in pallas.modules() if isinstance(m, LSTM))


def test_generator_bf16_scan_matches_jax_default_bf16(scan_generator_mels):
    """The port's default bfloat16 Generator against JAX's default bfloat16
    Generator (``_lstm_scan``): the mel within SCAN_MEL_MAX / SCAN_MEL_MEAN,
    and no farther from JAX float32 than REL times JAX bfloat16's own
    distance, in max and mean; the codes and decoder output bfloat16."""
    m = scan_generator_mels
    assert [o.dtype for o in m["port"]] == [BF, BF, BF] and m["scan"][1].dtype == jnp.bfloat16
    port, scan = m["port"][1].float().numpy(), _bf16_np(m["scan"][1])
    apart_max, apart_mean = _deltas(port, scan)
    jax_max, jax_mean = _deltas(scan, m["f32"])
    port_max, port_mean = _deltas(port, m["f32"])
    print(f"port bf16 (scan) vs JAX bf16 (scan): {apart_max:.4g} max / {apart_mean:.4g} mean; vs JAX f32 "
          f"{port_max:.4g} / {port_mean:.4g} (JAX's own {jax_max:.4g} / {jax_mean:.4g})")
    assert apart_max <= SCAN_MEL_MAX and apart_mean <= SCAN_MEL_MEAN
    assert port_max <= REL * jax_max and port_mean <= REL * jax_mean


def _port_dw(xproj, w_hh, dy, reverse, perms=None):
    """The plain scan chain's dW (forward, backward, weight gradient), with
    the hidden units relabelled by each of ``perms`` (stacked as one plain
    loop, each its own product) and relabelled back, when given."""
    x, w, d = (torch.from_numpy(a).to(BF) for a in (xproj, w_hh, dy))
    if perms is not None:
        p = torch.from_numpy(np.stack(perms))
        cols = torch.cat([p + g * p.shape[1] for g in range(4)], dim=1)
        x = torch.stack([x[..., c] for c in cols])
        w = torch.stack([w[q][:, c] for q, c in zip(p, cols)])
        d = torch.stack([d[..., q] for q in p])
    h_seq, c_seq, act, _, _ = lstm_ops.lstm_scan_bf16_train_ref(x, w, reverse=reverse)
    dx = lstm_ops.lstm_scan_bf16_backward_ref(w, act, c_seq, None, d, reverse=reverse)[0]
    dw = lstm_ops.lstm_scan_bf16_weight_grad_ref(h_seq, None, dx, reverse).float().numpy()
    if perms is None:
        return dw
    out = []
    for q, one in zip(perms, dw):
        inv = np.argsort(q)
        out.append(one[inv][:, np.concatenate([inv + g * len(inv) for g in range(4)])])
    return out


def _jax_dw(xproj, w_hh, dy, reverse):
    def run(x, w, d):
        zero = jnp.zeros((x.shape[0], w.shape[0]), x.dtype)
        _, vjp = jax.vjp(lambda w: _lstm_scan(x, w, zero, zero, reverse), w)
        return vjp(d)[0]

    dw = jax.jit(run)(*(jnp.asarray(a).astype(jnp.bfloat16) for a in (xproj, w_hh, dy)))
    return np.asarray(dw.astype(jnp.float32))


@pytest.mark.parametrize("reverse", [False, True])
def test_scan_weight_grad_bit_equal_to_jax_at_narrow_width(reverse):
    """``lstm_scan_bf16_weight_grad_ref`` on the plain scan chain against the
    w_hh cotangent of ``jax.jit(jax.vjp)`` of ``_lstm_scan`` in bfloat16 at
    B=8, T=24, H=32: bit for bit (the transposed scan's bfloat16
    accumulator, each step's product rounded before it is added)."""
    xproj, w_hh, dy = _scan_inputs(64 + reverse, 8, 24, 32)
    got, want = _port_dw(xproj, w_hh, dy, reverse), _jax_dw(xproj, w_hh, dy, reverse)
    assert got.dtype == np.float32 and np.array_equal(got, want)


def test_scan_weight_grad_rounds_each_step():
    """The control: the same gate gradients summed over all steps in float32
    and rounded once (the Pallas rounding's dW) are not JAX's scan dW."""
    xproj, w_hh, dy = _scan_inputs(64, 8, 24, 32)
    x, w, d = (torch.from_numpy(a).to(BF) for a in (xproj, w_hh, dy))
    h_seq, c_seq, act, _, _ = lstm_ops.lstm_scan_bf16_train_ref(x, w)
    dx = lstm_ops.lstm_scan_bf16_backward_ref(w, act, c_seq, None, d)[0]
    once = lstm_ops.lstm_weight_grad_ref(h_seq, None, dx.float()).float().numpy()
    assert not np.array_equal(once, _jax_dw(xproj, w_hh, dy, False))


@pytest.mark.parametrize("reverse", [False, True])
def test_scan_weight_grad_within_the_plain_loops_spread(reverse):
    """At B=7, T=64, H=256 the float32 sums of the forward and backward in
    another order flip bfloat16 values that the carries keep: the port's dW
    within SPREAD_MULT times the plain chain's own spread over RELABELLINGS
    relabellings of the hidden units, its largest distance from itself."""
    xproj, w_hh, dy = _scan_inputs(411 + reverse, 7, 64, 256)
    got, want = _port_dw(xproj, w_hh, dy, reverse), _jax_dw(xproj, w_hh, dy, reverse)
    perms = [np.random.RandomState(k).permutation(256) for k in range(RELABELLINGS)]
    spread = max(float(np.abs(r - got).max()) for r in _port_dw(xproj, w_hh, dy, reverse, perms))
    apart = float(np.abs(got - want).max())
    print(f"reverse={reverse}: dW {apart:.3e} from JAX's (own spread {spread:.3e}), "
          f"{(got == want).mean():.5f} bit-equal, peak {np.abs(want).max():.3f}")
    assert apart <= SPREAD_MULT * spread


def test_scan_function_returns_dw_only_where_asked():
    """``LSTMSequenceFn`` with ``scan``: a w_hh that requires grad gets the
    scan dW (bfloat16, ``lstm_scan_bf16_weight_grad_ref`` on the plain
    backward's gate gradients); a frozen one gets none."""
    xproj, w_hh, dy = _scan_inputs(65, 4, 16, 32)
    x = torch.from_numpy(xproj).to(BF).requires_grad_(True)
    w = torch.from_numpy(w_hh).to(BF).requires_grad_(True)
    h = lstm_ops.LSTMSequenceFn.apply(x, w, None, None, False, True)[0]
    h.backward(torch.from_numpy(dy).to(BF))
    h_seq, c_seq, act, _, _ = lstm_ops.lstm_scan_bf16_train_ref(x.detach(), w.detach())
    dx = lstm_ops.lstm_scan_bf16_backward_ref(w.detach(), act, c_seq, None, torch.from_numpy(dy).to(BF))[0]
    assert w.grad.dtype == BF and torch.equal(w.grad, lstm_ops.lstm_scan_bf16_weight_grad_ref(h_seq, None, dx))
    assert torch.equal(x.grad, dx)
    frozen = torch.from_numpy(w_hh).to(BF)
    x.grad = None
    lstm_ops.LSTMSequenceFn.apply(x, frozen, None, None, False, True)[0].sum().backward()
    assert frozen.grad is None and x.grad is not None


# ---------------------------------------- a narrow bfloat16 train step

SCAN_MODEL = dataclasses.replace(PORT_MODEL, use_pallas_lstm=False)
# JAX run op by op takes about 35 s at this batch on one CPU core, most of it
# compiling each primitive once. Measured (init 0, batch 1): the port's mean
# leaf distance from JAX bfloat16 0.21 of JAX float32's own, its worst leaf
# 0.31 of a scale (JAX float32's 1.48); with the Pallas rounding
# (use_pallas_lstm=True) 0.77 of it, which MEAN_SHARE (0.85) would pass, so
# the scan rounding is held to SCAN_SHARE.
SCAN_SHARE = 0.4
STEP_B, STEP_T = 2, 8
JAX_SCAN_BF16 = NarrowGenerator(**NARROW, dtype=jnp.bfloat16, use_pallas=False)


@functools.lru_cache(maxsize=None)
def _jax_op_by_op(init, batch):
    """JAX's ``--bf16`` loss and gradients in training form (the narrow
    Generator, ``_lstm_scan``) run op by op (``jax.disable_jit``: each
    primitive rounds its result, as the port's ops do), and JAX float32's."""
    from autovc_tpu.train import step as jax_step
    from autovc_tpu_torch.io import generator_state_from_jax

    params, stats = _jax_init(init)
    x, emb = _batch(batch, b=STEP_B, t=STEP_T)

    def run(model, jit):
        fn = jax.value_and_grad(lambda p: jax_step.loss_fn(model, _jax_cfg(), p, stats, jnp.asarray(x),
                                                           jnp.asarray(emb), train=True), has_aux=True)
        (total, (_, new_stats)), grads = (jax.jit(fn) if jit else fn)(params)
        return float(total), generator_state_from_jax({"params": grads, "batch_stats": new_stats})

    with jax.disable_jit():
        bf = run(JAX_SCAN_BF16, jit=False)
    return params, stats, x, emb, run(JAX_F32, jit=True), bf


def _scan_step_readings(compute_dtype, use_pallas_lstm=False):
    params, stats, x, emb, (loss32, g32), (loss_bf, g_bf) = _jax_op_by_op(0, 1)
    cfg = Config(model=dataclasses.replace(SCAN_MODEL, compute_dtype=compute_dtype, use_pallas_lstm=use_pallas_lstm))
    model = _port_model(params, stats, cfg)
    total, _ = loss_fn(model, cfg, torch.from_numpy(x), torch.from_numpy(emb), train=True)
    total.backward()
    got = {n: p.grad for n, p in model.named_parameters()}
    port, jax_own = _leaf_distances(got, g_bf, got), _leaf_distances(g32, g_bf, got)
    loss_apart = abs(float(total.detach()) - loss_bf) / abs(loss_bf)
    print(f"port in {compute_dtype} (use_pallas_lstm={use_pallas_lstm}): loss {loss_apart:.2e} from JAX bf16 op by op "
          f"({abs(loss_bf - loss32) / abs(loss32):.2e} JAX bf16 from f32); gradients worst {port.max():.3f}, "
          f"mean {port.mean():.3f} ({jax_own.max():.3f}, {jax_own.mean():.3f})")
    return model, port, jax_own


def test_bf16_scan_train_step_matches_jax_op_by_op():
    """The narrow bfloat16 Generator's training loss and gradients with the
    scan rounding against JAX's ``--bf16`` (``use_pallas=False``) run op by
    op, by the relative rule of tests/test_torch_bf16_train.py tightened:
    the mean gradient distance at most SCAN_SHARE of JAX float32's own;
    every LSTM in the scan rounding, its w_hh gradient float32."""
    model, port, jax_own = _scan_step_readings("bfloat16")
    assert all(m.scan for m in model.modules() if isinstance(m, LSTM))
    assert port.mean() <= SCAN_SHARE * jax_own.mean() <= MEAN_SHARE * jax_own.mean()


def test_bf16_scan_train_step_gate_refuses_a_float32_port():
    """The control: the port in float32 fails that gate."""
    _, port, jax_own = _scan_step_readings("float32")
    assert not port.mean() <= SCAN_SHARE * jax_own.mean()


def test_bf16_scan_train_step_gate_refuses_the_pallas_rounding():
    """The control: the port in bfloat16 with the Pallas rounding, which the
    scan rounding replaces as the default, fails that gate."""
    model, port, jax_own = _scan_step_readings("bfloat16", use_pallas_lstm=True)
    assert not any(m.scan for m in model.modules() if isinstance(m, LSTM))
    assert not port.mean() <= SCAN_SHARE * jax_own.mean()


# -------------------------------------------------------------- cli.train

@pytest.mark.parametrize("pallas", [False, True])
def test_cli_train_bf16_with_and_without_pallas(tmp_path, monkeypatch, pallas):
    """``cli.train --bf16`` (narrowed by a stand-in ModelConfig) trains 2
    steps to a finite loss with the scan rounding, or with ``--pallas`` the
    Pallas rounding, and exports parameters the JAX package loads."""
    from autovc_tpu_torch.cli import train as cli_train
    import autovc_tpu_torch.train as train_pkg

    monkeypatch.setattr(cli_train, "ModelConfig",
                        functools.partial(ModelConfig, enc_channels=32, dec_lstm_dim=64, postnet_channels=32))
    seen = {}

    class Recording(Solver):
        def train(self, *a, **kw):
            seen["metrics"] = super().train(*a, **kw)
            return seen["metrics"]

    def solver(cfg, data_iter, device):
        seen["solver"] = Recording(cfg, data_iter, device=device)
        return seen["solver"]

    monkeypatch.setattr(train_pkg, "Solver", solver)
    _write_corpus(tmp_path)
    out = str(tmp_path / "gen.npz")
    cli_train.main(["--main_dir", str(tmp_path), "--run_name", "s", "--device", "cpu", "--bf16", "--num_iters", "2",
                    "--batch_size", "2", "--len_crop", "32", "--dim_neck", "8", "--dim_emb", "16", "--dim_pre", "32",
                    "--freq", "8", "--log_step", "1", "--checkpoint_step", "2", "--export", out]
                   + (["--pallas"] if pallas else []))
    model = seen["solver"].state.model
    assert seen["solver"].cfg.model.use_pallas_lstm is pallas
    assert {m.scan for m in model.modules() if isinstance(m, LSTM)} == {not pallas}
    assert np.isfinite(float(seen["metrics"]["g_loss"]))
    assert jax_load_artifact(out) is not None
