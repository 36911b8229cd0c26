"""LSTM widths off the package's own, on the CPU: the gate-block padding the
kernels run such a width at (``ops.lstm.pad_hidden``, ``pad_gates``), the
launch plans of every width, the port's Generator and d-vector at such
widths against ``autovc_tpu``, and ``cli.make_gta_features`` against
``scripts/make_gta_features.py``.

On the card every LSTM wrapper pads H to ``pad_hidden(H)`` (a multiple of
8; of 16 past 1024), inserting zero units inside each of the i, f, g, o
blocks, and strips its outputs; the plain versions, which the CPU runs,
take any width. The kernels themselves are held to the plain versions at
H = 20, 44 and 2048 by ``tests/test_torch_gpu.py`` and ``chip_smoke.py``
phase 14a."""

from __future__ import annotations

import hashlib
import importlib.util
import json
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from autovc_tpu.config import Config as JaxConfig
from autovc_tpu.config import ModelConfig as JaxModelConfig
from autovc_tpu.models.dvector import dvector_for_params as jax_dvector_for_params
from autovc_tpu.train import step as jax_step
from autovc_tpu_torch.cli import make_gta_features
from autovc_tpu_torch.config import Config, ModelConfig
from autovc_tpu_torch.io import dvector_state_to_jax, generator_state_from_jax
from autovc_tpu_torch.models import DVector, build_generator
from autovc_tpu_torch.ops import lstm as lstm_ops
from autovc_tpu_torch.train import loss_fn
from autovc_tpu_torch.train.compare import grad_scale
from test_torch_convert_cli import WIDTHS, NarrowGen, _artifact, _tree, narrow_config

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMS = lstm_ops.SMS
ODD = dict(dim_neck=20, dim_emb=16, dim_pre=44)  # the encoder BLSTM's H and the decoder lstm1's, off a multiple of 8


def _inputs(seed, b, t, hidden):
    rng = np.random.RandomState(seed)
    xproj = torch.from_numpy((rng.randn(b, t, 4 * hidden) * 0.5).astype(np.float32))
    w_hh = torch.from_numpy(rng.uniform(-1, 1, (hidden, 4 * hidden)).astype(np.float32) / np.sqrt(hidden))
    h0, c0, dy = (torch.from_numpy(rng.randn(*s).astype(np.float32) * 0.5)
                  for s in [(b, hidden), (b, hidden), (b, t, hidden)])
    return xproj, w_hh, h0, c0, dy


# ---------------------------------------------------------------- padding

@pytest.mark.parametrize("hidden", [20, 44])
def test_pad_hidden_and_the_padded_layout(hidden):
    """The next multiple of 8 (of 16 past SCAN_BWD_MAX_HIDDEN, or where 8
    units a block would need more blocks than SMs); the package's widths
    are their own. Zero units go inside each gate block: stripping undoes
    padding exactly."""
    assert lstm_ops.pad_hidden(hidden) == -(-hidden // 8) * 8
    assert [lstm_ops.pad_hidden(h) for h in (32, 256, 512, 768, 1024)] == [32, 256, 512, 768, 1024]
    assert (lstm_ops.pad_hidden(1032), lstm_ops.pad_hidden(1284), lstm_ops.pad_hidden(2048)) == (1040, 1296, 2048)
    assert lstm_ops.pad_hidden(1000, sms=100) == 1008 and lstm_ops.pad_hidden(1000) == 1000
    width = lstm_ops.pad_hidden(hidden)
    xproj, w_hh, h0 = _inputs(0, 3, 5, hidden)[:3]
    px, pw = lstm_ops.pad_gates(xproj, width), lstm_ops.pad_w(w_hh, width)
    assert px.shape == (3, 5, 4 * width) and pw.shape == (width, 4 * width)
    for g in range(4):
        assert torch.equal(px[..., g * width:g * width + hidden], xproj[..., g * hidden:(g + 1) * hidden])
        assert not px[..., g * width + hidden:(g + 1) * width].any()
    assert not pw[hidden:].any()
    assert torch.equal(lstm_ops.strip_gates(px, hidden), xproj) and torch.equal(lstm_ops.strip_w(pw, hidden), w_hh)
    assert torch.equal(lstm_ops.strip_units(lstm_ops.pad_units(h0, width), hidden), h0)
    assert lstm_ops.pad_gates(xproj, hidden) is xproj and lstm_ops.pad_units(h0, hidden) is h0


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("hidden", [20, 44])
def test_padding_round_trips_the_float32_plain_versions(hidden, reverse):
    """The plain float32 forward at the padded width, stripped, is the
    unpadded one bit for bit, its padded units' h and c exactly 0; the
    backward's dxproj, dW, dh0 and dc0 within 1e-6 of each leaf's scale
    (the same sums, blocked otherwise by the CPU's matmul at the padded
    width), the padded units' gradients exactly 0."""
    xproj, w_hh, h0, c0, dy = _inputs(1, 7, 64, hidden)
    width = lstm_ops.pad_hidden(hidden)
    args = (lstm_ops.pad_gates(xproj, width), lstm_ops.pad_w(w_hh, width), lstm_ops.pad_units(h0, width),
            lstm_ops.pad_units(c0, width))
    want = lstm_ops.lstm_sequence_train_ref(xproj, w_hh, h0, c0, reverse)
    got = lstm_ops.lstm_sequence_train_ref(*args, reverse=reverse)
    for g, w in zip(got, want, strict=True):
        assert torch.equal(lstm_ops.strip_units(g, hidden), w)
        assert not g[..., hidden:].any()
    grads = lstm_ops.lstm_backward_ref(*args, got[0], got[1], lstm_ops.pad_units(dy, width), reverse=reverse)
    wgrads = lstm_ops.lstm_backward_ref(xproj, w_hh, h0, c0, want[0], want[1], dy, reverse=reverse)
    strip = (lambda v: lstm_ops.strip_gates(v, hidden), lambda v: lstm_ops.strip_w(v, hidden),
             lambda v: lstm_ops.strip_units(v, hidden), lambda v: lstm_ops.strip_units(v, hidden))
    for g, w, cut in zip(grads, wgrads, strip, strict=True):
        torch.testing.assert_close(cut(g), w, atol=1e-6 * float(w.abs().max()), rtol=0)
    dx, dw, dh0, dc0 = grads
    assert not dx.reshape(7, 64, 4, width)[..., hidden:].any() and not dh0[:, hidden:].any()
    assert not dc0[:, hidden:].any() and not dw[hidden:].any() and not dw.reshape(width, 4, width)[..., hidden:].any()


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("hidden", [20, 44])
def test_padding_round_trips_the_scan_rounding(hidden, reverse):
    """The scan rounding's plain forward at the padded width, stripped, is
    the unpadded one bit for bit (h_seq, c_seq, hN, cN and the activations of
    the real units; a padded unit's are [1/2, 1/2, 0, 1/2]), h and c of the
    padded units exactly 0; its backward and dW within 1e-6 of each leaf's
    scale, the padded units' gradients exactly 0."""
    xproj, w_hh, h0, c0, dy = (v.to(torch.bfloat16) for v in _inputs(2, 7, 64, hidden))
    width = lstm_ops.pad_hidden(hidden)
    px, pw = lstm_ops.pad_gates(xproj, width), lstm_ops.pad_w(w_hh, width)
    ph0, pc0 = lstm_ops.pad_units(h0, width), lstm_ops.pad_units(c0, width)
    want = lstm_ops.lstm_scan_bf16_train_ref(xproj, w_hh, h0, c0, reverse)
    got = lstm_ops.lstm_scan_bf16_train_ref(px, pw, ph0, pc0, reverse)
    for i, (g, w) in enumerate(zip(got, want, strict=True)):
        cut = lstm_ops.strip_gates(g, hidden) if i == 2 else lstm_ops.strip_units(g, hidden)
        assert torch.equal(cut, w), i
    assert not got[0][..., hidden:].any() and not got[1][..., hidden:].any()
    pad_act = got[2].reshape(7, 64, 4, width)[..., hidden:].float()
    assert torch.equal(pad_act, torch.tensor([0.5, 0.5, 0.0, 0.5])[:, None].expand_as(pad_act))
    dx = lstm_ops.lstm_scan_bf16_backward_ref(pw, got[2], got[1], pc0, lstm_ops.pad_units(dy, width),
                                              reverse=reverse)
    wdx = lstm_ops.lstm_scan_bf16_backward_ref(w_hh, want[2], want[1], c0, dy, reverse=reverse)
    for g, w, cut in zip(dx, wdx, (lstm_ops.strip_gates, lstm_ops.strip_units, lstm_ops.strip_units)):
        torch.testing.assert_close(cut(g, hidden).float(), w.float(), atol=1e-6 * float(w.float().abs().max()), rtol=0)
        assert not (g.reshape(*g.shape[:-1], -1, width)[..., hidden:].float().any())
    dw = lstm_ops.lstm_scan_bf16_weight_grad_ref(got[0], ph0, dx[0], reverse)
    wdw = lstm_ops.lstm_scan_bf16_weight_grad_ref(want[0], h0, wdx[0], reverse)
    torch.testing.assert_close(lstm_ops.strip_w(dw, hidden).float(), wdw.float(),
                               atol=1e-6 * float(wdw.float().abs().max()), rtol=0)
    assert not dw[hidden:].float().any() and not dw.reshape(width, 4, width)[..., hidden:].float().any()


@pytest.mark.parametrize("scan", [False, True])
def test_sequence_fn_pads_where_the_sequence_enters(monkeypatch, scan):
    """``LSTMSequenceFn`` pads once where a sequence enters and strips what
    leaves, as on the card (here ``_width`` pads on the CPU too, so the plain
    versions run at the padded width): at H=20, run at 24, h_seq, hN and cN
    are the unpadded run's bit for bit, and the four gradients lie within
    1e-6 of each leaf's scale of the unpadded run's."""
    hidden = 20
    xproj, w_hh, h0, c0, dy = _inputs(4, 3, 16, hidden)
    if scan:
        xproj, w_hh, h0, c0, dy = (v.to(torch.bfloat16) for v in (xproj, w_hh, h0, c0, dy))

    def run():
        leaves = [v.clone().requires_grad_() for v in (xproj, w_hh, h0, c0)]
        h_seq, hn, cn = lstm_ops.LSTMSequenceFn.apply(*leaves, True, scan)
        ((h_seq.float() * dy.float()).sum() + hn.float().sum() + 2 * cn.float().sum()).backward()
        return (h_seq, hn, cn), [v.grad for v in leaves]

    want, wgrads = run()
    widths = []

    def padded_width(v, h):
        widths.append(lstm_ops.pad_hidden(h))
        return widths[-1]

    monkeypatch.setattr(lstm_ops, "_width", padded_width)
    got, grads = run()
    assert widths == [24]
    for g, w in zip(got, want, strict=True):
        assert g.shape == w.shape and torch.equal(g, w)
    for g, w in zip(grads, wgrads, strict=True):
        assert g.shape == w.shape and g.dtype == w.dtype
        torch.testing.assert_close(g.float(), w.float(), atol=1e-6 * float(w.float().abs().max()), rtol=0)


def test_any_width_pads_each_argument_by_its_role(monkeypatch):
    """The wrappers' padding (``_any_width``): the arguments named with a
    role, positional or keyword, padded to the width ``_width`` gives (None
    left None), the others passed on, the outputs stripped by their roles;
    at a width that is its own the arguments reach the wrapper as they are."""
    calls = []

    @lstm_ops._any_width("gwu", xproj="g", w_hh="w", h0="u", c0="u")
    def wrapper(xproj, w_hh, h0=None, c0=None, reverse=False, *, extra=None):
        calls.append((xproj, w_hh, h0, c0, reverse, extra))
        return xproj, w_hh, xproj[..., :w_hh.shape[0]]

    xproj, w_hh, h0 = _inputs(5, 2, 3, 20)[:3]
    out = wrapper(xproj, w_hh, c0=None, h0=h0, reverse=True, extra=7)
    assert calls[-1][0] is xproj and calls[-1][2] is h0 and out[0] is xproj
    monkeypatch.setattr(lstm_ops, "_width", lambda v, h: lstm_ops.pad_hidden(h))
    out = wrapper(xproj, w_hh, c0=None, h0=h0, reverse=True, extra=7)
    px, pw, ph0, c0, reverse, extra = calls[-1]
    assert (px.shape, pw.shape, ph0.shape) == ((2, 3, 96), (24, 96), (2, 24))
    assert torch.equal(px, lstm_ops.pad_gates(xproj, 24)) and torch.equal(pw, lstm_ops.pad_w(w_hh, 24))
    assert torch.equal(ph0, lstm_ops.pad_units(h0, 24)) and (c0, reverse, extra) == (None, True, 7)
    assert torch.equal(out[0], xproj) and torch.equal(out[1], w_hh) and torch.equal(out[2], xproj[..., :20])


# ---------------------------------------------------------------- the plans

BATCHES = (1, 2, 4, 7, 8, 20, 32)


@pytest.mark.parametrize("batch", BATCHES)
def test_every_width_has_a_plan(batch):
    """``launch_plan`` (forward and backward, float32 and bfloat16 w_hh),
    ``scan_plan``, ``scan_bwd_plan``, ``scan_dw_plan`` and ``gates_plan``
    give a plan for every H in 1..2048 at 132 SMs, each planned at the
    padded width and in a block's shared memory; regime (c) only where (b)
    does not fit, its resident rows a multiple of its chunk."""
    for hidden in range(1, 2049):
        width = lstm_ops.pad_hidden(hidden)
        for kind in ("fwd", "bwd"):
            for wbytes in (4, 2):
                plan = lstm_ops.launch_plan(batch, hidden, kind, SMS, wbytes)
                assert plan is not None and plan.smem <= lstm_ops.SMEM_MAX, (hidden, kind, wbytes)
                assert plan.blocks * (plan.units if plan.regime != "a" else plan.rows) >= (
                    width if plan.regime != "a" else batch)
                if plan.regime == "c":
                    assert plan.kres % plan.kc == 0 and plan.smem == lstm_ops._smem(
                        kind, "c", width, plan.units, plan.rows, plan.kc, wbytes, plan.kres)
        for plan in (lstm_ops.scan_plan(batch, hidden, SMS), lstm_ops.scan_bwd_plan(batch, hidden, SMS)):
            assert plan is not None and plan.smem <= lstm_ops.SMEM_MAX, hidden
            assert plan.blocks <= SMS or plan.regime == "a"
        assert lstm_ops.scan_dw_plan(batch, 128, hidden, SMS) is not None
        assert lstm_ops.gates_plan(batch, 128, hidden).blocks > 0


# The published widths' plans before regime (c): per (B, H), launch_plan's
# (fwd, bwd) x (4, 2 bytes) as [regime, blocks, units, rows, kc, smem],
# scan_plan's and scan_bwd_plan's [regime, blocks, units, rows, smem],
# scan_dw_plan's [mi, nj, rows, slabs, blocks, warps, slots, smem], gates_plan's
# [nsub, blocks] and dw_plan's [tiles_m, tiles_n, splits, chunk, workspace]
# (T=128 for the last three), as a SHA-256 of their JSON; spelled out at the
# Generator's training shapes.
PUBLISHED_SHA256 = "941900929d952100c5e3fb2168563c27a1751818fd9b96df836c47b3343d42e9"


def _published_row(batch, hidden):
    row = []
    for kind in ("fwd", "bwd"):
        for wbytes in (4, 2):
            p = lstm_ops.launch_plan(batch, hidden, kind, SMS, wbytes)
            row.append([p.regime, p.blocks, p.units, p.rows, p.kc, p.smem])
    for p in (lstm_ops.scan_plan(batch, hidden, SMS), lstm_ops.scan_bwd_plan(batch, hidden, SMS)):
        row.append([p.regime, p.blocks, p.units, p.rows, p.smem])
    p = lstm_ops.scan_dw_plan(batch, 128, hidden, SMS)
    row.append([p.mi, p.nj, p.rows, p.slabs, p.blocks, p.warps, p.slots, p.smem])
    p = lstm_ops.gates_plan(batch, 128, hidden)
    row.append([p.nsub, p.blocks])
    p = lstm_ops.dw_plan(batch, 128, hidden, SMS)
    row.append([p.tiles_m, p.tiles_n, p.splits, p.chunk, p.workspace])
    return row


def test_published_widths_keep_their_plans():
    """At the package's widths (32, 256, 512, 768, 1024) and B in BATCHES
    every plan is what it was before padding and regime (c): no copy, no new
    launch, the same kernels' same grids."""
    table = {f"{b},{h}": _published_row(b, h) for h in (32, 256, 512, 768, 1024) for b in BATCHES}
    assert hashlib.sha256(json.dumps(table, sort_keys=True).encode()).hexdigest() == PUBLISHED_SHA256
    assert table["7,1024"][:6] == [["b", 128, 8, 8, 1024, 213248], ["b", 128, 8, 8, 1024, 147712],
                                   ["b", 128, 8, 8, 1024, 213248], ["b", 128, 8, 8, 2048, 213248],
                                   ["b", 128, 8, 8, 153872], ["b", 128, 8, 8, 71056]]
    assert table["7,512"][:6] == [["b", 128, 4, 8, 512, 82176], ["b", 128, 4, 8, 512, 65792],
                                  ["b", 128, 4, 8, 2048, 180480], ["b", 128, 4, 8, 2048, 164096],
                                  ["b", 64, 8, 8, 80144], ["b", 64, 8, 8, 38288]]
    assert table["7,32"][:6] == [["a", 2, 32, 4, 0, 33344], ["a", 2, 32, 4, 0, 25152], ["a", 2, 32, 4, 0, 34880],
                                 ["a", 2, 32, 4, 0, 26688], ["a", 1, 32, 8, 24208], ["a", 1, 32, 8, 5248]]


# ------------------------------------------ the port against autovc_tpu

def _odd_models():
    jmodel = NarrowGen(**ODD)
    rng = np.random.RandomState(3)
    x = rng.rand(4, 32, 80).astype(np.float32)
    emb = rng.randn(4, ODD["dim_emb"]).astype(np.float32)
    variables = jmodel.init(jax.random.PRNGKey(4), jnp.asarray(x), jnp.asarray(emb), jnp.asarray(emb))
    cfg = Config(model=ModelConfig(**{**WIDTHS, **ODD}))
    model = build_generator(cfg.model, device="cpu", trainable=True)
    model.load_state_dict(generator_state_from_jax(variables))
    return jmodel, variables, model, cfg, x, emb


def test_generator_at_odd_widths_matches_jax():
    """A Generator with dim_neck 20 and dim_pre 44 (the encoder BLSTM's and
    the decoder lstm1's H off a multiple of 8) on JAX's weights: the eval
    forward within 1e-4 of JAX's, and the training loss and every gradient
    leaf against ``jax.value_and_grad`` of the JAX loss (the loss within
    1e-5 relative, each leaf within 1e-4 of its ``grad_scale``)."""
    jmodel, variables, model, cfg, x, emb = _odd_models()
    want = jmodel.apply(variables, jnp.asarray(x), jnp.asarray(emb), jnp.asarray(emb), train=False)
    model.eval()
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(emb), torch.from_numpy(emb))
    for g, w in zip(got, want, strict=True):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4, rtol=0)
    model.train()
    jcfg = JaxConfig(model=JaxModelConfig(model_type="spmel", **ODD))
    (jtotal, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jax_step.loss_fn(jmodel, jcfg, p, variables["batch_stats"], jnp.asarray(x), jnp.asarray(emb)),
        has_aux=True))(variables["params"])
    total, _ = loss_fn(model, cfg, torch.from_numpy(x), torch.from_numpy(emb))
    total.backward()
    assert abs(float(total.detach()) - float(jtotal)) <= 1e-5 * abs(float(jtotal))
    grads = generator_state_from_jax({"params": jgrads, "batch_stats": variables["batch_stats"]})
    for name, p in model.named_parameters():
        torch.testing.assert_close(p.grad, grads[name], atol=1e-4 * grad_scale(name, grads), rtol=0, msg=name)


def test_dvector_at_dim_cell_20_matches_jax():
    """A seeded d-vector of dim_cell 20 (its three LSTMs' H) against the JAX
    ``DVector`` on the same weights, B=3, T=128, within 1e-5."""
    model = DVector(dim_cell=20, dim_emb=16)
    model.reset_parameters(5)
    params = dvector_state_to_jax(model.state_dict())
    x = np.random.RandomState(6).rand(3, 128, 80).astype(np.float32)
    want = np.asarray(jax_dvector_for_params(params).apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (3, 16)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


# ------------------------------------------------------- make_gta_features

def _jax_gta_script():
    spec = importlib.util.spec_from_file_location("jax_make_gta_features",
                                                  os.path.join(REPO, "scripts", "make_gta_features.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_make_gta_features_matches_the_jax_script(tmp_path, monkeypatch):
    """``cli.make_gta_features`` against ``scripts/make_gta_features.py`` on
    one temporary tree and narrow artifact (both sides' generators narrowed
    by a monkeypatched config): the same files, each reconstruction within
    1e-4 of JAX's and as long as its source mel (100-128 frames, padded to
    128 for the pass)."""
    import autovc_tpu.models as jax_models
    from test_torch_convert_cli import jax_narrow

    monkeypatch.setattr(make_gta_features, "ModelConfig", narrow_config)
    monkeypatch.setattr(jax_models, "build_generator", jax_narrow)
    entries = _tree(tmp_path)
    art = _artifact(tmp_path / "gen.npz", "spmel")
    jax_out, port_out = tmp_path / "gta_jax", tmp_path / "gta_port"
    monkeypatch.setattr(sys, "argv", ["make_gta_features.py", "--platform", "cpu", "--main_dir", str(tmp_path),
                                      "--artifact", art, "--out_dir", str(jax_out)])
    _jax_gta_script().main()
    n = make_gta_features.main(["--main_dir", str(tmp_path), "--artifact", art, "--out_dir", str(port_out),
                                "--device", "cpu"])
    names = sorted(os.path.relpath(os.path.join(d, f), jax_out) for d, _, fs in os.walk(jax_out) for f in fs)
    assert n == len(names) == sum(len(e.utterances) for e in entries)
    for rel in names:
        got, want = np.load(port_out / rel), np.load(jax_out / rel)
        src = np.load(tmp_path / "spmel" / rel)
        assert got.dtype == np.float32 and got.shape == want.shape == src.shape, rel
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=0, err_msg=rel)
