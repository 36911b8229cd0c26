"""The port's WaveNet vocoder (autovc_tpu_torch.vocoder.wavenet and
autovc_tpu_torch.ops.wavenet) against the JAX package's, on the CPU.

Generation consumes an external stream of uniforms, so both sides get the
same numbers: the uniforms that ``jax.random.uniform`` draws inside
``_generate_scan`` for a key are drawn here too and handed to the port."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from autovc_tpu.config import WaveNetConfig as JaxWaveNetConfig
from autovc_tpu.ops.pallas_wavenet import generate_pallas
from autovc_tpu.ops.pallas_wavenet import pack_weights as jax_pack_weights
from autovc_tpu.vocoder import wavenet as jax_wavenet
from autovc_tpu_torch import io
from autovc_tpu_torch.config import WaveNetConfig
from autovc_tpu_torch.ops import wavenet as wavenet_ops
from autovc_tpu_torch.vocoder import WaveNet, WaveNetVocoder, sample_from_mol_uniforms

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARTIFACTS = os.path.join(REPO, "artifacts")
ATOL = 1e-5  # f32 on both sides, the same operations in other summation orders
PALLAS_ATOL = 2e-4  # as tests/test_vocoder.py holds the Pallas kernel against the scan

TINY_KW = dict(out_channels=12, layers=6, stacks=2, residual_channels=16, gate_channels=16,
               skip_channels=8, cin_channels=80, upsample_scales=(4, 4, 4, 4))
EIGHT_KW = dict(TINY_KW, layers=8)  # dilations (1, 2, 4, 8) x 2


def _pair(kw, seed):
    """(JAX config, JAX params, port model) with the same weights."""
    jcfg = JaxWaveNetConfig(**kw)
    params = jax_wavenet.init_params(jcfg, jax.random.PRNGKey(seed))
    model = WaveNet(WaveNetConfig(**kw))
    model.load_state_dict(io.wavenet_state_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    return jcfg, params, model.eval().requires_grad_(False)


def _uniforms(key, b, length, k_mol):
    """The (B, T, K+1) stream that _generate_scan draws for ``key``."""
    u = jax.random.uniform(key, (length, b, k_mol + 1), minval=1e-5, maxval=1.0 - 1e-5)
    return np.array(np.asarray(u).swapaxes(0, 1))  # a writable, contiguous copy


@pytest.fixture(scope="module")
def tiny():
    return _pair(TINY_KW, 0)


def test_config_matches_jax():
    for kw in ({}, TINY_KW, EIGHT_KW):
        assert WaveNetConfig(**kw).dilations() == JaxWaveNetConfig(**kw).dilations()
    full = WaveNetConfig()
    assert full.dilations()[:6] == (1, 2, 4, 8, 16, 32) and len(full.dilations()) == 24
    assert (full.residual_channels, full.gate_channels, full.skip_channels, full.out_channels) == (512, 512, 256, 30)


@pytest.mark.parametrize("frames", [3, 10])
def test_upsample_conditioning_matches_jax(frames):
    """Random kernels (std 1/sqrt(6): each output sums 3 x 2 taps), which a
    flipped kernel would not match; the initial kernels are symmetric."""
    jcfg, params, model = _pair(TINY_KW, 0)
    rng = np.random.RandomState(frames)
    kernels = {str(j): {"kernel": (rng.randn(3, 2 * s) / np.sqrt(6.0)).astype(np.float32)}
               for j, s in enumerate(jcfg.upsample_scales)}
    for j, k in kernels.items():
        model.upsample[j].kernel.copy_(torch.from_numpy(k["kernel"]))
    mel = rng.rand(2, frames, 80).astype(np.float32)
    want = np.asarray(jax_wavenet.upsample_conditioning(dict(params, upsample=kernels), jcfg, jnp.asarray(mel)))
    got = model.upsample_conditioning(torch.from_numpy(mel)).numpy()
    assert got.shape == want.shape == (2, frames * 256, 80)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_apply_matches_jax(tiny):
    jcfg, params, model = tiny
    rng = np.random.RandomState(1)
    x = rng.uniform(-1, 1, (2, 300, 1)).astype(np.float32)
    mel = rng.rand(2, 2, 80).astype(np.float32)
    want = np.asarray(jax_wavenet.apply(params, jcfg, jnp.asarray(x), jnp.asarray(mel)))
    got = model.apply(torch.from_numpy(x), torch.from_numpy(mel)).numpy()
    assert got.shape == (2, 300, 12)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_sample_from_mol_uniforms_matches_jax():
    """Random logits and uniforms, plus rows whose mixture scores tie (the
    first index wins on both sides) and uniforms outside the clip range."""
    rng = np.random.RandomState(2)
    logits = rng.randn(64, 30).astype(np.float32) * 2
    u = rng.uniform(0, 1, (64, 11)).astype(np.float32)
    logits[:8, :10] = 0.5
    u[:8, :10] = 0.3
    u[8:12, :] = 0.0
    u[12:16, :] = 1.0
    want = np.asarray(jax_wavenet.sample_from_mol_uniforms(jnp.asarray(logits), jnp.asarray(u), -7.0))
    got = sample_from_mol_uniforms(torch.from_numpy(logits), torch.from_numpy(u), -7.0).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_pack_weights_matches_jax(tiny):
    jcfg, params, model = tiny
    want = jax_pack_weights(params, jcfg.layers, dtype=jnp.float32)
    got = wavenet_ops.pack_weights(model.state_dict(), jcfg.layers)
    assert set(got) == set(wavenet_ops.PACKED_KEYS) == set(want)
    for key in got:
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]).reshape(got[key].shape))


def test_generate_ref_matches_scan(tiny):
    """The plain loop against the JAX scan over all 2 x 1024 samples."""
    jcfg, params, model = tiny
    mel = np.random.RandomState(0).rand(2, 4, 80).astype(np.float32)
    cond = jax_wavenet.upsample_conditioning(params, jcfg, jnp.asarray(mel))
    key = jax.random.PRNGKey(42)
    want_y, want_logits = jax_wavenet._generate_scan(params, jcfg, cond, key, 1024)
    packed = wavenet_ops.pack_weights(model.state_dict(), jcfg.layers)
    u = _uniforms(key, 2, 1024, 4)
    got_y, got_logits = wavenet_ops.generate(packed, jcfg.dilations(), torch.from_numpy(np.array(cond)),
                                             torch.from_numpy(u), jcfg.log_scale_min)
    assert got_y.shape == (2, 1024) and got_logits.shape == (2, 1024, 12)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), atol=ATOL, rtol=0)
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(want_logits), atol=ATOL, rtol=0)


@pytest.mark.parametrize("kw, seed, hbm_threshold", [(TINY_KW, 0, None), (EIGHT_KW, 5, 4)],
                         ids=["rings_resident", "hbm_threshold_4"])
def test_generate_ref_matches_pallas(kw, seed, hbm_threshold):
    """The plain loop against the Pallas kernel in interpret mode, f32
    weights, with all rings resident and with the d >= 4 rings in HBM."""
    jcfg, params, model = _pair(kw, seed)
    rng = np.random.RandomState(3)
    mel = rng.rand(2, 4, 80).astype(np.float32)
    cond = jax_wavenet.upsample_conditioning(params, jcfg, jnp.asarray(mel))
    u = _uniforms(jax.random.PRNGKey(7), 2, 1024, 4)
    want = generate_pallas(jax_pack_weights(params, jcfg.layers, dtype=jnp.float32), tuple(jcfg.dilations()),
                           cond, jnp.asarray(u), log_scale_min=jcfg.log_scale_min, interpret=True,
                           hbm_threshold=hbm_threshold)
    packed = wavenet_ops.pack_weights(model.state_dict(), jcfg.layers)
    got, _ = wavenet_ops.generate_ref(packed, jcfg.dilations(), torch.from_numpy(np.array(cond)),
                                      torch.from_numpy(u), jcfg.log_scale_min)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=PALLAS_ATOL, rtol=0)


def test_generated_logits_match_teacher_forced(tiny):
    """The check the card makes on the kernel: the logits of generation
    equal the teacher-forced forward on the generated waveform."""
    _, _, model = tiny
    vocoder_cfg = model.cfg
    rng = np.random.RandomState(4)
    mel = torch.from_numpy(rng.rand(3, 2, 80).astype(np.float32))
    cond = model.upsample_conditioning(mel)
    u = torch.from_numpy(rng.uniform(1e-5, 1 - 1e-5, (3, 512, 5)).astype(np.float32))
    y, logits = wavenet_ops.generate_ref(wavenet_ops.pack_weights(model.state_dict(), vocoder_cfg.layers),
                                         vocoder_cfg.dilations(), cond, u, vocoder_cfg.log_scale_min)
    tf = model.apply(y[..., None], mel)
    torch.testing.assert_close(logits, tf, atol=1e-4, rtol=0)


def test_full_width_slice_matches_jax_on_committed_weights():
    """The committed wavenet_f16.npz at full width, one mel frame (256
    samples), the port's vocoder against the JAX vocoder's scan engine on
    the same uniforms.

    The two trajectories drift apart smoothly: the sample difference starts
    at ~1e-7 and grows through the autoregressive feedback (past 1e-5 near
    sample 74, past 2e-4 near sample 128, ~5e-3 at 256), with no mixture
    flip. So the waveform is held over a prefix of at least 32 samples, and
    the whole length is held through the logits: the port's teacher-forced
    forward on the JAX trajectory gives the JAX generation's logits."""
    path = os.path.join(ARTIFACTS, "wavenet_f16.npz")
    jax_voc = jax_wavenet.WaveNetVocoder.from_checkpoint(JaxWaveNetConfig(), path)
    port = WaveNetVocoder.from_checkpoint(WaveNetConfig(), path, device="cpu")
    mel = np.random.RandomState(5).rand(1, 80).astype(np.float32)
    key = jax.random.PRNGKey(0)
    cond = jax_wavenet.upsample_conditioning(jax_voc.params, jax_voc.cfg, jnp.asarray(mel)[None])
    want_y, want_logits = (np.array(a)[0] for a in jax_wavenet._generate_scan(jax_voc.params, jax_voc.cfg,
                                                                                 cond, key, 256))
    np.testing.assert_array_equal(want_y, np.asarray(jax_voc.generate(mel, key=key)))
    got = port.generate(mel, uniforms=torch.from_numpy(_uniforms(key, 1, 256, 10)[0])).numpy()
    assert got.shape == want_y.shape == (256,)
    np.testing.assert_allclose(got[:32], want_y[:32], atol=PALLAS_ATOL, rtol=0)
    apart = np.flatnonzero(np.abs(got - want_y) > PALLAS_ATOL)
    assert (apart[0] if apart.size else 256) >= 32
    tf = port.logits(torch.from_numpy(want_y)[None, :, None], torch.from_numpy(mel)[None])[0]
    np.testing.assert_allclose(tf.numpy(), want_logits, atol=1e-4, rtol=0)


@pytest.mark.parametrize("name", ["wavenet_f16.npz", "wavenet_105k.npz"])
def test_artifact_round_trip(name):
    """Every key of the artifact loads into WaveNet (strict) and comes back
    unchanged under its JAX name, f16 storage upcast to f32."""
    path = os.path.join(ARTIFACTS, name)
    tree, _ = io.load_artifact(path)
    model = WaveNet()
    model.load_state_dict(io.wavenet_state_from_jax(tree))
    state = {k.replace(".", "/"): v.numpy() for k, v in model.state_dict().items()}
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files if k != "__step__"}
    assert len(flat) == 226 and set(state) == set(flat)
    for key, value in flat.items():
        assert state[key].dtype == np.float32
        np.testing.assert_array_equal(state[key], value.astype(np.float32))


def test_generate_bucketed_trims_to_true_length():
    voc = WaveNetVocoder(WaveNetConfig(**TINY_KW), device="cpu", seed=1)
    mel = np.random.RandomState(6).rand(5, 80).astype(np.float32)
    u = voc.uniforms(1, 8 * 256, torch.Generator().manual_seed(3))[0]
    got = voc.generate_bucketed(mel, bucket=4, uniforms=u)
    assert got.shape == (5 * 256,)
    padded = np.concatenate([mel, np.repeat(mel[-1:], 3, axis=0)])
    torch.testing.assert_close(got, voc.generate(padded, uniforms=u)[: 5 * 256], atol=0, rtol=0)
    assert voc.generate_bucketed(mel, bucket=0, uniforms=u[: 5 * 256]).shape == (5 * 256,)


def test_seeded_vocoder_is_reproducible():
    """The same seed and generator give the same weights and waveform; the
    default stream is seed 0."""
    a = WaveNetVocoder(WaveNetConfig(**TINY_KW), device="cpu", seed=2)
    b = WaveNetVocoder(WaveNetConfig(**TINY_KW), device="cpu", seed=2)
    mel = np.random.RandomState(7).rand(2, 1, 80).astype(np.float32)
    torch.testing.assert_close(a.generate(mel), b.generate(mel, generator=torch.Generator().manual_seed(0)),
                               atol=0, rtol=0)
    u = a.uniforms(2, 256)
    assert u.shape == (2, 256, 5) and float(u.min()) >= 1e-5 and float(u.max()) <= 1 - 1e-5


def test_vocoder_defaults_to_cuda_and_raises_without_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        WaveNetVocoder(WaveNetConfig(**TINY_KW))
    # an r9y9 torch checkpoint loads (tests/test_torch_interop.py); one that holds no WaveNet raises
    path = str(tmp_path / "wavenet.pth")
    torch.save({"state_dict": {"first_conv.bias": torch.zeros(4)}}, path)
    with pytest.raises(KeyError, match="first_conv"):
        WaveNetVocoder.from_checkpoint(WaveNetConfig(), path, device="cpu")


def test_generate_takes_cpu_or_cuda_only(tiny):
    _, _, model = tiny
    packed = wavenet_ops.pack_weights(model.state_dict(), model.cfg.layers)
    cond = torch.zeros((1, 4, 80), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        wavenet_ops.generate(packed, model.cfg.dilations(), cond, torch.zeros((1, 4, 5), device="meta"))


@pytest.mark.parametrize("case", ["float64", "uniforms_shape", "gate_width", "bias_shape"])
def test_kernel_wrapper_rejects_before_building(tiny, case):
    """generate_cuda validates its inputs before it builds or launches."""
    _, _, model = tiny
    packed = wavenet_ops.pack_weights(model.state_dict(), model.cfg.layers)
    cond, u = torch.zeros((2, 4, 80)), torch.zeros((2, 4, 5))
    dils, error = model.cfg.dilations(), ValueError
    if case == "float64":
        cond, error = cond.double(), TypeError
    elif case == "uniforms_shape":
        u = torch.zeros((2, 4, 4))
    elif case == "gate_width":  # G = 8: the kernel needs G % 16 == 0
        packed = wavenet_ops.pack_weights(WaveNet(WaveNetConfig(**dict(TINY_KW, gate_channels=8))).state_dict(), 6)
    else:
        packed = dict(packed, bo=packed["bo"][:, :8].contiguous())
    with pytest.raises(error):
        wavenet_ops.generate_cuda(packed, dils, cond, u)


# ------------------------------------------------- the kernel's launch plan

FULL_WIDTHS = (512, 512, 256, 80, 30)  # (R, G, S, C, 3K) of the default WaveNetConfig
TINY_WIDTHS = (16, 16, 8, 80, 12)
EIGHT_WIDTHS = (64, 64, 32, 80, 30)


def _owned(blocks, per_block, width):
    """Each block's range of a phase's columns, cut at the width."""
    return [range(min(i * per_block, width), min((i + 1) * per_block, width)) for i in range(blocks)]


@pytest.mark.parametrize("sms", [132, 114, 96])
@pytest.mark.parametrize("batch", [1, 3, 8, 32, 37])
@pytest.mark.parametrize("widths", [FULL_WIDTHS, TINY_WIDTHS, EIGHT_WIDTHS])
def test_generate_plan_covers_every_column_once(widths, batch, sms):
    """Every gate pair, residual column and head column is owned by exactly
    one block, at most one block an SM; the shared bytes are the layout's
    and fit 227 KB; one launch a call."""
    r, g, s, _, _ = widths
    plan = wavenet_ops.generate_plan(batch, widths, sms)
    assert plan.blocks <= sms and plan.launches == 1 and 1 <= plan.depth <= wavenet_ops.MAX_DEPTH
    assert plan.smem <= 232_448
    assert plan.smem == wavenet_ops._smem(batch, widths, plan.pairs, plan.cols, plan.head_cols, plan.depth)
    for per_block, width in ((plan.pairs, g // 2), (plan.cols, r + s), (plan.head_cols, s)):
        owned = [c for cols in _owned(plan.blocks, per_block, width) for c in cols]
        assert sorted(owned) == list(range(width)) and len(set(owned)) == width
    assert 2 * plan.pairs <= wavenet_ops.MAX_COLS and plan.cols <= wavenet_ops.MAX_COLS


def test_generate_plan_at_full_width():
    """128 blocks of 2 pairs, 6 residual and 2 head columns, three phases
    of weights in flight; a tiny width leaves blocks that own no gate pair."""
    plan = wavenet_ops.generate_plan(8, FULL_WIDTHS)
    assert (plan.blocks, plan.pairs, plan.cols, plan.head_cols, plan.depth) == (128, 2, 6, 2, 3)
    tiny = wavenet_ops.generate_plan(1, TINY_WIDTHS)
    assert tiny.blocks == 24 and tiny.blocks * tiny.pairs > TINY_WIDTHS[1] // 2


def test_generate_plan_refuses_what_does_not_fit():
    with pytest.raises(ValueError, match="needs at least 96 SMs"):
        wavenet_ops.generate_plan(8, FULL_WIDTHS, sms=64)
    with pytest.raises(ValueError, match="rows of at most"):
        wavenet_ops.generate_plan(8, (1024, 512, 256, 80, 30))
    with pytest.raises(ValueError, match="shared memory"):
        wavenet_ops.generate_plan(8, (32, 1024, 1024, 80, 60))


def test_kernel_refuses_before_building(tiny, monkeypatch):
    """generate_cuda refuses a plan that cannot be made, and tensors off the
    card, before it builds anything."""
    _, _, model = tiny
    packed = wavenet_ops.pack_weights(model.state_dict(), model.cfg.layers)
    monkeypatch.setattr(wavenet_ops._build, "load", lambda name: pytest.fail("built the kernel"))
    cond, u = torch.zeros((2, 4, 80)), torch.zeros((2, 4, 5))
    with pytest.raises(ValueError, match="CUDA device"):
        wavenet_ops.generate_cuda(packed, model.cfg.dilations(), cond, u)
    monkeypatch.setattr(wavenet_ops, "SMS", 2)
    with pytest.raises(ValueError, match="SMs"):
        wavenet_ops.generate_cuda(packed, model.cfg.dilations(), cond, u)


@pytest.mark.parametrize("sms", [132, 5])
def test_kernel_weights_hold_each_blocks_slices(tiny, sms):
    """Block i's slot of phase p is its gate slice of layer p (rows [w3_p[:2R];
    the h rows; the z rows; wcond_p; the bias], columns [tanh j, sigmoid j]
    of its pairs, zero-padded to 4; zero at p = L) then its residual slice
    of layer p - 1 (rows of [wout | wskip], [bo | bs], fk and fb; zero at
    p = 0), as the kernel lays them out in shared memory. Layer 0's h rows
    are w3_0[2R:3R] and its z rows zero; layer p >= 1's fold the residual
    update of layer p - 1 into the gate: sqrt(.5) w3_p[2R:3R] on h_{p-1},
    sqrt(.5) wout_{p-1} @ w3_p[2R:3R] on z_{p-1}, and bo_{p-1} @ w3_p[2R:3R]
    into the bias (float64 products, rounded once)."""
    _, _, model = tiny
    packed = wavenet_ops.pack_weights(model.state_dict(), model.cfg.layers)
    r, g, s, c, _ = TINY_WIDTHS
    n_layers, g2, k = model.cfg.layers, g // 2, 3 * r + g // 2 + c
    plan = wavenet_ops.generate_plan(1, TINY_WIDTHS, sms)
    slices = wavenet_ops.kernel_weights(packed, plan)
    cg, cr = -(-2 * plan.pairs // 4) * 4, -(-plan.cols // 4) * 4
    assert slices.shape == (n_layers + 1, plan.blocks, (k + 1) * cg + (g2 + 3) * cr)
    half = np.sqrt(0.5)
    w_h = packed["w3"][:, 2 * r:].double()
    res_rows = torch.cat([torch.cat([packed["wout"], packed["wskip"]], dim=2),
                          torch.cat([packed["bo"], packed["bs"]], dim=1)[:, None],
                          torch.cat([torch.stack([packed["fk"], packed["fb"]]), torch.zeros(2, s)], dim=1)
                          .expand(n_layers, 2, r + s)], dim=1)
    for p in range(n_layers + 1):
        if p < n_layers:
            z_rows = (half * packed["wout"][p - 1].double() @ w_h[p] if p else torch.zeros(g2, g, dtype=torch.float64))
            bias = packed["bg"][p].double() + (half * packed["bo"][p - 1].double() @ w_h[p] if p else 0.0)
            gate_rows = torch.cat([packed["w3"][p, :2 * r].double(), (half if p else 1.0) * w_h[p], z_rows,
                                   packed["wcond"][p].double(), bias[None]]).float()
        for i in range(plan.blocks):
            gate = slices[p, i, : (k + 1) * cg].reshape(k + 1, cg)
            res = slices[p, i, (k + 1) * cg:].reshape(g2 + 3, cr)
            pairs = _owned(plan.blocks, plan.pairs, g2)[i] if p < n_layers else []
            for q, j in enumerate(pairs):
                assert torch.equal(gate[:, 2 * q], gate_rows[:, j])
                assert torch.equal(gate[:, 2 * q + 1], gate_rows[:, g2 + j])
            assert not gate[:, 2 * len(pairs):].any()
            cols = _owned(plan.blocks, plan.cols, r + s)[i] if p > 0 else []
            for q, n in enumerate(cols):
                assert torch.equal(res[:, q], res_rows[p - 1, :, n])
            assert not res[:, len(cols):].any()


@pytest.mark.parametrize("path", [None, "wavenet_f16.npz"])
def test_from_checkpoint_takes_the_jax_arguments(path):
    """``from_checkpoint(cfg, path)`` as JAX's takes them: an artifact gives
    JAX's weights exactly; None gives seeded weights, compared for shape and
    finiteness only (the two packages' seeds draw differently)."""
    full = None if path is None else os.path.join(ARTIFACTS, path)
    kw = TINY_KW if path is None else {}
    jax_voc = jax_wavenet.WaveNetVocoder.from_checkpoint(JaxWaveNetConfig(**kw), full)
    port = WaveNetVocoder.from_checkpoint(WaveNetConfig(**kw), full, device="cpu")
    want = io.wavenet_state_from_jax(jax.tree_util.tree_map(np.asarray, jax_voc.params))
    got = port.model.state_dict()
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k].shape == v.shape and bool(torch.isfinite(got[k]).all()), k
        if path is not None:
            assert torch.equal(got[k], v), k
