"""WaveNet generation in the JAX scan engine's bfloat16 rounding, on the CPU:
the port's plain loop (``ops.wavenet.generate_ref(..., scan=True)``) against
``_generate_scan(dtype=bfloat16)``, the ``engine`` argument of the entry
points and of ``cli.synthesize``, and the launch plan of the LSTM scan
forward's kernel (``ops.lstm.scan_plan``).

Both sides get the same uniforms: those ``jax.random.uniform`` draws inside
``_generate_scan`` for a key. The scan rounding rounds every op to bfloat16,
so the two loops keep the same bfloat16 state for as long as each product's
float32 sum rounds to the same value: at these widths for the whole run.
What is left is the float32 head (last1, last2) summed in another order."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from autovc_tpu.config import WaveNetConfig as JaxWaveNetConfig
from autovc_tpu.vocoder import wavenet as jax_wavenet
from autovc_tpu_torch import io
from autovc_tpu_torch.cli import synthesize
from autovc_tpu_torch.config import WaveNetConfig
from autovc_tpu_torch.data import save_results
from autovc_tpu_torch.ops import lstm as lstm_ops
from autovc_tpu_torch.ops import wavenet as wavenet_ops
from autovc_tpu_torch.vocoder import WaveNet, WaveNetVocoder

torch.set_num_threads(1)

BF = torch.bfloat16
TINY = dict(out_channels=12, layers=6, stacks=2, residual_channels=16, gate_channels=16, skip_channels=8,
            cin_channels=80, upsample_scales=(4, 4, 4, 4))
EIGHT = dict(TINY, layers=8, residual_channels=24, gate_channels=32, skip_channels=16)  # dilations 1..8 x 2
# The float32 head's sums in another order: the samples and logits of the
# two loops within this, which holds only while their bfloat16 states are
# the same bits (a state one bfloat16 ulp apart moves the logits by 1e-3).
HEAD_TOL = 1e-6
# The Pallas engine's rounding on the same weights lands this far and more
# from the scan engine's: the control that the tolerance tells them apart.
OTHER_ROUNDING = 1e-3


def _pair(kw, seed):
    """(JAX config, JAX params, port model) with the same weights, every
    bias and weight moved off its initial value (zero biases) so that each
    is exercised; the upsampler keeps its initial kernels."""
    jcfg = JaxWaveNetConfig(**kw)
    params = jax_wavenet.init_params(jcfg, jax.random.PRNGKey(seed))
    leaves, tree = jax.tree_util.tree_flatten({k: v for k, v in params.items() if k != "upsample"})
    keys = jax.random.split(jax.random.PRNGKey(seed + 1), len(leaves))
    params = dict(jax.tree_util.tree_unflatten(
        tree, [a + 0.05 * jax.random.normal(k, a.shape, a.dtype) for a, k in zip(leaves, keys)]),
        upsample=params["upsample"])
    model = WaveNet(WaveNetConfig(**kw))
    model.load_state_dict(io.wavenet_state_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    return jcfg, params, model.eval().requires_grad_(False)


def _uniforms(key, b, length, k_mol):
    """The (B, T, K+1) stream that _generate_scan draws for ``key``."""
    u = jax.random.uniform(key, (length, b, k_mol + 1), minval=1e-5, maxval=1.0 - 1e-5)
    return np.array(np.asarray(u).swapaxes(0, 1))


@pytest.fixture(scope="module")
def tiny():
    return _pair(TINY, 0)


@pytest.mark.parametrize("kw, seed, length", [(TINY, 0, 512), (EIGHT, 5, 256)], ids=["tiny", "eight_layers"])
def test_plain_scan_bf16_matches_jax_scan(kw, seed, length):
    """generate_ref(scan=True) against _generate_scan(dtype=bfloat16) on the
    cond JAX upsamples and the uniforms its key draws: the samples and
    logits within HEAD_TOL over the whole run (the bfloat16 states the same
    bits throughout), while the Pallas engine's rounding is more than
    OTHER_ROUNDING away from JAX's scan."""
    jcfg, params, model = _pair(kw, seed)
    mel = np.random.RandomState(seed).rand(2, length // 256, 80).astype(np.float32)
    cond = jax_wavenet.upsample_conditioning(params, jcfg, jnp.asarray(mel))
    key = jax.random.PRNGKey(seed + 3)
    want_y, want_logits = (np.asarray(a) for a in
                           jax_wavenet._generate_scan(params, jcfg, cond, key, length, dtype=jnp.bfloat16))
    packed = wavenet_ops.pack_weights(model.state_dict(), jcfg.layers, BF)
    u = torch.from_numpy(_uniforms(key, 2, length, jcfg.out_channels // 3))
    cond_t = torch.from_numpy(np.array(cond))
    got_y, got_logits = wavenet_ops.generate_ref(packed, jcfg.dilations(), cond_t, u, jcfg.log_scale_min, scan=True)
    assert got_y.shape == (2, length) and got_logits.shape == (2, length, jcfg.out_channels)
    np.testing.assert_allclose(got_y.numpy(), want_y, atol=HEAD_TOL, rtol=0)
    np.testing.assert_allclose(got_logits.numpy(), want_logits, atol=HEAD_TOL, rtol=0)
    pallas_y, _ = wavenet_ops.generate_ref(packed, jcfg.dilations(), cond_t, u, jcfg.log_scale_min)
    pallas_apart = np.abs(pallas_y.numpy() - want_y).max()
    assert pallas_apart > OTHER_ROUNDING
    print(f"scan bf16 R={jcfg.residual_channels} T={length}: samples {np.abs(got_y.numpy() - want_y).max():.2e}, "
          f"logits {np.abs(got_logits.numpy() - want_logits).max():.2e} from JAX's scan "
          f"({(got_logits.numpy() == want_logits).mean():.3f} bit-equal); the Pallas rounding {pallas_apart:.2e}")


def test_teacher_forced_scan_matches_generation(tiny):
    """WaveNet.apply(dtype=bfloat16, scan=True) on the plain loop's own
    waveform gives the loop's logits (the check chip_smoke.py makes on the
    kernel's output): within HEAD_TOL, while the Pallas rounding's
    teacher-forced forward is more than OTHER_ROUNDING away."""
    jcfg, _, model = tiny
    rng = np.random.RandomState(2)
    mel = torch.from_numpy(rng.rand(2, 1, 80).astype(np.float32))
    cond = model.upsample_conditioning(mel)
    u = torch.from_numpy(rng.uniform(1e-5, 1 - 1e-5, (2, 256, jcfg.out_channels // 3 + 1)).astype(np.float32))
    packed = wavenet_ops.pack_weights(model.state_dict(), jcfg.layers, BF)
    y, logits = wavenet_ops.generate_ref(packed, jcfg.dilations(), cond, u, jcfg.log_scale_min, scan=True)
    with torch.inference_mode():
        tf = model.apply(y[..., None], mel, BF, scan=True)
        tf_pallas = model.apply(y[..., None], mel, BF)
    np.testing.assert_allclose(tf.numpy(), logits.numpy(), atol=HEAD_TOL, rtol=0)
    assert (tf_pallas - logits).abs().max() > OTHER_ROUNDING
    with pytest.raises(ValueError, match="bfloat16"):
        model.apply(y[..., None], mel, torch.float32, scan=True)


def test_scan_weights_round_biases_and_first_conv(tiny):
    """scan_weights rounds bg, bo, bs, fk and fb to bfloat16 values (float32
    tensors, where the kernel reads them), leaves the rest, and refuses
    float32 layer weights."""
    jcfg, _, model = tiny
    packed = wavenet_ops.pack_weights(model.state_dict(), jcfg.layers, BF)
    scan = wavenet_ops.scan_weights(packed)
    for key in wavenet_ops.PACKED_KEYS:
        if key in ("bg", "bo", "bs", "fk", "fb"):
            assert scan[key].dtype == torch.float32 and torch.equal(scan[key], packed[key].to(BF).float())
            assert not torch.equal(scan[key], packed[key])
        else:
            assert scan[key] is packed[key]
    with pytest.raises(ValueError, match="bfloat16"):
        wavenet_ops.scan_weights(wavenet_ops.pack_weights(model.state_dict(), jcfg.layers))


def _vocoder(jcfg, params, tmp_path):
    artifact = tmp_path / "wavenet_tiny.npz"
    np.savez(artifact, **jax_wavenet.flatten_params(jax.tree_util.tree_map(np.asarray, params)))
    return WaveNetVocoder.from_checkpoint(WaveNetConfig(**TINY), str(artifact), device="cpu")


def test_vocoder_engines_match_jax_engines(tiny, tmp_path):
    """WaveNetVocoder.generate(dtype=bfloat16) against the JAX vocoder on the
    uniforms its key draws: the default engine, "scan", within HEAD_TOL of
    JAX's default scan engine in bfloat16 over all 512 samples; "pallas"
    runs the other rounding (more than OTHER_ROUNDING away); in float32 the
    two engines are the same loop. The mel is in sixteenths, so that both
    upsamplers give the same cond exactly."""
    jcfg, params, _ = tiny
    mel = (np.random.RandomState(1).randint(0, 17, (2, 2, 80)) / 16).astype(np.float32)
    key = jax.random.PRNGKey(7)
    want = np.asarray(jax_wavenet.WaveNetVocoder(jcfg, params).generate(jnp.asarray(mel), key=key,
                                                                         dtype=jnp.bfloat16))
    u = torch.from_numpy(_uniforms(key, 2, 512, jcfg.out_channels // 3))
    voc = _vocoder(jcfg, params, tmp_path)
    got = voc.generate(mel, uniforms=u, dtype=BF)
    assert got.shape == want.shape == (2, 512)
    np.testing.assert_allclose(got.numpy(), want, atol=HEAD_TOL, rtol=0)
    assert torch.equal(voc.generate(mel, uniforms=u, dtype=BF, engine="scan"), got)
    assert np.abs(voc.generate(mel, uniforms=u, dtype=BF, engine="pallas").numpy() - want).max() > OTHER_ROUNDING
    assert torch.equal(voc.generate(mel, uniforms=u, engine="scan"), voc.generate(mel, uniforms=u, engine="pallas"))
    with pytest.raises(ValueError, match="engine"):
        voc.generate(mel, uniforms=u, dtype=BF, engine="lax")


@pytest.mark.parametrize("engine", ["scan", "pallas"])
def test_generate_bucketed_passes_the_engine(tiny, tmp_path, engine):
    """generate_bucketed pads, generates in the engine's rounding and trims:
    the same samples as generate on the padded mel with that engine."""
    jcfg, params, _ = tiny
    voc = _vocoder(jcfg, params, tmp_path)
    mel = np.random.RandomState(3).rand(3, 80).astype(np.float32)
    u = voc.uniforms(1, 4 * 256, torch.Generator().manual_seed(9))[0]
    got = voc.generate_bucketed(mel, bucket=4, uniforms=u, dtype=BF, engine=engine)
    padded = np.concatenate([mel, mel[-1:]])
    want = voc.generate(padded, uniforms=u, dtype=BF, engine=engine)[: 3 * 256]
    assert got.shape == (3 * 256,) and torch.equal(got, want)


@pytest.mark.parametrize("flags, dtype, engine", [(["--bf16"], BF, "scan"),
                                                  (["--bf16", "--wavenet_engine", "scan"], BF, "scan"),
                                                  (["--wavenet_engine", "pallas"], BF, "pallas"),
                                                  (["--wavenet_engine", "pallas", "--batch", "2"], BF, "pallas"),
                                                  (["--bf16", "--batch", "2"], BF, "scan"),
                                                  ([], torch.float32, "scan")],
                         ids=["bf16_default_engine", "bf16_scan", "pallas", "pallas_batched", "bf16_batched",
                              "float32"])
def test_synthesize_runs_the_engine_rounding(tiny, tmp_path, monkeypatch, flags, dtype, engine):
    """cli.synthesize --vocoder wavenet passes every generate call the dtype
    and engine the JAX CLI would run (--bf16 keeps the default scan engine,
    pallas implies bfloat16), one mel at a time (bucketed to 64 frames) and
    batched. A stand-in generate records them and returns a cheap waveform:
    the CLI builds the published widths, too slow for the plain loop here;
    test_vocoder_engines_match_jax_engines holds what each engine computes."""
    jcfg, params, _ = tiny
    voc = _vocoder(jcfg, params, tmp_path)
    calls = []

    def record(mel, uniforms=None, generator=None, dtype=torch.float32, engine="scan"):
        mel = torch.as_tensor(mel)
        calls.append((tuple(mel.shape), dtype, engine))
        return torch.zeros(mel.shape[:-2] + (mel.shape[-2] * 256,))

    voc.generate = record
    monkeypatch.setattr(WaveNetVocoder, "from_checkpoint", staticmethod(lambda cfg, ckpt, *, device="cuda": voc))
    rng = np.random.RandomState(4)
    results = tmp_path / "results_0.pkl"
    save_results(str(results), [("conv0", rng.rand(1, 80).astype(np.float32)),
                                ("conv1", rng.rand(2, 80).astype(np.float32))])
    synthesize.main(["--results", str(results), "--out_dir", str(tmp_path / "out"), "--vocoder", "wavenet",
                     *flags, "--device", "cpu"])
    shapes = [(2, 2, 80)] if "--batch" in flags else [(64, 80), (64, 80)]
    assert calls == [(shape, dtype, engine) for shape in shapes]


def test_generate_cuda_scan_refuses_cpu_tensors_and_float32_weights(tiny):
    """The kernel's wrapper takes bfloat16 weights for the scan rounding and
    tensors on a card: it raises before any build here."""
    jcfg, _, model = tiny
    cond = torch.zeros(1, 4, 80)
    u = torch.full((1, 4, jcfg.out_channels // 3 + 1), 0.5)
    with pytest.raises(ValueError, match="bfloat16"):
        wavenet_ops.generate_cuda(wavenet_ops.pack_weights(model.state_dict(), jcfg.layers), jcfg.dilations(),
                                  cond, u, scan=True)
    with pytest.raises(ValueError, match="CUDA"):
        wavenet_ops.generate_cuda(wavenet_ops.pack_weights(model.state_dict(), jcfg.layers, BF),
                                  jcfg.dilations(), cond, u, scan=True)


# ------------------------------------------------- the LSTM scan forward's plan

def _smem(k, rows, m_tiles, parts):
    """The kernel's shared bytes: 1 KB of alignment, W^T in bfloat16 over K
    = k (H rounded up to 64), the h tile as two K halves of ceil(k / 128)
    64-k atoms of rows x 128 bytes, the K parts' sums (regime (a) one,
    regime (b) its two K halves) in rows of 64 m-tiles + 20 floats, and two
    8-byte mbarriers."""
    half = -(-k // 128)
    return 1024 + 2 * 64 * m_tiles * k + 2 * half * rows * 128 + 4 * parts * rows * (64 * m_tiles + 20) + 16


@pytest.mark.parametrize("batch, hidden, want", [
    (32, 32, lstm_ops.ScanPlan("a", 4, 32, 8, _smem(64, 8, 2, 1))),
    (7, 32, lstm_ops.ScanPlan("a", 1, 32, 8, _smem(64, 8, 2, 1))),
    (32, 512, lstm_ops.ScanPlan("b", 64, 8, 32, _smem(512, 32, 1, 2))),
    (32, 1024, lstm_ops.ScanPlan("b", 128, 8, 32, 219152)),
    (7, 1024, lstm_ops.ScanPlan("b", 128, 8, 8, _smem(1024, 8, 1, 2))),
    (1, 768, lstm_ops.ScanPlan("b", 96, 8, 8, _smem(768, 8, 1, 2))),
    (20, 256, lstm_ops.ScanPlan("b", 32, 8, 24, _smem(256, 24, 1, 2))),
    (37, 64, lstm_ops.ScanPlan("b", 8, 8, 32, _smem(64, 32, 1, 2))),
    (5, 40, lstm_ops.ScanPlan("b", 5, 8, 8, _smem(64, 8, 1, 2))),
    (3, 8, lstm_ops.ScanPlan("a", 1, 8, 8, _smem(64, 8, 1, 1))),
])
def test_scan_plan_shapes(batch, hidden, want):
    """The plan at the Generator's (B=32, T=512 and B=7) and the d-vector's
    (B=1, 20) shapes and at odd ones: regime (a) up to H=32 (8 rows a block,
    W^T in one or two 64-column m-tiles); regime (b) 8 units a block, a tile
    of B rows rounded up to 8, at most 32 (B=37: two tiles); the shared
    bytes as the kernel lays them out (``_smem``)."""
    assert lstm_ops.scan_plan(batch, hidden, 132) == want
    assert want.smem <= lstm_ops.SMEM_MAX
    assert want.rows % 8 == 0 and want.rows * want.units <= lstm_ops.SCAN_MAX_PAIRS * lstm_ops.THREADS


def test_scan_plan_refusals_and_forced_units():
    """H % 8 != 0 is planned at the padded width (36 -> 40); an H whose W^T
    and h tile overflow shared memory takes regime (c) (its first atoms
    resident, the rest streamed); where H / 8 blocks would outnumber the
    SMs, 16 units a block: at H=1024 on 100 SMs 64 blocks of the same
    bytes (all 64 columns of the tile), and none where H / 16 blocks do
    too."""
    assert lstm_ops.scan_plan(32, 36, 132) == lstm_ops.scan_plan(32, 40, 132)
    assert lstm_ops.scan_plan(32, 1152, 132).regime == "c"
    # H=2048, B=7: 9 of each half's 16 atoms resident and 4 ring slots of 8 KB, the h tile, the two K
    # halves' sums, six mbarriers
    assert lstm_ops.scan_plan(7, 2048, 132) == lstm_ops.ScanPlan(
        "c", 128, 16, 8, 1024 + (9 + 9 + 4) * 8192 + 2 * 16 * 8 * 128 + 4 * 2 * 8 * 84 + 6 * 8, 9)
    assert lstm_ops.scan_plan(32, 1024, 100) == lstm_ops.ScanPlan("b", 64, 16, 32, 219152)
    assert lstm_ops.scan_plan(32, 512, 63) == lstm_ops.ScanPlan("b", 32, 16, 32, _smem(512, 32, 1, 2))
    assert lstm_ops.scan_plan(32, 1024, 60) is None


def test_scan_forward_wrapper_refuses_what_it_does_not_take():
    """float32 inputs and CPU tensors raise before any build."""
    x = torch.zeros(2, 3, 32, dtype=BF)
    w = torch.zeros(8, 32, dtype=BF)
    with pytest.raises(TypeError, match="bfloat16"):
        lstm_ops.lstm_scan_forward_cuda(x.float(), w.float())
    with pytest.raises(ValueError, match="one CUDA device"):
        lstm_ops.lstm_scan_forward_cuda(x, w)
