"""The port's bfloat16 inference paths against the JAX package's, on the CPU:
the LSTM recurrence (the Pallas kernel's rounding: a float32 carry, the
sequence stored in bfloat16), the layers, the spmel Generator and HiFi-GAN
with ``compute_dtype``/parameters in bfloat16, WaveNet generation with
bfloat16 weights (``pack_weights(..., dtype=jnp.bfloat16)``), the results
manifest and ``cli.synthesize``.

bfloat16 keeps 8 bits of mantissa. Where both sides round the same float32
value at the same point they agree bit for bit; where they sum in another
order, a float32 sum a hair from a rounding boundary rounds to the
neighbouring bfloat16 value, so layers are held to one bfloat16 ulp and a
share of bit-equal elements, and whole networks to JAX's own bfloat16
error against float32."""

import dataclasses
import os
import wave

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from autovc_tpu import models as jax_models
from autovc_tpu.cli import synthesize as jax_synthesize
from autovc_tpu.cli.export_ckpt import load_artifact as jax_load_artifact
from autovc_tpu.config import Config as JaxConfig
from autovc_tpu.config import HiFiGANConfig as JaxHiFiGANConfig
from autovc_tpu.config import WaveNetConfig as JaxWaveNetConfig
from autovc_tpu.data import manifest as jax_manifest
from autovc_tpu.dsp import stft as jax_stft
from autovc_tpu.models import layers as jax_layers
from autovc_tpu.ops.pallas_lstm import _lstm_sequence as jax_lstm_sequence
from autovc_tpu.ops.pallas_wavenet import generate_pallas
from autovc_tpu.ops.pallas_wavenet import pack_weights as jax_pack_weights
from autovc_tpu.vocoder import griffinlim as jax_griffinlim
from autovc_tpu.vocoder import wavenet as jax_wavenet
from autovc_tpu.vocoder.hifigan import HiFiGANVocoder as JaxHiFiGANVocoder
from autovc_tpu.vocoder.hifigan import ResBlock1 as JaxResBlock1
from autovc_tpu_torch import io
from autovc_tpu_torch.cli import synthesize
from autovc_tpu_torch.config import HiFiGANConfig, ModelConfig, WaveNetConfig
from autovc_tpu_torch.convert import Converter
from autovc_tpu_torch.data import load_results, save_results
from autovc_tpu_torch.dsp import griffin_lim
from autovc_tpu_torch.models import LSTM, BatchNorm, ConvNorm, LinearNorm, build_generator
from autovc_tpu_torch.ops import lstm as lstm_ops
from autovc_tpu_torch.ops import wavenet as wavenet_ops
from autovc_tpu_torch.vocoder import WaveNet, WaveNetVocoder, mel_to_linear
from autovc_tpu_torch.vocoder.hifigan import HiFiGANVocoder, ResBlock1

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GEN_ARTIFACT = os.path.join(REPO, "artifacts", "generator_spmel_f16.npz")
VOC_ARTIFACT = os.path.join(REPO, "artifacts", "hifigan.npz")
BF = torch.bfloat16
# A whole bfloat16 network against JAX's float32 one: no worse than this
# times JAX's own bfloat16 path against float32, in max and in mean.
REL = 1.25
TINY_WN = dict(out_channels=12, layers=6, stacks=2, residual_channels=16, gate_channels=16, skip_channels=8,
               cin_channels=80, upsample_scales=(4, 4, 4, 4))


def _bf16_np(a) -> np.ndarray:
    """A JAX bfloat16 array (or a float32 one) as float32 NumPy."""
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _ulps(got: np.ndarray, want: np.ndarray) -> np.ndarray:
    """|got - want| in bfloat16 ulps (8 bits of mantissa) of want, or of
    2^-16 of want's largest magnitude where want is smaller: there the
    float32 sums that both sides round differ by more than the element's
    own ulp (cancellation), e.g. -1.856e-6 and -1.841e-6 for an LSTM output
    whose sequence peaks near 0.7."""
    scale = np.maximum(np.abs(want), 2.0 ** -16 * np.abs(want).max())
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(scale, 1e-30))) - 7)
    return np.abs(got.astype(np.float64) - want) / ulp


def _hold_bf16(got: torch.Tensor, want, equal_share: float = 0.99, max_ulps: float = 1.0) -> None:
    assert got.dtype == BF
    g, w = got.detach().float().numpy(), _bf16_np(want)
    assert g.shape == w.shape
    assert _ulps(g, w).max() <= max_ulps
    assert (g == w).mean() >= equal_share


def _deltas(a: np.ndarray, b: np.ndarray) -> tuple[float, float]:
    d = np.abs(a.astype(np.float64) - b)
    return float(d.max()), float(d.mean())


# ------------------------------------------------------------------ (a) LSTM

@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("b, t, hidden", [(3, 140, 16), (8, 130, 32)])
def test_lstm_plain_bf16_matches_pallas_kernel(b, t, hidden, reverse):
    """T past the Pallas kernel's 128-step chunk, where it hands the float32
    carry to the next call. Every element within 1 bfloat16 ulp of the
    Pallas kernel's (interpret mode), at least 99% bit-equal: both carry h
    and c in float32 and round only the stored h."""
    rng = np.random.RandomState(hidden + t)
    xproj = jnp.asarray((rng.randn(b, t, 4 * hidden) * 0.5).astype(np.float32)).astype(jnp.bfloat16)
    bound = 1.0 / np.sqrt(hidden)
    w_hh = jnp.asarray(rng.uniform(-bound, bound, (hidden, 4 * hidden)).astype(np.float32)).astype(jnp.bfloat16)
    want = jax_lstm_sequence(xproj, w_hh, reverse=reverse, interpret=True)
    got = lstm_ops.lstm_sequence(torch.from_numpy(_bf16_np(xproj)).to(BF),
                                 torch.from_numpy(_bf16_np(w_hh)).to(BF), reverse)
    _hold_bf16(got, want)


def test_lstm_bf16_launch_plans():
    """w_hh in bfloat16 halves each block's slice: regime (a) holds H up to
    160 (float32: 112); the Generator's H=512 and 1024 stay in regime (b)
    at 128 blocks, H=1024 staging 512-float K chunks (float32: 256). The
    float32 plans are as before. The backward's bfloat16 form keeps the
    float32 one's blocks and units, staging chunks twice as long; a w_hh
    element of another size is refused."""
    def top_a(wbytes):
        return max(h for h in range(8, 400, 8)
                   if (p := lstm_ops.launch_plan(32, h, "fwd", 132, wbytes)) is not None and p.regime == "a")

    assert (top_a(4), top_a(2)) == (112, 160)
    assert lstm_ops.launch_plan(32, 1024, "fwd", 132, 2) == lstm_ops.LaunchPlan("fwd", "b", 128, 8, 32, 512, 214016)
    assert lstm_ops.launch_plan(32, 1024, "fwd", 132) == lstm_ops.LaunchPlan("fwd", "b", 128, 8, 32, 256, 214016)
    assert lstm_ops.launch_plan(32, 512, "fwd", 132, 2) == lstm_ops.LaunchPlan("fwd", "b", 128, 4, 32, 512, 164864)
    assert lstm_ops.launch_plan(32, 32, "fwd", 132, 2).smem == 25152
    assert lstm_ops.launch_plan(7, 1024, "bwd", 132, 2) == lstm_ops.LaunchPlan("bwd", "b", 128, 8, 8, 2048, 213248)
    assert lstm_ops.launch_plan(7, 1024, "bwd", 132) == lstm_ops.LaunchPlan("bwd", "b", 128, 8, 8, 1024, 213248)
    with pytest.raises(ValueError):
        lstm_ops.launch_plan(32, 512, "bwd", 132, 3)


# ---------------------------------------------------------------- (b) layers

def _flax(module, x, seed=0, perturb=True):
    """(variables, module output on bfloat16 x) with every parameter moved
    off its initial value (zero biases, unit scales) by a seeded normal."""
    variables = module.init(jax.random.PRNGKey(seed), x)
    if perturb:
        leaves, tree = jax.tree_util.tree_flatten(variables)
        keys = jax.random.split(jax.random.PRNGKey(seed + 1), len(leaves))
        leaves = [a + 0.1 * jax.random.normal(k, a.shape, a.dtype) for a, k in zip(leaves, keys)]
        variables = jax.tree_util.tree_unflatten(tree, leaves)
    return variables, module.apply(variables, x)


def _x(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def test_linear_norm_bf16_matches_flax():
    """flax rounds x @ w to bfloat16, then the bias add: two roundings,
    bit for bit."""
    x = _x((3, 16, 64), 0)
    variables, want = _flax(jax_layers.LinearNorm(48, dtype=jnp.bfloat16), jnp.asarray(x))
    p = variables["params"]["Dense_0"]
    m = LinearNorm(64, 48, dtype=BF)
    m.weight.data = torch.from_numpy(np.asarray(p["kernel"]).T.copy())
    m.bias.data = torch.from_numpy(np.asarray(p["bias"]))
    _hold_bf16(m(torch.from_numpy(x)), want)


def test_conv_norm_bf16_matches_flax():
    x = _x((2, 24, 40), 1)
    variables, want = _flax(jax_layers.ConvNorm(32, 5, dtype=jnp.bfloat16), jnp.asarray(x))
    p = variables["params"]["Conv_0"]
    m = ConvNorm(40, 32, 5, dtype=BF)
    m.weight.data = torch.from_numpy(np.asarray(p["kernel"]).transpose(2, 1, 0).copy())
    m.bias.data = torch.from_numpy(np.asarray(p["bias"]))
    _hold_bf16(m(torch.from_numpy(x)), want)


def test_batch_norm_bf16_matches_flax():
    """Eval form on a bfloat16 input: normalised in float32 with the
    float32 statistics, scale and bias, the output rounded once."""
    x = jnp.asarray(_x((2, 30, 24), 2) * 3 + 1).astype(jnp.bfloat16)
    module = jax_layers.BatchNorm(use_running_average=True, dtype=jnp.bfloat16)
    variables = module.init(jax.random.PRNGKey(0), x)
    rng = np.random.RandomState(3)
    stats = {"mean": rng.randn(24), "var": rng.rand(24) + 0.5}
    params = {"scale": rng.rand(24) + 0.5, "bias": rng.randn(24)}
    variables = {"params": {"BatchNorm_0": {k: jnp.asarray(v, jnp.float32) for k, v in params.items()}},
                 "batch_stats": {"BatchNorm_0": {k: jnp.asarray(v, jnp.float32) for k, v in stats.items()}}}
    want = module.apply(variables, x)
    m = BatchNorm(24, dtype=BF).eval()
    for name, v in (("weight", params["scale"]), ("bias", params["bias"]), ("running_mean", stats["mean"]),
                    ("running_var", stats["var"])):
        getattr(m, name).data = torch.from_numpy(v.astype(np.float32))
    _hold_bf16(m(torch.from_numpy(_bf16_np(x)).to(BF)), want, equal_share=1.0, max_ulps=0.0)


def test_lstm_layer_bf16_matches_flax_pallas():
    """A 2-layer BLSTM in bfloat16 against flax's with the Pallas kernel:
    the input product rounded, then the bias in bfloat16, the recurrence on
    bfloat16 xproj and w_hh. Layer 2 takes layer 1's bfloat16 output, where
    a rounding flipped by the summation order moves it by an ulp, so the
    bound is 2 ulps and 98% bit-equal."""
    x = _x((3, 40, 24), 4)
    module = jax_layers.LSTM(16, num_layers=2, bidirectional=True, dtype=jnp.bfloat16, use_pallas=True)
    variables, want = _flax(module, jnp.asarray(x), perturb=False)
    m = LSTM(24, 16, num_layers=2, bidirectional=True, dtype=BF)
    m.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in variables["params"].items()})
    with torch.inference_mode():
        got = m(torch.from_numpy(x))
    _hold_bf16(got, want, equal_share=0.98, max_ulps=2.0)


# ------------------------------------------------------------- (c) Generator

@pytest.fixture(scope="module")
def generator_mels():
    """B=2, T=128 uniform mels and two random unit embeddings through JAX's
    float32 Generator, its bfloat16 Generator with the Pallas LSTM and with
    the scan, and the port's bfloat16 Generator with the Pallas rounding
    (``use_pallas_lstm=True``), on the committed weights."""
    variables, _ = jax_load_artifact(GEN_ARTIFACT)
    rng = np.random.RandomState(0)
    x = rng.rand(2, 128, 80).astype(np.float32)
    e = rng.randn(2, 256).astype(np.float32)
    e /= np.linalg.norm(e, axis=1, keepdims=True)
    e_org, e_trg = np.repeat(e[:1], 2, 0), np.repeat(e[1:], 2, 0)
    base = JaxConfig().model

    def jax_mel(**kw):
        out = jax_models.build_generator(dataclasses.replace(base, **kw)).apply(
            variables, jnp.asarray(x), jnp.asarray(e_org), jnp.asarray(e_trg), train=False)
        return out

    gen = build_generator(ModelConfig(compute_dtype="bfloat16", use_pallas_lstm=True), artifact=GEN_ARTIFACT,
                          device="cpu")
    with torch.inference_mode():
        port = gen(torch.from_numpy(x), torch.from_numpy(e_org), torch.from_numpy(e_trg))
    specs = [dataclasses.make_dataclass("Spec", ["src_features", "src_embedding", "trg_embedding"])(
        x[i], e_org[i], e_trg[i]) for i in range(2)]
    return {"f32": _bf16_np(jax_mel()[1]), "pallas": jax_mel(compute_dtype="bfloat16", use_pallas_lstm=True),
            "scan": _bf16_np(jax_mel(compute_dtype="bfloat16")[1]), "port": port,
            "converted": Converter(gen).convert_batch(specs, batch_size=2)}


def test_generator_bf16_as_close_to_jax_f32_as_jax_pallas_bf16(generator_mels):
    """The port's bfloat16 Generator is no worse an approximation of JAX's
    float32 Generator than JAX's own bfloat16 Pallas path: max and mean
    absolute mel delta each at most 1.25x JAX's. With
    ``use_pallas_lstm=True`` the port follows the Pallas rounding (a
    float32 LSTM carry), not the scan's (a bfloat16 carry, the default:
    tests/test_torch_scan_generator.py); the distances to both are
    recorded."""
    m = generator_mels
    outputs = [o.dtype for o in m["port"]] + [m["pallas"][1].dtype]
    assert outputs == [BF, BF, BF, jnp.bfloat16]
    port, pallas = m["port"][1].float().numpy(), _bf16_np(m["pallas"][1])
    jax_max, jax_mean = _deltas(pallas, m["f32"])
    port_max, port_mean = _deltas(port, m["f32"])
    print(f"vs JAX f32: JAX Pallas bf16 {jax_max:.4g} / {jax_mean:.4g}, port bf16 {port_max:.4g} / {port_mean:.4g}; "
          f"port vs JAX Pallas bf16 {_deltas(port, pallas)}, vs JAX scan bf16 {_deltas(port, m['scan'])}, "
          f"JAX scan vs f32 {_deltas(m['scan'], m['f32'])}")
    assert port_max <= REL * jax_max and port_mean <= REL * jax_mean
    # the codes and the decoder output are bfloat16 too, and near JAX's
    assert _deltas(m["port"][0].float().numpy(), _bf16_np(m["pallas"][0]))[0] <= 2 * jax_max


def test_converter_returns_float32_with_the_bf16_values(generator_mels):
    """numpy has no bfloat16: convert_batch returns float32 arrays holding
    the Generator's bfloat16 output exactly."""
    want = generator_mels["port"][1].float().numpy()
    for i, got in enumerate(generator_mels["converted"]):
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want[i])
        np.testing.assert_array_equal(torch.from_numpy(got).to(BF).float().numpy(), got)


# --------------------------------------------------------------- (d) HiFi-GAN

def test_resblock_bf16_matches_flax():
    """Each dilated conv rounded, then its bias added in bfloat16, the leaky
    ReLU's slope bfloat16's 0.1: a few summation-order ulps after six convs."""
    x = _x((1, 40, 16), 5)
    module = JaxResBlock1(16, 3, (1, 3, 5))
    variables = module.init(jax.random.PRNGKey(0), jnp.asarray(x))
    vb = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), variables)
    want = module.apply(vb, jnp.asarray(x).astype(jnp.bfloat16))
    m = ResBlock1(16, 3, (1, 3, 5))
    for name, conv in variables["params"].items():
        getattr(m, name).weight.data = torch.from_numpy(np.asarray(conv["kernel"]).transpose(2, 1, 0).copy())
        getattr(m, name).bias.data = torch.from_numpy(np.asarray(conv["bias"]))
    m = m.to(BF)
    with torch.inference_mode():
        got = m(torch.from_numpy(x).to(BF).transpose(1, 2)).transpose(1, 2)
    _hold_bf16(got, want, equal_share=0.95, max_ulps=4.0)


def test_hifigan_bf16_as_close_to_jax_f32_as_jax_bf16():
    """The bench program's vocoder: parameters and mel cast to bfloat16,
    the waveform back to float32 (bench.py:107-118,145-147), on the
    committed weights; the port's waveform no farther from JAX's float32 one
    than 1.25x JAX's own bfloat16 waveform, in max and mean."""
    jv = JaxHiFiGANVocoder.from_checkpoint(JaxHiFiGANConfig(), VOC_ARTIFACT)
    mel = np.random.RandomState(0).rand(1, 12, 80).astype(np.float32)
    f32 = np.asarray(jv.generate(mel))
    params = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16), jv.params)
    jax_bf16 = _bf16_np(jv.model.apply({"params": params}, jnp.asarray(mel).astype(jnp.bfloat16)))
    port = HiFiGANVocoder.from_checkpoint(HiFiGANConfig(), VOC_ARTIFACT, device="cpu", dtype=BF).generate(mel)
    assert port.dtype == torch.float32 and port.shape == (1, 12 * 256)
    port = port.numpy()
    jax_max, jax_mean = _deltas(jax_bf16, f32)
    port_max, port_mean = _deltas(port, f32)
    print(f"vs JAX f32: JAX bf16 {jax_max:.4g} / {jax_mean:.4g}, port bf16 {port_max:.4g} / {port_mean:.4g}")
    assert port_max <= REL * jax_max and port_mean <= REL * jax_mean


# ---------------------------------------------------------------- (e) WaveNet

@pytest.fixture(scope="module")
def tiny_wavenet():
    jcfg = JaxWaveNetConfig(**TINY_WN)
    params = jax_wavenet.init_params(jcfg, jax.random.PRNGKey(0))
    # biases off zero, so that each is exercised; the upsampler keeps its
    # initial kernels (1/4 on the middle frequency row), which map a mel of
    # sixteenths to the same bfloat16-exact cond on both sides
    leaves, tree = jax.tree_util.tree_flatten({k: v for k, v in params.items() if k != "upsample"})
    keys = jax.random.split(jax.random.PRNGKey(1), len(leaves))
    params = dict(jax.tree_util.tree_unflatten(
        tree, [a + 0.05 * jax.random.normal(k, a.shape, a.dtype) for a, k in zip(leaves, keys)]),
        upsample=params["upsample"])
    model = WaveNet(WaveNetConfig(**TINY_WN))
    model.load_state_dict(io.wavenet_state_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    return jcfg, params, model.eval().requires_grad_(False)


def test_wavenet_plain_bf16_matches_pallas_kernel(tiny_wavenet):
    """The plain loop with bfloat16 weights against generate_pallas on
    pack_weights(..., dtype=bfloat16) in interpret mode, on the same cond
    and uniforms: the first 256 samples within 1e-5 (the same rounding
    points; float32 sums in another order). The float32 loop is 1e-3 and
    more away from it: the rounding points are what agrees."""
    jcfg, params, model = tiny_wavenet
    rng = np.random.RandomState(0)
    b, t = 2, 256
    cond = rng.randn(b, t, 80).astype(np.float32)
    u = rng.uniform(1e-5, 1 - 1e-5, (b, t, jcfg.out_channels // 3 + 1)).astype(np.float32)
    want = np.asarray(generate_pallas(jax_pack_weights(params, jcfg.layers, dtype=jnp.bfloat16),
                                      tuple(jcfg.dilations()), jnp.asarray(cond), jnp.asarray(u),
                                      log_scale_min=jcfg.log_scale_min, interpret=True))
    packed = wavenet_ops.pack_weights(model.state_dict(), jcfg.layers, BF)
    assert [packed[k].dtype for k in ("w3", "wcond", "wout", "wskip", "bg", "fk", "l1k")] == [BF] * 4 + [torch.float32] * 3
    got, _ = wavenet_ops.generate_ref(packed, jcfg.dilations(), torch.from_numpy(cond), torch.from_numpy(u),
                                      jcfg.log_scale_min)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    f32, _ = wavenet_ops.generate_ref(wavenet_ops.pack_weights(model.state_dict(), jcfg.layers), jcfg.dilations(),
                                      torch.from_numpy(cond), torch.from_numpy(u), jcfg.log_scale_min)
    assert np.abs(f32.numpy() - want).max() > 1e-3


def test_wavenet_vocoder_bf16_matches_jax_pallas_engine(tiny_wavenet, tmp_path):
    """The entry point: WaveNetVocoder.generate(dtype=bfloat16,
    engine="pallas") against the JAX vocoder's engine='pallas' with bfloat16
    on the uniforms its key
    draws, (B, T, K+1) from the (T, B, K+1) stream; the first 128 samples
    within 1e-5. The mel is in sixteenths, so that both upsamplers give the
    same cond exactly (their float32 sums in another order would otherwise
    round a few cond values to neighbouring bfloat16 values, which moves
    the samples by up to 1e-3)."""
    jcfg, params, _ = tiny_wavenet
    mel = (np.random.RandomState(1).randint(0, 17, (2, 1, 80)) / 16).astype(np.float32)
    key = jax.random.PRNGKey(7)
    want = np.asarray(jax_wavenet.WaveNetVocoder(jcfg, params).generate(
        jnp.asarray(mel), key=key, dtype=jnp.bfloat16, engine="pallas", hbm_threshold=None))
    u = jax.random.uniform(key, (256, 2, jcfg.out_channels // 3 + 1), minval=1e-5, maxval=1.0 - 1e-5)
    artifact = tmp_path / "wavenet_tiny.npz"
    np.savez(artifact, **jax_wavenet.flatten_params(jax.tree_util.tree_map(np.asarray, params)))
    voc = WaveNetVocoder.from_checkpoint(WaveNetConfig(**TINY_WN), str(artifact), device="cpu")
    got = voc.generate(mel, uniforms=torch.from_numpy(np.array(np.asarray(u).swapaxes(0, 1))), dtype=BF,
                       engine="pallas")
    assert got.shape == want.shape == (2, 256)
    np.testing.assert_allclose(got[:, :128].numpy(), want[:, :128], atol=1e-5, rtol=0)


def test_wavenet_teacher_forced_bf16_matches_generation(tiny_wavenet):
    """WaveNet.apply(dtype=bfloat16), the teacher-forced forward at the
    bfloat16 generation's rounding points, on the plain loop's own
    waveform gives the loop's logits within 1e-4 (float32 sums in another
    order; the check chip_smoke.py runs on the kernel's output)."""
    jcfg, _, model = tiny_wavenet
    rng = np.random.RandomState(2)
    mel = torch.from_numpy(rng.rand(2, 1, 80).astype(np.float32))
    cond = model.upsample_conditioning(mel)
    u = torch.from_numpy(rng.uniform(1e-5, 1 - 1e-5, (2, 256, jcfg.out_channels // 3 + 1)).astype(np.float32))
    packed = wavenet_ops.pack_weights(model.state_dict(), jcfg.layers, BF)
    y, logits = wavenet_ops.generate_ref(packed, jcfg.dilations(), cond, u, jcfg.log_scale_min)
    with torch.inference_mode():
        tf = model.apply(y[..., None], mel, BF)
        tf32 = model.apply(y[..., None], mel)
    np.testing.assert_allclose(tf.numpy(), logits.numpy(), atol=1e-4, rtol=0)
    assert (tf32 - logits).abs().max() > 1e-3


def _unpack_bf16_slices(raw: torch.Tensor, steps: int) -> tuple[torch.Tensor, torch.Tensor]:
    """A plain reading of kernel_weights_bf16's slices (L, blocks, bytes):
    ``steps`` k16 steps of 32 lanes x 8 bfloat16 values, lane l = 4g + c
    holding the A tile's (row m, column k) = (g, 2c), (g, 2c+1), (g+8, 2c),
    (g+8, 2c+1), then the same at k + 8 (mma.sync m16n8k16's a0..a7), then
    16 float32 biases -> the weights (L, blocks, 16 steps, 16 columns) and
    the biases (L, blocks, 16)."""
    n_layers, blocks, _ = raw.shape
    frag = raw[..., :steps * 512].contiguous().view(BF).reshape(n_layers, blocks, steps, 32, 8)
    w = torch.zeros((n_layers, blocks, steps, 16, 16), dtype=BF)
    for lane in range(32):
        g, c = lane // 4, 2 * (lane % 4)
        for i, (m, k) in enumerate([(g, c), (g, c + 1), (g + 8, c), (g + 8, c + 1),
                                    (g, c + 8), (g, c + 9), (g + 8, c + 8), (g + 8, c + 9)]):
            w[:, :, :, k, m] = frag[:, :, :, lane, i]
    bias = raw[..., steps * 512:steps * 512 + 64].contiguous().view(torch.float32)
    return w.reshape(n_layers, blocks, steps * 16, 16), bias


def _check_bf16_slices(packed: dict, widths: tuple, plan) -> None:
    """Every (layer, block) slice of kernel_weights_bf16 unpacked against
    [w3; wcond] (each segment padded with zero rows to 64, a staged atom) at
    the block's gate tile (tanh of pairs 8i .. 8i + 7, then their sigmoid
    columns) and [wout | wskip] (G/2 padded to 64) at its residual columns
    16i .. 16i + 15, with bg and [bo | bs]; zero where a block owns no
    column."""
    r, g, s, c, _ = widths
    rp, cp, g2p = -(-r // 64) * 64, -(-c // 64) * 64, -(-(g // 2) // 64) * 64
    gate_raw, res_raw = wavenet_ops.kernel_weights_bf16(packed, plan)
    n_layers = packed["w3"].shape[0]
    assert gate_raw.dtype == torch.uint8 and gate_raw.shape == (n_layers, plan.blocks, (3 * rp + cp) // 16 * 512 + 64)
    assert res_raw.shape == (n_layers, plan.blocks, g2p // 16 * 512 + 64)
    gate_w, gate_b = _unpack_bf16_slices(gate_raw, (3 * rp + cp) // 16)
    res_w, res_b = _unpack_bf16_slices(res_raw, g2p // 16)
    # the padded rows: [w_prev2 | pad | w_prev1 | pad | w_cur | pad | wcond | pad]
    rows = torch.zeros((n_layers, 3 * rp + cp, g), dtype=BF)
    for i in range(3):
        rows[:, i * rp:i * rp + r] = packed["w3"][:, i * r:(i + 1) * r]
    rows[:, 3 * rp:3 * rp + c] = packed["wcond"]
    res_rows = torch.zeros((n_layers, g2p, r + s), dtype=BF)
    res_rows[:, :g // 2] = torch.cat([packed["wout"], packed["wskip"]], dim=2)
    res_bias = torch.cat([packed["bo"], packed["bs"]], dim=1)
    for blk in range(plan.blocks):
        for m in range(16):
            pair = 8 * blk + m % 8
            if pair < g // 2:
                col = pair + (g // 2 if m >= 8 else 0)
                assert torch.equal(gate_w[:, blk, :, m], rows[:, :, col])
                assert torch.equal(gate_b[:, blk, m], packed["bg"][:, col])
            else:
                assert not gate_w[:, blk, :, m].any() and not gate_b[:, blk, m].any()
            col = 16 * blk + m
            if col < r + s:
                assert torch.equal(res_w[:, blk, :, m], res_rows[:, :, col])
                assert torch.equal(res_b[:, blk, m], res_bias[:, col])
            else:
                assert not res_w[:, blk, :, m].any() and not res_b[:, blk, m].any()


def _random_packed(widths: tuple, n_layers: int, seed: int) -> dict:
    r, g, s, c, nout = widths
    gen = torch.Generator().manual_seed(seed)
    rand = lambda *shape: torch.randn(shape, generator=gen)
    return {"w3": rand(n_layers, 3 * r, g).to(BF), "wcond": rand(n_layers, c, g).to(BF),
            "wout": rand(n_layers, g // 2, r).to(BF), "wskip": rand(n_layers, g // 2, s).to(BF),
            "bg": rand(n_layers, g), "bo": rand(n_layers, r), "bs": rand(n_layers, s), "fk": rand(r), "fb": rand(r),
            "l1k": rand(s, s), "l1b": rand(s), "l2k": rand(s, nout), "l2b": rand(nout)}


def test_wavenet_bf16_kernel_layout(tiny_wavenet):
    """kernel_weights_bf16 lays each (layer, block) slice out as the kernel
    reads it: [w3; wcond] at the block's gate tile and [wout | wskip] at its
    residual tile in mma.sync's A-fragment order, each then its float32
    biases; zeros for columns a block does not own. At full width: 48
    blocks of one 16-column tile each way, slices of 53,312 and 8,256 bytes
    (K = 3 x 512 + 128: cond padded to 128).
    The tiny width: one gate tile (block 1 owns none) and two residual
    tiles (8 of block 1's 16 columns past R + S)."""
    full = (512, 512, 256, 80, 30)
    plan = wavenet_ops.generate_plan(8, full, 132, 2)
    assert (plan.blocks, plan.pairs, plan.cols, plan.head_cols) == (48, 8, 16, 6)
    assert wavenet_ops.bf16_slice_bytes(full) == (104 * 512 + 64, 16 * 512 + 64)
    jcfg, _, model = tiny_wavenet
    packed = wavenet_ops.pack_weights(model.state_dict(), jcfg.layers, BF)
    widths = (16, 16, 8, 80, 12)
    plan = wavenet_ops.generate_plan(3, widths, 132, 2)
    assert (plan.blocks, plan.pairs, plan.cols, plan.head_cols, plan.rows) == (2, 8, 16, 4, 8)
    _check_bf16_slices(packed, widths, plan)
    _check_bf16_slices(wavenet_ops.scan_weights(packed), widths, plan)


def test_wavenet_bf16_kernel_layout_full_width():
    """The full-width slices (two layers of seeded weights) read back every
    block's tiles and biases: 32 blocks own a gate tile, all 48 a residual
    tile."""
    full = (512, 512, 256, 80, 30)
    _check_bf16_slices(_random_packed(full, 2, 5), full, wavenet_ops.generate_plan(8, full, 132, 2))


def test_wavenet_bf16_kernel_layout_pads_segments():
    """Widths whose segments are no multiple of 64 (R = 72, C = 40, G/2 =
    24): each is padded with zero rows (R to 128, C and G/2 to 64), the
    columns past G/2 and R + S are zero."""
    widths = (72, 48, 8, 40, 12)
    plan = wavenet_ops.generate_plan(3, widths, 132, 2)
    assert plan.blocks == 5  # gate tiles 3 (24 pairs), residual tiles 5 (80 columns)
    packed = _random_packed(widths, 3, 6)
    _check_bf16_slices(packed, widths, plan)
    gate, res = wavenet_ops.kernel_weights_bf16(packed, plan)
    gate_w, _ = _unpack_bf16_slices(gate, (3 * 128 + 64) // 16)
    for lo, hi in ((72, 128), (200, 256), (328, 384), (384 + 40, 384 + 64)):
        assert not gate_w[:, :, lo:hi].any()
    assert not _unpack_bf16_slices(res, 64 // 16)[0][:, :, 24:].any()


# ------------------------------------------------------- (f) cli.synthesize

def _read_wav(path: str) -> np.ndarray:
    with wave.open(str(path), "rb") as w:
        return np.frombuffer(w.readframes(w.getnframes()), dtype="<i2").astype(np.float32) / 32767.0


@pytest.fixture(scope="module")
def results_pkl(tmp_path_factory):
    """A results pkl of three mels of 2, 1 and 3 frames, written by the port
    and read by both CLIs."""
    rng = np.random.RandomState(8)
    results = [(f"p22{i}_00{i}xp23{i}", rng.rand(n, 80).astype(np.float32)) for i, n in enumerate((2, 1, 3))]
    path = tmp_path_factory.mktemp("results") / "results_0.pkl"
    save_results(str(path), results)
    return path, results


def test_synthesize_hifigan_matches_jax_cli(results_pkl, tmp_path):
    """Both CLIs on the same pkl and artifact: the same files, readme.md
    line for line but the results path, the 16-bit samples within 2 LSB
    (float32 on both sides, summed in other orders)."""
    path, results = results_pkl
    synthesize.main(["--results", str(path), "--out_dir", str(tmp_path / "port"), "--vocoder", "hifigan",
                     "--vocoder_ckpt", VOC_ARTIFACT, "--batch", "2", "--device", "cpu"])
    jax_synthesize.main(["--results", str(path), "--out_dir", str(tmp_path / "jax"), "--vocoder", "hifigan",
                         "--vocoder_ckpt", VOC_ARTIFACT, "--batch", "2", "--platform", "cpu"])
    port_readme = (tmp_path / "port" / "readme.md").read_text().splitlines()
    jax_readme = (tmp_path / "jax" / "readme.md").read_text().splitlines()
    assert port_readme[0] == jax_readme[0] and port_readme[2:] == jax_readme[2:]
    for name, mel in results:
        got, want = _read_wav(tmp_path / "port" / f"{name}.wav"), _read_wav(tmp_path / "jax" / f"{name}.wav")
        assert got.shape == want.shape == (mel.shape[0] * 256,)
        assert np.abs(got - want).max() <= 2 / 32767.0


def _narrow_wavenet(monkeypatch, calls, fake: bool):
    """The CLI builds the published widths, too slow for the plain loop
    here: a narrow stand-in (seeded) takes their place, recording the shape
    and dtype of every generate call; with ``fake``, it returns a cheap
    waveform that peaks at 2 instead of generating."""
    real = WaveNetVocoder.from_checkpoint

    def narrow(cfg, ckpt, *, device="cuda"):
        voc = real(WaveNetConfig(**TINY_WN), ckpt, device=device)
        generate = voc.generate

        def record(mel, uniforms=None, generator=None, dtype=torch.float32, engine="scan"):
            mel = torch.as_tensor(mel)
            calls.append((tuple(mel.shape), dtype))
            if fake:
                ramp = torch.linspace(-2.0, 2.0, mel.shape[-2] * 256)
                return ramp * mel.mean(dim=-1).repeat_interleave(256, dim=-1)
            return generate(mel, uniforms, generator, dtype, engine)

        voc.generate = record
        return voc

    monkeypatch.setattr(WaveNetVocoder, "from_checkpoint", staticmethod(narrow))
    return narrow


def test_synthesize_wavenet_pallas_engine_batched_runs_bf16(results_pkl, tmp_path, monkeypatch):
    """--wavenet_engine pallas implies bfloat16 (a narrow stand-in WaveNet,
    generating on the CPU): the mels go sorted by length in groups of
    --batch, padded to the group's longest; each wav is its Tc*256 samples
    of that group's waveform (16-bit PCM), the readme lists every file."""
    path, results = results_pkl
    calls = []
    narrow = _narrow_wavenet(monkeypatch, calls, fake=False)
    synthesize.main(["--results", str(path), "--out_dir", str(tmp_path), "--vocoder", "wavenet",
                     "--wavenet_engine", "pallas", "--batch", "2", "--device", "cpu"])
    assert calls == [((2, 2, 80), BF), ((1, 3, 80), BF)]
    voc = narrow(None, None, device="cpu")
    lengths = [m.shape[0] for _, m in results]
    group = np.zeros((2, 2, 80), np.float32)
    group[0, :1], group[1] = results[1][1], results[0][1]
    out = voc.generate(group, dtype=BF, engine="pallas")
    want = {1: out[0, :256], 0: out[1], 2: voc.generate(results[2][1][None], dtype=BF, engine="pallas")[0]}
    for i, (name, _) in enumerate(results):
        got, w = _read_wav(tmp_path / f"{name}.wav"), want[i].numpy()
        peak = np.abs(w).max()
        w = w / peak * 0.999 if peak > 0.999 else w
        assert got.shape == (lengths[i] * 256,) and np.isfinite(got).all()
        assert np.abs(got - w).max() <= 1 / 32767.0
    assert len((tmp_path / "readme.md").read_text().splitlines()) == 5 + len(results)


@pytest.mark.parametrize("engine, bf16, dtype", [("scan", False, torch.float32), ("scan", True, BF),
                                                 ("pallas", False, BF)])
def test_synthesize_wavenet_one_at_a_time(results_pkl, tmp_path, monkeypatch, engine, bf16, dtype):
    """One conversion at a time: each mel bucketed to 64 frames (JAX's
    generate_bucketed), the waveform trimmed to Tc*256 and, where its peak
    is above 0.999, rescaled to 0.999 (a stand-in waveform that peaks at
    2); --bf16 or the pallas engine give bfloat16 weights."""
    path, results = results_pkl
    calls = []
    _narrow_wavenet(monkeypatch, calls, fake=True)
    synthesize.main(["--results", str(path), "--out_dir", str(tmp_path), "--vocoder", "wavenet",
                     "--wavenet_engine", engine, *(["--bf16"] if bf16 else []), "--device", "cpu"])
    assert calls == [((64, 80), dtype)] * len(results)
    for name, mel in results:
        padded = np.concatenate([mel, np.repeat(mel[-1:], 64 - mel.shape[0], 0)])
        want = (torch.linspace(-2.0, 2.0, 64 * 256) * torch.from_numpy(padded).mean(-1).repeat_interleave(256))
        want = want[: mel.shape[0] * 256].numpy()
        peak = np.abs(want).max()
        want = want / peak * 0.999 if peak > 0.999 else want
        np.testing.assert_allclose(_read_wav(tmp_path / f"{name}.wav"), want, atol=1 / 32767.0, rtol=0)


def test_synthesize_griffinlim_and_mel_to_linear_match_jax(results_pkl, tmp_path):
    """mel_to_linear against JAX's (float32: the same pinv basis, 1e-5 of
    the magnitude), Griffin-Lim of it from a given phase against JAX's,
    and the CLI's files and readme.md against the JAX CLI's (the random
    initial phases differ). Griffin-Lim needs two frames
    or more (one gives an empty waveform, in JAX too)."""
    _, results = results_pkl
    results = [r for r in results if r[1].shape[0] > 1]
    path = tmp_path / "results_gl.pkl"
    save_results(str(path), results)
    mel = results[1][1]
    want = np.asarray(jax_griffinlim.mel_to_linear(jnp.asarray(mel)))
    got = mel_to_linear(torch.from_numpy(mel)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max(), rtol=0)
    phase = np.exp(2j * np.pi * np.random.RandomState(9).rand(*want.shape)).astype(np.complex64)
    want_wav = np.asarray(jax_stft.griffin_lim(jnp.asarray(want), n_iter=3, init_phase=jnp.asarray(phase)))
    got_wav = griffin_lim(mel_to_linear(torch.from_numpy(mel)), n_iter=3, init_phase=torch.from_numpy(phase)).numpy()
    np.testing.assert_allclose(got_wav, want_wav, atol=1e-4 * np.abs(want_wav).max(), rtol=0)
    synthesize.main(["--results", str(path), "--out_dir", str(tmp_path / "port"), "--gl_iters", "2",
                     "--device", "cpu"])
    jax_synthesize.main(["--results", str(path), "--out_dir", str(tmp_path / "jax"), "--gl_iters", "2",
                         "--platform", "cpu"])
    assert (tmp_path / "port" / "readme.md").read_text().splitlines()[2:] == \
        (tmp_path / "jax" / "readme.md").read_text().splitlines()[2:]
    for name, m in results:
        got, want = _read_wav(tmp_path / "port" / f"{name}.wav"), _read_wav(tmp_path / "jax" / f"{name}.wav")
        assert got.shape == want.shape and np.isfinite(got).all()


# ------------------------------------------------------------ (g) manifest

def test_results_round_trip_with_jax(tmp_path):
    """save_results/load_results keep names and mels exactly, and read and
    write the JAX package's files."""
    rng = np.random.RandomState(10)
    results = [("p225_001xp228", rng.rand(5, 80).astype(np.float32)), ("a", rng.rand(1, 513).astype(np.float32))]
    for save, load in ((save_results, jax_manifest.load_results), (jax_manifest.save_results, load_results),
                       (save_results, load_results)):
        path = str(tmp_path / "results.pkl")
        save(path, results)
        back = load(path)
        assert [n for n, _ in back] == [n for n, _ in results]
        for (_, got), (_, want) in zip(back, results):
            np.testing.assert_array_equal(got, want)


# ---------------------------------------------------- (h) what stays refused

def test_bf16_training_forms_raise():
    """What the bfloat16 forms still refuse: mixed xproj and w_hh dtypes (a
    TypeError, through the autograd Function too), a float32 operand where
    the bfloat16 form takes bfloat16 and a bfloat16 one where it takes
    float32 (TypeError), gate activations from the bfloat16 forward (its
    backward recomputes them from the rounded h_seq), and a compute dtype
    other than float32 and bfloat16. Each raises before a kernel is built."""
    x = torch.zeros((2, 3, 32), dtype=BF, requires_grad=True)
    w = torch.zeros((8, 32), dtype=BF)
    with pytest.raises(TypeError, match="mixed"):
        lstm_ops.lstm_sequence(x, w.float())
    with pytest.raises(TypeError, match="mixed"):
        lstm_ops.LSTMSequenceFn.apply(x.float(), w, None, None, False)
    x = x.detach()
    with pytest.raises(TypeError, match="mixed"):
        lstm_ops.lstm_forward_cuda(x.float(), w)
    with pytest.raises(ValueError, match="gate activations"):
        lstm_ops.lstm_forward_cuda(x, w, with_cseq=True, with_gates=True)
    h = torch.zeros((2, 3, 8), dtype=BF)
    with pytest.raises(TypeError, match="h0"):
        lstm_ops.lstm_forward_cuda(x, w, h0=torch.zeros((2, 8), dtype=BF))
    with pytest.raises(TypeError, match="dy"):
        lstm_ops.lstm_backward_cuda(x, w, None, None, h, h.float(), h.float(), gates=x.float())
    with pytest.raises(TypeError, match="dgates"):
        lstm_ops.lstm_weight_grad_cuda(h, None, x)
    with pytest.raises(TypeError, match="bfloat16 form"):
        lstm_ops.lstm_gates_cuda(x.float(), w.float(), None, h.float())
    with pytest.raises(ValueError):
        ModelConfig(compute_dtype="float16")
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        BatchNorm(4, dtype=torch.float16)
