"""The stft and wav variants of the port against the JAX package on the CPU:
the wav variant's layers (PReLU, the ConvTasNet convolutions) in float32
and in bfloat16 bit for bit against flax, the ConvTasNet front and back
end, ``GeneratorWav`` and the stft ``Generator`` on carried weights, the
weight bridge of ``GeneratorWav`` both ways, the SDR losses, the stft and
wav losses and gradients against ``jax.grad`` of the JAX loss, the wav
network in bfloat16 by the relative rule, the compare tools' PReLU and
conv-bias rules, and the Solver and ``cli.train`` on both variants.

Narrow widths (ConvTasNet 16 channels, encoder 32, decoder LSTM 64, freq 4)
at the real ConvTasNet kernel and stride (1024, 256): a waveform of 2816
samples is 8 latent frames."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as fnn

from autovc_tpu.config import Config as JaxConfig
from autovc_tpu.config import ModelConfig as JaxModelConfig
from autovc_tpu.config import TrainConfig as JaxTrainConfig
from autovc_tpu.config import AudioConfig as JaxAudioConfig
from autovc_tpu.config import wav_len_crop as jax_wav_len_crop
from autovc_tpu.losses import neg_sdr as jax_neg_sdr
from autovc_tpu.models.autovc import Decoder, Encoder, Generator as JaxGenerator, Postnet
from autovc_tpu.models.convtas import ConvTasDecoder as JaxTasDecoder
from autovc_tpu.models.convtas import ConvTasEncoder as JaxTasEncoder
from autovc_tpu.models.convtas import GeneratorWav as JaxGeneratorWav
from autovc_tpu.models.layers import ConvTranspose1d as JaxConvTranspose1d
from autovc_tpu.models.layers import PReLU as JaxPReLU
from autovc_tpu.train import step as jax_step
from autovc_tpu_torch.config import AudioConfig, Config, ModelConfig, TrainConfig, wav_len_crop
from autovc_tpu_torch.io import (flatten_params, generator_state_from_jax, generator_state_to_jax, load_artifact,
                                 save_generator_artifact)
from autovc_tpu_torch.losses import neg_sdr, si_snr_loss
from autovc_tpu_torch.models import build_generator
from autovc_tpu_torch.models.convtas import ConvTasDecoder, ConvTasEncoder
from autovc_tpu_torch.models.layers import Conv, ConvTranspose1d, PReLU
from autovc_tpu_torch.train import loss_fn
from autovc_tpu_torch.train.compare import KinkTape, grad_scale

torch.set_num_threads(1)

BF = torch.bfloat16
NARROW = dict(dim_neck=8, dim_emb=16, dim_pre=32, freq=4)
CHANNELS = 16  # the ConvTasNet latent's width
L = 2816  # (8 - 1) * 256 + 1024 samples: 8 latent frames


class NarrowWav(JaxGeneratorWav):
    """The JAX wav generator at narrow widths (encoder channels 32, decoder
    lstm_dim 64; the JAX package hard-codes the published ones)."""

    def setup(self):
        self.tas_encoder = JaxTasEncoder(self.depth, self.channels, dtype=self.dtype)
        self.encoder = Encoder(self.dim_neck, self.freq, channels=32, dtype=self.dtype, use_pallas=self.use_pallas)
        self.decoder = Decoder(self.channels, self.dim_pre, lstm_dim=64, dtype=self.dtype, use_pallas=self.use_pallas)
        self.tas_decoder = JaxTasDecoder(self.depth, self.channels, dtype=self.dtype)


class NarrowStft(JaxGenerator):
    """The JAX generator at narrow widths, 513 bins."""

    def setup(self):
        self.encoder = Encoder(self.dim_neck, self.freq, channels=32)
        self.decoder = Decoder(self.n_bins, self.dim_pre, lstm_dim=64)
        self.postnet = Postnet(self.n_bins, channels=32)


WIDTHS = dict(**NARROW, enc_channels=32, dec_lstm_dim=64, postnet_channels=32)
WAV_MODEL = ModelConfig(model_type="wav", convtas_channels=CHANNELS, use_pallas_lstm=True, **WIDTHS)
STFT_MODEL = ModelConfig(model_type="stft", use_pallas_lstm=True, **WIDTHS)
JAX_WAV = NarrowWav(**NARROW, channels=CHANNELS)
JAX_WAV_BF16 = NarrowWav(**NARROW, channels=CHANNELS, dtype=jnp.bfloat16, use_pallas=True)
JAX_STFT = NarrowStft(**NARROW, n_bins=513)


def _jax_cfg(model_type, **train):
    return JaxConfig(model=JaxModelConfig(model_type=model_type, **NARROW, convtas_channels=CHANNELS),
                     train=JaxTrainConfig(**train))


def _wave(seed, b=2, n=L):
    """Robust-scaled-like waveforms (a few harmonics and noise) and unit
    embeddings."""
    rng = np.random.RandomState(seed)
    t = np.arange(n) / 16000.0
    f0 = rng.uniform(100, 250, (b, 1))
    x = sum(np.sin(2 * np.pi * k * f0 * t + rng.uniform(0, 6, (b, 1))) / k for k in range(1, 6))
    x = (0.5 * x + 0.1 * rng.randn(b, n)).astype(np.float32)[..., None]
    emb = rng.randn(b, NARROW["dim_emb"]).astype(np.float32)
    return x, emb / np.linalg.norm(emb, axis=1, keepdims=True)


def _stft_batch(seed, b=2, t=8):
    rng = np.random.RandomState(seed)
    return rng.rand(b, t, 513).astype(np.float32), rng.randn(b, NARROW["dim_emb"]).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _jax_init(kind, seed=0):
    """JAX variables of the narrow wav or stft generator (read, never
    changed, by the tests)."""
    model, (x, emb) = (JAX_WAV, _wave(100)) if kind == "wav" else (JAX_STFT, _stft_batch(100))
    return model.init(jax.random.PRNGKey(seed), jnp.asarray(x), jnp.asarray(emb), jnp.asarray(emb))


def _port(kind, variables=None, compute_dtype="float32", trainable=False):
    cfg = dataclasses.replace(WAV_MODEL if kind == "wav" else STFT_MODEL, compute_dtype=compute_dtype)
    model = build_generator(cfg, device="cpu", trainable=trainable)
    model.load_state_dict(generator_state_from_jax(variables or _jax_init(kind)))
    return model


def _bits(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    assert str(got.dtype).removeprefix("torch.") == str(want.dtype), (got.dtype, want.dtype)
    np.testing.assert_array_equal(got.float().numpy(), want.astype(np.float32))


# ------------------------------------------------------------------ (a) layers


@pytest.mark.parametrize("bf16", [False, True])
def test_prelu_matches_flax(bf16):
    """f32 within 1e-6; a bfloat16 input with the float32 slope gives
    float32, bit for bit (JAX's promotion in ``jnp.where``)."""
    rng = np.random.RandomState(0)
    x = rng.randn(2, 8, 16).astype(np.float32)
    alpha = np.asarray([0.3], np.float32)
    xj = jnp.asarray(x).astype(jnp.bfloat16) if bf16 else jnp.asarray(x)
    want = JaxPReLU().apply({"params": {"alpha": jnp.asarray(alpha)}}, xj)
    layer = PReLU()
    layer.alpha.data = torch.from_numpy(alpha)
    with torch.no_grad():
        got = layer(torch.from_numpy(x).to(BF) if bf16 else torch.from_numpy(x))
    if bf16:
        _bits(got, want)
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)


# (kernel, stride, padding, input frames): convT0 and convT_out
CONVT_SHAPES = [(3, 1, 1, 8), (1024, 256, 0, 8)]


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("k, s, p, t", CONVT_SHAPES)
def test_conv_transpose_matches_jax(k, s, p, t, bf16):
    """The (k, out, in) JAX kernel carried as (in, out, k), no flip along k:
    the output length (T - 1) * s - 2p + k; f32 within 1e-6 of the output's
    scale, bfloat16 bit for bit."""
    out_ch = 1 if k == 1024 else CHANNELS
    rng = np.random.RandomState(k)
    x = rng.randn(2, t, CHANNELS).astype(np.float32)
    jl = JaxConvTranspose1d(out_ch, k, s, p, dtype=jnp.bfloat16 if bf16 else None)
    variables = jl.init(jax.random.PRNGKey(1), jnp.asarray(x))
    want = jl.apply(variables, jnp.asarray(x))
    layer = ConvTranspose1d(CHANNELS, out_ch, k, s, p, dtype=BF if bf16 else torch.float32)
    layer.load_state_dict({n.split(".", 1)[1]: v for n, v in generator_state_from_jax(
        {"params": {"m": variables["params"]}, "batch_stats": {}}).items()})
    with torch.no_grad():
        got = layer(torch.from_numpy(x).to(BF) if bf16 else torch.from_numpy(x))
    assert got.shape == ((2, (t - 1) * s - 2 * p + k, out_ch))
    if bf16:
        _bits(got, want)
    else:
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6 * np.abs(want).max(), rtol=0)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("k, s, p, c_in", [(1024, 256, 0, 1), (3, 1, 1, CHANNELS)])
def test_conv_matches_flax(k, s, p, c_in, bf16):
    """The front end's convolutions (conv_in: VALID at stride 256; conv{i}:
    k 3, pad 1) against ``nn.Conv``; f32 within 1e-6 of the output's scale,
    bfloat16 bit for bit."""
    rng = np.random.RandomState(k + c_in)
    x = rng.randn(2, L if k == 1024 else 8, c_in).astype(np.float32)
    jl = fnn.Conv(CHANNELS, kernel_size=(k,), strides=(s,), padding="VALID" if p == 0 else [(p, p)],
                  dtype=jnp.bfloat16 if bf16 else None)
    variables = jl.init(jax.random.PRNGKey(2), jnp.asarray(x))
    variables = {"params": {"kernel": variables["params"]["kernel"],
                            "bias": jnp.asarray(rng.randn(CHANNELS).astype(np.float32) * 0.1)}}
    want = jl.apply(variables, jnp.asarray(x))
    layer = Conv(c_in, CHANNELS, k, s, p, dtype=BF if bf16 else torch.float32)
    layer.weight.data = torch.from_numpy(np.asarray(variables["params"]["kernel"]).transpose(2, 1, 0).copy())
    layer.bias.data = torch.from_numpy(np.asarray(variables["params"]["bias"]))
    with torch.no_grad():
        got = layer(torch.from_numpy(x).to(BF) if bf16 else torch.from_numpy(x))
    assert got.shape == want.shape
    if bf16:
        _bits(got, want)
    else:
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6 * np.abs(want).max(), rtol=0)


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("part", ["encoder", "decoder"])
def test_convtas_layers_in_bf16_match_flax(part, train):
    """Each layer of the ConvTasNet front and back end with
    ``dtype=jnp.bfloat16``, bit for bit: the convolution's bfloat16 output,
    the PReLU's float32 one, the BatchNorm's bfloat16 one (statistics of its
    float32 input), and the updated running statistics in training form."""
    variables = _jax_init("wav")
    sub = {c: variables[c][f"tas_{part}"] for c in ("params", "batch_stats")}
    x, _ = _wave(3)
    if part == "decoder":
        x = np.random.RandomState(3).randn(2, 8, CHANNELS).astype(np.float32)
    jm = (JaxTasEncoder if part == "encoder" else JaxTasDecoder)(1, CHANNELS, dtype=jnp.bfloat16)
    names = (["conv_in", "conv0", "prelu0", "bn0"] if part == "encoder" else ["convT0", "prelu0", "bn0", "convT_out"])
    want, upd = jm.apply(sub, jnp.asarray(x), train=train, mutable=["batch_stats", "intermediates"],
                         capture_intermediates=True)
    model = (ConvTasEncoder if part == "encoder" else ConvTasDecoder)(1, CHANNELS, dtype=BF).train(train)
    model.load_state_dict({n.split(".", 1)[1]: v for n, v in generator_state_from_jax(
        {"params": {"m": sub["params"]}, "batch_stats": {"m": sub["batch_stats"]}}).items()})
    outs = {}
    for n in names:
        getattr(model, n).register_forward_hook(lambda m, i, o, n=n: outs.__setitem__(n, o))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    inter = upd["intermediates"]
    for n in names:
        _bits(outs[n], inter[n]["__call__"][0])
    _bits(got, want)
    if train:
        stats = generator_state_from_jax({"params": {}, "batch_stats": {"m": upd["batch_stats"]}})
        for n, buf in model.named_buffers():
            np.testing.assert_array_equal(buf.numpy(), stats[f"m.{n}"].numpy())


# ------------------------------------------------------------------ (b) models


@pytest.mark.parametrize("train", [True, False])
def test_convtas_encoder_and_decoder_match_jax(train):
    """The f32 front end on a waveform and the back end on its latent,
    within 1e-4, in training form (batch statistics) and in eval form."""
    variables = _jax_init("wav")
    x, _ = _wave(4)
    sub = {c: variables[c]["tas_encoder"] for c in ("params", "batch_stats")}
    want_lat, _ = JaxTasEncoder(1, CHANNELS).apply(sub, jnp.asarray(x), train=train, mutable=["batch_stats"])
    sub = {c: variables[c]["tas_decoder"] for c in ("params", "batch_stats")}
    want_wav, _ = JaxTasDecoder(1, CHANNELS).apply(sub, want_lat, train=train, mutable=["batch_stats"])
    model = _port("wav").train(train)
    with torch.no_grad():
        lat = model.tas_encoder(torch.from_numpy(x))
        wav = model.tas_decoder(torch.from_numpy(np.asarray(want_lat)))
    assert lat.shape == (2, 8, CHANNELS) and wav.shape == (2, L, 1)
    np.testing.assert_allclose(lat.numpy(), np.asarray(want_lat), atol=1e-4, rtol=0)
    np.testing.assert_allclose(wav.numpy(), np.asarray(want_wav), atol=1e-4, rtol=0)


@pytest.mark.parametrize("train", [True, False])
def test_generator_wav_forward_and_encode_match_jax(train):
    """``GeneratorWav``'s four outputs and ``encode`` within 1e-4 of JAX's on
    the carried weights; in training form the updated statistics too."""
    variables = _jax_init("wav")
    x, emb = _wave(5)
    args = (jnp.asarray(x), jnp.asarray(emb))
    want, upd = JAX_WAV.apply(variables, *args, args[1], train=train, mutable=["batch_stats"])
    want_codes, _ = JAX_WAV.apply(variables, *args, train=train, method=JaxGeneratorWav.encode,
                                  mutable=["batch_stats"])
    model = _port("wav").train(train)
    codes_model = _port("wav").train(train)
    xt, et = torch.from_numpy(x), torch.from_numpy(emb)
    with torch.no_grad():
        got = model(xt, et, et)
        codes = codes_model.encode(xt, et)
    assert [tuple(g.shape) for g in got] == [(2, 8, CHANNELS), (2, L, 1), (2, 8, CHANNELS), (2, 2 * 2 * 8)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4, rtol=0)
    np.testing.assert_allclose(codes.numpy(), np.asarray(want_codes), atol=1e-4, rtol=0)
    if train:
        stats = generator_state_from_jax({"params": {}, "batch_stats": upd["batch_stats"]})
        for n, buf in model.named_buffers():
            np.testing.assert_allclose(buf.numpy(), stats[n].numpy(), atol=1e-5, rtol=0, err_msg=n)
    with pytest.raises(ValueError, match=r"\(B, L, 1\)"):
        model(xt[..., 0], et, et)


def test_stft_generator_matches_jax():
    """The 513-bin generator's three outputs within 1e-4 of JAX's."""
    x, emb = _stft_batch(6)
    want = JAX_STFT.apply(_jax_init("stft"), jnp.asarray(x), jnp.asarray(emb), jnp.asarray(emb), train=False)
    with torch.no_grad():
        got = _port("stft")(torch.from_numpy(x), torch.from_numpy(emb), torch.from_numpy(emb))
    assert got[0].shape == (2, 8, 513)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4, rtol=0)


def test_config_matches_jax():
    assert [ModelConfig(model_type=m).n_bins for m in ("spmel", "stft", "wav")] == [
        JaxModelConfig(model_type=m).n_bins for m in ("spmel", "stft", "wav")] == [80, 513, 512]
    assert wav_len_crop(AudioConfig()) == jax_wav_len_crop(JaxAudioConfig()) == 33536
    assert TrainConfig().lambda_sisnr == JaxTrainConfig().lambda_sisnr == 1.0
    with pytest.raises(ValueError, match="unknown model_type"):
        ModelConfig(model_type="mfcc").n_bins


# ------------------------------------------------------------------ (c) bridge


def test_wav_weight_bridge_both_ways(tmp_path):
    """JAX tree -> state dict -> JAX tree bit for bit (the bare ConvTasNet
    convolutions and the PReLU slopes without a flax wrapper); the port's
    export loads in JAX's ``load_artifact`` and gives the same outputs; a
    seeded port generator exported and loaded back is the same generator."""
    from autovc_tpu.cli.export_ckpt import load_artifact as jax_load_artifact

    variables = _jax_init("wav")
    state = generator_state_from_jax(variables)
    back = flatten_params(generator_state_to_jax(state))
    want = flatten_params(jax.tree_util.tree_map(np.asarray, dict(variables)))
    assert back.keys() == want.keys()
    assert all(np.array_equal(back[k], want[k]) for k in want)
    assert "params/tas_encoder/conv_in/kernel" in back and "params/tas_decoder/prelu0/alpha" in back

    seeded = build_generator(WAV_MODEL, device="cpu", seed=3)
    out = str(tmp_path / "wav.npz")
    save_generator_artifact(seeded.state_dict(), 7, out)
    jvars, step = jax_load_artifact(out)
    assert step == 7 and load_artifact(out)[1] == 7
    again = build_generator(WAV_MODEL, artifact=out, device="cpu")
    assert all(torch.equal(v, again.state_dict()[k]) for k, v in seeded.state_dict().items())
    x, emb = _wave(7)
    want = JAX_WAV.apply(jvars, jnp.asarray(x), jnp.asarray(emb), jnp.asarray(emb), train=False)
    with torch.no_grad():
        got = seeded(torch.from_numpy(x), torch.from_numpy(emb), torch.from_numpy(emb))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4, rtol=0)


def test_build_generator_variants_and_dtypes():
    """Seeded weights for every variant in f32 and bf16: the same float32
    parameters for one seed whatever the compute dtype; the PReLU slopes at
    0.25, the ConvTasNet biases zero for conv, uniform for the transposed."""
    for cfg in (STFT_MODEL, WAV_MODEL):
        a = build_generator(cfg, device="cpu", seed=4)
        b = build_generator(dataclasses.replace(cfg, compute_dtype="bfloat16"), device="cpu", seed=4)
        assert all(torch.equal(v, b.state_dict()[k]) for k, v in a.state_dict().items())
        assert {p.dtype for p in b.parameters()} == {torch.float32}
    wav = build_generator(WAV_MODEL, device="cpu", seed=4)
    assert float(wav.tas_encoder.prelu0.alpha) == float(wav.tas_decoder.prelu0.alpha) == 0.25
    assert not wav.tas_encoder.conv_in.bias.any() and wav.tas_decoder.convT_out.bias.abs().max() <= 1 / np.sqrt(
        CHANNELS * 1024)
    assert float(wav.tas_encoder.conv_in.weight.std()) * 32 == pytest.approx(1.0, rel=0.05)  # 1/sqrt(fan_in 1024)
    with pytest.raises(ValueError, match="unknown model_type"):
        build_generator(ModelConfig(model_type="mfcc"), device="cpu")


# ------------------------------------------------------------------ (d) losses


@pytest.mark.parametrize("reduction", ["mean", "none"])
@pytest.mark.parametrize("take_log", [True, False])
@pytest.mark.parametrize("zero_mean", [True, False])
@pytest.mark.parametrize("sdr_type", ["snr", "sisdr", "sdsdr"])
def test_neg_sdr_matches_jax(sdr_type, zero_mean, take_log, reduction):
    rng = np.random.RandomState(8)
    target = rng.randn(3, 400).astype(np.float32)
    est = (0.8 * target + 0.3 * rng.randn(3, 400) + 0.05).astype(np.float32)
    want = np.asarray(jax_neg_sdr(jnp.asarray(est), jnp.asarray(target), sdr_type, zero_mean, take_log, reduction))
    got = neg_sdr(torch.from_numpy(est), torch.from_numpy(target), sdr_type, zero_mean, take_log, reduction)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)


def test_si_snr_loss_widens_a_bf16_estimate():
    """The wav loss's SI-SNR of a bfloat16 estimate is computed in float32,
    as JAX promotes it; bad arguments raise."""
    from autovc_tpu.losses import si_snr_loss as jax_si_snr

    rng = np.random.RandomState(9)
    target = rng.randn(2, 300).astype(np.float32)
    est = torch.from_numpy(target + 0.2 * rng.randn(2, 300).astype(np.float32)).to(BF)
    got = si_snr_loss(est, torch.from_numpy(target))
    want = jax_si_snr(jnp.asarray(est.float().numpy()).astype(jnp.bfloat16), jnp.asarray(target))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    with pytest.raises(ValueError, match="sdr_type"):
        neg_sdr(est, est, "pesq")
    with pytest.raises(ValueError, match="shape"):
        neg_sdr(est, est[:, 1:])


@functools.lru_cache(maxsize=None)
def _jax_grad_fn(kind, model, train_cfg):
    """JAX's jitted loss and gradient of one model and config, compiled once
    for every batch of the same shapes."""
    cfg = _jax_cfg(kind, **dict(train_cfg))
    return jax.jit(jax.value_and_grad(
        lambda p, stats, x, emb: jax_step.loss_fn(model, cfg, p, stats, x, emb), has_aux=True))


def _jax_loss_and_grads(kind, model, variables, x, emb, **train_cfg):
    fn = _jax_grad_fn(kind, model, tuple(sorted(train_cfg.items())))
    (total, (metrics, stats)), grads = fn(variables["params"], variables["batch_stats"], jnp.asarray(x),
                                          jnp.asarray(emb))
    return float(total), {k: float(v) for k, v in metrics.items()}, generator_state_from_jax(
        {"params": grads, "batch_stats": stats})


@pytest.mark.parametrize("kind", ["stft", "wav"])
def test_loss_and_gradients_match_jax(kind):
    """``loss_fn`` and every gradient leaf against ``jax.value_and_grad`` of
    the JAX ``loss_fn`` (training form; for wav the four terms with
    lambda_sisnr 0.5 and lambda_cd 2, the second encode from the first
    pass's statistics): the loss and each term within 1e-5 relative, each
    leaf within 1e-4 of its ``grad_scale``, the updated statistics within
    1e-5. No kink lies within rounding: the port's step replayed in float64
    on the float32 step's kink sides finds every element on its side."""
    variables = _jax_init(kind)
    x, emb = _wave(10) if kind == "wav" else _stft_batch(10)
    train_cfg = dict(lambda_sisnr=0.5, lambda_cd=2.0) if kind == "wav" else {}
    total_j, metrics_j, want = _jax_loss_and_grads(kind, JAX_WAV if kind == "wav" else JAX_STFT, variables, x, emb,
                                                   **train_cfg)
    cfg = Config(model=WAV_MODEL if kind == "wav" else STFT_MODEL, train=TrainConfig(**train_cfg))
    model = _port(kind, trainable=True)
    tape = KinkTape()
    with tape.record():
        total, metrics = loss_fn(model, cfg, torch.from_numpy(x), torch.from_numpy(emb))
        total.backward()
    assert abs(float(total.detach()) - total_j) <= 1e-5 * abs(total_j)
    assert metrics.keys() == metrics_j.keys()
    for k, v in metrics_j.items():
        assert float(metrics[k]) == pytest.approx(v, rel=1e-5), k
    for name, p in model.named_parameters():
        torch.testing.assert_close(p.grad, want[name], atol=1e-4 * grad_scale(name, want), rtol=0, msg=name)
    for name, buf in model.named_buffers():
        torch.testing.assert_close(buf, want[name], atol=1e-5, rtol=0, msg=name)
    model64 = _port(kind, trainable=True).double()
    with tape.replay():
        loss_fn(model64, cfg, torch.from_numpy(x).double(), torch.from_numpy(emb).double())[0].backward()
    assert tape.flips == 0


# (e) the wav network in bfloat16 by the relative rule. Distances from JAX
# bfloat16 (Pallas, interpret mode): "outputs" the largest over the four
# eval-form outputs of their max-abs difference over their scale, "grads"
# the mean over the parameters of a training-form gradient leaf's largest
# difference over its grad_scale (JAX's gradient under jit), and each
# training-loss term's relative difference from JAX's loss_fn run op by op
# (eager). "JAX's own" is JAX float32's distance from JAX bfloat16. The
# terms are held to the eager run because the port copies flax's rounding
# points op by op; under jit XLA:CPU fuses elementwise chains and rounds
# otherwise, and the jitted bfloat16 loss lies as far from the eager one as
# from float32 (the total's readings below, "jit"). Measured on the CPU
# (B=2, L=2816; init seed, batch seed), the port in bfloat16 and, in
# brackets, JAX's own:
#   (0, 11) outputs 0 (5.9e-3), grads 0.076 (0.120); terms id 8.3e-6
#           (1.1e-5), gen 5.8e-5 (3.7e-4), cd 1.2e-3 (3.6e-3), sisnr 2.0e-3
#           (8.6e-3); the total under jit 7.0e-3 (3.3e-3)
#   (0, 14) outputs 0 (6.2e-3), grads 0.027 (0.136); terms id 7.6e-8
#           (3.0e-5), gen 1.2e-7 (5.9e-4), cd 0 (3.5e-3), sisnr 6.1e-8
#           (1.8e-3); jit 1.9e-3 (3.6e-3)
#   (0, 12) outputs 0 (6.1e-3), grads 1.82 (1.15); terms id 0 (9.8e-6), gen
#           0 (2.8e-4), cd 0 (1.3e-2), sisnr 1.8e-6 (2.7e-2); jit 7.4e-4
#           (2.6e-2)
#   (1, 12) terms id 0 (3.9e-5), gen 3.5e-7 (1.0e-3), cd 0 (3.7e-3), sisnr
#           1.2e-7 (3.2e-3); jit 4.8e-3 (1.6e-3)
# The eval-form network is bit for bit JAX bfloat16's on every batch, and
# the training form on (0, 14), (0, 12) and (1, 12) too (the terms apart by
# the order of their sums). On (0, 11) the training forward's LSTM (the
# decoder's first, 99.8% bit-equal to the Pallas kernel's: float32 sums in
# another order) flips one bfloat16 ulp that the train-mode BatchNorms
# spread, so its terms sit at up to 0.75 of JAX's own (g_loss_id). The
# gradient is held to a share of JAX's own where JAX's own is below a
# leaf's scale on average; on (0, 12) JAX's bfloat16 gradient lies 1.15 of
# its scale from its float32 one, so every engine there is rounding noise
# and none is held to another. A float32 port lands at JAX's own distance
# (shares near 1) and fails every gate.
OUTPUT_SHARE, GRAD_SHARE, TERM_SHARE = 0.5, 0.85, 0.85
WAV_TERMS = ("g_loss_id", "g_loss_gen", "g_loss_cd", "g_loss_sisnr")
BF16_BATCHES = [(0, 11), (0, 14), (0, 12)]


@functools.lru_cache(maxsize=None)
def _jax_bf16_reference(init, batch):
    variables = _jax_init("wav", init)
    x, emb = _wave(batch)
    args = (jnp.asarray(x), jnp.asarray(emb), jnp.asarray(emb))
    models = (("bf16", JAX_WAV_BF16), ("f32", JAX_WAV))
    outs = {name: [np.asarray(o).astype(np.float32) for o in m.apply(variables, *args, train=False)]
            for name, m in models}
    losses = {name: _jax_loss_and_grads("wav", m, variables, x, emb) for name, m in models}
    terms = {name: {k: float(v) for k, v in jax_step.loss_fn(m, _jax_cfg("wav"), variables["params"],
                                                               variables["batch_stats"], *args[:2])[1][0].items()}
             for name, m in models}
    return variables, x, emb, outs, losses, terms


def _wav_bf16_readings(compute_dtype, init, batch):
    """(the port's distances from JAX bfloat16, JAX float32's)."""
    variables, x, emb, outs, losses, terms = _jax_bf16_reference(init, batch)
    loss_bf, _, g_bf = losses["bf16"]
    model = _port("wav", variables, compute_dtype)
    with torch.no_grad():
        got_outs = [o.float().numpy() for o in model(*map(torch.from_numpy, (x, emb, emb)))]
    model = _port("wav", variables, compute_dtype, trainable=True)
    total, metrics = loss_fn(model, Config(model=dataclasses.replace(WAV_MODEL, compute_dtype=compute_dtype)),
                             torch.from_numpy(x), torch.from_numpy(emb))
    total.backward()
    got = {n: p.grad for n, p in model.named_parameters()}

    def readings(o, g, loss, m):
        return {"outputs": max(float(np.abs(a - b).max() / np.abs(b).max()) for a, b in zip(o, outs["bf16"])),
                "grads": float(np.mean([float((g[n] - g_bf[n]).abs().max()) / grad_scale(n, g_bf) for n in got])),
                "jit": abs(loss - loss_bf) / abs(loss_bf),
                **{k: abs(m[k] - terms["bf16"][k]) / abs(terms["bf16"][k]) for k in WAV_TERMS}}

    port = readings(got_outs, got, float(total.detach()), {k: float(v) for k, v in metrics.items()})
    own = readings(outs["f32"], losses["f32"][2], losses["f32"][0], terms["f32"])
    print(f"wav bf16 ({init}, {batch}), port in {compute_dtype}: {port}; JAX's own {own}")
    return port, own


def _wav_bf16_gates(port, own) -> dict:
    gates = {"outputs": port["outputs"] <= OUTPUT_SHARE * own["outputs"]}
    if own["grads"] < 1.0:
        gates["grads"] = port["grads"] <= GRAD_SHARE * own["grads"]
    gates.update({k: port[k] <= TERM_SHARE * own[k] for k in WAV_TERMS})
    return gates


@pytest.mark.parametrize("init, batch", BF16_BATCHES)
def test_wav_bf16_network_matches_jax_by_the_relative_rule(init, batch):
    """The bfloat16 wav generator's eval-form outputs no farther from JAX
    bfloat16's than OUTPUT_SHARE of JAX float32's distance from them, its
    training-form gradients within GRAD_SHARE of JAX's own, and each term
    of its training loss within TERM_SHARE of JAX's own (see the table
    above)."""
    port, own = _wav_bf16_readings("bfloat16", init, batch)
    gates = _wav_bf16_gates(port, own)
    assert all(gates.values()), (gates, port, own)


def test_wav_bf16_gates_refuse_a_float32_port():
    """The control: the float32 port lands at JAX float32's own distance and
    fails every gate."""
    port, own = _wav_bf16_readings("float32", *BF16_BATCHES[0])
    gates = _wav_bf16_gates(port, own)
    assert len(gates) == 2 + len(WAV_TERMS) and not any(gates.values()), (gates, port, own)


# ----------------------------------------------------------- (f) compare tools


def test_kink_tape_records_and_replays_prelu():
    """The PReLUs of the wav step are on the tape (front end, back end, the
    second front end, in call order) and a replay forces their recorded
    side: an element recorded >= 0 and replayed below takes the identity's
    value and gradient (1, no slope gradient)."""
    x, emb = _wave(12)
    tape = KinkTape()
    model = _port("wav", trainable=True)
    cfg = Config(model=WAV_MODEL)
    with tape.record():
        loss_fn(model, cfg, torch.from_numpy(x), torch.from_numpy(emb))
    assert [k for k, _ in tape.sides] == ["prelu"] + ["relu"] * 6 + ["prelu", "prelu"] + ["relu"] * 3 + ["abs"]
    layer = PReLU()
    layer.alpha.data = torch.tensor([0.25])
    tape2 = KinkTape()
    with tape2.record():
        layer(torch.tensor([1.0, -1.0, 1e-9]))
    v = torch.tensor([1.0, -1.0, -1e-9], requires_grad=True)
    with tape2.replay():
        out = layer(v)
        out.sum().backward()
    assert tape2.flips == 1
    assert v.grad.tolist() == [1.0, 0.25, 1.0] and float(layer.alpha.grad) == -1.0
    assert out.tolist() == pytest.approx([1.0, -0.25, -1e-9])


def test_grad_scale_measures_convtas_biases_by_their_own():
    """A conv bias is measured by its weight only where a BatchNorm directly
    follows the conv (the spmel modules); the ConvTasNet convolutions (a
    PReLU between, or no BatchNorm at all) by their own gradient."""
    grads = {"encoder.conv0.weight": torch.tensor([[-3.0]]), "encoder.conv0.bias": torch.tensor([1e-9]),
             "encoder.bn0.weight": torch.tensor([1.0]),
             "tas_encoder.conv_in.weight": torch.tensor([[5.0]]), "tas_encoder.conv_in.bias": torch.tensor([0.5]),
             "tas_encoder.conv0.weight": torch.tensor([[4.0]]), "tas_encoder.conv0.bias": torch.tensor([0.25]),
             "tas_encoder.prelu0.alpha": torch.tensor([0.1]), "tas_encoder.bn0.weight": torch.tensor([1.0]),
             "tas_decoder.convT0.weight": torch.tensor([[2.0]]), "tas_decoder.convT0.bias": torch.tensor([0.125]),
             "tas_decoder.convT_out.weight": torch.tensor([[2.0]]), "tas_decoder.convT_out.bias": torch.tensor([0.5])}
    got = {n: grad_scale(n, grads) for n in grads if n.endswith("bias")}
    assert got == {"encoder.conv0.bias": 3.0, "tas_encoder.conv_in.bias": 0.5, "tas_encoder.conv0.bias": 0.25,
                   "tas_decoder.convT0.bias": 0.125, "tas_decoder.convT_out.bias": 0.5}


# ------------------------------------------------------------ (g) Solver and CLI


def _write_corpus(root, kind, speakers=3, utts=2, seed=0):
    from autovc_tpu_torch.data import SpeakerEntry, save_train_manifest

    rng = np.random.RandomState(seed)
    feat_dir = root / kind
    entries = []
    for s in range(speakers):
        (feat_dir / f"p{s}").mkdir(parents=True)
        paths = []
        for u in range(utts):
            if kind == "wav":
                feat = _wave(seed * 10 + s * utts + u, b=1, n=L + int(rng.randint(0, 600)))[0][0]
            else:
                feat = rng.rand(int(rng.randint(20, 40)), 513).astype(np.float32)
            np.save(feat_dir / f"p{s}" / f"u{u}.npy", feat)
            paths.append(f"p{s}/u{u}.npy")
        emb = rng.randn(NARROW["dim_emb"]).astype(np.float32)
        entries.append(SpeakerEntry(f"p{s}", emb / np.linalg.norm(emb), paths))
    save_train_manifest(str(feat_dir / "train.pkl"), entries)
    return feat_dir


@pytest.mark.parametrize("kind", ["stft", "wav"])
def test_solver_trains_the_variant(tmp_path, kind):
    """Three Solver steps of each variant on its feature tree: finite losses
    with the variant's log keys, a checkpoint, its launches-free CPU path."""
    from autovc_tpu_torch.data import BatchIterator, UtteranceDataset
    from autovc_tpu_torch.train import Solver
    from autovc_tpu_torch.train.solver import log_keys

    feat_dir = _write_corpus(tmp_path, kind)
    cfg = Config(model=WAV_MODEL if kind == "wav" else STFT_MODEL,
                 train=TrainConfig(batch_size=2, len_crop=L if kind == "wav" else 16, num_iters=3, log_step=1,
                                   checkpoint_step=3), main_dir=str(tmp_path), run_name="r")
    it = BatchIterator(UtteranceDataset(str(feat_dir)), 2, cfg.train.len_crop, seed=0)
    solver = Solver(cfg, it, run_dir=str(tmp_path / "run"), device="cpu")
    solver.train()
    keys = ["g_loss_id", "g_loss_gen", "g_loss_cd", "g_loss_sisnr"] if kind == "wav" else [
        "g_loss_id", "g_loss_id_psnt", "g_loss_cd"]
    assert log_keys(cfg) == keys
    assert len(solver.history) == 3 and all(np.isfinite(h["g_loss"]) and set(keys) <= set(h) for h in solver.history)
    assert solver.checkpoint_steps() == [3]


def test_stft_refuses_lambda_spk_and_wav_ignores_it(tmp_path):
    """JAX asserts spmel for the auxiliary: the stft Solver raises when it is
    built, ``loss_fn`` too; the wav loss ignores the auxiliary, as JAX's."""
    from autovc_tpu_torch.train import Solver
    from autovc_tpu_torch.train.step import SpeakerAux

    cfg = Config(model=STFT_MODEL, train=TrainConfig(lambda_spk=0.5, spk_ckpt="ge2e.npz"), main_dir=str(tmp_path))
    with pytest.raises(ValueError, match="mel-domain"):
        Solver(cfg, iter(()), run_dir=str(tmp_path / "r"), device="cpu")
    x, emb = map(torch.from_numpy, _stft_batch(13))
    with pytest.raises(ValueError, match="mel-domain"):
        loss_fn(_port("stft"), cfg, x, emb, spk=SpeakerAux(model=None))
    wav_cfg = Config(model=WAV_MODEL, train=TrainConfig(lambda_spk=0.5))
    x, emb = map(torch.from_numpy, _wave(13))
    with torch.no_grad():
        a = loss_fn(_port("wav"), wav_cfg, x, emb, train=False, spk=SpeakerAux(model=None))[0]
        b = loss_fn(_port("wav"), Config(model=WAV_MODEL), x, emb, train=False)[0]
    assert torch.equal(a, b)


@pytest.mark.parametrize("kind, crop", [("wav", None), ("wav", "5000"), ("stft", None)])
def test_cli_trains_the_variant_at_published_widths(tmp_path, monkeypatch, kind, crop):
    """``cli.train --model_type stft|wav``: ``<main_dir>/<model_type>/train.pkl``,
    the published widths with --depth, --lambda_SISNR, and the crop's
    default (33536 samples for wav, 128 frames else). The Solver is a narrow
    stand-in."""
    import autovc_tpu_torch.train as train_pkg
    from autovc_tpu_torch.cli.train import main

    seen = {}

    class StandIn:
        def __init__(self, cfg, data_iter, device):
            seen.update(cfg=cfg, batch=next(iter(data_iter)))
            self.state = None

        def train(self):
            pass

    monkeypatch.setattr(train_pkg, "Solver", StandIn)
    _write_corpus(tmp_path, kind)
    main(["--main_dir", str(tmp_path), "--run_name", "c", "--device", "cpu", "--model_type", kind, "--depth", "2",
          "--lambda_SISNR", "0.3", *(["--len_crop", crop] if crop else [])])
    cfg = seen["cfg"]
    want_crop = int(crop) if crop else (33536 if kind == "wav" else 128)
    assert cfg.model == ModelConfig(model_type=kind, convtas_depth=2)
    assert (cfg.train.len_crop, cfg.train.lambda_sisnr) == (want_crop, 0.3)
    assert seen["batch"][0].shape == ((2, want_crop, 1) if kind == "wav" else (2, want_crop, 513))
