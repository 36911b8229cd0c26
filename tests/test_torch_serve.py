"""The port's serving path against the JAX package's on the CPU: the
operator ``autovc::lstm_sequence`` (``opcheck``, the same bits as the plain
version, one graph node a recurrence under ``torch.export``),
``serve.export_converter`` / ``ServingConverter`` against JAX's on the same
JAX variables (carried across by ``io.generator_state_from_jax`` /
``hifigan_state_from_jax``): the float32 converter within 1e-4 and bit for
bit against the port's live ``Converter``, one bundle at several (b, T),
the freq guard, the fused HiFi-GAN, hybrid and stft bundles, the bfloat16
bundle by the relative rule, ``weights.npz``; ``cli.serve``'s
``MicroBatcher`` and HTTP handler (ports of tests/test_serve.py), the
serving process's imports, ``cli.export_ckpt`` / ``cli.export_serving``
end to end, and ``dsp.stft.istft``'s overlap-add against its old slice
form. Narrow widths throughout (dim_neck 8, dim_emb 16, dim_pre 64,
encoder 32, decoder LSTM 64, postnet 32; HiFi-GAN 16 channels, 128 for the
hybrid, one resblock kind)."""

import io
import json
import os
import subprocess
import sys
import threading
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import autovc_tpu.models as jax_models
from autovc_tpu.config import Config as JaxConfig
from autovc_tpu.config import HiFiGANConfig as JaxHiFiGANConfig
from autovc_tpu.config import ModelConfig as JaxModelConfig
from autovc_tpu.models.autovc import Decoder, Encoder, Generator as JaxGenerator, Postnet
from autovc_tpu.serve import ServingConverter as JaxServingConverter
from autovc_tpu.serve import export_converter as jax_export_converter
from autovc_tpu_torch.cli import export_ckpt as export_ckpt_cli
from autovc_tpu_torch.cli import export_serving as export_serving_cli
from autovc_tpu_torch.cli.serve import MicroBatcher, make_handler
from autovc_tpu_torch.config import Config, HiFiGANConfig, ModelConfig
from autovc_tpu_torch.convert import ConversionSpec, Converter, bucket_length
from autovc_tpu_torch.dsp.stft import hann_window, istft
from autovc_tpu_torch.io import (conv_state_to_jax, generator_state_from_jax, generator_state_to_jax,
                                 hifigan_state_from_jax, load_artifact, save_generator_artifact, unflatten_params)
from autovc_tpu_torch.models import LSTM, Generator, build_generator
from autovc_tpu_torch.ops import lstm as lstm_ops
from autovc_tpu_torch.serve import CONVERTER_NAME, ServingConverter, export_converter
from autovc_tpu_torch.train.solver import checkpoint_file
from autovc_tpu_torch.vocoder import HiFiGANVocoder, HybridVocoder

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NARROW = dict(dim_neck=8, dim_emb=16, dim_pre=64)
WIDTHS = dict(**NARROW, enc_channels=32, dec_lstm_dim=64, postnet_channels=32)
HIFIGAN = dict(upsample_initial_channel=16, resblock_kernel_sizes=(3,), resblock_dilations=((1, 3, 5),))
# the hybrid's HiFi-GAN: 128 channels, so that the waveform whose phase the
# hybrid keeps has energy in every bin (16 channels leave bins whose phase
# is rounding noise)
HYBRID_HIFIGAN = dict(HIFIGAN, upsample_initial_channel=128)
ATOL = 1e-4  # float32 on both sides
HYBRID_ATOL = 5e-4  # tests/test_serve.py's: exported against live, through Griffin-Lim's FFTs
# bfloat16: the port's served mel no farther from JAX's bfloat16 bundle than
# this share of JAX float32's own distance from it (mean absolute); the
# float32 port, the control, lands at JAX float32's distance and fails it
BF16_SHARE = 0.5
SHAPES = [(1, 32), (3, 160), (2, 512)]
# a batched row against the same request alone (tests/test_serve.py's): the
# CPU's products take other blockings at another batch
BATCH_ATOL = 1e-6


class NarrowJaxGenerator(JaxGenerator):
    """The JAX Generator at WIDTHS (the JAX package hard-codes the
    published encoder, decoder and postnet widths), passing its dtype and
    use_pallas on."""

    def setup(self):
        self.encoder = Encoder(self.dim_neck, self.freq, channels=WIDTHS["enc_channels"], dtype=self.dtype,
                               use_pallas=self.use_pallas)
        self.decoder = Decoder(self.n_bins, self.dim_pre, lstm_dim=WIDTHS["dec_lstm_dim"], dtype=self.dtype,
                               use_pallas=self.use_pallas)
        self.postnet = Postnet(self.n_bins, channels=WIDTHS["postnet_channels"], dtype=self.dtype)


def _jax_narrow(model_cfg):
    """JAX's ``build_generator`` at WIDTHS."""
    return NarrowJaxGenerator(**NARROW, freq=model_cfg.freq, n_bins=model_cfg.n_bins,
                              dtype={"float32": None, "bfloat16": jnp.bfloat16}[model_cfg.compute_dtype],
                              use_pallas=model_cfg.use_pallas_lstm)


def _configs(model_type="spmel", compute_dtype="float32", hifigan=HIFIGAN):
    jax_cfg = JaxConfig(model=JaxModelConfig(model_type=model_type, compute_dtype=compute_dtype, **NARROW),
                        hifigan=JaxHiFiGANConfig(**hifigan))
    cfg = Config(model=ModelConfig(model_type=model_type, compute_dtype=compute_dtype, **WIDTHS),
                 hifigan=HiFiGANConfig(**hifigan))
    return jax_cfg, cfg


def _variables(model_type, seed=0):
    """A JAX variables tree (NumPy) of the narrow Generator, drawn from
    ``seed`` by the port (``io.generator_state_to_jax``: JAX's own init runs
    op by op here, about 20 s), its BatchNorm statistics moved off their
    initial values."""
    _, cfg = _configs(model_type)
    variables = generator_state_to_jax(build_generator(cfg.model, device="cpu", seed=seed).state_dict())
    rng = np.random.RandomState(seed)
    stats = jax.tree.map(lambda a: a + 0.1 * rng.rand(*a.shape).astype(np.float32), variables["batch_stats"])
    return {"params": variables["params"], "batch_stats": stats}


def _hifigan_params(seed=1, widths=HIFIGAN):
    """A JAX HiFi-GAN parameter tree (NumPy), drawn from ``seed`` by the port."""
    voc = HiFiGANVocoder(HiFiGANConfig(**widths), device="cpu", seed=seed)
    return unflatten_params(conv_state_to_jax(voc.model.state_dict()))


def _bundles(tmp, name, variables, model_type="spmel", compute_dtype="float32", hifigan=None, gl_iters=None,
             hifigan_widths=HIFIGAN):
    """(JAX's bundle, the port's bundle) of the same variables."""
    jax_cfg, cfg = _configs(model_type, compute_dtype, hifigan_widths)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_models, "build_generator", _jax_narrow)
        jax_dir = jax_export_converter(variables, jax_cfg, str(tmp / f"jax_{name}"), hifigan_params=hifigan,
                                       platforms=("cpu",), gl_iters=gl_iters)
    port_dir = export_converter(variables, cfg, str(tmp / f"port_{name}"), hifigan_params=hifigan,
                                platforms=("cpu",), gl_iters=gl_iters)
    return JaxServingConverter(jax_dir), ServingConverter(port_dir, device="cpu"), cfg


def _live(cfg, variables, hifigan=None, gl_iters=None):
    """The port's live staging: Converter (+ HiFiGANVocoder / HybridVocoder)."""
    gen = build_generator(cfg.model, device="cpu")
    gen.load_state_dict(generator_state_from_jax(variables))
    voc = None
    if hifigan is not None:
        dtype = torch.bfloat16 if cfg.model.compute_dtype == "bfloat16" else torch.float32
        voc = HiFiGANVocoder(cfg.hifigan, device="cpu", dtype=dtype)
        voc.model.load_state_dict(hifigan_state_from_jax(hifigan))
        if gl_iters is not None:
            voc = HybridVocoder(voc, cfg.audio, n_iter=gl_iters)
    return Converter(gen, cfg.model, cfg.audio), voc


def _request(rng, t, n_bins=80):
    return (rng.rand(t, n_bins).astype(np.float32), rng.rand(NARROW["dim_emb"]).astype(np.float32),
            rng.rand(NARROW["dim_emb"]).astype(np.float32))


@pytest.fixture(scope="module")
def spmel(tmp_path_factory):
    """The float32 spmel bundles with the fused HiFi-GAN, JAX's and the
    port's, and the port's live staging."""
    variables, hifigan = _variables("spmel"), _hifigan_params()
    jax_srv, srv, cfg = _bundles(tmp_path_factory.mktemp("serve"), "spmel", variables, hifigan=hifigan)
    return {"jax": jax_srv, "port": srv, "cfg": cfg, "variables": variables, "hifigan": hifigan,
            "live": _live(cfg, variables, hifigan)}


@pytest.fixture(scope="module")
def converter_only(tmp_path_factory):
    """A port bundle without a vocoder, for the server's tests."""
    _, cfg = _configs()
    out = export_converter(_variables("spmel", seed=2), cfg, str(tmp_path_factory.mktemp("serve") / "conv"),
                           platforms=("cpu",))
    return ServingConverter(out, device="cpu")


# ----------------------------------------------------------- the operator


@pytest.mark.parametrize("dtype,scan", [(torch.float32, False), (torch.bfloat16, False), (torch.bfloat16, True)])
@pytest.mark.parametrize("reverse", [False, True])
def test_lstm_operator_passes_opcheck(dtype, scan, reverse):
    g = torch.Generator().manual_seed(0)
    xproj = torch.randn(2, 7, 32, generator=g).to(dtype)
    w_hh = (0.3 * torch.randn(8, 32, generator=g)).to(dtype)
    torch.library.opcheck(torch.ops.autovc.lstm_sequence.default, (xproj, w_hh, reverse, scan))


@pytest.mark.parametrize("dtype,scan", [(torch.float32, False), (torch.bfloat16, False), (torch.bfloat16, True)])
def test_lstm_sequence_gives_the_plain_versions_bits(dtype, scan):
    """The no-grad path through the operator gives the bits of the plain
    version it ran before the operator existed."""
    g = torch.Generator().manual_seed(1)
    xproj = torch.randn(3, 11, 64, generator=g).to(dtype)
    w_hh = (0.3 * torch.randn(16, 64, generator=g)).to(dtype)
    for reverse in (False, True):
        with torch.no_grad():
            got = lstm_ops.lstm_sequence(xproj, w_hh, reverse=reverse, scan=scan)
        want = lstm_ops.lstm_sequence_ref(xproj, w_hh, reverse=reverse, scan=scan)
        assert got.dtype == want.dtype == dtype
        assert torch.equal(got, want)


def test_lstm_operator_has_cpu_and_cuda_kernels_and_no_default():
    name = "autovc::lstm_sequence"
    has = torch._C._dispatch_has_kernel_for_dispatch_key
    assert has(name, "CPU") and has(name, "CUDA")
    assert not has(name, "CompositeExplicitAutograd") and not has(name, "CompositeImplicitAutograd")


def test_lstm_exports_as_one_node_a_recurrence():
    """A one-layer LSTM under torch.export: one operator node a direction,
    and the program gives the eager bits."""
    lstm = LSTM(24, 8, num_layers=1, bidirectional=True)
    lstm.reset_parameters(torch.Generator().manual_seed(2))
    x = torch.randn(2, 5, 24, generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        program = torch.export.export(lstm, (x,), dynamic_shapes=({0: torch.export.Dim("b"),
                                                                   1: torch.export.Dim("t")},))
        nodes = [n for n in program.graph.nodes if n.target == torch.ops.autovc.lstm_sequence.default]
        assert [n.args[2] for n in nodes] == [False, True]  # reverse: the forward direction, then the backward
        y = torch.randn(3, 9, 24)
        assert torch.equal(program.module()(y), lstm(y))


# ------------------------------------------------------- the float32 bundle


@pytest.mark.parametrize("b,t", SHAPES)
def test_converter_matches_jax_and_the_live_converter(spmel, b, t):
    """One program at every (b, T): within 1e-4 of JAX's served output, and
    bit for bit against the port's live Converter."""
    rng = np.random.RandomState(t)
    x = rng.rand(b, t, 80).astype(np.float32)
    eo, et = rng.rand(b, NARROW["dim_emb"]).astype(np.float32), rng.rand(b, NARROW["dim_emb"]).astype(np.float32)
    got = spmel["port"](x, eo, et)
    assert got.shape == (b, t, 80) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(spmel["jax"](x, eo, et)), rtol=0, atol=ATOL)
    converter, _ = spmel["live"]
    assert torch.equal(got, converter._forward(x, eo, et))


def test_non_multiple_of_freq_rejected(spmel):
    with pytest.raises(ValueError, match="multiple of freq 32"):
        spmel["port"](np.zeros((1, 100, 80), np.float32), np.zeros((1, 16), np.float32),
                      np.zeros((1, 16), np.float32))


def test_converter_program_holds_seven_lstm_nodes(spmel, tmp_path):
    program = torch.export.load(os.path.join(spmel["port"].bundle_dir, CONVERTER_NAME.format(platform="cpu")))
    assert sum(n.target == torch.ops.autovc.lstm_sequence.default for n in program.graph.nodes) == 7


def test_fused_hifigan_bundle_matches_jax_and_live_staging(spmel):
    """T=100, not a freq multiple: the converter's pad is stripped before
    the vocoder program, as Converter.convert + HiFiGANVocoder.generate do."""
    feats, eo, et = _request(np.random.RandomState(3), 100)
    wav = spmel["port"].convert(feats, eo, et)
    assert wav.shape == (100 * 256,)
    np.testing.assert_allclose(wav, spmel["jax"].convert(feats, eo, et), rtol=0, atol=ATOL)
    converter, voc = spmel["live"]
    mel = converter.convert(ConversionSpec(0, "u", eo, feats, "t", et))
    np.testing.assert_array_equal(wav, voc.generate(mel).numpy())


def test_weights_npz_holds_jaxs_arrays(spmel):
    port = np.load(os.path.join(spmel["port"].bundle_dir, "weights.npz"))
    jax_bundle = np.load(os.path.join(os.path.dirname(spmel["port"].bundle_dir), "jax_spmel", "weights.npz"))
    assert sorted(port.files) == sorted(jax_bundle.files)
    assert any(k.startswith("hifigan/") for k in port.files) and any(k.startswith("batch_stats/") for k in port.files)
    for k in port.files:
        np.testing.assert_array_equal(port[k], jax_bundle[k])


def test_manifest_keeps_jaxs_keys(spmel):
    port, jax_manifest = spmel["port"].manifest, spmel["jax"].manifest
    assert set(jax_manifest) - {"call"} <= set(port)
    for k in ("model_type", "compute_dtype", "n_bins", "freq", "dim_emb", "with_vocoder", "vocoder_mode",
              "gl_iters", "hop_size"):
        assert port[k] == jax_manifest[k], k
    assert port["format"] == "autovc_tpu_torch.serve/1" and port["platforms"] == ["cpu"]
    assert port["torch_version"] == torch.__version__


def test_missing_platform_program_raises(spmel, tmp_path):
    """A bundle without the asked device's program raises: no fallback."""
    bundle = tmp_path / "cuda_only"
    bundle.mkdir()
    manifest = dict(spmel["port"].manifest, platforms=["cuda"])
    (bundle / "manifest.json").write_text(json.dumps(manifest))
    with pytest.raises(ValueError, match="not cpu"):
        ServingConverter(str(bundle), device="cpu")


# ------------------------------------------------ hybrid, stft, bfloat16


def test_hybrid_bundle_matches_jax_and_live_hybrid(tmp_path):
    """The hybrid bundle (gl_iters=2): its conversion bit for bit against
    the port's live Converter + HybridVocoder, and its vocoder program
    within 5e-4 of JAX's on a mel where it is conditioned. The hybrid keeps
    the neural waveform's phase, which is rounding noise in bins where that
    waveform has no energy, so its output moves with the last bits of its
    input (on this random Generator's flat output, by tenths of its peak).
    On mels over [0, 0.8] (test_torch_vocoder_train's range) JAX's distance
    and the port's own move under a 1e-6 shift of the mel are of one order
    (``-s`` prints both for four mels; one of the four lies 5.4e-4 from
    JAX); the gate holds the first, and checks its conditioning."""
    variables, hifigan = _variables("spmel", seed=4), _hifigan_params(seed=5, widths=HYBRID_HIFIGAN)
    jax_srv, srv, cfg = _bundles(tmp_path, "hybrid", variables, hifigan=hifigan, gl_iters=2,
                                 hifigan_widths=HYBRID_HIFIGAN)
    assert srv.manifest["vocoder_mode"] == "hybrid" and srv.manifest["gl_iters"] == 2
    feats, eo, et = _request(np.random.RandomState(5), 96)
    wav = srv.convert(feats, eo, et)
    assert wav.shape == (96 * 256,)
    converter, voc = _live(cfg, variables, hifigan, gl_iters=2)
    mel = converter.convert(ConversionSpec(0, "u", eo, feats, "t", et))
    np.testing.assert_array_equal(wav, voc.generate(mel).numpy())

    readings = []
    for seed in range(4):
        mel = (0.8 * np.random.RandomState(seed).rand(1, 96, 80)).astype(np.float32)
        got = srv.vocode(mel).numpy()
        readings.append((np.abs(got - np.asarray(jax_srv.vocode(mel))).max(),
                         np.abs(srv.vocode(mel + np.float32(1e-6)).numpy() - got).max(), np.abs(got).max()))
    print("hybrid vocoder program, mels over [0, 0.8]: (from JAX, moved by a 1e-6 shift, peak)",
          [tuple(f"{v:.3g}" for v in r) for r in readings])
    apart, shifted, _ = readings[0]
    assert apart <= HYBRID_ATOL and shifted < HYBRID_ATOL / 2
    with pytest.raises(ValueError, match="at least 4 frames"):
        srv.vocode(np.zeros((1, 3, 80), np.float32))


def test_stft_bundle_matches_jax(tmp_path):
    """513-bin features; the mel projection is baked into the vocoder
    program."""
    variables, hifigan = _variables("stft", seed=6), _hifigan_params(seed=7)
    jax_srv, srv, cfg = _bundles(tmp_path, "stft", variables, model_type="stft", hifigan=hifigan)
    feats, eo, et = _request(np.random.RandomState(7), 70, n_bins=513)
    wav = srv.convert(feats, eo, et)
    assert wav.shape == (70 * 256,)
    np.testing.assert_allclose(wav, jax_srv.convert(feats, eo, et), rtol=0, atol=ATOL)
    x = np.random.RandomState(8).rand(2, 64, 513).astype(np.float32)
    e = np.random.RandomState(9).rand(2, NARROW["dim_emb"]).astype(np.float32)
    np.testing.assert_allclose(srv(x, e, e[::-1]).numpy(), np.asarray(jax_srv(x, e, e[::-1])), rtol=0, atol=ATOL)


def test_bf16_bundle_bit_for_bit_live_and_near_jaxs(spmel, tmp_path):
    """The bfloat16 bundle (the Generator's LSTMs in the scan rounding, the
    default): bit for bit against the port's live bfloat16 Converter, and
    near JAX's bfloat16 bundle by the relative rule: within BF16_SHARE of
    JAX float32's own distance from it, which the float32 port fails."""
    variables, hifigan = spmel["variables"], spmel["hifigan"]
    jax_srv, srv, cfg = _bundles(tmp_path, "bf16", variables, compute_dtype="bfloat16", hifigan=hifigan)
    assert srv.manifest["compute_dtype"] == "bfloat16" and not srv.manifest["use_pallas_lstm"]
    rng = np.random.RandomState(10)
    x = rng.rand(2, 128, 80).astype(np.float32)
    eo, et = rng.rand(2, NARROW["dim_emb"]).astype(np.float32), rng.rand(2, NARROW["dim_emb"]).astype(np.float32)
    got = srv(x, eo, et)
    assert got.dtype == torch.float32
    converter, voc = _live(cfg, variables, hifigan)
    assert torch.equal(got, converter._forward(x, eo, et))
    feats, e1, e2 = _request(rng, 100)
    mel = converter.convert(ConversionSpec(0, "u", e1, feats, "t", e2))
    np.testing.assert_array_equal(srv.convert(feats, e1, e2), voc.generate(mel).numpy())

    jax_bf16 = np.asarray(jax_srv(x, eo, et))
    own = np.abs(np.asarray(spmel["jax"](x, eo, et)) - jax_bf16).mean()
    port = np.abs(got.numpy() - jax_bf16).mean()
    control = np.abs(spmel["port"](x, eo, et).numpy() - jax_bf16).mean()
    print(f"mean distance from JAX's bf16 bundle: JAX f32 {own:.4g}, port bf16 {port:.4g}, port f32 {control:.4g}")
    assert port <= BF16_SHARE * own < control


# ---------------------------------------------------------------- cli.serve


def test_microbatcher_matches_solo_bucketed_calls(converter_only):
    """A batched row equals the same request run solo at the same bucket
    padding, for mixed lengths landing in different buckets."""
    srv = converter_only
    batcher = MicroBatcher(srv, window_s=1.0, max_batch=8, bucket=128)
    try:
        rng = np.random.RandomState(7)
        reqs = [_request(rng, t) for t in (100, 128, 97, 300)]
        results = [None] * len(reqs)
        threads = [threading.Thread(target=lambda i=i, r=r: results.__setitem__(i, batcher.convert(*r)))
                   for i, r in enumerate(reqs)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
        assert not any(th.is_alive() for th in threads)
        assert max(batcher.batch_sizes) >= 2
        for (feats, eo, et), got in zip(reqs, results):
            tb = bucket_length(feats.shape[0], srv.manifest["freq"], 128)
            x = np.pad(feats, ((0, tb - feats.shape[0]), (0, 0)))
            want = srv(x[None], eo[None], et[None])[0, : feats.shape[0]].numpy()
            assert got.shape == feats.shape
            np.testing.assert_allclose(got, want, rtol=0, atol=BATCH_ATOL)
    finally:
        batcher.close()


def test_microbatcher_error_isolated_to_group(converter_only):
    """A failing group fails its requests with the error; the dispatcher
    keeps serving later requests."""
    batcher = MicroBatcher(converter_only, window_s=0.0, max_batch=4, bucket=128)
    try:
        bad = np.zeros((64, 80), np.float32)
        with pytest.raises(Exception):
            batcher.convert(bad, np.zeros((2, 16), np.float32), np.zeros((16,), np.float32))
        ok = batcher.convert(bad, np.zeros((16,), np.float32), np.zeros((16,), np.float32))
        assert ok.shape == (64, 80)
    finally:
        batcher.close()


def test_microbatcher_refuses_a_bucket_off_freq(converter_only):
    with pytest.raises(ValueError, match="multiple of the bundle's freq"):
        MicroBatcher(converter_only, bucket=100)


def _serve(srv, batcher=None):
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(srv, threading.Lock(), batcher))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    return httpd, thread, f"http://127.0.0.1:{httpd.server_address[1]}"


def _post(url, feats, eo, et):
    buf = io.BytesIO()
    np.savez(buf, features=feats, emb_org=eo, emb_trg=et)
    return np.load(io.BytesIO(urllib.request.urlopen(url + "/convert", data=buf.getvalue(), timeout=120).read()))


def test_http_server_batched_roundtrip(converter_only):
    """Concurrent HTTP /convert requests through a MicroBatcher come back
    equal to the batcher's own answer for each."""
    srv = converter_only
    batcher = MicroBatcher(srv, window_s=0.1, max_batch=8, bucket=128)
    httpd, thread, url = _serve(srv, batcher)
    try:
        rng = np.random.RandomState(11)
        reqs = [_request(rng, t) for t in (90, 90, 200)]
        outs = [None] * len(reqs)
        threads = [threading.Thread(target=lambda i=i: outs.__setitem__(i, _post(url, *reqs[i])))
                   for i in range(len(reqs))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
        assert not any(th.is_alive() for th in threads)
        for (feats, eo, et), got in zip(reqs, outs):
            assert got.shape == feats.shape
            np.testing.assert_allclose(got, batcher.convert(feats, eo, et), rtol=0, atol=BATCH_ATOL)
        stats = json.loads(urllib.request.urlopen(url + "/stats").read())
        assert stats["batching"] and stats["requests"] == 6 and stats["program_calls"] >= 2
    finally:
        httpd.shutdown()
        httpd.server_close()
        batcher.close()
        thread.join(timeout=30)


def test_http_server_roundtrip(converter_only):
    """Solo: npz request -> npy converted features equal to
    ServingConverter.convert; a malformed request -> 400, the server stays up."""
    srv = converter_only
    httpd, thread, url = _serve(srv)
    try:
        assert urllib.request.urlopen(url + "/healthz").read() == b"ok"
        manifest = json.loads(urllib.request.urlopen(url + "/manifest").read())
        assert manifest["n_bins"] == 80 and manifest["with_vocoder"] is False
        feats, eo, et = _request(np.random.RandomState(12), 150)
        np.testing.assert_array_equal(_post(url, feats, eo, et), srv.convert(feats, eo, et))
        for bad in ({"features": np.zeros((4, 3), np.float32), "emb_org": eo, "emb_trg": et},
                    {"features": feats, "emb_org": np.zeros(5, np.float32), "emb_trg": et}):
            buf = io.BytesIO()
            np.savez(buf, **bad)
            with pytest.raises(urllib.error.HTTPError) as err:
                urllib.request.urlopen(url + "/convert", data=buf.getvalue())
            assert err.value.code == 400 and b"must be" in err.value.read()
        assert urllib.request.urlopen(url + "/healthz").read() == b"ok"
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)


def test_serving_process_imports_no_model_code(converter_only):
    """A process that loads a bundle and converts imports neither the port's
    model code nor JAX."""
    code = (
        "import sys, numpy as np\n"
        "from autovc_tpu_torch.serve import ServingConverter\n"
        f"srv = ServingConverter({converter_only.bundle_dir!r}, device='cpu')\n"
        "out = srv.convert(np.zeros((40, 80), np.float32), np.zeros(16, np.float32), np.zeros(16, np.float32))\n"
        "assert out.shape == (40, 80), out.shape\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'autovc_tpu')\n"
        "       or m.startswith(('autovc_tpu_torch.models', 'autovc_tpu_torch.vocoder'))]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO, PYTHONDONTWRITEBYTECODE="1")
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]


# --------------------------------------------------------------- the CLIs


def _run_dir(root, seed=3):
    """A port Solver run directory at WIDTHS: checkpoints/step_*.pt holding
    params, batch_stats and ema_params under the state-dict names."""
    gen = build_generator(ModelConfig(**WIDTHS), device="cpu", seed=seed)
    ema = build_generator(ModelConfig(**WIDTHS), device="cpu", seed=seed + 1)
    ckpt_dir = os.path.join(root, "run", "checkpoints")
    os.makedirs(ckpt_dir)
    torch.save({"params": dict(gen.named_parameters()), "batch_stats": dict(gen.named_buffers()),
                "ema_params": dict(ema.named_parameters()), "opt_state": {}, "step": 7},
               checkpoint_file(ckpt_dir, 7))
    return os.path.join(root, "run"), gen, ema


@pytest.mark.parametrize("use_ema", [False, True])
def test_export_ckpt_writes_the_artifact(tmp_path, use_ema):
    run_dir, gen, ema = _run_dir(str(tmp_path))
    out = str(tmp_path / "gen.npz")
    export_ckpt_cli.main(["--run_dir", run_dir, "--out", out] + (["--use_ema"] if use_ema else []))
    tree, step = load_artifact(out)
    assert step == 7
    state = generator_state_from_jax(tree)
    want = {**dict((ema if use_ema else gen).named_parameters()), **dict(gen.named_buffers())}
    assert sorted(state) == sorted(want)
    for k, v in state.items():
        assert torch.equal(v, want[k].detach()), k


@pytest.mark.parametrize("dtype", ["float16", "bfloat16"])
def test_export_ckpt_quantizes_as_jax(tmp_path, dtype):
    """float16 storage, or bfloat16 values rounded as jnp rounds them; the
    BatchNorm statistics stay float32."""
    run_dir, gen, _ = _run_dir(str(tmp_path))
    out = str(tmp_path / "q.npz")
    export_ckpt_cli.main(["--run_dir", run_dir, "--out", out, "--dtype", dtype])
    full = str(tmp_path / "f.npz")
    export_ckpt_cli.main(["--run_dir", run_dir, "--out", full])
    q, f = np.load(out), np.load(full)
    for k in f.files:
        if k.startswith("params/"):
            want = np.asarray(jnp.asarray(f[k], getattr(jnp, dtype))).astype(np.float32)
            assert q[k].dtype == (np.float16 if dtype == "float16" else np.float32)
            np.testing.assert_array_equal(q[k].astype(np.float32), want)
        elif k.startswith("batch_stats/"):
            assert q[k].dtype == np.float32
            np.testing.assert_array_equal(q[k], f[k])


@pytest.fixture
def narrow_export_serving(monkeypatch):
    """cli.export_serving building WIDTHS and the narrow HiFi-GAN."""
    monkeypatch.setattr(export_serving_cli, "ModelConfig", lambda **kw: ModelConfig(**WIDTHS, **kw))
    monkeypatch.setattr(export_serving_cli, "HiFiGANConfig", lambda: HiFiGANConfig(**HIFIGAN))


def test_export_ckpt_then_export_serving_end_to_end(tmp_path, narrow_export_serving):
    """run dir -> cli.export_ckpt -> cli.export_serving --platforms cpu ->
    ServingConverter: the live Converter + HiFiGANVocoder on the run's
    weights, bit for bit."""
    run_dir, gen, _ = _run_dir(str(tmp_path))
    art = str(tmp_path / "gen.npz")
    export_ckpt_cli.main(["--run_dir", run_dir, "--out", art])
    voc = HiFiGANVocoder(HiFiGANConfig(**HIFIGAN), device="cpu", seed=3)
    voc_art = str(tmp_path / "hifigan.npz")
    np.savez(voc_art, **conv_state_to_jax(voc.model.state_dict()))
    out = export_serving_cli.main(["--artifact", art, "--out", str(tmp_path / "bundle"), "--hifigan", voc_art,
                                   "--platforms", "cpu"])
    srv = ServingConverter(out, device="cpu")
    assert srv.manifest["platforms"] == ["cpu"] and srv.manifest["vocoder_mode"] == "hifigan"
    feats, eo, et = _request(np.random.RandomState(13), 70)
    mel = Converter(gen, ModelConfig(**WIDTHS)).convert(ConversionSpec(0, "u", eo, feats, "t", et))
    np.testing.assert_array_equal(srv.convert(feats, eo, et), voc.generate(mel).numpy())


def test_export_serving_refuses_cuda_without_a_card_and_torch_checkpoints(tmp_path, narrow_export_serving):
    art = str(tmp_path / "gen.npz")
    save_generator_artifact(build_generator(ModelConfig(**WIDTHS), device="cpu").state_dict(), 1, art)
    out = tmp_path / "bundle"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            export_serving_cli.main(["--artifact", art, "--out", str(out)])  # --platforms cuda, the default
        assert not out.exists()
    with pytest.raises(ValueError, match="torch HiFi-GAN checkpoints"):
        export_serving_cli.main(["--artifact", art, "--out", str(out), "--hifigan", str(tmp_path / "g.pt"),
                                 "--platforms", "cpu"])


def _istft_slices(spec, n_fft=1024, hop=256, length=None):
    """``dsp.stft.istft`` as it summed its phase streams before the hybrid
    program: each stream added into a slice of one buffer, the window sum
    over the real frames a stream."""
    frames = torch.fft.irfft(spec, n=n_fft, dim=-1)
    window = torch.as_tensor(hann_window(n_fft, dtype=np.float64)).to(frames.dtype)
    frames = frames * window
    t = spec.shape[-2]
    out_len = n_fft + (t - 1) * hop
    batch_shape = frames.shape[:-2]
    k = n_fft // hop
    pad_t = (-t) % k
    frames_p = torch.cat([frames, frames.new_zeros(*batch_shape, pad_t, n_fft)], dim=-2)
    size = out_len + pad_t * hop + n_fft
    total = frames.new_zeros(*batch_shape, size)
    wsum = torch.zeros(size, dtype=torch.float32)
    w2 = window.float() ** 2
    for phase in range(k):
        sub = frames_p[..., phase::k, :]
        start = phase * hop
        total[..., start : start + sub.shape[-2] * n_fft] += sub.reshape(*batch_shape, -1)
        n_real = (t - phase + k - 1) // k if phase < t else 0
        if n_real:
            wsum[start : start + n_real * n_fft] += w2.repeat(n_real)
    y = total[..., :out_len] / torch.clamp(wsum[:out_len], min=1e-10)
    pad = n_fft // 2
    if length is None:
        return y[..., pad : out_len - pad]
    extra = pad + length - out_len
    if extra > 0:
        y = torch.cat([y, y.new_zeros(*y.shape[:-1], extra)], dim=-1)
    return y[..., pad : pad + length]


@pytest.mark.parametrize("batch", [(), (2,), (2, 3)])
def test_istft_overlap_add_gives_the_slice_forms_bits(batch):
    """The overlap-add the hybrid program exports (shifted chunks selected by
    phase) sums what the slice form summed in the same order: the same bits,
    at 11 frame counts (each residue mod 4, fewer frames than a stream) and
    three output lengths."""
    g = torch.Generator().manual_seed(len(batch))
    for t in range(1, 12):
        spec = torch.complex(torch.randn(*batch, t, 513, generator=g), torch.randn(*batch, t, 513, generator=g))
        for length in (None, t * 256, t * 256 + 700):
            want = _istft_slices(spec, length=length)
            got = istft(spec, length=length)
            assert got.shape == want.shape
            assert torch.equal(got, want), (t, length)


def test_generator_decode_refuses_a_length_off_its_blocks():
    gen = Generator(**WIDTHS, scan=False)
    with pytest.raises(ValueError, match="blocks of freq"):
        gen.decode(torch.zeros(1, 2, 16), torch.zeros(1, 16), 48)
