"""The leftover modules of the port on the CPU against the JAX package's: the
torch-checkpoint importers (``interop``) on seeded state dicts with the
reference's key names, the port's modules on the imported weights,
``from_checkpoint`` of a torch checkpoint in both vocoders,
``cli.make_metadata --dvector_ckpt`` on the reference's torch d-vector,
``cli.import_torch`` -> ``cli.convert``, and ``cli.visualize``."""

import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from autovc_tpu import interop as jax_interop
from autovc_tpu.config import HiFiGANConfig as JaxHiFiGANConfig
from autovc_tpu.config import WaveNetConfig as JaxWaveNetConfig
from autovc_tpu.models.dvector import DVector as JaxDVector
from autovc_tpu.vocoder import wavenet as jax_wavenet
from autovc_tpu.vocoder.hifigan import HiFiGANVocoder as JaxHiFiGANVocoder
from autovc_tpu_torch import interop
from autovc_tpu_torch.config import HiFiGANConfig, WaveNetConfig
from autovc_tpu_torch.io import flatten_params, generator_state_from_jax, wavenet_state_from_jax
from autovc_tpu_torch.models import build_dvector, build_generator
from autovc_tpu_torch.vocoder.hifigan import HiFiGANVocoder
from autovc_tpu_torch.vocoder.wavenet import WaveNet, WaveNetVocoder

from test_torch_convert_cli import NARROW, jax_narrow, narrow_config

torch.set_num_threads(1)

FWD_TOL = 1e-4  # a module on imported weights against JAX's on its import
WN_KW = dict(out_channels=12, layers=6, stacks=2, residual_channels=16, gate_channels=16, skip_channels=8,
             cin_channels=80, upsample_scales=(4, 4, 4, 4))
HIFI_KW = dict(upsample_initial_channel=32)


# ------------------------------------------- reference-named state dicts


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32, order="C"))


def _weight_norm(sd: dict, prefix: str, w: np.ndarray, style: str) -> None:
    """``w`` under ``prefix`` as the reference stores it: plain, legacy
    weight_norm (g, v) or torch parametrizations (original0, original1)."""
    if style == "plain":
        sd[f"{prefix}.weight"] = _t(w)
        return
    v = w * 1.7  # any scaling of v: g carries the norm
    g = np.sqrt((w**2).sum(axis=tuple(range(1, w.ndim)), keepdims=True))
    names = ("weight_g", "weight_v") if style == "legacy" else ("parametrizations.weight.original0",
                                                                "parametrizations.weight.original1")
    sd[f"{prefix}.{names[0]}"], sd[f"{prefix}.{names[1]}"] = _t(g), _t(v)


def _lstm(sd, prefix, tree, layers, bidirectional, rng):
    for layer in range(layers):
        for suf, d in [("", "fwd"), ("_reverse", "bwd")][: 2 if bidirectional else 1]:
            b = np.asarray(tree[f"b_l{layer}_{d}"])
            split = rng.randn(*b.shape).astype(np.float32)
            sd[f"{prefix}.weight_ih_l{layer}{suf}"] = _t(np.asarray(tree[f"w_ih_l{layer}_{d}"]).T)
            sd[f"{prefix}.weight_hh_l{layer}{suf}"] = _t(np.asarray(tree[f"w_hh_l{layer}_{d}"]).T)
            sd[f"{prefix}.bias_ih_l{layer}{suf}"], sd[f"{prefix}.bias_hh_l{layer}{suf}"] = _t(split), _t(b - split)


def _conv_bn(sd, prefix, params, i, rng):
    """A conv of the JAX tree and a BatchNorm of its width drawn from ``rng``."""
    conv = params[f"conv{i}"]["Conv_0"]
    sd[f"{prefix}.0.conv.weight"] = _t(np.asarray(conv["kernel"]).transpose(2, 1, 0))
    sd[f"{prefix}.0.conv.bias"] = _t(conv["bias"])
    c = np.asarray(params[f"bn{i}"]["BatchNorm_0"]["scale"]).shape[0]
    sd[f"{prefix}.1.weight"] = _t(1.0 + 0.1 * rng.randn(c))
    sd[f"{prefix}.1.bias"] = _t(0.1 * rng.randn(c))
    sd[f"{prefix}.1.running_mean"] = _t(0.1 * rng.randn(c))
    sd[f"{prefix}.1.running_var"] = _t(0.5 + rng.rand(c))


def _reference_generator(params, seed=0, prefix="") -> dict:
    """A state dict with model_vc_mel.py's names (and BatchNorm statistics
    drawn from ``seed``) of a JAX Generator tree's shapes and weights."""
    rng = np.random.RandomState(seed)
    sd: dict = {}
    for part, n in (("encoder", 3), ("decoder", 3), ("postnet", 5)):
        for i in range(n):
            _conv_bn(sd, f"{part}.convolutions.{i}", params[part], i, rng)
    _lstm(sd, "encoder.lstm", params["encoder"]["blstm"], 2, True, rng)
    _lstm(sd, "decoder.lstm1", params["decoder"]["lstm1"], 1, False, rng)
    _lstm(sd, "decoder.lstm2", params["decoder"]["lstm2"], 2, False, rng)
    proj = params["decoder"]["proj"]["Dense_0"]
    sd["decoder.linear_projection.linear_layer.weight"] = _t(np.asarray(proj["kernel"]).T)
    sd["decoder.linear_projection.linear_layer.bias"] = _t(proj["bias"])
    return {prefix + k: v for k, v in sd.items()}


def _reference_wav(params, seed=0) -> dict:
    """model_vc_wav.py's names: the core's, the ConvTasNet front end
    (tasEncoder.conv1x1, convD.{i}.{0 conv, 1 PReLU, 2 BatchNorm}) and back
    end (tasDecoder.convTD.{i}, convT1x1)."""
    rng = np.random.RandomState(seed)
    sd: dict = {}
    for part in ("encoder", "decoder"):
        for i in range(3):
            _conv_bn(sd, f"{part}.convolutions.{i}", params[part], i, rng)
    _lstm(sd, "encoder.lstm", params["encoder"]["blstm"], 2, True, rng)
    _lstm(sd, "decoder.lstm1", params["decoder"]["lstm1"], 1, False, rng)
    _lstm(sd, "decoder.lstm2", params["decoder"]["lstm2"], 2, False, rng)
    proj = params["decoder"]["proj"]["Dense_0"]
    sd["decoder.linear_projection.linear_layer.weight"] = _t(np.asarray(proj["kernel"]).T)
    sd["decoder.linear_projection.linear_layer.bias"] = _t(proj["bias"])
    te, td = params["tas_encoder"], params["tas_decoder"]
    for name, leaf in (("tasEncoder.conv1x1", te["conv_in"]), ("tasDecoder.convT1x1", td["convT_out"])):
        sd[f"{name}.weight"], sd[f"{name}.bias"] = _t(np.asarray(leaf["kernel"]).transpose(2, 1, 0)), _t(leaf["bias"])
    depth = sum(k.startswith("prelu") for k in te)
    for i in range(depth):
        for ref, ours, conv in (("tasEncoder.convD", te, f"conv{i}"), ("tasDecoder.convTD", td, f"convT{i}")):
            sd[f"{ref}.{i}.0.weight"] = _t(np.asarray(ours[conv]["kernel"]).transpose(2, 1, 0))
            sd[f"{ref}.{i}.0.bias"] = _t(ours[conv]["bias"])
            sd[f"{ref}.{i}.1.weight"] = _t(0.1 + 0.3 * rng.rand(1))
            c = np.asarray(ours[f"bn{i}"]["BatchNorm_0"]["scale"]).shape[0]
            sd[f"{ref}.{i}.2.weight"], sd[f"{ref}.{i}.2.bias"] = _t(1 + 0.1 * rng.randn(c)), _t(0.1 * rng.randn(c))
            sd[f"{ref}.{i}.2.running_mean"] = _t(0.1 * rng.randn(c))
            sd[f"{ref}.{i}.2.running_var"] = _t(0.5 + rng.rand(c))
    return sd


def _reference_dvector(dim_cell=32, dim_emb=16, seed=0) -> dict:
    """model_bl.py's D_VECTOR as the 3000000-BL.ckpt stores it ('module.'
    prefix of DataParallel): a 3-layer LSTM and the embedding."""
    rng = np.random.RandomState(seed)
    sd = {}
    for layer in range(3):
        cin = 80 if layer == 0 else dim_cell
        for name, shape in (("weight_ih", (4 * dim_cell, cin)), ("weight_hh", (4 * dim_cell, dim_cell)),
                            ("bias_ih", (4 * dim_cell,)), ("bias_hh", (4 * dim_cell,))):
            sd[f"module.lstm.{name}_l{layer}"] = _t(rng.randn(*shape) / np.sqrt(dim_cell))
    sd["module.embedding.weight"] = _t(rng.randn(dim_emb, dim_cell) / np.sqrt(dim_cell))
    sd["module.embedding.bias"] = _t(0.1 * rng.randn(dim_emb))
    return sd


def _reference_hifigan(cfg, seed=0) -> dict:
    """The public HiFi-GAN generator's names (conv_pre, ups.{i},
    resblocks.{k}.convs{1,2}.{d}, conv_post) with weight norm, the
    'generator.' prefix of a training checkpoint, and the three weight-norm
    formats."""
    rng = np.random.RandomState(seed)
    sd: dict = {}
    styles = iter(["legacy", "parametrizations", "plain"] * 100)

    def conv(prefix, shape):
        _weight_norm(sd, f"generator.{prefix}", (rng.randn(*shape) / np.sqrt(np.prod(shape[1:]))).astype(np.float32),
                     next(styles))
        sd[f"generator.{prefix}.bias"] = _t(0.05 * rng.randn(shape[0] if not prefix.startswith("ups") else shape[1]))

    c = cfg.upsample_initial_channel
    conv("conv_pre", (c, 80, 7))
    n_res = len(cfg.resblock_kernel_sizes)
    for i, (u, k) in enumerate(zip(cfg.upsample_rates, cfg.upsample_kernel_sizes)):
        conv(f"ups.{i}", (c, c // 2, k))  # ConvTranspose1d: (in, out, k)
        c //= 2
        for j, (ks, dil) in enumerate(zip(cfg.resblock_kernel_sizes, cfg.resblock_dilations)):
            for s in ("convs1", "convs2"):
                for d in range(len(dil)):
                    conv(f"resblocks.{i * n_res + j}.{s}.{d}", (c, c, ks))
    conv("conv_post", (1, c, 7))
    return sd


def _reference_wavenet(cfg, seed=0) -> dict:
    """r9y9 wavenet_vocoder's names, weight-normalised in the legacy format,
    some convolutions plain; upsample convs at the Sequential's even
    indices."""
    rng = np.random.RandomState(seed)
    sd: dict = {}
    r, g, s, c = cfg.residual_channels, cfg.gate_channels, cfg.skip_channels, cfg.cin_channels

    def conv(prefix, shape, style="legacy", bias=True):
        _weight_norm(sd, prefix, (rng.randn(*shape) / np.sqrt(np.prod(shape[1:]))).astype(np.float32), style)
        if bias:
            sd[f"{prefix}.bias"] = _t(0.05 * rng.randn(shape[0]))

    conv("first_conv", (r, 1, 1), "plain")
    for i in range(cfg.layers):
        p = f"conv_layers.{i}"
        conv(f"{p}.conv", (g, r, cfg.kernel_size))
        conv(f"{p}.conv1x1c", (g, c, 1), bias=False)
        conv(f"{p}.conv1x1_out", (r, g // 2, 1))
        conv(f"{p}.conv1x1_skip", (s, g // 2, 1), "parametrizations")
    conv("last_conv_layers.1", (s, s, 1))
    conv("last_conv_layers.3", (cfg.out_channels, s, 1), "plain")
    for j, scale in enumerate(cfg.upsample_scales):
        conv(f"upsample_conv.{2 * j}", (1, 1, cfg.freq_axis_kernel_size, 2 * scale), "plain", bias=False)
    return sd


def _same_tree(got, want) -> None:
    got, want = flatten_params(got), flatten_params(want)
    assert got.keys() == want.keys() and len(got) > 0
    for k, v in want.items():
        assert got[k].dtype == np.float32 and np.array_equal(got[k], np.asarray(v)), k


# --------------------------------------------------------- the importers


@pytest.fixture(scope="module")
def narrow_jax_generator():
    model = jax_narrow(narrow_config())
    rng = np.random.RandomState(0)
    x = rng.rand(2, 64, 80).astype(np.float32)
    c = rng.randn(2, NARROW["dim_emb"]).astype(np.float32)
    variables = model.init(jax.random.PRNGKey(1), jnp.asarray(x), jnp.asarray(c), jnp.asarray(c), train=False)
    return model, jax.tree_util.tree_map(np.asarray, variables)


@pytest.mark.parametrize("prefix", ["", "model."])
def test_generator_importer_matches_jax_and_loads_into_the_port(narrow_jax_generator, prefix):
    """``generator_params_from_torch`` on model_vc_mel.py's names (and the
    GeneratorSTFT checkpoint's 'model.' prefix): the same trees as JAX's
    importer bit for bit; the port's Generator on them against JAX's
    Generator on its import within 1e-4 (eval mode, the imported running
    statistics)."""
    jmodel, variables = narrow_jax_generator
    sd = _reference_generator(variables["params"], prefix=prefix)
    params, stats = interop.generator_params_from_torch(sd)
    jparams, jstats = jax_interop.generator_params_from_torch(sd)
    _same_tree(params, jparams)
    _same_tree(stats, jstats)
    port = build_generator(narrow_config(), device="cpu")
    port.load_state_dict(generator_state_from_jax({"params": params, "batch_stats": stats}))
    rng = np.random.RandomState(3)
    x, c_org, c_trg = rng.rand(2, 64, 80).astype(np.float32), *rng.randn(2, 2, NARROW["dim_emb"]).astype(np.float32)
    want = jmodel.apply({"params": jparams, "batch_stats": jstats}, x, c_org, c_trg, train=False)
    with torch.no_grad():
        got = port(*map(torch.from_numpy, (x, c_org, c_trg)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=FWD_TOL, rtol=0)


def test_wav_generator_importer_matches_jax_and_loads_into_the_port():
    """``generator_wav_params_from_torch`` on model_vc_wav.py's names (the
    ConvTasNet front and back end, its PReLU slopes and BatchNorms): JAX's
    trees bit for bit; the port's GeneratorWav on them against JAX's on its
    import within 1e-4 (8960 samples: 32 latent frames)."""
    cfg = narrow_config(model_type="wav")
    jmodel = jax_narrow(cfg)
    x = np.random.RandomState(4).uniform(-1, 1, (2, 8960, 1)).astype(np.float32)
    c = np.random.RandomState(5).randn(2, NARROW["dim_emb"]).astype(np.float32)
    variables = jmodel.init(jax.random.PRNGKey(2), jnp.asarray(x), jnp.asarray(c), jnp.asarray(c), train=False)
    sd = _reference_wav(jax.tree_util.tree_map(np.asarray, variables["params"]))
    params, stats = interop.generator_wav_params_from_torch(sd)
    jparams, jstats = jax_interop.generator_wav_params_from_torch(sd)
    _same_tree(params, jparams)
    _same_tree(stats, jstats)
    port = build_generator(cfg, device="cpu")
    port.load_state_dict(generator_state_from_jax({"params": params, "batch_stats": stats}))
    want = jmodel.apply({"params": jparams, "batch_stats": jstats}, x, c, c[::-1], train=False)
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(c), torch.from_numpy(c[::-1].copy()))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=FWD_TOL, rtol=0)


def test_dvector_importer_matches_jax_and_loads_into_the_port():
    """``dvector_params_from_torch`` on the 3000000-BL.ckpt's names
    ('module.' stripped, bias_ih + bias_hh): JAX's tree bit for bit; the
    port's DVector on it against JAX's within 1e-4."""
    sd = _reference_dvector()
    tree, jtree = interop.dvector_params_from_torch(sd), jax_interop.dvector_params_from_torch(sd)
    _same_tree(tree, jtree)
    x = np.random.RandomState(6).rand(3, 128, 80).astype(np.float32)
    want = JaxDVector(dim_cell=32, dim_emb=16).apply({"params": jtree}, jnp.asarray(x))
    with torch.no_grad():
        got = build_dvector(tree, device="cpu")(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FWD_TOL, rtol=0)


def test_hifigan_importer_matches_jax_and_loads_into_the_port():
    """``hifigan_params_from_torch`` on the public generator's names, each
    weight-norm format among its convolutions: JAX's tree bit for bit; the
    port's vocoder on it against JAX's within 1e-4."""
    cfg, jcfg = HiFiGANConfig(**HIFI_KW), JaxHiFiGANConfig(**HIFI_KW)
    sd = _reference_hifigan(cfg)
    tree, jtree = interop.hifigan_params_from_torch(sd, cfg), jax_interop.hifigan_params_from_torch(sd, jcfg)
    _same_tree(tree, jtree)
    mel = np.random.RandomState(7).rand(2, 6, 80).astype(np.float32)
    want = np.asarray(JaxHiFiGANVocoder(jcfg, jtree).generate(mel))
    got = HiFiGANVocoder(cfg, params=tree, device="cpu").generate(mel).numpy()
    np.testing.assert_allclose(got, want, atol=FWD_TOL, rtol=0)


def test_wavenet_importer_matches_jax_and_loads_into_the_port():
    """``wavenet_params_from_torch`` on r9y9's names (legacy weight norm,
    parametrizations and plain weights): JAX's tree bit for bit; the port's
    teacher-forced WaveNet on it against JAX's within 1e-4."""
    cfg, jcfg = WaveNetConfig(**WN_KW), JaxWaveNetConfig(**WN_KW)
    sd = _reference_wavenet(cfg)
    tree, jtree = interop.wavenet_params_from_torch(sd, cfg), jax_interop.wavenet_params_from_torch(sd, jcfg)
    _same_tree(tree, jtree)
    model = WaveNet(cfg)
    model.load_state_dict(wavenet_state_from_jax(tree))
    rng = np.random.RandomState(8)
    x, mel = rng.uniform(-1, 1, (2, 300, 1)).astype(np.float32), rng.rand(2, 2, 80).astype(np.float32)
    want = np.asarray(jax_wavenet.apply(jtree, jcfg, jnp.asarray(x), jnp.asarray(mel)))
    with torch.no_grad():
        got = model.apply(torch.from_numpy(x), torch.from_numpy(mel)).numpy()
    np.testing.assert_allclose(got, want, atol=FWD_TOL, rtol=0)


# ------------------------------------------ torch checkpoints at the entry points


@pytest.mark.parametrize("wrap", ["generator", "state_dict", None])
def test_hifigan_from_checkpoint_reads_a_torch_checkpoint(tmp_path, wrap):
    """``HiFiGANVocoder.from_checkpoint(cfg, 'g.pt')``: the checkpoint's
    ``generator`` or ``state_dict`` entry, or a bare state dict, as JAX's
    from_checkpoint reads them: the same weights exactly."""
    cfg = HiFiGANConfig(**HIFI_KW)
    sd = _reference_hifigan(cfg, seed=1)
    path = str(tmp_path / "g.pt")
    torch.save({wrap: sd} if wrap else sd, path)
    port = HiFiGANVocoder.from_checkpoint(cfg, path, device="cpu")
    jax_voc = JaxHiFiGANVocoder.from_checkpoint(JaxHiFiGANConfig(**HIFI_KW), path)
    from autovc_tpu_torch.io import hifigan_state_from_jax

    want = hifigan_state_from_jax(jax.tree_util.tree_map(np.asarray, jax_voc.params))
    got = port.model.state_dict()
    assert got.keys() == want.keys()
    assert all(torch.equal(got[k], v) for k, v in want.items())


def test_wavenet_from_checkpoint_reads_a_torch_checkpoint(tmp_path):
    """``WaveNetVocoder.from_checkpoint(cfg, 'ckpt.pth')`` on an r9y9
    checkpoint ({'state_dict', 'global_step', ...}): JAX's weights exactly,
    and the packed kernel weights built from them."""
    cfg = WaveNetConfig(**WN_KW)
    path = str(tmp_path / "checkpoint_step001000000_ema.pth")
    torch.save({"state_dict": _reference_wavenet(cfg, seed=2), "global_step": 1000000}, path)
    port = WaveNetVocoder.from_checkpoint(cfg, path, device="cpu")
    jax_voc = jax_wavenet.WaveNetVocoder.from_checkpoint(JaxWaveNetConfig(**WN_KW), path)
    want = wavenet_state_from_jax(jax.tree_util.tree_map(np.asarray, jax_voc.params))
    got = port.model.state_dict()
    assert got.keys() == want.keys() and all(torch.equal(got[k], v) for k, v in want.items())
    assert set(port.packed) and all(torch.isfinite(v).all() for v in port.packed.values())


def test_make_metadata_reads_the_reference_torch_dvector(tmp_path):
    """``cli.make_metadata --dvector_ckpt 3000000-BL.ckpt`` ({'model_b':
    state dict}) against the JAX CLI on the same tree: the same speakers and
    conversions, the embeddings within the d-vector's 1e-5."""
    from test_torch_speaker import DVEC_TOL, _assert_same_rows, _raw, _spmel_tree

    from autovc_tpu.cli import make_metadata as jax_make_metadata
    from autovc_tpu_torch.cli import make_metadata

    dirs = {}
    for side in ("port", "jax"):
        dirs[side] = tmp_path / side
        _spmel_tree(str(dirs[side]))
    ckpt = str(tmp_path / "3000000-BL.ckpt")
    torch.save({"model_b": _reference_dvector(dim_cell=768, dim_emb=256, seed=3)}, ckpt)
    make_metadata.main(["--main_dir", str(dirs["port"]), "--dvector_ckpt", ckpt, "--device", "cpu"])
    jax_make_metadata.main(["--platform", "cpu", "--main_dir", str(dirs["jax"]), "--dvector_ckpt", ckpt])
    for name in ("train.pkl", "metadata.pkl"):
        _assert_same_rows(_raw(dirs["port"] / "spmel" / name), _raw(dirs["jax"] / "spmel" / name), DVEC_TOL)


def test_import_torch_then_convert_matches_the_jax_chain(tmp_path, monkeypatch):
    """``cli.import_torch`` of a reference .ckpt ({'epoch', 'state_dict',
    ...}) writes the port's Solver checkpoint (fresh Adam moments, the EMA
    equal to the parameters, the epoch as its step), which ``cli.convert
    --run_dir`` converts as the JAX chain (its import_torch's orbax run,
    then its convert) does: the same results within 1e-4; the Solver
    (``cli.train --resume``) restores it. The CLIs build the
    narrow widths (a monkeypatched ModelConfig / build_generator, as
    tests/test_torch_convert_cli.py narrows them)."""
    from test_torch_convert_cli import _same_results, _tree

    from autovc_tpu.cli import convert as jax_convert_cli
    from autovc_tpu.cli import import_torch as jax_import_torch
    from autovc_tpu import models as jax_models
    from autovc_tpu_torch.cli import convert as convert_cli
    from autovc_tpu_torch.cli import import_torch
    from autovc_tpu_torch.data import load_results

    for mod in (convert_cli, import_torch):
        monkeypatch.setattr(mod, "ModelConfig", narrow_config)
    monkeypatch.setattr(jax_convert_cli, "build_generator", jax_narrow)
    monkeypatch.setattr(jax_models, "build_generator", jax_narrow)
    _tree(tmp_path)
    jmodel = jax_narrow(narrow_config())
    x = np.zeros((1, 64, 80), np.float32)
    c = np.zeros((1, NARROW["dim_emb"]), np.float32)
    variables = jax.tree_util.tree_map(np.asarray, jmodel.init(jax.random.PRNGKey(5), x, c, c, train=False))
    ckpt = str(tmp_path / "chkpnt_spmel.ckpt")
    torch.save({"epoch": 42, "state_dict": _reference_generator(variables["params"], 1),
                "optimizer": {}, "loss": 0.5}, ckpt)
    path = import_torch.main(["--ckpt", ckpt, "--out_run_dir", str(tmp_path / "port_run")])
    tree = torch.load(path, weights_only=True)
    assert tree["step"] == 42 and tree["opt_state"]["state"] == {}
    assert all(torch.equal(tree["ema_params"][k], v) for k, v in tree["params"].items())
    got = convert_cli.main(["--main_dir", str(tmp_path), "--run_dir", str(tmp_path / "port_run"), "--device", "cpu",
                            "--out", str(tmp_path / "port.pkl")])
    jax_import_torch.main(["--platform", "cpu", "--ckpt", ckpt, "--out_run_dir", str(tmp_path / "jax_run")])
    want_path = str(tmp_path / "jax.pkl")
    jax_convert_cli.main(["--platform", "cpu", "--main_dir", str(tmp_path), "--run_dir", str(tmp_path / "jax_run"),
                          "--out", want_path])
    _same_results(got, load_results(want_path))
    assert len(got) == 2
    # cli.train --resume's Solver restores the imported run: step, weights, fresh Adam
    from autovc_tpu_torch.config import Config
    from autovc_tpu_torch.data import BatchIterator, UtteranceDataset
    from autovc_tpu_torch.train import Solver

    solver = Solver(Config(model=narrow_config(), main_dir=str(tmp_path), run_name="r"),
                    BatchIterator(UtteranceDataset(str(tmp_path / "spmel")), 2, 32), run_dir=str(tmp_path / "port_run"),
                    device="cpu")
    assert solver.state.step == 42 and solver.state.optimizer.state_dict()["state"] == {}
    assert all(torch.equal(p.detach(), tree["params"][n]) for n, p in solver.state.model.named_parameters())


# ------------------------------------------------------------ visualize


def test_visualize_describes_pickles_as_jax_and_plots(tmp_path, capsys, monkeypatch):
    """``describe_pickle`` prints what JAX's prints for a results and a
    train manifest; ``main`` writes one PNG a feature file and a result's
    mel; without matplotlib plotting raises and says so, while
    ``describe_pickle`` still works."""
    from autovc_tpu.cli import visualize as jax_visualize
    from autovc_tpu_torch.cli import visualize
    from autovc_tpu_torch.data import SpeakerEntry, save_results, save_train_manifest

    rng = np.random.RandomState(9)
    results, train = str(tmp_path / "results.pkl"), str(tmp_path / "train.pkl")
    save_results(results, [(str(i), rng.rand(20 + i, 80).astype(np.float32)) for i in range(7)])
    save_train_manifest(train, [SpeakerEntry(f"p{i}", rng.randn(16).astype(np.float32), [f"p{i}/a.npy"] * (i + 1))
                                for i in range(3)])
    for path in (results, train):
        visualize.describe_pickle(path)
        ours = capsys.readouterr().out
        jax_visualize.describe_pickle(path)
        assert ours == capsys.readouterr().out and "entries" in ours
    pytest.importorskip("matplotlib")
    feat = str(tmp_path / "p225_001.npy")
    np.save(feat, rng.rand(30, 80).astype(np.float32))
    out = tmp_path / "png"
    visualize.main([feat, results, "--out_dir", str(out)])
    assert sorted(os.listdir(out)) == sorted(["p225_001.png"] + [f"result_{i}.png" for i in range(7)])
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(SystemExit, match="needs matplotlib"):
        visualize.plot_features(feat, str(out))
    visualize.describe_pickle(results)
    assert "list of 7 entries" in capsys.readouterr().out
