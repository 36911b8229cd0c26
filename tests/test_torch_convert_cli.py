"""The port's conversion of the stft and wav variants and its conversion and
evaluation CLIs against the JAX package on the CPU: ``bucket_length``,
``Converter.convert_to_mel`` and ``convert_batch(to_mel, use_buckets)``,
``run_conversions``' pkl, ``WavConverter``, ``all_pairs_specs``, and
``cli.convert`` (``--artifact``, ``--run_dir`` of a port Solver,
``--all_pairs``, ``--raw``), ``cli.evaluate`` and
``cli.evaluate_conversion --through mel`` against the JAX CLIs on one
temporary tree and artifact.

The CLIs build the published widths; here both packages' CLIs build a
narrow stand-in (dim_neck 8, dim_emb 16, dim_pre 32, encoder 32, decoder
LSTM 64, postnet 32, ConvTasNet 16 channels) at the CLIs' own freq, 32."""

import os

import numpy as np
import pytest
import torch

import autovc_tpu.cli.convert as jax_convert_cli
import autovc_tpu.models as jax_models
from autovc_tpu.config import Config as JaxConfig
from autovc_tpu.config import ModelConfig as JaxModelConfig
from autovc_tpu.convert import Converter as JaxConverter
from autovc_tpu.convert import WavConverter as JaxWavConverter
from autovc_tpu.convert import all_pairs_specs as jax_all_pairs_specs
from autovc_tpu.convert import bucket_length as jax_bucket_length
from autovc_tpu.convert import run_conversions as jax_run_conversions
from autovc_tpu.models.autovc import Decoder, Encoder, Generator as JaxGenerator, Postnet
from autovc_tpu.models.convtas import ConvTasDecoder as JaxTasDecoder
from autovc_tpu.models.convtas import ConvTasEncoder as JaxTasEncoder
from autovc_tpu.models.convtas import GeneratorWav as JaxGeneratorWav
from autovc_tpu_torch.cli import convert as convert_cli
from autovc_tpu_torch.cli import evaluate as evaluate_cli
from autovc_tpu_torch.cli import evaluate_conversion as evaluate_conversion_cli
from autovc_tpu_torch.config import Config, ModelConfig, TrainConfig
from autovc_tpu_torch.convert import Converter, WavConverter, all_pairs_specs, bucket_length, run_conversions
from autovc_tpu_torch.data import (BatchIterator, SpeakerEntry, UtteranceDataset, load_results,
                                   save_conversion_metadata, save_train_manifest)
from autovc_tpu_torch.io import save_dvector_artifact, save_generator_artifact
from autovc_tpu_torch.models import DVector, build_generator

torch.set_num_threads(1)

NARROW = dict(dim_neck=8, dim_emb=16, dim_pre=32)
WIDTHS = dict(**NARROW, enc_channels=32, dec_lstm_dim=64, postnet_channels=32, convtas_channels=16)
SPEAKERS = ("p225", "p226", "p227")
ATOL = 1e-4


class NarrowGen(JaxGenerator):
    def setup(self):
        self.encoder = Encoder(self.dim_neck, self.freq, channels=32)
        self.decoder = Decoder(self.n_bins, self.dim_pre, lstm_dim=64)
        self.postnet = Postnet(self.n_bins, channels=32)


class NarrowWav(JaxGeneratorWav):
    def setup(self):
        self.tas_encoder = JaxTasEncoder(self.depth, self.channels)
        self.encoder = Encoder(self.dim_neck, self.freq, channels=32)
        self.decoder = Decoder(self.channels, self.dim_pre, lstm_dim=64)
        self.tas_decoder = JaxTasDecoder(self.depth, self.channels)


def narrow_config(**kw) -> ModelConfig:
    """The port CLIs' ``ModelConfig`` at the narrow widths."""
    return ModelConfig(**WIDTHS, **kw)


def jax_narrow(model_cfg):
    """The JAX CLIs' ``build_generator`` at the narrow widths."""
    if model_cfg.model_type == "wav":
        return NarrowWav(**NARROW, freq=model_cfg.freq, channels=WIDTHS["convtas_channels"])
    return NarrowGen(**NARROW, freq=model_cfg.freq, n_bins=model_cfg.n_bins)


@pytest.fixture
def narrow_clis(monkeypatch):
    for mod in (convert_cli, evaluate_cli, evaluate_conversion_cli):
        monkeypatch.setattr(mod, "ModelConfig", narrow_config)
    monkeypatch.setattr(jax_convert_cli, "build_generator", jax_narrow)
    monkeypatch.setattr(jax_models, "build_generator", jax_narrow)


def _waveform(rng, n):
    t = np.arange(n) / 16000.0
    x = sum(np.sin(2 * np.pi * k * rng.uniform(100, 250) * t) / k for k in range(1, 4))
    return (0.4 * x + 0.05 * rng.randn(n)).astype(np.float32)[:, None]


def _tree(root, utts=2, seed=0):
    """<root>/{spmel,stft,wav}/<speaker>/<speaker>_<nnn>.npy with the same
    names (100-128 frames, one padded length at freq 32, about a spectral
    envelope of the speaker's: the d-vector's windows hold a few zero
    frames at most; the waveforms 9000 to 9600 samples, 32
    latent frames), a train.pkl in each and a metadata.pkl of two
    conversions in each."""
    rng = np.random.RandomState(seed)
    entries = []
    for s in SPEAKERS:
        env = {"spmel": rng.rand(80), "stft": rng.rand(513)}  # a spectral envelope a speaker
        paths = []
        for u in range(utts):
            rel = f"{s}/{s}_{u + 1:03d}.npy"
            frames = int(rng.randint(100, 129))
            feats = {k: np.clip(e + 0.1 * rng.randn(frames, e.size), 0, 1).astype(np.float32) for k, e in env.items()}
            feats["wav"] = _waveform(rng, int(rng.randint(9000, 9600)))
            for kind, f in feats.items():
                os.makedirs(os.path.join(root, kind, s), exist_ok=True)
                np.save(os.path.join(root, kind, rel), f)
            paths.append(rel)
        emb = rng.randn(NARROW["dim_emb"]).astype(np.float32)
        entries.append(SpeakerEntry(s, emb / np.linalg.norm(emb), paths))
    for kind in ("spmel", "stft", "wav"):
        save_train_manifest(os.path.join(root, kind, "train.pkl"), entries)
        specs = all_pairs_specs(entries, os.path.join(root, kind))
        save_conversion_metadata(os.path.join(root, kind, "metadata.pkl"), [specs[1], specs[5]])
    return entries


def _artifact(path, model_type, seed=1):
    save_generator_artifact(build_generator(narrow_config(model_type=model_type), device="cpu", seed=seed)
                            .state_dict(), 5, str(path))
    return str(path)


def _jax_converter(model_type, art, use_buckets=False):
    from autovc_tpu.cli.export_ckpt import load_artifact as jax_load_artifact

    variables, _ = jax_load_artifact(art)
    cfg = JaxConfig(model=JaxModelConfig(model_type=model_type))
    cls = JaxWavConverter if model_type == "wav" else JaxConverter
    kw = {} if model_type == "wav" else {"use_buckets": use_buckets}
    return cls(jax_narrow(cfg.model), variables["params"], variables["batch_stats"], cfg, **kw)


def _port_converter(model_type, art, use_buckets=False):
    cfg = narrow_config(model_type=model_type)
    gen = build_generator(cfg, artifact=art, device="cpu")
    return WavConverter(gen, cfg) if model_type == "wav" else Converter(gen, cfg, use_buckets=use_buckets)


def _same_results(got, want, atol=ATOL):
    assert [name for name, _ in got] == [name for name, _ in want]
    for (name, g), (_, w) in zip(got, want):
        assert g.shape == np.asarray(w).shape, name
        np.testing.assert_allclose(g, np.asarray(w, np.float32), atol=atol, rtol=0, err_msg=name)


# -------------------------------------------------------------- the converters


@pytest.mark.parametrize("t", [1, 31, 32, 256, 257, 700])
def test_bucket_length_matches_jax(t):
    assert bucket_length(t, 32) == jax_bucket_length(t, 32)
    with pytest.raises(ValueError, match="multiple"):
        bucket_length(t, 32, 100)


@pytest.mark.parametrize("use_buckets", [False, True])
def test_stft_converter_matches_jax(tmp_path, use_buckets):
    """The stft converter: ``convert`` (513 bins), ``convert_to_mel`` (80),
    ``convert_batch`` with and without ``to_mel`` (a short group
    zero-filled), padded to freq or to 256-frame buckets; each within 1e-4
    of JAX's, in the order of the specs."""
    entries = _tree(tmp_path)
    art = _artifact(tmp_path / "stft.npz", "stft")
    specs = all_pairs_specs(entries, str(tmp_path / "stft"))[:5]
    port, jc = _port_converter("stft", art, use_buckets), _jax_converter("stft", art, use_buckets)
    got, want = port.convert(specs[0]), jc.convert(specs[0])
    assert got.shape == (specs[0].src_features.shape[0], 513)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    np.testing.assert_allclose(port.convert_to_mel(specs[1]), jc.convert_to_mel(specs[1]), atol=ATOL, rtol=0)
    for to_mel in (True, False):
        got = port.convert_batch(specs, batch_size=4, to_mel=to_mel)
        want = jc.convert_batch(specs, batch_size=4, to_mel=to_mel)
        assert [g.shape for g in got] == [(s.src_features.shape[0], 80 if to_mel else 513) for s in specs]
        _same_results(list(enumerate(got)), list(enumerate(want)))


def test_run_conversions_writes_the_results_pkl(tmp_path):
    """``[(str(id), mel)]`` pickled in the order of the specs, as JAX's."""
    entries = _tree(tmp_path)
    art = _artifact(tmp_path / "stft.npz", "stft")
    specs = all_pairs_specs(entries, str(tmp_path / "stft"))[:3]
    got = run_conversions(_port_converter("stft", art), specs, str(tmp_path / "r.pkl"))
    want = jax_run_conversions(_jax_converter("stft", art), specs)
    _same_results(got, want)
    _same_results(load_results(str(tmp_path / "r.pkl")), want)
    assert [name for name, _ in got] == ["0", "1", "2"]


def test_wav_converter_matches_jax(tmp_path):
    """``valid_length``, the converted waveform (the valid length, within
    1e-4) and its re-extracted mel (the float32 front end on the CPU,
    within 1e-4) against JAX's ``WavConverter``."""
    entries = _tree(tmp_path)
    art = _artifact(tmp_path / "wav.npz", "wav")
    spec = all_pairs_specs(entries, str(tmp_path / "wav"))[1]
    port, jc = _port_converter("wav", art), _jax_converter("wav", art)
    for n in (8960, 9215, 9216, 20000):
        assert port.valid_length(n) == jc.valid_length(n)
    with pytest.raises(ValueError, match="too short"):
        port.valid_length(8959)
    wav = port.convert(spec)
    assert wav.shape == (port.valid_length(spec.src_features.shape[0]),)
    np.testing.assert_allclose(wav, jc.convert(spec), atol=ATOL, rtol=0)
    mel = port.convert_to_mel(spec)
    want = jc.convert_to_mel(spec)
    assert mel.shape == want.shape and mel.shape[1] == 80
    np.testing.assert_allclose(mel, want, atol=ATOL, rtol=0)


def test_all_pairs_specs_match_jax(tmp_path):
    entries = _tree(tmp_path)
    from autovc_tpu.data.manifest import load_train_manifest as jax_load_train_manifest

    jentries = jax_load_train_manifest(str(tmp_path / "spmel" / "train.pkl"))
    for index in (0, 1):
        got = all_pairs_specs(entries, str(tmp_path / "spmel"), index)
        want = jax_all_pairs_specs(jentries, str(tmp_path / "spmel"), index)
        assert len(got) == len(SPEAKERS) ** 2
        for g, w in zip(got, want):
            assert (g.conversion_id, g.src_name, g.trg_speaker, g.src_speaker) == (
                w.conversion_id, w.src_name, w.trg_speaker, w.src_speaker)
            for a in ("src_embedding", "trg_embedding", "src_features"):
                np.testing.assert_array_equal(getattr(g, a), getattr(w, a))


# ---------------------------------------------------------------------- CLIs


@pytest.mark.parametrize("model_type, flags", [("stft", ["--all_pairs"]), ("stft", ["--raw"]), ("wav", []),
                                               ("spmel", ["--all_pairs", "--raw"])])
def test_convert_cli_matches_jax_on_an_artifact(tmp_path, narrow_clis, model_type, flags):
    """``cli.convert --artifact``: the same results pkl as the JAX CLI (ids
    and order; arrays within 1e-4): the stft matrix batched and projected
    onto the mel bands, stft --raw in its 513 bins, wav re-extracted mels;
    the default path <main_dir>/<model_type>/results_step<step>.pkl."""
    _tree(tmp_path)
    art = _artifact(tmp_path / f"{model_type}.npz", model_type)
    want_path = str(tmp_path / "jax.pkl")
    jax_convert_cli.main(["--main_dir", str(tmp_path), "--artifact", art, "--model_type", model_type,
                          "--out", want_path, *flags])
    got = convert_cli.main(["--main_dir", str(tmp_path), "--artifact", art, "--model_type", model_type,
                            "--device", "cpu", *flags])
    out = tmp_path / model_type / "results_step5.pkl"
    want = load_results(want_path)
    n = len(SPEAKERS) ** 2 if "--all_pairs" in flags else 2
    assert len(want) == n
    _same_results(got, want)
    _same_results(load_results(str(out)), want)
    width = {"stft": 513 if "--raw" in flags else 80, "spmel": 80, "wav": 80}[model_type]
    assert all(np.isfinite(m).all() and m.shape[-1] == width for _, m in got)


def _solver_run(root):
    """Two steps of the port's Solver on the narrow spmel generator, its
    checkpoint at step 2 under <root>/run."""
    from autovc_tpu_torch.train import Solver

    cfg = Config(model=narrow_config(), train=TrainConfig(batch_size=2, len_crop=32, num_iters=2, log_step=1,
                                                          checkpoint_step=2, ema_decay=0.5),
                 main_dir=str(root), run_name="r")
    it = BatchIterator(UtteranceDataset(str(root / "spmel")), 2, 32, seed=0)
    solver = Solver(cfg, it, run_dir=str(root / "run"), device="cpu")
    solver.train()
    return solver


@pytest.mark.parametrize("use_ema", [False, True])
def test_convert_cli_reads_a_port_run_dir(tmp_path, narrow_clis, use_ema):
    """``cli.convert --run_dir`` reads the Solver's newest checkpoint (its
    EMA with --use_ema): the same results as the JAX CLI on an artifact of
    those weights."""
    _tree(tmp_path)
    solver = _solver_run(tmp_path)
    tree, step = convert_cli.load_solver_checkpoint(str(tmp_path / "run"))
    assert step == 2 and set(tree) >= {"params", "ema_params", "batch_stats"}
    params = tree["ema_params" if use_ema else "params"]
    model = solver.state.model
    assert all(torch.equal(params[n], (solver.state.ema_params[n] if use_ema else p.detach()))
               for n, p in model.named_parameters())
    art = str(tmp_path / "run.npz")
    save_generator_artifact({**params, **tree["batch_stats"]}, step, art)
    want_path = str(tmp_path / "jax.pkl")
    jax_convert_cli.main(["--main_dir", str(tmp_path), "--artifact", art, "--out", want_path])
    ema = ["--use_ema"] if use_ema else []
    got = convert_cli.main(["--main_dir", str(tmp_path), "--run_dir", str(tmp_path / "run"), "--device", "cpu",
                            "--out", str(tmp_path / "port.pkl"), *ema])
    _same_results(got, load_results(want_path))


def test_convert_cli_refuses_what_it_cannot_read(tmp_path, narrow_clis):
    """An orbax run (the JAX Solver's) raises and says what it is; no
    checkpoint raises; --seq_devices above 1 names its ROADMAP item."""
    _tree(tmp_path)
    (tmp_path / "orbax" / "checkpoints" / "100").mkdir(parents=True)
    with pytest.raises(ValueError, match="orbax"):
        convert_cli.main(["--main_dir", str(tmp_path), "--run_dir", str(tmp_path / "orbax"), "--device", "cpu"])
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        convert_cli.main(["--main_dir", str(tmp_path), "--run_dir", str(tmp_path), "--device", "cpu"])
    with pytest.raises(SystemExit, match="Queue 1 #8"):
        convert_cli.main(["--main_dir", str(tmp_path), "--artifact", "a.npz", "--seq_devices", "2", "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            convert_cli.main(["--main_dir", str(tmp_path), "--artifact", "a.npz"])


def test_convert_cli_writes_pdfs(tmp_path, narrow_clis):
    """--pdf writes one <id>_conversion.pdf per result beside the pkl (the
    wav source shown as its mel)."""
    pytest.importorskip("matplotlib")
    _tree(tmp_path)
    art = _artifact(tmp_path / "wav.npz", "wav")
    convert_cli.main(["--main_dir", str(tmp_path), "--artifact", art, "--model_type", "wav", "--device", "cpu",
                      "--pdf"])
    assert sorted(p for p in os.listdir(tmp_path / "wav") if p.endswith(".pdf")) == [
        "1_conversion.pdf", "5_conversion.pdf"]


def test_evaluate_cli_matches_jax(tmp_path, narrow_clis, monkeypatch, capsys):
    """``cli.evaluate`` on a port run: the JAX CLI's report (the JAX CLI
    given the same checkpoint's weights), the step and utterance count
    exactly, the metrics within 1e-4 relative; --max_utts."""
    import json

    from autovc_tpu.cli.evaluate import main as jax_evaluate
    from autovc_tpu.cli.export_ckpt import load_artifact as jax_load_artifact

    _tree(tmp_path)
    _solver_run(tmp_path)
    tree, step = convert_cli.load_solver_checkpoint(str(tmp_path / "run"))
    art = str(tmp_path / "run.npz")
    save_generator_artifact({**tree["params"], **tree["batch_stats"]}, step, art)
    variables, _ = jax_load_artifact(art)
    monkeypatch.setattr(jax_convert_cli, "load_solver_checkpoint",
                        lambda run_dir: ({"params": variables["params"], "batch_stats": variables["batch_stats"]},
                                         step))
    for extra in ([], ["--max_utts", "3"]):
        want = jax_evaluate(["--main_dir", str(tmp_path), "--run_dir", "x", *extra])
        got = evaluate_cli.main(["--main_dir", str(tmp_path), "--run_dir", str(tmp_path / "run"), "--device", "cpu",
                                 *extra])
        assert (got["step"], got["utterances"]) == (want["step"], want["utterances"]) == (
            2, 3 if extra else 2 * len(SPEAKERS))
        for k in want:
            assert got[k] == pytest.approx(want[k], rel=1e-4), k
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == got


@pytest.mark.parametrize("model_type", ["spmel", "stft"])
def test_evaluate_conversion_cli_matches_jax(tmp_path, narrow_clis, model_type):
    """``cli.evaluate_conversion --through mel`` with a seeded narrow GE2E
    (written by ``io.save_dvector_artifact``): the JAX CLI's summary and
    records, in order: cosines, margins and the identity L1 within 1e-4, a
    conversion's success the same wherever JAX's margin is beyond 1e-4 (the
    success rate off by no more than the pairs within it), and the report
    file."""
    import json

    from autovc_tpu.cli.evaluate_conversion import main as jax_evaluate_conversion

    _tree(tmp_path)
    art = _artifact(tmp_path / "gen.npz", model_type)
    dvec = DVector(dim_cell=32, dim_emb=16)
    dvec.reset_parameters(3)
    ge2e = str(tmp_path / "ge2e.npz")
    save_dvector_artifact(dvec.state_dict(), ge2e)
    args = ["--main_dir", str(tmp_path), "--artifact", art, "--dvector_ckpt", ge2e, "--model_type", model_type,
            "--centroid_utts", "2"]
    want = jax_evaluate_conversion(args)
    got = evaluate_conversion_cli.main([*args, "--device", "cpu", "--out", str(tmp_path / "report.json")])
    gs, ws = got["summary"], want["summary"]
    assert gs.keys() == ws.keys()
    assert (gs["pairs"], gs["generator_step"], gs["through"]) == (ws["pairs"], ws["generator_step"], "mel")
    for k in ("mean_cos_trg", "mean_cos_src", "mean_margin", "median_margin", "identity_recon_l1_mean"):
        assert gs[k] == pytest.approx(ws[k], abs=1e-4), k
    assert [(r["src"], r["trg"]) for r in got["records"]] == [(r["src"], r["trg"]) for r in want["records"]]
    undecided = 0
    for r, w in zip(got["records"], want["records"]):
        for k in ("cos_trg", "cos_src", "margin", "orig_cos_trg", "orig_cos_src"):
            assert r[k] == pytest.approx(w[k], abs=1e-4), k
        if abs(w["margin"]) > 1e-4:  # a success decided beyond rounding
            assert r["success"] == w["success"]
        elif r["src"] != r["trg"]:
            undecided += 1
    assert abs(gs["success_rate"] - ws["success_rate"]) <= undecided / ws["pairs"]
    assert undecided < ws["pairs"] / 2
    with open(tmp_path / "report.json") as fh:
        assert json.load(fh)["summary"] == gs


def test_evaluate_conversion_cli_refuses_hybrid(tmp_path):
    """``--through audio --vocoder hybrid`` without ``--vocoder_ckpt`` is
    refused, as the JAX CLI refuses it (a random HiFi-GAN's audio scores
    nothing)."""
    with pytest.raises(SystemExit):
        evaluate_conversion_cli.main(["--main_dir", str(tmp_path), "--artifact", "a.npz", "--dvector_ckpt", "d.npz",
                                      "--through", "audio", "--vocoder", "hybrid", "--device", "cpu"])


def test_evaluate_conversion_cli_runs_hybrid(tmp_path, narrow_clis, monkeypatch):
    """``--through audio --vocoder hybrid`` (a narrow HiFi-GAN from a seeded
    checkpoint the port wrote): every cross pair scored and the identity
    pairs' L1, each converted mel re-extracted from the hybrid vocoder's
    waveform."""
    import dataclasses
    import json

    from autovc_tpu_torch.config import HiFiGANConfig
    from autovc_tpu_torch.io import conv_state_to_jax
    from autovc_tpu_torch.vocoder.hifigan import HiFiGANGenerator

    narrow = dataclasses.replace(HiFiGANConfig(), upsample_initial_channel=16)
    monkeypatch.setattr(evaluate_conversion_cli, "HiFiGANConfig", lambda: narrow)
    _tree(tmp_path)
    art = _artifact(tmp_path / "gen.npz", "spmel")
    dvec = DVector(dim_cell=32, dim_emb=16)
    dvec.reset_parameters(3)
    ge2e = str(tmp_path / "ge2e.npz")
    save_dvector_artifact(dvec.state_dict(), ge2e)
    hifigan = HiFiGANGenerator(narrow)
    hifigan.reset_parameters(4)
    voc = str(tmp_path / "hifigan.npz")
    np.savez(voc, **conv_state_to_jax(hifigan.state_dict()))
    got = evaluate_conversion_cli.main(["--main_dir", str(tmp_path), "--artifact", art, "--dvector_ckpt", ge2e,
                                        "--through", "audio", "--vocoder", "hybrid", "--vocoder_ckpt", voc,
                                        "--centroid_utts", "2", "--device", "cpu"])
    summary = got["summary"]
    pairs = len(SPEAKERS) * (len(SPEAKERS) - 1)
    assert (summary["through"], summary["vocoder"], summary["pairs"]) == ("audio", "hybrid", pairs)
    assert np.isfinite([summary["mean_margin"], summary["identity_recon_l1_mean"]]).all()
    assert json.dumps(summary)
