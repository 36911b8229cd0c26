"""The port's speaker-embedding path against the JAX package on the CPU: the
GE2E ``DVector`` on both committed checkpoints, the windowed
``SpeakerEmbedder``, the evaluation's NumPy functions, the metadata builder
and its CLI, the speaker-encoder evaluation CLI, and the ``lambda_spk``
training auxiliary (``windowed_embed``, ``loss_fn`` with ``spk``, the
Solver's tables). The d-vector's LSTM kernels on a card are held to their
plain versions in tests/test_torch_gpu.py."""

import os
import pickle
import shutil
import warnings

import numpy as np
import pandas as pd
import pytest
import torch

import jax
import jax.numpy as jnp

from autovc_tpu import eval as jax_eval
from autovc_tpu.cli import evaluate_speaker_encoder as jax_eval_cli
from autovc_tpu.cli import make_metadata as jax_make_metadata
from autovc_tpu.config import Config as JaxConfig
from autovc_tpu.config import ModelConfig as JaxModelConfig
from autovc_tpu.config import TrainConfig as JaxTrainConfig
from autovc_tpu.data import metadata_builder as jax_builder
from autovc_tpu.eval import fidelity as jax_fidelity
from autovc_tpu.models.autovc import Decoder, Encoder, Generator as JaxGenerator, Postnet
from autovc_tpu.models.layers import _lstm_scan
from autovc_tpu.models.dvector import DVector as JaxDVector
from autovc_tpu.models.dvector import dvector_for_params as jax_dvector_for_params
from autovc_tpu.train import step as jax_step
from autovc_tpu.train.ge2e import GE2ETrainer
from autovc_tpu.train.solver import Solver as JaxSolver
from autovc_tpu_torch import eval as port_eval
from autovc_tpu_torch.cli import evaluate_speaker_encoder, make_metadata
from autovc_tpu_torch.config import Config, ModelConfig, TrainConfig
from autovc_tpu_torch.data import SpeakerEntry, UtteranceDataset, BatchIterator, save_train_manifest
from autovc_tpu_torch.data import metadata_builder as builder
from autovc_tpu_torch.data.manifest import load_conversion_metadata
from autovc_tpu_torch.eval import fidelity
from autovc_tpu_torch.io import (dvector_state_from_jax, dvector_state_to_jax, flatten_params,
                                 generator_state_from_jax, save_dvector_artifact)
from autovc_tpu_torch.models import DVector, build_dvector, build_generator, dvector_for_params
from autovc_tpu_torch.ops import lstm as lstm_ops
from autovc_tpu_torch.train import Solver, loss_fn
from autovc_tpu_torch.train.compare import grad_scale
from autovc_tpu_torch.train.ge2e import load_params
from autovc_tpu_torch.train.step import SpeakerAux, windowed_embed

from test_torch_bf16_train import _ulps

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARTIFACTS = {"indep": os.path.join(REPO, "artifacts", "ge2e_indep.npz"),  # 80/256/256 x3
             "full": os.path.join(REPO, "artifacts", "ge2e.npz")}  # 80/768/256 x3, the reference's widths
# The d-vector on the CPU, the port's plain loop against JAX's lax.scan:
# f32 sums in another order through three recurrences of 128 steps (the
# trained 768-wide encoder measured 6.5e-6)
DVEC_TOL = 1e-5
NARROW_CELL, NARROW_EMB = 32, 16


def _narrow_ge2e(path, seed=0):
    """A seeded narrow GE2E checkpoint (dim_cell 32, dim_emb 16), written by
    the port as the JAX trainer writes one."""
    model = DVector(dim_cell=NARROW_CELL, dim_emb=NARROW_EMB)
    model.reset_parameters(seed)
    save_dvector_artifact(model.state_dict(), str(path))
    return str(path)


def _jax_dvector(tree):
    params = tree.get("dvector", tree)
    model = jax_dvector_for_params(params)
    return model, params


# ------------------------------------------------------------------ DVector


@pytest.mark.parametrize("which", ["indep", "full"])
def test_dvector_matches_jax(which):
    """Unit embeddings of the committed encoders, B=3, T=128, against the
    JAX ``DVector`` (``lax.scan`` recurrence), within 1e-5."""
    tree = load_params(ARTIFACTS[which])
    jmodel, jparams = _jax_dvector(GE2ETrainer.load_params(ARTIFACTS[which]))
    x = np.random.RandomState(0).rand(3, 128, 80).astype(np.float32)
    want = np.asarray(jmodel.apply({"params": jparams}, jnp.asarray(x)))
    with torch.no_grad():
        got = build_dvector(tree, device="cpu")(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (3, 256)
    np.testing.assert_allclose(got, want, atol=DVEC_TOL, rtol=0)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-6)


@pytest.mark.parametrize("which", ["indep", "full", "malformed"])
def test_dvector_for_params_sizes_to_the_tree(which):
    if which == "malformed":
        tree = {"dvector": {"lstm": {}, "embedding": {}}}
        with pytest.warns(UserWarning, match="not understood"):
            got = dvector_for_params(tree)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            want = jax_dvector_for_params(tree)
    else:
        got = dvector_for_params(load_params(ARTIFACTS[which]))
        want = jax_dvector_for_params(GE2ETrainer.load_params(ARTIFACTS[which]))
    dims = (got.dim_input, got.dim_cell, got.dim_emb, got.num_layers)
    assert dims == (want.dim_input, want.dim_cell, want.dim_emb, want.num_layers)
    assert dims == {"indep": (80, 256, 256, 3), "full": (80, 768, 256, 3), "malformed": (80, 768, 256, 3)}[which]


def test_dvector_state_round_trips_the_jax_tree(tmp_path):
    """state_from_jax and state_to_jax are inverses; the port's GE2E .npz
    loads into JAX's GE2ETrainer.load_params and gives the port's
    embeddings."""
    path = _narrow_ge2e(tmp_path / "ge2e.npz", seed=3)
    tree = load_params(path)
    state = dvector_state_from_jax(tree)
    back = flatten_params(dvector_state_to_jax(state))
    assert back.keys() == flatten_params(tree["dvector"]).keys()
    assert all(np.array_equal(v, flatten_params(tree["dvector"])[k]) for k, v in back.items())
    jmodel, jparams = _jax_dvector(GE2ETrainer.load_params(path))
    x = np.random.RandomState(1).rand(2, 40, 80).astype(np.float32)
    with torch.no_grad():
        got = build_dvector(tree, device="cpu")(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jmodel.apply({"params": jparams}, jnp.asarray(x))),
                               atol=DVEC_TOL, rtol=0)


# -------------------------------------------------- the d-vector in bfloat16

BF = torch.bfloat16
# The scan rounding against JAX's: where both round the same float32 value
# they agree bit for bit; a float32 sum of another order (h @ w_hh over H
# terms, dgates @ w_hh^T over 4H) lands a value a hair from a rounding
# boundary on the neighbouring bfloat16 value, and the bfloat16 carry keeps
# it. So the forward's first SCAN_STEPS steps are held to 1 ulp (floored at
# 2^-16 of the peak) and >= 99% bit-equal, and both whole sequences to
# SPREAD_MULT times the plain loop's own spread (the backward starts from the
# forward's last steps, where the two forwards have parted, and each of its
# steps rounds dh's sum over 4H to bfloat16, so one flip moves the next steps'
# small elements by tens of their ulps, on either side):
# its largest distance from itself with the hidden units relabelled in
# RELABELLINGS ways (the same network, its sums in another order). Measured
# at B=7, T=128, H=256 on two seeds: JAX's distance 0-0.016 of h_seq's and
# dxproj's, 0.00-0.67 of that spread.
SCAN_STEPS = 16
SPREAD_MULT = 2.0
RELABELLINGS = 4


def _scan_inputs(seed, b, t, hidden):
    """bfloat16 xproj, w_hh and dy as float32 numpy arrays, from a seed."""
    rng = np.random.RandomState(seed)
    bound = 1.0 / np.sqrt(hidden)
    arrays = ((rng.randn(b, t, 4 * hidden) * 0.5), rng.uniform(-bound, bound, (hidden, 4 * hidden)),
              rng.randn(b, t, hidden))
    return [torch.from_numpy(a.astype(np.float32)).to(BF).float().numpy() for a in arrays]


def _port_scan(xproj, w_hh, dy, reverse, perm=None):
    """The plain forward's h_seq and the backward's dxproj, with the hidden
    units relabelled by ``perm`` (and relabelled back) when given."""
    x, w, d = (torch.from_numpy(a).to(BF) for a in (xproj, w_hh, dy))
    if perm is not None:
        p = torch.from_numpy(perm)
        cols = torch.cat([p + g * len(p) for g in range(4)])
        x, w, d = x[..., cols], w[p][:, cols], d[..., p]
    h_seq, c_seq, act, _, _ = lstm_ops.lstm_scan_bf16_train_ref(x, w, reverse=reverse)
    dx = lstm_ops.lstm_scan_bf16_backward_ref(w, act, c_seq, None, d, reverse=reverse)[0]
    h_seq, dx = h_seq.float().numpy(), dx.float().numpy()
    if perm is not None:
        inv = np.argsort(perm)
        h_seq, dx = h_seq[..., inv], dx[..., np.concatenate([inv + g * len(inv) for g in range(4)])]
    return h_seq, dx


def _jax_scan(xproj, w_hh, dy, reverse):
    def run(x, w, d):
        zero = jnp.zeros((x.shape[0], w.shape[0]), x.dtype)
        y, vjp = jax.vjp(lambda x: _lstm_scan(x, w, zero, zero, reverse), x)
        return y, vjp(d)[0]

    y, dx = jax.jit(run)(*(jnp.asarray(a).astype(jnp.bfloat16) for a in (xproj, w_hh, dy)))
    return np.asarray(y.astype(jnp.float32)), np.asarray(dx.astype(jnp.float32))


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("b, t, hidden", [(8, 24, NARROW_CELL), (7, 128, 256)])
def test_scan_rounding_matches_jax_lstm_scan(b, t, hidden, reverse):
    """``lstm_scan_bf16_train_ref`` and ``lstm_scan_bf16_backward_ref``
    against ``jax.jit`` of ``_lstm_scan`` and its ``jax.vjp`` in bfloat16, at
    the narrow GE2E width and at the independent encoder's: the forward's
    first SCAN_STEPS steps within 1 ulp and >= 99% bit-equal, h_seq and
    dxproj within SPREAD_MULT times the plain loop's own spread (bit-equal
    where that spread is zero)."""
    xproj, w_hh, dy = _scan_inputs(b + t + hidden, b, t, hidden)
    want_h, want_dx = _jax_scan(xproj, w_hh, dy, reverse)
    got_h, got_dx = _port_scan(xproj, w_hh, dy, reverse)
    relabelled = [_port_scan(xproj, w_hh, dy, reverse, np.random.RandomState(k).permutation(hidden))
                  for k in range(RELABELLINGS)]
    spread_h = max(np.abs(got_h - h).max() for h, _ in relabelled)
    spread_dx = max(np.abs(got_dx - dx).max() for _, dx in relabelled)
    first = slice(t - SCAN_STEPS, t) if reverse else slice(0, SCAN_STEPS)
    g, w = got_h[:, first], want_h[:, first]
    assert _ulps(g, w).max() <= 1.0 and (g == w).mean() >= 0.99
    apart_h, apart_dx = np.abs(got_h - want_h).max(), np.abs(got_dx - want_dx).max()
    print(f"B={b} T={t} H={hidden} reverse={reverse}: h_seq {apart_h:.2e} (own spread {spread_h:.2e}), "
          f"{(got_h == want_h).mean():.5f} bit-equal; dxproj {apart_dx:.2e} ({spread_dx:.2e}), "
          f"{(got_dx == want_dx).mean():.5f}")
    assert apart_h <= SPREAD_MULT * spread_h and apart_dx <= SPREAD_MULT * spread_dx


def test_scan_rounding_layer_follows_its_input():
    """``layers.LSTM(dtype=None, scan=True)`` runs float32 for a float32
    input and the scan rounding for a bfloat16 one: its bfloat16 sequence
    equals JAX's ``LSTM(dtype=None)`` (``_lstm_scan`` under ``jit``) on the
    same input bit for bit (B=3, T=20, two layers of H=32), its float32
    one within the d-vector's float32 tolerance."""
    from autovc_tpu.models import layers as jax_layers
    from autovc_tpu_torch.models import LSTM

    x = np.random.RandomState(5).rand(3, 20, 24).astype(np.float32)
    jm = jax_layers.LSTM(NARROW_CELL, num_layers=2)
    params = jm.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"]
    layer = LSTM(24, NARROW_CELL, num_layers=2, dtype=None, scan=True)
    layer.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in params.items()})
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    want = np.asarray(jax.jit(lambda v: jm.apply({"params": params}, v))(xb).astype(jnp.float32))
    with torch.no_grad():
        got = layer(torch.from_numpy(x).to(BF))
        got32 = layer(torch.from_numpy(x))
    assert got.dtype == BF and got32.dtype == torch.float32
    np.testing.assert_array_equal(got.float().numpy(), want)
    np.testing.assert_allclose(got32.numpy(), np.asarray(jm.apply({"params": params}, jnp.asarray(x))),
                               atol=DVEC_TOL, rtol=0)


# The bfloat16 d-vector against JAX's: its embeddings are float32 (the dense
# layer promotes its bfloat16 input, as flax's does) from the last step's
# bfloat16 h. At the narrow width the two agree to float32 noise (1.2e-7);
# at H=256 a bfloat16 flip from a sum of another order, carried through
# three layers of 128 steps, moves them 3.1e-4, where the float32 d-vector on
# the input widened (the control) lies 3.9e-3 away. Held: within
# DVEC_BF16_TOL, or at H=256 within DVEC_BF16_SHARE of the control's
# distance, which the control fails.
DVEC_BF16_TOL = 1e-5
DVEC_BF16_SHARE = 0.25


@pytest.mark.parametrize("which", ["narrow", "indep"])
def test_bf16_dvector_matches_jax(which):
    """The port's ``DVector`` on a bfloat16 input against JAX's ``DVector``
    (``dtype=None``, so bfloat16 LSTMs by ``lax.scan``) under ``jit`` on the
    same input, B=3, T=128: float32 unit embeddings within DVEC_BF16_TOL
    (the seeded narrow encoder) or DVEC_BF16_SHARE of the widened float32
    control's distance (the committed independent one, H=256)."""
    if which == "narrow":
        port, jmodel, jparams = _narrow_pair(4)
    else:
        port = build_dvector(load_params(ARTIFACTS["indep"]), device="cpu")
        jmodel, jparams = _jax_dvector(GE2ETrainer.load_params(ARTIFACTS["indep"]))
    x = np.random.RandomState(2).rand(3, 128, 80).astype(np.float32)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    want = np.asarray(jax.jit(lambda v: jmodel.apply({"params": jparams}, v))(xb))
    with torch.no_grad():
        got = port(torch.from_numpy(x).to(BF))
        control = port(torch.from_numpy(x).to(BF).float())
    assert got.dtype == torch.float32 and want.dtype == np.float32
    apart, control_apart = np.abs(got.numpy() - want).max(), np.abs(control.numpy() - want).max()
    print(f"{which}: the bfloat16 d-vector {apart:.2e} from JAX's (the widened float32 one {control_apart:.2e})")
    gate = DVEC_BF16_TOL if which == "narrow" else DVEC_BF16_SHARE * control_apart
    assert apart <= gate < control_apart


# ------------------------------------------------------------ SpeakerEmbedder


@pytest.fixture(scope="module", params=["indep", "full"])
def embedders(request):
    tree = load_params(ARTIFACTS[request.param])
    return (port_eval.SpeakerEmbedder(tree, device="cpu"),
            jax_eval.SpeakerEmbedder(GE2ETrainer.load_params(ARTIFACTS[request.param])))


@pytest.mark.parametrize("frames", [60, 128, 317])
def test_speaker_embedder_matches_jax(embedders, frames):
    """One utterance zero-padded to a window (60), exactly one window (128),
    and four windows with the tail (317, padded to a batch of 8): within the
    DVector tolerance of JAX's embedding."""
    port, jax_embedder = embedders
    mel = np.random.RandomState(frames).rand(frames, 80).astype(np.float32)
    got, want = port.embed(mel), jax_embedder.embed(mel)
    assert got.shape == want.shape == (256,)
    np.testing.assert_allclose(got, want, atol=DVEC_TOL, rtol=0)


# --------------------------------------------------- the evaluation's NumPy


class _StubEmbedder:
    """embed(mel) -> a deterministic unit vector of the mel, for holding the
    NumPy functions of both packages to each other exactly."""

    def embed(self, mel):
        v = np.asarray(mel, np.float32)[:, :16].mean(axis=0) - 0.5
        return v / np.linalg.norm(v)


def _unit_rows(n, d=16, seed=0):
    e = np.random.RandomState(seed).randn(n, d).astype(np.float32)
    return e / np.linalg.norm(e, axis=-1, keepdims=True)


def test_speaker_centroids_and_similarity_records_match_jax():
    rng = np.random.RandomState(2)
    mels = {s: [rng.rand(rng.randint(50, 200), 80).astype(np.float32) for _ in range(4)] for s in ("a", "b", "c")}
    stub = _StubEmbedder()
    got, want = port_eval.speaker_centroids(stub, mels), jax_eval.speaker_centroids(stub, mels)
    assert got.keys() == want.keys() and all(np.array_equal(got[k], want[k]) for k in got)
    conv, orig = rng.rand(90, 80).astype(np.float32), rng.rand(70, 80).astype(np.float32)
    records = []
    for src, trg, o in (("a", "b", orig), ("b", "b", None), ("c", "a", orig), ("b", "c", None)):
        rec = port_eval.similarity_record(stub, got, conv, src, trg, o)
        assert rec == jax_eval.similarity_record(stub, want, conv, src, trg, o)
        records.append(rec)
    assert port_eval.summarize_similarity(records) == jax_eval.summarize_similarity(records)
    assert port_eval.summarize_similarity(records[1:2]) == jax_eval.summarize_similarity(records[1:2]) == {
        "pairs": 0}


@pytest.mark.parametrize("n, speakers", [(12, 3), (40, 5), (7, 2)])
def test_verification_eer_and_separation_match_jax(n, speakers):
    emb = _unit_rows(n, seed=n)
    labels = np.arange(n) % speakers
    assert port_eval.verification_eer(emb, labels) == jax_eval.verification_eer(emb, labels)
    assert port_eval.embedding_separation(emb, labels) == jax_eval.embedding_separation(emb, labels)


def test_mel_fidelity_report_matches_jax():
    rng = np.random.RandomState(4)
    a, b = rng.rand(120, 80).astype(np.float32), rng.rand(117, 80).astype(np.float32)
    assert fidelity.mel_fidelity_report(a, b) == jax_fidelity.mel_fidelity_report(a, b)
    assert fidelity.mel_cepstral_distortion(a, b, n_coeffs=20) == jax_fidelity.mel_cepstral_distortion(
        a, b, n_coeffs=20)


# ---------------------------------------------------------- metadata builder

SPEAKERS = ("p225", "p226", "p227")
SPEAKER_INFO = ("ID  AGE  GENDER  ACCENTS  REGION\n"
                "p225  23  F    English    Southern\n"
                "p226  22  M  English  Surrey\n"
                "p227  38  M  English  Cumbria\n")


def _spmel_tree(root, utts=12, seed=0):
    """<root>/spmel/<speaker>/<speaker>_<nnn>.npy for three speakers, 40-300
    frames (some shorter than a 128-frame crop), numbered from 002 so that
    the reference's default conversion (p225 sentence 001) is absent; one
    _mic2 file; a speaker table and one transcript."""
    rng = np.random.RandomState(seed)
    for s in SPEAKERS:
        os.makedirs(os.path.join(root, "spmel", s))
        for u in range(utts):
            frames = int(rng.randint(40, 300))
            name = f"{s}_{u + 2:03d}" + ("_mic2" if (s, u) == ("p226", 1) else "")
            np.save(os.path.join(root, "spmel", s, name + ".npy"), rng.rand(frames, 80).astype(np.float32))
    with open(os.path.join(root, "speaker_info.txt"), "w") as fh:
        fh.write(SPEAKER_INFO)
    os.makedirs(os.path.join(root, "txt", "p226"))
    with open(os.path.join(root, "txt", "p226", "p226_003.txt"), "w") as fh:
        fh.write("Please call Stella.  \n")
    return os.path.join(root, "spmel")


def test_embed_speaker_picks_the_jax_crops(tmp_path):
    """The same seed draws the same utterances and crops (short utterances
    resampled); with the two packages' d-vectors the embeddings agree within
    the DVector tolerance."""
    mel_dir = _spmel_tree(str(tmp_path))
    crops = {"port": [], "jax": []}

    def recorder(name):
        def apply_fn(crop):
            crops[name].append(np.asarray(crop))
            return np.asarray(crop)[:, 0, :16]
        return apply_fn

    for s in SPEAKERS:
        got = builder.embed_speaker(recorder("port"), mel_dir, s, np.random.default_rng(7))
        want = jax_builder.embed_speaker(recorder("jax"), mel_dir, s, np.random.default_rng(7))
        np.testing.assert_array_equal(got, want)
    assert len(crops["port"]) == len(crops["jax"]) == 30
    assert all(np.array_equal(a, b) for a, b in zip(crops["port"], crops["jax"]))

    path = _narrow_ge2e(tmp_path / "ge2e.npz")
    port_fn = make_metadata.dvector_apply_fn(path, device="cpu")
    jmodel, jparams = _jax_dvector(GE2ETrainer.load_params(path))
    got = builder.embed_speaker(port_fn, mel_dir, "p226", np.random.default_rng(8))
    want = jax_builder.embed_speaker(lambda x: jmodel.apply({"params": jparams}, x), mel_dir, "p226",
                                     np.random.default_rng(8))
    np.testing.assert_allclose(got, want, atol=DVEC_TOL, rtol=0)


def test_build_manifests_match_jax(tmp_path):
    root = str(tmp_path)
    mel_dir = _spmel_tree(root)
    emb = {s: e for s, e in zip(SPEAKERS, _unit_rows(3, 256))}
    got, want = builder.build_train_manifest(mel_dir, emb), jax_builder.build_train_manifest(mel_dir, emb)
    assert [(e.speaker_id, e.utterances) for e in got] == [(e.speaker_id, e.utterances) for e in want]
    assert all(np.array_equal(a.embedding, b.embedding) for a, b in zip(got, want))
    conversions = [(("p226", "003"), "p225"), (("p225", "005"), "p227")]
    info = pd.read_csv(os.path.join(root, "speaker_info.txt"), sep=r"\s+")
    table = builder.SpeakerTable.read(os.path.join(root, "speaker_info.txt"))
    got = builder.build_conversion_metadata(mel_dir, emb, conversions, os.path.join(root, "txt"), table,
                                            str(tmp_path / "port.log"))
    want = jax_builder.build_conversion_metadata(mel_dir, emb, conversions, os.path.join(root, "txt"), info,
                                                 str(tmp_path / "jax.log"))
    for g, w in zip(got, want):
        assert (g.conversion_id, g.src_name, g.trg_speaker, g.src_speaker) == (
            w.conversion_id, w.src_name, w.trg_speaker, w.src_speaker)
        for f in ("src_embedding", "src_features", "trg_embedding"):
            np.testing.assert_array_equal(getattr(g, f), getattr(w, f))
    assert open(tmp_path / "port.log").read() == open(tmp_path / "jax.log").read()
    with pytest.raises(FileNotFoundError):
        builder.build_conversion_metadata(mel_dir, emb, [(("p225", "999"), "p226")])


@pytest.mark.parametrize("text", [
    SPEAKER_INFO,
    "ID AGE X\np225 2.50 a\np226 10.25 bb\n",  # float column, trimmed together
    "ID AGE X\np225 2 n/a\np226 n/a bb\n",  # missing values
    "ID AGE\n225 23\n226 24\n",  # numeric IDs never match a speaker name
    "ID AGE H\np225 -2 1.125\np226 30000 2.5\np227 7 3\n",
])
def test_speaker_table_writes_rows_as_pandas(tmp_path, text):
    """``SpeakerTable.rows_of`` against pandas'
    ``df[df["ID"] == speaker].to_string(index=False)``, the JAX CLI's
    metadata.log rows."""
    path = tmp_path / "speaker_info.txt"
    path.write_text(text)
    df = pd.read_csv(str(path), sep=r"\s+")
    table = builder.SpeakerTable.read(str(path))
    for spk in ("p225", "p226", "p227", "225", "x"):
        assert table.rows_of(spk) == df[df["ID"] == spk].to_string(index=False), spk


def _raw(path):
    with open(path, "rb") as fh:
        return pickle.load(fh)


def _assert_same_rows(got, want, atol):
    """Raw pickled rows: strings and ids equal, arrays within ``atol``."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, (list, tuple)):
            assert type(g) is type(w)
            _assert_same_rows(g, w, atol)
        elif isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_allclose(g, w, atol=atol, rtol=0)
        else:
            assert g == w


@pytest.mark.parametrize("mode", ["dvector", "one_hot", "reuse", "auto_reuse", "auto_one_hot", "conversions"])
def test_make_metadata_cli_matches_jax(tmp_path, mode, capsys):
    """``cli.make_metadata --device cpu`` against the JAX CLI on copies of
    one tree: train.pkl, metadata.pkl (the d-vector embeddings within the
    DVector tolerance, everything else exactly; the same bytes where the
    embeddings do not come from a d-vector) and metadata.log (the same
    text)."""
    base = tmp_path / "base"
    _spmel_tree(str(base))
    ckpt = _narrow_ge2e(tmp_path / "ge2e.npz")
    reuse = str(tmp_path / "reuse.pkl")
    save_train_manifest(reuse, [SpeakerEntry(s, e, []) for s, e in zip(SPEAKERS, _unit_rows(3, 256, seed=5))])
    if mode == "auto_reuse":
        save_train_manifest(str(base / "spmel" / "train.pkl"),
                            [SpeakerEntry(s, e, []) for s, e in zip(SPEAKERS, _unit_rows(3, 256, seed=6))])
    args = {"dvector": ["--dvector_ckpt", ckpt], "one_hot": ["--one_hot", "--dim_emb", "8"],
            "reuse": ["--reuse", reuse], "auto_reuse": [], "auto_one_hot": [],
            "conversions": ["--one_hot", "--conversions", "p226:003:p225,p227:004:p226"]}[mode]
    dirs = {k: tmp_path / k for k in ("port", "jax")}
    for d in dirs.values():
        shutil.copytree(base, d)
    make_metadata.main(["--main_dir", str(dirs["port"]), "--seed", "3", "--device", "cpu", *args])
    port_out = capsys.readouterr().out
    jax_make_metadata.main(["--main_dir", str(dirs["jax"]), "--seed", "3", *args])
    jax_out = capsys.readouterr().out
    assert port_out.replace(str(dirs["port"]), "") == jax_out.replace(str(dirs["jax"]), "")
    atol = DVEC_TOL if mode == "dvector" else 0.0
    for name in ("train.pkl", "metadata.pkl"):
        _assert_same_rows(_raw(dirs["port"] / "spmel" / name), _raw(dirs["jax"] / "spmel" / name), atol)
        if mode != "dvector":  # the same embeddings: the same bytes
            assert (dirs["port"] / "spmel" / name).read_bytes() == (dirs["jax"] / "spmel" / name).read_bytes()
    log = (dirs["port"] / "spmel" / "metadata.log").read_text()
    assert log == (dirs["jax"] / "spmel" / "metadata.log").read_text()
    assert "Uttered by the speaker:" in log
    specs = load_conversion_metadata(str(dirs["port"] / "spmel" / "metadata.pkl"))
    assert [s.src_name for s in specs] == (["p226_003", "p227_004"] if mode == "conversions" else ["p225_002"])


def test_make_metadata_refuses_a_torch_checkpoint(tmp_path):
    """A torch checkpoint that holds no d-vector raises on the first missing
    key (the reference's d-vector loads: tests/test_torch_interop.py)."""
    _spmel_tree(str(tmp_path))
    ckpt = str(tmp_path / "not-a-dvector.ckpt")
    torch.save({"model_b": {"encoder.lstm.weight_ih_l0": torch.zeros(4, 2)}}, ckpt)
    with pytest.raises(KeyError, match="lstm.weight_ih_l0"):
        make_metadata.main(["--main_dir", str(tmp_path), "--dvector_ckpt", ckpt, "--device", "cpu"])


@pytest.mark.parametrize("holdout", [0, 4])
def test_evaluate_speaker_encoder_cli_matches_jax(tmp_path, holdout, capsys):
    """The JSON of ``cli.evaluate_speaker_encoder --device cpu`` against the
    JAX CLI's on one tree of four speakers (one of them with too few
    utterances for the holdout): the same keys and counts, the EER,
    threshold and cosines within 1e-5 (the embeddings agree within the
    DVector tolerance). ``run`` gives ``main``'s report and the unit
    embeddings it scored."""
    root = str(tmp_path)
    mel_dir = _spmel_tree(root, utts=10)
    entries = []
    for s in SPEAKERS:
        files = sorted(os.listdir(os.path.join(mel_dir, s)))
        entries.append(SpeakerEntry(s, np.zeros(16, np.float32), [os.path.join(s, f) for f in files]))
    entries.append(SpeakerEntry("p228", np.zeros(16, np.float32), entries[0].utterances[:3]))
    save_train_manifest(os.path.join(mel_dir, "train.pkl"), entries)
    ckpt = _narrow_ge2e(tmp_path / "ge2e.npz", seed=4)
    args = ["--main_dir", root, "--dvector_ckpt", ckpt, "--holdout", str(holdout)]
    got = evaluate_speaker_encoder.main(args + ["--device", "cpu", "--out", str(tmp_path / "rep.json")])
    want = jax_eval_cli.main(args)
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k] == pytest.approx(v, abs=1e-5, rel=0), k
    assert (got["utterances"], got["speakers"]) == ((12, 3) if holdout else (33, 4))
    assert "skipping p228" in capsys.readouterr().out if holdout else True
    rep, embeds = evaluate_speaker_encoder.run(args + ["--device", "cpu"])
    assert rep == got
    assert embeds.shape == (got["utterances"], NARROW_EMB)
    np.testing.assert_allclose(np.linalg.norm(embeds, axis=1), 1.0, atol=1e-6)


# ---------------------------------------------------------- lambda_spk path


def _narrow_pair(seed=0):
    """The same seeded narrow d-vector as the port's (on the CPU) and as the
    JAX module with its params."""
    model = DVector(dim_cell=NARROW_CELL, dim_emb=NARROW_EMB)
    model.reset_parameters(seed)
    tree = dvector_state_to_jax(model.state_dict())
    jtree = jax.tree_util.tree_map(jnp.asarray, tree)
    return build_dvector(tree, device="cpu"), JaxDVector(dim_cell=NARROW_CELL, dim_emb=NARROW_EMB), jtree


@pytest.mark.parametrize("frames", [100, 128, 300])
def test_windowed_embed_matches_jax(frames):
    """One padded window (100), exactly one (128), and five with the tail
    (300), two rows: within the DVector tolerance of JAX's
    ``windowed_embed``, and the SpeakerEmbedder's embedding of each row."""
    port, jmodel, jparams = _narrow_pair(1)
    mel = np.random.RandomState(frames).rand(2, frames, 80).astype(np.float32)
    with torch.no_grad():
        got = windowed_embed(port, torch.from_numpy(mel)).numpy()
    want = np.asarray(jax_step.windowed_embed(jmodel, jparams, jnp.asarray(mel)))
    np.testing.assert_allclose(got, want, atol=DVEC_TOL, rtol=0)
    embedder = port_eval.SpeakerEmbedder(dvector_state_to_jax(port.state_dict()), device="cpu")
    for row in range(2):
        np.testing.assert_allclose(embedder.embed(mel[row]), got[row], atol=DVEC_TOL, rtol=0)


NARROW = dict(dim_neck=8, dim_emb=16, dim_pre=32, freq=8)
PORT_CFG = Config(model=ModelConfig(**NARROW, enc_channels=32, dec_lstm_dim=64, postnet_channels=32))


class NarrowGenerator(JaxGenerator):
    """The JAX generator at the narrow widths of tests/test_torch_train.py."""

    def setup(self):
        self.encoder = Encoder(self.dim_neck, self.freq, channels=32)
        self.decoder = Decoder(self.n_bins, self.dim_pre, lstm_dim=64)
        self.postnet = Postnet(self.n_bins, channels=32)


@pytest.mark.parametrize("protocol", ["windowed", "crop"])
def test_speaker_loss_and_gradients_match_jax(protocol):
    """``loss_fn`` with the auxiliary (lambda_spk 0.7, margin 1.5) against
    JAX's on the same weights, batch, frozen d-vector and tables: the loss
    within 1e-5 relative, every term within 1e-5 relative (``g_loss_spk``
    among them; windowed, ``g_spk_margin`` within 1e-5), each gradient leaf
    within 1e-4 of its ``grad_scale``, the updated statistics within 1e-5;
    the d-vector gets no gradient."""
    rng = np.random.RandomState(9)
    b, t = 4, 136  # 136 frames: two windows, the second the tail
    x = rng.rand(b, t, 80).astype(np.float32)
    emb = rng.randn(b, NARROW["dim_emb"]).astype(np.float32)
    table = emb / np.linalg.norm(emb, axis=-1, keepdims=True)  # the batch's rows are the table's speakers
    cents = _unit_rows(b, NARROW_EMB, seed=11)
    jmodel = NarrowGenerator(**NARROW)
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(emb), jnp.asarray(emb))
    params, stats = variables["params"], variables["batch_stats"]
    port_dvec, jdvec, jdparams = _narrow_pair(2)
    windowed = protocol == "windowed"
    jaux = jax_step.SpeakerAux(jdvec, jdparams, *((jnp.asarray(table), jnp.asarray(cents)) if windowed else ()))
    aux = SpeakerAux(port_dvec, *((torch.from_numpy(table), torch.from_numpy(cents)) if windowed else ()))
    train = dict(lambda_spk=0.7, spk_protocol=protocol, spk_margin=1.5)
    jcfg = JaxConfig(model=JaxModelConfig(model_type="spmel", **NARROW),
                     train=JaxTrainConfig(spk_ckpt="unused-here", **train))
    (jtotal, (jm, jstats)), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jax_step.loss_fn(jmodel, jcfg, p, stats, jnp.asarray(x), jnp.asarray(emb), spk=jaux),
        has_aux=True))(params)
    model = build_generator(PORT_CFG.model, device="cpu", trainable=True)
    model.load_state_dict(generator_state_from_jax({"params": params, "batch_stats": stats}))
    cfg = Config(model=PORT_CFG.model, train=TrainConfig(**train))
    total, metrics = loss_fn(model, cfg, torch.from_numpy(x), torch.from_numpy(emb), spk=aux)
    total.backward()
    keys = ["g_loss", "g_loss_id", "g_loss_id_psnt", "g_loss_cd", "g_loss_spk"] + (["g_spk_margin"] if windowed
                                                                                    else [])
    assert sorted(metrics) == sorted(jm) == sorted(keys)
    for k in keys:  # the margin, a difference of two cosines, may sit near 0: 1e-5 absolute
        tol = dict(abs=1e-5, rel=0) if k == "g_spk_margin" else dict(rel=1e-5)
        assert float(metrics[k]) == pytest.approx(float(jm[k]), **tol), k
    assert float(metrics["g_loss_spk"]) > 0
    want = generator_state_from_jax({"params": jgrads, "batch_stats": jstats})
    for name, p in model.named_parameters():
        torch.testing.assert_close(p.grad, want[name], atol=1e-4 * grad_scale(name, want), rtol=0, msg=name)
    for name, buf in model.named_buffers():
        torch.testing.assert_close(buf, want[name], atol=1e-5, rtol=0, msg=name)
    assert all(p.grad is None and not p.requires_grad for p in port_dvec.parameters())


def _corpus(root, speakers=4, utts=3, seed=0):
    rng = np.random.RandomState(seed)
    mel_dir = os.path.join(root, "spmel")
    entries = []
    for s in range(speakers):
        os.makedirs(os.path.join(mel_dir, f"p{s}"))
        paths = []
        for u in range(utts):
            np.save(os.path.join(mel_dir, f"p{s}", f"u{u}.npy"),
                    rng.rand(int(rng.randint(40, 200)), 80).astype(np.float32))
            paths.append(f"p{s}/u{u}.npy")
        entries.append(SpeakerEntry(f"p{s}", rng.randn(NARROW["dim_emb"]).astype(np.float32), paths))
    save_train_manifest(os.path.join(mel_dir, "train.pkl"), entries)
    return mel_dir


def test_solver_speaker_tables_match_jax(tmp_path):
    """The Solver's 'windowed' tables (the unit-norm train.pkl rows and the
    evaluation's centroids, computed on the CPU) against JAX's
    ``Solver._speaker_aux_windowed`` on the same tree and checkpoint: the
    table exactly, the centroids within the DVector tolerance."""
    mel_dir = _corpus(str(tmp_path))
    ckpt = _narrow_ge2e(tmp_path / "ge2e.npz", seed=5)
    cfg = Config(model=PORT_CFG.model, train=TrainConfig(batch_size=2, len_crop=32, lambda_spk=1.0, spk_ckpt=ckpt),
                 main_dir=str(tmp_path), run_name="t")
    solver = Solver(cfg, BatchIterator(UtteranceDataset(mel_dir), 2, 32), run_dir=str(tmp_path / "run"),
                    device="cpu")
    jcfg = JaxConfig(train=JaxTrainConfig(lambda_spk=1.0, spk_ckpt=ckpt), main_dir=str(tmp_path))
    want = JaxSolver._speaker_aux_windowed(type("S", (), {"cfg": jcfg})(),
                                           GE2ETrainer.load_params(ckpt)["dvector"])
    np.testing.assert_array_equal(solver.spk_aux.emb_table.numpy(), np.asarray(want.emb_table))
    np.testing.assert_allclose(solver.spk_aux.centroids.numpy(), np.asarray(want.centroids), atol=DVEC_TOL, rtol=0)
    assert not any(p.requires_grad for p in solver.spk_aux.model.parameters())


@pytest.mark.parametrize("protocol", ["windowed", "crop"])
def test_solver_trains_with_lambda_spk_and_logs_its_keys(tmp_path, protocol, capsys):
    """Three Solver steps with the auxiliary on: finite losses, the
    auxiliary's keys in the history and on the console, the eval loss with
    the same terms as the training loss."""
    mel_dir = _corpus(str(tmp_path))
    ckpt = _narrow_ge2e(tmp_path / "ge2e.npz", seed=6)
    cfg = Config(model=PORT_CFG.model, train=TrainConfig(batch_size=2, len_crop=32, log_step=1, num_iters=3,
                                                         checkpoint_step=10_000, lambda_spk=1.0, spk_ckpt=ckpt,
                                                         spk_protocol=protocol),
                 main_dir=str(tmp_path), run_name="t")
    solver = Solver(cfg, BatchIterator(UtteranceDataset(mel_dir), 2, 32), run_dir=str(tmp_path / "run"),
                    device="cpu")
    solver.train()
    keys = {"g_loss_spk"} | ({"g_spk_margin"} if protocol == "windowed" else set())
    assert len(solver.history) == 3 and all(keys <= h.keys() and np.isfinite(h["g_loss"]) for h in solver.history)
    out = capsys.readouterr().out
    assert all(k in out for k in keys)
    assert keys <= solver.eval_loss(*next(solver.data_iter)).keys()
    with pytest.raises(ValueError, match="spk_ckpt"):
        Solver(Config(model=PORT_CFG.model, train=TrainConfig(lambda_spk=1.0), main_dir=str(tmp_path)),
               iter(()), run_dir=str(tmp_path / "r2"), device="cpu")


def test_train_cli_passes_the_speaker_flags(tmp_path, monkeypatch):
    """``cli.train --lambda_spk --spk_ckpt --spk_protocol --spk_margin``
    reach the Solver's TrainConfig."""
    import autovc_tpu_torch.train as train_pkg
    from autovc_tpu_torch.cli.train import main

    seen = {}

    class Recorder:
        def __init__(self, cfg, data_iter, device):
            seen["cfg"] = cfg

        def train(self):
            pass

    monkeypatch.setattr(train_pkg, "Solver", Recorder)
    _corpus(str(tmp_path))
    main(["--main_dir", str(tmp_path), "--run_name", "c", "--device", "cpu", "--lambda_spk", "0.3",
          "--spk_ckpt", "ge2e.npz", "--spk_protocol", "crop", "--spk_margin", "1.2"])
    tc = seen["cfg"].train
    assert (tc.lambda_spk, tc.spk_ckpt, tc.spk_protocol, tc.spk_margin) == (0.3, "ge2e.npz", "crop", 1.2)


def test_speaker_gradient_where_the_base_loss_kinks_differ():
    """At B=4, T=136 with embeddings 1.7 times unit rows, some of the base
    loss's ReLU inputs sit within 1e-6 of their kink, so the port's and
    JAX's float32 gradients of the whole loss take other sides there. The
    auxiliary's own gradient, the 'windowed' loss's minus the reference
    loss's on each side, still agrees within 1e-4 of each leaf's scale."""
    rng = np.random.RandomState(9)
    b, t = 4, 136
    x = rng.rand(b, t, 80).astype(np.float32)
    table = _unit_rows(b, NARROW["dim_emb"], seed=10)
    emb = (table * 1.7).astype(np.float32)
    cents = _unit_rows(b, NARROW_EMB, seed=11)
    jmodel = NarrowGenerator(**NARROW)
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(emb), jnp.asarray(emb))
    params, stats = variables["params"], variables["batch_stats"]
    port_dvec, jdvec, jdparams = _narrow_pair(2)
    jaux = jax_step.SpeakerAux(jdvec, jdparams, jnp.asarray(table), jnp.asarray(cents))
    aux = SpeakerAux(port_dvec, torch.from_numpy(table), torch.from_numpy(cents))
    got, want = {}, {}
    for lam in (0.7, 0.0):
        jcfg = JaxConfig(model=JaxModelConfig(model_type="spmel", **NARROW),
                         train=JaxTrainConfig(lambda_spk=lam, spk_ckpt="unused-here"))
        jgrads = jax.jit(jax.grad(lambda p: jax_step.loss_fn(jmodel, jcfg, p, stats, jnp.asarray(x), jnp.asarray(emb),
                                                             spk=jaux)[0]))(params)
        want[lam] = generator_state_from_jax({"params": jgrads, "batch_stats": stats})
        model = build_generator(PORT_CFG.model, device="cpu", trainable=True)
        model.load_state_dict(generator_state_from_jax({"params": params, "batch_stats": stats}))
        cfg = Config(model=PORT_CFG.model, train=TrainConfig(lambda_spk=lam))
        loss_fn(model, cfg, torch.from_numpy(x), torch.from_numpy(emb), spk=aux)[0].backward()
        got[lam] = {n: p.grad for n, p in model.named_parameters()}
    aux_want = {n: want[0.7][n] - want[0.0][n] for n in got[0.7]}
    for n in got[0.7]:
        torch.testing.assert_close(got[0.7][n] - got[0.0][n], aux_want[n], atol=1e-4 * grad_scale(n, aux_want),
                                   rtol=0, msg=n)
