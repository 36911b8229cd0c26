"""The port's parallelism on the CPU against the JAX package's: the mesh and
its tensor-parallel rules, the sequence-parallel primitives (a 4-rank gloo
world against JAX's shard_map on 4 virtual devices), the host-sharded batch
iterator, the native loader, ``cli.convert --seq_devices``. SPGenerator:
tests/test_torch_sp_generator.py.

Every world is started with ``parallel.launch.run_world`` (spawned
processes, a ``file://`` store, one thread a rank). The ranks import this
module by name to find their work, so it imports JAX only inside the tests.
"""

import os

import numpy as np
import pytest
import torch

from autovc_tpu_torch.config import ModelConfig
from autovc_tpu_torch.data import (BatchIterator, SpeakerEntry, UtteranceDataset, load_conversion_metadata,
                                   save_train_manifest)
from autovc_tpu_torch.models import build_generator
from autovc_tpu_torch.parallel import mesh as pmesh
from autovc_tpu_torch.parallel.launch import run_world
from autovc_tpu_torch.parallel.sequence import halo_conv1d, sp_blstm, sp_lstm, time_block

torch.set_num_threads(1)

SEQ_TOL = 1e-5  # test_parallel.py's tolerance of the primitives
# test_parallel.py's tolerances of the whole generator against the dense one
CODES_TOL, ID_TOL, PSNT_TOL = 2e-5, 2e-4, 2e-3


# ------------------------------------------------------------ rank work


def _gathered(block: torch.Tensor, mesh) -> np.ndarray:
    return pmesh.all_gather(block, mesh, "seq", dim=1).numpy()


def _seq_world(dev, inp: dict) -> dict:
    """A 4-rank 'seq' world: every primitive on its block, the global
    results gathered; make_mesh's layout at 2 x 2."""
    mesh = pmesh.mesh_over({"seq": 4}, dev)
    out = {}
    for k in (5, 1):
        x = time_block(torch.from_numpy(inp["halo_x"]), mesh)
        w = torch.from_numpy(inp[f"halo_w{k}"]).permute(2, 1, 0)  # (k, in, out) -> (out, in, k)
        out[f"halo{k}"] = _gathered(halo_conv1d(x, w, torch.from_numpy(inp["halo_b"]), mesh), mesh)
    x = time_block(torch.from_numpy(inp["lstm_x"]), mesh)
    for reverse in (False, True):
        out[f"lstm_{reverse}"] = _gathered(
            sp_lstm(x, *(torch.from_numpy(inp[k]) for k in ("lstm_w_ih", "lstm_w_hh", "lstm_b")), mesh,
                    reverse=reverse), mesh)
    x = time_block(torch.from_numpy(inp["blstm_x"]), mesh)
    out["blstm"] = _gathered(sp_blstm(x, {k: torch.from_numpy(v) for k, v in inp["blstm"].items()}, mesh), mesh)
    layout = pmesh.make_mesh(data=2, model=2, device=dev)
    out["layout"] = (layout.index("data"), layout.index("model"), layout.group_ranks["data"],
                     layout.group_ranks["model"])
    return out


# ------------------------------------------------------------- fixtures


def _jax_seq_mesh(n=4):
    import jax
    from jax.sharding import Mesh

    return Mesh(np.asarray(jax.devices()[:n]), ("seq",))


@pytest.fixture(scope="module")
def seq_run():
    """The inputs of tests/test_parallel.py's primitives, the JAX results on
    4 virtual devices, and the port's 4-rank world's."""
    import jax
    import jax.numpy as jnp

    from autovc_tpu.models import LSTM as JaxLSTM
    from autovc_tpu.parallel.sequence import halo_conv1d as jhalo, sp_blstm as jblstm, sp_lstm as jlstm

    mesh = _jax_seq_mesh()
    rng = np.random.RandomState(0)
    inp = {"halo_x": rng.randn(2, 64, 16).astype(np.float32),
           "halo_w5": (rng.randn(5, 16, 8) * 0.1).astype(np.float32),
           "halo_b": rng.randn(8).astype(np.float32)}
    inp["halo_w1"] = (np.random.RandomState(1).randn(1, 16, 8) * 0.1).astype(np.float32)
    rng = np.random.RandomState(1)
    b, t, cin, h = 2, 32, 12, 8
    inp.update(lstm_x=rng.randn(b, t, cin).astype(np.float32),
               lstm_w_ih=(rng.randn(cin, 4 * h) * 0.2).astype(np.float32),
               lstm_w_hh=(rng.randn(h, 4 * h) * 0.2).astype(np.float32),
               lstm_b=(rng.randn(4 * h) * 0.1).astype(np.float32))
    inp["blstm_x"] = np.random.RandomState(2).randn(1, 32, 10).astype(np.float32)
    blstm = JaxLSTM(hidden=6, num_layers=2, bidirectional=True)
    bvars = blstm.init(jax.random.PRNGKey(0), jnp.asarray(inp["blstm_x"]))
    inp["blstm"] = {k: np.asarray(v) for k, v in bvars["params"].items()}

    want = {f"halo{k}": np.asarray(jhalo(jnp.asarray(inp["halo_x"]), jnp.asarray(inp[f"halo_w{k}"]),
                                         jnp.asarray(inp["halo_b"]), mesh)) for k in (5, 1)}
    for reverse in (False, True):
        want[f"lstm_{reverse}"] = np.asarray(jlstm(*(jnp.asarray(inp[k]) for k in ("lstm_x", "lstm_w_ih",
                                                                                    "lstm_w_hh", "lstm_b")),
                                                   mesh, reverse=reverse))
    want["blstm"] = np.asarray(jblstm(jnp.asarray(inp["blstm_x"]), bvars["params"], mesh, num_layers=2))
    want["blstm_dense"] = np.asarray(blstm.apply(bvars, jnp.asarray(inp["blstm_x"])))
    got = run_world(_seq_world, 4, inp, device="cpu", threads=1)
    return inp, want, got


# ---------------------------------------------------------------- tests


@pytest.mark.parametrize("k", [5, 1])
def test_halo_conv1d_matches_jax(seq_run, k):
    """k = 5 and the k = 1 case (nothing to exchange; a past regression of
    the JAX function): the gathered blocks against JAX's on 4 devices and
    the dense convolution."""
    inp, want, got = seq_run
    x = torch.from_numpy(inp["halo_x"]).transpose(1, 2)
    dense = torch.nn.functional.conv1d(x, torch.from_numpy(inp[f"halo_w{k}"]).permute(2, 1, 0),
                                       torch.from_numpy(inp["halo_b"]), padding=k // 2).transpose(1, 2).numpy()
    out = got[0][f"halo{k}"]
    assert out.shape == want[f"halo{k}"].shape == (2, 64, 8)
    np.testing.assert_allclose(out, want[f"halo{k}"], atol=SEQ_TOL, rtol=0)
    np.testing.assert_allclose(out, dense, atol=SEQ_TOL, rtol=0)
    np.testing.assert_array_equal(got[3][f"halo{k}"], out)


@pytest.mark.parametrize("reverse", [False, True])
def test_sp_lstm_matches_jax(seq_run, reverse):
    """The relay of (h, c) over 4 blocks, both directions, against JAX's ring
    of ppermute rounds and the plain loop over the whole sequence."""
    from autovc_tpu_torch.ops.lstm import lstm_sequence_train_ref

    inp, want, got = seq_run
    xproj = torch.from_numpy(inp["lstm_x"]) @ torch.from_numpy(inp["lstm_w_ih"]) + torch.from_numpy(inp["lstm_b"])
    dense = lstm_sequence_train_ref(xproj, torch.from_numpy(inp["lstm_w_hh"]), reverse=reverse)[0].numpy()
    out = got[0][f"lstm_{reverse}"]
    np.testing.assert_allclose(out, want[f"lstm_{reverse}"], atol=SEQ_TOL, rtol=0)
    np.testing.assert_allclose(out, dense, atol=SEQ_TOL, rtol=0)


def test_sp_blstm_matches_jax(seq_run):
    """Two bidirectional layers with layers.LSTM's parameter names against
    JAX's sp_blstm and the dense flax LSTM."""
    inp, want, got = seq_run
    np.testing.assert_allclose(got[0]["blstm"], want["blstm"], atol=SEQ_TOL, rtol=0)
    np.testing.assert_allclose(got[0]["blstm"], want["blstm_dense"], atol=SEQ_TOL, rtol=0)


def test_make_mesh_layout(seq_run):
    """make_mesh(2, 2) over 4 ranks: rank = data * 2 + model, as JAX's
    reshape of the device list; each rank's 'data' and 'model' groups."""
    _, _, got = seq_run
    assert [g["layout"] for g in got] == [(0, 0, (0, 2), (0, 1)), (0, 1, (1, 3), (0, 1)),
                                          (1, 0, (0, 2), (2, 3)), (1, 1, (1, 3), (2, 3))]
    one = pmesh.make_mesh()  # no process group: a world of one
    assert one.shape == {"data": 1, "model": 1} and one.backend is None
    with pytest.raises(AssertionError, match="> 1 ranks"):
        pmesh.make_mesh(data=2)


def test_param_shardings_match_jax():
    """The full spmel Generator at model = 2: every parameter's sharded axis
    (in the port's layout) is the axis JAX's NamedSharding spec names on
    the same leaf, through io.generator_jax_paths; BatchNorm leaves stay
    replicated."""
    import jax

    from autovc_tpu.parallel import make_mesh as jax_make_mesh, param_shardings as jax_param_shardings
    from autovc_tpu_torch.io import generator_jax_paths, generator_state_to_jax

    model = build_generator(ModelConfig(), device="cpu")
    mesh = pmesh.Mesh(("data", "model"), (1, 2), 0, torch.device("cpu"), None, {}, {})
    got = pmesh.param_shardings(model, mesh)
    tree = generator_state_to_jax(model.state_dict())["params"]
    want = jax_param_shardings(tree, jax_make_mesh(data=4, model=2), tensor_parallel=True)
    flat_want = {"/".join(p.key for p in path): spec.spec
                 for path, spec in jax.tree_util.tree_flatten_with_path(want)[0]}
    paths = generator_jax_paths(model.state_dict())
    sharded = 0
    for name, axis in got.items():
        spec = tuple(flat_want[paths[name][1]])
        jax_axis = spec.index("model") if "model" in spec else None
        assert (None if axis is None else paths[name][2][axis]) == jax_axis, name
        sharded += axis is not None
    # 11 convs (kernel, bias), 7 LSTM directions (w_ih, w_hh, b), the projection's kernel
    assert sharded == sum("model" in tuple(s) for s in flat_want.values()) == 22 + 21 + 1
    assert pmesh.param_shardings(model, mesh, tensor_parallel=False) == {n: None for n in got}


def test_tp_rules_match_jax_on_test_parallel_tree():
    """tests/test_parallel.py's tree: the wide conv and the LSTM input
    projection shard, the non-matching leaf stays replicated, and a
    dimension 'model' does not divide falls through to the next rule."""
    from autovc_tpu.parallel import make_mesh as jax_make_mesh, param_shardings as jax_param_shardings
    import jax.numpy as jnp

    leaves = {"conv0/Conv_0/kernel": (5, 336, 512), "conv0/Conv_0/bias": (512,), "blstm/w_ih_l0_fwd": (512, 128),
              "blstm/b_l0_fwd": (128,), "small/kernel": (3, 3), "odd/Conv_0/kernel": (5, 4, 3)}
    tree: dict = {}
    for path, shape in leaves.items():
        node = tree
        for part in path.split("/")[:-1]:
            node = node.setdefault(part, {})
        node[path.split("/")[-1]] = jnp.zeros(shape)
    want = jax_param_shardings(tree, jax_make_mesh(data=4, model=2), tensor_parallel=True)
    for path, shape in leaves.items():
        node = want
        for part in path.split("/"):
            node = node[part]
        spec = tuple(node.spec)
        assert pmesh.tp_axis(path, shape, 2) == (spec.index("model") if "model" in spec else None), path
    assert pmesh.tp_axis("conv0/Conv_0/kernel", (5, 336, 512), 1) is None


def test_backend_follows_the_device_and_refuses_shared_nccl(monkeypatch, capsys):
    """gloo for the CPU, nccl for the card, AUTOVC_DIST_BACKEND above both;
    two NCCL ranks on one card raise with both ranks' devices, gloo ranks
    share it."""
    monkeypatch.delenv(pmesh.BACKEND_ENV, raising=False)
    assert pmesh.backend_for("cpu") == "gloo" and pmesh.backend_for("cuda") == "nccl"
    monkeypatch.setenv(pmesh.BACKEND_ENV, "gloo")
    assert pmesh.backend_for("cuda") == "gloo"
    monkeypatch.setenv(pmesh.BACKEND_ENV, "mpi")
    with pytest.raises(ValueError, match="gloo or nccl"):
        pmesh.backend_for("cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match=r"NCCL ranks 0 and 1 would both run on cuda:0"):
        pmesh.rank_device("cuda", 1, 2, "nccl")
    assert pmesh.rank_device("cuda", 1, 2, "gloo") == torch.device("cuda", 0)
    assert pmesh.rank_device("cuda", 0, 1, "nccl") == torch.device("cuda", 0)


# ------------------------------------------------------ data: sharding


def _corpus(root, speakers=4, utts=3, seed=0):
    rng = np.random.RandomState(seed)
    entries = []
    for s in range(speakers):
        os.makedirs(os.path.join(root, f"p{s}"), exist_ok=True)
        paths = []
        for u in range(utts):
            np.save(os.path.join(root, f"p{s}", f"u{u}.npy"), rng.rand(int(rng.randint(20, 90)), 80).astype(np.float32))
            paths.append(f"p{s}/u{u}.npy")
        entries.append(SpeakerEntry(f"p{s}", rng.randn(16).astype(np.float32), paths))
    save_train_manifest(os.path.join(root, "train.pkl"), entries)
    return str(root)


def test_batch_iterator_host_shards_join_to_the_single_host_batch(tmp_path):
    """BatchIterator(host_count=2): the two hosts' rows, joined, equal the
    single-host batch and JAX's host-sharded batches bit for bit, over 3
    batches (crossing an epoch: 4 speakers, batches of 4); a batch that does
    not split raises."""
    from autovc_tpu.data import BatchIterator as JaxBatchIterator, UtteranceDataset as JaxUtteranceDataset

    root = _corpus(tmp_path)
    ds = UtteranceDataset(root, use_native=False)
    jds = JaxUtteranceDataset(root, use_native=False)
    single = BatchIterator(ds, 4, 64, seed=3)
    hosts = [BatchIterator(ds, 4, 64, seed=3, host_index=h, host_count=2) for h in range(2)]
    jax_hosts = [JaxBatchIterator(jds, 4, 64, seed=3, host_index=h, host_count=2) for h in range(2)]
    for _ in range(3):
        x, emb = next(single)
        parts = [next(it) for it in hosts]
        jparts = [next(it) for it in jax_hosts]
        for i, arr in enumerate((x, emb)):
            np.testing.assert_array_equal(np.concatenate([p[i] for p in parts]), arr)
            np.testing.assert_array_equal(np.concatenate([p[i] for p in jparts]), arr)
        assert parts[0][0].shape == (2, 64, 80)
    with pytest.raises(ValueError, match="does not split"):
        BatchIterator(ds, 3, 64, host_count=2)


# ------------------------------------------------------- native loader


def _wav(path, n, seed, channels=1):
    from autovc_tpu_torch.dsp import write_wav

    rng = np.random.RandomState(seed)
    if channels == 1:
        write_wav(path, (0.3 * rng.randn(n)).clip(-1, 1).astype(np.float32))
        return
    import wave

    pcm = (rng.randn(n, channels) * 3000).clip(-32768, 32767).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(pcm.tobytes())


def test_native_loader_matches_the_jax_runtime(tmp_path):
    """The port's own copy of loader.cc, built with g++ at first use, against
    autovc_tpu.runtime's library: read_wavs (mono, stereo averaged, a file
    cut short by max_len, a file that is not a WAV), the store's rows, cols
    and views, the pack's crops and zero padding past an utterance's end,
    bit for bit; UtteranceDataset(use_native=None) picks it."""
    from autovc_tpu import runtime as jax_runtime
    from autovc_tpu_torch import runtime

    if not (runtime.native_available() and jax_runtime.native_available()):
        pytest.skip("no g++ here to build either native runtime")
    wavs = []
    for i, (n, ch) in enumerate(((8000, 1), (12345, 2), (30000, 1))):
        wavs.append(str(tmp_path / f"w{i}.wav"))
        _wav(wavs[-1], n, i, ch)
    (tmp_path / "bad.wav").write_bytes(b"not a wave file at all" * 3)
    paths = wavs + [str(tmp_path / "bad.wav")]
    got = runtime.read_wavs(paths, max_len=20000, threads=3)
    want = jax_runtime.read_wavs(paths, max_len=20000, threads=3)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert got[2] == 3 and list(got[1]) == [8000, 12345, 30000, 0]

    root = _corpus(tmp_path / "feats")
    files = sorted(os.path.join(root, f"p{s}", f"u{u}.npy") for s in range(4) for u in range(3))
    store, jstore = runtime.FeatureStore(), jax_runtime.FeatureStore()
    ids, jids = store.load_npy_batch(files), jstore.load_npy_batch(files)
    np.testing.assert_array_equal(ids, jids)
    for i, f in enumerate(files):
        np.testing.assert_array_equal(store.view(int(ids[i])), np.load(f))
        assert (store.rows(int(ids[i])), store.cols(int(ids[i]))) == (jstore.rows(int(ids[i])), 80)
    rng = np.random.default_rng(0)
    sel = rng.integers(0, len(files), size=6)
    offs = np.array([rng.integers(0, store.rows(int(ids[s]))) for s in sel])  # some crops run past the end
    batch = store.pack(ids[sel], offs, len_crop=64, threads=3)
    np.testing.assert_array_equal(batch, jstore.pack(jids[sel], offs, len_crop=64, threads=3))
    assert any(store.rows(int(ids[s])) - o < 64 for s, o in zip(sel, offs))
    for row, s, o in zip(batch, sel, offs):
        avail = min(64, store.rows(int(ids[s])) - o)
        np.testing.assert_array_equal(row[:avail], np.load(files[s])[o : o + avail])
        assert not row[avail:].any()
    assert store.load_npy_batch([str(tmp_path / "bad.wav")])[0] == -1
    ds = UtteranceDataset(root)
    assert hasattr(ds, "_store") and not ds.features[0][0].flags.writeable
    plain = UtteranceDataset(root, use_native=False)
    for a, b in zip(BatchIterator(ds, 4, 64, seed=1).__next__(), BatchIterator(plain, 4, 64, seed=1).__next__()):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------- cli.convert --seq_devices


@pytest.mark.parametrize("model_type", ["spmel", "stft"])
def test_convert_cli_seq_devices_matches_one_device(tmp_path, monkeypatch, model_type):
    """``cli.convert --seq_devices 2`` (two ranks the CLI starts, gloo on the
    CPU, each utterance padded to a multiple of 2 * freq and split in two
    time blocks) against the same CLI without it: the same ids, the mels
    within 2e-3; stft projected onto the mel bands as without it. Every
    utterance of the tree (100-128 frames) pads to 128 frames both ways:
    where the two paddings differ the padded frames' context moves the
    result (JAX's two paths alike)."""
    from test_torch_convert_cli import _artifact, _tree, narrow_config

    from autovc_tpu_torch.cli import convert as convert_cli

    monkeypatch.setattr(convert_cli, "ModelConfig", narrow_config)
    _tree(tmp_path)
    art = _artifact(tmp_path / f"{model_type}.npz", model_type)
    args = ["--main_dir", str(tmp_path), "--artifact", art, "--model_type", model_type, "--device", "cpu"]
    want = convert_cli.main(args + ["--out", str(tmp_path / "one.pkl")])
    got = convert_cli.main(args + ["--out", str(tmp_path / "two.pkl"), "--seq_devices", "2"])
    assert [n for n, _ in got] == [n for n, _ in want] and len(got) == 2
    specs = load_conversion_metadata(str(tmp_path / model_type / "metadata.pkl"))
    assert all(-(-s.src_features.shape[0] // 32) == 2 * -(-s.src_features.shape[0] // 64) for s in specs)
    for (_, g), (_, w) in zip(got, want):
        assert g.shape == w.shape and g.shape[-1] == 80
        np.testing.assert_allclose(g, w, atol=2e-3, rtol=0)


def test_convert_cli_seq_devices_matches_jax_where_paddings_differ(tmp_path, monkeypatch):
    """``cli.convert --seq_devices 2`` (two gloo ranks) against JAX's
    ``autovc_tpu.cli.convert --seq_devices 2`` (two of conftest's virtual
    CPU devices) on one narrow artifact, with the first conversion's source
    cut to 90 frames, which pads to 128 frames for two blocks (2 * freq) and
    to 96 for one: the same ids and each mel within 1e-4 of JAX's. The two
    CLIs without --seq_devices part there by the padded frames' context
    (both packages alike), which the same rule must show."""
    import autovc_tpu.cli.convert as jax_convert_cli
    from autovc_tpu.config import ModelConfig as JaxModelConfig
    from test_torch_convert_cli import NARROW, _artifact, _tree, jax_narrow, narrow_config

    import autovc_tpu.models as jax_models
    from autovc_tpu_torch.cli import convert as convert_cli
    from autovc_tpu_torch.data import load_results, save_conversion_metadata

    monkeypatch.setattr(convert_cli, "ModelConfig", narrow_config)
    monkeypatch.setattr(jax_convert_cli, "ModelConfig", lambda **kw: JaxModelConfig(**NARROW, **kw))
    monkeypatch.setattr(jax_convert_cli, "build_generator", jax_narrow)
    monkeypatch.setattr(jax_models, "build_generator", jax_narrow)
    _tree(tmp_path)
    meta = str(tmp_path / "spmel" / "metadata.pkl")
    specs = load_conversion_metadata(meta)
    specs[0].src_features = specs[0].src_features[:90]
    save_conversion_metadata(meta, specs)
    art = _artifact(tmp_path / "spmel.npz", "spmel")
    args = ["--main_dir", str(tmp_path), "--artifact", art, "--model_type", "spmel"]
    got = convert_cli.main(args + ["--device", "cpu", "--out", str(tmp_path / "port.pkl"), "--seq_devices", "2"])
    jax_convert_cli.main(args + ["--out", str(tmp_path / "jax.pkl"), "--seq_devices", "2"])
    want = load_results(str(tmp_path / "jax.pkl"))
    assert [n for n, _ in got] == [n for n, _ in want] and len(got) == 2
    assert -(-90 // 32) * 32 != -(-90 // 64) * 64
    apart = [float(np.abs(g - np.asarray(w, np.float32)).max()) for (_, g), (_, w) in zip(got, want)]
    print(f"cli.convert --seq_devices 2, port against JAX: {apart}")
    for (name, g), (_, w) in zip(got, want):
        assert g.shape == np.asarray(w).shape and g.shape[0] in (90, specs[1].src_features.shape[0]), name
    assert max(apart) <= 1e-4, apart
    one = convert_cli.main(args + ["--device", "cpu", "--out", str(tmp_path / "one.pkl")])
    alone = float(np.abs(one[0][1] - got[0][1]).max())
    print(f"the same utterance without --seq_devices (96 frames padded, not 128): {alone}")
    assert alone > 1e-4  # the 32 padded frames' context differs
