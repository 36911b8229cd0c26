"""Data and tensor parallelism of the port's training on the CPU: a 2-rank
step's gradient against JAX's single-device step on the same global batch
(with and without lambda_spk; BatchNorm with local statistics planted as
the fault the gate must catch), the Solver at DP 2, TP 2 and 2 x 2 against
the port's single process (the first two steps' metrics and the first
gradient, as ``train.compare.history_gap`` and ``moment_gap`` hold them,
then the state after 3 steps; local gradients and a stale tensor-parallel
slice planted as the faults that gate must catch), and ``cli.train
--multihost`` as 2 OS processes against one.

The worlds are gloo worlds of spawned processes (``parallel.launch
.run_world``, a ``file://`` store, one thread a rank); the CLI runs are
subprocesses joined through a TCP store on localhost. The ranks import this
module by name to find their work, so it imports JAX only inside the tests.
"""

import copy
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from autovc_tpu_torch.config import Config, ModelConfig, TrainConfig
from autovc_tpu_torch.data import BatchIterator, SpeakerEntry, UtteranceDataset, save_train_manifest
from autovc_tpu_torch.io import load_artifact, flatten_params
from autovc_tpu_torch.models import build_dvector, build_generator
from autovc_tpu_torch.parallel import mesh as pmesh
from autovc_tpu_torch.parallel.launch import run_world
from autovc_tpu_torch.train import Solver
from autovc_tpu_torch.train.metrics import read_metrics
from autovc_tpu_torch.train.compare import KinkTape, grad_scale, history_gap, moment_gap
from autovc_tpu_torch.train.step import SpeakerAux, backward

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NARROW = dict(dim_neck=8, dim_emb=16, dim_pre=32, freq=8)
WIDTHS = dict(enc_channels=32, dec_lstm_dim=64, postnet_channels=32)
MODEL = ModelConfig(**NARROW, **WIDTHS)
GRAD_TOL = 1e-4  # of each leaf's grad_scale (ROADMAP's rule for two float32 engines' gradients)
PARAM_TOL = 1e-3  # tests/test_train.py's ceiling of a parallel run's parameters after 3 steps
# compare.history_gap's ceiling (relative; sound runs here read <= 6e-7, a
# stale tensor-parallel slice >= 3e-4, local gradients 0.6 at grad_norm@1)
STEP_TOL = 1e-5
# tests/test_multihost.py's ceilings of the exported trees
MH_PARAMS_TOL, MH_STATS_TOL = 1e-3, 2e-2


# ------------------------------------------------------------ rank work


def _rank_tape(tape: KinkTape, rank: int, n: int) -> KinkTape:
    """This rank's rows of every side a single-process step recorded (each
    kinked tensor's leading axis is the batch's)."""
    mine = KinkTape()
    mine.sides = [(kind, side.chunk(n, 0)[rank]) for kind, side in tape.sides]
    return mine


def _grad_world(dev, case: dict) -> dict:
    """One 2-rank data-parallel loss and backward (``train.step.backward``)
    on this rank's rows, the single-process step's kinks replayed; each
    setting of ``case['runs']``: (label, global statistics or local,
    lambda_spk on or off)."""
    mesh = pmesh.make_mesh(2, 1, dev)
    rank = mesh.index("data")
    out = {}
    for label, sync, spk_on in case["runs"]:
        model = build_generator(case["cfg"].model, device="cpu", trainable=True)
        model.load_state_dict(case["state"])
        pmesh.sync_batch_norm(model, mesh if sync else None)
        cfg, spk = case["cfg"], None
        if spk_on:
            cfg = case["spk_cfg"]
            spk = SpeakerAux(build_dvector(case["dvec"], device="cpu"), torch.from_numpy(case["table"]),
                             torch.from_numpy(case["cents"]))
        x, emb = (pmesh.batch_split(torch.from_numpy(a), mesh) for a in (case["x"], case["emb"]))
        with _rank_tape(case["tapes"][spk_on], rank, 2).replay():
            metrics = backward(model, cfg, x, emb, spk, mesh)
        out[label] = ({n: p.grad.numpy().copy() for n, p in model.named_parameters()},
                      {n: b.numpy().copy() for n, b in model.named_buffers()},
                      {k: float(v) for k, v in metrics.items()})
    return out


def _plant(fault: str | None) -> None:
    """A fault planted in this rank's train step: 'local_grads' keeps each
    rank's own gradient where the all-reduce over 'data' gave the average
    (the metrics are still averaged); 'stale_slice' has 'model' rank 1 keep
    its slice of every sharded parameter from before the update."""
    from autovc_tpu_torch.train import step as step_mod

    if fault == "local_grads":
        step_mod._unflatten_dense_tensors = lambda flat, grads: grads
    elif fault == "stale_slice":
        gather, shard, kept = step_mod.gather_params, step_mod.shard_params, {}

        def gather_params(model, shards, mesh, axis="model"):
            kept.update({n: p.detach().clone() for n, p in model.named_parameters()})
            gather(model, shards, mesh, axis)

        def shard_params(model, shards, mesh, axis="model"):
            shard(model, shards, mesh, axis)
            if mesh.index(axis) == 1:
                for n, p in model.named_parameters():
                    if shards[n] is not None:
                        p.data.copy_(kept[n])

        step_mod.gather_params, step_mod.shard_params = gather_params, shard_params


def _first_step(solver: Solver) -> dict:
    """Run the Solver's first step (no prefetcher: it takes no batch ahead)
    -> Adam's state after it, whose moments are the first gradient."""
    solver.train(1, prefetch=0)
    return copy.deepcopy(solver.state.optimizer.state_dict())


def _solver_world(dev, cfg: Config, mel_dir: str, run_dir: str, fault: str | None = None) -> dict:
    """3 Solver steps on this rank's rows of the global batch (``fault``:
    see ``_plant``); the gathered state, each step's metrics, Adam's
    moments, each parameter's shape on this rank between steps, and whether
    a second Solver restores the checkpoint rank 0 wrote."""
    _plant(fault)
    tc = cfg.train
    rank = torch.distributed.get_rank()
    it = BatchIterator(UtteranceDataset(mel_dir), tc.batch_size, tc.len_crop, seed=tc.seed,
                       host_index=rank // tc.model_parallel, host_count=tc.data_parallel)
    solver = Solver(cfg, it, run_dir=run_dir, device=dev)
    first = _first_step(solver)
    solver.train()
    shapes = {n: tuple(p.shape) for n, p in solver.state.model.named_parameters()}
    ema_shapes = {n: tuple(v.shape) for n, v in solver.state.ema_params.items()}
    # a slice that is a view keeps the whole leaf's storage: no memory saved
    own_storage = all(t.untyped_storage().nbytes() == t.numel() * t.element_size()
                      for t in [*solver.state.model.parameters(), *solver.state.ema_params.values()])
    state = {k: v.numpy().copy() for k, v in solver.model_state().items()}
    opt = solver.state.optimizer.state_dict()
    again = Solver(cfg, it, run_dir=run_dir, device=dev)  # restores step 3 on every rank
    restored = again.state.step == 3 and all(np.array_equal(v.numpy(), state[k])
                                             for k, v in again.model_state().items())
    return {"state": state, "shapes": shapes, "ema_shapes": ema_shapes, "own_storage": own_storage,
            "restored": restored,
            "history": solver.history, "opt": opt, "first": first}


# ------------------------------------------------------------- the step


@pytest.fixture(scope="module")
def grad_case():
    """A narrow generator from JAX's init, a global batch of 4, the
    single-process port step's kinks (plain and with lambda_spk), and JAX's
    single-device loss, gradients and statistics on that batch."""
    import jax
    import jax.numpy as jnp

    from test_torch_speaker import _narrow_pair, _unit_rows
    from test_torch_train import NarrowGenerator, _jax_cfg

    from autovc_tpu.config import Config as JaxConfig, ModelConfig as JaxModelConfig, TrainConfig as JaxTrainConfig
    from autovc_tpu.train import step as jax_step
    from autovc_tpu_torch.io import dvector_state_to_jax, generator_state_from_jax
    from autovc_tpu_torch.train import loss_fn

    rng = np.random.RandomState(4)
    x = rng.rand(4, 136, 80).astype(np.float32)  # 136 frames: two d-vector windows, the second the tail
    emb = rng.randn(4, NARROW["dim_emb"]).astype(np.float32)
    jmodel = NarrowGenerator(**NARROW)
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(emb), jnp.asarray(emb))
    params, stats = variables["params"], variables["batch_stats"]
    state = generator_state_from_jax({"params": params, "batch_stats": stats})
    cfg = Config(model=MODEL)
    spk_train = dict(lambda_spk=0.7, spk_protocol="windowed", spk_margin=1.5)
    spk_cfg = Config(model=MODEL, train=TrainConfig(**spk_train))
    port_dvec, jdvec, jdparams = _narrow_pair(2)
    table = emb / np.linalg.norm(emb, axis=-1, keepdims=True)
    cents = _unit_rows(4, 16, seed=11)
    jaux = jax_step.SpeakerAux(jdvec, jdparams, jnp.asarray(table), jnp.asarray(cents))
    spk = SpeakerAux(port_dvec, torch.from_numpy(table), torch.from_numpy(cents))
    jcfgs = {False: _jax_cfg(), True: JaxConfig(model=JaxModelConfig(model_type="spmel", **NARROW),
                                                train=JaxTrainConfig(spk_ckpt="unused-here", **spk_train))}
    tapes, want = {}, {}
    for spk_on in (False, True):
        (jtotal, (jm, jstats)), jgrads = jax.jit(jax.value_and_grad(
            lambda p: jax_step.loss_fn(jmodel, jcfgs[spk_on], p, stats, jnp.asarray(x), jnp.asarray(emb),
                                       spk=jaux if spk_on else None), has_aux=True))(params)
        want[spk_on] = (generator_state_from_jax({"params": jgrads, "batch_stats": jstats}),
                        {k: float(v) for k, v in jm.items()})
        model = build_generator(MODEL, device="cpu", trainable=True)
        model.load_state_dict(state)
        tapes[spk_on] = KinkTape()
        with tapes[spk_on].record():
            total, _ = loss_fn(model, spk_cfg if spk_on else cfg, torch.from_numpy(x), torch.from_numpy(emb),
                               spk=spk if spk_on else None)
            total.backward()
    case = dict(cfg=cfg, spk_cfg=spk_cfg, state=state, x=x, emb=emb, tapes=tapes,
                dvec=dvector_state_to_jax(port_dvec.state_dict()), table=table, cents=cents,
                runs=[("sync", True, False), ("local", False, False), ("sync_spk", True, True)])
    return want, run_world(_grad_world, 2, case, device="cpu", threads=1)


def _worst(grads: dict, want: dict) -> tuple[float, str]:
    """The largest distance of a leaf from JAX's in units of its grad_scale."""
    return max((float(np.abs(g - want[n].numpy()).max()) / grad_scale(n, want), n) for n, g in grads.items())


@pytest.mark.parametrize("label", ["sync", "sync_spk"])
def test_two_rank_gradient_matches_jax_single_device(grad_case, label):
    """Each rank's gradient (averaged over 'data' by ``backward``), before
    the update, against ``jax.value_and_grad`` of the JAX loss on the whole
    batch on one device: every leaf within 1e-4 of its grad_scale, the
    metrics within 1e-5 relative (the windowed margin 1e-5 absolute), the
    running statistics (moved by the global batch's statistics) within
    1e-5. With lambda_spk the cross-pairs roll over the global batch: row 2
    (rank 1's first) converts toward row 1 (rank 0's last)."""
    want, got = grad_case
    wgrads, wmetrics = want[label == "sync_spk"]
    for rank in got:
        grads, bufs, metrics = rank[label]
        worst, name = _worst(grads, wgrads)
        assert worst <= GRAD_TOL, (worst, name)
        for n, b in bufs.items():
            np.testing.assert_allclose(b, wgrads[n].numpy(), atol=1e-5, rtol=0, err_msg=n)
        assert sorted(metrics) == sorted(wmetrics)
        for k, v in wmetrics.items():
            tol = dict(abs=1e-5, rel=0) if k == "g_spk_margin" else dict(rel=1e-5)
            assert metrics[k] == pytest.approx(v, **tol), k
    np.testing.assert_array_equal(got[0][label][0]["decoder.proj.weight"], got[1][label][0]["decoder.proj.weight"])


def test_local_batchnorm_statistics_fail_the_gate(grad_case):
    """The planted fault: the same 2-rank step with each rank's BatchNorm on
    its own rows' statistics (no ``sync_batch_norm``) is farther from JAX's
    gradient than the gate allows, and its running statistics differ."""
    want, got = grad_case
    grads, bufs, _ = got[0]["local"]
    worst, _ = _worst(grads, want[False][0])
    assert worst > 100 * GRAD_TOL, worst
    assert max(float(np.abs(b - want[False][0][n].numpy()).max()) for n, b in bufs.items()) > 1e-3


# -------------------------------------------------------------- Solver


def _corpus(root, speakers=4, utts=3, seed=0) -> str:
    rng = np.random.RandomState(seed)
    mel_dir = os.path.join(str(root), "spmel")
    entries = []
    for s in range(speakers):
        os.makedirs(os.path.join(mel_dir, f"p{s}"), exist_ok=True)
        paths = []
        for u in range(utts):
            frames = int(rng.randint(40, 120))
            np.save(os.path.join(mel_dir, f"p{s}", f"u{u}.npy"), rng.rand(frames, 80).astype(np.float32))
            paths.append(f"p{s}/u{u}.npy")
        entries.append(SpeakerEntry(f"p{s}", rng.randn(NARROW["dim_emb"]).astype(np.float32), paths))
    save_train_manifest(os.path.join(mel_dir, "train.pkl"), entries)
    return mel_dir


def _cfg(root, data=1, model=1) -> Config:
    return Config(model=MODEL, train=TrainConfig(batch_size=4, len_crop=32, num_iters=3, log_step=1,
                                                 checkpoint_step=3, data_parallel=data, model_parallel=model),
                  main_dir=str(root), run_name="r")


@pytest.fixture(scope="module")
def single_process(tmp_path_factory):
    """The port's Solver in this process: 3 steps of the global batch of 4."""
    root = tmp_path_factory.mktemp("single")
    mel_dir = _corpus(root)
    solver = Solver(_cfg(root), BatchIterator(UtteranceDataset(mel_dir), 4, 32, seed=0),
                    run_dir=str(root / "run"), device="cpu")
    first = _first_step(solver)
    solver.train()
    return mel_dir, {"state": {k: v.numpy().copy() for k, v in solver.model_state().items()},
                     "history": solver.history, "opt": solver.state.optimizer.state_dict(),
                     "names": [n for n, _ in solver.state.model.named_parameters()], "first": first}


def _gate(rank: dict, want: dict) -> dict:
    """A parallel rank's distances from the single process: the first step's
    metrics and the second's loss terms (``compare.history_gap``, relative),
    Adam's moments after the first step (``compare.moment_gap``, of each
    leaf's scale), and the state after 3 steps (max abs: parameters, running
    statistics)."""
    names = set(want["names"])
    return {"steps": max(history_gap(rank["history"], want["history"], step) for step in (1, 2)),
            "moments": moment_gap(rank["first"], want["first"], want["names"]),
            "params": max(float(np.abs(v - want["state"][k]).max()) for k, v in rank["state"].items() if k in names),
            "stats": max(float(np.abs(v - want["state"][k]).max()) for k, v in rank["state"].items()
                         if k not in names)}


def _passes(gap: dict) -> bool:
    return (gap["steps"][0] < STEP_TOL and gap["moments"][0] < GRAD_TOL and gap["params"] < PARAM_TOL
            and gap["stats"] < MH_STATS_TOL)


@pytest.mark.parametrize("data, model", [(2, 1), (1, 2), (2, 2)])
def test_solver_parallel_matches_single_process(tmp_path, single_process, data, model):
    """DP 2, TP 2 and 2 x 2 worlds against the single process: the first
    step's metrics and the second's loss terms within 1e-5 relative, Adam's
    moments after the first step (the global batch's gradient) within 1e-4
    of each leaf's scale, and after 3 steps every parameter within 1e-3
    (tests/test_train.py's ceiling) and the running statistics within
    2e-2; under TP each rank holds half of every sharded parameter and of
    its EMA along the axis param_shardings gives, and the rest whole, each
    slice in a storage of its own (the memory a TP rank saves); rank 0
    wrote the step-3 checkpoint once, it holds the gathered state, and
    every rank restores it."""
    mel_dir, want = single_process
    run_dir = str(tmp_path / "run")
    got = run_world(_solver_world, data * model, _cfg(tmp_path, data, model), mel_dir, run_dir,
                    device="cpu", threads=1)
    for rank in got:
        assert rank["restored"]
        gap = _gate(rank, want)
        assert _passes(gap), gap
    shards = pmesh.param_shardings(build_generator(MODEL, device="cpu"),
                                   pmesh.Mesh(("data", "model"), (data, model), 0, torch.device("cpu"), None, {}, {}))
    for rank in got:
        assert rank["own_storage"]
        for n, shape in rank["shapes"].items():
            full = list(want["state"][n].shape)
            if shards[n] is not None:
                full[shards[n]] //= model
            assert shape == tuple(full) == rank["ema_shapes"][n], n
    assert (model > 1) == any(a is not None for a in shards.values())
    ckpt = torch.load(os.path.join(run_dir, "checkpoints", "step_000000003.pt"), weights_only=True)
    assert sorted(os.listdir(os.path.join(run_dir, "checkpoints"))) == ["step_000000003.pt"]
    for k, v in {**ckpt["params"], **ckpt["batch_stats"]}.items():
        np.testing.assert_array_equal(v.numpy(), got[0]["state"][k])


@pytest.mark.parametrize("fault, data, model", [("local_grads", 2, 1), ("stale_slice", 1, 2)])
def test_solver_gate_catches_planted_faults(tmp_path, single_process, fault, data, model):
    """The planted faults (``_plant``) fail the gate above on every rank:
    gradients kept local where the all-reduce averaged them (the first
    step's grad_norm and Adam's moments), and a tensor-parallel rank that
    kept its slice from before the update (the second step's loss)."""
    mel_dir, want = single_process
    got = run_world(_solver_world, data * model, _cfg(tmp_path, data, model), mel_dir, str(tmp_path / "run"),
                    fault, device="cpu", threads=1)
    for rank in got:
        gap = _gate(rank, want)
        assert not _passes(gap), gap
        assert gap["steps"][0] > 10 * STEP_TOL, gap
        if fault == "local_grads":
            assert gap["steps"][1] == "grad_norm@1" and gap["moments"][0] > 100 * GRAD_TOL, gap


def test_solver_refuses_a_mesh_that_does_not_span_the_world(tmp_path):
    """As the JAX Solver: data x model must cover every rank, here the one
    process that has no process group."""
    with pytest.raises(ValueError, match="does not span"):
        Solver(_cfg(tmp_path, 2, 1), iter(()), run_dir=str(tmp_path / "r"), device="cpu")


# ------------------------------------------------------ cli.train --multihost


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


# the CLI at the narrow widths: its ModelConfig with the narrow channel counts
_STUB = ("import functools, sys; from autovc_tpu_torch.cli import train; "
         "from autovc_tpu_torch.config import ModelConfig; "
         f"train.ModelConfig = functools.partial(ModelConfig, **{WIDTHS!r}); train.main(sys.argv[1:])")


def _train_cmd(main_dir: str, run_name: str, export: str, *flags: str) -> list[str]:
    return [sys.executable, "-c", _STUB, "--main_dir", main_dir, "--run_name", run_name, "--resume", "--device",
            "cpu", "--dim_neck", "8", "--dim_emb", "16", "--dim_pre", "32", "--freq", "8", "--batch_size", "4",
            "--len_crop", "32", "--num_iters", "3", "--log_step", "1", "--checkpoint_step", "1", "--export",
            export, *flags]


@pytest.mark.parametrize("flags", [[], ["--model_parallel", "2"]])
def test_cli_train_multihost_matches_one_process(tmp_path, flags):
    """``cli.train --multihost`` as 2 OS processes (AUTOVC_COORDINATOR,
    AUTOVC_NUM_PROCESSES, AUTOVC_PROCESS_ID; gloo on the CPU) against one
    process on the same seeded stream: ``data_parallel -> 2`` printed (or,
    at --model_parallel 2, ``data_parallel -> 1``), rank 0's --export within
    tests/test_multihost.py's ceilings of the single process's (params
    1e-3, batch_stats 2e-2); the first two steps' metrics of both ranks
    (their metrics streams) within 1e-5 relative, and Adam's moments in the
    step-1 checkpoint rank 0 wrote within 1e-4 of each leaf's scale, of the
    single process's; both ranks exit 0."""
    _corpus(tmp_path)
    env = dict(os.environ, AUTOVC_COORDINATOR=f"localhost:{_free_port()}", AUTOVC_NUM_PROCESSES="2",
               OMP_NUM_THREADS="1")
    env.pop(pmesh.BACKEND_ENV, None)
    mh, solo = str(tmp_path / "mh.npz"), str(tmp_path / "solo.npz")
    procs = [subprocess.Popen(_train_cmd(str(tmp_path), "mh", mh, "--multihost", *flags), cwd=REPO,
                              env=dict(env, AUTOVC_PROCESS_ID=str(r)), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(2)]
    outs = [p.communicate(timeout=300)[0] for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    assert f"data_parallel -> {1 if flags else 2}" in outs[0], outs[0][-2000:]
    assert "backend gloo (for cpu)" in outs[1]
    one = subprocess.run(_train_cmd(str(tmp_path), "solo", solo), cwd=REPO, env=env,
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, timeout=300)
    assert one.returncode == 0, one.stdout[-3000:]
    got, want = (flatten_params(load_artifact(p)[0]) for p in (mh, solo))
    assert got.keys() == want.keys() and len(got) > 0
    worst_p = max(float(np.abs(got[k] - want[k]).max()) for k in got if k.startswith("params/"))
    worst_s = max(float(np.abs(got[k] - want[k]).max()) for k in got if k.startswith("batch_stats/"))
    assert worst_p < MH_PARAMS_TOL and worst_s < MH_STATS_TOL, (worst_p, worst_s)
    runs = tmp_path / "runs"
    solo_steps = read_metrics(str(runs / "solo" / "metrics_solo.jsonl"))
    for stream in ("metrics_mh.jsonl", "metrics_mh.rank1.jsonl"):
        mh_steps = read_metrics(str(runs / "mh" / stream))
        gap = max(history_gap(mh_steps, solo_steps, step) for step in (1, 2))
        assert gap[0] < STEP_TOL, (stream, gap)
    first = [torch.load(str(runs / r / "checkpoints" / "step_000000001.pt"), weights_only=True) for r in ("mh", "solo")]
    gap = moment_gap(first[0]["opt_state"], first[1]["opt_state"], list(first[1]["params"]))
    assert gap[0] < GRAD_TOL, gap
