"""The port's GE2E speaker-encoder training against the JAX package on the
CPU: the softmax GE2E loss and its gradient, the batch sampler bit for
bit, two ``GE2ETrainer`` steps from the JAX trainer's parameters with and
without the cross-entropy head (a d-vector at dim_cell 32), the
checkpoints both ways, and ``cli.train_speaker_encoder`` on a tiny tree.
The d-vector's LSTM kernels with dW at the published widths are held to
their plain versions on a card (tests/test_torch_gpu.py)."""

import functools
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from autovc_tpu.train import ge2e as jax_ge2e
from autovc_tpu.vocoder.wavenet import flatten_params as jax_flatten
from autovc_tpu_torch.io import dvector_state_to_jax, flatten_params
from autovc_tpu_torch.models import build_dvector
from autovc_tpu_torch.train import ge2e

from test_torch_vocoder_train import adam_moments, float64_steps, held_share, moment_rule, param_rule, step_gradients

torch.set_num_threads(1)

LOSS_RTOL = 1e-5
LEAF_TOL = 1e-4  # of a leaf's scale (its largest magnitude)
CELL, EMB = 32, 16


def _embeds(seed, n=4, m=5, d=EMB):
    e = np.random.RandomState(seed).randn(n, m, d).astype(np.float32)
    return e / np.linalg.norm(e, axis=-1, keepdims=True)


@pytest.mark.parametrize("w, b", [(10.0, -5.0), (3.0, 1.5)])
def test_ge2e_loss_matches_jax(w, b):
    """``ge2e_softmax_loss`` and its gradients in the embeddings, w and b
    against JAX's: the loss to LOSS_RTOL, the gradients within 1e-5 of
    their peak."""
    e = _embeds(int(w))
    want, (ge, gw, gb) = jax.value_and_grad(jax_ge2e.ge2e_softmax_loss, argnums=(0, 1, 2))(
        jnp.asarray(e), jnp.asarray(w, jnp.float32), jnp.asarray(b, jnp.float32))
    te = torch.from_numpy(e).requires_grad_()
    tw, tb = (torch.tensor(v).requires_grad_() for v in (w, b))
    got = ge2e.ge2e_softmax_loss(te, tw, tb)
    got.backward()
    assert float(got.detach()) == pytest.approx(float(want), rel=LOSS_RTOL)
    ge = np.asarray(ge)
    np.testing.assert_allclose(te.grad.numpy(), ge, atol=1e-5 * np.abs(ge).max(), rtol=0)
    assert float(tw.grad) == pytest.approx(float(gw), rel=1e-4, abs=1e-7)
    assert float(tb.grad) == pytest.approx(float(gb), rel=1e-4, abs=1e-7)


def _features(seed=0, speakers=4, utts=3, bins=80):
    """Per-speaker utterances of 10-40 frames (some shorter than a crop)."""
    rng = np.random.RandomState(seed)
    return [[rng.rand(int(rng.randint(10, 40)), bins).astype(np.float32) for _ in range(utts)]
            for _ in range(speakers)]


@pytest.mark.parametrize("labels", [False, True])
def test_sample_ge2e_batch_matches_jax_bit_for_bit(labels):
    features = _features()
    got = ge2e.sample_ge2e_batch(features, 3, 4, 24, np.random.default_rng(5), return_labels=labels)
    want = jax_ge2e.sample_ge2e_batch(features, 3, 4, 24, np.random.default_rng(5), return_labels=labels)
    for a, b in zip(got if labels else (got,), want if labels else (want,)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def _leaf_distances(got: dict, want: dict) -> dict:
    """Each leaf's largest distance over its scale (its largest magnitude),
    of two parameter trees."""
    flat_g, flat_w = flatten_params(got), flatten_params(want)
    assert flat_g.keys() == flat_w.keys()
    return {k: float(np.abs(np.asarray(flat_g[k], np.float64) - np.asarray(flat_w[k], np.float64)).max())
            / max(float(np.abs(flat_w[k]).max()), 1e-30) for k in flat_w}


# The global-norm clip of the trainer tests: the gradients' norms are 0.60
# then 0.09 without the CE head and 2.08 then 0.67 with it, so the clip
# engages on the first step, and on both with the head.
CLIP = 0.5
# ``param_rule``'s near-zero share for the d-vector, whose float32 gradients
# (no FFT) round far less than HiFi-GAN's: every element held at 1e-2 (0.41
# and 0.39 of them, without and with the head); at 3e-3 an element of
# w_ih_l0 lies 2.1e-4 of its scale away without the head.
NEAR_ZERO = 1e-2


@functools.lru_cache(maxsize=None)
def _ge2e_reference(n_classes: int):
    """The JAX trainer (dim_cell 32, lr 1e-2, ``wb_grad_scale`` 0.5, the
    global-norm clip at CLIP, the CE head with ``n_classes``) and two batches of N=3 speakers x M=2 crops
    of 24 frames: (its parameters before, the batches, its float32 losses,
    its float64 parameters and Adam moments after the two steps, each
    step's gradients)."""
    jt = jax_ge2e.GE2ETrainer(dim_cell=CELL, dim_emb=EMB, lr=1e-2, grad_clip=CLIP, seed=0, wb_grad_scale=0.5,
                              n_classes=n_classes)
    tree = jax.tree_util.tree_map(np.asarray, jt.params)
    features, rng = _features(1, speakers=4), np.random.default_rng(2)
    batches = [ge2e.sample_ge2e_batch(features, 3, 2, 24, rng, return_labels=True) for _ in range(2)]
    states, _ = float64_steps(jt._step, (jt.params, jt.opt_state), batches)
    losses = []
    for batch, labels in batches:
        jt.params, jt.opt_state, jloss = jt._step(jt.params, jt.opt_state, jnp.asarray(batch), jnp.asarray(labels))
        losses.append(float(jloss))
    moments = [adam_moments(opt) for _, opt in states]
    return tree, batches, losses, jax_flatten(states[-1][0]), moments[-1], step_gradients(moments, 0.9)


def _port_ge2e(n_classes: int, plant=None):
    """The port's trainer from the JAX trainer's parameters after the same
    two steps, its attributes or optimizer's hyperparameters replaced by
    ``plant``: (losses, parameters, Adam moments), by JAX's flat names."""
    tree, batches = _ge2e_reference(n_classes)[:2]
    pt = ge2e.GE2ETrainer(dim_cell=CELL, dim_emb=EMB, lr=1e-2, grad_clip=CLIP, seed=0, wb_grad_scale=0.5,
                          n_classes=n_classes, device="cpu")
    pt.load_tree(tree)
    for k, v in (plant or {}).items():
        if k in pt.optimizer.param_groups[0]:
            pt.optimizer.param_groups[0][k] = v
        else:
            setattr(pt, k, v)
    losses = [float(pt.step(batch, labels if n_classes else None)) for batch, labels in batches]

    def named(key):
        state = pt.optimizer.state
        moment = {"dvector": dvector_state_to_jax({n: state[p][key] for n, p in pt.model.named_parameters()}),
                  "w": state[pt.w][key].numpy(), "b": state[pt.b][key].numpy()}
        if pt.cls:
            moment["cls"] = {k: state[p][key].numpy() for k, p in pt.cls.items()}
        return {f"{m}/{k}": v for m in (key,) for k, v in flatten_params(moment).items()}

    moments = {k.replace("exp_avg_sq/", "nu/").replace("exp_avg/", "mu/"): v
               for key in ("exp_avg", "exp_avg_sq") for k, v in named(key).items()}
    return losses, flatten_params(pt.params), moments


@pytest.mark.parametrize("n_classes", [0, 4])
def test_ge2e_trainer_two_steps_match_jax(n_classes):
    """Two steps of the port's trainer (dim_cell 32; N=3 speakers x M=2
    crops of 24 frames) from the JAX trainer's parameters, with and without
    the cross-entropy head (the global-norm clip at CLIP engaged, w held at
    1e-2 or more after the update, ``wb_grad_scale`` 0.5): the losses to
    LOSS_RTOL of JAX's; the parameters by ``param_rule`` and Adam's moments
    by ``moment_rule`` against JAX's own float64 steps
    (tests/test_torch_vocoder_train.py)."""
    _, _, want_losses, exact, exact_moments, grads = _ge2e_reference(n_classes)
    losses, params, moments = _port_ge2e(n_classes)
    assert losses == pytest.approx(want_losses, rel=LOSS_RTOL)
    print(f"held {held_share(exact, grads, NEAR_ZERO):.3f} of the elements")
    assert param_rule(params, exact, grads, NEAR_ZERO) == []
    assert moment_rule(moments, exact_moments) == []


@pytest.mark.parametrize("plant", [{"betas": (0.9, 0.99)}, {"grad_clip": 5.0}, {"wb_grad_scale": 1.0}],
                         ids=["b2", "clip", "wb-scale"])
def test_ge2e_trainer_rules_refuse_a_planted_fault(plant):
    """The controls: the port's Adam with b2 0.99, its global-norm clip at
    5 (above the gradients' norms) or its (w, b) gradients unscaled fails
    the float64 rules."""
    _, _, _, exact, exact_moments, grads = _ge2e_reference(4)
    _, params, moments = _port_ge2e(4, plant)
    assert param_rule(params, exact, grads, NEAR_ZERO) + moment_rule(moments, exact_moments) != []


def test_ge2e_trainer_holds_w_above_its_floor():
    """w is clamped to 1e-2 after an update that would take it below (Adam's
    first step at lr 1 moves w by 1 against its gradient's sign)."""
    pt = ge2e.GE2ETrainer(dim_cell=CELL, dim_emb=EMB, lr=1.0, seed=0, device="cpu")
    batch = torch.from_numpy(ge2e.sample_ge2e_batch(_features(3), 3, 2, 24, np.random.default_rng(0)))
    pt.loss(batch).backward()
    sign = float(torch.sign(pt.w.grad))
    with torch.no_grad():
        pt.w.fill_(0.011 if sign > 0 else -0.5)  # the step takes it to about -0.989, or to 0.5
    pt.step(batch)
    assert float(pt.w.detach()) == (np.float32(1e-2) if sign > 0 else pytest.approx(0.5, abs=1e-3))


def test_ge2e_checkpoints_load_both_ways(tmp_path):
    """The port's ``save`` (no ``cls``) loads in the JAX trainer's
    ``load_params`` and in the port's ``build_dvector``, leaf for leaf; the
    JAX trainer's ``save`` loads in the port's ``load_params`` and trainer."""
    pt = ge2e.GE2ETrainer(dim_cell=CELL, dim_emb=EMB, seed=4, n_classes=3, device="cpu")
    path = str(tmp_path / "port.npz")
    pt.save(path)
    tree = jax_ge2e.GE2ETrainer.load_params(path)
    assert set(tree) == {"dvector", "w", "b"}
    want = {k: v for k, v in pt.params.items() if k != "cls"}
    assert max(_leaf_distances(want, tree).values()) == 0.0
    dvec = build_dvector(ge2e.load_params(path), device="cpu")
    x = torch.from_numpy(np.random.RandomState(0).rand(2, 20, 80).astype(np.float32))
    with torch.no_grad():
        torch.testing.assert_close(dvec(x), pt.model.eval()(x), atol=0, rtol=0)
    jt = jax_ge2e.GE2ETrainer(dim_cell=CELL, dim_emb=EMB, seed=5)
    jpath = str(tmp_path / "jax.npz")
    jt.save(jpath)
    back = ge2e.GE2ETrainer(dim_cell=CELL, dim_emb=EMB, device="cpu")
    back.load_tree(ge2e.load_params(jpath))
    assert max(_leaf_distances(back.params, jax.tree_util.tree_map(np.asarray, jt.params)).values()) == 0.0


def _tree(root, speakers=3, utts=4, seed=6, manifest=False):
    """<root>/spmel/<spk>/<utt>.npy (and, with ``manifest``, a train.pkl)."""
    from autovc_tpu_torch.data import SpeakerEntry, save_train_manifest

    rng = np.random.RandomState(seed)
    entries = []
    for s in range(speakers):
        spk = f"p{225 + s}"
        os.makedirs(os.path.join(root, "spmel", spk))
        rels = []
        for u in range(utts):
            rel = os.path.join(spk, f"{spk}_{u:03d}.npy")
            np.save(os.path.join(root, "spmel", rel), rng.rand(int(rng.randint(20, 40)), 80).astype(np.float32))
            rels.append(rel)
        entries.append(SpeakerEntry(spk, np.zeros(EMB, np.float32), rels))
    if manifest:
        save_train_manifest(os.path.join(root, "spmel", "train.pkl"), entries)


@pytest.mark.parametrize("manifest", [False, True])
def test_train_speaker_encoder_cli(tmp_path, monkeypatch, manifest):
    """``cli.train_speaker_encoder`` (2 steps, dim_cell 32) with and without
    a train.pkl: every speaker a batch at ``--n_speakers 0``, the holdout
    applied, the CE head on at ``--ce_weight``; the batches drawn are the
    JAX CLI's, and its checkpoint loads in ``autovc_tpu`` and in the port,
    with the JAX CLI's keys and shapes."""
    from autovc_tpu.cli import train_speaker_encoder as jax_cli
    from autovc_tpu_torch.cli import train_speaker_encoder as cli

    _tree(tmp_path, manifest=manifest)
    drawn = {"port": [], "jax": []}
    for mod, key in ((ge2e, "port"), (jax_ge2e, "jax")):
        real = mod.sample_ge2e_batch

        def record(*a, _real=real, _key=key, **kw):
            out = _real(*a, **kw)
            drawn[_key].append(out)
            return out

        monkeypatch.setattr(mod, "sample_ge2e_batch", record)
    args = ["--main_dir", str(tmp_path), "--num_iters", "2", "--m_utts", "2", "--len_crop", "24", "--dim_cell",
            str(CELL), "--dim_emb", str(EMB), "--holdout", "1", "--ce_weight", "0.5", "--log_step", "1"]
    trainer = cli.main([*args, "--out", str(tmp_path / "port.npz"), "--device", "cpu"])
    jax_cli.main([*args, "--out", str(tmp_path / "jax.npz")])
    assert trainer.n_classes == 3 and len(drawn["port"]) == len(drawn["jax"]) == 2
    for (pb, pl), (jb, jl) in zip(drawn["port"], drawn["jax"]):
        assert pb.shape == (3, 2, 24, 80) and np.array_equal(pb, jb) and np.array_equal(pl, jl)
    port, want = (jax_ge2e.GE2ETrainer.load_params(str(tmp_path / f"{n}.npz")) for n in ("port", "jax"))
    flat_p, flat_w = jax_flatten(port), jax_flatten(want)
    assert {k: v.shape for k, v in flat_p.items()} == {k: v.shape for k, v in flat_w.items()}
    build_dvector(ge2e.load_params(str(tmp_path / "port.npz")), device="cpu")
