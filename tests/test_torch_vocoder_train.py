"""The port's vocoder extras and training against the JAX package on the CPU:
the discretized MoL loss, the WaveNet trainer (noam, crops, Adam, EMA, its
``.npz`` checkpoints and train states), the HiFi-GAN discriminators and
losses, the reconstruction and GAN trainers, the hybrid vocoder, and
``cli.train_vocoder`` and ``cli.evaluate_vocoder`` on a tiny tree. Narrow
networks (a 2-layer WaveNet with R=G=S=16, a 16-channel HiFi-GAN) and the
discriminators at their published widths on B=2, T=2047 (an odd length:
SAME pooling pads 1 and 2)."""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from autovc_tpu.config import AudioConfig as JaxAudioConfig
from autovc_tpu.config import HiFiGANConfig as JaxHiFiGANConfig
from autovc_tpu.config import WaveNetConfig as JaxWaveNetConfig
from autovc_tpu.vocoder import discriminators as jax_disc
from autovc_tpu.vocoder import hybrid as jax_hybrid
from autovc_tpu.vocoder import train_hifigan as jax_hifigan
from autovc_tpu.vocoder import train_wavenet as jax_wavenet
from autovc_tpu.vocoder.hifigan import HiFiGANVocoder as JaxHiFiGANVocoder
from autovc_tpu.vocoder.wavenet import WaveNetVocoder as JaxWaveNetVocoder
from autovc_tpu.vocoder.wavenet import discretized_mol_loss as jax_mol_loss
from autovc_tpu.vocoder.wavenet import flatten_params as jax_flatten
from autovc_tpu.vocoder.wavenet import unflatten_params as jax_unflatten
from autovc_tpu_torch.config import AudioConfig, HiFiGANConfig, WaveNetConfig
from autovc_tpu_torch.dsp import write_wav
from autovc_tpu_torch.io import conv_state_to_jax
from autovc_tpu_torch.train.optax_state import JaxLeaves
from autovc_tpu_torch.vocoder import discriminators as disc
from autovc_tpu_torch.vocoder import train_hifigan, train_wavenet
from autovc_tpu_torch.vocoder.hybrid import refine_with_mel_magnitude
from autovc_tpu_torch.vocoder.wavenet import discretized_mol_loss

torch.set_num_threads(1)

LOSS_RTOL = 1e-5
LEAF_TOL = 1e-4  # of a leaf's scale (its largest magnitude)
WN = dict(layers=2, stacks=1, residual_channels=16, gate_channels=16, skip_channels=16)
HG = dict(upsample_initial_channel=16)


def _leaf_apart(got: dict, want: dict) -> float:
    """The largest distance of a leaf, over that leaf's scale (its largest
    magnitude)."""
    assert got.keys() == want.keys()
    return max(float((got[k] - want[k]).abs().max()) / max(float(want[k].abs().max()), 1e-30) for k in want)


def _t(flat: dict) -> dict:
    return {k: torch.from_numpy(np.array(v, np.float32)) for k, v in flat.items()}


# --------------------------------------------------------------- the losses

def test_mol_loss_matches_jax_including_edges():
    """``discretized_mol_loss`` and its gradient against JAX's on targets
    that take each branch: the edges beyond +-0.999, bins whose mass is
    above 1e-5, and bins far in a narrow logistic's tail (the density
    branch); log scales below ``log_scale_min`` clamped."""
    rng = np.random.RandomState(0)
    logits = rng.randn(2, 64, 30).astype(np.float32)
    logits[..., 20:] = rng.uniform(-40.0, 1.0, (2, 64, 10))
    logits[0, :8, 20:] = -9.0  # narrow: a target 0.5 away sits in the tail
    target = rng.uniform(-0.98, 0.98, (2, 64)).astype(np.float32)
    target[0, :8] = 0.5 + logits[0, :8, 10:20].max(-1)
    target[1, :4], target[1, 4:8] = -1.0, 1.0
    target[1, 8:10], target[1, 10:12] = -0.9995, 0.9995
    jl, jg = jax.value_and_grad(lambda lg: jax_mol_loss(lg, jnp.asarray(target)))(jnp.asarray(logits))
    want_nll = np.asarray(jax_mol_loss(jnp.asarray(logits), jnp.asarray(target), reduce=False))
    lg = torch.from_numpy(logits).requires_grad_()
    loss = discretized_mol_loss(lg, torch.from_numpy(target))
    loss.backward()
    nll = discretized_mol_loss(lg.detach(), torch.from_numpy(target), reduce=False).numpy()
    assert float(loss.detach()) == pytest.approx(float(jl), rel=LOSS_RTOL)
    np.testing.assert_allclose(nll, want_nll, rtol=LOSS_RTOL, atol=LOSS_RTOL * np.abs(want_nll).max())
    np.testing.assert_allclose(lg.grad.numpy(), np.asarray(jg), atol=1e-6 * np.abs(np.asarray(jg)).max() + 1e-9,
                               rtol=1e-4)


def _waves(seed, b=2, n=2047):
    rng = np.random.RandomState(seed)
    t = np.arange(n) / 16000.0
    return np.stack([0.4 * np.sin(2 * np.pi * rng.uniform(100, 300) * t) + 0.05 * rng.randn(n)
                     for _ in range(b)]).astype(np.float32)


# The gradients of the STFT losses, of their peak: two float32 FFTs round a
# bin about 1e-6 of the frame's loudest apart, and the log magnitude's
# gradient, 1 / (m + 1e-5), carries that to the waveform far larger where a
# bin is near the floor (the multi-resolution loss's 512-point frames:
# measured 4.1e-4 at the worst sample, 2e-7 at the median); the mel losses
# sum bins first (measured 1.0e-6).
GRAD_TOL = {"stft": 1e-3, "log_mel": 1e-5, "feature_mel": 1e-5}


def test_stft_losses_match_jax():
    """The multi-resolution STFT loss (a Frobenius norm over the whole
    batch), the log-mel L1 and the feature-mel L1 to LOSS_RTOL, and their
    gradients within GRAD_TOL of the peak, against JAX's."""
    audio, y_hat, y = AudioConfig(), _waves(1, n=8192), _waves(2, n=8192)
    basis = train_hifigan.mel_basis(audio)
    jbasis = jnp.asarray(basis.numpy())
    for name, port_fn, jax_fn in (
            ("stft", train_hifigan.multi_resolution_stft_loss, jax_hifigan.multi_resolution_stft_loss),
            ("log_mel", lambda a, b: train_hifigan.log_mel_l1(a, b, basis, audio),
             lambda a, b: jax_hifigan.log_mel_l1(a, b, jbasis, JaxAudioConfig())),
            ("feature_mel", lambda a, b: train_hifigan.feature_mel_l1(a, b, basis, audio),
             lambda a, b: jax_hifigan.feature_mel_l1(a, b, jbasis, JaxAudioConfig()))):
        want, jg = jax.value_and_grad(jax_fn)(jnp.asarray(y_hat), jnp.asarray(y))
        a = torch.from_numpy(y_hat).requires_grad_()
        got = port_fn(a, torch.from_numpy(y))
        got.backward()
        assert float(got.detach()) == pytest.approx(float(want), rel=LOSS_RTOL), name
        jg = np.asarray(jg)
        np.testing.assert_allclose(a.grad.numpy(), jg, atol=GRAD_TOL[name] * np.abs(jg).max(), rtol=0,
                                   err_msg=name)


# ---------------------------------------------------------------- the crops

def _corpus(seed=5, n=3):
    rng = np.random.RandomState(seed)
    lengths = [int(rng.randint(20, 40)) for _ in range(n)]
    wavs = [rng.randn(f * 256 + int(rng.randint(0, 200))).astype(np.float32) * 0.3 for f in lengths]
    wavs.append(rng.randn(5 * 256).astype(np.float32) * 0.3)  # shorter than a crop
    mels = [rng.rand(len(w) // 256, 80).astype(np.float32) for w in wavs]
    return wavs, mels


def test_crops_match_jax_bit_for_bit():
    """``crop_batch`` (8000 -> 7936 samples at hop 256) and
    ``hifigan_crop_batch`` against JAX's on the same generator seed,
    bit for bit, short utterances zero-padded."""
    wavs, mels = _corpus()
    for port_fn, jax_fn, arg in ((train_wavenet.crop_batch, jax_wavenet.crop_batch, 8000),
                                 (train_hifigan.hifigan_crop_batch, jax_hifigan.hifigan_crop_batch, 32)):
        got = port_fn(wavs, mels, 6, arg, 256, np.random.default_rng(7))
        want = jax_fn(wavs, mels, 6, arg, 256, np.random.default_rng(7))
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("init_step", [0, 3999, 10_000])
def test_noam_schedule_matches_jax(init_step):
    port, want = train_wavenet.noam_schedule(4000, init_step), jax_wavenet.noam_schedule(4000, init_step)
    for step in (0, 1, 2, 100, 5000):
        assert port(step) == np.float32(want(step))


# ---------------------------------------------------------------- trainers

def _wavenet_pair(tmp_path, init_step=0):
    """The JAX trainer and the port's carrying its parameters (through the
    JAX trainer's ``save`` of its raw parameters and the port's ``load``)."""
    jt = jax_wavenet.WaveNetTrainer(JaxWaveNetConfig(**WN), lr=1e-3, warmup=4, ema_decay=0.9, seed=0,
                                    init_step=init_step)
    path = str(tmp_path / "jax_wn.npz")
    jt.save(path, use_ema=False)
    pt = train_wavenet.WaveNetTrainer(WaveNetConfig(**WN), lr=1e-3, warmup=4, ema_decay=0.9, init_step=init_step,
                                      device="cpu")
    pt.load(path)
    return jt, pt


def _wavenet_batches(n=2):
    wavs, mels = _corpus()
    rng = np.random.default_rng(3)
    return [train_wavenet.crop_batch(wavs, mels, 2, 1024, 256, rng) for _ in range(n)]


def test_wavenet_trainer_two_steps_match_jax(tmp_path):
    """Two steps of the port's trainer against the JAX trainer's jitted
    step on the same batches from the same parameters: the losses to
    LOSS_RTOL, the parameters and the EMA (decay 0.9, so that it moves)
    within LEAF_TOL of a leaf's scale; then ``save`` both ways."""
    jt, pt = _wavenet_pair(tmp_path)
    for x, c in _wavenet_batches():
        jt.params, jt.opt_state, jt.ema, jloss = jt._step(jt.params, jt.opt_state, jt.ema, jnp.asarray(x),
                                                          jnp.asarray(c))
        assert float(pt.step(x, c)) == pytest.approx(float(jloss), rel=LOSS_RTOL)
    assert pt.opt_count() == jt.opt_count() == 2
    port_params = {k.replace(".", "/"): v.detach() for k, v in pt.model.named_parameters()}
    assert _leaf_apart(port_params, _t(jax_flatten(jt.params))) <= LEAF_TOL
    assert _leaf_apart({k.replace(".", "/"): v for k, v in pt.ema.items()}, _t(jax_flatten(jt.ema))) <= LEAF_TOL
    ema = str(tmp_path / "port_ema.npz")
    pt.save(ema)
    loaded = JaxWaveNetVocoder.from_checkpoint(JaxWaveNetConfig(**WN), ema)
    assert _leaf_apart(_t(jax_flatten(loaded.params)), _t(jax_flatten(jt.ema))) <= LEAF_TOL


def test_wavenet_train_state_round_trips_both_ways(tmp_path):
    """The port's ``save_train_state`` restores into the JAX trainer (its
    leaves the JAX trainer's after the same two steps, within LEAF_TOL of a
    leaf's scale; the counts equal), and the JAX trainer's into the port's,
    which then takes the next step as JAX does; a mismatched ``init_step``
    is refused."""
    jt, pt = _wavenet_pair(tmp_path, init_step=5)
    batches = _wavenet_batches(3)
    for x, c in batches[:2]:
        jt.params, jt.opt_state, jt.ema, _ = jt._step(jt.params, jt.opt_state, jt.ema, jnp.asarray(x),
                                                      jnp.asarray(c))
        pt.step(x, c)
    port_state, jax_state = str(tmp_path / "port.train_state.npz"), str(tmp_path / "jax.train_state.npz")
    pt.save_train_state(port_state)
    jt.save_train_state(jax_state)
    with np.load(port_state) as a, np.load(jax_state) as b:
        assert sorted(a.files) == sorted(b.files)
        assert int(a["meta_count"]) == int(b["meta_count"]) == 2 and int(a["meta_init_step"]) == 5
        for k in b.files:
            want = b[k]
            assert a[k].shape == want.shape and a[k].dtype == want.dtype, k
            scale = max(float(np.abs(want).max()), 1e-30)
            assert float(np.abs(a[k] - want).max()) <= LEAF_TOL * scale, k
    back = jax_wavenet.WaveNetTrainer(JaxWaveNetConfig(**WN), lr=1e-3, warmup=4, ema_decay=0.9, init_step=5)
    back.restore_train_state(port_state)
    assert back.opt_count() == 2
    resumed = train_wavenet.WaveNetTrainer(WaveNetConfig(**WN), lr=1e-3, warmup=4, ema_decay=0.9, init_step=5,
                                           device="cpu")
    resumed.restore_train_state(jax_state)
    x, c = batches[2]
    jt.params, jt.opt_state, jt.ema, jloss = jt._step(jt.params, jt.opt_state, jt.ema, jnp.asarray(x),
                                                      jnp.asarray(c))
    assert float(resumed.step(x, c)) == pytest.approx(float(jloss), rel=LOSS_RTOL)
    port_params = {k.replace(".", "/"): v.detach() for k, v in resumed.model.named_parameters()}
    assert _leaf_apart(port_params, _t(jax_flatten(jt.params))) <= LEAF_TOL
    with pytest.raises(ValueError, match="init_step"):
        train_wavenet.WaveNetTrainer(WaveNetConfig(**WN), device="cpu").restore_train_state(jax_state)


HG_CFG = dataclasses.replace(HiFiGANConfig(), **HG)
JAX_HG_CFG = dataclasses.replace(JaxHiFiGANConfig(), **HG)


def _hifigan_batches(n=2, frames=8):
    wavs, mels = _corpus()
    rng = np.random.default_rng(4)
    return [train_hifigan.hifigan_crop_batch(wavs, mels, 2, frames, 256, rng) for _ in range(n)]


def _wide(a):
    a = np.asarray(a)
    return jnp.asarray(a.astype(np.float64) if np.issubdtype(a.dtype, np.floating) else a)


def float64_steps(step, state: tuple, batches) -> tuple[list, list]:
    """A JAX trainer's jitted ``step`` run from ``state`` on ``batches`` with
    JAX's float64 on, every floating leaf widened: the exact steps, made by
    the JAX package alone, that the port is held to. -> (the state after
    each step, each step's last output), numpy."""
    with jax.enable_x64(True):
        state = jax.tree_util.tree_map(_wide, tuple(state))
        states, outs = [], []
        for batch in batches:
            *state, out = step(*state, *(_wide(b) for b in batch))
            states.append(jax.tree_util.tree_map(np.asarray, tuple(state)))
            outs.append(jax.tree_util.tree_map(np.asarray, out))
        return states, outs


def adam_moments(opt_state, prefix: str = "") -> dict:
    """optax's Adam moments in ``opt_state`` by their parameters' flat names
    (``mu/<prefix><name>``, ``nu/<prefix><name>``)."""
    (adam,) = [s for s in jax.tree_util.tree_leaves(opt_state, is_leaf=lambda s: hasattr(s, "mu"))
               if hasattr(s, "mu")]
    return {f"{m}/{prefix}{k}": v for m in ("mu", "nu") for k, v in jax_flatten(getattr(adam, m)).items()}


def port_moments(leaves: JaxLeaves, optimizer, prefix: str = "") -> dict:
    """The port optimizer's Adam moments, named as ``adam_moments`` names
    JAX's."""
    _, *moments = leaves.adam_leaves(optimizer)
    n = len(leaves.paths)
    return {f"{'mu' if i < n else 'nu'}/{prefix}{leaves.paths[i % n]}": v for i, v in enumerate(moments)}


def step_gradients(states_moments: list, b1: float) -> list:
    """Each step's exact gradient up to Adam's factor 1 - b1, from the first
    moments after each step: mu_t - b1 mu_(t-1), by parameter name."""
    grads, prev = [], None
    for moments in states_moments:
        mu = {k[3:]: v for k, v in moments.items() if k.startswith("mu/")}
        grads.append({k: v - (b1 * prev[k] if prev else 0.0) for k, v in mu.items()})
        prev = mu
    return grads


def leaf_distances(got: dict, want: dict) -> dict:
    assert got.keys() == want.keys()
    return {k: float(np.abs(np.asarray(got[k], np.float64) - np.asarray(want[k], np.float64)).max())
            / max(float(np.abs(np.asarray(want[k])).max()), 1e-30) for k in want}


# An element of a parameter is held to LEAF_TOL of its leaf's scale from
# JAX's float64 steps where its exact gradient at every step is at least
# NEAR_ZERO of the leaf's largest. Below, float32 cannot settle Adam's step:
# the gradients carry rounding of about 1e-3 of a leaf's largest (two
# float32 FFTs, a log magnitude; more through the discriminators), Adam's
# first update is +-lr whatever the gradient's size and its second follows
# the ratio of the two gradients, so a rounding of r moves an element whose
# gradient is a share f of the largest by about r / f of lr, and flips it
# (2 lr, 2.5e-3 of a leaf's scale) where f < r. Measured: every held element
# within LEAF_TOL at NEAR_ZERO 0.05 on both the reconstruction and the GAN
# steps, which holds 0.50 and 0.30 of their elements; at 0.02 one GAN
# generator kernel lies 1.34e-4 away. A gradient below ZERO of the largest
# anywhere is zero to float32: GE2E's b, which shifts every score alike and
# so has none in exact arithmetic.
NEAR_ZERO, ZERO = 0.05, 1e-5
# Adam's moments (the gradients) from JAX's float64 steps, of a leaf's
# scale: every leaf within MOMENT_LEAF_TOL and the median leaf within
# MOMENT_TOL. Measured on the reconstruction steps: the worst leaf 4.5e-3,
# the median 2.8e-4 (JAX float32's own: 3.7e-2 and 3.7e-4); b1 0.9 in place
# of 0.8 moves the median to 0.23, b2 0.999 in place of 0.99 to 0.45.
MOMENT_LEAF_TOL, MOMENT_TOL = 5e-2, 2e-3


def held_elements(exact: dict, grads: list, near_zero: float = NEAR_ZERO) -> dict:
    """Per leaf, the elements ``param_rule`` holds: those whose exact
    gradient at every step (``grads``, from ``step_gradients``) is at least
    ``near_zero`` of the leaf's largest and at least ZERO of the largest in
    ``exact``'s leaves."""
    held = {k: np.ones(np.shape(v), bool) for k, v in exact.items()}
    for g in grads:
        g = {k: np.abs(np.asarray(g[k], np.float64)) for k in exact}
        floor = ZERO * max(float(v.max()) for v in g.values())
        for k, v in g.items():
            held[k] &= (v >= near_zero * v.max()) & (v >= floor)
    return held


def param_rule(port: dict, exact: dict, grads: list, near_zero: float = NEAR_ZERO) -> list:
    """The leaves with a held element (``held_elements``) farther than
    LEAF_TOL of the leaf's scale from JAX's float64 steps (``exact``):
    (name, the distance, the share of the leaf's elements held)."""
    off = []
    for k, held in held_elements(exact, grads, near_zero).items():
        want = np.asarray(exact[k], np.float64)
        apart = np.abs(np.asarray(port[k], np.float64) - want) / max(float(np.abs(want).max()), 1e-30)
        if held.any() and apart[held].max() > LEAF_TOL:
            off.append((k, float(apart[held].max()), float(held.mean())))
    return off


def held_share(exact: dict, grads: list, near_zero: float = NEAR_ZERO) -> float:
    """The share of the parameters' elements that ``param_rule`` holds."""
    held = held_elements(exact, grads, near_zero).values()
    return sum(int(h.sum()) for h in held) / sum(h.size for h in held)


def moment_rule(port: dict, exact: dict) -> list:
    """Adam's moments farther than MOMENT_LEAF_TOL of a leaf's scale from
    JAX's float64 steps, and the median leaf farther than MOMENT_TOL; a
    leaf's scale its largest exact moment, or ZERO of the largest first
    moment anywhere (ZERO squared for the second) where that is larger."""
    apart = {}
    for kind, floor in (("mu/", ZERO), ("nu/", ZERO ** 2)):
        keys = [k for k in exact if k.startswith(kind)]
        floor *= max(float(np.abs(exact[k]).max()) for k in keys)
        for k in keys:
            want = np.asarray(exact[k], np.float64)
            apart[k] = (float(np.abs(np.asarray(port[k], np.float64) - want).max())
                        / max(float(np.abs(want).max()), floor, 1e-30))
    median = float(np.median(list(apart.values())))
    return ([(k, v) for k, v in apart.items() if v > MOMENT_LEAF_TOL]
            + ([("median leaf", median)] if median > MOMENT_TOL else []))


class GivenInit:
    """A flax module whose ``init`` returns the parameters of a port module
    (``conv_state_to_jax``): the JAX trainers compile their networks'
    ``init``, which takes most of half a minute here for the narrow
    HiFi-GAN, and the steps compared need only start from the same
    parameters on both sides."""

    def __init__(self, module, port: torch.nn.Module):
        self.module, self.flat = module, conv_state_to_jax(port.state_dict())

    def init(self, *args):
        return {"params": jax.tree_util.tree_map(jnp.asarray, jax_unflatten(self.flat))}

    def apply(self, *args, **kw):
        return self.module.apply(*args, **kw)


def jax_hifigan_trainer(trainer=None, **kw):
    """A JAX HiFi-GAN trainer (``trainer``, the reconstruction one by
    default) at JAX_HG_CFG, its generator starting from a port generator's
    parameters (GivenInit)."""
    real = jax_hifigan.HiFiGANGenerator
    port = train_hifigan.HiFiGANTrainer(HG_CFG, seed=0, device="cpu").model
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_hifigan, "HiFiGANGenerator", lambda cfg: GivenInit(real(cfg), port))
        return (trainer or jax_hifigan.HiFiGANTrainer)(JAX_HG_CFG, seed=0, **kw)


@pytest.fixture(scope="module")
def hifigan_recon_reference():
    """The JAX reconstruction trainer's parameters (flat), then its two
    float32 steps and its two float64 steps from them: (start, JAX's
    losses, JAX float32's Adam moments, the float64 parameters, moments and
    each step's gradients)."""
    jt = jax_hifigan_trainer()
    start = jax_flatten(jax.tree_util.tree_map(np.asarray, jt.params))
    states, _ = float64_steps(jt._step, (jt.params, jt.opt_state), _hifigan_batches())
    losses = []
    for mel, y in _hifigan_batches():
        jt.params, jt.opt_state, jloss = jt._step(jt.params, jt.opt_state, jnp.asarray(mel), jnp.asarray(y))
        losses.append(float(jloss))
    moments = [adam_moments(opt) for _, opt in states]
    return start, losses, adam_moments(jt.opt_state), (jax_flatten(states[-1][0]), moments[-1],
                                                        step_gradients(moments, 0.8))


def _port_recon(start, plant=None):
    """The port's reconstruction trainer from ``start``, its optimizer's
    hyperparameters replaced by ``plant``, after the two steps: (losses,
    parameters, Adam moments, the trainer)."""
    pt = train_hifigan.HiFiGANTrainer(HG_CFG, seed=0, device="cpu")
    pt.load_generator(start)
    pt.optimizer.param_groups[0].update(plant or {})
    losses = [float(pt.step(mel, y)) for mel, y in _hifigan_batches()]
    leaves = JaxLeaves(pt.model, conv_state_to_jax, train_hifigan._from_flat)
    return losses, conv_state_to_jax(pt.model.state_dict()), port_moments(leaves, pt.optimizer), pt


def test_hifigan_reconstruction_two_steps_match_jax(tmp_path, hifigan_recon_reference):
    """Two reconstruction steps (adamw b1 0.8, b2 0.99, no decay) from the
    JAX trainer's parameters: the losses to LOSS_RTOL of JAX's; the
    generator by ``param_rule`` and Adam's moments by ``moment_rule``,
    against JAX's own float64 steps; its ``save`` loads in the JAX
    vocoder."""
    start, want_losses, jax_moments, (exact, exact_moments, grads) = hifigan_recon_reference
    assert moment_rule(jax_moments, exact_moments) == []  # JAX float32 meets it too
    losses, port, moments, pt = _port_recon(start)
    assert losses == pytest.approx(want_losses, rel=LOSS_RTOL)
    print(f"held {held_share(exact, grads):.3f} of the generator's elements")
    assert param_rule(port, exact, grads) == []
    assert moment_rule(moments, exact_moments) == []
    path = str(tmp_path / "port_hifigan.npz")
    pt.save(path)
    loaded = JaxHiFiGANVocoder.from_checkpoint(JAX_HG_CFG, path)
    assert _leaf_apart(_t(jax_flatten(loaded.params)), _t(port)) == 0.0


@pytest.mark.parametrize("plant", [{"betas": (0.8, 0.999)}, {"betas": (0.9, 0.99)}, {"lr": 2.2e-4}],
                         ids=["b2", "b1", "lr"])
def test_hifigan_reconstruction_rule_refuses_a_planted_fault(hifigan_recon_reference, plant):
    """The controls: the port's optimizer with b2 0.999, b1 0.9 or a
    learning rate 10% high fails the float64 rules (a weight decay or an
    eps too small to move two steps at lr 2e-4 is held by
    tests/test_torch_hifigan_gan.py's optimizer test)."""
    start, _, _, (exact, exact_moments, grads) = hifigan_recon_reference
    _, port, moments, _ = _port_recon(start, plant)
    assert param_rule(port, exact, grads) + moment_rule(moments, exact_moments) != []


# ------------------------------------------------------------ the hybrid

def test_refine_with_mel_magnitude_matches_jax():
    """``refine_with_mel_magnitude`` against JAX's, within 1e-4 of the
    output's peak: a waveform as long as the mel (cut) and one shorter
    (its phase padded with the last frame), n_iter 0 and 2."""
    rng = np.random.RandomState(6)
    mel = rng.rand(12, 80).astype(np.float32) * 0.8
    for n in (12 * 256, 9 * 256):
        wav = (0.3 * np.sin(np.arange(n) * 0.05) + 0.02 * rng.randn(n)).astype(np.float32)
        for n_iter in (0, 2):
            want = np.asarray(jax_hybrid.refine_with_mel_magnitude(jnp.asarray(wav), jnp.asarray(mel),
                                                                   JaxAudioConfig(), n_iter=n_iter))
            got = refine_with_mel_magnitude(torch.from_numpy(wav), torch.from_numpy(mel), AudioConfig(),
                                            n_iter=n_iter).numpy()
            assert got.shape == want.shape == (12 * 256,)
            np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max(), rtol=0)


# ---------------------------------------------------------------- the CLIs

def tree(root, speakers=2, utts=2, seed=8):
    """<root>/wavs/<spk>/<utt>.wav and <root>/spmel/<spk>/<utt>.npy pairs
    (the mel a stand-in: only the pairing and the lengths matter here)."""
    rng = np.random.RandomState(seed)
    for s in range(speakers):
        spk = f"p{225 + s}"
        os.makedirs(os.path.join(root, "wavs", spk))
        os.makedirs(os.path.join(root, "spmel", spk))
        for u in range(utts):
            n = int(rng.randint(40, 60)) * 256
            t = np.arange(n) / 16000.0
            wav = (0.3 * np.sin(2 * np.pi * rng.uniform(100, 300) * t) + 0.02 * rng.randn(n)).astype(np.float32)
            write_wav(os.path.join(root, "wavs", spk, f"{spk}_{u:03d}.wav"), wav)
            np.save(os.path.join(root, "spmel", spk, f"{spk}_{u:03d}.npy"),
                    rng.rand(n // 256 + 1, 80).astype(np.float32))


@pytest.fixture
def narrow_vocoder_clis(monkeypatch):
    from autovc_tpu_torch.cli import evaluate_vocoder, train_vocoder

    monkeypatch.setattr(train_vocoder, "WaveNetConfig", lambda: WaveNetConfig(**WN))
    for mod in (train_vocoder, evaluate_vocoder):
        monkeypatch.setattr(mod, "HiFiGANConfig", lambda: HG_CFG)
    return train_vocoder, evaluate_vocoder


def test_train_vocoder_cli_wavenet_and_hifigan(tmp_path, narrow_vocoder_clis):
    """``cli.train_vocoder`` for each vocoder (2 steps): WaveNet with its
    train state, resumed by ``--init``, and HiFi-GAN's reconstruction with
    ``--save_every 1`` and ``--feat_weight``; each checkpoint loads in
    ``autovc_tpu``, the WaveNet train state restores into the JAX trainer
    (the GAN's: tests/test_torch_hifigan_gan.py)."""
    train_vocoder, _ = narrow_vocoder_clis
    tree(tmp_path)
    common = ["--main_dir", str(tmp_path), "--num_iters", "2", "--log_step", "1", "--device", "cpu"]
    wn = str(tmp_path / "wn.npz")
    train_vocoder.main([*common, "--vocoder", "wavenet", "--max_time", "1024", "--out", wn])
    JaxWaveNetVocoder.from_checkpoint(JaxWaveNetConfig(**WN), wn)
    jax_wavenet.WaveNetTrainer(JaxWaveNetConfig(**WN)).restore_train_state(wn + ".train_state.npz")
    resumed = train_vocoder.main([*common, "--vocoder", "wavenet", "--max_time", "1024", "--init", wn, "--out",
                                  str(tmp_path / "wn2.npz")])
    assert resumed.opt_count() == 4
    hg = str(tmp_path / "hg.npz")
    trainer = train_vocoder.main([*common, "--vocoder", "hifigan", "--frames", "8", "--save_every", "1",
                                  "--feat_weight", "0.5", "--out", hg])
    assert len(trainer.history) == 2 and not os.path.exists(hg + ".train_state.npz")
    JaxHiFiGANVocoder.from_checkpoint(JAX_HG_CFG, hg)


def test_evaluate_vocoder_cli_matches_jax(tmp_path, narrow_vocoder_clis, monkeypatch, capsys):
    """``cli.evaluate_vocoder --vocoder hifigan`` and ``hybrid`` on a narrow
    HiFi-GAN checkpoint against the JAX CLI (its config narrowed the same
    way): the JSON line's numbers within 1e-3 relative; griffinlim runs
    (its random phase is drawn otherwise than JAX's)."""
    import json

    import autovc_tpu.config as jax_config
    from autovc_tpu.cli.evaluate_vocoder import main as jax_main

    _, evaluate_vocoder = narrow_vocoder_clis
    real = jax_config.Config
    monkeypatch.setattr(jax_config, "Config", lambda: dataclasses.replace(real(), hifigan=JAX_HG_CFG))
    tree(tmp_path, speakers=1)
    pt = train_hifigan.HiFiGANTrainer(HG_CFG, seed=2, device="cpu")
    ckpt = str(tmp_path / "hg.npz")
    pt.save(ckpt)
    spmel = str(tmp_path / "spmel")
    for vocoder in ("hifigan", "hybrid"):
        args = ["--spmel_dir", spmel, "--vocoder", vocoder, "--vocoder_ckpt", ckpt]
        jax_main(args)
        want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        got = evaluate_vocoder.main([*args, "--device", "cpu", "--out", str(tmp_path / "log.jsonl")])
        assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == got
        assert got.keys() == want.keys() and got["utterances"] == want["utterances"] == 2
        for k in ("mel_l1_mean", "mel_l1_median", "mel_mse_mean", "mcd_db_mean", "mcd_db_median"):
            assert got[k] == pytest.approx(want[k], rel=1e-3), (vocoder, k)
    gl = evaluate_vocoder.main(["--spmel_dir", spmel, "--max_utts", "1", "--gl_iters", "2", "--device", "cpu"])
    assert gl["utterances"] == 1 and np.isfinite(gl["mel_l1_mean"])
    with open(tmp_path / "log.jsonl") as fh:
        assert len(fh.readlines()) == 2
    with pytest.raises(SystemExit):
        evaluate_vocoder.main(["--spmel_dir", spmel, "--vocoder", "wavenet", "--device", "cpu"])
