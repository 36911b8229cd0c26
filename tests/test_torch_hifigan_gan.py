"""The port's HiFi-GAN discriminators and adversarial training against the
JAX package on the CPU: MPD and MSD at their published widths on B=2,
T=2047 (an odd length: SAME pooling pads 1 and 2), flax's SAME average
pooling, two GAN steps of ``HiFiGANGANTrainer`` from the JAX trainer's
parameters (a narrow 16-channel generator and narrow discriminators), its
``.npz`` train state both ways, and ``cli.train_vocoder --gan --init``.
Apart from tests/test_torch_vocoder_train.py to keep each file's time
short."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from flax import linen as fnn

from autovc_tpu.vocoder import discriminators as jax_disc
from autovc_tpu.vocoder import train_hifigan as jax_hifigan
from autovc_tpu.vocoder.hifigan import HiFiGANVocoder as JaxHiFiGANVocoder
from autovc_tpu.vocoder.wavenet import flatten_params as jax_flatten
from autovc_tpu_torch.io import conv_state_to_jax, hifigan_state_from_jax
from autovc_tpu_torch.vocoder import discriminators as disc
from autovc_tpu_torch.vocoder import train_hifigan

from test_torch_vocoder_train import (HG_CFG, JAX_HG_CFG, LOSS_RTOL, GivenInit, _hifigan_batches, _waves, adam_moments,
                                      float64_steps, jax_hifigan_trainer, moment_rule, narrow_vocoder_clis,
                                      held_share, param_rule, step_gradients, tree)

torch.set_num_threads(1)

__all__ = ["narrow_vocoder_clis"]  # a fixture


# The GAN steps and the CLI run narrow discriminators on both sides (the
# published MSD holds 1024 x 1024 x 41 kernels: 0.6 GB of parameters, each
# Adam moment as much again, too much for these CPU tests); the published
# widths are held by the forward check below, on JAX's own modules.
NARROW_MPD = (4, 8, 16, 16, 16)
NARROW_MSD = ((8, 15, 1), (8, 41, 2), (16, 41, 2), (16, 41, 4), (16, 41, 4), (16, 5, 1))
REAL_DISCS = jax_disc.HiFiGANDiscriminators


def narrow_discriminators() -> disc.HiFiGANDiscriminators:
    return disc.HiFiGANDiscriminators(mpd_channels=NARROW_MPD, msd_specs=NARROW_MSD)


class NarrowPeriod(fnn.Module):
    """``jax_disc.PeriodDiscriminator`` at NARROW_MPD's widths."""

    period: int

    @fnn.compact
    def __call__(self, y):
        b, t = y.shape
        pad = (-t) % self.period
        h = jnp.pad(y, ((0, 0), (0, pad)), mode="reflect" if t > 1 else "constant")
        h = h.reshape(b, (t + pad) // self.period, self.period, 1)
        feats = []
        for i, ch in enumerate(NARROW_MPD):
            strides = (3, 1) if i < 4 else (1, 1)
            h = jax_disc._leaky(fnn.Conv(ch, (5, 1), strides=strides, padding=[(2, 2), (0, 0)], name=f"conv{i}")(h))
            feats.append(h)
        return fnn.Conv(1, (3, 1), padding=[(1, 1), (0, 0)], name="post")(h).reshape(b, -1), feats


class NarrowScale(fnn.Module):
    """``jax_disc.ScaleDiscriminator`` at NARROW_MSD's widths."""

    @fnn.compact
    def __call__(self, y):
        h, feats = y[..., None], []
        for i, (ch, k, st) in enumerate(NARROW_MSD):
            h = jax_disc._leaky(fnn.Conv(ch, (k,), strides=(st,), padding=[(k // 2, k // 2)], name=f"conv{i}")(h))
            feats.append(h)
        return fnn.Conv(1, (3,), padding=[(1, 1)], name="post")(h).reshape(y.shape[0], -1), feats


class NarrowDiscriminators(fnn.Module):
    """``jax_disc.HiFiGANDiscriminators`` of NarrowPeriod and NarrowScale,
    with JAX's own SAME pooling."""

    periods: tuple = (2, 3, 5, 7, 11)

    @fnn.compact
    def __call__(self, y):
        scores, feats = [], []
        for p in self.periods:
            s, f = NarrowPeriod(p, name=f"mpd{p}")(y)
            scores.append(s)
            feats.append(f)
        h = y
        for i in range(3):
            s, f = NarrowScale(name=f"msd{i}")(h)
            scores.append(s)
            feats.append(f)
            h = jax_disc._avg_pool(h)
        return scores, feats


@pytest.fixture(scope="module")
def gan_trainers(tmp_path_factory):
    """The JAX GAN trainer (its discriminators NarrowDiscriminators; its
    parameters a port generator's and port discriminators'), a
    function that makes the port's trainer at the same widths carrying its generator
    (``save``) and discriminators (``save_train_state``, the optimizers at
    count 0), and JAX's two float64 GAN steps from that state: (the JAX
    trainer, that function, the float64 states and metrics, a directory)."""
    tmp = tmp_path_factory.mktemp("gan")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_disc, "HiFiGANDiscriminators",
                   lambda: GivenInit(NarrowDiscriminators(), narrow_discriminators()))
        jt = jax_hifigan_trainer(jax_hifigan.HiFiGANGANTrainer)
    gen, state = str(tmp / "g.npz"), str(tmp / "g.npz.train_state.npz")
    jt.save(gen)
    jt.save_train_state(state)
    exact = float64_steps(jt._gan_step, (jt.params, jt.opt_state, jt.d_params, jt.d_opt_state),
                          _hifigan_batches(frames=4))

    def port():
        with np.load(gen) as z, pytest.MonkeyPatch.context() as mp:
            mp.setattr(train_hifigan, "HiFiGANDiscriminators", narrow_discriminators)
            pt = train_hifigan.HiFiGANGANTrainer(HG_CFG, seed=0, generator_params={k: z[k] for k in z.files},
                                                 device="cpu")
        pt.restore_train_state(state)
        return pt

    return jt, port, exact, tmp


@pytest.fixture(scope="module")
def real_discriminators():
    """JAX's discriminators at the published widths, initialised on a
    (1, 2048) waveform, and the port's carrying their parameters."""
    module = REAL_DISCS()
    params = jax.jit(module.init)(jax.random.PRNGKey(0), jnp.zeros((1, 2048)))["params"]
    port = disc.HiFiGANDiscriminators()
    port.load_state_dict(hifigan_state_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    return module, params, port


def _nhwc(feat: torch.Tensor) -> np.ndarray:
    """A port feature map (B, C, ...) in flax's channels-last layout."""
    return np.moveaxis(feat.detach().numpy(), 1, -1)


def test_discriminators_match_jax_on_an_odd_length(real_discriminators):
    """MPD and MSD at the published widths (JAX's, carried by
    ``io.hifigan_state_from_jax``) on B=2, T=2047: every score and
    feature map within 1e-5 of its peak, and the LSGAN and
    feature-matching losses to LOSS_RTOL."""
    module, params, port = real_discriminators
    apply = jax.jit(module.apply)
    real, fake = _waves(3), _waves(4)
    jr, jf = (apply({"params": params}, jnp.asarray(w)) for w in (real, fake))
    with torch.no_grad():
        pr, pf = port(torch.from_numpy(real)), port(torch.from_numpy(fake))
    for (js, jfe), (ps, pfe) in ((jr, pr), (jf, pf)):
        assert len(ps) == len(js) == 8
        for a, b in zip(ps, js):
            b = np.asarray(b)
            assert a.shape == b.shape
            np.testing.assert_allclose(a.numpy(), b, atol=1e-5 * np.abs(b).max(), rtol=0)
        for fa, fb in zip(pfe, jfe):
            for a, b in zip(fa, fb):
                b = np.asarray(b)
                np.testing.assert_allclose(_nhwc(a).reshape(b.shape), b, atol=1e-5 * np.abs(b).max(), rtol=0)
    pairs = ((disc.discriminator_loss(pr[0], pf[0]), jax_disc.discriminator_loss(jr[0], jf[0])),
             (disc.generator_adversarial_loss(pf[0]), jax_disc.generator_adversarial_loss(jf[0])),
             (disc.feature_matching_loss(pr[1], pf[1]), jax_disc.feature_matching_loss(jr[1], jf[1])))
    for got, want in pairs:
        assert float(got) == pytest.approx(float(want), rel=LOSS_RTOL)


@pytest.mark.parametrize("t", [2047, 2048, 7, 1])
def test_avg_pool_counts_the_padding_as_flax_does(t):
    """``avg_pool`` against flax's ``avg_pool(k=4, s=2, "SAME")``: ceil(T/2)
    outputs, the padded zeros in each mean."""
    from flax import linen as nn

    y = np.random.RandomState(t).randn(2, t).astype(np.float32)
    want = np.asarray(nn.avg_pool(jnp.asarray(y)[..., None], (4,), strides=(2,), padding="SAME")[..., 0])
    got = disc.avg_pool(torch.from_numpy(y)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-7, rtol=1e-6)


def test_hifigan_gan_steps_match_jax(gan_trainers):
    """Two GAN steps (the discriminators' update, then the generator's
    against them, narrow discriminators on both sides; the discriminators'
    adamw with optax's default weight decay 1e-4, the generator's with none)
    on 4-frame crops from the JAX trainer's state, held to JAX's own float64
    steps: the first discriminator loss to LOSS_RTOL of JAX's; every metric
    no farther from the float64 step's than twice JAX float32's distance
    plus LOSS_RTOL of it; the generator, and the discriminators and both
    Adam states of the port's train state as the JAX trainer restores it,
    by ``param_rule`` and ``moment_rule``."""
    jt, port, (states, metrics64), tmp = gan_trainers
    pt = port()
    for i, ((mel, y), em) in enumerate(zip(_hifigan_batches(frames=4), metrics64)):
        jt.params, jt.opt_state, jt.d_params, jt.d_opt_state, jm = jt._gan_step(
            jt.params, jt.opt_state, jt.d_params, jt.d_opt_state, jnp.asarray(mel), jnp.asarray(y))
        pm = pt.gan_step(mel, y)
        assert pm.keys() == jm.keys() == em.keys()
        for k in jm:
            got, want, ref = float(pm[k]), float(jm[k]), float(em[k])
            if i == 0 and k == "d_loss":
                assert got == pytest.approx(want, rel=LOSS_RTOL)
            assert abs(got - ref) <= 2 * abs(want - ref) + LOSS_RTOL * abs(ref), (i, k, got, want, ref)
    port_state, jax_state = str(tmp / "port.train_state.npz"), str(tmp / "jax.train_state.npz")
    pt.save_train_state(port_state)
    jt.save_train_state(jax_state)
    with np.load(port_state) as a, np.load(jax_state) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in b.files:
            assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype, k
    jt.restore_train_state(port_state)
    assert int(jax.tree_util.tree_leaves(jt.d_opt_state)[0]) == int(jax.tree_util.tree_leaves(jt.opt_state)[0]) == 2

    def named(g_params, g_opt, d_params, d_opt):
        params = {**{f"g/{k}": v for k, v in g_params.items()}, **{f"d/{k}": v for k, v in jax_flatten(d_params).items()}}
        return params, {**adam_moments(g_opt, "g/"), **adam_moments(d_opt, "d/")}

    port_params, port_moments = named(conv_state_to_jax(pt.model.state_dict()), jt.opt_state, jt.d_params,
                                      jt.d_opt_state)
    exact = [named(jax_flatten(g), go, d, do) for g, go, d, do in states]
    grads = step_gradients([moments for _, moments in exact], 0.8)
    for net in ("g/", "d/"):  # each network by its own scale
        params = {k: v for k, v in exact[-1][0].items() if k.startswith(net)}
        moments = {k: v for k, v in exact[-1][1].items() if k[3:].startswith(net)}
        print(f"{net} held {held_share(params, grads):.3f} of the elements")
        assert param_rule(port_params, params, grads) == [], net
        assert moment_rule(port_moments, moments) == [], net


# The optimizers' own arithmetic in float64, of a leaf's scale: torch's
# AdamW against optax's adamw (the same formula, summed in another order).
OPT_TOL = 1e-12


def _optimizer_apart(pt, jt, which: str, plant: dict) -> float:
    """The port trainer's optimizer ``which`` (its hyperparameters replaced
    by ``plant``) against the JAX trainer's, both in float64 on the same
    parameters and three steps of gradients of magnitudes 1e-9 to 1: the
    largest leaf distance over the leaf's scale."""
    opt = getattr(pt, which)
    opt.param_groups[0].update(plant)
    params = opt.param_groups[0]["params"]
    rng = np.random.RandomState(7)
    grads = [[rng.randn(*p.shape) * 10.0 ** rng.uniform(-9, 0, p.shape) for p in params] for _ in range(3)]
    with torch.no_grad():
        for p in params:
            p.data = p.data.double()
    start = [p.detach().numpy().copy() for p in params]
    for step in grads:
        for p, g in zip(params, step):
            p.grad = torch.from_numpy(g)
        opt.step()
    with jax.enable_x64(True):
        ref = getattr(jt, which)
        want = [jnp.asarray(a) for a in start]
        state = ref.init(want)

        @jax.jit
        def update(grads, state, params):
            updates, state = ref.update(grads, state, params)
            return optax.apply_updates(params, updates), state

        for step in grads:
            want, state = update([jnp.asarray(g) for g in step], state, want)
        want = [np.asarray(a) for a in want]
    return max(float(np.abs(p.detach().numpy() - w).max()) / max(float(np.abs(w).max()), 1e-30)
               for p, w in zip(params, want))


@pytest.mark.parametrize("which", ["optimizer", "d_optimizer"])
def test_hifigan_optimizers_match_optax_in_float64(gan_trainers, which):
    """The GAN trainer's two optimizers (the generator's adamw b1 0.8, b2
    0.99, no decay; the discriminators' the same with optax's default decay
    1e-4) take the JAX trainer's optax steps within OPT_TOL in float64."""
    jt, port, _, _ = gan_trainers
    assert _optimizer_apart(port(), jt, which, {}) <= OPT_TOL


@pytest.mark.parametrize("which, plant", [("d_optimizer", {"weight_decay": 0.0}), ("optimizer", {"weight_decay": 1e-4}),
                                          ("optimizer", {"eps": 1e-6}), ("d_optimizer", {"betas": (0.8, 0.999)})],
                         ids=["d-no-decay", "g-decay", "eps", "b2"])
def test_hifigan_optimizer_gate_refuses_a_planted_fault(gan_trainers, which, plant):
    """The controls: the discriminators' optimizer without its decay, the
    generator's with one, an eps of 1e-6 or a b2 of 0.999 fails OPT_TOL."""
    jt, port, _, _ = gan_trainers
    assert _optimizer_apart(port(), jt, which, plant) > OPT_TOL


def test_train_vocoder_cli_gan_with_init(tmp_path, narrow_vocoder_clis, gan_trainers, monkeypatch):
    """``cli.train_vocoder --vocoder hifigan --gan --init`` (2 steps,
    ``--save_every 1``) on a reconstruction checkpoint: the checkpoint loads
    in the JAX vocoder and its train state restores into the JAX GAN
    trainer; a second ``--gan --init`` on it resumes that state."""
    train_vocoder, _ = narrow_vocoder_clis
    monkeypatch.setattr(train_hifigan, "HiFiGANDiscriminators", narrow_discriminators)
    tree(tmp_path)
    common = ["--main_dir", str(tmp_path), "--num_iters", "2", "--log_step", "1", "--device", "cpu",
              "--vocoder", "hifigan", "--frames", "4"]
    hg = str(tmp_path / "hg.npz")
    train_vocoder.main([*common, "--num_iters", "1", "--out", hg])
    gan = str(tmp_path / "gan.npz")
    trainer = train_vocoder.main([*common, "--gan", "--init", hg, "--save_every", "1", "--out", gan])
    assert len(trainer.gan_history) == 2 and os.path.exists(gan + ".train_state.npz")
    JaxHiFiGANVocoder.from_checkpoint(JAX_HG_CFG, gan)
    gan_trainers[0].restore_train_state(gan + ".train_state.npz")
    resumed = train_vocoder.main([*common, "--num_iters", "1", "--gan", "--init", gan, "--out",
                                  str(tmp_path / "gan2.npz")])
    assert int(resumed.d_optimizer.state[next(iter(resumed.disc.parameters()))]["step"]) == 3
