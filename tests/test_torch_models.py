"""The port's layers and AutoVC generator (autovc_tpu_torch.models) against
the JAX package's flax modules, on the committed spmel weights and on seeded
random parameters; and the JAX-tree -> state-dict mapping (autovc_tpu_torch.io)."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from autovc_tpu import models as jax_models
from autovc_tpu.cli.export_ckpt import load_artifact as jax_load_artifact
from autovc_tpu.config import Config
from autovc_tpu_torch import io
from autovc_tpu_torch.config import ModelConfig
from autovc_tpu_torch.models import LSTM, BatchNorm, ConvNorm, Generator, LinearNorm, build_generator

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GEN_ARTIFACT = os.path.join(REPO, "artifacts", "generator_spmel_f16.npz")
ATOL = 1e-4  # f32 on both sides; convs and matmuls sum in different orders


def _jax_to_torch(variables, module):
    """Load a flax variable tree into a port module through io's mapping."""
    variables = jax.tree_util.tree_map(np.asarray, dict(variables))
    state = io.generator_state_from_jax({"params": variables["params"],
                                         "batch_stats": variables.get("batch_stats", {})})
    module.load_state_dict(state, strict=True)
    return module.eval()


def _jax_state_from_torch(state):
    """The inverse mapping, written out independently of io: torch key and
    layout back to the flat JAX key and layout."""
    flat = {}
    for key, value in state.items():
        arr = value.numpy()
        parts = key.split(".")
        leaf = parts[-1]
        if leaf in ("running_mean", "running_var"):
            flat["batch_stats/" + "/".join(parts[:-1] + ["BatchNorm_0", leaf.split("_")[1]])] = arr
            continue
        if parts[-2].startswith("bn"):
            flat["params/" + "/".join(parts[:-1] + ["BatchNorm_0", {"weight": "scale"}.get(leaf, leaf)])] = arr
        elif parts[-2] == "proj":
            flat["params/" + "/".join(parts[:-1] + ["Dense_0", {"weight": "kernel"}.get(leaf, leaf)])] = (
                arr.T if leaf == "weight" else arr)
        elif parts[-2].startswith("conv"):
            flat["params/" + "/".join(parts[:-1] + ["Conv_0", {"weight": "kernel"}.get(leaf, leaf)])] = (
                arr.transpose(2, 1, 0) if leaf == "weight" else arr)
        else:  # LSTM parameters keep the JAX layout
            flat["params/" + "/".join(parts)] = arr
    return flat


@pytest.fixture(scope="module")
def generator_pair():
    variables, _ = jax_load_artifact(GEN_ARTIFACT)
    jax_gen = jax_models.build_generator(Config().model)  # f32, use_pallas_lstm=False
    torch_gen = build_generator(ModelConfig(), artifact=GEN_ARTIFACT, device="cpu")
    return jax_gen, variables, torch_gen


@pytest.fixture(scope="module")
def generator_outputs(generator_pair):
    jax_gen, variables, torch_gen = generator_pair
    rng = np.random.RandomState(0)
    x = rng.rand(2, 64, 80).astype(np.float32)
    e_org = rng.randn(2, 256).astype(np.float32)
    e_trg = rng.randn(2, 256).astype(np.float32)
    want = jax_gen.apply(variables, jnp.asarray(x), jnp.asarray(e_org), jnp.asarray(e_trg), train=False)
    with torch.inference_mode():
        got = torch_gen(torch.from_numpy(x), torch.from_numpy(e_org), torch.from_numpy(e_trg))
    names = ("x_identic", "x_identic_psnt", "codes")
    return {n: (g.numpy(), np.asarray(w)) for n, g, w in zip(names, got, want)}


@pytest.mark.parametrize("output", ["x_identic", "x_identic_psnt", "codes"])
def test_generator_matches_jax_on_committed_weights(generator_outputs, output):
    got, want = generator_outputs[output]
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_encode_matches_jax(generator_pair):
    jax_gen, variables, torch_gen = generator_pair
    rng = np.random.RandomState(1)
    x = rng.rand(1, 96, 80).astype(np.float32)
    emb = rng.randn(1, 256).astype(np.float32)
    want = jax_gen.apply(variables, jnp.asarray(x), jnp.asarray(emb), train=False,
                         method=jax_gen.encode)
    with torch.inference_mode():
        got = torch_gen.encode(torch.from_numpy(x), torch.from_numpy(emb))
    assert got.shape == (1, 96 // 32 * 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def test_generator_state_round_trip_covers_every_artifact_key():
    tree, step = io.load_artifact(GEN_ARTIFACT)
    assert step >= 0
    with np.load(GEN_ARTIFACT) as z:
        flat = {k: z[k].astype(np.float32) for k in z.files if k != "__step__"}
    state = io.generator_state_from_jax(tree)
    Generator().load_state_dict(state, strict=True)  # every module key, no extras
    back = _jax_state_from_torch(state)
    assert sorted(back) == sorted(flat)
    for key, value in flat.items():
        np.testing.assert_array_equal(back[key], value, err_msg=key)


def test_load_artifact_upcasts_f16_and_pops_step():
    tree, _ = io.load_artifact(GEN_ARTIFACT)
    w = tree["params"]["decoder"]["lstm2"]["w_hh_l0_fwd"]
    assert w.dtype == np.float32 and w.shape == (1024, 4096)
    assert "__step__" not in tree


def test_flatten_unflatten_round_trip():
    flat = {"a/b/c": np.ones(2), "a/d": np.zeros(3), "e": np.arange(4)}
    assert io.flatten_params(io.unflatten_params(flat)).keys() == flat.keys()


@pytest.mark.parametrize("dilation", [1, 3])
def test_conv_norm_matches_jax(dilation):
    rng = np.random.RandomState(2)
    x = rng.randn(2, 19, 6).astype(np.float32)
    mod = jax_models.ConvNorm(5, kernel_size=5, dilation=dilation)
    variables = mod.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want = mod.apply(variables, jnp.asarray(x))
    port = _jax_to_torch({"params": {"conv": variables["params"]}}, _Wrap(conv=ConvNorm(6, 5, 5, dilation)))
    with torch.inference_mode():
        got = port.conv(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


def test_linear_norm_matches_jax():
    rng = np.random.RandomState(3)
    x = rng.randn(2, 7, 12).astype(np.float32)
    mod = jax_models.LinearNorm(5)
    variables = mod.init(jax.random.PRNGKey(1), jnp.asarray(x))
    want = mod.apply(variables, jnp.asarray(x))
    port = _jax_to_torch({"params": {"proj": variables["params"]}}, _Wrap(proj=LinearNorm(12, 5)))
    with torch.inference_mode():
        got = port.proj(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


def test_batch_norm_running_stats_match_jax():
    rng = np.random.RandomState(4)
    x = rng.randn(3, 11, 6).astype(np.float32) * 2 + 1
    mod = jax_models.BatchNorm()
    variables = {
        "params": {"BatchNorm_0": {"scale": rng.rand(6).astype(np.float32) + 0.5,
                                   "bias": rng.randn(6).astype(np.float32)}},
        "batch_stats": {"BatchNorm_0": {"mean": rng.randn(6).astype(np.float32),
                                        "var": rng.rand(6).astype(np.float32) + 0.1}},
    }
    want = mod.apply(variables, jnp.asarray(x), use_running_average=True)
    port = _jax_to_torch({"params": {"bn0": variables["params"]},
                          "batch_stats": {"bn0": variables["batch_stats"]}}, _Wrap(bn0=BatchNorm(6)))
    with torch.inference_mode():
        got = port.bn0(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


@pytest.mark.parametrize("bidirectional, num_layers", [(True, 2), (False, 2), (False, 1)])
def test_lstm_layer_matches_jax(bidirectional, num_layers):
    """Hoisted input product + recurrence per layer and direction, forward
    features first."""
    rng = np.random.RandomState(5)
    x = rng.randn(3, 13, 10).astype(np.float32)
    mod = jax_models.LSTM(16, num_layers=num_layers, bidirectional=bidirectional)
    variables = mod.init(jax.random.PRNGKey(3), jnp.asarray(x))
    want = mod.apply(variables, jnp.asarray(x))
    port = _jax_to_torch({"params": {"lstm": variables["params"]}},
                         _Wrap(lstm=LSTM(10, 16, num_layers, bidirectional)))
    with torch.inference_mode():
        got = port.lstm(torch.from_numpy(x))
    assert got.shape == (3, 13, 32 if bidirectional else 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


class _Wrap(torch.nn.Module):
    """Holds one layer under the child name its JAX parameters carry."""

    def __init__(self, **layers):
        super().__init__()
        for name, layer in layers.items():
            self.add_module(name, layer)


def test_seeded_generator_is_reproducible_and_finite():
    a = build_generator(device="cpu", seed=7)
    b = build_generator(device="cpu", seed=7)
    c = build_generator(device="cpu", seed=8)
    for (name, pa), pb in zip(a.state_dict().items(), b.state_dict().values()):
        torch.testing.assert_close(pa, pb, atol=0, rtol=0, msg=name)
    assert not torch.equal(a.decoder.lstm2.w_hh_l0_fwd, c.decoder.lstm2.w_hh_l0_fwd)
    x = torch.rand(1, 32, 80)
    e = torch.randn(1, 256)
    with torch.inference_mode():
        outs = a(x, e, e)
    assert all(bool(torch.isfinite(o).all()) for o in outs)


def test_build_generator_defaults_to_cuda_and_raises_without_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_generator()


def test_encoder_rejects_length_not_multiple_of_freq():
    gen = build_generator(device="cpu", seed=0)
    with pytest.raises(ValueError, match="multiple of freq"):
        gen.encode(torch.zeros(1, 40, 80), torch.zeros(1, 256))
