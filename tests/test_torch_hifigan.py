"""The port's HiFi-GAN (autovc_tpu_torch.vocoder.hifigan) against the JAX
package's, on the committed vocoder weights and on seeded random layers."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from autovc_tpu.config import HiFiGANConfig as JaxHiFiGANConfig
from autovc_tpu.models.layers import ConvTranspose1d as JaxConvTranspose1d
from autovc_tpu.vocoder.hifigan import HiFiGANVocoder as JaxHiFiGANVocoder
from autovc_tpu.vocoder.hifigan import ResBlock1 as JaxResBlock1
from autovc_tpu_torch import io
from autovc_tpu_torch.config import HiFiGANConfig
from autovc_tpu_torch.vocoder.hifigan import HiFiGANGenerator, HiFiGANVocoder, ResBlock1

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOC_ARTIFACT = os.path.join(REPO, "artifacts", "hifigan.npz")
ATOL = 1e-4  # f32 on both sides; 4 upsampling stages of convs in different summation orders


def _params(variables):
    return jax.tree_util.tree_map(np.asarray, dict(variables["params"]))


@pytest.fixture(scope="module")
def vocoders():
    jax_voc = JaxHiFiGANVocoder.from_checkpoint(JaxHiFiGANConfig(), VOC_ARTIFACT)
    torch_voc = HiFiGANVocoder.from_checkpoint(HiFiGANConfig(), VOC_ARTIFACT, device="cpu")
    return jax_voc, torch_voc


def test_hifigan_matches_jax_on_committed_weights(vocoders):
    jax_voc, torch_voc = vocoders
    mel = np.random.RandomState(0).rand(1, 32, 80).astype(np.float32)
    want = np.asarray(jax_voc.generate(mel))
    got = torch_voc.generate(mel).numpy()
    assert got.shape == want.shape == (1, 32 * 256)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_generate_takes_unbatched_mel(vocoders):
    _, torch_voc = vocoders
    mel = np.random.RandomState(1).rand(16, 80).astype(np.float32)
    wav = torch_voc.generate(mel)
    assert wav.shape == (16 * 256,)
    torch.testing.assert_close(wav, torch_voc.generate(mel[None])[0], atol=1e-6, rtol=0)


def test_hifigan_state_round_trip_covers_every_artifact_key():
    tree, _ = io.load_artifact(VOC_ARTIFACT)
    with np.load(VOC_ARTIFACT) as z:
        flat = {k: z[k] for k in z.files if k != "__step__"}
    state = io.hifigan_state_from_jax(tree)
    HiFiGANGenerator().load_state_dict(state, strict=True)  # every module key, no extras
    back = {}
    for key, value in state.items():
        *path, leaf = key.split(".")
        arr = value.numpy()
        back["/".join(path + [{"weight": "kernel"}.get(leaf, leaf)])] = (
            arr.transpose(2, 1, 0) if leaf == "weight" else arr)
    assert sorted(back) == sorted(flat)
    for key, value in flat.items():
        np.testing.assert_array_equal(back[key], value, err_msg=key)


@pytest.mark.parametrize("kernel, rate", [(16, 8), (4, 2)])
def test_conv_transpose_layout_and_padding_match_jax(kernel, rate):
    """JAX kernel (k, out, in) -> torch (in, out, k); padding (k - rate) // 2."""
    rng = np.random.RandomState(2)
    x = rng.randn(2, 9, 6).astype(np.float32)
    mod = JaxConvTranspose1d(4, kernel_size=kernel, stride=rate, padding=(kernel - rate) // 2)
    variables = mod.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want = np.asarray(mod.apply(variables, jnp.asarray(x)))
    layer = torch.nn.ConvTranspose1d(6, 4, kernel, stride=rate, padding=(kernel - rate) // 2)
    state = io.hifigan_state_from_jax(_params(variables))
    layer.load_state_dict(state, strict=True)
    with torch.inference_mode():
        got = layer(torch.from_numpy(x).transpose(1, 2)).transpose(1, 2).numpy()
    assert got.shape == want.shape == (2, 9 * rate, 4)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("kernel", [3, 7, 11])
def test_resblock_matches_jax(kernel):
    rng = np.random.RandomState(3)
    x = rng.randn(2, 30, 8).astype(np.float32)
    mod = JaxResBlock1(8, kernel, (1, 3, 5))
    variables = mod.init(jax.random.PRNGKey(1), jnp.asarray(x))
    want = np.asarray(mod.apply(variables, jnp.asarray(x)))
    block = ResBlock1(8, kernel, (1, 3, 5))
    block.load_state_dict(io.hifigan_state_from_jax(_params(variables)), strict=True)
    with torch.inference_mode():
        got = block(torch.from_numpy(x).transpose(1, 2)).transpose(1, 2).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_seeded_vocoder_is_reproducible_and_bounded():
    cfg = HiFiGANConfig(upsample_initial_channel=32)
    mel = torch.rand(1, 8, 80)
    a = HiFiGANVocoder(cfg, device="cpu", seed=3).generate(mel)
    b = HiFiGANVocoder(cfg, device="cpu", seed=3).generate(mel)
    torch.testing.assert_close(a, b, atol=0, rtol=0)
    assert a.shape == (1, 8 * 256) and bool((a.abs() <= 1).all())


def test_vocoder_defaults_to_cuda_and_raises_without_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        HiFiGANVocoder.from_checkpoint(HiFiGANConfig(), VOC_ARTIFACT)


@pytest.mark.parametrize("path", [None, VOC_ARTIFACT])
def test_from_checkpoint_takes_the_jax_arguments(path):
    """``from_checkpoint(cfg, path)`` as JAX's takes them, on a narrow
    config for None (seeded weights, compared for shape and finiteness
    only: the two packages' seeds draw differently) and the committed
    artifact (JAX's weights exactly). A torch checkpoint:
    tests/test_torch_interop.py."""
    kw = dict(upsample_initial_channel=32) if path is None else {}
    jax_voc = JaxHiFiGANVocoder.from_checkpoint(JaxHiFiGANConfig(**kw), path)
    port = HiFiGANVocoder.from_checkpoint(HiFiGANConfig(**kw), path, device="cpu")
    want = io.hifigan_state_from_jax(_params({"params": jax_voc.params}))
    got = port.model.state_dict()
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k].shape == v.shape and bool(torch.isfinite(got[k]).all()), k
        if path is not None:
            assert torch.equal(got[k], v), k
