"""The port's conversion entry point (autovc_tpu_torch.convert) against the
JAX package's Converter on the committed spmel weights, and the port's
independence from JAX."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from autovc_tpu.cli.export_ckpt import load_artifact as jax_load_artifact
from autovc_tpu.config import Config
from autovc_tpu.convert import Converter as JaxConverter
from autovc_tpu.convert import pad_seq as jax_pad_seq
from autovc_tpu.data.manifest import ConversionSpec
from autovc_tpu.models import build_generator as jax_build_generator
from autovc_tpu_torch.config import ModelConfig
from autovc_tpu_torch.convert import Converter, pad_seq
from autovc_tpu_torch.models import build_generator

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GEN_ARTIFACT = os.path.join(REPO, "artifacts", "generator_spmel_f16.npz")
ATOL = 1e-4  # f32 on both sides


def _spec(rng, t, i):
    emb = rng.randn(2, 256).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    return ConversionSpec(conversion_id=i, src_name=f"u{i}", src_embedding=emb[0],
                          src_features=rng.rand(t, 80).astype(np.float32),
                          trg_speaker="trg", trg_embedding=emb[1])


@pytest.fixture(scope="module")
def converters():
    variables, _ = jax_load_artifact(GEN_ARTIFACT)
    jax_conv = JaxConverter(jax_build_generator(Config().model), variables["params"],
                            variables["batch_stats"], Config())
    port = Converter(build_generator(ModelConfig(), artifact=GEN_ARTIFACT, device="cpu"))
    return jax_conv, port


@pytest.mark.parametrize("t", [1, 32, 45, 64])
def test_pad_seq_matches_jax(t):
    x = np.random.RandomState(t).rand(t, 80).astype(np.float32)
    got, got_pad = pad_seq(x, 32)
    want, want_pad = jax_pad_seq(x, 32)
    assert got_pad == want_pad
    np.testing.assert_array_equal(got, want)


def test_convert_batch_matches_jax_on_two_lengths(converters):
    """Two specs that pad to 64 and 96 frames: two groups, padding stripped."""
    jax_conv, port = converters
    rng = np.random.RandomState(0)
    specs = [_spec(rng, 45, 0), _spec(rng, 70, 1)]
    want = jax_conv.convert_batch(specs, batch_size=2)
    got = port.convert_batch(specs, batch_size=2)
    assert [g.shape for g in got] == [(45, 80), (70, 80)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=0)


def test_convert_matches_jax(converters):
    jax_conv, port = converters
    spec = _spec(np.random.RandomState(1), 40, 0)
    got = port.convert(spec)
    assert got.shape == (40, 80)
    np.testing.assert_allclose(got, jax_conv.convert(spec), atol=ATOL, rtol=0)


def test_convert_batch_groups_and_keeps_order(converters):
    """A short group is zero-filled; every result equals its single conversion."""
    _, port = converters
    rng = np.random.RandomState(2)
    specs = [_spec(rng, 30, 0), _spec(rng, 64, 1), _spec(rng, 20, 2)]
    got = port.convert_batch(specs, batch_size=2)
    assert [g.shape[0] for g in got] == [30, 64, 20]
    for g, s in zip(got, specs):
        np.testing.assert_allclose(g, port.convert(s), atol=1e-5, rtol=0)


def test_port_and_chip_smoke_import_without_jax():
    """With jax, flax, pandas and autovc_tpu blocked, every module of the
    port (the WaveNet, training, feature-extraction, speaker-encoder,
    synthesis, wav-variant, conversion and evaluation modules among them)
    and chip_smoke still import."""
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'flax', 'pandas', 'autovc_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import importlib, pkgutil, autovc_tpu_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(autovc_tpu_torch.__path__, 'autovc_tpu_torch.')]\n"
        "assert {'autovc_tpu_torch.ops.wavenet', 'autovc_tpu_torch.vocoder.wavenet', 'autovc_tpu_torch.losses',\n"
        "        'autovc_tpu_torch.data.dataset', 'autovc_tpu_torch.data.manifest', 'autovc_tpu_torch.data.prefetch',\n"
        "        'autovc_tpu_torch.train.solver', 'autovc_tpu_torch.train.step', 'autovc_tpu_torch.train.state',\n"
        "        'autovc_tpu_torch.train.schedule', 'autovc_tpu_torch.train.metrics', 'autovc_tpu_torch.train.profiler',\n"
        "        'autovc_tpu_torch.train.watch', 'autovc_tpu_torch.train.compare',\n"
        "        'autovc_tpu_torch.cli.train', 'autovc_tpu_torch.dsp', 'autovc_tpu_torch.dsp.mel',\n"
        "        'autovc_tpu_torch.dsp.audio_io', 'autovc_tpu_torch.dsp.filters', 'autovc_tpu_torch.dsp.stft',\n"
        "        'autovc_tpu_torch.dsp.features', 'autovc_tpu_torch.ops.mel', 'autovc_tpu_torch.ops.sosfilt',\n"
        "        'autovc_tpu_torch.cli.make_spect', 'autovc_tpu_torch.models.dvector', 'autovc_tpu_torch.eval',\n"
        "        'autovc_tpu_torch.eval.fidelity', 'autovc_tpu_torch.data.metadata_builder',\n"
        "        'autovc_tpu_torch.train.ge2e', 'autovc_tpu_torch.cli.make_metadata',\n"
        "        'autovc_tpu_torch.cli.evaluate_speaker_encoder', 'autovc_tpu_torch.cli.synthesize',\n"
        "        'autovc_tpu_torch.vocoder.griffinlim', 'autovc_tpu_torch.models.convtas',\n"
        "        'autovc_tpu_torch.cli.convert', 'autovc_tpu_torch.cli.evaluate',\n"
        "        'autovc_tpu_torch.cli.evaluate_conversion'} <= set(mods), mods\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "from autovc_tpu_torch.vocoder import WaveNetVocoder\n"
        "from autovc_tpu_torch.config import WaveNetConfig\n"
        "import chip_smoke\n"
        "print(len(mods))\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO, PYTHONDONTWRITEBYTECODE="1")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 49
