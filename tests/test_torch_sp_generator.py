"""The port's sequence-parallel Generator (``convert.sequence_parallel
.SPGenerator``) on the CPU against the JAX package's SPGenerator and its
dense Generator at the published widths, T=256: 4 ranks along 'seq', and
2 x 2 (data x seq), each a gloo world of spawned processes
(``parallel.launch.run_world``). The ranks import this module by name to
find their work, so it imports JAX only inside the tests."""

import numpy as np
import pytest
import torch

from autovc_tpu_torch.config import ModelConfig
from autovc_tpu_torch.convert.sequence_parallel import SPGenerator
from autovc_tpu_torch.models import build_generator
from autovc_tpu_torch.parallel import mesh as pmesh
from autovc_tpu_torch.parallel.launch import run_world

torch.set_num_threads(1)

# tests/test_parallel.py's tolerances of the whole generator against the dense one
CODES_TOL, ID_TOL, PSNT_TOL = 2e-5, 2e-4, 2e-3


def _sp_world(dev, inp: dict, shape: dict, batch_axis):
    mesh = pmesh.mesh_over(shape, dev)
    gen = build_generator(ModelConfig(), device="cpu")
    gen.load_state_dict(inp["gen_state"])
    x, c_org, c_trg = (inp[k] for k in ("gen_x", "gen_c_org", "gen_c_trg"))
    return [o.numpy() for o in SPGenerator(gen, mesh, batch_axis=batch_axis)(x, c_org, c_trg)]


@pytest.fixture(scope="module")
def dense():
    """JAX's dense Generator at the published widths on (2, 256, 80), as
    tests/test_parallel.py initialises it, its outputs, and the port state
    dict of its weights."""
    import jax
    import jax.numpy as jnp

    from autovc_tpu.config import ModelConfig as JaxModelConfig
    from autovc_tpu.models import build_generator as jax_build_generator
    from autovc_tpu_torch.io import generator_state_from_jax

    model = jax_build_generator(JaxModelConfig(model_type="spmel"))
    rng = np.random.RandomState(7)
    x = rng.rand(2, 256, 80).astype(np.float32)
    c_org = rng.randn(2, 256).astype(np.float32)
    c_trg = rng.randn(2, 256).astype(np.float32)
    variables = model.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(c_org), jnp.asarray(c_trg),
                           train=False)
    out = [np.asarray(o) for o in model.apply(variables, x, c_org, c_trg, train=False)]
    state = generator_state_from_jax(jax.tree_util.tree_map(np.asarray, variables))
    return dict(gen_x=x, gen_c_org=c_org, gen_c_trg=c_trg, gen_state=state), variables, out


def _jax_sp(variables, inp, mesh, batch_axis=None):
    from autovc_tpu.config import ModelConfig as JaxModelConfig
    from autovc_tpu.convert.sequence_parallel import SPGenerator as JaxSPGenerator

    sp = JaxSPGenerator(variables["params"], variables["batch_stats"], JaxModelConfig(model_type="spmel"), mesh,
                        batch_axis=batch_axis)
    return [np.asarray(o) for o in sp(inp["gen_x"], inp["gen_c_org"], inp["gen_c_trg"])]


def _assert_generator(got, sp_want, dense_want):
    x_id, x_psnt, codes = got
    for tol, g, w_sp, w_dense in ((CODES_TOL, codes, sp_want[2], dense_want[2]),
                                  (ID_TOL, x_id, sp_want[0], dense_want[0]),
                                  (PSNT_TOL, x_psnt, sp_want[1], dense_want[1])):
        assert g.shape == w_dense.shape
        np.testing.assert_allclose(g, w_sp, atol=tol, rtol=0)
        np.testing.assert_allclose(g, w_dense, atol=tol, rtol=0)


def test_sp_generator_matches_jax(dense):
    """T=256 over 4 ranks: codes, x_identic and x_psnt against JAX's
    SPGenerator on 4 devices and the dense JAX Generator, every rank holding
    the global outputs."""
    import jax
    from jax.sharding import Mesh

    inp, variables, dense_want = dense
    sp_want = _jax_sp(variables, inp, Mesh(np.asarray(jax.devices()[:4]), ("seq",)))
    got = run_world(_sp_world, 4, inp, {"seq": 4}, None, device="cpu", threads=1)
    _assert_generator(got[0], sp_want, dense_want)
    for rank in got[1:]:
        for a, b in zip(rank, got[0]):
            np.testing.assert_array_equal(a, b)


def test_sp_generator_data_x_sequence_matches_jax(dense):
    """2 x 2 (data x seq): B=2 over 'data', T=256 over 'seq', against JAX's
    SPGenerator on a 2 x 4 mesh (batch_axis='data') and the dense
    Generator."""
    import jax
    from jax.sharding import Mesh

    inp, variables, dense_want = dense
    sp_want = _jax_sp(variables, inp, Mesh(np.asarray(jax.devices()[:8]).reshape(2, 4), ("data", "seq")), "data")
    got = run_world(_sp_world, 4, inp, {"data": 2, "seq": 2}, "data", device="cpu", threads=1)
    _assert_generator(got[0], sp_want, dense_want)
    _assert_generator(got[3], sp_want, dense_want)
