"""Whether the port's bfloat16 train-step gradients part from JAX's by
chaos or by a rounding point: the comparison of
``tests/test_torch_bf16_train.py`` (f) (the port's ``loss_fn`` in bfloat16
and its gradients against ``jax.value_and_grad`` of JAX's ``loss_fn`` with
``dtype=bfloat16, use_pallas=True``, and JAX float32's distance from JAX
bfloat16 beside it) at the test's narrow widths and at wider layers, where
one bfloat16 flip weighs less in a leaf's sums:

    JAX_PLATFORMS=cpu python scripts/bf16_step_widths.py [--widths 32,64,32 64,128,64 128,256,128]
        [--seeds 1,2 0,1 1,1 0,2]

``--widths`` are (encoder channels, decoder lstm_dim, postnet channels);
``--seeds`` (init seed, batch seed). Prints, a line each, the loss's and
the gradient leaves' distances in training form (a leaf's largest
difference over its ``grad_scale``): the port from JAX bfloat16, JAX
float32 from JAX bfloat16 in brackets, the worst leaf's name for both, and
the port's mean as a share of JAX's own. A rounding point the port misses
keeps the port's share where it is as the layers widen; chaos (flips whose
weight falls with width) takes it down with JAX float32's. CPU only; runs
the JAX side's Pallas kernels in interpret mode.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--widths", nargs="+", default=["32,64,32", "64,128,64", "128,256,128"])
    ap.add_argument("--seeds", nargs="+", default=["1,2", "0,1", "1,1", "0,2"])
    args = ap.parse_args()
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np
    import torch

    from autovc_tpu_torch.config import Config, ModelConfig
    from autovc_tpu_torch.train import loss_fn
    from test_torch_bf16_train import WideGenerator, _jax_loss_and_grads, _leaf_distances, _port_model
    from test_torch_train import NARROW, _batch

    torch.set_num_threads(1)

    for spec in args.widths:
        enc, lstm, post = (int(v) for v in spec.split(","))
        f32 = WideGenerator(**NARROW, enc=enc, lstm=lstm, post=post)
        bf = WideGenerator(**NARROW, enc=enc, lstm=lstm, post=post, dtype=jnp.bfloat16, use_pallas=True)
        cfg = Config(model=ModelConfig(**NARROW, enc_channels=enc, dec_lstm_dim=lstm, postnet_channels=post,
                                       compute_dtype="bfloat16", use_pallas_lstm=True))
        for seeds in args.seeds:
            init, batch = (int(v) for v in seeds.split(","))
            t0 = time.perf_counter()
            x0, e0 = _batch(100)
            variables = f32.init(jax.random.PRNGKey(init), jnp.asarray(x0), jnp.asarray(e0), jnp.asarray(e0))
            params, stats = variables["params"], variables["batch_stats"]
            x, emb = _batch(batch)
            loss32, g32 = _jax_loss_and_grads(f32, params, stats, x, emb, True)
            loss_bf, g_bf = _jax_loss_and_grads(bf, params, stats, x, emb, True)
            model = _port_model(params, stats, cfg)
            total, _ = loss_fn(model, cfg, torch.from_numpy(x), torch.from_numpy(emb), train=True)
            total.backward()
            got = {n: p.grad for n, p in model.named_parameters()}
            names = list(got)
            port, own = _leaf_distances(got, g_bf, names), _leaf_distances(g32, g_bf, names)
            loss_apart = abs(float(total.detach()) - loss_bf) / abs(loss_bf)
            print(f"widths {enc}/{lstm}/{post} seeds ({init}, {batch}): loss {loss_apart:.2e} "
                  f"({abs(loss_bf - loss32) / abs(loss32):.2e}); gradients worst {port.max():.3f} "
                  f"[{names[int(np.argmax(port))]}] ({own.max():.3f} [{names[int(np.argmax(own))]}]), mean "
                  f"{port.mean():.3f} ({own.mean():.3f}), share of JAX's own mean {port.mean() / own.mean():.2f}, "
                  f"worst {port.max() / own.max():.2f} ({time.perf_counter() - t0:.0f} s)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
