"""Exports one serving bundle of ``chip_smoke.py`` phase 12 in a process of
its own, so that the phase exports its five bundles at once:

    python3 scripts/serve_exports.py OUT_DIR NAME [--trained]

NAME is one of BUNDLES: the float32, bfloat16 (the scan rounding) and
bfloat16 Pallas-rounding spmel bundles of 12a, the stft and hybrid bundles
of 12b. The weights are ``serving_weights``' (seeded, as chip_smoke.py
draws them; with --trained the committed artifacts), the stft generator
seeded apart (``variant_weights``). Writes the bundle to OUT_DIR/NAME
(``serve.export_converter`` for the card) and ``{"export_s": ...,
"export_cpu_s": ...}``, the wall and the process's CPU seconds of that call
(one thread: what the export costs where it runs alone), to
OUT_DIR/NAME.json. Needs a CUDA card (export
traces the card's programs).
"""

from __future__ import annotations

import json
import os
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from autovc_tpu_torch.config import Config, ModelConfig  # noqa: E402
from autovc_tpu_torch.models import build_generator  # noqa: E402
from autovc_tpu_torch.vocoder.hifigan import HiFiGANVocoder  # noqa: E402

# name -> (the generator's ModelConfig, with the HiFi-GAN program, gl_iters)
BUNDLES = {"f32": (ModelConfig(), True, None),
           "bf16": (ModelConfig(compute_dtype="bfloat16"), True, None),
           "bf16_pallas": (ModelConfig(compute_dtype="bfloat16", use_pallas_lstm=True), False, None),
           "stft": (ModelConfig(model_type="stft"), True, None),
           "hybrid": (ModelConfig(), True, 2)}


def serving_weights(trained: bool) -> tuple[dict, dict]:
    """The JAX-layout trees a bundle takes: phase 2's generator and HiFi-GAN
    (seeded, or the artifacts)."""
    from autovc_tpu_torch.io import conv_state_to_jax, generator_state_to_jax, load_artifact, unflatten_params

    art = ROOT / "artifacts"
    if trained:
        return load_artifact(str(art / "generator_spmel_f16.npz"))[0], load_artifact(str(art / "hifigan.npz"))[0]
    gen = build_generator(ModelConfig(), device="cpu", seed=1)
    voc = HiFiGANVocoder(device="cpu", seed=2)
    return generator_state_to_jax(gen.state_dict()), unflatten_params(conv_state_to_jax(voc.model.state_dict()))


def variant_weights(name: str, variables: dict) -> dict:
    """The generator tree of bundle ``name``: the stft bundle's a seeded
    513-bin generator of its own, the others ``variables``."""
    from autovc_tpu_torch.io import generator_state_to_jax

    if name != "stft":
        return variables
    return generator_state_to_jax(build_generator(BUNDLES["stft"][0], device="cpu", seed=3).state_dict())


def main(argv: list[str] | None = None) -> None:
    from autovc_tpu_torch.serve import export_converter

    args = sys.argv[1:] if argv is None else argv
    out_dir, name, trained = args[0], args[1], "--trained" in args[2:]
    torch.set_num_threads(1)
    variables, hifigan = serving_weights(trained)
    mcfg, with_voc, gl_iters = BUNDLES[name]
    t0, cpu0 = time.perf_counter(), time.process_time()
    export_converter(variant_weights(name, variables), Config(model=mcfg), os.path.join(out_dir, name),
                     hifigan_params=hifigan if with_voc else None, platforms=("cuda",), gl_iters=gl_iters)
    with open(os.path.join(out_dir, f"{name}.json"), "w") as f:
        json.dump({"export_s": time.perf_counter() - t0, "export_cpu_s": time.process_time() - cpu0}, f)


if __name__ == "__main__":
    main()
