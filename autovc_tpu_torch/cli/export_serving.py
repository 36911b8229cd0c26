"""Export a serving bundle: exported, shape-polymorphic conversion programs.

    python -m autovc_tpu_torch.cli.export_serving --artifact gen.npz --out DIR
        [--hifigan hifigan.npz] [--vocoder_mode hifigan|hybrid] [--gl_iters 2]
        [--platforms cuda[,cpu]] [--model_type spmel|stft]
        [--compute_dtype float32|bfloat16]

Counterpart of ``autovc_tpu/cli/export_serving.py``, with its flags: a
generator artifact (``cli.export_ckpt``, ``cli.train --export`` or the JAX
package's) -> a bundle directory (``autovc_tpu_torch.serve``) of the
converter program (any batch, any multiple of freq frames), optionally the
vocoder program, the weights and a manifest, one program per platform of
--platforms (cuda needs a card). --hifigan takes an exported .npz or a
public torch HiFi-GAN checkpoint (``.pt``/``.pth``/``.ckpt``, through
``interop.hifigan_params_from_torch``);
--vocoder_mode hybrid bakes --gl_iters Griffin-Lim projections seeded by
the neural phase into the vocoder program (``vocoder.hybrid``). Load the
bundle with ``serve.ServingConverter`` or serve it with ``cli.serve``, on
the torch version that wrote it.
"""

from __future__ import annotations

import argparse

from autovc_tpu_torch.config import Config, HiFiGANConfig, ModelConfig


def main(argv=None) -> str:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--artifact", required=True, help="generator .npz (cli.export_ckpt)")
    ap.add_argument("--out", required=True, help="output bundle directory")
    ap.add_argument("--hifigan", default=None,
                    help="HiFi-GAN .npz or torch checkpoint: add the waveform-synthesis program")
    ap.add_argument("--vocoder_mode", default="hifigan", choices=["hifigan", "hybrid"],
                    help="hybrid bakes Griffin-Lim magnitude projections seeded by the neural phase into the "
                         "vocoder program (vocoder/hybrid.py)")
    ap.add_argument("--gl_iters", type=int, default=2, help="hybrid mode: Griffin-Lim refinement iterations")
    ap.add_argument("--platforms", default="cuda", help="comma-separated: cuda, cpu")
    ap.add_argument("--model_type", default="spmel", choices=["spmel", "stft"])
    ap.add_argument("--compute_dtype", default="float32", choices=["float32", "bfloat16"],
                    help="compute precision of the exported programs")
    args = ap.parse_args(argv)

    from autovc_tpu_torch.io import conv_state_to_jax, load_artifact, unflatten_params
    from autovc_tpu_torch.serve import export_converter

    cfg = Config(model=ModelConfig(model_type=args.model_type, compute_dtype=args.compute_dtype),
                 hifigan=HiFiGANConfig())
    variables, step = load_artifact(args.artifact)
    hparams = None
    if args.hifigan:
        from autovc_tpu_torch.vocoder.hifigan import HiFiGANVocoder

        voc = HiFiGANVocoder.from_checkpoint(cfg.hifigan, args.hifigan, device="cpu")
        hparams = unflatten_params(conv_state_to_jax(voc.model.state_dict()))
    out = export_converter(variables, cfg, args.out, hifigan_params=hparams,
                           platforms=[p.strip() for p in args.platforms.split(",") if p.strip()],
                           gl_iters=args.gl_iters if args.vocoder_mode == "hybrid" else None)
    voc_desc = "none"
    if hparams is not None:
        voc_desc = args.vocoder_mode + (f"(gl_iters={args.gl_iters})" if args.vocoder_mode == "hybrid" else "")
    print(f"[export_serving] wrote {out} (generator step {step}, compute {args.compute_dtype}, vocoder={voc_desc})")
    return out


if __name__ == "__main__":
    main()
