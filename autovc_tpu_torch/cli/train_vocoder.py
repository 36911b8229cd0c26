"""Train a vocoder: WaveNet (MoL NLL, noam schedule, EMA) or HiFi-GAN
(reconstruction pretraining, or ``--gan`` the adversarial fine-tune) on the
(waveform, spmel) pairs of a corpus.

    python -m autovc_tpu_torch.cli.train_vocoder --main_dir DIR
        [--vocoder wavenet|hifigan] [--gan] [--num_iters N] [--batch_size B]
        [--max_time 8000] [--frames 32] [--lr LR] [--log_step N] [--out CKPT.npz]
        [--seed S] [--init CKPT.npz] [--init_step N] [--save_every N]
        [--feat_weight W] [--device cuda|cpu]

Counterpart of ``autovc_tpu/cli/train_vocoder.py``, with its flags and
``--device`` (default cuda; cpu runs the plain PyTorch versions). The
corpus is every ``<main_dir>/spmel/<speaker>/<utt>.npy`` that has a
``<wav dir>/<speaker>/<utt>.wav`` (the wav dir is the first of
``wav48_silence_trimmed``, ``wavs`` and ``wav`` under ``main_dir``), which
``cli.make_spect`` writes. The checkpoint (default
``<main_dir>/<vocoder>_vocoder.npz``) is the ``.npz`` that ``cli.synthesize
--vocoder_ckpt`` and ``cli.evaluate_vocoder`` read in both packages (the
WaveNet's EMA weights); WaveNet and the GAN also write
``<out>.train_state.npz``, which ``--init`` resumes from when it sits beside
the checkpoint. The networks have the published widths
(``WaveNetConfig``, ``HiFiGANConfig``).
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from autovc_tpu_torch import exact_f32, resolve_device
from autovc_tpu_torch.config import AudioConfig, HiFiGANConfig, WaveNetConfig
from autovc_tpu_torch.dsp import read_wav


def load_corpus(main_dir: str, audio_sr: int = 16_000) -> tuple[list[np.ndarray], list[np.ndarray]]:
    """All (waveform, mel) pairs of ``<main_dir>/{wavs,spmel}``."""
    wav_root = next((os.path.join(main_dir, c) for c in ("wav48_silence_trimmed", "wavs", "wav")
                     if os.path.isdir(os.path.join(main_dir, c))), None)
    if wav_root is None:
        raise SystemExit(f"no wav dir under {main_dir}")
    mel_root = os.path.join(main_dir, "spmel")
    wavs, mels = [], []
    for spk in sorted(os.listdir(mel_root)):
        spk_mel = os.path.join(mel_root, spk)
        if not os.path.isdir(spk_mel):
            continue
        for f in sorted(os.listdir(spk_mel)):
            wav_path = os.path.join(wav_root, spk, f[:-4] + ".wav")
            if not f.endswith(".npy") or not os.path.exists(wav_path):
                continue
            wavs.append(read_wav(wav_path, audio_sr)[0])
            mels.append(np.load(os.path.join(spk_mel, f)))
    if not wavs:
        raise SystemExit("no (wav, mel) pairs found: run make_spect first")
    return wavs, mels


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--main_dir", required=True)
    ap.add_argument("--vocoder", default="wavenet", choices=["wavenet", "hifigan"])
    ap.add_argument("--num_iters", type=int, default=200_000)
    ap.add_argument("--batch_size", type=int, default=2)
    ap.add_argument("--max_time", type=int, default=8000, help="wavenet crop samples (hparams.py:150)")
    ap.add_argument("--frames", type=int, default=32, help="hifigan crop frames")
    ap.add_argument("--lr", type=float, default=None)
    ap.add_argument("--log_step", type=int, default=50)
    ap.add_argument("--out", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--gan", action="store_true",
                    help="hifigan: the adversarial objective (MPD+MSD, feature matching, mel L1) instead of "
                         "reconstruction-only pretraining")
    ap.add_argument("--init", default=None,
                    help="warm-start from an .npz checkpoint (hifigan: the generator; wavenet: parameters and "
                         "EMA, a fresh optimizer unless <init>.train_state.npz exists)")
    ap.add_argument("--init_step", type=int, default=0,
                    help="wavenet: offset the noam schedule by this many steps")
    ap.add_argument("--save_every", type=int, default=0, help="also checkpoint to --out every N iters (0 = at the end)")
    ap.add_argument("--feat_weight", type=float, default=0.0,
                    help="hifigan: an L1 on the normalized mel features (evaluate_vocoder's metric)")
    ap.add_argument("--device", default="cuda", help="cuda (the kernels) or cpu (the plain versions)")
    return ap


def main(argv: list[str] | None = None):
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    audio = AudioConfig()
    wavs, mels = load_corpus(args.main_dir, audio.sample_rate)
    print(f"[train_vocoder] corpus: {len(wavs)} utterances")
    rng = np.random.default_rng(args.seed)
    out = args.out or os.path.join(args.main_dir, f"{args.vocoder}_vocoder.npz")
    state = args.init + ".train_state.npz" if args.init else None

    if args.vocoder == "wavenet":
        from autovc_tpu_torch.vocoder.train_wavenet import WaveNetTrainer, crop_batch

        trainer = WaveNetTrainer(WaveNetConfig(), lr=args.lr or 1e-3, seed=args.seed, init_step=args.init_step,
                                 device=device)
        if args.init:
            trainer.load(args.init)
            print(f"[train_vocoder] warm-start wavenet from {args.init} (noam schedule offset {args.init_step})")
            if os.path.exists(state):
                trainer.restore_train_state(state)
                print(f"[train_vocoder] restored wavenet train state from {state}")

        def batches():
            while True:
                yield crop_batch(wavs, mels, args.batch_size, args.max_time, audio.hop_length, rng)
    else:
        from autovc_tpu_torch.vocoder.train_hifigan import HiFiGANGANTrainer, HiFiGANTrainer, hifigan_crop_batch

        init = None
        if args.init:
            with np.load(args.init) as z:
                init = {k: z[k] for k in z.files}
            print(f"[train_vocoder] warm-start generator from {args.init}")
        if args.gan:
            trainer = HiFiGANGANTrainer(HiFiGANConfig(), audio, lr=args.lr or 2e-4, seed=args.seed,
                                        feat_weight=args.feat_weight, generator_params=init, device=device)
            if args.init and os.path.exists(state):
                trainer.restore_train_state(state)
                print(f"[train_vocoder] restored GAN train state from {state}")
        else:
            trainer = HiFiGANTrainer(HiFiGANConfig(), audio, lr=args.lr or 2e-4, seed=args.seed,
                                     feat_weight=args.feat_weight, device=device)
            if init is not None:
                trainer.load_generator(init)

        def batches():
            while True:
                yield hifigan_crop_batch(wavs, mels, args.batch_size, args.frames, audio.hop_length, rng)

    gan = args.vocoder == "hifigan" and args.gan
    train_fn = trainer.train_gan if gan else trainer.train
    chunk = args.save_every if 0 < args.save_every < args.num_iters else args.num_iters
    done = 0
    with exact_f32(device):
        while done < args.num_iters:
            n = min(chunk, args.num_iters - done)
            train_fn(batches(), n, log_step=args.log_step)
            done += n
            trainer.save(out)
            if args.vocoder == "wavenet" or gan:
                trainer.save_train_state(out + ".train_state.npz")
            if done < args.num_iters:
                print(f"[train_vocoder] checkpointed {out} @ {done}/{args.num_iters}")
    print(f"[train_vocoder] saved {out}")
    return trainer


if __name__ == "__main__":
    main()
