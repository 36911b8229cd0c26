"""HiFi-GAN training: reconstruction pretraining (log-mel L1 and the
multi-resolution STFT loss) and the adversarial fine-tune against the MPD
and MSD discriminators.

Counterpart of ``autovc_tpu/vocoder/train_hifigan.py``. The generator and
the discriminators are convolutions (cuDNN on a card; no Pallas kernel in
JAX), the STFTs cuFFT, the mel projection a ``torch.matmul``, as they are
plain XLA in JAX. Both optimizers are optax's ``adamw(lr, b1=0.8,
b2=0.99)``: the generator's with weight decay 0, the discriminators' with
optax's default 1e-4 (torch's ``AdamW``, whose decoupled decay is the same
update). ``save`` writes the flat ``.npz`` that ``HiFiGANVocoder
.from_checkpoint`` reads in both packages; the GAN trainer's
``save_train_state`` and ``restore_train_state`` the JAX trainer's resume
file (``d/<path>`` of the discriminators, ``g_opt/<i>`` and ``d_opt/<i>``
optax's Adam leaves in ``jax.tree_util`` order).
"""

from __future__ import annotations

import os
import time
from typing import Iterator

import numpy as np
import torch

from autovc_tpu_torch import exact_f32, resolve_device
from autovc_tpu_torch.config import AudioConfig, HiFiGANConfig
from autovc_tpu_torch.dsp.mel import mel_filterbank
from autovc_tpu_torch.dsp.stft import stft_magnitude
from autovc_tpu_torch.io import conv_state_to_jax, hifigan_state_from_jax, unflatten_params
from autovc_tpu_torch.ops.mel import normalize_db
from autovc_tpu_torch.train.optax_state import JaxLeaves
from autovc_tpu_torch.vocoder.discriminators import (HiFiGANDiscriminators, discriminator_loss,
                                                     feature_matching_loss, generator_adversarial_loss)
from autovc_tpu_torch.vocoder.hifigan import HiFiGANGenerator

RESOLUTIONS = ((512, 128), (1024, 256), (2048, 512))


def multi_resolution_stft_loss(y_hat: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The mean over RESOLUTIONS of the spectral convergence (the Frobenius
    norm of the magnitudes' difference over the whole batch, over the
    target's, + 1e-6) plus the L1 of the log magnitudes (+ 1e-5)."""
    total = 0.0
    for n_fft, hop in RESOLUTIONS:
        m_hat, m = stft_magnitude(y_hat, n_fft, hop), stft_magnitude(y, n_fft, hop)
        sc = torch.linalg.vector_norm(m - m_hat) / (torch.linalg.vector_norm(m) + 1e-6)
        mag = torch.mean(torch.abs(torch.log(m + 1e-5) - torch.log(m_hat + 1e-5)))
        total = total + sc + mag
    return total / len(RESOLUTIONS)


def mel_basis(audio: AudioConfig, device: torch.device | str = "cpu") -> torch.Tensor:
    """The (bins, n_mels) float32 mel basis of the feature contract."""
    fb = mel_filterbank(audio.sample_rate, audio.n_fft, audio.n_mels, audio.mel_fmin, audio.mel_fmax)
    return torch.from_numpy(np.asarray(fb, np.float32)).to(device)


def log_mel_l1(y_hat: torch.Tensor, y: torch.Tensor, basis: torch.Tensor, audio: AudioConfig) -> torch.Tensor:
    mh = stft_magnitude(y_hat, audio.n_fft, audio.hop_length) @ basis
    m = stft_magnitude(y, audio.n_fft, audio.hop_length) @ basis
    return torch.mean(torch.abs(torch.log(mh + 1e-5) - torch.log(m + 1e-5)))


def feature_mel_l1(y_hat: torch.Tensor, y: torch.Tensor, basis: torch.Tensor, audio: AudioConfig) -> torch.Tensor:
    """The L1 between the normalized mel features (``normalize_db`` of the
    mel): the metric ``cli.evaluate_vocoder`` reports."""
    mh = stft_magnitude(y_hat, audio.n_fft, audio.hop_length) @ basis
    m = stft_magnitude(y, audio.n_fft, audio.hop_length) @ basis
    fh = normalize_db(mh, audio.ref_level_db, audio.min_level_db)
    f = normalize_db(m, audio.ref_level_db, audio.min_level_db)
    return torch.mean(torch.abs(fh - f))


def _from_flat(flat):
    """Flat JAX conv parameters (the generator's or the discriminators') ->
    a state dict."""
    return hifigan_state_from_jax(unflatten_params(flat))


class HiFiGANTrainer:
    """Reconstruction pretraining of a HiFi-GAN generator drawn from
    ``seed`` on ``device``: ``mel_weight`` x log-mel L1 + the
    multi-resolution STFT loss (+ ``feat_weight`` x the feature-mel L1)."""

    def __init__(self, cfg: HiFiGANConfig, audio: AudioConfig = AudioConfig(), lr: float = 2e-4,
                 mel_weight: float = 45.0 / 45.0, feat_weight: float = 0.0, seed: int = 0,
                 device: str | torch.device = "cuda"):
        self.cfg, self.audio, self.lr = cfg, audio, lr
        self.mel_weight, self.feat_weight = mel_weight, feat_weight
        self.device = resolve_device(device)
        self.model = HiFiGANGenerator(cfg)
        self.model.reset_parameters(seed)
        self.model.to(self.device).train()
        self.optimizer = self._adamw(self.model, 0.0)
        self.basis = mel_basis(audio, self.device)
        self.history: list[float] = []

    def _adamw(self, module: torch.nn.Module, weight_decay: float) -> torch.optim.AdamW:
        return torch.optim.AdamW(module.parameters(), lr=self.lr, betas=(0.8, 0.99), eps=1e-8,
                                 weight_decay=weight_decay)

    def load_generator(self, flat: dict) -> None:
        """Warm-start the generator from flat JAX parameters (an ``.npz``'s
        entries); its optimizer restarts."""
        self.model.load_state_dict(_from_flat({k: np.asarray(v, np.float32) for k, v in flat.items()}))
        self.optimizer = self._adamw(self.model, 0.0)

    def _tensors(self, mel, y) -> tuple[torch.Tensor, torch.Tensor]:
        """The batch on the device in float32."""
        return (torch.as_tensor(mel, device=self.device).float(), torch.as_tensor(y, device=self.device).float())

    def recon_loss(self, y_hat: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        loss = self.mel_weight * log_mel_l1(y_hat, y, self.basis, self.audio) + multi_resolution_stft_loss(y_hat, y)
        if self.feat_weight:
            loss = loss + self.feat_weight * feature_mel_l1(y_hat, y, self.basis, self.audio)
        return loss

    def step(self, mel, y) -> torch.Tensor:
        """One update on mels (B, T, 80) and waveforms (B, T * hop) -> the
        loss before it (on the device, not synchronised)."""
        mel, y = self._tensors(mel, y)
        with exact_f32(self.device):
            self.optimizer.zero_grad(set_to_none=True)
            loss = self.recon_loss(self.model(mel), y)
            loss.backward()
            self.optimizer.step()
        return loss.detach()

    def train(self, batches: Iterator, num_iters: int, log_step: int = 50) -> float:
        t0 = time.time()
        loss = float("nan")
        for i in range(1, num_iters + 1):
            loss_t = self.step(*next(batches))
            if i % log_step == 0 or i == num_iters:
                loss = float(loss_t)
                if not np.isfinite(loss):
                    raise RuntimeError(f"[hifigan] non-finite loss at iter {i}; refusing to continue — resume "
                                       f"from the last saved checkpoint")
                self.history.append(loss)
                print(f"[hifigan] iter {i}/{num_iters} loss {loss:.4f} ({(time.time() - t0) / i:.2f}s/it)",
                      flush=True)
        return loss

    def save(self, path: str) -> None:
        """The generator's flat ``.npz`` (``pre/kernel``, ...)."""
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        np.savez(path, **conv_state_to_jax(self.model.state_dict()))


class HiFiGANGANTrainer(HiFiGANTrainer):
    """The adversarial fine-tune: each step first updates the discriminators
    (LSGAN on the real waveform and the generator's, the generator frozen),
    then the generator (adversarial + ``fm_weight`` x feature matching +
    ``mel_weight`` x log-mel L1, + ``feat_weight`` x feature-mel L1)
    against the updated discriminators. The discriminators are drawn from
    ``seed + 1``; ``generator_params`` (flat JAX parameters) warm-start the
    generator."""

    def __init__(self, cfg: HiFiGANConfig, audio: AudioConfig = AudioConfig(), lr: float = 2e-4,
                 mel_weight: float = 45.0, fm_weight: float = 2.0, feat_weight: float = 0.0, seed: int = 0,
                 generator_params: dict | None = None, device: str | torch.device = "cuda"):
        # the reconstruction step keeps its own weights (1 and 0), as in JAX
        super().__init__(cfg, audio, lr=lr, seed=seed, device=device)
        self.gan_weights = (mel_weight, fm_weight, feat_weight)
        if generator_params is not None:
            self.load_generator(generator_params)
        self.disc = HiFiGANDiscriminators()
        self.disc.reset_parameters(seed + 1)
        self.disc.to(self.device)
        self.d_optimizer = self._adamw(self.disc, 1e-4)  # optax.adamw's default weight decay
        self.gan_history: list[dict] = []

    def gan_step(self, mel, y) -> dict[str, torch.Tensor]:
        """One discriminator update, then one generator update -> the
        metrics (d_loss, g_loss, adv, fm, mel), on the device."""
        mel, y = self._tensors(mel, y)
        mel_weight, fm_weight, feat_weight = self.gan_weights
        with exact_f32(self.device):
            with torch.no_grad():
                y_hat = self.model(mel)
            self.d_optimizer.zero_grad(set_to_none=True)
            real_s, _ = self.disc(y)
            fake_s, _ = self.disc(y_hat)
            d_loss = discriminator_loss(real_s, fake_s)
            d_loss.backward()
            self.d_optimizer.step()

            self.optimizer.zero_grad(set_to_none=True)
            self.disc.requires_grad_(False)
            try:
                y_hat = self.model(mel)
                fake_s, fake_f = self.disc(y_hat)
                with torch.no_grad():
                    _, real_f = self.disc(y)
                adv = generator_adversarial_loss(fake_s)
                fm = feature_matching_loss(real_f, fake_f)
                mel_l = log_mel_l1(y_hat, y, self.basis, self.audio)
                g_loss = adv + fm_weight * fm + mel_weight * mel_l
                if feat_weight:
                    g_loss = g_loss + feat_weight * feature_mel_l1(y_hat, y, self.basis, self.audio)
                g_loss.backward()
            finally:
                self.disc.requires_grad_(True)
            self.optimizer.step()
        return {"d_loss": d_loss.detach(), "g_loss": g_loss.detach(), "adv": adv.detach(), "fm": fm.detach(),
                "mel": mel_l.detach()}

    def train_gan(self, batches: Iterator, num_iters: int, log_step: int = 50) -> dict:
        t0 = time.time()
        for i in range(1, num_iters + 1):
            m = self.gan_step(*next(batches))
            if i % log_step == 0 or i == num_iters:
                rec = {k: float(v) for k, v in m.items()}
                if not all(np.isfinite(v) for v in rec.values()):
                    raise RuntimeError(f"[hifigan-gan] non-finite metric at iter {i} ({rec}); refusing to continue "
                                       f"— resume from the last saved checkpoint")
                self.gan_history.append(rec)
                print(f"[hifigan-gan] iter {i}/{num_iters} " + " ".join(f"{k}={v:.3f}" for k, v in rec.items())
                      + f" ({(time.time() - t0) / i:.2f}s/it)", flush=True)
        return self.gan_history[-1] if self.gan_history else {}

    def _leaves(self) -> tuple[JaxLeaves, JaxLeaves]:
        return (JaxLeaves(self.model, conv_state_to_jax, _from_flat),
                JaxLeaves(self.disc, conv_state_to_jax, _from_flat))

    def save_train_state(self, path: str) -> None:
        """The discriminators and both optimizers' states, beside the
        generator's checkpoint, so that a fine-tune resumes as it was."""
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        g, d = self._leaves()
        np.savez(path, **{f"d/{k}": v for k, v in conv_state_to_jax(self.disc.state_dict()).items()},
                 **{f"g_opt/{i:04d}": v for i, v in enumerate(g.adam_leaves(self.optimizer))},
                 **{f"d_opt/{i:04d}": v for i, v in enumerate(d.adam_leaves(self.d_optimizer))})

    def restore_train_state(self, path: str) -> None:
        with np.load(path) as z:
            data = {k: z[k] for k in z.files}
        self.disc.load_state_dict(_from_flat({k[2:]: v for k, v in data.items()
                                                             if k.startswith("d/")}))
        g, d = self._leaves()
        for leaves, opt, pref in ((g, self.optimizer, "g_opt/"), (d, self.d_optimizer, "d_opt/")):
            leaves.load_adam_leaves(opt, [data[k] for k in sorted(k for k in data if k.startswith(pref))])


def hifigan_crop_batch(wavs, mels, batch_size: int, frames: int, hop: int, rng: np.random.Generator
                       ) -> tuple[np.ndarray, np.ndarray]:
    """(mel (B, frames, 80), waveform (B, frames * hop)) aligned random
    crops, the JAX function's draws from ``rng``; short utterances
    zero-padded."""
    ms, ys = [], []
    for _ in range(batch_size):
        i = int(rng.integers(0, len(wavs)))
        w, m = wavs[i], mels[i]
        max_f = min(m.shape[0], w.shape[0] // hop) - frames
        f0 = int(rng.integers(0, max(1, max_f)))
        xm = m[f0 : f0 + frames]
        xw = w[f0 * hop : (f0 + frames) * hop]
        if xm.shape[0] < frames:
            xm = np.pad(xm, ((0, frames - xm.shape[0]), (0, 0)))
        if xw.shape[0] < frames * hop:
            xw = np.pad(xw, (0, frames * hop - xw.shape[0]))
        ms.append(xm)
        ys.append(xw)
    return np.stack(ms).astype(np.float32), np.stack(ys).astype(np.float32)
