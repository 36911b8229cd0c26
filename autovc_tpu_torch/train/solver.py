"""Training orchestration of the generator family (spmel, stft, wav) on one
device.

Counterpart of ``autovc_tpu/train/solver.py``: weights drawn from
``cfg.train.seed``, Adam, the Cosine/CosineDecay/Plateau schedules, a
checkpoint every ``checkpoint_step`` with resume from the latest, SIGTERM and
SIGINT saving a checkpoint and stopping, a non-finite loss raising
``FloatingPointError`` without saving, transient data errors retried (at
most 3 in a row), the JSONL metrics stream and the console line, histograms
every ``watch_step``.

Checkpoints are ``torch.save`` files of ``{params, batch_stats, opt_state,
ema_params, step}`` under ``<run_dir>/checkpoints``. A save takes a copy of
the state on the device (the step updates it in place) and writes it from
one background thread, under a temporary name then renamed; a periodic save
that finds the previous one still in flight is skipped, and the last three
are kept. There is no mesh and no multi-process path here: data and model
parallelism other than 1 raise (ROADMAP Queue 1 #8).

With ``lambda_spk > 0`` the frozen GE2E encoder of ``spk_ckpt`` and, for the
'windowed' protocol, its tables (the unit-norm train.pkl embeddings and the
evaluation's speaker centroids, computed once with ``eval.SpeakerEmbedder``
on the Solver's device) are built once and shared by the train step and
``eval_loss``.
"""

from __future__ import annotations

import os
import re
import signal
import threading
import time
from typing import Any, Iterator

import numpy as np
import torch

from autovc_tpu_torch import resolve_device
from autovc_tpu_torch.config import Config
from autovc_tpu_torch.data.prefetch import DevicePrefetcher
from autovc_tpu_torch.models import build_generator
from autovc_tpu_torch.train.metrics import MetricsLogger
from autovc_tpu_torch.train.profiler import StepTimer
from autovc_tpu_torch.train.schedule import ReduceLROnPlateau
from autovc_tpu_torch.train.state import TrainState, init_ema
from autovc_tpu_torch.train.step import SpeakerAux, make_eval_loss, make_optimizer, make_train_step
from autovc_tpu_torch.train.watch import watch_histograms

MAX_TO_KEEP = 3
_CKPT = re.compile(r"^step_(\d+)\.pt$")


def checkpoint_file(ckpt_dir: str, step: int) -> str:
    """The path of the step's checkpoint under ``ckpt_dir``."""
    return os.path.join(ckpt_dir, f"step_{step:09d}.pt")


def saved_steps(ckpt_dir: str) -> list[int]:
    """The steps of the checkpoints under ``ckpt_dir``, ascending."""
    return sorted(int(mt.group(1)) for f in os.listdir(ckpt_dir) if (mt := _CKPT.match(f)))


def log_keys(cfg: Config) -> list[str]:
    """The console's loss terms of the variant: the speaker auxiliary's
    among them when it is on (and its mean margin under the 'windowed'
    protocol); the wav loss has no auxiliary."""
    if cfg.model.model_type == "wav":
        return ["g_loss_id", "g_loss_gen", "g_loss_cd", "g_loss_sisnr"]
    keys = ["g_loss_id", "g_loss_id_psnt", "g_loss_cd"]
    if cfg.train.lambda_spk > 0:
        keys.append("g_loss_spk")
        if cfg.train.spk_protocol == "windowed":
            keys.append("g_spk_margin")
    return keys


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree) if isinstance(tree, torch.Tensor) else tree


class Solver:
    def __init__(self, cfg: Config, data_iter: Iterator, run_dir: str | None = None,
                 device: str | torch.device = "cuda"):
        if cfg.train.data_parallel != 1 or cfg.train.model_parallel != 1:
            raise NotImplementedError("data_parallel/model_parallel other than 1 are not ported yet "
                                      "(ROADMAP Queue 1 #8)")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.data_iter = data_iter
        self.run_dir = run_dir or os.path.join(cfg.main_dir, "runs", cfg.run_name)
        os.makedirs(self.run_dir, exist_ok=True)
        self.metrics = MetricsLogger(self.run_dir, cfg.run_name)
        if self.device.type == "cpu":
            self.metrics.alert("CPU", "training on the CPU with the plain LSTM recurrence")
        self.plateau = (ReduceLROnPlateau(cfg.train.plateau_factor, cfg.train.plateau_patience)
                        if cfg.train.lr_scheduler == "Plateau" else None)
        self.ckpt_dir = os.path.abspath(os.path.join(self.run_dir, "checkpoints"))
        os.makedirs(self.ckpt_dir, exist_ok=True)
        self.save_stall_ms: list[float] = []  # train-loop wall time each save took
        self.timer = StepTimer()
        self.history: list[dict] = []
        self._save_thread: threading.Thread | None = None
        self._save_error: Exception | None = None
        self._saves_skipped = 0  # periodic saves dropped while one was in flight
        self._last_saved_step = -1

        model = build_generator(cfg.model, device=self.device, seed=cfg.train.seed, trainable=True)
        self.state = TrainState(step=0, model=model, optimizer=make_optimizer(model, cfg),
                                ema_params=init_ema(model))
        self.spk_aux = self._build_spk_aux()
        self._step_fn = make_train_step(cfg, spk=self.spk_aux)
        self._eval_fn = make_eval_loss(model, cfg, spk=self.spk_aux)
        latest = self.latest_step()
        if latest is not None:
            self.restore(latest)
            print(f"Continue from iteration: {self.state.step}")

    # ------------------------------------------------------- speaker encoder

    def _speaker_aux_windowed(self, dvec_params: dict) -> SpeakerAux:
        """The 'windowed' protocol's tables: the unit-norm train.pkl
        conditioning rows (the speaker lookup) and the evaluation's speaker
        centroids (the targets), computed once with the same
        ``eval.SpeakerEmbedder`` the similarity evaluation uses."""
        from autovc_tpu_torch.data.manifest import load_train_manifest
        from autovc_tpu_torch.eval import SpeakerEmbedder, load_speaker_mels, speaker_centroids

        mel_dir = os.path.join(self.cfg.main_dir, "spmel")
        entries = load_train_manifest(os.path.join(mel_dir, "train.pkl"))
        embedder = SpeakerEmbedder(dvec_params, device=self.device)
        mels = load_speaker_mels(mel_dir, entries, self.cfg.speaker.num_uttrs)
        cents = speaker_centroids(embedder, mels)
        table = np.stack([e.embedding for e in entries]).astype(np.float32)
        table /= np.linalg.norm(table, axis=-1, keepdims=True) + 1e-8
        print(f"[solver] lambda_spk windowed protocol: eval centroids for {len(entries)} speakers "
              f"(margin {self.cfg.train.spk_margin})")
        centroids = np.stack([cents[e.speaker_id] for e in entries]).astype(np.float32)
        return SpeakerAux(embedder.model, emb_table=torch.from_numpy(table).to(self.device),
                          centroids=torch.from_numpy(centroids).to(self.device))

    def _build_spk_aux(self) -> SpeakerAux | None:
        """The lambda_spk auxiliary's frozen encoder (and tables), or None
        when lambda_spk is 0. stft raises, as the JAX loss asserts spmel; for
        wav it is built and the wav loss ignores it, as in the JAX Solver."""
        tc = self.cfg.train
        if tc.lambda_spk <= 0:
            return None
        if not tc.spk_ckpt:
            raise ValueError("lambda_spk > 0 requires spk_ckpt (a GE2E checkpoint .npz)")
        if self.cfg.model.model_type == "stft":
            raise ValueError("lambda_spk requires mel-domain outputs (model_type spmel), not stft")
        from autovc_tpu_torch.models import build_dvector
        from autovc_tpu_torch.train.ge2e import load_params

        dvec_params = load_params(tc.spk_ckpt)
        if tc.spk_protocol == "windowed":
            spk = self._speaker_aux_windowed(dvec_params)
        else:
            spk = SpeakerAux(build_dvector(dvec_params, device=self.device))
        print(f"[solver] speaker-consistency aux on (lambda_spk={tc.lambda_spk}, protocol={tc.spk_protocol}, "
              f"frozen encoder: {tc.spk_ckpt})")
        return spk

    # ----------------------------------------------------------------- train

    def train(self, num_iters: int | None = None, prefetch: int = 2) -> dict:
        cfg = self.cfg
        num_iters = num_iters if num_iters is not None else cfg.train.num_iters
        lr_scale = 1.0
        data_iter = prefetcher = None
        if prefetch:
            data_iter = prefetcher = DevicePrefetcher(self.data_iter, self.device, depth=prefetch)
        else:
            data_iter = self.data_iter

        stop_requested = {"flag": False}

        def _on_term(signum, frame):
            stop_requested["flag"] = True

        old_handlers = {}
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                old_handlers[sig] = signal.signal(sig, _on_term)
            except ValueError:  # not the main thread
                pass

        print("Starting training...", flush=True)
        i = self.state.step
        last_metrics: dict = {}
        m = None
        data_failures = 0
        try:
            while i < num_iters:
                if stop_requested["flag"]:
                    # a termination after a non-finite step must not replace
                    # the last good checkpoint
                    if m is not None and not np.isfinite(float(m["g_loss"])):
                        print(f"[solver] termination at step {i} with non-finite loss; NOT "
                              f"checkpointing (last good: {self.latest_step()})")
                    else:
                        print(f"[solver] termination requested at step {i}; checkpointing")
                        self.save(i, wait=True)
                    break
                try:
                    x, emb = next(data_iter)
                    data_failures = 0
                except StopIteration:
                    raise
                except Exception as exc:  # transient data error: retry, bounded
                    data_failures += 1
                    if data_failures > 3:
                        raise
                    print(f"[solver] data error ({exc}); retry {data_failures}/3")
                    continue
                if prefetcher is None:
                    x = torch.as_tensor(x).to(self.device)
                    emb = torch.as_tensor(emb).to(self.device)
                m = self._step_fn(self.state, x, emb, lr_scale)
                i += 1

                # the loss is fetched (a host sync) only at log_step boundaries
                if i % cfg.train.log_step == 0:
                    loss_val = float(m["g_loss"])
                    if not np.isfinite(loss_val):
                        raise FloatingPointError(f"non-finite loss at step {i}; resume from the last "
                                                 f"good checkpoint (step {self.latest_step()})")
                    if self.plateau is not None:
                        lr_scale = self.plateau.step(loss_val)
                    last_metrics = {k: float(v) for k, v in m.items()}
                    self.history.append(dict(last_metrics, step=i))
                    self.metrics.log(i, last_metrics)
                    self.metrics.console(i, num_iters, last_metrics, keys=log_keys(cfg))
                self.timer.tick()
                if cfg.train.watch_step and i % cfg.train.watch_step == 0:
                    self.metrics.log_histograms(i, watch_histograms(self.state.model))
                if i % cfg.train.checkpoint_step == 0:
                    if not np.isfinite(float(m["g_loss"])):  # never persist a poisoned state
                        raise FloatingPointError(f"non-finite loss at checkpoint step {i}; last good "
                                                 f"checkpoint is step {self.latest_step()}")
                    self.save(i)
        finally:
            if prefetcher is not None:
                prefetcher.close()
            for sig, h in old_handlers.items():
                signal.signal(sig, h)
        # a boundary save skipped while the previous one was in flight must
        # not leave the end of the run unsaved
        cs = cfg.train.checkpoint_step
        if (not stop_requested["flag"] and m is not None and i >= cs
                and self._last_saved_step < (i // cs) * cs and np.isfinite(float(m["g_loss"]))):
            self.save(i, wait=True)
        self.finish_saves()
        return last_metrics

    # ------------------------------------------------------------ checkpoint

    def checkpoint_path(self, step: int) -> str:
        return checkpoint_file(self.ckpt_dir, step)

    def checkpoint_steps(self) -> list[int]:
        return saved_steps(self.ckpt_dir)

    def latest_step(self) -> int | None:
        steps = self.checkpoint_steps()
        return steps[-1] if steps else None

    def state_tree(self) -> dict[str, Any]:
        """The checkpoint's contents, referring to the live tensors."""
        model = self.state.model
        return {
            "params": {n: p.detach() for n, p in model.named_parameters()},
            "batch_stats": {n: b for n, b in model.named_buffers()},
            "opt_state": self.state.optimizer.state_dict(),
            "ema_params": self.state.ema_params,
            "step": self.state.step,
        }

    def save(self, step: int, wait: bool = False) -> None:
        t0 = time.perf_counter()
        self._save(step, wait)
        stall = (time.perf_counter() - t0) * 1e3
        self.save_stall_ms.append(stall)
        if stall > 2000:
            print(f"[solver] checkpoint save blocked the loop {stall:.0f} ms")

    def _save(self, step: int, wait: bool) -> None:
        if self._save_thread is not None:
            if self._save_thread.is_alive() and not wait:
                self._saves_skipped += 1
                return
            self._save_thread.join()
            self._save_thread = None
        if self._saves_skipped:
            print(f"[solver] {self._saves_skipped} checkpoint(s) skipped while the previous save "
                  f"was in flight")
            self._saves_skipped = 0
        if self._save_error is not None:
            # a failed background save stops training now: checkpoints are
            # the recovery path
            exc, self._save_error = self._save_error, None
            self.metrics.alert("checkpoint save failed", f"background save raised: {exc!r}")
            raise exc
        snap = _tree_map(torch.clone, self.state_tree())  # on the device, in stream order

        def _bg():
            try:
                self._write(step, snap)
            except Exception as exc:  # surfaced at the next save or at finish_saves
                self._save_error = exc

        self._save_thread = threading.Thread(target=_bg, daemon=True)
        self._save_thread.start()
        self._last_saved_step = step

    def _write(self, step: int, snap: dict) -> None:
        path = self.checkpoint_path(step)
        tmp = f"{path}.{os.getpid()}.tmp"
        torch.save(_tree_map(lambda t: t.cpu(), snap), tmp)
        os.replace(tmp, path)
        for old in self.checkpoint_steps()[:-MAX_TO_KEEP]:
            os.remove(self.checkpoint_path(old))

    def finish_saves(self) -> None:
        """Wait for the save in flight; re-raise its error if it failed."""
        if self._save_thread is not None:
            self._save_thread.join()
            self._save_thread = None
        if self._save_error is not None:
            exc, self._save_error = self._save_error, None
            raise exc

    def restore(self, step: int) -> None:
        # loaded on the CPU: load_state_dict copies the model's tensors in, and
        # moves the optimizer's moments to the parameters' device while its
        # step counts stay on the host, as Adam keeps them (a step count on
        # the card would cost a device sync per parameter and step)
        tree = torch.load(self.checkpoint_path(step), map_location="cpu", weights_only=True)
        model = self.state.model
        model.load_state_dict({**tree["params"], **tree["batch_stats"]})
        self.state.optimizer.load_state_dict(tree["opt_state"])
        self.state.ema_params = {k: v.to(self.device) for k, v in tree["ema_params"].items()}
        self.state.step = int(tree["step"])

    # ------------------------------------------------------------------ eval

    def eval_loss(self, x, emb) -> dict:
        """Eval-mode metrics of one batch (running statistics, nothing
        mutated)."""
        x = torch.as_tensor(x, dtype=torch.float32).to(self.device)
        emb = torch.as_tensor(emb, dtype=torch.float32).to(self.device)
        return {k: float(v) for k, v in self._eval_fn(x, emb).items()}
