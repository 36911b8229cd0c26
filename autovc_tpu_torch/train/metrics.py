"""Metrics sink, as ``autovc_tpu/train/metrics.py``: a local JSONL stream
(``metrics_<run_name>.jsonl``), the reference's console line and the
histogram records. The JAX package's optional wandb mirroring and
spectrogram figures are not ported (ROADMAP Queue 1)."""

from __future__ import annotations

import datetime
import json
import os
import time
from typing import Any, Mapping


def read_metrics(path: str) -> list[dict]:
    """The scalar records of a metrics stream (each step ``log`` wrote), in
    order; histogram records left out."""
    with open(path) as f:
        return [rec for rec in map(json.loads, f) if "histograms" not in rec]


class MetricsLogger:
    def __init__(self, run_dir: str, run_name: str):
        os.makedirs(run_dir, exist_ok=True)
        self.path = os.path.join(run_dir, f"metrics_{run_name}.jsonl")
        self._f = open(self.path, "a", buffering=1)
        self.start_time = time.time()

    def alert(self, title: str, text: str) -> None:
        print(f"[alert] {title}: {text}", flush=True)

    def log(self, step: int, metrics: Mapping[str, Any]) -> None:
        rec = {"step": step, "time": time.time() - self.start_time}
        rec.update({k: float(v) for k, v in metrics.items()})
        self._f.write(json.dumps(rec) + "\n")

    def console(self, step: int, num_iters: int, metrics: Mapping[str, Any], keys=None) -> None:
        """The reference's log line."""
        et = str(datetime.timedelta(seconds=time.time() - self.start_time))[:-7]
        line = f"Elapsed [{et}], Iteration [{step}/{num_iters}]"
        for k in keys or sorted(metrics):
            line += f", {k}: {float(metrics[k]):.4f}"
        print(line, flush=True)

    def log_histograms(self, step: int, hists: Mapping[str, Mapping[str, Any]]) -> None:
        """hists: {'param/encoder': {counts, lo, hi, rms}, ...} -> one JSONL
        record of summaries and counts."""
        rec: dict[str, Any] = {"step": step, "histograms": {}}
        for name, h in hists.items():
            rec["histograms"][name] = {
                "lo": float(h["lo"]),
                "hi": float(h["hi"]),
                "rms": float(h["rms"]),
                "counts": h["counts"].cpu().long().tolist(),
            }
        self._f.write(json.dumps(rec) + "\n")

    def close(self) -> None:
        self._f.close()
