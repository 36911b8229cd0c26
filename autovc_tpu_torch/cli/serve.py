"""Conversion server: load a serving bundle, answer conversions over HTTP.

    python -m autovc_tpu_torch.cli.serve --bundle DIR [--port 8765]
        [--warmup 256,512] [--batch_window 5 --max_batch 16 --bucket 256]
        [--device cuda|cpu]

Counterpart of ``autovc_tpu/cli/serve.py``: a long-lived process that loads
the exported programs once (``autovc_tpu_torch.serve.ServingConverter``,
without the model code) and answers conversion requests.

Protocol (stdlib only, binary npz in, npy out):

  GET  /healthz    -> 200 "ok" once the bundle is loaded and warmed
  GET  /manifest   -> 200 manifest.json of the loaded bundle
  GET  /stats      -> 200 JSON: program calls, requests, mean and max batch
  POST /convert    -> body: npz with arrays
                        features (T, n_bins) f32   normalized features
                        emb_org (dim_emb,)   f32   source speaker d-vector
                        emb_trg (dim_emb,)   f32   target speaker d-vector
                      response: .npy, the converted features (T, n_bins),
                      or the waveform (T*hop,) f32 for a bundle with a
                      vocoder; a malformed request gets 400, a failure of
                      the program 500

Client sketch::

    buf = io.BytesIO(); np.savez(buf, features=f, emb_org=a, emb_trg=b)
    wav = np.load(io.BytesIO(urlopen(url + "/convert", buf.getvalue()).read()))

Requests are served through one device. --warmup converts zeros at the
given frame counts before the server listens (the first call of a program
at a shape pays its one-time costs there, not in a request).

With --batch_window MS concurrent requests are micro-batched: requests
arriving within the window are zero-padded to a shared bucket
(``convert.bucket_length``: the Converter's ``use_buckets`` padding) and
answered by one batched program call. Batching does not change a
request's result against a solo call at the same bucket padding (the batch
axis is data-parallel through the whole Generator); it costs up to one
window of latency. Bucketing trades the reference's pad-to-freq for fewer
distinct lengths, as ``Converter(use_buckets=True)`` does.

Everything runs on --device (default cuda, in exact float32 there; cpu runs
the plain PyTorch versions).
"""

from __future__ import annotations

import argparse
import io
import json
import queue
import threading
import time

import numpy as np


class _Item:
    __slots__ = ("feats", "emb_org", "emb_trg", "done", "result", "error")

    def __init__(self, feats, emb_org, emb_trg):
        self.feats, self.emb_org, self.emb_trg = feats, emb_org, emb_trg
        self.done = threading.Event()
        self.result = None
        self.error: Exception | None = None


_STOP = object()


class MicroBatcher:
    """Groups concurrent conversion requests into batched program calls.

    One dispatcher thread owns the device: it takes the first pending
    request, waits up to ``window_s`` for companions (at most ``max_batch``
    a call), groups them by bucketed padded length and runs one converter
    call a group. Each row's padding is stripped, so a batched row equals
    the same request run solo at the same bucket padding. For a bundle with
    a vocoder the vocoder runs a request at a time on its exact stripped
    length: vocoding padded mels would change the tail's receptive field
    (``autovc_tpu_torch.serve``'s staging).
    """

    def __init__(self, srv, window_s: float = 0.005, max_batch: int = 16, bucket: int = 256):
        from autovc_tpu_torch.convert import bucket_length

        freq = srv.manifest["freq"]
        if bucket % freq != 0:
            # checked here (and at CLI startup) so that a bad --bucket is a
            # startup error, not a failure inside the dispatcher thread
            raise ValueError(f"bucket ({bucket}) must be a multiple of the bundle's freq ({freq})")
        self._bucket_length = bucket_length
        self.srv = srv
        self.window_s = window_s
        self.max_batch = max_batch
        self.bucket = bucket
        self.batch_sizes: list[int] = []  # the batch of each program call
        self._q: queue.Queue = queue.Queue()
        self._closed = False
        # serializes enqueue against close: without it a handler that passed
        # the _closed check could enqueue after close() put _STOP and the
        # dispatcher drained, and wait on item.done forever
        self._submit_lock = threading.Lock()
        self._thread = threading.Thread(target=self._loop, name="serve-batcher", daemon=True)
        self._thread.start()

    def convert(self, feats, emb_org, emb_trg):
        """Blocking request entry point (called from handler threads)."""
        item = _Item(feats, emb_org, emb_trg)
        with self._submit_lock:
            if self._closed:
                raise RuntimeError("server is shutting down")
            # under the lock the item lands ahead of close()'s _STOP in the
            # FIFO, so the dispatcher answers it
            self._q.put(item)
        item.done.wait()
        if item.error is not None:
            raise item.error
        return item.result

    def close(self):
        with self._submit_lock:
            self._closed = True  # new convert() calls fail from here on
            self._q.put(_STOP)
        self._thread.join(timeout=30.0)
        if self._thread.is_alive():
            print("[serve] warning: batcher thread did not exit within 30s")

    def _loop(self):
        while True:
            first = self._q.get()
            if first is _STOP:
                self._drain_and_exit()
                return
            batch = [first]
            deadline = time.monotonic() + self.window_s
            stopping = False
            while len(batch) < self.max_batch:
                timeout = deadline - time.monotonic()
                if timeout <= 0:
                    break
                try:
                    nxt = self._q.get(timeout=timeout)
                except queue.Empty:
                    break
                if nxt is _STOP:
                    stopping = True
                    break
                batch.append(nxt)
            self._run_safe(batch)
            if stopping:
                self._drain_and_exit()
                return

    def _drain_and_exit(self):
        """Answer the requests queued behind _STOP (they won the race against
        the closed flag), so that no handler thread waits forever."""
        batch: list[_Item] = []
        while True:
            try:
                it = self._q.get_nowait()
            except queue.Empty:
                break
            if it is _STOP:
                continue
            batch.append(it)
            if len(batch) >= self.max_batch:
                self._run_safe(batch)
                batch = []
        if batch:
            self._run_safe(batch)

    def _run_safe(self, batch):
        """_run, with any exception that escapes it failing the batch's
        items instead of ending the dispatcher thread (a dead dispatcher
        would leave every later request waiting)."""
        try:
            self._run(batch)
        except Exception as exc:
            for it in batch:
                if not it.done.is_set():
                    it.error = exc
                    it.done.set()

    def _run(self, batch):
        freq = self.srv.manifest["freq"]
        groups: dict[int, list[_Item]] = {}
        for it in batch:
            tb = self._bucket_length(it.feats.shape[0], freq, self.bucket)
            groups.setdefault(tb, []).append(it)
        for tb, items in groups.items():
            try:
                x = np.stack([np.pad(it.feats, ((0, tb - it.feats.shape[0]), (0, 0))) for it in items])
                eo = np.stack([it.emb_org for it in items])
                et = np.stack([it.emb_trg for it in items])
                out = self.srv(x, eo, et)
                self.batch_sizes.append(len(items))
                for row, it in zip(out, items):
                    res = row[: it.feats.shape[0]]
                    if self.srv.with_vocoder:
                        res = self.srv.vocode(res[None])[0]
                    it.result = res.cpu().numpy()
                    it.done.set()
            except Exception as exc:  # fail the whole group, keep serving
                for it in items:
                    if not it.done.is_set():
                        it.error = exc
                        it.done.set()


def make_handler(srv, lock, batcher: MicroBatcher | None = None):
    """HTTP handler bound to a loaded ServingConverter (importable without a
    server, for tests). With a batcher, /convert requests go through it (its
    dispatcher thread serializes the device); otherwise each request
    converts alone under ``lock``."""
    from http.server import BaseHTTPRequestHandler

    class Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, body: bytes, ctype: str = "application/octet-stream"):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._send(200, b"ok", "text/plain")
            elif self.path == "/manifest":
                self._send(200, json.dumps(srv.manifest).encode(), "application/json")
            elif self.path == "/stats":
                bs = list(batcher.batch_sizes) if batcher is not None else []
                stats = {
                    "batching": batcher is not None,
                    "program_calls": len(bs),
                    "requests": int(sum(bs)),
                    "mean_batch": (sum(bs) / len(bs)) if bs else None,
                    "max_batch": max(bs) if bs else None,
                }
                self._send(200, json.dumps(stats).encode(), "application/json")
            else:
                self._send(404, b"not found", "text/plain")

        def do_POST(self):
            if self.path != "/convert":
                self._send(404, b"not found", "text/plain")
                return
            try:
                n = int(self.headers.get("Content-Length", "0"))
                data = np.load(io.BytesIO(self.rfile.read(n)))
                feats = np.asarray(data["features"], np.float32)
                eo = np.asarray(data["emb_org"], np.float32)
                et = np.asarray(data["emb_trg"], np.float32)
                if feats.ndim != 2 or feats.shape[1] != srv.manifest["n_bins"]:
                    raise ValueError(f"features must be (T, {srv.manifest['n_bins']}), got {feats.shape}")
                # the embeddings are checked here, so that a malformed
                # request gets its own 400 instead of failing its group
                dim_emb = srv.manifest["dim_emb"]
                for name, e in (("emb_org", eo), ("emb_trg", et)):
                    if e.shape != (dim_emb,):
                        raise ValueError(f"{name} must be ({dim_emb},), got {e.shape}")
            except Exception as exc:  # a malformed request -> 400, not a crash
                self._send(400, f"{type(exc).__name__}: {exc}".encode(), "text/plain")
                return
            try:
                if batcher is not None:
                    out = batcher.convert(feats, eo, et)
                else:
                    with lock:  # one device; serialize calls
                        out = srv.convert(feats, eo, et)
            except Exception as exc:
                # device, program or bundle failures are server errors: a 5xx,
                # so that clients do not blame (and retry) their payload
                self._send(500, f"{type(exc).__name__}: {exc}".encode(), "text/plain")
                return
            buf = io.BytesIO()
            np.save(buf, np.asarray(out, np.float32))
            self._send(200, buf.getvalue())

        def log_message(self, fmt, *args):  # to stdout, not stderr
            print(f"[serve] {self.address_string()} {fmt % args}")

    return Handler


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--bundle", required=True, help="cli.export_serving output dir")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8765)
    ap.add_argument("--warmup", default="", help="comma-separated frame counts to convert before listening")
    ap.add_argument("--batch_window", type=float, default=0.0,
                    help="micro-batching window in ms (0 = off): concurrent requests within the window share "
                         "one batched, bucket-padded program call")
    ap.add_argument("--max_batch", type=int, default=16, help="micro-batching: max requests a program call")
    ap.add_argument("--bucket", type=int, default=256,
                    help="micro-batching: frame-count bucket (a multiple of freq)")
    ap.add_argument("--device", default="cuda", help="cuda (the kernels) or cpu (the plain versions)")
    return ap


def make_server(args: argparse.Namespace):
    """(httpd, srv, batcher) for parsed arguments: the bundle loaded on
    --device, warmed, and the server bound (not yet serving)."""
    from http.server import ThreadingHTTPServer

    from autovc_tpu_torch.serve import ServingConverter

    srv = ServingConverter(args.bundle, device=args.device)
    if args.batch_window > 0 and args.bucket % srv.manifest["freq"] != 0:
        raise ValueError(f"--bucket {args.bucket} must be a multiple of the bundle's freq ({srv.manifest['freq']})")
    emb = np.zeros((srv.manifest["dim_emb"],), np.float32)
    for tok in args.warmup.split(","):
        if tok.strip():
            t = int(tok)
            srv.convert(np.zeros((t, srv.manifest["n_bins"]), np.float32), emb, emb)
            print(f"[serve] warmed T={t}")
    batcher = None
    if args.batch_window > 0:
        batcher = MicroBatcher(srv, window_s=args.batch_window / 1e3, max_batch=args.max_batch, bucket=args.bucket)
    httpd = ThreadingHTTPServer((args.host, args.port), make_handler(srv, threading.Lock(), batcher))
    return httpd, srv, batcher


def main(argv=None):
    args = build_parser().parse_args(argv)
    httpd, srv, batcher = make_server(args)
    host, port = httpd.server_address[:2]
    print(f"[serve] listening on http://{host}:{port} (bundle: {args.bundle}, device: {srv.device}, "
          f"vocoder: {srv.manifest['with_vocoder']}, batching: {args.batch_window} ms x {args.max_batch})")
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        print("[serve] shutting down")
    finally:
        if batcher is not None:
            batcher.close()
        httpd.server_close()


if __name__ == "__main__":
    main()
