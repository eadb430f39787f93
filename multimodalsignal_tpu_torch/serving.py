"""HTTP model server: trained fold checkpoint -> prediction endpoint.

Counterpart of multimodalsignal_tpu/serving.py: a dependency-free (stdlib
`http.server`) threaded HTTP server around one `Predictor`, on the GPU:

    python -m multimodalsignal_tpu_torch.serving \
        --checkpoint output/.../fold_test_on_S2/best_model.msgpack \
        --config output/.../config.json --port 8080 [--device cuda]
    python -m multimodalsignal_tpu_torch.serving --run-dir output/.../run_X

The checkpoint and config are the JAX package's, read unchanged. --run-dir
serves the run's fold ensemble (predict.EnsemblePredictor), or one fold with
--fold <subject>. Serving an exported artifact (--artifact) is not ported
yet (ROADMAP.md).

Endpoints (all JSON):

  GET  /healthz
      Liveness + model card: model name, classification mode, channels,
      expected window shape, torch device type ("platform"), requests served.

  POST /v1/predict
      Body: {"windows": [[[...T floats...] x C] x N]}           (nested lists)
         or {"windows_b64": "<base64 of a .npy float32 [N, C, T]>"}
      Reply: {"class_names", "labels", "probs", "num_windows", "latency_ms"}
      Windows must already be normalized the way training data was.
      Requests over --max-request-windows are refused with 413; clearly
      oversized bodies are refused from Content-Length without being read.

  POST /v1/predict_recording
      Body: {"pkl_path": "/path/on/server/S16.pkl"}
      Runs the full serving pipeline (resample -> window -> normalize ->
      forward) on a raw WESAD recording readable by the server process.
      Reply: predict.PredictionResult JSON + per-class window counts.

Device execution is single-flight (one lock), and batches are padded to a
fixed size (predict.Predictor.predict_windows). Concurrent small requests
are micro-batched (--micro-batch-ms, default 2 ms): a worker thread drains
the request queue for up to that long (or until batch_size windows) and
serves every waiting request with one padded forward; --micro-batch-ms 0
restores pure single-flight latency.
"""

from __future__ import annotations

import argparse
import base64
import io
import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import numpy as np

from multimodalsignal_tpu_torch.experiments.predict import (
    CLASS_NAMES,
    EnsemblePredictor,
    Predictor,
)


class MicroBatcher:
    """Coalesce concurrent predict requests into one padded device batch.

    Leader thread model: one daemon worker blocks on the queue; on the
    first pending request it keeps draining for up to `max_wait_s` (or
    until `max_windows` are queued), concatenates, runs ONE
    predictor.predict_windows under the service's device lock, and fans the
    probability rows back out to the waiting request threads. Exceptions
    propagate to every request in the failed batch.
    """

    def __init__(self, service: "PredictionService", max_wait_s: float):
        self.service = service
        self.max_wait_s = max_wait_s
        self.max_windows = service.batch_size
        self.batches_run = 0  # observability: coalescing effectiveness
        self._closed = False
        # Serializes the closed-check-then-put in submit() against close():
        # without it a submit passing the check while close() enqueues the
        # sentinel would land BEHIND the sentinel and block forever in
        # done.wait() (the worker exits at the sentinel).
        self._state_lock = threading.Lock()
        self._q: queue.Queue = queue.Queue()
        self._worker = threading.Thread(target=self._loop, daemon=True,
                                        name="mms-microbatcher")
        self._worker.start()

    def submit(self, x: np.ndarray) -> np.ndarray:
        done = threading.Event()
        slot: dict = {}
        with self._state_lock:
            if self._closed:
                raise RuntimeError("MicroBatcher is closed")
            self._q.put((x, done, slot))
        done.wait()
        if "err" in slot:
            raise slot["err"]
        return slot["probs"]

    def close(self) -> None:
        """Stop the worker thread (idempotent). In-flight requests drain
        first (the sentinel queues behind them); later submit() raises."""
        with self._state_lock:
            if self._closed:
                return
            self._closed = True
            self._q.put(None)
        self._worker.join()

    def _loop(self) -> None:
        stop = False
        while not stop:
            first = self._q.get()  # block for the first request
            if first is None:  # close() sentinel
                return
            batch = [first]
            n = len(first[0])
            deadline = time.perf_counter() + self.max_wait_s
            while n < self.max_windows:
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    break
                try:
                    item = self._q.get(timeout=remaining)
                except queue.Empty:
                    break
                if item is None:  # sentinel mid-drain: finish this batch
                    stop = True
                    break
                batch.append(item)
                n += len(item[0])
            try:
                # Concatenation stays INSIDE the try: a MemoryError on a
                # pathological batch must fan out to the waiting requests,
                # not kill the lone worker thread (which would wedge every
                # future request in done.wait()).
                xs = (batch[0][0] if len(batch) == 1
                      else np.concatenate([b[0] for b in batch]))
                svc = self.service
                with svc._lock:
                    probs = svc.predictor.predict_windows(xs, svc.batch_size)
                    svc.requests_served += len(batch)
                    svc.windows_served += len(xs)
                    self.batches_run += 1
                ofs = 0
                for bx, done, slot in batch:
                    k = len(bx)
                    slot["probs"] = probs[ofs : ofs + k]
                    ofs += k
                    done.set()
            except Exception as exc:  # fan the failure out, keep serving
                for _, done, slot in batch:
                    slot["err"] = exc
                    done.set()


class PredictionService:
    """Thread-safe wrapper of one `Predictor` for request-driven serving."""

    def __init__(self, predictor: Predictor, batch_size: int = 64,
                 micro_batch_ms: float = 2.0,
                 max_request_windows: int = 256):
        self.predictor = predictor
        self.batch_size = batch_size
        self._lock = threading.Lock()  # single-flight device execution
        self.requests_served = 0
        self.windows_served = 0
        self.micro_batch_ms = micro_batch_ms
        # Request-size bound: /v1/predict rejects more than this many windows
        # with 413. Enforced twice — on Content-Length BEFORE the body is
        # read (max_body_bytes, so a pathological request never allocates),
        # and on the decoded window count (b64 payloads compress).
        self.max_request_windows = max_request_windows
        self._batcher = (MicroBatcher(self, micro_batch_ms / 1e3)
                         if micro_batch_ms > 0 else None)
        cfg = predictor.cfg
        self.model_name = cfg.model.name
        self.classification_mode = cfg.classification_mode
        self.channels = list(cfg.channels_to_use)
        self.window_shape = (len(cfg.channels_to_use),
                             predictor.window_sec * predictor.target_fs)
        self.normalization = cfg.normalization
        self.backend = "checkpoint"
        fold_names = getattr(predictor, "fold_names", None)
        if fold_names:
            self.backend += f"-ensemble[{len(fold_names)}]"
        self.class_names = CLASS_NAMES[self.classification_mode]

    @property
    def max_body_bytes(self) -> int:
        """Upper bound on a plausible max_request_windows-sized body: JSON
        floats run ~24 bytes each incl. separators; anything larger is
        rejected from Content-Length alone, before the body is read."""
        c, t = self.window_shape
        per_window = c * t * 24
        return max(1, self.max_request_windows) * per_window + 64 * 1024

    # -- model card -----------------------------------------------------------
    def health(self) -> dict:
        return {
            "status": "ok",
            "model": self.model_name,
            "backend": self.backend,
            "classification_mode": self.classification_mode,
            "class_names": list(self.class_names),
            "channels": self.channels,
            "window_shape": list(self.window_shape),
            "normalization": self.normalization,
            "platform": self.predictor.device.type,
            "batch_size": self.batch_size,
            "micro_batch_ms": self.micro_batch_ms,
            "max_request_windows": self.max_request_windows,
            "batches_run": (self._batcher.batches_run
                            if self._batcher else self.requests_served),
            "requests_served": self.requests_served,
            "windows_served": self.windows_served,
        }

    def close(self) -> None:
        """Release the micro-batcher worker thread (idempotent). Without
        this every service with micro_batch_ms > 0 pins one daemon thread
        (and, through it, the predictor's model and its device memory) for process
        lifetime — long-lived hosts that build services repeatedly
        (benchmarks, notebooks, test suites) must call close()."""
        if self._batcher is not None:
            self._batcher.close()
            self._batcher = None

    # -- request handlers -------------------------------------------------------
    def predict_windows(self, payload: dict) -> dict:
        x = self._decode_windows(payload)
        t0 = time.perf_counter()
        if self._batcher is not None:
            # Coalesced path: the worker thread batches this request with
            # any others arriving within micro_batch_ms and updates the
            # counters under the device lock.
            probs = self._batcher.submit(x)
        else:
            with self._lock:
                probs = self.predictor.predict_windows(x, self.batch_size)
                # Counter updates stay inside the lock: ThreadingHTTPServer
                # runs handlers concurrently and += is not atomic.
                self.requests_served += 1
                self.windows_served += len(x)
        latency_ms = (time.perf_counter() - t0) * 1e3
        return {
            "class_names": list(self.class_names),
            "labels": [self.class_names[int(i)] for i in probs.argmax(axis=-1)],
            "probs": [[round(float(p), 6) for p in row] for row in probs],
            "num_windows": len(x),
            "latency_ms": round(latency_ms, 2),
        }

    def predict_recording(self, payload: dict) -> dict:
        pkl_path = payload.get("pkl_path")
        if not pkl_path or not Path(pkl_path).is_file():
            raise ServingError(400, f"pkl_path not found: {pkl_path!r}")
        t0 = time.perf_counter()
        # The host pipeline (resample/window/normalize) runs outside the
        # lock — only the device forward is single-flight.
        x, starts_sec = self.predictor.windows_from_recording(pkl_path)
        with self._lock:
            probs = self.predictor.predict_windows(x, self.batch_size)
            self.requests_served += 1
            self.windows_served += len(x)
        latency_ms = (time.perf_counter() - t0) * 1e3
        labels = probs.argmax(axis=-1)
        counts = np.bincount(labels, minlength=len(self.class_names))
        return {
            "class_names": list(self.class_names),
            "windows": [
                {"start_sec": float(t),
                 "label": self.class_names[int(l)],
                 "probs": [round(float(p), 6) for p in row]}
                for t, l, row in zip(starts_sec, labels, probs)
            ],
            "class_counts": {n: int(c)
                             for n, c in zip(self.class_names, counts)},
            "latency_ms": round(latency_ms, 2),
        }

    # -- input decoding ---------------------------------------------------------
    def _decode_windows(self, payload: dict) -> np.ndarray:
        if "windows_b64" in payload:
            try:
                raw = base64.b64decode(payload["windows_b64"])
                x = np.load(io.BytesIO(raw), allow_pickle=False)
            except Exception as exc:
                raise ServingError(400, f"windows_b64 is not a valid .npy: {exc}")
        elif "windows" in payload:
            try:
                x = np.asarray(payload["windows"], dtype=np.float32)
            except (TypeError, ValueError) as exc:
                raise ServingError(400, f"windows is not numeric [N,C,T]: {exc}")
        else:
            raise ServingError(400, "body must contain 'windows' or 'windows_b64'")
        x = np.asarray(x, dtype=np.float32)
        c, t = self.window_shape
        if x.ndim == 2:  # single window convenience
            x = x[None]
        if x.ndim != 3 or x.shape[1] != c or x.shape[2] != t:
            raise ServingError(
                400, f"expected windows of shape [N, {c}, {t}] "
                     f"(channels {self.channels}), got {list(x.shape)}")
        if len(x) == 0:
            raise ServingError(400, "empty windows batch")
        if len(x) > self.max_request_windows:
            raise ServingError(
                413, f"request carries {len(x)} windows; the limit is "
                     f"{self.max_request_windows} (--max-request-windows). "
                     f"Split the batch across requests.")
        if not np.isfinite(x).all():
            raise ServingError(400, "windows contain NaN/Inf")
        return x


class ServingError(Exception):
    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status
        self.message = message


def make_handler(service: PredictionService):
    class Handler(BaseHTTPRequestHandler):
        # Silence per-request stderr logging; the CLI prints a startup line.
        def log_message(self, fmt, *args):  # noqa: D102
            pass

        def _reply(self, status: int, obj: dict) -> None:
            body = json.dumps(obj).encode()
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802
            if self.path in ("/healthz", "/health", "/"):
                self._reply(200, service.health())
            else:
                self._reply(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):  # noqa: N802
            routes = {
                "/v1/predict": service.predict_windows,
                "/v1/predict_recording": service.predict_recording,
            }
            fn = routes.get(self.path)
            if fn is None:
                self._reply(404, {"error": f"unknown path {self.path}"})
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                # Reject oversized bodies from the header alone — the bytes
                # are drained in small discarded chunks (bounded memory, so
                # the client can finish sending and read the reply) but the
                # body is never materialized and never JSON-parsed.
                if (self.path == "/v1/predict"
                        and length > service.max_body_bytes):
                    remaining = length
                    while remaining > 0:
                        chunk = self.rfile.read(min(remaining, 1 << 16))
                        if not chunk:
                            break
                        remaining -= len(chunk)
                    self._reply(413, {
                        "error": f"request body {length} bytes exceeds "
                                 f"{service.max_body_bytes} "
                                 f"(max {service.max_request_windows} "
                                 f"windows per request)"})
                    return
                payload = json.loads(self.rfile.read(length) or b"{}")
                if not isinstance(payload, dict):
                    raise ServingError(400, "body must be a JSON object")
                self._reply(200, fn(payload))
            except ServingError as exc:
                self._reply(exc.status, {"error": exc.message})
            except json.JSONDecodeError as exc:
                self._reply(400, {"error": f"invalid JSON body: {exc}"})
            except Exception as exc:  # pragma: no cover - defensive 500
                self._reply(500, {"error": f"{type(exc).__name__}: {exc}"})

    return Handler


def make_server(service: PredictionService, host: str = "127.0.0.1",
                port: int = 8080) -> ThreadingHTTPServer:
    """Build the (threaded) HTTP server; caller runs serve_forever()."""
    return ThreadingHTTPServer((host, port), make_handler(service))


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--checkpoint", help="best_model.msgpack (with --config)")
    p.add_argument("--config", help="the run's config.json (with --checkpoint)")
    p.add_argument("--artifact", help="exported .mms artifact (not ported yet)")
    p.add_argument("--run-dir", help="run directory: serves the fold ensemble (or "
                                     "one fold with --fold); replaces --checkpoint/--config")
    p.add_argument("--fold", default="all",
                   help="with --run-dir: a subject id, or 'all' for the fold "
                        "ensemble (default)")
    p.add_argument("--device", default="cuda",
                   help="torch device to serve on (default cuda)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--micro-batch-ms", type=float, default=2.0,
                   help="coalesce concurrent /v1/predict requests arriving "
                        "within this window into one padded device batch "
                        "(0 disables micro-batching)")
    p.add_argument("--max-request-windows", type=int, default=256,
                   help="reject /v1/predict requests carrying more windows "
                        "than this with 413 (oversized bodies are refused "
                        "from Content-Length, before any allocation)")
    args = p.parse_args(argv)

    if args.artifact:
        p.error("--artifact is not yet ported to multimodalsignal_tpu_torch "
                "(ROADMAP.md, queue 1, item 5: hybrid, export, streaming, import); "
                "serve --run-dir, or --checkpoint with --config")
    if args.run_dir:
        if args.checkpoint or args.config:
            p.error("--run-dir replaces --checkpoint/--config")
        predictor = EnsemblePredictor.from_run(args.run_dir, args.fold, args.device)
    elif args.checkpoint and args.config:
        predictor = Predictor.from_files(args.checkpoint, args.config, args.device)
    else:
        p.error("provide --run-dir, or --checkpoint with --config")
    service = PredictionService(predictor, batch_size=args.batch_size,
                                micro_batch_ms=args.micro_batch_ms,
                                max_request_windows=args.max_request_windows)
    # Warm the batched forward (and build the CUDA kernels) before accepting
    # traffic, so the first request does not pay for it.
    warm = np.zeros((1,) + tuple(service.window_shape), np.float32)
    service.predict_windows({"windows": warm.tolist()})
    service.requests_served = 0
    service.windows_served = 0
    if service._batcher is not None:
        service._batcher.batches_run = 0

    server = make_server(service, args.host, args.port)
    card = service.health()
    host, port = server.server_address[:2]   # the bound port, also for --port 0
    print(f"Serving {card['model']} ({card['classification_mode']}, "
          f"channels {card['channels']}, backend {card['backend']}) "
          f"on http://{host}:{port} [{card['platform']}]",
          flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.shutdown()
    finally:
        server.server_close()
        service.close()


if __name__ == "__main__":
    main()
