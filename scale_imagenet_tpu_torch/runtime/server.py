"""Inference serving: an HTTP server with dynamic batching (counterpart of
``scale_imagenet_tpu/runtime/server.py:38,153,185``).

A threaded HTTP front end feeds one device worker through a dynamic batcher:
requests are coalesced (up to ``batch_size``, waiting at most
``max_wait_ms`` for stragglers) and run as ONE forward, padded to
``batch_size`` so the device always sees one shape.

Endpoints:
  GET  /healthz  -> {"model", "device", "batch_size", "served", ...}
  POST /predict  -> body = JPEG/PNG bytes (``image/*``, decoded with
                    Pillow through the model's PIL-exact eval transform,
                    ``data/transforms.py``) or a raw float32 NHWC tensor
                    of one image (application/octet-stream); the JSON
                    answer carries the top-5 class indices, their
                    probabilities and the latency.
"""

from __future__ import annotations

import io
import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from ..data.transforms import imagenet_eval_transform


class DynamicBatcher:
    """Coalesce concurrent requests into one padded device call.

    The worker thread takes the first pending request, waits up to
    ``max_wait_ms`` for more (up to ``batch_size``), pads the stack to
    exactly ``batch_size`` rows and runs the forward once.  Results go back
    through per-request events.
    """

    _LAT_WINDOW = 512                   # recent-batch latency ring size

    def __init__(self, forward, example_input: np.ndarray,
                 batch_size: int = 8, max_wait_ms: float = 2.0):
        self.batch_size = batch_size
        self.max_wait_s = max_wait_ms / 1e3
        self._forward = forward
        self._shape = tuple(example_input.shape)   # per-sample HWC
        self._q: queue.Queue = queue.Queue()
        self._stop = threading.Event()
        self._stats_lock = threading.Lock()
        self.reset_stats()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def submit(self, x: np.ndarray, timeout: float = 30.0) -> np.ndarray:
        if tuple(x.shape) != self._shape:
            raise ValueError(f"input shape {x.shape} != model input "
                             f"{self._shape}")
        done = threading.Event()
        slot: dict = {}
        self._q.put((x, done, slot))
        if not done.wait(timeout):
            raise TimeoutError("inference timed out")
        if "error" in slot:
            raise RuntimeError(slot["error"])
        return slot["out"]

    def reset_stats(self):
        with self._stats_lock:
            self.served = 0
            self.batches = 0                 # device calls run
            self._lat_ring = [0.0] * self._LAT_WINDOW
            self._lat_n = 0

    def stats(self) -> dict:
        """Throughput counters, batch fill, recent device-batch latency."""
        with self._stats_lock:
            served, batches = self.served, self.batches
            lat = sorted(self._lat_ring[:min(self._lat_n, self._LAT_WINDOW)])
        return {
            "served": served,
            "batches": batches,
            "avg_batch_fill": round(served / batches, 2) if batches else 0.0,
            "batch_ms_p50": round(lat[len(lat) // 2], 2) if lat else None,
            "batch_ms_p95": round(lat[int(len(lat) * 0.95)], 2)
            if lat else None,
        }

    def close(self):
        self._stop.set()
        self._thread.join(timeout=5)
        # fail queued requests now instead of letting their handler
        # threads sit out the submit timeout
        while True:
            try:
                _, done, slot = self._q.get_nowait()
            except queue.Empty:
                break
            slot["error"] = "server shutting down"
            done.set()

    def _worker(self):
        while not self._stop.is_set():
            try:
                first = self._q.get(timeout=0.1)
            except queue.Empty:
                continue
            batch = [first]
            deadline = time.monotonic() + self.max_wait_s
            while len(batch) < self.batch_size:
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                try:
                    batch.append(self._q.get(timeout=left))
                except queue.Empty:
                    break
            xs = np.stack([b[0] for b in batch])
            n = xs.shape[0]
            if n < self.batch_size:      # one shape: pad, run, slice
                pad = np.zeros((self.batch_size - n,) + self._shape,
                               xs.dtype)
                xs = np.concatenate([xs, pad])
            try:
                t0 = time.perf_counter()
                out = self._forward(xs)[:n]
                ms = (time.perf_counter() - t0) * 1e3
                # stats before done.set(): a caller may read or reset the
                # counters the moment its event fires
                with self._stats_lock:
                    self.served += n
                    self.batches += 1
                    self._lat_ring[self._lat_n % self._LAT_WINDOW] = ms
                    self._lat_n += 1
                for i, (_, done, slot) in enumerate(batch):
                    slot["out"] = out[i]
                    done.set()
            except Exception as e:      # propagate, don't hang clients
                for _, done, slot in batch:
                    slot["error"] = repr(e)
                    done.set()


def make_forward(apply, device: torch.device):
    """numpy NHWC batch -> numpy class probabilities, through ``apply``
    (NHWC tensor -> logits) on ``device``."""
    def forward(xs: np.ndarray) -> np.ndarray:
        with torch.inference_mode():
            logits = apply(torch.from_numpy(xs).to(device))
            probs = torch.softmax(logits.float(), dim=-1)
            return probs.cpu().numpy()
    return forward


def _decode_image(body: bytes, transform) -> np.ndarray:
    """JPEG/PNG bytes -> the HWC float32 eval input."""
    from PIL import Image

    with Image.open(io.BytesIO(body)) as img:
        return transform(img.convert("RGB"))


def serve(apply, name: str, input_shape, *, device: torch.device,
          host: str = "127.0.0.1", port: int = 8000, batch_size: int = 8,
          max_wait_ms: float = 2.0, ready_event=None, stop_event=None,
          verbose: bool = True, transform=imagenet_eval_transform) -> int:
    """Run the HTTP server until ``stop_event`` is set (or forever).

    ``apply``: NHWC float32 tensor -> logits.  ``input_shape``: the
    per-sample HWC shape posts must match.  ``transform``: the eval
    transform of image uploads (the 32x32 models' is the CIFAR one).
    ``ready_event`` is set (with a ``port`` attribute) once the socket is
    bound.  Returns the bound port.
    """
    forward = make_forward(apply, device)
    example = np.zeros(input_shape, np.float32)
    batcher = DynamicBatcher(forward, example, batch_size=batch_size,
                             max_wait_ms=max_wait_ms)
    # first call builds the kernels and warms the device; keep it out of
    # the stats
    batcher.submit(example, timeout=600.0)
    batcher.reset_stats()

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):
            if verbose:
                print("serve:", fmt % args)

        def _json(self, code: int, obj):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path != "/healthz":
                return self._json(404, {"error": "unknown path"})
            self._json(200, {"model": name, "device": str(device),
                             "batch_size": batch_size, **batcher.stats()})

        def do_POST(self):
            if self.path != "/predict":
                return self._json(404, {"error": "unknown path"})
            try:
                length = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(length)
                ctype = self.headers.get("Content-Type",
                                         "application/octet-stream")
                if ctype.startswith("image/"):
                    x = _decode_image(body, transform)
                else:
                    x = np.frombuffer(body, np.float32).reshape(input_shape)
                t0 = time.perf_counter()
                probs = batcher.submit(np.ascontiguousarray(x, np.float32))
                ms = (time.perf_counter() - t0) * 1e3
                top5 = np.argsort(probs)[::-1][:5]
                self._json(200, {
                    "top5": [int(i) for i in top5],
                    "probs": [float(probs[i]) for i in top5],
                    "latency_ms": round(ms, 2),
                })
            except Exception as e:
                self._json(400, {"error": repr(e)})

    httpd = ThreadingHTTPServer((host, port), Handler)
    bound_port = httpd.server_address[1]
    if verbose:
        print(f"serving {name} on http://{host}:{bound_port} "
              f"(batch {batch_size}, wait {max_wait_ms} ms, {device})")
    if ready_event is not None:
        ready_event.port = bound_port
        ready_event.set()
    try:
        if stop_event is None:
            httpd.serve_forever(poll_interval=0.2)
        else:
            httpd_thread = threading.Thread(target=httpd.serve_forever,
                                            kwargs={"poll_interval": 0.2},
                                            daemon=True)
            httpd_thread.start()
            stop_event.wait()
    finally:
        httpd.shutdown()
        httpd.server_close()
        batcher.close()
    return bound_port
