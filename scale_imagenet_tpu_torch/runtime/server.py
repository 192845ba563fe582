"""Inference serving: an HTTP server with dynamic batching (counterpart of
``scale_imagenet_tpu/runtime/server.py:38,153,185``).

A threaded HTTP front end feeds the devices through a dynamic batcher:
requests are coalesced (up to ``batch_size``, waiting at most
``max_wait_ms`` for stragglers) and run as ONE forward, padded to
``batch_size`` so the device always sees one shape.

Over a mesh of several devices (``parallel/mesh.py::make_local_mesh``,
JAX's ``make_forward(mesh, spatial)``) the padded batch is split over
them (``parallel/local.py``): one persistent worker thread a replica, each
on a CUDA stream of its own and in ``torch.inference_mode``, runs the
replica's forward on its data slice, or under ``spatial`` (``--sp``) on
its rows of it, the rows' exchanges going through a ``LocalGroup`` a data
index.  The replicas run at the same time; the batcher waits for all of
them, then gathers the probabilities.  A 1x1 mesh runs the forward in the
batcher's own thread, as one device always did.

Endpoints:
  GET  /healthz  -> {"model", "device", "mesh", "devices", "batch_size",
                    "served", "batches", "avg_batch_fill", "batch_ms_p50",
                    "batch_ms_p95", "queue_ms_p50", "queue_ms_p95"}: the
                    batch ms are the device calls' times, the queue ms
                    each request's wait from its arrival at the batcher
                    to the start of its batch's forward (recent ones)
  POST /predict  -> body = JPEG/PNG bytes (``image/*``, decoded with
                    Pillow through the model's PIL-exact eval transform,
                    ``data/transforms.py``) or a raw float32 NHWC tensor
                    of one image (application/octet-stream); the JSON
                    answer carries the top-5 class indices, their
                    probabilities and the latency.
"""

from __future__ import annotations

import contextlib
import io
import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from ..data.transforms import imagenet_eval_transform
from ..parallel.local import LocalGroup, gather_probs, split_batch
from ..parallel.sp import RowShard


class DynamicBatcher:
    """Coalesce concurrent requests into one padded device call.

    The worker thread takes the first pending request, waits up to
    ``max_wait_ms`` for more (up to ``batch_size``), pads the stack to
    exactly ``batch_size`` rows and runs the forward once.  Results go back
    through per-request events.
    """

    _LAT_WINDOW = 512       # recent batches' and requests' ring size

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
        self._q.put((x, done, slot, time.perf_counter()))
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
            self._queue_ring = [0.0] * self._LAT_WINDOW
            self._queue_n = 0

    def stats(self) -> dict:
        """Throughput counters, batch fill, recent device-batch latency
        and recent requests' queue wait."""
        with self._stats_lock:
            served, batches = self.served, self.batches
            lat = sorted(self._lat_ring[:min(self._lat_n, self._LAT_WINDOW)])
            wait = sorted(self._queue_ring[:min(self._queue_n,
                                                self._LAT_WINDOW)])
        return {
            "served": served,
            "batches": batches,
            "avg_batch_fill": round(served / batches, 2) if batches else 0.0,
            "batch_ms_p50": _quantile(lat, 0.5),
            "batch_ms_p95": _quantile(lat, 0.95),
            "queue_ms_p50": _quantile(wait, 0.5),
            "queue_ms_p95": _quantile(wait, 0.95),
        }

    def close(self):
        self._stop.set()
        self._thread.join(timeout=5)
        # fail queued requests now instead of letting their handler
        # threads sit out the submit timeout
        while True:
            try:
                _, done, slot, _ = self._q.get_nowait()
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
                with self._stats_lock:
                    for *_, arrived in batch:
                        self._queue_ring[self._queue_n % self._LAT_WINDOW] \
                            = (t0 - arrived) * 1e3
                        self._queue_n += 1
                out = self._forward(xs)[:n]
                ms = (time.perf_counter() - t0) * 1e3
                # stats before done.set(): a caller may read or reset the
                # counters the moment its event fires
                with self._stats_lock:
                    self.served += n
                    self.batches += 1
                    self._lat_ring[self._lat_n % self._LAT_WINDOW] = ms
                    self._lat_n += 1
                for i, (_, done, slot, _) in enumerate(batch):
                    slot["out"] = out[i]
                    done.set()
            except Exception as e:      # propagate, don't hang clients
                for _, done, slot, _ in batch:
                    slot["error"] = repr(e)
                    done.set()


def _quantile(values: list, q: float):
    """The ``q`` quantile of sorted ``values``, rounded to 0.01 (None for
    none)."""
    return round(values[int(len(values) * q)], 2) if values else None


def _probs(apply, x: torch.Tensor) -> torch.Tensor:
    return torch.softmax(apply(x).float(), dim=-1)


class _Replica:
    """One replica's worker thread: ``run(piece)`` hands it a host piece
    of the batch, ``wait()`` returns its probabilities on its device."""

    def __init__(self, apply, device: torch.device, name: str, group=None):
        self.apply, self.device, self.group = apply, device, group
        self._jobs: queue.Queue = queue.Queue()
        self._out: dict = {}
        self._done = threading.Event()
        self._thread = threading.Thread(target=self._work, name=name,
                                        daemon=True)
        self._thread.start()

    def _work(self):
        cuda = self.device.type == "cuda"
        stream = torch.cuda.Stream(self.device) if cuda else None
        with torch.inference_mode(), (torch.cuda.stream(stream) if cuda
                                      else contextlib.nullcontext()):
            while True:
                piece = self._jobs.get()
                if piece is None:
                    return
                try:
                    out = _probs(self.apply, piece.to(self.device))
                    if cuda:
                        stream.synchronize()
                    self._out = {"probs": out}
                except BaseException as e:   # noqa: BLE001: to the batcher
                    self._out = {"error": e}
                    if self.group is not None:
                        self.group.abort()   # its peers raise, not wait
                self._done.set()

    def run(self, piece: torch.Tensor) -> None:
        self._done.clear()
        self._jobs.put(piece)

    def wait(self) -> dict:
        self._done.wait()
        return self._out

    def close(self) -> None:
        self._jobs.put(None)
        self._thread.join(timeout=5)


class MeshForward:
    """numpy NHWC batch -> numpy class probabilities over a ``LocalMesh``:
    ``replica(d, m, shard)`` (``shard`` a ``RowShard`` joined by its data
    index's ``LocalGroup`` under ``spatial``, else None) gives the forward
    of data index ``d``'s replica on model rank ``m``'s device; without
    ``spatial`` model rank 0 alone serves a data index (the others would
    repeat its work)."""

    def __init__(self, replica, mesh, spatial: bool = False):
        self.mesh, self.spatial = mesh, spatial
        ranks = range(mesh["model"]) if spatial else (0,)
        self._groups, self._replicas = [], {}
        for d in range(mesh["data"]):
            group = LocalGroup([mesh.device(d, m) for m in ranks]) \
                if spatial else None
            self._groups.append(group)
            for m in ranks:
                shard = RowShard(mesh["model"], m, group.member(m)) \
                    if spatial else None
                self._replicas[d, m] = _Replica(
                    replica(d, m, shard), mesh.device(d, m),
                    f"replica-d{d}-m{m}", group)

    def __call__(self, xs: np.ndarray) -> np.ndarray:
        pieces = split_batch(xs, self.mesh, self.spatial)
        for key, piece in pieces.items():
            self._replicas[key].run(piece)
        outs = {key: self._replicas[key].wait() for key in pieces}
        errors = [o["error"] for o in outs.values() if "error" in o]
        if errors:
            for group in self._groups:
                if group is not None:
                    group.reset()            # every replica has returned
            # a replica's own fault before its peers' broken barriers
            errors.sort(key=lambda e: isinstance(e,
                                                 threading.BrokenBarrierError))
            raise errors[0]
        return gather_probs({k: o["probs"] for k, o in outs.items()},
                            self.mesh)

    def close(self) -> None:
        for rep in self._replicas.values():
            rep.close()


def make_forward(replica, mesh, spatial: bool = False):
    """numpy NHWC batch -> numpy class probabilities, with a ``close()``
    that stops its threads.  ``replica(d, m, shard)`` gives a replica's
    ``x -> logits`` (``MeshForward``); on a 1x1 mesh ``replica(0, 0,
    None)`` runs on ``mesh.device(0, 0)`` in the caller's thread."""
    if mesh["data"] * mesh["model"] > 1:
        return MeshForward(replica, mesh, spatial)
    apply, device = replica(0, 0, None), mesh.device(0, 0)

    def forward(xs: np.ndarray) -> np.ndarray:
        with torch.inference_mode():
            return _probs(apply, torch.from_numpy(xs).to(device)).cpu() \
                .numpy()
    forward.close = lambda: None
    return forward


def _decode_image(body: bytes, transform) -> np.ndarray:
    """JPEG/PNG bytes -> the HWC float32 eval input."""
    from PIL import Image

    with Image.open(io.BytesIO(body)) as img:
        return transform(img.convert("RGB"))


def serve(replica, name: str, input_shape, *, mesh, spatial: bool = False,
          host: str = "127.0.0.1", port: int = 8000, batch_size: int = 8,
          max_wait_ms: float = 2.0, ready_event=None, stop_event=None,
          verbose: bool = True, transform=imagenet_eval_transform) -> int:
    """Run the HTTP server until ``stop_event`` is set (or forever).

    ``replica(d, m, shard)``: the forward (NHWC float32 tensor -> logits)
    of a replica over ``mesh`` (``make_forward``); ``spatial``: each image's
    rows over the mesh's model axis.  ``input_shape``: the per-sample HWC
    shape posts must match.  ``transform``: the eval transform of image
    uploads (the 32x32 models' is the CIFAR one).  ``ready_event`` is set
    (with a ``port`` attribute) once the socket is bound.  Returns the
    bound port.
    """
    forward = make_forward(replica, mesh, spatial)
    example = np.zeros(input_shape, np.float32)
    batcher = DynamicBatcher(forward, example, batch_size=batch_size,
                             max_wait_ms=max_wait_ms)
    devices = [str(d) for d in mesh.devices]
    # first call builds the kernels and warms the devices; keep it out of
    # the stats
    try:
        batcher.submit(example, timeout=600.0)
    except BaseException:
        batcher.close()
        forward.close()
        raise
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
            self._json(200, {"model": name, "device": devices[0],
                             "mesh": dict(mesh), "spatial": spatial,
                             "devices": devices, "batch_size": batch_size,
                             **batcher.stats()})

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
              f"(batch {batch_size}, wait {max_wait_ms} ms, mesh "
              f"{dict(mesh)}{' --sp' if spatial else ''} over {devices})")
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
        forward.close()
    return bound_port
