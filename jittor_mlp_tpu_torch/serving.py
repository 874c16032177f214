"""Batched inference serving for the port's models.

Counterpart of ``jittor_mlp_tpu/serving.py``. ``Predictor`` wraps a model
with the serving plumbing:

- fixed-shape batching: requests pad up to ``batch_size``, so every forward
  has one shape;
- uint8 NHWC upload with on-device /255, normalize and (only when the size
  differs) resize;
- bf16 weights and activations with a float32 softmax, top-k taken on the
  device, so only (N, k) values come back to the host;
- the JAX Predictor's int8 options: ``weights="int8"`` (weight-only int8,
  dequantized once at build) and ``compute="int8"`` (dynamic W8A8 serving).

The device is the model's; the factories build on the card by default.

    p = Predictor(MLPMixerForImageClassification(), batch_size=8)
    labels, probs = p.predict(images_u8)   # (N, k) each, N ≤ batch_size
"""

from __future__ import annotations

import contextlib
import threading
import time

import numpy as np
import torch

from . import config
from .data.preprocess import IMAGENET_MEAN, IMAGENET_STD, resize_bilinear


class Predictor:
    def __init__(self, model, batch_size=8, image_size=224, top_k=5,
                 bf16=None, mean=IMAGENET_MEAN, std=IMAGENET_STD,
                 preprocess=True, weights=None, compute=None):
        """bf16=None (default): resolve the serving dtype from
        ``tuned.serve_settings`` (bf16 for every model while the port's
        table is empty; a row with dtype "int8" selects compute="int8").
        Pass bf16=True / bf16=False (or compute=) to override.
        ``self.dtype`` records the resolved choice: "int8", "bf16" or "f32".

        weights="int8": quantize the weights to per-channel int8 with the
        JAX package's rule (``quant.quantize_state_dict``) and dequantize
        them once, here, to the compute dtype.

        compute="int8": run every forward under ``config.int8_mode()`` for
        the thread that runs it: dense ops as dynamic W8A8 int8, and in
        bf16 eval the W8A8 block kernels. The choice travels with the call,
        so Predictors of both kinds can serve side by side from
        MicroBatcher's threads."""
        if weights not in (None, "int8"):
            raise ValueError(f"unknown weights option {weights!r}")
        if compute not in (None, "int8"):
            raise ValueError(f"unknown compute option {compute!r}")
        self.model = model.eval()
        if bf16 is None:
            from .tuned import serve_settings

            rec = serve_settings(getattr(model, "name", None))
            choice = rec["dtype"] if rec else "bf16"
            bf16 = choice != "f32"
            if choice == "int8" and compute is None and weights is None:
                compute = "int8"
        self.dtype = "int8" if compute == "int8" else "bf16" if bf16 else "f32"
        self._int8 = compute == "int8"
        if weights == "int8":
            from .quant import dequantize_state_dict, quantize_state_dict

            q = quantize_state_dict(self.model.name, self.model.state_dict())
            self.model.load_state_dict(
                dequantize_state_dict(q, torch.bfloat16 if bf16 else torch.float32))
        if bf16:
            self.model.to_bf16()
        self._compute_dtype = torch.bfloat16 if bf16 else torch.float32
        self.device = self.model.device
        self.batch_size = batch_size
        self.image_size = image_size
        self.top_k = top_k
        self._mean = torch.as_tensor(mean, dtype=torch.float32, device=self.device)
        self._std = torch.as_tensor(std, dtype=torch.float32, device=self.device)
        self._preprocess = preprocess
        # per-request wall-clock ring buffer (seconds). Locked: predict may
        # run concurrently from MicroBatcher's executor pool.
        self._lat = np.zeros(1024, np.float64)
        self._lat_n = 0
        self._lat_lock = threading.Lock()

    @torch.inference_mode()
    def _fwd(self, images):
        if self._preprocess:
            x = images.float() / 255.0
            x = (x - self._mean) / self._std
            if x.shape[1] != self.image_size:
                x = resize_bilinear(x, self.image_size)
            x = x.permute(0, 3, 1, 2)
        else:
            x = images
        with config.int8_mode() if self._int8 else contextlib.nullcontext():
            logits = self.model.forward(x.to(self._compute_dtype)).float()
        probs = torch.softmax(logits, dim=-1)
        top = torch.topk(probs, self.top_k, dim=-1)
        return top.indices, top.values

    def warmup(self):
        """Run one padded batch ahead of traffic (builds the kernels)."""
        if self._preprocess:
            dummy = np.zeros(
                (self.batch_size, self.image_size, self.image_size, 3),
                np.uint8,
            )
        else:
            dummy = np.zeros(
                (self.batch_size, 3, self.image_size, self.image_size),
                np.float32,
            )
        self.predict(dummy)
        return self

    def predict(self, images):
        """images: uint8 NHWC (preprocess=True) or float NCHW. N ≤ batch_size
        (padded internally to the fixed shape). Returns (labels, probs),
        both (N, top_k) numpy arrays."""
        images = np.asarray(images)
        n = images.shape[0]
        if n > self.batch_size:
            raise ValueError(
                f"request of {n} exceeds batch_size={self.batch_size}; "
                f"split upstream or build a larger Predictor"
            )
        if n < self.batch_size:
            pad = np.zeros((self.batch_size - n, *images.shape[1:]),
                           images.dtype)
            images = np.concatenate([images, pad])
        t0 = time.perf_counter()
        idx, probs = self._fwd(torch.from_numpy(images).to(self.device))
        out = idx.cpu().numpy()[:n], probs.cpu().numpy()[:n]
        # the copies to the host wait for the device, so the stopwatch
        # covers upload + forward + top-k download: the request time
        dt = time.perf_counter() - t0
        with self._lat_lock:
            self._lat[self._lat_n % self._lat.size] = dt
            self._lat_n += 1
        return out

    def latency_stats(self):
        """Request-latency percentiles over the recent window (up to the
        last 1024 ``predict`` calls, warmup included until it rotates out).
        Returns {} before any request; times in ms."""
        with self._lat_lock:
            n = min(self._lat_n, self._lat.size)
            if n == 0:
                return {}
            w = np.sort(self._lat[:n]) * 1000.0
        q = lambda p: float(w[min(int(p * n), n - 1)])
        return {
            "count": self._lat_n,
            "mean_ms": float(w.mean()),
            "p50_ms": q(0.50),
            "p95_ms": q(0.95),
            "p99_ms": q(0.99),
            "max_ms": float(w[-1]),
        }


class _Pending:
    __slots__ = ("image", "event", "result", "error", "t0")

    def __init__(self, image):
        self.image = image
        self.event = threading.Event()
        self.result = None
        self.error = None
        self.t0 = time.perf_counter()


class MicroBatcher:
    """Deadline-based request coalescing in front of a Predictor.

    ``submit`` blocks the calling thread while a dispatcher packs queued
    requests into one fixed-shape padded ``Predictor.predict`` the moment
    the batch fills or the oldest request has waited ``max_delay_ms``.
    Per-request results equal the unbatched ones: the model is per-sample
    independent in eval mode.

        batcher = MicroBatcher(Predictor(model, batch_size=16))
        labels, probs = batcher.submit(image)   # (k,), (k,) for ONE image

    ``in_flight`` runs dispatched batches through a small executor pool, so
    host-side packing and transfers of one batch overlap the device work of
    another.
    """

    def __init__(self, predictor, max_delay_ms=2.0, in_flight=4):
        from concurrent.futures import ThreadPoolExecutor

        self.predictor = predictor
        self.max_delay = max_delay_ms / 1e3
        self._cv = threading.Condition()
        self._queue = []
        self._stopped = False
        self._shape = None  # fixed per-image shape, set by the first submit
        # batch-occupancy histogram: _fills[n] = batches dispatched with n
        # requests
        self._fills = np.zeros(predictor.batch_size + 1, np.int64)
        self._batches = 0
        self._requests = 0
        self._stats_lock = threading.Lock()
        self._pool = ThreadPoolExecutor(
            max_workers=max(1, in_flight), thread_name_prefix="microbatch"
        )
        self._worker = threading.Thread(
            target=self._run, name="microbatcher", daemon=True
        )
        self._worker.start()

    def submit(self, image):
        """Classify ONE image; blocks until its coalesced batch returns.

        image: (H, W, C) uint8 when the Predictor preprocesses, else the
        float layout its forward expects. All submissions must share one
        shape; a mismatch raises here, in the caller, without poisoning the
        in-flight batch. Returns (labels, probs), each a (top_k,) array.
        """
        image = np.asarray(image)
        p = _Pending(image)
        with self._cv:
            if self._stopped:
                raise RuntimeError("MicroBatcher is closed")
            if self._shape is None:
                self._shape = image.shape
            elif image.shape != self._shape:
                raise ValueError(
                    f"image shape {image.shape} != batch shape "
                    f"{self._shape}; resize upstream (the serving batch "
                    f"is one fixed-shape stack)"
                )
            self._queue.append(p)
            self._cv.notify_all()
        p.event.wait()
        if p.error is not None:
            raise p.error
        return p.result

    def _run(self):
        cap = self.predictor.batch_size
        while True:
            with self._cv:
                while not self._queue and not self._stopped:
                    self._cv.wait()
                if not self._queue and self._stopped:
                    return
                # the oldest request's deadline bounds everyone's wait
                deadline = self._queue[0].t0 + self.max_delay
                while len(self._queue) < cap and not self._stopped:
                    remaining = deadline - time.perf_counter()
                    if remaining <= 0:
                        break
                    self._cv.wait(remaining)
                batch = self._queue[:cap]
                del self._queue[:cap]
            self._pool.submit(self._execute, batch)

    def _execute(self, batch):
        try:
            labels, probs = self.predictor.predict(
                np.stack([p.image for p in batch])
            )
            for i, p in enumerate(batch):
                p.result = (labels[i], probs[i])
        except Exception as e:  # surface in every waiting caller
            for p in batch:
                p.error = e
        with self._stats_lock:
            self._batches += 1
            self._requests += len(batch)
            self._fills[len(batch)] += 1
        for p in batch:
            p.event.set()

    def stats(self):
        """Batching effectiveness: dispatched batches, mean fill (of
        batch_size), and the occupancy histogram {fill: count}."""
        with self._stats_lock:
            requests, b = self._requests, self._batches
            fills = self._fills.copy()
        return {
            "requests": int(requests),
            "batches": int(b),
            "batch_size": int(self.predictor.batch_size),
            "mean_fill": float(requests / b) if b else 0.0,
            "fill_hist": {
                str(i): int(c)
                for i, c in enumerate(fills)
                if i > 0 and c
            },
        }

    def close(self):
        """Drain the queue, process the final partial batch, stop the
        dispatcher and executor pool. Subsequent ``submit`` calls raise."""
        with self._cv:
            self._stopped = True
            self._cv.notify_all()
        self._worker.join()
        self._pool.shutdown(wait=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
