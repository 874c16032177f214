"""Dataset ingestion (counterpart of ``jittor_mlp_tpu/data/dataset.py``).

- ImageFolderDataset: torchvision-style class-per-subdirectory image tree,
  decoded on the host to uint8 HWC at a fixed size — batches ride the native
  threaded JPEG/PNG decoder (data/native/decode.cpp) with per-image PIL
  fallback for anything it can't handle.
- ArrayDataset: in-memory uint8 images + labels.
- BatchIterator: epoch shuffling (``np.random.default_rng(seed)``, the
  JAX package's order) + background-thread prefetch producing numpy batches
  {'image': u8 NHWC, 'label': i32}.
- make_augment: random crop + horizontal flip + normalize + NHWC→NCHW on the
  images' device, drawn from an explicit ``torch.Generator`` — uploads stay
  uint8 (a quarter of the float32 bytes), all per-pixel math runs on the
  device.
"""

from __future__ import annotations

import os
import queue
import threading

import numpy as np
import torch

from .loader import resize_batch
from .preprocess import IMAGENET_MEAN, IMAGENET_STD

_IMG_EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".webp")


class ArrayDataset:
    """In-memory dataset of uint8 HWC images and integer labels."""

    def __init__(self, images_u8, labels):
        self.images = np.asarray(images_u8, np.uint8)
        self.labels = np.asarray(labels, np.int32)
        if len(self.images) != len(self.labels):
            raise ValueError(f"{len(self.images)} images, {len(self.labels)} labels")

    def __len__(self):
        return len(self.images)

    def get(self, idx):
        return self.images[idx], self.labels[idx]


def pil_square(f, size):
    """Decode file or file object ``f`` with PIL to a (size, size, 3) uint8
    array: RGB, shorter side resized to ``size`` (dims rounded, never below
    it), center crop — the geometry of the native decoder."""
    from PIL import Image

    with Image.open(f) as im:
        im = im.convert("RGB")
        w, h = im.size
        scale = size / min(w, h)
        im = im.resize((max(size, round(w * scale)), max(size, round(h * scale))))
        arr = np.asarray(im, np.uint8)
    top = (arr.shape[0] - size) // 2
    left = (arr.shape[1] - size) // 2
    return arr[top:top + size, left:left + size]


class ImageFolderDataset:
    """Class-per-subdirectory image tree (the torchvision ImageFolder layout).

    Images decode on the host and resize to ``decode_size`` (square) uint8
    HWC at access time; pair with BatchIterator for shuffling/prefetch and
    make_augment for on-device random crops down to the model size.
    """

    def __init__(self, root, decode_size=256):
        self.root = root
        self.decode_size = decode_size
        self.classes = sorted(d for d in os.listdir(root)
                              if os.path.isdir(os.path.join(root, d)))
        self.class_to_idx = {c: i for i, c in enumerate(self.classes)}
        self.samples = []
        for c in self.classes:
            cdir = os.path.join(root, c)
            for fn in sorted(os.listdir(cdir)):
                if fn.lower().endswith(_IMG_EXTS):
                    self.samples.append((os.path.join(cdir, fn), self.class_to_idx[c]))
        if not self.samples:
            raise ValueError(f"no images under {root}")

    def __len__(self):
        return len(self.samples)

    def get_batch(self, idxs):
        """Decode a batch on the native C++ thread pool (libjpeg scaled
        decode + libpng, shorter-side resize + center crop — the geometry of
        get()); images the native path can't handle (bmp/webp/CMYK/alpha/
        corrupt) fall back to PIL per image."""
        from .loader import decode_available, decode_batch

        if not decode_available():
            imgs, labels = zip(*(self.get(i) for i in idxs))
            return np.stack(imgs), np.asarray(labels, np.int32)
        buffers, labels = [], []
        for i in idxs:
            path, label = self.samples[i]
            with open(path, "rb") as f:
                buffers.append(f.read())
            labels.append(label)
        batch, fail = decode_batch(buffers, self.decode_size)
        for j in np.nonzero(fail)[0]:
            batch[j] = self.get(idxs[j])[0]
        return batch, np.asarray(labels, np.int32)

    def get(self, idx):
        path, label = self.samples[idx]
        return pil_square(path, self.decode_size), np.int32(label)


class BatchIterator:
    """Shuffled, prefetching batch iterator over a dataset.

    Yields {'image': uint8 (B, S, S, 3) NHWC, 'label': int32 (B,)} numpy
    batches; a background thread keeps ``prefetch`` batches decoded ahead.
    An error in that thread is raised in the consumer. ``rows=(offset,
    size)`` keeps rows ``[offset, offset + size)`` of each batch, chosen
    before anything is decoded: a data-parallel rank's share
    (``parallel.multihost.process_batch_offset`` and ``_size``).
    """

    def __init__(self, dataset, batch_size, shuffle=True, seed=0,
                 drop_last=True, prefetch=2, resize_to=None, rows=None):
        self.ds = dataset
        self.rows = rows
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.resize_to = resize_to
        self._rng = np.random.default_rng(seed)

    def _epoch_order(self):
        order = np.arange(len(self.ds))
        if self.shuffle:
            self._rng.shuffle(order)
        return order

    def _assemble(self, idxs):
        if hasattr(self.ds, "get_batch"):
            batch, labels = self.ds.get_batch(idxs)
        else:
            imgs, labels = zip(*(self.ds.get(i) for i in idxs))
            batch = np.stack(imgs)
        if self.resize_to and batch.shape[1] != self.resize_to:
            batch = resize_batch(batch, self.resize_to)
        return {"image": batch, "label": np.asarray(labels, np.int32)}

    def __iter__(self):
        order = self._epoch_order()
        n = len(order)
        chunks = [order[e - self.batch_size:e]
                  for e in range(self.batch_size, n + 1, self.batch_size)]
        if not self.drop_last and n % self.batch_size:
            chunks.append(order[-(n % self.batch_size):])
        if self.rows is not None:
            off, size = self.rows
            chunks = [c[off:off + size] for c in chunks]

        q = queue.Queue(maxsize=self.prefetch)
        stop = object()

        def worker():
            try:
                for c in chunks:
                    q.put(self._assemble(c))
            except Exception as e:  # handed to the consumer
                q.put(e)
            finally:
                q.put(stop)

        threading.Thread(target=worker, daemon=True).start()
        while True:
            item = q.get()
            if item is stop:
                return
            if isinstance(item, Exception):
                raise item
            yield item


def draw_crops(generator, batch, height, width, image_size, flip):
    """Per-image crop corners and flips for ``make_augment``, drawn from
    ``generator`` on its device: tops in [0, height - image_size], lefts in
    [0, width - image_size], flips with probability 0.5 (all False without
    ``flip``)."""
    dev = generator.device
    tops = torch.randint(0, height - image_size + 1, (batch,), generator=generator, device=dev)
    lefts = torch.randint(0, width - image_size + 1, (batch,), generator=generator, device=dev)
    if flip:
        flips = torch.rand(batch, generator=generator, device=dev) < 0.5
    else:
        flips = torch.zeros(batch, dtype=torch.bool, device=dev)
    return tops, lefts, flips


def make_augment(image_size=224, mean=IMAGENET_MEAN, std=IMAGENET_STD,
                 flip=True, to_nchw=True):
    """Train-time augmentation on the images' device.

    fn(generator, images_u8_nhwc) -> float32 NCHW batch: per-image random
    crop from the decoded size down to ``image_size`` and random horizontal
    flip (``draw_crops``, one gather), /255 + mean/std normalize. Upload
    stays uint8. ``fn(generator, images, window=(global_batch, offset))``
    takes ``images`` as rows ``[offset, offset + B)`` of a batch of
    ``global_batch``: the draws cover the global batch and the images
    take their rows, as the whole batch's augmentation would give them.
    """

    def augment(generator, images, window=None):
        B, H, W, C = images.shape
        dev = images.device
        n, off = (B, 0) if window is None else window
        tops, lefts, flips = (t[off:off + B].to(dev) for t in
                              draw_crops(generator, n, H, W, image_size, flip))
        r = torch.arange(image_size, device=dev)
        rows = tops[:, None] + r  # (B, S)
        cols = lefts[:, None] + torch.where(flips[:, None], image_size - 1 - r, r)
        crops = images[torch.arange(B, device=dev)[:, None, None], rows[:, :, None],
                       cols[:, None, :]]
        m = torch.as_tensor(mean, dtype=torch.float32, device=dev)
        s = torch.as_tensor(std, dtype=torch.float32, device=dev)
        x = (crops.float() / 255.0 - m) / s
        return x.permute(0, 3, 1, 2) if to_nchw else x

    return augment
