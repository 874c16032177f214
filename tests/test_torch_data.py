"""The port's data pipeline against jittor_mlp_tpu's, on the CPU.

- ``decode_batch`` (native libjpeg/libpng decode, shorter-side resize,
  center crop) bit-equal to the JAX package's on PNGs and JPEGs written with
  PIL, failure flags included (an alpha PNG, a BMP, corrupt bytes);
- ``normalize_batch``, ``resize_batch`` and ``HostLoader``, native and
  without the native library, against the JAX functions;
- ``make_preprocess`` against the JAX jitted pipeline within 1e-5, and
  ``patchify`` equal;
- ``ImageFolderDataset`` + ``BatchIterator``: the same batches in the same
  order as the JAX package's, shuffled and not, the ragged tail included;
- ``make_augment`` under one fixed pattern of crops and flips, patched into
  both packages (their random generators cannot agree), within 1e-6; and the
  port's draws on their own: in range, flips near half, one seed one batch.
"""

import io
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from jittor_mlp_tpu.data import dataset as jds
from jittor_mlp_tpu.data import loader as jloader
from jittor_mlp_tpu.data import preprocess as jpre
from jittor_mlp_tpu_torch import data as tdata
from jittor_mlp_tpu_torch.data import dataset as tds
from jittor_mlp_tpu_torch.data import loader as tloader
from jittor_mlp_tpu_torch.data import preprocess as tpre

SIZES = [(40, 56), (64, 48), (33, 70), (24, 24)]


def _array(h, w, seed):
    """A smooth seeded RGB image (JPEG keeps its content recognisable)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = rng.uniform(0, 255, 3) + 60 * np.sin(yy[..., None] / 5 + rng.uniform(0, 6, 3))
    base = base + 40 * np.cos(xx[..., None] / 7)
    return np.clip(base + rng.normal(0, 8, (h, w, 3)), 0, 255).astype(np.uint8)


def _encode(arr, fmt):
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format=fmt, **({"quality": 90} if fmt == "JPEG" else {}))
    return buf.getvalue()


def test_native_libraries_build_under_build_dir():
    assert tloader.native_available() and tloader.decode_available()
    built = os.listdir(tloader.BUILD_DIR)
    for name in ("fastloader", "decode"):
        assert any(f.startswith(f"{name}_") and f.endswith(".so") for f in built), built
    # nothing is built beside the sources
    assert not [f for f in os.listdir(tloader._NATIVE) if f.endswith(".so")]


@pytest.mark.parametrize("fmt", ["PNG", "JPEG"])
@pytest.mark.parametrize("size", [16, 32])
def test_decode_batch_matches_jax(fmt, size):
    bufs = [_encode(_array(h, w, i), fmt) for i, (h, w) in enumerate(SIZES)]
    got, gfail = tloader.decode_batch(bufs, size)
    want, wfail = jloader.decode_batch(bufs, size)
    assert got.shape == (len(bufs), size, size, 3) and got.dtype == np.uint8
    assert not gfail.any()
    np.testing.assert_array_equal(gfail, wfail)
    np.testing.assert_array_equal(got, want)


def test_decode_flags_what_it_cannot_read():
    rgba = np.dstack([_array(20, 30, 1), np.full((20, 30), 200, np.uint8)])
    buf = io.BytesIO()
    Image.fromarray(rgba, "RGBA").save(buf, format="PNG")
    bufs = [_encode(_array(20, 30, 2), "PNG"), buf.getvalue(), _encode(_array(20, 30, 3), "BMP"),
            b"\xff\xd8\xff not a jpeg", b""]
    got, gfail = tloader.decode_batch(bufs, 16)
    want, wfail = jloader.decode_batch(bufs, 16)
    np.testing.assert_array_equal(gfail, [False, True, True, True, True])
    np.testing.assert_array_equal(gfail, wfail)
    np.testing.assert_array_equal(got[0], want[0])


def test_decode_scale_one_is_the_center_crop():
    """At decode size = the shorter side, PNG decodes to the source's
    center crop exactly (no resize runs)."""
    arr = _array(24, 40, 5)
    got, fail = tloader.decode_batch([_encode(arr, "PNG")], 24)
    assert not fail[0]
    np.testing.assert_array_equal(got[0], arr[:, 8:32])
    np.testing.assert_array_equal(tds.pil_square(io.BytesIO(_encode(arr, "PNG")), 24),
                                  arr[:, 8:32])


def _u8(shape, seed=0):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


MEAN, STD = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
def test_normalize_batch_matches_jax(native, monkeypatch):
    x = _u8((3, 10, 12, 3))
    want = jloader.normalize_batch(x, MEAN, STD)
    if not native:
        monkeypatch.setattr(tloader, "_lib", lambda: None)
    got = tloader.normalize_batch(x, MEAN, STD)
    assert got.shape == (3, 3, 10, 12) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("out", [8, 20, (9, 14)])
def test_resize_batch_matches_jax(out):
    x = _u8((2, 13, 17, 3), seed=1)
    np.testing.assert_array_equal(tloader.resize_batch(x, out), jloader.resize_batch(x, out))


@pytest.mark.parametrize("out", [8, 20])
def test_resize_batch_fallback_matches_jax_fallback(out, monkeypatch):
    """Without the native library both packages resize as
    ``jax.image.resize`` (antialiased when shrinking) and round; the
    float resizes differ by rounding, so a pixel may land one level off."""
    x = _u8((2, 13, 17, 3), seed=2)
    monkeypatch.setattr(jloader, "_lib", lambda: None)
    monkeypatch.setattr(tloader, "_lib", lambda: None)
    got = tloader.resize_batch(x, out).astype(int)
    want = jloader.resize_batch(x, out).astype(int)
    assert np.abs(got - want).max() <= 1 and (got == want).mean() > 0.99


def test_host_loader_matches_jax():
    x = _u8((4, 20, 20, 3), seed=3)
    got = tloader.HostLoader(image_size=16)(x)
    want = jloader.HostLoader(image_size=16)(x)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    same = tloader.HostLoader(image_size=20)(x)  # no resize at the model size
    np.testing.assert_allclose(same, tloader.normalize_batch(x, MEAN, STD), rtol=0, atol=0)


@pytest.mark.parametrize("in_size,layout,dtype", [
    (16, "NCHW", "float32"), (24, "NCHW", "float32"), (20, "NHWC", "float32"),
    (16, "NCHW", "bfloat16")])
def test_make_preprocess_matches_jax(in_size, layout, dtype):
    x = _u8((3, in_size, in_size, 3), seed=4)
    want = np.asarray(jpre.make_preprocess(16, layout=layout, dtype=getattr(jnp, dtype))(x),
                      np.float32)
    got = tpre.make_preprocess(16, layout=layout, dtype=getattr(torch, dtype))(
        torch.from_numpy(x))
    assert got.dtype == getattr(torch, dtype)
    tol = 1e-5 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)


def test_patchify_matches_jax():
    x = np.random.default_rng(5).standard_normal((2, 8, 12, 3)).astype(np.float32)
    got = tpre.patchify(torch.from_numpy(x), 4)
    assert got.shape == (2, 6, 48)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jpre.patchify(x, 4)))


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    """Three classes of PNGs and JPEGs, 11 images, one an alpha PNG (the
    PIL fallback)."""
    root = tmp_path_factory.mktemp("folder")
    i = 0
    for c, n in (("cat", 4), ("dog", 3), ("eel", 4)):
        os.makedirs(root / c)
        for k in range(n):
            h, w = SIZES[i % len(SIZES)]
            arr = _array(h, w, 10 + i)
            if i == 5:
                Image.fromarray(np.dstack([arr, np.full((h, w), 99, np.uint8)]), "RGBA").save(
                    root / c / f"{k}.png")
            else:
                ext = "png" if i % 2 else "jpg"
                with open(root / c / f"{k}.{ext}", "wb") as f:
                    f.write(_encode(arr, "PNG" if ext == "png" else "JPEG"))
            i += 1
    (root / "notes.txt").write_text("not a class")
    return str(root)


@pytest.mark.parametrize("shuffle,drop_last", [(False, False), (True, False), (True, True)])
def test_folder_batches_match_jax(folder, shuffle, drop_last):
    tset = tdata.ImageFolderDataset(folder, decode_size=20)
    jset = jds.ImageFolderDataset(folder, decode_size=20)
    assert tset.classes == jset.classes == ["cat", "dog", "eel"]
    assert tset.samples == jset.samples
    got = list(tdata.BatchIterator(tset, 4, shuffle=shuffle, seed=3, drop_last=drop_last))
    want = list(jds.BatchIterator(jset, 4, shuffle=shuffle, seed=3, drop_last=drop_last))
    assert [len(b["label"]) for b in got] == ([4, 4] if drop_last else [4, 4, 3])
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g["image"].dtype == np.uint8 and g["label"].dtype == np.int32
        np.testing.assert_array_equal(g["label"], w["label"])
        np.testing.assert_array_equal(g["image"], w["image"])


def test_second_epoch_and_array_dataset_match_jax():
    imgs, labels = _u8((10, 12, 12, 3), seed=6), np.arange(10) % 3
    titer = tdata.BatchIterator(tdata.ArrayDataset(imgs, labels), 3, seed=1, resize_to=8)
    jiter = jds.BatchIterator(jds.ArrayDataset(imgs, labels), 3, seed=1, resize_to=8)
    for _ in range(2):  # the generator carries over between epochs
        for g, w in zip(list(titer), list(jiter), strict=True):
            np.testing.assert_array_equal(g["label"], w["label"])
            np.testing.assert_array_equal(g["image"], w["image"])


def test_batch_iterator_raises_loader_errors():
    class Broken:
        def __len__(self):
            return 4

        def get(self, i):
            raise OSError(f"cannot read {i}")

    with pytest.raises(OSError):
        list(tdata.BatchIterator(Broken(), 2))


B, H, W, S = 6, 20, 24, 16
TOPS, LEFTS = np.array([0, 4, 2, 1, 3, 4]), np.array([8, 0, 5, 3, 1, 7])
FLIPS = np.array([True, False, False, True, True, False])


@pytest.mark.parametrize("flip,to_nchw", [(True, True), (True, False), (False, True)])
def test_make_augment_matches_jax_under_fixed_draws(flip, to_nchw, monkeypatch):
    x = _u8((B, H, W, 3), seed=7)
    draws = [jnp.asarray(TOPS), jnp.asarray(LEFTS)]
    monkeypatch.setattr(jax.random, "randint", lambda *a, **k: draws.pop(0))
    monkeypatch.setattr(jax.random, "bernoulli", lambda *a, **k: jnp.asarray(FLIPS))
    want = np.asarray(jds.make_augment(S, flip=flip, to_nchw=to_nchw)(jax.random.PRNGKey(0), x))
    flips = torch.from_numpy(FLIPS) if flip else torch.zeros(B, dtype=torch.bool)
    monkeypatch.setattr(tds, "draw_crops", lambda *a: (torch.from_numpy(TOPS),
                                                       torch.from_numpy(LEFTS), flips))
    got = tdata.make_augment(S, flip=flip, to_nchw=to_nchw)(torch.Generator(), torch.from_numpy(x))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_augment_draws_in_range_and_flips_near_half():
    g = torch.Generator().manual_seed(0)
    tops, lefts, flips = tds.draw_crops(g, 4000, H, W, S, True)
    assert int(tops.min()) == 0 and int(tops.max()) == H - S
    assert int(lefts.min()) == 0 and int(lefts.max()) == W - S
    assert abs(flips.float().mean().item() - 0.5) < 0.03
    assert not tds.draw_crops(g, 100, H, W, S, False)[2].any()


def test_augment_is_the_drawn_crop_and_seeded():
    x = torch.from_numpy(_u8((B, H, W, 3), seed=8))
    aug = tdata.make_augment(S, mean=(0, 0, 0), std=(1, 1, 1), to_nchw=False)
    got = aug(torch.Generator().manual_seed(4), x)
    torch.testing.assert_close(aug(torch.Generator().manual_seed(4), x), got, rtol=0, atol=0)
    assert not torch.equal(aug(torch.Generator().manual_seed(5), x), got)
    tops, lefts, flips = tds.draw_crops(torch.Generator().manual_seed(4), B, H, W, S, True)
    for i in range(B):
        crop = x[i, tops[i]:tops[i] + S, lefts[i]:lefts[i] + S]
        if flips[i]:
            crop = crop.flip(1)
        torch.testing.assert_close(got[i], crop.float() / 255.0, rtol=0, atol=0)
