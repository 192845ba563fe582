"""The port's training input pipeline against the JAX package: the
on-device RandomResizedCrop + flip + ColorJitter (``train/augment.py``), the
PIL train transforms, and the loaders' training order (``shuffle``,
``seed``, ``drop_last``, ``set_epoch``).

The augmentation splits sampling from applying: JAX's own draws
(``sample_crop``, the flip bit, ``_jitter_coeffs``) go into the port's
``apply_rrc_flip_jitter``, whose output equals ``make_rrc_flip_jitter``'s
within 1e-6 in f32; the port's sampler, drawing from a ``torch.Generator``,
passes the distribution checks of ``tests/test_augment.py``.  Transforms
and loaders are equal to the JAX package's exactly, down to the RNG calls.
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from scale_imagenet_tpu.data import loader as jloader
from scale_imagenet_tpu.data import shards as jshards
from scale_imagenet_tpu.data import transforms as jtf
from scale_imagenet_tpu.data.dataset import ArrayDataset as JArrayDataset
from scale_imagenet_tpu.train import augment as jaug
from scale_imagenet_tpu_torch.data import ArrayDataset, DataLoader, \
    IMAGENET_MEAN, IMAGENET_STD, imagenet_train_crop_u8, \
    imagenet_train_transform, shard_loader, write_shards
from scale_imagenet_tpu_torch.data import transforms as tf
from scale_imagenet_tpu_torch.train import augment as aug
from scale_imagenet_tpu_torch.train import make_input_pipeline

from _torch_port import few_threads  # noqa: F401

# torch at two threads a worker (``_torch_port.few_threads``)
pytestmark = pytest.mark.usefixtures("few_threads")

NORM = (tuple(IMAGENET_MEAN.tolist()), tuple(IMAGENET_STD.tolist()))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The tensors here are tiny: one intra-op thread is as fast, and
    spares the cores that the other test workers share."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def _jax_draws(key, n: int, size: int):
    """The per-image draws of JAX's ``make_rrc_flip_jitter`` for ``key``:
    ``(crops, flips, jitter)`` as the port's apply function takes them."""
    def one(k):
        k_crop, k_flip, k_jit = jax.random.split(k, 3)
        return (jaug.sample_crop(k_crop, size, size),
                jax.random.bernoulli(k_flip),
                jaug._jitter_coeffs(k_jit, 0.5, 0.5, 0.3))
    crops, flips, jitter = jax.jit(jax.vmap(one))(jax.random.split(key, n))

    def t(a):
        return torch.from_numpy(np.array(a))
    return tuple(map(t, crops)), t(flips), tuple(map(t, jitter))


@pytest.mark.parametrize("size,out,normalize", [(40, 32, True),
                                                (48, 48, False)])
def test_apply_with_jax_draws_matches_jax(size, out, normalize):
    """Every crop geometry (the 10-attempt loop and its fallback), flip and
    jitter order of 16 images drawn by JAX, applied by the port: within
    1e-6 on the [0, 1] pixel scale (1e-6 / std once normalized; the mean
    gray is a reduction, summed in another order).  The JAX function runs
    op by op, as written: XLA's compiled program reassociates the crop
    arithmetic and moves pixels by up to 4e-6."""
    x = np.random.default_rng(size).integers(0, 256, (16, size, size, 3),
                                             dtype=np.uint8)
    key = jax.random.PRNGKey(size)
    norm = NORM if normalize else None
    want = jaug.make_rrc_flip_jitter(out_size=out, normalize=norm)(
        jnp.asarray(x), key)
    crops, flips, jitter = _jax_draws(key, 16, size)
    got = aug.apply_rrc_flip_jitter(torch.from_numpy(x), crops, flips,
                                    jitter, out_size=out, normalize=norm)
    assert got.dtype == torch.float32 and got.shape == (16, out, out, 3)
    scale = np.asarray(NORM[1], np.float32) if normalize else 1.0
    np.testing.assert_allclose(got.numpy() * scale, np.asarray(want) * scale,
                               rtol=0, atol=1e-6)
    assert 0 < int(flips.sum()) < 16


def test_apply_bf16_matches_jax_bf16():
    """Under ``--amp`` the pixels are computed in bf16 on both sides.
    With XLA's excess precision off, so that every bf16 op rounds as the
    program is written (as the port's ops do), the outputs are equal."""
    x = np.random.default_rng(7).integers(0, 256, (8, 40, 40, 3),
                                          dtype=np.uint8)
    key = jax.random.PRNGKey(7)
    fn = jax.jit(jaug.make_rrc_flip_jitter(out_size=32, normalize=NORM,
                                           dtype=jnp.bfloat16))
    xj = jnp.asarray(x)
    want = fn.lower(xj, key).compile(
        {"xla_allow_excess_precision": False})(xj, key)
    crops, flips, jitter = _jax_draws(key, 8, 40)
    got = aug.apply_rrc_flip_jitter(torch.from_numpy(x), crops, flips,
                                    jitter, out_size=32, normalize=NORM,
                                    dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


@pytest.mark.parametrize("perm", range(6))
def test_jitter_composition_matches_jax(perm):
    rng = np.random.default_rng(perm)
    fb, fc, fs = (rng.uniform(0.5, 1.5, 5).astype(np.float32)
                  for _ in range(3))
    got = aug.compose_jitter_coeffs(*(torch.from_numpy(f)
                                      for f in (fb, fc, fs)),
                                    torch.full((5,), perm))
    want = jax.vmap(lambda b, c, s: jaug.compose_jitter_coeffs(
        b, c, s, perm))(fb, fc, fs)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)


def test_crop_sampler_distribution_matches_host():
    """The checks of ``tests/test_augment.py`` on the port's sampler: every
    box in bounds, the mean area within 0.03 of the PIL path's over 2,000
    draws, the aspect symmetric; the flips fair and the jitter factors in
    their ranges."""
    gen = torch.Generator().manual_seed(0)
    tops, lefts, chs, cws = (t.numpy() for t in
                             aug.sample_crops(2000, 256, 256, gen))
    assert (tops >= 0).all() and (lefts >= 0).all()
    assert (tops + chs <= 256).all() and (lefts + cws <= 256).all()
    assert (tops == np.floor(tops)).all() and (chs >= 1).all()

    host_rng = random.Random(0)
    img = Image.new("RGB", (256, 256))
    boxes = []
    orig_crop = Image.Image.crop

    def record_crop(self, box):
        boxes.append(box)
        return orig_crop(self, box)

    Image.Image.crop = record_crop
    try:
        for _ in range(2000):
            tf._random_resized_crop(img, 224, host_rng)
    finally:
        Image.Image.crop = orig_crop
    host_areas = [(r - l) * (b - t) / 256.0 ** 2 for l, t, r, b in boxes]
    dev_areas = chs * cws / 256.0 ** 2
    assert abs(dev_areas.mean() - np.mean(host_areas)) < 0.03, \
        (dev_areas.mean(), np.mean(host_areas))
    assert abs(np.log(cws / chs).mean()) < 0.02
    assert abs(float(aug.sample_flips(2000, gen).float().mean()) - 0.5) < 0.05
    a, b, g = (t.numpy() for t in aug.sample_jitter(2000, gen))
    # alpha is the product of the three factors: within (0.5*0.5*0.7,
    # 1.5*1.5*1.3)
    assert (a > 0.175).all() and (a < 2.925).all() and np.isfinite(b).all() \
        and np.isfinite(g).all()


def test_augment_is_deterministic_given_the_generator():
    """One seed, one batch: the same pixels; another seed, others.  The
    full path returns ``dtype`` and normalizes inside."""
    x = torch.from_numpy(np.random.default_rng(1).integers(
        0, 256, (4, 40, 40, 3), dtype=np.uint8))
    full = make_input_pipeline(NORM, "full", image_size=32,
                               dtype=torch.bfloat16)
    a = full(x, torch.Generator().manual_seed(5))
    b = full(x, torch.Generator().manual_seed(5))
    c = full(x, torch.Generator().manual_seed(6))
    assert a.dtype == torch.bfloat16 and a.shape == (4, 32, 32, 3)
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_flip_only_pipeline_flips_whole_images():
    """Same-size shards: normalize, then each image flipped or not."""
    x = torch.from_numpy(np.random.default_rng(2).integers(
        0, 256, (64, 6, 5, 3), dtype=np.uint8))
    plain = make_input_pipeline(NORM)(x)
    got = make_input_pipeline(NORM, True)(x, torch.Generator().manual_seed(0))
    flipped = torch.tensor([bool(torch.equal(g, p.flip(1)))
                            for g, p in zip(got, plain)])
    kept = torch.tensor([bool(torch.equal(g, p))
                         for g, p in zip(got, plain)])
    assert bool((flipped | kept).all()) and 0 < int(flipped.sum()) < 64


def _image(seed: int, size=(300, 270)) -> Image.Image:
    arr = np.random.default_rng(seed).integers(0, 256, size[::-1] + (3,),
                                               dtype=np.uint8)
    return Image.fromarray(arr)


@pytest.mark.parametrize("size", [(300, 270), (256, 256), (200, 320)])
def test_train_crop_u8_matches_jax(size):
    img = _image(1, size)
    got = imagenet_train_crop_u8(img)
    assert got.dtype == np.uint8 and got.shape == (256, 256, 3)
    np.testing.assert_array_equal(got, jtf.imagenet_train_crop_u8(img))


@pytest.mark.parametrize("seed", range(4))
def test_train_transform_matches_jax_under_equal_rng(seed):
    """The same ``random.Random`` state gives the same crop, flip, jitter
    order and factors, so the same array; both RNGs end in one state."""
    img = _image(seed + 10)
    ours, theirs = random.Random(seed), random.Random(seed)
    for _ in range(3):
        np.testing.assert_array_equal(imagenet_train_transform(img, ours),
                                      jtf.imagenet_train_transform(img,
                                                                   theirs))
    assert ours.getstate() == theirs.getstate()


def _dataset(n=23, seed=2):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (n, 4, 5, 3), dtype=np.uint8),
            rng.integers(0, 1000, n).astype(np.int32))


def _same_batches(a, b):
    a, b = list(a), list(b)
    assert len(a) == len(b)
    for (ia, la), (ib, lb) in zip(a, b):
        np.testing.assert_array_equal(ia, ib)
        np.testing.assert_array_equal(la, lb)


@pytest.mark.parametrize("drop_last", [True, False])
def test_shuffled_dataloader_matches_jax(drop_last):
    """Epochs 0 and 1 of one seed: the JAX batches in the JAX order."""
    imgs, labels = _dataset()
    kw = dict(batch_size=4, shuffle=True, num_workers=2, drop_last=drop_last,
              seed=3)
    ours = DataLoader(ArrayDataset(imgs, labels), **kw)
    ref = jloader.DataLoader(JArrayDataset(imgs, labels), **kw)
    assert len(ours) == len(ref) == (5 if drop_last else 6)
    orders = []
    for epoch in (0, 1):
        ours.set_epoch(epoch)
        ref.set_epoch(epoch)
        _same_batches(ours, ref)
        orders.append(np.concatenate([lb for _, lb in ours]))
    assert not np.array_equal(orders[0], orders[1])


def test_shuffled_shard_loader_matches_jax(tmp_path):
    """The training shard loader (``drop_last``, two-level shuffle from
    ``seed + epoch``) over shards of 10: the JAX batches in the JAX order
    for epochs 0 and 1."""
    imgs, labels = _dataset(37, 3)
    write_shards(ArrayDataset(imgs, labels), str(tmp_path), shard_size=10)
    ours = shard_loader(str(tmp_path), 8, drop_last=True, shuffle=True,
                        seed=5)
    ref = jshards.shard_loader(str(tmp_path), 8, drop_last=True,
                               shuffle=True, seed=5)
    assert len(ours) == len(ref) == 4
    firsts = []
    for epoch in (0, 1):
        ours.set_epoch(epoch)
        ref.set_epoch(epoch)
        _same_batches(ours, ref)
        firsts.append(next(iter(ours))[1])
    assert not np.array_equal(*firsts)
