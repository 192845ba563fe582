"""The port's local dataset readers and their transforms against the JAX
package's (``scale_imagenet_tpu/data/dataset.py:64-197``,
``data/transforms.py:153-190``): ``CIFAR10`` over fake pickled batches,
``MNIST`` over idx files (raw and ``.gz``, torchvision's layout and the
flat one), ``tiny_imagenet`` over a tiny ImageFolder, the three transforms
(``to_tensor_transform``, ``grayscale_transform``, ``tiny_train_transform``
from one ``random.Random`` state) and ``make_dataset_loader``'s batches,
all equal exactly.
"""

import gzip
import pickle
import random
import re
import struct

import numpy as np
import pytest

from scale_imagenet_tpu.data import dataset as jds
from scale_imagenet_tpu.data import transforms as jtf
from scale_imagenet_tpu_torch.data import CIFAR10, MNIST, \
    grayscale_transform, make_dataset_loader, tiny_imagenet, \
    tiny_train_transform, to_tensor_transform

from _torch_port import few_threads  # noqa: F401

# torch at two threads a worker (``_torch_port.few_threads``)
pytestmark = pytest.mark.usefixtures("few_threads")


def _cifar(root, n=6):
    base = root / "cifar-10-batches-py"
    base.mkdir(parents=True)
    rng = np.random.default_rng(3)
    for i, name in enumerate([f"data_batch_{j}" for j in range(1, 6)]
                             + ["test_batch"]):
        d = {b"data": rng.integers(0, 256, (n, 3072), dtype=np.uint8),
             b"labels": rng.integers(0, 10, n).tolist(),
             b"batch_label": name.encode()}
        with open(base / name, "wb") as f:
            pickle.dump(d, f)


def _idx(path, arr, gz):
    head = struct.pack(">i", 0x0800 | arr.ndim) + struct.pack(
        f">{arr.ndim}i", *arr.shape)
    op = gzip.open if gz else open
    with op(str(path) + (".gz" if gz else ""), "wb") as f:
        f.write(head + arr.astype(np.uint8).tobytes())


def _mnist(base, gz, n=7):
    base.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(4 + gz)
    for split, (img, lbl) in MNIST._FILES.items():
        _idx(base / img, rng.integers(0, 256, (n, 28, 28)), gz)
        _idx(base / lbl, rng.integers(0, 10, n), gz)


def _tiny(root):
    from PIL import Image

    rng = np.random.default_rng(5)
    for split in ("train", "val"):
        for c in ("n01", "n02"):
            d = root / "tiny-imagenet-200" / split / c
            d.mkdir(parents=True)
            for i in range(3):
                Image.fromarray(rng.integers(0, 256, (64, 64, 3),
                                             dtype=np.uint8)).save(
                    d / f"{i}.png")


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    top = tmp_path_factory.mktemp("readers")
    _cifar(top / "cifar")
    _mnist(top / "mnist_tv" / "MNIST" / "raw", gz=True)
    _mnist(top / "mnist_flat", gz=False)
    _tiny(top / "tiny")
    return top


def _same(a, b):
    assert len(a) == len(b)
    for i in range(len(a)):
        (x, y), (jx, jy) = a[i], b[i]
        assert x.dtype == jx.dtype and x.shape == jx.shape
        np.testing.assert_array_equal(x, jx)
        assert y == jy


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("transform", [None, "to_tensor", "grayscale"])
def test_cifar10_matches_jax(roots, train, transform):
    tf = {None: (None, None),
          "to_tensor": (to_tensor_transform, jtf.to_tensor_transform),
          "grayscale": (grayscale_transform, jtf.grayscale_transform)}
    ours = CIFAR10(str(roots / "cifar"), train, tf[transform][0])
    ref = jds.CIFAR10(str(roots / "cifar"), train, tf[transform][1])
    assert len(ours) == (30 if train else 6)
    np.testing.assert_array_equal(ours.images, ref.images)
    np.testing.assert_array_equal(ours.labels, ref.labels)
    _same(ours, ref)


@pytest.mark.parametrize("layout", ["mnist_tv", "mnist_flat"])
@pytest.mark.parametrize("train", [True, False])
def test_mnist_idx_raw_and_gz_match_jax(roots, layout, train):
    for tf, jtf_ in ((None, None),
                     (to_tensor_transform, jtf.to_tensor_transform)):
        ours = MNIST(str(roots / layout), train, tf)
        ref = jds.MNIST(str(roots / layout), train, jtf_)
        assert ours.images.shape == (7, 28, 28)
        np.testing.assert_array_equal(ours.labels, ref.labels)
        _same(ours, ref)


def test_mnist_missing_files_raise(tmp_path):
    with pytest.raises(FileNotFoundError, match="train-images-idx3-ubyte"):
        MNIST(str(tmp_path))


@pytest.mark.parametrize("nchannel", [1, 3])
def test_tiny_train_transform_draws_as_jax(roots, nchannel):
    ds = tiny_imagenet(str(roots / "tiny"), True)
    ref = jds.tiny_imagenet(str(roots / "tiny"), True)
    assert ds.samples == ref.samples and ds.classes == ["n01", "n02"]
    ours_rng, ref_rng = random.Random(11), random.Random(11)
    for i in range(len(ds)):
        img, _ = ds[i]
        got = tiny_train_transform(img, ours_rng, nchannel=nchannel)
        want = jtf.tiny_train_transform(img, ref_rng, nchannel=nchannel)
        assert got.shape == (64, 64, nchannel)
        np.testing.assert_array_equal(got, want)
    assert ours_rng.getstate() == ref_rng.getstate()


@pytest.mark.parametrize("dataset,root,train,nchannel", [
    ("MNIST", "mnist_tv", True, 1), ("MNIST", "mnist_flat", False, 1),
    ("CIFAR10", "cifar", True, 3), ("CIFAR10", "cifar", False, 1),
    ("Tiny", "tiny", True, 3), ("Tiny", "tiny", True, 1),
    ("Tiny", "tiny", False, 1)])
def test_make_dataset_loader_matches_jax(roots, dataset, root, train,
                                         nchannel):
    kw = dict(batch_size=4, nchannel=nchannel, num_workers=1, seed=2)
    ours = make_dataset_loader(dataset, str(roots / root), train, **kw)
    ref = jds.make_dataset_loader(dataset, str(roots / root), train, **kw)
    assert len(ours) == len(ref) and ours.shuffle == train
    for epoch in (0, 1):
        ours.set_epoch(epoch)
        ref.set_epoch(epoch)
        random.seed(epoch)            # Tiny's rotation and flip
        got = list(ours)
        random.seed(epoch)
        want = list(ref)
        assert len(got) == len(want)
        for (x, y), (jx, jy) in zip(got, want):
            assert x.shape[-1] == nchannel
            np.testing.assert_array_equal(x, jx)
            np.testing.assert_array_equal(y, jy)


def test_make_dataset_loader_refuses_an_unknown_dataset(tmp_path):
    with pytest.raises(ValueError,
                       match=re.escape("(MNIST | CIFAR10 | Tiny)")):
        make_dataset_loader("SVHN", str(tmp_path), True, 4)
