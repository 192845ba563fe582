"""The port's eval harness: losses, the loader and its padding, the shard
format, the PIL eval transform, the eval step and loop, and
``main --mode eval`` end to end on the CPU.

The same seeded numpy inputs go to the JAX package and the port: metric
sums and loader batches are equal, shards written by either package read
in the other, the uint8 crop is exact, and the eval loop's top-1/top-5 are
equal to JAX's with the loss within 1e-5 (f64 forwards on both sides).
"""

import json
import os
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import images, jax_and_port, x64  # noqa: F401

from scale_imagenet_tpu.data import loader as jloader
from scale_imagenet_tpu.data import shards as jshards
from scale_imagenet_tpu.data import transforms as jtf
from scale_imagenet_tpu.data.dataset import ArrayDataset as JArrayDataset
from scale_imagenet_tpu.runtime.evaluate import evaluate as jevaluate
from scale_imagenet_tpu.train import losses as jlosses
from scale_imagenet_tpu.train.steps import make_eval_step as jmake_eval_step
from scale_imagenet_tpu_torch import main as cli
from scale_imagenet_tpu_torch.data import ArrayDataset, DataLoader, \
    IMAGENET_MEAN, IMAGENET_STD, ShardDataset, device_prefetch, \
    filler_batch, imagenet_eval_crop_u8, imagenet_eval_transform, \
    pad_batches, write_shards
from scale_imagenet_tpu_torch.models import get_model
from scale_imagenet_tpu_torch.models.ttnet_imagenet import \
    ttnet_imagenet_apply
from scale_imagenet_tpu_torch.runtime.evaluate import evaluate
from scale_imagenet_tpu_torch.train import MetricsLogger, accuracy_topk, \
    cross_entropy, make_eval_step, make_input_pipeline, masked_metric_sums

from _torch_port import few_threads  # noqa: F401

# torch at two threads a worker (``_torch_port.few_threads``)
pytestmark = pytest.mark.usefixtures("few_threads")

SMALL = ["--model", "ttnet_imagenet_xsmall", "--nfilter", "4", "--tfilter",
         "4", "--layers", "0"]


def _logits_labels(seed=0, n=12, c=20):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((n, c))
    labels = rng.integers(0, c, n).astype(np.int32)
    labels[-3:] = -1                                       # pad rows
    return logits, labels


def test_metric_sums_match_jax(x64):
    logits, labels = _logits_labels()
    nll, (c1, c5), n = masked_metric_sums(torch.from_numpy(logits),
                                          torch.from_numpy(labels))
    jnll, (j1, j5), jn = jlosses.masked_metric_sums(jnp.asarray(logits),
                                                   jnp.asarray(labels))
    np.testing.assert_allclose(float(nll), float(jnll), rtol=1e-12)
    assert (float(c1), float(c5), float(n)) == \
        (float(j1), float(j5), float(jn)) and float(n) == 9.0


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_cross_entropy_and_topk_match_jax(x64, smoothing):
    logits, labels = _logits_labels(1)
    labels = np.abs(labels)
    got = cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                        smoothing)
    want = jlosses.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                 smoothing)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-12)
    assert [float(a) for a in accuracy_topk(
        torch.from_numpy(logits), torch.from_numpy(labels), (1, 5))] == \
        [float(a) for a in jlosses.accuracy_topk(
            jnp.asarray(logits), jnp.asarray(labels), (1, 5))]


def _dataset(n=23, seed=2):
    rng = np.random.default_rng(seed)
    imgs = rng.integers(0, 256, (n, 4, 5, 3), dtype=np.uint8)
    return imgs, rng.integers(0, 1000, n).astype(np.int32)


def _same_batches(a, b):
    a, b = list(a), list(b)
    assert len(a) == len(b)
    for (ia, la), (ib, lb) in zip(a, b):
        np.testing.assert_array_equal(ia, ib)
        np.testing.assert_array_equal(la, lb)


def test_pad_batches_and_filler_match_jax():
    imgs, labels = _dataset()
    batches = [(imgs[i:i + 8], labels[i:i + 8]) for i in range(0, 23, 8)]
    _same_batches(pad_batches(iter(batches), 8),
                  jloader.pad_batches(iter(batches), 8))
    _same_batches([filler_batch(4, (4, 5, 3))],
                  [jloader.filler_batch(4, (4, 5, 3))])


@pytest.mark.parametrize("world", [1, 2, 3, 7, 30])
def test_dataloader_order_and_rank_slicing_match_jax(world):
    """Sequential eval order; every rank of ``world`` (30 > 23 images
    leaves ranks with no image, only filler batches)."""
    imgs, labels = _dataset()
    for rank in range(world):
        kw = dict(batch_size=4, num_workers=2, rank=rank, world=world)
        ours = DataLoader(ArrayDataset(imgs, labels), **kw)
        ref = jloader.DataLoader(JArrayDataset(imgs, labels), shuffle=False,
                                 drop_last=False, **kw)
        assert len(ours) == len(ref)
        _same_batches(ours, ref)


def test_shards_round_trip_between_packages(tmp_path):
    imgs, labels = _dataset(37, 3)
    write_shards(ArrayDataset(imgs, labels), str(tmp_path / "ours"),
                 shard_size=10)
    jshards.write_shards(JArrayDataset(imgs, labels), str(tmp_path / "jax"),
                         shard_size=10)
    for d in ("ours", "jax"):
        root = str(tmp_path / d)
        ours, ref = ShardDataset(root), jshards.ShardDataset(root)
        assert len(ours) == len(ref) == 37
        for i in (0, 9, 10, 36):
            np.testing.assert_array_equal(ours[i][0], imgs[i])
            assert ours[i][1] == ref[i][1] == labels[i]
        _same_batches(ours.iter_batches(8), ref.iter_batches(8))
        for world in (2, 3):
            assert ours.rank_batches(8, world) == \
                ref.rank_batches(8, False, world)
            for rank in range(world):
                _same_batches(ours.iter_batches(8, rank=rank, world=world),
                              ref.iter_batches(8, rank=rank, world=world))
    with open(tmp_path / "ours" / "meta.json") as f:
        assert json.load(f) == {"n": 37, "shape": [4, 5, 3], "classes": []}


def _pil_image(w, h, seed):
    from PIL import Image

    rng = np.random.default_rng(seed)
    return Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8))


@pytest.mark.parametrize("w,h", [(300, 257), (250, 400), (256, 256)])
def test_eval_crop_and_transform_exact(w, h):
    img = _pil_image(w, h, w + h)
    crop = imagenet_eval_crop_u8(img)
    assert crop.shape == (224, 224, 3) and crop.dtype == np.uint8
    np.testing.assert_array_equal(crop, jtf.imagenet_eval_crop_u8(img))
    np.testing.assert_array_equal(imagenet_eval_transform(img),
                                  jtf.imagenet_eval_transform(img))
    # the shard split (u8 crop, normalize on the device) loses nothing
    prepare = make_input_pipeline((IMAGENET_MEAN, IMAGENET_STD))
    np.testing.assert_array_equal(
        prepare(torch.from_numpy(crop.copy())[None])[0].numpy(),
        imagenet_eval_transform(img))


def test_eval_step_and_loop_match_jax(x64):
    """Two full batches and a tail of 3 (padded, masked): top-1/top-5
    equal to JAX's ``make_eval_step`` + ``evaluate``, loss within 1e-5."""
    jm, params, state, md, model = jax_and_port(
        "ttnet_imagenet_xsmall", np.float64, nfilter=2, tfilter=2, layers=0)
    n, bs = 11, 4
    imgs = (images((n, 224, 224, 3), 7) * 255).astype(np.uint8)
    prepare = make_input_pipeline((IMAGENET_MEAN, IMAGENET_STD))
    with torch.no_grad():
        pred = ttnet_imagenet_apply(model, prepare(torch.from_numpy(imgs)))
    top5 = torch.topk(pred, 5).indices.numpy()
    labels = np.random.default_rng(8).integers(0, 1000, n).astype(np.int32)
    labels[::2] = top5[::2, 0]                  # some right at top-1,
    labels[1::4] = top5[1::4, 3]                # some at top-5 only
    batches = list(pad_batches(((imgs[i:i + bs], labels[i:i + bs])
                                for i in range(0, n, bs)), bs))
    step = make_eval_step(lambda x: ttnet_imagenet_apply(model, x),
                          (IMAGENET_MEAN, IMAGENET_STD))
    got = evaluate(step, [(torch.from_numpy(i), torch.from_numpy(lb))
                          for i, lb in batches], log_interval=2,
                   verbose=False)
    jstep = jmake_eval_step(jm, normalize=(jtf.IMAGENET_MEAN,
                                           jtf.IMAGENET_STD))
    want = jevaluate(jstep, params, state, batches, log_interval=2,
                     verbose=False)
    assert got[:2] == want[:2]
    assert 0 < got[0] < 100 and got[0] < got[1]
    assert abs(got[2] - want[2]) < 1e-5


def _labelled_shards(tmp_path, n=13, seed=3):
    """Seeded uint8 images labelled by the small model's own argmax."""
    imgs = (images((n, 224, 224, 3), 9) * 255).astype(np.uint8)
    model = get_model("ttnet_imagenet_xsmall", nfilter=4, tfilter=4,
                      layers=0).init(seed=seed, device="cpu")
    prepare = make_input_pipeline((IMAGENET_MEAN, IMAGENET_STD))
    with torch.no_grad():
        labels = ttnet_imagenet_apply(model, prepare(torch.from_numpy(
            imgs))).argmax(1).numpy().astype(np.int32)
    labels[0] = (labels[0] + 1) % 1000                      # one miss
    root = str(tmp_path / "shards")
    write_shards(ArrayDataset(imgs, labels), root, shard_size=5)
    return root


def test_main_eval_end_to_end(tmp_path, capsys):
    """``--mode eval --shards_dir`` on the CPU, conv and ``--lut``, the
    archive written by one run and loaded by the next."""
    root = _labelled_shards(tmp_path)
    base = ["--mode", "eval", "--device", "cpu", "--shards_dir", root,
            "--eval_batch_size", "4", "--seed", "3", "--root_dir",
            str(tmp_path), "--log_interval", "1", *SMALL]
    conv = cli.main(base)
    assert conv[0] == pytest.approx(100 * 12 / 13)
    assert "final: top1 92.308% top5" in capsys.readouterr().out
    lut = cli.main(base + ["--lut"])
    assert lut[:2] == conv[:2] and abs(lut[2] - conv[2]) < 1e-4
    path = str(tmp_path / "luts")
    written = cli.main(base + ["--lut", "--lut_path", path])
    assert "saved LUTs" in capsys.readouterr().out
    loaded = cli.main(base + ["--lut", "--lut_path", path])
    assert "loading LUTs" in capsys.readouterr().out
    assert loaded == written == lut
    logs = [os.path.join(dp, f) for dp, _, fs in os.walk(tmp_path / "logs")
            for f in fs if f == "metrics.jsonl"]
    assert len(logs) == 4
    with open(logs[0]) as f:
        assert {json.loads(line)["tag"] for line in f} == \
            {"Loss/test", "Accuracy/test"}


def test_main_eval_image_folder_and_write_shards(tmp_path):
    """``--data_dir`` (ImageFolder val/, PIL transform on host threads) and
    ``--write_shards`` then ``--shards_dir`` (u8 crop, normalized on the
    device) give the same metrics."""
    for c, cls in enumerate(("a_cls", "b_cls")):
        d = tmp_path / "data" / "val" / cls
        d.mkdir(parents=True)
        for i in range(3):
            _pil_image(230 + 17 * i, 260 - 9 * c, 10 * c + i).save(
                d / f"{i}.png")
    common = ["--device", "cpu", "--eval_batch_size", "4", "--num_workers",
              "2", "--root_dir", str(tmp_path), *SMALL]
    folder = cli.main(["--mode", "eval", "--data_dir",
                       str(tmp_path / "data"), *common])
    meta = cli.main(["--write_shards", str(tmp_path / "sh"), "--data_dir",
                     str(tmp_path / "data"), "--shard_size", "4", *common])
    assert meta["n"] == 6 and meta["classes"] == ["a_cls", "b_cls"]
    shards = cli.main(["--mode", "eval", "--shards_dir",
                       str(tmp_path / "sh"), *common])
    assert shards[:2] == folder[:2]
    assert abs(shards[2] - folder[2]) < 1e-5


@pytest.mark.parametrize("argv,match", [
    (["--amp"], "bf16 mixed-precision TRAINING"),
    (["--remat"], "recompute"),
    (["--bias_decay", "1e-3"], "robust TRAINING"),
    # --tp, --sp and the model axis are ported (tests/test_torch_tp*.py,
    # tests/test_torch_sp*.py): the two refuse each other with the JAX
    # CLI's text, and one process holds no model axis
    (["--tp", "--sp"], "both shard over the 'model' mesh axis — pick one"),
    (["--lut_path", "x.npz"], "add --lut"),
    (["--mesh_model", "2", "--shards_dir", "d"],
     "1 devices not divisible by model=2"),
    ([], "--shards_dir or --data_dir"),
    (["--write_shards", "d"], "--write_shards decodes --data_dir")])
def test_eval_refuses_flags_it_does_not_carry(argv, match):
    with pytest.raises(ValueError, match=match):
        cli.main(["--mode", "eval", "--device", "cpu", *argv])


def test_device_prefetch_on_cpu_passes_errors_and_stops():
    imgs, labels = _dataset(8, 4)
    got = list(device_prefetch(iter([(imgs, labels)]), "cpu"))
    assert len(got) == 1 and torch.equal(got[0][0], torch.from_numpy(imgs))

    def broken():
        yield imgs, labels
        raise OSError("shard unreadable")

    with pytest.raises(OSError, match="unreadable"):
        list(device_prefetch(broken(), "cpu"))

    before = threading.active_count()
    endless = device_prefetch(((imgs, labels) for _ in iter(int, 1)), "cpu")
    next(endless)
    endless.close()                 # the producer must not outlive it
    assert threading.active_count() <= before


def test_metrics_logger_writes_jsonl(tmp_path):
    log = MetricsLogger(str(tmp_path / "l"))
    log.add_scalar("Loss/test", 1.5, 3)
    log.close()
    with open(tmp_path / "l" / "metrics.jsonl") as f:
        rec = json.loads(f.readline())
    assert (rec["tag"], rec["value"], rec["step"]) == ("Loss/test", 1.5, 3)
