"""The DoReFa ResNets (``models/resnet.py``, ``convert/fuse_quant.py``)
against the JAX package on the CPU.

``dorefa_w`` (1, 2 and 4 bits) and ``dorefa_a`` with their gradients; the
f64 logits of ``resnet18_cifar`` (basic blocks) and ``resnet50_cifar``
(bottlenecks) match to 1e-9; two f64 train steps of ``resnet18_cifar``
match ``make_train_step`` to 1e-9, with 4-bit weights and float activations
and the other way round (both quantized, the registry's default, in
``tests/test_torch_resnet_train.py``); ``--fold_bn`` and
``--fuse_quant`` give the trees and logits of JAX's ``fold_model_bns`` and
``quantize_resnet_weights`` + ``fuse_resnet``; a torchvision-layout
``.pth`` goes through the port's copy of ``import_resnet`` as through
JAX's and loads through ``--ckpt``. ``main`` on the family and the deep
ResNets' construction are in ``tests/test_torch_zoo_cli.py``.
"""

import jax
import numpy as np
import pytest
import torch

from _torch_port import _FAST_COMPILE, few_threads, images, \
    jax_train_steps, port_and_trees, x64  # noqa: F401
from test_torch_cifar_zoo import assert_trees_match

from scale_imagenet_tpu.convert import bn_fold as jbn_fold, \
    fuse_quant as jfuse, torch_import as jimport
from scale_imagenet_tpu.ops import dorefa as jdorefa
from scale_imagenet_tpu.train import make_optimizer as jmake_optimizer
from scale_imagenet_tpu_torch import main as cli
from scale_imagenet_tpu_torch.convert import jax_trees
from scale_imagenet_tpu_torch.convert import torch_import as pimport
from scale_imagenet_tpu_torch.convert.bn_fold import fold_model_bns
from scale_imagenet_tpu_torch.convert.fuse_quant import fuse_resnet
from scale_imagenet_tpu_torch.models import get_model
from scale_imagenet_tpu_torch.ops import dorefa
from scale_imagenet_tpu_torch.train import TrainState, make_optimizer, \
    make_train_step

TOL = dict(rtol=1e-9, atol=1e-9)

# torch at two threads a worker (``_torch_port.few_threads``)
pytestmark = pytest.mark.usefixtures("few_threads")


@pytest.mark.parametrize("nbit", [1, 2, 4])
def test_dorefa_w_a_and_gradients(x64, nbit):  # noqa: F811
    rng = np.random.default_rng(nbit)
    w = rng.standard_normal((5, 3, 3, 3)) * 0.3
    x = rng.standard_normal((2, 6)) * 8
    gw, gx = rng.standard_normal(w.shape), rng.standard_normal(x.shape)
    for jf, pf, a, g in ((jdorefa.dorefa_w, dorefa.dorefa_w, w, gw),
                         (jdorefa.dorefa_a, dorefa.dorefa_a, x, gx)):
        want, vjp = jax.vjp(lambda v: jf(v, nbit), a)
        t = torch.tensor(a, requires_grad=True)
        got = pf(t, nbit)
        got.backward(torch.from_numpy(g))
        np.testing.assert_allclose(got.detach().numpy(), want, **TOL)
        np.testing.assert_allclose(t.grad.numpy(), vjp(g)[0], **TOL)


@pytest.mark.parametrize("name", ["resnet18_cifar", "resnet50_cifar"])
def test_logits_match_jax_f64(x64, name):  # noqa: F811
    jm, params, state, md, model = port_and_trees(name, seed=2)
    x = images((1, 16, 16, 3), 3) * 2 - 1
    fwd = jax.jit(lambda p, s, a: jm.apply(p, s, a)[0])
    want = np.asarray(fwd.lower(params, state, x).compile(_FAST_COMPILE)(
        params, state, x))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == (1, 1000)
    np.testing.assert_allclose(got, want, **TOL)


def assert_two_steps_match(wbit: int, abit: int, side: int) -> None:
    """Two f64 SGD steps of ``resnet18_cifar`` (10 classes) on seeded
    ``side``x``side`` batches of 4 match JAX's ``make_train_step``: the
    metrics to 1e-9, the trees to 1e-9 relative and 1e-12 absolute."""
    opt_kw = dict(lr=0.1, milestones=(1,), steps_per_epoch=1)
    jm, params, state, md, model = port_and_trees(
        "resnet18_cifar", seed=5, num_classes=10, wbit=wbit, abit=abit)
    rng = np.random.default_rng(6)
    batches = [(rng.uniform(-1, 1, (4, side, side, 3)),
                rng.integers(0, 10, 4).astype(np.int32)) for _ in range(2)]
    tx, _ = jmake_optimizer(**opt_kw)
    jparams, jstate, jmetrics, _ = jax_train_steps(jm, tx, params, state,
                                                   batches)
    opt, _ = make_optimizer(**opt_kw)
    ts = TrainState(model, opt.init(dict(model.named_parameters())))
    step = make_train_step(model, opt)
    for (x, y), want in zip(batches, jmetrics):
        ts, m = step(ts, torch.from_numpy(x), torch.from_numpy(y))
        for k, v in want.items():
            np.testing.assert_allclose(float(m[k]), v, **TOL, err_msg=k)
    got_p, got_s = jax_trees(ts.model)
    assert_trees_match(got_p, jparams)
    assert_trees_match(got_s, jstate)


@pytest.mark.parametrize("wbit,abit", [(4, 32), (32, 4)])
def test_two_train_steps_match_jax(x64, wbit, abit):  # noqa: F811
    assert_two_steps_match(wbit, abit, 8)


def test_fold_bn_and_fuse_quant_match_jax(x64):  # noqa: F811
    jm, params, state, md, model = port_and_trees("resnet18_cifar", seed=7,
                                                  num_classes=10)
    x = images((2, 8, 8, 3), 8) * 2 - 1
    from scale_imagenet_tpu.models.resnet import resnet_apply

    for transform in ("fold", "fuse"):
        net = get_model("resnet18_cifar", num_classes=10).init(
            device="cpu", dtype=torch.float64)
        net.load_state_dict(model.state_dict())
        cfg = md.config
        # JAX's transforms under jit: op by op they take seconds in f64
        if transform == "fold":
            p, s = jax.jit(lambda pp, ss: jbn_fold.fold_model_bns(
                pp, ss, jbn_fold.conv_bn_pairs_resnet(cfg)))(params, state)
            assert fold_model_bns(net) == 17
        else:
            p, s = jax.jit(lambda pp, ss: jfuse.fuse_resnet(
                jfuse.quantize_resnet_weights(pp, cfg.wbit), ss, cfg))(
                    params, state)
            assert fuse_resnet(net) == 20 and net.cfg.wbit == 32
            cfg = net.cfg
        got_p, got_s = jax_trees(net)
        assert_trees_match(got_p, p, atol=1e-15)
        assert_trees_match(got_s, s, atol=1e-15)
        fwd = jax.jit(lambda pp, ss, a: resnet_apply(pp, ss, cfg, a)[0])
        want = np.asarray(fwd.lower(p, s, x).compile(_FAST_COMPILE)(p, s, x))
        with torch.no_grad():
            got = net(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, want, **TOL)


def reference_sd(params: dict, state: dict) -> dict:
    """torchvision's ResNet names, as ``import_resnet`` reads them."""
    sd = {}
    for tree in (params, state):
        for path, a in jax.tree_util.tree_flatten_with_path(tree)[0]:
            keys = [k.key for k in path]
            if keys[0].startswith("layer"):
                li, bi = keys[0].split("_")
                sub = {"down_conv": "downsample.0",
                       "down_bn": "downsample.1"}.get(keys[1], keys[1])
                keys = [f"{li}.{bi}", sub, *keys[2:]]
            a = np.asarray(a)
            sd[".".join(keys)] = np.transpose(a, (3, 2, 0, 1)) \
                if a.ndim == 4 else a.T if a.ndim == 2 else a
    return sd


def test_reference_pth_through_the_key_map(tmp_path):
    _, params, state, md, model = port_and_trees(
        "resnet18_cifar", np.float32, seed=3, num_classes=10)
    sd = reference_sd(params, state)
    want = jimport.import_resnet(sd, md.config)
    got = pimport.import_resnet(sd, md.config)
    for g, w in zip(got, want):
        assert_trees_match(g, w, rtol=0, atol=0)
    path = str(tmp_path / "ref.pth")
    torch.save({f"module.{k}": torch.from_numpy(np.ascontiguousarray(v))
                for k, v in sd.items()}, path)
    fresh = get_model("resnet18_cifar", num_classes=10).init(seed=8,
                                                             device="cpu")
    cli.load_checkpoint(fresh, path, "resnet18_cifar")
    for k, v in model.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k
