"""The port's ttnet_imagenet family against the JAX package.

One JAX init supplies both sides (through ``state_dict_from_jax``); the
conv forward is compared in f64: logits to 1e-9 (summation order only) and
every block's output bits exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import images, jax_and_port, nchw, x64  # noqa: F401

from scale_imagenet_tpu.convert.torch_export import export_ttnet_imagenet
from scale_imagenet_tpu.layers.norm import batch_norm as jbatch_norm
from scale_imagenet_tpu.models.multihead import multihead_block as jblock
from scale_imagenet_tpu.models.ttnet_imagenet import \
    ttnet_imagenet_apply as japply
from scale_imagenet_tpu.ops.binarize import binarize01_act as jbinarize
from scale_imagenet_tpu.pallas.stem import space_to_depth_stem as jstem
from scale_imagenet_tpu_torch.convert import state_dict_from_jax
from scale_imagenet_tpu_torch.models import get_model, list_models
from scale_imagenet_tpu_torch.models.ttnet_imagenet import stem, \
    ttnet_imagenet_apply

TOL = dict(rtol=1e-9, atol=1e-9)


def test_state_dict_from_jax_matches_export():
    jm, params, state, md, model = jax_and_port(
        "ttnet_imagenet_small", np.float32, nfilter=4, tfilter=4, layers=1)
    ours = state_dict_from_jax(params, state, md.config)
    ref = export_ttnet_imagenet(params, state, jm.config)
    assert set(ours) == set(ref) == set(model.state_dict())
    for k, v in ref.items():
        assert ours[k].dtype == torch.from_numpy(np.asarray(v)).dtype, k
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(v), k)
    # strict load into a fresh model, and the values land where they belong
    fresh = md.init(seed=1, device="cpu")
    fresh.load_state_dict(ours, strict=True)
    np.testing.assert_array_equal(
        fresh.blocks[0].Block_conv3.conv1.weight.detach().numpy(),
        np.transpose(params["block0"]["conv3"]["conv1"]["weight"],
                     (3, 2, 0, 1)))


def test_registry_and_shapes():
    from scale_imagenet_tpu.models import get_model as jget
    from scale_imagenet_tpu_torch.models.ttnet_imagenet_v1 import \
        V1_STAGES, cifar_name

    assert {"ttnet_imagenet_small", "ttnet_imagenet_xsmall",
            "ttnet_imagenet_small_g8", "TT_vf_19lv3_imgnet_small",
            "TT_vf_19lv3_imgnet_xsmall", "ttnet_imagenet_vgg_stem",
            "TT_vf_19lv3_imgnet_xsmall_VGG", "ttnet_imagenet_v2",
            "TT_vf_19lv3_imgnet", "TT_FHE_SMALL", "tt_fhe_small",
            "TT_FHE_XSMALL", "TT_FHE_ref", "TT_FHE_SMALL_polyhead",
            "TT_FHE_SMALL_bireal", "TT_FHE_small",
            "TT_FHE_XSMALL_vAlexnet", *V1_STAGES,
            *map(cifar_name, V1_STAGES)} <= set(list_models())
    # every name of the JAX registry since the zoo families
    assert len(list_models()) == 71
    for name in list_models():
        for layers in range(5):
            cfg = get_model(name, layers=layers).config
            jcfg = jget(name, layers=layers).config
            # the vAlexnet configs have no feature_shape in either package,
            # the ResNets no fcsize
            if hasattr(jcfg, "feature_shape"):
                assert cfg.feature_shape() == jcfg.feature_shape()
            if hasattr(jcfg, "fcsize"):
                assert cfg.fcsize == jcfg.fcsize
    with pytest.raises(KeyError, match="unknown model"):
        get_model("resnet9")
    # the noisy TT_FHE model is registered since its dead zone is ported
    assert get_model("TT_FHE_small").stochastic


def test_seeded_init_is_deterministic():
    md = get_model("ttnet_imagenet_xsmall", nfilter=2, tfilter=2, layers=0)
    a = md.init(seed=3, device="cpu").state_dict()
    b = md.init(seed=3, device="cpu").state_dict()
    c = md.init(seed=4, device="cpu").state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["features.1.weight"], c["features.1.weight"])


@pytest.mark.parametrize("layers", [0, 1])
@pytest.mark.parametrize("name", ["ttnet_imagenet_small",
                                  "ttnet_imagenet_xsmall",
                                  "ttnet_imagenet_small_g8"])
def test_conv_forward_matches_jax(x64, name, layers):
    jm, params, state, md, model = jax_and_port(
        name, np.float64, nfilter=4, tfilter=4, layers=layers)
    x = images((2, 224, 224, 3), 0)
    jp, js = jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray,
                                                             state)
    # jitted: one compile instead of one per primitive (the test's time)
    ref, _ = jax.jit(japply, static_argnums=2)(jp, js, jm.config,
                                                jnp.asarray(x))
    xt = torch.from_numpy(x)
    with torch.no_grad():
        got = ttnet_imagenet_apply(model, xt)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
        # every block's output, the port chain against the JAX chain
        h = jstem(jnp.asarray(x), jp["stem_conv"]["weight"])
        h = jbinarize(jbatch_norm(jp["stem_bn"], js["stem_bn"], h)[0])
        ht = stem(model, xt.permute(0, 3, 1, 2))
        np.testing.assert_array_equal(nchw(ht), np.asarray(h))
        jblock_jit = jax.jit(jblock, static_argnums=2)
        for i, (bcfg, block) in enumerate(zip(jm.config.block_configs(),
                                              model.blocks)):
            h, _ = jblock_jit(jp[f"block{i}"], js[f"block{i}"], bcfg, h)
            ht = block(ht)
            if bcfg.last:
                np.testing.assert_allclose(nchw(ht), np.asarray(h), **TOL)
            else:
                np.testing.assert_array_equal(nchw(ht), np.asarray(h))
                assert 0.05 < float(ht.mean()) < 0.95   # not trivial


def test_reference_stem_option_matches_jax(x64):
    jm, params, state, md, _ = jax_and_port(
        "ttnet_imagenet_xsmall", np.float64, nfilter=4, tfilter=4, layers=0)
    jcfg = dataclasses.replace(jm.config, stem_impl="reference")
    cfg = dataclasses.replace(md.config, stem_impl="reference")
    model = dataclasses.replace(md, config=cfg).init(device="cpu",
                                                     dtype=torch.float64)
    model.load_state_dict(state_dict_from_jax(params, state, cfg))
    x = images((2, 224, 224, 3), 1)
    ref, _ = japply(jax.tree.map(jnp.asarray, params),
                    jax.tree.map(jnp.asarray, state), jcfg, jnp.asarray(x))
    with torch.no_grad():
        got = ttnet_imagenet_apply(model, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
