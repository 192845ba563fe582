"""Model registry (counterpart of ``scale_imagenet_tpu/models/registry.py:311-326``).

The ``ttnet_imagenet`` entries and their reference aliases (the v2 and
VGG-stem variants among them, ``registry.py:148-160,314,325``), the TT_FHE
models (``registry.py:131-173``) and the v1 ImageNet family with its
32x32 10-class clones (``registry.py:199-222``): 37 of the JAX registry's
71 names.  The rest follows its families (``ROADMAP.md``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch
from torch import nn

from .tt_fhe import FHE_MODELS, TTFHEAlexnetConfig, TTFHEConfig, \
    build_tt_fhe
from .ttnet_imagenet import TTnetImageNetConfig, TTnetVGGStemConfig, \
    build_ttnet_imagenet, build_ttnet_vgg_stem
from .ttnet_imagenet_v1 import V1_STAGES, TTnetV1Config, build_ttnet_v1, \
    cifar_name

_BUILD_FNS = {TTnetImageNetConfig: build_ttnet_imagenet,
             TTnetVGGStemConfig: build_ttnet_vgg_stem,
             TTFHEConfig: build_tt_fhe, TTFHEAlexnetConfig: build_tt_fhe,
             TTnetV1Config: build_ttnet_v1}


@dataclasses.dataclass(frozen=True)
class ModelDef:
    name: str
    config: TTnetImageNetConfig | TTnetVGGStemConfig | TTFHEConfig \
        | TTFHEAlexnetConfig | TTnetV1Config

    @property
    def stochastic(self) -> bool:
        """The forward draws coin flips (``TT_FHE_small``): eval, serving
        and training give it a ``NoiseKey``."""
        return getattr(self.config, "stochastic", False)

    def init(self, seed: int = 0, device=None,
             dtype: torch.dtype = torch.float32) -> nn.Module:
        """The model on ``device`` (the card unless the caller asks for the
        CPU), in eval mode, weights from ``seed``."""
        return _BUILD_FNS[type(self.config)](self.config, seed=seed,
                                            device=device, dtype=dtype)


def _ttnet_imagenet(name: str, variant: str):
    def build(nfilter=8, tfilter=8, layers=1, num_classes=1000,
              image_size=224, stem_impl="s2d"):
        return ModelDef(name=name, config=TTnetImageNetConfig(
            variant=variant, nfilter=nfilter, tfilter=tfilter,
            layers=layers, num_classes=num_classes, image_size=image_size,
            stem_impl=stem_impl))
    return build


def _vgg_stem(name: str):
    def build(num_classes=1000, **_):
        # the other width flags do not apply: the stem fixes p = 64
        return ModelDef(name=name,
                        config=TTnetVGGStemConfig(num_classes=num_classes))
    return build


def _tt_fhe(name: str):
    def build(nfilter=8, tfilter=8, num_classes=10, **_):
        return ModelDef(name=name, config=TTFHEConfig(
            name=name, nfilter=nfilter, tfilter=tfilter,
            num_classes=num_classes))
    return build


def _tt_fhe_alexnet(num_classes=10, maxpool=3, **_):
    return ModelDef(name="TT_FHE_XSMALL_vAlexnet", config=TTFHEAlexnetConfig(
        num_classes=num_classes, maxpool=maxpool))


def _v1(name: str, image_size: int = 224, num_classes_default: int = 1000):
    def build(nfilter=8, tfilter=8, a_bit=2,
              num_classes=num_classes_default, **_):
        return ModelDef(name=name, config=TTnetV1Config(
            name=name, nfilter=nfilter, tfilter=tfilter, a_bit=a_bit,
            num_classes=num_classes, image_size=image_size))
    return build


MODEL_REGISTRY: dict[str, Callable[..., ModelDef]] = {
    # the shipped TTnet-Small
    "ttnet_imagenet_small": _ttnet_imagenet("ttnet_imagenet_small", "small"),
    "ttnet_imagenet_xsmall": _ttnet_imagenet("ttnet_imagenet_xsmall",
                                             "xsmall"),
    # flagship geometry, n=8 head 3 / convf tables
    "ttnet_imagenet_small_g8": _ttnet_imagenet("ttnet_imagenet_small_g8",
                                               "small_g8"),
    # reference aliases
    "TT_vf_19lv3_imgnet_small": _ttnet_imagenet("TT_vf_19lv3_imgnet_small",
                                                "small"),
    "TT_vf_19lv3_imgnet_xsmall": _ttnet_imagenet("TT_vf_19lv3_imgnet_xsmall",
                                                 "xsmall"),
    # the VGG16-stem variant, under both of the JAX package's names
    "TT_vf_19lv3_imgnet_xsmall_VGG": _vgg_stem(
        "TT_vf_19lv3_imgnet_xsmall_VGG"),
    "ttnet_imagenet_vgg_stem": _vgg_stem("TT_vf_19lv3_imgnet_xsmall_VGG"),
    # TT_vf_19lv3_imgnet: (6,5)/(5,6) heads, groups stepped down at p = 64
    "ttnet_imagenet_v2": _ttnet_imagenet("ttnet_imagenet_v2", "v2"),
    "TT_vf_19lv3_imgnet": _ttnet_imagenet("TT_vf_19lv3_imgnet", "v2"),
    # the TT_FHE family (CIFAR, 32x32); tt_fhe_small is TT_FHE_SMALL's
    # alias, as in the JAX registry
    **{name: _tt_fhe(name) for name in FHE_MODELS},
    "tt_fhe_small": _tt_fhe("TT_FHE_SMALL"),
    "TT_FHE_XSMALL_vAlexnet": _tt_fhe_alexnet,
    # the v1 family at 224x224, and the reference's CIFAR clones of the
    # same classes (``models/TT_general.py``: 32x32, 10 classes); the clone
    # keeps its ImageNet name in ``ModelDef.name``, as in JAX
    **{name: _v1(name) for name in V1_STAGES},
    **{cifar_name(name): _v1(name, image_size=32, num_classes_default=10)
       for name in V1_STAGES},
}


def get_model(name: str, **kwargs) -> ModelDef:
    if name not in MODEL_REGISTRY:
        raise KeyError(f"unknown model {name!r}; the port has "
                       f"{sorted(MODEL_REGISTRY)} (the rest: ROADMAP.md)")
    return MODEL_REGISTRY[name](**kwargs)


def list_models() -> list[str]:
    return sorted(MODEL_REGISTRY)
