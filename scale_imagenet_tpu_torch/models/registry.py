"""Model registry (counterpart of ``scale_imagenet_tpu/models/registry.py:311-326``).

The ``ttnet_imagenet`` entries ported so far and their reference aliases,
the VGG-stem variant among them (``registry.py:148-160``); the rest of the
JAX registry follows its families (``ROADMAP.md``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from .ttnet_imagenet import TTnetImageNet, TTnetImageNetConfig, \
    TTnetVGGStem, TTnetVGGStemConfig, build_ttnet_imagenet, \
    build_ttnet_vgg_stem


@dataclasses.dataclass(frozen=True)
class ModelDef:
    name: str
    config: TTnetImageNetConfig | TTnetVGGStemConfig

    def init(self, seed: int = 0, device=None,
             dtype: torch.dtype = torch.float32) \
            -> TTnetImageNet | TTnetVGGStem:
        """The model on ``device`` (the card unless the caller asks for the
        CPU), in eval mode, weights from ``seed``."""
        build = build_ttnet_vgg_stem if isinstance(
            self.config, TTnetVGGStemConfig) else build_ttnet_imagenet
        return build(self.config, seed=seed, device=device, dtype=dtype)


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
}


def get_model(name: str, **kwargs) -> ModelDef:
    if name not in MODEL_REGISTRY:
        raise KeyError(f"unknown model {name!r}; the port has "
                       f"{sorted(MODEL_REGISTRY)} (the rest: ROADMAP.md)")
    return MODEL_REGISTRY[name](**kwargs)


def list_models() -> list[str]:
    return sorted(MODEL_REGISTRY)
