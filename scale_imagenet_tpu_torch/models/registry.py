"""Model registry (counterpart of ``scale_imagenet_tpu/models/registry.py``).

All 71 names of the JAX registry, aliases included: the ``ttnet_imagenet``
entries (the v2 and VGG-stem variants among them), the TT_FHE models, the
v1 ImageNet family with its 32x32 10-class clones, the DoReFa ResNets,
``tt_certif``, the mobilenet variants, the TT_general float family and its
correctBN twins, ``model_general`` and ``cifar10lownoise``.  Each factory
takes the JAX factory's keyword arguments and ignores the others, as the
CLI passes ``--nfilter``/``--tfilter``/``--layers`` and every
``--model_arg`` to whichever model it builds; ``_simple`` keeps the
config's own fields (``registry.py:59``).  ``tt_certif``, ``model_general``
and ``cifar10lownoise`` (aliases included), and they alone, carry the
interval hooks (``registry.py:27-37,115-128,272-305``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch
from torch import nn

from .resnet import ResNet, ResNetConfig, init_resnet
from .tt_certif import TTCertif, TTCertifConfig, \
    tt_certif_interval_logits, tt_certif_interval_loss
from .tt_fhe import FHE_MODELS, TTFHEAlexnetConfig, TTFHEConfig, \
    build_tt_fhe
from .ttnet_cifar import Cifar10LowNoise, Cifar10LowNoiseConfig, \
    MobilenetV1TT, MobilenetV1TTConfig, MobilenetV2TT, MobilenetV2TTConfig, \
    ModelGeneral, ModelGeneralConfig, build_zoo, \
    cifar10lownoise_interval_logits, cifar10lownoise_interval_loss, \
    model_general_interval_logits, model_general_interval_loss
from .ttnet_general_float import TTGeneralCorrectBN, \
    TTGeneralCorrectBNConfig, TTGeneralFloat, TTGeneralFloatConfig
from .ttnet_imagenet import TTnetImageNetConfig, TTnetVGGStemConfig, \
    build_ttnet_imagenet, build_ttnet_vgg_stem
from .ttnet_imagenet_v1 import V1_STAGES, TTnetV1Config, build_ttnet_v1, \
    cifar_name


# the configs whose modules carry the JAX trees' names, and their modules
ZOO_MODULES = {ResNetConfig: ResNet, TTCertifConfig: TTCertif,
               MobilenetV1TTConfig: MobilenetV1TT,
               MobilenetV2TTConfig: MobilenetV2TT,
               ModelGeneralConfig: ModelGeneral,
               Cifar10LowNoiseConfig: Cifar10LowNoise,
               TTGeneralFloatConfig: TTGeneralFloat,
               TTGeneralCorrectBNConfig: TTGeneralCorrectBN}


def _zoo(cls, init=None):
    def build(cfg, seed=0, device=None, dtype=torch.float32):
        return build_zoo(cls(cfg), seed, device, dtype,
                         **({"init": init} if init else {}))
    return build


_BUILD_FNS = {TTnetImageNetConfig: build_ttnet_imagenet,
             TTnetVGGStemConfig: build_ttnet_vgg_stem,
             TTFHEConfig: build_tt_fhe, TTFHEAlexnetConfig: build_tt_fhe,
             TTnetV1Config: build_ttnet_v1,
             **{c: _zoo(m, init_resnet if c is ResNetConfig else None)
                for c, m in ZOO_MODULES.items()}}


@dataclasses.dataclass(frozen=True)
class ModelDef:
    name: str
    config: object
    # the interval-arithmetic activation-stability loss
    # (compute_act_stabilizing_loss_abstract, netbin.py:726-738):
    # ``interval_loss(model, x, eps, inputs_min, inputs_max) -> scalar``
    interval_loss: Callable | None = None
    # sound logit bounds under a clipped L-inf eps-ball, the certificate
    # of ``--certify``: ``interval_logits(model, x, eps, inputs_min,
    # inputs_max) -> robust.interval.Interval``
    interval_logits: Callable | None = None

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


def _simple(name: str, cfg_cls):
    """The config built from the keyword arguments it has fields for."""
    def build(**kwargs):
        fields = {f.name for f in dataclasses.fields(cfg_cls)}
        return ModelDef(name=name, config=cfg_cls(
            **{k: v for k, v in kwargs.items() if k in fields}))
    return build


def _interval(build, loss, logits):
    """``build`` with the interval hooks on its ``ModelDef``."""
    def with_hooks(**kwargs):
        return dataclasses.replace(build(**kwargs), interval_loss=loss,
                                   interval_logits=logits)
    return with_hooks


def _resnet(depth: int, cifar: bool = False):
    def build(wbit=4, abit=4, num_classes=1000, **_):
        return ModelDef(
            name=f"resnet{depth}{'_cifar' if cifar else ''}",
            config=ResNetConfig(depth=depth, wbit=wbit, abit=abit,
                                num_classes=num_classes, cifar=cifar))
    return build


def _mobilenet_v2(name: str, variant: str):
    def build(num_classes=10, **_):
        return ModelDef(name=name, config=MobilenetV2TTConfig(
            variant=variant, num_classes=num_classes))
    return build


def _tt_general(name: str, variant: str):
    def build(nfilter=8, tfilter=8, layers=18, a_bit=2, num_classes=1000,
              image_size=224, groups=(1, 2, 4, 4), **_):
        return ModelDef(name=name, config=TTGeneralFloatConfig(
            variant=variant, nfilter=nfilter, tfilter=tfilter, layers=layers,
            a_bit=a_bit, num_classes=num_classes, image_size=image_size,
            groups=tuple(groups)))
    return build


def _correctbn(name: str, image_size: int):
    def build(nfilter=8, tfilter=6, layers=18, a_bit=2, num_classes=10,
              **_):
        return ModelDef(name=name, config=TTGeneralCorrectBNConfig(
            nfilter=nfilter, tfilter=tfilter, layers=layers, a_bit=a_bit,
            num_classes=num_classes, image_size=image_size))
    return build


# variant -> its names (the first is ``ModelDef.name``)
_V2_NAMES = {
    "mobilenet_v2": ("mobilenet_v2_tt", "mobilenet_v2_TT"),
    "small": ("mobilenet_v2_tt_small", "mobilenet_v2_TT_small"),
    "small_n64": ("mobilenet_v2_tt_small_n64", "mobilenet_v2_TT_small_n64"),
    "small_n64bis": ("mobilenet_v2_tt_small_n64bis",
                     "mobilenet_v2_TT_small_n64bis"),
    "32_64": ("mobilenet_v2_tt_32_64", "mobilenet_v2_TT_32_64"),
    "32_32": ("mobilenet_v2_tt_32_32", "mobilenet_v2_TT_32_32"),
}


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
    # the DoReFa ResNets; the _cifar ones keep 1000 classes by default, as
    # in the JAX registry
    **{f"resnet{d}": _resnet(d) for d in (18, 34, 50, 101, 152)},
    **{f"resnet{d}_cifar": _resnet(d, True) for d in (18, 34, 50, 101, 152)},
    "tt_certif": _interval(_simple("tt_certif", TTCertifConfig),
                           tt_certif_interval_loss,
                           tt_certif_interval_logits),
    "mobilenet_v1_tt": _simple("mobilenet_v1_tt", MobilenetV1TTConfig),
    "mobilenet_v1_TT": _simple("mobilenet_v1_tt", MobilenetV1TTConfig),
    **{n: _mobilenet_v2(names[0], v) for v, names in _V2_NAMES.items()
       for n in names},
    "TT_general": _tt_general("TT_general", "general"),
    "TT_general_big": _tt_general("TT_general_big", "general_big"),
    "TT_general_8": _tt_general("TT_general_8", "general_8"),
    "TT_general_correctBN": _correctbn("TT_general_correctBN", 224),
    "TT_general_correctBN_cifar": _correctbn("TT_general_correctBN_cifar",
                                             32),
    "model_general": _interval(_simple("model_general",
                                       ModelGeneralConfig),
                               model_general_interval_loss,
                               model_general_interval_logits),
    "cifar10lownoise": _interval(_simple("cifar10lownoise",
                                         Cifar10LowNoiseConfig),
                                 cifar10lownoise_interval_loss,
                                 cifar10lownoise_interval_logits),
}
MODEL_REGISTRY["TT_certif"] = MODEL_REGISTRY["tt_certif"]
MODEL_REGISTRY["model_cifar10lownoise"] = MODEL_REGISTRY["cifar10lownoise"]


def get_model(name: str, **kwargs) -> ModelDef:
    if name not in MODEL_REGISTRY:
        raise KeyError(f"unknown model {name!r}; available: "
                       f"{sorted(MODEL_REGISTRY)}")
    return MODEL_REGISTRY[name](**kwargs)


def list_models() -> list[str]:
    return sorted(MODEL_REGISTRY)
