"""JAX ``(params, state)`` trees -> the port's state dict.

The key map is the reference's, the one
``scale_imagenet_tpu/convert/torch_export.py::export_ttnet_imagenet``
emits: ``features.1`` stem conv, ``features.2`` stem BN, ``features.3`` stem
activation, ``features.{4+i}`` blocks (``Block_conv{1,2,3}``/``Block_convf``
with ``conv1``/``bn1``/``conv2``/``bn2``/``act`` each, plus the block
``act``), then the ``Classifier_scale`` head after the pool and flatten.
Conv weights go HWIO -> OIHW, linear weights ``(in, out)`` -> ``(out, in)``;
BN ``num_batches_tracked`` and the activations' ``grad_scale`` buffers
(inference reads neither) get their defaults so ``strict=True`` loads.

The VGG-stem variant's map is the reference's too
(``scale_imagenet_tpu/convert/torch_import.py:215-240``): ``features.1`` and
``features.3`` the stem convs (weight and bias), ``features.5`` the stem
BN, ``features.7`` the stem activation, ``features.8`` the block (heads
``Block_conv{1,2,3}``, no fuse head), ``features.10`` the classifier.

The TT_FHE family's map is ``convert/torch_export.py::export_tt_fhe``'s
(``torch_export.py:88-150``; ``models/tt_fhe.py``): ``features.0`` the stem
conv, ``.1`` its BN, ``.2`` the stem activation (``grad_scale``, or the
Bi-Real ``alpha_a``/``beta_a``), ``.3…`` the blocks (no block-level
activation), then the classifier after the pool and flatten.
``TT_FHE_XSMALL_vAlexnet``'s is ``import_tt_fhe_alexnet``'s
(``torch_import.py:190``): ``features.0`` the conv with bias, ``.2`` the
BN, ``.4`` the activation, ``.5`` the block, ``.7`` the classifier.

The v1 family's is ``import_ttnet_v1``'s (``torch_import.py:424-445``):
``features.1`` the stem conv, ``.2`` its BN, ``.3`` the activation,
``.{4+i}`` the blocks (``Block_conv{j}`` for each conv head and
``Block_convf``, each ``conv1``/``bn1``/``conv2``/``bn2``), the Linear
``fc`` after the pool and the flatten.

The models of the families that no exporter writes (``ZOO_MODULES``: the
ResNets, ``tt_certif``, the mobilenets, ``model_general``,
``cifar10lownoise``, the TT_general float family) name their modules as
the JAX trees name their entries, so their map is the trees' own paths
joined with dots, conv weights (4-D) and linear weights (2-D) transposed;
the reference's key maps for them are ``convert/torch_import.py``'s.

``jax_trees`` is the inverse map, from a port model back to the JAX
layout (``compile/lut_store.py`` hashes it).  The trees are nested dicts of
numpy arrays; nothing here imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.registry import ZOO_MODULES
from ..models.tt_fhe import TTFHEAlexnetConfig, TTFHEConfig
from ..models.ttnet_imagenet import TTnetVGGStemConfig
from ..models.ttnet_imagenet_v1 import TTnetV1Config

_HEADS = (("conv1", "Block_conv1"), ("conv2", "Block_conv2"),
          ("conv3", "Block_conv3"), ("convf", "Block_convf"))


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


def _conv(w) -> torch.Tensor:
    return _t(np.transpose(np.asarray(w), (3, 2, 0, 1)))


def _bn(sd: dict, prefix: str, p: dict, s: dict) -> None:
    sd[f"{prefix}.weight"] = _t(p["weight"])
    sd[f"{prefix}.bias"] = _t(p["bias"])
    sd[f"{prefix}.running_mean"] = _t(s["running_mean"])
    sd[f"{prefix}.running_var"] = _t(s["running_var"])
    sd[f"{prefix}.num_batches_tracked"] = torch.zeros((), dtype=torch.int64)


def _act(sd: dict, prefix: str) -> None:
    sd[f"{prefix}.grad_scale"] = torch.tensor(1.0)


def _is_vgg(cfg) -> bool:
    return isinstance(cfg, TTnetVGGStemConfig)


def _layout(cfg) -> tuple[int, int]:
    """``(index of the first block, index of the classifier)`` in
    ``features``."""
    if _is_vgg(cfg):
        return 8, 10
    n_blocks = len(cfg.block_configs())
    return 4, 4 + n_blocks + 2                    # after AvgPool + Flatten


def _cell_sd(sd: dict, prefix: str, p: dict, s: dict) -> None:
    """A cell's ``conv1``/``bn1``/``conv2``/``bn2`` (a Block_TT's, or a
    resnet cell's)."""
    sd[f"{prefix}.conv1.weight"] = _conv(p["conv1"]["weight"])
    _bn(sd, f"{prefix}.bn1", p["bn1"], s["bn1"])
    sd[f"{prefix}.conv2.weight"] = _conv(p["conv2"]["weight"])
    _bn(sd, f"{prefix}.bn2", p["bn2"], s["bn2"])


def _blocks_to_sd(sd: dict, params: dict, state: dict, cfg, first: int,
                  block_act: bool) -> None:
    for i, bcfg in enumerate(cfg.block_configs()):
        base = f"features.{first + i}"
        bp, bs = params[f"block{i}"], state[f"block{i}"]
        for ours, name in _HEADS if bcfg.fuse else _HEADS[:3]:
            prefix = f"{base}.{name}"
            _cell_sd(sd, prefix, bp[ours], bs[ours])
            _act(sd, f"{prefix}.act")
        if block_act:
            _act(sd, f"{base}.act")


def _lin(sd: dict, prefix: str, p: dict) -> None:
    sd[f"{prefix}.weight"] = _t(np.asarray(p["weight"]).T)
    if "bias" in p:
        sd[f"{prefix}.bias"] = _t(p["bias"])


def _fhe_head_cls(cfg) -> int:
    return 3 + len(cfg.block_configs()) + 2       # after pool + flatten


def _tt_fhe_sd(params: dict, state: dict, cfg: TTFHEConfig) -> dict:
    """``export_tt_fhe``'s keys (``torch_export.py:88``), as tensors."""
    sd = {"features.0.weight": _conv(params["stem_conv"]["weight"])}
    _bn(sd, "features.1", params["stem_bn"], state["stem_bn"])
    if "stem_act" in params:
        sd["features.2.alpha_a"] = _t(params["stem_act"]["alpha"])
        sd["features.2.beta_a"] = _t(params["stem_act"]["beta"])
    else:
        _act(sd, "features.2")
    _blocks_to_sd(sd, params, state, cfg, 3, block_act=False)
    cls = _fhe_head_cls(cfg)
    style = cfg.spec["classifier"]
    if style == "scale_new":
        cp, cs = params["classifier"], state["classifier"]
        for lin in ("lin1", "lin2", "linvf"):
            _lin(sd, f"features.{cls}.{lin}", cp[lin])
        for theirs, ours in (("BN1", "bn1"), ("BN2", "bn2"),
                             ("BNvf", "bnvf")):
            _bn(sd, f"features.{cls}.{theirs}", cp[ours], cs[ours])
    elif style == "scale":
        _lin(sd, f"features.{cls}.lin1", params["lin1"])
        _bn(sd, f"features.{cls}.BN2", params["bn1"], state["bn1"])
        _lin(sd, f"features.{cls}.lin2", params["lin2"])
    else:                                   # flat lin, bn, lin[, bn]
        _lin(sd, f"features.{cls}", params["lin1"])
        _bn(sd, f"features.{cls + 1}", params["bn1"], state["bn1"])
        _lin(sd, f"features.{cls + 2}", params["lin2"])
        if "bn2" in params:
            _bn(sd, f"features.{cls + 3}", params["bn2"], state["bn2"])
    return sd


def _v1_heads(bcfg) -> list[tuple[str, str]]:
    return [(f"conv{j}", f"Block_conv{j}") for j in bcfg.conv_heads] + [
        ("convf", "Block_convf")]


def _v1_sd(params: dict, state: dict, cfg: TTnetV1Config) -> dict:
    """``import_ttnet_v1``'s keys (``torch_import.py:424``), as tensors."""
    sd = {"features.1.weight": _conv(params["stem_conv"]["weight"])}
    _bn(sd, "features.2", params["stem_bn"], state["stem_bn"])
    _act(sd, "features.3")
    blocks = cfg.block_configs()
    for i, bcfg in enumerate(blocks):
        bp, bs = params[f"block{i}"], state[f"block{i}"]
        for ours, name in _v1_heads(bcfg):
            _cell_sd(sd, f"features.{4 + i}.{name}", bp[ours], bs[ours])
    _lin(sd, f"features.{4 + len(blocks) + 2}", params["fc"])
    return sd


def _tt_fhe_alexnet_sd(params: dict, state: dict, cfg) -> dict:
    sd = {"features.0.weight": _conv(params["vgg_conv1"]["weight"]),
          "features.0.bias": _t(params["vgg_conv1"]["bias"])}
    _bn(sd, "features.2", params["stem_bn"], state["stem_bn"])
    _act(sd, "features.4")
    _blocks_to_sd(sd, params, state, cfg, 5, block_act=False)
    _lin(sd, "features.7.lin1", params["lin1"])
    _bn(sd, "features.7.BN2", params["bn1"], state["bn1"])
    _lin(sd, "features.7.lin2", params["lin2"])
    return sd


# buffers no forward reads, with their values at init
_UNREAD = {"num_batches_tracked": lambda: torch.zeros((), dtype=torch.int64),
           "grad_scale": lambda: torch.tensor(1.0)}


def _to_torch_layout(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.ndim == 4:
        return _conv(a)
    return _t(a.T if a.ndim == 2 else a)


def _zoo_sd(params: dict, state: dict, cfg) -> dict:
    """The trees' paths as keys; the unread buffers of the model's own
    state dict (its module tree built on the meta device) at their init
    values."""
    sd: dict = {}

    def walk(tree: dict, prefix: str) -> None:
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}.")
            else:
                sd[f"{prefix}{k}"] = _to_torch_layout(v)

    walk(params, "")
    walk(state, "")
    with torch.device("meta"):
        own = ZOO_MODULES[type(cfg)](cfg).state_dict()
    for key in own:
        name = key.rsplit(".", 1)[-1]
        if key not in sd and name in _UNREAD:
            sd[key] = _UNREAD[name]()
    return sd


def _zoo_trees(model) -> tuple[dict, dict]:
    params: dict = {}
    state: dict = {}
    for key, v in model.state_dict().items():
        *path, name = key.split(".")
        if name in _UNREAD:
            continue
        a = _np(v)
        a = np.ascontiguousarray(np.transpose(a, (2, 3, 1, 0)) if a.ndim == 4
                                 else a.T if a.ndim == 2 else a)
        node = state if name in ("running_mean", "running_var") else params
        for k in path:
            node = node.setdefault(k, {})
        node[name] = a
    return params, state


def state_dict_from_jax(params: dict, state: dict, cfg) -> dict:
    """``cfg``: the port's config of the same model (``TTnetImageNetConfig``,
    ``TTnetVGGStemConfig``, ``TTFHEConfig``, ``TTFHEAlexnetConfig``,
    ``TTnetV1Config`` or one of ``ZOO_MODULES``)."""
    if type(cfg) in ZOO_MODULES:
        return _zoo_sd(params, state, cfg)
    if isinstance(cfg, TTnetV1Config):
        return _v1_sd(params, state, cfg)
    if isinstance(cfg, TTFHEConfig):
        return _tt_fhe_sd(params, state, cfg)
    if isinstance(cfg, TTFHEAlexnetConfig):
        return _tt_fhe_alexnet_sd(params, state, cfg)
    sd: dict = {}
    if _is_vgg(cfg):
        for key, name in (("features.1", "vgg_conv1"),
                          ("features.3", "vgg_conv2")):
            sd[f"{key}.weight"] = _conv(params[name]["weight"])
            sd[f"{key}.bias"] = _t(params[name]["bias"])
        _bn(sd, "features.5", params["stem_bn"], state["stem_bn"])
        _act(sd, "features.7")
    else:
        sd["features.1.weight"] = _conv(params["stem_conv"]["weight"])
        _bn(sd, "features.2", params["stem_bn"], state["stem_bn"])
        _act(sd, "features.3")
    first, cls = _layout(cfg)
    _blocks_to_sd(sd, params, state, cfg, first, block_act=True)
    cls = f"features.{cls}"
    cp, cs = params["classifier"], state["classifier"]
    sd[f"{cls}.lin1.weight"] = _t(np.asarray(cp["lin1"]["weight"]).T)
    _bn(sd, f"{cls}.BN2", cp["bn"], cs["bn"])
    sd[f"{cls}.lin2.weight"] = _t(np.asarray(cp["lin2"]["weight"]).T)
    sd[f"{cls}.lin2.bias"] = _t(cp["lin2"]["bias"])
    return sd


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _hwio(w: torch.Tensor) -> np.ndarray:
    return np.ascontiguousarray(np.transpose(_np(w), (2, 3, 1, 0)))


def _bn_trees(sd: dict, prefix: str) -> tuple[dict, dict]:
    return ({"bias": _np(sd[f"{prefix}.bias"]),
             "weight": _np(sd[f"{prefix}.weight"])},
            {"running_mean": _np(sd[f"{prefix}.running_mean"]),
             "running_var": _np(sd[f"{prefix}.running_var"])})


def _cell_trees(sd: dict, prefix: str) -> tuple[dict, dict]:
    """The inverse of ``_cell_sd``."""
    bn1, bn1_s = _bn_trees(sd, f"{prefix}.bn1")
    bn2, bn2_s = _bn_trees(sd, f"{prefix}.bn2")
    return ({"conv1": {"weight": _hwio(sd[f"{prefix}.conv1.weight"])},
             "bn1": bn1,
             "conv2": {"weight": _hwio(sd[f"{prefix}.conv2.weight"])},
             "bn2": bn2},
            {"bn1": bn1_s, "bn2": bn2_s})


def _blocks_to_trees(sd: dict, params: dict, state: dict, cfg,
                     first: int) -> None:
    for i, bcfg in enumerate(cfg.block_configs()):
        base = f"features.{first + i}"
        bp, bs = params.setdefault(f"block{i}", {}), \
            state.setdefault(f"block{i}", {})
        for ours, name in _HEADS if bcfg.fuse else _HEADS[:3]:
            bp[ours], bs[ours] = _cell_trees(sd, f"{base}.{name}")


def _lin_tree(sd: dict, prefix: str) -> dict:
    p = {"weight": np.ascontiguousarray(_np(sd[f"{prefix}.weight"]).T)}
    if f"{prefix}.bias" in sd:
        p["bias"] = _np(sd[f"{prefix}.bias"])
    return p


def _fhe_trees(model) -> tuple[dict, dict]:
    sd = model.state_dict()
    cfg = model.cfg
    params: dict = {}
    state: dict = {}
    if isinstance(cfg, TTFHEAlexnetConfig):
        params["vgg_conv1"] = {"bias": _np(sd["features.0.bias"]),
                               "weight": _hwio(sd["features.0.weight"])}
        params["stem_bn"], state["stem_bn"] = _bn_trees(sd, "features.2")
        _blocks_to_trees(sd, params, state, cfg, 5)
        params["lin1"] = _lin_tree(sd, "features.7.lin1")
        params["bn1"], state["bn1"] = _bn_trees(sd, "features.7.BN2")
        params["lin2"] = _lin_tree(sd, "features.7.lin2")
        return params, state
    params["stem_conv"] = {"weight": _hwio(sd["features.0.weight"])}
    params["stem_bn"], state["stem_bn"] = _bn_trees(sd, "features.1")
    if "features.2.alpha_a" in sd:
        params["stem_act"] = {"alpha": _np(sd["features.2.alpha_a"]),
                              "beta": _np(sd["features.2.beta_a"])}
    _blocks_to_trees(sd, params, state, cfg, 3)
    cls = _fhe_head_cls(cfg)
    style = cfg.spec["classifier"]
    if style == "scale_new":
        cp, cs = {}, {}
        for lin in ("lin1", "lin2", "linvf"):
            cp[lin] = _lin_tree(sd, f"features.{cls}.{lin}")
        for theirs, ours in (("BN1", "bn1"), ("BN2", "bn2"),
                             ("BNvf", "bnvf")):
            cp[ours], cs[ours] = _bn_trees(sd, f"features.{cls}.{theirs}")
        params["classifier"], state["classifier"] = cp, cs
    elif style == "scale":
        params["lin1"] = _lin_tree(sd, f"features.{cls}.lin1")
        params["bn1"], state["bn1"] = _bn_trees(sd, f"features.{cls}.BN2")
        params["lin2"] = _lin_tree(sd, f"features.{cls}.lin2")
    else:
        params["lin1"] = _lin_tree(sd, f"features.{cls}")
        params["bn1"], state["bn1"] = _bn_trees(sd, f"features.{cls + 1}")
        params["lin2"] = _lin_tree(sd, f"features.{cls + 2}")
        if style == "two_bn":
            params["bn2"], state["bn2"] = _bn_trees(
                sd, f"features.{cls + 3}")
    return params, state


def _v1_trees(model) -> tuple[dict, dict]:
    sd = model.state_dict()
    params = {"stem_conv": {"weight": _hwio(sd["features.1.weight"])}}
    state: dict = {}
    params["stem_bn"], state["stem_bn"] = _bn_trees(sd, "features.2")
    blocks = model.cfg.block_configs()
    for i, bcfg in enumerate(blocks):
        bp = params.setdefault(f"block{i}", {})
        bs = state.setdefault(f"block{i}", {})
        for ours, name in _v1_heads(bcfg):
            bp[ours], bs[ours] = _cell_trees(sd, f"features.{4 + i}.{name}")
    params["fc"] = _lin_tree(sd, f"features.{4 + len(blocks) + 2}")
    return params, state


def jax_trees(model) -> tuple[dict, dict]:
    """The inverse of ``state_dict_from_jax``: a port model as the JAX
    package's ``(params, state)`` nested dicts of numpy arrays (conv
    weights OIHW -> HWIO, linear weights ``(out, in)`` -> ``(in, out)``,
    the buffers inference does not read left out), in the model's dtype."""
    if type(model.cfg) in ZOO_MODULES:
        return _zoo_trees(model)
    if isinstance(model.cfg, TTnetV1Config):
        return _v1_trees(model)
    if isinstance(model.cfg, (TTFHEConfig, TTFHEAlexnetConfig)):
        return _fhe_trees(model)
    sd = model.state_dict()
    cfg = model.cfg
    params: dict = {}
    state: dict = {}
    if _is_vgg(cfg):
        for key, name in (("features.1", "vgg_conv1"),
                          ("features.3", "vgg_conv2")):
            params[name] = {"bias": _np(sd[f"{key}.bias"]),
                            "weight": _hwio(sd[f"{key}.weight"])}
        params["stem_bn"], state["stem_bn"] = _bn_trees(sd, "features.5")
    else:
        params["stem_conv"] = {"weight": _hwio(sd["features.1.weight"])}
        params["stem_bn"], state["stem_bn"] = _bn_trees(sd, "features.2")
    first, cls = _layout(cfg)
    _blocks_to_trees(sd, params, state, cfg, first)
    cls = f"features.{cls}"
    bn, bn_s = _bn_trees(sd, f"{cls}.BN2")
    params["classifier"] = {
        "lin1": {"weight": np.ascontiguousarray(_np(sd[f"{cls}.lin1.weight"]).T)},
        "bn": bn,
        "lin2": {"weight": np.ascontiguousarray(_np(sd[f"{cls}.lin2.weight"]).T),
                 "bias": _np(sd[f"{cls}.lin2.bias"])}}
    state["classifier"] = {"bn": bn_s}
    return params, state
