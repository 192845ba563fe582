"""Reference ``.pth`` state dicts -> the JAX package's ``(params, state)``
layout, for the families whose modules carry the JAX trees' names (the
port's copy of ``scale_imagenet_tpu/convert/torch_import.py:253-423``).

The trees are nested dicts of numpy arrays, conv weights HWIO and linear
weights ``(in, out)``, as the JAX importers give them;
``convert/from_jax.py::state_dict_from_jax`` turns them into the port's
state dict.  The ``module.`` prefix of a DataParallel checkpoint is
dropped.  ``IMPORTERS`` maps a config's class name to its importer, as
``scale_imagenet_tpu/main.py:286-298`` registers them; ``TTCertifConfig``
has none there either.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np

from ..models.ttnet_general_float import FLOAT_VARIANTS


def strip_module_prefix(sd: Mapping[str, np.ndarray]) -> dict:
    return {(k[len("module."):] if k.startswith("module.") else k): v
            for k, v in sd.items()}


def _hwio(w: np.ndarray) -> np.ndarray:
    return np.array(np.transpose(w, (2, 3, 1, 0)))


def _io(w: np.ndarray) -> np.ndarray:
    return np.array(np.transpose(w))


def _bn(sd: Mapping[str, np.ndarray], prefix: str):
    return ({"weight": np.array(sd[f"{prefix}.weight"]),
             "bias": np.array(sd[f"{prefix}.bias"])},
            {"running_mean": np.array(sd[f"{prefix}.running_mean"]),
             "running_var": np.array(sd[f"{prefix}.running_var"])})


def _cell(sd: Mapping[str, np.ndarray], prefix: str):
    """A cell's ``conv1``/``bn1``/``conv2``/``bn2`` (``_block_tt``)."""
    bn1, bn1_s = _bn(sd, f"{prefix}.bn1")
    bn2, bn2_s = _bn(sd, f"{prefix}.bn2")
    return ({"conv1": {"weight": _hwio(sd[f"{prefix}.conv1.weight"])},
             "bn1": bn1,
             "conv2": {"weight": _hwio(sd[f"{prefix}.conv2.weight"])},
             "bn2": bn2},
            {"bn1": bn1_s, "bn2": bn2_s})


def _linear(sd: Mapping[str, np.ndarray], prefix: str) -> dict:
    return {"weight": _io(sd[f"{prefix}.weight"]),
            "bias": np.array(sd[f"{prefix}.bias"])}


def import_mobilenet_v2_tt(sd: Mapping[str, np.ndarray], cfg):
    """``torch_import.py:253``: ``features.0`` the stem conv, ``.2`` its BN,
    ``.{3+i}`` the blocks, whose sparse head names (``conv1`` and
    ``conv3`` where the reference commented the others out) are renumbered
    densely, the Linear after the pool and the flatten."""
    sd = strip_module_prefix(sd)
    params = {"stem_conv": {"weight": _hwio(sd["features.0.weight"])}}
    state = {}
    params["stem_bn"], state["stem_bn"] = _bn(sd, "features.2")
    n_blocks = len(cfg.block_configs())
    for i in range(n_blocks):
        base = f"features.{3 + i}"
        bp, bs = {}, {}
        present = [j for j in (1, 2, 3, 4)
                   if f"{base}.conv{j}.conv1.weight" in sd]
        for slot, j in enumerate(present, start=1):
            bp[f"conv{slot}"], bs[f"conv{slot}"] = _cell(sd,
                                                         f"{base}.conv{j}")
        bp["convf"], bs["convf"] = _cell(sd, f"{base}.convf")
        params[f"block{i}"], state[f"block{i}"] = bp, bs
    params["fc"] = _linear(sd, f"features.{3 + n_blocks + 2}")
    return params, state


def _conv_maybe_masked(sd: Mapping[str, np.ndarray], prefix: str) -> dict:
    p = {"weight": _hwio(sd[f"{prefix}.weight"])}
    if f"{prefix}.bias" in sd:
        p["bias"] = np.array(sd[f"{prefix}.bias"])
    if f"{prefix}.weight_mask" in sd:
        p["weight_mask"] = _hwio(sd[f"{prefix}.weight_mask"])
    return p


def import_model_general(sd: Mapping[str, np.ndarray], cfg):
    """``torch_import.py:294``: ``features`` = [stem conv, BN, act, (conv,
    BN, ReLU, conv, BN, act) a block, flatten, Linear, stats BN], the
    stats BN absent under ``remove_last_bn``."""
    sd = strip_module_prefix(sd)
    params = {"stem_conv": _conv_maybe_masked(sd, "features.0")}
    state = {}
    params["stem_bn"], state["stem_bn"] = _bn(sd, "features.1")
    nb = len(cfg.filters)
    for i in range(nb):
        base = 3 + 6 * i
        params[f"conv{i}a"] = _conv_maybe_masked(sd, f"features.{base}")
        params[f"bn{i}a"], state[f"bn{i}a"] = _bn(sd, f"features.{base + 1}")
        params[f"conv{i}b"] = _conv_maybe_masked(sd, f"features.{base + 3}")
        params[f"bn{i}b"], state[f"bn{i}b"] = _bn(sd, f"features.{base + 4}")
    lin = 4 + 6 * nb
    fc = {"weight": _io(sd[f"features.{lin}.weight"])}
    if f"features.{lin}.bias" in sd:
        fc["bias"] = np.array(sd[f"features.{lin}.bias"])
    if f"features.{lin}.weight_mask" in sd:
        fc["weight_mask"] = _io(sd[f"features.{lin}.weight_mask"])
    params["fc"] = fc
    if f"features.{lin + 1}.weight" in sd:
        params["head_bn"], state["head_bn"] = _bn(sd, f"features.{lin + 1}")
    return params, state


def _float_cell(sd: Mapping[str, np.ndarray], prefix: str):
    """A float cell, with ``conv1b``/``bn1b`` in the ``_big`` variant."""
    p, s = {}, {}
    for conv in ("conv1", "conv1b", "conv2"):
        if f"{prefix}.{conv}.weight" in sd:
            p[conv] = {"weight": _hwio(sd[f"{prefix}.{conv}.weight"])}
    for bn in ("bn1", "bn1b", "bn2"):
        if f"{prefix}.{bn}.weight" in sd:
            p[bn], s[bn] = _bn(sd, f"{prefix}.{bn}")
    return p, s


def import_tt_general_float(sd: Mapping[str, np.ndarray], cfg):
    """``torch_import.py:340``: the float family ([AvgPool], conv, act, BN,
    blocks, pool, flatten, fc) and the correctBN twins (conv, BN, act,
    blocks, pool, flatten, fc1, fc2); heads the groups disable are
    absent.  ``Block_conv4`` (the k = 1 head of ``TT_general`` and
    ``TT_general_big``) is read too, which the JAX importer leaves out, so
    that a four-head checkpoint loads (``ROADMAP.md`` queue C)."""
    sd = strip_module_prefix(sd)
    nb = len(cfg.block_configs())
    state = {}
    correctbn = not hasattr(cfg, "variant")
    if correctbn:
        off, bn_idx, cell = 0, 1, _cell
    else:
        off = 0 if FLOAT_VARIANTS[cfg.variant]["stem"] == "s1" else 1
        bn_idx, cell = off + 2, _float_cell
    params = {"stem_conv": {"weight": _hwio(sd[f"features.{off}.weight"])}}
    params["stem_bn"], state["stem_bn"] = _bn(sd, f"features.{bn_idx}")
    for i in range(nb):
        base = f"features.{off + 3 + i}"
        bp, bs = {}, {}
        for j in (1, 2, 3, 4):
            if f"{base}.Block_conv{j}.conv1.weight" in sd:
                bp[f"conv{j}"], bs[f"conv{j}"] = cell(
                    sd, f"{base}.Block_conv{j}")
        bp["convf"], bs["convf"] = cell(sd, f"{base}.Block_convf")
        params[f"block{i}"], state[f"block{i}"] = bp, bs
    lin = off + 3 + nb + 2
    if correctbn:
        params["fc1"] = _linear(sd, f"features.{lin}")
        params["fc2"] = _linear(sd, f"features.{lin + 1}")
    else:
        params["fc"] = _linear(sd, f"features.{lin}")
    return params, state


def import_mobilenet_v1_tt(sd: Mapping[str, np.ndarray], cfg):
    """``torch_import.py:389``: [conv, BN, act, (block, act) x 12, block,
    pool, flatten, fc]."""
    sd = strip_module_prefix(sd)
    params = {"stem_conv": {"weight": _hwio(sd["features.0.weight"])}}
    state = {}
    params["stem_bn"], state["stem_bn"] = _bn(sd, "features.1")
    n = len(cfg.block_configs())
    for i in range(n):
        params[f"block{i}"], state[f"block{i}"] = _cell(
            sd, f"features.{3 + 2 * i}")
    params["fc"] = _linear(sd, f"features.{3 + 2 * (n - 1) + 3}")
    return params, state


def import_resnet(sd: Mapping[str, np.ndarray], cfg):
    """``torch_import.py:407``: torchvision's ResNet names
    (``layer{i}.{j}.conv{k}``, ``downsample.0``/``.1``)."""
    sd = strip_module_prefix(sd)
    params = {"conv1": {"weight": _hwio(sd["conv1.weight"])}}
    state = {}
    params["bn1"], state["bn1"] = _bn(sd, "bn1")
    n_convs = 2 if cfg.block == "basic" else 3
    for li, nblocks in enumerate(cfg.stage_blocks):
        for bi in range(nblocks):
            tb, name = f"layer{li + 1}.{bi}", f"layer{li + 1}_{bi}"
            bp, bs = {}, {}
            for ci in range(1, n_convs + 1):
                bp[f"conv{ci}"] = {"weight": _hwio(
                    sd[f"{tb}.conv{ci}.weight"])}
                bp[f"bn{ci}"], bs[f"bn{ci}"] = _bn(sd, f"{tb}.bn{ci}")
            if f"{tb}.downsample.0.weight" in sd:
                bp["down_conv"] = {"weight": _hwio(
                    sd[f"{tb}.downsample.0.weight"])}
                bp["down_bn"], bs["down_bn"] = _bn(sd, f"{tb}.downsample.1")
            params[name], state[name] = bp, bs
    params["fc"] = _linear(sd, "fc")
    return params, state


IMPORTERS = {
    "ModelGeneralConfig": import_model_general,
    "TTGeneralFloatConfig": import_tt_general_float,
    "TTGeneralCorrectBNConfig": import_tt_general_float,
    "MobilenetV1TTConfig": import_mobilenet_v1_tt,
    "MobilenetV2TTConfig": import_mobilenet_v2_tt,
    "ResNetConfig": import_resnet,
}
