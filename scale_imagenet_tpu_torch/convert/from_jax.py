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

``jax_trees`` is the inverse map, from a port model back to the JAX
layout (``compile/lut_store.py`` hashes it).  The trees are nested dicts of
numpy arrays; nothing here imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch

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


def state_dict_from_jax(params: dict, state: dict, cfg) -> dict:
    """``cfg``: the port's ``TTnetImageNetConfig`` of the same model."""
    sd: dict = {"features.1.weight": _conv(params["stem_conv"]["weight"])}
    _bn(sd, "features.2", params["stem_bn"], state["stem_bn"])
    _act(sd, "features.3")
    n_blocks = len(cfg.block_configs())
    for i in range(n_blocks):
        base = f"features.{4 + i}"
        bp, bs = params[f"block{i}"], state[f"block{i}"]
        for ours, name in _HEADS:
            prefix = f"{base}.{name}"
            sd[f"{prefix}.conv1.weight"] = _conv(bp[ours]["conv1"]["weight"])
            _bn(sd, f"{prefix}.bn1", bp[ours]["bn1"], bs[ours]["bn1"])
            sd[f"{prefix}.conv2.weight"] = _conv(bp[ours]["conv2"]["weight"])
            _bn(sd, f"{prefix}.bn2", bp[ours]["bn2"], bs[ours]["bn2"])
            _act(sd, f"{prefix}.act")
        _act(sd, f"{base}.act")
    cls = f"features.{4 + n_blocks + 2}"          # after AvgPool + Flatten
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


def jax_trees(model) -> tuple[dict, dict]:
    """The inverse of ``state_dict_from_jax``: a port ``TTnetImageNet`` as
    the JAX package's ``(params, state)`` nested dicts of numpy arrays
    (conv weights OIHW -> HWIO, linear weights ``(out, in)`` ->
    ``(in, out)``, the buffers inference does not read left out), in the
    model's dtype."""
    sd = model.state_dict()
    params: dict = {"stem_conv": {"weight": _hwio(sd["features.1.weight"])}}
    state: dict = {}
    params["stem_bn"], state["stem_bn"] = _bn_trees(sd, "features.2")
    n_blocks = len(model.cfg.block_configs())
    for i in range(n_blocks):
        base = f"features.{4 + i}"
        bp, bs = params.setdefault(f"block{i}", {}), \
            state.setdefault(f"block{i}", {})
        for ours, name in _HEADS:
            prefix = f"{base}.{name}"
            bn1, bn1_s = _bn_trees(sd, f"{prefix}.bn1")
            bn2, bn2_s = _bn_trees(sd, f"{prefix}.bn2")
            bp[ours] = {"conv1": {"weight": _hwio(sd[f"{prefix}.conv1.weight"])},
                        "bn1": bn1,
                        "conv2": {"weight": _hwio(sd[f"{prefix}.conv2.weight"])},
                        "bn2": bn2}
            bs[ours] = {"bn1": bn1_s, "bn2": bn2_s}
    cls = f"features.{4 + n_blocks + 2}"
    bn, bn_s = _bn_trees(sd, f"{cls}.BN2")
    params["classifier"] = {
        "lin1": {"weight": np.ascontiguousarray(_np(sd[f"{cls}.lin1.weight"]).T)},
        "bn": bn,
        "lin2": {"weight": np.ascontiguousarray(_np(sd[f"{cls}.lin2.weight"]).T),
                 "bias": _np(sd[f"{cls}.lin2.bias"])}}
    state["classifier"] = {"bn": bn_s}
    return params, state
